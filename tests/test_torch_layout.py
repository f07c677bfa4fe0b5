"""The port's layout engine (``repro_torch.dist.layout``) against the JAX
package's (``repro.dist.layout``): every parameter spec of all ten archs
at full width (port trees on the meta device, JAX trees from
``jax.eval_shape``), the int8 ``{q, scale}`` trees, all four strategies,
on the meshes (1, 1), (2, 4), (16, 16) and (2, 16, 16); cache and batch
specs; ``score_layouts`` to a relative 1e-12 on the TPU sheet and
``choose_layout``; and the optimizers' state specs."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro import quant as jquant
from repro.configs.base import ARCH_IDS, get_config as jget_config
from repro.core.hardware import TPU_V5E
from repro.data import pipeline as jpipeline
from repro.dist import layout as jlayout
from repro.models import transformer as JT
from repro.optim import adafactor as jadafactor, adamw as jadamw
from repro.runtime import elastic as jelastic
from repro.train import train_step as JTS

from repro_torch import quant
from repro_torch.configs import get_config
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.data import pipeline
from repro_torch.dist import layout
from repro_torch.models import transformer as T
from repro_torch.optim import adafactor, adamw
from repro_torch.runtime import elastic
from repro_torch.train import train_step as TS


class FakeMesh:
    """Duck-typed mesh (axis names + shape) for spec-level tests."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


MESHES = {
    "1x1": FakeMesh((1, 1), ("data", "model")),
    "2x4": FakeMesh((2, 4), ("data", "model")),
    "16x16": FakeMesh((16, 16), ("data", "model")),
    "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model")),
}


def one_repeat(cfg):
    """``cfg`` at full width with one repeat of its layer pattern (and
    its tail): the stacked leading dim is never sharded, so the specs of
    every leaf are those of the full depth."""
    return dataclasses.replace(
        cfg, n_layers=len(cfg.layer_pattern) + len(cfg.tail_pattern))


@functools.lru_cache(maxsize=None)
def trees(arch, int8=False):
    """(port meta tree, JAX ShapeDtypeStruct tree) of ``arch``'s full
    width parameters (int8-quantized with ``int8``, at one repeat: the
    port quantizes a stacked leaf one layer and expert at a time)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    if int8:
        cfg, jcfg = one_repeat(cfg), one_repeat(jcfg)
    port = TS.state_struct(cfg, "adamw").params

    def init():
        p = JT.init_params(jax.random.PRNGKey(0), jcfg)
        return jquant.quantize_params(p)[0] if int8 else p

    if int8:
        port = quant.quantize_params(port)[0]
    return port, jax.eval_shape(init)


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of nested dicts (JAX specs are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def assert_same_specs(port_specs, jax_specs):
    pf, jf = _flat(port_specs), _flat(jax_specs)
    assert sorted(pf) == sorted(jf)
    for path, spec in jf.items():
        assert tuple(pf[path]) == tuple(spec), (path, pf[path], spec)
        assert isinstance(pf[path], layout.P)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", layout.STRATEGIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, strategy, mesh):
    port, jtree = trees(arch)
    assert_same_specs(
        layout.param_specs(port, get_config(arch), MESHES[mesh], strategy),
        jlayout.param_specs(jtree, jget_config(arch), MESHES[mesh],
                            strategy))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_int8_param_specs_match_jax(arch, mesh):
    """The int8 ``{q, scale}`` leaves inherit the weight's placement (the
    per-channel scale relaxing on its broadcast dim), all strategies."""
    port, jtree = trees(arch, int8=True)
    assert any(p.endswith("/scale") for p in _flat(port))
    for strategy in layout.STRATEGIES:
        assert_same_specs(
            layout.param_specs(port, one_repeat(get_config(arch)),
                               MESHES[mesh], strategy),
            jlayout.param_specs(jtree, one_repeat(jget_config(arch)),
                                MESHES[mesh], strategy))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_score_and_choose_layout_match_jax(arch, mesh):
    """Every strategy's score on the TPU sheet to a relative 1e-12, the
    choice equal, and the default sheet the H100's."""
    sizes = dict(zip(MESHES[mesh].axis_names, MESHES[mesh].devices.shape))
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = layout.score_layouts(cfg, sizes, hbm_bytes=TPU_V5E.hbm_bytes)
    want = jlayout.score_layouts(jcfg, sizes, hbm_bytes=TPU_V5E.hbm_bytes)
    assert list(got) == list(want)
    for s in want:
        for k, v in want[s].items():
            if isinstance(v, bool):
                assert got[s][k] == v, (s, k)
            else:
                assert got[s][k] == pytest.approx(v, rel=1e-12, abs=0)
    assert layout.choose_layout(cfg, sizes, hbm_bytes=TPU_V5E.hbm_bytes) \
        == jlayout.choose_layout(jcfg, sizes, hbm_bytes=TPU_V5E.hbm_bytes)
    assert layout.score_layouts(cfg, sizes) == layout.score_layouts(
        cfg, sizes, hbm_bytes=HOPPER_H100.hbm_bytes)
    # without a mesh, the JAX default's production single pod
    assert layout.choose_layout(cfg, hbm_bytes=TPU_V5E.hbm_bytes) \
        == jlayout.choose_layout(jcfg, hbm_bytes=TPU_V5E.hbm_bytes)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch, mesh):
    """Dense caches (windowed rings, the unstacked tail, the encoder's
    cross cache) and, for the archs the pool takes, the paged pool."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = layout.cache_specs(T.init_cache(cfg, 8, 1024, device="meta"),
                             MESHES[mesh])
    want = jlayout.cache_specs(
        jax.eval_shape(lambda: JT.init_cache(jcfg, 8, 1024)), MESHES[mesh])
    assert_same_specs(got, want)
    try:
        T.check_paged(cfg)
    except (ValueError, NotImplementedError):
        return
    got = layout.cache_specs(T.init_paged_cache(cfg, 8, 64, 16, 8,
                                                device="meta"),
                             MESHES[mesh])
    want = jlayout.cache_specs(jax.eval_shape(
        lambda: JT.init_paged_cache(jcfg, 8, 64, 16, 8)), MESHES[mesh])
    assert_same_specs(got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rows", [1, 2, 8, 32, 512])
@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-medium",
                                  "internvl2-76b"])
def test_batch_specs_match_jax(arch, rows, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    d = pipeline.DataConfig(seq_len=cfg.prefix_tokens + 16 if
                            cfg.prefix_tokens else 16, global_batch=rows)
    jd = jpipeline.DataConfig(seq_len=d.seq_len, global_batch=rows)
    assert_same_specs(
        layout.batch_specs(pipeline.batch_spec(cfg, d), MESHES[mesh]),
        jlayout.batch_specs(jpipeline.batch_spec(jcfg, jd), MESHES[mesh]))


@pytest.mark.parametrize("case", [
    ("layers/u0/mlp/w_gate", (32, 4096, 16384), "tp", {"data": 16,
                                                       "model": 16}),
    ("lm_head", (4096, 256000), "tp", {"data": 16, "model": 16}),
    ("layers/u0/attn/wq", (32, 960, 950), "fsdp_tp", {"data": 16,
                                                      "model": 16}),
    ("layers/u0/mlp/w_gate", (61, 7168, 2048), "fsdp_tp",
     {"pod": 2, "data": 16, "model": 16}),
    ("layers/u0/mlp/w_gate", (61, 7184, 2048), "fsdp_tp",
     {"pod": 2, "data": 16, "model": 16}),
    ("layers/u0/moe/w_down/scale", (4, 128, 1, 4096), "fsdp_tp",
     {"data": 2, "model": 4}),
    ("layers/u0/norm1/scale", (4, 4096), "fsdp", {"data": 2, "model": 4}),
])
def test_spec_for_matches_jax(case):
    name, shape, strategy, sizes = case
    assert tuple(layout.spec_for(name, shape, strategy, sizes)) \
        == tuple(jlayout.spec_for(name, shape, strategy, sizes))


def test_spec_for_rejects_an_unknown_strategy():
    with pytest.raises(ValueError, match="unknown layout strategy"):
        layout.spec_for("lm_head", (8, 8), "zero3", {"data": 2})


@pytest.mark.parametrize("mesh", ["2x4", "2x16x16"])
@pytest.mark.parametrize("strategy", layout.STRATEGIES)
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "smollm-360m",
                                  "recurrentgemma-9b"])
def test_optimizer_state_specs_match_jax(arch, strategy, mesh):
    """AdamW's moments inherit each spec; Adafactor's factored row /
    column statistics take the rank-adjusted specs."""
    port, jtree = trees(arch)
    cfg, jcfg = get_config(arch), jget_config(arch)
    ps = layout.param_specs(port, cfg, MESHES[mesh], strategy)
    js = jlayout.param_specs(jtree, jcfg, MESHES[mesh], strategy)
    a, ja = adamw.state_specs(ps, port), jadamw.state_specs(js, jtree)
    assert tuple(a.step) == tuple(ja.step)
    assert_same_specs(a.mu, ja.mu)
    assert_same_specs(a.nu, ja.nu)
    f = adafactor.state_specs(ps, port)
    jf = jadafactor.state_specs(js, jtree)
    assert tuple(f.step) == tuple(jf.step)
    assert_same_specs(f.vr, jf.vr)
    assert_same_specs(f.vc, jf.vc)


def test_compute_specs_keep_only_the_expert_dim():
    port, _ = trees("qwen3-moe-235b-a22b")
    specs = layout.param_specs(port, get_config("qwen3-moe-235b-a22b"),
                               MESHES["2x4"], "fsdp_tp")
    comp = _flat(layout.compute_specs(specs))
    moe = "layers/u0/moe/"
    assert tuple(_flat(specs)[moe + "w_gate"]) == (None, "model", "data",
                                                   None)
    assert tuple(comp[moe + "w_gate"]) == (None, "model", None, None)
    assert tuple(comp[moe + "w_down"]) == (None, "model", None, None)
    assert all(e is None for p, s in comp.items() for e in s
               if not p.startswith(moe + "w_"))
    dropped = _flat(layout.dropped_specs(specs, layout.compute_specs(specs)))
    assert tuple(dropped[moe + "w_gate"]) == (None, None, "data", None)


def _flat_state(tree, prefix=""):
    """{path: leaf} of a TrainState-like tree (named tuples by field),
    a spec a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree):
            out.update(_flat_state(v, f"{prefix}/.{f}"))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mesh", ["1x1", "2x4", "2x16x16"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "recurrentgemma-9b",
                                  "whisper-medium"])
def test_train_state_specs_match_jax(arch, optimizer, mesh):
    """``runtime.elastic.state_specs`` of a whole training state (params
    by ``choose_layout``, the optimizer's own specs, the step
    replicated), the meta tree against ``jax.eval_shape``'s."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = elastic.state_specs(TS.state_struct(cfg, optimizer), cfg,
                              MESHES[mesh])
    want = jelastic.state_specs(jax.eval_shape(
        lambda: JTS.init_state(jax.random.PRNGKey(0), jcfg, optimizer)),
        jcfg, MESHES[mesh])
    gf, wf = _flat_state(got), _flat_state(want)
    assert sorted(gf) == sorted(wf)
    for k, spec in wf.items():
        assert tuple(gf[k]) == tuple(spec), k
