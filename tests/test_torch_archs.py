"""Every architecture of the JAX package in the port, on the CPU: the
``tests/test_archs.py`` smoke set, run against JAX for each arch in
``repro.configs.base.ARCH_IDS``.

Parameters of the smoke models (f32) come from the JAX init through
``bridge.from_jax``; batches from both packages' data pipelines (the
same numpy draws: whisper's stub frames, internvl2's prefix
embeddings); the JAX side runs with ``REPRO_KERNELS=ref``.  Tolerances:
``atol = rtol = 1e-4`` against JAX (hidden states, loss, every gradient
leaf, prefill and decode logits: f32 sums in another order), ``2e-3``
for the port's own prefill + decode against its forward, as
``tests/test_archs.py`` holds the JAX package (every arch but
internvl2-76b, as there).
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.data import pipeline as JP
from repro.models import transformer as JT
from repro_torch.bridge import from_jax, to_numpy
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import pipeline as P
from repro_torch.models import transformer as T
from repro_torch.train import train_step as TS

CPU = torch.device("cpu")
VS_JAX = dict(atol=1e-4, rtol=1e-4)
SELF = dict(atol=2e-3, rtol=2e-3)
BATCH, SEQ = 2, 32


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


_SMOKE = {}


def _smoke(arch):
    """(jax cfg, jax params, port cfg, port params, jax batch, port
    batch), made once an arch: ``tests/test_archs.py``'s batch of 2 x 32
    text tokens (after the prefix, for internvl2)."""
    if arch not in _SMOKE:
        jcfg, tcfg = JB.get_smoke_config(arch), get_smoke_config(arch)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        dc = dict(seq_len=SEQ + (jcfg.prefix_tokens or 0),
                  global_batch=BATCH, seed=1)
        _SMOKE[arch] = (jcfg, jp, tcfg, from_jax(jax.tree.map(np.asarray,
                                                               jp)),
                        JP.make_batch(jcfg, JP.DataConfig(**dc), 0),
                        P.make_batch(tcfg, P.DataConfig(**dc), 0))
    return _SMOKE[arch]


def _by_path(tree) -> dict:
    return {jtu.keystr(k): np.asarray(v)
            for k, v in jtu.tree_flatten_with_path(tree)[0]}


def _paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{pre}['{k}']")
        else:
            yield f"{pre}['{k}']", v


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg,
                               **tol)


def _extras(batch) -> dict:
    return {k: batch[k] for k in ("prefix_embeds", "frames") if k in batch}


# ------------------------------------------------------------------ configs

def test_arch_ids_equal_the_jax_tuple():
    assert ARCH_IDS == JB.ARCH_IDS


@pytest.mark.parametrize("name", [a + s for a in JB.ARCH_IDS
                                  for s in ("", "-smoke")])
def test_configs_match_jax(name):
    """Both registrations of every arch, field for field, and the
    parameter count."""
    smoke = name.endswith("-smoke")
    arch = name[:-len("-smoke")] if smoke else name
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    jcfg = JB.get_smoke_config(arch) if smoke else JB.get_config(arch)
    assert dataclasses_equal(cfg, jcfg)
    assert cfg.param_count() == jcfg.param_count()
    T.check_supported(cfg)


def dataclasses_equal(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f)
               for f in b.__dataclass_fields__)


# ------------------------------------------------------------ parameters

@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_params_match_the_jax_layout_and_round_trip(arch):
    """The port's own init has the JAX tree's keys, shapes and dtypes
    (whisper's ``encoder``, ``norm_x``, ``cross``, LayerNorm biases and
    GELU MLP included); the JAX parameters cross to the port and back
    bit for bit."""
    jcfg, jp, tcfg, tp, _, _ = _smoke(arch)
    want = _by_path(jp)
    mine = dict(_paths(T.init_params(tcfg, torch.Generator().manual_seed(0),
                                     device=CPU)))
    assert sorted(mine) == sorted(want)
    for k, v in mine.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == want[k].dtype.name, k
    for k, v in _paths(to_numpy(tp)):
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ------------------------------------------------------- forward, grads

@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_forward_matches_jax(arch):
    """Hidden states of the whole (prefix + text) sequence, whisper's
    decoder cross-attending its encoder over the frames."""
    jcfg, jp, tcfg, tp, jb, tb = _smoke(arch)
    jh, jaux = JT.forward(jp, jcfg, jb["tokens"], **_extras(jb))
    th, taux = T.forward(tp, tcfg, tb["tokens"], **_extras(tb))
    assert th.shape == (BATCH, SEQ + (tcfg.prefix_tokens or 0),
                        tcfg.d_model)
    _close(th, jh, VS_JAX)
    _close(taux, jaux, VS_JAX)


@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` (text positions only after a prefix) and every
    gradient leaf against ``jax.value_and_grad``, with remat."""
    jcfg, jp, tcfg, tp, jb, tb = _smoke(arch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb, n_chunks=2), has_aux=True)(jp)
    tl, _, tg = TS.value_and_grad(tp, tcfg, tb, n_chunks=2)
    _close(tl, jl, VS_JAX)
    want = _by_path(jg)
    got = dict(_paths(tg))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        _close(g, want[k], VS_JAX, k)
        assert torch.isfinite(g).all(), k


# ------------------------------------------------------ prefill + decode

@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_prefill_then_decode_matches_jax(arch):
    """Prefill the first 28 text tokens (after the prefix, with the
    frames), then decode 4: every logits row, and the final cache (the
    cross k / v included), against the JAX package's."""
    jcfg, jp, tcfg, tp, jb, tb = _smoke(arch)
    max_len = SEQ + 8 + (tcfg.prefix_tokens or 0)
    toks = tb["tokens"]
    jc = JT.init_cache(jcfg, BATCH, max_len)
    tc = T.init_cache(tcfg, BATCH, max_len, device=CPU)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks[:, :28].numpy()), jc,
                        **_extras(jb))
    tl, tc = T.prefill(tp, tcfg, toks[:, :28], tc, **_extras(tb))
    _close(tl, jl, VS_JAX, "prefill")
    step = jax.jit(lambda t, c: JT.decode_step(jp, jcfg, t, c))
    for i in range(28, SEQ):
        t = toks[:, i:i + 1]
        jl, jc = step(jnp.asarray(t.numpy()), jc)
        tl, tc = T.decode_step(tp, tcfg, t, tc)
        _close(tl, jl, VS_JAX, f"position {i}")
    want = _by_path(jc)
    got = dict(_paths(tc))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        _close(v, want[k], VS_JAX, k)


@pytest.mark.parametrize("arch", [a for a in JB.ARCH_IDS
                                  if a != "internvl2-76b"])
def test_prefill_plus_decode_matches_forward(arch):
    """The port's cache against its own forward, as
    ``tests/test_archs.py`` holds the JAX package: logits of
    prefill(t[:-1]) then decode(t[-1]) equal the forward's at the last
    position (2e-3)."""
    _, _, tcfg, tp, _, tb = _smoke(arch)
    tokens, frames = tb["tokens"], tb.get("frames")
    h, _ = T.forward(tp, tcfg, tokens, frames=frames, remat=False)
    want = h[:, -1] @ tp["lm_head"]
    cache = T.init_cache(tcfg, BATCH, SEQ + 8, device=CPU)
    _, cache = T.prefill(tp, tcfg, tokens[:, :-1], cache, frames=frames)
    got, _ = T.decode_step(tp, tcfg, tokens[:, -1:], cache)
    _close(got, want.detach().numpy(), SELF)
