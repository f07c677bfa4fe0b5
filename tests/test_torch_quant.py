"""Int8 serving (W8A16 and W8A8) of the port against the JAX package on
the CPU: ``repro_torch.quant`` against ``repro.quant`` bit for bit; the
int8 plain versions of kernels B1, B2, B6 and B7 against the Pallas
kernels in interpret mode (as tests/test_kernels.py runs them); the
quantized plans against ``repro.kernels.api`` on the TPU sheet, and the
W8A8 re-route against the JAX package's ``execute``.  The smoke models
and engines under int8 are held to the JAX package in
tests/test_torch_quant_serve.py; the CUDA kernels to their plain
versions on the card in tests/test_torch_cuda.py.

Tolerances: W8A8 bit for bit where the flush is the scale multiply alone
(int32 sums are exact); with a bias or residual the Pallas kernel in
interpret mode may contract the multiply and the add into one FMA (XLA
on the CPU does), one f32 rounding fewer than the port's flush, so those
compare at f32's ``atol=rtol=1e-5``; W8A16 in f32 at 1e-5 (f32 sums in
another order), bf16 compared in f32 at ``atol=rtol=2e-2``; out-quant:
equal int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro import quant as jquant
from repro.kernels import api as japi
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro_torch import ops, quant
from repro_torch.bridge import from_jax, to_numpy
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.tiling import TileConfig
from repro_torch.kernels import api
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.gemm_aie import gemm_aie
from repro_torch.kernels.gemm_gated import gemm_gated
from repro_torch.kernels.gemm_grouped import gemm_grouped
from repro_torch.kernels.gemm_tb import gemm_tb
from repro_torch.models import transformer as T

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _modes_and_caches(monkeypatch):
    """Each test starts in W8A16 mode with empty plan caches, in both
    packages, and leaves them so."""
    monkeypatch.delenv("REPRO_W8A8", raising=False)
    for mod in (quant, jquant):
        mod.set_activation_mode("none")
    api.plan_cache_clear()
    japi.plan_cache_clear()
    yield
    for mod in (quant, jquant):
        mod.set_activation_mode("none")
    api.plan_cache_clear()
    japi.plan_cache_clear()


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _pair(x, dtype="float32"):
    """The same values as a JAX array and a CPU torch tensor."""
    jx = jnp.asarray(x).astype(DT[dtype][0]) if x.dtype != np.int8 \
        else jnp.asarray(x)
    return jx, from_jax({"x": np.asarray(jx)})["x"]


def _struct_pair(w):
    """A weight quantized by the JAX package, as both packages' structs
    (the port's carried across by the bridge)."""
    jw = jquant.quantize_weight(jnp.asarray(w))
    return jw, from_jax(jax.tree.map(np.asarray, jw))


def _same(got_t, want_j):
    """Equal values (bf16 compared through f32, which holds it exactly)."""
    if got_t.dtype == torch.bfloat16:
        got_t, want_j = got_t.float(), np.asarray(want_j, np.float32)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_j))


def _close(got_t, want_j, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# repro_torch.quant == repro.quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 40), (3, 32, 24), (2, 4, 16, 12)])
def test_quantize_weight_matches_jax(shape):
    w = _np(shape, 0)
    w[..., 3] = 0.0                  # a zero column: scale 1, q 0
    got = quant.quantize_weight(torch.as_tensor(w))
    want = jquant.quantize_weight(jnp.asarray(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32
    _same(got["q"], want["q"])
    _same(got["scale"], want["scale"])
    assert got["scale"].shape[-2:] == (1, shape[-1])
    _same(quant.dequantize_weight(got, torch.float32),
          jquant.dequantize_weight(want, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_matches_jax(dtype):
    x = _np((9, 48), 1, 3.0)
    x[4] = 0.0                       # an all-zero row
    jx, tx = _pair(x, dtype)
    got = quant.quantize_activations(tx)
    want = jquant.quantize_activations(jx)
    _same(got[0], want[0])
    _same(got[1], want[1])


def _smoke_params(arch):
    """The smoke config's f32 parameters in both packages, the same
    values: the port draws them (seed 0; the JAX init's per-leaf draws
    cost seconds an arch, and any values serve a parity test)."""
    tp = T.init_params(get_smoke_config(arch),
                       torch.Generator().manual_seed(0), device="cpu")
    return jax.tree.map(jnp.asarray, to_numpy(tp)), tp


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, tree


#: leaves only the other families have, each of which must be quantized
FAMILY_LEAVES = {
    "recurrentgemma-9b": ("rec/in_proj", "rec/w_r", "rec/w_i",
                          "rec/out_proj"),
    "mamba2-370m": ("mixer/in_proj", "mixer/out_proj"),
    "whisper-medium": ("cross/wq", "cross/wk", "encoder/layers/u0/mlp/w_in",
                       "encoder/layers/u0/attn/wo"),
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quantize_params_and_byte_counts_match_jax(arch):
    """Every GEMM leaf (stacked (r, k, n) projections and (r, E, k, n)
    expert banks; the recurrent, encoder and cross projections of the
    other families) quantized bit for bit, the same leaves left alone,
    the same count; the parameter and weight-stream byte counts equal,
    for every arch of the JAX package."""
    jp, tp = _smoke_params(arch)
    jq, jn = jquant.quantize_params(jp)
    tq, tn = quant.quantize_params(tp)
    assert tn == jn > 0
    want = dict(_flat(to_numpy(from_jax(jax.tree.map(np.asarray, jq)))))
    got = dict(_flat(to_numpy(tq)))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
        assert got[path].dtype == want[path].dtype, path
    if arch.startswith("qwen3"):
        bank = tq["layers"]["u0"]["moe"]["w_gate"]
        assert bank["q"].dim() == 4 and bank["scale"].shape[-2] == 1
        assert not quant.is_quantized(tq["layers"]["u0"]["moe"]["router"])
    for leaf in FAMILY_LEAVES.get(arch, ()):
        assert any(p.endswith(f"/{leaf}/q") for p in got), leaf
    assert not quant.is_quantized(tq["embed"])
    for jt, tt in ((jp, tp), (jq, tq)):
        assert quant.param_bytes(tt) == jquant.param_bytes(jt)
        assert quant.gemm_weight_bytes(tt) == jquant.gemm_weight_bytes(jt)
    assert quant.gemm_weight_bytes(tq) < quant.gemm_weight_bytes(tp) / 3


@pytest.mark.parametrize("env", ["1", "true", "w8a8", "", "0", "false",
                                 "none", "yes", "False", "W8A8"])
def test_strict_repro_w8a8_parse_matches_jax(env, monkeypatch):
    monkeypatch.setenv("REPRO_W8A8", env)
    try:
        want = jquant.activation_mode()
    except ValueError:
        with pytest.raises(ValueError, match="REPRO_W8A8"):
            quant.activation_mode()
        return
    assert quant.activation_mode() == want


def test_activation_mode_setter_matches_jax():
    for mod in (quant, jquant):
        mod.set_activation_mode("w8a8")
        assert mod.activation_mode() == "w8a8"
        with pytest.raises(ValueError, match="unknown activation mode"):
            mod.set_activation_mode("w4a4")


def test_bridge_carries_a_jax_quantized_tree_unchanged():
    """A JAX {q, scale} tree crosses into the port with every key, q
    (k, n) int8 and scale (1, n) f32, bit for bit, and back."""
    jp, _ = _smoke_params("smollm-360m")
    jq, _ = jquant.quantize_params(jp)
    tq = from_jax(jax.tree.map(np.asarray, jq))
    wq = tq["layers"]["u0"]["attn"]["wq"]
    assert set(wq) == {"q", "scale"} and quant.is_quantized(wq)
    assert wq["q"].dtype == torch.int8 and wq["scale"].dtype == \
        torch.float32
    r, k, n = jq["layers"]["u0"]["attn"]["wq"]["q"].shape
    assert tuple(wq["q"].shape) == (r, k, n)
    assert tuple(wq["scale"].shape) == (r, 1, n)
    back = to_numpy(tq)
    for path, want in _flat(jax.tree.map(np.asarray, jq)):
        got = dict(_flat(back))[path]
        np.testing.assert_array_equal(got, want, err_msg=path)


# ---------------------------------------------------------------------------
# the int8 plain versions of B1, B6, B2 and B7 against the Pallas kernels
# ---------------------------------------------------------------------------

def _int8_case(m, k, n, mode, seed=0):
    """(JAX A, port A, JAX weight struct, port struct, weight dtype name)
    of one case: mode "w8a8" (A int8), "w8a16_f32" or "w8a16_bf16"."""
    dtype = "bfloat16" if mode == "w8a16_bf16" else "float32"
    x = _np((m, k), seed, k ** -0.5)
    if mode == "w8a8":
        x = np.asarray(jquant.quantize_activations(jnp.asarray(x))[0])
    ja, ta = _pair(x, dtype)
    jw, tw = _struct_pair(_np((k, n), seed + 1))
    return ja, ta, jw, tw, dtype


def _epilogue(m, n, epi, dtype, seed=5):
    jkw, tkw = {}, {}
    if "bias" in epi:
        jb, tb = _pair(_np((n,), seed))
        jkw["bias"], tkw["bias"] = jb, tb
    if "silu" in epi:
        jkw["activation"] = tkw["activation"] = "silu"
    if "res" in epi:
        jr, tr = _pair(_np((m, n), seed + 1), dtype)
        jkw["residual"], tkw["residual"] = jr, tr
    return jkw, tkw


@pytest.mark.parametrize("m,k,n", [(8, 256, 192), (13, 300, 77),
                                   (300, 128, 96)])
@pytest.mark.parametrize("mode", ["w8a8", "w8a16_f32", "w8a16_bf16"])
@pytest.mark.parametrize("epi", ["none", "bias", "res", "bias+silu+res"])
@pytest.mark.parametrize("strategy", ["aie", "tb"])
def test_int8_plain_versions_match_pallas_interpret(m, k, n, mode, epi,
                                                    strategy, monkeypatch):
    """B1 (``gemm_aie``) and B6 (``gemm_tb``, its int8 partial chunks) on
    W8A8 and W8A16 against the JAX package's Pallas kernel of the same
    dataflow in interpret mode (``ops.gemm`` pads to its tile)."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    ja, ta, jw, tw, dtype = _int8_case(m, k, n, mode)
    jkw, tkw = _epilogue(m, n, epi, dtype)
    out = jnp.float32 if mode == "w8a8" else DT[dtype][0]
    want = jops.gemm(ja, jw, strategy=strategy, out_dtype=out, **jkw)
    t_out = torch.float32 if mode == "w8a8" else DT[dtype][1]
    if strategy == "aie":
        got = gemm_aie(ta, tw["q"], b_scale=tw["scale"], out_dtype=t_out,
                       **tkw)
    else:
        got = gemm_tb(ta, tw["q"], b_scale=tw["scale"], out_dtype=t_out,
                      tile=TileConfig(8, 128, 64, "tb"), **tkw)
    assert got.dtype == t_out
    if mode == "w8a8" and epi == "none":
        _same(got, want)
    else:
        _close(got, want, dtype if mode != "w8a8" else "float32")


@pytest.mark.parametrize("strategy", ["aie", "tb"])
@pytest.mark.parametrize("mode", ["w8a8", "w8a16_f32"])
def test_out_quant_plain_matches_pallas_interpret(strategy, mode,
                                                  monkeypatch):
    """The int8 output of B1 and B6b (divide, round half to even, clip
    to +-127) equals the Pallas kernels', value for value; integral f32
    activations keep the W8A16 sums exact, so no rounding differs."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    m, k, n = 16, 256, 128
    ja, ta, jw, tw, dtype = _int8_case(m, k, n, mode, seed=3)
    if mode == "w8a16_f32":
        x = np.round(_np((m, k), 3, 4.0))
        ja, ta = _pair(x)
    jkw, tkw = _epilogue(m, n, "bias+res", "float32")
    want = jops.gemm(ja, jw, strategy=strategy, out_scale=0.37, **jkw)
    kw = dict(b_scale=tw["scale"], out_scale=0.37, **tkw)
    got = gemm_aie(ta, tw["q"], **kw) if strategy == "aie" else \
        gemm_tb(ta, tw["q"], tile=TileConfig(8, 64, 64, "tb"), **kw)
    assert got.dtype == torch.int8 and np.asarray(want).dtype == np.int8
    _same(got, want)
    assert (got.abs() == 127).any() and (got.abs() < 127).any()


@pytest.mark.parametrize("m,k,n", [(8, 256, 192), (37, 300, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a16_gemm_gated_plain_matches_pallas_interpret(m, k, n, dtype,
                                                         monkeypatch):
    """B2 on int8 gate/up weights, each accumulator scaled by its own
    (1, n) scale before the gate."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    ja, ta = _pair(_np((m, k), 0, k ** -0.5), dtype)
    jg, tg = _struct_pair(_np((k, n), 1))
    ju, tu = _struct_pair(_np((k, n), 2))
    want = jops.gemm(ja, jg, b2=ju, activation="silu")
    got = gemm_gated(ta, tg["q"], tu["q"], bg_scale=tg["scale"],
                     bu_scale=tu["scale"])
    _close(got, want, dtype)


@pytest.mark.parametrize("sizes,m,k,n", [
    ([5, 0, 9, 3], 20, 64, 48), ([3, 2, 1, 1, 4, 2, 20], 40, 300, 200),
    ([0, 0, 37, 0, 20, 0], 57, 100, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epi", ["none", "bias+silu"])
def test_w8a16_gemm_grouped_plain_matches_pallas_interpret(sizes, m, k, n,
                                                           dtype, epi,
                                                           monkeypatch):
    """B7 on an int8 bank with its per-expert (E, 1, n) scale rows; rows
    past the groups zero."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    e = len(sizes)
    ja, ta = _pair(_np((m, k), 0, k ** -0.5), dtype)
    jw, tw = _struct_pair(_np((e, k, n), 1))
    gs = np.asarray(sizes, np.int32)
    jkw, tkw = {}, {}
    if epi != "none":
        jb, tb = _pair(_np((e, n), 2))
        jkw = {"bias": jb, "activation": "silu"}
        tkw = {"bias": tb, "activation": "silu"}
    want = jops.gemm_grouped(ja, jw, jnp.asarray(gs), **jkw)
    got = gemm_grouped(ta, tw["q"], torch.as_tensor(gs),
                       b_scale=tw["scale"], out_dtype=DT[dtype][1], **tkw)
    _close(got, want, dtype)
    assert not got[int(gs.sum()):].any()


# ---------------------------------------------------------------------------
# plans and the W8A8 re-route
# ---------------------------------------------------------------------------

D, FF, V = 960, 2560, 49152


@pytest.mark.parametrize("shape", [(8, D, D), (8, D, 320), (8, FF, D),
                                   (8, D, V), (300, D, D), (17, 100, 70)])
@pytest.mark.parametrize("case", ["w8a16", "w8a16+res", "w8a16_f32",
                                  "w8a8", "w8a8+res", "gated", "q8out"])
def test_quantized_plans_on_the_tpu_sheet_equal_the_reference(shape, case):
    """The int8 specs resolve to the reference's tile, bytes (q at one
    byte an element plus its scale vector) and footprint."""
    kw = {"b_quant": True}
    ep = "res" if "+res" in case else ""
    if case == "w8a16_f32":
        kw["a_dtype"] = "float32"
    if case.startswith("w8a8"):
        kw.update(a_dtype="int8", out_dtype="float32")
    if case == "gated":
        kw["gated"], ep = True, "silu"
    if case == "q8out":
        ep = "bias+q8"
    j = japi.GemmSpec(epilogue=JEpilogue.parse(ep), tune=False, **kw)
    t = api.GemmSpec(epilogue=Epilogue.parse(ep), **kw)
    assert j.key == t.key
    want = japi.plan(j, shape)
    got = api._resolve(t, *shape, TPU_V5E)
    assert (got.tile.strategy, got.tile.bm, got.tile.bk, got.tile.bn) == \
        (want.tile.strategy, want.tile.bm, want.tile.bk, want.tile.bn)
    assert got.problem.out_dtype == want.problem.out_dtype
    assert got.problem.acc_dtype == want.problem.acc_dtype
    assert got.fallback_reason == want.fallback_reason
    assert got.hbm_bytes == pytest.approx(want.hbm_bytes, rel=1e-12)
    assert got.flops == pytest.approx(want.flops, rel=1e-12)
    assert got.vmem_bytes == want.vmem_bytes


@pytest.mark.parametrize("shape", [(64, 4096, 1536, 128, 1024),
                                   (2400, 1536, 4096, 128, 3072),
                                   (40, 64, 64, 8, 64)])
def test_quantized_grouped_plans_on_the_tpu_sheet_equal_the_reference(
        shape):
    j = japi.GemmSpec(b_quant=True, grouped=True,
                      epilogue=JEpilogue.parse("silu"), tune=False)
    t = api.GemmSpec(b_quant=True, grouped=True,
                     epilogue=Epilogue.parse("silu"))
    want = japi.plan(j, shape)
    got = api._resolve(t, *shape[:3], TPU_V5E, *shape[3:])
    assert (got.tile.bm, got.tile.bk, got.tile.bn) == \
        (want.tile.bm, want.tile.bk, want.tile.bn)
    assert got.hbm_bytes == pytest.approx(want.hbm_bytes, rel=1e-12)
    assert got.vmem_bytes == want.vmem_bytes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epi", ["none", "bias", "res", "bias+res"])
def test_w8a8_reroute_matches_jax_execute(dtype, epi, monkeypatch):
    """Under W8A8 a quantized linear-epilogue GEMM quantizes its rows,
    runs int8 x int8 into int32 and applies the row scale, bias and
    residual outside, bit for bit as the JAX package's ``execute``; a
    silu epilogue stays W8A16 in both."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    m, k, n = 12, 192, 80
    ja, ta = _pair(_np((m, k), 0), dtype)
    jw, tw = _struct_pair(_np((k, n), 1))
    jkw, tkw = _epilogue(m, n, epi, dtype)
    w16 = ops.gemm(ta, tw, **tkw)
    for mod in (quant, jquant):
        mod.set_activation_mode("w8a8")
    got = ops.gemm(ta, tw, **tkw)
    _same(got, jops.gemm(ja, jw, **jkw))
    assert not torch.equal(got, w16)
    sub = api._w8a8_plan(ops.plan(ops.GemmSpec.for_operands(
        ta, tw, **tkw), (m, k, n)))
    assert (sub.spec.a_dtype, sub.spec.b_dtype, sub.problem.out_dtype,
            sub.problem.acc_dtype) == ("int8", "int8", "float32", "int32")
    silu = dict(tkw, activation="silu")
    jsilu = dict(jkw, activation="silu")
    _close(ops.gemm(ta, tw, **silu), jops.gemm(ja, jw, **jsilu), dtype)


def test_one_shot_cache_keeps_struct_and_modes_apart(monkeypatch):
    """ops.gemm's one-shot cache never replays a plan of one kind for the
    other: a tensor and a quantized struct of the same shape, and W8A16
    and W8A8, each take their own path (a repeat equals a fresh call)."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    a = torch.as_tensor(_np((6, 64), 0))
    w = torch.as_tensor(_np((64, 40), 1))
    s = quant.quantize_weight(w)
    dense = ops.gemm(a, w)
    w16 = ops.gemm(a, s)
    quant.set_activation_mode("w8a8")
    w8 = ops.gemm(a, s)
    assert not torch.equal(w8, w16) and not torch.equal(w16, dense)
    api.plan_cache_clear()
    assert torch.equal(ops.gemm(a, s), w8)
    quant.set_activation_mode("none")
    assert torch.equal(ops.gemm(a, s), w16)
    assert torch.equal(ops.gemm(a, w), dense)
    monkeypatch.setenv("REPRO_W8A8", "1")
    assert torch.equal(ops.gemm(a, s), w8)


def test_explain_names_the_int8_path():
    w8a16 = ops.plan(ops.GemmSpec(b_quant=True), (8, D, D)).explain()
    assert "B int8 {q,scale}" in w8a16 and "W8A16" in w8a16 \
        and "re-routed to W8A8" in w8a16
    w8a8 = ops.plan(ops.GemmSpec(a_dtype="int8", b_quant=True,
                                 out_dtype="float32"), (8, D, D)).explain()
    assert "W8A8" in w8a8 and "m16n8k32" in w8a8 and "acc int32" in w8a8
    q8 = ops.plan(ops.GemmSpec(b_quant=True, epilogue="q8"),
                  (8, D, D)).explain()
    assert "-> int8" in q8 and "round half to even" in q8
    gated = ops.plan(ops.GemmSpec(b_quant=True, gated=True,
                                  epilogue="silu"), (8, D, FF)).explain()
    assert "2x int8 {q,scale}" in gated and "re-routed" not in gated


def test_int8_specs_refuse_what_no_kernel_runs():
    with pytest.raises(ValueError, match="float activations"):
        api.GemmSpec(a_dtype="int8", b_quant=True, gated=True,
                     epilogue="silu")
    with pytest.raises(ValueError, match="float activations"):
        api.GemmSpec(a_dtype="int8", b_quant=True, grouped=True)
    with pytest.raises(ValueError, match="int8 A needs an int8 B"):
        api.GemmSpec(a_dtype="int8")
    a = torch.zeros((2, 4))
    s = quant.quantize_weight(torch.ones((4, 3)))
    with pytest.raises(ValueError, match="both gated operands"):
        ops.gemm(a, s, b2=torch.ones((4, 3)), activation="silu")
    with pytest.raises(ValueError, match="struct"):
        ops.execute(ops.plan(ops.GemmSpec(a_dtype="float32",
                                          b_dtype="float32"), (2, 4, 3)),
                    a, s)
