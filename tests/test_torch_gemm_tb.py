"""Kernel B6 (``gemm_tb``) against the JAX package on the CPU, and the
planned API's two dataflows against each other.

The JAX side runs its Pallas ``gemm_tb`` in interpret mode (as
tests/test_kernels.py does), with dims that are tile multiples (the JAX
kernel takes padded operands); the port's wrapper gets the same numpy
inputs on CPU tensors, where it runs ``gemm_tb_plain``: the same
k-chunks accumulated in f32 with the epilogue after the last.  The CUDA
kernel is held against that plain version on the card
(tests/test_torch_cuda.py).

Tolerances: f32 ``atol=rtol=1e-5``; bf16 compared in f32 at
``atol=rtol=2e-2`` (a few bf16 ulps after differently ordered f32 sums).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core.tiling import TileConfig as JTile
from repro.kernels.gemm_tb import gemm_tb as j_gemm_tb
from repro.models import transformer as JT
from repro_torch import ops
from repro_torch.bridge import from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core.tiling import TileConfig
from repro_torch.kernels import api
from repro_torch.kernels.gemm_tb import gemm_tb, gemm_tb_plain
from repro_torch.models import transformer as T

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(shape, dtype, seed, scale=1.0):
    """The same values as a JAX array and a CPU torch tensor."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    jx = jnp.asarray(x, jnp.float32).astype(DTYPES[dtype][0])
    return jx, from_jax({"x": np.asarray(jx)})["x"]


def _close(got_t, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("k,bk,chunks", [(384, 384, 1), (256, 128, 2),
                                         (384, 128, 3)])
@pytest.mark.parametrize("epi", ["none", "bias", "silu", "gelu", "relu",
                                 "residual", "bias+gelu+res", "outdtype"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_tb_matches_jax_interpret(k, bk, chunks, epi, dtype):
    m, n = 16, 256
    tile_j = JTile(8, bk, 128, "tb")
    tile_t = TileConfig(8, bk, 128, "tb")
    assert -(-k // bk) == chunks
    a_j, a_t = _pair((m, k), dtype, 0, k ** -0.5)
    b_j, b_t = _pair((k, n), dtype, 1)
    jkw, tkw = {}, {}
    if "bias" in epi:
        c_j, c_t = _pair((1, n), "float32", 2)
        jkw["bias"], tkw["bias"] = c_j, c_t[0]
    for act in ("silu", "gelu", "relu"):
        if act in epi:
            jkw["activation"] = tkw["activation"] = act
    if "res" in epi:
        r_j, r_t = _pair((m, n), dtype, 3)
        jkw["residual"], tkw["residual"] = r_j, r_t
    if epi == "outdtype":
        jkw["out_dtype"], tkw["out_dtype"] = DTYPES[dtype]
    want = j_gemm_tb(a_j, b_j, tile=tile_j, interpret=True, **jkw)
    before = gemm_tb_plain.launches
    got = gemm_tb(a_t, b_t, tile=tile_t, **tkw)
    assert gemm_tb_plain.launches == before + 1
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    _close(got, want, dtype)


@pytest.mark.parametrize("m,k,n", [(8, 960, 320), (3, 60, 200),
                                   (17, 100, 70), (40, 2560, 96)])
@pytest.mark.parametrize("epi", ["none", "residual", "bias+silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planned_tb_equals_planned_aie_on_the_cpu(m, k, n, epi, dtype):
    rng = np.random.default_rng(5)
    td = DTYPES[dtype][1]
    a = torch.as_tensor(rng.standard_normal((m, k)) * k ** -0.5).to(td)
    w = torch.as_tensor(rng.standard_normal((k, n))).to(td)
    kw = {}
    if epi == "residual":
        kw["residual"] = torch.as_tensor(rng.standard_normal((m, n))).to(td)
    if epi == "bias+silu":
        kw["bias"] = torch.as_tensor(rng.standard_normal(n)).float()
        kw["activation"] = "silu"
    tb = ops.gemm(a, w, strategy="tb", **kw)
    aie = ops.gemm(a, w, strategy="aie", **kw)
    assert ops.plan(ops.GemmSpec.for_operands(a, w, strategy="tb", **kw),
                    (m, k, n)).kernel == "tb"
    assert tb.dtype == aie.dtype == td
    _close(tb, aie.float().numpy(), dtype)


def test_ragged_chunks_and_the_explicit_tile_reach_the_plain_version():
    """A tile whose k-chunk does not divide K (the card's kernel masks the
    ragged last chunk) runs the same chunks on the CPU."""
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.standard_normal((5, 100)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((100, 70)), dtype=torch.float32)
    tile = TileConfig(8, 32, 64, "tb")
    pl = ops.plan(ops.GemmSpec(a_dtype="float32", b_dtype="float32",
                               tile=tile), (5, 100, 70))
    assert pl.tile == tile and pl.chunk_bk == 32
    assert pl.launches == {"gemm_tb": 3, "gemm_tb_final": 1}
    before = gemm_tb_plain.launches
    got = ops.execute(pl, a, w)
    assert gemm_tb_plain.launches == before + 1
    torch.testing.assert_close(got, a @ w, atol=1e-5, rtol=1e-5)


def test_gemm_tb_refuses_int8():
    """int8 operands run (W8A16, W8A8), but an int8 A against a float B,
    a b_scale over a float B and an int8 C without its scale would
    narrow or drop a value silently, and raise."""
    a8 = torch.zeros((2, 4), dtype=torch.int8)
    t = TileConfig(8, 32, 32, "tb")
    assert gemm_tb(a8, a8.T.contiguous(), tile=t).dtype == torch.int32
    with pytest.raises(TypeError, match="int8 A needs an int8 B"):
        gemm_tb(a8, torch.zeros((4, 3)), tile=t)
    with pytest.raises(TypeError, match="b_scale"):
        gemm_tb(torch.zeros((2, 4)), torch.zeros((4, 3)), tile=t,
                b_scale=torch.ones(3))
    with pytest.raises(TypeError, match="out_scale"):
        gemm_tb(a8, torch.zeros((4, 3), dtype=torch.int8), tile=t,
                out_dtype=torch.int8)


def test_smoke_model_on_the_tb_dataflow_matches_jax(monkeypatch):
    """The slice as a whole with every non-gated GEMM planned onto B6 at
    32-wide k-chunks (two chunks at d = 60, five at d_ff = 160): prefill
    + 8 decode steps of smollm-360m-smoke match the JAX package
    (``REPRO_KERNELS=ref``) within 1e-4, greedy tokens identically."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    resolve = api._resolve

    def to_tb(spec, m, k, n, chip=api.HOPPER_H100):
        if not spec.gated:
            spec = dataclasses.replace(spec, tile=TileConfig(8, 32, 32, "tb"))
        return resolve(spec, m, k, n, chip)

    monkeypatch.setattr(api, "_resolve", to_tb)
    api.plan_cache_clear()
    try:
        jcfg = j_smoke("smollm-360m")
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        tp = from_jax(jax.tree.map(np.asarray, jp))
        tcfg = get_smoke_config("smollm-360m")
        toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 12)) \
            .astype(np.int32)
        jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks),
                            JT.init_cache(jcfg, 2, 40))
        before = gemm_tb_plain.launches
        tl, tc = T.prefill(tp, tcfg, torch.as_tensor(toks),
                           T.init_cache(tcfg, 2, 40, device="cpu"))
        for step in range(9):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=1e-4)
            jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
            tt = torch.argmax(tl, -1)[:, None]
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            if step == 8:
                break
            jl, jc = JT.decode_step(jp, jcfg, jt, jc)
            tl, tc = T.decode_step(tp, tcfg, tt, tc)
        # 2 layers x 5 non-gated GEMMs + lm_head, 9 passes
        assert gemm_tb_plain.launches - before == 9 * 11
        assert {p.kernel for p in ops.plans()} == {"tb", "gated"}
    finally:
        api.plan_cache_clear()


# ---------------------------------------------------------------------------
# B6's launch geometry on the Hopper sheet (host side, no card needed)
# ---------------------------------------------------------------------------

from repro_torch.core.hardware import HOPPER_H100  # noqa: E402
from repro_torch.kernels.gemm_tb import n_split  # noqa: E402


@pytest.mark.parametrize("bm,bn,ok", [
    (8, 256, True), (16, 256, True),     # one 16-row block, 32 fragments
    (32, 128, True), (64, 64, True),     # 4 fragments a warp
    (128, 32, True), (8, 16, True),
    (80, 48, False),   # f32 body fits (16 rows a thread), 10 warps needed
    (32, 256, False),  # both bodies refuse
    (64, 128, False)])
def test_launchable_needs_both_bodies_of_b6(bm, bn, ok):
    """A tile is launchable when B6's bf16 body (at most 4 m16 x n8
    fragments of one 16-row block a warp, 8 warps) and its f32 body (one
    column a thread, at most 16 rows) both cover it."""
    assert HOPPER_H100.launchable(bm, bn) is ok


@pytest.mark.parametrize("gm,n_tiles,smem,want", [
    (3, 256, 224 << 10, 6),    # qwen3 wq, m = 300: one CTA an SM
    (5, 128, 152 << 10, 5),    # qwen3 wo + residual, m = 300
    (1, 1536, 74 << 10, 4),    # smollm lm_head at decode: three an SM
    (1, 30, 74 << 10, 1),      # fewer tiles than CTAs: one tile a CTA
    (1, 4748, 146 << 10, 36),  # qwen3 lm_head at decode
])
def test_n_split_gives_each_sm_what_its_shared_memory_holds(gm, n_tiles,
                                                            smem, want):
    per = n_split(gm, n_tiles, smem)
    assert per == want
    ctas = -(-n_tiles // per) * gm
    per_sm = max(1, HOPPER_H100.vmem_bytes // smem)
    assert ctas <= per_sm * HOPPER_H100.sm_count + gm
