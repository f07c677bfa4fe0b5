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


@pytest.mark.parametrize("bm,bn,dtype,ok", [
    (8, 256, "float32", True), (16, 256, "float32", True),  # 32 fragments
    (32, 128, "float32", True), (64, 64, "int8", True),   # 4 a warp
    (128, 32, "float32", True), (8, 16, "int8", True),
    (80, 48, "float32", False),  # 16 rows a thread fit, 10 warps needed
    (32, 256, "int8", False),    # both 256-thread bodies refuse
    (64, 128, "float32", False),
    # bf16 x bf16: the warp-specialised body takes up to 128 x 256
    (64, 128, "bfloat16", True), (128, 256, "bfloat16", True),
    (80, 48, "bfloat16", True), (8, 16, "bfloat16", True),
    (129, 64, "bfloat16", False), (64, 257, "bfloat16", False)])
def test_launchable_needs_both_bodies_of_b6(bm, bn, dtype, ok):
    """A bf16 x bf16 tile is launchable when B6's warp-specialised body
    covers it (at most 128 rows and 256 columns); any other when both of
    its 256-thread bodies do (the int8 tensor-core one: at most 4 m16 x n8
    fragments of one 16-row block a warp, 8 warps; the f32 one: one
    column a thread, at most 16 rows)."""
    assert HOPPER_H100.launchable(bm, bn, dtype, dtype) is ok


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


# ---------------------------------------------------------------------------
# B6's warp-specialised bf16 body on the Hopper sheet (host side)
# ---------------------------------------------------------------------------

import re  # noqa: E402

from repro_torch import ops  # noqa: E402
from repro_torch.core import memory_model  # noqa: E402
from repro_torch.core.hardware import TPU_V5E, ws_tb_tile  # noqa: E402
from repro_torch.core.tiling import GemmProblem as TGemmProblem  # noqa
from repro_torch.kernels import _build  # noqa: E402


def _csrc_int(name: str, path: str) -> int:
    """``constexpr int name = <int>;`` from a CUDA source of the port."""
    text = (_build.CSRC_DIR / path).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_ws_constants_are_the_kernels():
    """The footprint model's stage depth, ring sizes and static bytes are
    the ones csrc/gemm_ws.cuh compiles."""
    from repro_torch.core import hardware as hw
    assert memory_model.WS_BK == _csrc_int("kBK", "gemm_ws.cuh") == 64
    assert hw.B6_WS_STAGES == _csrc_int("kTbStages", "gemm_ws.cuh")
    assert hw.B6_WS_RING_BYTES == _csrc_int("kTbRingBytes", "gemm_ws.cuh")
    assert hw.B6_WS_MAX_STAGES == _csrc_int("kMaxStages", "gemm_ws.cuh")
    assert memory_model.WS_STATIC_SMEM == _csrc_int("kStaticSmem",
                                                    "gemm_ws.cuh")


@pytest.mark.parametrize("bm,bk,bn,rows,cols", [
    (8, 512, 64, 16, 64),       # the mma.sync form: 16 rows, one panel
    (16, 1024, 256, 16, 256),   # four panels
    (8, 4096, 16, 16, 16),      # one narrow panel
    (8, 512, 48, 16, 64),       # bn rounded up to a power of two
    (64, 256, 32, 64, 64),      # one consumer warpgroup, N 64
    (64, 256, 128, 64, 128),
    (80, 256, 96, 128, 128),    # two; bn rounded up to whole panels
    (128, 256, 256, 128, 256)])
def test_ws_tb_footprint_is_the_kernels_smem_formula(bm, bk, bn, rows,
                                                     cols):
    """vmem_footprint of a bf16 'tb' tile on HOPPER_H100 is gemm_tb.cuh's
    ws_smem (the A panel in 64-deep boxes of the CTA's rows, a ring of
    B's panels -- 4 stages on wgmma, 64 KiB's worth (4 to 16) in the
    mma.sync form -- and one f32 C stage) plus the barriers' 1 KiB, what
    gemm_tb_smem_bytes returns on the card."""
    assert ws_tb_tile(bm, bn) == (rows, cols)
    p = TGemmProblem(300, 960, 960)
    fp = memory_model.vmem_footprint(TileConfig(bm, bk, bn, "tb"), p,
                                     HOPPER_H100)
    stages = 4 if rows > 16 else min(16, max(4, 65536 // (128 * cols)))
    want = (-(-bk // 64) * rows * 128 + stages * 64 * cols * 2
            + rows * bn * 4 + 1024)
    assert fp.total == want
    # the epilogue's operands are read on the flush, not staged
    pe = TGemmProblem(300, 960, 960, epilogue="bias+silu+res")
    assert memory_model.vmem_footprint(TileConfig(bm, bk, bn, "tb"), pe,
                                       HOPPER_H100).total == want


def test_hopper_search_proposes_unpadded_bf16_tiles():
    """The search's bf16 'tb' candidates are tiles the body runs without
    padded work (at most 16 rows, or exactly the 64- or 128-row CTA, and
    the CTA's width) or that cover the problem whole; f32 keeps the
    256-thread rule."""
    bf16 = TGemmProblem(300, 960, 960)
    assert HOPPER_H100.tile_aligned(64, 256, 128, bf16)
    assert HOPPER_H100.tile_aligned(16, 256, 256, bf16)
    assert HOPPER_H100.tile_aligned(8, 256, 32, bf16)   # mma.sync form
    assert not HOPPER_H100.tile_aligned(32, 256, 128, bf16)
    assert not HOPPER_H100.tile_aligned(64, 256, 32, bf16)
    assert HOPPER_H100.tile_aligned(8, 32, 32, TGemmProblem(2, 4, 3))
    f32 = TGemmProblem(300, 960, 960, "float32", "float32")
    assert HOPPER_H100.tile_aligned(32, 256, 128, f32)
    assert not HOPPER_H100.tile_aligned(64, 256, 128, f32)
    # the gated search keeps the 256-thread rule in bf16 too
    gated = TGemmProblem(300, 960, 960, n_b_operands=2)
    assert HOPPER_H100.tile_aligned(32, 256, 128, gated)
    # the TPU sheet does not look at the problem
    for p in (bf16, f32, None):
        assert TPU_V5E.tile_aligned(128, 256, 128, p)


@pytest.mark.parametrize("m,k,n,tile,cta", [
    (8, 2560, 960, (8, 512, 64), "16x64 CTA (the mma.sync form"),
    (300, 960, 960, (64, 256, 128), "64x128 CTA (1 consumer"),
    (300, 960, 960, (128, 256, 128), "128x128 CTA (2 consumer")])
def test_explain_names_the_cta_b6_launches(m, k, n, tile, cta):
    pl = ops.plan(ops.GemmSpec(tile=TileConfig(*tile, "tb")), (m, k, n))
    text = pl.explain()
    assert "src/repro_torch/csrc/gemm_ws.cuh" in text
    assert f"launches a {cta}" in text
    f32 = ops.plan(ops.GemmSpec(a_dtype="float32", b_dtype="float32",
                                tile=TileConfig(8, 512, 64, "tb")),
                   (m, k, n)).explain()
    assert "csrc/gemm_tb.cu" in f32 and "launches a" not in f32
