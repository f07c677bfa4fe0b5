"""B1's and B6's f32 bodies (``csrc/gemm_f32.cuh``) on the host side: the
CTA shapes B1 launches and their shared memory, the grid at the MoE
routers' shapes, B6's f32 tile rule and its footprint on the Hopper
sheet, the Hopper planner's f32 plans, and the plain path against the
JAX package.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``, the f32 body block); here nothing
launches.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiling import TileConfig as JTile
from repro.kernels.gemm_aie import gemm_aie as j_gemm_aie
from repro.kernels.gemm_tb import gemm_tb as j_gemm_tb
from repro_torch import ops
from repro_torch.core import hardware as hw
from repro_torch.core import memory_model
from repro_torch.core.hardware import HOPPER_H100, HopperChip
from repro_torch.core.tiling import GemmProblem, TileConfig, cdiv
from repro_torch.kernels import _build
from repro_torch.kernels import gemm_aie as ga
from repro_torch.kernels.gemm_aie import (F32_CHAINS, F32_STAGES, F32_TILES,
                                          cta_smem_bytes, cta_tile,
                                          gemm_aie)
from repro_torch.kernels.gemm_tb import gemm_tb

F32 = torch.float32
#: qwen3-moe-235b-a22b's router at decode, in a 300-token prefill and a
#: 64-token paged chunk; kimi-k2-1t-a32b's at decode
ROUTERS = {"qwen3 decode": (8, 4096, 128), "qwen3 prefill": (300, 4096, 128),
           "qwen3 chunk": (64, 4096, 128), "kimi decode": (8, 7168, 384)}


def _csrc(name: str) -> str:
    return (_build.CSRC_DIR / name).read_text()


def _aie_shapes():
    """config -> (kBM, kBN, kR, kC, kKS, kStages) as csrc/gemm_f32.cuh
    launch_aie compiles them."""
    text = _csrc("gemm_f32.cuh")
    return {int(c): tuple(map(int, s.split(","))) for c, s in re.findall(
        r"case (\d+):\s*return launch_aie_shape<AieShape<([\d, ]+)>",
        text)}


def test_b1_f32_shapes_are_the_compiled_ones():
    """F32_TILES / F32_CHAINS / F32_STAGES are the shapes launch_aie
    compiles, each a whole number of warps."""
    shapes = _aie_shapes()
    assert sorted(shapes) == sorted(F32_TILES)
    for c, (bm, bn, r, cols, ks, stages) in shapes.items():
        assert F32_TILES[c] == (bm, ks, bn) and F32_CHAINS[c] == (r, cols)
        assert F32_STAGES[c] == stages
        threads = (bm // r) * (bn // cols)
        assert threads in (64, 128) and bm % r == 0 and bn % cols == 0


@pytest.mark.parametrize("m,n", [(1, 128), (8, 128), (8, 384), (9, 128),
                                 (16, 960), (64, 128), (300, 128),
                                 (4096, 128), (4096, 4096), (3, 49152)])
@pytest.mark.parametrize("b_dtype", [F32, torch.int8])
def test_b1_f32_cta_and_its_shared_memory(m, n, b_dtype):
    """cta_tile names the launched f32 shape (8 rows up to m = 64), and
    cta_smem_bytes is its ring (A's slabs and B's at B's width) and an
    mbarrier a stage, within one CTA's 227 KiB."""
    bm, bk, bn = cta_tile(m, n, F32, b_dtype)
    config = ga._f32_config(m, n)
    assert (bm, bk, bn) == F32_TILES[config]
    if m <= 64:
        assert (bm, bn) == (8, 8)
    b_size = 1 if b_dtype == torch.int8 else 4
    smem = cta_smem_bytes(m, n, F32, b_dtype)
    assert smem == F32_STAGES[config] * (bm * bk * 4 + bk * bn * b_size + 8)
    assert smem <= HOPPER_H100.vmem_bytes


@pytest.mark.parametrize("name,ctas,warps", [
    ("qwen3 decode", 16, 32),      # two warps, 8 columns: 16 SMs stream B
    ("kimi decode", 48, 96),
    ("qwen3 chunk", 128, 256),     # two warps a CTA up to 64 rows
    ("qwen3 prefill", 76, 304)])   # 8 x 64, four warps a CTA
def test_router_grids_fill_the_card(name, ctas, warps):
    """At the router shapes B1's f32 grid spreads B's columns over as many
    SMs as the design gives: up to 64 rows two warps a CTA, one chain a
    thread, 8 columns; at 300 rows four warps of 8 x 64 (no more rows a
    CTA reaches 7 of every 8 SMs), one warp a scheduler."""
    m, k, n = ROUTERS[name]
    config = ga._f32_config(m, n)
    bm, _, bn = F32_TILES[config]
    r, c = F32_CHAINS[config]
    assert cdiv(m, bm) * cdiv(n, bn) == ctas
    assert ctas * (bm // r) * (bn // c) // 32 == warps
    assert warps <= 4 * HOPPER_H100.sm_count
    assert (r, c) == ((1, 1) if m <= 64 else (1, 4))


def _old_launchable_256(bm, bn):
    """B6's tile rule before the f32 body had its own (the int8 half and
    the old f32 body's 16 rows a thread)."""
    if not 1 <= bn <= 256 or bm < 1:
        return False
    return -(-bm // 16) * -(-bn // 32) <= 8 and -(-bm // (256 // bn)) <= 16


def test_b6_int8_rule_is_unchanged_and_f32_has_its_own():
    """The int8 half gives the old rule's answer on every tile; the f32
    half is the body's: powers of two, 8-128 rows, 32-256 columns, 1 to 16
    chains a thread, columns first (up to 4), as gemm_tb.cuh launch_f32
    dispatches them."""
    compiled = {tuple(map(int, s.split(","))) for s in re.findall(
        r"launch_f32_shape<(\d+, \d+), kFinal, TB>", _csrc("gemm_tb.cuh"))}
    assert compiled == {(1, 1), (1, 2), (1, 4), (2, 4), (4, 4)}
    for bm in range(1, 300):
        for bn in range(1, 300):
            assert HopperChip._launchable_int8(bm, bn) == \
                _old_launchable_256(bm, bn), (bm, bn)
            ok = HopperChip._launchable_f32(bm, bn)
            assert HOPPER_H100.launchable(bm, bn, "float32", "float32") == ok
            assert HOPPER_H100.launchable(bm, bn, "int8", "int8") == \
                _old_launchable_256(bm, bn)
            if not ok:
                continue
            chains = bm * bn // 256     # columns first, up to 4
            r, c = chains // min(4, chains), min(4, chains)
            assert (r, c) in compiled and r * c * 256 == bm * bn
            assert bm % r == 0 and 256 // (bn // c) * r == bm
    assert HOPPER_H100.launchable(8, 32, "float32", "int8")
    assert not HOPPER_H100.launchable(64, 128, "float32")  # 32 chains
    assert not HOPPER_H100.launchable(24, 64, "float32")   # not a power


@pytest.mark.parametrize("tile,panel", [
    ((8, 1024, 32), 8 * 1024), ((64, 512, 32), 64 * 512),
    ((128, 256, 32), 128 * 256), ((16, 100, 256), 16 * 128),
    ((8, 5216, 32), 8 * 256 * 21)])   # 20 whole panels and a part
@pytest.mark.parametrize("epi", ["", "bias+silu+res"])
def test_b6_f32_footprint_is_the_kernels(tile, panel, epi):
    """An f32 'tb' tile on HOPPER_H100 bills gemm_f32.cuh's tb_smem: the
    panel as panels of at most 256 columns (a chunk on the 32-grid), the
    ring of B and an mbarrier a stage and one for the panel; the partial
    and the epilogue's operands are read on the flush, so they add
    nothing."""
    text = _csrc("gemm_f32.cuh")
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 text).group(1))
             for name in ("kTbStages", "kTbStageBytes", "kTbPanelCols",
                          "kGrid")}
    assert (const["kTbStages"], const["kTbStageBytes"],
            const["kTbPanelCols"], const["kGrid"]) == (
        hw.B6_F32_STAGES, hw.B6_F32_STAGE_BYTES, hw.B6_F32_PANEL_COLS,
        hw.B6_F32_GRID)
    p = GemmProblem(300, 4096, 128, "float32", "float32", "float32",
                    "float32", epi)
    fp = memory_model.vmem_footprint(TileConfig(*tile, "tb"), p, HOPPER_H100)
    stages = const["kTbStages"]
    assert fp.total == panel * 4 + stages * const["kTbStageBytes"] \
        + (stages + 1) * 8


#: HOPPER_H100's f32 plans: the routers, and MoE training's router
#: forward / dB (4096 x 4096 x 128) and dA (4096 x 128 x 4096); the 300-
#: and 64-row routers plan B1 since an f32 plan is priced at the SMs its
#: CTAs fill (B6's 64 x 512 x 32 tile gives them 20 and 4 CTAs)
F32_PLANS = {
    (8, 4096, 128): ("aie", 8, 32, 128),
    (300, 4096, 128): ("aie", 64, 32, 64),
    (64, 4096, 128): ("aie", 64, 32, 64),
    (8, 7168, 384): ("tb", 8, 1024, 32),
    (4096, 4096, 128): ("tb", 128, 256, 32),
    (4096, 128, 4096): ("tb", 128, 128, 32),
}


@pytest.mark.parametrize("shape", sorted(F32_PLANS))
def test_hopper_f32_plans_are_pinned(shape):
    spec = ops.GemmSpec(a_dtype=F32, b_dtype=F32, out_dtype=F32)
    t = ops.plan(spec, shape).tile
    assert (t.strategy, t.bm, t.bk, t.bn) == F32_PLANS[shape]


def test_f32_plans_are_priced_at_the_sms_their_ctas_fill():
    """A dense f32 plan's compute time on HOPPER_H100 is its operations at
    the f32 rate times the share of the 132 SMs its launched CTAs fill,
    and no less than one fmaf chain over k; bf16 and the TPU sheet keep
    operations over the rate."""
    from repro_torch.core.bandwidth import estimate
    from repro_torch.core.hardware import TPU_V5E
    from repro_torch.kernels.gemm_tb import n_split
    m, k, n = 300, 4096, 128
    p = GemmProblem(m, k, n, "float32", "float32", "float32", "float32")
    flops = 2.0 * m * k * n
    tb = TileConfig(64, 512, 32, "tb")
    per = n_split(5, 4, hw.f32_tb_smem(64, 512))
    ctas = 5 * -(-4 // per)
    assert ctas == 20
    est = estimate(tb, p, HOPPER_H100)         # (its padded operations)
    assert est.t_compute == pytest.approx(est.flops / (67e12 * ctas / 132),
                                          rel=1e-12)
    chain = k * hw.F32_FFMA_CYCLES / HOPPER_H100.sm_clock_hz
    aie = estimate(TileConfig(64, 32, 64, "aie"), p, HOPPER_H100)
    # (B1 launches 76 CTAs of 8 x 64, whatever the plan's tile)
    assert aie.t_compute == pytest.approx(max(
        aie.flops / (67e12 * 76 / 132), chain), rel=1e-12)
    one = estimate(TileConfig(8, 32, 128, "aie"),
                   GemmProblem(8, k, n, "float32", "float32", "float32",
                               "float32"), HOPPER_H100)
    assert one.t_compute == pytest.approx(chain)  # the chain bounds decode
    bf = estimate(tb, GemmProblem(m, k, n), HOPPER_H100)
    assert bf.t_compute == pytest.approx(bf.flops / 989e12)
    tpu = estimate(tb, p, TPU_V5E)
    assert tpu.t_compute == pytest.approx(tpu.flops
                                          / TPU_V5E.peak_bf16_flops)
    assert flops <= tpu.flops


@pytest.mark.parametrize("m", [1, 8, 19])
def test_f32_plain_path_matches_jax_at_a_narrowed_router(m):
    """The router's GEMM narrowed to d 256 (128 experts, f32 out): the
    port's B1 and B6 (their plain versions on the CPU; B6 in two k-chunks)
    against the JAX package's gemm_aie and gemm_tb in interpret mode,
    within 1e-5."""
    k, n = 256, 128
    rng = np.random.default_rng(m)
    a = (rng.standard_normal((m, k)) / k ** 0.5).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    mp = -(-m // 8) * 8
    ja, jb = jnp.pad(jnp.asarray(a), ((0, mp - m), (0, 0))), jnp.asarray(b)
    want_aie = np.asarray(j_gemm_aie(ja, jb, tile=JTile(8, 128, 128),
                                     out_dtype=jnp.float32,
                                     interpret=True))[:m]
    want_tb = np.asarray(j_gemm_tb(ja, jb, tile=JTile(8, 128, 128, "tb"),
                                   out_dtype=jnp.float32,
                                   interpret=True))[:m]
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    got_aie = gemm_aie(ta, tb_, out_dtype=F32).numpy()
    got_tb = gemm_tb(ta, tb_, tile=TileConfig(8, 128, 32, "tb"),
                     out_dtype=F32).numpy()
    for got, want in ((got_aie, want_aie), (got_tb, want_tb)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
