"""The port's cost model and tiling search (``repro_torch.core``) against
the JAX package's (``repro.core``), run on the port's copy of the
``TPU_V5E`` sheet; and the port's own plans on ``HOPPER_H100``, pinned so
that a change to the sheet shows in review.

Modeled bytes and times must agree to a relative 1e-12 (the same float
arithmetic in the same order); tiles, strategies and footprints exactly.
"""

import itertools

import pytest

from repro.core import bandwidth as j_bw
from repro.core import dse as j_dse
from repro.core import memory_model as j_mem
from repro.core import tiling as j_tiling
from repro.kernels import gemm_tb as j_gemm_tb
from repro_torch.core import bandwidth as t_bw
from repro_torch.core import dse as t_dse
from repro_torch.core import memory_model as t_mem
from repro_torch.core import tiling as t_tiling
from repro_torch.core.hardware import HOPPER_H100, TPU_V5E
from repro_torch.kernels import api
from repro_torch.kernels.gemm_tb import feasible_bk

REL = 1e-12
D, FF, V = 960, 2560, 49152
#: (k, n) of every GEMM on smollm-360m's serve path
SERVE_KN = {"wq/wo": (D, D), "wk/wv": (D, 320), "gate/up": (D, FF),
            "down": (FF, D), "lm_head": (D, V)}
DTYPES = [("bfloat16", "bfloat16"), ("float32", "float32"),
          ("bfloat16", "float32"), ("float32", "bfloat16")]
EPILOGUES = ["", "bias", "silu", "res", "bias+gelu+res"]


def _problems(m, k, n, a, b, ep, nb=1):
    args = (m, k, n, a, a, "float32", b, ep, nb)
    return j_tiling.GemmProblem(*args), t_tiling.GemmProblem(*args)


def _same(x, y):
    return abs(x - y) <= REL * max(abs(x), abs(y))


@pytest.mark.parametrize("m", [1, 8, 300, 1024])
@pytest.mark.parametrize("shape", sorted(SERVE_KN))
def test_solve_ranks_the_same_designs_as_the_reference(m, shape):
    k, n = SERVE_KN[shape]
    cases = [(a, b, ep, 1) for (a, b), ep in itertools.product(DTYPES,
                                                               EPILOGUES)]
    cases += [(a, b, "silu", 2) for a, b in DTYPES]     # gated
    for a, b, ep, nb in cases:
        jp, tp = _problems(m, k, n, a, b, ep, nb)
        want = j_dse.solve(jp, top=10)
        got = t_dse.solve(tp, TPU_V5E, top=10)
        assert [(d.tile.bm, d.tile.bk, d.tile.bn, d.tile.strategy)
                for d in got] == [(d.tile.bm, d.tile.bk, d.tile.bn,
                                   d.tile.strategy) for d in want], jp
        for g, w in zip(got, want):
            assert _same(g.traffic.hbm_bytes, w.traffic.hbm_bytes)
            assert _same(g.traffic.t_model, w.traffic.t_model)
            assert g.vmem_bytes == w.vmem_bytes
            assert _same(g.vmem_eff, w.vmem_eff)


TILES = [(8, 128, 128), (16, 256, 512), (256, 1024, 128), (1024, 2048, 2048),
         (8, 2048, 128), (512, 512, 1024)]


@pytest.mark.parametrize("strategy", ["aie", "tb"])
@pytest.mark.parametrize("tile", TILES)
def test_footprint_fit_and_traffic_agree_case_by_case(tile, strategy):
    for (m, (k, n)), (a, b), ep in itertools.product(
            [(8, SERVE_KN["wk/wv"]), (300, SERVE_KN["down"]),
             (1024, SERVE_KN["lm_head"])], DTYPES, EPILOGUES):
        jp, tp = _problems(m, k, n, a, b, ep)
        jt = j_tiling.TileConfig(*tile, strategy)
        tt = t_tiling.TileConfig(*tile, strategy)
        assert t_mem.vmem_footprint(tt, tp, TPU_V5E).as_dict() == \
            j_mem.vmem_footprint(jt, jp).as_dict()
        assert t_mem.fits_vmem(tt, tp, TPU_V5E) == j_mem.fits_vmem(jt, jp)
        assert _same(t_bw.hbm_traffic_bytes(tt, tp),
                     j_bw.hbm_traffic_bytes(jt, jp))
        assert _same(t_mem.vmem_efficiency(tt, tp, TPU_V5E),
                     j_mem.vmem_efficiency(jt, jp))
        assert tt.mxu_aligned(TPU_V5E) == jt.mxu_aligned()


@pytest.mark.parametrize("tile", TILES + [(8, 1024, 128), (128, 384, 256)])
def test_feasible_bk_agrees_on_the_tpu_sheet(tile):
    t = t_tiling.TileConfig(*tile, "tb")
    j = j_tiling.TileConfig(*tile, "tb")
    for (m, k, n), (a, b), ep in itertools.product(
            [(8, 1024, 384), (256, 2560, 1024), (2048, 8192, 2048),
             (1024, 384, 49152)], DTYPES, ["", "res", "bias+silu+res"]):
        assert feasible_bk(m, k, n, t, a, b, a, "float32", ep,
                           chip=TPU_V5E) == \
            j_gemm_tb.feasible_bk(m, k, n, j, a, b, a, "float32",
                                  epilogue=ep), (m, k, n, tile, a, b, ep)


#: HOPPER_H100's plan of every serve-path GEMM of smollm-360m (bf16):
#: (strategy, bm, bk, bn).  A change to the sheet or the search that moves
#: one of these should be seen in review.
HOPPER_PLANS = {
    1: {"wq": ("aie", 8, 32, 256), "wk": ("aie", 8, 32, 64),
        "wo": ("aie", 8, 32, 256), "gate_up": ("aie", 8, 32, 256),
        "down": ("tb", 8, 512, 32), "lm_head": ("aie", 8, 32, 256)},
    8: {"wq": ("aie", 8, 32, 256), "wk": ("aie", 8, 32, 64),
        "wo": ("aie", 8, 32, 256), "gate_up": ("aie", 8, 32, 256),
        "down": ("tb", 8, 512, 32), "lm_head": ("aie", 8, 32, 256)},
    300: {"wq": ("aie", 128, 32, 256), "wk": ("tb", 128, 512, 64),
          "wo": ("aie", 128, 32, 256), "gate_up": ("aie", 64, 32, 64),
          "down": ("aie", 128, 32, 256), "lm_head": ("aie", 128, 32, 256)},
    1024: {"wq": ("aie", 128, 32, 256), "wk": ("tb", 128, 512, 64),
           "wo": ("aie", 128, 32, 256), "gate_up": ("aie", 64, 32, 64),
           "down": ("aie", 128, 32, 256), "lm_head": ("aie", 128, 32, 256)},
}
SERVE_SPECS = {
    "wq": (D, D, {}), "wk": (D, 320, {}),
    "wo": (D, D, {"epilogue": "res"}),
    "gate_up": (D, FF, {"gated": True, "epilogue": "silu"}),
    "down": (FF, D, {"epilogue": "res"}),
    "lm_head": (D, V, {"out_dtype": "float32"}),
}


@pytest.mark.parametrize("m", sorted(HOPPER_PLANS))
def test_hopper_plans_of_the_serve_shapes_are_pinned(m):
    for name, (k, n, kw) in SERVE_SPECS.items():
        t = api._resolve(api.GemmSpec(**kw), m, k, n, HOPPER_H100).tile
        assert (t.strategy, t.bm, t.bk, t.bn) == HOPPER_PLANS[m][name], name


@pytest.mark.parametrize("m", [1, 8, 300, 1024])
def test_every_hopper_candidate_fits_and_launches(m):
    """Every design the search ranks on HOPPER_H100 fits one CTA's
    227 KiB and is a (bm, bn) tile kernel B6 launches for its dtypes."""
    for name, (k, n, kw) in SERVE_SPECS.items():
        spec = api.GemmSpec(**kw)
        p = api._problem_for(spec, m, k, n)
        for d in t_dse.solve(p, HOPPER_H100, top=10_000):
            assert d.vmem_bytes <= 227 * 1024 == HOPPER_H100.vmem_bytes
            assert HOPPER_H100.launchable(d.tile.bm, d.tile.bn, p.a_dtype,
                                          p.b_dtype), d.tile
            assert d.tile.mxu_aligned(HOPPER_H100, p)


def test_search_is_memoized_per_sheet():
    p = t_tiling.GemmProblem(8, D, 320)
    t_dse._solve_cached.cache_clear()
    tpu = t_dse.solve(p, TPU_V5E)
    h100 = t_dse.solve(p, HOPPER_H100)
    assert tpu[0].tile != h100[0].tile
    assert t_dse.solve(p, TPU_V5E) == tpu
    info = t_dse._solve_cached.cache_info()
    assert (info.misses, info.hits) == (2, 1)


def test_calibration_reranks_instead_of_serving_stale_answers():
    p = t_tiling.GemmProblem(300, D, D)
    before = t_dse.solve(p, HOPPER_H100, top=1)[0]
    try:
        t_bw.set_calibration(t_bw.Calibration(hbm_bw=1e9))
        after = t_dse.solve(p, HOPPER_H100, top=1)[0]
        assert after.traffic.t_model > 100 * before.traffic.t_model
    finally:
        t_bw.clear_calibration()
    assert t_dse.solve(p, HOPPER_H100, top=1)[0] == before


def test_grouped_problems_wait_for_a9():
    """ROADMAP A9's grouped GEMM has landed: a grouped problem is now
    searched ('aie' only) and billed per tile instance, as the reference
    bills it, and on HOPPER_H100 only at tiles kernel B7 launches."""
    args = (64, 128, 128, "bfloat16", "bfloat16", "float32", "bfloat16",
            "", 1, 4)
    jp, tp = j_tiling.GemmProblem(*args), t_tiling.GemmProblem(*args)
    for tile in (t_tiling.TileConfig(8, 128, 128),
                 t_tiling.TileConfig(16, 128, 128)):
        jt = j_tiling.TileConfig(tile.bm, tile.bk, tile.bn)
        assert _same(t_bw.hbm_traffic_bytes(tile, tp),
                     j_bw.hbm_traffic_bytes(jt, jp))
        assert _same(t_bw.estimate(tile, tp, TPU_V5E).flops,
                     j_bw.estimate(jt, jp).flops)
    designs = t_dse.solve(tp, HOPPER_H100)
    assert designs and all(d.tile.strategy == "aie" for d in designs)
    assert all(HOPPER_H100.grouped_launchable(d.tile.bm, d.tile.bn)
               for d in designs)


@pytest.mark.parametrize("strategy", [None, "aie", "tb"])
def test_best_tile_matches_the_reference(strategy):
    for m, (k, n) in [(8, SERVE_KN["wk/wv"]), (300, SERVE_KN["down"]),
                      (1024, SERVE_KN["wq/wo"])]:
        try:
            want = j_dse.best_tile(m, k, n, strategy=strategy,
                                   epilogue="res")
        except ValueError:      # no design of that strategy in the top 10
            with pytest.raises(ValueError, match="no feasible"):
                t_dse.best_tile(m, k, n, strategy=strategy, epilogue="res",
                                chip=TPU_V5E)
            continue
        got = t_dse.best_tile(m, k, n, strategy=strategy, epilogue="res",
                              chip=TPU_V5E)
        assert (got.bm, got.bk, got.bn, got.strategy) == \
            (want.bm, want.bk, want.bn, want.strategy)
