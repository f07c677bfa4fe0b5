"""The port's copy of the paper's FPGA models, against the paper and
against the JAX package's original.

The first half is ``tests/test_paper_model.py`` run on
:mod:`repro_torch.core.paper_model` and its tables, with the same
tolerances (exact for Table II; <=1% throughput, <=0.1 GiB/s BW, <=1.5%
RAM-efficiency elsewhere).  The second half holds every function of the
copy equal to ``repro.core.paper_model``'s, exactly, on every row of
Tables II-IV, and both DSEs' design lists equal.

The Stratix DSE solves 120 layouts (about a minute in one process), so
the module solves each layout once per package in a pool of spawned
processes, then runs each package's own ``stratix_dse`` with its
``stratix_ip_solve`` answered from those solutions.
"""

import concurrent.futures
import dataclasses
import math
import multiprocessing

import pytest

from repro.core import paper_model as ref_pm
from repro.core import paper_tables as ref_pt
from repro_torch.core import paper_model as pm
from repro_torch.core import paper_tables as pt
from repro_torch.core.hardware import STRATIX_NX2100, VERSAL_VC1902

def _sol(pattern: str) -> pm.AIESolution:
    return pm.MAXEVA_P1 if pattern == "P1" else pm.MAXEVA_P2


# ---------------------------------------------------------------------------
# Table II: memory-model estimates and the HLS-AUTO failure mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row", pt.VERSAL_TABLE2,
                         ids=[f"{r.u}x{r.v}x{r.w}-{r.pattern}"
                              for r in pt.VERSAL_TABLE2])
def test_table2_model_estimate_exact(row):
    geom = pm.versal_buffer_geometry(_sol(row.pattern), row.u, row.v, row.w)
    found = pm.versal_best_mapping(geom)
    assert found is not None
    mapping, brams, urams = found
    assert mapping == row.mapping
    assert brams == row.model_brams
    assert urams == row.model_urams


@pytest.mark.parametrize("row", pt.VERSAL_TABLE2,
                         ids=[f"{r.u}x{r.v}x{r.w}-{r.pattern}"
                              for r in pt.VERSAL_TABLE2])
def test_table2_hls_auto_exact(row):
    geom = pm.versal_buffer_geometry(_sol(row.pattern), row.u, row.v, row.w)
    _, brams, urams, fails = pm.versal_hls_auto_mapping(geom)
    assert brams == row.auto_brams
    assert urams == row.auto_urams
    assert fails == row.auto_fails
    if fails:  # the paper's over-utilization numbers: 133% / 138% URAM
        assert urams / VERSAL_VC1902.uram_288k > 1.3


# ---------------------------------------------------------------------------
# Table III: Versal top-10 designs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row", pt.VERSAL_TABLE3,
                         ids=[f"{r.u}x{r.v}x{r.w}-{r.pattern}"
                              for r in pt.VERSAL_TABLE3])
def test_table3_geometry_and_resources(row):
    sol = _sol(row.pattern)
    assert sol.compute_gemm == row.compute_gemm
    assert sol.native_buffer(row.u, row.v, row.w) == row.native_buffer
    assert sol.aie_cores == row.aie_cores

    geom = pm.versal_buffer_geometry(sol, row.u, row.v, row.w)
    found = pm.versal_best_mapping(geom)
    assert found is not None
    mapping, brams, urams = found
    # Table III counts are post-implementation; they exceed the buffer
    # model by a small constant number of system FIFO BRAMs.
    assert urams == row.urams
    assert 0 <= row.brams - brams <= pm.BRAM_IMPL_OVERHEAD_TOL
    if row.mapping is not None:
        assert mapping == row.mapping


@pytest.mark.parametrize("row", pt.VERSAL_TABLE3,
                         ids=[f"{r.u}x{r.v}x{r.w}-{r.pattern}"
                              for r in pt.VERSAL_TABLE3])
def test_table3_throughput_within_1pct(row):
    thr = pm.versal_throughput_ops(_sol(row.pattern), row.pl_freq_mhz * 1e6)
    assert abs(thr / 1e12 - row.throughput_tops) / row.throughput_tops < 0.01


@pytest.mark.parametrize("row", pt.VERSAL_TABLE3,
                         ids=[f"{r.u}x{r.v}x{r.w}-{r.pattern}"
                              for r in pt.VERSAL_TABLE3])
def test_table3_bandwidth_column(row):
    """The BW column is bytes/2**30; reproduce to 0.1 'GB/s' printed."""
    sol = _sol(row.pattern)
    thr = pm.versal_throughput_ops(sol, row.pl_freq_mhz * 1e6)
    # Use the paper's measured throughput for the time base so the BW check
    # is independent of the (calibrated) throughput model's <=1% error.
    bw = pm.bytes_to_gibps(pm.versal_bw_bytes(
        sol, row.u, row.v, row.w, row.throughput_tops * 1e12))
    if (row.u, row.v, row.w, row.pattern) == (4, 2, 4, "P1"):
        # Model: 102.88 vs printed 101.9 (1.0%) — the single deviating row;
        # notably the model value falls just above the 102.4 DDR gate while
        # the printed one falls just below.  Documented in EXPERIMENTS.md.
        assert bw == pytest.approx(row.bw_gibps, rel=0.011)
    else:
        assert bw == pytest.approx(row.bw_gibps, abs=0.1)
    # And with the modeled throughput it stays within 1.5% (the 0.4-0.9%
    # throughput-model error compounds with the BW row tolerance).
    bw_model = pm.bytes_to_gibps(
        pm.versal_bw_bytes(sol, row.u, row.v, row.w, thr))
    assert bw_model == pytest.approx(row.bw_gibps, rel=0.015)


@pytest.mark.parametrize("row", pt.VERSAL_TABLE3,
                         ids=[f"{r.u}x{r.v}x{r.w}-{r.pattern}"
                              for r in pt.VERSAL_TABLE3])
def test_table3_ram_efficiency(row):
    sol = _sol(row.pattern)
    geom = pm.versal_buffer_geometry(sol, row.u, row.v, row.w)
    found = pm.versal_best_mapping(geom)
    assert found is not None
    eff = pm.versal_ram_efficiency(geom, found[0])
    assert eff == pytest.approx(row.ram_eff, abs=0.002)


def test_versal_dse_contains_paper_designs():
    """Every Table III (U,V,W) must appear among the DSE's top-8 ranked
    designs for its pattern, and the DSE must not find more reuse than the
    paper's best (=32)."""
    for pattern in ("P1", "P2"):
        designs = pm.versal_dse(_sol(pattern))
        rows = [r for r in pt.VERSAL_TABLE3 if r.pattern == pattern]
        top_reuse = designs[0].reuse
        top8 = {(d.u, d.v, d.w) for d in designs[:8]}
        for r in rows:
            assert (r.u, r.v, r.w) in top8, (pattern, r.u, r.v, r.w)
            assert r.u * r.v * r.w <= top_reuse
        # Paper's best designs achieve the DSE's maximum reuse (=32).
        assert top_reuse == 32


def test_versal_ddr_gate_selects_paper_valid_set():
    """SS V-A2: designs within the printed 102.4 BW gate are exactly the
    four the paper calls valid (75.40-76.93 TOPs, 0.911-0.938 TOPs/W)."""
    valid = [r for r in pt.VERSAL_TABLE3
             if r.bw_gibps <= pt.VERSAL_DDR_LIMIT_GIBPS]
    assert len(valid) == 4
    assert min(r.throughput_tops for r in valid) == 75.40
    assert max(r.throughput_tops for r in valid) == 76.93
    assert min(r.energy_eff for r in valid) == 0.911
    assert max(r.energy_eff for r in valid) == 0.938
    # our BW model must agree with the gate decision row by row, except the
    # single deviating 4x2x4 (P1) row (model 102.9 vs printed 101.9, which
    # straddles the 102.4 gate — documented in EXPERIMENTS.md).
    for r in pt.VERSAL_TABLE3:
        if (r.u, r.v, r.w, r.pattern) == (4, 2, 4, "P1"):
            continue
        bw = pm.bytes_to_gibps(pm.versal_bw_bytes(
            _sol(r.pattern), r.u, r.v, r.w, r.throughput_tops * 1e12))
        assert (bw <= pt.VERSAL_DDR_LIMIT_GIBPS) == (r in valid)


def test_fig7a_frequency_sweep():
    """Fig. 7a: <1.5% throughput drop from 290 to 250 MHz; ~16% from 250
    to 200 MHz (PL streaming becomes the bound)."""
    sol = pm.MAXEVA_P1
    t290 = pm.versal_throughput_ops(sol, 290e6)
    t250 = pm.versal_throughput_ops(sol, 250e6)
    t200 = pm.versal_throughput_ops(sol, 200e6)
    assert (t290 - t250) / t290 < 0.015
    drop = (t250 - t200) / t250
    assert 0.10 < drop < 0.20


def test_versal_peak_fraction_claim():
    """SS V-C3: ~60% of the 128-TOPs AIE theoretical peak."""
    frac = pm.versal_throughput_ops(pm.MAXEVA_P1, 300e6) / 128e12
    lo, hi = pt.VERSAL_PEAK_FRACTION_CLAIM
    assert lo <= frac <= hi + 0.005


# ---------------------------------------------------------------------------
# Table IV: Stratix top-10 designs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row", pt.STRATIX_TABLE4,
                         ids=[f"{r.tb_len}x{r.kp}x{r.np_}x{r.mp}-{r.nprime}"
                              if False else
                              f"{r.tb_len}x{r.kp}x{r.np_}x{r.mp}"
                              f"@{r.native_buffer[2]}"
                              for r in pt.STRATIX_TABLE4])
def test_table4_layout_algebra(row):
    lay = pm.TBLayout(row.tb_len, row.kp, row.np_, row.mp)
    assert lay.compute_gemm == row.compute_gemm
    assert lay.tbs == row.tbs
    assert lay.tbs / STRATIX_NX2100.compute_units <= 0.91 + 1e-9
    # native buffer respects the latency-hiding + capacity constraints
    # (two rows have non-multiple native dims; the paper zero-pads)
    geom = pm.stratix_check_design(lay, row.native_buffer)
    assert geom.m20ks <= STRATIX_NX2100.bram_36k


@pytest.mark.parametrize("row", pt.STRATIX_TABLE4,
                         ids=[f"{r.tb_len}x{r.kp}x{r.np_}x{r.mp}"
                              f"@{r.native_buffer[2]}"
                              for r in pt.STRATIX_TABLE4])
def test_table4_throughput_within_0p3pct(row):
    lay = pm.TBLayout(row.tb_len, row.kp, row.np_, row.mp)
    thr = pm.stratix_throughput_ops(lay, row.freq_mhz * 1e6)
    assert abs(thr / 1e12 - row.throughput_tops) / row.throughput_tops \
        < 0.003


@pytest.mark.parametrize("row", pt.STRATIX_TABLE4,
                         ids=[f"{r.tb_len}x{r.kp}x{r.np_}x{r.mp}"
                              f"@{r.native_buffer[2]}"
                              for r in pt.STRATIX_TABLE4])
def test_table4_m20k_count(row):
    """Eq. 12/14 reproduce the M20K column exactly on 7/10 rows; three rows
    (18x16x4x3, 18x16x3x4, 9x16x6x4) are printed 2.7-4.2% above the buffer
    model — implementation blocks beyond the modeled buffers, mirroring the
    +6..12 BRAM overhead on Versal Table III.  Model never exceeds print."""
    lay = pm.TBLayout(row.tb_len, row.kp, row.np_, row.mp)
    geom = pm.stratix_geometry(lay, *row.native_buffer)
    assert geom.m20ks <= row.brams
    assert (row.brams - geom.m20ks) / row.brams <= 0.045
    overhead_rows = {(18, 16, 4, 3), (18, 16, 3, 4), (9, 16, 6, 4)}
    if (row.tb_len, row.kp, row.np_, row.mp) not in overhead_rows:
        assert geom.m20ks == row.brams, (geom.m20ks, row.brams)


@pytest.mark.parametrize("row", pt.STRATIX_TABLE4,
                         ids=[f"{r.tb_len}x{r.kp}x{r.np_}x{r.mp}"
                              f"@{r.native_buffer[2]}"
                              for r in pt.STRATIX_TABLE4])
def test_table4_bandwidth_column(row):
    bw = pm.bytes_to_gibps(pm.stratix_bw_bytes(
        *row.native_buffer, row.throughput_tops * 1e12))
    assert bw == pytest.approx(row.bw_gibps, abs=0.15)


@pytest.mark.parametrize("row", pt.STRATIX_TABLE4,
                         ids=[f"{r.tb_len}x{r.kp}x{r.np_}x{r.mp}"
                              f"@{r.native_buffer[2]}"
                              for r in pt.STRATIX_TABLE4])
def test_table4_ram_efficiency(row):
    """Printed efficiencies divide by the *implemented* M20K count, so we
    evaluate the model's logical-bit numerator against the printed block
    count (within 1%)."""
    lay = pm.TBLayout(row.tb_len, row.kp, row.np_, row.mp)
    geom = pm.stratix_geometry(lay, *row.native_buffer)
    eff = pm.stratix_ram_efficiency(geom, m20ks=row.brams)
    assert eff == pytest.approx(row.ram_eff, abs=0.01)


def test_stratix_ip_reuse_at_least_paper():
    """Our IP solver must find native buffers with reuse >= the paper's
    published choice for every Table IV layout."""
    for row in pt.STRATIX_TABLE4:
        lay = pm.TBLayout(row.tb_len, row.kp, row.np_, row.mp)
        ours = pm.stratix_ip_solve(lay)
        paper_reuse = math.prod(row.native_buffer)
        assert ours.reuse >= paper_reuse, (row, ours.native_buffer)


def test_stratix_dse_covers_paper_layouts(stratix_dses):
    designs = stratix_dses[pm]
    keys = {(d.layout.tb_len, d.layout.kp, d.layout.np_, d.layout.mp)
            for d in designs}
    for row in pt.STRATIX_TABLE4:
        assert (row.tb_len, row.kp, row.np_, row.mp) in keys


def test_headline_claims():
    """Abstract: up to 77 / 68 TOPs and 0.94 / 1.35 TOPs/W."""
    v = pm.versal_throughput_ops(pm.MAXEVA_P1, 300e6) / 1e12
    assert v == pytest.approx(pt.VERSAL_PEAK_TOPS_CLAIM, rel=0.01)
    lay = pm.TBLayout(18, 16, 4, 3)
    s = pm.stratix_throughput_ops(lay, 349e6) / 1e12
    assert s == pytest.approx(pt.STRATIX_PEAK_TOPS_CLAIM, rel=0.005)
    assert s / STRATIX_NX2100.peak_tops_int8 * 1e12 == pytest.approx(
        pt.STRATIX_PEAK_FRACTION_CLAIM, abs=0.01)


# ---------------------------------------------------------------------------
# The copy against the JAX package's original, exactly
# ---------------------------------------------------------------------------

def _plain(x):
    """Dataclasses (of either package) as nested tuples."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _both(fn_name, *args, **kwargs):
    """``fn_name`` of the copy and of the original on the same arguments,
    each package's dataclass arguments rebuilt in its own classes."""
    out = []
    for mod in (pm, ref_pm):
        a = [_rebuild(mod, x) for x in args]
        out.append(_plain(getattr(mod, fn_name)(*a, **kwargs)))
    return out


def _rebuild(mod, x):
    if isinstance(x, (pm.AIESolution, ref_pm.AIESolution)):
        return mod.AIESolution(*_plain(x))
    if isinstance(x, (pm.TBLayout, ref_pm.TBLayout)):
        return mod.TBLayout(*_plain(x))
    return x


def test_tables_and_constants_equal():
    for name in ("VERSAL_TABLE2", "VERSAL_TABLE3", "STRATIX_TABLE4",
                 "VERSAL_PEAK_TOPS_CLAIM", "STRATIX_PEAK_TOPS_CLAIM",
                 "VERSAL_BEST_EFF_CLAIM", "STRATIX_BEST_EFF_CLAIM",
                 "VERSAL_PEAK_FRACTION_CLAIM", "STRATIX_PEAK_FRACTION_CLAIM",
                 "VERSAL_DDR_LIMIT_GIBPS"):
        assert _plain(getattr(pt, name)) == _plain(getattr(ref_pt, name))
    for name in ("AIE_ARRAY_STALL", "BRAM_IMPL_OVERHEAD_TOL", "BRAM_BITS",
                 "URAM_BITS", "M20K_BITS", "PLIO_BITS", "MAX_DEPTH",
                 "TB_DRAIN_FACTOR", "MAXEVA_P1", "MAXEVA_P2"):
        assert _plain(getattr(pm, name)) == _plain(getattr(ref_pm, name))
    from repro.core import hardware as ref_hw
    from repro_torch.core import hardware as hw
    for name in ("VERSAL_VC1902", "STRATIX_NX2100", "AIE_KERNEL_M",
                 "AIE_KERNEL_K", "AIE_KERNEL_N", "AIE_FREQ_HZ",
                 "AIE_KERNEL_EFFICIENCY", "AIE_MACS_PER_CYCLE", "TB_CHAIN",
                 "TB_DOT", "TB_LANES", "TB_LOAD_CYCLES", "TB_CASCADE_CYCLES"):
        assert _plain(getattr(hw, name)) == _plain(getattr(ref_hw, name))


_VERSAL_ROWS = [(r.u, r.v, r.w, r.pattern) for r in pt.VERSAL_TABLE3] + [
    (r.u, r.v, r.w, r.pattern) for r in pt.VERSAL_TABLE2]


@pytest.mark.parametrize("u,v,w,pattern", _VERSAL_ROWS,
                         ids=[f"{u}x{v}x{w}-{p}-{i}" for i, (u, v, w, p)
                              in enumerate(_VERSAL_ROWS)])
def test_versal_functions_equal(u, v, w, pattern):
    sol = _sol(pattern)
    geom = _both("versal_buffer_geometry", sol, u, v, w)
    assert geom[0] == geom[1]
    g = pm.BufferGeometry(*geom[0])
    rg = ref_pm.BufferGeometry(*geom[0])
    for depth in g.depths():
        assert pm.f_bram(depth) == ref_pm.f_bram(depth)
        assert pm.f_uram(depth) == ref_pm.f_uram(depth)
    for mapping in ("BBB", "BBU", "BUB", "BUU", "UBB", "UBU", "UUB", "UUU"):
        assert pm.versal_mapping_cost(g, tuple(mapping)) == \
            ref_pm.versal_mapping_cost(rg, tuple(mapping))
    best = pm.versal_best_mapping(g)
    assert best == ref_pm.versal_best_mapping(rg)
    assert pm.versal_hls_auto_mapping(g) == ref_pm.versal_hls_auto_mapping(rg)
    assert pm.versal_ram_efficiency(g, best[0]) == \
        ref_pm.versal_ram_efficiency(rg, best[0])
    for fn in ("versal_raw_aie_ops",):
        a, b = _both(fn, sol)
        assert a == b
    for mhz in (200, 250, 290, 300):
        for fn in ("versal_pl_stream_ops", "versal_throughput_ops"):
            a, b = _both(fn, sol, mhz * 1e6)
            assert a == b
    thr = pm.versal_throughput_ops(sol, 300e6)
    a, b = _both("versal_bw_bytes", sol, u, v, w, thr)
    assert a == b
    assert pm.bytes_to_gibps(a) == ref_pm.bytes_to_gibps(b)


@pytest.mark.parametrize("row", pt.STRATIX_TABLE4,
                         ids=[f"{r.tb_len}x{r.kp}x{r.np_}x{r.mp}"
                              f"@{r.native_buffer[2]}"
                              for r in pt.STRATIX_TABLE4])
def test_stratix_functions_equal(row):
    lay = pm.TBLayout(row.tb_len, row.kp, row.np_, row.mp)
    rlay = ref_pm.TBLayout(row.tb_len, row.kp, row.np_, row.mp)
    for prop in ("tbs", "useful_tbs", "compute_gemm", "min_nprime"):
        assert getattr(lay, prop) == getattr(rlay, prop)
    geom = pm.stratix_geometry(lay, *row.native_buffer)
    rgeom = ref_pm.stratix_geometry(rlay, *row.native_buffer)
    assert _plain(geom) == _plain(rgeom) and geom.m20ks == rgeom.m20ks
    assert _plain(pm.stratix_check_design(lay, row.native_buffer)) == \
        _plain(ref_pm.stratix_check_design(rlay, row.native_buffer))
    for depth in (geom.a_depth, geom.b_depth, geom.c_depth):
        assert pm.f_m80(depth) == ref_pm.f_m80(depth)
        assert pm.f_m32(depth) == ref_pm.f_m32(depth)
    thr = pm.stratix_throughput_ops(lay, row.freq_mhz * 1e6)
    assert thr == ref_pm.stratix_throughput_ops(rlay, row.freq_mhz * 1e6)
    assert pm.stratix_bw_bytes(*row.native_buffer, thr) == \
        ref_pm.stratix_bw_bytes(*row.native_buffer, thr)
    for m20ks in (None, row.brams):
        assert pm.stratix_ram_efficiency(geom, m20ks=m20ks) == \
            ref_pm.stratix_ram_efficiency(rgeom, m20ks=m20ks)


@pytest.mark.parametrize("pattern", ["P1", "P2"])
def test_versal_dse_equal(pattern):
    ours = pm.versal_dse(_sol(pattern))
    theirs = ref_pm.versal_dse(ref_pm.MAXEVA_P1 if pattern == "P1"
                               else ref_pm.MAXEVA_P2)
    assert _plain(ours) == _plain(theirs)
    for d, r in zip(ours, theirs):
        for mhz in (250, 300):
            assert d.throughput_ops(mhz * 1e6) == r.throughput_ops(mhz * 1e6)
            assert d.bw_gibps(mhz * 1e6) == r.bw_gibps(mhz * 1e6)


def _layouts(mod):
    """stratix_dse's candidate layouts (its loops and TB filter)."""
    out = []
    units = mod.STRATIX_NX2100.compute_units
    for tb_len in (36, 18, 12, 9):
        for kp in (4, 8, 16):
            for np_ in range(2, 12):
                for mp in range(2, 12):
                    lay = mod.TBLayout(tb_len, kp, np_, mp)
                    if 0.75 * units <= lay.tbs <= units:
                        out.append((tb_len, kp, np_, mp))
    return out


def _ip_solve(package: str, layout):
    """One layout's ``stratix_ip_solve`` in ``package`` (a pool task):
    the design, or None where the package raises ValueError."""
    import importlib
    mod = importlib.import_module(f"{package}.core.paper_model")
    try:
        return mod.stratix_ip_solve(mod.TBLayout(*layout))
    except ValueError:
        return None


@pytest.fixture(scope="module")
def stratix_dses():
    """Each package's ``stratix_dse()`` list, its IP solves run in a pool
    of spawned processes and fed back through its own module."""
    layouts = _layouts(pm)
    assert layouts == _layouts(ref_pm)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(4, mp_context=ctx) as pool:
        futures = {(package, lay): pool.submit(_ip_solve, package, lay)
                   for package in ("repro_torch", "repro") for lay in layouts}
        solved = {key: f.result(timeout=600) for key, f in futures.items()}
    out = {}
    for mod, package in ((pm, "repro_torch"), (ref_pm, "repro")):
        def answer(lay, device=None, _package=package):
            design = solved[(_package, (lay.tb_len, lay.kp, lay.np_,
                                        lay.mp))]
            if design is None:
                raise ValueError(f"no feasible native buffer for {lay}")
            return design
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(mod, "stratix_ip_solve", answer)
            out[mod] = mod.stratix_dse()
    return out


def test_stratix_dse_equal(stratix_dses):
    ours, theirs = stratix_dses[pm], stratix_dses[ref_pm]
    assert len(ours) == len(theirs) > 0
    assert _plain(ours) == _plain(theirs)
    for d, r in zip(ours, theirs):
        assert d.throughput_ops(340e6) == r.throughput_ops(340e6)
        assert d.bw_gibps(340e6) == r.bw_gibps(340e6)
