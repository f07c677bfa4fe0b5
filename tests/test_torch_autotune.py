"""The port's measured tuning against the JAX package's, on the CPU.

* The harness: ``reject_outliers`` and ``Measurement`` equal the
  reference's on hypothesis-drawn samples; ``measure_plan`` with an
  injected timer is deterministic, runs the plain versions on the CPU,
  leaves the kernels' launch counters as it found them and says that it
  is measuring.
* Keys: ``GemmSpec.key`` and the tuning-cache key equal the reference's
  for the same specs; a second process computes the same key.
* The reference's ``tests/test_autotune.py`` contract through the port's
  ``plan()``, with an injected measurer and ``device="cpu"``: a winner
  is selected and cached exactly once, a second process makes zero
  measurements, spec -> module -> env precedence, the backward never
  tunes, the flop budget skips the search, grouped specs stay analytic,
  and corrupt, stale or malformed caches fall back to the analytic plan.
  Without a card and without ``device="cpu"`` nothing is measured.
* ``explain()``'s ``source`` line: ``analytic``, ``tuned (measured
  top-K)`` with the analytic choice's time, ``tuned (cache)``.
* Calibration: ``fit`` equals ``repro.tune.calibrate.fit`` on the same
  entries (relative 1e-9), dropped terms and too few samples included;
  ``apply`` re-prices and ``clear`` restores; an f32 GEMM keeps the
  sheet's f32/bf16 ratio under a calibration.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import api as japi
from repro.tune import cache as jcache
from repro.tune import calibrate as jcalibrate
from repro.tune import measure as jmeasure
from repro_torch import ops
from repro_torch.core import bandwidth
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.kernels import api
from repro_torch.kernels.gemm_aie import gemm_aie_plain
from repro_torch.kernels.gemm_tb import gemm_tb_plain
from repro_torch.tune import autotune, cache, calibrate, measure

SHAPE = (16, 128, 128)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Every test gets its own tuning-cache file and fresh plan state;
    the autotune switches are restored afterwards.  Searches measure on
    the CPU."""
    monkeypatch.setenv("REPRO_TUNE_CACHE",
                       str(tmp_path / "tune_cache.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    cache.tuning_cache_reset()
    api.plan_cache_clear()
    monkeypatch.setattr(autotune, "_enabled", None)  # unset, not off
    monkeypatch.setattr(autotune, "_k", None)
    monkeypatch.setattr(autotune, "_device", torch.device("cpu"))
    yield
    calibrate.clear()
    cache.tuning_cache_reset()
    api.plan_cache_clear()


# ---------------------------------------------------------------------------
# Measurement harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("times", [
    (1.0, 1.02, 0.98, 1.01, 50.0), (2.0, 2.0, 2.0), (1.0, 9.0),
    (1.0, 1.0, 10.0, 10.0), (), (3.0,)])
def test_reject_outliers_hand_cases_equal_the_reference(times):
    assert measure.reject_outliers(times) == jmeasure.reject_outliers(times)


def test_reject_outliers_drops_a_gc_pause_and_keeps_half():
    kept = measure.reject_outliers((1.0, 1.02, 0.98, 1.01, 50.0))
    assert set(kept) == {1.0, 1.02, 0.98, 1.01}
    assert len(measure.reject_outliers((1.0, 1.0, 10.0, 10.0))) >= 2


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(1e-6, 10.0, allow_nan=False), max_size=16),
       st.floats(0.5, 6.0))
def test_reject_outliers_equals_the_reference(times, cutoff):
    times = tuple(times)
    assert measure.reject_outliers(times, cutoff) == \
        jmeasure.reject_outliers(times, cutoff)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.floats(1e-6, 10.0, allow_nan=False), min_size=1,
                max_size=12), st.integers(0, 4))
def test_measurement_equals_the_reference(times, warmup):
    times = tuple(times)
    kept = measure.reject_outliers(times)
    a = measure.Measurement(times_s=times, kept_s=kept, warmup=warmup)
    b = jmeasure.Measurement(times_s=times, kept_s=kept, warmup=warmup)
    for name in ("iters", "rejected", "median_s", "mean_s", "spread"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("DEFAULT_ITERS", "DEFAULT_WARMUP", "DEFAULT_MAX_FLOPS",
                 "MAD_CUTOFF"):
        assert getattr(measure, name) == getattr(jmeasure, name)


def test_measure_plan_with_fake_timer_is_deterministic():
    ticks = iter(np.arange(0.0, 100.0, 0.5))
    pl = ops.plan(ops.GemmSpec(), SHAPE)
    meas = measure.measure_plan(pl, iters=3, warmup=1, device="cpu",
                                timer=lambda: float(next(ticks)))
    assert meas.times_s == (0.5, 0.5, 0.5)
    assert meas.median_s == 0.5 and meas.spread == 0.0
    assert meas.warmup == 1


@pytest.mark.parametrize("spec", [
    ops.GemmSpec(), ops.GemmSpec(strategy="tb"),
    ops.GemmSpec(epilogue="bias+gelu+res"),
    ops.GemmSpec(gated=True, epilogue="silu"),
    ops.GemmSpec(b_quant=True), ops.GemmSpec(a_dtype="float32",
                                             b_dtype="float32")],
    ids=lambda s: s.key)
def test_measure_plan_runs_plain_versions_and_restores_counters(spec):
    """On the CPU the plan runs its plain version; the launch counters
    read as before the measurement, and ``measuring()`` is true only
    inside it."""
    pl = ops.plan(spec, SHAPE)
    seen = []
    orig = api._launch

    def spy(*args, **kw):
        seen.append(measure.measuring())
        return orig(*args, **kw)

    before = (gemm_aie_plain.launches, gemm_tb_plain.launches)
    api._launch = spy
    try:
        meas = measure.measure_plan(pl, iters=2, warmup=1, device="cpu")
    finally:
        api._launch = orig
    assert meas.iters == 2 and meas.median_s > 0
    assert seen and all(seen) and not measure.measuring()
    assert (gemm_aie_plain.launches, gemm_tb_plain.launches) == before


def test_synthesized_operands_match_the_spec():
    spec = ops.GemmSpec(b_quant=True, epilogue="bias+res")
    pl = ops.plan(spec, SHAPE)
    o = measure.synthesize_operands(pl, np.random.default_rng(0), "cpu")
    m, k, n = SHAPE
    assert o["a"].shape == (m, k) and o["a"].dtype == torch.bfloat16
    assert o["b"]["q"].dtype == torch.int8 and o["b"]["q"].shape == (k, n)
    assert o["b"]["scale"].shape == (1, n)
    assert o["bias"].shape == (n,) and o["residual"].shape == (m, n)
    assert o["b2"] is None and o["out_scale"] is None


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

SPECS = [
    dict(), dict(b_quant=True), dict(gated=True, epilogue="silu"),
    dict(epilogue="bias+gelu+res"), dict(strategy="tb"),
    dict(a_dtype="float32", b_dtype="float32", out_dtype="float32"),
    dict(b_quant=True, epilogue="silu"), dict(epilogue="res", tune=True),
    dict(a_dtype="int8", b_quant=True, out_dtype="float32"),
]


@pytest.mark.parametrize("kw", SPECS, ids=str)
@pytest.mark.parametrize("mode", ["cpu", "cuda:NVIDIA H100 80GB HBM3"])
def test_cache_key_equals_the_reference(kw, mode):
    mine = ops.GemmSpec(**kw)
    ref = japi.GemmSpec(**kw)
    assert mine.key == ref.key
    assert cache.cache_key(mine, SHAPE, mode) == \
        jcache.cache_key(ref, SHAPE, mode)


def test_cache_key_is_stable_across_processes():
    spec = ops.GemmSpec(b_quant=True, epilogue="silu")
    local = cache.cache_key(spec, SHAPE, "cpu")
    prog = (
        "from repro_torch import ops\n"
        "from repro_torch.tune import cache\n"
        "spec = ops.GemmSpec(b_quant=True, epilogue='silu')\n"
        f"print(cache.cache_key(spec, {SHAPE!r}, 'cpu'))\n")
    out = subprocess.run([sys.executable, "-c", prog], text=True,
                         capture_output=True, check=True,
                         env=os.environ.copy())
    assert out.stdout.strip() == local
    assert "|16x128x128|cpu" in local


def test_device_mode_names_the_device():
    assert cache.device_mode("cpu") == "cpu"
    assert cache.device_mode(torch.device("cpu")) == "cpu"


@pytest.mark.parametrize("tune", [True, False])
def test_tune_field_never_changes_the_cache_key(tune):
    base = cache.cache_key(ops.GemmSpec(), SHAPE, "cpu")
    assert cache.cache_key(ops.GemmSpec(tune=tune), SHAPE, "cpu") == base


def test_cache_round_trip_persists_across_instances(tmp_path):
    path = str(tmp_path / "rt.json")
    c1 = cache.TuningCache(path)
    entry = {"tile": {"bm": 16, "bk": 128, "bn": 128, "strategy": "aie"},
             "t_us": 12.5, "mode": "cpu"}
    c1.put("k1", entry)
    c2 = cache.TuningCache(path)
    got = c2.get("k1")
    assert got is not None and got["tile"] == entry["tile"]
    assert got["t_us"] == 12.5 and "created" in got
    assert c2.info() == cache.TuningCacheInfo(1, 1, 0, 0, 0)
    assert c1.info() == cache.TuningCacheInfo(1, 0, 0, 1, 0)
    assert cache.DEFAULT_PATH == jcache.DEFAULT_PATH
    assert cache.SCHEMA_VERSION == jcache.SCHEMA_VERSION


def test_the_reference_reads_the_ports_cache_file(tmp_path):
    """Same schema: a file the port wrote loads in the JAX package."""
    path = str(tmp_path / "x.json")
    cache.TuningCache(path).put("k", {"tile": {"bm": 8}, "mode": "cpu"})
    assert jcache.TuningCache(path).get("k")["tile"] == {"bm": 8}


# ---------------------------------------------------------------------------
# Degradation: corrupt / stale / malformed caches, no device
# ---------------------------------------------------------------------------

def _fake_measurer(times_by_tile: dict, default: float = 2e-3,
                   explode: bool = False):
    """measure_plan stand-in: wall clock keyed by tile, call-counted."""
    def fake(pl, *, iters=3, warmup=1, rng=None, timer=None, device=None):
        fake.calls.append(pl.tile)
        fake.devices.append(device)
        if explode:
            raise RuntimeError("no measuring allowed")
        t = times_by_tile.get(
            (pl.tile.bm, pl.tile.bk, pl.tile.bn, pl.tile.strategy),
            default)
        return measure.Measurement(times_s=(t,) * iters,
                                   kept_s=(t,) * iters, warmup=warmup)
    fake.calls = []
    fake.devices = []
    return fake


def test_corrupt_cache_warns_and_plan_survives(tmp_path, monkeypatch):
    path = str(tmp_path / "corrupt.json")
    with open(path, "w") as f:
        f.write("{not json at all")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    cache.tuning_cache_reset()
    monkeypatch.setattr(measure, "measure_plan", _fake_measurer({}))
    with pytest.warns(UserWarning, match="unreadable"):
        pl = ops.plan(ops.GemmSpec(tune=True), SHAPE)
    assert pl.tile is not None
    assert cache.tuning_cache_info().load_errors == 1


def test_stale_schema_warns_and_falls_back(tmp_path, monkeypatch):
    path = str(tmp_path / "stale.json")
    with open(path, "w") as f:
        json.dump({"schema": cache.SCHEMA_VERSION + 1,
                   "entries": {"k": {}}}, f)
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    cache.tuning_cache_reset()
    with pytest.warns(UserWarning, match="stale"):
        assert cache.tuning_cache().get("k") is None
    monkeypatch.setattr(measure, "measure_plan",
                        _fake_measurer({}, explode=True))
    assert ops.plan(ops.GemmSpec(tune=True), SHAPE).source == "analytic"


@pytest.mark.parametrize("bad", ["not-a-tile-dict", {"bm": 8},
                                 {"bm": "x", "bk": 1, "bn": 1,
                                  "strategy": "aie"}])
def test_malformed_entry_degrades_to_analytic(monkeypatch, bad):
    c = cache.tuning_cache()
    c.put(cache.cache_key(ops.GemmSpec(), SHAPE, "cpu"), {"tile": bad})
    monkeypatch.setattr(measure, "measure_plan",
                        _fake_measurer({}, explode=True))
    pl = ops.plan(ops.GemmSpec(tune=True), SHAPE)
    assert pl.source == "analytic" and pl.tuned is None
    assert len(autotune.candidate_errors) >= 1


def test_without_a_card_nothing_measures(monkeypatch):
    """The search measures on the card by default; without one the plan
    stays analytic (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setattr(autotune, "_device", None)
    fake = _fake_measurer({})
    monkeypatch.setattr(measure, "measure_plan", fake)
    with pytest.warns(UserWarning, match="none is available"):
        pl = ops.plan(ops.GemmSpec(tune=True), SHAPE)
    assert pl.source == "analytic" and fake.calls == []
    assert cache.tuning_cache_info().measurements == 0


# ---------------------------------------------------------------------------
# Winner selection through plan()
# ---------------------------------------------------------------------------

def test_measured_winner_selected_and_cached_exactly_once(monkeypatch):
    spec = ops.GemmSpec(tune=True)
    designs = api.solve_topk(spec, SHAPE, k=autotune.DEFAULT_K)
    assert len(designs) >= 2
    target = designs[-1].tile               # the analytically worst wins
    fake = _fake_measurer({(target.bm, target.bk, target.bn,
                            target.strategy): 1e-3})
    monkeypatch.setattr(measure, "measure_plan", fake)
    pl = ops.plan(spec, SHAPE)
    assert pl.source == "tuned" and pl.tile == target
    assert pl.tuned.from_cache is False
    assert pl.tuned.k_searched == len(designs)
    assert pl.tuned.t_measured_us == pytest.approx(1e3)
    assert pl.tuned.analytic_tile.startswith(designs[0].tile.strategy)
    assert len(fake.calls) == len(designs)
    assert set(fake.devices) == {torch.device("cpu")}
    info = cache.tuning_cache_info()
    assert info.entries == 1 and info.measurements == 1
    (ent,) = cache.tuning_cache().entries().values()
    assert ent["mode"] == "cpu" and len(ent["samples"]) == len(designs)
    assert [s["rank"] for s in ent["samples"]] == list(range(len(designs)))
    ops.plan(spec, SHAPE)                   # plan-cache hit, no search
    assert len(fake.calls) == len(designs)


@pytest.mark.parametrize("k", [2, 8])
def test_search_sweeps_k_candidates(monkeypatch, k):
    fake = _fake_measurer({})
    monkeypatch.setattr(measure, "measure_plan", fake)
    autotune.enable(k=k, device="cpu")
    pl = ops.plan(ops.GemmSpec(), (300, 512, 1024))
    want = len(api.solve_topk(ops.GemmSpec(), (300, 512, 1024), k))
    assert len(fake.calls) == want and pl.tuned.k_searched == want


def test_second_process_reuses_winner_with_zero_measurements(monkeypatch):
    spec = ops.GemmSpec(tune=True)
    designs = api.solve_topk(spec, SHAPE, k=autotune.DEFAULT_K)
    target = designs[-1].tile
    fake = _fake_measurer({(target.bm, target.bk, target.bn,
                            target.strategy): 1e-3})
    monkeypatch.setattr(measure, "measure_plan", fake)
    first = ops.plan(spec, SHAPE)
    assert cache.tuning_cache_info().measurements == 1
    cache.tuning_cache_reset()
    api.plan_cache_clear()
    monkeypatch.setattr(measure, "measure_plan",
                        _fake_measurer({}, explode=True))
    second = ops.plan(spec, SHAPE)
    assert second.tile == first.tile and second.source == "tuned"
    assert second.tuned.from_cache is True
    info = cache.tuning_cache_info()
    assert info.hits == 1 and info.measurements == 0


def test_a_card_winner_never_serves_the_cpu(monkeypatch):
    """A winner keyed under a card's mode is a miss for a CPU search."""
    c = cache.tuning_cache()
    c.put(cache.cache_key(ops.GemmSpec(), SHAPE, "cuda:NVIDIA H100"),
          {"tile": {"bm": 16, "bk": 128, "bn": 128, "strategy": "aie"}})
    fake = _fake_measurer({})
    monkeypatch.setattr(measure, "measure_plan", fake)
    pl = ops.plan(ops.GemmSpec(tune=True), SHAPE)
    assert fake.calls and pl.tuned.from_cache is False


def test_enablement_precedence_spec_module_env(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    assert not autotune.is_enabled(None)
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert autotune.is_enabled(None)
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert not autotune.is_enabled(None)
    monkeypatch.setenv("REPRO_AUTOTUNE", "6")
    assert autotune.is_enabled(None) and autotune.search_k() == 6
    autotune.disable()                      # module switch beats env
    assert not autotune.is_enabled(None)
    autotune.enable(k=3)
    assert autotune.is_enabled(None) and autotune.search_k() == 3
    assert autotune.measure_device() == torch.device("cuda")
    autotune.enable(k=3, device="cpu")
    assert autotune.measure_device() == torch.device("cpu")
    assert autotune.is_enabled(False) is False   # spec beats everything
    autotune.disable()
    assert autotune.is_enabled(True) is True
    assert autotune.DEFAULT_K == 4


def test_precedence_decides_what_plan_does(monkeypatch):
    fake = _fake_measurer({})
    monkeypatch.setattr(measure, "measure_plan", fake)
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert ops.plan(ops.GemmSpec(tune=False), SHAPE).source == "analytic"
    assert ops.plan(ops.GemmSpec(), SHAPE).source == "tuned"
    api.plan_cache_clear()
    monkeypatch.setattr(autotune, "_enabled", False)
    assert ops.plan(ops.GemmSpec(), SHAPE).source == "analytic"
    assert ops.plan(ops.GemmSpec(tune=True), (8, 128, 128)).source == \
        "tuned"


def test_backward_pass_never_tunes(monkeypatch):
    fake = _fake_measurer({})
    monkeypatch.setattr(measure, "measure_plan", fake)
    a = torch.ones((16, 128), requires_grad=True)
    b = torch.ones((128, 128), requires_grad=True)
    autotune.enable(k=2, device="cpu")
    ops.gemm(a, b).sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
    # only the forward spec searched; _plain's dA / dB pin tune=False
    assert cache.tuning_cache_info().measurements == 1
    backward = [p for p in api.plans() if p.spec.tune is False]
    assert backward and all(p.source == "analytic" for p in backward)


def test_flop_budget_skips_search(monkeypatch):
    fake = _fake_measurer({})
    monkeypatch.setattr(measure, "measure_plan", fake)
    autotune.enable(k=2, device="cpu")
    big = ops.plan(ops.GemmSpec(), (4096, 4096, 4096))   # 137 GFLOP
    assert big.source == "analytic" and big.tuned is None
    assert fake.calls == []
    assert cache.tuning_cache_info().measurements == 0


@pytest.mark.parametrize("shapes", [(64, 128, 256, 8), (3, 128, 256, 4, 32)])
def test_grouped_specs_stay_analytic(monkeypatch, shapes):
    fake = _fake_measurer({})
    monkeypatch.setattr(measure, "measure_plan", fake)
    autotune.enable(k=4, device="cpu")
    pl = ops.plan(ops.GemmSpec(grouped=True, tune=True), shapes)
    assert pl.source == "analytic" and fake.calls == []


def test_real_search_on_the_cpu_keeps_outputs():
    """No fake: the CPU's plain versions are measured, a tuned plan runs
    and gives the analytic plan's numbers (a tile changes no bit of a
    plain version's f32 product here: both sum k in one order)."""
    autotune.enable(k=3, device="cpu")
    g = torch.Generator().manual_seed(0)
    a = torch.randn((8, 256), generator=g)
    b = torch.randn((256, 320), generator=g)
    tuned = ops.gemm(a, b)
    pl = api.plans()[0]
    assert pl.source == "tuned" and pl.tuned.k_searched >= 1
    autotune.disable()
    api.plan_cache_clear()
    assert torch.allclose(ops.gemm(a, b), tuned, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# explain()'s source line
# ---------------------------------------------------------------------------

def test_explain_says_how_the_tile_was_chosen(monkeypatch):
    spec = ops.GemmSpec(tune=True)
    designs = api.solve_topk(spec, SHAPE, k=autotune.DEFAULT_K)
    target = designs[-1].tile
    monkeypatch.setattr(measure, "measure_plan", _fake_measurer(
        {(target.bm, target.bk, target.bn, target.strategy): 1e-3}))
    untuned = ops.plan(ops.GemmSpec(), SHAPE).explain()
    assert "  source   : analytic" in untuned
    text = ops.plan(spec, SHAPE).explain()
    assert f"source   : tuned (measured top-{len(designs)})" in text
    assert "1000.0 us measured vs" in text
    first = designs[0].tile
    assert (f"analytic first choice {first.strategy} {first.bm}x"
            f"{first.bk}x{first.bn} measured 2000.0 us") in text
    cache.tuning_cache_reset()
    api.plan_cache_clear()
    again = ops.plan(spec, SHAPE).explain()
    assert "source   : tuned (cache)" in again


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _synthetic_entries(t0, bw, fl, n=8, mode="cpu", seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n):
        by = float(rng.integers(1, 64) * 2**20)
        fp = float(rng.integers(1, 64) * 1e9)
        t = t0 + by / bw + fp / fl
        samples.append({"t_us": t * (1 + noise * rng.standard_normal())
                        * 1e6, "hbm_bytes": by, "flops": fp})
    return {f"k{seed}": {"mode": mode, "samples": samples}}


def _assert_fits_equal(mine, ref):
    assert sorted(mine) == sorted(ref)
    for mode in ref:
        a, b = mine[mode].as_dict(), ref[mode].as_dict()
        assert set(a) == set(b)
        for key, want in b.items():
            got = a[key]
            if isinstance(want, float) and isinstance(got, float):
                assert got == pytest.approx(want, rel=1e-9, abs=1e-12), key
            else:
                assert got == want, key


CASES = {
    "exact": _synthetic_entries(5e-4, 40e9, 2e12),
    "noisy": _synthetic_entries(2e-5, 3e12, 7e14, n=20, noise=0.05),
    "two modes": {**_synthetic_entries(1e-5, 3e12, 9e14, mode="cuda:x"),
                  **_synthetic_entries(5e-4, 40e9, 2e12, seed=1)},
    "too few": _synthetic_entries(1e-4, 1e10, 1e12, n=2),
    "empty": {},
    "no samples": {"k": {"mode": "cpu"}},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_equals_the_reference(case):
    entries = CASES[case]
    _assert_fits_equal(calibrate.fit(entries), jcalibrate.fit(entries))
    assert calibrate.render(calibrate.fit(entries)) == \
        jcalibrate.render(jcalibrate.fit(entries))


@pytest.mark.parametrize("seed", range(4))
def test_fit_drops_non_identifiable_terms_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(10):
        by = float(rng.integers(1, 64) * 2**20)
        fp = float(rng.integers(1, 64) * 1e6)
        t = 1e-3 + by / 10e9 - fp / 1e12 * (seed + 1)
        samples.append({"t_us": t * 1e6, "hbm_bytes": by, "flops": fp})
    entries = {"k": {"mode": "cpu", "samples": samples}}
    mine = calibrate.fit(entries)
    _assert_fits_equal(mine, jcalibrate.fit(entries))
    assert mine["cpu"].peak_flops is None and "flops" in mine["cpu"].note


def test_fit_recovers_exact_constants():
    c = calibrate.fit(CASES["exact"])["cpu"]
    assert c.t0_us == pytest.approx(500.0, rel=1e-3)
    assert c.hbm_bw == pytest.approx(40e9, rel=1e-3)
    assert c.peak_flops == pytest.approx(2e12, rel=1e-3)
    assert "eff BW 40.00 GB/s" in calibrate.render({"cpu": c})


def test_apply_changes_the_model_and_clear_restores():
    before = ops.plan(ops.GemmSpec(), SHAPE).traffic.t_model
    applied = calibrate.apply(
        calibrate.fit(_synthetic_entries(t0=0.0, bw=1e9, fl=1e9)))
    assert applied is not None and applied.mode == "cpu"
    assert bandwidth.get_calibration() is not None
    after = ops.plan(ops.GemmSpec(), SHAPE).traffic.t_model
    assert after > before * 10
    calibrate.clear()
    assert bandwidth.get_calibration() is None
    restored = ops.plan(ops.GemmSpec(), SHAPE).traffic.t_model
    assert restored == pytest.approx(before)


def test_apply_without_a_fit_for_the_mode_is_none():
    assert calibrate.apply(calibrate.fit(
        _synthetic_entries(1e-5, 1e12, 1e14, mode="cuda:x"))) is None
    assert bandwidth.get_calibration() is None


def _spec_entries(spec, rate, t0, bw, n, seed):
    """Entries of one spec whose samples run at ``rate`` op/s."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n):
        by = float(rng.integers(1, 64) * 2**20)
        fp = float(rng.integers(1, 64) * 1e9)
        samples.append({"t_us": (t0 + by / bw + fp / rate) * 1e6,
                        "hbm_bytes": by, "flops": fp})
    return {f"{spec}|{seed}": {"mode": "cuda:x", "spec": spec,
                               "samples": samples}}


@pytest.mark.parametrize("other", ["float32xfloat32->float32",
                                   "float32xfloat32:bias",
                                   "int8xint8{q}->bfloat16"])
def test_fit_reads_other_types_as_bf16_equivalent_flops(other):
    """Samples of an f32 or W8A8 spec, running at the sheet's rate for
    their type, leave the fitted bf16 rate where bf16 samples alone put
    it: their flops are scaled to bf16 ones before the fit."""
    h = HOPPER_H100
    bf16_rate = 400e12
    rate = bf16_rate * (h.peak_int8_ops if other.startswith("int8")
                        else h.peak_f32_flops) / h.peak_bf16_flops
    bf16 = _spec_entries("bfloat16xbfloat16", bf16_rate, 5e-6, 2e12, 8, 0)
    mixed = {**bf16, **_spec_entries(other, rate, 5e-6, 2e12, 8, 1)}
    alone = calibrate.fit(bf16)["cuda:x"]
    both = calibrate.fit(mixed)["cuda:x"]
    assert alone.peak_flops == pytest.approx(bf16_rate, rel=1e-6)
    assert both.peak_flops == pytest.approx(bf16_rate, rel=1e-6)
    assert both.hbm_bw == pytest.approx(2e12, rel=1e-6)
    assert both.n_samples == 16 and both.r2 == pytest.approx(1.0)
    # the recorded samples are left as they were
    assert mixed[f"{other}|1"]["samples"][0]["flops"] % 1e9 == 0


@pytest.mark.parametrize("key, factor", [
    ("bfloat16xbfloat16", 1.0),
    ("bfloat16xint8{q}:bias", 1.0),             # W8A16: the bf16 rate
    ("float32xfloat32->float32", 989 / 67),
    ("bfloat16xfloat32", 989 / 67),
    ("int8xint8{q}->int8!tb", 989 / 1979),
    (None, 1.0), ("", 1.0), ("garbage", 1.0)])
def test_bf16_flops_factor(key, factor):
    assert calibrate.bf16_flops_factor(key) == pytest.approx(factor)


def test_apply_prices_int8_at_the_sheets_ratio():
    fits = calibrate.fit(_synthetic_entries(t0=0.0, bw=1e12, fl=4e14))
    calibrate.apply(fits, "cpu")
    try:
        cal = bandwidth.get_calibration()
        assert cal.peak_bf16_flops == pytest.approx(4e14, rel=1e-6)
        assert cal.peak_int8_ops == pytest.approx(
            4e14 * HOPPER_H100.peak_int8_ops / HOPPER_H100.peak_bf16_flops,
            rel=1e-6)
    finally:
        calibrate.clear()


@pytest.mark.parametrize("bf16_rate", [100e12, 989e12, 5e12])
def test_f32_keeps_the_sheets_ratio_under_a_calibration(bf16_rate):
    """An f32 GEMM is priced at the fitted bf16 rate times the sheet's
    f32/bf16 ratio (67/989 on HOPPER_H100), not at the bf16 rate."""
    bandwidth.set_calibration(bandwidth.Calibration(
        hbm_bw=2e12, peak_bf16_flops=bf16_rate, peak_int8_ops=bf16_rate))
    try:
        f32, bw = bandwidth.effective_rates(HOPPER_H100, False, True)
        bf16, _ = bandwidth.effective_rates(HOPPER_H100, False, False)
        int8, _ = bandwidth.effective_rates(HOPPER_H100, True)
        assert bw == 2e12 and bf16 == bf16_rate and int8 == bf16_rate
        assert f32 == pytest.approx(
            bf16_rate * HOPPER_H100.peak_f32_flops
            / HOPPER_H100.peak_bf16_flops)
        assert f32 < bf16 / 10
        spec = ops.GemmSpec(a_dtype="float32", b_dtype="float32")
        pl = ops.plan(spec, (4096, 4096, 128))
        assert pl.traffic.t_compute == pytest.approx(pl.flops / f32)
    finally:
        bandwidth.clear_calibration()
        api.plan_cache_clear()
    assert bandwidth.effective_rates(HOPPER_H100, False, True)[0] == \
        HOPPER_H100.peak_f32_flops
