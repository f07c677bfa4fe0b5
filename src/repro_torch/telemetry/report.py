"""Model-against-measured reporting (port of
``repro/telemetry/report.py``): join every planned GEMM's modeled cost
(device-memory bytes, roofline time) with a measured standalone
execution.

For each :class:`~repro_torch.kernels.api.GemmPlan` in the plan cache
(populated by serving a trace, a training step, or explicit ``plan()``
calls), it synthesizes operands matching the spec on the measurement
device, executes the plan through the public ``execute`` path, and
reports per spec + shape:

* the *modeled* side — device-memory bytes, flops, roofline time and
  whether the model calls it compute- or memory-bound;
* the *measured* side — **median** wall clock over ``iters`` samples,
  each between two device synchronizations, after ``warmup`` calls,
  with MAD outlier rejection, plus the surviving ``spread``
  ((max-min)/median) — the shared :mod:`repro_torch.tune.measure`
  harness the autotuner uses;
* ``achieved`` — modeled time / measured time, the fraction of the
  roofline the execution reached.

Honesty note: ``t_model`` is the ``HOPPER_H100`` roofline (3.35 TB/s,
989 TFLOP/s bf16, 67 f32).  On the card (``mode`` ``cuda:<name>``) a
measured sample also holds the host's launch cost, so a small GEMM's
``achieved`` is bounded by its launch time, not by the kernel.  On the
CPU (``mode`` ``cpu``) the plain versions run, and ``achieved`` only
compares plans on one host; it says nothing about the card.  Each row
records its mode.

Plans whose padded flops exceed ``max_flops`` are not silently dropped:
they appear as rows with ``note='skipped (flops budget)'`` and no
measured time.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch import telemetry
from repro_torch.tune import measure as _measure
from repro_torch.tune.cache import device_mode
from repro_torch.tune.measure import (  # noqa: F401  (re-exports)
    DEFAULT_MAX_FLOPS,
    Measurement,
    synthesize_operands,
)


def measure_plan(pl, *, iters: int = _measure.DEFAULT_ITERS,
                 warmup: int = _measure.DEFAULT_WARMUP,
                 rng: Optional[np.random.Generator] = None, device=None
                 ) -> Measurement:
    """Measure one plan with the shared :mod:`repro_torch.tune.measure`
    harness (warm-up, ``iters`` samples between device syncs, MAD
    outlier rejection) on ``device`` (default: the card).  Returns the
    full :class:`Measurement`; use ``.median_s`` for the headline
    number."""
    return _measure.measure_plan(pl, iters=iters, warmup=warmup, rng=rng,
                                 device=device)


def model_vs_measured(plans: Optional[Sequence] = None, *,
                      max_flops: float = DEFAULT_MAX_FLOPS,
                      iters: int = _measure.DEFAULT_ITERS,
                      warmup: int = _measure.DEFAULT_WARMUP,
                      seed: int = 0, device=None) -> List[dict]:
    """One row per plan: the modeled bytes/time next to the measured
    median wall clock and its spread, on ``device`` (default: the card).
    ``plans`` defaults to every plan resolved so far (the plan cache in
    insertion order)."""
    from repro_torch import resolve_device
    from repro_torch.kernels import api
    if plans is None:
        plans = api.plans()
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    mode = device_mode(device)
    rows: List[dict] = []
    for pl in plans:
        t = pl.tile
        row = {
            "spec": pl.spec.key,
            "m": pl.m, "k": pl.k, "n": pl.n,
            "strategy": t.strategy,
            "tile": f"{t.bm}x{t.bk}x{t.bn}",
            "source": pl.source,
            "hbm_mib": round(pl.hbm_bytes / 2**20, 3),
            "flops": pl.flops,
            "bound": pl.traffic.bound,
            "t_model_us": round(pl.traffic.t_model * 1e6, 2),
            "mode": mode,
            "iters": iters,
            "warmup": warmup,
            "t_measured_us": None,
            "spread": None,
            "achieved": None,
            "note": "",
        }
        if pl.flops > max_flops:
            row["note"] = "skipped (flops budget)"
        else:
            meas = measure_plan(pl, iters=iters, warmup=warmup, rng=rng,
                                device=device)
            dt = meas.median_s
            row["t_measured_us"] = round(dt * 1e6, 2)
            row["spread"] = round(meas.spread, 4)
            row["achieved"] = round(pl.traffic.t_model / dt, 5)
            if meas.rejected:
                row["note"] = f"{meas.rejected} outlier(s) rejected"
            telemetry.event("gemm.measured", **{
                k: row[k] for k in ("spec", "m", "k", "n", "strategy",
                                    "tile", "source", "hbm_mib",
                                    "t_model_us", "t_measured_us",
                                    "spread", "achieved", "mode")})
        rows.append(row)
    return rows


def summarize(rows: Sequence[dict]) -> dict:
    measured = [r for r in rows if r["t_measured_us"] is not None]
    skipped = len(rows) - len(measured)
    return {
        "n_plans": len(rows),
        "n_measured": len(measured),
        "n_skipped": skipped,
        "mean_achieved": (round(float(np.mean(
            [r["achieved"] for r in measured])), 5) if measured else None),
    }


def render(rows: Sequence[dict]) -> str:
    """Aligned text table of a model-vs-measured report."""
    cols = ("spec", "shape", "tile", "src", "hbm_mib", "t_model_us",
            "t_measured_us", "spread", "achieved", "note")
    table = [cols]
    for r in rows:
        table.append((
            r["spec"], f"{r['m']}x{r['k']}x{r['n']}",
            f"{r['strategy']} {r['tile']}",
            r.get("source", "analytic"), f"{r['hbm_mib']:.2f}",
            f"{r['t_model_us']:.1f}",
            "-" if r["t_measured_us"] is None
            else f"{r['t_measured_us']:.1f}",
            "-" if r.get("spread") is None else f"{r['spread'] * 100:.0f}%",
            "-" if r["achieved"] is None else f"{r['achieved']:.3f}",
            r["note"]))
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
             for row in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    s = summarize(rows)
    lines.append(f"[{s['n_measured']}/{s['n_plans']} plans measured, "
                 f"{s['n_skipped']} skipped; mode sees a "
                 f"{rows[0]['mode'] if rows else '?'} device — t_model is "
                 "the HOPPER_H100 roofline]")
    return "\n".join(lines)
