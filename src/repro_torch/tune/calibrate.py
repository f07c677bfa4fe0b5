"""Cost-model calibration (port of ``repro/tune/calibrate.py``): fit
effective hardware constants from the tuning cache's measured samples.

The analytic search prices every tile with two constants — peak flop/s
and device-memory bytes/s (:mod:`repro_torch.core.bandwidth`), the
``HOPPER_H100`` datasheet numbers.  The device measured achieves some
effective fraction of each.  This module regresses, per device mode,
every sample the tuner recorded:

    t_measured  ≈  t0  +  modeled_hbm_bytes / BW_eff  +  flops / F_eff

by ordinary least squares over ``[1, bytes, flops]``, reporting R² and
the per-call overhead ``t0`` (host dispatch and launch).  A term whose
fitted coefficient is non-positive is dropped and refit — on a small
sweep the flops term is often not identifiable, and reporting a
negative "effective bandwidth" would be worse than saying so.

``flops`` are bf16-equivalent: an entry whose spec the model prices at
another rate (f32 off the tensor cores, W8A8 int8) has its samples'
flops scaled by the sheet's bf16 rate over that rate, so the one compute
term is a bf16 rate whatever mix of types the tuner measured (on
Hopper an f32 flop costs ~15 bf16 ones).  Entries without a spec, and
bf16 ones, go in as recorded, as in the JAX package, whose TPU sheet
has one rate.

``apply()`` feeds the fitted constants back into the analytic model
(:func:`repro_torch.core.bandwidth.set_calibration`), so the search
re-ranks designs with measured rather than datasheet rates; f32 and
int8 GEMMs keep the sheet's ratio to the fitted bf16 rate (the JAX
package sets int8 to the fitted rate itself).  This is
explicit and reversible (:func:`clear`) — never switched on implicitly,
because CPU-measured constants applied to the card's model would be
nonsense.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import bandwidth
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.core.tiling import dtype_bytes
from repro_torch.tune.cache import tuning_cache


@dataclasses.dataclass(frozen=True)
class CalibrationFit:
    """Fitted effective constants for one device mode."""

    mode: str
    n_samples: int
    t0_us: float                    # fixed per-call overhead
    hbm_bw: Optional[float]         # effective bytes/s (None: unidentifiable)
    peak_flops: Optional[float]     # effective flop/s  (None: unidentifiable)
    r2: float
    note: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def bf16_flops_factor(spec_key: Optional[str], chip=HOPPER_H100) -> float:
    """bf16 flops per flop of a GEMM of spec ``spec_key`` (a
    ``GemmSpec.key``) on ``chip``'s sheet: the sheet's bf16 rate over the
    rate :func:`repro_torch.core.bandwidth.estimate` prices it at (both
    operands int8: the int8 rate; an f32 operand: the f32 rate).  1.0
    for bf16 and for a missing or unreadable key."""
    if not spec_key:
        return 1.0
    head = spec_key.split(":")[0].split("->")[0].split("!")[0]
    dtypes = head.replace("{q}", "").split("x")
    if len(dtypes) != 2:
        return 1.0
    try:
        if all(dtype_bytes(d) == 1 for d in dtypes):
            return chip.peak_bf16_flops / chip.peak_int8_ops
    except (KeyError, TypeError, ValueError):
        return 1.0
    if "float32" in dtypes:
        return chip.peak_bf16_flops / chip.peak_f32_flops
    return 1.0


def _samples_by_mode(entries: Dict[str, dict]
                     ) -> Dict[str, List[dict]]:
    by_mode: Dict[str, List[dict]] = {}
    for ent in entries.values():
        mode = str(ent.get("mode", "?"))
        scale = bf16_flops_factor(ent.get("spec"))
        for s in ent.get("samples") or []:
            if {"t_us", "hbm_bytes", "flops"} <= set(s):
                if scale != 1.0:
                    s = {**s, "flops": s["flops"] * scale}
                by_mode.setdefault(mode, []).append(s)
    return by_mode


def _fit_mode(mode: str, samples: Sequence[dict]) -> CalibrationFit:
    t = np.asarray([s["t_us"] * 1e-6 for s in samples], dtype=np.float64)
    b = np.asarray([s["hbm_bytes"] for s in samples], dtype=np.float64)
    f = np.asarray([s["flops"] for s in samples], dtype=np.float64)
    n = len(t)
    if n < 3:
        return CalibrationFit(mode, n, 0.0, None, None, 0.0,
                              note=f"insufficient samples ({n} < 3)")
    # least squares over [1, bytes, flops]; drop-and-refit any term whose
    # coefficient comes out non-positive (not identifiable on this host)
    use_b, use_f = True, True
    for _ in range(3):
        cols = [np.ones_like(t)]
        if use_b:
            cols.append(b)
        if use_f:
            cols.append(f)
        X = np.stack(cols, axis=1)
        coef, *_ = np.linalg.lstsq(X, t, rcond=None)
        i = 1
        cb = cf = None
        if use_b:
            cb = coef[i]
            i += 1
        if use_f:
            cf = coef[i]
        if use_b and cb is not None and cb <= 0:
            use_b = False
            continue
        if use_f and cf is not None and cf <= 0:
            use_f = False
            continue
        break
    pred = X @ coef
    ss_res = float(np.sum((t - pred) ** 2))
    ss_tot = float(np.sum((t - np.mean(t)) ** 2))
    r2 = 1.0 if ss_tot == 0.0 else 1.0 - ss_res / ss_tot
    t0 = float(coef[0])
    note = ""
    if not use_b or not use_f:
        dropped = [name for used, name in ((use_b, "bytes"),
                                           (use_f, "flops")) if not used]
        note = f"dropped non-identifiable term(s): {', '.join(dropped)}"
    return CalibrationFit(
        mode=mode, n_samples=n, t0_us=t0 * 1e6,
        hbm_bw=float(1.0 / cb) if use_b and cb else None,
        peak_flops=float(1.0 / cf) if use_f and cf else None,
        r2=round(r2, 5), note=note)


def fit(entries: Optional[Dict[str, dict]] = None
        ) -> Dict[str, CalibrationFit]:
    """One :class:`CalibrationFit` per device mode present in the
    tuning cache (or in explicitly passed ``entries``)."""
    if entries is None:
        entries = tuning_cache().entries()
    return {mode: _fit_mode(mode, samples)
            for mode, samples in sorted(_samples_by_mode(entries).items())}


def render(fits: Dict[str, CalibrationFit]) -> str:
    """Aligned text report of the fitted constants."""
    if not fits:
        return ("[calibrate] no measured samples in the tuning cache — "
                "run an --autotune pass first")
    lines = []
    for mode, c in fits.items():
        bw = f"{c.hbm_bw / 1e9:.2f} GB/s" if c.hbm_bw else "n/a"
        fl = f"{c.peak_flops / 1e9:.1f} GFLOP/s" if c.peak_flops else "n/a"
        lines.append(
            f"[calibrate] mode={mode}: eff BW {bw}, eff compute {fl}, "
            f"t0 {c.t0_us:.1f} us, R2 {c.r2:.4f} "
            f"({c.n_samples} samples{'; ' + c.note if c.note else ''})")
    return "\n".join(lines)


def apply(fits: Optional[Dict[str, CalibrationFit]] = None,
          mode: Optional[str] = None) -> Optional[CalibrationFit]:
    """Push one mode's fitted constants (default: the autotuner's
    measurement device's) into the analytic model
    (``bandwidth.set_calibration``), clearing the plan cache (and the
    one-shot plan map) so every later ``plan()`` re-ranks under measured
    rates.  Returns the fit applied, or ``None`` when nothing usable
    exists."""
    from repro_torch.kernels import api
    from repro_torch.tune import autotune
    from repro_torch.tune.cache import device_mode
    if fits is None:
        fits = fit()
    mode = mode or device_mode(autotune.measure_device())
    c = fits.get(mode)
    if c is None or (c.hbm_bw is None and c.peak_flops is None):
        return None
    chip = HOPPER_H100                  # the sheet the planner prices on
    bandwidth.set_calibration(bandwidth.Calibration(
        hbm_bw=c.hbm_bw, peak_bf16_flops=c.peak_flops,
        peak_int8_ops=(c.peak_flops * chip.peak_int8_ops
                       / chip.peak_bf16_flops if c.peak_flops else None),
        source=f"tune.calibrate[{mode}, n={c.n_samples}, r2={c.r2}]"))
    api.plan_cache_clear()
    return c


def clear() -> None:
    """Back to datasheet constants (and a fresh plan cache)."""
    from repro_torch.kernels import api
    bandwidth.clear_calibration()
    api.plan_cache_clear()
