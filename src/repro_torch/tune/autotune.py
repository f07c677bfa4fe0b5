"""Measured top-K tile search (port of the GEMM half of
``repro/tune/autotune.py``): close the analytic search's
model-against-reality loop by timing its best candidates on the device
that will run them.

``lookup_or_search`` is the single entry point ``plan()`` consults when
autotuning is enabled (``GemmSpec(tune=True)``, :func:`enable` or
``REPRO_AUTOTUNE=1``):

1. the persistent :mod:`repro_torch.tune.cache` is checked first — a
   winner measured by any earlier process on the same device mode is
   reused with **zero** re-measurement;
2. on a miss, the top-K candidates of the search on ``HOPPER_H100``
   (ranked by modeled roofline time) are each resolved to a real plan and
   timed with the :mod:`repro_torch.tune.measure` harness (median-of-N,
   outlier-rejected) on the measurement device;
3. the measured winner is persisted — tile, median, spread, the analytic
   rank-0 time it displaced, and every per-candidate sample so
   :mod:`repro_torch.tune.calibrate` can fit cost-model constants later.

The measurement device is the card unless :func:`enable` names another
(the CPU tests pass ``device="cpu"``); without a card the search does not
fall back to the CPU: the plan stays analytic.  The search *never*
raises into ``plan()``: problems over the flop budget, candidates that
fail post-clamp feasibility, and measurement errors all degrade to the
analytic answer (``None``).  The attention half of the reference's
search waits for the attention planner (ROADMAP queue A6).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.tiling import TileConfig
from repro_torch.tune import measure
from repro_torch.tune.cache import cache_key, device_mode, tuning_cache

#: candidates swept per search when nothing narrower is configured
DEFAULT_K = 4

_enabled: Optional[bool] = None     # module switch; None -> env
_k: Optional[int] = None
_device: Optional[torch.device] = None

#: every failed candidate of this process, (stage, spec key, (m, k, n),
#: tile, error) with stage "resolve" (the tile does not fit after
#: clamping) or "measure" (the execution raised) — kept whether or not
#: telemetry is on, so a caller can count failures instead of letting
#: the analytic fallback hide them
candidate_errors: list = []


def enable(k: Optional[int] = None, device=None) -> None:
    """Turn autotuning on for this process (what ``--autotune`` does);
    ``k`` narrows or widens the per-shape candidate sweep, ``device``
    fixes the device the search measures on (default: the card)."""
    global _enabled, _k, _device
    _enabled = True
    if k is not None:
        _k = int(k)
    _device = torch.device(device) if device is not None else None


def disable() -> None:
    global _enabled, _k, _device
    _enabled = False
    _k = None
    _device = None


def is_enabled(spec_tune: Optional[bool] = None) -> bool:
    """The three-level switch: the spec's own ``tune`` field wins, then
    the process switch (:func:`enable` / :func:`disable`), then the
    ``REPRO_AUTOTUNE`` env var ('0'/'false'/'' = off, anything else on;
    an integer > 1 doubles as the search K)."""
    if spec_tune is not None:
        return bool(spec_tune)
    if _enabled is not None:
        return _enabled
    return os.environ.get("REPRO_AUTOTUNE", "").lower() \
        not in ("", "0", "false")


def search_k() -> int:
    if _k is not None:
        return _k
    env = os.environ.get("REPRO_AUTOTUNE", "")
    try:
        if int(env) > 1:
            return int(env)
    except ValueError:
        pass
    return DEFAULT_K


def measure_device() -> torch.device:
    """The device searches measure on: the one :func:`enable` named,
    else the first CUDA card."""
    return _device if _device is not None else torch.device("cuda")


def _tile_from(d: dict) -> TileConfig:
    return TileConfig(int(d["bm"]), int(d["bk"]), int(d["bn"]),
                      str(d["strategy"]))


def _tile_dict(t: TileConfig) -> dict:
    return {"bm": t.bm, "bk": t.bk, "bn": t.bn, "strategy": t.strategy}


def _tile_str(t: TileConfig) -> str:
    return f"{t.strategy} {t.bm}x{t.bk}x{t.bn}"


def lookup_or_search(spec, shapes: Tuple[int, int, int], problem, *,
                     k: Optional[int] = None,
                     iters: int = measure.DEFAULT_ITERS,
                     warmup: int = measure.DEFAULT_WARMUP,
                     max_flops: float = measure.DEFAULT_MAX_FLOPS,
                     seed: int = 0, device=None):
    """Measured winner for (spec, shapes) — ``(TileConfig, TunedInfo)``
    from the persistent cache or a fresh top-K sweep, or ``None`` when
    the analytic path should decide (no measurement device, over-budget
    problem, nothing measurable, a malformed cache entry)."""
    from repro_torch.kernels import api
    device = torch.device(device) if device is not None \
        else measure_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        warnings.warn("autotuning measures on the CUDA card and none is "
                      "available; plans stay analytic (tune.enable("
                      "device='cpu') measures the plain versions)",
                      stacklevel=3)
        return None
    mode = device_mode(device)
    cache = tuning_cache()
    key = cache_key(spec, shapes, mode)
    ent = cache.get(key)
    if ent is not None:
        try:
            tile = _tile_from(ent["tile"])
        except (KeyError, TypeError, ValueError):
            tile = None             # malformed entry -> analytic
        if tile is not None:
            analytic = ent.get("analytic") or {}
            telemetry.counter("gemm.autotune.cache_hits").add(1)
            return tile, api.TunedInfo(
                t_measured_us=float(ent.get("t_us", 0.0)),
                spread=float(ent.get("spread", 0.0)),
                t_analytic_us=analytic.get("t_us"),
                analytic_tile=str(analytic.get("tile", "")),
                k_searched=int(ent.get("k_searched", 0)),
                from_cache=True)
    if problem.flops > max_flops:
        telemetry.counter("gemm.autotune.flops_skips").add(1)
        return None                 # too big to sweep

    k = k or search_k()
    designs = api.solve_topk(spec, shapes, k)
    rng = np.random.default_rng(seed)
    candidates = []                 # (median_s, rank, plan, Measurement)
    for rank, d in enumerate(designs):
        stage = "resolve"
        try:
            cand = dataclasses.replace(spec, tile=d.tile, tune=False)
            pl = api._resolve(cand, *shapes)    # no plan-cache pollution
            stage = "measure"
            meas = measure.measure_plan(pl, iters=iters, warmup=warmup,
                                        rng=rng, device=device)
        except Exception as e:      # infeasible post-clamp / exec error
            candidate_errors.append((stage, spec.key, tuple(shapes),
                                     _tile_str(d.tile), repr(e)))
            telemetry.counter("gemm.autotune.candidate_errors").add(1)
            telemetry.event("gemm.autotune.candidate_error",
                            spec=spec.key, tile=_tile_str(d.tile),
                            m=shapes[0], k=shapes[1], n=shapes[2],
                            stage=stage, error=repr(e))
            continue
        candidates.append((meas.median_s, rank, pl, meas))
    if not candidates:
        return None
    candidates.sort(key=lambda c: (c[0], c[1]))     # ties: analytic rank
    _, win_rank, win_pl, win_meas = candidates[0]
    analytic_first = next((c for c in candidates if c[1] == 0), None)
    entry = {
        "tile": _tile_dict(win_pl.tile),
        "t_us": win_meas.median_s * 1e6,
        "spread": win_meas.spread,
        "t_model_us": win_pl.traffic.t_model * 1e6,
        "hbm_bytes": win_pl.hbm_bytes,
        "flops": win_pl.flops,
        "analytic": {
            "tile": _tile_str(analytic_first[2].tile),
            "t_us": analytic_first[0] * 1e6,
        } if analytic_first is not None else None,
        "k_searched": len(candidates),
        "iters": iters, "warmup": warmup,
        "mode": mode, "spec": spec.key,
        "shape": f"{shapes[0]}x{shapes[1]}x{shapes[2]}",
        "samples": [
            {"tile": _tile_dict(pl.tile), "rank": rank,
             "t_us": med * 1e6, "spread": meas.spread,
             "t_model_us": pl.traffic.t_model * 1e6,
             "hbm_bytes": pl.hbm_bytes, "flops": pl.flops}
            for med, rank, pl, meas in sorted(candidates,
                                              key=lambda c: c[1])
        ],
    }
    cache.put(key, entry)
    telemetry.counter("gemm.autotune.searches").add(1)
    telemetry.event(
        "gemm.autotune", spec=spec.key, m=shapes[0], k=shapes[1],
        n=shapes[2], mode=mode, k_searched=len(candidates),
        winner=_tile_str(win_pl.tile), winner_rank=win_rank,
        t_us=entry["t_us"], spread=entry["spread"],
        analytic=entry["analytic"])
    analytic = entry["analytic"] or {}
    return win_pl.tile, api.TunedInfo(
        t_measured_us=entry["t_us"], spread=entry["spread"],
        t_analytic_us=analytic.get("t_us"),
        analytic_tile=str(analytic.get("tile", "")),
        k_searched=len(candidates), from_cache=False)
