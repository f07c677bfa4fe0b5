"""The shared measurement harness — the *measured* half of every
model-against-reality loop in the port (port of the GEMM half of
``repro/tune/measure.py``).

One plan, one number: synthesize operands matching the plan's spec
(quantized ``{q, scale}`` structs, the gated second B, bias / residual /
out-scale epilogue terms) from a numpy generator, drawn on an explicit
device,
run the plan through the public ``execute`` path under
``torch.inference_mode()`` (the direct dispatch serving uses, not the
autograd Function) ``warmup`` times, then time ``iters`` samples, each
the wall clock between two device synchronizations, so a ``tb`` plan's
per-chunk launches are counted as eager serving pays them.  The samples
are reduced **robustly**: outliers are rejected by median-absolute-
deviation before the median is taken, and the surviving spread is
reported so a noisy host is visible instead of folded into a mean.

A measurement is not an execution of the served step: the kernels'
launch counters are put back as they were found, so the serve paths'
launches-equal-executed-plans checks stay exact under tuning.  Nothing
measures while the current stream captures a CUDA graph.

Consumers: :mod:`repro_torch.telemetry.report` (the model-against-
measured table), :mod:`repro_torch.tune.autotune` (the top-K tile
search), and through the tuning cache :mod:`repro_torch.tune.calibrate`.

The ``timer`` parameter exists for determinism tests: a fake clock makes
the winner selection reproducible without a card.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, telemetry

#: per-GEMM flop budget for measured passes
DEFAULT_MAX_FLOPS = 5e10

#: default repeat / warm-up counts (median-of-5 after 2 warm-up calls)
DEFAULT_ITERS = 5
DEFAULT_WARMUP = 2

#: samples farther than this many (scaled) MADs from the median are
#: rejected before the median is taken — one GC pause or page-fault storm
#: must not decide a tile search
MAD_CUTOFF = 3.0

_active = 0         # measure_plan calls in progress


def measuring() -> bool:
    """True while :func:`measure_plan` runs: its executions are
    measurements, not executions of the served step (a caller that counts
    executed plans skips them)."""
    return _active > 0


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Robust wall-clock summary of repeated plan executions."""

    times_s: Tuple[float, ...]      # every post-warm-up sample
    kept_s: Tuple[float, ...]       # samples surviving outlier rejection
    warmup: int                     # warm-up calls excluded from times_s

    @property
    def iters(self) -> int:
        return len(self.times_s)

    @property
    def rejected(self) -> int:
        return len(self.times_s) - len(self.kept_s)

    @property
    def median_s(self) -> float:
        return statistics.median(self.kept_s)

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self.kept_s)

    @property
    def spread(self) -> float:
        """(max - min) / median over the kept samples — the noise-floor
        indicator reported next to every measured number."""
        med = self.median_s
        if not med:
            return 0.0
        return (max(self.kept_s) - min(self.kept_s)) / med


def reject_outliers(times: Tuple[float, ...],
                    cutoff: float = MAD_CUTOFF) -> Tuple[float, ...]:
    """Drop samples beyond ``cutoff`` scaled MADs from the median.  At
    least half the samples always survive (a bimodal run keeps its
    faster mode rather than rejecting everything)."""
    if len(times) <= 2:
        return tuple(times)
    med = statistics.median(times)
    mad = statistics.median(abs(t - med) for t in times)
    if mad == 0.0:
        return tuple(times)
    scaled = 1.4826 * mad           # MAD -> sigma under normality
    kept = tuple(t for t in times if abs(t - med) <= cutoff * scaled)
    if len(kept) < max(1, len(times) // 2):
        return tuple(times)
    return kept


def _rand(gen: torch.Generator, shape, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return torch.randint(-127, 128, shape, generator=gen,
                             device=gen.device, dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=getattr(torch, dtype))


def synthesize_operands(pl, rng: np.random.Generator, device="cuda"
                        ) -> dict:
    """``execute()`` operands matching the plan's spec, on ``device`` —
    quantized weight structs, the gated second B, and every epilogue
    term it declares (the reference's operands, in its order).  The
    numpy generator seeds a torch generator on the device, which draws
    them there: a host draw of qwen3-moe's 4096 x 151936 lm_head weight
    alone takes seconds."""
    spec, ep = pl.spec, pl.spec.epilogue
    m, k, n = pl.m, pl.k, pl.n
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**63 - 1)))

    def weight():
        if spec.b_quant:
            return {"q": _rand(gen, (k, n), "int8"),
                    "scale": _rand(gen, (1, n), "float32") * 0.01 + 0.02}
        return _rand(gen, (k, n), spec.b_dtype)

    return {
        "a": _rand(gen, (m, k), spec.a_dtype),
        "b": weight(),
        "b2": weight() if spec.gated else None,
        "bias": _rand(gen, (n,), spec.a_dtype) if ep.bias else None,
        "residual": (_rand(gen, (m, n), spec.a_dtype)
                     if ep.residual else None),
        "out_scale": 0.05 if ep.out_quant else None,
    }


def _launch_counters():
    """Every kernel wrapper's launch counter, as (function, attribute)."""
    from repro_torch.kernels.gemm_aie import gemm_aie, gemm_aie_plain
    from repro_torch.kernels.gemm_gated import gemm_gated, gemm_gated_plain
    from repro_torch.kernels.gemm_grouped import gemm_grouped, \
        gemm_grouped_plain
    from repro_torch.kernels.gemm_tb import gemm_tb, gemm_tb_plain
    fns = (gemm_aie, gemm_aie_plain, gemm_gated, gemm_gated_plain,
           gemm_tb, gemm_tb_plain, gemm_grouped, gemm_grouped_plain)
    return [(f, a) for f in fns for a in ("launches", "final_launches")
            if hasattr(f, a)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_plan(pl, *, iters: int = DEFAULT_ITERS,
                 warmup: int = DEFAULT_WARMUP,
                 rng: Optional[np.random.Generator] = None,
                 timer: Callable[[], float] = time.perf_counter,
                 device=None) -> Measurement:
    """Time one plan's forward execution on ``device`` (default: the
    card): ``warmup`` calls, then ``iters`` samples each taken between
    two device synchronizations, summarized robustly (median after MAD
    outlier rejection).  Raises inside a CUDA-graph capture."""
    from repro_torch.kernels import api
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("measure_plan inside a CUDA-graph capture: a "
                           "plan resolved during capture must not measure")
    rng = rng or np.random.default_rng(0)
    ops = synthesize_operands(pl, rng, device)
    kw = {k: ops[k] for k in ("b2", "bias", "residual", "out_scale")}
    global _active
    counters = [(f, a, getattr(f, a)) for f, a in _launch_counters()]
    times = []
    _active += 1
    try:
        with torch.inference_mode():
            for _ in range(max(1, warmup)):
                out = api.execute(pl, ops["a"], ops["b"], **kw)
            _sync(device)
            with telemetry.span("measure.gemm", spec=pl.spec.key,
                                m=pl.m, k=pl.k, n=pl.n, iters=iters,
                                warmup=warmup) as sp:
                for _ in range(max(1, iters)):
                    _sync(device)
                    t0 = timer()
                    out = api.execute(pl, ops["a"], ops["b"], **kw)
                    _sync(device)
                    times.append(timer() - t0)
                sp.sync(out)
    finally:
        _active -= 1
        for f, a, v in counters:
            setattr(f, a, v)
    return Measurement(times_s=tuple(times),
                       kept_s=reject_outliers(tuple(times)),
                       warmup=max(1, warmup))
