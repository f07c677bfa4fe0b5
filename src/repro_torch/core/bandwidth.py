"""Device-memory traffic model per tiling (port of
``repro/core/bandwidth.py``).

The roofline terms of a (tile, problem): the bytes the dataflow moves
between device memory and the chip, and the operations it executes,
each over the sheet's rate.  A measured :class:`Calibration` can
override the rates process-wide; ``calibration_version()`` changes with
every override, so the search's memo never serves stale rankings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.tiling import GemmProblem, TileConfig, dtype_bytes, \
    grouped_instances


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured effective rates overriding a sheet's datasheet constants
    (``None`` fields keep the sheet value)."""

    hbm_bw: Optional[float] = None           # bytes/s
    peak_bf16_flops: Optional[float] = None  # flop/s
    peak_int8_ops: Optional[float] = None    # op/s
    source: str = ""


_calibration: Optional[Calibration] = None
_cal_version: int = 0


def set_calibration(cal: Optional[Calibration]) -> None:
    """Install (or, with ``None``, drop) measured effective constants."""
    global _calibration, _cal_version
    _calibration = cal
    _cal_version += 1


def clear_calibration() -> None:
    set_calibration(None)


def get_calibration() -> Optional[Calibration]:
    return _calibration


def calibration_version() -> int:
    return _cal_version


def effective_rates(chip, int8: bool, f32: bool = False) -> tuple:
    """(peak op/s, device-memory bytes/s) after any installed
    calibration.  ``f32`` prices an f32 GEMM at the sheet's f32 rate
    (the TPU sheet's equals its bf16 rate, as in the JAX package); under
    a calibration it keeps the sheet's f32/bf16 ratio below the fitted
    bf16 rate (Hopper's f32 rate is 67 of 989 TFLOP/s: the fitted bf16
    rate alone would price an f32 GEMM some 15x too cheap)."""
    if int8:
        peak = chip.peak_int8_ops
    else:
        peak = chip.peak_f32_flops if f32 else chip.peak_bf16_flops
    bw = chip.hbm_bw
    cal = _calibration
    if cal is not None:
        if int8:
            peak = cal.peak_int8_ops or peak
        elif cal.peak_bf16_flops:
            peak = cal.peak_bf16_flops * (
                chip.peak_f32_flops / chip.peak_bf16_flops if f32 else 1.0)
        bw = cal.hbm_bw or bw
    return peak, bw


@dataclasses.dataclass(frozen=True)
class TrafficEstimate:
    """Modeled device-memory traffic and roofline terms for one
    (tile, problem)."""

    hbm_bytes: float          # total device-memory bytes moved
    flops: float              # padded (executed) flops
    t_compute: float          # s
    t_memory: float           # s
    arithmetic_intensity: float

    @property
    def t_model(self) -> float:
        """Roofline execution-time estimate (perfect overlap)."""
        return max(self.t_compute, self.t_memory)

    @property
    def bound(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"


def hbm_traffic_bytes(tile: TileConfig, p: GemmProblem) -> float:
    """Worst-case device-memory bytes for one GEMM under a tiling.

    * ``aie`` (output-stationary): every A panel is re-read once per
      n-block column, every B panel once per m-block row, C is written
      once.
    * ``tb`` (A-stationary): A is read once; B is re-read per m-block
      row; the f32 partial C is read and written once per k-chunk
      (``c_rmw * (2 * gk - 1)``).  On the card kernel B6 re-reads the A
      panel once per CTA that shares its m-block; after the first read
      those are L2 hits, and the model bills A once.

    Operands are billed at their own dtype widths; int8 operands move
    their f32 scale vectors; a fused bias (1, n) rides with every m-row
    of B panels and a residual (m, n) is read once.

    Grouped ragged GEMMs (``p.n_groups > 0``, output-stationary only):
    A is charged at the true routed rows ``p.m``, each of the worst-case
    ``gm + E - 1`` straddling tile instances re-reading its (bm, pk) A
    rows once per n-block column; B one (pk, pn) expert panel per
    instance (never the whole (E, k, n) bank); the per-expert (1, n)
    scale / bias vectors ride per instance; C is written once.
    """
    from repro_torch.kernels.epilogue import Epilogue
    ep = Epilogue.parse(p.epilogue)
    gm, gn, gk = tile.grid(p)
    pm_, pk, pn = tile.padded_dims(p)
    a_b = dtype_bytes(p.a_dtype)
    b_b = dtype_bytes(p.b_dtype)
    out_b = dtype_bytes(p.out_dtype)
    acc_b = dtype_bytes(p.acc_dtype)
    a_bytes = pm_ * pk * a_b
    b_bytes = pk * pn * b_b * p.n_b_operands
    c_bytes = pm_ * pn * out_b
    a_scale = pm_ * 4 if p.a_dtype == "int8" else 0
    b_scale = pn * 4 * p.n_b_operands if p.b_dtype == "int8" else 0
    bias_bytes = pn * 4 * gm if ep.bias else 0
    res_bytes = pm_ * pn * out_b if ep.residual else 0
    if p.n_groups:
        inst = grouped_instances(tile, p)
        a_inst = inst * tile.bm * pk * a_b
        a_s_inst = inst * tile.bm * 4 if p.a_dtype == "int8" else 0
        b_inst = inst * pk * pn * b_b
        b_s_inst = inst * pn * 4 if p.b_dtype == "int8" else 0
        bias_inst = inst * pn * 4 if ep.bias else 0
        return ((a_inst + a_s_inst) * gn + b_inst + b_s_inst
                + c_bytes + bias_inst)
    if tile.strategy == "aie":
        return ((a_bytes + a_scale) * gn + (b_bytes + b_scale) * gm
                + c_bytes + bias_bytes + res_bytes)
    c_rmw = pm_ * pn * acc_b
    return (a_bytes + a_scale) + (b_bytes + b_scale) * gm \
        + c_rmw * (2 * gk - 1) + c_bytes + bias_bytes + res_bytes


def estimate(tile: TileConfig, p: GemmProblem, chip=TPU_V5E
             ) -> TrafficEstimate:
    pm_, pk, pn = tile.padded_dims(p)
    flops = 2.0 * pm_ * pk * pn * p.n_b_operands
    if p.n_groups:
        # executed flops: every straddling instance computes its whole
        # (bm, pk, pn) block
        flops = 2.0 * grouped_instances(tile, p) * tile.bm * pk * pn
    # the int8 rate needs both operands at 8 bits
    int8 = dtype_bytes(p.a_dtype) == 1 and dtype_bytes(p.b_dtype) == 1
    f32 = "float32" in (p.a_dtype, p.b_dtype)
    peak, hbm_bw = effective_rates(chip, int8, f32)
    hbm = hbm_traffic_bytes(tile, p)
    return TrafficEstimate(
        hbm_bytes=hbm,
        flops=flops,
        t_compute=chip.compute_seconds(tile, p, flops, peak),
        t_memory=hbm / hbm_bw,
        arithmetic_intensity=flops / hbm,
    )


def decode_kv_bytes(positions, *, n_kv_heads: int, head_dim: int,
                    dtype="bfloat16", window: int = 0,
                    page_size: Optional[int] = None) -> int:
    """Modeled device-memory bytes ONE attention layer streams from its
    KV cache for one decode step, billed at *true per-row positions* —
    not the dense ``max_len`` rows the cache allocates.

    A row at position ``p`` reads its ``p + 1``-entry causal history (k
    and v each, at storage dtype); a sliding window clamps that to the
    last ``window`` entries.  A block-paged cache bills whole pages
    ``[0, ceil((p + 1) / page_size))`` and IGNORES the window: the paged
    kernel (B5) walks every history page of the table and masks the
    window in its tiles.  ``positions``: iterable of per-row cache
    positions (the engine's live slots).
    """
    per_tok = 2 * n_kv_heads * head_dim * dtype_bytes(dtype)
    tokens = 0
    for p in positions:
        hi = int(p) + 1                      # rows [0, hi) are live
        if page_size:
            tokens += -(-hi // page_size) * page_size
        else:
            lo = max(0, hi - window) if window > 0 else 0
            tokens += hi - lo
    return tokens * per_tok
