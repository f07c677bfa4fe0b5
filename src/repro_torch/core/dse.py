"""Reuse-maximizing tiling search (port of ``repro/core/dse.py``).

    minimize   modeled device-memory traffic / roofline time
    subject to the on-chip budget   (memory_model.fits_vmem)
               the sheet's tile rule (TileConfig.mxu_aligned)

over the sheet's candidate edges, with the two dataflow strategies
('aie' / 'tb') searched jointly.  The search is exhaustive and memoized
per (problem, sheet, calibration version).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.bandwidth import (
    TrafficEstimate,
    calibration_version,
    estimate,
)
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.memory_model import (
    fits_vmem,
    vmem_efficiency,
    vmem_footprint,
)
from repro_torch.core.tiling import (
    STRATEGIES,
    GemmProblem,
    TileConfig,
    min_sublane,
    round_up,
)


@dataclasses.dataclass(frozen=True)
class TileDesign:
    """One scored point of the search."""

    tile: TileConfig
    traffic: TrafficEstimate
    vmem_bytes: int
    vmem_eff: float
    tile_eff: float

    @property
    def score(self) -> Tuple:
        # Primary: modeled roofline time.  Ties: less traffic, higher
        # on-chip efficiency, smaller footprint.
        return (self.traffic.t_model, self.traffic.hbm_bytes,
                -self.vmem_eff, self.vmem_bytes)


def _m_candidates(m: int, dtype, chip) -> Sequence[int]:
    sub = min_sublane(dtype, chip)
    cands = sorted(c for c in set(chip.m_candidates) if c >= sub)
    # never tile beyond the (padded) problem dim
    cap = round_up(m, sub)
    return [c for c in cands if c <= max(cap, cands[0])] or [cands[0]]


def _lane_candidates(dim: int, chip, cands: Sequence[int]) -> Sequence[int]:
    cap = round_up(dim, chip.lane)
    out = [c for c in cands if c <= cap]
    return out or [chip.lane]


@functools.lru_cache(maxsize=4096)
def _solve_cached(m: int, k: int, n: int, a_dtype: str, b_dtype: str,
                  out_dtype: str, acc_dtype: str, epilogue: str,
                  n_b_operands: int, n_groups: int, chip,
                  budget_fraction: Optional[float], top: int,
                  cal_version: int) -> Tuple["TileDesign", ...]:
    p = GemmProblem(m, k, n, a_dtype, out_dtype, acc_dtype, b_dtype,
                    epilogue, n_b_operands, n_groups)
    designs: List[TileDesign] = []
    for strategy in STRATEGIES:
        if n_b_operands > 1 and strategy == "tb":
            continue    # the gated dual-B kernel is output-stationary only
        if n_groups and strategy == "tb":
            continue    # the grouped sweep is output-stationary only
        for bm in _m_candidates(m, a_dtype, chip):
            for bk in _lane_candidates(k, chip, chip.k_candidates):
                for bn in _lane_candidates(n, chip, chip.n_candidates):
                    tile = TileConfig(bm, bk, bn, strategy)
                    if not tile.mxu_aligned(chip, p):
                        continue
                    if n_groups and not chip.grouped_launchable(bm, bn):
                        continue
                    if not fits_vmem(tile, p, chip, budget_fraction):
                        continue
                    designs.append(TileDesign(
                        tile=tile,
                        traffic=estimate(tile, p, chip),
                        vmem_bytes=vmem_footprint(tile, p, chip).total,
                        vmem_eff=vmem_efficiency(tile, p, chip),
                        tile_eff=tile.tile_efficiency(p),
                    ))
    if not designs:
        raise ValueError(f"no feasible tiling for {p} on {chip.name}")
    designs.sort(key=lambda d: d.score)
    return tuple(designs[:top])


def solve(p: GemmProblem, chip=TPU_V5E,
          budget_fraction: Optional[float] = None, top: int = 10
          ) -> List[TileDesign]:
    """Ranked tiling designs for a GEMM problem on ``chip``.  The memo
    key holds the sheet and the cost-model calibration version."""
    return list(_solve_cached(p.m, p.k, p.n, p.a_dtype, p.b_dtype,
                              p.out_dtype, p.acc_dtype, p.epilogue,
                              p.n_b_operands, p.n_groups, chip,
                              budget_fraction, top,
                              calibration_version()))


def best_tile(m: int, k: int, n: int, in_dtype: str = "bfloat16",
              out_dtype: str = "bfloat16", acc_dtype: str = "float32",
              strategy: Optional[str] = None, *,
              b_dtype: Optional[str] = None, epilogue: str = "",
              n_b_operands: int = 1, chip=TPU_V5E) -> TileConfig:
    """The search's winner on ``chip``, optionally restricted to one
    strategy."""
    p = GemmProblem(m, k, n, in_dtype, out_dtype, acc_dtype, b_dtype,
                    epilogue, n_b_operands)
    for d in solve(p, chip):
        if strategy is None or d.tile.strategy == strategy:
            return d.tile
    raise ValueError(f"no feasible {strategy!r} tiling for {p}")
