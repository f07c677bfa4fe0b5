"""Three-term roofline of a counted step (port of ``repro/core/roofline.py``).

    compute term    = FLOPs / peak op/s                 (per rank)
    memory term     = device-memory bytes / HBM rate    (per rank)
    collective term = collective result bytes / link rate

The three counts come from :mod:`repro_torch.core.op_cost` (the port's
counterpart of ``repro/core/hlo_cost.py``: every op counted as it runs,
each kernel at its boundary), priced on ``HOPPER_H100`` through
:func:`repro_torch.core.bandwidth.effective_rates`: the bf16 tensor-core
rate, the f32 rate for an f32 step (``f32=True``), the int8 rate under
W8A8 (``int8=True``), and any installed calibration.  The collective
term takes the sheet's NVLink rate (``HopperChip.link_bw``, one
direction), which flatters a collective that leaves the 8 cards of a
node.  The reference's XLA diagnostics (``xla_flops_raw``,
``xla_bytes_raw``, ``n_while``: what ``compiled.cost_analysis()`` says
with loops counted once) have no counterpart: nothing is compiled, and
no loop is counted once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.bandwidth import effective_rates
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.core.op_cost import OpCost


@dataclasses.dataclass
class RooflineReport:
    """The per-(arch x shape x mesh) roofline record."""

    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    per_collective: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    peak_flops: float
    model_flops_per_device: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card's compute roofline this step achieves,
        assuming perfect overlap: t_compute / max(all terms)."""
        return self.t_compute / self.t_bound if self.t_bound else 0.0

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy waste detector."""
        if self.model_flops_per_device is None or not self.flops_per_device:
            return None
        return self.model_flops_per_device / self.flops_per_device

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant,
                 roofline_fraction=self.roofline_fraction,
                 useful_flops_ratio=self.useful_flops_ratio,
                 t_bound=self.t_bound)
        return d


def analyze(cost: OpCost, *, chip=HOPPER_H100, int8: bool = False,
            f32: bool = False,
            model_flops_per_device: Optional[float] = None
            ) -> RooflineReport:
    """The three-term roofline of one rank's counted step on ``chip``."""
    peak, hbm_bw = effective_rates(chip, int8, f32=f32)
    coll = cost.collective_total
    return RooflineReport(
        flops_per_device=cost.flops,
        hbm_bytes_per_device=cost.bytes_accessed,
        collective_bytes_per_device=coll,
        per_collective=dict(cost.collective_bytes),
        t_compute=cost.flops / peak,
        t_memory=cost.bytes_accessed / hbm_bw,
        t_collective=coll / chip.link_bw,
        peak_flops=peak,
        model_flops_per_device=model_flops_per_device)
