"""Published reference data from the paper (Tables II, III, IV).

A copy of the JAX package's ``repro/core/paper_tables.py``.  These rows
are the ground truth the faithful analytical models in
:mod:`repro_torch.core.paper_model` are validated against
(``tests/test_torch_paper_model.py``).

Units note (derived during reproduction, documented in EXPERIMENTS.md):
the paper's "BW (GB/s)" columns are bytes / 2**30 per second (GiB/s).  Our
models reproduce the printed numbers exactly under that convention.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class VersalRow:
    """One row of Table III (plus Table II where applicable)."""

    u: int
    v: int
    w: int
    pattern: str                  # 'P1' (13x4x6) or 'P2' (10x3x10)
    compute_gemm: Tuple[int, int, int]
    native_buffer: Tuple[int, int, int]
    luts: int                     # reference only (no analogue modeled)
    brams: int                    # implementation count (Table III)
    urams: int
    aie_cores: int
    pl_freq_mhz: float
    throughput_tops: float
    power_w: float
    energy_eff: float             # TOPs/W
    ram_eff: float                # fraction
    bw_gibps: float               # paper prints GB/s; actually bytes/2^30
    mapping: Optional[Tuple[str, str, str]] = None   # Table II {A,B,C} map


# Table III: 10 top-ranked GEMM designs on Versal VC1902 (AIE @ 1.25 GHz).
VERSAL_TABLE3 = [
    VersalRow(2, 8, 2, "P1", (416, 512, 192), (832, 4096, 384),
              85_000, 630, 304, 390, 300, 77.01, 78.6, 0.980, 0.889, 145.2,
              ("U", "U", "B")),
    VersalRow(2, 2, 8, "P1", (416, 512, 192), (832, 1024, 1536),
              0, 422, 408, 390, 290, 76.93, 82.0, 0.938, 0.889, 101.4,
              ("B", "U", "U")),
    VersalRow(3, 2, 5, "P1", (416, 512, 192), (1248, 1024, 960),
              94_000, 792, 408, 390, 278, 76.72, 82.7, 0.932, 0.757, 100.7,
              ("B", "U", "U")),
    VersalRow(4, 2, 4, "P1", (416, 512, 192), (1664, 1024, 768),
              90_000, 792, 408, 390, 278, 76.72, 82.3, 0.928, 0.816, 101.9,
              ("B", "U", "U")),
    VersalRow(2, 4, 4, "P1", (416, 512, 192), (832, 2048, 768),
              97_000, 792, 408, 390, 278, 76.72, 82.8, 0.927, 0.626, 106.9,
              ("B", "U", "U")),
    VersalRow(2, 8, 2, "P2", (320, 384, 320), (640, 3072, 640),
              92_000, 806, 240, 400, 300, 76.08, 78.3, 0.971, 0.889, 122.2,
              ("U", "U", "B")),
    VersalRow(2, 7, 2, "P2", (320, 384, 320), (640, 2688, 640),
              92_000, 806, 240, 400, 300, 76.08, 77.8, 0.977, 0.810, 123.9,
              ("U", "U", "B")),
    VersalRow(2, 6, 2, "P2", (320, 384, 320), (640, 2304, 640),
              91_000, 806, 240, 400, 300, 76.08, 77.5, 0.982, 0.732, 126.1,
              ("U", "U", "B")),
    VersalRow(4, 2, 4, "P2", (320, 384, 320), (1280, 768, 1280),
              100_000, 912, 400, 400, 275, 75.40, 82.8, 0.911, 0.902, 100.6,
              ("B", "B", "U")),
    VersalRow(4, 2, 3, "P2", (320, 384, 320), (1280, 768, 960),
              100_000, 912, 400, 400, 275, 75.40, 82.0, 0.919, 0.702, 109.7,
              ("B", "B", "U")),
]


@dataclasses.dataclass(frozen=True)
class Table2Row:
    """Table II: model estimate vs HLS AUTO mapping."""

    u: int
    v: int
    w: int
    pattern: str
    mapping: Tuple[str, str, str]       # model's {A,B,C} -> {B,U}
    model_brams: int
    model_urams: int
    auto_brams: int
    auto_urams: int
    auto_fails: bool                    # URAM over-capacity -> PnR failure


VERSAL_TABLE2 = [
    Table2Row(4, 2, 4, "P1", ("B", "U", "U"), 780, 408, 0, 616, True),
    Table2Row(4, 2, 4, "P2", ("B", "B", "U"), 900, 400, 0, 640, True),
    Table2Row(2, 2, 8, "P1", ("B", "U", "U"), 416, 408, 416, 408, False),
    Table2Row(2, 8, 2, "P2", ("U", "U", "B"), 800, 240, 800, 240, False),
]


@dataclasses.dataclass(frozen=True)
class StratixRow:
    """One row of Table IV."""

    tb_len: int
    kp: int
    np_: int
    mp: int
    compute_gemm: Tuple[int, int, int]
    native_buffer: Tuple[int, int, int]
    alms: int                     # reference only
    brams: int                    # M20K count
    tbs: int
    freq_mhz: float
    throughput_tops: float
    power_w: float
    energy_eff: float
    ram_eff: float
    bw_gibps: float


# Table IV: 10 top-ranked GEMM designs on Stratix 10 NX 2100.
STRATIX_TABLE4 = [
    StratixRow(18, 16, 4, 3, (9, 2720, 4), (639, 2720, 1008),
               124_000, 6304, 3456, 349, 68.00, 51.1, 1.331, 0.880, 92.6),
    StratixRow(18, 8, 8, 3, (9, 1360, 8), (675, 2720, 928),
               123_000, 6064, 3456, 345, 67.21, 50.2, 1.340, 0.877, 91.6),
    StratixRow(9, 16, 5, 5, (15, 1280, 5), (900, 1280, 1000),
               127_000, 5840, 3600, 350, 66.94, 52.5, 1.275, 0.812, 90.2),
    StratixRow(12, 8, 6, 6, (18, 880, 6), (1152, 1760, 756),
               100_000, 6144, 3456, 338, 64.00, 48.6, 1.317, 0.867, 82.2),
    StratixRow(18, 16, 3, 4, (12, 2720, 3), (850, 2720, 750),
               108_000, 6272, 3456, 327, 63.71, 47.3, 1.347, 0.859, 85.4),
    StratixRow(9, 16, 6, 4, (12, 1280, 6), (912, 2560, 756),
               131_000, 6464, 3456, 342, 62.88, 50.7, 1.241, 0.851, 82.3),
    StratixRow(18, 8, 3, 8, (24, 1360, 3), (1600, 1360, 550),
               81_000, 6064, 3456, 321, 62.40, 46.5, 1.342, 0.831, 92.4),
    StratixRow(9, 8, 10, 5, (15, 640, 10), (900, 1280, 1000),
               124_000, 5840, 3600, 320, 61.21, 48.7, 1.257, 0.812, 82.4),
    StratixRow(18, 8, 5, 5, (15, 1360, 5), (1020, 2720, 630),
               101_000, 6150, 3600, 301, 61.08, 45.4, 1.346, 0.900, 83.5),
    StratixRow(18, 4, 8, 6, (18, 680, 8), (1152, 1360, 832),
               91_000, 6080, 3456, 312, 60.69, 46.2, 1.315, 0.843, 79.3),
]

# Paper headline claims (abstract / SS V).
VERSAL_PEAK_TOPS_CLAIM = 77.01
STRATIX_PEAK_TOPS_CLAIM = 68.00
VERSAL_BEST_EFF_CLAIM = 0.94       # TOPs/W ("up to 0.94")
STRATIX_BEST_EFF_CLAIM = 1.35
VERSAL_PEAK_FRACTION_CLAIM = (0.589, 0.601)   # 58.9-60.1% of 128 TOPs (AIE)
STRATIX_PEAK_FRACTION_CLAIM = 0.476           # 47.6% of 143 TOPs
VERSAL_DDR_LIMIT_GIBPS = 102.4     # gate used on the printed BW column
