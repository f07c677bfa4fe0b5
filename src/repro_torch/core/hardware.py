"""Hardware sheets for the cost model (port of ``repro/core/hardware.py``).

* ``HOPPER_H100`` — the port's target: one NVIDIA H100 SXM card, its
  datasheet rates, and the on-chip budget and tile rules of the port's
  GEMM kernels (``csrc/gemm_tb.cu``, ``csrc/gemm_aie.cu``,
  ``csrc/gemm_grouped.cu``).
* ``TPU_V5E`` — a copy of the JAX package's sheet, kept only so that the
  tests can hold this package's search against ``repro.core.dse``.  No
  number on it describes the port's card.
* ``VERSAL_VC1902`` and ``STRATIX_NX2100`` with the AIE and Tensor Block
  constants — copies of the paper's devices (Table I) from the JAX
  sheet, which :mod:`repro_torch.core.paper_model` consumes.

Besides the rates, a sheet carries what ``repro.core.dse`` and
``repro.core.memory_model`` hard-code for the TPU: the candidate tile
edges, the alignment rule, whether blocks pad to (sublane, lane) tiles,
the share of on-chip memory a tiling may plan for, and how many (bm, bn)
f32 buffers the A-stationary dataflow keeps for C.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB

#: Kernel B6's bf16 body (csrc/gemm_ws.cuh, shared with B1) runs one or two
#: consumer warpgroups of 64 rows on wgmma (N up to 256), or, for at most 16
#: rows, the mma.sync form (16 rows, 8 to 256 columns).  It launches any C
#: tile of at most 128 x 256; the search proposes only the tiles it runs
#: without padded work (at most 16 rows and a power-of-two width, or a
#: multiple of 64 rows and whole 64-column panels).
B6_WS_MAX_BM = 128
B6_WS_MAX_BN = 256
B6_WS_MMA_BM = 16
B6_WS_PANEL = 64
#: its ring of B slabs (csrc/gemm_ws.cuh kTbStages, kTbRingBytes,
#: kMaxStages)
B6_WS_STAGES = 4
B6_WS_RING_BYTES = 65536
B6_WS_MAX_STAGES = 16
#: B6's int8 tensor-core bodies (csrc/gemm_tb.cuh) run 256 threads (8
#: warps) a CTA and split the C tile into m16 x n8 fragments, a warp owning
#: at most 4 neighbouring ones of one 16-row block.
B6_THREADS = 256
B6_MAX_FRAGS_PER_WARP = 4
#: B6's f32 body (csrc/gemm_f32.cuh, shared with B1) runs 256 threads too,
#: each a block of rows x columns of fmaf chains (min(4, bm bn / 256)
#: columns): tiles whose edges are powers of two, 8 to 128 rows, 32 to 256
#: columns and 1 to 16 chains a thread.  Its ring holds B6_F32_STAGES
#: stages of B6_F32_STAGE_BYTES of B and its A panel is held as panels of
#: at most B6_F32_PANEL_COLS columns (csrc/gemm_f32.cuh kTbStages,
#: kTbStageBytes, kTbPanelCols), its chunks on the 32-grid (kGrid).
B6_F32_BM = (8, 128)
B6_F32_BN = (32, 256)
B6_F32_MAX_CHAINS = 16
B6_F32_STAGES = 6
B6_F32_STAGE_BYTES = 16384
B6_F32_PANEL_COLS = 256
B6_F32_GRID = 32
#: cycles of one dependent fmaf on the card (tools/hopper_probe.cu probe 6
#: reads 4.06): a chain's step, the f32 bodies' floor a k step
F32_FFMA_CYCLES = 4
#: Kernel B7 (csrc/gemm_grouped.cu) launches one of its compiled CTA
#: shapes, picked by rows per expert (kernels/gemm_grouped.py cta_tile)
#: whatever the plan's tile says.  The largest C block one of them covers
#: is the bf16 prefill shape's 64 x 128 (four 16-row warps by two
#: 64-column ones on the tensor cores); the others (bf16 decode 16 x 128,
#: f32 8 x 128 and 16 x 64) fit inside it.
B7_MAX_BM = 64
B7_MAX_BN = 128


def _bf16_pair(a_dtype, b_dtype) -> bool:
    """bf16 A and B (B: A's dtype when None), the pair kernel B6's
    warp-specialised body takes."""
    return str(a_dtype).replace("torch.", "") == "bfloat16" and str(
        b_dtype or a_dtype).replace("torch.", "") == "bfloat16"


def _f32_a(a_dtype) -> bool:
    """An f32 A: kernel B6's f32 body (f32 or int8 B)."""
    return str(a_dtype).replace("torch.", "") == "float32"


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def f32_tb_smem(bm: int, bk: int) -> int:
    """Shared memory one CTA of B6's f32 body takes for a (bm, bk) panel
    (csrc/gemm_f32.cuh ``tb_smem``): the panel as panels of at most
    :data:`B6_F32_PANEL_COLS` columns (a chunk on the 32-grid), the ring,
    and an mbarrier a stage and one for the panel."""
    pw = min(B6_F32_PANEL_COLS, -(-bk // B6_F32_GRID) * B6_F32_GRID)
    return (bm * pw * -(-bk // pw) * 4 + B6_F32_STAGES * B6_F32_STAGE_BYTES
            + (B6_F32_STAGES + 1) * 8)


def ws_tb_tile(bm: int, bn: int) -> Tuple[int, int]:
    """The (rows, columns) one CTA of B6's bf16 body covers for a (bm,
    bn) plan tile (csrc/gemm_tb.cuh ``ws_rows`` / ``ws_cols``): 16 rows
    (the mma.sync form) for at most 16 rows, bn rounded up to a power of
    two from 8; else 64 or 128 rows on wgmma, bn rounded up to 64, 128 or
    256."""
    rows = B6_WS_MMA_BM if bm <= B6_WS_MMA_BM else 64 if bm <= 64 else 128
    cols = 8 if bm <= B6_WS_MMA_BM else B6_WS_PANEL
    while cols < bn:
        cols *= 2
    return rows, cols


def ws_tb_stages(bm: int, bn: int) -> int:
    """The stages of B's 64-deep slabs in one CTA of B6's bf16 body
    (csrc/gemm_tb.cuh ``ws_stages``): 4 on wgmma; the mma.sync form's
    narrow slabs as many as hold 64 KiB, from 4 to 16."""
    if bm > B6_WS_MMA_BM:
        return B6_WS_STAGES
    per = 64 * ws_tb_tile(bm, bn)[1] * 2
    return min(B6_WS_MAX_STAGES, max(B6_WS_STAGES, B6_WS_RING_BYTES // per))


@dataclasses.dataclass(frozen=True)
class TPUChip:
    """A TPU chip model used for roofline + DSE constraints."""

    name: str
    peak_bf16_flops: float          # FLOP/s
    peak_int8_ops: float            # OP/s (2x bf16 on v5e MXU)
    hbm_bytes: int                  # HBM capacity per chip
    hbm_bw: float                   # bytes/s
    vmem_bytes: int                 # VMEM scratchpad per core
    ici_link_bw: float              # bytes/s per link, per direction
    ici_links: int                  # torus links per chip
    dcn_bw: float                   # bytes/s per chip for pod-to-pod traffic
    mxu_dim: int = 128              # systolic array edge
    sublanes: int = 8               # fp32 sublane count; bf16=16, int8=32
    lane: int = 128
    # What repro/core/dse.py and memory_model.py hard-code for the TPU:
    m_candidates: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024,
                                     2048)   # _LANE_CANDIDATES + _M_EXTRA
    k_candidates: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    n_candidates: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    pads_tiles: bool = True         # blocks pad to (sublane, lane) tiles
    budget_fraction: float = 0.75   # compiler headroom in fits_vmem
    tb_c_buffers: int = 4           # C in + out, two pipeline stages each
    pinned_top: int = 10            # a pinned strategy's design is looked
                                    # for among the search's first 10

    @property
    def peak_f32_flops(self) -> float:
        """The JAX package prices every non-int8 GEMM at the bf16 rate."""
        return self.peak_bf16_flops

    @staticmethod
    def launchable(bm: int, bn: int, a_dtype: str = "bfloat16",
                   b_dtype=None) -> bool:
        """Pallas launches any block the VMEM budget admits."""
        return True

    @staticmethod
    def compute_seconds(tile, p, flops: float, peak: float) -> float:
        """The operations at the sheet's rate (``repro/core/bandwidth.py``
        estimate)."""
        return flops / peak

    @staticmethod
    def grouped_launchable(bm: int, bn: int) -> bool:
        """The grouped Pallas sweep too."""
        return True

    def tile_aligned(self, bm: int, bk: int, bn: int, p=None) -> bool:
        """MXU-friendly: lane dims multiples of 128, sublane dim aligned
        (``repro/core/tiling.py:170``)."""
        return (bn % self.lane == 0 and bk % self.lane == 0
                and bm % self.sublanes == 0)


TPU_V5E = TPUChip(
    name="tpu_v5e",
    peak_bf16_flops=197e12,
    peak_int8_ops=394e12,
    hbm_bytes=16 * GiB,
    hbm_bw=819e9,
    vmem_bytes=128 * MiB,
    ici_link_bw=50e9,
    ici_links=4,            # 2D torus on v5e: 4 links
    dcn_bw=25e9,            # conservative per-chip share of pod-to-pod DCN
)


@dataclasses.dataclass(frozen=True)
class HopperChip:
    """One NVIDIA Hopper card as the cost model sees it.

    ``vmem_bytes`` is the on-chip budget of one kernel instance: on a
    Hopper card the shared memory one CTA can take, which the tiling
    search and the B6 launcher both check against.  The attribute keeps
    the JAX package's name so the two searches line up one for one.
    """

    name: str
    peak_bf16_flops: float          # dense tensor-core FLOP/s
    peak_int8_ops: float            # dense tensor-core OP/s
    peak_f32_flops: float           # FLOP/s outside the tensor cores
    hbm_bytes: int
    hbm_bw: float                   # bytes/s
    vmem_bytes: int                 # shared memory per CTA
    sm_count: int
    link_bw: float = 0.0            # bytes/s a card sends to its peers,
                                    # one direction (the roofline's
                                    # collective term)
    sublanes: int = 8               # smallest row edge of a tile
    lane: int = 32                  # warp width: the k / n edge quantum
    m_candidates: Tuple[int, ...] = (8, 16, 32, 64, 128)
    k_candidates: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    n_candidates: Tuple[int, ...] = (32, 64, 128, 256)
    pads_tiles: bool = False        # the kernels mask ragged edges
    budget_fraction: float = 1.0    # vmem_bytes is already the CTA limit
    tb_c_buffers: int = 2           # B6 prefetches C in; C leaves from
                                    # registers
    pinned_top: int = 1 << 20       # a pinned strategy takes its best
                                    # design, however far down the ranking
    sm_clock_hz: float = 1.98e9     # the highest SM clock (datasheet)

    def compute_seconds(self, tile, p, flops: float, peak: float) -> float:
        """The operations' time.  A dense f32 GEMM runs B1's or B6's f32
        body (csrc/gemm_f32.cuh) on the CUDA cores of the SMs its CTAs
        occupy: its operations go at the sheet's f32 rate times the share
        of the card those CTAs fill (B1's grid at the CTA shape it picks
        by m and n whatever the plan's tile; B6's at the plan's tile and
        n split), and no faster than one fmaf chain over k, k dependent
        fmaf at :data:`F32_FFMA_CYCLES` each.  Anything else at the
        sheet's rate."""
        if not (_f32_a(p.a_dtype) and p.n_b_operands == 1
                and not p.n_groups):
            return flops / peak
        from repro_torch.core.tiling import cdiv
        from repro_torch.kernels.gemm_aie import F32_TILES, _f32_config
        from repro_torch.kernels.gemm_tb import n_split
        if tile.strategy == "aie":
            bm, _, bn = F32_TILES[_f32_config(p.m, p.n)]
            ctas = cdiv(p.m, bm) * cdiv(p.n, bn)
        else:
            gm, n_tiles = cdiv(p.m, tile.bm), cdiv(p.n, tile.bn)
            per = n_split(gm, n_tiles, f32_tb_smem(tile.bm, tile.bk))
            ctas = gm * cdiv(n_tiles, per)
        share = min(1.0, ctas / self.sm_count)
        chain = p.k * F32_FFMA_CYCLES / self.sm_clock_hz
        return max(flops / (peak * share), chain)

    def tile_aligned(self, bm: int, bk: int, bn: int, p=None) -> bool:
        """A DSE candidate for the problem ``p`` (a ``GemmProblem``; None:
        a dense bf16 one of unknown size): edges on the sheet's quanta
        and a (bm, bn) tile that kernel B6 launches (:meth:`launchable`).
        For a dense (single-B, ungrouped) bf16 problem, which B6's
        warp-specialised body runs, also a tile whose CTA (``ws_tb_tile``)
        does no padded work -- at most 16 rows or exactly 64 or 128, and
        bn the CTA's width -- or one that covers all of m (n) already.  A
        dense f32 problem takes the f32 body's rule; the gated and
        grouped searches keep the int8 bodies' (the old 256-thread rule,
        unchanged)."""
        if not (bm % self.sublanes == 0 and bk % self.lane == 0
                and bn % self.lane == 0):
            return False
        a_dtype, b_dtype = (p.a_dtype, p.b_dtype) if p else ("bfloat16",
                                                             None)
        dense = p is None or (p.n_b_operands == 1 and not p.n_groups)
        if dense and _f32_a(a_dtype):
            return self._launchable_f32(bm, bn)
        if not (dense and _bf16_pair(a_dtype, b_dtype)):
            return self._launchable_int8(bm, bn)
        m, n = (p.m, p.n) if p else (0, 0)
        rows, cols = ws_tb_tile(bm, bn)
        return (self.launchable(bm, bn, a_dtype, b_dtype)
                and (bm == rows or bm <= B6_WS_MMA_BM or bm >= m > 0)
                and (bn == cols or bn >= n > 0))

    @staticmethod
    def launchable(bm: int, bn: int, a_dtype: str = "bfloat16",
                   b_dtype=None) -> bool:
        """Whether kernel B6 covers a (bm, bn) C tile of A and B of these
        dtypes (B: A's when None).  bf16 x bf16 runs the warp-specialised
        body: any tile of at most 128 x 256; an f32 A the f32 body
        (:meth:`_launchable_f32`); the int8 pairs the int8 tensor-core
        bodies (:meth:`_launchable_int8`)."""
        if _bf16_pair(a_dtype, b_dtype):
            return 1 <= bm <= B6_WS_MAX_BM and 1 <= bn <= B6_WS_MAX_BN
        if _f32_a(a_dtype):
            return HopperChip._launchable_f32(bm, bn)
        return HopperChip._launchable_int8(bm, bn)

    @staticmethod
    def _launchable_int8(bm: int, bn: int) -> bool:
        """Whether B6's int8 tensor-core bodies cover a (bm, bn) C tile:
        each of their 8 warps owns at most 4 neighbouring m16 x n8
        fragments of one 16-row block (``cdiv(bm, 16) * cdiv(bn, 32) <=
        8``), bn at most 256."""
        if not 1 <= bn <= B6_THREADS or bm < 1:
            return False
        warps = B6_THREADS // 32
        per_warp = 8 * B6_MAX_FRAGS_PER_WARP
        return -(-bm // 16) * -(-bn // per_warp) <= warps

    @staticmethod
    def _launchable_f32(bm: int, bn: int) -> bool:
        """Whether B6's f32 body covers a (bm, bn) C tile: edges powers of
        two in :data:`B6_F32_BM` and :data:`B6_F32_BN`, and 1 to
        :data:`B6_F32_MAX_CHAINS` chains for each of its 256 threads."""
        chains = bm * bn / B6_THREADS
        return (_pow2(bm) and _pow2(bn)
                and B6_F32_BM[0] <= bm <= B6_F32_BM[1]
                and B6_F32_BN[0] <= bn <= B6_F32_BN[1]
                and 1 <= chains <= B6_F32_MAX_CHAINS)

    @staticmethod
    def grouped_launchable(bm: int, bn: int) -> bool:
        """Whether one CTA of B7 covers a (bm, bn) C tile of the grouped
        sweep: ``bm <= 64`` and ``bn <= 128``, the largest CTA tile it
        launches.  The grouped search admits only these."""
        return 1 <= bm <= B7_MAX_BM and 1 <= bn <= B7_MAX_BN


HOPPER_H100 = HopperChip(
    name="h100_sxm",
    # NVIDIA H100 SXM datasheet, dense (no sparsity), at the 700 W limit:
    # 989 TFLOP/s bf16, 1979 TOP/s int8 tensor-core rates, 67 TFLOP/s f32
    # on the CUDA cores; 80 GB HBM3 at 3.35 TB/s.
    peak_bf16_flops=989e12,
    peak_int8_ops=1979e12,
    peak_f32_flops=67e12,
    hbm_bytes=80 * GiB,
    hbm_bw=3.35e12,
    # Hopper (compute capability 9.0): 227 KiB = 232448 bytes of the SM's
    # 256 KB shared memory / L1 is the most one CTA can take, as dynamic
    # shared memory.
    vmem_bytes=227 * KiB,
    sm_count=132,           # H100 SXM
    # NVIDIA H100 SXM datasheet: fourth-generation NVLink, 900 GB/s a card
    # to the other cards of its host, both directions together; 450 GB/s
    # is one direction.  Optimistic for collectives that leave the 8
    # cards of a node (those cross the network at a fraction of it).
    link_bw=450e9,
)


@dataclasses.dataclass(frozen=True)
class FPGADevice:
    """Paper Table I rows (only the fields the analytical models consume)."""

    name: str
    bram_36k: int            # Versal: 36Kb BRAM count; Stratix: M20K count
    uram_288k: int           # Versal only (0 for Stratix)
    onchip_mem_bytes: float
    peak_tops_int8: float
    peak_dram_bw: float      # bytes/s
    peak_power_w: float
    compute_units: int       # AIE cores (Versal) / Tensor Blocks (Stratix)


# Versal VC1902: 967 36Kb BRAMs + 463 URAMs (AM007); paper quotes utilization
# percentages that imply B36K=967 and U288K=463: e.g. Table II: 780/81%≈963,
# 408/88%≈464, 912/94%≈970, 400/86%≈465 -> (967, 463) matches all rows.
VERSAL_VC1902 = FPGADevice(
    name="versal_vc1902",
    bram_36k=967,
    uram_288k=463,
    onchip_mem_bytes=20.5e6 + 12.5e6,     # PL + AIE memory (Table I)
    peak_tops_int8=135e12,
    peak_dram_bw=102.4e9,
    peak_power_w=165.0,
    compute_units=400,                    # AIE cores
)

# Stratix 10 NX 2100: 6847 M20Ks (paper percentages: 6304/92%≈6852,
# 5840/85%≈6871, 6464/94%≈6877 -> 6847 is the published device count).
STRATIX_NX2100 = FPGADevice(
    name="stratix_nx2100",
    bram_36k=6847,                        # M20K blocks
    uram_288k=0,
    onchip_mem_bytes=16.75e6,
    peak_tops_int8=143e12,
    peak_dram_bw=512e9,
    peak_power_w=125.0,
    compute_units=3960,                   # Tensor Blocks
)


# Versal AIE single-kernel shape used by all MaxEVA solutions in the paper.
AIE_KERNEL_M, AIE_KERNEL_K, AIE_KERNEL_N = 32, 128, 32
AIE_FREQ_HZ = 1.25e9
AIE_KERNEL_EFFICIENCY = 0.95              # paper §V-A: 95% MatMul efficiency
AIE_MACS_PER_CYCLE = 128                  # int8 MACs/cycle/core (128 ops=2*128)

# Stratix TB constants (paper §III-B).
TB_CHAIN = 36                             # TBs per physical chain
TB_DOT = 10                               # dot-product width
TB_LANES = 3                              # parallel dot engines / TB
TB_LOAD_CYCLES = 3                        # cascade loading cycles per TB
TB_CASCADE_CYCLES = 2                     # dot+cascade latency per TB
