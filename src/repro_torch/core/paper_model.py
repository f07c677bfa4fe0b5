"""Faithful analytical models of the paper's two GEMM frameworks.

A copy of the JAX package's ``repro/core/paper_model.py`` (nothing in it
touches JAX or a card); ``tests/test_torch_paper_model.py`` holds every
function equal to the original on every row of the paper's tables.

This module reproduces, in code, the analytical machinery of

    *Efficient Approaches for GEMM Acceleration on Leading AI-Optimized
    FPGAs* (Taka, Gourounas, Gerstlauer, Marculescu, Arora, 2024)

for both devices:

* **Versal VC1902** (SS IV-A): the MaxEVA AIE solutions, the PL buffer
  geometry (eq. 1-3), the BRAM/URAM block-count model (eq. 4-5), the
  depth constraint (eq. 6), the resource constraints (eq. 7-8 over all
  mapping permutations), the reuse-maximizing U,V,W IP/DSE, the HLS-AUTO
  failure mode (Table II), the worst-case DDR bandwidth model, the RAM
  *efficiency* metric, and a calibrated throughput model.

* **Stratix 10 NX 2100** (SS IV-B): the TB layout algebra (compute GEMM
  size), the M20K block-count model (eq. 9-14), the IP solver maximizing
  ``M'*K'*N'`` under eq. 15-16, throughput, bandwidth and RAM efficiency.

Everything here is validated against the paper's published rows in
:mod:`repro_torch.core.paper_tables` (``tests/test_torch_paper_model.py``).

Calibrated constants (documented, derived from the paper's own measured
data — the paper measures these effects in hardware emulation/ModelSim and
attributes them to AIE memory-conflict stalls resp. control overhead):

* ``AIE_ARRAY_STALL``: per-placement-pattern array-level efficiency on top
  of the 95% single-kernel efficiency.  Calibrated on the two 300 MHz
  designs; reproduces all ten Table III throughputs within 0.9%.
* ``TB_DRAIN_FACTOR``: 0.995 cascade drain/control overhead; reproduces all
  ten Table IV throughputs within 0.3%.

Units note: the paper's printed "BW (GB/s)" columns are bytes/2**30 per
second.  ``*_bw_gibps`` functions return that printed unit; ``*_bw_bytes``
return SI bytes/s.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hardware import (
    AIE_FREQ_HZ,
    AIE_KERNEL_EFFICIENCY,
    AIE_MACS_PER_CYCLE,
    STRATIX_NX2100,
    TB_CHAIN,
    TB_DOT,
    TB_LANES,
    TB_LOAD_CYCLES,
    VERSAL_VC1902,
    FPGADevice,
)

# ---------------------------------------------------------------------------
# Versal ACAP (SS IV-A)
# ---------------------------------------------------------------------------

BRAM_BITS = 36 * 1024            # 36Kb BRAM
URAM_BITS = 288 * 1024           # 288Kb URAM
M20K_BITS = 20 * 1024            # Stratix M20K
PLIO_BITS = 128                  # PLIO width (SS IV-A3)

# Array-level stall factors, calibrated once per placement pattern from the
# paper's 300 MHz designs (Table III rows 1 and 6).  The paper attributes
# the gap to AIE memory-conflict stalls and the non-computing Add kernels
# (SS V-C3); MaxEVA measures it, we carry it as a constant.
AIE_ARRAY_STALL = {"P1": 0.81194, "P2": 0.83421}

# Table III implementation BRAM counts exceed the buffer model by 6-12
# blocks (FIFOs etc.); Table II (the model-estimate table) matches exactly.
BRAM_IMPL_OVERHEAD_TOL = 12


@dataclasses.dataclass(frozen=True)
class AIESolution:
    """A MaxEVA AIE-array solution (X,Y,Z placement, M,K,N kernel)."""

    pattern: str
    x: int
    y: int
    z: int
    m: int = 32
    k: int = 128
    n: int = 32

    @property
    def matmul_cores(self) -> int:
        return self.x * self.y * self.z

    @property
    def add_cores(self) -> int:
        # One AIE core runs each group's (Y-1)-kernel adder tree (SS IV-A2).
        return self.x * self.z if self.y > 1 else 0

    @property
    def aie_cores(self) -> int:
        return self.matmul_cores + self.add_cores

    @property
    def compute_gemm(self) -> Tuple[int, int, int]:
        return (self.x * self.m, self.y * self.k, self.z * self.n)

    def native_buffer(self, u: int, v: int, w: int) -> Tuple[int, int, int]:
        cm, ck, cn = self.compute_gemm
        return (u * cm, v * ck, w * cn)


MAXEVA_P1 = AIESolution("P1", 13, 4, 6)      # highest-throughput solution
MAXEVA_P2 = AIESolution("P2", 10, 3, 10)     # highest-efficiency solution


@dataclasses.dataclass(frozen=True)
class BufferGeometry:
    """Partition factors and depths of the PL buffers (eq. 1-3)."""

    a_part: int
    a_depth: int
    b_part: int
    b_depth: int
    c_part: int
    c_depth: int

    def parts(self) -> Tuple[int, int, int]:
        return (self.a_part, self.b_part, self.c_part)

    def depths(self) -> Tuple[int, int, int]:
        return (self.a_depth, self.b_depth, self.c_depth)


def versal_buffer_geometry(sol: AIESolution, u: int, v: int, w: int
                           ) -> BufferGeometry:
    """Eq. 1-3: partition factor x2 for double buffering; depth /16 (A,B:
    16 int8 lanes per 128-bit beat) resp. /4 (C: 4 int32 per beat)."""
    return BufferGeometry(
        a_part=2 * sol.x * sol.y,
        a_depth=u * v * sol.m * sol.k // 16,
        b_part=2 * sol.y * sol.z,
        b_depth=v * w * sol.k * sol.n // 16,
        c_part=2 * sol.x * sol.z,
        c_depth=u * w * sol.m * sol.n // 4,
    )


def f_bram(depth: int) -> Optional[float]:
    """Eq. 4: 36K-BRAM blocks needed for one 128-bit-wide partition."""
    if depth <= 512:
        return 2.0
    if depth <= 1024:
        return 4.0
    if depth <= 2048:
        return 7.5          # 2Kx18 + the 2Kx2-on-1Kx18 packing trick
    if depth <= 4096:
        return 15.0
    return None


def f_uram(depth: int) -> Optional[float]:
    """Eq. 5: URAMs (4Kx72) needed for one 128-bit-wide partition."""
    return 2.0 if depth <= 4096 else None


MAX_DEPTH = 4096   # eq. 6


def _block_count(kind: str, depth: int) -> Optional[float]:
    return f_bram(depth) if kind == "B" else f_uram(depth)


def versal_mapping_cost(geom: BufferGeometry, mapping: Tuple[str, str, str]
                        ) -> Optional[Tuple[float, float]]:
    """(BRAMs, URAMs) used by a {A,B,C}->{B,U} mapping, or None if a depth
    is unsupported by the assigned resource."""
    brams = urams = 0.0
    for kind, part, depth in zip(mapping, geom.parts(), geom.depths()):
        f = _block_count(kind, depth)
        if f is None:
            return None
        if kind == "B":
            brams += part * f
        else:
            urams += part * f
    return brams, urams


def versal_best_mapping(geom: BufferGeometry,
                        device: FPGADevice = VERSAL_VC1902
                        ) -> Optional[Tuple[Tuple[str, str, str], float, float]]:
    """Search all 8 mapping permutations (eq. 7-8 'for all permutations');
    return the feasible one using the fewest blocks (ties: fewest URAMs)."""
    best = None
    for mapping in itertools.product("BU", repeat=3):
        cost = versal_mapping_cost(geom, mapping)  # type: ignore[arg-type]
        if cost is None:
            continue
        brams, urams = cost
        if brams > device.bram_36k or urams > device.uram_288k:
            continue
        key = (brams + urams, urams)
        if best is None or key < best[0]:
            best = (key, mapping, brams, urams)
    if best is None:
        return None
    return tuple(best[1]), best[2], best[3]  # type: ignore[return-value]


def versal_hls_auto_mapping(geom: BufferGeometry,
                            device: FPGADevice = VERSAL_VC1902
                            ) -> Tuple[Tuple[str, str, str], float, float, bool]:
    """The HLS-AUTO behaviour reverse-engineered from Table II: buffers with
    depth > 1024 go to URAM, others to BRAM.  Returns (mapping, brams,
    urams, fails) where *fails* flags over-capacity (the paper's PnR
    failure on 5/10 designs)."""
    mapping = tuple("U" if d > 1024 else "B" for d in geom.depths())
    cost = versal_mapping_cost(geom, mapping)
    assert cost is not None
    brams, urams = cost
    fails = brams > device.bram_36k or urams > device.uram_288k
    return mapping, brams, urams, fails  # type: ignore[return-value]


def versal_raw_aie_ops(sol: AIESolution) -> float:
    """Peak int8 ops/s of the MatMul cores at 95% kernel efficiency."""
    per_core = 2 * AIE_MACS_PER_CYCLE * AIE_FREQ_HZ   # 256 ops/cycle
    return sol.matmul_cores * per_core * AIE_KERNEL_EFFICIENCY


def versal_pl_stream_ops(sol: AIESolution, pl_freq_hz: float) -> float:
    """PL-side streaming bound: each PLIO port needs max(M*K/16, K*N/16,
    M*N/4) beats per compute-GEMM iteration (SS IV-A3 rate matching)."""
    beats = max(sol.m * sol.k // 16, sol.k * sol.n // 16, sol.m * sol.n // 4)
    cm, ck, cn = sol.compute_gemm
    ops_per_iter = 2.0 * cm * ck * cn
    return ops_per_iter * pl_freq_hz / beats


def versal_throughput_ops(sol: AIESolution, pl_freq_hz: float) -> float:
    """min(AIE-bound, PL-streaming-bound); reproduces Table III and the
    Fig. 7a frequency sweep (flat >=250 MHz, ~16% drop at 200 MHz)."""
    aie = versal_raw_aie_ops(sol) * AIE_ARRAY_STALL[sol.pattern]
    return min(aie, versal_pl_stream_ops(sol, pl_freq_hz))


def versal_bw_bytes(sol: AIESolution, u: int, v: int, w: int,
                    throughput_ops: float) -> float:
    """Worst-case DDR bytes/s: concurrent A+B loads and C store (all int8,
    'due to quantization in DL') per native-buffer GEMM."""
    nm, nk, nn = sol.native_buffer(u, v, w)
    bytes_per_native = nm * nk + nk * nn + nm * nn
    t_native = 2.0 * nm * nk * nn / throughput_ops
    return bytes_per_native / t_native


def bytes_to_gibps(bw_bytes: float) -> float:
    return bw_bytes / 2**30


def versal_ram_efficiency(geom: BufferGeometry,
                          mapping: Tuple[str, str, str]) -> float:
    """Logical bits / physical bits of all blocks used (SS IV-A4)."""
    logical = physical = 0.0
    for kind, part, depth in zip(mapping, geom.parts(), geom.depths()):
        f = _block_count(kind, depth)
        assert f is not None
        logical += part * depth * PLIO_BITS
        physical += part * f * (BRAM_BITS if kind == "B" else URAM_BITS)
    return logical / physical


@dataclasses.dataclass(frozen=True)
class VersalDesign:
    """One evaluated point of the Versal U,V,W DSE."""

    sol: AIESolution
    u: int
    v: int
    w: int
    mapping: Tuple[str, str, str]
    brams: float
    urams: float
    reuse: int                       # U*V*W — the DSE objective
    native_buffer: Tuple[int, int, int]
    ram_eff: float

    def throughput_ops(self, pl_freq_hz: float) -> float:
        return versal_throughput_ops(self.sol, pl_freq_hz)

    def bw_gibps(self, pl_freq_hz: float) -> float:
        thr = self.throughput_ops(pl_freq_hz)
        return bytes_to_gibps(versal_bw_bytes(self.sol, self.u, self.v,
                                              self.w, thr))


def versal_dse(sol: AIESolution, device: FPGADevice = VERSAL_VC1902,
               max_param: int = 16) -> List[VersalDesign]:
    """Exhaustive IP solve (SS IV-A4): maximize reuse U*V*W subject to
    eq. 6 (depth <= 4K) and eq. 7-8 (capacity under the best feasible
    mapping).  Returns designs sorted by (reuse desc, BW asc)."""
    designs: List[VersalDesign] = []
    for u, v, w in itertools.product(range(1, max_param + 1), repeat=3):
        geom = versal_buffer_geometry(sol, u, v, w)
        if max(geom.depths()) > MAX_DEPTH:
            continue
        found = versal_best_mapping(geom, device)
        if found is None:
            continue
        mapping, brams, urams = found
        designs.append(VersalDesign(
            sol=sol, u=u, v=v, w=w, mapping=mapping, brams=brams,
            urams=urams, reuse=u * v * w,
            native_buffer=sol.native_buffer(u, v, w),
            ram_eff=versal_ram_efficiency(geom, mapping)))
    # Rank: maximize reuse; tie-break on lower worst-case bandwidth (the
    # paper's DDR-feasibility consideration), then larger native buffer.
    ref_freq = 300e6
    designs.sort(key=lambda d: (-d.reuse, d.bw_gibps(ref_freq)))
    return designs


# ---------------------------------------------------------------------------
# Stratix 10 NX (SS IV-B)
# ---------------------------------------------------------------------------

# Cascade drain / control overhead calibrated against Table IV (<=0.3% err).
TB_DRAIN_FACTOR = 0.995


@dataclasses.dataclass(frozen=True)
class TBLayout:
    """The four TB architecture parameters (SS IV-B1)."""

    tb_len: int
    kp: int
    np_: int
    mp: int

    def __post_init__(self):
        if TB_CHAIN % self.tb_len != 0:
            raise ValueError(
                f"TB_len={self.tb_len} must divide the chain length "
                f"{TB_CHAIN} (SS IV-B3a)")

    @property
    def tbs(self) -> int:
        return self.tb_len * self.kp * self.np_ * self.mp

    @property
    def useful_tbs(self) -> int:
        # First TB of each array is a loading port only.
        return (self.tb_len - 1) * self.kp * self.np_ * self.mp

    @property
    def compute_gemm(self) -> Tuple[int, int, int]:
        """(D_M', D_K', D_N') = (Mp*3, (TBlen-1)*Kp*10, Np)."""
        return (self.mp * TB_LANES,
                (self.tb_len - 1) * self.kp * TB_DOT,
                self.np_)

    @property
    def min_nprime(self) -> int:
        """Eq. 16: N' >= TBlen*3*Np hides the cascade loading latency."""
        return self.tb_len * TB_LOAD_CYCLES * self.np_


def f_m80(depth: int) -> int:
    """Eq. 12: M20Ks for an 80-bit-wide buffer partition."""
    return 2 * math.ceil(depth / 512)


def f_m32(depth: int) -> int:
    """Eq. 14: M20Ks for a 32-bit-wide C partition."""
    return math.ceil(depth / 512)


@dataclasses.dataclass(frozen=True)
class StratixGeometry:
    a_part: int
    a_depth: int
    b_part: int
    b_depth: int
    c_part: int
    c_depth: int

    @property
    def m20ks(self) -> int:
        return (self.a_part * f_m80(self.a_depth)
                + self.b_part * f_m80(self.b_depth)
                + self.c_part * f_m32(self.c_depth))


def stratix_geometry(lay: TBLayout, mprime: int, kprime: int, nprime: int
                     ) -> StratixGeometry:
    """Eq. 9-14 (x2 factors are double buffering; /10 converts bytes to
    80-bit words)."""
    b_part = (lay.tb_len - 1) * lay.kp * lay.np_
    a_part = lay.mp * lay.kp
    c_part = lay.mp * lay.np_ * TB_LANES * 2
    return StratixGeometry(
        a_part=a_part,
        a_depth=math.ceil(2 * mprime * kprime / (a_part * TB_DOT)),
        b_part=b_part,
        b_depth=math.ceil(2 * kprime * nprime / (b_part * TB_DOT)),
        c_part=c_part,
        c_depth=math.ceil(mprime * nprime * 2 / c_part),
    )


def stratix_throughput_ops(lay: TBLayout, freq_hz: float) -> float:
    """useful_TBs * 3 dot-10 engines * 20 ops/engine/cycle * f."""
    return lay.useful_tbs * TB_LANES * 2 * TB_DOT * freq_hz * TB_DRAIN_FACTOR


def stratix_bw_bytes(mprime: int, kprime: int, nprime: int,
                     throughput_ops: float) -> float:
    bytes_per_native = mprime * kprime + kprime * nprime + mprime * nprime
    t_native = 2.0 * mprime * kprime * nprime / throughput_ops
    return bytes_per_native / t_native


def stratix_ram_efficiency(geom: StratixGeometry,
                           m20ks: Optional[int] = None) -> float:
    """Logical bits (incl. double buffering, already inside the depths) over
    physical M20K bits.  ``m20ks`` overrides the eq. 12/14 model count with
    an implementation count (the paper's printed efficiencies use the
    implemented block count, which exceeds the model on 3/10 rows)."""
    logical = ((geom.a_part * geom.a_depth + geom.b_part * geom.b_depth) * 80
               + geom.c_part * geom.c_depth * 32)
    return logical / ((m20ks or geom.m20ks) * M20K_BITS)


@dataclasses.dataclass(frozen=True)
class StratixDesign:
    layout: TBLayout
    mprime: int
    kprime: int
    nprime: int
    geom: StratixGeometry
    reuse: int

    @property
    def native_buffer(self) -> Tuple[int, int, int]:
        return (self.mprime, self.kprime, self.nprime)

    def throughput_ops(self, freq_hz: float) -> float:
        return stratix_throughput_ops(self.layout, freq_hz)

    def bw_gibps(self, freq_hz: float) -> float:
        thr = self.throughput_ops(freq_hz)
        return bytes_to_gibps(
            stratix_bw_bytes(self.mprime, self.kprime, self.nprime, thr))


def stratix_ip_solve(lay: TBLayout, device: FPGADevice = STRATIX_NX2100
                     ) -> StratixDesign:
    """SS IV-B5: maximize M'*K'*N' subject to the M20K capacity (eq. 15)
    and latency-hiding (eq. 16) constraints; dims are multiples of the
    compute GEMM size.  Exhaustive over the (K', M') multiple grid (the
    block-count functions are monotone in each dim, so each loop breaks at
    the first infeasible point); for each (K', M') the largest feasible N'
    multiple, the one whose reuse beats every smaller N' there, is found
    by doubling and bisection.  The winner is the one the reference's
    walk over every N' (``repro/core/paper_model.py``) keeps: the first
    of the largest reuse in (K', M') order."""
    dm, dk, dn = lay.compute_gemm
    best: Optional[StratixDesign] = None
    l_min = max(1, math.ceil(lay.min_nprime / dn))

    def feasible(m: int, k: int, n: int) -> Optional[StratixGeometry]:
        geom = stratix_geometry(lay, m, k, n)
        return geom if geom.m20ks <= device.bram_36k else None

    def last_feasible(mprime: int, kprime: int) -> int:
        """The largest l with N' = l * dn feasible (l_min is)."""
        lo, step = l_min, 1
        while feasible(mprime, kprime, (lo + step) * dn) is not None:
            lo, step = lo + step, 2 * step
        hi = lo + step          # infeasible
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if feasible(mprime, kprime, mid * dn) is not None:
                lo = mid
            else:
                hi = mid
        return lo

    j = 1
    while feasible(dm, j * dk, l_min * dn) is not None:
        kprime = j * dk
        i = 1
        while feasible(i * dm, kprime, l_min * dn) is not None:
            mprime = i * dm
            nprime = last_feasible(mprime, kprime) * dn
            reuse = mprime * kprime * nprime
            if best is None or reuse > best.reuse:
                best = StratixDesign(lay, mprime, kprime, nprime,
                                     feasible(mprime, kprime, nprime),
                                     reuse)
            i += 1
        j += 1
    if best is None:
        raise ValueError(f"no feasible native buffer for layout {lay}")
    return best


def stratix_check_design(lay: TBLayout, native: Tuple[int, int, int],
                         device: FPGADevice = STRATIX_NX2100
                         ) -> StratixGeometry:
    """Validate a (paper) native-buffer choice against eq. 15-16 and return
    its geometry (used to reproduce the Table IV M20K column).

    Note: two published rows (18x16x3x4 and 18x8x3x8) have native dims that
    are *not* multiples of the compute GEMM size; the paper zero-pads
    partial tiles (SS V-C2), so non-multiples are accepted here.
    """
    mprime, kprime, nprime = native
    if nprime < lay.min_nprime:
        raise ValueError(f"N'={nprime} < eq.16 minimum {lay.min_nprime}")
    geom = stratix_geometry(lay, mprime, kprime, nprime)
    if geom.m20ks > device.bram_36k:
        raise ValueError(f"{geom.m20ks} M20Ks exceed {device.bram_36k}")
    return geom


def stratix_dse(device: FPGADevice = STRATIX_NX2100,
                freq_model_hz: float = 340e6) -> List[StratixDesign]:
    """Enumerate TB layouts (TBlen a factor of 36, SS IV-B3a) that use most
    of the device's TBs, IP-solve each for its native buffer, and rank by
    modeled throughput (at a nominal frequency) then reuse."""
    designs: List[StratixDesign] = []
    for tb_len in (36, 18, 12, 9):
        for kp in (4, 8, 16):
            for np_ in range(2, 12):
                for mp in range(2, 12):
                    lay = TBLayout(tb_len, kp, np_, mp)
                    if not 0.75 * device.compute_units <= lay.tbs \
                            <= device.compute_units:
                        continue
                    try:
                        designs.append(stratix_ip_solve(lay, device))
                    except ValueError:
                        continue
    designs.sort(key=lambda d: (-d.throughput_ops(freq_model_hz), -d.reuse))
    return designs
