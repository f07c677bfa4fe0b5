"""The attention operator API: ``AttnSpec`` -> ``attn_plan`` ->
``attn_execute`` (port of ``repro/kernels/attn_api.py``, its planner
half).

* :class:`AttnSpec` — a frozen, hashable description of the attention
  asked for: ``prefill`` (q rows over dense k / v), ``decode`` (one
  token a slot over a dense cache and per-slot positions) or
  ``decode_paged`` (one token a slot over the shared page pool and
  per-slot page tables); the mask (causal, window), the GQA ratio, the
  operand dtypes.  Invalid requests fail at construction, with the JAX
  package's messages and keys.
* :func:`attn_plan` — resolves a spec at concrete shapes once (cached on
  spec, shapes and the device): the kernel family, its blocks, its
  on-chip footprint and the modeled traffic.  Every prefill plans kernel
  B3 (``flash_attention``, at every sq: the TPU's sq >= 128 gate came
  from its (8, 128) tiling), decode B4 (``flash_decode``) and paged
  decode B5 (``flash_decode_paged``).  The blocks are launch-time shapes
  the kernels compile (:func:`_block_candidates`): B3's bf16 body 16-128
  (q position, q head) rows a CTA by 64- or 128-key ring stages, B4's 1,
  2 or 4 64-key splits a CTA; the f32 bodies and B5 one shape each.  No
  shape changes a bit of any output row, so the search may give two
  shapes of one prompt different blocks.  An explicit compiled block is
  honoured, one that is not compiled raises ``ValueError``; otherwise a
  plan takes the family's default, or with measured tuning on
  (``AttnSpec(tune=True)``, ``repro_torch.tune.enable()`` or
  ``REPRO_AUTOTUNE``) the winner of :func:`repro_torch.tune.
  attn_lookup_or_search` (persistent cache, then a top-K sweep on the
  card), degrading to the default with a ``fallback_reason``, never
  raising.  The footprint is what a CTA allocates, checked against
  ``HOPPER_H100``'s 227 KiB.  :meth:`AttnPlan.explain` names the kernel
  and its source, says that its plain version runs for CPU tensors, and
  prints the modeled costs and, when tuned, the measured time.
* :func:`attn_execute` — runs a plan on live operands, which must match
  it.  With grad mode on, every mode runs inside ONE autograd Function
  (:class:`_AttnCore`, the reference's single ``custom_vjp``): forward
  on the planned kernel, backward recomputing through the
  differentiable reference composition (the kernels are forward-only,
  as the Pallas ones are).  With grad mode off it dispatches directly.

The one-shots :func:`attention`, :func:`decode_attention` and
:func:`decode_attention_paged` are what the model layers call: the first
call with an operand signature plans and checks through
:func:`attn_execute`; a repeat resolves its plan with one tuple key and
one dict lookup, as ``kernels/api.py``'s one-shot ``gemm`` does.  A plan
is device-scoped (its ``dispatch`` is the device, ``"cpu"`` or
``"cuda:<card>"``); the kernel it names runs on CUDA tensors, its plain
version on CPU tensors.  With :mod:`repro_torch.telemetry` on,
``attn_plan()`` emits one ``attn.plan`` event a call and execution one
``attn.execute`` event a plan and recorder.

Given the ``TPU_V5E`` sheet, :class:`AttnProblem` and
:func:`attn_traffic` reproduce the JAX package's numbers, XLA families
included, so the tests can hold the cost model to it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device, telemetry
from repro_torch.core import bandwidth
from repro_torch.core.hardware import HOPPER_H100, HopperChip
from repro_torch.core.tiling import cdiv, dtype_bytes, dtype_name
from repro_torch.kernels.api import TunedInfo
from repro_torch.kernels.blocked_attention import (BLOCKED_ATTN_THRESHOLD,
                                                   attention_blocked)
from repro_torch.kernels.flash_attention import (DECODE_SPLIT,
                                                 F32_KEY_BLOCK, F32_ROWS,
                                                 KEY_BLOCK, MAX_HEAD_DIM,
                                                 b3_blocks,
                                                 cta_shape, decode_blocks,
                                                 decode_grid,
                                                 flash_attention)
from repro_torch.kernels.flash_decode import (MAX_GROUP, flash_decode,
                                              flash_decode_paged)
from repro_torch.kernels.ref import attention_ref, decode_attention_xla
from repro_torch.tune import autotune as _autotune
from repro_torch.tune import measure as _tune_measure
from repro_torch.tune.cache import device_mode

_MODES = ("prefill", "decode", "decode_paged")

_FLOAT_DTYPES = ("float32", "bfloat16", "float16")

#: the kernel each mode plans on the card
_FAMILY = {"prefill": "flash_attention", "decode": "flash_decode",
           "decode_paged": "flash_decode_paged"}

#: what each kernel is, for explain(): (kernel, source, plain version)
KERNELS = {
    "flash_attention": ("B3 flash_attention",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "flash_attention_plain"),
    "flash_decode": ("B4 flash_decode",
                     "src/repro_torch/csrc/flash_decode.cu + decode_split.cuh",
                     "flash_decode_plain"),
    "flash_decode_paged": ("B5 flash_decode_paged",
                           "src/repro_torch/csrc/flash_decode_paged.cu + "
                           "decode_split.cuh",
                           "flash_decode_paged_plain"),
}

#: the families whose blocks the measured search chooses (B5's block is
#: the page, as in the JAX package)
TUNABLE_KERNELS = ("flash_attention", "flash_decode")


# ---------------------------------------------------------------------------
# AttnSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """What attention is asked for (shapes excluded: they arrive at
    :func:`attn_plan` time, so one spec serves every shape).

    * ``mode`` — ``prefill``, ``decode`` or ``decode_paged``.
    * ``causal`` / ``window`` — the mask.  Decode is causal; a sliding
      window is a causal look-back, so ``causal=False`` with
      ``window > 0`` is rejected.
    * ``group`` — the GQA ratio ``hq // hkv``.
    * ``q_dtype`` / ``kv_dtype`` — operand dtypes (strings or torch
      dtypes; stored as names), floating.  ``kv_quant`` is the int8-KV
      hook and raises until a quantized cache lands.
    * ``bq`` / ``bkv`` — block overrides, validated as the JAX package
      does (rejected for ``decode_paged``); a plan honours one the
      kernel compiles (B3: ``bq`` (q position, q head) rows a CTA and
      ``bkv`` keys a ring stage; B4: ``bkv`` keys a CTA) and raises
      ``ValueError`` for one it does not.
    * ``tune`` — measured tuning for this spec (None: the process switch,
      then ``REPRO_AUTOTUNE``; the three-level rule of ``GemmSpec.tune``).
      Not part of :attr:`key`, as in the JAX package.
    """

    mode: str = "prefill"
    causal: bool = True
    window: int = 0
    group: int = 1
    q_dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"
    kv_quant: bool = False
    bq: Optional[int] = None
    bkv: Optional[int] = None
    tune: Optional[bool] = None

    def __post_init__(self):
        object.__setattr__(self, "q_dtype", dtype_name(self.q_dtype))
        object.__setattr__(self, "kv_dtype", dtype_name(self.kv_dtype))
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.group < 1:
            raise ValueError(f"group (GQA ratio) must be >= 1, "
                             f"got {self.group}")
        if self.mode != "prefill" and not self.causal:
            raise ValueError(f"{self.mode} attention is inherently "
                             "causal; causal=False is a prefill-only "
                             "(cross-attention) shape")
        if not self.causal and self.window:
            raise ValueError("a sliding window is a causal look-back "
                             "construct; window > 0 requires causal=True")
        for name, dt in (("q_dtype", self.q_dtype),
                         ("kv_dtype", self.kv_dtype)):
            if dt not in _FLOAT_DTYPES:
                raise ValueError(f"{name} must be floating "
                                 f"({_FLOAT_DTYPES}), got {dt!r}")
        if self.kv_quant:
            raise ValueError(
                "kv_quant is the forward-compat hook for the int8 KV "
                "cache (ROADMAP item) — not implemented yet")
        if self.mode == "decode_paged" and (self.bq or self.bkv):
            raise ValueError("decode_paged has no free blocks: the kv "
                             "block is the page size")
        if self.bq is not None and (self.bq < 8 or self.bq % 8):
            raise ValueError(f"bq must be a positive multiple of 8, "
                             f"got {self.bq}")
        if self.bkv is not None and (self.bkv < 128 or self.bkv % 128):
            raise ValueError(f"bkv must be a positive multiple of 128, "
                             f"got {self.bkv}")

    @property
    def key(self) -> str:
        """Canonical string id, the JAX package's: ``attn|`` then mode,
        mask, group, dtypes and any block override."""
        parts = [self.mode, "causal" if self.causal else "full"]
        if self.window:
            parts.append(f"w{self.window}")
        if self.group != 1:
            parts.append(f"g{self.group}")
        parts.append(f"{self.q_dtype}x{self.kv_dtype}")
        if self.kv_quant:
            parts.append("kvq")
        s = ":".join(parts)
        if self.bq is not None or self.bkv is not None:
            s += f"!{self.bq or 0}x{self.bkv or 0}"
        return "attn|" + s

    @classmethod
    def for_operands(cls, q, k, *, mode: str = "prefill",
                     causal: bool = True, window: int = 0,
                     **kw) -> "AttnSpec":
        """Spec inferred from live operands: GQA ratio and dtypes from
        the tensors, mask and mode from the keywords."""
        hq = q.shape[-2]
        hkv = k.shape[-2]
        if hkv == 0 or hq % hkv:
            raise ValueError(f"hq ({hq}) must be a multiple of "
                             f"hkv ({hkv})")
        return cls(mode=mode, causal=causal, window=window,
                   group=hq // hkv, q_dtype=q.dtype, kv_dtype=k.dtype, **kw)


# ---------------------------------------------------------------------------
# AttnProblem — the cost model's view
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnProblem:
    """One attention problem at concrete shapes: true-position flops and
    the q / kv / o device-memory streams.  ``skv`` is the dense kv length
    (for ``decode_paged`` the table's ``max_pages * page_size``);
    ``page_size`` is 0 unless paged."""

    mode: str
    b: int
    sq: int
    skv: int
    hq: int
    hkv: int
    d: int
    q_dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"
    causal: bool = True
    window: int = 0
    page_size: int = 0

    def _row_extent(self, i: int) -> Tuple[int, int]:
        """[lo, hi) kv positions query row ``i`` attends (the rows sit at
        the end of the kv sequence, ``q_offset = skv - sq``)."""
        if not self.causal:
            return 0, self.skv
        hi = min(self.skv, self.skv - self.sq + i + 1)
        lo = max(0, hi - self.window) if self.window > 0 else 0
        return lo, max(hi, 0)

    def attended(self) -> int:
        """True attended kv positions summed over every (batch, q row);
        paged decode rounds up to whole pages, decode bills a full
        (window-clamped) cache."""
        if self.mode == "prefill":
            per_batch = sum(hi - lo for lo, hi in
                            (self._row_extent(i) for i in range(self.sq)))
            return self.b * per_batch
        hi = self.skv
        if self.page_size > 0:
            return self.b * cdiv(hi, self.page_size) * self.page_size
        if self.window > 0:
            return self.b * min(hi, self.window)
        return self.b * hi

    @property
    def flops(self) -> float:
        """QK^T + PV: 2 GEMMs of (rows x attended x d) per head."""
        return 4.0 * self.hq * self.d * float(self.attended())

    @property
    def q_bytes(self) -> int:
        return self.b * self.sq * self.hq * self.d * dtype_bytes(self.q_dtype)

    @property
    def o_bytes(self) -> int:
        return self.q_bytes                 # output written at q dtype

    def decode_positions(self) -> list:
        """The worst-case per-slot positions a static plan bills at (a
        full cache)."""
        return [self.skv - 1] * self.b

    def kv_bytes(self, bq: Optional[int] = None) -> int:
        """Modeled device-memory bytes of the k + v streams: decode one
        pass over the live cache (:func:`bandwidth.decode_kv_bytes`);
        prefill, with ``bq``, each query head's q blocks of ``bq`` rows
        re-reading their attended kv extent, without it one pass."""
        if self.mode != "prefill":
            return int(bandwidth.decode_kv_bytes(
                self.decode_positions(), n_kv_heads=self.hkv,
                head_dim=self.d, dtype=self.kv_dtype, window=self.window,
                page_size=self.page_size or None))
        per_tok = 2 * self.d * dtype_bytes(self.kv_dtype)   # k + v
        if bq is None:
            return self.b * self.hkv * self.skv * per_tok
        return self.b * self.hq * self._extents(bq, 1) * per_tok

    def _extents(self, rows: int, group: int) -> int:
        """Kv positions read, summed over tiles of ``rows`` flattened
        (q position, q head) rows with ``group`` heads a position."""
        toks = 0
        for r0 in range(0, self.sq * group, rows):
            lo_i, hi_i = r0 // group, min(self.sq, cdiv(r0 + rows, group))
            lo = min(self._row_extent(i)[0] for i in range(lo_i, hi_i))
            hi = max(self._row_extent(i)[1] for i in range(lo_i, hi_i))
            toks += max(0, hi - lo)
        return toks

    def logits_bytes(self) -> int:
        """The (b, hq, rows, skv) f32 score round trip an unblocked
        reference materializes."""
        return 2 * self.b * self.hq * self.sq * self.skv * 4


def _b3_kv_bytes(p: AttnProblem, bq: Optional[int] = None) -> int:
    """K / V bytes B3 reads on the card: the bf16 body stages its kv
    head's blocks once for each CTA of ``bq`` (q position, q head) rows
    of the GQA group (None: the default, 64, or 32 at head 256); the f32
    body once for each 16 positions of one q head."""
    per_tok = 2 * p.d * dtype_bytes(p.kv_dtype)
    if p.q_dtype != "bfloat16":
        return p.kv_bytes(F32_ROWS)
    rows = bq if bq is not None else b3_blocks(p.d)[0][0]
    return p.b * p.hkv * p._extents(rows, p.hq // p.hkv) * per_tok


def attn_traffic(p: AttnProblem, kernel: str,
                 bq: Optional[int], bkv: Optional[int],
                 chip=HOPPER_H100) -> bandwidth.TrafficEstimate:
    """Roofline estimate for one (kernel family, blocks) choice, on the
    GEMM estimator's rates (:func:`bandwidth.effective_rates`, an f32
    problem at the sheet's f32 rate).  On a Hopper sheet B3 bills the
    staging its CTAs of ``bq`` rows do (:func:`_b3_kv_bytes`); B4's
    bytes do not depend on its ``bkv``; on the TPU sheet every family
    bills as the JAX package does."""
    hbm = float(p.q_bytes + p.o_bytes)
    if kernel == "flash_attention" and isinstance(chip, HopperChip):
        hbm += _b3_kv_bytes(p, bq)
    elif kernel in ("flash_attention", "attention_blocked"):
        hbm += p.kv_bytes(bq or p.sq)
    elif kernel == "xla_ref":
        hbm += p.kv_bytes(None) + p.logits_bytes()
    elif kernel == "xla_decode":
        hbm += p.kv_bytes() + p.logits_bytes()
    elif kernel == "xla_decode_paged":
        hbm += 3 * p.kv_bytes() + p.logits_bytes()
    else:                                   # the flash decode families
        hbm += p.kv_bytes()
    flops = p.flops
    peak, bw = bandwidth.effective_rates(chip, int8=False,
                                         f32=p.q_dtype == "float32")
    return bandwidth.TrafficEstimate(
        hbm_bytes=hbm, flops=flops, t_compute=flops / peak,
        t_memory=hbm / bw, arithmetic_intensity=flops / hbm if hbm else 0.0)


# ---------------------------------------------------------------------------
# The kernels' footprint on the card
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnFootprint:
    """What one launch of the planned kernel allocates: a CTA's shared
    memory, the CTAs (and merge CTAs) it launches, and the f32 partials
    the wrapper allocates in device memory (the bf16 decode bodies)."""

    smem_bytes: int
    ctas: int
    merge_ctas: int
    scratch_bytes: int
    design: str


def attn_footprint(p: AttnProblem, kernel: str, bq: Optional[int] = None,
                   bkv: Optional[int] = None) -> AttnFootprint:
    """The CTA shape and grid the kernel launches for this problem at
    blocks ``bq`` / ``bkv`` (None: the default;
    ``flash_attention.cta_shape`` / ``decode_grid``), with the shared
    memory each compiled shape allocates, as the JAX package's
    ``attn_vmem_footprint(p, kernel, bq, bkv)`` bills each block."""
    dt = getattr(torch, p.q_dtype)
    if kernel == "flash_attention":
        s = cta_shape(p.b, p.sq, p.hq, p.hkv, p.d, dt, bq, bkv)
        if s.body == "fmaf":
            how = (f"fmaf, {s.rows} positions of one q head a CTA, "
                   f"{F32_KEY_BLOCK}-key blocks")
        else:
            how = (f"tensor cores, {s.rows} (q position, q head) rows of "
                   f"one kv head's group a CTA, ring stages of "
                   f"{bkv or KEY_BLOCK} keys, {KEY_BLOCK}-key blocks from "
                   "key 0")
        return AttnFootprint(s.smem_bytes, s.ctas, 0, 0,
                             f"{how}; {s.tiles} q tiles x {p.hkv} kv heads"
                             f" x {p.b} batch rows = {s.ctas} CTAs, head "
                             f"padded to {s.head_dim}")
    g = decode_grid(p.b, p.hq, p.hkv, p.skv, p.d, dt,
                    bkv if kernel == "flash_decode" else None)
    if g.body == "fmaf":
        smem = cta_shape(1, 1, 1, 1, p.d, dt).smem_bytes
        return AttnFootprint(smem, g.ctas, 0, 0,
                             f"fmaf, one CTA per (kv head, slot) = {g.ctas}"
                             f" CTAs walking {F32_KEY_BLOCK}-key blocks")
    # csrc/decode_split.cuh: each warp's K and V tiles of kSplit x kD
    # bf16 and its split's row offsets
    smem = g.per_cta * (2 * DECODE_SPLIT * g.head_dim * 2 + DECODE_SPLIT * 8)
    where = "the page table" if kernel == "flash_decode_paged" \
        else "the dense cache"
    return AttnFootprint(
        smem, g.ctas, g.merge_ctas, 4 * (g.acc_floats + g.ml_floats),
        f"tensor cores, {DECODE_SPLIT}-key splits from key 0 ({g.per_cta} "
        f"a CTA, a warp each) over {where}: {g.splits} splits x {p.hkv} kv "
        f"heads x {p.b} slots in {g.ctas} CTAs (a warp with no key its "
        f"slot sees returns at once), then {g.merge_ctas} merge CTAs in "
        f"ascending split order; head padded to {g.head_dim}")


def _fits(fp: AttnFootprint, chip=HOPPER_H100) -> bool:
    return fp.smem_bytes <= chip.vmem_bytes


# ---------------------------------------------------------------------------
# Kernel family and blocks
# ---------------------------------------------------------------------------

class AttnBlockDesign(NamedTuple):
    """One (blocks, modeled cost) candidate."""

    bq: Optional[int]
    bkv: Optional[int]
    traffic: bandwidth.TrafficEstimate
    footprint: AttnFootprint


def _choose_kernel(spec: AttnSpec, p: AttnProblem
                   ) -> Tuple[str, Optional[str]]:
    """(kernel family, fallback_reason).  Every mode has its kernel at
    every shape the kernels take; a head or GQA group past their tiles
    is said loudly, since the kernel raises on CUDA tensors there."""
    kernel = _FAMILY[spec.mode]
    if p.d > MAX_HEAD_DIM:
        return kernel, (f"head_dim {p.d} > {MAX_HEAD_DIM}: "
                        f"{KERNELS[kernel][0]} raises on CUDA tensors; "
                        "only its plain version (CPU) runs this shape")
    if spec.mode != "prefill" and p.hq // p.hkv > MAX_GROUP:
        return kernel, (f"GQA group {p.hq // p.hkv} > {MAX_GROUP}: "
                        f"{KERNELS[kernel][0]} raises on CUDA tensors; "
                        "only its plain version (CPU) runs this shape")
    return kernel, None


def _block_candidates(kernel: str, p: AttnProblem
                      ) -> Tuple[Tuple[Optional[int], Optional[int]], ...]:
    """Each family's compiled (bq, bkv) shapes, the default first: B3's
    rows a CTA by keys a ring stage (``flash_attention.b3_blocks``), B4's
    keys a CTA (``decode_blocks``), B5's page (no free block).  A head
    past the kernels' tiles is billed at the widest."""
    dt = getattr(torch, p.q_dtype)
    d = min(p.d, MAX_HEAD_DIM)
    if kernel == "flash_attention":
        return b3_blocks(d, dt)
    if kernel == "flash_decode":
        return tuple((None, b) for b in decode_blocks(d, dt))
    return ((None, None),)


def attn_solve_topk(spec: AttnSpec, shapes: Tuple[int, ...],
                    k: int = 5) -> Tuple[AttnBlockDesign, ...]:
    """The ranked block candidates the measured search sweeps, all
    fitting a CTA's shared memory: the family's compiled default first,
    then the other compiled shapes by modeled time (stable).  The
    default leads because the card measured it fastest at the shapes it
    was chosen on (PERF.md §6) for reasons the byte model cannot see
    (CTAs against 132 SMs, warps a CTA staging a block), which would
    rank the widest CTA first wherever bytes bind; so the default is
    also what an untuned plan runs."""
    p = _problem_for(spec, shapes)
    kernel, _ = _choose_kernel(spec, p)
    designs = []
    for bq, bkv in _block_candidates(kernel, p):
        fp = attn_footprint(p, kernel, bq, bkv)
        if _fits(fp):
            designs.append(AttnBlockDesign(
                bq, bkv, attn_traffic(p, kernel, bq, bkv), fp))
    designs[1:] = sorted(designs[1:], key=lambda d: d.traffic.t_model)
    return tuple(designs[:max(int(k), 1)])


# ---------------------------------------------------------------------------
# AttnPlan and the plan cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """One resolved attention decision: spec x shapes x device -> the
    kernel, its blocks, its footprint and the modeled costs."""

    spec: AttnSpec
    b: int
    sq: int
    skv: int
    hq: int
    hkv: int
    d: int
    page_size: int                   # 0 unless decode_paged
    max_pages: int                   # 0 unless decode_paged
    dispatch: str                    # the device: "cpu" or "cuda:<card>"
    kernel: str
    bq: Optional[int]
    bkv: Optional[int]
    problem: AttnProblem
    traffic: bandwidth.TrafficEstimate
    footprint: AttnFootprint
    fallback_reason: Optional[str] = None
    tuned: Optional[TunedInfo] = None

    @property
    def flops(self) -> float:
        return self.traffic.flops

    @property
    def hbm_bytes(self) -> float:
        return self.traffic.hbm_bytes

    @property
    def vmem_bytes(self) -> int:
        """A CTA's shared memory (the reference's on-chip field)."""
        return self.footprint.smem_bytes

    @property
    def source(self) -> str:
        """How the blocks were chosen: ``'tuned'`` (the measured winner)
        or ``'analytic'`` (an explicit block, or the family's default)."""
        return "tuned" if self.tuned is not None else "analytic"

    @property
    def shape_key(self) -> str:
        if self.spec.mode == "decode_paged":
            return (f"b{self.b}xp{self.max_pages}x{self.page_size}x"
                    f"h{self.hq}/{self.hkv}xd{self.d}")
        if self.spec.mode == "decode":
            return (f"b{self.b}xS{self.skv}x"
                    f"h{self.hq}/{self.hkv}xd{self.d}")
        return (f"b{self.b}x{self.sq}x{self.skv}x"
                f"h{self.hq}/{self.hkv}xd{self.d}")

    @property
    def launches(self) -> dict:
        """Wrapper launches one execution counts, by launch counter."""
        return {self.kernel: 1}

    def explain(self) -> str:
        """Human-readable decision record: the kernel and its source, the
        plain version that runs for CPU tensors, the launch-time design,
        the footprint, the modeled traffic and, when tuned, the measured
        winner."""
        t, fp, p = self.traffic, self.footprint, self.problem
        mib, kib = 2 ** 20, 1024
        name, src, plain = KERNELS[self.kernel]
        lines = [
            f"AttnPlan {self.spec.key} {self.shape_key} [{self.dispatch}]",
            f"  kernel   : {name} ({src}) on CUDA tensors; its plain "
            f"version ({plain}) on CPU tensors",
            f"  design   : {fp.design}",
            f"  blocks   : bq={self.bq or '-'} bkv={self.bkv or '-'}"
            + (f" page={self.page_size}" if self.page_size else "")
            + _shapes_note(len(_block_candidates(self.kernel, p))),
            f"  on-chip  : {fp.smem_bytes / kib:.1f} KiB shared memory a "
            f"CTA of {HOPPER_H100.vmem_bytes / kib:.0f} KiB on "
            f"{HOPPER_H100.name}"
            + (f"; f32 partials {fp.scratch_bytes / mib:.2f} MiB in device "
               "memory" if fp.scratch_bytes else ""),
        ]
        kv = t.hbm_bytes - p.q_bytes - p.o_bytes
        pos_note = (" (page-rounded)" if self.page_size
                    else " (true positions)"
                    if self.spec.mode != "prefill" else "")
        lines.append(
            f"  hbm      : {t.hbm_bytes / mib:.2f} MiB "
            f"(q {p.q_bytes / mib:.2f}, kv {kv / mib:.2f}{pos_note}, "
            f"o {p.o_bytes / mib:.2f})")
        lines.append(
            f"  roofline : {t.bound}-bound, {t.t_model * 1e6:.1f} us "
            f"modeled on {HOPPER_H100.name} (AI "
            f"{t.arithmetic_intensity:.1f} flop/B, {t.flops / 1e9:.2f} "
            "GFLOP); not a measurement")
        if self.tuned is not None:
            tu = self.tuned
            how = "cache" if tu.from_cache else f"K={tu.k_searched} sweep"
            lines.append(
                f"  source   : tuned ({tu.t_measured_us:.1f} us measured"
                f" ±{tu.spread:.2f}, {how})")
            if tu.t_analytic_us is not None and tu.analytic_tile != \
                    _autotune._blocks_str(self.bq, self.bkv):
                lines.append(f"             analytic first choice "
                             f"{tu.analytic_tile} measured "
                             f"{tu.t_analytic_us:.1f} us")
        else:
            lines.append("  source   : analytic")
        if self.fallback_reason:
            lines.append(f"  fallback : {self.fallback_reason}")
        return "\n".join(lines)


def _shapes_note(n: int) -> str:
    return (f" (one of {n} compiled shapes, all giving the same bits)"
            if n > 1 else " (the one compiled shape)")


class AttnPlanCacheInfo(NamedTuple):
    entries: int
    hits: int
    misses: int


_plan_cache: dict = {}
_oneshot: dict = {}         # a one-shot's operand key -> plan
_plan_hits = 0
_plan_misses = 0


def attn_plan_cache_info() -> AttnPlanCacheInfo:
    """(entries, hits, misses); a one-shot call that reuses a plan counts
    as a hit."""
    return AttnPlanCacheInfo(len(_plan_cache), _plan_hits, _plan_misses)


def attn_plan_cache_clear() -> None:
    """Drop every cached attention plan and zero the counters."""
    global _plan_hits, _plan_misses
    _plan_cache.clear()
    _oneshot.clear()
    _plan_hits = 0
    _plan_misses = 0


def attn_plans() -> Tuple[AttnPlan, ...]:
    """Every attention plan resolved so far, in insertion order."""
    return tuple(_plan_cache.values())


def _plan_event(pl: AttnPlan, cache: str) -> None:
    telemetry.counter(f"attn.plan_cache.{cache}").add(1)
    tuned = pl.tuned
    t_model_us = pl.traffic.t_model * 1e6
    telemetry.event(
        "attn.plan", cache=cache, spec=pl.spec.key, shape=pl.shape_key,
        dispatch=pl.dispatch, kernel=pl.kernel,
        bq=pl.bq, bkv=pl.bkv, page_size=pl.page_size or None,
        hbm_bytes=pl.hbm_bytes, vmem_bytes=pl.vmem_bytes,
        flops=pl.flops, t_model_us=t_model_us,
        bound=pl.traffic.bound, source=pl.source,
        t_measured_us=tuned.t_measured_us if tuned else None,
        measured_vs_model=(tuned.t_measured_us / t_model_us
                           if tuned and t_model_us else None),
        fallback_reason=pl.fallback_reason)


def _shape_fields(spec: AttnSpec, shapes: Tuple[int, ...]) -> dict:
    """Validated (b, sq, skv, hq, hkv, d, page_size, max_pages) from the
    per-mode shape tuple:

    * prefill:      ``(b, sq, skv, hq, hkv, d)``
    * decode:       ``(b, skv, hq, hkv, d)``
    * decode_paged: ``(b, max_pages, page_size, hq, hkv, d)``
    """
    want = {"prefill": 6, "decode": 5, "decode_paged": 6}[spec.mode]
    if len(shapes) != want:
        raise ValueError(
            f"{spec.mode} shapes must be {want} ints "
            f"(got {len(shapes)}: {shapes})")
    s = tuple(int(x) for x in shapes)
    if any(x <= 0 for x in s):
        raise ValueError(f"shapes must be positive, got {s}")
    if spec.mode == "prefill":
        b, sq, skv, hq, hkv, d = s
        page_size = max_pages = 0
    elif spec.mode == "decode":
        b, skv, hq, hkv, d = s
        sq = 1
        page_size = max_pages = 0
    else:
        b, max_pages, page_size, hq, hkv, d = s
        sq = 1
        skv = max_pages * page_size
    if hq != hkv * spec.group:
        raise ValueError(
            f"hq ({hq}) != hkv ({hkv}) * spec.group ({spec.group})")
    return dict(b=b, sq=sq, skv=skv, hq=hq, hkv=hkv, d=d,
                page_size=page_size, max_pages=max_pages)


def _problem_for(spec: AttnSpec, shapes: Tuple[int, ...]) -> AttnProblem:
    f = _shape_fields(spec, shapes)
    return AttnProblem(
        mode=spec.mode, b=f["b"], sq=f["sq"], skv=f["skv"],
        hq=f["hq"], hkv=f["hkv"], d=f["d"], q_dtype=spec.q_dtype,
        kv_dtype=spec.kv_dtype, causal=spec.causal, window=spec.window,
        page_size=f["page_size"])


def _tune_enabled(spec: AttnSpec) -> bool:
    """The three-level rule: the spec's ``tune``, then the process
    switch, then ``REPRO_AUTOTUNE``."""
    return _autotune.is_enabled(spec.tune)


def _resolve(spec: AttnSpec, shapes: Tuple[int, ...],
             dispatch: str) -> AttnPlan:
    f = _shape_fields(spec, shapes)
    p = _problem_for(spec, shapes)
    kernel, fallback = _choose_kernel(spec, p)
    cands = _block_candidates(kernel, p)
    tuned = None
    if spec.bq is not None or spec.bkv is not None:
        # an explicit block: honoured if compiled, else refused
        bq = spec.bq if spec.bq is not None else cands[0][0]
        bkv = spec.bkv if spec.bkv is not None else cands[0][1]
        if (bq, bkv) not in cands:
            raise ValueError(
                f"explicit blocks bq={bq} bkv={bkv}: {KERNELS[kernel][0]} "
                f"does not compile them for head_dim {p.d} in "
                f"{p.q_dtype}; compiled (bq, bkv): {list(cands)}")
    else:
        # the default, which attn_solve_topk ranks first
        bq, bkv = cands[0]
        if kernel in TUNABLE_KERNELS and _tune_enabled(spec):
            # measured tuning: the persistent cache first, then a top-K
            # sweep; every degradation keeps the default, never raising
            from repro_torch import tune as _tune
            found = _tune.attn_lookup_or_search(spec, shapes, p)
            if found is not None:
                (tq, tkv), tuned = found
                if (tq, tkv) in cands and _fits(
                        attn_footprint(p, kernel, tq, tkv)):
                    bq, bkv = tq, tkv
                else:
                    fallback = ((fallback + "; ") if fallback else "") + (
                        f"tuned blocks bq={tq} bkv={tkv} infeasible here; "
                        "re-resolved analytically")
                    tuned = None
    fp = attn_footprint(p, kernel, bq, bkv)
    if not _fits(fp):
        fallback = ((fallback + "; ") if fallback else "") + (
            f"{fp.smem_bytes} bytes of shared memory a CTA exceed "
            f"{HOPPER_H100.name}'s {HOPPER_H100.vmem_bytes}")
    return AttnPlan(
        spec=spec, b=f["b"], sq=f["sq"], skv=f["skv"], hq=f["hq"],
        hkv=f["hkv"], d=f["d"], page_size=f["page_size"],
        max_pages=f["max_pages"], dispatch=dispatch, kernel=kernel,
        bq=bq, bkv=bkv, problem=p,
        traffic=attn_traffic(p, kernel, bq, bkv), footprint=fp,
        fallback_reason=fallback, tuned=tuned)


def attn_plan(spec: AttnSpec, shapes: Tuple[int, ...],
              device=None) -> AttnPlan:
    """Resolve (and cache) the decision for ``spec`` at the per-mode
    ``shapes`` tuple (:func:`_shape_fields`) for operands on ``device``
    (default: the CUDA card; pass ``"cpu"`` for the plain versions'
    plans).  The cache key holds the device: its plan names the same
    kernel, but dispatches its plain version."""
    global _plan_hits, _plan_misses
    dispatch = device_mode(resolve_device(device))
    key = (spec, tuple(int(x) for x in shapes), dispatch)
    hit = _plan_cache.get(key)
    if hit is not None:
        _plan_hits += 1
        if telemetry.enabled():
            _plan_event(hit, "hit")
        return hit
    _plan_misses += 1
    resolved = _resolve(spec, shapes, dispatch)
    _plan_cache[key] = resolved
    if telemetry.enabled():
        _plan_event(resolved, "miss")
    return resolved


# ---------------------------------------------------------------------------
# attn_execute — one autograd Function for the whole family
# ---------------------------------------------------------------------------

def _launch(pl: AttnPlan, scale, q_offset, q, k, v, pos, page_table):
    """The kernel fan-out, driven by the plan: B3, B4 or B5 (each
    wrapper runs its plain version for CPU tensors)."""
    spec = pl.spec
    kern = pl.kernel
    if kern == "flash_attention":
        return flash_attention(q, k, v, causal=spec.causal,
                               window=spec.window, scale=scale,
                               q_offset=q_offset, bq=pl.bq, bkv=pl.bkv)
    if kern == "flash_decode":
        return flash_decode(q, k, v, pos, window=spec.window, bkv=pl.bkv)
    return flash_decode_paged(q, k, v, page_table, pos, window=spec.window)


def _decode_attention_paged_xla(q, k_pages, v_pages, page_table, pos, *,
                                window):
    """The reference's paged decode composition: each row's pages
    gathered into a dense view, then the storage-dtype decode."""
    _, ps, hkv, d = k_pages.shape
    b, max_pages = page_table.shape
    idx = page_table.long()
    k = k_pages[idx].reshape(b, max_pages * ps, hkv, d)
    v = v_pages[idx].reshape(b, max_pages * ps, hkv, d)
    return decode_attention_xla(q, k, v, pos, window=window)


def _reference(pl: AttnPlan, scale, q_offset, pos, page_table):
    """The differentiable composition the backward recomputes through
    (``repro/kernels/attn_api.py:863-896``): prefill the plain reference
    (blocked past ``BLOCKED_ATTN_THRESHOLD`` positions, so no
    (b, hq, sq, skv) scores), decode the storage-dtype einsums, paged
    decode the same over the gathered pages."""
    spec = pl.spec
    if spec.mode == "prefill":
        fwd = attention_blocked if max(pl.sq, pl.skv) \
            > BLOCKED_ATTN_THRESHOLD else attention_ref
        return lambda q, k, v: fwd(q, k, v, causal=spec.causal,
                                   window=spec.window, scale=scale,
                                   q_offset=q_offset)
    if spec.mode == "decode":
        return lambda q, k, v: decode_attention_xla(q, k, v, pos,
                                                    window=spec.window)
    return lambda q, k, v: _decode_attention_paged_xla(
        q, k, v, page_table, pos, window=spec.window)


class _AttnCore(torch.autograd.Function):
    """The whole attention family behind one autograd Function: forward
    on the plan's kernel (its plain version on the CPU), backward by
    recomputing through :func:`_reference` and pulling the cotangent
    through it.  ``pos`` / ``page_table`` ride as integer operands with
    no gradient."""

    @staticmethod
    def forward(ctx, pl, scale, q_offset, q, k, v, pos, page_table):
        ctx.fwd = _reference(pl, scale, q_offset, pos, page_table)
        ctx.save_for_backward(q, k, v)
        return _launch(pl, scale, q_offset, q, k, v, pos, page_table)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            dq, dk, dv = torch.autograd.grad(ctx.fwd(*qkv), qkv, g)
        return None, None, None, dq, dk, dv, None, None


def _run(pl: AttnPlan, scale, q_offset, q, k, v, pos, page_table):
    """Inside :class:`_AttnCore` with grad mode on, else straight to the
    kernel (serving runs under ``inference_mode``)."""
    if torch.is_grad_enabled():
        return _AttnCore.apply(pl, scale, q_offset, q, k, v, pos,
                               page_table)
    return _launch(pl, scale, q_offset, q, k, v, pos, page_table)


def _execute_event(pl: AttnPlan) -> None:
    """One ``attn.execute`` event a plan and recorder (the plan carries
    the recorder it reported to, as ``gemm.execute``'s plans do)."""
    rec = telemetry.recorder()
    if pl.__dict__.get("_reported") is rec or _tune_measure.measuring():
        return                          # a tuner's sample is no execution
    object.__setattr__(pl, "_reported", rec)
    telemetry.event("attn.execute", spec=pl.spec.key, shape=pl.shape_key,
                    dispatch=pl.dispatch, kernel=pl.kernel, bq=pl.bq,
                    bkv=pl.bkv, hbm_bytes=pl.hbm_bytes, flops=pl.flops)


def attn_execute(pl: AttnPlan, q, k, v, *, pos=None, page_table=None,
                 scale: Optional[float] = None,
                 q_offset: Optional[int] = None):
    """Run a resolved plan on live operands.

    * prefill: ``attn_execute(pl, q, k, v[, scale=, q_offset=])`` with
      q (b, sq, hq, d) and k / v (b, skv, hkv, d);
    * decode: ``attn_execute(pl, q, k_cache, v_cache, pos=pos)`` with
      q (b, hq, d), caches (b, S, hkv, d), pos (b,) int32;
    * decode_paged: ``attn_execute(pl, q, k_pages, v_pages,
      page_table=tbl, pos=pos)`` with pools (n_pages, page_size, hkv, d)
      and tables (b, max_pages) int32.

    Operands that disagree with the plan's spec, shapes or device raise.
    """
    spec = pl.spec
    if spec.mode == "prefill":
        want_q = (pl.b, pl.sq, pl.hq, pl.d)
        want_kv = (pl.b, pl.skv, pl.hkv, pl.d)
        if pos is not None or page_table is not None:
            raise ValueError("pos/page_table are decode-only operands")
    elif spec.mode == "decode":
        want_q = (pl.b, pl.hq, pl.d)
        want_kv = (pl.b, pl.skv, pl.hkv, pl.d)
        if pos is None:
            raise ValueError("decode plans require pos=")
        if page_table is not None:
            raise ValueError("page_table is a decode_paged operand")
    else:
        want_q = (pl.b, pl.hq, pl.d)
        want_kv = (None, pl.page_size, pl.hkv, pl.d)
        if pos is None or page_table is None:
            raise ValueError("decode_paged plans require pos= and "
                             "page_table=")
        if tuple(page_table.shape) != (pl.b, pl.max_pages):
            raise ValueError(
                f"page_table shape {tuple(page_table.shape)} != plan's "
                f"({pl.b}, {pl.max_pages})")
    if tuple(q.shape) != want_q:
        raise ValueError(f"q shape {tuple(q.shape)} != plan's {want_q}")
    for name, op in (("k", k), ("v", v)):
        got = tuple(op.shape)
        if got[1:] != want_kv[1:] or (want_kv[0] is not None
                                      and got[0] != want_kv[0]):
            raise ValueError(
                f"{name} shape {got} != plan's {want_kv}")
    if dtype_name(q.dtype) != spec.q_dtype:
        raise ValueError(f"q dtype {q.dtype} != spec q_dtype "
                         f"{spec.q_dtype}")
    if dtype_name(k.dtype) != spec.kv_dtype:
        raise ValueError(f"k dtype {k.dtype} != spec kv_dtype "
                         f"{spec.kv_dtype}")
    if spec.mode != "prefill" and (scale is not None
                                   or q_offset is not None):
        raise ValueError("scale/q_offset are prefill-only statics; "
                         "decode uses d**-0.5 at position pos")
    if device_mode(q.device) != pl.dispatch:
        raise ValueError(f"operands on {q.device}, plan resolved for "
                         f"{pl.dispatch}")
    if telemetry.enabled():
        _execute_event(pl)
    return _run(pl, scale, q_offset, q, k, v, pos, page_table)


# ---------------------------------------------------------------------------
# One-shots: what every model layer calls
# ---------------------------------------------------------------------------

def _repeat(pl: AttnPlan) -> None:
    """A one-shot repeat's bookkeeping: the hit, and the execute event
    when telemetry is on."""
    global _plan_hits
    _plan_hits += 1
    if telemetry.enabled():
        _execute_event(pl)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None,
              q_offset: Optional[int] = None,
              bq: Optional[int] = None,
              bkv: Optional[int] = None,
              tune: Optional[bool] = None) -> torch.Tensor:
    """Planned multi-head attention with GQA and an optional sliding
    window.  q: (b, sq, hq, d); k / v: (b, skv, hkv, d) -> (b, sq, hq,
    d).  ``tune`` is the spec's (``ops.attention(q, k, v, tune=True)``
    searches the blocks as in the JAX package)."""
    key = ("prefill", q.shape, k.shape, q.dtype, k.dtype, q.device, causal,
           window, bq, bkv, tune)
    pl = _oneshot.get(key)
    if pl is None:
        b, sq, hq, d = q.shape
        _, skv, hkv, _ = k.shape
        spec = AttnSpec.for_operands(q, k, mode="prefill", causal=causal,
                                     window=window, bq=bq, bkv=bkv,
                                     tune=tune)
        pl = attn_plan(spec, (b, sq, skv, hq, hkv, d), device=q.device)
        out = attn_execute(pl, q, k, v, scale=scale, q_offset=q_offset)
        _oneshot[key] = pl
        return out
    _repeat(pl)
    return _run(pl, scale, q_offset, q, k, v, None, None)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *, window: int = 0,
                     bkv: Optional[int] = None,
                     tune: Optional[bool] = None) -> torch.Tensor:
    """Planned single-token attention over a dense KV cache.
    q: (b, hq, d); caches: (b, S, hkv, d); pos: (b,) int32 (a scalar
    broadcasts) -> (b, hq, d).  ``tune`` is the spec's."""
    key = ("decode", q.shape, k_cache.shape, q.dtype, k_cache.dtype,
           q.device, window, bkv, tune)
    pl = _oneshot.get(key)
    if pl is None:
        b, hq, d = q.shape
        _, skv, hkv, _ = k_cache.shape
        spec = AttnSpec.for_operands(q, k_cache, mode="decode",
                                     window=window, bkv=bkv, tune=tune)
        pl = attn_plan(spec, (b, skv, hq, hkv, d), device=q.device)
        out = attn_execute(pl, q, k_cache, v_cache, pos=pos)
        _oneshot[key] = pl
        return out
    _repeat(pl)
    return _run(pl, None, None, q, k_cache, v_cache, pos, None)


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos, *, window: int = 0) -> torch.Tensor:
    """Planned single-token attention over the block-paged KV pool.
    q: (b, hq, d); pools: (n_pages, page_size, hkv, d); page_table:
    (b, max_pages) int32; pos: (b,) int32 -> (b, hq, d)."""
    key = ("decode_paged", q.shape, k_pages.shape[1:], page_table.shape,
           q.dtype, k_pages.dtype, q.device, window)
    pl = _oneshot.get(key)
    if pl is None:
        b, hq, d = q.shape
        _, page_size, hkv, _ = k_pages.shape
        spec = AttnSpec.for_operands(q, k_pages, mode="decode_paged",
                                     window=window)
        pl = attn_plan(spec, (b, page_table.shape[1], page_size, hq, hkv,
                              d), device=q.device)
        out = attn_execute(pl, q, k_pages, v_pages, page_table=page_table,
                           pos=pos)
        _oneshot[key] = pl
        return out
    _repeat(pl)
    return _run(pl, None, None, q, k_pages, v_pages, pos, page_table)
