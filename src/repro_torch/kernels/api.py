"""The GEMM operator API: ``GemmSpec`` -> ``plan`` -> ``execute`` (port of
``repro/kernels/api.py``, dense family).

* :class:`GemmSpec` — a frozen, hashable description of the GEMM family
  member asked for: per-operand dtypes, an optional fused
  :class:`~repro_torch.kernels.epilogue.Epilogue`, an optional gated
  second B operand (``act(A W_g) * (A W_u)``), and strategy / tile /
  out-dtype overrides.  Invalid requests fail at construction.
* :func:`plan` — resolves a spec for concrete ``(m, k, n)`` once (cached
  on the spec+shape key): the tiling search (:mod:`repro_torch.core.dse`)
  on the ``HOPPER_H100`` sheet picks the dataflow and tile, an explicit
  tile is checked and raises when infeasible, and the modeled traffic,
  on-chip footprint and flops ride on the :class:`GemmPlan`, whose
  ``explain()`` says which kernel runs and why.
* :func:`execute` — runs a plan: a gated plan launches kernel B2
  (``gemm_gated``), a grouped plan kernel B7 (``gemm_grouped``) and a
  ``tb`` plan kernel B6 (``gemm_tb``) with the plan's tile, anything
  else kernel B1 (``gemm_aie``); B1, B2 and B7 launch the CTA tile they
  pick themselves.  The kernels mask ragged edges, so
  nothing is padded.  :func:`gemm` is the one-shot form every model
  layer calls, :func:`gemm_grouped` the MoE experts'.

Quantized weights arrive as ``{"q": int8, "scale": f32}`` structs
(:mod:`repro_torch.quant`): the plan bills q at one byte an element plus
its scale vector, and the kernels run their int8 paths (W8A16: the int8
weights widened to bf16 on chip, the scale on the flush).  Under
``quant.activation_mode() == "w8a8"`` a quantized, non-gated plan with a
linear epilogue re-routes, as the JAX package's ``execute`` does: the
activations are quantized per row, an int8 x int8 plan runs with int32
accumulation and an f32 output, and the row scale, bias and residual
apply outside.  An int8 output (``out_scale``) quantizes on the flush.

The plan is the same on every device: a CPU tensor runs the chosen
kernel's plain version, a CUDA tensor the kernel itself.  With grad mode
on, a dense GEMM runs inside one ``torch.autograd.Function``
(:class:`_GemmCore`, the JAX package's ``_gemm_core`` custom VJP): its
forward launches the planned kernel, its backward is the unfused
composition of planned plain GEMMs (:func:`_plain`), so the gradient
reaches the weights through the same kernels on every device.  A grouped
GEMM runs inside :class:`_GroupedCore` (``_grouped_core``): dA and the
activation's pre-activation recompute are planned grouped GEMMs (B7 on a
card), dB the per-expert outer product in plain f32.  With grad mode off
both dispatch directly.

Measured tuning (``GemmSpec(tune=True)``, ``repro_torch.tune.enable()``
or ``REPRO_AUTOTUNE``): ``plan()`` asks :mod:`repro_torch.tune` first —
the persistent tuning cache, then a top-K sweep timed on the card — and
falls back to the analytic winner, never raising; the plan's ``tuned``
record and ``explain()``'s ``source`` line say which.  Grouped specs and
the backward's GEMMs stay analytic.  With :mod:`repro_torch.telemetry`
on, ``plan()`` emits one ``gemm.plan`` event a call and execution one
``gemm.execute`` event per (spec, m, k, n).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import quant as _quant
from repro_torch import telemetry
from repro_torch.tune import autotune as _autotune
from repro_torch.tune import measure as _tune_measure
from repro_torch.tune.cache import device_mode
from repro_torch.core import dse
from repro_torch.core.bandwidth import TrafficEstimate, estimate
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.core.memory_model import VmemFootprint, budget_bytes, \
    fits_vmem, vmem_efficiency, vmem_footprint
from repro_torch.core.tiling import STRATEGIES, GemmProblem, TileConfig, \
    cdiv, dtype_name, grouped_instances, round_up
from repro_torch.kernels.epilogue import ACTIVATIONS, Epilogue
from repro_torch.kernels.gemm_aie import cta_tile as _aie_cta
from repro_torch.kernels.gemm_aie import gemm_aie
from repro_torch.kernels.gemm_gated import cta_tile as _gated_cta
from repro_torch.kernels.gemm_gated import gemm_gated
from repro_torch.kernels.gemm_grouped import cta_tile as _grouped_cta
from repro_torch.kernels.gemm_grouped import gemm_grouped as _gemm_grouped
from repro_torch.kernels.gemm_tb import feasible_bk, gemm_tb


def _is_quant(b) -> bool:
    return isinstance(b, dict) and {"q", "scale"} <= set(b)


# ---------------------------------------------------------------------------
# GemmSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """What GEMM-family member is asked for (shapes excluded: they
    arrive at :func:`plan` time, so one spec serves every shape).

    * ``a_dtype`` / ``b_dtype`` — per-operand dtypes (strings or torch
      dtypes; stored as ``"bfloat16"``-style names).
    * ``gated`` — dual-B kernel ``act(A B_gate) * (A B_up)``; requires an
      epilogue activation, rejects bias / residual / out-quant and 'tb'.
    * ``epilogue`` — bias / activation / residual fused into the flush
      (an :class:`Epilogue` or its key string).
    * ``strategy`` / ``tile`` — overrides for the search; an explicit
      tile is honoured after a feasibility check and raises at plan time
      when infeasible.
    * ``grouped`` — the ragged MoE member: A is (m, k) tokens sorted by
      expert, B an (E, k, n) bank; plans take ``(m, k, n, E[,
      dense_rows])``; 'aie' only, single-B, bias + activation only.
    * ``b_quant`` — B arrives as a ``{"q", "scale"}`` int8 struct
      (``b_dtype`` is forced to int8); an int8 ``a_dtype`` is the W8A8
      member (int8 x int8, int32 accumulation), which only a non-gated,
      non-grouped spec takes.
    * ``out_dtype`` — ``None`` resolves to ``a_dtype`` (int8 when the
      epilogue quantizes the output).
    * ``tune`` — measured tuning for this spec: ``True`` / ``False``
      win over the process switch and ``REPRO_AUTOTUNE``
      (:func:`repro_torch.tune.autotune.is_enabled`), ``None`` defers to
      them.
    """

    a_dtype: str = "bfloat16"
    b_dtype: str = "bfloat16"
    b_quant: bool = False
    gated: bool = False
    grouped: bool = False
    epilogue: Epilogue = Epilogue()
    out_dtype: Optional[str] = None
    strategy: Optional[str] = None
    tile: Optional[TileConfig] = None
    tune: Optional[bool] = None

    def __post_init__(self):
        object.__setattr__(self, "a_dtype", dtype_name(self.a_dtype))
        if self.b_quant:
            object.__setattr__(self, "b_dtype", "int8")
        else:
            object.__setattr__(self, "b_dtype", dtype_name(self.b_dtype))
        if self.out_dtype is not None:
            object.__setattr__(self, "out_dtype",
                               dtype_name(self.out_dtype))
        if isinstance(self.epilogue, str):
            object.__setattr__(self, "epilogue",
                               Epilogue.parse(self.epilogue))
        if self.strategy is not None and self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}: choose from "
                f"{STRATEGIES} (or None for the DSE to search both)")
        if self.tile is not None and not isinstance(self.tile, TileConfig):
            raise ValueError(f"tile must be a TileConfig, got {self.tile!r}")
        tb = self.strategy == "tb" or (self.tile is not None
                                       and self.tile.strategy == "tb")
        if self.gated:
            if self.epilogue.activation is None:
                raise ValueError(
                    "gated GEMM requires an epilogue activation: choose "
                    f"from {tuple(ACTIVATIONS)}")
            if self.epilogue.bias or self.epilogue.residual \
                    or self.epilogue.out_quant:
                raise ValueError(
                    "gated GEMM fuses only the gate activation; bias / "
                    "residual / out-quant epilogue terms are unsupported "
                    f"(got {self.epilogue.key!r})")
            if tb:
                raise ValueError(
                    "the gated dual-B kernel is output-stationary "
                    "('aie') only; strategy/tile 'tb' is infeasible")
        if self.grouped:
            if self.gated:
                raise ValueError("grouped GEMM is single-B; it cannot "
                                 "be gated")
            if self.epilogue.residual or self.epilogue.out_quant:
                raise ValueError(
                    "grouped GEMM fuses only a per-expert bias + "
                    "activation; residual / out-quant epilogue terms "
                    f"are unsupported (got {self.epilogue.key!r})")
            if tb:
                raise ValueError(
                    "the grouped ragged kernel is output-stationary "
                    "('aie') only; strategy/tile 'tb' is infeasible")
        if self.a_dtype == "int8" and (self.gated or self.grouped):
            raise ValueError(
                "the gated and grouped kernels take float activations: "
                "W8A8 runs non-gated, non-grouped GEMMs only")
        if self.a_dtype == "int8" and self.b_dtype != "int8":
            raise ValueError("an int8 A needs an int8 B (W8A8)")

    @property
    def key(self) -> str:
        """Compact canonical string (as ``repro.kernels.api.GemmSpec``)."""
        s = f"{self.a_dtype}x{self.b_dtype}"
        if self.b_quant:
            s += "{q}"
        if self.gated:
            s += ":gated"
        if self.grouped:
            s += ":grouped"
        if self.epilogue.key:
            s += f":{self.epilogue.key}"
        if self.out_dtype:
            s += f"->{self.out_dtype}"
        if self.strategy:
            s += f"!{self.strategy}"
        if self.tile is not None:
            s += f"!{self.tile.bm}x{self.tile.bk}x{self.tile.bn}"
        return s

    @classmethod
    def for_operands(cls, a, b, b2=None, *, bias=None,
                     activation: Optional[str] = None, residual=None,
                     out_scale=None, strategy: Optional[str] = None,
                     tile: Optional[TileConfig] = None, out_dtype=None,
                     tune: Optional[bool] = None) -> "GemmSpec":
        """Spec inferred from concrete operands (tensors or ``{"q",
        "scale"}`` weight structs) plus the optional epilogue set — what
        the one-shot :func:`gemm` builds."""
        bq = _is_quant(b)
        if b2 is not None and _is_quant(b2) != bq:
            raise ValueError("quantize both gated operands or neither")
        gated = b2 is not None
        if gated:
            if bias is not None or residual is not None \
                    or out_scale is not None:
                raise ValueError("gated GEMM takes no bias/residual/"
                                 "out_scale epilogue operands")
            ep = Epilogue(activation=activation)
        else:
            ep = Epilogue.from_args(bias, activation, residual, out_scale)
        return cls(a_dtype=dtype_name(a.dtype),
                   b_dtype="int8" if bq else dtype_name(b.dtype),
                   b_quant=bq, gated=gated, epilogue=ep,
                   out_dtype=None if out_dtype is None
                   else dtype_name(out_dtype),
                   strategy=strategy, tile=tile, tune=tune)


def gemm_shapes(a, b) -> Tuple[int, int, int]:
    """The planned ``(m, k, n)``: leading dims of ``a`` flatten into M."""
    k = a.shape[-1]
    n = (b["q"] if _is_quant(b) else b).shape[-1]
    return (math.prod(a.shape[:-1]), k, n)


def gemm_grouped_shapes(a, b, dense_rows: Optional[int] = None
                        ) -> Tuple[int, int, int, int, int]:
    """The planned ``(m, k, n, E, dense_rows)`` of a grouped spec: ``a``
    is the (m, k) group-sorted token buffer (m = true routed rows), ``b``
    the (E, k, n) expert bank.  ``dense_rows`` is what the dense
    capacity-padded formulation would multiply (E * capacity); it rides
    the plan so ``explain()`` can state the padding flops saved, and
    defaults to ``m``."""
    e, k, n = (b["q"] if _is_quant(b) else b).shape
    m = math.prod(a.shape[:-1])
    return (m, k, n, e, int(dense_rows) if dense_rows else m)


# ---------------------------------------------------------------------------
# GemmPlan and the plan cache
# ---------------------------------------------------------------------------

#: what each kernel is, for explain(): (kernel, source, the (bm, bk, bn)
#: CTA tile it launches whatever the plan's tile says — B1's and B2's by
#: (m, n) and the operand dtypes, B7's by rows per expert — or None when
#: it runs the plan's)
_KERNELS = {
    "aie": ("B1 gemm_aie", "src/repro_torch/csrc/gemm_aie.cu",
            lambda pl, a, b: _aie_cta(pl.m, pl.n, a, b)),
    "gated": ("B2 gemm_gated", "src/repro_torch/csrc/gemm_gated.cu",
              lambda pl, a, b: _gated_cta(pl.m, pl.n, a, b)),
    "tb": ("B6 gemm_tb", "src/repro_torch/csrc/gemm_tb.cu", None),
    "grouped": ("B7 gemm_grouped", "src/repro_torch/csrc/gemm_grouped.cu",
                lambda pl, a, b: _grouped_cta(pl.m, pl.n_groups, a, b)),
}


@dataclasses.dataclass(frozen=True)
class TunedInfo:
    """The measured-tuning record riding a tuned plan: the winner's
    measured time (median, with spread), the analytic first choice it
    was compared against, and whether the answer came from the
    persistent cache (zero re-measurement) or a fresh top-K sweep."""

    t_measured_us: float            # winner median wall clock
    spread: float                   # (max-min)/median of kept samples
    t_analytic_us: Optional[float]  # measured time of the search's rank-0
    analytic_tile: str              # e.g. "tb 128x512x32"
    k_searched: int
    from_cache: bool


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One resolved execution decision: spec x (m, k, n) on a sheet ->
    strategy, tile, and the modeled costs the search ranked it by.
    ``chunk_bk`` is the k-chunk a ``tb`` plan runs at (0 for ``aie``);
    a grouped plan carries its expert count ``n_groups`` and the
    ``dense_rows`` a capacity-padded formulation would multiply; a tuned
    plan its :class:`TunedInfo`."""

    spec: GemmSpec
    m: int
    k: int
    n: int
    problem: GemmProblem
    tile: TileConfig
    traffic: TrafficEstimate
    vmem: VmemFootprint
    chip: object = HOPPER_H100
    chunk_bk: int = 0
    fallback_reason: Optional[str] = None
    n_groups: int = 0
    dense_rows: int = 0
    tuned: Optional[TunedInfo] = None

    @property
    def source(self) -> str:
        """How the tile was chosen: ``'tuned'`` (the measured winner) or
        ``'analytic'`` (the cost-model search)."""
        return "tuned" if self.tuned is not None else "analytic"

    @property
    def hbm_bytes(self) -> float:
        return self.traffic.hbm_bytes

    @property
    def flops(self) -> float:
        """Executed (padded) flops at this tile."""
        return self.traffic.flops

    @property
    def vmem_bytes(self) -> int:
        return self.vmem.total

    def __post_init__(self):
        # what every execution reads, resolved once (the one-shot gemm's
        # repeat path touches nothing else of the plan)
        object.__setattr__(self, "_run", (
            "gated" if self.spec.gated else
            "grouped" if self.spec.grouped else self.tile.strategy,
            self.spec.epilogue.activation,
            getattr(torch, self.problem.out_dtype)))

    @property
    def out_dtype(self) -> torch.dtype:
        return self._run[2]

    @property
    def kernel(self) -> str:
        """``"gated"``, ``"grouped"``, ``"tb"`` or ``"aie"``: which
        kernel executes."""
        return self._run[0]

    @property
    def launches(self) -> dict:
        """Kernel launches one execution makes, by launch counter:
        ``gemm_aie`` / ``gemm_gated`` / ``gemm_grouped`` (one), or a
        ``tb`` plan's ``gemm_tb`` (B6a, one a k-chunk but the last) and
        ``gemm_tb_final`` (B6b, one)."""
        if self.kernel != "tb":
            return {f"gemm_{self.kernel}": 1}
        return {"gemm_tb": cdiv(self.k, self.chunk_bk) - 1,
                "gemm_tb_final": 1}

    def explain(self) -> str:
        """Human-readable decision record: the kernel that runs, its
        source, the tile, the modeled traffic / footprint / time, and why
        any fallback happened."""
        s, p, t = self.spec, self.problem, self.tile
        name, src, cta = _KERNELS[self.kernel]
        gm, gn, gk = t.grid(p)
        if self.kernel == "tb":
            chunks = cdiv(self.k, self.chunk_bk)
            how = (f"k in {chunks} chunk(s) of {self.chunk_bk}: "
                   f"{chunks - 1} B6a accumulate + 1 B6b final launch; "
                   "each CTA keeps a (bm x chunk) A panel in shared memory "
                   "and sweeps its share of the n tiles (the panel re-read "
                   "per CTA hits L2; the model bills A once)")
        else:
            cta = cta(self, getattr(torch, p.a_dtype),
                      getattr(torch, p.b_dtype))
            how = (f"launches its compiled {cta[0]}x{cta[1]}x{cta[2]} "
                   "(bm x bk x bn) CTA tile whatever the plan's tile says; "
                   "the tile below is the cost model's")
            if self.kernel == "grouped":
                how += ("; the CTA shape goes by rows per expert (decode: "
                        "at most one on average, else prefill), one CTA "
                        "per (m-tile instance, n tile) that can be live, "
                        "and the CTAs past the device-side live count "
                        "exit")
        b_desc = ("2x " if s.gated else "") + p.b_dtype \
            + (" {q,scale}" if s.b_quant else "")
        budget = budget_bytes(self.chip)
        tm = self.traffic
        lines = [
            f"GemmPlan {self.m}x{self.k}x{self.n}  A {p.a_dtype}  "
            f"B {b_desc}  -> {p.out_dtype} (acc {p.acc_dtype})",
            f"  kernel   : {name} ({src}) on CUDA tensors; its plain "
            "version on CPU tensors",
            f"             {how}",
            f"  tile     : {t.strategy} {t.bm}x{t.bk}x{t.bn}"
            f"{'  (user override)' if s.tile is not None else ''}  "
            f"grid (gm,gn,gk)=({gm},{gn},{gk})  "
            f"pad eff {t.tile_efficiency(p):.0%}",
            f"  on-chip  : {self.vmem.total / 1024:.1f} KiB of "
            f"{budget / 1024:.0f} KiB budget on {self.chip.name}  "
            f"(a {self.vmem.a_bytes / 1024:.1f} KiB, b "
            f"{self.vmem.b_bytes / 1024:.1f} KiB, c "
            f"{(self.vmem.out_bytes + self.vmem.acc_bytes) / 1024:.1f} KiB)"
            f"  eff {vmem_efficiency(t, p, self.chip):.0%}",
            f"  traffic  : {tm.hbm_bytes / 2**20:.3f} MiB modeled  "
            f"AI {tm.arithmetic_intensity:.0f} flop/B",
            f"  roofline : {tm.bound}-bound  t_model "
            f"{tm.t_model * 1e6:.2f} us modeled on {self.chip.name} "
            f"(t_comp {tm.t_compute * 1e6:.2f}, "
            f"t_mem {tm.t_memory * 1e6:.2f}); not a measurement",
            f"  epilogue : {s.epilogue.key or '(none)'}"
            + (f"  gated({s.epilogue.activation})" if s.gated else ""),
        ]
        if p.n_groups:
            inst = grouped_instances(t, p)
            dense_flops = 2.0 * self.dense_rows * p.k * p.n
            saved = 1.0 - self.flops / dense_flops if dense_flops else 0.0
            lines.insert(4, (
                f"  grouped  : E={p.n_groups} groups, <={inst} tile "
                f"instances  A/HBM billed at true rows "
                f"(m={self.m} of {self.dense_rows} dense-capacity), "
                f"B one {t.bk}x{t.bn} panel per instance"))
            lines.insert(5, (
                f"  padding  : {self.flops / 1e9:.2f} GFLOP executed vs "
                f"{dense_flops / 1e9:.2f} dense-capacity "
                f"({saved:+.0%} saved)"))
        int8 = _int8_path(self)
        if int8:
            lines.insert(3, f"  int8     : {int8}")
        if self.tuned is not None:
            ti = self.tuned
            t_model_us = tm.t_model * 1e6
            how = "cache" if ti.from_cache else \
                f"measured top-{ti.k_searched}"
            lines.append(
                f"  source   : tuned ({how})  {ti.t_measured_us:.1f} us "
                f"measured vs {t_model_us:.1f} us modeled "
                f"({ti.t_measured_us / t_model_us:.1f}x model, "
                f"spread {ti.spread:.0%})")
            if ti.t_analytic_us is not None and ti.analytic_tile != \
                    f"{t.strategy} {t.bm}x{t.bk}x{t.bn}":
                lines.append(
                    f"             analytic first choice "
                    f"{ti.analytic_tile} measured "
                    f"{ti.t_analytic_us:.1f} us")
        else:
            lines.append("  source   : analytic")
        if self.fallback_reason:
            lines.append(f"  fallback : {self.fallback_reason}")
        return "\n".join(lines)


def _int8_path(pl: GemmPlan) -> Optional[str]:
    """What the kernel's int8 path does with this plan, for explain()."""
    s, p = pl.spec, pl.problem
    parts = []
    if p.a_dtype == "int8":
        parts.append("W8A8: int8 A and B staged at one byte an element, "
                     "mma.sync m16n8k32 s8 with int32 accumulators (exact), "
                     "b_scale on the flush")
    elif p.b_dtype == "int8":
        parts.append("W8A16: int8 B staged at one byte an element, widened "
                     "to " + p.a_dtype + " on chip (exact), the "
                     + ("per-expert (E, 1, n)" if s.grouped else "(1, n)")
                     + " scale" + (" of each accumulator" if s.gated else "")
                     + " on the flush")
        if s.b_quant and not s.gated and not s.grouped \
                and not s.epilogue.activation and not s.epilogue.out_quant:
            parts.append("re-routed to W8A8 when quant.activation_mode() "
                         "is 'w8a8'")
    if s.epilogue.out_quant:
        parts.append("int8 C: divide by out_scale, round half to even, "
                     "clip to +-127 on the flush")
    return "; ".join(parts) or None


class PlanCacheInfo(NamedTuple):
    entries: int
    hits: int
    misses: int


_plan_cache: dict = {}
_oneshot: dict = {}             # gemm()'s and _plain()'s operand key -> plan
_plan_hits = 0
_plan_misses = 0


def plan_cache_info() -> PlanCacheInfo:
    """(entries, hits, misses) of the spec+shape plan cache; a one-shot
    :func:`gemm` call that reuses a plan counts as a hit."""
    return PlanCacheInfo(len(_plan_cache), _plan_hits, _plan_misses)


def plan_cache_clear() -> None:
    """Drop every cached plan and zero the hit/miss counters."""
    global _plan_hits, _plan_misses
    _plan_cache.clear()
    _oneshot.clear()
    _plan_hits = 0
    _plan_misses = 0


def plans() -> Tuple[GemmPlan, ...]:
    """Every plan resolved so far, in insertion order."""
    return tuple(_plan_cache.values())


def _clamp_tile(tile: TileConfig, m: int, k: int, n: int,
                chip=HOPPER_H100) -> TileConfig:
    bm = min(tile.bm, round_up(m, chip.sublanes))
    bk = min(tile.bk, round_up(k, chip.lane))
    bn = min(tile.bn, round_up(n, chip.lane))
    return TileConfig(bm, bk, bn, tile.strategy)


def _acc_name(a_dtype: str) -> str:
    return "int32" if a_dtype == "int8" else "float32"


def _infeasible_reason(tile: TileConfig, p: GemmProblem,
                       chip=HOPPER_H100) -> Optional[str]:
    """Why a tile cannot run, or None.  'tb' keeps a (bm, bk) A panel
    resident and refines its own k-chunking, so its gate is
    ``feasible_bk`` (and, on the card, a (bm, bn) tile kernel B6 can
    launch); 'aie' streams everything, so plain ``fits_vmem`` (and a
    grouped tile must be a C block one CTA of kernel B7 covers)."""
    if p.n_groups and not chip.grouped_launchable(tile.bm, tile.bn):
        return (f"a ({tile.bm}, {tile.bn}) C tile is larger than any CTA "
                "tile kernel B7 launches (bm <= 64, bn <= 128)")
    if tile.strategy == "tb":
        if not chip.launchable(tile.bm, tile.bn):
            return (f"a ({tile.bm}, {tile.bn}) C tile does not map onto "
                    "kernel B6's 256 threads (bn <= 256; bf16: at most 4 "
                    "m16 x n8 fragments a warp, f32: at most 16 rows a "
                    "thread)")
        if feasible_bk(round_up(p.m, tile.bm), round_up(p.k, tile.bk),
                           round_up(p.n, tile.bn), tile, p.a_dtype,
                           p.b_dtype, p.out_dtype, _acc_name(p.a_dtype),
                           epilogue=p.epilogue, chip=chip) > 0:
            return None
        return ("no k-chunk keeps the resident (bm, bn) blocks inside "
                "the on-chip budget (feasible_bk == 0)")
    if fits_vmem(tile, p, chip):
        return None
    return (f"on-chip footprint {vmem_footprint(tile, p, chip).total} "
            f"bytes exceeds the {budget_bytes(chip):.0f}-byte budget of "
            f"{chip.name}")


def _problem_for(spec: GemmSpec, m: int, k: int, n: int,
                 n_groups: int = 0) -> GemmProblem:
    """The cost-model problem a spec resolves to at concrete shapes."""
    out_dtype = spec.out_dtype or ("int8" if spec.epilogue.out_quant
                                   else spec.a_dtype)
    return GemmProblem(m, k, n, spec.a_dtype, out_dtype,
                       _acc_name(spec.a_dtype), spec.b_dtype,
                       spec.epilogue.key, 2 if spec.gated else 1,
                       n_groups if spec.grouped else 0)


def solve_topk(spec: GemmSpec, shapes: Tuple[int, int, int], k: int = 5,
               chip=HOPPER_H100) -> Tuple:
    """The ranked tile candidates for ``spec`` at ``shapes`` on ``chip``
    (:class:`repro_torch.core.dse.TileDesign` rows, best first,
    restricted to the spec's strategy when one is pinned)."""
    m, kk, n = (int(x) for x in shapes[:3])
    problem = _problem_for(spec, m, kk, n,
                           int(shapes[3]) if len(shapes) > 3 else 0)
    k = max(int(k), 1)
    designs = dse.solve(problem, chip, top=k)
    if spec.strategy is not None:
        designs = [d for d in designs if d.tile.strategy == spec.strategy]
    return tuple(designs[:k])


def _resolve(spec: GemmSpec, m: int, k: int, n: int, chip=HOPPER_H100,
             n_groups: int = 0, dense_rows: int = 0) -> GemmPlan:
    """Strategy + tile for ``spec`` at (m, k, n) (and ``n_groups``
    expert groups) on ``chip``: a checked explicit tile, else (tuning
    on, not grouped) the measured winner, else the search's winner,
    falling back to its best 'aie' design when a 'tb' winner fails the
    post-clamp check."""
    problem = _problem_for(spec, m, k, n, n_groups)
    fallback = None
    tuned = None
    tile = None
    if spec.tile is not None:
        tile = _clamp_tile(spec.tile, m, k, n, chip)
        err = _infeasible_reason(tile, problem, chip)
        if err:
            raise ValueError(
                f"explicit tile {tile.strategy} {tile.bm}x{tile.bk}x"
                f"{tile.bn} is infeasible for {problem}: {err}")
    elif _autotune.is_enabled(spec.tune) and not spec.grouped:
        # measured tuning: the persistent tuning cache first, then a
        # top-K sweep on the card; any degradation (over-budget problem,
        # malformed cache, measurement failure, a cached tile that no
        # longer fits) falls through to the analytic search below.
        # Grouped specs stay analytic: the harness builds dense operands
        # and would mis-time the ragged sweep.
        found = _autotune.lookup_or_search(spec, (m, k, n), problem)
        if found is not None:
            cand, tuned = found
            cand = _clamp_tile(cand, m, k, n, chip)
            err = _infeasible_reason(cand, problem, chip)
            if err:
                fallback = (f"tuned tile {cand.strategy} {cand.bm}x"
                            f"{cand.bk}x{cand.bn} infeasible here ({err}); "
                            "re-resolved analytically")
                tuned = None
            else:
                tile = cand
    if tile is None:
        designs = dse.solve(problem, chip)
        chosen = next((d for d in designs
                       if spec.strategy in (None, d.tile.strategy)), None)
        if chosen is None:
            raise ValueError(
                f"no feasible {spec.strategy!r} tiling for {problem}")
        tile = _clamp_tile(chosen.tile, m, k, n, chip)
        err = _infeasible_reason(tile, problem, chip)
        if err:
            aie = next((d for d in designs if d.tile.strategy == "aie"),
                       None)
            if aie is None:
                raise ValueError(f"no feasible tiling for {problem}: {err}")
            fallback = (f"tb tile {tile.bm}x{tile.bk}x{tile.bn} "
                        f"infeasible ({err}); fell back to the DSE's aie "
                        "winner")
            tile = _clamp_tile(aie.tile, m, k, n, chip)
    chunk = 0
    if tile.strategy == "tb":
        chunk = min(tile.bk, feasible_bk(
            m, k, n, tile, problem.a_dtype, problem.b_dtype,
            problem.out_dtype, problem.acc_dtype, problem.epilogue, chip))
    return GemmPlan(spec, m, k, n, problem, tile,
                    estimate(tile, problem, chip),
                    vmem_footprint(tile, problem, chip), chip, chunk,
                    fallback, n_groups, dense_rows, tuned)



def plan(spec: GemmSpec, shapes: Tuple[int, ...]) -> GemmPlan:
    """Resolve ``spec`` for concrete ``(m, k, n)`` on ``HOPPER_H100``,
    once per (spec, shape) key.  Grouped specs take the extended shapes
    ``(m, k, n, E[, dense_rows])`` (:func:`gemm_grouped_shapes`)."""
    global _plan_hits, _plan_misses
    shapes = tuple(int(x) for x in shapes)
    if spec.grouped:
        if len(shapes) not in (4, 5):
            raise ValueError(
                "a grouped spec plans with (m, k, n, E[, dense_rows]) "
                f"shapes — got {shapes}")
        m, k, n, e = shapes[:4]
        dense_rows = shapes[4] if len(shapes) == 5 else m
        if e < 1:
            raise ValueError(f"grouped spec needs E >= 1 groups, got {e}")
    else:
        if len(shapes) != 3:
            raise ValueError(
                f"a dense spec plans with (m, k, n) shapes — got {shapes}")
        m, k, n = shapes
        e, dense_rows = 0, 0
    key = (spec, m, k, n, e, dense_rows)
    cached = _plan_cache.get(key)
    if cached is not None:
        _plan_hits += 1
        if telemetry.enabled():
            _plan_event(cached, "hit")
        return cached
    _plan_misses += 1
    grouped = (HOPPER_H100, e, dense_rows) if spec.grouped else ()
    resolved = _resolve(spec, m, k, n, *grouped)
    _plan_cache[key] = resolved
    if telemetry.enabled():
        _plan_event(resolved, "miss")
    return resolved


def _plan_event(pl: GemmPlan, cache: str) -> None:
    """One telemetry event per plan() call: the decision record — spec
    key, strategy / tile, modeled device-memory and on-chip bytes,
    flops, roofline verdict, cache hit or miss, source and any fallback
    reason."""
    t = pl.tile
    telemetry.counter(f"gemm.plan_cache.{cache}").add(1)
    tuned = pl.tuned
    t_model_us = pl.traffic.t_model * 1e6
    telemetry.event(
        "gemm.plan", cache=cache, spec=pl.spec.key,
        m=pl.m, k=pl.k, n=pl.n, strategy=t.strategy,
        tile=f"{t.bm}x{t.bk}x{t.bn}", hbm_bytes=pl.hbm_bytes,
        vmem_bytes=pl.vmem_bytes, flops=pl.flops,
        t_model_us=t_model_us, bound=pl.traffic.bound,
        source=pl.source,
        t_measured_us=tuned.t_measured_us if tuned else None,
        measured_vs_model=(tuned.t_measured_us / t_model_us
                           if tuned and t_model_us else None),
        fallback_reason=pl.fallback_reason)


def _execute_event(pl: GemmPlan, a: torch.Tensor) -> None:
    """One ``gemm.execute`` event per plan, i.e. per (spec, m, k, n), and
    recorder (the JAX package emits it once per trace; eager callers
    would otherwise emit one a call, ~200 a decode step).  The plan
    carries the recorder it reported to, so a repeat costs one attribute
    read, not a hash of its spec.  ``mode`` is the device the operands
    live on (:func:`repro_torch.tune.device_mode`)."""
    rec = telemetry.recorder()
    if pl.__dict__.get("_reported") is rec or _tune_measure.measuring():
        return                          # a tuner's sample is no execution
    object.__setattr__(pl, "_reported", rec)
    spec = pl.spec
    telemetry.event(
        "gemm.execute", spec=spec.key, m=pl.m, k=pl.k, n=pl.n,
        strategy=pl.tile.strategy, mode=device_mode(a.device),
        kernel=pl.kernel, hbm_bytes=pl.hbm_bytes, flops=pl.flops)
    telemetry.counter("gemm.execute.first_traces").add(1)


# ---------------------------------------------------------------------------
# execute and the one-shot gemm
# ---------------------------------------------------------------------------

def _launch(pl: GemmPlan, a2, b, b2, bias, res2, group_sizes=None,
            b_scale=None, b2_scale=None, out_scale=None) -> torch.Tensor:
    """The one kernel fan-out, driven by the plan: B2 for a gated plan,
    B7 for a grouped one, B6 with the plan's tile for 'tb', else B1.
    Quantized weights arrive unpacked: q as ``b`` / ``b2``, their scales
    as ``b_scale`` / ``b2_scale``."""
    kind, act, out_dtype = pl._run
    if kind == "aie":
        return gemm_aie(a2, b, bias=bias, activation=act, residual=res2,
                        out_dtype=out_dtype, b_scale=b_scale,
                        out_scale=out_scale)
    if kind == "tb":
        return gemm_tb(a2, b, tile=pl.tile, out_dtype=out_dtype, bias=bias,
                       activation=act, residual=res2, b_scale=b_scale,
                       out_scale=out_scale)
    if kind == "grouped":
        return _gemm_grouped(a2, b, group_sizes, out_dtype=out_dtype,
                             b_scale=b_scale, bias=bias, activation=act)
    return gemm_gated(a2, b, b2, activation=act, out_dtype=out_dtype,
                      bg_scale=b_scale, bu_scale=b2_scale)


def _w8a8_plan(pl: GemmPlan) -> Optional[GemmPlan]:
    """The int8 x int8 plan a quantized plan re-routes to under W8A8, or
    None when it never does (gated, grouped, an activation or int8
    output in the epilogue, or an int8 A already): JAX's execute
    (repro/kernels/api.py:1106-1125).  Resolved once a plan."""
    sub = pl.__dict__.get("_w8a8")
    if sub is None:
        spec, ep = pl.spec, pl.spec.epilogue
        ok = (spec.b_quant and not spec.gated and not spec.grouped
              and ep.activation is None and not ep.out_quant
              and spec.a_dtype != "int8")
        sub = plan(dataclasses.replace(
            spec, a_dtype="int8", epilogue=Epilogue(), out_dtype="float32",
            tune=False), (pl.m, pl.k, pl.n)) if ok else False
        object.__setattr__(pl, "_w8a8", sub)
    return sub or None


def _dispatch(pl: GemmPlan, a2, b, b2, bias, res2, out_scale=None,
         group_sizes=None) -> torch.Tensor:
    """Launch a checked plan on (m, k) rows: plain weights go straight to
    :func:`_launch`; ``{"q", "scale"}`` structs are unpacked, and under
    W8A8 a plan that re-routes quantizes its rows (each row alone, so
    its bits do not depend on the batch), runs the int8 x int8 plan to
    f32 and applies the row scale, bias and residual outside."""
    if not pl.spec.b_quant:
        return _launch(pl, a2, b, b2, bias, res2, group_sizes,
                       out_scale=out_scale)
    q, scale = b["q"], b["scale"]
    sub = _w8a8_plan(pl)
    if sub is not None and _quant.activation_mode() == "w8a8":
        a_q, a_s = _quant.quantize_activations(a2, axis=-1)
        out = _launch(sub, a_q, q, None, None, None, b_scale=scale) * a_s
        if bias is not None:
            out = out + bias.reshape(1, -1).float()
        if res2 is not None:
            out = out + res2.float()
        return out.to(pl.out_dtype)
    return _launch(pl, a2, q, b2["q"] if b2 is not None else None, bias,
                   res2, group_sizes, b_scale=scale,
                   b2_scale=b2["scale"] if b2 is not None else None,
                   out_scale=out_scale)


# ---------------------------------------------------------------------------
# The ONE autograd Function of the dense GEMM family
# ---------------------------------------------------------------------------

def _act_bwd(activation: Optional[str], z: torch.Tensor, g: torch.Tensor
             ) -> torch.Tensor:
    """dL/dz given dL/d(act(z)) — the unfused-composition backward."""
    if activation is None:
        return g
    with torch.enable_grad():
        zz = z.detach().requires_grad_()
        return torch.autograd.grad(ACTIVATIONS[activation](zz), zz, g)[0]


def _plain(a: torch.Tensor, b: torch.Tensor, b_scale, out_dtype,
           strategy: Optional[str] = None) -> torch.Tensor:
    """A planned plain GEMM (no epilogue) — the recompute primitive the
    backward is composed from (``tune=False``, as in the JAX package).
    Its plan is looked up by operand signature, so a backward builds no
    spec after its first step; transposed operands arrive as views and
    the kernels' wrappers copy them contiguous."""
    m, k = a.shape
    n = b.shape[1]
    key = ("plain", a.dtype, b.dtype, b_scale is not None, out_dtype,
           strategy, m, k, n)
    pl = _oneshot.get(key)
    if pl is None:
        spec = GemmSpec(a_dtype=a.dtype, b_dtype=b.dtype,
                        b_quant=b_scale is not None, out_dtype=out_dtype,
                        strategy=strategy, tune=False)
        pl = _oneshot[key] = plan(spec, (m, k, n))
    bb = {"q": b, "scale": b_scale} if b_scale is not None else b
    return _run(pl, a, bb, None, None, None)


def _bwd_weight(q: torch.Tensor, b_scale, dtype) -> torch.Tensor:
    """The ONLY place a quantized weight is dequantized — the backward's
    rematerialization; the forward never pays 2-byte weight traffic."""
    if b_scale is None:
        return q
    return (q.float() * b_scale.reshape(1, -1).float()).to(dtype)


class _GemmCore(torch.autograd.Function):
    """epilogue(A @ B) (or the gated dual-B form), forward and backward
    both driven by the plan (``repro/kernels/api.py`` ``_gemm_core``).
    Absent operands are None; a quantized weight arrives as its int8 q
    and f32 (1, n) scale."""

    @staticmethod
    def forward(ctx, pl, a, b, b_scale, b2, b2_scale, bias, residual):
        ctx.pl = pl
        ctx.res_dtype = residual.dtype if residual is not None else None
        ctx.save_for_backward(a, b, b_scale, b2, b2_scale, bias)
        return _launch(pl, a, b, b2, bias, residual, b_scale=b_scale,
                       b2_scale=b2_scale)

    @staticmethod
    def backward(ctx, g):
        # Recompute the pre-activation z (one extra GEMM), then the
        # standard cotangents through the elementwise epilogue.  An int8
        # weight (q and its scale) gets no gradient; it is dequantized
        # only here, for dA.
        a, b, b_scale, b2, b2_scale, bias = ctx.saved_tensors
        need_a, need_b, _, need_b2, _, need_bias, need_res = \
            ctx.needs_input_grad[1:]
        spec = ctx.pl.spec
        act = spec.epilogue.activation
        strat = spec.strategy
        gf = g.float()
        dres = gf.to(ctx.res_dtype) if need_res else None
        float_b = b.dtype != torch.int8
        if spec.gated:
            zg = _plain(a, b, b_scale, torch.float32)
            zu = _plain(a, b2, b2_scale, torch.float32)
            dzu = gf * ACTIVATIONS[act](zg)
            dzg = _act_bwd(act, zg, gf * zu).to(a.dtype)
            dzu = dzu.to(a.dtype)
            da = dbg = dbu = None
            if need_a:
                wg = _bwd_weight(b, b_scale, a.dtype)
                wu = _bwd_weight(b2, b2_scale, a.dtype)
                da = (_plain(dzg, wg.T, None, a.dtype)
                      + _plain(dzu, wu.T, None, a.dtype)).to(a.dtype)
            if need_b and float_b:
                dbg = _plain(a.T, dzg, None, b.dtype).to(b.dtype)
            if need_b2 and float_b:
                dbu = _plain(a.T, dzu, None, b2.dtype).to(b2.dtype)
            return None, da, dbg, None, dbu, None, None, None
        if act is not None:
            z = _plain(a, b, b_scale, torch.float32, strat)
            if bias is not None:
                z = z + bias.reshape(1, -1).float()
            dz = _act_bwd(act, z, gf)
        else:
            dz = gf
        dbias = dz.sum(0).reshape(bias.shape).to(bias.dtype) \
            if need_bias else None
        da = db = None
        if need_a and a.dtype != torch.int8:
            w = _bwd_weight(b, b_scale, a.dtype)
            da = _plain(dz.to(a.dtype), w.T, None, a.dtype,
                        strat).to(a.dtype)
        if need_b and float_b and b_scale is None:
            db = _plain(a.T, dz.to(a.dtype), None, b.dtype,
                        strat).to(b.dtype)
        return None, da, db, None, None, None, dbias, dres


def _run(pl: GemmPlan, a2, b, b2, bias, res2, out_scale=None
         ) -> torch.Tensor:
    """Run a checked plan on (m, k) rows.  With grad mode on, through
    :class:`_GemmCore`; with it off (serving's ``inference_mode``) there
    is nothing to record and the plan dispatches directly, which the
    host-bound eager decode step feels: 47.5 ms median against 57.7
    through the Function (smollm-360m bf16, 8 slots, H100;
    ``tools/dispatch_probe.py``).  An int8
    output and the W8A8 re-route are forward-only, as in the JAX
    package (which dispatches the first outside its VJP and stops the
    gradient at the second's quantized rows)."""
    if out_scale is not None or not torch.is_grad_enabled() or (
            pl.spec.b_quant and _w8a8_plan(pl) is not None
            and _quant.activation_mode() == "w8a8"):
        return _dispatch(pl, a2, b, b2, bias, res2, out_scale)
    if pl.spec.b_quant:
        return _GemmCore.apply(pl, a2, b["q"], b["scale"],
                               b2["q"] if b2 is not None else None,
                               b2["scale"] if b2 is not None else None,
                               bias, res2)
    return _GemmCore.apply(pl, a2, b, None, b2, None, bias, res2)


# ---------------------------------------------------------------------------
# The grouped family's autograd Function (backward = grouped GEMMs with the
# transposed expert bank steered by the SAME group sizes)
# ---------------------------------------------------------------------------

def _group_rows(sizes: torch.Tensor, m: int):
    """Per-row group id (clamped) and liveness under ``sizes`` — the
    backward's reconstruction of the forward's steering tables."""
    ends = torch.cumsum(sizes.to(torch.int64), 0)
    rows = torch.arange(m, dtype=torch.int64, device=sizes.device)
    gid = torch.searchsorted(ends, rows, right=True)
    return torch.clamp(gid, max=sizes.shape[0] - 1), rows < ends[-1]


def _grouped_plain(a: torch.Tensor, b: torch.Tensor, b_scale, sizes,
                   out_dtype) -> torch.Tensor:
    """A planned plain grouped GEMM — the recompute/backward primitive
    (``tune=False`` like :func:`_plain`; dense_rows defaults to m, so
    internal plans claim no padding savings).  A transposed bank arrives
    as a view and B7's wrapper copies it contiguous."""
    m, k = a.shape
    e, _, n = b.shape
    key = ("grouped plain", a.dtype, b.dtype, b_scale is not None,
           out_dtype, m, k, n, e)
    pl = _oneshot.get(key)
    if pl is None:
        spec = GemmSpec(a_dtype=a.dtype, b_dtype=b.dtype,
                        b_quant=b_scale is not None, grouped=True,
                        out_dtype=out_dtype, tune=False)
        pl = _oneshot[key] = plan(spec, (m, k, n, e))
    return _launch(pl, a, b, None, None, None, sizes, b_scale=b_scale)


def _expert_rows(sizes: Tuple[int, ...]):
    """Each expert's slice of the group-sorted rows, from host sizes."""
    start = 0
    for size in sizes:
        yield slice(start, start + size)
        start += size


def _grouped_db(a: torch.Tensor, dz: torch.Tensor, sizes: Tuple[int, ...],
                dtype) -> torch.Tensor:
    """dB of a grouped GEMM: expert ``e``'s ``A[rows_e]^T dz[rows_e]`` in
    f32, rounded to ``dtype`` — the reference's one-hot
    ``einsum("re,rk,rn->ekn")`` contracted over each expert's own rows
    (``sizes`` read on the host), so no (r, e, k) tensor and no f32
    (E, k, n) bank is ever built."""
    db = torch.zeros((len(sizes), a.shape[1], dz.shape[1]), dtype=dtype,
                     device=a.device)
    for i, rows in enumerate(_expert_rows(sizes)):
        if rows.stop > rows.start:
            db[i] = a[rows].float().T @ dz[rows]
    return db


class _GroupedCore(torch.autograd.Function):
    """epilogue(A[r] @ B[g(r)]) over the ragged groups, forward and
    backward driven by the plan (``repro/kernels/api.py``
    ``_grouped_core``).  A quantized bank arrives as its int8 q and f32
    (E, 1, n) scale; ``group_sizes`` takes no gradient."""

    @staticmethod
    def forward(ctx, pl, a, b, b_scale, group_sizes, bias):
        ctx.pl = pl
        ctx.save_for_backward(a, b, b_scale, group_sizes, bias)
        return _launch(pl, a, b, None, bias, None, group_sizes,
                       b_scale=b_scale)

    @staticmethod
    def backward(ctx, g):
        # dA rows see only their own expert's panel, so dA is itself a
        # grouped GEMM against the transposed bank with the same sizes; dB
        # is the per-expert outer product.  An int8 bank (q and its
        # scale) gets no gradient; it is dequantized only here, for dA.
        a, b, b_scale, sizes, bias = ctx.saved_tensors
        _, need_a, need_b, _, _, need_bias = ctx.needs_input_grad
        act = ctx.pl.spec.epilogue.activation
        e = b.shape[0]
        gid, live = _group_rows(sizes, a.shape[0])
        gf = torch.where(live[:, None], g.float(), 0.0)
        if act is not None:
            z = _grouped_plain(a, b, b_scale, sizes, torch.float32)
            if bias is not None:
                z = z + bias.reshape(e, -1)[gid].float()
            dz = torch.where(live[:, None], _act_bwd(act, z, gf), 0.0)
        else:
            dz = gf
        need_b = need_b and b.dtype != torch.int8 and b_scale is None
        host = tuple(sizes.tolist()) if need_b or need_bias else None
        dbias = db = da = None
        if need_bias:
            dbias = torch.stack([dz[rows].sum(0) for rows in
                                 _expert_rows(host)]) \
                .reshape(bias.shape).to(bias.dtype)
        if need_a:
            w = b if b_scale is None else \
                (b.float() * b_scale.reshape(e, 1, -1).float()).to(a.dtype)
            da = _grouped_plain(dz.to(a.dtype), w.transpose(1, 2), None,
                                sizes, a.dtype).to(a.dtype)
        if need_b:
            db = _grouped_db(a, dz, host, b.dtype)
        return None, da, db, None, None, dbias


def _run_grouped(pl: GemmPlan, a2, b, bias, group_sizes) -> torch.Tensor:
    """Run a checked grouped plan: through :class:`_GroupedCore` with grad
    mode on, directly with it off (serving), as :func:`_run` does."""
    if not torch.is_grad_enabled():
        return _dispatch(pl, a2, b, None, bias, None,
                         group_sizes=group_sizes)
    if pl.spec.b_quant:
        return _GroupedCore.apply(pl, a2, b["q"], b["scale"], group_sizes,
                                  bias)
    return _GroupedCore.apply(pl, a2, b, None, group_sizes, bias)


def execute(pl: GemmPlan, a: torch.Tensor, b, *, b2=None,
            bias: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None,
            out_scale=None, group_sizes=None) -> torch.Tensor:
    """Run a resolved plan on concrete operands.

    ``a``: (..., k) — leading dims flatten into the planned M; ``b`` /
    ``b2``: (k, n) tensors, or ``{"q", "scale"}`` structs (q int8 (k, n),
    scale f32 (1, n)) when the spec says ``b_quant``.  Epilogue operands
    must match the spec (a plan for a bias epilogue requires ``bias=``,
    and vice versa; an out-quant plan ``out_scale=``); mismatches raise
    rather than silently computing something else.

    A grouped plan requires ``group_sizes=`` (an (E,) integer vector on
    A's device) and takes ``b`` as the (E, k, n) expert bank (quantized:
    q (E, k, n), scale (E, 1, n)); ``bias`` is then per-expert (E, n).
    Rows of ``a`` must be group-sorted; rows at and beyond
    ``sum(group_sizes)`` come back zero.  A quantized bank always runs
    W8A16.

    Under ``quant.activation_mode() == "w8a8"`` a quantized, non-gated,
    linear-epilogue plan re-routes through per-row int8 activations
    (see :func:`_dispatch`).
    """
    spec = pl.spec
    ep = spec.epilogue
    if spec.gated != (b2 is not None):
        raise ValueError(f"plan {'expects' if spec.gated else 'forbids'} "
                         "a second gated B operand `b2`")
    if spec.grouped != (group_sizes is not None):
        raise ValueError(
            f"plan {'requires' if spec.grouped else 'forbids'} "
            "`group_sizes=`")
    for name, want, got in (("bias", ep.bias, bias is not None),
                            ("residual", ep.residual,
                             residual is not None),
                            ("out_scale", ep.out_quant,
                             out_scale is not None)):
        if want != got:
            raise ValueError(
                f"plan epilogue {ep.key or '(none)'!r} "
                f"{'requires' if want else 'forbids'} `{name}=`")
    if spec.b_quant != _is_quant(b) or (
            b2 is not None and spec.b_quant != _is_quant(b2)):
        raise ValueError(
            "plan expects B as a {'q','scale'} struct" if spec.b_quant
            else "plan expects a plain B array, got a quant struct")
    bw = b["q"] if spec.b_quant else b
    if telemetry.enabled():
        _execute_event(pl, a)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if dtype_name(a2.dtype) != spec.a_dtype \
            or dtype_name(bw.dtype) != spec.b_dtype:
        raise ValueError(
            f"operand dtypes ({dtype_name(a2.dtype)}, "
            f"{dtype_name(bw.dtype)}) do not match the spec "
            f"({spec.a_dtype}, {spec.b_dtype})")
    if spec.grouped:
        _check_grouped(pl, a2, b, bias, group_sizes)
        return _run_grouped(pl, a2, b, bias, group_sizes).reshape(
            *lead, pl.n)
    if tuple(a2.shape) != (pl.m, pl.k) or tuple(bw.shape) != (pl.k, pl.n):
        raise ValueError(
            f"operands {tuple(a.shape)} @ {tuple(bw.shape)} do not match "
            f"the plan's {pl.m}x{pl.k}x{pl.n}")
    if spec.b_quant:
        for w in (b, b2):
            if w is not None and w["scale"].numel() != pl.n:
                raise ValueError(f"quant scale must be (1, {pl.n}), got "
                                 f"{tuple(w['scale'].shape)}")
    b2w = b2["q"] if spec.b_quant and b2 is not None else b2
    if b2w is not None and tuple(b2w.shape) != (pl.k, pl.n):
        raise ValueError(
            f"gated operand b2 {tuple(b2w.shape)} does not match the "
            f"plan's ({pl.k}, {pl.n})")
    n = pl.n
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias {tuple(bias.shape)} does not hold the "
                         f"plan's {n} columns")
    res2 = residual.reshape(-1, n) if residual is not None else None
    if res2 is not None and res2.shape[0] != pl.m:
        raise ValueError(
            f"residual {tuple(residual.shape)} does not match the plan's "
            f"({pl.m}, {n}) output")
    return _run(pl, a2, b, b2, bias, res2, out_scale).reshape(*lead, n)


def _check_grouped(pl: GemmPlan, a2, b, bias, group_sizes) -> None:
    """A grouped plan's operand checks."""
    e = pl.n_groups
    bank = b["q"] if pl.spec.b_quant else b
    if tuple(bank.shape) != (e, pl.k, pl.n):
        raise ValueError(
            f"grouped plan expects the ({e}, {pl.k}, {pl.n}) expert bank, "
            f"got B {tuple(bank.shape)}")
    if pl.spec.b_quant and tuple(b["scale"].shape) != (e, 1, pl.n):
        raise ValueError(
            f"grouped quant scale must be ({e}, 1, {pl.n}), got "
            f"{tuple(b['scale'].shape)}")
    if tuple(a2.shape) != (pl.m, pl.k):
        raise ValueError(
            f"operands {tuple(a2.shape)} @ {tuple(bank.shape)} do not "
            f"match the plan's {pl.m}x{pl.k}x{pl.n}")
    if not isinstance(group_sizes, torch.Tensor) \
            or tuple(group_sizes.shape) != (e,) \
            or group_sizes.dtype.is_floating_point:
        raise ValueError(f"group_sizes must be an ({e},) integer tensor, "
                         f"got {group_sizes!r}")
    if bias is not None and bias.numel() != e * pl.n:
        raise ValueError(f"grouped bias must be per-expert ({e}, {pl.n}), "
                         f"got {tuple(bias.shape)}")


def _operand_key(b):
    """A B operand's part of the one-shot cache key: a tensor's shape and
    dtype, or a quantized struct's, marked apart from any tensor and
    tagged with the activation mode (W8A16 and W8A8 run other plans)."""
    if isinstance(b, dict):
        return ("q", b["q"].shape, b["q"].dtype, _quant.activation_mode())
    return (b.shape, b.dtype)


def gemm(a: torch.Tensor, b, *, b2=None,
         bias: Optional[torch.Tensor] = None,
         activation: Optional[str] = None,
         residual: Optional[torch.Tensor] = None, out_scale=None,
         strategy: Optional[str] = None,
         tile: Optional[TileConfig] = None, out_dtype=None,
         tune: Optional[bool] = None) -> torch.Tensor:
    """The one-shot planned GEMM: ``spec -> plan -> execute`` in a
    single call.

    * ``gemm(a, b)`` — C = A @ B;
    * ``gemm(a, b, bias=..., activation="gelu", residual=...)`` — the
      epilogue fused into the kernel's flush;
    * ``gemm(a, b_gate, b2=b_up, activation="silu")`` — the gated pair.

    The output dtype is ``out_dtype or a.dtype``.  The first call with a
    given operand signature builds the spec, plans and checks the
    operands through :func:`execute`; a repeat resolves its plan with one
    tuple key and one dict lookup and launches, building no spec.
    """
    global _plan_hits
    key = (a.shape, _operand_key(b), a.dtype, b2 is not None,
           bias is not None, activation, residual is not None,
           out_scale is not None, out_dtype, strategy, tile, tune)
    pl = _oneshot.get(key)
    if pl is None:
        spec = GemmSpec.for_operands(
            a, b, b2, bias=bias, activation=activation, residual=residual,
            out_scale=out_scale, strategy=strategy, tile=tile,
            out_dtype=out_dtype, tune=tune)
        pl = plan(spec, gemm_shapes(a, b))
        out = execute(pl, a, b, b2=b2, bias=bias, residual=residual,
                      out_scale=out_scale)
        _oneshot[key] = pl
        return out
    _plan_hits += 1
    if telemetry.enabled():
        _execute_event(pl, a)
    if a.dim() == 2 and (residual is None or residual.dim() == 2):
        return _run(pl, a, b, b2, bias, residual, out_scale)
    n = pl.n
    res2 = residual.reshape(-1, n) if residual is not None else None
    return _run(pl, a.reshape(-1, pl.k), b, b2, bias, res2,
                out_scale).reshape(*a.shape[:-1], n)


def gemm_grouped(a: torch.Tensor, b, group_sizes: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 tile: Optional[TileConfig] = None, out_dtype=None,
                 dense_rows: Optional[int] = None) -> torch.Tensor:
    """The one-shot planned grouped ragged GEMM (the MoE expert sweep):
    ``C[r] = epilogue(A[r] @ B[g(r)])`` with ``g(r)`` the expert owning
    row ``r`` under ``group_sizes``.

    ``a``: (..., k) tokens sorted by expert (leading dims flatten into
    the routed row count m); ``b``: (E, k, n) expert bank, or a ``{"q",
    "scale"}`` W8A16 struct with scale (E, 1, n); ``bias``: per-expert
    (E, n).  Rows at and beyond ``sum(group_sizes)`` come
    back zero.  ``dense_rows`` (the E*capacity rows a padded einsum
    would multiply) feeds ``explain()``'s padding line.  As with
    :func:`gemm`, a repeat resolves its plan with one tuple key and one
    dict lookup; ``group_sizes`` stays on the device.
    """
    global _plan_hits
    key = ("grouped", a.shape, _operand_key(b), a.dtype, bias is not None,
           activation, tile, out_dtype, dense_rows)
    pl = _oneshot.get(key)
    if pl is None:
        bq = _is_quant(b)
        spec = GemmSpec(
            a_dtype=dtype_name(a.dtype),
            b_dtype="int8" if bq else dtype_name(b.dtype), b_quant=bq,
            grouped=True, epilogue=Epilogue.from_args(bias, activation),
            out_dtype=None if out_dtype is None else dtype_name(out_dtype),
            tile=tile)
        pl = plan(spec, gemm_grouped_shapes(a, b, dense_rows))
        out = execute(pl, a, b, bias=bias, group_sizes=group_sizes)
        _oneshot[key] = pl
        return out
    _plan_hits += 1
    if telemetry.enabled():
        _execute_event(pl, a)
    return _run_grouped(pl, a.reshape(-1, pl.k), b, bias,
                        group_sizes).reshape(*a.shape[:-1], pl.n)
