"""GEMM problems and tiles (port of ``repro/core/tiling.py``).

dtypes are strings (``"bfloat16"``, ``"float32"``), as in the JAX
package, so problems and specs compare equal across the two packages;
:func:`dtype_name` turns a ``torch.dtype`` into that string.

The two dataflow strategies are the paper's two devices:

* ``aie`` — output-stationary: each C tile is accumulated over the whole
  of K and written once (kernel B1, ``csrc/gemm_aie.cu``);
* ``tb``  — A-stationary: K is chunked outside the kernel, an A panel
  stays resident while B streams past it, and C is read-modified-written
  once per chunk (kernel B6, ``csrc/gemm_tb.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.hardware import TPU_V5E

STRATEGIES = ("aie", "tb")

_ITEMSIZE = {"float64": 8, "float32": 4, "int32": 4, "bfloat16": 2,
             "float16": 2, "int8": 1, "uint8": 1}


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` / ``"bfloat16"`` -> ``"bfloat16"``."""
    name = str(dtype)
    return name[6:] if name.startswith("torch.") else name


def dtype_bytes(dtype) -> int:
    return _ITEMSIZE[dtype_name(dtype)]


def min_sublane(dtype, chip=TPU_V5E) -> int:
    """Minimum second-to-last-dim tile for a dtype: on a TPU 8 fp32 / 16
    bf16 / 32 int8 (packed sublanes); on a sheet that does not pad tiles
    the sheet's smallest row edge."""
    if not chip.pads_tiles:
        return chip.sublanes
    return chip.sublanes * max(1, 4 // dtype_bytes(dtype))


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    """A logical (M, K, N) GEMM with per-operand dtypes.

    ``b_dtype=None`` means "same as A".  ``epilogue`` is the canonical
    :class:`repro_torch.kernels.epilogue.Epilogue` key (``"bias+silu+res"``,
    ``""`` for none): bias and residual operands take on-chip blocks and
    device-memory reads of their own.  ``n_b_operands`` is 2 for the
    dual-B gated kernel.  Grouped ragged GEMMs (the MoE expert sweep)
    set ``n_groups`` to the expert count E: ``m`` is then the true total
    of routed rows, B an (E, k, n) bank of which each m-tile instance
    streams one expert's panels, and the billing charges the up to
    ``gm + E - 1`` tile instances the straddling sweep executes.
    """

    m: int
    k: int
    n: int
    a_dtype: str = "bfloat16"
    out_dtype: str = "bfloat16"
    acc_dtype: str = "float32"
    b_dtype: Optional[str] = None
    epilogue: str = ""
    n_b_operands: int = 1
    n_groups: int = 0

    def __post_init__(self):
        if self.b_dtype is None:
            object.__setattr__(self, "b_dtype", self.a_dtype)
        if self.n_b_operands not in (1, 2):
            raise ValueError(f"n_b_operands must be 1 or 2, got "
                             f"{self.n_b_operands}")
        if self.n_groups < 0:
            raise ValueError(f"n_groups must be >= 0, got {self.n_groups}")
        if self.n_groups and self.n_b_operands != 1:
            raise ValueError("grouped GEMM is single-B")

    @property
    def flops(self) -> float:
        """Logical (unpadded) flops — what the tuner's budget reads."""
        return 2.0 * self.m * self.k * self.n * self.n_b_operands


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One tiling choice (bm, bk, bn) and its dataflow strategy."""

    bm: int
    bk: int
    bn: int
    strategy: str = "aie"

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")

    def grid(self, p: GemmProblem) -> Tuple[int, int, int]:
        """Trip counts (gm, gn, gk)."""
        return (cdiv(p.m, self.bm), cdiv(p.n, self.bn), cdiv(p.k, self.bk))

    def padded_dims(self, p: GemmProblem) -> Tuple[int, int, int]:
        gm, gn, gk = self.grid(p)
        return (gm * self.bm, gk * self.bk, gn * self.bn)

    def tile_efficiency(self, p: GemmProblem) -> float:
        """Useful fraction of the padded compute."""
        pm_, pk, pn = self.padded_dims(p)
        return (p.m * p.k * p.n) / (pm_ * pk * pn)

    def mxu_aligned(self, chip=TPU_V5E, p: "GemmProblem" = None) -> bool:
        """Whether the sheet admits this tile: on a TPU lane dims are
        multiples of 128 and the sublane dim of 8; on ``HOPPER_H100`` it
        is a tile kernel B6 launches for the problem ``p`` (a dense bf16
        one when None; :meth:`HopperChip.tile_aligned`)."""
        return chip.tile_aligned(self.bm, self.bk, self.bn, p)


def grouped_instances(tile: TileConfig, p: GemmProblem) -> int:
    """Static worst-case m-tile instances of a grouped sweep: every
    m-tile once, plus one revisit per group boundary that can land
    mid-tile (``gm + E - 1``).  The traffic model bills this; the live
    instance count (``kernels.gemm_grouped.group_metadata``) is at most
    this."""
    gm, _, _ = tile.grid(p)
    return gm + max(p.n_groups - 1, 0)
