"""On-chip footprint model (port of ``repro/core/memory_model.py``).

Predicts the bytes one kernel instance keeps on chip for a tile, and
rejects tilings that over-subscribe it.  On the TPU sheet that is VMEM,
with every block padded to (sublane, lane) tiles; on ``HOPPER_H100`` it
is the dynamic shared memory of one CTA, with no padding.  For the
A-stationary ``tb`` strategy on ``HOPPER_H100`` the footprint is exactly
what kernel B6 allocates: for bf16 operands its warp-specialised body
(``csrc/gemm_tb.cuh`` ``ws_smem``): the resident A panel in 64-deep
boxes of the CTA's rows, ``ws_tb_stages`` stages of B's panels, one f32
C-partial stage and the barriers' 1 KiB; for an f32 A its f32 body
(``csrc/gemm_f32.cuh``): the resident A panel and a ring of B stages;
for the int8 pairs ``tb_layout``: the resident A panel, two B stages
(and, int8 x int8, the 128-row transposed sub-slab), two C-partial
stages, and two stages of each fused epilogue operand.  For the
output-stationary ``aie`` strategy on ``HOPPER_H100``
it is the shared memory of the CTA shape kernel B1 launches for the
problem (``kernels/gemm_aie.py`` ``cta_smem_bytes``), whatever the
plan's tile.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.hardware import B6_F32_STAGE_BYTES, B6_F32_STAGES, \
    TPU_V5E, _bf16_pair, _f32_a, f32_tb_smem, ws_tb_stages, ws_tb_tile
from repro_torch.core.tiling import (
    GemmProblem,
    TileConfig,
    dtype_bytes,
    min_sublane,
    round_up,
)

# Streams from device memory are double-buffered: two stages in flight.
PIPELINE_STAGES = 2
# The k-rows of an int8 B tile kernel B6's W8A8 body transposes at a time
# (gemm_tb.cuh kSub), on a sheet that does not pad tiles
TB_CONV_ROWS = 128
# Kernel B6's bf16 body: the k depth of a stage and of a panel box and the
# barriers' static shared memory (csrc/gemm_ws.cuh kBK, kStaticSmem)
WS_BK = 64
WS_STATIC_SMEM = 1024


def padded_tile_bytes(rows: int, cols: int, dtype, chip=TPU_V5E) -> int:
    """On-chip bytes of one (rows, cols) block: padded to (sublane, lane)
    tiles where the sheet pads, else its logical size."""
    if not chip.pads_tiles:
        return rows * cols * dtype_bytes(dtype)
    pr = round_up(rows, min_sublane(dtype, chip))
    pc = round_up(cols, chip.lane)
    return pr * pc * dtype_bytes(dtype)


@dataclasses.dataclass(frozen=True)
class VmemFootprint:
    """Per-buffer on-chip bytes for one kernel instance."""

    a_bytes: int
    b_bytes: int
    out_bytes: int
    acc_bytes: int
    scale_bytes: int = 0          # fused-dequant fp32 scale vector blocks
    bias_bytes: int = 0           # fused-epilogue (1, bn) f32 bias blocks
    residual_bytes: int = 0       # fused-epilogue (bm, bn) residual stream

    @property
    def total(self) -> int:
        return (self.a_bytes + self.b_bytes + self.out_bytes
                + self.acc_bytes + self.scale_bytes + self.bias_bytes
                + self.residual_bytes)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self) | {"total": self.total}


def vmem_footprint(tile: TileConfig, p: GemmProblem,
                   chip=TPU_V5E) -> VmemFootprint:
    """Predict the kernel's on-chip working set.

    * ``aie`` (output-stationary): A and B blocks stream (x pipeline
      stages); the f32 accumulator is persistent; the out block streams.
    * ``tb`` (A-stationary): the A block is resident (single copy); B
      streams (x pipeline stages) and C is kept in ``chip.tb_c_buffers``
      f32 blocks (the TPU: in and out, two stages each; B6: the
      prefetched partial, two stages).

    A and B are billed at their own dtype widths.  The gated dual-B
    kernel doubles the B stream, the scale blocks and the accumulator; a
    fused epilogue adds its (1, bn) f32 bias blocks and its (bm, bn)
    out-dtype residual stream.
    """
    from repro_torch.kernels.epilogue import Epilogue
    ep = Epilogue.parse(p.epilogue)
    a = padded_tile_bytes(tile.bm, tile.bk, p.a_dtype, chip)
    b = p.n_b_operands * padded_tile_bytes(tile.bk, tile.bn, p.b_dtype,
                                           chip)
    o = padded_tile_bytes(tile.bm, tile.bn, p.out_dtype, chip)
    acc = p.n_b_operands * padded_tile_bytes(tile.bm, tile.bn, p.acc_dtype,
                                             chip)
    scale = 0
    if p.b_dtype == "int8":
        scale = p.n_b_operands * PIPELINE_STAGES * padded_tile_bytes(
            1, tile.bn, "float32", chip)
    bias = 0
    if ep.bias:
        bias = PIPELINE_STAGES * padded_tile_bytes(1, tile.bn, "float32",
                                                   chip)
    residual = 0
    if ep.residual:
        residual = PIPELINE_STAGES * padded_tile_bytes(
            tile.bm, tile.bn, p.out_dtype, chip)
    if not chip.pads_tiles and p.n_b_operands == 1 and not p.n_groups:
        if tile.strategy == "aie":
            # the CTA shape kernel B1 launches for the problem
            import torch
            from repro_torch.kernels.gemm_aie import cta_smem_bytes
            return VmemFootprint(a_bytes=0, b_bytes=cta_smem_bytes(
                p.m, p.n, getattr(torch, p.a_dtype),
                getattr(torch, p.b_dtype)), out_bytes=0, acc_bytes=0)
        if _bf16_pair(p.a_dtype, p.b_dtype):
            # kernel B6's warp-specialised body (gemm_tb.cuh ws_smem)
            rows, cols = ws_tb_tile(tile.bm, tile.bn)
            return VmemFootprint(
                a_bytes=-(-tile.bk // WS_BK) * WS_BK * rows * 2,
                b_bytes=ws_tb_stages(tile.bm, tile.bn) * WS_BK * cols * 2,
                out_bytes=rows * tile.bn * 4,
                acc_bytes=WS_STATIC_SMEM)
        if _f32_a(p.a_dtype):
            # kernel B6's f32 body (gemm_f32.cuh tb_smem): the panel, the
            # ring of B and the mbarriers; the partial C and the epilogue's
            # operands are read on the flush
            ring = B6_F32_STAGES * B6_F32_STAGE_BYTES
            bars = (B6_F32_STAGES + 1) * 8
            return VmemFootprint(
                a_bytes=f32_tb_smem(tile.bm, tile.bk) - ring - bars,
                b_bytes=ring, out_bytes=0, acc_bytes=bars)
    if tile.strategy == "aie":
        return VmemFootprint(
            a_bytes=PIPELINE_STAGES * a,
            b_bytes=PIPELINE_STAGES * b,
            out_bytes=PIPELINE_STAGES * o,
            acc_bytes=acc,
            scale_bytes=scale,
            bias_bytes=bias,
            residual_bytes=residual,
        )
    conv = 0
    if not chip.pads_tiles and p.b_dtype == "int8" and p.a_dtype == "int8":
        # kernel B6's W8A8 body transposes its int8 B tile TB_CONV_ROWS
        # k-rows at a time into a k-major sub-slab
        conv = TB_CONV_ROWS * tile.bn
    return VmemFootprint(
        a_bytes=a,
        b_bytes=PIPELINE_STAGES * b + conv,
        out_bytes=chip.tb_c_buffers * padded_tile_bytes(
            tile.bm, tile.bn, p.acc_dtype, chip),
        acc_bytes=0,
        scale_bytes=scale,
        bias_bytes=bias,
        residual_bytes=residual,
    )


def vmem_efficiency(tile: TileConfig, p: GemmProblem,
                    chip=TPU_V5E) -> float:
    """Logical bytes / on-chip (padded) bytes of the A, B and C blocks."""
    logical = tile.bm * tile.bk * dtype_bytes(p.a_dtype) \
        + tile.bk * tile.bn * dtype_bytes(p.b_dtype) \
        + tile.bm * tile.bn * dtype_bytes(p.out_dtype)
    a = padded_tile_bytes(tile.bm, tile.bk, p.a_dtype, chip)
    b = padded_tile_bytes(tile.bk, tile.bn, p.b_dtype, chip)
    o = padded_tile_bytes(tile.bm, tile.bn, p.out_dtype, chip)
    return logical / (a + b + o)


def budget_bytes(chip=TPU_V5E, budget_fraction=None) -> float:
    """The on-chip bytes a tiling may plan for: the sheet's share of its
    on-chip memory unless ``budget_fraction`` says otherwise."""
    if budget_fraction is None:
        budget_fraction = chip.budget_fraction
    return budget_fraction * chip.vmem_bytes


def fits_vmem(tile: TileConfig, p: GemmProblem, chip=TPU_V5E,
              budget_fraction=None) -> bool:
    """Capacity constraint: the footprint within :func:`budget_bytes`."""
    return vmem_footprint(tile, p, chip).total \
        <= budget_bytes(chip, budget_fraction)
