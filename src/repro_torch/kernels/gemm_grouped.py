"""Grouped ragged GEMM of the MoE experts (kernel B7).

Replaces the Pallas kernel ``repro/kernels/gemm_grouped.py``
``gemm_grouped`` (pallas_call :196, body ``_grouped_kernel`` :90) with
the hand-written CUDA kernel ``csrc/gemm_grouped.cu``:
``C[r] = epilogue(A[r] @ B[g(r)])`` over group-sorted rows ``A`` (m, k)
and an (E, k, n) expert bank, ``g(r)`` the group owning row ``r`` under
``group_sizes``; rows at and beyond ``sum(group_sizes)`` come back zero.

The steering tables (:func:`group_metadata`, JAX :54) are built here
with torch ops on the tensor's device, at the static length
``tiles_m + E - 1``; the live instance count stays a device scalar, so
a MoE layer makes no host sync: the kernel launches the static worst
case and a CTA past the live count exits.

Dispatch goes by device: a CPU tensor takes :func:`gemm_grouped_plain`,
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.hardware import HOPPER_H100
from repro_torch.core.tiling import TileConfig, cdiv
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.ref import gemm_grouped_ref

#: k rows the kernel streams a stage (csrc/gemm_grouped.cu kBK)
CTA_K = 64

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def _repeat(values: torch.Tensor, repeats: torch.Tensor, total: int
            ) -> torch.Tensor:
    """``jnp.repeat(values, repeats, total_repeat_length=total)`` with no
    host sync: entry ``i`` is the value whose run covers ``i``, and the
    entries past ``sum(repeats)`` repeat the last value."""
    run_starts = torch.cumsum(repeats, 0) - repeats
    at = torch.arange(total, dtype=run_starts.dtype, device=values.device)
    return values[torch.searchsorted(run_starts, at, right=True) - 1]


def group_metadata(group_sizes: torch.Tensor, m: int, bm: int
                   ) -> Tuple[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor], torch.Tensor]:
    """CSR-style steering tables of the grouped sweep (JAX
    ``group_metadata``).

    Returns ``((group_offsets (E+1,), group_ids (I,), m_tile_ids (I,)),
    num_instances)``, all int32 on ``group_sizes``' device, with the
    static ``I = cdiv(m, bm) + E - 1`` (every group boundary mid-tile);
    ``num_instances`` is a device scalar, the live entries' count: an
    empty group has none, a group one a m-tile it overlaps.  Entries
    past it are repeat-padding and never run.  No step syncs the host.
    """
    e = group_sizes.shape[0]
    tiles_m = cdiv(m, bm)
    sizes = group_sizes.to(torch.int64)
    ends = torch.cumsum(sizes, 0)
    starts = ends - sizes
    # m-tiles each group overlaps: [floor(start/bm), ceil(end/bm))
    tiles_per_group = torch.where(sizes == 0, 0,
                                  (ends + bm - 1) // bm - starts // bm)
    n_inst = tiles_m + e - 1
    group_ids = _repeat(torch.arange(e, device=sizes.device),
                        tiles_per_group, n_inst)
    # visits per m-tile: 1 + the non-empty groups starting mid-tile
    mid_start = (starts % bm != 0) & (sizes > 0)
    start_tile = torch.where(mid_start, starts // bm, tiles_m) \
        .clamp(max=tiles_m)
    visits = torch.ones(tiles_m + 1, dtype=torch.int64,
                        device=sizes.device)
    visits = visits.scatter_add(0, start_tile, torch.ones_like(start_tile))
    m_tile_ids = _repeat(torch.arange(tiles_m, device=sizes.device),
                         visits[:tiles_m], n_inst)
    offsets = torch.cat([ends.new_zeros(1), ends])
    i32 = torch.int32
    return ((offsets.to(i32), group_ids.to(i32), m_tile_ids.to(i32)),
            tiles_per_group.sum().to(i32))


#: steering tables built inside a :func:`shared_tables` block, by
#: (id(group_sizes), m, bm); None outside any block
_shared: Optional[dict] = None


@contextlib.contextmanager
def shared_tables():
    """Within the block, launches with the same ``group_sizes`` tensor,
    row count and ``bm`` build the steering tables once (a MoE layer's
    three expert GEMMs share them).  The caller must not change
    ``group_sizes`` in place inside the block."""
    global _shared
    outer = _shared
    if outer is None:
        _shared = {}
    try:
        yield
    finally:
        _shared = outer


def _tables(group_sizes: torch.Tensor, m: int, bm: int):
    """:func:`group_metadata`, reused inside a :func:`shared_tables`
    block (the entry holds ``group_sizes`` so its id stays its own)."""
    if _shared is None:
        return group_metadata(group_sizes, m, bm)
    key = (id(group_sizes), m, bm)
    hit = _shared.get(key)
    if hit is None or hit[0] is not group_sizes:
        hit = _shared[key] = (group_sizes,
                              group_metadata(group_sizes, m, bm))
    return hit[1]


def _check(a, b, group_sizes, b_scale, bias, activation):
    if b_scale is not None or a.dtype == torch.int8 \
            or b.dtype == torch.int8:
        raise NotImplementedError(
            "int8 expert banks / b_scale dequant arrive with ROADMAP "
            "queue A8")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.dim() != 2 or b.dim() != 3 or a.shape[1] != b.shape[1]:
        raise ValueError(f"gemm_grouped: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    e, _, n = b.shape
    if tuple(group_sizes.shape) != (e,):
        raise ValueError(f"group_sizes must be ({e},), got "
                         f"{tuple(group_sizes.shape)}")
    if bias is not None and bias.numel() != e * n:
        raise ValueError(f"bias must be per-expert ({e}, {n}), got "
                         f"{tuple(bias.shape)}")


def gemm_grouped_plain(a: torch.Tensor, b: torch.Tensor,
                       group_sizes: torch.Tensor, *,
                       tile: Optional[TileConfig] = None, out_dtype=None,
                       bias: Optional[torch.Tensor] = None,
                       activation: Optional[str] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device
    (:func:`repro_torch.kernels.ref.gemm_grouped_ref`: one full-k matmul
    per group in f32, then the epilogue).  ``tile`` is accepted for
    call compatibility and changes nothing."""
    gemm_grouped_plain.launches += 1
    e, _, n = b.shape
    return gemm_grouped_ref(
        a, b, group_sizes, activation=activation,
        bias=bias.reshape(e, n) if bias is not None else None,
        out_dtype=out_dtype or torch.float32)


gemm_grouped_plain.launches = 0


def gemm_grouped(a: torch.Tensor, b: torch.Tensor,
                 group_sizes: torch.Tensor, *, tile: TileConfig,
                 out_dtype=None, b_scale: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None) -> torch.Tensor:
    """``C[r, n] = epilogue(sum_k A[r, k] B[g(r), k, n])``, ``g(r)`` the
    group owning row ``r`` under ``group_sizes``.

    ``a``: (m, k) group-sorted rows; ``b``: (E, k, n) bank;
    ``group_sizes``: (E,) integers; ``bias``: per-expert (E, n) (or
    (E, 1, n)), applied with ``activation`` on the flush in f32.  Rows
    at and beyond ``sum(group_sizes)`` come back zero.  ``tile`` is the
    plan's: B7 launches its (bm, bn) with its compiled k stage of
    :data:`CTA_K` rows.  ``out_dtype`` defaults to f32, as the Pallas
    kernel's does.  Quantized banks (``b_scale``, int8) raise.
    """
    _check(a, b, group_sizes, b_scale, bias, activation)
    out_dtype = out_dtype or torch.float32
    if a.device.type == "cpu":
        return gemm_grouped_plain(a, b, group_sizes, out_dtype=out_dtype,
                                  bias=bias, activation=activation)
    ops = [t for t in (a, b, group_sizes, bias) if t is not None]
    _build.require_cuda("gemm_grouped", *ops)
    if a.dtype != b.dtype:
        raise TypeError(f"gemm_grouped: A {a.dtype} and B {b.dtype} differ")
    bm, bn = tile.bm, tile.bn
    if not HOPPER_H100.grouped_launchable(bm, bn):
        raise ValueError(f"gemm_grouped: a ({bm}, {bn}) C tile does not map "
                         "onto the kernel's 256 threads (bn <= 256, at "
                         "most 4 rows a thread)")
    m, k = a.shape
    e, _, n = b.shape
    if cdiv(m, bm) + e - 1 > 65535:
        raise ValueError(f"gemm_grouped: {cdiv(m, bm) + e - 1} tile "
                         "instances exceed the grid's 65535 rows")
    in_code = _build.dtype_code(a.dtype, "gemm_grouped A")
    out_code = _build.dtype_code(out_dtype, "gemm_grouped out")
    c = torch.zeros((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    a, b = a.contiguous(), b.contiguous()
    bias32 = bias.reshape(e, n).float().contiguous() if bias is not None \
        else None
    (offsets, group_ids, m_tile_ids), live = _tables(group_sizes, m, bm)
    rc = _build.entry("gemm_grouped_launch", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        bias32.data_ptr() if bias32 is not None else None,
        offsets.data_ptr(), group_ids.data_ptr(), m_tile_ids.data_ptr(),
        live.data_ptr(), group_ids.shape[0], m, n, k, bm, bn, in_code,
        out_code, ACT_CODES[activation], _build.copy_mode(a, k, CTA_K),
        _build.copy_mode(b, n, bn), _build.stream_of(a))
    _build.check(rc, "gemm_grouped")
    gemm_grouped.launches += 1
    return c


gemm_grouped.launches = 0
