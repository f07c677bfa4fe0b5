"""Grouped ragged GEMM of the MoE experts (kernel B7).

Replaces the Pallas kernel ``repro/kernels/gemm_grouped.py``
``gemm_grouped`` (pallas_call :196, body ``_grouped_kernel`` :90) with
the hand-written CUDA kernel ``csrc/gemm_grouped.cu``:
``C[r] = epilogue(A[r] @ B[g(r)])`` over group-sorted rows ``A`` (m, k)
and an (E, k, n) expert bank, ``g(r)`` the group owning row ``r`` under
``group_sizes``; rows at and beyond ``sum(group_sizes)`` come back zero.
bf16 operands run B1's m16n8k16 tensor-core chain
(``csrc/mma_chain.cuh``) on each group's rows, so a row is bit for bit
``gemm_aie`` of that row against its expert's weights; f32 operands run
an fmaf chain, bit for bit B1's f32 body.  An int8 bank (W8A16) is
widened in registers and scaled by its expert's (1, n) scale row, so an
int8 row is bit for bit B1's W8A16 row.  :func:`cta_tile` picks the CTA
shape by rows per expert (decode or prefill), whatever the plan's tile
says.

The steering tables (:func:`group_metadata`, JAX :54, with torch ops;
on a card one launch of a table kernel, :func:`steering_tables`) are
built at the CTA's m tile and the static length ``tiles_m + E - 1``;
the live instance count stays a device scalar, so a MoE layer makes no
host sync: the kernel launches every instance that can be live (a
static bound) and a CTA past the live count exits.

Dispatch goes by device: a CPU tensor takes :func:`gemm_grouped_plain`,
a meta tensor (a dry-run's trace) gets an empty result of the kernel's
shape and dtype and launches nothing, a CUDA tensor launches the kernel
or raises.  The wrapper is the ``gemm_grouped`` scope of
:mod:`repro_torch.core.op_cost`, which counts the live routed rows with
data and the capacity rows on meta.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import op_cost
from repro_torch.core.tiling import cdiv
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.gemm_aie import check_cuda_pair
from repro_torch.kernels.ref import gemm_grouped_ref

#: the (bm, bk, bn) CTA tiles of the bf16 body, by the config index the C
#: entry point takes (csrc/gemm_grouped.cu launch_bf16): 1 at decode (one
#: 16-row block, eight warps across 128 columns, 128-deep slabs), 2 in
#: prefill (a 64-row m tile of four 16-row blocks by two 64-column halves)
BF16_TILES = {1: (16, 128, 128), 2: (64, 64, 128)}
#: the same with an int8 bank (W8A16): the decode slabs twice as deep, so a
#: stage holds as many bytes of B
INT8_TILES = {1: (16, 256, 128), 2: (64, 64, 128)}
#: the (bm, bk, bn) C tiles of the f32 body, by the same index
#: (csrc/gemm_grouped.cu launch_f32)
F32_TILES = {1: (8, 64, 128), 2: (16, 64, 64)}

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_TABLE_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p] * 5


def _tiles(dtype, b_dtype=None) -> dict:
    if dtype != torch.bfloat16:
        return F32_TILES
    return INT8_TILES if b_dtype == torch.int8 else BF16_TILES


def _config(m: int, e: int) -> int:
    """The regime of m routed rows over e experts: 1 (decode) with at
    most one row an expert on average, else 2 (prefill)."""
    return 1 if m <= e else 2


def cta_tile(m: int, e: int, dtype=torch.bfloat16, b_dtype=None):
    """The (bm, bk, bn) CTA tile the kernel launches for m routed rows
    over e experts, A of ``dtype`` and a bank of ``b_dtype`` (default
    A's)."""
    return _tiles(dtype, b_dtype)[_config(m, e)]


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


def steering_tables(group_sizes: torch.Tensor, m: int, bm: int):
    """:func:`group_metadata`'s tables: on a CUDA tensor by one launch of
    ``csrc/gemm_grouped.cu``'s table kernel (the same live entries and
    padding), on a CPU tensor by :func:`group_metadata` itself."""
    if group_sizes.device.type == "cpu":
        return group_metadata(group_sizes, m, bm)
    e = group_sizes.shape[0]
    n_inst = cdiv(m, bm) + e - 1
    if group_sizes.device.type == "meta":     # shapes only: nothing to run
        meta = dict(dtype=torch.int32, device="meta")
        return ((torch.empty(e + 1, **meta), torch.empty(n_inst, **meta),
                 torch.empty(n_inst, **meta)), torch.empty((), **meta))
    sizes = group_sizes.to(torch.int32).contiguous()
    i32 = dict(dtype=torch.int32, device=group_sizes.device)
    offsets = torch.empty(e + 1, **i32)
    group_ids = torch.empty(n_inst, **i32)
    m_tile_ids = torch.empty(n_inst, **i32)
    live = torch.empty((), **i32)
    rc = _build.entry("grouped_tables_launch", _TABLE_ARGTYPES)(
        sizes.data_ptr(), e, m, bm, n_inst, offsets.data_ptr(),
        group_ids.data_ptr(), m_tile_ids.data_ptr(), live.data_ptr(),
        _build.stream_of(sizes))
    _build.check(rc, "grouped_tables")
    return (offsets, group_ids, m_tile_ids), live


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
    """:func:`steering_tables`, reused inside a :func:`shared_tables`
    block (the entry holds ``group_sizes`` so its id stays its own)."""
    if _shared is None:
        return steering_tables(group_sizes, m, bm)
    key = (id(group_sizes), m, bm)
    hit = _shared.get(key)
    if hit is None or hit[0] is not group_sizes:
        hit = _shared[key] = (group_sizes,
                              steering_tables(group_sizes, m, bm))
    return hit[1]


def _check(a, b, group_sizes, b_scale, bias, activation, cta=None):
    if a.dtype == torch.int8:
        raise TypeError("gemm_grouped: the grouped kernel takes float "
                        "activations (a quantized bank always runs W8A16, "
                        "repro/kernels/api.py:1008-1010)")
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
    if b_scale is not None and (b.dtype != torch.int8
                                or b_scale.numel() != e * n):
        raise ValueError(f"b_scale dequantizes an int8 bank, per expert "
                         f"({e}, 1, {n}); got {tuple(b_scale.shape)} over "
                         f"{b.dtype}")
    if cta is not None and cta not in _tiles(a.dtype):
        raise ValueError(f"gemm_grouped: no CTA shape {cta} for {a.dtype} "
                         f"(one of {sorted(_tiles(a.dtype))})")


def gemm_grouped_plain(a: torch.Tensor, b: torch.Tensor,
                       group_sizes: torch.Tensor, *, out_dtype=None,
                       b_scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       activation: Optional[str] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device
    (:func:`repro_torch.kernels.ref.gemm_grouped_ref`: one full-k matmul
    per group in f32, an int8 bank widened to A's dtype first, times the
    group's scale row, then the epilogue)."""
    gemm_grouped_plain.launches += 1
    e, _, n = b.shape
    return gemm_grouped_ref(
        a, b, group_sizes, activation=activation,
        b_scale=b_scale.reshape(e, n) if b_scale is not None else None,
        bias=bias.reshape(e, n) if bias is not None else None,
        out_dtype=out_dtype or torch.float32)


gemm_grouped_plain.launches = 0


def _cost(c, a, b, group_sizes, *, b_scale=None, bias=None, **_):
    """(FLOPs, boundary bytes) over B7's rows
    (:func:`repro_torch.core.op_cost.grouped_rows`): those rows of A read,
    the bank and its epilogue operands read once, all of C written."""
    m, k = a.shape
    n = b.shape[2]
    rows = op_cost.grouped_rows(group_sizes, m)
    return 2 * rows * k * n, rows * k * a.element_size() + op_cost.boundary(
        c, b, group_sizes, b_scale, bias)


@op_cost.scope("gemm_grouped", _cost)
def gemm_grouped(a: torch.Tensor, b: torch.Tensor,
                 group_sizes: torch.Tensor, *, out_dtype=None,
                 b_scale: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 cta: Optional[int] = None) -> torch.Tensor:
    """``C[r, n] = epilogue(sum_k A[r, k] B[g(r), k, n])``, ``g(r)`` the
    group owning row ``r`` under ``group_sizes``.

    ``a``: (m, k) group-sorted rows; ``b``: (E, k, n) bank;
    ``group_sizes``: (E,) integers; ``bias``: per-expert (E, n) (or
    (E, 1, n)), applied with ``activation`` on the flush in f32.  An
    int8 bank (W8A16) is widened to A's dtype in registers and scaled by
    its expert's row of ``b_scale`` ((E, 1, n)) before the epilogue.
    Rows at and beyond ``sum(group_sizes)`` come back zero.  The kernel
    launches the CTA shape :func:`cta_tile` picks, or the one of index
    ``cta`` in :data:`BF16_TILES` / :data:`F32_TILES`.  ``out_dtype``
    defaults to f32, as the Pallas kernel's does.
    """
    _check(a, b, group_sizes, b_scale, bias, activation, cta)
    out_dtype = out_dtype or torch.float32
    if a.device.type == "cpu":
        return gemm_grouped_plain(a, b, group_sizes, out_dtype=out_dtype,
                                  b_scale=b_scale, bias=bias,
                                  activation=activation)
    if a.device.type == "meta":
        _build.require_meta("gemm_grouped", b, group_sizes, bias, b_scale)
        return torch.empty((a.shape[0], b.shape[2]), dtype=out_dtype,
                           device="meta")
    ops = [t for t in (a, b, group_sizes, bias, b_scale) if t is not None]
    _build.require_cuda("gemm_grouped", *ops)
    check_cuda_pair("gemm_grouped", a, b)
    a_code = _build.dtype_code(a.dtype, "gemm_grouped A")
    b_code = _build.dtype_code(b.dtype, "gemm_grouped B")
    out_code = _build.dtype_code(out_dtype, "gemm_grouped out")
    m, k = a.shape
    e, _, n = b.shape
    config = _config(m, e) if cta is None else cta
    bm, bk, bn = _tiles(a.dtype, b.dtype)[config]
    if cdiv(m, bm) + e - 1 > 65535:
        raise ValueError(f"gemm_grouped: {cdiv(m, bm) + e - 1} tile "
                         "instances exceed the grid's 65535 rows")
    # the kernel writes every element, zeroing the rows past the groups
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    # the backward's dA passes the bank transposed, as a view: copying a
    # qwen3-moe bank takes 6.0-6.1 ms on an NVIDIA H100 80GB HBM3 at
    # 700 W (PERF.md section 6; ROADMAP queue B part 3, item 2)
    a, b = a.contiguous(), b.contiguous()
    bias32 = bias.reshape(e, n).float().contiguous() if bias is not None \
        else None
    scale32 = b_scale.reshape(e, n).float().contiguous() \
        if b_scale is not None else None
    (offsets, group_ids, m_tile_ids), live = _tables(group_sizes, m, bm)
    # the grid: every instance that can be live (at most min(E, m) groups
    # hold rows, each one more instance a tile boundary it straddles)
    grid_instances = min(group_ids.shape[0], min(e, m) + cdiv(m, bm) - 1)
    rc = _build.entry("gemm_grouped_launch", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), _build.ptr(bias32),
        _build.ptr(scale32), offsets.data_ptr(), group_ids.data_ptr(),
        m_tile_ids.data_ptr(), live.data_ptr(), grid_instances, m, n, k, e,
        config, a_code, b_code, out_code, ACT_CODES[activation],
        _build.copy_mode(a, k, bk), _build.copy_mode(b, n, bn),
        _build.stream_of(a))
    _build.check(rc, "gemm_grouped")
    gemm_grouped.launches += 1
    return c


gemm_grouped.launches = 0
