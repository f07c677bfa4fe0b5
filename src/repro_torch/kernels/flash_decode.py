"""Single-token attention over a dense KV cache (kernel B4) and over a
shared page pool (kernel B5).

B4 replaces the Pallas kernel ``repro/kernels/flash_decode.py``
``flash_decode`` (pallas_call :144, body ``_flash_decode_kernel`` :37)
with the hand-written CUDA kernel ``csrc/flash_decode.cu``.  On an H100
it is bound by the cache bytes each slot has written and, at serving
lengths, by the latency of a launch and of one round of loads.  bf16
operands run ``csrc/decode_split.cuh``: the keys split across CTAs on a
grid of 64-key splits fixed from key 0
(``flash_attention.decode_grid``), one warp a split on the tensor
cores, 1, 2 or 4 splits a CTA (``bkv`` = 64, 128 or 256 keys a CTA,
chosen at launch), then a merge of the splits' partials in ascending
order (``flash_attention.decode_splits``); so a row's bits depend only
on its q, its keys, its ``pos`` and the window, whatever ``bkv``.  f32
operands keep ``csrc/flash.cuh``'s ``fmaf`` step, one CTA per (kv
head, slot).  It reads ``pos`` from device memory (no host sync).

B5 replaces ``flash_decode_paged`` (pallas_call :275, body
``_flash_decode_paged_kernel`` :156) with ``csrc/flash_decode_paged.cu``:
B4's grid at one split a CTA, its splits and merge, with each key's
row looked up through the slot's page table, so paged decode equals
dense decode bit for bit at any page size.  Its block is the page: it
takes no ``bkv``, as in the JAX package.  It reads ``pos`` and the
table from device memory.

Each launch counter counts wrapper calls that launch the kernel: a bf16
call is two CUDA launches (the split grid and its merge) and counts one.
Dispatch goes by device: a CPU tensor takes the ``*_plain`` version, a
meta tensor (a dry-run's trace) gets an empty result of the kernel's
shape and dtype and launches nothing, a CUDA tensor launches the kernel
or raises.  The wrappers are the ``flash_decode`` and
``flash_decode_paged`` scopes of :mod:`repro_torch.core.op_cost`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import op_cost
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DECODE_SPLIT, MAX_HEAD_DIM,
                                                 decode_cta_keys,
                                                 decode_grid)
from repro_torch.kernels.ref import (decode_attention_paged_ref,
                                    decode_attention_ref)

#: most q heads one kv head may serve (the kernel's 16 rows per CTA)
MAX_GROUP = 16

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PAGED_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _pos_vector(pos, b: int, device, name: str) -> torch.Tensor:
    """(b,) contiguous int32 positions on ``device``; a scalar
    broadcasts."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    pos = pos.expand(b).contiguous() if pos.dim() == 0 else pos.contiguous()
    if tuple(pos.shape) != (b,):
        raise ValueError(f"{name}: pos must be ({b},), got "
                         f"{tuple(pos.shape)}")
    return pos


def _check_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, hq: int, hkv: int, d: int) -> None:
    """What both kernels take: one dtype, head_dim and GQA group within
    the kernel's tiles."""
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q and cache dtypes differ")
    if d > MAX_HEAD_DIM or hq // hkv > MAX_GROUP:
        raise ValueError(f"{name}: head_dim {d} (max {MAX_HEAD_DIM}) "
                         f"or group {hq // hkv} (max {MAX_GROUP}) too large")


def _split_scratch(q: torch.Tensor, hkv: int, length: int, k, v):
    """The bf16 body's partials (None for f32) and the staging copy
    modes of k and v, for keys of ``length`` slots (the partials do not
    depend on the splits a CTA)."""
    b, hq, d = q.shape
    grid = decode_grid(b, hq, hkv, length, d, q.dtype)
    if not grid.acc_floats:
        return None, None, 0
    f32 = dict(dtype=torch.float32, device=q.device)
    modes = _build.copy_mode(k, hkv * d, d) \
        | _build.copy_mode(v, hkv * d, d) << 2
    return (torch.empty(grid.acc_floats, **f32),
            torch.empty(grid.ml_floats, **f32), modes)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, pos, *,
                       window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    flash_decode_plain.launches += 1
    return decode_attention_ref(q, k_cache, v_cache, pos, window=window)


flash_decode_plain.launches = 0


def _decode_cost(o, q, k_cache, v_cache, pos, **_):
    """(FLOPs, boundary bytes): QK^T and PV over the cache's S slots."""
    b, hq, d = q.shape
    return 4 * b * hq * k_cache.shape[1] * d, op_cost.boundary(
        o, q, k_cache, v_cache, pos)


@op_cost.scope("flash_decode", _decode_cost)
def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos, *, window: int = 0,
                 bkv: Optional[int] = None) -> torch.Tensor:
    """q: (b, hq, d) one token per slot; caches: (b, S, hkv, d); pos:
    (b,) int32 per-slot positions (a scalar broadcasts).  Row i sees
    cache slots <= pos[i] (and > pos[i] - window when window > 0).
    ``bkv`` (the JAX wrapper's keyword): keys a CTA, one of
    ``flash_attention.decode_blocks`` (None: the default, 64); one that
    is not compiled raises ``ValueError``; every one gives the same
    bits.  Returns (b, hq, d) in q's dtype."""
    b, hq, d = q.shape
    bk, skv, hkv, dk = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or bk != b \
            or dk != d or hq % hkv != 0:
        raise ValueError(f"flash_decode: bad shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}")
    keys = decode_cta_keys(d, q.dtype, bkv)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, pos, window=window)
    if q.device.type == "meta":
        _build.require_meta("flash_decode", k_cache, v_cache,
                            *(p for p in (pos,) if torch.is_tensor(p)))
        return torch.empty_like(q)
    pos = _pos_vector(pos, b, q.device, "flash_decode")
    _build.require_cuda("flash_decode", q, k_cache, v_cache, pos)
    _check_operands("flash_decode", q, k_cache, v_cache, hq, hkv, d)
    code = _build.dtype_code(q.dtype, "flash_decode")
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    o = torch.empty_like(q)
    part_acc, part_ml, modes = _split_scratch(q, hkv, skv, k_cache, v_cache)
    rc = _build.entry("flash_decode_launch", _ARGTYPES)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos.data_ptr(), o.data_ptr(), _ptr(part_acc), _ptr(part_ml), b, skv,
        hq, hkv, d, int(window), float(d ** -0.5), code, modes,
        keys // DECODE_SPLIT, _build.stream_of(q))
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0


def flash_decode_paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor,
                             page_table: torch.Tensor, pos, *,
                             window: int = 0) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch, on any device: the
    pages gathered into a dense view, then the dense reference."""
    flash_decode_paged_plain.launches += 1
    return decode_attention_paged_ref(q, k_pages, v_pages, page_table, pos,
                                      window=window)


flash_decode_paged_plain.launches = 0


def _paged_cost(o, q, k_pages, v_pages, page_table, pos, **_):
    """(FLOPs, boundary bytes): QK^T and PV over the table's
    ``max_pages * page_size`` keys; the pools, table and positions read
    once."""
    b, hq, d = q.shape
    keys = page_table.shape[1] * k_pages.shape[1]
    return 4 * b * hq * keys * d, op_cost.boundary(
        o, q, k_pages, v_pages, page_table, pos)


@op_cost.scope("flash_decode_paged", _paged_cost)
def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       pos, *, window: int = 0) -> torch.Tensor:
    """q: (b, hq, d) one token per slot; k_pages/v_pages: (n_pages,
    page_size, hkv, d), one pool shared by every slot; page_table:
    (b, max_pages) int32, row i's logical key kp in physical page
    ``page_table[i, kp // page_size]``; pos: (b,) int32 (a scalar
    broadcasts).  Row i sees keys <= pos[i] and < max_pages * page_size
    (and > pos[i] - window when window > 0); a row that sees no key at
    all (only a masked row whose position has run past its table, under
    a window) gets zeros from the kernel, as from the Pallas kernel, and
    the mean of the values from the plain version — the serve loop never
    reads such a row.  Table entries are not checked against n_pages on
    the card (that would cost a host sync); the serve loop's pool hands
    out only pages it holds.  Returns (b, hq, d) in q's dtype."""
    b, hq, d = q.shape
    _, ps, hkv, dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or dk != d \
            or hq % hkv != 0 or page_table.dim() != 2 \
            or page_table.shape[0] != b:
        raise ValueError(f"flash_decode_paged: bad shapes q "
                         f"{tuple(q.shape)}, pools {tuple(k_pages.shape)}, "
                         f"table {tuple(page_table.shape)}")
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pages, v_pages, page_table,
                                        pos, window=window)
    if q.device.type == "meta":
        _build.require_meta("flash_decode_paged", k_pages, v_pages,
                            page_table,
                            *(p for p in (pos,) if torch.is_tensor(p)))
        return torch.empty_like(q)
    pos = _pos_vector(pos, b, q.device, "flash_decode_paged")
    _build.require_cuda("flash_decode_paged", q, k_pages, v_pages,
                        page_table, pos)
    _check_operands("flash_decode_paged", q, k_pages, v_pages, hq, hkv, d)
    if page_table.dtype != torch.int32:
        raise TypeError("flash_decode_paged: the page table must be int32")
    code = _build.dtype_code(q.dtype, "flash_decode_paged")
    q, page_table = q.contiguous(), page_table.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    o = torch.empty_like(q)
    max_pages = page_table.shape[1]
    part_acc, part_ml, modes = _split_scratch(q, hkv, max_pages * ps,
                                              k_pages, v_pages)
    rc = _build.entry("flash_decode_paged_launch", _PAGED_ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), o.data_ptr(),
        _ptr(part_acc), _ptr(part_ml), b, ps, max_pages, hq, hkv, d,
        int(window), float(d ** -0.5), code, modes, _build.stream_of(q))
    _build.check(rc, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return o


flash_decode_paged.launches = 0
