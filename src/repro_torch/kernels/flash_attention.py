"""Forward online-softmax attention for prefill (kernel B3).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (pallas_call :125, body ``_flash_kernel`` :29) with
the hand-written CUDA kernel ``csrc/flash_attention.cu``.  At serving
prompt lengths its bytes and operations are far below a launch, so what
it pays is the latency of its key-block loop and of staging.  bf16
operands run both products on the tensor cores (``mma.sync`` m16n8k16),
the softmax in registers, K and V staged once per kv head's GQA group
through a ``cp.async`` ring; a CTA holds 64 (q position, q head) rows,
on the grid :func:`cta_shape` gives.  f32 operands keep the ``fmaf``
body of ``csrc/flash.cuh``.  Either way a row's bits depend only on its absolute
position and the keys (a fixed key-block grid, visited in order), so
chunked == unchunked prefill bit for bit.  The TPU's sq >= 128 gate
(attn_api.py:403) came from its (8, 128) tiling: here every prefill,
short prompts included, runs the kernel.

Dispatch goes by device: a CPU tensor takes :func:`flash_attention_plain`,
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core.tiling import cdiv
from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

#: widest head the kernel's shared-memory tiles hold (csrc/flash.cuh)
MAX_HEAD_DIM = 128
#: keys a block of the bf16 body (csrc/flash_attention.cu kBkv): blocks
#: start at multiples of it from key 0
KEY_BLOCK = 64
#: rows a CTA of the f32 body holds: 16 positions of one q head
#: (csrc/flash.cuh kFaRows)
F32_ROWS = 16
#: rows a CTA of the bf16 body holds, 16 a warp (csrc/flash_attention.cu
#: kRows): on an H100 64 rows beat 16 and 32 at every served prompt and
#: chunk length (PERF.md §6)
BF16_ROWS = 64

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]


class CtaShape(NamedTuple):
    """What one launch runs: ``rows`` rows a CTA, ``tiles`` q tiles of
    one (batch row, head group), ``ctas`` CTAs in all, ``head_dim`` the
    head padded in shared memory, ``smem_bytes`` a CTA's shared memory
    and ``body`` ("tensor cores" or "fmaf")."""

    rows: int
    tiles: int
    ctas: int
    head_dim: int
    smem_bytes: int
    body: str


def cta_shape(b: int, sq: int, hq: int, hkv: int, d: int,
              dtype=torch.bfloat16) -> CtaShape:
    """The CTA shape and grid the kernel launches for q (b, sq, hq, d)
    against k/v with ``hkv`` heads.

    bf16: a CTA holds :data:`BF16_ROWS` (q position, q head) pairs of
    one kv head's group, flattened position-major (row f is position f
    // group, q head kv_head * group + f % group), so each staged K/V
    block serves the whole group.  CTA x runs q tile
    ``tiles - 1 - x // (hkv b)`` (the causally heaviest first), kv head
    ``x % (hkv b) % hkv`` and batch row ``x % (hkv b) // hkv``.  head_dim
    is padded to 32, 64 or 128 in shared memory, two stages of K and V
    blocks of :data:`KEY_BLOCK` keys.  f32: 16 positions of one q head a
    CTA, the grid (q tiles, hq, b)."""
    if dtype != torch.bfloat16:
        tiles = cdiv(sq, F32_ROWS)
        # csrc/flash.cuh FlashSmem: q, k (+1 column), v, p in f32
        smem = 4 * (F32_ROWS * MAX_HEAD_DIM + 32 * (MAX_HEAD_DIM + 1)
                    + 32 * MAX_HEAD_DIM + F32_ROWS * 32)
        return CtaShape(F32_ROWS, tiles, tiles * hq * b, MAX_HEAD_DIM, smem,
                        "fmaf")
    head_dim = 32 if d <= 32 else 64 if d <= 64 else MAX_HEAD_DIM
    tiles = cdiv(sq * (hq // hkv), BF16_ROWS)
    return CtaShape(BF16_ROWS, tiles, tiles * hkv * b, head_dim,
                    2 * 2 * KEY_BLOCK * head_dim * 2, "tensor cores")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, scale: Optional[float] = None,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    flash_attention_plain.launches += 1
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, scale=scale)


flash_attention_plain.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d); returns (b, sq, hq, d)
    in q's dtype.  GQA maps kv head = q head // (hq // hkv);
    ``q_offset`` defaults to skv - sq."""
    b, sq, hq, d = q.shape
    bk, skv, hkv, dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or bk != b or dk != d \
            or hq % hkv != 0:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q_offset is None:
        q_offset = skv - sq
    scale = float(scale if scale is not None else d ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    _build.require_cuda("flash_attention", q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("flash_attention: q, k, v dtypes differ")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} > {MAX_HEAD_DIM}")
    code = _build.dtype_code(q.dtype, "flash_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    # the bf16 body's staging copy modes of k and v
    modes = _build.copy_mode(k, hkv * d, d) | _build.copy_mode(v, hkv * d,
                                                               d) << 2
    rc = _build.entry("flash_attention_launch", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, sq, skv, hq, hkv, d, int(causal), int(window), int(q_offset),
        scale, code, modes, _build.stream_of(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
