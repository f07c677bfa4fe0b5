"""Forward online-softmax attention for prefill (kernel B3).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (pallas_call :125, body ``_flash_kernel`` :29) with
the hand-written CUDA kernel ``csrc/flash_attention.cu``.  At serving
prompt lengths it is bound by on-chip traffic and launch latency, not by
device memory; the softmax stays on chip and no score matrix is written.
The TPU's sq >= 128 gate (attn_api.py:403) came from its (8, 128)
tiling: here every prefill, short prompts included, runs the kernel.

Dispatch goes by device: a CPU tensor takes :func:`flash_attention_plain`,
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

#: widest head the kernel's shared-memory tiles hold (csrc/flash.cuh)
MAX_HEAD_DIM = 128

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


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
    rc = _build.entry("flash_attention_launch", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, sq, skv, hq, hkv, d, int(causal), int(window), int(q_offset),
        scale, code, _build.stream_of(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
