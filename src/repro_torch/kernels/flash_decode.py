"""Single-token attention over a dense KV cache (kernel B4).

Replaces the Pallas kernel ``repro/kernels/flash_decode.py``
``flash_decode`` (pallas_call :144, body ``_flash_decode_kernel`` :37)
with the hand-written CUDA kernel ``csrc/flash_decode.cu``.  On an H100
it is bound by the cache bytes each slot has written; it reads ``pos``
from device memory (no host sync) and stops at ``pos[row]``.

Dispatch goes by device: a CPU tensor takes :func:`flash_decode_plain`,
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM
from repro_torch.kernels.ref import decode_attention_ref

#: most q heads one kv head may serve (the kernel's 16 rows per CTA)
MAX_GROUP = 16

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, pos, *,
                       window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    flash_decode_plain.launches += 1
    return decode_attention_ref(q, k_cache, v_cache, pos, window=window)


flash_decode_plain.launches = 0


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos, *,
                 window: int = 0) -> torch.Tensor:
    """q: (b, hq, d) one token per slot; caches: (b, S, hkv, d); pos:
    (b,) int32 per-slot positions (a scalar broadcasts).  Row i sees
    cache slots <= pos[i] (and > pos[i] - window when window > 0).
    Returns (b, hq, d) in q's dtype."""
    b, hq, d = q.shape
    bk, skv, hkv, dk = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or bk != b \
            or dk != d or hq % hkv != 0:
        raise ValueError(f"flash_decode: bad shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, pos, window=window)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos = pos.expand(b).contiguous() if pos.dim() == 0 else pos.contiguous()
    if tuple(pos.shape) != (b,):
        raise ValueError(f"flash_decode: pos must be ({b},), got "
                         f"{tuple(pos.shape)}")
    _build.require_cuda("flash_decode", q, k_cache, v_cache, pos)
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError("flash_decode: q and cache dtypes differ")
    if d > MAX_HEAD_DIM or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_decode: head_dim {d} (max {MAX_HEAD_DIM}) "
                         f"or group {hq // hkv} (max {MAX_GROUP}) too large")
    code = _build.dtype_code(q.dtype, "flash_decode")
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    o = torch.empty_like(q)
    rc = _build.entry("flash_decode_launch", _ARGTYPES)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos.data_ptr(), o.data_ptr(), b, skv, hq, hkv, d, int(window),
        float(d ** -0.5), code, _build.stream_of(q))
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0
