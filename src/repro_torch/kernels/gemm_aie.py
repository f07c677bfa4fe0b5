"""Output-stationary GEMM with the fused epilogue (kernel B1).

Replaces the Pallas kernel ``repro/kernels/gemm_aie.py`` ``gemm_aie``
(pallas_call :143, body ``_gemm_aie_kernel`` :38) with the hand-written
CUDA kernel ``csrc/gemm_aie.cu``.  On an H100 the serving-path calls are
bound by the bytes of the weight matrix (few rows, B read once); the
kernel keeps the epilogue on its register flush so C is written once,
and walks k in a fixed order so a row's bits do not depend on the batch.

Dispatch goes by device: a CPU tensor takes :func:`gemm_aie_plain`, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.ref import gemm_epilogue_ref

#: the (bm, bk, bn) CTA tile the kernel is compiled for (csrc/gemm_aie.cu kBM, kBK, kBN)
CTA_TILE = (16, 128, 32)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def gemm_aie_plain(a: torch.Tensor, b: torch.Tensor, *,
                   bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None,
                   residual: Optional[torch.Tensor] = None,
                   out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    gemm_aie_plain.launches += 1
    return gemm_epilogue_ref(a, b, bias=bias, activation=activation,
                             residual=residual,
                             out_dtype=out_dtype or torch.float32)


gemm_aie_plain.launches = 0


def gemm_aie(a: torch.Tensor, b: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             activation: Optional[str] = None,
             residual: Optional[torch.Tensor] = None,
             out_dtype=None,
             b_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[m,n] = epilogue(sum_k A[m,k] B[k,n]) with bias (n,) ->
    activation -> residual (m,n) in f32.

    ``out_dtype`` defaults to f32, as the Pallas kernel's does
    (gemm_aie.py:114); ``ops.gemm`` passes A's dtype instead.
    """
    if b_scale is not None or a.dtype == torch.int8 \
            or b.dtype == torch.int8:
        raise NotImplementedError(
            "int8 operands / b_scale dequant arrive with ROADMAP queue A8")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_aie: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias must hold {n} values, got {bias.shape}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} != ({m}, {n})")
    out_dtype = out_dtype or torch.float32
    if a.device.type == "cpu":
        return gemm_aie_plain(a, b, bias=bias, activation=activation,
                              residual=residual, out_dtype=out_dtype)
    ops = [t for t in (a, b, bias, residual) if t is not None]
    _build.require_cuda("gemm_aie", *ops)
    if a.dtype != b.dtype:
        raise TypeError(f"gemm_aie: A {a.dtype} and B {b.dtype} differ")
    in_code = _build.dtype_code(a.dtype, "gemm_aie A")
    out_code = _build.dtype_code(out_dtype, "gemm_aie out")
    res_code = 0
    if residual is not None:
        res_code = _build.dtype_code(residual.dtype, "gemm_aie residual")
        residual = residual.contiguous()
    a, b = a.contiguous(), b.contiguous()
    bias32 = bias.reshape(n).float().contiguous() if bias is not None \
        else None
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    rc = _build.entry("gemm_aie_launch", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        bias32.data_ptr() if bias32 is not None else None,
        residual.data_ptr() if residual is not None else None,
        m, n, k, in_code, out_code, res_code, ACT_CODES[activation],
        _build.stream_of(a))
    _build.check(rc, "gemm_aie")
    gemm_aie.launches += 1
    return c


gemm_aie.launches = 0
