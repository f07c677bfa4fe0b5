"""Output-stationary GEMM with the fused epilogue (kernel B1).

Replaces the Pallas kernel ``repro/kernels/gemm_aie.py`` ``gemm_aie``
(pallas_call :143, body ``_gemm_aie_kernel`` :38) with the hand-written
CUDA kernel ``csrc/gemm_aie.cu``.  On an H100 the serving-path calls are
bound by the bytes of the weight matrix (few rows, B read once); the
kernel keeps the epilogue on its register flush so C is written once,
and walks k in a fixed order so a row's bits do not depend on the batch:
bf16 operands run the m16n8k16 tensor-core chain of
``csrc/mma_chain.cuh`` (shared with kernel B6) at a CTA shape
:func:`cta_tile` picks by m and n, f32 operands an fmaf chain.

Dispatch goes by device: a CPU tensor takes :func:`gemm_aie_plain`, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.hardware import HOPPER_H100
from repro_torch.core.tiling import cdiv
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.ref import gemm_epilogue_ref

#: the (bm, bk, bn) CTA tile of the f32 body (csrc/gemm_aie.cu kBM, kBK,
#: kBN)
F32_TILE = (16, 128, 32)
#: the (bm, bk, bn) CTA tiles of the bf16 body, by the config index the C
#: entry point takes (csrc/gemm_aie.cu launch_bf16): one 16-row fragment
#: and 8, 32 or 64 columns for few rows, 64 x 64 for more
BF16_TILES = {1: (16, 128, 8), 2: (16, 128, 32), 3: (16, 128, 64),
              4: (64, 64, 64)}

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _config(m: int, n: int, dtype) -> int:
    """The bf16 body's CTA shape for an (m, n) C (0: the f32 body).  With
    m <= 16 rows the widest n split that still gives 7 of every 8 SMs a
    CTA (one SM streams only a share of the card's memory rate, so the
    decode GEMMs spread their weights over as many SMs as n / 8 allows);
    with more rows 64 x 64."""
    if dtype != torch.bfloat16:
        return 0
    if m > 16:
        return 4
    for config in (3, 2):
        if 8 * cdiv(n, BF16_TILES[config][2]) >= 7 * HOPPER_H100.sm_count:
            return config
    return 1


def cta_tile(m: int, n: int, dtype=torch.bfloat16):
    """The (bm, bk, bn) CTA tile the kernel launches for an (m, n) C."""
    config = _config(m, n, dtype)
    return BF16_TILES[config] if config else F32_TILE


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
    config, modes = _config(m, n, a.dtype), 0
    if config:  # the bf16 body's staging copy modes of A and B
        _, bk, bn = BF16_TILES[config]
        modes = _build.copy_mode(a, k, bk) | _build.copy_mode(b, n, bn) << 2
    rc = _build.entry("gemm_aie_launch", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        bias32.data_ptr() if bias32 is not None else None,
        residual.data_ptr() if residual is not None else None,
        m, n, k, in_code, out_code, res_code, ACT_CODES[activation],
        config, modes, _build.stream_of(a))
    _build.check(rc, "gemm_aie")
    gemm_aie.launches += 1
    return c


gemm_aie.launches = 0
