"""Dual-B gated GEMM ``act(A Wg) * (A Wu)`` (kernel B2).

Replaces the Pallas kernel ``repro/kernels/gemm_gated.py``
``gemm_gated`` (pallas_call :114, body ``_gated_kernel`` :34) with the
hand-written CUDA kernel ``csrc/gemm_gated.cu``.  On an H100 the serving
calls are bound by the bytes of the two weight matrices; one staged A
slab feeds both B streams and the gate/up sums never leave registers.
bf16 operands run B1's m16n8k16 tensor-core chain (``csrc/mma_chain.cuh``)
on both accumulators, at a CTA shape :func:`cta_tile` picks by m, so
each accumulator is bit for bit ``gemm_aie(a, b, out_dtype=float32)``
and a row's bits do not depend on m; f32 operands run an fmaf chain.

int8 gate/up weights (W8A16) are widened to bf16 in shared memory once
each slab lands, for the same chain, and each accumulator is scaled
before the gate.

Dispatch goes by device: a CPU tensor takes :func:`gemm_gated_plain`, a
meta tensor (a dry-run's trace) gets an empty result of the kernel's
shape and dtype and launches nothing, a CUDA tensor launches the kernel
or raises.  The wrapper is the ``gemm_gated`` scope of
:mod:`repro_torch.core.op_cost`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import op_cost
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.gemm_aie import check_cuda_pair, check_int8, \
    scale_vector
from repro_torch.kernels.ref import gemm_gated_ref

#: the (bm, bk, bn) CTA tile of the f32 body (csrc/gemm_gated.cu kBM, kBK,
#: kBN)
F32_TILE = (16, 64, 32)
#: the (bm, bk, bn) CTA tiles of the bf16 body, by the config index the C
#: entry point takes (csrc/gemm_gated.cu launch_bf16): one 16-row fragment
#: and 16 columns of both products for m <= 16 (smollm-360m's n = 2560
#: gives 160 CTAs, at least 7 of every 8 SMs: one SM streams only a share
#: of the card's memory rate), 64 x 64 for more rows
BF16_TILES = {1: (16, 128, 16), 2: (64, 64, 64)}

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _config(m: int, dtype) -> int:
    """The bf16 body's CTA shape for m rows (0: the f32 body)."""
    if dtype != torch.bfloat16:
        return 0
    return 1 if m <= 16 else 2


def cta_tile(m: int, n: int, dtype=torch.bfloat16, b_dtype=None):
    """The (bm, bk, bn) CTA tile the kernel launches for an (m, n) C
    with A of ``dtype`` (int8 weights run the same ones); n does not
    choose it (ragged n is masked)."""
    config = _config(m, dtype)
    return BF16_TILES[config] if config else F32_TILE


def gemm_gated_plain(a: torch.Tensor, b_gate: torch.Tensor,
                     b_up: torch.Tensor, *, activation: str = "silu",
                     out_dtype=None, bg_scale: Optional[torch.Tensor] = None,
                     bu_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    gemm_gated_plain.launches += 1
    n = b_gate.shape[1]
    return gemm_gated_ref(
        a, b_gate, b_up, activation=activation, out_dtype=out_dtype,
        bg_scale=bg_scale.reshape(1, n) if bg_scale is not None else None,
        bu_scale=bu_scale.reshape(1, n) if bu_scale is not None else None)


gemm_gated_plain.launches = 0


def _cost(c, a, b_gate, b_up, *, bg_scale=None, bu_scale=None, **_):
    """(FLOPs, boundary bytes): two products of A, one C."""
    m, k = a.shape
    return 4 * m * k * b_gate.shape[1], op_cost.boundary(
        c, a, b_gate, b_up, bg_scale, bu_scale)


@op_cost.scope("gemm_gated", _cost)
def gemm_gated(a: torch.Tensor, b_gate: torch.Tensor, b_up: torch.Tensor,
               *, activation: str = "silu", out_dtype=None,
               bg_scale: Optional[torch.Tensor] = None,
               bu_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[m,n] = act((A @ B_gate) * bg_scale) * ((A @ B_up) * bu_scale);
    output A's dtype by default (gemm_gated.py:94).  The weights are of
    A's float dtype or both int8 (W8A16: widened to bf16 on chip, each
    accumulator scaled by its (n,) / (1, n) scale before the gate).  An
    int8 A raises: the planner never sends W8A8 to the gated kernel
    (repro/kernels/api.py:1106-1109)."""
    if activation is None or activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.dim() != 2 or b_gate.dim() != 2 or a.shape[1] != b_gate.shape[0] \
            or b_up.shape != b_gate.shape:
        raise ValueError(f"gemm_gated: bad shapes {tuple(a.shape)}, "
                         f"{tuple(b_gate.shape)}, {tuple(b_up.shape)}")
    m, k = a.shape
    n = b_gate.shape[1]
    if a.dtype == torch.int8:
        raise TypeError("gemm_gated: the gated kernel takes float "
                        "activations (W8A8 never routes a gated plan)")
    if (bg_scale is None) != (bu_scale is None):
        raise ValueError("gemm_gated: give both dequant scales or neither")
    check_int8("gemm_gated", a, b_gate, bg_scale, n)
    check_int8("gemm_gated", a, b_up, bu_scale, n)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return gemm_gated_plain(a, b_gate, b_up, activation=activation,
                                out_dtype=out_dtype, bg_scale=bg_scale,
                                bu_scale=bu_scale)
    if a.device.type == "meta":
        _build.require_meta("gemm_gated", b_gate, b_up, bg_scale, bu_scale)
        return torch.empty((m, n), dtype=out_dtype, device="meta")
    sg, su = scale_vector(bg_scale, n), scale_vector(bu_scale, n)
    _build.require_cuda("gemm_gated", a, b_gate, b_up,
                        *(t for t in (sg, su) if t is not None))
    if b_gate.dtype != b_up.dtype:
        raise TypeError("gemm_gated: operand dtypes differ")
    check_cuda_pair("gemm_gated", a, b_gate)
    a_code = _build.dtype_code(a.dtype, "gemm_gated A")
    b_code = _build.dtype_code(b_gate.dtype, "gemm_gated B")
    out_code = _build.dtype_code(out_dtype, "gemm_gated out")
    a, b_gate, b_up = a.contiguous(), b_gate.contiguous(), \
        b_up.contiguous()
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    config, modes = _config(m, a.dtype), 0
    if config:  # the bf16 body's staging copy modes of A and of both Bs
        _, bk, bn = cta_tile(m, n, a.dtype, b_gate.dtype)
        modes = _build.copy_mode(a, k, bk) | min(
            _build.copy_mode(b_gate, n, bn),
            _build.copy_mode(b_up, n, bn)) << 2
    ptr = _build.ptr
    rc = _build.entry("gemm_gated_launch", _ARGTYPES)(
        a.data_ptr(), b_gate.data_ptr(), b_up.data_ptr(), ptr(sg), ptr(su),
        c.data_ptr(), m, n, k, a_code, b_code, out_code,
        ACT_CODES[activation], config, modes, _build.stream_of(a))
    _build.check(rc, "gemm_gated")
    gemm_gated.launches += 1
    return c


gemm_gated.launches = 0
