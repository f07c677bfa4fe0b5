"""Output-stationary GEMM with the fused epilogue (kernel B1).

Replaces the Pallas kernel ``repro/kernels/gemm_aie.py`` ``gemm_aie``
(pallas_call :143, body ``_gemm_aie_kernel`` :38) with the hand-written
CUDA kernel ``csrc/gemm_aie.cu``.  On an H100 the serving-path calls are
bound by the bytes of the weight matrix (few rows, B read once); the
kernel keeps the epilogue on its register flush so C is written once,
and walks k in a fixed order so a row's bits do not depend on the batch:
bf16 operands run the warp-specialised, TMA-fed wgmma body of
``csrc/gemm_ws.cuh`` (shared with kernel B6) at a CTA shape
:func:`cta_tile` picks by m and n; f32 operands one fmaf chain an
element on the CUDA cores (``csrc/gemm_f32.cuh``, shared with B6), at a
CTA shape :func:`cta_tile` also picks by m and n (:data:`F32_TILES`).

The int8 paths keep the sm_80 body (``cp.async`` stages, the mma.sync
m16n8k16 chain of ``csrc/mma_chain.cuh``, whose bits wgmma's chain
gives too) at their own CTA shapes (:data:`INT8_TILES`): W8A16 (a bf16
or f32 A against an int8 weight, widened to bf16 in shared memory once
each slab lands, its per-column scale on the flush; bit for bit the
bf16 body on the widened weights, then the scale), W8A8 (int8 A and B
on the int8 tensor cores, int32 sums), and an int8 C quantized on the
flush by ``out_scale``.

Dispatch goes by device: a CPU tensor takes :func:`gemm_aie_plain`, a
meta tensor (a dry-run's trace, which has no data) gets an empty C of
the kernel's shape and dtype and launches nothing, a CUDA tensor
launches the kernel or raises: an int8 operand never falls back to a
dequantized bf16 call.  The wrapper is the ``gemm_aie`` scope of
:mod:`repro_torch.core.op_cost`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import op_cost
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.core.tiling import cdiv
from repro_torch.kernels import _build, acc_dtype
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.ref import gemm_epilogue_ref, gemm_ref

#: the (bm, bk, bn) CTA tiles of the f32 body, by the config index the C
#: entry point takes (csrc/gemm_f32.cuh launch_aie; bk a ring stage's
#: depth): for few rows two warps of 8 rows x 8 columns (1), one chain a
#: thread; for more, four warps of 8 x 16 threads, 8 to 64 rows and 64
#: columns (2 .. 5), 4 to 32 chains a thread
F32_TILES = {1: (8, 256, 8), 2: (8, 64, 64), 3: (16, 64, 64),
             4: (32, 64, 64), 5: (64, 64, 64)}
#: the (rows, columns) of chains each thread of a shape keeps
F32_CHAINS = {1: (1, 1), 2: (1, 4), 3: (2, 4), 4: (4, 4), 5: (8, 4)}
#: the ring stages of each f32 shape (csrc/gemm_f32.cuh AieShape kStages)
F32_STAGES = {1: 6, 2: 6, 3: 4, 4: 4, 5: 3}
#: the (bm, bk, bn) CTA tiles of the bf16 body, by the config index the C
#: entry point takes (csrc/gemm_aie_ws.cu; bk the stage depth): for few
#: rows the swapped wgmma form 16 x 64 (1) and the mma.sync form 16 x 8,
#: 16, 32 or 64 (6 .. 9); for more, wgmma at 64 x 64, 64 x 128, 128 x 128
#: and 128 x 256 (2 .. 5)
BF16_TILES = {1: (16, 64, 64), 2: (64, 64, 64), 3: (64, 64, 128),
              4: (128, 64, 128), 5: (128, 64, 256), 6: (16, 64, 8),
              7: (16, 64, 16), 8: (16, 64, 32), 9: (16, 64, 64)}
#: the ring stages each bf16 shape keeps (csrc/gemm_aie_ws.cu)
BF16_STAGES = {1: 8, 2: 6, 3: 4, 4: 6, 5: 4, 6: 16, 7: 16, 8: 16, 9: 16}
#: the CTA tiles of the int8 bodies (csrc/gemm_aie.cu launch_tc): one
#: 16-row fragment and 8, 32 or 64 columns for few rows, 64 x 64 for more
INT8_TILES = {1: (16, 256, 8), 2: (16, 256, 32), 3: (16, 256, 64),
              4: (64, 128, 64)}
#: their ring stages
INT8_STAGES = {1: 8, 2: 8, 3: 4, 4: 4}

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _config(m: int, n: int, dtype, b_dtype=None) -> int:
    """The tensor-core CTA shape for an (m, n) C with A of ``dtype`` and
    B of ``b_dtype`` (default A's); 0: the f32 body.  With m <= 16 rows
    the widest n split that still gives 7 of every 8 SMs a CTA (one SM
    streams only a share of the card's memory rate, so the decode GEMMs
    spread their weights over as many SMs as n / 8 allows): bf16 x bf16
    the mma.sync form of :data:`BF16_TILES` at 8, 16 or 32 columns, or,
    where 64 would do, the swapped wgmma form; an int8 operand
    :data:`INT8_TILES`.  With more rows bf16 takes the largest wgmma
    tile whose CTAs still give every SM one, else 64 x 64; int8 64 x
    64."""
    if dtype not in (torch.bfloat16, torch.int8):
        return 0
    sms = HOPPER_H100.sm_count
    bf16 = torch.int8 not in (dtype, b_dtype)
    if m > 16:
        if not bf16:
            return 4
        for config in (5, 4, 3):
            bm, _, bn = BF16_TILES[config]
            if cdiv(m, bm) * cdiv(n, bn) >= sms:
                return config
        return 2
    tiles, split = (BF16_TILES, (9, 8, 7)) if bf16 else (INT8_TILES, (3, 2))
    for config in split:
        if 8 * cdiv(n, tiles[config][2]) >= 7 * sms:
            # at 64 columns a CTA the swapped wgmma form runs faster on
            # the card, narrower the mma.sync form (PERF.md §6,
            # chip_smoke.py decode_form_phase)
            return 1 if config == 9 else config
    return 6 if bf16 else 1


def _f32_config(m: int, n: int) -> int:
    """The f32 shape for an (m, n) C: up to 64 rows the two-warp shape,
    one chain a thread, so a decode router's weight streams through one
    SM for every 8 of its columns; with more rows the four-warp shape of
    the most rows whose CTAs still reach 7 of every 8 SMs, else 8 x 64.
    (On the card, tools/f32_shapes.py: one chain a thread beats the
    others at 1, 8 and 64 rows, 8 x 64 at 300, 64 x 64 at 4096; PERF.md
    §6.)"""
    if m <= 64:
        return 1
    for config in (5, 4, 3):
        bm, _, bn = F32_TILES[config]
        if 8 * cdiv(m, bm) * cdiv(n, bn) >= 7 * HOPPER_H100.sm_count:
            return config
    return 2


def cta_tile(m: int, n: int, dtype=torch.bfloat16, b_dtype=None):
    """The (bm, bk, bn) CTA tile the kernel launches for an (m, n) C
    with A of ``dtype`` and B of ``b_dtype`` (default A's)."""
    config = _config(m, n, dtype, b_dtype)
    if not config:
        return F32_TILES[_f32_config(m, n)]
    return (INT8_TILES if torch.int8 in (dtype, b_dtype)
            else BF16_TILES)[config]


def cta_smem_bytes(m: int, n: int, dtype=torch.bfloat16,
                   b_dtype=None) -> int:
    """Shared memory one CTA takes at the shape :func:`cta_tile` picks:
    the bf16 body's ring of stages, each A's (bm x 64) slab and B's
    panels (``csrc/gemm_ws.cuh`` ``smem_bytes``), and its barriers'
    1 KiB; the int8
    bodies' ring of A and B slabs and the converted B slab
    (``csrc/gemm_aie.cu`` ``MmaShape::smem``); the f32 body's ring of
    A's and B's slabs (B at its width) and an mbarrier a stage
    (``csrc/gemm_f32.cuh`` ``AieShape::smem``)."""
    config = _config(m, n, dtype, b_dtype)
    if not config:
        config = _f32_config(m, n)
        bm, bk, bn = F32_TILES[config]
        b_size = 1 if b_dtype == torch.int8 else 4
        return F32_STAGES[config] * (bm * bk * 4 + bk * bn * b_size + 8)
    if torch.int8 not in (dtype, b_dtype):
        bm, bk, bn = BF16_TILES[config]
        return BF16_STAGES[config] * bk * (bm + bn) * 2 + 1024
    bm, bk, bn = INT8_TILES[config]
    a_size = 1 if dtype == torch.int8 else 2
    return (INT8_STAGES[config] * (bm * bk * a_size + bk * bn)
            + bk * bn * a_size)


def default_out_dtype(a_dtype, *, fused: bool, out_scale=None):
    """The Pallas kernel's output dtype when the caller names none
    (gemm_aie.py:114): int8 under output quantization, else f32 when
    anything is fused (a dequant scale included) or A is a float, else
    the int32 sums of an int8 A."""
    if out_scale is not None:
        return torch.int8
    return torch.float32 if fused or a_dtype != torch.int8 \
        else acc_dtype(a_dtype)


def check_int8(name: str, a: torch.Tensor, b: torch.Tensor, b_scale,
               n: int) -> None:
    """The int8 operand pairs: a float A against an int8 B (W8A16: B
    widened), or int8 against int8 (W8A8); a ``b_scale`` ((n,) or (1,
    n)) only with an int8 B.  An int8 A against a float B would narrow
    silently and raises.  (On a card the float pairs must also be of one
    dtype: :func:`check_cuda_pair`.)"""
    if a.dtype == torch.int8 and b.dtype != torch.int8:
        raise TypeError(f"{name}: an int8 A needs an int8 B, got {b.dtype}")
    if b_scale is not None:
        if b.dtype != torch.int8:
            raise TypeError(f"{name}: b_scale dequantizes an int8 B, got "
                            f"{b.dtype}")
        if b_scale.numel() != n:
            raise ValueError(f"{name}: b_scale must hold {n} values, got "
                             f"{tuple(b_scale.shape)}")


def check_cuda_pair(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """The kernels take float A and B of one dtype, or an int8 B."""
    if b.dtype != torch.int8 and a.dtype != b.dtype:
        raise TypeError(f"{name}: A {a.dtype} and B {b.dtype} differ")


def scale_vector(scale: Optional[torch.Tensor], n: int):
    """A (1, n) / (n,) scale as the contiguous (n,) f32 the kernels read."""
    if scale is None:
        return None
    return scale.reshape(n).float().contiguous()


def out_scale_scalar(out_scale, device):
    """The output scale as a one-element f32 tensor on ``device`` (from a
    Python number, made there: no host copy, so a CUDA graph can capture
    the call; or from a one-element tensor), or None."""
    if out_scale is None:
        return None
    if isinstance(out_scale, torch.Tensor):
        return out_scale.reshape(1).to(device=device, dtype=torch.float32)
    return torch.full((1,), float(out_scale), dtype=torch.float32,
                      device=device)


def gemm_aie_plain(a: torch.Tensor, b: torch.Tensor, *,
                   bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None,
                   residual: Optional[torch.Tensor] = None,
                   out_dtype=None, b_scale: Optional[torch.Tensor] = None,
                   out_scale=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    gemm_aie_plain.launches += 1
    if out_dtype == torch.int32:  # the bare int32 sums, exactly
        return gemm_ref(a, b, out_dtype=torch.int32)
    return gemm_epilogue_ref(
        a, b, b_scale=b_scale, bias=bias, activation=activation,
        residual=residual, out_scale=out_scale_scalar(out_scale, a.device),
        out_dtype=out_dtype or torch.float32)


gemm_aie_plain.launches = 0


def gemm_cost(c, a, b, *, bias=None, residual=None, b_scale=None,
              out_scale=None, **_):
    """(FLOPs, boundary bytes) of one C = A @ B call with its epilogue
    operands (:mod:`repro_torch.core.op_cost`; B1's and B6's)."""
    m, k = a.shape
    return 2 * m * k * b.shape[1], op_cost.boundary(
        c, a, b, bias, residual, b_scale, out_scale)


@op_cost.scope("gemm_aie", gemm_cost)
def gemm_aie(a: torch.Tensor, b: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             activation: Optional[str] = None,
             residual: Optional[torch.Tensor] = None,
             out_dtype=None,
             b_scale: Optional[torch.Tensor] = None,
             out_scale=None) -> torch.Tensor:
    """C[m,n] = epilogue(sum_k A[m,k] B[k,n]) with b_scale (n,) ->
    bias (n,) -> activation -> residual (m,n) -> out-quant in f32.

    Operands: bf16 or f32 A and B; a bf16 or f32 A against an int8 B
    (W8A16: B widened to bf16 on chip, its per-column ``b_scale`` on the
    flush); int8 A and B (W8A8: int32 sums, ``b_scale`` on the flush).
    ``out_scale`` (a scalar) quantizes C to int8 after the epilogue:
    divide, round half to even, clip to +-127.  ``out_dtype`` defaults
    as the Pallas kernel's does (:func:`default_out_dtype`); ``ops.gemm``
    passes its own.  An int32 ``out_dtype`` (W8A8, nothing fused) gives
    the bare sums.
    """
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_aie: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    check_int8("gemm_aie", a, b, b_scale, n)
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias must hold {n} values, got {bias.shape}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} != ({m}, {n})")
    fused = any(x is not None for x in (b_scale, bias, activation,
                                        residual, out_scale))
    out_dtype = out_dtype or default_out_dtype(a.dtype, fused=fused,
                                               out_scale=out_scale)
    if out_dtype == torch.int32 and (fused or a.dtype != torch.int8):
        raise TypeError("gemm_aie: an int32 C holds the bare sums of an "
                        "int8 A, with nothing fused")
    if (out_dtype == torch.int8) != (out_scale is not None):
        raise TypeError("gemm_aie: an int8 C needs out_scale, and "
                        "out_scale an int8 C")
    if a.device.type == "cpu":
        return gemm_aie_plain(a, b, bias=bias, activation=activation,
                              residual=residual, out_dtype=out_dtype,
                              b_scale=b_scale, out_scale=out_scale)
    if a.device.type == "meta":
        _build.require_meta("gemm_aie", b, bias, residual, b_scale)
        return torch.empty((m, n), dtype=out_dtype, device="meta")
    osc = out_scale_scalar(out_scale, a.device)
    scale = scale_vector(b_scale, n)
    ops = [t for t in (a, b, bias, residual, scale, osc) if t is not None]
    _build.require_cuda("gemm_aie", *ops)
    check_cuda_pair("gemm_aie", a, b)
    a_code = _build.dtype_code(a.dtype, "gemm_aie A")
    b_code = _build.dtype_code(b.dtype, "gemm_aie B")
    out_code = _build.dtype_code(out_dtype, "gemm_aie out")
    res_code = 0
    if residual is not None:
        res_code = _build.dtype_code(residual.dtype, "gemm_aie residual")
        residual = residual.contiguous()
    a, b = a.contiguous(), b.contiguous()
    bias32 = bias.reshape(n).float().contiguous() if bias is not None \
        else None
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    config = _config(m, n, a.dtype, b.dtype) or _f32_config(m, n)
    # the staging copy modes of A and B at the launched CTA shape
    _, bk, bn = cta_tile(m, n, a.dtype, b.dtype)
    modes = _build.copy_mode(a, k, bk) | _build.copy_mode(b, n, bn) << 2
    ptr = _build.ptr
    rc = _build.entry("gemm_aie_launch", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), ptr(bias32), ptr(scale),
        ptr(residual), ptr(osc), m, n, k, a_code, b_code, out_code, res_code,
        ACT_CODES[activation], config, modes, _build.stream_of(a))
    _build.check(rc, "gemm_aie")
    gemm_aie.launches += 1
    return c


gemm_aie.launches = 0
