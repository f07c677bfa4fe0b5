"""A-stationary GEMM with the fused epilogue on its last chunk (kernel B6).

Replaces the Pallas kernel ``repro/kernels/gemm_tb.py`` ``gemm_tb``:
both its sites, ``_tb_call`` (pallas_call :96, body ``_gemm_tb_kernel``
:52) — one k-chunk accumulated onto C in place — and ``_tb_call_final``
(pallas_call :139, body ``_gemm_tb_final_kernel`` :65) — the last chunk
with bias -> activation -> residual, C written once at the out dtype —
with the hand-written CUDA kernel ``csrc/gemm_tb.cu`` (B6a and B6b).

K is chunked here on the host, as the JAX package does (gemm_tb.py:232):
``gk = cdiv(k, bk)`` launches, ``bk`` refined by :func:`feasible_bk`
against the sheet (and, for bf16, down to the tensor cores' k-depth of
16 when there are several chunks).  The f32 partial C is one
``torch.empty`` a call; with a single chunk only B6b runs.  Each C element
is the same chain over k = 0..K-1 as in kernel B1 — for bf16 operands
the m16n8k16 tensor-core chain of ``csrc/mma_chain.cuh``, each later
chunk starting from the stored f32 partial; for f32 operands the fmaf
chain of ``csrc/gemm_f32.cuh``, shared with B1, each of 256 threads a
block of chains — so ``gemm_tb`` equals
``gemm_aie`` bit for bit at any tile, chunk count and n split.

The bf16 chunks launch as programmatic dependents: a chunk's CTAs stage
the A panel and their first B tile while the chunk before it finishes,
and wait for it only before reading its partial.

The int8 paths are B1's (W8A16, W8A8, out-quant on the last chunk);
under an int8 A the partial between chunks is int32, as in the JAX
package, and exact, so B6 == B1 holds on every int8 path too.

Dispatch goes by device: a CPU tensor takes :func:`gemm_tb_plain`, a
meta tensor (a dry-run's trace) gets an empty result of the kernel's
shape and dtype and launches nothing, a CUDA tensor launches the kernel
or raises.  The wrapper is the ``gemm_tb`` scope of
:mod:`repro_torch.core.op_cost`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import memory_model, op_cost
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.core.tiling import GemmProblem, TileConfig, cdiv, \
    dtype_name
from repro_torch.kernels import _build, acc_dtype
from repro_torch.kernels.epilogue import ACT_CODES, Epilogue, \
    apply_epilogue
from repro_torch.kernels.gemm_aie import check_cuda_pair, check_int8, \
    gemm_cost, out_scale_scalar, scale_vector
from repro_torch.kernels.ref import int_dot

_ACC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 \
    + [ctypes.c_void_p]
_FINAL_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 \
    + [ctypes.c_void_p]
_SMEM_ARGTYPES = [ctypes.c_int] * 9
#: the k-depth of one tensor-core step of the bf16 body (m16n8k16) and of
#: the int8 x int8 body (m16n8k32), and the grid of the f32 body's k steps
MMA_K = 16
MMA_K_S8 = 32
F32_GRID = 32


def feasible_bk(m: int, k: int, n: int, tile: TileConfig, a_dtype,
                b_dtype, out_dtype, acc_dtype, epilogue: str = "",
                chip=HOPPER_H100) -> int:
    """Largest k-chunk <= ``tile.bk``, on the sheet's lane quantum, that
    keeps the A-stationary working set (resident (bm, bk) A panel,
    streamed B / C blocks, fused bias / residual blocks) inside the
    sheet's on-chip budget.  Where the sheet pads tiles (the TPU) the
    chunk must also divide K; on ``HOPPER_H100`` the last chunk may be
    ragged.  0 when no chunk fits."""
    p = GemmProblem(m, k, n, dtype_name(a_dtype), dtype_name(out_dtype),
                    dtype_name(acc_dtype), dtype_name(b_dtype), epilogue)
    for bk in range(min(tile.bk, k), 0, -chip.lane):
        if (k % bk == 0 or not chip.pads_tiles) and memory_model.fits_vmem(
                TileConfig(tile.bm, bk, tile.bn, "tb"), p, chip):
            return bk
    return 0


def _chunk(a, b, tile, out_dtype, bias, activation, residual,
           out_scale=None) -> int:
    """The k-chunk a call runs at, or ValueError when none fits."""
    m, k = a.shape
    n = b.shape[1]
    ep = Epilogue.from_args(bias, activation, residual, out_scale).key
    bk = feasible_bk(m, k, n, tile, a.dtype, b.dtype, out_dtype,
                     acc_dtype(a.dtype), ep)
    if bk == 0:
        raise ValueError(
            f"tb tile {tile} infeasible for ({m},{k},{n}) on "
            f"{HOPPER_H100.name}: no k-chunk keeps the (bm, bn) blocks "
            "inside shared memory — shrink the tile or use 'aie'")
    return min(tile.bk, bk)


def _out_dtype(a, out_dtype, fused, out_scale):
    """int8 under output quantization, f32 when anything is fused, else
    the accumulator's dtype (gemm_tb.py:214)."""
    if out_dtype is not None:
        return out_dtype
    if out_scale is not None:
        return torch.int8
    return torch.float32 if fused else acc_dtype(a.dtype)


def gemm_tb_plain(a: torch.Tensor, b: torch.Tensor, *, tile: TileConfig,
                  out_dtype=None, bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None,
                  b_scale: Optional[torch.Tensor] = None,
                  out_scale=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the same
    k-chunks accumulated in f32 (int32 for an int8 A, exactly; an int8 B
    under a float A widened first), then the dequant scale and the
    epilogue after the last one."""
    gemm_tb_plain.launches += 1
    fused = any(x is not None for x in (b_scale, bias, activation,
                                        residual, out_scale))
    out_dtype = _out_dtype(a, out_dtype, fused, out_scale)
    bk = _chunk(a, b, tile, out_dtype, bias, activation, residual,
                out_scale)
    k = a.shape[1]
    int8 = a.dtype == torch.int8
    c = torch.zeros((a.shape[0], b.shape[1]),
                    dtype=torch.int32 if int8 else torch.float32,
                    device=a.device)
    for k0 in range(0, k, bk):
        ac, bc = a[:, k0:k0 + bk], b[k0:k0 + bk]
        if int8:
            c = c + int_dot(ac, bc)
        else:
            c = c + ac.float() @ bc.to(a.dtype).float()
    if out_dtype == torch.int32:
        return c
    x = c.float()
    if b_scale is not None:
        x = x * b_scale.reshape(1, -1).float()
    x = apply_epilogue(x, activation=activation, bias=bias,
                       residual=residual,
                       out_scale=out_scale_scalar(out_scale, a.device))
    return x.to(out_dtype)


gemm_tb_plain.launches = 0


def n_split(gm: int, n_tiles: int, smem: int) -> int:
    """n tiles a CTA sweeps: an m-block's sweep is split over enough
    CTAs, each with its own copy of the A panel, to give every SM as many
    CTAs as its shared memory holds (``smem`` bytes a CTA), or one n tile
    a CTA, if fewer.  One wave of CTAs, each sweeping more tiles, beats
    two: a CTA streams the next tile during this one's products, and
    fewer CTAs copy the panel."""
    per_sm = max(1, HOPPER_H100.vmem_bytes // smem)
    ctas = min(n_tiles, max(1, cdiv(per_sm * HOPPER_H100.sm_count, gm)))
    return cdiv(n_tiles, ctas)


def smem_bytes(bm: int, bk: int, bn: int, a_dtype, res_dtype=None, *,
               b_dtype=None, scale: bool = False, bias: bool = False,
               residual: bool = False) -> int:
    """Dynamic shared memory B6 allocates for a tile (``tb_layout`` in
    ``csrc/gemm_tb.cuh``); equal to ``vmem_footprint`` on
    ``HOPPER_H100`` whenever the residual's dtype is the out dtype."""
    fn = _build.entry("gemm_tb_smem_bytes", _SMEM_ARGTYPES)
    return fn(bm, bk, bn, _build.dtype_code(a_dtype, "gemm_tb A"),
              _build.dtype_code(b_dtype or a_dtype, "gemm_tb B"),
              _build.dtype_code(res_dtype or torch.float32,
                                "gemm_tb residual"),
              int(scale), int(bias), int(residual))


@op_cost.scope("gemm_tb", gemm_cost)
def gemm_tb(a: torch.Tensor, b: torch.Tensor, *, tile: TileConfig,
            out_dtype=None, bias: Optional[torch.Tensor] = None,
            activation: Optional[str] = None,
            residual: Optional[torch.Tensor] = None,
            b_scale: Optional[torch.Tensor] = None,
            out_scale=None,
            n_split_tiles: Optional[int] = None) -> torch.Tensor:
    """C[m,n] = epilogue(sum_k A[m,k] B[k,n]), A-stationary, with
    b_scale (n,) -> bias (n,) -> activation -> residual (m,n) ->
    out-quant in f32 on the last k-chunk.

    Operands as :func:`repro_torch.kernels.gemm_aie.gemm_aie`'s (float
    A and B, W8A16, W8A8); under an int8 A the partial between chunks is
    int32.  ``tile`` is the plan's (bm, bk, bn); ``bk`` is refined by
    :func:`feasible_bk`.  ``out_dtype`` defaults to int8 under
    ``out_scale``, f32 when anything is fused (gemm_tb.py:214), else the
    accumulator's dtype.  ``n_split_tiles`` sets how many n tiles one
    CTA sweeps (default :func:`n_split`); it changes no bit of C.
    """
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_tb: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    check_int8("gemm_tb", a, b, b_scale, n)
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias must hold {n} values, got {bias.shape}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} != ({m}, {n})")
    fused = any(x is not None for x in (b_scale, bias, activation,
                                        residual, out_scale))
    out_dtype = _out_dtype(a, out_dtype, fused, out_scale)
    if out_dtype == torch.int32 and (fused or a.dtype != torch.int8):
        raise TypeError("gemm_tb: an int32 C holds the bare sums of an "
                        "int8 A, with nothing fused")
    if (out_dtype == torch.int8) != (out_scale is not None):
        raise TypeError("gemm_tb: an int8 C needs out_scale, and "
                        "out_scale an int8 C")
    if a.device.type == "cpu":
        return gemm_tb_plain(a, b, tile=tile, out_dtype=out_dtype,
                             bias=bias, activation=activation,
                             residual=residual, b_scale=b_scale,
                             out_scale=out_scale)
    if a.device.type == "meta":
        _build.require_meta("gemm_tb", b, bias, residual, b_scale)
        return torch.empty((m, n), dtype=out_dtype, device="meta")
    osc = out_scale_scalar(out_scale, a.device)
    scale = scale_vector(b_scale, n)
    ops = [t for t in (a, b, bias, residual, scale, osc) if t is not None]
    _build.require_cuda("gemm_tb", *ops)
    check_cuda_pair("gemm_tb", a, b)
    bk = _chunk(a, b, tile, out_dtype, bias, activation, residual,
                out_scale)
    bm, bn = tile.bm, tile.bn
    if not HOPPER_H100.launchable(bm, bn, dtype_name(a.dtype),
                                  dtype_name(b.dtype)):
        raise ValueError(f"gemm_tb: a ({bm}, {bn}) C tile does not map "
                         "onto the kernel's CTAs (bf16: at most 128 x 256; "
                         "int8: 256 threads, bn <= 256, at most 4 m16 x n8 "
                         "fragments a warp; f32: 256 threads of 1 to 16 "
                         "chains, edges powers of two, 8-128 x 32-256)")
    if a.dtype == torch.bfloat16 and bk < k:
        # the chunks continue one tensor-core chain: boundaries on its k-grid
        bk = max(MMA_K, bk - bk % MMA_K)
    elif a.dtype == torch.float32 and bk < k:
        # the f32 body reads its panel and B in steps of F32_GRID: chunk
        # boundaries on that grid keep a step from crossing one
        bk = max(F32_GRID, bk - bk % F32_GRID)
    elif a.dtype == torch.bfloat16 and b.dtype == torch.int8:
        # one chunk, its int8 tile zero-filled to the 16-grid
        bk = cdiv(k, MMA_K) * MMA_K
    if a.dtype == torch.int8:
        # the int8 panel is read in 32-byte k-steps: its width, and every
        # chunk boundary, on that grid
        bk = max(MMA_K_S8, bk - bk % MMA_K_S8) if bk < k \
            else cdiv(k, MMA_K_S8) * MMA_K_S8
    if b.dtype == torch.int8 and bn % (4 if a.dtype == torch.int8 else 16):
        raise ValueError(f"gemm_tb: an int8 B tile is read in 16-column "
                         f"groups (W8A16) or transposed four columns at a "
                         f"time (W8A8); bn {bn} does not fit")
    a_code = _build.dtype_code(a.dtype, "gemm_tb A")
    b_code = _build.dtype_code(b.dtype, "gemm_tb B")
    out_code = _build.dtype_code(out_dtype, "gemm_tb out")
    res_code = 0
    if residual is not None:
        res_code = _build.dtype_code(residual.dtype, "gemm_tb residual")
        residual = residual.contiguous()
    smem = smem_bytes(bm, bk, bn, a.dtype,
                      residual.dtype if residual is not None else None,
                      b_dtype=b.dtype, scale=scale is not None,
                      bias=bias is not None, residual=residual is not None)
    if smem > HOPPER_H100.vmem_bytes:
        raise ValueError(f"gemm_tb: tile ({bm}, {bk}, {bn}) needs {smem} "
                         f"bytes of shared memory, over the "
                         f"{HOPPER_H100.vmem_bytes} one CTA can take")
    a, b = a.contiguous(), b.contiguous()
    bias32 = bias.reshape(n).float().contiguous() if bias is not None \
        else None
    n_tiles = cdiv(n, bn)
    per_cta = n_split_tiles or n_split(cdiv(m, bm), n_tiles, smem)
    stream = _build.stream_of(a)
    gk = cdiv(k, bk)
    part = torch.empty((m, n), dtype=acc_dtype(a.dtype), device=a.device) \
        if gk > 1 else None
    # 2 bits an operand: A, B, the partial C, bias, residual, b_scale
    mode = _build.copy_mode
    modes = (mode(a, k, bk) | mode(b, n, bn) << 2 | mode(part, n, bn) << 4
             | mode(bias32, 0, bn) << 6 | mode(residual, n, bn) << 8
             | mode(scale, 0, bn) << 10)
    ptr = _build.ptr
    for i in range(gk - 1):
        rc = _build.entry("gemm_tb_accumulate_launch", _ACC_ARGTYPES)(
            a.data_ptr(), b.data_ptr(), ptr(part) if i else None,
            part.data_ptr(), m, n, k, i * bk, bk, bm, bk, bn, per_cta,
            a_code, b_code, res_code, int(scale is not None),
            int(bias is not None), int(residual is not None), modes, stream)
        _build.check(rc, "gemm_tb")
        gemm_tb.launches += 1
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    k0 = (gk - 1) * bk
    rc = _build.entry("gemm_tb_final_launch", _FINAL_ARGTYPES)(
        a.data_ptr(), b.data_ptr(), ptr(part), c.data_ptr(), ptr(bias32),
        ptr(scale), ptr(residual), ptr(osc), m, n, k, k0, k - k0, bm, bk,
        bn, per_cta, a_code, b_code, out_code, res_code,
        ACT_CODES[activation], modes, stream)
    _build.check(rc, "gemm_tb final chunk")
    gemm_tb.final_launches += 1
    return c


#: B6a (accumulate chunks) and B6b (final chunk) launches
gemm_tb.launches = 0
gemm_tb.final_launches = 0
