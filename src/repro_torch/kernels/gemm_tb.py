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
chain — so ``gemm_tb`` equals ``gemm_aie`` bit for bit at any tile, chunk
count and n split.

The bf16 chunks launch as programmatic dependents: a chunk's CTAs stage
the A panel and their first B tile while the chunk before it finishes,
and wait for it only before reading its partial.

Dispatch goes by device: a CPU tensor takes :func:`gemm_tb_plain`, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import memory_model
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.core.tiling import GemmProblem, TileConfig, cdiv, \
    dtype_name
from repro_torch.kernels import _build, acc_dtype
from repro_torch.kernels.epilogue import ACT_CODES, Epilogue, \
    apply_epilogue

_ACC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 \
    + [ctypes.c_void_p]
_FINAL_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 \
    + [ctypes.c_void_p]
_SMEM_ARGTYPES = [ctypes.c_int] * 7
#: the k-depth of one tensor-core step of the bf16 body (m16n8k16)
MMA_K = 16


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


def _chunk(a, b, tile, out_dtype, bias, activation, residual) -> int:
    """The k-chunk a call runs at, or ValueError when none fits."""
    m, k = a.shape
    n = b.shape[1]
    ep = Epilogue.from_args(bias, activation, residual).key
    bk = feasible_bk(m, k, n, tile, a.dtype, b.dtype, out_dtype,
                     acc_dtype(a.dtype), ep)
    if bk == 0:
        raise ValueError(
            f"tb tile {tile} infeasible for ({m},{k},{n}) on "
            f"{HOPPER_H100.name}: no k-chunk keeps the (bm, bn) blocks "
            "inside shared memory — shrink the tile or use 'aie'")
    return min(tile.bk, bk)


def _out_dtype(a, out_dtype, bias, activation, residual):
    """f32 when anything is fused, else the accumulator's dtype
    (gemm_tb.py:214)."""
    if out_dtype is not None:
        return out_dtype
    fused = bias is not None or activation is not None \
        or residual is not None
    return torch.float32 if fused else acc_dtype(a.dtype)


def gemm_tb_plain(a: torch.Tensor, b: torch.Tensor, *, tile: TileConfig,
                  out_dtype=None, bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the same
    k-chunks accumulated in f32, the epilogue after the last one."""
    gemm_tb_plain.launches += 1
    out_dtype = _out_dtype(a, out_dtype, bias, activation, residual)
    bk = _chunk(a, b, tile, out_dtype, bias, activation, residual)
    k = a.shape[1]
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                    device=a.device)
    for k0 in range(0, k, bk):
        c = c + a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    x = apply_epilogue(c, activation=activation, bias=bias,
                       residual=residual)
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


def smem_bytes(bm: int, bk: int, bn: int, in_dtype, res_dtype=None, *,
               bias: bool = False, residual: bool = False) -> int:
    """Dynamic shared memory B6 allocates for a tile (``tb_layout`` in
    ``csrc/gemm_tb.cu``); equal to ``vmem_footprint`` on
    ``HOPPER_H100`` whenever the residual's dtype is the out dtype."""
    fn = _build.entry("gemm_tb_smem_bytes", _SMEM_ARGTYPES)
    return fn(bm, bk, bn, _build.dtype_code(in_dtype, "gemm_tb A"),
              _build.dtype_code(res_dtype or torch.float32,
                                "gemm_tb residual"),
              int(bias), int(residual))


def gemm_tb(a: torch.Tensor, b: torch.Tensor, *, tile: TileConfig,
            out_dtype=None, bias: Optional[torch.Tensor] = None,
            activation: Optional[str] = None,
            residual: Optional[torch.Tensor] = None,
            n_split_tiles: Optional[int] = None) -> torch.Tensor:
    """C[m,n] = epilogue(sum_k A[m,k] B[k,n]), A-stationary, with bias
    (n,) -> activation -> residual (m,n) in f32 on the last k-chunk.

    ``tile`` is the plan's (bm, bk, bn); ``bk`` is refined by
    :func:`feasible_bk`.  ``out_dtype`` defaults to f32 when anything is
    fused (gemm_tb.py:214).  ``n_split_tiles`` sets how many n tiles one
    CTA sweeps (default :func:`n_split`); it changes no bit of C.
    """
    if a.dtype == torch.int8 or b.dtype == torch.int8:
        raise NotImplementedError(
            "int8 operands / b_scale dequant arrive with ROADMAP queue A8")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_tb: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias must hold {n} values, got {bias.shape}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} != ({m}, {n})")
    out_dtype = _out_dtype(a, out_dtype, bias, activation, residual)
    if a.device.type == "cpu":
        return gemm_tb_plain(a, b, tile=tile, out_dtype=out_dtype,
                             bias=bias, activation=activation,
                             residual=residual)
    ops = [t for t in (a, b, bias, residual) if t is not None]
    _build.require_cuda("gemm_tb", *ops)
    if a.dtype != b.dtype:
        raise TypeError(f"gemm_tb: A {a.dtype} and B {b.dtype} differ")
    bk = _chunk(a, b, tile, out_dtype, bias, activation, residual)
    bm, bn = tile.bm, tile.bn
    if not HOPPER_H100.launchable(bm, bn):
        raise ValueError(f"gemm_tb: a ({bm}, {bn}) C tile does not map "
                         "onto the kernel's 256 threads (bn <= 256; bf16: "
                         "at most 4 m16 x n8 fragments a warp, f32: at "
                         "most 16 rows a thread)")
    if a.dtype == torch.bfloat16 and bk < k:
        # the chunks continue one tensor-core chain: boundaries on its k-grid
        bk = max(MMA_K, bk - bk % MMA_K)
    in_code = _build.dtype_code(a.dtype, "gemm_tb A")
    out_code = _build.dtype_code(out_dtype, "gemm_tb out")
    res_code = 0
    if residual is not None:
        res_code = _build.dtype_code(residual.dtype, "gemm_tb residual")
        residual = residual.contiguous()
    smem = smem_bytes(bm, bk, bn, a.dtype,
                      residual.dtype if residual is not None else None,
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
    part = torch.empty((m, n), dtype=torch.float32, device=a.device) \
        if gk > 1 else None
    # 2 bits an operand: A, B, the f32 partial C, bias, residual
    mode = _build.copy_mode
    modes = (mode(a, k, bk) | mode(b, n, bn) << 2 | mode(part, n, bn) << 4
             | mode(bias32, 0, bn) << 6 | mode(residual, n, bn) << 8)
    for i in range(gk - 1):
        rc = _build.entry("gemm_tb_accumulate_launch", _ACC_ARGTYPES)(
            a.data_ptr(), b.data_ptr(),
            part.data_ptr() if i else None, part.data_ptr(),
            m, n, k, i * bk, bk, bm, bk, bn, per_cta, in_code, res_code,
            int(bias is not None), int(residual is not None), modes,
            stream)
        _build.check(rc, "gemm_tb")
        gemm_tb.launches += 1
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    k0 = (gk - 1) * bk
    rc = _build.entry("gemm_tb_final_launch", _FINAL_ARGTYPES)(
        a.data_ptr(), b.data_ptr(),
        part.data_ptr() if part is not None else None, c.data_ptr(),
        bias32.data_ptr() if bias32 is not None else None,
        residual.data_ptr() if residual is not None else None,
        m, n, k, k0, k - k0, bm, bk, bn, per_cta, in_code, out_code,
        res_code, ACT_CODES[activation], modes, stream)
    _build.check(rc, "gemm_tb final chunk")
    gemm_tb.final_launches += 1
    return c


#: B6a (accumulate chunks) and B6b (final chunk) launches
gemm_tb.launches = 0
gemm_tb.final_launches = 0
