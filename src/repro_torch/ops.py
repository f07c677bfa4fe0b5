"""``repro_torch.ops`` — the public operator API (port of ``repro/ops.py``).

The GEMM family is the planned pipeline of
:mod:`repro_torch.kernels.api`:

    spec = ops.GemmSpec.for_operands(x, w, residual=r)   # or GemmSpec(...)
    pl   = ops.plan(spec, ops.gemm_shapes(x, w))         # cached, once
    y    = ops.execute(pl, x, w, residual=r)
    print(pl.explain())                  # kernel, source, tile, modeled cost

or the one-shot form every model layer calls (the same plans):

    y = ops.gemm(x, w, residual=r)

The planner runs the paper's tiling search on the ``HOPPER_H100`` sheet
and picks, per GEMM shape, the output-stationary dataflow (kernel B1,
``gemm_aie``) or the A-stationary one (kernel B6, ``gemm_tb``); a gated
GEMM runs kernel B2 (``gemm_gated``), and the MoE experts' grouped
ragged GEMM (``gemm_grouped(xs, bank, group_sizes)``, planned with
``gemm_grouped_shapes``) kernel B7.  A repeated one-shot call costs one
tuple key and one dict lookup before its launch.

Attention keeps the JAX package's one-shot entry points
(``attention``, ``decode_attention``, ``decode_attention_paged``); their
planner (``AttnSpec``) arrives with the rest of ROADMAP queue A6.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.tiling import TileConfig  # noqa: F401
from repro_torch.kernels.api import (  # noqa: F401
    GemmPlan,
    GemmSpec,
    PlanCacheInfo,
    execute,
    gemm,
    gemm_grouped,
    gemm_grouped_shapes,
    gemm_shapes,
    plan,
    plan_cache_clear,
    plan_cache_info,
    plans,
    solve_topk,
)
from repro_torch.kernels.epilogue import ACTIVATIONS, Epilogue  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_paged)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None,
              q_offset: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention with GQA and an optional sliding window.
    q: (b, sq, hq, d); k/v: (b, skv, hkv, d) -> (b, sq, hq, d)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention over a dense KV cache.  q: (b, hq, d);
    caches: (b, S, hkv, d); pos: (b,) int32 -> (b, hq, d)."""
    return flash_decode(q, k_cache, v_cache, pos, window=window)


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos, *, window: int = 0) -> torch.Tensor:
    """Single-token attention over a shared page pool.  q: (b, hq, d);
    pools: (n_pages, page_size, hkv, d); page_table: (b, max_pages)
    int32; pos: (b,) int32 -> (b, hq, d)."""
    return flash_decode_paged(q, k_pages, v_pages, page_table, pos,
                              window=window)
