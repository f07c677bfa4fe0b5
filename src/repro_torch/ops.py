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
Prefill ``attention`` is differentiable: with grad mode on it runs
inside :class:`_AttnCore` (the prefill half of the JAX package's
``_attn_core`` custom VJP), kernel B3 forward, a backward that
recomputes through the plain reference (the blocked one past
``BLOCKED_ATTN_THRESHOLD`` positions).
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
from repro_torch.kernels.blocked_attention import (BLOCKED_ATTN_THRESHOLD,
                                                   attention_blocked)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_paged)
from repro_torch.kernels.ref import attention_ref


class _AttnCore(torch.autograd.Function):
    """Prefill attention, forward on kernel B3 (its plain version on the
    CPU), backward by recomputing through the differentiable reference
    composition and pulling the cotangent through it: B3 is forward-only,
    as the Pallas kernel is (``repro/kernels/attn_api.py:849-899``).
    Past ``BLOCKED_ATTN_THRESHOLD`` positions the recompute is the
    blocked one, so no (b, hq, sq, skv) scores are materialized."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        q_offset=q_offset)
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        fwd = attention_blocked if max(q.shape[1], k.shape[1]) \
            > BLOCKED_ATTN_THRESHOLD else attention_ref
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fwd(*qkv, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None,
              q_offset: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention with GQA and an optional sliding window.
    q: (b, sq, hq, d); k/v: (b, skv, hkv, d) -> (b, sq, hq, d).  With
    grad mode off (serving) B3 is called directly, as ``api._run``
    dispatches a GEMM: the Functions cost the host-bound serving path
    time (``tools/dispatch_probe.py``)."""
    if torch.is_grad_enabled():
        return _AttnCore.apply(q, k, v, causal, window, scale, q_offset)
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
