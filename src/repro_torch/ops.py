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

Attention is the same framework (:mod:`repro_torch.kernels.attn_api`):

    spec = ops.AttnSpec(mode="decode", group=4)
    pl   = ops.attn_plan(spec, (b, skv, hq, hkv, d))   # device: the card
    o    = ops.attn_execute(pl, q, k_cache, v_cache, pos=pos)
    print(pl.explain())        # B3 / B4 / B5, its source, the plain path

with the one-shots ``ops.attention`` / ``ops.decode_attention`` /
``ops.decode_attention_paged`` building the spec from live operands: a
prefill plans kernel B3, a decode B4, a paged decode B5.  With grad mode
on every mode runs inside one autograd Function (``attn_api._AttnCore``),
whose backward recomputes through the plain reference composition.  The
pre-redesign entry points live on as deprecated shims in
:mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

from repro_torch.core.tiling import TileConfig  # noqa: F401
from repro_torch.kernels.api import (  # noqa: F401
    GemmPlan,
    GemmSpec,
    PlanCacheInfo,
    TunedInfo,
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
from repro_torch.kernels.attn_api import (  # noqa: F401
    BLOCKED_ATTN_THRESHOLD,
    AttnPlan,
    AttnPlanCacheInfo,
    AttnProblem,
    AttnSpec,
    attention,
    attn_execute,
    attn_plan,
    attn_plan_cache_clear,
    attn_plan_cache_info,
    attn_plans,
    attn_solve_topk,
    decode_attention,
    decode_attention_paged,
)
from repro_torch.kernels.epilogue import ACTIVATIONS, Epilogue  # noqa: F401
from repro_torch.kernels.ref import dequantize, quantize_int8  # noqa: F401
