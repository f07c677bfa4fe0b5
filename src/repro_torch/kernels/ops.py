"""Legacy kernel entry points (port of ``repro/kernels/ops.py``).

Every family has a planned API: the GEMMs ``GemmSpec`` -> ``plan`` ->
``execute`` (:mod:`repro_torch.kernels.api`), attention ``AttnSpec`` ->
``attn_plan`` -> ``attn_execute`` (:mod:`repro_torch.kernels.attn_api`),
both re-exported as :mod:`repro_torch.ops`.  Each function below is a
deprecated shim that warns and delegates to the planned one-shot, so its
result is bit for bit the planned path's.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.kernels import api, attn_api
from repro_torch.kernels import ref as _ref


def _warn(name: str) -> None:
    warnings.warn(
        f"repro_torch.kernels.ops.{name} is deprecated; use repro_torch.ops "
        "(the planned Spec / plan / execute APIs or their one-shots)",
        DeprecationWarning, stacklevel=3)


def gemm(a, b, *, strategy=None, tile=None, out_dtype=None):
    """Deprecated shim: C = A @ B through the planned GemmSpec API
    (``b`` may be a ``{"q", "scale"}`` int8 weight struct)."""
    _warn("gemm")
    return api.gemm(a, b, strategy=strategy, tile=tile,
                    out_dtype=out_dtype)


def gemm_fused(a, b, *, bias=None, activation=None, residual=None,
               out_scale=None, strategy=None, tile=None, out_dtype=None):
    """Deprecated shim: epilogue-fused GEMM through the planned API."""
    _warn("gemm_fused")
    return api.gemm(a, b, bias=bias, activation=activation,
                    residual=residual, out_scale=out_scale,
                    strategy=strategy, tile=tile, out_dtype=out_dtype)


def gemm_gated(a, b_gate, b_up, *, activation="silu", tile=None,
               out_dtype=None):
    """Deprecated shim: dual-B gated GEMM through the planned API."""
    _warn("gemm_gated")
    return api.gemm(a, b_gate, b2=b_up, activation=activation, tile=tile,
                    out_dtype=out_dtype)


def gemm_int8(a_q, b_q, a_scale, b_scale, *, out_dtype=torch.float32,
              tile=None):
    """Deprecated shim: raw int8 x int8 GEMM (int32 accumulation, scales
    applied outside) through the planned API."""
    _warn("gemm_int8")
    acc = api.gemm(a_q, b_q, tile=tile, out_dtype=torch.int32)
    return (acc.float() * a_scale * b_scale).to(out_dtype)


quantize_int8 = _ref.quantize_int8
dequantize = _ref.dequantize


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale=None, q_offset=None) -> torch.Tensor:
    """Deprecated shim: prefill attention through the planned AttnSpec
    API."""
    _warn("attention")
    return attn_api.attention(q, k, v, causal=causal, window=window,
                              scale=scale, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos, *,
                     window: int = 0) -> torch.Tensor:
    """Deprecated shim: dense-cache decode attention through the planned
    AttnSpec API."""
    _warn("decode_attention")
    return attn_api.decode_attention(q, k_cache, v_cache, pos,
                                     window=window)


def decode_attention_paged(q, k_pages, v_pages, page_table, pos, *,
                           window: int = 0) -> torch.Tensor:
    """Deprecated shim: paged-pool decode attention through the planned
    AttnSpec API."""
    _warn("decode_attention_paged")
    return attn_api.decode_attention_paged(q, k_pages, v_pages,
                                           page_table, pos, window=window)
