"""One-shot operator entry points every model layer calls.

The counterparts of ``repro.ops.gemm`` / ``attention`` /
``decode_attention`` with the same arguments.  The JAX package plans
each call (Spec -> Plan -> Execute, the DSE's choice between the
output-stationary and the A-stationary dataflow); that planner arrives
with ROADMAP queue A6.  Until then every non-gated GEMM takes
``gemm_aie``, which computes the same function the A-stationary kernel
would (api.py:666).  The CUDA kernels mask ragged edges themselves, so
nothing is padded here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_paged)
from repro_torch.kernels.gemm_aie import gemm_aie
from repro_torch.kernels.gemm_gated import gemm_gated


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         b2: Optional[torch.Tensor] = None,
         bias: Optional[torch.Tensor] = None,
         activation: Optional[str] = None,
         residual: Optional[torch.Tensor] = None,
         out_dtype=None, b_scale=None) -> torch.Tensor:
    """C = epilogue(A @ B) over A's leading dims.

    * ``gemm(a, b)`` — C = A @ B;
    * ``gemm(a, b, bias=..., activation=..., residual=...)`` — the
      epilogue on the kernel's flush;
    * ``gemm(a, b_gate, b2=b_up, activation="silu")`` — the gated pair.

    The output dtype is ``out_dtype or a.dtype`` (api.py:539), unlike
    the raw ``gemm_aie`` whose default is f32.
    """
    if b_scale is not None or isinstance(b, dict):
        raise NotImplementedError(
            "int8 weight structs / b_scale arrive with ROADMAP queue A8")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    out_dtype = out_dtype or a.dtype
    if b2 is not None:
        if bias is not None or residual is not None:
            raise ValueError("the gated GEMM takes no bias or residual")
        out = gemm_gated(a2, b, b2, activation=activation,
                         out_dtype=out_dtype)
    else:
        res2 = residual.reshape(-1, b.shape[1]) \
            if residual is not None else None
        out = gemm_aie(a2, b, bias=bias, activation=activation,
                       residual=res2, out_dtype=out_dtype)
    return out.reshape(*lead, b.shape[1])


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
