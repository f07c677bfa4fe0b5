"""Plain PyTorch oracles (port of ``repro/kernels/ref.py``).

These are the CPU execution path of every kernel wrapper and the
references the CUDA kernels are held against on the card.  Operands are
widened to f32 before each product: a bf16 x bf16 product is exact in
f32, so this is the same arithmetic as the JAX package's storage-dtype
dots with ``preferred_element_type=f32``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.epilogue import ACTIVATIONS, apply_epilogue

NEG_INF = -1e30          # large-negative for masking (bf16-safe)


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 sums of an int8 x int8 product, exactly: f64 holds every
    partial sum of int8 products exactly (|sum| < 2^31 < 2^53), so any
    summation order gives the same integers, on any device (CUDA has no
    int32 matmul)."""
    return (a.double() @ b.double()).to(torch.int32)


def gemm_ref(a: torch.Tensor, b: torch.Tensor, *,
             acc_dtype=torch.float32, out_dtype=None) -> torch.Tensor:
    """C = A @ B with explicit accumulation dtype: int8 x int8
    accumulates in int32, floats in f32."""
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        return int_dot(a, b).to(out_dtype or torch.int32)
    out = (a.to(acc_dtype) @ b.to(acc_dtype)).to(acc_dtype)
    return out.to(out_dtype or acc_dtype)


def quantize_int8(x: torch.Tensor, axis: int = -1):
    """Symmetric per-channel int8 quantization -> (q, scale): the scale
    is amax / 127 over ``axis`` (1 where the amax is 0), q the values
    divided by it, rounded half to even and clipped to +-127."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def gemm_fused_ref(a: torch.Tensor, b_q: torch.Tensor,
                   b_scale: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Oracle of the fused weight dequant: B stays int8 through the
    product, its (1, n) scale multiplies the accumulator once (W8A16: f32
    accumulation; W8A8: int8 operands, int32 accumulation)."""
    return (_acc_f32(a, b_q) * b_scale.float()).to(out_dtype
                                                   or torch.float32)


def gemm_int8_ref(a_q: torch.Tensor, b_q: torch.Tensor,
                  a_scale: torch.Tensor, b_scale: torch.Tensor,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Quantized GEMM: int8 operands, int32 accumulation, the (m, 1) row
    and (1, n) column scales applied after."""
    acc = int_dot(a_q, b_q)
    return (acc.float() * a_scale * b_scale).to(out_dtype)


def _acc_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Accumulate A @ B into f32 the way the kernels do: int8 x int8 in
    int32 then widened; a float A sees B widened to its dtype first."""
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        return int_dot(a, b).float()
    if b.dtype == torch.int8:
        b = b.to(a.dtype)
    return a.float() @ b.float()


def gemm_epilogue_ref(a: torch.Tensor, b: torch.Tensor, *,
                      b_scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None,
                      residual: Optional[torch.Tensor] = None,
                      out_scale: Optional[torch.Tensor] = None,
                      out_dtype=None) -> torch.Tensor:
    """Oracle for the fused-epilogue flush: accumulate, optional
    per-output-channel dequant scale, then bias -> activation ->
    residual -> output quantization, all in f32.  Default output f32
    (int8 with ``out_scale``)."""
    x = _acc_f32(a, b)
    if b_scale is not None:
        x = x * b_scale.float()
    x = apply_epilogue(x, activation=activation, bias=bias,
                       residual=residual, out_scale=out_scale)
    if out_dtype is None:
        out_dtype = torch.int8 if out_scale is not None else torch.float32
    return x.to(out_dtype)


def gemm_gated_ref(a: torch.Tensor, b_gate: torch.Tensor,
                   b_up: torch.Tensor, *, activation: str = "silu",
                   bg_scale: Optional[torch.Tensor] = None,
                   bu_scale: Optional[torch.Tensor] = None,
                   out_dtype=None) -> torch.Tensor:
    """Oracle for the dual-B gated kernel: ``act(A @ B_gate) * (A @
    B_up)`` in f32; default output A's dtype (f32 for int8 A)."""
    xg = _acc_f32(a, b_gate)
    xu = _acc_f32(a, b_up)
    if bg_scale is not None:
        xg = xg * bg_scale.float()
        xu = xu * bu_scale.float()
    out = ACTIVATIONS[activation](xg) * xu
    if out_dtype is None:
        out_dtype = a.dtype if a.dtype != torch.int8 else torch.float32
    return out.to(out_dtype)


def gemm_grouped_ref(a: torch.Tensor, b: torch.Tensor,
                     group_sizes: torch.Tensor, *,
                     b_scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None,
                     out_dtype=None) -> torch.Tensor:
    """Oracle (and CPU path) of the grouped ragged GEMM:
    ``C[r] = epilogue(A[r] @ B[g(r)])`` with ``g(r)`` the group owning
    row ``r`` of the group-sorted ``a`` under ``group_sizes``.

    One full-k f32 matmul per group over the group's own rows (groups
    are contiguous, so the other groups' rows are masked out by slicing;
    the JAX oracle computes every row and selects), then the epilogue
    with the per-expert ``bias`` ((E, n) or (E, 1, n)).  Rows at and
    beyond ``sum(group_sizes)`` come back zero.  The group ends are read
    on the host."""
    m = a.shape[0]
    e, _, n = b.shape
    out = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    start = 0
    for g, end in enumerate(torch.cumsum(group_sizes.to(torch.int64), 0)
                            .tolist()):
        end = min(end, m)
        if end > start:
            z = _acc_f32(a[start:end], b[g])
            if b_scale is not None:
                z = z * b_scale.reshape(e, n)[g].float()
            out[start:end] = apply_epilogue(
                z, activation=activation,
                bias=bias.reshape(e, n)[g] if bias is not None else None)
        start = max(start, end)
    return out.to(out_dtype or torch.float32)


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """(b,) int32 per-slot positions; a scalar broadcasts."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return p.expand(b) if p.dim() == 0 else p


def _decode_mask(pos: torch.Tensor, skv: int, window: int) -> torch.Tensor:
    k_pos = torch.arange(skv, device=pos.device)
    mask = k_pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > pos[:, None] - window
    return mask                                        # (b, skv)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos, *, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention over a cache, all in f32.

    q: (b, hq, d); caches: (b, S, hkv, d); pos: (b,) int32 per-slot
    positions (a scalar broadcasts) — row i masks slots > pos[i]; a
    sliding window masks slots <= pos[i] - window.  Returns (b, hq, d).
    """
    b, hq, d = q.shape
    _, skv, hkv, _ = k_cache.shape
    groups = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, groups, d).float() * scale
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    mask = _decode_mask(_pos_vector(pos, b, q.device), skv, window)
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_paged_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               page_table: torch.Tensor, pos, *,
                               window: int = 0) -> torch.Tensor:
    """Single-token attention over a page pool, all in f32
    (``attn_api._decode_attention_paged_xla``): each row's pages are
    gathered back into a dense (b, max_pages * page_size, hkv, d) view
    and attended by :func:`decode_attention_ref`.  With the gathered
    length equal to a dense cache's length the result is the dense
    result, bit for bit.

    q: (b, hq, d); pools: (n_pages, page_size, hkv, d); page_table:
    (b, max_pages) int32; pos: (b,) int32 (a scalar broadcasts)."""
    _, ps, hkv, d = k_pages.shape
    b, max_pages = page_table.shape
    idx = page_table.long()
    k = k_pages[idx].reshape(b, max_pages * ps, hkv, d)
    v = v_pages[idx].reshape(b, max_pages * ps, hkv, d)
    return decode_attention_ref(q, k, v, pos, window=window)


def decode_attention_xla(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos, *,
                         window: int = 0) -> torch.Tensor:
    """The storage-dtype decode path (``attn_api._decode_attention_xla``):
    the probabilities are rounded to the cache dtype before the PV
    product, as the JAX package's XLA path does; products accumulate in
    f32 and the cache itself is never kept in f32."""
    b, hq, d = q.shape
    _, skv, hkv, _ = k_cache.shape
    groups = hq // hkv
    qg = q.reshape(b, hkv, groups, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k_cache.float()) * d ** -0.5
    mask = _decode_mask(_pos_vector(pos, b, q.device), skv, window)
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.float(), v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)


def _window_mask(q_len: int, kv_len: int, *, causal: bool, window: int,
                 q_offset: int, device) -> torch.Tensor:
    """(q_len, kv_len) boolean mask; ``window`` <= 0 means unbounded."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with GQA + sliding window, softmax in f32.

    q: (b, sq, hq, d); k, v: (b, skv, hkv, d) with hq % hkv == 0.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    groups = hq // hkv
    if q_offset is None:
        q_offset = skv - sq
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = _window_mask(sq, skv, causal=causal, window=window,
                        q_offset=q_offset, device=q.device)
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)
