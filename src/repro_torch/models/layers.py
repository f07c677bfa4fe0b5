"""Shared model layers (port of ``repro/models/layers.py``): RMS norm
and LayerNorm, rotary embeddings, the SwiGLU and GELU MLPs, GQA
self-attention over a dense per-slot KV cache or a shared page pool,
cross-attention over an encoder's output, embeddings, and the chunked
cross-entropy of training.

Parameters are plain dicts of tensors in the JAX layout ((d_in, d_out)
weights); a projection may be a quantized ``{"q", "scale"}`` struct
(:mod:`repro_torch.quant`).  Every projection goes through
:func:`repro_torch.ops.gemm`, so on a card each one launches a
hand-written kernel, on its int8 path for a quantized weight.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import ops


#: elements drawn at once in f32 by :func:`normal_init`: a larger leaf is
#: drawn in slices of this many into its output, so a full-width bank
#: (kimi-k2's 384 experts: 5.6e9 elements a bank) never has a whole f32
#: copy beside it on the card
DRAW_CHUNK = 1 << 28


def normal_init(generator: torch.Generator, shape, std: float, dtype
                ) -> torch.Tensor:
    """N(0, std^2) values of ``shape``, drawn in f32, scaled in place and
    cast.  A leaf of at most :data:`DRAW_CHUNK` elements is one draw (the
    bits of ``(randn(shape) * std).to(dtype)``); a larger one is drawn
    :data:`DRAW_CHUNK` elements at a time in order, which bounds the f32
    temporary at 1 GiB (other values, the same distribution)."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), DRAW_CHUNK):
        part = flat[i:i + DRAW_CHUNK]
        w = torch.randn(part.shape if flat.numel() > DRAW_CHUNK else shape,
                        generator=generator, device=generator.device,
                        dtype=torch.float32)
        part.copy_(w.mul_(std).reshape(-1))
    return out


def dense_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    """N(0, 1/d_in) weights of ``shape`` (..., d_in, d_out), drawn in f32
    and cast, as ``layers.dense_init`` does; a leading repeats axis
    gives the stacked layout."""
    return normal_init(generator, shape, 1.0 / math.sqrt(shape[-2]), dtype)


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by pairwise halving with elementwise adds
    only.  A reduction kernel's summation order can depend on how many
    rows it is given; elementwise adds cannot, so a row's sum has the
    same bits at batch 1 and inside a continuous batch (the greedy
    bit-identity contract)."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if n % 2 else y
    return x


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = _row_sum(xf * xf) / x.shape[-1]
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


def init_layer_norm(d: int, device, lead: tuple = ()) -> dict:
    """LayerNorm's f32 scale (ones) and bias (zeros); ``lead`` stacks."""
    return {"scale": torch.ones(lead + (d,), dtype=torch.float32,
                                device=device),
            "bias": torch.zeros(lead + (d,), dtype=torch.float32,
                                device=device)}


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm in f32 with the population variance, at the JAX
    package's fixed eps of 1e-5 (the config's ``norm_eps`` is the RMS
    norm's).  Mean and variance are sums by :func:`_row_sum`, so a row
    has the same bits at batch 1 and inside a continuous batch."""
    xf = x.float()
    d = x.shape[-1]
    mean = _row_sum(xf) / d
    xc = xf - mean
    var = _row_sum(xc * xc) / d
    out = xc * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (b, s, h, d) with even d; positions: (b, s) or (s,).  Rotates
    split halves (not interleaved pairs), as ``layers.rope`` does."""
    d = x.shape[-1]
    half = d // 2
    # a Python-scalar base keeps this on the device: a host tensor here
    # would be a host-to-device copy, and a stall, in every layer
    freqs = torch.pow(
        float(theta),
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # (b, s, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(params: dict, x: torch.Tensor,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """silu(x W_gate) * (x W_up) in one gated-kernel call, then the down
    projection with the residual add on its flush."""
    h = ops.gemm(x, params["w_gate"], b2=params["w_up"], activation="silu")
    return ops.gemm(h, params["w_down"], residual=residual)


def init_gelu_mlp(generator: torch.Generator, d: int, d_ff: int, dtype,
                  lead: tuple = ()) -> dict:
    """The GELU MLP's ``w_in`` (d, d_ff) and ``w_out`` (d_ff, d)."""
    return {"w_in": dense_init(generator, lead + (d, d_ff), dtype),
            "w_out": dense_init(generator, lead + (d_ff, d), dtype)}


def gelu_mlp(params: dict, x: torch.Tensor,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gelu(x W_in) with the activation (the tanh form) on the GEMM's
    flush, then W_out with the residual add on its flush."""
    h = ops.gemm(x, params["w_in"], activation="gelu")
    return ops.gemm(h, params["w_out"], residual=residual)


@dataclasses.dataclass(frozen=True)
class AttnLayerSpec:
    """Layer configuration (weights + head geometry)."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int = 0          # 0 = full attention
    rope_theta: float = 10000.0
    causal: bool = True
    use_rope: bool = True


def _project_qkv(params, x, spec: AttnLayerSpec, positions):
    b, s, _ = x.shape
    q = ops.gemm(x, params["wq"]).reshape(b, s, spec.n_heads, spec.head_dim)
    k = ops.gemm(x, params["wk"]).reshape(b, s, spec.n_kv_heads,
                                          spec.head_dim)
    v = ops.gemm(x, params["wv"]).reshape(b, s, spec.n_kv_heads,
                                          spec.head_dim)
    if spec.use_rope:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    return q, k, v


def project_kv(params: dict, memory: torch.Tensor, spec: AttnLayerSpec
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention's k / v heads from the raw encoder output (b, f,
    d): (b, f, n_kv_heads, head_dim) each, with no rotary embedding."""
    b, f, _ = memory.shape
    k = ops.gemm(memory, params["wk"]).reshape(b, f, spec.n_kv_heads,
                                               spec.head_dim)
    v = ops.gemm(memory, params["wv"]).reshape(b, f, spec.n_kv_heads,
                                               spec.head_dim)
    return k, v


def attention_block(params: dict, x: torch.Tensor, spec: AttnLayerSpec,
                    positions: Optional[torch.Tensor] = None,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    memory: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Full-sequence (train / prefill / encoder) attention; ``residual``
    fuses into the output projection's flush.

    Cross-attention: ``memory`` (the raw (b, f, d) encoder output, k / v
    projected here) or ``kv`` (heads already projected, e.g. from the
    cross cache).  Either makes it non-causal with no window, and only q
    takes the rotary embedding (when ``spec.use_rope``)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if kv is None and memory is None:
        q, k, v = _project_qkv(params, x, spec, positions)
        out = ops.attention(q, k, v, causal=spec.causal, window=spec.window)
    else:
        q = ops.gemm(x, params["wq"]).reshape(b, s, spec.n_heads,
                                              spec.head_dim)
        if spec.use_rope:
            q = rope(q, positions, spec.rope_theta)
        k, v = kv if kv is not None else project_kv(params, memory, spec)
        out = ops.attention(q, k, v, causal=False, window=0)
    return ops.gemm(out.reshape(b, s, -1), params["wo"], residual=residual)


def init_kv_cache(batch: int, max_len: int, spec: AttnLayerSpec, dtype,
                  device) -> dict:
    shape = (batch, max_len, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def scatter_rows(cache: torch.Tensor, new: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Row ``i`` of ``cache`` (b, S, ...) takes ``new[i]`` (1, ...) at
    sequence position ``idx[i]`` — the per-slot write of continuous
    batching.  The JAX version returns a new array; this one writes in
    place (one indexed copy, no host sync) to keep a single cache
    resident.  Positions past the end clamp to the last slot, as
    ``dynamic_update_slice`` does."""
    b, s = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    cache[rows, idx.long().clamp(max=s - 1)] = new[:, 0].to(cache.dtype)
    return cache


def attention_decode(params: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, spec: AttnLayerSpec,
                     residual: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """Single-step decode: write each row's k/v at its own position
    ``pos`` ((b,) int32) and attend over the cache with per-row
    masking.  x: (b, 1, d).  Returns (out (b, 1, d), cache updated in
    place)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    q, k_new, v_new = _project_qkv(params, x, spec, pos[:, None])
    scatter_rows(cache["k"], k_new, pos)
    scatter_rows(cache["v"], v_new, pos)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], pos,
                               window=spec.window)
    out = ops.gemm(out.reshape(b, 1, -1), params["wo"], residual=residual)
    return out, cache


def paged_attention_decode(params: dict, x: torch.Tensor, cache: dict,
                           page_table: torch.Tensor, pos: torch.Tensor,
                           spec: AttnLayerSpec,
                           residual: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, dict]:
    """Single-step decode against a block-paged KV pool.

    ``cache``: {"k", "v"} of (n_pages, page_size, hkv, hd), one pool
    shared by every slot; ``page_table``: (b, max_pages) int32 per-slot
    tables.  Row i's new k/v lands in physical page
    ``page_table[i, min(pos[i] // page_size, max_pages - 1)]`` at offset
    ``pos[i] % page_size``: the clamp keeps a masked row whose position
    has run past its table in bounds, and masked rows (all-sink tables)
    write into the sink page, which no live table references.  The write
    is in place; colliding sink writes are harmless.  x: (b, 1, d)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    ps = cache["k"].shape[1]
    max_pages = page_table.shape[1]
    q, k_new, v_new = _project_qkv(params, x, spec, pos[:, None])
    rows = torch.arange(b, device=x.device)
    pages = page_table[rows, (pos // ps).clamp(max=max_pages - 1).long()]
    pages, offs = pages.long(), (pos % ps).long()
    cache["k"][pages, offs] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][pages, offs] = v_new[:, 0].to(cache["v"].dtype)
    out = ops.decode_attention_paged(q[:, 0], cache["k"], cache["v"],
                                     page_table, pos, window=spec.window)
    out = ops.gemm(out.reshape(b, 1, -1), params["wo"], residual=residual)
    return out, cache


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype) -> torch.Tensor:
    return normal_init(generator, (vocab, d), 0.02, dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def _chunk_loss(hc: torch.Tensor, lm_head: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor):
    """One sequence chunk's summed cross-entropy and label count.  The
    f32 logits come straight out of the GEMM's accumulator
    (``out_dtype``): no bf16 logits are written and widened again."""
    logits = ops.gemm(hc, lm_head, out_dtype=torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, lc.long()[..., None],
                                dim=-1)[..., 0]
    return ((logz - gold) * mc).sum(), mc.sum()


def chunked_softmax_xent(h: torch.Tensor, lm_head: torch.Tensor,
                         labels: torch.Tensor, *, n_chunks: int = 8,
                         label_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Cross-entropy over a large vocab without materializing full logits.

    h: (b, s, d); lm_head: (d, V); labels: (b, s) ints.  Chunks run over
    the *sequence* axis, each keeping the batch dim, so peak logits
    memory is (b, s / n_chunks, V) instead of (b, s, V); each chunk is
    checkpointed, and its backward recomputes its logits.  Positions
    padded to a whole number of chunks carry mask 0.
    """
    b, s, d = h.shape
    n_chunks = max(1, min(n_chunks, s))
    pad = (-s) % n_chunks
    mf = torch.ones((b, s), dtype=torch.float32, device=h.device) \
        if label_mask is None else label_mask.float()
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mf = torch.nn.functional.pad(mf, (0, pad))
    cs = (s + pad) // n_chunks
    losses, counts = [], []
    for i in range(n_chunks):
        sl = slice(i * cs, (i + 1) * cs)
        loss, count = checkpoint(_chunk_loss, h[:, sl], lm_head,
                                 labels[:, sl], mf[:, sl],
                                 use_reentrant=False)
        losses.append(loss)
        counts.append(count)
    return torch.stack(losses).sum() / torch.clamp(
        torch.stack(counts).sum(), min=1.0)
