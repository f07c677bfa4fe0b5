"""Decoder stack (port of ``repro/models/transformer.py``; every layer
kind: ``attn``, ``local``, ``moe``, ``ssm`` and ``rec``, and the
unstacked ``tail_pattern``): parameter init, the full-sequence
``forward`` and ``loss_fn`` of training, and for serving the dense
per-slot cache, prefill, one decode step, slot-targeted prefill for
continuous batching, and the block-paged cache (pool init, chunked
prefill into pages, copy-on-write page copies; ``decode_step`` takes
the pool's page table when the cache has one).

The JAX package scans one compiled unit (``layers/u{i}``, one entry per
position of ``cfg.layer_pattern``) over the stacked ``repeats`` axis;
here a Python loop walks the stacked leaves, taking layer ``r`` as a
view ``leaf[r]``.  A ``moe`` layer is an ``attn`` layer whose SwiGLU MLP
is the mixture of experts (:mod:`repro_torch.models.moe`), its output
added to the residual stream as ``x + y``.  Caches are updated in place
(one resident cache, no per-step copy); the functions still return the
cache so call sites read like the JAX ones.  ``forward(remat=True)``
checkpoints each unit (``torch.utils.checkpoint``, non-reentrant) as
the reference's ``jax.checkpoint`` of the scanned unit does.

A sliding-window layer (``cfg.window`` of ``attn`` / ``moe`` layers,
h2o-danube-3-4b; ``cfg.local_window`` of ``local`` layers,
recurrentgemma-9b) keeps a dense cache of ``min(max_len, window)``
slots: a ring that position ``p`` writes at slot ``p % window``
(:func:`cache_len`, :func:`_decode_ring`), so a prompt may run past the
cache's length and prefill keeps its ring-aligned tail.  On the page
pool a windowed layer pages at full length and the kernel masks the
window.

A recurrent layer (``ssm``: :mod:`repro_torch.models.mamba2`; ``rec``:
:mod:`repro_torch.models.rglru`) keeps a per-slot state instead of k / v
(``{"conv", "ssd"}`` / ``{"conv", "h"}``, the recurrences in f32),
written in place by prefill and by each decode step.  Recurrent state
has no page-table indirection, so those kinds serve on the dense cache
only (:func:`init_paged_cache` refuses them, as the JAX package does).
The tail's layers (``params["tail"]["t{i}"]``, ``cache["tail"]``) run
after the repeats, unstacked: their cache leaves carry the batch at
dim 0, the stacked ones at dim 1.

Two families add to the stack.  The encoder-decoder (``audio``,
whisper-medium): LayerNorm and a GELU MLP in place of RMS norm and
SwiGLU, sinusoidal absolute positions added to the embeddings (no
rotary embedding), a non-causal encoder (``params["encoder"]``) over
stub frame embeddings, and in each decoder layer a cross-attention
(``norm_x``, ``cross``) over the encoder's output; serving keeps each
layer's projected cross k / v in ``cache["cross"]`` (stacked like
``layers``, batch at dim 1), written by prefill from the request's
frames and read by every decode step.  The prefix family (``vlm``,
internvl2-76b): stub patch embeddings prepended to the token
embeddings, the loss over text positions only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import ops, resolve_device
from repro_torch.bridge import map_tree, zip_trees
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


#: layer kinds with attention (a k / v cache), and those with a recurrent
#: state
ATTN_KINDS = ("attn", "local", "moe")
RECURRENT_KINDS = ("ssm", "rec")

#: the MoE layer's capacity factor at decode (the JAX package's, :369)
DECODE_CAPACITY_FACTOR = 4.0

#: weight of the MoE load-balancing loss in ``loss_fn`` (as the JAX
#: package's; each ``moe`` layer returns its own, summed over the stack)
AUX_LOSS_WEIGHT = 0.01


def check_supported(cfg: ModelConfig) -> None:
    """The port runs every layer kind, a tail, the encoder-decoder,
    prefix embeddings and absolute positions.  An encoder raises beside
    a tail (which the JAX package asserts against) or a recurrent layer
    kind (which has no cross-attention to read it)."""
    if cfg.encoder_layers and (cfg.tail_pattern or any(
            k in RECURRENT_KINDS for k in cfg.layer_pattern)):
        raise ValueError(f"{cfg.name}: an encoder needs a stack of "
                         "attention layers with no tail")


def _window(cfg: ModelConfig, kind: str) -> int:
    """An attention layer's window: ``cfg.window`` for ``attn`` / ``moe``
    layers, ``cfg.local_window`` for ``local`` ones (0: full)."""
    return cfg.window if kind in ("attn", "moe") else cfg.local_window


def _attn_spec(cfg: ModelConfig, kind: str = "attn") -> L.AttnLayerSpec:
    return L.AttnLayerSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        window=_window(cfg, kind), rope_theta=cfg.rope_theta, causal=True,
        use_rope=cfg.use_rope)


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal position encoding in f32: ``[sin | cos]``
    concatenated (not interleaved), frequencies spaced by
    ``max(half - 1, 1)`` as the JAX package's."""
    half = d // 2
    freqs = torch.exp(
        -torch.arange(half, dtype=torch.float32, device=positions.device)
        * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _maybe_abs_pos(cfg: ModelConfig, x: torch.Tensor, start
                   ) -> torch.Tensor:
    """``x`` plus the sinusoidal encoding of its positions when the model
    has no rotary embedding.  ``start`` is an int (every row at one
    offset: training, prefill) or a (b,) device tensor (decode, each slot
    at its own position: read on the device, no host copy)."""
    if cfg.use_rope:
        return x
    s, d = x.shape[1], x.shape[2]
    steps = torch.arange(s, device=x.device)
    if isinstance(start, torch.Tensor):
        pos = steps[None, :] + start[:, None]               # (b, s)
        return x + _sinusoid(pos, d).to(x.dtype)
    return x + _sinusoid(steps + start, d)[None].to(x.dtype)


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm (eps 1e-5) in the audio family, else RMS norm."""
    return L.layer_norm(p, x) if cfg.family == "audio" \
        else L.rms_norm(p, x, cfg.norm_eps)


def _mlp(cfg: ModelConfig, p: dict, x: torch.Tensor,
         residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The GELU MLP in the audio family, else SwiGLU; ``residual`` rides
    the down projection's flush."""
    return L.gelu_mlp(p, x, residual=residual) if cfg.family == "audio" \
        else L.swiglu(p, x, residual=residual)


def _layer(tree: dict, r: int) -> dict:
    """Layer ``r`` of a stacked subtree, as views."""
    return map_tree(lambda t: t[r], tree)


def _units(cfg: ModelConfig):
    """(unit key, layer kind) of each position of the layer pattern."""
    return [(f"u{i}", kind) for i, kind in enumerate(cfg.layer_pattern)]


def _tail(cfg: ModelConfig):
    """(tail key, layer kind) of each layer after the repeats."""
    return [(f"t{i}", kind) for i, kind in enumerate(cfg.tail_pattern)]


def _ffn(p: dict, cfg: ModelConfig, kind: str, h: torch.Tensor,
         x: torch.Tensor, capacity_factor: float) -> torch.Tensor:
    """The layer's second half on the normed ``h``: the SwiGLU MLP with
    the residual ``x`` fused into its down projection, or the mixture of
    experts added to ``x``."""
    if kind == "moe":
        y, _ = MOE.moe_ffn(p["moe"], h, top_k=cfg.top_k,
                           capacity_factor=capacity_factor, aux_loss=False)
        return x + y
    return _mlp(cfg, p["mlp"], h, residual=x)


def _cross(p: dict, cfg: ModelConfig, x: torch.Tensor, *, kv=None,
           memory=None) -> torch.Tensor:
    """A decoder layer's cross-attention with its residual: over the
    encoder output ``memory`` or the cross cache's ``kv`` (k, v)."""
    return L.attention_block(p["cross"], _norm(cfg, p["norm_x"], x),
                             _attn_spec(cfg), kv=kv, memory=memory,
                             residual=x)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters in the JAX layout and with the JAX init's
    standard deviations (embedding 0.02, projections 1/sqrt(d_in), norm
    scales 1 in f32, LayerNorm biases 0; a ``moe`` unit's router in f32
    and its (E, d, f) / (E, f, d) banks; the ``rec`` / ``ssm`` blocks as
    :func:`~repro_torch.models.rglru.init_rglru` /
    :func:`~repro_torch.models.mamba2.init_mamba2` make them; with an
    encoder, each decoder layer's ``norm_x`` and ``cross`` and the
    ``encoder`` subtree), drawn from ``generator`` on ``device`` (default
    the CUDA card; the generator must live on that device)."""
    check_supported(cfg)
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"go to {device}")
    dt = _DTYPES[cfg.dtype]
    d, hd = cfg.d_model, cfg.hd

    def norm(*lead):
        if cfg.family == "audio":
            return L.init_layer_norm(d, device, lead)
        return {"scale": torch.ones(lead + (d,), dtype=torch.float32,
                                    device=device)}

    def mlp(r):
        if cfg.family == "audio":
            return L.init_gelu_mlp(generator, d, cfg.d_ff, dt, (r,))
        return {"w_gate": L.dense_init(generator, (r, d, cfg.d_ff), dt),
                "w_up": L.dense_init(generator, (r, d, cfg.d_ff), dt),
                "w_down": L.dense_init(generator, (r, cfg.d_ff, d), dt)}

    def attn(r):
        return {
            "wq": L.dense_init(generator, (r, d, cfg.n_heads * hd), dt),
            "wk": L.dense_init(generator, (r, d, cfg.n_kv_heads * hd), dt),
            "wv": L.dense_init(generator, (r, d, cfg.n_kv_heads * hd), dt),
            "wo": L.dense_init(generator, (r, cfg.n_heads * hd, d), dt),
        }

    def unit(kind, r, cross=False):
        """``r`` stacked layers of ``kind`` (with cross-attention)."""
        u = {"norm1": norm(r)}
        if kind == "ssm":
            u["mixer"] = M2.init_mamba2(generator, d, cfg.ssm_state, dt, (r,))
            return u
        if kind == "rec":
            u["rec"] = RG.init_rglru(generator, d, cfg.lru_width or d, dt,
                                     (r,))
            u["norm2"] = norm(r)
            u["mlp"] = mlp(r)
            return u
        u["attn"] = attn(r)
        u["norm2"] = norm(r)
        if kind == "moe":
            u["moe"] = MOE.init_moe(generator, d, cfg.d_ff, cfg.n_experts,
                                    dt, r)
        else:
            u["mlp"] = mlp(r)
        if cross:
            u["norm_x"] = norm(r)
            u["cross"] = attn(r)
        return u

    enc = bool(cfg.encoder_layers)
    params = {"layers": {ck: unit(kind, cfg.repeats, cross=enc)
                         for ck, kind in _units(cfg)}}
    if cfg.tail_pattern:
        params["tail"] = {tk: _layer(unit(kind, 1), 0)
                          for tk, kind in _tail(cfg)}
    if enc:
        params["encoder"] = {"final_norm": norm(),
                             "layers": {"u0": unit("attn",
                                                   cfg.encoder_layers)}}
    return {
        "embed": L.init_embedding(generator, cfg.vocab, d, dt),
        "final_norm": norm(),
        "lm_head": L.dense_init(generator, (d, cfg.vocab), dt),
        **params,
    }


# ---------------------------------------------------------------------------
# Full-sequence apply (training)
# ---------------------------------------------------------------------------

def apply_layer(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, *,
                enc_out: Optional[torch.Tensor] = None,
                causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer, full sequence.  Returns (x, aux_loss).  An attention
    layer's residual-stream adds ride the output and down projections'
    flushes (a decoder layer's cross-attention over ``enc_out`` too); a
    ``moe`` layer adds its experts' output to ``x`` and returns the
    load-balancing loss; a recurrent block's output is added to ``x``
    (and a ``rec`` layer's MLP then fuses its residual), as the JAX
    package adds them."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in RECURRENT_KINDS:
        h = _norm(cfg, p["norm1"], x)
        if kind == "ssm":
            return x + M2.mamba2_block(p["mixer"], h, cfg.ssm_state), zero
        x = x + RG.rglru_block(p["rec"], h)
        return _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], x),
                    residual=x), zero
    spec = dataclasses.replace(_attn_spec(cfg, kind), causal=causal)
    x = L.attention_block(p["attn"], _norm(cfg, p["norm1"], x), spec,
                          residual=x)
    if enc_out is not None:
        x = _cross(p, cfg, x, memory=enc_out)
    h = _norm(cfg, p["norm2"], x)
    if kind == "moe":
        y, aux = MOE.moe_ffn(p["moe"], h, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
        return x + y, aux
    return _mlp(cfg, p["mlp"], h, residual=x), zero


def _unit(unit: dict, cfg: ModelConfig, x: torch.Tensor,
          enc_out: Optional[torch.Tensor] = None):
    """One repeat of the layer pattern over ``x`` (``unit``: each
    position's layer parameters): (x, summed aux)."""
    aux = None
    for ck, kind in _units(cfg):
        x, a = apply_layer(unit[ck], cfg, kind, x, enc_out=enc_out)
        aux = a if aux is None else aux + a
    return x, aux


def _unbound(stack: dict, n: int):
    """Layer ``r`` of a stacked subtree for r < n, as views taken at once
    (``unbind``): their gradients stack into the leaf's in one op, where
    a view taken per layer (leaf[r]) would add a zero-padded full-size
    gradient per layer, quadratic in the depth."""
    views = map_tree(lambda t: t.unbind(0), stack)
    return [map_tree(lambda v: v[r], views) for r in range(n)]


def _encode(params: dict, cfg: ModelConfig, frames: torch.Tensor
            ) -> torch.Tensor:
    """The non-causal encoder over stub frame embeddings (b, F, d), in
    the model dtype, with no position encoding (as the JAX package's),
    then its final norm."""
    enc = params["encoder"]
    x = frames.to(params["embed"].dtype)
    for p in _unbound(enc["layers"]["u0"], cfg.encoder_layers):
        x, _ = apply_layer(p, cfg, "attn", x, causal=False)
    return _norm(cfg, enc["final_norm"], x)


def _project_cross_kv(p: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """One decoder layer's cross k / v from the encoder output."""
    return L.project_kv(p["cross"], enc_out, _attn_spec(cfg))


def _embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embeds=None, start=0) -> torch.Tensor:
    """Token embeddings after the prefix embeddings (b, P, d) when given,
    with absolute positions from ``start`` when the model has them."""
    x = L.embed(params["embed"], tokens)
    if prefix_embeds is not None:
        if prefix_embeds.shape[-1] != x.shape[-1]:
            raise ValueError(f"prefix embeddings of width "
                             f"{prefix_embeds.shape[-1]}, model width "
                             f"{x.shape[-1]}")
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return _maybe_abs_pos(cfg, x, start)


def _check_frames(params: dict, cfg: ModelConfig, frames) -> None:
    if frames is not None and "encoder" not in params:
        raise ValueError(f"{cfg.name} has no encoder to take frames")


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds=None, frames=None, remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (hidden (b, s, d), aux_loss).
    ``prefix_embeds`` (vlm): (b, P, d) prepended to the token embeddings
    (s counts them); ``frames`` (audio): (b, F, d) encoder input, whose
    output every decoder layer cross-attends.  ``remat`` checkpoints
    each repeat of the layer pattern, so its backward recomputes the
    unit's activations (kernels included)."""
    check_supported(cfg)
    _check_frames(params, cfg, frames)
    x = _embed_inputs(params, cfg, tokens, prefix_embeds)
    enc_out = _encode(params, cfg, frames) if frames is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in _unbound(params["layers"], cfg.repeats):
        if remat:
            x, a = checkpoint(_unit, unit, cfg, x, enc_out,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _unit(unit, cfg, x, enc_out)
        aux = aux + a
    for tk, kind in _tail(cfg):               # after the repeats, as JAX
        x, a = apply_layer(params["tail"][tk], cfg, kind, x,
                           enc_out=enc_out)
        aux = aux + a
    return _norm(cfg, params["final_norm"], x), aux


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            n_chunks: int = 8, remat: bool = True
            ) -> Tuple[torch.Tensor, dict]:
    """batch: tokens (b, s), labels (b, s), optional mask, frames and
    prefix_embeds; with a prefix the loss covers text positions only."""
    h, aux = forward(params, cfg, batch["tokens"],
                     prefix_embeds=batch.get("prefix_embeds"),
                     frames=batch.get("frames"), remat=remat)
    if batch.get("prefix_embeds") is not None:
        h = h[:, batch["prefix_embeds"].shape[1]:]
    ce = L.chunked_softmax_xent(h, params["lm_head"], batch["labels"],
                                n_chunks=n_chunks,
                                label_mask=batch.get("mask"))
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def cache_len(cfg: ModelConfig, max_len: int, kind: str = "attn") -> int:
    """Slots an attention layer's dense cache holds (``_cache_len`` of
    the JAX package): a sliding-window layer only ever needs its
    window."""
    window = _window(cfg, kind)
    return min(max_len, window) if window > 0 else max_len


def _is_ring(spec: L.AttnLayerSpec, slots: int) -> bool:
    """Whether a dense cache of ``slots`` slots is a windowed ring (the
    JAX package's test at ``decode_layer``): a windowed layer's cache no
    longer than its window.  A longer cache keeps positions in place and
    the kernels mask the window."""
    return spec.window > 0 and slots <= spec.window


def _layer_cache(cfg: ModelConfig, kind: str, lead: tuple, batch: int,
                 max_len: int, device) -> dict:
    """One layer's dense cache (``lead`` stacked): k / v of
    :func:`cache_len` slots, or the recurrent state."""
    dt = _DTYPES[cfg.dtype]
    if kind == "ssm":
        c = M2.init_mamba2_cache(batch, cfg.d_model, cfg.ssm_state, dt,
                                 device)
    elif kind == "rec":
        c = RG.init_rglru_cache(batch, cfg.lru_width or cfg.d_model, dt,
                                device)
    else:
        shape = (batch, cache_len(cfg, max_len, kind), cfg.n_kv_heads,
                 cfg.hd)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    return map_tree(lambda t: t.new_zeros(lead + tuple(t.shape)), c) \
        if lead else c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Dense per-slot cache: ``pos`` is a (batch,) int32 vector, every
    slot decoding at its own position; each unit's leaves are stacked
    (repeats, batch, ...): k / v of (:func:`cache_len`, n_kv_heads,
    head_dim), a ring of ``window`` slots for a windowed layer, or a
    recurrent layer's ``{"conv", "ssd"}`` / ``{"conv", "h"}``.  The
    tail's leaves (``cache["tail"]["t{i}"]``) are (batch, ...).  With an
    encoder, ``cache["cross"]`` holds each decoder layer's cross k / v,
    (repeats, batch, encoder_seq, n_kv_heads, head_dim), zeros until a
    prefill with frames writes a slot's."""
    check_supported(cfg)
    device = resolve_device(device)
    cache = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": {ck: _layer_cache(cfg, kind, (cfg.repeats,), batch,
                                    max_len, device)
                   for ck, kind in _units(cfg)},
    }
    if cfg.tail_pattern:
        cache["tail"] = {tk: _layer_cache(cfg, kind, (), batch, max_len,
                                          device)
                         for tk, kind in _tail(cfg)}
    if cfg.encoder_layers:
        cache["cross"] = _kv_units(
            cfg, (cfg.repeats, batch, cfg.encoder_seq, cfg.n_kv_heads,
                  cfg.hd), device)
    return cache


def _kv_units(cfg: ModelConfig, shape, device) -> dict:
    dt = _DTYPES[cfg.dtype]
    return {ck: {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
            for ck, _ in _units(cfg)}


def _layers(cfg: ModelConfig, params: dict, cache: dict):
    """(layer params, kind, layer cache, cross k / v or None) of every
    layer in order: repeat r's units, then the tail; a stacked layer's
    parameters and caches as views of its leaves."""
    cross = cache.get("cross")
    for r in range(cfg.repeats):
        for ck, kind in _units(cfg):
            yield (_layer(params["layers"][ck], r), kind,
                   _layer(cache["layers"][ck], r),
                   None if cross is None else _layer(cross[ck], r))
    for tk, kind in _tail(cfg):
        yield params["tail"][tk], kind, cache["tail"][tk], None


def _write_state(cache: dict, new: dict) -> dict:
    """A recurrent layer's new state into its cache leaves, in place (one
    resident cache; a captured step replays the copies)."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def _recurrent(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
               state: dict, decode: bool) -> Tuple[torch.Tensor, dict]:
    """A recurrent layer from ``state``: its block (one token's update,
    or the whole prompt's scan) added to ``x``, then a ``rec`` layer's
    SwiGLU MLP with its residual fused.  Returns (x, new state)."""
    h = _norm(cfg, p["norm1"], x)
    if kind == "ssm":
        y, new = (M2.mamba2_decode(p["mixer"], h, state, cfg.ssm_state)
                  if decode else
                  M2.mamba2_scan(p["mixer"], h, cfg.ssm_state, state))
        return x + y, new
    y, new = (RG.rglru_decode(p["rec"], h, state) if decode else
              RG.rglru_scan(p["rec"], h, state))
    x = x + y
    return _mlp(cfg, p["mlp"], _norm(cfg, p["norm2"], x), residual=x), new


def decode_layer(p: dict, cache: dict, cfg: ModelConfig, kind: str,
                 x: torch.Tensor, pos: torch.Tensor, cross_kv=None,
                 page_table: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """One layer of a decode step; ``page_table`` set means ``cache`` is
    this layer's page pool; ``cross_kv`` (this layer's ``{"k", "v"}`` of
    the cross cache) adds the cross-attention, a one-row prefill-mode
    attention over each slot's encoder keys.  The layer's cache is
    written in place."""
    if kind in RECURRENT_KINDS:
        x, new = _recurrent(p, cfg, kind, x, cache, decode=True)
        return x, _write_state(cache, new)
    h = _norm(cfg, p["norm1"], x)
    spec = _attn_spec(cfg, kind)
    if page_table is not None:
        # windowed layers page at full length; B5 masks the window
        x, cache = L.paged_attention_decode(p["attn"], h, cache, page_table,
                                            pos, spec, residual=x)
    elif _is_ring(spec, cache["k"].shape[1]):
        x, cache = _decode_ring(p["attn"], cache, spec, h, pos, residual=x)
    else:
        x, cache = L.attention_decode(p["attn"], h, cache, pos, spec,
                                      residual=x)
    if cross_kv is not None:
        x = _cross(p, cfg, x, kv=(cross_kv["k"], cross_kv["v"]))
    h = _norm(cfg, p["norm2"], x)
    return _ffn(p, cfg, kind, h, x, DECODE_CAPACITY_FACTOR), cache


def _sliding_pos(pos: torch.Tensor, slots: int) -> torch.Tensor:
    """Ring write slot of each row's position, on the device (no host
    scalar crosses to the card, so a captured step replays it)."""
    return torch.remainder(pos, slots)


def _decode_ring(params: dict, cache: dict, spec: L.AttnLayerSpec,
                 x: torch.Tensor, pos: torch.Tensor,
                 residual: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """Windowed decode against a ring cache of ``W <= window`` slots
    (``_decode_ring`` of the JAX package): row ``i`` writes its k / v at
    slot ``pos[i] % W`` and attends every slot it has written, which
    the window holds by construction: slots ``<= pos[i]`` before the
    ring wraps, all of them after.

    Attention over a set of keys does not depend on their order, and
    that mask is kernel B4's at position ``min(pos, W - 1)`` with no
    window, so the ring runs through the planned B4 (one launch, f32
    accumulation, a row's bits independent of the batch) where the JAX
    package writes two einsums.  Rotary embedding takes the true
    ``pos``.  x: (b, 1, d).  Returns (out (b, 1, d), cache updated in
    place)."""
    b = x.shape[0]
    slots = cache["k"].shape[1]
    q, k_new, v_new = L._project_qkv(params, x, spec, pos[:, None])
    wpos = _sliding_pos(pos, slots)
    L.scatter_rows(cache["k"], k_new, wpos)
    L.scatter_rows(cache["v"], v_new, wpos)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                               pos.clamp(max=slots - 1))
    out = ops.gemm(out.reshape(b, 1, -1), params["wo"], residual=residual)
    return out, cache


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """One decode step.  token: (b, 1) ints.  Returns (logits (b, V) f32,
    cache) — the cache's k / v and recurrent states are written in place
    and ``pos`` advances by one for every slot.  A cache with a
    ``page_table`` (from :func:`init_paged_cache`) is a page pool
    addressed through it."""
    pos = cache["pos"]
    table = cache.get("page_table")
    x = _embed_inputs(params, cfg, token, start=pos)
    for p, kind, layer_cache, cross in _layers(cfg, params, cache):
        x, _ = decode_layer(p, layer_cache, cfg, kind, x, pos,
                            cross_kv=cross, page_table=table)
    x = _norm(cfg, params["final_norm"], x)
    logits = ops.gemm(x[:, 0], params["lm_head"], out_dtype=torch.float32)
    return logits, dict(cache, pos=pos + 1)


def prefill_layer(p: dict, cache: dict, cfg: ModelConfig, kind: str,
                  x: torch.Tensor, cross_kv=None
                  ) -> Tuple[torch.Tensor, dict]:
    """Full-prompt forward that also fills this layer's cache (the
    prompt starts at position 0).  A prompt longer than a windowed ring
    leaves its last ``W`` positions there, position ``p`` at slot
    ``p % W``; a recurrent layer leaves its state after the prompt's
    last position (``_mamba2_prefill`` / ``_rglru_prefill`` of the JAX
    package, from the cache's state); ``cross_kv`` adds the
    cross-attention over this layer's cross k / v."""
    if kind in RECURRENT_KINDS:
        x, new = _recurrent(p, cfg, kind, x, cache, decode=False)
        return x, _write_state(cache, new)
    b, s, _ = x.shape
    spec = _attn_spec(cfg, kind)
    slots = cache["k"].shape[1]
    if s > slots and not _is_ring(spec, slots):
        raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                         f"{slots} positions")
    h = _norm(cfg, p["norm1"], x)
    positions = torch.arange(s, device=x.device)
    q, k, v = L._project_qkv(p["attn"], h, spec, positions)
    out = ops.attention(q, k, v, causal=True, window=spec.window)
    x = ops.gemm(out.reshape(b, s, -1), p["attn"]["wo"], residual=x)
    if s <= slots:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    else:   # the ring-aligned tail: roll by (s - W) % W, in place
        shift = (s - slots) % slots
        for name, t in (("k", k), ("v", v)):
            tail = t[:, s - slots:]
            cache[name][:, shift:] = tail[:, :slots - shift]
            cache[name][:, :shift] = tail[:, slots - shift:]
    if cross_kv is not None:
        x = _cross(p, cfg, x, kv=(cross_kv["k"], cross_kv["v"]))
    hh = _norm(cfg, p["norm2"], x)
    return _ffn(p, cfg, kind, hh, x, cfg.capacity_factor), cache


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict, *, prefix_embeds=None, frames=None
            ) -> Tuple[torch.Tensor, dict]:
    """Run the prompt, fill the cache.  ``prefix_embeds`` (b, P, d) go
    before the tokens, so ``pos`` becomes P + s; ``frames`` (b, F, d) run
    through the encoder, and every decoder layer's cross k / v are
    written into ``cache["cross"]`` in place (without frames the cache's
    cross k / v stay as they are: zeros in a fresh cache, as in the JAX
    package).  Returns (last-token logits (b, V) f32, cache)."""
    _check_frames(params, cfg, frames)
    x = _embed_inputs(params, cfg, tokens, prefix_embeds)
    s_total = x.shape[1]
    if frames is not None:
        enc_out = _encode(params, cfg, frames)
        for ck, _ in _units(cfg):
            kv = cache["cross"][ck]
            for r in range(cfg.repeats):
                k, v = _project_cross_kv(_layer(params["layers"][ck], r),
                                         cfg, enc_out)
                kv["k"][r].copy_(k)
                kv["v"][r].copy_(v)
    for p, kind, layer_cache, cross in _layers(cfg, params, cache):
        x, _ = prefill_layer(p, layer_cache, cfg, kind, x, cross_kv=cross)
    x = _norm(cfg, params["final_norm"], x)
    logits = ops.gemm(x[:, -1], params["lm_head"], out_dtype=torch.float32)
    pos = torch.full((tokens.shape[0],), s_total, dtype=torch.int32,
                     device=tokens.device)
    return logits, dict(cache, pos=pos)


#: the batch axis of a cache subtree's leaves (``_cache_batch_dim`` of the
#: JAX package): stacked (repeats, batch, ...) under ``layers`` and
#: ``cross``, (batch, ...) under ``tail``
_BATCH_DIM = {"layers": 1, "cross": 1, "tail": 0}


def insert_cache_slot(live: dict, sub: dict, slot: int) -> dict:
    """Copy a batch-1 cache into batch row ``slot`` of a live multi-slot
    cache, in place, every leaf (k / v, the recurrent states, the cross
    k / v); resident slots are untouched."""
    for name, dim in _BATCH_DIM.items():
        if name in live:
            zip_trees(lambda t, u: t.select(dim, slot).copy_(u.select(dim, 0)),
                      live[name], sub[name])
    live["pos"][slot] = sub["pos"][0]
    return live


def prefill_into_slot(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: dict, slot: int, *, max_len: int,
                      prefix_embeds=None, frames=None
                      ) -> Tuple[torch.Tensor, dict]:
    """Admit ONE request into slot ``slot`` of a live multi-slot cache:
    the (1, s) prompt (after ``prefix_embeds`` (1, P, d), with the
    encoder over ``frames`` (1, F, d)) prefills a fresh batch-1 cache
    whose rows are then copied into the slot.  Stale entries beyond the
    new request's length stay invisible: decode masks positions >
    ``pos[slot]``.

    Returns (last-token logits (1, V), cache)."""
    if tokens.shape[0] != 1:
        raise ValueError("slot prefill admits one request")
    fresh = init_cache(cfg, 1, max_len, device=cache["pos"].device)
    logits, sub = prefill(params, cfg, tokens, fresh,
                          prefix_embeds=prefix_embeds, frames=frames)
    return logits, insert_cache_slot(cache, sub, slot)


# ---------------------------------------------------------------------------
# Block-paged KV cache (serve)
# ---------------------------------------------------------------------------

def check_paged(cfg: ModelConfig, where: str = "paged cache") -> None:
    """What the page pool holds: the k / v of ``attn`` and ``moe``
    layers.  Recurrent kinds raise as the JAX package's engine does:
    their per-slot state has no page-table indirection, so chunked
    prefill would reuse a slot's stale state, interleaved decode bursts
    would advance a mid-prefill slot's recurrence (only attention writes
    go to the sink page), and prefix sharing cannot skip tokens through
    a recurrence; those archs serve on the dense cache.  An
    encoder-decoder raises too, as in the JAX package (its cross k / v
    have no pages).  A ``local`` layer or a tail on the pool waits
    (ROADMAP queue A9)."""
    check_supported(cfg)
    bad = sorted({k for k in cfg.all_kinds if k in RECURRENT_KINDS})
    if bad:
        raise ValueError(f"{where}: recurrent layer kinds {bad} unsupported "
                         f"(arch {cfg.name}); use the dense engine")
    if cfg.encoder_layers:
        raise ValueError(f"{where}: encoder-decoder archs unsupported")
    if "local" in cfg.all_kinds or cfg.tail_pattern:
        raise NotImplementedError(
            f"{cfg.name}: local-window layers and tail layers on the page "
            "pool are not ported yet (ROADMAP queue A9)")


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, max_pages: int, device=None) -> dict:
    """Decode cache whose K/V live in a shared block pool: each unit's
    k/v leaves stacked (repeats, n_pages, page_size, n_kv_heads,
    head_dim); slots address them through ``page_table`` ((batch,
    max_pages) int32, all pointing at page 0, the serve loop's sink,
    until a slot is promoted).  :func:`check_paged` says which configs
    page."""
    check_paged(cfg)
    device = resolve_device(device)
    shape = (cfg.repeats, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "page_table": torch.zeros((batch, max_pages), dtype=torch.int32,
                                  device=device),
        "layers": _kv_units(cfg, shape, device),
    }


def _prefill_chunk_layer(p: dict, cache: dict, cfg: ModelConfig,
                         kind: str, x: torch.Tensor, pages: torch.Tensor,
                         offs: torch.Tensor, hist: torch.Tensor, start: int
                         ) -> Tuple[torch.Tensor, dict]:
    """One layer of a prompt chunk at positions [start, start + s)
    against this layer's page pool.  The chunk's k/v go to
    ``(pages[j], offs[j])``; the history pages ``hist`` are gathered
    into an exact (1, start + s) view, so attention sees the operands a
    whole-prompt prefill's rows see."""
    b, s, _ = x.shape
    spec = _attn_spec(cfg, kind)
    h = _norm(cfg, p["norm1"], x)
    positions = torch.arange(start, start + s, device=x.device)
    q, k, v = L._project_qkv(p["attn"], h, spec, positions)
    cache["k"][pages, offs] = k[0].to(cache["k"].dtype)
    cache["v"][pages, offs] = v[0].to(cache["v"].dtype)
    n = start + s
    kf = cache["k"][hist].reshape(1, -1, spec.n_kv_heads, spec.head_dim)
    vf = cache["v"][hist].reshape(1, -1, spec.n_kv_heads, spec.head_dim)
    out = ops.attention(q, kf[:, :n], vf[:, :n], causal=True,
                        window=spec.window, q_offset=start)
    x = ops.gemm(out.reshape(b, s, -1), p["attn"]["wo"], residual=x)
    hh = _norm(cfg, p["norm2"], x)
    return _ffn(p, cfg, kind, hh, x, cfg.capacity_factor), cache


def prefill_paged_chunk(params: dict, cfg: ModelConfig,
                        tokens: torch.Tensor, cache: dict, slot: int,
                        table_row, start_pos: int
                        ) -> Tuple[torch.Tensor, dict]:
    """Prefill ONE chunk of a prompt into the page pool.

    tokens: (1, s), prompt positions [start_pos, start_pos + s);
    ``table_row``: the slot's TRUE (max_pages,) int32 table, a host
    array (the device ``page_table`` row stays all-sink until the engine
    promotes the slot after its last chunk, so interleaved decode steps
    never read a half-written prompt); ``start_pos``: a Python int.  The
    chunk's page / offset indices and its history pages are worked out
    on the host once per chunk and cross to the card in one copy.  A
    prompt whose first ``start_pos`` tokens ride shared prefix pages
    prefills only its suffix, attending that history through the table.

    Returns (last-position logits (1, V) f32, cache) with the pool
    written in place and ``pos[slot] = start_pos + s``."""
    if tokens.shape[0] != 1:
        raise ValueError("chunk prefill admits one request")
    s = tokens.shape[1]
    kv = cache["layers"]["u0"]
    ps = kv["k"].shape[2]
    row = np.asarray(table_row, dtype=np.int64)
    at = np.arange(start_pos, start_pos + s)
    n_hist = -(-(start_pos + s) // ps)
    if n_hist > row.shape[0]:
        raise ValueError(f"chunk ends at position {start_pos + s}, past the "
                         f"table's {row.shape[0]} pages of {ps}")
    idx = torch.as_tensor(np.concatenate([row[at // ps], at % ps,
                                          row[:n_hist]]))
    idx = idx.to(kv["k"].device)
    pages, offs, hist = idx[:s], idx[s:2 * s], idx[2 * s:]
    x = _embed_inputs(params, cfg, tokens, start=start_pos)
    for p, kind, layer_cache, _ in _layers(cfg, params, cache):
        x, _ = _prefill_chunk_layer(p, layer_cache, cfg, kind, x, pages,
                                    offs, hist, start_pos)
    x = _norm(cfg, params["final_norm"], x)
    logits = ops.gemm(x[:, -1], params["lm_head"], out_dtype=torch.float32)
    cache["pos"][slot] = start_pos + s
    return logits, cache


def copy_kv_pages(cache: dict, src, dst) -> dict:
    """Copy physical pages ``src[i] -> dst[i]`` in every layer's pool, in
    place (the copy-on-write step: a slot about to write into a shared
    page gets its own copy first).  src / dst: sequences of page ids."""
    device = cache["pos"].device
    src = torch.as_tensor(np.asarray(src, np.int64)).to(device)
    dst = torch.as_tensor(np.asarray(dst, np.int64)).to(device)
    for kv in cache["layers"].values():
        for name in ("k", "v"):
            kv[name][:, dst] = kv[name][:, src]
    return cache
