"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``, its pjit
path): sort-based dispatch and three grouped ragged expert GEMMs.

* Routing: softmax -> top-k -> renormalised gates (token choice).
* Dispatch (:func:`_sort_dispatch`): the ``t*k`` (token, expert)
  assignments are sorted by expert (stable) into a ragged ``(t*k, d)``
  pack where expert ``e``'s rows are ``[start_e, start_e + size_e)``
  with ``size_e = min(count_e, C)``: capacity C per expert, overflow
  dropped (GShard semantics).
* Expert compute (:func:`_expert_gemms`): one grouped ragged GEMM a
  projection (``ops.gemm_grouped``, kernel B7 on a card) over the true
  routed rows, silu fused into the gate GEMM's flush.
* Combine: each token sums its k weighted expert outputs in ascending
  expert order, rounding to the activation dtype after every add, as
  the JAX package's scatter-add does on its host.

Every step keeps a token's bits independent of the rest of the batch,
so continuous-batched greedy decoding equals solo decoding whenever no
token is dropped: the router GEMM walks k in one order, the softmax and
the gate renormalisation sum with elementwise adds only
(``layers._row_sum``), top-k is a stable sort (ties go to the lower
expert id, as ``lax.top_k``'s), and the combine sums in a fixed order.
Nothing here syncs the host: group sizes, offsets and capacity drops
stay on the device.  With telemetry on, the ``moe.group_sizes`` (rows
routed through the grouped GEMMs) and ``moe.dropped_tokens``
(capacity-dropped assignments) counters keep their running sums on the
device and read them once, at the recorder's snapshot.

Not in the port yet (ROADMAP queue A9): the shard_map expert-parallel
path and the ``REPRO_MOE_GROUPED=0`` dense-einsum baseline.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops, quant, telemetry
from repro_torch.kernels.gemm_grouped import shared_tables
from repro_torch.models.layers import _row_sum, dense_init, normal_init


def init_moe(generator: torch.Generator, d: int, d_ff: int,
             n_experts: int, dtype, repeats: int) -> dict:
    """Router (f32) and expert banks of ``repeats`` stacked layers, with
    the JAX init's standard deviations (router 1/sqrt(d), gate/up
    1/sqrt(d), down 1/sqrt(d_ff)); a bank is drawn in slices
    (:func:`~repro_torch.models.layers.normal_init`)."""
    def bank(shape, std):
        return normal_init(generator, (repeats,) + shape, std, dtype)

    return {
        "router": dense_init(generator, (repeats, d, n_experts),
                             torch.float32),
        "w_gate": bank((n_experts, d, d_ff), 1.0 / math.sqrt(d)),
        "w_up": bank((n_experts, d, d_ff), 1.0 / math.sqrt(d)),
        "w_down": bank((n_experts, d_ff, d), 1.0 / math.sqrt(d_ff)),
    }


def capacity(n_tokens: int, n_experts: int, top_k: int,
             factor: float = 1.25, multiple: int = 8) -> int:
    c = math.ceil(n_tokens * top_k * factor / n_experts)
    return max(multiple, ((c + multiple - 1) // multiple) * multiple)


class MoeDispatch(NamedTuple):
    """Sort-based dispatch of ``t*k`` (token, expert) assignments (the
    JAX package's fields).  ``xs`` is the ragged pack: kept assignment
    ``i`` (in expert-sorted order) lives at row ``dest[i]``; rows past
    ``sum(sizes)`` are zero.  Dropped assignments have ``dest == t*k``
    and ``in_cap`` False."""

    xs: torch.Tensor         # (t*k, d) ragged expert-sorted tokens
    sizes: torch.Tensor      # (E,) int32 kept rows per expert (<= C)
    counts: torch.Tensor     # (E,) int32 routed counts (before capacity)
    dest: torch.Tensor       # (t*k,) ragged row per assignment
    slot: torch.Tensor       # (t*k,) position within the expert group
    token_idx: torch.Tensor  # (t*k,) source token of each assignment
    order: torch.Tensor      # (t*k,) argsort permutation of flat ids
    in_cap: torch.Tensor     # (t*k,) bool, assignment kept
    sorted_e: torch.Tensor   # (t*k,) expert id, ascending


def _sort_dispatch(xe: torch.Tensor, top_ids: torch.Tensor, top_k: int,
                   n_experts: int, c: int) -> MoeDispatch:
    """Sort tokens by expert into the ragged ``(t*k, d)`` pack (overflow
    beyond capacity ``c`` dropped).  Counts come from a scatter-add into
    E bins, not ``bincount``, whose output length would need a sync."""
    t = xe.shape[0]
    tk = t * top_k
    flat_e = top_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    token_idx = order // top_k
    counts = torch.zeros(n_experts, dtype=torch.int32, device=xe.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    slot = torch.arange(tk, dtype=torch.int32, device=xe.device) \
        - starts[sorted_e]
    in_cap = slot < c
    sizes = torch.clamp(counts, max=c)
    rstarts = torch.cumsum(sizes, 0, dtype=torch.int32) - sizes
    dest = torch.where(in_cap, rstarts[sorted_e] + slot, tk)
    # dropped rows land in one spare row past the pack, then cut off
    xs = xe.new_zeros((tk + 1, xe.shape[-1]))
    xs[dest.long()] = xe[token_idx]
    return MoeDispatch(xs[:tk], sizes, counts, dest, slot, token_idx, order,
                       in_cap, sorted_e)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last dim with the sum taken by
    elementwise adds, so a row's bits do not depend on the batch."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / _row_sum(e)


def _route(xe: torch.Tensor, router: torch.Tensor, top_k: int):
    # the JAX package multiplies bf16 tokens by the f32 router with A
    # promoted to f32; the cast here is that promotion (exact), so the
    # kernels see one dtype
    logits = ops.gemm(xe.to(router.dtype), router, out_dtype=torch.float32)
    probs = _softmax(logits)                                   # (t, E)
    # a stable descending sort puts equal probabilities in ascending
    # expert order: lax.top_k's tie-break
    gate_vals, top_ids = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_vals, top_ids = gate_vals[:, :top_k], top_ids[:, :top_k]
    gate_vals = gate_vals / _row_sum(gate_vals)
    return probs, gate_vals, top_ids


def _aux_loss(counts: torch.Tensor, probs: torch.Tensor, n_tokens
              ) -> torch.Tensor:
    """Switch-style load-balance loss ``E * sum_e f_e * p_e`` from the
    dispatch's expert counts."""
    n_experts = counts.shape[0]
    freq = counts.float() / n_tokens
    return n_experts * torch.sum(freq * torch.mean(probs, dim=0))


def _bank(w, dtype) -> torch.Tensor:
    """Dense view of an expert bank (dequantizes ``{"q", "scale"}``)."""
    return quant.dequantize_weight(w, dtype) if quant.is_quantized(w) \
        else w


def _expert_gemms(params: dict, xs: torch.Tensor, sizes: torch.Tensor,
                  dtype, dense_rows: int = 0) -> torch.Tensor:
    """SwiGLU over the ragged expert-sorted rows: three grouped ragged
    GEMMs against the stacked banks, silu fused into the gate GEMM's
    flush.  Quantized banks (``{"q", "scale"}``) stream int8 and widen in
    registers (W8A16).  ``dense_rows`` is the E*C row count a
    capacity-padded formulation would compute (plan billing context
    only)."""
    dr = dense_rows or None
    with shared_tables():       # the three GEMMs share one set of tables
        gate = ops.gemm_grouped(xs, params["w_gate"], sizes,
                                activation="silu", out_dtype=dtype,
                                dense_rows=dr)
        up = ops.gemm_grouped(xs, params["w_up"], sizes, out_dtype=dtype,
                              dense_rows=dr)
        return ops.gemm_grouped(gate * up, params["w_down"], sizes,
                                out_dtype=dtype, dense_rows=dr)


def _combine(ys: torch.Tensor, dsp: MoeDispatch, gate_vals: torch.Tensor,
             t: int, top_k: int) -> torch.Tensor:
    """``zeros.at[token_idx].add(ys[dest] * weights)``: a token's k
    contributions, each rounded to the activation dtype, added in
    ascending expert order (the order of the sorted assignments) with a
    rounding after every add.  CUDA's scatter-add would add them in a
    varying order; here the order is fixed."""
    tk = t * top_k
    gathered = ys[torch.clamp(dsp.dest, max=tk - 1).long()]
    weights = (gate_vals.reshape(-1)[dsp.order] * dsp.in_cap.float()) \
        .to(ys.dtype)
    contrib = gathered * weights[:, None]                  # sorted order
    # each token's sorted positions, ascending = ascending expert id
    inv = torch.empty_like(dsp.order)
    inv[dsp.order] = torch.arange(tk, device=ys.device)
    pos = torch.sort(inv.view(t, top_k), dim=-1).values
    per_token = contrib[pos]                               # (t, k, d)
    y = ys.new_zeros((t, ys.shape[-1]))
    for j in range(top_k):
        y = y + per_token[:, j]
    return y


def _emit_moe_counters(n_assignments: int, sizes: torch.Tensor) -> None:
    """``moe.group_sizes`` (rows routed through the grouped GEMMs) and
    ``moe.dropped_tokens`` (capacity-dropped assignments), only while
    telemetry is on.  The sums stay on the device (a ``.item()`` here
    would sync every MoE layer of every step) until the snapshot reads
    them; nothing is counted while a CUDA graph is being captured."""
    if not telemetry.enabled():
        return
    if sizes.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    kept = sizes.sum(dtype=torch.int64)
    telemetry.counter("moe.group_sizes").add(kept)
    telemetry.counter("moe.dropped_tokens").add(n_assignments - kept)


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, aux_loss: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (b, s, d) -> (y: (b, s, d), aux_loss: scalar) — the JAX
    package's ``_moe_ffn_pjit``.  The aux loss is a training value:
    ``aux_loss=False`` (serving) skips it and returns None in its
    place."""
    b, s, d = x.shape
    t = b * s
    n_experts = params["router"].shape[-1]
    c = capacity(t, n_experts, top_k, capacity_factor)
    xe = x.reshape(t, d)
    probs, gate_vals, top_ids = _route(xe, params["router"], top_k)
    dsp = _sort_dispatch(xe, top_ids, top_k, n_experts, c)
    _emit_moe_counters(t * top_k, dsp.sizes)
    aux = _aux_loss(dsp.counts, probs, t) if aux_loss else None
    ys = _expert_gemms(params, dsp.xs, dsp.sizes, x.dtype,
                       dense_rows=n_experts * c)
    return _combine(ys, dsp, gate_vals, t, top_k).reshape(b, s, d), aux


def moe_ffn_dense_ref(params: dict, x: torch.Tensor, *, top_k: int
                      ) -> torch.Tensor:
    """Dense oracle: every expert computed for every token, combined with
    the same renormalised top-k gates, no capacity drops (a test oracle
    of the dispatch path when nothing drops); quantized banks are
    dequantized up front (``repro/models/moe.py`` ``_bank``)."""
    b, s, d = x.shape
    xe = x.reshape(b * s, d)
    probs = torch.softmax(xe.float() @ params["router"], dim=-1)
    gate_vals, top_ids = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_vals, top_ids = gate_vals[:, :top_k], top_ids[:, :top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter_(1, top_ids, gate_vals)
    gate = torch.einsum("td,edf->tef", xe, _bank(params["w_gate"], x.dtype))
    up = torch.einsum("td,edf->tef", xe, _bank(params["w_up"], x.dtype))
    h = F.silu(gate.float()).to(x.dtype) * up
    out = torch.einsum("tef,efd->ted", h, _bank(params["w_down"], x.dtype))
    y = torch.einsum("ted,te->td", out.float(), combine)
    return y.to(x.dtype).reshape(b, s, d)
