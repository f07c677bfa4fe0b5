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

**Expert parallelism** (:func:`_moe_ffn_ep`, the default under a mesh
whose ``model`` axis has m > 1 ranks, E % m == 0 and s % m == 0;
``REPRO_MOE_EP=0`` turns it off): each rank holds E/m experts (the
banks' expert dim on ``model``, as the layout engine places them) and
takes its s/m slice of the sequence of its rows (the caller has split
the batch over the data axes, so the JAX condition's ``b % |batch|``
holds by construction).  It routes and sorts its tokens into an
``(E, C_src, d)`` send buffer, one all_to_all over ``model`` delivers
every expert its tokens (the ``(E, 1)`` kept counts ride a second), the
receiver packs the chunks ragged and runs the same three grouped GEMMs
(:func:`_ep_grouped_gemms`, B7 on a card), and the mirror all_to_all
brings the outputs back; the combine keeps its ascending expert order
at the source, and the sequence is gathered over ``model``.  A row's
bits do not depend on which rank computed it, so with nothing dropped
the forward equals the single-process ``moe_ffn`` bit for bit.  The
Switch aux loss sums its counts, probabilities and tokens over every
rank.  Banks of the whole E on every rank are cut to the local experts;
local banks off the EP path (s % m != 0) are gathered.

``REPRO_MOE_GROUPED=0`` selects the padded dense-capacity baseline
(:func:`_expert_gemms_dense`, an einsum over ``(E, C, d)``) on both
paths, the A/B baseline and capacity-FLOPs reference of the JAX
package.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops, quant, telemetry
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.kernels.gemm_grouped import shared_tables
from repro_torch.models.layers import _row_sum, dense_init, normal_init
from repro_torch.runtime import graphs


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


def grouped_enabled() -> bool:
    """Grouped ragged expert GEMMs (default); ``REPRO_MOE_GROUPED=0``
    selects the padded dense-einsum baseline."""
    return os.environ.get("REPRO_MOE_GROUPED", "1") != "0"


def ep_enabled() -> bool:
    return os.environ.get("REPRO_MOE_EP", "1") != "0"


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


def _aux_loss_mesh(counts: torch.Tensor, probs: torch.Tensor,
                   n_tokens: int, mesh) -> torch.Tensor:
    """The Switch loss of the whole mesh's tokens: the expert counts,
    the summed probabilities and the token count summed over every rank
    (one all-reduce; model-axis replicas of the same rows scale all
    three alike, which leaves the loss as it is)."""
    n_experts = counts.shape[0]
    sums = torch.cat([counts.float(), torch.sum(probs, dim=0),
                      torch.full((1,), float(n_tokens),
                                 device=probs.device)])
    sums = coll.all_reduce(sums, _world(mesh))
    freq, prob, n = sums[:n_experts], sums[n_experts:-1], sums[-1]
    return n_experts * torch.sum((freq / n) * (prob / n))


def _world(mesh):
    return mesh.world() if shd.mesh_devices(mesh) > 1 else None


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


def _expert_gemms_dense(params: dict, buf: torch.Tensor, dtype
                        ) -> torch.Tensor:
    """Padded dense-capacity baseline: batched einsum over (E, C, d)."""
    gate = torch.einsum("ecd,edf->ecf", buf, _bank(params["w_gate"], dtype))
    up = torch.einsum("ecd,edf->ecf", buf, _bank(params["w_up"], dtype))
    h = F.silu(gate.float()).to(dtype) * up
    return torch.einsum("ecf,efd->ecd", h, _bank(params["w_down"], dtype))


def _capacity_buffer(xe: torch.Tensor, dsp: MoeDispatch, n_experts: int,
                     c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the ``(E, c, d)`` buffer with each kept assignment's token at
    (expert, slot), zeros elsewhere; each assignment's flat row in it,
    ``E * c`` for a dropped one)."""
    flat = torch.where(dsp.in_cap, dsp.sorted_e * c + dsp.slot,
                       n_experts * c).long()
    buf = xe.new_zeros((n_experts * c + 1, xe.shape[-1]))
    buf[flat] = xe[dsp.token_idx]
    return buf[:-1].view(n_experts, c, xe.shape[-1]), flat


def _combine(gathered: torch.Tensor, dsp: MoeDispatch,
             gate_vals: torch.Tensor, t: int, top_k: int) -> torch.Tensor:
    """``zeros.at[token_idx].add(gathered * weights)`` with ``gathered``
    each assignment's expert output in expert-sorted order: a token's k
    contributions, each rounded to the activation dtype, added in
    ascending expert order (the order of the sorted assignments) with a
    rounding after every add.  CUDA's scatter-add would add them in a
    varying order; here the order is fixed."""
    tk = t * top_k
    weights = (gate_vals.reshape(-1)[dsp.order] * dsp.in_cap.float()) \
        .to(gathered.dtype)
    contrib = gathered * weights[:, None]                  # sorted order
    # each token's sorted positions, ascending = ascending expert id
    inv = torch.empty_like(dsp.order)
    inv[dsp.order] = torch.arange(tk, device=gathered.device)
    pos = torch.sort(inv.view(t, top_k), dim=-1).values
    per_token = contrib[pos]                               # (t, k, d)
    y = gathered.new_zeros((t, gathered.shape[-1]))
    for j in range(top_k):
        y = y + per_token[:, j]
    return y


def _emit_moe_counters(n_assignments: int, sizes: torch.Tensor) -> None:
    """``moe.group_sizes`` (rows routed through the grouped GEMMs) and
    ``moe.dropped_tokens`` (capacity-dropped assignments), only while
    telemetry is on.  The sums stay on the device (a ``.item()`` here
    would sync every MoE layer of every step) until the snapshot reads
    them.  While a step is captured by :func:`repro_torch.runtime.graphs.
    capture` they go to the capture's static accumulators, made before
    it, which count every replay; under any other capture nothing is
    counted."""
    if not telemetry.enabled():
        return
    if sizes.is_cuda and torch.cuda.is_current_stream_capturing():
        if graphs.recording():
            kept = sizes.sum(dtype=torch.int64)
            graphs.device_count("moe.group_sizes", kept)
            graphs.device_count("moe.dropped_tokens", n_assignments - kept)
        return
    kept = sizes.sum(dtype=torch.int64)
    telemetry.counter("moe.group_sizes").add(kept)
    telemetry.counter("moe.dropped_tokens").add(n_assignments - kept)


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, aux_loss: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (b, s, d) -> (y: (b, s, d), aux_loss: scalar).  Under a mesh
    whose ``model`` axis has m > 1 ranks, with E % m == 0 and s % m == 0,
    the expert-parallel path (``x``: this rank's rows); else the JAX
    package's ``_moe_ffn_pjit``.  The aux loss is a training value:
    ``aux_loss=False`` (serving) skips it and returns None in its
    place."""
    mesh = shd.current_mesh()
    n_experts = params["router"].shape[-1]
    if mesh is not None and ep_enabled():
        m = shd.axis_sizes(mesh).get("model", 1)
        b, s, _ = x.shape
        if m > 1 and n_experts % m == 0 and s % m == 0 and b * s >= m:
            return _moe_ffn_ep(params, x, top_k=top_k,
                               capacity_factor=capacity_factor, mesh=mesh,
                               aux_loss=aux_loss)
    return _moe_ffn_pjit(params, x, top_k=top_k,
                         capacity_factor=capacity_factor, aux_loss=aux_loss,
                         mesh=mesh)


def _expert_block(w, n_experts: int, mesh):
    """This rank's E/m experts of a bank: the bank itself when it holds
    them already, else its block of the whole E (an int8 struct's
    leaves alike)."""
    if isinstance(w, dict):
        return {k: _expert_block(v, n_experts, mesh) for k, v in w.items()}
    if w.shape[-3] != n_experts:
        return w
    m = shd.axis_sizes(mesh)["model"]
    e_loc = n_experts // m
    return w.narrow(-3, mesh.coord["model"] * e_loc, e_loc)


def _whole_banks(params: dict, mesh) -> dict:
    """``params`` with every expert bank of the whole E: local blocks
    are gathered over ``model``."""
    n_experts = params["router"].shape[-1]

    def whole(w):
        if isinstance(w, dict):
            return {k: whole(v) for k, v in w.items()}
        if w.shape[-3] == n_experts:
            return w
        return coll.all_gather(w, w.dim() - 3, mesh.group("model"))

    return {k: whole(v) if k.startswith("w_") else v
            for k, v in params.items()}


def _moe_ffn_pjit(params: dict, x: torch.Tensor, *, top_k: int,
                  capacity_factor: float, aux_loss: bool, mesh=None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Every expert on this rank, over the rank's rows; under a mesh the
    aux loss is the whole mesh's (:func:`_aux_loss_mesh`)."""
    b, s, d = x.shape
    t = b * s
    if mesh is not None and shd.mesh_devices(mesh) > 1:
        params = _whole_banks(params, mesh)
    else:
        mesh = None
    n_experts = params["router"].shape[-1]
    c = capacity(t, n_experts, top_k, capacity_factor)
    xe = x.reshape(t, d)
    probs, gate_vals, top_ids = _route(xe, params["router"], top_k)
    dsp = _sort_dispatch(xe, top_ids, top_k, n_experts, c)
    _emit_moe_counters(t * top_k, dsp.sizes)
    aux = None
    if aux_loss:
        aux = _aux_loss(dsp.counts, probs, t) if mesh is None \
            else _aux_loss_mesh(dsp.counts, probs, t, mesh)
    if grouped_enabled():
        ys = _expert_gemms(params, dsp.xs, dsp.sizes, x.dtype,
                           dense_rows=n_experts * c)
        gathered = ys[torch.clamp(dsp.dest, max=t * top_k - 1).long()]
    else:
        buf, flat = _capacity_buffer(xe, dsp, n_experts, c)
        out = _expert_gemms_dense(params, buf, x.dtype).reshape(-1, d)
        gathered = out[torch.clamp(flat, max=n_experts * c - 1)]
    return _combine(gathered, dsp, gate_vals, t, top_k).reshape(b, s, d), \
        aux


def _ep_grouped_gemms(params: dict, recv: torch.Tensor, sz: torch.Tensor,
                      c: int, dtype) -> torch.Tensor:
    """Grouped expert GEMMs on one EP rank's receive buffer.

    ``recv`` is the (E_loc, n_src*c, d) all_to_all product: each local
    expert's tokens arrive as n_src chunks of capacity c with
    ``sz[e, src]`` live rows each.  Pack them ragged (one scatter), run
    the same grouped GEMMs as the single-rank path with group sizes
    summed over the sources, and scatter back to the chunk layout the
    mirror all_to_all expects (dead rows zero)."""
    e_loc, n_src = sz.shape
    d = recv.shape[-1]
    rows = e_loc * n_src * c
    gsize = torch.sum(sz, dim=1, dtype=torch.int32)
    gstart = torch.cumsum(gsize, 0, dtype=torch.int32) - gsize
    src_off = torch.cumsum(sz, 1, dtype=torch.int32) - sz
    i = torch.arange(c, dtype=torch.int32, device=recv.device)
    dest = gstart[:, None, None] + src_off[:, :, None] + i[None, None, :]
    valid = i[None, None, :] < sz[:, :, None]
    dest = torch.where(valid, dest, rows).reshape(rows).long()
    xs = recv.new_zeros((rows + 1, d))
    xs[dest] = recv.reshape(rows, d)
    ys = _expert_gemms(params, xs[:rows], gsize, dtype, dense_rows=rows)
    out = torch.where(valid.reshape(rows, 1),
                      ys[torch.clamp(dest, max=rows - 1)], 0)
    return out.reshape(e_loc, n_src * c, d)


def _moe_ffn_ep(params: dict, x: torch.Tensor, *, top_k: int,
                capacity_factor: float, mesh, aux_loss: bool
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Expert parallelism over ``model``: a local sort-dispatch and one
    all_to_all each way (the JAX package's ``_moe_ffn_ep``).

    This rank's tokens are the s/m positions at its ``model`` index of
    its rows: t_loc = b * s / m; send buffer (E, C_src, d) with the
    per-source capacity C_src; the all_to_all yields (E/m, m*C_src, d):
    every local expert sees its tokens from all sources, and the kept
    counts ride an (E, 1) int32 all_to_all so the receiver can pack the
    chunks ragged."""
    n_experts = params["router"].shape[-1]
    m = shd.axis_sizes(mesh)["model"]
    e_loc = n_experts // m
    group = mesh.group("model")
    banks = {k: _expert_block(params[k], n_experts, mesh)
             for k in ("w_gate", "w_up", "w_down")}

    def local(x_loc, router):
        b, s_loc, d = x_loc.shape
        t = b * s_loc
        xe = x_loc.reshape(t, d)
        probs, gate_vals, top_ids = _route(xe, router, top_k)
        c = capacity(t, n_experts, top_k, capacity_factor)
        dsp = _sort_dispatch(xe, top_ids, top_k, n_experts, c)
        _emit_moe_counters(t * top_k, dsp.sizes)
        buf, flat = _capacity_buffer(xe, dsp, n_experts, c)
        # (E, C, d) -> (E/m, m*C, d): block r of the exchange is source r
        recv = coll.all_to_all(buf, group).view(m, e_loc, c, d) \
            .transpose(0, 1).reshape(e_loc, m * c, d)
        if grouped_enabled():
            sz = coll.all_to_all(dsp.sizes.view(n_experts, 1), group) \
                .view(m, e_loc).t()
            out_loc = _ep_grouped_gemms(banks, recv, sz, c, x_loc.dtype)
        else:
            out_loc = _expert_gemms_dense(banks, recv, x_loc.dtype)
        # mirror: (E/m, m*C, d) -> (E, C, d) back at the source
        back = coll.all_to_all(
            out_loc.view(e_loc, m, c, d).transpose(0, 1).contiguous(),
            group).reshape(n_experts * c, d)
        gathered = back[torch.clamp(flat, max=n_experts * c - 1)]
        y = _combine(gathered, dsp, gate_vals, t, top_k)
        aux = _aux_loss_mesh(dsp.counts, probs, t, mesh) if aux_loss \
            else torch.zeros((), device=x_loc.device)
        return y.reshape(b, s_loc, d), aux

    seq = shd.P(None, "model", None)
    y, aux = shd.shard_map(local, mesh, in_specs=(seq, shd.P()),
                           out_specs=(seq, shd.P()))(x, params["router"])
    return y, (aux if aux_loss else None)


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
