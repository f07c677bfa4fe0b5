"""RG-LRU recurrent block (port of ``repro/models/rglru.py``;
RecurrentGemma / Griffin, arXiv:2402.19427).

The recurrence:  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
with a_t = exp(-c * softplus(Lambda) * r_t), r_t / i_t input-dependent
sigmoid gates.  Prefill and training run the recurrence as a log-depth
doubling scan of elementwise ops (:func:`_lru_scan`: about log2(s)
rounds, not s kernel launches); decode is a single state update.

Block structure (Griffin residual block): in-proj to (branch, gate), a
short causal conv on the branch, the RG-LRU, gated by gelu(gate) (the
tanh form, as ``jax.nn.gelu``), out-proj.  The four projections go
through :func:`repro_torch.ops.gemm`; there is no Pallas kernel in this
module, so none on the card either.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.models.layers import dense_init

CONV_WIDTH = 4
C_FACTOR = 8.0


def init_rglru(generator: torch.Generator, d_model: int, lru_width: int,
               dtype, lead=()) -> dict:
    """Random parameters in the JAX layout and with its init's
    distributions (Lambda so that a^c spans (0.9, 0.999)); ``lead`` is a
    leading stacked shape (the repeats axis)."""
    lead = tuple(lead)
    dev = generator.device
    u = torch.rand(lead + (lru_width,), generator=generator, device=dev,
                   dtype=torch.float32) * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2
    return {
        "in_proj": dense_init(generator, lead + (d_model, 2 * lru_width),
                              dtype),
        "conv_w": (torch.randn(lead + (CONV_WIDTH, lru_width),
                               generator=generator, device=dev,
                               dtype=torch.float32) * 0.2).to(dtype),
        "conv_b": torch.zeros(lead + (lru_width,), dtype=dtype, device=dev),
        "w_r": dense_init(generator, lead + (lru_width, lru_width), dtype),
        "w_i": dense_init(generator, lead + (lru_width, lru_width), dtype),
        "lambda": torch.log(torch.exp(-torch.log(u) / C_FACTOR) - 1.0),
        "out_proj": dense_init(generator, lead + (lru_width, d_model), dtype),
    }


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d of width 4 at storage dtype, its taps
    summed in order from the first; ``state``: the (b, 3, ch) carry-in.
    Returns (y, new state)."""
    s = x.shape[1]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, CONV_WIDTH):
        y = y + xp[:, i:i + s] * w[i]
    return y + b, xp[:, -(CONV_WIDTH - 1):]


def _gates(params: dict, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, gated input) in f32: a = exp(-c softplus(Lambda) r) and
    sqrt(1 - a^2) * i * x, r and i sigmoid of the planned GEMMs."""
    r = torch.sigmoid(ops.gemm(x, params["w_r"]).float())
    i = torch.sigmoid(ops.gemm(x, params["w_i"]).float())
    log_a = -C_FACTOR * F.softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    gate_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                    min=1e-12))
    return a, gate_x * i * x.float()


def _lru_scan(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor
              ) -> torch.Tensor:
    """h_t = a_t h_{t-1} + bx_t along axis 1, h0 folded into position 0
    (``jax.lax.associative_scan`` of the same combine in the JAX
    package).  A doubling scan: round j combines each position with the
    one 2^j before it, so ceil(log2 s) rounds of elementwise ops.
    a, bx: (b, s, w) f32; h0: (b, w)."""
    bx = torch.cat([(bx[:, 0] + a[:, 0] * h0)[:, None], bx[:, 1:]], dim=1)
    s = a.shape[1]
    off = 1
    while off < s:
        bx = torch.cat([bx[:, :off], a[:, off:] * bx[:, :-off] + bx[:, off:]],
                       dim=1)
        if 2 * off < s:          # the last round needs no products of a
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return bx


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="tanh")


def rglru_scan(params: dict, x: torch.Tensor, state: dict
               ) -> Tuple[torch.Tensor, dict]:
    """The block over a whole sequence from ``state`` ({"conv", "h"}):
    in-proj, conv, gates, scan, gelu gate, out-proj.  Returns (y, the
    state after the last position)."""
    proj = ops.gemm(x, params["in_proj"])
    branch, gate = proj.chunk(2, dim=-1)
    branch, conv_state = _conv(branch, params["conv_w"], params["conv_b"],
                               state["conv"])
    a, bx = _gates(params, branch)
    h = _lru_scan(a, bx, state["h"])
    y = h.to(x.dtype) * _gelu(gate).to(x.dtype)
    return ops.gemm(y, params["out_proj"]), \
        {"conv": conv_state, "h": h[:, -1]}


def rglru_block(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block from a zero state.
    x: (b, s, d_model)."""
    bsz = x.shape[0]
    lru_width = params["conv_b"].shape[-1]
    y, _ = rglru_scan(params, x, init_rglru_cache(bsz, lru_width, x.dtype,
                                                  x.device))
    return y


def init_rglru_cache(batch: int, lru_width: int, dtype, device) -> dict:
    return {"conv": torch.zeros((batch, CONV_WIDTH - 1, lru_width),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, lru_width), dtype=torch.float32,
                             device=device)}


def rglru_decode(params: dict, x: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """Single-token step.  x: (b, 1, d_model).  Returns (y, the new
    state); ``cache`` is not written."""
    proj = ops.gemm(x, params["in_proj"])
    branch, gate = proj.chunk(2, dim=-1)
    branch, conv_state = _conv(branch, params["conv_w"], params["conv_b"],
                               cache["conv"])
    a, bx = _gates(params, branch)
    h = a[:, 0] * cache["h"] + bx[:, 0]
    y = h[:, None, :].to(x.dtype) * _gelu(gate).to(x.dtype)
    return ops.gemm(y, params["out_proj"]), {"conv": conv_state, "h": h}

