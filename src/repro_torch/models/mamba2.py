"""Mamba-2 (SSD, state-space duality) block (port of
``repro/models/mamba2.py``; arXiv:2405.21060).

The chunked, matmul-form SSD algorithm: the sequence is split into
chunks of 128; within a chunk the output is a masked (attention-like)
product, across chunks a small recurrent state (heads, head_dim,
d_state) is carried.  Its products are plain ``torch.einsum`` outside
any kernel, as the JAX package leaves them to XLA; the in- and
out-projections go through :func:`repro_torch.ops.gemm`.

Decode is one state update a token.  Its read-out
``y = sum_n C_n state_{h,p,n}`` is an elementwise product summed by
:func:`repro_torch.models.layers._row_sum`, not a batched GEMM, so a
slot's bits are the same at batch 1 and inside a continuous batch.

Layout: d_inner = 2 * d_model, heads = d_inner / 64, one B/C group,
a scalar A per head.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.models.layers import _row_sum, dense_init, rms_norm

CONV_WIDTH = 4
HEAD_DIM = 64


def dims(d_model: int, d_state: int) -> dict:
    d_inner = 2 * d_model
    heads = d_inner // HEAD_DIM
    return {"d_inner": d_inner, "heads": heads, "head_dim": HEAD_DIM,
            "d_state": d_state,
            # in_proj produces: z, x, B, C, dt
            "proj_out": 2 * d_inner + 2 * d_state + heads}


def init_mamba2(generator: torch.Generator, d_model: int, d_state: int,
                dtype, lead=()) -> dict:
    """Random parameters in the JAX layout and with its init's values
    (A from 1 to 16 over the heads, dt's bias from 1e-3 to 0.1 through
    softplus); ``lead`` is a leading stacked shape (the repeats axis)."""
    lead = tuple(lead)
    dev = generator.device
    dd = dims(d_model, d_state)
    h = dd["heads"]
    conv_ch = dd["d_inner"] + 2 * d_state          # x, B, C get conv'd

    def per_head(t):
        return t.to(dev).expand(lead + (h,)).clone()

    f32 = dict(dtype=torch.float32)
    return {
        "in_proj": dense_init(generator, lead + (d_model, dd["proj_out"]),
                              dtype),
        "conv_w": (torch.randn(lead + (CONV_WIDTH, conv_ch),
                               generator=generator, device=dev, **f32)
                   * 0.2).to(dtype),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "a_log": per_head(torch.log(torch.linspace(1.0, 16.0, h, **f32))),
        "d_skip": torch.ones(lead + (h,), device=dev, **f32),
        "dt_bias": per_head(torch.log(
            torch.exp(torch.linspace(1e-3, 0.1, h, **f32)) - 1.0 + 1e-9)),
        "norm": {"scale": torch.ones(lead + (dd["d_inner"],), device=dev,
                                     **f32)},
        "out_proj": dense_init(generator, lead + (dd["d_inner"], d_model),
                               dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d, then silu in f32.  x: (b, s, ch); w: (W,
    ch); ``state``: (b, W-1, ch) carry-in.  Returns (y, new state)."""
    bsz, s, ch = x.shape
    if state is None:
        state = torch.zeros((bsz, CONV_WIDTH - 1, ch), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, CONV_WIDTH):
        y = y + xp[:, i:i + s] * w[i]
    y = F.silu((y + b).float()).to(x.dtype)
    return y, xp[:, -(CONV_WIDTH - 1):]


def _split_proj(proj: torch.Tensor, d_model: int, d_state: int):
    dd = dims(d_model, d_state)
    di = dd["d_inner"]
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    b_ = proj[..., 2 * di:2 * di + d_state]
    c_ = proj[..., 2 * di + d_state:2 * di + 2 * d_state]
    dt = proj[..., 2 * di + 2 * d_state:]
    return z, x, b_, c_, dt


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Causal segment-sum: out[i, j] = sum_{j < l <= i} a[l] (lower-tri),
    -inf above the diagonal.  a: (..., q)."""
    q = a.shape[-1]
    cums = torch.cumsum(a, dim=-1)
    diff = cums[..., :, None] - cums[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_: torch.Tensor, c_: torch.Tensor, d_skip: torch.Tensor,
                dt_bias: torch.Tensor, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (bsz, s, h, p); dt: (bsz, s, h); b_, c_: (bsz, s, n) single group.
    Returns (y: (bsz, s, h, p), final_state: (bsz, h, p, n) f32).
    """
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_ = F.pad(b_, (0, 0, 0, pad))
        c_ = F.pad(c_, (0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk

    dtf = F.softplus(dt.float() + dt_bias)                      # (b,sp,h)
    if pad:
        # padded positions must neither decay the state nor feed it
        valid = (torch.arange(sp, device=x.device) < s)[None, :, None]
        dtf = torch.where(valid, dtf, torch.zeros((), device=x.device))
    a = -torch.exp(a_log)                                        # (h,)
    da = dtf * a                                                 # log-decay
    xb = x.float() * dtf[..., None]                              # dt-scaled

    def ch(t):
        return t.reshape((bsz, nc, chunk) + tuple(t.shape[2:]))
    xc, dac, bc, cc = ch(xb), ch(da), ch(b_.float()), ch(c_.float())

    # intra-chunk (diagonal) term: an attention-like masked product
    lmat = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))       # (b,nc,h,q,q)
    scores = torch.einsum("bzqn,bzkn->bzqk", cc, bc)          # (b,nc,q,q)
    y_diag = torch.einsum("bzhqk,bzqk,bzkhp->bzqhp", lmat, scores, xc)

    # chunk-final states: sum_k decay_to_end(k) * B_k (x) x_k
    cumsum_da = torch.cumsum(dac, dim=2)                      # (b,nc,q,h)
    decay_to_end = torch.exp(cumsum_da[:, :, -1:, :] - cumsum_da)
    states = torch.einsum("bzkh,bzkn,bzkhp->bzhpn", decay_to_end, bc, xc)

    # inter-chunk recurrence over the chunks, in order
    chunk_decay = torch.exp(cumsum_da[:, :, -1, :])           # (b,nc,h)
    st = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    prev = []
    for z in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                    # (b,nc,h,p,n)

    # inter-chunk (off-diagonal) output: C_q . decay_from_start . h_prev
    decay_from_start = torch.exp(cumsum_da)                   # (b,nc,q,h)
    y_off = torch.einsum("bzqn,bzqh,bzhpn->bzqhp", cc, decay_from_start,
                         prev_states)

    y = (y_diag + y_off).reshape(bsz, sp, h, p)
    y = y + x.float() * d_skip[None, None, :, None]
    return y[:, :s].to(x.dtype), st


def mamba2_scan(params: dict, x: torch.Tensor, d_state: int,
                state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """The mixer over a whole sequence from ``state`` ({"conv", "ssd"};
    zeros when None).  x: (b, s, d_model).  Returns (y, the state after
    the last position)."""
    bsz, s, d_model = x.shape
    dd = dims(d_model, d_state)
    di = dd["d_inner"]
    proj = ops.gemm(x, params["in_proj"])
    z, xs, b_, c_, dt = _split_proj(proj, d_model, d_state)
    conv_in = torch.cat([xs, b_, c_], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, params["conv_w"], params["conv_b"],
        None if state is None else state["conv"])
    xs = conv_out[..., :di]
    b_ = conv_out[..., di:di + d_state]
    c_ = conv_out[..., di + d_state:]
    xh = xs.reshape(bsz, s, dd["heads"], dd["head_dim"])
    y, ssd = ssd_chunked(xh, dt, params["a_log"], b_, c_, params["d_skip"],
                         params["dt_bias"],
                         init_state=None if state is None else state["ssd"])
    y = y.reshape(bsz, s, di)
    y = rms_norm(params["norm"], y) * F.silu(z.float()).to(x.dtype)
    return ops.gemm(y, params["out_proj"]), {"conv": conv_state, "ssd": ssd}


def mamba2_block(params: dict, x: torch.Tensor, d_state: int
                 ) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer from a zero state.  x: (b, s,
    d_model)."""
    y, _ = mamba2_scan(params, x, d_state)
    return y


def init_mamba2_cache(batch: int, d_model: int, d_state: int, dtype,
                      device) -> dict:
    dd = dims(d_model, d_state)
    conv_ch = dd["d_inner"] + 2 * d_state
    return {
        "conv": torch.zeros((batch, CONV_WIDTH - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, dd["heads"], dd["head_dim"], d_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(params: dict, x: torch.Tensor, cache: dict, d_state: int
                  ) -> Tuple[torch.Tensor, dict]:
    """Single-token step.  x: (b, 1, d_model).  Returns (y, the new
    state); ``cache`` is not written."""
    bsz, s, d_model = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    dd = dims(d_model, d_state)
    di = dd["d_inner"]
    proj = ops.gemm(x, params["in_proj"])
    z, xs, b_, c_, dt = _split_proj(proj, d_model, d_state)
    conv_in = torch.cat([xs, b_, c_], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"],
                                        params["conv_b"], cache["conv"])
    xs = conv_out[..., :di]
    b_ = conv_out[:, 0, di:di + d_state].float()                # (b, n)
    c_ = conv_out[:, 0, di + d_state:].float()                  # (b, n)

    dtf = F.softplus(dt[:, 0].float() + params["dt_bias"])      # (b, h)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dtf * a)                                  # (b, h)
    xh = xs[:, 0].reshape(bsz, dd["heads"], dd["head_dim"])
    xb = xh.float() * dtf[..., None]
    state = cache["ssd"] * decay[..., None, None] \
        + xb[..., None] * b_[:, None, None, :]
    # sum over n by elementwise halving: no GEMM whose algorithm could
    # change with the batch
    y = _row_sum(state * c_[:, None, None, :])[..., 0]          # (b, h, p)
    y = y + xh.float() * params["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rms_norm(params["norm"], y) * F.silu(z.float()).to(x.dtype)
    return ops.gemm(y, params["out_proj"]), {"conv": conv_state, "ssd": state}
