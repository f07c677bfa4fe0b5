"""Blocked online-softmax attention in plain PyTorch (port of
``repro/kernels/blocked_attention.py``).

The reference has no Pallas kernel here: this is the plain twin of
kernel B3's recurrence (q chunks x kv chunks, running max / sum /
accumulator), which the attention backward recomputes through when a
sequence is longer than ``BLOCKED_ATTN_THRESHOLD`` positions, so no
(b, heads, sq, skv) score tensor is ever materialized.  Peak score
memory is (b, heads, bq, bkv).

Each kv step is wrapped in ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``): the backward recomputes a step's scores instead of
storing every chunk's probabilities.  GQA is handled by head-grouped
einsums (no kv-head materialization).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ref import NEG_INF

#: above this many query / kv positions the backward recomputes through
#: :func:`attention_blocked` instead of the unblocked reference
#: (``repro/kernels/attn_api.py:55``)
BLOCKED_ATTN_THRESHOLD = 1024


def _kv_step(m, l, acc, qck, qpos, kck, vck, kpos, *, skv: int,
             causal: bool, window: int, scale: float):
    """One kv chunk of the online softmax for one q chunk.
    qck: (b, bq, hkv, g, d); kck / vck: (b, bkv, hkv, d);
    m / l: (b, hkv, g, bq, 1); acc: (b, hkv, g, bq, d)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qck.float() * scale, kck.float())
    valid = (kpos < skv)[None, :]
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    p = torch.where(valid, p, torch.zeros_like(p))
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                         vck.float())
    return m_new, l_new, acc_new


def attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      q_offset: Optional[int] = None,
                      bq: int = 512, bkv: int = 1024) -> torch.Tensor:
    """q: (b, sq, hq, d); k / v: (b, skv, hkv, d) -> (b, sq, hq, d) in
    q's dtype; ``q_offset`` defaults to skv - sq."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"attention_blocked: {hq} q heads over {hkv} kv "
                         "heads")
    g = hq // hkv
    if q_offset is None:
        q_offset = skv - sq
    scale = float(scale if scale is not None else d ** -0.5)
    bq, bkv = min(bq, sq), min(bkv, skv)
    pad_q, pad_kv = (-sq) % bq, (-skv) % bkv
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nq, nk = (sq + pad_q) // bq, (skv + pad_kv) // bkv
    qc = qp.reshape(b, nq, bq, hkv, g, d)
    kc = kp.reshape(b, nk, bkv, hkv, d)
    vc = vp.reshape(b, nk, bkv, hkv, d)
    qpos = (torch.arange(nq * bq, device=q.device) + q_offset).reshape(nq,
                                                                       bq)
    kpos = torch.arange(nk * bkv, device=q.device).reshape(nk, bkv)
    kw = dict(skv=skv, causal=causal, window=window, scale=scale)

    def step(m, l, acc, qck, qp_, kck, vck, kp_):
        return _kv_step(m, l, acc, qck, qp_, kck, vck, kp_, **kw)

    outs = []
    for i in range(nq):
        m = torch.full((b, hkv, g, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, bq, d), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            m, l, acc = checkpoint(step, m, l, acc, qc[:, i], qpos[i],
                                   kc[:, j], vc[:, j], kpos[j],
                                   use_reentrant=False)
        out = acc / torch.where(l > 0, l, torch.ones_like(l))
        # (b, hkv, g, bq, d) -> (b, bq, hkv * g, d)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, bq, hq, d)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]
