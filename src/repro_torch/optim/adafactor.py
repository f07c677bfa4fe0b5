"""Adafactor, factored second moments (port of
``repro/optim/adafactor.py``; Shazeer & Stern 2018: the beta2 schedule,
RMS update clipping, no momentum).

For a leaf of two or more dimensions the second-moment estimate is a
row statistic over the last axis (``vr``, shape ``p.shape[:-1]``) and a
column statistic over the second-to-last (``vc``, shape
``p.shape[:-2] + p.shape[-1:]``) instead of one value an element; a 1-D
leaf keeps the full statistic in ``vr`` and a (1,) placeholder in
``vc``.  States are f32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.bridge import map_tree, tree_leaves, zip_trees


class AdafactorState(NamedTuple):
    step: torch.Tensor          # () int32
    vr: dict                    # row stats (matrices) / full stats (vectors)
    vc: dict                    # col stats (matrices) / (1,) (vectors)


EPS1 = 1e-30
CLIP = 1.0


def _factored(p) -> bool:
    return p.dim() >= 2


def init(params) -> AdafactorState:
    def vr_init(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc_init(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    some = next(iter(tree_leaves(params)))
    return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                           device=some.device),
                          vr=map_tree(vr_init, params),
                          vc=map_tree(vc_init, params))


def state_specs(param_specs, params) -> AdafactorState:
    """Spec tree mirroring :func:`init`: row stats drop the parameter
    spec's last entry, col stats its second-to-last, so factored moments
    stay sharded like the dims they summarize."""
    from repro_torch.dist.sharding import P

    def vr_spec(s, p):
        return P(*s[:-1]) if _factored(p) else P(*s)

    def vc_spec(s, p):
        return P(*(tuple(s[:-2]) + (s[-1],))) if _factored(p) else P(None)

    return AdafactorState(step=P(),
                          vr=zip_trees(vr_spec, param_specs, params),
                          vc=zip_trees(vc_spec, param_specs, params))


@torch.no_grad()
def update(grads, state: AdafactorState, params, *, lr,
           weight_decay: float = 0.0, sum_over=None
           ) -> Tuple[dict, AdafactorState]:
    """One step: (new params, new state).  ``sum_over``: a tree like
    ``params`` whose leaf is None, or, for a leaf this rank holds one
    block of, a function summing a tensor over the ranks holding the
    others; the RMS clip then takes the whole leaf's mean."""
    step = state.step + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - torch.pow(t, -0.8)

    def upd(g, vr, vc, p, total):
        gf = g.float()
        g2 = gf * gf + EPS1
        if _factored(p):
            vr_new = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
            vc_new = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
            r = vr_new / torch.clamp(vr_new.mean(dim=-1, keepdim=True),
                                     min=EPS1)
            u = gf / (torch.sqrt(r)[..., None]
                      * torch.sqrt(vc_new)[..., None, :] + EPS1)
        else:
            vr_new = beta2 * vr + (1 - beta2) * g2
            vc_new = vc
            u = gf / (torch.sqrt(vr_new) + EPS1)
        if total is None:
            ms = (u * u).mean()
        else:                           # the mean over every rank's block
            sq_n = total(torch.stack([
                (u * u).sum().double(),
                torch.full((), u.numel(), dtype=torch.float64,
                           device=u.device)]))
            ms = (sq_n[0] / sq_n[1]).float()
        rms = torch.sqrt(ms + EPS1)                      # RMS clip
        u = u / torch.clamp(rms / CLIP, min=1.0)
        if p.dim() >= 2 and weight_decay:
            u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), vr_new, vc_new

    if sum_over is None:
        sum_over = map_tree(lambda _: None, params)
    out = zip_trees(upd, grads, state.vr, state.vc, params, sum_over)
    return (map_tree(lambda o: o[0], out),
            AdafactorState(step=step,
                           vr=map_tree(lambda o: o[1], out),
                           vc=map_tree(lambda o: o[2], out)))
