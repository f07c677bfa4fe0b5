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

from typing import Iterable, NamedTuple, Tuple

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


def _leaf(g, vr, vc, p, total, *, beta2, lr, weight_decay):
    """One leaf's (new p, new vr, new vc); ``total`` as ``sum_over``'s
    leaf.  The inputs are left as they are; each full-size temporary is
    updated in place and dropped as soon as it is used (the same values
    as the expressions written out), so at most about three of them are
    alive at once."""
    gf = g.float()
    g2 = gf * gf
    g2.add_(EPS1)
    if _factored(p):
        vr_new = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
        vc_new = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
        del g2
        r = vr_new / torch.clamp(vr_new.mean(dim=-1, keepdim=True),
                                 min=EPS1)
        den = torch.sqrt(r)[..., None] * torch.sqrt(vc_new)[..., None, :]
    else:
        vr_new = beta2 * vr + (1 - beta2) * g2
        del g2
        vc_new = vc
        den = torch.sqrt(vr_new)
    den.add_(EPS1)
    u = gf.div_(den) if gf is not g else gf / den
    del gf, den
    if total is None:
        ms = (u * u).mean()
    else:                           # the mean over every rank's block
        sq_n = total(torch.stack([
            (u * u).sum().double(),
            torch.full((), u.numel(), dtype=torch.float64,
                       device=u.device)]))
        ms = (sq_n[0] / sq_n[1]).float()
    rms = torch.sqrt(ms + EPS1)                      # RMS clip
    u.div_(torch.clamp(rms / CLIP, min=1.0))
    if p.dim() >= 2 and weight_decay:
        u.add_(weight_decay * p.float())
    u.mul_(lr)
    pf = p.float()
    new_p = pf.sub_(u) if pf is not p else p - u
    del u
    return new_p.to(p.dtype), vr_new, vc_new


def _beta2(step):
    return 1.0 - torch.pow(step.to(torch.float32), -0.8)


@torch.no_grad()
def update(grads, state: AdafactorState, params, *, lr,
           weight_decay: float = 0.0, sum_over=None
           ) -> Tuple[dict, AdafactorState]:
    """One step: (new params, new state).  ``sum_over``: a tree like
    ``params`` whose leaf is None, or, for a leaf this rank holds one
    block of, a function summing a tensor over the ranks holding the
    others; the RMS clip then takes the whole leaf's mean."""
    step = state.step + 1
    kw = dict(beta2=_beta2(step), lr=lr, weight_decay=weight_decay)
    if sum_over is None:
        sum_over = map_tree(lambda _: None, params)
    out = zip_trees(lambda *a: _leaf(*a, **kw), grads, state.vr, state.vc,
                    params, sum_over)
    return (map_tree(lambda o: o[0], out),
            AdafactorState(step=step,
                           vr=map_tree(lambda o: o[1], out),
                           vc=map_tree(lambda o: o[2], out)))


@torch.no_grad()
def update_(grads: Iterable, state: AdafactorState, params, *, lr,
            weight_decay: float = 0.0, sum_over=None) -> None:
    """:func:`update` written into ``params`` and ``state`` in place (the
    JAX step's donated state), the same bits; ``grads`` yields each
    leaf's gradient in leaf order, drawn one leaf at a time (a gradient
    the caller no longer holds is freed once used)."""
    state.step.add_(1)
    kw = dict(beta2=_beta2(state.step), lr=lr, weight_decay=weight_decay)
    totals = list(tree_leaves(sum_over)) if sum_over is not None else None
    for i, (g, vr, vc, p) in enumerate(zip(
            grads, tree_leaves(state.vr), tree_leaves(state.vc),
            tree_leaves(params))):
        _write(g, vr, vc, p, None if totals is None else totals[i], **kw)
        del g


def _write(g, vr, vc, p, total, **kw) -> None:
    """:func:`_leaf` into ``p``, ``vr``, ``vc``; its temporaries die
    here."""
    p_new, vr_new, vc_new = _leaf(g, vr, vc, p, total, **kw)
    p.copy_(p_new)
    vr.copy_(vr_new)
    if vc_new is not vc:
        vc.copy_(vc_new)
