"""AdamW with decoupled weight decay (port of ``repro/optim/adamw.py``).

States are f32 whatever the parameter dtype (bf16-safe training), in a
tree that mirrors the parameter tree.  Weight decay applies to leaves
of two or more dimensions only: a norm scale or bias (1-D) gets none.
The stacked ``layers/u{i}`` leaves carry a leading repeats axis, so a
stacked norm scale is 2-D and decays, exactly as in the reference.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Tuple

import torch

from repro_torch.bridge import map_tree, tree_leaves, zip_trees


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: dict
    nu: dict


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    some = next(iter(tree_leaves(params)))
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=some.device),
                      mu=map_tree(zeros, params), nu=map_tree(zeros, params))


def state_specs(param_specs, params) -> AdamWState:
    """Spec tree mirroring :func:`init` (the moments inherit each
    parameter's spec verbatim)."""
    from repro_torch.dist.sharding import P
    return AdamWState(step=P(), mu=map_tree(lambda s: s, param_specs),
                      nu=map_tree(lambda s: s, param_specs))


def _leaf(g, m, v, p, *, c1, c2, lr, b1, b2, eps, weight_decay, decay):
    """One leaf's (new p, new m, new v); elementwise, so a slice of the
    leaves gives the same bits as the whole leaf."""
    gf = g.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    if decay:                            # no decay on norms / biases
        delta = delta + weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m_new, v_new


def _bias_corrections(step, b1: float, b2: float):
    t = step.to(torch.float32)
    return 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1) -> Tuple[dict, AdamWState]:
    """One step: (new params, new state).  ``lr`` is a float or a 0-d
    tensor on the parameters' device."""
    step = state.step + 1
    c1, c2 = _bias_corrections(step, b1, b2)
    kw = dict(c1=c1, c2=c2, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    out = zip_trees(lambda g, m, v, p: _leaf(g, m, v, p, decay=p.dim() >= 2,
                                             **kw),
                    grads, state.mu, state.nu, params)
    return (map_tree(lambda o: o[0], out),
            AdamWState(step=step, mu=map_tree(lambda o: o[1], out),
                       nu=map_tree(lambda o: o[2], out)))


@torch.no_grad()
def update_(grads: Iterable, state: AdamWState, params, *, lr,
            b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
            weight_decay: float = 0.1) -> None:
    """:func:`update` written into ``params`` and ``state`` in place (the
    JAX step's donated state), the same bits.  ``grads`` yields each
    leaf's gradient in leaf order and is drawn one leaf at a time, so a
    gradient the caller no longer holds is freed once used.  A stacked
    leaf (three or more dims) is updated a layer at a time, which keeps
    the f32 temporaries to one layer's."""
    state.step.add_(1)
    c1, c2 = _bias_corrections(state.step, b1, b2)
    kw = dict(c1=c1, c2=c2, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    for g, m, v, p in zip(grads, tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        kw["decay"] = p.dim() >= 2
        if p.dim() >= 3:
            for i in range(p.shape[0]):
                _write(g[i], m[i], v[i], p[i], **kw)
        else:
            _write(g, m, v, p, **kw)
        del g


def _write(g, m, v, p, **kw) -> None:
    """:func:`_leaf` into ``p``, ``m``, ``v``; its temporaries die here."""
    p_new, m_new, v_new = _leaf(g, m, v, p, **kw)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
