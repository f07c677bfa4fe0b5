"""AdamW with decoupled weight decay (port of ``repro/optim/adamw.py``).

States are f32 whatever the parameter dtype (bf16-safe training), in a
tree that mirrors the parameter tree.  Weight decay applies to leaves
of two or more dimensions only: a norm scale or bias (1-D) gets none.
The stacked ``layers/u{i}`` leaves carry a leading repeats axis, so a
stacked norm scale is 2-D and decays, exactly as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1) -> Tuple[dict, AdamWState]:
    """One step: (new params, new state).  ``lr`` is a float or a 0-d
    tensor on the parameters' device."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)

    def upd(g, m, v, p):
        gf = g.float()
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if p.dim() >= 2:                     # no decay on norms / biases
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = zip_trees(upd, grads, state.mu, state.nu, params)
    return (map_tree(lambda o: o[0], out),
            AdamWState(step=step, mu=map_tree(lambda o: o[1], out),
                       nu=map_tree(lambda o: o[2], out)))
