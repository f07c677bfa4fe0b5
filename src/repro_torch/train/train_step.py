"""The microbatched train step (port of ``repro/train/train_step.py``).

* gradients through every kernel of the forward by autograd: each GEMM
  and prefill attention runs inside the port's ``autograd.Function``\\s
  (:mod:`repro_torch.kernels.api`, :mod:`repro_torch.ops`), whose
  backwards are composed of planned kernels too;
* grads accumulated over microbatches one after another, so peak
  activation memory is one microbatch's; the accumulators are f32, and
  with one microbatch a bf16 leaf's gradient stays bf16, as in the
  reference;
* the optimizer by model size (AdamW; Adafactor from ~100B parameters);
* global grad-norm clipping, then a warmup-cosine learning rate.

The state is a plain tuple of tensor trees; the step returns a new one
and never mutates its argument's tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.bridge import map_tree, tree_leaves, zip_trees
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adafactor, adamw, schedule as sched

ADAFACTOR_THRESHOLD = 100e9


class TrainState(NamedTuple):
    params: dict
    opt: tuple
    step: torch.Tensor          # () int32


def select_optimizer(cfg: ModelConfig) -> str:
    return "adafactor" if cfg.param_count() >= ADAFACTOR_THRESHOLD \
        else "adamw"


def init_state(cfg: ModelConfig, generator: torch.Generator, device=None,
               optimizer: Optional[str] = None) -> TrainState:
    """Random parameters from ``generator`` on ``device`` (default the
    CUDA card; the generator must live there) and fresh f32 optimizer
    moments."""
    device = resolve_device(device)
    params = T.init_params(cfg, generator, device=device)
    optimizer = optimizer or select_optimizer(cfg)
    opt = adamw.init(params) if optimizer == "adamw" \
        else adafactor.init(params)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), each in its own dtype;
    the norm: the sqrt of every leaf's f32 sum of squares, summed in
    leaf order)."""
    total = None
    for g in tree_leaves(grads):
        sq = torch.sum(g.float() ** 2)
        total = sq if total is None else total + sq
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return map_tree(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def value_and_grad(params: dict, cfg: ModelConfig, batch: dict, *,
                   n_chunks: int = 8, remat: bool = True):
    """(loss, metrics, grads) of ``T.loss_fn`` at ``params``; each grad
    in its leaf's dtype.  ``params`` is left as it was: the gradient is
    taken with respect to detached aliases of its leaves."""
    leaves = map_tree(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = T.loss_fn(leaves, cfg, batch, n_chunks=n_chunks,
                                  remat=remat)
        flat = list(tree_leaves(leaves))
        grads = torch.autograd.grad(loss, flat)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            map_tree(lambda _: next(it), leaves))


def make_train_step(cfg: ModelConfig, *, optimizer: Optional[str] = None,
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000, weight_decay: float = 0.1,
                    grad_clip: float = 1.0, microbatches: int = 1,
                    remat: bool = True, n_loss_chunks: int = 8,
                    return_grads: bool = False) -> Callable:
    """Build ``train_step(state, batch) -> (new_state, metrics)``.
    ``metrics`` holds the loss, the grad norm before clipping and the
    learning rate (and, with one microbatch, ``ce`` and ``aux``);
    ``return_grads`` adds the unclipped gradient tree as ``grads``."""
    optimizer = optimizer or select_optimizer(cfg)
    opt_update = adamw.update if optimizer == "adamw" \
        else adafactor.update

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(params, cfg, batch, n_chunks=n_loss_chunks,
                                  remat=remat)
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} rows does not split into "
                             f"{microbatches} microbatches")
        rows = b // microbatches
        g_sum, l_sum = None, 0.0
        for i in range(microbatches):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            loss, _, grads = value_and_grad(params, cfg, mb,
                                            n_chunks=n_loss_chunks,
                                            remat=remat)
            g_sum = map_tree(lambda g: g.float(), grads) if g_sum is None \
                else zip_trees(lambda a, g: a + g.float(), g_sum, grads)
            l_sum = l_sum + loss
        grads = map_tree(lambda g: g / microbatches, g_sum)
        return l_sum / microbatches, {}, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        loss, metrics, grads = grads_of(state.params, batch)
        clipped, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = sched.warmup_cosine(state.step, peak_lr=peak_lr,
                                 warmup_steps=warmup_steps,
                                 total_steps=total_steps)
        params, opt = opt_update(clipped, state.opt, state.params, lr=lr,
                                 weight_decay=weight_decay)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        if return_grads:
            out["grads"] = grads
        return new_state, out

    return train_step
