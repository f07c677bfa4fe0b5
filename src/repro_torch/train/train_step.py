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

The state is a plain tuple of tensor trees.  The default step returns
a new one and never mutates its argument's tensors; the consuming step
(``make_train_step(consume=True)``, the JAX step's
``donate_argnums=(0,)``) writes the new parameters, optimizer state and
step counter into the state's own tensors, the same bits, and frees
each gradient leaf once the optimizer has used it, so the parameters
and moments are never held twice.

**On a mesh of several ranks** (``mesh``, ``specs``: the TrainState's
spec tree from :func:`repro_torch.runtime.elastic.state_specs`) the
state holds this rank's blocks and the batch this rank's rows.  The
step gathers every leaf whole at its start but an expert bank's expert
dim on ``model`` (:func:`repro_torch.dist.layout.compute_specs`: expert
parallelism keeps it), runs forward and backward on its rows, sums each
gradient over the ranks that hold the same block and divides by the
number of ranks (every rank's loss is one term of the mean; the
collectives' backward rules count a model-axis replica's share once a
replica), clips by the norm of the whole gradient (an expert bank's
squares summed over ``model``), updates, and keeps its blocks of the new
parameters and optimizer state.  The loss and its parts are averaged
over the ranks.  Tensor-parallel compute (Megatron column / row GEMMs)
and per-layer FSDP gathers are not ported (``ROADMAP.md`` A11).
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.bridge import map_tree, tree_leaves, zip_trees
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
from repro_torch.dist import layout, sharding as shd
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


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device (shapes and
    dtypes, no values)."""

    @property
    def device(self):
        return torch.device("meta")


def state_struct(cfg: ModelConfig, optimizer: Optional[str] = None
                 ) -> TrainState:
    """The TrainState's whole shapes and dtypes as meta tensors (the JAX
    package's ``eval_shape`` of ``init_state``): what the layout engine
    and a re-meshing restore take."""
    return init_state(cfg, _MetaGenerator(), device="meta",
                      optimizer=optimizer)


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def _clip_leaf(g, scale):
    return (g.float() * scale).to(g.dtype)


def _clip(grads, gn, max_norm: float):
    scale = _clip_scale(gn, max_norm)
    return map_tree(lambda g: _clip_leaf(g, scale), grads)


def _clipped(flat: list, scale):
    """The gradients of ``flat`` clipped as :func:`_clip` does, one at a
    time in order; each entry is cleared as it is drawn, so a gradient
    no one else holds dies once the optimizer has used it."""
    for i in range(len(flat)):
        g, flat[i] = flat[i], None
        c = _clip_leaf(g, scale)
        del g
        yield c
        del c


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    if src is not dst:
        dst.copy_(src)


def _sum_in_order(xs):
    total = None
    for x in xs:
        total = x if total is None else total + x
    return total


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), each in its own dtype;
    the norm: the sqrt of every leaf's f32 sum of squares, summed in
    leaf order)."""
    gn = torch.sqrt(_sum_in_order(torch.sum(g.float() ** 2)
                                  for g in tree_leaves(grads)))
    return _clip(grads, gn, max_norm), gn


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
                    return_grads: bool = False, mesh=None,
                    specs: Optional[TrainState] = None,
                    consume: bool = False) -> Callable:
    """Build ``train_step(state, batch) -> (new_state, metrics)``.
    ``metrics`` holds the loss, the grad norm before clipping and the
    learning rate (and, with one microbatch, ``ce`` and ``aux``);
    ``return_grads`` adds the unclipped gradient tree as ``grads`` (which
    the consuming step then keeps until it returns).  With a ``mesh`` of
    several ranks and the state's ``specs``, the step of the module
    docstring.  ``consume`` builds the consuming step: ``new_state`` is
    ``state``, its tensors written in place (on a mesh, this rank's
    blocks of the gathered update)."""
    optimizer = optimizer or select_optimizer(cfg)
    opt_update = adamw.update if optimizer == "adamw" \
        else adafactor.update
    opt_update_ = adamw.update_ if optimizer == "adamw" \
        else adafactor.update_

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

    if mesh is None or shd.mesh_devices(mesh) == 1:
        ranks = _OneRank()
    elif specs is None:
        raise ValueError("a train step on a mesh needs the state's specs")
    else:
        ranks = _Ranks(cfg, mesh, specs, optimizer)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        with ranks.scope():
            params, opt = ranks.gather(state)
            loss, metrics, grads = grads_of(params, batch)
        grads = ranks.reduce(grads)
        gnorm = torch.sqrt(_sum_in_order(ranks.squares(grads)))
        clipped = _clip(grads, gnorm, grad_clip)
        lr = sched.warmup_cosine(state.step, peak_lr=peak_lr,
                                 warmup_steps=warmup_steps,
                                 total_steps=total_steps)
        params, opt = opt_update(clipped, opt, params, lr=lr,
                                 weight_decay=weight_decay,
                                 **ranks.update_args)
        params, opt = ranks.shard(params, opt)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        loss, metrics = ranks.mean(loss, metrics)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        if return_grads:
            out["grads"] = grads
        return new_state, out

    def consuming_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        with ranks.scope():
            params, opt = ranks.gather(state)
            loss, metrics, grads = grads_of(params, batch)
        grads = ranks.reduce(grads)
        gnorm = torch.sqrt(_sum_in_order(ranks.squares(grads)))
        lr = sched.warmup_cosine(state.step, peak_lr=peak_lr,
                                 warmup_steps=warmup_steps,
                                 total_steps=total_steps)
        kept = grads if return_grads else None
        flat = list(tree_leaves(grads))
        del grads
        opt_update_(_clipped(flat, _clip_scale(gnorm, grad_clip)), opt,
                    params, lr=lr, weight_decay=weight_decay,
                    **ranks.update_args)
        ranks.write_back(state, params, opt)
        state.step.add_(1)
        loss, metrics = ranks.mean(loss, metrics)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        if return_grads:
            out["grads"] = kept
        return state, out

    return consuming_step if consume else train_step


class _OneRank:
    """The step's hooks on one rank: the state whole, no collective."""

    update_args: dict = {}

    def scope(self):
        return contextlib.nullcontext()

    def gather(self, state: TrainState):
        return state.params, state.opt

    def reduce(self, grads):
        return grads

    def squares(self, grads) -> list:
        """Each leaf's f32 sum of squares, in leaf order."""
        return [torch.sum(g.float() ** 2) for g in tree_leaves(grads)]

    def shard(self, params, opt):
        return params, opt

    def write_back(self, state: TrainState, params, opt) -> None:
        """The updated ``params`` / ``opt`` into the state's own tensors
        (one rank: they are the state's)."""

    def mean(self, loss, metrics: dict):
        return loss, metrics


def _block_groups(spec, mesh):
    """Process groups over which a leaf computed under ``spec`` is the
    same block: every axis the spec does not split."""
    split = {a for e in spec for a in
             (e if isinstance(e, tuple) else (e,)) if a}
    return [mesh.group(a) for a in mesh.axis_names
            if a not in split and mesh.group(a) is not None]


class _Ranks(_OneRank):
    """The hooks of the module docstring's step on a mesh of several
    ranks."""

    def __init__(self, cfg: ModelConfig, mesh, specs: TrainState,
                 optimizer: str):
        self.mesh, self.world = mesh, shd.mesh_devices(mesh)
        self.compute = layout.compute_specs(specs.params)
        opt_specs = adamw.state_specs if optimizer == "adamw" \
            else adafactor.state_specs
        self.p_drop = layout.dropped_specs(specs.params, self.compute)
        self.o_drop = layout.dropped_specs(specs.opt, opt_specs(
            self.compute, state_struct(cfg, optimizer).params))
        self.model = mesh.group("model")
        # leaves this rank computes a block of: expert banks split on model
        self.split = map_tree(
            lambda spec: self.model is not None and "model" in spec,
            self.compute)
        if optimizer != "adamw":
            self.update_args = {"sum_over": map_tree(
                lambda x: self.over_model if x else None, self.split)}

    def over_model(self, t):
        return coll.all_reduce(t, self.model)

    def scope(self):
        return shd.use_mesh(self.mesh)

    def gather(self, state: TrainState):
        return (layout.gather_tree(state.params, self.p_drop, self.mesh),
                layout.gather_tree(state.opt, self.o_drop, self.mesh))

    def reduce(self, grads):
        """Each gradient summed over the ranks holding its block, over
        the world."""
        def mean_over_ranks(g, spec):
            total = g.float()
            for group in _block_groups(spec, self.mesh):
                total = coll.all_reduce(total, group)
            return (total / self.world).to(g.dtype)

        return zip_trees(mean_over_ranks, grads, self.compute)

    def squares(self, grads) -> list:
        """An expert bank's squares summed over ``model``: the whole
        leaf's."""
        sq = super().squares(grads)
        local = list(tree_leaves(self.split))
        if any(local):
            it = iter(self.over_model(torch.stack(
                [q for q, x in zip(sq, local) if x])))
            sq = [next(it) if x else q for q, x in zip(sq, local)]
        return sq

    def shard(self, params, opt):
        return (layout.shard_tree(params, self.p_drop, self.mesh),
                layout.shard_tree(opt, self.o_drop, self.mesh))

    def write_back(self, state: TrainState, params, opt) -> None:
        params, opt = self.shard(params, opt)
        zip_trees(_copy_into, state.params, params)
        zip_trees(_copy_into, state.opt, opt)

    def mean(self, loss, metrics: dict):
        every = coll.all_reduce(torch.stack(
            [loss.float()] + [v.float() for v in metrics.values()]),
            self.mesh.world()) / self.world
        return every[0], dict(zip(metrics, every[1:]))
