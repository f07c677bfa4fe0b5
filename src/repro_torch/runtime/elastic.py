"""Elastic re-mesh: resume a run on another number of ranks (port of
``repro/runtime/elastic.py``).

Checkpoints hold whole (unsharded) arrays with a manifest
(:mod:`repro_torch.checkpoint.checkpointer`), and the layout engine
derives every leaf's spec from the (config, mesh) pair, so growing or
shrinking the mesh is: build the new mesh -> derive the specs -> restore
each rank's block of every leaf.  The data pipeline is deterministic in
the step, so the global batch re-partitions cleanly too.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.bridge import zip_trees
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import layout, sharding
from repro_torch.dist.sharding import P
from repro_torch.optim import adafactor, adamw


def state_specs(target_state, cfg: ModelConfig, mesh, layout_name=None):
    """Spec tree of a TrainState: params by the layout engine, the
    optimizer state by the optimizer's own ``state_specs`` (Adafactor's
    factored statistics take rank-adjusted specs).  ``target_state``'s
    leaves carry the whole shapes (the meta tree of
    :func:`~repro_torch.train.train_step.state_struct` will do)."""
    p_specs = layout.param_specs(target_state.params, cfg, mesh,
                                 layout_name)
    opt = target_state.opt
    if isinstance(opt, adamw.AdamWState):
        opt_specs = adamw.state_specs(p_specs, target_state.params)
    elif isinstance(opt, adafactor.AdafactorState):
        opt_specs = adafactor.state_specs(p_specs, target_state.params)
    else:                                     # unknown: replicate
        opt_specs = zip_trees(lambda _: P(), opt)
    return type(target_state)(params=p_specs, opt=opt_specs, step=P())


def state_shardings(target_state, cfg: ModelConfig, mesh, layout_name=None):
    specs = state_specs(target_state, cfg, mesh, layout_name)
    return zip_trees(lambda s: sharding.NamedSharding(mesh, s), specs)


def remesh_restore(ckpt: Checkpointer, target_state, cfg: ModelConfig,
                   new_mesh, step: Optional[int] = None):
    """Restore ``target_state`` (a TrainState of whole-shaped tensors,
    the meta device's will do) as this rank's blocks under
    ``new_mesh``'s layout, on the mesh's device, from a checkpoint
    written at any mesh."""
    shardings = state_shardings(target_state, cfg, new_mesh)
    return ckpt.restore(target_state, step=step, shardings=shardings)
