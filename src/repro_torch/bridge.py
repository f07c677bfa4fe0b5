"""Carry parameter trees and training states between the JAX package
and the port.

The JAX package hands its pytrees over as numpy arrays (``np.asarray``
of each leaf); this module turns them into torch tensors with every key
and the stacked ``layers/u{i}`` layout kept (the unstacked
``tail/t{i}`` layers of recurrentgemma-9b too, the recurrent blocks'
f32 leaves: ``lambda``, ``a_log``, ``d_skip``, ``dt_bias``, and
whisper-medium's ``encoder`` subtree, each decoder layer's ``norm_x`` and
``cross``, the LayerNorms' f32 ``scale`` / ``bias`` and the GELU MLP's
``w_in`` / ``w_out``), and back.  bf16 leaves
arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects, so
they cross as their raw ``uint16`` bits and are re-viewed as
``torch.bfloat16`` — a bit-exact round trip.  A training state (params,
the AdamW ``step`` / ``mu`` / ``nu`` or Adafactor ``step`` / ``vr`` /
``vc`` moments, the step counter) crosses the same way
(:func:`train_state_from_jax`, :func:`to_numpy`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def map_tree(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts and named
    tuples (rebuilt with their own type); anything else is a leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a tree of nested dicts, in insertion order (the
    order :func:`map_tree` visits them)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def zip_trees(fn: Callable, first, *rest):
    """``fn`` over the matching leaves of trees of nested dicts and named
    tuples that share ``first``'s structure."""
    if isinstance(first, dict):
        return {k: zip_trees(fn, v, *(r[k] for r in rest))
                for k, v in first.items()}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(zip_trees(fn, v, *(getattr(r, f) for r in rest))
                             for f, v in zip(first._fields, first)))
    return fn(first, *rest)


def _leaf_from_numpy(x) -> torch.Tensor:
    arr = np.array(x)                      # own, writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_jax(tree) -> dict:
    """Tree of numpy (or numpy-convertible) leaves -> tree of CPU torch
    tensors, bit for bit."""
    return map_tree(_leaf_from_numpy, tree)


def to_numpy(tree):
    """Tree of torch tensors -> tree of numpy arrays (bf16 leaves come
    back as ``ml_dtypes.bfloat16``), bit for bit; named tuples (a
    :class:`~repro_torch.train.train_step.TrainState` and its optimizer
    state) keep their port types, whose fields are the JAX package's."""
    return map_tree(_leaf_to_numpy, tree)


def train_state_from_jax(state):
    """A JAX ``TrainState`` (params, an ``AdamWState`` or
    ``AdafactorState``, step; leaves numpy- or array-like) -> the port's
    :class:`~repro_torch.train.train_step.TrainState` of CPU tensors, bit
    for bit.  The optimizer state is told apart by its fields."""
    from repro_torch.optim import adafactor, adamw
    from repro_torch.train.train_step import TrainState
    opt = state.opt
    if hasattr(opt, "mu"):
        o = adamw.AdamWState(step=_leaf_from_numpy(opt.step),
                             mu=from_jax(opt.mu), nu=from_jax(opt.nu))
    else:
        o = adafactor.AdafactorState(step=_leaf_from_numpy(opt.step),
                                     vr=from_jax(opt.vr),
                                     vc=from_jax(opt.vc))
    return TrainState(params=from_jax(state.params), opt=o,
                      step=_leaf_from_numpy(state.step))


def to_device(tree, device) -> dict:
    """Move every tensor of a tree to ``device``."""
    return map_tree(lambda t: t.to(device), tree)
