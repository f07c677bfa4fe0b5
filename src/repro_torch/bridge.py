"""Carry parameter trees between the JAX package and the port.

The JAX package hands its pytrees over as numpy arrays (``np.asarray``
of each leaf); this module turns them into torch tensors with every key
and the stacked ``layers/u{i}`` layout kept, and back.  bf16 leaves
arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects, so
they cross as their raw ``uint16`` bits and are re-viewed as
``torch.bfloat16`` — a bit-exact round trip.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def map_tree(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


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


def to_numpy(tree) -> dict:
    """Tree of torch tensors -> tree of numpy arrays (bf16 leaves come
    back as ``ml_dtypes.bfloat16``), bit for bit."""
    return map_tree(_leaf_to_numpy, tree)


def to_device(tree, device) -> dict:
    """Move every tensor of a tree to ``device``."""
    return map_tree(lambda t: t.to(device), tree)
