"""Mesh lifecycle, logical-axis resolution and shard arithmetic (port of
``repro/dist/sharding.py``, the *mechanism* half of ``repro_torch.dist``,
on ``torch.distributed``).

A :class:`Mesh` lays the process group's ranks out in a named shape
(``("data", "model")``, ``("pod", "data", "model")``) and holds one
process group an axis, through
``torch.distributed.device_mesh.init_device_mesh``.  A single process
with no process group is the trivial mesh: every axis of size 1, no
group, and every collective the identity.

A spec (:class:`PartitionSpec`, a tuple) names for each dim of a tensor
the mesh axis (or axes, outermost first) it is split over, or None: the
rank holds the block its coordinate on those axes picks, as a JAX
``NamedSharding`` places it.  :func:`shard` cuts a rank's block out of a
whole tensor, :func:`gather` puts the whole back together from every
rank's block (a collective), and :class:`NamedSharding` pairs a spec
with a mesh as the JAX class does.

Logical axes resolve exactly as in the JAX package (``"batch"`` to the
batch-like axes that divide, ``"seq"`` and ``"expert"`` to ``"model"``,
divisibility-checked, an axis claimed twice dropped).  :func:`act`
returns ``x`` unchanged: eager PyTorch has no compiler to constrain, and
each rank already holds its rows (``ROADMAP.md`` queue C, deliberate
differences).  :func:`shard_map` runs a local function on the rank's
shards of its arguments and gathers its outputs, as ``jax.shard_map``
with ``check=False`` does; its collectives are the autograd Functions of
:mod:`repro_torch.dist.collectives`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device

# ---------------------------------------------------------------------------
# Specs and meshes
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry a dim: None (replicated), a mesh axis name, or a tuple
    of axis names (outermost first).  A plain tuple underneath, so specs
    compare with tuples (and with ``tuple(jax_spec)``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


class Mesh:
    """The process group's ranks in a named shape.  ``axis_names`` and
    ``devices`` (the ranks as a numpy array of the mesh's shape) are the
    JAX mesh's; ``coord`` is this rank's index on each axis,
    :meth:`group` an axis's process group (None on the trivial mesh, and
    for an axis of size 1), ``device`` where this rank computes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} for axes {names}")
        n = math.prod(shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n != world:
            raise ValueError(f"a mesh of {n} ranks {dict(zip(names, shape))}"
                             f" over a process group of {world}")
        self.axis_names = names
        self.devices = np.arange(n).reshape(shape)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coord = {a: int(i) for a, i in
                      zip(names, np.unravel_index(self.rank, shape))}
        self.device = resolve_device(device)
        self.device_mesh = None
        self._groups: Dict[str, object] = {}
        if world > 1:
            from torch.distributed.device_mesh import init_device_mesh
            self.device_mesh = init_device_mesh(
                self.device.type, shape, mesh_dim_names=names)
            self._groups = {a: self.device_mesh.get_group(a)
                            for a, s in zip(names, shape) if s > 1}

    def group(self, axis: str):
        """The process group of ``axis`` (None when it has one rank)."""
        return self._groups.get(axis)

    def world(self):
        """The group of every rank of the mesh (None with one rank)."""
        return dist.group.WORLD if self.devices.size > 1 else None

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, "
                f"rank {self.rank} at {self.coord}, {self.device})")


class DryMesh(Mesh):
    """A mesh of ``shape`` with no process group behind it, seen from
    rank 0: each axis's group is a
    :class:`~repro_torch.dist.collectives.DryGroup`, whose collectives
    move nothing and only shape-propagate meta tensors.  The dry-run
    traces one rank's step on a production mesh through it
    (:mod:`repro_torch.launch.dryrun`); its device is ``meta``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        from repro_torch.dist.collectives import DryGroup
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} for axes {names}")
        self.axis_names = names
        self.devices = np.arange(math.prod(shape)).reshape(shape)
        self.rank = 0
        self.coord = {a: 0 for a in names}
        self.device = torch.device("meta")
        self.device_mesh = None
        self._groups = {a: DryGroup(s) for a, s in zip(names, shape)
                        if s > 1}
        self._world = DryGroup(self.devices.size)

    def world(self):
        return self._world if self.devices.size > 1 else None


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None) -> Mesh:
    """A :class:`Mesh` over the process group (the JAX package's
    ``make_mesh``; ``device``: where this rank computes, default the
    card)."""
    return Mesh(axis_shapes, axis_names, device)


# ---------------------------------------------------------------------------
# Mesh lifecycle
# ---------------------------------------------------------------------------

_MESH_STACK: list = []


def current_mesh():
    """The innermost active mesh, or ``None`` outside any ``use_mesh``."""
    return _MESH_STACK[-1] if _MESH_STACK else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the ambient mesh for the dynamic extent.

    Nestable and exception-safe: the previous mesh (or no-mesh state) is
    restored on exit.  ``mesh`` may be any object exposing
    ``axis_names`` + ``devices`` (a :class:`Mesh`, or a duck-typed
    stand-in in spec-level tests).
    """
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis_name: size}`` for a (possibly duck-typed) mesh."""
    if mesh is None:
        return {}
    return dict(zip(tuple(mesh.axis_names), tuple(mesh.devices.shape)))


def mesh_devices(mesh) -> int:
    return int(mesh.devices.size) if mesh is not None else 1


# ---------------------------------------------------------------------------
# Logical-axis resolution
# ---------------------------------------------------------------------------

#: batch-like mesh axes, outermost first — "batch" binds to all present
DATA_AXES: Tuple[str, ...] = ("pod", "data")


def seq_shard_enabled() -> bool:
    return os.environ.get("REPRO_SEQ_SHARD", "1") != "0"


def _divides(dim: int, sizes: Dict[str, int], axes) -> bool:
    total = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        total *= sizes.get(a, 1)
    return total > 0 and dim % total == 0


def data_axes_for(dim: int, sizes: Dict[str, int]):
    """Batch-like mesh axes that divide ``dim``: the widest suffix of
    ``DATA_AXES`` whose product divides, else None (replicate)."""
    present = tuple(a for a in DATA_AXES if a in sizes)
    for start in range(len(present)):
        cand = present[start:]
        if _divides(dim, sizes, cand):
            return cand if len(cand) > 1 else cand[0]
    return None


def resolve_axis(logical: Optional[str], dim: int, sizes: Dict[str, int]):
    """One logical axis -> mesh axis (or axes tuple), divisibility-checked;
    ``None`` when the logical axis has no mesh backing or the dim does
    not divide it (relax-to-replicated)."""
    if logical is None:
        return None
    if logical == "batch":
        return data_axes_for(dim, sizes)
    if logical == "seq":
        if not seq_shard_enabled():
            return None
        logical = "model"
    if logical == "expert":
        logical = "model"
    if logical in sizes and _divides(dim, sizes, logical):
        return logical
    return None


def logical_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 sizes: Dict[str, int]) -> PartitionSpec:
    """Full-rank spec for ``shape`` from logical axis names, dropping any
    axis claimed twice (a mesh axis can shard one dim)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} for axes {tuple(axes)}")
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        r = resolve_axis(name, int(dim), sizes)
        flat = r if isinstance(r, tuple) else (r,) if r else ()
        if any(a in used for a in flat):
            r = None
            flat = ()
        used.update(flat)
        out.append(r)
    return P(*out)


def act(x: torch.Tensor, *axes) -> torch.Tensor:
    """The JAX package's activation constraint: ``x`` unchanged.  There
    is no compiler to constrain, and under a mesh each rank already
    holds its own rows."""
    return x


# ---------------------------------------------------------------------------
# Shard arithmetic
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block(entry, sizes: Dict[str, int], coord: Dict[str, int]
          ) -> Tuple[int, int]:
    """(index, count) of the block a rank at ``coord`` holds of a dim
    split over ``entry``'s axes, the outermost axis first."""
    index, count = 0, 1
    for a in _axes(entry):
        index = index * sizes.get(a, 1) + coord.get(a, 0)
        count *= sizes.get(a, 1)
    return index, count


def narrow(x: torch.Tensor, spec, sizes: Dict[str, int],
           coord: Dict[str, int]) -> torch.Tensor:
    """The block of ``x`` (a whole tensor) that the rank at ``coord``
    holds under ``spec`` (a view; entries past ``len(spec)`` are
    replicated)."""
    for dim, entry in enumerate(spec):
        index, count = block(entry, sizes, coord)
        if count > 1:
            n = x.shape[dim]
            if n % count:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split {count} ways ({spec})")
            x = x.narrow(dim, index * (n // count), n // count)
    return x


def is_sharded(spec, sizes: Dict[str, int]) -> bool:
    return any(block(e, sizes, {})[1] > 1 for e in spec)


def shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``: a view
    when no dim is split, else a copy of its own (so the whole tensor
    can be freed)."""
    sizes = axis_sizes(mesh)
    if not is_sharded(spec, sizes):
        return x
    return narrow(x, spec, sizes, mesh.coord).clone()


def gather(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` under ``spec`` (a
    collective over the axes the spec names; ``x`` itself when it names
    none of size > 1).  Differentiable: the backward sums the gradient
    over the ranks and keeps this rank's block."""
    from repro_torch.dist import collectives as coll
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):      # innermost axis first
            x = coll.all_gather(x, dim, mesh.group(a))
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the JAX class's counterpart): :meth:`place`
    puts this rank's block of a whole host tensor on the mesh's
    device."""

    mesh: Mesh
    spec: PartitionSpec

    def place(self, whole: torch.Tensor) -> torch.Tensor:
        part = narrow(whole, self.spec, axis_sizes(self.mesh),
                      self.mesh.coord)
        return part.contiguous().to(self.mesh.device)


def shard_map(f: Callable, mesh, in_specs, out_specs) -> Callable:
    """``f`` run on this rank's shards (the JAX ``shard_map`` with
    ``check=False``): each argument is cut to its block under its entry
    of ``in_specs``, ``f`` runs on the blocks, and each output is
    gathered under its entry of ``out_specs`` (``P()``: the output is
    already whole, as a psum over every axis leaves it)."""
    sizes = axis_sizes(mesh)

    def run(*args):
        # views: a block's gradient is zero outside it
        local = [narrow(a, s, sizes, mesh.coord)
                 for a, s in zip(args, in_specs)]
        outs = f(*local)
        single = not isinstance(outs, tuple)
        outs = (outs,) if single else outs
        whole = tuple(gather(o, s, mesh) for o, s in zip(outs, out_specs))
        return whole[0] if single else whole
    return run

