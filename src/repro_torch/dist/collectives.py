"""The collectives of the port's meshes (no JAX counterpart: they play
the part of those GSPMD and ``shard_map`` insert), as autograd Functions
on ``torch.distributed``:

* :func:`all_to_all` — equal blocks of dim 0 exchanged over a group
  (``all_to_all_single``); its backward is the same exchange of the
  gradient, which mirrors it;
* :func:`all_gather` — every rank's block concatenated along a dim; its
  backward sums the gradient over the group and keeps this rank's block
  (all-reduce, then narrow);
* :func:`all_reduce` — the sum over a group; its backward sums the
  gradient over the group.

The backward rules are those of a program in which every rank's loss is
one term of a summed loss, so a gradient comes out summed over the ranks
that computed it; the train step divides by the world size
(:mod:`repro_torch.train.train_step`).

**The backend follows the cards** (:func:`init_process_group`): NCCL
when each rank of the host has a CUDA card of its own, gloo when ranks
share a card (two ranks on one H100) and on the CPU.  gloo takes no CUDA
tensor in these collectives, so on a gloo group a CUDA tensor's
collective is staged through pinned host buffers — by that rule, for
gloo groups only, never as a fallback after a failure.  The launchers
print the choice once.  A group of one rank (None) makes every
collective the identity.

**A dry group** (:class:`DryGroup`, the groups of
:class:`repro_torch.dist.sharding.DryMesh`) stands for a process group
that does not exist: the dry-run traces one rank's step on a production
mesh of 256 or 512 ranks on the meta device.  Its collectives take meta
tensors only, move nothing and return their results' shapes; they reach
no ``torch.distributed`` call.  Every collective here, dry or real, adds
its result's bytes to a running :mod:`repro_torch.core.op_cost` count.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import op_cost


class DryGroup:
    """A process group of ``size`` ranks that moves nothing (module
    docstring); this process is its rank 0."""

    def __init__(self, size: int):
        self.size = int(size)

    def __repr__(self) -> str:
        return f"DryGroup({self.size})"


def _dry(group, t: torch.Tensor) -> bool:
    """Whether ``t``'s collective over ``group`` only propagates shapes
    (a dry group takes meta tensors only)."""
    if not isinstance(group, DryGroup):
        return False
    if t.device.type != "meta":
        raise ValueError(f"a dry group's collective takes meta tensors, "
                         f"got one on {t.device}")
    return True


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None)."""
    if group is None:
        return 1
    return group.size if isinstance(group, DryGroup) \
        else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for None and a dry group)."""
    if group is None or isinstance(group, DryGroup):
        return 0
    return dist.get_rank(group)


def local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` (set by
    ``torch.distributed.run``), else the world size."""
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))


def choose_backend(device: torch.device, ranks_on_host: int) -> str:
    """``nccl`` when ``device`` is a CUDA card and the host has one for
    each of its ranks, else ``gloo``."""
    if device.type == "cuda" and torch.cuda.device_count() >= ranks_on_host:
        return "nccl"
    return "gloo"


def init_process_group(device, *, init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None) -> str:
    """Join the process group (from the ``torch.distributed.run``
    environment unless ``init_method`` / ``rank`` / ``world_size`` are
    given), with the backend :func:`choose_backend` gives; on a card,
    first make ``local_rank % cards`` this process's device.  Returns the
    choice as one line (``backend gloo: ...``), which the launchers print
    once, at rank 0."""
    device = torch.device(device)
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    on_host = world if world_size is not None else local_world_size()
    backend = choose_backend(device, on_host)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        torch.cuda.init()
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    if backend == "nccl":
        how = "one CUDA card a rank"
    elif device.type == "cuda":
        how = (f"{on_host} ranks share {torch.cuda.device_count()} CUDA "
               "card(s); collectives on CUDA tensors are staged through "
               "pinned host buffers")
    else:
        how = "CPU tensors"
    return f"backend {backend}: {world} ranks, {how}"


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t``'s collective goes through pinned host memory: a CUDA
    tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A data-movement collective moves ``t``'s bytes (gloo reduces no
    16-bit integers, and bytes keep every dtype's bits); dim 0 keeps its
    length, so equal dim-0 blocks stay blocks."""
    return t.reshape(t.shape[0], -1).view(torch.uint8)


@op_cost.collective("all-to-all")
def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    if _dry(group, x):
        return torch.empty_like(x)
    x = x.contiguous()
    src = _host(x) if _staged(group, x) else x
    out = torch.empty_like(src)
    dist.all_to_all_single(_bytes(out), _bytes(src), group=group)
    return out.to(x.device, non_blocking=False)


@op_cost.collective("all-gather")
def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if _dry(group, x):
        shape = list(x.shape)
        shape[dim] *= group.size
        return x.new_empty(shape)
    x = x.contiguous()
    src = _host(x) if _staged(group, x) else x
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather([_bytes(p) for p in parts], _bytes(src), group=group)
    return torch.cat(parts, dim).to(x.device)


@op_cost.collective("all-reduce")
def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, taken in f32 for 16-bit floats (and
    rounded back once)."""
    if _dry(group, x):
        return torch.empty_like(x)
    acc = x.float() if x.dtype in (torch.bfloat16, torch.float16) \
        else x.clone()
    buf = _host(acc) if _staged(group, acc) else acc.contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(x.device).to(x.dtype)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.n = group_rank(group), x.shape[dim]
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g, ctx.group)
        return total.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r's dim-0 block i goes to rank i, where it lands as block r
    (``x``'s dim 0 splits into one equal block a rank)."""
    return x if group is None else _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return x if group is None else _AllGather.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (``dist.group.WORLD`` for every
    rank), as a new tensor."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
