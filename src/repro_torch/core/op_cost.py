"""Op-by-op cost of a step: FLOPs, device-memory bytes, collective bytes
and peak memory (the counterpart of ``repro/core/hlo_cost.py``).

The JAX package parses the post-SPMD HLO of a compiled step and corrects
for loops, because XLA counts a ``while`` body once.  Eager PyTorch has
no HLO and no scan: every op is counted as it runs, under a
``TorchDispatchMode`` (:func:`count`), so a Python loop over layers needs
no correction.  The record keeps the reference's keys (:class:`OpCost`):
``flops``, ``bytes_accessed``, ``collective_bytes`` by type and
``flops_by_scope`` / ``bytes_by_scope``.  It counts the same work on the
card, on the CPU and on the meta device, where a step runs with no data
and allocates nothing (the dry-run, :mod:`repro_torch.launch.dryrun`).

Three rules:

* **Kernel scopes.**  Each kernel wrapper (B1 ``gemm_aie``, B2
  ``gemm_gated``, B3 ``flash_attention``, B4 ``flash_decode``, B5
  ``flash_decode_paged``, B6 ``gemm_tb``, B7 ``gemm_grouped``) runs as a
  scope named after its kernel (:func:`scope`).  Inside it the counter
  ignores the aten ops, whatever runs there: the kernel on a card, the
  plain version on the CPU, nothing on meta.  The scope records the
  kernel's FLOPs from its shapes, and its boundary bytes: each tensor
  operand read once, the result written once.  That is the reference's
  fusion-boundary convention ("fusion internals are on-chip"), so a
  rewrite of a kernel cannot move its count.
* **Outside any scope every aten op counts**, in the scope ``"<none>"``
  (the reference's name for an instruction outside any named scope):
  the norms, the rope, the attention backward, the optimizer.  Its
  FLOPs are ``torch.utils.flop_counter``'s for the dots (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolutions), 0 for the rest, as the
  reference counts only dots and convolutions; its bytes are its tensor
  operands plus its result, but for the ops that touch part of an
  operand, charged for the elements they touch (the reference charges a
  dynamic-slice its slice and an in-place dynamic-update-slice twice
  its update): a copy into a view, an in-place indexed write (a cache
  update), a gather (an embedding lookup), a ``zeros_like`` (its
  result).  Views, the copy-free reshape and allocations that write
  nothing are free.
* **Collectives** (:mod:`repro_torch.dist.collectives`, :func:`collective`)
  add their result bytes by type, as ``repro.core.roofline.
  collective_bytes`` reads each collective's result type (an
  all-gather's gathered result, an all-reduce's and an all-to-all's
  operand-sized one); the ops inside them are not counted.

Two choices:

* **Attention FLOPs** count the dots that the reference's attention
  computes: the full q x k rectangle that ``repro/kernels/ref.py``
  builds before it masks, ``4 b hq sq skv d`` for QK^T and PV, whatever
  the mask or the window lets the kernel skip.  A decode counts its
  cache's S slots (B5: the table's ``max_pages * page_size``, the
  reference's gathered view).  So the FLOPs match the JAX count.
* **B7's rows.**  With data (CPU or card) the scope counts the live
  routed rows, ``sum(group_sizes)`` (one host read, made only while
  counting): what these inputs need.  On meta there is no data to read,
  so it counts the capacity rows, A's m.  :attr:`OpCost.grouped_rows`
  says which rows a record counted, each kind apart.  The grouped
  GEMM's weight gradient (plain f32 products, one an expert over its own
  rows: ``kernels/api.py`` ``_grouped_param_grads``) follows the same
  rows, so it is a scope too, ``grouped_db``: the products' FLOPs over
  B7's rows, and its boundary bytes.

**Peak memory**: the bytes of every storage alive during the block,
its maximum in :attr:`OpCost.peak_bytes`.  A storage
is counted when an op outside any scope makes it, or when a scope
returns it, and dropped by a weakref finalizer when it dies.  Inside a
kernel scope only the scope's result counts: the plain version's
temporaries (B3's materialised scores) are not the kernel's.  The
tensors given as ``hold=`` count from the start.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: the reference's collective types (``repro/core/hlo_cost.py``)
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")
#: the scope of every aten op outside a kernel
NO_SCOPE = "<none>"

_aten = torch.ops.aten
#: ops that move no bytes: allocations that write nothing, aliases and
#: the copy-free reshape
_FREE = frozenset((
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.detach.default,
    _aten.alias.default, _aten.lift_fresh.default,
    _aten._local_scalar_dense.default, _aten._unsafe_view.default,
))


def _update(times: int, values: int):
    """An in-place indexed write: ``times`` x the update (read it, write
    it; one more read of the destination's elements to accumulate) plus
    the indices; the rest of the destination is not touched."""
    def moved(args, kwargs, out):
        upd = args[values]
        idx = [t for t in _tensors(args[1:]) if not t.is_floating_point()
               and t is not upd]
        n = nbytes(upd) if isinstance(upd, torch.Tensor) else \
            idx[0].numel() * args[0].element_size()   # a scalar's fill
        return times * n + sum(nbytes(t) for t in idx)
    return moved


def _gather(args, kwargs, out):
    """A gather reads the rows it returns and its indices, not the whole
    table."""
    idx = [t for t in _tensors(args[1:]) if not t.is_floating_point()]
    return 2 * nbytes(out) + sum(nbytes(t) for t in idx)


def _written(args, kwargs, out):
    """A fill or an allocation that writes its result (``zeros_like``,
    ``new_full``): its operand gives a shape, nothing is read."""
    return nbytes(out)


#: ops charged for the elements they touch, not for their whole operands
#: (the reference's slice-aware charge of a dynamic-slice or an in-place
#: dynamic-update-slice): copies into a view, fills, in-place indexed
#: writes and gathers
_SLICED = {
    **{op: _written for op in (
        _aten.zeros_like, _aten.ones_like, _aten.full_like,
        _aten.new_zeros, _aten.new_ones, _aten.new_full)},
    _aten.copy_: lambda args, kwargs, out: 2 * nbytes(args[1]),
    _aten.fill_: lambda args, kwargs, out: nbytes(args[0]),
    _aten.zero_: lambda args, kwargs, out: nbytes(args[0]),
    _aten.index_put_: lambda args, kwargs, out: _update(
        3 if (args[3] if len(args) > 3 else kwargs.get("accumulate"))
        else 2, 2)(args, kwargs, out),
    _aten.index_copy_: _update(2, 3),
    _aten.index_add_: _update(3, 3),
    _aten.scatter_: _update(2, 3),
    _aten.scatter_add_: _update(3, 3),
    _aten.index: _gather,
    _aten.index_select: _gather,
    _aten.gather: _gather,
    _aten.embedding: _gather,
}

#: the counter of the running :func:`count`, None outside one
_LIVE: Optional["_Counter"] = None


@dataclasses.dataclass
class OpCost:
    """One counted block's totals (per rank: the ops this process ran)."""

    flops: float
    bytes_accessed: float
    collective_bytes: Dict[str, float]
    flops_by_scope: Dict[str, float]
    bytes_by_scope: Dict[str, float]
    calls_by_scope: Dict[str, int]
    peak_bytes: int
    grouped_rows: Dict[str, int]

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["collective_total"] = self.collective_total
        return d


def _tensors(tree, out=None) -> list:
    """The tensors of a tree of tuples, lists, dicts and named tuples (a
    plain walk: an op's arguments are shallow, and this runs for every
    op)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def nbytes(t) -> int:
    """Bytes of a tensor's elements (0 for None or a non-tensor)."""
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * t.element_size()


def storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the storages under a tree's tensors, each
    once (views share their base's)."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(tree)}


def boundary(out, *operands) -> int:
    """A kernel's boundary bytes: each tensor operand read once, the
    result (a tensor or a tuple of them) written once."""
    return sum(nbytes(t) for t in _tensors(operands)) + \
        sum(nbytes(t) for t in _tensors(out))


class _Counter(TorchDispatchMode):
    """The dispatch mode behind :func:`count`."""

    def __init__(self):
        super().__init__()
        self.depth = 0                  # > 0 inside a kernel / collective
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.coll = {op: 0.0 for op in COLLECTIVE_OPS}
        self.rows = {"live": 0, "capacity": 0}
        self.live = self.peak = 0
        self._held: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth == 0:
            self._count(func, args, kwargs, out)
            self.hold(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        if func.namespace != "aten" or func.is_view or func in _FREE:
            return
        packet = func._overloadpacket
        flops = flop_registry[packet](*args, **kwargs, out_val=out) \
            if packet in flop_registry else 0
        if packet in _SLICED:
            moved = _SLICED[packet](args, kwargs, out)
        else:
            moved = boundary(out, args, kwargs)
        self.flops[NO_SCOPE] += flops
        self.bytes[NO_SCOPE] += moved
        self.calls[NO_SCOPE] += 1

    # -- peak memory -------------------------------------------------------
    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as alive until they
        die."""
        for t in _tensors(tree):
            if t.layout != torch.strided:
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self._held:
                continue
            n = s.nbytes()
            self._held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    # -- scopes ------------------------------------------------------------
    def add(self, scope: str, flops: float, moved: float, out) -> None:
        self.flops[scope] += flops
        self.bytes[scope] += moved
        self.calls[scope] += 1
        self.hold(out)

    def result(self) -> OpCost:
        return OpCost(
            flops=float(sum(self.flops.values())),
            bytes_accessed=float(sum(self.bytes.values())),
            collective_bytes=dict(self.coll),
            flops_by_scope=dict(self.flops),
            bytes_by_scope=dict(self.bytes),
            calls_by_scope=dict(self.calls),
            peak_bytes=int(self.peak), grouped_rows=dict(self.rows))


class count:
    """``with count(hold=(state, batch)) as c: step(state, batch)`` and
    then ``c.result()``: the :class:`OpCost` of the ops run inside the
    block.  ``hold``: tensors alive from the start (the step's
    arguments), counted in the peak."""

    def __init__(self, hold=()):
        self._counter = _Counter()
        self._counter.hold(hold)
        self._outer = None

    def __enter__(self) -> "count":
        global _LIVE
        self._outer, _LIVE = _LIVE, self._counter
        self._counter.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        global _LIVE
        try:
            self._counter.__exit__(*exc)
        finally:
            _LIVE = self._outer

    def result(self) -> OpCost:
        return self._counter.result()


def counting() -> bool:
    """Whether a :func:`count` block is running."""
    return _LIVE is not None


def scope(name: str, cost: Callable) -> Callable:
    """Decorator: run a kernel wrapper as the scope ``name``.  ``cost(out,
    *args, **kwargs)`` gives the call's ``(flops, bytes)`` from the
    wrapper's arguments and result.  Outside a :func:`count` block the
    wrapper runs as it is, after one global read."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            c = _LIVE
            if c is None or c.depth:
                return fn(*args, **kwargs)
            c.depth += 1
            try:
                out = fn(*args, **kwargs)
                flops, moved = cost(out, *args, **kwargs)
            finally:
                c.depth -= 1
            c.add(name, flops, moved, out)
            return out
        return run
    return wrap


def collective(kind: str) -> Callable:
    """Decorator: a collective of type ``kind`` whose result's bytes are
    counted under ``collective_bytes[kind]`` (the ops inside it are
    not)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            c = _LIVE
            if c is None or c.depth:
                return fn(*args, **kwargs)
            c.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                c.depth -= 1
            c.coll[kind] += nbytes(out)
            c.calls[kind] += 1
            c.hold(out)
            return out
        return run
    return wrap


def grouped_rows(group_sizes: torch.Tensor, m: int) -> int:
    """B7's rows under the module docstring's rule: the live routed rows
    with data (a host read), the capacity ``m`` on meta; the kind goes
    to the running count's ``grouped_rows``."""
    if group_sizes.device.type == "meta":
        rows, kind = m, "capacity"
    else:
        rows, kind = min(m, int(group_sizes.sum())), "live"
    if _LIVE is not None:
        _LIVE.rows[kind] += rows
    return rows
