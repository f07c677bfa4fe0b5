"""CUDA-graph capture of a step, with its kernel accounting (the port's
counterpart of the JAX package's jitted steps).

A captured step replays on the card without the host, so nothing of a
replay passes through the kernel wrappers: their launch counters (each
wrapper's ``.launches``, and B6's ``.final_launches``) and the operator
API's kernel fan-out (``kernels.api._launch``, ``kernels.attn_api.
_launch``) never see it.  :func:`capture` therefore

* runs the step once eagerly on a side stream (a real execution,
  counted as any eager call is; its result is :attr:`Graph.first`);
* captures it into a ``torch.cuda.CUDAGraph`` inside :func:`record`,
  which notes what the capture launched -- each counter's delta, and the
  GEMM and attention plans the fan-out ran -- and takes the deltas back
  off the counters (a capture executes nothing);
* and at every :meth:`Graph.replay` adds the deltas back and announces
  the plans to the hooks :func:`add_replay_hook` registered, so launches
  == executed plans holds for a replayed step as for an eager one.

A count a step keeps on the device while telemetry is on (the MoE
layer's routed and dropped rows, :data:`DEVICE_COUNTS`) goes, during a
capture, into a static accumulator allocated before it
(:func:`device_count`), which :meth:`Graph.fold` adds to its telemetry
counter after a burst of replays.

Nothing here falls back to eager execution: a capture that fails
raises.  The step must read and write only tensors that outlive the
graph (static buffers written in place between replays); host values
it reads are frozen at capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import telemetry

#: (module of repro_torch.kernels, its wrappers with a launch counter)
_WRAPPERS = (("gemm_aie", ("gemm_aie", "gemm_aie_plain")),
             ("gemm_gated", ("gemm_gated", "gemm_gated_plain")),
             ("gemm_tb", ("gemm_tb", "gemm_tb_plain")),
             ("gemm_grouped", ("gemm_grouped", "gemm_grouped_plain")),
             ("flash_attention", ("flash_attention",
                                  "flash_attention_plain")),
             ("flash_decode", ("flash_decode", "flash_decode_plain",
                               "flash_decode_paged",
                               "flash_decode_paged_plain")))
#: the telemetry counters a captured step may add device counts to
DEVICE_COUNTS = ("moe.group_sizes", "moe.dropped_tokens")
#: the capture in progress (its accounting), None outside one
_recording: Optional["Accounting"] = None
#: functions called as hook(gemm_plans, attn_plans) after every replay,
#: each dict {plan: executions a replay}
_hooks: List[Callable[[dict, dict], None]] = []


def counters() -> List[Tuple[Any, str]]:
    """Every kernel wrapper's launch counter, as (wrapper, attribute)."""
    fns = []
    for mod, names in _WRAPPERS:
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        fns += [getattr(m, n) for n in names]
    tb = importlib.import_module("repro_torch.kernels.gemm_tb").gemm_tb
    return [(f, "launches") for f in fns] + [(tb, "final_launches")]


def add_replay_hook(hook: Callable[[dict, dict], None]) -> None:
    _hooks.append(hook)


def remove_replay_hook(hook: Callable[[dict, dict], None]) -> None:
    _hooks.remove(hook)


def recording() -> bool:
    """Whether a :func:`record` block is open (a plan run inside it is
    captured, not executed)."""
    return _recording is not None


@dataclasses.dataclass
class Accounting:
    """What one execution of a recorded step launches: each counter's
    delta, and the GEMM / attention plans by executions."""
    deltas: Dict[Tuple[Any, str], int] = dataclasses.field(
        default_factory=dict)
    plans: Dict[Any, int] = dataclasses.field(default_factory=dict)
    attn_plans: Dict[Any, int] = dataclasses.field(default_factory=dict)
    device_counts: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    counted: set = dataclasses.field(default_factory=set)

    def apply(self) -> None:
        """One replay's launches onto the counters, its plans to the
        hooks."""
        for (obj, attr), n in self.deltas.items():
            setattr(obj, attr, getattr(obj, attr) + n)
        for hook in list(_hooks):
            hook(self.plans, self.attn_plans)


@contextlib.contextmanager
def record(device_counts: Optional[Dict[str, torch.Tensor]] = None):
    """Yield an :class:`Accounting` that the block fills: the plans the
    operator API's fan-out runs inside it, and at exit each counter's
    delta, which is then taken back off the counter.  ``device_counts``
    are the static accumulators :func:`device_count` adds to."""
    global _recording
    from repro_torch.kernels import api, attn_api
    if _recording is not None:
        raise RuntimeError("a capture is already being recorded")
    acc = Accounting(device_counts=dict(device_counts or {}))
    before = {key: getattr(*key) for key in counters()}
    gemm_launch, attn_launch = api._launch, attn_api._launch

    def gemm(pl, *args, **kw):
        acc.plans[pl] = acc.plans.get(pl, 0) + 1
        return gemm_launch(pl, *args, **kw)

    def attn(pl, *args):
        acc.attn_plans[pl] = acc.attn_plans.get(pl, 0) + 1
        return attn_launch(pl, *args)

    api._launch, attn_api._launch = gemm, attn
    _recording = acc
    try:
        yield acc
    finally:
        _recording = None
        api._launch, attn_api._launch = gemm_launch, attn_launch
        for key, n in before.items():
            delta = getattr(*key) - n
            if delta:
                acc.deltas[key] = delta
                setattr(key[0], key[1], n)


def device_count(name: str, value: torch.Tensor) -> None:
    """Add a device count to the static accumulator ``name`` of the
    capture being recorded (made before it: one of
    :data:`DEVICE_COUNTS`, while telemetry is on)."""
    acc = _recording
    if acc is None or name not in acc.device_counts:
        raise RuntimeError(f"no capture with a static accumulator for "
                           f"{name!r} is being recorded")
    acc.device_counts[name].add_(value)
    acc.counted.add(name)


@dataclasses.dataclass
class Graph:
    """A captured step: ``first`` is the eager warm-up's result (until
    :meth:`take_first` hands it over), ``out`` the capture's (static
    tensors each replay rewrites)."""
    graph: Any
    accounting: Accounting
    first: Any
    out: Any
    replays: int = 0

    def take_first(self) -> Any:
        """The warm-up's result, dropped here so that its tensors die
        with the caller's use of them."""
        first, self.first = self.first, None
        return first

    def replay(self) -> Any:
        self.graph.replay()
        self.accounting.apply()
        self.replays += 1
        return self.out

    def fold(self) -> None:
        """Add the device counts of the replays since the last fold to
        their telemetry counters (those the step counts), and zero the
        accumulators."""
        for name in self.accounting.counted:
            buf = self.accounting.device_counts[name]
            telemetry.counter(name).add(buf.clone())
            buf.zero_()


def capture(fn: Callable[[], Any]) -> Graph:
    """Run ``fn()`` once eagerly on a side stream, then capture it into
    a CUDA graph (see the module docstring).  Raises if the capture
    fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = fn()
    torch.cuda.current_stream().wait_stream(side)
    counts = {name: torch.zeros((), dtype=torch.int64, device="cuda")
              for name in DEVICE_COUNTS} if telemetry.enabled() else {}
    graph = torch.cuda.CUDAGraph()
    with record(counts) as acc:
        with torch.cuda.graph(graph):
            out = fn()
    return Graph(graph=graph, accounting=acc, first=first, out=out)
