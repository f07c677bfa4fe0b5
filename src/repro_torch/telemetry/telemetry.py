"""``repro_torch.telemetry`` — spans, counters and trace export for the
whole stack, zero-cost when disabled (port of
``repro/telemetry/telemetry.py``; same API, same export schema).

* :func:`span` — hierarchical wall-clock spans (``perf_counter``), used
  as context managers.  CUDA work is asynchronous, so a span can
  register tensors via ``sp.sync(x)``: at exit it records one
  ``torch.cuda.Event`` on the current stream of each registered CUDA
  tensor's device and synchronizes it, so the device time is billed to
  the span that launched it, not to whichever later host line happens
  to block.  CPU tensors need no wait; ``sync`` leaves them alone.
* :func:`event` / :func:`complete_span` — instant events and
  retroactively-timed spans (for lifecycles that cross host loop
  iterations, e.g. one serve request from queued to finished).
* :func:`counter` / :func:`gauge` — typed metric registries.  Counters
  accumulate (snapshot-only); every gauge ``set`` that changes the value
  also records a timeline sample, which the Chrome-trace export renders
  as a counter track (the serve engine's slot-occupancy timeline).
* :class:`Recorder` — the process-global event sink.  Exports (a)
  structured JSONL (one self-contained JSON object per line, a leading
  ``meta`` line with the schema version and a final metric snapshot)
  and (b) Chrome-trace/Perfetto JSON loadable in ``chrome://tracing`` or
  ``ui.perfetto.dev``.

Disabled mode (the default) is a hard no-op: module functions read ONE
module global and hand back shared stateless singletons — no recorder,
span, dict or list is allocated, so instrumented hot paths cost a
predicate.  Enable with :func:`enable` (or the launchers' ``--telemetry
PATH``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = [
    "Counter", "Gauge", "Recorder", "Span", "SCHEMA_VERSION",
    "complete_span", "counter", "disable", "enable", "enabled", "event",
    "export", "gauge", "recorder", "snapshot", "span",
]

#: bump when the JSONL event schema changes shape
SCHEMA_VERSION = 1

#: explicit-tid tracks (e.g. one row per serve request) are offset past
#: this base so they never collide with interned host-thread tids
TRACK_TID_BASE = 1000

_recorder: Optional["Recorder"] = None


# ---------------------------------------------------------------------------
# Disabled-mode singletons: stateless, shared, allocation-free
# ---------------------------------------------------------------------------

class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def sync(self, value):
        return value


class _NoopCounter:
    __slots__ = ()
    value = 0

    def add(self, n=1) -> None:
        pass

    def flush(self) -> None:
        pass


class _NoopGauge:
    __slots__ = ()
    value = 0.0

    def set(self, value: float) -> None:
        pass


_NOOP_SPAN = _NoopSpan()
_NOOP_COUNTER = _NoopCounter()
_NOOP_GAUGE = _NoopGauge()


# ---------------------------------------------------------------------------
# Live metric types
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic accumulator; final value rides the snapshot.

    ``add`` also takes a device tensor (a count computed on the card):
    it accumulates on the device, with no host sync, and folds into
    ``value`` at :meth:`flush`, which every snapshot calls (never while
    the current stream is capturing a CUDA graph)."""

    __slots__ = ("name", "value", "_pending")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0
        self._pending = None

    def add(self, n=1) -> None:
        if isinstance(n, torch.Tensor):
            self._pending = n if self._pending is None \
                else self._pending + n
        else:
            self.value += n

    def flush(self) -> None:
        """Fold the device-side running sum into ``value`` (one sync)."""
        p = self._pending
        if p is None or (p.is_cuda
                         and torch.cuda.is_current_stream_capturing()):
            return
        self._pending = None
        self.value += p.item()


class Gauge:
    """Point-in-time value; ``set`` records a timeline sample whenever
    the value *changes* (counter tracks are step functions — emitting
    unchanged values would only bloat the trace, e.g. from a serve
    engine's idle poll loop), and the Chrome-trace export draws the
    samples as a counter track."""

    __slots__ = ("name", "value", "_rec", "_set_once")

    def __init__(self, name: str, rec: "Recorder"):
        self.name = name
        self.value: float = 0.0
        self._rec = rec
        self._set_once = False

    def set(self, value: float) -> None:
        value = float(value)
        if self._set_once and value == self.value:
            return
        self._set_once = True
        self.value = value
        self._rec._emit({"type": "gauge", "name": self.name,
                         "ts": self._rec._now(), "value": self.value})


class Span:
    """One live hierarchical span.  Use as a context manager; ``set``
    attaches attributes, ``sync(x)`` registers a tensor (or a nested
    list / tuple / dict of them) whose device work the exit waits for
    (so asynchronously launched CUDA work is billed to this span)."""

    __slots__ = ("name", "attrs", "_rec", "_t0", "_t1", "_syncs",
                 "sid", "parent", "depth")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._rec = rec
        self._syncs: List[Any] = []
        self.sid = -1
        self.parent: Optional[int] = None
        self.depth = 0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def sync(self, value):
        self._syncs.append(value)
        return value

    def __enter__(self) -> "Span":
        st = self._rec._stack()
        self.parent = st[-1].sid if st else None
        self.depth = len(st)
        self.sid = self._rec._new_sid()
        st.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._syncs:
            _wait(self._syncs)
            self._syncs = []
        self._t1 = time.perf_counter()
        self._rec._pop(self)
        return False


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in a nested value."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def _wait(values) -> None:
    """The counterpart of ``jax.block_until_ready``: one event recorded
    on the current stream of each CUDA device the values live on, then
    synchronized.  CPU tensors are ready when their op returns."""
    for device in _cuda_devices(values, set()):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


# ---------------------------------------------------------------------------
# Recorder
# ---------------------------------------------------------------------------

class Recorder:
    """Process-global event sink: spans, instant events, gauge samples,
    plus the counter/gauge registries.  Timestamps are seconds since the
    recorder was created (``perf_counter`` deltas)."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.events: List[dict] = []
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._next_sid = 0
        self._tids: Dict[int, int] = {}

    # ----------------------------------------------------------- internals

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _new_sid(self) -> int:
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        return sid

    def _pop(self, sp: Span) -> None:
        st = self._stack()
        # tolerate exits out of order (an exception unwound past a span)
        while st and st[-1].sid != sp.sid:
            st.pop()
        if st:
            st.pop()
        self._emit({"type": "span", "name": sp.name,
                    "ts": sp._t0 - self._t0, "dur": sp._t1 - sp._t0,
                    "sid": sp.sid, "parent": sp.parent,
                    "depth": sp.depth, "tid": self._tid(),
                    "attrs": sp.attrs})

    # ----------------------------------------------------------- public API

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        self._emit({"type": "event", "name": name, "ts": self._now(),
                    "tid": self._tid(), "attrs": attrs})

    def complete_span(self, name: str, t_start: float, t_end: float, *,
                      tid: Optional[int] = None, **attrs) -> None:
        """Record a span from absolute ``perf_counter`` endpoints —
        for lifecycles that cross host loop iterations.  An explicit
        ``tid`` gets its own Chrome-trace track (offset past host-thread
        tids), e.g. one row per serve request."""
        self._emit({"type": "span", "name": name,
                    "ts": t_start - self._t0,
                    "dur": max(t_end - t_start, 0.0),
                    "sid": None, "parent": None, "depth": 0,
                    "tid": self._tid() if tid is None
                    else TRACK_TID_BASE + tid,
                    "attrs": attrs})

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self))
        return g

    def snapshot(self) -> dict:
        """Point-in-time metric state: counter/gauge values, event
        volume, and the GEMM plan-cache + tuning-cache stats (every
        snapshot carries them — the cache hit/miss trajectory is a
        first-class telemetry signal)."""
        from repro_torch.kernels import api as _api  # runtime: no cycle
        from repro_torch.tune import cache as _tcache
        for c in list(self._counters.values()):
            c.flush()
        return {
            "elapsed_s": self._now(),
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "plan_cache": _api.plan_cache_info()._asdict(),
            "tuning_cache": _tcache.tuning_cache_info()._asdict(),
            "n_events": len(self.events),
        }

    # -------------------------------------------------------------- export

    def export_jsonl(self, path: str) -> str:
        """One JSON object per line.  Line 1 is ``{"type": "meta", ...}``
        with the schema version and a final snapshot; every following
        line is an event: spans carry ``(type, name, ts, dur, attrs)``,
        instants ``(type, name, ts, attrs)``, gauge samples
        ``(type, name, ts, value)``.  ``ts``/``dur`` are seconds."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            meta = {"type": "meta", "schema_version": SCHEMA_VERSION,
                    "pid": os.getpid(), "snapshot": self.snapshot()}
            f.write(json.dumps(meta) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev, default=str) + "\n")
        return path

    def chrome_trace(self) -> dict:
        """The trace as a Chrome/Perfetto ``traceEvents`` object —
        spans as complete ('X') events, instants as 'i', gauge samples
        as counter ('C') tracks; timestamps in microseconds."""
        pid = os.getpid()
        out: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid,
             "args": {"name": "repro"}},
        ]
        named_tracks = set()
        for ev in self.events:
            ts_us = ev["ts"] * 1e6
            if ev["type"] == "span":
                tid = ev.get("tid", 0)
                if tid >= TRACK_TID_BASE and tid not in named_tracks:
                    named_tracks.add(tid)
                    out.append({"ph": "M", "name": "thread_name",
                                "pid": pid, "tid": tid,
                                "args": {"name": f"request "
                                         f"{tid - TRACK_TID_BASE}"}})
                out.append({"ph": "X", "name": ev["name"], "cat": "repro",
                            "ts": ts_us, "dur": ev["dur"] * 1e6,
                            "pid": pid, "tid": tid,
                            "args": ev.get("attrs", {})})
            elif ev["type"] == "event":
                out.append({"ph": "i", "name": ev["name"], "cat": "repro",
                            "ts": ts_us, "s": "t", "pid": pid,
                            "tid": ev.get("tid", 0),
                            "args": ev.get("attrs", {})})
            elif ev["type"] == "gauge":
                out.append({"ph": "C", "name": ev["name"], "ts": ts_us,
                            "pid": pid, "tid": 0,
                            "args": {"value": ev["value"]}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, default=str)
        return path

    def export(self, base: str) -> Tuple[str, str]:
        """Write both artifacts next to each other: ``{base}.jsonl`` and
        ``{base}.trace.json``; returns their paths."""
        return (self.export_jsonl(base + ".jsonl"),
                self.export_chrome_trace(base + ".trace.json"))


# ---------------------------------------------------------------------------
# Module-level API (reads one global; no-op singletons when disabled)
# ---------------------------------------------------------------------------

def enabled() -> bool:
    return _recorder is not None


def recorder() -> Optional[Recorder]:
    return _recorder


def enable(rec: Optional[Recorder] = None) -> Recorder:
    """Install (and return) the process-global recorder.  Idempotent:
    enabling while enabled keeps the existing recorder unless a new one
    is passed explicitly."""
    global _recorder
    if rec is not None:
        _recorder = rec
    elif _recorder is None:
        _recorder = Recorder()
    return _recorder


def disable() -> Optional[Recorder]:
    """Uninstall and return the recorder (so callers can still export
    after turning instrumentation off)."""
    global _recorder
    rec, _recorder = _recorder, None
    return rec


def span(name: str, **attrs):
    rec = _recorder
    if rec is None:
        return _NOOP_SPAN
    return Span(rec, name, attrs)


def event(name: str, **attrs) -> None:
    rec = _recorder
    if rec is not None:
        rec.event(name, **attrs)


def complete_span(name: str, t_start: float, t_end: float, *,
                  tid: Optional[int] = None, **attrs) -> None:
    rec = _recorder
    if rec is not None:
        rec.complete_span(name, t_start, t_end, tid=tid, **attrs)


def counter(name: str):
    rec = _recorder
    if rec is None:
        return _NOOP_COUNTER
    return rec.counter(name)


def gauge(name: str):
    rec = _recorder
    if rec is None:
        return _NOOP_GAUGE
    return rec.gauge(name)


def snapshot() -> Optional[dict]:
    rec = _recorder
    return rec.snapshot() if rec is not None else None


def export(base: str) -> Optional[Tuple[str, str]]:
    rec = _recorder
    return rec.export(base) if rec is not None else None


def export_report(tag: str, path: str) -> Tuple[dict, List[str]]:
    """Export the recorder to ``path``.jsonl / .trace.json; returns the
    final snapshot and the launcher's lines to print: ``[tag]
    telemetry`` and, when MoE layers ran, the routed / dropped line."""
    snap = snapshot()
    paths = export(path)
    lines = [f"[{tag}] telemetry: {snap['n_events']} events, plan cache "
             f"{snap['plan_cache']}; wrote {paths[0]} and {paths[1]}"]
    routed = snap["counters"].get("moe.group_sizes")
    if routed is not None:
        dropped = snap["counters"].get("moe.dropped_tokens", 0)
        total = routed + dropped
        lines.append(f"[{tag}] moe: {int(routed)} rows through grouped "
                     f"expert GEMMs, {int(dropped)} capacity-dropped "
                     f"({dropped / max(total, 1):.1%} of assignments)")
    return snap, lines
