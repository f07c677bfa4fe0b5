"""Fault-tolerance machinery (port of ``repro/runtime/fault_tolerance.py``,
pure Python, the port's own copy): step watchdog (straggler detection),
failure injection, and a resumable step-runner.

The failure model: (a) hard node loss -> restart from the last committed
checkpoint, possibly on fewer ranks (:mod:`repro_torch.runtime.elastic`);
(b) stragglers -> detected as step-time outliers and reported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


class PreemptionError(RuntimeError):
    """Simulated node loss / preemption."""


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


class StepWatchdog:
    """Tracks step durations; flags steps slower than
    ``threshold x running median`` as stragglers."""

    def __init__(self, threshold: float = 2.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.durations: List[float] = []
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, duration: float) -> Optional[StragglerEvent]:
        hist = self.durations[-self.window:]
        self.durations.append(duration)
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            if duration > self.threshold * med:
                ev = StragglerEvent(step, duration, med)
                self.events.append(ev)
                return ev
        return None


class FailureInjector:
    """Deterministically raises PreemptionError at chosen steps (tests)."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise PreemptionError(f"injected failure at step {step}")


def run_resumable(total_steps: int, run_step: Callable[[int], None],
                  restore: Callable[[], int],
                  max_restarts: int = 10) -> int:
    """Drive ``run_step`` from the restored step to ``total_steps``,
    restarting from ``restore()`` on preemption.  Returns restart count."""
    restarts = 0
    while True:
        start = restore()
        try:
            for step in range(start, total_steps):
                run_step(step)
            return restarts
        except PreemptionError:
            restarts += 1
            if restarts > max_restarts:
                raise
