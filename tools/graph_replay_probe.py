#!/usr/bin/env python3
"""Time kernel B7 and its library yardstick in CUDA graphs of 1 and of 8
calls a replay, on one card.

    python3 tools/graph_replay_probe.py

``chip_smoke.py``'s kernel phase replays a graph of one call per input
set; an operand set larger than the L2 cache (B7's 1.6 GB expert bank)
gives one call a replay, so each reading also carries the replay's own
start.  This probe times the timed B7 cases of ``chip_smoke.py``
(qwen3-moe-235b-a22b's decode and prefill expert GEMMs) both ways: B7
as the MoE layer calls it, B7 with its steering tables built once
outside the timed calls (``shared_tables``), the table kernel alone,
and ``torch._grouped_mm``; the median of 20 replays, divided by the
calls a replay.  Prints one line a case and reading.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gemm_grouped import (  # noqa: E402
    cta_tile, gemm_grouped, shared_tables, steering_tables)


def graph_us(fn, args, kw, calls):
    """Median device time of one call, from replays of a graph holding
    ``calls`` calls on the same operands."""
    fn(*args, **kw)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(S.REPS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return float(np.median(times)) * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("graph_replay_probe: no CUDA device is available")
    card = S.card_line()
    _build.load()
    S._GEN = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for case in S.grouped_cases():
            if not case["timed"]:
                continue
            (a, b, gs), kw = case["make"]()
            bm = cta_tile(a.shape[0], gs.shape[0])[0]
            args = (a, b, gs)
            for calls in (1, 8):
                b7 = graph_us(gemm_grouped, args, kw, calls)
                with shared_tables():
                    shared = graph_us(gemm_grouped, args, kw, calls)
                tables = graph_us(
                    lambda a_, b_, g_, **k_: steering_tables(
                        g_, a_.shape[0], bm), args, kw, calls)
                lib = graph_us(case["library"], args, kw, calls)
                S.log(f"  {case['name']:34s} {calls} call(s) a replay: "
                      f"B7 {b7:7.1f} us, with shared tables {shared:7.1f}, "
                      f"tables alone {tables:5.1f}, _grouped_mm "
                      f"{lib:7.1f}")
            del a, b, args
            torch.cuda.empty_cache()
    print(card)


if __name__ == "__main__":
    main()
