#!/usr/bin/env python3
"""Where one full-width training step of smollm-360m spends the card's
time, from a ``torch.profiler`` trace.

    python3 tools/train_profile.py [--steps 3]

Trains smollm-360m at full width in bf16 (seq 512, global batch 8,
AdamW, seed 0) with the state and step of ``repro_torch.launch.train``;
the last step is traced (CPU and CUDA activities), the earlier ones warm
the plans and the allocator.  Prints the step's wall ms, the device's busy
ms (the union of its kernel and copy intervals) and idle share, and the
device time by kernel family: the port's hand-written kernels by name,
the plain PyTorch work by category (matmul / einsum, elementwise,
reductions, copies, the rest).  Writes the rows to
``chiprun_out/train_profile.json``.  TF32 is off, as in
``chip_smoke.py``, which traces its MoE training step with
:func:`summarize` too.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402

#: the port's kernels, by a substring of their CUDA symbol
PORT_KERNELS = ("gemm_tb", "gemm_aie", "gemm_gated", "flash_attention",
                "gemm_grouped", "grouped_tables", "decode")

#: plain PyTorch work, by a substring of the kernel name (first match)
CATEGORIES = (("matmul / einsum (cuBLAS, CUTLASS)",
               ("gemm", "cutlass", "sm90", "xmma", "cublas")),
              ("copies (contiguous, casts)", ("copy", "Copy", "cat")),
              ("reductions (softmax, sums, norms)",
               ("reduce", "softmax", "Softmax", "logsumexp", "norm")),
              ("elementwise", ("elementwise", "vectorized", "unrolled",
                               "Elementwise")),
              ("indexing (embedding, gather, scatter)",
               ("index", "gather", "scatter", "embedding")))


def family(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return f"port: {k}"
    for label, keys in CATEGORIES:
        if any(k in name for k in keys):
            return f"plain: {label}"
    return "plain: other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(prof) -> dict:
    """Device busy ms, window, and time by kernel family and by kernel
    name of a finished ``torch.profiler.profile``; None when the trace
    holds no device events (busy time not measured)."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_family, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        f = family(e.name)
        by_family[f] = by_family.get(f, 0.0) + us / 1e3
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    return {"device_window_ms": (max(e for _, e in spans)
                                 - min(s for s, _ in spans)) / 1e3,
            "device_busy_ms": busy_us(spans) / 1e3,
            "device_events": len(kernels),
            "by_family_ms": dict(sorted(by_family.items(),
                                        key=lambda kv: -kv[1])),
            "top": [{"name": k, "count": n, "ms": ms}
                    for k, (n, ms) in top]}


def report(summary: dict, prefix: str = "[train_profile]") -> None:
    """Print :func:`summarize`'s families and top kernels."""
    for f, ms in summary["by_family_ms"].items():
        print(f"{prefix}   {f:48s} {ms:9.2f} ms")
    for row in summary["top"]:
        print(f"{prefix}   {row['ms']:9.2f} ms {row['count']:6d}x  "
              f"{row['name'][:110]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("smollm-360m")
    state, step_fn = train_launch.build(cfg, device=torch.device("cuda"),
                                        total_steps=args.steps, seed=0,
                                        optimizer="adamw")
    data = pipeline.DataConfig(seq_len=512, global_batch=8, seed=0)
    for step in range(args.steps):
        batch = pipeline.make_batch(cfg, data, step, "cuda")
        torch.cuda.synchronize()
        traced = step == args.steps - 1
        if traced:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.__exit__(None, None, None)
    card = torch.cuda.get_device_name(0)
    summary = summarize(prof)
    if summary is None:
        print(f"[train_profile] the trace holds no device events on {card}: "
              "device busy time not measured")
        return
    busy, window = summary["device_busy_ms"], summary["device_window_ms"]
    print(f"[train_profile] {card}: smollm-360m bf16 b 8 x s 512 AdamW, "
          f"one traced step (loss "
          f"{loss:.4f}): wall {wall_ms:.1f} ms, device window {window:.1f} "
          f"ms, device busy {busy:.1f} ms ({summary['device_events']} "
          f"device events), idle {1 - busy / window:.1%} of the window")
    report(summary)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_profile.json").write_text(json.dumps(dict(
        card=card, wall_ms=wall_ms, **summary), indent=1))


if __name__ == "__main__":
    main()
