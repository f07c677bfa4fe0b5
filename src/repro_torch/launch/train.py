"""Training entry point (port of the single-host path of
``repro/launch/train.py``): config -> random state from ``--seed`` ->
train step -> deterministic data pipeline, on the CUDA card (or on the
CPU when asked).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 4 --seq-len 512 --global-batch 8

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
        --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-moe-235b-a22b --smoke --steps 4 --device cpu \
        --ckpt-dir "$(mktemp -d)"

Prints the same ``[train] step N loss ... gnorm ... ms`` lines as the
JAX driver, for every step (the JAX driver prints every tenth and the
last).  With ``--ckpt-dir`` the run resumes from the newest committed
checkpoint there (``[train] resumed from step N``), saves every
``ckpt_every`` steps without blocking and once more, blocking, at the
end, in the JAX package's on-disk format
(:mod:`repro_torch.checkpoint.checkpointer`).  ``--telemetry PATH``
records one ``train.step`` span a step (waiting for the step's loss on
the device), the ``train.tokens`` counter, the GEMM plan events and, for
MoE models, the routed / dropped counters, and writes ``PATH.jsonl`` and
``PATH.trace.json``.  Like the JAX driver it has no ``--autotune``: the
forward GEMMs tune when ``REPRO_AUTOTUNE`` or ``tune.enable`` turns
tuning on; the backward's never do.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device, telemetry
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import pipeline
from repro_torch.train import train_step as TS


def build(cfg, *, device, peak_lr: float = 3e-4, total_steps: int = 1000,
          microbatches: int = 1, seed: int = 0,
          optimizer: Optional[str] = None, return_grads: bool = False):
    """(state, step function) on ``device``, the state drawn from
    ``seed``."""
    step_fn = TS.make_train_step(cfg, peak_lr=peak_lr,
                                 total_steps=total_steps,
                                 microbatches=microbatches,
                                 optimizer=optimizer,
                                 return_grads=return_grads)
    gen = torch.Generator(device=device).manual_seed(seed)
    return TS.init_state(cfg, gen, device=device, optimizer=optimizer), \
        step_fn


def train(cfg, *, steps: int, seq_len: int, global_batch: int,
          microbatches: int = 1, seed: int = 0, device=None,
          optimizer: Optional[str] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, resume: bool = True,
          on_step: Optional[Callable] = None,
          return_grads: bool = False) -> dict:
    """Run (or resume) a training job up to step ``steps``; returns the
    last step's metrics as floats, and prints every step's line.
    ``optimizer`` picks AdamW or Adafactor (default: by model size);
    the learning-rate schedule spans ``steps``.  With ``ckpt_dir`` a
    committed checkpoint there is restored when ``resume`` is set (the
    run then starts at its step), the state is saved every
    ``ckpt_every`` steps without blocking, and once more, blocking, at
    the end.  ``on_step(step, state, metrics, times)`` is called after
    every step with the new state, the step's metrics (``grads`` among
    them under ``return_grads``) and ``times``: ``wall_ms`` (host clock
    around the step, ended by a synchronize) and, on a card,
    ``device_ms`` (CUDA events around the step)."""
    device = resolve_device(device)
    state, step_fn = build(cfg, device=device,
                           total_steps=steps,
                           microbatches=microbatches, seed=seed,
                           optimizer=optimizer, return_grads=return_grads)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start = int(state.step)
        print(f"[train] resumed from step {start}", flush=True)
    data_cfg = pipeline.DataConfig(seq_len=seq_len,
                                   global_batch=global_batch, seed=seed)
    cuda = device.type == "cuda"
    metrics = {}
    for step in range(start, steps):
        batch = pipeline.make_batch(cfg, data_cfg, step, device)
        if cuda:
            torch.cuda.synchronize(device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        with telemetry.span("train.step", step=step) as sp:
            state, metrics = step_fn(state, batch)
            sp.sync(metrics["loss"])
        telemetry.counter("train.tokens").add(
            data_cfg.seq_len * data_cfg.global_batch)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize(device)
        times = {"wall_ms": (time.perf_counter() - t0) * 1e3}
        if cuda:
            times["device_ms"] = ev[0].elapsed_time(ev[1])
        print(f"[train] step {step} loss {float(metrics['loss']):.4f} "
              f"gnorm {float(metrics['grad_norm']):.3f} "
              f"{times['wall_ms']:.0f}ms", flush=True)
        if on_step is not None:
            on_step(step, state, metrics, times)
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state, blocking=False)
    if ckpt:
        ckpt.save(steps, state, blocking=True)
    return {k: float(v) for k, v in metrics.items() if k != "grads"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="record per-step spans + GEMM plan events and "
                         "write PATH.jsonl + PATH.trace.json")
    args = ap.parse_args(argv)
    if args.telemetry:
        telemetry.enable()
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    out = train(cfg, steps=args.steps, seq_len=args.seq_len,
                global_batch=args.global_batch,
                microbatches=args.microbatches, seed=args.seed,
                device=args.device, ckpt_dir=args.ckpt_dir)
    print("[train] final:", {k: round(v, 4) for k, v in out.items()})
    if args.telemetry:
        _, lines = telemetry.export_report("train", args.telemetry)
        print("\n".join(lines))


if __name__ == "__main__":
    main()
