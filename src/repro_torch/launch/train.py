"""Training entry point (port of ``repro/launch/train.py``): config ->
mesh -> layout engine -> random state from ``--seed`` -> train step ->
deterministic data pipeline -> checkpoints -> straggler watchdog, on the
CUDA card (or on the CPU when asked).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 4 --seq-len 512 --global-batch 8

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
        --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-moe-235b-a22b --smoke --steps 4 --device cpu \
        --ckpt-dir "$(mktemp -d)"

    # the encoder-decoder and the prefix family: the data pipeline's
    # batch carries stub frames / patch embeddings, which loss_fn takes
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch whisper-medium --smoke --steps 2 --seq-len 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch internvl2-76b --smoke --steps 2 --seq-len 40 --device cpu

    # several ranks: the process group from the torch.distributed.run
    # environment, a ("data", "model") mesh of data = world (gloo on the
    # CPU and when ranks share a card, NCCL with a card a rank)
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --smoke --steps 3 --device cpu

Prints the same ``[train] step N loss ... gnorm ... ms`` lines as the
JAX driver (rank 0 only), for every step (the JAX driver prints every
tenth and the last), and the watchdog's ``[train] straggler: ...`` line
for a step slower than twice the running median.  Under
``torch.distributed.run`` each rank holds its blocks of the state under
the layout ``choose_layout`` picks for the mesh
(:func:`repro_torch.runtime.elastic.state_specs`) and trains on its rows
of each global batch; a checkpoint holds the whole state, and a resume
restores each rank's blocks under the new mesh's layout
(``remesh_restore``), whatever mesh wrote it.  With ``--ckpt-dir`` the
run resumes from the newest committed checkpoint there (``[train]
resumed from step N``), saves every ``ckpt_every`` steps without
blocking and once more, blocking, at the end, in the JAX package's
on-disk format
(:mod:`repro_torch.checkpoint.checkpointer`).  ``--telemetry PATH``
records one ``train.step`` span a step (waiting for the step's loss on
the device), the ``train.tokens`` counter, the GEMM plan events and, for
MoE models, the routed / dropped counters, and writes ``PATH.jsonl`` and
``PATH.trace.json``.  Like the JAX driver it has no ``--autotune``: the
forward GEMMs tune when ``REPRO_AUTOTUNE`` or ``tune.enable`` turns
tuning on; the backward's never do.

The step consumes its state (the JAX launcher's ``donate_argnums=(0,)``:
the new parameters and optimizer state are written into the state's own
tensors).  On the card a one-rank step of a model without MoE layers
replays from one CUDA graph (:class:`CapturedStep`: forward, backward
with its remat recompute, and the update); ``train(graphs=False)`` runs
it eagerly.  Two steps stay eager by rule: MoE training (the grouped
GEMM's weight gradient reads the group sizes on the host,
``kernels/api.py`` ``_grouped_param_grads``) and a step on a mesh of
several ranks (its gloo exchanges are staged through host memory).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device, telemetry
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.data import pipeline
from repro_torch.dist import collectives, layout, sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime import elastic, graphs as G
from repro_torch.runtime.fault_tolerance import StepWatchdog
from repro_torch.train import train_step as TS


def build(cfg, *, device, peak_lr: float = 3e-4, total_steps: int = 1000,
          microbatches: int = 1, seed: int = 0,
          optimizer: Optional[str] = None, return_grads: bool = False,
          mesh=None):
    """(state, consuming step function) on ``device``, the state drawn
    from ``seed``.  On a mesh of several ranks the state is this rank's
    blocks under ``choose_layout``'s layout and the step the sharded
    one."""
    optimizer = optimizer or TS.select_optimizer(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = TS.init_state(cfg, gen, device=device, optimizer=optimizer)
    specs = None
    if mesh is not None and shd.mesh_devices(mesh) > 1:
        specs = elastic.state_specs(TS.state_struct(cfg, optimizer), cfg,
                                    mesh)
        state = layout.shard_tree(state, specs, mesh)
    step_fn = TS.make_train_step(cfg, peak_lr=peak_lr,
                                 total_steps=total_steps,
                                 microbatches=microbatches,
                                 optimizer=optimizer,
                                 return_grads=return_grads, mesh=mesh,
                                 specs=specs, consume=True)
    return state, step_fn


def eager_reason(cfg, device, mesh=None) -> Optional[str]:
    """Why a step of ``cfg`` on ``device`` and ``mesh`` cannot replay
    from a CUDA graph, or None when it can."""
    if torch.device(device).type != "cuda":
        return "CUDA graphs need the card"
    if cfg.n_experts:
        return ("MoE training reads the group sizes on the host "
                "(kernels/api.py _grouped_param_grads)")
    if mesh is not None and shd.mesh_devices(mesh) > 1:
        return ("a step on a mesh of several ranks stages its gloo "
                "exchanges through host memory")
    return None


class CapturedStep:
    """A consuming one-rank train step replayed from one CUDA graph
    (:mod:`repro_torch.runtime.graphs`).  The first call runs the step
    eagerly on its batch (the capture's warm-up) and captures it over
    the state and over static copies of that batch; every later call
    copies its batch into those buffers and replays.  The metrics a call
    returns are the graph's static tensors, which the next call
    rewrites; the state must be the one the step was captured on."""

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn
        self.graph: Optional[G.Graph] = None
        self.state = self.batch = None

    def __call__(self, state, batch: dict):
        if self.graph is None:
            self.state = state
            self.batch = {k: v.clone() for k, v in batch.items()}
            self.graph = G.capture(
                lambda: self.step_fn(self.state, self.batch))
            return self.graph.take_first()
        if state is not self.state:
            raise ValueError("a captured step replays on the state it was "
                             "captured with")
        if batch.keys() != self.batch.keys() or any(
                v.shape != self.batch[k].shape for k, v in batch.items()):
            raise ValueError("a captured step replays on batches of the "
                             "shapes it was captured with")
        for k, v in batch.items():
            self.batch[k].copy_(v)
        return self.graph.replay()


def rank_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch (``batch_specs``: the rows
    split over the data axes, replicated when they do not divide)."""
    return layout.shard_tree(batch, layout.batch_specs(batch, mesh), mesh)


def train(cfg, *, steps: int, seq_len: int, global_batch: int,
          microbatches: int = 1, seed: int = 0, device=None,
          optimizer: Optional[str] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, resume: bool = True,
          on_step: Optional[Callable] = None,
          return_grads: bool = False, mesh=None,
          watchdog: Optional[StepWatchdog] = None,
          graphs: Optional[bool] = None) -> dict:
    """Run (or resume) a training job up to step ``steps``; returns the
    last step's metrics as floats, and prints every step's line (rank 0
    only).  ``optimizer`` picks AdamW or Adafactor (default: by model
    size); the learning-rate schedule spans ``steps``.  ``mesh`` (default
    ``make_host_mesh(data=world)``): on several ranks, the sharded step
    of :mod:`repro_torch.train.train_step` under ``choose_layout``'s
    layout on each rank's rows.  With ``ckpt_dir`` a
    committed checkpoint there is restored when ``resume`` is set (the
    run then starts at its step; on a mesh through ``remesh_restore``),
    the state is saved every ``ckpt_every`` steps without blocking, and
    once more, blocking, at the end.  ``on_step(step, state, metrics,
    times)`` is called after every step with the new state (this rank's
    blocks), the step's metrics (``grads`` among them under
    ``return_grads``) and ``times``: ``wall_ms`` (host clock around the
    step, ended by a synchronize) and, on a card, ``device_ms`` (CUDA
    events around the step).  ``graphs`` (default: wherever
    :func:`eager_reason` finds none) replays the step from a CUDA graph
    (:class:`CapturedStep`); ``graphs=False`` runs it eagerly, and
    ``graphs=True`` raises where it cannot be captured."""
    device = resolve_device(device)
    optimizer = optimizer or TS.select_optimizer(cfg)
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_host_mesh(data=world, device=device)
    lead = mesh.rank == 0
    state, step_fn = build(
        cfg, device=device, total_steps=steps, microbatches=microbatches,
        seed=seed, optimizer=optimizer, return_grads=return_grads,
        mesh=mesh)
    reason = eager_reason(cfg, device, mesh)
    if graphs and reason:
        raise ValueError(f"{cfg.name}: the step cannot be captured: "
                         f"{reason}")
    if graphs is None:
        graphs = reason is None
    if graphs:
        step_fn = CapturedStep(step_fn)
    shardings = None
    if shd.mesh_devices(mesh) > 1:
        shardings = elastic.state_shardings(TS.state_struct(cfg, optimizer),
                                            cfg, mesh)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        if shardings is None:
            state = ckpt.restore(state)
        else:
            state = elastic.remesh_restore(
                ckpt, TS.state_struct(cfg, optimizer), cfg, mesh)
        start = int(state.step)
        if lead:
            print(f"[train] resumed from step {start}", flush=True)
    data_cfg = pipeline.DataConfig(seq_len=seq_len,
                                   global_batch=global_batch, seed=seed)
    watchdog = watchdog or StepWatchdog()
    cuda = device.type == "cuda"
    metrics = {}
    for step in range(start, steps):
        batch = pipeline.make_batch(cfg, data_cfg, step, device)
        if shardings is not None:
            batch = rank_rows(batch, mesh)
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
        ev_slow = watchdog.observe(step, times["wall_ms"] / 1e3)
        if lead and ev_slow:
            print(f"[train] straggler: step {ev_slow.step} took "
                  f"{ev_slow.duration:.2f}s (median {ev_slow.median:.2f}s)",
                  flush=True)
        if lead:
            print(f"[train] step {step} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{times['wall_ms']:.0f}ms", flush=True)
        if on_step is not None:
            on_step(step, state, metrics, times)
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state, blocking=False, shardings=shardings)
    if ckpt:
        ckpt.save(steps, state, blocking=True, shardings=shardings)
    return {k: float(v) for k, v in metrics.items() if k != "grads"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
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
    device = resolve_device(args.device)
    ranks = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if ranks:                   # started by torch.distributed.run
        line = collectives.init_process_group(device)
        if dist.get_rank() == 0:
            print(f"[dist] {line}", flush=True)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    try:
        out = train(cfg, steps=args.steps, seq_len=args.seq_len,
                    global_batch=args.global_batch,
                    microbatches=args.microbatches, seed=args.seed,
                    device=device, ckpt_dir=args.ckpt_dir)
        lead = not dist.is_initialized() or dist.get_rank() == 0
        if lead:
            print("[train] final:",
                  {k: round(v, 4) for k, v in out.items()})
        if args.telemetry and lead:
            _, lines = telemetry.export_report("train", args.telemetry)
            print("\n".join(lines))
    finally:
        if ranks:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
