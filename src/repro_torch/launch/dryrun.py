"""Multi-pod dry-run of the port: one rank's step of every cell, counted
on the meta device (port of ``repro/launch/dryrun.py``).

For every (architecture x input-shape) cell, build rank 0's step on the
production mesh — 16x16 ('data', 'model') single-pod or 2x16x16 ('pod',
'data', 'model') multi-pod, as a :class:`~repro_torch.dist.sharding.
DryMesh` whose collectives move nothing — from meta tensors only
(:mod:`repro_torch.launch.specs`; nothing is allocated), run it under
:mod:`repro_torch.core.op_cost`, and record per rank:

* the counted FLOPs, device-memory bytes and collective bytes, by scope
  (each kernel at its boundary), and their three-term roofline on
  ``HOPPER_H100`` (:mod:`repro_torch.core.roofline`);
* the peak bytes a rank holds (``memory_analysis``), against the card's
  80 GB: ``fits``;
* the GEMM and attention plans the trace resolved — the card's plans,
  since the planners run on the ``HOPPER_H100`` sheet on every device.

The JAX package lowers and compiles each cell; the port has nothing to
compile, so ``lower_s`` is the trace's seconds and ``compile_s`` None.
No dry-run path reaches ``torch.distributed``.

The measured half runs on ``--device`` (default the card; without one it
raises unless ``--device cpu``): ``--measure`` executes every planned
GEMM standalone (``telemetry.report.model_vs_measured``), ``--autotune
[K]`` runs the measured tile search for every GEMM the cell plans.

Usage:
    # one cell (what --all spawns per cell, for crash isolation):
    python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single --out artifacts/dryrun_torch
    # a small mesh, for a quick look:
    python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape decode_32k --debug-mesh 2,4
    # the full 40-cell x {single, multi} sweep (skips cached results):
    python -m repro_torch.launch.dryrun --all --mesh both
    # on the card: every planned GEMM measured against its model
    python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape decode_32k --debug-mesh 1,1 --measure
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional


def _mesh_for(mode: str, debug_shape: Optional[str]):
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import PRODUCTION
    if debug_shape:
        dims = tuple(int(x) for x in debug_shape.split(","))
        names = {2: ("data", "model"),
                 3: ("pod", "data", "model")}[len(dims)]
        return shd.DryMesh(dims, names)
    return shd.DryMesh(*PRODUCTION[mode == "multi"])


def _memory_analysis(args, out, peak: int) -> dict:
    """The reference's ``memory_analysis`` fields from a counted trace:
    the arguments' and results' storages, the results that alias an
    argument (caches written in place), and the counted peak; ``temp`` is
    what the peak holds beyond them (peak = argument + output + temp -
    alias)."""
    from repro_torch.core.op_cost import storages
    arg, res = storages(args), storages(out)
    arg_b, out_b = sum(arg.values()), sum(res.values())
    alias_b = sum(n for k, n in res.items() if k in arg)
    return {"available": True, "argument_size_in_bytes": arg_b,
            "output_size_in_bytes": out_b, "alias_size_in_bytes": alias_b,
            "temp_size_in_bytes": peak - arg_b - out_b + alias_b,
            "peak_bytes_per_device": peak}


def run_cell(arch: str, shape_name: str, mesh_mode: str,
             debug_shape: Optional[str] = None,
             layout_name: Optional[str] = None,
             explain: bool = False, measure: bool = False,
             autotune=None, device=None) -> dict:
    from repro_torch import ops, resolve_device, telemetry
    from repro_torch.configs.base import get_config
    from repro_torch.core import op_cost, roofline
    from repro_torch.core.hardware import HOPPER_H100
    from repro_torch.launch import specs
    from repro_torch.launch.shapes import SHAPES, skip_reason

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_mode,
           "kind": shape.kind, "ok": False}
    skip = skip_reason(cfg, shape)
    if skip:
        rec.update(skipped=True, skip_reason=skip, ok=True)
        return rec
    if measure or autotune:
        device = resolve_device(device)
    if autotune:
        # measured top-K tile search for every GEMM the cell plans, on
        # the measurement device; winners persist to the tuning cache
        from repro_torch import tune
        tune.enable(None if autotune is True else int(autotune),
                    device=device)

    mesh = _mesh_for(mesh_mode, debug_shape)
    n_devices = int(mesh.devices.size)
    rec.update(mesh_shape=list(mesh.devices.shape),
               mesh_axes=list(mesh.axis_names), n_devices=n_devices)
    t0 = time.time()
    with telemetry.span("dryrun.trace", arch=arch, shape=shape_name):
        p = specs.build_problem(arch, shape_name, mesh, layout_name)
        with op_cost.count(hold=p.args) as counter:
            out = p.fn(*p.args)
    cost = counter.result()
    rec.update(layout=p.layout_name, tokens_per_step=p.tokens,
               rows_per_device=p.rows, lower_s=round(time.time() - t0, 2),
               compile_s=None)

    mem = _memory_analysis(p.args, out, cost.peak_bytes)
    del out
    rec["memory_analysis"] = mem
    rec["arg_bytes_per_device"] = specs.arg_bytes(p)
    rec["hbm_per_device"] = HOPPER_H100.hbm_bytes
    rec["fits"] = mem["peak_bytes_per_device"] <= HOPPER_H100.hbm_bytes
    rec["cost_analysis"] = {"flops": cost.flops,
                            "bytes_accessed": cost.bytes_accessed}
    model_flops = cfg.model_flops(p.tokens, training=p.training)
    report = roofline.analyze(
        cost, f32=cfg.dtype == "float32",
        model_flops_per_device=model_flops / n_devices)
    rec["roofline"] = report.as_dict()
    rec["bytes_by_scope"] = {k: round(v) for k, v
                             in cost.bytes_by_scope.items()}
    rec["flops_by_scope"] = {k: round(v) for k, v
                             in cost.flops_by_scope.items()}
    rec["grouped_rows"] = cost.grouped_rows
    rec["params"] = cfg.param_count()
    rec["params_active"] = cfg.param_count(active_only=True)

    # Every GEMM and attention the cell traced went through the planned
    # APIs, so the plan caches hold the cell's per-call decisions
    # (kernel, tile, modeled bytes, fallback reasons).
    rec["gemm_plan_cache"] = ops.plan_cache_info()._asdict()
    rec["attn_plan_cache"] = ops.attn_plan_cache_info()._asdict()
    if autotune:
        from repro_torch import tune
        rec["tuning_cache"] = tune.tuning_cache_info()._asdict()
        rec["gemm_sources"] = {
            s: sum(1 for q in ops.plans() if q.source == s)
            for s in ("tuned", "analytic")}
        rec["attn_sources"] = {
            s: sum(1 for q in ops.attn_plans() if q.source == s)
            for s in ("tuned", "analytic")}
    if explain:
        rec["gemm_plans"] = [q.explain() for q in ops.plans()]
        rec["attn_plans"] = [q.explain() for q in ops.attn_plans()]
    if measure:
        # the measured half: every GEMM the cell planned, executed
        # standalone on the device and joined with its modeled bytes and
        # roofline time
        from repro_torch.telemetry import report as treport
        rows = treport.model_vs_measured(ops.plans(), device=device)
        rec["model_vs_measured"] = rows
        rec["model_vs_measured_summary"] = treport.summarize(rows)
    rec["ok"] = True
    return rec


# ---------------------------------------------------------------------------
# Sweep orchestration (a subprocess per cell: fresh plan caches, isolation)
# ---------------------------------------------------------------------------

def _out_path(out_dir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(out_dir, mesh, f"{arch}__{shape}.json")


def _write(path: str, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def sweep(out_dir: str, mesh_modes, force: bool = False,
          archs=None, shapes=None, timeout: int = 7200) -> int:
    from repro_torch.launch.shapes import all_cells
    failures = 0
    for mesh_mode in mesh_modes:
        for arch, shape, skip in all_cells():
            if archs and arch not in archs:
                continue
            if shapes and shape not in shapes:
                continue
            path = _out_path(out_dir, arch, shape, mesh_mode)
            if os.path.exists(path) and not force:
                continue
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if skip:
                _write(path, {"arch": arch, "shape": shape,
                              "mesh": mesh_mode, "ok": True,
                              "skipped": True, "skip_reason": skip})
                print(f"[dryrun] SKIP {mesh_mode} {arch} {shape}: {skip}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_mode,
                   "--out", out_dir]
            t0 = time.time()
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=timeout)
            except subprocess.TimeoutExpired:
                failures += 1
                _write(path, {"arch": arch, "shape": shape,
                              "mesh": mesh_mode, "ok": False,
                              "error": f"timeout after {timeout}s"})
                print(f"[dryrun] TIMEOUT {mesh_mode} {arch} {shape}")
                continue
            dt = time.time() - t0
            if r.returncode != 0:
                failures += 1
                _write(path, {"arch": arch, "shape": shape,
                              "mesh": mesh_mode, "ok": False,
                              "error": r.stderr[-4000:]})
                print(f"[dryrun] FAIL {mesh_mode} {arch} {shape} "
                      f"({dt:.0f}s)\n{r.stderr[-2000:]}")
            else:
                print(f"[dryrun] ok {mesh_mode} {arch} {shape} "
                      f"({dt:.0f}s)")
    return failures


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell via subprocesses")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--explain", action="store_true",
                    help="print GemmPlan.explain() / AttnPlan.explain() for "
                         "every GEMM and attention the cell planned")
    ap.add_argument("--measure", action="store_true",
                    help="execute every planned GEMM standalone on "
                         "--device and print the model-vs-measured table")
    ap.add_argument("--autotune", nargs="?", const=True, default=None,
                    metavar="K",
                    help="measured top-K tile search on --device for every "
                         "GEMM the cell plans (winners persist to the "
                         "tuning cache); optional K narrows the sweep")
    ap.add_argument("--device", default=None,
                    help="where --measure / --autotune run (default: the "
                         "card; 'cpu' measures the plain versions)")
    ap.add_argument("--layout", default=None,
                    choices=(None, "tp", "fsdp_tp"))
    ap.add_argument("--debug-mesh", default=None,
                    help="e.g. '2,4' — a small mesh instead of the "
                         "production one")
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--shapes", nargs="*", default=None)
    args = ap.parse_args()

    modes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        failures = sweep(args.out, modes, force=args.force,
                         archs=args.archs, shapes=args.shapes)
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    try:
        rec = run_cell(args.arch, args.shape, modes[0],
                       debug_shape=args.debug_mesh,
                       layout_name=args.layout, explain=args.explain,
                       measure=args.measure, autotune=args.autotune,
                       device=args.device)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": modes[0],
               "ok": False, "error": traceback.format_exc()}
    path = _out_path(args.out, args.arch, args.shape, modes[0])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write(path, rec)
    if args.explain and rec.get("gemm_plans"):
        print(f"[dryrun] {len(rec['gemm_plans'])} planned GEMMs "
              f"(cache {rec['gemm_plan_cache']}):")
        for text in rec["gemm_plans"]:
            print(text)
    if args.explain and rec.get("attn_plans"):
        print(f"[dryrun] {len(rec['attn_plans'])} planned attentions "
              f"(cache {rec['attn_plan_cache']}):")
        for text in rec["attn_plans"]:
            print(text)
    if args.measure and rec.get("model_vs_measured"):
        from repro_torch.telemetry import report as treport
        print("[dryrun] model-vs-measured (per planned GEMM):")
        print(treport.render(rec["model_vs_measured"]))
    if args.autotune and rec.get("tuning_cache"):
        from repro_torch import tune
        print(f"[dryrun] tuning cache {tune.cache_path()}: "
              f"{rec['tuning_cache']} gemm sources "
              f"{rec.get('gemm_sources')} attn sources "
              f"{rec.get('attn_sources')}")
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("error", "gemm_plans", "attn_plans",
                                   "model_vs_measured")}, indent=1))
    if not rec["ok"]:
        print(rec.get("error", ""), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
