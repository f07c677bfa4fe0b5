#!/usr/bin/env python3
"""The eager decode step of two source trees, in turns on one card.

    python3 tools/eager_ab.py OLD_ROOT NEW_ROOT [--rounds 6]

Each root is a checkout of this repo (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``).
One worker process a tree imports that tree's ``repro_torch`` (its
``src`` on ``PYTHONPATH``), builds its kernels, makes smollm-360m at
full width and qwen3-moe-235b-a22b at full width with 4 layers (bf16,
random weights from seed 0), fills an 8-slot dense cache of 1024
positions (and, for smollm-360m, a paged pool of 16-token pages) with
the same eight prompts as ``chip_smoke.py``'s step phase, and waits.
Both workers stay alive; the orchestrator asks one at a time for one
eager loop of 20 decode steps with their greedy argmax (telemetry and
tuning off, under ``torch.inference_mode``), the mean step in ms on
the host's clock ended by a synchronize: the definition of
``chip_smoke.py``'s ``eager_ms_per_step``.  Rounds alternate the order
old, new, new, old and new, old, old, new, so host drift between
readings falls on both trees alike.

Prints the card's name and power limit and every reading, and writes
them with each tree's median and minimum to ``chiprun_out/eager_ab.json``.
Worker processes share the card; only one runs a loop at any time.
The two trees' kernels build into their own ``_build`` directories
unless those are linked to one (a library is named by a hash of its
sources, so identical sources build once).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROMPT_LENS = (12, 160, 8, 24, 300, 16, 32, 9)
STEPS = 20
MOE_LAYERS = 4
CASES = ("smollm-360m dense", "smollm-360m paged", "qwen3-moe-235b-a22b dense")


def worker() -> None:
    """Serve ``CASES`` names read from stdin with one eager loop each."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T

    _build.load()
    torch.set_grad_enabled(False)
    steps = {}

    def prepare(cfg, params, paged):
        rng = np.random.default_rng(11)
        if paged:
            cache = T.init_paged_cache(cfg, 8, 1 + 8 * 64, 16, 64,
                                       device="cuda")
            rows = np.arange(1, 1 + 8 * 64, dtype=np.int32).reshape(8, 64)
        else:
            cache = T.init_cache(cfg, 8, 1024, device="cuda")
        for slot, p in enumerate(PROMPT_LENS):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, p)),
                                   device="cuda")
            if paged:
                _, cache = T.prefill_paged_chunk(params, cfg, toks, cache,
                                                 slot, rows[slot], 0)
            else:
                _, cache = T.prefill_into_slot(params, cfg, toks, cache,
                                               slot, max_len=1024)
        if paged:
            cache["page_table"].copy_(torch.as_tensor(rows))
        tok = torch.zeros((8, 1), dtype=torch.int64, device="cuda")

        def step():
            logits, _ = T.decode_step(params, cfg, tok, cache)
            return torch.argmax(logits, -1)
        for _ in range(3):
            step()
        return step

    with torch.inference_mode():
        small = get_config("smollm-360m")
        params = T.init_params(
            small, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        steps[CASES[0]] = prepare(small, params, paged=False)
        steps[CASES[1]] = prepare(small, params, paged=True)
        moe = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                                  n_layers=MOE_LAYERS)
        moe_params = T.init_params(
            moe, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        steps[CASES[2]] = prepare(moe, moe_params, paged=False)
        torch.cuda.synchronize()
        print("ready", flush=True)
        for line in sys.stdin:
            name = line.strip()
            if name == "quit":
                break
            step = steps[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / STEPS * 1e3
            print(json.dumps({"case": name, "ms": ms}), flush=True)


def start(root: pathlib.Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        cwd=root)
    line = proc.stdout.readline().strip()
    if line != "ready":
        proc.kill()
        raise RuntimeError(f"worker for {root} did not start: {line!r}")
    return proc


def ask(proc: subprocess.Popen, case: str) -> float:
    proc.stdin.write(case + "\n")
    proc.stdin.flush()
    reply = json.loads(proc.stdout.readline())
    assert reply["case"] == case, reply
    return reply["ms"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=pathlib.Path)
    ap.add_argument("new", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    if "--worker" in sys.argv:
        worker()
        return 0
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("eager_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    roots = {"old": args.old.resolve(), "new": args.new.resolve()}
    procs = {}
    try:
        for side, root in roots.items():
            t0 = time.perf_counter()
            procs[side] = start(root)
            print(f"{side} ({root}) ready in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        readings = {case: {"old": [], "new": []} for case in CASES}
        for r in range(args.rounds):
            order = ("old", "new", "new", "old") if r % 2 == 0 \
                else ("new", "old", "old", "new")
            for case in CASES:
                for side in order:
                    readings[case][side].append(ask(procs[side], case))
        for p in procs.values():
            p.stdin.write("quit\n")
            p.stdin.flush()
            p.wait(timeout=60)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    out = {"card": card, "steps_per_reading": STEPS,
           "roots": {k: str(v) for k, v in roots.items()}, "cases": {}}
    for case, by_side in readings.items():
        row = {side: {"ms": ms, "median": float(np.median(ms)),
                      "min": float(np.min(ms))}
               for side, ms in by_side.items()}
        row["new_over_old_median"] = row["new"]["median"] \
            / row["old"]["median"]
        out["cases"][case] = row
        print(f"{case}: old median {row['old']['median']:.2f} ms (min "
              f"{row['old']['min']:.2f}), new median "
              f"{row['new']['median']:.2f} ms (min "
              f"{row['new']['min']:.2f}), new/old "
              f"{row['new_over_old_median']:.4f}; old "
              + ", ".join(f"{x:.2f}" for x in by_side["old"]) + "; new "
              + ", ".join(f"{x:.2f}" for x in by_side["new"]), flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "eager_ab.json").write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({case: row["new_over_old_median"]
                      for case, row in out["cases"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
