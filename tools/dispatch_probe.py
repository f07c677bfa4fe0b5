#!/usr/bin/env python3
"""Host cost of the autograd Functions on the serving path.

    python3 tools/dispatch_probe.py [--reps 40]

Serves smollm-360m at full width in bf16 (random weights from seed 0)
under ``torch.inference_mode`` and times, on the host's clock ended by a
synchronize, the mean eager 8-slot decode step (dense cache of 1024
positions) and the mean 512-token prefill, with every GEMM and
attention (prefill and decode) reached two ways:

* ``direct``: ``api._dispatch`` and ``attn_api._launch`` (what
  ``api._run`` and ``attn_api._run`` call when grad mode is off);
* ``function``: ``_GemmCore.apply`` and ``attn_api._AttnCore.apply``
  (the autograd Functions training goes through).

The variants alternate direct, function, function, direct, ROUNDS
times over, in one process on one card: the host's clock varies by
several ms between readings of one variant, so each variant's median
and minimum over its 2 * ROUNDS readings are compared.

It first times the host's cost of one kernel call: the mean host
microseconds to enqueue ``CALLS`` calls in a row (no synchronize
between them) of ``gemm_aie`` at a decode and a prefill shape and of
``gemm_tb`` at a decode shape's plan (five k-chunks, so five launches
a call), ``CALL_ROUNDS`` readings each, interleaved; each case's
median, minimum and spread (largest less smallest reading).  With
``--calls-only`` it stops there.  Prints the card's name and power
limit and every reading, and writes them to
``chiprun_out/dispatch_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import api, attn_api  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

PROMPT_LENS = (12, 160, 8, 24, 300, 16, 32, 9)
PREFILL_LEN = 512
ROUNDS = 4
CALLS = 200
CALL_ROUNDS = 8
#: (name, kernel, m, k, n): smollm-360m's wq at decode and in a 300-token
#: prefill on B1, its w_down at decode on B6 at the 'tb' plan's tile
CALL_CASES = (("gemm_aie 8x960x960", "aie", 8, 960, 960),
              ("gemm_aie 300x960x960", "aie", 300, 960, 960),
              ("gemm_tb 8x2560x960", "tb", 8, 2560, 960))


def run_direct(pl, a2, b, b2, bias, res2, out_scale=None):
    return api._dispatch(pl, a2, b, b2, bias, res2, out_scale)


def run_function(pl, a2, b, b2, bias, res2, out_scale=None):
    if out_scale is not None or pl.spec.b_quant:
        raise ValueError("the probe serves plain bf16 weights only")
    return api._GemmCore.apply(pl, a2, b, None, b2, None, bias, res2)


def attention_direct(pl, scale, q_offset, q, k, v, pos, page_table):
    return attn_api._launch(pl, scale, q_offset, q, k, v, pos, page_table)


def attention_function(pl, scale, q_offset, q, k, v, pos, page_table):
    return attn_api._AttnCore.apply(pl, scale, q_offset, q, k, v, pos,
                                    page_table)


VARIANTS = {"direct": (run_direct, attention_direct),
            "function": (run_function, attention_function)}


def mean_ms(fn, reps: int, sync) -> float:
    for _ in range(3):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


@torch.inference_mode()
def call_probe(device) -> dict:
    """Host µs a call of each :data:`CALL_CASES` kernel (bf16, seed-0
    operands): the mean over ``CALLS`` enqueued calls, ``CALL_ROUNDS``
    readings a case in turns; every reading, and each case's median,
    minimum and spread."""
    from repro_torch import ops
    from repro_torch.kernels.gemm_aie import gemm_aie
    from repro_torch.kernels.gemm_tb import gemm_tb
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    fns = {}
    for name, kernel, m, k, n in CALL_CASES:
        a = torch.randn((m, k), generator=gen, device=device,
                        dtype=torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device=device,
                        dtype=torch.bfloat16)
        if kernel == "aie":
            fns[name] = (lambda a=a, b=b: gemm_aie(a, b,
                                                   out_dtype=torch.bfloat16))
        else:
            tile = ops.plan(ops.GemmSpec(strategy="tb"), (m, k, n)).tile
            fns[name] = (lambda a=a, b=b, tile=tile: gemm_tb(
                a, b, tile=tile, out_dtype=torch.bfloat16))
    for fn in fns.values():     # build, warm the tensor-map cache
        fn()
    torch.cuda.synchronize(device)
    readings = {name: [] for name in fns}
    for _ in range(CALL_ROUNDS):
        for name, fn in fns.items():
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            readings[name].append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize(device)
    return {name: {"us": r, "median": float(np.median(r)),
                   "min": float(np.min(r)),
                   "spread": float(np.max(r) - np.min(r))}
            for name, r in readings.items()}


@torch.inference_mode()
def probe(cfg, device, reps: int) -> dict:
    """Every reading of each variant's mean decode-step and prefill ms,
    in the order direct, function, function, direct, ROUNDS times, and
    each variant's median and minimum."""
    device = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(cfg, gen, device=device)
    rng = np.random.default_rng(11)
    cache = T.init_cache(cfg, 8, 1024, device=device)
    for slot, p in enumerate(PROMPT_LENS):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, p)),
                               device=device)
        _, cache = T.prefill_into_slot(params, cfg, toks, cache, slot,
                                       max_len=1024)
    tok = torch.zeros((8, 1), dtype=torch.int64, device=device)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, PREFILL_LEN)),
                             device=device)
    fresh = T.init_cache(cfg, 1, PREFILL_LEN, device=device)

    def decode():
        # the dense cache's pos is not advanced: every step decodes the
        # same positions
        logits, _ = T.decode_step(params, cfg, tok, cache)
        return torch.argmax(logits, -1)

    rows = []
    saved = api._run, attn_api._run
    try:
        for name in ("direct", "function", "function", "direct") * ROUNDS:
            api._run, attn_api._run = VARIANTS[name]
            rows.append({
                "variant": name,
                "decode_step_ms": mean_ms(decode, reps, sync),
                "prefill_ms": mean_ms(
                    lambda: T.prefill(params, cfg, prompt, fresh),
                    max(1, reps // 4), sync)})
    finally:
        api._run, attn_api._run = saved
    summary = {name: {f"{k}_{stat.__name__}": float(stat(
        [r[k] for r in rows if r["variant"] == name]))
        for k in ("decode_step_ms", "prefill_ms")
        for stat in (np.median, np.min)} for name in VARIANTS}
    return {"config": cfg.name, "reps": reps, "rows": rows,
            "summary": summary}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--calls-only", action="store_true",
                    help="only the host µs a kernel call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dispatch_probe: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    calls = call_probe("cuda")
    for name, c in calls.items():
        print(f"[dispatch] host us a call, {name}: median "
              f"{c['median']:.2f}, min {c['min']:.2f}, spread "
              f"{c['spread']:.2f} over {CALL_ROUNDS} readings of {CALLS} "
              f"calls [{card}]")
    out = {"calls": calls, "rows": [], "summary": {}} if args.calls_only \
        else probe(get_config("smollm-360m"), "cuda", args.reps) | {
            "calls": calls}
    out["card"] = card
    for r in out["rows"]:
        print(f"[dispatch] {r['variant']:8s} decode step "
              f"{r['decode_step_ms']:.3f} ms, prefill {PREFILL_LEN} "
              f"{r['prefill_ms']:.3f} ms [{card}]")
    for name, s in out["summary"].items():
        print(f"[dispatch] {name:8s} median / min: decode step "
              f"{s['decode_step_ms_median']:.3f} / "
              f"{s['decode_step_ms_min']:.3f} ms, prefill "
              f"{s['prefill_ms_median']:.3f} / {s['prefill_ms_min']:.3f} ms "
              f"[{card}]")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "dispatch_probe.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
