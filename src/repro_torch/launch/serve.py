"""Serving entry point: a Poisson-arrival request trace through the
continuous-batching engine on the CUDA card (or on the CPU when asked).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --trace 16 --rate 4 --slots 8 --steps 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --trace 8 --slots 2 --steps 8 --device cpu

    # block-paged KV pool, chunked prefill, prefix sharing
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --page-size 16 --prefill-chunk 8 --device cpu

    # int8 weights (W8A16), or int8 weights and activations (W8A8)
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --int8 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --w8a8 \
        --device cpu

    # one lockstep batch through engine.generate instead of a trace
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --batch 4 \
        --prompt-len 16 --steps 8 --device cpu

    # spans / counters to PATH.jsonl + PATH.trace.json; measured tile
    # search (top-8) with winners kept in $REPRO_TUNE_CACHE
    T=$(mktemp -d)
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --telemetry $T/serve --autotune 8 --device cpu

Weights are random, drawn from ``--seed``.  Prints the same ``[serve]``
lines as ``repro.launch.serve``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import ops, quant, resolve_device, telemetry, tune
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import DecodeEngine, Request

#: prompt lengths a trace draws from
TRACE_PROMPT_BUCKETS = (4, 8, 16, 32)


def make_trace(cfg, n_requests: int, rate: float, max_steps: int,
               temperature: float, seed: int = 0) -> list:
    """Poisson-arrival workload: exponential inter-arrival gaps at
    ``rate`` req/s, prompt lengths from TRACE_PROMPT_BUCKETS, max_tokens
    uniform in [2, max_steps]."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    arrivals -= arrivals[0]                  # first request at t=0
    reqs = []
    for t in arrivals:
        plen = int(rng.choice(TRACE_PROMPT_BUCKETS))
        reqs.append(Request(
            prompt=rng.integers(0, cfg.vocab, (plen,)).astype(np.int32),
            max_tokens=int(rng.integers(2, max(max_steps, 2) + 1)),
            temperature=temperature, arrival=float(t)))
    return reqs


def _warmup(engine: DecodeEngine, cfg, prompt_lens,
            temperature: float = 0.0) -> None:
    """Run one short request per prompt length (and the sampling path
    the trace uses) before any timed work, so the first timed step pays
    no kernel build or allocator growth."""
    rng = np.random.default_rng(1234)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (int(p),))
                    .astype(np.int32), max_tokens=2,
                    temperature=temperature)
            for p in sorted(set(int(p) for p in prompt_lens))]
    engine.run(reqs)
    engine.reset_metrics()
    info = ops.plan_cache_info()
    print(f"[serve] gemm plan cache after warm-up: {info.entries} "
          f"plans ({info.hits} hits / {info.misses} misses)")
    _print_tune_info()


def _print_tune_info() -> None:
    """Tuning-cache state after warm-up (only when autotuning is on):
    entries, hit / measure counters, and how many live plans took the
    measured winner against the analytic answer."""
    if not tune.is_enabled():
        return
    ti = tune.tuning_cache_info()
    plans = ops.plans()
    tuned = sum(1 for p in plans if p.source == "tuned")
    print(f"[serve] tuning cache {tune.cache_path()}: {ti.entries} "
          f"entries ({ti.hits} hits / {ti.measurements} measured); "
          f"{tuned}/{len(plans)} plans tuned")


def run_trace(engine: DecodeEngine, cfg, args) -> None:
    reqs = make_trace(cfg, args.trace, args.rate, args.steps,
                      args.temperature, seed=args.seed)
    _warmup(engine, cfg, [r.prompt.shape[0] for r in reqs],
            temperature=args.temperature)
    t0 = time.perf_counter()
    results = engine.run(reqs, now_fn=lambda: time.perf_counter() - t0)
    dt = time.perf_counter() - t0
    lat = np.asarray([r.finished_time - r.arrival for r in results])
    ttft = np.asarray([r.ttft for r in results])
    qwait = np.asarray([r.queue_wait for r in results])
    gen = sum(r.n_tokens for r in results)
    m = engine.metrics
    print(f"[serve] trace: {len(results)}/{args.trace} requests, "
          f"{gen} tokens in {dt:.2f}s "
          f"({gen / dt:.1f} tok/s end-to-end, "
          f"{engine.tokens_per_sec():.1f} tok/s decode)")
    print(f"[serve] latency: mean {lat.mean()*1e3:.0f} ms, "
          f"p99 {np.percentile(lat, 99)*1e3:.0f} ms; "
          f"slot occupancy {engine.occupancy():.2f} "
          f"({m['decode_steps']} steps x {engine.n_slots} slots, "
          f"{m['prefill_tokens']} prompt tokens)")
    print(f"[serve] ttft: mean {ttft.mean()*1e3:.0f} ms, "
          f"p99 {np.percentile(ttft, 99)*1e3:.0f} ms; "
          f"queue wait: mean {qwait.mean()*1e3:.0f} ms, "
          f"p99 {np.percentile(qwait, 99)*1e3:.0f} ms")
    if engine.paged:
        print(f"[serve] paged KV: {m['prefill_chunks']} prefill "
              f"chunks, max decode stall "
              f"{m['max_prefill_stall_tokens']} prompt tokens; "
              f"prefix cache {m['prefix_hits']} hits / "
              f"{m['prefix_misses']} misses "
              f"({m['shared_prompt_tokens']} prompt tokens shared); "
              f"peak {m['peak_pages_used']} pages in use")
        dense = m["modeled_kv_bytes_dense_rows"]
        if dense:
            print(f"[serve] modeled decode KV stream "
                  f"{m['modeled_kv_bytes'] / 2**20:.2f} MiB at true "
                  f"positions vs {dense / 2**20:.2f} MiB at dense "
                  f"max_len rows ({m['modeled_kv_bytes'] / dense:.2f}x)")


def run_batch(engine: DecodeEngine, cfg, args) -> None:
    """One lockstep batch of ``--batch`` prompts of ``--prompt-len``
    tokens through ``engine.generate``, after one throwaway generation
    (kernel builds, allocator growth) of two tokens."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)) \
        .astype(np.int32)
    engine.generate(prompts, min(2, args.steps + 1))
    engine.reset_metrics()
    _print_tune_info()
    t0 = time.perf_counter()
    result = engine.generate(prompts, args.steps)
    dt = time.perf_counter() - t0
    tok_s = args.batch * result.steps / dt
    print(f"[serve] generated {result.steps} steps x {args.batch} seqs "
          f"in {dt:.2f}s ({tok_s:.1f} tok/s, "
          f"{engine.tokens_per_sec():.1f} tok/s decode-only)")
    print("[serve] first sequence:", result.tokens[0][:16], "...")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--trace", type=int, default=8,
                    help="serve N Poisson-arrival requests")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="trace arrival rate (requests/sec)")
    ap.add_argument("--batch", type=int, default=None,
                    help="serve one lockstep batch of this many prompts "
                         "through engine.generate instead of a trace")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt length of --batch")
    ap.add_argument("--slots", type=int, default=None,
                    help="cache slots of the continuous batch (default: "
                         "4 for a trace, --batch for a batch)")
    ap.add_argument("--steps", type=int, default=16,
                    help="largest max_tokens a request draws")
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="block-paged KV cache with this page size "
                         "(tokens); max_len rounds up to a page multiple")
    ap.add_argument("--pages", type=int, default=None,
                    help="KV pool size in pages incl. the sink page "
                         "(default: dense-equivalent capacity)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split paged admissions into chunks of this many "
                         "prompt tokens, interleaved with decode bursts")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable content-hash prefix sharing of paged "
                         "prompt pages")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="record spans / counters for the whole run and "
                         "write PATH.jsonl + PATH.trace.json (the latter "
                         "loads in chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--autotune", nargs="?", const=True, default=None,
                    metavar="K",
                    help="measured top-K tile search (on the serving "
                         "device) for every GEMM the warm-up plans; "
                         "winners persist to the tuning cache "
                         "($REPRO_TUNE_CACHE, default "
                         "artifacts/tune_cache.json), so a later serve "
                         "re-plans with zero re-measurement")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights, bf16 activations (W8A16)")
    ap.add_argument("--w8a8", action="store_true",
                    help="int8 weights + dynamic per-row int8 activations "
                         "(the paper's int8 x int8 / int32-accumulate "
                         "scheme); implies --int8")
    args = ap.parse_args(argv)
    if args.trace < 1:
        ap.error("--trace must be at least 1")
    if args.batch is not None and (args.batch < 1 or args.prompt_len < 1):
        ap.error("--batch and --prompt-len must be at least 1")
    if args.page_size is None and (args.pages or args.prefill_chunk
                                   or args.no_prefix_cache):
        ap.error("--pages, --prefill-chunk and --no-prefix-cache need "
                 "--page-size")

    quant.set_activation_mode("w8a8" if args.w8a8 else "none")
    device = resolve_device(args.device)
    if args.telemetry:
        telemetry.enable()
    if args.autotune:
        tune.enable(None if args.autotune is True else int(args.autotune),
                    device=device)
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    if args.int8 or args.w8a8:  # the paper's precision: int8 weights
        before = quant.param_bytes(params)
        params, n = quant.quantize_params(params)
        print(f"[serve] int8-quantized {n} weight banks: "
              f"{before / 2**20:.0f} -> "
              f"{quant.param_bytes(params) / 2**20:.0f} MiB "
              f"({before} -> {quant.param_bytes(params)} bytes)")
    if args.batch is not None:
        n_slots = args.slots or args.batch
        max_len = args.max_len or args.prompt_len + max(args.steps, 2)
    else:
        n_slots = args.slots or 4
        # trace prompts come from the buckets; the warm-up needs 2 tokens
        max_len = args.max_len or max(TRACE_PROMPT_BUCKETS) \
            + max(args.steps, 2)
    engine = DecodeEngine(params, cfg, batch=n_slots, max_len=max_len,
                          page_size=args.page_size, n_pages=args.pages,
                          prefill_chunk=args.prefill_chunk,
                          prefix_cache=not args.no_prefix_cache,
                          seed=args.seed, device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[serve] {cfg.name} ({cfg.dtype}) on {name}: {n_slots} "
          f"slots x {engine.max_len} positions")
    mode = "w8a8" if args.w8a8 else "w8a16" if args.int8 else cfg.dtype
    bpt = engine.modeled_bytes_per_token()
    print(f"[serve] {mode}: modeled GEMM weight stream "
          f"{bpt / 2**20:.1f} MiB/step ({bpt / n_slots / 2**20:.2f} MiB "
          f"per seq-token at {n_slots} slots)")
    if engine.paged:
        print(f"[serve] paged KV: {engine.kv.pool.n_pages - 1} pages x "
              f"{engine.page_size} tokens (+1 sink), "
              f"{engine.kv.max_pages} pages/slot"
              + (f", prefill chunk {engine.prefill_chunk}"
                 if engine.prefill_chunk else ""))
    if args.batch is not None:
        run_batch(engine, cfg, args)
    else:
        run_trace(engine, cfg, args)
    if args.telemetry:
        _, lines = telemetry.export_report("serve", args.telemetry)
        print("\n".join(lines))


if __name__ == "__main__":
    main()
