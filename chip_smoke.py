#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. require CUDA; print the card's name and power limit; TF32 off;
2. build the hand-written kernels from ``src/repro_torch/csrc``;
3. hold each kernel against its plain PyTorch version at the serving
   paths' bf16 shapes and at one f32 edge shape, and time the kernel,
   the plain version and one PyTorch library call for the same function
   where one exists (CUDA events over CUDA-graph replays, median of 20;
   operands cycled over more than 100 MB so each call finds the L2
   cache cold, as a layer of the real model does); then the paged
   decode kernel must equal the dense one bit for bit on one logical
   cache scattered into a permuted pool, at page sizes 16, 32 and 64;
4. serve smollm-360m at full width (bf16, random weights from seed 0)
   through ``DecodeEngine`` with 8 slots x 1024 positions, on the dense
   cache and then on the page pool (16-token pages, 64-token prefill
   chunks, prefix cache on, two requests sharing a 64-token prefix):
   each path's kernels must have launched exactly as often as its steps
   and prefill chunks say, the other decode kernel and every plain
   version not at all; then one 8-slot decode step of each cache is
   timed from CUDA-graph replays (device time alone) beside the same
   step run eagerly, which gives the device's idle share of an eager
   step;
5. continuous-batched greedy == solo greedy on the dense cache, token
   for token, at full width (the acceptance trace); then paged greedy
   (2 slots, 16-token pages, 16-token chunks) == dense solo greedy on
   the acceptance trace plus a short and a 96-token prompt, and on two
   prompts sharing a prefix with the prefix cache on;
6. smollm-360m-smoke (f32): prefill + 8 decode steps on the card match
   the same port on the CPU within atol=rtol=1e-4.

Prints a ``{"kernels": [...]}`` line and the card line before the last
line, which is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.bridge import to_device  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode, flash_decode_paged, flash_decode_paged_plain,
    flash_decode_plain)
from repro_torch.kernels.gemm_aie import gemm_aie, gemm_aie_plain  # noqa
from repro_torch.kernels.gemm_gated import (  # noqa: E402
    gemm_gated, gemm_gated_plain)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    ACCEPTANCE_TRACE, DecodeEngine, Request, acceptance_requests,
    solo_greedy)

# H100 SXM datasheet peaks: HBM bytes/s and
# dense operations/s by operand type (bf16 tensor cores; f32 outside them)
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
COLD_BYTES = 128 << 20        # operands cycled per timing, > 50 MB L2
REPS = 20

KERNELS = {
    "gemm_aie": (gemm_aie, gemm_aie_plain, "src/repro_torch/csrc/gemm_aie.cu",
                 "src/repro/kernels/gemm_aie.py:143"),
    "gemm_gated": (gemm_gated, gemm_gated_plain,
                   "src/repro_torch/csrc/gemm_gated.cu",
                   "src/repro/kernels/gemm_gated.py:114"),
    "flash_attention": (flash_attention, flash_attention_plain,
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:125"),
    "flash_decode": (flash_decode, flash_decode_plain,
                     "src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:144"),
    "flash_decode_paged": (flash_decode_paged, flash_decode_paged_plain,
                           "src/repro_torch/csrc/flash_decode_paged.cu",
                           "src/repro/kernels/flash_decode.py:275"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 3

_GEN = None


def rand(shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=_GEN, device="cuda") * scale) \
        .to(dtype)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def gemm_case(name, weight, m, k, n, dtype, *, residual=False, bias=False,
              act=None, out_dtype=None):
    out_dtype = out_dtype or dtype

    def make():
        kw = {"out_dtype": out_dtype}
        if residual:
            kw["residual"] = rand((m, n), dtype)
        if bias:
            kw["bias"] = rand((n,), torch.float32)
        if act:
            kw["activation"] = act
        return (rand((m, k), dtype), rand((k, n), dtype, k ** -0.5)), kw

    def library(a, b, out_dtype, residual=None, bias=None, activation=None):
        x = torch.matmul(a, b)
        if bias is not None:
            x = x + bias
        if activation == "silu":
            x = F.silu(x)
        if residual is not None:
            x = x + residual
        return x.to(out_dtype)

    def cost(args, kw):
        a, b = args
        out = m * n * torch.empty((), dtype=out_dtype).element_size()
        return (nbytes(a, b, kw.get("residual"), kw.get("bias")) + out,
                2.0 * m * n * k)
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=library, cost=cost)


def gated_case(name, weight, m, k, n, dtype):
    def make():
        return (rand((m, k), dtype), rand((k, n), dtype, k ** -0.5),
                rand((k, n), dtype, k ** -0.5)), {}

    def library(a, bg, bu):
        return F.silu(torch.matmul(a, bg)) * torch.matmul(a, bu)

    def cost(args, kw):
        a, bg, bu = args
        return nbytes(a, bg, bu, a.new_empty((m, n))), 4.0 * m * n * k
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=library, cost=cost)


def attn_case(name, weight, b, s, hq, hkv, d, dtype):
    def make():
        return (rand((b, s, hq, d), dtype), rand((b, s, hkv, d), dtype),
                rand((b, s, hkv, d), dtype)), {"causal": True}

    def library(q, k, v, causal):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)

    def cost(args, kw):
        q, k, v = args
        pairs = b * s * (s + 1) / 2                 # causal (q, k) pairs
        return nbytes(q, k, v, q), 4.0 * hq * d * pairs
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=library, cost=cost)


def decode_case(name, weight, pos, S, hq, hkv, d, dtype):
    b = len(pos)

    def make():
        p = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
        return (rand((b, hq, d), dtype), rand((b, S, hkv, d), dtype),
                rand((b, S, hkv, d), dtype), p), {}

    def library(q, k, v, p):
        mask = torch.arange(S, device="cuda")[None, :] <= p[:, None]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=True)[:, :, 0]

    def cost(args, kw):
        q = args[0]
        keys = sum(min(p, S - 1) + 1 for p in pos)  # rows each slot reads
        row = hkv * d * q.element_size()
        return nbytes(q, q) + 2 * keys * row, 4.0 * hq * d * keys
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=library, cost=cost)


def paged_case(name, weight, pos, ps, max_pages, hq, hkv, d, dtype, *,
               window=0, sink_row=None):
    """Decode over a pool of 1 + slots * max_pages pages, each slot's
    table a random permutation of physical pages (page 0, the sink,
    stays out of live tables; ``sink_row`` gets an all-sink table)."""
    b = len(pos)
    n_pages = 1 + b * max_pages
    S = max_pages * ps

    def make():
        perm = torch.randperm(n_pages - 1, generator=_GEN, device="cuda")
        table = (perm + 1).reshape(b, max_pages).to(torch.int32)
        if sink_row is not None:
            table[sink_row] = 0
        p = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
        return (rand((b, hq, d), dtype), rand((n_pages, ps, hkv, d), dtype),
                rand((n_pages, ps, hkv, d), dtype), table, p), \
            {"window": window}

    def gather_sdpa(q, k_pages, v_pages, table, p, window):
        """No single PyTorch call attends through a page table: this is
        two, the gather and scaled_dot_product_attention."""
        k = k_pages[table.long()].reshape(b, S, hkv, d)
        v = v_pages[table.long()].reshape(b, S, hkv, d)
        mask = torch.arange(S, device="cuda")[None, :] <= p[:, None]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=True)[:, :, 0]

    def cost(args, kw):
        q, table = args[0], args[3]
        keys = sum(min(p, S - 1) + 1 for p in pos)  # rows each slot reads
        row = hkv * d * q.element_size()
        return nbytes(q, q, table) + 2 * keys * row, 4.0 * hq * d * keys
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=None, two_calls=gather_sdpa, cost=cost)


def device_ms(fn, inputs) -> float:
    """Median device time of one call, from CUDA-graph replays of one
    call per input set (the sets together exceed the L2 cache)."""
    for args, kw in inputs[:2]:
        fn(*args, **kw)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs[0][0], **inputs[0][1])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args, kw in inputs:
            fn(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / len(inputs))
    return float(np.median(times))


def check_kernel(name, cases):
    kernel, plain, _, _ = KERNELS[name]
    rows, worst = [], 0.0
    for case in cases:
        first = case["make"]()
        args, kw = first
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{name} {case['name']}: non-finite output")
        err = (got.float() - want.float()).abs()
        tol = TOL[case["dtype"]]
        bad = err > tol + tol * want.float().abs()
        if bad.any():
            raise RuntimeError(
                f"{name} {case['name']}: {int(bad.sum())} elements off, "
                f"max abs err {err.max().item():.3e}")
        row = {"case": case["name"], "weight": case["weight"],
               "max_abs_err": err.max().item()}
        worst = max(worst, row["max_abs_err"])
        if case["weight"]:
            per = nbytes(*args, *(v for v in kw.values()
                                  if isinstance(v, torch.Tensor)))
            copies = max(1, min(64, math.ceil(COLD_BYTES / per)))
            inputs = [first] + [case["make"]() for _ in range(copies - 1)]
            b, ops = case["cost"](args, kw)
            library = case["library"]
            if "two_calls" in case:
                row["gather_sdpa_ms"] = device_ms(case["two_calls"], inputs)
            row.update(
                ms=device_ms(kernel, inputs),
                plain_ms=device_ms(plain, inputs),
                library_ms=device_ms(library, inputs) if library else None,
                bytes=b, ops=ops,
                bound_ms=max(b / PEAK_BYTES, ops / PEAK_OPS[case["dtype"]])
                * 1e3,
                bound_by="bytes" if b / PEAK_BYTES
                >= ops / PEAK_OPS[case["dtype"]] else "operations")
            del inputs
        rows.append(row)
        lib = row.get("library_ms")
        log(f"  {name:18s} {case['name']:32s} err {row['max_abs_err']:.2e}"
            + (f"  kernel {row['ms']*1e3:8.1f} us  plain "
               f"{row['plain_ms']*1e3:8.1f} us  library "
               + (f"{lib*1e3:8.1f} us" if lib is not None else "       —")
               + f"  bound {row['bound_ms']*1e3:7.1f} us ({row['bound_by']})"
               + (f"  gather+sdpa (2 calls) "
                  f"{row['gather_sdpa_ms']*1e3:.1f} us"
                  if "gather_sdpa_ms" in row else "")
               if "ms" in row else "  (edge shape, not timed)"))
    timed = [r for r in rows if "ms" in r]
    total = {key: sum(r["weight"] * r[key] for r in timed)
             for key in ("ms", "plain_ms", "bound_ms", "bytes", "ops")}
    libs = [r["library_ms"] for r in timed]
    total["library_ms"] = None if None in libs else \
        sum(r["weight"] * r["library_ms"] for r in timed)
    return rows, worst, total


def kernel_phase():
    bf, f32 = torch.bfloat16, torch.float32
    d, hq, hkv, ff, V = 960, 15, 5, 2560, 49152
    pos = [17, 40, 95, 160, 210, 300, 333, 363]
    plan = {
        # weights = launches of that shape in one decode step (8 slots)
        "gemm_aie": [
            gemm_case("decode wq 8x960x960", 32, 8, d, d, bf),
            gemm_case("decode wk/wv 8x960x320", 64, 8, d, 320, bf),
            gemm_case("decode wo+res 8x960x960", 32, 8, d, d, bf,
                      residual=True),
            gemm_case("decode down+res 8x2560x960", 32, 8, ff, d, bf,
                      residual=True),
            gemm_case("decode lm_head 8x960x49152", 1, 8, d, V, bf,
                      out_dtype=f32),
            gemm_case("prefill wq 300x960x960", 0, 300, d, d, bf),
            gemm_case("edge f32 3x60x49152 bias+silu+res", 0, 3, 60, V, f32,
                      residual=True, bias=True, act="silu"),
        ],
        "gemm_gated": [
            gated_case("decode gate/up 8x960x2560", 32, 8, d, ff, bf),
            gated_case("prefill gate/up 300x960x2560", 0, 300, d, ff, bf),
            gated_case("edge f32 3x60x160", 0, 3, 60, 160, f32),
        ],
        "flash_attention": [
            # weights = launches in one 300-token prefill
            attn_case("prefill 1x300 h15/5 d64", 32, 1, 300, hq, hkv, 64,
                      bf),
            attn_case("prefill 1x12 h15/5 d64", 0, 1, 12, hq, hkv, 64, bf),
            attn_case("edge f32 2x45 h3/1 d20", 0, 2, 45, 3, 1, 20, f32),
        ],
        "flash_decode": [
            decode_case("decode 8 slots S1024 h15/5 d64", 32, pos, 1024,
                        hq, hkv, 64, bf),
            decode_case("edge f32 3 slots S50 h3/1 d20", 0, [0, 17, 49],
                        50, 3, 1, 20, f32),
        ],
        "flash_decode_paged": [
            paged_case("decode 8 slots 64x16 h15/5 d64", 32, pos, 16, 64,
                       hq, hkv, 64, bf),
            paged_case("edge f32 4 slots 7x8 h3/1 d20 w20", 0,
                       [0, 17, 55, 70], 8, 7, 3, 1, 20, f32, window=20,
                       sink_row=2),
        ],
    }
    return {name: check_kernel(name, cases) for name, cases in plan.items()}


def paged_bitwise_phase():
    """B5 == B4, bit for bit: one logical bf16 cache of 8 slots x 1024
    positions, dense and scattered into a permuted pool, at the serve
    path's page size and two larger ones, with and without a window."""
    b, S, hq, hkv, d = 8, 1024, 15, 5, 64
    q = rand((b, hq, d), torch.bfloat16)
    k = rand((b, S, hkv, d), torch.bfloat16)
    v = rand((b, S, hkv, d), torch.bfloat16)
    pos = torch.as_tensor([17, 40, 95, 160, 210, 300, 1023, 1500],
                          dtype=torch.int32, device="cuda")
    for ps in (16, 32, 64):
        max_pages = S // ps
        n_pages = 1 + b * max_pages
        perm = torch.randperm(n_pages - 1, generator=_GEN, device="cuda")
        table = (perm + 1).reshape(b, max_pages).to(torch.int32)
        k_pages = rand((n_pages, ps, hkv, d), torch.bfloat16)
        v_pages = rand((n_pages, ps, hkv, d), torch.bfloat16)
        k_pages[table.long()] = k.reshape(b, max_pages, ps, hkv, d)
        v_pages[table.long()] = v.reshape(b, max_pages, ps, hkv, d)
        for window in (0, 100):
            got = flash_decode_paged(q, k_pages, v_pages, table, pos,
                                     window=window)
            want = flash_decode(q, k, v, pos, window=window)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"flash_decode_paged != flash_decode at "
                                   f"page size {ps}, window {window}")
    log("paged == dense decode, bit for bit, at page sizes 16/32/64 "
        "(8 slots x 1024, permuted pool, window 0 and 100)")
    return [16, 32, 64]


# ---------------------------------------------------------------- phase 4

#: prompts of the serve trace: mostly short, two past 128 tokens
SERVE_PROMPT_LENS = (12, 160, 8, 24, 300, 16, 32, 9, 20, 28)


def reset_counters():
    for kernel, plain, _, _ in KERNELS.values():
        kernel.launches = 0
        plain.launches = 0


def serve_trace(cfg):
    rng = np.random.default_rng(7)
    return [Request(prompt=rng.integers(0, cfg.vocab, (p,)).astype(np.int32),
                    max_tokens=int(rng.integers(16, 65)))
            for p in SERVE_PROMPT_LENS]


def shared_prefix_requests(cfg, prefix_len, tail_len, max_tokens, seed):
    """Two prompts that share their first ``prefix_len`` tokens."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab, (prefix_len,)).astype(np.int32)
    return [Request(prompt=np.concatenate(
        [pre, rng.integers(0, cfg.vocab, (tail_len,)).astype(np.int32)]),
        max_tokens=max_tokens) for _ in range(2)]


def serve_phase(cfg, params, *, paged):
    """Serve the trace through the dense engine or, ``paged``, through
    the paged one (16-token pages, 64-token chunks, prefix cache on)
    with two shared-prefix requests added.  The kernel counts are set to
    0 just before the run and read just after."""
    trace = serve_trace(cfg)
    kw = dict(page_size=16, prefill_chunk=64) if paged else {}
    if paged:
        trace += shared_prefix_requests(cfg, 64, 20, 32, seed=8)
    engine = DecodeEngine(params, cfg, batch=8, max_len=1024, device="cuda",
                          **kw)
    engine.run([Request(prompt=trace[0].prompt[:5], max_tokens=2)])  # warm-up
    engine.reset_metrics()

    reset_counters()
    t0 = time.perf_counter()
    results = engine.run(trace)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: k.launches for n, (k, _, _, _) in KERNELS.items()}
    plain = {n: p.launches for n, (_, p, _, _) in KERNELS.items()}

    m = engine.metrics
    steps = m["decode_steps"]
    prefills = m["prefill_chunks"]
    decode, other = ("flash_decode_paged", "flash_decode") if paged \
        else ("flash_decode", "flash_decode_paged")
    want = {"gemm_aie": 161 * (steps + prefills),
            "gemm_gated": 32 * (steps + prefills),
            decode: 32 * steps, other: 0,
            "flash_attention": 32 * prefills}
    if launches != want or any(plain.values()):
        raise RuntimeError(f"{'paged' if paged else 'dense'} path launches "
                           f"{launches} (expected {want}), plain versions "
                           f"{plain}")
    if paged and (m["prefix_hits"] < 1
                  or m["max_prefill_stall_tokens"] > 64):
        raise RuntimeError(f"paged serve: {m['prefix_hits']} prefix hits, "
                           f"max stall {m['max_prefill_stall_tokens']} "
                           "tokens (want >= 1 hit, <= 64 tokens)")
    by_rid = {r.rid: r for r in results}
    for req in trace:
        r = by_rid[req.rid]
        if r.n_tokens != req.max_tokens or \
                not ((r.tokens >= 0) & (r.tokens < cfg.vocab)).all():
            raise RuntimeError(f"request {req.rid}: bad tokens {r.tokens}")
    gen = sum(r.n_tokens for r in results)
    ttft = np.asarray([r.ttft for r in results])
    out = {"requests": len(results), "generated_tokens": gen,
           "seconds": dt, "tok_s_end_to_end": gen / dt,
           "tok_s_decode": engine.tokens_per_sec(),
           "decode_steps": steps, "decode_ms_per_step":
               m["decode_time"] / max(steps, 1) * 1e3,
           "prefill_seconds": m["prefill_time"],
           "ttft_mean_ms": float(ttft.mean() * 1e3),
           "ttft_p99_ms": float(np.percentile(ttft, 99) * 1e3),
           "occupancy": engine.occupancy(), "launches": launches,
           "plain_launches": plain, "prefill_chunks": prefills,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    tag = "paged serve" if paged else "serve"
    if paged:
        out.update({k: m[k] for k in (
            "max_prefill_stall_tokens", "prefix_hits", "prefix_misses",
            "shared_prompt_tokens", "peak_pages_used")})
    log(f"{tag}: {len(results)} requests, {gen} tokens in {dt:.2f} s "
        f"({out['tok_s_end_to_end']:.1f} tok/s end-to-end, "
        f"{out['tok_s_decode']:.1f} tok/s decode, "
        f"{out['decode_ms_per_step']:.2f} ms/step); ttft mean "
        f"{out['ttft_mean_ms']:.0f} ms p99 {out['ttft_p99_ms']:.0f} ms; "
        f"occupancy {out['occupancy']:.2f}")
    if paged:
        log(f"{tag}: {prefills} prefill chunks, max stall "
            f"{m['max_prefill_stall_tokens']} tokens; prefix "
            f"{m['prefix_hits']} hits / {m['prefix_misses']} misses, "
            f"{m['shared_prompt_tokens']} tokens shared; peak "
            f"{m['peak_pages_used']} of {engine.kv.pool.n_pages - 1} pages "
            "in use")
    log(f"{tag}: launches {launches}; plain versions {plain}")
    return out


@torch.inference_mode()
def step_phase(cfg, params, *, paged):
    """Device time of one 8-slot decode step (with its greedy argmax),
    from CUDA-graph replays that take the host out of the step, beside
    the same step run eagerly; the difference is the device's idle time
    in an eager step.  The same eight prompts sit in the dense cache or,
    ``paged``, in 16-token pages of a pool (64 pages a slot, so the
    gathered length equals the dense 1024)."""
    rng = np.random.default_rng(11)
    if paged:
        cache = T.init_paged_cache(cfg, 8, 1 + 8 * 64, 16, 64, device="cuda")
        rows = np.arange(1, 1 + 8 * 64, dtype=np.int32).reshape(8, 64)
    else:
        cache = T.init_cache(cfg, 8, 1024, device="cuda")
    for slot, p in enumerate(SERVE_PROMPT_LENS[:8]):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, p)),
                               device="cuda")
        if paged:
            _, cache = T.prefill_paged_chunk(params, cfg, toks, cache, slot,
                                             rows[slot], 0)
        else:
            _, cache = T.prefill_into_slot(params, cfg, toks, cache, slot,
                                           max_len=1024)
    if paged:
        cache["page_table"].copy_(torch.as_tensor(rows))
    tok = torch.zeros((8, 1), dtype=torch.int64, device="cuda")

    def step(tok, cache):
        logits, _ = T.decode_step(params, cfg, tok, cache)
        return torch.argmax(logits, -1)

    device = device_ms(step, [((tok, cache), {})])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        step(tok, cache)
    torch.cuda.synchronize()
    eager = (time.perf_counter() - t0) / REPS * 1e3
    out = {"device_ms_per_step": device, "eager_ms_per_step": eager,
           "device_idle_share": 1.0 - device / eager}
    log(f"{'paged' if paged else 'dense'} decode step (8 slots): device "
        f"{device:.2f} ms (CUDA graph), eager {eager:.2f} ms; device idle "
        f"{out['device_idle_share']:.1%} of an eager step")
    return out


def bit_identity_phase(cfg, params):
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    reqs = acceptance_requests(cfg.vocab)
    engine = DecodeEngine(params, cfg, batch=2, max_len=max_len,
                          device="cuda")
    results = {r.rid: r.tokens for r in engine.run(reqs)}
    for req in reqs:
        want = solo_greedy(params, cfg, req.prompt, req.max_tokens, max_len)
        if not np.array_equal(results[req.rid], want):
            raise RuntimeError(f"continuous != solo greedy for request "
                               f"{req.rid}: {results[req.rid]} vs {want}")
    log(f"bit identity: {len(reqs)} acceptance requests, continuous "
        "batch == solo greedy at full width")
    return len(reqs)


#: the paged trace of benchmarks/serve_bench.py: the acceptance trace
#: plus a short and a 96-token prompt
PAGED_TRACE = ACCEPTANCE_TRACE + ((8, 8), (96, 8))


def paged_bit_identity_phase(cfg, params):
    """Paged greedy == dense solo greedy at full width: 2 slots, 16-token
    pages, 16-token chunks, prefix cache off, on the paged trace; then
    two prompts sharing a 32-token prefix with the prefix cache on."""
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (p,)).astype(np.int32),
                    max_tokens=mt) for p, mt in PAGED_TRACE]
    max_len = -(-max(p + mt - 1 for p, mt in PAGED_TRACE) // 16) * 16
    runs = [(reqs, False), (shared_prefix_requests(cfg, 32, 8, 8, seed=7),
                            True)]
    n = 0
    for trace, prefix in runs:
        engine = DecodeEngine(params, cfg, batch=2, max_len=max_len,
                              page_size=16, prefill_chunk=16,
                              prefix_cache=prefix, device="cuda")
        results = {r.rid: r.tokens for r in engine.run(trace)}
        for req in trace:
            want = solo_greedy(params, cfg, req.prompt, req.max_tokens,
                               max_len)
            if not np.array_equal(results[req.rid], want):
                raise RuntimeError(
                    f"paged != dense solo greedy for request {req.rid} "
                    f"(prefix cache {prefix}): {results[req.rid]} vs {want}")
        if prefix and engine.metrics["prefix_hits"] != 1:
            raise RuntimeError("paged bit identity: the shared prefix was "
                               "not shared")
        n += len(trace)
    log(f"paged bit identity: {n} requests, paged greedy (pages 16, chunks "
        "16) == dense solo greedy at full width, 2 of them sharing a "
        "32-token prefix")
    return n


@torch.inference_mode()
def cross_device_phase():
    cfg = get_smoke_config("smollm-360m")
    cpu_params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    gpu_params = to_device(cpu_params, "cuda")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12)))
    c_cache = T.init_cache(cfg, 2, 40, device="cpu")
    g_cache = T.init_cache(cfg, 2, 40, device="cuda")
    c_log, c_cache = T.prefill(cpu_params, cfg, toks, c_cache)
    g_log, g_cache = T.prefill(gpu_params, cfg, toks.cuda(), g_cache)
    worst = 0.0
    for step in range(9):
        torch.testing.assert_close(g_log.cpu(), c_log, atol=1e-4,
                                   rtol=1e-4)
        worst = max(worst, (g_log.cpu() - c_log).abs().max().item())
        if step == 8:
            break
        tok = torch.argmax(c_log, -1)[:, None]
        c_log, c_cache = T.decode_step(cpu_params, cfg, tok, c_cache)
        g_log, g_cache = T.decode_step(gpu_params, cfg, tok.cuda(), g_cache)
    log(f"cross-device: smoke prefill + 8 decode steps, card vs CPU max "
        f"abs err {worst:.2e} (tolerance 1e-4)")
    return worst


def main() -> None:
    global _GEN
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    _GEN = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        checked = kernel_phase()
        bitwise_page_sizes = paged_bitwise_phase()

    cfg = get_config("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, device="cuda")
    serve = serve_phase(cfg, params, paged=False)
    paged = serve_phase(cfg, params, paged=True)
    serve["step"] = step_phase(cfg, params, paged=False)
    paged["step"] = step_phase(cfg, params, paged=True)
    n_bit = bit_identity_phase(cfg, params)
    n_paged_bit = paged_bit_identity_phase(cfg, params)
    cross = cross_device_phase()

    line = []
    for name, (rows, worst, total) in checked.items():
        _, _, source, replaces = KERNELS[name]
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # launches on the two main paths, dense and paged serving
            "launches": serve["launches"][name] + paged["launches"][name],
            "max_abs_err": worst, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "bytes" if total["bytes"] / PEAK_BYTES
            >= total["ops"] / PEAK_OPS[torch.bfloat16] else "operations",
            "library_ms": total["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "kernels": line,
        "cases": {n: rows for n, (rows, _, _) in checked.items()},
        "serve": serve, "paged_serve": paged,
        "paged_bitwise_page_sizes": bitwise_page_sizes,
        "bit_identity_requests": n_bit,
        "paged_bit_identity_requests": n_paged_bit,
        "cross_device_max_abs_err": cross,
        "build_seconds": _build.build_seconds,
        "seconds": time.perf_counter() - t_start}, indent=1))
    if _build.build_log:
        (out_dir / "ptxas.log").write_text(_build.build_log)
    log("kernel times are per decode step of 8 slots (flash_attention: "
        "per 300-token prefill), summed over the main paths' shapes; "
        "launches are summed over the dense and the paged serve runs")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
