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
   cache cold, as a layer of the real model does); the A-stationary
   gemm_tb (B6) runs at every GEMM shape of the serve path at the tile
   its 'tb' plan gives; each dense GEMM of qwen3-moe's served path (the
   decode step's, timed, a 300-token prefill's, timed, a paged chunk's
   and the last-token lm_head) runs on B1 or B6 as its HOPPER_H100 plan
   picks, at the plan's tile; the grouped gemm_grouped (B7) at
   qwen3-moe's expert GEMMs (a decode step's 64 routed rows and a 300-token
   prefill's 2400, beside ``torch._grouped_mm``; its plain version
   reads the group ends on the host and is timed from eager calls) and
   at edges with empty groups, a dropped tail and a straddled tile, each
   case naming its body and the CTA shape B7 picked; the
   attention kernels also at qwen3-moe's GQA group of 16 and head_dim
   of 128;
   each decode case names the split grid it launched (the split, the
   CTAs launched and live, the merge CTAs); then the paged decode kernel
   must equal the dense one bit for bit on one logical cache scattered
   into a permuted pool, at both models' heads, page sizes 8, 16, 32 and
   64, windows 0, 64 and 100, and pools as long as the cache or longer; gemm_tb must equal gemm_aie bit for bit at both models'
   dense serve shapes, in bf16 and f32, with each epilogue, at the 'tb'
   plan's tile and tiles giving one, two and four or more k-chunks; and
   every group's rows of each gemm_grouped case, at both of B7's CTA
   shapes, must equal gemm_aie on them, bit for bit (bf16: B1's
   tensor-core chain; f32: its fmaf body); B3's bf16 body must give a prompt's rows the bits of one
   whole-prompt call when they run in chunks of 7, 16 and 64 (q_offset =
   start) or one q head alone, at d 64 / 128 / 120 (window) / 20; B2's
   bf16 body with relu must equal relu(B1) * B1 bit for bit at m = 1, 8,
   9, 16 and 300, and its rows at m = 9, 16 and 300 those of its 300-row
   call; every B2 and B3 case names the body and CTA shape that ran;
3b. the int8 paths of B1, B2, B6 and B7 at both models' served shapes
   (smollm-360m's decode step and 300-token prefill, qwen3-moe's decode
   step, with B7's twelve decode and two prefill launches, and prefill):
   W8A16 on all four, W8A8 on B1 and B6, one out-quant case on B1 and on
   B6b, each held against its plain version and timed beside its byte
   or op bound, ``torch._int_mm`` x the scale (W8A8, where its shape
   rules allow) or the unfused dequantize + library call (W8A16); then
   their bitwise gates: W8A8 == plain, W8A16 == B1's bf16 body on
   q.to(bfloat16) then * scale, B6 == B1 on every int8 path, B7's int8
   rows == B1's W8A16 rows, and B2 on int8 weights == relu(B1) * B1;
4. the operator API: for each dense GEMM shape of both models' serve
   paths at m = 8 and m = 300 and for the 1024^3 GEMM, print the
   HOPPER_H100 plan's ``explain()`` and time the one-shot ``ops.gemm``
   with the planner's choice, with ``strategy="aie"`` and with
   ``strategy="tb"``, measured beside modeled;
5. serve smollm-360m at full width (bf16, random weights from seed 0)
   through ``DecodeEngine`` with 8 slots x 1024 positions, on the dense
   cache and then on the page pool (16-token pages, 64-token prefill
   chunks, prefix cache on, two requests sharing a 64-token prefix):
   each pass runs 193 planned GEMMs, and each kernel must have launched
   exactly as often as the executed plans (B1, B2, or B6's chunks) and
   the steps and prefill chunks say, the other decode kernel and every
   plain version not at all; each trace is then served again with
   telemetry on (``repro_torch.telemetry``; both artifacts exported to
   ``chiprun_out/telemetry_*``): one ``serve.request`` span a request,
   the decode bursts' steps summing to the engine's, the serve counters
   equal to its metrics and the greedy tokens equal to the untraced
   run's; then one 8-slot decode step of each cache is timed from
   CUDA-graph replays (device time alone) beside the same step run
   eagerly, which gives the device's idle share of an eager step, and
   eagerly again with telemetry on;
5b. model against measured: ``telemetry.report.model_vs_measured`` over
   the serve phases' dense plans (modeled us against us measured between
   device syncs; the table in ``chiprun_out/model_vs_measured_*.txt``);
5c. autotune: the dense trace once more untuned with every plan cached
   (the baseline), then with ``tune.enable(8)`` on a fresh tuning cache
   (a directory of the checkout, deleted at exit) twice (the first pass
   searches every GEMM it plans on the card), with
   launches equal to the executed plans (the tuner's samples are not
   executions), greedy tokens equal to the untuned run's bit for bit, no
   B1 / B6 candidate failing, and a second pass over the cache file
   measuring nothing; each tuned plan's analytic and measured winner,
   the flop budget's skips, and decode tok/s, the device step and TTFT
   beside the untuned run of the same call;
6. continuous-batched greedy == solo greedy on the dense cache, token
   for token, at full width (the acceptance trace); then paged greedy
   (2 slots, 16-token pages, 16-token chunks) == dense solo greedy on
   the acceptance trace plus a short and a 96-token prompt, and on two
   prompts sharing a prefix with the prefix cache on;
7. smollm-360m-smoke (f32): prefill + 8 decode steps on the card match
   the same port on the CPU within atol=rtol=1e-4, in f32, W8A16 and
   W8A8; then smollm-360m's weights are quantized to int8 and served
   again, W8A16 dense and paged and W8A8 dense (phase 5), with
   continuous == solo and paged == dense solo greedy in both modes;
7b. training: one AdamW step of smollm-360m-smoke (f32) from one state
   on the card and on the CPU, loss, grad norm, gradients, parameters and
   moments within 1e-4, the update over lr within 1e-2 where the
   gradient is clear of zero; then ``repro_torch.launch.train.train`` on
   smollm-360m at full width in bf16 (seq 512, global batch 8, AdamW, 4
   steps, seed 0): every step's loss and grad norm finite, every
   gradient leaf finite and non-zero at step 0, each step's launches
   equal to its executed plans (928 planned GEMMs a step, on B1, B2 and
   B6, and B3 twice a layer: forward and remat recompute) with B2, B3 and
   B6 in every step and no plain version; each step's wall and device
   ms, tokens/s, model-FLOP share and the peak memory printed with the
   card's name and power limit; the device time of the contiguous copies
   of the backward's transposed operands; then every distinct GEMM plan
   of one step, on the kernel and tile it picked, held to its plain
   version and timed beside ``torch.matmul``, and B3 at b 8 x s 512
   beside SDPA;
7c. resume: one smollm-360m step run twice from one state (its spread,
   0 when bit for bit, bounds the check); phase 7b's run checkpoints
   every 2 steps into a directory in the checkout; its step-4
   checkpoint is deleted and ``train(resume=True)`` resumes from step 2
   to 4: the resumed steps' losses and final parameters equal the
   unbroken run's within that spread; the directory is deleted; phase
   7b's run records telemetry: one ``train.step`` span a step within 5 %
   of the step's wall ms;
8. with smollm-360m freed, qwen3-moe-235b-a22b at full width with its
   depth cut to 4 layers (printed with the reason; random weights from
   seed 0): phases 5 and 6 again, dense and paged, every MoE layer
   launching B7 three times a pass and no plain version running; its
   paged greedy is held to paged solo greedy (chunked prefill sets the
   expert capacity by the chunk, so it may drop otherwise than a
   whole-prompt prefill), with the dense trace's telemetry run (the MoE
   counters' routed + dropped rows equal tokens x top-k over every MoE
   layer and pass), 5b and 5c (qwen3's 300 x 4096 x 8192 and 300 x 8192
   x 4096 named); then calibration: ``tune.calibrate.fit`` over the
   tuning cache's samples, ``apply`` for the card, every dense GEMM of
   both models' serve paths and of smollm-360m's training step
   re-planned (which change tile or strategy; f32 plans priced at the
   sheet's f32/bf16 ratio), and ``clear``; then its int8 copy (the bf16
   copy freed),
   served as smollm-360m's was, the experts staying W8A16 under W8A8;
9. MoE training: one Adafactor step of qwen3-moe-235b-a22b-smoke (f32)
   on the card against the CPU, as 7b (and whether two card steps agree
   bit for bit); then ``train`` on qwen3-moe-235b-a22b at full width with
   its depth cut to 1 layer (printed with the reason), bf16, Adafactor,
   b 8 x s 512, 3 steps: launches equal the executed plans, B7 10 times a
   layer-step (3 forward, 3 remat, the gate's f32 pre-activation
   recompute, 3 dA), no plain version, every gradient leaf finite and
   non-zero at step 0; wall and device ms, tokens/s, model-FLOP share,
   peak memory, the last step traced (device busy time by kernel
   family), and the gradients taken twice (deterministic or not); then
   B7 at that step's shapes and group sizes against its plain version,
   ``torch._grouped_mm`` and its bound, the transposed-bank copies, the
   plain dB, and the f32 router GEMMs on B1 / B6.

Prints a ``{"kernels": [...]}`` line (seven kernels; gemm_tb's launches
sum its two Pallas sites, listed under ``sites``; ``launches_by_path``
splits each count by model and mode; each entry's times sum the step
its ``timed_on`` names, a ``qwen3-moe-235b-a22b`` key holds the 4-layer
MoE step's, a ``train`` key the full-width training step's (B7's: the
MoE training layer-step's), a ``train qwen3-moe-235b-a22b`` key B1's and
B6's f32 router GEMMs of that step, and the
four GEMMs' ``int8`` objects hold their int8 cases, ``... tuned`` paths
the autotune phases' second serve runs,
step sums by mode and launches on the int8 paths) and the card line
before the last line, which is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import atexit
import collections
import dataclasses
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import ops, quant, telemetry, tune  # noqa: E402
from repro_torch.bridge import map_tree, to_device, tree_leaves  # noqa
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    DECODE_SPLIT, cta_shape as attn_cta_shape, decode_grid,
    decode_live_ctas, flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode, flash_decode_paged, flash_decode_paged_plain,
    flash_decode_plain)
from repro_torch.kernels.gemm_aie import gemm_aie, gemm_aie_plain  # noqa
from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels.gemm_gated import (  # noqa: E402
    cta_tile as gated_cta_tile, gemm_gated, gemm_gated_plain)
from repro_torch.kernels.gemm_grouped import (  # noqa: E402
    cta_tile as grouped_cta_tile, gemm_grouped, gemm_grouped_plain,
    group_metadata, steering_tables)
from repro_torch.kernels.gemm_tb import gemm_tb, gemm_tb_plain  # noqa
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.core import bandwidth  # noqa: E402
from repro_torch.core.hardware import HOPPER_H100  # noqa: E402
from repro_torch.telemetry import report as treport  # noqa: E402
from repro_torch.tune import autotune, calibrate  # noqa: E402
from repro_torch.tune import measure as tune_measure  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
import train_profile  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    ACCEPTANCE_TRACE, DecodeEngine, Request, acceptance_requests,
    solo_greedy)

# H100 SXM datasheet peaks: HBM bytes/s and
# dense operations/s by operand type (bf16 and int8 tensor cores; f32
# outside them)
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
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
    "gemm_tb": (gemm_tb, gemm_tb_plain, "src/repro_torch/csrc/gemm_tb.cu",
                "src/repro/kernels/gemm_tb.py:96"),
    "gemm_grouped": (gemm_grouped, gemm_grouped_plain,
                     "src/repro_torch/csrc/gemm_grouped.cu",
                     "src/repro/kernels/gemm_grouped.py:196"),
}
#: B6's second Pallas site, the final k-chunk, and its launch counter
GEMM_TB_FINAL_SITE = "src/repro/kernels/gemm_tb.py:139"
#: the shape set each kernel's times in the kernels line sum over
TIMED_ON = {
    "gemm_aie": "smollm-360m: one 8-slot decode step",
    "gemm_tb": "smollm-360m: one 8-slot decode step's non-gated GEMMs, "
               "the shape set of gemm_aie",
    "gemm_gated": "smollm-360m: one 8-slot decode step",
    "flash_attention": "smollm-360m: one 300-token prefill",
    "flash_decode": "smollm-360m: one 8-slot decode step",
    "flash_decode_paged": "smollm-360m: one 8-slot decode step",
    "gemm_grouped": "qwen3-moe-235b-a22b at 4 layers: one 8-slot decode "
                    "step",
}
#: the same for one full-width smollm-360m training step, under "train"
TRAIN_TIMED_ON = {
    "gemm_aie": "smollm-360m training: one step's GEMMs (b 8 x s 512, "
                "forward, remat recompute and backward) that the "
                "HOPPER_H100 planner gives this kernel",
    "gemm_tb": "smollm-360m training: one step's GEMMs that the "
               "HOPPER_H100 planner gives this kernel",
    "gemm_gated": "smollm-360m training: one step's gated GEMMs (forward "
                  "and remat recompute)",
    "flash_attention": "smollm-360m training: one step's 64 launches "
                       "(b 8 x s 512, forward and remat recompute)",
}
#: the same for qwen3-moe-235b-a22b at 4 layers, under its own key
MOE_TIMED_ON = {
    "gemm_aie": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
                "planner gives this kernel",
    "gemm_tb": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
               "planner gives this kernel",
    "flash_attention": "one 300-token prefill",
    "flash_decode": "one 8-slot decode step",
    "flash_decode_paged": "one 8-slot decode step",
}
#: the same for qwen3-moe-235b-a22b's full-width 1-layer training step
MOE_TRAIN_TIMED_ON = {
    "gemm_grouped": "qwen3-moe-235b-a22b training at 1 layer: one "
                    "layer-step's 10 launches (b 8 x s 512, 32768 routed "
                    "rows: the three forwards twice, the gate's f32 "
                    "pre-activation recompute, the three dA on contiguous "
                    "transposed banks)",
    "gemm_aie": "qwen3-moe-235b-a22b training at 1 layer: the step's f32 "
                "router GEMMs (forward, recompute, dA, dB) the HOPPER_H100 "
                "planner gives this kernel",
    "gemm_tb": "qwen3-moe-235b-a22b training at 1 layer: the step's f32 "
               "router GEMMs the HOPPER_H100 planner gives this kernel",
}
#: qwen3-moe-235b-a22b is served at full width with its depth cut to this
#: many layers: 94 layers of bf16 weights (about 470 GB) do not fit one
#: 80 GB card, 4 (about 22.4 GB) do
MOE_LAYERS = 4


def gemms_per_pass(cfg) -> int:
    """The planned GEMMs of one decode step, prefill or prefill chunk: q,
    k, v, o a layer, then gate/up and down (an attn layer) or the router
    and three grouped expert GEMMs (a moe layer), and the lm_head."""
    per_kind = {"attn": 6, "moe": 8}
    return sum(per_kind[k] for k in cfg.layer_pattern) * cfg.repeats + 1


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _public(value):
    """``value`` without the dict keys that start with ``_`` (tokens and
    plan objects a phase hands to a later one), for the JSON."""
    if isinstance(value, dict):
        return {k: _public(v) for k, v in value.items()
                if not (isinstance(k, str) and k.startswith("_"))}
    if isinstance(value, (list, tuple)):
        return [_public(v) for v in value]
    return value


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


def tb_tile(m, k, n, dtype, *, residual=False, bias=False, act=None,
            out_dtype=None):
    """The tile HOPPER_H100's planner gives a 'tb' GEMM of this shape."""
    ep = ops.Epilogue(bias=bias, activation=act, residual=residual)
    spec = ops.GemmSpec(a_dtype=dtype, b_dtype=dtype, epilogue=ep,
                        out_dtype=out_dtype, strategy="tb")
    return ops.plan(spec, (m, k, n)).tile


def gemm_case(name, weight, m, k, n, dtype, *, residual=False, bias=False,
              act=None, out_dtype=None, tb=False, tile=None, **extra):
    """A GEMM case for B1 or, ``tb``, for B6 at ``tile`` or else the tile
    its 'tb' plan gives the shape; ``extra`` keys go into the case."""
    out_dtype = out_dtype or dtype
    if tb and tile is None:
        tile = tb_tile(m, k, n, dtype, residual=residual, bias=bias,
                       act=act, out_dtype=out_dtype)

    def make():
        kw = {"out_dtype": out_dtype}
        if tile is not None:
            kw["tile"] = tile
        if residual:
            kw["residual"] = rand((m, n), dtype)
        if bias:
            kw["bias"] = rand((n,), torch.float32)
        if act:
            kw["activation"] = act
        return (rand((m, k), dtype), rand((k, n), dtype, k ** -0.5)), kw

    def library(a, b, out_dtype, residual=None, bias=None, activation=None,
                tile=None):
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
    if tile is not None:
        name += f" tile {tile.bm}x{tile.bk}x{tile.bn}"
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=library, cost=cost, **extra)


def moe_gemm_cases():
    """B1 or B6, as the HOPPER_H100 planner picks, at each dense GEMM of
    qwen3-moe-235b-a22b's served path and at its plan's tile: a decode
    step of 8 slots (timed; ``moe_weight`` = launches in one step of the
    4-layer model), a 300-token prefill (timed), a 64-token paged chunk
    and the prefill's last-token lm_head.  Returns {kernel: [cases]}."""
    bf, f32 = torch.bfloat16, torch.float32
    d, q, kv, e, V = 4096, 8192, 512, 128, 151936
    n_l = MOE_LAYERS
    shapes = []
    for m, per_step, tag in ((8, 1, "decode"), (300, 0, "prefill"),
                             (64, 0, "chunk")):
        shapes += [(f"{tag} wq {m}x{d}x{q}", per_step * n_l, m, d, q, bf,
                    {}),
                   (f"{tag} wk/wv {m}x{d}x{kv}", per_step * 2 * n_l, m, d,
                    kv, bf, {}),
                   (f"{tag} wo+res {m}x{q}x{d}", per_step * n_l, m, q, d,
                    bf, {"residual": True}),
                   (f"{tag} router f32 {m}x{d}x{e}", per_step * n_l, m, d,
                    e, f32, {})]
    shapes += [(f"decode lm_head 8x{d}x{V}", 1, 8, d, V, bf,
                {"out_dtype": f32}),
               (f"prefill lm_head 1x{d}x{V}", 0, 1, d, V, bf,
                {"out_dtype": f32})]
    out = {"gemm_aie": [], "gemm_tb": []}
    for name, per_step, m, k, n, dtype, kw in shapes:
        out_dtype = kw.get("out_dtype", dtype)
        spec = ops.GemmSpec(a_dtype=dtype, b_dtype=dtype, out_dtype=out_dtype,
                            epilogue=ops.Epilogue(
                                residual=kw.get("residual", False)))
        tile = ops.plan(spec, (m, k, n)).tile
        tb = tile.strategy == "tb"
        out["gemm_tb" if tb else "gemm_aie"].append(gemm_case(
            "qwen3 " + name, 0, m, k, n, dtype, tb=tb,
            tile=tile if tb else None, moe_weight=per_step,
            timed=per_step > 0 or m == 300, **kw))
    return out


def gated_case(name, weight, m, k, n, dtype, **extra):
    def make():
        return (rand((m, k), dtype), rand((k, n), dtype, k ** -0.5),
                rand((k, n), dtype, k ** -0.5)), {}

    def library(a, bg, bu):
        return F.silu(torch.matmul(a, bg)) * torch.matmul(a, bu)

    def cost(args, kw):
        a, bg, bu = args
        return nbytes(a, bg, bu, a.new_empty((m, n))), 4.0 * m * n * k
    bm, bk, bn = gated_cta_tile(m, n, dtype)
    body = "tensor cores" if dtype == torch.bfloat16 else "fmaf"
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=library, cost=cost,
                body=f"{body}, CTA tile {bm}x{bk}x{bn}", **extra)


def attn_case(name, weight, b, s, hq, hkv, d, dtype, *, skv=None,
              causal=True, window=0, **extra):
    """B3 on q (b, s, hq, d) against ``skv`` keys (default s; the
    q_offset is skv - s); the library yardstick is SDPA where one call
    computes the function (causal or not, no window, skv == s)."""
    skv = skv or s

    def make():
        return (rand((b, s, hq, d), dtype), rand((b, skv, hkv, d), dtype),
                rand((b, skv, hkv, d), dtype)), \
            {"causal": causal, "window": window}

    def library(q, k, v, causal, window):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)

    def cost(args, kw):
        q, k, v = args
        pairs = b * s * (s + 1) / 2                 # causal (q, k) pairs
        return nbytes(q, k, v, q), 4.0 * hq * d * pairs
    shape = attn_cta_shape(b, s, hq, hkv, d, dtype)
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=library if skv == s and not window else None,
                cost=cost, body=f"{shape.body}, {shape.rows} rows x "
                f"{shape.ctas} CTAs, head padded to {shape.head_dim}",
                **extra)


def decode_body(pos, length, hq, hkv, d, dtype, window=0):
    """The grid B4 or B5 launches for these slots: the split, the CTAs
    launched and those with a live block, and the merge CTAs."""
    g = decode_grid(len(pos), hq, hkv, length, d, dtype)
    if g.body == "fmaf":
        return f"fmaf, {g.ctas} CTAs, one per (kv head, slot)"
    live = decode_live_ctas(pos, length, window, hkv)
    return (f"tensor cores, split {DECODE_SPLIT} keys (one warp), "
            f"{g.ctas} CTAs launched, {live} live, {g.merge_ctas} merge "
            f"CTAs, head padded to {g.head_dim}")


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
                library=library, cost=cost,
                body=decode_body(pos, S, hq, hkv, d, dtype))


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
                library=None, two_calls=gather_sdpa, cost=cost,
                body=decode_body(pos, S, hq, hkv, d, dtype, window))


def routed_sizes(tokens, n_experts, top_k, cap, seed):
    """Group sizes of ``tokens`` routed top-k over the experts uniformly
    at random, each clipped to the capacity ``cap`` (the rows past the
    groups are the dropped tail)."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(n_experts, np.int64)
    for _ in range(tokens):
        counts[rng.choice(n_experts, top_k, replace=False)] += 1
    return np.minimum(counts, cap)


def grouped_case(name, weight, sizes, m, k, n, dtype, *, act=None,
                 bias=False, timed=False, out_dtype=None, tol=None):
    """A case for B7 at the CTA shape it picks for m rows over the
    experts; ``sizes`` are the group sizes, ``m`` >= their sum the
    rows; the output is ``out_dtype`` (default A's ``dtype``); ``tol``
    (atol = rtol) overrides the one A's dtype gives."""
    sizes = np.asarray(sizes, np.int64)
    e = len(sizes)
    out_dtype = out_dtype or dtype

    def make():
        kw = {"out_dtype": out_dtype}
        if act:
            kw["activation"] = act
        if bias:
            kw["bias"] = rand((e, n), torch.float32)
        gs = torch.as_tensor(sizes.astype(np.int32), device="cuda")
        return (rand((m, k), dtype), rand((e, k, n), dtype, k ** -0.5),
                gs), kw

    def library(a, b, gs, out_dtype, activation=None, bias=None):
        """torch._grouped_mm over the group ends (one call), then the
        activation; the rows past the groups are not its business."""
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        x = torch._grouped_mm(a, b, offs=offs)
        if activation == "silu":
            x = F.silu(x)
        return x.to(out_dtype)

    def cost(args, kw):
        """Bytes: the live experts' banks, A and C (and their biases);
        operations: the routed rows' products."""
        a, b, _ = args
        es = a.element_size()
        live = int((sizes > 0).sum())
        byts = (live * k * n + m * k) * es \
            + m * n * torch.finfo(out_dtype).bits // 8 \
            + (live * n * 4 if bias else 0)
        return byts, 2.0 * float(sizes.sum()) * k * n
    bm, bk, bn = grouped_cta_tile(m, e, dtype)
    body = "tensor cores" if dtype == torch.bfloat16 else "fmaf"
    return dict(name=name, weight=weight, moe_weight=weight, dtype=dtype,
                make=make, library=library, cost=cost,
                timed=timed or weight > 0, plain_eager=True,
                body=f"{body}, CTA tile {bm}x{bk}x{bn}",
                **({"tol": tol} if tol is not None else {}))


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


def eager_ms(fn, inputs) -> float:
    """Mean device-timeline time of one eager call (CUDA events around
    REPS calls over the input sets), for a function that reads values on
    the host and so cannot be captured in a CUDA graph."""
    for args, kw in inputs[:2]:
        fn(*args, **kw)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(REPS):
        args, kw = inputs[i % len(inputs)]
        fn(*args, **kw)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / REPS


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
        tol = case.get("tol", TOL.get(case["dtype"]))
        bad = err > tol + tol * want.float().abs()
        if bad.any():
            raise RuntimeError(
                f"{name} {case['name']}: {int(bad.sum())} elements off, "
                f"max abs err {err.max().item():.3e}")
        row = {"case": case["name"], "weight": case["weight"],
               "moe_weight": case.get("moe_weight", 0),
               "max_abs_err": err.max().item()}
        if "body" in case:
            row["body"] = case["body"]
        worst = max(worst, row["max_abs_err"])
        if case.get("timed", case["weight"] > 0):
            per = nbytes(*args, *(v for v in kw.values()
                                  if isinstance(v, torch.Tensor)))
            copies = max(1, min(64, math.ceil(COLD_BYTES / per)))
            inputs = [first] + [case["make"]() for _ in range(copies - 1)]
            b, ops = case["cost"](args, kw)
            peak = case.get("peak_ops", PEAK_OPS.get(case["dtype"]))
            if "two_calls" in case:
                row["gather_sdpa_ms"] = device_ms(case["two_calls"], inputs)
            if "dequant" in case:
                row["dequant_ms"] = device_ms(case["dequant"], inputs)
            library = case["library"]
            row.update(
                ms=device_ms(kernel, inputs),
                plain_ms=(eager_ms if case.get("plain_eager")
                          else device_ms)(plain, inputs),
                library_ms=device_ms(library, inputs) if library else None,
                bytes=b, ops=ops,
                bound_ms=max(b / PEAK_BYTES, ops / peak) * 1e3,
                bound_by="bytes" if b / PEAK_BYTES >= ops / peak
                else "operations")
            del inputs
        rows.append(row)
        lib = row.get("library_ms")
        log(f"  {name:18s} {case['name']:38s} err {row['max_abs_err']:.2e}"
            + (f"  kernel {row['ms']*1e3:8.1f} us  plain "
               f"{row['plain_ms']*1e3:8.1f} us  library "
               + (f"{lib*1e3:8.1f} us" if lib is not None else "       —")
               + f"  bound {row['bound_ms']*1e3:7.1f} us ({row['bound_by']})"
               + (f"  gather+sdpa (2 calls) "
                  f"{row['gather_sdpa_ms']*1e3:.1f} us"
                  if "gather_sdpa_ms" in row else "")
               + (f"  dequant+library {row['dequant_ms']*1e3:.1f} us"
                  if "dequant_ms" in row else "")
               if "ms" in row else "  (edge shape, not timed)")
            + (f"  [{row['body']}]" if "body" in row else ""))
    return rows, worst, weighted(rows, "weight"), weighted(rows, "moe_weight")


def weighted(rows, weight):
    """The timed rows' times, bytes and operations, each row counted
    ``row[weight]`` times (its launches in one step); None if no row
    has that weight."""
    timed = [r for r in rows if "ms" in r and r[weight]]
    if not timed:
        return None
    total = {key: sum(r[weight] * r[key] for r in timed)
             for key in ("ms", "plain_ms", "bound_ms", "bytes", "ops")}
    libs = [r["library_ms"] for r in timed]
    total["library_ms"] = None if None in libs else \
        sum(r[weight] * r["library_ms"] for r in timed)
    if all("dequant_ms" in r for r in timed):
        total["dequant_ms"] = sum(r[weight] * r["dequant_ms"] for r in timed)
    by_bytes = sum(r[weight] * r["bound_ms"] for r in timed
                   if r["bound_by"] == "bytes")
    total["bound_by"] = "bytes" if 2 * by_bytes >= total["bound_ms"] \
        else "operations"
    return total


def kernel_phase():
    bf, f32 = torch.bfloat16, torch.float32
    d, hq, hkv, ff, V = 960, 15, 5, 2560, 49152
    pos = [17, 40, 95, 160, 210, 300, 333, 363]
    moe_gemms = moe_gemm_cases()
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
            # 9..16 rows: B1's 16-row fragment with every row staged (at
            # most 8 rows stage 8 and zero the rest), as the serve paths'
            # 9- to 16-token prompts run wq/wo (and qwen3's wk/wv/wo)
            gemm_case("prefill wq 9x960x960", 0, 9, d, d, bf),
            gemm_case("prefill wq 12x960x960", 0, 12, d, d, bf),
            gemm_case("prefill wo+res 16x960x960", 0, 16, d, d, bf,
                      residual=True),
            gemm_case("qwen3 prefill wk/wv 12x4096x512", 0, 12, 4096, 512,
                      bf),
            gemm_case("qwen3 prefill wo+res 16x8192x4096", 0, 16, 8192,
                      4096, bf, residual=True),
            gemm_case("edge f32 3x60x49152 bias+silu+res", 0, 3, 60, V, f32,
                      residual=True, bias=True, act="silu"),
            gemm_case("edge 5x131x77 k % 16 != 0", 0, 5, 131, 77, bf),
            # qwen3-moe's 300-token prefill GEMMs, which its plans give
            # B6: timed on B1 too, so the two dataflows compare there
            gemm_case("qwen3 prefill wq 300x4096x8192", 0, 300, 4096, 8192,
                      bf, timed=True),
            gemm_case("qwen3 prefill wk/wv 300x4096x512", 0, 300, 4096, 512,
                      bf, timed=True),
            gemm_case("qwen3 prefill wo+res 300x8192x4096", 0, 300, 8192,
                      4096, bf, residual=True, timed=True),
        ] + moe_gemms["gemm_aie"],
        # weights: the decode step's non-gated GEMMs, as for gemm_aie, so
        # the two dataflows' sums compare on one shape set
        "gemm_tb": [
            gemm_case("decode wq 8x960x960", 32, 8, d, d, bf, tb=True),
            gemm_case("decode wk/wv 8x960x320", 64, 8, d, 320, bf, tb=True),
            gemm_case("decode wo+res 8x960x960", 32, 8, d, d, bf,
                      residual=True, tb=True),
            gemm_case("decode down+res 8x2560x960", 32, 8, ff, d, bf,
                      residual=True, tb=True),
            gemm_case("decode lm_head 8x960x49152", 1, 8, d, V, bf,
                      out_dtype=f32, tb=True),
            gemm_case("prefill wq 300x960x960", 0, 300, d, d, bf, tb=True),
            gemm_case("prefill wk/wv 300x960x320", 0, 300, d, 320, bf,
                      tb=True),
            gemm_case("prefill wo+res 300x960x960", 0, 300, d, d, bf,
                      residual=True, tb=True),
            gemm_case("prefill down+res 300x2560x960", 0, 300, ff, d, bf,
                      residual=True, tb=True),
            gemm_case("edge f32 37x200x131 bias+silu+res", 0, 37, 200, 131,
                      f32, residual=True, bias=True, act="silu", tb=True),
        ] + moe_gemms["gemm_tb"],
        "gemm_gated": [
            gated_case("decode gate/up 8x960x2560", 32, 8, d, ff, bf),
            # a 300-token prefill, timed beside silu(a@bg)*(a@bu)
            gated_case("prefill gate/up 300x960x2560", 0, 300, d, ff, bf,
                       timed=True),
            # 1, 9..16 rows: the 16-row fragment at 8 and at 16 rows staged
            gated_case("prefill gate/up 1x960x2560", 0, 1, d, ff, bf),
            gated_case("prefill gate/up 9x960x2560", 0, 9, d, ff, bf),
            gated_case("prefill gate/up 16x960x2560", 0, 16, d, ff, bf),
            gated_case("edge 7x131x77 k % 16 != 0", 0, 7, 131, 77, bf),
            gated_case("edge 37x200x131 ragged 64x64", 0, 37, 200, 131, bf),
            gated_case("edge f32 3x60x160", 0, 3, 60, 160, f32),
        ],
        "flash_attention": [
            # weights = launches in one 300-token prefill
            attn_case("prefill 1x300 h15/5 d64", 32, 1, 300, hq, hkv, 64,
                      bf),
            attn_case("prefill 1x12 h15/5 d64", 0, 1, 12, hq, hkv, 64, bf),
            attn_case("prefill 1x160 h15/5 d64", 0, 1, 160, hq, hkv, 64, bf),
            attn_case("edge f32 2x45 h3/1 d20", 0, 2, 45, 3, 1, 20, f32),
            # the bf16 body's edges: the smoke config's d 20, h2o-danube's
            # d 120 with a window and a q_offset, kimi's d 112, non-causal
            attn_case("edge 2x45 h3/1 d20", 0, 2, 45, 3, 1, 20, bf),
            attn_case("edge 64x96 h4/2 d120 window 32 q_offset 32", 0, 1,
                      64, 4, 2, 120, bf, skv=96, window=32),
            attn_case("edge 70 h6/3 d112", 0, 1, 70, 6, 3, 112, bf),
            attn_case("edge non-causal 1x40 h2/2 d64", 0, 1, 40, 2, 2, 64,
                      bf, causal=False),
            attn_case("edge 33x100 h16/1 d128 q_offset 67", 0, 1, 33, 16, 1,
                      128, bf, skv=100),
            # qwen3-moe: GQA group 16 (the kernels' MAX_GROUP) and head_dim
            # 128 (MAX_HEAD_DIM), reached for the first time; moe_weight =
            # launches in one prefill / decode step of the 4-layer model
            dict(attn_case("qwen3 prefill 1x300 h64/4 d128", 0, 1, 300, 64,
                           4, 128, bf), timed=True, moe_weight=MOE_LAYERS),
        ],
        "flash_decode": [
            decode_case("decode 8 slots S1024 h15/5 d64", 32, pos, 1024,
                        hq, hkv, 64, bf),
            decode_case("edge f32 3 slots S50 h3/1 d20", 0, [0, 17, 49],
                        50, 3, 1, 20, f32),
            dict(decode_case("qwen3 decode 8 slots S1024 h64/4 d128", 0, pos,
                             1024, 64, 4, 128, bf), timed=True,
                 moe_weight=MOE_LAYERS),
        ],
        "flash_decode_paged": [
            paged_case("decode 8 slots 64x16 h15/5 d64", 32, pos, 16, 64,
                       hq, hkv, 64, bf),
            paged_case("edge f32 4 slots 7x8 h3/1 d20 w20", 0,
                       [0, 17, 55, 70], 8, 7, 3, 1, 20, f32, window=20,
                       sink_row=2),
            dict(paged_case("qwen3 decode 8 slots 64x16 h64/4 d128", 0, pos,
                            16, 64, 64, 4, 128, bf), timed=True,
                 moe_weight=MOE_LAYERS),
        ],
        # weights = launches in one decode step of the 4-layer MoE
        "gemm_grouped": grouped_cases(),
    }
    return {name: check_kernel(name, cases) for name, cases in plan.items()}


def grouped_cases():
    """B7 at qwen3-moe-235b-a22b's expert GEMMs (d 4096, d_ff 1536, 128
    experts, top-8): a decode step of 8 slots (64 routed rows over the
    experts 8 tokens pick) and a 300-token prefill (2400 rows, capacity
    24, so a full expert drops its overflow into the tail), both timed;
    then untimed edges: empty groups at the ends and in the middle, a
    dropped tail, and a tile straddled by several groups."""
    bf, f32 = torch.bfloat16, torch.float32
    d, ff, e = 4096, 1536, 128
    dec = routed_sizes(8, e, 8, 8, seed=21)
    pre = routed_sizes(300, e, 8, 24, seed=22)
    return [
        grouped_case("decode gate+silu 64x4096x1536", MOE_LAYERS, dec, 64,
                     d, ff, bf, act="silu"),
        grouped_case("decode up 64x4096x1536", MOE_LAYERS, dec, 64, d, ff,
                     bf),
        grouped_case("decode down 64x1536x4096", MOE_LAYERS, dec, 64, ff, d,
                     bf),
        grouped_case("prefill gate+silu 2400x4096x1536", 0, pre, 2400, d,
                     ff, bf, act="silu", timed=True),
        grouped_case("prefill down 2400x1536x4096", 0, pre, 2400, ff, d, bf,
                     timed=True),
        grouped_case("edge f32 empty groups bias+silu", 0,
                     [0, 0, 37, 0, 20, 0, 0], 57, 100, 70, f32, act="silu",
                     bias=True),
        grouped_case("edge bf16 dropped tail", 0, [5, 9, 0, 4], 30, 256, 192,
                     bf),
        grouped_case("edge f32 straddled tile", 0, [3, 2, 1, 1, 4, 2, 50], 63,
                     300, 200, f32),
    ]


def paged_bitwise_phase():
    """B5 == B4, bit for bit: one logical bf16 cache of 8 slots x 1024
    positions, dense and scattered into a permuted pool, at smollm-360m's
    heads (15/5, d 64) and qwen3-moe's (64/4, d 128), page sizes 8, 16,
    32 and 64, windows 0, 64 and 100, with the table as long as the dense
    cache or longer (1280 keys; there the slot past the dense cache's
    end, pos 1500, sees the pool's extra keys and is left out)."""
    b, S = 8, 1024
    pos = torch.as_tensor([17, 40, 95, 160, 210, 300, 1023, 1500],
                          dtype=torch.int32, device="cuda")
    checked = 0
    for hq, hkv, d in ((15, 5, 64), (64, 4, 128)):
        q = rand((b, hq, d), torch.bfloat16)
        k = rand((b, S, hkv, d), torch.bfloat16)
        v = rand((b, S, hkv, d), torch.bfloat16)
        for ps in (8, 16, 32, 64):
            for pool_len in (S, 1280):
                max_pages, dense_pages = pool_len // ps, S // ps
                n_pages = 1 + b * max_pages
                perm = torch.randperm(n_pages - 1, generator=_GEN,
                                      device="cuda")
                table = (perm + 1).reshape(b, max_pages).to(torch.int32)
                k_pages = rand((n_pages, ps, hkv, d), torch.bfloat16)
                v_pages = rand((n_pages, ps, hkv, d), torch.bfloat16)
                rows = table[:, :dense_pages].long()
                k_pages[rows] = k.reshape(b, dense_pages, ps, hkv, d)
                v_pages[rows] = v.reshape(b, dense_pages, ps, hkv, d)
                keep = b if pool_len == S else b - 1
                for window in (0, 64, 100):
                    got = flash_decode_paged(q, k_pages, v_pages, table, pos,
                                             window=window)
                    want = flash_decode(q, k, v, pos, window=window)
                    torch.cuda.synchronize()
                    if not torch.equal(got[:keep], want[:keep]):
                        raise RuntimeError(
                            f"flash_decode_paged != flash_decode at heads "
                            f"{hq}/{hkv} d {d}, page size {ps}, pool "
                            f"{pool_len} keys, window {window}")
                    checked += 1
    log(f"paged == dense decode, bit for bit, in {checked} cases: heads "
        "15/5 d64 and 64/4 d128, page sizes 8/16/32/64, pools of 1024 and "
        "1280 keys against a 1024-key cache, windows 0/64/100")
    return {"cases": checked, "page_sizes": [8, 16, 32, 64],
            "windows": [0, 64, 100], "pool_keys": [S, 1280],
            "heads": ["15/5 d64", "64/4 d128"]}


def tb_bitwise_phase():
    """B6 == B1, bit for bit: at every dense GEMM shape of both models'
    serve paths (smollm-360m and qwen3-moe-235b-a22b: decode m = 8, a
    300-token prefill, 12- and 16-token prompts, qwen3's 64-token paged
    chunk and last-token lm_head) and an f32 edge shape, in bf16 and f32, with each epilogue,
    at the tile HOPPER_H100's 'tb' plan gives the shape and three tiles
    that give one k-chunk, two, and four or more."""
    d, ff, V = 960, 2560, 49152
    qd, qq, qkv, qe, qV = 4096, 8192, 512, 128, 151936
    shapes = [(8, d, d), (8, d, 320), (8, ff, d), (8, d, V), (300, d, d),
              (300, d, 320), (300, ff, d), (37, 200, 131)]
    for m in (8, 300, 64):
        shapes += [(m, qd, qq), (m, qd, qkv), (m, qq, qd), (m, qd, qe)]
    shapes += [(12, d, 320), (16, d, d), (12, qd, qkv), (16, qq, qd)]
    shapes += [(8, qd, qV), (1, qd, qV)]
    epilogues = [{}, {"residual": True}, {"bias": True, "act": "gelu"},
                 {"bias": True, "act": "silu", "residual": True},
                 {"out_dtype": torch.float32}]
    checked, chunk_counts = 0, set()
    for m, k, n in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            a = rand((m, k), dtype, k ** -0.5)
            b = rand((k, n), dtype)
            res = rand((m, n), dtype)
            bias = rand((n,), torch.float32)
            half = -(-k // 2 // 32) * 32
            pt = tb_tile(m, k, n, dtype)
            tiles = [(pt.bm, pt.bk, pt.bn), (8, 4096, 16), (16, half, 32),
                     (8, 128, 64)]
            for ep in epilogues:
                kw = {"out_dtype": ep.get("out_dtype", dtype)}
                if ep.get("residual"):
                    kw["residual"] = res
                if ep.get("bias"):
                    kw["bias"] = bias
                if ep.get("act"):
                    kw["activation"] = ep["act"]
                want = gemm_aie(a, b, **kw)
                for tile in tiles:
                    t = ops.TileConfig(*tile, "tb")
                    got = gemm_tb(a, b, tile=t, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise RuntimeError(
                            f"gemm_tb != gemm_aie at {m}x{k}x{n} {dtype} "
                            f"{ep} tile {tile}")
                    pl = ops.plan(ops.GemmSpec(
                        a_dtype=dtype, b_dtype=dtype, tile=t,
                        epilogue=ops.Epilogue(
                            bias=bool(ep.get("bias")),
                            activation=ep.get("act"),
                            residual=bool(ep.get("residual"))),
                        out_dtype=kw["out_dtype"]), (m, k, n))
                    chunk_counts.add(-(-k // pl.chunk_bk))
                    checked += 1
            del a, b, res
    if not {1, 2} <= chunk_counts or max(chunk_counts) < 4:
        raise RuntimeError(f"tb bitwise: chunk counts {chunk_counts}")
    log(f"gemm_tb == gemm_aie, bit for bit: {checked} cases ({len(shapes)} "
        f"shapes x bf16/f32 x {len(epilogues)} epilogues x 4 tiles; "
        f"k-chunk counts {sorted(chunk_counts)})")
    return {"cases": checked, "chunk_counts": sorted(chunk_counts)}


def grouped_bitwise_phase():
    """B7 == B1 on every group's rows, bit for bit: in each B7 case, at
    both of its CTA shapes (the decode and the prefill one, of which the
    case launches one), row block ``g`` of the grouped GEMM equals
    gemm_aie of those rows against expert ``g``'s weights with the same
    epilogue, on the same operands: a bf16 row B1's tensor-core chain,
    an f32 row B1's fmaf body.  Rows past the groups are zero.  The
    steering tables the card builds (one launch of B7's table kernel)
    equal group_metadata's on the CPU at both shapes' m tiles."""
    checked = 0
    for case in grouped_cases():
        (a, b, gs), kw = case["make"]()
        sizes = gs.tolist()
        for bm in {grouped_cta_tile(1, 1, a.dtype)[0],
                   grouped_cta_tile(2, 1, a.dtype)[0]}:
            got = steering_tables(gs, a.shape[0], bm)
            want = group_metadata(gs.cpu(), a.shape[0], bm)
            for x, y in zip((*got[0], got[1]), (*want[0], want[1])):
                if not torch.equal(x.cpu(), y):
                    raise RuntimeError(f"steering tables != group_metadata "
                                       f"for {case['name']} at bm {bm}")
        for cta in (1, 2):
            got = gemm_grouped(a, b, gs, cta=cta, **kw)
            start = 0
            for g, size in enumerate(sizes):
                if size:
                    want = gemm_aie(
                        a[start:start + size], b[g],
                        bias=kw["bias"][g] if "bias" in kw else None,
                        activation=kw.get("activation"),
                        out_dtype=kw["out_dtype"])
                    if not torch.equal(got[start:start + size], want):
                        raise RuntimeError(
                            f"gemm_grouped != gemm_aie on group {g} of "
                            f"{case['name']} at CTA shape {cta}")
                    checked += 1
                start += size
            if got[start:].any():
                raise RuntimeError(f"gemm_grouped: rows past the groups of "
                                   f"{case['name']} are not zero")
        del a, b
    log(f"gemm_grouped == gemm_aie (bf16: the tensor-core chain; f32: the "
        f"fmaf body), bit for bit: {checked} groups over the B7 cases at "
        "both CTA shapes each; rows past the groups zero; the card's "
        "steering tables == group_metadata's")
    return checked


def redesign_bitwise_phase():
    """The bitwise gates of B3's and B2's bf16 tensor-core bodies.

    (a) B3 q-split invariance: a prompt's full prefill equals, bit for
    bit, its rows computed in chunks of 7, 16 and 64 with q_offset =
    start against the key prefix, and one q head's rows computed alone
    against its kv head, at smollm-360m's d 64 / group 3, qwen3-moe's d
    128 / group 16, d 120 with window 32 and the smoke config's d 20;
    (b) gemm_gated(relu, f32 out) == relu(gemm_aie) * gemm_aie on
    smollm-360m's 960 x 2560 at m = 1, 8, 9, 16 and 300; (c) B2's rows at
    m = 9, 16 and 300 equal its 300-row call."""
    bf, f32 = torch.bfloat16, torch.float32
    attn = []
    for s, hq, hkv, d, window in ((300, 15, 5, 64, 0), (300, 64, 4, 128, 0),
                                  (200, 8, 2, 120, 32), (90, 3, 1, 20, 0)):
        q = rand((1, s, hq, d), bf)
        k = rand((1, s, hkv, d), bf)
        v = rand((1, s, hkv, d), bf)
        full = flash_attention(q, k, v, window=window)
        for chunk in (7, 16, 64):
            got = torch.cat([
                flash_attention(q[:, a:a + chunk], k[:, :a + chunk],
                                v[:, :a + chunk], window=window, q_offset=a)
                for a in range(0, s, chunk)], dim=1)
            torch.cuda.synchronize()
            if not torch.equal(got, full):
                raise RuntimeError(f"flash_attention: chunks of {chunk} != "
                                   f"the whole prompt at s {s} h{hq}/{hkv} "
                                   f"d{d} window {window}")
        group = hq // hkv
        for h in (0, hq // 2, hq - 1):
            solo = flash_attention(q[:, :, h:h + 1],
                                   k[:, :, h // group:h // group + 1],
                                   v[:, :, h // group:h // group + 1],
                                   window=window)
            torch.cuda.synchronize()
            if not torch.equal(solo[:, :, 0], full[:, :, h]):
                raise RuntimeError(f"flash_attention: head {h} alone != in "
                                   f"its group at s {s} h{hq}/{hkv} d{d}")
        attn.append(f"s{s} h{hq}/{hkv} d{d} window {window}")
    log("flash_attention q-split invariance, bit for bit: chunks of 7/16/64 "
        f"and single heads == the whole prompt at {attn}")
    a = rand((300, 960), bf, 960 ** -0.5)
    bg = rand((960, 2560), bf)
    bu = rand((960, 2560), bf)
    for m in (1, 8, 9, 16, 300):
        got = gemm_gated(a[:m], bg, bu, activation="relu", out_dtype=f32)
        want = torch.relu(gemm_aie(a[:m], bg, out_dtype=f32)) \
            * gemm_aie(a[:m], bu, out_dtype=f32)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"gemm_gated != relu(gemm_aie) * gemm_aie at "
                               f"m = {m}")
    full = gemm_gated(a, bg, bu)
    for m in (9, 16, 300):
        for r0 in sorted({0, 5, 300 - m}):
            got = gemm_gated(a[r0:r0 + m], bg, bu)
            torch.cuda.synchronize()
            if not torch.equal(got, full[r0:r0 + m]):
                raise RuntimeError(f"gemm_gated rows {r0}..{r0 + m} != its "
                                   "300-row call")
    log("gemm_gated == relu(gemm_aie) * gemm_aie, bit for bit, at m = 1, 8, "
        "9, 16, 300 (960x2560); its rows at m = 9, 16, 300 == its 300-row "
        "call")
    return {"flash_attention_q_split": attn,
            "gemm_gated_relu_identity_m": [1, 8, 9, 16, 300],
            "gemm_gated_batch_invariance_m": [9, 16, 300]}


def api_phase():
    """The paper's question on this card: which dataflow wins where.  For
    each dense GEMM shape of both models' serve paths (smollm-360m's and
    qwen3-moe-235b-a22b's) at m = 8 and m = 300, and the 1024^3 bf16
    GEMM, print the HOPPER_H100 plan's explain(), then time the one-shot
    ops.gemm with the planner's choice, with strategy="aie" and with
    strategy="tb" (CUDA-graph replays, cold L2), measured beside
    modeled.  Kernel launch counts are set to 0 before and read after."""
    d, ff, V = 960, 2560, 49152
    qd, qq, qkv = 4096, 8192, 512
    bf = torch.bfloat16
    cases = []
    for m in (8, 300):
        cases += [(f"wq {m}x960x960", m, d, d, {}),
                  (f"wk/wv {m}x960x320", m, d, 320, {}),
                  (f"wo+res {m}x960x960", m, d, d, {"residual": True}),
                  (f"gate/up {m}x960x2560", m, d, ff, {"gated": True}),
                  (f"down+res {m}x2560x960", m, ff, d, {"residual": True}),
                  (f"qwen3 wq {m}x{qd}x{qq}", m, qd, qq, {}),
                  (f"qwen3 wk/wv {m}x{qd}x{qkv}", m, qd, qkv, {}),
                  (f"qwen3 wo+res {m}x{qq}x{qd}", m, qq, qd,
                   {"residual": True})]
    cases += [("lm_head 8x960x49152", 8, d, V, {"f32": True}),
              ("bench 1024x1024x1024", 1024, 1024, 1024, {})]
    reset_counters()
    rows = []
    for name, m, k, n, opt in cases:
        def make():
            a = rand((m, k), bf, k ** -0.5)
            kw = {"out_dtype": torch.float32} if opt.get("f32") else {}
            if opt.get("gated"):
                kw.update(b2=rand((k, n), bf, k ** -0.5), activation="silu")
            if opt.get("residual"):
                kw["residual"] = rand((m, n), bf)
            return (a, rand((k, n), bf, k ** -0.5)), kw
        first = make()
        args, kw = first
        per = nbytes(*args, *(v for v in kw.values()
                              if isinstance(v, torch.Tensor)))
        copies = max(1, min(64, math.ceil(COLD_BYTES / per)))
        inputs = [first] + [make() for _ in range(copies - 1)]
        row = {"case": name, "m": m, "k": k, "n": n}
        for label, strategy in (("planned", None), ("aie", "aie"),
                                ("tb", "tb")):
            if strategy == "tb" and opt.get("gated"):
                continue                    # the gated kernel is 'aie' only
            pl = ops.plan(ops.GemmSpec.for_operands(
                *args, strategy=strategy, **kw), (m, k, n))
            if label == "planned":
                log(f"plan {name}:\n{pl.explain()}")
            t = pl.tile
            row[label] = {
                "strategy": t.strategy, "tile": [t.bm, t.bk, t.bn],
                "chunk_bk": pl.chunk_bk, "launches": pl.launches,
                "modeled_us": pl.traffic.t_model * 1e6,
                "modeled_bytes": pl.hbm_bytes,
                "measured_us": device_ms(
                    lambda a, b, _s=strategy, **kk: ops.gemm(
                        a, b, strategy=_s, **kk), inputs) * 1e3}
        del inputs
        rows.append(row)
        cells = "  ".join(
            f"{lab} {row[lab]['strategy']} "
            f"{'x'.join(map(str, row[lab]['tile']))}: "
            f"{row[lab]['measured_us']:.1f} us (modeled "
            f"{row[lab]['modeled_us']:.2f})"
            for lab in ("planned", "aie", "tb") if lab in row)
        log(f"api {name:24s} {cells}")
    launches = counts()
    log(f"api: launches {launches}")
    return {"rows": rows, "launches": launches}


# ------------------------------------------------------- phase 3: int8

#: the int8 modes of the kernel phase: W8A16 (bf16 A, int8 weights widened
#: in registers) and W8A8 (A quantized per row, int8 x int8 into int32)
INT8_MODES = ("w8a16", "w8a8")


def int8_weight(k, n, lead=()):
    """A random weight quantized per output channel: (q int8, scale f32
    (..., 1, n))."""
    w = quant.quantize_weight(rand(lead + (k, n), torch.float32, k ** -0.5))
    return w["q"], w["scale"]


def _int_mm_ok(m, k, n):
    """torch._int_mm's shape rules on the card: m > 16, k and n
    multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def int8_gemm_case(name, weight, m, k, n, mode, *, residual=False,
                   out_dtype=None, out_scale=None, tb=False, tile=None,
                   **extra):
    """B1 or, ``tb``, B6 (at ``tile`` or its int8 'tb' plan's) on an int8
    weight: W8A16 (bf16 A, bf16 or ``out_dtype`` C) or W8A8 (A int8, f32
    C, or int8 under ``out_scale``).  Library yardstick: W8A8
    ``torch._int_mm`` x the scale where its shape rules allow, else none;
    W8A16 has no one call, and the unfused dequantize + matmul is timed
    beside it."""
    w8a8 = mode == "w8a8"
    out_dtype = out_dtype or (torch.int8 if out_scale is not None else
                              torch.float32 if w8a8 else torch.bfloat16)
    if tb and tile is None:
        spec = ops.GemmSpec(a_dtype="int8" if w8a8 else "bfloat16",
                            b_quant=True, out_dtype=out_dtype,
                            epilogue=ops.Epilogue(
                                residual=residual,
                                out_quant=out_scale is not None),
                            strategy="tb")
        try:
            tile = ops.plan(spec, (m, k, n)).tile
        except ValueError:      # no 'tb' design in the search's top ten
            tile = tb_tile(m, k, n, torch.bfloat16, residual=residual,
                           out_dtype=torch.float32)

    def make():
        a = rand((m, k), torch.bfloat16)
        if w8a8:
            a = quant.quantize_activations(a)[0]
        q, scale = int8_weight(k, n)
        kw = {"out_dtype": out_dtype, "b_scale": scale}
        if tile is not None:
            kw["tile"] = tile
        if residual:
            kw["residual"] = rand((m, n), torch.bfloat16)
        if out_scale is not None:
            kw["out_scale"] = out_scale
        return (a, q), kw

    def int_mm(a, q, b_scale, out_dtype, tile=None, **_):
        return torch._int_mm(a, q).float() * b_scale

    def dequant(a, q, b_scale, out_dtype, residual=None, tile=None):
        x = torch.matmul(a, q * b_scale.to(a.dtype))
        return (x + residual if residual is not None else x).to(out_dtype)

    def cost(args, kw):
        a, q = args
        out = m * n * torch.empty((), dtype=out_dtype).element_size()
        return (nbytes(a, q, kw["b_scale"], kw.get("residual")) + out,
                2.0 * m * n * k)
    if tile is not None:
        name += f" tile {tile.bm}x{tile.bk}x{tile.bn}"
    case = dict(name=f"{mode} {name}", weight=weight, make=make, cost=cost,
                dtype=torch.float32 if out_dtype != torch.bfloat16
                else torch.bfloat16,
                peak_ops=PEAK_OPS[torch.int8 if w8a8 else torch.bfloat16],
                library=int_mm if w8a8 and out_scale is None
                and _int_mm_ok(m, k, n) else None, **extra)
    if out_scale is not None:
        case["tol"] = 0.0               # int8 C: equal, value for value
    if not w8a8:
        case["dequant"] = dequant
    return case


def int8_moe_cases(mode):
    """qwen3-moe-235b-a22b's quantized dense GEMMs at an 8-slot decode
    step (``moe_weight`` = launches in one step of the 4-layer model) and
    a 300-token prefill (timed), each on the kernel its int8 HOPPER_H100
    plan picks (W8A8: the re-routed int8 x int8 plan, the residual
    outside).  Returns {kernel: [cases]}."""
    d, q, kv, V = 4096, 8192, 512, 151936
    w8a8 = mode == "w8a8"
    out = {"gemm_aie": [], "gemm_tb": []}
    for m, per_step, tag in ((8, 1, "decode"), (300, 0, "prefill")):
        shapes = [(f"qwen3 {tag} wq {m}x{d}x{q}", per_step * MOE_LAYERS, d, q,
                   False, None),
                  (f"qwen3 {tag} wk/wv {m}x{d}x{kv}",
                   per_step * 2 * MOE_LAYERS, d, kv, False, None),
                  (f"qwen3 {tag} wo{'' if w8a8 else '+res'} {m}x{q}x{d}",
                   per_step * MOE_LAYERS, q, d, not w8a8, None)]
        if m == 8:
            shapes.append((f"qwen3 decode lm_head 8x{d}x{V}", 1, d, V, False,
                           torch.float32))
        for name, steps, k, n, res, out_dtype in shapes:
            spec = ops.GemmSpec(
                a_dtype="int8" if w8a8 else "bfloat16", b_quant=True,
                out_dtype="float32" if w8a8 or out_dtype else None,
                epilogue=ops.Epilogue(residual=res))
            tile = ops.plan(spec, (m, k, n)).tile
            tb = tile.strategy == "tb"
            out["gemm_tb" if tb else "gemm_aie"].append(int8_gemm_case(
                name, 0, m, k, n, mode, residual=res, out_dtype=out_dtype,
                tb=tb, tile=tile if tb else None, moe_weight=steps,
                timed=True))
    return out


def int8_gated_case(name, weight, m, k, n, **extra):
    """B2 with int8 gate/up weights (W8A16); the unfused dequantize +
    gate composition is timed beside it (no one PyTorch call)."""
    def make():
        qg, sg = int8_weight(k, n)
        qu, su = int8_weight(k, n)
        return (rand((m, k), torch.bfloat16), qg, qu), \
            {"bg_scale": sg, "bu_scale": su}

    def dequant(a, qg, qu, bg_scale, bu_scale):
        return F.silu(torch.matmul(a, qg * bg_scale.to(a.dtype))) \
            * torch.matmul(a, qu * bu_scale.to(a.dtype))

    def cost(args, kw):
        a, qg, qu = args
        return nbytes(a, qg, qu, kw["bg_scale"], kw["bu_scale"],
                      a.new_empty((m, n))), 4.0 * m * n * k
    bm, bk, bn = gated_cta_tile(m, n, torch.bfloat16, torch.int8)
    return dict(name=f"w8a16 {name}", weight=weight, dtype=torch.bfloat16,
                make=make, library=None, dequant=dequant, cost=cost,
                body=f"tensor cores, int8 weights, CTA tile {bm}x{bk}x{bn}",
                **extra)


def int8_grouped_case(name, weight, sizes, m, k, n, *, act=None,
                      timed=False):
    """B7 on an int8 expert bank with its (E, 1, n) scale rows (W8A16);
    the unfused dequantize + ``torch._grouped_mm`` is timed beside it."""
    sizes = np.asarray(sizes, np.int64)
    e = len(sizes)

    def make():
        q, scale = int8_weight(k, n, (e,))
        kw = {"out_dtype": torch.bfloat16, "b_scale": scale}
        if act:
            kw["activation"] = act
        gs = torch.as_tensor(sizes.astype(np.int32), device="cuda")
        return (rand((m, k), torch.bfloat16), q, gs), kw

    def dequant(a, q, gs, out_dtype, b_scale, activation=None):
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        x = torch._grouped_mm(a, q * b_scale.to(a.dtype), offs=offs)
        return (F.silu(x) if activation == "silu" else x).to(out_dtype)

    def cost(args, kw):
        """Bytes: the live experts' int8 panels and scale rows, A and C;
        operations: the routed rows' products."""
        live = int((sizes > 0).sum())
        return (live * (k * n + 4 * n) + 2 * (m * k + m * n),
                2.0 * float(sizes.sum()) * k * n)
    bm, bk, bn = grouped_cta_tile(m, e, torch.bfloat16, torch.int8)
    return dict(name=f"w8a16 {name}", weight=weight, moe_weight=weight,
                dtype=torch.bfloat16, make=make, library=None,
                dequant=dequant, cost=cost, timed=timed or weight > 0,
                plain_eager=True,
                body=f"tensor cores, int8 bank, CTA tile {bm}x{bk}x{bn}")


def int8_cases():
    """The int8 kernel cases, {kernel: {mode: [cases]}}, at the served
    shapes of both models: smollm-360m's 8-slot decode step (weights =
    launches of that shape in one step) and 300-token prefill, and
    qwen3-moe's decode step and prefill; one out-quant case on B1 and on
    B6b; the edges k = 300 and n = 200 (B7: rows not whole 16-byte
    units, so the cp.async path)."""
    d, ff, V = 960, 2560, 49152
    out = {"gemm_aie": {}, "gemm_tb": {}, "gemm_gated": {},
           "gemm_grouped": {}}
    for mode in INT8_MODES:
        w8a8 = mode == "w8a8"
        res = not w8a8          # W8A8 adds the residual outside the kernel
        for name, tb in (("gemm_aie", False), ("gemm_tb", True)):
            out[name][mode] = [
                int8_gemm_case("decode wq 8x960x960", 32, 8, d, d, mode,
                               tb=tb),
                int8_gemm_case("decode wk/wv 8x960x320", 64, 8, d, 320, mode,
                               tb=tb),
                int8_gemm_case(f"decode wo{'+res' if res else ''} 8x960x960",
                               32, 8, d, d, mode, residual=res, tb=tb),
                int8_gemm_case(f"decode down{'+res' if res else ''} "
                               "8x2560x960", 32, 8, ff, d, mode,
                               residual=res, tb=tb),
                int8_gemm_case("decode lm_head 8x960x49152", 1, 8, d, V,
                               mode, out_dtype=torch.float32, tb=tb),
                int8_gemm_case("prefill wq 300x960x960", 0, 300, d, d, mode,
                               tb=tb, timed=True),
                int8_gemm_case("prefill down 300x2560x960", 0, 300, ff, d,
                               mode, tb=tb, timed=True),
                int8_gemm_case("edge 9x300x200 k % 16 != 0", 0, 9, 300, 200,
                               mode, tb=tb),
            ] + int8_moe_cases(mode)[name]
            if w8a8:
                out[name][mode].append(int8_gemm_case(
                    "out-quant 8x960x960 scale 0.37", 0, 8, d, d, mode,
                    out_scale=0.37, tb=tb, timed=True))
    out["gemm_gated"]["w8a16"] = [
        int8_gated_case("decode gate/up 8x960x2560", 32, 8, d, ff),
        int8_gated_case("prefill gate/up 300x960x2560", 0, 300, d, ff,
                        timed=True),
        int8_gated_case("edge 37x300x200", 0, 37, 300, 200),
    ]
    dk, dff, e = 4096, 1536, 128
    dec = routed_sizes(8, e, 8, 8, seed=21)
    pre = routed_sizes(300, e, 8, 24, seed=22)
    out["gemm_grouped"]["w8a16"] = [
        int8_grouped_case("decode gate+silu 64x4096x1536", MOE_LAYERS, dec,
                          64, dk, dff, act="silu"),
        int8_grouped_case("decode up 64x4096x1536", MOE_LAYERS, dec, 64, dk,
                          dff),
        int8_grouped_case("decode down 64x1536x4096", MOE_LAYERS, dec, 64,
                          dff, dk),
        int8_grouped_case("prefill gate+silu 2400x4096x1536", 0, pre, 2400,
                          dk, dff, act="silu", timed=True),
        int8_grouped_case("prefill down 2400x1536x4096", 0, pre, 2400, dff,
                          dk, timed=True),
        int8_grouped_case("edge straddled 63x300x200", 0,
                          [3, 2, 1, 1, 4, 2, 50], 63, 300, 200),
    ]
    return out


def int8_kernel_phase():
    """Each int8 case against its plain version (bf16 C 2e-2, f32 C
    1e-5, int8 C equal), timed beside its byte or op bound, its library
    call where one exists and the unfused dequantize + library
    composition where none does.  {kernel: {mode: check_kernel(...)}}."""
    out = {}
    for name, by_mode in int8_cases().items():
        out[name] = {}
        for mode, cases in by_mode.items():
            for case in cases:      # the library yardstick, where it runs
                if case["library"] is not None:
                    args, kw = case["make"]()
                    try:
                        case["library"](*args, **kw)
                    except RuntimeError as exc:
                        log(f"  {case['name']}: torch._int_mm refused "
                            f"({str(exc).splitlines()[0]}); no yardstick")
                        case["library"] = None
            out[name][mode] = check_kernel(name, cases)
    return out


def int8_bitwise_phase():
    """The bitwise gates of the int8 paths, at both models' served
    shapes: (a) W8A8 == its plain version (int32 sums exact, one f32
    multiply) on B1 and B6, f32 and int32 C; (b) W8A16 on B1 == B1's bf16
    body on q.to(bfloat16) with f32 output, then * b_scale; (c) B6 == B1
    on every int8 path (W8A16, W8A8, out-quant) at the 'tb' plan's tile
    and tiles giving one, two and four or more k-chunks; (d) B7's int8
    rows == B1's W8A16 rows, at both CTA shapes; (e) B2 with int8
    weights and relu == relu(B1 W8A16) * B1 W8A16."""
    shapes = [(8, 960, 960), (8, 960, 320), (8, 2560, 960), (300, 960, 960),
              (8, 4096, 8192), (8, 8192, 4096), (300, 4096, 512),
              (9, 300, 200)]
    n_a = n_b = n_c = 0
    for m, k, n in shapes:
        a = rand((m, k), torch.bfloat16)
        a8 = quant.quantize_activations(a)[0]
        q, scale = int8_weight(k, n)
        f32 = torch.float32
        for got, want, what in (
                (gemm_aie(a8, q, b_scale=scale, out_dtype=f32),
                 gemm_aie_plain(a8, q, b_scale=scale, out_dtype=f32),
                 "B1 W8A8"),
                (gemm_tb(a8, q, b_scale=scale, out_dtype=f32,
                         tile=ops.TileConfig(16, 512, 64, "tb")),
                 gemm_aie_plain(a8, q, b_scale=scale, out_dtype=f32),
                 "B6 W8A8"),
                (gemm_aie(a8, q), gemm_aie_plain(a8, q,
                                                 out_dtype=torch.int32),
                 "B1 W8A8 int32 sums"),
                (gemm_aie(a, q, b_scale=scale, out_dtype=f32),
                 gemm_aie(a, q.to(torch.bfloat16), out_dtype=f32) * scale,
                 "B1 W8A16 == B1 bf16 on the widened weights")):
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{what} differs at {m}x{k}x{n}")
            n_a += 1
        res = rand((m, n), torch.bfloat16)
        variants = {
            "w8a16": (a, {"b_scale": scale, "out_dtype": torch.bfloat16}),
            "w8a16+res": (a, {"b_scale": scale, "residual": res,
                              "out_dtype": torch.bfloat16}),
            "w8a8": (a8, {"b_scale": scale, "out_dtype": f32}),
            "out-quant": (a8, {"b_scale": scale, "out_scale": 0.37,
                               "out_dtype": torch.int8}),
        }
        half = -(-k // 2 // 32) * 32
        for label, (x, kw) in variants.items():
            want = gemm_aie(x, q, **kw)
            spec = ops.GemmSpec(a_dtype=x.dtype, b_quant=True,
                                out_dtype=kw["out_dtype"], strategy="tb",
                                epilogue=ops.Epilogue(
                                    residual="residual" in kw,
                                    out_quant="out_scale" in kw))
            try:
                pt = ops.plan(spec, (m, k, n)).tile
                tiles = [(pt.bm, pt.bk, pt.bn)]
            except ValueError:  # no 'tb' design in the search's top ten
                tiles = []
            for tile in tiles + [(8, 4096, 16), (16, half, 32),
                                 (8, 128, 64)]:
                got = gemm_tb(x, q, tile=ops.TileConfig(*tile, "tb"), **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"gemm_tb != gemm_aie ({label}) at "
                                       f"{m}x{k}x{n} tile {tile}")
                n_b += 1
        del a, a8, q, scale, res
    for case in int8_cases()["gemm_grouped"]["w8a16"]:
        (a, q, gs), kw = case["make"]()
        sizes = gs.tolist()
        for cta in (1, 2):
            got = gemm_grouped(a, q, gs, cta=cta, **kw)
            start = 0
            for g, size in enumerate(sizes):
                if size:
                    want = gemm_aie(a[start:start + size], q[g],
                                    b_scale=kw["b_scale"][g],
                                    activation=kw.get("activation"),
                                    out_dtype=kw["out_dtype"])
                    if not torch.equal(got[start:start + size], want):
                        raise RuntimeError(
                            f"int8 gemm_grouped != gemm_aie W8A16 on group "
                            f"{g} of {case['name']} at CTA shape {cta}")
                    n_c += 1
                start += size
            if got[start:].any():
                raise RuntimeError(f"int8 gemm_grouped: rows past the groups "
                                   f"of {case['name']} are not zero")
        del a, q
    a = rand((300, 960), torch.bfloat16, 960 ** -0.5)
    qg, sg = int8_weight(960, 2560)
    qu, su = int8_weight(960, 2560)
    for m in (1, 8, 9, 16, 300):
        got = gemm_gated(a[:m], qg, qu, bg_scale=sg, bu_scale=su,
                         activation="relu", out_dtype=torch.float32)
        want = torch.relu(gemm_aie(a[:m], qg, b_scale=sg,
                                   out_dtype=torch.float32)) \
            * gemm_aie(a[:m], qu, b_scale=su, out_dtype=torch.float32)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"int8 gemm_gated != relu(B1) * B1 at m = {m}")
    log(f"int8 bitwise: W8A8 == plain and W8A16 == B1 bf16 on the widened "
        f"weights in {n_a} cases; gemm_tb == gemm_aie on W8A16, W8A16+res, "
        f"W8A8 and out-quant in {n_b} cases; int8 gemm_grouped == gemm_aie "
        f"W8A16 on {n_c} groups at both CTA shapes; int8 gemm_gated == "
        "relu(B1) * B1 at m = 1, 8, 9, 16, 300")
    return {"w8a8_and_widened_cases": n_a, "tb_equals_aie_cases": n_b,
            "grouped_groups": n_c, "gated_m": [1, 8, 9, 16, 300]}


# ---------------------------------------------------------------- phase 4

#: prompts of the serve trace: mostly short, two past 128 tokens
SERVE_PROMPT_LENS = (12, 160, 8, 24, 300, 16, 32, 9, 20, 28)


def reset_counters():
    for kernel, plain, _, _ in KERNELS.values():
        kernel.launches = 0
        plain.launches = 0
    gemm_tb.final_launches = 0


def counts():
    """Kernel launch counts by counter (B6's final chunk apart)."""
    out = {n: k.launches for n, (k, _, _, _) in KERNELS.items()}
    out["gemm_tb_final"] = gemm_tb.final_launches
    return out


class PlanRecorder:
    """Counts the GEMM plans the one-shot ops.gemm executes, by wrapping
    the operator API's kernel fan-out for the length of a ``with``.  The
    tuner's measurements are not executions of the step (their launches
    are taken back off the counters too) and are not counted."""

    def __enter__(self):
        self.plans = {}
        self.group_sizes = None       # the first grouped launch's sizes
        self._launch = api._launch

        def record(pl, *args, **kw):
            if tune_measure.measuring():    # a tuner's sample, not a step
                return self._launch(pl, *args, **kw)
            self.plans[pl] = self.plans.get(pl, 0) + 1
            if pl.spec.grouped and self.group_sizes is None:
                self.group_sizes = args[5] if len(args) > 5 \
                    else kw["group_sizes"]
            return self._launch(pl, *args, **kw)
        api._launch = record
        return self

    def __exit__(self, *exc):
        api._launch = self._launch

    def implied(self):
        """Launches the executed plans imply, by counter."""
        out = {}
        for pl, times in self.plans.items():
            for name, n in pl.launches.items():
                out[name] = out.get(name, 0) + times * n
        return out


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


def serve_phase(cfg, params, *, paged, mode=None, telemetry_base=None):
    """Serve the trace through the dense engine or, ``paged``, through
    the paged one (16-token pages, 64-token chunks, prefix cache on)
    with two shared-prefix requests added.  The kernel counts are set to
    0 just before the run and read just after; a MoE model must launch
    B7 three times a layer a pass.  With ``telemetry_base`` the trace is
    served again with telemetry on (:func:`telemetry_run`).  The tokens
    by trace position and the executed plans ride the result under
    ``_tokens`` / ``_plans`` (the caller pops them before the JSON)."""
    trace = serve_trace(cfg)
    kw = dict(page_size=16, prefill_chunk=64) if paged else {}
    if paged:
        trace += shared_prefix_requests(cfg, 64, 20, 32, seed=8)
    engine = DecodeEngine(params, cfg, batch=8, max_len=1024, device="cuda",
                          **kw)
    engine.run([Request(prompt=trace[0].prompt[:5], max_tokens=2)])  # warm-up
    engine.reset_metrics()
    if mode == "tuning":            # what only the search pass measures
        log(f"serve {cfg.name}: the search pass, tok/s and TTFT include "
            "the tile searches")

    reset_counters()
    with PlanRecorder() as rec:
        t0 = time.perf_counter()
        results = engine.run(trace)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = counts()
    plain = {n: p.launches for n, (_, p, _, _) in KERNELS.items()}

    m = engine.metrics
    steps = m["decode_steps"]
    prefills = m["prefill_chunks"]
    decode, other = ("flash_decode_paged", "flash_decode") if paged \
        else ("flash_decode", "flash_decode_paged")
    # every pass runs gemms_per_pass planned GEMMs; their plans say which
    # kernel takes each and how often (a 'tb' plan: one B6a a chunk but
    # the last, and one B6b)
    passes = steps + prefills
    executed = sum(rec.plans.values())
    if executed != gemms_per_pass(cfg) * passes:
        raise RuntimeError(f"{executed} GEMMs ran, expected "
                           f"{gemms_per_pass(cfg)} x {passes} passes")
    n_moe = cfg.repeats * cfg.layer_pattern.count("moe")
    want = {"gemm_aie": 0, "gemm_gated": 0, "gemm_tb": 0,
            "gemm_tb_final": 0, "gemm_grouped": 0}
    want.update(rec.implied())
    want.update({decode: cfg.n_layers * steps, other: 0,
                 "flash_attention": cfg.n_layers * prefills})
    if want["gemm_grouped"] != 3 * n_moe * passes:
        raise RuntimeError(f"{want['gemm_grouped']} grouped GEMMs planned, "
                           f"expected 3 x {n_moe} MoE layers x {passes}")
    if launches != want or any(plain.values()):
        raise RuntimeError(f"{'paged' if paged else 'dense'} path launches "
                           f"{launches} (expected {want}), plain versions "
                           f"{plain}")
    by_kernel = {}
    for pl, times in rec.plans.items():
        key = f"{pl.kernel} m={pl.m} {pl.k}x{pl.n}"
        by_kernel[key] = by_kernel.get(key, 0) + times
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
           "gemm_plans_executed": by_kernel,
           "plain_launches": plain, "prefill_chunks": prefills,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    tag = ("paged serve" if paged else "serve") + f" {cfg.name}" \
        + (f" {mode}" if mode else "")
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
    out["_tokens"] = [by_rid[req.rid].tokens for req in trace]
    out["_plans"] = dict(rec.plans)
    if telemetry_base:
        out["telemetry"] = telemetry_run(cfg, params, trace, kw,
                                         out["_tokens"], telemetry_base, tag)
    return out


def telemetry_run(cfg, params, trace, kw, want_tokens, base, tag):
    """The serve trace again through a fresh engine, telemetry on (the
    warm-up off), both artifacts exported to ``chiprun_out/base``.  The
    trace must agree with the engine: one ``serve.request`` span a
    request, the decode bursts' steps summing to the engine's decode
    steps, the serve counters equal to its metrics, and for a MoE model
    routed + dropped rows equal to tokens x top-k over every MoE layer
    and pass; the greedy tokens must equal the untraced run's bit for
    bit.  Prints what the spans show."""
    engine = DecodeEngine(params, cfg, batch=8, max_len=1024, device="cuda",
                          **kw)
    engine.run([Request(prompt=trace[0].prompt[:5], max_tokens=2)])  # warm-up
    engine.reset_metrics()
    reqs = [dataclasses.replace(r, rid=-1) for r in trace]
    rec = telemetry.enable(telemetry.Recorder())
    try:
        results = engine.run(reqs)
        snap = rec.snapshot()
    finally:
        telemetry.disable()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    paths = rec.export(str(out_dir / base))
    by_rid = {r.rid: r for r in results}
    for i, req in enumerate(reqs):
        if not np.array_equal(by_rid[req.rid].tokens, want_tokens[i]):
            raise RuntimeError(f"{tag} with telemetry: request {i} decoded "
                               f"{by_rid[req.rid].tokens}, without "
                               f"{want_tokens[i]}")
    m, c = engine.metrics, snap["counters"]
    spans = collections.defaultdict(list)
    for e in rec.events:
        if e["type"] == "span":
            spans[e["name"]].append(e)
    if len(spans["serve.request"]) != len(reqs):
        raise RuntimeError(f"{tag}: {len(spans['serve.request'])} "
                           f"serve.request spans for {len(reqs)} requests")
    burst_steps = sum(e["attrs"]["steps"] for e in spans["serve.decode_burst"])
    want = {"serve.decode_steps": m["decode_steps"],
            "serve.prefill_tokens": m["prefill_tokens"],
            "serve.generated_tokens": m["generated_tokens"],
            "serve.completed": m["completed"]}
    if engine.paged:
        want.update({"serve.prefix_cache.hits": m["prefix_hits"],
                     "serve.prefix_cache.misses": m["prefix_misses"]})
    got = {k: c.get(k, 0) for k in want}
    if burst_steps != m["decode_steps"] or got != want:
        raise RuntimeError(f"{tag}: bursts {burst_steps} steps, counters "
                           f"{got}, engine {want}")
    out = {"events": len(rec.events), "artifacts": [
        str(pathlib.Path(x).relative_to(ROOT)) for x in paths],
        "counters": c, "gauges": snap["gauges"]}
    n_moe = cfg.repeats * cfg.layer_pattern.count("moe")
    if n_moe:
        routed, dropped = c["moe.group_sizes"], c["moe.dropped_tokens"]
        rows = (m["prefill_tokens"] + engine.n_slots * m["decode_steps"]) \
            * cfg.top_k * n_moe
        if routed + dropped != rows:
            raise RuntimeError(f"{tag}: MoE counters {routed} routed + "
                               f"{dropped} dropped != {rows} assignments")
        out["moe_rows"] = {"routed": routed, "dropped": dropped}

    def ms(name, key="dur"):
        return [e[key] * 1e3 for e in spans[name]]

    prefill = ms("serve.prefill") + ms("serve.prefill_chunk")
    bursts = spans["serve.decode_burst"]
    per_step = [e["dur"] * 1e3 / e["attrs"]["steps"] for e in bursts]
    split = {k: float(np.mean(ms(f"serve.request.{k}")))
             for k in ("queued", "prefill", "decode")}
    out.update({
        "prefill_spans": len(prefill),
        "prefill_ms_mean": float(np.mean(prefill)),
        "prefill_ms_total": float(np.sum(prefill)),
        "decode_bursts": len(bursts),
        "decode_burst_ms_per_step_median": float(np.median(per_step)),
        "request_split_ms_mean": split,
        "ttft_ms_mean": float(np.mean(
            [e["attrs"]["ttft"] for e in spans["serve.request"]]) * 1e3)})
    log(f"{tag} with telemetry: {len(rec.events)} events, tokens == the "
        f"untraced run's; {len(prefill)} prefill spans, mean "
        f"{out['prefill_ms_mean']:.2f} ms ({out['prefill_ms_total']:.1f} "
        f"ms in all); {len(bursts)} decode bursts, median "
        f"{out['decode_burst_ms_per_step_median']:.2f} ms a step; request "
        f"means: queued {split['queued']:.1f} ms, prefill "
        f"{split['prefill']:.1f} ms, decode {split['decode']:.1f} ms, TTFT "
        f"{out['ttft_ms_mean']:.1f} ms"
        + (f"; MoE {out['moe_rows']['routed']} rows routed, "
           f"{out['moe_rows']['dropped']} dropped" if n_moe else "")
        + f"; wrote {', '.join(out['artifacts'])}")
    return out


@torch.inference_mode()
def step_phase(cfg, params, *, paged, mode=None, telemetry_on=False):
    """Device time of one 8-slot decode step (with its greedy argmax),
    from CUDA-graph replays that take the host out of the step, beside
    the same step run eagerly: one loop of REPS steps right after the
    replays, timed on the host's clock to a synchronize
    (``eager_ms_per_step``); the difference is the device's idle time in
    an eager step.  ``telemetry_on`` runs the eager loop seven more
    times, telemetry off and on in turns, and compares the medians of
    each mode's four loops (the first loop counts as an off one).  The
    same eight prompts sit in the dense cache or, ``paged``, in 16-token
    pages of a pool (64 pages a slot, so the gathered length equals the
    dense 1024)."""
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

    def eager_loop():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            step(tok, cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / REPS * 1e3

    def traced_loop():
        rec = telemetry.enable(telemetry.Recorder())
        try:
            ms = eager_loop()
            rec.snapshot()          # folds the MoE counters (one sync)
        finally:
            telemetry.disable()
        return ms

    eager = eager_loop()
    out = {"device_ms_per_step": device, "eager_ms_per_step": eager,
           "device_idle_share": 1.0 - device / eager}
    if telemetry_on:        # in turns (ABBA BAAB), as the host drifts
        order = (False, True, True, False, True, False, False, True)
        runs = [eager] + [traced_loop() if on else eager_loop()
                          for on in order[1:]]
        off = [r for r, on in zip(runs, order) if not on]
        on = [r for r, on in zip(runs, order) if on]
        out.update({"eager_ms_off_median": float(np.median(off)),
                    "eager_ms_per_step_telemetry_on": float(np.median(on)),
                    "eager_ms_off": off, "eager_ms_on": on})
        out["telemetry_on_over_off"] = \
            out["eager_ms_per_step_telemetry_on"] / out["eager_ms_off_median"]
    log(f"{cfg.name} {mode or cfg.dtype} {'paged' if paged else 'dense'} "
        "decode step (8 "
        "slots): device "
        f"{device:.2f} ms (CUDA graph), eager {eager:.2f} ms; device idle "
        f"{out['device_idle_share']:.1%} of an eager step"
        + (f"; eager, medians of four loops each in turns, telemetry off "
           f"{out['eager_ms_off_median']:.2f} ms, on "
           f"{out['eager_ms_per_step_telemetry_on']:.2f} ms ("
           f"{out['telemetry_on_over_off'] - 1:+.1%}; off "
           f"{', '.join(f'{x:.2f}' for x in off)}; on "
           f"{', '.join(f'{x:.2f}' for x in on)})" if telemetry_on else ""))
    return out


# ------------------------------------------------- tuning and calibration

#: candidates the measured search sweeps a shape: the reference's K = 4
#: never reaches the first 'aie' design at qwen3-moe's 300-token wq
TUNE_K = 8
#: qwen3-moe's 300-token prefill GEMMs the Hopper plan sends to B6
NAMED_SHAPES = {(300, 4096, 8192): "qwen3 wq, 300 tokens",
                (300, 8192, 4096): "qwen3 wo + residual, 300 tokens"}


def _tile(t) -> str:
    return f"{t.strategy} {t.bm}x{t.bk}x{t.bn}"


def autotune_phase(cfg, params, untuned, card):
    """The dense serve trace once more untuned (every plan cached: the
    baseline), then under ``tune.enable(TUNE_K)`` on the fresh tuning
    cache ``$REPRO_TUNE_CACHE``: the plan cache starts empty, so every
    GEMM the warm-up and the trace plan is searched on the card, and a
    second tuned pass, every plan cached, is the one compared.  Gates:
    launches equal the executed plans (serve_phase; the tuner's samples
    are not executions), the greedy tokens equal
    ``untuned``'s bit for bit, no B1 / B6 candidate fails at the model's
    shapes, and a second pass (a fresh in-memory cache over the same
    file) re-plans every plan with zero measurements and the same tiles.
    Prints each tuned plan: the analytic first choice and its measured
    us, the winner and its us; and the plans the flop budget skipped."""
    errors0 = len(autotune.candidate_errors)
    measured0 = tune.tuning_cache_info().measurements
    # the untuned baseline with every plan already cached, as the tuned
    # pass below finds them (the first untuned run plans each new prompt
    # length on the host while it serves)
    base = serve_phase(cfg, params, paged=False, mode="untuned, planned")
    tune.enable(TUNE_K)
    api.plan_cache_clear()
    try:
        t0 = time.perf_counter()     # the pass that searches
        search = serve_phase(cfg, params, paged=False, mode="tuning")
        seconds = time.perf_counter() - t0
        run = serve_phase(cfg, params, paged=False, mode="tuned")
        run["step"] = step_phase(cfg, params, paged=False, mode="tuned")
        plans = [pl for pl in api.plans() if not pl.spec.grouped]
        searched = tune.tuning_cache_info().measurements - measured0
        tune.tuning_cache_reset()           # the second pass
        api.plan_cache_clear()
        again = [api.plan(pl.spec, (pl.m, pl.k, pl.n)) for pl in plans]
        second = tune.tuning_cache_info()
    finally:
        tune.disable()
        api.plan_cache_clear()
    run.pop("_plans")
    for tokens in (base.pop("_tokens"), search.pop("_tokens"),
                   run.pop("_tokens")):
        for i, (a, b) in enumerate(zip(tokens, untuned["_tokens"])):
            if not np.array_equal(a, b):
                raise RuntimeError(f"tuned {cfg.name}: request {i} decoded "
                                   f"{a}, untuned {b}")
    if second.measurements or [pl.tile for pl in again] != \
            [pl.tile for pl in plans]:
        raise RuntimeError(f"tuned {cfg.name}: the second pass measured "
                           f"{second.measurements} plans or changed a tile")
    errors = autotune.candidate_errors[errors0:]
    failed = [e for e in errors if e[0] == "measure"]
    if failed:
        raise RuntimeError(f"tuned {cfg.name}: {len(failed)} candidate "
                           f"executions failed: {failed[:3]}")
    rows, skipped = [], []
    for pl in plans:
        shape = (pl.m, pl.k, pl.n)
        if pl.tuned is None:
            if pl.problem.flops > tune.DEFAULT_MAX_FLOPS:
                skipped.append(f"{pl.spec.key} {pl.m}x{pl.k}x{pl.n}")
            continue
        ti = pl.tuned
        row = {"spec": pl.spec.key, "shape": f"{pl.m}x{pl.k}x{pl.n}",
               "analytic": ti.analytic_tile,
               "analytic_us": ti.t_analytic_us, "winner": _tile(pl.tile),
               "winner_kernel": pl.kernel, "winner_us": ti.t_measured_us,
               "t_model_us": pl.traffic.t_model * 1e6,
               "k_searched": ti.k_searched,
               "name": NAMED_SHAPES.get(shape)}
        rows.append(row)
        # every row goes to the JSON; the log names the shapes asked
        # for and every plan whose winner runs another kernel
        if row["name"] or row["winner"].split()[0] != \
                row["analytic"].split()[0]:
            log(f"tuned {cfg.name} {row['spec']} {row['shape']}"
                + (f" ({row['name']})" if row["name"] else "")
                + f": analytic {row['analytic']} "
                f"{row['analytic_us']:.1f} us, measured winner "
                f"{row['winner']} ({pl.kernel}) {row['winner_us']:.1f} us"
                f" [{card}]")
    for shape, name in NAMED_SHAPES.items():
        if cfg.name.startswith("qwen3") and not any(
                r["shape"] == "x".join(map(str, shape)) for r in rows):
            raise RuntimeError(f"tuned {cfg.name}: {name} was not tuned")
    out = {"k": TUNE_K, "search_seconds": seconds, "searches": searched,
           "search_pass_launches": search["launches"],
           "second_pass_hits": second.hits,
           "second_pass_measurements": second.measurements,
           "candidate_errors": len(errors),
           "candidate_errors_resolve": len(errors) - len(failed),
           "plans": len(plans), "tuned": rows, "flop_budget_skipped": skipped,
           "serve": run, "untuned": {
               "tok_s_decode": base["tok_s_decode"],
               "ttft_mean_ms": base["ttft_mean_ms"],
               "device_ms_per_step":
                   untuned["step"]["device_ms_per_step"],
               "first_run_tok_s_decode": untuned["tok_s_decode"],
               "first_run_ttft_mean_ms": untuned["ttft_mean_ms"]}}
    log(f"autotune {cfg.name} (K = {TUNE_K}): {searched} searches in "
        f"{seconds:.1f} s with the trace that ran them (launches == "
        f"executed plans in it too), {len(rows)} of {len(plans)} plans "
        f"tuned, {sum(r['winner'] != r['analytic'] for r in rows)} changed "
        f"tile, {len(skipped)} over the flop budget {skipped}; "
        f"{len(errors)} candidate errors ({len(failed)} executions failed, "
        f"{len(errors) - len(failed)} tiles infeasible after clamping); "
        f"second pass {second.hits} hits, {second.measurements} "
        f"measurements; tokens == untuned")
    log(f"autotune {cfg.name}: decode {run['tok_s_decode']:.1f} tok/s "
        f"(untuned {base['tok_s_decode']:.1f}), device step "
        f"{run['step']['device_ms_per_step']:.2f} ms (untuned "
        f"{untuned['step']['device_ms_per_step']:.2f}), TTFT mean "
        f"{run['ttft_mean_ms']:.0f} ms (untuned {base['ttft_mean_ms']:.0f};"
        f" both with every plan cached) [{card}]")
    return out


def _plan_keys(plans):
    """The distinct dense (spec, (m, k, n)) of some executed plans, the
    spec untuned."""
    keys = {}
    for pl in plans:
        if not pl.spec.grouped:
            keys[(dataclasses.replace(pl.spec, tune=False),
                  (pl.m, pl.k, pl.n))] = None
    return list(keys)


def calibration_phase(plan_sets, card):
    """Fit the effective device-memory rate, compute rate and per-call
    t0 from every sample the autotune phases left in the tuning cache,
    install the card's fit, re-plan every dense GEMM of ``plan_sets``
    (name -> (spec, shape) keys) and report which plans change strategy
    or tile.  f32 plans must be priced at the fitted bf16 rate times the
    sheet's f32/bf16 ratio.  The calibration is cleared at the end."""
    mode = tune.device_mode("cuda")
    fits = calibrate.fit()
    log(calibrate.render(fits))
    before = {name: [api._resolve(spec, *shape) for spec, shape in keys]
              for name, keys in plan_sets.items()}
    applied = calibrate.apply(fits, mode)
    out = {"mode": mode, "fits": {k: v.as_dict() for k, v in fits.items()},
           "applied": applied is not None}
    if applied is None:
        log(f"calibration: no usable fit for {mode}; nothing applied")
        return out
    try:
        cal = bandwidth.get_calibration()
        f32_rate = cal.peak_bf16_flops * HOPPER_H100.peak_f32_flops \
            / HOPPER_H100.peak_bf16_flops if cal.peak_bf16_flops else None
        flips, f32_checked = {}, 0
        for name, keys in plan_sets.items():
            rows = []
            for (spec, shape), a in zip(keys, before[name]):
                b = api._resolve(spec, *shape)
                if spec.a_dtype == "float32" and f32_rate:
                    f32_checked += 1
                    if not math.isclose(b.traffic.t_compute,
                                        b.flops / f32_rate, rel_tol=1e-9):
                        raise RuntimeError(
                            f"calibrated f32 plan {spec.key} {shape} priced "
                            f"at {b.flops / b.traffic.t_compute:.3e} op/s, "
                            f"not {f32_rate:.3e}")
                if a.tile != b.tile:
                    rows.append({"spec": spec.key,
                                 "shape": "x".join(map(str, shape)),
                                 "analytic": _tile(a.tile),
                                 "calibrated": _tile(b.tile),
                                 "strategy_changed":
                                     a.tile.strategy != b.tile.strategy,
                                 "name": NAMED_SHAPES.get(shape)})
            flips[name] = {"plans": len(keys), "changed": rows}
            n_strat = sum(r["strategy_changed"] for r in rows)
            log(f"calibrated re-plan of {name}: {len(keys)} plans, "
                f"{len(rows)} change tile, {n_strat} change strategy: "
                + "; ".join(f"{r['spec']} {r['shape']} {r['analytic']} -> "
                            f"{r['calibrated']}" for r in rows[:12])
                + (" ..." if len(rows) > 12 else ""))
        for shape, name in NAMED_SHAPES.items():
            hit = [r for rows in flips.values() for r in rows["changed"]
                   if r["shape"] == "x".join(map(str, shape))]
            log(f"calibration at {name}: "
                + ("; ".join(f"{r['analytic']} -> {r['calibrated']}"
                             for r in hit) if hit else "no change"))
        out.update({"calibration": dataclasses.asdict(cal),
                    "replanned": flips, "f32_plans_checked": f32_checked,
                    "f32_rate": f32_rate})
    finally:
        calibrate.clear()
    if bandwidth.get_calibration() is not None:
        raise RuntimeError("the calibration outlived its phase")
    log(f"calibration ({mode}): eff BW {applied.hbm_bw}, eff compute "
        f"{applied.peak_flops}, t0 {applied.t0_us:.2f} us, R2 "
        f"{applied.r2} ({applied.n_samples} samples); {f32_checked} f32 "
        f"plans priced at the sheet's f32/bf16 ratio; cleared [{card}]")
    return out


def report_phase(plans, name, card):
    """``telemetry.report.model_vs_measured`` over the executed dense
    plans of a model's serve phases: modeled us against measured us
    (between device syncs, the host's launch included) and the achieved
    share; the whole table goes to ``chiprun_out``."""
    # grouped plans are left out: the harness builds dense operands (the
    # tuner keeps them analytic for the same reason)
    rows = treport.model_vs_measured(
        [pl for pl in dict.fromkeys(plans) if not pl.spec.grouped],
        device="cuda")
    path = ROOT / "chiprun_out" / f"model_vs_measured_{name}.txt"
    path.write_text(f"{card}\n" + treport.render(rows) + "\n")
    summary = treport.summarize(rows)
    worst = sorted((r for r in rows if r["achieved"] is not None),
                   key=lambda r: r["achieved"])
    log(f"model against measured, {name} serve plans: {summary}; lowest "
        "achieved " + ", ".join(
            f"{r['spec']} {r['m']}x{r['k']}x{r['n']} {r['t_model_us']:.1f} "
            f"/ {r['t_measured_us']:.1f} us" for r in worst[:3])
        + f"; highest {worst[-1]['spec']} {worst[-1]['m']}x{worst[-1]['k']}"
        f"x{worst[-1]['n']} {worst[-1]['achieved']:.3f}; table in "
        f"{path.relative_to(ROOT)} [{card}]")
    return {"rows": rows, "summary": summary}


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
    log(f"bit identity ({cfg.name}, activations {quant.activation_mode()})"
        f": {len(reqs)} acceptance requests, continuous batch == solo "
        "greedy at full width")
    return len(reqs)


#: the paged trace of benchmarks/serve_bench.py: the acceptance trace
#: plus a short and a 96-token prompt
PAGED_TRACE = ACCEPTANCE_TRACE + ((8, 8), (96, 8))


def paged_bit_identity_phase(cfg, params, *, reference="dense"):
    """Paged greedy == solo greedy at full width: 2 slots, 16-token
    pages, 16-token chunks, prefix cache off, on the paged trace; then
    two prompts sharing a 32-token prefix with the prefix cache on.  The
    reference is each request alone, by dense ``solo_greedy``
    (``reference="dense"``) or on a 1-slot paged engine with the same
    pages and chunks (``"paged"``): a MoE model's prefill chunk sets the
    expert capacity by the chunk's tokens, so chunked prefill may drop
    other assignments than a whole-prompt prefill (in the JAX package
    too), and the paged MoE path is held to paged solo runs."""
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (p,)).astype(np.int32),
                    max_tokens=mt) for p, mt in PAGED_TRACE]
    max_len = -(-max(p + mt - 1 for p, mt in PAGED_TRACE) // 16) * 16
    kw = dict(max_len=max_len, page_size=16, prefill_chunk=16,
              device="cuda")

    def solo(req):
        if reference == "dense":
            return solo_greedy(params, cfg, req.prompt, req.max_tokens,
                               max_len)
        return DecodeEngine(params, cfg, batch=1, prefix_cache=False,
                            **kw).run([Request(prompt=req.prompt,
                                               max_tokens=req.max_tokens)]
                                      )[0].tokens

    runs = [(reqs, False), (shared_prefix_requests(cfg, 32, 8, 8, seed=7),
                            True)]
    n = 0
    for trace, prefix in runs:
        engine = DecodeEngine(params, cfg, batch=2, prefix_cache=prefix,
                              **kw)
        results = {r.rid: r.tokens for r in engine.run(trace)}
        for req in trace:
            want = solo(req)
            if not np.array_equal(results[req.rid], want):
                raise RuntimeError(
                    f"paged != {reference} solo greedy for request "
                    f"{req.rid} (prefix cache {prefix}): "
                    f"{results[req.rid]} vs {want}")
        if prefix and engine.metrics["prefix_hits"] != 1:
            raise RuntimeError("paged bit identity: the shared prefix was "
                               "not shared")
        n += len(trace)
    log(f"paged bit identity ({cfg.name}, activations "
        f"{quant.activation_mode()}): {n} requests, paged greedy "
        f"(pages 16, chunks 16) == {reference} solo greedy at full width, "
        "2 of them sharing a 32-token prefix")
    return n


@torch.inference_mode()
def cross_device_phase(mode=None):
    """smollm-360m-smoke (f32) on the card against the same port on the
    CPU: bf16-free f32 weights, or (``mode`` "w8a16" / "w8a8") its
    quantized weights, run in that activation mode."""
    cfg = get_smoke_config("smollm-360m")
    cpu_params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    if mode:
        cpu_params, _ = quant.quantize_params(cpu_params)
    quant.set_activation_mode("w8a8" if mode == "w8a8" else "none")
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
    quant.set_activation_mode("none")
    log(f"cross-device{' ' + mode if mode else ''}: smoke prefill + 8 "
        f"decode steps, card vs CPU max abs err {worst:.2e} (tolerance "
        "1e-4)")
    return worst


def int8_serve_phases(cfg, qparams, *, reference="dense"):
    """Serve the quantized weights: W8A16 on the dense cache and the page
    pool, W8A8 on the dense cache, each pass's launches held to its
    executed plans and its decode step timed from CUDA-graph replays;
    then continuous == solo greedy and paged == ``reference`` solo greedy
    in both modes.  The activation mode is W8A16 again after."""
    out = {}
    try:
        for mode in INT8_MODES:
            quant.set_activation_mode("w8a8" if mode == "w8a8" else "none")
            run = {"serve": serve_phase(cfg, qparams, paged=False, mode=mode)}
            run["serve"]["step"] = step_phase(cfg, qparams, paged=False,
                                              mode=mode)
            if mode == "w8a16":
                run["paged_serve"] = serve_phase(cfg, qparams, paged=True,
                                                 mode=mode)
                run["paged_serve"]["step"] = step_phase(cfg, qparams,
                                                        paged=True, mode=mode)
            run["bit_identity_requests"] = bit_identity_phase(cfg, qparams)
            run["paged_bit_identity_requests"] = paged_bit_identity_phase(
                cfg, qparams, reference=reference)
            out[mode] = run
    finally:
        quant.set_activation_mode("none")
    return out


@torch.no_grad()
def quantize(params, name):
    """The weights' int8 copy (``quant.quantize_params``), with the bytes
    before and after logged."""
    t0 = time.perf_counter()
    before = quant.param_bytes(params)
    qparams, n = quant.quantize_params(params)
    torch.cuda.synchronize()
    after = quant.param_bytes(qparams)
    log(f"{name}: int8-quantized {n} weight banks, {before / 1e9:.2f} -> "
        f"{after / 1e9:.2f} GB ({before} -> {after} bytes) in "
        f"{time.perf_counter() - t0:.1f} s; GEMM weight stream "
        f"{quant.gemm_weight_bytes(qparams) / 1e9:.3f} GB a step")
    return qparams, {"quantized_leaves": n, "bytes_before": before,
                     "bytes_after": after,
                     "gemm_weight_bytes": quant.gemm_weight_bytes(qparams)}


# ------------------------------------------------------------ training

#: smollm-360m's training run: the JAX CLI's defaults (sequence 512,
#: global batch 8), AdamW, seed 0, full width and depth, nothing cut
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, LOSS_CHUNKS = 4, 512, 8, 8


def train_gemms_per_step(cfg) -> int:
    """The planned GEMMs of one remat training step: per layer the six
    forward GEMMs twice (the forward and its recompute), dA and dB of q,
    k, v, o and down, and the gated pair's two f32 pre-activation
    recomputes, two dA and two dB; per loss chunk the lm_head forward,
    its recompute, dA and dB."""
    return cfg.n_layers * (2 * 6 + 5 * 2 + 6) + 4 * LOSS_CHUNKS


class TransposeRecorder:
    """Counts the operands of the backward's planned GEMMs that arrive as
    strided views (Wᵀ for dA, Aᵀ for dB), which the kernels' wrappers
    copy contiguous, by wrapping ``api._plain`` for a ``with``."""

    def __enter__(self):
        self.views = {}
        self._plain = api._plain

        def record(a, b, *args, **kw):
            for t in (a, b):
                if not t.is_contiguous():
                    key = (tuple(t.shape), t.dtype)
                    self.views[key] = self.views.get(key, 0) + 1
            return self._plain(a, b, *args, **kw)
        api._plain = record
        return self

    def __exit__(self, *exc):
        api._plain = self._plain


def train_cross_device_phase(arch="smollm-360m", optimizer="adamw"):
    """One ``make_train_step`` step of ``arch``'s smoke config (f32, TF32
    off) from one state on the card and on the CPU: loss, grad norm, every
    gradient leaf, and every updated parameter and optimizer moment within
    1e-4.  The learning rate is 3e-5 from step 0 (no warmup): AdamW's
    first step moves an element by about lr times its gradient's sign,
    so an element whose gradient is ~0 and takes another sign on the
    other device ends at most 2 lr = 6e-5 apart.  That same smallness
    would let a step that applied no update pass, so the update itself,
    (p_new - p_old) / lr (about sign(g) + 0.1 p under weight decay;
    Adafactor's: the gradient over its factored RMS, clipped), must agree
    within 1e-2 on every element whose gradient is clear of zero
    (|g| > 1e-5 on both devices, at least half of all elements); the f32
    rounding of p_new is ~2e-3 of it.  The card's side must launch B1 or
    B6 and B3 (smollm-360m: B2; qwen3-moe: B7) and no plain version.
    The card's step then runs again from the same state: whether the two
    card steps agree bit for bit is reported (``deterministic``)."""
    cfg = get_smoke_config(arch)
    state = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu",
                          optimizer=optimizer)
    batch = pipeline.make_batch(
        cfg, pipeline.DataConfig(seq_len=32, global_batch=4), 0)
    step = TS.make_train_step(cfg, peak_lr=3e-5, warmup_steps=0,
                              optimizer=optimizer, return_grads=True)
    c_state, c_m = step(state, batch)
    reset_counters()
    g_state, g_m = step(to_device(state, "cuda"), to_device(batch, "cuda"))
    torch.cuda.synchronize()
    launches = counts()
    plain = {n: p.launches for n, (_, p, _, _) in KERNELS.items()}
    ffn = "gemm_grouped" if cfg.n_experts else "gemm_gated"
    if any(plain.values()) or not launches[ffn] \
            or not launches["flash_attention"] \
            or not (launches["gemm_aie"] + launches["gemm_tb_final"]):
        raise RuntimeError(f"train cross-device {arch}: card launches "
                           f"{launches}, plain versions {plain}")
    worst = {}
    pairs = [("loss", c_m["loss"], g_m["loss"]),
             ("grad_norm", c_m["grad_norm"], g_m["grad_norm"])]
    moments = [(f, getattr(c_state.opt, f), getattr(g_state.opt, f))
               for f in c_state.opt._fields if f != "step"]
    for tag, c_tree, g_tree in [("grad", c_m["grads"], g_m["grads"]),
                                ("param", c_state.params, g_state.params)
                                ] + moments:
        pairs += [(tag, c, g) for c, g in zip(tree_leaves(c_tree),
                                              tree_leaves(g_tree))]
    for tag, c, g in pairs:
        torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=1e-4)
        worst[tag] = max(worst.get(tag, 0.0),
                         (g.cpu() - c).abs().max().item())
    lr, clear_n, all_n = float(c_m["lr"]), 0, 0
    for p0, c, g, gc, gg in zip(*(tree_leaves(t) for t in (
            state.params, c_state.params, g_state.params, c_m["grads"],
            g_m["grads"]))):
        clear = (gc.abs() > 1e-5) & (gg.cpu().abs() > 1e-5)
        uc, ug = ((c - p0) / lr)[clear], ((g.cpu() - p0) / lr)[clear]
        torch.testing.assert_close(ug, uc, atol=1e-2, rtol=0)
        if clear.any():
            worst["update/lr"] = max(worst.get("update/lr", 0.0),
                                     (ug - uc).abs().max().item())
        clear_n, all_n = clear_n + int(clear.sum()), all_n + clear.numel()
    if clear_n < all_n / 2:
        raise RuntimeError(f"train cross-device {arch}: only {clear_n} of "
                           f"{all_n} gradient elements clear of zero")
    again_state, again_m = step(to_device(state, "cuda"),
                                to_device(batch, "cuda"))
    same = [torch.equal(a, b) for a, b in zip(
        tree_leaves(dict(grads=g_m["grads"], params=g_state.params)),
        tree_leaves(dict(grads=again_m["grads"],
                         params=again_state.params)))]
    deterministic = all(same) and torch.equal(g_m["loss"], again_m["loss"])
    log(f"train cross-device: {cfg.name} one {optimizer} step (f32, lr "
        f"3e-5), card vs CPU max abs err: " + ", ".join(
            f"{k} {v:.2e}" for k, v in worst.items())
        + f" (tolerance 1e-4; update/lr 1e-2 on the {clear_n} of {all_n} "
        f"elements whose |grad| > 1e-5); card launches {launches}; two "
        f"card steps from one state equal bit for bit: {deterministic} "
        f"({sum(same)} of {len(same)} gradient and parameter leaves)")
    return {"config": cfg.name, "optimizer": optimizer,
            "max_abs_err": worst, "launches": launches,
            "deterministic": deterministic}


def train_phase(cfg, card, ckpt_dir, telemetry_base=None):
    """``repro_torch.launch.train.train`` on smollm-360m at full width in
    bf16: TRAIN_STEPS AdamW steps of TRAIN_BATCH x TRAIN_SEQ tokens from
    seed 0, checkpointed into ``ckpt_dir`` every RESUME_AT steps (the
    saves write on a thread during the later steps; the resume phase
    restarts from the first).  Kernel counts and the executed plans are set to 0 just
    before the run and read, then set to 0 again, after every step: each
    step's launches must equal its executed plans (B1, B2, B6's chunks),
    B3 twice a layer (forward and remat recompute), no decode kernel and
    no plain version; B2, B3 and B6 must launch in every step.  Every
    step's loss and grad norm must be finite and every parameter leaf's
    gradient at step 0 finite and non-zero.  With ``telemetry_base`` the
    run records telemetry: one ``train.step`` span a step, whose ms must
    agree with the step's wall ms within 5 % (the span waits for the
    loss), exported to ``chiprun_out/telemetry_base``."""
    if TS.select_optimizer(cfg) != "adamw":
        raise RuntimeError(f"{cfg.name} would not train with AdamW")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops = cfg.model_flops(tokens, training=True)
    rows, out = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with PlanRecorder() as rec, TransposeRecorder() as tr:
        def on_step(step, state, m, times):
            launches = counts()
            plain = {n: p.launches for n, (_, p, _, _) in KERNELS.items()}
            want = dict({n: 0 for n in launches}, **rec.implied())
            want["flash_attention"] = 2 * cfg.n_layers
            executed = sum(rec.plans.values())
            if executed != train_gemms_per_step(cfg):
                raise RuntimeError(f"train step {step}: {executed} GEMMs "
                                   f"ran, expected "
                                   f"{train_gemms_per_step(cfg)}")
            if launches != want or any(plain.values()):
                raise RuntimeError(f"train step {step}: launches {launches}"
                                   f" (expected {want}), plain versions "
                                   f"{plain}")
            for k in ("gemm_gated", "flash_attention", "gemm_tb_final"):
                if not launches[k]:
                    raise RuntimeError(f"train step {step}: {k} never ran")
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gn)):
                raise RuntimeError(f"train step {step}: loss {loss}, "
                                   f"grad norm {gn}")
            if step == 0:
                for key, g in _paths(m["grads"]):
                    if not torch.isfinite(g.float()).all() \
                            or not g.float().abs().sum() > 0:
                        raise RuntimeError(f"train step 0: the gradient of "
                                           f"{key} is zero or non-finite")
            rows.append({
                "step": step, "loss": loss, "grad_norm": gn,
                "lr": float(m["lr"]), "wall_ms": times["wall_ms"],
                "device_ms": times["device_ms"],
                "tokens_per_s": tokens / times["wall_ms"] * 1e3,
                "model_flop_share": flops / (times["wall_ms"] * 1e-3)
                / PEAK_OPS[torch.bfloat16],
                "launches": launches, "gemms_executed": executed})
            out["step_plans"], out["step_views"] = dict(rec.plans), \
                dict(tr.views)
            if step == TRAIN_STEPS - 1:        # for the resume phase
                out["final_params"] = map_tree(
                    lambda t: t.detach().cpu(), state.params)
            log(f"train step {step}: loss {loss:.4f} gnorm {gn:.3f}; wall "
                f"{times['wall_ms']:.1f} ms, device {times['device_ms']:.1f} "
                f"ms (CUDA events), {rows[-1]['tokens_per_s']:.0f} tok/s, "
                f"model-FLOP share {rows[-1]['model_flop_share']:.2%} of "
                f"989 TFLOP/s; launches {launches} [{card}]")
            reset_counters()
            rec.plans = {}
            tr.views = {}

        t0 = time.perf_counter()
        trec = telemetry.enable(telemetry.Recorder()) if telemetry_base \
            else None
        try:
            final = train_launch.train(
                cfg, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                global_batch=TRAIN_BATCH, seed=0, device="cuda",
                ckpt_dir=ckpt_dir, ckpt_every=RESUME_AT, on_step=on_step,
                return_grads=True)
        finally:
            telemetry.disable()
        seconds = time.perf_counter() - t0
    if trec is not None:
        spans = [e for e in trec.events if e["name"] == "train.step"]
        if [e["attrs"]["step"] for e in spans] != list(range(TRAIN_STEPS)):
            raise RuntimeError(f"train telemetry: spans {spans}")
        for e, r in zip(spans, rows):
            r["span_ms"] = e["dur"] * 1e3
            if abs(r["span_ms"] - r["wall_ms"]) > 0.05 * r["wall_ms"]:
                raise RuntimeError(f"train step {r['step']}: span "
                                   f"{r['span_ms']:.1f} ms, wall "
                                   f"{r['wall_ms']:.1f} ms")
        paths = trec.export(str(ROOT / "chiprun_out" / telemetry_base))
        out["telemetry"] = {
            "artifacts": [str(pathlib.Path(x).relative_to(ROOT))
                          for x in paths],
            "events": len(trec.events),
            "span_ms": [r["span_ms"] for r in rows],
            "counters": trec.snapshot()["counters"]}
        log("train telemetry: train.step spans "
            + ", ".join(f"{r['span_ms']:.1f}" for r in rows)
            + " ms against wall " + ", ".join(f"{r['wall_ms']:.1f}"
                                              for r in rows)
            + f" ms; {len(trec.events)} events; wrote "
            + ", ".join(out["telemetry"]["artifacts"]))
    peak = torch.cuda.max_memory_allocated()
    steady = rows[1:]
    out.update({"config": cfg.name, "dtype": cfg.dtype, "steps": rows,
                "final": final, "seconds": seconds,
                "tokens_per_step": tokens, "model_flops_per_step": flops,
                "peak_memory_bytes": peak,
                "launches": {k: sum(r["launches"][k] for r in rows)
                             for k in rows[0]["launches"]}})
    for key in ("wall_ms", "device_ms", "tokens_per_s", "model_flop_share"):
        out[f"steady_{key}"] = float(np.median([r[key] for r in steady]))
    log(f"train {cfg.name} bf16 b {TRAIN_BATCH} x s {TRAIN_SEQ}, AdamW, "
        f"steps 1-{TRAIN_STEPS - 1} (median): wall "
        f"{out['steady_wall_ms']:.1f} ms, device "
        f"{out['steady_device_ms']:.1f} ms, "
        f"{out['steady_tokens_per_s']:.0f} tok/s, model-FLOP share "
        f"{out['steady_model_flop_share']:.2%} ({flops / 1e12:.2f} TFLOP a "
        f"step over 989 TFLOP/s); peak memory {peak / 1e9:.2f} GB "
        f"(max_memory_allocated); launches a step "
        f"{rows[-1]['launches']} [{card}]")
    return out


def _paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{pre}/{k}")
        else:
            yield f"{pre}/{k}", v


def transpose_copy_phase(views, card):
    """Device time of the contiguous copies the backward's strided
    operands cost in one training step (each view shape timed on its
    own, times its count in the step)."""
    total, rows = 0.0, []
    for (shape, dtype), n in sorted(views.items(), key=str):
        def make(shape=shape, dtype=dtype):
            return (rand(shape[::-1], dtype).T,), {}
        first = make()
        copies = max(1, min(64, math.ceil(COLD_BYTES / nbytes(first[0][0]))))
        inputs = [first] + [make() for _ in range(copies - 1)]
        ms = device_ms(lambda t: t.contiguous(), inputs)
        del inputs
        rows.append({"shape": list(shape), "dtype": str(dtype),
                     "per_step": n, "ms": ms})
        total += n * ms
    log(f"train: the backward's transposed operands, copied contiguous by "
        f"the kernels' wrappers: {sum(views.values())} copies a step, "
        f"{total:.2f} ms of device time a step [{card}]")
    return {"ms_per_step": total, "views": rows}


def train_kernel_phase(step_plans, attn=True, keep=lambda pl: True):
    """Each distinct GEMM plan one full-width training step executed
    (those ``keep`` takes), on the kernel and tile its HOPPER_H100 plan
    picks, held to its plain version and timed beside torch.matmul
    (weight = its executions in the step); with ``attn``, B3 at smollm-
    360m's b 8 x s 512 (64 launches a step) beside SDPA."""
    distinct = {}     # plans that differ only in how their spec names
    for pl, times in step_plans.items():     # the output dtype run alike
        if pl.spec.grouped or not keep(pl):
            continue
        p = pl.problem
        key = (pl.kernel, pl.m, pl.k, pl.n, p.a_dtype, p.b_dtype,
               p.out_dtype, p.epilogue, pl.tile)
        first, n = distinct.get(key, (pl, 0))
        distinct[key] = (first, n + times)
    cases = {"gemm_aie": [], "gemm_tb": [], "gemm_gated": []}
    for key in sorted(distinct, key=str):
        pl, times = distinct[key]
        ep = pl.spec.epilogue
        dtype = getattr(torch, pl.problem.a_dtype)
        out = getattr(torch, pl.problem.out_dtype)
        name = (f"train {pl.m}x{pl.k}x{pl.n} {ep.key or 'plain'}"
                + (" ->f32" if out == torch.float32 else ""))
        if pl.kernel == "gated":
            cases["gemm_gated"].append(gated_case(name, times, pl.m, pl.k,
                                                  pl.n, dtype))
            continue
        cases["gemm_tb" if pl.kernel == "tb" else "gemm_aie"].append(
            gemm_case(name, times, pl.m, pl.k, pl.n, dtype,
                      residual=ep.residual, bias=ep.bias,
                      act=ep.activation, out_dtype=out,
                      tb=pl.kernel == "tb",
                      tile=pl.tile if pl.kernel == "tb" else None))
    if attn:
        cases["flash_attention"] = [attn_case(
            "train b8 s512 h15/5 d64", 64, TRAIN_BATCH, TRAIN_SEQ, 15, 5,
            64, torch.bfloat16)]
    with torch.inference_mode():
        return {name: check_kernel(name, c) for name, c in cases.items()
                if c}


# ------------------------------------------------------------- resume

#: the resume check restarts smollm-360m's run from its checkpoint at
#: this step and resumes it to TRAIN_STEPS
RESUME_AT = 2


def _tree_spread(a, b) -> float:
    """The largest |a - b| over two trees' matching leaves."""
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def resume_phase(cfg, unbroken, ckpt_dir, card):
    """Checkpoint and resume through ``repro_torch.launch.train.train`` on
    smollm-360m at full width: the unbroken step is first run twice from
    one state (the seed-0 init, batch 0), and the two runs' spread over
    the loss, the parameters and the AdamW moments bounds the check (0:
    bit for bit).  Then train_phase's checkpoint of step TRAIN_STEPS is
    deleted from ``ckpt_dir`` and a second ``train`` call resumes from
    the one of step RESUME_AT to TRAIN_STEPS: its losses and final
    parameters must equal train_phase's unbroken run's within that
    spread."""
    kw = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0,
              device="cuda")
    state, step_fn = train_launch.build(cfg, device=torch.device("cuda"),
                                        total_steps=TRAIN_STEPS, seed=0)
    batch = pipeline.make_batch(
        cfg, pipeline.DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                 seed=0), 0, "cuda")
    (s1, m1), (s2, m2) = (step_fn(state, batch) for _ in range(2))
    spread = max(abs(float(m1["loss"]) - float(m2["loss"])),
                 _tree_spread(s1.params, s2.params),
                 _tree_spread(s1.opt.mu, s2.opt.mu),
                 _tree_spread(s1.opt.nu, s2.opt.nu))
    del state, s1, s2, m1, m2
    torch.cuda.empty_cache()
    saved = Checkpointer(ckpt_dir).all_steps()
    if saved != [RESUME_AT, TRAIN_STEPS]:
        raise RuntimeError(f"resume: the unbroken run saved steps {saved}, "
                           f"expected {[RESUME_AT, TRAIN_STEPS]}")
    directory = pathlib.Path(ckpt_dir)
    disk = sum(f.stat().st_size
               for f in (directory / f"step_{RESUME_AT:08d}").iterdir())
    shutil.rmtree(directory / f"step_{TRAIN_STEPS:08d}")
    resumed = {}

    def on_step(step, state, m, times):
        resumed[step] = float(m["loss"])
        if step == TRAIN_STEPS - 1:
            resumed["params"] = map_tree(lambda t: t.detach().cpu(),
                                         state.params)
    t0 = time.perf_counter()
    train_launch.train(cfg, steps=TRAIN_STEPS, ckpt_dir=ckpt_dir,
                       ckpt_every=RESUME_AT, on_step=on_step, **kw)
    second_s = time.perf_counter() - t0
    want = {r["step"]: r["loss"] for r in unbroken["steps"]}
    if sorted(k for k in resumed if k != "params") \
            != list(range(RESUME_AT, TRAIN_STEPS)):
        raise RuntimeError(f"resume: the resumed run ran steps "
                           f"{sorted(k for k in resumed if k != 'params')}")
    loss_err = max(abs(resumed[k] - want[k])
                   for k in range(RESUME_AT, TRAIN_STEPS))
    param_err = _tree_spread(resumed["params"], unbroken["final_params"])
    if loss_err > spread or param_err > spread:
        raise RuntimeError(f"resume: the resumed run is {loss_err:.3e} "
                           f"(loss) / {param_err:.3e} (parameters) from the "
                           f"unbroken one, beyond the two-run spread "
                           f"{spread:.3e}")
    log(f"resume: {cfg.name} bf16 AdamW, the unbroken run's checkpoint "
        f"of step {RESUME_AT} ({disk / 1e9:.2f} GB on disk) resumed to "
        f"step {TRAIN_STEPS} ({second_s:.1f} s with the restore and two "
        f"saves): steps "
        f"{RESUME_AT}-{TRAIN_STEPS - 1} losses "
        f"{[resumed[k] for k in range(RESUME_AT, TRAIN_STEPS)]} against the "
        f"unbroken {[want[k] for k in range(RESUME_AT, TRAIN_STEPS)]}; max "
        f"|loss| diff {loss_err:.3e}, max |param| diff {param_err:.3e}; one "
        f"step run twice from one state differs by {spread:.3e} "
        + ("(deterministic: the check is bit for bit)" if spread == 0
           else "(the check's bound)") + f" [{card}]")
    return {"config": cfg.name, "resume_at": RESUME_AT,
            "steps": TRAIN_STEPS, "checkpoint_bytes": disk,
            "resumed_run_s": second_s,
            "resumed_losses": {k: resumed[k]
                               for k in range(RESUME_AT, TRAIN_STEPS)},
            "max_loss_diff": loss_err, "max_param_diff": param_err,
            "two_run_spread": spread, "bitwise": spread == 0}


# ------------------------------------------------------- MoE training

#: qwen3-moe-235b-a22b trains at full width with its depth cut to this
#: many layers: at 1 the parameters, their gradients, the clipped
#: gradients and the new parameters (four bf16 trees of 3.73 G elements,
#: 29.9 GB) and Adafactor's f32 temporaries of one 805 M-element expert
#: bank (~16 GB) fit the card; at 2 (~82 GB) they do not
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_STEPS = 3
#: B7 launches of one MoE layer's training step: three forward, three in
#: the remat recompute, the gate's f32 pre-activation recompute and three
#: dA against the transposed banks
B7_PER_LAYER_STEP = 10


def moe_train_gemms_per_step(cfg) -> int:
    """The planned GEMMs of one remat MoE training step: per layer q, k,
    v, o and the f32 router twice (forward and recompute) with their dA
    and dB, the three grouped expert GEMMs twice, the gate's
    pre-activation recompute and three grouped dA; per loss chunk the
    lm_head forward, its recompute, dA and dB."""
    return cfg.n_layers * (2 * 5 + 2 * 5 + B7_PER_LAYER_STEP) \
        + 4 * LOSS_CHUNKS


def moe_train_phase(full, card):
    """``repro_torch.launch.train.train`` on qwen3-moe-235b-a22b at full
    width with its depth cut to MOE_TRAIN_LAYERS, bf16, Adafactor (the
    full model's optimizer), b 8 x s 512, seed 0, MOE_TRAIN_STEPS steps.
    Counts and executed plans are set to 0 before the run and after every
    step: each step's launches must equal its executed plans, B7 launch
    B7_PER_LAYER_STEP times a layer, B3 twice a layer, and no plain
    version run; loss and grad norm finite, every gradient leaf finite
    and non-zero at step 0 (router and banks included).  The last step
    is traced with ``torch.profiler`` (device busy time by kernel
    family, ``tools/train_profile.py``'s summary).  Then the loss and
    gradients at the final parameters are taken twice: whether they
    agree bit for bit says whether the MoE step is deterministic."""
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    optimizer = TS.select_optimizer(full)
    log(f"{full.name} training: full width, depth cut {full.n_layers} -> "
        f"{MOE_TRAIN_LAYERS} layer(s), {optimizer} (the full model's "
        f"optimizer): at 1 layer the parameters, gradients, clipped "
        f"gradients and new parameters (4 x {cfg.param_count() * 2 / 1e9:.2f}"
        f" GB of bf16) and Adafactor's f32 temporaries of one expert bank "
        f"fit 80 GB; at 2 layers they do not")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops = cfg.model_flops(tokens, training=True)
    rows, out, kept = [], {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with PlanRecorder() as rec, TransposeRecorder() as tr:
        def on_step(step, state, m, times):
            if step == MOE_TRAIN_STEPS - 1:
                kept["prof"].__exit__(None, None, None)
            launches = counts()
            plain = {n: p.launches for n, (_, p, _, _) in KERNELS.items()}
            want = dict({n: 0 for n in launches}, **rec.implied())
            want["flash_attention"] = 2 * cfg.n_layers
            executed = sum(rec.plans.values())
            if executed != moe_train_gemms_per_step(cfg):
                raise RuntimeError(f"MoE train step {step}: {executed} "
                                   f"GEMMs ran, expected "
                                   f"{moe_train_gemms_per_step(cfg)}")
            if launches != want or any(plain.values()) \
                    or launches["gemm_grouped"] \
                    != B7_PER_LAYER_STEP * cfg.n_layers:
                raise RuntimeError(f"MoE train step {step}: launches "
                                   f"{launches} (expected {want}, B7 "
                                   f"{B7_PER_LAYER_STEP} a layer), plain "
                                   f"versions {plain}")
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gn)):
                raise RuntimeError(f"MoE train step {step}: loss {loss}, "
                                   f"grad norm {gn}")
            if step == 0:
                for key, g in _paths(m.pop("grads")):
                    if not torch.isfinite(g.float()).all() \
                            or not g.float().abs().sum() > 0:
                        raise RuntimeError(f"MoE train step 0: the gradient "
                                           f"of {key} is zero or non-finite")
                out["step_plans"], out["step_views"] = dict(rec.plans), \
                    dict(tr.views)
                out["group_sizes"] = rec.group_sizes.cpu().tolist()
            m.pop("grads", None)
            rows.append({
                "step": step, "loss": loss, "grad_norm": gn,
                "aux": float(m["aux"]), "lr": float(m["lr"]),
                "wall_ms": times["wall_ms"],
                "device_ms": times["device_ms"],
                "tokens_per_s": tokens / times["wall_ms"] * 1e3,
                "model_flop_share": flops / (times["wall_ms"] * 1e-3)
                / PEAK_OPS[torch.bfloat16], "launches": launches,
                "gemms_executed": executed,
                "traced": step == MOE_TRAIN_STEPS - 1})
            log(f"MoE train step {step}: loss {loss:.4f} gnorm {gn:.3f}; "
                f"wall {times['wall_ms']:.1f} ms, device "
                f"{times['device_ms']:.1f} ms (CUDA events), "
                f"{rows[-1]['tokens_per_s']:.0f} tok/s, model-FLOP share "
                f"{rows[-1]['model_flop_share']:.2%} of 989 TFLOP/s"
                + (" (traced)" if rows[-1]["traced"] else "")
                + f"; launches {launches} [{card}]")
            reset_counters()
            rec.plans = {}
            tr.views = {}
            if step == MOE_TRAIN_STEPS - 1:
                kept["params"] = state.params
            if step == MOE_TRAIN_STEPS - 2:       # trace the last step
                kept["prof"] = train_profile.profile(activities=[
                    train_profile.ProfilerActivity.CPU,
                    train_profile.ProfilerActivity.CUDA])
                kept["prof"].__enter__()

        t0 = time.perf_counter()
        final = train_launch.train(
            cfg, steps=MOE_TRAIN_STEPS, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH, seed=0, device="cuda",
            optimizer=optimizer, on_step=on_step, return_grads=True)
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    profile = train_profile.summarize(kept.pop("prof"))
    # the same loss and gradients twice, at the final parameters
    batch = pipeline.make_batch(
        cfg, pipeline.DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                 seed=0), 0, "cuda")
    (l1, _, g1), (l2, _, g2) = (TS.value_and_grad(kept["params"], cfg, batch)
                                for _ in range(2))
    spread = max(abs(float(l1) - float(l2)), _tree_spread(g1, g2))
    del g1, g2, kept
    reset_counters()
    clean = rows[1:-1] or rows[1:]
    out.update({"config": cfg.name, "layers": MOE_TRAIN_LAYERS,
                "optimizer": optimizer, "dtype": cfg.dtype, "steps": rows,
                "final": final, "seconds": seconds,
                "tokens_per_step": tokens, "model_flops_per_step": flops,
                "peak_memory_bytes": peak, "profile": profile,
                "gradient_two_run_spread": spread,
                "deterministic": spread == 0,
                "launches": {k: sum(r["launches"][k] for r in rows)
                             for k in rows[0]["launches"]}})
    for key in ("wall_ms", "device_ms", "tokens_per_s", "model_flop_share"):
        out[f"steady_{key}"] = float(np.median([r[key] for r in clean]))
    log(f"MoE train {cfg.name} ({MOE_TRAIN_LAYERS} layer) bf16 b "
        f"{TRAIN_BATCH} x s {TRAIN_SEQ}, {optimizer}, untraced steps "
        f"{[r['step'] for r in clean]}: wall {out['steady_wall_ms']:.1f} ms,"
        f" device {out['steady_device_ms']:.1f} ms, "
        f"{out['steady_tokens_per_s']:.0f} tok/s, model-FLOP share "
        f"{out['steady_model_flop_share']:.2%} ({flops / 1e12:.2f} TFLOP a "
        f"step over 989 TFLOP/s); peak memory {peak / 1e9:.2f} GB "
        f"(max_memory_allocated); the loss and gradients taken twice "
        f"differ by {spread:.3e} ("
        + ("deterministic" if spread == 0 else "not deterministic")
        + f") [{card}]")
    if profile is None:
        log("MoE train: the trace holds no device events: device busy "
            "time not measured")
    else:
        busy, window = profile["device_busy_ms"], profile["device_window_ms"]
        log(f"MoE train: traced step {MOE_TRAIN_STEPS - 1}: wall "
            f"{rows[-1]['wall_ms']:.1f} ms, device window {window:.1f} ms, "
            f"busy {busy:.1f} ms, idle {1 - busy / window:.1%} of the "
            f"window; by family [{card}]:")
        train_profile.report(profile, prefix="[chip_smoke]")
    return out


def moe_train_kernel_phase(cfg, sizes, step_plans, card):
    """B7 at the MoE training step's own shapes and group sizes (32768
    routed rows; weight = launches a layer-step): the gate + silu, up and
    down forwards, the gate's f32 pre-activation recompute and the three
    dA (against contiguous transposed banks), each against its plain
    version, ``torch._grouped_mm`` and its bound; the device time of
    copying each transposed bank contiguous (what B7's wrapper does in
    the step); the plain dB (per-expert f32 products over the sizes read
    on the host), from a CUDA graph and eagerly; and the step's f32
    router GEMMs on B1 / B6 (forward, recompute, dA, dB)."""
    bf, f32 = torch.bfloat16, torch.float32
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    m = TRAIN_SEQ * TRAIN_BATCH * cfg.top_k
    rows = int(sum(sizes))
    cases = [
        grouped_case(f"train gate+silu {m}x{d}x{f} (fwd, remat)", 2, sizes,
                     m, d, f, bf, act="silu", timed=True),
        grouped_case(f"train up {m}x{d}x{f} (fwd, remat)", 2, sizes, m, d,
                     f, bf, timed=True),
        grouped_case(f"train down {m}x{f}x{d} (fwd, remat)", 2, sizes, m, f,
                     d, bf, timed=True),
        # exact bf16 products summed in f32 in another order: ~1e-5
        # apart, where an output rounded to bf16 would be ~4e-3 off
        grouped_case(f"train gate pre-activation {m}x{d}x{f} ->f32", 1,
                     sizes, m, d, f, bf, out_dtype=f32, timed=True,
                     tol=1e-4),
        grouped_case(f"train dA gate/up {m}x{f}x{d} (bank transposed)", 2,
                     sizes, m, f, d, bf, timed=True),
        grouped_case(f"train dA down {m}x{d}x{f} (bank transposed)", 1,
                     sizes, m, d, f, bf, timed=True)]
    for c in cases:
        c["moe_weight"] = 0
    with torch.inference_mode():
        checked = {"gemm_grouped": check_kernel("gemm_grouped", cases)}
        copies, db = [], []
        for (k, n), per_step in (((d, f), 2), ((f, d), 1)):
            bank = rand((e, k, n), bf)
            ms = device_ms(lambda w: w.transpose(1, 2).contiguous(),
                           [((bank,), {})])
            copies.append({"bank": [e, k, n], "per_step": per_step,
                           "ms": ms, "bytes": 2 * bank.numel() * 2})
            a, dz = rand((m, k), bf), rand((m, n), f32)
            host = tuple(int(x) for x in sizes)
            inputs = [((a, dz, host, bf), {})]
            byts, ops = rows * (k * 2 + n * 4) + e * k * n * 2, \
                2.0 * rows * k * n
            db.append({
                "shape": f"dB ({e}, {k}, {n}) over {rows} rows",
                "per_step": per_step,
                "ms": device_ms(api._grouped_db, inputs),
                "eager_ms": eager_ms(api._grouped_db, inputs),
                "bytes": byts, "ops": ops,
                "transient_bytes": k * n * 4 + max(sizes) * k * 4,
                # f32 products (as the reference's einsum), at the f32 peak
                "bound_ms": max(byts / PEAK_BYTES,
                                ops / PEAK_OPS[f32]) * 1e3,
                "bound_by": "bytes" if byts / PEAK_BYTES
                >= ops / PEAK_OPS[f32] else "operations"})
            del bank, a, dz
        router = train_kernel_phase(
            step_plans, attn=False,
            keep=lambda pl: pl.problem.a_dtype == "float32")
    copy_ms = sum(c["per_step"] * c["ms"] for c in copies)
    db_ms = sum(r["per_step"] * r["ms"] for r in db)
    db_eager = sum(r["per_step"] * r["eager_ms"] for r in db)
    db_bound = sum(r["per_step"] * r["bound_ms"] for r in db)
    log(f"MoE train: the transposed banks copied contiguous by B7's "
        f"wrapper, {sum(c['per_step'] for c in copies)} a layer-step: "
        + ", ".join(f"({c['bank'][0]}, {c['bank'][1]}, {c['bank'][2]}) "
                    f"{c['ms']:.3f} ms" for c in copies)
        + f"; {copy_ms:.3f} ms a layer-step [{card}]")
    log(f"MoE train: plain dB (per-expert f32 products, no (r, e, k) "
        f"tensor): " + ", ".join(
            f"{r['shape']} {r['ms']:.3f} ms graph / {r['eager_ms']:.3f} ms "
            f"eager, bound {r['bound_ms']:.3f} ms ({r['bound_by']}: "
            f"{r['bytes'] / 1e9:.2f} GB moved, {r['ops'] / 1e9:.1f} f32 "
            f"GFLOP), {r['transient_bytes'] / 1e6:.0f} MB transient"
            for r in db)
        + f"; {db_ms:.3f} ms a layer-step ({db_eager:.3f} eager) against "
        f"a bound of {db_bound:.3f} ms [{card}]")
    checked.update(router)
    return checked, {"transposed_bank_copies": copies,
                     "copy_ms_per_layer_step": copy_ms, "plain_db": db,
                     "db_ms_per_layer_step": db_ms,
                     "db_eager_ms_per_layer_step": db_eager,
                     "db_bound_ms_per_layer_step": db_bound}


def main() -> None:
    global _GEN
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    quant.set_activation_mode("none")
    # a fresh tuning cache for the autotune phases, deleted at exit
    tune_dir = tempfile.mkdtemp(prefix=".tune_cache_", dir=ROOT)
    atexit.register(shutil.rmtree, tune_dir, True)
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tune_dir,
                                                  "tune_cache.json")
    tune.tuning_cache_reset()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    _GEN = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        checked = kernel_phase()
        paged_bitwise = paged_bitwise_phase()
        tb_bitwise = tb_bitwise_phase()
        grouped_bitwise = grouped_bitwise_phase()
        redesign_bitwise = redesign_bitwise_phase()
        checked8 = int8_kernel_phase()
        int8_bitwise = int8_bitwise_phase()
        api_run = api_phase()
    torch.cuda.empty_cache()

    cfg = get_config("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, device="cuda")
    serve = serve_phase(cfg, params, paged=False,
                        telemetry_base="telemetry_smollm_dense")
    paged = serve_phase(cfg, params, paged=True,
                        telemetry_base="telemetry_smollm_paged")
    serve["step"] = step_phase(cfg, params, paged=False, telemetry_on=True)
    paged["step"] = step_phase(cfg, params, paged=True, telemetry_on=True)
    paged.pop("_tokens")
    serve_plans = list(serve.pop("_plans")) + list(paged.pop("_plans"))
    plan_sets = {f"{cfg.name} serve": _plan_keys(serve_plans)}
    report = {cfg.name: report_phase(serve_plans, cfg.name, card)}
    del serve_plans
    tuned = {cfg.name: autotune_phase(cfg, params, serve, card)}
    serve.pop("_tokens")
    n_bit = bit_identity_phase(cfg, params)
    n_paged_bit = paged_bit_identity_phase(cfg, params)
    cross = cross_device_phase()
    cross8 = {mode: cross_device_phase(mode) for mode in INT8_MODES}
    train_cross = train_cross_device_phase()
    ckpt_dir = tempfile.mkdtemp(prefix=".resume_check_", dir=ROOT)
    try:
        train_run = train_phase(cfg, card, ckpt_dir,
                                telemetry_base="telemetry_smollm_train")
        step_plans = train_run.pop("step_plans")
        plan_sets[f"{cfg.name} train step"] = _plan_keys(step_plans)
        train_run["transpose_copies"] = transpose_copy_phase(
            train_run.pop("step_views"), card)
        train_checked = train_kernel_phase(step_plans)
        del step_plans
        torch.cuda.empty_cache()
        resume = resume_phase(cfg, train_run, ckpt_dir, card)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del train_run["final_params"]
    torch.cuda.empty_cache()
    qparams, q_bytes = quantize(params, cfg.name)
    del params
    int8_run = int8_serve_phases(cfg, qparams)
    int8_run.update(q_bytes)
    del qparams
    torch.cuda.empty_cache()

    full = get_config("qwen3-moe-235b-a22b")
    moe_cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    log(f"{full.name}: full width (d {full.d_model}, {full.n_heads}/"
        f"{full.n_kv_heads} heads of {full.hd}, {full.n_experts} experts "
        f"top-{full.top_k}, expert d_ff {full.d_ff}, vocab {full.vocab}, "
        f"bf16), depth cut {full.n_layers} -> {MOE_LAYERS} layers: "
        f"{full.n_layers} layers of bf16 weights (about "
        f"{full.param_count() * 2 / 1e9:.0f} GB) do not fit one 80 GB card")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    moe_params = T.init_params(moe_cfg, gen, device="cuda")
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _leaves(moe_params)) / 1e9
    log(f"{moe_cfg.name} at {MOE_LAYERS} layers: {weights_gb:.1f} GB of "
        f"weights made from seed 0 in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    moe_serve = serve_phase(moe_cfg, moe_params, paged=False,
                            telemetry_base="telemetry_qwen3_moe_dense")
    moe_paged = serve_phase(moe_cfg, moe_params, paged=True)
    moe_serve["step"] = step_phase(moe_cfg, moe_params, paged=False,
                                   telemetry_on=True)
    moe_paged["step"] = step_phase(moe_cfg, moe_params, paged=True)
    moe_paged.pop("_tokens")
    serve_plans = list(moe_serve.pop("_plans")) \
        + list(moe_paged.pop("_plans"))
    plan_sets[f"{moe_cfg.name} serve"] = _plan_keys(serve_plans)
    report[moe_cfg.name] = report_phase(serve_plans, moe_cfg.name, card)
    del serve_plans
    tuned[moe_cfg.name] = autotune_phase(moe_cfg, moe_params, moe_serve,
                                         card)
    moe_serve.pop("_tokens")
    calibration = calibration_phase(plan_sets, card)
    moe_bit = bit_identity_phase(moe_cfg, moe_params)
    moe_paged_bit = paged_bit_identity_phase(moe_cfg, moe_params,
                                             reference="paged")
    # the int8 copy of the same seed-0 weights; the bf16 copy is freed
    moe_q, moe_q_bytes = quantize(moe_params, moe_cfg.name)
    del moe_params
    torch.cuda.empty_cache()
    moe_int8 = int8_serve_phases(moe_cfg, moe_q, reference="paged")
    moe_int8.update(moe_q_bytes)
    del moe_q
    torch.cuda.empty_cache()

    moe_train_cross = train_cross_device_phase(full.name, "adafactor")
    moe_train = moe_train_phase(full, card)
    moe_plans = moe_train.pop("step_plans")
    moe_train["dense_transposed_operands"] = sum(
        moe_train.pop("step_views").values())
    torch.cuda.empty_cache()
    moe_train_checked, moe_train_extra = moe_train_kernel_phase(
        full, moe_train["group_sizes"], moe_plans, card)
    moe_train.update(moe_train_extra)
    del moe_plans
    torch.cuda.empty_cache()

    paths = {cfg.name: (serve, paged), moe_cfg.name: (moe_serve, moe_paged),
             "operator_api": (api_run,), "train": (train_run,),
             f"train {full.name}": (moe_train,)}
    for name, run in tuned.items():         # the tuned plans' serve run
        paths[f"{name} tuned"] = (run["serve"],)
    int8_paths = {}
    for name, run in ((cfg.name, int8_run), (moe_cfg.name, moe_int8)):
        int8_paths[f"{name} w8a16"] = (run["w8a16"]["serve"],
                                       run["w8a16"]["paged_serve"])
        int8_paths[f"{name} w8a8"] = (run["w8a8"]["serve"],)
    paths.update(int8_paths)

    def driven(counter, runs=sum(paths.values(), ())):
        """Launches on the paths the script drives (by default all:
        dense and paged serving of both models in bf16, W8A16 and W8A8,
        and the operator-API phase)."""
        return sum(run["launches"][counter] for run in runs)

    def times(total, timed_on):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        extra = {"dequant_ms": total["dequant_ms"]} \
            if "dequant_ms" in total else {}
        return dict({k: total[k] for k in keys}, timed_on=timed_on, **extra)

    line = []
    for name, (rows, worst, total, moe_total) in checked.items():
        _, _, source, replaces = KERNELS[name]
        counters = [name] + (["gemm_tb_final"] if name == "gemm_tb" else [])
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(driven(c) for c in counters),
            "launches_by_path": {p: sum(driven(c, runs) for c in counters)
                                 for p, runs in paths.items()},
            "max_abs_err": worst, **times(total, TIMED_ON[name])}
        if moe_total is not None and name != "gemm_grouped":
            entry[moe_cfg.name] = times(moe_total, MOE_TIMED_ON[name])
        if name in train_checked:
            _, t_worst, t_total, _ = train_checked[name]
            entry["max_abs_err"] = max(worst, t_worst)
            entry["train"] = times(t_total, TRAIN_TIMED_ON[name])
        if name in moe_train_checked:
            _, t_worst, t_total, _ = moe_train_checked[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], t_worst)
            key = "train" if name == "gemm_grouped" \
                else f"train {full.name}"
            entry[key] = times(t_total, MOE_TRAIN_TIMED_ON[name])
        if name == "gemm_tb":       # two Pallas sites: B6a and B6b
            entry["sites"] = {replaces: driven("gemm_tb"),
                              GEMM_TB_FINAL_SITE: driven("gemm_tb_final")}
        if name in checked8:
            int8_runs = sum(int8_paths.values(), ())
            by_mode = checked8[name]
            entry["int8"] = {
                "launches": sum(driven(c, int8_runs) for c in counters),
                "launches_by_path": {
                    p: sum(driven(c, runs) for c in counters)
                    for p, runs in int8_paths.items()},
                "max_abs_err": max(w for _, w, _, _ in by_mode.values()),
                "cases": [dict({k: r[k] for k in (
                    "case", "max_abs_err", "ms", "plain_ms", "library_ms",
                    "dequant_ms", "bound_ms", "bound_by") if k in r})
                    for rows8, _, _, _ in by_mode.values() for r in rows8]}
            for mode, (_, _, tot, moe_tot) in by_mode.items():
                if tot is not None:
                    entry["int8"][mode] = times(
                        tot, f"smollm-360m: one 8-slot decode step under "
                        f"{mode}" + (", the shape set of gemm_aie"
                                     if name == "gemm_tb" else ""))
                if moe_tot is not None:
                    entry["int8"][f"{moe_cfg.name} {mode}"] = times(
                        moe_tot, f"the 4-layer MoE's 8-slot decode step "
                        f"under {mode}: the GEMMs its plans give this "
                        "kernel")
            if entry["int8"]["launches"] == 0:
                raise RuntimeError(f"{name} was launched on no int8 path "
                                   "the script drives")
        line.append(entry)
    for name in KERNELS:
        if driven(name) == 0:
            raise RuntimeError(f"{name} was launched on no path the script "
                               "drives")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(_public({
        "card": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "kernels": line,
        "cases": {n: rows for n, (rows, *_) in checked.items()},
        "int8_cases": {n: {m: rows for m, (rows, *_) in by.items()}
                       for n, by in checked8.items()},
        "serve": serve, "paged_serve": paged, "int8": int8_run,
        "moe": {"config": moe_cfg.name, "layers": MOE_LAYERS,
                "weights_gb": weights_gb, "serve": moe_serve,
                "paged_serve": moe_paged,
                "bit_identity_requests": moe_bit,
                "paged_bit_identity_requests": moe_paged_bit,
                "paged_bit_identity_reference": "paged solo",
                "int8": moe_int8},
        "train": train_run, "train_cross_device": train_cross,
        "train_cases": {n: rows for n, (rows, *_) in train_checked.items()},
        "resume": resume, "moe_train": moe_train,
        "moe_train_cross_device": moe_train_cross,
        "moe_train_cases": {n: rows for n, (rows, *_) in
                            moe_train_checked.items()},
        "paged_bitwise": paged_bitwise,
        "tb_bitwise": tb_bitwise, "grouped_bitwise_groups": grouped_bitwise,
        "b3_b2_bitwise": redesign_bitwise, "int8_bitwise": int8_bitwise,
        "operator_api": api_run,
        "autotune": tuned, "calibration": calibration,
        "model_vs_measured": report,
        "bit_identity_requests": n_bit,
        "paged_bit_identity_requests": n_paged_bit,
        "cross_device_max_abs_err": cross,
        "cross_device_int8_max_abs_err": cross8,
        "build_seconds": _build.build_seconds,
        "seconds": time.perf_counter() - t_start}), indent=1))
    if _build.build_log:
        (out_dir / "ptxas.log").write_text(_build.build_log)
    log("kernels line: ms / plain_ms / bound_ms / library_ms are summed "
        "over the shapes of the step each entry's timed_on names, the "
        f"{moe_cfg.name} key holds the same for the 4-layer MoE, the "
        "train key for one full-width smollm-360m training step (B7: one "
        f"layer-step of {full.name} training), the train {full.name} key "
        "B1's and B6's f32 router GEMMs of that step, and each GEMM's int8 "
        "object the same for its int8 cases by mode; launches sum the "
        "dense and paged serve runs of both models in bf16, W8A16 and "
        "W8A8, the operator-API phase and both training runs "
        "(launches_by_path splits them)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
