#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; each logs
its seconds, kept under ``phase_seconds`` in the JSON):

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
   of 128; the f32 router GEMMs (qwen3-moe at decode, in a 300-token
   prefill and a 64-token chunk, kimi-k2 at decode) on B1 and on B6 at
   its 'tb' plan's tile whichever the plan takes, and one f32 W8A16
   case on each, every f32 row beside the chain floor of its k (k
   dependent fmaf at the latency tools/hopper_probe.cu probe 6 reads,
   at the card's highest SM clock);
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
   then every launch-time shape of B3 (rows a CTA x keys a ring stage)
   and every B4 grouping (64-key splits a CTA) at the served shapes
   (smollm's, h2o's, recurrentgemma's, whisper's encoder, cross decode
   and self decode, kimi's) must equal the default shape's output bit
   for bit and the plain version within 2e-2, each timed beside SDPA
   and the bound (key ``attn_blocks``);
3b. the int8 paths of B1, B2, B6 and B7 at both models' served shapes
   (smollm-360m's decode step and 300-token prefill, qwen3-moe's decode
   step, with B7's twelve decode and two prefill launches, and prefill):
   W8A16 on all four, W8A8 on B1 and B6, one out-quant case on B1 and on
   B6b, each held against its plain version and timed beside its byte
   or op bound, ``torch._int_mm`` x the scale (W8A8, where its shape
   rules allow) or the unfused dequantize + library call (W8A16); the
   same at the int8 shapes of the paths phases 7e and 10 serve in int8
   (recurrentgemma's RG-LRU in_proj and w_r / w_i, whisper's w_in +
   gelu with and without a bias, its encoder wq over 1500 rows under
   W8A8) and at mamba2's in_proj (n 4384, W8A16); then
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
   chunks, prefix cache on, two requests sharing a 64-token prefix),
   the engine's decode step replayed from a CUDA graph after its first
   burst (``repro_torch.runtime.graphs``; every serve phase below runs
   this captured engine, the card's default):
   each pass runs 193 planned GEMMs, and each kernel must have launched
   exactly as often as the executed plans (B1, B2, or B6's chunks) and
   the steps and prefill chunks say, the other decode kernel and every
   plain version not at all, every replay counted (its captured
   launches added to the counters, its plans announced to the
   recorder; a run that replayed nothing fails); then the graph ==
   eager gate: the trace again through an engine run eagerly
   (``graphs=False``), its tokens equal bit for bit and its launch counts
   equal, its decode tok/s, step ms and TTFT beside the graph's (the
   same gate for qwen3-moe dense, h2o's ring, recurrentgemma, mamba2
   and whisper below); each trace is then served again with
   telemetry on (``repro_torch.telemetry``; both artifacts exported to
   ``chiprun_out/telemetry_*``): one ``serve.request`` span a request,
   the decode bursts' steps summing to the engine's, the serve counters
   equal to its metrics and the greedy tokens equal to the untraced
   run's; then one 8-slot decode step of each cache is timed from
   CUDA-graph replays (device time alone) beside the same step run
   eagerly, which gives the device's idle share of an eager step, the
   step captured as the engine captures it and replayed back to back
   (the idle share of a replayed step), and eagerly again with
   telemetry on;
5b. model against measured: ``telemetry.report.model_vs_measured`` over
   the serve phases' dense plans (modeled us against us measured between
   device syncs; the table in ``chiprun_out/model_vs_measured_*.txt``);
5c. autotune: the dense trace once more untuned with every plan cached
   (the baseline), then with ``tune.enable(8)`` on a fresh tuning cache
   (a directory of the checkout, deleted at exit) twice (the first pass
   searches every GEMM and every B3 / B4 attention plan it plans on the
   card), with
   launches equal to the executed plans (the tuner's samples are not
   executions), greedy tokens equal to the untuned run's bit for bit, no
   B1 / B6 candidate and no attention candidate failing, and a second
   pass over the cache file measuring nothing and keeping every tile
   and block; each tuned plan's analytic and measured winner,
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
   B6 in every step and no plain version (the step consumes its state
   and, from step 1, replays from one CUDA graph: forward, backward and
   update; step 0 is the capture's eager warm-up); each step's wall and
   device
   ms, tokens/s, model-FLOP share and the peak memory printed with the
   card's name and power limit; the device time of the contiguous copies
   of the backward's transposed operands; then every distinct GEMM plan
   of one step, on the kernel and tile it picked, held to its plain
   version and timed beside ``torch.matmul``, and B3 at b 8 x s 512
   beside SDPA;
7c. resume: one smollm-360m step run twice from copies of one state
   (its spread, 0 when bit for bit, bounds the check); phase 7b's run
   checkpoints
   every 2 steps into a directory in the checkout; its step-4
   checkpoint is deleted and ``train(resume=True)`` resumes from step 2
   to 4: the resumed steps' losses and final parameters equal the
   unbroken run's within that spread; the directory is deleted; phase
   7b's run records telemetry: one ``train.step`` span a step within 5 %
   of the step's wall ms; then the train graph gate: three steps from
   one state of the step that returns a new state, the eager consuming
   step and the captured one, equal bit for bit after every step (loss,
   grad norm, every parameter, both AdamW moments) with equal launches,
   each mode's steady step ms, tok/s and model-FLOP share;
7d. with smollm-360m freed, h2o-danube-3-4b at full width, its depth cut
   24 -> 4 layers (bf16, random weights from seed 0; a sliding window of
   4096): phase
   5's dense and paged serve runs with 8 slots of 8192 positions (the
   dense cache a 4096-slot ring), on the serve trace plus a 4000-token
   prompt with 160 new tokens (the ring wraps while it decodes) and a
   5000-token prompt with 32 (its prefill keeps the ring's tail), the
   paged run in 512-token chunks; every executed GEMM and attention plan
   (B3 prefill, B4 over the ring at positions clamped to 4095, B5 with
   the window) accounts for the launches; the decode step timed with
   every slot at position 5000, beside its byte bound; continuous ==
   solo greedy through the ring, paged == paged solo greedy, and the
   5000-token prompt's chunked == unchunked == dense prefill, bit for
   bit; the ring's decode logits against a full 8192-slot cache's
   (B4 masking the window) within the bf16 tolerance; the three
   attention families' plans (``explain()`` and ``attn.plan``); the
   kernel phase holds B3 at the 5000-token windowed prefill, B4 at the
   ring's clamped positions and B5 with the window past position 4096,
   and h2o's GEMMs on B1 / B2 / B6, against their plain versions;
7e. with h2o freed, the recurrent families at full width, their depth
   cut (bf16, random weights from seed 0) on the dense engine, 8 slots x
   4096 positions: recurrentgemma-9b (38 -> 8 layers: 6 RG-LRU and 2
   local-attention layers of head_dim 256, window 2048: the dense cache
   a 2048-slot ring in each local layer) on the serve trace plus a
   2000-token prompt with 96 new tokens (the ring wraps) and a 3000-token
   one with 32 (prefill keeps the ring's tail), then mamba2-370m (48 ->
   8 Mamba-2 layers) on the serve trace plus a 4000-token prompt with 64
   (32 SSD chunks through the state); each with launches equal to the
   executed GEMM and attention plans, the decode step (positions 3000 /
   4000) from CUDA-graph replays beside the eager step and its byte
   bound (weights, ring KV, the recurrent state read and written),
   continuous == solo greedy on every request, bit for bit, and the
   paged engine's refusal; recurrentgemma's weights then quantized to
   int8 (the bf16 copy freed) and served in W8A16 and W8A8 on the dense
   engine (the serve trace, launches == executed plans, the decode step
   at position 3000 beside the bf16 step's, continuous == solo greedy);
   recurrentgemma's ring against a full
   4096-slot cache (every local layer's ring attention equal to the full
   cache's on the same inputs within the bf16 gate, the logits' distance
   recorded) and its local attention's three plans (``explain()``); the
   kernel phase holds B3 at 1 x 3000 (h 16/1,
   d 256, window 2048), B4 over the 2048-slot ring at group 16 and B5 at
   d 256 with the window, in bf16 (timed, beside SDPA and the bound) and
   f32, and both models' decode-step GEMMs on B1 / B2 / B6 (timed) and
   their long prompts' prefill GEMMs (checked);
8. with h2o-danube-3-4b freed, qwen3-moe-235b-a22b at full width with its
   depth cut to 4 layers (printed with the reason; random weights from
   seed 0): phases 5 and 6 again, dense and paged, every MoE layer
   launching B7 three times a pass and no plain version running; its
   paged greedy is held to paged solo greedy (chunked prefill sets the
   expert capacity by the chunk, so it may drop otherwise than a
   whole-prompt prefill), with the dense trace's telemetry run (the MoE
   counters' routed + dropped rows equal tokens x top-k over every MoE
   layer and pass, and equal to an eager engine's run of the same
   trace), 5b and 5c (qwen3's 300 x 4096 x 8192 and 300 x 8192
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
   its depth cut to 3 layers (the deepest whose consuming step the
   dry-run fits in 80 GB with 5 % to spare; eager: MoE training reads the
   group sizes on the host), bf16, Adafactor,
   b 8 x s 512, 3 steps: launches equal the executed plans, B7 10 times a
   layer-step (3 forward, 3 remat, the gate's f32 pre-activation
   recompute, 3 dA), no plain version; wall and device ms, tokens/s,
   model-FLOP share, peak memory, the last step traced (device busy time
   by kernel family), and the gradients at the final parameters taken
   twice (every leaf finite and non-zero; deterministic or not); then
   B7 at that step's shapes and group sizes against its plain version,
   ``torch._grouped_mm`` and its bound, the transposed-bank copies, the
   plain dB, and the f32 router GEMMs on B1 / B6;
10. the encoder-decoder, prefix and last three configs (bf16, random
   weights from seed 0, the dense engine, 8 slots): whisper-medium at
   full width (24 encoder layers over 1500 stub frames, its 24 decoder
   layers cut to 6; 448 positions, its decoder context) on the serve
   trace with each request's own frames, launches equal to the executed
   GEMM and attention plans (each framed admission's encoder and cross
   k / v, every pass's cross-attention on B3), the encoder's share of an
   admission, the decode step at position 400 beside its byte bound
   (decoder weights, self KV and every slot's cross k / v), continuous
   == solo greedy with the frames, the paged engine's refusal, its int8
   copy (the bf16 copy freed) served in W8A16 and W8A8 on the same trace
   with the same gates, and the
   f32 smoke model card vs CPU within 1e-4; then internvl2-76b (depth
   cut 80 -> 8 layers: its 256-embedding prefix prefill + decode held
   to ``forward(prefix_embeds=)`` within 2e-2 of the row's largest
   logit, then served text only), kimi-k2-1t-a32b (61 -> 1 layer: 384
   experts, top-8, head_dim 112), deepseek-67b (95 -> 4) and minitron-8b
   (32 -> 8), each with launches == executed plans, the decode step
   and continuous == solo; kimi-k2 and deepseek-67b then on the page
   pool with the same weights (launches == executed plans with B5 at
   every decode, kimi's at head_dim 112; the paged decode step; paged
   greedy == paged solo for kimi, == dense solo for deepseek); the
   kernel phase holds B3 at whisper's
   encoder, cross-prefill and cross-decode shapes, B3 / B4 at head_dim
   112 and B7 at 384 experts (decode 64 rows, prefill 2400), all timed
   beside SDPA / ``torch._grouped_mm`` and their bounds, B5 at kimi's
   heads (timed beside the gather + SDPA), and every new
   config's decode GEMMs, gate / up and d 128 attention (checked);
11. training the windowed and encoder-decoder families: one AdamW step of
   h2o-danube-3-4b-smoke (64 tokens past its 32-token window) and of
   whisper-medium-smoke on the card against the CPU, as 7b; then
   ``train`` on h2o-danube-3-4b at full width and its full 24 layers
   (the consuming step, captured), b 1 x s 4608 (past its 4096-token
   window; the peak memory reckoned and logged first) and on whisper-medium at full width and depth, b 8 x s
   448 over 1500 stub frames a row, each with the optimizer
   ``select_optimizer`` gives the full-depth config, 3 steps: launches
   equal the executed plans (B3 with the window; non-causal for the
   encoder and the cross-attention), no plain version, losses and grad
   norms finite, every gradient leaf finite and non-zero at the final
   parameters (the steps keep no gradient); step wall ms, tok/s and
   peak memory; then B3 at both training shapes
   against its plain version, SDPA and its bound;
12. two ranks sharing the card (spawned processes, a gloo group, every
   collective on a CUDA tensor staged through pinned host buffers): the
   EP phase, qwen3-moe-235b-a22b's MoE FFN at full width (d 4096, 128
   experts top-8, expert d_ff 1536, bf16) on a (data 1, model 2) mesh,
   64 experts a rank, x 8 x 300 tokens at capacity factor 16: launches
   == executed plans, B7 on every rank, no token dropped, the output ==
   the one-process ``moe_ffn``'s bit for bit, the bank gradients, dx and
   the router gradient within 2e-2 of their largest value; then the DP
   phase, smollm-360m at full width on a (data 2, model 1) mesh under
   ``choose_layout``'s layout, AdamW at lr 1e-2, two steps of b 8 x s
   512 (4 rows a rank): launches == executed plans every step, the loss
   and gradients == the one-process step with a rank's rows a
   microbatch bit for bit, the loss, grad norm, AdamW moments and update
   over lr held to the plain one-process step from the same state; its
   checkpoint (rank 0 writes the gathered state),
   restored by ``remesh_restore`` in this process, equal leaf by leaf
   (SHA-256) to what was saved, and ``launch/serve.py --ckpt-dir`` on it
   giving the greedy tokens the ranks' parameters give in memory
   (key ``dist``);
13. the op counter and the dry-run (``repro_torch.core.op_cost``,
   ``repro_torch.launch.dryrun``): one training step of smollm-360m (b 8
   x s 512, AdamW) and of qwen3-moe-235b-a22b at 3 layers (Adafactor),
   both the consuming step, counted on the card, each against the meta
   trace of the same config
   and batch (run in spawned processes meanwhile): FLOPs, bytes and
   calls equal scope by scope but B7's row scopes (live routed rows on
   the card, capacity rows on meta: printed apart), and the meta peak
   within 10 % of the step's allocator peak; h2o-danube-3-4b training
   at b 1 x s 4608 predicted on meta only, under the card's 80 GB at 24
   layers (beside phase 11's run there) and at 8; then the dry-run's
   ``--measure`` on the
   decode_32k cells of smollm-360m (one rank) and qwen3-moe (rank 0 of
   16): every planned GEMM executed on the card against its model, B1,
   B2, B6 and B7 between them (key ``op_cost``).

Prints a ``{"kernels": [...]}`` line (seven kernels; gemm_tb's launches
sum its two Pallas sites, listed under ``sites``; ``launches_by_path``
splits each count by model and mode; each entry's times sum the step
its ``timed_on`` names, a ``qwen3-moe-235b-a22b`` key holds the 4-layer
MoE step's, an ``h2o-danube-3-4b`` key h2o's decode step (B3: its
5000-token prefill), ``recurrentgemma-9b`` and ``mamba2-370m`` keys their
decode steps' (B3: recurrentgemma's 3000-token prefill; B5: its local
layers' shape, which no served path runs), ``whisper-medium`` and
``kimi-k2-1t-a32b`` keys their decode steps' (kimi's B3: a 300-token
prefill), a ``train`` key the full-width training step's (B7's: the
MoE training layer-step's), a ``train qwen3-moe-235b-a22b`` key B1's and
B6's f32 router GEMMs of that step, B3's ``train h2o-danube-3-4b`` and
``train whisper-medium`` keys its launches at those runs' shapes, and the
four GEMMs' ``int8`` objects hold their int8 cases, ``... tuned`` paths
the autotune phases' second serve runs, ``ep ...`` / ``dp ...`` paths
phase 12's ranks,
step sums by mode and launches on the int8 paths) and the card line
before the last line, which is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import atexit
import collections
import dataclasses
import functools
import gc
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
    DECODE_SPLIT, b3_blocks, cta_shape as attn_cta_shape, decode_blocks,
    decode_grid, decode_live_ctas, flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode, flash_decode_paged, flash_decode_paged_plain,
    flash_decode_plain)
from repro_torch.kernels.gemm_aie import gemm_aie, gemm_aie_plain  # noqa
from repro_torch.kernels import api, attn_api  # noqa: E402
from repro_torch.kernels.gemm_gated import (  # noqa: E402
    cta_tile as gated_cta_tile, gemm_gated, gemm_gated_plain)
from repro_torch.kernels.gemm_grouped import (  # noqa: E402
    cta_tile as grouped_cta_tile, gemm_grouped, gemm_grouped_plain,
    group_metadata, steering_tables)
from repro_torch.kernels.gemm_tb import gemm_tb, gemm_tb_plain  # noqa
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.core import bandwidth, op_cost  # noqa: E402
from repro_torch.core.hardware import F32_FFMA_CYCLES, HOPPER_H100  # noqa
from repro_torch.telemetry import report as treport  # noqa: E402
from repro_torch.tune import autotune, calibrate  # noqa: E402
from repro_torch.tune import measure as tune_measure  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import graphs as G  # noqa: E402
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
    "gemm_aie": (gemm_aie, gemm_aie_plain, "src/repro_torch/csrc/gemm_ws.cuh",
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
    "gemm_tb": (gemm_tb, gemm_tb_plain, "src/repro_torch/csrc/gemm_ws.cuh",
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
#: the same for h2o-danube-3-4b at full width, under its own key
H2O_TIMED_ON = {
    "gemm_aie": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
                "planner gives this kernel",
    "gemm_tb": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
               "planner gives this kernel",
    "gemm_gated": "one 8-slot decode step",
    "flash_attention": "one 5000-token prefill (window 4096)",
    "flash_decode": "one 8-slot decode step over the 4096-slot rings "
                    "(positions clamped to 4095)",
    "flash_decode_paged": "one 8-slot decode step, window 4096, slots past "
                          "position 4096",
}
#: the same for qwen3-moe-235b-a22b's full-width 3-layer training step
MOE_TRAIN_TIMED_ON = {
    "gemm_grouped": "qwen3-moe-235b-a22b training at 3 layers: one "
                    "layer-step's 10 launches (b 8 x s 512, 32768 routed "
                    "rows: the three forwards twice, the gate's f32 "
                    "pre-activation recompute, the three dA on contiguous "
                    "transposed banks)",
    "gemm_aie": "qwen3-moe-235b-a22b training at 3 layers: the step's f32 "
                "router GEMMs (forward, recompute, dA, dB) the HOPPER_H100 "
                "planner gives this kernel",
    "gemm_tb": "qwen3-moe-235b-a22b training at 3 layers: the step's f32 "
               "router GEMMs the HOPPER_H100 planner gives this kernel",
}
#: qwen3-moe-235b-a22b is served at full width with its depth cut to this
#: many layers: 94 layers of bf16 weights (about 470 GB) do not fit one
#: 80 GB card, 4 (about 22.4 GB) do
MOE_LAYERS = 4
#: the windowed model, served at full width (its depth cut to
#: :data:`H2O_LAYERS`)
H2O = "h2o-danube-3-4b"
#: positions a slot may take: twice the 4096-token window, so the dense
#: cache is a 4096-slot ring and the pool pages 8192 positions a slot
H2O_MAX_LEN = 8192
#: the long requests added to the serve trace: a 4000-token prompt whose
#: 160 new tokens wrap the ring, a 5000-token prompt whose prefill keeps
#: the ring's tail
H2O_LONG = ((4000, 160), (5000, 32))
#: the paged trace's prefill chunk
H2O_CHUNK = 512
#: every slot of the timed decode step decodes here, past the window
H2O_STEP_POS = 5000
#: the ring-against-full-cache gate: its slots' prompt lengths (all past
#: the window) and the teacher-forced steps compared
H2O_RING_PROMPTS = (4096, 4100, 4500, 4700, 5000, 5500, 6000, 6100)
H2O_RING_STEPS = 4
#: the recurrent families, served at full width (depth cut to
#: :data:`RG_LAYERS` / :data:`MAMBA_LAYERS`): recurrentgemma-9b (RG-LRU
#: layers and local-attention layers of head_dim 256) and mamba2-370m
#: (Mamba-2 layers)
RG = "recurrentgemma-9b"
MAMBA = "mamba2-370m"
#: positions a slot may take: twice recurrentgemma's 2048-token local
#: window, so each local layer's dense cache is a 2048-slot ring
RG_MAX_LEN = 4096
#: the long requests added to the serve trace: a 2000-token prompt whose
#: 96 new tokens wrap the ring, a 3000-token prompt whose prefill keeps
#: the ring's tail
RG_LONG = ((2000, 96), (3000, 32))
#: every slot of the timed decode step decodes here, past the window
RG_STEP_POS = 3000
#: the ring-against-full-cache gate's prompt lengths (all past the window)
RG_RING_PROMPTS = (2048, 2100, 2300, 2500, 2700, 3000, 3500, 4000)
#: mamba2-370m: a 4000-token prompt (32 SSD chunks carried through the
#: state) with 64 new tokens
MAMBA_MAX_LEN = 4096
MAMBA_LONG = ((4000, 64),)
MAMBA_STEP_POS = 4000
#: the f32 router GEMMs, which the kernel phase times on B1 and on B6 (at
#: the tile its 'tb' plan gives) whichever its plan takes: qwen3-moe's at
#: an 8-slot decode step, a 300-token prefill and a 64-token paged chunk,
#: kimi-k2's at decode
ROUTERS = {"qwen3 decode router f32 8x4096x128": (8, 4096, 128),
           "qwen3 prefill router f32 300x4096x128": (300, 4096, 128),
           "qwen3 chunk router f32 64x4096x128": (64, 4096, 128),
           "kimi decode router f32 8x7168x384": (8, 7168, 384)}
#: the kernels line's per-model keys: the decode step's times by kernel
#: (B3: one prefill of the long prompt)
RG_TIMED_ON = {
    "gemm_aie": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
                "planner gives this kernel",
    "gemm_tb": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
               "planner gives this kernel",
    "gemm_gated": "one 8-slot decode step (38 layers)",
    "flash_attention": "one 3000-token prefill (12 local layers, d 256, "
                       "window 2048)",
    "flash_decode": "one 8-slot decode step over the 2048-slot rings "
                    "(12 local layers, d 256, group 16)",
    "flash_decode_paged": "one 8-slot decode step's 12 local layers at d "
                          "256, window 2048 (B5 is not on the served path: "
                          "the paged engine refuses recurrent kinds)",
}
MAMBA_TIMED_ON = {
    "gemm_aie": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
                "planner gives this kernel",
    "gemm_tb": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
               "planner gives this kernel",
}
#: depth cuts of earlier paths, made when the last five configs joined so
#: the script stays near half its 1200 s limit (at full depth it took
#: 809 s), and halved again when the two-rank phases joined (the script
#: read 1009.0 s on one host, 717.9 s on another): their continuous ==
#: solo checks run each request alone at batch 1, eagerly, at a host
#: cost that grows with the depth.  Widths, windows, rings, traces and
#: gates stay as they were; the kernel phase still weighs its rows by the
#: full-depth models' launches
H2O_LAYERS = 4              # of 24
RG_LAYERS = 8               # of 38: 2 x (rec, rec, local) + (rec, rec)
MAMBA_LAYERS = 8            # of 48


def cut_depth(cfg, layers):
    """``cfg`` with its depth cut to ``layers``, logged with the reason."""
    log(f"{cfg.name}: depth cut {cfg.n_layers} -> {layers} layers to keep "
        "the script near half its time limit (widths, windows and gates "
        "unchanged)")
    return dataclasses.replace(cfg, n_layers=layers)


#: the encoder-decoder and prefix families and the last three configs:
#: whisper-medium at full width (24 encoder layers over 1500 frames, 24
#: decoder layers, cut to 6 by :data:`TIME_CUTS`; 448 positions, its
#: decoder context);
#: internvl2-76b at full width with its depth cut to 8 of 80 layers
#: (about 18 GB of the 152 GB), deepseek-67b to 4 of 95 (about 9 GB of
#: 134 GB), kimi-k2-1t-a32b to 1 of 61 (about 39 GB of 2 TB: 384 experts
#: a layer), minitron-8b at full width (about 20 GB; 32 layers cut to 8
#: by :data:`TIME_CUTS`)
WHISPER = "whisper-medium"
INTERNVL = "internvl2-76b"
DEEPSEEK = "deepseek-67b"
MINITRON = "minitron-8b"
KIMI = "kimi-k2-1t-a32b"
A9_LAYERS = {INTERNVL: 8, DEEPSEEK: 4, KIMI: 1, MINITRON: None}
#: depth cuts made when the two-rank phases joined (the script read
#: 1085.3 s with both at full depth, then 1009.0 s with whisper's decoder
#: at 12 layers on a slower host): their continuous == solo checks run
#: each request alone at batch 1, eagerly, at a host cost that grows with
#: the depth.  whisper-medium keeps its 24 encoder layers; widths,
#: traces and gates stay, and the kernel phase still weighs its rows by
#: the full-depth models' launches
TIME_CUTS = {WHISPER: 6, MINITRON: 8}
#: the last configs also served on the page pool, after their dense run
#: on the same weights, and the reference their paged greedy is held to:
#: deepseek-67b dense solo runs; kimi-k2 (a MoE: a prefill chunk sizes
#: the expert capacity by its tokens) paged solo runs.  kimi's heads (64
#: / 8 of 112) are the B5 shape no other served path launches;
#: internvl2-76b's and minitron-8b's (group 8 and 4 at d 128) are B5's
#: d-128 body at groups its card tests cover, and stay dense here
A9_PAGED = {KIMI: "paged", DEEPSEEK: "dense"}
WHISPER_MAX_LEN = 448
#: every slot of whisper's timed decode step decodes here
WHISPER_STEP_POS = 400
#: the other configs' timed decode step: every slot at this position
A9_STEP_POS = 300
#: internvl2's prefix gate: 60 text tokens prefilled after the 256 patch
#: embeddings, then 4 decoded, each step's logits held to the forward's
PREFIX_TEXT = (60, 64)
WHISPER_TIMED_ON = {
    "gemm_aie": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
                "planner gives this kernel (24 decoder layers: self and "
                "cross q / o, k, v, w_in + gelu, w_out + res; lm_head)",
    "gemm_tb": "one 8-slot decode step's GEMMs that the HOPPER_H100 "
               "planner gives this kernel",
    "flash_attention": "one 8-slot decode step's 24 cross-attention "
                       "launches (8 x 1 query over 1500 encoder keys, "
                       "non-causal, h 16/16, d 64)",
    "flash_decode": "one 8-slot decode step's 24 self-attention launches "
                    "(448-slot cache, h 16/16, d 64)",
}
KIMI_TIMED_ON = {
    "gemm_aie": "one 8-slot decode step's GEMMs (1 layer) that the "
                "HOPPER_H100 planner gives this kernel",
    "gemm_tb": "one 8-slot decode step's GEMMs (1 layer) that the "
               "HOPPER_H100 planner gives this kernel",
    "gemm_grouped": "one 8-slot decode step at 1 layer: gate + silu, up, "
                    "down over 64 routed rows of 384 experts (top-8)",
    "flash_attention": "one 300-token prefill at 1 layer (h 64/8, d 112)",
    "flash_decode": "one 8-slot decode step at 1 layer (1024-slot cache, "
                    "h 64/8, d 112)",
    "flash_decode_paged": "one 8-slot paged decode step at 1 layer (64 "
                          "pages of 16 a slot, h 64/8, d 112)",
}
#: the same for B3 at the full-width training runs' shapes, under "train
#: <model>"
A9_TRAIN_TIMED_ON = {
    H2O: "h2o-danube-3-4b training at 24 layers: one step's 48 launches "
         "(1 x 4608, h 32/8, d 120, window 4096; forward and remat "
         "recompute)",
    WHISPER: "whisper-medium training: one step's 24 encoder launches (8 x "
             "1500 frames, h 16/16, d 64, non-causal; the decoder's self "
             "and cross launches are at other shapes, not timed)",
}
#: the row keys that weight a case in a per-model sum (its launches in
#: that model's step)
WEIGHT_KEYS = ("weight", "moe_weight", "h2o_weight", "rg_weight",
               "mamba_weight", "whisper_weight", "kimi_weight")


#: planned GEMMs a layer of each kind runs in a pass: q, k, v, o, then
#: gate/up and down (attn, local; w_in and w_out of a GELU MLP) or the
#: router and three grouped expert GEMMs (moe); in_proj, w_r, w_i,
#: out_proj, gate/up and down (rec); in_proj and out_proj (ssm)
GEMMS_PER_LAYER = {"attn": 6, "local": 6, "moe": 8, "rec": 6, "ssm": 2}


def gemms_per_pass(cfg) -> int:
    """The planned GEMMs of one decode step, prefill or prefill chunk:
    every layer's, the tail's included, a decoder layer's cross q and o,
    and the lm_head."""
    cross = 2 * cfg.n_layers if cfg.encoder_layers else 0
    return sum(GEMMS_PER_LAYER[k] for k in cfg.layer_pattern) \
        * cfg.repeats + sum(GEMMS_PER_LAYER[k] for k in cfg.tail_pattern) \
        + cross + 1


def encoder_gemms(cfg) -> int:
    """The planned GEMMs a prefill with frames adds: every encoder
    layer's six and each decoder layer's cross k and v."""
    return 6 * cfg.encoder_layers + 2 * cfg.n_layers \
        if cfg.encoder_layers else 0


def attn_windows(cfg):
    """The window of every attention layer in the stack, in order (0:
    full); recurrent layers have none."""
    kinds = list(cfg.layer_pattern) * cfg.repeats + list(cfg.tail_pattern)
    return [T._window(cfg, k) for k in kinds if k in T.ATTN_KINDS]


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


_T_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, with the seconds since the script
    started (a phase's cost is the difference of two stamps)."""
    print(f"[chip_smoke {time.perf_counter() - _T_START:7.1f}s] {msg}",
          flush=True)


class PhaseClock:
    """The seconds of each phase of the run: :meth:`mark` logs the time
    since the previous mark (or the clock's start) as the named phase's
    and keeps it in :attr:`seconds`."""

    def __init__(self):
        self.seconds = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._last
        self._last = now
        log(f"phase {name}: {self.seconds[name]:.1f} s; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
            f"{graph_pool_bytes() / 1e9:.2f} GB of it in CUDA-graph pools")


def graph_pool_bytes() -> int:
    """Bytes allocated in CUDA-graph private pools: the live outputs of
    the graphs still held."""
    return sum(seg["allocated_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


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
        if activation == "gelu":
            x = F.gelu(x, approximate="tanh")
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
    if dtype == torch.float32:      # one fmaf chain over k an element
        extra.setdefault("chain_k", k)
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
            timed=per_step > 0 or m == 300 or dtype == f32, **kw))
    # B6 at the prefill's wo + residual whatever the plan picks: the shape
    # whose B6 time PERF.md §6 holds to a target (under 0.3 ms)
    tile = ops.plan(ops.GemmSpec(epilogue=ops.Epilogue(residual=True),
                                 strategy="tb"), (300, q, d)).tile
    out["gemm_tb"].append(gemm_case(
        f"qwen3 prefill wo+res 300x{q}x{d} (tb)", 0, 300, q, d, bf, tb=True,
        tile=tile, moe_weight=0, timed=True, residual=True))
    return out


def h2o_gemm_cases():
    """B1 or B6, as the HOPPER_H100 planner picks, at each dense GEMM of
    h2o-danube-3-4b's served path and at its plan's tile: a decode step
    of 8 slots (timed; ``h2o_weight`` = launches in one step of the
    24-layer model), a 512-token paged chunk and a 5000-token prefill
    (checked), and the prefill's last-token lm_head.  Returns {kernel:
    [cases]}."""
    bf, f32 = torch.bfloat16, torch.float32
    cfg = get_config(H2O)
    d, kv, ff, V, n_l = cfg.d_model, cfg.n_kv_heads * cfg.hd, cfg.d_ff, \
        cfg.vocab, cfg.n_layers
    shapes = []
    for m, per_step, tag in ((8, 1, "decode"), (512, 0, "chunk"),
                             (5000, 0, "prefill")):
        shapes += [(f"{tag} wq {m}x{d}x{d}", per_step * n_l, m, d, d, {}),
                   (f"{tag} wk/wv {m}x{d}x{kv}", per_step * 2 * n_l, m, d,
                    kv, {}),
                   (f"{tag} wo+res {m}x{d}x{d}", per_step * n_l, m, d, d,
                    {"residual": True}),
                   (f"{tag} down+res {m}x{ff}x{d}", per_step * n_l, m, ff,
                    d, {"residual": True})]
    shapes += [(f"decode lm_head 8x{d}x{V}", 1, 8, d, V,
                {"out_dtype": f32}),
               (f"prefill lm_head 1x{d}x{V}", 0, 1, d, V,
                {"out_dtype": f32})]
    out = {"gemm_aie": [], "gemm_tb": []}
    for name, per_step, m, k, n, kw in shapes:
        spec = ops.GemmSpec(out_dtype=kw.get("out_dtype", bf),
                            epilogue=ops.Epilogue(
                                residual=kw.get("residual", False)))
        tile = ops.plan(spec, (m, k, n)).tile
        tb = tile.strategy == "tb"
        out["gemm_tb" if tb else "gemm_aie"].append(gemm_case(
            "h2o " + name, 0, m, k, n, bf, tb=tb, tile=tile if tb else None,
            h2o_weight=per_step, timed=per_step > 0, **kw))
    return out


def step_gemm_cases(tag, shapes, weight_key):
    """B1 or B6, as the HOPPER_H100 planner picks, at the plan's tile, for
    each (name, launches in one decode step, m, k, n, extra) of
    ``shapes``: timed where it runs in the decode step (``weight_key`` =
    those launches), checked only elsewhere (prefill shapes, and every
    shape when ``weight_key`` is None).  An ``extra`` may set the
    operands' ``dtype`` (default bf16).  Returns {kernel: [cases]}."""
    bf = torch.bfloat16
    out = {"gemm_aie": [], "gemm_tb": []}
    for name, per_step, m, k, n, kw in shapes:
        kw = dict(kw)
        dtype = kw.pop("dtype", bf)
        spec = ops.GemmSpec(a_dtype=dtype, b_dtype=dtype,
                            out_dtype=kw.get("out_dtype", dtype),
                            epilogue=ops.Epilogue(
                                residual=kw.get("residual", False),
                                activation=kw.get("act")))
        tile = ops.plan(spec, (m, k, n)).tile
        tb = tile.strategy == "tb"
        out["gemm_tb" if tb else "gemm_aie"].append(gemm_case(
            f"{tag} {name}", 0, m, k, n, dtype, tb=tb,
            tile=tile if tb else None, timed=per_step > 0,
            **({weight_key: per_step} if weight_key else {}), **kw))
    return out


def recurrent_gemm_cases():
    """The dense GEMMs of recurrentgemma-9b's and mamba2-370m's served
    paths: each decode step's (8 slots, timed, weighted by launches in
    one step of the full-depth model) and the long prompts' prefill
    shapes (3000 and 4000 tokens, checked)."""
    f32 = torch.float32
    rg, mb = get_config(RG), get_config(MAMBA)
    d, w, ff, kv, V = rg.d_model, rg.lru_width, rg.d_ff, \
        rg.n_kv_heads * rg.hd, rg.vocab
    n_rec = rg.layer_pattern.count("rec") * rg.repeats \
        + rg.tail_pattern.count("rec")
    n_loc = rg.layer_pattern.count("local") * rg.repeats
    m = 8
    rg_shapes = [
        (f"decode rec in_proj {m}x{d}x{2 * w}", n_rec, m, d, 2 * w, {}),
        (f"decode wq / w_r / w_i / out_proj {m}x{d}x{d}",
         n_loc + 3 * n_rec, m, d, d, {}),
        (f"decode wk/wv {m}x{d}x{kv}", 2 * n_loc, m, d, kv, {}),
        (f"decode wo+res {m}x{d}x{d}", n_loc, m, d, d, {"residual": True}),
        (f"decode down+res {m}x{ff}x{d}", rg.n_layers, m, ff, d,
         {"residual": True}),
        (f"decode lm_head {m}x{d}x{V}", 1, m, d, V, {"out_dtype": f32})]
    p = RG_LONG[1][0]
    rg_shapes += [
        (f"prefill rec in_proj {p}x{d}x{2 * w}", 0, p, d, 2 * w, {}),
        (f"prefill wq / w_r / w_i / out_proj {p}x{d}x{d}", 0, p, d, d, {}),
        (f"prefill wk/wv {p}x{d}x{kv}", 0, p, d, kv, {}),
        (f"prefill down+res {p}x{ff}x{d}", 0, p, ff, d, {"residual": True}),
        (f"prefill lm_head 1x{d}x{V}", 0, 1, d, V, {"out_dtype": f32})]
    dd = M2.dims(mb.d_model, mb.ssm_state)
    md, mV, p = mb.d_model, mb.vocab, MAMBA_LONG[0][0]
    mb_shapes = [
        (f"decode in_proj {m}x{md}x{dd['proj_out']}", mb.n_layers, m, md,
         dd["proj_out"], {}),
        (f"decode out_proj {m}x{dd['d_inner']}x{md}", mb.n_layers, m,
         dd["d_inner"], md, {}),
        (f"decode lm_head {m}x{md}x{mV}", 1, m, md, mV, {"out_dtype": f32}),
        (f"prefill in_proj {p}x{md}x{dd['proj_out']}", 0, p, md,
         dd["proj_out"], {}),
        (f"prefill out_proj {p}x{dd['d_inner']}x{md}", 0, p, dd["d_inner"],
         md, {})]
    a = step_gemm_cases("rg", rg_shapes, "rg_weight")
    b = step_gemm_cases("mamba2", mb_shapes, "mamba_weight")
    return {k: a[k] + b[k] for k in a}


def a9_gemm_cases():
    """The dense GEMMs of the last five configs' served paths, on B1 or
    B6 as the HOPPER_H100 planner picks: whisper-medium's decode step
    (timed, ``whisper_weight`` = launches in one 8-slot step of the 24
    decoder layers) and its framed prefill's encoder and cross k / v
    shapes (1500 frames, checked); kimi-k2's decode step at 1 layer
    (timed, ``kimi_weight``); internvl2-76b's, deepseek-67b's and
    minitron-8b's decode-step shapes (checked)."""
    f32 = torch.float32
    wh, ki = get_config(WHISPER), get_config(KIMI)
    d, ff, V, n, F_ = wh.d_model, wh.d_ff, wh.vocab, wh.n_layers, \
        wh.encoder_seq
    out = step_gemm_cases("whisper", [
        (f"decode wq / wk / wv / cross wq 8x{d}x{d}", 4 * n, 8, d, d, {}),
        (f"decode wo+res / cross wo+res 8x{d}x{d}", 2 * n, 8, d, d,
         {"residual": True}),
        (f"decode w_in+gelu 8x{d}x{ff}", n, 8, d, ff, {"act": "gelu"}),
        (f"decode w_out+res 8x{ff}x{d}", n, 8, ff, d, {"residual": True}),
        (f"decode lm_head 8x{d}x{V}", 1, 8, d, V, {"out_dtype": f32}),
        (f"encoder wq / wk / wv, cross wk / wv {F_}x{d}x{d}", 0, F_, d, d,
         {}),
        (f"encoder w_in+gelu {F_}x{d}x{ff}", 0, F_, d, ff, {"act": "gelu"}),
        (f"encoder w_out+res {F_}x{ff}x{d}", 0, F_, ff, d,
         {"residual": True})], "whisper_weight")
    d, q, kv, V = ki.d_model, ki.n_heads * ki.hd, ki.n_kv_heads * ki.hd, \
        ki.vocab
    more = [step_gemm_cases("kimi", [
        (f"decode wq 8x{d}x{q}", 1, 8, d, q, {}),
        (f"decode wk/wv 8x{d}x{kv}", 2, 8, d, kv, {}),
        (f"decode wo+res 8x{q}x{d}", 1, 8, q, d, {"residual": True}),
        (f"decode router f32 8x{d}x{ki.n_experts}", 1, 8, d, ki.n_experts,
         {"dtype": f32}),
        (f"decode lm_head 8x{d}x{V}", 1, 8, d, V, {"out_dtype": f32})],
        "kimi_weight")]
    for name in (INTERNVL, DEEPSEEK, MINITRON):
        c = get_config(name)
        d, q, kv, ff, V = c.d_model, c.n_heads * c.hd, \
            c.n_kv_heads * c.hd, c.d_ff, c.vocab
        more.append(step_gemm_cases(name.split("-")[0], [
            (f"decode wq 8x{d}x{q}", 0, 8, d, q, {}),
            (f"decode wk/wv 8x{d}x{kv}", 0, 8, d, kv, {}),
            (f"decode wo+res 8x{q}x{d}", 0, 8, q, d, {"residual": True}),
            (f"decode down+res 8x{ff}x{d}", 0, 8, ff, d,
             {"residual": True}),
            (f"decode lm_head 8x{d}x{V}", 0, 8, d, V, {"out_dtype": f32})],
            None))
    for extra in more:
        for k in out:
            out[k] += extra[k]
    return out


def a9_attention_cases():
    """B2 to B5 and B7 at the last five configs' shapes: whisper-medium's
    encoder (1 x 1500 x 1500), cross-attention prefill (1 x 200 x 1500)
    and decode (8 x 1 x 1500) on B3 (non-causal, h 16/16, d 64, timed
    beside SDPA) and its self-attention decode on B4 (448 slots); kimi-k2
    at head_dim 112 (B3 prefill, B4 decode timed; B5 checked) and its
    expert GEMMs on B7 at 384 experts, top-8 (an 8-slot decode step's 64
    routed rows, capacity 8, and a 300-token prefill's 2400, timed
    beside ``torch._grouped_mm``); the dense configs' gate / up on B2
    and their d 128 group-8 attention (checked).  Returns {kernel:
    [cases]}."""
    bf = torch.bfloat16
    wh, ki = get_config(WHISPER), get_config(KIMI)
    wd = dict(hq=wh.n_heads, hkv=wh.n_kv_heads, d=wh.hd)
    kd = dict(hq=ki.n_heads, hkv=ki.n_kv_heads, d=ki.hd)
    F_ = wh.encoder_seq
    pos = [17, 40, 95, 160, 210, 300, 333, 363]
    w_pos = [5, 60, 120, 200, 300, 350, 400, 447]
    out = {
        "flash_attention": [
            attn_case(f"whisper encoder 1x{F_} h16/16 d64 non-causal", 0,
                      1, F_, dtype=bf, causal=False, timed=True, **wd),
            attn_case(f"whisper cross prefill 1x200x{F_} h16/16 d64", 0, 1,
                      200, dtype=bf, skv=F_, causal=False, timed=True, **wd),
            attn_case(f"whisper cross decode 8x1x{F_} h16/16 d64", 0, 8, 1,
                      dtype=bf, skv=F_, causal=False, timed=True,
                      whisper_weight=wh.n_layers, **wd),
            attn_case(f"whisper f32 cross decode 8x1x{F_} h16/16 d64", 0,
                      8, 1, dtype=torch.float32, skv=F_, causal=False, **wd),
            attn_case("kimi prefill 1x300 h64/8 d112", 0, 1, 300, dtype=bf,
                      timed=True, kimi_weight=1, **kd),
        ],
        "flash_decode": [
            decode_case(f"whisper decode 8 slots S{WHISPER_MAX_LEN} h16/16 "
                        "d64", 0, w_pos, WHISPER_MAX_LEN, dtype=bf,
                        timed=True, whisper_weight=wh.n_layers, **wd),
            decode_case("kimi decode 8 slots S1024 h64/8 d112", 0, pos, 1024,
                        dtype=bf, timed=True, kimi_weight=1, **kd),
        ],
        "flash_decode_paged": [
            paged_case("kimi decode 8 slots 64x16 h64/8 d112", 0, pos, 16,
                       64, dtype=bf, timed=True, kimi_weight=1, **kd),
        ],
        "gemm_gated": [],
    }
    for name in (INTERNVL, DEEPSEEK, MINITRON):
        c = get_config(name)
        tag = name.split("-")[0]
        hd = dict(hq=c.n_heads, hkv=c.n_kv_heads, d=c.hd)
        out["gemm_gated"].append(gated_case(
            f"{tag} decode gate/up 8x{c.d_model}x{c.d_ff}", 0, 8, c.d_model,
            c.d_ff, bf))
        out["flash_attention"].append(attn_case(
            f"{tag} prefill 1x300 h{c.n_heads}/{c.n_kv_heads} d{c.hd}", 0,
            1, 300, dtype=bf, **hd))
        out["flash_decode"].append(decode_case(
            f"{tag} decode 8 slots S1024 h{c.n_heads}/{c.n_kv_heads} "
            f"d{c.hd}", 0, pos, 1024, dtype=bf, **hd))
    d, ff, e, k = ki.d_model, ki.d_ff, ki.n_experts, ki.top_k
    dec = routed_sizes(8, e, k, 8, seed=23)
    pre = routed_sizes(300, e, k, 8, seed=24)
    kw = dict(weight=0, kimi_weight=1, timed=True)
    out["gemm_grouped"] = [
        grouped_case(f"kimi decode gate+silu 64x{d}x{ff}", sizes=dec, m=64,
                     k=d, n=ff, dtype=bf, act="silu", **kw),
        grouped_case(f"kimi decode up 64x{d}x{ff}", sizes=dec, m=64, k=d,
                     n=ff, dtype=bf, **kw),
        grouped_case(f"kimi decode down 64x{ff}x{d}", sizes=dec, m=64, k=ff,
                     n=d, dtype=bf, **kw),
        grouped_case(f"kimi prefill gate+silu 2400x{d}x{ff}", 0, pre, 2400,
                     d, ff, bf, act="silu", timed=True),
        grouped_case(f"kimi prefill down 2400x{ff}x{d}", 0, pre, 2400, ff,
                     d, bf, timed=True),
    ]
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
    computes the function (skv == s, or no causal mask: cross-attention;
    a window as a boolean mask made once, outside the timed calls).  The
    operations count the (q, key) pairs the mask keeps."""
    skv = skv or s
    mask = None
    if window:
        rows = torch.arange(s, device="cuda")[:, None] + (skv - s)
        keys = torch.arange(skv, device="cuda")[None, :]
        mask = (keys <= rows) & (keys > rows - window)

    def make():
        return (rand((b, s, hq, d), dtype), rand((b, skv, hkv, d), dtype),
                rand((b, skv, hkv, d), dtype)), \
            {"causal": causal, "window": window}

    def library(q, k, v, causal, window):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    pairs = attn_api.AttnProblem(mode="prefill", b=b, sq=s, skv=skv, hq=hq,
                                 hkv=hkv, d=d, causal=causal,
                                 window=window).attended()

    def cost(args, kw):
        q, k, v = args
        return nbytes(q, k, v, q), 4.0 * hq * d * pairs
    shape = attn_cta_shape(b, s, hq, hkv, d, dtype)
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=library if skv == s or not causal else None,
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


def _visible_keys(pos, S, window):
    """Keys the slots at ``pos`` see in a cache of ``S`` keys, summed."""
    return sum(len(range(max(0, p - window + 1) if window else 0,
                         min(S, p + 1))) for p in pos)


def _decode_mask(p, S, window):
    keys = torch.arange(S, device="cuda")[None, :]
    mask = keys <= p[:, None]
    if window:
        mask &= keys > p[:, None] - window
    return mask[:, None, None, :]


def decode_case(name, weight, pos, S, hq, hkv, d, dtype, *, window=0,
                **extra):
    b = len(pos)

    def make():
        p = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
        return (rand((b, hq, d), dtype), rand((b, S, hkv, d), dtype),
                rand((b, S, hkv, d), dtype), p), {"window": window}

    def library(q, k, v, p, window):
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=_decode_mask(p, S, window), enable_gqa=True)[:, :, 0]

    def cost(args, kw):
        q = args[0]
        keys = _visible_keys(pos, S, window)        # rows the slots read
        row = hkv * d * q.element_size()
        return nbytes(q, q) + 2 * keys * row, 4.0 * hq * d * keys
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=library, cost=cost,
                body=decode_body(pos, S, hq, hkv, d, dtype, window), **extra)


def paged_case(name, weight, pos, ps, max_pages, hq, hkv, d, dtype, *,
               window=0, sink_row=None, **extra):
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
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=_decode_mask(p, S, window), enable_gqa=True)[:, :, 0]

    def cost(args, kw):
        q, table = args[0], args[3]
        keys = _visible_keys(pos, S, window)        # rows the slots read
        row = hkv * d * q.element_size()
        return nbytes(q, q, table) + 2 * keys * row, 4.0 * hq * d * keys
    return dict(name=name, weight=weight, dtype=dtype, make=make,
                library=None, two_calls=gather_sdpa, cost=cost,
                body=decode_body(pos, S, hq, hkv, d, dtype, window), **extra)


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
                 bias=False, timed=False, out_dtype=None, tol=None,
                 **extra):
    """A case for B7 at the CTA shape it picks for m rows over the
    experts; ``sizes`` are the group sizes, ``m`` >= their sum the
    rows; the output is ``out_dtype`` (default A's ``dtype``); ``tol``
    (atol = rtol) overrides the one A's dtype gives; ``extra`` keys go
    into the case.  The bank is drawn in slices
    (``layers.normal_init``), so kimi-k2's 384 experts (11.3 GB a bank)
    never have an f32 copy beside them."""
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
        return (rand((m, k), dtype),
                L.normal_init(_GEN, (e, k, n), k ** -0.5, dtype), gs), kw

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
                **({"tol": tol} if tol is not None else {}), **extra)


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


@functools.lru_cache(maxsize=None)
def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm, MHz)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def chain_floor_ms(k: int) -> float:
    """The least time of one fmaf chain over ``k`` steps: k times an
    fmaf's latency (``F32_FFMA_CYCLES``, tools/hopper_probe.cu probe 6) at
    the highest SM clock; B1's and B6's f32 bodies run one a C
    element."""
    return k * F32_FFMA_CYCLES / (sm_clock_mhz() * 1e3)


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
        row = {"case": case["name"],
               **{key: case.get(key, 0) for key in WEIGHT_KEYS},
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
            if case.get("chain_k"):
                # the f32 bodies' third floor: k dependent fmaf a chain
                row["chain_floor_ms"] = chain_floor_ms(case["chain_k"])
            del inputs
        rows.append(row)
        lib = row.get("library_ms")
        log(f"  {name:18s} {case['name']:38s} err {row['max_abs_err']:.2e}"
            + (f"  kernel {row['ms']*1e3:8.1f} us  plain "
               f"{row['plain_ms']*1e3:8.1f} us  library "
               + (f"{lib*1e3:8.1f} us" if lib is not None else "       —")
               + f"  bound {row['bound_ms']*1e3:7.1f} us ({row['bound_by']})"
               + (f"  chain {row['chain_floor_ms']*1e3:.1f} us"
                  if "chain_floor_ms" in row else "")
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
    h2o = get_config(H2O)
    h2o_gemms = h2o_gemm_cases()
    hh = dict(hq=h2o.n_heads, hkv=h2o.n_kv_heads, d=h2o.hd)
    ring = h2o.window                   # the dense cache's ring slots
    h2o_pos = [5, 900, 4095, 4096, 4097, 5000, 6100, 8000]
    rg = get_config(RG)
    rh = dict(hq=rg.n_heads, hkv=rg.n_kv_heads, d=rg.hd)
    rw = rg.local_window                # the local layers' ring slots
    rg_pos = [5, 900, 2047, 2048, 2049, 2500, 3000, 4000]
    n_loc = rg.layer_pattern.count("local") * rg.repeats
    rec_gemms = recurrent_gemm_cases()
    a9_gemms = a9_gemm_cases()
    a9 = a9_attention_cases()
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
        ] + [gemm_case(f"{name} (B1)", 0, m, k, n, f32, timed=True)
             for name, (m, k, n) in ROUTERS.items()]
        + moe_gemms["gemm_aie"] + h2o_gemms["gemm_aie"]
        + rec_gemms["gemm_aie"] + a9_gemms["gemm_aie"],
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
        ] + [gemm_case(f"{name} (tb)", 0, m, k, n, f32, tb=True, timed=True)
             for name, (m, k, n) in ROUTERS.items()]
        + moe_gemms["gemm_tb"] + h2o_gemms["gemm_tb"]
        + rec_gemms["gemm_tb"] + a9_gemms["gemm_tb"],
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
            # h2o-danube-3-4b: h2o_weight = launches in one decode step
            gated_case(f"h2o decode gate/up 8x{h2o.d_model}x{h2o.d_ff}", 0,
                       8, h2o.d_model, h2o.d_ff, bf, timed=True,
                       h2o_weight=h2o.n_layers),
            gated_case(f"h2o chunk gate/up 512x{h2o.d_model}x{h2o.d_ff}", 0,
                       512, h2o.d_model, h2o.d_ff, bf),
            gated_case(f"h2o prefill gate/up 5000x{h2o.d_model}x"
                       f"{h2o.d_ff}", 0, 5000, h2o.d_model, h2o.d_ff, bf),
            # recurrentgemma-9b: every layer's MLP (rec and local)
            gated_case(f"rg decode gate/up 8x{rg.d_model}x{rg.d_ff}", 0,
                       8, rg.d_model, rg.d_ff, bf, timed=True,
                       rg_weight=rg.n_layers),
            gated_case(f"rg prefill gate/up {RG_LONG[1][0]}x{rg.d_model}x"
                       f"{rg.d_ff}", 0, RG_LONG[1][0], rg.d_model, rg.d_ff,
                       bf),
        ] + a9["gemm_gated"],
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
            # h2o-danube-3-4b's window: a 5000-token prompt past it
            # (h2o_weight = launches in one prefill) and its last
            # 512-token paged chunk
            attn_case("h2o prefill 1x5000 h32/8 d120 window 4096", 0, 1,
                      5000, dtype=bf, window=h2o.window, timed=True,
                      h2o_weight=h2o.n_layers, **hh),
            attn_case("h2o chunk 512 of 5000 h32/8 d120 window 4096", 0, 1,
                      512, dtype=bf, skv=5000, window=h2o.window, **hh),
            # recurrentgemma-9b's local layers at head_dim 256 (the kD =
            # 256 body): the 3000-token prompt past the window (rg_weight
            # = launches in one prefill), in bf16 and in f32
            attn_case("rg prefill 1x3000 h16/1 d256 window 2048", 0, 1,
                      3000, dtype=bf, window=rw, timed=True,
                      rg_weight=n_loc, **rh),
            attn_case("rg f32 prefill 1x3000 h16/1 d256 window 2048", 0, 1,
                      3000, dtype=f32, window=rw, **rh),
        ] + a9["flash_attention"],
        "flash_decode": [
            decode_case("decode 8 slots S1024 h15/5 d64", 32, pos, 1024,
                        hq, hkv, 64, bf),
            decode_case("edge f32 3 slots S50 h3/1 d20", 0, [0, 17, 49],
                        50, 3, 1, 20, f32),
            dict(decode_case("qwen3 decode 8 slots S1024 h64/4 d128", 0, pos,
                             1024, 64, 4, 128, bf), timed=True,
                 moe_weight=MOE_LAYERS),
            # h2o-danube-3-4b: the dense ring decode (4096 slots at
            # positions clamped to 4095, no window; h2o_weight = launches
            # in one decode step) and a full-length cache with the window
            decode_case("h2o ring decode 8 slots S4096 h32/8 d120, "
                        "positions clamped", 0,
                        [min(p, ring - 1) for p in h2o_pos], ring,
                        dtype=bf, timed=True, h2o_weight=h2o.n_layers, **hh),
            decode_case("h2o decode 8 slots S8192 h32/8 d120 window 4096",
                        0, h2o_pos, 8192, dtype=bf, window=h2o.window, **hh),
            # recurrentgemma-9b: the 2048-slot rings at group 16, d 256
            # (rg_weight = launches in one decode step), in bf16 and f32,
            # and a full-length cache with the window
            decode_case("rg ring decode 8 slots S2048 h16/1 d256, "
                        "positions clamped", 0,
                        [min(p, rw - 1) for p in rg_pos], rw, dtype=bf,
                        timed=True, rg_weight=n_loc, **rh),
            decode_case("rg f32 ring decode 8 slots S2048 h16/1 d256", 0,
                        [min(p, rw - 1) for p in rg_pos], rw, dtype=f32,
                        **rh),
            decode_case("rg decode 8 slots S4096 h16/1 d256 window 2048", 0,
                        rg_pos, 4096, dtype=bf, window=rw, **rh),
        ] + a9["flash_decode"],
        "flash_decode_paged": [
            paged_case("decode 8 slots 64x16 h15/5 d64", 32, pos, 16, 64,
                       hq, hkv, 64, bf),
            paged_case("edge f32 4 slots 7x8 h3/1 d20 w20", 0,
                       [0, 17, 55, 70], 8, 7, 3, 1, 20, f32, window=20,
                       sink_row=2),
            dict(paged_case("qwen3 decode 8 slots 64x16 h64/4 d128", 0, pos,
                            16, 64, 64, 4, 128, bf), timed=True,
                 moe_weight=MOE_LAYERS),
            paged_case("h2o decode 8 slots 512x16 h32/8 d120 window 4096",
                       0, h2o_pos, 16, 512, dtype=bf, window=h2o.window,
                       timed=True, h2o_weight=h2o.n_layers, **hh),
            # head_dim 256 and group 16 with recurrentgemma's window (the
            # paged engine refuses recurrent kinds: B5 takes the shape,
            # no served path runs it there), in bf16 and f32
            paged_case("rg decode 8 slots 256x16 h16/1 d256 window 2048", 0,
                       rg_pos, 16, 256, dtype=bf, window=rw, timed=True,
                       rg_weight=n_loc, **rh),
            paged_case("rg f32 decode 8 slots 256x16 h16/1 d256 window "
                       "2048", 0, rg_pos, 16, 256, dtype=f32, window=rw,
                       **rh),
        ] + a9["flash_decode_paged"],
        # weights = launches in one decode step of the 4-layer MoE
        "gemm_grouped": grouped_cases() + a9["gemm_grouped"],
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


#: B6 tiles the warp-specialised bf16 body runs at its large CTA shapes
#: (one and two consumer warpgroups, wgmma N 128 / 256) and its swapped
#: one (16 rows, 2 and 4 panels of 64 columns)
WS_TB_TILES = [(64, 256, 128), (128, 256, 128), (64, 256, 256),
               (16, 512, 256), (16, 1024, 128)]


def tb_bitwise_phase():
    """B6 == B1, bit for bit: at every dense GEMM shape of both models'
    serve paths (smollm-360m and qwen3-moe-235b-a22b: decode m = 8, a
    300-token prefill, 12- and 16-token prompts, qwen3's 64-token paged
    chunk and last-token lm_head) and an f32 edge shape, in bf16 and f32,
    with each epilogue, at the tile HOPPER_H100's 'tb' plan gives the
    shape, three tiles that give one k-chunk, two, and four or more, and,
    in bf16, :data:`WS_TB_TILES`."""
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
            # (the f32 body takes 32 columns or more)
            tiles = [(pt.bm, pt.bk, pt.bn),
                     (8, 4096, 16 if dtype == torch.bfloat16 else 32),
                     (16, half, 32), (8, 128, 64)]
            if dtype == torch.bfloat16:     # the warp-specialised body's
                tiles += WS_TB_TILES        # large and swapped shapes
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
        f"shapes x bf16/f32 x {len(epilogues)} epilogues x 4 tiles, "
        f"{len(WS_TB_TILES)} more in bf16; k-chunk counts "
        f"{sorted(chunk_counts)})")
    return {"cases": checked, "chunk_counts": sorted(chunk_counts)}


#: (k, n) of the decode GEMMs decode_form_phase times at 8 rows:
#: smollm-360m's wq, wk / wv, w_down, gate and lm_head, h2o-danube-3-4b's wq
#: and w_down
DECODE_FORM_KN = ((960, 960), (960, 320), (2560, 960), (960, 2560),
                  (960, 49152), (3840, 3840), (10240, 3840))


def decode_form_phase():
    """B1's two few-row forms of the warp-specialised bf16 body at 8 rows,
    in turns in this process: the swapped wgmma form (the rows on wgmma's
    N side, 64 columns a CTA: BF16_TILES config 1) and the mma.sync form
    at the columns ``cta_tile``'s split gives (8 to 64 a CTA; ``cta_tile``
    takes the swapped form where that is 64), device time of each
    (CUDA-graph replays over copies past the L2 cache) and their outputs
    bit for bit."""
    from repro_torch.kernels import gemm_aie as aie
    fn = _build.entry("gemm_aie_launch", aie._ARGTYPES)
    bf16, out = torch.bfloat16, []
    for k, n in DECODE_FORM_KN:
        # the mma.sync form at the split cta_tile's rule gives (it takes the
        # swapped form where that is 64 columns)
        mma = next((c for c in (9, 8, 7) if 8 * -(-n // aie.BF16_TILES[c][2])
                    >= 7 * HOPPER_H100.sm_count), 6)

        def launch(a, b, c, config):
            _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), None,
                            None, None, None, 8, n, k, 1, 1, 1, 0, 0, config,
                            2 | 2 << 2, _build.stream_of(a)), "gemm_aie")
        copies = max(2, min(64, math.ceil(COLD_BYTES / (2 * k * (8 + n)))))
        sets = [((rand((8, k), bf16, k ** -0.5), rand((k, n), bf16),
                  torch.empty((8, n), dtype=bf16, device="cuda")), {})
                for _ in range(copies)]
        row = {"k": k, "n": n, "mma_config": mma}
        for config, tag in ((1, "swapped"), (mma, "mma"), (1, "swapped"),
                            (mma, "mma")):
            ms = device_ms(lambda a, b, c: launch(a, b, c, config), sets)
            row.setdefault(f"{tag}_us", []).append(ms * 1e3)
        a, b, _ = sets[0][0]
        c1 = torch.empty((8, n), dtype=bf16, device="cuda")
        c2 = torch.empty_like(c1)
        launch(a, b, c1, 1)
        launch(a, b, c2, mma)
        torch.cuda.synchronize()
        if not torch.equal(c1, c2):
            raise RuntimeError(f"decode forms differ at 8x{k}x{n}")
        out.append(row)
        log(f"  B1 8x{k}x{n}: swapped wgmma {row['swapped_us'][0]:.1f} / "
            f"{row['swapped_us'][1]:.1f} us, mma.sync (config {mma}) "
            f"{row['mma_us'][0]:.1f} / {row['mma_us'][1]:.1f} us, bit for "
            f"bit equal")
        del sets
    return out


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


def attn_block_phase(card):
    """Every launch-time shape B3 compiles (rows a CTA x keys a ring
    stage) and every B4 grouping (64-key splits a CTA) at the served
    shapes: B3 at smollm-360m's 300-token prefill (h 15/5, d 64), h2o's
    5000-token prefill (h 32/8, d 120, window 4096), recurrentgemma's
    3000-token one (h 16/1, d 256, window 2048), whisper's encoder (1 x
    1500², non-causal, MHA, d 64) and cross decode (8 x 1 x 1500) and
    kimi's 300-token prefill (h 64/8, d 112); B4 at smollm's decode step
    (8 slots x 1024), kimi's (d 112), recurrentgemma's rings (8 x 2048,
    group 16, d 256, positions clamped) and whisper's self-attention (8 x
    448).  Gates: each shape's output equals the default's, torch.equal,
    and is within the card tolerance of the plain version.  Each shape is
    timed as the kernel phase times kernels (CUDA graphs, operands cycled
    past the L2 cache) beside SDPA and the bound; the fastest is named.
    A shape that fails to build or launch raises."""
    bf = torch.bfloat16
    h2o, rg, wh, ki = (get_config(n) for n in (H2O, RG, WHISPER, KIMI))
    hh = dict(hq=h2o.n_heads, hkv=h2o.n_kv_heads, d=h2o.hd)
    rh = dict(hq=rg.n_heads, hkv=rg.n_kv_heads, d=rg.hd)
    wd = dict(hq=wh.n_heads, hkv=wh.n_kv_heads, d=wh.hd)
    kd = dict(hq=ki.n_heads, hkv=ki.n_kv_heads, d=ki.hd)
    rw, F_ = rg.local_window, wh.encoder_seq
    pos = [17, 40, 95, 160, 210, 300, 333, 363]
    rg_pos = [min(p, rw - 1) for p in (5, 900, 2047, 2048, 2049, 2500, 3000,
                                       4000)]
    w_pos = [5, 60, 120, 200, 300, 350, 400, 447]
    b3 = [attn_case("smollm prefill 1x300 h15/5 d64", 0, 1, 300, 15, 5, 64,
                    bf),
          attn_case("h2o prefill 1x5000 h32/8 d120 window 4096", 0, 1, 5000,
                    dtype=bf, window=h2o.window, **hh),
          attn_case("rg prefill 1x3000 h16/1 d256 window 2048", 0, 1, 3000,
                    dtype=bf, window=rw, **rh),
          attn_case(f"whisper encoder 1x{F_} h16/16 d64 non-causal", 0, 1,
                    F_, dtype=bf, causal=False, **wd),
          attn_case(f"whisper cross decode 8x1x{F_} h16/16 d64", 0, 8, 1,
                    dtype=bf, skv=F_, causal=False, **wd),
          attn_case("kimi prefill 1x300 h64/8 d112", 0, 1, 300, dtype=bf,
                    **kd)]
    b4 = [decode_case("smollm decode 8 slots S1024 h15/5 d64", 0, pos, 1024,
                      15, 5, 64, bf),
          decode_case("kimi decode 8 slots S1024 h64/8 d112", 0, pos, 1024,
                      dtype=bf, **kd),
          decode_case(f"rg ring decode 8 slots S{rw} h16/1 d256, positions "
                      "clamped", 0, rg_pos, rw, dtype=bf, **rh),
          decode_case(f"whisper decode 8 slots S{WHISPER_MAX_LEN} h16/16 "
                      "d64", 0, w_pos, WHISPER_MAX_LEN, dtype=bf, **wd)]
    out = []
    for name, cases, blocks_of in (
            ("flash_attention", b3, lambda a: b3_blocks(a[0].shape[-1])),
            ("flash_decode", b4,
             lambda a: [(None, k) for k in decode_blocks(a[0].shape[-1])])):
        kernel, plain, _, _ = KERNELS[name]
        for case in cases:
            first = case["make"]()
            args, kw = first
            want = plain(*args, **kw)
            base = kernel(*args, **kw)
            per = nbytes(*args)
            copies = max(1, min(64, math.ceil(COLD_BYTES / per)))
            inputs = [first] + [case["make"]() for _ in range(copies - 1)]
            b, ops_ = case["cost"](args, kw)
            bound = max(b / PEAK_BYTES, ops_ / PEAK_OPS[bf]) * 1e3
            lib = device_ms(case["library"], inputs) \
                if case["library"] else None
            rows = []
            for bq, bkv in blocks_of(args):
                blk = {"bkv": bkv} if bq is None else {"bq": bq, "bkv": bkv}
                got = kernel(*args, **kw, **blk)
                torch.cuda.synchronize()
                if not torch.equal(got, base):
                    raise RuntimeError(f"{name} {case['name']} {blk}: not "
                                       "bit for bit the default's output")
                err = (got.float() - want.float()).abs()
                tol = TOL[bf]
                if (err > tol + tol * want.float().abs()).any():
                    raise RuntimeError(f"{name} {case['name']} {blk}: max "
                                       f"abs err {err.max().item():.3e}")
                ms = device_ms(lambda *a, **k: kernel(*a, **k, **blk),
                               inputs)
                rows.append({"kernel": name, "case": case["name"], "bq": bq,
                             "bkv": bkv, "default": not rows, "ms": ms,
                             "library_ms": lib, "bound_ms": bound,
                             "bound_by": "bytes" if b / PEAK_BYTES >=
                             ops_ / PEAK_OPS[bf] else "operations",
                             "share": bound / ms,
                             "max_abs_err": err.max().item()})
            del inputs
            best = min(rows, key=lambda r: r["ms"])
            for r in rows:
                r["fastest"] = r is best
            out += rows
            log(f"  {name:15s} {case['name']:44s} "
                + "  ".join(f"{r['bq'] or '-'}x{r['bkv']} "
                            f"{r['ms'] * 1e3:.1f}" for r in rows)
                + " us; SDPA " + (f"{lib * 1e3:.1f} us" if lib else "—")
                + f", bound {bound * 1e3:.1f} us; fastest "
                f"{best['bq'] or '-'}x{best['bkv']} (default "
                f"{rows[0]['ms'] * 1e3:.1f} us) [{card}]")
    log(f"attention blocks: {len(out)} shapes at {len(b3)} B3 and {len(b4)} "
        "B4 served shapes, each == the default's output bit for bit and "
        "within 2e-2 of the plain version")
    return out


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
                   bias=False, act=None, out_dtype=None, out_scale=None,
                   tb=False, tile=None, **extra):
    """B1 or, ``tb``, B6 (at ``tile`` or its int8 'tb' plan's) on an int8
    weight: W8A16 (bf16 A, bf16 or ``out_dtype`` C, an f32 ``bias`` and
    ``act`` on the flush) or W8A8 (A int8, f32 C, or int8 under
    ``out_scale``).  Library yardstick: W8A8 ``torch._int_mm`` x the
    scale where its shape rules allow, else none; W8A16 has no one call,
    and the unfused dequantize + matmul is timed beside it.  Mode
    "w8a16_f32": W8A16 on f32 activations (the f32 body, f32 C)."""
    w8a8 = mode == "w8a8"
    f32a = mode == "w8a16_f32"
    a_dtype = torch.float32 if f32a else torch.bfloat16
    out_dtype = out_dtype or (torch.int8 if out_scale is not None else
                              torch.float32 if w8a8 or f32a
                              else torch.bfloat16)
    if tb and tile is None:
        spec = ops.GemmSpec(a_dtype="int8" if w8a8 else
                            "float32" if f32a else "bfloat16",
                            b_quant=True, out_dtype=out_dtype,
                            epilogue=ops.Epilogue(
                                bias=bias, activation=act,
                                residual=residual,
                                out_quant=out_scale is not None),
                            strategy="tb")
        try:
            tile = ops.plan(spec, (m, k, n)).tile
        except ValueError:      # no 'tb' design in the search's top ten
            tile = tb_tile(m, k, n, torch.bfloat16, residual=residual,
                           out_dtype=torch.float32)

    def make():
        a = rand((m, k), a_dtype)
        if w8a8:
            a = quant.quantize_activations(a)[0]
        q, scale = int8_weight(k, n)
        kw = {"out_dtype": out_dtype, "b_scale": scale}
        if tile is not None:
            kw["tile"] = tile
        if residual:
            kw["residual"] = rand((m, n), a_dtype)
        if bias:
            kw["bias"] = rand((n,), torch.float32)
        if act:
            kw["activation"] = act
        if out_scale is not None:
            kw["out_scale"] = out_scale
        return (a, q), kw

    def int_mm(a, q, b_scale, out_dtype, tile=None, **_):
        return torch._int_mm(a, q).float() * b_scale

    def dequant(a, q, b_scale, out_dtype, residual=None, bias=None,
                activation=None, tile=None):
        x = torch.matmul(a, q * b_scale.to(a.dtype))
        if bias is not None:
            x = x + bias
        if activation == "gelu":
            x = F.gelu(x, approximate="tanh")
        return (x + residual if residual is not None else x).to(out_dtype)

    def cost(args, kw):
        a, q = args
        out = m * n * torch.empty((), dtype=out_dtype).element_size()
        return (nbytes(a, q, kw["b_scale"], kw.get("residual"),
                       kw.get("bias")) + out, 2.0 * m * n * k)
    if tile is not None:
        name += f" tile {tile.bm}x{tile.bk}x{tile.bn}"
    case = dict(name=f"{mode} {name}", weight=weight, make=make, cost=cost,
                dtype=torch.float32 if out_dtype != torch.bfloat16
                else torch.bfloat16,
                peak_ops=PEAK_OPS[torch.int8 if w8a8 else a_dtype],
                library=int_mm if w8a8 and out_scale is None
                and _int_mm_ok(m, k, n) else None, **extra)
    if out_scale is not None:
        case["tol"] = 0.0               # int8 C: equal, value for value
    if not w8a8:
        case["dequant"] = dequant
    if f32a:                            # one fmaf chain over k an element
        case["chain_k"] = k
    return case


def int8_moe_cases(mode):
    """qwen3-moe-235b-a22b's quantized dense GEMMs at an 8-slot decode
    step (``moe_weight`` = launches in one step of the 4-layer model) and
    a 300-token prefill (timed), each on the kernel its int8 HOPPER_H100
    plan picks (W8A8: the re-routed int8 x int8 plan, the residual
    outside).  Returns {kernel: [cases]}."""
    d, q, kv, V = 4096, 8192, 512, 151936
    w8a8 = mode == "w8a8"
    shapes = []
    for m, per_step, tag in ((8, 1, "decode"), (300, 0, "prefill")):
        shapes += [
            (f"qwen3 {tag} wq {m}x{d}x{q}", m, d, q,
             {"moe_weight": per_step * MOE_LAYERS}),
            (f"qwen3 {tag} wk/wv {m}x{d}x{kv}", m, d, kv,
             {"moe_weight": per_step * 2 * MOE_LAYERS}),
            (f"qwen3 {tag} wo{'' if w8a8 else '+res'} {m}x{q}x{d}", m, q, d,
             {"moe_weight": per_step * MOE_LAYERS, "residual": not w8a8})]
    shapes.append((f"qwen3 decode lm_head 8x{d}x{V}", 8, d, V,
                   {"moe_weight": 1, "out_dtype": torch.float32}))
    return int8_planned_cases(mode, shapes)


def int8_planned_cases(mode, shapes):
    """``shapes`` (name, m, k, n, keywords of :func:`int8_gemm_case`) as
    int8 cases, each on the kernel its int8 HOPPER_H100 plan picks (B1,
    or B6 at the plan's tile), timed: {kernel: [cases]}.  Under W8A8 a
    linear epilogue runs outside the kernel (the re-route), so a W8A8
    case is the bare int8 x int8 product with f32 C."""
    w8a8 = mode == "w8a8"
    out = {"gemm_aie": [], "gemm_tb": []}
    for name, m, k, n, ep in shapes:
        spec = ops.GemmSpec(
            a_dtype="int8" if w8a8 else "bfloat16", b_quant=True,
            out_dtype="float32" if w8a8 or ep.get("out_dtype") else None,
            epilogue=ops.Epilogue(bias=ep.get("bias", False),
                                  activation=ep.get("act"),
                                  residual=ep.get("residual", False)))
        tile = ops.plan(spec, (m, k, n)).tile
        tb = tile.strategy == "tb"
        out["gemm_tb" if tb else "gemm_aie"].append(int8_gemm_case(
            name, 0, m, k, n, mode, tb=tb, tile=tile if tb else None,
            timed=True, **ep))
    return out


def int8_a9_cases(mode):
    """The int8 GEMMs of the paths int8 serving had not run before:
    recurrentgemma-9b's RG-LRU in_proj and gate projections (w_r / w_i,
    their output read in f32) at an 8-slot decode step, in both modes;
    whisper-medium's w_in + gelu at an 8-slot decode step (W8A16: a
    non-linear epilogue stays off the W8A8 re-route), the same with an
    f32 bias on the flush (no served GEMM of either package carries a
    bias: the epilogue's bias path), and an encoder projection over the
    1500 frames under W8A8 (each row quantized on its own); mamba2-370m's
    in_proj (n 4384, not a multiple of 64) under W8A16.  Its int8
    serving waits: a kernel row only."""
    rg, wh, mb = get_config(RG), get_config(WHISPER), get_config(MAMBA)
    d, w = rg.d_model, rg.lru_width
    shapes = [(f"rg decode rec in_proj 8x{d}x{2 * w}", 8, d, 2 * w, {}),
              (f"rg decode rec w_r / w_i 8x{w}x{w}", 8, w, w, {})]
    wd, ff, F_ = wh.d_model, wh.d_ff, wh.encoder_seq
    if mode == "w8a16":
        dd = M2.dims(mb.d_model, mb.ssm_state)
        shapes += [
            (f"whisper decode w_in+gelu 8x{wd}x{ff}", 8, wd, ff,
             {"act": "gelu"}),
            (f"whisper decode w_in+bias+gelu 8x{wd}x{ff}", 8, wd, ff,
             {"act": "gelu", "bias": True}),
            (f"mamba2 decode in_proj 8x{mb.d_model}x{dd['proj_out']}", 8,
             mb.d_model, dd["proj_out"], {})]
    else:
        shapes.append((f"whisper encoder wq {F_}x{wd}x{wd}", F_, wd, wd,
                       {}))
    return int8_planned_cases(mode, shapes)


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
    units, so the cp.async path); recurrentgemma-9b's, whisper-medium's
    and mamba2-370m's shapes (:func:`int8_a9_cases`)."""
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
            ] + int8_moe_cases(mode)[name] + int8_a9_cases(mode)[name]
            if w8a8:
                out[name][mode].append(int8_gemm_case(
                    "out-quant 8x960x960 scale 0.37", 0, 8, d, d, mode,
                    out_scale=0.37, tb=tb, timed=True))
    # the f32 body on an int8 weight (W8A16 on f32 activations: the f32
    # smoke models' int8 path) at smollm-360m's decode wq shape
    for name, tb in (("gemm_aie", False), ("gemm_tb", True)):
        out[name]["w8a16"].append(int8_gemm_case(
            "decode wq 8x960x960", 0, 8, d, d, "w8a16_f32", tb=tb,
            timed=True))
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
    the operator API's kernel fan-out for the length of a ``with``, and
    the plans of every CUDA-graph replay, which
    ``repro_torch.runtime.graphs`` announces (a replay never passes the
    fan-out; its launches it adds to the counters).  The tuner's
    measurements are not executions of the step (their launches are
    taken back off the counters too), nor is a capture (it launches
    nothing); neither is counted.  ``replays`` counts the replays
    announced."""

    def __enter__(self):
        self.plans = {}
        self.attn_plans = {}          # attention plans, apart
        self.group_sizes = None       # the first grouped launch's sizes
        self.replays = 0
        self._launch = api._launch
        self._attn_launch = attn_api._launch

        def record(pl, *args, **kw):
            if tune_measure.measuring() or G.recording():
                return self._launch(pl, *args, **kw)   # not an execution
            self.plans[pl] = self.plans.get(pl, 0) + 1
            if pl.spec.grouped and self.group_sizes is None:
                self.group_sizes = args[5] if len(args) > 5 \
                    else kw["group_sizes"]
            return self._launch(pl, *args, **kw)

        def record_attn(pl, *args):
            if not (tune_measure.measuring() or G.recording()):
                self.attn_plans[pl] = self.attn_plans.get(pl, 0) + 1
            return self._attn_launch(pl, *args)
        api._launch = record
        attn_api._launch = record_attn
        G.add_replay_hook(self._replayed)
        return self

    def _replayed(self, plans, attn_plans):
        self.replays += 1
        for mine, theirs in ((self.plans, plans),
                             (self.attn_plans, attn_plans)):
            for pl, n in theirs.items():
                mine[pl] = mine.get(pl, 0) + n

    def __exit__(self, *exc):
        api._launch = self._launch
        attn_api._launch = self._attn_launch
        G.remove_replay_hook(self._replayed)

    @staticmethod
    def _sum(plans):
        out = {}
        for pl, times in plans.items():
            for name, n in pl.launches.items():
                out[name] = out.get(name, 0) + times * n
        return out

    def implied(self):
        """Launches the executed GEMM plans imply, by counter."""
        return self._sum(self.plans)

    def attn_implied(self):
        """Launches the executed attention plans imply, by counter."""
        return self._sum(self.attn_plans)


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


def serve_phase(cfg, params, *, paged, mode=None, telemetry_base=None,
                trace=None, max_len=1024, chunk=64, eager_gate=False):
    """Serve the trace (default :func:`serve_trace`) through the dense
    engine or, ``paged``, through the paged one (16-token pages,
    ``chunk``-token chunks, prefix cache on) with two shared-prefix
    requests added, 8 slots of ``max_len`` positions.  The engine is the
    card's default: its first burst (the warm-up request's) runs
    eagerly, the trace's first burst captures the decode step, and every
    later step replays it from the CUDA graph.  The kernel counts are
    set to 0 just before the run and read just after, and must equal
    what the executed GEMM and attention plans imply, the replays'
    included (each replay adds its captured launches to the counters and
    announces its plans to the recorder); the run must have replayed,
    one capture, every replay announced.  A MoE model must launch B7
    three times a layer a pass.  With ``eager_gate`` the trace is served
    again through an engine that runs every step eagerly
    (``graphs=False``): its tokens must equal the graph engine's bit for
    bit and its launch counts the graph run's (:func:`eager_gate_run`).
    With ``telemetry_base`` the trace is served again with telemetry on
    (:func:`telemetry_run`).  The tokens by trace position and the
    executed plans ride the result under ``_tokens`` / ``_plans`` (the
    caller pops them before the JSON)."""
    trace = list(trace or serve_trace(cfg))
    kw = dict(page_size=16, prefill_chunk=chunk) if paged else {}
    if paged:
        trace += shared_prefix_requests(cfg, 64, 20, 32, seed=8)
    engine = DecodeEngine(params, cfg, batch=8, max_len=max_len,
                          device="cuda", **kw)
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
    if m["graph_captures"] != 1 or not m["graph_replays"] \
            or rec.replays != m["graph_replays"] or not sum(launches.values()):
        raise RuntimeError(f"serve {cfg.name}: {m['graph_captures']} "
                           f"captures, {m['graph_replays']} steps replayed, "
                           f"{rec.replays} replays announced, launches "
                           f"{launches}")
    decode, other = ("flash_decode_paged", "flash_decode") if paged \
        else ("flash_decode", "flash_decode_paged")
    # every pass runs gemms_per_pass planned GEMMs; their plans say which
    # kernel takes each and how often (a 'tb' plan: one B6a a chunk but
    # the last, and one B6b)
    passes = steps + prefills
    # a prefill with frames adds the encoder and the cross k / v
    framed = sum(r.frames is not None for r in trace)
    executed = sum(rec.plans.values())
    if executed != gemms_per_pass(cfg) * passes + encoder_gemms(cfg) * framed:
        raise RuntimeError(f"{executed} GEMMs ran, expected "
                           f"{gemms_per_pass(cfg)} x {passes} passes + "
                           f"{encoder_gemms(cfg)} x {framed} encoder passes")
    n_moe = cfg.repeats * cfg.layer_pattern.count("moe")
    want = {"gemm_aie": 0, "gemm_gated": 0, "gemm_tb": 0,
            "gemm_tb_final": 0, "gemm_grouped": 0}
    want.update(rec.implied())
    n_attn = len(attn_windows(cfg))
    # B3 at every prefill's self-attention, every pass's cross-attention
    # (a one-row prefill at decode) and every framed prefill's encoder
    n_cross = cfg.n_layers if cfg.encoder_layers else 0
    want.update({decode: n_attn * steps, other: 0,
                 "flash_attention": n_attn * prefills + n_cross * passes
                 + cfg.encoder_layers * framed})
    if want["gemm_grouped"] != 3 * n_moe * passes:
        raise RuntimeError(f"{want['gemm_grouped']} grouped GEMMs planned, "
                           f"expected 3 x {n_moe} MoE layers x {passes}")
    attn_want = rec.attn_implied()
    if any(attn_want.get(k, 0) != want[k] for k in
           ("flash_attention", "flash_decode", "flash_decode_paged")):
        raise RuntimeError(f"attention plans executed imply {attn_want}, "
                           f"the passes {want}")
    if launches != want or any(plain.values()):
        raise RuntimeError(f"{'paged' if paged else 'dense'} path launches "
                           f"{launches} (expected {want}), plain versions "
                           f"{plain}")
    by_kernel = {}
    for pl, times in rec.plans.items():
        key = f"{pl.kernel} m={pl.m} {pl.k}x{pl.n}"
        by_kernel[key] = by_kernel.get(key, 0) + times
    attn_by_plan = {}
    for pl, times in rec.attn_plans.items():
        key = f"{pl.spec.key}@{pl.shape_key}->{pl.kernel}"
        attn_by_plan[key] = attn_by_plan.get(key, 0) + times
    if paged and (m["prefix_hits"] < 1
                  or m["max_prefill_stall_tokens"] > chunk):
        raise RuntimeError(f"paged serve: {m['prefix_hits']} prefix hits, "
                           f"max stall {m['max_prefill_stall_tokens']} "
                           f"tokens (want >= 1 hit, <= {chunk} tokens)")
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
           "graph_replays": m["graph_replays"],
           "graph_captures": m["graph_captures"],
           "gemm_plans_executed": by_kernel,
           "attn_plans_executed": attn_by_plan,
           "plain_launches": plain, "prefill_chunks": prefills,
           "framed_prefills": framed,
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
        f"occupancy {out['occupancy']:.2f}; {m['graph_replays']} of "
        f"{steps} decode steps replayed from the CUDA graph")
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
    if eager_gate:
        out["eager"] = eager_gate_run(cfg, params, trace, kw, max_len, out,
                                      tag)
    if telemetry_base:
        out["telemetry"] = telemetry_run(cfg, params, trace, kw,
                                         out["_tokens"], telemetry_base, tag)
    return out


def _engine_run(cfg, params, trace, kw, max_len, recorder=None,
                **engine_kw):
    """A fresh 8-slot engine, warmed up on a short request, serving a
    copy of ``trace`` (with ``recorder`` enabled after the warm-up; the
    caller disables it): (engine, its results by trace position, the
    launch counts of the trace's run, its seconds)."""
    engine = DecodeEngine(params, cfg, batch=8, max_len=max_len,
                          device="cuda", **kw, **engine_kw)
    engine.run([Request(prompt=trace[0].prompt[:5], max_tokens=2)])
    engine.reset_metrics()
    if recorder is not None:
        telemetry.enable(recorder)
    reqs = [dataclasses.replace(r, rid=-1) for r in trace]
    reset_counters()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_rid = {r.rid: r for r in results}
    return engine, [by_rid[r.rid] for r in reqs], counts(), dt


def eager_gate_run(cfg, params, trace, kw, max_len, graph_run, tag):
    """The graph == eager gate: ``trace`` through an engine that runs
    every decode step eagerly (``graphs=False``); each request's tokens
    must equal the graph engine's bit for bit, and the kernels' launch
    counts the graph run's (each replay adds what its capture launched).
    Returns the eager run's decode tok/s, step ms and TTFT."""
    engine, results, launches, dt = _engine_run(cfg, params, trace, kw,
                                                max_len, graphs=False)
    for i, (r, want) in enumerate(zip(results, graph_run["_tokens"])):
        if not np.array_equal(r.tokens, want):
            raise RuntimeError(f"{tag}: graph != eager engine on request "
                               f"{i}: {want} vs {r.tokens}")
    if launches != graph_run["launches"] or engine.metrics["graph_replays"]:
        raise RuntimeError(f"{tag}: eager launches {launches}, graph run "
                           f"{graph_run['launches']}")
    m = engine.metrics
    ttft = np.asarray([r.ttft for r in results])
    out = {"tok_s_decode": engine.tokens_per_sec(), "seconds": dt,
           "decode_ms_per_step": m["decode_time"] / max(m["decode_steps"],
                                                        1) * 1e3,
           "ttft_mean_ms": float(ttft.mean() * 1e3),
           "ttft_p99_ms": float(np.percentile(ttft, 99) * 1e3),
           "requests": len(results)}
    log(f"{tag}: graph == eager engine, {len(results)} requests bit for "
        f"bit, launches equal; eager {out['tok_s_decode']:.1f} tok/s "
        f"decode, {out['decode_ms_per_step']:.2f} ms/step, ttft mean "
        f"{out['ttft_mean_ms']:.0f} ms p99 {out['ttft_p99_ms']:.0f} ms "
        f"against the graph's {graph_run['tok_s_decode']:.1f} tok/s, "
        f"{graph_run['decode_ms_per_step']:.2f} ms/step, "
        f"{graph_run['ttft_mean_ms']:.0f} / {graph_run['ttft_p99_ms']:.0f} "
        "ms")
    return out


def telemetry_run(cfg, params, trace, kw, want_tokens, base, tag):
    """The serve trace again through a fresh engine, telemetry on (the
    warm-up off), both artifacts exported to ``chiprun_out/base``.  The
    trace must agree with the engine: one ``serve.request`` span a
    request, the decode bursts' steps summing to the engine's decode
    steps, the serve counters equal to its metrics, and for a MoE model
    routed + dropped rows equal to tokens x top-k over every MoE layer
    and pass; the greedy tokens must equal the untraced run's bit for
    bit.  The engine replays its decode step from a graph captured under
    the recorder; a MoE model's trace is then served by an eager engine
    (``graphs=False``) with telemetry on, and the routed / dropped
    counters of the two runs must be equal.  Prints what the spans
    show."""
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
        erec = telemetry.Recorder()
        try:
            _engine_run(cfg, params, trace, kw, 1024, recorder=erec,
                        graphs=False)
            ec = erec.snapshot()["counters"]
        finally:
            telemetry.disable()
        eager = {k: ec[k] for k in ("moe.group_sizes", "moe.dropped_tokens")}
        if eager != {"moe.group_sizes": routed, "moe.dropped_tokens": dropped}:
            raise RuntimeError(f"{tag}: MoE counters of the captured run "
                               f"{routed} / {dropped}, of the eager run "
                               f"{eager}")
        out["moe_rows_eager"] = eager
    if not m["graph_replays"]:
        raise RuntimeError(f"{tag} with telemetry: no step replayed")

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
def step_phase(cfg, params, *, paged, mode=None, telemetry_on=False,
               max_len=1024, at_pos=None, engine_ms=None):
    """Device time of one 8-slot decode step (with its greedy argmax),
    from CUDA-graph replays that take the host out of the step, beside
    the same step run eagerly: one loop of REPS steps right after the
    replays, timed on the host's clock to a synchronize
    (``eager_ms_per_step``); the difference is the device's idle time in
    an eager step.  The same step captured by
    ``repro_torch.runtime.graphs`` (as the engine captures it) is
    replayed REPS times back to back on the host's clock
    (``graph_ms_per_step``); with ``engine_ms``, the graph engine's decode
    ms a step over a trace, the device's idle share of the engine's
    decode (``engine_idle_share``: 1 - the device step / it; the step at
    this phase's positions, not the trace's).  ``telemetry_on`` runs the eager loop seven more
    times, telemetry off and on in turns, and compares the medians of
    each mode's four loops (the first loop counts as an off one).  The
    same eight prompts sit in the dense cache or, ``paged``, in 16-token
    pages of a pool (``max_len / 16`` pages a slot, so the gathered
    length equals the dense ``max_len``).  With ``at_pos`` no prompt is
    prefilled: every slot decodes at that position over the cache as it
    stands (the kernels' work depends on the positions, not on the
    values), and the step's byte bound (weights read once, each slot's
    window of KV read once) rides the result."""
    rng = np.random.default_rng(11)
    pages = max_len // 16
    if paged:
        cache = T.init_paged_cache(cfg, 8, 1 + 8 * pages, 16, pages,
                                   device="cuda")
        rows = np.arange(1, 1 + 8 * pages, dtype=np.int32).reshape(8, pages)
    else:
        cache = T.init_cache(cfg, 8, max_len, device="cuda")
    if at_pos is not None:
        cache["pos"].fill_(at_pos)
    for slot, p in enumerate(SERVE_PROMPT_LENS[:8] if at_pos is None
                             else ()):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, p)),
                               device="cuda")
        if paged:
            _, cache = T.prefill_paged_chunk(params, cfg, toks, cache, slot,
                                             rows[slot], 0)
        else:
            _, cache = T.prefill_into_slot(params, cfg, toks, cache, slot,
                                           max_len=max_len)
    if paged:
        cache["page_table"].copy_(torch.as_tensor(rows))
    tok = torch.zeros((8, 1), dtype=torch.int64, device="cuda")

    def step(tok, cache):
        logits, _ = T.decode_step(params, cfg, tok, cache)
        return torch.argmax(logits, -1)

    device = device_ms(step, [((tok, cache), {})])
    graph = G.capture(lambda: step(tok, cache))

    def graph_loop():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            graph.replay()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / REPS * 1e3

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
    replayed = graph_loop()
    del graph
    out = {"device_ms_per_step": device, "eager_ms_per_step": eager,
           "device_idle_share": 1.0 - device / eager,
           "graph_ms_per_step": replayed}
    if engine_ms is not None:
        out.update(engine_ms_per_step=engine_ms,
                   engine_idle_share=1.0 - device / engine_ms)
    if at_pos is not None:
        kv = sum(bandwidth.decode_kv_bytes(
            [at_pos] * 8, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            dtype=cfg.dtype, window=w) for w in attn_windows(cfg))
        weights = decode_weight_bytes(params)
        state = 2 * recurrent_state_bytes(cfg, cache)   # read and written
        # every slot's cross k / v, read once by the cross-attention
        cross = nbytes(*_leaves(cache["cross"])) if "cross" in cache else 0
        out.update(at_pos=at_pos, weight_bytes=weights, kv_bytes=kv + cross,
                   cross_kv_bytes=cross, state_bytes=state,
                   bound_ms=(weights + kv + cross + state) / PEAK_BYTES
                   * 1e3)
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
        "slots" + (f" at position {at_pos}" if at_pos is not None else "")
        + "): device "
        f"{device:.2f} ms (CUDA graph), eager {eager:.2f} ms; device idle "
        f"{out['device_idle_share']:.1%} of an eager step; the captured "
        f"step replayed back to back {replayed:.2f} ms a step (host clock)"
        + (f"; the graph engine's decode {engine_ms:.2f} ms a step over "
           f"the trace: the device idle {out['engine_idle_share']:.1%} of "
           "it" if engine_ms is not None else "")
        + (f"; byte bound {out['bound_ms']:.2f} ms ("
           f"{out['weight_bytes'] / 1e9:.2f} GB of weights, "
           f"{out['kv_bytes'] / 1e9:.2f} GB of KV, "
           f"{out['state_bytes'] / 1e9:.2f} GB of recurrent state read "
           "and written)" if at_pos is not None else "")
        + (f"; eager, medians of four loops each in turns, telemetry off "
           f"{out['eager_ms_off_median']:.2f} ms, on "
           f"{out['eager_ms_per_step_telemetry_on']:.2f} ms ("
           f"{out['telemetry_on_over_off'] - 1:+.1%}; off "
           f"{', '.join(f'{x:.2f}' for x in off)}; on "
           f"{', '.join(f'{x:.2f}' for x in on)})" if telemetry_on else ""))
    return out


def decode_weight_bytes(params) -> int:
    """The GEMM weights a decode step reads (``quant.gemm_weight_bytes``
    without an encoder and the decoder layers' cross k / v projections,
    which only a prefill with frames runs)."""
    dec = {k: v for k, v in params.items() if k != "encoder"}
    unused = sum(quant.gemm_weight_bytes(
        {"cross": {w: u["cross"][w] for w in ("wk", "wv")}})
        for u in params["layers"].values() if "cross" in u)
    return quant.gemm_weight_bytes(dec) - unused


def recurrent_state_bytes(cfg, cache) -> int:
    """Bytes of the recurrent layers' state in a dense cache (each read
    and written once a decode step)."""
    units = [(cache["layers"][ck], kind) for ck, kind in T._units(cfg)] \
        + [(cache["tail"][tk], kind) for tk, kind in T._tail(cfg)]
    return sum(nbytes(*c.values()) for c, kind in units
               if kind in T.RECURRENT_KINDS)


# ------------------------------------------------- tuning and calibration

#: candidates the measured search sweeps a shape: the reference's K = 4
#: never reaches the first 'aie' design at qwen3-moe's 300-token wq
TUNE_K = 8
#: qwen3-moe's 300-token prefill GEMMs the Hopper plan sends to B6
NAMED_SHAPES = {(300, 4096, 8192): "qwen3 wq, 300 tokens",
                (300, 8192, 4096): "qwen3 wo + residual, 300 tokens"}


def _tile(t) -> str:
    return f"{t.strategy} {t.bm}x{t.bk}x{t.bn}"


def _attn_shapes(pl):
    """The per-mode shape tuple an attention plan was resolved at."""
    if pl.spec.mode == "prefill":
        return (pl.b, pl.sq, pl.skv, pl.hq, pl.hkv, pl.d)
    if pl.spec.mode == "decode":
        return (pl.b, pl.skv, pl.hq, pl.hkv, pl.d)
    return (pl.b, pl.max_pages, pl.page_size, pl.hq, pl.hkv, pl.d)


def autotune_phase(cfg, params, untuned, card):
    """The dense serve trace once more untuned (every plan cached: the
    baseline), then under ``tune.enable(TUNE_K)`` on the fresh tuning
    cache ``$REPRO_TUNE_CACHE``: the plan caches start empty, so every
    GEMM and every B3 / B4 attention plan the warm-up and the trace plan
    is searched on the card, and a second tuned pass, every plan cached,
    is the one compared.  Gates: launches equal the executed plans
    (serve_phase; the tuner's samples are not executions), the greedy
    tokens equal ``untuned``'s bit for bit, no B1 / B6 candidate and no
    attention candidate fails at the model's shapes, and a second pass
    (a fresh in-memory cache over the same file) re-plans every GEMM and
    attention plan with zero measurements and the same tiles and blocks.
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
    attn_api.attn_plan_cache_clear()
    try:
        t0 = time.perf_counter()     # the pass that searches
        search = serve_phase(cfg, params, paged=False, mode="tuning")
        seconds = time.perf_counter() - t0
        run = serve_phase(cfg, params, paged=False, mode="tuned")
        run["step"] = step_phase(cfg, params, paged=False, mode="tuned",
                                 engine_ms=run["decode_ms_per_step"])
        plans = [pl for pl in api.plans() if not pl.spec.grouped]
        attn_plans = [pl for pl in attn_api.attn_plans()
                      if pl.kernel in attn_api.TUNABLE_KERNELS]
        searched = tune.tuning_cache_info().measurements - measured0
        tune.tuning_cache_reset()           # the second pass
        api.plan_cache_clear()
        attn_api.attn_plan_cache_clear()
        again = [api.plan(pl.spec, (pl.m, pl.k, pl.n)) for pl in plans]
        attn_again = [attn_api.attn_plan(pl.spec, _attn_shapes(pl),
                                         device="cuda") for pl in attn_plans]
        second = tune.tuning_cache_info()
    finally:
        tune.disable()
        api.plan_cache_clear()
        attn_api.attn_plan_cache_clear()
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
    blocks = [(pl.bq, pl.bkv) for pl in attn_plans]
    if [(pl.bq, pl.bkv) for pl in attn_again] != blocks or any(
            pl.tuned is None or not pl.tuned.from_cache
            for pl in attn_again):
        raise RuntimeError(f"tuned {cfg.name}: the second pass changed an "
                           "attention plan's blocks or did not take it "
                           "from the cache")
    if any(pl.tuned is None for pl in attn_plans):
        raise RuntimeError(f"tuned {cfg.name}: an attention plan was not "
                           "tuned: " + ", ".join(
                               f"{pl.spec.key} {pl.shape_key}"
                               for pl in attn_plans if pl.tuned is None))
    errors = autotune.candidate_errors[errors0:]
    attn_errors = [e for e in errors if e[1].startswith("attn|")]
    failed = [e for e in errors if e[0] == "measure"]
    if failed or attn_errors:
        raise RuntimeError(f"tuned {cfg.name}: {len(failed)} candidate "
                           f"executions failed, {len(attn_errors)} "
                           "attention candidates: "
                           f"{(failed + attn_errors)[:3]}")
    attn_rows = []
    for pl in attn_plans:
        ti = pl.tuned
        row = {"spec": pl.spec.key, "shape": pl.shape_key,
               "kernel": pl.kernel, "analytic": ti.analytic_tile,
               "analytic_us": ti.t_analytic_us,
               "winner": autotune._blocks_str(pl.bq, pl.bkv),
               "winner_us": ti.t_measured_us,
               "t_model_us": pl.traffic.t_model * 1e6,
               "k_searched": ti.k_searched}
        attn_rows.append(row)
        log(f"tuned {cfg.name} {pl.kernel} {row['spec']} {row['shape']}: "
            f"analytic {row['analytic']} {row['analytic_us']:.1f} us, "
            f"measured winner {row['winner']} {row['winner_us']:.1f} us "
            f"(K = {ti.k_searched}, host clock between syncs) [{card}]")
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
           "attn_plans": len(attn_plans), "attn_tuned": attn_rows,
           "attn_changed": sum(r["winner"] != r["analytic"]
                               for r in attn_rows),
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
        f"{len(attn_plans)} attention plans tuned, "
        f"{sum(r['winner'] != r['analytic'] for r in attn_rows)} off the "
        f"default blocks; second pass {second.hits} hits, "
        f"{second.measurements} measurements, the same tiles and blocks; "
        "tokens == untuned")
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
    """Continuous == solo greedy on the acceptance trace, 2 slots; an
    encoder-decoder's requests carry their own stub frames (seed 5)."""
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    reqs = acceptance_requests(cfg.vocab)
    if cfg.encoder_layers:
        rng = np.random.default_rng(5)
        reqs = [dataclasses.replace(r, frames=rng.standard_normal(
            (cfg.encoder_seq, cfg.d_model), dtype=np.float32))
            for r in reqs]
    engine = DecodeEngine(params, cfg, batch=2, max_len=max_len,
                          device="cuda")
    results = {r.rid: r.tokens for r in engine.run(reqs)}
    for req in reqs:
        want = solo_greedy(params, cfg, req.prompt, req.max_tokens, max_len,
                           frames=req.frames)
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


# ------------------------------------------- windowed serving: h2o

def h2o_trace(cfg):
    """The serve trace plus :data:`H2O_LONG`'s two long requests."""
    rng = np.random.default_rng(21)
    return serve_trace(cfg) + [
        Request(prompt=rng.integers(0, cfg.vocab, (p,)).astype(np.int32),
                max_tokens=mt) for p, mt in H2O_LONG]


def h2o_bit_identity_phase(cfg, params, dense_tokens, paged_tokens):
    """Continuous == solo greedy through the dense ring (each request of
    the dense trace alone at batch 1), and paged == paged solo (each
    request of the paged trace alone on a 1-slot paged engine with the
    same pages and chunks, prefix cache off), bit for bit."""
    trace = h2o_trace(cfg)
    for req, got in zip(trace, dense_tokens):
        want = solo_greedy(params, cfg, req.prompt, req.max_tokens,
                           H2O_MAX_LEN)
        if not np.array_equal(got, want):
            raise RuntimeError(f"{cfg.name}: continuous != solo greedy for "
                               f"a {len(req.prompt)}-token prompt: {got} vs "
                               f"{want}")
    paged_trace = trace + shared_prefix_requests(cfg, 64, 20, 32, seed=8)
    for req, got in zip(paged_trace, paged_tokens):
        (solo,) = DecodeEngine(
            params, cfg, batch=1, max_len=H2O_MAX_LEN, page_size=16,
            prefill_chunk=H2O_CHUNK, prefix_cache=False,
            device="cuda").run([Request(prompt=req.prompt,
                                        max_tokens=req.max_tokens)])
        if not np.array_equal(got, solo.tokens):
            raise RuntimeError(f"{cfg.name}: paged != paged solo greedy for "
                               f"a {len(req.prompt)}-token prompt: {got} vs "
                               f"{solo.tokens}")
    log(f"bit identity ({cfg.name}): {len(trace)} requests continuous == "
        f"solo greedy through the {cfg.window}-slot ring, "
        f"{len(paged_trace)} paged == paged solo greedy (pages 16, chunks "
        f"{H2O_CHUNK}), at full width")
    return {"dense_requests": len(trace), "paged_requests": len(paged_trace)}


@torch.inference_mode()
def h2o_chunked_phase(cfg, params):
    """Chunked == unchunked == dense prefill, bit for bit: the 5000-token
    prompt into a 1-slot pool in :data:`H2O_CHUNK`-token chunks and in
    one chunk (the last logits and every layer's pool pages), and into
    the dense ring by ``prefill`` (the last logits)."""
    rng = np.random.default_rng(22)
    n = H2O_LONG[1][0]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                           device="cuda")
    pages = H2O_MAX_LEN // 16
    row = np.arange(1, 1 + pages, dtype=np.int32)
    used = torch.as_tensor(row[:-(-n // 16)], device="cuda").long()
    runs = []
    for chunk in (H2O_CHUNK, n):
        cache = T.init_paged_cache(cfg, 1, 1 + pages, 16, pages,
                                   device="cuda")
        for start in range(0, n, chunk):
            logits, cache = T.prefill_paged_chunk(
                params, cfg, toks[:, start:start + chunk], cache, 0, row,
                start)
        runs.append((logits, [kv[name][:, used] for kv in
                              cache["layers"].values() for name in "kv"]))
        del cache
    dense, _ = T.prefill(params, cfg, toks,
                         T.init_cache(cfg, 1, H2O_MAX_LEN, device="cuda"))
    (a, pa), (b, pb) = runs
    if not (torch.equal(a, b) and torch.equal(a, dense)
            and all(torch.equal(x, y) for x, y in zip(pa, pb))):
        raise RuntimeError(f"{cfg.name}: chunked != unchunked prefill of "
                           f"{n} tokens")
    log(f"chunked == unchunked prefill ({cfg.name}): {n} tokens in chunks "
        f"of {H2O_CHUNK} == one chunk == the dense ring's prefill, logits "
        "and pool pages bit for bit")
    return {"prompt": n, "chunk": H2O_CHUNK}


class RingShadow:
    """While a decode step runs on the ring, repeat each windowed layer's
    attention on that layer of the full-length cache with the same
    inputs: the ring call's q, and the new key and value the ring just
    took written at the slot's true position, then B4 over ``max_len``
    slots with the window.  Both calls see the same keys in another
    order, so their outputs differ by the kernel's f32 order alone; each
    must agree within the bf16 tolerance (2e-2 + 2e-2 |x| elementwise,
    the kernels' gate)."""

    def __init__(self, cfg, ring, full):
        self.window = T._window(cfg, next(
            k for _, k in T._units(cfg) if k in T.ATTN_KINDS))
        self.pos = ring["pos"]
        self.layers = {}        # ring k view's address -> full k, v
        for ck, kind in T._units(cfg):
            if kind in T.ATTN_KINDS:
                for r in range(cfg.repeats):
                    rk = ring["layers"][ck]["k"][r]
                    self.layers[rk.data_ptr()] = (
                        full["layers"][ck]["k"][r],
                        full["layers"][ck]["v"][r])
        self.worst = 0.0
        self.calls = 0

    def __enter__(self):
        self._decode = ops.decode_attention

        def shadow(q, k, v, pos, window=0):
            out = self._decode(q, k, v, pos, window=window)
            fk, fv = self.layers[k.data_ptr()]
            rows = torch.arange(q.shape[0], device=q.device)
            true = self.pos.long()
            fk[rows, true] = k[rows, true % k.shape[1]]
            fv[rows, true] = v[rows, true % v.shape[1]]
            want = self._decode(q, fk, fv, self.pos, window=self.window)
            err = (out.float() - want.float()).abs()
            tol = TOL[torch.bfloat16]
            if (err > tol + tol * want.float().abs()).any():
                raise RuntimeError(f"ring attention off the full cache's by "
                                   f"{err.max().item():.3e}")
            self.worst = max(self.worst, err.max().item())
            self.calls += 1
            return out
        ops.decode_attention = shadow
        return self

    def __exit__(self, *exc):
        ops.decode_attention = self._decode


@torch.inference_mode()
def ring_phase(cfg, params, prompts, steps, max_len, *, layer_gate=False):
    """The dense ring against a full-length cache that B4 masks to the
    window: 8 slots prefilled with ``prompts`` past the window into the
    ring (a windowed layer's cache of ``window`` slots) and into a cache
    of ``max_len`` slots, then ``steps`` teacher-forced decode steps on
    each.  The same keys are summed in another order, and the bf16
    layers carry one rounding's change on: each row's logits must agree
    within the bf16 tolerance relative to the row's largest logit (max
    |ring - full| <= 2e-2 max |full|).  The elementwise error, the share
    of logits off by more than 2e-2 + 2e-2 |logit|, the relative L2
    error and the greedy tokens' agreement are recorded beside it.

    ``layer_gate`` (recurrentgemma-9b) holds each windowed layer's
    attention output instead (:class:`RingShadow`, every layer of every
    step) and records the logits' distance: through 38 layers of random
    weights the logits of the two caches part by about 3 % of the row's
    largest logit even when both run the plain f32 attention, which no
    correct ring can undercut (``tools/ring_probe.py``, PERF.md §6)."""
    rng = np.random.default_rng(23)
    ck, kind = next((ck, k) for ck, k in T._units(cfg) if k in T.ATTN_KINDS)
    window = T._window(cfg, kind)
    # a cache of max_len slots a layer; the decode steps still window
    full_cfg = dataclasses.replace(cfg, window=0, local_window=0)
    ring = T.init_cache(cfg, 8, max_len, device="cuda")
    full = T.init_cache(full_cfg, 8, max_len, device="cuda")
    if ring["layers"][ck]["k"].shape[2] != window \
            or full["layers"][ck]["k"].shape[2] != max_len:
        raise RuntimeError("ring phase: the caches have the wrong length")
    for slot, p in enumerate(prompts):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, p)),
                               device="cuda")
        _, ring = T.prefill_into_slot(params, cfg, toks, ring, slot,
                                      max_len=max_len)
        _, sub = T.prefill(params, cfg, toks, T.init_cache(
            full_cfg, 1, max_len, device="cuda"))
        T.insert_cache_slot(full, sub, slot)
        del sub
    tol = TOL[torch.bfloat16]
    rows = []
    shadows = []
    for i in range(steps):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (8, 1)),
                              device="cuda")
        if layer_gate:
            with RingShadow(cfg, ring, full) as shadow:
                got, ring = T.decode_step(params, cfg, tok, ring)
            shadows.append({"calls": shadow.calls,
                            "max_abs_err": shadow.worst})
        else:
            got, ring = T.decode_step(params, cfg, tok, ring)
        want, full = T.decode_step(params, cfg, tok, full)
        err = (got - want).abs()
        scale = want.abs().max(-1).values
        row = {"max_abs_err": err.max().item(),
               "max_abs_logit": scale.max().item(),
               "rel_err": (err.max(-1).values / scale).max().item(),
               "rel_l2_err": ((got - want).norm(dim=-1)
                              / want.norm(dim=-1)).max().item(),
               "share_off_elementwise": (err > tol + tol * want.abs())
               .float().mean().item(),
               "argmax_agree": (got.argmax(-1) == want.argmax(-1))
               .float().mean().item()}
        rows.append(row)
        if not torch.isfinite(got).all() or (
                not layer_gate and row["rel_err"] > tol):
            raise RuntimeError(f"{cfg.name}: ring decode step {i} off the "
                               f"full cache's: {row}")
    def each(key, fmt):
        return ", ".join(format(r[key], fmt) for r in rows)
    log(f"ring vs full cache ({cfg.name}): {steps} decode steps of "
        f"8 slots at positions {prompts[0]}-"
        f"{prompts[-1] + steps - 1}: max |ring - full| / "
        f"max |full| {each('rel_err', '.3e')} ("
        + ("recorded; the gate is by layer" if layer_gate else f"gate {tol}")
        + f"); max abs err "
        f"{each('max_abs_err', '.3e')} of logits up to "
        f"{max(r['max_abs_logit'] for r in rows):.2f}; greedy tokens agree "
        f"{each('argmax_agree', '.3f')}"
        + (f"; gated by layer: {sum(x['calls'] for x in shadows)} windowed "
           "attention outputs equal the full cache's within 2e-2 + 2e-2 |x| "
           f"(max abs err {max(x['max_abs_err'] for x in shadows):.3e})"
           if layer_gate else ""))
    out = {"positions": list(prompts), "steps": rows, "tol": tol,
           "gate": "each windowed layer's attention output" if layer_gate
           else "logits relative to the row's largest"}
    if layer_gate:
        out["layer_gate"] = shadows
    return out


def attn_plan_phase(cfg, kind, prompt, max_len):
    """The three attention families' plans at the serving shapes of the
    model's ``kind`` layers (the serve phases resolved the first two:
    ``attn.plan`` hits; B5 plans only where the model pages), with
    ``explain()`` and the ``attn.plan`` records."""
    g = cfg.n_heads // cfg.n_kv_heads
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    window = T._window(cfg, kind)
    rec = telemetry.enable(telemetry.Recorder())
    try:
        plans = {
            "prefill": ops.attn_plan(
                ops.AttnSpec(window=window, group=g),
                (1, prompt, prompt) + heads),
            "decode (ring)": ops.attn_plan(
                ops.AttnSpec(mode="decode", group=g),
                (8, window) + heads),
            "decode_paged": ops.attn_plan(
                ops.AttnSpec(mode="decode_paged", window=window,
                             group=g), (8, max_len // 16, 16) + heads),
        }
    finally:
        telemetry.disable()
    for name, pl in plans.items():
        log(f"{cfg.name} attention plan, {name}:\n{pl.explain()}")
    return {"explain": {n: pl.explain() for n, pl in plans.items()},
            "attn_plan_events": [e["attrs"] for e in rec.events
                                 if e["name"] == "attn.plan"]}


def h2o_phases(card):
    """h2o-danube-3-4b at full width, its depth cut to
    :data:`H2O_LAYERS` (bf16, random weights from seed 0): the
    dense-ring and paged serve phases on the trace with the two long
    requests, each with its launches equal to the executed plans; the
    decode step at position :data:`H2O_STEP_POS`, dense and paged; then
    the bitwise gates, the ring against a full cache, and the attention
    plans."""
    cfg = cut_depth(get_config(H2O), H2O_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, device="cuda")
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _leaves(params)) / 1e9
    log(f"{cfg.name}: full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
        f"window {cfg.window}, bf16): {weights_gb:.2f} GB of weights made "
        f"from seed 0 in {time.perf_counter() - t0:.1f} s; the dense cache "
        f"is a ring of {T.cache_len(cfg, H2O_MAX_LEN)} slots, the pool "
        f"pages {H2O_MAX_LEN} positions a slot [{card}]")
    trace = h2o_trace(cfg)
    torch.cuda.reset_peak_memory_stats()
    dense = serve_phase(cfg, params, paged=False, trace=trace,
                        max_len=H2O_MAX_LEN, eager_gate=True)
    torch.cuda.reset_peak_memory_stats()
    paged = serve_phase(cfg, params, paged=True, trace=trace,
                        max_len=H2O_MAX_LEN, chunk=H2O_CHUNK)
    dense.pop("_plans")
    paged.pop("_plans")
    dense["step"] = step_phase(cfg, params, paged=False,
                               max_len=H2O_MAX_LEN, at_pos=H2O_STEP_POS,
                               engine_ms=dense["decode_ms_per_step"])
    paged["step"] = step_phase(cfg, params, paged=True, max_len=H2O_MAX_LEN,
                               at_pos=H2O_STEP_POS,
                               engine_ms=paged["decode_ms_per_step"])
    out = {"config": cfg.name, "layers": cfg.n_layers,
           "weights_gb": weights_gb, "serve": dense,
           "paged_serve": paged,
           "bit_identity": h2o_bit_identity_phase(
               cfg, params, dense.pop("_tokens"), paged.pop("_tokens")),
           "chunked_prefill": h2o_chunked_phase(cfg, params),
           "ring_vs_full_cache": ring_phase(cfg, params, H2O_RING_PROMPTS,
                                            H2O_RING_STEPS, H2O_MAX_LEN),
           "plans": attn_plan_phase(cfg, "attn", H2O_LONG[1][0],
                                    H2O_MAX_LEN)}
    del params
    torch.cuda.empty_cache()
    return out


def long_trace(cfg, long, seed):
    """The serve trace plus the ``long`` (prompt, new tokens) requests."""
    rng = np.random.default_rng(seed)
    return serve_trace(cfg) + [
        Request(prompt=rng.integers(0, cfg.vocab, (p,)).astype(np.int32),
                max_tokens=mt) for p, mt in long]


def dense_bit_identity_phase(cfg, params, trace, tokens, max_len):
    """Continuous == solo greedy on the dense cache: each request of the
    served trace alone at batch 1 gives the tokens it got in the
    continuous batch, bit for bit (the recurrent states copied in at
    admission, the rings, and the batch-invariant kernels)."""
    for req, got in zip(trace, tokens):
        want = solo_greedy(params, cfg, req.prompt, req.max_tokens, max_len,
                           frames=req.frames)
        if not np.array_equal(got, want):
            raise RuntimeError(f"{cfg.name}: continuous != solo greedy for "
                               f"a {len(req.prompt)}-token prompt: {got} vs "
                               f"{want}")
    log(f"bit identity ({cfg.name}, {cfg.n_layers} layers): {len(trace)} "
        "requests continuous == solo greedy at full width")
    return len(trace)


def recurrent_phases(name, card, *, max_len, long, step_pos,
                     ring_prompts=(), layers=None, int8=False):
    """A recurrent model at full width, its depth cut to ``layers``
    (bf16, random weights from seed 0) on the dense engine: the serve
    trace plus ``long``, 8
    slots of ``max_len`` positions, launches equal to the executed GEMM
    and attention plans; the decode step at ``step_pos`` (CUDA-graph
    device ms, eager ms, its byte bound); continuous == solo greedy on
    every request; the paged engine's refusal; with local layers, the
    ring against a full cache at ``ring_prompts`` and the local
    attention's three plans; with ``int8``, the weights' int8 copy
    (the bf16 copy freed) served in W8A16 and W8A8 on the dense engine
    (the serve trace, the step at ``step_pos``)."""
    cfg = get_config(name)
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, device="cuda")
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _leaves(params)) / 1e9
    log(f"{cfg.name}: full width ({cfg.n_layers} layers "
        f"{'+'.join(cfg.layer_pattern)} x {cfg.repeats}"
        + (f" + {'+'.join(cfg.tail_pattern)}" if cfg.tail_pattern else "")
        + f", d {cfg.d_model}, vocab {cfg.vocab}, bf16): {weights_gb:.2f} GB"
        f" of weights made from seed 0 in {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    trace = long_trace(cfg, long, 21)
    torch.cuda.reset_peak_memory_stats()
    dense = serve_phase(cfg, params, paged=False, trace=trace,
                        max_len=max_len, eager_gate=True)
    dense.pop("_plans")
    dense["step"] = step_phase(cfg, params, paged=False, max_len=max_len,
                               at_pos=step_pos,
                               engine_ms=dense["decode_ms_per_step"])
    try:
        DecodeEngine(params, cfg, batch=8, max_len=max_len, page_size=16,
                     device="cuda")
    except ValueError as e:
        refusal = str(e)
    else:
        raise RuntimeError(f"{cfg.name}: the paged engine took a recurrent "
                           "model")
    log(f"{cfg.name}: the paged engine refuses it: {refusal}")
    out = {"config": cfg.name, "layers": cfg.n_layers,
           "weights_gb": weights_gb, "long_requests": [list(r) for r in long],
           "max_len": max_len, "serve": dense,
           "bit_identity_requests": dense_bit_identity_phase(
               cfg, params, trace, dense.pop("_tokens"), max_len),
           "paged_refusal": refusal}
    if ring_prompts:
        out["ring_vs_full_cache"] = ring_phase(cfg, params, ring_prompts,
                                               H2O_RING_STEPS, max_len,
                                               layer_gate=True)
        out["plans"] = attn_plan_phase(cfg, "local", long[-1][0], max_len)
    if int8:
        out["int8"] = int8_on_the_same_weights(
            cfg, params, max_len=max_len, at_pos=step_pos,
            bf16_step=dense["step"])
    del params
    torch.cuda.empty_cache()
    return out


def int8_on_the_same_weights(cfg, params, **kw):
    """The int8 copy of ``params`` (the bf16 leaves freed as each is
    quantized: the caller's tree is emptied) served by
    :func:`int8_serve_phases` on the dense engine only (``kw`` its
    trace, positions and the bf16 step)."""
    qparams, q_bytes = quantize(params, cfg.name)
    params.clear()
    torch.cuda.empty_cache()
    out = int8_serve_phases(cfg, qparams, paged=False, **kw)
    out.update(q_bytes)
    del qparams
    torch.cuda.empty_cache()
    return out


# ------------------------------- the encoder-decoder, prefix and the rest

def paged_refusal(cfg, params, max_len):
    """The paged engine's refusal of ``cfg`` (its message); raises if the
    engine takes it."""
    try:
        DecodeEngine(params, cfg, batch=8, max_len=max_len, page_size=16,
                     device="cuda")
    except ValueError as e:
        log(f"{cfg.name}: the paged engine refuses it: {e}")
        return str(e)
    raise RuntimeError(f"{cfg.name}: the paged engine took it")


def a9_params(name, card):
    """``name``'s config at full width (its depth cut to
    :data:`A9_LAYERS`, with the reason logged) and random bf16 weights
    from seed 0 on the card."""
    full = get_config(name)
    layers = A9_LAYERS.get(name)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    if name in TIME_CUTS:
        cfg = cut_depth(full, TIME_CUTS[name])
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _leaves(params)) / 1e9
    full_gb = full.param_count() * 2 / 1e9
    cut = "" if layers is None else (
        f"; depth cut {full.n_layers} -> {layers} layers: {full.n_layers} "
        f"layers of bf16 weights (about {full_gb:.0f} GB) do not fit one "
        "80 GB card")
    log(f"{name}: full width (d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.hd}, "
        + (f"{cfg.n_experts} experts top-{cfg.top_k}, " if cfg.n_experts
           else "")
        + (f"{cfg.encoder_layers} encoder layers over {cfg.encoder_seq} "
           "frames, " if cfg.encoder_layers else "")
        + (f"{cfg.prefix_tokens} prefix embeddings, " if cfg.prefix_tokens
           else "")
        + f"vocab {cfg.vocab}, bf16), {cfg.n_layers} layers{cut}; "
        f"{weights_gb:.2f} GB of weights made from seed 0 in {seconds:.1f} s "
        f"[{card}]")
    return cfg, params, {"config": name, "layers": cfg.n_layers,
                         "full_layers": full.n_layers,
                         "weights_gb": weights_gb,
                         "full_weights_gb": full_gb,
                         "init_seconds": seconds}


def whisper_trace(cfg):
    """The serve trace, each request with its own stub frames (F, d) from
    seed 23; a prompt and its new tokens stay within the 448-token
    decoder context."""
    rng = np.random.default_rng(23)
    return [dataclasses.replace(r, frames=rng.standard_normal(
        (cfg.encoder_seq, cfg.d_model), dtype=np.float32))
        for r in serve_trace(cfg)]


@torch.inference_mode()
def encoder_share(cfg, params, frames, serve):
    """Device ms of one request's encoder (24 layers over its frames)
    and of its decoder layers' cross k / v projections (CUDA events,
    median of 5), beside the serve run's mean admission (prefill, to the
    first token) ms."""
    x = torch.as_tensor(frames)[None].cuda()

    def enc():
        e = T._encode(params, cfg, x)
        for ck, _ in T._units(cfg):
            for r in range(cfg.repeats):
                T._project_cross_kv(T._layer(params["layers"][ck], r), cfg,
                                    e)

    times = []
    for _ in range(6):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        enc()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    ms = float(np.median(times[1:]))
    admit = serve["prefill_seconds"] / serve["requests"] * 1e3
    log(f"{cfg.name}: one request's encoder + cross k / v {ms:.2f} ms on "
        f"the device, {ms / admit:.1%} of the mean admission "
        f"({admit:.1f} ms to the first token); TTFT mean "
        f"{serve['ttft_mean_ms']:.0f} ms (queueing included)")
    return {"encoder_and_cross_kv_ms": ms, "admission_ms_mean": admit,
            "share_of_admission": ms / admit}


@torch.inference_mode()
def prefix_phase(cfg, params):
    """internvl2's prefix path: 256 stub patch embeddings and 60 text
    tokens prefilled, then 4 text tokens decoded; the prefill's and each
    step's logits against ``forward(prefix_embeds=)`` over the whole
    sequence at the same position, within 2e-2 of the row's largest
    logit (bf16; the forward runs B3 over all 320 positions, the steps
    B4)."""
    n_pre, n_text = PREFIX_TEXT
    p = cfg.prefix_tokens
    rng = np.random.default_rng(25)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n_text)),
                           device="cuda")
    pre = torch.as_tensor(rng.standard_normal((1, p, cfg.d_model),
                                              dtype=np.float32)) \
        .to("cuda", torch.bfloat16)
    h, _ = T.forward(params, cfg, toks, prefix_embeds=pre, remat=False)
    want = ops.gemm(h[0, p + n_pre - 1:], params["lm_head"],
                    out_dtype=torch.float32)
    cache = T.init_cache(cfg, 1, p + n_text, device="cuda")
    logits, cache = T.prefill(params, cfg, toks[:, :n_pre], cache,
                              prefix_embeds=pre)
    got = [logits[0]]
    if int(cache["pos"][0]) != p + n_pre:
        raise RuntimeError(f"prefix prefill left pos {int(cache['pos'][0])}"
                           f", want {p + n_pre}")
    for i in range(n_pre, n_text - 1):
        logits, cache = T.decode_step(params, cfg, toks[:, i:i + 1], cache)
        got.append(logits[0])
    rel = [((g - w).abs().max() / w.abs().max()).item()
           for g, w in zip(got, want)]
    if not all(np.isfinite(rel)) or max(rel) > 2e-2:
        raise RuntimeError(f"{cfg.name}: prefix prefill + decode against "
                           f"forward, relative errors {rel} (gate 2e-2)")
    log(f"{cfg.name}: {p} prefix embeddings + {n_pre} tokens prefilled, "
        f"{len(got) - 1} decoded: logits within {max(rel):.2e} of the "
        "row's largest against forward(prefix_embeds=) (gate 2e-2): "
        + ", ".join(f"{r:.2e}" for r in rel))
    return {"positions": [p + n_pre - 1 + i for i in range(len(got))],
            "relative_errors": rel, "gate": 2e-2}


def whisper_phases(card):
    """whisper-medium at full width (decoder depth by :data:`TIME_CUTS`)
    on the dense engine: the
    serve trace with per-request frames, 8 slots of 448 positions,
    launches equal to the executed GEMM and attention plans (the
    encoder, the cross k / v and every pass's cross-attention
    included); the encoder's share of an admission; the decode step at
    position :data:`WHISPER_STEP_POS` beside its byte bound (decoder
    weights, self KV and every slot's cross k / v); continuous == solo
    greedy with each request's frames; the paged engine's refusal; the
    weights' int8 copy (the bf16 copy freed) in W8A16 and W8A8 on the
    same trace; the f32 smoke model on the card against the CPU."""
    cfg, params, out = a9_params(WHISPER, card)
    trace = whisper_trace(cfg)
    torch.cuda.reset_peak_memory_stats()
    dense = serve_phase(cfg, params, paged=False, trace=trace,
                        max_len=WHISPER_MAX_LEN, eager_gate=True)
    dense.pop("_plans")
    out["encoder"] = encoder_share(cfg, params, trace[0].frames, dense)
    dense["step"] = step_phase(cfg, params, paged=False,
                               max_len=WHISPER_MAX_LEN,
                               at_pos=WHISPER_STEP_POS,
                               engine_ms=dense["decode_ms_per_step"])
    out["serve"] = dense
    out["bit_identity_requests"] = dense_bit_identity_phase(
        cfg, params, trace, dense.pop("_tokens"), WHISPER_MAX_LEN)
    out["paged_refusal"] = paged_refusal(cfg, params, WHISPER_MAX_LEN)
    out["int8"] = int8_on_the_same_weights(
        cfg, params, trace=trace, max_len=WHISPER_MAX_LEN,
        at_pos=WHISPER_STEP_POS, bf16_step=dense["step"])
    del params
    torch.cuda.empty_cache()
    out["cross_device_max_abs_err"] = cross_device_phase(arch=WHISPER)
    return out


def a9_serve_phases(name, card):
    """``name`` at full width (depth by :data:`A9_LAYERS`) on the dense
    engine: the serve trace (text only), 8 slots of 1024 positions,
    launches equal to the executed plans; the decode step at position
    :data:`A9_STEP_POS` beside its byte bound (a MoE model's with the
    trace's prompts, no bound); continuous == solo greedy
    on every request; for a prefix model, first the prefix prefill +
    decode against forward.  For a model of :data:`A9_PAGED`, then on
    the same weights the paged engine: the serve trace with two
    shared-prefix requests (launches equal to the executed plans, B5 at
    every decode), its decode step, and paged greedy == the
    :data:`A9_PAGED` reference's solo greedy."""
    cfg, params, out = a9_params(name, card)
    if cfg.prefix_tokens:
        out["prefix_vs_forward"] = prefix_phase(cfg, params)
    torch.cuda.reset_peak_memory_stats()
    dense = serve_phase(cfg, params, paged=False)
    dense.pop("_plans")
    # every slot at A9_STEP_POS gives a dense model's byte bound; a MoE
    # step reads the banks of the experts its tokens pick, which the
    # bound's all-weights sum would overstate, so kimi's step decodes
    # the trace's prompts with no bound
    dense["step"] = step_phase(cfg, params, paged=False,
                               at_pos=None if cfg.n_experts
                               else A9_STEP_POS,
                               engine_ms=dense["decode_ms_per_step"])
    out["serve"] = dense
    out["bit_identity_requests"] = dense_bit_identity_phase(
        cfg, params, serve_trace(cfg), dense.pop("_tokens"), 1024)
    if name in A9_PAGED:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        paged = serve_phase(cfg, params, paged=True)
        paged.pop("_plans")
        paged.pop("_tokens")
        paged["step"] = step_phase(cfg, params, paged=True,
                                   at_pos=None if cfg.n_experts
                                   else A9_STEP_POS,
                                   engine_ms=paged["decode_ms_per_step"])
        out["paged_serve"] = paged
        out["paged_bit_identity_reference"] = f"{A9_PAGED[name]} solo"
        out["paged_bit_identity_requests"] = paged_bit_identity_phase(
            cfg, params, reference=A9_PAGED[name])
        out["paged_seconds"] = time.perf_counter() - t0
        log(f"{name} paged phases: {out['paged_seconds']:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


@torch.inference_mode()
def cross_device_phase(mode=None, arch="smollm-360m"):
    """``arch``'s smoke config (f32; default smollm-360m) on the card
    against the same port on the CPU: bf16-free f32 weights, or (``mode``
    "w8a16" / "w8a8") its quantized weights, run in that activation mode;
    an encoder-decoder prefills with stub frames, a prefix model with
    stub prefix embeddings."""
    cfg = get_smoke_config(arch)
    cpu_params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    if mode:
        cpu_params, _ = quant.quantize_params(cpu_params)
    quant.set_activation_mode("w8a8" if mode == "w8a8" else "none")
    gpu_params = to_device(cpu_params, "cuda")
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 12)))
    extra = {}
    if cfg.encoder_layers:
        extra["frames"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
    if cfg.prefix_tokens:
        extra["prefix_embeds"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.prefix_tokens, cfg.d_model), dtype=np.float32))
    max_len = 40 + cfg.prefix_tokens
    c_cache = T.init_cache(cfg, 2, max_len, device="cpu")
    g_cache = T.init_cache(cfg, 2, max_len, device="cuda")
    c_log, c_cache = T.prefill(cpu_params, cfg, toks, c_cache, **extra)
    g_log, g_cache = T.prefill(gpu_params, cfg, toks.cuda(), g_cache,
                               **to_device(extra, "cuda"))
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
    log(f"cross-device{' ' + mode if mode else ''} ({cfg.name}): prefill + "
        f"8 decode steps, card vs CPU max abs err {worst:.2e} (tolerance "
        "1e-4)")
    return worst


def int8_serve_phases(cfg, qparams, *, reference="dense", paged=True,
                      trace=None, max_len=1024, at_pos=None, bf16_step=None):
    """Serve the quantized weights: W8A16 on the dense cache and (with
    ``paged``) the page pool, W8A8 on the dense cache, each pass's
    launches held to its executed plans and its decode step timed from
    CUDA-graph replays (``max_len`` positions a slot, every slot at
    ``at_pos`` when given, beside the bf16 model's ``bf16_step``); then
    continuous == solo greedy and (with ``paged``) paged == ``reference``
    solo greedy in both modes.  ``trace`` defaults to the serve trace.
    The activation mode is W8A16 again after."""
    out = {}
    try:
        for mode in INT8_MODES:
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            quant.set_activation_mode("w8a8" if mode == "w8a8" else "none")
            run = {"serve": serve_phase(cfg, qparams, paged=False, mode=mode,
                                        trace=trace, max_len=max_len)}
            run["serve"]["step"] = step = step_phase(
                cfg, qparams, paged=False, mode=mode, max_len=max_len,
                at_pos=at_pos, engine_ms=run["serve"]["decode_ms_per_step"])
            if bf16_step is not None:
                ms, bf = step["device_ms_per_step"], \
                    bf16_step["device_ms_per_step"]
                step["bf16_device_ms_per_step"] = bf
                log(f"{cfg.name} {mode} decode step: device {ms:.2f} ms "
                    f"against bf16's {bf:.2f} ms ({ms / bf:.2f}x)")
            if paged and mode == "w8a16":
                run["paged_serve"] = serve_phase(cfg, qparams, paged=True,
                                                 mode=mode)
                run["paged_serve"]["step"] = step_phase(
                    cfg, qparams, paged=True, mode=mode,
                    engine_ms=run["paged_serve"]["decode_ms_per_step"])
            run["bit_identity_requests"] = bit_identity_phase(cfg, qparams)
            if paged:
                run["paged_bit_identity_requests"] = \
                    paged_bit_identity_phase(cfg, qparams,
                                             reference=reference)
            run["seconds"] = time.perf_counter() - t0
            log(f"int8 {mode} ({cfg.name}) phases: {run['seconds']:.1f} s")
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
    its recompute, dA and dB.  An encoder-decoder (GELU MLPs): per
    decoder layer its ten GEMMs (self and cross q, k, v, o, w_in + gelu,
    w_out) twice with their dA and dB and w_in's pre-activation
    recompute; per encoder layer (not rematerialized) its six once with
    their dA and dB and the same recompute."""
    if cfg.encoder_layers:
        return cfg.n_layers * (4 * 10 + 1) \
            + cfg.encoder_layers * (3 * 6 + 1) + 4 * LOSS_CHUNKS
    return cfg.n_layers * (2 * 6 + 5 * 2 + 6) + 4 * LOSS_CHUNKS


def train_attn_per_step(cfg) -> int:
    """B3 launches of one remat training step: every attention layer's
    forward and recompute, a decoder layer's cross-attention the same,
    and each encoder layer's once (the backward recomputes through the
    plain reference, which no counter counts)."""
    cross = 2 * cfg.n_layers if cfg.encoder_layers else 0
    return 2 * len(attn_windows(cfg)) + cross + cfg.encoder_layers


class TransposeRecorder:
    """Counts the operands of the backward's planned GEMMs that arrive as
    strided views (Wᵀ for dA, Aᵀ for dB), which the kernels' wrappers
    copy contiguous, by wrapping ``api._plain`` for a ``with``."""

    def __enter__(self):
        self.views = {}
        self._plain = api._plain

        def record(a, b, *args, **kw):
            for t in (a, b) if not G.recording() else ():
                if not t.is_contiguous():
                    key = (tuple(t.shape), t.dtype)
                    self.views[key] = self.views.get(key, 0) + 1
            return self._plain(a, b, *args, **kw)
        api._plain = record
        return self

    def __exit__(self, *exc):
        api._plain = self._plain


def train_cross_device_phase(arch="smollm-360m", optimizer="adamw",
                             seq_len=32):
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
    card steps agree bit for bit is reported (``deterministic``).  A batch
    of 4 rows of ``seq_len`` tokens (an encoder-decoder's with stub
    frames; a windowed model's past its window, so the window masks keys
    on both devices); a GELU MLP model launches no B2."""
    t0 = time.perf_counter()
    cfg = get_smoke_config(arch)
    state = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu",
                          optimizer=optimizer)
    batch = pipeline.make_batch(
        cfg, pipeline.DataConfig(seq_len=seq_len, global_batch=4), 0)
    step = TS.make_train_step(cfg, peak_lr=3e-5, warmup_steps=0,
                              optimizer=optimizer, return_grads=True)
    c_state, c_m = step(state, batch)
    reset_counters()
    g_state, g_m = step(to_device(state, "cuda"), to_device(batch, "cuda"))
    torch.cuda.synchronize()
    launches = counts()
    plain = {n: p.launches for n, (_, p, _, _) in KERNELS.items()}
    ffn = "gemm_grouped" if cfg.n_experts else \
        "flash_attention" if cfg.family == "audio" else "gemm_gated"
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
        f"3e-5, b 4 x s {seq_len}"
        + (f", window {cfg.window}" if cfg.window else "")
        + f"; {time.perf_counter() - t0:.1f} s), card vs CPU max abs err: "
        + ", ".join(
            f"{k} {v:.2e}" for k, v in worst.items())
        + f" (tolerance 1e-4; update/lr 1e-2 on the {clear_n} of {all_n} "
        f"elements whose |grad| > 1e-5); card launches {launches}; two "
        f"card steps from one state equal bit for bit: {deterministic} "
        f"({sum(same)} of {len(same)} gradient and parameter leaves)")
    return {"config": cfg.name, "optimizer": optimizer, "seq_len": seq_len,
            "max_abs_err": worst, "launches": launches,
            "deterministic": deterministic}


def train_phase(cfg, card, ckpt_dir=None, telemetry_base=None, *,
                steps=TRAIN_STEPS, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                optimizer="adamw", grads_at_end=False):
    """``repro_torch.launch.train.train`` on ``cfg`` (smollm-360m at full
    width by default) in bf16: ``steps`` ``optimizer`` steps of ``batch``
    x ``seq`` tokens from seed 0 (an encoder-decoder's rows with stub
    frames), with ``ckpt_dir`` checkpointed there every RESUME_AT steps
    (the saves write on a thread during the later steps; the resume
    phase restarts from the first).  Kernel counts and the executed
    plans are set to 0 just before the run and read, then set to 0
    again, after every step: each step's launches must equal its
    executed plans (B1, B2, B6's chunks), B3 :func:`train_attn_per_step`
    times (forward and remat recompute; a window masks, an encoder and
    the cross-attention run non-causal), no decode kernel and no plain
    version; B3, B6 and (but for a GELU MLP) B2 must launch in every
    step.  Every
    step's loss and grad norm must be finite and every parameter leaf's
    gradient at step 0 finite and non-zero; with ``grads_at_end`` the
    steps keep no gradient (the step frees each leaf once used, as a
    model near the card's memory needs) and the gradient is taken at the
    final parameters instead.  With ``telemetry_base`` the
    run records telemetry: one ``train.step`` span a step, whose ms must
    agree with the step's wall ms within 5 % (the span waits for the
    loss), exported to ``chiprun_out/telemetry_base``."""
    tokens = seq * batch
    flops = cfg.model_flops(tokens, training=True)
    must = ("flash_attention",) + (
        () if cfg.family == "audio" else ("gemm_gated",))
    rows, out, kept = [], {"step_views": {}}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with PlanRecorder() as rec, TransposeRecorder() as tr:
        def on_step(step, state, m, times):
            launches = counts()
            plain = {n: p.launches for n, (_, p, _, _) in KERNELS.items()}
            want = dict({n: 0 for n in launches}, **rec.implied())
            want["flash_attention"] = train_attn_per_step(cfg)
            executed = sum(rec.plans.values())
            if executed != train_gemms_per_step(cfg):
                raise RuntimeError(f"train step {step}: {executed} GEMMs "
                                   f"ran, expected "
                                   f"{train_gemms_per_step(cfg)}")
            if launches != want or any(plain.values()):
                raise RuntimeError(f"train step {step}: launches {launches}"
                                   f" (expected {want}), plain versions "
                                   f"{plain}")
            for k in must:
                if not launches[k]:
                    raise RuntimeError(f"train step {step}: {k} never ran")
            if not launches["gemm_aie"] + launches["gemm_tb_final"]:
                raise RuntimeError(f"train step {step}: no dense GEMM ran "
                                   "(B1 or B6, as the plans pick)")
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gn)):
                raise RuntimeError(f"train step {step}: loss {loss}, "
                                   f"grad norm {gn}")
            if step == 0 and not grads_at_end:
                _check_grads(m["grads"], "train step 0")
            rows.append({
                "step": step, "loss": loss, "grad_norm": gn,
                "lr": float(m["lr"]), "wall_ms": times["wall_ms"],
                "device_ms": times["device_ms"],
                "tokens_per_s": tokens / times["wall_ms"] * 1e3,
                "model_flop_share": flops / (times["wall_ms"] * 1e-3)
                / PEAK_OPS[torch.bfloat16],
                "launches": launches, "gemms_executed": executed})
            out["step_plans"] = dict(rec.plans)
            if tr.views:        # a replayed step passes no wrapper
                out["step_views"] = dict(tr.views)
            if step == steps - 1 and ckpt_dir:    # for the resume phase
                out["final_params"] = map_tree(
                    lambda t: t.detach().cpu(), state.params)
            if step == steps - 1 and grads_at_end:
                kept["params"] = state.params
            log(f"train {cfg.name} step {step}: loss {loss:.4f} gnorm "
                f"{gn:.3f}; wall "
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
                cfg, steps=steps, seq_len=seq, global_batch=batch, seed=0,
                device="cuda", optimizer=optimizer, ckpt_dir=ckpt_dir,
                ckpt_every=RESUME_AT, on_step=on_step,
                return_grads=not grads_at_end)
        finally:
            telemetry.disable()
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if grads_at_end:        # the steps' state is freed but its parameters
        batch_ = pipeline.make_batch(cfg, pipeline.DataConfig(
            seq_len=seq, global_batch=batch, seed=0), 0, "cuda")
        _check_grads(TS.value_and_grad(kept.pop("params"), cfg, batch_)[2],
                     f"train {cfg.name} at the final parameters")
        del batch_
    if trec is not None:
        spans = [e for e in trec.events if e["name"] == "train.step"]
        if [e["attrs"]["step"] for e in spans] != list(range(steps)):
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
    steady = rows[1:]
    out.update({"config": cfg.name, "dtype": cfg.dtype, "steps": rows,
                "optimizer": optimizer, "batch": batch, "seq": seq,
                "final": final, "seconds": seconds,
                "tokens_per_step": tokens, "model_flops_per_step": flops,
                "peak_memory_bytes": peak,
                "launches": {k: sum(r["launches"][k] for r in rows)
                             for k in rows[0]["launches"]}})
    for key in ("wall_ms", "device_ms", "tokens_per_s", "model_flop_share"):
        out[f"steady_{key}"] = float(np.median([r[key] for r in steady]))
    log(f"train {cfg.name} {cfg.dtype} b {batch} x s {seq}, {optimizer}, "
        f"steps 1-{steps - 1} (median): wall "
        f"{out['steady_wall_ms']:.1f} ms, device "
        f"{out['steady_device_ms']:.1f} ms, "
        f"{out['steady_tokens_per_s']:.0f} tok/s, model-FLOP share "
        f"{out['steady_model_flop_share']:.2%} ({flops / 1e12:.2f} TFLOP a "
        f"step over 989 TFLOP/s); peak memory {peak / 1e9:.2f} GB "
        f"(max_memory_allocated); launches a step "
        f"{rows[-1]['launches']} [{card}]")
    return out


#: the graph == eager train gate's steps
TRAIN_GRAPH_STEPS = 3


def train_graph_phase(cfg, card):
    """The compiled training step against the eager ones: from one seed-0
    state of ``cfg`` (smollm-360m at full width, bf16, b 8 x s 512,
    AdamW, warmup 1, peak lr 3e-4) three copies run TRAIN_GRAPH_STEPS
    steps on the same batches: the step that returns a new state
    (``make_train_step``), the eager consuming step
    (``consume=True``) and the consuming step replayed from one CUDA
    graph (``launch.train.CapturedStep``; its first call is the
    capture's eager warm-up).  After every step the three agree bit for
    bit on the loss, the grad norm, every parameter and both AdamW
    moments, and launch the same kernels as often.  Each step's wall ms
    (host clock between synchronizes), tokens/s and model-FLOP share
    are reported, the steady figures (steps 1 on) by mode, with the
    peak memory of each mode's run."""
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops = cfg.model_flops(tokens, training=True)
    base = TS.init_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", optimizer="adamw")
    kw = dict(optimizer="adamw", warmup_steps=1, peak_lr=3e-4,
              total_steps=TRAIN_GRAPH_STEPS, n_loss_chunks=LOSS_CHUNKS)
    modes = {"new_state": TS.make_train_step(cfg, **kw),
             "consuming": TS.make_train_step(cfg, consume=True, **kw),
             "graph": train_launch.CapturedStep(
                 TS.make_train_step(cfg, consume=True, **kw))}
    states = {name: map_tree(torch.clone, base) for name in modes}
    del base
    data = pipeline.DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                               seed=0)
    ms = {name: [] for name in modes}
    peaks = {name: 0 for name in modes}
    for i in range(TRAIN_GRAPH_STEPS):
        batch = pipeline.make_batch(cfg, data, i, "cuda")
        got, launched = {}, {}
        for name, fn in modes.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            t0 = time.perf_counter()
            states[name], m = fn(states[name], batch)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
            launched[name] = counts()
            got[name] = (m["loss"].clone(), m["grad_norm"].clone())
        for name in ("consuming", "graph"):
            same = [torch.equal(a, b) for a, b in zip(got[name],
                                                      got["new_state"])]
            same += [torch.equal(a, b) for a, b in zip(
                tree_leaves(dict(p=states[name].params,
                                 mu=states[name].opt.mu,
                                 nu=states[name].opt.nu)),
                tree_leaves(dict(p=states["new_state"].params,
                                 mu=states["new_state"].opt.mu,
                                 nu=states["new_state"].opt.nu)))]
            if not all(same) or launched[name] != launched["new_state"]:
                raise RuntimeError(
                    f"train graph gate, step {i}: the {name} step differs "
                    f"from the new-state step in {same.count(False)} of "
                    f"{len(same)} values (loss, grad norm, leaves); "
                    f"launches {launched[name]} against "
                    f"{launched['new_state']}")
    if modes["graph"].graph.replays != TRAIN_GRAPH_STEPS - 1:
        raise RuntimeError(f"train graph gate: "
                           f"{modes['graph'].graph.replays} replays")
    out = {"config": cfg.name, "steps": TRAIN_GRAPH_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "wall_ms": ms,
           "peak_memory_bytes": peaks, "launches_a_step":
               launched["graph"]}
    for name, walls in ms.items():
        steady = float(np.median(walls[1:]))
        out[name] = {"steady_wall_ms": steady,
                     "tokens_per_s": tokens / steady * 1e3,
                     "model_flop_share": flops / (steady * 1e-3)
                     / PEAK_OPS[torch.bfloat16]}
    log(f"train graph gate {cfg.name} bf16 b {TRAIN_BATCH} x s {TRAIN_SEQ} "
        f"AdamW, {TRAIN_GRAPH_STEPS} steps: the captured step == the eager "
        "consuming step == the new-state step bit for bit (loss, grad norm, "
        "every parameter and both moments, each step), launches equal; "
        "steady wall (steps 1 on) "
        + "; ".join(f"{name} {out[name]['steady_wall_ms']:.1f} ms, "
                    f"{out[name]['tokens_per_s']:.0f} tok/s, model-FLOP "
                    f"share {out[name]['model_flop_share']:.2%}, peak "
                    f"{peaks[name] / 1e9:.2f} GB" for name in modes)
        + f" (steps {', '.join(f'{n}: ' + ' / '.join(f'{x:.1f}' for x in w) for n, w in ms.items())} ms) [{card}]")
    del states, modes
    torch.cuda.empty_cache()
    return out


def _check_grads(grads, tag):
    """Every gradient leaf finite and non-zero, or raise."""
    for key, g in _paths(grads):
        if not torch.isfinite(g.float()).all() \
                or not g.float().abs().sum() > 0:
            raise RuntimeError(f"{tag}: the gradient of {key} is zero or "
                               "non-finite")


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


# --------------------- training the windowed and encoder-decoder families

#: (layers, steps, batch, sequence) of each family's full-width training
#: run: h2o-danube-3-4b at its full 24 layers (the consuming step's meta
#: peak 55.09 GB; the step that returned a new state needed 112.07 GB),
#: one row of 4608 tokens, past its 4096-token window; whisper-medium at
#: full depth, 8 rows of its 448-token decoder context, each over 1500
#: stub frames.  The attention backward recomputes through the plain f32
#: reference (blocked past 1024 positions): its score blocks, h x s x s x
#: 4 bytes a layer in all (2.7 GB for h2o's, 1.2 GB for whisper's
#: encoder), bound the length
A9_TRAIN = {H2O: (None, 3, 1, 4608), WHISPER: (None, 3, 8, 448)}
#: the smoke configs' card-against-CPU step: h2o's 64 tokens run past its
#: 32-token smoke window
A9_TRAIN_CROSS_SEQ = {H2O: 64, WHISPER: 32}


def a9_train_phase(name, card):
    """:func:`train_phase` on ``name`` at full width (depth by
    :data:`A9_TRAIN`), with the optimizer ``select_optimizer`` gives the
    full-depth config; the peak memory is reckoned and logged first (12
    bytes a parameter under the consuming step: the bf16 parameters and
    gradients, and AdamW's two f32 moments; plus one layer's f32
    attention scores in the backward), then measured."""
    t0 = time.perf_counter()
    full = get_config(name)
    layers, steps, batch, seq = A9_TRAIN[name]
    cfg = full if layers is None else \
        dataclasses.replace(full, n_layers=layers)
    optimizer = TS.select_optimizer(full)
    n = cfg.param_count()
    per_param = 2 * 2 + (8 if optimizer == "adamw" else 0)
    skv = cfg.encoder_seq or seq
    scores = cfg.n_heads * (batch * skv * skv) * 4
    reckoned = n * per_param + scores
    log(f"train {name}: full width, {cfg.n_layers} of {full.n_layers} "
        f"layers, {optimizer} (select_optimizer of the {full.n_layers}-"
        f"layer config), b {batch} x s {seq}"
        + (f" (window {cfg.window}: the window masks keys)" if cfg.window
           else "")
        + (f", {cfg.encoder_seq} stub frames a row" if cfg.encoder_layers
           else "")
        + f"; reckoned peak {reckoned / 1e9:.1f} GB: {n / 1e9:.2f} G "
        f"parameters x {per_param} B (bf16 parameters and gradients"
        + (", AdamW's two f32 moments" if optimizer == "adamw" else "")
        + f") + {scores / 1e9:.2f} GB of one layer's f32 attention scores "
        f"in the backward [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train {name}: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "allocated before the run")
    run = train_phase(cfg, card, steps=steps, seq=seq, batch=batch,
                      optimizer=optimizer, grads_at_end=True)
    run.pop("step_plans")
    run.pop("step_views")
    run.update(layers=cfg.n_layers, full_layers=full.n_layers,
               reckoned_peak_bytes=reckoned,
               phase_seconds=time.perf_counter() - t0)
    log(f"train {name}: peak {run['peak_memory_bytes'] / 1e9:.2f} GB "
        f"against {reckoned / 1e9:.1f} GB reckoned; phase "
        f"{run['phase_seconds']:.1f} s")
    torch.cuda.empty_cache()
    return run


def a9_train_kernel_phase():
    """B3 at the two training shapes, held to its plain version and
    timed beside SDPA and its bound: h2o's 1 x 4608 (h 32/8, d 120,
    window 4096; 2 launches a layer a step, forward and recompute) and
    whisper's encoder 8 x 1500 x 1500 (MHA h 16, d 64, non-causal; 24
    launches a step).  {model: check_kernel(...)}."""
    h2o, wh = get_config(H2O), get_config(WHISPER)
    _, _, hb, hs = A9_TRAIN[H2O]
    wb = A9_TRAIN[WHISPER][2]
    F_ = wh.encoder_seq
    cases = {
        H2O: attn_case(
            f"train h2o {hb}x{hs} h{h2o.n_heads}/{h2o.n_kv_heads} "
            f"d{h2o.hd} window {h2o.window}",
            2 * (A9_TRAIN[H2O][0] or h2o.n_layers), hb, hs,
            h2o.n_heads, h2o.n_kv_heads, h2o.hd, torch.bfloat16,
            window=h2o.window),
        WHISPER: attn_case(
            f"train whisper encoder {wb}x{F_} h{wh.n_heads}/"
            f"{wh.n_kv_heads} d{wh.hd} non-causal", wh.encoder_layers, wb,
            F_, wh.n_heads, wh.n_kv_heads, wh.hd, torch.bfloat16,
            causal=False)}
    with torch.inference_mode():
        return {name: check_kernel("flash_attention", [case])
                for name, case in cases.items()}


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
    # the step consumes its state: each run on a copy of it
    (s1, m1), (s2, m2) = (step_fn(map_tree(torch.clone, state), batch)
                          for _ in range(2))
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
#: many layers: the deepest whose consuming step the dry-run fits in 80
#: GB with 5 % to spare (meta peaks 22.41 / 41.46 / 60.95 GB at 1 / 2 / 3
#: layers, about 80.4 at 4; the step that returned a new state peaked at
#: 47.60 GB at 1)
MOE_TRAIN_LAYERS = 3
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
    version run; loss and grad norm finite.  The last step
    is traced with ``torch.profiler`` (device busy time by kernel
    family, ``tools/train_profile.py``'s summary).  Then the loss and
    gradients at the final parameters are taken twice: every gradient
    leaf must be finite and non-zero (router and banks included), and
    whether the two agree bit for bit says whether the MoE step is
    deterministic.  The steps keep no gradient (``return_grads`` off:
    the step the dry-run fits in 80 GB frees each gradient leaf once the
    optimizer has used it); the first gradients are copied to the host
    before the second are taken."""
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    optimizer = TS.select_optimizer(full)
    log(f"{full.name} training: full width, depth cut {full.n_layers} -> "
        f"{MOE_TRAIN_LAYERS} layer(s), {optimizer} (the full model's "
        f"optimizer), the consuming step (eager: MoE training reads the "
        f"group sizes on the host): the deepest the dry-run fits in 80 GB "
        f"with 5 % to spare ({cfg.param_count() * 2 / 1e9:.2f} GB of bf16 "
        f"parameters)")
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
                out["step_plans"], out["step_views"] = dict(rec.plans), \
                    dict(tr.views)
                out["group_sizes"] = rec.group_sizes.cpu().tolist()
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
            optimizer=optimizer, on_step=on_step)
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    profile = train_profile.summarize(kept.pop("prof"))
    # the same loss and gradients twice, at the final parameters
    batch = pipeline.make_batch(
        cfg, pipeline.DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                 seed=0), 0, "cuda")
    l1, _, g1 = TS.value_and_grad(kept["params"], cfg, batch)
    _check_grads(g1, "MoE train at the final parameters")
    g1 = map_tree(lambda t: t.cpu(), g1)
    l2, _, g2 = TS.value_and_grad(kept["params"], cfg, batch)
    spread = max([abs(float(l1) - float(l2))] + [
        (a.to(b.device).float() - b.float()).abs().max().item()
        for a, b in zip(tree_leaves(g1), tree_leaves(g2))])
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


# ---------------------------------------------------------------- phase 13

#: the training steps the op counter wraps on the card, each against the
#: meta trace of the same config and batch: (arch, layers or None, the
#: optimizer) at b TRAIN_BATCH x s TRAIN_SEQ, as phases 7b and 9 train
OP_COST_STEPS = (("smollm-360m", None, "adamw"),
                 ("qwen3-moe-235b-a22b", MOE_TRAIN_LAYERS, "adafactor"))
#: h2o-danube-3-4b training at b 1 x s 4608, traced on meta only, at 24
#: and 8 layers: the consuming step fits both (the step that returned a
#: new state needed 112.07 GB at 24, and ran out of memory on the card);
#: phase 11 trains the 24 layers on the card
OP_COST_H2O = (24, 8)
#: the meta peak against max_memory_allocated for the same step
PEAK_TOL = 0.10
#: the cells the dry-run's --measure runs, with their debug meshes: the
#: dense decode on one rank (B2 and B6 plans at 128 rows) and the MoE's
#: on rank 0 of 16 data ranks (8 rows: B1 for wk / wv / wo and the f32
#: router, B6, and B7 over 64 routed rows)
MEASURE_CELLS = (("smollm-360m", "decode_32k", "1,1"),
                 ("qwen3-moe-235b-a22b", "decode_32k", "16,1"))
#: a plan's kernel by its GemmPlan.kernel
PLAN_KERNEL = {"aie": "gemm_aie", "tb": "gemm_tb", "gated": "gemm_gated",
               "grouped": "gemm_grouped"}
#: scopes whose counts follow B7's rows (live on the card, capacity on
#: meta), compared apart
ROW_SCOPES = ("gemm_grouped", "grouped_db")


def _op_cost_cfg(name, layers):
    full = get_config(name)
    return full if layers is None else dataclasses.replace(full,
                                                           n_layers=layers)


def meta_step_cost(name, layers, optimizer, batch, seq) -> dict:
    """One consuming training step of ``name`` (``layers`` deep) traced
    on the meta device under ``repro_torch.core.op_cost``: its counts and
    peak (a task of phase 13's process pool; it touches no card)."""
    cfg = _op_cost_cfg(name, layers)
    state = TS.state_struct(cfg, optimizer)
    rows = pipeline.batch_spec(cfg, pipeline.DataConfig(
        seq_len=seq, global_batch=batch))
    step = TS.make_train_step(cfg, optimizer=optimizer, consume=True)
    t0 = time.perf_counter()
    with op_cost.count(hold=(state, rows)) as c:
        step(state, rows)
    return dict(c.result().as_dict(), seconds=time.perf_counter() - t0)


def card_step_cost(name, layers, optimizer, card) -> dict:
    """The same step as :func:`meta_step_cost` on the card, from seed-0
    weights: counted, and its peak read from the allocator (the growth of
    ``max_memory_allocated`` over what was allocated before it, plus the
    state and batch it holds)."""
    cfg = _op_cost_cfg(name, layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = TS.init_state(cfg, gen, device="cuda", optimizer=optimizer)
    rows = pipeline.make_batch(cfg, pipeline.DataConfig(
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0), 0, "cuda")
    step = TS.make_train_step(cfg, optimizer=optimizer, consume=True)
    held = sum(op_cost.storages((state, rows)).values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counters()
    t0 = time.perf_counter()
    with op_cost.count(hold=(state, rows)) as c:
        new, m = step(state, rows)
        loss = float(m["loss"])
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before + held
    launches = counts()
    del new, m, state, rows
    torch.cuda.empty_cache()
    if not math.isfinite(loss):
        raise RuntimeError(f"op-cost step of {cfg.name}: loss {loss}")
    return dict(c.result().as_dict(), allocator_peak_bytes=peak,
                seconds=seconds, launches=launches, loss=loss)


def _compare_counts(tag, card_run, meta_run) -> dict:
    """Card and meta counts scope by scope: equal outside B7's row
    scopes (else raise); those printed apart."""
    out = {}
    for key in ("flops_by_scope", "bytes_by_scope", "calls_by_scope"):
        a, b = card_run[key], meta_run[key]
        same = {s for s in a if s not in ROW_SCOPES}
        if {s: a[s] for s in same} != {s: b.get(s) for s in same} \
                or set(a) != set(b):
            raise RuntimeError(f"op cost {tag}: {key} on the card {a} != "
                               f"meta {b}")
        out[key] = {s: (a[s], b[s]) for s in a if s in ROW_SCOPES}
    if card_run["collective_bytes"] != meta_run["collective_bytes"]:
        raise RuntimeError(f"op cost {tag}: collective bytes differ")
    return out


def op_cost_phase(card, h2o_peak=None):
    """Phase 13: the port's op counter and dry-run on the card.

    1. For each step of :data:`OP_COST_STEPS`, one step on the card under
       the counter against the meta trace of the same config and batch:
       FLOPs, bytes and calls equal scope by scope but B7's row scopes
       (live rows against capacity, printed apart), and the meta peak
       within :data:`PEAK_TOL` of the card step's allocator peak.
    2. h2o-danube-3-4b training at b 1 x s 4608, predicted on meta only:
       under the card's 80 GB at 24 layers and at 8 (the 24-layer peak
       beside phase 11's run at that depth, ``h2o_peak``).
    3. ``repro_torch.launch.dryrun``'s ``--measure`` for each of
       :data:`MEASURE_CELLS` on its debug mesh: every planned GEMM
       executed on the card and held to its model; between them the
       plans run B1, B2, B6 and B7.
    The meta traces run in a pool of spawned processes while the card
    works."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    jobs = [(name, layers, opt, TRAIN_BATCH, TRAIN_SEQ)
            for name, layers, opt in OP_COST_STEPS] + [
        (H2O, layers, TS.select_optimizer(get_config(H2O)), 1, 4608)
        for layers in OP_COST_H2O]
    out = {"card": card}
    with concurrent.futures.ProcessPoolExecutor(3, mp_context=ctx) as pool:
        metas = [pool.submit(meta_step_cost, *job) for job in jobs]
        cards = {}
        for name, layers, opt in OP_COST_STEPS:
            cards[name] = card_step_cost(name, layers, opt, card)
        measured = {}
        for arch, shape, mesh in MEASURE_CELLS:
            # the cell's own plans, alone in the plan caches
            ops.plan_cache_clear()
            ops.attn_plan_cache_clear()
            rec = dryrun.run_cell(arch, shape, "single", debug_shape=mesh,
                                  measure=True, device="cuda")
            # the harness puts the launch counters back (a sample is no
            # execution of a step): the kernels by the measured plans
            rec["kernels"] = dict(collections.Counter(
                PLAN_KERNEL[pl.kernel] for pl in ops.plans()))
            measured[f"{arch} {shape}"] = rec
        metas = [f.result(timeout=600) for f in metas]
    for (name, layers, _), meta in zip(OP_COST_STEPS, metas):
        run = cards[name]
        tag = f"{name}" + (f" ({layers} layer)" if layers else "")
        apart = _compare_counts(tag, run, meta)
        ratio = meta["peak_bytes"] / run["allocator_peak_bytes"]
        if abs(ratio - 1) > PEAK_TOL:
            raise RuntimeError(
                f"op cost {tag}: meta peak {meta['peak_bytes'] / 1e9:.2f} GB"
                f" against the card's {run['allocator_peak_bytes'] / 1e9:.2f}"
                f" GB (max_memory_allocated), past {PEAK_TOL:.0%}")
        out[tag] = {"card": run, "meta": meta, "row_scopes": apart,
                    "peak_ratio": ratio}
        log(f"op cost {tag} b {TRAIN_BATCH} x s {TRAIN_SEQ}: card == meta "
            f"in every scope but B7's rows; FLOPs {run['flops']:.6e} (meta "
            f"{meta['flops']:.6e}), bytes {run['bytes_accessed']:.6e} "
            f"(meta {meta['bytes_accessed']:.6e}); B7 rows live "
            f"{run['grouped_rows']['live']} / capacity "
            f"{meta['grouped_rows']['capacity']}, row scopes (card, meta) "
            f"{apart}; peak: meta {meta['peak_bytes'] / 1e9:.3f} GB, card "
            f"counter {run['peak_bytes'] / 1e9:.3f} GB, allocator "
            f"{run['allocator_peak_bytes'] / 1e9:.3f} GB (ratio "
            f"{ratio:.4f}); card step {run['seconds']:.1f} s counted, meta "
            f"trace {meta['seconds']:.1f} s; launches {run['launches']} "
            f"[{card}]")
    for layers, meta in zip(OP_COST_H2O, metas[len(OP_COST_STEPS):]):
        peak = meta["peak_bytes"]
        fits = peak <= HOPPER_H100.hbm_bytes
        if not fits:
            raise RuntimeError(f"op cost {H2O} at {layers} layers: meta "
                               f"peak {peak / 1e9:.2f} GB, over 80 GB")
        card_peak = h2o_peak if layers == get_config(H2O).n_layers else None
        out[f"{H2O} ({layers} layers) meta"] = dict(
            meta, fits=fits, card_train_peak_bytes=card_peak)
        log(f"op cost {H2O} {layers} layers b 1 x s 4608 (meta only): peak "
            f"{peak / 1e9:.2f} GB, fits"
            + (f"; phase 11's run at this depth peaked at "
               f"{card_peak / 1e9:.2f} GB (max_memory_allocated over its "
               f"three steps, the first the capture's; ratio "
               f"{peak / card_peak:.4f})"
               if card_peak else "")
            + f"; trace {meta['seconds']:.1f} s")
    out["measure"] = {}
    for cell, rec in measured.items():
        summary = rec["model_vs_measured_summary"]
        if not summary["n_measured"] \
                or summary["n_measured"] != summary["n_plans"]:
            raise RuntimeError(f"dry-run --measure {cell} left plans "
                               f"unmeasured: {summary}")
        out["measure"][cell] = {k: rec[k] for k in (
            "mesh_shape", "layout", "fits", "roofline", "memory_analysis",
            "gemm_plan_cache", "model_vs_measured",
            "model_vs_measured_summary", "kernels", "lower_s")}
        peak = rec["memory_analysis"]["peak_bytes_per_device"]
        log(f"dry-run --measure {cell}, mesh {rec['mesh_shape']} "
            f"({rec['rows_per_device']} rows a rank, cache 32768; peak "
            f"{peak / 1e9:.1f} GB, fits "
            f"{rec['fits']}; trace {rec['lower_s']} s): {summary}; plans by "
            f"kernel {rec['kernels']} [{card}]")
        print(treport.render(rec["model_vs_measured"]), flush=True)
    ran = set().union(*(rec["kernels"] for rec in measured.values()))
    if not {"gemm_aie", "gemm_tb", "gemm_grouped"} <= ran:
        raise RuntimeError(f"dry-run --measure ran the plans of {ran}, "
                           "not B1, B6 and B7")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------- phase 12

#: the two-rank phases: two processes share the one card, on gloo, their
#: collectives staged through pinned host buffers
DIST_RANKS = 2
#: a two-rank phase's time limit: ranks still running are killed
DIST_TIMEOUT = 300
#: the EP phase: one MoE FFN of qwen3-moe-235b-a22b at full width, x of
#: 8 x 300 tokens, capacity factor 16 (nothing drops)
EP_ARCH, EP_ROWS, EP_SEQ, EP_CAPACITY = "qwen3-moe-235b-a22b", 8, 300, 16.0
#: the EP gradients against the one-process layer's: max |diff| over the
#: tensor's largest |value| (the bf16 gate).  They are not bit for bit:
#: a bank's dB sums each expert's rows, which EP receives source by
#: source (a rank's sequence slice at a time) where one process holds
#: them in token order, and dx sums a token's k contributions with an
#: atomic scatter-add on either side
EP_GRAD_TOL = 2e-2
#: the DP phase: smollm-360m at full width, AdamW at lr 1e-2 from step 0
#: (no warmup), b 8 x s 512 global (4 rows a rank), two steps
DP_ARCH, DP_STEPS, DP_BATCH, DP_SEQ, DP_LR = "smollm-360m", 2, 8, 512, 1e-2
#: its gates against the one-process step from the same state on the
#: same global batch: the loss within 1e-3 of itself, the grad norm
#: within 1e-2 (each rank's bf16 gradient is rounded before the f32
#: mean); AdamW's f32 moments mu and nu (every element of the clipped
#: gradient, and of its square), leaf by leaf, within DP_MOMENT_TOL of
#: the leaf's largest |value|; and the update over lr, on every element
#: whose two gradients are clear of zero (|g| > 1e-6) and of one sign (at
#: least half of all elements: an embedding row no token of the batch
#: reads has none, and a sign apart moves an element the other way),
#: within DP_UPDATE_TOL_F32 on an f32 leaf (the norm scales) and, on a
#: bf16 one, within DP_UPDATE_TOL_BF16 plus the bf16 rounding of the new
#: parameters over lr (two roundings differ by at most one ulp, 2^-7 of
#: the leaf's largest |value|).  The limits are about twice the largest
#: readings of the sound runs (PERF.md section 6).  Against the one-
#: process step that takes each rank's rows as a microbatch, the loss
#: and every gradient (rounded to its leaf's dtype) bit for bit.
DP_LOSS_RTOL, DP_GNORM_RTOL, DP_MOMENT_TOL = 1e-3, 1e-2, 4e-2
DP_UPDATE_TOL_F32, DP_UPDATE_TOL_BF16 = 3e-4, 0.4
#: the served check of the DP checkpoint (``launch/serve.py`` arguments)
DP_SERVE = ("--batch", "2", "--prompt-len", "16", "--steps", "8")


def _rank_main(rank, world, store, out, job, args):
    """One rank of a two-rank phase (a spawned process): join the gloo
    group on the card, run ``job(rank, *args)``, write its result."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as coll
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = coll.init_process_group("cuda", init_method=f"file://{store}",
                                   rank=rank, world_size=world,
                                   local_rank=rank)
    if rank == 0:
        log(f"[dist] {line}")
    try:
        torch.save(job(rank, *args), pathlib.Path(out) / f"rank{rank}.pt")
        coll.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(job, *args, world=DIST_RANKS):
    """``job(rank, *args)`` on ``world`` spawned processes sharing the
    card; their results in rank order.  Raises when a rank fails or is
    still running after :data:`DIST_TIMEOUT` s (it is then killed)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=".ranks_", dir=ROOT))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, str(tmp / "store"), str(tmp), job, args))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        failed = [(r, p.exitcode) for r, p in enumerate(procs)
                  if not p.is_alive() and p.exitcode != 0]
        if late or failed:
            raise RuntimeError(f"{job.__name__}: ranks still running after "
                               f"{DIST_TIMEOUT} s: {late}; failed (rank, "
                               f"exit code): {failed}")
        # written by this script's own ranks
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def _rel_err(got, ref) -> float:
    """max |got - ref| over the largest |ref|."""
    ref = ref.float()
    return float((got.float() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def ep_rank(rank, card):
    """One rank of the EP phase: qwen3-moe-235b-a22b's MoE FFN at full
    width (d 4096, 128 experts top-8, expert d_ff 1536, bf16, weights
    and x from seed 0) on a (data 1, model 2) mesh, this rank holding 64
    experts.  Kernel counts and executed plans are set to 0 just before
    the forward and backward of sum(y * t) (t a seeded f32 weighting)
    and read just after: the launches must equal the executed plans, B7
    must run, no plain version, no token dropped.  Then the one-process
    ``moe_ffn`` on the same weights and inputs (its launches uncounted):
    the output must equal it bit for bit, the aux loss within 1e-5, and
    this rank's bank gradients, its sequence slice of dx and the router
    gradient summed over the ranks within :data:`EP_GRAD_TOL` (each
    rank's gradient is its term of the summed loss: the replicas of the
    rows double it)."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as coll, sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as MOE
    cfg = get_config(EP_ARCH)
    d, n_exp, k = cfg.d_model, cfg.n_experts, cfg.top_k
    mesh = make_host_mesh(data=1, model=DIST_RANKS, device="cuda")
    j, e_loc = mesh.coord["model"], n_exp // DIST_RANKS
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = {n: v[0] for n, v in MOE.init_moe(gen, d, cfg.d_ff, n_exp,
                                             torch.bfloat16, 1).items()}
    x = torch.randn((EP_ROWS, EP_SEQ, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.randn(x.shape, generator=gen, device="cuda")
    block = slice(j * e_loc, (j + 1) * e_loc)
    mine = {n: (v[block].clone() if n.startswith("w_") else v)
            .detach().requires_grad_() for n, v in full.items()}
    bank_gb = sum(v.numel() * v.element_size() for n, v in mine.items()
                  if n.startswith("w_")) / 1e9
    xr = x.detach().requires_grad_()
    trec = telemetry.enable(telemetry.Recorder())
    torch.cuda.synchronize()
    reset_counters()
    try:
        with PlanRecorder() as rec:
            t0 = time.perf_counter()
            with shd.use_mesh(mesh):
                y, aux = MOE.moe_ffn(mine, xr, top_k=k,
                                     capacity_factor=EP_CAPACITY)
                (y.float() * t).sum().backward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts()
    finally:
        telemetry.disable()
    plain = {n: p.launches for n, (_, p, _, _) in KERNELS.items()}
    want = dict({n: 0 for n in launches}, **rec.implied())
    grouped_plans = sum(n for pl, n in rec.plans.items() if pl.spec.grouped)
    moe_counts = {c: int(trec.snapshot()["counters"].get(c, 0))
                  for c in ("moe.group_sizes", "moe.dropped_tokens")}
    if launches != want or any(plain.values()) \
            or not launches["gemm_grouped"]:
        raise RuntimeError(f"EP rank {rank}: launches {launches} (executed "
                           f"plans {want}), plain versions {plain}")
    if moe_counts["moe.dropped_tokens"] or moe_counts["moe.group_sizes"] \
            != EP_ROWS * EP_SEQ // DIST_RANKS * k:
        raise RuntimeError(f"EP rank {rank}: MoE counters {moe_counts}")
    ref = {n: v.detach().requires_grad_() for n, v in full.items()}
    xref = x.detach().requires_grad_()
    y_ref, aux_ref = MOE.moe_ffn(ref, xref, top_k=k,
                                 capacity_factor=EP_CAPACITY)
    (y_ref.float() * t).sum().backward()
    if not torch.equal(y, y_ref):
        raise RuntimeError(f"EP rank {rank}: the output is not the one-"
                           f"process moe_ffn's bit for bit (max abs diff "
                           f"{(y.float() - y_ref.float()).abs().max()})")
    aux_err = abs(float(aux.detach()) - float(aux_ref.detach())) \
        / abs(float(aux_ref.detach()))
    sl = slice(j * EP_SEQ // DIST_RANKS, (j + 1) * EP_SEQ // DIST_RANKS)
    outside = torch.cat([xr.grad[:, :sl.start], xr.grad[:, sl.stop:]], 1)
    router = coll.all_reduce(mine["router"].grad, dist.group.WORLD) / 2
    errs = {n: _rel_err(mine[n].grad / 2, ref[n].grad[block])
            for n in ("w_gate", "w_up", "w_down")}
    errs["dx"] = _rel_err(xr.grad[:, sl] / 2, xref.grad[:, sl])
    errs["router"] = _rel_err(router, ref["router"].grad)
    if aux_err > 1e-5 or outside.abs().max() > 0 \
            or max(errs.values()) > EP_GRAD_TOL:
        raise RuntimeError(f"EP rank {rank}: gradient errors {errs} "
                           f"(tolerance {EP_GRAD_TOL}), aux {aux_err:.2e}, "
                           f"dx outside the rank's slice "
                           f"{float(outside.abs().max())}")
    log(f"EP rank {rank} ({mesh}): {e_loc} experts ({bank_gb:.2f} GB of "
        f"banks), {EP_ROWS} x {EP_SEQ // DIST_RANKS} tokens of {EP_SEQ}; "
        f"forward + backward {wall * 1e3:.1f} ms; B7 launches "
        f"{launches['gemm_grouped']} against {grouped_plans} executed "
        f"grouped plans (implied {want['gemm_grouped']}); launches "
        f"{launches}; output == one-process moe_ffn bit for bit; gradient "
        f"errors (over the largest |value|) "
        + ", ".join(f"{n} {v:.2e}" for n, v in errs.items())
        + f", aux {aux_err:.1e}; MoE counters {moe_counts} [{card}]")
    return {"rank": rank, "coord": mesh.coord, "experts": e_loc,
            "bank_gb": bank_gb, "wall_ms": wall * 1e3, "launches": launches,
            "executed_grouped_plans": grouped_plans, "implied": want,
            "grad_rel_err": errs, "aux_rel_err": aux_err,
            "moe_counters": moe_counts, "output_bitwise": True}


def _sha(t) -> str:
    import hashlib
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()


def _dp_prompts(cfg):
    """``launch/serve.py --batch 2 --prompt-len 16``'s prompts."""
    return np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)) \
        .astype(np.int32)


def _dp_readings(before, after, ref_after, m, ref_m) -> dict:
    """The DP step against the one-process step from the same state:
    each AdamW moment's largest leaf error over that leaf's largest
    |value|; the update over lr's largest difference on the elements
    whose two gradients are clear of zero and of one sign, on the f32
    leaves and on the bf16 ones (also past their rounding term, see
    :data:`DP_UPDATE_TOL_BF16`)."""
    out = {"mu_rel_err": 0.0, "nu_rel_err": 0.0, "update_over_lr_f32": 0.0,
           "update_over_lr_bf16": 0.0,
           "update_over_lr_bf16_excess": -math.inf, "clear_elements": 0,
           "elements": 0}
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(getattr(after.opt, name)),
                        tree_leaves(getattr(ref_after.opt, name))):
            out[f"{name}_rel_err"] = max(out[f"{name}_rel_err"],
                                         _rel_err(a, b))
    for p0, a, b, ga, gb in zip(*(tree_leaves(x) for x in (
            before.params, after.params, ref_after.params, m["grads"],
            ref_m["grads"]))):
        ga, gb = ga.float(), gb.float()
        clear = (ga.abs() > 1e-6) & (gb.abs() > 1e-6) \
            & (torch.sign(ga) == torch.sign(gb))
        out["clear_elements"] += int(clear.sum())
        out["elements"] += clear.numel()
        if not clear.any():
            continue
        p0f, af, bf = p0.float(), a.float(), b.float()
        worst = float((((af - p0f) - (bf - p0f)).abs() / DP_LR)[clear]
                      .max())
        if p0.dtype == torch.float32:
            out["update_over_lr_f32"] = max(out["update_over_lr_f32"], worst)
            continue
        scale = torch.maximum(p0f.abs(), torch.maximum(af.abs(), bf.abs()))
        out["update_over_lr_bf16"] = max(out["update_over_lr_bf16"], worst)
        out["update_over_lr_bf16_excess"] = max(
            out["update_over_lr_bf16_excess"],
            worst - 2 ** -7 * float(scale.max()) / DP_LR)
    return out


def dp_rank(rank, ckpt_dir, card):
    """One rank of the DP phase: smollm-360m at full width (bf16, seed
    0) on a (data 2, model 1) mesh under ``choose_layout``'s layout,
    AdamW at :data:`DP_LR` without warmup, :data:`DP_STEPS` steps of the
    b 8 x s 512 global batch, this rank's 4 rows.  Kernel counts and
    plans are set to 0 just before each step and read just after: the
    launches must equal the executed plans (B1, B2, B6's chunks; B3 twice
    a layer), with B2, B3 and B6 in the step and no plain version.  Rank
    0 then runs the one-process step from the same state on the global
    batch and holds the loss, grad norm, AdamW moments and update over
    lr to it (the ``DP_*`` gates, :func:`_dp_readings`), and the loss
    and gradients to the one-process step with a rank's rows a
    microbatch, bit for bit.  After the last step every rank takes part in the
    checkpoint (rank 0 writes the gathered state into ``ckpt_dir``);
    rank 0 keeps each leaf's SHA-256 and the greedy tokens of
    ``launch/serve.py --batch 2 --prompt-len 16 --steps 8``'s prompts
    served from its parameters in memory."""
    from repro_torch.dist import collectives as coll, layout
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import elastic
    from repro_torch.checkpoint.checkpointer import _flatten
    cfg = get_config(DP_ARCH)
    mesh = make_host_mesh(data=DIST_RANKS, device="cuda")
    struct = TS.state_struct(cfg, "adamw")
    strategy = layout.choose_layout(cfg, shd.axis_sizes(mesh))
    specs = elastic.state_specs(struct, cfg, mesh)
    state = layout.shard_tree(TS.init_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"),
        specs, mesh)
    step = TS.make_train_step(cfg, peak_lr=DP_LR, warmup_steps=0,
                              return_grads=True, mesh=mesh, specs=specs)
    ref_step = TS.make_train_step(cfg, peak_lr=DP_LR, warmup_steps=0,
                                  return_grads=True)
    micro_step = TS.make_train_step(cfg, peak_lr=DP_LR, warmup_steps=0,
                                    microbatches=DIST_RANKS,
                                    return_grads=True)
    data = pipeline.DataConfig(seq_len=DP_SEQ, global_batch=DP_BATCH)
    rows = []
    for i in range(DP_STEPS):
        batch = pipeline.make_batch(cfg, data, i, "cuda")
        mine = train_launch.rank_rows(batch, mesh)
        before = layout.gather_tree(state, specs, mesh)
        torch.cuda.synchronize()
        reset_counters()
        with PlanRecorder() as rec:
            t0 = time.perf_counter()
            state, m = step(state, mine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts()
        plain = {n: p.launches for n, (_, p, _, _) in KERNELS.items()}
        want = dict({n: 0 for n in launches}, **rec.implied())
        want["flash_attention"] = train_attn_per_step(cfg)
        executed = sum(rec.plans.values())
        if launches != want or any(plain.values()) \
                or executed != train_gemms_per_step(cfg) or not all(
                    launches[n] for n in ("gemm_gated", "flash_attention")) \
                or not launches["gemm_aie"] + launches["gemm_tb_final"]:
            raise RuntimeError(f"DP rank {rank} step {i}: launches "
                               f"{launches} (executed plans {want}, "
                               f"{executed} GEMMs), plain {plain}")
        row = {"step": i, "wall_ms": wall * 1e3, "launches": launches,
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "rows": int(mine["tokens"].shape[0])}
        after = layout.gather_tree(state, specs, mesh)
        if rank == 0:
            ref_after, ref_m = ref_step(before, batch)
            row["ref_loss"] = float(ref_m["loss"])
            row["ref_grad_norm"] = float(ref_m["grad_norm"])
            row.update(_dp_readings(before, after, ref_after, m, ref_m))
            loss_err = abs(row["loss"] - row["ref_loss"]) / row["ref_loss"]
            gn_err = abs(row["grad_norm"] - row["ref_grad_norm"]) \
                / row["ref_grad_norm"]
            row.update({"loss_rel_err": loss_err, "grad_norm_rel_err": gn_err})
            log(f"DP step {i}: loss {row['loss']:.5f} (one process "
                f"{row['ref_loss']:.5f}), grad norm {row['grad_norm']:.4f} "
                f"({row['ref_grad_norm']:.4f}); moments over their leaf's "
                f"largest value: mu {row['mu_rel_err']:.3e}, nu "
                f"{row['nu_rel_err']:.3e}; update over lr max diff: f32 "
                f"leaves {row['update_over_lr_f32']:.3e}, bf16 leaves "
                f"{row['update_over_lr_bf16']:.3e} "
                f"({row['update_over_lr_bf16_excess']:.3e} past their "
                f"rounding) on {row['clear_elements']} of "
                f"{row['elements']} elements; rank 0 wall "
                f"{row['wall_ms']:.1f} ms; launches {launches} [{card}]")
            del ref_after, ref_m
            _, micro_m = micro_step(before, batch)
            row["micro_bitwise"] = bool(torch.equal(m["loss"],
                                                    micro_m["loss"])) and all(
                torch.equal(a, b.to(a.dtype)) for a, b in zip(
                    tree_leaves(m["grads"]), tree_leaves(micro_m["grads"])))
            del micro_m
            log(f"DP step {i}: loss and gradients == the one-process step "
                f"with a rank's rows a microbatch, bit for bit: "
                f"{row['micro_bitwise']}")
            if loss_err > DP_LOSS_RTOL or gn_err > DP_GNORM_RTOL \
                    or max(row["mu_rel_err"], row["nu_rel_err"]) \
                    > DP_MOMENT_TOL \
                    or row["update_over_lr_f32"] > DP_UPDATE_TOL_F32 \
                    or row["update_over_lr_bf16_excess"] \
                    > DP_UPDATE_TOL_BF16 \
                    or row["clear_elements"] < row["elements"] / 2 \
                    or not row["micro_bitwise"]:
                raise RuntimeError(f"DP step {i} off the one-process "
                                   f"step's: {row}")
        del before, after, m
        torch.cuda.empty_cache()
        coll.barrier()
        rows.append(row)
    t0 = time.perf_counter()
    Checkpointer(ckpt_dir).save(DP_STEPS, state, shardings=elastic
                                .state_shardings(struct, cfg, mesh))
    out = {"rank": rank, "layout": strategy, "steps": rows,
           "save_s": time.perf_counter() - t0,
           "launches": {n: sum(r["launches"][n] for r in rows)
                        for n in rows[0]["launches"]}}
    whole = layout.gather_tree(state, specs, mesh)
    if rank == 0:
        out["sha256"] = {k: _sha(v) for k, v in _flatten(whole)}
        engine = DecodeEngine(whole.params, cfg, batch=2, max_len=24,
                              device="cuda")
        out["tokens"] = np.asarray(engine.generate(_dp_prompts(cfg),
                                                   8).tokens)
    return out


def dist_rank(rank, ckpt_dir, card):
    """One rank of phase 12: the EP phase, then the DP phase, each with
    its seconds on this rank's clock."""
    t0 = time.perf_counter()
    ep = ep_rank(rank, card)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    dp = dp_rank(rank, ckpt_dir, card)
    return {"ep": dict(ep, seconds=t1 - t0),
            "dp": dict(dp, seconds=time.perf_counter() - t1)}


def dist_phases(card):
    """Phase 12: the EP and DP phases on two ranks sharing the card, then
    the DP checkpoint restored by ``remesh_restore`` in this process (one
    rank) equal, leaf by leaf, to what rank 0 saved (SHA-256 of every
    leaf's bytes), and ``launch/serve.py --ckpt-dir`` on it giving the
    greedy tokens of the parameters the ranks held in memory."""
    import contextlib
    import io
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import elastic
    ckpt_dir = tempfile.mkdtemp(prefix=".dp_ckpt_", dir=ROOT)
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(dist_rank, ckpt_dir, card)
        spawn_s = time.perf_counter() - t0
        ep, dp = [r["ep"] for r in ranks], [r["dp"] for r in ranks]
        ep_s = max(r["seconds"] for r in ep)
        dp_s = max(r["seconds"] for r in dp)
        log(f"two ranks: {spawn_s:.1f} s from spawn to exit; EP phase "
            f"({EP_ARCH} MoE FFN) {ep_s:.1f} s, DP phase ({DP_ARCH}) "
            f"{dp_s:.1f} s on the ranks' clocks")
        cfg = get_config(DP_ARCH)
        t0 = time.perf_counter()
        restored = elastic.remesh_restore(
            Checkpointer(ckpt_dir), TS.state_struct(cfg, "adamw"), cfg,
            make_host_mesh(device="cuda"))
        got = {k: _sha(v) for k, v in _flatten(restored)}
        if got != dp[0]["sha256"]:
            bad = [k for k in got if got[k] != dp[0]["sha256"].get(k)]
            raise RuntimeError("DP checkpoint: the one-rank restore differs "
                               f"from what rank 0 saved in leaves {bad}")
        del restored
        restore_s = time.perf_counter() - t0
        engine = DecodeEngine(serve_launch.load_params(
            cfg, torch.device("cuda"), ckpt_dir), cfg, batch=2, max_len=24,
            device="cuda")
        served = np.asarray(engine.generate(_dp_prompts(cfg), 8).tokens)
        del engine
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_launch.main(["--ckpt-dir", ckpt_dir, *DP_SERVE])
        first = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("[serve] first sequence:")]
        want = dp[0]["tokens"]
        if not np.array_equal(served, want) or first != [
                f"[serve] first sequence: {want[0][:16]} ..."]:
            raise RuntimeError(f"serve --ckpt-dir: tokens {served} / CLI "
                               f"{first}, in memory {want}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"DP phase ({DIST_RANKS} ranks, {DP_ARCH}, layout "
        f"{dp[0]['layout']}): checkpoint restored in one "
        f"process == saved ({len(got)} leaves by SHA-256; "
        f"{restore_s:.1f} s); serve --ckpt-dir tokens == in memory "
        f"{want.tolist()} [{card}]")
    return {"ep": {"config": EP_ARCH, "rows": EP_ROWS, "seq": EP_SEQ,
                   "capacity_factor": EP_CAPACITY, "ranks": ep,
                   "grad_tolerance": EP_GRAD_TOL, "seconds": ep_s},
            "dp": {"config": DP_ARCH, "batch": DP_BATCH, "seq": DP_SEQ,
                   "lr": DP_LR, "ranks": [
                       {k: v for k, v in r.items()
                        if k not in ("sha256", "tokens")} for r in dp],
                   "tokens": want.tolist(), "leaves": len(got),
                   "restore_s": restore_s, "seconds": dp_s},
            "spawn_to_exit_s": spawn_s, "card": card}


def main() -> None:
    global _GEN
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    t_start = time.perf_counter()
    clock = PhaseClock()
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
    clock.mark("build")

    _GEN = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        checked = kernel_phase()
        clock.mark("kernels")
        paged_bitwise = paged_bitwise_phase()
        tb_bitwise = tb_bitwise_phase()
        grouped_bitwise = grouped_bitwise_phase()
        redesign_bitwise = redesign_bitwise_phase()
        decode_forms = decode_form_phase()
        clock.mark("bitwise")
        attn_blocks = attn_block_phase(card)
        clock.mark("attention blocks")
        checked8 = int8_kernel_phase()
        int8_bitwise = int8_bitwise_phase()
        clock.mark("int8 kernels and bitwise")
        api_run = api_phase()
    torch.cuda.empty_cache()
    clock.mark("operator API")

    cfg = get_config("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, device="cuda")
    serve = serve_phase(cfg, params, paged=False, eager_gate=True,
                        telemetry_base="telemetry_smollm_dense")
    paged = serve_phase(cfg, params, paged=True, eager_gate=True,
                        telemetry_base="telemetry_smollm_paged")
    serve["step"] = step_phase(cfg, params, paged=False, telemetry_on=True,
                               engine_ms=serve["decode_ms_per_step"])
    paged["step"] = step_phase(cfg, params, paged=True, telemetry_on=True,
                               engine_ms=paged["decode_ms_per_step"])
    paged.pop("_tokens")
    clock.mark(f"{cfg.name} serve")
    serve_plans = list(serve.pop("_plans")) + list(paged.pop("_plans"))
    plan_sets = {f"{cfg.name} serve": _plan_keys(serve_plans)}
    report = {cfg.name: report_phase(serve_plans, cfg.name, card)}
    del serve_plans
    tuned = {cfg.name: autotune_phase(cfg, params, serve, card)}
    serve.pop("_tokens")
    clock.mark(f"{cfg.name} report and autotune")
    n_bit = bit_identity_phase(cfg, params)
    n_paged_bit = paged_bit_identity_phase(cfg, params)
    cross = cross_device_phase()
    cross8 = {mode: cross_device_phase(mode) for mode in INT8_MODES}
    train_cross = train_cross_device_phase()
    clock.mark(f"{cfg.name} bit identity and cross-device")
    ckpt_dir = tempfile.mkdtemp(prefix=".resume_check_", dir=ROOT)
    try:
        train_run = train_phase(cfg, card, ckpt_dir,
                                optimizer=TS.select_optimizer(cfg),
                                telemetry_base="telemetry_smollm_train")
        step_plans = train_run.pop("step_plans")
        plan_sets[f"{cfg.name} train step"] = _plan_keys(step_plans)
        train_run["transpose_copies"] = transpose_copy_phase(
            train_run.pop("step_views"), card)
        train_checked = train_kernel_phase(step_plans)
        del step_plans
        torch.cuda.empty_cache()
        resume = resume_phase(cfg, train_run, ckpt_dir, card)
        train_graph = train_graph_phase(cfg, card)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del train_run["final_params"]
    torch.cuda.empty_cache()
    clock.mark(f"{cfg.name} train and resume")
    qparams, q_bytes = quantize(params, cfg.name)
    del params
    int8_run = int8_serve_phases(cfg, qparams)
    int8_run.update(q_bytes)
    del qparams
    torch.cuda.empty_cache()
    clock.mark(f"{cfg.name} int8")

    h2o = h2o_phases(card)
    clock.mark(H2O)
    rg = recurrent_phases(RG, card, max_len=RG_MAX_LEN, long=RG_LONG,
                          step_pos=RG_STEP_POS, ring_prompts=RG_RING_PROMPTS,
                          layers=RG_LAYERS, int8=True)
    clock.mark(f"{RG} (bf16 and int8)")
    mamba = recurrent_phases(MAMBA, card, max_len=MAMBA_MAX_LEN,
                             long=MAMBA_LONG, step_pos=MAMBA_STEP_POS,
                             layers=MAMBA_LAYERS)
    clock.mark(MAMBA)

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
                            eager_gate=True,
                            telemetry_base="telemetry_qwen3_moe_dense")
    moe_paged = serve_phase(moe_cfg, moe_params, paged=True)
    moe_serve["step"] = step_phase(moe_cfg, moe_params, paged=False,
                                   telemetry_on=True,
                                   engine_ms=moe_serve["decode_ms_per_step"])
    moe_paged["step"] = step_phase(moe_cfg, moe_params, paged=True,
                                   engine_ms=moe_paged["decode_ms_per_step"])
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
    clock.mark(f"{moe_cfg.name} serve, tuning and calibration")
    # the int8 copy of the same seed-0 weights; the bf16 copy is freed
    moe_q, moe_q_bytes = quantize(moe_params, moe_cfg.name)
    del moe_params
    torch.cuda.empty_cache()
    moe_int8 = int8_serve_phases(moe_cfg, moe_q, reference="paged")
    moe_int8.update(moe_q_bytes)
    del moe_q
    torch.cuda.empty_cache()
    clock.mark(f"{moe_cfg.name} int8")

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
    clock.mark(f"{full.name} train")

    a9 = {WHISPER: whisper_phases(card)}
    clock.mark(f"{WHISPER} (bf16 and int8)")
    for name in (INTERNVL, KIMI, DEEPSEEK, MINITRON):
        a9[name] = a9_serve_phases(name, card)
        clock.mark(name + (" (dense and paged)" if name in A9_PAGED else ""))

    train_a9 = {}
    for name in (H2O, WHISPER):
        cross_train = train_cross_device_phase(
            name, TS.select_optimizer(get_config(name)),
            seq_len=A9_TRAIN_CROSS_SEQ[name])
        train_a9[name] = a9_train_phase(name, card)
        train_a9[name]["cross_device"] = cross_train
        clock.mark(f"train {name}")
    train_a9_checked = a9_train_kernel_phase()
    clock.mark("training B3 rows")
    op_cost_run = op_cost_phase(
        card, h2o_peak=train_a9[H2O]["peak_memory_bytes"])
    clock.mark("op cost and dry-run")
    dist_run = dist_phases(card)
    clock.mark(f"two ranks: EP ({EP_ARCH}) and DP ({DP_ARCH})")

    paths = {cfg.name: (serve, paged), moe_cfg.name: (moe_serve, moe_paged),
             H2O: (h2o["serve"], h2o["paged_serve"]),
             RG: (rg["serve"],), MAMBA: (mamba["serve"],),
             "operator_api": (api_run,), "train": (train_run,),
             f"train {full.name}": (moe_train,),
             **{name: (run["serve"],) for name, run in a9.items()},
             **{f"{name} paged": (run["paged_serve"],)
                for name, run in a9.items() if "paged_serve" in run},
             **{f"train {name}": (run,) for name, run in train_a9.items()}}
    paths[f"ep {EP_ARCH} ({DIST_RANKS} ranks)"] = tuple(
        dist_run["ep"]["ranks"])
    paths[f"dp {DP_ARCH} ({DIST_RANKS} ranks)"] = tuple(
        dist_run["dp"]["ranks"])
    for name, run in tuned.items():         # the tuned plans' serve run
        paths[f"{name} tuned"] = (run["serve"],)
    int8_paths = {}
    for name, run in ((cfg.name, int8_run), (moe_cfg.name, moe_int8),
                      (RG, rg["int8"]), (WHISPER, a9[WHISPER]["int8"])):
        w8a16 = run["w8a16"]
        int8_paths[f"{name} w8a16"] = (w8a16["serve"],) + (
            (w8a16["paged_serve"],) if "paged_serve" in w8a16 else ())
        int8_paths[f"{name} w8a8"] = (run["w8a8"]["serve"],)
    paths.update(int8_paths)

    def driven(counter, runs=sum(paths.values(), ())):
        """Launches on the paths the script drives (by default all: the
        serve runs, dense and paged, in bf16, W8A16 and W8A8, the
        training runs and the operator-API phase)."""
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
        h2o_total = weighted(rows, "h2o_weight")
        if h2o_total is not None:
            entry[H2O] = times(h2o_total, H2O_TIMED_ON[name])
        for model, key, timed_on in ((RG, "rg_weight", RG_TIMED_ON),
                                     (MAMBA, "mamba_weight",
                                      MAMBA_TIMED_ON),
                                     (WHISPER, "whisper_weight",
                                      WHISPER_TIMED_ON),
                                     (KIMI, "kimi_weight", KIMI_TIMED_ON)):
            total = weighted(rows, key)
            if total is not None:
                entry[model] = times(total, timed_on[name])
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
        if name == "flash_attention":
            for model, (_, t_worst, t_total, _) in train_a9_checked.items():
                entry["max_abs_err"] = max(entry["max_abs_err"], t_worst)
                entry[f"train {model}"] = times(t_total,
                                                A9_TRAIN_TIMED_ON[model])
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
        "h2o": h2o, "recurrentgemma": rg, "mamba2": mamba, "a9": a9,
        "dist": dist_run, "op_cost": op_cost_run,
        "a9_train": train_a9,
        "a9_train_cases": {n: rows for n, (rows, *_) in
                           train_a9_checked.items()},
        "train": train_run, "train_cross_device": train_cross,
        "train_graph": train_graph,
        "train_cases": {n: rows for n, (rows, *_) in train_checked.items()},
        "resume": resume, "moe_train": moe_train,
        "moe_train_cross_device": moe_train_cross,
        "moe_train_cases": {n: rows for n, (rows, *_) in
                            moe_train_checked.items()},
        "paged_bitwise": paged_bitwise,
        "tb_bitwise": tb_bitwise, "grouped_bitwise_groups": grouped_bitwise,
        "b3_b2_bitwise": redesign_bitwise, "int8_bitwise": int8_bitwise,
        "decode_forms": decode_forms,
        "attn_blocks": attn_blocks,
        "operator_api": api_run,
        "autotune": tuned, "calibration": calibration,
        "model_vs_measured": report,
        "bit_identity_requests": n_bit,
        "paged_bit_identity_requests": n_paged_bit,
        "cross_device_max_abs_err": cross,
        "cross_device_int8_max_abs_err": cross8,
        "build_seconds": _build.build_seconds,
        "phase_seconds": clock.seconds,
        "seconds": time.perf_counter() - t_start}), indent=1))
    if _build.build_log:
        (out_dir / "ptxas.log").write_text(_build.build_log)
    log("kernels line: ms / plain_ms / bound_ms / library_ms are summed "
        "over the shapes of the step each entry's timed_on names, the "
        f"{moe_cfg.name} key holds the same for the 4-layer MoE, the {H2O} "
        "key for h2o's decode step (B3: its 5000-token prefill), the "
        f"{RG}, {MAMBA}, {WHISPER} and {KIMI} keys for their decode steps "
        f"(B3: recurrentgemma's 3000-token prefill, {KIMI}'s 300-token "
        "one), the "
        "train key for one full-width smollm-360m training step (B7: one "
        f"layer-step of {full.name} training), the train {full.name} key "
        "B1's and B6's f32 router GEMMs of that step, B3's train "
        f"{H2O} / train {WHISPER} keys its launches at those training "
        "shapes, and each GEMM's int8 "
        "object the same for its int8 cases by mode; launches sum the "
        "dense and paged serve runs of the ten models (smollm-360m, "
        f"qwen3-moe, {RG} and {WHISPER} also in W8A16 and W8A8), the "
        "operator-API phase, the four training runs and the two-rank EP "
        "and DP phases (launches_by_path splits them)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
