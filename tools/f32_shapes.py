#!/usr/bin/env python3
"""Times B1's and B6's f32 bodies (csrc/gemm_f32.cuh) at the MoE routers'
and MoE training's f32 shapes on the card: B1 at every compiled CTA shape
(kernels/gemm_aie.py F32_TILES) beside the one it picks, B6 at its 'tb'
plan's tile and at tiles giving one to many k-chunks, the HOPPER_H100
plan through ops.gemm, and torch.matmul (TF32 off).  Each time is the
median of CUDA-graph replays over operand copies that exceed the L2
cache.  Also the largest error against the plain version at qwen3-moe's
dense shapes in f32 and of the f32 W8A16 body at k = 8192.

    python3 tools/f32_shapes.py          # writes chiprun_out/f32_shapes.json
    python3 tools/f32_shapes.py 8x4096x128 8x7168x384   # those shapes only

Needs one NVIDIA card; exits non-zero without one.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import ops  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.core.tiling import TileConfig  # noqa: E402
from repro_torch.kernels import gemm_aie as ga  # noqa: E402
from repro_torch.kernels.gemm_aie import (F32_TILES, gemm_aie,  # noqa: E402
                                          gemm_aie_plain)
from repro_torch.kernels.gemm_tb import gemm_tb  # noqa: E402

F32 = torch.float32
#: the routers (qwen3-moe decode, 300-token prefill, 64-token chunk,
#: batch 1; kimi-k2 decode) and MoE training's router forward / dB and dA
SHAPES = [(8, 4096, 128), (300, 4096, 128), (64, 4096, 128), (1, 4096, 128),
          (8, 7168, 384), (4096, 4096, 128), (4096, 128, 4096)]
TB_TILES = [(8, 1024, 32), (8, 8192, 64), (16, 2048, 64), (32, 1024, 32),
            (64, 512, 32)]
COLD_BYTES = 128 << 20
REPS = 20


def device_ms(fn, inputs):
    """Median device ms of one call over CUDA-graph replays of one call a
    input set."""
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


def b1_at(config):
    """gemm_aie with the f32 CTA shape forced to ``config``."""
    def run(a, b, **kw):
        keep = ga._f32_config
        ga._f32_config = lambda m, n: config
        try:
            return gemm_aie(a, b, **kw)
        finally:
            ga._f32_config = keep
    return run


def tb_at(tile):
    t = TileConfig(*tile, "tb")
    return lambda a, b, **kw: gemm_tb(a, b, tile=t, **kw)


def main():
    if not torch.cuda.is_available():
        sys.exit("f32_shapes: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = {"card": card, "shapes": {}}
    only = [tuple(map(int, a.split("x"))) for a in sys.argv[1:]]
    for m, k, n in only or SHAPES:
        sets = max(2, min(64, COLD_BYTES // ((m * k + k * n) * 4)))
        inputs = [((torch.randn(m, k, device="cuda") / k ** 0.5,
                    torch.randn(k, n, device="cuda")), {"out_dtype": F32})
                  for _ in range(sets)]
        row = {"b1_pick": ga._f32_config(m, n),
               "matmul_us": 1e3 * device_ms(
                   lambda a, b, out_dtype: torch.matmul(a, b), inputs)}
        for c in F32_TILES:
            row[f"b1_{c}_us"] = 1e3 * device_ms(b1_at(c), inputs)
        plan = ops.plan(ops.GemmSpec(a_dtype=F32, b_dtype=F32, out_dtype=F32),
                        (m, k, n)).tile
        tbp = ops.plan(ops.GemmSpec(a_dtype=F32, b_dtype=F32, out_dtype=F32,
                                    strategy="tb"), (m, k, n)).tile
        row["plan"] = f"{plan.strategy} {plan.bm}x{plan.bk}x{plan.bn}"
        row["plan_us"] = 1e3 * device_ms(
            lambda a, b, out_dtype: ops.gemm(a, b, out_dtype=out_dtype),
            inputs)
        for tile in [(tbp.bm, tbp.bk, tbp.bn)] + TB_TILES:
            row["tb_{}x{}x{}_us".format(*tile)] = 1e3 * device_ms(
                tb_at(tile), inputs)
        a, b = inputs[0][0]
        want = gemm_aie_plain(a, b, out_dtype=F32)
        row["b1_err"] = float((gemm_aie(a, b, out_dtype=F32) - want)
                              .abs().max())
        out["shapes"][f"{m}x{k}x{n}"] = row
        print(f"{m}x{k}x{n}", json.dumps(row), flush=True)
        del inputs
    errs = {}
    for m, k, n in [] if only else [(300, 4096, 8192), (300, 4096, 512),
                                    (300, 8192, 4096), (8, 8192, 4096)]:
        a = torch.randn(m, k, device="cuda") / k ** 0.5
        b = torch.randn(k, n, device="cuda")
        kw = {"out_dtype": F32, "bias": torch.randn(n, device="cuda"),
              "activation": "silu",
              "residual": torch.randn(m, n, device="cuda")}
        errs[f"f32 {m}x{k}x{n} bias+silu+res"] = float(
            (gemm_aie(a, b, **kw) - gemm_aie_plain(a, b, **kw)).abs().max())
        w = quant.quantize_weight(torch.randn(k, n, device="cuda"))
        q, s = w["q"], w["scale"]
        errs[f"w8a16_f32 {m}x{k}x{n}"] = float(
            (gemm_aie(a, q, b_scale=s, out_dtype=F32)
             - gemm_aie_plain(a, q, b_scale=s, out_dtype=F32)).abs().max())
    out["max_abs_err"] = errs
    print("max_abs_err", json.dumps(errs))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "f32_shapes.json").write_text(
        json.dumps(out, indent=1))
    print(card)


if __name__ == "__main__":
    main()
