#!/usr/bin/env python3
"""Where a windowed ring's decode logits part from a full cache's.

    python3 tools/ring_probe.py [--arch recurrentgemma-9b] [--steps 2]

Makes the model at full width and depth (bf16, random weights from seed
0), prefills eight prompts past the window (``chip_smoke.py``'s ring
prompts for the arch) into a dense cache whose windowed layers are
rings of ``window`` slots and into one of ``max_len`` slots, and
decodes the same teacher-forced tokens on each, twice: with the
attention kernel B4 (what serving runs) and with its plain f32 version
(``flash_decode_plain``) in its place.  For each step it prints, by
pair, the largest |a - b| over each row's largest |b| (the quantity
``chip_smoke.py``'s ring gate bounds by 2e-2), the relative L2 error and
the greedy tokens' agreement:

* ring B4 against full B4: the served comparison;
* ring plain against full plain: the same keys in another order, in f32;
* full B4 against full plain: the kernel's own distance from f32.

Needs one card; writes ``chiprun_out/ring_probe.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import ops  # noqa: E402
from repro_torch.bridge import map_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode_plain  # noqa
from repro_torch.models import transformer as T  # noqa: E402

#: (max_len, prompts past the window) a model is probed at
SETUPS = {
    "recurrentgemma-9b": (4096, (2048, 2100, 2300, 2500, 2700, 3000, 3500,
                                 4000)),
    "h2o-danube-3-4b": (8192, (4096, 4100, 4500, 4700, 5000, 5500, 6000,
                               6100)),
}


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    err = (got - want).abs()
    scale = want.abs().max(-1).values
    return {"rel_linf": (err.max(-1).values / scale).max().item(),
            "rel_l2": ((got - want).norm(dim=-1)
                       / want.norm(dim=-1)).max().item(),
            "argmax_agree": (got.argmax(-1) == want.argmax(-1))
            .float().mean().item()}


@torch.inference_mode()
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b",
                    choices=sorted(SETUPS))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ring_probe: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    max_len, prompts = SETUPS[args.arch]
    full_cfg = dataclasses.replace(cfg, window=0, local_window=0)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    rng = np.random.default_rng(23)
    caches = {"ring": T.init_cache(cfg, 8, max_len, device="cuda"),
              "full": T.init_cache(full_cfg, 8, max_len, device="cuda")}
    for slot, p in enumerate(prompts):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, p)),
                               device="cuda")
        _, caches["ring"] = T.prefill_into_slot(params, cfg, toks,
                                                caches["ring"], slot,
                                                max_len=max_len)
        _, sub = T.prefill(params, cfg, toks, T.init_cache(
            full_cfg, 1, max_len, device="cuda"))
        T.insert_cache_slot(caches["full"], sub, slot)
        del sub
    runs = {}
    for name, cache in caches.items():
        for attn in ("b4", "plain"):
            runs[f"{name} {attn}"] = map_tree(torch.clone, cache)
    kernel_decode = ops.decode_attention

    def plain_decode(q, k, v, pos, window=0):
        return flash_decode_plain(q, k, v, pos, window=window)

    rows = []
    for i in range(args.steps):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (8, 1)),
                              device="cuda")
        logits = {}
        for key, cache in runs.items():
            ops.decode_attention = plain_decode if key.endswith("plain") \
                else kernel_decode
            try:
                logits[key], runs[key] = T.decode_step(params, cfg, tok,
                                                       cache)
            finally:
                ops.decode_attention = kernel_decode
        row = {"step": i,
               "ring b4 vs full b4": compare(logits["ring b4"],
                                             logits["full b4"]),
               "ring plain vs full plain": compare(logits["ring plain"],
                                                   logits["full plain"]),
               "full b4 vs full plain": compare(logits["full b4"],
                                                logits["full plain"])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ring_probe.json").write_text(json.dumps(
        {"card": card, "arch": cfg.name, "max_len": max_len,
         "prompts": list(prompts), "steps": rows}, indent=1))
    print(card)


if __name__ == "__main__":
    main()
