"""The assigned input-shape suite and the 40-cell (arch x shape) matrix
(a copy of ``repro/launch/shapes.py`` over the port's configs).

    train_4k      seq 4096   global_batch 256   -> train_step
    prefill_32k   seq 32768  global_batch 32    -> prefill (inference)
    decode_32k    seq 32768  global_batch 128   -> serve_step (1 token,
                                                  KV cache of seq_len)
    long_500k     seq 524288 global_batch 1     -> serve_step; requires
                  sub-quadratic attention: runs only for h2o-danube-3-4b
                  (SWA), mamba2-370m (SSM), recurrentgemma-9b (hybrid);
                  skipped cells are recorded with their reason.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the cell runs; otherwise the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full attention is quadratic / unbounded-KV at 524k; "
                "runs only for SSM/SWA/hybrid archs (task sheet)")
    return None


def all_cells() -> List[Tuple[str, str, Optional[str]]]:
    """All 40 (arch, shape, skip_reason) cells."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            out.append((arch, shape.name, skip_reason(cfg, shape)))
    return out


def runnable_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a, s, skip in all_cells() if skip is None]
