"""Deterministic synthetic LM data pipeline (port of
``repro/data/pipeline.py``).

A batch is drawn by numpy's generator seeded with
``SeedSequence([seed, step, row_start])``, exactly as in the JAX
package, so both packages see the same tokens bit for bit and a restart
at a step reproduces its batch.  Each host draws only its rows of the
global batch.  The batch comes back as tensors on the requested device.
:func:`batch_spec` gives its shapes and dtypes as meta tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    # host sharding: this host materializes rows [row_start, row_start+rows)
    row_start: int = 0
    rows: Optional[int] = None      # None = full global batch


def _tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Markov-ish synthetic stream: a mixture of a random walk and
    uniform resets, so the LM loss is learnable."""
    walk = rng.integers(0, vocab, size=shape, dtype=np.int64)
    out = np.cumsum(walk, axis=-1) % vocab
    resets = rng.random(shape) < 0.1
    out = np.where(resets, walk, out)
    return out.astype(np.int32)


def make_batch(cfg: ModelConfig, data: DataConfig, step: int,
               device="cpu") -> Dict[str, torch.Tensor]:
    """Deterministic batch for ``step`` (this host's rows only):
    ``tokens`` and ``labels`` (rows, text_len) int32, plus the stub
    ``frames`` (audio) or ``prefix_embeds`` (vlm) in the model dtype."""
    rows = data.rows if data.rows is not None else data.global_batch
    rng = np.random.default_rng(
        np.random.SeedSequence([data.seed, step, data.row_start]))
    text_len = data.seq_len - (cfg.prefix_tokens or 0)
    stream = _tokens(rng, (rows, text_len + 1), cfg.vocab)
    batch = {"tokens": torch.from_numpy(np.ascontiguousarray(stream[:, :-1])),
             "labels": torch.from_numpy(np.ascontiguousarray(stream[:, 1:]))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model), dtype=np.float32)) \
            .to(_DTYPES[cfg.dtype])
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (rows, cfg.prefix_tokens, cfg.d_model), dtype=np.float32)) \
            .to(_DTYPES[cfg.dtype])
    return {k: v.to(device) for k, v in batch.items()}


def iterate(cfg: ModelConfig, data: DataConfig, start_step: int = 0,
            device="cpu") -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_batch(cfg, data, step, device)
        step += 1


def batch_spec(cfg: ModelConfig, data: DataConfig) -> Dict[str, torch.Tensor]:
    """Meta tensors of :func:`make_batch`'s shapes and dtypes (the JAX
    package's ShapeDtypeStructs)."""
    rows = data.rows if data.rows is not None else data.global_batch
    text_len = data.seq_len - (cfg.prefix_tokens or 0)
    spec = {k: torch.empty((rows, text_len), dtype=torch.int32,
                           device="meta") for k in ("tokens", "labels")}
    if cfg.family == "audio":
        spec["frames"] = torch.empty(
            (rows, cfg.encoder_seq, cfg.d_model),
            dtype=_DTYPES[cfg.dtype], device="meta")
    if cfg.family == "vlm":
        spec["prefix_embeds"] = torch.empty(
            (rows, cfg.prefix_tokens, cfg.d_model),
            dtype=_DTYPES[cfg.dtype], device="meta")
    return spec
