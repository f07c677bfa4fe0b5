"""The GEMM epilogue math (port of ``repro/kernels/epilogue.py``).

Fixed application order, all in f32 on the accumulator::

    x -> + bias -> activation -> + residual

``gelu`` is the tanh approximation, like ``jax.nn.gelu``'s default —
``torch.nn.functional.gelu`` defaults to the exact form, so it is named
explicitly here.  The CUDA kernels apply the same order on their
register flush (``csrc/common.cuh``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}

#: activation name -> the integer code the CUDA kernels take
ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3}


def apply_epilogue(x: torch.Tensor, *, activation: Optional[str] = None,
                   bias: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """bias -> activation -> residual on an f32 accumulator; the caller
    casts to the output dtype."""
    if bias is not None:
        x = x + bias.float()
    if activation is not None:
        x = ACTIVATIONS[activation](x)
    if residual is not None:
        x = x + residual.float()
    return x
