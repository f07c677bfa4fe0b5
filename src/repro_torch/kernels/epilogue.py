"""The GEMM epilogue spec and math (port of ``repro/kernels/epilogue.py``).

:class:`Epilogue` is the declarative, hashable description of what a
GEMM's flush applies; its ``key`` string (``"bias+silu+res"``) is what
the cost model's ``GemmProblem`` carries.  Fixed application order, all
in f32 on the accumulator (after an int8 weight's dequant scale)::

    x -> + bias -> activation -> + residual -> [/ out_scale, round, clip]

``gelu`` is the tanh approximation, like ``jax.nn.gelu``'s default —
``torch.nn.functional.gelu`` defaults to the exact form, so it is named
explicitly here.  The CUDA kernels apply the same order on their
register flush (``csrc/common.cuh``).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """What the GEMM flush applies before the C tile leaves the chip."""

    bias: bool = False
    activation: Optional[str] = None     # "silu" | "gelu" | "relu"
    residual: bool = False
    out_quant: bool = False              # int8 output, caller-given scale

    def __post_init__(self):
        if self.activation is not None \
                and self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")

    def __bool__(self) -> bool:
        return (self.bias or self.activation is not None or self.residual
                or self.out_quant)

    @property
    def key(self) -> str:
        """Canonical string form: e.g. ``"bias+silu+res"``; the empty
        epilogue serializes to ``""``."""
        parts = []
        if self.bias:
            parts.append("bias")
        if self.activation:
            parts.append(self.activation)
        if self.residual:
            parts.append("res")
        if self.out_quant:
            parts.append("q8")
        return "+".join(parts)

    @classmethod
    def parse(cls, key: str) -> "Epilogue":
        """Inverse of :attr:`key`."""
        if not key:
            return cls()
        parts = key.split("+")
        act = [p for p in parts if p in ACTIVATIONS]
        if len(act) > 1:
            raise ValueError(f"multiple activations in {key!r}")
        known = set(act) | {"bias", "res", "q8"}
        bad = [p for p in parts if p not in known]
        if bad:
            raise ValueError(f"unknown epilogue terms {bad} in {key!r}")
        return cls(bias="bias" in parts,
                   activation=act[0] if act else None,
                   residual="res" in parts,
                   out_quant="q8" in parts)

    @classmethod
    def from_args(cls, bias=None, activation: Optional[str] = None,
                  residual=None, out_scale=None) -> "Epilogue":
        """Spec from the optional operand set an op-level call provides."""
        return cls(bias=bias is not None, activation=activation,
                   residual=residual is not None,
                   out_quant=out_scale is not None)


def apply_epilogue(x: torch.Tensor, *, activation: Optional[str] = None,
                   bias: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   out_scale: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """bias -> activation -> residual -> output quantization on an f32
    accumulator; the caller casts to the output dtype (int8 when
    ``out_scale`` quantizes).  The quantization divides by the scale,
    rounds half to even (``torch.round``, as ``jnp.round``) and clips to
    [-127, 127]."""
    if bias is not None:
        x = x + bias.float()
    if activation is not None:
        x = ACTIVATIONS[activation](x)
    if residual is not None:
        x = x + residual.float()
    if out_scale is not None:
        x = torch.clamp(torch.round(x / out_scale.float()), -127, 127)
    return x
