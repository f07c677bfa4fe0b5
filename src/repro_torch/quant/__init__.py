"""Int8 quantization for serving (port of ``repro/quant/__init__.py``).

The paper evaluates int8 GEMMs: 8-bit operands, 32-bit accumulation.
:func:`quantize_params` rewrites every GEMM weight leaf into a
``{"q": int8 (..., k, n), "scale": f32 (..., 1, n)}`` struct, symmetric
per output channel, and ``repro_torch.ops.gemm`` / ``gemm_grouped``
consume those structs on the int8 paths of kernels B1, B2, B6 and B7:
the int8 weights are staged at one byte an element and widened in
registers, so the weight bytes of a decode step, the bytes that bound
it, halve against bf16.

Two serving modes:

* **W8A16** (quantized params, the default): bf16 activations against
  the widened int8 weights, f32 accumulation, the weight scale on the
  kernel's flush.
* **W8A8** (:func:`set_activation_mode` ``("w8a8")``, or
  ``REPRO_W8A8=1``): each non-gated, linear-epilogue GEMM quantizes its
  activations per row to int8 (:func:`quantize_activations`), runs int8
  x int8 on the tensor cores with int32 accumulation and the weight
  scale on the flush, and applies the row scale, bias and residual
  outside.  Gated GEMMs and the grouped expert banks stay W8A16.

Only leaves that flow through ``ops.gemm`` / ``ops.gemm_grouped`` are
rewritten (:data:`QUANT_PATHS`): the attention and MLP projections, the
lm_head and the stacked MoE expert banks.  Embeddings, the MoE router
and norms keep their dtype.  The functions are the JAX package's, on
torch tensors, and keep its numbers bit for bit (``torch.round`` and
``jnp.round`` both round half to even).
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import torch

from repro_torch.kernels import ref as _ref

# leaves consumed via ops.gemm(x, w) with w: (k, n), plus the stacked
# (E, k, n) MoE expert banks consumed via ops.gemm_grouped (their
# per-output-channel scales quantize to (E, 1, n): the per-expert scale
# rows kernel B7 applies on its flush)
QUANT_PATHS = re.compile(
    r"(attn|cross)/w[qkvo]$|mlp/w_(gate|up|down|in|out)$"
    r"|moe/w_(gate|up|down)$"
    r"|(mixer|rec)/(in|out)_proj$|rec/w_[ri]$|lm_head$")


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel (axis -2 = k reduced) int8.  A
    stacked leaf is quantized one leading index at a time (the scale
    reduces over k only, so the values are those of one call), which
    bounds the f32 temporaries to one layer's weights."""
    if w.dim() > 2:
        parts = [quantize_weight(x) for x in w]
        return {"q": torch.stack([p["q"] for p in parts]),
                "scale": torch.stack([p["scale"] for p in parts])}
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_weight(wq: dict, dtype) -> torch.Tensor:
    return (wq["q"].float() * wq["scale"]).to(dtype)


def _walk(tree, fn, path=""):
    """``fn(path, leaf)`` over a tree of nested dicts, a quantized struct
    counting as one leaf; paths join the keys with ``/``."""
    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _walk(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def quantize_params(params) -> Tuple[dict, int]:
    """Quantize every GEMM weight leaf.  Returns (params', n_quantized);
    the other leaves are the same tensors."""
    count = 0

    def one(path, leaf):
        nonlocal count
        if isinstance(leaf, torch.Tensor) and QUANT_PATHS.search(path) \
                and leaf.dim() >= 2:
            count += 1
            return quantize_weight(leaf)
        return leaf

    return _walk(params, one), count


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def param_bytes(params) -> int:
    total = 0

    def one(path, leaf):
        nonlocal total
        if is_quantized(leaf):
            total += _nbytes(leaf["q"]) + _nbytes(leaf["scale"])
        else:
            total += _nbytes(leaf)
        return leaf

    _walk(params, one)
    return total


def gemm_weight_bytes(params) -> int:
    """Device-memory bytes of the GEMM-consumed weight stream: the
    modeled weight traffic of one batched decode step (every projection
    leaf read once; a quantized leaf bills q at one byte an element plus
    its f32 scale vector)."""
    total = 0

    def one(path, leaf):
        nonlocal total
        if is_quantized(leaf):
            total += _nbytes(leaf["q"]) + _nbytes(leaf["scale"])
        elif QUANT_PATHS.search(path) and getattr(leaf, "dim", lambda: 0)() \
                >= 2:
            total += _nbytes(leaf)
        return leaf

    _walk(params, one)
    return total


# --------------------------------------------------------------- W8A8

_ACTIVATION_MODES = ("none", "w8a8")
_activation_mode = "none"


def set_activation_mode(mode: str) -> None:
    """Select the serving activation precision: "none" (W8A16 against
    quantized weights) or "w8a8" (dynamic per-row int8 activations, int8
    x int8 GEMM, int32 accumulation)."""
    global _activation_mode
    if mode not in _ACTIVATION_MODES:
        raise ValueError(f"unknown activation mode {mode!r}")
    _activation_mode = mode


def activation_mode() -> str:
    """The active mode; the ``REPRO_W8A8`` environment variable, when
    set, overrides the setter.  Its values are strict: anything but
    1/true/w8a8 or ""/0/false/none raises."""
    env = os.environ.get("REPRO_W8A8")
    if env is None:
        return _activation_mode
    if env in ("1", "true", "w8a8"):
        return "w8a8"
    if env in ("", "0", "false", "none"):
        return "none"
    raise ValueError(f"REPRO_W8A8={env!r}: use 1/0")


def quantize_activations(x: torch.Tensor, axis: int = -1):
    """Symmetric dynamic per-row int8 activation quantization -> (q,
    scale): the W8A8 front half.  Each row's amax, division and rounding
    touch that row only, so a row's bits do not depend on the batch."""
    return _ref.quantize_int8(x, axis=axis)
