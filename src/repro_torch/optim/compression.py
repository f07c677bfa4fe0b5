"""int8 error-feedback gradient compression for the cross-pod reduction
(port of ``repro/optim/compression.py``).

Gradients are quantized to int8 (one symmetric scale a tensor) before
the reduction and the quantization residual is carried into the next
step (error feedback).  The arithmetic is the JAX package's: the int8
payloads are summed as int32, the scales summed, and the mean taken
with the mean scale.

    grads, err = compress_psum(grads, err, mesh.group("pod"))
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.bridge import map_tree, zip_trees
from repro_torch.dist import collectives as coll


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.amax(torch.abs(g))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_psum(grads, err, group):
    """Quantize (grads + carried error), sum the int8 payloads over
    ``group`` (as int32), dequantize with the mean scale, and return
    (mean_grads, new_err); ``group`` None is a group of one rank."""
    n = coll.group_size(group)

    def one(g, e):
        gf = g.float() + e
        q, scale = _quantize(gf)
        new_e = gf - q.float() * scale
        total = coll.all_reduce(q.to(torch.int32), group)
        scale_sum = coll.all_reduce(scale, group)
        mean = total.float() * (scale_sum / n) / n
        return mean.to(g.dtype), new_e

    out = zip_trees(one, grads, err)
    return (map_tree(lambda o: o[0], out), map_tree(lambda o: o[1], out))


def init_error(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
