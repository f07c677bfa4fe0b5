"""PyTorch + CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

Public functions keep the JAX package's names, arguments and layouts
((b, s, h, d) attention operands, (d_in, d_out) weights, stacked
``layers/u0/...`` parameter leaves).  Every Pallas kernel on the ported
path is a hand-written CUDA kernel under ``csrc/``; a wrapper launches
it for CUDA tensors and runs its plain PyTorch version only for CPU
tensors.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    the first CUDA card.  Without a card and without an explicit device
    this raises — the port never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly "
            "to run the plain PyTorch path on the CPU")
    return torch.device("cuda")
