"""Hand-written Hopper kernels and their plain PyTorch versions."""

import torch


def acc_dtype(in_dtype: torch.dtype) -> torch.dtype:
    """The accumulation rule shared by every GEMM kernel: int8 operands
    accumulate in int32, floats in f32."""
    return torch.int32 if in_dtype == torch.int8 else torch.float32


from repro_torch.kernels.gemm_tb import gemm_tb  # noqa: E402,F401
