"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU: the ``cuda_device`` fixture
skips it elsewhere, saying so — a skipped test verified nothing.

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: f32 ``atol=rtol=1e-5`` (the kernel sums in another order
than the plain matmul); bf16 outputs compared in f32 at
``atol=rtol=2e-2`` (a few bf16 ulps after differently ordered f32 sums).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.gemm_aie import gemm_aie, gemm_aie_plain
from repro_torch.kernels.gemm_gated import gemm_gated, gemm_gated_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel was not run")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.standard_normal(shape, dtype=np.float32)) \
        .to(device=device, dtype=dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("m,k,n", [(1, 960, 960), (8, 960, 320),
                                   (3, 60, 49152), (300, 2560, 960),
                                   (17, 100, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epi", ["none", "residual", "bias+silu",
                                 "f32out"])
def test_gemm_aie_kernel_matches_plain(cuda_device, m, k, n, dtype, epi):
    a = _randn((m, k), dtype, cuda_device, 0) / k ** 0.5
    b = _randn((k, n), dtype, cuda_device, 1)
    kw = {"out_dtype": dtype}
    if epi == "residual":
        kw["residual"] = _randn((m, n), dtype, cuda_device, 2)
    elif epi == "bias+silu":
        kw.update(bias=_randn((n,), torch.float32, cuda_device, 3),
                  activation="silu")
    elif epi == "f32out":
        kw["out_dtype"] = torch.float32
    got = gemm_aie(a, b, **kw)
    want = gemm_aie_plain(a, b, **kw)
    assert got.dtype == want.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("m,k,n", [(1, 960, 2560), (8, 960, 2560),
                                   (300, 960, 2560), (5, 60, 160)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_gated_kernel_matches_plain(cuda_device, m, k, n, dtype):
    a = _randn((m, k), dtype, cuda_device, 0) / k ** 0.5
    bg = _randn((k, n), dtype, cuda_device, 1)
    bu = _randn((k, n), dtype, cuda_device, 2)
    _close(gemm_gated(a, bg, bu), gemm_gated_plain(a, bg, bu), dtype)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", [
    (1, 300, 300, 15, 5, 64, True, 0),       # smollm prefill
    (1, 7, 7, 15, 5, 64, True, 0),           # short prompt
    (2, 45, 45, 3, 1, 20, True, 0),          # smoke head_dim, ragged sq
    (1, 64, 96, 4, 2, 120, True, 32),        # q_offset, window, d 120
    (1, 40, 40, 2, 2, 64, False, 0),         # non-causal
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, b, sq, skv, hq,
                                              hkv, d, causal, window,
                                              dtype):
    q = _randn((b, sq, hq, d), dtype, cuda_device, 0)
    k = _randn((b, skv, hkv, d), dtype, cuda_device, 1)
    v = _randn((b, skv, hkv, d), dtype, cuda_device, 2)
    kw = dict(causal=causal, window=window)
    _close(flash_attention(q, k, v, **kw),
           flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("b,S,hq,hkv,d,window", [
    (8, 1024, 15, 5, 64, 0),                 # smollm decode
    (3, 50, 3, 1, 20, 0),                    # smoke config
    (2, 300, 16, 1, 128, 64),                # MQA group 16, window
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda_device, b, S, hq, hkv, d,
                                           window, dtype):
    q = _randn((b, hq, d), dtype, cuda_device, 0)
    k = _randn((b, S, hkv, d), dtype, cuda_device, 1)
    v = _randn((b, S, hkv, d), dtype, cuda_device, 2)
    rng = np.random.default_rng(4)
    pos = torch.as_tensor(rng.integers(0, S, (b,)), dtype=torch.int32,
                          device=cuda_device)
    pos[0] = S + 5                            # an idle slot past the end
    _close(flash_decode(q, k, v, pos, window=window),
           flash_decode_plain(q, k, v, pos, window=window), dtype)


def test_kernels_are_batch_invariant(cuda_device):
    """A row's bits do not depend on how many rows share the call —
    the property continuous-batched greedy == solo greedy rests on."""
    dt = torch.bfloat16
    a = _randn((8, 960), dt, cuda_device, 0)
    w = _randn((960, 2560), dt, cuda_device, 1)
    w2 = _randn((960, 2560), dt, cuda_device, 2)
    full = gemm_aie(a, w, out_dtype=dt)
    gated = gemm_gated(a, w, w2)
    for i in (0, 5):
        assert torch.equal(gemm_aie(a[i:i + 1], w, out_dtype=dt),
                           full[i:i + 1])
        assert torch.equal(gemm_gated(a[i:i + 1], w, w2), gated[i:i + 1])
    q = _randn((8, 15, 64), dt, cuda_device, 3)
    k = _randn((8, 256, 5, 64), dt, cuda_device, 4)
    v = _randn((8, 256, 5, 64), dt, cuda_device, 5)
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device) * 30
    out = flash_decode(q, k, v, pos)
    assert torch.equal(flash_decode(q[3:4], k[3:4], v[3:4], pos[3:4]),
                       out[3:4])


def test_launch_counters_count_kernel_launches(cuda_device):
    a = _randn((2, 64), torch.float32, cuda_device, 0)
    w = _randn((64, 32), torch.float32, cuda_device, 1)
    before, plain_before = gemm_aie.launches, gemm_aie_plain.launches
    gemm_aie(a, w)
    assert gemm_aie.launches == before + 1
    assert gemm_aie_plain.launches == plain_before
