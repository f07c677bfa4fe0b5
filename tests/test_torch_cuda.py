"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU: the ``cuda_device`` fixture
skips it elsewhere, saying so — a skipped test verified nothing.

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: f32 ``atol=rtol=1e-5`` (the kernel sums in another order
than the plain matmul); bf16 outputs compared in f32 at
``atol=rtol=2e-2`` (a few bf16 ulps after differently ordered f32 sums);
B7's f32 output of bf16 operands at the training shapes ``1e-4``.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_paged,
                                              flash_decode_paged_plain,
                                              flash_decode_plain)
from repro_torch.kernels.gemm_aie import gemm_aie, gemm_aie_plain
from repro_torch.kernels.gemm_gated import gemm_gated, gemm_gated_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: slot positions on both sides of the decode kernels' 64-key splits, and
#: one deep in a 1024-key cache
STRADDLING_POS = [63, 64, 127, 128, 255, 256, 383, 1000]


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


#: qwen3-moe-235b-a22b's dense GEMMs (wq, wk/wv, wo) at decode and in a
#: 300-token prefill
QWEN3_DENSE = [(m, k, n) for m in (8, 300)
               for k, n in ((4096, 8192), (4096, 512), (8192, 4096))]


@pytest.mark.parametrize("m,k,n,dtype", [
    (m, k, n, dtype)
    for m, k, n in [(1, 960, 960), (8, 960, 320), (3, 60, 49152),
                    (300, 2560, 960), (17, 100, 70), (5, 131, 77),
                    # 9..16 rows: the 16-row fragment with every row staged
                    (9, 960, 960), (12, 960, 960), (16, 960, 960)]
    for dtype in (torch.float32, torch.bfloat16)]
    # the tensor-core body at qwen3-moe's shapes (the f32 body is
    # unchanged), 12- and 16-token prompts included
    + [(m, k, n, torch.bfloat16) for m, k, n in
       QWEN3_DENSE + [(12, 4096, 512), (16, 8192, 4096)]]
    # the warp-specialised body's CTA shapes: 64 x 128 (200 x 8192) and,
    # at smollm-360m's training shapes (b 8 x s 512), 128 x 128
    # (n 960) and 128 x 256 (n 2560, 49152)
    + [(m, k, n, torch.bfloat16) for m, k, n in
       [(200, 960, 8192), (4096, 960, 960), (4096, 2560, 960),
        (4096, 960, 2560), (4096, 960, 49152)]]
    # the f32 body at qwen3-moe's router shape, k = 4096
    + [(8, 4096, 128, torch.float32)])
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
                                   (300, 960, 2560), (5, 60, 160),
                                   # every row of the 16-row fragment, a
                                   # ragged 64 x 64 tile, odd k and n
                                   (9, 960, 2560), (16, 960, 2560),
                                   (17, 100, 70), (7, 131, 77)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_gated_kernel_matches_plain(cuda_device, m, k, n, dtype):
    a = _randn((m, k), dtype, cuda_device, 0) / k ** 0.5
    bg = _randn((k, n), dtype, cuda_device, 1)
    bu = _randn((k, n), dtype, cuda_device, 2)
    _close(gemm_gated(a, bg, bu), gemm_gated_plain(a, bg, bu), dtype)


def _randn_card(shape, dtype, device, seed):
    """Normal values drawn on the card itself: the long-k operands would
    take seconds to draw in numpy."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


#: the k = 8192 and 28672 cases of the gates that hold B2's and the W8A16
#: paths' mma.sync chain to B1's wgmma chain: internvl2-76b's gate / up
#: (k 8192, n 8192 keeps B1 on the swapped wgmma form it launches at n
#: 28672) and down (k 28672), at decode and in a 300-token prefill
LONG_K = [(8, 8192, 8192), (300, 8192, 8192), (8, 28672, 8192),
          (300, 28672, 1024)]


@pytest.mark.parametrize("m,k,n", [(m, 960, 2560) for m in (1, 8, 9, 16,
                                                            300)] + LONG_K)
def test_gemm_gated_equals_relu_gemm_aie_bitwise(cuda_device, m, k, n):
    """Both accumulators of B2's bf16 body run B1's tensor-core chain, so
    relu(A Wg) * (A Wu) in f32 is relu(B1(A, Wg)) * B1(A, Wu) bit for bit,
    at every CTA shape m picks, on smollm-360m's 960 x 2560, and at k =
    8192 and 28672 (B2 on mma.sync, B1 on wgmma: probe 4 covered k <=
    4096)."""
    draw = _randn_card if k > 960 else _randn
    a = draw((m, k), torch.bfloat16, cuda_device, 0) / k ** 0.5
    bg = draw((k, n), torch.bfloat16, cuda_device, 1)
    bu = draw((k, n), torch.bfloat16, cuda_device, 2)
    f32 = torch.float32
    got = gemm_gated(a, bg, bu, activation="relu", out_dtype=f32)
    want = torch.relu(gemm_aie(a, bg, out_dtype=f32)) \
        * gemm_aie(a, bu, out_dtype=f32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", [
    (1, 300, 300, 15, 5, 64, True, 0),       # smollm prefill
    (1, 7, 7, 15, 5, 64, True, 0),           # short prompt
    (2, 45, 45, 3, 1, 20, True, 0),          # smoke head_dim, ragged sq
    (1, 64, 96, 4, 2, 120, True, 32),        # q_offset, window, d 120
    (1, 40, 40, 2, 2, 64, False, 0),         # non-causal
    (1, 300, 300, 64, 4, 128, True, 0),      # qwen3-moe prefill, group 16
    (1, 33, 100, 16, 1, 128, True, 0),       # q_offset, d 128, group 16
    (2, 70, 70, 6, 3, 112, True, 0),         # d 112, two batch rows
    (1, 50, 130, 3, 1, 20, False, 40),       # non-causal window, d 20
    (1, 100, 130, 16, 1, 256, True, 64),     # recurrentgemma's d 256, MQA
    (2, 45, 45, 4, 2, 200, True, 0),         # d 200: padded to 256
    # whisper-medium: the encoder (1500 frames, 1500 keys: not a multiple
    # of the key block), cross-attention at prefill and at decode (one
    # query a slot over its 1500 encoder keys), MHA d 64
    (1, 1500, 1500, 16, 16, 64, False, 0),
    (1, 200, 1500, 16, 16, 64, False, 0),
    (8, 1, 1500, 16, 16, 64, False, 0),
    (1, 300, 300, 64, 8, 112, True, 0),      # kimi-k2 prefill, d 112
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
    (8, 1024, 64, 4, 128, 0),                # qwen3-moe decode
    (2, 70, 4, 2, 17, 0),                    # odd head_dim: plain loads
    (4, 300, 16, 1, 256, 100),               # d 256, group 16, window
    (2, 70, 4, 2, 200, 0),                   # d 200: padded to 256
    (8, 1024, 64, 8, 112, 0),                # kimi-k2 decode, d 112
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_decode_is_batch_invariant(cuda_device, dtype):
    """whisper-medium's cross-attention at decode (8 slots x 1 query over
    1500 encoder keys, non-causal, MHA d 64): each slot alone has the
    bits it has among eight, which continuous == solo greedy needs."""
    q = _randn((8, 1, 16, 64), dtype, cuda_device, 0)
    k = _randn((8, 1500, 16, 64), dtype, cuda_device, 1)
    v = _randn((8, 1500, 16, 64), dtype, cuda_device, 2)
    out = flash_attention(q, k, v, causal=False)
    for i in range(8):
        one = slice(i, i + 1)
        assert torch.equal(flash_attention(q[one], k[one], v[one],
                                           causal=False), out[one]), i


def test_kernels_are_batch_invariant(cuda_device):
    """A row's bits do not depend on how many rows share the call —
    the property continuous-batched greedy == solo greedy rests on.  B1
    and B6 rows at m = 1, 8, 9, 12, 16 and 300 (B1 stages 8 rows of its
    16-row fragment up to m = 8, all 16 up to m = 16 and runs 64 x 64
    tiles beyond; B6 runs at the plans' decode and prefill tiles) all
    equal B1's 300-row call; B2 rows at m = 9, 16 and 300 equal its
    300-row call."""
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
    big = _randn((300, 960), dt, cuda_device, 6) * 960 ** -0.5
    res = _randn((300, 2560), dt, cuda_device, 7)
    ref = gemm_aie(big, w, residual=res, out_dtype=dt)
    for tile in ((8, 512, 32), (128, 512, 32), (16, 1024, 256)):
        t = TileConfig(*tile, "tb")
        assert torch.equal(gemm_tb(big, w, tile=t, residual=res,
                                   out_dtype=dt), ref), tile
    for m in (1, 8, 9, 12, 16):
        for r0 in (0, 5, 300 - m):
            rows = slice(r0, r0 + m)
            assert torch.equal(gemm_aie(big[rows], w, residual=res[rows],
                                        out_dtype=dt), ref[rows]), (m, r0)
            assert torch.equal(gemm_tb(big[rows], w, residual=res[rows],
                                       tile=TileConfig(8, 512, 32, "tb"),
                                       out_dtype=dt), ref[rows]), (m, r0)
    # B2 rows at m = 9, 16 (the 16-row fragment) and 300 (64 x 64 tiles)
    # equal its 300-row call, as its m = 1 and 8 rows equal its 8-row one
    up = _randn((960, 2560), dt, cuda_device, 8)
    gated300 = gemm_gated(big, w, up)
    for m in (9, 16, 300):
        for r0 in sorted({0, 5, 300 - m}):
            rows = slice(r0, r0 + m)
            assert torch.equal(gemm_gated(big[rows], w, up),
                               gated300[rows]), (m, r0)
    q = _randn((8, 15, 64), dt, cuda_device, 3)
    k = _randn((8, 256, 5, 64), dt, cuda_device, 4)
    v = _randn((8, 256, 5, 64), dt, cuda_device, 5)
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device) * 30
    out = flash_decode(q, k, v, pos)
    assert torch.equal(flash_decode(q[3:4], k[3:4], v[3:4], pos[3:4]),
                       out[3:4])
    # B4 at S 1024, both models' heads, slots on both sides of the
    # 64-key splits: each slot alone equals its row
    for hq, hkv, d in ((15, 5, 64), (64, 4, 128)):
        q = _randn((8, hq, d), dt, cuda_device, 10)
        k = _randn((8, 1024, hkv, d), dt, cuda_device, 11)
        v = _randn((8, 1024, hkv, d), dt, cuda_device, 12)
        pos = torch.as_tensor(STRADDLING_POS, dtype=torch.int32,
                              device=cuda_device)
        for window in (0, 100):
            out = flash_decode(q, k, v, pos, window=window)
            for i in range(8):
                one = slice(i, i + 1)
                assert torch.equal(flash_decode(q[one], k[one], v[one],
                                                pos[one], window=window),
                                   out[one]), (hq, window, i)


def test_launch_counters_count_kernel_launches(cuda_device):
    a = _randn((2, 64), torch.float32, cuda_device, 0)
    w = _randn((64, 32), torch.float32, cuda_device, 1)
    before, plain_before = gemm_aie.launches, gemm_aie_plain.launches
    gemm_aie(a, w)
    assert gemm_aie.launches == before + 1
    assert gemm_aie_plain.launches == plain_before
    q = _randn((2, 3, 8), torch.float32, cuda_device, 2)
    pool = _randn((5, 4, 1, 8), torch.float32, cuda_device, 3)
    table = torch.ones((2, 2), dtype=torch.int32, device=cuda_device)
    before = flash_decode_paged.launches
    plain_before = flash_decode_paged_plain.launches
    flash_decode_paged(q, pool, pool, table, 3)
    assert flash_decode_paged.launches == before + 1
    assert flash_decode_paged_plain.launches == plain_before


def _paged_pool(k, v, ps, seed, max_pages=None):
    """Scatter dense (b, S, hkv, d) caches into a pool over a random
    permutation of pages 1..b*max_pages (page 0, the sink, keeps noise);
    returns the pools and the (b, max_pages) int32 table.  ``max_pages``
    (default S/ps) may exceed S/ps: a row's pages past the cache's keep
    noise."""
    b, S, hkv, d = k.shape
    dense_pages = S // ps
    max_pages = max_pages or dense_pages
    n_pages = 1 + b * max_pages
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    table = torch.as_tensor(perm.reshape(b, max_pages).astype(np.int32),
                            device=k.device)
    k_pages = _randn((n_pages, ps, hkv, d), k.dtype, k.device, seed + 1)
    v_pages = _randn((n_pages, ps, hkv, d), k.dtype, k.device, seed + 2)
    rows = table[:, :dense_pages].long()
    k_pages[rows] = k.reshape(b, dense_pages, ps, hkv, d)
    v_pages[rows] = v.reshape(b, dense_pages, ps, hkv, d)
    return k_pages, v_pages, table


@pytest.mark.parametrize("ps", [8, 16, 32, 64])
@pytest.mark.parametrize("b,S,hq,hkv,d,window", [
    (4, 256, 15, 5, 64, 0),                  # smollm heads
    (4, 256, 3, 1, 20, 24),                  # smoke head_dim, window
    (4, 256, 16, 1, 128, 0),                 # MQA group 16
    (4, 256, 4, 4, 120, 100),                # MHA, d 120, wide window
    (8, 1024, 64, 4, 128, 0),                # qwen3-moe decode
    (4, 256, 16, 1, 256, 100),               # recurrentgemma's heads
    (8, 1024, 64, 8, 112, 0),                # kimi-k2 paged decode, d 112
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_kernel_matches_plain(cuda_device, ps, b, S, hq,
                                                 hkv, d, window, dtype):
    q = _randn((b, hq, d), dtype, cuda_device, 0)
    k = _randn((b, S, hkv, d), dtype, cuda_device, 1)
    v = _randn((b, S, hkv, d), dtype, cuda_device, 2)
    k_pages, v_pages, table = _paged_pool(k, v, ps, 3)
    table[2] = 0                              # a masked, all-sink row
    # row 2's position has run past its table, as a masked row's does; it
    # still sees keys under every window here (a row that sees none gets
    # zeros from the kernel and the mean of the values from the plain
    # version, and is never read)
    pos = torch.as_tensor([0, 77, S + 10, S - 1, 17, 160, 363, 700][:b],
                          dtype=torch.int32, device=cuda_device)
    _close(flash_decode_paged(q, k_pages, v_pages, table, pos,
                              window=window),
           flash_decode_paged_plain(q, k_pages, v_pages, table, pos,
                                    window=window), dtype)


@pytest.mark.parametrize("ps", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(15, 5, 64), (64, 4, 128),
                                     (64, 8, 112)])
@pytest.mark.parametrize("pool_len", [1024, 1280])
def test_flash_decode_paged_equals_dense_bitwise(cuda_device, ps, dtype, hq,
                                                 hkv, d, pool_len):
    """One logical cache, dense and in a permuted pool: B5's output has
    B4's bits at every page size, windows included, at smollm-360m's,
    qwen3-moe's and kimi-k2's heads (d 112), with the pool's table as
    long as the dense cache
    (1024 keys) or longer (1280): a row's bits do not depend on the
    length beyond pos + 1.  The slot past the dense cache's end (pos
    1500) sees the pool's extra keys, so it is compared only at equal
    lengths."""
    b, S = 8, 1024
    q = _randn((b, hq, d), dtype, cuda_device, 0)
    k = _randn((b, S, hkv, d), dtype, cuda_device, 1)
    v = _randn((b, S, hkv, d), dtype, cuda_device, 2)
    k_pages, v_pages, table = _paged_pool(k, v, ps, 4, pool_len // ps)
    pos = torch.as_tensor([17, 40, 95, 160, 210, 300, 1023, 1500],
                          dtype=torch.int32, device=cuda_device)
    rows = slice(0, b if pool_len == S else b - 1)
    for window in (0, 64, 100):
        got = flash_decode_paged(q, k_pages, v_pages, table, pos,
                                 window=window)
        want = flash_decode(q, k, v, pos, window=window)
        torch.cuda.synchronize()
        assert torch.equal(got[rows], want[rows]), (ps, window)


def test_flash_decode_paged_is_batch_invariant(cuda_device):
    dt = torch.bfloat16
    q = _randn((8, 15, 64), dt, cuda_device, 0)
    k = _randn((8, 256, 5, 64), dt, cuda_device, 1)
    v = _randn((8, 256, 5, 64), dt, cuda_device, 2)
    k_pages, v_pages, table = _paged_pool(k, v, 16, 5)
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device) * 30
    out = flash_decode_paged(q, k_pages, v_pages, table, pos)
    for i in (0, 3, 7):
        assert torch.equal(
            flash_decode_paged(q[i:i + 1], k_pages, v_pages,
                               table[i:i + 1], pos[i:i + 1]),
            out[i:i + 1])
    # B5 at 64 pages of 16 (1024 keys), both models' heads, slots on both
    # sides of the 64-key splits
    for hq, hkv, d in ((15, 5, 64), (64, 4, 128)):
        q = _randn((8, hq, d), dt, cuda_device, 10)
        k = _randn((8, 1024, hkv, d), dt, cuda_device, 11)
        v = _randn((8, 1024, hkv, d), dt, cuda_device, 12)
        k_pages, v_pages, table = _paged_pool(k, v, 16, 13)
        pos = torch.as_tensor(STRADDLING_POS, dtype=torch.int32,
                              device=cuda_device)
        for window in (0, 100):
            out = flash_decode_paged(q, k_pages, v_pages, table, pos,
                                     window=window)
            for i in range(8):
                one = slice(i, i + 1)
                assert torch.equal(
                    flash_decode_paged(q[one], k_pages, v_pages, table[one],
                                       pos[one], window=window),
                    out[one]), (hq, window, i)


@pytest.mark.parametrize("s,hq,hkv,d,window", [
    (300, 15, 5, 64, 0),                     # smollm-360m, group 3
    (300, 64, 4, 128, 0),                    # qwen3-moe, group 16
    (200, 8, 2, 120, 32),                    # h2o-danube's d 120, window
    (90, 3, 1, 20, 0),                       # the smoke config's d 20
    (300, 16, 1, 256, 100),                  # recurrentgemma's d 256
])
def test_flash_attention_q_split_invariance_bitwise(cuda_device, s, hq, hkv,
                                                    d, window):
    """B3's bf16 body: a prompt's full prefill equals, bit for bit, its
    rows computed in chunks of 7, 16 and 64 with q_offset = start against
    the key prefix (other CTA row counts, tiles and key ranges), and one
    q head's rows computed alone against its kv head."""
    dt = torch.bfloat16
    q = _randn((1, s, hq, d), dt, cuda_device, 0)
    k = _randn((1, s, hkv, d), dt, cuda_device, 1)
    v = _randn((1, s, hkv, d), dt, cuda_device, 2)
    full = flash_attention(q, k, v, window=window)
    for chunk in (7, 16, 64):
        parts = [flash_attention(q[:, a:a + chunk], k[:, :a + chunk],
                                 v[:, :a + chunk], window=window, q_offset=a)
                 for a in range(0, s, chunk)]
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(parts, dim=1), full), chunk
    group = hq // hkv
    for h in (0, hq // 2, hq - 1):
        kvh = h // group
        solo = flash_attention(q[:, :, h:h + 1], k[:, :, kvh:kvh + 1],
                               v[:, :, kvh:kvh + 1], window=window)
        torch.cuda.synchronize()
        assert torch.equal(solo[:, :, 0], full[:, :, h]), h


#: (b, sq, skv, hq, hkv, d, causal, window, q_offset): causal, non-causal,
#: a window, a q_offset against a longer key prefix, GQA groups 1, 3, 8 and
#: 16 and heads 64, 112, 120 and 256
B3_BLOCK_CASES = [
    (1, 300, 300, 15, 5, 64, True, 0, None),        # smollm-360m, group 3
    (2, 70, 70, 4, 4, 64, False, 0, None),          # non-causal, group 1
    (1, 200, 200, 8, 1, 120, True, 64, None),       # d 120, window, group 8
    (1, 33, 150, 64, 4, 112, True, 0, 117),         # q_offset, d 112, 16
    (1, 260, 260, 16, 1, 256, True, 100, None),     # recurrentgemma's d 256
    (8, 1, 200, 16, 16, 64, False, 0, None),        # whisper's cross decode
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,q_offset",
                         B3_BLOCK_CASES)
def test_flash_attention_every_block_shape_bitwise(cuda_device, b, sq, skv,
                                                   hq, hkv, d, causal,
                                                   window, q_offset):
    """Every launch-time shape B3 compiles (rows a CTA x keys a ring
    stage) gives the default shape's output bit for bit, and the plain
    version's within the bf16 tolerance."""
    from repro_torch.kernels.flash_attention import b3_blocks
    dt = torch.bfloat16
    q = _randn((b, sq, hq, d), dt, cuda_device, 0)
    k = _randn((b, skv, hkv, d), dt, cuda_device, 1)
    v = _randn((b, skv, hkv, d), dt, cuda_device, 2)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    base = flash_attention(q, k, v, **kw)
    _close(base, flash_attention_plain(q, k, v, **kw), dt)
    blocks = b3_blocks(d)
    assert len(blocks) == (3 if d > 128 else 8)
    for bq, bkv in blocks:
        got = flash_attention(q, k, v, bq=bq, bkv=bkv, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, base), (bq, bkv)


@pytest.mark.parametrize("b,S,hq,hkv,d,window,pos", [
    (8, 1024, 15, 5, 64, 0, STRADDLING_POS),        # smollm-360m, group 3
    (8, 1024, 64, 8, 112, 0, STRADDLING_POS),       # kimi's d 112, group 8
    (3, 300, 4, 4, 120, 0, [0, 150, 299]),          # group 1, d 120
    (8, 2048, 16, 1, 256, 0,                        # recurrentgemma's ring
     [5, 900, 2047, 2047, 2047, 2047, 2047, 2047]),
    (4, 1024, 64, 4, 128, 200, [100, 300, 700, 1023]),  # past the window
])
def test_flash_decode_every_grouping_bitwise(cuda_device, b, S, hq, hkv, d,
                                             window, pos):
    """Every B4 grouping (1, 2 or 4 64-key splits a CTA; 1 or 2 at head
    256) gives the default's output bit for bit, and the plain
    version's within the bf16 tolerance, decode positions past the
    window included."""
    from repro_torch.kernels.flash_attention import decode_blocks
    dt = torch.bfloat16
    q = _randn((b, hq, d), dt, cuda_device, 3)
    k = _randn((b, S, hkv, d), dt, cuda_device, 4)
    v = _randn((b, S, hkv, d), dt, cuda_device, 5)
    p = torch.as_tensor(pos, dtype=torch.int32, device=cuda_device)
    base = flash_decode(q, k, v, p, window=window)
    _close(base, flash_decode_plain(q, k, v, p, window=window), dt)
    keys = decode_blocks(d)
    assert keys == ((64, 128) if d > 128 else (64, 128, 256))
    for bkv in keys:
        got = flash_decode(q, k, v, p, window=window, bkv=bkv)
        torch.cuda.synchronize()
        assert torch.equal(got, base), bkv


def test_uncompiled_blocks_raise_on_the_card(cuda_device):
    """A shape that is not compiled never reaches the card: the wrappers
    raise ValueError naming the compiled set (128 rows and 128-key
    stages are out at head 256, four splits a CTA too)."""
    dt = torch.bfloat16
    q = _randn((1, 8, 2, 256), dt, cuda_device, 0)
    k = _randn((1, 8, 2, 256), dt, cuda_device, 1)
    for kw in (dict(bq=128), dict(bkv=128), dict(bq=48)):
        with pytest.raises(ValueError, match="compiled"):
            flash_attention(q, k, k, **kw)
    p = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="compiled"):
        flash_decode(q[:, 0], k, k, p, bkv=256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_prefill_equals_unchunked_bitwise(cuda_device, dtype):
    """The smoke model on the card: a 45-token prompt prefilled into the
    page pool in chunks of 7 gives the logits and the pools of one
    whole-prompt chunk, and the dense prefill's logits, bit for bit."""
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), dtype=dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.init_params(cfg, gen, device=cuda_device)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 45)), device=cuda_device)
    ps, max_pages = 8, 8
    row = np.random.default_rng(2).permutation(np.arange(1, 1 + max_pages)) \
        .astype(np.int32)
    caches, logits = [], []
    with torch.inference_mode():
        for chunk in (45, 7):
            cache = T.init_paged_cache(cfg, 1, 1 + max_pages, ps, max_pages,
                                       device=cuda_device)
            for start in range(0, 45, chunk):
                lg, cache = T.prefill_paged_chunk(
                    params, cfg, toks[:, start:start + chunk], cache, 0,
                    row, start)
            caches.append(cache)
            logits.append(lg)
        dense, _ = T.prefill(params, cfg, toks,
                             T.init_cache(cfg, 1, 64, device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(logits[0], logits[1])
    assert torch.equal(logits[0], dense)
    for name in ("k", "v"):
        assert torch.equal(caches[0]["layers"]["u0"][name],
                           caches[1]["layers"]["u0"][name])


# ---------------------------------------------------------------- B6 gemm_tb

from repro_torch import ops  # noqa: E402
from repro_torch.core.hardware import HOPPER_H100  # noqa: E402
from repro_torch.core.memory_model import vmem_footprint  # noqa: E402
from repro_torch.core.tiling import GemmProblem, TileConfig  # noqa: E402
from repro_torch.kernels.gemm_tb import (gemm_tb, gemm_tb_plain,  # noqa
                                         smem_bytes)


def _tb_operands(m, k, n, dtype, epi, device, seed=0):
    a = _randn((m, k), dtype, device, seed) * k ** -0.5
    w = _randn((k, n), dtype, device, seed + 1)
    kw = {"out_dtype": dtype}
    if epi in ("residual", "bias+gelu+res"):
        kw["residual"] = _randn((m, n), dtype, device, seed + 2)
    if epi in ("bias+silu", "bias+gelu+res"):
        kw["bias"] = _randn((n,), torch.float32, device, seed + 3)
        kw["activation"] = "silu" if epi == "bias+silu" else "gelu"
    if epi == "f32out":
        kw["out_dtype"] = torch.float32
    return a, w, kw


@pytest.mark.parametrize("m,k,n,tile,dtype", [
    (m, k, n, tile, dtype) for m, k, n, tile in [
        (8, 960, 320, (8, 512, 32)),       # wk/wv at decode: 2 chunks, ragged
        (8, 2560, 960, (8, 512, 64)),      # w_down at decode: 5 chunks
        (300, 960, 960, (128, 512, 32)),   # prefill: m not a multiple of bm
        (17, 100, 70, (16, 32, 64)),       # ragged everything, 4 chunks
        (3, 60, 200, (8, 1024, 256)),      # one chunk: B6b alone
        (9, 1000, 96, (16, 512, 32)),      # last chunk 488: k % 16 != 0
    ] for dtype in (torch.float32, torch.bfloat16)] + [
    # the tensor-core body at qwen3-moe's shapes (the f32 body is unchanged)
    (m, k, n, tile, torch.bfloat16) for m, k, n, tile in [
        (8, 4096, 8192, (8, 1024, 32)),    # wq at decode
        (8, 4096, 512, (8, 1024, 32)),     # wk/wv at decode
        (8, 8192, 4096, (8, 1024, 32)),    # wo at decode
        (300, 4096, 8192, (128, 512, 32)),  # wq in prefill
        (300, 4096, 512, (128, 512, 32)),  # wk/wv in prefill
        (300, 8192, 4096, (64, 512, 32)),  # wo + residual in prefill
        # the warp-specialised body's large and swapped shapes, at
        # smollm-360m's training shapes and its decode lm_head
        (4096, 960, 2560, (128, 256, 128)),
        (4096, 2560, 960, (64, 256, 256)),
        (4096, 960, 960, (128, 256, 128)),
        (8, 960, 49152, (16, 512, 256)),
        (300, 960, 960, (16, 1024, 128)),
    ]])
@pytest.mark.parametrize("epi", ["none", "residual", "bias+silu", "f32out"])
def test_gemm_tb_kernel_matches_plain(cuda_device, m, k, n, tile, dtype,
                                      epi):
    a, w, kw = _tb_operands(m, k, n, dtype, epi, cuda_device)
    t = TileConfig(*tile, "tb")
    _close(gemm_tb(a, w, tile=t, **kw), gemm_tb_plain(a, w, tile=t, **kw),
           dtype)


@pytest.mark.parametrize("m,k,n", [(8, 960, 320), (8, 2560, 960),
                                   (12, 960, 320), (300, 960, 960),
                                   (5, 131, 77), (300, 4096, 512),
                                   (4096, 960, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epi", ["none", "residual", "bias+gelu+res",
                                 "f32out"])
def test_gemm_tb_equals_gemm_aie_bitwise(cuda_device, m, k, n, dtype, epi):
    """Both dataflows run one chain over k in order per element (the
    tensor-core chain for bf16, the fmaf chain for f32) and the same
    flush, so B6 == B1 bit for bit at any tile (1, 2 and >= 4 k-chunks
    here; in bf16 also the warp-specialised body's 128 x 128, 64 x 256
    and swapped 16 x 256 CTAs) and any split of the n sweep over CTAs."""
    a, w, kw = _tb_operands(m, k, n, dtype, epi, cuda_device, seed=7)
    want = gemm_aie(a, w, **kw)
    tiles = [(8, 1024, 256), (16, 512, 64), (64, 128, 32), (8, 32, 128)]
    if dtype == torch.bfloat16:     # the warp-specialised body's large
        tiles += [(128, 256, 128), (64, 256, 256), (16, 512, 256)]
    for tile in tiles:
        t = TileConfig(*tile, "tb")
        for split in (None, 1, 3):
            got = gemm_tb(a, w, tile=t, n_split_tiles=split, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (tile, split)


def test_gemm_tb_launch_counters_follow_the_plan(cuda_device):
    a = _randn((8, 2560), torch.bfloat16, cuda_device, 0)
    w = _randn((2560, 960), torch.bfloat16, cuda_device, 1)
    pl = ops.plan(ops.GemmSpec(strategy="tb"), (8, 2560, 960))
    want = pl.launches
    assert want["gemm_tb"] >= 1 and want["gemm_tb_final"] == 1
    before = (gemm_tb.launches, gemm_tb.final_launches,
              gemm_tb_plain.launches, gemm_aie.launches)
    ops.execute(pl, a, w)
    assert (gemm_tb.launches - before[0],
            gemm_tb.final_launches - before[1]) == \
        (want["gemm_tb"], want["gemm_tb_final"])
    assert gemm_tb_plain.launches == before[2]
    assert gemm_aie.launches == before[3]


@pytest.mark.parametrize("tile,epi,dtype", [
    ((8, 512, 32), "", "bfloat16"), ((128, 512, 32), "", "bfloat16"),
    ((64, 512, 32), "res", "bfloat16"), ((16, 256, 64), "bias+silu+res",
                                         "float32"),
    # the warp-specialised body's large and swapped CTAs
    ((128, 256, 128), "res", "bfloat16"), ((64, 256, 256), "", "bfloat16"),
    ((16, 512, 256), "bias+silu+res", "bfloat16")])
def test_gemm_tb_smem_is_the_modeled_footprint(cuda_device, tile, epi,
                                               dtype):
    t = TileConfig(*tile, "tb")
    p = GemmProblem(300, 960, 960, dtype, dtype, "float32", dtype, epi)
    td = getattr(torch, dtype)
    assert smem_bytes(*tile, td, td, bias="bias" in epi,
                      residual="res" in epi) == \
        vmem_footprint(t, p, HOPPER_H100).total


def test_gemm_tb_refuses_what_it_cannot_launch(cuda_device):
    a = _randn((64, 960), torch.float32, cuda_device, 0)
    w = _randn((960, 320), torch.float32, cuda_device, 1)
    with pytest.raises(ValueError, match="256 threads"):
        gemm_tb(a, w, tile=TileConfig(64, 128, 256, "tb"))
    with pytest.raises(ValueError, match="infeasible"):
        ops.gemm(a, w, tile=TileConfig(64, 128, 256, "tb"))
    # bf16: the warp-specialised body covers at most 128 x 256
    a16, w16 = a.to(torch.bfloat16), w.to(torch.bfloat16)
    with pytest.raises(ValueError, match="128 x 256"):
        gemm_tb(a16, w16, tile=TileConfig(256, 128, 64, "tb"))


def test_hopper_probe_finds_wgmma_keeps_the_chain_bits(cuda_device,
                                                      tmp_path):
    """tools/hopper_probe.cu probe 4, built and run here: wgmma m64nNk16,
    unswapped and with the roles swapped, gives the mma.sync m16n8k16
    chain's f32 bits, from zero and from a non-zero C; the premise on
    which B1 and B6 run wgmma while B2, B7 and the int8 W8A16 bodies keep
    mma.sync, and every bitwise gate between them holds."""
    import pathlib
    import subprocess
    from repro_torch.kernels import _build
    root = pathlib.Path(__file__).resolve().parents[1]
    exe = tmp_path / "hopper_probe"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-o", str(exe),
                    str(root / "tools" / "hopper_probe.cu")], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True).stdout
    verdict = [ln for ln in out.splitlines()
               if ln.startswith("probe 4 verdict")]
    assert verdict == ["probe 4 verdict: (a) within 1e-5 of float64: yes; "
                       "(b) wgmma == mma.sync chain bit for bit: yes (0 "
                       "elements differ); (c) swapped wgmma == chain: yes "
                       "(0 differ)"], out
    # probe 6: an fmaf chain's step, the latency B1's and B6's f32 bodies
    # are built around, and the chain floor it gives
    lat = [ln for ln in out.splitlines()
           if ln.startswith("probe 6: fmaf dependent chain")]
    assert len(lat) == 1 and 2.0 <= float(lat[0].split()[5]) <= 8.0, out
    assert any(ln.startswith("probe 6: SM clock under the chain")
               for ln in out.splitlines()), out


# ---------------------------------------------------------------------------
# B1's and B6's f32 bodies (csrc/gemm_f32.cuh): the MoE routers' GEMMs
# ---------------------------------------------------------------------------

#: the served f32 router GEMMs: qwen3-moe-235b-a22b's at decode, in a
#: 300-token prefill and a 64-token paged chunk (d 4096, 128 experts), and
#: kimi-k2-1t-a32b's at decode (d 7168, 384 experts)
F32_ROUTERS = [(8, 4096, 128), (300, 4096, 128), (64, 4096, 128),
               (8, 7168, 384)]
#: the reference's own gate for its f32 GEMM (tests/test_kernels.py:69-72),
#: which holds the cases past k = 4096 and qwen3-moe's dense shapes at f32
#: (ROADMAP queue C): there one fmaf chain over k reads past 1e-5 off the
#: plain matmul's other order on a few of millions of elements (300 x 4096
#: x 8192, bias + silu + residual: 1.30e-5 on 2 of 2457600; PERF.md §6)
REF_F32_GATE = {"atol": 1e-3, "rtol": 1e-5}


def _f32_close(got, want, k, ref_gate=False):
    """f32 atol = rtol = 1e-5 (TOL) up to k = 4096, the reference's gate
    beyond or where ``ref_gate`` says."""
    torch.cuda.synchronize()
    tol = REF_F32_GATE if k > 4096 or ref_gate else {
        "atol": TOL[torch.float32], "rtol": TOL[torch.float32]}
    torch.testing.assert_close(got, want, **tol)


def _tb_plan_tile(m, k, n, **ep):
    spec = ops.GemmSpec(a_dtype=torch.float32, b_dtype=torch.float32,
                        out_dtype=torch.float32, strategy="tb",
                        epilogue=ops.Epilogue(**ep))
    return ops.plan(spec, (m, k, n)).tile


@pytest.mark.parametrize("m,k,n", F32_ROUTERS + [
    # qwen3-moe's dense GEMMs at f32 (wq, wk/wv, wo), decode and prefill
    s for s in QWEN3_DENSE])
@pytest.mark.parametrize("epi", ["none", "bias+silu+res"])
def test_f32_bodies_match_plain_at_the_served_shapes(cuda_device, m, k, n,
                                                     epi):
    """B1's f32 body (the CTA shape cta_tile picks), B6's at the tile its
    'tb' plan gives, and ops.gemm's planned path, each against its plain
    version: the routers within 1e-5 at k <= 4096; qwen3's dense shapes
    and k > 4096 within the reference's f32 gate."""
    gate = (m, k, n) not in F32_ROUTERS
    a = _randn_card((m, k), torch.float32, cuda_device, 0) / k ** 0.5
    w = _randn_card((k, n), torch.float32, cuda_device, 1)
    kw = {"out_dtype": torch.float32}
    ep = {}
    if epi != "none":
        kw.update(bias=_randn((n,), torch.float32, cuda_device, 2),
                  activation="silu",
                  residual=_randn((m, n), torch.float32, cuda_device, 3))
        ep = {"bias": True, "activation": "silu", "residual": True}
    _f32_close(gemm_aie(a, w, **kw), gemm_aie_plain(a, w, **kw), k, gate)
    t = _tb_plan_tile(m, k, n, **ep)
    _f32_close(gemm_tb(a, w, tile=t, **kw), gemm_tb_plain(a, w, tile=t, **kw),
               k, gate)
    _f32_close(ops.gemm(a, w, **kw), gemm_aie_plain(a, w, **kw), k, gate)


@pytest.mark.parametrize("m,k,n", F32_ROUTERS)
def test_f32_gemm_tb_equals_gemm_aie_bitwise_at_the_routers(cuda_device, m,
                                                            k, n):
    """B6's f32 body == B1's bit for bit at the router shapes: tiles giving
    one k-chunk (two at k 7168), two, and four or more (the 'tb' plan's
    among them), each at three splits of the n sweep over CTAs."""
    a = _randn_card((m, k), torch.float32, cuda_device, 4) / k ** 0.5
    w = _randn_card((k, n), torch.float32, cuda_device, 5)
    want = gemm_aie(a, w, out_dtype=torch.float32)
    plan = _tb_plan_tile(m, k, n)
    tiles = [(8, 8192, 64), (16, 2048, 128), (64, 512, 32), (128, 256, 32),
             (plan.bm, plan.bk, plan.bn)]
    chunks = set()
    for tile in tiles:
        t = TileConfig(*tile, "tb")
        chunks.add(ops.plan(ops.GemmSpec(a_dtype=torch.float32,
                                         b_dtype=torch.float32,
                                         out_dtype=torch.float32, tile=t),
                            (m, k, n)).launches["gemm_tb"] + 1)
        for split in (None, 1, 3):
            got = gemm_tb(a, w, tile=t, n_split_tiles=split,
                          out_dtype=torch.float32)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (tile, split)
    assert min(chunks) <= 2 and max(chunks) >= 4, chunks


def test_f32_rows_are_batch_invariant(cuda_device):
    """f32 rows at m = 1, 8, 9, 16 and 300 (B1's one-warp shapes of 8 and
    16 rows and its four-warp ones; B6 at each m's 'tb' plan) equal the
    same rows of the 300-row call, bit for bit, at qwen3-moe's router
    shape: continuous == solo greedy for the MoE models rests on it."""
    k, n = 4096, 128
    big = _randn_card((300, k), torch.float32, cuda_device, 6) / k ** 0.5
    w = _randn_card((k, n), torch.float32, cuda_device, 7)
    ref = gemm_aie(big, w, out_dtype=torch.float32)
    for m in (1, 8, 9, 16, 300):
        t = _tb_plan_tile(m, k, n)
        for r0 in sorted({0, 5, 300 - m}):
            rows = slice(r0, r0 + m)
            for got in (gemm_aie(big[rows], w, out_dtype=torch.float32),
                        gemm_tb(big[rows], w, tile=t,
                                out_dtype=torch.float32),
                        ops.gemm(big[rows], w, out_dtype=torch.float32)):
                torch.cuda.synchronize()
                assert torch.equal(got, ref[rows]), (m, r0, t)


@pytest.mark.parametrize("m,k,n", [(8, 8192, 4096), (300, 8192, 512)])
def test_f32_w8a16_at_k_8192_holds_the_reference_gate(cuda_device, m, k, n):
    """The f32 body on an int8 weight (W8A16 on f32 activations) at k =
    8192, on B1 and on B6 at its 'tb' plan, within the reference's f32
    GEMM gate of its plain version (one fmaf chain over 8192 steps against
    the plain matmul's order), and B6 == B1 bit for bit."""
    a, q, kw = _int8_operands(m, k, n, "w8a16_f32", "none", cuda_device)
    want = gemm_aie_plain(a, q, **kw)
    got = gemm_aie(a, q, **kw)
    _f32_close(got, want, k)
    t = _tb_plan_tile(m, k, n)
    tb = gemm_tb(a, q, tile=t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(tb, got), t


# ---------------------------------------------------------------------------
# B7: the grouped ragged GEMM of the MoE experts
# ---------------------------------------------------------------------------

from repro_torch.kernels.gemm_grouped import (  # noqa: E402
    BF16_TILES, F32_TILES, gemm_grouped, gemm_grouped_plain)

#: group sizes: routed decode rows over many experts (some empty), empty
#: groups at both ends and in the middle, a dropped tail (rows past the
#: groups), and a tile straddled by several groups
GROUP_CASES = {
    "decode": ([0, 1, 2, 0, 1, 1, 0, 3, 1, 0, 2, 1], 13),
    "empty": ([0, 0, 37, 0, 20, 0], 57),
    "dropped_tail": ([5, 9, 0, 4], 30),
    "straddled": ([3, 2, 1, 1, 4, 2, 50], 63),
}


def _routed(tokens, e, top_k, cap, seed):
    """Group sizes of ``tokens`` routed top-k over e experts uniformly at
    random, each clipped to the capacity ``cap``."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(e, np.int64)
    for _ in range(tokens):
        counts[rng.choice(e, top_k, replace=False)] += 1
    return np.minimum(counts, cap).tolist()


#: qwen3-moe-235b-a22b's expert GEMMs (128 experts, top-8): an 8-slot
#: decode step's 64 routed rows and a 300-token prefill's 2400 (capacity
#: 24, so full experts drop their overflow into the tail)
QWEN3_CASES = {
    "qwen3_decode": (_routed(8, 128, 8, 8, 21), 64),
    "qwen3_prefill": (_routed(300, 128, 8, 24, 22), 2400),
}
#: kimi-k2-1t-a32b's (384 experts, top-8, capacity 8): an 8-slot decode
#: step's 64 routed rows (most groups empty) and a 200-token prefill's
#: 1600 (full experts drop their overflow)
KIMI_CASES = {
    "kimi_decode": (_routed(8, 384, 8, 8, 23), 64),
    "kimi_prefill": (_routed(200, 384, 8, 8, 24), 1600),
}
#: (case, k, n, dtype) of the match test: the edge cases at three (k, n),
#: one of them k = 300 off the 16-grid, in both dtypes; qwen3's gate/up
#: and down shapes in bf16
MATCH_CASES = [(case, k, n, dtype) for case in sorted(GROUP_CASES)
               for k, n in ((256, 192), (100, 70), (300, 200))
               for dtype in (torch.float32, torch.bfloat16)] + \
    [(case, k, n, torch.bfloat16) for case in sorted(QWEN3_CASES)
     for k, n in ((4096, 1536), (1536, 4096))]


def _grouped_operands(sizes, m, k, n, dtype, device, seed):
    e = len(sizes)
    a = _randn((m, k), dtype, device, seed) / k ** 0.5
    b = _randn((e, k, n), dtype, device, seed + 1)
    gs = torch.as_tensor(np.asarray(sizes, np.int32), device=device)
    bias = _randn((e, n), torch.float32, device, seed + 2)
    return a, b, gs, bias


def _ctas(dtype):
    """Every CTA shape B7 launches for ``dtype``."""
    return sorted(BF16_TILES if dtype == torch.bfloat16 else F32_TILES)


@pytest.mark.parametrize("case,k,n,dtype", MATCH_CASES)
@pytest.mark.parametrize("epi", ["none", "bias+silu", "f32out"])
def test_gemm_grouped_kernel_matches_plain(cuda_device, case, k, n, dtype,
                                           epi):
    sizes, m = {**GROUP_CASES, **QWEN3_CASES}[case]
    a, b, gs, bias = _grouped_operands(sizes, m, k, n, dtype, cuda_device, 0)
    kw = {"out_dtype": torch.float32 if epi == "f32out" else dtype}
    if epi == "bias+silu":
        kw.update(bias=bias, activation="silu")
    want = gemm_grouped_plain(a, b, gs, **kw)
    live = int(sum(sizes))
    for cta in _ctas(dtype):
        got = gemm_grouped(a, b, gs, cta=cta, **kw)
        assert got.dtype == want.dtype
        _close(got, want, dtype)
        assert not got[live:].any(), "rows past the groups must be zero"


@pytest.mark.parametrize("case", sorted(GROUP_CASES) + ["qwen3_decode"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epi", ["none", "bias+gelu"])
def test_gemm_grouped_rows_equal_gemm_aie_bitwise(cuda_device, case, dtype,
                                                  epi):
    """Each row is B1's A[r] @ B[g(r)] bit for bit on the same operands,
    at every CTA shape B7 launches: a bf16 row B1's tensor-core chain
    (one m16n8k16 sequence over k ascending, the k = 300 tail zero-filled
    to the 16-grid), an f32 row B1's fmaf body; the edge cases straddle
    tiles with several groups."""
    sizes, m = {**GROUP_CASES, **QWEN3_CASES}[case]
    k, n = 300, 200
    a, b, gs, bias = _grouped_operands(sizes, m, k, n, dtype, cuda_device, 3)
    kw = {"out_dtype": dtype}
    if epi != "none":
        kw.update(activation="gelu")
    for cta in _ctas(dtype):
        got = gemm_grouped(a, b, gs, cta=cta,
                           bias=bias if epi != "none" else None, **kw)
        torch.cuda.synchronize()
        start = 0
        for g, size in enumerate(sizes):
            if size:
                want = gemm_aie(a[start:start + size], b[g],
                                bias=bias[g] if epi != "none" else None,
                                **kw)
                assert torch.equal(got[start:start + size], want), (cta, g)
            start += size
        assert not got[start:].any(), cta


@pytest.mark.parametrize("case", sorted(GROUP_CASES) + sorted(QWEN3_CASES))
@pytest.mark.parametrize("bm", [8, 16, 64])
def test_table_kernel_equals_group_metadata(cuda_device, case, bm):
    """The card's steering tables (one launch of the table kernel) are
    group_metadata's on the CPU, entry for entry, padding included."""
    from repro_torch.kernels.gemm_grouped import (group_metadata,
                                                  steering_tables)
    sizes, m = {**GROUP_CASES, **QWEN3_CASES}[case]
    gs = torch.as_tensor(np.asarray(sizes, np.int32))
    (offs, gids, tids), live = steering_tables(gs.to(cuda_device), m, bm)
    (w_offs, w_gids, w_tids), w_live = group_metadata(gs, m, bm)
    for got, want in ((offs, w_offs), (gids, w_gids), (tids, w_tids),
                      (live, w_live)):
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", sorted(KIMI_CASES))
@pytest.mark.parametrize("k,n", [(7168, 2048), (2048, 7168)])
def test_gemm_grouped_at_384_experts(cuda_device, case, k, n):
    """B7 at kimi-k2's 384 experts, top-8 (steering tables of
    cdiv(m, bm) + 383 entries), bf16, at both CTA shapes: against its
    plain version, rows past the groups zero, and its steering tables
    equal group_metadata's."""
    from repro_torch.kernels.gemm_grouped import (group_metadata,
                                                  steering_tables)
    sizes, m = KIMI_CASES[case]
    bf = torch.bfloat16
    a, b, gs, bias = _grouped_operands(sizes, m, k, n, bf, cuda_device, 0)
    kw = dict(bias=bias, activation="silu")
    want = gemm_grouped_plain(a, b, gs, **kw)
    live = int(sum(sizes))
    for cta in _ctas(bf):
        got = gemm_grouped(a, b, gs, cta=cta, **kw)
        _close(got, want, bf)
        assert not got[live:].any(), "rows past the groups must be zero"
    for bm in (16, 64):
        (offs, gids, tids), lv = steering_tables(gs, m, bm)
        (w_offs, w_gids, w_tids), w_lv = group_metadata(gs.cpu(), m, bm)
        for got, w in ((offs, w_offs), (gids, w_gids), (tids, w_tids),
                       (lv, w_lv)):
            assert torch.equal(got.cpu(), w)


def test_gemm_grouped_is_batch_invariant(cuda_device):
    """One row's output does not depend on the other rows in the call, at
    the decode CTA shape."""
    a, b, gs, _ = _grouped_operands([3, 0, 4, 1], 8, 512, 384,
                                    torch.bfloat16, cuda_device, 5)
    full = gemm_grouped(a, b, gs, cta=1, out_dtype=torch.bfloat16)
    for r, g in ((0, 0), (5, 2), (7, 3)):
        one = torch.zeros(4, dtype=torch.int32, device=cuda_device)
        one[g] = 1
        solo = gemm_grouped(a[r:r + 1], b, one, cta=1,
                            out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(solo[0], full[r]), r


def test_gemm_grouped_planned_launches_and_refusals(cuda_device):
    a, b, gs, _ = _grouped_operands([10, 0, 20, 3], 40, 256, 128,
                                    torch.bfloat16, cuda_device, 6)
    before = (gemm_grouped.launches, gemm_grouped_plain.launches)
    y = ops.gemm_grouped(a, b, gs, activation="silu")
    ops.gemm_grouped(a, b, gs, activation="silu")            # the repeat
    assert (gemm_grouped.launches - before[0],
            gemm_grouped_plain.launches - before[1]) == (2, 0)
    pl = ops.plan(ops.GemmSpec(grouped=True, epilogue="silu"),
                  ops.gemm_grouped_shapes(a, b))
    assert pl.launches == {"gemm_grouped": 1}
    torch.testing.assert_close(
        y.float(), gemm_grouped_plain(a, b, gs, activation="silu",
                                      out_dtype=torch.bfloat16).float(),
        atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="no CTA shape"):
        gemm_grouped(a, b, gs, cta=0)
    with pytest.raises(TypeError, match="float activations"):
        gemm_grouped(a.to(torch.int8), b.to(torch.int8), gs)
    with pytest.raises(TypeError, match="differ"):
        gemm_grouped(a, b.float(), gs)


def test_moe_ffn_is_batch_invariant_on_the_card(cuda_device):
    """A token's MoE output (router, softmax, top-k, the grouped GEMMs,
    the combine) has the same bits alone and inside a batch of 8, at the
    decode capacity, where nothing drops."""
    from repro_torch.models import moe as TM
    g = torch.Generator(device=cuda_device).manual_seed(0)
    p = {k: v[0] for k, v in TM.init_moe(g, 256, 128, 16, torch.bfloat16,
                                         1).items()}
    x = _randn((8, 1, 256), torch.bfloat16, cuda_device, 9)
    full, _ = TM.moe_ffn(p, x, top_k=4, capacity_factor=4.0)
    for r in (0, 3, 7):
        solo, _ = TM.moe_ffn(p, x[r:r + 1], top_k=4, capacity_factor=4.0)
        torch.cuda.synchronize()
        assert torch.equal(solo[0], full[r]), r


def test_moe_layer_builds_its_steering_tables_once(cuda_device,
                                                  monkeypatch):
    """A MoE layer's three grouped GEMMs launch B7 three times on one set
    of steering tables (built once, on the device)."""
    from repro_torch.kernels import gemm_grouped as G
    from repro_torch.models import moe as TM
    built = []
    real = G.steering_tables
    monkeypatch.setattr(G, "steering_tables",
                        lambda gs, m, bm: built.append((m, bm)) or
                        real(gs, m, bm))
    g = torch.Generator(device=cuda_device).manual_seed(0)
    p = {k: v[0] for k, v in TM.init_moe(g, 256, 128, 16, torch.bfloat16,
                                         1).items()}
    x = _randn((8, 1, 256), torch.bfloat16, cuda_device, 9)
    before = G.gemm_grouped.launches
    y, aux = TM.moe_ffn(p, x, top_k=4, capacity_factor=4.0, aux_loss=False)
    assert G.gemm_grouped.launches - before == 3 and aux is None
    assert len(built) == 1 and G._shared is None
    assert torch.isfinite(y.float()).all()


def test_moe_smoke_model_on_the_card_matches_the_cpu(cuda_device):
    """qwen3-moe-235b-a22b-smoke (f32): prefill + 6 decode steps on the
    card within 1e-4 of the same port on the CPU."""
    from repro_torch.bridge import to_device
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = to_device(cpu, cuda_device)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12)))
    c_log, c_cache = T.prefill(cpu, cfg, toks,
                               T.init_cache(cfg, 2, 40, device="cpu"))
    g_log, g_cache = T.prefill(gpu, cfg, toks.to(cuda_device),
                               T.init_cache(cfg, 2, 40, device=cuda_device))
    for _ in range(6):
        torch.testing.assert_close(g_log.cpu(), c_log, atol=1e-4, rtol=1e-4)
        tok = torch.argmax(c_log, -1)[:, None]
        c_log, c_cache = T.decode_step(cpu, cfg, tok, c_cache)
        g_log, g_cache = T.decode_step(gpu, cfg, tok.to(cuda_device),
                                       g_cache)
    torch.testing.assert_close(g_log.cpu(), c_log, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The int8 paths of B1, B2, B6 and B7 (W8A16, W8A8, out-quant)
# ---------------------------------------------------------------------------

from repro_torch.quant import quantize_activations, quantize_weight  # noqa


def _int8_weight(k, n, device, seed, lead=()):
    """A random (k, n) weight (stacked under ``lead``), made and quantized
    per output channel on ``device``: (q int8, scale f32 (..., 1, n))."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = quantize_weight(torch.randn(lead + (k, n), generator=g,
                                    device=device))
    return w["q"], w["scale"]


def _int8_operands(m, k, n, mode, epi, device, seed=0):
    """A, the int8 weight and its (1, n) scale, and the epilogue keywords
    of one int8 case: ``mode`` "w8a16" (bf16 A), "w8a16_f32" (f32 A) or
    "w8a8" (A quantized per row)."""
    dtype = torch.float32 if mode == "w8a16_f32" else torch.bfloat16
    a = _randn((m, k), dtype, device, seed) / k ** 0.5
    if mode == "w8a8":
        a = quantize_activations(a)[0]
    q, s = _int8_weight(k, n, device, seed + 1)
    kw = {"out_dtype": torch.float32 if epi == "f32out" or mode != "w8a16"
          else torch.bfloat16, "b_scale": s}
    if epi in ("residual", "bias+silu+res"):
        kw["residual"] = _randn((m, n), dtype, device, seed + 2)
    if epi == "bias+silu+res":
        kw["bias"] = _randn((n,), torch.float32, device, seed + 3)
        kw["activation"] = "silu"
    return a, q, kw


def _tol_dtype(mode, kw):
    return torch.bfloat16 if kw["out_dtype"] == torch.bfloat16 \
        else torch.float32


#: the served int8 shapes: smollm-360m's decode GEMMs and its 300-token
#: prefill, qwen3-moe's decode wq / wo and prefill wk/wv; edges off the
#: 16-grid (k = 131, k = 300, n = 77)
INT8_SHAPES = [(8, 960, 960), (8, 960, 320), (8, 2560, 960), (8, 960, 49152),
               (300, 960, 960), (300, 2560, 960), (8, 4096, 8192),
               (8, 8192, 4096), (300, 4096, 512), (5, 131, 77),
               (9, 300, 200), (16, 960, 960)]


@pytest.mark.parametrize("m,k,n,mode", [
    (m, k, n, mode) for m, k, n in INT8_SHAPES for mode in ("w8a16", "w8a8")]
    # the f32 body (the f32 smoke models' W8A16) at k <= 4096: at k = 8192
    # its fmaf order reads ~1e-5 off the plain matmul (ROADMAP queue C)
    + [(m, k, n, "w8a16_f32") for m, k, n in INT8_SHAPES
       if k <= 4096 and m * k * n <= 300 * 2560 * 960])
@pytest.mark.parametrize("epi", ["none", "residual", "bias+silu+res"])
def test_int8_gemm_aie_matches_plain(cuda_device, m, k, n, mode, epi):
    """B1's int8 paths against the plain version: W8A16 within the
    working dtype's tolerance, W8A8 with a linear epilogue bit for bit
    (int32 sums are exact and the flush is one f32 multiply and adds)."""
    a, q, kw = _int8_operands(m, k, n, mode, epi, cuda_device)
    got = gemm_aie(a, q, **kw)
    want = gemm_aie_plain(a, q, **kw)
    torch.cuda.synchronize()
    if mode == "w8a8" and epi != "bias+silu+res":
        assert torch.equal(got, want)
    else:
        _close(got, want, _tol_dtype(mode, kw))


@pytest.mark.parametrize("m,k,n", [(8, 960, 320), (300, 960, 960),
                                   (8, 4096, 512), (9, 300, 200),
                                   (5, 131, 77),
                                   # mma.sync (W8A16) against wgmma (bf16)
                                   # at qwen3-moe's wo (k 8192) and
                                   # internvl2-76b's down (k 28672)
                                   (8, 8192, 4096), (300, 8192, 4096),
                                   (8, 28672, 8192)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res", [False, True])
def test_w8a16_equals_bf16_on_the_widened_weights_bitwise(cuda_device, m, k,
                                                          n, out_dtype, res):
    """W8A16 on B1 == B1's bf16 body on q.to(bfloat16) with f32 output,
    then * b_scale (then + residual, then the cast), bit for bit: the
    widening is exact and the flush multiplies once, never fused with an
    add; at k up to 28672 and the CTA shapes the two launch there."""
    a = _randn((m, k), torch.bfloat16, cuda_device, 4)
    q, s = _int8_weight(k, n, cuda_device, 5)
    r = _randn((m, n), torch.bfloat16, cuda_device, 6) if res else None
    got = gemm_aie(a, q, b_scale=s, residual=r, out_dtype=out_dtype)
    want = gemm_aie(a, q.to(torch.bfloat16), out_dtype=torch.float32) * s
    if r is not None:
        want = want + r.float()
    torch.cuda.synchronize()
    assert torch.equal(got, want.to(out_dtype))


@pytest.mark.parametrize("m,k,n", [(8, 960, 320), (8, 2560, 960),
                                   (300, 960, 960), (9, 300, 200),
                                   (8, 4096, 8192)])
@pytest.mark.parametrize("mode", ["w8a16", "w8a16_f32", "w8a8"])
@pytest.mark.parametrize("epi", ["none", "residual", "bias+silu+res"])
def test_int8_gemm_tb_equals_gemm_aie_bitwise(cuda_device, m, k, n, mode,
                                              epi):
    """B6 == B1 on every int8 path, at tiles giving one, two and four or
    more k-chunks (W8A8 carries an int32 partial between chunks), and
    both match the plain version."""
    a, q, kw = _int8_operands(m, k, n, mode, epi, cuda_device, seed=9)
    want = gemm_aie(a, q, **kw)
    for tile in ((8, 1024, 256), (16, 512, 64), (64, 128, 32), (8, 32, 128)):
        t = TileConfig(*tile, "tb")
        got = gemm_tb(a, q, tile=t, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile
    _close(want, gemm_tb_plain(a, q, tile=TileConfig(16, 512, 64, "tb"),
                               **kw), _tol_dtype(mode, kw))


@pytest.mark.parametrize("tb", [False, True])
@pytest.mark.parametrize("mode", ["bf16", "w8a16", "w8a8"])
def test_out_quant_rounds_half_to_even(cuda_device, tb, mode):
    """Out-quant on B1 and B6b at values on exact .5 boundaries: integer
    sums over an output scale of 2 (W8A8, W8A16 with integral bf16
    activations, bf16 x bf16) give x / 2 = j + 0.5 for odd sums, which
    must round half to even, then clip to +-127, as the plain version
    (torch.round) does."""
    m, k, n = 16, 96, 200
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-6, 7, (m, k), generator=g)
    b = torch.randint(-6, 7, (k, n), generator=g)
    a = a.to(torch.int8 if mode == "w8a8" else torch.bfloat16)
    b = b.to(torch.bfloat16 if mode == "bf16" else torch.int8)
    kw = {"out_scale": 2.0, "out_dtype": torch.int8}
    if mode != "bf16":
        kw["b_scale"] = torch.ones(n)
    a, b = a.to(cuda_device), b.to(cuda_device)
    kw = {k_: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
          for k_, v in kw.items()}
    want = gemm_aie_plain(a, b, **kw)
    if tb:
        got = gemm_tb(a, b, tile=TileConfig(16, 32, 64, "tb"), **kw)
    else:
        got = gemm_aie(a, b, **kw)
    torch.cuda.synchronize()
    x = gemm_aie_plain(a, b, out_dtype=torch.float32,
                       b_scale=kw.get("b_scale"))
    assert ((x / 2) % 1 == 0.5).any(), "no value sits on a .5 boundary"
    assert got.dtype == torch.int8 and torch.equal(got, want)


def test_w8a8_int32_sums_are_exact(cuda_device):
    """The bare int32 sums of an int8 x int8 product, on B1 and B6 (an
    int32 partial between chunks), equal the exact integers."""
    g = torch.Generator().manual_seed(5)
    a = torch.randint(-127, 128, (300, 4096), generator=g,
                      dtype=torch.int8).to(cuda_device)
    b = torch.randint(-127, 128, (4096, 512), generator=g,
                      dtype=torch.int8).to(cuda_device)
    want = gemm_aie_plain(a, b, out_dtype=torch.int32)
    assert torch.equal(gemm_aie(a, b), want)
    assert torch.equal(gemm_tb(a, b, tile=TileConfig(64, 512, 64, "tb")),
                       want)


@pytest.mark.parametrize("m,k,n", [(1, 960, 2560), (8, 960, 2560),
                                   (300, 960, 2560), (7, 131, 77),
                                   (37, 300, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_gemm_gated_matches_plain_and_b1(cuda_device, m, k, n, dtype):
    """B2 with int8 weights (W8A16): within tolerance of the plain version,
    and with relu and f32 output == relu(B1 W8A16) * B1 W8A16 bit for bit
    (both accumulators run B1's chain on the widened weights and scale
    once before the gate)."""
    a = _randn((m, k), dtype, cuda_device, 0) / k ** 0.5
    qg, sg = _int8_weight(k, n, cuda_device, 1)
    qu, su = _int8_weight(k, n, cuda_device, 2)
    kw = dict(bg_scale=sg, bu_scale=su)
    _close(gemm_gated(a, qg, qu, **kw), gemm_gated_plain(a, qg, qu, **kw),
           dtype)
    got = gemm_gated(a, qg, qu, activation="relu", out_dtype=torch.float32,
                     **kw)
    want = torch.relu(gemm_aie(a, qg, b_scale=sg, out_dtype=torch.float32)) \
        * gemm_aie(a, qu, b_scale=su, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


#: B7's int8 cases: (case, k, n); (256, 192) takes the tensor-map copies,
#: (300, 200) and (100, 70) the cp.async path (rows not 16-byte units),
#: qwen3's gate/up and down shapes in bf16
INT8_GROUPED = [(case, k, n) for case in sorted(GROUP_CASES)
                for k, n in ((256, 192), (300, 200), (100, 70))] + \
    [(case, k, n) for case in sorted(QWEN3_CASES)
     for k, n in ((4096, 1536), (1536, 4096))]


@pytest.mark.parametrize("case,k,n,dtype", [
    (case, k, n, torch.bfloat16) for case, k, n in INT8_GROUPED]
    # the f32 body (the f32 smoke models' W8A16) at the edge shapes
    + [(case, k, n, torch.float32) for case, k, n in INT8_GROUPED
       if k * n <= 300 * 200])
def test_int8_gemm_grouped_matches_plain_and_b1(cuda_device, case, k, n,
                                                dtype):
    """B7 on an int8 bank with its per-expert (E, 1, n) scale (W8A16), at
    both CTA shapes: within tolerance of the plain version, rows past the
    groups zero, and each group's rows == B1's W8A16 rows against its
    expert, bit for bit."""
    sizes, m = {**GROUP_CASES, **QWEN3_CASES}[case]
    e = len(sizes)
    a = _randn((m, k), dtype, cuda_device, 0) / k ** 0.5
    q, s = _int8_weight(k, n, cuda_device, 1, lead=(e,))
    gs = torch.as_tensor(np.asarray(sizes, np.int32), device=cuda_device)
    bias = _randn((e, n), torch.float32, cuda_device, 2)
    kw = {"out_dtype": dtype, "b_scale": s, "bias": bias,
          "activation": "silu"}
    want = gemm_grouped_plain(a, q, gs, **kw)
    for cta in _ctas(dtype):
        got = gemm_grouped(a, q, gs, cta=cta, **kw)
        _close(got, want, dtype)
        start = 0
        for g, size in enumerate(sizes):
            if size:
                row = gemm_aie(a[start:start + size], q[g], b_scale=s[g],
                               bias=bias[g], activation="silu",
                               out_dtype=dtype)
                assert torch.equal(got[start:start + size], row), (cta, g)
            start += size
        assert not got[start:].any(), cta


def test_int8_paths_launch_their_kernels_or_raise(cuda_device):
    """On a card every int8 path launches its kernel (no plain version,
    no dequantize-then-bf16 call) or raises."""
    a = _randn((8, 256), torch.bfloat16, cuda_device, 0)
    q, s = _int8_weight(256, 192, cuda_device, 1)
    plain = (gemm_aie_plain.launches, gemm_gated_plain.launches,
             gemm_tb_plain.launches, gemm_grouped_plain.launches)
    before = (gemm_aie.launches, gemm_gated.launches, gemm_tb.final_launches,
              gemm_grouped.launches)
    gemm_aie(a, q, b_scale=s)
    gemm_aie(quantize_activations(a)[0], q, b_scale=s)
    gemm_gated(a, q, q, bg_scale=s, bu_scale=s)
    gemm_tb(a, q, tile=TileConfig(8, 256, 64, "tb"), b_scale=s)
    qe, se = _int8_weight(256, 192, cuda_device, 2, lead=(3,))
    gemm_grouped(a, qe, torch.tensor([3, 0, 5], dtype=torch.int32,
                                     device=cuda_device), b_scale=se)
    assert (gemm_aie.launches - before[0], gemm_gated.launches - before[1],
            gemm_tb.final_launches - before[2],
            gemm_grouped.launches - before[3]) == (2, 1, 1, 1)
    assert plain == (gemm_aie_plain.launches, gemm_gated_plain.launches,
                     gemm_tb_plain.launches, gemm_grouped_plain.launches)
    with pytest.raises(TypeError):
        gemm_gated(quantize_activations(a)[0], q, q, bg_scale=s, bu_scale=s)
    with pytest.raises(TypeError):
        gemm_grouped(quantize_activations(a)[0], qe,
                     torch.tensor([3, 0, 5], dtype=torch.int32,
                                  device=cuda_device), b_scale=se)


# ------------------------------------------------------------ training

#: smollm-360m's training GEMMs at b 8 x s 512 (4096 tokens): one layer's
#: dA (m 4096: wq/wo, wk/wv, w_down, the gated pair) and dB (m = d_model
#: 960 and d_ff 2560, k 4096), and one loss chunk's lm_head dA (512 x
#: 49152 x 960, B6 in 96 k-chunks) and dB (960 x 512 x 49152); the A of
#: a dB and the B of a dA arrive transposed, as views
TRAIN_GEMMS = [(4096, 960, 960, "b"), (4096, 320, 960, "b"),
               (4096, 960, 2560, "b"), (4096, 2560, 960, "b"),
               (960, 4096, 960, "a"), (960, 4096, 320, "a"),
               (960, 4096, 2560, "a"), (2560, 4096, 960, "a"),
               (512, 49152, 960, "b"), (960, 512, 49152, "a")]


def _train_operands(m, k, n, view, device):
    a = _randn((k, m) if view == "a" else (m, k), torch.bfloat16, device,
               0) * k ** -0.5
    w = _randn((n, k) if view == "b" else (k, n), torch.bfloat16, device, 1)
    return (a.T if view == "a" else a), (w.T if view == "b" else w)


@pytest.mark.parametrize("m,k,n,view", TRAIN_GEMMS)
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_training_gemm_shapes_match_plain(cuda_device, m, k, n, view, out):
    """B1, and B6 at the tile its 'tb' plan gives, on a transposed view
    at the backward's shapes, against their plain versions (bf16 2e-2);
    f32 out is what the gated pair's pre-activation recompute asks."""
    a, w = _train_operands(m, k, n, view, cuda_device)
    kw = {"out_dtype": torch.float32 if out == "f32" else torch.bfloat16}
    _close(gemm_aie(a, w, **kw), gemm_aie_plain(a, w, **kw), torch.bfloat16)
    pl = ops.plan(ops.GemmSpec(strategy="tb", out_dtype=kw["out_dtype"]),
                  (m, k, n))
    assert pl.chunk_bk > 0
    _close(gemm_tb(a, w, tile=pl.tile, **kw),
           gemm_tb_plain(a, w, tile=pl.tile, **kw), torch.bfloat16)


GRAD_GEMMS = {"plain": {}, "bias+silu": {"bias": True,
                                         "activation": "silu"},
              "residual tb": {"residual": True, "strategy": "tb"},
              "gated": {"gated": True, "activation": "silu"}}


@pytest.mark.parametrize("case", list(GRAD_GEMMS))
def test_gemm_function_grads_on_the_card_match_the_cpu(cuda_device, case):
    """The GEMM Function's gradients with CUDA tensors (kernels forward
    and backward) against the same Function on CPU tensors (plain
    versions), f32, atol = rtol = 1e-5."""
    opt = GRAD_GEMMS[case]
    m, k, n = 96, 200, 136
    names = ["a", "b"] + [x for x in ("b2", "bias", "residual")
                          if opt.get("gated" if x == "b2" else x)]
    shapes = {"a": (m, k), "b": (k, n), "b2": (k, n), "bias": (n,),
              "residual": (m, n)}
    vals = {x: _randn(shapes[x], torch.float32, "cpu", i) * (
        k ** -0.5 if x in ("b", "b2") else 1.0) for i, x in enumerate(names)}
    g = _randn((m, n), torch.float32, "cpu", 9)
    kw = {x: opt[x] for x in ("activation", "strategy") if x in opt}
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = {x: v.to(dev, copy=True).requires_grad_()
                  for x, v in vals.items()}
        out = ops.gemm(leaves["a"], leaves["b"], b2=leaves.get("b2"),
                       bias=leaves.get("bias"),
                       residual=leaves.get("residual"), **kw)
        (out * g.to(dev)).sum().backward()
        grads[str(dev)] = {x: t.grad.cpu() for x, t in leaves.items()}
    for x in names:
        torch.testing.assert_close(grads["cuda"][x], grads["cpu"][x],
                                   atol=1e-5, rtol=1e-5, msg=x)


@pytest.mark.parametrize("s,dtype", [(96, torch.float32),
                                     (512, torch.bfloat16),
                                     (1100, torch.float32)])
def test_attention_function_grads_on_the_card_match_the_cpu(cuda_device, s,
                                                            dtype):
    """B3 forward and the recompute backward on the card against the
    same Function on the CPU: f32 atol = rtol = 1e-5, bf16 2e-2; s = 1100
    recomputes through the blocked path."""
    shapes = ((2, s, 15, 64), (2, s, 5, 64), (2, s, 5, 64))
    vals = [_randn(sh, dtype, "cpu", i) for i, sh in enumerate(shapes)]
    g = _randn(shapes[0], dtype, "cpu", 7)
    res = {}
    for dev in ("cpu", cuda_device):
        qkv = [v.to(dev, copy=True).requires_grad_() for v in vals]
        out = ops.attention(*qkv)
        (out.float() * g.to(dev).float()).sum().backward()
        res[str(dev)] = [out.detach().cpu()] + [t.grad.cpu() for t in qkv]
    tol = TOL[dtype]
    for got, want in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One AdamW step of smollm-360m-smoke (f32) from one state: loss,
    grad norm, every gradient, parameter and moment within 1e-4 (lr 3e-5
    from step 0, so a near-zero gradient of another sign moves its
    element at most 6e-5 apart).  As a step moves every element by only
    ~lr, the update itself, (p_new - p_old) / lr, is held within 1e-2
    (its f32 rounding is ~2e-3) where |grad| > 1e-5 on both devices."""
    from repro_torch.bridge import to_device, tree_leaves
    from repro_torch.data import pipeline
    from repro_torch.train import train_step as TS
    cfg = get_smoke_config("smollm-360m")
    state = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = pipeline.make_batch(
        cfg, pipeline.DataConfig(seq_len=32, global_batch=4), 0)
    step = TS.make_train_step(cfg, peak_lr=3e-5, warmup_steps=0,
                              return_grads=True)
    c_state, c_m = step(state, batch)
    g_state, g_m = step(to_device(state, cuda_device),
                        to_device(batch, cuda_device))
    for c_tree, g_tree in ((c_m, g_m), (c_state.params, g_state.params),
                           (c_state.opt.mu, g_state.opt.mu)):
        for c, gv in zip(tree_leaves(c_tree), tree_leaves(g_tree)):
            torch.testing.assert_close(gv.cpu(), c, atol=1e-4, rtol=1e-4)
    lr, clear_n, all_n = float(c_m["lr"]), 0, 0
    for p0, c, gv, gc, gg in zip(*(tree_leaves(t) for t in (
            state.params, c_state.params, g_state.params, c_m["grads"],
            g_m["grads"]))):
        clear = (gc.abs() > 1e-5) & (gg.cpu().abs() > 1e-5)
        torch.testing.assert_close(((gv.cpu() - p0) / lr)[clear],
                                   ((c - p0) / lr)[clear], atol=1e-2, rtol=0)
        clear_n, all_n = clear_n + int(clear.sum()), all_n + clear.numel()
    assert clear_n >= all_n / 2


# -------------------------------------------------------- MoE training

#: qwen3-moe-235b-a22b's training step at b 8 x s 512: 4096 tokens routed
#: top-8 over 128 experts, capacity 320 (32768 routed rows)
QWEN3_TRAIN_SIZES = _routed(4096, 128, 8, 320, 23)


@pytest.mark.parametrize("k,n", [(4096, 1536), (1536, 4096)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("transposed", [False, True])
def test_gemm_grouped_at_the_training_shapes(cuda_device, k, n, out,
                                             transposed):
    """B7 at the MoE training step's shapes (32768 rows), with an f32
    output (the gate's pre-activation recompute) and on a transposed
    bank view (dA), against its plain version: a bf16 output at 2e-2, an
    f32 one at 1e-4 (exact bf16 products summed in f32 in another order,
    where an output rounded to bf16 would be ~4e-3 off); the rows past
    the groups come back zero."""
    sizes = QWEN3_TRAIN_SIZES
    m, e = 4096 * 8, len(sizes)
    a = _randn((m, k), torch.bfloat16, cuda_device, 0) / k ** 0.5
    bank = _randn((e, n, k) if transposed else (e, k, n), torch.bfloat16,
                  cuda_device, 1)
    if transposed:
        bank = bank.transpose(1, 2)
    gs = torch.as_tensor(np.asarray(sizes, np.int32), device=cuda_device)
    got = gemm_grouped(a, bank, gs, out_dtype=out)
    want = gemm_grouped_plain(a, bank, gs, out_dtype=out)
    assert got.dtype == out
    tol = TOL[torch.bfloat16] if out == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert not got[int(sum(sizes)):].any()


@pytest.mark.parametrize("case,dtype", [("plain", torch.float32),
                                        ("bias+silu", torch.float32),
                                        ("silu", torch.bfloat16)])
def test_grouped_function_grads_on_the_card_match_the_cpu(cuda_device, case,
                                                          dtype):
    """The grouped GEMM's Function with CUDA tensors (B7 forward, f32
    recompute and dA; the plain dB) against the same Function on CPU
    tensors, with an empty group and rows past the groups: f32 atol =
    rtol = 1e-5, bf16 2e-2."""
    sizes, m, k, n = [40, 0, 70, 33, 12], 170, 136, 200
    e = len(sizes)
    vals = {"a": _randn((m, k), dtype, "cpu", 0),
            "b": _randn((e, k, n), dtype, "cpu", 1) * k ** -0.5}
    if case == "bias+silu":
        vals["bias"] = _randn((e, n), dtype, "cpu", 2)
    act = None if case == "plain" else "silu"
    g = _randn((m, n), torch.float32, "cpu", 3)
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = {x: v.to(dev, copy=True).requires_grad_()
                  for x, v in vals.items()}
        gs = torch.as_tensor(np.asarray(sizes, np.int32), device=dev)
        out = ops.gemm_grouped(leaves["a"], leaves["b"], gs,
                               bias=leaves.get("bias"), activation=act,
                               out_dtype=torch.float32)
        (out * g.to(dev)).sum().backward()
        grads[str(dev)] = {x: t.grad.cpu() for x, t in leaves.items()}
    for x in vals:
        _close(grads["cuda"][x], grads["cpu"][x], dtype)


def test_moe_smoke_resume_on_the_card(cuda_device, tmp_path):
    """qwen3-moe smoke (f32) on the card: four unbroken steps saved every
    two; the step-4 checkpoint is deleted and the run resumed from step
    2 to four.  When two unbroken runs agree bit for bit, the resumed
    one must too; otherwise it must lie within their spread."""
    from repro_torch.bridge import tree_leaves
    from repro_torch.launch import train as train_cli
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    kw = dict(seq_len=32, global_batch=4, device=cuda_device)

    def run(**extra):
        seen = {}

        def keep(step, state, m, times):
            seen[step] = (m["loss"].cpu(), [t.cpu() for t in
                                            tree_leaves(state.params)])
        train_cli.train(cfg, on_step=keep, **dict(kw, **extra))
        return seen

    first = run(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2)
    second = run(steps=4)
    shutil.rmtree(tmp_path / "step_00000004")
    resumed = run(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2)
    assert sorted(resumed) == [2, 3]

    def spread(x, y):
        return max((a - b).abs().max().item() for a, b in
                   zip([x[3][0]] + x[3][1], [y[3][0]] + y[3][1]))
    bound = spread(first, second)
    assert spread(resumed, first) <= bound


# ------------------------------------------------ telemetry and tuning


def test_span_sync_waits_for_a_b1_launch(cuda_device):
    """A span that syncs on B1's output lasts at least the kernel's
    event-timed device time (the fastest of five): the wait is billed to
    the span.  Without the sync the span ends at the launch."""
    from repro_torch import telemetry
    a = _randn((8192, 8192), torch.bfloat16, cuda_device, 0)
    b = _randn((8192, 8192), torch.bfloat16, cuda_device, 1)
    gemm_aie(a, b)                                   # build and warm
    torch.cuda.synchronize()
    kernel_ms = []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        gemm_aie(a, b)
        t1.record()
        t1.synchronize()
        kernel_ms.append(t0.elapsed_time(t1))
    rec = telemetry.enable(telemetry.Recorder())
    try:
        with telemetry.span("synced") as sp:
            sp.sync(gemm_aie(a, b))
        with telemetry.span("unsynced"):
            gemm_aie(a, b)
        torch.cuda.synchronize()
    finally:
        telemetry.disable()
    dur = {e["name"]: e["dur"] * 1e3 for e in rec.events}
    assert dur["synced"] >= 0.95 * min(kernel_ms) > 0
    assert dur["unsynced"] < 0.5 * min(kernel_ms)


@pytest.mark.parametrize("strategy", ["aie", "tb"])
def test_measure_plan_on_the_card(cuda_device, strategy):
    """The harness times a plan on the card between device syncs and
    leaves the launch counters as it found them."""
    from repro_torch import ops
    from repro_torch.kernels.gemm_tb import gemm_tb
    from repro_torch.tune import measure
    pl = ops.plan(ops.GemmSpec(strategy=strategy), (300, 4096, 8192))
    before = (gemm_aie.launches, gemm_tb.launches, gemm_tb.final_launches)
    meas = measure.measure_plan(pl, iters=5, warmup=2, device=cuda_device)
    assert (gemm_aie.launches, gemm_tb.launches,
            gemm_tb.final_launches) == before
    assert meas.iters == 5 and 5e-6 < meas.median_s < 5e-2


def test_tuned_smoke_serve_gives_the_same_tokens(cuda_device, tmp_path,
                                                monkeypatch):
    """smollm-360m-smoke (bf16) served with every GEMM tuned (K = 8, on
    the card) decodes the untuned run's tokens bit for bit; a second
    process over the cache file measures nothing."""
    from repro_torch import ops, tune
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import DecodeEngine, acceptance_requests
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tc.json"))
    tune.tuning_cache_reset()
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"),
                              dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(0), device=cuda_device)

    def serve():
        eng = DecodeEngine(params, cfg, batch=2, max_len=64,
                           device=cuda_device)
        return [r.tokens for r in sorted(eng.run(
            acceptance_requests(cfg.vocab)), key=lambda r: r.rid)]

    ops.plan_cache_clear()
    want = serve()
    tune.enable(8)
    ops.plan_cache_clear()
    try:
        got = serve()
        tuned = [p for p in ops.plans() if p.source == "tuned"]
        assert tuned and tune.tuning_cache_info().measurements > 0
        tune.tuning_cache_reset()
        ops.plan_cache_clear()
        again = serve()
        assert tune.tuning_cache_info().measurements == 0
    finally:
        tune.disable()
        ops.plan_cache_clear()
        tune.tuning_cache_reset()
    for a, b, c in zip(want, got, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# ------------------------------------ windowed serving: h2o-danube-3-4b

#: h2o-danube-3-4b's attention: 32 q heads on 8 kv heads of 120, window
#: 4096; slot positions before, at and past the window, and past a
#: 4096-slot ring's wrap
H2O = dict(hq=32, hkv=8, d=120, window=4096)
H2O_POS = [5, 900, 4095, 4096, 4097, 5000, 6100, 8000]


@pytest.mark.parametrize("sq,skv", [(5000, 5000), (512, 5000), (64, 64)])
def test_h2o_flash_attention_window_matches_plain(cuda_device, sq, skv):
    """B3 at h2o's heads with its window: a 5000-token prompt past the
    window, the last 512-token chunk of it (q_offset 4488) and a short
    prompt."""
    bf = torch.bfloat16
    q = _randn((1, sq, H2O["hq"], H2O["d"]), bf, cuda_device, 0)
    k = _randn((1, skv, H2O["hkv"], H2O["d"]), bf, cuda_device, 1)
    v = _randn((1, skv, H2O["hkv"], H2O["d"]), bf, cuda_device, 2)
    kw = dict(causal=True, window=H2O["window"])
    _close(flash_attention(q, k, v, **kw),
           flash_attention_plain(q, k, v, **kw), bf)


@pytest.mark.parametrize("case", ["window", "ring"])
def test_h2o_flash_decode_matches_plain(cuda_device, case):
    """B4 at h2o's heads: over a full-length cache of 8192 keys with the
    4096 window masked, and over a 4096-slot ring at ring-clamped
    positions min(pos, 4095) with no window (the dense ring decode)."""
    bf = torch.bfloat16
    S = 8192 if case == "window" else 4096
    q = _randn((8, H2O["hq"], H2O["d"]), bf, cuda_device, 0)
    k = _randn((8, S, H2O["hkv"], H2O["d"]), bf, cuda_device, 1)
    v = _randn((8, S, H2O["hkv"], H2O["d"]), bf, cuda_device, 2)
    pos = torch.as_tensor(H2O_POS, dtype=torch.int32, device=cuda_device)
    window = H2O["window"]
    if case == "ring":
        pos, window = pos.clamp(max=S - 1), 0
    _close(flash_decode(q, k, v, pos, window=window),
           flash_decode_plain(q, k, v, pos, window=window), bf)


def test_h2o_flash_decode_paged_window_matches_plain(cuda_device):
    """B5 at h2o's heads with the 4096 window, 16-token pages, slots past
    position 4096, and B5 == B4 bit for bit there."""
    bf = torch.bfloat16
    q = _randn((8, H2O["hq"], H2O["d"]), bf, cuda_device, 0)
    k = _randn((8, 8192, H2O["hkv"], H2O["d"]), bf, cuda_device, 1)
    v = _randn((8, 8192, H2O["hkv"], H2O["d"]), bf, cuda_device, 2)
    k_pages, v_pages, table = _paged_pool(k, v, 16, 3)
    pos = torch.as_tensor(H2O_POS, dtype=torch.int32, device=cuda_device)
    got = flash_decode_paged(q, k_pages, v_pages, table, pos,
                             window=H2O["window"])
    _close(got, flash_decode_paged_plain(q, k_pages, v_pages, table, pos,
                                         window=H2O["window"]), bf)
    assert torch.equal(got, flash_decode(q, k, v, pos,
                                         window=H2O["window"]))


# --------------------------- recurrentgemma-9b's local layers: head_dim 256

#: recurrentgemma-9b's local attention: 16 q heads on one kv head of 256,
#: window 2048; slot positions before, at and past the window and a
#: 2048-slot ring's wrap
RG = dict(hq=16, hkv=1, d=256, window=2048)
RG_POS = [5, 900, 2047, 2048, 2049, 2500, 3000, 4000]


@pytest.mark.parametrize("sq,skv", [(3000, 3000), (512, 3000), (64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rg_flash_attention_window_matches_plain(cuda_device, sq, skv,
                                                 dtype):
    """B3 at head_dim 256 with recurrentgemma's window: a 3000-token
    prompt past the window, its last 512-token chunk (q_offset 2488) and
    a short prompt, in both bodies."""
    q = _randn((1, sq, RG["hq"], RG["d"]), dtype, cuda_device, 0)
    k = _randn((1, skv, RG["hkv"], RG["d"]), dtype, cuda_device, 1)
    v = _randn((1, skv, RG["hkv"], RG["d"]), dtype, cuda_device, 2)
    kw = dict(causal=True, window=RG["window"])
    _close(flash_attention(q, k, v, **kw),
           flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("case", ["window", "ring"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rg_flash_decode_matches_plain(cuda_device, case, dtype):
    """B4 at head_dim 256, group 16: over a 4096-key cache with the 2048
    window masked, and over a 2048-slot ring at ring-clamped positions
    with no window (the dense ring decode)."""
    S = 4096 if case == "window" else RG["window"]
    q = _randn((8, RG["hq"], RG["d"]), dtype, cuda_device, 0)
    k = _randn((8, S, RG["hkv"], RG["d"]), dtype, cuda_device, 1)
    v = _randn((8, S, RG["hkv"], RG["d"]), dtype, cuda_device, 2)
    pos = torch.as_tensor(RG_POS, dtype=torch.int32, device=cuda_device)
    window = RG["window"]
    if case == "ring":
        pos, window = pos.clamp(max=S - 1), 0
    _close(flash_decode(q, k, v, pos, window=window),
           flash_decode_plain(q, k, v, pos, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rg_flash_decode_paged_window_matches_plain(cuda_device, dtype):
    """B5 at head_dim 256 with the 2048 window, 16-token pages, slots past
    position 2048; and B5 == B4 bit for bit there."""
    q = _randn((8, RG["hq"], RG["d"]), dtype, cuda_device, 0)
    k = _randn((8, 4096, RG["hkv"], RG["d"]), dtype, cuda_device, 1)
    v = _randn((8, 4096, RG["hkv"], RG["d"]), dtype, cuda_device, 2)
    k_pages, v_pages, table = _paged_pool(k, v, 16, 3)
    pos = torch.as_tensor(RG_POS, dtype=torch.int32, device=cuda_device)
    got = flash_decode_paged(q, k_pages, v_pages, table, pos,
                             window=RG["window"])
    _close(got, flash_decode_paged_plain(q, k_pages, v_pages, table, pos,
                                         window=RG["window"]), dtype)
    assert torch.equal(got, flash_decode(q, k, v, pos,
                                         window=RG["window"]))


def test_rg_decode_is_batch_invariant(cuda_device):
    """B4 over recurrentgemma's ring: each slot's row alone has the bits
    it has among eight."""
    bf = torch.bfloat16
    q = _randn((8, RG["hq"], RG["d"]), bf, cuda_device, 0)
    k = _randn((8, 2048, RG["hkv"], RG["d"]), bf, cuda_device, 1)
    v = _randn((8, 2048, RG["hkv"], RG["d"]), bf, cuda_device, 2)
    pos = torch.as_tensor(RG_POS, dtype=torch.int32,
                          device=cuda_device).clamp(max=2047)
    out = flash_decode(q, k, v, pos)
    for i in range(8):
        one = slice(i, i + 1)
        assert torch.equal(flash_decode(q[one], k[one], v[one], pos[one]),
                           out[one]), i


def test_mamba2_decode_is_batch_invariant_on_the_card(cuda_device):
    """mamba2-370m's decode mixer at full width in bf16 (B1 projections,
    the read-out summed by halving): each slot's output and state alone
    have the bits they have among eight."""
    from repro_torch.models import mamba2 as M2
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = M2.init_mamba2(gen, 1024, 128, torch.bfloat16)
    dd = M2.dims(1024, 128)
    x = _randn((8, 1, 1024), torch.bfloat16, cuda_device, 0)
    cache = {"conv": _randn((8, 3, dd["d_inner"] + 256), torch.bfloat16,
                            cuda_device, 1),
             "ssd": _randn((8, dd["heads"], 64, 128), torch.float32,
                           cuda_device, 2)}
    with torch.inference_mode():
        y, c = M2.mamba2_decode(p, x, cache, 128)
        for i in range(8):
            one = slice(i, i + 1)
            yi, ci = M2.mamba2_decode(p, x[one], {k: v[one] for k, v in
                                                  cache.items()}, 128)
            assert torch.equal(yi, y[one]), i
            assert torch.equal(ci["ssd"], c["ssd"][one]), i


def test_attention_one_shot_repeat_resolves_no_plan(cuda_device,
                                                    monkeypatch):
    """A repeated one-shot attention call on the card reuses its plan: the
    hit counter moves, the kernel launches, and no plan is resolved."""
    from repro_torch import ops
    from repro_torch.kernels import attn_api
    bf = torch.bfloat16
    q = _randn((8, 32, 120), bf, cuda_device, 0)
    k = _randn((8, 4096, 8, 120), bf, cuda_device, 1)
    pos = torch.full((8,), 4095, dtype=torch.int32, device=cuda_device)
    ops.attn_plan_cache_clear()
    first = ops.decode_attention(q, k, k, pos)
    (pl,) = ops.attn_plans()
    assert pl.kernel == "flash_decode" and pl.dispatch.startswith("cuda:")

    def no_resolve(*a, **kw):
        raise AssertionError("a one-shot repeat resolved a plan")
    monkeypatch.setattr(attn_api, "_resolve", no_resolve)
    monkeypatch.setattr(attn_api, "attn_plan", no_resolve)
    hits, launches = ops.attn_plan_cache_info().hits, flash_decode.launches
    again = ops.decode_attention(q, k, k, pos)
    torch.cuda.synchronize()
    assert ops.attn_plan_cache_info().hits == hits + 1
    assert flash_decode.launches == launches + 1
    assert torch.equal(first, again)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
def test_op_cost_card_equals_meta(cuda_device, arch):
    """The op-by-op count (``repro_torch.core.op_cost``) of one smoke
    train step on the card equals the meta trace's of the same config
    and batch, scope by scope: the kernels count at their boundary
    whatever runs inside them.  B7's rows are live on the card and
    capacity on meta; the smoke MoE drops no token, so they agree."""
    from repro_torch.core import op_cost
    from repro_torch.data import pipeline as P
    from repro_torch.train import train_step as TS
    cfg = get_smoke_config(arch)
    dc = P.DataConfig(seq_len=16, global_batch=4)
    step = TS.make_train_step(cfg, optimizer="adamw", n_loss_chunks=4)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    runs = {}
    for where, state, batch in (
            ("cuda", TS.init_state(cfg, gen, device=cuda_device,
                                   optimizer="adamw"),
             P.make_batch(cfg, dc, 0, device=cuda_device)),
            ("meta", TS.state_struct(cfg, "adamw"), P.batch_spec(cfg, dc))):
        with op_cost.count() as c:
            step(state, batch)
        runs[where] = c.result()
    torch.cuda.synchronize()
    card, meta = runs["cuda"], runs["meta"]
    assert card.flops_by_scope == meta.flops_by_scope
    assert card.bytes_by_scope == meta.bytes_by_scope
    assert card.calls_by_scope == meta.calls_by_scope
    assert card.grouped_rows["live"] == meta.grouped_rows["capacity"]


# ------------------------------------------------ compiled steps (A13)

#: one smoke config of each cache kind: dense, paged, MoE, a windowed
#: ring, recurrent (rec + local ring; ssm), the encoder-decoder's cross
#: cache
GRAPH_ENGINES = [("smollm-360m", {}),
                 ("smollm-360m", dict(page_size=8, prefill_chunk=8)),
                 ("qwen3-moe-235b-a22b", {}), ("h2o-danube-3-4b", {}),
                 ("recurrentgemma-9b", {}), ("mamba2-370m", {}),
                 ("whisper-medium", {})]


def _graph_trace(cfg):
    """The acceptance trace plus a prompt past the smoke window (the
    ring wraps while it decodes); an encoder-decoder's requests carry
    their own frames."""
    from repro_torch.serve.engine import Request, acceptance_requests
    rng = np.random.default_rng(21)
    reqs = acceptance_requests(cfg.vocab) + [Request(
        prompt=rng.integers(0, cfg.vocab, (40,)).astype(np.int32),
        max_tokens=24)]
    if cfg.encoder_layers:
        for i, r in enumerate(reqs):
            r.frames = rng.standard_normal(
                (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return reqs


@pytest.mark.parametrize("arch,kw", GRAPH_ENGINES,
                         ids=[a + ("-paged" if k else "")
                              for a, k in GRAPH_ENGINES])
def test_graph_engine_equals_eager_engine(cuda_device, arch, kw):
    """The same trace through an engine that replays its decode step
    from a CUDA graph and one that runs it eagerly (``graphs=False``):
    equal tokens, request by request; the kernels' launch counters equal
    (each replay adds the captured launches); and with telemetry on, a
    MoE model's routed / dropped counters equal the eager run's."""
    from repro_torch import telemetry
    from repro_torch.models import transformer as T
    from repro_torch.runtime import graphs
    from repro_torch.serve.engine import DecodeEngine
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(0), device=cuda_device)
    runs = {}
    for on in (False, True):
        eng = DecodeEngine(params, cfg, batch=2, max_len=72,
                           device=cuda_device, graphs=on, **kw)
        keys = graphs.counters()
        before = {k: getattr(*k) for k in keys}
        rec = telemetry.enable(telemetry.Recorder())
        try:
            toks = [r.tokens for r in sorted(eng.run(_graph_trace(cfg)),
                                             key=lambda r: r.rid)]
            counters = rec.snapshot()["counters"]
        finally:
            telemetry.disable()
        runs[on] = (toks, {k: getattr(*k) - before[k] for k in keys},
                    {k: v for k, v in counters.items()
                     if k.startswith("moe.")}, dict(eng.metrics))
    (want, eager_launches, eager_moe, _), (got, launches, moe, m) = \
        runs[False], runs[True]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert launches == eager_launches
    assert sum(launches.values()) > 0
    assert m["graph_captures"] == 1 and m["graph_replays"] > 0
    assert moe == eager_moe and (bool(moe) == bool(cfg.n_experts))


def test_captured_train_step_equals_the_eager_steps(cuda_device):
    """smollm-360m-smoke (bf16), three AdamW steps from one state: the
    step replayed from a CUDA graph (``launch.train.CapturedStep``), the
    eager consuming step and the step that returns a new state agree bit
    for bit (loss, grad norm, every parameter and both moments), and
    the replays count their launches as the eager steps do."""
    from repro_torch.bridge import map_tree, tree_leaves
    from repro_torch.data import pipeline as P
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime import graphs
    from repro_torch.train import train_step as TS
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"),
                              dtype="bfloat16")
    base = TS.init_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device=cuda_device, optimizer="adamw")
    kw = dict(optimizer="adamw", warmup_steps=1, peak_lr=1e-2)
    steps = {"new": (TS.make_train_step(cfg, **kw), map_tree(torch.clone,
                                                             base)),
             "eager": (TS.make_train_step(cfg, consume=True, **kw),
                       map_tree(torch.clone, base)),
             "graph": (train_cli.CapturedStep(TS.make_train_step(
                 cfg, consume=True, **kw)), map_tree(torch.clone, base))}
    keys = graphs.counters()
    launches = {}
    for i in range(3):
        batch = P.make_batch(cfg, P.DataConfig(seq_len=32, global_batch=4),
                             i, device=cuda_device)
        metrics = {}
        for name, (fn, state) in steps.items():
            before = {k: getattr(*k) for k in keys}
            state, m = fn(state, batch)
            steps[name] = (fn, state)
            metrics[name] = {k: m[k].clone() for k in ("loss", "grad_norm")}
            launches[name] = {k: getattr(*k) - before[k] for k in keys}
        for name in ("eager", "graph"):
            for k in ("loss", "grad_norm"):
                assert torch.equal(metrics[name][k], metrics["new"][k]), \
                    (i, name, k)
        assert launches["graph"] == launches["eager"] == launches["new"]
    want = list(tree_leaves(dict(p=steps["new"][1].params,
                                 mu=steps["new"][1].opt.mu,
                                 nu=steps["new"][1].opt.nu)))
    for name in ("eager", "graph"):
        got = list(tree_leaves(dict(p=steps[name][1].params,
                                    mu=steps[name][1].opt.mu,
                                    nu=steps[name][1].opt.nu)))
        assert all(torch.equal(a, b) for a, b in zip(want, got)), name
    assert steps["graph"][0].graph.replays == 2
