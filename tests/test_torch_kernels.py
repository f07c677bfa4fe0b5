"""Each ported kernel module against the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode (as
tests/test_kernels.py and tests/test_flash_decode.py do); the port's
wrapper gets the same numpy inputs on CPU tensors, where it dispatches
to its plain PyTorch version.  The CUDA kernels themselves are checked
against those plain versions on the card (tests/test_torch_cuda.py).

Tolerances: f32 ``atol=rtol=1e-5``; bf16 compared in f32 at
``atol=rtol=2e-2`` (a few bf16 ulps after differently ordered f32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiling import TileConfig
from repro.kernels import ref as jref
from repro.kernels.attn_api import _decode_attention_xla
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_decode import flash_decode as j_decode
from repro.kernels.flash_decode import flash_decode_paged as j_paged
from repro.kernels.gemm_aie import gemm_aie as j_gemm_aie
from repro.kernels.gemm_gated import gemm_gated as j_gemm_gated
from repro_torch.bridge import from_jax, to_numpy
from repro_torch.kernels import acc_dtype
from repro_torch.kernels import ref as tref
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_paged,
                                              flash_decode_paged_plain)
from repro_torch.kernels.gemm_aie import gemm_aie, gemm_aie_plain
from repro_torch.kernels.gemm_gated import gemm_gated

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TILE = TileConfig(8, 128, 128, "aie")


def _pair(shape, dtype, seed, scale=1.0):
    """The same values as a JAX array and a CPU torch tensor."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    jx = jnp.asarray(x, jnp.float32).astype(DTYPES[dtype][0])
    return jx, from_jax({"x": np.asarray(jx)})["x"]


def _close(got_t, want_j, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got_t.float().numpy(), np.asarray(want_j, np.float32),
        atol=tol, rtol=tol)


def _pad(x, shape):
    return jnp.pad(x, [(0, t - s) for s, t in zip(x.shape, shape)])


def _up(x, mult):
    return -(-x // mult) * mult


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,epi", [
    (3, 60, 200, "none"),          # ragged m/k/n, f32 default out
    (8, 130, 96, "residual"),      # the wo / w_down flush
    (5, 100, 70, "bias+silu"),
    (2, 64, 40, "gelu"),           # tanh gelu
    (4, 96, 136, "f32out"),        # lm_head: f32 out whatever the input
])
def test_gemm_aie_matches_jax_interpret(m, k, n, epi, dtype):
    a_j, a_t = _pair((m, k), dtype, 0, k ** -0.5)
    b_j, b_t = _pair((k, n), dtype, 1)
    mp, kp, np_ = _up(m, TILE.bm), _up(k, TILE.bk), _up(n, TILE.bn)
    jkw, tkw = {}, {}
    if epi == "residual":
        r_j, r_t = _pair((m, n), dtype, 2)
        jkw["residual"], tkw["residual"] = _pad(r_j, (mp, np_)), r_t
    if epi == "bias+silu":
        c_j, c_t = _pair((n,), "float32", 3)
        jkw["bias"], tkw["bias"] = _pad(c_j[None], (1, np_)), c_t
        jkw["activation"] = tkw["activation"] = "silu"
    if epi == "gelu":
        jkw["activation"] = tkw["activation"] = "gelu"
    if epi != "f32out":                # otherwise both default to f32
        out = DTYPES[dtype]
        jkw["out_dtype"], tkw["out_dtype"] = out
    want = j_gemm_aie(_pad(a_j, (mp, kp)), _pad(b_j, (kp, np_)), tile=TILE,
                      interpret=True, **jkw)[:m, :n]
    before = gemm_aie_plain.launches
    got = gemm_aie(a_t, b_t, **tkw)
    assert gemm_aie_plain.launches == before + 1
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(5, 60, 160), (8, 96, 130)])
def test_gemm_gated_matches_jax_interpret(m, k, n, dtype):
    a_j, a_t = _pair((m, k), dtype, 0, k ** -0.5)
    g_j, g_t = _pair((k, n), dtype, 1)
    u_j, u_t = _pair((k, n), dtype, 2)
    mp, kp, np_ = _up(m, TILE.bm), _up(k, TILE.bk), _up(n, TILE.bn)
    want = j_gemm_gated(_pad(a_j, (mp, kp)), _pad(g_j, (kp, np_)),
                        _pad(u_j, (kp, np_)), tile=TILE,
                        interpret=True)[:m, :n]
    got = gemm_gated(a_t, g_t, u_t, activation="silu")
    assert got.dtype == a_t.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,dtype", [
    (1, 20, 20, 3, 1, 20, True, 0, "float32"),      # smoke shape, sq < 128
    (2, 70, 70, 6, 2, 64, True, 0, "float32"),      # GQA 3, ragged sq
    (1, 64, 96, 4, 2, 64, True, 16, "float32"),     # q_offset + window
    (1, 40, 40, 2, 2, 20, False, 0, "float32"),     # non-causal
    (1, 50, 50, 6, 2, 64, True, 0, "bfloat16"),
    # recurrentgemma-9b's local heads: 16 q on 1 kv head of 256, a window
    (1, 100, 100, 16, 1, 256, True, 64, "float32"),
    (1, 80, 80, 16, 1, 256, True, 32, "bfloat16"),
])
def test_flash_attention_matches_jax_interpret(b, sq, skv, hq, hkv, d,
                                               causal, window, dtype):
    q_j, q_t = _pair((b, sq, hq, d), dtype, 0)
    k_j, k_t = _pair((b, skv, hkv, d), dtype, 1)
    v_j, v_t = _pair((b, skv, hkv, d), dtype, 2)
    want = j_flash(q_j, k_j, v_j, causal=causal, window=window,
                   bq=128, bkv=128, interpret=True)
    before = flash_attention_plain.launches
    got = flash_attention(q_t, k_t, v_t, causal=causal, window=window)
    assert flash_attention_plain.launches == before + 1
    _close(got, want, dtype)


@pytest.mark.parametrize("b,S,hq,hkv,d,window,dtype", [
    (4, 200, 6, 2, 20, 0, "float32"),      # GQA 3, head_dim 20
    (3, 300, 15, 5, 64, 0, "float32"),     # smollm heads
    (2, 256, 6, 2, 64, 40, "float32"),     # window
    (3, 160, 15, 5, 64, 0, "bfloat16"),
    # recurrentgemma-9b's local heads (group 16, head_dim 256), a window
    (2, 300, 16, 1, 256, 100, "float32"),
    (2, 160, 16, 1, 256, 0, "bfloat16"),
])
def test_flash_decode_matches_jax_interpret(b, S, hq, hkv, d, window,
                                            dtype):
    q_j, q_t = _pair((b, hq, d), dtype, 0)
    k_j, k_t = _pair((b, S, hkv, d), dtype, 1)
    v_j, v_t = _pair((b, S, hkv, d), dtype, 2)
    pos = np.random.default_rng(3).integers(0, S, (b,)).astype(np.int32)
    want = j_decode(q_j, k_j, v_j, jnp.asarray(pos), window=window,
                    bkv=128, interpret=True)
    got = flash_decode(q_t, k_t, v_t, torch.as_tensor(pos), window=window)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_paged_at_head_256_matches_jax_interpret(dtype):
    """B5's plain version at recurrentgemma-9b's local heads (16 q heads
    on one kv head of 256) with a window, through a permuted pool of
    16-token pages, against the Pallas kernel in interpret mode."""
    b, hq, hkv, d, ps, max_pages = 2, 16, 1, 256, 16, 6
    n_pages = 1 + b * max_pages
    q_j, q_t = _pair((b, hq, d), dtype, 0)
    k_j, k_t = _pair((n_pages, ps, hkv, d), dtype, 1)
    v_j, v_t = _pair((n_pages, ps, hkv, d), dtype, 2)
    table = np.random.default_rng(3).permutation(np.arange(1, n_pages)) \
        .reshape(b, max_pages).astype(np.int32)
    pos = np.asarray([max_pages * ps - 3, 40], np.int32)
    want = j_paged(q_j, k_j, v_j, jnp.asarray(table), jnp.asarray(pos),
                   window=40, interpret=True)
    before = flash_decode_paged_plain.launches
    got = flash_decode_paged(q_t, k_t, v_t, torch.as_tensor(table),
                             torch.as_tensor(pos), window=40)
    assert flash_decode_paged_plain.launches == before + 1
    _close(got, want, dtype)


def test_decode_attention_xla_storage_dtype_path():
    """The port of ``_decode_attention_xla`` (bf16 probabilities before
    the PV product) against the JAX one, ragged positions."""
    q_j, q_t = _pair((3, 6, 32), "bfloat16", 0)
    k_j, k_t = _pair((3, 90, 2, 32), "bfloat16", 1)
    v_j, v_t = _pair((3, 90, 2, 32), "bfloat16", 2)
    pos = np.asarray([5, 60, 89], np.int32)
    want = _decode_attention_xla(q_j, k_j, v_j, jnp.asarray(pos), window=0)
    got = tref.decode_attention_xla(q_t, k_t, v_t, torch.as_tensor(pos))
    _close(got, want, "bfloat16")


def test_attention_and_decode_refs_match_jax():
    q_j, q_t = _pair((2, 24, 6, 16), "float32", 0)
    k_j, k_t = _pair((2, 24, 2, 16), "float32", 1)
    v_j, v_t = _pair((2, 24, 2, 16), "float32", 2)
    _close(tref.attention_ref(q_t, k_t, v_t, window=8),
           jref.attention_ref(q_j, k_j, v_j, window=8), "float32")
    _close(tref.decode_attention_ref(q_t[:, -1], k_t, v_t, 23),
           jref.decode_attention_ref(q_j[:, -1], k_j, v_j,
                                     jnp.asarray(23, jnp.int32)),
           "float32")


def test_epilogue_and_gemm_refs_match_jax():
    """bias -> act -> residual in f32, with the tanh gelu, and the int8
    x int8 -> int32 accumulation rule."""
    x_j, x_t = _pair((4, 8), "float32", 0, 3.0)
    c_j, c_t = _pair((8,), "float32", 1)
    r_j, r_t = _pair((4, 8), "float32", 2)
    from repro.kernels.epilogue import apply_epilogue as j_apply
    for act in ("silu", "gelu", "relu"):
        _close(apply_epilogue(x_t, activation=act, bias=c_t, residual=r_t),
               j_apply(x_j, activation=act, bias=c_j[None], residual=r_j),
               "float32")
    qa = np.random.default_rng(0).integers(-127, 128, (5, 7)).astype(np.int8)
    qb = np.random.default_rng(1).integers(-127, 128, (7, 3)).astype(np.int8)
    want = jref.gemm_ref(jnp.asarray(qa), jnp.asarray(qb))
    got = tref.gemm_ref(torch.as_tensor(qa), torch.as_tensor(qb))
    assert got.dtype == acc_dtype(torch.int8) == torch.int32
    np.testing.assert_array_equal(to_numpy({"x": got})["x"],
                                  np.asarray(want))


def test_wrappers_refuse_what_they_cannot_run():
    """Dispatch goes by device: operands on meta (a dry-run's trace) give
    a result of the kernel's shape and dtype and launch nothing, and a
    meta operand beside one on another device raises instead of falling
    back; a dequant scale over a float B raises instead of scaling
    silently."""
    a = torch.zeros((2, 4), device="meta")
    launches = gemm_aie.launches
    c = gemm_aie(a, torch.zeros((4, 3), device="meta"))
    assert (c.device.type, tuple(c.shape), c.dtype) == \
        ("meta", (2, 3), torch.float32)
    assert gemm_aie.launches == launches
    with pytest.raises(ValueError):
        gemm_aie(a, torch.zeros((4, 3)))
    with pytest.raises(TypeError):
        gemm_aie(torch.zeros((2, 4)), torch.zeros((4, 3)),
                 b_scale=torch.ones(3))
    o = flash_decode(torch.zeros((1, 3, 8), device="meta"),
                     torch.zeros((1, 4, 1, 8), device="meta"),
                     torch.zeros((1, 4, 1, 8), device="meta"), 0)
    assert (o.device.type, tuple(o.shape)) == ("meta", (1, 3, 8))
    with pytest.raises(ValueError):
        flash_decode(torch.zeros((1, 3, 8), device="meta"),
                     torch.zeros((1, 4, 1, 8)),
                     torch.zeros((1, 4, 1, 8)), 0)
