"""B3's bf16 block order, checked on the CPU before the card runs it.

``csrc/flash_attention.cu`` keeps chunked == unchunked == solo prefill
bit for bit because a row's bits depend only on its absolute position,
the keys and a fixed key-block grid: blocks of ``KEY_BLOCK`` keys from
key 0, visited in ascending order, a window's start rounded down onto
the grid, and a block wholly masked for a row leaving its state
unchanged.  :func:`emulate` is that arithmetic in plain PyTorch — bf16
P, f32 scores, O and l, the CTA's row tiles and key range as the kernel
computes them — with every sum an elementwise chain, so nothing but the
block order can make two calls differ.  It lives here only; the port's
CPU path is ``flash_attention_plain``.  On the card,
``tests/test_torch_cuda.py`` holds the kernel itself to the same
invariance.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_order.py
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.bridge import from_jax
from repro_torch.core.hardware import HOPPER_H100
from repro_torch.kernels.flash_attention import (KEY_BLOCK, MAX_HEAD_DIM,
                                                 cta_shape)

NEG_INF = -1e30


def _exp2(x):
    """exp2 whose f32 bits do not depend on where an element sits in the
    tensor (torch's vectorized and scalar f32 exp2 may differ in the last
    bit): computed in f64, then rounded."""
    return torch.exp2(x.double()).float()


def emulate(q, k, v, *, causal=True, window=0, q_offset=None, rows=None):
    """B3's bf16 body in plain PyTorch: q (b, sq, hq, d), k/v (b, skv,
    hkv, d) in bf16; ``rows`` a CTA (default: what ``cta_shape`` picks).
    Returns (b, sq, hq, d) in f32, before the kernel's rounding to bf16
    (which would hide most differences of the f32 sums)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if q_offset is None:
        q_offset = skv - sq
    rows = rows or cta_shape(b, sq, hq, hkv, d).rows
    scale_log2 = torch.tensor(d ** -0.5 * math.log2(math.e),
                              dtype=torch.float32)
    out = torch.zeros((b, sq, hq, d), dtype=torch.float32)
    for bi in range(b):
        for kvh in range(hkv):
            # position-major rows of the group: f = pos * group + g
            qg = q[bi, :, kvh * group:(kvh + 1) * group].float() \
                .reshape(sq * group, d)
            kk, vv = k[bi, :, kvh].float(), v[bi, :, kvh].float()
            og = torch.zeros_like(qg)
            for f0 in range(0, sq * group, rows):
                f1 = min(f0 + rows, sq * group)
                qpos = q_offset + torch.arange(f0, f1) // group
                lo, hi = int(qpos[0]), int(qpos[-1])
                kv_end = min(skv, hi + 1) if causal else skv
                kv_begin = max(0, lo - window + 1) // KEY_BLOCK \
                    * KEY_BLOCK if window > 0 else 0
                og[f0:f1] = _tile(qg[f0:f1], kk, vv, qpos, kv_begin, kv_end,
                                  causal, window, scale_log2)
            out[bi, :, kvh * group:(kvh + 1) * group] = \
                og.reshape(sq, group, d)
    return out


def _tile(qt, kk, vv, qpos, kv_begin, kv_end, causal, window, scale_log2):
    """One CTA's rows over the key blocks [kv_begin, kv_end)."""
    n, d = qt.shape
    skv = kk.shape[0]
    m = torch.full((n,), NEG_INF)
    l = torch.zeros(n)
    acc = torch.zeros((n, d))
    for kv0 in range(kv_begin, kv_end, KEY_BLOCK):
        keys = torch.arange(kv0, kv0 + KEY_BLOCK)
        kb = torch.zeros((KEY_BLOCK, d))
        vb = torch.zeros((KEY_BLOCK, d))
        live_keys = min(KEY_BLOCK, skv - kv0)
        kb[:live_keys], vb[:live_keys] = kk[kv0:kv0 + live_keys], \
            vv[kv0:kv0 + live_keys]
        s = torch.zeros((n, KEY_BLOCK))
        for c in range(d):                      # one chain over d a score
            s = s + qt[:, c:c + 1] * kb[None, :, c]
        live = (keys < skv)[None, :].expand(n, -1)
        if causal:
            live = live & (keys[None, :] <= qpos[:, None])
        if window > 0:
            live = live & (keys[None, :] > qpos[:, None] - window)
        s = torch.where(live, s * scale_log2, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.max(dim=1).values)
        alpha = torch.where(m_new == m, torch.ones(()),
                            _exp2(m - m_new))
        p = torch.where(live, _exp2(s - m_new[:, None]),
                        torch.zeros(())).to(torch.bfloat16).float()
        ps = torch.zeros(n)
        for j in range(KEY_BLOCK):              # one chain over the keys
            ps = ps + p[:, j]
        l = alpha * l + ps
        m = m_new
        acc = acc * alpha[:, None]
        for j in range(KEY_BLOCK):
            acc = acc + p[:, j:j + 1] * vb[None, j]
    return acc / torch.where(l > 0, l, torch.ones(()))[:, None]


def _inputs(b, s, hq, hkv, d, seed):
    """bf16 q, k, v as JAX arrays and CPU torch tensors of one value."""
    out = []
    for i, h in enumerate((hq, hkv, hkv)):
        x = np.random.default_rng(seed + i).standard_normal((b, s, h, d))
        jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
        out.append((jx, from_jax({"x": np.asarray(jx)})["x"]))
    return out


#: (b, s, hq, hkv, d, window): the smoke model's head_dim 20, smollm-360m's
#: d 64 / group 3, h2o-danube's d 120 with window 32, qwen3-moe's d 128 /
#: group 16
CASES = [(1, 90, 3, 1, 20, 0), (1, 80, 6, 2, 64, 0), (1, 100, 4, 2, 120, 32),
         (1, 40, 16, 1, 128, 0)]


@pytest.mark.parametrize("b,s,hq,hkv,d,window", CASES)
def test_chunked_equals_unchunked_bitwise(b, s, hq, hkv, d, window):
    """A prompt's rows computed in chunks of 7, 16 and 64 (q_offset =
    start, against the key prefix), at 16-, 32- and 64-row CTAs, equal
    the whole prompt's at 64- and 16-row CTAs, bit for bit; so do one
    q head's rows computed alone against its kv head.  Compared in f32,
    before the output's rounding to bf16."""
    (_, q), (_, k), (_, v) = _inputs(b, s, hq, hkv, d, 0)
    full = emulate(q, k, v, window=window, rows=64)
    assert torch.equal(emulate(q, k, v, window=window, rows=16), full)
    for chunk, rows in ((7, 16), (16, 32), (64, 64)):
        parts = [emulate(q[:, a:a + chunk], k[:, :a + chunk],
                         v[:, :a + chunk], window=window, q_offset=a,
                         rows=rows) for a in range(0, s, chunk)]
        assert torch.equal(torch.cat(parts, dim=1), full), (chunk, rows)
    group = hq // hkv
    for h in (0, hq - 1):
        kvh = h // group
        solo = emulate(q[:, :, h:h + 1], k[:, :, kvh:kvh + 1],
                       v[:, :, kvh:kvh + 1], window=window)
        assert torch.equal(solo[:, :, 0], full[:, :, h]), h


@pytest.mark.parametrize("b,s,hq,hkv,d,window", CASES)
def test_emulation_matches_jax_interpret(b, s, hq, hkv, d, window):
    """The block order and bf16 P stay within the bf16 tolerance (2e-2)
    of the Pallas kernel in interpret mode, causal from key 0 and with a
    q_offset against a longer key prefix."""
    (qj, q), (kj, k), (vj, v) = _inputs(b, s, hq, hkv, d, 1)
    for sq in (s, s // 3):
        got = emulate(q[:, -sq:], k, v, window=window).to(torch.bfloat16)
        want = j_flash(qj[:, -sq:], kj, vj, causal=True, window=window,
                       bq=128, bkv=128, interpret=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)


def cta_rows(shape, x, b, sq, hq, hkv):
    """The (batch row, q position, q head) rows CTA ``x`` of a bf16
    launch computes, as ``csrc/flash_attention.cu`` maps them from the
    shape ``cta_shape`` gives."""
    group = hq // hkv
    per_tile = hkv * b
    tile = shape.tiles - 1 - x // per_tile
    kvh, bi = x % per_tile % hkv, x % per_tile // hkv
    f0 = tile * shape.rows
    return [(bi, f // group, kvh * group + f % group)
            for f in range(f0, min(f0 + shape.rows, sq * group))]


@pytest.mark.parametrize("b,sq,hq,hkv,d", [
    (1, 300, 15, 5, 64),       # smollm-360m 300-token prefill
    (1, 300, 64, 4, 128),      # qwen3-moe 300-token prefill
    (1, 12, 15, 5, 64),        # a short prompt
    (2, 45, 3, 1, 20),         # the smoke config, two batch rows
    (1, 100, 4, 2, 120),       # h2o-danube's head_dim
])
def test_cta_shape_covers_every_row_once(b, sq, hq, hkv, d):
    shape = cta_shape(b, sq, hq, hkv, d)
    seen = {}
    for x in range(shape.ctas):
        rows = cta_rows(shape, x, b, sq, hq, hkv)
        assert 0 < len(rows) <= shape.rows
        for r in rows:
            seen[r] = seen.get(r, 0) + 1
    assert seen == {(bi, p, h): 1 for bi in range(b) for p in range(sq)
                    for h in range(hq)}
    # tiles run heaviest first: CTA 0 holds the last rows
    assert cta_rows(shape, 0, b, sq, hq, hkv)[-1][1] == sq - 1


@pytest.mark.parametrize("hq,hkv,d", [(15, 5, 64), (64, 4, 128)])
def test_cta_shape_fills_the_card_at_a_300_token_prefill(hq, hkv, d):
    """What smollm-360m's (4500 rows) and qwen3-moe's (19200 rows)
    300-token prefills put on the card: 64-row CTAs of four warps, 75 and
    300 of them.  smollm-360m's 75 leave SMs idle, yet on an H100 they
    beat the 16- and 32-row CTAs that would reach 7 of every 8 SMs, at
    every served prompt and chunk length (PERF.md §6)."""
    shape = cta_shape(1, 300, hq, hkv, d)
    assert shape.rows == 64 and shape.body == "tensor cores"
    assert shape.ctas == -(-300 * (hq // hkv) // 64) * hkv
    assert shape.ctas == {5: 75, 4: 300}[hkv]
    assert (shape.ctas >= HOPPER_H100.sm_count) == (hkv == 4)


@pytest.mark.parametrize("d,head_dim", [(20, 32), (64, 64), (112, 128),
                                        (120, 128), (128, 128), (200, 256),
                                        (256, 256)])
def test_cta_shape_pads_the_head_and_fits_shared_memory(d, head_dim):
    shape = cta_shape(1, 300, 64, 4, d)
    assert shape.head_dim == head_dim >= d
    # two stages of K and V blocks, bf16: 64 KB at d = 128; at 256 a CTA
    # of 32 rows (two warps a 16-row group) and their q tile, 144 KB
    q_tile = 32 if head_dim == 256 else 0
    assert shape.rows == (32 if head_dim == 256 else 64)
    assert shape.smem_bytes == (2 * 2 * KEY_BLOCK + q_tile) * head_dim * 2
    assert shape.smem_bytes <= 232448          # 227 KB a CTA on an H100
    f32 = cta_shape(1, 300, 64, 4, d, torch.float32)
    assert f32.body == "fmaf" and f32.rows == 16
    # the f32 tiles: within the 48 KB a CTA gets without the opt-in up to
    # d = 128, 82 KB (dynamic, opted in) at 256
    assert f32.smem_bytes <= (48 if d <= 128 else 227) * 1024
    assert MAX_HEAD_DIM == 256
