"""B4's and B5's bf16 split order, checked on the CPU before the card runs it.

``csrc/decode_split.cuh`` keeps continuous == solo greedy and paged ==
dense decode bit for bit because a row's bits depend only on its q, the
keys and values it sees, its ``pos`` and the window: the keys split into
64-key splits counted from key 0 (``decode_splits``), each split's
partial (m, l, acc) computed alone, the partials merged in ascending
split order, a split without a visible key merging as the identity.
:func:`emulate` is that arithmetic in plain PyTorch (f32 scores, l and
acc, bf16 P, every sum an elementwise chain, keys outside the slot's
range zero-filled and never read), with a key's row found through a
dense cache or a page table as the kernels find it, so nothing but the
split grid and the merge can make two calls differ.  It lives here
only; the port's CPU path is ``flash_decode_plain``.  On the card,
``tests/test_torch_cuda.py`` holds the kernels themselves to the same
invariance.

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_order.py
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as j_decode
from repro.kernels.flash_decode import flash_decode_paged as j_paged
from repro_torch.bridge import from_jax
from repro_torch.kernels.flash_attention import (DECODE_SPLIT, MAX_HEAD_DIM,
                                                 decode_grid,
                                                 decode_live_ctas,
                                                 decode_splits)

NEG_INF = -1e30


def _exp2(x):
    """exp2 whose f32 bits do not depend on where an element sits in the
    tensor: computed in f64, then rounded."""
    return torch.exp2(x.double()).float()


def dense_rows(k, v):
    """Key rows of a dense (b, S, hkv, d) cache: slot bi's keys kps."""
    return lambda bi, kvh, kps: (k[bi, kps, kvh], v[bi, kps, kvh])


def paged_rows(k_pages, v_pages, table):
    """Key rows through slot bi's table: key kp in page table[bi, kp //
    ps] at offset kp % ps."""
    ps = k_pages.shape[1]

    def rows(bi, kvh, kps):
        pages = table[bi, kps // ps].long()
        return k_pages[pages, kps % ps, kvh], v_pages[pages, kps % ps, kvh]
    return rows


def split_partials(splits, q, rows, hkv, scale_log2):
    """Each CTA's 64-key split, all at once (elementwise f32 operations
    round the same wherever an element sits): ``splits`` lists (slot, kv
    head, split, lo, hi); returns m, l (n, group) and acc (n, group, d)."""
    group, d = q.shape[1] // hkv, q.shape[2]
    n = len(splits)
    qb = torch.zeros((n, group, d))
    kb = torch.zeros((n, DECODE_SPLIT, d))
    vb = torch.zeros((n, DECODE_SPLIT, d))
    live = torch.zeros((n, DECODE_SPLIT), dtype=torch.bool)
    for i, (bi, kvh, sp, lo, hi) in enumerate(splits):
        keys = torch.arange(sp * DECODE_SPLIT, (sp + 1) * DECODE_SPLIT)
        live[i] = (keys >= lo) & (keys < hi)
        qb[i] = q[bi, kvh * group:(kvh + 1) * group].float()
        kr, vr = rows(bi, kvh, keys[live[i]])   # the rest zero-filled,
        kb[i, live[i]], vb[i, live[i]] = kr.float(), vr.float()  # never read
    s = torch.zeros((n, group, DECODE_SPLIT))
    for c in range(d):                          # one chain over d a score
        s = s + qb[:, :, c:c + 1] * kb[:, None, :, c]
    mask = live[:, None, :]
    s = torch.where(mask, s * scale_log2, torch.tensor(NEG_INF))
    m = s.max(dim=2).values
    p = torch.where(mask, _exp2(s - m[:, :, None]),
                    torch.zeros(())).to(torch.bfloat16).float()
    l = torch.zeros((n, group))
    acc = torch.zeros((n, group, d))
    for j in range(DECODE_SPLIT):               # chains over the keys
        l = l + p[:, :, j]
        acc = acc + p[:, :, j:j + 1] * vb[:, None, j]
    return m, l, acc


def merge(partials):
    """The ascending merge: an empty partial (m = NEG_INF) is the
    identity, the first one is taken as it is."""
    M = L = A = None
    for m, l, a in partials:
        if M is None:
            M, L, A = m.clone(), l.clone(), a.clone()
            continue
        empty, first = m == NEG_INF, M == NEG_INF
        mn = torch.maximum(M, m)
        alpha = torch.where(mn == M, torch.ones(()), _exp2(M - mn))
        beta = torch.where(mn == m, torch.ones(()), _exp2(m - mn))
        L2 = alpha * L + beta * l
        A2 = alpha[:, None] * A + beta[:, None] * a
        L = torch.where(empty, L, torch.where(first, l, L2))
        A = torch.where(empty[:, None], A,
                        torch.where(first[:, None], a, A2))
        M = torch.where(empty, M, torch.where(first, m, mn))
    return M, L, A


def emulate(q, rows, pos, hkv, length, *, window=0, empty_at=()):
    """The bf16 body in plain PyTorch: q (b, hq, d) bf16, key rows from
    ``rows`` (:func:`dense_rows` or :func:`paged_rows`) over ``length``
    keys.  ``empty_at``: merge an empty partial before each of these
    positions in a row's list (and at its end).  Returns (b, hq, d) in
    f32, before the kernel's rounding to bf16."""
    b, hq, d = q.shape
    group = hq // hkv
    scale_log2 = torch.tensor(d ** -0.5 * math.log2(math.e),
                              dtype=torch.float32)
    splits = []
    for bi in range(b):
        p = int(pos[bi])
        hi = min(length, p + 1)
        lo = max(0, p - window + 1) if window > 0 else 0
        splits += [(bi, kvh, sp, lo, hi) for kvh in range(hkv)
                   for sp in decode_splits(p, length, window)]
    m, l, acc = split_partials(splits, q, rows, hkv, scale_log2)
    empty = (torch.full((group,), NEG_INF), torch.zeros(group),
             torch.zeros((group, d)))
    out = torch.zeros((b, hq, d))
    for bi in range(b):
        for kvh in range(hkv):
            parts = [(m[i], l[i], acc[i]) for i, sp in enumerate(splits)
                     if sp[:2] == (bi, kvh)]
            for i in sorted(empty_at, reverse=True):
                parts.insert(min(i, len(parts)), empty)
            if not parts:
                continue                        # no visible key: zeros
            _, L, A = merge(parts)
            out[bi, kvh * group:(kvh + 1) * group] = \
                A / torch.where(L > 0, L, torch.ones(()))[:, None]
    return out


def _bf16(shape, seed):
    """bf16 values as a JAX array and a CPU torch tensor of one value."""
    x = np.random.default_rng(seed).standard_normal(shape)
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    return jx, from_jax({"x": np.asarray(jx)})["x"]


def _pool(k, v, ps, max_pages, seed):
    """Dense (b, S, hkv, d) caches scattered into a pool over a random
    permutation of pages 1.. (page 0, the sink, and each row's pages past
    S hold noise); the (b, max_pages) int32 table."""
    b, S, hkv, d = k.shape
    n_pages = 1 + b * max_pages
    rng = np.random.default_rng(seed)
    table = torch.as_tensor((rng.permutation(n_pages - 1) + 1)
                            .reshape(b, max_pages).astype(np.int32))
    noise = torch.as_tensor(rng.standard_normal(
        (2, n_pages, ps, hkv, d)).astype(np.float32)).to(k.dtype)
    k_pages, v_pages = noise[0].clone(), noise[1].clone()
    dense = table[:, :S // ps].long()
    k_pages[dense] = k.reshape(b, S // ps, ps, hkv, d)
    v_pages[dense] = v.reshape(b, S // ps, ps, hkv, d)
    return k_pages, v_pages, table


#: (hq, hkv, d): smollm-360m's heads, qwen3-moe's group of 16 at d 128,
#: the smoke config's d 20
HEADS = [(15, 5, 64), (64, 4, 128), (3, 1, 20)]
#: slot positions on both sides of the 64-key splits
POS = [0, 63, 64, 127, 128, 200, 255]


@pytest.mark.parametrize("hq,hkv,d", HEADS)
@pytest.mark.parametrize("window", [0, 100])
def test_row_bits_do_not_depend_on_the_batch(hq, hkv, d, window):
    """Each slot computed alone equals its row of the 7-slot call, bit
    for bit; window 100 starts mid-split."""
    S = 256
    _, q = _bf16((len(POS), hq, d), 0)
    _, k = _bf16((len(POS), S, hkv, d), 1)
    _, v = _bf16((len(POS), S, hkv, d), 2)
    full = emulate(q, dense_rows(k, v), POS, hkv, S, window=window)
    for i in (0, 2, 3, 5, 6):
        one = slice(i, i + 1)
        alone = emulate(q[one], dense_rows(k[one], v[one]), POS[one], hkv, S,
                        window=window)
        assert torch.equal(alone, full[one]), i


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_of_another_length_equals_dense_bitwise(ps, window):
    """One logical cache, dense (256 keys) and in a permuted pool whose
    table spans 384 keys: every slot with pos < 256 gets the dense bits
    at page sizes 8, 16 and 64."""
    hq, hkv, d, S, pool_len = 15, 5, 64, 256, 384
    _, q = _bf16((len(POS), hq, d), 3)
    _, k = _bf16((len(POS), S, hkv, d), 4)
    _, v = _bf16((len(POS), S, hkv, d), 5)
    k_pages, v_pages, table = _pool(k, v, ps, pool_len // ps, 6)
    dense = emulate(q, dense_rows(k, v), POS, hkv, S, window=window)
    paged = emulate(q, paged_rows(k_pages, v_pages, table), POS, hkv,
                    pool_len, window=window)
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("hq,hkv,d", HEADS[:2])
def test_keys_outside_the_window_are_never_read(hq, hkv, d):
    """Under a window whose start falls mid-split (pos 200, window 100:
    keys 101..200), NaN in every key and value outside it changes no
    bit."""
    S, window = 256, 100
    pos = [200]
    _, q = _bf16((1, hq, d), 7)
    _, k = _bf16((1, S, hkv, d), 8)
    _, v = _bf16((1, S, hkv, d), 9)
    lo, hi = pos[0] - window + 1, pos[0] + 1
    assert lo % DECODE_SPLIT
    want = emulate(q, dense_rows(k, v), pos, hkv, S, window=window)
    k2, v2 = k.clone(), v.clone()
    for t in (k2, v2):
        t[:, :lo] = float("nan")
        t[:, hi:] = float("nan")
    got = emulate(q, dense_rows(k2, v2), pos, hkv, S, window=window)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hq,hkv,d", HEADS[:2])
def test_an_empty_split_merges_as_the_identity(hq, hkv, d):
    """Empty partials (m = NEG_INF, l = 0, acc = 0) merged first, between
    splits and last give the bits of the merge that skips them: a
    skipped split and a merged empty one are the same."""
    S = 256
    _, q = _bf16((len(POS), hq, d), 10)
    _, k = _bf16((len(POS), S, hkv, d), 11)
    _, v = _bf16((len(POS), S, hkv, d), 12)
    rows = dense_rows(k, v)
    want = emulate(q, rows, POS, hkv, S, window=100)
    got = emulate(q, rows, POS, hkv, S, window=100, empty_at=(0, 1, 3, 99))
    assert torch.equal(got, want)


@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 64), (16, 1, 128), (3, 1, 20)])
@pytest.mark.parametrize("window", [0, 32])
def test_emulation_matches_jax_interpret(hq, hkv, d, window):
    """The split order and bf16 P stay within the bf16 tolerance (2e-2)
    of the Pallas kernels in interpret mode: flash_decode at bkv 128 and
    flash_decode_paged at page size 16, as tests/test_flash_decode.py
    runs them."""
    S, pos = 256, [3, 130, 0, 255]
    qj, q = _bf16((4, hq, d), 13)
    kj, k = _bf16((4, S, hkv, d), 14)
    vj, v = _bf16((4, S, hkv, d), 15)
    got = emulate(q, dense_rows(k, v), pos, hkv, S, window=window) \
        .to(torch.bfloat16).float().numpy()
    pj = jnp.asarray(pos, jnp.int32)
    want = j_decode(qj, kj, vj, pj, window=window, bkv=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    k_pages, v_pages, table = _pool(k, v, 16, S // 16, 16)
    paged = emulate(q, paged_rows(k_pages, v_pages, table), pos, hkv, S,
                    window=window).to(torch.bfloat16).float().numpy()
    assert np.array_equal(paged, got)
    want = j_paged(qj, jnp.asarray(k_pages.float().numpy(), jnp.bfloat16),
                   jnp.asarray(v_pages.float().numpy(), jnp.bfloat16),
                   jnp.asarray(table.numpy()), pj, window=window,
                   interpret=True)
    np.testing.assert_allclose(paged, np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("length", [50, 64, 256, 1024, 1280])
@pytest.mark.parametrize("window", [0, 1, 64, 100, 300])
def test_decode_splits_cover_each_visible_key_once(length, window):
    """The splits a row merges hold every key of [lo, hi) exactly once,
    each holds at least one, they ascend, and they are the same for any
    length past pos + 1 (the function takes no b at all)."""
    for pos in list(range(0, 300, 7)) + [length - 1, length + 40, 2000]:
        hi = min(length, pos + 1)
        lo = max(0, pos - window + 1) if window > 0 else 0
        splits = list(decode_splits(pos, length, window))
        assert splits == sorted(set(splits))
        seen = [kp for sp in splits
                for kp in range(sp * DECODE_SPLIT, (sp + 1) * DECODE_SPLIT)
                if lo <= kp < hi]
        assert seen == list(range(lo, hi)) if hi > lo else not splits
        assert all(max(lo, sp * DECODE_SPLIT)
                   < min(hi, (sp + 1) * DECODE_SPLIT) for sp in splits)
        if pos + 1 <= length:
            assert decode_splits(pos, 4096, window) == \
                decode_splits(pos, length, window)


@pytest.mark.parametrize("b,hq,hkv,length,d", [
    (8, 15, 5, 1024, 64),      # smollm-360m step, dense or 64 pages of 16
    (8, 64, 4, 1024, 128),     # qwen3-moe step
    (8, 64, 4, 1280, 128),     # a longer table
    (3, 3, 1, 50, 20),         # the smoke config
    (8, 16, 1, 2048, 256),     # recurrentgemma-9b's ring (8 merge CTAs)
])
def test_decode_grid_sizes_the_split_axis_from_the_length(b, hq, hkv,
                                                          length, d):
    """The grid covers the length with 64-key splits (one warp a CTA),
    merge CTAs of 128 threads with four columns of one row each, and
    scratch for every split's partial; the CTAs with work at the kernel
    phase's positions are the ones the splits name."""
    grid = decode_grid(b, hq, hkv, length, d)
    group = hq // hkv
    assert DECODE_SPLIT == 64
    assert grid.splits * 64 >= length > (grid.splits - 1) * 64
    assert grid.ctas == grid.splits * hkv * b
    per_head = -(-group * -(-d // 4) // 128)     # 1 at smollm, 4 at qwen3
    assert grid.merge_ctas == per_head * hkv * b
    assert grid.acc_floats == b * hkv * grid.splits * group * grid.head_dim
    assert grid.ml_floats == 2 * b * hkv * grid.splits * group
    assert d <= grid.head_dim <= MAX_HEAD_DIM and grid.head_dim % 32 == 0
    pos = [17, 40, 95, 160, 210, 300, 333, 363][:b]
    live = decode_live_ctas(pos, length, 0, hkv)
    assert 0 < live <= grid.ctas
    assert live == hkv * sum(-(-(min(p, length - 1) + 1) // DECODE_SPLIT)
                             for p in pos)
    f32 = decode_grid(b, hq, hkv, length, d, torch.float32)
    assert f32.body == "fmaf" and f32.ctas == hkv * b and not f32.acc_floats
