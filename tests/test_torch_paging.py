"""The port's paged-KV host bookkeeping and its paged decode kernel
module against the JAX package, on the CPU.

* ``repro_torch.serve.paging`` is a copy of ``repro.serve.paging``:
  seeded sequences of admit / register / release / reclaim give the
  same tables, refcounts and plans in both, and the allocator and
  prefix-cache invariants hold in the port's copy.
* ``flash_decode_paged`` on CPU tensors (its plain version) against the
  Pallas kernel in interpret mode.  Tolerances: f32 ``atol=rtol=1e-5``;
  bf16 compared in f32 at ``atol=rtol=2e-2`` (a few bf16 ulps after
  differently ordered f32 sums).  Against the dense plain version it is
  bit-exact when the gathered length equals the dense length.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode_paged as j_paged
from repro.serve import paging as jpaging
from repro_torch.bridge import from_jax
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_paged,
                                              flash_decode_paged_plain)
from repro_torch.serve import paging
from repro_torch.serve.paging import (SINK_PAGE, AdmitPlan, PagedKV,
                                      PagePool, PrefixCache)

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


# ---------------------------------------------------------------------------
# The copy against the JAX package's paging module
# ---------------------------------------------------------------------------

def _state(kv):
    pool = kv.pool
    return (kv.tables, [pool.refcount(p) for p in range(pool.n_pages)],
            pool.n_free, None if kv.prefix is None else
            (len(kv.prefix), kv.prefix.hits, kv.prefix.misses))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("page_size,prefix_cache", [(4, True), (8, True),
                                                     (4, False)])
def test_paging_copy_matches_jax(seed, page_size, prefix_cache):
    """A seeded mix of admissions (prompts drawn from a few shared
    prefixes, so the prefix cache hits and copies on write), prefix
    registrations, releases and reclaims, applied to both copies: the
    same AdmitPlans, tables, refcounts and counters after every op."""
    rng = np.random.default_rng(seed)
    n_slots, n_pages, max_pages = 4, 14, 6
    mine = PagedKV(n_slots, n_pages, page_size, max_pages,
                   prefix_cache=prefix_cache)
    ref = jpaging.PagedKV(n_slots, n_pages, page_size, max_pages,
                          prefix_cache=prefix_cache)
    stems = [rng.integers(0, 50, (rng.integers(1, 3 * page_size),))
             .astype(np.int32) for _ in range(3)]
    live, seen, cows = {}, [], 0                # slot -> prompt
    for _ in range(60):
        free = [s for s in range(n_slots) if s not in live]
        op = rng.choice(["admit", "release"] if live and free else
                        ["admit"] if free else ["release"])
        if op == "admit":
            slot = int(rng.choice(free))
            if seen and rng.random() < 0.3:      # identical re-prompt
                prompt = seen[rng.integers(0, len(seen))]
            else:
                tail = rng.integers(0, 50, (rng.integers(0, page_size + 2),))
                prompt = np.concatenate(
                    [stems[rng.integers(0, 3)], tail]).astype(np.int32)
            need = min(len(prompt) + int(rng.integers(0, 6)),
                       max_pages * page_size)
            prompt = prompt[:need]
            seen.append(prompt)
            assert mine.pages_needed(prompt, need) == \
                ref.pages_needed(prompt, need)
            fits = mine.try_reclaim(prompt, need)
            assert fits == ref.try_reclaim(prompt, need)
            if fits:
                got = mine.admit(slot, prompt, need)
                want = ref.admit(slot, prompt, need)
                assert isinstance(got, AdmitPlan)
                assert got.__dict__ == want.__dict__
                cows += len(got.cow_src)
                if rng.random() < 0.8:
                    assert mine.register_prefix(slot, prompt) == \
                        ref.register_prefix(slot, prompt)
                live[slot] = prompt
        else:
            slot = int(rng.choice(sorted(live)))
            mine.release(slot)
            ref.release(slot)
            del live[slot]
        assert _state(mine) == _state(ref)
        np.testing.assert_array_equal(mine.masked_tables(sorted(live)),
                                      ref.masked_tables(sorted(live)))
    if prefix_cache:
        assert mine.prefix.hits > 0 and cows > 0
        assert mine.prefix.drop_all(mine.pool) == \
            ref.prefix.drop_all(ref.pool)
        assert _state(mine) == _state(ref)


def test_paging_copy_has_the_same_code():
    """The copy is the JAX module's code, statement for statement; only
    the module docstring differs."""
    def body(mod):
        tree = ast.parse(pathlib.Path(mod.__file__).read_text())
        return [ast.dump(node) for node in tree.body[1:]]
    assert body(paging) == body(jpaging)


# ---------------------------------------------------------------------------
# Allocator and prefix-cache invariants (the port's copy)
# ---------------------------------------------------------------------------

def test_page_pool_basics():
    pool = PagePool(5)                       # pages 1..4 allocatable
    assert pool.n_free == 4 and pool.n_used == 0
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (1, 2)                  # deterministic lowest-first
    pool.free(a)
    assert pool.alloc() == 1                 # freed pages return
    pool.ref(b)                              # second holder
    pool.free(b)
    assert pool.refcount(b) == 1 and pool.n_free == 2
    pool.free(b)
    assert pool.refcount(b) == 0 and pool.n_free == 3


@pytest.mark.parametrize("bad", ["free_sink", "ref_unallocated",
                                 "exhausted", "too_small"])
def test_page_pool_guards(bad):
    pool = PagePool(3)
    if bad == "free_sink":
        with pytest.raises(ValueError):
            pool.free(SINK_PAGE)             # sink is never allocatable
    elif bad == "ref_unallocated":
        with pytest.raises(ValueError):
            pool.ref(1)
    elif bad == "exhausted":
        pool.alloc(), pool.alloc()
        with pytest.raises(RuntimeError):
            pool.alloc()
    else:
        with pytest.raises(ValueError):
            PagePool(1)                      # needs room beyond the sink


def test_page_pool_properties():
    """Under any interleaving of alloc / ref / free no page is handed
    out twice while live, freed pages return, a referenced page stays
    allocated, and pages are conserved."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(n_pages=st.integers(2, 12), n_ops=st.integers(0, 80),
           data=st.data())
    @settings(max_examples=60, deadline=None)
    def check(n_pages, n_ops, data):
        pool = PagePool(n_pages)
        live = {}
        for _ in range(n_ops):
            acts = (["alloc"] if pool.n_free else []) \
                + (["ref", "free"] if live else [])
            if not acts:
                break
            act = data.draw(st.sampled_from(acts))
            if act == "alloc":
                page = pool.alloc()
                assert page not in live and page != SINK_PAGE
                live[page] = 1
            elif act == "ref":
                page = data.draw(st.sampled_from(sorted(live)))
                pool.ref(page)
                live[page] += 1
            else:
                page = data.draw(st.sampled_from(sorted(live)))
                pool.free(page)
                live[page] -= 1
                if live[page] == 0:
                    del live[page]
            assert all(pool.refcount(p) == c for p, c in live.items())
            assert pool.n_free + len(live) == n_pages - 1
        for page in list(live):
            for _ in range(live.pop(page)):
                pool.free(page)
        assert pool.n_free == n_pages - 1

    check()


def test_prefix_cache_match_register_evict():
    pool = PagePool(8)
    cache = PrefixCache(page_size=4)
    toks = np.arange(10, dtype=np.int32)     # 2 full pages + tail of 2
    pages = [pool.alloc() for _ in range(3)]
    assert cache.register(toks, pages, pool) == 3
    assert all(pool.refcount(p) == 2 for p in pages)
    assert cache.register(toks, pages, pool) == 0   # idempotent
    assert cache.match(toks) == (pages, 10)  # partial tail matches too
    assert cache.match(toks[:7]) == (pages[:1], 4)
    assert cache.match(np.arange(100, 104, dtype=np.int32))[1] == 0
    for p in pages:                          # slot release
        pool.free(p)
    assert all(pool.refcount(p) == 1 for p in pages)
    pool.ref(pages[0])                       # a slot still maps page 0
    assert cache.evict(pool, 99) == 2 and pool.refcount(pages[0]) == 2
    assert cache.match(toks, peek=True)[1] == 4   # chain head survives


@pytest.mark.parametrize("extend_first", [False, True])
def test_prefix_cache_evicts_deepest_first(extend_first):
    """One register / match walk stamps its whole chain with one clock,
    so eviction drops the deepest link first and never orphans deeper
    links behind an evicted head — also when a chain was registered in
    two steps with another chain touched in between."""
    pool = PagePool(8)
    cache = PrefixCache(page_size=4)
    toks = np.arange(12, dtype=np.int32)     # 3 full pages
    pages = [pool.alloc() for _ in range(3)]
    other = np.arange(100, 104, dtype=np.int32)
    if extend_first:
        cache.register(toks[:4], pages[:1], pool)
        cache.register(other, [pool.alloc()], pool)
    cache.register(toks, pages, pool)
    for p in pages:
        pool.free(p)
    if extend_first:
        assert cache.evict(pool, 2) == 2
        assert cache.match(toks, peek=True)[1] == 4
        assert cache.match(other, peek=True)[1] == 4
        return
    assert cache.evict(pool, 1) == 1
    assert cache.match(toks, peek=True) == (pages[:2], 8)
    assert pool.refcount(pages[2]) == 0
    cache.match(toks[:4])                    # touch the head alone
    assert cache.evict(pool, 1) == 1
    assert cache.match(toks[:4], peek=True)[1] == 4
    assert pool.refcount(pages[1]) == 0


@pytest.mark.parametrize("plen,need,shared,n_pages", [
    (8, 12, 7, 3),     # page 0 shared in place, page 1 copied on write
    (6, 8, 5, 2),      # tail page mid-way: copied on write
])
def test_paged_kv_admit_shares_and_copies_on_write(plen, need, shared,
                                                   n_pages):
    """An identical re-prompt shares every full page before position
    plen - 1 in place and copies the page that position lands in."""
    kv = PagedKV(n_slots=2, n_pages=9, page_size=4, max_pages=4)
    toks = np.arange(plen, dtype=np.int32)
    assert kv.admit(0, toks, need) == AdmitPlan(0, (), (), n_pages, False)
    kv.register_prefix(0, toks)
    n_full = shared // 4
    assert kv.pages_needed(toks, need) == n_pages - n_full
    plan = kv.admit(1, toks, need)
    assert plan.shared_tokens == shared and plan.prefix_hit
    assert plan.cow_src == (kv.tables[0][n_full],)
    assert plan.cow_dst == (kv.tables[1][n_full],)
    assert kv.tables[1][:n_full] == kv.tables[0][:n_full]
    assert kv.pool.refcount(kv.tables[0][n_full]) == 2   # slot 0 + cache
    kv.release(0)
    kv.release(1)
    assert kv.pool.n_used == -(-plen // 4)   # the cache pins the prompt


def test_paged_kv_table_rows_and_reclaim():
    kv = PagedKV(n_slots=2, n_pages=4, page_size=4, max_pages=3)
    toks = np.arange(5, dtype=np.int32)
    kv.admit(0, toks, need_tokens=5)
    row = kv.table_row(0)
    assert row.shape == (3,) and row.dtype == np.int32
    assert list(row) == kv.tables[0] + [SINK_PAGE]
    assert (kv.masked_tables([]) == SINK_PAGE).all()
    kv.register_prefix(0, toks)
    kv.release(0)
    other = np.arange(50, 58, dtype=np.int32)
    assert not kv.can_admit(other, 8)        # cache pins both pages
    assert kv.try_reclaim(other, 8)          # eviction frees them
    plan = kv.admit(1, other, 8)
    assert plan.n_pages == 2 and not plan.prefix_hit


# ---------------------------------------------------------------------------
# flash_decode_paged: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _pair(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape)
    jx = jnp.asarray(x, jnp.float32).astype(DTYPES[dtype])
    return jx, from_jax({"x": np.asarray(jx)})["x"]


def _tables(b, max_pages, n_pages, seed, sink_row=None):
    """Per-row tables over a random permutation of the pool's pages 1..;
    ``sink_row`` gets an all-sink table."""
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    table = perm[:b * max_pages].reshape(b, max_pages).astype(np.int32)
    if sink_row is not None:
        table[sink_row] = SINK_PAGE
    return table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps,window", [(8, 0), (16, 0), (8, 24), (16, 40)])
def test_flash_decode_paged_matches_jax_interpret(ps, window, dtype):
    b, hq, hkv, d, max_pages = 3, 6, 2, 20, 6
    n_pages = 1 + b * max_pages + 2
    q_j, q_t = _pair((b, hq, d), dtype, 0)
    k_j, k_t = _pair((n_pages, ps, hkv, d), dtype, 1)
    v_j, v_t = _pair((n_pages, ps, hkv, d), dtype, 2)
    table = _tables(b, max_pages, n_pages, 3, sink_row=1)
    pos = np.asarray([max_pages * ps - 5, 37, ps + 2], np.int32)
    want = j_paged(q_j, k_j, v_j, jnp.asarray(table), jnp.asarray(pos),
                   window=window, interpret=True)
    before = flash_decode_paged_plain.launches
    got = flash_decode_paged(q_t, k_t, v_t, torch.as_tensor(table),
                             torch.as_tensor(pos), window=window)
    assert flash_decode_paged_plain.launches == before + 1
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_plain_equals_dense_plain_bitwise(ps, dtype):
    """One logical cache, dense and scattered into a permuted pool: the
    paged plain version gives the dense one's bits when max_pages *
    page_size equals the dense length."""
    b, S, hq, hkv, d = 4, 96, 15, 5, 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn((b, hq, d), generator=g).to(dtype)
    k = torch.randn((b, S, hkv, d), generator=g).to(dtype)
    v = torch.randn((b, S, hkv, d), generator=g).to(dtype)
    max_pages = S // ps
    n_pages = 1 + b * max_pages
    table = torch.as_tensor(_tables(b, max_pages, n_pages, ps))
    k_pages = torch.zeros((n_pages, ps, hkv, d), dtype=dtype)
    v_pages = torch.zeros_like(k_pages)
    k_pages[table.long()] = k.reshape(b, max_pages, ps, hkv, d)
    v_pages[table.long()] = v.reshape(b, max_pages, ps, hkv, d)
    pos = torch.as_tensor([0, 17, S - 1, S + 9], dtype=torch.int32)
    for window in (0, 20):
        assert torch.equal(
            flash_decode_paged(q, k_pages, v_pages, table, pos,
                               window=window),
            flash_decode(q, k, v, pos, window=window))


def test_flash_decode_paged_refuses_bad_operands():
    q = torch.zeros((2, 3, 8))
    pool = torch.zeros((5, 4, 1, 8))
    with pytest.raises(ValueError):          # table rows != batch
        flash_decode_paged(q, pool, pool,
                           torch.zeros((3, 2), dtype=torch.int32), 0)
    # meta operands trace shapes (a dry-run): no launch, no plain version
    o = flash_decode_paged(q.to("meta"), pool.to("meta"), pool.to("meta"),
                           torch.zeros((2, 2), dtype=torch.int32,
                                       device="meta"), 0)
    assert (o.device.type, tuple(o.shape)) == ("meta", (2, 3, 8))
    with pytest.raises(ValueError):          # meta beside the CPU
        flash_decode_paged(q.to("meta"), pool, pool,
                           torch.zeros((2, 2), dtype=torch.int32), 0)
