"""The port's paged serving path against the JAX package, on the CPU.

``smollm-360m-smoke`` (f32) parameters come from the JAX init through
``bridge.from_jax``; the JAX side runs with ``REPRO_KERNELS=ref``.
Layer outputs, logits and pools agree within ``atol=rtol=1e-4`` (f32
sums in another order); greedy tokens exactly.  The port's paged engine
reproduces the ``paged`` block of ``BENCH_serve.json`` (written by
``benchmarks/serve_bench.py`` from the JAX engine): the same capacity,
decode stall and prefix counts, and bit-identical greedy tokens against
the port's own dense solo runs.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.serve import paging
from repro_torch.serve.engine import (ACCEPTANCE_TRACE, DecodeEngine,
                                      Request, acceptance_requests,
                                      solo_greedy)

CPU = torch.device("cpu")
CLOSE = dict(atol=1e-4, rtol=1e-4)
ROOT = pathlib.Path(__file__).resolve().parent.parent

#: benchmarks/serve_bench.py's paged trace: the acceptance trace plus a
#: short and a long prompt, 16-token pages, 16-token prefill chunks
LONG_TRACE = ACCEPTANCE_TRACE + ((8, 8), (96, 8))
PAGE_SIZE = 16
PREFILL_CHUNK = 16


@pytest.fixture(scope="module")
def smoke():
    jcfg = j_smoke("smollm-360m")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_smoke_config("smollm-360m"), tparams


def _np(x):
    return np.random.default_rng(x[0]).standard_normal(x[1]) \
        .astype(np.float32)


def _pool_pair(cfg, n_pages, ps, seed):
    """The same random k/v pools as JAX arrays and torch tensors, one
    layer: (n_pages, ps, hkv, hd)."""
    shape = (n_pages, ps, cfg.n_kv_heads, cfg.hd)
    k, v = _np((seed, shape)), _np((seed + 1, shape))
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.as_tensor(k), "v": torch.as_tensor(v)})


def test_paged_attention_decode_matches_jax(smoke, monkeypatch):
    """One paged decode layer (layer 0 of the smoke model): the output
    and the written pools.  Row 1 is masked (all-sink table) with a
    position past its table, so its write clamps into the sink page."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jcfg, jp, tcfg, tp = smoke
    ps, max_pages, n_pages, b = 8, 4, 13, 3
    jc, tc = _pool_pair(jcfg, n_pages, ps, 0)
    perm = np.random.default_rng(1).permutation(np.arange(1, n_pages))
    table = perm[:b * max_pages].reshape(b, max_pages).astype(np.int32)
    table[1] = paging.SINK_PAGE
    pos = np.asarray([5, 40, 27], np.int32)
    x = _np((2, (b, 1, jcfg.d_model)))
    jl = jax.tree.map(lambda t: t[0], jp["layers"]["u0"]["attn"])
    tl = {n: t[0] for n, t in tp["layers"]["u0"]["attn"].items()}
    jspec = JL.AttnLayerSpec(jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
                             jcfg.hd)
    tspec = TL.AttnLayerSpec(tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
                             tcfg.hd)
    jout, jc = JL.paged_attention_decode(
        jl, jnp.asarray(x), jc, jnp.asarray(table), jnp.asarray(pos), jspec,
        residual=jnp.asarray(x))
    tx = torch.as_tensor(x)
    tout, tc2 = TL.paged_attention_decode(
        tl, tx, tc, torch.as_tensor(table), torch.as_tensor(pos), tspec,
        residual=tx)
    assert tc2 is tc                          # written in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **CLOSE)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **CLOSE)


def test_prefill_paged_chunk_matches_jax(smoke, monkeypatch):
    """A 17-token prompt in two chunks (10 + 7, the second attending the
    first through the table) into a permuted pool: logits after each
    chunk, the pools and pos agree with the JAX package, and the last
    chunk's logits agree with a whole-prompt dense prefill."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jcfg, jp, tcfg, tp = smoke
    ps, max_pages, n_pages = 8, 4, 9
    jc = JT.init_paged_cache(jcfg, 2, n_pages, ps, max_pages)
    tc = T.init_paged_cache(tcfg, 2, n_pages, ps, max_pages, device=CPU)
    row = np.asarray([7, 2, 5, paging.SINK_PAGE], np.int32)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (1, 17)) \
        .astype(np.int32)
    for start, stop in ((0, 10), (10, 17)):
        jl, jc = JT.prefill_paged_chunk(
            jp, jcfg, jnp.asarray(toks[:, start:stop]), jc,
            jnp.asarray(1, jnp.int32), jnp.asarray(row), start)
        tl, tc = T.prefill_paged_chunk(
            tp, tcfg, torch.as_tensor(toks[:, start:stop]), tc, 1, row,
            start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **CLOSE)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tc["layers"]["u0"][name].numpy(),
            np.asarray(jc["layers"]["u0"][name]), **CLOSE)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [0, 17]
    dense, _ = T.prefill(tp, tcfg, torch.as_tensor(toks),
                         T.init_cache(tcfg, 1, 32, device=CPU))
    np.testing.assert_allclose(tl.numpy(), dense.numpy(), **CLOSE)


def test_copy_kv_pages_matches_jax(smoke):
    jcfg, _, tcfg, _ = smoke
    jc = JT.init_paged_cache(jcfg, 1, 6, 4, 2)
    tc = T.init_paged_cache(tcfg, 1, 6, 4, 2, device=CPU)
    for name in ("k", "v"):
        x = _np((ord(name), jc["layers"]["u0"][name].shape))
        jc["layers"]["u0"][name] = jnp.asarray(x)
        tc["layers"]["u0"][name] = torch.as_tensor(x)
    jc = JT.copy_kv_pages(jc, jnp.asarray([2, 5]), jnp.asarray([4, 1]))
    tc = T.copy_kv_pages(tc, [2, 5], [4, 1])
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc["layers"]["u0"][name].numpy(),
                                      np.asarray(jc["layers"]["u0"][name]))


def test_paged_decode_step_matches_dense(smoke):
    """decode_step through a page table: four steps on a prompt held in
    scattered pages give the dense cache's logits, bit for bit (the
    gathered length equals the dense length)."""
    _, _, cfg, params = smoke
    ps, max_pages = 8, 6
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, 13)))
    dense = T.init_cache(cfg, 1, ps * max_pages, device=CPU)
    dl, dense = T.prefill(params, cfg, toks, dense)
    paged = T.init_paged_cache(cfg, 1, 1 + max_pages, ps, max_pages,
                               device=CPU)
    row = np.asarray([3, 6, 1, 4, 2, 5], np.int32)
    pl, paged = T.prefill_paged_chunk(params, cfg, toks, paged, 0, row, 0)
    paged["page_table"].copy_(torch.as_tensor(row)[None])
    np.testing.assert_allclose(pl.numpy(), dl.numpy(), **CLOSE)
    tok = torch.argmax(dl, -1)[:, None]
    for _ in range(4):
        dl, dense = T.decode_step(params, cfg, tok, dense)
        pl, paged = T.decode_step(params, cfg, tok, paged)
        assert torch.equal(pl, dl)
        tok = torch.argmax(dl, -1)[:, None]


def test_paged_engine_tokens_match_jax_engine(smoke, monkeypatch):
    """The acceptance trace through both packages' paged engines (pages
    of 16, chunks of 8, prefix cache on): the same tokens per request
    and the same chunk and prefix counters."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.serve.engine import DecodeEngine as JEngine
    from repro.serve.engine import acceptance_requests as j_reqs
    jcfg, jp, tcfg, tp = smoke
    kw = dict(batch=2, max_len=64, page_size=16, prefill_chunk=8)
    jeng = JEngine(jp, jcfg, **kw)
    want = {r.rid: r for r in jeng.run(j_reqs(jcfg.vocab))}
    teng = DecodeEngine(tp, tcfg, device=CPU, **kw)
    got = {r.rid: r for r in teng.run(acceptance_requests(tcfg.vocab))}
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].prefill_chunks == want[rid].prefill_chunks
    for key in ("decode_steps", "prefill_tokens", "prefill_chunks",
                "max_prefill_stall_tokens", "prefix_hits", "prefix_misses",
                "shared_prompt_tokens"):
        assert teng.metrics[key] == jeng.metrics[key], key
    assert [r.prefill_chunks for r in sorted(got.values(),
                                             key=lambda r: r.rid)] \
        == [1, 2, 1, 4]
    assert teng.kv.pool.n_used == jeng.kv.pool.n_used


# ---------------------------------------------------------------------------
# BENCH_serve.json's paged block, reproduced by the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCH_serve.json").read_text())["paged"]


def _long_requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                    max_tokens=mt) for p, mt in LONG_TRACE]


def _geometry():
    needs = [p + mt - 1 for p, mt in LONG_TRACE]
    dense_len = -(-max(needs) // PAGE_SIZE) * PAGE_SIZE
    return needs, dense_len, 2 * dense_len // PAGE_SIZE


def test_bench_paged_capacity(smoke, bench):
    """FIFO head-of-line admission at equal pool bytes: dense rows
    reserve a whole max_len row per request, the port's PagedKV only
    the pages each request needs — 131 against 58 tokens."""
    _, _, cfg, _ = smoke
    needs, dense_len, usable = _geometry()
    free = pool_tokens = usable * PAGE_SIZE
    dense_admitted = 0
    for n in needs:
        if free < dense_len:
            break
        free -= dense_len
        dense_admitted += n
    kv = paging.PagedKV(len(needs), 1 + usable, PAGE_SIZE,
                        dense_len // PAGE_SIZE, prefix_cache=False)
    paged_admitted = 0
    for slot, (n, req) in enumerate(zip(needs, _long_requests(cfg.vocab))):
        if not kv.can_admit(req.prompt, n):
            break
        kv.admit(slot, req.prompt, n)
        paged_admitted += n
    assert (pool_tokens, dense_admitted, paged_admitted) == (
        bench["trace"]["pool_tokens"],
        bench["capacity"]["dense_admitted_tokens"],
        bench["capacity"]["paged_admitted_tokens"]) == (224, 58, 131)


def test_bench_paged_stall_and_bit_identity(smoke, bench):
    """The long trace on 2 slots with 16-token pages: the worst decode
    stall is the 96-token prompt unchunked and one 16-token chunk
    chunked, and every request's tokens equal its dense solo greedy run
    both ways (6/6)."""
    _, _, cfg, params = smoke
    _, dense_len, usable = _geometry()
    solo = [solo_greedy(params, cfg, r.prompt, r.max_tokens, dense_len)
            for r in _long_requests(cfg.vocab)]
    stalls = []
    for chunk in (None, PREFILL_CHUNK):
        eng = DecodeEngine(params, cfg, batch=2, max_len=dense_len,
                           page_size=PAGE_SIZE, n_pages=1 + usable,
                           prefix_cache=False, prefill_chunk=chunk,
                           device=CPU)
        res = {r.rid: r for r in eng.run(_long_requests(cfg.vocab))}
        exact = sum(bool(np.array_equal(res[i].tokens, solo[i]))
                    for i in range(len(solo)))
        assert exact == len(solo) == 6
        stalls.append(eng.metrics["max_prefill_stall_tokens"])
        assert eng.kv.pool.n_used == 0
    assert bench["bit_identical"]
    assert tuple(stalls) == (bench["stall"]["unchunked"],
                             bench["stall"]["chunked"]) == (96, 16)


def test_bench_paged_prefix_sharing(smoke, bench):
    """Two prompts sharing a 32-token prefix: the prefix prefills once
    (48 prompt tokens, 32 shared, 1 hit) and both continuations equal
    their dense solo greedy runs."""
    _, _, cfg, params = smoke
    _, dense_len, usable = _geometry()
    rng = np.random.default_rng(7)
    pre = rng.integers(0, cfg.vocab, (2 * PAGE_SIZE,)).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab, (8,))
                               .astype(np.int32)]) for _ in range(2)]
    eng = DecodeEngine(params, cfg, batch=2, max_len=dense_len,
                       page_size=PAGE_SIZE, n_pages=1 + usable, device=CPU)
    res = {r.rid: r for r in eng.run(
        [Request(prompt=p, max_tokens=8) for p in prompts])}
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            res[i].tokens, solo_greedy(params, cfg, p, 8, dense_len))
    m = eng.metrics
    got = (m["prefill_tokens"], m["shared_prompt_tokens"], m["prefix_hits"])
    assert got == (bench["prefix"]["prefill_tokens"],
                   bench["prefix"]["shared_tokens"],
                   bench["prefix"]["hits"]) == (48, 32, 1)


# ---------------------------------------------------------------------------
# Engine behaviour of the paged mode
# ---------------------------------------------------------------------------

def test_identical_prompt_copies_on_write(smoke):
    """An identical re-prompt shares everything but its last token: the
    mid-page tail is copied on write and one token is recomputed; both
    runs equal the solo greedy run."""
    _, _, cfg, params = smoke
    p = np.random.default_rng(6).integers(0, cfg.vocab, (20,)) \
        .astype(np.int32)
    want = solo_greedy(params, cfg, p, 6, 64)
    eng = DecodeEngine(params, cfg, batch=1, max_len=64, page_size=8,
                       device=CPU)
    r1 = eng.run([Request(prompt=p.copy(), max_tokens=6)])
    t1 = eng.metrics["prefill_tokens"]
    r2 = eng.run([Request(prompt=p.copy(), max_tokens=6)])
    np.testing.assert_array_equal(r1[0].tokens, want)
    np.testing.assert_array_equal(r2[0].tokens, want)
    assert t1 == 20 and eng.metrics["prefill_tokens"] - t1 == 1
    assert eng.metrics["shared_prompt_tokens"] == 19


def test_pool_exhaustion_queues_and_completes(smoke):
    """A pool smaller than the offered load queues at the head of the
    line; every request completes once earlier ones free their pages,
    and the device table ends all-sink."""
    _, _, cfg, params = smoke
    rng = np.random.default_rng(8)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (16,))
                    .astype(np.int32), max_tokens=8) for _ in range(3)]
    eng = DecodeEngine(params, cfg, batch=2, max_len=64, page_size=16,
                       n_pages=1 + 3, prefix_cache=False, device=CPU)
    res = eng.run(reqs)
    assert len(res) == 3 and all(r.n_tokens == 8 for r in res)
    assert eng.kv.pool.n_used == 0
    assert eng.metrics["peak_pages_used"] == 2   # one request at a time
    assert not eng._cache["page_table"].any()


@pytest.mark.parametrize("prompt_len,n_pages,match", [
    (40, 3, "pages"),         # 3 pages of 16 < 47 positions
    (70, None, "max_len"),    # past max_len
])
def test_submit_rejects_oversized_paged_request(smoke, prompt_len, n_pages,
                                                match):
    _, _, cfg, params = smoke
    eng = DecodeEngine(params, cfg, batch=1, max_len=60, page_size=16,
                       n_pages=n_pages, device=CPU)
    assert eng.max_len == 64                  # rounded up to whole pages
    with pytest.raises(ValueError, match=match):
        eng.submit(Request(prompt=np.zeros(prompt_len, np.int32),
                           max_tokens=8))


def test_serve_cli_runs_paged_on_the_cpu(capsys):
    serve_cli.main(["--smoke", "--trace", "6", "--slots", "2", "--steps",
                    "6", "--rate", "1000", "--page-size", "16",
                    "--prefill-chunk", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] trace: 6/6 requests" in out
    assert "[serve] paged KV: " in out and "prefill chunks" in out
    with pytest.raises(SystemExit):
        serve_cli.main(["--smoke", "--prefill-chunk", "8", "--device",
                        "cpu"])

