"""Windowed serving (h2o-danube-3-4b) in the port against the JAX
package, on the CPU.

``h2o-danube-3-4b-smoke`` (f32, window 32) parameters come from the JAX
init through ``bridge.from_jax``; the JAX side runs with
``REPRO_KERNELS=ref``.  Logits agree within ``atol=rtol=1e-4`` (f32
sums in another order: the port's ring decode runs B4's plain version
over the ring, the reference two einsums), greedy tokens exactly.  The
port's own invariants hold bit for bit: continuous == solo greedy
through the ring, and a ring decode equals a full-length cache's
windowed decode within the same tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get
from repro.configs.base import get_smoke_config as j_smoke
from repro.data import pipeline as JP
from repro.models import transformer as JT
from repro.serve.engine import DecodeEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import ops
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import pipeline as P
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serve.engine import DecodeEngine, Request, solo_greedy
from repro_torch.train import train_step as TS

CPU = torch.device("cpu")
ARCH = "h2o-danube-3-4b"
CLOSE = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


@pytest.fixture(scope="module")
def smoke():
    jcfg = j_smoke(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_smoke_config(ARCH), tparams


def _tokens(n, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)) \
        .astype(np.int32)


@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_configs_match_jax(name):
    """Both registrations, field for field, and the parameter count."""
    cfg = get_config(name) if "smoke" not in name \
        else get_smoke_config(ARCH)
    jcfg = j_get(name) if "smoke" not in name else j_smoke(ARCH)
    for f in jcfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("max_len,slots", [(10_000, 32), (24, 24),
                                           (32, 32)])
def test_dense_cache_is_a_bounded_ring(smoke, max_len, slots):
    """The dense cache holds min(max_len, window) slots a layer, as the
    JAX cache does; the full-width model's ring is 4096 slots at any
    max_len past its window."""
    jcfg, _, tcfg, _ = smoke
    cache = T.init_cache(tcfg, 1, max_len, device=CPU)
    want = JT.init_cache(jcfg, 1, max_len)["layers"]["u0"]["k"].shape
    assert tuple(cache["layers"]["u0"]["k"].shape) == want
    assert want[2] == slots
    assert T.cache_len(get_config(ARCH), 8192) == 4096


@pytest.mark.parametrize("prompt", [16, 50])
def test_ring_decode_three_windows_matches_jax(smoke, prompt):
    """Prefill (16 tokens, or 50: past the 32-slot ring, so prefill keeps
    its ring-aligned tail), then decode to 3 x window + 7 positions:
    every step's logits and the final ring against the JAX ring."""
    jcfg, jp, tcfg, tp = smoke
    total = 3 * jcfg.window + 7
    toks = _tokens(total, jcfg.vocab, 2)
    jc = JT.init_cache(jcfg, 1, total)
    tc = T.init_cache(tcfg, 1, total, device=CPU)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks[:, :prompt]), jc)
    tl, tc = T.prefill(tp, tcfg, torch.as_tensor(toks[:, :prompt]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **CLOSE)
    np.testing.assert_allclose(tc["layers"]["u0"]["k"].numpy(),
                               np.asarray(jc["layers"]["u0"]["k"]),
                               **CLOSE)
    step = jax.jit(lambda t, c: JT.decode_step(jp, jcfg, t, c))
    for i in range(prompt, total):
        jl, jc = step(jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = T.decode_step(tp, tcfg, torch.as_tensor(toks[:, i:i + 1]),
                               tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"position {i}", **CLOSE)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers"]["u0"][name].numpy(),
                                   np.asarray(jc["layers"]["u0"][name]),
                                   **CLOSE)


def test_ring_matches_a_full_cache_with_the_window_masked(smoke):
    """The port's ring decode against its decode over a full-length
    cache that B4's plain version masks to the window, past the window:
    the same keys in another order."""
    _, _, tcfg, tp = smoke
    total = 2 * tcfg.window + 9
    toks = torch.as_tensor(_tokens(total, tcfg.vocab, 4))
    ring = T.init_cache(tcfg, 1, total, device=CPU)
    full = T.init_cache(dataclasses.replace(tcfg, window=0), 1, total,
                        device=CPU)
    assert full["layers"]["u0"]["k"].shape[2] == total
    _, ring = T.prefill(tp, tcfg, toks[:, :20], ring)
    _, full = T.prefill(tp, tcfg, toks[:, :20], full)
    for i in range(20, total):
        a, ring = T.decode_step(tp, tcfg, toks[:, i:i + 1], ring)
        b, full = T.decode_step(tp, tcfg, toks[:, i:i + 1], full)
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   err_msg=f"position {i}", **CLOSE)


def test_ring_decode_plans_b4_with_clamped_positions(smoke):
    """The ring decodes through one planned B4 call a layer, window 0
    over the ring's slots; the prefill plans B3 with the window."""
    _, _, tcfg, tp = smoke
    ops.attn_plan_cache_clear()
    cache = T.init_cache(tcfg, 2, 100, device=CPU)
    toks = torch.as_tensor(_tokens(40, tcfg.vocab, 5))
    _, cache = T.prefill_into_slot(tp, tcfg, toks, cache, 1, max_len=100)
    T.decode_step(tp, tcfg, torch.zeros((2, 1), dtype=torch.int64), cache)
    keys = [(pl.spec.key, pl.shape_key, pl.kernel) for pl in ops.attn_plans()]
    assert keys == [
        ("attn|prefill:causal:w32:g2:float32xfloat32", "b1x40x40xh4/2xd16",
         "flash_attention"),
        ("attn|decode:causal:g2:float32xfloat32", "b2xS32xh4/2xd16",
         "flash_decode")]


def test_ragged_ring_trace_bit_identical_to_solo(smoke):
    """tests/test_serve.py's windowed trace on the port: two requests of
    different lengths decode past the window together on a 2-slot engine,
    each bit-identical to its solo batch-1 run; then a prompt longer than
    the ring (50 > 32) is admitted (the engine admits up to max_len
    positions) and matches its solo run and the JAX engine's tokens."""
    jcfg, jp, tcfg, tp = smoke
    rng = np.random.default_rng(11)
    lens, mts = (8, 24), (40, 20)
    max_len = 72
    reqs = [Request(prompt=rng.integers(0, tcfg.vocab, (p,))
                    .astype(np.int32), max_tokens=mt)
            for p, mt in zip(lens, mts)]
    engine = DecodeEngine(tp, tcfg, batch=2, max_len=max_len, device=CPU)
    results = {r.rid: r for r in engine.run(reqs)}
    for req in reqs:
        want = solo_greedy(tp, tcfg, req.prompt, req.max_tokens, max_len)
        np.testing.assert_array_equal(results[req.rid].tokens, want,
                                      err_msg=f"rid {req.rid}")
    long = Request(prompt=_tokens(50, tcfg.vocab, 12)[0], max_tokens=12)
    (got,) = DecodeEngine(tp, tcfg, batch=2, max_len=max_len,
                          device=CPU).run([long])
    np.testing.assert_array_equal(
        got.tokens, solo_greedy(tp, tcfg, long.prompt, 12, max_len))
    (jgot,) = JEngine(jp, jcfg, batch=2, max_len=max_len).run(
        [JRequest(prompt=long.prompt, max_tokens=12)])
    np.testing.assert_array_equal(got.tokens, np.asarray(jgot.tokens))


def test_paged_windowed_engine_matches_jax(smoke):
    """The paged engine pages windowed layers at full length and masks
    the window in B5 (its plain version here): prompts 8 and 40 decode
    past the window with 8-token pages and 8-token chunks; greedy tokens
    equal the JAX paged engine's and the port's paged solo runs."""
    jcfg, jp, tcfg, tp = smoke
    rng = np.random.default_rng(13)
    lens, mts = (8, 40), (40, 16)
    prompts = [rng.integers(0, tcfg.vocab, (p,)).astype(np.int32)
               for p in lens]
    kw = dict(batch=2, max_len=80, page_size=8, prefill_chunk=8)
    tres = DecodeEngine(tp, tcfg, device=CPU, **kw).run(
        [Request(prompt=p, max_tokens=mt) for p, mt in zip(prompts, mts)])
    jres = JEngine(jp, jcfg, **kw).run(
        [JRequest(prompt=p, max_tokens=mt) for p, mt in zip(prompts, mts)])
    got = {r.rid: r.tokens for r in tres}
    want = {r.rid: np.asarray(r.tokens) for r in jres}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"rid {rid}")
        (solo,) = DecodeEngine(tp, tcfg, device=CPU, prefix_cache=False,
                               **dict(kw, batch=1)).run(
            [Request(prompt=prompts[rid], max_tokens=mts[rid])])
        np.testing.assert_array_equal(got[rid], solo.tokens)


def _by_path(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _port_paths(v, f"{pre}['{k}']")
        else:
            yield f"{pre}['{k}']", v


def test_loss_and_grads_match_jax(smoke):
    """Training through the window: 48 positions past the 32-token
    window, the loss and every gradient leaf against
    ``jax.value_and_grad`` (f32, atol = rtol = 1e-4)."""
    jcfg, jp, tcfg, tp = smoke
    dc = dict(seq_len=48, global_batch=2, seed=3)
    jb = JP.make_batch(jcfg, JP.DataConfig(**dc), 0)
    tb = P.make_batch(tcfg, P.DataConfig(**dc), 0)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb, n_chunks=2), has_aux=True)(jp)
    tl, _, tg = TS.value_and_grad(tp, tcfg, tb, n_chunks=2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **CLOSE)
    want = _by_path(jg)
    got = dict(_port_paths(tg))
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[key], err_msg=key,
                                   **CLOSE)


@pytest.mark.parametrize("paged", [False, True])
def test_serve_cli_serves_the_windowed_model(capsys, paged):
    """``--arch h2o-danube-3-4b --smoke --device cpu``, dense (the ring
    wraps: prompts up to 32 tokens, 24 new ones, a 32-slot ring) and
    paged."""
    argv = ["--arch", ARCH, "--smoke", "--trace", "4", "--slots", "2",
            "--steps", "24", "--rate", "1000", "--device", "cpu"]
    if paged:
        argv += ["--page-size", "8", "--prefill-chunk", "8"]
    serve_cli.main(argv)
    out = capsys.readouterr().out
    assert "[serve] trace: 4/4 requests" in out
    assert ("paged KV" in out) == paged
    assert ("sliding window 32: the dense cache is a ring of 32" in out) \
        == (not paged)
    assert "flash_decode_paged" in out if paged else "flash_decode" in out
