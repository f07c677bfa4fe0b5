"""Paged serving of the other archs the page pool takes, against the JAX
package on the CPU: internvl2-76b (text only: neither package's engine
takes prefix embeddings), deepseek-67b, minitron-8b and kimi-k2-1t-a32b
(384 experts at full width, a MoE at smoke size).

Parameters of the smoke models (f32) are drawn by the port and handed
to JAX as the same values; the JAX side runs with ``REPRO_KERNELS=ref``.
The trace is the acceptance trace plus two requests sharing a 32-token
prefix, on 2 slots at the page size and prefill chunk of
``tests/test_torch_paged_serve.py`` (16-token pages, 8-token chunks,
prefix cache on).  Greedy tokens must be equal, request by request, to
the JAX paged engine's, with the same chunk and prefix counters; the
dense-family archs' paged tokens must equal the port's dense engine's,
kimi-k2's its paged solo runs (a chunked prefill sizes the expert
capacity by the chunk, in both packages, so a MoE is held to paged solo
runs as qwen3-moe is).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.serve.engine import DecodeEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.bridge import to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ACCEPTANCE_TRACE, DecodeEngine, Request

CPU = torch.device("cpu")
ARCHS = ["internvl2-76b", "deepseek-67b", "minitron-8b", "kimi-k2-1t-a32b"]
PAGED = dict(batch=2, page_size=16, prefill_chunk=8)
PREFIX, TAIL, NEW = 32, 8, 8


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """Both packages' configs and the same f32 parameters: the port
    draws them (seed 0; the JAX init's per-leaf draws cost seconds an
    arch, and any values serve a parity test)."""
    tcfg = get_smoke_config(request.param)
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), device=CPU)
    return j_smoke(request.param), \
        jax.tree.map(jnp.asarray, to_numpy(tp)), tcfg, tp


def _trace(vocab):
    """(prompt, new tokens) pairs: the acceptance trace's prompts (the
    same draws as ``acceptance_requests``), then two prompts that share
    their first :data:`PREFIX` tokens."""
    rng = np.random.default_rng(0)
    out = [(rng.integers(0, vocab, (p,)).astype(np.int32), mt)
           for p, mt in ACCEPTANCE_TRACE]
    pre = rng.integers(0, vocab, (PREFIX,)).astype(np.int32)
    out += [(np.concatenate([pre, rng.integers(0, vocab, (TAIL,))
                             .astype(np.int32)]), NEW) for _ in range(2)]
    return out


def _max_len(trace):
    return max(len(p) + mt for p, mt in trace) + 1


def _run(engine, trace, request_cls):
    return {r.rid: r for r in engine.run(
        [request_cls(prompt=p, max_tokens=mt) for p, mt in trace])}


def test_paged_engine_tokens_match_jax_paged_engine(smoke):
    """Both packages' paged engines on the trace: the same tokens and
    prefill chunks per request, the same decode steps, prefill tokens
    and chunks, longest stall and prefix counters (one hit: the shared
    prefix), and the same pages in use at the end."""
    jcfg, jp, tcfg, tp = smoke
    trace = _trace(tcfg.vocab)
    kw = dict(PAGED, max_len=_max_len(trace))
    jeng = JEngine(jp, jcfg, **kw)
    want = _run(jeng, trace, JRequest)
    teng = DecodeEngine(tp, tcfg, device=CPU, **kw)
    got = _run(teng, trace, Request)
    assert sorted(got) == sorted(want) == list(range(len(trace)))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens,
                                      err_msg=f"request {rid}")
        assert got[rid].prefill_chunks == want[rid].prefill_chunks
    for key in ("decode_steps", "prefill_tokens", "prefill_chunks",
                "max_prefill_stall_tokens", "prefix_hits", "prefix_misses",
                "shared_prompt_tokens"):
        assert teng.metrics[key] == jeng.metrics[key], key
    assert teng.metrics["prefix_hits"] == 1
    assert teng.kv.pool.n_used == jeng.kv.pool.n_used


def test_paged_tokens_equal_the_reference(smoke):
    """The port's paged tokens against its own reference, request by
    request: the dense engine's for the dense family, a 1-slot paged
    engine's (the same pages and chunks, no prefix cache) for kimi-k2."""
    _, _, cfg, params = smoke
    trace = _trace(cfg.vocab)
    max_len = _max_len(trace)
    got = _run(DecodeEngine(params, cfg, device=CPU, max_len=max_len,
                            **PAGED), trace, Request)
    if cfg.n_experts:
        kw = dict(PAGED, batch=1, prefix_cache=False, max_len=max_len)
        want = [_run(DecodeEngine(params, cfg, device=CPU, **kw), [req],
                     Request)[0].tokens for req in trace]
    else:
        dense = _run(DecodeEngine(params, cfg, batch=2, max_len=max_len,
                                  device=CPU), trace, Request)
        want = [dense[rid].tokens for rid in range(len(trace))]
    for rid, tokens in enumerate(want):
        np.testing.assert_array_equal(got[rid].tokens, tokens,
                                      err_msg=f"request {rid}")
