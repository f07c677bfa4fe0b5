"""The smoke models and engines under int8 serving (W8A16 and W8A8)
against the JAX package on the CPU.

The JAX package quantizes the smoke parameters
(``repro.quant.quantize_params``); the port gets that ``{q, scale}``
tree across ``bridge.from_jax`` unchanged, and both packages run in the
same activation mode, the JAX side with ``REPRO_KERNELS=ref``.  Logits
must agree within ``atol=rtol=1e-4`` (f32 sums in another order through
the layers), greedy tokens exactly, from both packages' dense and paged
engines; where the JAX engine refuses the page pool (recurrent layer
kinds, an encoder-decoder) the port refuses it with the same error.  An
encoder-decoder's requests carry their own stub frames.

This file holds smollm-360m and qwen3-moe-235b-a22b; the other archs
run the same tests through ``tests/test_torch_quant_serve_*.py``, which
import them and give the ``smoke`` fixture their archs (tier-1 runs one
file on one worker, so the archs are spread over files).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs.base import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro_torch import quant
from repro_torch.bridge import from_jax, to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import api
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (ACCEPTANCE_TRACE, DecodeEngine,
                                      Request, acceptance_requests,
                                      solo_greedy)

CPU = torch.device("cpu")
ARCHS = ["smollm-360m", "qwen3-moe-235b-a22b"]


def make_smoke(arch):
    """(jax cfg, quantized jax params, port cfg, the same params in the
    port) of ``arch``'s smoke config.  The port draws the f32 weights
    (seed 0; the JAX init's per-leaf draws cost seconds an arch, and any
    values serve a parity test); the JAX package quantizes them."""
    tcfg = get_smoke_config(arch)
    drawn = T.init_params(tcfg, torch.Generator().manual_seed(0),
                          device=CPU)
    jp, _ = jquant.quantize_params(jax.tree.map(jnp.asarray,
                                                to_numpy(drawn)))
    return j_smoke(arch), jp, tcfg, from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    return make_smoke(request.param)


@pytest.fixture(scope="module")
def dense_runs():
    """The port's dense engine over the acceptance trace, by (arch,
    mode): run once, read by the JAX-parity and the continuous == solo
    cases (the importing files take this fixture with the tests)."""
    return {}


def _dense_tokens(runs, cfg, params, mode, max_len):
    """The port's dense engine (2 slots) over the acceptance trace,
    computed once for (arch, mode): ``{rid: tokens}`` and the tokens in
    trace order."""
    key = (cfg.name, mode)
    if key not in runs:
        engine = DecodeEngine(params, cfg, batch=2, max_len=max_len,
                              device=CPU)
        reqs = _trace(cfg, Request)
        by_rid = {r.rid: r.tokens for r in engine.run(reqs)}
        runs[key] = by_rid, [by_rid[r.rid] for r in reqs]
    return runs[key]


@pytest.fixture(params=["w8a16", "w8a8"])
def mode(request, monkeypatch):
    """Both packages in one activation mode for the test, W8A16 after."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    monkeypatch.delenv("REPRO_W8A8", raising=False)
    m = "w8a8" if request.param == "w8a8" else "none"
    for mod in (quant, jquant):
        mod.set_activation_mode(m)
    api.plan_cache_clear()
    yield request.param
    for mod in (quant, jquant):
        mod.set_activation_mode("none")


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _frames(cfg, n, seed=5):
    """``n`` requests' stub frames (F, d) for an encoder-decoder, else
    ``n`` Nones."""
    if not cfg.encoder_layers:
        return [None] * n
    rng = np.random.default_rng(seed)
    return list(rng.standard_normal((n, cfg.encoder_seq, cfg.d_model))
                .astype(np.float32))


def _trace(cfg, request_cls):
    """The acceptance trace as ``request_cls`` requests (either
    package's), each with its own stub frames for an encoder-decoder."""
    reqs = acceptance_requests(cfg.vocab)
    return [request_cls(prompt=r.prompt, max_tokens=r.max_tokens, frames=f)
            for r, f in zip(reqs, _frames(cfg, len(reqs)))]


def _pages(cfg) -> bool:
    """Whether the paged engine takes ``cfg`` (no recurrent layer kind,
    no encoder)."""
    return not cfg.encoder_layers \
        and not set(cfg.all_kinds) & set(T.RECURRENT_KINDS)


def test_int8_prefill_and_decode_logits_match_jax(smoke, mode):
    """A 12-token prefill of two rows and 6 greedy decode steps: logits
    within 1e-4 of the JAX package's, the same tokens."""
    jcfg, jp, tcfg, tp = smoke
    toks = _tokens((2, 12), jcfg.vocab)
    frames = _frames(tcfg, 2)
    jkw, tkw = {}, {}
    if tcfg.encoder_layers:
        jkw["frames"] = jnp.asarray(np.stack(frames))
        tkw["frames"] = torch.as_tensor(np.stack(frames))
    # jitted, as the decode step: one compile, not one an op
    jl, jc = jax.jit(lambda t, c: JT.prefill(jp, jcfg, t, c, **jkw))(
        jnp.asarray(toks), JT.init_cache(jcfg, 2, 40))
    tl, tc = T.prefill(tp, tcfg, torch.as_tensor(toks),
                       T.init_cache(tcfg, 2, 40, device=CPU), **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    step = jax.jit(lambda t, c: JT.decode_step(jp, jcfg, t, c))
    for _ in range(6):
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = step(jt, jc)
        tl, tc = T.decode_step(tp, tcfg, tt, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("paged", [False, True])
def test_int8_engine_tokens_match_jax_engine(smoke, mode, paged,
                                             dense_runs):
    """The acceptance trace through both packages' engines, dense and
    paged (16-token pages, 8-token chunks): the same tokens, request by
    request; where the JAX engine refuses the pool, the port refuses it
    with the same error type and message."""
    from repro.serve.engine import DecodeEngine as JEngine
    from repro.serve.engine import Request as JRequest
    jcfg, jp, tcfg, tp = smoke
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    kw = dict(batch=2, max_len=max_len)
    if paged:
        kw.update(page_size=16, prefill_chunk=8)
    if paged and not _pages(tcfg):
        with pytest.raises(ValueError) as jerr:
            JEngine(jp, jcfg, **kw)
        with pytest.raises(ValueError) as terr:
            DecodeEngine(tp, tcfg, device=CPU, **kw)
        assert str(terr.value) == str(jerr.value)
        return
    want = {r.rid: r.tokens for r in
            JEngine(jp, jcfg, **kw).run(_trace(tcfg, JRequest))}
    got = {r.rid: r.tokens for r in
           DecodeEngine(tp, tcfg, device=CPU, **kw).run(
               _trace(tcfg, Request))} if paged \
        else _dense_tokens(dense_runs, tcfg, tp, mode, max_len)[0]
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_int8_continuous_batch_equals_solo_greedy(smoke, mode, dense_runs):
    """Per-row activation quantization touches a row alone, so a request
    decodes the same tokens inside the 2-slot batch as alone."""
    _, _, cfg, params = smoke
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    reqs = _trace(cfg, Request)
    _, results = _dense_tokens(dense_runs, cfg, params, mode, max_len)
    for req, tokens in zip(reqs, results):
        np.testing.assert_array_equal(
            tokens,
            solo_greedy(params, cfg, req.prompt, req.max_tokens, max_len,
                        frames=req.frames))


@pytest.mark.parametrize("flag", ["--int8", "--w8a8"])
def test_serve_cli_serves_int8_on_the_cpu(flag, capsys):
    try:
        serve_cli.main(["--smoke", flag, "--device", "cpu", "--trace", "3",
                        "--slots", "2", "--steps", "4"])
    finally:
        quant.set_activation_mode("none")
    out = capsys.readouterr().out
    assert "[serve] int8-quantized 8 weight banks" in out and "bytes)" in out
    assert ("w8a8" if flag == "--w8a8" else "w8a16") in out
    assert "[serve] trace: 3/3 requests" in out
