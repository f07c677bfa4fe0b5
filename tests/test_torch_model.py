"""The port's serving slice against the JAX package on the CPU.

``smollm-360m-smoke`` (f32) parameters are made by the JAX init and
carried across with ``bridge.from_jax``; the JAX side runs with
``REPRO_KERNELS=ref``.  Logits must agree within ``atol=rtol=1e-4``
(f32 sums in another order through two layers), greedy tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro_torch import ops
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (ACCEPTANCE_TRACE, DecodeEngine,
                                      Request, SlotScheduler,
                                      acceptance_requests, solo_greedy)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def smoke():
    jcfg = j_smoke("smollm-360m")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_smoke_config("smollm-360m"), tparams


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def test_prefill_and_decode_logits_match_jax(smoke, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jcfg, jp, tcfg, tp = smoke
    toks = _tokens((2, 12), jcfg.vocab)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 2, 40))
    tl, tc = T.prefill(tp, tcfg, torch.as_tensor(toks),
                       T.init_cache(tcfg, 2, 40, device=CPU))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    step = jax.jit(lambda t, c: JT.decode_step(jp, jcfg, t, c))
    jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl, -1)[:, None]
    for _ in range(16):
        jl, jc = step(jt, jc)
        tl, tc = T.decode_step(tp, tcfg, tt, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_greedy_tokens_match_jax_solo(smoke, monkeypatch):
    """16 greedy tokens of a batch-1 request: the port's solo_greedy
    equals the JAX package's, token for token."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.serve.engine import solo_greedy as j_solo
    jcfg, jp, tcfg, tp = smoke
    prompt = _tokens((9,), jcfg.vocab, seed=1)
    want = j_solo(jp, jcfg, prompt, 16, 32)
    got = solo_greedy(tp, tcfg, prompt, 16, 32)
    np.testing.assert_array_equal(got, want)


def test_acceptance_trace_bit_identical_to_solo(smoke):
    """ACCEPTANCE_TRACE on a 2-slot continuous engine: every request's
    tokens equal its solo batch-1 greedy run, slots turn over."""
    _, _, cfg, params = smoke
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    reqs = acceptance_requests(cfg.vocab)
    engine = DecodeEngine(params, cfg, batch=2, max_len=max_len, device=CPU)
    results = {r.rid: r for r in engine.run(reqs)}
    assert len(results) == len(reqs)
    for req in reqs:
        want = solo_greedy(params, cfg, req.prompt, req.max_tokens, max_len)
        np.testing.assert_array_equal(results[req.rid].tokens, want,
                                      err_msg=f"rid {req.rid}")
    assert engine.occupancy() > 0.8
    assert engine.metrics["prefill_tokens"] == \
        sum(p for p, _ in ACCEPTANCE_TRACE)


def test_engine_tokens_match_jax_engine(smoke, monkeypatch):
    """The same trace through both packages' engines gives the same
    tokens, request by request."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.serve.engine import DecodeEngine as JEngine
    from repro.serve.engine import acceptance_requests as j_reqs
    jcfg, jp, tcfg, tp = smoke
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    want = {r.rid: r.tokens for r in
            JEngine(jp, jcfg, batch=2, max_len=max_len).run(
                j_reqs(jcfg.vocab))}
    got = {r.rid: r.tokens for r in
           DecodeEngine(tp, tcfg, batch=2, max_len=max_len,
                        device=CPU).run(acceptance_requests(tcfg.vocab))}
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_layers_match_jax(smoke, monkeypatch):
    """The layer functions of the slice one by one: rms_norm, rope,
    swiglu and the full-sequence attention_block with its residual
    flush, on the smoke model's first layer."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jcfg, jp, tcfg, tp = smoke
    x = np.random.default_rng(9).standard_normal((2, 10, jcfg.d_model)) \
        .astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    jl = jax.tree.map(lambda t: t[0], jp["layers"]["u0"])
    tl = {k: {n: t[0] for n, t in v.items()}
          for k, v in tp["layers"]["u0"].items()}
    close = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        TL.rms_norm(tl["norm1"], tx, tcfg.norm_eps).numpy(),
        np.asarray(JL.rms_norm(jl["norm1"], jx, jcfg.norm_eps)), **close)
    h = x.reshape(2, 10, 3, 20)
    pos = np.arange(10)
    np.testing.assert_allclose(
        TL.rope(torch.as_tensor(h), torch.as_tensor(pos), 1e4).numpy(),
        np.asarray(JL.rope(jnp.asarray(h), jnp.asarray(pos), 1e4)), **close)
    np.testing.assert_allclose(
        TL.swiglu(tl["mlp"], tx, residual=tx).numpy(),
        np.asarray(JL.swiglu(jl["mlp"], jx, residual=jx)), **close)
    jspec = JL.AttnLayerSpec(jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
                             jcfg.hd)
    tspec = TL.AttnLayerSpec(tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
                             tcfg.hd)
    np.testing.assert_allclose(
        TL.attention_block(tl["attn"], tx, tspec, residual=tx).numpy(),
        np.asarray(JL.attention_block(jl["attn"], jx, jspec, residual=jx)),
        **close)
    jc = JL.init_kv_cache(3, 16, jspec, jnp.float32)
    tc = TL.init_kv_cache(3, 16, tspec, torch.float32, CPU)
    assert tuple(tc["k"].shape) == jc["k"].shape
    assert not tc["k"].any() and not tc["v"].any()


def test_prefill_into_slot_preserves_resident_slots(smoke):
    _, _, cfg, params = smoke
    cache = T.init_cache(cfg, 2, 32, device=CPU)
    p0 = torch.as_tensor(_tokens((1, 8), cfg.vocab, 3))
    p1 = torch.as_tensor(_tokens((1, 12), cfg.vocab, 4))
    _, cache = T.prefill_into_slot(params, cfg, p0, cache, 0, max_len=32)
    k_before = cache["layers"]["u0"]["k"].clone()
    _, cache = T.prefill_into_slot(params, cfg, p1, cache, 1, max_len=32)
    k_after = cache["layers"]["u0"]["k"]
    assert cache["pos"].tolist() == [8, 12]
    assert torch.equal(k_before[:, 0], k_after[:, 0])
    assert not torch.equal(k_before[:, 1], k_after[:, 1])


def test_eos_stops_and_masks_post_eos_tokens(smoke):
    _, _, cfg, params = smoke
    prompt = _tokens((8,), cfg.vocab, 5)
    eos = int(solo_greedy(params, cfg, prompt, 3, 32)[1])
    engine = DecodeEngine(params, cfg, batch=2, max_len=32, device=CPU)
    res = engine.run([Request(prompt=prompt, max_tokens=12, eos_id=eos)])
    toks = res[0].tokens
    assert toks[-1] == eos and eos not in toks[:-1]


def test_temperature_slot_leaves_greedy_slot_bit_identical(smoke):
    _, _, cfg, params = smoke
    pg, pt = _tokens((8,), cfg.vocab, 6), _tokens((8,), cfg.vocab, 7)
    engine = DecodeEngine(params, cfg, batch=2, max_len=32, device=CPU)
    reqs = [Request(prompt=pg, max_tokens=6),
            Request(prompt=pt, max_tokens=6, temperature=1.0)]
    results = {r.rid: r for r in engine.run(reqs)}
    np.testing.assert_array_equal(results[reqs[0].rid].tokens,
                                  solo_greedy(params, cfg, pg, 6, 32))
    assert results[reqs[1].rid].n_tokens == 6


def test_slot_scheduler_fifo_and_reuse():
    s = SlotScheduler(2)
    for rid in range(4):
        s.submit(rid)
    assert s.admit() == (0, 0) and s.admit() == (1, 1)
    assert s.admit() is None
    assert s.release(0) == 0
    assert s.admit() == (0, 2)
    s.release(1)
    s.release(0)
    assert s.admit() == (0, 3)
    s.release(0)
    assert not s.has_work()


def test_init_params_layout_and_std_match_jax():
    """Same keys, shapes, dtypes and init scales as the JAX init, on the
    full-width config (shapes only: no full-size tensors are made)."""
    jcfg = j_smoke("smollm-360m")
    struct = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    tcfg = get_smoke_config("smollm-360m")
    gen = torch.Generator().manual_seed(0)
    tp = T.init_params(tcfg, gen, device=CPU)
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(struct)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", v

    tflat = dict(flat(tp))
    assert sorted(tflat) == sorted(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[-1] == jflat[k].dtype.name, k
    wq = tflat["['layers']['u0']['attn']['wq']"]
    assert abs(wq.std().item() * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(tflat["['embed']"].std().item() - 0.02) < 0.002


def test_full_width_config_matches_jax_and_defaults_need_a_card():
    from repro.configs.base import get_config as j_get
    cfg, jcfg = get_config("smollm-360m"), j_get("smollm-360m")
    for f in jcfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_cache(get_smoke_config("smollm-360m"), 1, 8)


#: what each case raises: features outside the port name the ROADMAP
#: queue item that brings them; inputs a config cannot take, and an
#: attention block the kernel does not compile, raise ValueError
_REFUSALS = {
    "window": (ValueError, "not compile"),
    "local": (NotImplementedError, "ROADMAP queue A9"),
    "ssm": (ValueError, "an encoder needs a stack of attention layers"),
    "prefix_embeds": (ValueError, "prefix embeddings of width 2"),
    "frames": (ValueError, "has no encoder to take frames"),
    "page_size": (NotImplementedError, "ROADMAP queue A9"),
}


@pytest.mark.parametrize("what", ["window", "local", "ssm", "prefix_embeds",
                                  "frames", "page_size"])
def test_unported_features_raise(smoke, what):
    """Each feature outside the port refuses with NotImplementedError,
    naming the ROADMAP queue item that brings it: a ``local`` layer on
    the page pool (A9), alone or beside ``attn`` layers.  Every layer
    kind, absolute positions, prefix embeddings and the encoder-decoder
    are served (tests/test_torch_archs.py); what raises ValueError there
    is an input the config cannot take: an attention block the kernel
    does not compile (a windowed prefill at bq=24), an encoder over
    recurrent layers, prefix embeddings of another width, frames for a
    model with no encoder."""
    _, _, cfg, params = smoke
    toks = torch.as_tensor(_tokens((1, 4), cfg.vocab))
    err, match = _REFUSALS[what]
    with pytest.raises(err, match=match):
        if what == "window":
            q = torch.zeros((1, 4, cfg.n_heads, cfg.hd))
            kv = torch.zeros((1, 4, cfg.n_kv_heads, cfg.hd))
            ops.attention(q, kv, kv, window=8, bq=24)
        elif what == "local":
            T.init_paged_cache(dataclasses.replace(
                cfg, local_window=4, layer_pattern=("local",)),
                1, 3, 4, 2, device=CPU)
        elif what == "ssm":
            T.init_params(dataclasses.replace(cfg, layer_pattern=("ssm",),
                                              encoder_layers=2),
                          torch.Generator().manual_seed(0), device=CPU)
        elif what == "page_size":           # paging, with a local window
            DecodeEngine(params, dataclasses.replace(
                cfg, window=8, local_window=4,
                layer_pattern=("attn", "local")),
                batch=1, max_len=8, page_size=4, device=CPU)
        else:
            width = 2 if what == "prefix_embeds" else cfg.d_model
            T.prefill(params, cfg, toks, T.init_cache(cfg, 1, 8, device=CPU),
                      **{what: torch.zeros((1, 2, width))})


def test_serve_cli_runs_a_trace_on_the_cpu(capsys):
    serve_cli.main(["--smoke", "--trace", "5", "--slots", "2", "--steps",
                    "6", "--rate", "1000", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] trace: 5/5 requests" in out
    assert "slot occupancy" in out and "[serve] ttft:" in out
