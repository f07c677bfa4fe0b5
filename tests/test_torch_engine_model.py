"""The engine's lockstep front end and its modeled bytes against the JAX
package's, on the CPU.

* ``DecodeEngine.generate`` equals the JAX engine's on the smoke models
  (smollm-360m-smoke, qwen3-moe-235b-a22b-smoke), EOS padding included.
* ``bandwidth.decode_kv_bytes`` equals the reference's over
  hypothesis-drawn positions, windows and page sizes.
* ``modeled_kv_bytes_per_step``, ``modeled_bytes_per_token`` (f32, bf16
  and int8 parameters) and a trace's ``modeled_kv_bytes*`` metrics equal
  the JAX engine's, dense and paged.
* ``launch/serve.py --batch`` serves one lockstep batch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import quant as jquant
from repro.configs.base import get_smoke_config as j_smoke
from repro.core import bandwidth as jbandwidth
from repro.models import transformer as JT
from repro_torch import quant
from repro_torch.bridge import from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core import bandwidth
from repro_torch.launch import serve as serve_cli
from repro_torch.serve.engine import ACCEPTANCE_TRACE, DecodeEngine, \
    acceptance_requests

CPU = torch.device("cpu")
ARCHS = ["smollm-360m", "qwen3-moe-235b-a22b"]


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    jcfg = j_smoke(request.param)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_smoke_config(request.param), tparams


def _jengine(jp, jcfg, **kw):
    from repro.serve.engine import DecodeEngine as JEngine
    return JEngine(jp, jcfg, **kw)


# ------------------------------------------------------------- generate

def test_generate_equals_the_jax_engine(smoke, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jcfg, jp, tcfg, tp = smoke
    prompts = np.random.default_rng(3).integers(
        0, tcfg.vocab, (3, 12)).astype(np.int32)
    want = _jengine(jp, jcfg, batch=3, max_len=32).generate(
        jax.numpy.asarray(prompts), 8)
    got = DecodeEngine(tp, tcfg, batch=3, max_len=32, device=CPU) \
        .generate(prompts, 8)
    assert got.steps == want.steps == 8
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_generate_pads_after_eos_as_the_jax_engine(smoke, monkeypatch):
    """EOS = the token row 0 samples third: row 0 stops there and pads
    with eos_id, as the JAX engine's rows do."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jcfg, jp, tcfg, tp = smoke
    prompts = np.random.default_rng(4).integers(
        0, tcfg.vocab, (2, 9)).astype(np.int32)
    free = DecodeEngine(tp, tcfg, batch=2, max_len=32, device=CPU) \
        .generate(prompts, 10)
    eos = int(free.tokens[0, 2])
    want = _jengine(jp, jcfg, batch=2, max_len=32, eos_id=eos).generate(
        jax.numpy.asarray(prompts), 10)
    engine = DecodeEngine(tp, tcfg, batch=2, max_len=32, eos_id=eos,
                          device=CPU)
    got = engine.generate(torch.as_tensor(prompts), 10)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    row = list(got.tokens[0])
    first = row.index(eos)
    assert first <= 2 and all(t == eos for t in row[first:])


def test_generate_is_seeded(smoke):
    """Temperature rows draw from the generator ``generate`` reseeds."""
    _, _, tcfg, tp = smoke
    prompts = np.random.default_rng(5).integers(
        0, tcfg.vocab, (2, 6)).astype(np.int32)
    engine = DecodeEngine(tp, tcfg, batch=2, max_len=16, temperature=1.0,
                          device=CPU)
    a = engine.generate(prompts, 6, seed=7).tokens
    b = engine.generate(prompts, 6, seed=7).tokens
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 6)


# ------------------------------------------------------- decode_kv_bytes

@settings(max_examples=150, deadline=None)
@given(st.lists(st.integers(0, 4000), max_size=10),
       st.sampled_from([1, 2, 5, 8]), st.sampled_from([16, 64, 120, 128]),
       st.sampled_from(["bfloat16", "float32", "int8"]),
       st.integers(0, 600), st.sampled_from([None, 1, 8, 16, 64]))
def test_decode_kv_bytes_equals_the_reference(positions, hkv, hd, dtype,
                                              window, page_size):
    kw = dict(n_kv_heads=hkv, head_dim=hd, dtype=dtype, window=window,
              page_size=page_size)
    assert bandwidth.decode_kv_bytes(positions, **kw) == \
        jbandwidth.decode_kv_bytes(positions, **kw)


def test_paged_billing_ignores_the_window_and_rounds_to_pages():
    kw = dict(n_kv_heads=2, head_dim=4, dtype="float32")
    assert bandwidth.decode_kv_bytes([9], window=4, **kw) == 4 * 2 * 2 * 4 * 4
    assert bandwidth.decode_kv_bytes([9], window=4, page_size=8, **kw) == \
        16 * 2 * 2 * 4 * 4


# ------------------------------------------------------- modeled bytes

def _cast(tree, fn):
    if isinstance(tree, dict):
        return {k: _cast(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_modeled_bytes_equal_the_jax_engine(smoke, paged, precision):
    jcfg, jp, tcfg, tp = smoke
    if precision == "bf16":
        jp = jax.tree.map(lambda x: x.astype(jax.numpy.bfloat16), jp)
        tp = _cast(tp, lambda t: t.to(torch.bfloat16))
    elif precision == "int8":
        jp, _ = jquant.quantize_params(jp)
        tp, _ = quant.quantize_params(tp)
    kw = dict(page_size=16) if paged else {}
    jeng = _jengine(jp, jcfg, batch=4, max_len=100, **kw)
    teng = DecodeEngine(tp, tcfg, batch=4, max_len=100, device=CPU, **kw)
    for positions in ([0], [5, 17, 33, 99], [15, 16, 31, 32], []):
        assert teng.modeled_kv_bytes_per_step(positions) == \
            jeng.modeled_kv_bytes_per_step(positions)
        assert teng.modeled_bytes_per_token(positions) == \
            jeng.modeled_bytes_per_token(positions)
    assert teng.modeled_bytes_per_token() == jeng.modeled_bytes_per_token()
    assert teng._dense_rows_kv_bytes_per_step() == \
        jeng._dense_rows_kv_bytes_per_step()
    assert teng._attn_layer_windows() == jeng._attn_layer_windows()
    assert teng._attn_plan_key() is None


@pytest.mark.parametrize("window", [0, 8])
def test_windowed_layers_bill_as_the_jax_engine(window):
    """A sliding window clamps the dense billing (the model is never
    run: the billing reads only the config)."""
    jcfg = dataclasses.replace(j_smoke("smollm-360m"), window=window)
    tcfg = dataclasses.replace(get_smoke_config("smollm-360m"),
                               window=window)
    jp = JT.init_params(jax.random.PRNGKey(0), j_smoke("smollm-360m"))
    tp = from_jax(jax.tree.map(np.asarray, jp))
    jeng = _jengine(jp, jcfg, batch=2, max_len=64)
    teng = DecodeEngine.__new__(DecodeEngine)
    teng.cfg, teng.page_size, teng.max_len, teng.n_slots = \
        tcfg, None, 64, 2
    teng.params = tp
    for positions in ([3, 40], [63, 63]):
        assert teng.modeled_kv_bytes_per_step(positions) == \
            jeng.modeled_kv_bytes_per_step(positions)
    assert teng._dense_rows_kv_bytes_per_step() == \
        jeng._dense_rows_kv_bytes_per_step()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_trace_modeled_kv_metrics_equal_the_jax_engine(smoke, monkeypatch,
                                                        paged):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.serve.engine import acceptance_requests as j_reqs
    jcfg, jp, tcfg, tp = smoke
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    kw = dict(page_size=16, prefill_chunk=8) if paged else {}
    jeng = _jengine(jp, jcfg, batch=2, max_len=max_len, **kw)
    jeng.run(j_reqs(jcfg.vocab))
    teng = DecodeEngine(tp, tcfg, batch=2, max_len=max_len, device=CPU,
                        **kw)
    teng.run(acceptance_requests(tcfg.vocab))
    for key in ("modeled_kv_bytes", "modeled_kv_bytes_dense_rows",
                "decode_steps", "prefill_tokens", "generated_tokens"):
        assert teng.metrics[key] == jeng.metrics[key], key
    assert teng.metrics["modeled_kv_bytes"] > 0
    assert teng.metrics["modeled_kv_bytes"] < \
        teng.metrics["modeled_kv_bytes_dense_rows"]


# ---------------------------------------------------------- the launcher

def test_serve_cli_batch_generates(capsys):
    serve_cli.main(["--smoke", "--batch", "2", "--prompt-len", "8",
                    "--steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] generated 4 steps x 2 seqs" in out
    assert "[serve] first sequence:" in out
    assert "modeled GEMM weight stream" in out
