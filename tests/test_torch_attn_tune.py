"""The attention half of the port's measured tuning against the JAX
package's, on the CPU (``device="cpu"``, a fake measurer or timer).

* Keys and schema: ``attn_cache_key`` equals ``repro.tune.attn_cache_key``
  for the same spec, shapes and mode; ``tune`` never changes
  ``AttnSpec.key``; a search's cache entry has the JAX entry's keys.
* ``_attn_proxy_shapes`` equals the JAX function for the same problem and
  flop budget (the batch proxy of ``tests/test_attn_api.py:475``).
* The search: it sweeps the compiled blocks, the default first; the
  winner persists and a second process plans it with zero measurements
  (``tests/test_attn_api.py:447``); enablement follows spec > ``enable``
  > ``REPRO_AUTOTUNE``; cached blocks that are not compiled or do not fit
  the head, and malformed entries, degrade to the default and never
  raise; without a card nothing measures; the backward pass never tunes.
* The harness: ``measure_attn_plan`` with a fake timer is deterministic,
  puts the launch counters back, synthesizes the JAX package's operands.
* A tuned plan's output against ``repro.ops.attention(..., tune=True)``
  (bf16 operands: the f32 bodies have one design), within 2e-2.
* Every compiled B3 shape's CTA grid covers each row once, and the CPU
  emulation of B3's block order gives every row count the same bits.
"""

from __future__ import annotations

import dataclasses
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.kernels import attn_api as jattn
from repro.tune import autotune as jautotune
from repro.tune import cache as jcache
from repro.tune import measure as jmeasure
from repro_torch import ops
from repro_torch.kernels import attn_api
from repro_torch.kernels.flash_attention import (b3_blocks, cta_shape,
                                                 decode_blocks,
                                                 flash_attention)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.tune import autotune, cache, measure
from tests.test_torch_flash_order import _inputs, cta_rows, emulate

CPU = torch.device("cpu")
BF16 = dict(q_dtype="bfloat16", kv_dtype="bfloat16")
#: smollm-360m's head and GQA group at a smoke prompt length
PREFILL = (1, 40, 40, 6, 2, 64)
DECODE = (2, 256, 6, 2, 64)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Its own tuning-cache file, fresh plan caches, the switches unset
    and searches measuring on the CPU."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    cache.tuning_cache_reset()
    jcache.tuning_cache_reset()
    attn_api.attn_plan_cache_clear()
    jattn.attn_plan_cache_clear()
    monkeypatch.setattr(autotune, "_enabled", None)
    monkeypatch.setattr(autotune, "_k", None)
    monkeypatch.setattr(autotune, "_device", CPU)
    yield
    cache.tuning_cache_reset()
    jcache.tuning_cache_reset()
    attn_api.attn_plan_cache_clear()
    jattn.attn_plan_cache_clear()
    jautotune.disable()
    jautotune._enabled = None


def _fake(times: dict, default: float = 2e-3, explode: bool = False):
    """measure_attn_plan stand-in: a time by (bq, bkv), call-counted."""
    def fake(pl, *, iters=3, warmup=1, rng=None, timer=None, device=None):
        fake.calls.append((pl.bq, pl.bkv))
        if explode:
            raise RuntimeError("no measuring allowed")
        t = times.get((pl.bq, pl.bkv), default)
        return measure.Measurement(times_s=(t,) * iters, kept_s=(t,) * iters,
                                   warmup=warmup)
    fake.calls = []
    return fake


def _bf16(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    return torch.as_tensor(x).to(torch.bfloat16)


# ------------------------------------------------------ keys and schema

@pytest.mark.parametrize("kw,shapes", [
    (dict(group=3), PREFILL),
    (dict(mode="decode", group=3, window=4096), DECODE),
    (dict(mode="decode_paged", group=4), (8, 64, 16, 32, 8, 120)),
    (dict(causal=False, q_dtype="float32", kv_dtype="float32"),
     (8, 1, 1500, 16, 16, 64)),
])
@pytest.mark.parametrize("tune", [None, True, False])
def test_cache_key_and_spec_key_equal_the_reference(kw, shapes, tune):
    spec, jspec = ops.AttnSpec(tune=tune, **kw), jops.AttnSpec(tune=tune,
                                                              **kw)
    assert spec.key == jspec.key == ops.AttnSpec(**kw).key
    mode = "cuda:NVIDIA H100 80GB HBM3"
    assert cache.attn_cache_key(spec, shapes, mode) == \
        jcache.attn_cache_key(jspec, shapes, mode)
    assert cache.attn_cache_key(spec, shapes, mode).startswith("attn|")


@pytest.mark.parametrize("shapes,budget", [
    ((256, 4096, 4096, 15, 5, 64), 5e10),       # scaled down, not out
    ((256, 4096, 4096, 15, 5, 64), 1e7),        # even b = 1 is too big
    ((1, 300, 300, 15, 5, 64), 5e10),           # fits as it is
    ((8, 1024, 15, 5, 64), 1e6),                # decode, scaled down
])
def test_proxy_shapes_equal_the_reference(shapes, budget):
    mode = "prefill" if len(shapes) == 6 else "decode"
    spec, jspec = ops.AttnSpec(mode=mode, group=3), \
        jops.AttnSpec(mode=mode, group=3)
    p, jp = attn_api._problem_for(spec, shapes), \
        jattn._problem_for(jspec, shapes)
    assert p.flops == jp.flops
    assert autotune._attn_proxy_shapes(spec, shapes, p, budget) == \
        jautotune._attn_proxy_shapes(jspec, shapes, jp, budget)


def test_entry_has_the_reference_schema(monkeypatch):
    """The port's entry and the JAX package's (its search on its blocked
    path, ``REPRO_KERNELS=ref``) carry the same keys, samples included."""
    monkeypatch.setattr(measure, "measure_attn_plan", _fake({}))
    autotune.enable(k=8, device="cpu")
    ops.attn_plan(ops.AttnSpec(group=3, tune=True), PREFILL, device=CPU)
    (entry,) = cache.tuning_cache().entries().values()

    def jfake(pl, *, iters=3, warmup=1, rng=None, timer=None):
        return jmeasure.Measurement(times_s=(1e-3,) * iters,
                                    kept_s=(1e-3,) * iters, warmup=warmup)
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    monkeypatch.setattr(jmeasure, "measure_attn_plan", jfake)
    jops.attn_plan(jops.AttnSpec(tune=True), (1, 128, 2048, 2, 2, 64))
    # one file: the JAX cache reads the port's entry too
    (jentry,) = [e for e in jcache.tuning_cache().entries().values()
                 if e["mode"] == "ref"]
    assert set(entry) == set(jentry)
    assert set(entry["samples"][0]) == set(jentry["samples"][0])
    assert set(entry["analytic"]) == set(jentry["analytic"])
    assert set(entry["blocks"]) == set(jentry["blocks"]) == {"bq", "bkv"}


# ------------------------------------------------------------- the search

@pytest.mark.parametrize("kw,shapes,d", [
    (dict(group=3), PREFILL, 64),
    (dict(group=16, window=100), (1, 30, 30, 16, 1, 256), 256),
    (dict(mode="decode", group=3), DECODE, 64),
    (dict(mode="decode", group=16), (2, 256, 16, 1, 256), 256),
])
def test_search_sweeps_the_compiled_blocks_default_first(monkeypatch, kw,
                                                         shapes, d):
    fake = _fake({})
    monkeypatch.setattr(measure, "measure_attn_plan", fake)
    autotune.enable(k=8, device="cpu")
    errors = len(autotune.candidate_errors)
    pl = ops.attn_plan(ops.AttnSpec(**BF16, **kw), shapes, device=CPU)
    want = b3_blocks(d) if "mode" not in kw \
        else tuple((None, b) for b in decode_blocks(d))
    assert fake.calls[0] == want[0] and sorted(fake.calls, key=str) == \
        sorted(want, key=str)
    assert len(autotune.candidate_errors) == errors
    # every time ties: the default (analytic rank 0) wins
    assert pl.source == "tuned" and (pl.bq, pl.bkv) == want[0]
    assert pl.tuned.k_searched == len(want) and not pl.tuned.from_cache


def test_winner_persists_and_a_second_process_measures_nothing(monkeypatch):
    fake = _fake({(32, 128): 1e-3})
    monkeypatch.setattr(measure, "measure_attn_plan", fake)
    autotune.enable(k=8, device="cpu")
    spec = ops.AttnSpec(group=3)
    pl = ops.attn_plan(spec, PREFILL, device=CPU)
    assert (pl.bq, pl.bkv) == (32, 128) and pl.source == "tuned"
    assert pl.tuned.analytic_tile == "bq=64 bkv=64"
    assert pl.vmem_bytes == cta_shape(1, 40, 6, 2, 64, torch.bfloat16, 32,
                                      128).smem_bytes
    assert "analytic first choice bq=64 bkv=64" in pl.explain()
    assert cache.tuning_cache_info().measurements == 1
    (key,) = cache.tuning_cache().entries()
    assert key == cache.attn_cache_key(spec, PREFILL, "cpu")

    cache.tuning_cache_reset()              # a second process, one file
    attn_api.attn_plan_cache_clear()
    monkeypatch.setattr(measure, "measure_attn_plan", _fake({}, explode=True))
    pl2 = ops.attn_plan(spec, PREFILL, device=CPU)
    assert pl2.tuned.from_cache and (pl2.bq, pl2.bkv) == (32, 128)
    assert cache.tuning_cache_info().measurements == 0
    assert f"{pl2.tuned.t_measured_us:.1f} us measured" in pl2.explain()


def test_enablement_precedence_spec_module_env(monkeypatch):
    monkeypatch.setattr(measure, "measure_attn_plan", _fake({}))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert ops.attn_plan(ops.AttnSpec(group=3, tune=False), PREFILL,
                         device=CPU).source == "analytic"
    assert ops.attn_plan(ops.AttnSpec(group=3), PREFILL,
                         device=CPU).source == "tuned"
    attn_api.attn_plan_cache_clear()
    monkeypatch.setattr(autotune, "_enabled", False)   # module beats env
    assert ops.attn_plan(ops.AttnSpec(group=3), PREFILL,
                         device=CPU).source == "analytic"
    # the spec beats the module; B5 has no block to search
    assert ops.attn_plan(ops.AttnSpec(group=3, tune=True), PREFILL,
                         device=CPU).source == "tuned"
    paged = ops.attn_plan(ops.AttnSpec(mode="decode_paged", group=3,
                                       tune=True), (2, 4, 64, 6, 2, 64),
                          device=CPU)
    assert paged.source == "analytic" and paged.fallback_reason is None


@pytest.mark.parametrize("blocks,shapes", [
    ({"bq": 48, "bkv": 64}, PREFILL),                   # not compiled
    ({"bq": 128, "bkv": 128}, (1, 30, 30, 16, 1, 256)),  # not at head 256
    ({"bq": None, "bkv": 256}, (2, 256, 16, 1, 256)),    # B4 at head 256
])
def test_cached_blocks_that_do_not_run_here_degrade(monkeypatch, blocks,
                                                    shapes):
    spec = ops.AttnSpec(mode="prefill" if len(shapes) == 6 else "decode",
                        group=shapes[-3] // shapes[-2])
    cache.tuning_cache().put(cache.attn_cache_key(spec, shapes, "cpu"),
                             {"blocks": blocks, "t_us": 1.0})
    monkeypatch.setattr(measure, "measure_attn_plan", _fake({}, explode=True))
    autotune.enable(device="cpu")
    pl = ops.attn_plan(spec, shapes, device=CPU)
    cands = attn_api._block_candidates(pl.kernel, pl.problem)
    assert pl.source == "analytic" and (pl.bq, pl.bkv) == cands[0]
    assert "infeasible here; re-resolved analytically" in pl.fallback_reason


@pytest.mark.parametrize("entry", [
    {"blocks": [64, 64]}, {"blocks": {"bq": 64}, "t_us": "fast"}, {}])
def test_malformed_entries_are_searched_again_never_raising(monkeypatch,
                                                           entry):
    spec = ops.AttnSpec(group=3)
    cache.tuning_cache().put(cache.attn_cache_key(spec, PREFILL, "cpu"),
                             entry)
    monkeypatch.setattr(measure, "measure_attn_plan", _fake({}, explode=True))
    autotune.enable(device="cpu")
    errors = len(autotune.candidate_errors)
    pl = ops.attn_plan(spec, PREFILL, device=CPU)     # every sample fails
    assert pl.source == "analytic" and (pl.bq, pl.bkv) == (64, 64)
    failed = autotune.candidate_errors[errors:]
    assert failed and all(e[0] == "measure" and e[1] == spec.key
                          for e in failed)


def test_without_a_card_nothing_measures(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the search measures on it")
    fake = _fake({})
    monkeypatch.setattr(measure, "measure_attn_plan", fake)
    autotune.enable()                       # measures on the card
    with pytest.warns(UserWarning, match="plans stay analytic"):
        pl = ops.attn_plan(ops.AttnSpec(group=3), PREFILL, device=CPU)
    assert pl.source == "analytic" and fake.calls == []


def test_the_backward_pass_never_tunes(monkeypatch):
    monkeypatch.setattr(measure, "measure_attn_plan", _fake({}))
    autotune.enable(k=8, device="cpu")
    q = _bf16((1, 40, 6, 64), 0).float().requires_grad_()
    k = _bf16((1, 40, 2, 64), 1).float().requires_grad_()
    v = _bf16((1, 40, 2, 64), 2).float().requires_grad_()
    ops.attention(q, k, v).sum().backward()
    assert q.grad.shape == q.shape and v.grad.shape == v.shape
    # one forward plan searched; the backward recomputes through the
    # reference composition and plans nothing
    assert cache.tuning_cache_info().measurements == 1
    assert len(ops.attn_plans()) == 1


# ------------------------------------------------------------ the harness

@pytest.mark.parametrize("mode,shapes", [
    ("prefill", PREFILL), ("decode", DECODE),
    ("decode_paged", (2, 4, 64, 6, 2, 64))])
def test_measure_attn_plan_with_a_fake_timer(mode, shapes):
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_decode import (flash_decode_paged_plain,
                                                  flash_decode_plain)
    pl = attn_api.attn_plan(ops.AttnSpec(mode=mode, group=3), shapes,
                            device=CPU)
    plains = (flash_attention_plain, flash_decode_plain,
              flash_decode_paged_plain)
    before = [f.launches for f in plains]
    ticks = iter(range(100))
    m = measure.measure_attn_plan(pl, iters=4, warmup=1,
                                  timer=lambda: float(next(ticks)),
                                  device="cpu")
    assert m.times_s == (1.0,) * 4 and m.median_s == 1.0
    assert [f.launches for f in plains] == before
    assert not measure.measuring()
    ops_ = measure.synthesize_attn_operands(pl, np.random.default_rng(0),
                                            "cpu")
    if mode == "prefill":
        assert ops_["q"].shape == (1, 40, 6, 64) and ops_["pos"] is None
    else:
        assert ops_["pos"].tolist() == [pl.skv - 1] * pl.b
        assert ops_["q"].dtype == torch.bfloat16
    if mode == "decode_paged":
        assert ops_["page_table"].tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]


# ---------------------------------------------------- against repro.ops

def test_a_tuned_plan_matches_the_reference(monkeypatch):
    """bf16 operands (the f32 bodies have one design): a tuned plan off
    the default blocks gives the untuned plan's output on the CPU and
    ``repro.ops.attention(..., tune=True)``'s within 2e-2; so does a
    tuned decode plan."""
    monkeypatch.setattr(measure, "measure_attn_plan",
                        _fake({(16, 128): 1e-3, (None, 256): 1e-3}))
    autotune.enable(k=8, device="cpu")
    q, k, v = _bf16((1, 40, 6, 64), 0), _bf16((1, 40, 2, 64), 1), \
        _bf16((1, 40, 2, 64), 2)
    got = ops.attention(q, k, v, tune=True)
    (pl,) = ops.attn_plans()
    assert (pl.bq, pl.bkv) == (16, 128) and pl.source == "tuned"
    assert torch.equal(got, ops.attention(q, k, v, tune=False))
    assert torch.equal(got, flash_attention(q, k, v, bq=16, bkv=128))
    want = jops.attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in (q, k, v)), tune=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    qd, kc, vc = _bf16((2, 6, 64), 3), _bf16((2, 256, 2, 64), 4), \
        _bf16((2, 256, 2, 64), 5)
    pos = torch.as_tensor([100, 255], dtype=torch.int32)
    dec = ops.decode_attention(qd, kc, vc, pos, tune=True)
    dpl = [p for p in ops.attn_plans() if p.kernel == "flash_decode"][0]
    assert dpl.bkv == 256 and dpl.source == "tuned"
    assert torch.equal(dec, flash_decode(qd, kc, vc, pos, bkv=256))
    jdec = jops.decode_attention(*(jnp.asarray(t.float().numpy(),
                                               jnp.bfloat16)
                                   for t in (qd, kc, vc)),
                                 jnp.asarray(pos.numpy()), tune=True)
    np.testing.assert_allclose(dec.float().numpy(),
                               np.asarray(jdec, np.float32),
                               atol=2e-2, rtol=2e-2)


# ----------------------------------------------- the compiled CTA shapes

@pytest.mark.parametrize("b,sq,hq,hkv,d", [
    (1, 45, 15, 5, 64), (2, 30, 4, 2, 120), (1, 40, 16, 1, 256),
    (3, 1, 16, 16, 64)])
def test_every_compiled_shape_covers_each_row_once(b, sq, hq, hkv, d):
    want = {(bi, p, h): 1 for bi in range(b) for p in range(sq)
            for h in range(hq)}
    for bq, bkv in b3_blocks(d):
        shape = cta_shape(b, sq, hq, hkv, d, torch.bfloat16, bq, bkv)
        assert shape.rows == bq and shape.smem_bytes <= 227 * 1024
        seen = {}
        for x in range(shape.ctas):
            for r in cta_rows(shape, x, b, sq, hq, hkv):
                seen[r] = seen.get(r, 0) + 1
        assert seen == want, (bq, bkv)


@pytest.mark.parametrize("s,hq,hkv,d,window", [(70, 6, 2, 64, 0),
                                               (40, 4, 1, 256, 24)])
def test_emulated_rows_do_not_depend_on_the_rows_a_cta(s, hq, hkv, d,
                                                       window):
    (_, q), (_, k), (_, v) = _inputs(1, s, hq, hkv, d, 5)
    rows = sorted({bq for bq, _ in b3_blocks(d)})
    base = emulate(q, k, v, window=window, rows=rows[0])
    for r in rows[1:]:
        assert torch.equal(emulate(q, k, v, window=window, rows=r), base), r


def test_uncompiled_blocks_raise_naming_the_compiled_set():
    q = torch.zeros((1, 8, 2, 256), dtype=torch.bfloat16)
    for kw in (dict(bq=128), dict(bkv=128), dict(bq=24)):
        with pytest.raises(ValueError, match="compiled"):
            flash_attention(q, q, q, **kw)
    with pytest.raises(ValueError, match=r"compiled: \[64, 128\]"):
        flash_decode(q[:, 0], q, q, 0, bkv=256)
    with pytest.raises(ValueError, match="does not compile"):
        ops.attn_plan(ops.AttnSpec(bq=128), (1, 8, 8, 2, 2, 256),
                      device=CPU)
    # the f32 body's one shape is accepted as asked
    f = torch.zeros((1, 8, 2, 64))
    assert flash_attention(f, f, f, bq=16).shape == f.shape
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dataclasses.replace(ops.AttnSpec(), tune=True).key == \
            ops.AttnSpec().key
    assert json.dumps(autotune._blocks_dict(None, 64)) == \
        '{"bq": null, "bkv": 64}'
