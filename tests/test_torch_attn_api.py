"""The port's attention operator API against the JAX package's, on the
CPU.

* ``AttnSpec``: validation (the same errors, word for word) and keys.
* ``AttnProblem`` and ``attn_traffic`` on the ``TPU_V5E`` sheet: the
  JAX package's numbers to a relative 1e-12, every kernel family and
  the decode KV billing of ``tests/test_attn_api.py`` included; on the
  ``HOPPER_H100`` sheet the footprint of the kernel that runs.
* The plan cache (counters, device scoping, a one-shot repeat resolving
  no plan), operand checks, ``explain()``, the ``attn.plan`` /
  ``attn.execute`` fields, block overrides.
* The one autograd Function in all three modes against ``jax.grad``
  through ``repro.ops`` (f32, 1e-5), the deprecated shims bit for bit.
"""

import dataclasses
import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro import telemetry as jtel
from repro.core.hardware import TPU_V5E as J_TPU
from repro.kernels import attn_api as jattn
from repro_torch import ops, telemetry
from repro_torch.core.hardware import HOPPER_H100, TPU_V5E
from repro_torch.kernels import attn_api
from repro_torch.kernels import ops as legacy
from repro_torch.kernels.flash_attention import (b3_blocks, cta_shape,
                                                 decode_grid,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import (flash_decode_paged_plain,
                                              flash_decode_plain)
from repro_torch.telemetry import Recorder
from repro_torch.tune import calibrate

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_plan_caches(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    attn_api.attn_plan_cache_clear()
    jattn.attn_plan_cache_clear()
    yield
    attn_api.attn_plan_cache_clear()
    jattn.attn_plan_cache_clear()
    telemetry.disable()
    jtel.disable()


def _rand(shape, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    return torch.as_tensor(x).to(dtype)


def _qkv(b=1, sq=40, skv=40, hq=4, hkv=2, d=16, dtype=torch.float32):
    return (_rand((b, sq, hq, d), 0, dtype), _rand((b, skv, hkv, d), 1, dtype),
            _rand((b, skv, hkv, d), 2, dtype))


def _decode_ops(b=2, skv=64, hq=4, hkv=2, d=16, dtype=torch.float32):
    return (_rand((b, hq, d), 0, dtype), _rand((b, skv, hkv, d), 1, dtype),
            _rand((b, skv, hkv, d), 2, dtype),
            torch.as_tensor([skv // 2, skv - 1][:b], dtype=torch.int32))


def _paged_ops(dtype=torch.float32):
    q, kc, vc, pos = _decode_ops(dtype=dtype)
    kp, vp = kc.reshape(8, 16, 2, 16), vc.reshape(8, 16, 2, 16)
    tbl = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    return q, kp, vp, tbl, pos


# ------------------------------------------------------------ AttnSpec

SPECS = {
    "default": {},
    "decode gqa": dict(mode="decode", group=4),
    "paged window": dict(mode="decode_paged", window=4096, group=4),
    "prefill window f32": dict(window=64, q_dtype="float32",
                               kv_dtype="float32"),
    "full mqa": dict(causal=False, group=8),
    "blocks": dict(bq=256, bkv=128),
    "bq only": dict(bq=64),
    "f16": dict(q_dtype="float16", kv_dtype="float16"),
    "bad mode": dict(mode="chunked"),
    "bad window": dict(window=-1),
    "bad group": dict(group=0),
    "noncausal decode": dict(mode="decode", causal=False),
    "noncausal paged": dict(mode="decode_paged", causal=False),
    "noncausal window": dict(causal=False, window=128),
    "int q": dict(q_dtype="int8"),
    "int kv": dict(kv_dtype="int32"),
    "kv_quant": dict(kv_quant=True),
    "paged blocks": dict(mode="decode_paged", bkv=256),
    "bq 100": dict(bq=100),
    "bkv 64": dict(bkv=64),
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_spec_validation_and_keys_equal_the_reference(case):
    kw = SPECS[case]
    try:
        want = jops.AttnSpec(**kw).key
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ops.AttnSpec(**kw)
        assert str(got.value) == str(e)
        return
    spec = ops.AttnSpec(**kw)
    assert spec.key == want
    assert hash(spec) == hash(ops.AttnSpec(**kw))


def test_for_operands_reads_group_and_dtypes():
    q, k, _ = _qkv(hq=8, hkv=2, dtype=torch.bfloat16)
    spec = ops.AttnSpec.for_operands(q, k, window=16)
    assert (spec.group, spec.q_dtype, spec.window) == (4, "bfloat16", 16)
    assert spec.key == jops.AttnSpec(group=4, window=16).key
    with pytest.raises(ValueError, match="multiple"):
        ops.AttnSpec.for_operands(q, k[:, :, :1].expand(-1, -1, 3, -1))


# ------------------------------------------- cost model on the TPU sheet

PROBLEMS = [
    dict(mode="prefill", b=1, sq=300, skv=300, hq=15, hkv=5, d=64),
    dict(mode="prefill", b=2, sq=64, skv=160, hq=8, hkv=2, d=120,
         window=32),
    dict(mode="prefill", b=1, sq=40, skv=40, hq=4, hkv=4, d=16,
         causal=False, q_dtype="float32", kv_dtype="float32"),
    dict(mode="decode", b=4, sq=1, skv=32768, hq=15, hkv=5, d=64),
    dict(mode="decode", b=8, sq=1, skv=8192, hq=32, hkv=8, d=120,
         window=4096),
    dict(mode="decode_paged", b=4, sq=1, skv=256 * 128, hq=15, hkv=5,
         d=64, page_size=128),
    dict(mode="decode_paged", b=8, sq=1, skv=512 * 16, hq=32, hkv=8,
         d=120, window=4096, page_size=16),
]
FAMILIES = [("flash_attention", 128, 512), ("flash_attention", None, None),
            ("attention_blocked", 512, 1024), ("xla_ref", None, None),
            ("xla_decode", None, None), ("xla_decode_paged", None, None),
            ("flash_decode", None, 512), ("flash_decode_paged", None, None)]


@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_problem_and_traffic_equal_the_reference_on_the_tpu_sheet(i):
    kw = PROBLEMS[i]
    p, jp = attn_api.AttnProblem(**kw), jattn.AttnProblem(**kw)
    assert p.attended() == jp.attended()
    for name in ("flops", "q_bytes", "o_bytes"):
        assert getattr(p, name) == pytest.approx(getattr(jp, name),
                                                 rel=1e-12)
    assert p.logits_bytes() == jp.logits_bytes()
    assert p.kv_bytes() == jp.kv_bytes()
    if kw["mode"] == "prefill":
        for bq in (8, 64, 128, 4096):
            assert p.kv_bytes(bq) == jp.kv_bytes(bq)
    for kernel, bq, bkv in FAMILIES:
        t = attn_api.attn_traffic(p, kernel, bq, bkv, chip=TPU_V5E)
        jt = jattn.attn_traffic(jp, kernel, bq, bkv, chip=J_TPU)
        for f in ("hbm_bytes", "flops", "t_compute", "t_memory",
                  "arithmetic_intensity", "t_model"):
            assert getattr(t, f) == pytest.approx(getattr(jt, f),
                                                  rel=1e-12), (kernel, f)
        assert t.bound == jt.bound


def test_decode_kv_billing_matches_the_reference_plans(monkeypatch):
    """``tests/test_attn_api.py``'s decode-32k and paged billing: the
    port's plan bills the same kv bytes (true positions, page-rounded)
    plus q and o, as the JAX plan of the flash decode kernels does
    (``interpret``: the ``ref`` mode plans the XLA paths)."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    for spec_kw, shapes in ((dict(mode="decode", group=3),
                             (4, 32768, 15, 5, 64)),
                            (dict(mode="decode_paged", group=3),
                             (4, 256, 128, 15, 5, 64))):
        pl = ops.attn_plan(ops.AttnSpec(**spec_kw), shapes, device=CPU)
        jpl = jops.attn_plan(jops.AttnSpec(**spec_kw), shapes)
        assert pl.hbm_bytes == pytest.approx(jpl.hbm_bytes, rel=1e-12)
        assert pl.flops == pytest.approx(jpl.flops, rel=1e-12)
        assert pl.shape_key == jpl.shape_key
        assert pl.traffic.bound == "memory"
        assert ("page-rounded" if pl.page_size else "true positions") \
            in pl.explain()


# -------------------------------------- plans on the HOPPER_H100 sheet

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_each_mode_plans_its_kernel_and_footprint(dtype):
    """Prefill plans B3 at every sq (no sq >= 128 gate, no fallback),
    decode B4, paged decode B5, each untuned at its compiled default
    design and the shared memory its CTA allocates; the search's ranked
    candidates lead with that default and are the compiled shapes."""
    g = dict(group=4, q_dtype=dtype, kv_dtype=dtype)
    bf16 = dtype == "bfloat16"
    for sq in (1, 64, 5000):
        pl = ops.attn_plan(ops.AttnSpec(window=4096, **g),
                           (1, sq, sq, 32, 8, 120), device=CPU)
        shape = cta_shape(1, sq, 32, 8, 120, getattr(torch, dtype))
        assert (pl.kernel, pl.fallback_reason) == ("flash_attention", None)
        assert (pl.bq, pl.bkv) == ((64, 64) if bf16 else (16, 32))
        assert pl.vmem_bytes == shape.smem_bytes <= HOPPER_H100.vmem_bytes
        assert pl.footprint.ctas == shape.ctas
    dec = ops.attn_plan(ops.AttnSpec(mode="decode", **g),
                        (8, 4096, 32, 8, 120), device=CPU)
    grid = decode_grid(8, 32, 8, 4096, 120, getattr(torch, dtype))
    assert (dec.kernel, dec.bq, dec.bkv) == \
        ("flash_decode", None, 64 if bf16 else 32)
    assert (dec.footprint.ctas, dec.footprint.merge_ctas) == \
        (grid.ctas, grid.merge_ctas)
    assert dec.footprint.scratch_bytes == \
        4 * (grid.acc_floats + grid.ml_floats)
    paged = ops.attn_plan(ops.AttnSpec(mode="decode_paged", window=4096,
                                       **g), (8, 512, 16, 32, 8, 120),
                          device=CPU)
    assert (paged.kernel, paged.bq, paged.bkv, paged.page_size) == \
        ("flash_decode_paged", None, None, 16)
    designs = ops.attn_solve_topk(ops.AttnSpec(**g), (1, 300, 300, 32, 8,
                                                      120), k=8)
    compiled = b3_blocks(120, getattr(torch, dtype))
    assert [(d.bq, d.bkv) for d in designs][0] == (pl.bq, pl.bkv)
    assert sorted((d.bq, d.bkv) for d in designs) == sorted(compiled)
    assert len(compiled) == (8 if bf16 else 1)
    ts = [d.traffic.t_model for d in designs[1:]]
    assert ts == sorted(ts)


def test_b3_bills_the_staging_of_its_ctas():
    """On the card B3 stages its kv head's blocks once a CTA of 64 (q
    position, q head) rows: group 4 means 16 positions a CTA, billed
    per kv head, not per q head as the TPU sheet bills."""
    p = attn_api.AttnProblem(mode="prefill", b=1, sq=256, skv=256, hq=32,
                             hkv=8, d=128)
    t = attn_api.attn_traffic(p, "flash_attention", 64, 64)
    per_tok = 2 * 128 * 2
    toks = sum(16 * (i + 1) for i in range(16))      # 16 tiles of 16 rows
    assert t.hbm_bytes == p.q_bytes + p.o_bytes + 8 * toks * per_tok


def test_footprint_past_the_kernels_tiles_is_said_loudly():
    pl = ops.attn_plan(ops.AttnSpec(mode="decode", group=32),
                       (1, 64, 32, 1, 64), device=CPU)
    assert "group 32 > 16" in pl.fallback_reason
    assert "fallback" in pl.explain()
    # the kernels take recurrentgemma-9b's head of 256, not a wider one
    fits = ops.attn_plan(ops.AttnSpec(), (1, 8, 8, 2, 2, 256), device=CPU)
    assert fits.fallback_reason is None
    wide = ops.attn_plan(ops.AttnSpec(), (1, 8, 8, 2, 2, 272), device=CPU)
    assert "head_dim 272 > 256" in wide.fallback_reason


def test_block_override_other_than_the_design_raises():
    """The kernels' blocks are launch-time shapes: an override the
    kernel compiles plans as asked (the other block at its default), one
    it does not compile raises ValueError naming the compiled set (and a
    one-shot with one does too: B4's f32 body walks 32-key blocks)."""
    shapes = (1, 300, 300, 2, 2, 64)
    same = ops.attn_plan(ops.AttnSpec(bq=64), shapes, device=CPU)
    assert (same.bq, same.bkv) == (64, 64)
    for kw, blocks in ((dict(bq=128), (128, 64)), (dict(bkv=128), (64, 128)),
                       (dict(bq=256, bkv=128), None)):
        if blocks is None:
            with pytest.raises(ValueError, match="compiled"):
                ops.attn_plan(ops.AttnSpec(**kw), shapes, device=CPU)
            continue
        pl = ops.attn_plan(ops.AttnSpec(**kw), shapes, device=CPU)
        assert (pl.bq, pl.bkv) == blocks and pl.source == "analytic"
        assert pl.vmem_bytes == cta_shape(1, 300, 2, 2, 64, torch.bfloat16,
                                          *blocks).smem_bytes
    q, kc, vc, pos = _decode_ops()
    with pytest.raises(ValueError, match="compiled"):
        ops.decode_attention(q, kc, vc, pos, bkv=256)


def test_plans_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default plans for it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.attn_plan(ops.AttnSpec(), (1, 8, 8, 2, 2, 16))


# --------------------------------------------------------- plan cache

def test_plan_cache_counters_and_one_shot_repeats(monkeypatch):
    spec = ops.AttnSpec(mode="decode", group=2, q_dtype="float32",
                        kv_dtype="float32")
    p1 = ops.attn_plan(spec, (2, 64, 4, 2, 16), device=CPU)
    assert p1 is ops.attn_plan(spec, (2, 64, 4, 2, 16), device="cpu")
    assert p1.dispatch == "cpu"
    assert tuple(ops.attn_plan_cache_info()) == (1, 1, 1)
    q, kc, vc, pos = _decode_ops()
    first = ops.decode_attention(q, kc, vc, pos)      # its own plan key
    assert tuple(ops.attn_plan_cache_info()) == (1, 2, 1)

    def no_resolve(*a, **k):
        raise AssertionError("a one-shot repeat resolved a plan")
    monkeypatch.setattr(attn_api, "_resolve", no_resolve)
    monkeypatch.setattr(attn_api, "attn_plan", no_resolve)
    again = ops.decode_attention(q, kc, vc, pos)
    assert torch.equal(first, again)
    assert tuple(ops.attn_plan_cache_info()) == (1, 3, 1)
    ops.attn_plan_cache_clear()
    assert tuple(ops.attn_plan_cache_info()) == (0, 0, 0)


def test_one_shots_run_the_plain_versions_on_the_cpu():
    """Each one-shot plans its kernel and, for CPU tensors, runs that
    kernel's plain version once a call."""
    counters = (flash_attention_plain, flash_decode_plain,
                flash_decode_paged_plain)
    before = [f.launches for f in counters]
    q, k, v = _qkv()
    ops.attention(q, k, v, window=8)
    ops.decode_attention(*_decode_ops())
    ops.decode_attention_paged(*_paged_ops())
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    assert [pl.kernel for pl in ops.attn_plans()] == [
        "flash_attention", "flash_decode", "flash_decode_paged"]


def test_execute_rejects_operands_that_mismatch_the_plan():
    q, kc, vc, pos = _decode_ops()
    pl = ops.attn_plan(ops.AttnSpec(mode="decode", group=2,
                                    q_dtype="float32", kv_dtype="float32"),
                       (2, 64, 4, 2, 16), device=CPU)
    with pytest.raises(ValueError, match="pos"):
        ops.attn_execute(pl, q, kc, vc)
    with pytest.raises(ValueError, match="q shape"):
        ops.attn_execute(pl, q[:1], kc, vc, pos=pos)
    with pytest.raises(ValueError, match="k shape"):
        ops.attn_execute(pl, q, kc[:, :32], vc, pos=pos)
    with pytest.raises(ValueError, match="dtype"):
        ops.attn_execute(pl, q.to(torch.bfloat16), kc, vc, pos=pos)
    with pytest.raises(ValueError, match="prefill-only"):
        ops.attn_execute(pl, q, kc, vc, pos=pos, scale=0.5)
    meta = dataclasses.replace(pl, dispatch="cuda:card")
    with pytest.raises(ValueError, match="resolved for cuda:card"):
        ops.attn_execute(meta, q, kc, vc, pos=pos)


def test_explain_names_the_kernel_its_source_and_the_plain_path():
    shapes = {"prefill": (1, 300, 300, 32, 8, 120),
              "decode": (8, 4096, 32, 8, 120),
              "decode_paged": (8, 512, 16, 32, 8, 120)}
    names = {"prefill": ("B3 flash_attention", "csrc/flash_attention.cu"),
             "decode": ("B4 flash_decode", "csrc/flash_decode.cu"),
             "decode_paged": ("B5 flash_decode_paged",
                              "csrc/flash_decode_paged.cu")}
    for mode, shape in shapes.items():
        text = ops.attn_plan(ops.AttnSpec(mode=mode, group=4), shape,
                             device=CPU).explain()
        for part in names[mode] + ("on CUDA tensors", "plain version",
                                   "on CPU tensors", "[cpu]",
                                   "compiled shape",
                                   "source   : analytic"):
            assert part in text, (mode, part)
        assert "fallback" not in text


# ----------------------------------------------------------- telemetry

def test_plan_and_execute_events_carry_the_reference_fields():
    rec = telemetry.enable(Recorder())
    q, kc, vc, pos = _decode_ops()
    for _ in range(3):
        ops.decode_attention(q, kc, vc, pos)
    spec = ops.AttnSpec(mode="decode", group=2, q_dtype="float32",
                        kv_dtype="float32")
    ops.attn_plan(spec, (2, 64, 4, 2, 16), device=CPU)
    telemetry.disable()
    plans = [e for e in rec.events if e["name"] == "attn.plan"]
    assert [e["attrs"]["cache"] for e in plans] == ["miss", "hit"]
    execs = [e for e in rec.events if e["name"] == "attn.execute"]
    assert len(execs) == 1                      # once a plan and recorder
    assert execs[0]["attrs"]["kernel"] == "flash_decode"

    jrec = jtel.enable(jtel.Recorder())
    jq, jkc, jvc = (jnp.asarray(t.numpy()) for t in (q, kc, vc))
    jops.decode_attention(jq, jkc, jvc, jnp.asarray(pos.numpy()))
    jtel.disable()
    (jplan,) = [e for e in jrec.events if e["name"] == "attn.plan"]
    (jexec,) = [e for e in jrec.events if e["name"] == "attn.execute"]
    assert set(plans[0]["attrs"]) == set(jplan["attrs"])
    assert set(execs[0]["attrs"]) == set(jexec["attrs"]) | {"dispatch"}
    for f in ("spec", "shape", "source", "bound", "flops"):
        assert plans[0]["attrs"][f] == jplan["attrs"][f], f
    assert rec.counter("attn.plan_cache.miss").value == 1
    assert rec.counter("attn.plan_cache.hit").value == 1


def test_calibration_clears_the_attention_plans():
    """``calibrate.apply`` and ``clear`` drop the attention plans, which
    price at the same rates: a plan after ``apply`` reads the fitted
    bandwidth."""
    ops.attn_plan(ops.AttnSpec(), (1, 8, 8, 2, 2, 16), device=CPU)
    fit = calibrate.CalibrationFit(mode="cpu", n_samples=3, t0_us=1.0,
                                   hbm_bw=1e11, peak_flops=1e12, r2=0.9)
    try:
        assert calibrate.apply({"cpu": fit}, "cpu") is fit
        assert ops.attn_plan_cache_info().entries == 0
        slow = ops.attn_plan(ops.AttnSpec(), (1, 8, 8, 2, 2, 16),
                             device=CPU)
        assert slow.traffic.t_memory == pytest.approx(slow.hbm_bytes / 1e11)
    finally:
        calibrate.clear()
    assert ops.attn_plan_cache_info().entries == 0


# ------------------------------------------------ gradients, one Function

def test_exactly_one_autograd_function_in_attn_api():
    src = inspect.getsource(attn_api)
    assert src.count("(torch.autograd.Function)") == 1


@pytest.mark.parametrize("mode", ["prefill", "decode", "decode_paged"])
def test_grads_through_the_one_function_match_jax(mode):
    """f32: forward (the kernels' plain versions) and the recompute
    backward against ``jax.grad`` through ``repro.ops`` (whose backward
    recomputes the same reference composition), atol = rtol = 1e-5."""
    if mode == "prefill":
        ins = _qkv(sq=33, skv=50)
        kw = dict(window=12, q_offset=17)
        run = (lambda q, k, v: ops.attention(q, k, v, **kw),
               lambda q, k, v: jops.attention(q, k, v, **kw))
        extra = ()
    elif mode == "decode":
        *ins, pos = _decode_ops()
        run = (lambda q, k, v: ops.decode_attention(q, k, v, pos, window=20),
               lambda q, k, v: jops.decode_attention(
                   q, k, v, jnp.asarray(pos.numpy()), window=20))
        extra = (pos,)
    else:
        q, kp, vp, tbl, pos = _paged_ops()
        ins = (q, kp, vp)
        jt, jpos = jnp.asarray(tbl.numpy()), jnp.asarray(pos.numpy())
        run = (lambda q, k, v: ops.decode_attention_paged(q, k, v, tbl, pos,
                                                          window=40),
               lambda q, k, v: jops.decode_attention_paged(q, k, v, jt, jpos,
                                                           window=40))
        extra = (tbl,)
    g = _rand(tuple(run[0](*ins).shape), 9)
    jins = [jnp.asarray(t.numpy()) for t in ins]
    jg = jax.grad(lambda *a: jnp.sum(run[1](*a) * jnp.asarray(g.numpy())),
                  argnums=(0, 1, 2))(*jins)
    tins = [t.clone().requires_grad_() for t in ins]
    out = run[0](*tins)
    (out * g).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(run[1](*jins)), atol=1e-5,
                               rtol=1e-5)
    for t, j, name in zip(tins, jg, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    for t in extra:
        assert not t.requires_grad


def test_grad_mode_off_dispatches_without_the_function(monkeypatch):
    calls = []
    monkeypatch.setattr(attn_api._AttnCore, "apply",
                        lambda *a: calls.append(a))
    q, kc, vc, pos = _decode_ops()
    with torch.no_grad():
        out = ops.decode_attention(q, kc, vc, pos)
    assert out is not None and not calls
    ops.decode_attention(q, kc, vc, pos)
    assert len(calls) == 1


# ------------------------------------------------- the deprecated shims

def _shim_pairs():
    q, k, v = _qkv(dtype=torch.bfloat16)
    qd, kc, vc, pos = _decode_ops(dtype=torch.bfloat16)
    _, kp, vp, tbl, _ = _paged_ops(dtype=torch.bfloat16)
    a = _rand((8, 32), 5, torch.bfloat16)
    w, w2 = _rand((32, 24), 6, torch.bfloat16), _rand((32, 24), 7,
                                                      torch.bfloat16)
    return [
        (lambda: legacy.attention(q, k, v, window=16),
         lambda: ops.attention(q, k, v, window=16)),
        (lambda: legacy.decode_attention(qd, kc, vc, pos),
         lambda: ops.decode_attention(qd, kc, vc, pos)),
        (lambda: legacy.decode_attention_paged(qd, kp, vp, tbl, pos),
         lambda: ops.decode_attention_paged(qd, kp, vp, tbl, pos)),
        (lambda: legacy.gemm(a, w), lambda: ops.gemm(a, w)),
        (lambda: legacy.gemm_fused(a, w, activation="gelu"),
         lambda: ops.gemm(a, w, activation="gelu")),
        (lambda: legacy.gemm_gated(a, w, w2),
         lambda: ops.gemm(a, w, b2=w2, activation="silu")),
    ]


def test_shims_are_bit_identical_and_warn():
    for old, new in _shim_pairs():
        with pytest.warns(DeprecationWarning, match="repro_torch.ops"):
            got = old()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            want = new()
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_ops_exports_the_attention_api():
    for name in ("AttnSpec", "AttnPlan", "AttnProblem", "attn_plan",
                 "attn_execute", "attn_plans", "attn_plan_cache_info",
                 "attn_plan_cache_clear", "attn_solve_topk", "attention",
                 "decode_attention", "decode_attention_paged",
                 "BLOCKED_ATTN_THRESHOLD", "AttnPlanCacheInfo", "TunedInfo",
                 "quantize_int8", "dequantize"):
        assert hasattr(ops, name), name
