"""The port's telemetry against the JAX package's, on the CPU.

* The recorder: span nesting, the span stack after an exception, request
  tracks, counters (device-tensor counts folded at the snapshot) and
  gauges, the disabled mode's shared singletons (nothing allocated), and
  the JSONL / Chrome-trace exports, whose every line carries the
  reference's fields when both recorders see the same calls.
* The operator API's ``gemm.plan`` / ``gemm.execute`` events and the
  model-against-measured report on the CPU's plain versions.
* Both packages' engines serve the same bridged smoke parameters and
  the same requests with telemetry on (smollm-360m-smoke and
  qwen3-moe-235b-a22b-smoke, dense and paged, the MoE one at a capacity
  that drops): the same multiset of serve event and span names, equal
  serve and MoE counters, the same gauge sequences, the same
  (spec key, m, k, n) set in ``gemm.execute`` and the same decode plan
  on the decode spans' ``attn_plan`` (the reference under
  ``REPRO_KERNELS=ref`` plans its XLA decode paths where the port plans
  B4 / B5: ``ATTN_KERNEL_NAMES``).
* ``launch/train.py --telemetry --device cpu`` writes one
  ``train.step`` span a step.
"""

import ast
import collections
import dataclasses
import json
import pathlib
import time

import jax
import numpy as np
import pytest
import torch

from repro import telemetry as jtel
from repro.configs.base import get_smoke_config as j_smoke
from repro.kernels import api as japi
from repro.kernels import attn_api as jattn
from repro.models import transformer as JT
from repro_torch import ops, telemetry
from repro_torch.bridge import from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import api
from repro_torch.launch import train as train_cli
from repro_torch.serve.engine import ACCEPTANCE_TRACE, DecodeEngine, \
    acceptance_requests
from repro_torch.telemetry import TRACK_TID_BASE, Recorder
from repro_torch.telemetry import report as treport

CPU = torch.device("cpu")
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture
def rec():
    """A fresh recorder for the test, uninstalled afterwards."""
    r = telemetry.enable(Recorder())
    yield r
    telemetry.disable()


@pytest.fixture(autouse=True)
def _always_disabled_after():
    yield
    telemetry.disable()
    jtel.disable()


# ---------------------------------------------------------------- spans

def test_span_nesting_and_attrs(rec):
    with telemetry.span("outer", a=1) as outer:
        with telemetry.span("inner") as inner:
            inner.set(b=2)
        assert inner.parent == outer.sid
        assert inner.depth == outer.depth + 1
    spans = {e["name"]: e for e in rec.events if e["type"] == "span"}
    assert set(spans) == {"outer", "inner"}
    assert rec.events[0]["name"] == "inner"       # children close first
    assert spans["outer"]["attrs"] == {"a": 1}
    assert spans["inner"]["attrs"] == {"b": 2}
    assert spans["inner"]["parent"] == spans["outer"]["sid"]
    assert spans["inner"]["ts"] >= spans["outer"]["ts"]
    assert spans["inner"]["dur"] <= spans["outer"]["dur"]


@pytest.mark.parametrize("value", [
    torch.ones(4), [torch.ones(2), (torch.zeros(1),)], {"a": torch.ones(1)},
    42, None])
def test_span_sync_passes_cpu_values_through(rec, value):
    """CPU work is done when its op returns: sync returns its argument
    and the exit waits for nothing (the card's wait is a card test)."""
    with telemetry.span("work") as sp:
        out = sp.sync(value)
    assert out is value
    (ev,) = [e for e in rec.events if e["type"] == "span"]
    assert ev["dur"] >= 0


def test_span_stack_survives_exception(rec):
    with pytest.raises(RuntimeError):
        with telemetry.span("outer"):
            with telemetry.span("inner"):
                raise RuntimeError("boom")
    with telemetry.span("after") as sp:
        pass
    assert sp.depth == 0 and sp.parent is None


def test_complete_span_gets_request_track(rec):
    t = time.perf_counter()
    telemetry.complete_span("serve.request", t, t + 0.5, tid=3, rid=3)
    (ev,) = rec.events
    assert ev["tid"] == TRACK_TID_BASE + 3
    assert abs(ev["dur"] - 0.5) < 1e-6


def test_counters_and_gauges(rec):
    telemetry.counter("tok").add(3)
    telemetry.counter("tok").add()
    assert telemetry.counter("tok") is rec.counter("tok")
    assert rec.counter("tok").value == 4
    g = telemetry.gauge("slots")
    g.set(2)
    g.set(2)          # unchanged -> no new timeline sample
    g.set(1)
    samples = [e for e in rec.events if e["type"] == "gauge"]
    assert [s["value"] for s in samples] == [2.0, 1.0]
    snap = rec.snapshot()
    assert snap["counters"]["tok"] == 4
    assert snap["gauges"]["slots"] == 1.0
    assert {"entries", "hits", "misses"} <= set(snap["plan_cache"])
    assert {"entries", "measurements"} <= set(snap["tuning_cache"])


def test_device_tensor_counts_fold_at_the_snapshot(rec):
    """A count computed as a tensor accumulates without a host read and
    joins the counter's value at the snapshot."""
    c = telemetry.counter("rows")
    c.add(2)
    c.add(torch.tensor(5))
    c.add(torch.tensor(7))
    assert c.value == 2                       # not read yet
    assert rec.snapshot()["counters"]["rows"] == 14
    assert c.value == 14 and isinstance(c.value, int)
    assert rec.snapshot()["counters"]["rows"] == 14   # folded once


def test_disabled_mode_is_allocation_free_noop():
    assert telemetry.recorder() is None and not telemetry.enabled()
    assert telemetry.span("a", x=1) is telemetry.span("b")
    assert telemetry.counter("a") is telemetry.counter("b")
    assert telemetry.gauge("a") is telemetry.gauge("b")
    with telemetry.span("a") as sp:
        v = sp.sync(42)
    assert v == 42 and sp.set(k=1) is sp
    telemetry.counter("a").add(5)
    telemetry.counter("a").add(torch.tensor(5))
    telemetry.gauge("a").set(5)
    telemetry.event("a", x=1)
    telemetry.complete_span("a", 0.0, 1.0)
    assert telemetry.snapshot() is None
    assert telemetry.export("/nonexistent/should-not-write") is None


def test_disabled_hot_path_allocates_no_python_objects():
    """Over many disabled calls the interpreter's allocated block count
    does not grow (the singletons are shared; nothing is kept)."""
    import sys

    def burst():
        for _ in range(2000):
            with telemetry.span("x", a=1) as sp:
                sp.sync(None)
            telemetry.counter("c").add(1)
            telemetry.gauge("g").set(1.0)
            telemetry.event("e")

    burst()
    before = sys.getallocatedblocks()
    burst()
    assert sys.getallocatedblocks() - before < 50


# -------------------------------------------------------------- exports

def _same_calls(tel, rec_cls):
    """Drive one recorder through a fixed sequence of calls."""
    r = tel.enable(rec_cls())
    with tel.span("work", n=1):
        tel.event("mark", k="v")
        with tel.span("inner"):
            pass
    tel.gauge("g").set(7)
    tel.counter("c").add(2)
    tel.complete_span("serve.request", r._t0, r._t0 + 0.1, tid=0, rid=0)
    tel.disable()
    return r


def test_jsonl_has_the_reference_fields_line_for_line(tmp_path):
    mine = _same_calls(telemetry, Recorder)
    ref = _same_calls(jtel, jtel.Recorder)
    a = [json.loads(x) for x in open(mine.export_jsonl(
        str(tmp_path / "t.jsonl")))]
    b = [json.loads(x) for x in open(ref.export_jsonl(
        str(tmp_path / "r.jsonl")))]
    assert len(a) == len(b)
    assert a[0]["schema_version"] == b[0]["schema_version"] == \
        telemetry.SCHEMA_VERSION
    assert set(a[0]) == set(b[0])
    assert set(a[0]["snapshot"]) == set(b[0]["snapshot"])
    assert a[0]["snapshot"]["counters"] == b[0]["snapshot"]["counters"]
    assert a[0]["snapshot"]["gauges"] == b[0]["snapshot"]["gauges"]
    for x, y in zip(a[1:], b[1:]):
        assert set(x) == set(y)
        assert (x["type"], x["name"]) == (y["type"], y["name"])
        assert x.get("attrs") == y.get("attrs")
        for key in ("sid", "parent", "depth", "tid", "value"):
            assert x.get(key) == y.get(key)


def test_chrome_trace_has_the_reference_fields(tmp_path):
    mine = _same_calls(telemetry, Recorder)
    ref = _same_calls(jtel, jtel.Recorder)
    _, path = mine.export(str(tmp_path / "t"))
    trace = json.loads(open(path).read())
    want = ref.chrome_trace()
    assert set(trace) == set(want)
    assert len(trace["traceEvents"]) == len(want["traceEvents"])
    for x, y in zip(trace["traceEvents"], want["traceEvents"]):
        assert set(x) == set(y)
        assert (x["ph"], x["name"]) == (y["ph"], y["name"])
        assert x.get("args") == y.get("args") or x["ph"] == "M"
    phases = {e["ph"] for e in trace["traceEvents"]}
    assert {"M", "X", "i", "C"} <= phases
    names = [e for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"]
    assert any(e["args"]["name"] == "request 0" for e in names)


# ----------------------------------------------- kernel plan/execute

def test_plan_events_carry_modeled_traffic(rec):
    ops.plan_cache_clear()
    spec = ops.GemmSpec()
    ops.plan(spec, (64, 256, 128))
    ops.plan(spec, (64, 256, 128))          # cache hit
    plans = [e for e in rec.events if e["name"] == "gemm.plan"]
    assert [p["attrs"]["cache"] for p in plans] == ["miss", "hit"]
    for p in plans:
        a = p["attrs"]
        assert {"spec", "strategy", "tile", "hbm_bytes", "vmem_bytes",
                "flops", "t_model_us", "bound", "source"} <= set(a)
        assert a["hbm_bytes"] > 0 and a["flops"] == 2 * 64 * 256 * 128
        assert a["source"] == "analytic"
    assert rec.counter("gemm.plan_cache.miss").value == 1
    assert rec.counter("gemm.plan_cache.hit").value == 1


def test_plan_event_attrs_equal_the_reference_names(rec, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    ops.plan_cache_clear()
    japi.plan_cache_clear()
    ops.plan(ops.GemmSpec(), (64, 256, 128))
    jrec = jtel.enable(jtel.Recorder())
    try:
        japi.plan(japi.GemmSpec(), (64, 256, 128))
    finally:
        jtel.disable()
    (mine,) = [e for e in rec.events if e["name"] == "gemm.plan"]
    (ref,) = [e for e in jrec.events if e["name"] == "gemm.plan"]
    assert set(mine["attrs"]) == set(ref["attrs"])
    assert mine["attrs"]["spec"] == ref["attrs"]["spec"]


@pytest.mark.parametrize("shape", [(16, 64), (2, 8, 64)])
def test_execute_event_once_per_spec_shape(rec, shape):
    ops.plan_cache_clear()
    x = torch.ones(shape, dtype=torch.bfloat16)
    w = torch.ones((64, 32), dtype=torch.bfloat16)
    for _ in range(3):
        ops.gemm(x, w)
    execs = [e for e in rec.events if e["name"] == "gemm.execute"]
    assert len(execs) == 1
    a = execs[0]["attrs"]
    assert {"spec", "m", "k", "n", "strategy", "mode", "hbm_bytes",
            "flops"} <= set(a)
    assert (a["m"], a["k"], a["n"]) == (16, 64, 32) and a["mode"] == "cpu"
    ops.plan_cache_clear()                   # a new plan reports again
    ops.gemm(x, w)
    assert len([e for e in rec.events if e["name"] == "gemm.execute"]) == 2


def test_execute_event_when_enabled_after_the_first_call():
    """A one-shot plan cached while telemetry was off still reports its
    execution once after telemetry turns on."""
    ops.plan_cache_clear()
    x = torch.ones((4, 64))
    w = torch.ones((64, 32))
    ops.gemm(x, w)
    r = telemetry.enable(Recorder())
    ops.gemm(x, w)
    ops.gemm(x, w)
    execs = [e for e in r.events if e["name"] == "gemm.execute"]
    assert len(execs) == 1 and execs[0]["attrs"]["m"] == 4
    assert not [e for e in r.events if e["name"] == "gemm.plan"]


def test_execute_event_once_per_recorder_over_warm_plans():
    """Each recorder gets its own ``gemm.execute`` for a plan that an
    earlier recorder already reported (a second traced run over a warm
    plan cache), once however many calls it records."""
    ops.plan_cache_clear()
    x = torch.ones((4, 64))
    w = torch.ones((64, 32))
    for _ in range(2):
        r = telemetry.enable(Recorder())
        for _ in range(3):
            ops.gemm(x, w)
        telemetry.disable()
        execs = [e for e in r.events if e["name"] == "gemm.execute"]
        assert [e["attrs"]["m"] for e in execs] == [4]


def test_model_vs_measured_report_on_the_cpu(rec):
    ops.plan_cache_clear()
    pl = ops.plan(ops.GemmSpec(), (16, 128, 128))
    rows = treport.model_vs_measured([pl], iters=2, device="cpu")
    (r,) = rows
    assert r["t_measured_us"] > 0 and r["t_model_us"] > 0
    assert r["mode"] == "cpu" and r["source"] == "analytic"
    # both rounded for display: against the unrounded modeled time,
    # within the achieved column's last place
    assert r["achieved"] == pytest.approx(
        pl.traffic.t_model * 1e6 / r["t_measured_us"], rel=1e-2, abs=1e-5)
    text = treport.render(rows)
    assert "measured" in text and "HOPPER_H100" in text
    s = treport.summarize(rows)
    assert s["n_measured"] == 1 and s["n_skipped"] == 0
    assert [e["name"] for e in rec.events].count("gemm.measured") == 1
    rows = treport.model_vs_measured([pl], max_flops=1, device="cpu")
    assert rows[0]["t_measured_us"] is None
    assert "flops budget" in rows[0]["note"]


def test_report_rows_have_the_reference_columns(rec, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.telemetry import report as jreport
    ops.plan_cache_clear()
    japi.plan_cache_clear()
    pl = ops.plan(ops.GemmSpec(), (16, 128, 128))
    jpl = japi.plan(japi.GemmSpec(), (16, 128, 128))
    (mine,) = treport.model_vs_measured([pl], max_flops=1, device="cpu")
    (ref,) = jreport.model_vs_measured([jpl], max_flops=1)
    assert set(mine) == set(ref)
    assert treport.summarize([mine]) == jreport.summarize([ref])


def test_no_prints_in_library_code():
    """``print`` belongs to launch/ (and the tools); the library reports
    through telemetry or return values."""
    offenders = []
    for path in SRC.rglob("*.py"):
        if "launch" in path.relative_to(SRC).parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                offenders.append(f"{path.relative_to(SRC)}:{node.lineno}")
    assert not offenders, f"print() outside launch/: {offenders}"


# ------------------------------------------- both engines, telemetry on

ENGINES = {
    "smollm-360m": {},
    "qwen3-moe-235b-a22b": {"capacity_factor": 0.5},   # drops in prefill
}


@pytest.fixture(scope="module", params=sorted(ENGINES))
def smoke(request):
    arch = request.param
    over = ENGINES[arch]
    jcfg = dataclasses.replace(j_smoke(arch), **over)
    tcfg = dataclasses.replace(get_smoke_config(arch), **over)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    return arch, jcfg, jparams, tcfg, tparams


def _record(run):
    """(events, snapshot) of one run under a fresh recorder of the
    package whose module ``tel`` is given."""
    tel, fn = run
    r = tel.enable(tel.Recorder())
    try:
        fn()
        snap = r.snapshot()
    finally:
        tel.disable()
    return r.events, snap


#: the reference's decode families under REPRO_KERNELS=ref -> the port's
#: kernels for the same plan
ATTN_KERNEL_NAMES = {"xla_decode": "flash_decode",
                     "xla_decode_paged": "flash_decode_paged"}


def _decode_plans(events, rename=False):
    """The ``attn_plan`` of every decode span, in order, with the
    reference's family names mapped to the port's."""
    out = []
    for e in events:
        if e["type"] == "span" and e["name"] in ("serve.decode_burst",
                                                 "serve.request.decode"):
            key = e["attrs"]["attn_plan"]
            if rename and key is not None:
                head, kernel = key.rsplit("->", 1)
                key = f"{head}->{ATTN_KERNEL_NAMES[kernel]}"
            out.append((e["name"], key))
    return out


def _serve_view(events, snap):
    names = collections.Counter(
        (e["type"], e["name"]) for e in events
        if e["type"] in ("event", "span")
        and e["name"].startswith(("serve.", "moe.")))
    gauges = collections.defaultdict(list)
    for e in events:
        if e["type"] == "gauge":
            gauges[e["name"]].append(e["value"])
    counters = {k: v for k, v in snap["counters"].items()
                if k.startswith(("serve.", "moe."))}
    execs = {(e["attrs"]["spec"], e["attrs"]["m"], e["attrs"]["k"],
              e["attrs"]["n"]) for e in events
             if e["name"] == "gemm.execute"}
    return names, dict(gauges), counters, execs


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engines_emit_the_same_telemetry(smoke, monkeypatch, paged):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.serve.engine import DecodeEngine as JEngine
    from repro.serve.engine import acceptance_requests as j_reqs
    arch, jcfg, jp, tcfg, tp = smoke
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    kw = dict(page_size=16, prefill_chunk=8) if paged else {}
    japi.plan_cache_clear()
    api.plan_cache_clear()
    jattn.attn_plan_cache_clear()
    ops.attn_plan_cache_clear()
    jeng = JEngine(jp, jcfg, batch=2, max_len=max_len, **kw)
    teng = DecodeEngine(tp, tcfg, batch=2, max_len=max_len, device=CPU,
                        **kw)
    out = {}
    jev, jsnap = _record((jtel, lambda: out.setdefault(
        "j", jeng.run(j_reqs(jcfg.vocab)))))
    tev, tsnap = _record((telemetry, lambda: out.setdefault(
        "t", teng.run(acceptance_requests(tcfg.vocab)))))
    j_names, j_gauges, j_counters, j_execs = _serve_view(jev, jsnap)
    t_names, t_gauges, t_counters, t_execs = _serve_view(tev, tsnap)
    assert t_names == j_names
    assert t_gauges == j_gauges
    assert t_counters == j_counters
    assert t_execs == j_execs
    t_plans = _decode_plans(tev)
    assert t_plans == _decode_plans(jev, rename=True)
    kernel = "flash_decode_paged" if paged else "flash_decode"
    assert {k for _, k in t_plans} - {None} == {
        next(f"{p.spec.key}@{p.shape_key}->{p.kernel}"
             for p in ops.attn_plans() if p.kernel == kernel)}
    # the counters agree with the engine's own metrics
    m = teng.metrics
    assert t_counters["serve.decode_steps"] == m["decode_steps"]
    assert t_counters["serve.prefill_tokens"] == m["prefill_tokens"]
    assert t_counters["serve.generated_tokens"] == m["generated_tokens"]
    assert t_counters["serve.completed"] == m["completed"] == \
        len(ACCEPTANCE_TRACE)
    bursts = [e for e in tev if e["name"] == "serve.decode_burst"]
    assert sum(e["attrs"]["steps"] for e in bursts) == m["decode_steps"]
    requests = [e for e in tev if e["name"] == "serve.request"]
    assert sorted(e["attrs"]["rid"] for e in requests) == \
        list(range(len(ACCEPTANCE_TRACE)))
    for r in out["t"]:
        (life,) = [e for e in requests if e["attrs"]["rid"] == r.rid]
        assert life["tid"] == TRACK_TID_BASE + r.rid
        assert life["attrs"]["ttft"] == pytest.approx(r.ttft, abs=1e-9)
    if tcfg.n_experts:
        routed = t_counters["moe.group_sizes"]
        dropped = t_counters["moe.dropped_tokens"]
        # whole prompts drop at this capacity; 8-token chunks never do
        assert (dropped > 0) == (not paged)
        # every MoE layer of every pass routes tokens x top-k
        n_moe = tcfg.repeats * tcfg.layer_pattern.count("moe")
        tokens = m["prefill_tokens"] + 2 * m["decode_steps"]
        assert routed + dropped == tokens * tcfg.top_k * n_moe
    # and the tokens equal the untraced engine's
    again = {r.rid: r.tokens for r in DecodeEngine(
        tp, tcfg, batch=2, max_len=max_len, device=CPU, **kw).run(
        acceptance_requests(tcfg.vocab))}
    for r in out["t"]:
        np.testing.assert_array_equal(r.tokens, again[r.rid])


# ------------------------------------------------------- train launcher

def test_train_cli_writes_one_train_step_span_a_step(tmp_path, capsys):
    ops.plan_cache_clear()
    base = str(tmp_path / "train")
    train_cli.main(["--smoke", "--steps", "3", "--device", "cpu",
                    "--seq-len", "16", "--global-batch", "2",
                    "--telemetry", base])
    out = capsys.readouterr().out
    assert "[train] telemetry:" in out
    lines = [json.loads(x) for x in open(base + ".jsonl")]
    steps = [e for e in lines if e.get("name") == "train.step"]
    assert [e["attrs"]["step"] for e in steps] == [0, 1, 2]
    assert all(e["type"] == "span" and e["dur"] > 0 for e in steps)
    assert lines[0]["snapshot"]["counters"]["train.tokens"] == 3 * 16 * 2
    trace = json.loads(open(base + ".trace.json").read())
    assert sum(e["name"] == "train.step" and e["ph"] == "X"
               for e in trace["traceEvents"]) == 3
