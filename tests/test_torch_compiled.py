"""The port's compiled steps on the CPU (the card's half is in
``tests/test_torch_cuda.py``).

* the consuming train step (``make_train_step(consume=True)``, the JAX
  step's ``donate_argnums=(0,)``) equals the step that returns a new
  state bit for bit, and writes into the state's own storage;
* the launcher's consuming step against ``repro.launch.train.build``'s
  donated jitted step (the JAX side under ``REPRO_KERNELS=ref``): the
  loss within 2e-4 absolute, as the six-step loss curve of
  ``tests/test_torch_train.py``, and every parameter within atol = rtol
  = 1e-4, as that file's gradient leaves;
* the dry-run traces the consuming step: its state is aliased and its
  peak is lower;
* the replay accounting of :mod:`repro_torch.runtime.graphs` as host
  arithmetic: n replays add the captured launches and plans n times;
* the CPU engine and trainer never capture, and the engine's tokens
  still equal the JAX engine's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.data import pipeline as JP
from repro.launch import train as j_train
from repro.launch.mesh import make_host_mesh
from repro_torch import ops, telemetry
from repro_torch.bridge import map_tree, to_numpy, train_state_from_jax, \
    tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.core import op_cost
from repro_torch.data import pipeline as P
from repro_torch.dist import layout, sharding as shd
from repro_torch.launch import dryrun, specs
from repro_torch.launch import train as train_cli
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.runtime import graphs
from repro_torch.serve.engine import (ACCEPTANCE_TRACE, DecodeEngine,
                                      acceptance_requests)
from repro_torch.train import train_step as TS

MOE = "qwen3-moe-235b-a22b"


def _state_leaves(state):
    return list(tree_leaves(dict(params=state.params,
                                 opt=dict(zip(state.opt._fields, state.opt)),
                                 step=state.step)))


@pytest.mark.parametrize("arch,optimizer,microbatches,dtype", [
    (arch, opt, mb, "float32") for arch in ("smollm-360m", MOE)
    for opt in ("adamw", "adafactor") for mb in (1, 2)]
    + [("smollm-360m", "adamw", 1, "bfloat16")])
def test_consuming_step_equals_the_step_bitwise(arch, optimizer,
                                                microbatches, dtype):
    """Two steps from one state: the consuming step returns its input
    state, whose leaves keep their storage and hold, bit for bit, what
    the step that returns a new state computes (loss, grad norm, lr,
    every parameter, moment and step counter)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    state = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu",
                          optimizer=optimizer)
    consumed = map_tree(torch.clone, state)
    ptrs = [t.data_ptr() for t in _state_leaves(consumed)]
    kw = dict(optimizer=optimizer, microbatches=microbatches,
              warmup_steps=1, peak_lr=1e-2)
    step = TS.make_train_step(cfg, **kw)
    consume = TS.make_train_step(cfg, consume=True, **kw)
    for i in range(2):
        batch = P.make_batch(cfg, P.DataConfig(seq_len=16, global_batch=4),
                             i)
        state, want = step(state, batch)
        out, got = consume(consumed, batch)
        assert out is consumed
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(got[key], want[key]), key
        for a, b in zip(_state_leaves(state), _state_leaves(consumed)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert [t.data_ptr() for t in _state_leaves(consumed)] == ptrs
    assert int(consumed.step) == 2


def test_consuming_step_matches_the_jax_donated_step(monkeypatch):
    """Three steps of the port launcher's step (``build``) from the JAX
    launcher's initial state against ``repro.launch.train.build``'s
    jitted step with the state donated."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    arch = "smollm-360m"
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    jstate, jstep, _ = j_train.build(jcfg, make_host_mesh(),
                                     total_steps=3)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    _, step = train_cli.build(tcfg, device="cpu", total_steps=3)
    dc = dict(seq_len=16, global_batch=2, seed=0)
    for i in range(3):
        jstate, jm = jstep(jstate, JP.make_batch(jcfg, JP.DataConfig(**dc),
                                                 i))
        out, m = step(state, P.make_batch(tcfg, P.DataConfig(**dc), i))
        assert out is state
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=2e-4, rtol=0)
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    for a, b in zip(tree_leaves(state.params), tree_leaves(want.params)):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), atol=1e-4,
                                   rtol=1e-4)
    assert int(state.step) == int(want.step) == 3


@pytest.mark.parametrize("dims", [(1, 1), (2, 2)])
def test_dryrun_counts_the_consumed_state_as_aliased(dims, monkeypatch):
    """A smoke training cell's dry-run trace (one rank, and rank 0 of a
    2 x 2 mesh): the consuming step's result aliases the state's every
    byte, and its peak is below the step that returns a new state."""
    cfg = get_smoke_config("smollm-360m")
    mesh = shd.DryMesh(dims, ("data", "model"))
    lay = layout.choose_layout(cfg, shd.axis_sizes(mesh))
    shape = ShapeSpec(name="train_smoke", seq_len=32, global_batch=4,
                      kind="train")
    make = TS.make_train_step
    mem = {}
    for consume in (False, True):
        monkeypatch.setattr(TS, "make_train_step", lambda *a, **k: make(
            *a, **dict(k, consume=consume)))
        p = specs._train_problem(cfg, shape, mesh, lay)
        with op_cost.count(hold=p.args) as counter:
            out = p.fn(*p.args)
        mem[consume] = dryrun._memory_analysis(p.args, out,
                                               counter.result().peak_bytes)
        state_bytes = sum(op_cost.storages(p.args[0]).values())
    assert mem[False]["alias_size_in_bytes"] == 0
    assert mem[True]["alias_size_in_bytes"] == state_bytes > 0
    assert mem[True]["peak_bytes_per_device"] \
        < mem[False]["peak_bytes_per_device"]


def test_the_dryrun_traces_the_consuming_step(monkeypatch):
    """``specs``' train problem builds the consuming step."""
    seen = {}
    make = TS.make_train_step

    def spy(*a, **k):
        seen.update(k)
        return make(*a, **k)
    monkeypatch.setattr(TS, "make_train_step", spy)
    monkeypatch.setattr(specs, "get_config", get_smoke_config)
    specs.build_problem("smollm-360m", "train_4k",
                        shd.DryMesh((1, 1), ("data", "model")))
    assert seen.get("consume") is True


def test_replay_accounting_adds_the_captured_launches_n_times():
    """What a recorded block launches (here the CPU's plain versions) is
    taken back off the counters at its end; each ``apply`` -- one
    replay -- adds every delta back and hands the plans to the hooks;
    ``fold`` adds a static device count to its telemetry counter and
    zeroes it."""
    a = torch.randn(8, 32)
    w = torch.randn(32, 16)
    q = torch.randn(2, 1, 4, 8)
    kv = torch.randn(2, 24, 4, 8)
    ops.gemm(a, w)
    ops.decode_attention(q[:, 0], kv, kv, torch.tensor([5, 20]))
    before = {key: getattr(*key) for key in graphs.counters()}
    with graphs.record() as acc:
        assert graphs.recording()
        ops.gemm(a, w)
        ops.gemm(a, w)
        ops.decode_attention(q[:, 0], kv, kv, torch.tensor([5, 20]))
    assert not graphs.recording()
    assert {key: getattr(*key) for key in graphs.counters()} == before
    assert sum(acc.plans.values()) == 2 and sum(acc.attn_plans.values()) == 1
    assert acc.deltas and min(acc.deltas.values()) > 0
    seen = []

    def hook(plans, attn_plans):
        seen.append((dict(plans), dict(attn_plans)))
    graphs.add_replay_hook(hook)
    try:
        n = 5
        for _ in range(n):
            acc.apply()
    finally:
        graphs.remove_replay_hook(hook)
    for key, n0 in before.items():
        assert getattr(*key) == n0 + n * acc.deltas.get(key, 0)
    assert seen == [(acc.plans, acc.attn_plans)] * n
    g = graphs.Graph(graph=None, accounting=graphs.Accounting(
        device_counts={"moe.group_sizes": torch.tensor(7),
                       "moe.dropped_tokens": torch.tensor(0)},
        counted={"moe.group_sizes"}), first=None, out=None)
    rec = telemetry.enable(telemetry.Recorder())
    try:
        g.fold()
        g.fold()
        snap = rec.snapshot()
    finally:
        telemetry.disable()
    assert snap["counters"]["moe.group_sizes"] == 7
    assert "moe.dropped_tokens" not in snap["counters"]    # never counted
    assert int(g.accounting.device_counts["moe.group_sizes"]) == 0


def test_cpu_engine_never_captures_and_matches_jax(monkeypatch):
    """The CPU engine runs every step eagerly (``graphs=True`` raises),
    and the acceptance trace's tokens equal the JAX engine's."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.models import transformer as JT
    from repro.serve.engine import DecodeEngine as JEngine
    from repro.serve.engine import acceptance_requests as j_reqs
    from repro_torch.bridge import from_jax
    jcfg = j_smoke("smollm-360m")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = get_smoke_config("smollm-360m")
    tp = from_jax(jax.tree.map(np.asarray, jp))
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        DecodeEngine(tp, tcfg, batch=2, max_len=max_len, device="cpu",
                     graphs=True)
    engine = DecodeEngine(tp, tcfg, batch=2, max_len=max_len, device="cpu")
    got = {r.rid: r.tokens for r in
           engine.run(acceptance_requests(tcfg.vocab))}
    assert not engine.graphs and engine._graph is None
    assert engine.metrics["graph_captures"] == 0
    assert engine.metrics["graph_replays"] == 0
    want = {r.rid: r.tokens for r in
            JEngine(jp, jcfg, batch=2, max_len=max_len).run(
                j_reqs(jcfg.vocab))}
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_which_train_steps_are_captured():
    """On the CPU the trainer runs eagerly and ``graphs=True`` raises; on
    the card MoE training and a step on a mesh of several ranks stay
    eager, by rule, with their reasons."""
    cfg = get_smoke_config("smollm-360m")
    assert train_cli.eager_reason(cfg, "cpu") == "CUDA graphs need the card"
    assert train_cli.eager_reason(cfg, "cuda") is None
    assert "group sizes on the host" in train_cli.eager_reason(
        get_smoke_config(MOE), "cuda")
    assert "gloo" in train_cli.eager_reason(
        cfg, "cuda", shd.DryMesh((2, 1), ("data", "model")))
    with pytest.raises(ValueError, match="cannot be captured"):
        train_cli.train(cfg, steps=1, seq_len=8, global_batch=2,
                        device="cpu", graphs=True)
