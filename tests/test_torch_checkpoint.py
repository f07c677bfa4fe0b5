"""The port's checkpointer and resume against the JAX package's, on the
CPU.

A checkpoint is the JAX package's on-disk format (``step_%08d/{
manifest.json, arrays.npz, COMMITTED}``), keyed by the reference's tree
paths: a file either package writes restores in the other bit for bit,
bf16 leaves included.  A resumed run equals an unbroken one bit for bit
(the CPU is deterministic).  The next step from a restored JAX state
matches JAX's own next step within 2e-4 (f32 sums in another order; the
learning rate is ~3e-6 at step 1, so parameters move by less than that).
"""

import dataclasses
import os
import shutil

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten as j_flatten
from repro.configs.base import get_smoke_config as j_smoke
from repro.data import pipeline as JP
from repro.train import train_step as JTS
from repro_torch.bridge import map_tree, tree_leaves
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as P
from repro_torch.launch import train as train_cli
from repro_torch.train import train_step as TS

OPTS = {"adamw": "smollm-360m", "adafactor": "qwen3-moe-235b-a22b"}


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


def _port_state(arch, dtype="bfloat16", optimizer="adamw", seed=0):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    return TS.init_state(cfg, torch.Generator().manual_seed(seed), "cpu",
                         optimizer=optimizer)


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy() \
        .tobytes()


def _assert_equal_states(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert _bits(x) == _bits(y), k


def _jax_state(arch, optimizer, dtype="bfloat16"):
    jcfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    return jcfg, JTS.init_state(jax.random.PRNGKey(1), jcfg, optimizer)


def _jax_bits(tree) -> dict:
    """A JAX pytree's leaves as raw bytes, keyed by the checkpoint key."""
    return {k: np.ascontiguousarray(np.asarray(v)).view(np.uint8).tobytes()
            for k, v in j_flatten(tree)}


# ------------------------------------------------------------- the format


@pytest.mark.parametrize("optimizer", sorted(OPTS))
def test_keys_are_the_references(optimizer):
    """The port's keys and their order are the JAX ``_flatten``'s, letter
    for letter, for a TrainState of either optimizer."""
    arch = OPTS[optimizer]
    _, js = _jax_state(arch, optimizer)
    ts = _port_state(arch, optimizer=optimizer)
    assert [k for k, _ in _flatten(ts)] == [k for k, _ in j_flatten(js)]


@pytest.mark.parametrize("blocking", [True, False])
def test_save_restore_is_bit_exact(tmp_path, blocking):
    """bf16 parameters, f32 moments and int32 steps come back bit for
    bit, in the target's dict order and on its device; an async save
    holds the values of the moment it was called."""
    state = _port_state("smollm-360m", optimizer="adamw", seed=3)
    want = map_tree(torch.clone, state)
    ck = Checkpointer(str(tmp_path))
    ck.save(7, state, blocking=blocking)
    if not blocking:                    # the caller reuses its tensors
        for t in tree_leaves(state.params):
            t.add_(1.0)
        ck.wait()
    target = _port_state("smollm-360m", optimizer="adamw", seed=4)
    got = ck.restore(target)
    _assert_equal_states(got, want)
    assert list(got.params) == list(target.params)
    assert ck.latest_step() == 7


def test_uncommitted_directories_are_ignored(tmp_path):
    state = _port_state("smollm-360m")
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state)
    os.makedirs(tmp_path / "step_00000009")            # no COMMITTED
    (tmp_path / "step_00000011.tmp1_2").mkdir()        # a torn write
    assert ck.all_steps() == [2] and ck.latest_step() == 2
    empty = Checkpointer(str(tmp_path / "none"))
    assert empty.latest_step() is None
    with pytest.raises(FileNotFoundError):
        empty.restore(state)


def test_keep_last(tmp_path):
    state = _port_state("smollm-360m")
    ck = Checkpointer(str(tmp_path), keep_last=2)
    for step in (1, 2, 3, 4):
        ck.save(step, state, blocking=step % 2 == 0)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


# --------------------------------------------------- across the packages


@pytest.mark.parametrize("optimizer", sorted(OPTS))
def test_jax_checkpoint_restores_in_the_port(tmp_path, optimizer):
    """A bf16 TrainState written by the JAX Checkpointer restores in the
    port bit for bit."""
    arch = OPTS[optimizer]
    _, js = _jax_state(arch, optimizer)
    JCheckpointer(str(tmp_path)).save(5, js)
    got = Checkpointer(str(tmp_path)).restore(
        _port_state(arch, optimizer=optimizer))
    want = _jax_bits(js)
    flat = _flatten(got)
    assert [k for k, _ in flat] == list(want)
    for key, t in flat:
        assert _bits(t) == want[key], key
    assert int(got.step) == 0


@pytest.mark.parametrize("optimizer", sorted(OPTS))
def test_port_checkpoint_restores_in_jax(tmp_path, optimizer):
    """A bf16 TrainState written by the port restores in the JAX
    Checkpointer bit for bit."""
    arch = OPTS[optimizer]
    state = _port_state(arch, optimizer=optimizer, seed=2)
    Checkpointer(str(tmp_path)).save(3, state)
    _, target = _jax_state(arch, optimizer)
    got = JCheckpointer(str(tmp_path)).restore(target)
    assert jtu.tree_structure(got) == jtu.tree_structure(target)
    want = {k: _bits(t) for k, t in _flatten(state)}
    assert _jax_bits(got) == want
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(target)):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("optimizer", sorted(OPTS))
def test_next_step_from_a_jax_checkpoint_matches_jax(tmp_path, optimizer):
    """JAX takes one step (f32 smoke), saves, and takes a second; the
    port restores the file and takes the second step: loss, grad norm
    and every updated parameter within 2e-4."""
    arch = OPTS[optimizer]
    jcfg, js = _jax_state(arch, optimizer, dtype="float32")
    tcfg = get_smoke_config(arch)
    dc = dict(seq_len=16, global_batch=2, seed=0)
    jstep = jax.jit(JTS.make_train_step(jcfg, optimizer=optimizer))
    js, _ = jstep(js, JP.make_batch(jcfg, JP.DataConfig(**dc), 0))
    JCheckpointer(str(tmp_path)).save(1, js)
    js2, jm = jstep(js, JP.make_batch(jcfg, JP.DataConfig(**dc), 1))
    ts = Checkpointer(str(tmp_path)).restore(
        _port_state(arch, dtype="float32", optimizer=optimizer))
    assert int(ts.step) == 1
    ts2, tm = TS.make_train_step(tcfg, optimizer=optimizer)(
        ts, P.make_batch(tcfg, P.DataConfig(**dc), 1))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   atol=2e-4, rtol=0, err_msg=key)
    want = {k: np.asarray(v) for k, v in j_flatten(js2)}
    for key, t in _flatten(ts2):
        np.testing.assert_allclose(t.numpy(), want[key], atol=2e-4,
                                   rtol=0, err_msg=key)


# --------------------------------------------------------------- resume


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
def test_resumed_run_equals_an_unbroken_one(tmp_path, arch):
    """Four unbroken steps saved every two; the step-4 checkpoint is
    deleted and the run resumed from step 2 to four: steps 2-3's losses
    and the final state equal the unbroken run's bit for bit."""
    cfg = get_smoke_config(arch)
    kw = dict(seq_len=16, global_batch=2, device="cpu",
              ckpt_dir=str(tmp_path), ckpt_every=2)
    runs = {"unbroken": {}, "resumed": {}}

    def keep(name):
        def on_step(step, state, m, times):
            runs[name][step] = (float(m["loss"]), state)
        return on_step

    train_cli.train(cfg, steps=4, on_step=keep("unbroken"), **kw)
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
    shutil.rmtree(tmp_path / "step_00000004")
    train_cli.train(cfg, steps=4, on_step=keep("resumed"), **kw)
    assert sorted(runs["resumed"]) == [2, 3]
    for step in (2, 3):
        assert runs["resumed"][step][0] == runs["unbroken"][step][0]
    _assert_equal_states(runs["resumed"][3][1], runs["unbroken"][3][1])
    final = Checkpointer(str(tmp_path)).restore(runs["unbroken"][3][1])
    _assert_equal_states(final, runs["unbroken"][3][1])


def test_ckpt_dir_resumes_from_the_cli(tmp_path, capsys):
    argv = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu",
            "--seq-len", "8", "--global-batch", "2", "--ckpt-dir",
            str(tmp_path)]
    train_cli.main(argv + ["--steps", "2"])
    first = capsys.readouterr().out
    assert "resumed" not in first
    train_cli.main(argv + ["--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[train] resumed from step 2"
    assert [ln.split()[2] for ln in lines
            if ln.startswith("[train] step ")] == ["2"]
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 3
    assert int(ck.restore(_port_state("qwen3-moe-235b-a22b",
                                      dtype="float32")).step) == 3
