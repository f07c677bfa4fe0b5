"""The multi-rank half of the port's distributed path on the CPU, in gloo
process groups: two spawns of ``tests/torch_dist_worker.py`` (world 2,
then world 4), each rank a process, each spawn under its own time limit,
the group's store a file in the test's temporary directory.

* **Expert parallelism** on a (data 2, model 2) mesh against
  ``repro.models.moe.moe_ffn_dense_ref`` on the same weights carried by
  ``bridge``: the output to 1e-5 and the gradients of sum(y ** 2) to
  1e-4 in f32 (each rank's gradient is its term of the summed loss: the
  test sums them over the ranks holding a block and divides by the
  model-axis replicas), int8 banks to 1e-4, the ``REPRO_MOE_GROUPED=0``
  baseline, and against the port's one-process ``moe_ffn`` and the JAX
  pjit path's aux loss; the same mesh off the EP path
  (``REPRO_MOE_EP=0``, and a sequence model 2 does not divide) likewise.
* **compress_psum** at world 4 against the JAX function under
  ``jax.vmap(..., axis_name="pod")`` over the same four shards: the mean
  and every rank's new error.
* **Training**: a 2-rank smoke run (FSDP layout) through
  ``launch.train.train`` with a checkpoint against the 1-process run,
  loss and grad norm over 3 steps; resumed from its step-2 checkpoint at
  world 1 and at world 4, the resumed step and the final state equal
  the unbroken run's; and two sharded steps at lr 1e-2 (smollm FSDP with
  AdamW; qwen3-moe on a model-2 mesh, fsdp_tp, Adafactor, experts
  through EP, and with ``REPRO_MOE_EP=0`` the banks gathered by the
  layer) against the 1-process step: loss, grad norm, gradients and the
  new state.
* The collectives' forward and backward rules on bf16 and int32.
"""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.models import moe as JM
from repro.optim import compression as jcompression
from repro_torch.bridge import from_jax, map_tree, tree_leaves
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import moe as TM
from repro_torch.train import train_step as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
#: a spawn's time limit (both together take ~30 s on an idle host)
SPAWN_TIMEOUT = 300
E, D, F, K = 8, 32, 64, 2


def spawn(job: str, world: int, d: pathlib.Path) -> list:
    """Run ``job`` on ``world`` gloo ranks; each rank's saved outputs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), job, str(r), str(world),
         str(d / f"store_{job}"), str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=30)
        pytest.fail(f"{job}: ranks still running after {SPAWN_TIMEOUT} s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"{job} rank {r}:\n{logs[r][-4000:]}"
    # written by this test's own ranks
    return [torch.load(d / f"{job}_{r}.pt", weights_only=False)
            for r in range(world)]


def oracle():
    """The EP inputs (JAX init, f32; int8 banks by the JAX quantizer),
    the dense oracle's output and gradients of sum(y ** 2), and the
    compression shards."""
    jp = JM.init_moe(jax.random.PRNGKey(0), D, F, E, jnp.float32)
    x = np.random.default_rng(1).standard_normal((4, 8, D)).astype(
        np.float32)
    # 7 positions: s % m != 0 takes the path off EP
    x_odd = np.ascontiguousarray(x[:, :7])

    def loss(p, x):
        return jnp.sum(JM.moe_ffn_dense_ref(p, x, top_k=K) ** 2)

    def ref(x):
        gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
        return {"dense": np.asarray(JM.moe_ffn_dense_ref(
                    jp, jnp.asarray(x), top_k=K)),
                "aux": float(JM._moe_ffn_pjit(jp, jnp.asarray(x), top_k=K,
                                              capacity_factor=16.0)[1]),
                "grads": jax.tree.map(np.asarray, gp),
                "dx": np.asarray(gx)}

    whole, odd = ref(x), ref(x_odd)
    qp = dict(jp, **{k: jquant.quantize_weight(jp[k])
                     for k in ("w_gate", "w_up", "w_down")})
    rng = np.random.default_rng(2)
    shards = [({"w": rng.standard_normal((16, 8)).astype(np.float32)
                * (r + 1), "b": {"c": rng.standard_normal(5).astype(
                    np.float32)}},
               {"w": rng.standard_normal((16, 8)).astype(np.float32) * 1e-2,
                "b": {"c": np.zeros(5, np.float32)}}) for r in range(4)]
    return {
        "moe": from_jax(jax.tree.map(np.asarray, jp)),
        "moe_int8": from_jax(jax.tree.map(np.asarray, qp)),
        "x": torch.from_numpy(x), "x_odd": torch.from_numpy(x_odd),
        "top_k": K, "dense": whole["dense"],
        "dense_int8": np.asarray(JM.moe_ffn_dense_ref(qp, jnp.asarray(x),
                                                      top_k=K)),
        "pjit_aux": whole["aux"], "grads": whole["grads"],
        "dx": whole["dx"], "whole": whole, "odd": odd,
        "compress": [(from_jax(g), from_jax(e)) for g, e in shards],
    }


def _resume_dir(src: pathlib.Path, dst: pathlib.Path) -> pathlib.Path:
    """A copy of ``src`` without its step-3 checkpoint: a resume from
    step 2."""
    shutil.copytree(src, dst)
    shutil.rmtree(dst / "step_00000003")
    return dst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    inputs = oracle()
    torch.save({k: v for k, v in inputs.items()
                if k in ("moe", "moe_int8", "x", "x_odd", "top_k",
                         "compress")},
               d / "inputs.pt")
    two = spawn("world2", 2, d)
    _resume_dir(d / "ckpt2", d / "resume4")
    _resume_dir(d / "ckpt2", d / "resume1")
    four = spawn("world4", 4, d)
    return {"dir": d, "inputs": inputs, "two": two, "four": four}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) \
        else torch.as_tensor(a)


def _close(a, b, atol, rtol=0.0):
    torch.testing.assert_close(_tensor(a).float(), _tensor(b).float(),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------- expert parallelism

def test_ep_forward_matches_the_dense_oracle(runs):
    four, inp = runs["four"], runs["inputs"]
    for r in four:
        i = r["coord"]["data"]
        _close(r["ep"]["y"], inp["dense"][2 * i:2 * i + 2], 1e-5)
        _close(r["ep_dense"]["y"], inp["dense"][2 * i:2 * i + 2], 1e-5)
        _close(r["ep"]["aux"], inp["pjit_aux"], 0, 1e-5)
    one, _ = TM.moe_ffn(inp["moe"], inp["x"], top_k=K, capacity_factor=16.0)
    got = torch.cat([four[0]["ep"]["y"], four[2]["ep"]["y"]])
    _close(got, one, 1e-5)
    # the model-axis replicas of a data block hold the same output
    assert torch.equal(four[0]["ep"]["y"], four[1]["ep"]["y"])


def _assert_grads_match(four, mode, ref):
    """Summed over the ranks holding a block, over the two model-axis
    replicas of every row: the oracle's gradients of sum(y ** 2)."""
    g = [r[mode]["grads"] for r in four]
    by_coord = {(r["coord"]["data"], r["coord"]["model"]): r[mode]
                for r in four}
    _close(sum(x["router"] for x in g) / 2, ref["grads"]["router"], 1e-4)
    for k in ("w_gate", "w_up", "w_down"):
        blocks = [(by_coord[(0, j)]["grads"][k]
                   + by_coord[(1, j)]["grads"][k]) / 2 for j in (0, 1)]
        _close(torch.cat(blocks), ref["grads"][k], 1e-4)
    dx = [(by_coord[(i, 0)]["dx"] + by_coord[(i, 1)]["dx"]) / 2
          for i in (0, 1)]
    _close(torch.cat(dx), ref["dx"], 1e-4)


def test_ep_gradients_match_the_dense_oracle(runs):
    for mode in ("ep", "ep_dense"):
        _assert_grads_match(runs["four"], mode, runs["inputs"])


@pytest.mark.parametrize("mode", ["ep_off", "ep_odd"])
def test_moe_off_the_ep_path_matches_the_dense_oracle(runs, mode):
    """A (2, 2) mesh off the EP path (``REPRO_MOE_EP=0``; 7 positions,
    which model 2 does not divide): every rank gathers the banks over
    model and routes its rows through all experts.  Forward and aux loss
    against the oracle and the port's one-process ``moe_ffn``, the
    gradients (the gather's backward sums over model) against the
    oracle's."""
    four, inp = runs["four"], runs["inputs"]
    ref = inp["whole"] if mode == "ep_off" else inp["odd"]
    x = inp["x"] if mode == "ep_off" else inp["x_odd"]
    for r in four:
        i = r["coord"]["data"]
        _close(r[mode]["y"], ref["dense"][2 * i:2 * i + 2], 1e-5)
        _close(r[mode]["aux"], ref["aux"], 0, 1e-5)
    one, _ = TM.moe_ffn(inp["moe"], x, top_k=K, capacity_factor=16.0)
    _close(torch.cat([four[0][mode]["y"], four[2][mode]["y"]]), one, 1e-5)
    _assert_grads_match(four, mode, ref)


def test_ep_int8_banks_match_the_dense_oracle(runs):
    for r in runs["four"]:
        i = r["coord"]["data"]
        _close(r["ep_int8"]["y"],
               runs["inputs"]["dense_int8"][2 * i:2 * i + 2], 1e-4)


def test_collectives_forward_and_backward(runs):
    four = runs["four"]
    xs = [r["collectives"]["x"] for r in four]
    for rank, r in enumerate(four):
        c = r["collectives"]
        # rank r's block j is rank j's block r, bit for bit (bf16)
        assert torch.equal(c["a2a"], torch.stack([x[rank] for x in xs]))
        # rank r's block j went to rank j, whose loss weighs it j + 1
        assert torch.equal(c["a2a_grad"].float(), torch.arange(
            1, 5, dtype=torch.float32)[:, None].expand(4, 3))
        assert torch.equal(c["gather"], torch.cat(xs, 1))
        # every rank's loss squares every rank's block
        assert torch.equal(c["gather_grad"], (8 * xs[rank].float())
                           .to(torch.bfloat16))
        assert int(c["ids"]) == 6


# ----------------------------------------------------------- compression

def test_compress_psum_matches_jax_under_vmap(runs):
    shards = runs["inputs"]["compress"]
    stack = jax.tree.map(lambda *a: np.stack(a),
                         *[map_tree(lambda t: t.numpy(), g)
                           for g, _ in shards])
    err = jax.tree.map(lambda *a: np.stack(a),
                       *[map_tree(lambda t: t.numpy(), e)
                         for _, e in shards])
    mean, new_err = jax.vmap(
        lambda g, e: jcompression.compress_psum(g, e, "pod"),
        axis_name="pod")(stack, err)
    for rank, r in enumerate(runs["four"]):
        got_mean, got_err = r["compress"]
        for path in (("w",), ("b", "c")):
            def pick(tree):
                for p in path:
                    tree = tree[p]
                return tree
            _close(pick(got_mean), np.asarray(pick(mean))[rank], 0, 1e-6)
            _close(pick(got_err), np.asarray(pick(new_err))[rank], 1e-7,
                   1e-6)


# -------------------------------------------------------------- training

def _smoke(arch, dtype="float32"):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def _one_process_train(ckpt_dir, steps=3):
    rec = {}
    train_launch.train(
        _smoke("smollm-360m"), steps=steps, seq_len=32, global_batch=4,
        device="cpu", ckpt_dir=str(ckpt_dir), ckpt_every=2,
        on_step=lambda s, st, m, t: rec.__setitem__(
            s, (float(m["loss"]), float(m["grad_norm"]))))
    return rec


def _final_state(ckpt_dir):
    ck = Checkpointer(str(ckpt_dir))
    return ck.restore(TS.init_state(_smoke("smollm-360m"),
                                    torch.Generator().manual_seed(0), "cpu"))


def _assert_states_close(a, b, atol, params_atol=None):
    """Every leaf within ``atol`` (and a relative 1e-5); the parameters
    within ``params_atol`` when given."""
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        tol = params_atol if params_atol is not None \
            and k.startswith(".params/") else atol
        _close(fa[k], fb[k], tol, 1e-5)


def test_two_rank_training_matches_one_rank(runs, tmp_path):
    two = runs["two"]
    assert two[0]["train"] == two[1]["train"]
    one = _one_process_train(tmp_path / "one")
    assert sorted(one) == sorted(two[0]["train"]) == [0, 1, 2]
    for s in one:
        _close(two[0]["train"][s][0], one[s][0], 1e-5, 1e-5)
        _close(two[0]["train"][s][1], one[s][1], 1e-5, 1e-5)
    # rank 0 wrote the whole state, in the JAX package's format
    ck = Checkpointer(str(runs["dir"] / "ckpt2"))
    assert ck.all_steps() == [2, 3]
    _assert_states_close(_final_state(runs["dir"] / "ckpt2"),
                         _final_state(tmp_path / "one"), 1e-5)


@pytest.mark.parametrize("world", [1, 4])
def test_resume_at_another_world_equals_the_unbroken_run(runs, world):
    d = runs["dir"]
    if world == 1:
        resumed = _one_process_train(d / "resume1")
    else:
        resumed = runs["four"][0]["resume"]
        assert all(r["resume"] == resumed for r in runs["four"])
    unbroken = runs["two"][0]["train"]
    assert sorted(resumed) == [2]
    _close(resumed[2][0], unbroken[2][0], 1e-5, 1e-5)
    _close(resumed[2][1], unbroken[2][1], 1e-5, 1e-5)
    _assert_states_close(_final_state(d / f"resume{world}"),
                         _final_state(d / "ckpt2"), 1e-5)


@pytest.mark.parametrize("case", ["dense_fsdp", "moe_ep", "moe_off"])
def test_sharded_steps_match_the_one_process_step(runs, case):
    """Two steps at lr 1e-2 from the seed-0 state: loss, grad norm and
    gradients within 1e-5 (f32 sums in another order), the optimizer
    state within 1e-5, and the update over lr within 1e-2 where the
    gradient is clear of zero (AdamW's first step moves an element by
    about lr whatever its gradient, so an element whose gradient is ~0
    may move otherwise: the parameters are held within 2 lr).  Each
    step starts from the state the sharded run reached."""
    arch, optimizer = {"dense_fsdp": ("smollm-360m", "adamw"),
                       "moe_ep": ("qwen3-moe-235b-a22b", "adafactor"),
                       "moe_off": ("qwen3-moe-235b-a22b", "adafactor")}[case]
    cfg = _smoke(arch)
    state = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu",
                          optimizer=optimizer)
    step = TS.make_train_step(cfg, optimizer=optimizer, peak_lr=1e-2,
                              warmup_steps=0, return_grads=True)
    data = pipeline.DataConfig(seq_len=32, global_batch=4)
    got = runs["two"][0][case]
    for r in runs["two"][1:]:
        for a, b in zip(r[case], got):
            _assert_states_close(a["state"], b["state"], 0)
    for i, rec in enumerate(got):
        # each step from the state the sharded run reached
        before = got[i - 1]["state"] if i else state
        after, m = step(before, pipeline.make_batch(cfg, data, i))
        _close(rec["loss"], m["loss"], 1e-5, 1e-5)
        _close(rec["grad_norm"], m["grad_norm"], 1e-5, 1e-5)
        for a, b in zip(tree_leaves(rec["grads"]), tree_leaves(m["grads"])):
            _close(a, b, 1e-5, 1e-4)
        _assert_states_close(rec["state"], after, 1e-5, params_atol=2e-2)
        for p0, a, b, g in zip(*(tree_leaves(t) for t in (
                before.params, rec["state"].params, after.params,
                m["grads"]))):
            clear = g.abs() > 1e-5
            _close(((a - p0) / 1e-2)[clear], ((b - p0) / 1e-2)[clear], 1e-2)


def test_sharded_bf16_step_equals_two_microbatches_bitwise(runs):
    """In bf16 the two-rank step's gradients are the one-process step's
    with each rank's rows as a microbatch, rounded to the leaf's dtype,
    bit for bit (each rank's bf16 gradient is one microbatch's, the f32
    mean of the two is the accumulated one), and its loss that step's
    loss bit for bit.  Each step starts from the state the sharded run
    reached."""
    cfg = _smoke("smollm-360m", "bfloat16")
    state = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = TS.make_train_step(cfg, peak_lr=1e-2, warmup_steps=0,
                              microbatches=2, return_grads=True)
    data = pipeline.DataConfig(seq_len=32, global_batch=4)
    got = runs["two"][0]["dense_bf16"]
    assert any(g.dtype == torch.bfloat16
               for g in tree_leaves(got[0]["grads"]))
    for i, rec in enumerate(got):
        before = got[i - 1]["state"] if i else state
        _, m = step(before, pipeline.make_batch(cfg, data, i))
        assert torch.equal(rec["loss"], m["loss"])
        for a, b in zip(tree_leaves(rec["grads"]), tree_leaves(m["grads"])):
            assert torch.equal(a, b.to(a.dtype))
