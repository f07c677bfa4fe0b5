"""The single-process half of the port's distributed modules against the
JAX package, on the CPU: ``repro_torch.dist.sharding``'s mesh lifecycle
and logical-axis resolution against ``repro.dist.sharding``; the shard
arithmetic; the mesh builders; ``runtime.fault_tolerance`` on
``tests/test_substrates.py``'s cases; ``optim.compression``'s quantizer
and the error-feedback convergence check; ``data.pipeline.batch_spec``
and its row-sharded batches; the ``REPRO_MOE_GROUPED=0`` baseline
against the JAX pjit path's; a restore under shardings and a re-meshing
restore on one rank; and ``launch/serve.py --ckpt-dir`` against the JAX
launcher's tokens on the same checkpoint.  The multi-rank half is
``tests/test_torch_dist.py``."""

import dataclasses
import itertools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.data import pipeline as JP
from repro.dist import sharding as jshd
from repro.launch import serve as jserve
from repro.models import moe as JM
from repro.optim import compression as jcompression
from repro.runtime import fault_tolerance as jft

from repro_torch.bridge import from_jax, tree_leaves
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_cli
from repro_torch.models import moe as TM
from repro_torch.optim import compression
from repro_torch.runtime import elastic
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.train import train_step as TS


class FakeMesh:
    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = names


SIZES = [{}, {"data": 2}, {"model": 4}, {"data": 2, "model": 4},
         {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
         {"pod": 3, "data": 2}]
DIMS = [1, 2, 3, 4, 6, 8, 16, 32, 48, 64, 96, 512]
LOGICAL = [None, "batch", "seq", "expert", "model", "data", "pod", "other"]


# ------------------------------------------------------------ resolution

@pytest.mark.parametrize("seq_shard", ["1", "0"])
@pytest.mark.parametrize("sizes", SIZES, ids=str)
def test_resolution_matches_jax(sizes, seq_shard, monkeypatch):
    monkeypatch.setenv("REPRO_SEQ_SHARD", seq_shard)
    assert shd.seq_shard_enabled() == jshd.seq_shard_enabled()
    assert shd.DATA_AXES == jshd.DATA_AXES
    for dim in DIMS:
        assert shd.data_axes_for(dim, sizes) == jshd.data_axes_for(dim,
                                                                  sizes)
        for name in LOGICAL:
            assert shd.resolve_axis(name, dim, sizes) \
                == jshd.resolve_axis(name, dim, sizes), (name, dim)
    for axes in itertools.product(LOGICAL[:5], repeat=3):
        for shape in [(8, 32, 64), (1, 6, 16), (96, 512, 3)]:
            got = shd.logical_spec(shape, axes, sizes)
            assert isinstance(got, P)
            assert tuple(got) == tuple(jshd.logical_spec(shape, axes, sizes))


@pytest.mark.parametrize("shape,names", [
    ((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))])
def test_axis_sizes_and_devices_of_a_duck_typed_mesh(shape, names):
    m = FakeMesh(shape, names)
    assert shd.axis_sizes(m) == jshd.axis_sizes(m)
    assert shd.mesh_devices(m) == jshd.mesh_devices(m)
    assert shd.axis_sizes(None) == jshd.axis_sizes(None) == {}
    assert shd.mesh_devices(None) == jshd.mesh_devices(None) == 1


def test_use_mesh_nests_and_restores_on_error():
    a, b = FakeMesh((2, 2), ("data", "model")), FakeMesh((4,), ("data",))
    assert shd.current_mesh() is None
    with shd.use_mesh(a):
        assert shd.current_mesh() is a
        with pytest.raises(RuntimeError):
            with shd.use_mesh(b):
                assert shd.current_mesh() is b
                raise RuntimeError("inside")
        assert shd.current_mesh() is a
    assert shd.current_mesh() is None


def test_act_returns_its_input():
    x = torch.randn(4, 8, 16)
    with shd.use_mesh(FakeMesh((2, 2), ("data", "model"))):
        assert shd.act(x, ("batch", "seq", None)) is x
        assert shd.act(x, "batch", None, "model") is x
    assert shd.act(x, ("batch", None, None)) is x


def test_partition_spec_is_a_tuple_that_pickles():
    import pickle
    s = P(("pod", "data"), None, "model")
    assert s == (("pod", "data"), None, "model") and len(P()) == 0
    assert pickle.loads(pickle.dumps(s)) == s
    assert isinstance(pickle.loads(pickle.dumps(s)), P)


# ------------------------------------------------------ shard arithmetic

@pytest.mark.parametrize("spec", [P(None, "data"), P("model", None),
                                  P(("pod", "data"), "model"),
                                  P(None, ("data", "model"))])
def test_blocks_tile_the_whole_tensor(spec):
    """The blocks of every coordinate cover the tensor, each element as
    often as coordinates share a block, and each block is the slice its
    outermost-first index names."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    x = torch.arange(64).reshape(8, 8)
    seen = torch.zeros(64, dtype=torch.long)
    for coord in itertools.product(range(2), repeat=3):
        c = dict(zip(("pod", "data", "model"), coord))
        part = shd.narrow(x, spec, sizes, c)
        want = x
        for dim, entry in enumerate(spec):
            idx, count = shd.block(entry, sizes, c)
            want = want.narrow(dim, idx * (8 // count), 8 // count)
        assert torch.equal(part, want)
        seen[part.reshape(-1)] += 1
    split = 1
    for entry in spec:
        split *= shd.block(entry, sizes, {})[1]
    assert torch.all(seen == 8 // split)


def test_block_index_orders_axes_outermost_first():
    sizes = {"pod": 2, "data": 4}
    assert shd.block(("pod", "data"), sizes, {"pod": 1, "data": 2}) \
        == (1 * 4 + 2, 8)
    assert shd.block("data", sizes, {"pod": 1, "data": 2}) == (2, 4)
    assert shd.block(None, sizes, {"pod": 1}) == (0, 1)


def test_trivial_mesh_and_builders():
    m = mesh_lib.make_host_mesh(data=4, model=2, device="cpu")
    assert m.axis_names == ("data", "model")
    assert m.devices.shape == (1, 1) and m.coord == {"data": 0, "model": 0}
    assert m.group("data") is None and m.group("model") is None
    x = torch.randn(4, 6)
    assert shd.gather(x, P("data", "model"), m) is x
    assert shd.shard(x, P("data", "model"), m) is x
    # the production meshes are the JAX package's literals
    assert mesh_lib.PRODUCTION[False] == ((16, 16), ("data", "model"))
    assert mesh_lib.PRODUCTION[True] == ((2, 16, 16),
                                         ("pod", "data", "model"))
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_lib.make_production_mesh(device="cpu")


# ------------------------------------------------------- fault tolerance

def test_watchdog_flags_stragglers_as_jax():
    wd, jwd = ft.StepWatchdog(threshold=2.0), jft.StepWatchdog(threshold=2.0)
    for i, dur in enumerate([1.0] * 10 + [5.0, 1.0, 2.5, 0.5]):
        got, want = wd.observe(i, dur), jwd.observe(i, dur)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert [e.step for e in wd.events] == [10, 12]


def test_run_resumable_restarts_as_jax():
    def run(mod):
        inj = mod.FailureInjector(fail_at_steps=(3, 7))
        done, state = [], {"step": 0}

        def run_step(step):
            inj.maybe_fail(step)
            done.append(step)
            state["step"] = step + 1

        restarts = mod.run_resumable(10, run_step, lambda: state["step"])
        return restarts, state["step"], done

    assert run(ft) == run(jft)
    restarts, step, done = run(ft)
    assert restarts == 2 and step == 10
    assert sorted(set(done)) == list(range(10))
    with pytest.raises(ft.PreemptionError):
        ft.run_resumable(5, lambda s: ft.FailureInjector([s]).maybe_fail(s),
                         lambda: 0, max_restarts=2)


# ----------------------------------------------------------- compression

@pytest.mark.parametrize("scale", [0.0, 1e-3, 1.0, 300.0])
def test_quantize_matches_jax(scale):
    g = np.random.default_rng(5).standard_normal((64, 48)).astype(
        np.float32) * scale
    q, s = compression._quantize(torch.from_numpy(g))
    jq, js = jcompression._quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_int8_error_feedback_reduces_error():
    """tests/test_substrates.py's check on the port's quantizer: the
    residual carried into the next step keeps the cumulative compressed
    sum within 1 % of the true sum."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((128,))).float()
    err = torch.zeros_like(g)
    acc_true, acc_comp = torch.zeros_like(g), torch.zeros_like(g)
    for step in range(20):
        gs = g * (0.9 ** step)
        q, scale = compression._quantize(gs + err)
        deq = q.float() * scale
        err = gs + err - deq
        acc_true += gs
        acc_comp += deq
    assert float(torch.linalg.norm(acc_comp - acc_true)
                 / torch.linalg.norm(acc_true)) < 0.01


def test_compress_psum_on_one_rank_is_the_dequantized_sum():
    g = {"w": torch.randn(16, 8), "b": {"c": torch.randn(5)}}
    err = compression.init_error(g)
    mean, new_err = compression.compress_psum(g, err, None)
    for k in ("w",):
        q, s = compression._quantize(g[k])
        torch.testing.assert_close(mean[k], q.float() * s, rtol=0, atol=0)
        torch.testing.assert_close(new_err[k], g[k] - q.float() * s,
                                   rtol=0, atol=0)
    assert new_err["b"]["c"].dtype == torch.float32


# -------------------------------------------------------------- pipeline

@pytest.mark.parametrize("arch", ["minitron-8b", "whisper-medium",
                                  "internvl2-76b"])
def test_batch_spec_and_row_shards_match_jax(arch):
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    seq = 24
    for row_start, rows in [(0, None), (0, 2), (2, 2), (3, 1)]:
        d = pipeline.DataConfig(seq_len=seq, global_batch=4,
                                row_start=row_start, rows=rows)
        jd = JP.DataConfig(seq_len=seq, global_batch=4,
                           row_start=row_start, rows=rows)
        spec, jspec = pipeline.batch_spec(cfg, d), JP.batch_spec(jcfg, jd)
        assert sorted(spec) == sorted(jspec)
        got, want = pipeline.make_batch(cfg, d, 3), JP.make_batch(jcfg, jd, 3)
        for k, s in jspec.items():
            assert tuple(spec[k].shape) == s.shape and spec[k].is_meta
            assert str(spec[k].dtype).removeprefix("torch.") == str(s.dtype)
            assert tuple(got[k].shape) == s.shape
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(want[k], np.float32))


# ----------------------------------------------------- the MoE baseline

@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_dense_capacity_baseline_matches_jax(monkeypatch, cf):
    """``REPRO_MOE_GROUPED=0``: the padded (E, C, d) einsum baseline of
    the single-rank path, against the JAX package's, and against the
    grouped path when nothing drops."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jp = JM.init_moe(jax.random.PRNGKey(0), 32, 48, 8, jnp.float32)
    tp = from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(2).standard_normal((4, 8, 32)).astype(
        np.float32)
    grouped, _ = TM.moe_ffn(tp, torch.from_numpy(x), top_k=2,
                            capacity_factor=cf)
    monkeypatch.setenv("REPRO_MOE_GROUPED", "0")
    assert not TM.grouped_enabled() and not JM.grouped_enabled()
    y, aux = TM.moe_ffn(tp, torch.from_numpy(x), top_k=2,
                        capacity_factor=cf)
    jy, jaux = JM._moe_ffn_pjit(jp, jnp.asarray(x), top_k=2,
                                capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if cf > 1:
        torch.testing.assert_close(y, grouped, atol=1e-5, rtol=1e-5)


def test_ep_and_grouped_switches_read_the_environment(monkeypatch):
    assert TM.ep_enabled() and TM.grouped_enabled()
    monkeypatch.setenv("REPRO_MOE_EP", "0")
    assert not TM.ep_enabled() and TM.ep_enabled() == JM.ep_enabled()


# ------------------------------------------------------------ checkpoint

def _state(arch="smollm-360m", optimizer="adamw"):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return cfg, TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu",
                              optimizer=optimizer)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_remesh_restore_on_one_rank_equals_what_was_saved(tmp_path,
                                                         optimizer):
    cfg, state = _state(optimizer=optimizer)
    ck = Checkpointer(str(tmp_path))
    ck.save(4, state)
    mesh = mesh_lib.make_host_mesh(device="cpu")
    struct = TS.state_struct(cfg, optimizer)
    assert all(t.is_meta for t in tree_leaves(struct.params))
    got = elastic.remesh_restore(ck, struct, cfg, mesh)
    assert type(got.opt) is type(state.opt)
    want = _flat(state)
    for k, a in _flat(got).items():
        assert a.device.type == "cpu" and not a.is_meta, k
        assert a.dtype == want[k].dtype and torch.equal(a, want[k]), k
    specs = elastic.state_specs(struct, cfg, mesh)
    assert all(tuple(s) == (None,) * len(s) for s in
               tree_leaves(specs.params))
    assert ck.keys()[0].startswith(".params/") and ".step" in ck.keys()


def _flat(state):
    return dict(_flatten(state))


def test_restore_places_blocks_under_shardings(tmp_path):
    """``restore(shardings=)`` on a duck-typed two-rank coordinate: each
    leaf comes back as the block the spec names."""
    tree = {"a": torch.arange(24.0).reshape(4, 6), "b": torch.arange(6.0)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)

    class Rank1:
        axis_names = ("data", "model")
        devices = np.empty((2, 1), dtype=object)
        coord = {"data": 1, "model": 0}
        device = torch.device("cpu")

    sh = {"a": shd.NamedSharding(Rank1(), P("data", None)),
          "b": shd.NamedSharding(Rank1(), P(None))}
    got = ck.restore({k: torch.empty(v.shape, device="meta")
                      for k, v in tree.items()}, shardings=sh)
    assert torch.equal(got["a"], tree["a"][2:]) and got["a"].is_contiguous()
    assert torch.equal(got["b"], tree["b"])


# ----------------------------------------------------------------- serve

def test_serve_ckpt_dir_gives_the_jax_launchers_tokens(tmp_path, capsys,
                                                      monkeypatch):
    """A parameter checkpoint written by the port: the port's
    ``launch/serve.py --ckpt-dir`` and the JAX launcher's print the same
    greedy tokens; the port also serves a training state's
    ``.params``."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    cfg = get_smoke_config("smollm-360m")
    state = TS.init_state(cfg, torch.Generator().manual_seed(7), "cpu")
    params_dir, state_dir = tmp_path / "params", tmp_path / "state"
    Checkpointer(str(params_dir)).save(1, state.params)
    Checkpointer(str(state_dir)).save(2, state)
    argv = ["--smoke", "--batch", "2", "--prompt-len", "8", "--steps", "4",
            "--ckpt-dir"]

    def first_sequence(out):
        return [ln for ln in out.splitlines()
                if ln.startswith("[serve] first sequence:")]

    serve_cli.main(argv + [str(params_dir), "--device", "cpu"])
    port = first_sequence(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv + [str(params_dir)])
    jserve.main()
    want = first_sequence(capsys.readouterr().out)
    assert port == want and len(want) == 1
    serve_cli.main(argv + [str(state_dir), "--device", "cpu"])
    assert first_sequence(capsys.readouterr().out) == want
    for got, ref in zip(tree_leaves(serve_cli.load_params(
            cfg, torch.device("cpu"), str(state_dir))),
            tree_leaves(state.params)):
        assert torch.equal(got, ref)


def test_distributed_modules_import_no_jax():
    """The distributed modules and the launchers that use them, imported
    alone: neither jax nor anything of the JAX package comes in."""
    import subprocess
    code = (
        "import sys\n"
        "import repro_torch.dist, repro_torch.dist.collectives\n"
        "import repro_torch.launch.mesh, repro_torch.launch.train\n"
        "import repro_torch.launch.serve, repro_torch.runtime.elastic\n"
        "import repro_torch.runtime.fault_tolerance\n"
        "import repro_torch.optim.compression, repro_torch.models.moe\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
