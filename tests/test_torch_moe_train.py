"""The port's MoE training against the JAX package on the CPU.

The grouped GEMM's autograd Function (``_GroupedCore``) against
``jax.grad`` through ``repro.ops.gemm_grouped``, and the whole
``qwen3-moe-235b-a22b-smoke`` model (f32 parameters made by the JAX
init, carried by ``bridge``) against ``jax.value_and_grad`` of the JAX
``loss_fn``; the JAX side runs with ``REPRO_KERNELS=ref``.  Tolerances,
each stated where it is used:

* the Function's dA, dB and dbias: atol = rtol = 1e-5 (one or two f32
  products summed in another order);
* loss and every gradient leaf of ``loss_fn``: atol = rtol = 1e-4;
* six Adafactor steps: the loss curves within 2e-4 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro import quant as jquant
from repro.configs.base import get_smoke_config as j_smoke
from repro.data import pipeline as JP
from repro.models import transformer as JT
from repro.optim import adafactor as JAF
from repro.train import train_step as JTS
from repro_torch import ops
from repro_torch.bridge import from_jax, train_state_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as P
from repro_torch.kernels import api
from repro_torch.kernels.gemm_grouped import gemm_grouped_plain
from repro_torch.launch import train as train_cli
from repro_torch.models import moe as TM
from repro_torch.optim import adafactor as AF
from repro_torch.train import train_step as TS

ARCH = "qwen3-moe-235b-a22b"


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


def _smoke(capacity_factor=None):
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def smoke():
    return _smoke()


def _port_paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _port_paths(v, f"{pre}['{k}']")
        else:
            yield f"{pre}['{k}']", v


def _assert_trees_close(port, jax_tree, atol, rtol):
    want = {jtu.keystr(k): np.asarray(v)
            for k, v in jtu.tree_flatten_with_path(jax_tree)[0]}
    got = dict(_port_paths(port))
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(), want[key],
                                   atol=atol, rtol=rtol, err_msg=key)


def _batch(jcfg, tcfg, step=0, seq_len=16, rows=2):
    dc = dict(seq_len=seq_len, global_batch=rows, seed=3)
    return (JP.make_batch(jcfg, JP.DataConfig(**dc), step),
            P.make_batch(tcfg, P.DataConfig(**dc), step))


# ------------------------------------------- the grouped GEMM Function

#: (group sizes, routed rows m, bias, activation, quantized bank)
GROUPED_CASES = {
    "bias+silu": ([5, 3, 4, 2], 14, True, "silu", False),
    "plain": ([5, 3, 4, 2], 14, False, None, False),
    "empty group bias+gelu": ([5, 0, 6, 3], 14, True, "gelu", False),
    "rows past the groups": ([4, 3, 0, 2], 14, True, "silu", False),
    "w8a16 bank": ([5, 3, 4, 2], 14, False, "silu", True),
}


@pytest.mark.parametrize("name", list(GROUPED_CASES))
def test_grouped_function_grads_match_jax(name):
    """d(sum(gemm_grouped(...) * g)) by the port's _GroupedCore against
    jax.grad of repro.ops.gemm_grouped, f32, atol = rtol = 1e-5.  Rows at
    and past sum(sizes) get a zero dA; a quantized bank gets no gradient
    on either side (JAX: float0 for q), only dA."""
    sizes, m, bias, act, quantized = GROUPED_CASES[name]
    e, k, n = len(sizes), 24, 16
    rng = np.random.default_rng(len(name))
    o = {"a": rng.standard_normal((m, k), np.float32),
         "b": rng.standard_normal((e, k, n), np.float32) / np.sqrt(k),
         "bias": rng.standard_normal((e, n), np.float32)}
    g = rng.standard_normal((m, n), np.float32)
    diff = ["a"] + ([] if quantized else ["b"]) + (["bias"] if bias else [])
    jw = {x: jnp.asarray(v) for x, v in o.items()}
    tw = {x: torch.as_tensor(v) for x, v in o.items()}
    if quantized:
        jw["b"] = jquant.quantize_weight(jw["b"])
        tw["b"] = {x: torch.as_tensor(np.array(v))
                   for x, v in jw["b"].items()}
    gs = np.asarray(sizes, np.int32)

    def j_loss(*xs):
        args = dict(jw, **dict(zip(diff, xs)))
        out = jops.gemm_grouped(args["a"], args["b"], jnp.asarray(gs),
                                bias=args["bias"] if bias else None,
                                activation=act, out_dtype=jnp.float32)
        return jnp.sum(out * g)

    jgrads = jax.grad(j_loss, argnums=tuple(range(len(diff))))(
        *(jw[x] for x in diff))
    leaves = {x: tw[x].clone().requires_grad_() for x in diff}
    args = dict(tw, **leaves)
    out = ops.gemm_grouped(args["a"], args["b"], torch.as_tensor(gs),
                           bias=args["bias"] if bias else None,
                           activation=act, out_dtype=torch.float32)
    assert out.grad_fn is not None
    (out * torch.as_tensor(g)).sum().backward()
    for x, jg in zip(diff, jgrads):
        np.testing.assert_allclose(leaves[x].grad.numpy(), np.asarray(jg),
                                   atol=1e-5, rtol=1e-5, err_msg=x)
    assert not leaves["a"].grad[sum(sizes):].any()
    if quantized:
        assert tw["b"]["q"].grad is None and tw["b"]["scale"].grad is None


def test_grouped_gemm_backward_runs_planned_grouped_gemms():
    """The backward's products are planned grouped GEMMs: the f32
    pre-activation recompute and dA against the transposed bank (k and
    n swapped), on the same group sizes; dB is the plain per-expert
    product, not a plan."""
    api.plan_cache_clear()
    a = torch.randn(12, 8, requires_grad=True)
    bank = torch.randn(3, 8, 6, requires_grad=True)
    sizes = torch.tensor([4, 0, 5], dtype=torch.int32)
    before = gemm_grouped_plain.launches
    ops.gemm_grouped(a, bank, sizes, activation="silu").sum().backward()
    assert gemm_grouped_plain.launches - before == 3
    got = {(p.m, p.k, p.n, p.spec.epilogue.key, p.out_dtype)
           for p in ops.plans()}
    f32 = torch.float32
    assert got == {(12, 8, 6, "silu", f32), (12, 8, 6, "", f32),
                   (12, 6, 8, "", f32)}
    assert bank.grad[1].abs().sum() == 0 and bank.grad[0].abs().sum() > 0


def test_grouped_gemm_without_grad_mode_dispatches_directly(monkeypatch):
    """Serving runs under inference_mode / no_grad: the grouped GEMM
    launches without the Function, so its output carries no graph."""
    applied = []
    real = api._GroupedCore.apply
    monkeypatch.setattr(api._GroupedCore, "apply",
                        lambda *xs: applied.append(1) or real(*xs))
    a = torch.randn(6, 8, requires_grad=True)
    bank = torch.randn(2, 8, 4)
    sizes = torch.tensor([3, 3], dtype=torch.int32)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            for _ in range(2):                  # the plan, then the repeat
                assert ops.gemm_grouped(a, bank, sizes).grad_fn is None
    assert applied == []
    assert ops.gemm_grouped(a, bank, sizes).grad_fn is not None
    assert applied == [1]


# ------------------------------------------------------------ loss_fn


def _dropped(monkeypatch):
    """Record, for every MoE dispatch, whether an assignment was dropped."""
    seen = []
    real = TM._sort_dispatch

    def spy(*args):
        dsp = real(*args)
        seen.append(bool((~dsp.in_cap).any()))
        return dsp
    monkeypatch.setattr(TM, "_sort_dispatch", spy)
    return seen


@pytest.mark.parametrize("capacity_factor", [None, 1.0])
def test_moe_loss_and_grads_match_jax(monkeypatch, capacity_factor):
    """qwen3-moe smoke, f32, atol = rtol = 1e-4, every gradient leaf (the
    router and the three banks included): at the smoke capacity (8.0,
    nothing dropped) and at 1.0, where assignments are dropped."""
    jcfg, jp, tcfg, tp = _smoke(capacity_factor)
    jb, tb = _batch(jcfg, tcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True)(jp)
    seen = _dropped(monkeypatch)
    tl, tm, tg = TS.value_and_grad(tp, tcfg, tb)
    assert any(seen) == (capacity_factor is not None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tm["aux"].numpy(), np.asarray(jm["aux"]),
                               atol=1e-4, rtol=1e-4)
    _assert_trees_close(tg, jg, 1e-4, 1e-4)
    for key in ("router", "w_gate", "w_up", "w_down"):
        assert tg["layers"]["u0"]["moe"][key].abs().sum() > 0


def test_moe_remat_does_not_change_the_gradient(smoke):
    """The remat recompute routes the tokens as the forward did: the
    gradients with and without checkpointing are equal bit for bit."""
    jcfg, _, tcfg, tp = smoke
    _, tb = _batch(jcfg, tcfg)
    a = TS.value_and_grad(tp, tcfg, tb, remat=True)
    b = TS.value_and_grad(tp, tcfg, tb, remat=False)
    assert torch.equal(a[0], b[0])
    for (_, x), (_, y) in zip(_port_paths(a[2]), _port_paths(b[2])):
        assert torch.equal(x, y)


# ------------------------------------------------------- train steps


def test_six_adafactor_steps_track_the_jax_loss_curve(smoke):
    """Six Adafactor steps of qwen3-moe smoke from one state on the same
    batches: the loss within 2e-4 absolute at every step and the grad
    norm within rtol 1e-3 (Adafactor's update is a smooth function of
    the gradient, so last-bit differences stay small)."""
    jcfg, jp, tcfg, _ = smoke
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6,
              optimizer="adafactor")
    jstate = JTS.TrainState(params=jp, opt=JAF.init(jp),
                            step=jnp.zeros((), jnp.int32))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(JTS.make_train_step(jcfg, **kw))
    tstep = TS.make_train_step(tcfg, **kw)
    dc = dict(seq_len=16, global_batch=4, seed=0)
    jl, tl = [], []
    for step in range(6):
        jstate, jm = jstep(jstate, JP.make_batch(jcfg, JP.DataConfig(**dc),
                                                 step))
        tstate, tm = tstep(tstate, P.make_batch(tcfg, P.DataConfig(**dc),
                                                step))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    np.testing.assert_allclose(tl, jl, atol=2e-4, rtol=0)
    assert isinstance(tstate.opt, AF.AdafactorState)
    assert int(tstate.step) == 6 and int(tstate.opt.step) == 6


def test_train_takes_the_optimizer(capsys):
    """``train(optimizer=...)`` reaches the state and the step: the smoke
    model (AdamW by size) trains with Adafactor when asked."""
    seen = []
    train_cli.train(get_smoke_config(ARCH), steps=2, seq_len=8,
                    global_batch=2, device="cpu", optimizer="adafactor",
                    on_step=lambda s, state, m, t: seen.append(state.opt))
    assert [type(o) for o in seen] == [AF.AdafactorState] * 2
    assert int(seen[-1].step) == 2
    assert len(capsys.readouterr().out.splitlines()) == 2
