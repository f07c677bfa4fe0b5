"""The port's training slice against the JAX package on the CPU.

``smollm-360m-smoke`` (f32) parameters come from the JAX init through
``bridge``; the JAX side runs with ``REPRO_KERNELS=ref``.  Tolerances,
each stated where it is used:

* loss and every gradient leaf of ``loss_fn``: atol = rtol = 1e-4 (f32
  sums in another order; the readings are ~1e-6);
* the GEMM and attention Functions' gradients: atol = rtol = 1e-5 (one
  or two f32 products);
* one optimizer update on identical f32 gradients: atol = rtol = 1e-6;
* six train steps: the loss curves within 2e-4 absolute (see the test);
* ``make_batch``: equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs.base import get_smoke_config as j_smoke
from repro.data import pipeline as JP
from repro.kernels.blocked_attention import attention_blocked as j_blocked
from repro.models import transformer as JT
from repro.optim import adafactor as JAF
from repro.optim import adamw as JAW
from repro.optim import schedule as JS
from repro.train import train_step as JTS
from repro_torch import ops
from repro_torch.bridge import (from_jax, to_numpy, train_state_from_jax,
                                tree_leaves)
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as P
from repro_torch.kernels import api
from repro_torch.kernels.blocked_attention import attention_blocked
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.optim import adafactor as AF
from repro_torch.optim import adamw as AW
from repro_torch.optim import schedule as S
from repro_torch.train import train_step as TS

ARCH = "smollm-360m"


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


@pytest.fixture(scope="module")
def smoke():
    jcfg = j_smoke(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, get_smoke_config(ARCH), \
        from_jax(jax.tree.map(np.asarray, jparams))


def _by_path(tree) -> dict:
    """A JAX pytree's leaves as numpy, keyed "['a']['b']"."""
    return {jtu.keystr(k): np.asarray(v)
            for k, v in jtu.tree_flatten_with_path(tree)[0]}


def _port_paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _port_paths(v, f"{pre}['{k}']")
        else:
            yield f"{pre}['{k}']", v


def _assert_trees_close(port, jax_tree, atol, rtol):
    want = _by_path(jax_tree)
    got = dict(_port_paths(port))
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(), want[key],
                                   atol=atol, rtol=rtol, err_msg=key)


def _batch(jcfg, tcfg, seq_len=16, rows=2, step=0, mask=False):
    dc = dict(seq_len=seq_len, global_batch=rows, seed=3)
    jb = JP.make_batch(jcfg, JP.DataConfig(**dc), step)
    tb = P.make_batch(tcfg, P.DataConfig(**dc), step)
    if mask:
        m = np.random.default_rng(5).random((rows, seq_len)) < 0.7
        jb = dict(jb, mask=jnp.asarray(m))
        tb = dict(tb, mask=torch.as_tensor(m))
    return jb, tb


# ------------------------------------------------------------ loss_fn


@pytest.mark.parametrize("n_chunks,mask,remat", [
    (1, False, True), (2, False, True), (3, True, True), (2, True, False)])
def test_loss_and_grads_match_jax(smoke, n_chunks, mask, remat):
    """f32, atol = rtol = 1e-4; n_chunks 3 pads the 16 positions to 18
    and a label mask drops ~30 % of them."""
    jcfg, jp, tcfg, tp = smoke
    jb, tb = _batch(jcfg, tcfg, mask=mask)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb, n_chunks=n_chunks, remat=remat),
        has_aux=True)(jp)
    tl, _, tg = TS.value_and_grad(tp, tcfg, tb, n_chunks=n_chunks,
                                  remat=remat)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _assert_trees_close(tg, jg, 1e-4, 1e-4)


def test_remat_does_not_change_the_gradient(smoke):
    """Checkpointing each unit recomputes the same kernels on the same
    inputs: equal bit for bit."""
    _, _, tcfg, tp = smoke
    _, tb = _batch(j_smoke(ARCH), tcfg)
    a = TS.value_and_grad(tp, tcfg, tb, remat=True)
    b = TS.value_and_grad(tp, tcfg, tb, remat=False)
    assert torch.equal(a[0], b[0])
    for (_, x), (_, y) in zip(_port_paths(a[2]), _port_paths(b[2])):
        assert torch.equal(x, y)


def test_forward_raises_for_what_is_not_ported(smoke):
    """Prefix embeddings and frames are ported (tests/test_torch_archs.py);
    what ``forward`` still refuses is what the config cannot take:
    prefix embeddings of another width, frames for a model with no
    encoder, an encoder beside a tail."""
    _, _, tcfg, tp = smoke
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="prefix embeddings of width 59"):
        T.forward(tp, tcfg, toks, prefix_embeds=torch.zeros((1, 2, 59)))
    with pytest.raises(ValueError, match="no encoder to take frames"):
        T.forward(tp, tcfg, toks, frames=torch.zeros((1, 2, 60)))
    with pytest.raises(ValueError, match="an encoder needs"):
        T.forward(tp, dataclasses.replace(tcfg, encoder_layers=2, n_layers=3,
                                          tail_pattern=("attn",)), toks)


# -------------------------------------------------- the GEMM Function

GEMM_CASES = {
    "plain": {},
    "plain tb": {"strategy": "tb"},
    "bias+gelu": {"bias": True, "activation": "gelu"},
    "bias+silu": {"bias": True, "activation": "silu"},
    "bias+relu": {"bias": True, "activation": "relu"},
    "residual": {"residual": True},
    "bias+silu+residual tb": {"bias": True, "activation": "silu",
                              "residual": True, "strategy": "tb"},
    "gated silu": {"gated": True, "activation": "silu"},
    "gated gelu": {"gated": True, "activation": "gelu"},
    "w8a16": {"quant": True},
    "w8a16 gated": {"quant": True, "gated": True, "activation": "silu"},
}


def _gemm_operands(case, m=12, k=40, n=24, seed=0):
    rng = np.random.default_rng(seed)
    ops_ = {"a": rng.standard_normal((2, m // 2, k), np.float32),
            "b": rng.standard_normal((k, n), np.float32) / np.sqrt(k),
            "g": rng.standard_normal((2, m // 2, n), np.float32)}
    if case.get("gated"):
        ops_["b2"] = rng.standard_normal((k, n), np.float32) / np.sqrt(k)
    if case.get("bias"):
        ops_["bias"] = rng.standard_normal((n,), np.float32)
    if case.get("residual"):
        ops_["residual"] = rng.standard_normal((2, m // 2, n), np.float32)
    return ops_


def _quantize(w):
    """The same int8 weight struct for both packages."""
    from repro.quant import quantize_weight
    q = quantize_weight(jnp.asarray(w))
    return q, {"q": torch.as_tensor(np.array(q["q"])),
               "scale": torch.as_tensor(np.array(q["scale"]))}


@pytest.mark.parametrize("name", list(GEMM_CASES))
def test_gemm_function_grads_match_jax(name):
    """d(sum(gemm(...) * g)) by the port's _GemmCore against jax.grad of
    repro.ops.gemm, f32, atol = rtol = 1e-5.  A quantized weight gets no
    gradient on either side (JAX: float0 for q, zeros for the scale;
    the port: none)."""
    case = GEMM_CASES[name]
    o = _gemm_operands(case)
    diff = ["a"] + [n for n in ("b", "b2", "bias", "residual") if n in o
                    and not (case.get("quant") and n in ("b", "b2"))]
    kw = {k: case[k] for k in ("activation", "strategy") if k in case}
    jw = {n: jnp.asarray(o[n]) for n in o}
    tw = {n: torch.as_tensor(o[n]) for n in o}
    if case.get("quant"):
        jw["b"], tw["b"] = _quantize(o["b"])
        if "b2" in o:
            jw["b2"], tw["b2"] = _quantize(o["b2"])

    def j_loss(*xs):
        args = dict(jw, **dict(zip(diff, xs)))
        out = jops.gemm(args["a"], args["b"], b2=args.get("b2"),
                        bias=args.get("bias"), residual=args.get("residual"),
                        **kw)
        return jnp.sum(out * args["g"])

    jgrads = jax.grad(j_loss, argnums=tuple(range(len(diff))))(
        *(jw[n] for n in diff))
    leaves = {n: tw[n].clone().requires_grad_() for n in diff}
    if case.get("quant"):
        for n in ("b", "b2"):
            if n in tw:
                tw[n]["scale"].requires_grad_()
    args = dict(tw, **leaves)
    out = ops.gemm(args["a"], args["b"], b2=args.get("b2"),
                   bias=args.get("bias"), residual=args.get("residual"), **kw)
    assert out.grad_fn is not None
    (out * args["g"]).sum().backward()
    for n, jg in zip(diff, jgrads):
        np.testing.assert_allclose(leaves[n].grad.numpy(), np.asarray(jg),
                                   atol=1e-5, rtol=1e-5, err_msg=n)
    if case.get("quant"):
        assert tw["b"]["scale"].grad is None


def test_gemm_function_is_off_without_grad_mode():
    """Serving runs under inference_mode: the one-shot GEMM dispatches
    directly and its output carries no graph."""
    a = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 6)
    with torch.inference_mode():
        assert ops.gemm(a, w).grad_fn is None
    assert ops.gemm(a, w).grad_fn is not None


def test_grouped_gemm_refuses_a_gradient():
    """B7 has a backward: with grad mode on the grouped GEMM (first call
    and the one-shot repeat) carries a graph and its gradients equal the
    dense masked composition's; under no_grad it dispatches without the
    Function and carries none."""
    a = torch.randn(6, 8, requires_grad=True)
    bank = torch.randn(2, 8, 4, requires_grad=True)
    sizes = torch.tensor([3, 2], dtype=torch.int32)
    gid = torch.tensor([0, 0, 0, 1, 1, 1])
    live = torch.tensor([1.0] * 5 + [0.0])[:, None]
    want = torch.autograd.grad(
        (torch.einsum("rk,rkn->rn", a, bank[gid]) * live).square().sum(),
        (a, bank))
    for _ in range(2):                          # the plan, then the repeat
        out = ops.gemm_grouped(a, bank, sizes)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out.square().sum(), (a, bank))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        out = ops.gemm_grouped(a, bank, sizes)
    assert out.shape == (6, 4) and out.grad_fn is None


def test_backward_runs_planned_gemms():
    """Every backward product is a planned GEMM: the plans the backward
    adds are the dA / dB shapes (f32 pre-activation recompute for an
    activation)."""
    api.plan_cache_clear()
    a = torch.randn(16, 40, requires_grad=True)
    w = torch.randn(40, 24, requires_grad=True)
    bias = torch.randn(24, requires_grad=True)
    out = ops.gemm(a, w, bias=bias, activation="silu")
    before = {(p.m, p.k, p.n, p.spec.epilogue.key) for p in ops.plans()}
    out.sum().backward()
    after = {(p.m, p.k, p.n, p.spec.epilogue.key, p.spec.out_dtype)
             for p in ops.plans()}
    assert before == {(16, 40, 24, "bias+silu")}
    assert {(16, 40, 24, "", "float32"), (16, 24, 40, "", "float32"),
            (40, 16, 24, "", "float32")} <= after


# --------------------------------------------- the attention Function


@pytest.mark.parametrize("s,hq,hkv,window,q_offset", [
    (40, 3, 1, 0, None), (33, 4, 2, 8, None), (12, 2, 2, 0, 20),
    (1100, 2, 1, 0, None)])
def test_attention_function_grads_match_jax(s, hq, hkv, window, q_offset):
    """Forward (B3's plain version) and the recompute backward against
    repro.ops.attention, f32, atol = rtol = 1e-5.  s = 1100 is past
    BLOCKED_ATTN_THRESHOLD: both packages recompute through the blocked
    path."""
    rng = np.random.default_rng(s)
    skv = s + (q_offset or 0)
    q = rng.standard_normal((1, s, hq, 8), np.float32)
    k = rng.standard_normal((1, skv, hkv, 8), np.float32)
    v = rng.standard_normal((1, skv, hkv, 8), np.float32)
    g = rng.standard_normal((1, s, hq, 8), np.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset)

    def j_loss(q, k, v):
        return jnp.sum(jops.attention(q, k, v, **kw) * g)

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    out = ops.attention(tq, tk, tv, **kw)
    (out * torch.as_tensor(g)).sum().backward()
    want = np.asarray(jops.attention(q, k, v, **kw))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    for t, j, name in zip((tq, tk, tv), jg, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("sq,skv,bq,bkv,window", [
    (1100, 1100, 512, 1024, 0), (37, 50, 16, 8, 0), (64, 64, 16, 32, 20)])
def test_attention_blocked_matches_jax_and_reference(sq, skv, bq, bkv,
                                                     window):
    """The plain blocked twin against the JAX one and against the
    unblocked reference (forward and gradients), f32, atol = rtol =
    1e-5."""
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, sq, 4, 16), np.float32)
    k = rng.standard_normal((2, skv, 2, 16), np.float32)
    v = rng.standard_normal((2, skv, 2, 16), np.float32)
    kw = dict(causal=True, window=window, bq=bq, bkv=bkv)
    want = np.asarray(j_blocked(q, k, v, **kw))
    tq, tk, tv = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    got = attention_blocked(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    got.sum().backward()
    rq, rk, rv = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    attention_ref(rq, rk, rv, causal=True, window=window).sum().backward()
    for t, r in ((tq, rq), (tk, rk), (tv, rv)):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(),
                                   atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- optimizers


def _random_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape, np.float32) * 0.01), params)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(smoke, opt):
    """One update from a state the JAX optimizer has already stepped
    once (carried over by bridge), on identical f32 gradients: params
    and moments within atol = rtol = 1e-6."""
    jcfg, jp, _, _ = smoke
    jmod, tmod = (JAW, AW) if opt == "adamw" else (JAF, AF)
    kw = {"lr": 1e-3, "weight_decay": 0.1}
    jstate = jmod.init(jp)
    jp1, jstate = jmod.update(_random_grads(jp, 1), jstate, jp, **kw)
    grads = _random_grads(jp, 2)
    jp2, jstate2 = jmod.update(grads, jstate, jp1, **kw)

    carried = train_state_from_jax(jax.tree.map(
        np.asarray, JTS.TrainState(params=jp1, opt=jstate, step=jnp.int32(1))))
    tp2, tstate2 = tmod.update(from_jax(jax.tree.map(np.asarray, grads)),
                               carried.opt, carried.params, **kw)
    _assert_trees_close(tp2, jp2, 1e-6, 1e-6)
    for field in jstate2._fields:
        j, t = getattr(jstate2, field), getattr(tstate2, field)
        if field == "step":
            assert int(t) == int(j) == 2
        else:
            _assert_trees_close(t, j, 1e-6, 1e-6)


def test_train_state_round_trip_is_bit_exact(smoke):
    """JAX TrainState -> port -> numpy equals the JAX leaves bit for
    bit, for both optimizers, bf16 parameters included."""
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="bfloat16")
    for opt in ("adamw", "adafactor"):
        js = JTS.init_state(jax.random.PRNGKey(1), jcfg, opt)
        ts = train_state_from_jax(jax.tree.map(np.asarray, js))
        assert type(ts.opt) is (AW.AdamWState if opt == "adamw"
                                else AF.AdafactorState)
        want = list(_by_path(js).values())
        got = _flat_numpy(to_numpy(ts))
        assert len(got) == len(want)
        for j, t in zip(want, got):
            assert j.dtype == t.dtype and j.shape == t.shape
            assert np.array_equal(j.reshape(-1).view(np.uint8),
                                  t.reshape(-1).view(np.uint8))


def _flat_numpy(state):
    """A port TrainState's numpy leaves in JAX's flattening order
    (named-tuple fields in order, dict keys sorted)."""
    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                yield from walk(x[k])
        elif isinstance(x, tuple):
            for v in x:
                yield from walk(v)
        else:
            yield np.asarray(x)
    return list(walk(state))


def test_schedule_matches_jax():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        np.testing.assert_allclose(
            S.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                            **kw).numpy(),
            np.asarray(JS.warmup_cosine(step, **kw)), rtol=1e-7)
        assert float(S.constant(step, peak_lr=2e-3)) == \
            float(JS.constant(step, peak_lr=2e-3))


@pytest.mark.parametrize("max_norm", [0.05, 100.0])
def test_clip_by_global_norm_matches_jax(smoke, max_norm):
    """Clipping active (0.05) and inactive (100): the norm and the
    clipped leaves within atol = rtol = 1e-6."""
    _, jp, _, _ = smoke
    grads = _random_grads(jp, 4)
    jc, jn = JTS.clip_by_global_norm(grads, max_norm)
    tc, tn = TS.clip_by_global_norm(
        from_jax(jax.tree.map(np.asarray, grads)), max_norm)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    _assert_trees_close(tc, jc, 1e-6, 1e-6)


# ------------------------------------------------------------- data


@pytest.mark.parametrize("seed,step,row_start,rows", [
    (0, 0, 0, None), (3, 7, 0, None), (1, 2, 4, 2)])
def test_make_batch_equals_jax_bit_for_bit(smoke, seed, step, row_start,
                                           rows):
    jcfg, _, tcfg, _ = smoke
    dc = dict(seq_len=24, global_batch=6, seed=seed, row_start=row_start,
              rows=rows)
    jb = JP.make_batch(jcfg, JP.DataConfig(**dc), step)
    tb = P.make_batch(tcfg, P.DataConfig(**dc), step)
    assert sorted(jb) == sorted(tb)
    for key in jb:
        assert tb[key].dtype == torch.int32
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    it = P.iterate(tcfg, P.DataConfig(**dc), start_step=step)
    assert torch.equal(next(it)["tokens"], tb["tokens"])


# ------------------------------------------------------- train steps


@pytest.mark.parametrize("microbatches", [1, 2])
def test_six_train_steps_track_the_jax_loss_curve(smoke, microbatches):
    """Six AdamW steps from one state on the same batches.  The first
    AdamW step divides each gradient element by its own magnitude, so an
    element whose f32 gradient differs in its last bits between the two
    packages can still move by up to lr = 3e-3; parameters are therefore
    not compared bit for bit, the loss is: within 2e-4 absolute at every
    step (the curve falls ~0.1 over the six steps)."""
    jcfg, jp, tcfg, _ = smoke
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6,
              microbatches=microbatches, optimizer="adamw")
    jstate = JTS.TrainState(params=jp, opt=JAW.init(jp),
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
    assert jl[-1] < jl[0] and tl[-1] < tl[0]
    assert int(tstate.step) == 6 and int(tstate.opt.step) == 6


def test_train_step_keeps_bf16_grads_and_f32_moments(smoke):
    """bf16 leaves get bf16 gradients with one microbatch and f32
    accumulators with two; the moments stay f32 and the state's input
    tensors are not written."""
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    state = TS.init_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    before = state.params["lm_head"].clone()
    batch = P.make_batch(tcfg, P.DataConfig(seq_len=8, global_batch=2), 0)
    for mb, dtype in ((1, torch.bfloat16), (2, torch.float32)):
        step = TS.make_train_step(tcfg, microbatches=mb, return_grads=True,
                                  warmup_steps=1)
        new, m = step(state, batch)
        assert m["grads"]["lm_head"].dtype == dtype
        assert m["grads"]["final_norm"]["scale"].dtype == torch.float32
        assert new.params["lm_head"].dtype == torch.bfloat16
        assert new.opt.mu["lm_head"].dtype == torch.float32
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        for g in tree_leaves(m["grads"]):
            assert torch.isfinite(g.float()).all() and g.abs().sum() > 0
    assert torch.equal(state.params["lm_head"], before)


# ------------------------------------------------------------- the CLI


def test_train_cli_smoke_prints_three_steps(capsys):
    train_cli.main(["--smoke", "--steps", "3", "--device", "cpu",
                    "--seq-len", "16", "--global-batch", "2"])
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("[train] step ")]
    assert [ln.split()[2] for ln in steps] == ["0", "1", "2"]
    for ln in steps:
        loss, gnorm = float(ln.split()[4]), float(ln.split()[6])
        assert np.isfinite(loss) and np.isfinite(gnorm)
        assert ln.endswith("ms")
    assert lines[-1].startswith("[train] final:")


@pytest.mark.parametrize("flag", [["--autotune", "8"], ["--batch", "2"]])
def test_train_cli_refuses_what_is_not_ported(flag):
    """The JAX train driver takes neither option (training tunes through
    REPRO_AUTOTUNE / tune.enable), so the port's refuses them."""
    with pytest.raises(SystemExit):
        train_cli.main(["--smoke", "--device", "cpu"] + flag)


def test_train_defaults_to_the_card():
    """Without a card and without --device cpu the launcher raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--steps", "1"])
