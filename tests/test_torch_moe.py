"""The port's MoE serving slice against the JAX package on the CPU.

The MoE layer (``repro_torch.models.moe``) against ``repro.models.moe``'s
pjit path under ``REPRO_KERNELS=ref`` and ``interpret``: routing, the
sort dispatch's fields (equal), the layer output and the aux loss (f32
``atol=rtol=1e-5``), with a capacity that drops and the dense oracle
when nothing drops.  The whole ``qwen3-moe-235b-a22b-smoke`` model (f32
parameters made by the JAX init, carried by ``bridge.from_jax``):
prefill and decode logits within ``atol=rtol=1e-4``, and greedy tokens
identical to the JAX dense and paged engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs.base import get_config as j_get
from repro.configs.base import get_smoke_config as j_smoke
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import ops
from repro_torch.bridge import from_jax, to_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (ACCEPTANCE_TRACE, DecodeEngine,
                                      Request, acceptance_requests,
                                      solo_greedy)

CPU = torch.device("cpu")
ARCH = "qwen3-moe-235b-a22b"
CLOSE = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def smoke():
    jcfg = j_smoke(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_smoke_config(ARCH), tparams


def _layer0(smoke):
    _, jp, _, tp = smoke
    return (jax.tree.map(lambda t: t[0], jp["layers"]["u0"]["moe"]),
            {k: v[0] for k, v in tp["layers"]["u0"]["moe"].items()})


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_router_logits_and_routing_match_jax(smoke, monkeypatch):
    """bf16 tokens x the f32 router: the JAX package promotes A to f32;
    the port casts it (exact), so the kernels see one dtype."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jm, tm = _layer0(smoke)
    xe = _x((24, 64), 2)
    xb = jnp.asarray(xe).astype(jnp.bfloat16)
    tb = from_jax({"x": np.asarray(xb)})["x"]
    want = np.asarray(jops.gemm(xb, jm["router"], out_dtype=jnp.float32))
    got = ops.gemm(tb.float(), tm["router"], out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **CLOSE)
    # the one-shot gemm takes the mixed pair on the CPU as well
    np.testing.assert_allclose(
        ops.gemm(tb, tm["router"], out_dtype=torch.float32).numpy(), want,
        **CLOSE)
    jprobs, jgates, jids = JM._route(xb, jm["router"], 2)
    tprobs, tgates, tids = TM._route(tb, tm["router"], 2)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **CLOSE)
    np.testing.assert_allclose(tgates.numpy(), np.asarray(jgates), **CLOSE)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def test_routing_breaks_ties_toward_the_lower_expert():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    logits = torch.log(probs)
    router = torch.eye(4)
    _, _, ids = TM._route(logits, router, 2)
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy())), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.tolist() == [[1, 2], [0, 1]]


@pytest.mark.parametrize("t,cf", [(20, 8.0), (64, 0.25)])
def test_sort_dispatch_fields_equal_jax(t, cf):
    """The same routed ids give the same dispatch, field by field; at
    capacity factor 0.25 (64 tokens x top-2 over 8 experts, capacity 8)
    assignments drop."""
    rng = np.random.default_rng(5)
    xe = _x((t, 16), 6)
    ids = np.stack([rng.choice(8, 2, replace=False) for _ in range(t)]) \
        .astype(np.int32)
    c = JM.capacity(t, 8, 2, cf)
    assert c == TM.capacity(t, 8, 2, cf)
    want = JM._sort_dispatch(jnp.asarray(xe), jnp.asarray(ids), 2, 8, c)
    got = TM._sort_dispatch(torch.as_tensor(xe),
                            torch.as_tensor(ids).long(), 2, 8, c)
    for f in ("xs", "sizes", "counts", "dest", "slot", "token_idx", "order",
              "in_cap", "sorted_e"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (not got.in_cap.all()) == (cf < 1)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_ffn_matches_jax_pjit(smoke, monkeypatch, mode, cf):
    monkeypatch.setenv("REPRO_KERNELS", mode)
    jm, tm = _layer0(smoke)
    x = _x((4, 16, 64), 3)
    jy, jaux = JM._moe_ffn_pjit(jm, jnp.asarray(x), top_k=2,
                                capacity_factor=cf)
    ty, taux = TM.moe_ffn(tm, torch.as_tensor(x), top_k=2,
                          capacity_factor=cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **CLOSE)
    np.testing.assert_allclose(float(taux), float(jaux), **CLOSE)
    if cf >= 1:       # nothing drops: the dense oracle agrees
        dense = TM.moe_ffn_dense_ref(tm, torch.as_tensor(x), top_k=2)
        np.testing.assert_allclose(ty.numpy(), dense.numpy(), **CLOSE)
        np.testing.assert_allclose(
            dense.numpy(), np.asarray(JM.moe_ffn_dense_ref(
                jm, jnp.asarray(x), top_k=2)), **CLOSE)


def test_moe_ffn_without_the_aux_loss_serves_the_same_output(smoke):
    """The serve path skips the training-only aux loss: the layer's
    output keeps its bits and the loss comes back as None."""
    _, tm = _layer0(smoke)
    x = torch.as_tensor(_x((2, 8, 64), 5))
    y, aux = TM.moe_ffn(tm, x, top_k=2)
    y_serve, none = TM.moe_ffn(tm, x, top_k=2, aux_loss=False)
    assert torch.equal(y, y_serve) and none is None and aux.dim() == 0


def test_prefill_and_decode_logits_match_jax(smoke, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jcfg, jp, tcfg, tp = smoke
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 12)) \
        .astype(np.int32)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks),
                        JT.init_cache(jcfg, 2, 40))
    tl, tc = T.prefill(tp, tcfg, torch.as_tensor(toks),
                       T.init_cache(tcfg, 2, 40, device=CPU))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    step = jax.jit(lambda t, c: JT.decode_step(jp, jcfg, t, c))
    jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl, -1)[:, None]
    for _ in range(8):
        jl, jc = step(jt, jc)
        tl, tc = T.decode_step(tp, tcfg, tt, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_match_jax_engine(smoke, monkeypatch, paged):
    """The acceptance trace through both packages' engines, dense and
    paged (16-token pages, 8-token chunks): the same tokens, request by
    request."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.serve.engine import DecodeEngine as JEngine
    from repro.serve.engine import acceptance_requests as j_reqs
    jcfg, jp, tcfg, tp = smoke
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    kw = dict(page_size=16, prefill_chunk=8) if paged else {}
    want = {r.rid: r.tokens for r in
            JEngine(jp, jcfg, batch=2, max_len=max_len, **kw).run(
                j_reqs(jcfg.vocab))}
    got = {r.rid: r.tokens for r in
           DecodeEngine(tp, tcfg, batch=2, max_len=max_len, device=CPU,
                        **kw).run(acceptance_requests(tcfg.vocab))}
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_continuous_batch_equals_solo_greedy(smoke):
    _, _, cfg, params = smoke
    max_len = max(p + mt for p, mt in ACCEPTANCE_TRACE) + 1
    reqs = acceptance_requests(cfg.vocab)
    engine = DecodeEngine(params, cfg, batch=2, max_len=max_len, device=CPU)
    results = {r.rid: r.tokens for r in engine.run(reqs)}
    for req in reqs:
        np.testing.assert_array_equal(
            results[req.rid],
            solo_greedy(params, cfg, req.prompt, req.max_tokens, max_len))


def test_bridge_carries_the_moe_subtree_bit_for_bit():
    """bf16 banks and the f32 router cross unchanged, both ways."""
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="bfloat16")
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    jm = jax.tree.map(np.asarray, jp["layers"]["u0"]["moe"])
    tm = from_jax(jm)
    assert tm["router"].dtype == torch.float32
    for name in ("w_gate", "w_up", "w_down"):
        assert tm[name].dtype == torch.bfloat16
        assert tuple(tm[name].shape) == jm[name].shape
    back = to_numpy(tm)
    for name, leaf in jm.items():
        np.testing.assert_array_equal(back[name].view(np.uint8),
                                      leaf.view(np.uint8))


def test_config_and_init_layout_match_jax():
    cfg, jcfg = get_config(ARCH), j_get(ARCH)
    for f in jcfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    T.check_supported(cfg)
    scfg = get_smoke_config(ARCH)
    struct = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   j_smoke(ARCH)))
    tp = T.init_params(scfg, torch.Generator().manual_seed(0), device=CPU)
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(struct)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", v

    tflat = dict(flat(tp))
    assert sorted(tflat) == sorted(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[-1] == jflat[k].dtype.name, k
    bank = tflat["['layers']['u0']['moe']['w_down']"]
    assert abs(bank.std().item() * scfg.d_ff ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("paged", [False, True])
def test_serve_cli_serves_qwen3_moe_smoke_on_the_cpu(capsys, paged):
    argv = ["--arch", ARCH, "--smoke", "--trace", "4", "--slots", "2",
            "--steps", "5", "--rate", "1000", "--device", "cpu"]
    if paged:
        argv += ["--page-size", "16", "--prefill-chunk", "8"]
    serve_cli.main(argv)
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}-smoke (float32)" in out
    assert "[serve] trace: 4/4 requests" in out
    assert ("[serve] paged KV:" in out) == paged


def test_engine_serves_moe_with_requests_of_any_phase(smoke):
    """A request admitted mid-stream decodes the same tokens as alone."""
    _, _, cfg, params = smoke
    rng = np.random.default_rng(8)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (p,)).astype(np.int32),
                    max_tokens=mt) for p, mt in ((3, 9), (17, 4), (6, 7))]
    got = {r.rid: r.tokens for r in DecodeEngine(
        params, cfg, batch=2, max_len=32, device=CPU).run(reqs)}
    for req in reqs:
        np.testing.assert_array_equal(
            got[req.rid],
            solo_greedy(params, cfg, req.prompt, req.max_tokens, 32))
