"""The recurrent families in the port against the JAX package, on the
CPU: ``recurrentgemma-9b`` (RG-LRU ``rec`` layers, ``local`` attention
over a ring, a (rec, rec) tail) and ``mamba2-370m`` (Mamba-2 SSD).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs with ``REPRO_KERNELS=ref``.  Parameters of the smoke
models (f32) come from the JAX init through ``bridge.from_jax``.
Tolerances: ``atol = rtol = 1e-5`` for the modules (the same f32 ops;
the port's doubling scan and the JAX associative scan combine in
another order, the decode read-out sums by halving), ``1e-4`` for whole
models (those differences through a few layers).  Greedy tokens and the
port's own invariants (continuous == solo, prefill + decode == forward
at the last position) are held exactly or at ``1e-4``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import get_config as j_get
from repro.configs.base import get_smoke_config as j_smoke
from repro.data import pipeline as JP
from repro.models import mamba2 as JM2
from repro.models import rglru as JRG
from repro.models import transformer as JT
from repro.quant import gemm_weight_bytes as j_weight_bytes
from repro.serve.engine import DecodeEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import quant
from repro_torch.bridge import from_jax, to_numpy
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import pipeline as P
from repro_torch.launch import serve as serve_cli
from repro_torch.models import mamba2 as M2
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as T
from repro_torch.serve.engine import DecodeEngine, Request, solo_greedy

CPU = torch.device("cpu")
ARCHS = ("recurrentgemma-9b", "mamba2-370m")
MODULE = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


_SMOKE = {}


def _smoke(arch):
    """(jax cfg, jax params, port cfg, port params), made once."""
    if arch not in _SMOKE:
        jcfg = j_smoke(arch)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _SMOKE[arch] = (jcfg, jp, get_smoke_config(arch),
                        from_jax(jax.tree.map(np.asarray, jp)))
    return _SMOKE[arch]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _tokens(n, vocab, seed, b=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)) \
        .astype(np.int32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=msg, **tol)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("name", [a + s for a in ARCHS
                                  for s in ("", "-smoke")])
def test_configs_match_jax(name):
    """Both registrations of both archs, field for field, and the
    parameter count (``ssm`` counts through the port's ``mamba2.dims``)."""
    arch = name.replace("-smoke", "")
    cfg = get_smoke_config(arch) if "smoke" in name else get_config(name)
    jcfg = j_smoke(arch) if "smoke" in name else j_get(name)
    for f in jcfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    assert arch in ARCH_IDS


# -------------------------------------------------------------- the RG-LRU

D, W = 32, 48


@pytest.fixture(scope="module")
def rg_params():
    jp = JRG.init_rglru(jax.random.PRNGKey(3), D, W, jnp.float32)
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def test_rglru_conv_matches_jax(rg_params):
    jp, tp = rg_params
    x, st = _rand((2, 9, W), 1), _rand((2, 3, W), 2)
    jy, js = JRG._conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"] + 0.1,
                       jnp.asarray(st))
    ty, ts = RG._conv(_t(x), tp["conv_w"], tp["conv_b"] + 0.1, _t(st))
    _close(ty, jy, MODULE)
    _close(ts, js, MODULE)


def test_rglru_gates_match_jax(rg_params):
    jp, tp = rg_params
    x = _rand((2, 11, W), 4)
    ja, jbx = JRG._gates(jp, jnp.asarray(x))
    ta, tbx = RG._gates(tp, _t(x))
    _close(ta, ja, MODULE)
    _close(tbx, jbx, MODULE)


@pytest.mark.parametrize("s", [1, 7, 128, 300])
def test_lru_scan_matches_jax(s):
    """The doubling scan against ``jax.lax.associative_scan``, with a
    nonzero h0, at a decay near the model's (a in (0.8, 1))."""
    a = 0.8 + 0.2 * np.random.default_rng(5).random((2, s, W)) \
        .astype(np.float32)
    bx, h0 = _rand((2, s, W), 6), _rand((2, W), 7)
    want = JRG._lru_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    _close(RG._lru_scan(_t(a), _t(bx), _t(h0)), want, MODULE)


def test_rglru_block_matches_jax(rg_params):
    jp, tp = rg_params
    x = _rand((2, 20, D), 8)
    _close(RG.rglru_block(tp, _t(x)), JRG.rglru_block(jp, jnp.asarray(x)),
           MODULE)


def test_rglru_decode_matches_jax(rg_params):
    jp, tp = rg_params
    x = _rand((3, 1, D), 9)
    cache = {"conv": _rand((3, 3, W), 10), "h": _rand((3, W), 11)}
    jy, jc = JRG.rglru_decode(jp, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, cache))
    ty, tc = RG.rglru_decode(tp, _t(x), from_jax(cache))
    _close(ty, jy, MODULE)
    for k in ("conv", "h"):
        _close(tc[k], jc[k], MODULE, k)


# ---------------------------------------------------------------- Mamba-2

MD, MN = 64, 16          # d_model 64: d_inner 128, 2 heads of 64


@pytest.fixture(scope="module")
def m2_params():
    jp = JM2.init_mamba2(jax.random.PRNGKey(4), MD, MN, jnp.float32)
    return jp, from_jax(jax.tree.map(np.asarray, jp))


def test_causal_conv_matches_jax(m2_params):
    jp, tp = m2_params
    ch = jp["conv_w"].shape[1]
    x, st = _rand((2, 9, ch), 12), _rand((2, 3, ch), 13)
    for state in (None, st):
        jy, js = JM2._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                                  None if state is None
                                  else jnp.asarray(state))
        ty, ts = M2._causal_conv(_t(x), tp["conv_w"], tp["conv_b"],
                                 None if state is None else _t(state))
        _close(ty, jy, MODULE)
        _close(ts, js, MODULE)


def test_segsum_matches_jax():
    a = _rand((2, 3, 16), 14)
    np.testing.assert_array_equal(M2._segsum(_t(a)).numpy() == -np.inf,
                                  np.asarray(JM2._segsum(jnp.asarray(a)))
                                  == -np.inf)
    got, want = M2._segsum(_t(a)).numpy(), np.asarray(
        JM2._segsum(jnp.asarray(a)))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **MODULE)


def _ssd_inputs(tp, s, seed):
    """ssd_chunked's operands as the smoke-scale mixer makes them from a
    random (2, s, 64) input: in-proj, split, causal conv (numpy arrays,
    handed to both packages)."""
    x = _t(_rand((2, s, MD), seed))
    dd = M2.dims(MD, MN)
    with torch.no_grad():
        proj = x @ tp["in_proj"]
        _, xs, b_, c_, dt = M2._split_proj(proj, MD, MN)
        conv, _ = M2._causal_conv(torch.cat([xs, b_, c_], dim=-1),
                                  tp["conv_w"], tp["conv_b"])
    di = dd["d_inner"]
    xh = conv[..., :di].reshape(2, s, dd["heads"], dd["head_dim"])
    return [t.numpy() for t in (xh, dt, tp["a_log"], conv[..., di:di + MN],
                                conv[..., di + MN:], tp["d_skip"],
                                tp["dt_bias"])]


@pytest.mark.parametrize("s", [100, 300])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(m2_params, s, with_state):
    """Lengths that are not a multiple of the 128-token chunk (padded,
    the padding neither decaying nor feeding the state), from a zero
    state or from the state a 200-token segment leaves, on operands at
    the mixer's own scale."""
    _, tp = m2_params
    args = _ssd_inputs(tp, s, 15)
    st = None
    if with_state:
        _, st = M2.ssd_chunked(*map(_t, _ssd_inputs(tp, 200, 16)))
        st = st.numpy()
    jy, js = JM2.ssd_chunked(*map(jnp.asarray, args),
                             init_state=None if st is None
                             else jnp.asarray(st))
    ty, ts = M2.ssd_chunked(*map(_t, args),
                            init_state=None if st is None else _t(st))
    _close(ty, jy, MODULE)
    _close(ts, js, MODULE)


def test_mamba2_block_matches_jax(m2_params):
    jp, tp = m2_params
    x = _rand((2, 150, MD), 22)
    _close(M2.mamba2_block(tp, _t(x), MN),
           JM2.mamba2_block(jp, jnp.asarray(x), MN), MODULE)


def test_mamba2_decode_matches_jax(m2_params):
    jp, tp = m2_params
    x = _rand((3, 1, MD), 23)
    dd = JM2.dims(MD, MN)
    cache = {"conv": _rand((3, 3, dd["d_inner"] + 2 * MN), 24),
             "ssd": _rand((3, dd["heads"], dd["head_dim"], MN), 25)}
    jy, jc = JM2.mamba2_decode(jp, jnp.asarray(x),
                               jax.tree.map(jnp.asarray, cache), MN)
    ty, tc = M2.mamba2_decode(tp, _t(x), from_jax(cache), MN)
    _close(ty, jy, MODULE)
    for k in ("conv", "ssd"):
        _close(tc[k], jc[k], MODULE, k)


# ------------------------------------------------------------ whole models

@pytest.mark.parametrize("arch", ARCHS)
def test_params_match_the_jax_layout(arch):
    """The port's own init: the JAX tree's keys, shapes and dtypes, the
    tail unstacked."""
    jcfg, jp, tcfg, _ = _smoke(arch)
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), device=CPU)
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(_paths(tp))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == want[k].dtype.name, k


def _paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{pre}['{k}']")
        else:
            yield f"{pre}['{k}']", v


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jcfg, jp, tcfg, tp = _smoke(arch)
    dc = dict(seq_len=40, global_batch=2, seed=3)
    jb = JP.make_batch(jcfg, JP.DataConfig(**dc), 0)
    tb = P.make_batch(tcfg, P.DataConfig(**dc), 0)
    jh, _ = JT.forward(jp, jcfg, jb["tokens"])
    th, _ = T.forward(tp, tcfg, tb["tokens"])
    _close(th, jh, MODEL)
    jl, _ = JT.loss_fn(jp, jcfg, jb, n_chunks=2)
    tl, _ = T.loss_fn(tp, tcfg, tb, n_chunks=2)
    _close(tl, jl, MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """A 40-token prompt (past recurrentgemma's 32-token ring) and 8
    decode steps at batch 2: every step's logits and the final states."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    toks = _tokens(48, jcfg.vocab, 30, b=2)
    jc, tc = JT.init_cache(jcfg, 2, 64), T.init_cache(tcfg, 2, 64,
                                                       device=CPU)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks[:, :40]), jc)
    tl, tc = T.prefill(tp, tcfg, _t(toks[:, :40]), tc)
    _close(tl, jl, MODEL, "prefill")
    step = jax.jit(lambda t, c: JT.decode_step(jp, jcfg, t, c))
    for i in range(40, 48):
        jl, jc = step(jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = T.decode_step(tp, tcfg, _t(toks[:, i:i + 1]), tc)
        _close(tl, jl, MODEL, f"position {i}")
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(jc)[0]}
    for k, v in _paths(tc):
        _close(v, want[k], MODEL, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_equals_forward(arch):
    """The port's serving path against its own forward, as
    tests/test_archs.py holds the JAX package: prefill 20 tokens and
    decode 19 more; each step's logits equal the forward's at that
    position."""
    _, _, tcfg, tp = _smoke(arch)
    toks = _t(_tokens(40, tcfg.vocab, 31))
    h, _ = T.forward(tp, tcfg, toks, remat=False)
    full = h @ tp["lm_head"]
    cache = T.init_cache(tcfg, 1, 64, device=CPU)
    lg, cache = T.prefill(tp, tcfg, toks[:, :20], cache)
    _close(lg[0], full[0, 19].numpy(), MODEL)
    for i in range(20, 39):
        lg, cache = T.decode_step(tp, tcfg, toks[:, i:i + 1], cache)
        _close(lg[0], full[0, i].numpy(), MODEL, f"position {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_agree_and_continuous_equals_solo(arch):
    """Three requests of different lengths on a 2-slot dense engine (one
    admitted into a slot another has left, so its recurrent state is
    copied over a used row): the port's greedy tokens equal the JAX
    engine's and each request's solo batch-1 run, bit for bit."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    rng = np.random.default_rng(32)
    lens, mts = (8, 37, 5), (12, 20, 9)
    prompts = [rng.integers(0, tcfg.vocab, (p,)).astype(np.int32)
               for p in lens]
    max_len = 64
    tres = DecodeEngine(tp, tcfg, batch=2, max_len=max_len, device=CPU).run(
        [Request(prompt=p, max_tokens=m) for p, m in zip(prompts, mts)])
    jres = JEngine(jp, jcfg, batch=2, max_len=max_len).run(
        [JRequest(prompt=p, max_tokens=m) for p, m in zip(prompts, mts)])
    got = {r.rid: r.tokens for r in tres}
    want = {r.rid: np.asarray(r.tokens) for r in jres}
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"rid {rid}")
        np.testing.assert_array_equal(
            got[rid], solo_greedy(tp, tcfg, prompts[rid], mts[rid],
                                  max_len), err_msg=f"solo {rid}")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses_recurrent_kinds(arch):
    """Both packages refuse the page pool for ``ssm`` / ``rec`` layers
    with the same message; the port's paged cache does too."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    kw = dict(batch=2, max_len=32, page_size=8)
    with pytest.raises(ValueError) as jerr:
        JEngine(jp, jcfg, **kw)
    with pytest.raises(ValueError) as terr:
        DecodeEngine(tp, tcfg, device=CPU, **kw)
    assert str(terr.value) == str(jerr.value)
    assert "recurrent layer kinds" in str(terr.value)
    with pytest.raises(ValueError, match="recurrent layer kinds"):
        T.init_paged_cache(tcfg, 2, 9, 8, 4, device=CPU)


def test_insert_cache_slot_copies_tail_and_state_leaves():
    """A batch-1 cache of random leaves into row 1 of a 3-slot cache:
    the stacked leaves (batch at dim 1), the tail's (batch at dim 0) and
    pos, against the JAX ``insert_cache_slot``; rows 0 and 2 keep their
    values."""
    jcfg, _, tcfg, _ = _smoke("recurrentgemma-9b")
    live_j = JT.init_cache(jcfg, 3, 40)
    sub_j = JT.init_cache(jcfg, 1, 40)
    rng = np.random.default_rng(33)

    def noise(tree):
        return jax.tree.map(lambda a: np.asarray(
            rng.standard_normal(a.shape) * 10).astype(a.dtype), tree)
    live_np, sub_np = noise(live_j), noise(sub_j)
    want = JT.insert_cache_slot(jax.tree.map(jnp.asarray, live_np),
                                jax.tree.map(jnp.asarray, sub_np), 1)
    got = T.insert_cache_slot(from_jax(live_np), from_jax(sub_np), 1)
    assert "tail" in got and set(got["tail"]["t0"]) == {"conv", "h"}
    want_flat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    for k, v in _paths(got):
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_flat[k]),
                                      err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_checkpoint_round_trip_with_a_tail(tmp_path, arch):
    """The JAX parameters (recurrentgemma's with a ``tail``) cross to the
    port and back bit for bit; a checkpoint the port writes restores in
    the JAX Checkpointer, and one JAX writes restores in the port."""
    _, jp, tcfg, tp = _smoke(arch)
    jnp_tree = jax.tree.map(np.asarray, jp)
    back = to_numpy(tp)
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(jnp_tree)[0]}
    for k, v in _paths(back):
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert ("tail" in tp) == (arch == "recurrentgemma-9b")
    Checkpointer(str(tmp_path / "port")).save(1, tp)
    got = JCheckpointer(str(tmp_path / "port")).restore(jp)
    for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(k))
    JCheckpointer(str(tmp_path / "jax")).save(2, jp)
    zeros = T.init_params(tcfg, torch.Generator().manual_seed(1), device=CPU)
    restored = Checkpointer(str(tmp_path / "jax")).restore(zeros)
    for k, v in _paths(restored):
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_modeled_bytes_match_the_jax_engine(arch):
    """The engines' cost model on the smoke models: the KV stream of the
    local layers' rings (none for mamba2) at positions before and past
    the window, and the weight stream with every rec / mixer projection
    and the tail; then the full-width weight stream from shapes alone."""
    jcfg, jp, tcfg, tp = _smoke(arch)
    te = DecodeEngine(tp, tcfg, batch=4, max_len=64, device=CPU)
    je = JEngine(jp, jcfg, batch=4, max_len=64)
    for positions in ([0, 5, 31, 60], [33, 40, 50, 63]):
        assert te.modeled_kv_bytes_per_step(positions) == \
            je.modeled_kv_bytes_per_step(positions)
        assert te.modeled_bytes_per_token(positions) == \
            je.modeled_bytes_per_token(positions)
    assert (te.modeled_kv_bytes_per_step([40]) > 0) == \
        (arch == "recurrentgemma-9b")
    full, jfull = get_config(arch), j_get(arch)
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   jfull))
    meta = jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=getattr(torch, s.dtype.name), device="meta"), shapes)
    assert quant.gemm_weight_bytes(meta) == j_weight_bytes(shapes)
    assert full.param_count() == jfull.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_the_recurrent_model(capsys, arch):
    """``--arch ... --smoke --device cpu`` on the dense engine; the paged
    flags raise the engines' refusal."""
    argv = ["--arch", arch, "--smoke", "--trace", "4", "--slots", "2",
            "--steps", "12", "--rate", "1000", "--device", "cpu"]
    serve_cli.main(argv)
    out = capsys.readouterr().out
    assert "[serve] trace: 4/4 requests" in out
    assert ("local window 32" in out) == (arch == "recurrentgemma-9b")
    with pytest.raises(ValueError, match="recurrent layer kinds"):
        serve_cli.main(argv + ["--page-size", "8"])


def test_local_layers_keep_their_own_window():
    """In a stack of ``attn`` and ``local`` layers each kind's cache and
    kernels take its own window (``_attn_spec`` / ``cache_len`` by
    kind, as the JAX package's)."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"),
                              window=0, local_window=16)
    assert T.cache_len(cfg, 64, "local") == 16
    assert T.cache_len(cfg, 64, "attn") == 64
    assert T._attn_spec(cfg, "local").window == 16
    jcfg = dataclasses.replace(j_smoke("recurrentgemma-9b"), local_window=16)
    jc = JT.init_cache(jcfg, 1, 64)
    tc = T.init_cache(cfg, 1, 64, device=CPU)
    assert tuple(tc["layers"]["u2"]["k"].shape) == \
        jc["layers"]["u2"]["k"].shape
