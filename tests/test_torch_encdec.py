"""The encoder-decoder family's modules in the port against the JAX
package, on the CPU (whisper-medium's smoke model, f32): LayerNorm, the
GELU MLP, the sinusoidal positions, cross-attention, the cross cache's
slot copy, both engines' greedy tokens with per-request frames, the
paged refusal; and the bounded-peak weight draw kimi-k2 needs at full
width.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs with ``REPRO_KERNELS=ref``.  Tolerances: ``atol = rtol =
1e-5`` for modules (the same f32 ops in another order), ``1e-4`` for
whole models and for the sinusoid (an angle of up to 448 radians
carries the position times an ulp of its frequency: exp's last bit
differs between the two libraries); greedy tokens and the port's own
invariants (continuous == solo, batch 1 == batch 8 rows) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import DecodeEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import ops
from repro_torch.bridge import from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import DecodeEngine, Request, solo_greedy

CPU = torch.device("cpu")
ARCH = "whisper-medium"
MODULE = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)
SINUSOID = MODEL


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


@pytest.fixture(scope="module")
def smoke():
    jcfg = j_smoke(ARCH)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, get_smoke_config(ARCH), \
        from_jax(jax.tree.map(np.asarray, jp))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=msg, **tol)


# ------------------------------------------------------------------ layers

def test_layer_norm_matches_jax_and_is_batch_invariant():
    """Random scale and bias, rows off zero mean; eps 1e-5 whatever the
    config's norm_eps; a row's bits at batch 1 equal its bits in a
    batch of 8."""
    p = {"scale": _rand((48,), 1), "bias": _rand((48,), 2)}
    x = _rand((8, 3, 48), 3, 4.0) + 1.5
    want = JL.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = L.layer_norm({k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, want, MODULE)
    for i in (0, 5):
        one = L.layer_norm({k: _t(v) for k, v in p.items()}, _t(x[i:i + 1]))
        assert torch.equal(one[0], got[i])


def test_layer_norm_init_matches_jax():
    got = L.init_layer_norm(24, CPU, (3,))
    want = JL.init_layer_norm(24)
    for k in ("scale", "bias"):
        assert got[k].dtype == torch.float32 and got[k].shape == (3, 24)
        np.testing.assert_array_equal(got[k][1].numpy(),
                                      np.asarray(want[k]))


def test_gelu_mlp_matches_jax():
    """gelu (the tanh form) on w_in's flush, the residual on w_out's."""
    jp = JL.init_gelu_mlp(jax.random.PRNGKey(4), 32, 80, jnp.float32)
    tp = from_jax(jax.tree.map(np.asarray, jp))
    x, r = _rand((2, 5, 32), 5), _rand((2, 5, 32), 6)
    _close(L.gelu_mlp(tp, _t(x), residual=_t(r)),
           JL.gelu_mlp(jp, jnp.asarray(x), residual=jnp.asarray(r)), MODULE)
    _close(L.gelu_mlp(tp, _t(x)), JL.gelu_mlp(jp, jnp.asarray(x)), MODULE)


@pytest.mark.parametrize("d", [2, 16, 64, 1024])
def test_sinusoid_matches_jax(d):
    """Frequencies by max(half - 1, 1) (d = 2: one frequency), [sin |
    cos] concatenated, out to whisper's 448-token decoder context."""
    pos = np.arange(0, 448, 7)
    _close(T._sinusoid(_t(pos), d), JT._sinusoid(jnp.asarray(pos), d),
           SINUSOID)


def test_abs_pos_scalar_and_per_slot_start(smoke):
    """A scalar start (prefill) and a (b,) per-slot start (decode, each
    slot at its own position, on the device) against the JAX package;
    the x dtype is kept; a rope model is left as it is."""
    jcfg, _, tcfg, _ = smoke
    x = _rand((3, 4, tcfg.d_model), 7)
    _close(T._maybe_abs_pos(tcfg, _t(x), 5),
           JT._maybe_abs_pos(jcfg, jnp.asarray(x), 5), SINUSOID)
    start = np.asarray([0, 17, 300], np.int32)
    _close(T._maybe_abs_pos(tcfg, _t(x), _t(start)),
           JT._maybe_abs_pos(jcfg, jnp.asarray(x), jnp.asarray(start)),
           SINUSOID)
    xb = _t(x).to(torch.bfloat16)
    assert T._maybe_abs_pos(tcfg, xb, 3).dtype == torch.bfloat16
    rope_cfg = get_smoke_config("smollm-360m")
    assert T._maybe_abs_pos(rope_cfg, xb, 3) is xb


@pytest.mark.parametrize("use_rope", [False, True])
@pytest.mark.parametrize("how", ["memory", "kv"])
def test_cross_attention_block_matches_jax(how, use_rope):
    """Cross-attention over 11 encoder positions from 5 (and, for kv=,
    from 1: a decode step's shape) query positions, GQA 4/2: k / v
    projected from ``memory`` or given as ``kv``; non-causal with no
    window (the spec's window is ignored), rope on q only."""
    spec = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, window=3,
                use_rope=use_rope)
    jspec, tspec = JL.AttnLayerSpec(**spec), L.AttnLayerSpec(**spec)
    jp = JL.init_attention(jax.random.PRNGKey(8), jspec, jnp.float32)
    tp = from_jax(jax.tree.map(np.asarray, jp))
    mem = _rand((2, 11, 32), 9)
    for sq in (5, 1):
        x, r = _rand((2, sq, 32), 10 + sq), _rand((2, sq, 32), 20 + sq)
        if how == "memory":
            want = JL.attention_block(jp, jnp.asarray(x), jspec,
                                      memory=jnp.asarray(mem),
                                      residual=jnp.asarray(r))
            got = L.attention_block(tp, _t(x), tspec, memory=_t(mem),
                                    residual=_t(r))
        else:
            jk, jv = JL.project_kv(jp, jnp.asarray(mem), jspec)
            tk, tv = L.project_kv(tp, _t(mem), tspec)
            _close(tk, jk, MODULE)
            _close(tv, jv, MODULE)
            want = JL.attention_block(jp, jnp.asarray(x), jspec, kv=(jk, jv),
                                      residual=jnp.asarray(r))
            got = L.attention_block(tp, _t(x), tspec, kv=(tk, tv),
                                    residual=_t(r))
        _close(got, want, MODULE, f"sq {sq}")


def test_cross_attention_plans_b3_as_a_prefill():
    """Cross-attention is a prefill-mode, non-causal attention with its
    own skv (the reference's spec): at whisper's decode shape (8 slots x
    1 query over 1500 keys) it plans B3, and the plan records the shape
    and the mask."""
    q = torch.zeros((8, 1, 16, 64))
    kv = torch.zeros((8, 1500, 16, 64))
    ops.attn_plan_cache_clear()
    ops.attention(q, kv, kv, causal=False)
    pl = ops.attn_plans()[-1]
    assert pl.kernel == "flash_attention"
    assert (pl.spec.mode, pl.spec.causal, pl.b, pl.sq, pl.skv) == \
        ("prefill", False, 8, 1, 1500)
    with pytest.raises(ValueError, match="window > 0 requires causal"):
        ops.AttnSpec(causal=False, window=8)


# ------------------------------------------------------------- the caches

def test_insert_cache_slot_copies_the_cross_subtree(smoke):
    """A batch-1 cache of random leaves into row 1 of a 3-slot cache,
    against the JAX ``insert_cache_slot``: the cross k / v carry the
    batch at dim 1 like ``layers``; rows 0 and 2 keep their values."""
    jcfg, _, tcfg, _ = smoke
    rng = np.random.default_rng(11)

    def noise(tree):
        return jax.tree.map(lambda a: np.asarray(
            rng.standard_normal(a.shape) * 10).astype(a.dtype), tree)
    live, sub = noise(JT.init_cache(jcfg, 3, 24)), \
        noise(JT.init_cache(jcfg, 1, 24))
    want = JT.insert_cache_slot(jax.tree.map(jnp.asarray, live),
                                jax.tree.map(jnp.asarray, sub), 1)
    got = T.insert_cache_slot(from_jax(live), from_jax(sub), 1)
    assert got["cross"]["u0"]["k"].shape == \
        (tcfg.repeats, 3, tcfg.encoder_seq, tcfg.n_kv_heads, tcfg.hd)
    for part in ("cross", "layers"):
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                got[part]["u0"][name].numpy(),
                np.asarray(want[part]["u0"][name]), err_msg=part + name)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))


def test_prefill_writes_the_cross_cache(smoke):
    """Prefill with frames writes every layer's projected cross k / v
    into the cache; without frames a fresh cache's stay zero and the
    logits equal the JAX package's, which cross-attends those zeros."""
    jcfg, jp, tcfg, tp = smoke
    frames = _rand((1, tcfg.encoder_seq, tcfg.d_model), 12)
    toks = np.random.default_rng(13).integers(0, tcfg.vocab, (1, 6))
    tc = T.init_cache(tcfg, 1, 16, device=CPU)
    _, tc = T.prefill(tp, tcfg, _t(toks), tc, frames=_t(frames))
    enc = T._encode(tp, tcfg, _t(frames))
    for r in range(tcfg.repeats):
        k, v = T._project_cross_kv(T._layer(tp["layers"]["u0"], r), tcfg,
                                   enc)
        assert torch.equal(tc["cross"]["u0"]["k"][r], k)
        assert torch.equal(tc["cross"]["u0"]["v"][r], v)
    tl, tc = T.prefill(tp, tcfg, _t(toks),
                       T.init_cache(tcfg, 1, 16, device=CPU))
    jl, _ = JT.prefill(jp, jcfg, jnp.asarray(toks), JT.init_cache(jcfg, 1, 16))
    assert not tc["cross"]["u0"]["k"].any()
    _close(tl, jl, MODEL)


# -------------------------------------------------------------- engines

LENS, MTS = (6, 13, 4), (9, 5, 12)


def _requests(tcfg, with_frames=True):
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, tcfg.vocab, (p,)).astype(np.int32)
               for p in LENS]
    frames = [_rand((tcfg.encoder_seq, tcfg.d_model), 15 + i)
              if with_frames else None for i in range(len(LENS))]
    return prompts, frames


def test_engine_with_frames_matches_jax_and_solo(smoke):
    """Three requests with their own frames on a 2-slot dense engine
    (the third admitted into a slot another has left, so its cross k / v
    are copied over a used row): the port's greedy tokens equal the JAX
    engine's and each request's solo batch-1 run, bit for bit."""
    jcfg, jp, tcfg, tp = smoke
    prompts, frames = _requests(tcfg)
    kw = dict(batch=2, max_len=24)
    tres = DecodeEngine(tp, tcfg, device=CPU, **kw).run(
        [Request(prompt=p, max_tokens=m, frames=f)
         for p, m, f in zip(prompts, MTS, frames)])
    jres = JEngine(jp, jcfg, **kw).run(
        [JRequest(prompt=p, max_tokens=m, frames=f)
         for p, m, f in zip(prompts, MTS, frames)])
    got = {r.rid: r.tokens for r in tres}
    want = {r.rid: np.asarray(r.tokens) for r in jres}
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"rid {rid}")
        np.testing.assert_array_equal(
            got[rid], solo_greedy(tp, tcfg, prompts[rid], MTS[rid], 24,
                                  frames=frames[rid]), err_msg=f"solo {rid}")
    # the frames matter: without them the tokens differ
    bare = DecodeEngine(tp, tcfg, device=CPU, **kw).run(
        [Request(prompt=p, max_tokens=m) for p, m in zip(prompts, MTS)])
    assert any(not np.array_equal(r.tokens, got[r.rid]) for r in bare)


def test_generate_takes_frames_as_the_jax_engine_does(smoke):
    """``generate(prompts, n, frames=)`` gives row i the frames
    ``frames[i]`` (a numpy array or a host tensor): the tokens equal the
    JAX engine's ``generate``."""
    jcfg, jp, tcfg, tp = smoke
    rng = np.random.default_rng(16)
    prompts = rng.integers(0, tcfg.vocab, (3, 7)).astype(np.int32)
    frames = _rand((3, tcfg.encoder_seq, tcfg.d_model), 17)
    want = JEngine(jp, jcfg, batch=3, max_len=20).generate(
        jnp.asarray(prompts), 8, frames=jnp.asarray(frames)).tokens
    eng = DecodeEngine(tp, tcfg, batch=3, max_len=20, device=CPU)
    np.testing.assert_array_equal(eng.generate(prompts, 8,
                                               frames=frames).tokens,
                                  np.asarray(want))
    np.testing.assert_array_equal(eng.generate(prompts, 8,
                                               frames=_t(frames)).tokens,
                                  np.asarray(want))


def test_paged_engine_refuses_the_encoder_decoder(smoke):
    """Both packages refuse whisper on the page pool with the same error
    type and message, and a paged engine refuses a request with frames
    at submit; the dense engine refuses frames of the wrong shape or for
    a model with no encoder."""
    jcfg, jp, tcfg, tp = smoke
    kw = dict(batch=2, max_len=32, page_size=8)
    with pytest.raises(ValueError) as jerr:
        JEngine(jp, jcfg, **kw)
    with pytest.raises(ValueError) as terr:
        DecodeEngine(tp, tcfg, device=CPU, **kw)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="encoder-decoder"):
        T.init_paged_cache(tcfg, 2, 9, 8, 4, device=CPU)
    scfg = get_smoke_config("smollm-360m")
    sp = T.init_params(scfg, torch.Generator().manual_seed(0), device=CPU)
    prompt = np.zeros((4,), np.int32)
    with pytest.raises(ValueError, match="audio/enc-dec requests"):
        DecodeEngine(sp, scfg, device=CPU, **kw).submit(
            Request(prompt=prompt, max_tokens=2,
                    frames=np.zeros((16, 60), np.float32)))
    with pytest.raises(ValueError, match="takes frames of shape None"):
        DecodeEngine(sp, scfg, batch=1, max_len=8, device=CPU).submit(
            Request(prompt=prompt, max_tokens=2,
                    frames=np.zeros((16, 60), np.float32)))
    with pytest.raises(ValueError, match=r"takes frames of shape \(16, 64\)"):
        DecodeEngine(tp, tcfg, batch=1, max_len=8, device=CPU).submit(
            Request(prompt=prompt, max_tokens=2,
                    frames=np.zeros((15, 64), np.float32)))


def test_serve_cli_draws_frames_for_a_batch(capsys):
    """``--batch`` on whisper draws each row's stub frames from the
    seed (the JAX launcher's draw); a trace serves without frames."""
    serve_cli.main(["--arch", ARCH, "--smoke", "--batch", "2",
                    "--prompt-len", "5", "--steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] encoder-decoder: 2 encoder layers over 16 frames" in out
    assert "[serve] generated 4 steps x 2 seqs" in out
    serve_cli.main(["--arch", ARCH, "--smoke", "--trace", "3", "--rate",
                    "1000", "--steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(trace requests carry no frames: zeros)" in out
    assert "[serve] trace: 3/3 requests" in out


# ---------------------------------------------------- the weights' draw

def test_dense_init_draws_large_leaves_in_slices(monkeypatch):
    """A leaf at most ``DRAW_CHUNK`` elements is one draw, the bits of
    ``(randn * std).to(dtype)``; a larger one is drawn in slices (which
    bounds the f32 temporary on the card) with the same distribution:
    mean 0 and std 1/sqrt(d_in) within sampling error, every element
    drawn (no zero left, no slice repeated)."""
    shape = (3, 64, 50)
    g = torch.Generator().manual_seed(5)
    old = (torch.randn(shape, generator=g) / 8.0).to(torch.bfloat16)
    new = L.dense_init(torch.Generator().manual_seed(5), shape,
                       torch.bfloat16)
    assert torch.equal(old, new)
    monkeypatch.setattr(L, "DRAW_CHUNK", 1000)
    w = L.dense_init(torch.Generator().manual_seed(5), shape,
                     torch.float32)
    assert w.shape == shape and w.dtype == torch.float32
    n = w.numel()
    assert abs(w.mean().item()) < 4 / 8.0 / n ** 0.5
    assert abs(w.std().item() * 8.0 - 1.0) < 4 / (2 * n) ** 0.5
    assert (w != 0).all()
    chunks = w.reshape(-1)[:9000].reshape(9, 1000)
    assert len({tuple(c[:4].tolist()) for c in chunks}) == 9
    e = L.init_embedding(torch.Generator().manual_seed(6), 300, 20,
                         torch.float32)
    assert abs(e.std().item() / 0.02 - 1.0) < 0.05
