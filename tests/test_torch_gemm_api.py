"""The port's GEMM operator API (``repro_torch.kernels.api``) against the
JAX package's (``repro.kernels.api``): the same specs are accepted and
rejected with the same key strings, the port's resolver on its copy of
the ``TPU_V5E`` sheet makes the reference's exact choices (``tune=False``
on both sides), and the plan cache, ``explain()``, ``execute``'s checks
and the refusals of what the port does not run yet behave as specified.

Run as a script, it prints the one-shot ``ops.gemm``'s host cost per call
over a direct ``gemm_aie`` call (median of 1000):

    PYTHONPATH=src python tests/test_torch_gemm_api.py
"""

import dataclasses
import statistics
import time

import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro_torch import ops
from repro_torch.core.hardware import HOPPER_H100, TPU_V5E
from repro_torch.configs import get_smoke_config
from repro_torch.core.tiling import TileConfig
from repro_torch.kernels import api
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.gemm_aie import gemm_aie
from repro_torch.models import transformer as T

D, FF, V = 960, 2560, 49152


@pytest.fixture(autouse=True)
def _fresh_caches():
    api.plan_cache_clear()
    yield
    api.plan_cache_clear()


def _specs(epilogue="", **kw):
    """The same spec in both packages (no tuning on either side)."""
    j = japi.GemmSpec(epilogue=JEpilogue.parse(epilogue), tune=False, **kw)
    t = api.GemmSpec(epilogue=Epilogue.parse(epilogue), **kw)
    return j, t


@pytest.mark.parametrize("kw", [
    {"strategy": "ws"},
    {"gated": True, "strategy": "tb", "epilogue": "silu"},
    {"gated": True},
    {"gated": True, "epilogue": "bias+silu"},
    {"gated": True, "epilogue": "silu+res"},
    {"tile": (8, 128, 128)},
    {"epilogue": "swish"},
])
def test_spec_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        japi.GemmSpec(**kw)
    with pytest.raises(ValueError):
        api.GemmSpec(**kw)


@pytest.mark.parametrize("kw", [
    {}, {"a_dtype": "float32", "b_dtype": "float32"},
    {"epilogue": "bias+gelu+res", "out_dtype": "float32"},
    {"gated": True, "epilogue": "silu"},
    {"strategy": "tb"}, {"tile": "tile"},
])
def test_spec_keys_equal_the_reference(kw):
    if kw.get("tile") == "tile":
        j = japi.GemmSpec(tile=__import__("repro.core.tiling", fromlist=[
            "TileConfig"]).TileConfig(8, 512, 128, "tb"))
        t = api.GemmSpec(tile=TileConfig(8, 512, 128, "tb"))
        assert j.key == t.key == "bfloat16xbfloat16!8x512x128"
        return
    ep = kw.pop("epilogue", "")
    j, t = _specs(ep, **kw)
    assert j.key == t.key


SHAPES = [(1, D, D), (8, D, 320), (8, D, D), (8, FF, D), (8, D, V),
          (300, D, 320), (300, D, D), (1024, D, 320), (1024, 1024, 1024),
          (3, 60, 200), (17, 100, 70)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", ["plain", "res", "f32", "bias+gelu",
                                  "gated", "tb", "aie"])
def test_resolver_on_tpu_sheet_makes_the_reference_choices(shape, case):
    kw, ep = {}, ""
    if case == "res":
        ep = "res"
    elif case == "f32":
        kw = {"a_dtype": "float32", "b_dtype": "float32",
              "out_dtype": "float32"}
    elif case == "bias+gelu":
        ep = "bias+gelu"
    elif case == "gated":
        kw, ep = {"gated": True}, "silu"
    elif case in ("tb", "aie"):
        kw = {"strategy": case}
    j, t = _specs(ep, **kw)
    try:
        want = japi.plan(j, shape)
    except ValueError:      # no design of the pinned strategy in the top 10
        with pytest.raises(ValueError, match="no feasible"):
            api._resolve(t, *shape, TPU_V5E)
        return
    got = api._resolve(t, *shape, TPU_V5E)
    assert (got.tile.strategy, got.tile.bm, got.tile.bk, got.tile.bn) == \
        (want.tile.strategy, want.tile.bm, want.tile.bk, want.tile.bn)
    assert got.fallback_reason == want.fallback_reason
    assert got.hbm_bytes == pytest.approx(want.hbm_bytes, rel=1e-12)
    assert got.vmem_bytes == want.vmem_bytes


def test_tpu_resolver_picks_tb_for_wk_wv_like_the_reference():
    for m in (1, 8, 300, 1024):
        j, t = _specs()
        assert japi.plan(j, (m, D, 320)).tile.strategy == "tb"
        assert api._resolve(t, m, D, 320, TPU_V5E).tile.strategy == "tb"


@pytest.mark.parametrize("tile", [(8, 512, 128, "tb"), (16, 256, 256, "aie"),
                                  (4096, 2048, 2048, "aie")])
def test_explicit_tiles_on_tpu_sheet_match_the_reference(tile):
    from repro.core.tiling import TileConfig as JTile
    j = japi.GemmSpec(tile=JTile(*tile), tune=False)
    t = api.GemmSpec(tile=TileConfig(*tile))
    for shape in [(8, D, 320), (300, FF, D)]:
        try:
            want = japi.plan(j, shape)
        except ValueError:
            with pytest.raises(ValueError, match="infeasible"):
                api._resolve(t, *shape, TPU_V5E)
            continue
        got = api._resolve(t, *shape, TPU_V5E)
        assert (got.tile.bm, got.tile.bk, got.tile.bn) == \
            (want.tile.bm, want.tile.bk, want.tile.bn)


def test_tb_winner_that_fails_the_recheck_falls_back_like_the_reference(
        monkeypatch):
    monkeypatch.setattr(japi, "feasible_bk", lambda *a, **k: 0)
    monkeypatch.setattr(api, "feasible_bk", lambda *a, **k: 0)
    japi.plan_cache_clear()
    try:
        j, t = _specs()
        want = japi.plan(j, (8, D, 320))
        got = api._resolve(t, 8, D, 320, TPU_V5E)
    finally:
        japi.plan_cache_clear()
    assert want.tile.strategy == got.tile.strategy == "aie"
    assert (got.tile.bm, got.tile.bk, got.tile.bn) == \
        (want.tile.bm, want.tile.bk, want.tile.bn)
    assert "fell back to the DSE's aie winner" in want.fallback_reason
    assert "fell back to the DSE's aie winner" in got.fallback_reason


@pytest.mark.parametrize("strategy", [None, "aie", "tb"])
def test_solve_topk_ranks_like_the_reference(strategy):
    j, t = _specs(strategy=strategy)
    want = japi.solve_topk(j, (8, D, 320), k=6)
    got = ops.solve_topk(t, (8, D, 320), k=6, chip=TPU_V5E)
    assert [(d.tile.strategy, d.tile.bm, d.tile.bk, d.tile.bn)
            for d in got] == [(d.tile.strategy, d.tile.bm, d.tile.bk,
                               d.tile.bn) for d in want]
    assert all(d.tile.strategy == strategy for d in got if strategy)


def test_plan_cache_counts_one_miss_per_spec_and_shape():
    spec = api.GemmSpec()
    p1 = ops.plan(spec, (8, D, 320))
    p2 = ops.plan(api.GemmSpec(), (8, D, 320))
    ops.plan(spec, (8, D, D))
    assert p1 is p2
    assert ops.plan_cache_info() == (2, 1, 2)
    a = torch.zeros((2, 4, 60))
    w = torch.zeros((60, 200))
    for _ in range(3):
        ops.gemm(a, w)
    assert ops.plan_cache_info() == (3, 3, 3)
    assert len(ops.plans()) == 3
    ops.plan_cache_clear()
    assert ops.plan_cache_info() == (0, 0, 0)


def test_plans_target_the_hopper_sheet():
    pl = ops.plan(ops.GemmSpec(), (8, D, 320))
    assert pl.chip is HOPPER_H100
    assert pl.vmem_bytes <= HOPPER_H100.vmem_bytes


@pytest.mark.parametrize("spec,shape,kernel,source", [
    # bf16 B1 and B6 run the warp-specialised body
    ({}, (8, D, 320), "B1 gemm_aie", "csrc/gemm_ws.cuh"),
    ({"strategy": "tb"}, (8, D, 320), "B6 gemm_tb", "csrc/gemm_ws.cuh"),
    ({"a_dtype": "float32", "b_dtype": "float32", "strategy": "aie"},
     (8, D, 320), "B1 gemm_aie", "csrc/gemm_aie.cu"),
    ({"a_dtype": "float32", "b_dtype": "float32", "strategy": "tb"},
     (8, D, 320), "B6 gemm_tb", "csrc/gemm_tb.cu"),
    ({"gated": True, "epilogue": "silu"}, (8, D, FF), "B2 gemm_gated",
     "csrc/gemm_gated.cu"),
])
def test_explain_names_kernel_source_and_modeled(spec, shape, kernel,
                                                 source):
    text = ops.plan(ops.GemmSpec(**spec), shape).explain()
    assert kernel in text and source in text
    assert "modeled on h100_sxm" in text and "not a measurement" in text
    if kernel.startswith("B6"):
        assert "B6a accumulate" in text and "B6b final" in text
    else:
        assert "CTA tile" in text


def test_tb_plan_counts_its_launches():
    pl = ops.plan(ops.GemmSpec(strategy="tb"), (8, FF, D))
    chunks = -(-FF // pl.chunk_bk)
    assert pl.launches == {"gemm_tb": chunks - 1, "gemm_tb_final": 1}
    assert ops.plan(ops.GemmSpec(), (8, D, D)).launches == {"gemm_aie": 1}


def test_execute_rejects_operands_that_mismatch_the_plan():
    a = torch.zeros((4, 60))
    w = torch.zeros((60, 200))
    pl = ops.plan(ops.GemmSpec(a_dtype="float32", b_dtype="float32"),
                  (4, 60, 200))
    with pytest.raises(ValueError, match="forbids `bias=`"):
        ops.execute(pl, a, w, bias=torch.zeros(200))
    with pytest.raises(ValueError, match="forbids `residual=`"):
        ops.execute(pl, a, w, residual=torch.zeros((4, 200)))
    with pytest.raises(ValueError, match="b2"):
        ops.execute(pl, a, w, b2=w)
    with pytest.raises(ValueError, match="group_sizes"):
        ops.execute(pl, a, w, group_sizes=torch.ones(2))
    with pytest.raises(ValueError, match="do not match"):
        ops.execute(pl, torch.zeros((5, 60)), w)
    with pytest.raises(ValueError, match="dtypes"):
        ops.execute(pl, a.bfloat16(), w.bfloat16())
    with pytest.raises(ValueError, match="quant struct"):
        ops.execute(pl, a, {"q": w, "scale": torch.ones(200)})
    res = ops.plan(ops.GemmSpec(a_dtype="float32", b_dtype="float32",
                                epilogue="res"), (4, 60, 200))
    with pytest.raises(ValueError, match="requires `residual=`"):
        ops.execute(res, a, w)
    with pytest.raises(ValueError, match="residual"):
        ops.execute(res, a, w, residual=torch.zeros((3, 200)))
    gated = ops.plan(ops.GemmSpec(a_dtype="float32", b_dtype="float32",
                                  gated=True, epilogue="silu"), (4, 60, 200))
    with pytest.raises(ValueError, match="expects a second"):
        ops.execute(gated, a, w)
    with pytest.raises(ValueError, match="b2"):
        ops.execute(gated, a, w, b2=torch.zeros((60, 100)))


#: what each case raises: a feature outside the port names the ROADMAP
#: queue item that brings it; an attention block the kernel does not
#: compile (A6 made blocks launch-time choices) is a ValueError
_RAISES = {"A6": (ValueError, "does not compile"),
           "A9": (NotImplementedError, "ROADMAP queue A9")}


@pytest.mark.parametrize("make,item", [
    # windows are served (A12); an attention block the kernel does not
    # compile is refused (B3 stages 64 or 128 keys)
    (lambda: ops.attn_plan(ops.AttnSpec(window=64, bkv=256),
                           (1, 64, 64, 2, 2, 16), device="cpu"), "A6"),
    # every layer kind, the encoder-decoder and prefix embeddings are
    # served; a local-window layer or a tail on the page pool is not
    (lambda: T.check_paged(dataclasses.replace(
        get_smoke_config("smollm-360m"), layer_pattern=("local",),
        local_window=4)), "A9"),
    (lambda: T.check_paged(dataclasses.replace(
        get_smoke_config("qwen3-moe-235b-a22b"), n_layers=3,
        tail_pattern=("attn",))),
     "A9"),
])
def test_what_the_port_does_not_run_yet_raises(make, item):
    err, match = _RAISES[item]
    with pytest.raises(err, match=match):
        make()


@pytest.mark.parametrize("make", [
    lambda: ops.plan(api.GemmSpec(b_quant=True, tune=True), (2, 4, 3)),
    lambda: ops.plan(api.GemmSpec(tune=True), (2, 4, 3)),
    lambda: ops.gemm(torch.zeros((2, 4)), torch.zeros((4, 3)), tune=True),
])
def test_tuned_specs_plan_without_a_card(make, monkeypatch, tmp_path):
    """Measured tuning (queue A10) is ported: a tuned spec plans.  The
    search measures on the card; without one nothing is measured and the
    plan stays analytic (it never falls back to timing the CPU)."""
    from repro_torch.tune import autotune, cache
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tc.json"))
    monkeypatch.setattr(autotune, "_device", None)
    cache.tuning_cache_reset()
    ops.plan_cache_clear()
    try:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.warns(UserWarning, match="none is available"):
                make()
            assert all(p.source == "analytic" for p in ops.plans())
            assert cache.tuning_cache_info().measurements == 0
    finally:
        cache.tuning_cache_reset()
        ops.plan_cache_clear()


def test_explicit_unlaunchable_tb_tile_raises_at_plan_time():
    with pytest.raises(ValueError, match="infeasible.*256 threads"):
        ops.plan(ops.GemmSpec(a_dtype="float32", b_dtype="float32",
                              tile=TileConfig(64, 128, 256, "tb")),
                 (64, D, 320))
    with pytest.raises(ValueError, match="infeasible.*128 x 256"):
        ops.plan(ops.GemmSpec(tile=TileConfig(256, 128, 64, "tb")),
                 (256, D, 320))


def test_one_shot_repeat_builds_no_spec(monkeypatch):
    a = torch.zeros((8, 60))
    w = torch.zeros((60, 200))
    r = torch.zeros((8, 200))
    first = ops.gemm(a, w, residual=r)

    def no_spec(*args, **kwargs):
        raise AssertionError("a repeated one-shot call built a GemmSpec")

    monkeypatch.setattr(api.GemmSpec, "for_operands", no_spec)
    monkeypatch.setattr(api.GemmSpec, "__post_init__", no_spec)
    monkeypatch.setattr(api, "_resolve", no_spec)
    again = ops.gemm(a, w, residual=r)
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    monkeypatch.undo()
    overhead = host_overhead_us(reps=200)
    print(f"one-shot ops.gemm extra host cost: {overhead['extra_us']:.2f} "
          "us a call (CPU, median of 200)")


def host_overhead_us(reps: int = 1000) -> dict:
    """Host cost per call of the one-shot ``ops.gemm`` on
    (8, 960) x (960, 320) bf16 CPU tensors, beside a direct ``gemm_aie``
    call, median of ``reps`` each.  ``extra_us`` isolates the planner's
    share: both paths call a stub kernel that returns a ready tensor, so
    the matmul's own time and its noise drop out."""
    a = torch.randn((8, D), dtype=torch.bfloat16)
    w = torch.randn((D, 320), dtype=torch.bfloat16)
    out = torch.empty((8, 320), dtype=torch.bfloat16)

    def timed(fn):
        for _ in range(20):
            fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e6

    real = {"gemm_us": timed(lambda: ops.gemm(a, w)),
            "gemm_aie_us": timed(lambda: gemm_aie(a, w,
                                                  out_dtype=torch.bfloat16))}
    stub = lambda *args, **kwargs: out  # noqa: E731
    saved = api.gemm_aie
    api.gemm_aie = stub
    try:
        ops.gemm(a, w)
        planned = timed(lambda: ops.gemm(a, w))
        direct = timed(lambda: stub(a, w, bias=None, activation=None,
                                    residual=None,
                                    out_dtype=torch.bfloat16))
    finally:
        api.gemm_aie = saved
    return dict(real, planned_stub_us=planned, direct_stub_us=direct,
                extra_us=planned - direct)


def test_one_shot_matches_execute_on_the_cpu():
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((2, 5, 60), np.float32))
    w = torch.as_tensor(rng.standard_normal((60, 200), np.float32))
    r = torch.as_tensor(rng.standard_normal((2, 5, 200), np.float32))
    spec = ops.GemmSpec.for_operands(a, w, residual=r)
    want = ops.execute(ops.plan(spec, ops.gemm_shapes(a, w)), a, w,
                       residual=r)
    got = ops.gemm(a, w, residual=r)
    assert got.shape == (2, 5, 200) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


if __name__ == "__main__":
    api.plan_cache_clear()
    r = host_overhead_us(1000)
    print("ops.gemm vs gemm_aie, (8, 960) x (960, 320) bf16 on the CPU, "
          "median of 1000 calls:")
    for key, val in r.items():
        print(f"  {key:16s} {val:9.2f} us")


@pytest.mark.parametrize("m,n,dtype,tile", [
    (8, 960, "bfloat16", (16, 64, 8)),       # mma.sync form, 120 CTAs
    (8, 2560, "bfloat16", (16, 64, 16)),     # 160 CTAs
    (8, 4096, "bfloat16", (16, 64, 32)),     # 128 CTAs
    (16, 49152, "bfloat16", (16, 64, 64)),   # 64 columns: the swapped form
    (17, 960, "bfloat16", (64, 64, 64)),     # 15 CTAs: the most there are
    (300, 960, "bfloat16", (64, 64, 64)),    # 75 CTAs
    (300, 8192, "bfloat16", (128, 64, 128)),  # 192 CTAs
    (1024, 4096, "bfloat16", (128, 64, 128)),  # 128 x 256 gives 128
    (4096, 960, "bfloat16", (128, 64, 128)),  # training: 256 CTAs
    (4096, 2560, "bfloat16", (128, 64, 256)),  # 320 CTAs
    (300, 2560, "bfloat16", (64, 64, 64)),   # 64 x 128 gives 100 < 132
    (8, 960, "float32", (8, 256, 8)),        # the f32 body: 120 CTAs
])
def test_b1_cta_tile_follows_m_n_and_dtype(m, n, dtype, tile):
    """B1's bf16 body launches, for few rows, the mma.sync form at the
    widest of 32 and 16 columns a CTA that still reaches 7 of every 8
    SMs, else 8, and the swapped wgmma form where 64 would; for more rows,
    the largest of 128 x 256, 128 x 128 and 64 x 128 whose CTAs still give
    every SM one, else 64 x 64; f32 its fmaf body's shape by m and n
    (kernels/gemm_aie.py F32_TILES); explain() names the tile it
    launches."""
    from repro_torch.kernels.gemm_aie import cta_tile
    assert cta_tile(m, n, getattr(torch, dtype)) == tile
    pl = ops.plan(ops.GemmSpec(a_dtype=dtype, b_dtype=dtype,
                               strategy="aie"), (m, D, n))
    assert "launches its compiled {}x{}x{}".format(*tile) in pl.explain()


@pytest.mark.parametrize("m,n,b_dtype,tile", [
    (8, 960, "int8", (16, 256, 8)),       # 120 CTAs of one n8 fragment
    (8, 4096, "int8", (16, 256, 32)),     # 128 CTAs
    (8, 49152, "int8", (16, 256, 64)),
    (300, 960, "int8", (64, 128, 64)),
])
def test_b1_int8_cta_tile_keeps_the_int8_bodies(m, n, b_dtype, tile):
    """An int8 B (W8A16) keeps the int8 bodies' shapes: one 16-row
    fragment and the widest n split that still reaches 7 of every 8 SMs
    for few rows, 64 x 64 for more, slabs twice as deep as bf16 ones."""
    from repro_torch.kernels.gemm_aie import cta_smem_bytes, cta_tile
    assert cta_tile(m, n, torch.bfloat16, getattr(torch, b_dtype)) == tile
    bm, bk, bn = tile
    stages = 8 if bm == 16 and bn < 64 else 4
    assert cta_smem_bytes(m, n, torch.bfloat16, torch.int8) == \
        stages * (2 * bm * bk + bk * bn) + 2 * bk * bn


@pytest.mark.parametrize("m,n,dtype,tile", [
    (8, 2560, "bfloat16", (16, 128, 16)),    # smollm decode: 160 CTAs
    (1, 2560, "bfloat16", (16, 128, 16)),
    (16, 2560, "bfloat16", (16, 128, 16)),   # every row of the fragment
    (8, 960, "bfloat16", (16, 128, 16)),     # n does not choose the tile
    (8, 6144, "bfloat16", (16, 128, 16)),
    (17, 2560, "bfloat16", (64, 64, 64)),
    (300, 2560, "bfloat16", (64, 64, 64)),   # a 300-token prefill
    (8, 2560, "float32", (16, 64, 32)),      # the f32 fmaf body
    (300, 2560, "float32", (16, 64, 32)),
])
def test_b2_cta_tile_follows_m_n_and_dtype(m, n, dtype, tile):
    """B2 launches one 16-row fragment and 16 columns of both products
    for few rows (smollm-360m's n = 2560 then reaches 7 of every 8 SMs),
    64 x 64 for more, the f32 body's fixed tile for f32; a gated plan's
    explain() names the tile it launches."""
    from repro_torch.kernels.gemm_gated import cta_tile
    assert cta_tile(m, n, getattr(torch, dtype)) == tile
    if tile[0] == 16 and dtype == "bfloat16":
        assert 8 * -(-2560 // tile[2]) >= 7 * HOPPER_H100.sm_count
    pl = ops.plan(ops.GemmSpec(a_dtype=dtype, b_dtype=dtype, gated=True,
                               epilogue="silu"), (m, D, n))
    assert pl.kernel == "gated"
    assert "launches its compiled {}x{}x{}".format(*tile) in pl.explain()
