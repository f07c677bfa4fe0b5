"""The port's grouped ragged GEMM (kernel B7's tables, plain version and
plans) against the JAX package's, on the CPU.

* ``group_metadata`` builds the same steering tables as
  ``repro.kernels.gemm_grouped.group_metadata``, exactly.
* ``gemm_grouped_plain`` matches the Pallas ``gemm_grouped`` in interpret
  mode and ``gemm_grouped_blocked_ref`` within f32 ``atol=rtol=1e-5``
  (the same products summed in another order), plain and with bias +
  silu; rows past the groups are zero.
* Grouped plans on the port's ``TPU_V5E`` copy equal
  ``repro.kernels.api.plan``'s: tile, instances, modeled bytes and flops
  to a relative 1e-12; the ``HOPPER_H100`` plans of the qwen3-moe serve
  shapes, and the CTA tile B7 launches for each, are pinned.

The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.core import dse as j_dse
from repro.core import tiling as j_tiling
from repro.kernels import api as japi
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.kernels.gemm_grouped import gemm_grouped_blocked_ref
from repro.kernels.gemm_grouped import group_metadata as j_group_metadata
from repro_torch import ops
from repro_torch.core import dse as t_dse
from repro_torch.core import tiling as t_tiling
from repro_torch.core.hardware import HOPPER_H100, TPU_V5E
from repro_torch.kernels import api
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.gemm_grouped import BF16_TILES, F32_TILES
from repro_torch.kernels.gemm_grouped import cta_tile as grouped_cta_tile
from repro_torch.kernels.gemm_grouped import (gemm_grouped,
                                              gemm_grouped_plain,
                                              group_metadata)

CLOSE = dict(atol=1e-5, rtol=1e-5)
REL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_caches():
    api.plan_cache_clear()
    japi.plan_cache_clear()
    yield
    api.plan_cache_clear()
    japi.plan_cache_clear()


def _sizes(seed, e, high=40, empty=0.3):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, high, e) * (rng.random(e) > empty)
    return s.astype(np.int32)


METADATA_CASES = {
    "ragged+empty": ([100, 0, 37, 60], 256, 64),
    "all_empty": ([0, 0, 0, 0], 128, 64),
    "empty_middle": ([8, 0, 0, 0, 16], 32, 8),
    "one_group": ([0, 0, 197, 0], 256, 64),
    "straddling": ([3, 2, 1, 1, 4, 2, 50], 64, 8),
    "tile_multiples": ([64, 64, 64, 5], 256, 64),
    "singletons": ([1] * 8, 16, 8),
    "random_a": (_sizes(0, 9), 320, 16),
    "random_b": (_sizes(1, 5, high=30), 128, 8),
}


@pytest.mark.parametrize("case", sorted(METADATA_CASES))
def test_group_metadata_equals_the_reference(case):
    sizes, m, bm = METADATA_CASES[case]
    sizes = np.asarray(sizes, np.int32)
    (jo, jg, jt), jn = j_group_metadata(jnp.asarray(sizes), m, bm)
    (to, tg, tt), tn = group_metadata(torch.as_tensor(sizes), m, bm)
    for want, got in ((jo, to), (jg, tg), (jt, tt)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tn.dim() == 0 and int(tn) == int(jn)
    assert tg.shape == (-(-m // bm) + len(sizes) - 1,)


def test_group_metadata_on_a_ragged_m():
    """A ragged last m-tile (m not a multiple of bm, which the port's
    kernels mask instead of padding) counts as a tile of its own."""
    sizes = torch.as_tensor([5, 0, 9], dtype=torch.int32)
    (offs, gids, tids), n = group_metadata(sizes, 14, 8)
    assert offs.tolist() == [0, 5, 5, 14]
    assert int(n) == 3 and gids.tolist()[:3] == [0, 2, 2]
    assert tids.tolist()[:3] == [0, 0, 1] and gids.shape == (4,)


def test_shared_tables_are_built_once_per_group_sizes(monkeypatch):
    """Inside ``shared_tables`` the launches of one MoE layer (same
    ``group_sizes`` tensor, m and bm) build the steering tables once;
    another tensor, m or bm builds its own, and outside a block every
    launch builds them anew."""
    from repro_torch.kernels import gemm_grouped as G
    built = []
    real = G.group_metadata
    monkeypatch.setattr(G, "group_metadata",
                        lambda gs, m, bm: built.append((m, bm)) or
                        real(gs, m, bm))
    sizes = torch.as_tensor([5, 0, 9], dtype=torch.int32)
    other = sizes.clone()
    with G.shared_tables():
        first = G._tables(sizes, 14, 8)
        assert G._tables(sizes, 14, 8) is first
        with G.shared_tables():                  # a nested block shares
            assert G._tables(sizes, 14, 8) is first
        G._tables(other, 14, 8)
        G._tables(sizes, 14, 16)
        G._tables(sizes, 16, 8)
    assert built == [(14, 8), (14, 8), (14, 16), (16, 8)]
    assert G._shared is None
    G._tables(sizes, 14, 8)
    G._tables(sizes, 14, 8)
    assert len(built) == 6
    for got, want in zip(first[0], real(sizes, 14, 8)[0]):
        assert torch.equal(got, want)


def _operands(sizes, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    e = len(sizes)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((e, k, n)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((e, n)).astype(np.float32)
    return a, b, np.asarray(sizes, np.int32), bias


GEMM_CASES = {
    "ragged+empty": ([70, 0, 37, 20], 127, 96, 80),
    "dropped_tail": ([30, 9, 0, 4], 64, 64, 48),
    "straddled": ([3, 2, 1, 1, 4, 2, 20], 40, 72, 64),
    "all_empty": ([0, 0, 0], 16, 32, 32),
}


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
@pytest.mark.parametrize("epi", ["none", "bias+silu"])
def test_plain_matches_pallas_interpret_and_blocked_ref(case, epi,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    sizes, m, k, n = GEMM_CASES[case]
    a, b, gs, bias = _operands(sizes, m, k, n)
    kw = {"bias": bias, "activation": "silu"} if epi != "none" else {}
    want = np.asarray(jops.gemm_grouped(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(gs),
        **{k_: jnp.asarray(v) if k_ == "bias" else v
           for k_, v in kw.items()}))
    tkw = {k_: torch.as_tensor(v) if k_ == "bias" else v
           for k_, v in kw.items()}
    got = gemm_grouped_plain(torch.as_tensor(a), torch.as_tensor(b),
                             torch.as_tensor(gs), **tkw)
    np.testing.assert_allclose(got.numpy(), want, **CLOSE)
    live = int(gs.sum())
    assert not got[live:].any()
    # the blocked oracle replays the Pallas tile order; pad to its tile
    t = j_tiling.TileConfig(8, 32, 32)
    pm, pk, pn = (-(-m // 8)) * 8, (-(-k // 32)) * 32, (-(-n // 32)) * 32
    ap = np.pad(a, ((0, pm - m), (0, pk - k)))
    bp = np.pad(b, ((0, 0), (0, pk - k), (0, pn - n)))
    bkw = {}
    if epi != "none":
        bkw = {"bias": jnp.asarray(np.pad(bias, ((0, 0), (0, pn - n)))
                                   [:, None, :]), "activation": "silu"}
    blocked = np.asarray(gemm_grouped_blocked_ref(
        jnp.asarray(ap), jnp.asarray(bp), jnp.asarray(gs), tile=t,
        out_dtype=jnp.float32, **bkw))[:m, :n]
    np.testing.assert_allclose(got.numpy(), blocked, **CLOSE)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    a, b, gs, bias = _operands([5, 0, 9], 20, 32, 24)
    ta, tb, tg = map(torch.as_tensor, (a, b, gs))
    before = (gemm_grouped.launches, gemm_grouped_plain.launches)
    y = gemm_grouped(ta, tb, tg, bias=torch.as_tensor(bias),
                     activation="relu", out_dtype=torch.float32)
    assert (gemm_grouped.launches, gemm_grouped_plain.launches) == \
        (before[0], before[1] + 1)
    assert y.shape == (20, 24) and not y[14:].any()
    assert (y[:14] >= 0).all()
    with pytest.raises(ValueError, match="int8 bank"):
        gemm_grouped(ta, tb, tg, b_scale=torch.ones(3, 1, 24))
    with pytest.raises(ValueError, match="group_sizes"):
        gemm_grouped(ta, tb, tg[:2])
    with pytest.raises(ValueError, match="no CTA shape"):
        gemm_grouped(ta, tb, tg, cta=0)


def _jspec(epilogue="", **kw):
    return japi.GemmSpec(grouped=True, epilogue=JEpilogue.parse(epilogue),
                         tune=False, **kw)


def _tspec(epilogue="", **kw):
    return api.GemmSpec(grouped=True, epilogue=Epilogue.parse(epilogue),
                        **kw)


#: (m, k, n, E, dense_rows): qwen3-moe's serve GEMMs (decode: 8 tokens x
#: top-8; prefill: 300 tokens x top-8) and a smoke-sized ragged one
GROUPED_SHAPES = [(64, 4096, 1536, 128, 1024), (64, 1536, 4096, 128, 1024),
                  (2400, 4096, 1536, 128, 3072), (197, 256, 256, 4, 256),
                  (40, 64, 64, 8, 64)]


@pytest.mark.parametrize("shape", GROUPED_SHAPES)
@pytest.mark.parametrize("case", ["plain", "silu", "bias+gelu", "f32"])
def test_grouped_plans_on_the_tpu_sheet_equal_the_reference(shape, case):
    kw = {"a_dtype": "float32", "b_dtype": "float32"} if case == "f32" \
        else {}
    ep = "" if case in ("plain", "f32") else case
    want = japi.plan(_jspec(ep, **kw), shape)
    got = api._resolve(_tspec(ep, **kw), *shape[:3], TPU_V5E, *shape[3:])
    assert (got.tile.strategy, got.tile.bm, got.tile.bk, got.tile.bn) == \
        (want.tile.strategy, want.tile.bm, want.tile.bk, want.tile.bn)
    assert got.tile.strategy == "aie"
    assert (got.n_groups, got.dense_rows) == (want.n_groups,
                                              want.dense_rows)
    jp_ = j_tiling.GemmProblem(*shape[:3], n_groups=shape[3])
    tp_ = t_tiling.GemmProblem(*shape[:3], n_groups=shape[3])
    assert t_tiling.grouped_instances(got.tile, tp_) == \
        j_tiling.grouped_instances(want.tile, jp_)
    assert got.hbm_bytes == pytest.approx(want.hbm_bytes, rel=REL)
    assert got.flops == pytest.approx(want.flops, rel=REL)
    assert got.traffic.t_model == pytest.approx(want.traffic.t_model,
                                                rel=REL)


def test_grouped_search_ranks_like_the_reference():
    args = (64, 4096, 1536, "bfloat16", "bfloat16", "float32", "bfloat16",
            "silu", 1, 128)
    want = j_dse.solve(j_tiling.GemmProblem(*args))
    got = t_dse.solve(t_tiling.GemmProblem(*args), TPU_V5E, top=10)
    assert [(d.tile.bm, d.tile.bk, d.tile.bn) for d in got] == \
        [(d.tile.bm, d.tile.bk, d.tile.bn) for d in want]
    assert all(d.tile.strategy == "aie" for d in got)


#: HOPPER_H100's plan (bm, bk, bn) of qwen3-moe-235b-a22b's expert GEMMs
#: (the cost model's tile: at most the 64 x 128 C block one CTA of B7
#: covers) and the (bm, bk, bn) CTA tile B7 launches for it
HOPPER_GROUPED_PLANS = {
    (64, 4096, 1536): ((8, 32, 128), (16, 128, 128)),    # decode gate / up
    (64, 1536, 4096): ((8, 32, 128), (16, 128, 128)),    # decode down
    (2400, 4096, 1536): ((32, 32, 128), (64, 64, 128)),  # prefill gate / up
    (2400, 1536, 4096): ((32, 32, 128), (64, 64, 128)),  # prefill down
}


@pytest.mark.parametrize("mkn", sorted(HOPPER_GROUPED_PLANS))
def test_hopper_grouped_plans_are_pinned_and_launchable(mkn):
    plan_tile, launched = HOPPER_GROUPED_PLANS[mkn]
    for ep in ("", "silu"):
        pl = ops.plan(_tspec(ep), mkn + (128,))
        t = pl.tile
        assert (t.strategy, t.bm, t.bk, t.bn) == ("aie",) + plan_tile
        assert pl.kernel == "grouped" and pl.launches == {"gemm_grouped": 1}
        assert grouped_cta_tile(mkn[0], 128) == launched
        assert HOPPER_H100.grouped_launchable(*launched[::2])
        for d in t_dse.solve(api._problem_for(_tspec(ep), *mkn, 128),
                             HOPPER_H100, top=50):
            assert HOPPER_H100.grouped_launchable(d.tile.bm, d.tile.bn)
            assert d.tile.strategy == "aie"


def test_every_cta_tile_b7_launches_is_launchable():
    """Each CTA tile of either body covers a C block the grouped search
    admits, and a larger block is refused."""
    for tiles in (BF16_TILES, F32_TILES):
        for bm, _, bn in tiles.values():
            assert HOPPER_H100.grouped_launchable(bm, bn)
    assert not HOPPER_H100.grouped_launchable(128, 128)
    assert not HOPPER_H100.grouped_launchable(64, 256)


def test_grouped_explain_states_kernel_instances_and_padding():
    pl = ops.plan(_tspec("silu"), (64, 4096, 1536, 128, 1024))
    text = pl.explain()
    assert "B7 gemm_grouped" in text and "csrc/gemm_grouped.cu" in text
    assert "E=128 groups, <=135 tile instances" in text
    assert "m=64 of 1024 dense-capacity" in text
    assert "padding  :" in text
    # the CTA tile B7 launches, by rows per expert, beside the plan's
    assert "launches its compiled 16x128x128 (bm x bk x bn) CTA tile" in text
    assert "rows per expert" in text and "tile     : aie 8x32x128" in text
    pre = ops.plan(_tspec("silu"), (2400, 4096, 1536, 128, 3072)).explain()
    assert "launches its compiled 64x64x128 (bm x bk x bn) CTA tile" in pre
    f32 = ops.plan(_tspec(a_dtype="float32", b_dtype="float32"),
                   (64, 256, 256, 128)).explain()
    assert "launches its compiled 8x64x128 (bm x bk x bn) CTA tile" in f32


def test_grouped_plans_key_on_groups_and_dense_rows():
    spec = _tspec()
    a = ops.plan(spec, (64, 256, 128, 8))
    assert a.dense_rows == 64 and ops.plan(spec, (64, 256, 128, 8)) is a
    assert ops.plan(spec, (64, 256, 128, 8, 512)) is not a
    assert ops.plan(spec, (64, 256, 128, 16)).n_groups == 16
    with pytest.raises(ValueError, match="E\\[, dense_rows\\]"):
        ops.plan(spec, (64, 256, 128))
    with pytest.raises(ValueError, match="E >= 1"):
        ops.plan(spec, (64, 256, 128, 0))
    with pytest.raises(ValueError, match="infeasible.*B7"):
        ops.plan(_tspec(tile=t_tiling.TileConfig(64, 64, 256)),
                 (64, 256, 256, 8))


@pytest.mark.parametrize("kw", [
    {"gated": True, "epilogue": "silu"},
    {"epilogue": "res"},
    {"strategy": "tb"},
])
def test_grouped_spec_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        japi.GemmSpec(grouped=True, **kw)
    with pytest.raises(ValueError):
        api.GemmSpec(grouped=True, **kw)
    assert api.GemmSpec(grouped=True).key == \
        japi.GemmSpec(grouped=True).key


def test_one_shot_and_execute_agree_and_check_operands():
    a, b, gs, bias = _operands([10, 0, 20, 3], 40, 64, 48)
    ta, tb, tg, tbias = map(torch.as_tensor, (a, b, gs, bias))
    y = ops.gemm_grouped(ta, tb, tg, bias=tbias, activation="silu",
                         dense_rows=64)
    hits = ops.plan_cache_info().hits
    again = ops.gemm_grouped(ta, tb, tg, bias=tbias, activation="silu",
                             dense_rows=64)
    assert torch.equal(y, again) and ops.plan_cache_info().hits == hits + 1
    pl = ops.plan(_tspec("bias+silu", a_dtype="float32",
                         b_dtype="float32"),
                  ops.gemm_grouped_shapes(ta, tb, 64))
    assert torch.equal(ops.execute(pl, ta, tb, bias=tbias,
                                   group_sizes=tg), y)
    with pytest.raises(ValueError, match="requires `group_sizes"):
        ops.execute(pl, ta, tb, bias=tbias)
    with pytest.raises(ValueError, match="expert bank"):
        ops.execute(pl, ta, tb[:3], bias=tbias, group_sizes=tg)
    with pytest.raises(ValueError, match="integer"):
        ops.execute(pl, ta, tb, bias=tbias, group_sizes=tg.float())
    with pytest.raises(ValueError, match="per-expert"):
        ops.execute(pl, ta, tb, bias=tbias[:2], group_sizes=tg)
    q = torch.as_tensor(np.clip(np.round(b * 40), -127, 127)
                        .astype(np.int8))
    scale = torch.full((4, 1, 48), 0.025)
    yq = ops.gemm_grouped(ta, {"q": q, "scale": scale}, tg)
    torch.testing.assert_close(
        yq, gemm_grouped_plain(ta, q, tg, b_scale=scale,
                               out_dtype=torch.float32),
        atol=0, rtol=0)
    with pytest.raises(ValueError, match="scale"):
        ops.gemm_grouped(ta, {"q": q, "scale": scale[:, :, :4]}, tg)
