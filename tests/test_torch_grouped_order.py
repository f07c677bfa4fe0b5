"""B7's steering and coverage, checked on the CPU before the card runs it.

``csrc/gemm_grouped.cu`` hands C to the caller uncleared, so every
element must be written exactly once: each row a group owns by the one
instance of that group whose m tile holds it, every row past the groups
zeroed, and nothing else.  Its bits rest on a row being computed from
that row alone, so a CTA may read a row that another group owns only
into a fragment row it never stores.  This file emulates, in Python,

* the table kernel (``grouped_tables_kernel``): 256 threads, each a run
  of groups, whose first row and first instance come from two prefix
  sums over the threads, and the padding after the live entries filled
  as the reference pads; held to :func:`group_metadata` (itself held to
  the JAX package's in ``tests/test_torch_gemm_grouped.py``), entry for
  entry;
* the launch's coverage at every CTA tile B7 launches, both bodies: the
  bf16 body's 16-row warps over the group's rows staged from A tile row
  0, each lane's fragment rows and the 16-row boxes that fill them; the
  f32 body's row groups over the tile's rows; and the tail the CTAs
  zero.

On the card, ``tests/test_torch_cuda.py`` holds the kernels to the same
tables and to B1's bits.

    PYTHONPATH=src python -m pytest -q tests/test_torch_grouped_order.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.tiling import cdiv
from repro_torch.kernels.gemm_grouped import (BF16_TILES, F32_TILES,
                                              cta_tile, group_metadata)


def _routed(tokens, e, top_k, cap, seed):
    rng = np.random.default_rng(seed)
    counts = np.zeros(e, np.int64)
    for _ in range(tokens):
        counts[rng.choice(e, top_k, replace=False)] += 1
    return np.minimum(counts, cap).tolist()


#: (group sizes, m): ragged and empty groups, groups on tile boundaries, a
#: dropped tail, one group, all empty, singletons, and qwen3-moe's routed
#: decode (64 rows, 128 experts) and prefill (2400 rows, capacity 24)
CASES = {
    "ragged+empty": ([100, 0, 37, 60], 256),
    "all_empty": ([0, 0, 0, 0], 128),
    "empty_middle": ([8, 0, 0, 0, 16], 32),
    "one_group": ([0, 0, 197, 0], 256),
    "straddling": ([3, 2, 1, 1, 4, 2, 50], 64),
    "tile_multiples": ([64, 64, 64, 5], 256),
    "singletons": ([1] * 8, 16),
    "dropped_tail": ([5, 9, 0, 4], 30),
    "ragged_m": ([5, 0, 9], 14),
    "qwen3_decode": (_routed(8, 128, 8, 8, 21), 64),
    "qwen3_prefill": (_routed(300, 128, 8, 24, 22), 2400),
    # more groups than the table kernel's threads: runs of 2 groups
    "many_groups": (_routed(40, 300, 4, 3, 23), 200),
}
#: every (m tile) B7's tables are built at: the CTA tiles of both bodies
M_TILES = sorted({t[0] for t in (*BF16_TILES.values(), *F32_TILES.values())})


TABLE_THREADS = 256


def emulate_tables(sizes, m, bm):
    """``grouped_tables_kernel``: thread t's run of groups, its first row
    and first instance by exclusive prefix sums over the threads."""
    e, n_inst = len(sizes), cdiv(m, bm) + len(sizes) - 1
    per = cdiv(e, TABLE_THREADS)
    runs = [range(min(e, t * per), min(e, t * per + per))
            for t in range(TABLE_THREADS)]
    rows = [sum(sizes[g] for g in run) for run in runs]
    starts = np.concatenate([[0], np.cumsum(rows)[:-1]]).tolist()
    offsets, group_ids, m_tile_ids = [0] * (e + 1), [None] * n_inst, \
        [None] * n_inst
    counts = []
    for run, start in zip(runs, starts):
        count, s = 0, start
        for g in run:
            end = s + sizes[g]
            offsets[g + 1] = end
            if end > s:
                count += (end + bm - 1) // bm - s // bm
            s = end
        counts.append(count)
    firsts = np.concatenate([[0], np.cumsum(counts)[:-1]]).tolist()
    for run, start, inst in zip(runs, starts, firsts):
        s = start
        for g in run:
            end = s + sizes[g]
            if end > s:
                for t in range(s // bm, (end + bm - 1) // bm):
                    if inst < n_inst:
                        group_ids[inst], m_tile_ids[inst] = g, t
                    inst += 1
            s = end
    live = min(sum(counts), n_inst)
    all_rows = sum(rows)
    next_tile = (all_rows - 1) // bm + 1 if all_rows > 0 else 0
    for i in range(live, n_inst):
        group_ids[i] = e - 1
        m_tile_ids[i] = min(next_tile + (i - live), cdiv(m, bm) - 1)
    return offsets, group_ids, m_tile_ids, live


@pytest.mark.parametrize("bm", M_TILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_table_kernel_equals_group_metadata(case, bm):
    sizes, m = CASES[case]
    (offs, gids, tids), live = group_metadata(
        torch.as_tensor(np.asarray(sizes, np.int32)), m, bm)
    got = emulate_tables(sizes, m, bm)
    assert got[0] == offs.tolist()
    assert got[1] == gids.tolist() and got[2] == tids.tolist()
    assert got[3] == int(live)


@pytest.mark.parametrize("bm", M_TILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_live_instances_fit_the_launched_grid(case, bm):
    """The wrapper launches min(E, m) + tiles_m - 1 instances of the
    tables' tiles_m + E - 1: at most min(E, m) groups hold rows, and each
    adds one instance a tile boundary it straddles."""
    sizes, m = CASES[case]
    live = emulate_tables(sizes, m, bm)[3]
    assert live <= min(len(sizes), m) + cdiv(m, bm) - 1


def _owner(sizes, m):
    """The group owning each row, -1 past the groups."""
    own = np.full(m, -1)
    start = 0
    for g, size in enumerate(sizes):
        own[start:start + size] = g
        start += size
    return own


def _instance(offsets, g, tile, bm, m):
    """``instance_rows``: the rows [lo, hi) of m tile ``tile`` that group
    g owns."""
    row0 = tile * bm
    return max(offsets[g], row0), min(offsets[g + 1], row0 + bm, m)


def emulate_bf16(sizes, m, tile):
    """The bf16 body's writes and reads of C rows and A rows: per live
    instance, its rows staged from A tile row 0 (the group's first row)
    by 16-row boxes, each live warp's fragment rows (lane / 4 and + 8),
    the rows it stores (every fragment row read lies inside the staged
    boxes); then the tail the CTAs zero.  Returns the write count of
    each row, the groups whose instances wrote it, and where the tail
    starts."""
    bm, _, bn = tile
    wm = bm // 16                       # 16-row warps
    offsets, gids, tids, live = emulate_tables(sizes, m, bm)
    writes = np.zeros(m, int)
    writers = [set() for _ in range(m)]
    for i in range(live):
        g = gids[i]
        lo, hi = _instance(offsets, g, tids[i], bm, m)
        rows = hi - lo
        if rows <= 0:
            continue
        a_rows = 8 if bm == 16 and rows <= 8 else min(bm, (rows + 15) // 16
                                                      * 16)
        boxes = (a_rows + 15) // 16     # tensor-map loads: 16 rows a box
        for w in range(wm):
            wr = 16 * w
            if wr >= rows:              # a dead warp: no products
                continue
            stored = set()
            for lane in range(32):
                for e in range(4):
                    r = wr + lane // 4 + 8 * (e // 2)
                    # the fragment row read: beyond a_rows it is a copy
                    # of a staged row (B1's edge) or a box's spare row
                    assert r < 16 * boxes
                    if r < rows:
                        stored.add(r)
            for r in stored:
                writes[lo + r] += 1
                writers[lo + r].add(g)
    tail = offsets[-1]
    writes[tail:] += 1                  # zero_tail
    return writes, writers, tail


def emulate_f32(sizes, m, tile):
    """The f32 body's writes: 256 threads, a column each, 256 / bn row
    groups of 4 rows; a row is stored by the thread that owns it when
    its group owns it.  Returns as :func:`emulate_bf16` does."""
    bm, _, bn = tile
    groups = 256 // bn
    offsets, gids, tids, live = emulate_tables(sizes, m, bm)
    writes = np.zeros(m, int)
    writers = [set() for _ in range(m)]
    for i in range(live):
        g = gids[i]
        lo, hi = _instance(offsets, g, tids[i], bm, m)
        row0 = tids[i] * bm
        for ty in range(groups):
            my_rows = max(0, (bm - ty + groups - 1) // groups)
            assert my_rows <= 4
            for k in range(my_rows):
                row = row0 + ty + groups * k
                if lo <= row < hi:
                    writes[row] += 1
                    writers[row].add(g)
    tail = offsets[-1]
    writes[tail:] += 1
    return writes, writers, tail


@pytest.mark.parametrize("body,config", [("bf16", c) for c in BF16_TILES]
                         + [("f32", c) for c in F32_TILES])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_row_is_written_once_by_its_group(case, body, config):
    sizes, m = CASES[case]
    if body == "bf16":
        writes, writers, tail = emulate_bf16(sizes, m, BF16_TILES[config])
    else:
        writes, writers, tail = emulate_f32(sizes, m, F32_TILES[config])
    own = _owner(sizes, m)
    assert (writes == 1).all(), np.nonzero(writes != 1)[0][:10]
    for r in range(tail):
        assert writers[r] == {own[r]}, r
    for r in range(tail, m):            # only zero_tail writes there
        assert not writers[r], r


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_and_prefill_pick_their_cta_tile(case):
    """At most one routed row an expert takes the 16-row decode shape,
    more the 64-row prefill shape; qwen3-moe's decode streams one
    instance a live expert."""
    sizes, m = CASES[case]
    e = len(sizes)
    bm = cta_tile(m, e)[0]
    assert bm == (16 if m <= e else 64)
    if case == "qwen3_decode":
        offsets, gids, tids, live = emulate_tables(sizes, m, bm)
        assert live - sum(1 for s in sizes if s) <= cdiv(m, bm) - 1
