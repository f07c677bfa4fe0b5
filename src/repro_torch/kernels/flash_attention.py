"""Forward online-softmax attention for prefill (kernel B3).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (pallas_call :125, body ``_flash_kernel`` :29) with
the hand-written CUDA kernel ``csrc/flash_attention.cu``.  At serving
prompt lengths its bytes and operations are far below a launch, so what
it pays is the latency of its key-block loop and of staging.  bf16
operands run both products on the tensor cores (``mma.sync`` m16n8k16),
the softmax in registers, K and V staged once per kv head's GQA group
through a ``cp.async`` ring; a CTA holds ``bq`` (q position, q head)
rows and a ring stage copies ``bkv`` keys, both chosen at launch among
the shapes :func:`b3_blocks` lists (64 and 64 unless asked), on the grid
:func:`cta_shape` gives.  f32 operands keep the ``fmaf`` body of
``csrc/flash.cuh`` (one shape).  Either way a row's bits depend only on
its absolute position and the keys (a fixed 64-key block grid, visited
in order), whatever the shape, so chunked == unchunked prefill bit for
bit and every compiled shape gives the same output.  The TPU's sq >=
128 gate (attn_api.py:403) came from its (8, 128) tiling: here every
prefill, short prompts included, runs the kernel.

Dispatch goes by device: a CPU tensor takes
:func:`flash_attention_plain`, a meta tensor (a dry-run's trace) gets an
empty result of the kernel's shape and dtype and launches nothing, a
CUDA tensor launches the kernel or raises.  The wrapper is the
``flash_attention`` scope of :mod:`repro_torch.core.op_cost`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core import op_cost
from repro_torch.core.tiling import cdiv
from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

#: widest head the kernels' shared-memory tiles hold (csrc/flash.cuh
#: kFaDmax; the bf16 bodies pad to 32, 64, 128 or 256)
MAX_HEAD_DIM = 256
#: keys a block of the bf16 body (csrc/flash_attention_mma.cuh kBkv):
#: the online-softmax step; blocks start at multiples of it from key 0
KEY_BLOCK = 64
#: rows a CTA of the f32 body holds: 16 positions of one q head
#: (csrc/flash.cuh kFaRows), and the keys of its block (kFaBkv)
F32_ROWS = 16
F32_KEY_BLOCK = 32
#: the default rows a CTA of the bf16 body holds, 16 a warp: on an H100
#: 64 rows beat 16 and 32 at smollm-360m's prompt and chunk lengths
#: (PERF.md §6)
BF16_ROWS = 64
#: the rows a bf16 CTA may hold (``bq``), and the keys a ring stage may
#: copy (``bkv``), as csrc/flash_attention_mma.cuh compiles them; at head
#: 256 at most 64 rows and 64-key stages (a 128-key stage's ring would
#: take 256 KB of shared memory)
B3_ROWS = (16, 32, 64, 128)
B3_STAGES = (KEY_BLOCK, 2 * KEY_BLOCK)

#: keys a split of the decode kernels' bf16 body (B4, B5;
#: csrc/decode_split.cuh kSplit): one warp and one partial, splits
#: starting at multiples of it from key 0.  A CTA holds 1, 2 or 4 of
#: them (B4's ``bkv`` = 64, 128 or 256 keys a CTA; 64 or 128 at head 256;
#: B5 one); on an H100 one a CTA beat two and four at smollm-360m's and
#: qwen3-moe's decode steps (PERF.md §6), so one is the default.
DECODE_SPLIT = 64
DECODE_CTA_KEYS = (DECODE_SPLIT, 2 * DECODE_SPLIT, 4 * DECODE_SPLIT)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
    + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


class CtaShape(NamedTuple):
    """What one launch runs: ``rows`` rows a CTA, ``tiles`` q tiles of
    one (batch row, head group), ``ctas`` CTAs in all, ``head_dim`` the
    head padded in shared memory, ``smem_bytes`` a CTA's shared memory
    and ``body`` ("tensor cores" or "fmaf")."""

    rows: int
    tiles: int
    ctas: int
    head_dim: int
    smem_bytes: int
    body: str


def padded_head(d: int) -> int:
    """The head width the bf16 bodies pad ``d`` to in shared memory
    (their ``kD`` instantiations; a wider head, which the kernels
    refuse, is billed at the widest)."""
    return next((w for w in (32, 64, 128) if d <= w), MAX_HEAD_DIM)


def bf16_rows(d: int) -> int:
    """Rows a CTA of the bf16 body holds by default: :data:`BF16_ROWS`,
    or half of them at head 256, where two warps share 16 rows (each
    keeping half of O's columns)."""
    return BF16_ROWS // 2 if padded_head(d) > 128 else BF16_ROWS


def b3_blocks(d: int, dtype=torch.bfloat16) -> tuple:
    """The (bq, bkv) shapes B3 compiles for head ``d``, the default
    first: bf16 ``bq`` rows a CTA by ``bkv`` keys a stage; f32 its one
    shape (16 positions of one q head, 32-key blocks)."""
    if dtype != torch.bfloat16:
        return ((F32_ROWS, F32_KEY_BLOCK),)
    wide = padded_head(d) > 128
    rows = tuple(r for r in B3_ROWS if not (wide and r > 64))
    stages = B3_STAGES[:1] if wide else B3_STAGES
    default = (bf16_rows(d), KEY_BLOCK)
    return (default,) + tuple((r, s) for r in rows for s in stages
                              if (r, s) != default)


def _compiled(name: str, what: str, value, allowed, d, dtype):
    if value not in allowed:
        raise ValueError(f"{name}: {what}={value} is not compiled for "
                         f"head_dim {d} in {dtype}; compiled: "
                         f"{sorted(allowed)}")
    return value


def b3_shape(d: int, dtype=torch.bfloat16, bq: Optional[int] = None,
             bkv: Optional[int] = None) -> tuple:
    """(rows a CTA, keys a stage) for a launch asked for ``bq`` /
    ``bkv`` (None: the default's); a value or pair B3 does not compile
    raises ``ValueError`` naming the compiled set."""
    blocks = b3_blocks(d, dtype)      # every rows x stages pair
    rows = _compiled("flash_attention", "bq",
                     blocks[0][0] if bq is None else bq,
                     {r for r, _ in blocks}, d, dtype)
    stage = _compiled("flash_attention", "bkv",
                      blocks[0][1] if bkv is None else bkv,
                      {s for _, s in blocks}, d, dtype)
    return rows, stage


def decode_blocks(d: int, dtype=torch.bfloat16) -> tuple:
    """The keys a CTA B4 compiles for head ``d`` (``bkv``), the default
    first: bf16 1, 2 or 4 64-key splits (1 or 2 at head 256); f32 its
    one 32-key block walk."""
    if dtype != torch.bfloat16:
        return (F32_KEY_BLOCK,)
    return DECODE_CTA_KEYS[:2] if padded_head(d) > 128 else DECODE_CTA_KEYS


def decode_cta_keys(d: int, dtype=torch.bfloat16,
                    bkv: Optional[int] = None) -> int:
    """The keys a CTA of a decode launch asked for ``bkv`` (None: the
    default); one B4 does not compile raises ``ValueError``."""
    allowed = decode_blocks(d, dtype)
    return allowed[0] if bkv is None else _compiled(
        "flash_decode", "bkv", bkv, set(allowed), d, dtype)


def f32_head(d: int) -> int:
    """The head width the f32 body's tiles are sized for (``kDmax`` of
    csrc/flash.cuh)."""
    return 128 if d <= 128 else MAX_HEAD_DIM


def f32_smem_bytes(d: int) -> int:
    """A CTA's shared memory in the f32 body (csrc/flash.cuh
    ``FlashSmem<kDmax>``: q, k with one more column, v and p, in f32)."""
    w = f32_head(d)
    return 4 * (F32_ROWS * w + 32 * (w + 1) + 32 * w + F32_ROWS * 32)


def cta_shape(b: int, sq: int, hq: int, hkv: int, d: int,
              dtype=torch.bfloat16, bq: Optional[int] = None,
              bkv: Optional[int] = None) -> CtaShape:
    """The CTA shape and grid the kernel launches for q (b, sq, hq, d)
    against k/v with ``hkv`` heads, at ``bq`` rows a CTA and ``bkv``
    keys a stage (None: the default; :func:`b3_shape` checks them).

    bf16: a CTA holds ``bq`` (q position, q head) pairs of one kv
    head's group, flattened position-major (row f is position f //
    group, q head kv_head * group + f % group), so each staged K/V block
    serves the whole group.  CTA x runs q tile ``tiles - 1 - x // (hkv
    b)`` (the causally heaviest first), kv head ``x % (hkv b) % hkv``
    and batch row ``x % (hkv b) // hkv``.  head_dim is padded to 32, 64,
    128 or 256 in shared memory, two ring stages of ``bkv`` keys of K
    and V.  At 256 two warps share 16 rows, each keeping half of O's
    columns (registers would not hold all 256), and the rows' q takes a
    shared tile (csrc/flash_attention_mma.cuh).  f32: 16 positions of
    one q head a CTA, the grid (q tiles, hq, b)."""
    rows, stage = b3_shape(d, dtype, bq, bkv)
    if dtype != torch.bfloat16:
        tiles = cdiv(sq, F32_ROWS)
        return CtaShape(F32_ROWS, tiles, tiles * hq * b, f32_head(d),
                        f32_smem_bytes(d), "fmaf")
    head_dim = padded_head(d)
    tiles = cdiv(sq * (hq // hkv), rows)
    q_tile = rows if head_dim > 128 else 0
    return CtaShape(rows, tiles, tiles * hkv * b, head_dim,
                    (2 * 2 * stage + q_tile) * head_dim * 2,
                    "tensor cores")


class DecodeGrid(NamedTuple):
    """What one decode launch (B4 over a cache of ``length`` keys, or B5
    over a table of ``max_pages * page_size``) runs: ``ctas`` CTAs on
    the split axis of ``per_cta`` warps each (``splits`` splits of
    :data:`DECODE_SPLIT` keys, one partial each, per kv head and slot),
    then ``merge_ctas`` merge CTAs; ``head_dim`` the head padded in
    shared memory, ``acc_floats`` and ``ml_floats`` the f32 scratch the
    wrapper allocates, and ``body`` ("tensor cores" or "fmaf")."""

    splits: int
    ctas: int
    merge_ctas: int
    head_dim: int
    acc_floats: int
    ml_floats: int
    body: str
    per_cta: int = 1


def decode_grid(b: int, hq: int, hkv: int, length: int, d: int,
                dtype=torch.bfloat16, bkv: Optional[int] = None
                ) -> DecodeGrid:
    """The grid the decode kernels launch for q (b, hq, d) against keys
    of ``length`` slots and ``hkv`` heads, at ``bkv`` keys a CTA (None:
    the default; :func:`decode_cta_keys` checks it).  It depends on
    what the host knows (b, the heads, the length), never on the
    positions.

    bf16: CTA (x, kv head, slot) holds ``bkv / 64`` warps; warp w takes
    split s = x bkv / 64 + w, keys [64 s, 64 s + 64), and writes its
    partial (m, l for each of the group's rows; acc at the padded head
    width), or returns at once when they hold no key the slot sees (or s
    is past the split axis); the merge CTAs then fold each slot's
    partials in ascending split order (:func:`decode_splits`), a thread
    taking four columns of one of the group's rows, 128 threads a CTA.
    f32: one CTA per (kv head, slot) walks 32-key blocks
    (csrc/flash.cuh)."""
    keys = decode_cta_keys(d, dtype, bkv)
    if dtype != torch.bfloat16:
        return DecodeGrid(1, hkv * b, 0, f32_head(d), 0, 0, "fmaf")
    head_dim = padded_head(d)
    per_cta = keys // DECODE_SPLIT
    splits = cdiv(length, DECODE_SPLIT)
    parts = b * hkv * splits * (hq // hkv)
    merge_ctas = cdiv((hq // hkv) * cdiv(d, 4), 128) * hkv * b
    return DecodeGrid(splits, cdiv(splits, per_cta) * hkv * b, merge_ctas,
                      head_dim, parts * head_dim, parts * 2, "tensor cores",
                      per_cta)


def decode_splits(pos: int, length: int, window: int = 0) -> range:
    """The splits whose partials the bf16 decode merges for a slot at
    ``pos``, in the order it merges them: those that hold a key of
    [max(0, pos - window + 1), min(length, pos + 1)) (the lower end only
    under a window).  ``length`` matters only where pos + 1 exceeds it,
    so a row's splits, and its bits, are the same in a dense cache and
    in a page table of another length."""
    hi = min(length, pos + 1)
    lo = max(0, pos - window + 1) if window > 0 else 0
    if hi <= lo:
        return range(0)
    return range(lo // DECODE_SPLIT, cdiv(hi, DECODE_SPLIT))


def decode_live_ctas(pos, length: int, window: int, hkv: int) -> int:
    """Split CTAs of a bf16 decode launch that hold a key their slot
    sees (the rest return at once), over the slots' positions ``pos``."""
    return hkv * sum(len(decode_splits(int(p), length, window)) for p in pos)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, scale: Optional[float] = None,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    flash_attention_plain.launches += 1
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, scale=scale)


flash_attention_plain.launches = 0


def _cost(o, q, k, v, **_):
    """(FLOPs, boundary bytes): QK^T and PV over the full sq x skv
    rectangle (:mod:`repro_torch.core.op_cost`)."""
    b, sq, hq, d = q.shape
    return 4 * b * hq * sq * k.shape[1] * d, op_cost.boundary(o, q, k, v)


@op_cost.scope("flash_attention", _cost)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_offset: Optional[int] = None,
                    bq: Optional[int] = None,
                    bkv: Optional[int] = None) -> torch.Tensor:
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d); returns (b, sq, hq, d)
    in q's dtype.  GQA maps kv head = q head // (hq // hkv);
    ``q_offset`` defaults to skv - sq.  ``bq`` / ``bkv`` (the JAX
    wrapper's keywords): rows a CTA and keys a ring stage, one of the
    shapes :func:`b3_blocks` lists (None: the default); a shape that is
    not compiled raises ``ValueError``.  Here ``bq`` counts the CTA's
    (q position, q head) rows of one kv head's group, where the JAX
    package's counts q positions; every shape gives the same bits."""
    b, sq, hq, d = q.shape
    bk, skv, hkv, dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or bk != b or dk != d \
            or hq % hkv != 0:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    rows, stage = b3_shape(d, q.dtype, bq, bkv)
    if q_offset is None:
        q_offset = skv - sq
    scale = float(scale if scale is not None else d ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset) \
            .contiguous()               # the kernel's layout, as on a card
    if q.device.type == "meta":
        _build.require_meta("flash_attention", k, v)
        return torch.empty_like(q)
    _build.require_cuda("flash_attention", q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("flash_attention: q, k, v dtypes differ")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} > {MAX_HEAD_DIM}")
    code = _build.dtype_code(q.dtype, "flash_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    # the bf16 body's staging copy modes of k and v
    modes = _build.copy_mode(k, hkv * d, d) | _build.copy_mode(v, hkv * d,
                                                               d) << 2
    rc = _build.entry("flash_attention_launch", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, sq, skv, hq, hkv, d, int(causal), int(window), int(q_offset),
        scale, code, modes, rows, stage, _build.stream_of(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
