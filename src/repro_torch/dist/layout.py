"""Name-pattern partition-spec engine and layout search (port of
``repro/dist/layout.py``, the *policy* half of ``repro_torch.dist``).

For a whole model on a whole mesh, enumerate the candidate sharding
strategies, score each by per-device bytes plus collective traffic, and
give the spec of every parameter / cache / batch leaf under the winner,
exactly as the JAX module does (``tests/test_torch_layout.py`` holds
every spec and choice to it):

* ``dp``      — pure data parallel: params replicated.
* ``tp``      — tensor parallel over ``'model'``: column-parallel
  projections shard their output dim, row-parallel their input dim;
  MoE expert banks shard the expert dim (expert parallelism).
* ``fsdp``    — parameters sharded over the batch-like axes
  (``('pod', 'data')``).
* ``fsdp_tp`` — both.

Every placement is divisibility-checked: a dim that does not divide its
mesh axes relaxes to replicated.  Specs are full-rank and derived from
parameter *names*, so the int8 ``{"q", "scale"}`` structs inherit the
parent weight's placement.

The JAX package hands the specs to ``jax.device_put``; here
:func:`shard_tree` cuts each rank's block of a whole tree and
:func:`gather_tree` puts the whole back together.  How the train step
computes with the blocks: :func:`compute_specs`.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.bridge import zip_trees
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P

STRATEGIES = ("dp", "tp", "fsdp", "fsdp_tp")

# ---------------------------------------------------------------------------
# Name patterns -> trailing-dim roles
#
# Roles name the *parallelism direction* of each trailing dim; leading
# (stacked) dims are always replicated.  'fsdp' dims shard over the
# batch-like axes, 'tp' dims over 'model', 'expert' dims over 'model'
# (expert parallelism), 'rep' dims stay replicated.
# ---------------------------------------------------------------------------

_PATTERNS: Tuple[Tuple[re.Pattern, Tuple[str, ...]], ...] = tuple(
    (re.compile(pat), roles) for pat, roles in (
        (r"moe/router$", ("rep", "rep")),
        (r"moe/w_(gate|up)$", ("expert", "fsdp", "tp")),
        (r"moe/w_down$", ("expert", "tp", "fsdp")),
        (r"(attn|cross)/w[qkv]$", ("fsdp", "tp")),      # column-parallel
        (r"(attn|cross)/wo$", ("tp", "fsdp")),          # row-parallel
        (r"mlp/w_(gate|up|in)$", ("fsdp", "tp")),
        (r"mlp/w_(down|out)$", ("tp", "fsdp")),
        (r"(mixer|rec)/in_proj$", ("fsdp", "tp")),
        (r"(mixer|rec)/out_proj$", ("tp", "fsdp")),
        (r"rec/w_[ri]$", ("fsdp", "tp")),
        (r"lm_head$", ("fsdp", "tp")),
        (r"embed$", ("fsdp", "tp")),
    ))

#: quantized-struct leaf names that inherit the parent weight's pattern
_QUANT_SUFFIX = re.compile(r"/(q|scale)$")

#: role resolution priority — 'expert' claims 'model' before 'tp' can
_ROLE_ORDER = ("expert", "tp", "fsdp")

#: an expert bank (or its int8 struct's leaves)
_EXPERT_BANK = re.compile(r"moe/w_(gate|up|down)(/q|/scale)?$")


def _prod(xs) -> int:
    return int(math.prod(xs)) if xs else 1


def _fsdp_candidates(axis_sizes: Dict[str, int]
                     ) -> Tuple[Tuple[str, ...], ...]:
    """Batch-like axis combinations to try for an 'fsdp' dim, widest
    first: ('pod','data') -> ('data',) -> ('pod',)."""
    present = tuple(a for a in sharding.DATA_AXES if a in axis_sizes)
    cands = []
    if len(present) > 1:
        cands.append(present)
    for a in reversed(present):
        cands.append((a,))
    return tuple(cands)


def _axis_for_role(role: str, dim: int, strategy: str,
                   axis_sizes: Dict[str, int], used: set):
    """Mesh axis (or axes tuple) for one (role, dim) under ``strategy``,
    or None (inactive role / no divisible placement)."""
    if role in ("rep", None) or strategy == "dp":
        return None
    if role == "expert" or (role == "tp" and strategy in ("tp", "fsdp_tp")):
        m = axis_sizes.get("model", 1)
        if "model" not in used and m > 0 and dim % m == 0 \
                and "model" in axis_sizes:
            return "model"
        return None
    if role == "fsdp" and strategy in ("fsdp", "fsdp_tp"):
        for cand in _fsdp_candidates(axis_sizes):
            if any(a in used for a in cand):
                continue
            if dim % _prod([axis_sizes[a] for a in cand]) == 0:
                return cand if len(cand) > 1 else cand[0]
        return None
    return None


def spec_for(name: str, shape: Sequence[int], strategy: str,
             axis_sizes: Dict[str, int]) -> P:
    """Full-rank spec for one named parameter leaf.  ``name`` is the
    '/'-joined tree path (``layers/u0/attn/wq``, or the quantized
    ``layers/u0/attn/wq/q``); unknown names are replicated."""
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown layout strategy {strategy!r}; want one of "
            f"{STRATEGIES}")
    base = _QUANT_SUFFIX.sub("", name)
    roles: Optional[Tuple[str, ...]] = None
    for pat, r in _PATTERNS:
        if pat.search(base):
            roles = r
            break
    rank = len(shape)
    entries: list = [None] * rank
    if roles is None:
        return P(*entries)
    roles = roles[-rank:]
    offset = rank - len(roles)
    used: set = set()
    for want in _ROLE_ORDER:
        for i, role in enumerate(roles):
            if role != want:
                continue
            ax = _axis_for_role(role, int(shape[offset + i]), strategy,
                                axis_sizes, used)
            if ax is not None:
                entries[offset + i] = ax
                used.update(ax if isinstance(ax, tuple) else (ax,))
    return P(*entries)


# ---------------------------------------------------------------------------
# Tree-level spec derivation
# ---------------------------------------------------------------------------

def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of nested dicts, the path the
    '/'-joined keys (the JAX package's ``_path_str``)."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(params, cfg, mesh, strategy: Optional[str] = None):
    """Spec tree mirroring ``params`` (full-rank leaves; tensors of any
    device, the meta device included).  ``mesh`` only contributes axis
    names and sizes, so duck-typed meshes work; ``strategy`` defaults to
    :func:`choose_layout` scored against this mesh's axes."""
    sizes = sharding.axis_sizes(mesh)
    strategy = strategy or choose_layout(cfg, sizes)
    return _map_paths(lambda path, leaf: spec_for(path, leaf.shape,
                                                  strategy, sizes), params)


def param_shardings(params, cfg, mesh, strategy: Optional[str] = None):
    """:class:`~repro_torch.dist.sharding.NamedSharding` tree for
    ``params`` on a concrete mesh."""
    specs = param_specs(params, cfg, mesh, strategy)
    return zip_trees(lambda s: sharding.NamedSharding(mesh, s), specs)


def _data_axes(mesh, rows: int):
    return sharding.data_axes_for(int(rows), sharding.axis_sizes(mesh))


def batch_specs(batch, mesh):
    """Row-shard every batch leaf over the batch-like axes (dim 0); all
    other dims replicated.  Rows that don't divide replicate."""
    def one(leaf):
        rank = len(leaf.shape)
        if rank == 0:
            return P()
        return P(_data_axes(mesh, int(leaf.shape[0])),
                 *([None] * (rank - 1)))

    return zip_trees(one, batch)


def cache_specs(cache, mesh):
    """Decode / prefill cache specs, the JAX package's rules: stacked
    caches under ``layers`` / ``cross`` carry the batch at dim 1, the
    unstacked ``tail`` and ``pos`` at dim 0; k / v shard their sequence
    dim over ``'model'``; a block-paged pool (``"page_table"`` present)
    shards its kv-head dim over ``'model'`` instead, while ``pos`` /
    ``page_table`` row-shard with the slots."""
    sizes = sharding.axis_sizes(mesh)
    model_ok = "model" in sizes
    paged = isinstance(cache, dict) and "page_table" in cache

    def one(path, leaf):
        rank = len(leaf.shape)
        if rank == 0:
            return P()
        keys = path.split("/")
        if paged and keys[-1] in ("k", "v"):
            entries = [None] * rank
            hdim = rank - 2
            if model_ok and int(leaf.shape[hdim]) % sizes["model"] == 0:
                entries[hdim] = "model"
            return P(*entries)
        stacked = keys[0] in ("layers", "cross")
        bdim = 1 if stacked and rank >= 2 else 0
        entries: list = [None] * rank
        entries[bdim] = _data_axes(mesh, int(leaf.shape[bdim]))
        sdim = bdim + 1
        if keys[-1] in ("k", "v") and sdim < rank and model_ok \
                and int(leaf.shape[sdim]) % sizes["model"] == 0:
            entries[sdim] = "model"
        return P(*entries)

    return _map_paths(one, cache)


def compute_specs(specs):
    """The specs the train step computes under: every leaf whole but an
    expert bank's expert dim on ``'model'``, which expert parallelism
    keeps (its leaves never gathered).  ``specs``: a param-spec tree."""
    def one(path, spec):
        if _EXPERT_BANK.search(path):
            return P(*(e if e == "model" else None for e in spec))
        return P(*([None] * len(spec)))

    return _map_paths(one, specs)


def shard_tree(tree, specs, mesh):
    """This rank's block of every leaf of the whole ``tree`` under
    ``specs`` (a tree of the same structure, nested dicts and named
    tuples)."""
    return zip_trees(lambda t, s: sharding.shard(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """The whole tree from every rank's blocks (a collective on each
    sharded leaf; the inverse of :func:`shard_tree`)."""
    return zip_trees(lambda t, s: sharding.gather(t, s, mesh), tree, specs)


def dropped_specs(specs, compute):
    """Per leaf, the entries of ``specs`` that ``compute`` (its
    :func:`compute_specs`) drops: what a step gathers at its start
    (:func:`gather_tree`) and cuts again at its end
    (:func:`shard_tree`)."""
    return zip_trees(lambda s, c: P(*(None if e == ce else e
                                 for e, ce in zip(s, c))), specs, compute)


# ---------------------------------------------------------------------------
# Layout search — choose_layout
# ---------------------------------------------------------------------------

#: per-collective latency/launch overhead, expressed in byte-equivalents;
#: penalizes FSDP's per-layer gathers for models small enough that
#: replication is free
LATENCY_EQUIV_BYTES = 32 * 2 ** 20

#: HBM feasibility headroom — fragmentation + temp buffers
HBM_FIT_FRACTION = 0.9

#: optimizer switch mirrors repro_torch.train.train_step.ADAFACTOR_THRESHOLD
#: (not imported: layout stays import-cycle-free below the models)
_ADAFACTOR_THRESHOLD = 100e9

_DEFAULT_AXES = {"data": 16, "model": 16}       # production single pod


def _train_bytes_per_param(cfg) -> float:
    """bf16 params + fp32 grads + optimizer state (AdamW m,v fp32; the
    >=100B regime uses Adafactor whose factored stats are ~free)."""
    opt = 8.0 if cfg.param_count() < _ADAFACTOR_THRESHOLD else 0.5
    return 2.0 + 4.0 + opt


def score_layouts(cfg, axis_sizes: Optional[Dict[str, int]] = None, *,
                  hbm_bytes: Optional[int] = None) -> Dict[str, dict]:
    """Score every strategy for ``cfg`` on a mesh of ``axis_sizes``:
    per-device resident bytes, param-collective wire bytes per step and
    a per-collective latency charge.  ``hbm_bytes`` defaults to the
    H100's (``HOPPER_H100``).  Returns ``{strategy:
    {mem_bytes_per_device, collective_bytes_per_device, n_collectives,
    feasible, score}}``."""
    sizes = dict(axis_sizes or _DEFAULT_AXES)
    model = max(1, sizes.get("model", 1))
    dataprod = _prod([sizes[a] for a in sharding.DATA_AXES if a in sizes])
    dataprod = max(1, dataprod)
    if hbm_bytes is None:
        from repro_torch.core.hardware import HOPPER_H100
        hbm_bytes = HOPPER_H100.hbm_bytes

    n_params = cfg.param_count()
    train_bytes = n_params * _train_bytes_per_param(cfg)
    grad_wire = 2.0 * n_params                  # bf16 grads on the wire
    n_layers = cfg.n_layers

    shard_factor = {"dp": 1, "tp": model, "fsdp": dataprod,
                    "fsdp_tp": dataprod * model}
    collectives = {
        "dp": (2.0 * grad_wire, 1),
        "tp": (2.0 * grad_wire / model, 1),
        "fsdp": (3.0 * grad_wire, 3 * n_layers + 1),
        "fsdp_tp": (3.0 * grad_wire / model, 3 * n_layers + 1),
    }
    out = {}
    for s in STRATEGIES:
        mem = train_bytes / shard_factor[s]
        wire, n_coll = collectives[s]
        out[s] = {
            "mem_bytes_per_device": mem,
            "collective_bytes_per_device": wire,
            "n_collectives": n_coll,
            "feasible": mem <= HBM_FIT_FRACTION * hbm_bytes,
            "score": mem + wire + n_coll * LATENCY_EQUIV_BYTES,
        }
    return out


def choose_layout(cfg, axis_sizes: Optional[Dict[str, int]] = None, *,
                  hbm_bytes: Optional[int] = None) -> str:
    """Cheapest feasible strategy for ``cfg``; when nothing fits, the
    min-memory strategy."""
    scored = score_layouts(cfg, axis_sizes, hbm_bytes=hbm_bytes)
    feasible = {s: v for s, v in scored.items() if v["feasible"]}
    if feasible:
        return min(feasible, key=lambda s: feasible[s]["score"])
    return min(scored, key=lambda s: scored[s]["mem_bytes_per_device"])
