"""Per-cell (arch x shape) dry-run problems on the meta device (port of
``repro/launch/specs.py``).

For each of the 40 assigned cells this builds what one rank of a mesh
runs — the train step for train shapes, ``prefill`` / ``decode_step`` for
inference shapes — and that rank's inputs, as meta tensors only: the
FULL configs are only ever touched this way.  The JAX package lowers the
whole SPMD program; the port runs eagerly, one process a rank, so a cell
is one rank's step, traced by running it on meta tensors under
:mod:`repro_torch.core.op_cost` (:mod:`repro_torch.launch.dryrun`).

* **train** (:func:`_train_problem`): the consuming
  ``make_train_step(cfg, n_loss_chunks=32, consume=True)`` (the
  reference lowers its step with ``donate_argnums=(0,)``) on the mesh
  over this rank's blocks of ``state_struct(cfg)`` under
  ``runtime.elastic.state_specs`` and this rank's rows of
  ``data.pipeline.batch_spec``: the state's blocks are written in place,
  so ``memory_analysis`` counts them as aliased.  The step gathers every
  leaf whole at its start but the expert banks (``ROADMAP.md`` A11,
  "per-layer FSDP gathering"), which the peak shows.
* **prefill / decode** (:func:`_prefill_problem`,
  :func:`_decode_problem`): the parameters held as this rank's blocks
  under the same layout and gathered whole as the step starts (the train
  step's rule; the port has no tensor-parallel compute), then the port's
  ``prefill`` / ``decode_step`` under ``inference_mode`` on this rank's
  rows over a dense cache of the shape's length (its sequence dim is not
  split: the port's attention runs on a rank's whole cache).

The layout is :func:`repro_torch.dist.layout.choose_layout`'s for the
mesh.  The mesh is a :class:`~repro_torch.dist.sharding.DryMesh` seen
from rank 0: its collectives move nothing and only shape-propagate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.bridge import zip_trees
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import op_cost
from repro_torch.data import pipeline
from repro_torch.dist import layout, sharding as shd
from repro_torch.launch.shapes import SHAPES, ShapeSpec, skip_reason
from repro_torch.models import transformer as T
from repro_torch.runtime import elastic
from repro_torch.train import train_step as TS

DRYRUN_LOSS_CHUNKS = 32     # (b, s/32, V) fp32 logits per xent chunk


@dataclasses.dataclass
class CellProblem:
    """Everything the dry-run needs to trace one cell on one rank."""

    arch: str
    shape: str
    kind: str                       # train | prefill | decode
    fn: Callable
    args: Tuple[Any, ...]           # this rank's meta tensors
    tokens: int                     # tokens processed per step (global)
    training: bool
    layout_name: str
    rows: int                       # this rank's batch rows


def _block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A fresh meta tensor of this rank's block of ``t`` under ``spec``
    (a storage of its own, so the peak counts the block, not ``t``)."""
    shape = shd.narrow(t, spec, shd.axis_sizes(mesh), mesh.coord).shape
    return torch.empty(shape, dtype=t.dtype, device="meta")


def _rank_rows(rows: int, mesh) -> int:
    axes = layout._data_axes(mesh, rows)
    sizes = shd.axis_sizes(mesh)
    split = math.prod(sizes[a] for a in
                      (axes if isinstance(axes, tuple) else (axes,)) if a)
    return rows // split


def _sharded_params(cfg: ModelConfig, mesh, layout_name: str):
    """(this rank's blocks of the parameters, what a call gathers back:
    every split but an expert bank's on ``model``)."""
    whole = TS.state_struct(cfg).params
    specs = layout.param_specs(whole, cfg, mesh, layout_name)
    drop = layout.dropped_specs(specs, layout.compute_specs(specs))
    return zip_trees(lambda t, s: _block(t, s, mesh), whole, specs), drop


def _train_problem(cfg: ModelConfig, shape: ShapeSpec, mesh,
                   layout_name: str) -> CellProblem:
    whole = TS.state_struct(cfg)
    specs = elastic.state_specs(whole, cfg, mesh, layout_name)
    state = zip_trees(lambda t, s: _block(t, s, mesh), whole, specs)
    rows = _rank_rows(shape.global_batch, mesh)
    batch = pipeline.batch_spec(cfg, pipeline.DataConfig(
        seq_len=shape.seq_len, global_batch=shape.global_batch, rows=rows))
    step = TS.make_train_step(cfg, n_loss_chunks=DRYRUN_LOSS_CHUNKS,
                              mesh=mesh, specs=specs, consume=True)
    return CellProblem(
        arch=cfg.name, shape=shape.name, kind="train", fn=step,
        args=(state, batch), tokens=shape.global_batch * shape.seq_len,
        training=True, layout_name=layout_name, rows=rows)


def _serve_fn(cfg: ModelConfig, mesh, drop, body: Callable) -> Callable:
    """``body(params, *args)`` after gathering the parameters whole, on
    the mesh, under ``inference_mode`` (how the port serves)."""
    def fn(params, *args):
        with torch.inference_mode(), shd.use_mesh(mesh):
            return body(layout.gather_tree(params, drop, mesh), *args)
    return fn


def _prefill_problem(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     layout_name: str) -> CellProblem:
    rows = _rank_rows(shape.global_batch, mesh)
    batch = pipeline.batch_spec(cfg, pipeline.DataConfig(
        seq_len=shape.seq_len, global_batch=shape.global_batch, rows=rows))
    batch.pop("labels")
    cache = T.init_cache(cfg, rows, shape.seq_len, device="meta")
    params, drop = _sharded_params(cfg, mesh, layout_name)

    def body(params, batch, cache):
        return T.prefill(params, cfg, batch["tokens"], cache,
                         prefix_embeds=batch.get("prefix_embeds"),
                         frames=batch.get("frames"))

    return CellProblem(
        arch=cfg.name, shape=shape.name, kind="prefill",
        fn=_serve_fn(cfg, mesh, drop, body), args=(params, batch, cache),
        tokens=shape.global_batch * shape.seq_len, training=False,
        layout_name=layout_name, rows=rows)


def _decode_problem(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    layout_name: str) -> CellProblem:
    rows = _rank_rows(shape.global_batch, mesh)
    cache = T.init_cache(cfg, rows, shape.seq_len, device="meta")
    params, drop = _sharded_params(cfg, mesh, layout_name)
    tok = torch.empty((rows, 1), dtype=torch.int32, device="meta")

    def body(params, tok, cache):
        return T.decode_step(params, cfg, tok, cache)

    return CellProblem(
        arch=cfg.name, shape=shape.name, kind="decode",
        fn=_serve_fn(cfg, mesh, drop, body), args=(params, tok, cache),
        tokens=shape.global_batch, training=False, layout_name=layout_name,
        rows=rows)


def build_problem(arch: str, shape_name: str, mesh,
                  layout_name: Optional[str] = None) -> CellProblem:
    """The (arch x shape) cell's problem for rank 0 of ``mesh``.

    Raises ``ValueError`` for cells the task sheet skips (long_500k on
    pure full-attention archs) — callers record the reason instead.
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = skip_reason(cfg, shape)
    if skip is not None:
        raise ValueError(f"cell skipped: {skip}")
    layout_name = layout_name or layout.choose_layout(
        cfg, shd.axis_sizes(mesh))
    make = {"train": _train_problem, "prefill": _prefill_problem,
               "decode": _decode_problem}[shape.kind]
    return make(cfg, shape, mesh, layout_name)


def arg_bytes(p: CellProblem) -> int:
    """Bytes of this rank's inputs (the reference's ``_shard_bytes``:
    the input-side cross-check of the peak)."""
    return op_cost.boundary((), p.args)
