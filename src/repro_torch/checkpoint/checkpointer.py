"""Manifest checkpointing with atomic commits and async saves (port of
``repro/checkpoint/checkpointer.py``, in torch and numpy only).

Layout on disk, the JAX package's own:

    <dir>/step_<N>/manifest.json     keys, shapes, dtypes
    <dir>/step_<N>/arrays.npz        leaf arrays keyed by tree path
    <dir>/step_<N>/COMMITTED         written last -> crash-safe marker

A step is written into a temporary directory and renamed into place, and
only the newest ``keep_last`` committed steps are kept.  The keys are the
reference's ``_flatten`` paths letter for letter: a named-tuple field is
``.field``, a dict key itself, a sequence index its number, joined by
``/`` (``.params/layers/u0/attn/wq``, ``.opt/.mu/lm_head``, ``.step``),
so a checkpoint written by either package restores in the other.  bf16
leaves, which numpy has no dtype for, are stored as their raw bytes and
viewed back through the manifest's dtype.

Async: ``save(..., blocking=False)`` copies the tree to host memory at
once (so the caller may overwrite its tensors) and writes the files on a
background thread; ``wait()`` joins.  The thread writes each array's
buffer whole (:func:`_savez`), so it holds the GIL only for headers
while the caller goes on dispatching steps.

On a mesh of several ranks (``shardings``: the
:class:`~repro_torch.dist.sharding.NamedSharding` tree of the rank's
blocks) every rank takes part in gathering the whole tree, rank 0 alone
writes it, in the same format, and a blocking save ends at a barrier, so
every rank sees the committed step.  ``restore(..., shardings=)`` gives
each rank its block of every leaf under the (possibly other) mesh's
layout, on that mesh's device: the elastic re-mesh
(:mod:`repro_torch.runtime.elastic`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _children(tree):
    """(path entry, child) of a node, in the node's own order, or None
    for a leaf: a dict entry is named by its key, a named-tuple field
    ``.field``, a sequence entry by its index."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) of every leaf, keyed and ordered as the reference's
    ``_flatten`` keys and orders a pytree of the same structure (dict
    keys sorted)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    if isinstance(tree, dict):
        kids = sorted(kids)
    return [kv for name, child in kids
            for kv in _flatten(child, _join(prefix, name))]


def _rebuild(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, every node
    keeping its type and its own order (the port sums leaves in dict
    order, so a restored tree must keep it)."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    new = [_rebuild(child, fn, _join(prefix, name)) for name, child in kids]
    if isinstance(tree, dict):
        return dict(zip(tree, new))
    return type(tree)(*new) if hasattr(tree, "_fields") else type(tree)(new)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``, its own even on the CPU (bf16 as its int16
    bits; the caller stores them as bytes)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).contiguous().numpy()


def _savez(path: str, arrays: dict) -> None:
    """``np.savez(path, **arrays)``'s file (one uncompressed ``.npy``
    entry a key), each array's bytes handed to the zip entry in one
    write: the CRC and the file write release the GIL, where
    ``np.savez`` copies 16 MB chunks while holding it."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            a = np.asarray(a, order="C")        # keeps a 0-d array 0-d
            with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                f.write(memoryview(a.reshape(-1).view(np.uint8)))


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, blocking: bool = True,
             shardings=None) -> None:
        """Write ``tree`` as step ``step``.  With ``shardings`` (a tree
        of the leaves' ``NamedSharding`` on a mesh of several ranks)
        every rank must call this: the whole tree is gathered and rank 0
        writes it."""
        rank = 0
        if shardings is not None:
            from repro_torch.bridge import zip_trees
            from repro_torch.dist import collectives, sharding
            tree = zip_trees(
                lambda t, sh: sharding.gather(t, sh.spec, sh.mesh),
                tree, shardings)
            rank = _flatten(shardings)[0][1].mesh.rank
        if rank == 0:
            # the host copy is made now, whatever the caller does next
            flat = [(k, _to_numpy(v), str(v.dtype).removeprefix("torch."))
                    for k, v in _flatten(tree)]
            treedef = f"repro_torch {type(tree).__name__}"
            self.wait()                 # never two writers at once
            if blocking:
                self._write(step, flat, treedef)
            else:
                self._thread = threading.Thread(
                    target=self._write, args=(step, flat, treedef),
                    daemon=True)
                self._thread.start()
        if shardings is not None and blocking:
            collectives.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat, treedef: str) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = f"{final}.tmp{os.getpid()}_{threading.get_ident()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _savez(os.path.join(tmp, "arrays.npz"),
               {k: (np.atleast_1d(v).view(np.uint8)
                    if dt == "bfloat16" else v)
                for k, v, dt in flat})
        manifest = {
            "step": step,
            "treedef": treedef,
            "leaves": [{"key": k, "shape": list(v.shape), "dtype": dt}
                       for k, v, dt in flat],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if re.fullmatch(r"step_\d{8}", name) \
                    and os.path.exists(os.path.join(full, "COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def keys(self, step: Optional[int] = None) -> List[str]:
        """The leaf keys of a committed step's manifest (default: the
        newest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(os.path.join(self.directory, f"step_{step:08d}",
                               "manifest.json")) as f:
            return [leaf["key"] for leaf in json.load(f)["leaves"]]

    def restore(self, target, step: Optional[int] = None, shardings=None):
        """Restore into the structure of ``target`` (a tree of tensors of
        the whole shapes; the meta device's will do with ``shardings``):
        each leaf comes back with the target leaf's shape and dtype, on
        its device — or, with ``shardings`` (a matching tree of
        :class:`~repro_torch.dist.sharding.NamedSharding`), as this
        rank's block under its spec, on its mesh's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = {leaf["key"]: leaf["dtype"]
                      for leaf in json.load(f)["leaves"]}
        places = {} if shardings is None else dict(_flatten(shardings))
        with np.load(os.path.join(d, "arrays.npz")) as data:
            def leaf(key, tgt):
                arr = data[key]
                if dtypes[key] == "bfloat16":       # bytes -> bf16
                    t = torch.from_numpy(arr.view(np.int16).copy()) \
                        .view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr.copy())
                if t.dtype != tgt.dtype:
                    raise TypeError(f"{key}: the checkpoint holds "
                                    f"{t.dtype}, the target {tgt.dtype}")
                t = t.reshape(tgt.shape)
                return places[key].place(t) if key in places \
                    else t.to(tgt.device)
            return _rebuild(target, leaf)
