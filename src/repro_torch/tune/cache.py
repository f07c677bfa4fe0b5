"""The persistent tuning cache (port of ``repro/tune/cache.py``):
measured tile and attention block winners, keyed exactly like the plan
cache (spec key + shape) plus the device mode they were measured on.

One schema-versioned JSON file maps

    "<GemmSpec.key>|<m>x<k>x<n>|<mode>"  ->  winner entry
    "<AttnSpec.key>|<shape tuple>|<mode>"  ->  winner entry (attn|...)

where ``mode`` is the device the search measured on: ``"cpu"`` or
``"cuda:" + torch.cuda.get_device_name()`` (:func:`device_mode`) — a CPU
winner must never serve a card, nor an H100 winner another card.
Entries carry the winner tile, its measured median + spread, the
analytic rank-0 candidate it displaced, and every per-candidate sample
(modeled bytes/flops vs measured time) so
:mod:`repro_torch.tune.calibrate` can fit the cost-model constants
without re-measuring anything.

Failure policy — the cache must never take ``plan()`` down with it: a
missing file is an empty cache, a corrupt or stale-schema file warns and
starts empty (it is overwritten wholesale on the next save), and saves
go through an atomic tempfile replace.  Counters (hits / misses /
measurements / load errors) make cache behavior assertable: a second
process over the same file must show hits with **zero** measurements.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from typing import Dict, NamedTuple, Optional

import torch

#: bump when the entry layout changes shape — older files are discarded
#: with a warning, never half-parsed
SCHEMA_VERSION = 1

#: default on-disk location; override with REPRO_TUNE_CACHE
DEFAULT_PATH = os.path.join("artifacts", "tune_cache.json")


def cache_path() -> str:
    return os.environ.get("REPRO_TUNE_CACHE", DEFAULT_PATH)


def device_mode(device) -> str:
    """The mode a measurement on ``device`` is keyed under: ``"cpu"``,
    or ``"cuda:"`` and the card's name."""
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(device)
    return device.type


def cache_key(spec, shapes, mode: str) -> str:
    """The persistent join key: the plan cache's (spec, m, k, n) key
    serialized through ``GemmSpec.key`` (canonical, process-stable)
    plus the device mode."""
    m, k, n = (int(x) for x in shapes)
    return f"{spec.key}|{m}x{k}x{n}|{mode}"


def attn_cache_key(spec, shapes, mode: str) -> str:
    """The attention join key — ``AttnSpec.key`` already starts with
    ``attn|``, so attention winners live in their own namespace next to
    the GEMM entries in the same file (shape tuples are per-mode, see
    :func:`repro_torch.kernels.attn_api._shape_fields`)."""
    dims = "x".join(str(int(x)) for x in shapes)
    return f"{spec.key}|{dims}|{mode}"


class TuningCacheInfo(NamedTuple):
    entries: int
    hits: int
    misses: int
    measurements: int
    load_errors: int


class TuningCache:
    """One JSON file of measured winners, lazily loaded, with counted
    access so tests and benchmarks can assert re-measurement never
    happens once a winner is persisted."""

    def __init__(self, path: str):
        self.path = path
        self._entries: Optional[Dict[str, dict]] = None
        self.hits = 0
        self.misses = 0
        self.measurements = 0
        self.load_errors = 0

    # ------------------------------------------------------------- load/save

    def _load(self) -> Dict[str, dict]:
        if self._entries is not None:
            return self._entries
        self._entries = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    payload = json.load(f)
                if not isinstance(payload, dict):
                    raise ValueError("top level is not an object")
                schema = payload.get("schema")
                if schema != SCHEMA_VERSION:
                    raise ValueError(
                        f"schema {schema!r} != {SCHEMA_VERSION} (stale)")
                entries = payload.get("entries")
                if not isinstance(entries, dict):
                    raise ValueError("'entries' is not an object")
                self._entries = entries
            except (OSError, ValueError, json.JSONDecodeError) as e:
                self.load_errors += 1
                warnings.warn(
                    f"tuning cache {self.path!r} unreadable ({e}); "
                    "falling back to analytic plans — the file will be "
                    "rewritten on the next autotune save", stacklevel=3)
                self._entries = {}
        return self._entries

    def save(self) -> None:
        entries = self._load()
        payload = {"schema": SCHEMA_VERSION, "entries": entries}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # ------------------------------------------------------------- access

    def get(self, key: str) -> Optional[dict]:
        ent = self._load().get(key)
        if ent is None:
            self.misses += 1
        else:
            self.hits += 1
        return ent

    def put(self, key: str, entry: dict, *, save: bool = True) -> None:
        entry = dict(entry)
        entry.setdefault("created", time.time())
        self._load()[key] = entry
        self.measurements += 1
        if save:
            self.save()

    def entries(self) -> Dict[str, dict]:
        return dict(self._load())

    def info(self) -> TuningCacheInfo:
        # deliberately does NOT force a load: telemetry snapshots call
        # this and must stay free of disk I/O when tuning is unused
        n = len(self._entries) if self._entries is not None else 0
        return TuningCacheInfo(n, self.hits, self.misses,
                               self.measurements, self.load_errors)


# one live instance per resolved path, so every consumer in a process
# shares counters and an in-memory view of the same file
_caches: Dict[str, TuningCache] = {}


def tuning_cache(path: Optional[str] = None) -> TuningCache:
    p = path or cache_path()
    cache = _caches.get(p)
    if cache is None:
        cache = _caches.setdefault(p, TuningCache(p))
    return cache


def tuning_cache_info() -> TuningCacheInfo:
    """Counters of the *current-path* cache (the one ``plan()`` uses)."""
    return tuning_cache().info()


def tuning_cache_reset() -> None:
    """Drop every live in-memory cache instance (files are untouched) —
    the next access re-reads from disk with fresh counters.  Tests use
    this to simulate a second process over the same file."""
    _caches.clear()
