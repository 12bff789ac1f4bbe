"""Scalar metric aggregation (the port's copy of what it calls from
``areal_tpu/base/stats_tracker.py``): interfaces record scalar stats per
train step under scoped keys; ``export()`` reduces each key to its mean
and reports the declared cross-worker merge semantics. The masked
per-token stats and MoE aux losses of the reference are not ported."""

from __future__ import annotations

import contextlib
import enum
from typing import Dict, List, Optional

import numpy as np


class ReduceType(enum.Enum):
    AVG = "avg"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    SCALAR = "scalar"


class DistributedStatsTracker:

    def __init__(self, name: str = ""):
        self._scopes: List[str] = [name] if name else []
        self._scalars: Dict[str, List[float]] = {}
        self._scalar_types: Dict[str, ReduceType] = {}

    def _key(self, name: str) -> str:
        return "/".join(self._scopes + [name])

    @contextlib.contextmanager
    def scope(self, name: str):
        self._scopes.append(name)
        try:
            yield
        finally:
            self._scopes.pop()

    def scalar(self, reduce_type: ReduceType = ReduceType.AVG, **kwargs):
        """Record scalar stats. `reduce_type` declares the cross-worker
        merge semantics (within-process records are mean-reduced at
        export)."""
        for name, value in kwargs.items():
            key = self._key(name)
            self._scalars.setdefault(key, []).append(float(value))
            self._scalar_types[key] = reduce_type

    @staticmethod
    def _match(key: Optional[str], k: str) -> bool:
        # Prefix match on full name components only: "train" matches
        # "train/loss" but not "train_eval/acc".
        return key is None or k == key or k.startswith(key.rstrip("/") + "/")

    def export(self, key: Optional[str] = None, reset: bool = True,
               return_types: bool = False):
        """Reduce recorded stats to floats; with `return_types=True` also
        {key: "sum" | "avg" | ...} for a cross-process aggregator."""
        out: Dict[str, float] = {}
        types: Dict[str, str] = {}
        for k, vals in self._scalars.items():
            if not self._match(key, k):
                continue
            out[k] = float(np.mean(vals))
            types[k] = self._scalar_types.get(k, ReduceType.AVG).value
        if reset:
            for k in [k for k in self._scalars if self._match(key, k)]:
                del self._scalars[k]
                self._scalar_types.pop(k, None)
        if return_types:
            return out, types
        return out


# Process-global default tracker, mirroring the reference's module-level API.
DEFAULT_TRACKER = DistributedStatsTracker()

scope = DEFAULT_TRACKER.scope
scalar = DEFAULT_TRACKER.scalar
export = DEFAULT_TRACKER.export
