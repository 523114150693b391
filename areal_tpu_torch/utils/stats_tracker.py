"""Denominator-conditioned statistics tracker (a copy of
`areal_tpu/utils/stats_tracker.py`, same names and semantics).

Hierarchical scopes, bool-mask denominators, AVG/SUM/MIN/MAX/AVG_MIN_MAX
reductions, `record_timing` wall-clock scopes, and an `export()` that takes
an optional `reduce_fn(dict) -> dict` for a cross-process reduction. Values
are numpy arrays or anything `np.asarray` accepts (host tensors included).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from enum import Enum, auto
from threading import Lock

import numpy as np


class ReduceType(Enum):
    AVG_MIN_MAX = auto()
    AVG = auto()
    SUM = auto()
    MIN = auto()
    MAX = auto()
    SCALAR = auto()


def _to_numpy(x) -> np.ndarray:
    return np.asarray(x)


class DistributedStatsTracker:
    def __init__(self, name: str = ""):
        self.lock = Lock()
        self.scope_stack: list[str] = []
        if name:
            self.scope_stack.append(name.strip("/"))
        self.denominators: dict[str, str] = {}
        self.reduce_types: dict[str, ReduceType] = {}
        self.stats: dict[str, list] = defaultdict(list)
        # Per-stat snapshot of the denominator array current at stat() time,
        # so numerators always pair with the mask they were recorded under.
        self._denom_snapshots: dict[str, list] = defaultdict(list)

    # -- scoping --------------------------------------------------------
    def scope(self, name: str):
        return self.Scope(self, name)

    class Scope:
        def __init__(self, tracker, name):
            self.tracker = tracker
            self.name = name.strip("/")

        def __enter__(self):
            self.tracker.scope_stack.append(self.name)
            return self

        def __exit__(self, exc_type, exc_val, exc_tb):
            self.tracker.scope_stack.pop()

    def _full_key(self, key: str) -> str:
        if not self.scope_stack:
            return key
        return "/".join(self.scope_stack + [key])

    @contextmanager
    def disable_scope(self):
        tmp, self.scope_stack = self.scope_stack, []
        try:
            yield
        finally:
            self.scope_stack = tmp

    # -- recording ------------------------------------------------------
    @contextmanager
    def record_timing(self, key: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            with self.lock:
                full_key = f"timeperf/{key}"
                self._set_reduce_type(full_key, ReduceType.SCALAR)
                self.stats[full_key].append(time.perf_counter() - start)

    def denominator(self, **kwargs):
        with self.lock:
            for key, value in kwargs.items():
                arr = _to_numpy(value)
                if arr.dtype != np.bool_:
                    raise ValueError(f"`{key}` must be a bool array, got {arr.dtype}")
                if arr.size == 0:
                    raise ValueError(f"`{key}` must be non-empty")
                full_key = self._full_key(key)
                self._set_reduce_type(full_key, ReduceType.SUM)
                self.stats[full_key].append(arr)

    def scalar(self, **kwargs):
        with self.lock:
            for key, value in kwargs.items():
                full_key = self._full_key(key)
                self._set_reduce_type(full_key, ReduceType.SCALAR)
                self.stats[full_key].append(float(value))

    def stat(
        self,
        denominator: str,
        reduce_type: ReduceType | None = None,
        **kwargs,
    ):
        with self.lock:
            for key, value in kwargs.items():
                arr = _to_numpy(value).astype(np.float32)
                if arr.size == 0:
                    raise ValueError(f"`{key}` should be non-empty")
                if reduce_type == ReduceType.SCALAR:
                    raise ValueError("cannot use SCALAR reduce type for an array")
                full_key = self._full_key(key)
                denom_key = self._full_key(denominator)
                if denom_key not in self.stats:
                    raise ValueError(
                        f"denominator `{denom_key}` does not exist; record it first"
                    )
                denom = self.stats[denom_key][-1]
                if denom.shape != arr.shape:
                    raise ValueError(
                        f"shape mismatch between `{full_key}` {arr.shape} and "
                        f"denominator `{denom_key}` {denom.shape}"
                    )
                self.denominators[full_key] = denom_key
                if reduce_type is not None:
                    self._set_reduce_type(full_key, reduce_type)
                elif full_key not in self.reduce_types:
                    self._set_reduce_type(full_key, ReduceType.AVG_MIN_MAX)
                self.stats[full_key].append(arr)
                self._denom_snapshots[full_key].append(denom)

    def _set_reduce_type(self, key: str, reduce_type: ReduceType):
        if not isinstance(reduce_type, ReduceType):
            raise ValueError("reduce type must be a ReduceType enum")
        self.reduce_types[key] = reduce_type

    # -- export ---------------------------------------------------------
    def export(self, key=None, reduce_fn=None, reset=True) -> dict[str, float]:
        """Aggregate recorded stats into a flat {key: float} dict.

        `reduce_fn` (optional) receives the aggregated dict and may perform a
        cross-host reduction, returning the reduced dict.
        """
        with self.lock:
            if key is not None:
                keys = [k for k in self.stats if k == key or k.startswith(key + "/")]
            else:
                keys = list(self.stats.keys())
            result: dict[str, float] = {}
            for k in sorted(keys):
                result.update(self._aggregate(k))
            if reset:
                for k in keys:
                    del self.stats[k]
                    self._denom_snapshots.pop(k, None)
        if reduce_fn is not None:
            result = reduce_fn(result)
        return result

    def _aggregate(self, key: str) -> dict[str, float]:
        values = self.stats[key]
        if not values:
            return {}
        rt = self.reduce_types.get(key, ReduceType.AVG_MIN_MAX)
        if rt == ReduceType.SCALAR:
            return {key: float(np.mean(values))}

        xs = values
        if key in self._denom_snapshots and self._denom_snapshots[key]:
            denoms = [d.astype(np.float32) for d in self._denom_snapshots[key]]
        else:
            denoms = [np.ones_like(v) for v in values]

        total_num = sum(float(d.sum()) for d in denoms)
        out: dict[str, float] = {}
        if rt in (ReduceType.AVG, ReduceType.AVG_MIN_MAX):
            total = sum(float((x * d).sum()) for x, d in zip(xs, denoms))
            out[key if rt == ReduceType.AVG else f"{key}/avg"] = (
                total / total_num if total_num > 0 else 0.0
            )
        if rt in (ReduceType.MIN, ReduceType.AVG_MIN_MAX):
            mins = [
                float(np.where(d > 0, x, np.inf).min())
                for x, d in zip(xs, denoms)
                if d.sum() > 0
            ]
            if mins:
                out[key if rt == ReduceType.MIN else f"{key}/min"] = min(mins)
        if rt in (ReduceType.MAX, ReduceType.AVG_MIN_MAX):
            maxs = [
                float(np.where(d > 0, x, -np.inf).max())
                for x, d in zip(xs, denoms)
                if d.sum() > 0
            ]
            if maxs:
                out[key if rt == ReduceType.MAX else f"{key}/max"] = max(maxs)
        if rt == ReduceType.SUM:
            out[key] = sum(float(x.sum()) for x in xs)
        return out


# -- module-level default tracker (parity: stats_tracker.get/export_all) ----
_trackers: dict[str, DistributedStatsTracker] = {}


def get(name: str = "") -> DistributedStatsTracker:
    if name not in _trackers:
        _trackers[name] = DistributedStatsTracker(name)
    return _trackers[name]


DEFAULT = get()


def scope(name):
    return DEFAULT.scope(name)


def record_timing(key):
    return DEFAULT.record_timing(key)


def denominator(**kwargs):
    return DEFAULT.denominator(**kwargs)


def scalar(**kwargs):
    return DEFAULT.scalar(**kwargs)


def stat(denominator: str, reduce_type: ReduceType | None = None, **kwargs):
    return DEFAULT.stat(denominator, reduce_type, **kwargs)


def export_all(reduce_fn=None, reset=True) -> dict[str, float]:
    return DEFAULT.export(reduce_fn=reduce_fn, reset=reset)
