"""Vectorized aggregation functions for groupby/aggregate.

Counterpart of ``ray_tpu/data/aggregate.py``, unchanged. Reference:
``python/ray/data/aggregate.py`` (AggregateFn protocol:
init/accumulate/merge/finalize, with Count/Sum/Min/Max/Mean/Std
built-ins) and ``grouped_data.py``. The protocol here is columnar and
segment-vectorized instead of row-accumulated: an aggregate maps a
whole block to fixed-width per-group STATE columns (via unsorted
segment ops like ``np.add.at``), states merge by re-grouping, and
finalize converts state to the result column — no Python-per-row work,
the same shape as a ``segment_sum``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

Block = Dict[str, np.ndarray]


def _seg_sum(values: np.ndarray, gid: np.ndarray, n: int) -> np.ndarray:
    # integer columns accumulate in int64 (casting through float64
    # would silently round sums beyond 2^53); floats in float64
    kind = values.dtype.kind
    acc = (np.uint64 if kind == "u" else
           np.int64 if kind in "ib" else
           np.float64 if kind == "f" else values.dtype)
    out = np.zeros(n, dtype=acc)
    np.add.at(out, gid, values)
    return out


class AggregateFn:
    """One aggregation. State columns are namespaced by the engine."""

    name: str = "agg"

    def init_state(self, blk: Block, gid: np.ndarray, n: int
                   ) -> Dict[str, np.ndarray]:
        """Block rows → per-group state columns (each length n)."""
        raise NotImplementedError

    def combine(self, state: Dict[str, np.ndarray], gid: np.ndarray,
                n: int) -> Dict[str, np.ndarray]:
        """Re-group state rows (from concatenated partials) into n
        groups."""
        raise NotImplementedError

    def finalize(self, state: Dict[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError


class Count(AggregateFn):
    def __init__(self):
        self.name = "count()"

    def init_state(self, blk, gid, n):
        return {"c": np.bincount(gid, minlength=n).astype(np.int64)}

    def combine(self, state, gid, n):
        return {"c": _seg_sum(state["c"], gid, n).astype(np.int64)}

    def finalize(self, state):
        return state["c"]


class Sum(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        self.name = f"sum({on})"

    def init_state(self, blk, gid, n):
        return {"s": _seg_sum(np.asarray(blk[self.on]), gid, n)}

    def combine(self, state, gid, n):
        return {"s": _seg_sum(state["s"], gid, n)}

    def finalize(self, state):
        return state["s"]


class Mean(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        self.name = f"mean({on})"

    def init_state(self, blk, gid, n):
        return {"s": _seg_sum(np.asarray(blk[self.on]), gid, n),
                "c": np.bincount(gid, minlength=n).astype(np.int64)}

    def combine(self, state, gid, n):
        return {"s": _seg_sum(state["s"], gid, n),
                "c": _seg_sum(state["c"], gid, n).astype(np.int64)}

    def finalize(self, state):
        return state["s"] / np.maximum(state["c"], 1)


class Std(AggregateFn):
    """Population/sample std via (sum, sumsq, count) moments — exact
    merge under re-grouping (reference ``Std`` uses chunked M2 merge;
    moments are the vectorized equivalent at fp64)."""

    def __init__(self, on: str, ddof: int = 1):
        self.on = on
        self.ddof = ddof
        self.name = f"std({on})"

    def init_state(self, blk, gid, n):
        v = np.asarray(blk[self.on], dtype=np.float64)
        return {"s": _seg_sum(v, gid, n),
                "q": _seg_sum(v * v, gid, n),
                "c": np.bincount(gid, minlength=n).astype(np.int64)}

    def combine(self, state, gid, n):
        return {"s": _seg_sum(state["s"], gid, n),
                "q": _seg_sum(state["q"], gid, n),
                "c": _seg_sum(state["c"], gid, n).astype(np.int64)}

    def finalize(self, state):
        c = state["c"].astype(np.float64)
        mean = state["s"] / np.maximum(c, 1)
        var = (state["q"] / np.maximum(c, 1)) - mean * mean
        denom = c - self.ddof
        # count <= ddof → variance undefined → NaN (numpy/pandas do)
        return np.where(
            denom > 0,
            np.sqrt(np.maximum(var * c / np.maximum(denom, 1), 0.0)),
            np.nan)


class _Extremum(AggregateFn):
    _ufunc: np.ufunc
    _kind: str

    def __init__(self, on: str):
        self.on = on
        self.name = f"{self._kind}({on})"

    def _identity(self, dtype: np.dtype):
        if dtype.kind == "f":
            # +/-inf, not finfo.max/min: a column containing infinities
            # must still reduce to them
            return np.inf if self._kind == "min" else -np.inf
        if dtype.kind in "iu":
            lim = np.iinfo(dtype)
            return lim.max if self._kind == "min" else lim.min
        raise TypeError(
            f"{self._kind}() supports numeric columns, got {dtype}")

    def _reduce(self, values: np.ndarray, gid: np.ndarray, n: int,
                counts: Optional[np.ndarray] = None):
        out = np.full(n, self._identity(values.dtype),
                      dtype=values.dtype)
        self._ufunc.at(out, gid, values)
        return out

    def init_state(self, blk, gid, n):
        v = np.asarray(blk[self.on])
        return {"m": self._reduce(v, gid, n),
                "c": np.bincount(gid, minlength=n).astype(np.int64)}

    def combine(self, state, gid, n):
        # groups absent from a partial carry the identity; their count
        # is 0 so the identity never leaks into a real group's result
        mask = state["c"] > 0
        vals = state["m"][mask]
        g = gid[mask]
        out = np.full(n, self._identity(state["m"].dtype),
                      dtype=state["m"].dtype)
        if len(vals):
            self._ufunc.at(out, g, vals)
        return {"m": out,
                "c": _seg_sum(state["c"], gid, n).astype(np.int64)}

    def finalize(self, state):
        return state["m"]


class Min(_Extremum):
    _ufunc = np.minimum
    _kind = "min"


class Max(_Extremum):
    _ufunc = np.maximum
    _kind = "max"
