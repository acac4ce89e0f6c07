"""GroupedData: hash-partitioned groupby aggregation.

Reference: python/ray/data/grouped_data.py (GroupedData.count/sum/mean/...,
AggregateFn). Map side hashes the key into n partitions; each reduce task
groups its partition as pyarrow's group_by does (the reference's reduce),
here over the numpy block (``group_aggregate``) — all groups with equal
keys land in the same partition, so per-partition aggregates are exact.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data.block import (
    NULL,
    Column,
    Table,
    concat_blocks,
    to_pandas_frame,
)
from ray_tpu_torch.data.dataset import Dataset, _AllToAllStage


def _det_hash(v) -> int:
    """Deterministic cross-process hash (Python's hash() is salted per
    process — worker subprocesses would partition the same key
    differently)."""
    import zlib

    return zlib.crc32(repr(v).encode())


def _hash_partition(key: str):
    """part_fn for hash exchanges: rows with equal keys land in the same
    partition in every worker process."""

    def part(block, n, _key=key):
        if block.num_rows == 0:
            return [block] * n
        vals = block.column(_key).to_pylist()
        h = np.array([_det_hash(v) % n for v in vals])
        return [block.take(np.nonzero(h == j)[0]) for j in range(n)]

    return part


class AggregateFn:
    """Named aggregate over a column (reference: ray.data.aggregate.AggregateFn
    family — Count/Sum/Min/Max/Mean/Std)."""

    def __init__(self, kind: str, on: Optional[str] = None, alias: Optional[str] = None):
        self.kind = kind
        self.on = on
        self.alias = alias or (f"{kind}({on})" if on else kind)


def Count():
    return AggregateFn("count")


def Sum(on: str):
    return AggregateFn("sum", on)


def Min(on: str):
    return AggregateFn("min", on)


def Max(on: str):
    return AggregateFn("max", on)


def Mean(on: str):
    return AggregateFn("mean", on)


def Std(on: str):
    return AggregateFn("stddev", on)


_PA_AGG = {
    "count": "count",
    "sum": "sum",
    "min": "min",
    "max": "max",
    "mean": "mean",
    "stddev": "stddev",
}


_NAN = object()  # the one group key of every NaN (NaN != NaN)


def _group_ids(col: Column):
    """Each row's group, numbered by its key's first appearance (the order
    pyarrow's group_by emits its groups), with nulls one group and NaNs
    one; returns (ids, the first row of each group)."""
    ids = np.empty(len(col), np.int64)
    seen: dict = {}
    first: List[int] = []
    for i, k in enumerate(col.to_pylist()):
        if isinstance(k, float) and k != k:
            k = _NAN
        elif isinstance(k, list):
            k = repr(k)
        g = seen.get(k)
        if g is None:
            g = seen[k] = len(first)
            first.append(i)
        ids[i] = g
    return ids, first


def _sum_dtype(dt: np.dtype) -> np.dtype:
    if dt.kind == "u" or dt.kind == "b":
        return np.dtype(np.uint64)
    if dt.kind == "i":
        return np.dtype(np.int64)
    return np.dtype(np.float64)


def _aggregate(col: Column, fn: str, ids: np.ndarray, n_groups: int) -> Column:
    """One of pyarrow's hash aggregates over one column: count (non-null
    values), sum (int64 / uint64 / float64), min and max (the column's
    type), mean (float64) and stddev (ddof 0, float64), summed in row
    order; a group with no value gives a null."""
    n = len(col)
    valid = np.zeros(n, bool) if col.type == NULL else (
        np.ones(n, bool) if col.valid is None else col.valid)
    counts = np.bincount(ids[valid], minlength=n_groups).astype(np.int64)
    if fn == "count":
        return Column(counts, "int64")
    if col.type == NULL:
        return Column(np.array([None] * n_groups, dtype=object), NULL)
    if not col.is_primitive and fn not in ("min", "max"):
        raise TypeError(f"cannot {fn} a {col.type} column")
    members = [np.nonzero((ids == g) & valid)[0] for g in range(n_groups)]
    has = counts > 0
    if fn in ("min", "max"):
        pick = min if fn == "min" else max
        if col.is_primitive:
            red = np.fmin.reduce if fn == "min" else np.fmax.reduce
            out = np.zeros(n_groups, col.values.dtype)
            for g, m in enumerate(members):
                if len(m):
                    out[g] = red(col.values[m])
            return Column(out, col.type, has)
        out = np.array([pick(col.values[m]) if len(m) else None for m in members],
                       dtype=object)
        return Column(out, col.type, has)
    vals = col.values
    if fn == "sum":
        dt = _sum_dtype(vals.dtype)
        out = np.zeros(n_groups, dt)
        for g, m in enumerate(members):
            if len(m):  # in row order: a running sum, never a tree
                out[g] = np.cumsum(vals[m].astype(dt))[-1]
        return Column(out, dt.name, has)
    out = np.zeros(n_groups, np.float64)
    for g, m in enumerate(members):
        if not len(m):
            continue
        if vals.dtype.kind in "iub":
            mean = float(int(vals[m].astype(np.int64).sum())) / len(m)
        else:
            mean = float(np.cumsum(vals[m].astype(np.float64))[-1]) / len(m)
        if fn == "mean":
            out[g] = mean
        elif fn == "stddev":
            dev = vals[m].astype(np.float64) - mean
            out[g] = np.sqrt(np.cumsum(dev * dev)[-1] / len(m))
        else:
            raise ValueError(f"unknown aggregate {fn!r}")
    return Column(out, "float64", has)


def group_aggregate(t: Table, key: str, spec) -> Table:
    """pyarrow's ``t.group_by(key).aggregate(...)`` followed by the
    reference's rename: the key column first, its groups in the order
    their keys first appear, then one column an aggregate (col, fn,
    alias) under its alias."""
    kcol = t.column(key)
    ids, first = _group_ids(kcol)
    cols = {key: kcol.take(first)}
    for col, fn, alias in spec:
        cols[alias] = _aggregate(t.column(col), fn, ids, len(first))
    return Table(cols)


class GroupedData:
    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        key = self._key
        n = max(self._ds.num_blocks(), 1)
        agg_spec: List[Tuple[str, str, str]] = []
        for a in aggs:
            col = a.on if a.on else key
            agg_spec.append((col, _PA_AGG[a.kind], a.alias))

        def reduce(blocks, _key=key, _spec=tuple(agg_spec)):
            t = concat_blocks(blocks)
            if t.num_rows == 0:
                return t
            return group_aggregate(t, _key, _spec)

        return self._ds._with_stage(
            _AllToAllStage("groupby", n, _hash_partition(key), reduce)
        )

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on: str) -> Dataset:
        return self.aggregate(Std(on))

    def map_groups(self, fn) -> Dataset:
        """Apply fn(pandas.DataFrame) -> rows/DataFrame per group."""
        key = self._key
        n = max(self._ds.num_blocks(), 1)

        def reduce(blocks, _key=key):
            from ray_tpu_torch.data.block import block_from_batch

            t = concat_blocks(blocks)
            if t.num_rows == 0:
                return t
            df = to_pandas_frame(t)
            outs = []
            for _, group in df.groupby(_key, sort=False):
                out = fn(group)
                outs.append(block_from_batch(out))
            return concat_blocks(outs)

        return self._ds._with_stage(
            _AllToAllStage("map_groups", n, _hash_partition(key), reduce)
        )
