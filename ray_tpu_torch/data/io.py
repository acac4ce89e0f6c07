"""Datasource read/write for ray_tpu_torch.data.

Reference: python/ray/data/read_api.py (range/from_items/read_parquet/...)
and _internal/datasource/ (parquet/csv/json datasources). Reads produce one
remote task per file/shard so IO parallelizes through the scheduler like any
other work; blocks land in the object store. range, from_items and
from_numpy need neither pyarrow nor pandas; parquet, csv and json go
through pyarrow, and from_pandas and write_json through pandas, each
imported where it is used (ImportError naming the package without it).
"""

from __future__ import annotations

import glob
import os
from typing import Any, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Column,
    Table,
    block_from_rows,
    from_arrow_table,
    from_pandas_frame,
    require,
    to_arrow_table,
    to_pandas_frame,
)
from ray_tpu_torch.data.dataset import Dataset

_READERS = {"parquet": ("pyarrow.parquet", "read_table"),
            "csv": ("pyarrow.csv", "read_csv"),
            "json": ("pyarrow.json", "read_json")}


@ray_tpu_torch.remote
def _read_shard(kind: str, path_or_args: Any, kwargs: dict = None) -> Table:
    kwargs = kwargs or {}
    if kind == "range":
        start, stop = path_or_args
        return Table({"id": Column(np.arange(start, stop), "int64")})
    if kind in _READERS:
        module, fn = _READERS[kind]
        read = getattr(require(module, f"read_{kind}"), fn)
        return from_arrow_table(read(path_or_args, **kwargs))
    raise ValueError(kind)


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths}")
    return out


_range = range  # the module-level read API shadows the builtin below


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    if parallelism <= 0:
        parallelism = min(200, max(1, n // 1000)) if n else 1
    cuts = [n * i // parallelism for i in _range(parallelism + 1)]
    refs = [
        _read_shard.remote("range", (cuts[i], cuts[i + 1]))
        for i in _range(parallelism)
    ]
    return Dataset(refs)


def from_items(items: List[Any], *, parallelism: int = 4) -> Dataset:
    n = len(items)
    parallelism = max(1, min(parallelism, n or 1))
    cuts = [n * i // parallelism for i in _range(parallelism + 1)]
    refs = [
        ray_tpu_torch.put(block_from_rows(items[cuts[i]:cuts[i + 1]]))
        for i in _range(parallelism)
    ]
    return Dataset(refs)


def from_numpy(arr: np.ndarray, *, column: str = "data") -> Dataset:
    return from_items([{column: row} for row in arr])


def from_pandas(df) -> Dataset:
    """Needs pandas (raises ImportError naming it without)."""
    return Dataset([ray_tpu_torch.put(from_pandas_frame(df))])


def from_arrow(table) -> Dataset:
    """Needs pyarrow (raises ImportError naming it without)."""
    return Dataset([ray_tpu_torch.put(from_arrow_table(table))])


def read_parquet(paths, **kwargs) -> Dataset:
    """kwargs forward to pyarrow.parquet.read_table (columns=, filters=, ...)."""
    require("pyarrow.parquet", "read_parquet")
    return Dataset(
        [_read_shard.remote("parquet", p, kwargs) for p in _expand_paths(paths)]
    )


def read_csv(paths, **kwargs) -> Dataset:
    """kwargs forward to pyarrow.csv.read_csv (read_options=, ...)."""
    require("pyarrow.csv", "read_csv")
    return Dataset(
        [_read_shard.remote("csv", p, kwargs) for p in _expand_paths(paths)]
    )


def read_json(paths, **kwargs) -> Dataset:
    """kwargs forward to pyarrow.json.read_json."""
    require("pyarrow.json", "read_json")
    return Dataset(
        [_read_shard.remote("json", p, kwargs) for p in _expand_paths(paths)]
    )


def _write_blocks(ds: Dataset, path: str, fmt: str) -> None:
    """parquet and csv through pyarrow, json lines through pandas, as the
    reference writes them; each raises ImportError naming its package
    without it, before any file is written."""
    if fmt == "json":
        require("pandas", "write_json")
    else:
        require(f"pyarrow.{fmt}", f"write_{fmt}")
    os.makedirs(path, exist_ok=True)
    for i, block in enumerate(ds.iter_blocks()):
        if block.num_rows == 0:
            continue
        fp = os.path.join(path, f"part-{i:05d}.{fmt}")
        if fmt == "parquet":
            import pyarrow.parquet as pq

            pq.write_table(to_arrow_table(block), fp)
        elif fmt == "csv":
            from pyarrow import csv as pacsv

            pacsv.write_csv(to_arrow_table(block), fp)
        elif fmt == "json":
            to_pandas_frame(block).to_json(fp, orient="records", lines=True)
