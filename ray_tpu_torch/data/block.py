"""Block representation for ray_tpu_torch.data.

Reference: python/ray/data/block.py (Block, BlockAccessor). The JAX
package's block is a pyarrow.Table; this port's block is its own columnar
``Table`` of numpy arrays, so that Data runs where pyarrow and pandas are
not installed:

- one ``Column`` a name, in insertion order;
- a primitive column (ints, floats, bools, datetimes) is one 1-D array of
  its numpy dtype; a tensor column is one ``[rows, *shape]`` array;
- a column of strings, bytes, lists or dicts, or of nulls only, is an
  object array; any column may carry a validity mask where it holds nulls
  (a primitive column's masked slots hold 0, an object column's None).

A dict of numpy arrays crosses the shm store out of band
(core/serialization.py ``dumps_oob``), so a numpy block goes into the store
with no copy into the pickle, as the reference's Arrow IPC did.

Rows and batches come out as Arrow gives them: rows hold Python ``int``,
``float``, ``str`` and ``None``, and a tensor column's row is a flat list;
``to_numpy`` turns an int column with a null into float64 with NaN and a
string column into an object array. Types are inferred from Python values
by Arrow's rules (``[1, 2.5]`` is float64, ``[True]`` bool, ``[1, True]``
an error). pyarrow and pandas are imported only by the functions that need
them (``to_arrow``, ``from_arrow``, ``to_pandas``, the "pyarrow" and
"pandas" batch formats), and each raises ImportError naming the package
when it is absent.
"""

from __future__ import annotations

import importlib
import numbers
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

# logical types of object-valued columns
STRING, BINARY, LIST, STRUCT, NULL, TENSOR = (
    "string", "binary", "list", "struct", "null", "tensor")
_OBJECT_TYPES = (STRING, BINARY, LIST, STRUCT, NULL)


def require(module: str, what: str):
    """Import `module` for `what`, or raise ImportError naming it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        package = module.split(".")[0]
        raise ImportError(
            f"ray_tpu_torch.data: {what} needs {package}, which is not installed "
            "(the numpy block path needs neither pyarrow nor pandas)"
        ) from e


def _py(v):
    """A value as Arrow's to_pylist gives it back: numpy scalars and arrays
    become Python scalars and lists, nested containers recursively."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_py(x) for x in v]
    if isinstance(v, dict):
        return {k: _py(x) for k, x in v.items()}
    return v


def _object_array(values: list) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


class Column:
    """One column of a block: numpy values, an optional validity mask
    (True where a value is present) and a logical type: the numpy dtype's
    name for primitive columns, else one of string, binary, list, struct,
    null, tensor."""

    __slots__ = ("values", "valid", "type")

    def __init__(self, values: np.ndarray, type: str, valid: Optional[np.ndarray] = None):
        if valid is not None and bool(valid.all()):
            valid = None
        self.values = values
        self.type = type
        self.valid = valid

    def __len__(self) -> int:
        return len(self.values)

    @property
    def is_primitive(self) -> bool:
        return self.type not in _OBJECT_TYPES and self.type != TENSOR

    def take(self, idx) -> "Column":
        idx = np.asarray(idx, dtype=np.int64)
        return Column(self.values[idx], self.type,
                      None if self.valid is None else self.valid[idx])

    def slice(self, start: int, stop: int) -> "Column":
        return Column(self.values[start:stop], self.type,
                      None if self.valid is None else self.valid[start:stop])

    def to_numpy(self) -> np.ndarray:
        """As pyarrow's ``to_numpy(zero_copy_only=False)`` gives it (a
        tensor column as ``[rows, prod(shape)]``, as the reference's
        fixed-size lists flatten)."""
        v = self.values
        if self.type == TENSOR:
            return v.reshape(len(v), -1)
        if self.type == LIST:
            try:
                return np.stack([np.asarray(r) for r in v])
            except ValueError:
                return v
        if self.valid is None or self.type in _OBJECT_TYPES:
            return v
        kind = v.dtype.kind
        if kind in "iu":
            out = v.astype(np.float64)
            out[~self.valid] = np.nan
            return out
        if kind == "f":
            out = v.copy()
            out[~self.valid] = np.nan
            return out
        if kind in "mM":
            out = v.copy()
            out[~self.valid] = np.datetime64("NaT")
            return out
        out = v.astype(object)
        out[~self.valid] = None
        return out

    def to_pylist(self) -> list:
        if self.type == TENSOR:
            return self.values.reshape(len(self.values), -1).tolist()
        if self.type in _OBJECT_TYPES:
            return list(self.values)
        out = self.values.tolist()
        if self.valid is not None:
            for i in np.nonzero(~self.valid)[0]:
                out[i] = None
        return out

    def numpy_dtype(self) -> np.dtype:
        """The dtype ``to_numpy`` gives this column."""
        if self.type == TENSOR or (self.is_primitive and self.valid is None):
            return self.values.dtype
        if self.type == LIST:
            return self.to_numpy().dtype
        if self.is_primitive and self.values.dtype.kind in "iu":
            return np.dtype(np.float64)
        if self.is_primitive and self.values.dtype.kind in "fmM":
            return self.values.dtype
        return np.dtype(object)


def null_column(n: int, like: Column) -> Column:
    """n nulls, typed as `like`."""
    if like.type in _OBJECT_TYPES:
        return Column(_object_array([None] * n), like.type, np.zeros(n, bool))
    if like.type == TENSOR:
        raise TypeError("cannot fill a tensor column with nulls")
    return Column(np.zeros(n, like.values.dtype), like.type, np.zeros(n, bool))


def _infer(values: list) -> Column:
    """A Python list as a column, by pyarrow.array's inference rules."""
    n = len(values)
    valid = np.fromiter((v is not None for v in values), bool, n)
    present = [v for v in values if v is not None]
    if not present:
        return Column(_object_array([None] * n), NULL)
    mask = None if len(present) == n else valid

    def filled(fill):
        return [fill if v is None else v for v in values]

    first = present[0]
    if isinstance(first, np.generic) and all(
            isinstance(v, np.generic) and v.dtype == first.dtype for v in present):
        dt = first.dtype
        if dt.kind in "biufmM":
            zero = np.zeros((), dt)[()]
            return Column(np.array(filled(zero), dtype=dt), dt.name, mask)
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        return Column(np.array(filled(False), dtype=bool), "bool", mask)
    if any(isinstance(v, (bool, np.bool_)) for v in present):
        raise TypeError(f"cannot infer a column type from {values[:8]!r}: bool mixed "
                        "with other values (pyarrow: expected integer, got bool)")
    if all(isinstance(v, numbers.Integral) for v in present):
        return Column(np.array(filled(0), dtype=np.int64), "int64", mask)
    if all(isinstance(v, numbers.Real) for v in present):
        return Column(np.array(filled(0.0), dtype=np.float64), "float64", mask)
    if all(isinstance(v, str) for v in present):
        return Column(_object_array(values), STRING, mask)
    if all(isinstance(v, bytes) for v in present):
        return Column(_object_array(values), BINARY, mask)
    if all(isinstance(v, (list, tuple, np.ndarray)) for v in present):
        return Column(_object_array([_py(v) for v in values]), LIST, mask)
    if all(isinstance(v, dict) for v in present):
        return Column(_object_array([_py(v) for v in values]), STRUCT, mask)
    raise TypeError(f"cannot infer one column type from {values[:8]!r}")


def column_from_numpy(arr: np.ndarray) -> Column:
    """A numpy array as a column (pyarrow.array(arr), or a fixed-size list
    column for arr.ndim > 1): no copy of a numeric array."""
    arr = np.asarray(arr)
    if arr.ndim == 0:
        raise TypeError("a column needs a 1-D or higher array, got a scalar")
    if arr.ndim > 1:
        if arr.dtype.kind not in "biufc":
            raise TypeError(f"tensor column of dtype {arr.dtype} is not supported")
        return Column(arr, TENSOR)
    kind = arr.dtype.kind
    if kind in "biufmM":
        return Column(arr, arr.dtype.name)
    if kind == "U":
        return Column(_object_array(arr.tolist()), STRING)
    if kind == "S":
        return Column(_object_array(arr.tolist()), BINARY)
    return _infer(list(arr))


def column_from_values(values) -> Column:
    """A user's column: a list (tensor rows if the first value is an
    ndarray) or anything numpy takes."""
    if isinstance(values, Column):
        return values
    if isinstance(values, list):
        if values and isinstance(values[0], np.ndarray):
            return Column(np.stack(values), TENSOR)
        return _infer(values)
    return column_from_numpy(values)


class Field:
    """A schema entry: the column's name and the numpy dtype to_numpy
    gives it (pyarrow.Field's .name and .type)."""

    __slots__ = ("name", "type", "logical_type")

    def __init__(self, name: str, type: np.dtype, logical_type: str):
        self.name = name
        self.type = type
        self.logical_type = logical_type

    def __repr__(self):
        return f"{self.name}: {self.type} ({self.logical_type})"


class Schema:
    """A block's fields in column order; iterates as Fields."""

    def __init__(self, fields: List[Field]):
        self.fields = list(fields)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)

    def __repr__(self):
        return "\n".join(map(repr, self.fields))


class Table:
    """A block: named columns of equal length (the subset of
    pyarrow.Table's interface the Data operators use)."""

    def __init__(self, columns: Optional[Dict[str, Column]] = None):
        self._cols: Dict[str, Column] = dict(columns or {})
        lens = {len(c) for c in self._cols.values()}
        if len(lens) > 1:
            raise ValueError(f"columns of unequal length: {sorted(lens)}")
        self._n = lens.pop() if lens else 0

    @property
    def num_rows(self) -> int:
        return self._n

    @property
    def num_columns(self) -> int:
        return len(self._cols)

    @property
    def column_names(self) -> List[str]:
        return list(self._cols)

    @property
    def nbytes(self) -> int:
        total = 0
        for c in self._cols.values():
            total += c.values.nbytes + (0 if c.valid is None else c.valid.nbytes)
        return total

    @property
    def schema(self) -> Schema:
        return Schema([Field(k, c.numpy_dtype(), c.type) for k, c in self._cols.items()])

    def __len__(self) -> int:
        return self._n

    def __repr__(self):
        return f"Table({self._n} rows; {', '.join(f'{k}: {c.type}' for k, c in self._cols.items())})"

    def column(self, name: str) -> Column:
        return self._cols[name]

    def columns(self) -> Dict[str, Column]:
        return dict(self._cols)

    def slice(self, offset: int, length: Optional[int] = None) -> "Table":
        stop = self._n if length is None else min(self._n, offset + length)
        return Table({k: c.slice(offset, stop) for k, c in self._cols.items()})

    def take(self, indices) -> "Table":
        return Table({k: c.take(indices) for k, c in self._cols.items()})

    def filter(self, mask) -> "Table":
        mask = np.asarray(mask, dtype=bool)
        if len(mask) != self._n:
            raise ValueError(f"filter mask of {len(mask)} for {self._n} rows")
        return self.take(np.nonzero(mask)[0])

    def append_column(self, name: str, column) -> "Table":
        if name in self._cols:
            raise ValueError(f"column {name!r} exists")
        col = column_from_values(column)
        if self._cols and len(col) != self._n:
            raise ValueError(f"column {name!r} has {len(col)} rows, the table {self._n}")
        cols = dict(self._cols)
        cols[name] = col
        return Table(cols)

    def drop_columns(self, names) -> "Table":
        names = [names] if isinstance(names, str) else list(names)
        missing = [n for n in names if n not in self._cols]
        if missing:
            raise KeyError(f"columns {missing} not in the table")
        return Table({k: c for k, c in self._cols.items() if k not in names})

    def select(self, names) -> "Table":
        return Table({k: self._cols[k] for k in names})

    def to_pylist(self) -> List[dict]:
        cols = {k: c.to_pylist() for k, c in self._cols.items()}
        return [{k: v[i] for k, v in cols.items()} for i in range(self._n)]


# ---------------------------------------------------------------- builders


def _normalize_rows(rows: List[Any]) -> Table:
    """Items -> table. Non-dict items land in the reference's magic
    'item' column (python/ray/data/_internal/util.py)."""
    if rows and isinstance(rows[0], dict):
        if not all(isinstance(r, dict) for r in rows):
            raise TypeError("cannot mix dict and non-dict items in one block")
        # column set = union across ALL rows (missing values become null)
        keys: List[str] = []
        seen = set()
        for r in rows:
            for k in r:
                if k not in seen:
                    seen.add(k)
                    keys.append(k)
        return Table({k: column_from_values([r.get(k) for r in rows]) for k in keys})
    return Table({"item": column_from_values(list(rows))})


def block_from_rows(rows: List[Any]) -> Table:
    if not rows:
        return Table()
    return _normalize_rows(rows)


def _is_instance_of(obj, module: str, name: str) -> bool:
    """isinstance(obj, module.name) without importing module."""
    return any(c.__name__ == name and c.__module__.split(".")[0] == module
               for c in type(obj).__mro__)


def block_from_batch(batch: Any) -> Table:
    """A user batch (dict of numpy arrays / pandas DataFrame / pyarrow Table /
    list of rows) -> block."""
    if isinstance(batch, Table):
        return batch
    if isinstance(batch, dict):
        return Table({k: column_from_values(v) for k, v in batch.items()})
    if _is_instance_of(batch, "pandas", "DataFrame"):
        return from_pandas_frame(batch)
    if _is_instance_of(batch, "pyarrow", "Table"):
        return from_arrow_table(batch)
    if isinstance(batch, list):
        return block_from_rows(batch)
    raise TypeError(f"unsupported batch type: {type(batch)}")


# ---------------------------------------------------- pyarrow and pandas


def to_arrow_table(t: Table):
    pa = require("pyarrow", "to_arrow")
    arrays = {}
    for name, c in t.columns().items():
        if c.type == TENSOR:
            width = int(np.prod(c.values.shape[1:]))
            arrays[name] = pa.FixedSizeListArray.from_arrays(
                pa.array(np.ascontiguousarray(c.values).reshape(-1)), width)
        elif c.type == NULL:
            arrays[name] = pa.nulls(len(c))
        elif c.type == STRING:
            arrays[name] = pa.array(list(c.values), type=pa.string())
        elif c.type == BINARY:
            arrays[name] = pa.array(list(c.values), type=pa.binary())
        elif c.type in (LIST, STRUCT):
            arrays[name] = pa.array(list(c.values))
        else:
            arrays[name] = pa.array(c.values, mask=None if c.valid is None else ~c.valid)
    return pa.table(arrays)


def from_arrow_table(table) -> Table:
    pa = require("pyarrow", "from_arrow")
    cols = {}
    for name in table.column_names:
        col = table.column(name).combine_chunks()
        typ = col.type
        n = len(col)
        if pa.types.is_fixed_size_list(typ):
            flat = col.flatten().to_numpy(zero_copy_only=False)
            cols[name] = Column(flat.reshape(n, -1), TENSOR)
        elif pa.types.is_null(typ):
            cols[name] = Column(_object_array([None] * n), NULL)
        elif (pa.types.is_integer(typ) or pa.types.is_floating(typ)
              or pa.types.is_boolean(typ) or pa.types.is_temporal(typ)):
            if col.null_count:
                valid = col.is_valid().to_numpy(zero_copy_only=False)
                zero = False if pa.types.is_boolean(typ) else 0
                if pa.types.is_temporal(typ):
                    values = col.to_numpy(zero_copy_only=False)
                else:
                    values = col.fill_null(zero).to_numpy(zero_copy_only=False)
                cols[name] = Column(np.array(values), values.dtype.name, valid)
            else:
                values = np.array(col.to_numpy(zero_copy_only=False))
                cols[name] = Column(values, values.dtype.name)
        else:
            values = col.to_pylist()
            if pa.types.is_string(typ) or pa.types.is_large_string(typ):
                kind = STRING
            elif pa.types.is_binary(typ) or pa.types.is_large_binary(typ):
                kind = BINARY
            elif pa.types.is_list(typ) or pa.types.is_large_list(typ):
                kind = LIST
            elif pa.types.is_struct(typ):
                kind = STRUCT
            else:
                cols[name] = _infer(values)
                continue
            valid = np.fromiter((v is not None for v in values), bool, n)
            cols[name] = Column(_object_array(values), kind, valid)
    return Table(cols)


def to_pandas_frame(t: Table):
    pd = require("pandas", "to_pandas")
    data = {}
    for name, c in t.columns().items():
        if c.type == TENSOR:
            data[name] = _object_array(list(c.values.reshape(len(c), -1)))
        else:
            data[name] = c.to_numpy()
    return pd.DataFrame(data, columns=t.column_names)


def from_pandas_frame(df) -> Table:
    """A DataFrame as a block, as pyarrow.Table.from_pandas(df,
    preserve_index=False) reads it: NaN of a float column is a null."""
    pd = require("pandas", "from_pandas")
    cols = {}
    for name in df.columns:
        s = df[name]
        dt = s.dtype
        if isinstance(dt, np.dtype) and dt.kind == "f":
            values = s.to_numpy()
            nan = np.isnan(values)
            cols[str(name)] = Column(np.where(nan, 0.0, values).astype(dt), dt.name,
                                     ~nan if nan.any() else None)
        elif isinstance(dt, np.dtype) and dt.kind in "biumM":
            values = s.to_numpy()
            cols[str(name)] = Column(values, values.dtype.name)
        else:
            values = [None if (v is None or v is pd.NA or v is pd.NaT
                               or (isinstance(v, float) and np.isnan(v))) else v
                      for v in s.tolist()]
            cols[str(name)] = column_from_values(values)
    return Table(cols)


# ---------------------------------------------------------------- accessor


class BlockAccessor:
    """Uniform view over a block (reference: BlockAccessor.for_block)."""

    def __init__(self, block: Table):
        self._t = block

    @staticmethod
    def for_block(block: Table) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        return self._t.num_rows

    def size_bytes(self) -> int:
        return self._t.nbytes

    def schema(self) -> Schema:
        return self._t.schema

    def to_arrow(self):
        return to_arrow_table(self._t)

    def to_pandas(self):
        return to_pandas_frame(self._t)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {name: c.to_numpy() for name, c in self._t.columns().items()}

    def to_batch(self, batch_format: Optional[str]):
        if batch_format in (None, "default", "numpy"):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format == "pyarrow":
            return self.to_arrow()
        raise ValueError(f"unknown batch_format: {batch_format}")

    def iter_rows(self) -> Iterator[dict]:
        cols = self._t.column_names
        if cols == ["item"]:
            yield from self._t.column("item").to_pylist()
            return
        yield from self._t.to_pylist()

    def slice(self, start: int, end: int) -> Table:
        return self._t.slice(start, end - start)


def sort_indices(col: Column, order: str = "ascending") -> np.ndarray:
    """pyarrow.compute.sort_indices over one column: stable, so ties keep
    their input order in either direction; NaN after every value and
    nulls after NaN, in both directions. Descending order sorts the
    negated ranks of the values, never a reversed ascending order."""
    if order not in ("ascending", "descending"):
        raise ValueError(f"unknown sort order {order!r}")
    if col.type == TENSOR or col.type in (LIST, STRUCT):
        raise TypeError(f"cannot sort by a {col.type} column")
    n = len(col)
    valid = np.zeros(n, bool) if col.type == NULL else (
        np.ones(n, bool) if col.valid is None else col.valid)
    nan = np.zeros(n, bool)
    if col.is_primitive and col.values.dtype.kind == "f":
        nan = valid & np.isnan(col.values)
    elif col.is_primitive and col.values.dtype.kind in "mM":
        nan = valid & np.isnat(col.values)
    normal = np.nonzero(valid & ~nan)[0]
    # strings compare as Python compares them: code point order, which is
    # UTF-8 byte order, Arrow's
    _, ranks = np.unique(col.values[normal], return_inverse=True)
    ranks = ranks.reshape(-1).astype(np.int64)
    key = ranks if order == "ascending" else -ranks
    return np.concatenate([normal[np.argsort(key, kind="stable")],
                           np.nonzero(nan)[0], np.nonzero(~valid)[0]]).astype(np.int64)


def _concat_columns(name: str, cols: List[Column]) -> Column:
    typed = [c for c in cols if c.type != NULL]
    if not typed:
        return Column(_object_array([None] * sum(map(len, cols))), NULL)
    like = typed[0]
    for c in typed[1:]:
        same = c.type == like.type and (
            like.type != TENSOR or (c.values.shape[1:] == like.values.shape[1:]
                                    and c.values.dtype == like.values.dtype))
        if not same:
            raise TypeError(f"unable to merge column {name!r}: incompatible types "
                            f"{like.type} vs {c.type}")
    parts = [null_column(len(c), like) if c.type == NULL else c for c in cols]
    values = np.concatenate([c.values for c in parts])
    if all(c.valid is None for c in parts):
        return Column(values, like.type)
    valid = np.concatenate([np.ones(len(c), bool) if c.valid is None else c.valid
                            for c in parts])
    return Column(values, like.type, valid)


def concat_blocks(blocks: List[Table]) -> Table:
    """pyarrow.concat_tables(promote_options="default"): the union of the
    columns, a missing column as nulls, types otherwise equal."""
    blocks = [b for b in blocks if b.num_rows > 0]
    if not blocks:
        return Table()
    if len(blocks) == 1:
        return blocks[0]
    names: List[str] = []
    for b in blocks:
        names.extend(k for k in b.column_names if k not in names)
    cols = {}
    for name in names:
        parts = [b.column(name) if name in b.column_names else
                 Column(_object_array([None] * b.num_rows), NULL) for b in blocks]
        cols[name] = _concat_columns(name, parts)
    return Table(cols)
