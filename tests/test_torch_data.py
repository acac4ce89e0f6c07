"""ray_tpu_torch.data held against ray_tpu.data on the CPU.

- A counterpart of each of tests/test_data.py's 39 cases: the same seeded
  inputs go through both packages (each in a fresh local runtime), and the
  rows, batches and block shapes come out equal, with the same Python and
  numpy types: in order where the reference defines one, as multisets
  where it does not (the multiset cases sort both sides).
- The hazards of the numpy block (data/block.py), each against the
  reference: Arrow's type inference and its rows and batches (nulls,
  strings, tensors, NaN), _det_hash's partitions on Python values, the
  stable sort with nulls and NaN last and descending ties in input order,
  string order, the aggregates' group order, names, ddof and types, the
  shuffle's permutation and split's row counts.

The port's block is its own numpy table; pyarrow and pandas are needed
only by the cases that read or write files or take pandas batches, as in
the reference.
"""

import math
import os

import numpy as np
import pytest
import pyarrow as pa

import ray_tpu
import ray_tpu.data as ref_data
from ray_tpu.data import block as ref_block
from ray_tpu.data import grouped as ref_grouped
import ray_tpu_torch
import ray_tpu_torch.data as port_data
from ray_tpu_torch.data import block as port_block
from ray_tpu_torch.data import grouped as port_grouped
from test_torch_runtime import TORCH_CPU

PACKAGES = {"ref": (ray_tpu, ref_data), "port": (ray_tpu_torch, port_data)}


def both(fn, tmp_path=None):
    """fn(data) -- or fn(data, dir) with a directory of each package's own
    under tmp_path -- in a fresh local runtime of each package, the
    reference first. Returns (reference's, port's)."""
    out = {}
    for which, (rt, data) in PACKAGES.items():
        if which == "ref":
            rt.init(num_cpus=4)
        else:
            rt.init(num_cpus=4, _system_config=TORCH_CPU)
        try:
            out[which] = fn(data) if tmp_path is None else fn(data, str(tmp_path / which))
        finally:
            rt.shutdown()
    return out["ref"], out["port"]


def typed(x):
    """x with every leaf tagged by its type (numpy arrays by dtype and
    shape), NaN made comparable: equal iff the values and types are."""
    if isinstance(x, dict):
        return {k: typed(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [typed(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, typed(x.tolist()))
    if isinstance(x, float) and math.isnan(x):
        return ("float", "nan")
    return (type(x).__name__, x)


def same(fn, tmp_path=None):
    ref, port = both(fn, tmp_path)
    assert typed(port) == typed(ref), (port, ref)
    return port


def by_key(rows, key):
    """A groupby's rows in key order: the reference's pyarrow group_by runs
    on threads, and its groups' order varies from run to run under load
    (the port's is first appearance, pyarrow's single-threaded order,
    pinned by test_group_aggregate_equals_single_threaded_group_by)."""
    return sorted(rows, key=lambda r: repr(r[key]))


# ------------------------------------------- tests/test_data.py's 39 cases


def test_range_count_take():
    out = same(lambda d: (d.range(100, parallelism=4).count(),
                          d.range(100, parallelism=4).take(5),
                          d.range(100, parallelism=4).num_blocks()))
    assert out == (100, [{"id": i} for i in range(5)], 4)


def test_from_items_roundtrip():
    items = [{"x": i, "y": str(i)} for i in range(10)]
    assert same(lambda d: d.from_items(items).take_all()) == items


def test_from_items_scalars():
    assert same(lambda d: d.from_items([1, 2, 3]).take_all()) == [1, 2, 3]


def test_map():
    same(lambda d: d.range(10, parallelism=2).map(lambda r: {"id": r["id"] * 2}).take_all())


def test_filter_flat_map_fusion():
    def fn(d):
        ds = d.range(10, parallelism=2).filter(lambda r: r["id"] % 2 == 0).flat_map(
            lambda r: [r, r])
        return len(ds._stages), ds.take_all()

    assert same(fn)[0] == 1


def test_map_batches_numpy():
    same(lambda d: d.range(100, parallelism=4).map_batches(
        lambda b: {"id": b["id"] * 10}, batch_format="numpy").take_all())


def test_map_batches_pandas():
    def f(df):
        df["z"] = df["id"] + 1
        return df

    out = same(lambda d: d.range(5, parallelism=1).map_batches(
        f, batch_format="pandas").take_all())
    assert [r["z"] for r in out] == [1, 2, 3, 4, 5]


def test_map_batches_batch_size():
    def fn(d):
        sizes = []

        def f(b):
            sizes.append(len(b["id"]))
            return b

        d.range(10, parallelism=1).map_batches(f, batch_size=3).count()
        return sizes

    assert max(same(fn)) <= 3


def test_map_batches_actor_pool():
    class AddModel:
        def __init__(self):
            self.offset = 1000

        def __call__(self, batch):
            return {"id": batch["id"] + self.offset}

    same(lambda d: d.range(20, parallelism=4).map_batches(
        AddModel, compute=d.ActorPoolStrategy(size=2)).take_all())


def test_repartition():
    out = same(lambda d: [b.num_rows for b in d.range(100, parallelism=10)
                          .repartition(3).iter_blocks()])
    assert len(out) == 3 and sum(out) == 100


def test_random_shuffle_preserves_multiset():
    out = same(lambda d: [r["id"] for r in d.range(50, parallelism=5)
                          .random_shuffle(seed=0).take_all()])
    assert sorted(out) == list(range(50)) and out != list(range(50))


def test_sort():
    items = [{"v": int(x)} for x in np.random.default_rng(0).permutation(100)]
    assert [r["v"] for r in same(lambda d: d.from_items(items, parallelism=4)
                                 .sort("v").take_all())] == list(range(100))


def test_sort_descending():
    same(lambda d: d.from_items([{"v": i} for i in range(10)], parallelism=2)
         .sort("v", descending=True).take_all())


def test_groupby_count_sum():
    items = [{"k": i % 3, "v": i} for i in range(12)]
    same(lambda d: (by_key(d.from_items(items, parallelism=3).groupby("k").count().take_all(),
                           "k"),
                    by_key(d.from_items(items, parallelism=3).groupby("k").sum("v").take_all(),
                           "k")))


def test_groupby_map_groups():
    items = [{"k": i % 2, "v": i} for i in range(8)]
    out = same(lambda d: sorted(r["v"] for r in d.from_items(items, parallelism=2)
                                .groupby("k").map_groups(lambda df: df.nlargest(1, "v"))
                                .take_all()))
    assert out == [6, 7]


def test_limit():
    assert same(lambda d: d.range(100, parallelism=10).limit(7).count()) == 7


def test_union_zip():
    def fn(d):
        a, b = d.range(5, parallelism=1), d.range(5, parallelism=1)
        return a.union(b).count(), a.zip(b.map(lambda r: {"other": r["id"] * 2})).take_all()

    assert same(fn)[0] == 10


def test_split():
    out = same(lambda d: [p.count() for p in d.range(30, parallelism=3).split(3)])
    assert len(out) == 3 and sum(out) == 30


def test_add_drop_select_columns():
    def fn(d):
        ds = d.range(5, parallelism=1).add_column("sq", lambda b: b["id"] ** 2)
        return (ds.take_all(), ds.select_columns(["sq"]).take(1),
                ds.drop_columns(["sq"]).take(1))

    same(fn)


def test_iter_batches():
    same(lambda d: list(d.range(10, parallelism=2).iter_batches(batch_size=4,
                                                                batch_format="numpy")))


def test_schema_and_stats():
    out = same(lambda d: ([f.name for f in d.range(5, parallelism=1).schema()],
                          d.range(5, parallelism=1).stats()))
    assert out[0] == ["id"] and "blocks" in out[1]


def test_parquet_roundtrip(tmp_path):
    def fn(d, path):
        ds = d.range(50, parallelism=2).map(lambda r: {"id": r["id"], "s": str(r["id"])})
        ds.write_parquet(path)
        back = d.read_parquet(path)
        return back.count(), back.take_all()

    same(fn, tmp_path)


def test_csv_roundtrip(tmp_path):
    def fn(d, path):
        d.from_items([{"a": i, "b": i * 2} for i in range(10)]).write_csv(path)
        return d.read_csv(path).take_all()

    same(fn, tmp_path)


def test_json_roundtrip(tmp_path):
    def fn(d, path):
        d.from_items([{"a": i} for i in range(10)]).write_json(path)
        return sorted(os.listdir(path)), d.read_json(path).take_all()

    same(fn, tmp_path)


def test_from_numpy_tensor_column():
    arr = np.arange(12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_array_equal(same(lambda d: d.from_numpy(arr).take_batch(6))["data"], arr)


def test_from_pandas_to_pandas():
    import pandas as pd

    df = pd.DataFrame({"x": [1, 2, 3], "f": [0.5, float("nan"), 2.0], "s": ["a", None, "c"]})

    def fn(d):
        out = d.from_pandas(df).to_pandas()
        return ({k: str(v) for k, v in out.dtypes.items()},
                {k: out[k].tolist() for k in out.columns},
                d.from_pandas(df).take_all())

    same(fn)


def test_materialize():
    def fn(d):
        calls = []

        def f(r):
            calls.append(1)
            return r

        ds = d.range(10, parallelism=2).map(f).materialize()
        n0 = len(calls)
        ds.count()
        ds.count()
        return n0, len(calls)

    n0, n = same(fn)
    assert n == n0 == 10


def test_limit_position_semantics():
    same(lambda d: (d.range(10, parallelism=2).limit(2).flat_map(lambda r: [r, r]).take_all(),
                    d.range(10, parallelism=2).flat_map(lambda r: [r, r]).limit(2).count()))


def test_sort_globally_ordered_after_chained_map():
    items = [{"v": int(x)} for x in np.random.default_rng(1).permutation(200)]
    same(lambda d: d.from_items(items, parallelism=4).sort("v").map(
        lambda r: {"v": r["v"]}).take_all())


def test_sort_string_keys():
    items = [{"s": f"key{i:03d}"} for i in range(50)]
    np.random.default_rng(2).shuffle(items)
    same(lambda d: d.from_items(items, parallelism=3).sort("s").take_all())


def test_groupby_string_keys_deterministic():
    items = [{"k": f"g{i % 5}", "v": 1} for i in range(25)]
    same(lambda d: by_key(d.from_items(items, parallelism=5).groupby("k").count().take_all(),
                          "k"))


def test_map_batches_tensor_column_roundtrip():
    arr = np.arange(24, dtype=np.float32).reshape(12, 2)
    same(lambda d: d.from_numpy(arr).map_batches(lambda b: {"data": b["data"] * 2})
         .take_batch(12))


def test_single_block_all_to_all():
    items = [{"v": i} for i in range(5)]
    same(lambda d: (d.from_items(items, parallelism=1).repartition(1).take_all(),
                    d.from_items(items, parallelism=1).sort("v").take_all(),
                    d.from_items(items, parallelism=1).random_shuffle(seed=0).take_all()))


def test_map_batches_skips_empty_blocks():
    same(lambda d: d.range(10, parallelism=2).filter(lambda r: r["id"] >= 5)
         .map_batches(lambda b: {"id": b["id"] * 2}).take_all())


def test_from_items_heterogeneous_keys():
    out = same(lambda d: d.from_items([{"a": 1}, {"a": 2, "b": 9}], parallelism=1).take_all())
    assert out == [{"a": 1, "b": None}, {"a": 2, "b": 9}]


def test_random_shuffle_blocks_uncorrelated():
    def fn(d):
        ds = d.from_items([{"v": i} for i in range(64)], parallelism=4)
        return [[r["v"] for r in ds.random_shuffle(seed=s).take_all()] for s in (7, 7, 8)]

    a, b, c = same(fn)
    assert a == b and a != c and sorted(a) == list(range(64))


def test_union_is_lazy_and_correct(tmp_path):
    def fn(d, path):
        os.makedirs(path)
        sentinel = os.path.join(path, "executed")

        def tag(r, _s=sentinel):
            open(_s, "w").close()
            return {"v": r["v"] + 100}

        a = d.from_items([{"v": i} for i in range(3)]).map(tag)
        b = d.from_items([{"v": i} for i in range(3, 6)])
        u = a.union(b)
        lazy = not os.path.exists(sentinel)
        return (lazy, u.take_all(), os.path.exists(sentinel),
                u.map(lambda r: {"v": r["v"] * 2}).take_all(), u.limit(2).take_all(),
                u.num_blocks(), u.random_shuffle(seed=1).take_all())

    out = same(fn, tmp_path)
    assert out[0] and out[2]


def test_read_parquet_kwargs_forwarded(tmp_path):
    import pyarrow.parquet as pq

    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": [1, 2, 3], "b": ["x", "y", "z"]}), path)
    assert same(lambda d: d.read_parquet(path, columns=["a"]).take_all()) == [
        {"a": 1}, {"a": 2}, {"a": 3}]


def test_iter_torch_batches():
    import torch

    items = [{"x": float(i), "y": i} for i in range(100)]

    def fn(d):
        kw = {"device": "cpu"} if d is port_data else {}
        return [{k: (str(v.dtype), str(v.device), v.tolist()) for k, v in b.items()}
                for b in d.from_items(items, parallelism=4).iter_torch_batches(
                    batch_size=32, dtypes={"x": torch.float32}, **kw)]

    out = same(fn)
    assert sum(len(b["x"][2]) for b in out) == 100 and out[0]["x"][0] == "torch.float32"


# ------------------------------------------------------------- the hazards

ROWS_WITH_NULLS = [
    {"i": 1, "f": 2.5, "s": "x", "b": True, "l": [1, 2], "d": {"a": 1}, "t": None},
    {"i": None, "f": None, "s": None, "b": None, "l": None, "d": None, "t": None},
    {"i": 3, "f": float("nan"), "s": "", "b": False, "l": [3, 4], "d": {"a": 2}, "t": None},
]


def test_rows_and_batches_with_nulls_equal_reference():
    """Rows hold Python values and None; batches turn an int column with a
    null into float64 with NaN, a bool one into objects, strings into
    objects; the schema names the dtypes to_numpy gives."""
    def fn(d):
        ds = d.from_items(ROWS_WITH_NULLS, parallelism=1)
        return ds.take_all(), list(ds.iter_batches(batch_size=8)), ds.schema()

    ref, port = both(fn)
    assert typed(port[0]) == typed(ref[0])
    assert typed(port[1]) == typed(ref[1])
    assert [f.name for f in port[2]] == [f.name for f in ref[2]]
    assert {f.name: f.type for f in port[2]} == {k: v.dtype for k, v in ref[1][0].items()}


INFERENCE_CASES = {
    "int_float": [1, 2.5],
    "bool": [True, False],
    "null_int": [None, 1],
    "nulls": [None, None],
    "int_null_float": [1, None, 3.0],
    "str_null": ["a", None],
    "lists": [[1, 2], [3]],
    "equal_lists": [[1, 2], [3, 4]],
    "float32_scalars": [np.float32(1.5), np.float32(2.5)],
    "int32_and_int": [np.int32(3), 4],
    "int64_scalars": [np.int64(3), np.int64(-4)],
    "bytes": [b"x", b"yz"],
    "nan_and_null": [1.0, float("nan"), None],
    "dicts": [{"a": 1}, {"a": 2}],
    "big_ints": [2**40, -(2**40)],
}


@pytest.mark.parametrize("name", sorted(INFERENCE_CASES))
def test_type_inference_equal_reference(name):
    """A user batch's lists become the columns pyarrow.array would make:
    the same rows, the same numpy batch."""
    values = INFERENCE_CASES[name]
    ref = ref_block.BlockAccessor(ref_block.block_from_batch({"c": list(values)}))
    port = port_block.BlockAccessor(port_block.block_from_batch({"c": list(values)}))
    assert typed(list(port.iter_rows())) == typed(list(ref.iter_rows()))
    assert typed(port.to_numpy()) == typed(ref.to_numpy())


@pytest.mark.parametrize("values", [[1, True], [1, "a"], [True, 2.5]],
                         ids=["int_bool", "int_str", "bool_float"])
def test_type_inference_refuses_mixed_columns_as_reference(values):
    with pytest.raises((pa.ArrowInvalid, pa.ArrowTypeError)):
        ref_block.block_from_batch({"c": values})
    with pytest.raises(TypeError):
        port_block.block_from_batch({"c": values})


NUMPY_BATCHES = {
    "int32": np.arange(5, dtype=np.int32),
    "float16": np.linspace(0, 1, 5).astype(np.float16),
    "bool": np.array([True, False, True]),
    "unicode": np.array(["a", "bc", ""]),
    "object_with_none": np.array(["a", None, "c"], dtype=object),
    "float_nan": np.array([1.0, np.nan, 3.0]),
    "tensor_2d": np.arange(12, dtype=np.float32).reshape(4, 3),
    "tensor_3d": np.arange(24, dtype=np.int64).reshape(2, 3, 4),
}


@pytest.mark.parametrize("name", sorted(NUMPY_BATCHES))
def test_numpy_batches_equal_reference(name):
    """A map_batches output of numpy arrays: the rows (a tensor row as a
    flat list) and the batch (a tensor as [rows, prod(shape)]) as the
    reference gives them."""
    arr = NUMPY_BATCHES[name]
    ref = ref_block.BlockAccessor(ref_block.block_from_batch({"c": arr}))
    port = port_block.BlockAccessor(port_block.block_from_batch({"c": arr}))
    assert typed(list(port.iter_rows())) == typed(list(ref.iter_rows()))
    assert typed(port.to_numpy()) == typed(ref.to_numpy())


def test_tensor_column_keeps_its_shape_and_crosses_the_store_out_of_band():
    """The port's tensor column is one [rows, *shape] array; a numpy block
    pickles its arrays out of band (no copy into the pickle)."""
    from ray_tpu_torch.core import serialization

    arr = np.arange(64 * 32 * 8, dtype=np.float32).reshape(64, 32, 8)
    block = port_block.block_from_batch({"t": arr, "i": np.arange(64)})
    assert block.column("t").values.shape == (64, 32, 8)
    data, buffers = serialization.dumps_oob(block)
    assert len(buffers) == 2 and len(data) < 1024 < arr.nbytes
    back = serialization.loads_oob(data, buffers)
    assert typed(port_block.BlockAccessor(back).to_numpy()) == typed(
        port_block.BlockAccessor(block).to_numpy())


HASH_KEYS = {
    "ints": [int(x) for x in np.random.default_rng(3).integers(-50, 50, 40)],
    "strings": [f"k{int(x)}" for x in np.random.default_rng(4).integers(0, 9, 40)],
    "floats": [float(x) for x in np.random.default_rng(5).normal(size=40).round(2)],
    "with_nulls": [None if x % 7 == 0 else int(x) for x in range(40)],
}


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("name", sorted(HASH_KEYS))
def test_hash_partitions_equal_reference(name, n):
    """_det_hash hashes repr of the Python value, so the port must hash
    what to_pylist gives (repr(np.int64(3)) is 'np.int64(3)' under numpy
    2): every row lands in the reference's partition."""
    rows = [{"k": k, "i": i} for i, k in enumerate(HASH_KEYS[name])]
    ref = ref_grouped._hash_partition("k")(ref_block.block_from_rows(rows), n)
    port = port_grouped._hash_partition("k")(port_block.block_from_rows(rows), n)
    assert [typed(p.to_pylist()) for p in port] == [typed(p.to_pylist()) for p in ref]
    assert port_grouped._det_hash(3) == ref_grouped._det_hash(3)
    assert port_grouped._det_hash(np.int64(3)) != port_grouped._det_hash(3)


SORT_VALUES = {
    "floats_nulls_nan": [3.0, None, float("nan"), 1.0, float("nan"), 3.0, None, 2.0],
    "int_ties": [2, 1, 2, 0, 1, 2, 0, 1, 2],
    "ints_with_nulls": [5, None, 3, 5, None, 1],
    "strings": ["b", "a", None, "c", "a", "Z", "é", "z", "中", "b"],
    "bools": [True, False, None, True, False],
}


@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("name", sorted(SORT_VALUES))
def test_sort_indices_equal_reference(name, order):
    """Stable in both directions (descending ties keep input order), NaN
    after the values and nulls after NaN, strings in Arrow's byte order."""
    rows = [{"v": v, "i": i} for i, v in enumerate(SORT_VALUES[name])]
    t = ref_block.block_from_rows(rows)
    want = t.take(pa.compute.sort_indices(t, sort_keys=[("v", order)])).to_pylist()
    b = port_block.block_from_rows(rows)
    got = b.take(port_block.sort_indices(b.column("v"), order)).to_pylist()
    assert typed(got) == typed(want)


@pytest.mark.parametrize("descending", [False, True])
def test_sort_unicode_keys_with_ties_equal_reference(descending):
    keys = ["b", "a", "Z", "é", "z", "中", "ab", "", "b", "a"]
    rows = [{"s": keys[int(x)], "i": i}
            for i, x in enumerate(np.random.default_rng(6).integers(0, len(keys), 60))]
    same(lambda d: d.from_items(rows, parallelism=3).sort("s", descending=descending)
         .take_all())


def test_aggregates_names_ddof_equal_reference():
    """groupby().aggregate: the key column first, columns under their
    aliases; count counts non-null values, sum keeps ints, mean is
    float64, std has ddof 0; a group with no value is null."""
    rng = np.random.default_rng(8)
    rows = [{"k": None if i % 11 == 0 else int(x) % 4, "v": int(x),
             "f": None if i % 5 == 0 else float(y)}
            for i, (x, y) in enumerate(zip(rng.integers(0, 100, 60), rng.normal(size=60)))]
    rows.append({"k": 9, "v": 1, "f": None})  # a group whose f is all null

    def fn(d):
        ds = d.from_items(rows, parallelism=3).groupby("k").aggregate(
            d.Count(), d.Sum("v"), d.Min("v"), d.Max("v"), d.Mean("v"), d.Std("v"),
            d.Sum("f"), d.Mean("f"), d.Std("f"), d.Min("f"), d.Max("f"))
        return [b.column_names for b in ds.iter_blocks()], by_key(ds.take_all(), "k")

    ref, port = both(fn)
    assert port[0] == ref[0]
    assert len(port[1]) == len(ref[1])
    for got, want in zip(port[1], ref[1]):
        assert list(got) == list(want)
        for k, w in want.items():
            g = got[k]
            assert type(g) is type(w), (k, g, w)
            if isinstance(w, float) and k not in ("min(f)", "max(f)"):
                assert g == pytest.approx(w, rel=1e-12, abs=1e-15), (k, g, w)
            else:
                assert g == w, (k, g, w)


@pytest.mark.parametrize("chunks", [1, 3])
def test_group_aggregate_equals_single_threaded_group_by(chunks):
    """The reduce side alone, on a block of `chunks` concatenated parts:
    the port's groups in the order pyarrow's single-threaded group_by
    emits them (first appearance), the key column first, then each
    aggregate under the name the reference renames it to."""
    rng = np.random.default_rng(9 + chunks)
    rows = [{"k": ["b", "a", None, "c"][int(x) % 4], "v": int(x), "f": float(y)}
            for x, y in zip(rng.integers(0, 50, 48), rng.normal(size=48))]
    parts = np.array_split(np.arange(len(rows)), chunks)
    spec = (("k", "count", "count"), ("v", "sum", "sum(v)"), ("f", "mean", "mean(f)"),
            ("f", "stddev", "std(f)"), ("v", "max", "max(v)"))
    t = pa.concat_tables([ref_block.block_from_rows([rows[i] for i in p]) for p in parts])
    want = t.group_by("k", use_threads=False).aggregate([(c, fn) for c, fn, _ in spec])
    want = want.rename_columns(["k"] + [alias for _, _, alias in spec]).to_pylist()
    b = port_block.concat_blocks([port_block.block_from_rows([rows[i] for i in p])
                                  for p in parts])
    got = port_grouped.group_aggregate(b, "k", spec).to_pylist()
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["k"] for r in got] == [r["k"] for r in want]
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("k", "count", "sum(v)", "max(v)")} == {
            k: w[k] for k in ("k", "count", "sum(v)", "max(v)")}
        assert g["mean(f)"] == pytest.approx(w["mean(f)"], rel=1e-12)
        assert g["std(f)"] == pytest.approx(w["std(f)"], rel=1e-12)


@pytest.mark.parametrize("seed", [0, 7, 24])
@pytest.mark.parametrize("parallelism", [1, 3, 5])
def test_shuffle_permutation_equal_reference(seed, parallelism):
    """np.random.default_rng((seed, 0, idx)) assigns, (seed, 1, idx)
    permutes: the same seed gives the reference's order."""
    same(lambda d: [r["id"] for r in d.range(50, parallelism=parallelism)
                    .random_shuffle(seed=seed).take_all()])


@pytest.mark.parametrize("rows,parallelism,n", [(30, 3, 4), (7, 2, 3), (100, 7, 5), (5, 5, 8)])
def test_split_row_counts_equal_reference(rows, parallelism, n):
    same(lambda d: [p.take_all() for p in d.range(rows, parallelism=parallelism).split(n)])
