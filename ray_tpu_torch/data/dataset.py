"""Dataset: lazy logical plan + streaming block execution over the core API.

Reference surfaces: python/ray/data/dataset.py (user API),
_internal/execution/streaming_executor.py (windowed, memory-bounded block
processing), _internal/logical/ (plan + fusion rules), operators/
map_operator.py and actor_pool_map_operator.py (task vs actor compute).

Design: a Dataset is (input block producers, list of stages). Stages are
either per-block transforms (fused greedily, executed as a pipelined stream
of remote tasks with a bounded in-flight window) or all-to-all exchanges
(repartition / shuffle / sort / groupby — map-side partition tasks feeding
reduce tasks, the push-based-shuffle shape from
_internal/planner/exchange/). Blocks are the numpy Tables of data/block.py
in the object store; nothing here imports pyarrow.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    BlockAccessor,
    Table,
    block_from_batch,
    block_from_rows,
    column_from_values,
    concat_blocks,
    sort_indices,
    to_arrow_table,
    to_pandas_frame,
)

# ----------------------------------------------------------------- remote fns


@ray_tpu_torch.remote
def _map_block(fn, block):
    return fn(block)


@ray_tpu_torch.remote
def _partition_block(part_fn, n, idx, block):
    """Map side of an exchange: split one block into n partition blocks.
    With n == 1 the single block is returned bare (num_returns=1 stores the
    return value itself, not a 1-tuple)."""
    if getattr(part_fn, "_wants_index", False):
        parts = list(part_fn(block, n, idx))
    else:
        parts = list(part_fn(block, n))
    return parts[0] if n == 1 else tuple(parts)


@ray_tpu_torch.remote(num_returns="streaming")
def _partition_block_stream(part_fn, n, idx, block):
    """Streaming map side of an exchange (reference: the push-based
    shuffle / streaming-generator exchange in ray.data): each partition
    is PUBLISHED as it is produced — a separate store object shipped
    mid-task — instead of all n riding the task's completion as one
    result set. Partition i of every map task is consumable while the
    slower maps still run."""
    if getattr(part_fn, "_wants_index", False):
        yield from part_fn(block, n, idx)
    else:
        yield from part_fn(block, n)


@ray_tpu_torch.remote
def _count_rows(block):
    return BlockAccessor(block).num_rows()


@ray_tpu_torch.remote
def _slice_block(block, start, stop):
    return BlockAccessor(block).slice(start, stop)


@ray_tpu_torch.remote
def _reduce_blocks(reduce_fn, idx, *parts):
    if getattr(reduce_fn, "_wants_index", False):
        return reduce_fn(list(parts), idx)
    return reduce_fn(list(parts))


@ray_tpu_torch.remote
class _MapActor:
    """Actor-pool compute for map_batches with stateful callables
    (reference: actor_pool_map_operator.py)."""

    def __init__(self, fn_ctor):
        self._fn = fn_ctor()

    def apply(self, wrapper, block):
        return wrapper(self._fn, block)


# --------------------------------------------------------------------- stages


class _MapStage:
    def __init__(self, fn: Callable, name: str, compute=None, fn_ctor=None):
        self.fn = fn  # block -> block   (or (state, block) -> block w/ actors)
        self.name = name
        self.compute = compute
        self.fn_ctor = fn_ctor

    def fuse(self, other: "_MapStage") -> Optional["_MapStage"]:
        if self.compute is not None or other.compute is not None:
            return None
        f, g = self.fn, other.fn

        def fused(block):
            return g(f(block))

        return _MapStage(fused, f"{self.name}->{other.name}")


class _AllToAllStage:
    def __init__(self, name, n_outputs, part_fn, reduce_fn, prepare=None):
        self.name = name
        self.n_outputs = n_outputs
        self.part_fn = part_fn  # (block, n) -> [n blocks]
        self.reduce_fn = reduce_fn  # [blocks] -> block
        # optional pre-pass over the materialized input refs (e.g. boundary
        # sampling for sort); returns a replacement part_fn
        self.prepare = prepare


class _LimitStage:
    def __init__(self, n: int):
        self.n = n


DEFAULT_IN_FLIGHT = 16


class ActorPoolStrategy:
    """compute= argument for map_batches (reference: ray.data.ActorPoolStrategy)."""

    def __init__(self, size: int = 2):
        self.size = size


# ------------------------------------------------------------------ execution


def _execute_map(refs: Iterator, stage: _MapStage, window: int) -> Iterator:
    """Pipelined per-block execution with a bounded in-flight window.

    Yields outputs in SUBMISSION order (block order is part of Dataset
    semantics — take()/zip() depend on it), waiting on the head of the
    window while the rest keep running."""
    if stage.compute is not None:
        yield from _execute_map_actors(refs, stage)
        return
    in_flight: List = []
    for ref in refs:
        in_flight.append(_map_block.remote(stage.fn, ref))
        if len(in_flight) >= window:
            ray_tpu_torch.wait([in_flight[0]], num_returns=1)
            yield in_flight.pop(0)
    while in_flight:
        ray_tpu_torch.wait([in_flight[0]], num_returns=1)
        yield in_flight.pop(0)


def _execute_map_actors(refs: Iterator, stage: _MapStage) -> Iterator:
    pool = [_MapActor.remote(stage.fn_ctor) for _ in range(stage.compute.size)]
    try:
        in_flight = []
        for i, ref in enumerate(refs):
            actor = pool[i % len(pool)]
            in_flight.append(actor.apply.remote(stage.fn, ref))
            if len(in_flight) >= 2 * len(pool):
                ray_tpu_torch.wait([in_flight[0]], num_returns=1)
                yield in_flight.pop(0)
        while in_flight:
            ray_tpu_torch.wait([in_flight[0]], num_returns=1)
            yield in_flight.pop(0)
    finally:
        # pool actors hold their CPUs for life; leaking them across
        # re-executions starves the cluster and deadlocks actor creation
        for a in pool:
            ray_tpu_torch.kill(a)


def _execute_all_to_all(refs: List, stage: _AllToAllStage) -> List:
    n = stage.n_outputs
    part_fn = stage.part_fn
    if stage.prepare is not None:
        part_fn = stage.prepare(refs)
    if n == 1:
        parts = [
            [_partition_block.remote(part_fn, n, i, ref)]
            for i, ref in enumerate(refs)
        ]
    else:
        # streaming exchange: every map task publishes partitions as it
        # produces them; consuming the generators overlaps partitioning
        # with transfer across the whole map wave
        gens = [
            _partition_block_stream.remote(part_fn, n, i, ref)
            for i, ref in enumerate(refs)
        ]
        parts = [list(g) for g in gens]
        for i, (g, p) in enumerate(zip(gens, parts)):
            if g.errored:
                # the stream's last ref carries the partitioner's real
                # exception — surface IT, not a block-count mismatch (and
                # never hand the error marker to a reduce task as data)
                ray_tpu_torch.get(p[-1])
            if len(p) != n:
                raise ValueError(
                    f"exchange partitioner produced {len(p)} blocks for "
                    f"input {i}, expected {n}"
                )
    out = []
    for j in range(n):
        out.append(
            _reduce_blocks.remote(stage.reduce_fn, j, *[p[j] for p in parts])
        )
    return out


# -------------------------------------------------------------------- dataset


class Dataset:
    """Lazy, immutable, distributed collection of rows (reference:
    python/ray/data/dataset.py Dataset)."""

    def __init__(self, block_refs: List, stages: Optional[List] = None):
        self._input_refs = block_refs
        self._stages = stages or []
        # set by union(): input blocks come from the parents' pipelines,
        # executed lazily at consumption time
        self._parents: Optional[List["Dataset"]] = None

    # ------------------------------------------------------------- transforms

    def _with_stage(self, stage) -> "Dataset":
        stages = list(self._stages)
        if stages and isinstance(stage, _MapStage) and isinstance(stages[-1], _MapStage):
            fused = stages[-1].fuse(stage)
            if fused is not None:
                stages[-1] = fused
                return self._copy_with(stages)
        stages.append(stage)
        return self._copy_with(stages)

    def _copy_with(self, stages) -> "Dataset":
        ds = Dataset(self._input_refs, stages)
        ds._parents = self._parents
        return ds

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        def _map(block):
            return block_from_rows([fn(r) for r in BlockAccessor(block).iter_rows()])

        return self._with_stage(_MapStage(_map, "map"))

    def flat_map(self, fn: Callable[[dict], List[dict]]) -> "Dataset":
        def _fmap(block):
            out = []
            for r in BlockAccessor(block).iter_rows():
                out.extend(fn(r))
            return block_from_rows(out)

        return self._with_stage(_MapStage(_fmap, "flat_map"))

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        def _filt(block):
            # mask-based: preserves the schema even when every row drops
            mask = [bool(fn(r)) for r in BlockAccessor(block).iter_rows()]
            return block.filter(np.array(mask, dtype=bool))

        return self._with_stage(_MapStage(_filt, "filter"))

    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_format: Optional[str] = "numpy",
        batch_size: Optional[int] = None,
        compute: Optional[ActorPoolStrategy] = None,
        fn_constructor_args: tuple = (),
        **kwargs,
    ) -> "Dataset":
        """Apply fn to batches. A callable CLASS runs on an actor pool with
        one instance per actor (stateful, e.g. a model on the card)."""
        is_class = isinstance(fn, type)
        if is_class and compute is None:
            compute = ActorPoolStrategy(size=2)

        def _apply(callable_fn, block):
            acc = BlockAccessor(block)
            nrows = acc.num_rows()
            if nrows == 0:
                if block.num_columns == 0:
                    # schema-less empty: nothing the fn could act on
                    return block
                # empty but typed: run the fn so the OUTPUT schema is right;
                # only empty-batch-shaped failures (indexing/reducing zero
                # rows) fall back to the input block — real fn bugs propagate
                try:
                    return block_from_batch(
                        callable_fn(acc.to_batch(batch_format))
                    )
                except (IndexError, ValueError, ZeroDivisionError, StopIteration):
                    return block
            size = batch_size or nrows
            outs = []
            for s in range(0, nrows, size):
                sub = acc.slice(s, min(s + size, nrows))
                out = callable_fn(BlockAccessor(sub).to_batch(batch_format))
                outs.append(block_from_batch(out))
            return concat_blocks(outs)

        if is_class:
            ctor = (lambda: fn(*fn_constructor_args))
            return self._with_stage(
                _MapStage(_apply, "map_batches(actors)", compute=compute, fn_ctor=ctor)
            )

        def _task(block):
            return _apply(fn, block)

        return self._with_stage(_MapStage(_task, "map_batches"))

    def add_column(self, name: str, fn) -> "Dataset":
        def _add(block):
            col = fn(BlockAccessor(block).to_numpy())
            return block.append_column(name, column_from_values(np.asarray(col)))

        return self._with_stage(_MapStage(_add, f"add_column({name})"))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def _drop(block):
            return block.drop_columns(cols)

        return self._with_stage(_MapStage(_drop, "drop_columns"))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def _sel(block):
            return block.select(cols)

        return self._with_stage(_MapStage(_sel, "select_columns"))

    # ---------------------------------------------------------- all-to-all ops

    def repartition(self, num_blocks: int) -> "Dataset":
        def part(block, n):
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            cuts = [rows * i // n for i in range(n + 1)]
            return [acc.slice(cuts[i], cuts[i + 1]) for i in range(n)]

        return self._with_stage(
            _AllToAllStage("repartition", num_blocks, part, concat_blocks)
        )

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        n = max(self.num_blocks(), 1)

        def part(block, n, idx, _seed=seed):
            # seed salted per block index: every map task draws an
            # independent stream (reference: shuffle ops seed per task)
            rng = np.random.default_rng(
                None if _seed is None else (_seed, 0, idx)
            )
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            assign = rng.integers(0, n, rows)
            t = block
            return [
                t.take(np.nonzero(assign == j)[0]) for j in range(n)
            ]

        part._wants_index = True

        def reduce(blocks, idx, _seed=seed):
            t = concat_blocks(blocks)
            rng = np.random.default_rng(
                None if _seed is None else (_seed, 1, idx)
            )
            if t.num_rows:
                t = t.take(rng.permutation(t.num_rows))
            return t

        reduce._wants_index = True

        return self._with_stage(_AllToAllStage("random_shuffle", n, part, reduce))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Sample → range-partition → per-partition sort (reference:
        _internal/planner/exchange/sort_task_spec.py). Boundary sampling
        runs as a prepare pass over the materialized input refs, so
        partition j holds exactly the j-th key range: concatenating the
        output blocks in order IS the global sort order."""
        n = max(self.num_blocks(), 1)
        order = "descending" if descending else "ascending"

        def prepare(refs, _key=key, _n=n):
            @ray_tpu_torch.remote
            def sample(block):
                col = block.column(_key)
                m = min(block.num_rows, 64)
                if m == 0:
                    return []
                idx = np.linspace(0, block.num_rows - 1, m).astype(np.int64)
                return col.take(idx).to_pylist()

            samples = sorted(
                s for chunk in ray_tpu_torch.get([sample.remote(r) for r in refs])
                for s in chunk
            )
            if not samples:
                bounds = []
            else:
                bounds = [
                    samples[len(samples) * j // _n]
                    for j in range(1, _n)
                ]
            if descending:
                bounds = bounds[::-1]

            def part(block, n, _bounds=tuple(bounds), _desc=descending):
                if block.num_rows == 0:
                    return [block] * n
                vals = block.column(_key).to_pylist()
                # partition index = number of boundaries crossed; descending
                # bounds are reversed so partition 0 holds the largest keys
                assign = np.zeros(len(vals), np.int64)
                for b in _bounds:
                    crossed = [(v < b) if _desc else (v >= b) for v in vals]
                    assign += np.array(crossed, np.int64)
                assign = np.clip(assign, 0, n - 1)
                return [
                    block.take(np.nonzero(assign == j)[0])
                    for j in range(n)
                ]

            return part

        def reduce(blocks, _key=key, _order=order):
            t = concat_blocks(blocks)
            if t.num_rows == 0:
                return t
            return t.take(sort_indices(t.column(_key), _order))

        return self._with_stage(
            _AllToAllStage("sort", n, None, reduce, prepare=prepare)
        )

    def groupby(self, key: str) -> "GroupedData":
        from ray_tpu_torch.data.grouped import GroupedData

        return GroupedData(self, key)

    def union(self, other: "Dataset") -> "Dataset":
        """Lazy: neither input pipeline executes until the union is consumed."""
        ds = Dataset([])
        ds._parents = [self, other]
        return ds

    def zip(self, other: "Dataset") -> "Dataset":
        left = concat_blocks(ray_tpu_torch.get(self._materialize_refs()))
        right = concat_blocks(ray_tpu_torch.get(other._materialize_refs()))
        if left.num_rows != right.num_rows:
            raise ValueError("zip: datasets must have equal row counts")
        for name in right.column_names:
            out_name = name if name not in left.column_names else name + "_1"
            left = left.append_column(out_name, right.column(name))
        return Dataset([ray_tpu_torch.put(left)])

    def limit(self, n: int) -> "Dataset":
        return self._copy_with(list(self._stages) + [_LimitStage(n)])

    def split(self, n: int) -> List["Dataset"]:
        refs = self.repartition(n)._materialize_refs()
        return [Dataset([r]) for r in refs]

    # ------------------------------------------------------------- execution

    def _execute_refs(self) -> Iterator:
        window = DEFAULT_IN_FLIGHT
        if self._parents is not None:
            refs: Iterator = (
                r for p in self._parents for r in p._execute_refs()
            )
        else:
            refs = iter(self._input_refs)
        for stage in self._stages:
            if isinstance(stage, _MapStage):
                refs = _execute_map(refs, stage, window)
            elif isinstance(stage, _AllToAllStage):
                refs = iter(_execute_all_to_all(list(refs), stage))
            elif isinstance(stage, _LimitStage):
                # applied at its position in the plan: later stages only see
                # the truncated stream
                refs = self._apply_limit(refs, stage.n)
        yield from refs

    @staticmethod
    def _apply_limit(refs, n):
        # count/slice remotely: only the row count crosses to the driver,
        # never the block contents (reference: limit uses block metadata)
        taken = 0
        for ref in refs:
            if taken >= n:
                break
            rows = ray_tpu_torch.get(_count_rows.remote(ref))
            if taken + rows <= n:
                taken += rows
                yield ref
            else:
                yield _slice_block.remote(ref, 0, n - taken)
                taken = n

    def _materialize_refs(self) -> List:
        return list(self._execute_refs())

    def materialize(self) -> "Dataset":
        return Dataset(self._materialize_refs())

    # ------------------------------------------------------------ consumption

    def iter_blocks(self) -> Iterator[Table]:
        for r in self._execute_refs():
            yield ray_tpu_torch.get(r)

    def iter_rows(self) -> Iterator[dict]:
        for block in self.iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def iter_batches(
        self, *, batch_size: int = 256, batch_format: Optional[str] = "numpy"
    ) -> Iterator[Any]:
        for block in self.iter_blocks():
            acc = BlockAccessor(block)
            for s in range(0, acc.num_rows(), batch_size):
                sub = acc.slice(s, min(s + batch_size, acc.num_rows()))
                yield BlockAccessor(sub).to_batch(batch_format)

    def iter_torch_batches(
        self, *, batch_size: int = 256, dtypes=None, device=None
    ) -> Iterator[Any]:
        """Batches as dicts of torch tensors (reference:
        Dataset.iter_torch_batches; numpy batches zero-copy into
        torch.from_numpy where dtypes permit). Like every entry point of
        the port, the batches land on the card unless `device` says
        otherwise; without a card this raises (pass device="cpu")."""
        import torch

        from ray_tpu_torch.util.device import resolve_device

        dev = resolve_device(device, what="iter_torch_batches")
        for batch in self.iter_batches(
            batch_size=batch_size, batch_format="numpy"
        ):
            out = {}
            for k, v in batch.items():
                v = np.ascontiguousarray(v)
                if not v.flags.writeable:  # a view of the store: torch needs its own
                    v = v.copy()
                t = torch.from_numpy(v)
                if dtypes is not None:
                    want = dtypes.get(k) if isinstance(dtypes, dict) else dtypes
                    if want is not None:
                        t = t.to(want)
                if dev.type != "cpu":
                    t = t.to(dev)
                out[k] = t
            yield out

    def take(self, n: int = 20) -> List[Any]:
        return list(itertools.islice(self.iter_rows(), n))

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def take_batch(self, n: int = 20, *, batch_format: str = "numpy"):
        rows = self.take(n)
        return BlockAccessor(block_from_rows(rows)).to_batch(batch_format)

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows() for b in self.iter_blocks())

    def schema(self):
        for block in self.iter_blocks():
            if block.num_rows or block.num_columns:
                return BlockAccessor(block).schema()
        return None

    def num_blocks(self) -> int:
        if self._parents is not None:
            return sum(p.num_blocks() for p in self._parents)
        return len(self._input_refs)

    def to_pandas(self):
        """Needs pandas (raises ImportError naming it without)."""
        return to_pandas_frame(concat_blocks(list(self.iter_blocks())))

    def to_arrow(self):
        """Needs pyarrow (raises ImportError naming it without)."""
        return to_arrow_table(concat_blocks(list(self.iter_blocks())))

    def stats(self) -> str:
        return (
            f"Dataset(blocks={self.num_blocks()}, "
            f"stages={[getattr(s, 'name', 'limit') for s in self._stages]})"
        )

    # ---------------------------------------------------------------- writes

    def write_parquet(self, path: str) -> None:
        from ray_tpu_torch.data.io import _write_blocks

        _write_blocks(self, path, "parquet")

    def write_csv(self, path: str) -> None:
        from ray_tpu_torch.data.io import _write_blocks

        _write_blocks(self, path, "csv")

    def write_json(self, path: str) -> None:
        from ray_tpu_torch.data.io import _write_blocks

        _write_blocks(self, path, "json")

    def __repr__(self):
        return self.stats()
