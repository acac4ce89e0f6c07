"""ray_tpu_torch.data — streaming datasets over the core task/actor API.

Reference: python/ray/data/ (Dataset, read_api, grouped_data, aggregate).
A block is a columnar table of numpy arrays (data/block.py), so importing
this package and running a pipeline from range / from_items / from_numpy
through map_batches, shuffles, sorts and groupbys to iter_torch_batches
needs neither pyarrow nor pandas.
"""

from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.dataset import ActorPoolStrategy, Dataset
from ray_tpu_torch.data.grouped import (
    AggregateFn,
    Count,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from ray_tpu_torch.data.io import (
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A004
    read_csv,
    read_json,
    read_parquet,
)

__all__ = [
    "ActorPoolStrategy",
    "AggregateFn",
    "BlockAccessor",
    "Count",
    "Dataset",
    "Max",
    "Mean",
    "Min",
    "Std",
    "Sum",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_csv",
    "read_json",
    "read_parquet",
]
