"""ray_tpu_torch.data where pyarrow, pandas and joblib cannot be imported.

The H100 machine has no joblib (pyarrow and pandas are installed there;
chip_smoke.py phase 17a blocks them the same way). A subprocess with
sys.modules["pyarrow"] = sys.modules["pandas"] = sys.modules["joblib"] =
None imports ray_tpu_torch.data (and the host utilities and Workflow) and
runs range -> map_batches (a function, then a class on an actor pool) ->
random_shuffle -> sort -> groupby().count() -> iter_torch_batches(device=
"cpu"); the result must equal what the same pipeline gives in this
process, where all three are installed. read_parquet, to_pandas and the
other paths that need a package raise ImportError naming it.
"""

import json
import os
import subprocess
import sys

import pytest

import ray_tpu_torch
from ray_tpu_torch import data
from test_torch_runtime import TORCH_CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PIPELINE = '''
def pipeline(data):
    import numpy as np

    class Scale:
        def __init__(self):
            self.factor = 0.5

        def __call__(self, b):
            return {"id": b["id"], "k": b["k"], "x": b["id"] * self.factor,
                    "t": np.stack([b["id"], b["k"]], axis=1).astype(np.float32)}

    ds = (data.range(200, parallelism=4)
          .map_batches(lambda b: {"id": b["id"], "k": b["id"] % 7})
          .map_batches(Scale, compute=data.ActorPoolStrategy(size=2))
          .random_shuffle(seed=3)
          .sort("k", descending=True)
          .materialize())
    rows = ds.take_all()
    counts = ds.groupby("k").count().take_all()
    batches = [{k: [str(v.dtype), str(v.device), v.tolist()] for k, v in b.items()}
               for b in ds.iter_torch_batches(batch_size=64, device="cpu")]
    return {"rows": rows, "counts": counts, "batches": batches,
            "schema": [[f.name, str(f.type)] for f in ds.schema()]}
'''

CHILD = f'''
import json, sys
for m in ("pyarrow", "pandas", "joblib"):
    sys.modules[m] = None
sys.path.insert(0, {ROOT!r})
import ray_tpu_torch as rt
from ray_tpu_torch import data, workflow
from ray_tpu_torch.util import collective, graph, joblib_backend, multiprocessing, queue
{PIPELINE}
errors = {{}}

def expect(name, fn):
    try:
        fn()
    except ImportError as e:
        errors[name] = str(e)
    else:
        errors[name] = None

rt.init(num_cpus=4, _system_config={TORCH_CPU!r})
try:
    out = pipeline(data)
    ds = data.range(10)
    expect("read_parquet", lambda: data.read_parquet("missing.parquet"))
    expect("read_csv", lambda: data.read_csv("missing.csv"))
    expect("to_pandas", ds.to_pandas)
    expect("to_arrow", ds.to_arrow)
    expect("from_pandas", lambda: data.from_pandas(None))
    expect("write_json", lambda: ds.write_json("unused"))
    expect("register_ray_tpu", joblib_backend.register_ray_tpu)
finally:
    rt.shutdown()
out["errors"] = errors
out["still_blocked"] = [m for m in ("pyarrow", "pandas", "joblib") if sys.modules.get(m) is None]
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def child():
    proc = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                          timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_pipeline_without_pyarrow_pandas_joblib_equals_with_them(child):
    scope = {}
    exec(PIPELINE, scope)
    ray_tpu_torch.init(num_cpus=4, _system_config=TORCH_CPU)
    try:
        here = json.loads(json.dumps(scope["pipeline"](data)))
    finally:
        ray_tpu_torch.shutdown()
    assert child["still_blocked"] == ["pyarrow", "pandas", "joblib"]
    for key in ("rows", "counts", "batches", "schema"):
        assert child[key] == here[key], key
    assert [r["k"] for r in here["rows"]] == sorted((i % 7 for i in range(200)), reverse=True)
    assert {r["k"]: r["count"] for r in here["counts"]} == {
        k: sum(1 for i in range(200) if i % 7 == k) for k in range(7)}
    assert here["batches"][0]["t"][0] == "torch.float32"


@pytest.mark.parametrize("name,package", [
    ("read_parquet", "pyarrow"), ("read_csv", "pyarrow"), ("to_pandas", "pandas"),
    ("to_arrow", "pyarrow"), ("from_pandas", "pandas"), ("write_json", "pandas"),
    ("register_ray_tpu", "joblib")])
def test_paths_that_need_a_package_raise_import_error_naming_it(child, name, package):
    assert child["errors"][name] is not None, name
    assert package in child["errors"][name]
