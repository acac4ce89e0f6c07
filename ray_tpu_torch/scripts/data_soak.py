"""Data-pipeline soak: shuffle/groupby pipelines verified exact under node churn.

Run as: python -m ray_tpu_torch.scripts.data_soak [seconds]. Each iteration
runs map -> filter -> random_shuffle -> groupby.sum over 2000-4000 rows
and compares the result against an exact host-side computation, while a
node is killed (and replaced) roughly every other pipeline: multi-stage
block lineage must reconstruct through churn.
"""
import random, sys, time
import numpy as np
import ray_tpu_torch
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch import data as rdata


def main():
    DURATION = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    random.seed(5)
    cluster = Cluster()
    cluster.add_node(num_cpus=2, node_id="stable")
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)

    stats = {"pipelines": 0, "kills": 0, "errors": 0}
    t_end = time.time() + DURATION
    last = time.time()
    it = 0
    while time.time() < t_end:
        it += 1
        n = 2000 + (it % 5) * 500
        try:
            ds = rdata.from_items(
                [{"k": i % 10, "v": float(i)} for i in range(n)], parallelism=8
            )
            out = (ds.map(lambda r: {"k": r["k"], "v": r["v"] * 2})
                     .filter(lambda r: r["k"] != 3)
                     .random_shuffle(seed=it)
                     .groupby("k").sum("v"))
            rows = {r["k"]: r["sum(v)"] for r in out.take_all()}
            expect = {}
            for i in range(n):
                if i % 10 != 3:
                    expect[i % 10] = expect.get(i % 10, 0.0) + i * 2.0
            assert rows == expect, (sorted(rows.items())[:3], sorted(expect.items())[:3])
            stats["pipelines"] += 1
        except Exception as e:
            stats["errors"] += 1
            print("PIPELINE ERR:", repr(e)[:200], flush=True)
        if random.random() < 0.5 and len(cluster.daemons) > 1:
            victim = random.choice([d for d in cluster.daemons if d.node_id != "stable"])
            cluster.kill_node(victim)
            stats["kills"] += 1
            cluster.add_node(num_cpus=2)
        if time.time() - last > 30:
            print("t=%.0f %s" % (DURATION - (t_end - time.time()), stats), flush=True)
            last = time.time()
    print("FINAL:", stats, flush=True)
    ray_tpu_torch.shutdown(); cluster.shutdown()


if __name__ == "__main__":
    main()
