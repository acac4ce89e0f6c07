"""GCS-restart soak: tasks/actors flowing while the control plane restarts.

Run as: python -m ray_tpu_torch.scripts.gcs_soak [seconds]. Every task result
is value-checked; "errors" must stay 0 across restarts (snapshot persist
-> kill -> same-port restart -> daemon/driver reconnect + resubmit).
Each restart builds the GCS's scheduling policy anew (torch_cuda on the
card by default). The tables persist under the port's session root.
"""
import os, random, sys, tempfile, time
import ray_tpu_torch
from ray_tpu_torch.cluster.cluster_utils import Cluster


def main():
    DURATION = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    random.seed(11)
    # under TMPDIR, with the port's other session files: a pickle the reference
    # package left would load its classes into this GCS
    persist = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "gcs_soak_tables.pkl")
    os.makedirs(os.path.dirname(persist), exist_ok=True)
    cluster = Cluster(persistence_path=persist)
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)

    @ray_tpu_torch.remote(max_retries=10)
    def work(i):
        time.sleep(random.random() * 0.05)
        return i * 3

    @ray_tpu_torch.remote(max_restarts=-1)
    class Keeper:
        def __init__(self): self.n = 0
        def bump(self): self.n += 1; return self.n

    k = Keeper.options(name="keeper").remote()
    stats = {"tasks": 0, "errors": 0, "restarts": 0, "actor_ok": 0, "actor_err": 0}
    t_end = time.time() + DURATION
    pending = []
    i = 0
    last = time.time()
    while time.time() < t_end:
        i += 1
        pending.append((i, work.remote(i)))
        if random.random() < 0.3:
            try:
                ray_tpu_torch.get(k.bump.remote(), timeout=30)
                stats["actor_ok"] += 1
            except Exception:
                stats["actor_err"] += 1
        if random.random() < 0.01:
            cluster.gcs._persist_now()
            cluster.restart_gcs()
            stats["restarts"] += 1
            time.sleep(0.5)
        while len(pending) > 40:
            j, ref = pending.pop(0)
            try:
                assert ray_tpu_torch.get(ref, timeout=60) == j * 3
                stats["tasks"] += 1
            except Exception as e:
                stats["errors"] += 1
                print("ERR:", repr(e)[:150], flush=True)
        if time.time() - last > 30:
            print("t=%.0f %s" % (DURATION - (t_end - time.time()), stats), flush=True)
            last = time.time()
    for j, ref in pending:
        try:
            assert ray_tpu_torch.get(ref, timeout=90) == j * 3
            stats["tasks"] += 1
        except Exception as e:
            stats["errors"] += 1
            print("ERR-final:", repr(e)[:150], flush=True)
    print("FINAL:", stats, flush=True)
    ray_tpu_torch.shutdown(); cluster.shutdown()


if __name__ == "__main__":
    main()
