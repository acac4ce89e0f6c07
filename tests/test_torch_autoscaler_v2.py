"""ray_tpu_torch's autoscaler v2 against ray_tpu's: the instance state
machine (every transition the reference allows or refuses, the same
here), counts by type and the placement-group demand classes on the same
inputs; then the reference's two end-to-end cases on a port cluster: a
lifecycle with one failed launch retried, drained through the GCS before
it terminates, and a pending STRICT_PACK group that brings one node up.

The GCS's policy is torch_cuda with scheduler_device "cpu"."""

import subprocess
import threading
import time

import numpy as np
import pytest

from ray_tpu.autoscaler import instance_manager as REF
import ray_tpu_torch
from ray_tpu_torch.autoscaler import FakeNodeProvider, NodeTypeConfig
from ray_tpu_torch.autoscaler import instance_manager as IM
from ray_tpu_torch.autoscaler.instance_manager import (
    AutoscalerV2,
    InstanceManager,
    InstanceStatus,
    InvalidTransition,
    pg_demand_classes,
)
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config

CPU = {"scheduler_device": "cpu"}
STATES = sorted(v for k, v in vars(InstanceStatus).items() if not k.startswith("_"))


def test_states_and_transition_table_equal_ray_tpu():
    assert STATES == sorted(v for k, v in vars(REF.InstanceStatus).items()
                            if not k.startswith("_"))
    assert IM._TRANSITIONS == REF._TRANSITIONS
    assert IM._ACTIVE == REF._ACTIVE


def _walk(mod, path):
    """Drive one instance of `mod`'s manager along `path`; the outcome of
    each step (the new status, or the refusal)."""
    im = mod.InstanceManager()
    inst = im.create_instance("cpu2", {"CPU": 2})
    out = []
    for nxt in path:
        try:
            im.update_status(inst.instance_id, nxt, reason=f"to {nxt}")
            out.append(im.get(inst.instance_id).status)
        except mod.InvalidTransition:
            out.append("refused")
    hist = [(h[1], h[2], h[3]) for h in im.get(inst.instance_id).history]
    return out, hist


@pytest.mark.parametrize("seed", range(4))
def test_random_walks_equal_ray_tpu(seed):
    """Every pair of states, tried from every reachable state along seeded
    random walks of 40 steps: the same steps taken and refused, the same
    history."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        path = [STATES[i] for i in rng.integers(0, len(STATES), 40)]
        assert _walk(IM, path) == _walk(REF, path)


def test_instance_walks_legal_lifecycle_with_history():
    im = InstanceManager()
    inst = im.create_instance("cpu2", {"CPU": 2})
    chain = (InstanceStatus.REQUESTED, InstanceStatus.ALLOCATED,
             InstanceStatus.RAY_RUNNING, InstanceStatus.RAY_STOPPING,
             InstanceStatus.TERMINATING, InstanceStatus.TERMINATED)
    for nxt in chain:
        im.update_status(inst.instance_id, nxt, reason=f"to {nxt}")
    got = im.get(inst.instance_id)
    assert got.status == InstanceStatus.TERMINATED
    assert [h[2] for h in got.history[1:]] == list(chain)
    assert all(h[3] for h in got.history[1:])
    with pytest.raises(InvalidTransition):
        im.update_status(inst.instance_id, InstanceStatus.REQUESTED)


def test_counts_by_type_equal_ray_tpu():
    out = []
    for mod in (IM, REF):
        im = mod.InstanceManager()
        a = im.create_instance("a", {"CPU": 1})
        b = im.create_instance("a", {"CPU": 1})
        im.create_instance("b", {"CPU": 1})
        im.update_status(a.instance_id, mod.InstanceStatus.REQUESTED)
        im.update_status(a.instance_id, mod.InstanceStatus.ALLOCATION_FAILED)
        im.update_status(b.instance_id, mod.InstanceStatus.REQUESTED)
        out.append([im.counts_by_type(s) for s in (
            {mod.InstanceStatus.QUEUED}, mod._ACTIVE,
            {mod.InstanceStatus.ALLOCATION_FAILED}, set())])
    assert out[0] == out[1]
    assert out[0][0] == {"b": 1} and out[0][1] == {"a": 1, "b": 1}


def _random_pgs(seed):
    rng = np.random.default_rng(seed)
    pgs = []
    for _ in range(int(rng.integers(0, 6))):
        bundles = []
        for _ in range(int(rng.integers(0, 4))):
            b = {"CPU": float(rng.integers(1, 5))}
            if rng.random() < 0.4:
                b["memory"] = float(rng.integers(1, 9))
            if rng.random() < 0.2:
                b["GPU"] = int(rng.integers(1, 3))
            bundles.append(b)
        pg = {"bundles": bundles}
        if rng.random() < 0.9:
            pg["strategy"] = str(rng.choice(
                ["PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"]))
        pgs.append(pg)
    return pgs


def test_pg_demand_classes_equal_ray_tpu():
    cases = [
        [{"strategy": "STRICT_PACK", "bundles": [{"CPU": 2}, {"CPU": 3, "memory": 8.0}]}],
        [{"strategy": "PACK", "bundles": [{"CPU": 2}, {"CPU": 2}]}],
    ] + [_random_pgs(s) for s in range(30)]
    for pgs in cases:
        assert pg_demand_classes(pgs) == REF.pg_demand_classes(pgs)
    assert pg_demand_classes(cases[0]) == [
        {"resources": {"CPU": 5.0, "memory": 8.0}, "count": 1}]


# ---------------------------------------------------------- end to end


class FlakyProvider(FakeNodeProvider):
    """The first create call fails (the reference's FlakyProvider)."""

    def __init__(self, *a, fail_first=1, **kw):
        super().__init__(*a, **kw)
        self._fail = fail_first
        self._fail_lock = threading.Lock()
        self.daemons_seen = []

    def create_node(self, node_type, resources):
        with self._fail_lock:
            if self._fail > 0:
                self._fail -= 1
                raise RuntimeError("simulated cloud launch failure")
        nid = super().create_node(node_type, resources)
        self.daemons_seen.append(self._daemons[nid])
        return nid


def _reap(daemons):
    for d in daemons:
        for w in list(d.workers.values()):
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait(timeout=5)


def test_v2_end_to_end_lifecycle_and_retry():
    """Demand -> QUEUED -> ... -> RAY_RUNNING (one launch failure retried
    through a fresh record), then idle -> drained in the GCS ->
    RAY_STOPPING -> TERMINATING -> TERMINATED, the provider empty again,
    every history a walk of legal transitions; 30 s in all."""
    t0 = time.time()
    c = Cluster(config=Config(CPU))
    provider = FlakyProvider((c.host, c.gcs.port), config=c.config, fail_first=1)
    scaler = AutoscalerV2(
        (c.host, c.gcs.port), provider,
        [NodeTypeConfig("cpu2", {"CPU": 2, "memory": 2**30}, max_workers=4)],
        idle_timeout_s=1.0, update_interval_s=0.2,
    ).start()
    try:
        ray_tpu_torch.init(address=c.address)

        @ray_tpu_torch.remote(num_cpus=1)
        def work(t):
            time.sleep(t)
            return 1

        refs = [work.remote(0.3) for _ in range(4)]
        assert sum(ray_tpu_torch.get(refs, timeout=25)) == 4
        failed = scaler.im.instances({InstanceStatus.ALLOCATION_FAILED})
        assert len(failed) == 1
        assert "simulated cloud launch failure" in failed[0].history[-1][3]
        # a record turns TERMINATED once the provider's terminate returned
        while time.time() - t0 < 30 and (provider.non_terminated_nodes() or any(
                i.status == InstanceStatus.TERMINATING for i in scaler.im.instances())):
            time.sleep(0.2)
        assert provider.non_terminated_nodes() == []
        for inst in scaler.im.instances():
            assert inst.status in (InstanceStatus.TERMINATED,
                                   InstanceStatus.ALLOCATION_FAILED)
            for _, frm, to, _why in inst.history[1:]:
                assert to in IM._TRANSITIONS[frm]
            if inst.status == InstanceStatus.TERMINATED:
                seen = [h[2] for h in inst.history]
                assert InstanceStatus.RAY_RUNNING in seen
                assert InstanceStatus.RAY_STOPPING in seen
    finally:
        ray_tpu_torch.shutdown()
        scaler.shutdown()
        provider.shutdown()
        c.shutdown()
        _reap(provider.daemons_seen)
    assert time.time() - t0 < 30


def test_v2_pending_pg_triggers_launch():
    """A pending STRICT_PACK group and no task demand: exactly one cpu4
    node comes up and the group is placed on it."""
    from ray_tpu_torch.util.placement_group import placement_group

    c = Cluster(config=Config(CPU))
    provider = FakeNodeProvider((c.host, c.gcs.port), config=c.config)
    scaler = AutoscalerV2(
        (c.host, c.gcs.port), provider,
        [NodeTypeConfig("cpu4", {"CPU": 4, "memory": 2**30}, max_workers=4)],
        idle_timeout_s=30.0, update_interval_s=0.2,
    ).start()
    daemons = []
    try:
        ray_tpu_torch.init(address=c.address)
        pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_PACK")
        assert pg.ready(timeout=25)
        assert len(provider.non_terminated_nodes()) == 1
        daemons = list(provider._daemons.values())
    finally:
        ray_tpu_torch.shutdown()
        scaler.shutdown()
        provider.shutdown()
        c.shutdown()
        _reap(daemons)
