"""The owner's hold on an object it put: ray_tpu_torch's cluster keeps an
object while its owner holds the ref, however the ref was passed on.

A client that submits a task with a ref another client owns pins it for
the task's flight; when that pin ends it forgets the ref and frees
nothing (cluster/client.py ``_foreign``): only the owner frees. The
task's executor reports its own borrow, which the GCS forwards to the
owner.

The reference, ray_tpu, frees the object in the first case below (an
actor method forwarding the ref into a child actor's constructor): the
GCS's directory then no longer lists it, a task given the ref fails with
"lost arg objects" and an actor given it stays PENDING. In the Data case
its task's streaming exchange hangs instead (its ``get`` times out). These
tests hold the port to the owner's hold and do not run the reference.

The GCS's policy is torch_cuda with scheduler_device "cpu"."""

import subprocess
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.config import Config

CPU = {"scheduler_device": "cpu"}


@pytest.fixture
def cluster():
    c = Cluster(config=Config(CPU))
    c.add_node(num_cpus=8, node_id="b1")
    c.wait_for_nodes(1)
    rt.init(address=c.address)
    try:
        yield c
    finally:
        procs = [w.proc for d in c.daemons for w in list(d.workers.values())
                 if w.proc is not None]
        try:
            rt.shutdown()
        finally:
            c.shutdown()
            for p in procs:
                try:
                    p.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=5)


def _classes():
    """Actor classes and a task, made inside a function so that the
    workers get them by value."""

    @rt.remote
    class Child:
        def __init__(self, spec):
            self.w = spec["args"][0]

        def total(self):
            return float(rt.get(self.w).sum())

    @rt.remote
    class Parent:
        def spawn(self, specs):
            self.kids = [Child.remote(s) for s in specs]
            return [rt.get(k.total.remote(), timeout=60) for k in self.kids]

        def __init__(self, spec=None):
            # a ref two constructors deep: Parent(spec) -> Child(spec)
            self.kid = Child.remote(spec) if spec is not None else None

        def kid_total(self):
            return rt.get(self.kid.total.remote(), timeout=60)

    @rt.remote
    def total(x):
        return float(x.sum())

    return Child, Parent, total


def _held(c, ref, total_fn, Child, expect):
    """The owner's hold, as the fault showed its loss: the directory lists
    the object, a task given the ref runs, an actor given it reaches
    ALIVE and reads it."""
    time.sleep(0.5)  # any free would have reached the GCS by now
    assert c.gcs.directory.get(ref.id), "the owner's object was freed"
    assert rt.get(total_fn.remote(ref), timeout=60) == expect
    kid = Child.remote({"args": [ref]})
    assert rt.get(kid.total.remote(), timeout=60) == expect


def test_ref_forwarded_into_a_child_actor_stays_held(cluster):
    Child, Parent, total = _classes()
    w = rt.put(np.arange(10.0))
    p = Parent.remote()
    assert rt.get(p.spawn.remote([{"args": [w]}]), timeout=60) == [45.0]
    _held(cluster, w, total, Child, 45.0)
    # the child still reads it after the owner's other uses
    assert rt.get(p.spawn.remote([{"args": [w]}, {"args": [w]}]), timeout=60) == [45.0, 45.0]


def test_ref_passed_to_a_killed_actor_stays_held(cluster):
    Child, _, total = _classes()
    w = rt.put(np.arange(6.0))
    kid = Child.remote({"args": [w]})
    assert rt.get(kid.total.remote(), timeout=60) == 15.0
    rt.kill(kid)
    _held(cluster, w, total, Child, 15.0)


def test_ref_two_constructors_deep_stays_held(cluster):
    Child, Parent, total = _classes()
    w = rt.put(np.arange(4.0))
    p = Parent.remote({"args": [w]})
    assert rt.get(p.kid_total.remote(), timeout=60) == 6.0
    _held(cluster, w, total, Child, 6.0)


def test_forwarded_ref_child_outlives_the_parents_hold(cluster):
    """The child's borrow reaches the owner through the GCS: once the
    parent is killed, the child still reads the object."""
    Child, Parent, _ = _classes()
    w = rt.put(np.arange(8.0))
    p = Parent.remote()
    assert rt.get(p.spawn.remote([{"args": [w]}]), timeout=60) == [28.0]
    kid = Child.remote({"args": [w]})
    rt.kill(p)
    time.sleep(0.5)
    assert rt.get(kid.total.remote(), timeout=60) == 28.0
    assert cluster.gcs.directory.get(w.id)


def _consume_factory():
    @rt.remote
    def consume(ds):
        return [np.array(b["tokens"]).tolist() for b in ds.iter_batches(batch_size=4)]

    return consume


def test_data_exchange_in_a_task_keeps_the_drivers_blocks(cluster):
    """The driver builds the blocks (its puts); a task runs the lazy
    shuffle's exchange on them; then the driver runs the same Dataset and
    gets the same rows in the same order."""
    tokens = np.random.default_rng(0).integers(0, 100, (16, 9)).astype(np.int32)
    ds = data.from_numpy(tokens, column="tokens").random_shuffle(seed=24).repartition(1)
    in_task = rt.get(_consume_factory().remote(ds), timeout=60)
    here = [np.array(b["tokens"]).tolist() for b in ds.iter_batches(batch_size=4)]
    assert in_task == here
    assert sorted(sum(here, [])) == sorted(tokens.tolist())


def test_data_items_exchange_in_a_task_then_the_driver(cluster):
    """from_items(...) blocks, random_shuffle in a task, then the driver."""
    ds = data.from_items([{"x": i} for i in range(40)]).random_shuffle(seed=3)

    @rt.remote
    def xs(d):
        return [r["x"] for r in d.take_all()]

    in_task = rt.get(xs.remote(ds), timeout=60)
    here = [r["x"] for r in ds.take_all()]
    assert in_task == here and sorted(here) == list(range(40))


def test_stream_end_marker_outlives_a_slow_consumer(cluster):
    """A streaming task's end marker (its one declared return, the item
    count) is the owner's while the generator lives: a consumer that
    reaches the generator only after the task finished still gets every
    item and the end. The data exchanges above consume their map tasks'
    generators one after another, so every later generator is read late;
    when the end marker was freed on arrival (the caller held no ref to
    it), that consumer waited for it forever."""

    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i

    g = gen.remote(3)
    deadline = time.time() + 30
    while time.time() < deadline and not any(
            t.get("task_id") == g.task_id and t.get("status") == "FINISHED"
            for t in cluster.gcs.rpc_list_tasks({"limit": 100}, None)):
        time.sleep(0.05)
    time.sleep(0.5)  # the result has landed and the owner's gc has run
    assert [rt.get(g.next_ready(timeout=10), timeout=10) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(StopIteration):
        g.next_ready(timeout=10)
