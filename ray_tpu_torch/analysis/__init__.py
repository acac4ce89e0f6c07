"""ray_tpu_torch.analysis — distributed-correctness linter + runtime sanitizers.

Static half: ``python -m ray_tpu_torch.analysis <paths>`` runs the AST checkers
registered in :mod:`ray_tpu_torch.analysis.checkers` (blocking-in-async,
unsafe-closure-capture, lock-order-cycle, unawaited-coroutine,
dropped-object-ref, resource-spec-validation, unbounded-rpc-call, plus
the protocol checkers over :mod:`ray_tpu_torch.analysis.protocol`'s extracted
RPC model: rpc-method-unknown, rpc-payload-key-mismatch,
push-topic-unknown, config-key-unknown, and the lifecycle checkers over
:mod:`ray_tpu_torch.analysis.statemachine`'s declared/extracted state
machines: illegal-state-transition, cross-thread-field-write, and the
blocking-graph checkers over :mod:`ray_tpu_torch.analysis.waitgraph`:
blocking-wait-under-lock, rpc-reentry-cycle) with per-line
``# ray-lint: disable=<check>`` pragmas and a committed ratchet
baseline. ``--dump-protocol`` emits the protocol model (including the
state machines) as JSON; ``--dump-waitgraph`` emits the interprocedural
blocking graph (execution contexts -> blocking sites -> cross-process
RPC edges) whose cycles are potential distributed deadlocks.

Runtime half: :mod:`ray_tpu_torch.analysis.sanitizer` is the shared lock
instrumentation seam (refcounted ``Lock``/``RLock``/``Condition``
factory patches, one per-thread held stack, listener callbacks) with
:class:`~ray_tpu_torch.analysis.sanitizer.LockOrderSanitizer` riding it
(cross-checking the static lock graph via the ``lock_sanitizer``
fixture); :mod:`ray_tpu_torch.analysis.invariants` (Lamport-clocked protocol
tracer + offline happens-before invariant checker,
``invariant_sanitizer`` fixture / ``--check-trace``); and
:mod:`ray_tpu_torch.analysis.racer` — the hybrid data-race sanitizer: the
``cross-thread-field-write`` model emitted as a machine-readable
watchlist (``--dump-watchlist``) and *validated* by a FastTrack-style
vector-clock engine over the live control-plane threads
(``race_sanitizer`` fixture / ``--race`` / ``chaos_soak --race``;
seeded regression teeth in ``node_daemon.SEEDED_BUGS`` +
``serve.fastpath.SEEDED_BUGS``); and
:mod:`ray_tpu_torch.analysis.waitgraph`'s ``WaitSanitizer`` — the hybrid
wait-for deadlock & stall sanitizer: every lock/queue/future/condition
wait, RPC awaiting a reply, and dag-channel slow-tier park becomes a
node in a live cross-thread AND cross-process wait-for graph, probed
for cycles (deadlock reports carry both stacks + held sets + the RPC
chain) and scanned for stalls by a watchdog (``wait_sanitizer``
fixture / ``--wait`` / ``chaos_soak --stall`` / ``ray_tpu stacks``;
seeded teeth in ``gcs.SEEDED_BUGS`` + ``dag.compiled.SEEDED_BUGS``) —
each runtime sanitizer is the dynamic cross-check of its static model,
and the racer reports a race on a statically-credited-locked field as
a finding against the static analysis itself.

Model-checking half: :mod:`ray_tpu_torch.analysis.explore` runs the real GCS
handler object under a virtual runtime and *searches* handler
interleavings (bounded DFS + pruning + seeded sampling), replaying each
schedule through the invariant checker; ``--explore`` / ``--replay`` on
the CLI. Every scheduler step of an explored schedule is one synchronous
K1 round on the card (``device="cuda"``, the default; ``--device cpu``
runs K1's plain version).
:mod:`ray_tpu_torch.analysis.memmodel` gives the compiled-DAG seqlock channel
the same treatment at word-operation granularity (``--memmodel``,
``lint_gate --memmodel``), kept honest by an op-sequence round-trip
gate against ``dag/channel.py`` plus the two ``chan-*`` checkers
(raw-header-access discipline, publication order).

Deliberately imports no runtime module (torch, numpy, the cluster stack):
linting must work in any environment the source parses in.
"""

from ray_tpu_torch.analysis.core import (  # noqa: F401
    CHECKERS,
    AnalysisResult,
    Checker,
    Finding,
    ModuleContext,
    analyze_paths,
    load_baseline,
    register,
    split_by_baseline,
    write_baseline,
)
