"""Config/flag system.

Reference: src/ray/common/ray_config_def.h — a single X-macro list
``RAY_CONFIG(type, name, default)`` with env override ``RAY_<name>`` and
``ray.init(_system_config={...})``. Same model here: one declarative table,
env override ``RAY_TPU_<name>``, programmatic override via
``ray_tpu.init(_system_config=...)``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

# name -> (type, default)  — keep scheduler knobs named like the reference's
# (scheduler_spread_threshold etc. in ray_config_def.h) for discoverability.
_DEFS: Dict[str, tuple] = {
    "scheduler_spread_threshold": (float, 0.5),
    "scheduler_top_k_fraction": (float, 0.2),  # reserved; kernel is deterministic
    # torch_cuda | hybrid | spread | random; torch_cuda runs the round on
    # the hand-written CUDA kernels of sched/kernel_torch.py. The default
    # differs from the JAX package's ("hybrid", the NumPy policy) on
    # purpose: the port's entry points run on the card unless the caller
    # asks for the CPU (scheduler_device="cpu", or "hybrid")
    "scheduling_policy": (str, "torch_cuda"),
    # "scan" (K1) | "rounds" (K5) | "chunked" (K6)
    "scheduler_kernel_algo": (str, "scan"),
    # torch_cuda policy: the device its rounds run on — "cuda" (default) or
    # "cpu" (the plain PyTorch versions of the kernels). No quiet fallback:
    # "cuda" without a CUDA device raises at policy construction
    "scheduler_device": (str, "cuda"),
    # torch_cuda policy (the key keeps the JAX package's name, so one
    # config dict means the same to both): rounds smaller than this many classes*nodes cells run
    # on the bit-identical NumPy twin (device dispatch latency dominates
    # small solves); 0 = always use the device
    "jax_policy_min_cells": (int, 262_144),
    # device rounds in flight before the oldest is forced: deep pipelining
    # overlaps a round's download with the next rounds' compute.
    # 0 = synchronous rounds
    "jax_policy_pipeline_depth": (int, 8),
    # how long the dep gate honors an owner's "my in-flight actor call will
    # produce this object" voucher before node-death sweeps may re-evaluate
    # the dep (guards against owners that die/fail to publish an error)
    "own_inflight_lease_s": (float, 600.0),
    "scheduler_round_interval_ms": (float, 2.0),
    "max_direct_call_object_size": (int, 100 * 1024),  # inline-in-reply threshold
    "worker_lease_timeout_ms": (float, 500.0),
    "task_max_retries": (int, 3),
    "actor_max_restarts": (int, 0),
    "health_check_period_ms": (float, 1000.0),
    "health_check_timeout_ms": (float, 5000.0),
    "object_store_memory_bytes": (int, 256 * 1024 * 1024),
    "object_spilling_dir": (str, ""),  # empty -> <session_dir>/spill
    "object_transfer_chunk_bytes": (int, 1024 * 1024),
    # concurrent big-object pulls per peer daemon; more pulls queue behind a
    # semaphore (reference: pull_manager.cc prioritized, bandwidth-bounded
    # pull bundles)
    "object_pull_max_concurrent": (int, 2),
    # in-flight chunk requests per pull (pipelining window)
    "object_pull_window": (int, 8),
    # daemon-side arg prefetch bound; short on purpose — on failure the task
    # returns to the GCS dependency gate, which holds it until the object
    # actually exists (so slow producers don't need a long timeout here)
    "object_fetch_timeout_s": (float, 10.0),
    "memory_monitor_interval_ms": (float, 500.0),
    "gcs_port": (int, 0),  # 0 -> pick free port
    # outage window before RetryingRpcClient fires on_reconnect_timeout
    # (drivers fail stranded tasks then) — reconnection itself keeps
    # retrying past it, so a GCS back after minutes still restores the
    # session (reference: gcs_rpc_server_reconnect_timeout_s)
    "gcs_reconnect_timeout_s": (float, 30.0),
    # --- rpc layer (cluster/rpc.py; reference: the grpc deadline/retry
    # knobs around retryable_grpc_client.cc) ---
    "rpc_call_timeout_s": (float, 30.0),  # default blocking-call deadline
    # per-frame socket send deadline: a peer that stops draining its
    # receive buffer wedges senders at most this long (then ConnectionLost)
    "rpc_send_timeout_s": (float, 30.0),
    "rpc_server_start_timeout_s": (float, 10.0),
    "rpc_server_stop_timeout_s": (float, 3.0),
    # RetryingRpcClient backoff: full jitter over
    # [0, min(max_backoff, base * 2^attempt)]
    "rpc_retry_base_backoff_s": (float, 0.05),
    "rpc_retry_max_backoff_s": (float, 2.0),
    # sub-deadline per retryable attempt (a lost frame costs one attempt
    # window, not the whole call budget)
    "rpc_retry_attempt_timeout_s": (float, 5.0),
    # --- compiled execution graphs (ray_tpu/dag/) ---
    # initial payload area per edge channel; channels grow in place (the
    # writer ftruncates + remaps) when a frame exceeds it
    "dag_channel_buffer_bytes": (int, 65536),
    # default per-iteration deadline for CompiledDAG.execute — bounds every
    # channel wait so a dead pipeline raises instead of parking forever
    "dag_execute_timeout_s": (float, 60.0),
    # --- serve fast path (ray_tpu/serve/fastpath.py): the zero-RPC request
    # plane over dag-style shm channel pairs ---
    # initial payload area per request/response channel (grow-in-place)
    "serve_fastpath_channel_bytes": (int, 65536),
    # continuous batcher: hard cap on one dispatch group
    "serve_fastpath_batch_max": (int, 64),
    # target end-to-end latency the adaptive batch sizer aims at: batch
    # size ~= target / EMA(per-item service time), clamped to batch_max
    "serve_fastpath_target_latency_s": (float, 0.02),
    # router membership refresh cadence (a BACKGROUND thread, so the
    # steady-state request path stays RPC-free; failures force a refresh)
    "serve_fastpath_refresh_s": (float, 1.0),
    # router saturation bound: with every replica pair at >= this many
    # locally-observed in-flight requests, submit fails FAST with
    # ClusterOverloadedError instead of queueing behind the backlog;
    # 0 = unbounded (no fail-fast)
    "serve_fastpath_max_inflight": (int, 0),
    # --- overload control plane (admission + backpressure; see README
    # "Overload control") ---
    # GCS admission controller: max in-system (queued + dep-waiting +
    # running) normal tasks per driver; 0 disables admission control.
    # Over the bound, submit_task returns a typed retryable rejection
    # (ClusterOverloadedError client-side) — never a silent drop
    "admission_max_pending_per_driver": (int, 0),
    # pacing hint attached to admission rejections and overload pushes
    "admission_retry_after_s": (float, 0.25),
    # client-side pacing: retry rejected admissions (and slow submitters
    # down while the GCS advertises overload) instead of failing fast
    "admission_pacing_enabled": (bool, True),
    # total budget a rejected task may spend re-attempting admission
    # before its refs fail with ClusterOverloadedError
    "admission_pacing_max_s": (float, 10.0),
    # cluster overload state (hysteresis, derived each scheduler round
    # from GCS queue depth + daemon-reported queue depths): overloaded
    # when queued tasks exceed high*total_CPUs, cleared below low*CPUs
    "overload_pending_high_per_cpu": (float, 8.0),
    "overload_pending_low_per_cpu": (float, 2.0),
    # --- gray-failure defense plane (health scoring + straggler
    # speculation + quarantine; see README "Gray-failure defense") ---
    # master switch for the whole plane (scoring always runs; this gates
    # speculation + quarantine ACTIONS so the A/B storm can compare arms)
    "gray_defense_enabled": (bool, True),
    # straggler speculation: a RUNNING task whose elapsed time exceeds
    # factor * p95(its class's observed durations) gets a speculative
    # duplicate on a healthier node; 0 disables speculation
    "speculation_quantile_factor": (float, 3.0),
    # total executions per task including the primary (2 = at most one
    # speculative copy)
    "speculation_max_copies": (int, 2),
    # duration samples a class needs before its p95 is trusted
    "speculation_min_samples": (int, 5),
    # elapsed-time floor before any task is speculation-eligible (guards
    # sub-millisecond classes against scheduler-jitter false positives)
    "speculation_min_elapsed_s": (float, 0.2),
    # node suspicion hysteresis (score in [0,1] from heartbeat jitter +
    # per-(func,node) duration EMAs): sustained >= high quarantines,
    # probe-verified < low returns the node to service via probation
    "quarantine_high": (float, 0.7),
    "quarantine_low": (float, 0.3),
    # consecutive health sweeps over quarantine_high before quarantine
    # actually triggers ("sustained", not a single bad sample)
    "quarantine_sustain_sweeps": (int, 3),
    # cadence of probe pushes to quarantined nodes (probe results feed
    # recovery; 0 disables probing, leaving quarantine sticky)
    "probe_interval_s": (float, 2.0),
    # health sweeps a PROBATION node must stay clean before full OK;
    # a relapse (score >= high) during probation re-quarantines instantly
    "probation_sweeps": (int, 3),
    "num_workers_soft_limit": (int, 0),  # 0 -> num_cpus
    "worker_start_timeout_s": (float, 30.0),
    "metrics_report_interval_ms": (float, 2000.0),
    # --- observability (ray_tpu.obs; util/metrics.py pipeline) ---
    # master switch for metric collection + the heartbeat delta export;
    # instrumented hot paths check util.metrics.ENABLED (one global load)
    "metrics_enabled": (bool, True),
    # always-on in-memory flight recorder (ray_tpu/obs/flightrec.py):
    # a bounded ring of the same events the ProtocolTracer emits, dumped
    # to artifacts/flightrec-*.jsonl on crash surfaces; cheap enough to
    # leave ON (preformatted tuples, no serialization until a dump)
    "flight_recorder_enabled": (bool, True),
    "flight_recorder_cap": (int, 4096),
    "log_to_driver": (bool, True),
    # spill files, DAG channel dirs and runtime envs go under this root:
    # it follows TMPDIR, and its name keeps the port's files apart from the
    # reference package's, whose clusters use the same node ids
    "session_dir_root": (str, os.path.join(tempfile.gettempdir(), "ray_tpu_torch")),
    # task-event log (reference: gcs_task_manager.cc
    # RAY_task_events_max_num_task_in_gcs): recent window kept in memory;
    # everything beyond it aggregates + spills to JSONL so 1M-task runs
    # keep a queryable timeline without unbounded RSS
    "task_events_recent_cap": (int, 10_000),
    "task_events_spill": (bool, True),
    # anonymized local usage recording (util/usage.py); opt out with
    # RAY_TPU_usage_stats_enabled=0 (reference: RAY_USAGE_STATS_ENABLED)
    "usage_stats_enabled": (bool, True),
}


class Config:
    def __init__(self, overrides: Dict[str, Any] | None = None):
        self._values: Dict[str, Any] = {}
        for name, (typ, default) in _DEFS.items():
            env = os.environ.get(f"RAY_TPU_{name}")
            if env is not None:
                self._values[name] = _parse(typ, env)
            else:
                self._values[name] = default
        for k, v in (overrides or {}).items():
            if k not in _DEFS:
                raise ValueError(f"unknown config key {k!r}")
            self._values[k] = _parse(_DEFS[k][0], v)

    def __getattr__(self, name: str):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)


def _parse(typ, val):
    if typ is bool and isinstance(val, str):
        return val.lower() in ("1", "true", "yes", "on")
    return typ(val)


GLOBAL_CONFIG = Config()


def set_global_config(overrides: Dict[str, Any] | None) -> Config:
    global GLOBAL_CONFIG
    GLOBAL_CONFIG = Config(overrides)
    return GLOBAL_CONFIG
