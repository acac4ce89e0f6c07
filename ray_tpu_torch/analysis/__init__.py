"""ray_tpu_torch.analysis — the runtime protocol tracer the control plane
installs (:mod:`ray_tpu_torch.analysis.invariants`, activated from
``cluster/rpc.py`` by ``RAY_TPU_TRACE_FILE``).

Only the tracer is ported so far; the JAX package's static linter, model
checker and sanitizers are later slices of the port (ROADMAP.md, queue 1).
"""
