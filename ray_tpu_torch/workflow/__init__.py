"""Durable workflows: storage-backed DAG execution with resume.

Reference: python/ray/workflow/ (workflow_executor.py drives a DAG of steps;
workflow_storage.py persists each step's spec and result so `resume`
re-executes only the steps whose results are missing).
"""

from ray_tpu_torch.workflow.workflow import (
    Step,
    list_all,
    resume,
    run,
    step,
)

__all__ = ["Step", "step", "run", "resume", "list_all"]
