"""Exception hierarchy (reference: python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ray_tpu.get() on the caller
    (reference: RayTaskError in python/ray/exceptions.py — the traceback of
    the remote execution is carried in `cause_text`)."""

    def __init__(self, message: str, cause_text: str = ""):
        super().__init__(message)
        self.cause_text = cause_text

    def __str__(self):
        base = super().__str__()
        if self.cause_text:
            return f"{base}\n\nRemote traceback:\n{self.cause_text}"
        return base


class ActorError(RayTpuError):
    """Actor-related failure."""


class ActorDiedError(ActorError):
    """The actor died before/while executing the call (reference: RayActorError)."""


class ClusterOverloadedError(RayTpuError):
    """The GCS admission controller refused the submission: this driver's
    in-system task count is at its bound (reference shape: the pushback in
    Ray's backpressure RFCs — reject loudly instead of queueing without
    bound). RETRYABLE: ``retry_after_s`` carries the server's pacing hint;
    with ``admission_pacing_enabled`` the client retries admission itself
    for up to ``admission_pacing_max_s`` before surfacing this error."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(RayTpuError, TimeoutError):
    """A request's deadline expired before its handler ran, so it was shed
    (serve fast-path deadline-aware load shedding). A DELIVERED typed
    outcome, never a silent drop: the submitter's response resolves with
    this error exactly once."""


class ObjectLostError(RayTpuError):
    """Object can no longer be retrieved and could not be reconstructed
    (reference: ObjectLostError / ObjectReconstructionFailedError)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu.get(timeout=...) expired (reference: GetTimeoutError)."""


class WorkerCrashedError(RayTpuError):
    """Worker process died mid-task (reference: WorkerCrashedError)."""


class RuntimeEnvSetupError(RayTpuError):
    """Runtime environment failed to build (reference: RuntimeEnvSetupError)."""
