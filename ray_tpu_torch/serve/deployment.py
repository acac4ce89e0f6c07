"""Deployment definition + binding (model composition).

Reference: python/ray/serve/deployment.py (Deployment, @serve.deployment),
serve/_private/deployment_graph: ``.bind()`` produces a node whose
constructor args may themselves be bound deployments — at deploy time those
become DeploymentHandles (composition).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple


@dataclass
class AutoscalingConfig:
    """Reference: serve/config.py AutoscalingConfig (subset that drives the
    reference's decision: scale to ongoing_requests / target)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0


class Deployment:
    def __init__(
        self,
        func_or_class: Any,
        name: str,
        *,
        num_replicas: Optional[int] = None,
        ray_actor_options: Optional[Dict[str, Any]] = None,
        max_ongoing_requests: int = 16,
        autoscaling_config: Optional[AutoscalingConfig] = None,
        user_config: Optional[Dict[str, Any]] = None,
        version: str = "1",
        fast_path: bool = False,
    ):
        self.func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas or 1
        self.ray_actor_options = dict(ray_actor_options or {})
        self.max_ongoing_requests = max_ongoing_requests
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        self.autoscaling_config = autoscaling_config
        self.user_config = user_config
        self.version = version
        # fast_path=True: handles/proxies route requests over dag-style
        # shm channel pairs (ray_tpu_torch/serve/fastpath.py) — zero GCS RPCs
        # per request in cluster mode; local mode falls back to the task
        # layer (there is no daemon to pin channels on)
        self.fast_path = bool(fast_path)

    def options(self, **kwargs) -> "Deployment":
        merged = dict(
            num_replicas=self.num_replicas,
            ray_actor_options=self.ray_actor_options,
            max_ongoing_requests=self.max_ongoing_requests,
            autoscaling_config=self.autoscaling_config,
            user_config=self.user_config,
            version=self.version,
            fast_path=self.fast_path,
        )
        name = kwargs.pop("name", self.name)
        merged.update(kwargs)
        return Deployment(self.func_or_class, name, **merged)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name}, replicas={self.num_replicas})"


class Application:
    """A bound deployment node (reference: serve Application / DAGNode).
    init args may contain other Applications — deployed bottom-up with
    handles injected."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def _walk(self, seen: Dict[str, "Application"]):
        """Topological collect: dependencies first."""
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, Application):
                a._walk(seen)
        seen[self.deployment.name] = self
        return seen


def deployment(
    _func_or_class: Optional[Any] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Optional[int] = None,
    ray_actor_options: Optional[Dict[str, Any]] = None,
    max_ongoing_requests: int = 16,
    autoscaling_config: Optional[AutoscalingConfig] = None,
    user_config: Optional[Dict[str, Any]] = None,
    version: str = "1",
    fast_path: bool = False,
):
    """@serve.deployment / @serve.deployment(...) (reference: serve/api.py)."""

    def make(target):
        return Deployment(
            target,
            name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config,
            user_config=user_config,
            version=version,
            fast_path=fast_path,
        )

    if _func_or_class is not None:
        return make(_func_or_class)
    return make
