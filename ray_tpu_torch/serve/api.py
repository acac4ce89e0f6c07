"""serve public API: run/delete/status/shutdown.

Reference: python/ray/serve/api.py (serve.run deploys an Application through
the controller and returns the ingress handle; serve.start launches the
proxy).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.proxy import HTTPProxy

_CONTROLLER_NAME = "serve:controller"
_PROXY_NAME = "serve:http_proxy"

# Extra actor options merged into the controller's placement (e.g.
# ``{"resources": {"STABLE": 0.01}}`` to pin it to a survivor node in
# chaos runs — scripts/serve_storm.py and chaos_soak --serve use this;
# replica placement stays per-deployment via ray_actor_options).
CONTROLLER_OPTIONS: Dict[str, Any] = {}


def _get_controller(create: bool = False):
    try:
        return ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    except ValueError:
        if not create:
            raise RuntimeError("serve is not running (call serve.run first)")
        return ServeController.options(
            name=_CONTROLLER_NAME, num_cpus=0, max_concurrency=16,
            **CONTROLLER_OPTIONS
        ).remote()


def start(http_port: int = 0):
    """Ensure controller + HTTP proxy exist (reference: serve.start)."""
    ctrl = _get_controller(create=True)
    try:
        proxy = ray_tpu_torch.get_actor(_PROXY_NAME)
    except ValueError:
        proxy = HTTPProxy.options(
            name=_PROXY_NAME, num_cpus=0, max_concurrency=32
        ).remote(http_port)
    return ctrl, proxy


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", _blocking: bool = False,
        http_port: int = 0) -> DeploymentHandle:
    """Deploy an application; returns the ingress DeploymentHandle."""
    if isinstance(app, Deployment):
        app = app.bind()
    ctrl = _get_controller(create=True)
    # topological order: dependencies first; bound-Application args become
    # handles (model composition, reference: deployment graph build)
    nodes = app._walk({})
    specs = []
    for node_name, node in nodes.items():
        d = node.deployment

        def to_handle(v):
            if isinstance(v, Application):
                return DeploymentHandle(v.deployment.name, name)
            return v

        specs.append({
            "name": d.name,
            "func_or_class": d.func_or_class,
            "init_args": tuple(to_handle(a) for a in node.args),
            "init_kwargs": {k: to_handle(v) for k, v in node.kwargs.items()},
            "num_replicas": d.num_replicas,
            "ray_actor_options": d.ray_actor_options,
            "max_ongoing_requests": d.max_ongoing_requests,
            "autoscaling_config": d.autoscaling_config,
            "user_config": d.user_config,
            "version": d.version,
            "fast_path": d.fast_path,
        })
    ray_tpu_torch.get(ctrl.deploy_application.remote(
        name, specs, app.deployment.name))
    ingress = DeploymentHandle(app.deployment.name, name)
    if route_prefix is not None:
        _, proxy = start(http_port)
        ray_tpu_torch.get(proxy.set_route.remote(route_prefix, ingress))
    return ingress


def get_app_handle(name: str = "default") -> DeploymentHandle:
    """Handle to a running application's ingress (reference:
    serve.get_app_handle)."""
    ctrl = _get_controller()
    ingress = ray_tpu_torch.get(ctrl.get_ingress.remote(name))
    if ingress is None:
        raise KeyError(f"no application {name!r}")
    return DeploymentHandle(ingress, name)


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def status() -> Dict[str, Any]:
    ctrl = _get_controller()
    return ray_tpu_torch.get(ctrl.status.remote())


def delete(name: str):
    ctrl = _get_controller()
    ray_tpu_torch.get(ctrl.delete_application.remote(name))


def http_port() -> int:
    proxy = ray_tpu_torch.get_actor(_PROXY_NAME)
    return ray_tpu_torch.get(proxy.get_port.remote())


def shutdown():
    # retire fast-path routers FIRST: their channel pairs + GCS pair
    # registrations must not outlive the replicas they point at
    from ray_tpu_torch.serve import fastpath as _fastpath

    _fastpath.shutdown_all()
    try:
        ctrl = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
        ray_tpu_torch.get(ctrl.shutdown.remote(), timeout=10.0)
        ray_tpu_torch.kill(ctrl)
    except Exception:
        pass
    try:
        proxy = ray_tpu_torch.get_actor(_PROXY_NAME)
        ray_tpu_torch.kill(proxy)
    except Exception:
        pass
