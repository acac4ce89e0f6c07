"""HTTP/JSON dashboard head over the state API, with REST job submission
and a named-call gateway for non-Python clients.

Reference: python/ray/dashboard/head.py (aiohttp app aggregating GCS
state), modules/state/state_head.py (the `/api/...` state routes), and
modules/job/job_head.py + job_manager.py (REST job submission: POST an
entrypoint shell command, the job runs as a detached driver subprocess
with the cluster address in its env, stdout/stderr captured per job).
stdlib ThreadingHTTPServer here — the image has no aiohttp, and the
endpoint surface is the component, not the web stack.

The `/api/call` gateway is the cross-language entry point (reference
analog: the Java/C++ workers' cross-language `ray.task(PyFunction...)`
calls by module path): POST {"func": "module:attr", "args": [...]} runs
that function as a cluster task and returns its JSON-serializable result.
The native C++ client (_native/native_client.cc) speaks these routes.
Binds 127.0.0.1 by default; like the reference's job server, submission
implies code execution, so only bind addresses you would give a shell on.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional


_JOB_ID_RE = re.compile(r"[A-Za-z0-9_.-]+")


def _named_call(path: str, args: list, kwargs: dict):
    """Cluster-side body of /api/call: import `module:attr` and run it."""
    import importlib

    mod, _, attr = path.partition(":")
    fn = importlib.import_module(mod)
    for part in attr.split("."):
        fn = getattr(fn, part)
    return fn(*args, **(kwargs or {}))


class DashboardHead:
    """Serves cluster state as JSON; one instance per driver/head.

    Endpoints:
      /api/summary              cluster counts               (GET)
      /api/nodes                node table                   (GET)
      /api/actors               actor table                  (GET)
      /api/tasks?limit=N        recent task events           (GET)
      /api/placement_groups     PG table                     (GET)
      /api/cluster_resources    total resources              (GET)
      /api/available_resources  free resources               (GET)
      /api/events               structured cluster events    (GET)
      /api/jobs                 list jobs / submit entrypoint (GET/POST)
      /api/jobs/<id>[/logs]     job status / captured logs   (GET)
      /api/jobs/<id>/stop       terminate a running job      (POST)
      /api/call                 run "module:attr" as a task  (POST)
      /                         endpoint index
    """

    def __init__(self, gcs_address: str, host: str = "127.0.0.1",
                 port: int = 0):
        from ray_tpu_torch.core.config import Config
        from ray_tpu_torch.cluster.client import ClusterClient

        # a state-only consumer: don't subscribe this process to the whole
        # cluster's worker-log fanout
        self._client = ClusterClient(
            gcs_address, config=Config({"log_to_driver": False})
        )
        head = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet access log
                pass

            def _respond(self, body, status):
                try:
                    data = json.dumps(body, default=str).encode()
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except OSError:
                    pass  # client hung up / head shutting down mid-request

            def _respond_text(self, text, status,
                              ctype="text/plain; version=0.0.4"):
                # Prometheus exposition is text, not JSON (the version
                # parameter is the text-format content type scrapers send)
                try:
                    data = text.encode()
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except OSError:
                    pass

            def do_GET(self):
                if self.path.partition("?")[0] == "/metrics":
                    try:
                        text, status = head._route_metrics_text()
                    except Exception as e:  # noqa: BLE001
                        text, status = repr(e) + "\n", 500
                    self._respond_text(text, status)
                    return
                try:
                    body, status = head._route(self.path)
                except Exception as e:  # noqa: BLE001
                    body, status = {"error": repr(e)}, 500
                self._respond(body, status)

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(n) if n else b""
                    payload = json.loads(raw) if raw else {}
                    body, status = head._route_post(self.path, payload)
                except Exception as e:  # noqa: BLE001
                    body, status = {"error": repr(e)}, 500
                self._respond(body, status)

        self._gcs_address = gcs_address
        self._jobs: Dict[str, dict] = {}
        self._jobs_lock = threading.Lock()
        self._job_seq = 0
        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="dashboard-head",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _route(self, path: str):
        route, _, query = path.partition("?")
        params: Dict[str, str] = {}
        for pair in query.split("&"):
            if "=" in pair:
                k, _, v = pair.partition("=")
                params[k] = v
        c = self._client
        if route in ("/", "/api"):
            return {
                "endpoints": [
                    "/api/summary", "/api/nodes", "/api/actors",
                    "/api/tasks?limit=N", "/api/placement_groups",
                    "/api/cluster_resources", "/api/available_resources",
                    "/api/events?limit=N&severity=&label=",
                    "/api/metrics", "/metrics (Prometheus text)",
                    "/api/jobs [GET|POST]", "/api/jobs/<id>",
                    "/api/jobs/<id>/logs", "/api/jobs/<id>/stop [POST]",
                    "/api/call [POST]",
                ]
            }, 200
        if route == "/api/metrics":
            r = self._client.gcs.call("metrics", {"format": "json"},
                                      timeout=15.0)
            return r["metrics"], 200
        if route == "/api/summary":
            return c.summary(), 200
        if route == "/api/nodes":
            return c.nodes(), 200
        if route == "/api/actors":
            return c.list_actors(), 200
        if route == "/api/tasks":
            return c.list_tasks(int(params.get("limit", 1000))), 200
        if route == "/api/placement_groups":
            return c.list_placement_groups(), 200
        if route == "/api/cluster_resources":
            return c.cluster_resources(), 200
        if route == "/api/available_resources":
            return c.available_resources(), 200
        if route == "/api/events":
            from ray_tpu_torch.util.events import list_events

            limit = int(params.get("limit", 1000))
            try:
                remote = self._client.gcs.call(
                    "list_events",
                    {"limit": limit, "severity": params.get("severity"),
                     "label": params.get("label")},
                )["events"]
            except Exception:  # noqa: BLE001 - GCS bounced mid-request
                remote = []
            # merge the GCS's ring with this process's own (job events);
            # dedupe — when the head shares the GCS's process (local mode,
            # tests) both reads hit the SAME module-global ring
            local = list_events(limit=limit, severity=params.get("severity"),
                                label=params.get("label"))
            seen = set()
            merged = []
            for e in sorted(
                remote + local, key=lambda e: e["timestamp"], reverse=True
            ):
                key = (e.get("timestamp"), e.get("pid"), e.get("label"),
                       e.get("message"))
                if key in seen:
                    continue
                seen.add(key)
                merged.append(e)
            return merged[:limit], 200
        if route == "/api/jobs":
            with self._jobs_lock:
                jobs = [j for j in self._jobs.values() if j is not None]
            return [self._job_view(j) for j in jobs], 200
        if route.startswith("/api/jobs/"):
            jid = route[len("/api/jobs/"):].rstrip("/")
            if jid.endswith("/logs"):
                jid = jid[: -len("/logs")]
                j = self._jobs.get(jid)
                if j is None:  # unknown or still spawning
                    return {"error": f"no job {jid}"}, 404
                return {"job_id": jid, "logs": self._job_logs(j)}, 200
            j = self._jobs.get(jid)
            if j is None:
                return {"error": f"no job {jid}"}, 404
            return self._job_view(j), 200
        return {"error": f"unknown route {route}"}, 404

    def _route_metrics_text(self):
        """GET /metrics: the GCS's cluster-wide aggregate in Prometheus
        text format (reference: dashboard/modules/metrics exposing the
        scrape endpoint) — node heartbeat deltas + the head's own
        registry, see util/metrics.py."""
        r = self._client.gcs.call("metrics", {"format": "prometheus"},
                                  timeout=15.0)
        return r["text"], 200

    # ------------------------------------------------------------- POST

    def _route_post(self, path: str, payload: dict):
        route = path.partition("?")[0].rstrip("/")
        if route == "/api/jobs":
            return self._submit_job(payload)
        if route.startswith("/api/jobs/") and route.endswith("/stop"):
            jid = route[len("/api/jobs/"):-len("/stop")].rstrip("/")
            with self._jobs_lock:
                j = self._jobs.get(jid)
            if j is None:  # unknown or still spawning
                return {"error": f"no job {jid}"}, 404
            if j["proc"].poll() is None:
                # kill the whole process GROUP: terminate() signals only the
                # shell, orphaning compound entrypoints ("a && b", pipelines)
                # while status would read STOPPED. start_new_session
                # guarantees pgid == proc.pid. (reference: job_manager.py
                # kills the job's process group too)
                try:
                    os.killpg(j["proc"].pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    j["proc"].terminate()
            return self._job_view(j), 200
        if route == "/api/call":
            return self._gateway_call(payload)
        return {"error": f"unknown route {route}"}, 404

    # ------------------------------------------------------------- jobs

    def _submit_job(self, payload: dict):
        """POST /api/jobs {"entrypoint": "<shell cmd>", "env": {...}}.

        The entrypoint runs as a detached driver subprocess with the GCS
        address exported (reference: job_manager.py JobSupervisor spawning
        the entrypoint with RAY_ADDRESS set), logs captured to a file."""
        entry = payload.get("entrypoint")
        if not entry or not isinstance(entry, str):
            return {"error": "entrypoint (string) required"}, 400
        sub_id = payload.get("submission_id")
        if sub_id is not None and not _JOB_ID_RE.fullmatch(str(sub_id)):
            return {"error": "submission_id must match [A-Za-z0-9_.-]+"}, 400
        # reserve the id under the lock; fork/exec outside it (a spawn can
        # be slow and must not serialize submissions or block /stop)
        with self._jobs_lock:
            if sub_id:
                jid = sub_id
                if jid in self._jobs:
                    return {"error": f"job {jid} already exists"}, 400
            else:
                # skip auto ids a user-chosen submission_id already took
                while True:
                    self._job_seq += 1
                    jid = f"job-{self._job_seq:04d}"
                    if jid not in self._jobs:
                        break
            self._jobs[jid] = None  # placeholder: id is taken
        env = dict(os.environ)
        env.update({str(k): str(v) for k, v in (payload.get("env") or {}).items()})
        env["RAY_TPU_GCS_ADDR"] = self._gcs_address
        env["RAY_TPU_ADDRESS"] = self._gcs_address
        try:
            logf = tempfile.NamedTemporaryFile(
                mode="wb", prefix=f"rt-{jid}-", suffix=".log", delete=False
            )
            with logf:
                proc = subprocess.Popen(
                    entry, shell=True, env=env,
                    stdout=logf, stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
        except Exception:
            with self._jobs_lock:
                self._jobs.pop(jid, None)
            raise
        job = {
            "job_id": jid, "entrypoint": entry, "proc": proc,
            "log_path": logf.name, "start": time.time(),
        }
        with self._jobs_lock:
            self._jobs[jid] = job
        from ray_tpu_torch.util.events import record_event

        record_event("JOB_SUBMITTED", f"job {jid}: {entry[:120]}",
                     source="dashboard", job_id=jid)
        return self._job_view(job), 200

    @staticmethod
    def _job_view(j: dict) -> dict:
        rc = j["proc"].poll()
        status = ("RUNNING" if rc is None
                  else "SUCCEEDED" if rc == 0
                  else "STOPPED" if rc < 0 else "FAILED")
        return {
            "job_id": j["job_id"], "entrypoint": j["entrypoint"],
            "status": status, "returncode": rc,
            "start_time": j["start"],
        }

    @staticmethod
    def _job_logs(j: dict, max_bytes: int = 1 << 20) -> str:
        try:
            with open(j["log_path"], "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - max_bytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    # ------------------------------------------------------------- call

    def _gateway_call(self, payload: dict):
        """POST /api/call {"func": "module:attr", "args": [...],
        "kwargs": {...}, "num_cpus": f, "timeout": s} -> {"result": ...}.

        Submits one cluster task running the named function; blocks for the
        result (the native client is synchronous)."""
        from ray_tpu_torch.core.task_spec import TaskSpec, new_id

        path = payload.get("func")
        if not path or ":" not in path:
            return {"error": 'func ("module:attr") required'}, 400
        spec = TaskSpec(
            task_id=new_id("task"),
            func=_named_call,
            args=(path, list(payload.get("args") or []),
                  dict(payload.get("kwargs") or {})),
            resources={"CPU": float(payload.get("num_cpus", 1.0))},
            owner_id=self._client.worker_id,
            name=f"api_call:{path}",
        )
        refs = self._client.submit_task(spec)
        try:
            val = self._client.get(
                refs, timeout=float(payload.get("timeout", 60.0))
            )[0]
        except Exception as e:  # noqa: BLE001 - task error -> HTTP error
            return {"error": repr(e)}, 500
        try:
            json.dumps(val)
        except (TypeError, ValueError):
            val = repr(val)
        return {"result": val}, 200

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()  # release the listening socket now
        with self._jobs_lock:
            jobs = [j for j in self._jobs.values() if j is not None]
        for j in jobs:  # reap captured-log files (reference deletes job
            try:        # artifacts on job deletion; head exit is ours)
                os.unlink(j["log_path"])
            except OSError:
                pass
        self._client.shutdown()
