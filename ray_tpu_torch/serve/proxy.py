"""HTTP proxy: routes requests to deployment handles.

Reference: python/ray/serve/_private/proxy.py (HTTP proxy actor; uvicorn in
the reference, stdlib ThreadingHTTPServer here — zero-dependency). JSON in,
JSON out: POST/GET <route_prefix> with a JSON body calls the app's ingress
deployment.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle


@ray_tpu_torch.remote(num_cpus=0)
class HTTPProxy:
    def __init__(self, port: int = 8000):
        self._routes: Dict[str, DeploymentHandle] = {}
        self._lock = threading.Lock()
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _serve(self):
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                    payload = json.loads(body) if body else None
                    path = self.path.split("?", 1)[0]  # match sans query string
                    handle = proxy._match(path)
                    if handle is None:
                        self.send_response(404)
                        self.end_headers()
                        self.wfile.write(b'{"error": "no route"}')
                        return
                    resp = handle.remote(payload) if payload is not None else handle.remote()
                    result = resp.result(timeout=60.0)
                    data = json.dumps(result).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(data)
                except Exception as e:  # noqa: BLE001
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(json.dumps({"error": repr(e)}).encode())

            def do_GET(self):
                self._serve()

            def do_POST(self):
                self._serve()

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def _match(self, path: str) -> Optional[DeploymentHandle]:
        with self._lock:
            # longest-prefix match (reference: route table longest prefix)
            best = None
            for prefix, h in self._routes.items():
                if path == prefix or path.startswith(prefix.rstrip("/") + "/") or prefix == "/":
                    if best is None or len(prefix) > len(best[0]):
                        best = (prefix, h)
            return best[1] if best else None

    def set_route(self, route_prefix: str, handle: DeploymentHandle):
        with self._lock:
            self._routes[route_prefix] = handle
        return True

    def remove_route(self, route_prefix: str):
        with self._lock:
            self._routes.pop(route_prefix, None)
        return True

    def get_port(self) -> int:
        return self.port
