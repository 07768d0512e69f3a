"""The operator's served HTTP surface: /healthz, /readyz, /metrics.

The reference's manager serves liveness/readiness probes and the
Prometheus endpoint from the operator process (operator.go:181-198 healthz
/readyz wiring, metrics server port at :105-135); this is the same surface
over the in-process registry — probes delegate to Operator.healthz/readyz
(the cluster-Synced gate) and /metrics renders the exposition format from
metrics.registry.REGISTRY.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Handler(BaseHTTPRequestHandler):
    operator = None  # bound per server

    def log_message(self, *args) -> None:
        pass

    def _send(self, code: int, body: str, ctype: str = "text/plain") -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:
        path = self.path.split("?")[0]
        if path == "/healthz":
            ok = self.operator.healthz()
            self._send(200 if ok else 503, "ok" if ok else "unhealthy")
        elif path == "/readyz":
            ok = self.operator.readyz()
            self._send(200 if ok else 503, "ready" if ok else "not ready")
        elif path == "/metrics":
            from karpenter_core_tpu_torch.metrics.registry import REGISTRY

            self._send(
                200, REGISTRY.render(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        else:
            self._send(404, "not found")


def start_health_server(
    operator, port: int = 8081, host: str = "0.0.0.0"
) -> ThreadingHTTPServer:
    """Serve probes+metrics on host:port in a daemon thread; returns the
    server (port 0 picks a free one — server_address[1]). Binds all
    interfaces by default — kubelet httpGet probes hit the pod IP, not
    loopback (the reference's metrics/probe listeners do the same)."""
    handler = type("BoundHealth", (_Handler,), {"operator": operator})
    httpd = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd
