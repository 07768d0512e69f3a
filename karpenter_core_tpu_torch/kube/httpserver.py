"""HTTP apiserver over a KubeStore — the second side of the client seam.

An HTTP-faithful stand-in for a real kube-apiserver (envtest's role, run
as a SEPARATE PROCESS): the store's apiserver contracts — resource-version
conflicts (409), finalizer-gated deletes, NotFound (404), PDB-gated
eviction (429), bind subresource — surface as their HTTP status codes, and
watches surface as a resource-version-cursored event feed the way the real
watch API replays from a resourceVersion. kube/httpclient.py speaks this
protocol and passes the same conformance battery as the in-memory store
(tests/test_client_conformance.py), which is what makes the KubeClient
protocol (kube/client.py) a proven seam rather than a declared one.
Reference anchors: operator.go:105-206 (client construction),
pkg/test/environment.go:60-80 (envtest as the test apiserver).

Run: ``python -m karpenter_core_tpu_torch.kube.httpserver --port 8123``
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Tuple
from urllib.parse import parse_qs, urlparse

from karpenter_core_tpu_torch.kube import serial
from karpenter_core_tpu_torch.kube.store import (
    ConflictError,
    KubeStore,
    NotFoundError,
    TooManyRequestsError,
)

_LIST_KINDS = {
    "pods": "list_pods",
    "nodes": "list_nodes",
    "nodeclaims": "list_nodeclaims",
    "nodepools": "list_nodepools",
    "daemonsets": "list_daemonsets",
    "volumeattachments": "list_volume_attachments",
    "poddisruptionbudgets": "list_pdbs",
}

# -- shared handler plumbing (also used by solver/service.py, the solverd
# sidecar — one definition of "send a body with correct framing") ----------


def send_body(
    handler: BaseHTTPRequestHandler,
    code: int,
    body: bytes,
    ctype: str = "application/json",
    headers: dict = None,
) -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    for k, v in (headers or {}).items():
        handler.send_header(k, v)
    handler.end_headers()
    handler.wfile.write(body)


def read_body(handler: BaseHTTPRequestHandler) -> bytes:
    n = int(handler.headers.get("Content-Length", "0"))
    return handler.rfile.read(n) if n else b""


# kinds the GET-by-name path serves (plural -> API class)
_GET_KINDS = {}


def _get_kinds():
    if not _GET_KINDS:
        from karpenter_core_tpu_torch.api import objects as o
        from karpenter_core_tpu_torch.api.nodeclaim import NodeClaim
        from karpenter_core_tpu_torch.api.nodepool import NodePool

        _GET_KINDS.update({
            "pods": o.Pod,
            "nodes": o.Node,
            "nodeclaims": NodeClaim,
            "nodepools": NodePool,
            "daemonsets": o.DaemonSet,
            "volumeattachments": o.VolumeAttachment,
            "poddisruptionbudgets": o.PodDisruptionBudget,
            "persistentvolumeclaims": o.PersistentVolumeClaim,
            "persistentvolumes": o.PersistentVolume,
            "storageclasses": o.StorageClass,
            "csinodes": o.CSINode,
        })
    return _GET_KINDS


class ApiServer:
    """The store plus an event journal for resource-version watches."""

    def __init__(self, store: KubeStore):
        self.store = store
        self.events: List[Tuple[int, str, str, object]] = []
        self._lock = threading.Lock()
        store.watch(self._journal)

    def _journal(self, event: str, kind: str, obj) -> None:
        with self._lock:
            self.events.append(
                (self.store.mutations, event, kind, serial.encode(obj))
            )
            if len(self.events) > 100_000:
                del self.events[:50_000]

    def since(self, cursor: int):
        with self._lock:
            return [e for e in self.events if e[0] > cursor]


class _Handler(BaseHTTPRequestHandler):
    server_version = "karpenter-fake-apiserver/1"
    api: ApiServer

    def log_message(self, *args) -> None:  # quiet
        pass

    def _send(self, code: int, payload) -> None:
        send_body(self, code, json.dumps(payload).encode())

    def _body(self):
        raw = read_body(self)
        return json.loads(raw) if raw else None

    # -- verbs -------------------------------------------------------------

    def do_GET(self) -> None:
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        store = self.api.store
        try:
            if parts == ["watch"]:
                cursor = int(parse_qs(url.query).get("since", ["0"])[0])
                events = self.api.since(cursor)
                self._send(200, {
                    "cursor": store.mutations,
                    "events": [
                        {"rv": rv, "event": ev, "kind": kind, "object": obj}
                        for rv, ev, kind, obj in events
                    ],
                })
            elif parts == ["healthz"]:
                self._send(200, {"ok": True})
            elif len(parts) == 2 and parts[0] == "apis":
                method = _LIST_KINDS.get(parts[1])
                if method is None:
                    return self._send(404, {"error": f"unknown kind {parts[1]}"})
                objs = getattr(store, method)()
                self._send(200, {"items": [serial.encode(o) for o in objs]})
            elif len(parts) == 4 and parts[0] == "apis":
                cls = _get_kinds().get(parts[1])
                if cls is None:
                    return self._send(404, {"error": f"unknown kind {parts[1]}"})
                obj = store.get(cls, parts[3], parts[2])
                if obj is None:
                    return self._send(404, {"error": "not found"})
                self._send(200, serial.encode(obj))
            elif parts[:1] == ["nodes-by-provider-id"]:
                pid = parse_qs(url.query).get("id", [""])[0]
                obj = store.get_node_by_provider_id(pid)
                if obj is None:
                    return self._send(404, {"error": "not found"})
                self._send(200, serial.encode(obj))
            else:
                self._send(404, {"error": f"bad path {url.path}"})
        except Exception as e:  # pragma: no cover - defensive
            self._send(500, {"error": repr(e)})

    def do_POST(self) -> None:
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        store = self.api.store
        try:
            if parts and parts[0] == "apis":
                obj = serial.decode(self._body())
                created = store.create(obj)
                self._send(201, serial.encode(created))
            elif parts == ["bind"]:
                body = self._body()
                from karpenter_core_tpu_torch.api.objects import Pod

                pod = store.get(
                    Pod, body["name"], body.get("namespace", "default")
                )
                if pod is None:
                    return self._send(404, {"error": "pod not found"})
                store.bind(pod, body["node_name"])
                self._send(200, serial.encode(pod))
            elif parts == ["evict"]:
                body = self._body()
                from karpenter_core_tpu_torch.api.objects import Pod

                pod = store.get(
                    Pod, body["name"], body.get("namespace", "default")
                )
                if pod is None:
                    return self._send(404, {"error": "pod not found"})
                store.evict(pod)
                self._send(200, {"evicted": True})
            else:
                self._send(404, {"error": "bad path"})
        except ConflictError as e:
            self._send(409, {"error": str(e)})
        except NotFoundError as e:
            self._send(404, {"error": str(e)})
        except TooManyRequestsError as e:
            self._send(429, {"error": str(e)})
        except Exception as e:  # pragma: no cover
            self._send(500, {"error": repr(e)})

    def do_PUT(self) -> None:
        try:
            obj = serial.decode(self._body())
            updated = self.api.store.update(obj)
            self._send(200, serial.encode(updated))
        except ConflictError as e:
            self._send(409, {"error": str(e)})
        except NotFoundError as e:
            self._send(404, {"error": str(e)})
        except Exception as e:  # pragma: no cover
            self._send(500, {"error": repr(e)})

    def do_DELETE(self) -> None:
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        store = self.api.store
        try:
            cls = _get_kinds().get(parts[1]) if len(parts) == 4 else None
            if cls is None:
                return self._send(404, {"error": "bad path"})
            obj = store.get(cls, parts[3], parts[2])
            if obj is None:
                raise NotFoundError(f"{parts[1]}/{parts[3]}")
            store.delete(obj)
            self._send(200, {"deleted": True})
        except NotFoundError as e:
            self._send(404, {"error": str(e)})
        except Exception as e:  # pragma: no cover
            self._send(500, {"error": repr(e)})


def serve(port: int, store: KubeStore = None) -> ThreadingHTTPServer:
    """Start serving on 127.0.0.1:port; returns the server (caller joins
    or shuts down). Port 0 picks a free port (server.server_address)."""
    api = ApiServer(store or KubeStore())
    handler = type("BoundHandler", (_Handler,), {"api": api})
    httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
    return httpd


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8123)
    args = ap.parse_args()
    httpd = serve(args.port)
    print(f"listening on {httpd.server_address[0]}:{httpd.server_address[1]}",
          flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
