"""HTTP KubeClient — the second implementation of the client seam.

Speaks the kube/httpserver.py protocol with stdlib http.client only, and
satisfies kube/client.py's KubeClient protocol: the SAME controller stack
that runs over the in-memory KubeStore runs over this client against an
apiserver in another process (tests/test_client_conformance.py +
tests/test_e2e_http.py prove it). Semantics mapping:

* create/update sync the server-assigned fields (resourceVersion,
  timestamps, bind results) back into the caller's object, the way
  client-go decodes the response into the passed struct;
* 404 -> NotFoundError, 409 -> ConflictError, 429 -> TooManyRequestsError
  (the PDB eviction contract, eviction.go:176);
* watch is a resource-version-cursored pull: the client drains the
  server's event feed after every write it issues (so self-originated
  events stay ordered like the store's synchronous notify) and on every
  poll()/list; external writers surface at the next drain — the informer
  resync model, not a long-lived stream, which keeps the client loop
  single-threaded like the rest of the framework.
"""
from __future__ import annotations

import http.client
import json
import time
from typing import Callable, List, Optional

from karpenter_core_tpu_torch.kube import serial
from karpenter_core_tpu_torch.kube.store import (
    ConflictError,
    NotFoundError,
    TooManyRequestsError,
)

_PLURALS = {
    "Pod": "pods",
    "Node": "nodes",
    "NodeClaim": "nodeclaims",
    "NodePool": "nodepools",
    "DaemonSet": "daemonsets",
    "VolumeAttachment": "volumeattachments",
    "PodDisruptionBudget": "poddisruptionbudgets",
    "PersistentVolumeClaim": "persistentvolumeclaims",
    "PersistentVolume": "persistentvolumes",
    "StorageClass": "storageclasses",
    "CSINode": "csinodes",
}
_NAMESPACED = {"Pod", "PersistentVolumeClaim", "PodDisruptionBudget",
               "DaemonSet"}


def _ns(kind: str, obj) -> str:
    return obj.metadata.namespace if kind in _NAMESPACED else "default"


# transient statuses a GET/LIST may retry through: apiserver overload (429)
# and gateway/server-side blips (5xx). Writes are NOT retried — a timed-out
# create/update may have landed, and replaying it is not idempotent.
_RETRYABLE_STATUSES = (429, 500, 502, 503, 504)
GET_RETRIES = 3
GET_RETRY_BACKOFF = 0.05


class HttpKubeClient:
    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 30.0,
        get_retries: int = GET_RETRIES,
        retry_backoff: float = GET_RETRY_BACKOFF,
    ):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.get_retries = get_retries
        self.retry_backoff = retry_backoff
        self._sleep = time.sleep  # injectable for tests
        self._watchers: List[Callable[[str, str, object], None]] = []
        self._cursor = 0
        self.mutations = 0  # event count; run_until_idle's idle signal

    # -- transport ---------------------------------------------------------

    def _do_request(self, method: str, path: str, payload=None):
        """One wire round-trip: (status, decoded body)."""
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            body = None if payload is None else json.dumps(payload)
            conn.request(
                method, path, body=body,
                headers={"Content-Type": "application/json"} if body else {},
            )
            resp = conn.getresponse()
            data = json.loads(resp.read() or b"null")
        finally:
            conn.close()
        return resp.status, data

    def _request(self, method: str, path: str, payload=None):
        # bounded retry with exponential backoff for idempotent reads on
        # transient 429/5xx (client-go's rest client retries the same set);
        # everything else surfaces on the first response
        attempts = self.get_retries + 1 if method == "GET" else 1
        for attempt in range(attempts):
            status, data = self._do_request(method, path, payload)
            if (
                status in _RETRYABLE_STATUSES
                and attempt < attempts - 1
            ):
                self._sleep(self.retry_backoff * (2 ** attempt))
                continue
            break
        if status == 404:
            raise NotFoundError(str((data or {}).get("error", path)))
        if status == 409:
            raise ConflictError(str((data or {}).get("error", path)))
        if status == 429:
            raise TooManyRequestsError(str((data or {}).get("error", path)))
        if status >= 400:
            raise RuntimeError(f"{method} {path}: {status} {data}")
        return data

    # -- watch -------------------------------------------------------------

    def watch(self, fn: Callable[[str, str, object], None]) -> None:
        self._watchers.append(fn)

    def poll(self) -> int:
        """Drain the server's event feed; dispatch to watchers. Returns the
        number of events seen (drives mutations/idle detection)."""
        data = self._request("GET", f"/watch?since={self._cursor}")
        events = data.get("events", [])
        self._cursor = data.get("cursor", self._cursor)
        for e in events:
            self.mutations += 1
            obj = serial.decode(e["object"])
            for fn in self._watchers:
                fn(e["event"], e["kind"], obj)
        return len(events)

    # -- CRUD --------------------------------------------------------------

    def create(self, obj) -> object:
        kind = type(obj).__name__
        fresh = serial.decode(self._request(
            "POST", f"/apis/{_PLURALS[kind]}", serial.encode(obj)
        ))
        serial.sync_into(obj, fresh)
        self.poll()
        return obj

    def get(self, cls, name: str, namespace: str = "default"):
        kind = cls.__name__
        try:
            data = self._request(
                "GET", f"/apis/{_PLURALS[kind]}/{namespace}/{name}"
            )
        except NotFoundError:
            return None
        return serial.decode(data)

    def update(self, obj) -> object:
        kind = type(obj).__name__
        fresh = serial.decode(self._request(
            "PUT",
            f"/apis/{_PLURALS[kind]}/{_ns(kind, obj)}/{obj.metadata.name}",
            serial.encode(obj),
        ))
        serial.sync_into(obj, fresh)
        self.poll()
        return obj

    def delete(self, obj) -> None:
        kind = type(obj).__name__
        self._request(
            "DELETE",
            f"/apis/{_PLURALS[kind]}/{_ns(kind, obj)}/{obj.metadata.name}",
        )
        self.poll()

    # -- typed listings ----------------------------------------------------

    def _list(self, plural: str) -> List[object]:
        data = self._request("GET", f"/apis/{plural}")
        return [serial.decode(o) for o in data.get("items", [])]

    def list_pods(self):
        return self._list("pods")

    def list_nodes(self):
        return self._list("nodes")

    def list_nodeclaims(self):
        return self._list("nodeclaims")

    def list_nodepools(self):
        return self._list("nodepools")

    def list_daemonsets(self):
        return self._list("daemonsets")

    def list_volume_attachments(self):
        return self._list("volumeattachments")

    def list_pdbs(self):
        return self._list("poddisruptionbudgets")

    def get_node_by_provider_id(self, provider_id: str) -> Optional[object]:
        try:
            data = self._request(
                "GET", f"/nodes-by-provider-id?id={provider_id}"
            )
        except NotFoundError:
            return None
        return serial.decode(data)

    # -- pod subresources --------------------------------------------------

    def bind(self, pod, node_name: str) -> None:
        fresh = serial.decode(self._request("POST", "/bind", {
            "name": pod.metadata.name,
            "namespace": pod.metadata.namespace,
            "node_name": node_name,
        }))
        serial.sync_into(pod, fresh)
        self.poll()

    def evict(self, pod) -> None:
        self._request("POST", "/evict", {
            "name": pod.metadata.name,
            "namespace": pod.metadata.namespace,
        })
        self.poll()
