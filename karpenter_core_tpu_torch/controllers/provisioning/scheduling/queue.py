"""Pod scheduling queue, CPU-then-memory descending with progress detection
(reference: pkg/controllers/provisioning/scheduling/queue.go:31-112)."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.api.objects import Pod


def by_cpu_and_memory_descending(pods: List[Pod], pod_requests: Dict[str, dict]) -> List[Pod]:
    def sort_key(p: Pod):
        r = pod_requests[p.uid]
        return (
            -r.get("cpu", 0.0),
            -r.get("memory", 0.0),
            p.metadata.creation_timestamp,
            p.uid,
        )

    return sorted(pods, key=sort_key)


class Queue:
    def __init__(self, pods: List[Pod], pod_requests: Dict[str, dict]):
        self.pods: List[Pod] = by_cpu_and_memory_descending(list(pods), pod_requests)
        self.last_len: Dict[str, int] = {}

    def pop(self) -> Tuple[Optional[Pod], bool]:
        if not self.pods:
            return None, False
        p = self.pods[0]
        # no progress since this pod was last pushed at this queue length
        if self.last_len.get(p.uid) == len(self.pods):
            return None, False
        self.pods = self.pods[1:]
        return p, True

    def push(self, pod: Pod, relaxed: bool) -> None:
        self.pods.append(pod)
        if relaxed:
            self.last_len = {}
        else:
            self.last_len[pod.uid] = len(self.pods)

    def list(self) -> List[Pod]:
        return self.pods
