"""Host-port conflict tracking per hypothesized node
(reference: pkg/scheduling/hostportusage.go:34-90)."""
from __future__ import annotations

from typing import List, Optional, Tuple

from karpenter_core_tpu_torch.api.objects import Pod

HostPort = Tuple[str, int, str]  # (ip, port, protocol)


class HostPortUsage:
    def __init__(self):
        self.reserved: List[Tuple[str, HostPort]] = []  # (pod uid, port)

    def conflicts(self, pod: Pod, ports: List[HostPort]) -> Optional[str]:
        for _, (ip, port, proto) in self.reserved:
            for nip, nport, nproto in ports:
                if port == nport and proto == nproto and (
                    ip == nip or ip == "0.0.0.0" or nip == "0.0.0.0"
                ):
                    return f"host port {nip}:{nport}/{nproto} already in use"
        return None

    def add(self, pod: Pod, ports: List[HostPort]) -> None:
        self.reserved.extend((pod.uid, p) for p in ports)

    def remove(self, pod_uid: str) -> None:
        self.reserved = [(u, p) for u, p in self.reserved if u != pod_uid]
