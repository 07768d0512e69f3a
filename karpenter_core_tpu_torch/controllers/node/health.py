"""Node auto-repair (feature-gated): force-delete claims whose unhealthy
condition outlasted the provider's toleration, with a 20%-unhealthy
circuit breaker (reference: pkg/controllers/node/health/controller.go:50-222).
"""
from __future__ import annotations

import math

from karpenter_core_tpu_torch.api.objects import Node

UNHEALTHY_THRESHOLD = 0.20  # health/controller.go:188-222


class NodeHealth:
    def __init__(self, kube, cluster, cloud_provider, clock, enabled: bool):
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.enabled = enabled
        # node conditions carry no transition times in our object model, so
        # the controller tracks first-observed-unhealthy itself (the
        # reference reads condition.LastTransitionTime)
        self._first_seen: dict = {}  # (node name, condition type) -> time

    def reconcile(self, node: Node) -> None:
        if not self.enabled:
            return
        # never repair a node that is already terminating (or, within this
        # pass, already terminated) — the reference skips deleting nodes
        if node.metadata.deletion_timestamp is not None:
            return
        if self.kube.get(Node, node.name) is None:
            return
        policies = self.cloud_provider.repair_policies()
        if not policies:
            return
        # prune windows for nodes other controllers deleted, so a later
        # name-reuse never inherits an expired toleration window
        live = {n.name for n in self.kube.list_nodes()}
        for key in [k for k in self._first_seen if k[0] not in live]:
            del self._first_seen[key]
        hit = self._unhealthy_policy(node, policies)
        if hit is None:
            # healthy: clear any tracked windows for this node
            for key in [k for k in self._first_seen if k[0] == node.name]:
                del self._first_seen[key]
            return
        policy = hit
        key = (node.name, policy.condition_type)
        since = self._first_seen.setdefault(key, self.clock.now())
        if self.clock.since(since) < policy.toleration_duration:
            return
        if self._circuit_broken(policies):
            return
        claims = [
            c
            for c in self.kube.list_nodeclaims()
            if c.status.node_name == node.name
        ]
        for c in claims:
            self.kube.delete(c)
        self.kube.delete(node)
        self._first_seen.pop(key, None)

    def _unhealthy_policy(self, node: Node, policies):
        for policy in policies:
            for cond in node.status.conditions:
                ctype, status = cond[0], cond[1]
                if ctype == policy.condition_type and status == policy.condition_status:
                    return policy
        return None

    def _circuit_broken(self, policies) -> bool:
        """Stop repairs when unhealthy nodes exceed ceil(20%) of the cluster
        — likely systemic, not node-level; the round-up mirrors PDB
        percentage logic so small clusters can still repair one node
        (health/controller.go:188-222)."""
        nodes = self.kube.list_nodes()
        if not nodes:
            return False
        unhealthy = sum(
            1 for n in nodes if self._unhealthy_policy(n, policies) is not None
        )
        threshold = math.ceil(UNHEALTHY_THRESHOLD * len(nodes) - 1e-9)
        return unhealthy > threshold
