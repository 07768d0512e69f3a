"""Cluster state cache — the L3 layer feeding the solver
(reference: pkg/controllers/state/cluster.go:48-658, statenode.go:115-529).

StateNode merges the Node and NodeClaim views of one machine; Cluster keys
them by provider id, tracks pod↔node bindings, and produces the SimNode
snapshot the scheduler (and later, the device snapshot codec) consumes.
Informer events arrive through KubeStore.watch; `sync()` performs the full
resync the reference's Synced() gate guarantees before a solve.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import NodeClaim
from karpenter_core_tpu_torch.api.objects import Node, Pod
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import SimNode
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
    has_required_pod_anti_affinity,
)
from karpenter_core_tpu_torch.scheduling.taints import KNOWN_EPHEMERAL_TAINTS
from karpenter_core_tpu_torch.utils import resources as resutil
from karpenter_core_tpu_torch.utils.clock import Clock


class StateNode:
    """Node + NodeClaim merged view (statenode.go:115-145)."""

    def __init__(
        self, node: Optional[Node] = None, node_claim: Optional[NodeClaim] = None
    ):
        self.node = node
        self.node_claim = node_claim
        self.marked_for_deletion = False
        self.nominated_until = 0.0

    # -- identity ---------------------------------------------------------

    @property
    def name(self) -> str:
        if self.node is not None:
            return self.node.name
        return self.node_claim.status.node_name or self.node_claim.name

    @property
    def provider_id(self) -> str:
        if self.node is not None and self.node.provider_id:
            return self.node.provider_id
        if self.node_claim is not None:
            return self.node_claim.status.provider_id
        return ""

    @property
    def labels(self) -> dict:
        if self.node is not None:
            return self.node.labels
        return self.node_claim.metadata.labels

    @property
    def nodepool_name(self) -> str:
        return self.labels.get(apilabels.NODEPOOL_LABEL_KEY, "")

    # -- lifecycle predicates (statenode.go:311-327) ----------------------

    def registered(self) -> bool:
        if self.node_claim is not None:
            return self.node_claim.is_registered()
        return self.node is not None  # unmanaged nodes count as registered

    def initialized(self) -> bool:
        if self.node_claim is not None:
            return self.node_claim.is_initialized()
        return self.node is not None

    def managed(self) -> bool:
        return self.node_claim is not None or (
            self.node is not None
            and apilabels.NODEPOOL_LABEL_KEY in self.node.labels
        )

    def deleting(self) -> bool:
        return (
            self.node is not None
            and self.node.metadata.deletion_timestamp is not None
        ) or (
            self.node_claim is not None
            and self.node_claim.metadata.deletion_timestamp is not None
        )

    # -- resources (statenode.go:329-366) ---------------------------------

    def capacity(self) -> dict:
        if self.node is not None and self.node.status.capacity:
            return dict(self.node.status.capacity)
        if self.node_claim is not None:
            return dict(self.node_claim.status.capacity)
        return {}

    def allocatable(self) -> dict:
        if self.node is not None and self.node.status.allocatable:
            return dict(self.node.status.allocatable)
        if self.node_claim is not None:
            return dict(self.node_claim.status.allocatable)
        return {}

    def taints(self) -> list:
        """Scheduling-relevant taints: known-ephemeral and startup taints are
        filtered until the node is initialized (statenode.go:279-309)."""
        raw = list(self.node.taints) if self.node is not None else (
            list(self.node_claim.spec.taints) if self.node_claim else []
        )
        if self.initialized():
            return raw
        startup = (
            list(self.node_claim.spec.startup_taints)
            if self.node_claim is not None
            else []
        )
        out = []
        for t in raw:
            if any(
                t.key == e.key and t.effect == e.effect
                for e in KNOWN_EPHEMERAL_TAINTS
            ):
                continue
            if any(t == s for s in startup):
                continue
            out.append(t)
        return out

    def nominate(self, until: float) -> None:
        self.nominated_until = until

    def nominated(self, now: float) -> bool:
        return self.nominated_until > now


class Cluster:
    """(cluster.go:48-88)"""

    def __init__(self, kube, clock: Optional[Clock] = None):
        self.kube = kube
        self.clock = clock or Clock()
        self.state_nodes: Dict[str, StateNode] = {}  # provider_id (or name)
        self.bindings: Dict[str, str] = {}  # pod key -> node name
        self._pods: Dict[str, Pod] = {}  # pod key -> pod
        self._consolidated_at = 0.0
        self._unconsolidated_at = self.clock.now()
        kube.watch(self._on_event)
        self.sync()

    # -- informer seam ----------------------------------------------------

    def _on_event(self, event: str, kind: str, obj) -> None:
        if kind == "Node":
            if event == "DELETED":
                self._forget_node(obj)
            else:
                self.update_node(obj)
        elif kind == "NodeClaim":
            if event == "DELETED":
                self._forget_nodeclaim(obj)
            else:
                self.update_nodeclaim(obj)
        elif kind == "Pod":
            if event == "DELETED":
                self.delete_pod(obj)
            else:
                self.update_pod(obj)
        if kind in ("Node", "NodeClaim", "NodePool"):
            self.mark_unconsolidated()

    def sync(self) -> None:
        """Full resync from the store (the reference's cache-sync gate,
        cluster.go:96-150, is a superset check; with a synchronous store a
        rebuild is exact)."""
        self.state_nodes = {}
        self.bindings = {}
        self._pods = {}
        for claim in self.kube.list_nodeclaims():
            self.update_nodeclaim(claim)
        for node in self.kube.list_nodes():
            self.update_node(node)
        for pod in self.kube.list_pods():
            self.update_pod(pod)

    def synced(self) -> bool:
        return True  # synchronous store: watch events apply inline

    # -- node/claim bookkeeping -------------------------------------------

    def _key_for(self, provider_id: str, name: str) -> str:
        return provider_id or f"name:{name}"

    def update_node(self, node: Node) -> None:
        key = self._key_for(node.provider_id, node.name)
        sn = self.state_nodes.get(key)
        if sn is None:
            # adopt a claim-only entry whose provider id matches
            sn = self.state_nodes.pop(self._key_for("", node.name), None)
            if sn is None:
                sn = StateNode()
            self.state_nodes[key] = sn
        sn.node = node
        if node.metadata.deletion_timestamp is not None:
            sn.marked_for_deletion = True

    def update_nodeclaim(self, claim: NodeClaim) -> None:
        key = self._key_for(
            claim.status.provider_id, claim.status.node_name or claim.name
        )
        sn = self.state_nodes.get(key)
        if sn is None:
            # adopt the pre-launch name-keyed entry once the claim gains a
            # provider id / node name, so one machine never has two entries
            for stale_key in (
                self._key_for("", claim.name),
                self._key_for("", claim.status.node_name),
            ):
                if stale_key != key and stale_key in self.state_nodes:
                    stale = self.state_nodes[stale_key]
                    if stale.node_claim is claim or (
                        stale.node_claim is not None
                        and stale.node_claim.name == claim.name
                    ):
                        sn = self.state_nodes.pop(stale_key)
                        break
            if sn is None:
                sn = StateNode()
            self.state_nodes[key] = sn
        sn.node_claim = claim
        if claim.metadata.deletion_timestamp is not None:
            sn.marked_for_deletion = True

    def _forget_node(self, node: Node) -> None:
        key = self._key_for(node.provider_id, node.name)
        sn = self.state_nodes.get(key)
        if sn is None:
            return
        if sn.node_claim is None:
            del self.state_nodes[key]
        else:
            sn.node = None

    def _forget_nodeclaim(self, claim: NodeClaim) -> None:
        key = self._key_for(
            claim.status.provider_id, claim.status.node_name or claim.name
        )
        sn = self.state_nodes.get(key)
        if sn is None:
            return
        if sn.node is None:
            del self.state_nodes[key]
        else:
            sn.node_claim = None

    # -- pods -------------------------------------------------------------

    def update_pod(self, pod: Pod) -> None:
        key = pod.key()
        self._pods[key] = pod
        if pod.node_name:
            self.bindings[key] = pod.node_name
        else:
            self.bindings.pop(key, None)

    def delete_pod(self, pod: Pod) -> None:
        self._pods.pop(pod.key(), None)
        self.bindings.pop(pod.key(), None)

    def pods_on_node(self, node_name: str) -> List[Pod]:
        return [
            self._pods[k]
            for k, n in self.bindings.items()
            if n == node_name and k in self._pods
        ]

    def nominate_node(self, node_name: str, until: float) -> None:
        """Mark the named node nominated (pending binds en route): the
        disruption candidate filter skips it until the TTL elapses
        (disruption/types.py; statenode nomination — the provisioner
        calls this for every existing-node placement it returns)."""
        for sn in self.state_nodes.values():
            if sn.name == node_name:
                sn.nominate(max(until, sn.nominated_until))
                return

    def clear_node_nomination(self, node_name: str) -> None:
        """Drop the named node's nomination early: the binder calls this
        once EVERY pod nominated onto the node has bound — the
        protection window has served its purpose, and consolidation
        should not wait out the TTL backstop."""
        for sn in self.state_nodes.values():
            if sn.name == node_name:
                sn.nominated_until = 0.0
                return

    def nomination_wait_remaining(self) -> float:
        """Seconds until the nearest node-nomination TTL lapses (0 when
        none): a fake-clock driver (run_until_idle, the twin) elapses it
        like the batcher/backoff/validation timers so consolidation is
        dampened by the window, never parked behind it."""
        now = self.clock.now()
        waits = [
            sn.nominated_until - now
            for sn in self.state_nodes.values()
            if sn.nominated_until > now
        ]
        return min(waits) if waits else 0.0

    # -- consolidation bookkeeping (cluster.go:397-423) --------------------

    def mark_unconsolidated(self) -> None:
        self._unconsolidated_at = self.clock.now()

    def mark_consolidated(self) -> None:
        self._consolidated_at = self.clock.now()

    def consolidated(self) -> bool:
        """5-minute forced refresh even when nothing changed."""
        if self.clock.since(self._consolidated_at) > 300.0:
            return False
        return self._consolidated_at > self._unconsolidated_at

    # -- snapshots for the scheduler --------------------------------------

    def nodes(self) -> List[StateNode]:
        return list(self.state_nodes.values())

    def sim_nodes(self, include_deleting: bool = False) -> List[SimNode]:
        """SimNode views for schedulable (registered, non-deleting) nodes
        (scheduler.go:318-354 existing-node build)."""
        out = []
        for sn in self.state_nodes.values():
            if sn.node is None or not sn.registered():
                continue
            if (sn.deleting() or sn.marked_for_deletion) and not include_deleting:
                continue
            pods = self.pods_on_node(sn.name)
            used = resutil.requests_for_pods(*[p for p in pods if not p.is_daemonset])
            daemon = resutil.requests_for_pods(*[p for p in pods if p.is_daemonset])
            alloc = sn.allocatable()
            available = resutil.subtract(alloc, resutil.merge(used, daemon))
            available["pods"] = alloc.get("pods", 0.0) - len(pods)
            out.append(
                SimNode(
                    name=sn.name,
                    labels=dict(sn.labels),
                    taints=sn.taints(),
                    available=available,
                    capacity=sn.capacity(),
                    daemon_requests=daemon,
                    initialized=sn.initialized(),
                    nodeclaim_name=sn.node_claim.name if sn.node_claim else "",
                    nodepool_name=sn.nodepool_name,
                    evictable=self._evictable_on(pods),
                )
            )
        return out

    @staticmethod
    def _evictable_on(pods) -> tuple:
        """Bound pods a preemptive solve may evict (gangsched, ISSUE 10):
        reschedulable non-daemonset pods, as capacity views carrying the
        disruption-cost victim ordering. The tier-legality rule (only
        strictly-lower tiers are evictable) is applied at USE — the kernel
        masks by the contending class's tier — so the view is
        priority-complete, not pre-filtered."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
            EvictablePod,
        )
        from karpenter_core_tpu_torch.utils import pod as podutil
        from karpenter_core_tpu_torch.utils.disruption import (
            eviction_cost,
            priority_tier,
        )

        return tuple(
            EvictablePod(
                uid=p.uid,
                priority=priority_tier(p.priority),
                requests=resutil.requests_for_pods(p),
                cost=eviction_cost(p),
            )
            for p in pods
            if not p.is_daemonset and podutil.is_reschedulable(p)
        )

    def existing_pod_triples(self) -> List[Tuple[Pod, dict, str]]:
        """(pod, node labels, node name) for topology domain counting
        (topology.go countDomains:274-321)."""
        by_name = {sn.name: sn for sn in self.state_nodes.values() if sn.node}
        out = []
        for key, node_name in self.bindings.items():
            pod = self._pods.get(key)
            sn = by_name.get(node_name)
            if pod is None or sn is None:
                continue
            out.append((pod, dict(sn.labels), node_name))
        return out

    def pods_with_anti_affinity(self) -> List[Tuple[Pod, dict, str]]:
        return [
            (p, labels, name)
            for p, labels, name in self.existing_pod_triples()
            if has_required_pod_anti_affinity(p)
        ]
