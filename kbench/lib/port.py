"""The program's objects built from the generator's plain rows.

The only module of the harness, with ``entries/``, that touches the
program under test (``karpenter_core_tpu_torch``): its API objects for the
catalog, the NodePool, pods and existing nodes, and the reading of its
answers back into plain rows for the reference.
"""
from __future__ import annotations

from typing import Dict, List

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"


def instance_types(rows: List[Dict]):
    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.cloudprovider.types import (
        InstanceType, Offering, Offerings,
    )
    from karpenter_core_tpu_torch.scheduling import Requirement, Requirements

    out = []
    for t in rows:
        offerings = Offerings()
        for o in t["offerings"]:
            offerings.append(Offering(
                requirements=Requirements([
                    Requirement.new(L.CAPACITY_TYPE_LABEL_KEY, "In",
                                    [o["capacity_type"]]),
                    Requirement.new(L.LABEL_TOPOLOGY_ZONE, "In", [o["zone"]]),
                ]),
                price=o["price"], available=True))
        cts = sorted({o["capacity_type"] for o in t["offerings"]})
        out.append(InstanceType(
            name=t["name"],
            requirements=Requirements([
                Requirement.new(L.LABEL_INSTANCE_TYPE, "In", [t["name"]]),
                Requirement.new(L.LABEL_ARCH, "In", [t["arch"]]),
                Requirement.new(L.LABEL_OS, "In", list(t["os"])),
                Requirement.new(L.LABEL_TOPOLOGY_ZONE, "In", list(t["zones"])),
                Requirement.new(L.CAPACITY_TYPE_LABEL_KEY, "In", cts),
            ]),
            offerings=offerings,
            capacity={"cpu": t["cpu"], "memory": t["memory"],
                      "pods": t["pods"]},
            overhead=dict(t["overhead"]),
        ))
    return out


def nodepool(spec: Dict):
    from karpenter_core_tpu_torch.api.nodepool import NodePool, NodePoolSpec
    from karpenter_core_tpu_torch.api.objects import ObjectMeta

    pool = NodePool(metadata=ObjectMeta(name=spec["name"]))
    pool.spec = NodePoolSpec()
    return pool


def pods(rows: List[Dict], traffic: Dict):
    """One Pod a row; the row's ``kind`` gives its constraints."""
    from karpenter_core_tpu_torch.api.objects import (
        Affinity, LabelSelector, NodeAffinity, NodeSelectorRequirement,
        NodeSelectorTerm, ObjectMeta, Pod, PodAffinity, PodAffinityTerm,
        TopologySpreadConstraint,
    )

    out = []
    for r in rows:
        kw = {}
        labels = {}
        kind = r.get("kind", "generic")
        if kind in ("zone_spread", "host_spread", "anti"):
            labels = {"app": r["cohort"]}
            sel = LabelSelector(match_labels=tuple(sorted(labels.items())))
        if kind == "zonal":
            kw["affinity"] = Affinity(node_affinity=NodeAffinity(required=[
                NodeSelectorTerm(match_expressions=(NodeSelectorRequirement(
                    ZONE, "In", tuple(traffic["zonal_zones"])),))]))
        elif kind == "selector":
            kw["node_selector"] = dict(traffic["selector"])
        elif kind in ("zone_spread", "host_spread"):
            kw["topology_spread_constraints"] = [TopologySpreadConstraint(
                max_skew=1,
                topology_key=ZONE if kind == "zone_spread" else HOSTNAME,
                when_unsatisfiable="DoNotSchedule", label_selector=sel)]
        elif kind == "anti":
            kw["affinity"] = Affinity(pod_anti_affinity=PodAffinity(required=[
                PodAffinityTerm(topology_key=HOSTNAME, label_selector=sel)]))
        elif kind != "generic":
            raise ValueError(f"unknown pod kind {kind!r}")
        out.append(Pod(
            metadata=ObjectMeta(name=r["name"], labels=labels),
            resource_requests={"cpu": r["cpu"], "memory": r["memory"]},
            **kw))
    return out


def sim_nodes(state: Dict, pool_name: str):
    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (  # noqa: E501
        SimNode,
    )

    t = state["node_type"]
    return [SimNode(
        name=n["name"],
        labels={L.LABEL_ARCH: t["arch"], L.LABEL_OS: state["node_os"],
                L.LABEL_TOPOLOGY_ZONE: n["zone"],
                L.NODEPOOL_LABEL_KEY: pool_name,
                L.LABEL_INSTANCE_TYPE: t["name"]},
        taints=[], available=dict(n["available"]),
        capacity=dict(state["capacity"]),
    ) for n in state["nodes"]]


def answer_rows(result, pods) -> Dict:
    """A solve's answer as plain rows: each new NodeClaim's pods, instance
    type options and zone requirement; pods bound to existing
    nodes; the names of the pods left unschedulable (``pods`` is the
    backlog the solve was given)."""
    def values(reqs, key):
        if key not in reqs:
            return None
        req = reqs[key]
        if req.complement:
            return None
        return sorted(req.values)

    name_of = {p.metadata.uid: p.metadata.name for p in pods}
    claims = []
    for c in result.new_node_claims:
        claims.append({
            "pods": [p.metadata.name for p in c.pods],
            "options": [it.name for it in c.instance_type_options],
            "zones": values(c.requirements, ZONE),
        })
    existing = [[p.metadata.name for p in s.pods]
                for s in result.existing_nodes if s.pods]
    return {"claims": claims, "existing": existing,
            "errors": sorted(name_of.get(uid, uid)
                             for uid in result.pod_errors)}
