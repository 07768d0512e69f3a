"""The existing nodes' rows of a prepare, built in bulk from their labels.

``DeviceScheduler._fp_entry`` builds the existing-node planes
(``ex_valmask``, ``ex_defines``, ``ex_complement``, ``ex_negative``,
``ex_gt``, ``ex_lt``) and the ``ex_requests`` / ``ex_capacity`` rows for
all nodes at once (``_node_label_planes``, ``_node_resource_rows``). They
must equal, bit for bit, the per-node encoding they replace, kept here as
the oracle: ``encode_requirements_batch`` over ``Requirements.from_labels``,
``_neutralize``, then one row a node, its requests ``rvec`` of the daemon
overhead less the node's daemon requests floored at zero, its capacity
``rvec_cap`` of what it has available. The nodes are seeded and random:
well-known and custom keys, a key beside its deprecated alias (agreeing
and disagreeing), integer values on a key a pod bounds with Gt/Lt, a node
without labels, taints, daemon requests above and below the overhead, and
resources off the axis. ``_vocab_universe`` must give the base sets that
the nodes' ``Requirements.from_labels`` gave.
"""
import random

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu_torch.api import labels as L
from karpenter_core_tpu_torch.api.nodepool import NodePool, NodePoolSpec
from karpenter_core_tpu_torch.api.objects import (
    Affinity,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    Taint,
    Toleration,
)
from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
    SimNode,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
    Topology,
)
from karpenter_core_tpu_torch.models import provisioner as prov
from karpenter_core_tpu_torch.scheduling import Requirements
from karpenter_core_tpu_torch.solver.vocab import encode_requirements_batch
from karpenter_core_tpu_torch.utils import resources as resutil

GIB = 2.0**30
GEN = "example.com/generation"
RACK = "example.com/rack"
TEAM = "team"
DEPRECATED_ZONE = "failure-domain.beta.kubernetes.io/zone"
DEPRECATED_ARCH = "beta.kubernetes.io/arch"
PLANES = ("ex_valmask", "ex_defines", "ex_complement", "ex_negative",
          "ex_gt", "ex_lt", "ex_requests", "ex_capacity")


def _pool():
    pool = NodePool(metadata=ObjectMeta(name="default"))
    pool.spec = NodePoolSpec()
    return pool


def _node(rng: random.Random, i: int, kind: str) -> SimNode:
    labels = {}
    if kind != "bare":
        if rng.random() < 0.8:
            labels[L.LABEL_TOPOLOGY_ZONE] = rng.choice(
                ["zone-a", "zone-b", "zone-c"])
        if rng.random() < 0.7:
            labels[L.LABEL_HOSTNAME] = f"node-{i}"
        if rng.random() < 0.6:
            labels[L.LABEL_ARCH] = rng.choice(["amd64", "arm64"])
        if rng.random() < 0.5:
            labels[L.CAPACITY_TYPE_LABEL_KEY] = rng.choice(
                ["spot", "on-demand"])
        if rng.random() < 0.5:
            labels[L.NODEPOOL_LABEL_KEY] = "default"
        if rng.random() < 0.5:
            labels[TEAM] = rng.choice(["a", "b", "c", "d"])
        if rng.random() < 0.5:
            labels[GEN] = str(rng.randint(1, 12))
        if rng.random() < 0.3:
            labels[RACK] = f"r{rng.randint(0, 9)}"
        if rng.random() < 0.2:  # a deprecated key alone
            labels[DEPRECATED_ARCH] = rng.choice(["amd64", "arm64"])
            labels.pop(L.LABEL_ARCH, None)
    if kind == "alias_agree":
        labels[L.LABEL_TOPOLOGY_ZONE] = "zone-b"
        labels[DEPRECATED_ZONE] = "zone-b"
    elif kind == "alias_disagree":
        labels[DEPRECATED_ZONE] = "zone-a"
        labels[L.LABEL_TOPOLOGY_ZONE] = "zone-c"
    taints = []
    if rng.random() < 0.3:
        taints.append(Taint(key="batch", effect="NoSchedule"))
    daemon = {}
    roll = rng.random()
    if roll < 0.3:  # below the overhead
        daemon = {"cpu": 0.05, "memory": 0.1 * GIB}
    elif roll < 0.6:  # above it, and a resource off the overhead
        daemon = {"cpu": 2.0, "pods": 9.0, "example.com/disk": 2.0}
    available = {
        "cpu": rng.choice([0.0, 0.35, 1.5, 3.999, 7.25]),
        "memory": rng.choice([0.0, 0.5, 3.3, 15.75]) * GIB,
        "pods": float(rng.randint(0, 110)),
    }
    if rng.random() < 0.4:  # off the resource axis
        available["example.com/fpga"] = 4.0
    if rng.random() < 0.3:
        available["ephemeral-storage"] = rng.choice([10.0, 100.5]) * GIB
    return SimNode(name=f"node-{i:04d}", labels=labels, taints=taints,
                   available=available, capacity=dict(available),
                   daemon_requests=daemon, initialized=rng.random() < 0.9)


def _nodes(n: int, seed: int):
    rng = random.Random(seed)
    kinds = ["plain"] * n
    if n >= 4:
        kinds[1], kinds[2], kinds[3] = "alias_agree", "alias_disagree", "bare"
    elif n == 1:
        kinds[0] = "alias_disagree" if seed % 2 else "plain"
    return [_node(rng, i, k) for i, k in enumerate(kinds)]


def _daemons():
    """One daemon every node and template takes, one only on team ``a``
    nodes, whose ``example.com/nic`` no template's overhead puts on the
    resource axis."""
    return [
        Pod(metadata=ObjectMeta(name="everywhere"),
            resource_requests={"cpu": 0.2, "memory": 0.25 * GIB,
                               "hugepages-2Mi": 64 * 2.0**20},
            tolerations=[Toleration(operator="Exists")], is_daemonset=True),
        Pod(metadata=ObjectMeta(name="team-a"),
            resource_requests={"cpu": 0.5, "example.com/nic": 1.0},
            node_selector={TEAM: "a"}, is_daemonset=True),
    ]


def _pods():
    """Plain pods, and pods that bound ``GEN`` with Gt/Lt and pick a team."""
    def pod(i, reqs=()):
        affinity = None
        if reqs:
            affinity = Affinity(node_affinity=NodeAffinity(required=[
                NodeSelectorTerm(match_expressions=tuple(
                    NodeSelectorRequirement(k, op, tuple(vals))
                    for k, op, vals in reqs))]))
        return Pod(metadata=ObjectMeta(name=f"p{i}"),
                   resource_requests={"cpu": 0.25 * (1 + i % 3),
                                      "memory": 0.5 * GIB},
                   affinity=affinity)

    return ([pod(i) for i in range(6)]
            + [pod(6, [(GEN, "Gt", ["4"])]),
               pod(7, [(GEN, "Lt", ["9"]), (TEAM, "In", ["a", "b"])])])


def _scheduler(n_nodes: int, seed: int):
    return prov.DeviceScheduler(
        [_pool()], {"default": build_catalog()[:12]},
        existing_nodes=_nodes(n_nodes, seed), daemonset_pods=_daemons(),
        max_slots=512, device="cpu", kernel_backend="reference")


def _per_node(sched, frozen, entry) -> dict:
    """The rows as the per-node path built them."""
    nodes = sched.existing_nodes
    E, K, V, R = len(nodes), frozen.K, frozen.V, entry["R"]
    out = dict(
        ex_valmask=np.ones((E, K, V), dtype=bool),
        ex_defines=np.zeros((E, K), dtype=bool),
        ex_complement=np.ones((E, K), dtype=bool),
        ex_negative=np.ones((E, K), dtype=bool),
        ex_gt=np.full((E, K), prov.GT_NONE, dtype=np.int32),
        ex_lt=np.full((E, K), prov.LT_NONE, dtype=np.int32),
        ex_requests=np.zeros((E, R), dtype=np.float32),
        ex_capacity=np.zeros((E, R), dtype=np.float32),
    )
    if not E:
        return out
    masks = prov._neutralize(encode_requirements_batch(
        frozen, [Requirements.from_labels(n.labels) for n in nodes]))
    for ei, node in enumerate(nodes):
        remaining = resutil.subtract(
            sched._node_daemon_overhead(node), node.daemon_requests)
        for k in list(remaining):
            if remaining[k] < 0:
                remaining[k] = 0.0
        out["ex_requests"][ei] = entry["rvec"](remaining)
        out["ex_capacity"][ei] = entry["rvec_cap"](node.available)
        out["ex_valmask"][ei] = masks.mask[ei]
        out["ex_defines"][ei] = masks.defines[ei]
        out["ex_complement"][ei] = np.where(
            masks.defines[ei], ~masks.concrete[ei], True)
        out["ex_negative"][ei] = np.where(
            masks.defines[ei], masks.negative[ei], True)
        out["ex_gt"][ei] = masks.gt[ei]
        out["ex_lt"][ei] = masks.lt[ei]
    return out


def _prepared(n_nodes: int, seed: int):
    sched = _scheduler(n_nodes, seed)
    prep = sched._prepare(_pods(), 512, Topology())
    entry, _ = sched._fp_entry(prep.vocab, prep.resource_names)
    return sched, prep, entry


def _bit_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


@pytest.mark.parametrize("n_nodes,seed", [
    (0, 1), (1, 2), (1, 3), (9, 4), (40, 5), (300, 6)])
def test_bulk_rows_equal_the_per_node_rows(n_nodes, seed):
    sched, prep, entry = _prepared(n_nodes, seed)
    assert entry["E"] == n_nodes
    want = _per_node(sched, prep.vocab, entry)
    for name in PLANES:
        assert _bit_equal(entry[name], want[name]), name
    # the cases the nodes are meant to cover did occur
    if n_nodes >= 40:
        keys = prep.vocab.keys
        assert {GEN, TEAM, RACK, L.LABEL_HOSTNAME} <= set(keys)
        assert "hugepages-2Mi" in prep.resource_names
        assert "example.com/nic" not in prep.resource_names
        assert "example.com/fpga" not in prep.resource_names
        zone = keys[L.LABEL_TOPOLOGY_ZONE]
        # the scheduler sorts its nodes; find the special ones by name
        row = {n.name: i for i, n in enumerate(sched.existing_nodes)}
        agree, disagree, bare = (row[f"node-{i:04d}"] for i in (1, 2, 3))
        # the disagreeing alias pair leaves an empty, negative zone row
        assert entry["ex_defines"][disagree, zone]
        assert not entry["ex_valmask"][disagree, zone].any()
        assert entry["ex_negative"][disagree, zone]
        # the agreeing pair is zone-b alone; the bare node defines nothing
        zb = prep.vocab.values[zone]["zone-b"]
        assert np.flatnonzero(
            entry["ex_valmask"][agree, zone]).tolist() == [zb]
        assert not entry["ex_defines"][bare].any()
        # daemon requests above the overhead floor at zero, below it not
        over = [sched._node_daemon_overhead(n) for n in sched.existing_nodes]
        cpu = prep.resource_names.index("cpu")
        floored = [i for i, n in enumerate(sched.existing_nodes)
                   if n.daemon_requests.get("cpu", 0.0) > over[i]["cpu"]]
        kept = [i for i, n in enumerate(sched.existing_nodes)
                if 0 < n.daemon_requests.get("cpu", 0.0) < over[i]["cpu"]]
        assert floored and kept
        assert (entry["ex_requests"][floored, cpu] == 0).all()
        assert (entry["ex_requests"][kept, cpu] > 0).all()
        # a pod bounds GEN, so its integer values carry Gt/Lt meaning
        gen = keys[GEN]
        assert (prep.vocab.int_values[gen][:len(prep.vocab.value_names[gen])]
                != prov.LT_NONE).all()


@pytest.mark.parametrize("n_nodes,seed", [(1, 3), (40, 5), (300, 6)])
def test_alias_nodes_alone(n_nodes, seed):
    """Only nodes holding a key beside its deprecated alias are encoded one
    at a time; a deprecated key alone goes through the bulk pass."""
    sched, prep, _ = _prepared(n_nodes, seed)
    alone = [i for i, n in enumerate(sched.existing_nodes)
             if prov._label_alias(n.labels)]
    planes, n_alone = sched._node_label_planes(prep.vocab)
    assert n_alone == len(alone)
    assert set(alone) == {i for i, n in enumerate(sched.existing_nodes)
                          if n.name in ("node-0001", "node-0002")
                          or (n_nodes == 1 and DEPRECATED_ZONE in n.labels)}
    assert any(DEPRECATED_ARCH in n.labels for n in sched.existing_nodes) == (
        n_nodes >= 40)


def test_value_outside_the_vocab():
    """A node whose label value the vocab lacks (its nodes swapped after
    the universe was taken) is encoded alone, as the per-node path did."""
    sched, prep, entry = _prepared(40, 5)
    node = sched.existing_nodes[7]
    node.labels = dict(node.labels, **{L.LABEL_TOPOLOGY_ZONE: "zone-z"})
    planes, n_alone = sched._node_label_planes(prep.vocab)
    want = _per_node(sched, prep.vocab, entry)
    for name in planes:
        assert _bit_equal(planes[name], want[name]), name
    assert n_alone == 3  # the two alias pairs and this node
    zone = prep.vocab.keys[L.LABEL_TOPOLOGY_ZONE]
    assert planes["ex_defines"][7, zone]
    assert not planes["ex_valmask"][7, zone].any()


@pytest.mark.parametrize("n_nodes,seed", [(0, 1), (1, 3), (40, 5), (300, 6)])
def test_vocab_universe_from_labels(n_nodes, seed):
    sched = _scheduler(n_nodes, seed)
    base, it_vals = sched._vocab_universe()
    want = {}
    for reqs in (
        [t.requirements for t in sched.templates]
        + [Requirements.from_labels(n.labels) for n in sched.existing_nodes]
        + [off.requirements for it in sched._catalog_union()
           for off in it.offerings]
    ):
        for key, req in reqs.items():
            want.setdefault(key, set()).update(req.values)
    assert base == want
    assert DEPRECATED_ZONE not in base and DEPRECATED_ARCH not in base
