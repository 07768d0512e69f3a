"""The provisioning solve's verify pass (``models/verify_pass.VerifyPass``)
against the verbatim ``solver/verify.ResultVerifier`` it subclasses.

Every case hands one result to both and asserts the same ``(reason,
detail)`` list, in the same order; a case that injects a fault also
asserts that the fault is found.

* Clean results of the plain scan on small backlogs of upstream's diverse
  mix (generic pods, zone and hostname spread cohorts by label, zonal node
  affinity, a nodeSelector, one hostname anti-affinity cohort), alone and
  beside existing nodes with zone labels and a topology context of bound
  pods.
* Faults: a hostname-spread pod moved onto a claim that holds its cohort,
  or a pod of its class added beside it;
  a zone cohort skewed past maxSkew between zone-pinned claims, and by
  the topology context's bound pods; two anti-affinity pods on one claim,
  and two pods of a second anti-affinity cohort beside one of the first;
  foreign options (a copy of a catalog type under its own name passes);
  a selector mismatch; a taint; a capacity overflow; a pod placed twice,
  lost, or unknown; pods moved onto existing nodes.
* What the copy skips: a cohort with a matching pod that does not carry
  the constraint, a constraint with no selector, a cohort on a claim of
  no single zone.
* A seeded batch of random mutations over several backlogs.
"""
import copy
import random

import pytest

from karpenter_core_tpu_torch.api import labels as L
from karpenter_core_tpu_torch.api.nodepool import NodePool, NodePoolSpec
from karpenter_core_tpu_torch.api.objects import (
    Affinity,
    LabelSelector,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    Taint,
    TopologySpreadConstraint,
)
from karpenter_core_tpu_torch.cloudprovider.kwok import KWOK_ZONES, bench_catalog
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (  # noqa: E501
    SimNode,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (  # noqa: E501
    Topology,
)
from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
from karpenter_core_tpu_torch.models.verify_pass import VerifyPass
from karpenter_core_tpu_torch.solver.verify import ResultVerifier
from tests.torch_threads import one_torch_thread  # noqa: F401

GIB = 2.0**30
KINDS = ("generic", "zone_spread", "host_spread", "zonal", "selector",
         "anti")
VALUES = "abcdefg"
ZONES = ("zone-a", "zone-b")
CATALOG = bench_catalog(48)


def _selector(labels):
    return LabelSelector(match_labels=tuple(sorted(labels.items())))


def _spread(key, labels, selector="own"):
    return [TopologySpreadConstraint(
        max_skew=1, topology_key=key, when_unsatisfiable="DoNotSchedule",
        label_selector=_selector(labels) if selector == "own" else selector)]


def _pod(name, kind, value, rng):
    """One pod of the diverse mix: a spread pod's selector matches its own
    cohort label (app=<kind>-<value>); the anti-affinity pods share one."""
    kw = {}
    labels = {}
    if kind in ("zone_spread", "host_spread"):
        labels = {"app": f"{kind}-{value}"}
        key = L.LABEL_TOPOLOGY_ZONE if kind == "zone_spread" else (
            L.LABEL_HOSTNAME)
        kw["topology_spread_constraints"] = _spread(key, labels)
    elif kind == "anti":
        labels = {"app": "anti"}
        kw["affinity"] = Affinity(pod_anti_affinity=PodAffinity(required=[
            PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                            label_selector=_selector(labels))]))
    elif kind == "zonal":
        kw["affinity"] = Affinity(node_affinity=NodeAffinity(required=[
            NodeSelectorTerm(match_expressions=(NodeSelectorRequirement(
                L.LABEL_TOPOLOGY_ZONE, "In", ZONES),))]))
    elif kind == "selector":
        kw["node_selector"] = {L.LABEL_OS: "linux"}
    return Pod(
        metadata=ObjectMeta(name=name, labels=labels),
        resource_requests={"cpu": rng.choice([0.1, 0.25, 0.5, 1.0]),
                           "memory": rng.choice([0.25, 0.5, 1.0]) * GIB},
        **kw)


def _backlog(seed, n):
    rng = random.Random(seed)
    return [_pod(f"s{seed}-p{i}", KINDS[i % len(KINDS)],
                 rng.choice(VALUES), rng) for i in range(n)]


def _pool():
    pool = NodePool(metadata=ObjectMeta(name="default"))
    pool.spec = NodePoolSpec()
    return pool


def _nodes():
    """Four existing nodes, two a zone, with room for a few pods."""
    return [SimNode(
        name=f"node-{i}",
        labels={L.LABEL_TOPOLOGY_ZONE: ZONES[i % 2], L.LABEL_OS: "linux",
                L.LABEL_ARCH: "amd64", L.LABEL_HOSTNAME: f"node-{i}"},
        taints=[], available={"cpu": 2.0, "memory": 4 * GIB, "pods": 20.0},
        capacity={"cpu": 2.0, "memory": 4 * GIB, "pods": 20.0},
    ) for i in range(4)]


def _topology(nodes, n_bound=0, value="a"):
    """A topology context holding ``n_bound`` bound pods of the zone
    cohort ``value`` on the first node, and one unrelated pod a node."""
    bound = []
    for i in range(n_bound):
        p = Pod(metadata=ObjectMeta(
            name=f"bound-{i}", labels={"app": f"zone_spread-{value}"}),
            resource_requests={"cpu": 0.1})
        bound.append((p, dict(nodes[0].labels), nodes[0].name))
    for node in nodes:
        p = Pod(metadata=ObjectMeta(name=f"on-{node.name}",
                                    labels={"app": "other"}),
                resource_requests={"cpu": 0.1})
        bound.append((p, {}, node.name))
    return Topology(domains={L.LABEL_TOPOLOGY_ZONE: set(KWOK_ZONES)},
                    existing_pods=bound)


def _world(seed, n, existing=False, n_bound=0):
    pool = _pool()
    its = {"default": list(CATALOG)}
    nodes = _nodes() if existing else []
    topo = _topology(nodes, n_bound) if existing else None
    pods = _backlog(seed, n)
    sched = DeviceScheduler([pool], its, existing_nodes=nodes, max_slots=128,
                            topology=topo, device="cpu",
                            kernel_backend="reference")
    res = sched.solve(pods)
    return dict(pools=[pool], its=its, nodes=nodes, topo=topo), res, pods


_SOLVED = {}


def _solved(seed, n=90, existing=False):
    """A fresh copy of one solve (the catalog and the pool are shared)."""
    key = (seed, n, existing)
    if key not in _SOLVED:
        _SOLVED[key] = _world(seed, n, existing)
    world, res, pods = _SOLVED[key]
    memo = {id(x): x for x in CATALOG + world["pools"]}
    res, pods, nodes, topo = copy.deepcopy(
        (res, pods, world["nodes"], world["topo"]), memo)
    return dict(world, nodes=nodes, topo=topo), res, pods


def _verdicts(world, res, pods):
    """Both verifiers' (reason, detail) lists; they must be equal."""
    got = []
    for cls in (ResultVerifier, VerifyPass):
        v = cls(world["pools"], world["its"], existing_nodes=world["nodes"],
                topology=world["topo"])
        got.append([(x.reason, x.detail) for x in v.verify(res, pods)])
    assert got[1] == got[0]
    return got[0]


def _reasons(verdicts):
    return {r for r, _d in verdicts}


def _cohort(pod):
    return (pod.metadata.labels or {}).get("app")


def _where(res, pred):
    """(claim, pod) pairs of the result's claims whose pod meets pred."""
    return [(c, p) for c in res.new_node_claims for p in c.pods if pred(p)]


def _zone(claim):
    if not claim.requirements.has(L.LABEL_TOPOLOGY_ZONE):
        return None
    vals = claim.requirements[L.LABEL_TOPOLOGY_ZONE].sorted_values()
    return vals[0] if len(vals) == 1 else None


def _move(pod, src, dst):
    src.pods.remove(pod)
    dst.pods.append(pod)


# -- clean results ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clean_result_verdicts_equal(seed):
    world, res, pods = _solved(seed)
    assert res.new_node_claims and not res.pod_errors
    assert _verdicts(world, res, pods) == []


@pytest.mark.parametrize("seed", [0, 1])
def test_clean_result_with_existing_nodes_and_bound_pods(seed):
    world, res, pods = _solved(seed, existing=True)
    assert any(sim.pods for sim in res.existing_nodes)
    assert world["topo"].existing_pods
    assert _verdicts(world, res, pods) == []


# -- injected faults ----------------------------------------------------------


def test_hostname_spread_pod_onto_its_cohort():
    world, res, pods = _solved(0)
    hs = _where(res, lambda p: (_cohort(p) or "").startswith("host_spread"))
    for (src, p), (dst, q) in ((a, b) for a in hs for b in hs):
        if src is not dst and _cohort(p) == _cohort(q):
            _move(p, src, dst)
            break
    else:
        pytest.fail("no cohort spans two claims")
    got = _verdicts(world, res, pods)
    assert any(r == "spread" and "hostname spread" in d for r, d in got)


def test_hostname_spread_twin_on_its_claim():
    """A second pod of a placed hostname-spread pod's class on its claim:
    the count is of pods, not of classes."""
    world, res, pods = _solved(0)
    (claim, p), *_ = _where(
        res, lambda p: (_cohort(p) or "").startswith("host_spread"))
    twin = copy.deepcopy(p)
    twin.metadata.name = "twin"
    twin.metadata.uid = "twin"
    claim.pods.append(twin)
    pods.append(twin)
    got = _verdicts(world, res, pods)
    assert any(r == "spread" and "2 pods matching hostname spread" in d
               for r, d in got)


def _skew_zone_cohort(res):
    """Move every pod of one zone cohort onto a zone-pinned claim of it:
    the cohort's zone counts skew past maxSkew. Returns the cohort."""
    zs = _where(res, lambda p: (_cohort(p) or "").startswith("zone_spread"))
    by_cohort = {}
    for c, p in zs:
        by_cohort.setdefault(_cohort(p), []).append((c, p))
    for cohort, members in sorted(by_cohort.items()):
        zones = {_zone(c) for c, _p in members}
        if None in zones or len(zones) < 2 or len(members) < 4:
            continue
        dst = members[0][0]
        for c, p in members[1:]:
            if c is not dst:
                _move(p, c, dst)
        return cohort
    pytest.fail("no zone cohort over two pinned zones")


def test_zone_cohort_skewed_between_pinned_claims():
    world, res, pods = _solved(1)
    cohort = _skew_zone_cohort(res)
    got = _verdicts(world, res, pods)
    assert any(r == "spread" and "zone spread" in d and cohort in d
               for r, d in got)


def test_zone_cohort_skewed_by_bound_pods():
    """The topology context's bound pods of a cohort count toward its
    zone: a clean placement skews once enough of them are bound."""
    world, res, pods = _solved(0, existing=True)
    assert _verdicts(world, res, pods) == []
    world["topo"] = _topology(world["nodes"], n_bound=6)
    got = _verdicts(world, res, pods)
    assert any(r == "spread" and "zone_spread-a" in d for r, d in got)


def test_anti_affinity_pods_colocated():
    world, res, pods = _solved(2)
    anti = _where(res, lambda p: _cohort(p) == "anti")
    (src, p), (dst, _q) = next(
        (a, b) for a in anti for b in anti if a[0] is not b[0])
    _move(p, src, dst)
    got = _verdicts(world, res, pods)
    assert sum(r == "anti_affinity" for r, _d in got) >= 2


def test_two_anti_affinity_cohorts_on_one_claim():
    """Two pods of a second anti-affinity cohort join a claim after its
    pod of the first: each selector's matches are its own."""
    world, res, pods = _solved(2)
    (claim, _p), *_ = _where(res, lambda p: _cohort(p) == "anti")
    labels = {"app": "anti-b"}
    for i in range(2):
        p = Pod(metadata=ObjectMeta(name=f"anti-b-{i}", labels=labels),
                resource_requests={"cpu": 0.1},
                affinity=Affinity(pod_anti_affinity=PodAffinity(required=[
                    PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                                    label_selector=_selector(labels))])))
        claim.pods.append(p)
        pods.append(p)
    got = _verdicts(world, res, pods)
    assert [d for r, d in got if r == "anti_affinity"] == [
        f"claim[{res.new_node_claims.index(claim)}]: pod 'anti-b-{i}'"
        " co-located with a pod matching its required hostname"
        " anti-affinity selector" for i in range(2)]


def test_foreign_options():
    """A type outside the catalog is foreign; a different object that
    carries a catalog type's name is not (the copy tests by name), also
    when a whole option list is such copies. A foreign list as long as a
    clean one seen before is still tested."""
    world, res, pods = _solved(0)
    claims = res.new_node_claims
    assert len(claims) >= 4
    claims[0].instance_type_options = [
        copy.copy(it) for it in claims[0].instance_type_options]
    claims[1].instance_type_options.append(copy.copy(CATALOG[0]))
    assert _verdicts(world, res, pods) == []
    same = [c for c in claims[2:] if len(c.instance_type_options) == len(
        claims[0].instance_type_options)]
    target = same[-1] if same else claims[-1]
    foreign = copy.copy(target.instance_type_options[-1])
    foreign.name = "foreign-type"
    target.instance_type_options[-1] = foreign
    got = _verdicts(world, res, pods)
    assert any(r == "structure" and "foreign-type" in d for r, d in got)


def test_selector_mismatch():
    world, res, pods = _solved(1)
    (_c, p), *_ = _where(res, lambda p: bool(p.node_selector))
    p.node_selector = {L.LABEL_OS: "plan9"}
    assert "selector" in _reasons(_verdicts(world, res, pods))


def test_taint():
    world, res, pods = _solved(2)
    claim = res.new_node_claims[0]
    claim.template = copy.copy(claim.template)
    claim.template.taints = [Taint(key="dedicated", effect="NoSchedule")]
    assert "taint" in _reasons(_verdicts(world, res, pods))


def test_capacity_overflow():
    world, res, pods = _solved(0)
    dst, *rest = res.new_node_claims
    for c in rest[:8]:
        for p in list(c.pods):
            _move(p, c, dst)
    got = _verdicts(world, res, pods)
    assert {"capacity", "structure"} <= _reasons(got)


def test_pod_placed_twice_lost_and_unknown():
    world, res, pods = _solved(1)
    a, b, c = res.new_node_claims[:3]
    b.pods.append(a.pods[0])
    lost = c.pods.pop()
    c.pods.append(Pod(metadata=ObjectMeta(name="stranger"),
                      resource_requests={"cpu": 0.1}))
    got = _verdicts(world, res, pods)
    assert {"double_place", "conservation", "structure"} <= _reasons(got)
    assert any(lost.metadata.name in d for _r, d in got)


def test_pods_moved_onto_existing_nodes():
    world, res, pods = _solved(1, existing=True)
    sims = res.existing_nodes
    hs = _where(res, lambda p: (_cohort(p) or "").startswith("host_spread"))
    for c, p in hs[:6]:
        c.pods.remove(p)
        sims[0].pods.append(p)
    got = _verdicts(world, res, pods)
    assert any(r == "spread" and d.startswith("node[") for r, d in got)


# -- what the copy skips ------------------------------------------------------


@pytest.mark.parametrize("spread", [False, True])
def test_cohort_with_an_uncarrying_match_is_skipped(spread):
    """A pod that matches a zone cohort's selector without carrying the
    constraint (it has no spread constraint, or a hostname one) makes the
    cohort unattributable: its skew is not reported."""
    world, res, pods = _solved(1)
    cohort = _skew_zone_cohort(res)
    labels = {"app": cohort}
    intruder = Pod(metadata=ObjectMeta(name="intruder", labels=labels),
                   resource_requests={"cpu": 0.1},
                   topology_spread_constraints=_spread(
                       L.LABEL_HOSTNAME, labels) if spread else [])
    res.new_node_claims[-1].pods.append(intruder)
    pods.append(intruder)
    got = _verdicts(world, res, pods)
    assert not any(r == "spread" and cohort in d for r, d in got)


def test_constraint_without_selector_is_skipped():
    world, res, pods = _solved(0)
    hs = _where(res, lambda p: (_cohort(p) or "").startswith("host_spread"))
    dst = hs[0][0]
    for c, p in hs[1:]:
        p.topology_spread_constraints = _spread(L.LABEL_HOSTNAME, {}, None)
        if c is not dst:
            _move(p, c, dst)
    dst.pods[0].topology_spread_constraints = _spread(
        L.LABEL_HOSTNAME, {}, None)
    got = _verdicts(world, res, pods)
    assert not any(r == "spread" for r, _d in got)


def test_cohort_on_a_claim_of_no_single_zone_is_skipped():
    world, res, pods = _solved(1)
    cohort = _skew_zone_cohort(res)
    loose = next(c for c in res.new_node_claims if _zone(c) is None)
    (src, p), *_ = _where(res, lambda p: _cohort(p) == cohort)
    _move(p, src, loose)
    got = _verdicts(world, res, pods)
    assert not any(r == "spread" and cohort in d for r, d in got)


# -- random mutations ---------------------------------------------------------


def _mutate(res, pods, rng):
    """One random edit of the result or of a pod."""
    claims = res.new_node_claims
    groups = [c.pods for c in claims] + [s.pods for s in res.existing_nodes]
    full = [g for g in groups if g]
    op = rng.choice(("move", "move", "cohort", "cohort", "copy", "drop",
                     "relabel", "unspread", "options"))
    if op == "cohort":
        cohort = [(c, p) for c in claims for p in c.pods
                  if "spread" in (_cohort(p) or "")]
        if cohort:
            src, p = rng.choice(cohort)
            src.pods.remove(p)
            rng.choice(groups).append(p)
    elif op in ("move", "copy"):
        src = rng.choice(full)
        p = rng.choice(src)
        if op == "move":
            src.remove(p)
        rng.choice(groups).append(p)
    elif op == "drop":
        src = rng.choice(full)
        src.remove(rng.choice(src))
    elif op == "relabel":
        p = rng.choice(pods)
        p.metadata.labels = {"app": rng.choice(
            ["anti", "other"] + [f"{k}-{v}" for k in ("zone_spread",
                                                      "host_spread")
                                 for v in VALUES])}
    elif op == "unspread":
        p = rng.choice(pods)
        p.topology_spread_constraints = []
    else:
        c = rng.choice(claims)
        if c.instance_type_options:
            c.instance_type_options.pop(rng.randrange(
                len(c.instance_type_options)))


@pytest.mark.parametrize("seed", range(12))
def test_random_mutations(seed):
    rng = random.Random(1000 + seed)
    world, res, pods = _solved(seed % 3, existing=seed % 2 == 1)
    for _ in range(rng.randint(1, 8)):
        _mutate(res, pods, rng)
    _verdicts(world, res, pods)
