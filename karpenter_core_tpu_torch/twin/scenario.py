"""Scenario model: the twin's input, as data.

A scenario is everything a twin run depends on — seed, cluster count,
virtual duration, workload waves, fault schedules (chaos rates, ICE
storms, fleet-level faults), and test-only hooks — expressed as frozen
dataclasses with a CANONICAL JSON encoding. Canonical means: stable field
names, lists sorted by their natural keys, ``json.dumps(sort_keys=True)``
with fixed separators — so ``scenario_fingerprint`` is a pure function of
the scenario's content and a shrunk repro committed as a fixture replays
byte-for-byte. The GL201/GL202 determinism lint family covers this module
(tools/graftlint/rules/determinism.py): unordered iteration or unsorted
json.dumps in these encoders fails lint, not a code review.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Tuple

SCENARIO_VERSION = 1


@dataclass(frozen=True)
class WorkloadWave:
    """One arrival wave of a workload class at virtual offset ``at``.

    ``kind`` shapes the pods (twin/workloads.py): ``training`` emits
    gang-annotated pods (``gang_size`` per gang, all-or-nothing),
    ``serving`` emits replica pods under a PodDisruptionBudget
    (``min_available``), ``batch`` emits preemptible filler. ``lifetime``
    schedules the whole wave's deletion (serving churn / batch drain);
    0 keeps it forever. ``max_hops`` >= 0 makes a training wave
    comms-sensitive (topoaware, ISSUE 20): every gang declares that hard
    network-hop bound and every member carries its rank annotation, so
    the solver must place the gang rank-adjacent within the bound; -1
    (default) leaves the gang distance-blind — byte-identical pods to
    the pre-topoaware twin."""

    at: float
    cluster: int
    kind: str  # training | serving | batch
    count: int
    cpu: float = 0.5
    memory_gib: float = 1.0
    gang_size: int = 0
    priority: int = 0
    lifetime: float = 0.0
    min_available: int = 0
    max_hops: int = -1


@dataclass(frozen=True)
class Storm:
    """An ICE window: the head of the cluster's catalog is stocked out in
    the named zones/capacity types during [start, start+duration) of
    virtual time (materialized as chaos.IceStorm against the cluster's
    own catalog; cluster -1 storms every cluster)."""

    start: float
    duration: float
    cluster: int = -1
    head: int = 4
    zones: Tuple[str, ...] = ("zone-a", "zone-b")
    capacity_types: Tuple[str, ...] = ("spot",)


@dataclass(frozen=True)
class FleetFault:
    """A fleet-tier fault at virtual offset ``at``:

    * ``murder`` — member ``member``'s daemon is torn down mid-window (an
      in-flight or subsequent solve sees the transport die) and respawns
      one tick later with empty caches and a fresh instance id;
    * ``partition`` — operator ``cluster`` (-1 = all) cannot reach the
      fleet for ``duration`` virtual seconds (every RPC fails as a
      transport fault: retries, breaker charges, greedy degradation);
    * ``amnesia`` — member ``member``'s segment store forgets everything
      (the delta wire's miss/re-upload handshake must repair it)."""

    at: float
    kind: str  # murder | partition | amnesia
    member: int = 0
    cluster: int = -1
    duration: float = 0.0


@dataclass(frozen=True)
class TestHook:
    """A test-only invariant saboteur (the shrinker demo rides it): at
    virtual offset ``at``, ``lose_bound_pod`` silently deletes one bound
    pod from cluster ``cluster``'s store WITHOUT telling the workload
    bookkeeping — the exact defect shape an operator bug that drops a
    binding would produce, guaranteed to trip pod conservation."""

    at: float
    kind: str  # lose_bound_pod
    cluster: int = 0

    # not a pytest class, despite the Test- name
    __test__ = False


@dataclass(frozen=True)
class Scenario:
    seed: int = 0
    clusters: int = 1
    duration: float = 300.0
    tick: float = 30.0
    solver: str = "greedy"  # greedy | tpu
    # 0 = solves run in-process; N >= 1 = N in-thread solverd members
    # shared by every cluster through a FleetRouter (requires solver=tpu)
    fleet: int = 0
    wire: str = "delta"  # delta | full (fleet mode's request wire)
    # incremental re-solve (incsolve, ISSUE 16): clients name their prior
    # solve's fingerprint on every request so the solverd tier's
    # PackingLedger warm-starts churn-proportional re-solves (requires a
    # fleet tier — the ledger lives daemon-side)
    incremental: bool = False
    # elastic tier (fleetscale, ISSUE 17): the TierAutoscaler sizes the
    # fleet between [fleet_min or 1, fleet_max or fleet] on the virtual
    # clock, from the scenario's own deterministic backlog signal.
    # ``fleet`` stays the STARTING size; fleet faults may then name any
    # member index up to the max bound (out-of-range at fire time skips
    # deterministically — the member it targeted was never grown or was
    # already retired)
    autoscale: bool = False
    fleet_min: int = 0
    fleet_max: int = 0
    # SLO bound doubling as the starvation invariant: an expected pod
    # pending longer than this at a stable tick is a violation
    max_pending: float = 600.0
    # rack topology (topoaware, ISSUE 20): N >= 1 makes every cluster's
    # kwok provider stamp created nodes with deterministic rack (and
    # superpod) labels — racks of N nodes per zone, superpods of two
    # racks — so gang placements become hop-attributable; 0 (default)
    # keeps catalogs rack-less and the whole topo layer disengaged
    rack_size: int = 0
    rates: Dict[str, float] = field(default_factory=dict)
    waves: Tuple[WorkloadWave, ...] = ()
    storms: Tuple[Storm, ...] = ()
    fleet_faults: Tuple[FleetFault, ...] = ()
    hooks: Tuple[TestHook, ...] = ()


def _encode_items(items, cls) -> list:
    """Each dataclass item as a plain dict, the list sorted by the
    dataclass's own field order (natural key = (at/start, ...)): encoding
    order never depends on construction order."""
    names = [f.name for f in dataclasses.fields(cls)]
    rows = []
    for item in sorted(items, key=dataclasses.astuple):
        row = {}
        for name in names:
            value = getattr(item, name)
            row[name] = list(value) if isinstance(value, tuple) else value
        rows.append(row)
    return rows


def encode_scenario(s: Scenario) -> dict:
    return {
        "version": SCENARIO_VERSION,
        "seed": s.seed,
        "clusters": s.clusters,
        "duration": s.duration,
        "tick": s.tick,
        "solver": s.solver,
        "fleet": s.fleet,
        "wire": s.wire,
        "incremental": s.incremental,
        "autoscale": s.autoscale,
        "fleet_min": s.fleet_min,
        "fleet_max": s.fleet_max,
        "max_pending": s.max_pending,
        "rack_size": s.rack_size,
        "rates": dict(sorted(s.rates.items())),
        "waves": _encode_items(s.waves, WorkloadWave),
        "storms": _encode_items(s.storms, Storm),
        "fleet_faults": _encode_items(s.fleet_faults, FleetFault),
        "hooks": _encode_items(s.hooks, TestHook),
    }


def scenario_to_json(s: Scenario) -> str:
    return json.dumps(
        encode_scenario(s), sort_keys=True, separators=(",", ":")
    )


def _decode_items(rows, cls) -> tuple:
    names = {f.name for f in dataclasses.fields(cls)}
    out = []
    for row in rows or []:
        kwargs = {}
        for key in sorted(row):
            if key not in names:
                raise ValueError(
                    f"unknown {cls.__name__} field {key!r} in scenario"
                )
            value = row[key]
            kwargs[key] = tuple(value) if isinstance(value, list) else value
        out.append(cls(**kwargs))
    return tuple(sorted(out, key=dataclasses.astuple))


def decode_scenario(data: dict) -> Scenario:
    version = data.get("version", SCENARIO_VERSION)
    if version != SCENARIO_VERSION:
        raise ValueError(f"unknown scenario version {version!r}")
    known = {f.name for f in dataclasses.fields(Scenario)}
    bogus = sorted(set(data) - known - {"version"})
    if bogus:
        # a typo'd field silently ignored would replay a DIFFERENT
        # scenario than the fixture claims to pin
        raise ValueError(f"unknown scenario field(s) {bogus}")
    s = Scenario(
        seed=int(data.get("seed", 0)),
        clusters=int(data.get("clusters", 1)),
        duration=float(data.get("duration", 300.0)),
        tick=float(data.get("tick", 30.0)),
        solver=data.get("solver", "greedy"),
        fleet=int(data.get("fleet", 0)),
        wire=data.get("wire", "delta"),
        incremental=bool(data.get("incremental", False)),
        autoscale=bool(data.get("autoscale", False)),
        fleet_min=int(data.get("fleet_min", 0)),
        fleet_max=int(data.get("fleet_max", 0)),
        max_pending=float(data.get("max_pending", 600.0)),
        rack_size=int(data.get("rack_size", 0)),
        rates={k: float(v) for k, v in sorted((data.get("rates") or {}).items())},
        waves=_decode_items(data.get("waves"), WorkloadWave),
        storms=_decode_items(data.get("storms"), Storm),
        fleet_faults=_decode_items(data.get("fleet_faults"), FleetFault),
        hooks=_decode_items(data.get("hooks"), TestHook),
    )
    validate_scenario(s)
    return s


def scenario_from_json(text: str) -> Scenario:
    return decode_scenario(json.loads(text))


def validate_scenario(s: Scenario) -> None:
    if s.clusters < 1:
        raise ValueError(f"scenario needs >= 1 cluster, got {s.clusters}")
    if s.duration <= 0 or s.tick <= 0:
        raise ValueError("scenario duration and tick must be positive")
    if s.solver not in ("greedy", "tpu"):
        raise ValueError(f"unknown scenario solver {s.solver!r}")
    if s.wire not in ("delta", "full"):
        raise ValueError(f"unknown scenario wire {s.wire!r}")
    if s.fleet and s.solver != "tpu":
        raise ValueError("a fleet tier requires solver=tpu")
    if s.incremental and not s.fleet:
        # the PackingLedger lives daemon-side; without a solverd tier
        # there is no ledger to warm-start from
        raise ValueError("incremental re-solve requires a fleet tier")
    if s.fleet_min < 0 or s.fleet_max < 0:
        raise ValueError("fleet_min/fleet_max must be >= 0")
    if s.autoscale:
        if not s.fleet:
            raise ValueError("autoscale requires a fleet tier (fleet>=1)")
        mn = s.fleet_min or 1
        mx = s.fleet_max or max(s.fleet, mn)
        if mx < mn:
            raise ValueError(
                f"fleet_max ({mx}) must be >= fleet_min ({mn})"
            )
        if not (mn <= s.fleet <= mx):
            raise ValueError(
                f"starting fleet size {s.fleet} outside"
                f" autoscale bounds [{mn}, {mx}]"
            )
    elif s.fleet_min or s.fleet_max:
        raise ValueError("fleet_min/fleet_max require autoscale")
    if s.rack_size < 0:
        raise ValueError(f"rack_size must be >= 0, got {s.rack_size}")
    def _cluster_in_range(what: str, cluster: int, wildcard: bool) -> None:
        lo = -1 if wildcard else 0  # -1 = every cluster, where allowed
        if not (lo <= cluster < s.clusters):
            raise ValueError(
                f"{what} targets cluster {cluster} outside"
                f" [{lo}, {s.clusters})"
            )

    for wave in s.waves:
        _cluster_in_range(f"wave at t={wave.at}", wave.cluster, False)
        if wave.kind not in ("training", "serving", "batch"):
            raise ValueError(f"unknown wave kind {wave.kind!r}")
        if wave.kind == "training":
            if wave.gang_size < 1:
                raise ValueError("training waves need gang_size >= 1")
            if wave.count < wave.gang_size or wave.count % wave.gang_size:
                # a silent round-up/down would make the scenario file lie
                # about how many pods actually materialize
                raise ValueError(
                    f"training wave count {wave.count} must be a positive"
                    f" multiple of gang_size {wave.gang_size}"
                )
            if not (-1 <= wave.max_hops <= 3):
                # the annotation contract clamps hostile ints server-side;
                # a scenario FILE declaring an impossible bound is a typo,
                # not an adversary — reject it loudly
                raise ValueError(
                    f"training wave max_hops {wave.max_hops} outside"
                    " [-1, 3]"
                )
        elif wave.max_hops != -1:
            raise ValueError(
                f"max_hops only applies to training waves, not {wave.kind!r}"
            )
    for storm in s.storms:
        _cluster_in_range(f"storm at t={storm.start}", storm.cluster, True)
    for fault in s.fleet_faults:
        if fault.kind not in ("murder", "partition", "amnesia"):
            raise ValueError(f"unknown fleet fault kind {fault.kind!r}")
        if not s.fleet:
            raise ValueError("fleet faults require a fleet tier (fleet>=1)")
        # under autoscale the live member set is dynamic, so faults may
        # target any slot up to the max bound; a slot empty at fire time
        # skips deterministically (harness)
        member_bound = (
            max(s.fleet, s.fleet_max or s.fleet) if s.autoscale else s.fleet
        )
        if fault.kind in ("murder", "amnesia") and not (
            0 <= fault.member < member_bound
        ):
            raise ValueError(
                f"fleet fault targets member {fault.member} outside"
                f" [0, {member_bound})"
            )
        if fault.kind == "partition":
            _cluster_in_range(
                f"partition at t={fault.at}", fault.cluster, True
            )
    for hook in s.hooks:
        if hook.kind != "lose_bound_pod":
            raise ValueError(f"unknown test hook kind {hook.kind!r}")
        _cluster_in_range(f"hook at t={hook.at}", hook.cluster, False)


def canonical_scenario(s: Scenario) -> Scenario:
    """The scenario with every collection in its canonical (encoded)
    order. The harness normalizes through this before running, so two
    constructions that differ only in tuple order — which share a
    fingerprint, because the encoder sorts — also share a run."""
    return dataclasses.replace(
        s,
        waves=tuple(sorted(s.waves, key=dataclasses.astuple)),
        storms=tuple(sorted(s.storms, key=dataclasses.astuple)),
        fleet_faults=tuple(sorted(s.fleet_faults, key=dataclasses.astuple)),
        hooks=tuple(sorted(s.hooks, key=dataclasses.astuple)),
        rates={k: v for k, v in sorted(s.rates.items())},
    )


def wave_ids(waves: Tuple[WorkloadWave, ...]) -> list:
    """Stable per-wave identities derived from CONTENT, not position:
    pod names and the wave's child RNG stream key off this, so dropping
    one wave from a scenario (the shrinker) or reordering the tuple (a
    hand-edited fixture) never re-rolls the surviving waves. Identical
    duplicate waves disambiguate by occurrence index — deterministic
    under the canonical order."""
    seen: Dict[str, int] = {}
    out = []
    for wave in waves:
        blob = repr(dataclasses.astuple(wave)).encode()
        base = f"{wave.kind[0]}{hashlib.sha256(blob).hexdigest()[:6]}"
        n = seen.get(base, 0)
        seen[base] = n + 1
        out.append(base if n == 0 else f"{base}x{n}")
    return out


def scenario_fingerprint(s: Scenario) -> str:
    """Content address of the scenario (canonical JSON bytes, sha256/16):
    identical fingerprints MUST replay identical event traces and
    ledgers — the contract the determinism tests pin."""
    digest = hashlib.sha256(scenario_to_json(s).encode()).hexdigest()
    return digest[:16]
