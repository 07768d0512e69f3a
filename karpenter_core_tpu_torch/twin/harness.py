"""DigitalTwin: N simulated clusters + one solverd tier, one virtual
timeline, every fault seam scripted — the closed loop, compressed.

Each cluster is a full ``Operator`` (its own KubeStore, kwok provider
with a DISTINCT catalog, chaos-wrapped kube/cloud seams) sharing one
``VirtualClock``; with ``scenario.fleet`` > 0 the solve path runs through
a REAL fleetd tier — in-thread solverd daemons behind HTTP, each
operator's ``FleetRouter`` doing digest-affinity placement over them —
whose client-side state (breaker cooldowns, retry sleeps, quarantine
TTLs) rides the same virtual clock via the operator's ``solver_client``
injection seam. Fleet-level faults compose on top of the chaos harness:

* ``murder``    — a member's server is torn down (transport dies under
  the client), respawning one tick later with a fresh daemon: empty
  segment store, cold caches, new instance id — the client must pay one
  miss/re-upload round and nothing else;
* ``partition`` — an operator's view of the whole tier fails as
  transport faults for a window (degrade-to-greedy, quarantine strikes,
  never a lost pod);
* ``amnesia``   — a member's segment store is swapped empty in place.

Determinism contract: identical (seed, scenario) → byte-identical event
trace and ledger JSON. Everything that could differ between two runs of
one process — claim-name and uid counters, ephemeral port numbers,
process-global metric absolutes — is reset, scrubbed, or delta'd.

Port of ``karpenter_core_tpu/twin/harness.py``. The edits:

* **The device is explicit.** ``DigitalTwin(scenario, ..., device="cuda",
  kernel="cuda")`` and ``run_scenario(..., device=..., kernel=...)``
  default to the card and raise without a GPU (``utils/device``); on the
  CPU pass ``device="cpu", kernel="reference"``. They thread into each
  in-process operator's ``Options(solver_kernel=kernel,
  device_scheduler_opts={"device": device})`` and into each in-thread
  ``SolverDaemon(device=device, kernel=kernel)``. They are run arguments,
  never ``Scenario`` fields: the scenario's JSON and fingerprint are the
  JAX package's.
* The in-thread tier (``_FleetTier``) and the elastic tier
  (``_TwinTierAdapter``) stay in-thread: every daemon shares this
  process's one CUDA context. The operators get their router through the
  ``solver_client`` seam, not a spawned fleet.
* **Failed RPCs are counted.** The sidecar client is the reference's: a
  partition window or a murdered member degrades the solve to the host
  greedy Scheduler, counted in ``rpc_fallbacks`` as in the reference. The
  counters add ``rpc_failures`` (``SOLVER_RPC_FAILURES``), which the
  ledger does not carry.
* **A murdered member refuses in process** (``_install_murder_gate``): a
  connect to its freed port must not depend on the host; the client
  raises the socket's own refusal instead, and the run's trace and ledger
  are unchanged.
"""
from __future__ import annotations

import errno
import itertools
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.api.nodepool import NodePool, NodePoolSpec
from karpenter_core_tpu_torch.api.objects import ObjectMeta, Pod
from karpenter_core_tpu_torch.chaos import (
    ChaosCloudProvider,
    ChaosKubeClient,
    ChaosSchedule,
    IceStorm,
    fold_seed,
)
from karpenter_core_tpu_torch.cloudprovider.kwok import KwokCloudProvider, build_catalog
from karpenter_core_tpu_torch.cloudprovider.types import OfferingKey
from karpenter_core_tpu_torch.kube.store import KubeStore
from karpenter_core_tpu_torch.operator import Operator, Options
from karpenter_core_tpu_torch.operator import _check_solver_kernel
from karpenter_core_tpu_torch.twin import workloads
from karpenter_core_tpu_torch.twin.clock import VirtualClock
from karpenter_core_tpu_torch.twin.invariants import InvariantMonitor, Violation
from karpenter_core_tpu_torch.twin.ledger import Ledger, price_index
from karpenter_core_tpu_torch.twin.scenario import (
    Scenario,
    canonical_scenario,
    scenario_fingerprint,
    validate_scenario,
    wave_ids,
)
from karpenter_core_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# every twin run starts its virtual timeline here (FakeClock's epoch):
# absolute virtual timestamps are deterministic because the origin is
TWIN_EPOCH = 1_000_000.0

# ephemeral ports differ between runs; the trace must not
_PORT_RE = re.compile(r"127\.0\.0\.1:\d+")


def _scrub(text: str) -> str:
    return _PORT_RE.sub("127.0.0.1:<port>", text)


def _counter_total(counter) -> float:
    return sum(counter.values.values())


def _metric_snapshot() -> Dict[str, float]:
    from karpenter_core_tpu_torch.metrics import wiring as m

    return {
        "rpc_fallbacks": _counter_total(m.SOLVER_RPC_FALLBACKS),
        # the failed RPCs, the faults that bit (the ledger does not carry
        # them)
        "rpc_failures": _counter_total(m.SOLVER_RPC_FAILURES),
        "result_rejected": _counter_total(m.SOLVER_RESULT_REJECTED),
        "host_fallback_pods": _counter_total(m.SOLVER_HOST_FALLBACK_PODS),
        "preemption_evictions": _counter_total(m.SOLVER_PREEMPTION_EVICTIONS),
        # incsolve: warm/partial replays actually served — the
        # drift-judge tests gate on these to stay non-vacuous
        "incremental_warm": (
            m.SOLVER_INCREMENTAL.values.get((("outcome", "warm"),), 0.0)
            + m.SOLVER_INCREMENTAL.values.get((("outcome", "partial"),), 0.0)
        ),
        "incremental_total": _counter_total(m.SOLVER_INCREMENTAL),
    }


def _reset_identity_counters() -> None:
    """Claim names and object uids draw from process-global counters; two
    runs of one scenario in one process must mint identical identities
    (the test_chaos _reset_claim_counter precedent, widened)."""
    from karpenter_core_tpu_torch.api import objects as apiobjects
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling import (
        nodeclaimtemplate,
    )

    apiobjects._uid_counter = itertools.count(1)
    nodeclaimtemplate._claim_counter = itertools.count(1)


def cluster_catalog(i: int):
    """Distinct per-cluster instance catalogs (different cpu grids and
    memory families), so the tier's prepared-state caches and the delta
    wire's segment stores see N genuinely different problem halves."""
    grids = ([1, 2, 4, 8, 16], [2, 4, 8, 16, 32], [1, 2, 4, 8, 16, 32])
    mems = ([2, 4], [4, 8], [2, 8])
    return build_catalog(
        cpu_grid=list(grids[i % 3]), mem_factors=list(mems[i % 3])
    )


@dataclass
class TwinResult:
    scenario: Scenario
    fingerprint: str
    violations: List[Violation]
    ledger: Ledger
    trace: List[tuple]
    counters: Dict[str, float] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def trace_json(self) -> str:
        return json.dumps(
            [list(entry) for entry in self.trace], separators=(",", ":")
        )

    def ledger_json(self) -> str:
        return self.ledger.to_json()

    def first_violation(self) -> Optional[Violation]:
        return self.violations[0] if self.violations else None


class _FleetTier:
    """The shared solverd tier: in-thread daemons behind real HTTP, plus
    the murder/respawn/amnesia machinery. In-thread (not subprocess) so a
    tier-1 twin run costs no spawn latency and stays deterministic; the
    transport, codec, gateway and caches are the production objects."""

    def __init__(self, n: int, vclock: VirtualClock, device, kernel: str):
        from karpenter_core_tpu_torch.solver import fleet as fleetmod
        from karpenter_core_tpu_torch.solver import service

        self._fleetmod = fleetmod
        self._service = service
        self.vclock = vclock
        # every member solves on this process's device (one CUDA context)
        self.device = device
        self.kernel = kernel
        self.daemons: List = []
        self.servers: List = []
        self.addrs: List[str] = []
        # stable member identities surviving index shifts under elastic
        # resize (fleetscale): ids are never reused, so the
        # routers' rendezvous ranks and the utilization ledger never
        # alias a retired member's successor
        self.member_ids: List[str] = []
        # addresses of murdered members: every connection to one is
        # refused in process (DigitalTwin._install_murder_gate)
        self.dead: set = set()
        self._next = 0
        self.member_solves: Dict[str, int] = {}
        for _ in range(n):
            self.grow()

    def grow(self) -> int:
        """Spawn one fresh member (autoscaler scale-up actuator); returns
        its index in the live member list."""
        daemon, srv, addr = self._spawn()
        self.daemons.append(daemon)
        self.servers.append(srv)
        self.addrs.append(addr)
        self.member_ids.append(str(self._next))
        self._next += 1
        return len(self.daemons) - 1

    def retire(self, i: int) -> None:
        """Crash-only scale-down, in-thread: flush the member's queue
        (each queued request answers 503 — the faultless drain path),
        close its socket, drop it from the live set. Indices above i
        shift down, exactly like FleetRouter.remove_member — the run
        keeps the two aligned."""
        if self.servers[i] is not None:
            self._bank_solves(i)
            self.daemons[i].drain()
            self.servers[i].shutdown()
            self.servers[i].server_close()
        self.daemons.pop(i)
        self.servers.pop(i)
        self.addrs.pop(i)
        self.member_ids.pop(i)

    def live_count(self) -> int:
        return sum(1 for srv in self.servers if srv is not None)

    def _spawn(self):
        daemon = self._service.SolverDaemon(
            quarantine=self._fleetmod.PoisonQuarantine(
                site="gateway", time_fn=self.vclock.monotonic
            ),
            device=self.device,
            kernel=self.kernel,
        )
        srv = self._service.serve(0, daemon=daemon)
        addr = f"127.0.0.1:{srv.server_address[1]}"
        self.dead.discard(addr)  # the host may hand a dead port out again
        return daemon, srv, addr

    def murder(self, i: int) -> None:
        """Tear the member down: its socket closes under any client."""
        self._bank_solves(i)
        self.dead.add(self.addrs[i])
        self.servers[i].shutdown()
        self.servers[i].server_close()
        self.servers[i] = None

    def respawn(self, i: int, routers: List) -> None:
        """Fresh daemon (empty segment store, cold caches, new instance
        id) on a fresh port; every operator's router re-points, exactly
        as reconcile_once does after a FleetSupervisor restart."""
        daemon, srv, addr = self._spawn()
        self.daemons[i] = daemon
        self.servers[i] = srv
        self.addrs[i] = addr
        for router in routers:
            router.set_member_addr(i, addr)

    def amnesia(self, i: int) -> None:
        from karpenter_core_tpu_torch.solver import segments

        self.daemons[i].segment_store = segments.SegmentStore()

    def _bank_solves(self, i: int) -> None:
        mid = self.member_ids[i]
        self.member_solves[mid] = (
            self.member_solves.get(mid, 0) + self.daemons[i].solves
        )

    def utilization(self) -> Dict[str, int]:
        # keyed by stable member id: a retired member's banked solves
        # survive it leaving the live list
        out: Dict[str, int] = dict(self.member_solves)
        for i, daemon in enumerate(self.daemons):
            if self.servers[i] is not None:
                mid = self.member_ids[i]
                out[mid] = out.get(mid, 0) + daemon.solves
        return out

    def stop(self) -> None:
        for srv in self.servers:
            if srv is not None:
                srv.shutdown()
                srv.server_close()


class _TwinTierAdapter:
    """The TierAutoscaler's tier surface over the in-thread fleet,
    DETERMINISTIC by construction: production SpawnedTier reads wall-time
    queue-wait percentiles off /statz, which two replays of one scenario
    would never reproduce byte-for-byte — so the twin derives pressure
    from the scenario's own state instead (expected-but-unbound pods per
    live member, a pure function of the virtual timeline). Scale-up grows
    a member and hands every cluster's router a gated virtual-clock
    client; scale-down retires through the in-thread drain path with the
    router un-routed FIRST, same ordering as production."""

    # how many backlogged pods one member absorbs per tick before the
    # tier counts as over budget (pressure 1.0)
    PODS_PER_MEMBER = 8.0

    def __init__(self, tier: _FleetTier, routers, new_clients, backlog_fn):
        self.tier = tier
        self.routers = routers
        self.new_clients = new_clients  # (addr, member_id) -> [client/router]
        self.backlog_fn = backlog_fn

    def observe(self):
        from karpenter_core_tpu_torch.solver.autoscale import (
            MemberSignal,
            TierSignals,
        )

        members = [
            MemberSignal(
                member=mid, draining=self.tier.servers[i] is None
            )
            for i, mid in enumerate(self.tier.member_ids)
        ]
        live = sum(1 for ms in members if not ms.draining) or 1
        pressure = self.backlog_fn() / (live * self.PODS_PER_MEMBER)
        return TierSignals(members=members, pressure=pressure, storm=False)

    def scale_up(self) -> None:
        idx = self.tier.grow()
        addr = self.tier.addrs[idx]
        mid = self.tier.member_ids[idx]
        for router, client in zip(self.routers, self.new_clients(addr, mid)):
            router.add_member(client, member_id=mid)

    def scale_down(self, index: int) -> None:
        for router in self.routers:
            router.remove_member(index)
        self.tier.retire(index)

    def set_rung(self, rung: int) -> None:
        for i, daemon in enumerate(self.tier.daemons):
            if self.tier.servers[i] is not None:
                daemon.set_brownout(rung)


class DigitalTwin:
    def __init__(
        self,
        scenario: Scenario,
        reconcile_iters: int = 300,
        device=DEFAULT_DEVICE,
        kernel: str = "cuda",
    ):
        validate_scenario(scenario)
        # canonical collection order: constructions that share a
        # fingerprint (the encoder sorts) must also share a run
        self.scenario = canonical_scenario(scenario)
        self.reconcile_iters = reconcile_iters
        # explicit device, no fallback: CUDA without a GPU raises here
        self.device = resolve_device(device)
        _check_solver_kernel(kernel)
        self.kernel = kernel

    # -- construction ------------------------------------------------------

    def _member_client(self, cluster: int, addr: str, member: str, vclock):
        """One cluster's client for one tier member: virtual-clock
        breaker, partition gate — shared by founding members and any the
        autoscaler grows later."""
        from karpenter_core_tpu_torch.solver.remote import SolverClient

        client = SolverClient(
            addr,
            timeout=30.0,
            tenant=f"c{cluster}",
            wire_mode=self.scenario.wire,
            member=member,
            sleep=vclock.sleep,
        )
        # the client's fault-tolerance state rides VIRTUAL time: a
        # breaker cooldown or quarantine TTL elapses with the
        # scenario, not with the wall — days of churn in minutes
        client.breaker.time_fn = vclock.monotonic
        self._install_partition_gate(cluster, client)
        # and the murder gate: a murdered member refuses in process
        self._install_murder_gate(client)
        return client

    def _make_router(self, cluster: int, tier: _FleetTier, vclock):
        from karpenter_core_tpu_torch.solver.fleet import PoisonQuarantine
        from karpenter_core_tpu_torch.solver.remote import FleetRouter

        # autoscaled tiers label members even at a starting size of 1:
        # the set is about to change and rendezvous ranks key off ids
        labeled = len(tier.addrs) > 1 or self.scenario.autoscale
        members = [
            self._member_client(
                cluster, addr, tier.member_ids[j] if labeled else "", vclock
            )
            for j, addr in enumerate(tier.addrs)
        ]
        return FleetRouter(
            members,
            tenant=f"c{cluster}",
            quarantine=PoisonQuarantine(
                site="client", time_fn=vclock.monotonic
            ),
        )

    def _install_partition_gate(self, cluster: int, client) -> None:
        from karpenter_core_tpu_torch.solver.remote import RemoteSolverError

        def active() -> bool:
            offset = self._vclock.now() - TWIN_EPOCH
            for fault in self.scenario.fleet_faults:
                if fault.kind != "partition":
                    continue
                if fault.cluster not in (-1, cluster):
                    continue
                if fault.at <= offset < fault.at + fault.duration:
                    return True
            return False

        orig = client.call

        def gated(*args, _orig=orig, **kwargs):
            if active():
                raise RemoteSolverError(
                    "error", "twin: operator-fleet partition window"
                )
            return _orig(*args, **kwargs)

        client.call = gated

    def _install_murder_gate(self, client) -> None:
        """A murdered member's address refuses every connection in process:
        the client meets the socket's own ``ConnectionRefusedError`` and
        takes the same retry, breaker and quarantine path, with no connect
        to the dead port. A real connect to the freed port can wait out the
        client's 30-s real-time deadline instead of being refused (seen once
        on a GPU host), which would make the run's trace turn on the host's
        network stack."""
        orig = client._once

        def gated(path, body, headers=None, _orig=orig):
            if client.addr in self._tier.dead:
                client._apply_fault()
                raise ConnectionRefusedError(
                    errno.ECONNREFUSED, os.strerror(errno.ECONNREFUSED))
            return _orig(path, body, headers)

        client._once = gated

    def _make_operator(
        self, cluster: int, vclock, tier: Optional[_FleetTier]
    ) -> Tuple[Operator, KubeStore, ChaosSchedule]:
        s = self.scenario
        catalog = cluster_catalog(cluster)
        schedule = ChaosSchedule(
            seed=fold_seed(s.seed, f"cluster{cluster}"),
            rates=dict(s.rates),
        )
        store = KubeStore(vclock)
        storms = []
        for storm in s.storms:
            if storm.cluster not in (-1, cluster):
                continue
            storms.append(IceStorm(
                start=TWIN_EPOCH + storm.start,
                duration=storm.duration,
                offerings=tuple(
                    OfferingKey(it.name, zone, ct)
                    for it in catalog[: storm.head]
                    for zone in storm.zones
                    for ct in storm.capacity_types
                ),
            ))
        provider = ChaosCloudProvider(
            KwokCloudProvider(store, catalog, rack_size=s.rack_size),
            schedule,
            storms=storms,
            clock=vclock,
        )
        kube = ChaosKubeClient(store, schedule)
        if tier is not None:
            options = Options(
                solver="tpu",
                solver_mode="sidecar",
                solver_tenant=f"c{cluster}",
                solver_wire=s.wire,
                # incsolve: the client names its prior solve's
                # fingerprint on every request; the tier's PackingLedger
                # replays the unchanged half of last round's packing
                device_scheduler_opts=(
                    {"incremental": True} if s.incremental else {}
                ),
            )
            client = self._make_router(cluster, tier, vclock)
        else:
            options = Options(
                solver=s.solver,
                solver_kernel=self.kernel,
                device_scheduler_opts={"device": str(self.device)},
            )
            client = None
        op = Operator(
            kube=kube,
            cloud_provider=provider,
            clock=vclock,
            options=options,
            solver_client=client,
        )
        pool = NodePool(metadata=ObjectMeta(name="default"))
        pool.spec = NodePoolSpec()
        store.create(pool)
        return op, store, schedule

    # -- the run -----------------------------------------------------------

    def run(self) -> TwinResult:
        s = self.scenario
        _reset_identity_counters()
        vclock = VirtualClock(TWIN_EPOCH)
        self._vclock = vclock
        tier = (
            _FleetTier(s.fleet, vclock, str(self.device), self.kernel)
            if s.fleet
            else None
        )
        self._tier = tier
        notes: List[tuple] = []
        note_seq = itertools.count()

        def note(kind: str, detail: str) -> None:
            notes.append((
                round(vclock.now() - TWIN_EPOCH, 3),
                "twin",
                next(note_seq),
                kind,
                _scrub(detail),
            ))

        operators: List[Operator] = []
        stores: List[KubeStore] = []
        schedules: List[ChaosSchedule] = []
        routers: List = []
        try:
            for i in range(s.clusters):
                op, store, schedule = self._make_operator(i, vclock, tier)
                operators.append(op)
                stores.append(store)
                schedules.append(schedule)
                if tier is not None:
                    routers.append(op.solver_client)

            price_indices = {
                i: price_index(cluster_catalog(i)) for i in range(s.clusters)
            }
            monitor = InvariantMonitor(max_pending=s.max_pending)
            ledger = Ledger()
            baseline = _metric_snapshot()
            expected: Dict[int, Dict[str, Pod]] = {
                i: {} for i in range(s.clusters)
            }
            wave_names: Dict[str, List[str]] = {}
            bound_seen: Dict[int, set] = {i: set() for i in range(s.clusters)}
            active_partitions: set = set()
            down_members: Dict[str, float] = {}  # member id -> respawn due

            autoscaler = None
            if s.autoscale and tier is not None:
                from karpenter_core_tpu_torch.solver.autoscale import (
                    TierAutoscaler,
                )

                def _backlog() -> float:
                    # expected-but-unbound pods across every cluster: the
                    # deterministic demand signal (wall-free, replayable)
                    total = 0
                    for i in range(s.clusters):
                        for name in expected[i]:
                            pod = stores[i].get(Pod, name)
                            if pod is not None and not pod.node_name:
                                total += 1
                    return float(total)

                def _new_clients(addr: str, mid: str):
                    return [
                        self._member_client(i, addr, mid, vclock)
                        for i in range(len(routers))
                    ]

                autoscaler = TierAutoscaler(
                    _TwinTierAdapter(tier, routers, _new_clients, _backlog),
                    s.fleet_min or 1,
                    s.fleet_max or max(s.fleet, s.fleet_min or 1),
                    # hysteresis in TICKS of virtual time: react after one
                    # over-budget tick, relax after two quiet ones, with a
                    # longer scale-down cooldown (the production shape,
                    # compressed to the scenario's timescale)
                    up_stable=1,
                    down_stable=2,
                    up_cooldown_s=s.tick,
                    down_cooldown_s=2 * s.tick,
                    rung_up_stable=1,
                    rung_down_stable=2,
                    time_fn=lambda: vclock.now() - TWIN_EPOCH,
                    on_decision=lambda action, arg: note(
                        "autoscale", f"{action} {arg}"
                    ),
                )

            # the timeline: (due offset, kind order, seq) -> action.
            # Wave identity is CONTENT-derived (scenario.wave_ids): pod
            # names/RNG streams survive sibling waves being dropped or
            # reordered
            ids = wave_ids(s.waves)
            events: List[tuple] = []
            for wi, wave in enumerate(s.waves):
                events.append((wave.at, 0, wi, "wave", wave))
                if wave.lifetime > 0:
                    events.append(
                        (wave.at + wave.lifetime, 1, wi, "delete_wave", wave)
                    )
            for fi, fault in enumerate(s.fleet_faults):
                if fault.kind in ("murder", "amnesia"):
                    events.append((fault.at, 2, fi, fault.kind, fault))
            for hi, hook in enumerate(s.hooks):
                events.append((hook.at, 3, hi, hook.kind, hook))
            events.sort(key=lambda e: e[:3])
            cursor = 0

            n_ticks = max(int(-(-s.duration // s.tick)), 1)
            prev_t = 0.0
            for k in range(1, n_ticks + 1):
                t = min(k * s.tick, s.duration)
                vclock.advance_to(TWIN_EPOCH + t)
                # respawn members whose murder window elapsed (looked up
                # by stable id — a scale-down may have shifted indices)
                for mid in sorted(down_members):
                    if down_members[mid] <= t:
                        del down_members[mid]
                        if mid in tier.member_ids:
                            tier.respawn(tier.member_ids.index(mid), routers)
                            note("respawn", f"fleet member {mid} respawned")
                # apply everything due by this tick
                while cursor < len(events) and events[cursor][0] <= t:
                    _, _, idx, kind, payload = events[cursor]
                    cursor += 1
                    if kind == "wave":
                        self._apply_wave(
                            payload, ids[idx], stores, expected, wave_names
                        )
                        note("wave", (
                            f"cluster {payload.cluster}: {payload.kind}"
                            f" wave {ids[idx]} x{payload.count}"
                        ))
                    elif kind == "delete_wave":
                        self._delete_wave(
                            payload, ids[idx], stores, expected, wave_names
                        )
                        note("delete_wave", (
                            f"cluster {payload.cluster}: wave {ids[idx]}"
                            " retired"
                        ))
                    elif kind == "murder":
                        # under autoscale the index targets the CURRENT
                        # live list; an empty slot (never grown, already
                        # retired) skips deterministically
                        if payload.member < len(tier.member_ids) and (
                            tier.servers[payload.member] is not None
                        ):
                            mid = tier.member_ids[payload.member]
                            tier.murder(payload.member)
                            down_members[mid] = t + s.tick
                            note("murder", (
                                f"fleet member {mid} murdered"
                            ))
                    elif kind == "amnesia":
                        if payload.member < len(tier.member_ids) and (
                            tier.servers[payload.member] is not None
                        ):
                            mid = tier.member_ids[payload.member]
                            tier.amnesia(payload.member)
                            note("amnesia", (
                                f"fleet member {mid} segment"
                                " store wiped"
                            ))
                    elif kind == "lose_bound_pod":
                        self._apply_lose_pod(payload, stores, expected, note)
                # partition window edges, at tick granularity
                now_active = set()
                for fi, fault in enumerate(s.fleet_faults):
                    if fault.kind != "partition":
                        continue
                    if fault.at <= t < fault.at + fault.duration:
                        now_active.add(fi)
                for fi in sorted(now_active - active_partitions):
                    note("partition_start", (
                        f"cluster {s.fleet_faults[fi].cluster} partitioned"
                        " from the fleet"
                    ))
                for fi in sorted(active_partitions - now_active):
                    note("partition_end", "partition healed")
                active_partitions = now_active

                # autoscaler step BEFORE the settle: the tier resizes on
                # the backlog the tick arrived with, then the operators
                # solve against the resized tier (one control period per
                # tick, riding the virtual clock)
                if autoscaler is not None:
                    autoscaler.step()

                # one closed-loop settle per cluster
                for op in operators:
                    op.run_until_idle(max_iters=self.reconcile_iters)

                # SLO accounting: first tick each expected pod shows bound
                for i, op in enumerate(operators):
                    live = expected[i]
                    for name in sorted(live):
                        if name in bound_seen[i]:
                            continue
                        pod = op.kube.get(Pod, name)
                        if pod is None or not pod.node_name:
                            continue
                        bound_seen[i].add(name)
                        latency = (
                            vclock.now() - pod.metadata.creation_timestamp
                        )
                        ledger.record_bind(
                            workloads.workload_class(pod), latency
                        )
                        if latency > s.max_pending:
                            ledger.slo_misses += 1

                monitor.check(vclock.now(), operators, expected)
                ledger.sample(
                    t - prev_t, operators, price_indices,
                    tier_members=tier.live_count() if tier else 0,
                )
                prev_t = t

            after = _metric_snapshot()
            delta = {
                key: after[key] - baseline[key] for key in sorted(baseline)
            }
            ledger.preemption_evictions = int(delta["preemption_evictions"])
            ledger.utilization = {
                "chaos_draws": {
                    str(i): schedules[i].draws for i in range(s.clusters)
                },
                # faults that actually FIRED (draws count every call,
                # faulted or ok — a non-vacuousness gate needs these)
                "chaos_injected": {
                    str(i): (
                        sum(operators[i].kube.injected.values())
                        + sum(
                            operators[i].cloud_provider.injected.values()
                        )
                    )
                    for i in range(s.clusters)
                },
                "rpc_fallbacks": delta["rpc_fallbacks"],
                "host_fallback_pods": delta["host_fallback_pods"],
            }
            if tier is not None:
                ledger.utilization["member_solves"] = tier.utilization()

            trace = self._merge_trace(notes, operators)
            return TwinResult(
                scenario=s,
                fingerprint=scenario_fingerprint(s),
                violations=list(monitor.violations),
                ledger=ledger,
                trace=trace,
                counters=delta,
            )
        finally:
            for op in operators:
                op.shutdown()
            if tier is not None:
                tier.stop()

    # -- event application -------------------------------------------------

    def _apply_wave(self, wave, wave_id, stores, expected, wave_names):
        pods, pdbs = workloads.pods_for_wave(
            wave, wave_id, self.scenario.seed
        )
        store = stores[wave.cluster]
        names = []
        for pdb in pdbs:
            store.create(pdb)
        for pod in pods:
            store.create(pod)
            expected[wave.cluster][pod.name] = pod
            names.append(pod.name)
        wave_names[wave_id] = names

    def _delete_wave(self, wave, wave_id, stores, expected, wave_names):
        store = stores[wave.cluster]
        for name in wave_names.get(wave_id, []):
            pod = store.get(Pod, name)
            if pod is not None:
                store.delete(pod)
            expected[wave.cluster].pop(name, None)
        from karpenter_core_tpu_torch.api.objects import PodDisruptionBudget

        pdb = store.get(PodDisruptionBudget, f"pdb-{wave_id}")
        if pdb is not None:
            store.delete(pdb)

    def _apply_lose_pod(self, hook, stores, expected, note) -> None:
        """The test-only invariant saboteur: silently drop one bound pod
        from the store, leaving the workload bookkeeping convinced it
        still exists — pod conservation MUST catch this."""
        store = stores[hook.cluster]
        for name in sorted(expected[hook.cluster]):
            pod = store.get(Pod, name)
            if pod is not None and pod.node_name:
                store.delete(pod)
                note("lose_bound_pod", f"test hook dropped bound pod {name}")
                return

    # -- trace -------------------------------------------------------------

    def _merge_trace(self, notes: List[tuple], operators) -> List[tuple]:
        entries: List[tuple] = list(notes)
        for i, op in enumerate(operators):
            for seq, event in enumerate(op.recorder.events):
                entries.append((
                    round(event.timestamp - TWIN_EPOCH, 3),
                    f"cluster{i}",
                    seq,
                    f"{event.type}/{event.reason}",
                    _scrub(f"{event.involved_object}: {event.message}"),
                ))
        entries.sort(key=lambda e: (e[0], str(e[1]), e[2]))
        return entries


def run_scenario(scenario: Scenario, **kwargs) -> TwinResult:
    return DigitalTwin(scenario, **kwargs).run()
