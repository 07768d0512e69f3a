"""TierAutoscaler: the closed loop that sizes the solverd fleet (ISSUE 17).

The tier is horizontally scaled (PR 13) but was statically sized: a fixed
``--solver-fleet=N`` wastes members through a quiet night or sheds load
through a surge. Elasticity here is POLICY, not new lifecycle work — the
crash-only drain contract (PR 8), digest-affinity routing with a one-miss
re-upload handshake (PR 13) and the respawn-storm alarm (PR 14) already
make member churn cheap and observable. This module adds the control loop
on top:

* **Signals** come from what the tier already exports: per-member
  queue-wait p50/p99 and shed rate from the gateway snapshot (served at
  ``GET /statz``), queue depth and draining state from the same snapshot,
  spill/in-flight counts from the router. Adapters normalize them into a
  single scalar **pressure** (>= 1.0 means the tier is over its queue-wait
  budget) plus per-member load, so the policy itself never does I/O.
* **Hysteresis**: separate up/down pressure thresholds, separate
  consecutive-observation streak requirements, separate per-direction
  cooldowns, and hard min/max member bounds. The middle band between the
  thresholds resets both streaks — a flapping signal scales nothing.
* **Flap containment**: scale-up is suppressed while ``respawn_storm()``
  fires (growing a melting tier feeds the melt), and scale-down never
  picks a member that is draining or currently answering a spill.
* **Scale-down = drain**: the victim is the least-loaded member, retired
  through the faultless ``POST /drain`` path (``DRAIN_EXIT_CODE``, zero
  backoff charge) via ``FleetSupervisor.retire_member()``; the router's
  rendezvous hash runs over the live member set, so retiring member k
  remaps only k's digests — one miss/re-upload round each, breakers
  untouched, fallbacks unmoved (the PR 13 respawn contract extended to
  resize).
* **Brownout ladder**: at max members with pressure still over budget the
  loop climbs an explicit degradation ladder instead of shedding blind —
  rung 1 serves ``relax`` requests in FFD mode (the anytime answer,
  verifier unchanged), rung 2 widens the batch window for deeper
  coalescing, rung 3 halves queue capacity so shedding starts earlier.
  Each rung has its own enter/exit hysteresis and is exported as a
  metric-labeled state on ``/healthz``; verification is never disabled on
  any rung. Rungs enter 1->2->3 and exit 3->2->1, strictly in order.

Lock discipline (GL302/GL304): ``step()`` is gather -> decide -> actuate.
``observe()`` and every actuation (HTTP drain, subprocess spawn) run with
NO autoscaler lock held; only the pure decision runs under
``_state_lock``. The decision log (``decisions``) is the deterministic
record the twin replays byte-identically.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

# the explicit degradation ladder above max scale; service.SolverDaemon
# imports this so the daemon-side rung validation and the policy can
# never disagree about how deep the ladder goes
BROWNOUT_MAX_RUNG = 3


@dataclass
class MemberSignal:
    """One member's load as seen at observation time."""

    member: str
    depth: int = 0
    inflight: int = 0
    spilling: int = 0
    draining: bool = False
    wait_p99_s: float = 0.0


@dataclass
class TierSignals:
    """One observation of the whole tier, normalized by an adapter.

    ``pressure`` is the scalar the hysteresis runs on: the tier's worst
    queue-wait p99 over its budget (so >= 1.0 means over budget), bumped
    to at least 1.0 whenever the observation window saw sheds — a shed IS
    the over-budget signal, whatever the percentiles say."""

    members: List[MemberSignal] = field(default_factory=list)
    pressure: float = 0.0
    storm: bool = False


class TierAutoscaler:
    """Hysteresis + cooldown control loop over a tier adapter.

    The adapter (``SpawnedTier`` for supervised subprocesses, the twin's
    virtual tier, the bench's in-thread tier) provides::

        observe() -> TierSignals     # may block on I/O; no lock held
        scale_up() -> None           # spawn + route one more member
        scale_down(index) -> None    # drain, retire, un-route member
        set_rung(rung) -> None       # push the brownout rung to members

    ``step()`` runs one control iteration and returns the actions taken.
    Call it from the reconcile loop (the operator) or a virtual-clock
    tick (the twin); ``start()`` runs it on a background thread for
    standalone deployments.
    """

    def __init__(
        self,
        tier,
        min_members: int,
        max_members: int,
        *,
        up_pressure: float = 1.0,
        down_pressure: float = 0.3,
        up_stable: int = 2,
        down_stable: int = 3,
        up_cooldown_s: float = 30.0,
        down_cooldown_s: float = 120.0,
        rung_up_stable: int = 2,
        rung_down_stable: int = 2,
        time_fn: Callable[[], float] = time.monotonic,
        on_decision: Optional[Callable[[str, str], None]] = None,
    ):
        if min_members < 1:
            raise ValueError(f"min_members must be >= 1, got {min_members}")
        if max_members < min_members:
            raise ValueError(
                f"max_members ({max_members}) < min_members ({min_members})"
            )
        if down_pressure >= up_pressure:
            raise ValueError(
                "down_pressure must sit below up_pressure "
                f"({down_pressure} >= {up_pressure}) — equal thresholds flap"
            )
        self.tier = tier
        self.min_members = min_members
        self.max_members = max_members
        self.up_pressure = up_pressure
        self.down_pressure = down_pressure
        self.up_stable = max(1, up_stable)
        self.down_stable = max(1, down_stable)
        self.up_cooldown_s = up_cooldown_s
        self.down_cooldown_s = down_cooldown_s
        self.rung_up_stable = max(1, rung_up_stable)
        self.rung_down_stable = max(1, rung_down_stable)
        self.time_fn = time_fn
        self.on_decision = on_decision
        self._state_lock = threading.RLock()
        self.rung = 0
        self._up_streak = 0
        self._down_streak = 0
        self._rung_up_streak = 0
        self._rung_down_streak = 0
        self._last_up_at: Optional[float] = None
        self._last_down_at: Optional[float] = None
        # deterministic decision log: (t, action, detail) — the twin
        # replays this byte-identically and the bench reads rung order
        self.decisions: List[Tuple[float, str, str]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the control iteration --------------------------------------------

    def step(self) -> List[Tuple[str, object]]:
        """One gather -> decide -> actuate iteration.

        Observation and actuation both block on I/O, so neither runs
        under ``_state_lock`` — only the pure policy does. Single-caller
        by contract (the reconcile loop or the background thread, never
        both)."""
        signals = self.tier.observe()
        now = float(self.time_fn())
        actions = self._decide(signals, now)
        for action, arg in actions:
            self._actuate(action, arg, signals)
        if self.on_decision is not None:
            for action, arg in actions:
                self.on_decision(action, str(arg))
        return actions

    def _decide(
        self, signals: TierSignals, now: float
    ) -> List[Tuple[str, object]]:
        with self._state_lock:
            n = len(signals.members)
            over = signals.pressure >= self.up_pressure
            under = signals.pressure <= self.down_pressure
            if over:
                self._up_streak += 1
                self._down_streak = 0
            elif under:
                self._down_streak += 1
                self._up_streak = 0
            else:
                # the hysteresis band: a signal bouncing between the
                # thresholds earns neither direction
                self._up_streak = 0
                self._down_streak = 0

            # rung streaks only accumulate where the ladder applies:
            # climb pressure only counts at max size (below max,
            # capacity comes first), descent pressure only counts while
            # a rung is held
            if n >= self.max_members and over:
                self._rung_up_streak += 1
            else:
                self._rung_up_streak = 0
            if self.rung > 0 and not over:
                self._rung_down_streak += 1
            else:
                self._rung_down_streak = 0

            actions: List[Tuple[str, object]] = []
            if over:
                if signals.storm:
                    # never grow a melting tier: a respawn storm means
                    # new members would join the same melt
                    actions.append(
                        ("hold", "respawn storm suppresses scale-up")
                    )
                elif (
                    n < self.max_members
                    and self._up_streak >= self.up_stable
                    and self._cooled(
                        self._last_up_at, self.up_cooldown_s, now
                    )
                ):
                    self._last_up_at = now
                    self._up_streak = 0
                    actions.append(
                        (
                            "up",
                            f"pressure={signals.pressure:.3f}"
                            f" n={n}->{n + 1}",
                        )
                    )
                elif (
                    n >= self.max_members
                    and self.rung < BROWNOUT_MAX_RUNG
                    and self._rung_up_streak >= self.rung_up_stable
                ):
                    self.rung += 1
                    self._rung_up_streak = 0
                    actions.append(("rung_up", self.rung))
            elif self.rung > 0:
                # descend the ladder fully before any scale-down: a
                # tier that still holds a rung was overloaded a moment
                # ago
                if self._rung_down_streak >= self.rung_down_stable:
                    self.rung -= 1
                    self._rung_down_streak = 0
                    actions.append(("rung_down", self.rung))
            elif (
                under
                and n > self.min_members
                and self._down_streak >= self.down_stable
                and self._cooled(self._last_down_at, self.down_cooldown_s, now)
            ):
                victim = self._victim(signals)
                if victim is None:
                    actions.append(
                        (
                            "hold",
                            "no drainable member (all spilling or draining)",
                        )
                    )
                else:
                    self._last_down_at = now
                    self._down_streak = 0
                    actions.append(("down", victim))
            for action, arg in actions:
                self.decisions.append((round(now, 3), action, str(arg)))
            return actions

    @staticmethod
    def _cooled(last_at: Optional[float], cooldown: float, now: float) -> bool:
        return last_at is None or now - last_at >= cooldown

    @staticmethod
    def _victim(signals: TierSignals) -> Optional[int]:
        """Least-loaded retirable member index, or None.

        A member mid-drain is already leaving; a member answering a spill
        is the tier's safety valve RIGHT NOW — draining it would turn a
        refusal-with-answer into a loss. Ties break on the lowest index
        so twin replays pick the same victim byte-for-byte."""
        candidates = [
            (ms.inflight + ms.spilling, ms.depth, i)
            for i, ms in enumerate(signals.members)
            if not ms.draining and ms.spilling == 0
        ]
        if not candidates:
            return None
        return min(candidates)[2]

    def _actuate(self, action: str, arg: object, signals: TierSignals) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        n = len(signals.members)
        if action == "up":
            self.tier.scale_up()
            m.SOLVER_FLEET_SCALE.inc({"direction": "up"})
            m.SOLVER_FLEET_SIZE.set(float(n + 1))
        elif action == "down":
            self.tier.scale_down(int(arg))
            m.SOLVER_FLEET_SCALE.inc({"direction": "down"})
            m.SOLVER_FLEET_SIZE.set(float(n - 1))
        elif action in ("rung_up", "rung_down"):
            self.tier.set_rung(int(arg))
            m.SOLVER_FLEET_SCALE.inc({"direction": action})

    # -- optional background loop -----------------------------------------

    def start(self, interval_s: float = 10.0) -> None:
        """Run ``step()`` on a daemon thread every ``interval_s`` until
        ``stop()``; the operator instead calls step() from reconcile, so
        this path is for standalone tiers."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — the loop must survive
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class SpawnedTier:
    """Production adapter: FleetSupervisor-spawned members + FleetRouter(s).

    ``observe()`` polls every member's ``GET /statz?reset=1`` (the gateway
    snapshot: per-tenant queue-wait percentiles over the window since the
    last poll, shed counts, depth, draining) and folds the router's
    in-flight/spill counts in; pressure is the tier's worst per-tenant
    wait p99 over ``wait_budget_s``, bumped to the over-budget threshold
    whenever the window saw sheds. All member lists (supervisor members,
    every router's members) stay index-aligned: scale events mutate them
    in lockstep.
    """

    def __init__(
        self,
        supervisor,
        routers,
        make_client,
        wait_budget_s: float = 1.0,
        poll_timeout: float = 5.0,
    ):
        if wait_budget_s <= 0:
            raise ValueError(
                f"wait_budget_s must be positive, got {wait_budget_s}"
            )
        self.supervisor = supervisor
        self.routers = list(routers)
        self.make_client = make_client
        self.wait_budget_s = wait_budget_s
        self.poll_timeout = poll_timeout

    def _statz(self, addr: str) -> Optional[dict]:
        import json
        import urllib.request

        try:
            with urllib.request.urlopen(
                f"http://{addr}/statz?reset=1", timeout=self.poll_timeout
            ) as resp:
                return json.loads(resp.read().decode())
        except (OSError, ValueError):
            return None

    def observe(self) -> TierSignals:
        storm = self.supervisor.respawn_storm()
        loads = self.routers[0].member_loads() if self.routers else {}
        members: List[MemberSignal] = []
        pressure = 0.0
        shed_seen = False
        for sup in self.supervisor.members:
            stats = self._statz(sup.addr) if sup.alive() else None
            inflight, spilling = loads.get(sup.member, (0, 0))
            if stats is None:
                # down or unreachable: respawn in flight — treat like a
                # draining member (never a scale-down victim)
                members.append(
                    MemberSignal(
                        member=sup.member,
                        inflight=inflight,
                        spilling=spilling,
                        draining=True,
                    )
                )
                continue
            p99 = max(
                (t.get("wait_p99_s", 0.0) for t in stats["tenants"].values()),
                default=0.0,
            )
            sheds = sum(int(v) for v in stats.get("sheds", {}).values())
            shed_seen = shed_seen or sheds > 0
            pressure = max(pressure, p99 / self.wait_budget_s)
            members.append(
                MemberSignal(
                    member=sup.member,
                    depth=int(stats.get("depth", 0)),
                    inflight=inflight,
                    spilling=spilling,
                    draining=bool(stats.get("draining", False)),
                    wait_p99_s=p99,
                )
            )
        if shed_seen:
            pressure = max(pressure, 1.0)
        return TierSignals(members=members, pressure=pressure, storm=storm)

    def scale_up(self) -> None:
        idx = self.supervisor.add_member()
        sup = self.supervisor.members[idx]
        for router in self.routers:
            router.add_member(
                self.make_client(sup.addr, sup.member), member_id=sup.member
            )

    def scale_down(self, index: int) -> None:
        # un-route FIRST so no new solve lands on the victim, then drain:
        # anything already in flight gets the gateway's 503 flush and
        # spills to a surviving member (an answered refusal, no breaker
        # charge)
        for router in self.routers:
            router.remove_member(index)
        self.supervisor.retire_member(index)

    def set_rung(self, rung: int) -> None:
        import json
        import urllib.request

        body = json.dumps({"rung": rung}).encode()
        for sup in self.supervisor.members:
            if not sup.alive():
                continue
            req = urllib.request.Request(
                f"http://{sup.addr}/brownout",
                data=body,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=self.poll_timeout):
                    pass
            except (OSError, ValueError):
                continue
