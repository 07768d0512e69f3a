"""fleetd: the multi-tenant solve gateway inside solverd.

One solverd used to serve exactly one operator: every request serialized
on a single FIFO lock, with no admission control and an unbounded
per-fingerprint scheduler cache. This module is the gateway that turns
the sidecar into a shared service for N operators (CvxCluster's "one fast
centralized allocator, many granular problems"; Tesserae's placement
serving that stays fair under many concurrent tenants):

* ``FleetGateway`` — a bounded admission queue with deadline-aware
  shedding (a request whose remaining client deadline cannot cover the
  observed p50 device time is rejected immediately, and the HTTP layer
  turns that into ``429 + Retry-After`` so solver/remote.py degrades the
  solve to the host greedy path), weighted fair scheduling across
  tenants, and a priority lane (provisioning solves dispatch ahead of
  consolidation sweeps) so one chatty or hung tenant cannot starve the
  rest;
* the host/device pipeline split — a request owns the device only
  between ``await_grant`` and ``release``; its host phases (codec
  decode before, codec encode after) run on its own handler thread, so
  the encode/decode of request B overlaps the device phase of request A;
* ``BoundedSchedulerCache`` — an LRU bound (entries + approximate
  bytes) with eviction metrics on the per-fingerprint DeviceScheduler
  cache, so a fleet of heterogeneous clusters cannot OOM the sidecar;
* the continuous-batching coalescer — a granted solve (the batch
  LEADER) collects up to ``max_batch - 1`` queued problems in the same
  compile-shape bucket (``collect_batch``; distinct fingerprints, fair
  vtime scan order) and solves them all under ONE exclusive device grant
  as a vmapped multi-problem batch (models/provisioner.solve_batch), the
  scheduler-gateway analogue of continuous batching in LLM serving.
  ``release_batch`` charges each tenant its pod-weighted share of the
  grant's device seconds so the WFQ vclock stays honest, and the shed
  estimator divides the backlog by the observed problems-per-grant so
  admission doesn't over-shed once batching raises throughput.

The gateway never creates threads: it sequences the caller's own handler
threads (ThreadingHTTPServer hands every request its own thread) with one
re-entrant lock and per-ticket events. All shared state is mutated under
``self._lock`` — including inside the ``_locked``-suffixed helpers, which
re-enter the RLock so the discipline is syntactically visible to
graftlint's GL302/GL303 and not an unstated caller contract.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

DEFAULT_TENANT = "default"

# the priority lane: provisioning solves ahead of consolidation sweeps —
# pending pods are unschedulable RIGHT NOW, a consolidation sweep is an
# optimization that can wait one grant
LANE_SOLVE = "solve"
LANE_SWEEP = "sweep"
_LANES = (LANE_SOLVE, LANE_SWEEP)

# admission defaults (service flags / operator passthrough override)
DEFAULT_QUEUE_DEPTH = 16
DEFAULT_CACHE_ENTRIES = 4
DEFAULT_CACHE_BYTES = 256 << 20
# continuous-batching defaults FOR THE SOLVERD FLAGS (the FleetGateway
# constructor itself defaults to max_batch=1/window=0 — batching off — so
# every pre-batching embedder keeps its exact semantics): one grant may
# coalesce up to 8 compatible problems, and a leader waits at most a few
# ms for still-decoding requests to reach the queue
DEFAULT_MAX_BATCH = 8
DEFAULT_BATCH_WINDOW_MS = 2.0
# distinct tenants the gateway keeps state for (vtime, wait samples): the
# id is client-supplied, so on a long-lived shared sidecar a client that
# varies it (a template interpolating a run id) must hit a bound, not a
# slow leak — idle tenants past the cap are forgotten and simply rejoin
# at the virtual clock like any idle tenant
TENANT_STATE_CAP = 1024
# device-time prior before any observation exists (a fresh sidecar must
# not shed its very first requests on a made-up estimate of infinity)
DEVICE_P50_BOOT = 0.5


class ShedError(Exception):
    """A request rejected by admission control (never by a fault).

    ``reason``: ``capacity`` (queue full), ``deadline`` (the remaining
    client deadline cannot cover the estimated queue wait + p50 device
    time), ``expired`` (the deadline lapsed while queued). ``retry_after``
    is the server's estimate, in seconds, of when a retry would be
    admitted — the HTTP layer ships it as the ``Retry-After`` header.
    """

    def __init__(self, reason: str, retry_after: float, message: str = ""):
        super().__init__(message or f"shed ({reason})")
        self.reason = reason
        self.retry_after = retry_after


class DrainError(Exception):
    """The gateway is draining: admission is closed and queued requests
    are being flushed ahead of a clean restart. The HTTP layer answers
    503 (drain ≠ shed ≠ fault: the client degrades this solve to greedy
    without charging the circuit breaker — the sidecar ANSWERED, it is
    restarting, not dead)."""

    def __init__(self, message: str = "gateway draining"):
        super().__init__(message)


class UnknownMemberError(LookupError):
    """A member-indexed fleet entry point (router ``set_member_addr``,
    supervisor ``drain``/``retire_member``, …) named an index outside the
    live member set. With dynamic membership (elastic scale, ISSUE 17)
    indices shift under retirement, so a stale index is an expected
    coordination race, not a programming error — callers catch THIS
    (``LookupError``) and re-observe, instead of a bare ``IndexError``
    escaping from list internals."""

    def __init__(self, index: int, size: int, site: str = ""):
        where = f" in {site}" if site else ""
        super().__init__(
            f"member index {index} outside live member set"
            f" [0, {size}){where}"
        )
        self.index = index
        self.size = size
        self.site = site


class QuarantinedError(Exception):
    """A request refused because its problem fingerprint is quarantined as
    a poison pill. The HTTP layer answers 422; the client routes the solve
    straight to greedy (and quarantines locally) without burning a device
    grant or charging the breaker."""

    def __init__(self, fingerprint: str, message: str = ""):
        super().__init__(
            message or f"fingerprint {fingerprint[:12]} quarantined"
        )
        self.fingerprint = fingerprint


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """``"a=3,b=1.5"`` -> ``{"a": 3.0, "b": 1.5}`` (the --tenant-weights
    flag format). Unlisted tenants get the gateway's default weight."""
    out: Dict[str, float] = {}
    for part in filter(None, (p.strip() for p in (spec or "").split(","))):
        name, _, value = part.partition("=")
        if not name or not value:
            raise ValueError(f"malformed tenant weight {part!r}")
        weight = float(value)
        if weight <= 0:
            raise ValueError(f"tenant weight must be positive: {part!r}")
        out[name] = weight
    return out


class Ticket:
    """One admitted request's pass through the gateway."""

    __slots__ = (
        "tenant", "lane", "submitted_at", "deadline_at",
        "ready_at", "granted_at", "event", "state",
        # continuous batching: the shape-bucket key + problem fingerprint
        # (set by the daemon after its host-phase decode, BEFORE
        # await_grant), the decoded payload a batch leader solves on the
        # member's behalf, and the result handoff (leader publishes,
        # member's handler thread encodes)
        "bucket", "fingerprint", "payload", "result", "error", "done",
        "batched_member",
    )

    def __init__(self, tenant: str, lane: str, submitted_at: float,
                 deadline_at: Optional[float]):
        self.tenant = tenant
        self.lane = lane
        self.submitted_at = submitted_at
        self.deadline_at = deadline_at
        self.ready_at: Optional[float] = None
        self.granted_at: Optional[float] = None
        self.event = threading.Event()
        # pending | queued | granted | batched | shed | drained | done
        self.state = "pending"
        # ONE-WAY marker set by collect_batch: the daemon branches member
        # vs leader on THIS, not on the mutable `state` — release_batch
        # overwrites a member's state to "done" while its handler thread
        # may still be waking, and a member that raced past that overwrite
        # on a state check would take the leader path without a grant
        self.batched_member = False
        self.bucket: Optional[str] = None
        self.fingerprint: Optional[str] = None
        self.payload = None
        self.result = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class FleetGateway:
    """Admission control + weighted fair device scheduling for N tenants.

    Life of a request (one handler thread end to end)::

        ticket = gateway.submit(tenant, lane, deadline)   # may shed
        problem = decode(body)            # host phase, device NOT held
        gateway.await_grant(ticket)       # fair-queued; may shed (expired)
        ...device solve...                # the ONLY exclusive section
        gateway.release(ticket, device_seconds)
        response = encode(results)        # host phase, device NOT held

    Fairness is virtual-time weighted fair queueing: each tenant
    accumulates ``device_seconds / weight`` per grant, and the dispatcher
    always grants the backlogged tenant with the smallest virtual time —
    so a tenant hammering the gateway advances its own clock and cannot
    starve a quiet one, while a weight-3 tenant gets ~3x the device share
    of a weight-1 tenant under contention. A tenant returning from idle
    is bumped to the current virtual clock so it cannot claim the device
    for its entire idle period retroactively.
    """

    def __init__(
        self,
        max_depth: int = DEFAULT_QUEUE_DEPTH,
        weights: Optional[Dict[str, float]] = None,
        default_weight: float = 1.0,
        p50_boot: float = DEVICE_P50_BOOT,
        window: int = 64,
        time_fn=time.monotonic,
        max_batch: int = 1,
        batch_window: float = 0.0,
    ):
        if max_depth <= 0:
            raise ValueError(f"max_depth must be positive, got {max_depth}")
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        if batch_window < 0:
            raise ValueError(
                f"batch_window must be >= 0, got {batch_window}"
            )
        self.max_depth = max_depth
        self.weights = dict(weights or {})
        self.default_weight = default_weight
        # continuous batching: a granted solve may collect up to
        # max_batch-1 compatible queued problems (same shape bucket,
        # distinct fingerprints) to ride its device grant as one vmapped
        # batch; batch_window (seconds) bounds how long the leader may
        # hold the device idle waiting for still-decoding requests to
        # reach the queue. max_batch=1 is the pre-batching gateway.
        self.max_batch = max_batch
        self.batch_window = batch_window
        self.time_fn = time_fn
        # RLock on purpose: the _locked helpers re-acquire it so every
        # shared-state write is syntactically inside a `with self._lock`
        self._lock = threading.RLock()
        self._device_times: deque = deque(maxlen=window)
        self._p50_boot = p50_boot
        # submitted and not yet finished (queued + decoding + on device)
        self._pending = 0
        # tenant -> lane -> FIFO of ready tickets
        self._queued: Dict[str, Dict[str, deque]] = {}
        self._vtime: Dict[str, float] = {}
        self._vclock = 0.0
        self._active: Optional[Ticket] = None
        # bench/test observability (the REGISTRY instruments aggregate
        # process-wide; these are per-gateway and resettable)
        self._wait_samples: Dict[str, deque] = {}
        self._shed_counts: Dict[str, int] = {}
        self._grant_count = 0
        # batch accounting: per-grant problem counts (the shed estimator's
        # amortization factor), members currently riding a leader's grant,
        # lifetime coalesced-problem count
        self._batch_sizes: deque = deque(maxlen=window)
        self._batched_inflight = 0
        self._coalesced = 0
        # per-lane count of tickets still in state "pending" (submitted,
        # host decode running, not yet queued): what the batching window
        # consults — only a mid-decode SOLVE request can coalesce, so a
        # leader must not hold the device idle for sweep traffic
        self._preparing_counts = {lane: 0 for lane in _LANES}
        # drain mode: admission closed, queue flushed with 503s ahead of a
        # clean (supervisor-respawned) process exit
        self._draining = False

    # -- admission ---------------------------------------------------------

    def device_p50(self) -> float:
        with self._lock:
            return self._device_p50_locked()

    def _device_p50_locked(self) -> float:
        """Observed per-GRANT device p50. One observation is recorded per
        exclusive device grant (release_batch), NOT per request — with
        batching on, one grant serves several requests, and an estimator
        that multiplied the backlog by a per-request time would over-shed
        exactly when batching raises effective throughput."""
        if not self._device_times:
            return self._p50_boot
        ts = sorted(self._device_times)
        return ts[len(ts) // 2]

    def _avg_batch_locked(self) -> float:
        """Observed mean problems-per-grant (>= 1): the amortization
        factor the expected-wait model divides the backlog by."""
        if not self._batch_sizes:
            return 1.0
        return max(sum(self._batch_sizes) / len(self._batch_sizes), 1.0)

    def submit(
        self,
        tenant: str = DEFAULT_TENANT,
        lane: str = LANE_SOLVE,
        deadline: Optional[float] = None,
    ) -> Ticket:
        """Admission decision, made BEFORE the request body is decoded (a
        shed must cost the sidecar nothing). Raises ShedError (overload),
        DrainError (restarting), or returns a Ticket the caller must
        resolve via await_grant+release (or abandon on a pre-grant
        failure)."""
        if lane not in _LANES:
            raise ValueError(f"unknown lane {lane!r}")
        with self._lock:
            if self._draining:
                raise DrainError()
            now = self.time_fn()
            p50 = self._device_p50_locked()
            batch = self._avg_batch_locked()
            if self._pending >= self.max_depth:
                # the backlog drains one GRANT (~avg_batch requests) per
                # ~p50 device seconds; the whole backlog must clear
                # before a retry is admitted
                grants_left = -(-self._pending // max(int(batch), 1))
                retry_after = max(grants_left * p50, p50)
                self._count_shed_locked(tenant, "capacity")
                raise ShedError(
                    "capacity", retry_after,
                    f"admission queue full ({self._pending}/{self.max_depth})",
                )
            if deadline is not None:
                # expected wait = grants needed to serve everyone ahead
                # plus this request, at the observed per-grant p50 and the
                # observed batch amortization (avg problems per grant) —
                # NOT one grant per pending request, which would over-shed
                # whenever batching raises effective throughput
                grants_needed = max(
                    (self._pending + 1) / batch, 1.0
                )
                estimate = grants_needed * p50
                if deadline < estimate:
                    retry_after = max(estimate - deadline, p50)
                    self._count_shed_locked(tenant, "deadline")
                    raise ShedError(
                        "deadline", retry_after,
                        f"deadline {deadline:.3f}s cannot cover estimated"
                        f" {estimate:.3f}s (p50 device/grant {p50:.3f}s,"
                        f" avg batch {batch:.2f}, {self._pending} ahead)",
                    )
            self._pending += 1
            ticket = Ticket(
                tenant, lane, now,
                None if deadline is None else now + deadline,
            )
            self._preparing_counts[lane] += 1
            self._export_depth_locked()
            return ticket

    def _count_shed_locked(self, tenant: str, reason: str) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            self._shed_counts[reason] = self._shed_counts.get(reason, 0) + 1
        m.SOLVERD_SHED.inc({"tenant": tenant, "reason": reason})

    # -- fair queueing -----------------------------------------------------

    def await_grant(self, ticket: Ticket) -> None:
        """Block the calling handler thread until the fair scheduler hands
        this ticket the device. Raises ShedError if the ticket's deadline
        expired while it queued (the client has already degraded to
        greedy; running the solve anyway would burn device time on an
        answer nobody reads), or DrainError when the gateway drained the
        queue out from under it."""
        with self._lock:
            if self._draining:
                ticket.state = "drained"
                self._pending -= 1
                self._preparing_counts[ticket.lane] -= 1
                self._export_depth_locked()
                raise DrainError()
            ticket.ready_at = self.time_fn()
            ticket.state = "queued"
            self._preparing_counts[ticket.lane] -= 1
            lanes = self._queued.get(ticket.tenant)
            if lanes is None:
                lanes = self._queued[ticket.tenant] = {
                    lane: deque() for lane in _LANES
                }
            if not any(lanes[lane] for lane in _LANES):
                # returning from idle: jump to the current virtual clock —
                # an idle period is not a credit voucher
                self._vtime[ticket.tenant] = max(
                    self._vtime.get(ticket.tenant, 0.0), self._vclock
                )
            lanes[ticket.lane].append(ticket)
            self._dispatch_locked()
        ticket.event.wait()
        if ticket.state == "shed":
            raise ShedError(
                "expired", self.device_p50(),
                "deadline expired while queued",
            )
        if ticket.state == "drained":
            raise DrainError()

    def _dispatch_locked(self) -> None:
        with self._lock:
            if self._active is not None:
                return
            from karpenter_core_tpu_torch.metrics import wiring as m

            now = self.time_fn()
            while True:
                ticket = self._pick_locked()
                if ticket is None:
                    return
                if (
                    ticket.deadline_at is not None
                    and now > ticket.deadline_at
                ):
                    ticket.state = "shed"
                    self._pending -= 1
                    self._count_shed_locked(ticket.tenant, "expired")
                    self._export_depth_locked()
                    ticket.event.set()
                    continue
                break
            ticket.state = "granted"
            ticket.granted_at = now
            self._active = ticket
            # monotone: a stale-vtime grant (a sweep held back behind the
            # solve lane) must not roll the clock backwards, or the
            # idle-rejoin bump would re-open the retroactive-credit hole
            self._vclock = max(
                self._vclock, self._vtime.get(ticket.tenant, 0.0)
            )
            self._grant_count += 1
            self._record_wait_locked(ticket, now)
            ticket.event.set()

    def _record_wait_locked(self, ticket: Ticket, now: float) -> None:
        """Grant-time queue-wait bookkeeping, shared by the dispatcher and
        the batch coalescer: the per-tenant p99 the shed estimator, bench,
        and snapshot() read must see EVERY way off the queue identically."""
        with self._lock:
            from karpenter_core_tpu_torch.metrics import wiring as m

            wait = now - (ticket.ready_at or now)
            m.SOLVERD_QUEUE_WAIT.observe(wait, {"tenant": ticket.tenant})
            samples = self._wait_samples.get(ticket.tenant)
            if samples is None:
                samples = self._wait_samples[ticket.tenant] = deque(
                    maxlen=512
                )
            samples.append(wait)

    def _pick_locked(self) -> Optional[Ticket]:
        """Smallest-virtual-time backlogged tenant; the solve lane drains
        before any sweep is considered (provisioning ahead of
        consolidation). Ties break on tenant name for determinism."""
        with self._lock:
            for lane in _LANES:
                candidates = [
                    (self._vtime.get(tenant, 0.0), tenant)
                    for tenant, lanes in self._queued.items()
                    if lanes[lane]
                ]
                if candidates:
                    _, tenant = min(candidates)
                    return self._queued[tenant][lane].popleft()
            return None

    def release(self, ticket: Ticket, device_seconds: float) -> None:
        """Device phase over: record the observation, charge the tenant's
        virtual time, and grant the next ticket (the single-problem
        wrapper over release_batch — a solo grant IS a batch of one)."""
        self.release_batch([(ticket, 1.0)], device_seconds)

    # -- continuous batching (coalesce compatible queued problems) ---------

    def collect_batch(self, leader: Ticket, limit: int = None) -> List[Ticket]:
        """Pop up to ``limit`` queued solve-lane tickets compatible with
        the GRANTED leader — same shape bucket, DISTINCT problem
        fingerprints (a fingerprint maps to one cached DeviceScheduler,
        which is single-solve stateful) — to ride its device grant as one
        vmapped multi-problem batch. Their handler threads wake with
        state="batched" and block in await_batched for the leader's
        per-problem outcome; expired tickets found on the way shed exactly
        as the dispatcher would. Tenants are scanned in virtual-time order
        so coalescing cannot become a side door around fair queueing."""
        if limit is None:
            limit = self.max_batch - 1
        members: List[Ticket] = []
        if limit <= 0 or leader.bucket is None:
            return members
        with self._lock:
            if self._active is not leader:
                return members
            now = self.time_fn()
            seen = {leader.fingerprint}
            for tenant in sorted(
                self._queued, key=lambda t: (self._vtime.get(t, 0.0), t)
            ):
                if len(members) >= limit:
                    break
                q = self._queued[tenant][LANE_SOLVE]
                kept: deque = deque()
                while q and len(members) < limit:
                    t = q.popleft()
                    if (
                        t.bucket is None
                        or t.bucket != leader.bucket
                        or t.fingerprint in seen
                    ):
                        kept.append(t)
                        continue
                    if t.deadline_at is not None and now > t.deadline_at:
                        t.state = "shed"
                        self._pending -= 1
                        self._count_shed_locked(t.tenant, "expired")
                        t.event.set()
                        continue
                    t.batched_member = True
                    t.state = "batched"
                    t.granted_at = now
                    seen.add(t.fingerprint)
                    self._record_wait_locked(t, now)
                    members.append(t)
                    t.event.set()
                while q:  # preserve FIFO order for everything skipped
                    kept.append(q.popleft())
                self._queued[tenant][LANE_SOLVE] = kept
            self._batched_inflight += len(members)
            self._export_depth_locked()
            return members

    def compatible_queued(self, leader: Ticket) -> int:
        """How many queued solve-lane tickets collect_batch could pop for
        this leader RIGHT NOW (same shape bucket, distinct fingerprints).
        The batching window's short-circuit: a leader whose batch is
        already fillable from the queue must not hold the device idle
        waiting for more."""
        if leader.bucket is None:
            return 0
        with self._lock:
            seen = {leader.fingerprint}
            n = 0
            for lanes in self._queued.values():
                for t in lanes[LANE_SOLVE]:
                    if t.bucket == leader.bucket and t.fingerprint not in seen:
                        seen.add(t.fingerprint)
                        n += 1
            return n

    def preparing(self, lane: str = LANE_SOLVE) -> int:
        """Tickets in the given lane submitted but not yet queued —
        requests still in their host decode phase. The batching window
        only pays off when one of these could reach the queue before the
        leader dispatches, so the daemon consults this before holding the
        device idle for the window; it is per-lane because only a
        mid-decode SOLVE request can ever coalesce onto a solve grant —
        sweep traffic must not buy device idle."""
        with self._lock:
            return self._preparing_counts.get(lane, 0)

    def finish_batched(self, ticket: Ticket, result=None,
                       error: BaseException = None) -> None:
        """Leader -> member handoff: publish one member's per-problem
        outcome and wake its handler thread (which encodes its own
        response — the host fan-out stays off the device window)."""
        ticket.result = result
        ticket.error = error
        ticket.done.set()

    def await_batched(self, ticket: Ticket):
        """Member side: block until the batch leader publishes this
        problem's outcome; re-raise its ISOLATED error (one poisoned
        batch member fails alone) or return the result."""
        ticket.done.wait()
        if ticket.error is not None:
            raise ticket.error
        return ticket.result

    def release_batch(
        self, shares: List[tuple], device_seconds: float
    ) -> None:
        """One device grant finished having served ``len(shares)``
        problems: record ONE per-grant device-time observation (the
        admission estimator's unit is the grant, not the request), charge
        each tenant its share of the batch's device seconds (the daemon
        weights shares by problem pod count), and grant the next ticket.

        ``shares``: ``[(ticket, weight), ...]`` — leader first, then the
        collected members; weights are normalized here."""
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            dt = max(device_seconds, 0.0)
            self._device_times.append(dt)
            self._batch_sizes.append(len(shares))
            m.SOLVERD_BATCH_SIZE.observe(float(len(shares)))
            if len(shares) > 1:
                self._coalesced += len(shares) - 1
                m.SOLVERD_BATCH_COALESCED.inc(by=len(shares) - 1)
            total = sum(max(s, 0.0) for _, s in shares) or 1.0
            for ticket, share in shares:
                weight = max(
                    self.weights.get(ticket.tenant, self.default_weight),
                    1e-9,
                )
                self._vtime[ticket.tenant] = (
                    self._vtime.get(ticket.tenant, 0.0)
                    + dt * (max(share, 0.0) / total) / weight
                )
                if ticket.state == "batched":
                    self._batched_inflight -= 1
                ticket.state = "done"
                self._pending -= 1
            self._active = None
            self._export_depth_locked()
            self._dispatch_locked()
            self._prune_locked()

    def _prune_locked(self) -> None:
        """Bound the per-tenant maps. Tenant ids arrive from the client,
        so without pruning every distinct id leaks a vtime float, a lane
        dict, and a wait deque for the sidecar's lifetime."""
        with self._lock:
            # empty lane dicts are pure bookkeeping — recreated on demand
            for tenant in [
                t for t, lanes in self._queued.items()
                if not any(lanes[lane] for lane in _LANES)
            ]:
                del self._queued[tenant]
            if len(self._vtime) > TENANT_STATE_CAP:
                # an idle tenant at-or-behind the clock carries no
                # information: rejoining would bump it to the clock anyway
                for tenant in [
                    t for t, v in self._vtime.items()
                    if t not in self._queued and v <= self._vclock
                ]:
                    del self._vtime[tenant]
            if len(self._vtime) > TENANT_STATE_CAP:
                # still over (many ahead-of-clock idles): trim smallest
                # vtime first — forgetting forgives at most their lead
                idle = sorted(
                    (v, t) for t, v in self._vtime.items()
                    if t not in self._queued
                )
                for _v, tenant in idle[: len(self._vtime) - TENANT_STATE_CAP]:
                    del self._vtime[tenant]
            if len(self._wait_samples) > TENANT_STATE_CAP:
                for tenant in [
                    t for t in self._wait_samples if t not in self._queued
                ][: len(self._wait_samples) - TENANT_STATE_CAP]:
                    del self._wait_samples[tenant]

    def abandon(self, ticket: Ticket) -> None:
        """A request failed between submit and grant (decode error, client
        gone): return its admission slot. Safe on granted tickets too (a
        device-phase exception path), where it behaves like a zero-cost
        release."""
        with self._lock:
            if ticket.state == "queued":
                lanes = self._queued.get(ticket.tenant)
                if lanes is not None:
                    for lane in _LANES:
                        try:
                            lanes[lane].remove(ticket)
                        except ValueError:
                            pass
            if ticket.state == "granted" and self._active is ticket:
                self._active = None
            if ticket.state in ("pending", "queued", "granted", "batched"):
                if ticket.state == "batched":
                    self._batched_inflight -= 1
                if ticket.state == "pending":
                    self._preparing_counts[ticket.lane] -= 1
                ticket.state = "done"
                self._pending -= 1
                self._export_depth_locked()
            self._dispatch_locked()

    # -- drain (the crash-only restart path) -------------------------------

    def drain(self) -> int:
        """Close admission and flush every queued ticket with a drain
        rejection (their handler threads answer 503 — queued requests must
        never just VANISH into a process exit). The active device ticket,
        if any, is left to finish or be watchdog-killed; returns the number
        of tickets flushed."""
        with self._lock:
            self._draining = True
            flushed = 0
            for lanes in list(self._queued.values()):
                for lane in _LANES:
                    while lanes[lane]:
                        ticket = lanes[lane].popleft()
                        ticket.state = "drained"
                        self._pending -= 1
                        flushed += 1
                        ticket.event.set()
            self._export_depth_locked()
            return flushed

    def resume(self) -> None:
        """Re-open admission (in-thread test servers; a real sidecar exits
        after drain and respawns fresh)."""
        with self._lock:
            self._draining = False

    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def set_batch_window(self, seconds: float) -> None:
        """Retune the coalescing window live (brownout rung 2 widens it
        to force deeper batches; descent restores the original)."""
        if seconds < 0:
            raise ValueError(f"batch_window must be >= 0, got {seconds}")
        with self._lock:
            self.batch_window = seconds

    def set_max_depth(self, depth: int) -> None:
        """Retune admission capacity live (brownout rung 3 halves it so
        shedding starts earlier; descent restores the original). Already
        queued tickets above a lowered bound stay queued — the bound
        gates NEW admissions only."""
        if depth <= 0:
            raise ValueError(f"max_depth must be positive, got {depth}")
        with self._lock:
            self.max_depth = depth

    def batch_stats(self) -> dict:
        """Lightweight batch telemetry for /healthz (snapshot() computes
        percentiles — too heavy for a probe path)."""
        with self._lock:
            return {
                "max_batch": self.max_batch,
                "window_s": self.batch_window,
                "coalesced": self._coalesced,
                "mean_size": round(self._avg_batch_locked(), 3),
                # members riding a leader's grant RIGHT NOW — nonzero
                # while a coalesced batch is on the device
                "inflight_members": self._batched_inflight,
            }

    # -- observability -----------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return self._pending

    def saturated(self) -> bool:
        with self._lock:
            return self._pending >= self.max_depth

    def _export_depth_locked(self) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            m.SOLVERD_QUEUE_DEPTH.set(float(self._pending))

    def snapshot(self, reset: bool = False) -> dict:
        """Per-gateway stats for the bench/tests (the REGISTRY instruments
        are process-global and never reset): per-tenant queue-wait
        percentiles over the recent sample window, shed counts by reason,
        grant count, current depth."""
        with self._lock:
            def q(samples: List[float], p: float) -> float:
                if not samples:
                    return 0.0
                ts = sorted(samples)
                return ts[min(int(round(p * (len(ts) - 1))), len(ts) - 1)]

            out = {
                "tenants": {
                    tenant: {
                        "n": len(samples),
                        "wait_p50_s": round(q(list(samples), 0.50), 6),
                        "wait_p99_s": round(q(list(samples), 0.99), 6),
                    }
                    for tenant, samples in sorted(self._wait_samples.items())
                },
                "sheds": dict(sorted(self._shed_counts.items())),
                "grants": self._grant_count,
                "depth": self._pending,
                "draining": self._draining,
                "device_p50_s": round(self._device_p50_locked(), 6),
                "batch": {
                    "max_batch": self.max_batch,
                    "window_s": self.batch_window,
                    "coalesced": self._coalesced,
                    "mean_size": round(self._avg_batch_locked(), 3),
                },
            }
            if reset:
                self._wait_samples = {}
                self._shed_counts = {}
                self._grant_count = 0
                self._batch_sizes.clear()
                self._coalesced = 0
            return out


# poison-pill defaults (service flags / client kwargs override)
QUARANTINE_STRIKES = 3
QUARANTINE_TTL = 300.0
QUARANTINE_CAP = 1024


class PoisonQuarantine:
    """TTL'd poison-pill ledger over request digests (codec.request_digest:
    sha256 of the canonical body for full-wire requests — PR 4 made wire
    bytes canonical per logical problem — and the manifest CORE for
    delta-wire requests, so the digest stays stable across retries AND
    across the miss/re-upload handshake's changing upload payloads).

    A problem that crashes, hangs, corrupts its result, or fails
    verification ``strikes`` times inside the TTL window is quarantined:
    for ``ttl`` seconds it routes straight to the greedy path (client
    site) or is refused pre-decode with 422 (gateway site) instead of
    burning device grants — and, for the wedge-the-process shapes,
    sidecar respawns — for every tenant. A success clears the strike
    count; quarantine entries expire on their own (the problem gets a
    fresh chance — the fault may have been environmental).

    The optional journal is the crash-only half: the gateway records the
    fingerprint it is ABOUT to solve (``begin``) and clears it on
    completion (``done``), so a poison pill that kills the process is
    found in the journal at next boot and charged a strike even though
    the process that hit it never got to say so.

    All shared state is mutated under ``self._lock`` (the ``_locked``
    helper discipline graftlint GL302/GL303 checks)."""

    def __init__(
        self,
        strikes: int = QUARANTINE_STRIKES,
        ttl: float = QUARANTINE_TTL,
        cap: int = QUARANTINE_CAP,
        time_fn=time.monotonic,
        site: str = "client",
        journal_path: Optional[str] = None,
    ):
        if strikes <= 0:
            raise ValueError(f"strikes must be positive, got {strikes}")
        self.strikes = strikes
        self.ttl = ttl
        self.cap = cap
        self.time_fn = time_fn
        self.site = site
        self.journal_path = journal_path
        self._lock = threading.RLock()
        self._strike_counts: Dict[str, tuple] = {}  # fp -> (count, last_at)
        self._entries: Dict[str, float] = {}  # fp -> quarantined_until
        self._inflight: set = set()
        if journal_path is not None:
            self._recover_journal()

    # -- the ledger --------------------------------------------------------

    def strike(self, fingerprint: str, reason: str = "fault") -> bool:
        """Record one fault against a fingerprint; returns True when this
        strike tipped it into quarantine."""
        with self._lock:
            now = self.time_fn()
            count, last_at = self._strike_counts.get(fingerprint, (0, now))
            if now - last_at > self.ttl:
                count = 0  # stale streak: faults outside the window forgive
            count += 1
            self._strike_counts[fingerprint] = (count, now)
            if count < self.strikes:
                self._prune_locked(now)
                return False
            self._entries[fingerprint] = now + self.ttl
            del self._strike_counts[fingerprint]
            self._prune_locked(now)
            self._export_locked()
            return True

    def poison(self, fingerprint: str) -> None:
        """Quarantine immediately (the gateway already counted its strikes
        and told us via 422 — no reason to re-learn locally)."""
        with self._lock:
            self._entries[fingerprint] = self.time_fn() + self.ttl
            self._strike_counts.pop(fingerprint, None)
            self._prune_locked(self.time_fn())
            self._export_locked()

    def quarantined(self, fingerprint: str) -> bool:
        with self._lock:
            until = self._entries.get(fingerprint)
            if until is None:
                return False
            if self.time_fn() >= until:
                del self._entries[fingerprint]
                self._export_locked()
                return False
            return True

    def clear(self, fingerprint: str) -> None:
        """A success: the problem is not poison — drop its strike streak.
        An ACTIVE quarantine entry stays until its TTL (a success can only
        have come from the greedy path while quarantined)."""
        with self._lock:
            self._strike_counts.pop(fingerprint, None)

    def size(self) -> int:
        with self._lock:
            now = self.time_fn()
            stale = [fp for fp, t in self._entries.items() if now >= t]
            for fp in stale:
                del self._entries[fp]
            if stale:
                self._export_locked()
            return len(self._entries)

    def _prune_locked(self, now: float) -> None:
        """Bound both maps: fingerprints are derived from client-supplied
        bodies, so an unbounded ledger is a memory leak with extra steps."""
        with self._lock:
            if len(self._strike_counts) > self.cap:
                stale = sorted(
                    self._strike_counts.items(), key=lambda kv: kv[1][1]
                )
                for fp, _ in stale[: len(self._strike_counts) - self.cap]:
                    del self._strike_counts[fp]
            expired = [fp for fp, t in self._entries.items() if now >= t]
            for fp in expired:
                del self._entries[fp]
            if len(self._entries) > self.cap:
                soonest = sorted(self._entries.items(), key=lambda kv: kv[1])
                for fp, _ in soonest[: len(self._entries) - self.cap]:
                    del self._entries[fp]

    def _export_locked(self) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            m.SOLVER_QUARANTINE_ENTRIES.set(
                float(len(self._entries)), {"site": self.site}
            )

    # -- crash-only journal ------------------------------------------------

    def begin(self, fingerprint: str) -> None:
        """Mark a fingerprint in flight on the device. If the process dies
        before ``done``, the next boot finds it in the journal and charges
        the crash it never lived to report."""
        if self.journal_path is None:
            return
        with self._lock:
            self._inflight.add(fingerprint)
            self._write_journal_locked()

    def done(self, fingerprint: str) -> None:
        if self.journal_path is None:
            return
        with self._lock:
            self._inflight.discard(fingerprint)
            self._write_journal_locked()

    def _write_journal_locked(self) -> None:
        import json as _json
        import os as _os

        with self._lock:
            # write-temp + atomic rename: the journal exists to survive a
            # process death, so the death must never catch it half-written
            # (a torn in-place rewrite would parse as garbage at recovery
            # and silently forget the very strike it was recording)
            tmp = f"{self.journal_path}.tmp"
            try:
                # graftlint: disable=GL705 -- deliberate: the write+rename
                # must stay serialized with the snapshot it records, or two
                # racing writers can land an OLDER journal over a newer one
                # (lost strike at recovery). The quarantine lock guards only
                # strike metadata — never the device grant (GL304 covers
                # that) — and the journal is a few hundred bytes on local
                # disk, so the tail this blocks is bounded and private.
                with open(tmp, "w") as f:
                    _json.dump(
                        {
                            "inflight": sorted(self._inflight),
                            "strikes": {
                                fp: count
                                for fp, (count, _at) in
                                self._strike_counts.items()
                            },
                        },
                        f,
                    )
                _os.replace(tmp, self.journal_path)
            except OSError:
                pass  # journal loss degrades protection, never the solve

    def _recover_journal(self) -> None:
        import json as _json

        try:
            with open(self.journal_path) as f:
                state = _json.load(f)
        except (OSError, ValueError):
            return
        now = self.time_fn()
        with self._lock:
            for fp, count in dict(state.get("strikes", {})).items():
                self._strike_counts[fp] = (int(count), now)
        # every fingerprint in flight at death gets the strike the dead
        # process could not record — N wedge-deaths in a row quarantine it
        for fp in state.get("inflight", []):
            self.strike(fp, "crash-recovered")
        # persist the merged view with the inflight set CLEARED: the
        # strike is recorded now, and a later clean boot must not
        # re-charge it
        with self._lock:
            self._write_journal_locked()


class BoundedSchedulerCache:
    """LRU over fingerprint -> DeviceScheduler with an entry AND an
    approximate-byte bound, so a fleet of heterogeneous clusters (every
    distinct problem half is its own entry) cannot grow the sidecar's
    memory without bound. ``approx_bytes`` is the caller's proxy for the
    entry's weight — solverd passes the encoded request size, which
    tracks catalog/node-count scale without walking device buffers.
    Evictions are observable (`solverd_scheduler_cache_evictions_total`
    by reason, entry/byte gauges) so a fleet dashboard can tell "cache
    too small for this tenant mix" from "cold tenant"."""

    def __init__(
        self,
        max_entries: int = DEFAULT_CACHE_ENTRIES,
        max_bytes: int = DEFAULT_CACHE_BYTES,
    ):
        if max_entries <= 0:
            raise ValueError(
                f"max_entries must be positive, got {max_entries}"
            )
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._bytes = 0
        self.evictions: Dict[str, int] = {}

    def get(self, fingerprint: str):
        with self._lock:
            hit = self._entries.get(fingerprint)
            if hit is None:
                return None
            self._entries.move_to_end(fingerprint)
            return hit[0]

    def put(self, fingerprint: str, scheduler, approx_bytes: int) -> None:
        with self._lock:
            old = self._entries.pop(fingerprint, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[fingerprint] = (scheduler, int(approx_bytes))
            self._bytes += int(approx_bytes)
            while len(self._entries) > self.max_entries:
                self._evict_locked("entries")
            # strict bound — even a single oversized problem may not pin
            # more than the budget (it still SERVES, just uncached)
            while self._bytes > self.max_bytes and self._entries:
                self._evict_locked("bytes")
            self._export_locked()

    def _evict_locked(self, reason: str) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            _fp, (_sched, nbytes) = self._entries.popitem(last=False)
            self._bytes -= nbytes
            self.evictions[reason] = self.evictions.get(reason, 0) + 1
        m.SOLVERD_SCHED_CACHE_EVICTIONS.inc({"reason": reason})

    def _export_locked(self) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            m.SOLVERD_SCHED_CACHE_ENTRIES.set(float(len(self._entries)))
            m.SOLVERD_SCHED_CACHE_BYTES.set(float(self._bytes))

    # dict-like views the solverd tests/ops surface read

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, fingerprint: str) -> bool:
        with self._lock:
            return fingerprint in self._entries

    def values(self) -> list:
        with self._lock:
            return [sched for sched, _bytes in self._entries.values()]

    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes
