"""RemoteSolver: the control-plane client of the solverd sidecar.

``RemoteScheduler`` presents the exact surface the provisioner consumes
(``solve(pods) -> Results``, the Scheduler/DeviceScheduler contract) while
the device work happens in another process (solver/service.py). Fault
tolerance is the point of the seam:

* per-request deadline (the HTTP timeout covers connect AND read, so a
  hung sidecar surfaces as ``socket.timeout`` within the budget);
* bounded retry with exponential backoff;
* a circuit breaker that trips after consecutive failures and half-opens
  after a cooldown, so a dead sidecar costs one fast-failed call per solve
  instead of retries×timeout (exported per tenant on the
  ``solver_circuit_breaker_state`` gauge, so a fleet dashboard sees WHICH
  operators are degraded);
* overload cooperation — the fleet gateway's 429 sheds carry a
  ``Retry-After`` estimate, which replaces the fixed exponential backoff
  for the next attempt; a Retry-After past the solve budget degrades
  immediately, and a shed never charges the breaker (the sidecar answered
  — it is regulating, not dead);
* graceful degradation — any RPC failure falls back to the host greedy
  Scheduler over the SAME inputs, so the cluster degrades to greedy parity
  instead of stalling provisioning (the in-solver twin of the device
  solver's own ``_host_fallback_add`` repair path).

Every request ships the client's tenant id (``X-Solver-Tenant`` + the wire
field) and its remaining deadline (``X-Solver-Deadline``), which is what
lets the gateway shed hopeless work instead of timing it out.

``FaultInjector`` scripts deterministic timeout/error/slow schedules into
the client (the cloudprovider/fake.py error-injection pattern) so every
degradation path is testable without real process failures.
"""
from __future__ import annotations

import hashlib
import http.client
import socket
import threading
import time
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.solver import codec

STATE_CLOSED = 0
STATE_HALF_OPEN = 1
STATE_OPEN = 2

_STATE_NAMES = {0: "closed", 1: "half-open", 2: "open"}

# causes where the sidecar ANSWERED — alive and regulating/restarting/
# refusing — so the breaker is never charged and retries are pointless
# (segment_miss is the delta wire's typed miss: the sidecar is alive and
# asking for bytes, the caller re-uploads — PR 5's shed contract, ISSUE 14)
_ANSWERED_CAUSES = ("shed", "drain", "poisoned", "segment_miss")


class RemoteSolverError(Exception):
    """An RPC abandoned after retries (or short-circuited)."""

    def __init__(
        self, cause: str, message: str = "",
        retry_after: Optional[float] = None,
    ):
        super().__init__(message or cause)
        # timeout | error | circuit_open | injected | shed | drain |
        # poisoned | segment_miss | corrupt (a result wire whose FIELDS
        # decoded but whose content is malformed — raised by
        # RemoteScheduler._materialize)
        self.cause = cause
        # server-estimated seconds until a retry would be admitted (429
        # sheds only); honored by call()'s backoff in place of the fixed
        # exponential schedule
        self.retry_after = retry_after
        # segment_miss payload: the digests the sidecar's store cannot
        # produce, and the answering daemon's instance id (what the
        # client's sent-cache keys on)
        self.need: List[str] = []
        self.instance: str = ""


class FaultInjector:
    """Scripted per-call faults, consumed in order; exhausted -> healthy.

    Entries: ``"ok"``, ``"error"`` (injected exception before transport),
    ``"timeout"`` (simulated deadline miss), ``"hang"`` (sleeps the client's
    full timeout, then times out — the slow-sidecar shape), ``"slow:<s>"``
    (adds latency, call still succeeds)."""

    def __init__(self, schedule: Optional[List[str]] = None):
        self.schedule = list(schedule or [])
        self.calls = 0

    def next_fault(self) -> str:
        self.calls += 1
        if self.schedule:
            return self.schedule.pop(0)
        return "ok"


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing."""

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown: float = 15.0,
        time_fn=time.monotonic,
        on_state_change=None,
        tenant: str = "default",
        member: str = "",
    ):
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self.time_fn = time_fn
        self.on_state_change = on_state_change
        self.tenant = tenant
        # fleet-member identity ("" outside fleet mode): per-member
        # breakers are what let the router keep serving from healthy
        # members while ONE member is dark
        self.member = member
        self.state = STATE_CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self._export()

    def _export(self) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        # tenant-labeled: each operator in the fleet owns its own breaker
        # series, so "tenant-b is on greedy" is one dashboard cell; in
        # fleet mode the member index joins the labels so "member 2 of
        # tenant-b's fleet is dark" is one cell too
        labels = {"tenant": self.tenant}
        if self.member:
            labels["member"] = self.member
        m.SOLVER_CIRCUIT_STATE.set(float(self.state), labels)

    def _transition(self, state: int) -> None:
        if state == self.state:
            return
        self.state = state
        self._export()
        if self.on_state_change is not None:
            self.on_state_change(_STATE_NAMES[state])

    def allow(self) -> bool:
        """May a call proceed right now? Open trips to half-open (one probe
        allowed) once the cooldown has elapsed."""
        if self.state == STATE_OPEN:
            if self.time_fn() - self.opened_at >= self.cooldown:
                self._transition(STATE_HALF_OPEN)
                return True
            return False
        return True

    def probeable(self) -> bool:
        """Read-only allow(): would a call be admitted now? The fleet
        router ranks members with this — allow() itself transitions
        open -> half-open, and ranking must not consume the probe slot."""
        return (
            self.state != STATE_OPEN
            or self.time_fn() - self.opened_at >= self.cooldown
        )

    def record_success(self) -> None:
        self.failures = 0
        self._transition(STATE_CLOSED)

    def record_failure(self) -> None:
        self.failures += 1
        if (
            self.state == STATE_HALF_OPEN
            or self.failures >= self.failure_threshold
        ):
            self.opened_at = self.time_fn()
            self._transition(STATE_OPEN)


class SolverClient:
    """Shared transport + fault-tolerance state for one sidecar address.

    One instance lives on the provisioner for the operator's lifetime (the
    breaker must remember failures ACROSS solves); RemoteScheduler instances
    are per-solve and borrow it."""

    def __init__(
        self,
        addr: str,
        timeout: float = 30.0,
        max_retries: int = 2,
        backoff: float = 0.1,
        breaker: Optional[CircuitBreaker] = None,
        fault_injector: Optional[FaultInjector] = None,
        sleep=time.sleep,
        on_state_change=None,
        tenant: str = "default",
        quarantine=None,
        wire_mode: str = "delta",
        member: str = "",
    ):
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff = backoff
        self.tenant = tenant
        # delta = manifest-of-digests solve requests with miss repair and
        # full-wire fallback (ISSUE 14); full = every request ships the
        # whole problem (the v4-and-earlier behavior, and the escape
        # hatch when the far side predates the segment store)
        if wire_mode not in ("delta", "full"):
            raise ValueError(f"unknown wire mode {wire_mode!r}")
        self.wire_mode = wire_mode
        self.member = member
        self.breaker = breaker or CircuitBreaker(
            on_state_change=on_state_change, tenant=tenant, member=member
        )
        if on_state_change is not None and breaker is not None:
            breaker.on_state_change = on_state_change
        self.fault_injector = fault_injector
        self.sleep = sleep
        # delta-wire sent-cache: which segment digests the CURRENT far
        # instance has confirmed (solver/segments.SentCache) — rebound
        # whenever the X-Solverd-Instance response header changes, so a
        # respawned sidecar costs one re-upload round, not a stale elision
        from karpenter_core_tpu_torch.solver.segments import SentCache

        self.segcache = SentCache()
        self._seen_instance = ""
        # incsolve predecessor reference (ISSUE 16): the fingerprint of
        # this client's last verified solve, sent as prev_fingerprint by
        # an incremental-opted RemoteScheduler. Lives here (not on the
        # per-solve facade) for the same reason the quarantine does; a
        # respawned sidecar's empty ledger just misses it — amnesia is a
        # full solve, never a wrong bind.
        self.prev_fingerprint = ""
        # client-side poison quarantine, keyed on the request-body digest:
        # lives HERE (not on the per-solve RemoteScheduler) because the
        # strike streak must survive across solves, like the breaker. A
        # problem that times out, errors, corrupts, or fails verification
        # N times inside the TTL routes straight to greedy without an RPC.
        if quarantine is None:
            from karpenter_core_tpu_torch.solver.fleet import PoisonQuarantine

            quarantine = PoisonQuarantine(site="client")
        self.quarantine = quarantine

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def set_addr(self, addr: str) -> None:
        """Follow a respawned sidecar to its new port (supervisor restarts
        with port 0 pick a fresh one)."""
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)

    # -- transport ---------------------------------------------------------

    def _apply_fault(self) -> None:
        if self.fault_injector is None:
            return
        fault = self.fault_injector.next_fault()
        if fault == "ok":
            return
        if fault == "error":
            raise RemoteSolverError("injected", "injected error")
        if fault == "timeout":
            raise socket.timeout("injected timeout")
        if fault == "hang":
            # a hung sidecar holds the socket until the client deadline
            self.sleep(self.timeout)
            raise socket.timeout("injected hang past deadline")
        if fault.startswith("slow:"):
            self.sleep(float(fault.split(":", 1)[1]))
            return
        raise ValueError(f"unknown fault {fault!r}")

    def _once(self, path: str, body: bytes, headers: dict = None):
        self._apply_fault()
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            conn.request(
                "POST", path, body,
                headers={
                    "Content-Type": "application/octet-stream",
                    # fleet-gateway identity: who is asking, and how much
                    # budget remains — what admission sheds against
                    "X-Solver-Tenant": self.tenant,
                    "X-Solver-Deadline": f"{self.timeout:.3f}",
                    # per-request extras (e.g. X-Solver-Mode, the solver
                    # backend selector) layer on top of the identity set
                    **(headers or {}),
                },
            )
            resp = conn.getresponse()
            data = resp.read()
            # the daemon's boot identity rides every answer; the delta
            # path keys its sent-cache on it (a changed id = a respawn =
            # the far store is empty)
            inst = resp.getheader("X-Solverd-Instance")
            if inst:
                self._seen_instance = inst
            if resp.status == 409:
                # delta-wire typed miss: the sidecar cannot assemble the
                # manifest and names exactly the digests it needs — an
                # ANSWER, not a fault (solve_delta re-uploads once)
                import json as _json

                try:
                    miss = _json.loads(data.decode())
                    need = [
                        d for d in miss.get("need", [])
                        if isinstance(d, str)
                    ]
                    instance = str(miss.get("instance", "") or "")
                except (ValueError, UnicodeDecodeError, AttributeError):
                    need, instance = [], ""
                e = RemoteSolverError(
                    "segment_miss",
                    f"sidecar {path} missing {len(need)} segment(s)",
                )
                e.need = need
                e.instance = instance
                raise e
            if resp.status == 429:
                # admission shed: the gateway answered with its estimate
                # of when a retry would be admitted
                raw = resp.getheader("Retry-After", "") or ""
                try:
                    retry_after = max(float(raw), 0.0)
                except ValueError:
                    retry_after = self.backoff
                raise RemoteSolverError(
                    "shed",
                    f"sidecar {path} shed the request: {data[:200]!r}",
                    retry_after=retry_after,
                )
            if resp.status == 503:
                # drain: the gateway is flushing its queue ahead of a
                # clean restart — degrade this solve, never the breaker
                raise RemoteSolverError(
                    "drain",
                    f"sidecar {path} draining: {data[:200]!r}",
                )
            if resp.status == 422:
                # poison-pill refusal: the gateway quarantined this
                # problem digest; quarantine it locally too
                raise RemoteSolverError(
                    "poisoned",
                    f"sidecar {path} quarantined the problem: "
                    f"{data[:200]!r}",
                )
            if resp.status != 200:
                raise RemoteSolverError(
                    "error",
                    f"sidecar {path} -> {resp.status}: {data[:200]!r}",
                )
            kernel = float(resp.getheader("X-Solver-Seconds", "0") or 0.0)
            return data, kernel
        finally:
            conn.close()

    def call(self, path: str, body: bytes, headers: dict = None,
             routing_key: str = None):
        """(response bytes, sidecar-reported kernel seconds), or raises
        RemoteSolverError after the retry budget / on an open circuit.
        ``routing_key`` is accepted (and ignored) so FleetRouter and the
        single client duck-type one call surface."""
        from karpenter_core_tpu_torch.metrics import wiring as m

        if not self.breaker.allow():
            m.SOLVER_RPC_FAILURES.inc({"cause": "circuit_open"})
            raise RemoteSolverError("circuit_open", "circuit breaker open")
        cause, detail = "error", ""
        retry_after: Optional[float] = None
        need: List[str] = []
        instance = ""
        for attempt in range(self.max_retries + 1):
            if attempt:
                m.SOLVER_RPC_RETRIES.inc()
                # a server-sent Retry-After replaces the fixed exponential
                # schedule — the gateway knows its own drain rate
                self.sleep(
                    retry_after
                    if retry_after is not None
                    else self.backoff * (2 ** (attempt - 1))
                )
            retry_after = None
            try:
                data, kernel = self._once(path, body, headers)
            except RemoteSolverError as e:
                cause, detail, retry_after = e.cause, str(e), e.retry_after
                need, instance = e.need, e.instance
                if e.cause in ("drain", "poisoned", "segment_miss"):
                    # the sidecar ANSWERED with a definitive refusal:
                    # draining (it is about to restart), a quarantined
                    # poison digest, or a segment miss (retrying the SAME
                    # body cannot succeed — the repair is a different
                    # body, solve_delta's job) — retrying is pointless
                    # and the breaker stays untouched (a live answer is
                    # not a dead sidecar)
                    self.breaker.record_success()
                    break
                if e.cause == "shed":
                    # the sidecar ANSWERED — alive and regulating: reset
                    # the breaker's failure streak, and if waiting out the
                    # Retry-After would blow this solve's budget anyway,
                    # stop burning attempts and degrade to greedy now
                    self.breaker.record_success()
                    if retry_after is not None and retry_after >= self.timeout:
                        break
                    continue
                if self.breaker.state == STATE_HALF_OPEN:
                    break  # one probe only — don't burn retries while open
                continue
            except socket.timeout as e:
                cause, detail = "timeout", str(e)
                if self.breaker.state == STATE_HALF_OPEN:
                    break
                continue
            except OSError as e:
                cause, detail = "error", str(e)
                if self.breaker.state == STATE_HALF_OPEN:
                    break
                continue
            self.breaker.record_success()
            return data, kernel
        if cause not in _ANSWERED_CAUSES:
            # a shed/drain/poison refusal is an ANSWER, not a fault — it
            # must never push the breaker toward open (that would turn a
            # load spike or a clean restart into a blanket greedy
            # degradation past its end)
            self.breaker.record_failure()
        m.SOLVER_RPC_FAILURES.inc({"cause": cause})
        err = RemoteSolverError(cause, detail, retry_after=retry_after)
        err.need, err.instance = need, instance
        raise err

    # -- delta wire (segmentstore, ISSUE 14) -------------------------------

    def solve_delta(self, plan, headers: dict = None):
        """One delta-wire solve: ship a manifest eliding every segment
        the sent-cache says the far instance holds; on the typed miss,
        re-upload exactly the named digests and retry ONCE. Raises
        RemoteSolverError("segment_miss") only when the repair round
        ALSO missed — the caller falls back to the full wire (degraded
        bytes, never a wrong solve and never a greedy fallback: the
        sidecar is alive and answering, so the breaker stays untouched).

        ``plan`` is solver/segments.split_solve_header's SegmentPlan; a
        fleet-member restart surfaces here as exactly one miss round —
        the new instance id on the answer rebinds the sent-cache."""
        from karpenter_core_tpu_torch.metrics import wiring as m
        from karpenter_core_tpu_torch.solver import codec

        include = [
            dg for dg in plan.segments if not self.segcache.known(dg)
        ]
        body = codec.encode_manifest_request(
            plan, include, base=self.segcache.base()
        )
        m.SOLVER_SEGMENT_WIRE_BYTES.inc(
            {"kind": "segment" if include else "manifest"}, by=len(body)
        )
        try:
            data, kernel = self.call("/solve", body, headers)
        except RemoteSolverError as e:
            if e.cause != "segment_miss":
                raise
            # miss: the far store lost segments and/or the base listing
            # (respawn, TTL, LRU, drift) — the answer names them; drop
            # them from the ledger, rebind to the answering instance (a
            # NEW id clears everything including the base), and repair
            # with one upload round
            self.segcache.forget(e.need)
            if e.instance:
                self.segcache.rebind(e.instance)
            repair = {dg for dg in e.need if dg in plan.segments}
            if any(dg not in plan.segments for dg in e.need):
                # the base listing itself (or something we never held)
                # is what's missing: resend the FULL listing
                self.segcache.drop_base()
            if not repair and self.segcache.base() is not None:
                # the miss names nothing we hold AND the base survived —
                # a malformed answer; nothing to repair, full-wire
                # fallback (the caller's job)
                raise
            repair |= {
                dg for dg in plan.segments
                if not self.segcache.known(dg)
            }
            body = codec.encode_manifest_request(
                plan, sorted(repair), base=self.segcache.base()
            )
            m.SOLVER_SEGMENT_WIRE_BYTES.inc(
                {"kind": "segment" if repair else "manifest"},
                by=len(body),
            )
            data, kernel = self.call("/solve", body, headers)
        self.segcache.rebind(self._seen_instance)
        self.segcache.mark(plan.all_digests())
        self.segcache.set_base(plan.listing_digest, plan.listing)
        return data, kernel


class RemoteScheduler:
    """Per-solve scheduler facade over a SolverClient.

    Holds the same constructor inputs as Scheduler/DeviceScheduler so the
    greedy fallback is built from the identical world the sidecar saw."""

    def __init__(
        self,
        client: SolverClient,
        nodepools,
        instance_types: Dict[str, list],
        existing_nodes=None,
        daemonset_pods=None,
        topology=None,
        device_scheduler_opts: Optional[dict] = None,
        unavailable_offerings: "frozenset | set" = frozenset(),
        verify: bool = True,
        recorder=None,
    ):
        self.client = client
        self.nodepools = list(nodepools)
        self.instance_types = instance_types
        self.existing_nodes = list(existing_nodes or [])
        self.daemonset_pods = list(daemonset_pods or [])
        self.topology = topology
        self.max_slots = (device_scheduler_opts or {}).get("max_slots", 256)
        # the solver backend this client requests per solve (relaxsolve,
        # ISSUE 13): rides the wire (codec solver_mode field) AND the
        # X-Solver-Mode header; the greedy degradation below is the
        # anytime answer either way
        self.solver_mode = (device_scheduler_opts or {}).get(
            "solver_mode", "ffd"
        )
        # incremental re-solve opt-in (incsolve, ISSUE 16): when set, each
        # request names the fingerprint of this client's last VERIFIED
        # solve so the sidecar may replay the unchanged half of that
        # packing from its ledger. The memory lives on the CLIENT (the
        # durable object — this facade is rebuilt per solve, the SentCache
        # lesson) and is cleared on every degradation below: a fallback
        # round must never advertise a predecessor the operator did not
        # actually bind. Off by default — the wire is byte-identical to a
        # pre-incsolve client's unless the operator opts in.
        self.incremental = bool(
            (device_scheduler_opts or {}).get("incremental", False)
        )
        # the ICE-cache snapshot ships on the wire so the sidecar masks the
        # same offerings; the greedy fallback applies it locally too
        self.unavailable_offerings = frozenset(unavailable_offerings)
        # host-side result verification (solver/verify.py): the trust
        # anchor between a sidecar result and NodeClaim creation — a
        # result that fails the independent constraint re-check degrades
        # to greedy exactly like an unreachable sidecar
        self.verify = verify
        self.recorder = recorder

    # -- the solve ---------------------------------------------------------

    def solve(self, pods: List):
        from karpenter_core_tpu_torch.metrics import wiring as m
        from karpenter_core_tpu_torch.solver import gangs as gangmod

        # one O(pods) annotation/priority scan per solve, shared by the
        # decode backstop and every degradation exit below
        gangsched = gangmod.has_gangsched(pods)
        digest = None
        quarantine = self.client.quarantine
        try:
            plan = None
            wire_mode = getattr(self.client, "wire_mode", "full")
            with m.SOLVER_RPC_PHASE_DURATION.time({"phase": "encode"}):
                header = codec._encode_solve_header(
                    self.nodepools,
                    self.instance_types,
                    self.existing_nodes,
                    self.daemonset_pods,
                    pods,
                    topology=self.topology,
                    max_slots=self.max_slots,
                    unavailable_offerings=self.unavailable_offerings,
                    tenant=self.client.tenant,
                    solver_mode=self.solver_mode,
                    prev_fingerprint=(
                        getattr(self.client, "prev_fingerprint", "")
                        if self.incremental
                        else ""
                    ),
                )
                if wire_mode == "delta":
                    # delta wire (ISSUE 14): split into content-addressed
                    # segments; the quarantine key is the manifest CORE
                    # (digests + inline + pod layout), stable whether or
                    # not uploads ride along — the same key the gateway
                    # computes via codec.request_digest
                    from karpenter_core_tpu_torch.solver import segments as segmod

                    plan = segmod.split_solve_header(header)
                    digest = plan.core_digest
                else:
                    body = codec._json_payload(header)
                    digest = hashlib.sha256(body).hexdigest()
            # poison check AFTER encode (the digest IS the canonical
            # content) but BEFORE any transport: a quarantined problem
            # costs zero RPCs, device grants, or sidecar respawns
            if quarantine is not None and quarantine.quarantined(digest):
                m.SOLVER_QUARANTINE_ROUTED.inc({"site": "client"})
                m.SOLVER_RPC_FALLBACKS.inc({"endpoint": "solve"})
                return self._fallback_solve(pods, gangsched)
            t0 = time.perf_counter()
            rpc_headers = {"X-Solver-Mode": self.solver_mode}
            if plan is not None:
                try:
                    data, kernel = self.client.solve_delta(
                        plan, rpc_headers
                    )
                except RemoteSolverError as e:
                    if e.cause != "segment_miss":
                        raise
                    # the manifest could not be resolved even after the
                    # re-upload round: ship the WHOLE problem — degraded
                    # bytes, never a wrong solve and never greedy (the
                    # sidecar is alive; full-wire v5 is first-class)
                    body = codec._json_payload(header)
                    m.SOLVER_SEGMENT_WIRE_BYTES.inc(
                        {"kind": "full"}, by=len(body)
                    )
                    data, kernel = self.client.call(
                        "/solve", body, rpc_headers,
                        routing_key=plan.catalog_digest,
                    )
            else:
                m.SOLVER_SEGMENT_WIRE_BYTES.inc(
                    {"kind": "full"}, by=len(body)
                )
                data, kernel = self.client.call(
                    "/solve", body, rpc_headers
                )
            total = time.perf_counter() - t0
            m.SOLVER_RPC_PHASE_DURATION.observe(kernel, {"phase": "kernel"})
            m.SOLVER_RPC_PHASE_DURATION.observe(
                max(total - kernel, 0.0), {"phase": "transit"}
            )
            with m.SOLVER_RPC_PHASE_DURATION.time({"phase": "decode"}):
                wire = codec.decode_solve_results(data)
                results = self._materialize(wire, pods)
            if gangsched:
                # decode-seam atomicity backstop (gangsched, ISSUE 10): a
                # wire uid that no longer resolves to a live pod can
                # materialize a gang partially — strip it BEFORE
                # verification, which treats partial gangs as violations
                gangmod.enforce_atomicity(results, pods)
                # topoaware backstops (ISSUE 20), same ordering as the
                # in-proc seam: distance stripping before eviction pruning
                # and before verification; rank re-assignment last (a pure
                # within-class permutation of the final packing)
                node_labels = {
                    n.name: getattr(n, "labels", None) or {}
                    for n in self.existing_nodes
                }
                gangmod.enforce_distance(results, pods, node_labels)
                gangmod.prune_evictions(results)
                gangmod.rank_order_pods(results, pods, node_labels)
        except RemoteSolverError as e:
            self._note_rpc_failure(e, digest)
            m.SOLVER_RPC_FALLBACKS.inc({"endpoint": "solve"})
            return self._fallback_solve(pods, gangsched)
        except (ValueError, KeyError):
            # malformed response (wire-version skew, truncated body):
            # degrade like an unreachable sidecar, but count the cause so
            # persistent skew is distinguishable from a dead process
            m.SOLVER_RPC_FAILURES.inc({"cause": "decode"})
            if quarantine is not None and digest is not None:
                quarantine.strike(digest, "decode")
            m.SOLVER_RPC_FALLBACKS.inc({"endpoint": "solve"})
            return self._fallback_solve(pods, gangsched)
        if self.verify:
            from karpenter_core_tpu_torch.solver import verify as verifymod

            with m.SOLVER_RPC_PHASE_DURATION.time({"phase": "verify"}):
                violations = verifymod.ResultVerifier(
                    self.nodepools,
                    self.instance_types,
                    existing_nodes=self.existing_nodes,
                    daemonset_pods=self.daemonset_pods,
                    topology=self.topology,
                    unavailable_offerings=self.unavailable_offerings,
                ).verify(results, pods)
            if violations:
                verifymod.reject(violations, "sidecar", self.recorder)
                if quarantine is not None and digest is not None:
                    quarantine.strike(digest, "verify")
                m.SOLVER_RPC_FALLBACKS.inc({"endpoint": "solve"})
                return self._fallback_solve(pods, gangsched)
        if quarantine is not None and digest is not None:
            quarantine.clear(digest)
        if self.incremental:
            # remember the VERIFIED solve as the next request's
            # predecessor: the manifest path derives the fingerprint from
            # the plan it already split; the full wire re-canonicalizes
            from karpenter_core_tpu_torch.solver import segments as segmod

            self.client.prev_fingerprint = (
                segmod.fingerprint_of_parts(plan.listing, plan.inline)
                if plan is not None
                else codec.problem_fingerprint(header)
            )
        return results

    def _note_rpc_failure(self, e: RemoteSolverError, digest) -> None:
        """Quarantine/breaker bookkeeping for one failed RPC round trip.
        Transport failures already charged the breaker inside call();
        ``corrupt`` (malformed result content, raised by _materialize)
        never crossed call()'s accounting, so it charges here — a sidecar
        producing garbage should open the breaker like a dead one."""
        from karpenter_core_tpu_torch.metrics import wiring as m

        if e.cause == "corrupt":
            self.client.breaker.record_failure()
            m.SOLVER_RPC_FAILURES.inc({"cause": "corrupt"})
        quarantine = self.client.quarantine
        if quarantine is None or digest is None:
            return
        if e.cause == "poisoned":
            # the gateway already counted its strikes: mirror its verdict
            # locally so the NEXT solve skips the RPC entirely
            quarantine.poison(digest)
        elif e.cause in ("timeout", "error", "corrupt", "injected"):
            quarantine.strike(digest, e.cause)

    def _fallback_solve(self, pods: List, gangsched: Optional[bool] = None):
        """Greedy degradation: the host Scheduler over the same inputs —
        the cluster keeps provisioning at greedy parity, with gangsched
        problems routed through solver/gangs.degraded_solve's tiered
        wrapper. ``gangsched`` carries solve()'s already-computed
        has_gangsched verdict; None rescans."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
            Scheduler,
        )
        from karpenter_core_tpu_torch.solver import gangs as gangmod

        # incsolve fallback contract (ISSUE 16): a greedy round's packing
        # was never remembered by any sidecar ledger, so the next request
        # must not name it as a predecessor — clearing routes that solve
        # down the full path (a stale reference would only miss anyway;
        # this keeps the reference honest and the miss accounting clean)
        if getattr(self, "incremental", False):
            self.client.prev_fingerprint = ""

        def make_scheduler():
            return Scheduler(
                self.nodepools,
                self.instance_types,
                existing_nodes=self.existing_nodes,
                daemonset_pods=self.daemonset_pods,
                topology=self.topology,
                unavailable_offerings=self.unavailable_offerings,
            )

        return gangmod.degraded_solve(
            make_scheduler, pods, self.existing_nodes, gangsched
        )

    # -- response materialization -----------------------------------------

    def _materialize(self, wire: dict, pods: List):
        """Re-bind a wire response to the caller's live objects: pods by
        uid, instance types by name, nodepools by name. The rebuilt
        InFlightNodeClaims are indistinguishable from locally-solved ones
        (provision() and the disruption price filters mutate them).

        Hardened against truncated/corrupt result wire: every field is
        type-checked before use and any malformation raises
        ``RemoteSolverError("corrupt")`` — the NORMAL degradation path
        (greedy fallback, breaker charged) — instead of a TypeError
        escaping into the reconciler. The subtle shapes matter: a
        ``pod_uids`` field that decodes as a *string* iterates as
        characters and would silently materialize an empty claim."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
            ExistingNodeSim,
            InFlightNodeClaim,
        )
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.nodeclaimtemplate import (
            NodeClaimTemplate,
        )
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
            Results,
            _daemon_compatible,
        )
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
            Topology,
        )
        from karpenter_core_tpu_torch.scheduling import Requirements
        from karpenter_core_tpu_torch.utils import resources as resutil

        def corrupt(detail: str):
            raise RemoteSolverError(
                "corrupt", f"malformed solve result: {detail}"
            )

        def str_list(v, field: str) -> List[str]:
            if not isinstance(v, list) or not all(
                isinstance(x, str) for x in v
            ):
                corrupt(f"{field} is not a list of strings: {v!r}")
            return v

        pods_by_uid = {p.uid: p for p in pods}
        it_by_name: Dict[str, object] = {}
        for its in self.instance_types.values():
            for it in its:
                it_by_name.setdefault(it.name, it)
        templates: Dict[str, NodeClaimTemplate] = {}
        overhead: Dict[str, dict] = {}
        for np_ in self.nodepools:
            nct = NodeClaimTemplate.from_nodepool(np_)
            templates[np_.name] = nct
            overhead[np_.name] = resutil.requests_for_pods(
                *[p for p in self.daemonset_pods if _daemon_compatible(nct, p)]
            )

        if not isinstance(wire.get("errors"), dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in wire["errors"].items()
        ):
            corrupt(f"errors is not a str->str dict: {wire.get('errors')!r}")
        if not isinstance(wire.get("claims"), list):
            corrupt(f"claims is not a list: {wire.get('claims')!r}")
        if not isinstance(wire.get("existing"), list):
            corrupt(f"existing is not a list: {wire.get('existing')!r}")

        errors = dict(wire["errors"])
        claims = []
        for c in wire["claims"]:
            if not isinstance(c, dict):
                corrupt(f"claim entry is not a dict: {c!r}")
            if not isinstance(c.get("nodepool"), str):
                corrupt(f"claim nodepool is not a string: {c!r}")
            if not isinstance(c.get("requirements"), Requirements):
                corrupt(f"claim requirements did not decode: {c!r}")
            if not isinstance(c.get("requests"), dict) or not all(
                isinstance(k, str) and isinstance(v, (int, float))
                and not isinstance(v, bool)
                for k, v in c["requests"].items()
            ):
                corrupt(f"claim requests is not a resource list: {c!r}")
            uids = str_list(c.get("pod_uids"), "claim pod_uids")
            options_names = str_list(
                c.get("instance_types"), "claim instance_types"
            )
            template = templates.get(c["nodepool"])
            if template is None:  # pool vanished between encode and decode
                for uid in uids:
                    errors[uid] = f"nodepool {c['nodepool']!r} no longer exists"
                continue
            options = [
                it_by_name[n] for n in options_names if n in it_by_name
            ]
            claim = InFlightNodeClaim(
                template, Topology(), overhead[c["nodepool"]], options
            )
            claim.requirements = c["requirements"]
            claim.requests = dict(c["requests"])
            claim.pods = [
                pods_by_uid[u] for u in uids if u in pods_by_uid
            ]
            claims.append(claim)

        node_by_name = {n.name: n for n in self.existing_nodes}
        sims = []
        for e in wire["existing"]:
            if not isinstance(e, dict) or not isinstance(
                e.get("node"), str
            ):
                corrupt(f"existing entry is malformed: {e!r}")
            uids = str_list(e.get("pod_uids"), "existing pod_uids")
            node = node_by_name.get(e["node"])
            if node is None:
                continue
            sim = ExistingNodeSim(node, Topology(), {})
            sim.pods = [
                pods_by_uid[u] for u in uids if u in pods_by_uid
            ]
            sims.append(sim)
        # eviction claims (gangsched, ISSUE 10): absent on every
        # non-preemptive wire (the byte-parity contract), a str->List[str]
        # map when present. A claim on a node that vanished locally is
        # dropped with its sim — nothing to drain, nothing placed there.
        evictions: Dict[str, List[str]] = {}
        ev_wire = wire.get("evictions", {})
        if not isinstance(ev_wire, dict):
            corrupt(f"evictions is not a dict: {ev_wire!r}")
        for node_name, uids in ev_wire.items():
            if not isinstance(node_name, str):
                corrupt(f"eviction node name is not a string: {node_name!r}")
            uids = str_list(uids, "eviction uids")
            if node_name in node_by_name:
                evictions[node_name] = list(uids)
        return Results(
            new_node_claims=claims,
            existing_nodes=sims,
            pod_errors=errors,
            evictions=evictions,
        )


class FleetRouter:
    """Client-side routing over N solverd fleet members (ISSUE 14).

    Duck-types the SolverClient surface RemoteScheduler consumes
    (``call``/``solve_delta``/``tenant``/``quarantine``/``breaker``/
    ``wire_mode``) while placing each solve on one of N member clients:

    * **digest affinity** — rendezvous (highest-random-weight) hashing of
      the manifest's CATALOG digest over member INDICES, so every solve
      of one cluster keeps landing on the member whose prepared-state
      and scheduler caches are already warm for it. Keying on the index
      (not the address) keeps the mapping stable across respawns, and
      rendezvous keeps it stable under member churn: removing one member
      remaps only that member's keys, never the survivors';
    * **spill-over** — an ANSWERED refusal (shed/drain/quarantine) from
      the affinity member re-routes once to the least-loaded healthy
      other member (the refusal never charged a breaker, so spilling is
      free); with affinity off (the bench's negative control) every
      placement is least-loaded;
    * **per-member breakers** — each member client owns its breaker
      (member-labeled on the gauge), and a member whose breaker is open
      is skipped at placement (``reason=degraded``) so one dark member
      costs routing, not greedy degradation;
    * **aggregate health** — ``health()`` polls every member's /healthz
      into one fleet view (ready = any member ready).

    The client-side poison quarantine is SHARED across members (a poison
    problem is poison everywhere), as is the tenant identity. Placement
    counters ride ``solver_fleet_routed_total{reason}``.
    """

    def __init__(
        self,
        members: List[SolverClient],
        tenant: str = "default",
        affinity: bool = True,
        quarantine=None,
    ):
        if not members:
            raise ValueError("FleetRouter needs at least one member")
        self.members = list(members)
        self.tenant = tenant
        self.affinity = affinity
        if quarantine is None:
            from karpenter_core_tpu_torch.solver.fleet import PoisonQuarantine

            quarantine = PoisonQuarantine(site="client")
        self.quarantine = quarantine
        for c in self.members:
            c.quarantine = quarantine  # one verdict ledger, N transports
        self._lock = threading.RLock()
        # stable member identities: the rendezvous hash runs over THESE,
        # not list positions, so dynamic membership (elastic resize,
        # ISSUE 17) remaps only the departing/arriving member's keys.
        # The defaults reproduce the founding indices, keeping the hash
        # byte-identical to the static fleet's for unchanged membership.
        ids = [getattr(c, "member", "") or str(i)
               for i, c in enumerate(self.members)]
        if len(set(ids)) != len(ids):
            ids = [str(i) for i in range(len(self.members))]
        self._ids: List[str] = ids
        self._next_id = len(self.members)
        self._inflight: Dict[str, int] = {mid: 0 for mid in self._ids}
        # members currently serving a SPILL on this thread's behalf: the
        # autoscaler must never drain the tier's active safety valve
        self._spilling: Dict[str, int] = {mid: 0 for mid in self._ids}
        self._tl = threading.local()
        self.routed: Dict[str, int] = {}
        # incsolve predecessor reference (ISSUE 16): one slot suffices —
        # digest affinity pins a snapshot's lineage to one member, whose
        # ledger is the one this fingerprint can hit; a spill/degraded
        # re-route lands on a member that simply misses (full solve)
        self.prev_fingerprint = ""
        # the routing key of the last /solve placed: a membership change
        # compares its affinity winner before/after, and a remapped
        # lineage clears prev_fingerprint proactively (a guaranteed
        # ledger miss becomes a PLANNED full solve, not daemon amnesia)
        self._lineage_key: Optional[str] = None

    # -- SolverClient surface ---------------------------------------------

    @property
    def wire_mode(self) -> str:
        return self.members[0].wire_mode

    @property
    def breaker(self):
        """The breaker of the member that served THIS thread's last call
        — what RemoteScheduler charges on a corrupt result. Falls back to
        member 0 before any call has routed. Holds the serving CLIENT
        (not its index), so the charge still lands on the right breaker
        when membership shifted underneath a long solve."""
        client = getattr(self._tl, "last", None)
        return (client if client is not None else self.members[0]).breaker

    @property
    def addr(self) -> str:
        return ",".join(c.addr for c in self.members)

    def _check_index(self, i: int, site: str) -> None:
        if not 0 <= i < len(self.members):
            from karpenter_core_tpu_torch.solver.fleet import UnknownMemberError

            raise UnknownMemberError(i, len(self.members), site)

    def set_member_addr(self, i: int, addr: str) -> None:
        """Follow a respawned fleet member to its new port (the operator
        calls this after FleetSupervisor.poll reports a restart)."""
        with self._lock:
            self._check_index(i, "set_member_addr")
            self.members[i].set_addr(addr)

    def set_addr(self, addr: str) -> None:
        """SolverClient duck-typing for the single-member router: a bare
        address re-points member 0."""
        self.set_member_addr(0, addr)

    # -- placement ---------------------------------------------------------

    def _healthy_locked(self) -> List[int]:
        with self._lock:
            up = [
                i for i, c in enumerate(self.members)
                if c.breaker.probeable()
            ]
            # every breaker open: fall through to all members — the
            # breakers themselves fast-fail, and a blanket empty set
            # would turn "all cooling down" into an unroutable error
            return up or list(range(len(self.members)))

    def _count_routed_locked(self, reason: str) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            self.routed[reason] = self.routed.get(reason, 0) + 1
        m.SOLVER_FLEET_ROUTED.inc({"reason": reason})

    def _least_loaded_locked(self, candidates: List[int]) -> int:
        with self._lock:
            return min(
                candidates,
                key=lambda i: (self._inflight[self._ids[i]], i),
            )

    def _rank_locked(self, i: int, routing_key: str) -> bytes:
        with self._lock:
            return hashlib.sha256(
                f"{self._ids[i]}|{routing_key}".encode()
            ).digest()

    def _pick(self, routing_key: Optional[str]) -> int:
        with self._lock:
            healthy = self._healthy_locked()
            if self.affinity and routing_key:
                ranked = max(
                    healthy,
                    key=lambda i: self._rank_locked(i, routing_key),
                )
                degraded = len(healthy) < len(self.members) and (
                    ranked != max(
                        range(len(self.members)),
                        key=lambda i: self._rank_locked(i, routing_key),
                    )
                )
                reason = "degraded" if degraded else "affinity"
                member = ranked
            else:
                member = self._least_loaded_locked(healthy)
                reason = "spill"
        self._count_routed_locked(reason)
        return member

    def _run(self, client: SolverClient, mid: str, fn, spill: bool = False):
        with self._lock:
            if mid in self._inflight:
                self._inflight[mid] += 1
                if spill:
                    self._spilling[mid] += 1
        self._tl.last = client
        try:
            return fn(client)
        finally:
            with self._lock:
                # the member may have been removed mid-call: its
                # counters left with it
                if mid in self._inflight:
                    self._inflight[mid] -= 1
                    if spill:
                        self._spilling[mid] = max(
                            0, self._spilling[mid] - 1
                        )

    def _routed(self, fn, routing_key: Optional[str]):
        """Place fn on the affinity pick; spill ONCE to the least-loaded
        healthy other member when the pick answers with a refusal (shed/
        drain/poisoned — it is regulating or restarting, not dead; a
        transport FAULT does not spill, the breaker machinery owns it)."""
        with self._lock:
            first = self._pick(routing_key)
            first_client, first_mid = self.members[first], self._ids[first]
        try:
            return self._run(first_client, first_mid, fn)
        except RemoteSolverError as e:
            if (
                e.cause not in ("shed", "drain", "poisoned")
                or len(self.members) < 2
            ):
                raise
            with self._lock:
                # exclude the refusing member by IDENTITY, not index —
                # membership may have shifted under the first call
                others = [
                    i for i in self._healthy_locked()
                    if self.members[i] is not first_client
                ]
                if not others:
                    raise
                spill = self._least_loaded_locked(others)
                spill_client, spill_mid = (
                    self.members[spill], self._ids[spill]
                )
            self._count_routed_locked("spill")
            return self._run(spill_client, spill_mid, fn, spill=True)

    def call(self, path: str, body: bytes, headers: dict = None,
             routing_key: str = None):
        if routing_key is None:
            # no explicit affinity key (frontier sweeps, fallback bodies
            # from callers that did not thread one): derive a stable one
            # from the body so repeat traffic still lands warm
            routing_key = hashlib.sha256(body).hexdigest()
        if path == "/solve":
            with self._lock:
                self._lineage_key = routing_key
        return self._routed(
            lambda c: c.call(path, body, headers), routing_key
        )

    def solve_delta(self, plan, headers: dict = None):
        with self._lock:
            self._lineage_key = plan.catalog_digest
        return self._routed(
            lambda c: c.solve_delta(plan, headers), plan.catalog_digest
        )

    # -- dynamic membership (elastic resize, ISSUE 17) ---------------------

    def member_loads(self) -> Dict[str, tuple]:
        """member id -> (inflight, spilling): the autoscaler's view of
        who is busy and who is answering a spill right now."""
        with self._lock:
            return {
                mid: (self._inflight[mid], self._spilling[mid])
                for mid in self._ids
            }

    def _lineage_winner_locked(self) -> Optional[str]:
        with self._lock:
            key = self._lineage_key
            if not key or not self.affinity or not self.members:
                return None
            win = max(
                range(len(self.members)),
                key=lambda i: self._rank_locked(i, key),
            )
            return self._ids[win]

    def _lineage_remap_locked(self, before: Optional[str]) -> None:
        with self._lock:
            after = self._lineage_winner_locked()
            if before is not None and before != after:
                # the lineage's routing key now ranks a different member:
                # its predecessor entry lives in the old member's ledger,
                # so the reference is a guaranteed miss. Clear it — the
                # next round is a PLANNED full solve, not an incremental
                # attempt the metrics would count as daemon amnesia.
                self.prev_fingerprint = ""

    def add_member(
        self, client: SolverClient, member_id: Optional[str] = None
    ) -> int:
        """Grow the live member set (autoscaler scale-up). Rendezvous
        hashing means the new member takes ONLY the keys it now wins —
        every survivor keeps its warm-cache keys. Returns the new
        member's index."""
        with self._lock:
            mid = member_id or getattr(client, "member", "") or ""
            while not mid or mid in self._ids:
                mid = str(self._next_id)
                self._next_id += 1
            before = self._lineage_winner_locked()
            client.quarantine = self.quarantine
            self.members.append(client)
            self._ids.append(mid)
            self._inflight[mid] = 0
            self._spilling[mid] = 0
            self._lineage_remap_locked(before)
            return len(self.members) - 1

    def remove_member(self, i: int) -> SolverClient:
        """Shrink the live member set (autoscaler scale-down): retiring
        member k remaps only k's digests — each costs one miss/re-upload
        round on its next solve, breakers untouched, fallbacks unmoved
        (the PR 13 respawn contract extended to resize). Returns the
        removed client (the caller owns its teardown)."""
        with self._lock:
            self._check_index(i, "remove_member")
            if len(self.members) < 2:
                raise ValueError("cannot remove the last fleet member")
            before = self._lineage_winner_locked()
            client = self.members.pop(i)
            mid = self._ids.pop(i)
            self._inflight.pop(mid, None)
            self._spilling.pop(mid, None)
            self._lineage_remap_locked(before)
            return client

    # -- observability -----------------------------------------------------

    def health(self, timeout: float = 2.0) -> dict:
        """Aggregate fleet /healthz: one member view per row, fleet-level
        ready when ANY member is ready (the router can place around the
        rest). An unreachable member reports ok:false, reachable:false —
        a fleet dashboard tells 'member down' from 'member overloaded'."""
        import json as _json
        from urllib.request import urlopen

        rows = []
        ready = 0
        for c in self.members:
            row = {"addr": c.addr, "ok": False, "reachable": False}
            try:
                with urlopen(
                    f"http://{c.addr}/healthz", timeout=timeout
                ) as resp:
                    row.update(_json.loads(resp.read().decode()))
                    row["reachable"] = True
            except (OSError, ValueError):
                pass
            if row.get("ready"):
                ready += 1
            rows.append(row)
        return {
            "ok": any(r.get("ok") for r in rows),
            "ready": ready > 0,
            "ready_members": ready,
            "size": len(self.members),
            "members": rows,
        }

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "routed": dict(sorted(self.routed.items())),
                "members": [
                    {
                        "addr": c.addr,
                        "member": self._ids[i],
                        "breaker": _STATE_NAMES[c.breaker.state],
                        "inflight": self._inflight[self._ids[i]],
                        "spilling": self._spilling[self._ids[i]],
                    }
                    for i, c in enumerate(self.members)
                ],
            }


def remote_frontier(
    client: SolverClient,
    nodepools,
    instance_types,
    cand_nodes,
    keep_nodes,
    daemonset_pods,
    base_pods,
    candidate_pods,
    max_slots: int = 1024,
):
    """Consolidation prefix sweep over the sidecar seam. Any RPC failure
    returns None — the caller's host binary search, i.e. greedy-parity
    degradation for disruption too."""
    from karpenter_core_tpu_torch.metrics import wiring as m

    digest = None
    quarantine = client.quarantine
    try:
        with m.SOLVER_RPC_PHASE_DURATION.time({"phase": "encode"}):
            body = codec.encode_frontier_request(
                nodepools,
                instance_types,
                cand_nodes,
                keep_nodes,
                daemonset_pods,
                base_pods,
                candidate_pods,
                max_slots=max_slots,
                tenant=client.tenant,
            )
        # same poison contract as the solve path: a quarantined frontier
        # problem goes straight to the host binary search, zero RPCs
        digest = hashlib.sha256(body).hexdigest()
        if quarantine is not None and quarantine.quarantined(digest):
            m.SOLVER_QUARANTINE_ROUTED.inc({"site": "client"})
            m.SOLVER_RPC_FALLBACKS.inc({"endpoint": "consolidate"})
            return None
        t0 = time.perf_counter()
        data, kernel = client.call("/consolidate", body)
        total = time.perf_counter() - t0
        m.SOLVER_RPC_PHASE_DURATION.observe(kernel, {"phase": "kernel"})
        m.SOLVER_RPC_PHASE_DURATION.observe(
            max(total - kernel, 0.0), {"phase": "transit"}
        )
        with m.SOLVER_RPC_PHASE_DURATION.time({"phase": "decode"}):
            frontier = codec.decode_frontier_response(data)
    except RemoteSolverError as e:
        if quarantine is not None and digest is not None:
            if e.cause == "poisoned":
                quarantine.poison(digest)
            elif e.cause in ("timeout", "error", "injected"):
                quarantine.strike(digest, e.cause)
        m.SOLVER_RPC_FALLBACKS.inc({"endpoint": "consolidate"})
        return None
    except (ValueError, KeyError):
        m.SOLVER_RPC_FAILURES.inc({"cause": "decode"})
        if quarantine is not None and digest is not None:
            quarantine.strike(digest, "decode")
        m.SOLVER_RPC_FALLBACKS.inc({"endpoint": "consolidate"})
        return None
    # structural verification: the (ok, n_new, price_lb) triples feed
    # binary disruption decisions directly — garbage here silently
    # mis-sizes a consolidation command, so a defective frontier degrades
    # to the caller's host binary search like any RPC failure
    from karpenter_core_tpu_torch.solver.verify import verify_frontier

    defect = verify_frontier(frontier)
    if defect is not None:
        m.SOLVER_RESULT_REJECTED.inc(
            {"reason": "structure", "path": "frontier"}
        )
        m.SOLVER_RPC_FALLBACKS.inc({"endpoint": "consolidate"})
        return None
    if quarantine is not None and digest is not None:
        # success forgives the streak, exactly like the solve path —
        # transient faults spread across a healthy week must never
        # accumulate into a quarantine
        quarantine.clear(digest)
    return frontier
