"""solverd: the device solver as a supervised sidecar process.

Port of ``karpenter_core_tpu/solver/service.py`` onto the PyTorch solver:
each solve runs the port's ``DeviceScheduler`` on ``--device`` (default
``cuda``; the daemon raises at construction without a GPU, and
``--device cpu`` asks for the CPU) through ``--kernel`` (``cuda``, the
hand-written FFD kernel, or ``reference``, its plain torch version).
``--devices`` resolves as in the JAX package (0 = every device of the
kind; a larger count clamps to what exists); above 1 every solve and sweep
runs on a mesh of that many devices (``parallel/mesh.py``). Where the JAX
daemon points XLA's compile cache at disk at boot, this one builds the
kernel library (``ops/cuda_ffd.build``) on a CUDA device; the profile
toggle captures a ``torch.profiler`` chrome trace. A sticky CUDA error
inside a solve (``utils/device.is_sticky_cuda_error``: the context is
poisoned, every later call fails) takes the watchdog's crash-only exit:
the queue drains with 503s, the in-flight digests stay in the quarantine
journal (the respawned child charges each a strike), and the process
exits with WATCHDOG_EXIT_CODE for the supervisor to respawn with a fresh
context.

The reference's description follows.

SURVEY §7 / BASELINE frame the paper's architecture as Go reconcilers
feeding pod×InstanceType tensor problems to a TPU solver across a process
boundary; this server IS that boundary's solver side, promoted from the
codec-only seam (solver/codec.py called itself "the solver's process
boundary" while nothing served it). It speaks HTTP+npz instead of
gRPC+proto — same split, stdlib transport (the kube/httpserver.py pattern):

* ``POST /solve``        — full scheduler input -> DeviceScheduler.solve
                           (schedulers cached per problem fingerprint, so
                           repeat solves against an unchanged cluster reuse
                           the prepared-state caches across RPC calls)
* ``POST /consolidate``  — consolidation prefix sweep (frontier_core)
* ``GET  /healthz``      — liveness + readiness + admission-queue depth
                           (``ready: false`` while the queue is saturated,
                           so probes tell "overloaded" from "dead")
* ``GET  /metrics``      — the sidecar's own registry, exposition format
* ``POST /profile``      — toggle torch.profiler trace capture around solves
                           (requires ``--profile-dir``); GET reports state
* ``POST /drain``        — crash-only clean restart: admission closes,
                           queued requests answer 503 (drain ≠ shed ≠
                           fault), and the process exits with
                           DRAIN_EXIT_CODE once the in-flight device step
                           clears — the supervisor respawns immediately
                           without charging crash-loop backoff

Two survivability guards wrap the exclusive device step: a ``DeviceWatchdog``
(hard wall-clock bound; on overrun the queue is flushed with 503s and the
process exits crash-only with WATCHDOG_EXIT_CODE — Python cannot kill a
wedged device thread, so the process IS the unit of recovery) and a
``PoisonQuarantine`` (a request-body digest that crashes/wedges the device
N times inside a TTL is refused pre-decode with 422, so one tenant's
poison problem cannot crash-loop the shared sidecar for the whole fleet;
an optional journal carries the in-flight digest across the very crash it
causes).

Since the fleet gateway (solver/fleet.py) landed, one sidecar serves N
operators: every request carries a tenant (wire field + ``X-Solver-Tenant``
header) and a remaining deadline (``X-Solver-Deadline``), admission sheds
hopeless requests with ``429 + Retry-After`` (the client fails that
solve and the operator's next pass asks again), tenants share the device under weighted
fair queueing with provisioning prioritized over consolidation sweeps, and
only the device phase of a request is exclusive — request B's codec
decode/encode overlaps request A's device time.

With continuous batching on (``--max-batch`` > 1), a granted solve also
COALESCES: it collects compatible queued problems (same compile-shape
bucket via ``codec.problem_bucket``, distinct fingerprints) and solves
them all in one vmapped multi-problem device dispatch
(models/provisioner.solve_batch) under its single grant — many small
tenant solves amortize one device window instead of serializing, while
each problem's decode/verify/encode stays per-request on its own handler
thread and a poisoned batch member fails alone.

Responses carry ``X-Solver-Seconds`` (device solve wall time) so the client
can split its RPC histogram into transit vs kernel. Boot builds the kernel
library on a CUDA device and optionally pre-warms the common class-count
shape buckets.

Run: ``python -m karpenter_core_tpu_torch.solver.service --port 0``
(on the card), or ``... --device cpu --kernel reference`` on the CPU.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from karpenter_core_tpu_torch.kube.httpserver import read_body, send_body
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.solver import codec, fleet, segments
from karpenter_core_tpu_torch.solver import incremental as incsolve
from karpenter_core_tpu_torch.solver.autoscale import BROWNOUT_MAX_RUNG
from karpenter_core_tpu_torch.solver.supervisor import (
    DRAIN_EXIT_CODE,
    DRAIN_EXIT_DEADLINE_SECONDS,
    WATCHDOG_EXIT_CODE,
)
from karpenter_core_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    is_sticky_cuda_error,
    resolve_device,
)

_OCTET = "application/octet-stream"

# brownout ladder shape: rung 2 widens the coalescing window
# by WINDOW_FACTOR (with a floor so a zero-window gateway still widens),
# rung 3 scales admission capacity by SHED_FACTOR so shedding starts
# earlier. Rung 1 costs nothing here — it only rewrites relax -> ffd in
# solve(). Verification is NEVER touched by any rung.
BROWNOUT_WINDOW_FACTOR = 4.0
BROWNOUT_WINDOW_FLOOR = 0.01
BROWNOUT_SHED_FACTOR = 0.5

# grace window between flushing the queue (503s written by their handler
# threads) and the crash-only process exit — long enough for in-memory
# socket writes, short enough that a wedged chip is gone in well under a
# supervision pass
_EXIT_GRACE_SECONDS = 0.25


class DeviceWatchdog:
    """Hard wall-clock bound on the EXCLUSIVE device step.

    A wedged device solve (driver hang, pathological compile, poisoned
    input) holds the single device grant forever: every tenant's solves
    queue behind it until their deadlines shed, and every solve of the
    fleet fails. Python cannot kill the wedged thread, so
    the recovery is crash-only: on trip the daemon drains the gateway
    (queued requests answer 503 instead of vanishing), the process exits
    with WATCHDOG_EXIT_CODE, and the supervisor respawns it — the
    quarantine journal remembers the fingerprint that wedged it.

    Armed/disarmed around each device phase; the monitor thread wakes a
    few times a second and only ever reads two floats, so the idle cost is
    noise. ``check()`` evaluates once synchronously (the deterministic
    test hook)."""

    def __init__(
        self,
        budget_seconds: float,
        on_trip,
        exit_fn=None,
        time_fn=time.monotonic,
        poll_seconds: float = 0.05,
    ):
        if budget_seconds <= 0:
            raise ValueError(
                f"watchdog budget must be positive, got {budget_seconds}"
            )
        self.budget_seconds = budget_seconds
        self.on_trip = on_trip
        # None = report-and-drain only (in-thread test servers must not
        # take the test process down with them); solverd main passes
        # os._exit for the real crash-only contract
        self.exit_fn = exit_fn
        self.time_fn = time_fn
        self.poll_seconds = poll_seconds
        self.trips = 0
        self._lock = threading.Lock()
        self._armed_at = None
        self._note = ""
        self._thread = None

    def arm(self, note: str = "") -> None:
        with self._lock:
            self._armed_at = self.time_fn()
            self._note = note
            # poll_seconds == 0 runs without a monitor thread — the
            # deterministic mode where tests drive check() themselves
            if self._thread is None and self.poll_seconds > 0:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="solverd-watchdog",
                )
                self._thread.start()

    def disarm(self) -> None:
        with self._lock:
            self._armed_at = None
            self._note = ""

    def armed(self) -> bool:
        with self._lock:
            return self._armed_at is not None

    def _loop(self) -> None:
        while True:
            time.sleep(self.poll_seconds)
            self.check()

    def check(self) -> bool:
        """One evaluation: trip when the armed device step has overrun its
        budget. Returns True when it tripped."""
        with self._lock:
            armed_at, note = self._armed_at, self._note
        if armed_at is None:
            return False
        if self.time_fn() - armed_at < self.budget_seconds:
            return False
        return self._trip(armed_at, note)

    def _trip(self, armed_at: float, note: str) -> bool:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            # re-validate under the lock: the step may have finished
            # (disarm) — or a NEW step armed — between the monitor's read
            # and now; tripping on a stale observation would kill a
            # healthy sidecar and charge the supervisor's crash backoff
            if self._armed_at != armed_at:
                return False
            self._armed_at = None  # never double-trip on one overrun
            self._note = ""
            self.trips += 1
        m.SOLVERD_WATCHDOG_TRIPS.inc()
        try:
            self.on_trip(note)
        finally:
            if self.exit_fn is not None:
                time.sleep(_EXIT_GRACE_SECONDS)
                self.exit_fn(WATCHDOG_EXIT_CODE)
        return True


class SolverDaemon:
    """Request execution, transport-free (tests drive it directly).

    Schedulers are cached per problem fingerprint (everything in the solve
    request EXCEPT the pending pods and the tenant — see
    codec.problem_fingerprint): a control plane re-solving against an
    unchanged cluster reuses the same DeviceScheduler across RPC calls,
    which carries the prepared-state caches (vocab-keyed catalog tensors,
    per-class rows, device-resident class steps) across the wire boundary.
    Any change to the problem half changes the fingerprint and builds a
    fresh scheduler, so cached and uncached solves are packing-identical
    by construction (conformance battery in tests/test_solverd.py). The
    cache is LRU-bounded in entries AND approximate bytes
    (fleet.BoundedSchedulerCache) so a fleet of heterogeneous tenants
    cannot OOM the sidecar.

    The fleet gateway sequences the device: a request holds exclusivity
    only between ``await_grant`` and ``release`` — its codec decode runs
    before the grant and its result encode after the release, both on the
    request's own handler thread, so host work pipelines under the device
    phase of whichever request currently owns the chip. A cached
    DeviceScheduler is not reentrant; the single-grant gateway is what
    makes that safe."""

    def __init__(
        self,
        profile_dir: str = None,
        gateway: fleet.FleetGateway = None,
        sched_cache: fleet.BoundedSchedulerCache = None,
        devices: int = 1,
        watchdog_seconds: float = 0.0,
        quarantine: fleet.PoisonQuarantine = None,
        chaos=None,
        exit_fn=None,
        default_mode: str = "ffd",
        kernel: str = "cuda",
        segment_store: segments.SegmentStore = None,
        incremental=None,
        device=DEFAULT_DEVICE,
    ):
        # the device, explicit, no fallback: CUDA without a GPU raises here
        self.device = resolve_device(device)
        self.ready = False
        self.solves = 0
        self.profile_dir = profile_dir
        # boot identity for the delta wire (segmentstore): rides
        # every answer as X-Solverd-Instance and every segment-miss 409,
        # so clients key their sent-caches per PROCESS — a respawn mints
        # a fresh id and costs exactly one re-upload round, never a stale
        # elision against an empty store
        import uuid

        self.instance = uuid.uuid4().hex[:12]
        # content-addressed segment store: what a manifest request's
        # digests resolve against (`is None`, not truthiness — an empty
        # store must still be adopted, the cache lesson)
        self.segment_store = (
            segment_store
            if segment_store is not None
            else segments.SegmentStore()
        )
        # incremental re-solve engine (incsolve): entered only
        # when a request names its predecessor (prev_fingerprint on the
        # wire), so non-incremental clients never change behavior. The
        # ledger is process-local like the scheduler cache — a respawned
        # member's empty ledger degrades to a full solve (amnesia), and
        # the fleet router's digest affinity keeps a snapshot's requests
        # on the member whose ledger is warm. ``False`` disables; None
        # builds the default engine; an engine instance is adopted
        # (`is None` would wrongly re-enable an explicit False).
        if incremental is False:
            self.incremental = None
        elif incremental is None:
            self.incremental = incsolve.IncrementalEngine()
        else:
            self.incremental = incremental
        # solver backend served when a request names none (relaxsolve):
        # the wire field / X-Solver-Mode header select
        # per-request; this is the daemon-wide default (solverd
        # --solver-mode, riding the supervisor spawn argv)
        if default_mode not in codec.SOLVER_MODES:
            raise ValueError(f"unknown solver mode {default_mode!r}")
        self.default_mode = default_mode
        # which kernel implementation answers the FFD scan dispatches
        # (solverd --kernel riding the supervisor spawn argv): cuda = the
        # hand-written kernel (ops/cuda_ffd.py), reference = its plain torch
        # version (ops/ffd.py). Daemon-wide — results are bit-identical
        # either way, so it needs no per-request wire field; it still
        # suffixes the coalescer bucket (below) so a mixed-kernel fleet's
        # members never share a problem_bucket string.
        if kernel not in ("cuda", "reference"):
            raise ValueError(f"unknown kernel {kernel!r} (cuda | reference)")
        self.kernel = kernel
        # every solve/sweep runs on a mesh of this many devices of
        # self.device's kind (0 = all; requests clamp to what exists, so a
        # multi-device config runs the single-device path on a one-GPU
        # box); resolved per scheduler construction
        self.devices = devices
        self.profiling = False
        self._traces = 0
        self.gateway = gateway if gateway is not None else fleet.FleetGateway()
        # `is None`, not truthiness: an EMPTY BoundedSchedulerCache is
        # falsy (len 0) but must still be adopted, or the caller's bounds
        # would silently be replaced with the defaults
        self._sched_cache = (
            sched_cache
            if sched_cache is not None
            else fleet.BoundedSchedulerCache()
        )
        self._state_lock = threading.Lock()
        # brownout ladder state: the current rung (0 = clear)
        # and the gateway shape captured at first rung entry, restored on
        # descent. The rung itself is read un-locked on the solve path
        # (an atomic int read; a one-request-late rung switch is fine).
        self.brownout_rung = 0
        self._brownout_base = None
        # poison-pill quarantine: a request whose body digest has crashed
        # the device step N times is refused pre-decode (HTTP 422), so one
        # tenant's poison cannot re-wedge the shared sidecar for everyone
        self.quarantine = (
            quarantine
            if quarantine is not None
            else fleet.PoisonQuarantine(site="gateway")
        )
        # chaos injector (chaos.SolverChaos): wedge/corrupt-wire/bad-result
        # faults on the device tier, None in production
        self.chaos = chaos
        # None = exit disabled (in-thread test servers); solverd main
        # passes os._exit so drain/watchdog exits are truly crash-only
        self.exit_fn = exit_fn
        self.watchdog = (
            DeviceWatchdog(
                watchdog_seconds, on_trip=self._on_watchdog_trip,
                exit_fn=exit_fn,
            )
            if watchdog_seconds > 0
            else None
        )

    def _on_watchdog_trip(self, note: str) -> None:
        """Crash-only exit path: queued requests answer 503 (drain flush)
        instead of vanishing into the process exit; the wedged thread keeps
        the device — only the exit reclaims it."""
        self.gateway.drain()

    def drain(self) -> dict:
        """POST /drain: stop admission, flush the queue (each queued
        request's handler answers 503), then — when an exit_fn is wired —
        exit with DRAIN_EXIT_CODE once the in-flight device step clears,
        so the supervisor respawns a clean process without charging
        crash-loop backoff."""
        flushed = self.gateway.drain()
        if self.exit_fn is not None:
            t = threading.Thread(
                target=self._exit_after_idle, daemon=True,
                name="solverd-drain-exit",
            )
            t.start()
        return {
            "draining": True,
            "flushed": flushed,
            "exiting": self.exit_fn is not None,
        }

    def _exit_after_idle(self) -> None:
        """Wait (bounded) for the active device step to finish, then exit
        cleanly. A step that outlives the wait is wedged — the drain exit
        proceeds anyway; crash-only beats hanging the restart."""
        deadline = time.monotonic() + DRAIN_EXIT_DEADLINE_SECONDS
        while time.monotonic() < deadline and self.gateway.depth() > 0:
            time.sleep(0.05)
        time.sleep(_EXIT_GRACE_SECONDS)
        self.exit_fn(DRAIN_EXIT_CODE)

    def set_brownout(self, rung: int) -> dict:
        """POST /brownout: enter/exit one rung of the explicit degradation
        ladder (the autoscaler owns the hysteresis; this applies effects).
        Rung 1: relax requests are served in FFD mode (the anytime answer
        — solve() rewrites the effective mode, verifier untouched).
        Rung 2: the batch window widens for deeper coalescing. Rung 3:
        admission capacity halves so shedding starts earlier. Descent
        restores the captured gateway shape; every rung is visible on
        /healthz and the solverd_brownout_rung gauge."""
        from karpenter_core_tpu_torch.metrics import wiring as m

        if not 0 <= int(rung) <= BROWNOUT_MAX_RUNG:
            raise ValueError(
                f"brownout rung must be in [0, {BROWNOUT_MAX_RUNG}],"
                f" got {rung!r}"
            )
        rung = int(rung)
        with self._state_lock:
            previous = self.brownout_rung
            if self._brownout_base is None:
                self._brownout_base = (
                    self.gateway.batch_window, self.gateway.max_depth
                )
            base_window, base_depth = self._brownout_base
            self.brownout_rung = rung
        # gateway retunes take the GATEWAY lock — applied after the
        # daemon state lock is released, never nested under it
        if rung >= 2 and self.gateway.max_batch > 1:
            window = max(
                base_window * BROWNOUT_WINDOW_FACTOR, BROWNOUT_WINDOW_FLOOR
            )
        else:
            window = base_window
        self.gateway.set_batch_window(window)
        depth = (
            max(int(base_depth * BROWNOUT_SHED_FACTOR), 1)
            if rung >= 3 else base_depth
        )
        self.gateway.set_max_depth(depth)
        m.SOLVERD_BROWNOUT_RUNG.set(float(rung))
        return {
            "rung": rung,
            "previous": previous,
            "batch_window_s": window,
            "queue_capacity": depth,
        }

    # -- endpoints ---------------------------------------------------------

    def solve(self, body: bytes, tenant: str = None, deadline: float = None,
              solver_mode: str = None):
        """bytes -> (response bytes, solve seconds). Raises fleet.ShedError
        when admission rejects the request (the HTTP layer answers 429 +
        Retry-After; solver/remote.py fails that solve),
        fleet.DrainError while draining (503), and fleet.QuarantinedError
        for a poison-pill digest (422) — all BEFORE any decode or device
        work, so refusals cost the sidecar nothing.

        ``tenant`` is the transport-level identity (the X-Solver-Tenant
        header) and wins when present; a direct-drive caller that passes
        none is accounted to the tenant on the wire.

        With batching enabled (gateway max_batch > 1), a granted request
        becomes the batch LEADER: it collects compatible queued problems
        (same shape bucket, distinct fingerprints) and solves them all
        under its one device grant as a vmapped multi-problem batch
        (models/provisioner.solve_batch). Collected members wake with
        state="batched", wait for their ISOLATED per-problem outcome, and
        encode their own responses on their own handler threads — so the
        per-problem decode/verify/encode fan-out stays in the host phases
        and one corrupt or poisoned problem in a batch fails alone."""
        from karpenter_core_tpu_torch.metrics import wiring as m

        # the poison key is the request digest (canonical wire bytes for
        # full bodies, the manifest CORE for delta bodies — the same key
        # whether or not segment uploads ride along), computed pre-decode:
        # the decode itself may be the crash. For a manifest this parses
        # the (small) header and resolves the listing a second time
        # alongside _decode_solve — accepted: the heavy JSON (segment
        # contents) is only ever parsed once, in assembly, and both
        # passes run in the pipelined host phase, never on the grant.
        digest = codec.request_digest(
            body, segment_store=self.segment_store
        )
        if self.quarantine.quarantined(digest):
            m.SOLVER_QUARANTINE_ROUTED.inc({"site": "gateway"})
            raise fleet.QuarantinedError(digest)
        ticket = self.gateway.submit(
            tenant or fleet.DEFAULT_TENANT, fleet.LANE_SOLVE, deadline
        )
        try:
            # host phase: decode runs on this handler thread with the
            # device NOT held — request B decodes under request A's kernel
            problem = self._decode_solve(body)
            if tenant is None:
                ticket.tenant = problem["tenant"]
            # solver-mode resolution (relaxsolve): transport
            # header > wire field > daemon default. A resolved mode that
            # differs from the wire's suffixes the fingerprint (the
            # scheduler cache must never serve one mode's scheduler to
            # the other) and always rides the bucket so relax and ffd
            # problems can never coalesce into one vmapped batch.
            eff_mode = (
                solver_mode
                or problem.get("solver_mode")
                or self.default_mode
            )
            # brownout rung 1+: relax traffic is served in FFD
            # mode — the anytime answer. The REQUEST is honored (a real
            # verified placement comes back, phases say mode=ffd), only
            # the iterative-refinement budget is browned out; the
            # verifier runs unchanged on every rung.
            if self.brownout_rung >= 1 and eff_mode == "relax":
                eff_mode = "ffd"
                m.SOLVERD_BROWNOUT_SERVED.inc(
                    {"rung": str(self.brownout_rung)}
                )
            problem["solver_mode"] = eff_mode
            # the codec fingerprint deliberately excludes the raw
            # mode field (a mode-less wire and an explicit default
            # must map to ONE cached scheduler); the RESOLVED mode
            # re-joins here so the cache stays mode-bound without
            # version-skew splits
            problem["fingerprint"] = (
                f"{problem['fingerprint']}+m{eff_mode}"
            )
            # the coalescer's compatibility key: the decoded problem's
            # compile-shape bucket (codec.problem_bucket) scoped to this
            # daemon's device count; the fingerprint keeps two requests
            # for the SAME problem off one grant (a cached DeviceScheduler
            # is single-solve stateful)
            ticket.bucket = (
                f"{problem['bucket']}|m{eff_mode}|d{self.devices}"
                f"|k{self.kernel}"
            )
            ticket.fingerprint = problem["fingerprint"]
            ticket.payload = (body, problem, digest)
        except BaseException:
            self.gateway.abandon(ticket)
            raise
        self.gateway.await_grant(ticket)  # may raise Shed/DrainError
        if ticket.batched_member:
            # a leader collected this request onto its grant (the one-way
            # marker, NOT the mutable state — release_batch may have
            # already flipped state to "done" before this thread woke,
            # and racing past that onto the leader path would run a solve
            # without holding the grant): wait for the per-problem
            # outcome (an isolated failure re-raises here and answers
            # alone), then encode on THIS handler thread — host fan-out,
            # the device is already on to the next grant
            results, dt = self.gateway.await_batched(ticket)
            self.quarantine.clear(digest)
            m.SOLVERD_TENANT_SOLVES.inc(
                {"tenant": ticket.tenant, "endpoint": "solve"}
            )
            return codec.encode_solve_results(results, dt), dt
        return self._solve_as_leader(ticket)

    def _scheduler_for(self, problem: dict, approx_bytes: int):
        """Fingerprint-keyed DeviceScheduler acquisition (cache hit or
        construction) — per problem, inside the device window, exactly as
        the pre-batching path charged it."""
        from karpenter_core_tpu_torch.metrics import wiring as m
        from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

        scheduler = self._sched_cache.get(problem["fingerprint"])
        if scheduler is None:
            m.SOLVERD_SCHED_CACHE.inc({"outcome": "miss"})
            scheduler = DeviceScheduler(
                problem["nodepools"],
                problem["instance_types"],
                existing_nodes=problem["existing_nodes"],
                daemonset_pods=problem["daemonset_pods"],
                max_slots=problem["max_slots"],
                topology=problem["topology"],
                unavailable_offerings=problem["unavailable_offerings"],
                devices=self.devices,
                solver_mode=(
                    problem.get("solver_mode") or self.default_mode
                ),
                kernel_backend=self.kernel,
                device=self.device,
                # the CLIENT verifies (solver/remote.py): it must not
                # trust the wire anyway, so a sidecar-side check would
                # double the overhead yet still miss wire corruption —
                # and an in-sidecar re-solve would hide the rejection
                # signal from the fleet's operators
                verify=False,
            )
            # the encoded request size is the entry's weight proxy: it
            # tracks catalog/node scale without walking device buffers
            self._sched_cache.put(
                problem["fingerprint"], scheduler, approx_bytes
            )
        else:
            m.SOLVERD_SCHED_CACHE.inc({"outcome": "hit"})
            # the fingerprint ignores the pod-derived excluded-uid
            # list; hand the cached scheduler this request's live
            # topology context so exclusions are never stale
            scheduler.update_topology_context(problem["topology"])
        return scheduler

    def _solve_as_leader(self, ticket):
        """The granted request's device phase: optionally wait the batch
        window, collect compatible queued problems, solve the whole batch
        under this one grant, distribute per-problem outcomes, encode our
        own. A batch of one is byte-for-byte the pre-batching solo path
        (solve_batch drives the same per-problem pipeline with the same
        donating kernels)."""
        from karpenter_core_tpu_torch.metrics import wiring as m
        from karpenter_core_tpu_torch.models import provisioner as prov

        # chaos draws AFTER the grant: a request that admission refused
        # (shed/drain/quarantine) must not consume a scripted fault it
        # will never execute — a consumed entry always fires. The fault
        # targets the LEADER's problem only, so the chaos tests exercise
        # the batch-isolation contract end-to-end.
        fault = self.chaos.next_fault() if self.chaos is not None else "ok"
        grant_t0 = time.perf_counter()
        members = []
        if self.gateway.max_batch > 1:
            window = self.gateway.batch_window
            limit = self.gateway.max_batch - 1
            if (
                window > 0
                and self.gateway.preparing() > 0
                and self.gateway.compatible_queued(ticket) < limit
            ):
                # solve requests are mid-decode on their handler threads
                # AND the batch is not already fillable from the queue:
                # hold the grant for the (few-ms, bounded) window so they
                # can reach the queue and coalesce instead of
                # serializing — waking EARLY the moment the decodes land
                # or the batch fills, so the window is a ceiling on
                # device idle, not a tax every grant pays in full
                w0 = time.perf_counter()
                deadline = w0 + window
                while True:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    time.sleep(min(left, window / 8))
                    if (
                        self.gateway.preparing() == 0
                        or self.gateway.compatible_queued(ticket) >= limit
                    ):
                        break
                m.SOLVERD_BATCH_WINDOW_WAIT.observe(
                    time.perf_counter() - w0
                )
            members = self.gateway.collect_batch(ticket)
        batch = [ticket] + members
        digests = [t.payload[2] for t in batch]
        outcomes = [None] * len(batch)
        solve_wall = 0.0
        # a sticky CUDA error poisoned this process's context: the
        # digests stay in flight in the journal and the process exits
        device_fault = None
        # pod-weighted fairness shares: a tenant whose problem brings 10x
        # the pods pays 10x the share of this grant's device seconds
        weights = [max(len(t.payload[1]["pods"]), 1) for t in batch]
        total_w = float(sum(weights))
        try:
            try:
                # journal breadcrumbs + watchdog INSIDE the try: begin()
                # does file I/O per digest, and a raise here with members
                # already collected but release never reached would wedge
                # the gateway (_active stuck) and hang every member's
                # done.wait() forever; in here, the finallys below
                # guarantee release_batch and the member drain sweep
                # (done()/disarm() are no-ops for digests never begun)
                for d in digests:
                    # graftlint: disable=GL304 -- deliberate tradeoff
                    # (a review): begin() must run at grant time —
                    # journaling the digest any earlier would charge a
                    # crash strike against problems still sitting in the
                    # queue — and inside the release-guaranteeing try so a
                    # disk-full raise can never wedge the gateway. The
                    # write is a tmp+rename of a tiny JSON file; done()
                    # (the rewrite) stays off the window below.
                    self.quarantine.begin(d)
                if self.watchdog is not None:
                    self.watchdog.arm(
                        f"solve tenant={ticket.tenant} batch={len(batch)}"
                    )
                if fault.startswith("wedge"):
                    self.chaos.wedge(fault)  # holds the grant; watchdog trips
                entries, entry_idx = [], []
                for i, t in enumerate(batch):
                    if i == 0 and fault == "crash":
                        # device-phase raise -> poison strike, leader only
                        try:
                            self.chaos.crash()
                        except Exception as e:
                            outcomes[i] = ("error", e)
                            continue
                    body_i, problem_i, _d = t.payload
                    try:
                        # the cache's byte-bound weight comes from the
                        # PROBLEM's scale (resolved segment bytes for a
                        # manifest, body bytes for the full wire) — a
                        # steady-state manifest body is a few hundred
                        # bytes and would let N delta-wire tenants pin N
                        # full schedulers past the --cache-mib bound
                        # incremental path (incsolve): when the
                        # request names its predecessor and the engine is
                        # on, a lazy wrapper rides the batch entry — the
                        # engine replays the unchanged half of the prior
                        # packing and only constructs the real scheduler
                        # (through this same cache seam) when it decides
                        # it needs a fresh solve
                        if (
                            self.incremental is not None
                            and problem_i.get("prev_fingerprint")
                        ):
                            bytes_i = (
                                problem_i.get("approx_bytes") or len(body_i)
                            )
                            scheduler = self.incremental.wrap(
                                problem_i,
                                lambda p=problem_i, b=bytes_i: (
                                    self._scheduler_for(p, b)
                                ),
                            )
                        else:
                            scheduler = self._scheduler_for(
                                problem_i,
                                problem_i.get("approx_bytes") or len(body_i)
                            )
                    except Exception as e:
                        outcomes[i] = ("error", e)
                        continue
                    # relaxsolve anytime budget: the request's remaining
                    # client deadline bounds the optimizer's wall — past
                    # it the relax pass skips and the FFD answer serves
                    # (the deadline machinery, one layer deeper).
                    # Reset, don't just set: the scheduler is cached per
                    # fingerprint, and a stale tiny budget left by a
                    # deadline-carrying request would permanently degrade
                    # deadline-less requests to the FFD answer.
                    if getattr(scheduler, "solver_mode", "ffd") == "relax":
                        scheduler.relax_budget_s = (
                            max(t.deadline_at - self.gateway.time_fn(), 0.0)
                            if t.deadline_at is not None
                            else None
                        )
                    entries.append((scheduler, problem_i["pods"]))
                    entry_idx.append(i)
                if entries:
                    t0 = time.perf_counter()
                    with self._maybe_profile():
                        solved, bstats = prov.solve_batch(entries)
                    solve_wall = time.perf_counter() - t0
                    for i, outcome in zip(entry_idx, solved):
                        outcomes[i] = outcome
                        if outcome[0] == "error" and is_sticky_cuda_error(
                            outcome[1]
                        ):
                            device_fault = outcome[1]
                    if bstats["padded_total_rows"]:
                        m.SOLVERD_BATCH_PADDING.observe(
                            bstats["padded_rows"]
                            / bstats["padded_total_rows"]
                        )
                # count COMPLETED solves only (the pre-batching counter's
                # meaning — an errored problem never counted); handler
                # threads run concurrently, so a bare += would race
                ok_count = sum(
                    1 for o in outcomes if o is not None and o[0] == "ok"
                )
                with self._state_lock:
                    self.solves += ok_count
            finally:
                if self.watchdog is not None:
                    self.watchdog.disarm()
                # charge the FULL exclusive occupancy — window wait,
                # cache-miss scheduler construction, and the elapsed time
                # even when a solve raised: fairness and the admission
                # per-grant p50 must see what the device actually lost.
                # Each tenant pays its pod-weighted share of the grant; a
                # solo grant goes through the release() seam unchanged
                # (it IS a batch of one, and tests instrument that seam).
                occupancy = time.perf_counter() - grant_t0
                if len(batch) == 1:
                    self.gateway.release(ticket, occupancy)
                else:
                    self.gateway.release_batch(
                        [
                            (t, w / total_w)
                            for t, w in zip(batch, weights)
                        ],
                        occupancy,
                    )
                # journal bookkeeping AFTER release: done() rewrites the
                # journal file, and file I/O must never ride the
                # exclusive device window. After a device fault the
                # digests stay in flight: the respawned child charges them
                if device_fault is None:
                    for d in digests:
                        self.quarantine.done(d)
            if device_fault is not None:
                self._on_device_fault(device_fault)
            # per-problem epilogue (host phase): strikes for isolated
            # device failures, success bookkeeping, member handoff — the
            # member threads do their own encodes
            for i, t in enumerate(batch):
                st, val = outcomes[i] or (
                    "error", RuntimeError("batch solve aborted"),
                )
                # per-problem device share of the batch wall, so every
                # response's X-Solver-Seconds sums to the real device time
                dt_i = solve_wall * weights[i] / total_w
                if st == "error":
                    # a device-phase failure is a poison strike against
                    # THAT problem's digest only — batch-mates unaffected
                    self.quarantine.strike(t.payload[2], "crash")
                    if i > 0:
                        self.gateway.finish_batched(t, error=val)
                elif i > 0:
                    self.gateway.finish_batched(t, result=(val, dt_i))
            st, val = outcomes[0] or (
                "error", RuntimeError("batch solve aborted"),
            )
            if st == "error":
                raise val
            results = val
            leader_dt = solve_wall * weights[0] / total_w
            self.quarantine.clear(ticket.payload[2])
            m.SOLVERD_TENANT_SOLVES.inc(
                {"tenant": ticket.tenant, "endpoint": "solve"}
            )
            # host phase again: encode outside the grant, the next
            # tenant's device phase is already running
            if fault == "bad_result":
                self.chaos.sabotage(results)  # verification-failing result
            out = codec.encode_solve_results(results, leader_dt)
            if fault == "corrupt_wire":
                out = self.chaos.corrupt(out)
            return out, leader_dt
        finally:
            # no member handler may wait forever: whatever path got here
            # (watchdog drain, an unexpected raise above), any member not
            # yet answered gets the drain contract (503 — the client
            # fails that solve WITHOUT charging its breaker; the member
            # request did not fail on its own problem)
            for t in batch[1:]:
                if not t.done.is_set():
                    self.gateway.finish_batched(
                        t, error=fleet.DrainError("batch leader aborted")
                    )

    def _on_device_fault(self, exc: BaseException) -> None:
        """The crash-only exit after a sticky CUDA error: every later call
        on this process's CUDA context would fail too, so queued requests
        answer 503 (the drain flush) and, when an exit_fn is wired, the
        process exits with WATCHDOG_EXIT_CODE — a fault that charges the
        supervisor's backoff. In-thread servers (no exit_fn) drain and
        report the error on the request that hit it."""
        from karpenter_core_tpu_torch.metrics import wiring as m

        m.SOLVERD_WATCHDOG_TRIPS.inc()
        self.gateway.drain()
        if self.exit_fn is not None:
            time.sleep(_EXIT_GRACE_SECONDS)
            self.exit_fn(WATCHDOG_EXIT_CODE)

    def _decode_solve(self, body: bytes) -> dict:
        """The solve request's host-phase decode — a named seam so chaos
        tests can wedge ONE tenant's host phase and prove the device keeps
        serving everyone else. Manifest bodies resolve through the
        segment store here, pre-grant: a miss raises
        segments.SegmentMissError, the ticket is abandoned, and the HTTP
        layer answers the typed 409 — segment traffic never holds the
        device."""
        return codec.decode_solve_request(
            body, segment_store=self.segment_store
        )

    def _maybe_profile(self):
        """A torch.profiler capture, written as a chrome trace into
        --profile-dir, when profiling is toggled on and the directory was
        configured; a no-op context otherwise. Lets device traces be
        captured from a RUNNING sidecar (POST /profile) without a
        redeploy."""
        import contextlib

        if not (self.profiling and self.profile_dir):
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def capture():
            import torch
            from torch.profiler import ProfilerActivity, profile

            with self._state_lock:
                self._traces += 1
                n = self._traces
            os.makedirs(self.profile_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            trace = profile(activities=activities)
            trace.start()
            try:
                yield
            finally:
                trace.stop()
                trace.export_chrome_trace(
                    os.path.join(self.profile_dir, f"solve-{n}-torch.json")
                )

        return capture()

    def toggle_profile(self, enable: bool = None) -> dict:
        # read-modify-write (enable=None flips the current state) under its
        # own small lock: two concurrent POST /profile toggles must not both
        # read the same old value. Deliberately NOT a gateway ticket — a
        # toggle must not queue behind a multi-second solve.
        with self._state_lock:
            if enable is None:
                enable = not self.profiling
            self.profiling = bool(enable) and self.profile_dir is not None
            return {
                "profiling": self.profiling,
                "profile_dir": self.profile_dir,
                "configured": self.profile_dir is not None,
            }

    def consolidate(
        self, body: bytes, tenant: str = None, deadline: float = None
    ):
        """Consolidation sweeps ride the gateway's NORMAL lane: under
        contention every pending provisioning solve dispatches first.

        Same poison-quarantine protection as solve(): a frontier problem
        that wedges or crashes the device step is exactly as capable of
        crash-looping the shared sidecar as a solve problem, so its body
        digest is checked pre-decode, journaled around the device phase,
        and struck on a device-phase exception."""
        from karpenter_core_tpu_torch.metrics import wiring as m
        from karpenter_core_tpu_torch.models.consolidation import frontier_core

        digest = codec.request_digest(
            body, segment_store=self.segment_store
        )
        if self.quarantine.quarantined(digest):
            m.SOLVER_QUARANTINE_ROUTED.inc({"site": "gateway"})
            raise fleet.QuarantinedError(digest)
        ticket = self.gateway.submit(
            tenant or fleet.DEFAULT_TENANT, fleet.LANE_SWEEP, deadline
        )
        try:
            req = codec.decode_frontier_request(body)
            if tenant is None:
                ticket.tenant = req["tenant"]
        except BaseException:
            self.gateway.abandon(ticket)
            raise
        self.gateway.await_grant(ticket)
        dt = 0.0
        device_fault = None
        grant_t0 = time.perf_counter()
        # graftlint: disable=GL304 -- same deliberate tradeoff as the
        # solve path: the in-flight journal write belongs at grant time
        # (earlier would strike queued problems at a crash) and its
        # tmp+rename of a tiny file is bounded; done() runs post-release.
        self.quarantine.begin(digest)
        if self.watchdog is not None:
            self.watchdog.arm(f"consolidate tenant={ticket.tenant}")
        try:
            t0 = time.perf_counter()
            frontier = frontier_core(
                req["nodepools"],
                req["instance_types"],
                req["cand_nodes"],
                req["keep_nodes"],
                req["daemonset_pods"],
                req["base_pods"],
                req["candidate_pods"],
                max_slots=req["max_slots"],
                devices=self.devices,
                device=self.device,
                kernel_backend=self.kernel,
            )
            dt = time.perf_counter() - t0
        except BaseException as e:
            if is_sticky_cuda_error(e):
                device_fault = e
            else:
                self.quarantine.strike(digest, "crash")
            raise
        finally:
            if self.watchdog is not None:
                self.watchdog.disarm()
            # full-occupancy charge, as in solve()
            self.gateway.release(ticket, time.perf_counter() - grant_t0)
            # after release, as in solve(); after a device fault the digest
            # stays in flight for the respawned child to charge
            if device_fault is None:
                self.quarantine.done(digest)
            else:
                self._on_device_fault(device_fault)
        self.quarantine.clear(digest)
        m.SOLVERD_TENANT_SOLVES.inc(
            {"tenant": ticket.tenant, "endpoint": "consolidate"}
        )
        return codec.encode_frontier_response(frontier), dt

    def health(self) -> dict:
        """The /healthz body: liveness (warm-up finished) + readiness
        (liveness AND the admission queue below its bound AND not
        draining). An overloaded sidecar is alive-but-unready — the
        supervisor must not respawn it into a load spike (a restart storm
        turns overload into outage); a DRAINING one is alive-but-leaving,
        reported so probes don't mistake the planned exit for a death."""
        depth = self.gateway.depth()
        saturated = self.gateway.saturated()
        draining = self.gateway.draining()
        return {
            "ok": self.ready,
            "ready": bool(self.ready and not saturated and not draining),
            "overloaded": saturated,
            "draining": draining,
            "queue_depth": depth,
            "queue_capacity": self.gateway.max_depth,
            # delta-wire surface: the boot identity clients key
            # their sent-caches on, and the segment store's residency so a
            # fleet dashboard can tell "cold member" from "evicting"
            "instance": self.instance,
            "segments": self.segment_store.stats(),
            # the poison ledger, so a fleet dashboard can tell "this
            # sidecar is refusing a poison problem" from "cold"
            "quarantine_entries": self.quarantine.size(),
            "watchdog_trips": (
                self.watchdog.trips if self.watchdog is not None else 0
            ),
            # brownout ladder rung: 0 = clear; 1 = relax
            # served as FFD; 2 = + widened batch window; 3 = + halved
            # admission capacity — a metric-labeled state, never a
            # verification change
            "brownout_rung": self.brownout_rung,
            # which FFD-scan kernel this daemon answers with
            # (--kernel): results are byte-identical across kernels, so
            # this is a performance-dashboard fact, not a routing one
            "kernel": self.kernel,
            # the scan kernel's launches and problem rows in this process
            # (ops/cuda_ffd.counter), so a fleet's members can be told
            # apart by the device work each did
            "kernel_launches": cuda_ffd.counter.total(),
            "kernel_rows": cuda_ffd.counter.rows,
            # continuous-batching stats: how much device serialization the
            # coalescer is currently buying back (mean problems per grant,
            # lifetime coalesced count, the configured window/size bounds)
            "batch": self.gateway.batch_stats(),
            # incremental re-solve (incsolve): ledger residency
            # + drift-controller config + the last solve's outcome, so a
            # fleet dashboard can tell "warm ledger" from "amnesiac"
            "incremental": (
                self.incremental.stats()
                if self.incremental is not None
                else {"enabled": False}
            ),
        }

    # -- boot warm-up ------------------------------------------------------

    def warm_up(self, prewarm: bool = False) -> None:
        """Boot warm-up: on a CUDA device with the cuda kernel, build (or
        load, when the source hash is already built) the kernel library, so
        the first solve does not pay nvcc; with ``prewarm`` also run the
        synthetic shape-bucket solves."""
        if self.device.type == "cuda" and self.kernel == "cuda":
            cuda_ffd.build()
        if prewarm:
            from karpenter_core_tpu_torch.api.nodepool import NodePool, NodePoolSpec
            from karpenter_core_tpu_torch.api.objects import ObjectMeta
            from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
            from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

            pool = NodePool(metadata=ObjectMeta(name="prewarm"))
            pool.spec = NodePoolSpec()
            catalog = build_catalog(cpu_grid=[1, 2, 4, 8], mem_factors=[2, 4])
            DeviceScheduler(
                [pool], {"prewarm": catalog}, max_slots=256,
                devices=self.devices,
                kernel_backend=self.kernel,
                device=self.device,
                # same sidecar contract as the solve path: the CLIENT is
                # the trust anchor, and a synthetic warm-up solve must
                # never bump the fleet's rejection metric from inside boot
                verify=False,
            ).prewarm()
        self.ready = True


class _Handler(BaseHTTPRequestHandler):
    server_version = "karpenter-solverd/1"
    daemon: SolverDaemon

    def log_message(self, *args) -> None:  # quiet
        pass

    def do_GET(self) -> None:
        path, _, query = self.path.partition("?")
        if path == "/statz":
            # the gateway snapshot (per-tenant queue-wait percentiles,
            # shed counts, depth, draining): the autoscaler's control
            # signal. ?reset=1 makes the window per-poll — the
            # autoscaler is the sole consumer of the reset form.
            from urllib.parse import parse_qs

            reset = parse_qs(query).get("reset", ["0"])[0] not in (
                "0", "false", "off",
            )
            return send_body(
                self, 200,
                json.dumps(
                    self.daemon.gateway.snapshot(reset=reset)
                ).encode(),
            )
        if path == "/healthz":
            health = self.daemon.health()
            send_body(
                self,
                200 if health["ok"] else 503,
                json.dumps(health).encode(),
            )
        elif path == "/metrics":
            from karpenter_core_tpu_torch.metrics.registry import REGISTRY

            send_body(
                self, 200, REGISTRY.render().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif path == "/profile":
            send_body(
                self, 200,
                json.dumps(self.daemon.toggle_profile(
                    self.daemon.profiling  # GET reports, never toggles
                )).encode(),
            )
        else:
            send_body(self, 404, b'{"error": "not found"}')

    def _request_identity(self):
        """(tenant, deadline, solver_mode) from transport headers. The
        header is the gateway's pre-decode identity; the wire's tenant
        field backs it up for header-less clients. A malformed deadline
        means no deadline (shedding on garbage would turn a client bug
        into an outage); an unknown X-Solver-Mode is ignored the same
        way — the wire field / daemon default decide instead."""
        tenant = self.headers.get("X-Solver-Tenant") or None
        deadline = None
        raw = self.headers.get("X-Solver-Deadline")
        if raw:
            try:
                deadline = float(raw)
            except ValueError:
                deadline = None
        if deadline is not None and deadline <= 0:
            deadline = None
        from karpenter_core_tpu_torch.solver import codec as _codec

        mode = self.headers.get("X-Solver-Mode") or None
        if mode is not None and mode not in _codec.SOLVER_MODES:
            mode = None
        return tenant, deadline, mode

    def do_POST(self) -> None:
        path, _, query = self.path.partition("?")
        body = read_body(self)
        tenant, deadline, solver_mode = self._request_identity()
        try:
            if path == "/solve":
                out, dt = self.daemon.solve(
                    body, tenant=tenant, deadline=deadline,
                    solver_mode=solver_mode,
                )
            elif path == "/consolidate":
                out, dt = self.daemon.consolidate(
                    body, tenant=tenant, deadline=deadline
                )
            elif path == "/profile":
                from urllib.parse import parse_qs

                q = parse_qs(query)
                enable = None
                if "enable" in q:
                    enable = q["enable"][0] not in ("0", "false", "off")
                state = self.daemon.toggle_profile(enable)
                return send_body(self, 200, json.dumps(state).encode())
            elif path == "/drain":
                # supervisor-initiated clean restart: stop admission,
                # flush the queue (503s), exit with DRAIN_EXIT_CODE once
                # the in-flight device step clears
                state = self.daemon.drain()
                return send_body(self, 200, json.dumps(state).encode())
            elif path == "/brownout":
                # autoscaler-driven ladder transition
                try:
                    req = json.loads(body or b"{}")
                    state = self.daemon.set_brownout(
                        int(req.get("rung", 0))
                    )
                except (ValueError, TypeError):
                    return send_body(
                        self, 400, b'{"error": "bad brownout rung"}'
                    )
                return send_body(self, 200, json.dumps(state).encode())
            else:
                return send_body(self, 404, b'{"error": "not found"}')
        except fleet.ShedError as e:
            # overload is a CONTRACT, not an error: 429 + the gateway's
            # retry estimate; the client fails this solve
            return send_body(
                self, 429,
                json.dumps(
                    {"error": "overloaded", "reason": e.reason}
                ).encode(),
                headers={"Retry-After": f"{e.retry_after:.3f}"},
            )
        except fleet.DrainError:
            # draining is a CONTRACT too: 503 says "restarting, answer
            # came from a live process" — the client fails this solve
            # without charging its breaker
            return send_body(
                self, 503, b'{"error": "draining"}',
            )
        except fleet.QuarantinedError as e:
            # poison pill: refused pre-decode; 422 tells the client to
            # quarantine locally and fail the solve without an RPC
            return send_body(
                self, 422,
                json.dumps({
                    "error": "quarantined",
                    "fingerprint": e.fingerprint,
                }).encode(),
            )
        except segments.SegmentMissError as e:
            # delta-wire typed miss: the store cannot produce
            # these digests — answer 409 naming them (+ our instance id,
            # what the client's sent-cache rebinds on) and the client
            # repairs with ONE upload round. Never a wrong solve, never a
            # breaker charge: a miss is an answer, not a fault.
            return send_body(
                self, 409,
                json.dumps({
                    "error": "segments_missing",
                    "need": e.need,
                    "instance": self.daemon.instance,
                }).encode(),
            )
        except Exception as e:
            return send_body(
                self, 500, repr(e).encode(), ctype="text/plain"
            )
        send_body(
            self, 200, out, _OCTET,
            headers={
                "X-Solver-Seconds": f"{dt:.6f}",
                "X-Solverd-Instance": self.daemon.instance,
            },
        )


def serve(
    port: int,
    host: str = "127.0.0.1",
    daemon: SolverDaemon = None,
    ready: bool = True,
) -> ThreadingHTTPServer:
    """Serve solverd on host:port in a daemon thread; returns the server
    (port 0 picks a free one — server_address[1]). ``ready=True`` marks the
    daemon ready immediately (in-thread test servers skip warm-up)."""
    d = daemon or SolverDaemon()
    if ready:
        d.ready = True
    handler = type("BoundSolverd", (_Handler,), {"daemon": d})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_ = d
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="karpenter device solver sidecar")
    ap.add_argument("--port", type=int, default=8181)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument(
        "--prewarm", action="store_true",
        help="solve the common shape buckets before serving traffic",
    )
    ap.add_argument(
        "--profile-dir", default=None,
        help="directory for torch.profiler chrome traces; solves are"
        " wrapped in a trace capture while profiling is toggled on via POST"
        " /profile (off by default), so device traces can be grabbed from a"
        " running sidecar without redeploying",
    )
    ap.add_argument(
        "--queue-depth", type=int, default=fleet.DEFAULT_QUEUE_DEPTH,
        help="admission bound: requests in flight (queued + host phase +"
        " device) before the gateway sheds with 429 + Retry-After",
    )
    ap.add_argument(
        "--tenant-weights", default="",
        help="fair-share weights as 'tenant=weight,...' (default weight 1:"
        " a weight-3 tenant gets ~3x the device share under contention)",
    )
    ap.add_argument(
        "--cache-entries", type=int, default=fleet.DEFAULT_CACHE_ENTRIES,
        help="DeviceScheduler cache entry bound (one entry per distinct"
        " problem fingerprint across all tenants)",
    )
    ap.add_argument(
        "--cache-mib", type=int,
        default=fleet.DEFAULT_CACHE_BYTES >> 20,
        help="DeviceScheduler cache approximate-byte bound, in MiB"
        " (encoded-request-size proxy per entry)",
    )
    ap.add_argument(
        "--max-batch", type=int, default=fleet.DEFAULT_MAX_BATCH,
        help="continuous batching: max compatible queued problems one"
        " device grant may solve as a single vmapped batch (1 disables"
        " coalescing — every problem gets its own exclusive grant)",
    )
    ap.add_argument(
        "--batch-window-ms", type=float,
        default=fleet.DEFAULT_BATCH_WINDOW_MS,
        help="continuous batching: max milliseconds a grant leader holds"
        " the device waiting for still-decoding requests to reach the"
        " queue (bounds the latency cost of coalescing; 0 = never wait,"
        " coalesce only what is already queued)",
    )
    ap.add_argument(
        "--devices", type=int, default=1,
        help="run every solve/sweep on a mesh of the first N devices of"
        " --device's kind (0 = every device, 1 = single-device; a request"
        " clamps to what exists): solo scans on the first device, batched"
        " scans and the consolidation sweep split over the mesh",
    )
    ap.add_argument(
        "--device", default=DEFAULT_DEVICE,
        help="torch device the solves run on (default cuda: the sidecar"
        " refuses to start without a GPU; cpu runs the plain scan's"
        " torch ops on the CPU)",
    )
    ap.add_argument(
        "--watchdog-seconds", type=float, default=120.0,
        help="hard wall-clock bound on the exclusive device step; on"
        " overrun the process drains its queue (503s) and exits"
        " crash-only for the supervisor to respawn (0 disables)",
    )
    ap.add_argument(
        "--quarantine-strikes", type=int,
        default=fleet.QUARANTINE_STRIKES,
        help="device-phase faults a problem digest may accumulate inside"
        " the quarantine TTL before the sidecar refuses it with 422",
    )
    ap.add_argument(
        "--quarantine-ttl", type=float, default=fleet.QUARANTINE_TTL,
        help="seconds a quarantined poison-pill digest stays refused",
    )
    ap.add_argument(
        "--solver-mode", choices=list(codec.SOLVER_MODES), default="ffd",
        help="solve backend served when a request names none: ffd ="
        " first-fit-decreasing (classic), relax = convex-relaxation"
        " optimizer with the FFD result as the scored/anytime fallback;"
        " requests override per-call via the wire field or the"
        " X-Solver-Mode header",
    )
    ap.add_argument(
        "--kernel", choices=("cuda", "reference"), default="cuda",
        help="FFD-scan kernel implementation: cuda = the hand-written CUDA"
        " kernel (ops/cuda_ffd.py; its tensors on the CPU take the plain"
        " version), reference = the plain torch scan (ops/ffd.py)."
        " Bit-identical results either way",
    )
    ap.add_argument(
        "--segment-cache-mib", type=int,
        default=segments.DEFAULT_STORE_BYTES >> 20,
        help="delta-wire segment store byte bound, in MiB (canonical"
        " segment bytes; LRU past it — an evicted segment costs the next"
        " manifest one miss/re-upload round, never a wrong solve)",
    )
    ap.add_argument(
        "--segment-ttl", type=float, default=segments.DEFAULT_STORE_TTL,
        help="idle seconds before a segment no manifest references"
        " expires from the store (references refresh it)",
    )
    ap.add_argument(
        "--no-incremental", action="store_true",
        help="disable the incremental re-solve engine: every request"
        " solves fresh even when it names a prev_fingerprint (the"
        " packing ledger is never consulted or populated)",
    )
    ap.add_argument(
        "--incremental-interval", type=int,
        default=incsolve.DEFAULT_FULL_INTERVAL,
        help="drift controller: force a full solve after this many"
        " consecutive warm/partial replays of one problem lineage, so"
        " incremental packings cannot ratchet into bad node sets",
    )
    ap.add_argument(
        "--incremental-max-dirty", type=float,
        default=incsolve.DEFAULT_MAX_DIRTY_FRACTION,
        help="proportionality bound: past this dirty-pod fraction the"
        " engine skips the replay and solves fresh (diff bookkeeping"
        " stops paying for itself)",
    )
    ap.add_argument(
        "--ledger-entries", type=int,
        default=incsolve.DEFAULT_MAX_ENTRIES,
        help="packing ledger entry bound (one remembered packing per"
        " mode-suffixed problem fingerprint, LRU past it)",
    )
    ap.add_argument(
        "--ledger-mib", type=int,
        default=incsolve.DEFAULT_MAX_BYTES >> 20,
        help="packing ledger approximate-byte bound, in MiB (uid/name"
        " reference accounting per entry)",
    )
    ap.add_argument(
        "--quarantine-journal", default=None,
        help="path for the crash-only poison journal: the digest in"
        " flight on the device is recorded here, so a problem that"
        " KILLS the process is charged its strike by the respawned"
        " child (no journal = in-memory quarantine only)",
    )
    args = ap.parse_args()
    if args.devices < 0:
        ap.error("--devices must be >= 0 (0 = every device)")
    if args.watchdog_seconds < 0:
        ap.error("--watchdog-seconds must be >= 0 (0 disables)")
    if args.max_batch < 1:
        ap.error("--max-batch must be >= 1 (1 disables coalescing)")
    if args.batch_window_ms < 0:
        ap.error("--batch-window-ms must be >= 0 (0 = never wait)")
    if args.segment_cache_mib <= 0:
        ap.error("--segment-cache-mib must be positive")
    if args.segment_ttl <= 0:
        ap.error("--segment-ttl must be positive")
    if args.incremental_interval < 1:
        ap.error("--incremental-interval must be >= 1")
    if not (0.0 <= args.incremental_max_dirty <= 1.0):
        ap.error("--incremental-max-dirty must be in [0, 1]")
    if args.ledger_entries < 1 or args.ledger_mib < 1:
        ap.error("--ledger-entries/--ledger-mib must be positive")

    daemon = SolverDaemon(
        profile_dir=args.profile_dir,
        gateway=fleet.FleetGateway(
            max_depth=args.queue_depth,
            weights=fleet.parse_tenant_weights(args.tenant_weights),
            max_batch=args.max_batch,
            batch_window=args.batch_window_ms / 1000.0,
        ),
        sched_cache=fleet.BoundedSchedulerCache(
            max_entries=args.cache_entries,
            max_bytes=args.cache_mib << 20,
        ),
        devices=args.devices,
        watchdog_seconds=args.watchdog_seconds,
        default_mode=args.solver_mode,
        kernel=args.kernel,
        device=args.device,
        segment_store=segments.SegmentStore(
            max_bytes=args.segment_cache_mib << 20,
            ttl=args.segment_ttl,
        ),
        incremental=(
            False
            if args.no_incremental
            else incsolve.IncrementalEngine(
                ledger=incsolve.PackingLedger(
                    max_entries=args.ledger_entries,
                    max_bytes=args.ledger_mib << 20,
                ),
                full_interval=args.incremental_interval,
                max_dirty_fraction=args.incremental_max_dirty,
            )
        ),
        quarantine=fleet.PoisonQuarantine(
            strikes=args.quarantine_strikes,
            ttl=args.quarantine_ttl,
            site="gateway",
            journal_path=args.quarantine_journal,
        ),
        # the real sidecar exits crash-only on watchdog trip / drain; the
        # supervisor's exit-code contract does the rest
        exit_fn=os._exit,
    )
    httpd = serve(args.port, host=args.host, daemon=daemon, ready=False)
    # the supervisor (solver/supervisor.py) reads this line to learn the
    # bound address — same handshake as kube/httpserver.py
    print(
        f"listening on {httpd.server_address[0]}:{httpd.server_address[1]}",
        flush=True,
    )
    daemon.warm_up(prewarm=args.prewarm)
    print("ready", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
