"""Sidecar lifecycle supervision: spawn, monitor, restart with backoff.

The operator owns one SolverSupervisor when ``--solver-mode=sidecar`` runs
without an external ``--solver-addr``: it spawns
``python -m karpenter_core_tpu_torch.solver.service`` as a child process, learns
the bound address from the child's ``listening on host:port`` handshake
line (the kube/httpserver.py pattern), and on every reconcile pass checks
the child is alive — a dead child respawns under exponential backoff so a
crash-looping solver cannot busy-spin the operator, and every respawn is
surfaced through the ``on_event`` hook (the operator wires it to the event
recorder as a "sidecar unavailable"/"restarted" condition) plus the
``solverd_restarts_total`` counter (``cause=crash`` charges the backoff;
``cause=drain`` — the child flushed its queue via POST /drain and exited
with DRAIN_EXIT_CODE — respawns immediately without one).

The command is injectable so tests supervise a stub child; the default
spawns the real solverd module.

Port of ``karpenter_core_tpu/solver/supervisor.py``: the child is the
port's ``karpenter_core_tpu_torch.solver.service``, and its argv also
carries ``--device`` (the torch device the child solves on; default
``cuda``, so a CPU child is asked for with ``device="cpu"``) and the
port's ``--kernel cuda|reference``.
"""
from __future__ import annotations

import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

# exit-code contract with solverd (solver/service.py): a drain-initiated
# exit (POST /drain flushed the queue and asked to be restarted) uses
# DRAIN_EXIT_CODE so the supervisor can tell a CLEAN restart request from
# a crash — drain exits respawn immediately and never charge crash-loop
# backoff. A watchdog trip (wedged device step) exits with
# WATCHDOG_EXIT_CODE: deliberate, but still a fault — it charges backoff
# like any crash so a poison problem cannot hot-loop the respawn.
DRAIN_EXIT_CODE = 64
WATCHDOG_EXIT_CODE = 86
# consecutive drain exits (no stable run between) tolerated before the
# supervisor stops believing them and escalates to crash-cause backoff
DRAIN_STREAK_CAP = 3
# how long a draining child waits for its in-flight device step before
# exiting anyway (solver/service.py _exit_after_idle reads this); the
# supervisor's drain() wait is sized PAST it + the exit grace, so a drain
# that succeeds at the deadline is never misreported as a failure
DRAIN_EXIT_DEADLINE_SECONDS = 30.0
# respawn-storm alarm: a member that respawns more than STORM_THRESHOLD
# times inside a sliding STORM_WINDOW is MELTING, not crash-only-churning
# — the backoff keeps the operator responsive, but readyz must say the
# tier is degraded (the digital twin and production probes both key on
# it: routine churn is a counter, a storm is an alarm)
RESPAWN_STORM_WINDOW = 600.0
RESPAWN_STORM_THRESHOLD = 5


def default_command(
    port: int,
    prewarm: bool = False,
    profile_dir: Optional[str] = None,
    queue_depth: Optional[int] = None,
    tenant_weights: str = "",
    cache_entries: Optional[int] = None,
    cache_mib: Optional[int] = None,
    max_batch: Optional[int] = None,
    batch_window_ms: Optional[float] = None,
    devices: Optional[int] = None,
    watchdog_seconds: Optional[float] = None,
    quarantine_journal: Optional[str] = None,
    solve_mode: Optional[str] = None,
    kernel: Optional[str] = None,
    device: Optional[str] = None,
) -> List[str]:
    cmd = [
        sys.executable,
        "-m",
        "karpenter_core_tpu_torch.solver.service",
        "--port",
        str(port),
    ]
    if prewarm:
        cmd.append("--prewarm")
    if profile_dir:
        # the sidecar arms torch.profiler capture lazily (POST /profile),
        # so passing the directory at spawn time costs nothing until
        # toggled
        cmd.extend(["--profile-dir", profile_dir])
    # fleet-gateway sizing (solver/fleet.py): only non-defaults ride the
    # command line, so a respawned child always re-reads the operator's
    # configuration rather than a stale frozen argv default
    if queue_depth is not None:
        cmd.extend(["--queue-depth", str(queue_depth)])
    if tenant_weights:
        cmd.extend(["--tenant-weights", tenant_weights])
    if cache_entries is not None:
        cmd.extend(["--cache-entries", str(cache_entries)])
    if cache_mib is not None:
        cmd.extend(["--cache-mib", str(cache_mib)])
    # continuous-batching shape for the child's gateway (solverd
    # --max-batch / --batch-window-ms): rides the argv so a respawned
    # sidecar keeps the operator's coalescing policy
    if max_batch is not None:
        cmd.extend(["--max-batch", str(max_batch)])
    if batch_window_ms is not None:
        cmd.extend(["--batch-window-ms", str(batch_window_ms)])
    # the child owns the chips: the operator's --solver-devices rides the
    # spawn command so a respawned sidecar re-shards over the same slice
    if devices is not None:
        cmd.extend(["--devices", str(devices)])
    if watchdog_seconds is not None:
        cmd.extend(["--watchdog-seconds", str(watchdog_seconds)])
    # the quarantine journal is what makes poison protection survive the
    # very crash the poison causes: the respawned child reads back the
    # fingerprint that was in flight when its predecessor died
    if quarantine_journal:
        cmd.extend(["--quarantine-journal", quarantine_journal])
    # the child's default solve backend (relaxsolve): only a
    # non-default rides the argv, so a respawned sidecar keeps serving
    # the operator's --solver-backend choice to mode-less requests
    if solve_mode:
        cmd.extend(["--solver-mode", solve_mode])
    # the FFD-scan kernel implementation (--kernel=cuda|reference): only a
    # non-default rides the argv, so a respawned sidecar keeps answering
    # scans with the operator's choice
    if kernel:
        cmd.extend(["--kernel", kernel])
    # the torch device the child solves on (--device, default cuda): only
    # a non-default rides the argv
    if device:
        cmd.extend(["--device", device])
    return cmd


class SolverSupervisor:
    def __init__(
        self,
        command: Optional[List[str]] = None,
        port: int = 0,
        prewarm: bool = False,
        profile_dir: Optional[str] = None,
        queue_depth: Optional[int] = None,
        tenant_weights: str = "",
        cache_entries: Optional[int] = None,
        cache_mib: Optional[int] = None,
        max_batch: Optional[int] = None,
        batch_window_ms: Optional[float] = None,
        devices: Optional[int] = None,
        watchdog_seconds: Optional[float] = None,
        quarantine_journal: Optional[str] = None,
        solve_mode: Optional[str] = None,
        kernel: Optional[str] = None,
        device: Optional[str] = None,
        backoff_initial: float = 1.0,
        backoff_max: float = 30.0,
        stable_window: float = 60.0,
        spawn_timeout: float = 60.0,
        time_fn=time.monotonic,
        on_event: Optional[Callable[[str, str], None]] = None,
        storm_window: float = RESPAWN_STORM_WINDOW,
        storm_threshold: int = RESPAWN_STORM_THRESHOLD,
        member: str = "0",
    ):
        self.command = command or default_command(
            port, prewarm, profile_dir,
            queue_depth=queue_depth,
            tenant_weights=tenant_weights,
            cache_entries=cache_entries,
            cache_mib=cache_mib,
            max_batch=max_batch,
            batch_window_ms=batch_window_ms,
            devices=devices,
            watchdog_seconds=watchdog_seconds,
            quarantine_journal=quarantine_journal,
            solve_mode=solve_mode,
            kernel=kernel,
            device=device,
        )
        self.backoff_initial = backoff_initial
        self.backoff_max = backoff_max
        # deadline on the handshake line: a child that wedges before
        # printing it must not hang the operator's reconcile loop
        self.spawn_timeout = spawn_timeout
        # a child must stay up this long before the backoff resets — a
        # crash-looping sidecar (spawns fine, dies seconds later) must not
        # re-earn an immediate respawn on every death
        self.stable_window = stable_window
        self.time_fn = time_fn
        self.on_event = on_event
        self.proc: Optional[subprocess.Popen] = None
        self.addr: str = ""
        self.restarts = 0
        # delay before the NEXT respawn attempt: 0 after a stable run (the
        # first restart is immediate), then backoff_initial doubling per
        # attempt while the child keeps dying, capped at backoff_max
        self._delay = 0.0
        self._next_spawn_at = 0.0
        self._down_since: Optional[float] = None
        self._last_spawn_at = 0.0
        # how the current down child exited: "crash" (charges backoff) or
        # "drain" (clean restart request — respawn immediately)
        self._exit_cause = "crash"
        # consecutive drain exits without an intervening stable run: a
        # drain-LOOPING child (a misfiring preStop hook POSTing /drain
        # every probe, or anything else exiting DRAIN_EXIT_CODE at boot —
        # it collides with sysexits EX_USAGE) must not ride the
        # no-backoff path into a respawn storm; past the streak cap it is
        # treated as a crash
        self._drain_streak = 0
        # respawn-storm alarm state: timestamps of recent respawns inside
        # the sliding window; `member` labels the gauge so a fleet
        # dashboard sees WHICH member is melting
        self.storm_window = storm_window
        self.storm_threshold = storm_threshold
        self.member = member
        self._respawn_times: List[float] = []

    # -- lifecycle ---------------------------------------------------------

    def _emit(self, reason: str, message: str) -> None:
        if self.on_event is not None:
            self.on_event(reason, message)

    def _spawn(self) -> str:
        self._last_spawn_at = self.time_fn()
        self.proc = subprocess.Popen(
            self.command,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
        )
        # handshake: the child prints "listening on host:port" once bound
        # (before any heavy warm-up, so this resolves in import time, not
        # compile time). The read runs under a deadline — a child that
        # wedges pre-handshake (stuck import, held compile-cache lock)
        # raises here instead of hanging reconcile; poll() turns that into
        # backoff + an event, and provisioning solves fail until a child
        # answers.
        got: List[str] = []
        reader = threading.Thread(
            target=lambda: got.append(self.proc.stdout.readline()),
            daemon=True,
        )
        reader.start()
        reader.join(self.spawn_timeout)
        line = got[0] if got else ""
        if "listening on" not in line:
            self.proc.kill()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            raise RuntimeError(
                "sidecar failed to start ("
                + (f"got {line!r}" if got else
                   f"no handshake within {self.spawn_timeout}s")
                + f" from {self.command!r})"
            )
        self.addr = line.strip().rsplit(" ", 1)[-1]
        return self.addr

    def start(self) -> str:
        """Spawn the sidecar; returns its host:port address."""
        return self._spawn()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def poll(self) -> bool:
        """One supervision pass: respawn a dead child once its backoff
        window has elapsed. Returns True when a restart happened (the
        caller re-points its SolverClient at the possibly-new address)."""
        if self.proc is None:
            return False
        now = self.time_fn()
        if self.alive():
            if now - self._last_spawn_at >= self.stable_window:
                self._delay = 0.0
                self._drain_streak = 0
            return False
        if self._down_since is None:
            self._down_since = now
            rc = self.proc.returncode
            if rc == DRAIN_EXIT_CODE and self._drain_streak < DRAIN_STREAK_CAP:
                # clean drain-exit: the child flushed its queue and ASKED
                # to be restarted — respawn immediately, charge nothing
                # (a drain must never look like a crash loop). The streak
                # cap is the exception: N consecutive drains with no
                # stable run in between is a drain LOOP, and it earns
                # crash-cause backoff like any other respawn storm.
                self._exit_cause = "drain"
                self._drain_streak += 1
                self._next_spawn_at = now
                self._emit(
                    "SidecarDrained",
                    f"solver sidecar drained and exited cleanly (code {rc})",
                )
            else:
                # the accumulated delay survives a "successful" spawn that
                # dies again seconds later — only stability resets it
                self._exit_cause = "crash"
                self._next_spawn_at = now + self._delay
                self._emit(
                    "SidecarUnavailable",
                    "solver sidecar exited with code "
                    + (f"{rc} (watchdog)" if rc == WATCHDOG_EXIT_CODE
                       else f"{rc}"),
                )
        if now < self._next_spawn_at:
            return False
        if self._exit_cause == "crash":
            self._delay = min(
                max(self._delay * 2, self.backoff_initial), self.backoff_max
            )
        try:
            self._spawn()
        except (OSError, RuntimeError) as e:
            if self._exit_cause == "drain":
                # the clean path failed to come back — escalate like a crash
                self._exit_cause = "crash"
                self._delay = min(
                    max(self._delay * 2, self.backoff_initial),
                    self.backoff_max,
                )
            self._next_spawn_at = now + self._delay
            self._emit("SidecarRestartFailed", str(e))
            return False
        from karpenter_core_tpu_torch.metrics import wiring as m

        m.SOLVERD_RESTARTS.inc({"cause": self._exit_cause})
        self.restarts += 1
        self._note_respawn(self.time_fn())
        self._down_since = None
        self._emit(
            "SidecarRestarted", f"solver sidecar respawned on {self.addr}"
        )
        return True

    # -- respawn-storm alarm ----------------------------------------------

    def _note_respawn(self, now: float) -> None:
        """Record one respawn in the sliding storm window and export the
        alarm gauge; the accounting is separate from _spawn so a fake
        clock can drive it without subprocesses."""
        self._respawn_times.append(now)
        self._prune_storm(now)
        self._export_storm()

    def _prune_storm(self, now: float) -> None:
        cutoff = now - self.storm_window
        self._respawn_times = [t for t in self._respawn_times if t > cutoff]

    def respawn_storm(self) -> bool:
        """True while this member exceeded storm_threshold respawns inside
        the sliding storm_window — the tier is melting, not churning;
        readyz() degrades on it and solverd_respawn_storm exports it."""
        self._prune_storm(self.time_fn())
        self._export_storm()
        return len(self._respawn_times) > self.storm_threshold

    def _export_storm(self) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        m.SOLVERD_RESPAWN_STORM.set(
            1.0 if len(self._respawn_times) > self.storm_threshold else 0.0,
            {"member": self.member},
        )

    def drain(
        self, timeout: float = DRAIN_EXIT_DEADLINE_SECONDS + 15.0
    ) -> bool:
        """Ask the child to drain and restart cleanly: POST /drain stops
        admission, flushes queued requests with 503s, and exits with
        DRAIN_EXIT_CODE once the in-flight device step finishes. Returns
        True when the child exited within the timeout — the next poll()
        then respawns it immediately (cause=drain, no backoff charge).
        The default timeout sits PAST the child's own in-flight wait
        deadline + exit grace, so a drain that completes at the wire is
        reported as the success it is."""
        import http.client

        if not self.alive():
            return False
        host, _, port = self.addr.rpartition(":")
        try:
            conn = http.client.HTTPConnection(
                host or "127.0.0.1", int(port), timeout=min(timeout, 5.0)
            )
            try:
                conn.request("POST", "/drain", b"")
                conn.getresponse().read()
            finally:
                conn.close()
        except (OSError, ValueError):
            return False
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return False
        return True

    def stop(self) -> None:
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        if self.proc.stdout is not None:
            self.proc.stdout.close()
        self.proc = None


class FleetSupervisor:
    """--solver-fleet=N: N supervised solverd children on distinct ports.

    Composes N SolverSupervisors — each member keeps the FULL single-child
    contract (handshake deadline, crash-vs-drain exit classification,
    crash-loop backoff, the drain streak cap) unchanged; this class only
    adds the fleet-shaped surface the operator and the client-side router
    (solver/remote.FleetRouter) consume: start-all, per-pass poll-all
    (returning WHICH members respawned, so the router re-points exactly
    those addresses), per-member drain, stop-all. The crash-only
    drain/respawn already made each member replaceable; the fleet tier is
    routing + cache warmth, not new lifecycle machinery.

    Every child spawns with ``port=0`` (each picks its own free port), so
    members can never collide, and member events carry their index so the
    operator's event stream says WHICH sidecar restarted."""

    def __init__(
        self,
        n: int,
        on_event: Optional[Callable[[str, str], None]] = None,
        supervisor_factory=None,
        **child_kwargs,
    ):
        if n < 1:
            raise ValueError(f"fleet size must be >= 1, got {n}")
        self.on_event = on_event
        # retained for elastic growth (TierAutoscaler scale-up): a member
        # added later spawns with exactly the same child configuration as
        # the founding set
        self._factory = supervisor_factory or SolverSupervisor
        self._child_kwargs = dict(child_kwargs)
        # monotonic member-label source: labels are never reused after a
        # retirement, so the router's rendezvous hash (keyed on the label)
        # and the member-labeled metric series never alias a successor to
        # a retired member
        self._next_member = n
        self.members: List[SolverSupervisor] = [
            self._factory(
                on_event=self._member_event(str(i)),
                member=str(i),
                **self._child_kwargs,
            )
            for i in range(n)
        ]

    def _member_event(self, member: str) -> Callable[[str, str], None]:
        def emit(reason: str, message: str) -> None:
            if self.on_event is not None:
                self.on_event(reason, f"[member {member}] {message}")

        return emit

    def _check_index(self, i: int, site: str) -> None:
        if not 0 <= i < len(self.members):
            from karpenter_core_tpu_torch.solver.fleet import UnknownMemberError

            raise UnknownMemberError(i, len(self.members), site)

    def start(self) -> List[str]:
        """Spawn every member; returns their host:port addresses in
        member order (the router's stable member indices)."""
        return [m.start() for m in self.members]

    @property
    def addrs(self) -> List[str]:
        return [m.addr for m in self.members]

    def alive_count(self) -> int:
        return sum(1 for m in self.members if m.alive())

    def poll(self) -> List[int]:
        """One supervision pass over every member; returns the indices
        that respawned this pass (the caller re-points its router at
        those members' possibly-new addresses). A member still inside
        its crash backoff simply stays down this pass — the router keeps
        serving from the rest."""
        return [i for i, m in enumerate(self.members) if m.poll()]

    def respawn_storm(self) -> bool:
        """True while ANY member is inside a respawn storm (the operator's
        readyz degrades on it; per-member detail rides the member-labeled
        solverd_respawn_storm gauge). Short-circuits: each member's gauge
        series stays current through its own _note_respawn/respawn_storm
        calls, so the aggregate need not touch every member on every
        probe."""
        return any(m.respawn_storm() for m in self.members)

    def add_member(self, start: bool = True) -> int:
        """Grow the fleet by one member (TierAutoscaler scale-up): spawn a
        child with the retained configuration under a fresh, never-reused
        member label. Returns the new member's index; its address is at
        ``self.members[index].addr``."""
        member = str(self._next_member)
        self._next_member += 1
        sup = self._factory(
            on_event=self._member_event(member),
            member=member,
            **self._child_kwargs,
        )
        self.members.append(sup)
        if start:
            sup.start()
        return len(self.members) - 1

    def retire_member(
        self, i: int, timeout: float = DRAIN_EXIT_DEADLINE_SECONDS + 15.0
    ) -> bool:
        """Scale-down = the faultless drain path: POST /drain closes the
        member's admission, flushes its queue with 503s (answered
        refusals — no breaker charge for callers), and the child exits
        ``DRAIN_EXIT_CODE``; instead of respawning, the supervisor reaps
        it and drops it from the fleet. Returns True when the child
        exited through the drain contract (False = it had to be
        terminated, which ``stop()`` does regardless)."""
        self._check_index(i, "retire_member")
        if len(self.members) <= 1:
            raise ValueError("cannot retire the last fleet member")
        sup = self.members[i]
        clean = sup.drain(timeout=timeout)
        sup.stop()
        self.members.pop(i)
        return clean

    def drain(self, i: int, **kwargs) -> bool:
        """Drain ONE member (rolling restarts: drain, poll-respawn,
        next) — the fleet keeps serving from the others meanwhile."""
        self._check_index(i, "drain")
        return self.members[i].drain(**kwargs)

    def stop(self) -> None:
        for m in self.members:
            m.stop()
