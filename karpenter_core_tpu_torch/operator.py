"""Operator: wires store, cluster state, cloud provider, and controllers
into one reconcile loop (reference: pkg/operator/operator.go:105-223,
kwok/main.go:28-47).

The reference runs ~28 controllers concurrently on a controller-runtime
manager; here the loop is synchronous and cooperative — each pass drives
every controller once, and `run_until_idle` iterates until the store stops
mutating. That is exactly how the reference's envtest suites drive
reconcilers (pkg/test/expectations/expectations.go), promoted to the
framework's runtime; determinism is what makes 50k-pod benches and
differential tests reproducible.

The binder stands in for kube-scheduler: pods nominated to an existing node
bind immediately; pods nominated to a new NodeClaim bind once its node
registers.

Port of ``karpenter_core_tpu/operator.py``. With ``solver="tpu"`` the
provisioning solve and multi-node consolidation's prefix sweep run on the
port's device solver (models/provisioner.py, models/consolidation.py):
in process (``solver_mode="inproc"``) on ``device_scheduler_opts["device"]``
(default ``"cuda"``: building the operator raises without a GPU), or
behind the port's solverd sidecar (``solver_mode="sidecar"``: a supervised
``karpenter_core_tpu_torch.solver.service`` child, which owns the card and
takes ``device_scheduler_opts["device"]`` as its ``--device``), through
``solver_kernel`` (``cuda``, the hand kernel, or ``reference``, its plain
version) and ``solver_backend`` (``ffd`` or ``relax``).
``solver_devices`` resolves as in the JAX package (0 = every device, a
larger count clamps to what exists); above 1 the solve runs on a mesh of
that many devices (in process, or in the child, which gets ``--devices``).
A spawned fleet (``solver_fleet > 1``) and the tier autoscaler
(``solver_autoscale``) run as in the JAX package: supervised children on
distinct ports, each its own process with its own CUDA context, routed by
the ``FleetRouter``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.api.nodeclaim import NodeClaim
from karpenter_core_tpu_torch.api.objects import Node, Pod
from karpenter_core_tpu_torch.cloudprovider.kwok import KwokCloudProvider
from karpenter_core_tpu_torch.controllers.disruption.controller import (
    DisruptionController,
)
from karpenter_core_tpu_torch.controllers.node.health import NodeHealth
from karpenter_core_tpu_torch.controllers.node.termination import NodeTermination
from karpenter_core_tpu_torch.controllers.nodeclaim.disruption import (
    NodeClaimDisruption,
    PodEvents,
)
from karpenter_core_tpu_torch.controllers.nodeclaim.gc import (
    Consistency,
    Expiration,
    GarbageCollection,
)
from karpenter_core_tpu_torch.controllers.nodeclaim.hydration import Hydration
from karpenter_core_tpu_torch.controllers.nodeclaim.lifecycle import NodeClaimLifecycle
from karpenter_core_tpu_torch.controllers.nodepool.controllers import (
    Counter,
    Hash,
    Readiness,
    Validation,
)
from karpenter_core_tpu_torch.controllers.provisioning.provisioner import Provisioner
from karpenter_core_tpu_torch.events import Recorder
from karpenter_core_tpu_torch.kube.store import KubeStore
from karpenter_core_tpu_torch.solver.fleet import (
    DEFAULT_BATCH_WINDOW_MS,
    DEFAULT_MAX_BATCH,
)
from karpenter_core_tpu_torch.state.cluster import Cluster
from karpenter_core_tpu_torch.utils import pod as podutil
from karpenter_core_tpu_torch.utils.clock import Clock
from karpenter_core_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# -- reconcile fault isolation -----------------------------------------------
# One controller's exception must not kill the pass (the reference runs ~28
# independent controllers on a manager; an error there requeues ONE object
# with rate limiting, controller-runtime's DefaultTypedControllerRateLimiter).
# A guarded invocation that raises puts its controller on exponential requeue
# backoff; repeated consecutive errors mark it crash-looping and readyz()
# reports the control plane degraded.
RECONCILE_BACKOFF_BASE = 1.0
RECONCILE_BACKOFF_CAP = 60.0
CRASHLOOP_THRESHOLD = 3


def _parse_bool(value: str) -> bool:
    """Flag/env bool: the feature-gate truthy set, rejecting typos loudly
    (a misspelled 'fales' must not silently enable verification-off)."""
    low = value.strip().lower()
    if low in ("true", "1", "yes", "on"):
        return True
    if low in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {value!r}")


@dataclass
class Options:
    """Flag surface (reference: pkg/operator/options/options.go:49-102, plus
    the new solver seam). Resolution order mirrors AddFlags + env fallback
    (options.go:85-144): explicit flag > KARPENTER_* env var > default;
    feature gates parse from the comma-separated "Name=bool" string."""

    solver: str = "greedy"  # greedy | tpu
    # where the tpu solver runs: in this process, or behind the solverd
    # sidecar (solver/service.py) with RPC fault tolerance
    # (solver/remote.py; a solve the sidecar does not answer fails, its
    # pods wait for the next pass). solver_addr="" spawns a supervised
    # local sidecar (solver/supervisor.py); set it to reach an external one.
    solver_mode: str = "inproc"  # inproc | sidecar
    # which solve BACKEND runs behind the Solver seam (relaxsolve):
    # ffd = first-fit-decreasing (classic), relax = the
    # convex-relaxation optimizer with FFD as the scored/anytime
    # fallback. (--solver-mode was already taken by the inproc|sidecar
    # process topology above, so the backend selector is
    # --solver-backend; on the solverd child and the wire it IS named
    # solver mode — X-Solver-Mode / solverd --solver-mode.) In-proc it
    # threads into DeviceScheduler(solver_mode=); in sidecar mode it
    # rides every RPC (wire field + header) AND the spawned child's
    # argv as its default for mode-less clients.
    solver_backend: str = "ffd"  # ffd | relax
    # which KERNEL implementation answers the FFD scan dispatches under
    # whichever backend is selected above: cuda = the hand-written CUDA
    # kernel (ops/cuda_ffd.py, csrc/ffd_step.cu), reference = its plain
    # torch version (ops/ffd.py). Bit-identical results either way.
    # In-proc it threads into DeviceScheduler(kernel_backend=) and the
    # consolidation sweep; in sidecar mode it rides the spawned child's
    # argv (solverd --kernel).
    solver_kernel: str = "cuda"  # cuda | reference
    solver_addr: str = ""
    solver_timeout: float = 30.0  # per-RPC deadline, seconds
    # host-side verification of every device/sidecar solve result
    # (solver/verify.py) before the reconcilers act on it: the trust
    # anchor that lets optimizing backends swap in behind the Solver seam.
    # A rejected result counts solver_result_rejected_total{reason} and
    # publishes a Warning event; in-proc the solve is then redone on the
    # host greedy path, over the sidecar it fails.
    solver_verify: bool = True
    # crash-only survivability knobs for a SPAWNED sidecar (an external
    # --solver-addr sidecar configures its own): the hard wall-clock bound
    # on the exclusive device step (0 disables; rides the spawn argv as
    # solverd --watchdog-seconds), and the poison-pill journal path that
    # lets the gateway's quarantine survive the very crash it predicts
    # (empty = in-memory quarantine only)
    solver_watchdog_seconds: float = 120.0
    solver_quarantine_journal: str = ""
    # the device count of the solve (parallel/mesh.py): 0 = every device,
    # 1 = single-device, a request clamps to what exists; above 1 the
    # solve runs on a mesh (solo scans on its lead device, batched scans
    # and the consolidation sweep split over it). In-proc this threads
    # into the DeviceScheduler; in sidecar mode it rides the spawned
    # child's command line (solverd --devices) — an external
    # --solver-addr sidecar configures its own.
    solver_devices: int = 1
    # fleet tenancy (solver/fleet.py): this operator's identity at a SHARED
    # sidecar — rides every RPC (wire field + X-Solver-Tenant header) for
    # fair queueing / per-tenant accounting, and labels the circuit gauge
    solver_tenant: str = "default"
    # gateway sizing, passed through to a SPAWNED sidecar (an external
    # --solver-addr sidecar configures its own): admission bound before
    # 429 sheds, and 'tenant=weight,...' fair-share weights
    solver_queue_depth: int = 16
    solver_tenant_weights: str = ""
    # continuous cross-tenant batching at the spawned sidecar's gateway:
    # max compatible queued problems one device grant may solve as a
    # single vmapped batch (1 disables coalescing), and the few-ms window
    # a grant leader may hold the device for still-decoding requests
    # (0 = coalesce only what is already queued). The solverd defaults
    # (solver/fleet.py), single-sourced so operator-spawned and
    # externally-launched sidecars can never diverge on a default bump;
    # an external --solver-addr sidecar configures its own.
    solver_max_batch: int = DEFAULT_MAX_BATCH
    solver_batch_window_ms: float = DEFAULT_BATCH_WINDOW_MS
    # horizontally scaled solver tier (segmentstore + fleet routing):
    # spawn N supervised solverds on distinct ports and route
    # client-side with digest affinity + spill-over (solver/remote.
    # FleetRouter). 1 = the classic single sidecar. An external
    # --solver-addr may name a comma-separated member list instead.
    # Spawned members share the card(s): each is a process with its own
    # CUDA context and kernel library, pinned to no GPU.
    solver_fleet: int = 1
    # closed-loop elastic tier (solver/autoscale.py): when
    # enabled, a TierAutoscaler sizes the SPAWNED fleet between min/max
    # off the gateways' queue-wait/shed signals — scale-up through
    # FleetSupervisor.add_member, scale-down through the faultless drain
    # path, brownout ladder at max scale. --solver-fleet stays the
    # STARTING size; 0 min/max default to 1 / max(fleet, min).
    solver_autoscale: bool = False
    solver_fleet_min: int = 0
    solver_fleet_max: int = 0
    # solve-request wire form: delta = content-addressed segment
    # manifests with miss repair and full-wire fallback (unchanged
    # catalogs never re-upload); full = every request ships the whole
    # problem (the pre-v5 behavior, and the escape hatch)
    solver_wire: str = "delta"  # delta | full
    batch_max_duration: float = 10.0
    batch_idle_duration: float = 1.0
    log_level: str = "info"
    poll_interval: float = 1.0  # CLI loop pacing
    max_iters: int = 0  # CLI loop bound (0 = until interrupted)
    feature_gates: Dict[str, bool] = field(default_factory=dict)
    device_scheduler_opts: Dict = field(default_factory=dict)
    # host/device profiling hooks (the reference's pprof surface,
    # operator.go:159-175): cProfile the next N solves + a torch.profiler
    # trace per profiled solve, written under profile_dir
    profile_solves: int = 0
    profile_dir: str = "/tmp/karpenter-profiles"

    # served HTTP surface (operator.go:105-198): 0 disables, -1 picks free
    health_port: int = 0

    _FLAGS = {
        "health_port": ("--health-port", "KARPENTER_HEALTH_PORT", int),
        "solver": ("--solver", "KARPENTER_SOLVER", str),
        "solver_mode": ("--solver-mode", "KARPENTER_SOLVER_MODE", str),
        "solver_backend": (
            "--solver-backend", "KARPENTER_SOLVER_BACKEND", str,
        ),
        "solver_kernel": (
            "--kernel", "KARPENTER_SOLVER_KERNEL", str,
        ),
        "solver_addr": ("--solver-addr", "KARPENTER_SOLVER_ADDR", str),
        "solver_timeout": (
            "--solver-timeout", "KARPENTER_SOLVER_TIMEOUT", float,
        ),
        "solver_verify": (
            "--solver-verify", "KARPENTER_SOLVER_VERIFY", _parse_bool,
        ),
        "solver_watchdog_seconds": (
            "--solver-watchdog-seconds",
            "KARPENTER_SOLVER_WATCHDOG_SECONDS",
            float,
        ),
        "solver_quarantine_journal": (
            "--solver-quarantine-journal",
            "KARPENTER_SOLVER_QUARANTINE_JOURNAL",
            str,
        ),
        "solver_tenant": (
            "--solver-tenant", "KARPENTER_SOLVER_TENANT", str,
        ),
        "solver_devices": (
            "--solver-devices", "KARPENTER_SOLVER_DEVICES", int,
        ),
        "solver_queue_depth": (
            "--solver-queue-depth", "KARPENTER_SOLVER_QUEUE_DEPTH", int,
        ),
        "solver_tenant_weights": (
            "--solver-tenant-weights",
            "KARPENTER_SOLVER_TENANT_WEIGHTS",
            str,
        ),
        "solver_max_batch": (
            "--solver-max-batch", "KARPENTER_SOLVER_MAX_BATCH", int,
        ),
        "solver_batch_window_ms": (
            "--solver-batch-window-ms",
            "KARPENTER_SOLVER_BATCH_WINDOW_MS",
            float,
        ),
        "solver_fleet": (
            "--solver-fleet", "KARPENTER_SOLVER_FLEET", int,
        ),
        "solver_autoscale": (
            "--solver-autoscale", "KARPENTER_SOLVER_AUTOSCALE", _parse_bool,
        ),
        "solver_fleet_min": (
            "--solver-fleet-min", "KARPENTER_SOLVER_FLEET_MIN", int,
        ),
        "solver_fleet_max": (
            "--solver-fleet-max", "KARPENTER_SOLVER_FLEET_MAX", int,
        ),
        "solver_wire": (
            "--solver-wire", "KARPENTER_SOLVER_WIRE", str,
        ),
        "batch_max_duration": (
            "--batch-max-duration", "KARPENTER_BATCH_MAX_DURATION", float,
        ),
        "batch_idle_duration": (
            "--batch-idle-duration", "KARPENTER_BATCH_IDLE_DURATION", float,
        ),
        "log_level": ("--log-level", "KARPENTER_LOG_LEVEL", str),
        "poll_interval": ("--poll-interval", "KARPENTER_POLL_INTERVAL", float),
        "max_iters": ("--max-iters", "KARPENTER_MAX_ITERS", int),
        "profile_solves": (
            "--profile-solves", "KARPENTER_PROFILE_SOLVES", int,
        ),
        "profile_dir": ("--profile-dir", "KARPENTER_PROFILE_DIR", str),
    }

    @classmethod
    def parse(cls, argv=None, env=None) -> "Options":
        import os as _os

        argv = list(argv or [])
        env = dict(env if env is not None else _os.environ)
        opts = cls()
        known = {flag for flag, _, _ in cls._FLAGS.values()} | {
            "--feature-gates"
        }
        flat: Dict[str, str] = {}
        i = 0
        while i < len(argv):
            arg = argv[i]
            name = arg.split("=", 1)[0]
            if name not in known:
                raise ValueError(f"unknown flag {arg!r}")
            if "=" in arg:
                flat[name] = arg.split("=", 1)[1]
            elif i + 1 < len(argv):
                flat[name] = argv[i + 1]
                i += 1
            else:
                raise ValueError(f"flag {arg!r} needs a value")
            i += 1
        for attr, (flag, envvar, conv) in cls._FLAGS.items():
            if flag in flat:
                setattr(opts, attr, conv(flat[flag]))
            elif envvar in env:
                setattr(opts, attr, conv(env[envvar]))
        gates = flat.get(
            "--feature-gates", env.get("KARPENTER_FEATURE_GATES", "")
        )
        for part in filter(None, (p.strip() for p in gates.split(","))):
            name, _, value = part.partition("=")
            opts.feature_gates[name] = value.lower() in ("true", "1", "yes")
        # non-positive durations silently wedge the loop (a zero RPC
        # deadline fails every solve; a zero poll interval busy-spins) —
        # reject them at the flag surface, not deep in a controller
        for attr in ("solver_timeout", "batch_max_duration", "poll_interval",
                     "solver_queue_depth"):
            value = getattr(opts, attr)
            if value <= 0:
                flag = cls._FLAGS[attr][0]
                raise ValueError(
                    f"{flag} must be positive, got {value}"
                )
        if not opts.solver_tenant:
            raise ValueError("--solver-tenant must be non-empty")
        # 0 = all local devices is the only non-positive request that
        # means anything; a negative count is a typo, not a mesh
        if opts.solver_devices < 0:
            raise ValueError(
                "--solver-devices must be >= 0 (0 = all local devices),"
                f" got {opts.solver_devices}"
            )
        if opts.solver_watchdog_seconds < 0:
            raise ValueError(
                "--solver-watchdog-seconds must be >= 0 (0 disables),"
                f" got {opts.solver_watchdog_seconds}"
            )
        if opts.solver_max_batch < 1:
            raise ValueError(
                "--solver-max-batch must be >= 1 (1 disables coalescing),"
                f" got {opts.solver_max_batch}"
            )
        if opts.solver_batch_window_ms < 0:
            raise ValueError(
                "--solver-batch-window-ms must be >= 0 (0 = never wait),"
                f" got {opts.solver_batch_window_ms}"
            )
        if opts.solver_fleet < 1:
            raise ValueError(
                "--solver-fleet must be >= 1 (1 = single sidecar),"
                f" got {opts.solver_fleet}"
            )
        if opts.solver_fleet > 1 and opts.solver_addr:
            # the fleet size only governs SPAWNED children; an external
            # address wins and would silently ignore the flag — a user
            # who believes they have a 4-member fleet must hear otherwise
            raise ValueError(
                "--solver-fleet > 1 spawns supervised sidecars and"
                " cannot combine with --solver-addr; for an external"
                " fleet pass a comma-separated member list as"
                " --solver-addr instead"
            )
        if opts.solver_fleet_min < 0 or opts.solver_fleet_max < 0:
            raise ValueError(
                "--solver-fleet-min/--solver-fleet-max must be >= 0"
                " (0 = derive from --solver-fleet), got"
                f" {opts.solver_fleet_min}/{opts.solver_fleet_max}"
            )
        if opts.solver_autoscale:
            if opts.solver_addr:
                # the autoscaler spawns and retires SUPERVISED members;
                # an external fleet's lifecycle is not ours to resize
                raise ValueError(
                    "--solver-autoscale governs spawned sidecars and"
                    " cannot combine with --solver-addr"
                )
            if opts.solver != "tpu" or opts.solver_mode != "sidecar":
                raise ValueError(
                    "--solver-autoscale requires --solver=tpu"
                    " --solver-mode=sidecar (there is no tier to size"
                    f" under solver={opts.solver!r}"
                    f" mode={opts.solver_mode!r})"
                )
            mn = opts.solver_fleet_min or 1
            mx = opts.solver_fleet_max or max(opts.solver_fleet, mn)
            if mx < mn:
                raise ValueError(
                    f"--solver-fleet-max ({mx}) must be >="
                    f" --solver-fleet-min ({mn})"
                )
            if not mn <= opts.solver_fleet <= mx:
                raise ValueError(
                    f"--solver-fleet ({opts.solver_fleet}) must start"
                    f" inside [--solver-fleet-min, --solver-fleet-max]"
                    f" = [{mn}, {mx}]"
                )
        elif opts.solver_fleet_min or opts.solver_fleet_max:
            # bounds without the loop would silently do nothing — the
            # user believes they have elasticity; tell them otherwise
            raise ValueError(
                "--solver-fleet-min/--solver-fleet-max require"
                " --solver-autoscale"
            )
        if opts.solver_wire not in ("delta", "full"):
            raise ValueError(
                f"unknown solver wire mode {opts.solver_wire!r}"
                " (delta | full)"
            )
        # malformed weights must fail at the flag surface, not inside a
        # respawned sidecar's argparse three failures deep
        from karpenter_core_tpu_torch.solver.fleet import parse_tenant_weights

        parse_tenant_weights(opts.solver_tenant_weights)
        if opts.solver not in ("greedy", "tpu"):
            raise ValueError(f"unknown solver {opts.solver!r}")
        if opts.solver_mode not in ("inproc", "sidecar"):
            raise ValueError(f"unknown solver mode {opts.solver_mode!r}")
        if opts.solver_backend not in ("ffd", "relax"):
            raise ValueError(
                f"unknown solver backend {opts.solver_backend!r}"
            )
        _check_solver_kernel(opts.solver_kernel)
        if opts.solver_mode == "sidecar" and opts.solver != "tpu":
            # the sidecar hosts the DEVICE solver; accepting this combo
            # would silently run greedy in-proc while logging sidecar mode
            raise ValueError(
                "--solver-mode=sidecar requires --solver=tpu "
                f"(got solver={opts.solver!r})"
            )
        return opts


def _check_solver_kernel(kernel: str) -> None:
    # reject loudly: a typo'd kernel name (or the reference's xla | pallas)
    # must not silently fall back to another kernel
    if kernel not in ("cuda", "reference"):
        raise ValueError(f"unknown kernel {kernel!r} (cuda | reference)")


class Operator:
    def __init__(
        self,
        kube: Optional[KubeStore] = None,
        cloud_provider=None,
        clock: Optional[Clock] = None,
        options: Optional[Options] = None,
        instance_types=None,
        solver_client=None,
    ):
        self.clock = clock or Clock()
        # object timestamps (creation, condition transitions) follow the
        # operator's clock so fake-clock tests are fully deterministic
        from karpenter_core_tpu_torch.utils import timesource

        timesource.set_source(self.clock.now)
        self.kube = kube or KubeStore(self.clock)
        self.options = options or Options()
        from karpenter_core_tpu_torch.cloudprovider.metrics import MetricsDecorator
        from karpenter_core_tpu_torch.cloudprovider.unavailableofferings import (
            UnavailableOfferings,
        )

        # the ICE cache is shared three ways: lifecycle marks offerings from
        # typed InsufficientCapacityError context, the provisioner's solve
        # paths exclude them, and a provider that exposes its own cache (the
        # kwok/fake create paths skip cached offerings when picking) keeps
        # using the SAME instance so all views agree
        if cloud_provider is None:
            self.unavailable_offerings = UnavailableOfferings(self.clock)
            cloud_provider = KwokCloudProvider(
                self.kube,
                instance_types,
                unavailable_offerings=self.unavailable_offerings,
            )
        else:
            # `is None`, not truthiness: an EMPTY provider cache is falsy
            # (len 0) but must still be adopted, or lifecycle would mark a
            # different cache than the provider's create path consults
            adopted = getattr(cloud_provider, "unavailable_offerings", None)
            self.unavailable_offerings = (
                adopted
                if adopted is not None
                else UnavailableOfferings(self.clock)
            )
        self.cloud_provider = MetricsDecorator(cloud_provider)
        self.cluster = Cluster(self.kube, self.clock)
        self.recorder = Recorder(self.clock)
        device_opts = dict(self.options.device_scheduler_opts)
        # solverd sidecar wiring (solver_mode=sidecar): a supervised child
        # process (unless an external --solver-addr is given) plus the
        # fault-tolerant RPC client the provisioner routes solves through
        self.solver_supervisor = None
        self.solver_client = None
        self.solver_autoscaler = None
        if solver_client is not None:
            # injection seam (the digital twin, twin/harness.py): the
            # caller owns the client/router — typically one whose breaker
            # cooldowns, retry sleeps and quarantine TTLs ride a VIRTUAL
            # clock so days of fleet churn replay deterministically in
            # minutes — and the tier it points at, so no supervisor spawns
            if self.options.solver_mode != "sidecar":
                raise ValueError(
                    "solver_client injection requires solver_mode=sidecar"
                )
            self.solver_client = solver_client
        elif self.options.solver == "tpu" and self.options.solver_mode == "sidecar":
            from karpenter_core_tpu_torch.solver.remote import (
                FleetRouter,
                SolverClient,
            )

            # --solver-addr may name an external fleet as a comma-
            # separated member list; empty spawns supervised children
            addrs = [
                a.strip()
                for a in self.options.solver_addr.split(",")
                if a.strip()
            ]
            if not addrs:
                from karpenter_core_tpu_torch.solver.supervisor import (
                    FleetSupervisor,
                    SolverSupervisor,
                )

                child_kwargs = dict(
                    # the spawned sidecar arms torch.profiler capture
                    # lazily (POST /profile), so pass the operator's
                    # profile dir through: device traces become grabbable
                    # from the running child without a redeploy
                    profile_dir=self.options.profile_dir,
                    # fleet-gateway sizing for the child (an external
                    # --solver-addr sidecar configures its own)
                    queue_depth=self.options.solver_queue_depth,
                    tenant_weights=self.options.solver_tenant_weights,
                    # continuous-batching shape for the child's gateway
                    max_batch=self.options.solver_max_batch,
                    batch_window_ms=self.options.solver_batch_window_ms,
                    # only a non-default device count rides the argv, so a
                    # respawned child re-reads the operator's choice
                    devices=(
                        self.options.solver_devices
                        if self.options.solver_devices != 1
                        else None
                    ),
                    # the child owns the card: the operator's device rides
                    # its argv (only a non-default one)
                    device=(
                        str(device_opts["device"])
                        if device_opts.get("device", DEFAULT_DEVICE)
                        != DEFAULT_DEVICE
                        else None
                    ),
                    # crash-only survivability: the watchdog bound is
                    # explicit policy (it rides the argv so a respawned
                    # child keeps it), and the poison journal is what
                    # makes gateway-side quarantine survive the crash it
                    # predicts
                    watchdog_seconds=self.options.solver_watchdog_seconds,
                    quarantine_journal=(
                        self.options.solver_quarantine_journal or None
                    ),
                    # the child's default solve backend; per-request
                    # selection still rides every RPC's wire field
                    solve_mode=(
                        self.options.solver_backend
                        if self.options.solver_backend != "ffd"
                        else None
                    ),
                    # the child's FFD-scan kernel implementation; only a
                    # non-default choice rides the argv, so a respawned
                    # child keeps the operator's selection
                    kernel=(
                        self.options.solver_kernel
                        if self.options.solver_kernel != "cuda"
                        else None
                    ),
                )
                if (
                    self.options.solver_fleet > 1
                    or self.options.solver_autoscale
                ):
                    # N children on distinct ports; the router below does
                    # digest-affinity placement across them. The autoscaler
                    # needs the fleet shape even at a starting size of 1 —
                    # add_member/retire_member are its actuators.
                    self.solver_supervisor = FleetSupervisor(
                        self.options.solver_fleet,
                        on_event=self._publish_sidecar_event,
                        **child_kwargs,
                    )
                    addrs = self.solver_supervisor.start()
                else:
                    self.solver_supervisor = SolverSupervisor(
                        on_event=self._publish_sidecar_event,
                        **child_kwargs,
                    )
                    addrs = [self.solver_supervisor.start()]

            fleet_shaped = (
                len(addrs) > 1 or self.options.solver_autoscale
            )

            def _make_client(a: str, member: str) -> "SolverClient":
                return SolverClient(
                    a,
                    timeout=self.options.solver_timeout,
                    on_state_change=self._publish_circuit_event,
                    # this operator's identity at a (possibly shared)
                    # sidecar
                    tenant=self.options.solver_tenant,
                    # delta vs full solve-request wire
                    wire_mode=self.options.solver_wire,
                    member=member if fleet_shaped else "",
                )

            if fleet_shaped:
                # the router shares ONE client-side poison quarantine
                # across members and per-member breakers/sent-caches
                self.solver_client = FleetRouter(
                    [
                        _make_client(a, str(i))
                        for i, a in enumerate(addrs)
                    ],
                    tenant=self.options.solver_tenant,
                )
            else:
                self.solver_client = _make_client(addrs[0], "0")
            if (
                self.options.solver_autoscale
                and self.solver_supervisor is not None
            ):
                from karpenter_core_tpu_torch.solver.autoscale import (
                    SpawnedTier,
                    TierAutoscaler,
                )

                mn = self.options.solver_fleet_min or 1
                mx = self.options.solver_fleet_max or max(
                    self.options.solver_fleet, mn
                )
                self.solver_autoscaler = TierAutoscaler(
                    SpawnedTier(
                        self.solver_supervisor,
                        [self.solver_client],
                        _make_client,
                    ),
                    mn,
                    mx,
                    on_decision=self._publish_autoscale_event,
                )
        # in-proc solves run on device_scheduler_opts["device"] (sidecar
        # mode leaves the device to the child, which owns the card)
        if self.options.solver == "tpu":
            # the backend selector reaches BOTH scheduler constructions:
            # DeviceScheduler(solver_mode=) in-proc, and RemoteScheduler
            # reads it out of device_scheduler_opts for the wire field +
            # X-Solver-Mode header
            device_opts.setdefault(
                "solver_mode", self.options.solver_backend
            )
            # the FFD-scan kernel selector (--kernel) reaches the in-proc
            # DeviceScheduler the same way; in sidecar mode the spawned
            # child's argv carries it instead (the child owns the chips)
            if self.solver_client is None:
                device_opts.setdefault(
                    "kernel_backend", self.options.solver_kernel
                )
                _check_solver_kernel(device_opts["kernel_backend"])
        if self.options.solver == "tpu" and self.solver_client is None:
            device_opts.setdefault("devices", self.options.solver_devices)
            # explicit device, no fallback: CUDA without a GPU raises here
            resolve_device(device_opts.get("device", DEFAULT_DEVICE))
        self.provisioner = Provisioner(
            self.kube,
            self.cluster,
            self.cloud_provider,
            self.clock,
            solver=self.options.solver,
            device_scheduler_opts=device_opts,
            recorder=self.recorder,
            solver_client=self.solver_client,
            unavailable_offerings=self.unavailable_offerings,
            verify_results=self.options.solver_verify,
            # pods already promised capacity by an in-flight nomination
            # must not re-enter the solve (the bind-conflict double-book
            # the twin's fuzzer found — see Provisioner._nominated_pods)
            nominated_pods=self._nominated_pod_keys,
        )
        self.provisioner.profile_solves = self.options.profile_solves
        self.provisioner.profile_dir = self.options.profile_dir
        self.lifecycle = NodeClaimLifecycle(
            self.kube, self.cluster, self.cloud_provider, self.clock,
            unavailable_offerings=self.unavailable_offerings,
            recorder=self.recorder,
        )
        self.termination = NodeTermination(
            self.kube, self.cluster, self.cloud_provider, self.clock,
            recorder=self.recorder,
        )
        self.nodeclaim_disruption = NodeClaimDisruption(
            self.kube, self.cloud_provider, self.clock
        )
        self.pod_events = PodEvents(self.kube, self.cluster, self.clock)
        self.disruption = DisruptionController(
            self.kube,
            self.cluster,
            self.provisioner,
            self.cloud_provider,
            self.clock,
            feature_gates=self.options.feature_gates,
            recorder=self.recorder,
        )
        self.hydration = Hydration(self.kube)
        self.expiration = Expiration(self.kube, self.clock)
        self.garbage_collection = GarbageCollection(
            self.kube, self.cloud_provider, self.clock
        )
        self.consistency = Consistency(self.kube, self.recorder, self.clock)
        self.nodepool_counter = Counter(self.kube, self.cluster)
        self.nodepool_hash = Hash(self.kube)
        self.nodepool_readiness = Readiness(
            self.kube, self.cloud_provider, self.clock
        )
        self.nodepool_validation = Validation(self.kube, self.clock)
        self.node_health = NodeHealth(
            self.kube,
            self.cluster,
            self.cloud_provider,
            self.clock,
            enabled=self.options.feature_gates.get("NodeRepair", False),
        )
        from karpenter_core_tpu_torch.controllers.status import StatusController

        self.status = StatusController(self.kube, self.recorder, self.clock)
        # pod-trigger batching gates the solve (batcher.go:33-110); the
        # store's synchronous watch is the trigger controller
        # (provisioning/controller.go:54-76)
        from karpenter_core_tpu_torch.controllers.provisioning.batcher import Batcher

        self.batcher = Batcher(
            self.clock,
            max_duration=self.options.batch_max_duration,
            idle_duration=self.options.batch_idle_duration,
        )
        self.kube.watch(self._trigger_on_pod)
        # claim/node name -> pod keys awaiting bind
        self.nominations: Dict[str, List[str]] = {}
        # controller name -> (not_before, delay, consecutive_errors,
        # pass_id_recorded): the per-controller requeue backoff state
        # (_guarded); pass_id scopes the skip-gate so a fault armed DURING
        # a pass never skips that same pass's remaining objects
        self._controller_faults: Dict[str, tuple] = {}
        self._pass_id = 0
        # controllers _guarded saw this pass (invoked OR backoff-skipped):
        # a faulted controller that no longer appears at all — its failing
        # object was deleted and no workload remains — must drop its fault,
        # or readyz would report a crash-loop forever with nothing failing
        self._pass_seen: set = set()

    def _nominated_pod_keys(self) -> Dict[str, str]:
        """{pod key -> target} for LIVE nominations (binder ledger): the
        binder prunes dead targets every pass BEFORE provisioning runs,
        so a claim that died returns its pods to the solve the same
        pass. The provisioner excludes these pods from the solve AND
        reserves their capacity on the target node."""
        return {
            key: target
            for target, keys in self.nominations.items()
            for key in keys
        }

    def _trigger_on_pod(self, event: str, kind: str, obj) -> None:
        if kind != "Pod" or event == "DELETED":
            return
        if podutil.is_provisionable(obj):
            self.batcher.trigger()

    # -- solverd sidecar surface -------------------------------------------

    def _publish_sidecar_event(self, reason: str, message: str) -> None:
        """Supervisor lifecycle -> the event stream, the way the reference
        surfaces controller conditions (SidecarUnavailable is the 'sidecar
        unavailable' condition the ops surface watches)."""
        from karpenter_core_tpu_torch.events import Event

        self.recorder.publish(Event(
            involved_object="Solverd/sidecar",
            type="Warning" if "Unavailable" in reason or "Failed" in reason
            else "Normal",
            reason=reason,
            message=message,
        ))

    def _publish_autoscale_event(self, action: str, arg: str) -> None:
        """Autoscaler decisions -> the event stream so the ops surface can
        audit every resize/brownout transition after the fact."""
        from karpenter_core_tpu_torch.events import Event

        if action == "hold":
            return
        self.recorder.publish(Event(
            involved_object="Solverd/sidecar",
            type="Warning" if action.startswith("rung") else "Normal",
            reason="SolverFleetScale",
            message=f"autoscaler decided {action} ({arg})",
        ))

    def _publish_circuit_event(self, state: str) -> None:
        from karpenter_core_tpu_torch.events import Event

        self.recorder.publish(Event(
            involved_object="Solverd/sidecar",
            type="Warning" if state == "open" else "Normal",
            reason="SolverCircuitOpen" if state == "open"
            else "SolverCircuitClosed" if state == "closed"
            else "SolverCircuitHalfOpen",
            message=f"solver circuit breaker is {state}; "
            + (
                "sidecar solves fail until it closes"
                if state == "open"
                else "device solves resume"
            ),
        ))

    def shutdown(self) -> None:
        """Stop owned background resources (the supervised sidecar)."""
        if self.solver_supervisor is not None:
            self.solver_supervisor.stop()

    # -- health surface (operator.go:181-198 healthz/readyz) ---------------

    def healthz(self) -> bool:
        """Liveness: the process can serve (always true in-process)."""
        return True

    def readyz(self) -> bool:
        """Readiness: cluster state has caught up with the store — the
        Synced gate every solve already requires (state/cluster.go:96-150) —
        AND no controller is crash-looping (a controller past the
        consecutive-error threshold means the control plane is degraded;
        the probe surface must say so)."""
        if any(
            fault[2] >= CRASHLOOP_THRESHOLD
            for fault in self._controller_faults.values()
        ):
            return False
        # a solverd member respawning past the storm threshold means the
        # device tier is melting (supervisor.RESPAWN_STORM_*): solves
        # fail while no child answers, and the probe surface must say so
        if (
            self.solver_supervisor is not None
            and self.solver_supervisor.respawn_storm()
        ):
            return False
        return self.cluster.synced()

    # -- fault isolation (see module constants above) ----------------------

    def _guarded(self, controller: str, fn, *args) -> None:
        """Run one reconciler invocation inside the controller's failure
        domain: an exception increments reconcile_errors, publishes a
        Warning event, and escalates the controller's requeue backoff —
        the pass continues. The backoff gate only honors faults recorded
        in EARLIER passes, so the remaining objects of a pass still
        reconcile after a sibling's error, and a mixed controller (one
        broken object among healthy ones) clears its fault state on the
        next success instead of starving siblings or flipping readyz —
        crash-loop detection targets whole-controller failure."""
        self._pass_seen.add(controller)
        fault = self._controller_faults.get(controller)
        now = self.clock.now()
        if (
            fault is not None
            and now < fault[0]
            and fault[3] != self._pass_id
        ):
            return  # still on requeue backoff from a prior pass
        try:
            fn(*args)
        except Exception as e:  # noqa: BLE001 — isolation is the point
            self._record_reconcile_error(controller, e)
        else:
            if self._controller_faults.pop(controller, None) is not None:
                self._export_crashloop()

    def _record_reconcile_error(self, controller: str, e: Exception) -> None:
        from karpenter_core_tpu_torch.events import Event
        from karpenter_core_tpu_torch.metrics import wiring as m

        m.RECONCILE_ERRORS.inc(
            {"controller": controller, "error": type(e).__name__}
        )
        self.recorder.publish(Event(
            involved_object=f"Controller/{controller}",
            type="Warning",
            reason="ReconcileError",
            message=f"{type(e).__name__}: {e}",
        ))
        fault = self._controller_faults.get(controller)
        if fault is not None and fault[3] == self._pass_id:
            return  # already escalated this pass; don't compound the delay
        delay = (
            RECONCILE_BACKOFF_BASE
            if fault is None
            else min(fault[1] * 2.0, RECONCILE_BACKOFF_CAP)
        )
        # an optimistic-lock race is an expected requeue in EVERY
        # controller, not evidence of a crash-loop: it backs off like any
        # error (the controller-runtime rate limiter) but never advances
        # the consecutive count that degrades readyz
        from karpenter_core_tpu_torch.kube.store import ConflictError

        if isinstance(e, ConflictError):
            consecutive = 0 if fault is None else fault[2]
        else:
            consecutive = 1 if fault is None else fault[2] + 1
        self._controller_faults[controller] = (
            self.clock.now() + delay, delay, consecutive, self._pass_id,
        )
        self._export_crashloop()

    def _export_crashloop(self) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        m.CONTROLLER_CRASHLOOPING.set(float(sum(
            1
            for fault in self._controller_faults.values()
            if fault[2] >= CRASHLOOP_THRESHOLD
        )))

    def reconcile_backoff_wait_remaining(self) -> float:
        """Seconds until the nearest controller requeue backoff unblocks
        (0 when none) — lets a fake-clock driver elapse the backoff."""
        now = self.clock.now()
        waits = [
            fault[0] - now for fault in self._controller_faults.values()
            if fault[0] > now
        ]
        return min(waits) if waits else 0.0

    # -- one pass ----------------------------------------------------------

    def reconcile_once(self, disrupt: bool = True) -> None:
        self._pass_id += 1
        self._pass_seen = set()
        if self.solver_supervisor is not None:
            # supervise the sidecar(s) every pass; after a respawn the
            # client follows the (possibly fresh) address — no operator
            # restart. A FleetSupervisor reports WHICH members respawned
            # so the router re-points exactly those.
            restarted = self.solver_supervisor.poll()
            if self.solver_client is not None:
                if isinstance(restarted, list):
                    for i in restarted:
                        self.solver_client.set_member_addr(
                            i, self.solver_supervisor.addrs[i]
                        )
                elif restarted:
                    self.solver_client.set_addr(self.solver_supervisor.addr)
        if self.solver_autoscaler is not None:
            # one observe->decide->actuate step per reconcile pass; the
            # controller loop IS the autoscaler's clock, so twin replays
            # that drive reconcile_once on a virtual clock stay
            # deterministic.
            self._guarded("solver.autoscale", self.solver_autoscaler.step)
        for pool in list(self.kube.list_nodepools()):
            self._guarded("nodepool.hash", self.nodepool_hash.reconcile, pool)
            self._guarded(
                "nodepool.validation", self.nodepool_validation.reconcile, pool
            )
            self._guarded(
                "nodepool.readiness", self.nodepool_readiness.reconcile, pool
            )
            self._guarded(
                "nodepool.counter", self.nodepool_counter.reconcile, pool
            )
        for claim in list(self.kube.list_nodeclaims()):
            self._guarded("nodeclaim.lifecycle", self.lifecycle.reconcile, claim)
            self._guarded("nodeclaim.hydration", self.hydration.reconcile, claim)
            self._guarded(
                "nodeclaim.disruption",
                self.nodeclaim_disruption.reconcile,
                claim,
            )
            self._guarded("nodeclaim.expiration", self.expiration.reconcile, claim)
            self._guarded(
                "nodeclaim.consistency", self.consistency.reconcile, claim
            )
        self._guarded("nodeclaim.gc", self.garbage_collection.reconcile)
        for node in list(self.kube.list_nodes()):
            self._guarded("node.termination", self.termination.reconcile, node)
            self._guarded("node.health", self.node_health.reconcile, node)
        self._guarded("binder", self._bind_nominated)
        provisionable = any(
            podutil.is_provisionable(p) for p in self.kube.list_pods()
        )
        # self-heal: pods can become provisionable without a Pod write (a
        # nominated claim died; a pre-populated store) — open a window for
        # them so the batcher gate can never starve the solve
        if provisionable and not self.batcher.open:
            self.batcher.trigger()
        if self.batcher.ready():
            # a closed window resets even with nothing to solve (deleted
            # pods), or its stale age would instantly close the next burst's
            # window and split it into per-pod solves
            self.batcher.reset()
            if provisionable:
                self._guarded("provisioning", self._provision)
        if disrupt:
            self._guarded("disruption", self.disruption.reconcile)
        self._guarded("status", self.status.reconcile)
        self._guarded("metrics", self._export_metrics)
        # drop faults of controllers with no remaining workload (their
        # failing object vanished — nothing is failing anymore)
        stale = [
            name for name in self._controller_faults
            if name not in self._pass_seen
        ]
        if stale:
            for name in stale:
                del self._controller_faults[name]
            self._export_crashloop()

    def _export_metrics(self) -> None:
        """State gauges + pod/node/nodepool exporters (state/metrics.go:36-67,
        pkg/controllers/metrics/{pod,node,nodepool}). Multi-series gauges
        reset before re-export so a phase/nodepool/resource that disappears
        drops its series instead of freezing at the last value (the
        reference's gauge stores delete stale series on every update)."""
        from karpenter_core_tpu_torch.metrics import wiring as m
        from karpenter_core_tpu_torch.utils import resources as resutil

        m.CLUSTER_NODE_COUNT.set(len(self.cluster.nodes()))
        m.CLUSTER_SYNCED.set(1.0 if self.cluster.synced() else 0.0)
        all_pods = self.kube.list_pods()
        by_phase: Dict[str, int] = {}
        for p in all_pods:
            by_phase[p.phase] = by_phase.get(p.phase, 0) + 1
        m.PODS_STATE.reset()
        for phase, n in by_phase.items():
            m.PODS_STATE.set(n, {"phase": phase})
        alloc: Dict[str, float] = {}
        for node in self.kube.list_nodes():
            alloc = resutil.merge(alloc, node.status.allocatable)
        m.NODES_ALLOCATABLE.reset()
        for name, qty in alloc.items():
            m.NODES_ALLOCATABLE.set(qty, {"resource_type": name})
        bound = [p for p in all_pods if p.node_name]
        m.NODES_POD_REQUESTS.reset()
        m.NODES_POD_LIMITS.reset()
        if bound:
            for name, qty in resutil.requests_for_pods(*bound).items():
                m.NODES_POD_REQUESTS.set(qty, {"resource_type": name})
            for name, qty in resutil.limits_for_pods(*bound).items():
                m.NODES_POD_LIMITS.set(qty, {"resource_type": name})
        m.NODEPOOL_USAGE.reset()
        m.NODEPOOL_LIMIT.reset()
        for pool in self.kube.list_nodepools():
            for name, qty in (pool.status.resources or {}).items():
                m.NODEPOOL_USAGE.set(
                    qty, {"nodepool": pool.name, "resource_type": name}
                )
            if pool.spec.limits:
                for name, qty in dict(pool.spec.limits).items():
                    m.NODEPOOL_LIMIT.set(
                        qty, {"nodepool": pool.name, "resource_type": name}
                    )

    def run_until_idle(self, max_iters: int = 100, disrupt: bool = True) -> int:
        """Reconcile until the store stops changing; returns passes used.

        A pending disruption command waiting out its validation TTL is not
        idle: with a steppable (fake) clock the wait elapses here — the
        synchronous stand-in for the reference blocking on clock.After
        (validation.go:88-96) — so consolidation stays closed-loop."""
        for i in range(max_iters):
            before = self.kube.mutations
            self.reconcile_once(disrupt=disrupt)
            if self.kube.mutations == before and not self.disruption.in_flight:
                waits = [self.batcher.wait_remaining()]
                waits.append(self.termination.backoff_wait_remaining())
                waits.append(self.reconcile_backoff_wait_remaining())
                if disrupt:
                    waits.append(self.disruption.validation_wait_remaining())
                    # node-nomination TTLs gate disruption candidacy the
                    # same way the validation TTL gates commands
                    waits.append(self.cluster.nomination_wait_remaining())
                waits = [w for w in waits if w > 0]
                if waits and hasattr(self.clock, "step"):
                    # fire the nearest timer first (batch close / TTL elapse)
                    self.clock.step(min(waits))
                    continue
                return i + 1
        return max_iters

    # -- provisioning + binding -------------------------------------------

    def _provision(self) -> None:
        nominated = self.provisioner.provision()
        for pod_key, target in nominated.items():
            self.nominations.setdefault(target, []).append(pod_key)
        self._bind_nominated()

    def _bind_nominated(self) -> None:
        for target, pod_keys in list(self.nominations.items()):
            node = self.kube.get(Node, target)
            if node is None:
                claim = self.kube.get(NodeClaim, target)
                if claim is None:
                    # claim died (e.g. insufficient capacity): pods go back
                    # through the provisioner
                    del self.nominations[target]
                    continue
                if not claim.is_registered():
                    continue
                node = self.kube.get(Node, claim.status.node_name)
                if node is None:
                    continue
            for key in pod_keys:
                ns, name = key.split("/", 1)
                pod = self.kube.get(Pod, name, ns)
                if pod is None or pod.node_name:
                    continue  # deleted or already bound elsewhere
                self.kube.bind(pod, node.name)
            del self.nominations[target]
            # every nominated bind landed: release the node's disruption
            # protection now instead of waiting out the TTL backstop (a
            # bind that CONFLICTED raised above, keeping entry AND
            # nomination alive for the retry)
            self.cluster.clear_node_nomination(node.name)
