"""Seeded chaos harness: deterministic fault injection at the two seams the
control plane talks through — the ``KubeClient`` (apiserver) and the
``CloudProvider``.

The style is solver/remote.py's ``FaultInjector`` (scripted, consumed in
order, exhausted -> healthy) generalized to many fault sites and backed by
a seeded PRNG for rate-driven storms, so a chaos soak is REPRODUCIBLE:
identical seeds draw identical fault sequences, and with a fake clock the
whole run — including the operator's isolation backoffs and the ICE cache's
TTLs — replays event-for-event.

Faults injected BEFORE delegating model "the request never reached the
server" (create/delete/bind/evict): the store is untouched and the caller
retries from clean state. ``update`` faults inject AFTER delegating —
"applied, response lost" — because controllers mutate the store's own
object in place before calling update; raising before the write would
leave a phantom half-state (mutated object, no version bump, no watch
event) that neither a real apiserver nor a real network can produce.

Capacity stockouts are STATE, not a per-call coin flip: an ``IceStorm``
window writes the provider's ``stockouts`` set (the kwok/fake ground
truth), the provider's create raises typed ICE against it, lifecycle marks
the UnavailableOfferings cache, and the re-solve routes around the storm —
the whole availability loop under test.
"""
from __future__ import annotations

import hashlib
import random
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

from karpenter_core_tpu_torch.cloudprovider.types import (
    CloudProviderError,
    CreateError,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    OfferingKey,
)
from karpenter_core_tpu_torch.kube.store import ConflictError, TooManyRequestsError


def fold_seed(seed: int, name: str) -> int:
    """Fold a scenario seed with a stream name into an independent child
    seed. sha256, not hash(): str hashing is salted per process
    (PYTHONHASHSEED), and a fold that moves between runs would void the
    identical-seed→identical-trace contract the twin's fuzzer shrinks
    against."""
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


class ChaosSchedule:
    """Deterministic fault source shared by every injector.

    ``script`` maps a seam name to a fault list consumed call-by-call
    (``"ok"`` entries pass through); once a seam's script is exhausted,
    ``rates`` take over: ``{"<seam>.<fault>": probability}`` drawn from a
    PER-SEAM child PRNG (seed folded with the seam name), so the same seed
    replays the same faults AND each seam's fault sequence is independent
    of every other seam's draw count — removing one seam's faults (the
    twin's shrinker dropping a fault class from a failing scenario) leaves
    the remaining seams' sequences untouched, which is what makes
    shrinking monotone instead of a reshuffle."""

    def __init__(
        self,
        seed: int = 0,
        rates: Optional[Dict[str, float]] = None,
        script: Optional[Dict[str, List[str]]] = None,
    ):
        self.seed = seed
        self.rates = dict(rates or {})
        self.script = {k: list(v) for k, v in (script or {}).items()}
        self.draws = 0
        self.seam_draws: Dict[str, int] = {}
        self._seam_rngs: Dict[str, random.Random] = {}

    def _rng(self, seam: str) -> random.Random:
        rng = self._seam_rngs.get(seam)
        if rng is None:
            rng = random.Random(fold_seed(self.seed, seam))
            self._seam_rngs[seam] = rng
        return rng

    def next_fault(self, seam: str, faults: Sequence[str]) -> str:
        self.draws += 1
        self.seam_draws[seam] = self.seam_draws.get(seam, 0) + 1
        queued = self.script.get(seam)
        if queued:
            return queued.pop(0)
        rng = None
        for fault in faults:
            rate = self.rates.get(f"{seam}.{fault}", 0.0)
            if rate:
                # one draw per CONFIGURED fault keeps a seam's sequence a
                # pure function of (seed, seam, its own rate keys): faults
                # of OTHER seams can come and go without shifting it
                if rng is None:
                    rng = self._rng(seam)
                if rng.random() < rate:
                    return fault
        return "ok"


class ChaosKubeClient:
    """KubeClient wrapper injecting apiserver-shaped faults on writes:
    ConflictError (optimistic-lock race), TooManyRequestsError (apiserver
    overload), and latency (a slow round-trip, stepped on a fake clock).
    Reads delegate untouched — the seam under test is write contention."""

    WRITE_FAULTS = ("conflict", "too_many_requests", "latency")

    def __init__(self, inner, schedule: ChaosSchedule, latency: float = 0.25):
        self._inner = inner
        self.schedule = schedule
        self.latency = latency
        self.injected: Dict[str, int] = {}

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    def _fault(self, seam: str, verb: str, detail: str) -> None:
        fault = self.schedule.next_fault(seam, self.WRITE_FAULTS)
        if fault == "ok":
            return
        self.injected[fault] = self.injected.get(fault, 0) + 1
        if fault == "latency":
            clock = getattr(self._inner, "clock", None)
            if clock is not None and hasattr(clock, "step"):
                clock.step(self.latency)
            else:
                time.sleep(min(self.latency, 0.01))
            return
        if fault == "conflict":
            raise ConflictError(f"chaos: injected conflict on {verb} {detail}")
        if fault == "too_many_requests":
            raise TooManyRequestsError(
                f"chaos: injected 429 on {verb} {detail}"
            )
        raise ValueError(f"unknown chaos fault {fault!r}")

    @staticmethod
    def _detail(obj) -> str:
        return f"{type(obj).__name__}/{obj.metadata.name}"

    # request-lost faults (store untouched, caller retries clean)

    def create(self, obj):
        self._fault("kube.create", "create", self._detail(obj))
        return self._inner.create(obj)

    def delete(self, obj) -> None:
        self._fault("kube.delete", "delete", self._detail(obj))
        self._inner.delete(obj)

    def bind(self, pod, node_name: str) -> None:
        self._fault("kube.bind", "bind", self._detail(pod))
        self._inner.bind(pod, node_name)

    def evict(self, pod) -> None:
        self._fault("kube.evict", "evict", self._detail(pod))
        self._inner.evict(pod)

    # response-lost fault (applied first — see module docstring)

    def update(self, obj):
        out = self._inner.update(obj)
        self._fault("kube.update", "update", self._detail(obj))
        return out


class SolverChaos:
    """Device-tier fault injector for the solverd sidecar (the third chaos
    seam, after the kube client and the cloud provider): installed on a
    ``SolverDaemon`` it perturbs the solve pipeline at the three points
    the robustness layer must survive —

    * ``wedge`` / ``wedge:<s>`` — the device step sleeps past the
      watchdog budget (the wedged-solve shape: the exclusive grant is
      held, the watchdog trips, the process exits crash-only);
    * ``crash`` — the device step raises (the poison-pill shape: the
      client sees a 500, both quarantines count a strike, and N crashes
      route the problem straight to greedy fleet-wide);
    * ``corrupt_wire`` — the encoded result bytes are deterministically
      damaged (truncation + bit flips), exercising the client's decode/
      ``_materialize`` hardening and the quarantine strike path;
    * ``bad_result`` — the Results object is sabotaged BEFORE encoding
      (a pod silently dropped from a claim), producing a structurally
      valid wire whose content fails the client's ResultVerifier.

    Faults draw from the shared seeded ``ChaosSchedule`` (seam
    ``solverd.solve`` by default; a fleet twin names one seam per member,
    e.g. ``solverd.solve.m2``, so murdering one member's faults never
    shifts its siblings' draws), so a soak replays identically per seed."""

    FAULTS = ("wedge", "crash", "corrupt_wire", "bad_result")

    def __init__(
        self,
        schedule: ChaosSchedule,
        wedge_seconds: float = 1.0,
        sleep=time.sleep,
        seam: str = "solverd.solve",
    ):
        self.schedule = schedule
        self.wedge_seconds = wedge_seconds
        self.sleep = sleep
        self.seam = seam
        self.injected: Dict[str, int] = {}

    def next_fault(self) -> str:
        return self.schedule.next_fault(self.seam, self.FAULTS)

    def _count(self, fault: str) -> None:
        self.injected[fault] = self.injected.get(fault, 0) + 1

    def wedge(self, fault: str) -> None:
        """Hold the exclusive device grant well past any sane budget."""
        self._count("wedge")
        seconds = self.wedge_seconds
        if ":" in fault:
            seconds = float(fault.split(":", 1)[1])
        self.sleep(seconds)

    def crash(self) -> None:
        """Blow up the device phase (counted as a poison strike by both
        quarantine sites; the client sees a 500)."""
        self._count("crash")
        raise RuntimeError("chaos: injected device-phase crash")

    def corrupt(self, data: bytes) -> bytes:
        """Deterministic wire damage: drop the tail and flip bytes in the
        middle — enough to defeat both the npz container and any JSON
        inside, without randomness (the soak must replay per seed)."""
        self._count("corrupt_wire")
        if len(data) < 16:
            return b"\x00" * len(data)
        cut = data[: max(len(data) // 2, 8)]
        mid = len(cut) // 2
        return cut[:mid] + bytes(b ^ 0xFF for b in cut[mid:mid + 8]) + cut[mid + 8:]

    def sabotage(self, results) -> None:
        """Make a valid Results lie: silently drop one placed pod (it
        stays out of pod_errors, so pod conservation breaks — the exact
        defect class an optimizing-backend bug would produce)."""
        self._count("bad_result")
        for claim in results.new_node_claims:
            if claim.pods:
                claim.pods.pop()
                return
        for sim in results.existing_nodes:
            if sim.pods:
                sim.pods.pop()
                return


class IceStorm(NamedTuple):
    """A capacity stockout window: ``offerings`` are unfillable during
    [start, start+duration) of the provider's clock."""

    start: float
    duration: float
    offerings: "tuple[OfferingKey, ...]"


class ChaosCloudProvider:
    """CloudProvider wrapper: per-call create/delete/get faults plus
    time-windowed ICE storms written into the inner provider's ground-truth
    ``stockouts`` set (kwok/fake both expose it)."""

    CREATE_FAULTS = ("create_error", "insufficient_capacity")

    def __init__(
        self,
        inner,
        schedule: ChaosSchedule,
        storms: Sequence[IceStorm] = (),
        clock=None,
    ):
        from karpenter_core_tpu_torch.utils.clock import Clock

        self._inner = inner
        self.schedule = schedule
        self.storms = list(storms)
        self.clock = clock or getattr(inner, "clock", None) or Clock()
        self._base_stockouts = set(getattr(inner, "stockouts", set()))
        self.injected: Dict[str, int] = {}

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    def _count(self, fault: str) -> None:
        self.injected[fault] = self.injected.get(fault, 0) + 1

    def _apply_storms(self) -> None:
        if not self.storms:
            return
        now = self.clock.now()
        active: set = set()
        for storm in self.storms:
            if storm.start <= now < storm.start + storm.duration:
                active.update(OfferingKey(*k) for k in storm.offerings)
        self._inner.stockouts = self._base_stockouts | active

    def create(self, node_claim):
        self._apply_storms()
        fault = self.schedule.next_fault("cloud.create", self.CREATE_FAULTS)
        if fault == "create_error":
            self._count(fault)
            raise CreateError(
                "chaos: injected launch failure",
                condition_reason="ChaosInjected",
            )
        if fault == "insufficient_capacity":
            # context-free ICE (an aggregate stockout the provider could not
            # attribute): lifecycle deletes the claim and the re-solve
            # retries the same offering — the pre-cache degradation path
            self._count(fault)
            raise InsufficientCapacityError(
                "chaos: injected capacity stockout"
            )
        return self._inner.create(node_claim)

    def delete(self, node_claim) -> None:
        if self.schedule.next_fault("cloud.delete", ("delete_error",)) != "ok":
            self._count("delete_error")
            raise CloudProviderError("chaos: injected delete failure")
        self._inner.delete(node_claim)

    def get(self, provider_id: str):
        if self.schedule.next_fault("cloud.get", ("not_found",)) != "ok":
            self._count("not_found")
            raise NodeClaimNotFoundError(
                f"chaos: injected not-found for {provider_id}"
            )
        return self._inner.get(provider_id)
