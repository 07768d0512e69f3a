"""Disruption controller: method precedence, command execution, and the
orchestration queue waiting on replacements
(reference: pkg/controllers/disruption/controller.go:54-247,
orchestration/queue.go:108-249).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import NodeClaim
from karpenter_core_tpu_torch.api.objects import Node
from karpenter_core_tpu_torch.controllers.disruption.helpers import (
    build_disruption_budget_mapping,
    get_candidates,
)
from karpenter_core_tpu_torch.controllers.disruption.methods import (
    Drift,
    Emptiness,
    MultiNodeConsolidation,
    SingleNodeConsolidation,
)
from karpenter_core_tpu_torch.controllers.disruption.types import Command
from karpenter_core_tpu_torch.controllers.disruption.validation import (
    CONSOLIDATION_TTL,
    validate_command,
)
from karpenter_core_tpu_torch.kube.store import NotFoundError
from karpenter_core_tpu_torch.scheduling.taints import DISRUPTED_NO_SCHEDULE_TAINT

COMMAND_TIMEOUT = 10 * 60.0  # orchestration/queue.go:53


@dataclass
class DisruptionContext:
    """What every method needs to see (stand-in for the Go struct embeds)."""

    kube: object
    cluster: object
    provisioner: object
    cloud_provider: object
    clock: object
    feature_gates: Dict[str, bool] = field(default_factory=dict)


@dataclass
class InFlightCommand:
    command: Command
    replacement_names: List[str]
    created_at: float


@dataclass
class PendingCommand:
    """A computed command waiting out the validation TTL
    (validation.go:83-101)."""

    command: Command
    method: object
    computed_at: float


class DisruptionController:
    def __init__(
        self,
        kube,
        cluster,
        provisioner,
        cloud_provider,
        clock,
        feature_gates: Optional[Dict[str, bool]] = None,
        recorder=None,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        ctx = DisruptionContext(
            kube=kube,
            cluster=cluster,
            provisioner=provisioner,
            cloud_provider=cloud_provider,
            clock=clock,
            feature_gates=dict(feature_gates or {}),
        )
        self.ctx = ctx
        # method precedence (controller.go:84-93)
        self.methods = [
            Drift(ctx),
            Emptiness(ctx),
            MultiNodeConsolidation(ctx),
            SingleNodeConsolidation(ctx),
        ]
        self.in_flight: List[InFlightCommand] = []
        self.pending: List[PendingCommand] = []

    # -- the 10s poll body (controller.go:104-197) -------------------------

    def reconcile(self) -> Optional[Command]:
        self._untaint_outdated()
        self._reconcile_orchestration()
        # in-flight commands run CONCURRENTLY (orchestration/queue.go:108-141),
        # and so do pending validations: each command waits out its own 15s
        # TTL (per-command computed_at), the way every reference command gets
        # its own IsValid window (validation.go:83-101). Double-disruption is
        # prevented two ways: executed candidates by the marked_for_deletion
        # gate in new_candidate (the HasAny guard of queue.go:305), and
        # still-pending candidates by the busy-name filter below.
        executed = self._reconcile_pending()
        from karpenter_core_tpu_torch.metrics import wiring as m

        busy = {
            c.name for p in self.pending for c in p.command.candidates
        }
        # ONE budget mapping per poll, shared by every method and
        # pre-charged with still-pending commands: concurrent pending
        # validation would otherwise let each method (and each poll) spend
        # the full budget again — marked_for_deletion only counts after
        # execution (helpers.go:197-245 counts the disrupting state; the
        # pending window is this design's addition, so it must consume too)
        budgets = build_disruption_budget_mapping(
            self.clock, self.cluster, self.kube
        )
        for p in self.pending:
            for c in p.command.candidates:
                budgets.consume(c.nodepool.name, p.method.reason)
        for method in self.methods:
            candidates = get_candidates(
                self.clock,
                self.cluster,
                self.kube,
                self.cloud_provider,
                method.should_disrupt,
            )
            candidates = [c for c in candidates if c.name not in busy]
            m.DISRUPTION_ELIGIBLE_NODES.set(
                len(candidates), {"reason": method.reason}
            )
            if not candidates:
                continue
            command = method.compute_command(budgets, candidates)
            if command.decision == "no-op":
                continue
            if getattr(method, "validation", None) is not None:
                # hold for the TTL; validated on a later pass while other
                # commands keep computing against the remaining candidates
                self.pending.append(
                    PendingCommand(
                        command=command,
                        method=method,
                        computed_at=self.clock.now(),
                    )
                )
                busy.update(c.name for c in command.candidates)
                continue
            self._execute(command)
            return command
        if executed:
            return executed[-1]
        if not self.pending:
            self.cluster.mark_consolidated()
        return None

    def validation_wait_remaining(self) -> float:
        """Seconds until the NEXT pending command's TTL elapses (0 if none)."""
        if not self.pending:
            return 0.0
        return min(
            max(CONSOLIDATION_TTL - self.clock.since(p.computed_at), 0.0)
            for p in self.pending
        )

    def _reconcile_pending(self) -> List[Command]:
        """Validate + execute every pending command whose TTL has elapsed."""
        from karpenter_core_tpu_torch.metrics import wiring as m

        executed: List[Command] = []
        still_waiting: List[PendingCommand] = []
        for pending in self.pending:
            if self.clock.since(pending.computed_at) < CONSOLIDATION_TTL:
                still_waiting.append(pending)
                continue
            err = validate_command(self.ctx, pending.method, pending.command)
            if err is not None:
                # invalidated: drop; the next poll recomputes from fresh state
                m.DISRUPTION_VALIDATION_FAILURES.inc(
                    {"reason": pending.method.reason}
                )
                if self.recorder is not None:
                    from karpenter_core_tpu_torch.events import Event

                    self.recorder.publish(Event(
                        involved_object="Deployment/karpenter",
                        type="Normal",
                        reason="DisruptionValidationFailed",
                        message=err,
                    ))
                continue
            self._execute(pending.command)
            executed.append(pending.command)
        self.pending = still_waiting
        return executed

    def _untaint_outdated(self) -> None:
        """Crash recovery (controller.go:127-141): nodes carrying the
        disruption taint that belong to no active command — a restarted
        operator has an empty in-flight list while the store still shows
        taints from interrupted commands — get untainted so they rejoin
        scheduling instead of staying cordoned forever."""
        active = {
            c.name
            for cmd in self.in_flight
            for c in cmd.command.candidates
        } | {c.name for p in self.pending for c in p.command.candidates}
        for node in self.kube.list_nodes():
            if node.name in active:
                continue
            if node.metadata.deletion_timestamp is not None:
                continue  # termination owns the taint during teardown
            kept = [
                t for t in node.taints
                if t.key != DISRUPTED_NO_SCHEDULE_TAINT.key
            ]
            if len(kept) != len(node.taints):
                node.taints = kept
                self.kube.update(node)

    # -- execution (controller.go:203-247) ---------------------------------

    def _execute(self, command: Command) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        m.DISRUPTION_DECISIONS.inc(
            {"decision": command.decision, "reason": command.reason}
        )
        if self.recorder is not None:
            from karpenter_core_tpu_torch.events import Event

            self.recorder.publish(*[
                Event(
                    involved_object=f"Node/{c.name}",
                    type="Normal",
                    reason="DisruptionTerminating",
                    message=(
                        f"Disrupting node via {command.reason} "
                        f"({command.decision})"
                    ),
                )
                for c in command.candidates
            ])
        # taint + mark so the provisioner stops using the candidates
        for c in command.candidates:
            node = self.kube.get(Node, c.name)
            if node is None:
                continue
            if not any(
                t.key == DISRUPTED_NO_SCHEDULE_TAINT.key for t in node.taints
            ):
                node.taints.append(DISRUPTED_NO_SCHEDULE_TAINT)
                self.kube.update(node)
            c.state_node.marked_for_deletion = True

        replacement_names = []
        for claim in command.replacements:
            nc = claim.template.to_node_claim(
                claim.requirements, claim.instance_type_options, claim.requests
            )
            nc.metadata.finalizers.append(apilabels.TERMINATION_FINALIZER)
            self.kube.create(nc)
            replacement_names.append(nc.name)

        self.in_flight.append(
            InFlightCommand(
                command=command,
                replacement_names=replacement_names,
                created_at=self.clock.now(),
            )
        )

    # -- orchestration (orchestration/queue.go:163-249) --------------------

    def _reconcile_orchestration(self) -> None:
        remaining = []
        for cmd in self.in_flight:
            if self._finished(cmd):
                continue
            if self.clock.since(cmd.created_at) > COMMAND_TIMEOUT:
                self._rollback(cmd)
                continue
            remaining.append(cmd)
        self.in_flight = remaining

    def _finished(self, cmd: InFlightCommand) -> bool:
        # all replacements must be initialized before candidates die
        # (waitOrTerminate, orchestration/queue.go:221-249)
        for name in cmd.replacement_names:
            claim = self.kube.get(NodeClaim, name)
            if claim is None:
                # replacement failed (e.g. insufficient capacity): abort the
                # whole command and roll back (queue.go:181-209)
                self._rollback(cmd)
                return True
            if not claim.is_initialized():
                return False
        for c in cmd.command.candidates:
            node = self.kube.get(Node, c.name)
            if node is not None and node.metadata.deletion_timestamp is None:
                try:
                    self.kube.delete(node)
                except NotFoundError:
                    pass
        # command completes when every candidate node is gone
        return all(
            self.kube.get(Node, c.name) is None for c in cmd.command.candidates
        )

    def _rollback(self, cmd: InFlightCommand) -> None:
        for c in cmd.command.candidates:
            node = self.kube.get(Node, c.name)
            if node is not None and node.metadata.deletion_timestamp is None:
                node.taints = [
                    t
                    for t in node.taints
                    if t.key != DISRUPTED_NO_SCHEDULE_TAINT.key
                ]
                self.kube.update(node)
            c.state_node.marked_for_deletion = False
