"""NodeClaim lifecycle: Launch → Registration → Initialization, plus
liveness TTL and finalizer-driven teardown
(reference: pkg/controllers/nodeclaim/lifecycle/{controller,launch,
registration,initialization,liveness}.go).
"""
from __future__ import annotations

from typing import Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import (
    COND_INITIALIZED,
    COND_INSTANCE_TERMINATING,
    COND_LAUNCHED,
    COND_REGISTERED,
    NodeClaim,
)
from karpenter_core_tpu_torch.api.objects import Node
from karpenter_core_tpu_torch.cloudprovider.types import (
    CloudProviderError,
    CreateError,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    NodeClassNotReadyError,
)
from karpenter_core_tpu_torch.scheduling import Requirements
from karpenter_core_tpu_torch.scheduling.taints import UNREGISTERED_NO_EXECUTE_TAINT

REGISTRATION_TTL = 15 * 60.0  # liveness.go:41


class NodeClaimLifecycle:
    def __init__(
        self,
        kube,
        cluster,
        cloud_provider,
        clock,
        unavailable_offerings=None,
        recorder=None,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        # ICE cache the launch path populates from typed error context; the
        # provisioner's solve paths consume it (cloudprovider/
        # unavailableofferings.py) — None keeps the pre-cache behavior
        self.unavailable_offerings = unavailable_offerings
        self.recorder = recorder

    def reconcile(self, claim: NodeClaim) -> None:
        if claim.metadata.deletion_timestamp is not None:
            self._finalize(claim)
            return
        if apilabels.TERMINATION_FINALIZER not in claim.metadata.finalizers:
            claim.metadata.finalizers.append(apilabels.TERMINATION_FINALIZER)
            self.kube.update(claim)
        # liveness backstop (liveness.go:41): a claim not Registered within
        # the TTL is reaped REGARDLESS of launch state — a permanently
        # failing launch (CreateError each pass) must not retry forever
        if not claim.is_registered() and self.clock.since(
            claim.metadata.creation_timestamp
        ) > REGISTRATION_TTL:
            self.kube.delete(claim)
            return
        if not claim.is_launched():
            self._launch(claim)
        if claim.is_launched() and not claim.is_registered():
            self._register(claim)
        if claim.is_registered() and not claim.is_initialized():
            self._initialize(claim)

    # -- launch (launch.go:45) --------------------------------------------

    def _launch(self, claim: NodeClaim) -> None:
        user_labels = dict(claim.metadata.labels)
        try:
            self.cloud_provider.create(claim)
        except InsufficientCapacityError as e:
            # terminal for this claim: mark the stocked-out offerings in the
            # ICE cache so the re-solve excludes them (both solve paths AND
            # the provider's own pick consume the cache), then delete so the
            # provisioner retries onto the next-cheapest AVAILABLE offering
            # (launch.go terminal-error path + the AWS ICE cache)
            self._record_insufficient_capacity(claim, e)
            self.kube.delete(claim)
            return
        except NodeClassNotReadyError:
            # terminal against a (possibly fixed) class; retried via re-solve
            self.kube.delete(claim)
            return
        except CreateError as e:
            # non-terminal: surface the provider's typed condition so the
            # failure is visible while retries continue (launch.go sets
            # Launched=False from the CreateError's reason/message)
            claim.conditions.set_false(
                COND_LAUNCHED,
                e.condition_reason or "LaunchFailed",
                message=e.condition_message or str(e),
                now=self.clock.now(),
            )
            self.kube.update(claim)
            return
        except CloudProviderError:
            return  # retried next reconcile
        # PopulateNodeClaimDetails (launch.go:122-133): provider-resolved
        # labels < single-value requirement labels < user-defined labels
        req_labels = Requirements.from_node_selector_requirements_with_min_values(
            claim.spec.requirements
        ).to_labels()
        claim.metadata.labels = {
            **claim.metadata.labels,
            **req_labels,
            **user_labels,
        }
        self.kube.update(claim)

    def _record_insufficient_capacity(
        self, claim: NodeClaim, err: InsufficientCapacityError
    ) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        keys = getattr(err, "offerings", ()) or ()
        if self.unavailable_offerings is not None:
            for key in keys:
                self.unavailable_offerings.mark(key)
        if keys:
            for key in keys:
                m.INSUFFICIENT_CAPACITY_ERRORS.inc({
                    "capacity_type": key.capacity_type, "zone": key.zone,
                })
        else:
            m.INSUFFICIENT_CAPACITY_ERRORS.inc(
                {"capacity_type": "", "zone": ""}
            )
        if self.recorder is not None:
            from karpenter_core_tpu_torch.events import Event

            self.recorder.publish(Event(
                involved_object=f"NodeClaim/{claim.name}",
                type="Warning",
                reason="InsufficientCapacity",
                message=str(err),
            ))

    # -- registration (registration.go:43) --------------------------------

    def _register(self, claim: NodeClaim) -> None:
        node = self.kube.get_node_by_provider_id(claim.status.provider_id)
        if node is None:
            return  # liveness reap lives in reconcile()'s TTL backstop
        node.taints = [
            t
            for t in node.taints
            if not (
                t.key == UNREGISTERED_NO_EXECUTE_TAINT.key
                and t.effect == UNREGISTERED_NO_EXECUTE_TAINT.effect
            )
        ]
        for taint in list(claim.spec.taints) + list(claim.spec.startup_taints):
            if not any(
                t.key == taint.key and t.effect == taint.effect
                for t in node.taints
            ):
                node.taints.append(taint)
        node.metadata.labels.update(claim.metadata.labels)
        node.metadata.labels[apilabels.NODE_REGISTERED_LABEL_KEY] = "true"
        if apilabels.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(apilabels.TERMINATION_FINALIZER)
        self.kube.update(node)
        claim.status.node_name = node.name
        claim.conditions.set_true(COND_REGISTERED, "Registered", now=self.clock.now())
        self.kube.update(claim)

    # -- initialization (initialization.go:47) -----------------------------

    def _initialize(self, claim: NodeClaim) -> None:
        node = self.kube.get(Node, claim.status.node_name)
        if node is None or not node.ready():
            return
        # startup taints must clear and registered resources must be present
        startup = list(claim.spec.startup_taints)
        if any(
            any(t.key == s.key and t.effect == s.effect for s in startup)
            for t in node.taints
        ):
            return
        if not node.status.allocatable:
            return
        node.metadata.labels[apilabels.NODE_INITIALIZED_LABEL_KEY] = "true"
        self.kube.update(node)
        claim.conditions.set_true(COND_INITIALIZED, "Initialized", now=self.clock.now())
        self.kube.update(claim)

    # -- teardown (lifecycle/controller.go:111-285) ------------------------

    def _finalize(self, claim: NodeClaim) -> None:
        if apilabels.TERMINATION_FINALIZER not in claim.metadata.finalizers:
            return
        # no instance to delete when none was ever created — keyed on
        # provider_id, NOT the Launched condition: a provider can create
        # the instance and record its id, then fail before the condition
        # lands (lifecycle/controller.go keys the skip on an empty
        # ProviderID; gc.py's leak sweep uses the same signal)
        if claim.status.provider_id:
            try:
                self.cloud_provider.delete(claim)
            except NodeClaimNotFoundError:
                pass  # instance already gone
        claim.conditions.set_true(COND_INSTANCE_TERMINATING, "Terminating", now=self.clock.now())
        claim.metadata.finalizers.remove(apilabels.TERMINATION_FINALIZER)
        self.kube.update(claim)
