"""Pod scheduling predicates (reference: pkg/utils/pod/scheduling.go)."""
from __future__ import annotations

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import POD_FAILED, POD_SUCCEEDED, Pod


def is_scheduled(pod: Pod) -> bool:
    return bool(pod.node_name)


def is_terminal(pod: Pod) -> bool:
    return pod.phase in (POD_SUCCEEDED, POD_FAILED)


def is_terminating(pod: Pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_provisionable(pod: Pod) -> bool:
    """Pending, unscheduled, ungated, non-mirror (scheduling.go IsProvisionable)."""
    return (
        not is_scheduled(pod)
        and not is_terminal(pod)
        and not is_terminating(pod)
        and not pod.scheduling_gates
        and not pod.is_mirror
    )


def is_reschedulable(pod: Pod) -> bool:
    """Counts for rescheduling when its node is disrupted
    (scheduling.go IsReschedulable)."""
    return (
        not is_terminal(pod)
        and not is_terminating(pod)
        and not pod.is_daemonset
        and not pod.is_mirror
    )


def is_evictable(pod: Pod) -> bool:
    return not is_terminal(pod) and not pod.is_mirror


def is_disruptable(pod: Pod) -> bool:
    """do-not-disrupt pods block voluntary disruption (scheduling.go)."""
    return (
        pod.metadata.annotations.get(apilabels.DO_NOT_DISRUPT_ANNOTATION_KEY)
        != "true"
    )
