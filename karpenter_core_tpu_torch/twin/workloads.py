"""Tesserae-shaped workload generators for the twin.

Three workload classes, one per wave kind (twin/scenario.WorkloadWave):

* ``training`` — gang-annotated pods (solver/gangs.py pod-group contract,
  min-size = gang size: all-or-nothing) at the wave's priority tier, the
  distributed-training shape whose atomicity the invariant monitor pins;
* ``serving``  — replica pods behind a PodDisruptionBudget
  (min_available), the latency-SLO class whose time-to-bind percentiles
  the ledger reports and whose eviction budget the monitor enforces;
* ``batch``    — preemptible filler (the wave's priority, typically <= 0),
  the class preemption legitimately evicts.

Pod names, labels and sizes are pure functions of (wave index, pod index,
per-wave child RNG) — construction order never leaks into identity, so
two runs of one scenario create byte-identical workloads. Every pod
carries an owner reference (the ReplicaSet stand-in) so eviction returns
it to Pending instead of deleting it.
"""
from __future__ import annotations

import random
from typing import Dict, List, Tuple

from karpenter_core_tpu_torch.api.objects import (
    LabelSelector,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodDisruptionBudget,
)
from karpenter_core_tpu_torch.chaos import fold_seed
from karpenter_core_tpu_torch.solver.gangs import (
    GANG_ANNOTATION,
    GANG_MAX_HOPS_ANNOTATION,
    GANG_MIN_SIZE_ANNOTATION,
    GANG_RANK_ANNOTATION,
)
from karpenter_core_tpu_torch.twin.scenario import WorkloadWave

GIB = 2.0**30

# the workload class riding every twin pod (the ledger's SLO dimension)
CLASS_LABEL = "twin.karpenter.sh/workload-class"
WAVE_LABEL = "twin.karpenter.sh/wave"

# cpu jitter factors drawn per pod: mixed sizes pack differently than a
# monoculture, which is what makes the bin-packing honest
_SIZE_FACTORS = (0.5, 1.0, 1.0, 2.0)


def _pod(
    name: str,
    wave_id: str,
    cls: str,
    cpu: float,
    memory_gib: float,
    labels: Dict[str, str],
    annotations: Dict[str, str],
    priority: int,
) -> Pod:
    meta = ObjectMeta(name=name)
    meta.labels = {CLASS_LABEL: cls, WAVE_LABEL: wave_id, **labels}
    meta.annotations = dict(annotations)
    meta.owner_references = [
        OwnerReference(kind="ReplicaSet", name=f"rs-{wave_id}", uid=wave_id)
    ]
    return Pod(
        metadata=meta,
        resource_requests={"cpu": cpu, "memory": memory_gib * GIB},
        priority=priority,
    )


def pods_for_wave(
    wave: WorkloadWave, wave_id: str, seed: int
) -> Tuple[List[Pod], List[PodDisruptionBudget]]:
    """Materialize one wave: (pods, pdbs). ``wave_id`` is the wave's
    CONTENT-derived identity (scenario.wave_ids) — pod names and the
    folded child RNG stream key off it, never off tuple position, so
    dropping or reordering sibling waves (the shrinker, a hand-edited
    fixture) re-rolls nothing here."""
    rng = random.Random(fold_seed(seed, f"wave/{wave_id}"))
    pods: List[Pod] = []
    pdbs: List[PodDisruptionBudget] = []
    if wave.kind == "training":
        # validate_scenario pins count to a positive gang_size multiple
        for g in range(wave.count // wave.gang_size):
            gang_name = f"{wave_id}-g{g}"
            for i in range(wave.gang_size):
                annotations = {
                    GANG_ANNOTATION: gang_name,
                    GANG_MIN_SIZE_ANNOTATION: str(wave.gang_size),
                }
                if wave.max_hops >= 0:
                    # comms-sensitive gang (topoaware, ISSUE 20): a hard
                    # network-hop bound plus per-member collective rank,
                    # so the solver must place the gang rank-adjacent
                    # within the bound and the invariant monitor can
                    # re-derive both from annotations + node labels
                    annotations[GANG_MAX_HOPS_ANNOTATION] = str(
                        wave.max_hops
                    )
                    annotations[GANG_RANK_ANNOTATION] = str(i)
                pods.append(_pod(
                    name=f"{gang_name}-{i}",
                    wave_id=wave_id,
                    cls="training",
                    cpu=wave.cpu,
                    memory_gib=wave.memory_gib,
                    labels={"app": gang_name},
                    annotations=annotations,
                    priority=wave.priority,
                ))
    elif wave.kind == "serving":
        app = f"svc-{wave_id}"
        for i in range(wave.count):
            pods.append(_pod(
                name=f"{wave_id}-{i}",
                wave_id=wave_id,
                cls="serving",
                cpu=wave.cpu * rng.choice(_SIZE_FACTORS),
                memory_gib=wave.memory_gib,
                labels={"app": app},
                annotations={},
                priority=wave.priority,
            ))
        if wave.min_available > 0:
            pdb = PodDisruptionBudget(
                metadata=ObjectMeta(name=f"pdb-{wave_id}"),
                selector=LabelSelector(match_labels=(("app", app),)),
                min_available=wave.min_available,
            )
            pdbs.append(pdb)
    elif wave.kind == "batch":
        for i in range(wave.count):
            pods.append(_pod(
                name=f"{wave_id}-{i}",
                wave_id=wave_id,
                cls="batch",
                cpu=wave.cpu * rng.choice(_SIZE_FACTORS),
                memory_gib=wave.memory_gib,
                labels={"app": f"batch-{wave_id}"},
                annotations={},
                priority=wave.priority,
            ))
    else:
        raise ValueError(f"unknown wave kind {wave.kind!r}")
    return pods, pdbs


def gang_of(pod: Pod) -> str:
    return pod.metadata.annotations.get(GANG_ANNOTATION, "")


def gang_min_size(pod: Pod) -> int:
    raw = pod.metadata.annotations.get(GANG_MIN_SIZE_ANNOTATION, "0")
    try:
        return int(raw)
    except ValueError:
        return 0


def workload_class(pod: Pod) -> str:
    return pod.metadata.labels.get(CLASS_LABEL, "other")
