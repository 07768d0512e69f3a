"""The provisioning reconciler: pending pods → scheduler solve → NodeClaims
(reference: pkg/controllers/provisioning/provisioner.go:74-516).

`schedule()` assembles exactly the inputs the reference does — ready
NodePools in weight order, per-pool instance types, the topology domain
universe, live-cluster SimNodes, daemonset overhead — and runs the selected
solver (`greedy` host FFD or the `tpu` device solver). `provision()` then
materializes NodeClaims (limits-checked, instance types truncated to the 60
cheapest) and returns the pod→target nomination map the binder consumes.

Port of ``karpenter_core_tpu/controllers/provisioning/provisioner.py``: the
`tpu` solver builds the port's ``DeviceScheduler`` (models/provisioner.py),
which takes its ``device`` and ``kernel_backend`` from
``device_scheduler_opts``; with a ``solver_client`` the solve crosses the
solverd sidecar's RPC seam (solver/remote.RemoteScheduler) instead. A profiled solve writes a
``torch.profiler`` trace where the reference writes a ``jax.profiler`` one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodepool import NodePool
from karpenter_core_tpu_torch.api.objects import Pod
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
    Results,
    Scheduler,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
    Topology,
    domain_universe,
)
from karpenter_core_tpu_torch.utils import pod as podutil
from karpenter_core_tpu_torch.utils import resources as resutil

# how long an existing node stays disruption-protected after pods were
# nominated onto it (statenode nomination TTL; the reference's
# NominationWindow is batch-window-scaled — long enough for the binder's
# conflict-retry loop, short enough not to park consolidation)
NOMINATION_WINDOW = 30.0


class Provisioner:
    def __init__(
        self,
        kube,
        cluster,
        cloud_provider,
        clock,
        solver: str = "greedy",
        device_scheduler_opts: Optional[dict] = None,
        recorder=None,
        solver_client=None,
        unavailable_offerings=None,
        verify_results: bool = True,
        nominated_pods=None,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.solver = solver
        self.device_scheduler_opts = device_scheduler_opts or {}
        self.recorder = recorder
        # ICE cache (cloudprovider/unavailableofferings.py) shared with the
        # lifecycle controller: every scheduler this provisioner builds —
        # greedy, device, remote, and the disruption simulations routed
        # through new_scheduler — excludes the cached offerings
        self.unavailable_offerings = unavailable_offerings
        # non-None routes tpu solves (and the consolidation sweep) through
        # the solverd sidecar via solver/remote.py; the client owns the
        # circuit breaker, so it outlives individual schedulers
        self.solver_client = solver_client
        # host-side verification of every device/sidecar result
        # (solver/verify.py) before the reconcilers act on it; a rejected
        # result degrades that solve to greedy and emits a Warning event
        self.verify_results = verify_results
        # host+device profiling hook (reference pprof, operator.go:159-175):
        # set by the operator from --profile-solves / --profile-dir
        self.profile_solves = 0
        self.profile_dir = ""
        self._profiled = 0
        # live-nomination view (the operator's binder ledger):
        # {pod key -> target claim/node} for pods already promised
        # capacity whose bind has not landed yet. Two obligations follow
        # (both found by the digital twin's fuzzer under bind-conflict +
        # launch-fault chaos, as capacity overcommits): (1) nominated
        # pods must NOT re-enter the solve — re-placing one double-books
        # the capacity its pending bind is about to take; (2) the solve's
        # existing-node availability must SUBTRACT nominated-but-unbound
        # pods, or other pods get packed into capacity a pending bind
        # already owns. The reference prevents both with cluster-state
        # pod nominations (scheduler.go Reserve + nomination TTLs).
        self._nominated_pods = nominated_pods or (lambda: {})

    # -- input assembly ----------------------------------------------------

    def pending_pods(self) -> List[Pod]:
        nominated = self._nominated_pods()
        return [
            p
            for p in self.kube.list_pods()
            if podutil.is_provisionable(p) and p.key() not in nominated
        ]

    def deleting_node_pods(self) -> List[Pod]:
        """Reschedulable pods on deleting nodes re-enter the solve
        (provisioner.go:159-177)."""
        out = []
        for sn in self.cluster.nodes():
            if not (sn.deleting() or sn.marked_for_deletion):
                continue
            for p in self.cluster.pods_on_node(sn.name):
                if podutil.is_reschedulable(p):
                    out.append(p)
        return out

    def ready_nodepools(self) -> List[NodePool]:
        """Non-deleting pools whose validation/nodeclass conditions aren't
        False, weight-ordered (provisioner.go:215-234)."""
        from karpenter_core_tpu_torch.api.nodepool import (
            COND_NODEPOOL_NODECLASS_READY,
            COND_NODEPOOL_VALIDATION_SUCCEEDED,
        )

        pools = [
            np
            for np in self.kube.list_nodepools()
            if np.metadata.deletion_timestamp is None
            and not np.conditions.is_false(COND_NODEPOOL_VALIDATION_SUCCEEDED)
            and not np.conditions.is_false(COND_NODEPOOL_NODECLASS_READY)
        ]
        pools.sort(key=lambda n: (-n.spec.weight, n.name))
        return pools

    def daemonset_pods(self) -> List[Pod]:
        out = []
        for ds in self.kube.list_daemonsets():
            if ds.pod_template is not None:
                p = ds.pod_template
                p.is_daemonset = True
                out.append(p)
        return out

    def _profiled_solve(self, scheduler, pods):
        """cProfile the host path + capture a torch.profiler trace of the
        device path for one solve (the pprof/xprof stand-in)."""
        import cProfile
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.profile_dir or ".", exist_ok=True)
        n = self._profiled
        self._profiled += 1
        prof = cProfile.Profile()
        trace_path = os.path.join(self.profile_dir, f"solve-{n}-torch.json")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        trace = profile(activities=activities)
        try:
            trace.start()
            traced = True
        except Exception:
            traced = False
        prof.enable()
        try:
            return scheduler.solve(pods)
        finally:
            prof.disable()
            if traced:
                trace.stop()
                trace.export_chrome_trace(trace_path)
            prof.dump_stats(
                os.path.join(self.profile_dir, f"solve-{n}.pprof")
            )

    # -- the solve ---------------------------------------------------------

    def new_scheduler(self, pods: List[Pod], excluded_nodes=frozenset()):
        """Scheduler over the live cluster minus ``excluded_nodes`` — the
        shared assembly for the real solve and the disruption simulation
        (helpers.go:49-113 builds its sim the same way)."""
        nodepools = self.ready_nodepools()
        instance_types = {
            np.name: self.cloud_provider.get_instance_types(np)
            for np in nodepools
        }
        sim_nodes = [
            n
            for n in self.cluster.sim_nodes()
            if n.name not in excluded_nodes
        ]
        self._attach_volume_state(sim_nodes)
        self._reserve_nominated(sim_nodes)
        topology = Topology(
            domains=domain_universe(nodepools, instance_types, sim_nodes),
            existing_pods=[
                t
                for t in self.cluster.existing_pod_triples()
                if t[2] not in excluded_nodes
            ],
            excluded_pod_uids={p.uid for p in pods},
        )
        unavail = (
            self.unavailable_offerings.snapshot()
            if self.unavailable_offerings is not None
            else frozenset()
        )
        common = dict(
            nodepools=nodepools,
            instance_types=instance_types,
            existing_nodes=sim_nodes,
            daemonset_pods=self.daemonset_pods(),
            unavailable_offerings=unavail,
        )
        if self.solver == "tpu":
            if self.solver_client is not None:
                from karpenter_core_tpu_torch.solver.remote import RemoteScheduler

                return RemoteScheduler(
                    self.solver_client,
                    topology=topology,
                    device_scheduler_opts=self.device_scheduler_opts,
                    verify=self.verify_results,
                    recorder=self.recorder,
                    **common,
                )
            from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

            return DeviceScheduler(
                topology=topology, verify=self.verify_results,
                recorder=self.recorder,
                **common, **self.device_scheduler_opts,
            )
        return Scheduler(topology=topology, **common)

    def schedule(self) -> Tuple[Results, List[Pod]]:
        from karpenter_core_tpu_torch.metrics import wiring as m

        pods = self.pending_pods() + self.deleting_node_pods()
        if not pods:
            return Results([], [], {}), []
        pods, volume_errors = self._prepare_volumes(pods)
        m.QUEUE_DEPTH.set(len(pods))
        m.IGNORED_PODS.set(len(volume_errors))
        if not pods:
            return Results([], [], volume_errors), []
        scheduler = self.new_scheduler(pods)
        with m.SCHEDULING_DURATION.time():
            if self._profiled < self.profile_solves:
                results = self._profiled_solve(scheduler, pods)
            else:
                results = scheduler.solve(pods)
        results.pod_errors.update(volume_errors)
        m.UNSCHEDULABLE_PODS.set(len(results.pod_errors))
        if self.recorder is not None and results.pod_errors:
            from karpenter_core_tpu_torch.events import Event

            by_uid = {p.uid: p for p in pods}
            self.recorder.publish(*[
                Event(
                    involved_object=f"Pod/{by_uid[uid].key()}",
                    type="Warning",
                    reason="FailedScheduling",
                    message=msg,
                )
                for uid, msg in results.pod_errors.items()
                if uid in by_uid
            ])
        return results, pods

    # -- volume preprocessing (volumetopology.go inject+validate,
    # provisioner.go:436-516) ---------------------------------------------

    def _prepare_volumes(self, pods: List[Pod]):
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.volumetopology import (
            VolumeTopology,
        )
        from karpenter_core_tpu_torch.scheduling.volumeusage import get_volumes

        vt = VolumeTopology(self.kube)
        keep: List[Pod] = []
        errors: Dict[str, str] = {}
        for p in pods:
            if not p.volumes:
                keep.append(p)
                continue
            err = vt.validate_pvcs(p)
            if err is not None:
                errors[p.uid] = err
                continue
            vt.inject(p)
            p.resolved_volumes = get_volumes(self.kube, p) or None
            keep.append(p)
        return keep, errors

    def _reserve_nominated(self, sim_nodes) -> None:
        """Subtract nominated-but-unbound pods from their target node's
        availability: capacity a pending bind owns is not free. Pods
        nominated to an UNREGISTERED claim have no sim node yet and need
        no reservation — the claim's capacity only becomes a solve
        target after registration, and the binder lands (or prunes) the
        nominations earlier in that same pass."""
        nominated = self._nominated_pods()
        if not nominated:
            return
        pending_by_node: Dict[str, List[Pod]] = {}
        for key in sorted(nominated):
            ns, _, name = key.partition("/")
            pod = self.kube.get(Pod, name, ns)
            if pod is None or pod.node_name:
                continue  # gone, or the bind already landed
            pending_by_node.setdefault(nominated[key], []).append(pod)
        for sim in sim_nodes:
            pending = pending_by_node.get(sim.name)
            if not pending:
                continue
            # requests_for_pods already folds in the implicit 'pods'
            # count resource, so ONE subtract covers cpu/memory/slots
            sim.available = resutil.subtract(
                sim.available, resutil.requests_for_pods(*pending)
            )

    def _attach_volume_state(self, sim_nodes) -> None:
        """Per-node CSINode limits + bound pods' volume usage
        (statenode volume tracking, volumeusage.go Add/AddLimit)."""
        from karpenter_core_tpu_torch.api.objects import CSINode
        from karpenter_core_tpu_torch.scheduling.volumeusage import (
            VolumeUsage,
            get_volumes,
        )

        for sn in sim_nodes:
            csinode = self.kube.get(CSINode, sn.name)
            if csinode is None:
                continue
            usage = VolumeUsage()
            for driver, allocatable in csinode.drivers:
                usage.add_limit(driver, allocatable)
            for p in self.cluster.pods_on_node(sn.name):
                if p.resolved_volumes is None and p.volumes:
                    # stamp once; volumes are immutable between binds
                    p.resolved_volumes = get_volumes(self.kube, p) or {}
                if p.resolved_volumes:
                    usage.add(p.resolved_volumes)
            sn.volume_usage = usage

    # -- output: NodeClaims + nominations ----------------------------------

    def provision(self) -> Dict[str, str]:
        """One reconcile: solve and create NodeClaims. Returns nominations:
        pod key → existing node name or new NodeClaim name."""
        results, _ = self.schedule()
        nominations: Dict[str, str] = {}

        # eviction claims FIRST (drain-before-bind, gangsched):
        # preempted placements assume the victims' freed capacity, so the
        # victims are evicted before their nodes are nominated — the
        # binder's capacity view converges as the drains complete
        self._execute_evictions(results)

        for sim in results.existing_nodes:
            for p in sim.pods:
                nominations[p.key()] = sim.name
            if sim.pods:
                # protect the node from disruption while the binds land
                # (StateNode.nominated gates candidacy, disruption/types
                # .py; the reference's NominateNodeEvent + TTL — this was
                # the dormant half of that contract)
                self.cluster.nominate_node(
                    sim.name, self.clock.now() + NOMINATION_WINDOW
                )
        if self.recorder is not None and nominations:
            from karpenter_core_tpu_torch.events import Event

            self.recorder.publish(*[
                Event(
                    involved_object=f"Pod/{key}",
                    type="Normal",
                    reason="Nominated",
                    message=f"Pod should schedule on {target}",
                )
                for key, target in nominations.items()
            ])

        usage_by_pool = self._usage_by_nodepool()
        pools = {np.name: np for np in self.kube.list_nodepools()}
        for claim in results.new_node_claims:
            pool = pools.get(claim.template.nodepool_name)
            if pool is not None and pool.spec.limits:
                # pessimistic max-capacity check (provisioner.go:354-392)
                max_cap = resutil.cmp_max(
                    *(it.capacity for it in claim.instance_type_options)
                )
                usage = usage_by_pool.get(pool.name, {})
                projected = resutil.merge(usage, max_cap)
                errs = pool.spec.limits.exceeded_by(projected)
                if errs:
                    # pods stay pending, but VISIBLY (the greedy solve
                    # reports limit failures in-solve; the device solve
                    # reports them here at claim-creation time). The counter
                    # makes near-limit solve→drop→re-solve churn observable.
                    from karpenter_core_tpu_torch.metrics import wiring as m

                    m.SOLVER_LIMIT_DROPPED_CLAIMS.inc(
                        {"nodepool": pool.name}
                    )
                    if self.recorder is not None:
                        from karpenter_core_tpu_torch.events import Event

                        self.recorder.publish(*[
                            Event(
                                involved_object=f"Pod/{p.key()}",
                                type="Warning",
                                reason="FailedScheduling",
                                message=(
                                    f"nodepool {pool.name!r} limit "
                                    f"exceeded: {'; '.join(errs)}"
                                ),
                            )
                            for p in claim.pods
                        ])
                    continue  # skip launch
                usage_by_pool[pool.name] = projected
            nc = claim.template.to_node_claim(
                claim.requirements, claim.instance_type_options, claim.requests
            )
            nc.metadata.finalizers.append(apilabels.TERMINATION_FINALIZER)
            self.kube.create(nc)
            for p in claim.pods:
                nominations[p.key()] = nc.name
        return nominations

    def _execute_evictions(self, results: Results) -> None:
        """Turn verified eviction claims into API evictions. Claims were
        verified legal by solver/verify.py (every victim strictly lower
        tier than a pod its capacity admitted) before the result reached
        this reconciler; a victim that vanished since the snapshot is a
        no-op (its capacity is already free)."""
        evictions = getattr(results, "evictions", None)
        if not evictions:
            return
        from karpenter_core_tpu_torch.metrics import wiring as m

        for node_name, uids in sorted(evictions.items()):
            # claims name the victim's node: resolve uids against THAT
            # node's bound pods only, not a cluster-wide scan
            by_uid = {
                p.uid: p for p in self.cluster.pods_on_node(node_name)
            }
            for uid in uids:
                victim = by_uid.get(uid)
                if victim is None:
                    continue
                self.kube.evict(victim)
                m.SOLVER_PREEMPTION_EVICTIONS.inc()
                if self.recorder is not None:
                    from karpenter_core_tpu_torch.events import Event

                    self.recorder.publish(Event(
                        involved_object=f"Pod/{victim.key()}",
                        type="Normal",
                        reason="Preempted",
                        message=(
                            f"evicted from {node_name} to admit a"
                            " higher-priority pod (drain-before-bind)"
                        ),
                    ))

    def _usage_by_nodepool(self) -> Dict[str, dict]:
        """In-use capacity per pool (the nodepool.counter aggregation,
        reference pkg/controllers/nodepool/counter)."""
        usage: Dict[str, dict] = {}
        for sn in self.cluster.nodes():
            pool = sn.nodepool_name
            if pool:
                usage[pool] = resutil.merge(usage.get(pool, {}), sn.capacity())
        return usage
