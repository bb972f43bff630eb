"""The reference scheduler_perf workloads the port runs (a subset of the
JAX package's perf/workloads.py, same templates and sizes).

Node template (node-default.yaml): cpu 4, memory 32Gi, pods 110.
Pod template (pod-default.yaml): requests cpu 100m, memory 500Mi.
The gang workloads (MultiTenantGangStorm, QuotaExhaustionChurn,
GangPreemption, GangTopologyPacking) and the four DRA drains
(DRASteadyState, ...ClaimTemplates, ...CELIn, DRAMultiRequest) are the
JAX package's own, copied with their sizes and floors.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.objects import (
    LABEL_HOSTNAME,
    LABEL_POD_GROUP,
    LABEL_QUEUE,
    LABEL_ZONE,
    Affinity,
    Container,
    LabelSelector,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodGroup,
    PodSpec,
    ResourceRequirements,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from kubernetes_tpu_torch.perf.harness import (
    Churn,
    CreateNamespaces,
    CreateNodes,
    CreateObjects,
    CreatePods,
    Workload,
)


def _node(i: int, zones: list[str] | None = None) -> Node:
    """node-default.yaml + labelNodePrepareStrategy zone labels."""
    name = f"node-{i}"
    labels = {LABEL_HOSTNAME: name}
    if zones:
        labels[LABEL_ZONE] = zones[i % len(zones)]
    return Node(
        metadata=ObjectMeta(name=name, labels=labels),
        spec=NodeSpec(),
        status=NodeStatus(allocatable={
            "cpu": "4", "memory": "32Gi", "pods": "110"}))


def _pod(name: str, cpu: str = "100m", mem: str = "500Mi",
         namespace: str = "default", labels: dict | None = None,
         affinity: Affinity | None = None, tsc: list | None = None,
         priority: int | None = None) -> Pod:
    # cpu/mem "0" = a request-less pod (fit consumes only a pod slot;
    # scoring sees the NonZeroRequested defaults)
    requests = {}
    if cpu != "0":
        requests["cpu"] = cpu
    if mem != "0":
        requests["memory"] = mem
    return Pod(
        metadata=ObjectMeta(name=name, namespace=namespace,
                            labels=labels or {}),
        spec=PodSpec(
            containers=[Container(
                name="pause",
                resources=ResourceRequirements(requests=requests))],
            affinity=affinity,
            topology_spread_constraints=tsc or [],
            priority=priority))


# ------------------------------------------------- 1. SchedulingBasic
# misc/performance-config.yaml:40-66 (5000Nodes_10000Pods, threshold 270)

def scheduling_basic(init_nodes=5000, init_pods=1000,
                     measure_pods=10000) -> Workload:
    return Workload(
        name="SchedulingBasic/5000Nodes_10000Pods",
        threshold=270,
        batch_size=4096,   # auction path: bigger launches amortize better
        ops=[
            CreateNodes(init_nodes, _node),
            CreatePods(init_pods, lambda i: _pod(f"init-{i}")),
            CreatePods(measure_pods, lambda i: _pod(f"measure-{i}"),
                       collect_metrics=True),
        ])


# --------------------------------------- 3. SchedulingPodAntiAffinity
# affinity/performance-config.yaml:20-70 (5000Nodes_2000Pods, 60):
# 2 namespaces; pods labeled color=green with required hostname
# anti-affinity across both namespaces
# (pod-with-pod-anti-affinity.yaml).

def _anti_affinity_pod(i: int, ns: str) -> Pod:
    aff = Affinity(pod_anti_affinity=PodAntiAffinity(required=[
        PodAffinityTerm(
            topology_key=LABEL_HOSTNAME,
            label_selector=LabelSelector(match_labels={"color": "green"}),
            namespaces=["sched-1", "sched-0"])]))
    return _pod(f"anti-{ns}-{i}", namespace=ns,
                labels={"color": "green"}, affinity=aff)


def scheduling_pod_anti_affinity(init_nodes=5000, init_pods=1000,
                                 measure_pods=2000) -> Workload:
    return Workload(
        name="SchedulingPodAntiAffinity/5000Nodes_2000Pods",
        threshold=60,
        warm_full_nodes=True,   # hostname anti-affinity: domains = nodes
        ops=[
            CreateNodes(init_nodes, _node),
            CreateNamespaces("sched", 2),
            CreatePods(init_pods,
                       lambda i: _anti_affinity_pod(i, "sched-0")),
            CreatePods(measure_pods,
                       lambda i: _anti_affinity_pod(i, "sched-1"),
                       collect_metrics=True),
        ])


# ------------------------------------------- 4. TopologySpreading
# topology_spreading/performance-config.yaml:21-70 (5000Nodes_5000Pods,
# 85): nodes across 3 zones; measured pods spread maxSkew=5 on zone
# (pod-with-topology-spreading.yaml).

def _spreading_pod(i: int) -> Pod:
    tsc = [TopologySpreadConstraint(
        max_skew=5, topology_key=LABEL_ZONE,
        when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels={"color": "blue"}))]
    return _pod(f"spread-{i}", labels={"color": "blue"}, tsc=tsc)


def topology_spreading(init_nodes=5000, init_pods=5000,
                       measure_pods=5000) -> Workload:
    return Workload(
        name="TopologySpreading/5000Nodes_5000Pods",
        threshold=85,
        pod_capacity=32768,
        ops=[
            CreateNodes(init_nodes, lambda i: _node(
                i, zones=["moon-1", "moon-2", "moon-3"])),
            CreatePods(init_pods, lambda i: _pod(f"init-{i}")),
            CreatePods(measure_pods, _spreading_pod, collect_metrics=True),
        ])


# -------------------------------------- 14. SchedulingPodAffinity
# affinity/performance-config.yaml:83-148 (5000Nodes_5000Pods, 35): every
# node in ONE zone; init and measured pods carry required zone-level
# podAffinity on color=blue across namespaces sched-0/sched-1
# (pod-with-pod-affinity.yaml), so every placement updates the single
# shared affinity domain.

def _pod_affinity_pod(i: int, ns: str) -> Pod:
    aff = Affinity(pod_affinity=PodAffinity(required=[
        PodAffinityTerm(
            topology_key=LABEL_ZONE,
            label_selector=LabelSelector(match_labels={"color": "blue"}),
            namespaces=["sched-1", "sched-0"])]))
    return _pod(f"aff-{ns}-{i}", namespace=ns, labels={"color": "blue"},
                affinity=aff)


def scheduling_pod_affinity(init_nodes=5000, init_pods=5000,
                            measure_pods=5000) -> Workload:
    return Workload(
        name="SchedulingPodAffinity/5000Nodes_5000Pods",
        threshold=35,
        pod_capacity=32768,
        ops=[
            CreateNodes(init_nodes, lambda i: _node(i, zones=["zone1"])),
            CreateNamespaces("sched", 2),
            CreatePods(init_pods,
                       lambda i: _pod_affinity_pod(i, "sched-0")),
            CreatePods(measure_pods,
                       lambda i: _pod_affinity_pod(i, "sched-1"),
                       collect_metrics=True),
        ])


# -------------------------------- 10/11. Preferred pod (anti)affinity
# affinity/performance-config.yaml:141-198 / :204-261
# (SchedulingPreferredPodAffinity / ...AntiAffinity, 5000Nodes_5000Pods,
# both 90): soft zone-level terms, pure Score work — a soft-only topology
# batch (the soft-score auction on the card).

def _preferred_affinity_pod(i: int, anti: bool) -> Pod:
    term = WeightedPodAffinityTerm(weight=10, pod_affinity_term=(
        PodAffinityTerm(
            topology_key=LABEL_ZONE,
            label_selector=LabelSelector(match_labels={"team": "perf"}))))
    aff = (Affinity(pod_anti_affinity=PodAntiAffinity(preferred=[term]))
           if anti else
           Affinity(pod_affinity=PodAffinity(preferred=[term])))
    kind = "panti" if anti else "paff"
    return _pod(f"{kind}-{i}", labels={"team": "perf"}, affinity=aff)


def preferred_pod_affinity(init_nodes=5000, init_pods=1000,
                           measure_pods=5000) -> Workload:
    return Workload(
        name="SchedulingPreferredPodAffinity/5000Nodes_5000Pods",
        threshold=90,
        pod_capacity=32768,
        ops=[
            CreateNodes(init_nodes,
                        lambda i: _node(i, zones=["z1", "z2", "z3"])),
            CreatePods(init_pods, lambda i: _pod(f"init-{i}")),
            CreatePods(measure_pods,
                       lambda i: _preferred_affinity_pod(i, anti=False),
                       collect_metrics=True),
        ])


def preferred_pod_anti_affinity(init_nodes=5000, init_pods=1000,
                                measure_pods=5000) -> Workload:
    return Workload(
        name="SchedulingPreferredPodAntiAffinity/5000Nodes_5000Pods",
        threshold=90,
        pod_capacity=32768,
        ops=[
            CreateNodes(init_nodes,
                        lambda i: _node(i, zones=["z1", "z2", "z3"])),
            CreatePods(init_pods, lambda i: _pod(f"init-{i}")),
            CreatePods(measure_pods,
                       lambda i: _preferred_affinity_pod(i, anti=True),
                       collect_metrics=True),
        ])


# ------------------------------------------ 13. MixedSchedulingBasePod
# affinity/performance-config.yaml:338-418 (5000Nodes_5000Pods, 140):
# one zone; 2000 init pods of EACH of five templates — plain, required
# zone affinity (blue), required hostname anti-affinity (green),
# preferred hostname affinity (red), preferred hostname anti-affinity
# (yellow) — then 5000 plain measured pods scored against that mixture.
# The init batches carry required terms (the serial scan); the measured
# batches carry none, but the table does: soft-only launches at hostname
# width (the soft-score auction on the card).

def _mixed_init_pod(i: int) -> Pod:
    kind = i % 5
    j = i // 5
    if kind == 0:
        return _pod(f"mix-plain-{j}", namespace="sched-0")
    if kind == 1:
        aff = Affinity(pod_affinity=PodAffinity(required=[
            PodAffinityTerm(
                topology_key=LABEL_ZONE,
                label_selector=LabelSelector(
                    match_labels={"color": "blue"}),
                namespaces=["sched-1", "sched-0"])]))
        return _pod(f"mix-aff-{j}", namespace="sched-0",
                    labels={"color": "blue"}, affinity=aff)
    if kind == 2:
        aff = Affinity(pod_anti_affinity=PodAntiAffinity(required=[
            PodAffinityTerm(
                topology_key=LABEL_HOSTNAME,
                label_selector=LabelSelector(
                    match_labels={"color": "green"}),
                namespaces=["sched-1", "sched-0"])]))
        return _pod(f"mix-anti-{j}", namespace="sched-0",
                    labels={"color": "green"}, affinity=aff)
    term = WeightedPodAffinityTerm(weight=1, pod_affinity_term=(
        PodAffinityTerm(
            topology_key=LABEL_HOSTNAME,
            label_selector=LabelSelector(match_labels={
                "color": "red" if kind == 3 else "yellow"}),
            namespaces=["sched-1", "sched-0"])))
    if kind == 3:
        aff = Affinity(pod_affinity=PodAffinity(preferred=[term]))
        return _pod(f"mix-paff-{j}", namespace="sched-0",
                    labels={"color": "red"}, affinity=aff)
    aff = Affinity(pod_anti_affinity=PodAntiAffinity(preferred=[term]))
    return _pod(f"mix-panti-{j}", namespace="sched-0",
                labels={"color": "yellow"}, affinity=aff)


def mixed_scheduling_base_pod(init_nodes=5000, init_pods_each=2000,
                              measure_pods=5000) -> Workload:
    return Workload(
        name="MixedSchedulingBasePod/5000Nodes_5000Pods",
        threshold=140,
        pod_capacity=32768,
        warm_full_nodes=True,   # hostname terms: domains = nodes
        ops=[
            CreateNodes(init_nodes, lambda i: _node(i, zones=["zone1"])),
            CreateNamespaces("sched", 1),
            CreatePods(init_pods_each * 5, _mixed_init_pod),
            CreatePods(measure_pods,
                       lambda i: _pod(f"measure-{i}", namespace="sched-0"),
                       collect_metrics=True),
        ])


# ------------------------------ 19. PreferredTopologySpreading
# topology_spreading/performance-config.yaml:83-145 (5000Nodes_5000Pods,
# 125): three zones; measured pods carry a maxSkew=5 ScheduleAnyway zone
# constraint (pod-with-preferred-topology-spreading.yaml) — the soft
# spread Score path rather than the DoNotSchedule Filter.

def _preferred_spreading_pod(i: int) -> Pod:
    return _pod(f"pspread-{i}", labels={"color": "blue"}, tsc=[
        TopologySpreadConstraint(
            max_skew=5, topology_key=LABEL_ZONE,
            when_unsatisfiable="ScheduleAnyway",
            label_selector=LabelSelector(match_labels={"color": "blue"}))])


def preferred_topology_spreading(init_nodes=5000, init_pods=5000,
                                 measure_pods=5000) -> Workload:
    return Workload(
        name="PreferredTopologySpreading/5000Nodes_5000Pods",
        threshold=125,
        pod_capacity=32768,
        ops=[
            CreateNodes(init_nodes, lambda i: _node(
                i, zones=["moon-1", "moon-2", "moon-3"])),
            CreatePods(init_pods, lambda i: _pod(f"init-{i}")),
            CreatePods(measure_pods, _preferred_spreading_pod,
                       collect_metrics=True),
        ])


# ------------------------------------------- 5. PreemptionAsync
# misc/performance-config.yaml:195-250 (5000Nodes, 160): 20k low-priority
# 900m fillers (4 per 4-CPU node), churn creating a 3000m priority-10 pod
# every 200ms (each must preempt 3 fillers), 5000 always-schedulable
# 100m measured pods.

def _low_priority_pod(i: int) -> Pod:
    return _pod(f"low-{i}", cpu="900m", mem="500Mi")


def _high_priority_pod(i: int) -> Pod:
    return _pod(f"high-{i}", cpu="3000m", mem="500Mi", priority=10)


def preemption_async(init_nodes=5000, init_pods=20000,
                     measure_pods=5000) -> Workload:
    return Workload(
        name="PreemptionAsync/5000Nodes",
        threshold=160,
        pod_capacity=32768,
        ops=[
            CreateNodes(init_nodes, _node),
            CreatePods(init_pods, _low_priority_pod),
            Churn([_high_priority_pod], interval_ms=200),
            CreatePods(measure_pods, lambda i: _pod(f"measure-{i}"),
                       collect_metrics=True),
        ])


# ------------------------------ 23. PreemptionAsync (async enabled)
# misc/performance-config.yaml:247 (160): the preemption shape with
# SchedulerAsyncPreemption pinned on — victims are evicted between
# cycles (kep 4832) instead of inside the failure handler.

def preemption_async_enabled(init_nodes=5000, init_pods=20000,
                             measure_pods=5000) -> Workload:
    w = preemption_async(init_nodes, init_pods, measure_pods)
    w.name = "PreemptionAsync/5000Nodes_AsyncPreemptionEnabled"
    w.feature_gates = {"SchedulerAsyncPreemption": True}
    return w


# ------------------------------------- 26-29. gang / multi-tenant
# The multi-tenant job-storm workload class the gang subsystem opens
# (Kant, PAPERS.md): PodGroups with mixed gang sizes 2-64 across weighted
# tenants, quota exhaustion that must not starve other tenants, and
# priority preemption of whole gangs. No scheduler_perf floors exist for
# these — the thresholds are the JAX package's own floors. All carry a
# ``rescale`` hook: op counts must stay gang-aligned, so the harness's
# uniform per-op warmup scaling would strand partial gangs behind
# min_member; the factory rebuilds the whole workload at the requested
# scale instead (capacities/batch stay identical, preserving jit shapes).

GANG_SIZES = (2, 4, 8, 16, 32, 64)


def _gang_member(name: str, gang: str, tenant: str, cpu: str = "100m",
                 priority: int | None = None) -> Pod:
    p = _pod(name, cpu=cpu, mem="200Mi", priority=priority)
    p.metadata.labels[LABEL_POD_GROUP] = gang
    p.metadata.labels[LABEL_QUEUE] = tenant
    return p


def _tenant_pod(name: str, tenant: str, cpu: str = "100m") -> Pod:
    p = _pod(name, cpu=cpu, mem="200Mi")
    p.metadata.labels[LABEL_QUEUE] = tenant
    return p


def multi_tenant_gang_storm(init_nodes=500,
                            gangs_per_tenant=24) -> Workload:
    """Two weighted tenants (2:1), mixed gang sizes 2-64: every gang
    admits whole through the DRR queue and commits through Permit; the
    artifact's per-tenant ``contended_admitted`` ratio is the fairness
    number (≈ the weight ratio while both tenants have backlog)."""
    plan = []        # (gang name, tenant, size)
    for tenant in ("tenant-a", "tenant-b"):
        for g in range(gangs_per_tenant):
            plan.append((f"{tenant}-job-{g}", tenant,
                         GANG_SIZES[g % len(GANG_SIZES)]))
    members = [(f"{gang}-m{m}", gang, tenant)
               for gang, tenant, size in plan for m in range(size)]

    def mkgroup(i: int) -> PodGroup:
        gang, tenant, size = plan[i]
        return PodGroup(metadata=ObjectMeta(name=gang),
                        min_member=size, queue=tenant,
                        schedule_timeout_seconds=120.0)

    def mkpod(i: int) -> Pod:
        name, gang, tenant = members[i]
        return _gang_member(name, gang, tenant)

    return Workload(
        name="MultiTenantGangStorm/500Nodes",
        threshold=25,
        node_capacity=512,     # tracks the 500-node cluster
        batch_size=1024,
        tenants={"tenant-a": {"weight": 2.0},
                 "tenant-b": {"weight": 1.0}},
        ops=[
            CreateNodes(init_nodes, _node),
            CreateObjects(len(plan), mkgroup,
                          create_verb="create_pod_group"),
            CreatePods(len(members), mkpod, collect_metrics=True),
        ],
        rescale=lambda s: multi_tenant_gang_storm(
            init_nodes=max(8, int(init_nodes * s)),
            gangs_per_tenant=max(1, int(gangs_per_tenant * s))))


def quota_exhaustion_churn(init_nodes=200, blocked_pods=400,
                           quota_pods=100, measure_pods=2000) -> Workload:
    """A burst tenant whose demand exceeds its pod quota (only
    ``quota_pods`` admit; the rest hold in its job queue) while an
    unconstrained steady tenant's measured pods must flow at full rate —
    the "blocked tenants don't starve others" criterion."""
    return Workload(
        name="QuotaExhaustionChurn/200Nodes",
        threshold=150,
        # bucket tracks the 200-node cluster: a 1024-row bucket made
        # every [B, N] auction round pay 5x dead-row work
        node_capacity=256,
        batch_size=1024,
        tenants={"burst": {"quota": {"pods": str(quota_pods)}},
                 "steady": {}},
        ops=[
            CreateNodes(init_nodes, _node),
            CreatePods(blocked_pods,
                       lambda i: _tenant_pod(f"burst-{i}", "burst"),
                       wait=False),    # over-quota tail never schedules
            CreatePods(measure_pods,
                       lambda i: _tenant_pod(f"steady-{i}", "steady"),
                       collect_metrics=True),
        ],
        rescale=lambda s: quota_exhaustion_churn(
            init_nodes=max(8, int(init_nodes * s)),
            blocked_pods=max(4, int(blocked_pods * s)),
            quota_pods=max(1, int(quota_pods * s)),
            measure_pods=max(4, int(measure_pods * s))))


def gang_preemption(init_nodes=128, high_gangs=24) -> Workload:
    """Whole-gang priority preemption: low-priority gangs of 4 saturate
    the cluster's CPU; measured high-priority gangs of 4 must evict
    ENTIRE lower gangs (never a slice) to land — the eviction path runs
    through the fenced flush + _expand_gang_victims."""
    low_gangs = init_nodes               # 4 x 900m per 4-cpu node
    low = [(f"low-{g}-m{m}", f"low-{g}") for g in range(low_gangs)
           for m in range(4)]
    high = [(f"high-{g}-m{m}", f"high-{g}") for g in range(high_gangs)
            for m in range(4)]

    def mkgroup(i: int) -> PodGroup:
        if i < low_gangs:
            name, prio = f"low-{i}", 0
        else:
            name, prio = f"high-{i - low_gangs}", 10
        return PodGroup(metadata=ObjectMeta(name=name), min_member=4,
                        queue="jobs", priority=prio,
                        schedule_timeout_seconds=120.0)

    return Workload(
        name="GangPreemption/128Nodes",
        # the JAX package's floor: preemptor re-probes ride the next
        # wave the moment the eviction flush fires
        threshold=800,
        node_capacity=256,
        batch_size=512,
        ops=[
            CreateNodes(init_nodes, _node),
            CreateObjects(low_gangs + high_gangs, mkgroup,
                          create_verb="create_pod_group"),
            CreatePods(len(low),
                       lambda i: _gang_member(low[i][0], low[i][1],
                                              "jobs", cpu="900m")),
            CreatePods(len(high),
                       lambda i: _gang_member(high[i][0], high[i][1],
                                              "jobs", cpu="900m",
                                              priority=10),
                       collect_metrics=True),
        ],
        rescale=lambda s: gang_preemption(
            init_nodes=max(4, int(init_nodes * s)),
            high_gangs=max(1, int(high_gangs * s))))


def _colocation_validate(hub, result) -> None:
    """GangTopologyPacking's acceptance criterion: members of each gang
    land topology-close. Computes per-gang zone spans from the final
    placements and RAISES when the mean strays — the device packer's
    domain-major fill keeps each fitting gang inside one zone, while a
    per-member spreading placement would scatter it."""
    node_zone = {n.metadata.name: n.metadata.labels.get(LABEL_ZONE)
                 for n in hub.list_nodes()}
    by_gang: dict[str, set] = {}
    for p in hub.list_pods():
        g = p.metadata.labels.get(LABEL_POD_GROUP)
        if g and p.spec.node_name:
            by_gang.setdefault(g, set()).add(node_zone.get(p.spec.node_name))
    spans = sorted(len(z) for z in by_gang.values())
    assert spans, "no gang placed anything"
    mean = sum(spans) / len(spans)
    result["colocation"] = {
        "gangs": len(spans),
        "mean_zone_spans": round(mean, 3),
        "max_zone_spans": spans[-1],
        "one_zone_frac": round(
            sum(1 for s in spans if s == 1) / len(spans), 3),
    }
    assert mean <= 1.5, \
        f"gang members not topology-close: mean zone spans {mean:.2f}"


def gang_topology_packing(init_nodes=96, zones=8, gangs=8) -> Workload:
    """Zoned cluster, gangs sized to FIT one zone, cluster at half
    demand: every gang must land topology-close (the validate hook
    asserts mean zone spans <= 1.5 — the device packer's domain-major
    fill puts each gang in ONE zone, where per-member least-allocated
    spreading would scatter it across the cluster)."""
    nodes_per_zone = max(1, init_nodes // zones)
    zone_cap = nodes_per_zone * 4           # 900m members on 4-cpu nodes
    size = max(2, zone_cap // 2)            # each gang fits half a zone
    zone_names = [f"zone-{z}" for z in range(zones)]

    def mkgroup(i: int) -> PodGroup:
        return PodGroup(metadata=ObjectMeta(name=f"pack-{i}"),
                        min_member=size, queue="jobs",
                        schedule_timeout_seconds=120.0)

    def mkpod(i: int) -> Pod:
        return _gang_member(f"pack-{i // size}-m{i % size}",
                            f"pack-{i // size}", "jobs", cpu="900m")

    return Workload(
        name="GangTopologyPacking/96Nodes",
        # the JAX package's floor; the real acceptance gate is the
        # validate hook's co-location bound
        threshold=150,
        node_capacity=128,
        batch_size=512,
        ops=[
            CreateNodes(init_nodes, lambda i: _node(i, zone_names)),
            CreateObjects(gangs, mkgroup,
                          create_verb="create_pod_group"),
            CreatePods(gangs * size, mkpod, collect_metrics=True),
        ],
        validate=_colocation_validate,
        rescale=lambda s: gang_topology_packing(
            init_nodes=max(zones * 2, int(init_nodes * s)),
            zones=zones,
            gangs=max(2, int(gangs * s))))


# --------------------------- 13. DRA steady-state claim scheduling
# dra/performance-config.yaml:60-110 (SteadyStateClusterClaimTemplate,
# ~100 nodes, floor ~50): every node publishes a ResourceSlice of
# devices; each measured pod carries its own single-device ResourceClaim
# whose feasibility the batched allocator (K8) evaluates and which the
# DynamicResources plugin allocates at Reserve and persists through
# PreBind.

def _dra_node(i: int) -> Node:
    name = f"node-{i}"
    return Node(metadata=ObjectMeta(name=name,
                                    labels={LABEL_HOSTNAME: name}),
                spec=NodeSpec(),
                status=NodeStatus(allocatable={
                    "cpu": "16", "memory": "64Gi", "pods": "110"}))


def _dra_slice(i: int):
    from kubernetes_tpu_torch.api.objects import Device, ResourceSlice

    node = f"node-{i}"
    return ResourceSlice(
        metadata=ObjectMeta(name=f"slice-{node}"),
        node_name=node, driver="tpu.example.com", pool=node,
        devices=[Device(name=f"dev-{d}", device_class_name="tpu")
                 for d in range(8)])


def _dra_claim(i: int):
    from kubernetes_tpu_torch.api.objects import (
        DeviceRequest,
        ResourceClaim,
        ResourceClaimSpec,
    )

    return ResourceClaim(
        metadata=ObjectMeta(name=f"dra-claim-{i}"),
        spec=ResourceClaimSpec(device_requests=[
            DeviceRequest(name="accel", device_class_name="tpu",
                          count=1)]))


def _dra_pod(i: int) -> Pod:
    from kubernetes_tpu_torch.api.objects import PodResourceClaim

    p = _pod(f"dra-{i}", cpu="100m", mem="200Mi")
    p.spec.resource_claims = [PodResourceClaim(
        name="accel", resource_claim_name=f"dra-claim-{i}")]
    return p


def dra_steady_state(init_nodes=100, measure_pods=500) -> Workload:
    return Workload(
        name="DRASteadyState/100Nodes_500Pods",
        threshold=50,
        node_capacity=128,
        pod_capacity=2048,
        batch_size=256,
        ops=[
            CreateNodes(init_nodes, _dra_node),
            CreateObjects(init_nodes, _dra_slice,
                          create_verb="create_resource_slice"),
            CreateObjects(measure_pods, _dra_claim,
                          create_verb="create_resource_claim"),
            CreatePods(measure_pods, _dra_pod, collect_metrics=True),
        ])


# --------------- 13b. DRA steady-state via claim TEMPLATES + CEL
# dra/performance-config.yaml SteadyStateClusterClaimTemplate (+
# resourceclaim-with-selector.yaml): pods reference a
# ResourceClaimTemplate; the resourceclaim controller stamps a per-pod
# claim whose request carries a CEL device selector; the structured
# allocator matches attributes/capacity per device.

def _dra_attr_slice(i: int):
    from kubernetes_tpu_torch.api.objects import Device, ResourceSlice

    node = f"node-{i}"
    return ResourceSlice(
        metadata=ObjectMeta(name=f"slice-{node}"),
        node_name=node, driver="tpu.example.com", pool=node,
        devices=[Device(name=f"dev-{d}",
                        attributes={"preallocate": d % 2 == 0},
                        capacity={"counters": "2"})
                 for d in range(8)])


def _dra_template(i: int):
    from kubernetes_tpu_torch.api.objects import (
        DeviceRequest,
        DeviceSelector,
        ResourceClaimSpec,
        ResourceClaimTemplate,
    )

    expr = ("device.capacity['tpu.example.com'].counters"
            ".compareTo(quantity('2')) >= 0 && "
            "device.attributes['tpu.example.com'].preallocate")
    return ResourceClaimTemplate(
        metadata=ObjectMeta(name="perf-claim-template"),
        spec=ResourceClaimSpec(device_requests=[
            DeviceRequest(name="accel", selectors=[
                DeviceSelector(cel_expression=expr)])]))


def _dra_template_pod(i: int) -> Pod:
    from kubernetes_tpu_torch.api.objects import PodResourceClaim

    p = _pod(f"drat-{i}", cpu="100m", mem="200Mi")
    p.spec.resource_claims = [PodResourceClaim(
        name="accel", resource_claim_template_name="perf-claim-template")]
    return p


def dra_steady_state_templates(init_nodes=100,
                               measure_pods=400) -> Workload:
    return Workload(
        name="DRASteadyStateClaimTemplates/100Nodes_400Pods",
        threshold=40,   # dra/performance-config.yaml:97 (template variant)
        node_capacity=128,
        pod_capacity=2048,
        batch_size=256,
        dra_claim_controller=True,
        ops=[
            CreateNodes(init_nodes, _dra_node),
            CreateObjects(init_nodes, _dra_attr_slice,
                          create_verb="create_resource_slice"),
            CreateObjects(1, _dra_template,
                          create_verb="create_resource_claim_template"),
            CreatePods(measure_pods, _dra_template_pod,
                       collect_metrics=True),
        ])


# --------------- 13c. DRA steady-state with CEL `in` membership
# the selector corpus's membership test (dra/performance-config.yaml's attribute-selector
# shapes) over a heterogeneous device fleet — half the devices match.

def _dra_model_slice(i: int):
    from kubernetes_tpu_torch.api.objects import Device, ResourceSlice

    node = f"node-{i}"
    models = ("v4", "v5e", "v5p", "v6e")
    return ResourceSlice(
        metadata=ObjectMeta(name=f"slice-{node}"),
        node_name=node, driver="tpu.example.com", pool=node,
        devices=[Device(name=f"dev-{d}",
                        attributes={"model": models[d % 4]})
                 for d in range(8)])


def _dra_cel_in_template(i: int):
    from kubernetes_tpu_torch.api.objects import (
        DeviceRequest,
        DeviceSelector,
        ResourceClaimSpec,
        ResourceClaimTemplate,
    )

    expr = ("device.attributes['tpu.example.com'].model"
            " in ['v5e', 'v5p']")
    return ResourceClaimTemplate(
        metadata=ObjectMeta(name="perf-claim-template"),
        spec=ResourceClaimSpec(device_requests=[
            DeviceRequest(name="accel", selectors=[
                DeviceSelector(cel_expression=expr)])]))


def dra_steady_state_cel_in(init_nodes=100, measure_pods=300) -> Workload:
    return Workload(
        name="DRASteadyStateCELIn/100Nodes_300Pods",
        threshold=40,   # template-variant floor: same shape, `in` selector
        node_capacity=128,
        pod_capacity=2048,
        batch_size=256,
        dra_claim_controller=True,
        ops=[
            CreateNodes(init_nodes, _dra_node),
            CreateObjects(init_nodes, _dra_model_slice,
                          create_verb="create_resource_slice"),
            CreateObjects(1, _dra_cel_in_template,
                          create_verb="create_resource_claim_template"),
            CreatePods(measure_pods, _dra_template_pod,
                       collect_metrics=True),
        ])


# --------------- 13d. DRA multi-request claims
# each claim carries TWO requests (a
# class-matched pair + one attribute-selected device, 3 devices per
# pod), exercising the allocator's greedy multi-request walk — on
# device, the carried `taken` mask across request slots.

def _dra_multi_slice(i: int):
    from kubernetes_tpu_torch.api.objects import Device, ResourceSlice

    node = f"node-{i}"
    return ResourceSlice(
        metadata=ObjectMeta(name=f"slice-{node}"),
        node_name=node, driver="tpu.example.com", pool=node,
        devices=[Device(name=f"dev-{d}", device_class_name="tpu",
                        attributes={"preallocate": d % 2 == 0})
                 for d in range(16)])


def _dra_multi_template(i: int):
    from kubernetes_tpu_torch.api.objects import (
        DeviceRequest,
        DeviceSelector,
        ResourceClaimSpec,
        ResourceClaimTemplate,
    )

    expr = "device.attributes['tpu.example.com'].preallocate"
    return ResourceClaimTemplate(
        metadata=ObjectMeta(name="perf-claim-template"),
        spec=ResourceClaimSpec(device_requests=[
            DeviceRequest(name="pair", device_class_name="tpu", count=2),
            DeviceRequest(name="probe", count=1, selectors=[
                DeviceSelector(cel_expression=expr)]),
        ]))


def dra_multi_request(init_nodes=100, measure_pods=250) -> Workload:
    return Workload(
        name="DRAMultiRequest/100Nodes_250Pods",
        threshold=40,   # template-variant floor: 3 devices per pod
        node_capacity=128,
        pod_capacity=2048,
        batch_size=256,
        dra_claim_controller=True,
        ops=[
            CreateNodes(init_nodes, _dra_node),
            CreateObjects(init_nodes, _dra_multi_slice,
                          create_verb="create_resource_slice"),
            CreateObjects(1, _dra_multi_template,
                          create_verb="create_resource_claim_template"),
            CreatePods(measure_pods, _dra_template_pod,
                       collect_metrics=True),
        ])


def learned_config(ckpt_path: str, weight: float = 1.0, tie_seed: int = 0):
    """The learned arm's scheduler configuration, as the JAX package's
    ``bench.py --ab-scorer`` builds it (bench.py:274-280) for its
    SchedulingBasic, TopologySpreading and PreemptionAsync arms: the
    default profile with LearnedScore enabled at the score point with
    ``weight``, reading the checkpoint at ``ckpt_path``, and the A/B's
    fixed tie-break seed. ``run_workload(w, config=...)`` takes
    it; the hand arm is ``default_config()`` with the same seed."""
    from kubernetes_tpu_torch.config.types import Plugin, default_config

    cfg = default_config()
    cfg.tie_break_seed = tie_seed
    prof = cfg.profiles[0]
    prof.plugins.score.enabled.append(Plugin("LearnedScore", weight))
    prof.plugin_config["LearnedScore"] = {"checkpoint_path": ckpt_path}
    return cfg
