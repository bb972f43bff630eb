"""The reference scheduler_perf workloads the port runs (a subset of the
JAX package's perf/workloads.py, same templates and sizes).

Node template (node-default.yaml): cpu 4, memory 32Gi, pods 110.
Pod template (pod-default.yaml): requests cpu 100m, memory 500Mi.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.objects import (
    LABEL_HOSTNAME,
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
    PodSpec,
    ResourceRequirements,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from kubernetes_tpu_torch.perf.harness import (
    Churn,
    CreateNamespaces,
    CreateNodes,
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
