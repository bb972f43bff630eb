"""The reference scheduler_perf workloads the port runs (a subset of the
JAX package's perf/workloads.py, same templates).

Node template (node-default.yaml): cpu 4, memory 32Gi, pods 110.
Pod template (pod-default.yaml): requests cpu 100m, memory 500Mi.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.objects import (
    LABEL_HOSTNAME,
    LABEL_ZONE,
    Container,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
    ResourceRequirements,
)
from kubernetes_tpu_torch.perf.harness import CreateNodes, CreatePods, Workload


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
