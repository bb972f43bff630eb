"""The perf-harness op DSL + workload runner (a subset of the JAX package's
perf/harness.py).

A Workload is a list of ops executed in order against a fresh Hub +
production Scheduler:

- CreateNodes / CreateNamespaces: populate the cluster.
- CreatePods: create pods through hub.create_pod and drain the scheduler
  until every pod of the op is bound (the reference's
  waitUntilPodsScheduled); with collect_metrics=True the drain is timed
  by a ThroughputCollector observing the hub watch stream.

The drain drives Scheduler.run_until_idle — the production batched loop
(queue pop -> mirror pack -> device launch -> commit -> hub bind) — so
measured pods/s is production-path throughput. Churn, barriers and typed
objects are later slices of the port.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import Namespace, ObjectMeta, Pod
from kubernetes_tpu_torch.config.types import default_config
from kubernetes_tpu_torch.hub import EventHandlers, Hub
from kubernetes_tpu_torch.ops.features import Capacities
from kubernetes_tpu_torch.perf.collector import ThroughputCollector
from kubernetes_tpu_torch.scheduler import Scheduler


@dataclass
class CreateNodes:
    """createNodes op: ``make_node(i)`` -> Node."""

    count: int
    make_node: Callable[[int], object]


@dataclass
class CreateNamespaces:
    """createNamespaces op: namespaces ``{prefix}-0`` .. ``{prefix}-{count-1}``
    with ``labels(i)`` (none when unset)."""

    prefix: str
    count: int
    labels: Optional[Callable[[int], dict]] = None


@dataclass
class CreatePods:
    """createPods op: create ``count`` pods via ``make_pod(i)`` and wait
    for all of them to schedule. When ``collect_metrics`` the phase is
    timed."""

    count: int
    make_pod: Callable[[int], Pod]
    collect_metrics: bool = False
    timeout_s: float = 600.0


@dataclass
class Workload:
    name: str
    ops: list
    threshold: float = 0.0      # reference CI floor, pods/s
    node_capacity: int = 8192   # mirror bucket (pow2, fixed up front)
    pod_capacity: int = 16384
    batch_size: int = 2048
    # hostname-keyed topology workloads: the domain bucket tracks the
    # number of distinct domains = nodes, so a scaled-down run keeps
    # CreateNodes unscaled to launch at the full-size shapes
    warm_full_nodes: bool = False


class WorkloadStuck(Exception):
    """A phase did not finish within its timeout (pods stayed pending)."""


def run_workload(w: Workload, now: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 scale: float = 1.0, config=None, device="cuda",
                 on_scheduler: Optional[Callable] = None) -> dict:
    """Execute one workload on ``device``; returns the result dict
    (throughput summary, threshold verdict, scheduler stats).

    ``scale`` shrinks every op count while keeping capacities identical.
    ``on_scheduler(sched, hub)`` (if given) sees the scheduler and hub
    before the hub is closed, for callers that check the end state."""
    hub = Hub()
    cfg = copy.deepcopy(config) if config is not None else default_config()
    cfg.batch_size = w.batch_size
    sched = Scheduler(hub, cfg, caps=Capacities(
        nodes=w.node_capacity, pods=w.pod_capacity), now=now, device=device)
    summary = None
    phases: list[dict] = []

    def scaled(n: int) -> int:
        return max(1, int(n * scale)) if scale != 1.0 else n

    def drain(done_fn: Callable[[], bool], timeout_s: float) -> None:
        """Run the production loop until done_fn(); idle waits advance
        backoff."""
        deadline = now() + timeout_s
        while not done_fn():
            sched.run_until_idle(on_step=done_fn)
            if done_fn():
                return
            if now() > deadline:
                raise WorkloadStuck(
                    f"{w.name}: phase timed out after {timeout_s}s "
                    f"(pending={sched.queue.pending_counts()})")
            sleep(0.05)
            sched.queue.flush_backoff_completed()

    try:
        for op in w.ops:
            if isinstance(op, CreateNodes):
                n_nodes = op.count if w.warm_full_nodes else scaled(op.count)
                for i in range(n_nodes):
                    hub.create_node(op.make_node(i))
            elif isinstance(op, CreateNamespaces):
                for i in range(op.count):
                    hub.create_namespace(Namespace(metadata=ObjectMeta(
                        name=f"{op.prefix}-{i}",
                        labels=op.labels(i) if op.labels else {})))
            elif isinstance(op, CreatePods):
                n = scaled(op.count)
                pods = [op.make_pod(i) for i in range(n)]
                uids = {p.metadata.uid for p in pods}
                collector = None
                if op.collect_metrics:
                    collector = ThroughputCollector(uids, now)
                    hub.watch_pods(EventHandlers(
                        on_add=collector.on_add,
                        on_update=collector.on_update), replay=False)
                    collector.begin()
                for p in pods:
                    hub.create_pod(p)
                if collector is not None:
                    drain(collector.done, op.timeout_s)
                    summary = collector.summarize()
                else:
                    def all_bound() -> bool:
                        for u in uids:
                            p = hub.get_pod(u)
                            if p is not None and not p.spec.node_name:
                                return False
                        return True

                    drain(all_bound, op.timeout_s)
                phases.append({"op": "createPods", "count": n,
                               "measured": collector is not None})
            else:
                raise TypeError(f"unknown op {op!r}")
        if on_scheduler is not None:
            on_scheduler(sched, hub)
    finally:
        sched.close()  # binder threads released even on failure
    result = {
        "name": w.name,
        "threshold": w.threshold,
        "device": str(sched.device),
        "phases": phases,
        "stats": dict(sched.stats),
    }
    if summary is not None:
        result.update(summary.to_dict())
        result["passed"] = summary.pods_per_sec >= w.threshold
    return result
