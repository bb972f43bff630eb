"""The perf-harness op DSL + workload runner (a subset of the JAX package's
perf/harness.py).

A Workload is a list of ops executed in order against a fresh Hub +
production Scheduler:

- CreateNodes / CreateNamespaces: populate the cluster.
- CreateObjects: create typed objects through a hub verb (PodGroups,
  ResourceSlices, ResourceClaims, ResourceClaimTemplates).
- CreatePods: create pods through hub.create_pod and drain the scheduler
  until every pod of the op is bound (the reference's
  waitUntilPodsScheduled); with collect_metrics=True the drain is timed
  by a ThroughputCollector observing the hub watch stream; wait=False
  creates without draining (pods not expected to schedule).
- Churn: from this point on, create pods from the given templates at a
  fixed interval while later ops drain (scheduler_perf.go:819 churnOp,
  mode=create; mode=recreate keeps one copy per template alive). Node
  templates need the node lifecycle of the scenario engine, a later slice
  of the port: they raise.

The drain drives Scheduler.run_until_idle — the production batched loop
(queue pop -> mirror pack -> device launch -> commit -> hub bind) — so
measured pods/s is production-path throughput; churn pods are injected
between batches, on the harness clock. Barriers and typed objects are
later slices of the port.

Gang workloads carry the tenants of their job queues (merged onto the
configuration), a ``rescale`` hook (their op counts must stay
gang-aligned, so a scaled run rebuilds the workload) and a ``validate``
hook on the end state; their results add the per-tenant admission stats
(``tenants``) and the gang coordinator's (``gangs``). Claim-template
(DRA) workloads run a ResourceClaimController against the hub.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import Namespace, Node, ObjectMeta, Pod
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
    timed; ``wait=False`` creates without draining."""

    count: int
    make_pod: Callable[[int], Pod]
    collect_metrics: bool = False
    timeout_s: float = 600.0
    wait: bool = True


@dataclass
class CreateObjects:
    """Generic typed-object create op (scheduler_perf's createAny): calls
    hub.<create_verb>(make(i)) count times."""

    count: int
    make: Callable[[int], object]
    create_verb: str = "create_pod_group"


@dataclass
class Churn:
    """churnOp (scheduler_perf.go:819): once reached, inject one object
    per template every ``interval_ms`` while subsequent ops drain.
    mode=create keeps creating; mode=recreate deletes the previous copy of
    each template first, keeping one alive per template."""

    templates: list[Callable[[int], object]]
    interval_ms: int = 200
    mode: str = "create"


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
    # featureGates overrides for this workload (the reference's
    # per-workload featureGates block), merged onto the config's gates
    feature_gates: dict = field(default_factory=dict)
    # multi-tenant job queues: tenant name -> {"weight", "quota"} merged
    # onto SchedulerConfiguration.tenants for this workload
    tenants: dict = field(default_factory=dict)
    # gang workloads: the factory rebuilds the whole workload at a scale
    # (op counts stay gang-aligned; capacities and batch stay the same)
    rescale: Optional[Callable[[float], "Workload"]] = None
    # post-run assertion hook: validate(hub, result) inspects the final
    # cluster state, may attach result fields, and raises on a violated
    # workload invariant
    validate: Optional[Callable] = None
    # run a ResourceClaimController against the hub (the reference's
    # resourceclaim controller runs in kube-controller-manager): needed by
    # claim-TEMPLATE workloads, whose claims the controller materializes
    dra_claim_controller: bool = False


class _ChurnState:
    def __init__(self, op: Churn, now: Callable[[], float]) -> None:
        self.op = op
        self.t0 = now()
        self.created = 0
        # mode=recreate: previous live copy per template index
        self._live: dict[int, object] = {}

    def due(self, t: float) -> int:
        # the first injection fires immediately, so a drain that completes
        # inside one interval still exercises the churn path
        return 1 + int((t - self.t0) * 1000.0 / self.op.interval_ms)

    @staticmethod
    def _create(hub: Hub, obj, i: int) -> None:
        if isinstance(obj, Node):
            raise NotImplementedError(
                "Node churn (the scenario engine's node lifecycle): ROADMAP "
                "queue 1 item 9")
        obj.metadata.name = f"churn-{obj.metadata.name}-{i}"
        hub.create_pod(obj)

    @staticmethod
    def _delete(hub: Hub, obj) -> None:
        try:
            hub.delete_pod(obj.metadata.uid)
        except Exception:  # noqa: BLE001 — already gone is fine
            pass

    def inject(self, hub: Hub, t: float) -> None:
        want = self.due(t)
        while self.created < want:
            i = self.created
            ti = i % len(self.op.templates)
            obj = self.op.templates[ti](i)
            if self.op.mode == "recreate":
                prev = self._live.pop(ti, None)
                if prev is not None:
                    self._delete(hub, prev)
                self._live[ti] = obj
            self._create(hub, obj, i)
            self.created += 1


class WorkloadStuck(Exception):
    """A phase did not finish within its timeout (pods stayed pending)."""


def run_workload(w: Workload, now: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 scale: float = 1.0, config=None, device="cuda",
                 on_scheduler: Optional[Callable] = None) -> dict:
    """Execute one workload on ``device``; returns the result dict
    (throughput summary, threshold verdict, scheduler stats).

    ``scale`` shrinks every op count while keeping capacities identical
    (a workload with a ``rescale`` hook rebuilds itself at that scale).
    ``on_scheduler(sched, hub)`` (if given) sees the scheduler and hub
    before the hub is closed, for callers that check the end state."""
    if scale != 1.0 and w.rescale is not None:
        w = w.rescale(scale)
        scale = 1.0
    hub = Hub()
    if w.dra_claim_controller:
        from kubernetes_tpu_torch.plugins.dra import ResourceClaimController

        ResourceClaimController(hub)
    cfg = copy.deepcopy(config) if config is not None else default_config()
    cfg.batch_size = w.batch_size
    if w.tenants:
        cfg.tenants = {**cfg.tenants, **w.tenants}
    cfg.feature_gates.update(w.feature_gates)
    sched = Scheduler(hub, cfg, caps=Capacities(
        nodes=w.node_capacity, pods=w.pod_capacity), now=now, device=device)
    churns: list[_ChurnState] = []
    summary = None
    phases: list[dict] = []

    def scaled(n: int) -> int:
        return max(1, int(n * scale)) if scale != 1.0 else n

    def pump() -> None:
        for ch in churns:
            ch.inject(hub, now())

    def drain(done_fn: Callable[[], bool], timeout_s: float) -> None:
        """Run the production loop until done_fn(); churn pods are
        injected between batches; idle waits advance backoff."""
        deadline = now() + timeout_s

        def step() -> bool:
            pump()
            return done_fn()

        while not done_fn():
            pump()
            sched.run_until_idle(on_step=step)
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
            elif isinstance(op, CreateObjects):
                make = getattr(hub, op.create_verb)
                for i in range(scaled(op.count)):
                    make(op.make(i))
            elif isinstance(op, CreateNamespaces):
                for i in range(op.count):
                    hub.create_namespace(Namespace(metadata=ObjectMeta(
                        name=f"{op.prefix}-{i}",
                        labels=op.labels(i) if op.labels else {})))
            elif isinstance(op, Churn):
                churns.append(_ChurnState(op, now))
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
                if not op.wait:
                    phases.append({"op": "createPods", "count": n,
                                   "measured": False, "waited": False})
                    continue
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
        "churn_created": sum(ch.created for ch in churns),
        "threshold": w.threshold,
        "device": str(sched.device),
        "phases": phases,
        "stats": dict(sched.stats),
    }
    if sched.jobqueue.active:
        # per-tenant admission/fairness accounting (weights show up as
        # contended ratios) and the gang coordinator's counts
        result["tenants"] = sched.jobqueue.tenant_stats()
        result["gangs"] = sched._gang.debug_state()["stats"]
    if w.validate is not None:
        w.validate(hub, result)
    if summary is not None:
        result.update(summary.to_dict())
        result["passed"] = summary.pods_per_sec >= w.threshold
    return result
