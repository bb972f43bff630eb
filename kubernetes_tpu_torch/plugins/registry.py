"""In-tree plugin set of the port: descriptors binding names to extension
points, device-kernel slots, events-to-register, and host implementations.

A subset of the JAX package's plugins/registry.py: the queue, gate and
bind plugins, the device Filter/Score descriptors, DefaultPreemption
(PostFilter + the async-preemption PreEnqueue gate, bound to the
scheduler's Evaluator) and GangScheduling (PreFilter capacity bound,
Reserve rollback hook, Permit quorum; the scheduler's shared gang
coordinator, plugins/gang.py). The volume family and DynamicResources are
a later slice of the port (ROADMAP queue 1 item 7): their names in a
profile resolve to nothing here, and the Scheduler refuses the pods that
would need them.
"""


from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import Pod
from kubernetes_tpu_torch.hub import Fenced, Unavailable
from kubernetes_tpu_torch.plugins import hints
from kubernetes_tpu_torch.framework.interface import (
    ActionType,
    BindPlugin,
    ClusterEvent,
    ClusterEventWithHint,
    EventResource,
    PreEnqueuePlugin,
    QueueSortPlugin,
    Status,
)

A = ActionType
R = EventResource


def _ev(resource: R, action: A, hint=None) -> ClusterEventWithHint:
    return ClusterEventWithHint(event=ClusterEvent(resource, action),
                                queueing_hint_fn=hint)


@dataclass
class PluginDescriptor:
    """Metadata for one in-tree plugin."""

    name: str
    points: tuple[str, ...]
    default_weight: float = 0.0
    # slot names into pipeline.FILTER_PLUGINS / SCORE_PLUGINS when the
    # plugin's Filter/Score math runs on device
    device_filter: bool = False
    device_score: bool = False
    events: list[ClusterEventWithHint] = field(default_factory=list)
    # factory for plugins with host-side behavior (queue sort, gates, bind…)
    factory: Optional[Callable[[dict], object]] = None


class SchedulingGates(PreEnqueuePlugin):
    """Holds pods with non-empty spec.schedulingGates out of the activeQ
    (plugins/schedulinggates/scheduling_gates.go)."""

    NAME = "SchedulingGates"

    def pre_enqueue(self, pod: Pod) -> Status:
        if not pod.spec.scheduling_gates:
            return Status()
        gates = ", ".join(g.name for g in pod.spec.scheduling_gates)
        return Status.unschedulable(
            f"waiting for scheduling gates: {gates}",
            plugin=self.NAME, resolvable=False)


class PrioritySort(QueueSortPlugin):
    """(priority desc, queue-time asc) (queuesort/priority_sort.go:44)."""

    NAME = "PrioritySort"

    def less(self, a, b) -> bool:
        pa, pb = a.pod.priority(), b.pod.priority()
        if pa != pb:
            return pa > pb
        return a.timestamp < b.timestamp


class DefaultBinder(BindPlugin):
    """POSTs the Binding (defaultbinder/default_binder.go:52); the hub/client
    is injected by the scheduler."""

    NAME = "DefaultBinder"

    def __init__(self, binder: Optional[Callable[[Pod, str], None]] = None):
        self._binder = binder

    def bind(self, state, pod: Pod, node_name: str) -> Status:
        if self._binder is None:
            return Status.error("no binder client configured", self.NAME)
        try:
            self._binder(pod, node_name)
        except Unavailable:
            raise    # transport outage: degraded mode parks, not errors
        except Fenced:
            raise    # deposed epoch: the scheduler releases the claim
        except Exception as e:  # noqa: BLE001 — surfaced as Status
            return Status.error(str(e), self.NAME)
        return Status()


def _default_preemption_factory(args: dict):
    """Binds the PostFilter to the scheduler's Evaluator (injected via
    extra_args); absent outside a full scheduler (kernel tests)."""
    ev = args.get("preemption_evaluator")
    if ev is None:
        return None
    from kubernetes_tpu_torch.framework.preemption import DefaultPreemption

    return DefaultPreemption(ev)


def in_tree_registry() -> dict[str, PluginDescriptor]:
    """name -> descriptor for every in-tree plugin (registry.go:48)."""
    pod_del = _ev(R.ASSIGNED_POD, A.DELETE | A.UPDATE_POD_SCALE_DOWN)
    node_alloc = _ev(R.NODE, A.ADD | A.UPDATE_NODE_ALLOCATABLE)
    descriptors = [
        PluginDescriptor(
            name="SchedulingGates", points=("pre_enqueue",),
            factory=lambda args: SchedulingGates(),
            # gated pods live in the queue's _gated pool and re-probe
            # PreEnqueue directly on gate events — queueing-hint fns are
            # never consulted for them, so no hint is registered here
            events=[_ev(R.POD,
                        A.UPDATE_POD_SCHEDULING_GATES_ELIMINATED)]),
        PluginDescriptor(
            name="PrioritySort", points=("queue_sort",),
            factory=lambda args: PrioritySort()),
        PluginDescriptor(
            name="NodeUnschedulable", points=("filter",), device_filter=True,
            events=[_ev(R.NODE, A.ADD | A.UPDATE_NODE_TAINT)]),
        PluginDescriptor(
            name="NodeName", points=("filter",), device_filter=True,
            events=[_ev(R.NODE, A.ADD)]),
        PluginDescriptor(
            name="TaintToleration", points=("filter", "score"),
            device_filter=True, device_score=True, default_weight=3,
            events=[_ev(R.NODE, A.ADD | A.UPDATE_NODE_TAINT,
                        hints.taint_toleration_hint)]),
        PluginDescriptor(
            name="NodeAffinity", points=("filter", "score"),
            device_filter=True, device_score=True, default_weight=2,
            events=[_ev(R.NODE, A.ADD | A.UPDATE_NODE_LABEL,
                        hints.node_affinity_hint)]),
        PluginDescriptor(
            name="NodePorts", points=("filter",), device_filter=True,
            events=[_ev(R.ASSIGNED_POD, A.DELETE,
                        hints.node_ports_hint),
                    _ev(R.NODE, A.ADD | A.UPDATE_NODE_ALLOCATABLE,
                        hints.node_ports_hint)]),
        PluginDescriptor(
            name="NodeResourcesFit", points=("filter", "score"),
            device_filter=True, device_score=True, default_weight=1,
            events=[_ev(R.ASSIGNED_POD,
                        A.DELETE | A.UPDATE_POD_SCALE_DOWN,
                        hints.fit_hint),
                    _ev(R.NODE, A.ADD | A.UPDATE_NODE_ALLOCATABLE,
                        hints.fit_hint)]),
        PluginDescriptor(
            name="PodTopologySpread", points=("filter", "score"),
            device_filter=True, device_score=True, default_weight=2,
            events=[_ev(R.ASSIGNED_POD,
                        A.ADD | A.DELETE | A.UPDATE_POD_LABEL,
                        hints.topology_spread_hint),
                    _ev(R.NODE, A.ADD | A.DELETE | A.UPDATE_NODE_LABEL
                        | A.UPDATE_NODE_TAINT,
                        hints.topology_spread_hint)]),
        PluginDescriptor(
            name="InterPodAffinity", points=("filter", "score"),
            device_filter=True, device_score=True, default_weight=2,
            events=[_ev(R.ASSIGNED_POD,
                        A.ADD | A.DELETE | A.UPDATE_POD_LABEL,
                        hints.inter_pod_affinity_hint),
                    _ev(R.NODE, A.ADD | A.UPDATE_NODE_LABEL,
                        hints.inter_pod_affinity_hint)]),
        PluginDescriptor(
            name="NodeResourcesBalancedAllocation", points=("score",),
            device_score=True, default_weight=1,
            events=[pod_del, node_alloc]),
        PluginDescriptor(
            name="ImageLocality", points=("score",), device_score=True,
            default_weight=1,
            events=[_ev(R.NODE, A.ADD | A.UPDATE_NODE_LABEL)]),
        # learned MLP score term: OFF by default; a profile that enables
        # it is refused by the Scheduler until the learned scorer is
        # ported (ROADMAP queue 1 item 8)
        PluginDescriptor(
            name="LearnedScore", points=("score",), device_score=True,
            default_weight=1),
        PluginDescriptor(
            name="DefaultPreemption", points=("post_filter", "pre_enqueue"),
            factory=_default_preemption_factory,
            events=[_ev(R.ASSIGNED_POD, A.DELETE)]),
        PluginDescriptor(
            name="DefaultBinder", points=("bind",),
            factory=lambda args: DefaultBinder(args.get("binder"))),
        # gang scheduling: PreFilter capacity bound + Permit quorum
        # assembly + unreserve-driven atomic rollback (plugins/gang.py);
        # the shared coordinator is injected by the scheduler
        PluginDescriptor(
            name="GangScheduling", points=("filter", "reserve", "permit"),
            factory=lambda args: args.get("gang_shared"),
            events=[_ev(R.POD_GROUP, A.ADD | A.UPDATE),
                    # ADD: a peer's bind advances a parked member's
                    # quorum (the permit-timeout retry path after
                    # failover); DELETE: freed capacity + shrunk gangs
                    _ev(R.ASSIGNED_POD, A.ADD | A.DELETE),
                    _ev(R.NODE, A.ADD | A.UPDATE_NODE_ALLOCATABLE)]),
    ]
    return {d.name: d for d in descriptors}

