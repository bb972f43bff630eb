"""Framework runtime: resolves a profile into runnable extension points.

A subset of the JAX package's framework/runtime.py: the launch
configuration (filter slots, ScoreWeights, fit strategy), the queue sort
and PreEnqueue gates, the PostFilter (preemption), reserve/permit/bind
runners and the queueing hints. Host Filter/Score plugins and the Permit wait room are later
slices of the port (no plugin of this registry needs them). The
original notes follow.

Equivalent of the reference's frameworkImpl
(kubernetes/pkg/scheduler/framework/runtime/framework.go:53,268):
instantiates plugins from the registry, expands the MultiPoint shorthand
with override semantics (expandMultiPointPlugins :523), resolves score
weights (scorePluginWeight :57), and exposes per-point runners.

The structural difference from the reference: RunFilterPlugins /
RunScorePlugins for the device plugin set are NOT virtual calls per
(plugin, node) — they are one fused launch of models.pipeline. The runtime
therefore exposes the launch configuration (enabled filter slots, the
ScoreWeights vector) instead, and runs only host plugins procedurally.
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.objects import Pod
from kubernetes_tpu_torch.config.types import SchedulerProfile
from kubernetes_tpu_torch.framework.cycle_state import CycleState
from kubernetes_tpu_torch.framework.interface import (
    BindPlugin,
    ClusterEventWithHint,
    Code,
    FilterPlugin,
    PermitPlugin,
    PostBindPlugin,
    PostFilterPlugin,
    PreBindPlugin,
    PreEnqueuePlugin,
    QueueSortPlugin,
    ReservePlugin,
    ScorePlugin,
    Status,
)
from kubernetes_tpu_torch.models.pipeline import (
    FILTER_PLUGINS,
    SCORE_PLUGINS,
    ScoreWeights,
)
from kubernetes_tpu_torch.plugins.registry import PluginDescriptor, in_tree_registry

import numpy as np

# pipeline ScoreWeights field per SCORE_PLUGINS entry
_WEIGHT_FIELD = {
    "TaintToleration": "taint_toleration",
    "NodeAffinity": "node_affinity",
    "NodeResourcesFit": "resources_fit",
    "NodeResourcesBalancedAllocation": "balanced_allocation",
    "ImageLocality": "image_locality",
    "PodTopologySpread": "pod_topology_spread",
    "InterPodAffinity": "inter_pod_affinity",
    "LearnedScore": "learned",
}


def _score_weight(point: str, explicit: float, multipoint: float,
                  d: PluginDescriptor) -> float:
    if point != "score":
        return 0.0
    # scorePluginWeight: explicit > multipoint > default > 1
    return explicit or multipoint or d.default_weight or 1.0


def expand_point(profile, registry: dict[str, PluginDescriptor],
                 point: str) -> list[tuple[str, float]]:
    """Effective (name, weight) list at one extension point: MultiPoint
    expansion with specific-point overrides and disabled sets
    (runtime/framework.go:523 expandMultiPointPlugins). Module-level so
    config validation resolves points exactly the way the runtime will."""
    plugins = profile.plugins
    ps = getattr(plugins, point)
    mp = plugins.multi_point
    disabled = {p.name for p in ps.disabled}
    wipe = "*" in disabled
    mp_disabled = {p.name for p in mp.disabled}
    mp_wipe = "*" in mp_disabled
    explicit = {p.name: p for p in ps.enabled}
    out: list[tuple[str, float]] = []
    consumed: set[str] = set()
    for p in mp.enabled:
        d = registry.get(p.name)
        if d is None or point not in d.points:
            continue
        if mp_wipe or p.name in mp_disabled:
            continue
        if wipe or p.name in disabled:
            continue
        if p.name in explicit:
            # specific-point config overrides weight, keeps MP order
            out.append((p.name, _score_weight(point, explicit[p.name].weight,
                                              p.weight, d)))
            consumed.add(p.name)
        else:
            out.append((p.name, _score_weight(point, 0.0, p.weight, d)))
    for p in ps.enabled:
        if p.name in consumed:
            continue
        d = registry.get(p.name)
        if d is None or point not in d.points:
            continue
        out.append((p.name, _score_weight(point, p.weight, 0.0, d)))
    return out


class Framework:
    """One profile's resolved plugin configuration + host-plugin instances."""

    def __init__(self, profile: SchedulerProfile,
                 registry: Optional[dict[str, PluginDescriptor]] = None,
                 extra_args: Optional[dict] = None):
        self.profile = profile
        self.registry = dict(in_tree_registry() if registry is None
                             else registry)
        self._extra_args = extra_args or {}
        # point -> ordered list of (name, weight)
        self.points: dict[str, list[tuple[str, float]]] = {}
        for point in ("pre_enqueue", "queue_sort", "filter", "post_filter",
                      "score", "reserve", "permit", "pre_bind", "bind",
                      "post_bind"):
            self.points[point] = self._expand(point)
        self._instances: dict[str, object] = {}
        for point, entries in self.points.items():
            for name, _ in entries:
                d = self.registry.get(name)
                if d is not None and d.factory is not None \
                        and name not in self._instances:
                    args = dict(profile.plugin_config.get(name, {}))
                    args.update(self._extra_args)
                    self._instances[name] = d.factory(args)

    # ------------- MultiPoint expansion (framework.go:523) -------------

    def _expand(self, point: str) -> list[tuple[str, float]]:
        return expand_point(self.profile, self.registry, point)

    # ------------- device launch configuration -------------

    def enabled_filters(self) -> tuple[bool, ...]:
        """Static per-slot enable flags for pipeline.FILTER_PLUGINS."""
        on = {name for name, _ in self.points["filter"]}
        return tuple(name in on for name in FILTER_PLUGINS)

    def fit_scoring(self):
        """(strategy, shape | None) from NodeResourcesFitArgs
        (apis/config types.go ScoringStrategy: LeastAllocated default,
        MostAllocated, RequestedToCapacityRatio with shape points
        {utilization 0..100, score 0..10})."""
        args = self.profile.plugin_config.get("NodeResourcesFit", {})
        ss = args.get("scoring_strategy") or {}
        strategy = ss.get("type", "LeastAllocated")
        shape = None
        pts = (ss.get("requested_to_capacity_ratio") or {}).get("shape")
        if strategy == "RequestedToCapacityRatio":
            if not pts:
                raise ValueError(
                    "NodeResourcesFit scoringStrategy "
                    "RequestedToCapacityRatio requires a non-empty "
                    "requested_to_capacity_ratio.shape")
            pts = sorted(pts, key=lambda p: p["utilization"])
            shape = (np.asarray([p["utilization"] / 100.0 for p in pts],
                                np.float32),
                     np.asarray([p["score"] * 10.0 for p in pts],
                                np.float32))
        return strategy, shape

    def score_weights(self) -> ScoreWeights:
        """Dynamic ScoreWeights vector from resolved config weights."""
        w = {name: weight for name, weight in self.points["score"]}
        fields = {}
        for plugin in SCORE_PLUGINS:
            fields[_WEIGHT_FIELD[plugin]] = float(np.float32(
                w.get(plugin, 0.0)))
        return ScoreWeights(**fields)

    # ------------- host extension-point runners -------------

    def _iter(self, point: str, cls):
        """Instances at a point matching cls, cached: this runs per pod per
        extension point on the commit path, and the plugin sets are fixed
        after construction (the reference's frameworkImpl also resolves its
        per-point slices once, runtime/framework.go:268)."""
        cache = self.__dict__.setdefault("_iter_cache", {})
        key = (point, cls)
        out = cache.get(key)
        if out is None:
            out = cache[key] = tuple(
                inst for name, _ in self.points[point]
                if isinstance(inst := self._instances.get(name), cls))
        return out

    def run_pre_enqueue_plugins(self, pod: Pod) -> Status:
        """interface.go PreEnqueuePlugin; gate failures keep the pod in
        unschedulablePods (scheduling_queue.go:538 runPreEnqueuePlugins)."""
        for pl in self._iter("pre_enqueue", PreEnqueuePlugin):
            s = pl.pre_enqueue(pod)
            if not s.is_success():
                s.plugin = s.plugin or pl.name()
                return s
        return Status()

    @staticmethod
    def _priority_sort_less(a, b) -> bool:
        # fallback: PrioritySort semantics
        pa, pb = a.pod.priority(), b.pod.priority()
        if pa != pb:
            return pa > pb
        return a.timestamp < b.timestamp

    @property
    def queue_sort_less(self):
        """The resolved QueueSort comparator, bound once — the heap calls it
        O(pods log pods) times per drain, so no per-compare plugin walk."""
        fn = self.__dict__.get("_queue_sort_fn")
        if fn is None:
            fn = self._priority_sort_less
            for pl in self._iter("queue_sort", QueueSortPlugin):
                fn = pl.less
                break
            self._queue_sort_fn = fn
        return fn

    @property
    def queue_sort_key(self):
        """Per-item sort-key function when the resolved QueueSort carries
        the default PrioritySort semantics (the only in-tree sort), else
        None. Lets the activeQ heap compare precomputed tuples instead of
        calling a Python comparator per sift step."""
        from kubernetes_tpu_torch.plugins.registry import PrioritySort

        fn = self.queue_sort_less
        if fn is Framework._priority_sort_less or \
                getattr(fn, "__func__", None) is PrioritySort.less:
            return lambda qp: (-qp.pod.priority(), qp.timestamp)
        return None

    def has_host_filters(self) -> bool:
        """Any instantiated host FilterPlugin or ScorePlugin? (device
        plugins are descriptors with no instance; the Scheduler refuses a
        profile that has host ones until they are ported)."""
        return bool(self._iter("filter", FilterPlugin)) or any(
            isinstance(self._instances.get(name), ScorePlugin)
            for name, _ in self.points["score"])

    def run_reserve_plugins(self, state: CycleState, pod: Pod,
                            node_name: str) -> Status:
        for pl in self._iter("reserve", ReservePlugin):
            s = pl.reserve(state, pod, node_name)
            if not s.is_success():
                return s
        return Status()

    def run_unreserve_plugins(self, state: CycleState, pod: Pod,
                              node_name: str) -> None:
        for pl in self._iter("reserve", ReservePlugin):
            pl.unreserve(state, pod, node_name)

    def run_permit_plugins(self, state: CycleState, pod: Pod,
                           node_name: str
                           ) -> tuple[Status, dict[str, float]]:
        """RunPermitPlugins (runtime/framework.go:1480): a rejecting plugin
        fails the pod; WAIT verdicts aggregate into (WAIT status,
        {plugin: timeout}) — the scheduler parks the pod in the
        waitingPodsMap until allowed/rejected/timed out."""
        waits: dict[str, float] = {}
        for pl in self._iter("permit", PermitPlugin):
            s, timeout = pl.permit(state, pod, node_name)
            if s.is_skip():
                continue
            if s.code == Code.WAIT:
                waits[s.plugin or pl.name()] = timeout or 0.0
                continue
            if not s.is_success():
                s.plugin = s.plugin or pl.name()
                return s, {}
        if waits:
            return Status(code=Code.WAIT), waits
        return Status(), {}

    def run_pre_bind_plugins(self, state: CycleState, pod: Pod,
                             node_name: str) -> Status:
        for pl in self._iter("pre_bind", PreBindPlugin):
            s = pl.pre_bind(state, pod, node_name)
            if not s.is_success():
                return s
        return Status()

    def run_bind_plugins(self, state: CycleState, pod: Pod,
                         node_name: str) -> Status:
        for pl in self._iter("bind", BindPlugin):
            s = pl.bind(state, pod, node_name)
            if not s.is_skip():
                return s
        return Status.error("no bind plugin handled the pod")

    def run_post_bind_plugins(self, state: CycleState, pod: Pod,
                              node_name: str) -> None:
        for pl in self._iter("post_bind", PostBindPlugin):
            pl.post_bind(state, pod, node_name)

    def run_post_filter_plugins(self, state: CycleState, pod: Pod,
                                diagnosis) -> tuple[Optional[str], Status]:
        """Returns (nominated_node_name, status)."""
        for pl in self._iter("post_filter", PostFilterPlugin):
            result, s = pl.post_filter(state, pod, diagnosis)
            if s.is_success() or s.code.name == "ERROR":
                return result, s
        return None, Status.unschedulable("no postFilter plugin helped")

    # ------------- queueing hints (scheduler.go:428) -------------

    def events_to_register(self) -> dict[str, list[ClusterEventWithHint]]:
        """plugin name -> cluster events that may unstick its rejections."""
        out: dict[str, list[ClusterEventWithHint]] = {}
        seen: set[str] = set()
        for entries in self.points.values():
            for name, _ in entries:
                if name in seen:
                    continue
                seen.add(name)
                d = self.registry.get(name)
                if d is not None and d.events:
                    out[name] = list(d.events)
        return out
