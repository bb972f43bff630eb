"""The Scheduler: event handlers + the batched scheduling loop (port of the
JAX package's scheduler.py, main path).

The loop keeps the reference's structure: pop a batch from the activeQ,
refresh the cluster mirror (full cache snapshot + mirror sync, unless the
batch can launch against the device-resident usage chain), run ONE
batched launch on the device (phase 1, then the commit engine that
``commit_by_auction`` picks: the auction, the soft-score auction or the
serial commit scan), pull the verdicts on the commit thread, then
assume/reserve/permit/bind each winner on the host and hand the losers to
the failure path: PostFilter preemption (framework/preemption.py), then a
condition patch and the unschedulable pool with their reject counts.

What the port keeps from the reference so far: PIPELINE_DEPTH launches in
flight over the (free, nzr) chain, the off-thread verdict pull, the async
binder pool, the queue's hint-driven requeue, topology (required and
preferred pod (anti)affinity, both kinds of spread, host ports),
DefaultPreemption — fit-only rejections of equal priority share one
batched host sweep (Evaluator.batch_preempt), every other rejected
preemptor runs the full PostFilter (kernel K6), and the queued evictions
are flushed between cycles as one delete wave (_flush_evictions_safe),
a gang victim's whole gang with it — and gangs with tenant job queues:
labelled pods wait in the JobQueue (DRR over tenants, quota, gang
gating) until released; each popped batch's device-packable gang units
are placed whole by the fused gang packer (kernel K7a, one launch per
GANG_PACK_BUCKET units) and committed atomically on the host; the other
gang members take the normal launch with GangScheduling's PreFilter as a
host filter (its verdicts AND into phase 1 as ``host_ok``; its capacity
bound is kernel K7b, pulled with the cycle's verdicts) and assemble their
quorum in the Permit wait room — and DRA: a batch's claim pods are
packed into the device allocator's tensors (plugins/dra.py
DeviceAllocatorView, after the binder backlog has landed) and their
claim feasibility fuses into phase 1 (kernel K8); pods whose claims the
device cannot express (matchAttribute, firstAvailable, adminAccess) take
DynamicResources' host Filter through the ``host_ok`` seam; Reserve
allocates through the assume overlay (a same-batch device race is the
"devices vanished" rejection and one retry) and PreBind writes the
allocation. The percentageOfNodesToScore window (config below 100; 0 =
adaptive) gates the auction off and rotates the serial scan's start row
across launches. A profile that enables LearnedScore polls its
checkpoint at sync time and its params ride the launch (kernel K9 inside
K2a and K3); a NaN in them trips the launch guard, which raises
DeviceFault. Everything else — volumes, host Score plugins, the
learned scorer's trainer and export, chain patching, the host fallback
ladder and quarantine, scale-out, telemetry and the flight recorder — is
a later slice: a batch or profile that needs it raises
NotImplementedError naming its ROADMAP item, never taking a silent other
route.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.api.objects import (
    LABEL_POD_GROUP,
    Node,
    Pod,
    PodCondition,
    pod_group_key,
)
from kubernetes_tpu_torch.api.resources import pod_request
from kubernetes_tpu_torch.backend.cache import Cache
from kubernetes_tpu_torch.backend.jobqueue import JobQueue
from kubernetes_tpu_torch.backend.mirror import CapacityError, Mirror
from kubernetes_tpu_torch.backend.nominator import Nominator
from kubernetes_tpu_torch.backend.queue import PriorityQueue, QueuedPodInfo
from kubernetes_tpu_torch.backend.snapshot import Snapshot
from kubernetes_tpu_torch.config.types import (
    SchedulerConfiguration,
    default_config,
)
from kubernetes_tpu_torch.framework.cycle_state import CycleState
from kubernetes_tpu_torch.framework.interface import (
    ActionType,
    ClusterEvent,
    Code,
    EventResource,
)
from kubernetes_tpu_torch.framework.preemption import Evaluator
from kubernetes_tpu_torch.framework.runtime import Framework
from kubernetes_tpu_torch.framework.waiting import WaitingPod
from kubernetes_tpu_torch.hub import EventHandlers, Hub, Unavailable
from kubernetes_tpu_torch.models.pipeline import (
    ADAPTIVE_PCT,
    FILTER_PLUGINS,
    BatchResult,
    extract_state,
    launch_batch,
)
from kubernetes_tpu_torch.kernels import gang as KG
from kubernetes_tpu_torch.ops.features import Capacities, PodBlobs
from kubernetes_tpu_torch.plugins.dra import (
    DynamicResources,
    dra_serial_keys,
    release_pod_claims,
)
from kubernetes_tpu_torch.plugins.gang import GangScheduling
from kubernetes_tpu_torch.utils.gcguard import guard as gc_guard

# outstanding chained launches in run_until_idle's software pipeline: 2 =
# commit batch k-1 while launches k and k+1 are queued
PIPELINE_DEPTH = 2

# the per-phase wall-time split kept in stats["time_s"]; eviction_flush
# is the preemption flush between cycles, gang_device a gang chunk's pack
# launch with its pull, gang_commit its atomic host commit and
# binder_drain the loop thread collecting binding cycles from the binder
# pool, waiting for them where it must, learned_score the learned
# scorer's checkpoint poll and, after a publish, its load and device pack
# (the reference's phase names)
PHASES = ("pop", "sync", "pack", "dispatch", "pull", "commit",
          "eviction_flush", "gang_device", "gang_commit", "binder_drain",
          "learned_score")

A = ActionType
R = EventResource


class DeviceFault(RuntimeError):
    """The launch's guard reduction tripped (NaN scores or a poisoned
    usage state). Raised before any commit; the host fallback ladder that
    contains it in the reference is a later slice of the port."""


def _node_update_action(old: Node, new: Node) -> ActionType:
    """Which parts of the node changed (eventhandlers.go
    nodeSchedulingPropertiesChange)."""
    action = ActionType(0)
    if old.metadata.labels != new.metadata.labels:
        action |= A.UPDATE_NODE_LABEL
    if old.spec.taints != new.spec.taints \
            or old.spec.unschedulable != new.spec.unschedulable:
        action |= A.UPDATE_NODE_TAINT
    if old.status.allocatable != new.status.allocatable:
        action |= A.UPDATE_NODE_ALLOCATABLE
    return action or A.UPDATE_NODE_CONDITION


def unsupported_reason(pod: Pod) -> Optional[str]:
    """Why this pod needs a part of the scheduler not yet ported (and the
    ROADMAP item that ports it), or None for a pod the port schedules —
    preemptors included (priority and preemptionPolicy need nothing
    more)."""
    if pod.spec.volumes:
        return "volumes (host volume plugins): ROADMAP queue 1 item 7"
    return None


def commit_by_auction(spec, host_ports: bool, fit_on: bool,
                      device: torch.device) -> bool:
    """The commit engine of one launch, as the reference picks it
    (scheduler.py's ``use_auction``): the auction when the launch has no
    topology work, or only soft topology work (preferred terms,
    ScheduleAnyway spread) on the card — the reference's backend rule, with
    the launch device where it reads ``jax.default_backend()``; a soft
    batch on the CPU takes the serial scan — and when no batch pod carries
    host ports and the profile filters on NodeResourcesFit. The
    as-if-serial scan otherwise. (The Scheduler also takes the scan when
    the percentageOfNodesToScore window is on, as the reference does.)
    The Scheduler adds one deviation: a topology batch that carries host
    Filter or claim verdicts (``host_ok``, DRA) takes the scan on the card
    too — the soft auction reads its masks per group, the verdicts are per
    pod (models/pipeline.py)."""
    soft_auction = spec.topo_soft and device.type == "cuda"
    return ((not spec.enable_topology or soft_auction) and not host_ports
            and fit_on)


class Scheduler:
    def __init__(self, hub: Hub,
                 config: Optional[SchedulerConfiguration] = None,
                 caps: Optional[Capacities] = None,
                 now=time.time, registry=None, device="cuda"):
        self.hub = hub
        self.config = config or default_config()
        self.now = now
        # the launch device: "cuda" unless the caller asks for the CPU
        # (where the kernels' plain twins run); no card is an error
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Scheduler(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the plain-torch twins")
        # percentageOfNodesToScore (schedule_one.go:668): unset or >= 100
        # scores every node; an explicit 0 is the reference's adaptive
        # percentage; the window gates the auction off
        raw = self.config.percentage_of_nodes_to_score
        self._pct = (0 if raw is None or raw >= 100
                     else ADAPTIVE_PCT if raw == 0 else int(raw))
        # the window's rotating start row, carried across launches on the
        # device (nextStartNodeIndex, schedule_one.go:620)
        self._pct_start = None
        if self.config.extenders:
            raise NotImplementedError(
                "scheduler extenders: ROADMAP queue 1 item 7")
        profile = self.config.profiles[0]
        self._profile_name = profile.scheduler_name
        self.cache = Cache(now=now)
        self.snapshot = Snapshot()
        self.caps = caps or Capacities(
            nodes=self.config.node_capacity,
            pods=self.config.pod_table_capacity)
        self.mirror = Mirror(caps=self.caps, device=self.device)
        self.nominator = Nominator()
        self.preemption = Evaluator(
            hub, lambda: self.mirror, lambda: self.caps,
            self._filters_for, self.nominator)
        # the DRA plugin and the gang coordinator are shared across
        # profiles: one assume overlay must see every profile's
        # allocations, and quorum counting every profile's reservations
        self._dra = DynamicResources(hub)
        self._gang = GangScheduling(hub=hub, mirror_fn=lambda: self.mirror,
                                    now=now)
        # the multi-tenant job-queue layer in front of the activeQ; pods
        # without tenant/gang labels never touch it (jobqueue.active gates
        # the per-cycle release step)
        self.jobqueue = JobQueue(self.config.tenants, now=now,
                                 bound_fn=self._gang.bound_count)
        extra = {"binder": self.hub.bind, "hub": hub,
                 "preemption_evaluator": self.preemption,
                 "dra_shared": self._dra, "gang_shared": self._gang,
                 "device": self.device}
        self.frameworks = {
            p.scheduler_name: Framework(p, registry=registry,
                                        extra_args=extra)
            for p in self.config.profiles}
        for name, fw in self.frameworks.items():
            if fw.has_host_scores():
                raise NotImplementedError(
                    f"profile {name!r} has host Score plugins: ROADMAP "
                    "queue 1 item 7")
            self._gang.register_waiting_map(fw.waiting_pods)
        self.framework = self.frameworks[profile.scheduler_name]
        # host Filter plugins (GangScheduling's PreFilter) run per pod
        # behind their relevance gates; their verdicts AND into phase 1
        self._has_host_filters = any(fw.has_host_filters()
                                     for fw in self.frameworks.values())
        gates = [fw.host_gates() for fw in self.frameworks.values()]
        self._host_gates = (None if any(g is None for g in gates)
                            else [g for gs in gates for g in gs])
        merged_hints = {}
        for fw in self.frameworks.values():
            merged_hints.update(fw.events_to_register())
        if not self.config.gate("SchedulerQueueingHints"):
            from kubernetes_tpu_torch.framework.interface import (
                ClusterEventWithHint,
            )

            merged_hints = {
                name: [ClusterEventWithHint(event=r.event) for r in regs]
                for name, regs in merged_hints.items()}
        self.queue = PriorityQueue(
            less_fn=self.framework.queue_sort_less,
            sort_key_fn=self.framework.queue_sort_key,
            pre_enqueue=lambda pod: self._fw_for(
                pod).run_pre_enqueue_plugins(pod),
            queueing_hints=merged_hints,
            initial_backoff=self.config.pod_initial_backoff_seconds,
            max_backoff=self.config.pod_max_backoff_seconds,
            now=now)
        # gate opener of last resort: a flush that deleted nothing (empty
        # or already-gone victim sets) fires no cluster event, so the
        # evaluator re-activates those preemptors directly
        self.preemption.activate_fn = self.queue.activate
        # per-profile launch configuration
        self._profile_cfg = {
            name: {"filters": fw.enabled_filters(),
                   "weights": fw.score_weights(),
                   "fit": fw.fit_scoring(),
                   # the batched fit-only preemption path is only
                   # semantics-preserving when DefaultPreemption is the
                   # profile's ONLY PostFilter plugin
                   "batch_preempt_ok": [n for n, _ in
                                        fw.points["post_filter"]]
                   == ["DefaultPreemption"],
                   # fused device DRA allocation only applies to profiles
                   # that enable the DynamicResources filter: a profile
                   # with it disabled keeps scheduling claim pods
                   # unfiltered, as the host path did
                   "dra_filter": "DynamicResources" in {
                       n for n, _ in fw.points["filter"]},
                   # the learned scorer's checkpoint manager
                   # (plugins/learned.py); None unless the profile enables
                   # LearnedScore, and the launch then carries no
                   # learned term
                   "learned": fw.instance("LearnedScore"),
                   # device gang packing only engages for profiles that
                   # run the GangScheduling plugin at all — without it
                   # gang labels are inert and members are plain pods
                   "gang_plugin": any(
                       n == "GangScheduling"
                       for pt in ("filter", "permit")
                       for n, _ in fw.points[pt])}
            for name, fw in self.frameworks.items()}
        # device-side gang packing (K7a): whole PodGroups placed in one
        # fused launch; off = every gang takes the host Permit-quorum path
        # (the differential arm)
        self._gang_device = bool(getattr(self.config, "gang_device_packing",
                                         True))
        # explicit tie-break seed threaded into every launch
        self._tie_seed = int(np.uint32(
            getattr(self.config, "tie_break_seed", 0)))
        self.stats = {"scheduled": 0, "unschedulable": 0, "errors": 0,
                      "batches": 0, "attempts": 0, "launches": 0,
                      "chained_launches": 0, "round_trips": 0,
                      "preemptions": 0, "device_fallbacks": 0,
                      "gang_device_launches": 0, "gang_fallbacks": 0,
                      # gang_fallbacks by reason (the reference's metric
                      # label)
                      "gang_fallback_reasons": {},
                      "time_s": {p: 0.0 for p in PHASES}}
        # pods popped but deferred to the next batch (multi-profile split)
        self._deferred: list[QueuedPodInfo] = []
        # device-resident (free, nonzero_requested) chain: the post-launch
        # usage state of the newest dispatched launch. Any event not
        # caused by our own commits invalidates it, which forces a full
        # re-sync (chain patching is a later slice)
        self._chain: Optional[tuple] = None
        self._chain_epoch = 0
        self._pipelined = bool(getattr(self.config, "pipelined_waves", True))
        # off-thread verdict pull: the commit thread only waits for the
        # device-to-host copies; host mutation stays on the loop thread
        self._commit_pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="commit")
            if self._pipelined else None)
        # preemptor re-probes ride the next wave: after an eviction flush
        # fires, nominated reservations already protect the slots, so the
        # evaluator re-activates the flushed preemptors immediately
        self.preemption.activate_flushed = self._pipelined
        # preemption dry runs read the LIVE chain when one exists: under
        # pipelining the mirror's host free matrix lags by the in-flight
        # waves, and a dry run against it would over-evict (the sweep reads
        # it on the device; the K6b dry run copies it to the host)
        self.preemption.live_free_fn = (
            lambda: self._chain[0] if (self._pipelined
                                       and self._chain is not None)
            else None)
        self._lock = threading.RLock()
        self._binder: Optional[ThreadPoolExecutor] = None
        self._binder_tids: set[int] = set()
        if self.config.async_binding:
            self._binder = ThreadPoolExecutor(
                max_workers=self.config.binding_workers,
                thread_name_prefix="binder",
                initializer=lambda: self._binder_tids.add(
                    threading.get_ident()))
        self._inflight_binds: list[tuple] = []
        self._bind_backlog: list[tuple] = []
        self._pod_rv: dict[str, int] = {}   # newest applied pod revision
        self._rv_tombstones: deque = deque()
        self._deferred_events: deque = deque()
        self._last_backoff_flush = 0.0
        self._register_handlers()

    # ------------- event handlers (eventhandlers.go:366) -------------

    def _wrap(self, fn):
        """Events raised by the binder pool's own API writes are deferred
        (replayed on the loop thread); other callers apply inline under
        the scheduler lock when it is free and defer when it is held."""
        def handler(*args):
            if threading.get_ident() in self._binder_tids:
                self._deferred_events.append((fn, args))
                return
            if self._lock.acquire(blocking=False):
                try:
                    fn(*args)
                finally:
                    self._lock.release()
            else:
                self._deferred_events.append((fn, args))
        return handler

    def _process_deferred_events(self) -> None:
        while self._deferred_events:
            fn, args = self._deferred_events.popleft()
            fn(*args)

    def _pod_event_stale(self, pod: Pod) -> bool:
        """Drop any event older than the newest revision already applied
        (hub dispatch runs outside the hub lock)."""
        uid = pod.metadata.uid
        rv = pod.metadata.resource_version
        if rv <= self._pod_rv.get(uid, -1):
            return True
        self._pod_rv[uid] = rv
        return False

    def _register_handlers(self) -> None:
        w = self._wrap
        self.hub.watch_nodes(EventHandlers(
            on_add=w(self._on_node_add),
            on_update=w(self._on_node_update),
            on_delete=w(self._on_node_delete)))
        self.hub.watch_pods(EventHandlers(on_event=w(self._on_pod_event)))
        self.hub.watch_namespaces(EventHandlers(
            on_add=w(self._on_ns_set),
            on_update=w(lambda old, new: self._on_ns_set(new)),
            on_delete=w(self._on_ns_delete)))
        self.hub.watch_pod_groups(EventHandlers(
            on_add=w(lambda g: self._on_group_set(g, A.ADD)),
            on_update=w(lambda old, new: self._on_group_set(new, A.UPDATE)),
            on_delete=w(self._on_group_delete)))
        move = self.queue.move_all_to_active_or_backoff
        self.hub.watch_resource_slices(EventHandlers(
            on_add=w(lambda o: move(
                ClusterEvent(R.RESOURCE_SLICE, A.ADD), None, o)),
            on_delete=w(lambda o: move(
                ClusterEvent(R.RESOURCE_SLICE, A.DELETE), o, None))))
        self.hub.watch_resource_claims(EventHandlers(
            on_add=w(lambda o: move(
                ClusterEvent(R.RESOURCE_CLAIM, A.ADD), None, o)),
            on_update=w(lambda old, new: move(
                ClusterEvent(R.RESOURCE_CLAIM, A.UPDATE), old, new)),
            on_delete=w(lambda o: move(
                ClusterEvent(R.RESOURCE_CLAIM, A.DELETE), o, None))))

    def _on_group_set(self, group, action) -> None:
        """A PodGroup arrived/changed: the job queue may now release its
        orphaned members, the gang coordinator refreshes min_member and
        timeout, and parked members get a requeue chance."""
        self.jobqueue.set_group(group)
        self._gang.set_group(group)
        self.queue.move_all_to_active_or_backoff(
            ClusterEvent(R.POD_GROUP, action), None, group)

    def _on_group_delete(self, group) -> None:
        self.jobqueue.remove_group(group.key())
        self._gang.remove_group(group.key())

    def _invalidate_chain(self) -> None:
        """Drop the device-resident usage chain and bump the epoch so a
        dispatch that raced with the invalidation does not re-install a
        stale chain."""
        self._chain = None
        self._chain_epoch += 1

    def _on_ns_set(self, ns) -> None:
        self._invalidate_chain()
        self.cache.set_namespace(ns.metadata.name, ns.metadata.labels)

    def _on_ns_delete(self, ns) -> None:
        self._invalidate_chain()
        self.cache.remove_namespace(ns.metadata.name)

    def _on_node_add(self, node: Node) -> None:
        self._invalidate_chain()
        self.cache.add_node(node)
        self.queue.move_all_to_active_or_backoff(
            ClusterEvent(R.NODE, A.ADD), None, node)

    def _on_node_update(self, old: Node, new: Node) -> None:
        self._invalidate_chain()
        self.cache.update_node(old, new)
        self.queue.move_all_to_active_or_backoff(
            ClusterEvent(R.NODE, _node_update_action(old, new)), old, new)

    def _on_node_delete(self, node: Node) -> None:
        self._invalidate_chain()
        self.cache.remove_node(node)
        self.queue.move_all_to_active_or_backoff(
            ClusterEvent(R.NODE, A.DELETE), node, None)

    @staticmethod
    def _terminal(pod: Pod) -> bool:
        return pod.status.phase in ("Succeeded", "Failed")

    def _fw_for(self, pod: Pod) -> Framework:
        """frameworkForPod (schedule_one.go:371): by spec.schedulerName."""
        return self.frameworks.get(pod.spec.scheduler_name, self.framework)

    def _filters_for(self, pod: Pod) -> tuple[bool, ...]:
        """Enabled device-filter slots for the pod's profile (the
        preemption dry run must see the same filter set the pod's own
        scheduling cycle uses)."""
        return self._profile_cfg[self._fw_for(pod).profile.scheduler_name][
            "filters"]

    def _ours(self, pod: Pod) -> bool:
        return pod.spec.scheduler_name in self.frameworks

    def _enqueue_fresh(self, pod: Pod) -> None:
        """Route a pending pod to its queue: tenant/gang pods go through
        the job-queue layer (DRR + quota + gang gating), everything else
        straight to the activeQ."""
        if self.jobqueue.wants(pod) \
                and not self.jobqueue.was_admitted(pod.metadata.uid):
            self.jobqueue.add(pod)
        else:
            self.queue.add(pod)

    def _note_bound_pod(self, pod: Pod) -> None:
        """Bound-pod observation for the gang/tenant bookkeeping (quorum
        counting, quota replay)."""
        if LABEL_POD_GROUP in pod.metadata.labels:
            self._gang.note_bound(pod)
        if self.jobqueue.wants(pod):
            self.jobqueue.remove(pod)       # no longer queued here
            self.jobqueue.note_bound(pod)

    def _on_pod_event(self, ev) -> None:
        if ev.type == "delete":
            self._on_pod_delete(ev.old)
        elif ev.type == "add":
            self._on_pod_add(ev.new)
        else:
            self._on_pod_update(ev.old, ev.new)

    def _on_pod_add(self, pod: Pod) -> None:
        if self._pod_event_stale(pod):
            return
        if pod.spec.node_name:
            if not self.cache.is_assumed_pod(pod):
                # a foreign bind moves usage the chain does not carry
                self._invalidate_chain()
            self.cache.add_pod(pod)
            self._note_bound_pod(pod)
            self.queue.move_all_to_active_or_backoff(
                ClusterEvent(R.ASSIGNED_POD, A.ADD), None, pod)
        elif not self._terminal(pod) and self._ours(pod):
            if pod.status.nominated_node_name:
                self.nominator.add(pod, pod.status.nominated_node_name)
            self._enqueue_fresh(pod)

    def _on_pod_update(self, old: Pod, new: Pod) -> None:
        if self._pod_event_stale(new):
            return
        if new.spec.node_name:
            if not self.cache.is_assumed_pod(new):
                self._invalidate_chain()
            self.nominator.delete(new.metadata.uid)
            if old.spec.node_name:
                self.cache.update_pod(old, new)
                action = (A.UPDATE_POD_LABEL
                          if old.metadata.labels != new.metadata.labels
                          else A.UPDATE_POD_SCALE_DOWN)
                self.queue.move_all_to_active_or_backoff(
                    ClusterEvent(R.ASSIGNED_POD, action), old, new)
            else:
                # freshly bound (possibly by us): informer truth confirms
                self.cache.add_pod(new)
                self.queue.delete(new)
                self._note_bound_pod(new)
                self.queue.move_all_to_active_or_backoff(
                    ClusterEvent(R.ASSIGNED_POD, A.ADD), old, new)
        elif not self._terminal(new) and self._ours(new):
            self.nominator.update(new)
            if self.jobqueue.active \
                    and self.jobqueue.holds(new.metadata.uid):
                self.jobqueue.update(new)
            else:
                self.queue.update(old, new)

    def _on_pod_delete(self, pod: Pod) -> None:
        # deletes always win: tombstone at max rv so a straggling update
        # cannot resurrect the pod in the cache
        uid = pod.metadata.uid
        if self.jobqueue.active and self.jobqueue.wants(pod):
            # credit the tenant's quota reservation; drop queued copies
            self.jobqueue.remove(pod)
        if pod_group_key(pod) is not None and pod.spec.node_name:
            self._gang.note_unbound(pod)
        self._pod_rv[uid] = 2 ** 62
        self._rv_tombstones.append(uid)
        if len(self._rv_tombstones) > 50_000:
            self._pod_rv.pop(self._rv_tombstones.popleft(), None)
        if pod.spec.resource_claims:
            # the deleted pod leaves its claims' reservedFor
            release_pod_claims(self.hub, pod)
        self.nominator.delete(uid)
        if pod.spec.node_name:
            self._invalidate_chain()
            self.cache.remove_pod(pod)
            self.queue.move_all_to_active_or_backoff(
                ClusterEvent(R.ASSIGNED_POD, A.DELETE), pod, None)
        else:
            self.queue.delete(pod)

    # ------------- capacity re-bucketing -------------

    def _grow(self, err: CapacityError) -> None:
        """Double the exceeded capacity and rebuild the mirror."""
        field = err.field
        if not hasattr(self.caps, field):
            raise err
        cur = getattr(self.caps, field)
        new = max(cur * 2, 8)
        while new < err.needed:
            new *= 2
        self.caps = dataclasses.replace(self.caps, **{field: new})
        prev = self.mirror
        self.mirror = Mirror(caps=self.caps, device=self.device)
        # the fresh mirror keeps the domain bucket's high-water mark
        self.mirror.adopt_hysteresis(prev)
        self.snapshot = Snapshot()
        self._invalidate_chain()
        self.cache.update_snapshot(self.snapshot)

    # ------------- the batched scheduling cycle -------------

    def _tick(self, phase: str, t0: float) -> float:
        t1 = self.now()
        self.stats["time_s"][phase] += t1 - t0
        return t1

    def _pop_runnable(self) -> tuple[int, list[QueuedPodInfo]]:
        """Pop up to batch_size pods and apply skipPodSchedule
        (schedule_one.go:380: deleted or already assumed). Pods deferred
        from the previous batch go first."""
        t0 = self.now()
        deferred, self._deferred = self._deferred, []
        batch = deferred + self.queue.pop_batch(
            self.config.batch_size - len(deferred))
        runnable: list[QueuedPodInfo] = []
        for qp in batch:
            stored = self.hub.get_pod(qp.uid)
            if stored is None or stored.metadata.deletion_timestamp:
                self.queue.done(qp.uid)
                continue
            if self.cache.is_assumed_pod(qp.pod):
                self.queue.done(qp.uid)
                continue
            runnable.append(qp)
        self._tick("pop", t0)
        return len(batch), runnable

    def _chain_eligible(self, pods: list[Pod]) -> bool:
        """Can this batch launch against the device-resident usage chain
        without a snapshot/mirror re-sync? Needs a live chain and a launch
        that reads nothing the skipped sync would refresh."""
        return (self._chain is not None
                and not self.mirror.table_has_topology()
                and not self.mirror.batch_has_topology(pods)
                and not self.mirror.batch_has_host_ports(pods)
                and not (self._has_host_filters
                         and any(self._host_relevant(p) for p in pods)))

    def _dispatch(self, runnable: list[QueuedPodInfo], chained: bool,
                  flush_pending=None) -> Optional[tuple]:
        """Pack + launch one batch. ``flush_pending`` commits the launches
        still in flight before any re-sync, so a sync never reads a cache
        missing their placements."""
        for qp in runnable:
            reason = unsupported_reason(qp.pod)
            if reason is not None:
                raise NotImplementedError(f"pod {qp.pod.key()}: {reason}")
        epoch = self._chain_epoch
        if len(self.frameworks) > 1:
            # one profile per launch
            prof = runnable[0].pod.spec.scheduler_name
            same = [qp for qp in runnable
                    if qp.pod.spec.scheduler_name == prof]
            if len(same) != len(runnable):
                self._deferred.extend(
                    qp for qp in runnable
                    if qp.pod.spec.scheduler_name != prof)
                runnable = same
        else:
            prof = self._profile_name
        pcfg = self._profile_cfg[prof]
        if self._has_host_filters:
            runnable = self._defer_host_conflicts(runnable)
            if not runnable:
                return None
        self.stats["batches"] += 1
        self.stats["attempts"] += len(runnable)
        state = self._chain if chained else None
        need_sync = not chained
        pods = [qp.pod for qp in runnable]
        for _ in range(16):  # one capacity field may grow per attempt
            try:
                if need_sync:
                    if flush_pending is not None:
                        flush_pending()
                        flush_pending = None
                    t0 = self.now()
                    self.cache.update_snapshot(self.snapshot)
                    self.mirror.sync(self.snapshot)
                    self._tick("sync", t0)
                t0 = self.now()
                self.mirror.set_nominated(self.nominator.by_node())
                spec = self.mirror.prepare_launch(pods,
                                                  self.config.batch_size)
                self._tick("pack", t0)
                break
            except CapacityError as e:
                if flush_pending is not None:
                    flush_pending()
                    flush_pending = None
                self._grow(e)          # invalidates the chain
                state = None
                need_sync = True
        else:
            raise RuntimeError("mirror re-bucketing did not converge")
        # the learned scorer (profile-gated): poll the checkpoint's mtime
        # at sync time, a stat when unchanged, a load and one device pack
        # when a new version was published; the params then ride this
        # launch as one more weighted term (kernel K9 in K2a / K3), and a
        # reload rebuilds no kernel
        learned = None
        mgr = pcfg["learned"]
        if mgr is not None:
            t0 = self.now()
            mgr.maybe_reload()
            learned = mgr.params()
            self._tick("learned_score", t0)
        if pcfg["dra_filter"] and any(p.spec.resource_claims for p in pods):
            # the batched DRA allocator: binding cycles write allocations
            # (PreBind), so they land before the in-use mask packs
            self._drain_bind_results(wait=True)
            t0 = self.now()
            spec.dra, _dra_stats = self._dra.build_device_batch(
                pods, self.mirror.row_of, self.caps.nodes,
                spec.pblobs.f32.shape[0], self.device)
            for qp in runnable:
                if qp.pod.spec.resource_claims:
                    # a previous attempt's attribution must not survive
                    qp.host_reject_counts = {}
            self._tick("pack", t0)
        host_ok = None
        if self._has_host_filters:
            host_ok = self._run_host_plugins(runnable,
                                             spec.pblobs.f32.shape[0])
        use_auction = (not self._pct and commit_by_auction(
            spec, self.mirror.batch_has_host_ports(pods),
            pcfg["filters"][FILTER_PLUGINS.index("NodeResourcesFit")],
            self.device) and not ((host_ok is not None
                                   or spec.dra is not None)
                                  and spec.enable_topology))
        t0 = self.now()
        if state is None:
            # seed the usage chain from the freshly synced mirror
            state = extract_state(spec.cblobs, self.caps)
        else:
            self.stats["chained_launches"] += 1
        fit_strategy, fit_shape = pcfg["fit"]
        out: BatchResult = launch_batch(
            spec, self.mirror.well_known(), pcfg["weights"], self.caps,
            pcfg["filters"], serial_scan=not use_auction, state=state,
            host_ok=host_ok, fit_strategy=fit_strategy, fit_shape=fit_shape,
            pct_nodes=self._pct,
            pct_start=self._pct_start if self._pct else None,
            learned=learned, tie_seed=self._tie_seed, device=self.device)
        if self._pct:
            # the rotation carry stays on the device: the next launch's seed
            self._pct_start = out.pct_start
        self.stats["launches"] += 1
        self.stats["round_trips"] += out.round_trips
        # the chain advances to this launch's post-batch state UNLESS an
        # invalidation raced in while we were packing (epoch check)
        if epoch == self._chain_epoch:
            self._chain = (out.free, out.nzr)
        # the gang PreFilter's capacity reductions (K7b, queued by the host
        # pass above) ride this launch's verdict pull
        cap_pulls = self._gang.take_pending_caps()
        pull = self._start_pull(
            (out.node_row, out.guard, out.reject_counts, out.dra_reject)
            + tuple(arr for _key, _tok, arr in cap_pulls))
        self._tick("dispatch", t0)
        fut = (self._commit_pool.submit(self._pull_launch, pull)
               if self._commit_pool is not None else None)
        return (runnable, pull, fut, cap_pulls)

    def _start_pull(self, verdicts: tuple) -> tuple:
        """Queue the device-to-host copies of the verdicts (a launch's node
        rows, guard and reject counts, any gang capacity bounds riding
        along) into pinned host buffers, and an event after them."""
        if self.device.type != "cuda":
            return tuple(t.clone() for t in verdicts), None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in verdicts)
        for h, t in zip(host, verdicts):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _pull_launch(pull: tuple) -> tuple:
        """The commit-thread half of _finish: wait for the copies queued
        by _start_pull. Touches no host state. Returns (rows, guard,
        reject_counts, dra_reject, the riding capacity bounds) as numpy /
        int."""
        (rows, guard, rejects, dra_rej, *caps), ev = pull
        if ev is not None:
            ev.synchronize()
        return (rows.numpy(), int(guard), rejects.numpy(), dra_rej.numpy(),
                [int(c) for c in caps])

    def _finish(self, inflight: tuple) -> None:
        """Pull one dispatched launch's verdicts and commit/fail each pod."""
        runnable, pull, fut, cap_pulls = inflight
        n = len(runnable)
        t0 = self.now()
        rows_arr, guard, rejects, dra_rej, cap_vals = (
            fut.result() if fut is not None else self._pull_launch(pull))
        for (ckey, ctok, _arr), v in zip(cap_pulls, cap_vals):
            self._gang.resolve_cap(ckey, ctok, v)
        t0 = self._tick("pull", t0)
        if guard:
            raise DeviceFault(
                f"launch guard tripped (mask {guard:#x}): "
                f"{'NaN scores ' if guard & 1 else ''}"
                f"{'poisoned usage state' if guard & 2 else ''}")
        rows = rows_arr[:n].tolist()
        fail_is = [i for i in range(n) if rows[i] < 0]
        for i in fail_is:
            # the fused DRA rejections fold into host_reject_counts, so
            # diagnosis, requeue hints and the preemption fast-path gate
            # behave as on the host filter path
            c = int(dra_rej[i])
            if c:
                runnable[i].host_reject_counts["DynamicResources"] = c
        for qp, row in zip(runnable, rows):
            if row >= 0:
                self._commit(qp, self.mirror.name_of_row(row))
        if fail_is:
            self._handle_failures([(runnable[i], rejects[i].tolist())
                                   for i in fail_is])
        self._tick("commit", t0)

    # ------------- host Filter plugins (the host_ok seam) -------------

    def _host_relevant(self, pod: Pod) -> bool:
        if self._host_gates is None:
            return True
        return any(gate(pod) for gate in self._host_gates)

    def _defer_host_conflicts(self, runnable: list[QueuedPodInfo]
                              ) -> list[QueuedPodInfo]:
        """Host plugins cannot see in-batch commits, so two pods whose
        verdicts influence each other (pods referencing the SAME claim,
        dra_serial_keys) must not share a batch: keep the first, defer
        the rest to the next batch."""
        seen: set[str] = set()
        keep: list[QueuedPodInfo] = []
        for qp in runnable:
            if not qp.pod.spec.resource_claims:
                keep.append(qp)
                continue
            keys = dra_serial_keys(self.hub, qp.pod)
            if keys & seen:
                self._deferred.append(qp)
            else:
                seen |= keys
                keep.append(qp)
        return keep

    def _run_host_plugins(self, runnable: list[QueuedPodInfo],
                          b_cap: int) -> Optional[np.ndarray]:
        """Host PreFilter/Filter plugins per pod over the synced snapshot;
        returns host_ok [b_cap, N] aligned to mirror rows, or None when no
        plugin rejected anything. Plugins PreFilter-Skip irrelevant pods,
        so this is a few dict probes per pod for gang-free batches. Timed
        as ``pack`` (the bind drain before it as ``binder_drain``)."""
        relevant = [(i, qp) for i, qp in enumerate(runnable)
                    if self._host_relevant(qp.pod)]
        if not relevant:
            return None
        # host plugins read the HUB (pod placements): every outstanding
        # binding cycle must land first
        self._drain_bind_results(wait=True)
        t0 = self.now()
        infos = self.snapshot.node_info_list
        host_ok = None
        rows = None
        n_cap = self.caps.nodes
        for i, qp in relevant:
            qp.host_reject_counts = {}
            mask, counts, early = self._fw_for(qp.pod).run_host_filters(
                CycleState(), qp.pod, infos)
            if counts:
                qp.host_reject_counts = counts
            if early is not None:
                if host_ok is None:
                    host_ok = np.ones((b_cap, n_cap), bool)
                host_ok[i, :] = False
                continue
            if mask is not None and not all(mask):
                if host_ok is None:
                    host_ok = np.ones((b_cap, n_cap), bool)
                if rows is None:
                    rows = np.array([self.mirror.row_of(ni.name)
                                     for ni in infos], np.int64)
                bad = rows[~np.asarray(mask, bool)]
                host_ok[i, bad[bad >= 0]] = False
        self._tick("pack", t0)
        return host_ok

    # ------------- device-side gang packing (K7a) -------------
    #
    # A whole PodGroup as ONE device problem: the batch's gang units are
    # packed into a single fused launch (kernels/gang.pack_gangs) — static
    # filters (K1), member capacity per node, an all-or-nothing
    # feasibility reduction and topology-close domain packing, gangs
    # committed as-if-serial inside the launch. A unit that clears the
    # verdict commits as one atomic host step (reserve-all -> permit-all
    # -> bind-all); the Permit quorum machinery stays as the host path for
    # gangs the kernel cannot express (topology terms, host ports,
    # heterogeneous members, partial quorum) and for a chunk whose launch
    # raised.

    # gang-pack launch bucket: FIXED, so every wave launches the same
    # shapes; wider waves chunk (the chunks chain their usage state, still
    # O(1) launches per gang)
    GANG_PACK_BUCKET = 16

    def _gang_fallback(self, reason: str) -> None:
        self.stats["gang_fallbacks"] += 1
        reasons = self.stats["gang_fallback_reasons"]
        reasons[reason] = reasons.get(reason, 0) + 1

    def _gang_unit_fallback_reason(self, key: str,
                                   qps: list[QueuedPodInfo]
                                   ) -> Optional[str]:
        """None = the unit is device-packable; otherwise the reason it
        must take the host Permit path."""
        group = self._gang.group_of(key)
        if group is None:
            return "no_group"
        if self._gang._poison_reason(key) is not None:
            return "poisoned"
        pods = [qp.pod for qp in qps]
        prof = pods[0].spec.scheduler_name
        if any(p.spec.scheduler_name != prof for p in pods[1:]):
            return "profiles"
        pcfg = self._profile_cfg.get(prof)
        if pcfg is None or not pcfg.get("gang_plugin"):
            return "no_plugin"
        # every member present in THIS batch places together; the unit
        # is packable only if that completes the quorum (bound members
        # count)
        need = max(group.min_member - self._gang.bound_count(key), 0)
        if len(pods) < need:
            return "partial"
        if self.mirror.batch_has_topology(pods):
            return "topology"
        if self.mirror.batch_has_host_ports(pods):
            return "ports"
        if any(p.spec.resource_claims for p in pods):
            return "host_filters"
        if max((p.priority() for p in pods), default=0) > 0:
            # a preempting gang the packer would reject anyway (the
            # memoized capacity bound, still fresh by content token,
            # already proves < need) goes STRAIGHT to the host path
            cached = self._gang._cap_cache.get(key)
            if cached is not None and cached[1] < len(pods):
                try:
                    if cached[0] == self._gang.cap_token(self.mirror,
                                                         pods[0]):
                        return "infeasible_preempting"
                except CapacityError:
                    return "capacity"
        try:
            row0 = self.mirror._res_row(pod_request(pods[0])).tobytes()
            if any(self.mirror._res_row(pod_request(p)).tobytes() != row0
                   for p in pods[1:]):
                # the packer places request-IDENTICAL members (one
                # representative row per gang)
                return "hetero"
        except CapacityError:
            return "capacity"   # normal path re-buckets and retries
        return None

    def _split_gang_units(self, runnable: list[QueuedPodInfo]
                          ) -> tuple[list, list[QueuedPodInfo]]:
        """Partition a popped batch into device-packable gang units and
        the rest (plain pods + fallback-path gang members)."""
        by_key: dict[str, list[QueuedPodInfo]] = {}
        for qp in runnable:
            key = pod_group_key(qp.pod)
            if key is not None:
                by_key.setdefault(key, []).append(qp)
        if not by_key:
            return [], runnable
        units: list[tuple[str, list[QueuedPodInfo]]] = []
        taken: set[str] = set()
        unit_prof = None
        for key, qps in by_key.items():
            reason = self._gang_unit_fallback_reason(key, qps)
            if reason is None:
                prof = qps[0].pod.spec.scheduler_name
                if unit_prof is None:
                    unit_prof = prof
                elif prof != unit_prof:
                    # one enabled-filter set per launch: units of another
                    # profile ride the normal path this cycle
                    reason = "profiles_mixed"
            if reason is None:
                units.append((key, qps))
                taken.update(qp.uid for qp in qps)
            else:
                self._gang_fallback(reason)
        if not units:
            return [], runnable
        return units, [qp for qp in runnable if qp.uid not in taken]

    def _schedule_gang_units(self, runnable: list[QueuedPodInfo],
                             flush_pending=None) -> list[QueuedPodInfo]:
        """Route the batch's device-packable gang units through the fused
        packer; returns what the normal path still owns. A chunk whose
        launch raised degrades to the host Permit path (counted in
        ``stats["device_fallbacks"]`` and as the ``device_fault`` gang
        fallback reason), as in the reference; the units committed by
        earlier chunks stay committed."""
        if not self._gang_device or not runnable:
            return runnable
        units, rest = self._split_gang_units(runnable)
        if not units:
            return rest
        if flush_pending is not None:
            # commit in-flight pipelined launches first: their results are
            # what the usage chain (or the re-synced mirror) must reflect
            flush_pending()
        fallback: list[QueuedPodInfo] = []
        for i in range(0, len(units), self.GANG_PACK_BUCKET):
            chunk = units[i:i + self.GANG_PACK_BUCKET]
            later = units[i + self.GANG_PACK_BUCKET:]
            try:
                fallback.extend(self._dispatch_gang_chunk(chunk))
            except Exception:  # noqa: BLE001 — containment seam: the
                # Permit-quorum path still schedules these gangs
                self.stats["device_fallbacks"] += 1
                self._invalidate_chain()
                degraded = chunk + later
                for _key, _qps in degraded:
                    self._gang_fallback("device_fault")
                chunk_qps = [qp for _key, qps in chunk for qp in qps]
                fallback.extend(self._still_pending(chunk_qps))
                fallback.extend(qp for _key, qps in later for qp in qps)
                return rest + fallback
        return rest + fallback

    def _still_pending(self, qps: list[QueuedPodInfo]
                       ) -> list[QueuedPodInfo]:
        """The members of a faulted chunk that no commit path has touched
        yet (a unit committed before the fault is mid-bind; a parked one
        is owned by its failure handler): neither may be re-driven."""
        return [qp for qp in qps
                if self.cache.get_pod(qp.pod) is None
                and not self.queue.is_parked(qp.uid)]

    def _dispatch_gang_chunk(self, units: list) -> list[QueuedPodInfo]:
        """ONE fused packing launch (K1 + K7a) for a chunk of gang units,
        ONE pull, and the atomic host commit of every unit that cleared
        the verdict. Returns members that must fall back to the normal
        path."""
        t0 = self.now()
        epoch = self._chain_epoch
        state = self._chain
        need_sync = state is None
        reps = [qps[0].pod for _key, qps in units]
        g_bucket = self.GANG_PACK_BUCKET
        for _attempt in range(16):
            try:
                if need_sync:
                    self.cache.update_snapshot(self.snapshot)
                    self.mirror.sync(self.snapshot)
                # nominated reservations must be CURRENT: the packer
                # subtracts them (and hands back each gang's own)
                self.mirror.set_nominated(self.nominator.by_node())
                feats = self.mirror.launch_features(reps)
                pfields = self.mirror.pod_fields(feats, False)
                f32, i32 = self.mirror._pack_batch_np(reps, g_bucket,
                                                      pfields)
                break
            except CapacityError as e:
                self._grow(e)
                state = None
                need_sync = True
        else:
            raise RuntimeError("mirror re-bucketing did not converge")
        tk, d_bucket = self.mirror.gang_pack_domain()
        need = np.zeros((g_bucket,), np.int32)
        own_nom = None
        for i, (_key, qps) in enumerate(units):
            need[i] = len(qps)
            for qp in qps:
                nom = qp.pod.status.nominated_node_name
                row = self.mirror.row_of(nom) if nom else -1
                if row >= 0:
                    if own_nom is None:
                        own_nom = np.zeros((g_bucket, self.caps.nodes),
                                           np.int32)
                    own_nom[i, row] += 1
        cblobs = self.mirror.to_blobs()
        if state is None:
            state = extract_state(cblobs, self.caps)
        pcfg = self._profile_cfg[reps[0].spec.scheduler_name]
        out = KG.pack_gangs(
            cblobs, self.mirror._to_dev(PodBlobs(f32=f32, i32=i32)),
            self.mirror.well_known(), self.caps, need, tk, d_cap=d_bucket,
            enabled_filters=pcfg["filters"], active=feats, pfields=pfields,
            ptmpl=self.mirror.pod_template_blobs(), state=state,
            own_nom=own_nom)
        self.stats["gang_device_launches"] += 1
        # ONE pull for the whole wave: verdicts + placements + capacity
        # bounds + spans (+ any PreFilter capacity bounds awaiting their
        # ride)
        cap_pulls = self._gang.take_pending_caps()
        pull = self._start_pull((out.ok, out.alloc, out.cap, out.spans,
                                 out.guard)
                                + tuple(arr for _k, _t, arr in cap_pulls))
        host, ev = pull
        if ev is not None:
            ev.synchronize()
        ok_arr, alloc_np, cap_arr, _spans, guard = (t.numpy()
                                                    for t in host[:5])
        for (ckey, ctok, _arr), v in zip(cap_pulls, host[5:]):
            self._gang.resolve_cap(ckey, ctok, int(v))
        t_commit0 = self._tick("gang_device", t0)
        if int(guard):
            raise DeviceFault(f"gang pack guard tripped (mask "
                              f"{int(guard):#x}): poisoned usage state")
        fallback: list[QueuedPodInfo] = []
        try:
            for i, (key, qps) in enumerate(units):
                # the packer's capacity column seeds the PreFilter memo
                self._gang.note_device_cap(
                    key, self._gang.cap_token(self.mirror, qps[0].pod),
                    int(cap_arr[i]))
                counts = alloc_np[i]
                if bool(ok_arr[i]) and int(counts.sum()) == len(qps):
                    rows = np.repeat(np.arange(counts.shape[0]), counts)
                    names = [self.mirror.name_of_row(int(r)) for r in rows]
                    if any(nm is None for nm in names):
                        self._gang_fallback("rows")
                        fallback.extend(qps)
                        continue
                    self._commit_gang_unit(key, qps, names)
                    continue
                if max((qp.pod.priority() for qp in qps), default=0) > 0:
                    # a positive-priority gang may open capacity by
                    # preempting: the host path's PostFilter owns it
                    self._gang_fallback("infeasible_preempting")
                    fallback.extend(qps)
                    continue
                group = self._gang.group_of(key)
                quorum = (max(group.min_member
                              - self._gang.bound_count(key), 1)
                          if group is not None else len(qps))
                if len(qps) > quorum:
                    # the packer places ALL present members or none; the
                    # Permit path can still admit the min_member quorum
                    # subset when only that fits
                    self._gang_fallback("infeasible_partial")
                    fallback.extend(qps)
                    continue
                msg = (f"gang {key}: device packer found no "
                       f"all-or-nothing placement for {len(qps)} "
                       f"member(s) (capacity bound {int(cap_arr[i])})")
                for qp in qps:
                    qp.host_reject_counts = {}
                    self._park_unschedulable(qp, {"GangScheduling"}, msg)
        finally:
            self._tick("gang_commit", t_commit0)
        # the chain advances to the launch's post-batch state unless a
        # rollback/park above invalidated it (epoch check, like _dispatch);
        # parked/fallback units were never debited on the device
        if epoch == self._chain_epoch:
            self._chain = (out.free, out.nzr)
        return fallback

    def _commit_gang_unit(self, key: str, qps: list[QueuedPodInfo],
                          node_names: list[str]) -> None:
        """Atomic host commit of one device-placed gang: reserve EVERY
        member first; any failure rolls the whole unit back before a
        single member reaches the binder (all-or-nothing, no Permit
        round-trips — the device verdict is the quorum)."""
        fw = self._fw_for(qps[0].pod)
        reserved: list[tuple] = []
        failure = None
        fail_i = len(qps)
        for i, (qp, node) in enumerate(zip(qps, node_names)):
            fail_i = i
            pod = qp.pod
            assumed = pod.clone()
            assumed.spec.node_name = node
            self.cache.assume_pod(assumed)
            state = CycleState()
            try:
                s = fw.run_reserve_plugins(state, pod, node)
            except Exception as e:  # noqa: BLE001 — a raising plugin must
                # not strand the assumes: the unit rolls back
                failure = (qp, state, assumed, node,
                           f"reserve raised: {e!r}", "")
                break
            if not s.is_success():
                failure = (qp, state, assumed, node,
                           f"reserve: {s.message()}",
                           s.plugin if s.is_rejected() else "")
                break
            reserved.append((qp, state, assumed, node))
        if failure is not None:
            self._gang.stats["rollbacks"] += 1
            fqp, fstate, fassumed, fnode, msg, tag = failure
            peer_msg = f"gang {key} rollback: peer {fqp.pod.key()}: {msg}"
            for qp, state, assumed, node in reserved:
                self._undo_commit(qp, state, assumed, node, peer_msg,
                                  rejected_by="GangScheduling")
            self._undo_commit(fqp, fstate, fassumed, fnode, msg,
                              rejected_by=tag)
            # members AFTER the failure never reserved, but they are part
            # of the all-or-nothing unit: park them with the same
            # attribution instead of dropping them from the queue
            for qp in qps[fail_i + 1:]:
                self._park_unschedulable(qp, {"GangScheduling"}, peer_msg)
            return
        # every member reserved: the device verdict IS the quorum — Permit
        # answers allow for marked uids. Permits run for the WHOLE unit
        # before any member reaches the binder: a failure rolls every
        # member back
        self._gang.device_admit(key, {qp.uid for qp, *_rest in reserved})
        verdicts: list[tuple] = []
        failure = None
        try:
            for qp, state, assumed, node in reserved:
                try:
                    s, waits = fw.run_permit_plugins(state, qp.pod, node)
                except Exception as e:  # noqa: BLE001
                    failure = (qp, f"permit raised: {e!r}", "")
                    break
                if not s.is_success() and s.code != Code.WAIT:
                    failure = (qp, f"permit: {s.message()}",
                               s.plugin if s.is_rejected() else "")
                    break
                verdicts.append((qp, state, assumed, node, s, waits))
        finally:
            self._gang.clear_device_admit(key)
        if failure is not None:
            self._gang.stats["rollbacks"] += 1
            fqp, msg, tag = failure
            peer_msg = f"gang {key} rollback: peer {fqp.pod.key()}: {msg}"
            for qp, state, assumed, node in reserved:
                own = qp.uid == fqp.uid
                self._undo_commit(
                    qp, state, assumed, node, msg if own else peer_msg,
                    rejected_by=tag if own else "GangScheduling")
            return
        for qp, state, assumed, node, s, waits in verdicts:
            if s.code == Code.WAIT:
                # another permit plugin wants the wait room: honor it
                fw.waiting_pods.add(WaitingPod(qp, node, state, waits,
                                               self.now()))
            else:
                self._start_binding(qp, state, assumed, node)
        self._gang.stats["admitted"] += 1
        self._gang.stats["device_admitted"] += 1

    def _park_unschedulable(self, qp: QueuedPodInfo, plugins: set[str],
                            msg: str) -> None:
        """Unschedulable park with plugin attribution (no PostFilter)."""
        qp.unschedulable_plugins = plugins or {"NodeResourcesFit"}
        qp.unschedulable_count += 1
        qp.consecutive_errors_count = 0
        self.stats["unschedulable"] += 1
        self.hub.patch_pod_condition(qp.pod, PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable",
            message=msg))
        self.queue.add_unschedulable_if_not_present(qp)

    def schedule_one_batch(self) -> int:
        """Pop up to batch_size pods, run one device launch, commit results.
        Returns the number of pods attempted (0 = queue idle)."""
        with self._lock:
            self._process_deferred_events()
            self._process_waiting()
            if self.jobqueue.active:
                self.jobqueue.release(self.queue, self.config.batch_size)
            popped, runnable = self._pop_runnable()
            if popped == 0:
                self._drain_bind_results(wait=True)
                self._flush_evictions_safe()
                self._process_deferred_events()
                return 0
            if runnable:
                # device-packable gang units commit through their own
                # fused launch first; the normal path keeps the rest
                runnable = self._schedule_gang_units(runnable)
            if runnable:
                inflight = self._dispatch(runnable, self._chain_eligible(
                    [qp.pod for qp in runnable]))
                if inflight is not None:
                    self._finish(inflight)
            self._drain_bind_results(wait=True)
            # async preemption: victims queued by PostFilter are evicted
            # here, OUTSIDE the cycle (prepareCandidateAsync's analog)
            self._flush_evictions_safe()
            self._process_deferred_events()
            return popped

    def _commit(self, qp: QueuedPodInfo, node_name: str) -> None:
        """assume -> reserve -> permit (schedule_one.go:142); the binding
        cycle then runs on the binder pool. A WAIT permit parks the pod in
        the waitingPodsMap with its reservation held."""
        pod = qp.pod
        assumed = pod.clone()
        assumed.spec.node_name = node_name
        self.cache.assume_pod(assumed)
        state = CycleState()
        fw = self._fw_for(pod)
        s = fw.run_reserve_plugins(state, pod, node_name)
        if not s.is_success():
            # a REJECTING reserve is unschedulable with plugin attribution,
            # not a scheduler error. DynamicResources rejects here when a
            # pod of the same batch took the devices first ("devices
            # vanished"): the batch's verdict was stale, so the pod retries
            # after backoff (documented deviation, ROADMAP queue 3: the
            # reference parks it where no event wakes it)
            self._undo_commit(qp, state, assumed, node_name,
                              f"reserve: {s.message()}",
                              rejected_by=(s.plugin if s.is_rejected()
                                           else ""),
                              retry=(s.is_rejected()
                                     and s.plugin == DynamicResources.NAME))
            return
        s, waits = fw.run_permit_plugins(state, pod, node_name)
        if s.code == Code.WAIT:
            fw.waiting_pods.add(WaitingPod(qp, node_name, state, waits,
                                           self.now()))
            return
        if not s.is_success():
            self._undo_commit(qp, state, assumed, node_name,
                              f"permit: {s.message()}",
                              rejected_by=(s.plugin if s.is_rejected()
                                           else ""))
            return
        self._start_binding(qp, state, assumed, node_name)

    def _undo_commit(self, qp: QueuedPodInfo, state: CycleState,
                     assumed: Pod, node_name: str, msg: str,
                     rejected_by: str = "", retry: bool = False) -> None:
        """Unreserve + Forget, then requeue: error-class for infrastructure
        failures (schedule_one.go:337's bind-failure path), unschedulable
        with plugin attribution when a plugin REJECTED the pod (a permit
        reject or timeout goes through handleSchedulingFailure as
        Unschedulable, schedule_one.go:270); ``retry`` sends such a pod to
        backoff instead of the unschedulable pool."""
        self._fw_for(qp.pod).run_unreserve_plugins(state, qp.pod, node_name)
        self.cache.forget_pod(assumed)
        # the device chain assumed this placement; force a re-sync
        self._invalidate_chain()
        if rejected_by:
            qp.unschedulable_plugins = {rejected_by}
            qp.unschedulable_count += 1
            qp.consecutive_errors_count = 0
            self.stats["unschedulable"] += 1
            self.hub.patch_pod_condition(qp.pod, PodCondition(
                type="PodScheduled", status="False", reason="Unschedulable",
                message=msg))
            if retry:
                self.queue.add_backoff(qp)
            else:
                self.queue.add_unschedulable_if_not_present(qp)
        else:
            self._error(qp, msg)

    def _process_waiting(self) -> None:
        """Harvest the waitingPodsMap: fully-allowed pods proceed to the
        binding cycle; rejected/timed-out pods unreserve and requeue
        (waiting_pods_map.go semantics)."""
        ready: list = []
        failed: list = []
        for fw in self.frameworks.values():
            r, f = fw.waiting_pods.harvest(self.now())
            ready.extend(r)
            failed.extend(f)
        for wp in ready:
            assumed = wp.qp.pod.clone()
            assumed.spec.node_name = wp.node_name
            self._start_binding(wp.qp, wp.state, assumed, wp.node_name)
        for wp, st in failed:
            assumed = wp.qp.pod.clone()
            assumed.spec.node_name = wp.node_name
            self._undo_commit(wp.qp, wp.state, assumed, wp.node_name,
                              st.message(), rejected_by=st.plugin or "Permit")

    def _bind_task(self, state: CycleState, pod: Pod, node_name: str):
        fw = self._fw_for(pod)
        try:
            s = fw.run_pre_bind_plugins(state, pod, node_name)
            if s.is_success():
                s = fw.run_bind_plugins(state, pod, node_name)
        except Exception as e:  # noqa: BLE001 — surfaced as a Status
            from kubernetes_tpu_torch.framework.interface import Status

            s = Status.error(f"bind cycle raised: {e!r}")
        return s

    def _start_binding(self, qp: QueuedPodInfo, state: CycleState,
                       assumed: Pod, node_name: str) -> None:
        if self._binder is None:
            self._finish_binding(qp, state, assumed, node_name,
                                 self._bind_task(state, qp.pod, node_name))
            self._process_deferred_events()
        else:
            # the backlog is chunked across the pool by _submit_bind_backlog
            self._bind_backlog.append((qp, state, assumed, node_name))

    def _submit_bind_backlog(self) -> None:
        backlog, self._bind_backlog = self._bind_backlog, []
        if not backlog:
            return
        workers = max(1, self.config.binding_workers)
        chunk = max(1, -(-len(backlog) // workers))

        def run_chunk(items):
            return [self._bind_task(state, qp.pod, node_name)
                    for qp, state, assumed, node_name in items]

        for i in range(0, len(backlog), chunk):
            items = backlog[i:i + chunk]
            self._inflight_binds.append(
                (items, self._binder.submit(run_chunk, items)))

    def _drain_bind_results(self, wait: bool = False) -> None:
        """Collect finished binding cycles (all of them when ``wait``);
        the binder threads' own hub events replay here. Timed as
        ``binder_drain``: the wait, and the host side of each landed
        bind."""
        self._submit_bind_backlog()
        if not self._inflight_binds:
            return
        t0 = self.now()
        still: list[tuple] = []
        for item in self._inflight_binds:
            items, fut = item
            if wait or fut.done():
                for (qp, state, assumed, node_name), s in zip(
                        items, fut.result()):
                    self._finish_binding(qp, state, assumed, node_name, s)
                self._process_deferred_events()
            else:
                still.append(item)
        self._inflight_binds = still
        self._tick("binder_drain", t0)

    def _finish_binding(self, qp: QueuedPodInfo, state: CycleState,
                        assumed: Pod, node_name: str, s) -> None:
        if not s.is_success():
            self._undo_commit(qp, state, assumed, node_name,
                              f"bind: {s.message()}")
            return
        self.cache.finish_binding(assumed)
        self.nominator.delete(qp.uid)
        self.queue.done(qp.uid)
        self._fw_for(qp.pod).run_post_bind_plugins(state, qp.pod, node_name)
        qp.consecutive_errors_count = 0
        self.stats["scheduled"] += 1

    def _handle_failures(self, failures: list[tuple]) -> None:
        """handleSchedulingFailure (schedule_one.go:1015) for a whole
        batch: plugin attribution from the end-state reject counts,
        PostFilter (preemption), condition patch, park. Fit-only
        rejections of equal priority share ONE batched preemption sweep
        (Evaluator.batch_preempt) — a churn of identical preemptors costs
        one host sweep, not one per pod, and burst members never target
        the same capacity."""
        fit_idx = FILTER_PLUGINS.index("NodeResourcesFit")
        prepped = []
        any_pf = False
        for qp, reject_counts in failures:
            plugins = {FILTER_PLUGINS[i]
                       for i, c in enumerate(reject_counts) if c > 0}
            plugins |= set(qp.host_reject_counts)
            qp.unschedulable_plugins = plugins or {"NodeResourcesFit"}
            qp.unschedulable_count += 1
            qp.consecutive_errors_count = 0
            self.stats["unschedulable"] += 1
            has_pf = bool(self._fw_for(qp.pod).points["post_filter"])
            pcfg = self._profile_cfg.get(qp.pod.spec.scheduler_name, {})
            fit_only = (pcfg.get("batch_preempt_ok", False)
                        and not qp.host_reject_counts
                        and all(c == 0 for i, c in enumerate(reject_counts)
                                if i != fit_idx))
            any_pf = any_pf or has_pf
            prepped.append((qp, reject_counts, plugins, has_pf, fit_only))
        nominated_by_uid: dict[str, Optional[str]] = {}
        if any_pf:
            # chained launches skip the per-batch sync; preemption reads
            # the host snapshot + mirror, so refresh (O(1) when clean)
            self.cache.update_snapshot(self.snapshot)
            self.mirror.sync(self.snapshot)
            # the batched sweep for fit-only preemptors, grouped by
            # (priority, profile): one enabled-filter set per group
            groups: dict[tuple, list] = {}
            for qp, _rej, _pl, has_pf, fit_only in prepped:
                if has_pf and fit_only:
                    groups.setdefault(
                        (qp.pod.priority(), qp.pod.spec.scheduler_name),
                        []).append(qp)
            for qps in groups.values():
                try:
                    results = self.preemption.batch_preempt(qps,
                                                            self.snapshot)
                except Unavailable:
                    # outage mid-sweep: no nominations this round; the
                    # parked preemptors retry after backoff
                    results = {}
                for uid, (node, _status) in results.items():
                    nominated_by_uid[uid] = node
                    if node:
                        self.stats["preemptions"] += 1
            if not self.config.gate("SchedulerAsyncPreemption"):
                # gate off: prepare candidates synchronously, inside the
                # failure handling (pre-kep-4832 behavior)
                self._flush_evictions_safe()
        for qp, reject_counts, plugins, has_pf, fit_only in prepped:
            if has_pf and not fit_only:
                try:
                    nominated, _s = self._fw_for(
                        qp.pod).run_post_filter_plugins(
                        CycleState(), qp.pod,
                        {"snapshot": self.snapshot,
                         "reject_counts": reject_counts,
                         "host_rejects": qp.host_reject_counts})
                except Unavailable:
                    nominated = None
                if nominated:
                    self.stats["preemptions"] += 1
            else:
                nominated = nominated_by_uid.get(qp.uid)
            self._park_failed(qp, plugins, nominated)

    def _park_failed(self, qp: QueuedPodInfo, plugins,
                     nominated: Optional[str]) -> None:
        """Condition patch (with the nominated node, when preemption chose
        one) + park (the tail of handleSchedulingFailure)."""
        self.hub.patch_pod_condition(qp.pod, PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable",
            message=f"rejected by {sorted(plugins)}"), nominated)
        # the patch fired while this pod was in flight (the queue ignores
        # updates for in-flight pods), so park the FRESH object — the
        # packed nominated_row must see status.nominatedNodeName next
        # attempt
        stored = self.hub.get_pod(qp.uid)
        if stored is not None:
            qp.pod = stored
        self.queue.add_unschedulable_if_not_present(qp)

    def _flush_evictions_safe(self) -> None:
        """Run the queued evictions between cycles (the async half of
        preemption, kep 4832), timed as the eviction_flush phase when
        there is work."""
        busy = self.preemption.has_pending()
        t0 = self.now() if busy else 0.0
        try:
            if busy:
                # evictions fire only over durably-bound state: a victim
                # whose own bind still rides the binder backlog would be
                # deleted BEFORE its bind lands, losing the pod (the
                # bind-after-delete fails and the deleted pod can't
                # requeue). The wait is binder_drain's, not the flush's
                self._drain_bind_results(wait=True)
                t0 = self.now()
            # the queue's coalescing window batches the wave's delete
            # events into ONE requeue pass (the in-process hub dispatches
            # them inline on this thread)
            with self.queue.coalescing():
                self.preemption.flush_evictions()
        except Unavailable:
            pass    # the backlog was requeued; the next cycle retries
        finally:
            if busy:
                self._tick("eviction_flush", t0)

    def _error(self, qp: QueuedPodInfo, msg: str) -> None:
        """Error-class failure: separate backoff counter."""
        qp.consecutive_errors_count += 1
        qp.unschedulable_plugins = set()
        self.stats["errors"] += 1
        self.hub.patch_pod_condition(qp.pod, PodCondition(
            type="PodScheduled", status="False", reason="SchedulerError",
            message=msg))
        self.queue.add_unschedulable_if_not_present(qp)

    # ------------- driving -------------

    def close(self) -> None:
        """Release the binder and commit pools."""
        if self._binder is not None:
            self._drain_bind_results(wait=True)
            self._process_deferred_events()
            self._binder.shutdown(wait=True)
            self._binder = None
        if self._commit_pool is not None:
            self._commit_pool.shutdown(wait=True)
            self._commit_pool = None

    def run_until_idle(self, max_batches: int = 1000, on_step=None) -> int:
        """Drain the activeQ; returns pods attempted.

        Pipelined: while launch k is in flight, batch k+1 is popped,
        packed and dispatched against the usage chain; batch k's commits
        then follow. ``on_step`` (if given) runs once per loop iteration
        before the pop; a truthy return stops the drain (pending work is
        still committed). The collector is off meanwhile (utils/gcguard.py),
        as in the reference: a full pass inside a drain would stall it."""
        with self._lock, gc_guard:
            return self._run_until_idle_locked(max_batches, on_step)

    def _run_until_idle_locked(self, max_batches, on_step) -> int:
        total = 0
        pending: deque[tuple] = deque()

        def flush_all() -> None:
            while pending:
                self._finish(pending.popleft())

        for _ in range(max_batches):
            self._process_deferred_events()
            self._process_waiting()
            self._drain_bind_results()
            now = self.now()
            if now - self._last_backoff_flush >= 1.0:
                self._last_backoff_flush = now
                self.queue.flush_backoff_completed()
                # a young-generation sweep keeps deferred cyclic garbage
                # bounded during long drains
                gc_guard.idle_sweep()
            if on_step is not None and on_step():
                break
            if self.jobqueue.active:
                # admit tenant/gang work by DRR + quota before the pop
                self.jobqueue.release(self.queue, self.config.batch_size)
            popped, runnable = self._pop_runnable()
            if popped == 0:
                flush_all()
                # the flush may have completed a gang quorum (Permit
                # allowed the waiting peers): harvest them into the
                # binding cycle BEFORE deciding the queue is idle
                self._process_waiting()
                if self._pipelined:
                    # the flush may have planned evictions (the failed
                    # wave's PostFilter ran in _finish): fire them NOW so
                    # the activated preemptor rides the next wave of this
                    # same drain instead of waiting out a backoff
                    self._flush_evictions_safe()
                self.queue.flush_backoff_completed()
                # a drained wait room or a churn event may have refilled
                # the job queue mid-iteration
                if self.jobqueue.active:
                    self.jobqueue.release(self.queue,
                                          self.config.batch_size)
                popped, runnable = self._pop_runnable()
                if popped == 0:
                    break
            total += popped
            if runnable:
                # gang units first: their fused launch chains the usage
                # state the normal launch then builds on
                runnable = self._schedule_gang_units(
                    runnable, flush_pending=flush_all)
            if runnable:
                chained = self._chain_eligible([qp.pod for qp in runnable])
                try:
                    nxt = self._dispatch(runnable, chained,
                                         flush_pending=flush_all)
                except BaseException:
                    # commit what was already in flight (its launch
                    # predates the fault), then surface the fault
                    flush_all()
                    raise
                if nxt is not None:
                    pending.append(nxt)
            # keep up to PIPELINE_DEPTH launches outstanding; the off arm
            # commits every wave before the next dispatch
            depth = PIPELINE_DEPTH if self._pipelined else 0
            while len(pending) > depth:
                self._finish(pending.popleft())
            # async preemption evictions run between cycles (kep 4832)
            self._flush_evictions_safe()
        flush_all()
        self._drain_bind_results(wait=True)
        self._flush_evictions_safe()
        self._process_deferred_events()
        return total
