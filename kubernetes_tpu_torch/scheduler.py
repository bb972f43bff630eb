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
preferred pod (anti)affinity, both kinds of spread, host ports) and
DefaultPreemption: fit-only rejections of equal priority share one
batched host sweep (Evaluator.batch_preempt), every other rejected
preemptor runs the full PostFilter (kernel K6), and the queued evictions
are flushed between cycles as one delete wave (_flush_evictions_safe).
Everything else — gangs and job queues, DRA, volumes, the learned scorer,
chain patching, the host fallback ladder, scale-out, telemetry and the
flight recorder — is a later slice: a batch or profile that needs it
raises NotImplementedError naming its ROADMAP item, never taking a silent
other route.
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
    LABEL_QUEUE,
    Node,
    Pod,
    PodCondition,
)
from kubernetes_tpu_torch.backend.cache import Cache
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
from kubernetes_tpu_torch.hub import EventHandlers, Hub, Unavailable
from kubernetes_tpu_torch.models.pipeline import (
    FILTER_PLUGINS,
    BatchResult,
    extract_state,
    launch_batch,
)
from kubernetes_tpu_torch.ops.features import Capacities

# outstanding chained launches in run_until_idle's software pipeline: 2 =
# commit batch k-1 while launches k and k+1 are queued
PIPELINE_DEPTH = 2

# the per-phase wall-time split kept in stats["time_s"]; eviction_flush
# is the preemption flush between cycles (the reference's phase name)
PHASES = ("pop", "sync", "pack", "dispatch", "pull", "commit",
          "eviction_flush")

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
    s = pod.spec
    if s.volumes:
        return "volumes (host volume plugins): ROADMAP queue 1 item 7"
    if s.resource_claims:
        return "resource claims (DRA, K8): ROADMAP queue 1 item 7"
    labels = pod.metadata.labels
    if LABEL_POD_GROUP in labels or LABEL_QUEUE in labels:
        return "gangs / tenant job queues (K7): ROADMAP queue 1 item 6"
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
    as-if-serial scan otherwise. (percentageOfNodesToScore, which also
    forces the scan, raises in Scheduler.__init__.)"""
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
        if self.config.percentage_of_nodes_to_score is not None \
                and self.config.percentage_of_nodes_to_score < 100:
            raise NotImplementedError(
                "percentageOfNodesToScore window (serial scan): ROADMAP "
                "queue 1 item 4")
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
        extra = {"binder": self.hub.bind, "hub": hub,
                 "preemption_evaluator": self.preemption}
        self.frameworks = {
            p.scheduler_name: Framework(p, registry=registry,
                                        extra_args=extra)
            for p in self.config.profiles}
        for name, fw in self.frameworks.items():
            if any(n == "LearnedScore" for n, _ in fw.points["score"]):
                raise NotImplementedError(
                    f"profile {name!r} enables LearnedScore: ROADMAP queue 1 "
                    "item 8 (K9)")
            if fw.has_host_filters():
                raise NotImplementedError(
                    f"profile {name!r} has host Filter/Score plugins: "
                    "ROADMAP queue 1 item 7")
        self.framework = self.frameworks[profile.scheduler_name]
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
                   == ["DefaultPreemption"]}
            for name, fw in self.frameworks.items()}
        # explicit tie-break seed threaded into every launch
        self._tie_seed = int(np.uint32(
            getattr(self.config, "tie_break_seed", 0)))
        self.stats = {"scheduled": 0, "unschedulable": 0, "errors": 0,
                      "batches": 0, "attempts": 0, "launches": 0,
                      "chained_launches": 0, "round_trips": 0,
                      "preemptions": 0,
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
            self.queue.move_all_to_active_or_backoff(
                ClusterEvent(R.ASSIGNED_POD, A.ADD), None, pod)
        elif not self._terminal(pod) and self._ours(pod):
            if pod.status.nominated_node_name:
                self.nominator.add(pod, pod.status.nominated_node_name)
            self.queue.add(pod)

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
                self.queue.move_all_to_active_or_backoff(
                    ClusterEvent(R.ASSIGNED_POD, A.ADD), old, new)
        elif not self._terminal(new) and self._ours(new):
            self.nominator.update(new)
            self.queue.update(old, new)

    def _on_pod_delete(self, pod: Pod) -> None:
        # deletes always win: tombstone at max rv so a straggling update
        # cannot resurrect the pod in the cache
        uid = pod.metadata.uid
        self._pod_rv[uid] = 2 ** 62
        self._rv_tombstones.append(uid)
        if len(self._rv_tombstones) > 50_000:
            self._pod_rv.pop(self._rv_tombstones.popleft(), None)
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
                and not self.mirror.batch_has_host_ports(pods))

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
        use_auction = commit_by_auction(
            spec, self.mirror.batch_has_host_ports(pods),
            pcfg["filters"][FILTER_PLUGINS.index("NodeResourcesFit")],
            self.device)
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
            fit_strategy=fit_strategy, fit_shape=fit_shape,
            tie_seed=self._tie_seed, device=self.device)
        self.stats["launches"] += 1
        self.stats["round_trips"] += out.round_trips
        # the chain advances to this launch's post-batch state UNLESS an
        # invalidation raced in while we were packing (epoch check)
        if epoch == self._chain_epoch:
            self._chain = (out.free, out.nzr)
        pull = self._start_pull(out)
        self._tick("dispatch", t0)
        fut = (self._commit_pool.submit(self._pull_launch, pull)
               if self._commit_pool is not None else None)
        return (runnable, pull, fut)

    def _start_pull(self, out: BatchResult) -> tuple:
        """Queue the device-to-host copies of the verdicts (node rows, the
        guard, and the reject counts the failure path reads) into pinned
        host buffers, and an event after them."""
        verdicts = (out.node_row, out.guard, out.reject_counts)
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
        reject_counts) as numpy / int."""
        (rows, guard, rejects), ev = pull
        if ev is not None:
            ev.synchronize()
        return rows.numpy(), int(guard), rejects.numpy()

    def _finish(self, inflight: tuple) -> None:
        """Pull one dispatched launch's verdicts and commit/fail each pod."""
        runnable, pull, fut = inflight
        n = len(runnable)
        t0 = self.now()
        rows_arr, guard, rejects = (fut.result() if fut is not None
                                    else self._pull_launch(pull))
        t0 = self._tick("pull", t0)
        if guard:
            raise DeviceFault(
                f"launch guard tripped (mask {guard:#x}): "
                f"{'NaN scores ' if guard & 1 else ''}"
                f"{'poisoned usage state' if guard & 2 else ''}")
        rows = rows_arr[:n].tolist()
        fail_is = [i for i in range(n) if rows[i] < 0]
        for qp, row in zip(runnable, rows):
            if row >= 0:
                self._commit(qp, self.mirror.name_of_row(row))
        if fail_is:
            self._handle_failures([(runnable[i], rejects[i].tolist())
                                   for i in fail_is])
        self._tick("commit", t0)

    def schedule_one_batch(self) -> int:
        """Pop up to batch_size pods, run one device launch, commit results.
        Returns the number of pods attempted (0 = queue idle)."""
        with self._lock:
            self._process_deferred_events()
            popped, runnable = self._pop_runnable()
            if popped == 0:
                self._drain_bind_results(wait=True)
                self._flush_evictions_safe()
                self._process_deferred_events()
                return 0
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
        cycle then runs on the binder pool."""
        pod = qp.pod
        assumed = pod.clone()
        assumed.spec.node_name = node_name
        self.cache.assume_pod(assumed)
        state = CycleState()
        fw = self._fw_for(pod)
        s = fw.run_reserve_plugins(state, pod, node_name)
        if not s.is_success():
            self._undo_commit(qp, state, assumed, node_name,
                              f"reserve: {s.message()}")
            return
        s, _waits = fw.run_permit_plugins(state, pod, node_name)
        if s.code == Code.WAIT:
            raise NotImplementedError(
                "Permit wait room (gangs): ROADMAP queue 1 item 6")
        if not s.is_success():
            self._undo_commit(qp, state, assumed, node_name,
                              f"permit: {s.message()}")
            return
        self._start_binding(qp, state, assumed, node_name)

    def _undo_commit(self, qp: QueuedPodInfo, state: CycleState,
                     assumed: Pod, node_name: str, msg: str) -> None:
        """Unreserve + Forget, then requeue error-class."""
        self._fw_for(qp.pod).run_unreserve_plugins(state, qp.pod, node_name)
        self.cache.forget_pod(assumed)
        # the device chain assumed this placement; force a re-sync
        self._invalidate_chain()
        self._error(qp, msg)

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
        the binder threads' own hub events replay here."""
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
        self._tick("commit", t0)

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
                # requeue)
                self._drain_bind_results(wait=True)
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
        still committed)."""
        with self._lock:
            return self._run_until_idle_locked(max_batches, on_step)

    def _run_until_idle_locked(self, max_batches, on_step) -> int:
        total = 0
        pending: deque[tuple] = deque()

        def flush_all() -> None:
            while pending:
                self._finish(pending.popleft())

        for _ in range(max_batches):
            self._process_deferred_events()
            self._drain_bind_results()
            now = self.now()
            if now - self._last_backoff_flush >= 1.0:
                self._last_backoff_flush = now
                self.queue.flush_backoff_completed()
            if on_step is not None and on_step():
                break
            popped, runnable = self._pop_runnable()
            if popped == 0:
                flush_all()
                if self._pipelined:
                    # the flush may have planned evictions (the failed
                    # wave's PostFilter ran in _finish): fire them NOW so
                    # the activated preemptor rides the next wave of this
                    # same drain instead of waiting out a backoff
                    self._flush_evictions_safe()
                self.queue.flush_backoff_completed()
                popped, runnable = self._pop_runnable()
                if popped == 0:
                    break
            total += popped
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
