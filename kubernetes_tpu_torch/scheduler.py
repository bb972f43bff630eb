"""The Scheduler: event handlers + the batched scheduling loop (port of the
JAX package's scheduler.py, main path).

The loop keeps the reference's structure: pop a batch from the activeQ,
refresh the cluster mirror (full cache snapshot + mirror sync, unless the
batch can launch against the device-resident usage chain), run ONE
batched launch (phase 1 + the auction) on the device, pull the verdicts
on the commit thread, then assume/reserve/permit/bind each winner on the
host and park the losers as unschedulable with their reject counts.

What this slice keeps from the reference: PIPELINE_DEPTH launches in
flight over the (free, nzr) chain, the off-thread verdict pull, the async
binder pool and the queue's hint-driven requeue. Everything else — the
serial commit scan and topology, preemption, gangs and job queues, DRA,
volumes, the learned scorer, chain patching, the host fallback ladder,
scale-out, telemetry and the flight recorder — is a later slice: a batch
or profile that needs it raises NotImplementedError naming its ROADMAP
item, never taking a silent other route.
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
from kubernetes_tpu_torch.framework.runtime import Framework
from kubernetes_tpu_torch.hub import EventHandlers, Hub
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

# the per-phase wall-time split kept in stats["time_s"]
PHASES = ("pop", "sync", "pack", "dispatch", "pull", "commit")

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
    ROADMAP item that ports it), or None for a plain pod."""
    s = pod.spec
    if s.volumes:
        return "volumes (host volume plugins): ROADMAP queue 1 item 5"
    if s.resource_claims:
        return "resource claims (DRA, K8): ROADMAP queue 1 item 5"
    labels = pod.metadata.labels
    if LABEL_POD_GROUP in labels or LABEL_QUEUE in labels:
        return "gangs / tenant job queues (K7): ROADMAP queue 1 item 4"
    return None


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
                "queue 1 item 2 (K3)")
        if self.config.extenders:
            raise NotImplementedError(
                "scheduler extenders: ROADMAP queue 1 item 5")
        profile = self.config.profiles[0]
        self._profile_name = profile.scheduler_name
        self.cache = Cache(now=now)
        self.snapshot = Snapshot()
        self.caps = caps or Capacities(
            nodes=self.config.node_capacity,
            pods=self.config.pod_table_capacity)
        self.mirror = Mirror(caps=self.caps, device=self.device)
        self.nominator = Nominator()
        extra = {"binder": self.hub.bind, "hub": hub}
        self.frameworks = {
            p.scheduler_name: Framework(p, registry=registry,
                                        extra_args=extra)
            for p in self.config.profiles}
        for name, fw in self.frameworks.items():
            if any(n == "LearnedScore" for n, _ in fw.points["score"]):
                raise NotImplementedError(
                    f"profile {name!r} enables LearnedScore: ROADMAP queue 1 "
                    "item 6 (K9)")
            if fw.has_host_filters():
                raise NotImplementedError(
                    f"profile {name!r} has host Filter/Score plugins: "
                    "ROADMAP queue 1 item 5")
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
        # per-profile launch configuration
        self._profile_cfg = {
            name: {"filters": fw.enabled_filters(),
                   "weights": fw.score_weights(),
                   "fit": fw.fit_scoring()}
            for name, fw in self.frameworks.items()}
        # explicit tie-break seed threaded into every launch
        self._tie_seed = int(np.uint32(
            getattr(self.config, "tie_break_seed", 0)))
        self.stats = {"scheduled": 0, "unschedulable": 0, "errors": 0,
                      "batches": 0, "attempts": 0, "launches": 0,
                      "chained_launches": 0, "round_trips": 0,
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
        self.mirror = Mirror(caps=self.caps, device=self.device)
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
        if spec.enable_topology:
            raise NotImplementedError(
                "topology batch (pod affinity / topology spread, serial "
                "scan): ROADMAP queue 1 item 2 (K3-K5)")
        if self.mirror.batch_has_host_ports(pods):
            raise NotImplementedError(
                "batch with host ports (serial scan): ROADMAP queue 1 "
                "item 2 (K3)")
        if not pcfg["filters"][FILTER_PLUGINS.index("NodeResourcesFit")]:
            raise NotImplementedError(
                "profile without NodeResourcesFit (serial scan): ROADMAP "
                "queue 1 item 2 (K3)")
        t0 = self.now()
        if state is None:
            # seed the usage chain from the freshly synced mirror
            state = extract_state(spec.cblobs, self.caps)
        else:
            self.stats["chained_launches"] += 1
        fit_strategy, fit_shape = pcfg["fit"]
        out: BatchResult = launch_batch(
            spec, self.mirror.well_known(), pcfg["weights"], self.caps,
            pcfg["filters"], serial_scan=False, state=state,
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
                self._process_deferred_events()
                return 0
            if runnable:
                inflight = self._dispatch(runnable, self._chain_eligible(
                    [qp.pod for qp in runnable]))
                if inflight is not None:
                    self._finish(inflight)
            self._drain_bind_results(wait=True)
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
                "Permit wait room (gangs): ROADMAP queue 1 item 4")
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
        """handleSchedulingFailure (schedule_one.go:1015) for a batch:
        plugin attribution from the end-state reject counts, condition
        patch, park as unschedulable. PostFilter preemption is a later
        slice (ROADMAP queue 1 item 3)."""
        for qp, reject_counts in failures:
            plugins = {FILTER_PLUGINS[i]
                       for i, c in enumerate(reject_counts) if c > 0}
            qp.unschedulable_plugins = plugins or {"NodeResourcesFit"}
            qp.unschedulable_count += 1
            qp.consecutive_errors_count = 0
            self.stats["unschedulable"] += 1
            self.hub.patch_pod_condition(qp.pod, PodCondition(
                type="PodScheduled", status="False", reason="Unschedulable",
                message=f"rejected by {sorted(plugins)}"))
            # the patch fired while this pod was in flight: park the fresh
            # object
            stored = self.hub.get_pod(qp.uid)
            if stored is not None:
                qp.pod = stored
            self.queue.add_unschedulable_if_not_present(qp)

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
        flush_all()
        self._drain_bind_results(wait=True)
        self._process_deferred_events()
        return total
