"""The three-tier pending-pod queue with queueing hints.

Equivalent of kubernetes/pkg/scheduler/backend/queue/
scheduling_queue.go:147-198 (PriorityQueue), active_queue.go (in-flight
pods + concurrent-event replay), backoff_queue.go (exponential per-pod
backoff), and the event-driven requeue machinery
(MoveAllToActiveOrBackoffQueue :1129, isPodWorthRequeuing :428).

Tiers:
- activeQ    — heap ordered by the profile's QueueSort (priority desc, FIFO)
- backoffQ   — heap ordered by backoff expiry; error backoff is tracked
               separately from unschedulable backoff (types.go:394-404)
- unschedulablePods — map of pods waiting for a cluster event a QueueingHint
               says could make them schedulable

The TPU-build extension: ``pop_batch(n)`` drains up to n pods in one call —
the batch axis of the device pipeline (SURVEY.md north star) — marking all
of them in-flight with concurrent-event replay per pod.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import Pod
from kubernetes_tpu_torch.backend.heap import Heap
from kubernetes_tpu_torch.framework.interface import (
    ClusterEvent,
    ClusterEventWithHint,
    EventResource as R,
    QueueingHint,
    Status,
)

# reference defaults (scheduling_queue.go:63-80)
DEFAULT_POD_INITIAL_BACKOFF = 1.0
DEFAULT_POD_MAX_BACKOFF = 10.0
DEFAULT_MAX_IN_UNSCHEDULABLE_DURATION = 5 * 60.0


@dataclass
class QueuedPodInfo:
    """framework.QueuedPodInfo (types.go:377)."""

    pod: Pod
    timestamp: float = 0.0                 # last queue entry
    initial_attempt_timestamp: Optional[float] = None
    attempts: int = 0
    unschedulable_count: int = 0
    consecutive_errors_count: int = 0
    unschedulable_plugins: set[str] = field(default_factory=set)
    pending_plugins: set[str] = field(default_factory=set)
    gated_plugin: str = ""
    # park-index bookkeeping: the (resource, action) keys this pod is
    # filed under while parked (see PriorityQueue._park)
    park_keys: list = field(default_factory=list)
    # host Filter rejects from the last attempt (plugin -> node count);
    # merged into the failure diagnosis alongside device reject_counts
    host_reject_counts: dict[str, int] = field(default_factory=dict)

    @property
    def uid(self) -> str:
        return self.pod.metadata.uid

    def deep_copy(self) -> "QueuedPodInfo":
        return QueuedPodInfo(
            pod=self.pod, timestamp=self.timestamp,
            initial_attempt_timestamp=self.initial_attempt_timestamp,
            attempts=self.attempts,
            unschedulable_count=self.unschedulable_count,
            consecutive_errors_count=self.consecutive_errors_count,
            unschedulable_plugins=set(self.unschedulable_plugins),
            pending_plugins=set(self.pending_plugins),
            gated_plugin=self.gated_plugin)


class PriorityQueue:
    def __init__(self,
                 less_fn: Callable[[QueuedPodInfo, QueuedPodInfo], bool],
                 sort_key_fn: Optional[
                     Callable[[QueuedPodInfo], tuple]] = None,
                 pre_enqueue: Optional[Callable[[Pod], Status]] = None,
                 queueing_hints: Optional[
                     dict[str, list[ClusterEventWithHint]]] = None,
                 initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
                 max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
                 max_in_unschedulable: float =
                 DEFAULT_MAX_IN_UNSCHEDULABLE_DURATION,
                 now: Callable[[], float] = time.time):
        self._now = now
        self._less = less_fn
        self._pre_enqueue = pre_enqueue or (lambda pod: Status())
        # plugin name -> registered events+hints (buildQueueingHintMap)
        self._hints = queueing_hints or {}
        self._initial_backoff = initial_backoff
        self._max_backoff = max_backoff
        self._max_in_unschedulable = max_in_unschedulable

        self._active: Heap[QueuedPodInfo] = Heap(
            lambda qp: qp.uid, less_fn, sort_key_fn=sort_key_fn)
        self._backoff: Heap[QueuedPodInfo] = Heap(
            lambda qp: qp.uid,
            lambda a, b: self._backoff_expiry(a) < self._backoff_expiry(b),
            # expiry is a plain float: the backoff heap rides the native
            # engine (expiry recomputes on every add, same as less_fn did)
            sort_key_fn=lambda qp: (self._backoff_expiry(qp),))
        self._unschedulable: dict[str, QueuedPodInfo] = {}
        # gated pods (PreEnqueue rejections) live apart from unschedulable
        # ones: 10k parked gated pods must cost busy-path events nothing
        # (the SchedulingWhileGated workload's whole point)
        self._gated: dict[str, QueuedPodInfo] = {}
        # inverted requeue index over BOTH parked pools: (resource, action)
        # of every registered ClusterEvent of a pod's rejecting/gating
        # plugins -> uids. move_all touches only pods subscribed to a
        # matching event instead of sweeping O(parked) per event — the
        # index form of scheduling_queue.go:428's isPodWorthRequeuing
        # prefilter, needed because a Python sweep is ~100x the Go one.
        self._park_index: dict[tuple, set[str]] = {}
        self._park_all: set[str] = set()   # pods any event can requeue
        # in-flight machinery (active_queue.go:147-169): ONE shared event log
        # (seq, event, old, new) + per-pod start seq — appending an event is
        # O(1) regardless of how many pods are in flight (the reference's
        # shared inFlightEvents list, not a per-pod copy)
        self._in_flight: dict[str, int] = {}        # uid -> start seq
        self._events: list[tuple[int, ClusterEvent, object, object]] = []
        self._next_seq = 0
        self._moved_cycle = 0
        # event-burst coalescing window (ISSUE 15): non-None while a
        # caller batches requeue reaction across a burst (an eviction
        # flush's multi-delete wave) — see coalescing()
        self._coalesce: Optional[list] = None

    # ------------- backoff (backoff_queue.go:248) -------------

    def _backoff_duration(self, qp: QueuedPodInfo) -> float:
        """initial * 2^(count-1), capped; error backoff counts separately to
        protect the apiserver (types.go:394-404)."""
        count = max(qp.consecutive_errors_count, qp.unschedulable_count)
        if count == 0:
            return 0.0
        duration = self._initial_backoff * (2 ** (count - 1))
        return min(duration, self._max_backoff)

    def _backoff_expiry(self, qp: QueuedPodInfo) -> float:
        return qp.timestamp + self._backoff_duration(qp)

    def backoff_remaining(self, qp: QueuedPodInfo) -> float:
        return max(0.0, self._backoff_expiry(qp) - self._now())

    # ------------- add paths -------------

    def add(self, pod: Pod) -> None:
        """New pending pod from the informer (scheduling_queue.go Add)."""
        qp = QueuedPodInfo(pod=pod, timestamp=self._now(),
                           initial_attempt_timestamp=None)
        self._enqueue(qp)

    def _park(self, qp: QueuedPodInfo,
              pool: dict[str, QueuedPodInfo]) -> None:
        """File a pod in a parked pool + the inverted requeue index."""
        if qp.park_keys or qp.uid in self._park_all:
            # re-park without unpark would strand stale index entries
            self._unpark(qp)
        uid = qp.uid
        pool[uid] = qp
        plugins = set(qp.unschedulable_plugins)
        if qp.gated_plugin:
            plugins.add(qp.gated_plugin)
        keys = []
        wide = not plugins
        for plugin in plugins:
            regs = self._hints.get(plugin)
            if regs is None:
                # no registrations (extenders, out-of-tree): any event may
                # unstick it, like _worth_requeuing treats it
                wide = True
                continue
            for reg in regs:
                keys.append((reg.event.resource, reg.event.action_type))
        if wide:
            self._park_all.add(uid)
        for k in keys:
            self._park_index.setdefault(k, set()).add(uid)
        qp.park_keys = keys

    def _unpark(self, qp: QueuedPodInfo) -> None:
        uid = qp.uid
        self._park_all.discard(uid)
        for k in qp.park_keys:
            bucket = self._park_index.get(k)
            if bucket is not None:
                bucket.discard(uid)
                if not bucket:
                    del self._park_index[k]
        qp.park_keys = []

    def _pop_parked(self, uid: str) -> Optional[QueuedPodInfo]:
        qp = self._unschedulable.pop(uid, None)
        if qp is None:
            qp = self._gated.pop(uid, None)
        if qp is not None:
            self._unpark(qp)
        return qp

    def _enqueue(self, qp: QueuedPodInfo) -> None:
        """Run PreEnqueue gates; activeQ on success, gated pool if gated
        (scheduling_queue.go:538 runPreEnqueuePlugins)."""
        s = self._pre_enqueue(qp.pod)
        if s.is_success():
            qp.gated_plugin = ""
            self._active.add(qp)
            self._pop_parked(qp.uid)
            self._backoff.delete(qp.uid)
        else:
            qp.gated_plugin = s.plugin
            qp.unschedulable_plugins.add(s.plugin)
            self._park(qp, self._gated)

    def update(self, old: Pod, new: Pod) -> None:
        uid = new.metadata.uid
        for heap in (self._active, self._backoff):
            qp = heap.get(uid)
            if qp is not None:
                qp.pod = new
                heap.add(qp)
                return
        qp = self._unschedulable.get(uid) or self._gated.get(uid)
        if qp is not None:
            qp.pod = new
            if qp.gated_plugin:
                # gates may have been lifted by this update
                qp.timestamp = self._now()
                self._pop_parked(uid)
                self._enqueue(qp)
            return
        if uid not in self._in_flight:
            self.add(new)

    def delete(self, pod: Pod) -> None:
        uid = pod.metadata.uid
        self._active.delete(uid)
        self._backoff.delete(uid)
        self._pop_parked(uid)

    def drain_unowned(self, owns: Callable[[Pod], bool]) -> list[Pod]:
        """Scale-out rebalance support: remove and return every queued
        pod ``owns`` disclaims — active, backoff, unschedulable, and
        gated alike. The caller (the scheduler's slice sync) re-homes
        them; pods mid-cycle in ``_in_flight`` are left to finish and
        get fenced at bind if the slice really moved."""
        out: list[Pod] = []
        for heap in (self._active, self._backoff):
            for qp in list(heap.list()):
                if not owns(qp.pod):
                    heap.delete(qp.uid)
                    out.append(qp.pod)
        for pool in (self._unschedulable, self._gated):
            for uid, qp in list(pool.items()):
                if not owns(qp.pod):
                    self._pop_parked(uid)
                    out.append(qp.pod)
        return out

    # ------------- pop / in-flight -------------

    def pop(self) -> Optional[QueuedPodInfo]:
        qp = self._active.pop()
        if qp is None:
            return None
        qp.attempts += 1
        if qp.initial_attempt_timestamp is None:
            qp.initial_attempt_timestamp = self._now()
        self._in_flight[qp.uid] = self._next_seq
        return qp

    def pop_batch(self, n: int) -> list[QueuedPodInfo]:
        """Drain up to n pods for one device launch (the batch axis)."""
        out = []
        for _ in range(n):
            qp = self.pop()
            if qp is None:
                break
            out.append(qp)
        return out

    def done(self, uid: str) -> None:
        """Scheduling (+binding) finished; release in-flight events
        (schedule_one.go:305 via active_queue.go done)."""
        self._in_flight.pop(uid, None)
        self._trim_events()

    def _trim_events(self) -> None:
        """Drop log entries no in-flight pod can still replay. The min() scan
        is amortized: only when the log is empty-able or has grown past the
        trim threshold."""
        if not self._in_flight:
            self._events.clear()
        elif len(self._events) > 8192:
            low = min(self._in_flight.values())
            keep = [e for e in self._events if e[0] >= low]
            self._events = keep

    def in_flight_count(self) -> int:
        return len(self._in_flight)

    def is_parked(self, uid: str) -> bool:
        """True when the pod already re-entered a queue pool (active,
        backoff, unschedulable, or gated) — i.e. some failure handler
        owns it and it must not be driven again this cycle (the fault
        containment path uses this to skip already-parked batch peers)."""
        return (uid in self._active or uid in self._backoff
                or uid in self._unschedulable or uid in self._gated)

    # ------------- unschedulable / requeue -------------

    def add_unschedulable_if_not_present(self, qp: QueuedPodInfo,
                                         pod_scheduling_cycle: int = 0
                                         ) -> None:
        """Back from a failed cycle (scheduling_queue.go:824): replay events
        that arrived while in flight; if any hints QUEUE, skip the
        unschedulable pool and go straight to backoff/active."""
        uid = qp.uid
        start = self._in_flight.pop(uid, None)
        qp.timestamp = self._now()
        if uid in self._active or uid in self._backoff \
                or uid in self._unschedulable or uid in self._gated:
            self._trim_events()
            return
        if start is not None:
            for seq, event, old_obj, new_obj in self._events:
                if seq >= start and self._worth_requeuing(qp, event, old_obj,
                                                          new_obj):
                    self._trim_events()
                    self._requeue(qp)
                    return
        self._trim_events()
        if qp.consecutive_errors_count > 0 and not qp.unschedulable_plugins:
            # error-class failure (apiserver hiccup, bind conflict): no
            # cluster event will "fix" it — retry after backoff
            # (scheduling_queue.go:861 rejectedByError -> backoffQ)
            self._requeue(qp)
            return
        self._park(qp, self._unschedulable)

    def activate(self, pods: list[Pod]) -> None:
        """Plugin-requested activation (scheduling_queue.go:684)."""
        for pod in pods:
            qp = self._pop_parked(pod.metadata.uid)
            if qp is None:
                qp = self._backoff.delete(pod.metadata.uid)
            if qp is not None:
                qp.timestamp = self._now()
                self._enqueue(qp)

    def _worth_requeuing(self, qp: QueuedPodInfo, event: ClusterEvent,
                         old_obj, new_obj) -> bool:
        """isPodWorthRequeuing (scheduling_queue.go:428): consult the hint
        fns registered by the plugins that rejected this pod."""
        if not qp.unschedulable_plugins:
            return True  # rejected with no attribution: requeue on anything
        for plugin in qp.unschedulable_plugins:
            regs = self._hints.get(plugin)
            if regs is None:
                # a rejector with NO registrations (extenders, out-of-tree
                # plugins) cannot describe what unsticks its pods — requeue
                # on any event, like the reference treats extender rejects
                return True
            for reg in regs:
                if not reg.event.match(event):
                    continue
                if reg.queueing_hint_fn is None:
                    return True
                if reg.queueing_hint_fn(qp.pod, old_obj,
                                        new_obj) == QueueingHint.QUEUE:
                    return True
        return False

    def _requeue(self, qp: QueuedPodInfo) -> None:
        """To activeQ if backoff is over, else backoffQ
        (scheduling_queue.go:1139-1210 movePodsToActiveOrBackoffQueue)."""
        if qp.gated_plugin:
            self._park(qp, self._gated)
            return
        if self._backoff_expiry(qp) <= self._now():
            self._enqueue(qp)
        else:
            s = self._pre_enqueue(qp.pod)
            if s.is_success():
                self._backoff.add(qp)
            else:
                qp.gated_plugin = s.plugin
                self._park(qp, self._gated)

    def move_all_to_active_or_backoff(self, event: ClusterEvent,
                                      old_obj=None, new_obj=None) -> int:
        """A cluster event arrived (MoveAllToActiveOrBackoffQueue :1129).
        Also records the event in the shared in-flight log so any pod whose
        cycle fails can replay it."""
        if self._in_flight:
            self._events.append((self._next_seq, event, old_obj, new_obj))
            self._next_seq += 1
        self._moved_cycle += 1
        if self._coalesce is not None:
            # inside a coalescing window: the in-flight log above already
            # recorded the event; parked-pod reaction happens ONCE at
            # window close instead of per event
            self._coalesce.append((event, old_obj, new_obj))
            return 0
        moved = 0
        # candidates via the inverted index: distinct registered events are
        # few (tens), parked pods can be tens of thousands — only pods
        # whose plugins registered a MATCHING event are touched at all
        cands = set(self._park_all)
        for (res, action), uids in self._park_index.items():
            if ((res == R.WILDCARD or res == event.resource)
                    and action & event.action_type):
                cands |= uids
        for uid in cands:
            qp = self._gated.get(uid)
            if qp is not None:
                # gated pods re-run PreEnqueue instead of hints (the
                # matching registration got them here — e.g. the gates
                # plugin's gate-eliminated event, or DefaultPreemption's
                # victim-delete)
                s = self._pre_enqueue(qp.pod)
                if s.is_success():
                    self._pop_parked(uid)
                    qp.gated_plugin = ""
                    qp.timestamp = self._now()
                    self._enqueue(qp)
                    moved += 1
                continue
            qp = self._unschedulable.get(uid)
            if qp is None:
                continue
            if self._worth_requeuing(qp, event, old_obj, new_obj):
                self._pop_parked(uid)
                self._requeue(qp)
                moved += 1
        return moved

    def coalescing(self):
        """Context manager batching requeue reaction across an event
        BURST (an eviction flush's multi-delete wave, ISSUE 15): inside
        the window move_all_to_active_or_backoff only records events (the
        in-flight replay log is unaffected); the window close runs one
        pass where every parked candidate probes the whole burst at most
        once — O(affected pods) per wave instead of O(events x parked
        probes), and a gated pod re-runs its PreEnqueue gate once per
        wave instead of once per deletion."""
        import contextlib

        @contextlib.contextmanager
        def _window():
            if self._coalesce is not None:
                yield               # nested: the outer window owns it
                return
            self._coalesce = []
            try:
                yield
            finally:
                events, self._coalesce = self._coalesce, None
                self._move_all_batched(events)
        return _window()

    def _move_all_batched(self, events: list) -> int:
        if not events:
            return 0
        moved = 0
        cands = set(self._park_all)
        for (res, action), uids in self._park_index.items():
            for event, _old, _new in events:
                if ((res == R.WILDCARD or res == event.resource)
                        and action & event.action_type):
                    cands |= uids
                    break
        for uid in cands:
            qp = self._gated.get(uid)
            if qp is not None:
                s = self._pre_enqueue(qp.pod)
                if s.is_success():
                    self._pop_parked(uid)
                    qp.gated_plugin = ""
                    qp.timestamp = self._now()
                    self._enqueue(qp)
                    moved += 1
                continue
            qp = self._unschedulable.get(uid)
            if qp is None:
                continue
            for event, old_obj, new_obj in events:
                if self._worth_requeuing(qp, event, old_obj, new_obj):
                    self._pop_parked(uid)
                    self._requeue(qp)
                    moved += 1
                    break
        return moved

    # ------------- periodic flushes (scheduling_queue.go:378-386) -------------

    def flush_backoff_completed(self) -> int:
        """backoffQ -> activeQ for pods whose backoff expired (1s tick)."""
        moved = 0
        now = self._now()
        while True:
            head = self._backoff.peek()
            if head is None or self._backoff_expiry(head) > now:
                break
            self._backoff.pop()
            self._enqueue(head)
            moved += 1
        return moved

    def flush_unschedulable_timeout(self) -> int:
        """unschedulable pods stuck longer than the timeout requeue
        unconditionally (30s tick; 5min default timeout)."""
        now = self._now()
        moved = 0
        # gated pods are exempt: no event, no timeout ungates them
        # (the reference's flushUnschedulablePodsLeftover skips gated too)
        for uid in list(self._unschedulable):
            qp = self._unschedulable[uid]
            if now - qp.timestamp >= self._max_in_unschedulable:
                self._pop_parked(uid)
                self._requeue(qp)
                moved += 1
        return moved

    # ------------- introspection -------------

    def pending_counts(self) -> dict[str, int]:
        """pending_pods gauge split by queue (metrics.go:201)."""
        return {
            "active": len(self._active),
            "backoff": len(self._backoff),
            "unschedulable": len(self._unschedulable),
            "gated": len(self._gated),
        }

    def __len__(self) -> int:
        return (len(self._active) + len(self._backoff)
                + len(self._unschedulable) + len(self._gated))
