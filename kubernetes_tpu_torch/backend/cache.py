"""Authoritative cluster-state cache with assumed pods and incremental snapshot.

Equivalent of kubernetes/pkg/scheduler/backend/cache/cache.go: confirmed
(informer-delivered) plus *assumed* pods (optimistically placed by the
scheduling cycle before the binding round-trips, cache.go:361 AssumePod);
an MRU doubly-linked NodeInfo list ordered by ``generation`` so the per-cycle
snapshot refresh touches only changed nodes (cache.go:186 UpdateSnapshot,
moveNodeInfoToHead:113); TTL-based assumed-pod expiry (cleanupAssumedPods:730).

Thread model mirrors the reference: informer event handlers and the scheduling
loop both call in under one lock; the scheduling loop's snapshot is read
lock-free after update_snapshot returns.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import Node, Pod
from kubernetes_tpu_torch.backend.node_info import NodeInfo, next_generation
from kubernetes_tpu_torch.backend.node_tree import NodeTree
from kubernetes_tpu_torch.backend.snapshot import Snapshot


@dataclass
class _PodState:
    pod: Pod
    assumed: bool = False
    deadline: Optional[float] = None  # set by finish_binding when ttl > 0
    binding_finished: bool = False


class _NodeInfoListItem:
    __slots__ = ("info", "next", "prev")

    def __init__(self, info: NodeInfo):
        self.info = info
        self.next: Optional[_NodeInfoListItem] = None
        self.prev: Optional[_NodeInfoListItem] = None


class Cache:
    def __init__(self, ttl: float = 0.0, now: Callable[[], float] = time.time):
        """ttl: seconds an assumed pod survives after finish_binding before
        being reaped (0 = never expire, the reference default
        scheduler.go:58-62)."""
        self._lock = threading.RLock()
        self._ttl = ttl
        self._now = now
        self._nodes: dict[str, _NodeInfoListItem] = {}
        self._head: Optional[_NodeInfoListItem] = None
        self._node_tree = NodeTree()
        self._pod_states: dict[str, _PodState] = {}  # uid -> state
        self._assumed_pods: set[str] = set()
        self._namespaces: dict[str, dict[str, str]] = {}  # name -> labels
        self._ns_generation = 0
        # bumped when the set of nodes (or node-less nodeinfos) changes, so
        # update_snapshot's no-change fast path can skip the removal scan
        self._node_set_version = 0

    # ---------------- internal list maintenance ----------------

    def _move_to_head(self, item: _NodeInfoListItem) -> None:
        if item is self._head:
            return
        if item.prev is not None:
            item.prev.next = item.next
        if item.next is not None:
            item.next.prev = item.prev
        if self._head is not None:
            self._head.prev = item
        item.prev = None
        item.next = self._head
        self._head = item

    def _remove_from_list(self, item: _NodeInfoListItem) -> None:
        if item.prev is not None:
            item.prev.next = item.next
        if item.next is not None:
            item.next.prev = item.prev
        if item is self._head:
            self._head = item.next
        item.prev = item.next = None

    def _get_or_create(self, node_name: str) -> _NodeInfoListItem:
        item = self._nodes.get(node_name)
        if item is None:
            item = _NodeInfoListItem(NodeInfo())
            self._nodes[node_name] = item
            # imaginary node (pod observed before its node): park at head
            if self._head is not None:
                self._head.prev = item
            item.next = self._head
            self._head = item
        return item

    # ---------------- node ops ----------------

    def add_node(self, node: Node) -> None:
        with self._lock:
            item = self._get_or_create(node.metadata.name)
            self._node_tree.add_node(node)
            item.info.set_node(node)
            self._node_set_version += 1
            self._move_to_head(item)

    def update_node(self, old: Node, new: Node) -> None:
        with self._lock:
            item = self._get_or_create(new.metadata.name)
            self._node_tree.update_node(old, new)
            item.info.set_node(new)
            self._node_set_version += 1
            self._move_to_head(item)

    def remove_node(self, node: Node) -> None:
        with self._lock:
            item = self._nodes.get(node.metadata.name)
            if item is None:
                return
            self._node_set_version += 1
            self._node_tree.remove_node(node)
            if item.info.pods:
                # pods still assigned: keep the nodeinfo, drop the node object
                item.info.remove_node()
                self._move_to_head(item)
            else:
                self._remove_from_list(item)
                del self._nodes[node.metadata.name]

    def node_info(self, name: str):
        """The LIVE NodeInfo aggregate for one node, or None when the cache
        has never seen it. A node-less info (node deleted, assumed pods
        still draining) is returned as-is with ``info.node is None`` — the
        caller (Mirror.patch_node) treats that like a removal, matching
        update_snapshot's exclusion of node-less infos. The object is the
        cache's mutable truth: read it under the scheduler's event lock
        and don't hold it across handler returns."""
        with self._lock:
            item = self._nodes.get(name)
            return item.info if item is not None else None

    # ---------------- namespace ops ----------------

    def set_namespace(self, name: str, labels: dict[str, str]) -> None:
        """Add or update a namespace's labels (nsLister feed for affinity
        namespaceSelector unrolling)."""
        with self._lock:
            if self._namespaces.get(name) != labels:
                self._namespaces[name] = dict(labels)
                self._ns_generation = next_generation()

    def remove_namespace(self, name: str) -> None:
        with self._lock:
            if self._namespaces.pop(name, None) is not None:
                self._ns_generation = next_generation()

    # ---------------- pod ops ----------------

    def _add_pod_to_node(self, pod: Pod) -> None:
        item = self._get_or_create(pod.spec.node_name)
        item.info.add_pod(pod)
        self._move_to_head(item)

    def _remove_pod_from_node(self, pod: Pod) -> None:
        item = self._nodes.get(pod.spec.node_name)
        if item is None:
            return
        item.info.remove_pod(pod)
        if item.info.node is None and not item.info.pods:
            self._remove_from_list(item)
            del self._nodes[pod.spec.node_name]
        else:
            self._move_to_head(item)

    def assume_pod(self, pod: Pod) -> None:
        """Optimistically place a pod on pod.spec.node_name before binding
        (cache.go:361). Raises if already in cache."""
        uid = pod.metadata.uid
        with self._lock:
            if uid in self._pod_states:
                raise KeyError(f"pod {pod.key()} already in cache")
            self._add_pod_to_node(pod)
            self._pod_states[uid] = _PodState(pod=pod, assumed=True)
            self._assumed_pods.add(uid)

    def finish_binding(self, pod: Pod) -> None:
        """Start the assumed pod's expiry clock (cache.go:376)."""
        with self._lock:
            st = self._pod_states.get(pod.metadata.uid)
            if st and st.assumed:
                st.binding_finished = True
                if self._ttl > 0:
                    st.deadline = self._now() + self._ttl

    def forget_pod(self, pod: Pod) -> None:
        """Undo an assume after reserve/permit/bind failure (cache.go:404)."""
        uid = pod.metadata.uid
        with self._lock:
            st = self._pod_states.get(uid)
            if st is None:
                return
            if not st.assumed:
                raise KeyError(f"pod {pod.key()} is confirmed, cannot forget")
            self._remove_pod_from_node(st.pod)
            del self._pod_states[uid]
            self._assumed_pods.discard(uid)

    def add_pod(self, pod: Pod) -> None:
        """Informer-confirmed assigned pod (cache.go AddPod): confirms an
        assumed pod or adds a new one."""
        uid = pod.metadata.uid
        with self._lock:
            st = self._pod_states.get(uid)
            if (st is not None and st.assumed
                    and st.pod.spec.node_name == pod.spec.node_name):
                # confirm on the assumed node: the NodeInfo aggregates are
                # already right — swap the pod object in place WITHOUT
                # bumping the node generation, so the bind confirmation does
                # not force a second mirror row repack (the assume already
                # did one)
                item = self._nodes.get(pod.spec.node_name)
                if item is not None:
                    for pi in item.info.pods:
                        if pi.pod.metadata.uid == uid:
                            pi.pod = pod
                            break
                self._pod_states[uid] = _PodState(pod=pod)
                self._assumed_pods.discard(uid)
                return
            if st is not None:
                # informer truth wins, even if the node differs from what we
                # assumed; re-add of a confirmed pod is treated as an update
                self._remove_pod_from_node(st.pod)
            self._add_pod_to_node(pod)
            self._pod_states[uid] = _PodState(pod=pod)
            self._assumed_pods.discard(uid)

    def update_pod(self, old: Pod, new: Pod) -> None:
        with self._lock:
            st = self._pod_states.get(new.metadata.uid)
            if st is None:
                self.add_pod(new)
                return
            self._remove_pod_from_node(st.pod)
            self._add_pod_to_node(new)
            self._pod_states[new.metadata.uid] = _PodState(pod=new)
            self._assumed_pods.discard(new.metadata.uid)

    def remove_pod(self, pod: Pod) -> None:
        with self._lock:
            st = self._pod_states.get(pod.metadata.uid)
            if st is None:
                return
            self._remove_pod_from_node(st.pod)
            del self._pod_states[pod.metadata.uid]
            self._assumed_pods.discard(pod.metadata.uid)

    def is_assumed_pod(self, pod: Pod) -> bool:
        with self._lock:
            return pod.metadata.uid in self._assumed_pods

    def get_pod(self, pod: Pod) -> Optional[Pod]:
        with self._lock:
            st = self._pod_states.get(pod.metadata.uid)
            return st.pod if st else None

    def cleanup_assumed_pods(self) -> list[Pod]:
        """Expire assumed pods whose deadline passed (cache.go:730). Returns
        the expired pods so the caller can requeue them."""
        expired = []
        with self._lock:
            now = self._now()
            for uid in list(self._assumed_pods):
                st = self._pod_states[uid]
                if st.binding_finished and st.deadline is not None and now >= st.deadline:
                    expired.append(st.pod)
                    self._remove_pod_from_node(st.pod)
                    del self._pod_states[uid]
                    self._assumed_pods.discard(uid)
        return expired

    # ---------------- snapshot ----------------

    def update_snapshot(self, snapshot: Snapshot) -> None:
        """Incremental refresh: walk the MRU list head-first, cloning only
        NodeInfos newer than the snapshot's generation (cache.go:186-280).
        Rebuilds the zone-interleaved list only when nodes were added/removed
        or an affinity-relevant change occurred, like the reference."""
        with self._lock:
            # no-change fast path: the MRU head carries the max generation,
            # so a clean cache makes the whole refresh O(1) — _ensure_synced
            # style callers (preemption mid-drain) can call this per pod
            if ((self._head is None
                 or self._head.info.generation <= snapshot.generation)
                    and snapshot.node_set_version == self._node_set_version
                    and snapshot.ns_generation == self._ns_generation):
                return
            snap_gen = snapshot.generation
            updated_affinity = False
            item = self._head
            latest = snap_gen
            while item is not None and item.info.generation > snap_gen:
                info = item.info
                latest = max(latest, info.generation)
                if info.node is not None:
                    existing = snapshot.node_info_map.get(info.name)
                    clone = info.snapshot()
                    if existing is None or bool(existing.pods_with_affinity) != bool(
                        clone.pods_with_affinity
                    ) or bool(existing.pods_with_required_anti_affinity) != bool(
                        clone.pods_with_required_anti_affinity
                    ):
                        updated_affinity = True
                    snapshot.node_info_map[info.name] = clone
                item = item.next

            # removals: any snapshot node no longer in the cache (or node-less)
            live = {name for name, it in self._nodes.items() if it.info.node is not None}
            removed = [n for n in snapshot.node_info_map if n not in live]
            for n in removed:
                del snapshot.node_info_map[n]

            if snapshot.ns_generation != self._ns_generation:
                snapshot.namespaces = {n: dict(l)
                                       for n, l in self._namespaces.items()}
                snapshot.ns_generation = self._ns_generation

            if removed or len(snapshot.node_info_list) != len(live) or updated_affinity:
                self._rebuild_lists(snapshot)
            else:
                # same node set: refresh list entries in place from the map
                snapshot.node_info_list = [
                    snapshot.node_info_map[ni.name] for ni in snapshot.node_info_list
                ]
                self._rebuild_affinity_lists(snapshot)
            snapshot.generation = latest
            snapshot.node_set_version = self._node_set_version
            snapshot.version += 1

    def _rebuild_lists(self, snapshot: Snapshot) -> None:
        snapshot.node_info_list = []
        for name in self._node_tree.list():
            ni = snapshot.node_info_map.get(name)
            if ni is not None:
                snapshot.node_info_list.append(ni)
        self._rebuild_affinity_lists(snapshot)

    @staticmethod
    def _rebuild_affinity_lists(snapshot: Snapshot) -> None:
        snapshot.have_pods_with_affinity_list = [
            ni for ni in snapshot.node_info_list if ni.pods_with_affinity
        ]
        snapshot.have_pods_with_required_anti_affinity_list = [
            ni for ni in snapshot.node_info_list if ni.pods_with_required_anti_affinity
        ]

    # ---------------- introspection (cache debugger, metrics) ----------------

    def node_count(self) -> int:
        with self._lock:
            return sum(1 for it in self._nodes.values() if it.info.node is not None)

    def pod_count(self) -> int:
        with self._lock:
            return sum(len(it.info.pods) for it in self._nodes.values())

    def assumed_pod_count(self) -> int:
        with self._lock:
            return len(self._assumed_pods)

    def dump(self) -> dict:
        """Cache debugger surface (backend/cache/debugger): nodes + pods +
        assumed set, for the SIGUSR2-style comparer."""
        with self._lock:
            return {
                "nodes": {
                    name: {
                        "pods": [pi.pod.key() for pi in it.info.pods],
                        "requested_milli_cpu": it.info.requested.milli_cpu,
                        "generation": it.info.generation,
                    }
                    for name, it in self._nodes.items()
                },
                "assumed_pods": sorted(self._assumed_pods),
            }
