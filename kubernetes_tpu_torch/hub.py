"""In-process API hub: the storage/watch/bind surface the scheduler talks to.

A subset of the JAX package's hub.py: typed node/pod/namespace,
PodDisruptionBudget and PodGroup stores with resourceVersion bumps, LIST + WATCH-style
event delivery to registered handlers (the informer contract), the
Binding subresource, pod status patches (conditions and the nominated
node) and the preemption writes (the batched ``delete_pods`` eviction
wave, ``clear_nominated_node``). The revision journal, WAL, leases and
fencing epochs, ring slices, flow control and the other object kinds are
later slices of the port.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import (
    Namespace,
    Node,
    Pod,
    PodCondition,
    PodDisruptionBudget,
    PodGroup,
)


@dataclass
class WatchEvent:
    """One committed change: ``type`` is add / update / delete."""

    rv: int
    kind: str
    type: str
    old: object = None
    new: object = None


@dataclass
class EventHandlers:
    """cache.ResourceEventHandler equivalent. ``on_event``, when set,
    receives the whole :class:`WatchEvent` INSTEAD of the typed callbacks."""

    on_add: Optional[Callable] = None
    on_update: Optional[Callable] = None       # (old, new)
    on_delete: Optional[Callable] = None
    on_event: Optional[Callable] = None        # (WatchEvent)


def _deliver(h: EventHandlers, ev: WatchEvent) -> None:
    if h.on_event is not None:
        h.on_event(ev)
        return
    if ev.type == "add":
        if h.on_add:
            h.on_add(ev.new)
    elif ev.type == "update":
        if h.on_update:
            h.on_update(ev.old, ev.new)
    elif ev.type == "delete":
        if h.on_delete:
            h.on_delete(ev.old)


class Conflict(Exception):
    """resourceVersion conflict (optimistic concurrency)."""


class NotFound(Exception):
    pass


class Unavailable(Exception):
    """Transport-level failure: the hub could not be reached. The
    scheduler parks work instead of failing it."""


class Fenced(Exception):
    """Write carried a fencing epoch older than the newest leadership
    acquisition (leader election is a later slice of the port; the class
    exists so the bind plugin's error routing reads like the reference)."""


class _Store:
    def __init__(self, kind: str, watch_kind: str,
                 index_key: Optional[Callable] = None):
        self.kind = kind
        self.watch_kind = watch_kind
        self.objects: dict[str, object] = {}   # uid -> object
        self.handlers: list[EventHandlers] = []
        self.index_key = index_key
        self.index: dict[str, str] = {}        # key -> uid

    def index_add(self, obj) -> None:
        if self.index_key is not None:
            self.index[self.index_key(obj)] = obj.metadata.uid

    def index_remove(self, obj) -> None:
        if self.index_key is not None:
            self.index.pop(self.index_key(obj), None)

    def by_index(self, key: str):
        uid = self.index.get(key)
        return self.objects.get(uid) if uid else None


class Hub:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._last_rv = 0
        self._nodes = _Store("Node", "nodes", lambda o: o.metadata.name)
        self._pods = _Store("Pod", "pods")
        self._namespaces = _Store("Namespace", "namespaces")
        self._pdbs = _Store("PodDisruptionBudget", "pdbs")
        # gang scheduling: PodGroup declares min_member + tenant queue
        self._pod_groups = _Store("PodGroup", "pod_groups",
                                  lambda o: o.key())

    def _commit(self, store: _Store, etype: str, old, new) -> WatchEvent:
        """Stamp one revision (caller holds the lock and has mutated the
        store)."""
        self._last_rv += 1
        if new is not None:
            new.metadata.resource_version = self._last_rv
        return WatchEvent(rv=self._last_rv, kind=store.watch_kind,
                          type=etype, old=old, new=new)

    # ------------- watch registration -------------

    def _watch_store(self, store: _Store, h: EventHandlers,
                     replay: bool = True) -> int:
        """Register ``h`` and replay the store as synthetic adds under the
        lock (a consistent LIST: replayed deliveries land before any live
        event). Returns the current revision."""
        with self._lock:
            store.handlers.append(h)
            if replay:
                for o in list(store.objects.values()):
                    _deliver(h, WatchEvent(
                        rv=o.metadata.resource_version,
                        kind=store.watch_kind, type="add", new=o))
            return self._last_rv

    def watch_nodes(self, h: EventHandlers, replay: bool = True) -> int:
        return self._watch_store(self._nodes, h, replay)

    def watch_pods(self, h: EventHandlers, replay: bool = True) -> int:
        return self._watch_store(self._pods, h, replay)

    def watch_namespaces(self, h: EventHandlers, replay: bool = True) -> int:
        return self._watch_store(self._namespaces, h, replay)

    def watch_pod_groups(self, h: EventHandlers, replay: bool = True) -> int:
        return self._watch_store(self._pod_groups, h, replay)

    @staticmethod
    def _dispatch(store: _Store, ev: WatchEvent) -> None:
        """Deliver one event, never holding the hub lock (handlers take
        the scheduler's loop lock)."""
        for h in list(store.handlers):
            _deliver(h, ev)

    # ------------- generic CRUD -------------

    def _create(self, store: _Store, obj) -> None:
        with self._lock:
            uid = obj.metadata.uid
            if uid in store.objects:
                raise Conflict(f"{store.kind} {uid} already exists")
            store.objects[uid] = obj
            store.index_add(obj)
            ev = self._commit(store, "add", None, obj)
        self._dispatch(store, ev)

    def _update(self, store: _Store, obj) -> None:
        with self._lock:
            uid = obj.metadata.uid
            old = store.objects.get(uid)
            if old is None:
                raise NotFound(f"{store.kind} {uid}")
            store.objects[uid] = obj
            store.index_add(obj)
            ev = self._commit(store, "update", old, obj)
        self._dispatch(store, ev)

    def _delete(self, store: _Store, uid: str) -> None:
        with self._lock:
            old = store.objects.pop(uid, None)
            if old is None:
                raise NotFound(f"{store.kind} {uid}")
            store.index_remove(old)
            ev = self._commit(store, "delete", old, None)
        self._dispatch(store, ev)

    # ------------- nodes -------------

    def create_node(self, node: Node) -> None:
        self._create(self._nodes, node)

    def update_node(self, node: Node) -> None:
        self._update(self._nodes, node)

    def delete_node(self, uid: str) -> None:
        self._delete(self._nodes, uid)

    def get_node(self, name: str) -> Optional[Node]:
        with self._lock:
            return self._nodes.by_index(name)

    def list_nodes(self) -> list[Node]:
        with self._lock:
            return list(self._nodes.objects.values())

    # ------------- pods -------------

    def create_pod(self, pod: Pod) -> None:
        self._create(self._pods, pod)

    def update_pod(self, pod: Pod) -> None:
        self._update(self._pods, pod)

    def delete_pod(self, uid: str) -> None:
        self._delete(self._pods, uid)

    def delete_pods(self, uids: list[str]) -> list[str]:
        """Batched eviction wave: every delete committed under one lock
        acquisition, the events dispatched in commit order afterwards.
        Already-gone uids are skipped (evictions tolerate them, which makes
        a retried wave idempotent); returns the uids actually deleted, so
        the caller can tell which candidates produced a deletion event."""
        evs = []
        done: list[str] = []
        try:
            with self._lock:
                for uid in uids:
                    old = self._pods.objects.pop(uid, None)
                    if old is None:
                        continue
                    self._pods.index_remove(old)
                    evs.append(self._commit(self._pods, "delete", old, None))
                    done.append(uid)
        finally:
            for ev in evs:
                self._dispatch(self._pods, ev)
        return done

    def get_pod(self, uid: str) -> Optional[Pod]:
        with self._lock:
            return self._pods.objects.get(uid)

    def list_pods(self) -> list[Pod]:
        with self._lock:
            return list(self._pods.objects.values())

    def _swap_pod(self, old: Pod, new: Pod) -> WatchEvent:
        self._pods.objects[new.metadata.uid] = new
        return self._commit(self._pods, "update", old, new)

    def bind(self, pod: Pod, node_name: str) -> None:
        """The Binding subresource: sets spec.nodeName exactly once
        (Conflict if already bound)."""
        with self._lock:
            stored = self._pods.objects.get(pod.metadata.uid)
            if stored is None:
                raise NotFound(f"pod {pod.key()}")
            if stored.spec.node_name:
                raise Conflict(f"pod {pod.key()} already bound to "
                               f"{stored.spec.node_name}")
            new = stored.clone()
            new.spec.node_name = node_name
            ev = self._swap_pod(stored, new)
        self._dispatch(self._pods, ev)

    def patch_pod_condition(self, pod: Pod, condition: PodCondition,
                            nominated_node: str | None = None) -> None:
        """util.PatchPodStatus equivalent (schedule_one.go:1092)."""
        with self._lock:
            stored = self._pods.objects.get(pod.metadata.uid)
            if stored is None:
                return
            new = stored.clone()
            new.status.conditions = [
                c for c in new.status.conditions if c.type != condition.type
            ] + [condition]
            if nominated_node is not None:
                new.status.nominated_node_name = nominated_node
            ev = self._swap_pod(stored, new)
        self._dispatch(self._pods, ev)

    def clear_nominated_node(self, uid: str) -> None:
        """Clear status.nominatedNodeName (preemption.go prepareCandidate
        clears lower nominations through the API so they re-evaluate)."""
        with self._lock:
            stored = self._pods.objects.get(uid)
            if stored is None or not stored.status.nominated_node_name:
                return
            new = stored.clone()
            new.status.nominated_node_name = ""
            ev = self._swap_pod(stored, new)
        self._dispatch(self._pods, ev)

    # ------------- namespaces -------------

    def create_namespace(self, ns: Namespace) -> None:
        self._create(self._namespaces, ns)

    def update_namespace(self, ns: Namespace) -> None:
        self._update(self._namespaces, ns)

    def delete_namespace(self, uid: str) -> None:
        self._delete(self._namespaces, uid)

    def list_namespaces(self) -> list[Namespace]:
        with self._lock:
            return list(self._namespaces.objects.values())

    # ------------- pod disruption budgets -------------

    def create_pdb(self, pdb: PodDisruptionBudget) -> None:
        self._create(self._pdbs, pdb)

    def update_pdb(self, pdb: PodDisruptionBudget) -> None:
        self._update(self._pdbs, pdb)

    def list_pdbs(self) -> list[PodDisruptionBudget]:
        with self._lock:
            return list(self._pdbs.objects.values())

    # ------------- pod groups (gang scheduling) -------------

    def create_pod_group(self, pg: PodGroup) -> None:
        self._create(self._pod_groups, pg)

    def update_pod_group(self, pg: PodGroup) -> None:
        self._update(self._pod_groups, pg)

    def delete_pod_group(self, uid: str) -> None:
        self._delete(self._pod_groups, uid)

    def get_pod_group(self, namespace: str, name: str
                      ) -> Optional[PodGroup]:
        with self._lock:
            return self._pod_groups.by_index(f"{namespace}/{name}")

    def list_pod_groups(self) -> list[PodGroup]:
        with self._lock:
            return list(self._pod_groups.objects.values())
