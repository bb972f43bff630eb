"""In-process API hub: the storage/watch/bind surface the scheduler talks to.

A subset of the JAX package's hub.py: typed node/pod/namespace,
PodDisruptionBudget, PodGroup, DRA (ResourceClaim, ResourceSlice,
ResourceClaimTemplate, DeviceClass) and Event stores with resourceVersion bumps, LIST + WATCH-style
event delivery to registered handlers (the informer contract), the
Binding subresource, pod status patches (conditions and the nominated
node, the claim statuses a ResourceClaimController records) and the
preemption writes (the batched ``delete_pods`` eviction
wave, ``clear_nominated_node``). Of the revision journal it keeps the pod
DELETEs (a bounded ring, ``list_changes``): a bound pod's DELETE is the
eviction outcome the learned scorer's regret reads
(learn/regret.py harvest_hub_outcomes). The rest of the journal, the WAL,
leases and fencing epochs, ring slices, flow control and the other
object kinds are later slices of the port.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import (
    Event,
    Namespace,
    Node,
    ObjectMeta,
    Pod,
    PodCondition,
    PodDisruptionBudget,
    PodGroup,
    ResourceClaim,
    ResourceSlice,
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


# pod DELETEs the journal ring keeps (list_changes)
POD_DELETE_RING = 65536


class Hub:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._last_rv = 0
        # the journal's pod DELETEs, oldest first, and the newest rv it
        # has dropped (a resume point at or below it is too old)
        self._pod_deletes: deque = deque(maxlen=POD_DELETE_RING)
        self._deletes_compacted_rv = 0
        self._nodes = _Store("Node", "nodes", lambda o: o.metadata.name)
        self._pods = _Store("Pod", "pods")
        self._namespaces = _Store("Namespace", "namespaces")
        self._pdbs = _Store("PodDisruptionBudget", "pdbs")
        # gang scheduling: PodGroup declares min_member + tenant queue
        self._pod_groups = _Store("PodGroup", "pod_groups",
                                  lambda o: o.key())
        # dynamic resource allocation
        self._claims = _Store("ResourceClaim", "resource_claims",
                              lambda o: o.key())
        self._slices = _Store("ResourceSlice", "resource_slices")
        self._claim_templates = _Store("ResourceClaimTemplate",
                                       "resource_claim_templates",
                                       lambda o: o.key())
        self._device_classes = _Store("DeviceClass", "device_classes",
                                      lambda o: o.metadata.name)
        # core/v1 Event analog, deduped by (ref, reason) with a count
        # bump (a DeviceClass whose CEL selector does not compile)
        self._events = _Store("Event", "events",
                              lambda e: f"{e.ref_kind}/{e.ref_key}"
                                        f":{e.reason}")

    def _commit(self, store: _Store, etype: str, old, new) -> WatchEvent:
        """Stamp one revision (caller holds the lock and has mutated the
        store)."""
        self._last_rv += 1
        if new is not None:
            new.metadata.resource_version = self._last_rv
        ev = WatchEvent(rv=self._last_rv, kind=store.watch_kind,
                        type=etype, old=old, new=new)
        if etype == "delete" and store is self._pods:
            if len(self._pod_deletes) == self._pod_deletes.maxlen:
                self._deletes_compacted_rv = self._pod_deletes[0].rv
            self._pod_deletes.append(ev)
        return ev

    def list_changes(self, since_rv: int, kinds: tuple = ("pods",)) -> dict:
        """The journal's changes after ``since_rv`` (the reference's
        incremental LIST): here the pod DELETEs only, rv-sorted, each
        {"rv", "kind", "type", "obj"} with the deleted object. A resume
        point older than the ring answers {"too_old": True}."""
        with self._lock:
            rv = self._last_rv
            if since_rv > rv or (self._deletes_compacted_rv
                                 and since_rv < self._deletes_compacted_rv):
                return {"too_old": True,
                        "compacted_rv": self._deletes_compacted_rv, "rv": rv}
            changes = [] if "pods" not in kinds else [
                {"rv": ev.rv, "kind": ev.kind, "type": ev.type,
                 "obj": ev.old}
                for ev in self._pod_deletes if ev.rv > since_rv]
            return {"too_old": False, "rv": rv, "changes": changes}

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

    def watch_resource_claims(self, h: EventHandlers,
                              replay: bool = True) -> int:
        return self._watch_store(self._claims, h, replay)

    def watch_resource_slices(self, h: EventHandlers,
                              replay: bool = True) -> int:
        return self._watch_store(self._slices, h, replay)

    def watch_resource_claim_templates(self, h: EventHandlers,
                                       replay: bool = True) -> int:
        return self._watch_store(self._claim_templates, h, replay)

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

    # ------------- dynamic resource allocation -------------

    def set_pod_claim_statuses(self, uid: str,
                               statuses: dict[str, str]) -> None:
        """Record generated-claim names on pod.status.resourceClaimStatuses
        (the resourceclaim controller's status patch)."""
        with self._lock:
            stored = self._pods.objects.get(uid)
            if stored is None:
                return
            new = stored.clone()
            new.status.resource_claim_statuses = dict(statuses)
            ev = self._swap_pod(stored, new)
        self._dispatch(self._pods, ev)

    def create_resource_claim(self, claim: ResourceClaim) -> None:
        self._create(self._claims, claim)

    def update_resource_claim(self, claim: ResourceClaim) -> None:
        self._update(self._claims, claim)

    def delete_resource_claim(self, uid: str) -> None:
        self._delete(self._claims, uid)

    def get_resource_claim(self, namespace: str, name: str
                           ) -> Optional[ResourceClaim]:
        with self._lock:
            return self._claims.by_index(f"{namespace}/{name}")

    def list_resource_claims(self) -> list[ResourceClaim]:
        with self._lock:
            return list(self._claims.objects.values())

    def create_resource_slice(self, sl: ResourceSlice) -> None:
        self._create(self._slices, sl)

    def delete_resource_slice(self, uid: str) -> None:
        self._delete(self._slices, uid)

    def list_resource_slices(self) -> list[ResourceSlice]:
        with self._lock:
            return list(self._slices.objects.values())

    def create_resource_claim_template(self, t) -> None:
        self._create(self._claim_templates, t)

    def get_resource_claim_template(self, namespace: str, name: str):
        with self._lock:
            return self._claim_templates.by_index(f"{namespace}/{name}")

    def create_device_class(self, dc) -> None:
        self._create(self._device_classes, dc)

    def get_device_class(self, name: str):
        with self._lock:
            return self._device_classes.by_index(name)

    def list_device_classes(self) -> list:
        with self._lock:
            return list(self._device_classes.objects.values())

    # ------------- events (core/v1 Event analog) -------------

    def record_event(self, ref_kind: str, ref_key: str, reason: str,
                     message: str) -> None:
        """Record an object-level failure/notice, deduped by
        (ref, reason): a repeat bumps ``count`` and refreshes the
        message (the reference's event aggregation), so a hot loop
        hitting the same broken object cannot flood the store."""
        with self._lock:
            key = f"{ref_kind}/{ref_key}:{reason}"
            old = self._events.by_index(key)
            if old is not None:
                new = Event(metadata=ObjectMeta(
                                name=old.metadata.name,
                                uid=old.metadata.uid),
                            ref_kind=ref_kind, ref_key=ref_key,
                            reason=reason, message=message,
                            count=old.count + 1)
                self._events.objects[new.metadata.uid] = new
                ev = self._commit(self._events, "update", old, new)
            else:
                obj = Event(metadata=ObjectMeta(
                                name=f"{ref_kind.lower()}-{reason.lower()}"
                                     f"-{self._last_rv + 1}"),
                            ref_kind=ref_kind, ref_key=ref_key,
                            reason=reason, message=message)
                self._events.objects[obj.metadata.uid] = obj
                self._events.index_add(obj)
                ev = self._commit(self._events, "add", None, obj)
        self._dispatch(self._events, ev)

    def list_events(self, ref_kind: str | None = None,
                    ref_key: str | None = None) -> list[Event]:
        with self._lock:
            out = list(self._events.objects.values())
        if ref_kind is not None:
            out = [e for e in out if e.ref_kind == ref_kind]
        if ref_key is not None:
            out = [e for e in out if e.ref_key == ref_key]
        return out
