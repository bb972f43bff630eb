"""GangScheduling: all-or-nothing admission for PodGroups (port of the JAX
package's plugins/gang.py; the capacity bound's reduction is kernel K7b,
``kernels/gang.py:gang_capacity``, on the mirror's device-resident free
matrix).

The plugin half of the gang subsystem (the queue half is
backend/jobqueue.py). Three extension points on the existing framework:

* **PreFilter** — rejects members of a gang whose remaining
  ``min_member`` provably cannot fit anywhere. The bound itself comes
  from the device: for gangs the fused packer handled, the packer's own
  capacity reduction lands in the memo (``note_device_cap``); for
  host-path gangs the reduction is dispatched ASYNC
  (``kernels.gang.gang_capacity``, K7b) and its device-to-host copy rides
  the scheduler's existing one-per-cycle verdict pull — PreFilter answers
  from the memo and returns SKIP (optimistic, one attempt of lag) while
  a fresh bound is still in flight. No blocking pull, ever.

* **Permit** — the transactional commit point of the HOST-FALLBACK
  path (gangs the device packer cannot express: topology terms,
  heterogeneous members, claims/volumes, preemption). Each member that
  clears Reserve WAITs in the framework's wait room (its node
  reservation held as an assumed pod) until ``min_member`` members have
  reserved; the member that completes the quorum allows every waiting
  peer, and all of them proceed to the fenced binder together. A
  timeout or any member's failure rolls back EVERY reservation
  atomically via ``unreserve`` — no partial gang ever occupies nodes.
  Gangs placed by the device packer bypass the quorum: the scheduler
  marks them ``device_admit``-ed (the all-or-nothing device verdict IS
  the quorum) and Permit answers allow immediately.

* **Reserve/Unreserve** — the rollback hook: an unreserved member of an
  assembling gang rejects all waiting peers, whose harvest unreserves
  them in turn (re-entry is cut by popping the assembly state first).

The coordinator instance is shared across profiles (like the DRA
manager) via the scheduler's ``gang_shared`` extra arg; the scheduler
feeds it PodGroup watch events, bound-member observations from the
informer, and poison marks from the quarantine (a poisoned member
poisons the whole gang).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import (
    LABEL_POD_GROUP,
    Pod,
    PodGroup,
    pod_group_key,
)
from kubernetes_tpu_torch.api.resources import pod_request
from kubernetes_tpu_torch.framework.interface import (
    Code,
    FilterPlugin,
    PermitPlugin,
    PreFilterPlugin,
    ReservePlugin,
    Status,
)

logger = logging.getLogger("kubernetes_tpu_torch.gang")

# a gang key whose PodGroup is missing from the local cache re-probes the
# hub at most this often — the watch feed (set_group) is the real source;
# per-scheduling-attempt RPCs from the plugin hot path would hammer a
# RemoteHub for every member of a deleted group still in the queue
GROUP_PROBE_INTERVAL_S = 5.0


class GangScheduling(PreFilterPlugin, FilterPlugin, ReservePlugin,
                     PermitPlugin):
    """The gang coordinator + its framework plugin faces."""

    NAME = "GangScheduling"

    def __init__(self, hub=None,
                 mirror_fn: Optional[Callable] = None,
                 now: Callable[[], float] = time.time):
        self.hub = hub
        self._mirror_fn = mirror_fn
        self._now = now
        self.metrics = None                 # SchedulerMetrics, wired late
        self._groups: dict[str, PodGroup] = {}
        # the per-profile wait rooms this coordinator can reach into
        # (registered by the scheduler; one per Framework)
        self._waiting_maps: list = []
        # gang key -> {"waiting": set(uid), "deadline": float}
        self._assembling: dict[str, dict] = {}
        # gang key -> uids of members the informer has seen BOUND (quorum
        # counting must survive failover: a new leader admits the tail of
        # a half-bound gang instead of re-demanding min_member fresh)
        self._bound: dict[str, set[str]] = {}
        # gang key -> {offending uid -> reason}, while members sit in
        # poison quarantine (refcounted: the gang releases only when its
        # LAST quarantined member is released/deleted)
        self._poisoned: dict[str, dict[str, str]] = {}
        # gang key -> earliest next hub probe for a missing PodGroup
        self._group_probe: dict[str, float] = {}
        # PreFilter capacity-bound memo: gang key -> (token, cap). The
        # bound's inputs are identical for every same-shaped member of a
        # gang within one mirror sync, so one device reduction serves
        # the whole gang's batch. Fed by the device packer's cap column
        # (note_device_cap) or by an ASYNC reduction whose D2H pull the
        # scheduler folds into its per-cycle verdict pull (_pending_caps)
        self._cap_cache: dict[str, tuple] = {}
        # gang key -> (token, device scalar) awaiting the next cycle's
        # pull; resolved by Scheduler._finish / the gang dispatch
        self._pending_caps: dict[str, tuple] = {}
        # gang key -> uids admitted by the device packer's all-or-nothing
        # verdict: Permit allows them without quorum assembly (the
        # verdict IS the quorum); cleared when the unit's commit ends
        self._device_admitted: dict[str, set[str]] = {}
        self.stats = {"admitted": 0, "timeouts": 0, "rollbacks": 0,
                      "device_admitted": 0}

    # ------------- scheduler-side wiring -------------

    def register_waiting_map(self, waiting_map) -> None:
        if waiting_map not in self._waiting_maps:
            self._waiting_maps.append(waiting_map)

    def set_group(self, group: PodGroup) -> None:
        self._groups[group.key()] = group
        self._group_probe.pop(group.key(), None)

    def group_of(self, key: str) -> Optional[PodGroup]:
        return self._groups.get(key)

    def remove_group(self, key: str) -> None:
        self._groups.pop(key, None)
        self._assembling.pop(key, None)
        self._bound.pop(key, None)
        self._poisoned.pop(key, None)
        self._cap_cache.pop(key, None)
        self._pending_caps.pop(key, None)
        self._device_admitted.pop(key, None)

    def note_bound(self, pod: Pod) -> None:
        key = pod_group_key(pod)
        if key is not None:
            self._bound.setdefault(key, set()).add(pod.metadata.uid)
            # a peer's confirmed bind can complete a WAITING member's
            # quorum (post-failover: the new leader reserves the tail
            # member before its informer has confirmed every old bind) —
            # without this re-check the member would sit out its permit
            # timeout and park with no event left to wake it
            self._maybe_complete(key)

    # ------------- device-packer wiring -------------

    def cap_token(self, mirror, pod: Pod) -> tuple:
        """The capacity memo's freshness token: the bound only changes
        when the free matrix's CONTENT changes or the request shape
        differs (content-keyed so a reserve/rollback wave that returns
        free to identical bytes keeps the memo — see
        Mirror.free_fingerprint)."""
        return self._token_of(mirror, mirror._res_row(pod_request(pod)))

    @staticmethod
    def _token_of(mirror, row) -> tuple:
        return (mirror.free_fingerprint(), row.tobytes())

    def note_device_cap(self, key: str, token: tuple, cap: int) -> None:
        """The fused packer's capacity column for this gang (pulled with
        its verdict): seed the PreFilter memo so the host-fallback bound
        never re-derives what the packer already computed."""
        self._cap_cache[key] = (token, int(cap))
        self._pending_caps.pop(key, None)

    def take_pending_caps(self) -> list[tuple]:
        """(key, token, device scalar) entries awaiting resolution —
        the scheduler appends the scalars to its one-per-cycle
        verdict pull and hands the values back via resolve_cap."""
        return [(key, token, arr)
                for key, (token, arr) in self._pending_caps.items()]

    def resolve_cap(self, key: str, token: tuple, cap: int) -> None:
        pend = self._pending_caps.get(key)
        if pend is not None and pend[0] == token:
            del self._pending_caps[key]
        self._cap_cache[key] = (token, int(cap))

    def device_admit(self, key: str, uids: set) -> None:
        """Mark a unit the device packer placed: Permit allows these
        members without quorum assembly (all-or-nothing was already
        proven in one launch)."""
        self._device_admitted[key] = set(uids)

    def clear_device_admit(self, key: str) -> None:
        self._device_admitted.pop(key, None)

    def bound_count(self, key: str) -> int:
        """Informer-confirmed bound members of this gang — the single
        bound-member registry; the job queue's min_member gating queries
        it instead of keeping its own copy that could drift."""
        return len(self._bound.get(key, ()))

    def note_unbound(self, pod: Pod) -> None:
        key = pod_group_key(pod)
        if key is not None:
            members = self._bound.get(key)
            if members is not None:
                members.discard(pod.metadata.uid)
                if not members:
                    del self._bound[key]

    def poison(self, key: str, reason: str, uid: str = "") -> None:
        """A member of this gang was quarantined: the whole gang is held
        out (members reject at Reserve/PreFilter) and any assembling
        reservation rolls back — a gang scheduled around its poisoned
        member would violate all-or-nothing."""
        self._poisoned.setdefault(key, {})[uid] = reason
        self._rollback(key, f"gang member quarantined: {reason}",
                       timeout=False)

    def release_poison(self, key: str, uid: str = "") -> None:
        """One quarantined member released/deleted: the gang unpoisons
        only when NO member remains in quarantine."""
        members = self._poisoned.get(key)
        if members is None:
            return
        members.pop(uid, None)
        if not members:
            del self._poisoned[key]

    def _poison_reason(self, key: str) -> Optional[str]:
        members = self._poisoned.get(key)
        if not members:
            return None
        return next(iter(members.values()))

    def poisoned_gangs(self) -> dict[str, str]:
        return {k: next(iter(v.values()))
                for k, v in self._poisoned.items() if v}

    # ------------- relevance gates -------------

    @staticmethod
    def applies(pod: Pod) -> bool:
        return LABEL_POD_GROUP in pod.metadata.labels

    def _state_of(self, pod: Pod) -> tuple[Optional[str],
                                           Optional[PodGroup],
                                           Optional[Status]]:
        key = pod_group_key(pod)
        if key is None:
            return None, None, None
        reason = self._poison_reason(key)
        if reason is not None:
            return key, None, Status.unschedulable(
                f"gang {key} quarantined: {reason}", plugin=self.NAME)
        group = self._groups.get(key)
        if group is None and self.hub is not None \
                and self._group_probe.get(key, 0.0) <= self._now():
            try:
                group = self.hub.get_pod_group(pod.metadata.namespace,
                                               pod.metadata.labels[
                                                   LABEL_POD_GROUP])
            except Exception:  # noqa: BLE001 — hub outage: park, don't
                group = None   # poison the batch from a plugin raise
            if group is not None:
                self._groups[key] = group
                self._group_probe.pop(key, None)
            else:
                self._group_probe[key] = (self._now()
                                          + GROUP_PROBE_INTERVAL_S)
        if group is None:
            return key, None, Status.unschedulable(
                f"waiting for PodGroup {key}", plugin=self.NAME)
        return key, group, None

    # ------------- PreFilter: cheap impossibility check -------------

    def pre_filter(self, state, pod: Pod, nodes) -> Status:
        key, group, bad = self._state_of(pod)
        if key is None:
            return Status.skip()
        if bad is not None:
            return bad
        # remaining members to PLACE: bound peers and peers already
        # reserved (waiting at Permit) both count — the waiters' node
        # reservations have already left free_matrix, so charging the
        # full min_member against what's left would livelock a gang
        # that exactly fits but spans scheduling batches
        st = self._assembling.get(key)
        reserved = len(st["waiting"]) if st is not None else 0
        need = max(group.min_member - len(self._bound.get(key, ()))
                   - reserved, 1)
        mirror = self._mirror_fn() if self._mirror_fn else None
        # the FREE-capacity bound is only provable impossibility for a
        # gang that cannot preempt: a positive-priority gang may open
        # capacity by evicting lower-priority pods (whole lower gangs via
        # the evaluator), so it must reach PostFilter, not park here
        if mirror is not None and pod.priority() <= 0:
            # one reduction per gang per mirror sync, not per member:
            # the token pins the memo to this request shape and blob
            # state (free_matrix only changes at mirror.sync). The memo
            # is fed by the device packer's cap column or by an ASYNC
            # reduction (K7b over the mirror's device-resident free)
            # pulled with the scheduler's per-cycle verdict pull — a memo
            # miss answers SKIP (optimistic) while the fresh bound is in
            # flight, never a blocking pull
            row = mirror._res_row(pod_request(pod))
            token = self._token_of(mirror, row)
            cached = self._cap_cache.get(key)
            if cached is not None and cached[0] == token:
                if cached[1] < need:
                    return Status.unschedulable(
                        f"gang {key}: cluster capacity bound {cached[1]} "
                        f"< min_member remainder {need}", plugin=self.NAME)
            else:
                pend = self._pending_caps.get(key)
                if pend is None or pend[0] != token:
                    self._pending_caps[key] = (
                        token, self.dispatch_capacity(mirror, row))
        return Status.skip()    # skip => the per-node filter never runs

    @staticmethod
    def dispatch_capacity(mirror, row):
        """K7b over the mirror's device-resident free matrix for a request
        row (the one the memo's token was formed from): a 0-d device
        tensor, not synchronised. The row rides in the launch's argument
        block, so a PreFilter makes no host-to-device copy."""
        from kubernetes_tpu_torch.kernels.gang import gang_capacity

        return gang_capacity(mirror.device_free(), row)

    def filter(self, state, pod: Pod, node_info) -> Status:
        return Status()         # unreachable: pre_filter always skips

    # ------------- Reserve / the rollback hook -------------

    def reserve(self, state, pod: Pod, node_name: str) -> Status:
        key, _group, bad = self._state_of(pod)
        if key is None:
            return Status()
        return bad if bad is not None else Status()

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        """A gang member's reservation was undone (permit timeout, permit
        rejection, reserve failure of a later plugin, pod deletion):
        roll back the rest of the assembling gang."""
        key = pod_group_key(pod)
        if key is None:
            return
        st = self._assembling.get(key)
        if st is None:
            return              # gang already admitted (or rolled back)
        uid = pod.metadata.uid
        in_gang = uid in st["waiting"]
        st["waiting"].discard(uid)
        if in_gang:
            timed_out = self._now() >= st["deadline"]
            self._rollback(key, "gang member "
                           f"{pod.key()} unreserved; rolling back gang",
                           timeout=timed_out)

    def _rollback(self, key: str, msg: str, timeout: bool) -> None:
        st = self._assembling.pop(key, None)
        if st is None:
            return              # nothing assembling (already rolled back)
        self.stats["rollbacks"] += 1
        if timeout:
            self.stats["timeouts"] += 1
        m = self.metrics
        if m is not None:
            m.gang_rollbacks.inc()
            if timeout:
                m.gang_timeouts.inc()
        logger.info("gang %s rollback (%s waiting): %s",
                    key, len(st["waiting"]), msg)
        for uid in list(st["waiting"]):
            for wmap in self._waiting_maps:
                wp = wmap.get(uid)
                if wp is not None:
                    wp.reject(self.NAME, msg)
                    break

    # ------------- Permit: quorum assembly -------------

    def permit(self, state, pod: Pod, node_name: str
               ) -> tuple[Status, float]:
        key, group, bad = self._state_of(pod)
        if key is None:
            return Status.skip(), 0.0
        da = self._device_admitted.get(key)
        if da is not None and pod.metadata.uid in da:
            # placed by the fused device packer: the all-or-nothing
            # verdict already proved the whole unit fits — no quorum
            # assembly, straight to the fenced binder
            return Status(), 0.0
        if bad is not None:
            return bad, 0.0
        now = self._now()
        st = self._assembling.get(key)
        if st is None:
            st = self._assembling[key] = {
                "waiting": set(),
                "deadline": now + max(group.schedule_timeout_seconds, 0.1)}
        quorum = (len(st["waiting"]) + 1
                  + len(self._bound.get(key, ())))
        if quorum >= max(group.min_member, 1):
            # quorum reached: this member completes the gang — allow
            # every waiting peer; all proceed to the binding cycle
            self._admit(key, st)
            return Status(), 0.0
        st["waiting"].add(pod.metadata.uid)
        remaining = max(st["deadline"] - now, 0.1)
        return Status(code=Code.WAIT, plugin=self.NAME), remaining

    def _admit(self, key: str, st: dict) -> None:
        waiting = st["waiting"]
        self._assembling.pop(key, None)
        for uid in waiting:
            for wmap in self._waiting_maps:
                wp = wmap.get(uid)
                if wp is not None:
                    wp.allow(self.NAME)
                    break
        self.stats["admitted"] += 1
        if self.metrics is not None:
            self.metrics.gang_admitted.inc()

    def _maybe_complete(self, key: str) -> None:
        """Informer-driven quorum re-check: waiting members + confirmed
        bound members may now satisfy min_member."""
        st = self._assembling.get(key)
        group = self._groups.get(key)
        if st is None or group is None or not st["waiting"]:
            return
        quorum = len(st["waiting"]) + len(self._bound.get(key, ()))
        if quorum >= max(group.min_member, 1):
            self._admit(key, st)

    # ------------- introspection -------------

    def debug_state(self) -> dict:
        return {
            "assembling": {
                key: {"waiting": len(st["waiting"]),
                      "deadline": st["deadline"]}
                for key, st in self._assembling.items()},
            "bound_members": {k: len(v) for k, v in self._bound.items()},
            "poisoned": self.poisoned_gangs(),
            "pending_caps": len(self._pending_caps),
            "stats": dict(self.stats),
        }
