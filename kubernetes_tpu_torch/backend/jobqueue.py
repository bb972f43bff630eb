"""The multi-tenant job-queue layer in front of the activeQ (a copy of the
JAX package's backend/jobqueue.py, which imports no JAX: the port keeps
its own).

What Kant (PAPERS.md) calls job-level queues, grafted onto the batched
scheduling core: pods carrying the tenant label (``LABEL_QUEUE``) or a
gang label (``LABEL_POD_GROUP``) are held here — NOT in the
PriorityQueue — until their tenant's turn and quota admit them. Release
order across tenants is **weighted deficit round robin** (each tenant
accrues ``weight x quantum`` credit per round and spends one credit per
pod released), so a 2:1 weight ratio yields a 2:1 admission ratio under
contention without starving anyone. Quota is **admission-time
reservation** (the Kueue discipline): a tenant's requests-based usage
(api.resources.pod_request) is charged when its pods are released into
the scheduling batch (or observed already bound at startup replay) and
credited back when they are deleted; a unit that would exceed quota
stays queued without blocking the tenant's smaller units or any other
tenant.

Gang-aware release: pods of one PodGroup form a single release **unit**
that becomes eligible only when the group object is known, at least
``min_member`` members are present, and the whole unit fits the
tenant's remaining quota — the queue half of all-or-nothing admission
(the commit half lives in plugins/gang.py and the device gang packer).
Pods whose group has not arrived yet park in an orphan pool and join
their tenant when it does.

Gang-aware backfill: an ELIGIBLE gang waiting only on DRR credit at the
head of its tenant's queue earmarks the deficit (it accrues for the
gang, never spent by others — the bounded-wait guarantee), while
SINGLE-pod jobs behind it flow around on **backfill debt** capped at
one blocked-gang's cost; the debt repays from the deficit the moment
the gang releases, so the contended admission ratio converges back to
the configured weights (sibling gangs never ride debt — the contended
gang ratio stays the weight ratio).

Pods with neither label never touch this layer: the scheduler routes
them straight to the PriorityQueue, and the per-cycle release step is
gated on ``active`` — one attribute read — so the non-gang hot path
pays nothing.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from itertools import islice
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import (
    LABEL_POD_GROUP,
    LABEL_QUEUE,
    Pod,
    PodGroup,
    pod_group_key,
)
from kubernetes_tpu_torch.api.resources import Resource, pod_request

DEFAULT_TENANT = "default"

# DRR credit granted per tenant per round, scaled by weight; cost is one
# credit per pod, so weights read directly as admission ratios
DRR_QUANTUM = 1.0


class _Unit:
    """One release unit: a single pod, or a (possibly still assembling)
    gang of pods sharing a PodGroup."""

    __slots__ = ("gang_key", "pods", "seq")

    def __init__(self, gang_key: Optional[str], seq: int):
        self.gang_key = gang_key
        self.pods: "OrderedDict[str, Pod]" = OrderedDict()  # uid -> pod
        self.seq = seq

    def __len__(self) -> int:
        return len(self.pods)


class _Tenant:
    def __init__(self, name: str, weight: float = 1.0,
                 quota: Optional[Resource] = None,
                 quota_pods: int = 0):
        self.name = name
        self.weight = max(weight, 0.0) or 1.0
        self.quota = quota                  # None = unlimited
        self.quota_pods = quota_pods        # 0 = unlimited
        self.usage = Resource()
        self.usage_pods = 0
        self.deficit = 0.0
        # gang-aware backfill debt: pods released AROUND a credit-gated
        # gang at the head of this tenant's queue (charged here, not to
        # the deficit the gang is accruing), repaid from the deficit
        # after the gang releases so long-run ratios converge to weight
        self.backfill_debt = 0.0
        # a full scan found nothing releasable and nothing awaiting mere
        # credit (all units quota-blocked or assembling): the tenant's
        # turn is SKIPPED until an event that could unblock it (a pod
        # added, its group arriving, a quota credit, a bound member) —
        # re-probing a 300-unit blocked backlog every DRR rotation was
        # the QuotaExhaustionChurn hot spot
        self.idle = False
        # release order within the tenant: FIFO over units
        self.units: "OrderedDict[str, _Unit]" = OrderedDict()  # key -> unit
        # admission bookkeeping
        self.admitted = 0                   # pods released, lifetime
        # pods released while ANOTHER tenant also had backlog: under
        # contention these track the configured weight ratios (the
        # fairness number the gang-storm bench publishes — lifetime
        # totals converge to 1:1 once the faster tenant drains)
        self.contended_admitted = 0
        self.quota_blocked = 0              # release attempts quota denied

    def depth(self) -> int:
        return sum(len(u) for u in self.units.values())

    def fits_quota(self, req: Resource, n_pods: int) -> bool:
        if self.quota_pods and self.usage_pods + n_pods > self.quota_pods:
            return False
        q = self.quota
        if q is None:
            return True
        u = self.usage
        if u.milli_cpu + req.milli_cpu > q.milli_cpu > 0:
            return False
        if u.memory + req.memory > q.memory > 0:
            return False
        if u.ephemeral_storage + req.ephemeral_storage \
                > q.ephemeral_storage > 0:
            return False
        for k, v in req.scalar.items():
            cap = q.scalar.get(k, 0)
            if cap and u.scalar.get(k, 0) + v > cap:
                return False
        return True


def _unit_request(unit: _Unit) -> Resource:
    total = Resource()
    for pod in unit.pods.values():
        total.add(pod_request(pod))
    return total


class JobQueue:
    """Tenant queues + DRR release + quota accounting + gang gating."""

    def __init__(self, tenants: Optional[dict] = None,
                 now: Callable[[], float] = time.time,
                 bound_fn: Optional[Callable[[str], int]] = None):
        self._now = now
        self._tenants: "OrderedDict[str, _Tenant]" = OrderedDict()
        self._groups: dict[str, PodGroup] = {}       # gang key -> group
        # gang key -> count of members the informer has seen BOUND:
        # min_member gating must survive failover — a new leader releases
        # the TAIL of a half-bound gang (min_member minus bound) instead
        # of holding it behind a quorum of queued members that can never
        # assemble. The registry itself lives in the gang coordinator
        # (plugins/gang.py) — one copy, queried here — so the two quorum
        # counts cannot drift. None (standalone queue) counts zero bound.
        self._bound_fn = bound_fn
        # gang units whose PodGroup has not arrived: gang key -> unit
        self._orphans: dict[str, _Unit] = {}
        # BOUND gang members seen before their PodGroup (informer replays
        # pods before groups on restart): gang key -> uid -> pod. Their
        # quota charge is deferred to set_group — charging by the pod's
        # own label would misattribute the usage to the wrong tenant,
        # and the charge-once guard would make that permanent
        self._pending_bound: dict[str, dict[str, Pod]] = {}
        # uid -> (tenant name | None, unit key) for queued pods;
        # tenant None = orphan pool
        self._where: dict[str, tuple[Optional[str], str]] = {}
        # uids whose quota reservation is live (admitted or seen bound)
        self._charged: dict[str, tuple[str, Resource]] = {}
        self._seq = 0
        self._rr: list[str] = []            # DRR rotation order
        self._rr_i = 0
        # the scheduler's per-cycle gate: True once any tenant/gang pod
        # or group has ever been seen (one attribute read on hot path)
        self.active = False
        # brownout parking (scheduler overload self-protection): parked
        # tenants sit out the DRR rotation entirely — no releases, no
        # credit accrual (parking must not bank deficit the tenant
        # bursts through the moment pressure clears)
        self.parked: set[str] = set()
        for name, cfg in (tenants or {}).items():
            self.configure_tenant(name, **cfg)

    # ------------- configuration / groups -------------

    def configure_tenant(self, name: str, weight: float = 1.0,
                         quota: Optional[dict] = None) -> None:
        q = None
        q_pods = 0
        if quota:
            q = Resource.from_map({k: str(v) for k, v in quota.items()})
            q_pods = q.allowed_pod_number
        t = self._tenants.get(name)
        if t is None:
            self._tenants[name] = _Tenant(name, weight, q, q_pods)
            self._rr.append(name)
        else:
            t.weight = max(weight, 0.0) or 1.0
            t.quota, t.quota_pods = q, q_pods
            t.idle = False          # quota change may unblock the scan
        self.active = True

    def set_group(self, group: PodGroup) -> None:
        """PodGroup arrived/changed: adopt any orphaned members into the
        group's tenant queue."""
        key = group.key()
        self._groups[key] = group
        self.active = True
        t = self._tenant_for_name(group.queue)
        t.idle = False              # its gang may now be releasable
        # re-home a unit queued under any OTHER tenant (the group's queue
        # changed, or members routed by pod label before the group
        # arrived): a gang split across tenants can never assemble
        # min_member in either half, so the group's queue wins and the
        # halves merge
        for other in self._tenants.values():
            if other is t:
                continue
            stray = other.units.pop(key, None)
            if stray is None:
                continue
            home = t.units.get(key)
            if home is None:
                t.units[key] = stray
            else:
                home.pods.update(stray.pods)
            for uid in stray.pods:
                self._where[uid] = (t.name, key)
        orphan = self._orphans.pop(key, None)
        if orphan is not None:
            home = t.units.get(key)
            if home is None:
                t.units[key] = orphan
            else:
                home.pods.update(orphan.pods)
                orphan = home
            for uid in orphan.pods:
                self._where[uid] = (t.name, key)
        # charge bound members whose quota reservation waited on the
        # group's (authoritative) tenant
        pending = self._pending_bound.pop(key, None)
        if pending is not None:
            for pod in pending.values():
                self.note_bound(pod)

    def remove_group(self, key: str) -> None:
        self._groups.pop(key, None)
        # a deleted PodGroup must not wedge its queued members behind an
        # _eligible that can never pass again: the unit returns to the
        # orphan pool (the mirror of set_group's adoption), where it
        # re-joins a tenant if the group is re-created
        for t in self._tenants.values():
            unit = t.units.pop(key, None)
            if unit is not None:
                self._orphans[key] = unit
                for uid in unit.pods:
                    self._where[uid] = (None, key)
                break

    def group(self, key: str) -> Optional[PodGroup]:
        return self._groups.get(key)

    # ------------- routing -------------

    @staticmethod
    def wants(pod: Pod) -> bool:
        """Does this pod route through the job-queue layer? One/two dict
        probes — the whole tax non-tenant pods pay."""
        labels = pod.metadata.labels
        return LABEL_QUEUE in labels or LABEL_POD_GROUP in labels

    def holds(self, uid: str) -> bool:
        return uid in self._where

    def _tenant_for_name(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = _Tenant(name)
            self._tenants[name] = t
            self._rr.append(name)
        return t

    def _tenant_of(self, pod: Pod, group: Optional[PodGroup]) -> str:
        # the PodGroup's queue is authoritative for gang members:
        # routing by per-pod labels would split a gang with
        # inconsistent/missing labels into same-keyed units under
        # several tenants, none of which could ever reach min_member
        if group is not None:
            return group.queue
        name = pod.metadata.labels.get(LABEL_QUEUE)
        if name:
            return name
        return DEFAULT_TENANT

    # ------------- add / update / remove -------------

    def add(self, pod: Pod) -> None:
        """Queue one tenant/gang pod (idempotent per uid)."""
        self.active = True
        uid = pod.metadata.uid
        if uid in self._where:
            self.update(pod)
            return
        gang = pod_group_key(pod)
        if gang is not None:
            group = self._groups.get(gang)
            if group is None:
                unit = self._orphans.get(gang)
                if unit is None:
                    self._seq += 1
                    unit = self._orphans[gang] = _Unit(gang, self._seq)
                unit.pods[uid] = pod
                self._where[uid] = (None, gang)
                return
            t = self._tenant_for_name(self._tenant_of(pod, group))
            unit = t.units.get(gang)
            if unit is None:
                self._seq += 1
                unit = t.units[gang] = _Unit(gang, self._seq)
            unit.pods[uid] = pod
            self._where[uid] = (t.name, gang)
            t.idle = False          # the gang may now be assembled
            return
        t = self._tenant_for_name(self._tenant_of(pod, None))
        self._seq += 1
        key = f"pod:{uid}"
        unit = t.units[key] = _Unit(None, self._seq)
        unit.pods[uid] = pod
        self._where[uid] = (t.name, key)
        t.idle = False              # fresh releasable work

    def update(self, pod: Pod) -> None:
        where = self._where.get(pod.metadata.uid)
        if where is None:
            self.add(pod)
            return
        tenant, key = where
        pool = (self._orphans if tenant is None
                else self._tenants[tenant].units)
        unit = pool.get(key)
        if unit is not None and pod.metadata.uid in unit.pods:
            unit.pods[pod.metadata.uid] = pod

    def remove(self, pod: Pod) -> None:
        """Pod deleted (or left our jurisdiction): drop from any queue
        and credit back its quota reservation."""
        uid = pod.metadata.uid
        where = self._where.pop(uid, None)
        if where is not None:
            tenant, key = where
            pool = (self._orphans if tenant is None
                    else self._tenants[tenant].units)
            unit = pool.get(key)
            if unit is not None:
                unit.pods.pop(uid, None)
                if not unit.pods:
                    pool.pop(key, None)
        gang = pod_group_key(pod)
        if gang is not None:
            pending = self._pending_bound.get(gang)
            if pending is not None:
                pending.pop(uid, None)
                if not pending:
                    del self._pending_bound[gang]
        charged = self._charged.pop(uid, None)
        if charged is not None:
            tname, req = charged
            t = self._tenants.get(tname)
            if t is not None:
                t.usage.sub(req)
                t.usage_pods -= 1
                t.idle = False      # quota credit may unblock the scan
        if where is not None and where[0] is not None:
            t = self._tenants.get(where[0])
            if t is not None:
                t.idle = False      # a shrunk unit may now fit quota

    def drain_unowned(self, owns: Callable[[Pod], bool]) -> list[Pod]:
        """Scale-out rebalance support: remove and return every queued
        pod whose UNIT ``owns`` disclaims. Judged per unit, not per
        member — a gang routes whole by its PodGroup's ring slot
        (``pod_group_key`` carries the group's namespace, the hash
        input), so a rebalance mid-assembly re-homes the entire unit to
        the new owner instead of splitting members across replicas, the
        same never-split discipline ``set_group`` enforces across
        tenants. ``remove`` per member keeps the quota credit and
        pending-bound bookkeeping on the normal path."""
        out: list[Pod] = []
        pools = [t.units for t in self._tenants.values()]
        pools.append(self._orphans)
        for pool in pools:
            for unit in list(pool.values()):
                pods = list(unit.pods.values())
                if not pods or owns(pods[0]):
                    continue
                for pod in pods:
                    self.remove(pod)
                    out.append(pod)
        return out

    def note_bound(self, pod: Pod) -> None:
        """An already-bound tenant pod surfaced through the informer
        (startup replay / foreign bind): reserve its quota so admission
        accounting survives a scheduler restart."""
        uid = pod.metadata.uid
        if uid in self._charged:
            return
        self.active = True
        gang = pod_group_key(pod)
        group = self._groups.get(gang) if gang else None
        if gang is not None and group is None:
            # group not seen yet: defer the charge to set_group (the
            # group's queue is the authoritative tenant — see
            # _pending_bound)
            self._pending_bound.setdefault(gang, {})[uid] = pod
            return
        t = self._tenant_for_name(self._tenant_of(pod, group))
        req = pod_request(pod)
        t.usage.add(req)
        t.usage_pods += 1
        self._charged[uid] = (t.name, req)
        t.idle = False              # bound member: gang quorum moved

    # ------------- release (the DRR pop order) -------------

    def _eligible(self, t: _Tenant, unit: _Unit,
                  blocked_counted: Optional[set] = None) -> bool:
        """Is this unit releasable now? Gangs need their group object,
        min_member present members, and whole-unit quota fit; single
        pods just need quota. ``blocked_counted`` dedups the
        quota_blocked counter to one denial per unit per release() call
        (the same blocked head unit is re-probed every DRR round)."""
        if unit.gang_key is not None:
            group = self._groups.get(unit.gang_key)
            if group is None:
                return False
            # members the informer already saw bound count toward the
            # quorum: after failover the tail of a half-bound gang must
            # release (the same registry the Permit plugin's quorum uses)
            bound = (self._bound_fn(unit.gang_key)
                     if self._bound_fn is not None else 0)
            if len(unit) < max(group.min_member - bound, 1):
                return False
        req = _unit_request(unit)
        if not t.fits_quota(req, len(unit)):
            if blocked_counted is None or unit.seq not in blocked_counted:
                t.quota_blocked += 1
                if blocked_counted is not None:
                    blocked_counted.add(unit.seq)
            return False
        return True

    def _release_unit(self, t: _Tenant, key: str, unit: _Unit,
                      pq) -> int:
        t.units.pop(key, None)
        for uid, pod in unit.pods.items():
            self._where.pop(uid, None)
            if uid not in self._charged:    # charge-once per pod lifetime
                req = pod_request(pod)
                t.usage.add(req)
                t.usage_pods += 1
                self._charged[uid] = (t.name, req)
            pq.add(pod)
        t.admitted += len(unit)
        return len(unit)

    def was_admitted(self, uid: str) -> bool:
        """True once a pod's quota reservation is live (released into the
        scheduling batch, or observed bound): re-entries (relist replay,
        quarantine release) bypass the admission gate instead of being
        re-held behind min_member they already cleared."""
        return uid in self._charged

    def release(self, pq, budget: int = 256) -> int:
        """Admit up to ``budget`` pods into the PriorityQueue in weighted
        deficit-round-robin order across tenants; returns pods released.
        A gang unit releases whole or not at all (its cost may overdraw
        the remaining budget by design — splitting it would violate
        all-or-nothing admission)."""
        if not self._rr:
            return 0
        released = 0
        blocked_counted: set = set()
        # O(budget) guard: walk at most this many HEAD units per tenant
        # per round — an ineligible unit beyond the cap shadows later
        # ones until the head drains, which keeps a 100k-pod backlog
        # from costing a full scan every scheduling cycle
        scan_cap = max(budget * 4, 512)
        # one full rotation with credit accrual, repeated while progress
        # is being made (a tenant with deep backlog keeps its deficit)
        stalled_rounds = 0
        n = len(self._rr)
        while released < budget and stalled_rounds < 2:
            progressed = False
            # credit fast-forward: rounds until the NEAREST credit-gated
            # eligible gang could release (DRR rounds are virtual time —
            # when a rotation releases nothing, spinning real scheduling
            # cycles to accrue one quantum per call is pure dribble; all
            # tenants advance the SAME rounds, so ratios are untouched)
            ff_rounds = None
            for _ in range(n):
                name = self._rr[self._rr_i % len(self._rr)]
                self._rr_i += 1
                t = self._tenants[name]
                if name in self.parked:
                    t.deficit = 0.0     # parked must not bank credit
                    continue
                if not t.units:
                    # no backlog: credit must not bank, and backfill
                    # debt has no counterparty left to repay
                    t.deficit = 0.0
                    t.backfill_debt = 0.0
                    continue
                if t.idle:
                    # fully blocked backlog, nothing changed since the
                    # last full scan: skip the turn (deficit stays
                    # zeroed — blocked must not bank credit)
                    continue
                contended = any(o.units for o in self._tenants.values()
                                if o is not t)
                t.deficit += t.weight * DRR_QUANTUM
                # walk units in FIFO order, skipping ineligible ones
                # (an assembling gang must not block singles behind it)
                any_eligible = False
                budget_cut = False
                # gang-aware backfill: the first credit-gated gang on
                # this turn EARMARKS the deficit (it keeps accruing for
                # the gang, untouched); strictly smaller units behind it
                # may still flow, charged to bounded backfill debt
                gated_cost = 0
                for key in list(islice(t.units, scan_cap)):
                    if released >= budget:
                        budget_cut = True
                        break
                    unit = t.units.get(key)
                    if unit is None \
                            or not self._eligible(t, unit,
                                                  blocked_counted):
                        continue
                    any_eligible = True
                    cost = len(unit)
                    if contended:
                        if gated_cost:
                            # backfill around the earmarked gang:
                            # SINGLE-pod jobs only (a sibling gang
                            # riding debt would bend the contended
                            # gang-admission ratio off the configured
                            # weights), on debt capped at one
                            # blocked-gang's cost — the gang's release
                            # round is untouched (its deficit accrues
                            # whole), and the debt is repaid from
                            # post-release deficit so the contended
                            # ratio converges back to weight
                            if unit.gang_key is not None \
                                    or cost >= gated_cost \
                                    or t.backfill_debt + cost > gated_cost:
                                continue
                            t.backfill_debt += cost
                        else:
                            # credit gates releases only under
                            # contention — fairness has no counterparty
                            # when this tenant alone has backlog
                            if t.deficit < 1.0:
                                # eligible work awaits credit (e.g. the
                                # deficit is deep negative after a big
                                # gang's overdraw): record how far the
                                # virtual clock must advance for THIS
                                # head unit so an unproductive rotation
                                # can fast-forward instead of dribbling
                                need_credit = (min(cost, t.weight * 4)
                                               if cost > 1 else 1.0) \
                                    - t.deficit
                                rounds = need_credit / t.weight
                                if ff_rounds is None \
                                        or rounds < ff_rounds:
                                    ff_rounds = rounds
                                break
                            if cost > t.deficit and cost > 1 \
                                    and t.deficit < min(cost,
                                                        t.weight * 4):
                                # gang bigger than remaining credit:
                                # stop SPENDING (deficit accrues to the
                                # gang — singles must not spend it back
                                # to zero every round and starve it) but
                                # keep scanning for backfill
                                gated_cost = cost
                                need_credit = (min(cost, t.weight * 4)
                                               - t.deficit)
                                rounds = need_credit / t.weight
                                if ff_rounds is None or rounds < ff_rounds:
                                    ff_rounds = rounds
                                continue
                            t.deficit -= cost
                            if unit.gang_key is not None \
                                    and t.backfill_debt > 0.0:
                                # a gang released: repay backfill debt
                                # from what its earmark left behind —
                                # only from POSITIVE deficit (a big
                                # gang's overdraw leaves it negative;
                                # "repaying" from that would forgive
                                # the overdraw and inflate the debt)
                                pay = min(max(t.deficit, 0.0),
                                          t.backfill_debt)
                                t.deficit -= pay
                                t.backfill_debt -= pay
                    else:
                        t.deficit = 0.0
                        t.backfill_debt = 0.0
                    n_rel = self._release_unit(t, key, unit, pq)
                    released += n_rel
                    if contended:
                        t.contended_admitted += n_rel
                    progressed = True
                if not any_eligible and not budget_cut:
                    # quota-blocked / assembling backlog must not BANK
                    # credit (classic DRR zeroes an unproductive turn):
                    # banked deficit would let the tenant burst past its
                    # weight ratio the moment its units free up. Credit
                    # persists only while an ELIGIBLE unit awaits it.
                    t.deficit = 0.0
                    if gated_cost == 0 and len(t.units) <= scan_cap:
                        # the WHOLE backlog was scanned and every unit
                        # is quota-blocked or assembling: park the
                        # tenant until an unblocking event wakes it
                        t.idle = True
                if released >= budget:
                    break
            if not progressed and ff_rounds is not None and ff_rounds > 0:
                # nothing released but a credit-gated gang is waiting:
                # fast-forward the virtual clock just far enough that it
                # releases next rotation — every backlogged tenant
                # accrues the same rounds, preserving the weight ratios
                # exactly while cutting the one-quantum-per-call dribble
                adv = float(int(ff_rounds) + (ff_rounds % 1.0 > 0.0))
                for name in self._rr:
                    t = self._tenants[name]
                    # idle (fully blocked) tenants sit the rounds out:
                    # crediting them would BANK deficit the moment
                    # their quota frees — the invariant the zeroed
                    # unproductive turn enforces
                    if t.units and not t.idle \
                            and name not in self.parked:
                        t.deficit += t.weight * DRR_QUANTUM * adv
                progressed = True
            stalled_rounds = 0 if progressed else stalled_rounds + 1
        return released

    # ------------- brownout parking -------------

    def park_below(self, max_weight: float) -> list[str]:
        """Park every tenant whose weight is strictly below
        ``max_weight`` — the best-effort tier by the convention that
        weight encodes priority class. Parked tenants keep their
        backlog and quota charges; they simply stop releasing. Returns
        the names newly parked (sorted, for logs)."""
        newly = []
        for name, t in self._tenants.items():
            if t.weight < max_weight and name not in self.parked:
                self.parked.add(name)
                newly.append(name)
        return sorted(newly)

    def unpark_all(self) -> list[str]:
        """Brownout exit: every parked tenant rejoins the rotation.
        Idle flags clear so the next release() re-probes their
        backlogs. Returns the names freed (sorted)."""
        freed = sorted(self.parked)
        self.parked.clear()
        for name in freed:
            t = self._tenants.get(name)
            if t is not None:
                t.idle = False
        return freed

    # ------------- introspection -------------

    def pending_count(self) -> int:
        return (sum(t.depth() for t in self._tenants.values())
                + sum(len(u) for u in self._orphans.values()))

    def __len__(self) -> int:
        return self.pending_count()

    def tenant_stats(self) -> dict[str, dict]:
        """Per-tenant depth/usage/admission counters (metrics + debug)."""
        out = {}
        for name, t in self._tenants.items():
            out[name] = {
                "weight": t.weight,
                "parked": name in self.parked,
                "depth": t.depth(),
                "admitted": t.admitted,
                "contended_admitted": t.contended_admitted,
                "quota_blocked": t.quota_blocked,
                "backfill_debt": round(t.backfill_debt, 3),
                "usage": {"cpu_milli": t.usage.milli_cpu,
                          "memory": t.usage.memory,
                          "pods": t.usage_pods,
                          **{k: v for k, v in t.usage.scalar.items()}},
                "quota": (None if t.quota is None else {
                    "cpu_milli": t.quota.milli_cpu,
                    "memory": t.quota.memory,
                    "pods": t.quota_pods}),
            }
        return out

    def debug_state(self) -> dict:
        """The /debug/queue view: tenants + assembling gangs."""
        gangs = {}
        for name, t in self._tenants.items():
            for key, unit in t.units.items():
                if unit.gang_key is not None:
                    g = self._groups.get(unit.gang_key)
                    gangs[key] = {
                        "tenant": name,
                        "members_present": len(unit),
                        "min_member": g.min_member if g else None,
                    }
        for key, unit in self._orphans.items():
            gangs[key] = {"tenant": None, "members_present": len(unit),
                          "min_member": None, "orphan": True}
        return {"tenants": self.tenant_stats(), "gangs": gangs,
                "pending": self.pending_count()}
