"""Preemption: the generic Evaluator + the DefaultPreemption PostFilter
(port of the JAX package's framework/preemption.py).

Host orchestration mirrors the reference's preemption/preemption.go
(Evaluator.Preempt :232, findCandidates :307, SelectCandidate /
pickOneNodeForPreemption :395, :565, prepareCandidate :428) and
plugins/defaultpreemption/default_preemption.go (PostFilter :133,
SelectVictimsOnNode :219, PodEligibleToPreemptOthers :327,
GetOffsetAndNumCandidates :186) — with the per-node dry run replaced by
kernel K6: one sweep over victim prefixes (K6a, kernels/preempt.py
``preempt_sweep``) and the full-filter dry run of every node at once (K6b,
``preempt_feasible``).

Two paths, as in the reference:

- the batched fit-only path (``batch_preempt``): preemptors rejected only
  by NodeResourcesFit, under a profile whose only PostFilter is
  DefaultPreemption, share one host evaluation of the sweep over the
  incrementally kept victim state (``_host_kmin``, numpy; the device
  cumsum is kept up to date by a row scatter but not read on this path);
- the full PostFilter path (``preempt``): every other rejected preemptor
  runs K6a once and K6b for the all-victims dry run and each verification
  and reprieve step.

Victim ordering: pods on a node sort ascending by importance
(util.MoreImportantPod: priority, then start time) so the minimal feasible
prefix evicts the least-important pods first — the resource-space fixed
point of the reference's remove-all-then-reprieve loop.

Not ported yet, each raising NotImplementedError naming its ROADMAP item:
preemption extenders (queue 1 item 7), whole-gang eviction of a gang
victim (item 6) and the host fallback ladder's serial preemption (item
11). The hub has no leader election yet, so evictions carry no fencing
epoch.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_tpu_torch.api.labels import label_selector_matches
from kubernetes_tpu_torch.api.objects import LABEL_POD_GROUP, Pod
from kubernetes_tpu_torch.framework.interface import (
    PostFilterPlugin,
    PreEnqueuePlugin,
    Status,
)
from kubernetes_tpu_torch.hub import Unavailable
from kubernetes_tpu_torch.kernels.preempt import (
    preempt_feasible,
    preempt_sweep,
)
from kubernetes_tpu_torch.ops import features as F
from kubernetes_tpu_torch.utils.interner import NONE

# sentinel: the incremental victim-state update cannot represent the new
# cluster shape; fall back to a full rebuild
_REBUILD = object()

# default_preemption.go:40-44 (DefaultPreemptionArgs defaults)
MIN_CANDIDATE_NODES_PERCENTAGE = 10
MIN_CANDIDATE_NODES_ABSOLUTE = 100

# bound on exact dry-run launches per preemption attempt: candidates tried
# (verification) + reprieve steps on the winner
MAX_VERIFY_CANDIDATES = 8
MAX_REPRIEVE_STEPS = 16


@dataclass
class Candidate:
    """One preemption candidate (candidate.go): a node + its victims."""

    node_name: str
    row: int
    victims: list[Pod]
    pdb_violations: int


class Evaluator:
    """Generic preemption evaluator over the device mirror."""

    def __init__(self, hub, get_mirror, get_caps, get_enabled_filters,
                 nominator, rng: random.Random | None = None):
        self.hub = hub
        # callables: the scheduler re-buckets the mirror/caps, and the
        # framework (which owns the filter config) is built after us
        self._get_mirror = get_mirror
        self._get_caps = get_caps
        self._get_enabled_filters = get_enabled_filters
        self.nominator = nominator
        self._rng = rng or random.Random(0)
        # request-row cache: a victim's packed resource row is immutable per
        # uid FOR A GIVEN MIRROR — a re-bucketed mirror changes res_cols and
        # ext-resource column order, so the cache is tied to the mirror
        # object and dropped when the scheduler rebuilds it
        self._res_rows: dict[tuple[str, bool], np.ndarray] = {}
        self._res_rows_mirror: object = None
        # async preemption (preemption.go:460 prepareCandidateAsync +
        # kep 4832): pods whose victims are still being evicted, and the
        # eviction work queue the scheduler drains between cycles
        self.preempting: set[str] = set()
        self._pending: list[tuple[Candidate, Pod]] = []
        # nominee status-clear writes deferred by a hub outage (the
        # local nomination is already dropped; only the API write waits)
        self._pending_clears: list[str] = []
        # scheduler-installed: activates preemptors whose flush produced no
        # deletion event (empty/already-deleted victim sets) — the gate
        # opener of last resort (see flush_evictions)
        self.activate_fn = None
        # scheduler-installed (pipelined waves): when True, a preemptor
        # whose eviction wave FIRED is also activated explicitly at flush
        # end — it re-probes on the very next wave instead of waiting out
        # the deletion event's backoff routing (its nominated reservation
        # protects the freed slot meanwhile)
        self.activate_flushed = False
        # scheduler-installed (pipelined waves): () -> live device free
        # matrix (the scheduler's resident free/nzr chain) or None. When
        # set and live, the sweep/probe fit baselines see in-flight waves
        # the snapshot free matrix has not absorbed yet
        self.live_free_fn = None
        # scheduler-installed: () -> extenders; any preemption-capable one
        # raises (extenders are a later slice)
        self.extenders_fn = None
        self.metrics = None     # SchedulerMetrics: a later slice
        # incremental victim-sweep state per preemptor priority (see
        # _collect_victims): row_gen-keyed victim lists + the resident
        # device cumsum, refreshed by row-scatter between bursts
        self._vic_state: dict[int, dict] = {}

    # ---------------- eligibility (default_preemption.go:327) -------------

    def pod_eligible_to_preempt_others(self, pod: Pod) -> tuple[bool, str]:
        if pod.spec.preemption_policy == "Never":
            return False, "preemptionPolicy=Never"
        nom = pod.status.nominated_node_name
        if nom:
            # if the nominated node has a terminating lower-priority pod, the
            # previous preemption is still in flight: wait for it
            mirror = self._get_mirror()
            row = mirror.row_of(nom)
            if row >= 0:
                for p in self._pods_on_node(nom):
                    if (p.metadata.deletion_timestamp is not None
                            and p.priority() < pod.priority()):
                        return False, "previous victims still terminating"
        return True, ""

    # ---------------- candidate discovery ----------------

    def _pods_on_node(self, node_name: str) -> list[Pod]:
        info = self.cache_snapshot.get(node_name)
        return [pi.pod for pi in info.pods] if info is not None else []

    def _live_free(self):
        return self.live_free_fn() if self.live_free_fn is not None else None

    def find_candidates(self, pod: Pod, snapshot,
                        resource_only: bool = False) -> list[Candidate]:
        """Device sweep + host assembly of (node, victims) candidates.
        ``resource_only``: the caller knows the pod's rejection was pure
        NodeResourcesFit, so the sweep's answer is exact and the
        full-filter dry-run machinery is skipped."""
        self.cache_snapshot = snapshot.node_info_map
        mirror = self._get_mirror()
        caps = self._get_caps()
        prio = pod.priority()
        prep = self._collect_victims(prio, snapshot, mirror, caps)
        if prep is None:
            return []
        victims_by_row, _k_cap, cumsum, vic_cols, cumsum_np, cols_np = prep

        pblobs = mirror.pack_batch_blobs([pod], 1)
        cblobs = mirror.to_blobs()
        kmin = preempt_sweep(
            cblobs, pblobs, mirror.well_known(), cumsum, vic_cols, caps,
            self._get_enabled_filters(pod),
            free=self._live_free()).cpu().numpy()[0]
        self._kmin = kmin                     # reused by _minimize_victims
        self._victims_by_row = victims_by_row

        # candidate rows: full-filter feasibility with EVERY victim evicted
        # (the reference's remove-all first step, default_preemption.go:219,
        # evaluated for all nodes in one launch). This is the exact superset
        # of per-node-eviction feasibility for monotone filters; the chosen
        # candidate is re-verified with per-node masking before any eviction
        # happens, so an optimistic row costs one extra launch, never a
        # wrong eviction.
        if resource_only:
            # the pod was rejected ONLY by NodeResourcesFit: the resource
            # sweep's kmin IS the reference's remove-then-reprieve fixed
            # point, so candidate rows and minimal victim sets come
            # straight from it — no dry-run launches
            return self._assemble_candidates(
                pod, kmin, victims_by_row, snapshot, mirror,
                mirror.free_matrix(), self.hub.list_pdbs())

        all_uids = {pi.pod.metadata.uid
                    for vs in victims_by_row.values() for pi in vs}
        # keep victims that could SATISFY the preemptor's required affinity
        # visible: masking them cluster-wide would under-approximate
        # feasibility (the reference only ever removes the candidate node's
        # own pods). A provider-victim on the chosen node itself is caught
        # by the exact per-node verification.
        aff = pod.spec.affinity
        aff_terms = (aff.pod_affinity.required
                     if aff is not None and aff.pod_affinity is not None
                     else [])
        if aff_terms:
            for vs in victims_by_row.values():
                for pi in vs:
                    v = pi.pod
                    for term in aff_terms:
                        ns_ok = (v.metadata.namespace
                                 == pod.metadata.namespace
                                 if not term.namespaces
                                 else v.metadata.namespace in term.namespaces)
                        if ns_ok and label_selector_matches(
                                term.label_selector, v.metadata.labels):
                            all_uids.discard(v.metadata.uid)
                            break
        freed = {}
        for row, vs in victims_by_row.items():
            full = np.zeros((caps.res_cols,), np.float32)
            full[cols_np] = cumsum_np[row, len(vs), : len(cols_np)]
            freed[row] = full
        feas = self._dryrun_feasible(pod, all_uids, freed)
        rows = [row for row in victims_by_row if feas[row]]
        if not rows:
            return []

        # candidate subset: random offset + bounded count (preemption.go:307
        # GetOffsetAndNumCandidates)
        num_nodes = len(snapshot.node_info_list)
        want = max(num_nodes * MIN_CANDIDATE_NODES_PERCENTAGE // 100,
                   MIN_CANDIDATE_NODES_ABSOLUTE)
        rows.sort()
        off = self._rng.randrange(len(rows))
        picked = [rows[(off + i) % len(rows)]
                  for i in range(min(want, len(rows)))]

        pdbs = self.hub.list_pdbs()
        out = []
        for row in picked:
            vs = victims_by_row[row]
            # rank candidates by their minimal-victim ESTIMATE: the kmin
            # prefix when the resource sweep found one (exact for
            # resource-blocked preemptors), the full list otherwise —
            # select_candidate's pdb/priority/count keys would regress if
            # computed over pods that will never be evicted
            k = int(kmin[row])
            if k != NONE and 1 <= k <= len(vs):
                vs = vs[:k]
            victims = [pi.pod for pi in vs]
            out.append(Candidate(
                node_name=mirror.name_of_row(row) or "",
                row=row, victims=victims,
                pdb_violations=self._pdb_violations(victims, pdbs)))
        return out

    def _dryrun_feasible(self, pod: Pod, exclude_uids, freed_by_row
                         ) -> np.ndarray:
        """[N] bool: FULL filter set for ``pod`` with ``exclude_uids``
        masked out of the device pod table and each row's free resources
        raised by its freed vector (K6b, kernels/preempt.py
        preempt_feasible)."""
        mirror = self._get_mirror()
        caps = self._get_caps()
        dev = mirror.device
        tval = mirror.table_valid_mask(exclude_uids)
        live_free = self._live_free()
        # the live chain wins when present: the probe's fit baseline then
        # includes waves still in flight (a writable host copy of it)
        free = (np.array(live_free.cpu(), np.float32)
                if live_free is not None else mirror.free_matrix())
        for row, vec in freed_by_row.items():
            free[row] = free[row] + vec
        pblobs = mirror.pack_batch_blobs([pod], 1)
        enable = (mirror.table_has_topology()
                  or mirror.batch_has_topology([pod]))
        return preempt_feasible(
            mirror.to_blobs(), pblobs, mirror.well_known(), caps,
            torch.tensor(tval, device=dev), torch.tensor(free, device=dev),
            enable, mirror.launch_d_cap(enable),
            self._get_enabled_filters(pod)).cpu().numpy()

    def _res_row_cached(self, pod: Pod, freed: bool = False) -> np.ndarray:
        """A pod's f32 resource row: demand (the preemptor's request)
        rounds UP; ``freed=True`` (a victim's contribution handed back
        to capacity) rounds DOWN — summing ceiled victim rows onto free
        would overstate post-eviction headroom and evict pods for a
        preemption that cannot succeed."""
        from kubernetes_tpu_torch.api.resources import pod_request

        key = (pod.metadata.uid, freed)
        rr = self._res_rows.get(key)
        if rr is None:
            rr = np.asarray(self._get_mirror()._res_row(
                pod_request(pod), capacity=freed), np.float32)
            self._res_rows[key] = rr
        return rr

    def _minimize_victims(self, pod: Pod, cand: Candidate,
                          pdbs) -> Candidate | None:
        """Exact verification + reprieve for one candidate (the
        reference's per-node reprieve loop, default_preemption.go:219):

        1. Verify the pod actually fits with ONLY this node's victims
           evicted (full filters). A candidate from the optimistic
           all-evicted pass that fails here is discarded — no eviction ever
           happens on an unverified candidate.
        2. If the resource sweep found a feasible prefix, try it first: the
           prefix (least-important victims) is the resource-space reprieve
           fixed point, one launch to confirm.
        3. Otherwise reprieve victims one at a time — PDB-violating victims
           first, then most-important-first — keeping each reprieve that
           leaves the pod feasible (bounded by MAX_REPRIEVE_STEPS).
        """
        row = cand.row
        victims = list(cand.victims)        # ascending importance

        def feasible_with(vset: list[Pod]) -> bool:
            if not vset:
                return False
            freed = np.zeros_like(self._res_row_cached(vset[0],
                                                       freed=True))
            for v in vset:
                freed = freed + self._res_row_cached(v, freed=True)
            feas = self._dryrun_feasible(
                pod, {v.metadata.uid for v in vset}, {row: freed})
            return bool(feas[row])

        kmin = getattr(self, "_kmin", None)
        k = int(kmin[row]) if kmin is not None else NONE
        from_prefix = k != NONE and len(victims) == k
        if not feasible_with(victims):
            # the candidate carried the kmin-trimmed ranking estimate; try
            # the node's full victim set before giving up (topology-blocked
            # preemptors may need more than the resource prefix)
            full = [pi.pod for pi in self._victims_by_row.get(row, [])]
            if len(full) > len(victims) and feasible_with(full):
                victims = full
                from_prefix = False
            else:
                return None                 # unverifiable candidate: discard
        elif from_prefix:
            # the verified set IS the resource sweep's minimal prefix: the
            # reprieve loop cannot shrink it further (each prefix k-1 was
            # already infeasible by kmin's minimality)
            return Candidate(
                node_name=cand.node_name, row=row, victims=victims,
                pdb_violations=self._pdb_violations(victims, pdbs))
        if k != NONE and 1 <= k < len(victims):
            prefix = victims[:k]
            if feasible_with(prefix):
                victims = prefix
        if len(victims) > 1:
            flags = self._pdb_violation_flags(victims, pdbs)
            # reprieve order: PDB-violating first, then priority desc,
            # then older first (filterPodsWithPDBViolation + reprievePod)
            order = sorted(
                range(len(victims)),
                key=lambda i: (not flags[i], -victims[i].priority(),
                               victims[i].metadata.creation_timestamp))
            kept = set()
            steps = 0
            for i in order:
                if steps >= MAX_REPRIEVE_STEPS or len(victims) - len(kept) <= 1:
                    break
                trial = [v for j, v in enumerate(victims)
                         if j != i and j not in kept]
                steps += 1
                if feasible_with(trial):
                    kept.add(i)
            victims = [v for j, v in enumerate(victims) if j not in kept]
        return Candidate(
            node_name=cand.node_name, row=row, victims=victims,
            pdb_violations=self._pdb_violations(victims, pdbs))

    @staticmethod
    def _pdb_matches(v: Pod, pdbs) -> list:
        return [pdb for pdb in pdbs
                if pdb.metadata.namespace == v.metadata.namespace
                and pdb.selector is not None
                and label_selector_matches(pdb.selector, v.metadata.labels)]

    @staticmethod
    def _pdb_violation_flags(victims: list[Pod], pdbs) -> list[bool]:
        """Per-victim: does evicting it violate some exhausted PDB? Every
        eviction draws down each matching PDB's budget (preemption.go
        filterPodsWithPDBViolation classifies per pod)."""
        budget = {pdb.metadata.uid: pdb.disruptions_allowed for pdb in pdbs}
        flags = []
        for v in victims:
            matched = Evaluator._pdb_matches(v, pdbs)
            flags.append(any(budget[pdb.metadata.uid] <= 0
                             for pdb in matched))
            for pdb in matched:
                budget[pdb.metadata.uid] -= 1
        return flags

    @staticmethod
    def _pdb_violations(victims: list[Pod], pdbs) -> int:
        """How many VICTIMS violate some PDB's disruptionsAllowed — each pod
        counts at most once even if it matches several exhausted PDBs."""
        return sum(Evaluator._pdb_violation_flags(victims, pdbs))

    # ------------- extender pass (preemption.go:335 callExtenders) --------

    def call_extenders(self, pod: Pod,
                       candidates: list[Candidate]) -> list[Candidate]:
        """The candidates as they are when no preemption-capable extender
        is interested in the pod; extenders are a later slice."""
        extenders = self.extenders_fn() if self.extenders_fn else []
        if any(ext.supports_preemption and ext.is_interested(pod)
               for ext in extenders):
            raise NotImplementedError(
                "preemption extenders (ProcessPreemption): ROADMAP queue 1 "
                "item 7")
        return candidates

    # ---------------- selection (preemption.go:565 pickOneNode) -----------

    @staticmethod
    def candidate_key(c: Candidate):
        """pickOneNodeForPreemption's ordering (preemption.go:565):
        fewest PDB violations, lowest max victim priority, lowest
        priority sum, fewest victims, latest-started important victim."""
        prios = [v.priority() for v in c.victims]
        high = max(prios) if prios else -(2 ** 31)
        # latest start of the highest-priority victim: prefer evicting
        # the youngest important pod
        starts = [v.metadata.creation_timestamp for v in c.victims
                  if v.priority() == high]
        latest = max(starts) if starts else 0.0
        return (c.pdb_violations, high, sum(prios), len(c.victims),
                -latest, c.node_name)

    @staticmethod
    def select_candidate(candidates: list[Candidate]) -> Candidate | None:
        if not candidates:
            return None
        return min(candidates, key=Evaluator.candidate_key)

    # ---------------- execution (preemption.go:428 prepareCandidate) ------

    def prepare_candidate(self, candidate: Candidate, pod: Pod) -> None:
        """Queue the eviction work (prepareCandidateAsync, kep 4832): the
        scheduler drains it via flush_evictions OUTSIDE the scheduling
        cycle, and the DefaultPreemption PreEnqueue gate keeps the
        preemptor parked until its victims are gone."""
        self.preempting.add(pod.metadata.uid)
        self._pending.append((candidate, pod))

    def has_pending(self) -> bool:
        """Whether flush_evictions has queued work (evictions or deferred
        nomination clears) — the scheduler's cue to time the flush as an
        eviction_flush phase instead of skipping the empty no-op."""
        return bool(self._pending or self._pending_clears)

    def flush_evictions(self) -> int:
        """Execute queued evictions; returns the number of preparations
        run. The preemptor leaves ``preempting`` BEFORE the last victim
        deletion so that deletion's cluster event finds the gate open and
        requeues it (preemption.go:528's ordering). A candidate whose
        victim set is empty — or whose victims were already deleted by an
        overlapping candidate this flush — produces NO deletion event, so
        its preemptor is activated explicitly (``activate_fn``): without
        that, two preemptors nominating the same node can deadlock parked
        behind each other's reservations."""
        # retry API nomination clears a previous outage deferred (the
        # local nominator entries are already gone, so only the status
        # write can be replayed)
        clears, self._pending_clears = self._pending_clears, []
        for uid in clears:
            try:
                self.hub.clear_nominated_node(uid)
            except Unavailable:
                self._pending_clears.append(uid)
            except Exception:  # noqa: BLE001 — pod gone: nothing to clear
                pass
        work, self._pending = self._pending, []
        stranded = []
        try:
            self._flush_candidates(work, stranded)
        finally:
            # the activation of already-processed stranded preemptors
            # must fire even when an outage aborts the flush mid-way:
            # they are no longer in ``preempting`` and no deletion event
            # will requeue them (activate_fn is queue-local, hub-free)
            if stranded and self.activate_fn is not None:
                self.activate_fn(stranded)
        return len(work)

    def _clear_lower_nominations(self, candidate: Candidate,
                                 pod: Pod) -> None:
        """Lower-priority nominees on the candidate's node must
        re-evaluate: drop the nomination AND clear the API status; the
        update event re-activates them."""
        dropped = self.nominator.clear_for_node_below_priority(
            candidate.node_name, pod.priority())
        for nominee in dropped:
            try:
                self.hub.clear_nominated_node(nominee.metadata.uid)
            except Unavailable:
                # the nominator entry is dropped for good, so park the
                # STATUS write itself for replay
                self._pending_clears.append(nominee.metadata.uid)

    def _flush_candidates(self, work: list, stranded: list) -> None:
        """One flush = plan, then ONE multi-delete wave.

        Phase A walks the backlog host-side (nomination clears, the gang
        guard) into per-candidate victim plans; phase B opens every
        planned preemptor's gate and commits ALL victim deletions as one
        ``hub.delete_pods`` wave; phase C strands any candidate none of
        whose victims actually produced a deletion event. Hubs without the
        batched verb keep the per-victim path with identical semantics."""
        batched = getattr(self.hub, "delete_pods", None)
        if not callable(batched):
            return self._flush_candidates_serial(work, stranded)
        plans: list = []            # (pod, victims) per surviving candidate
        for i, (candidate, pod) in enumerate(work):
            try:
                self._clear_lower_nominations(candidate, pod)
                plans.append((pod, self._expand_gang_victims(
                    candidate.victims)))
            except Unavailable:
                # outage mid-planning: nothing is deleted yet — the
                # whole backlog (already-planned candidates included)
                # replays; every planning step is idempotent
                planned = {p.metadata.uid for (p, _v) in plans}
                self._pending = (
                    [w for w in work if w[1].metadata.uid in planned]
                    + work[i:] + self._pending)
                raise
        if not plans:
            return
        # phase B: gates open BEFORE any deletion event can fire (the
        # batched form of preemption.go:528's ordering), then one wave
        uids: list[str] = []
        owner: dict[str, int] = {}  # victim uid -> first plan claiming it
        for i, (pod, victims) in enumerate(plans):
            self.preempting.discard(pod.metadata.uid)
            for v in victims:
                if v.metadata.uid not in owner:
                    owner[v.metadata.uid] = i
                    uids.append(v.metadata.uid)
        try:
            gone = set(batched(uids)) if uids else set()
        except Unavailable:
            # the wave's verdict is unknown: re-gate + requeue every
            # planned candidate; a replayed wave skips already-gone
            # victims, so replay is idempotent
            for pod, _v in plans:
                self.preempting.add(pod.metadata.uid)
            planned = {p.metadata.uid for (p, _v) in plans}
            self._pending = ([w for w in work
                              if w[1].metadata.uid in planned]
                             + self._pending)
            raise
        for i, (pod, victims) in enumerate(plans):
            # a plan is "fired" only by a deletion it OWNS (first claim in
            # plan order — the serial path's exact discipline): a candidate
            # whose victims were all claimed by overlapping earlier plans
            # produces no deletion event of its own, so its preemptor must
            # be activated explicitly
            fired = any(v.metadata.uid in gone
                        and owner[v.metadata.uid] == i for v in victims)
            # pipelined waves: a FIRED preemptor is activated too — its
            # re-probe rides the very next scheduling wave instead of
            # waiting for the deletion event's backoff routing
            if not fired or self.activate_flushed:
                stranded.append(pod)

    def _flush_candidates_serial(self, work: list, stranded: list) -> None:
        """The per-victim flush, for hubs without ``delete_pods``."""
        for i, (candidate, pod) in enumerate(work):
            try:
                self._clear_lower_nominations(candidate, pod)
                victims = self._expand_gang_victims(candidate.victims)
                for victim in victims[:-1]:
                    try:
                        self.hub.delete_pod(victim.metadata.uid)
                    except Unavailable:
                        raise           # outage ≠ "already gone"
                    except Exception:  # noqa: BLE001 — gone is fine
                        pass
                self.preempting.discard(pod.metadata.uid)
                fired = False
                if victims:
                    try:
                        self.hub.delete_pod(victims[-1].metadata.uid)
                        fired = True
                    except Unavailable:
                        raise
                    except Exception:  # noqa: BLE001
                        pass
                if not fired or self.activate_flushed:
                    stranded.append(pod)
            except Unavailable:
                # hub outage mid-candidate: requeue it and the whole
                # unprocessed tail; re-gate THIS candidate's preemptor
                # (its discard may already have run). Every step above is
                # idempotent on replay.
                self.preempting.add(pod.metadata.uid)
                self._pending = work[i:] + self._pending
                raise

    @staticmethod
    def _expand_gang_victims(victims: list[Pod]) -> list[Pod]:
        """All-or-nothing eviction of a gang victim's whole gang is a later
        slice: the victims as they are, or NotImplementedError when one
        belongs to a gang."""
        for v in victims:
            if LABEL_POD_GROUP in v.metadata.labels:
                raise NotImplementedError(
                    f"victim {v.key()} belongs to a gang (whole-gang "
                    "eviction, K7): ROADMAP queue 1 item 6")
        return victims

    def _reprieve_by_resources(self, victims: list[Pod], pod: Pod,
                               row: int, free_mat: np.ndarray) -> list[Pod]:
        """The reference's reprieve pass, host-side: walk the victim set
        most-important-first (oldest first at equal priority) and re-add
        any victim whose eviction is NOT needed for the preemptor's
        resource fit (default_preemption.go:219's re-add loop). The
        effective free mirrors the sweep's fit base: nominated
        reservations subtracted, the pod's OWN nomination handed back."""
        mirror = self._get_mirror()
        free = np.asarray(free_mat[row], np.float32)
        req = np.asarray(self._res_row_cached(pod), np.float32)
        nom = mirror._nominated_req_of_row.get(row)
        if nom is not None:
            free = free - np.asarray(nom, np.float32)
        if pod.status.nominated_node_name \
                and mirror.row_of(pod.status.nominated_node_name) == row:
            free = free + req
        needed = np.maximum(req - free, 0.0)
        freed = np.zeros_like(req)
        rows = {}
        for v in victims:
            rows[v.metadata.uid] = self._res_row_cached(v, freed=True)
            freed = freed + rows[v.metadata.uid]
        kept: list[Pod] = list(victims)
        # most important first: priority desc, oldest first
        for v in sorted(victims,
                        key=lambda q: (-q.priority(),
                                       q.metadata.creation_timestamp)):
            if len(kept) <= 1:
                break
            trial = freed - rows[v.metadata.uid]
            if np.all(trial >= needed):
                freed = trial
                kept.remove(v)
        return kept

    # ---------------- the victim state ----------------

    def _collect_victims(self, prio: int, snapshot, mirror, caps):
        """(victims_by_row, k_cap, device cumsum [N, K+1, C], device
        vic_cols [C], host cumsum, host cols) for preemptors of ``prio``,
        or None when nothing is evictable. The trailing host pair backs
        full-width freed-vector expansion (find_candidates' dry run).

        Per-node victims sort ascending by importance (evict
        least-important first): priority asc, then start time desc.
        Nodes with no victims are skipped: the sweep only selects rows
        with 1 <= kmin <= len(victims), and an empty row can never win.

        INCREMENTAL across bursts: per-row victim lists and cumsum rows
        are keyed on each NodeInfo's generation, so a burst recomputes
        only the rows commits touched and row-scatters them into the
        device-resident cumsum. The cumsum carries only the columns
        victims actually free (see ops/preempt.py preempt_sweep)."""
        st = self._vic_state.get(prio)
        if (st is not None and st["mirror"] is mirror
                and st["n"] == caps.nodes):
            upd = self._update_victims(st, prio, snapshot, mirror)
            if upd is not _REBUILD:
                return upd
        return self._rebuild_victims(prio, snapshot, mirror, caps)

    def _res_row_of(self, pi) -> np.ndarray:
        """Victim freed-amount row (floored — it adds back to capacity),
        via the (uid, freed=True) cache key space."""
        key = (pi.pod.metadata.uid, True)
        rr = self._res_rows.get(key)
        if rr is None:
            rr = np.asarray(self._get_mirror()._res_row(
                pi.request, capacity=True), np.float32)
            self._res_rows[key] = rr
        return rr

    @staticmethod
    def _victim_sort_key(pi):
        return (pi.pod.priority(), -pi.pod.metadata.creation_timestamp)

    @staticmethod
    def _state_tuple(st):
        if not st["victims_by_row"]:
            return None
        return (st["victims_by_row"], st["k_cap"], st["cumsum_dev"],
                st["vic_cols_dev"], st["cumsum_host"], st["cols_np"])

    @staticmethod
    def _prefix_sums(flat: list[np.ndarray], k_arr: np.ndarray,
                     cols_np: np.ndarray, pods_pos: int, k_cap: int
                     ) -> np.ndarray:
        """[rows, k_cap, C] f32: per row, the freed request of its first
        j = 1..k_cap victims (j clamps to the row's victim count: padding
        prefixes repeat the full-eviction sum) over the ``cols_np``
        columns, the pod-count column set to j. ``flat`` stacks every
        row's victim rows in (row, rank) order.

        float64 accumulation: the GLOBAL running total over ~20k victims
        exceeds float32's 2^24 integer-exact range (MiB-scale rows), and
        cs[take] - base would cancel catastrophically, flipping boundary
        fit decisions in the sweep; per-node differences cast back to f32
        exactly (they're node-local sums, far below 2^24)."""
        stacked = np.stack(flat)                              # [V, R]
        cs = np.cumsum(stacked[:, cols_np], axis=0,
                       dtype=np.float64)                      # [V, C]
        offsets = np.concatenate(([0], np.cumsum(k_arr)))[:-1]
        base = np.where((offsets > 0)[:, None],
                        cs[np.maximum(offsets - 1, 0)], 0.0)  # [NR, C]
        j = np.arange(1, k_cap + 1)
        jk = np.minimum(j[None, :], np.maximum(k_arr, 1)[:, None])
        # clamp: a victimless TRAILING row has offset == V, and its jk
        # floor of 1 would index cs[V] out of bounds; the caller zeroes
        # such rows
        take = np.minimum(offsets[:, None] + jk - 1, len(flat) - 1)
        vals = (cs[take] - base[:, None, :]).astype(np.float32)
        vals[..., pods_pos] = jk
        return vals

    def _rebuild_victims(self, prio: int, snapshot, mirror, caps):
        victims_by_row = {}
        row_gen: dict[int, int] = {}
        k_max = 0
        for info in snapshot.node_info_list:
            row = mirror.row_of(info.name)
            if row < 0:
                continue
            row_gen[row] = info.generation
            vs = [pi for pi in info.pods if pi.pod.priority() < prio]
            if not vs:
                continue
            vs.sort(key=self._victim_sort_key)
            victims_by_row[row] = vs
            k_max = max(k_max, len(vs))
        if self._res_rows_mirror is not mirror:
            self._res_rows.clear()
            self._res_rows_mirror = mirror
        if len(self._res_rows) > 200_000:
            self._res_rows.clear()
        if k_max == 0:
            st = {"mirror": mirror, "n": caps.nodes, "row_gen": row_gen,
                  "victims_by_row": {}, "k_cap": 0, "cols": (),
                  "cols_np": None, "pods_pos": 0, "c_pad": 0,
                  "incols_mask": None, "cumsum_host": None,
                  "cumsum_dev": None, "vic_cols_dev": None}
            self._save_vic_state(prio, st)
            return None
        # k headroom (min 8): commits between bursts add victims per row;
        # a k_cap growth reshapes the cumsum, which the headroom absorbs
        k_cap = 8
        while k_cap < k_max:
            k_cap *= 2
        n = caps.nodes
        # one flat [V_total, R] stack of every victim's res row, in
        # (node, victim-rank) order
        flat_rows: list[np.ndarray] = []
        row_ids = np.empty((len(victims_by_row),), np.int64)
        k_arr = np.empty((len(victims_by_row),), np.int64)
        for i, (row, vs) in enumerate(victims_by_row.items()):
            row_ids[i] = row
            k_arr[i] = len(vs)
            for pi in vs:
                flat_rows.append(self._res_row_of(pi))
        stacked_all = np.stack(flat_rows)                     # [V, R]
        active = set(np.nonzero(stacked_all.any(axis=0))[0].tolist())
        active.add(int(F.COL_PODS))
        cols = sorted(active)
        c_pad = 4
        while c_pad < len(cols):
            c_pad *= 2
        pods_pos = cols.index(int(F.COL_PODS))
        cols_np = np.asarray(cols, np.int64)
        vals = self._prefix_sums(flat_rows, k_arr, cols_np, pods_pos, k_cap)
        cumsum = np.zeros((n, k_cap + 1, c_pad), np.float32)
        # padding columns: +BIG so they never bind
        cumsum[:, :, len(cols):] = 3.0e38
        cumsum[row_ids, 1:, : len(cols)] = vals
        # padding entries MUST alias an ACTIVE column (cols[0]), never a
        # blanket column 0: aliasing an inactive column would add it to the
        # kernel's col_freed mask (dropping it from the base-only check)
        # while the +BIG padding cumsum makes the subset check vacuous for
        # it — silently deleting that resource constraint from the sweep
        vic_cols = np.full((c_pad,), cols_np[0], np.int32)
        vic_cols[: len(cols)] = cols_np
        incols_mask = np.zeros((stacked_all.shape[1],), bool)
        incols_mask[cols_np] = True
        dev = mirror.device
        st = {"mirror": mirror, "n": n, "row_gen": row_gen,
              "victims_by_row": victims_by_row, "k_cap": k_cap,
              "cols": tuple(cols), "cols_np": cols_np,
              "pods_pos": pods_pos, "c_pad": c_pad,
              "incols_mask": incols_mask,
              # host copy rides along for full-width freed-vector
              # expansion (find_candidates' dry-run path) and _host_kmin
              "cumsum_host": cumsum,
              "cumsum_dev": torch.tensor(cumsum, device=dev),
              "vic_cols_dev": torch.tensor(vic_cols, device=dev)}
        self._save_vic_state(prio, st)
        return self._state_tuple(st)

    def _save_vic_state(self, prio: int, st: dict) -> None:
        self._vic_state[prio] = st
        while len(self._vic_state) > 4:     # bound distinct-priority states
            self._vic_state.pop(next(iter(self._vic_state)))

    def _update_victims(self, st: dict, prio: int, snapshot, mirror):
        """Refresh only rows whose NodeInfo generation moved; row-scatter
        their cumsum slices into the device-resident buffer (an
        ``index_copy_``). Returns the state tuple (or None when nothing is
        evictable), or _REBUILD when the shape no longer fits (k_cap
        overflow, a new active resource column, node set shrank)."""
        row_gen = st["row_gen"]
        vbr = st["victims_by_row"]
        k_cap = st["k_cap"]
        dirty: list[int] = []
        seen = 0
        for info in snapshot.node_info_list:
            row = mirror.row_of(info.name)
            if row < 0:
                continue
            seen += 1
            g = info.generation
            if row_gen.get(row) == g:
                continue
            vs = [pi for pi in info.pods if pi.pod.priority() < prio]
            if len(vs) > k_cap:
                return _REBUILD
            row_gen[row] = g
            vs.sort(key=self._victim_sort_key)
            if vs:
                vbr[row] = vs
            else:
                vbr.pop(row, None)
            dirty.append(row)
        if seen != len(row_gen):
            # nodes left the snapshot: stale rows would keep serving
            # cumsum entries — rare enough that a rebuild is fine
            return _REBUILD
        if not dirty:
            return self._state_tuple(st)
        if st["cumsum_host"] is None:
            # state was the "nothing evictable" marker; first victims
            # appeared -> allocate via a rebuild
            return _REBUILD
        cols_np, pods_pos = st["cols_np"], st["pods_pos"]
        c_pad, incols = st["c_pad"], st["incols_mask"]
        n_cols = len(cols_np)
        block = np.zeros((len(dirty), k_cap + 1, c_pad), np.float32)
        block[:, :, n_cols:] = 3.0e38
        flat: list[np.ndarray] = []
        k_arr = np.zeros((len(dirty),), np.int64)
        for i, row in enumerate(dirty):
            vs = vbr.get(row)
            if not vs:
                continue
            k_arr[i] = len(vs)
            for pi in vs:
                flat.append(self._res_row_of(pi))
        if flat:
            if np.stack(flat)[:, ~incols].any():
                return _REBUILD     # a victim frees a column the state
                                    # doesn't carry
            vals = self._prefix_sums(flat, k_arr, cols_np, pods_pos, k_cap)
            vals[k_arr == 0] = 0.0      # rows whose victims all vanished
            block[:, 1:, :n_cols] = vals
        st["cumsum_host"][dirty] = block
        # the port of the reference's _scatter_rows0_jit: the dirty rows
        # copied into the resident cumsum in place, stream-ordered after
        # any launch already reading it
        dev = st["cumsum_dev"].device
        idx = np.asarray(dirty, np.int64)
        st["cumsum_dev"].index_copy_(
            0, torch.from_numpy(idx).to(dev),
            torch.from_numpy(st["cumsum_host"][idx]).to(dev))
        return self._state_tuple(st)

    # ---------------- the batched fit-only path ----------------

    def _assemble_candidates(self, pod: Pod, kmin, victims_by_row,
                             snapshot, mirror, free_mat, pdbs
                             ) -> list[Candidate]:
        """kmin rows -> reprieved Candidates, with the reference's
        randomized percentage-bounded sampling (preemption.go:307
        GetOffsetAndNumCandidates)."""
        rows = [row for row, vs in victims_by_row.items()
                if kmin[row] != NONE and 1 <= kmin[row] <= len(vs)]
        if not rows:
            return []
        rows.sort()
        num_nodes = len(snapshot.node_info_list)
        want = max(num_nodes * MIN_CANDIDATE_NODES_PERCENTAGE // 100,
                   MIN_CANDIDATE_NODES_ABSOLUTE)
        off = self._rng.randrange(len(rows))
        picked = [rows[(off + i) % len(rows)]
                  for i in range(min(want, len(rows)))]
        out = []
        for row in picked:
            vs = self._reprieve_by_resources(
                [pi.pod for pi in victims_by_row[row][: int(kmin[row])]],
                pod, row, free_mat)
            out.append(Candidate(
                node_name=mirror.name_of_row(row) or "", row=row,
                victims=vs,
                pdb_violations=self._pdb_violations(vs, pdbs)))
        return out

    def begin_batch_preempt(self, jobs, snapshot) -> tuple:
        """Build or update the victim state for a burst of fit-only
        preemptors of equal priority. Returns (handle | None, immediate):
        ``immediate`` resolves pods that never needed a sweep (ineligible,
        nothing evictable)."""
        self.cache_snapshot = snapshot.node_info_map
        mirror = self._get_mirror()
        caps = self._get_caps()
        immediate: dict[str, tuple] = {}
        eligible = []
        for qp in list(jobs):
            ok, why = self.pod_eligible_to_preempt_others(qp.pod)
            if ok:
                eligible.append(qp)
            else:
                immediate[qp.uid] = (None, Status.unschedulable(
                    f"not eligible for preemption: {why}",
                    plugin="DefaultPreemption"))
        if not eligible:
            return None, immediate
        prio = eligible[0].pod.priority()
        prep = self._collect_victims(prio, snapshot, mirror, caps)
        if prep is None:
            immediate.update(
                {qp.uid: (None, Status.unschedulable(
                    "no preemption candidates",
                    plugin="DefaultPreemption")) for qp in eligible})
            return None, immediate
        victims_by_row = prep[0]
        return (eligible, victims_by_row, self._vic_state[prio], mirror,
                snapshot), immediate

    def _host_static_ok(self, pod: Pod, node_name: str) -> bool:
        """Host mirror of the device pipeline's commit-invariant filters
        (kernels/phase1.py static_filters) for one (pod, node): validity,
        NodeName, NodeUnschedulable, TaintToleration, NodeAffinity,
        NodePorts. Evaluated lazily on candidate-window rows only."""
        from kubernetes_tpu_torch.api.labels import (
            find_untolerated_taint,
            pod_matches_node_selector_and_affinity,
        )
        from kubernetes_tpu_torch.api.objects import Taint
        from kubernetes_tpu_torch.backend.mirror import TAINT_UNSCHEDULABLE

        info = self.cache_snapshot.get(node_name)
        if info is None or info.node is None:
            return False
        node = info.node
        if pod.spec.node_name and pod.spec.node_name != node_name:
            return False
        taints = list(node.spec.taints)
        if node.spec.unschedulable:
            # the NodeUnschedulable plugin's simulated taint
            taints.append(Taint(key=TAINT_UNSCHEDULABLE, value="",
                                effect="NoSchedule"))
        if find_untolerated_taint(taints, pod.spec.tolerations) is not None:
            return False
        if not pod_matches_node_selector_and_affinity(pod, node):
            return False
        for c in pod.spec.containers:
            for p in c.ports:
                if p.host_port and info.used_ports.conflicts(
                        p.host_ip or "0.0.0.0", p.protocol or "TCP",
                        p.host_port):
                    return False
        return True

    def _host_kmin(self, pod: Pod, st: dict, mirror, free_mat: np.ndarray
                   ) -> np.ndarray:
        """[N] i32 minimal victim-prefix making ``pod`` fit per node,
        NONE where eviction cannot help — the HOST evaluation of the
        sweep's resource half over the incremental cumsum (numpy, ~ms). A
        device sweep here would queue behind the drain's in-flight
        launches; the reference measured 100-1000 ms of wall per burst
        for it. Static filters are NOT folded in — the caller checks them
        lazily on visited window rows via _host_static_ok."""
        cumsum = st["cumsum_host"]                    # [N, K+1, C_pad]
        cols_np = st["cols_np"]
        n_cols = len(cols_np)
        base = free_mat.copy()
        for row, vec in mirror._nominated_req_of_row.items():
            base[row] = base[row] - vec
        req = self._res_row_cached(pod)
        nnn = pod.status.nominated_node_name
        if nnn:
            own = mirror.row_of(nnn)
            if own >= 0:
                base[own] = base[own] + req
        # allocatable bound: rows where the request can never fit
        off, size = mirror.node_codec._f32_off["allocatable"]
        alloc = mirror.node_f32[:, off:off + size]
        unresolvable = (req[None, :] > alloc).any(axis=1)
        col_freed = np.zeros((base.shape[1],), bool)
        col_freed[cols_np] = True
        ok_rest = np.all((req[None, :] <= base) | col_freed[None, :],
                         axis=1)
        eff = base[:, None, cols_np] + cumsum[:, :, :n_cols]
        fit = ok_rest[:, None] & np.all(req[cols_np][None, None, :] <= eff,
                                        axis=2)      # [N, K+1]
        kmin = fit.argmax(axis=1).astype(np.int32)
        ok = fit.any(axis=1) & ~unresolvable
        return np.where(ok, kmin, np.int32(NONE))

    def finish_batch_preempt(self, handle) -> dict:
        """Assign nodes/victims for a burst, entirely host-side: numpy
        kmin over the incremental cumsum, rotation-sampled candidate
        windows (GetOffsetAndNumCandidates, preemption.go:307), lazy
        static filtering, reprieve. Burst-local row exclusion: two
        preemptors never target the same capacity.
        {uid: (nominated_node | None, Status)}."""
        eligible, victims_by_row, st, mirror, snapshot = handle
        self.cache_snapshot = snapshot.node_info_map
        out: dict[str, tuple] = {}
        free_mat = mirror.free_matrix()
        pdbs = self.hub.list_pdbs()
        used_rows: set[int] = set()
        for qp in eligible:
            kmin = self._host_kmin(qp.pod, st, mirror, free_mat)
            rows = np.nonzero((kmin != NONE) & (kmin >= 1))[0]
            window: list[tuple[int, int]] = []
            if len(rows):
                off = self._rng.randrange(len(rows))
                for i in range(len(rows)):
                    row = int(rows[(off + i) % len(rows)])
                    vs = victims_by_row.get(row)
                    k = int(kmin[row])
                    if (vs is None or row in used_rows or k > len(vs)
                            or not self._host_static_ok(
                                qp.pod, mirror.name_of_row(row) or "")):
                        continue
                    window.append((row, k))
                    if len(window) >= MAX_VERIFY_CANDIDATES:
                        break
            candidates = []
            for row, k in window:
                vs = self._reprieve_by_resources(
                    [pi.pod for pi in victims_by_row[row][:k]],
                    qp.pod, row, free_mat)
                candidates.append(Candidate(
                    node_name=mirror.name_of_row(row) or "", row=row,
                    victims=vs,
                    pdb_violations=self._pdb_violations(vs, pdbs)))
            candidates = self.call_extenders(qp.pod, candidates)
            if not candidates:
                out[qp.uid] = (None, Status.unschedulable(
                    "no preemption candidates",
                    plugin="DefaultPreemption"))
                continue
            best = self.select_candidate(candidates)
            if self.metrics is not None:
                self.metrics.preemption_attempts.inc()
                self.metrics.preemption_victims.observe(len(best.victims))
            self.prepare_candidate(best, qp.pod)
            self.nominator.add(qp.pod, best.node_name)
            used_rows.add(best.row)
            out[qp.uid] = (best.node_name, Status())
        return out

    def batch_preempt(self, jobs, snapshot) -> dict:
        """Synchronous begin+finish (the scheduler's path and tests)."""
        handle, immediate = self.begin_batch_preempt(jobs, snapshot)
        if handle is not None:
            immediate.update(self.finish_batch_preempt(handle))
        return immediate

    # ---------------- the whole PostFilter flow ----------------

    def host_preempt(self, pod: Pod, snapshot) -> tuple[str | None, Status]:
        """The fallback ladder's serial host preemption: a later slice."""
        raise NotImplementedError(
            "host fallback ladder (serial host preemption): ROADMAP queue 1 "
            "item 11")

    def preempt(self, pod: Pod, snapshot,
                reject_counts=None,
                host_rejects=None) -> tuple[str | None, Status]:
        self.cache_snapshot = snapshot.node_info_map
        ok, why = self.pod_eligible_to_preempt_others(pod)
        if not ok:
            return None, Status.unschedulable(
                f"not eligible for preemption: {why}",
                plugin="DefaultPreemption")
        # fit-only rejection => the resource sweep alone is exact
        from kubernetes_tpu_torch.models.pipeline import FILTER_PLUGINS

        fit_idx = FILTER_PLUGINS.index("NodeResourcesFit")
        resource_only = (
            reject_counts is not None and not host_rejects
            and all(c == 0 for i, c in enumerate(reject_counts)
                    if i != fit_idx))
        candidates = self.find_candidates(pod, snapshot,
                                          resource_only=resource_only)
        pdbs = self.hub.list_pdbs()
        candidates = self.call_extenders(pod, candidates)
        for _ in range(min(len(candidates), MAX_VERIFY_CANDIDATES)):
            best = self.select_candidate(candidates)
            if best is None:
                break
            if resource_only:
                final = best        # sweep-exact: already minimal
            else:
                final = self._minimize_victims(pod, best, pdbs)
            if final is not None:
                if self.metrics is not None:
                    self.metrics.preemption_attempts.inc()
                    self.metrics.preemption_victims.observe(
                        len(final.victims))
                self.prepare_candidate(final, pod)
                self.nominator.add(pod, final.node_name)
                return final.node_name, Status()
            candidates = [c for c in candidates if c is not best]
        return None, Status.unschedulable(
            "no preemption candidates", plugin="DefaultPreemption")


class DefaultPreemption(PostFilterPlugin, PreEnqueuePlugin):
    """PostFilter plugin wrapper (default_preemption.go:133) + the
    PreEnqueue gate (:146): while a pod's async preemption is in flight it
    must not re-enter the activeQ — it would just fail again against a
    node whose victims haven't finished going away."""

    NAME = "DefaultPreemption"

    def __init__(self, evaluator: Evaluator):
        self.evaluator = evaluator

    def name(self) -> str:
        return self.NAME

    def pre_enqueue(self, pod: Pod) -> Status:
        if pod.metadata.uid in self.evaluator.preempting:
            return Status.unschedulable(
                "waiting for the preemption for this pod to be finished",
                plugin=self.NAME, resolvable=False)
        return Status()

    def post_filter(self, state, pod: Pod, diagnosis
                    ) -> tuple[str | None, Status]:
        snapshot = diagnosis.get("snapshot") if diagnosis else None
        if snapshot is None:
            return None, Status.unschedulable("no snapshot in diagnosis",
                                              plugin=self.NAME)
        return self.evaluator.preempt(
            pod, snapshot,
            reject_counts=diagnosis.get("reject_counts"),
            host_rejects=diagnosis.get("host_rejects"))
