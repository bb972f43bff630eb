"""InterPodAffinity + PodTopologySpread as topology-domain tensor ops (port
of the JAX package's ops/topology.py).

Each function evaluates ONE incoming pod (its PodFeatures fields carry no
batch axis) against the pod table and the nodes, as the reference does
before vmapping; the group loop is written out by the caller
(kernels/topology.py). The reference's notes follow.

The reference computes per-pod PreFilter state by scanning all pods on all
nodes into `(topologyKey, topologyValue) -> count` hash maps
(interpodaffinity/filtering.go:204-272, podtopologyspread/filtering.go:235+)
and then does per-node map lookups. The dense formulation replaces the hash
maps with per-topology-key domain arrays:

- every registered topology key tk has a compact domain-id space [0, D);
  a node's domain under tk is ``ct.topo_dom[n, tk]`` (NONE = label absent);
- "existing pod p affects all nodes in its domain" becomes a scatter of
  per-(pod-slot, term) matches into a ``[TK or A or C, D]`` map;
- "node n looks up its (key, value) pair" becomes a gather of that map at
  ``topo_dom[n, tk]``.

Index semantics follow the reference exactly: a gather clamps an index past
the end of the domain axis to its last entry, a scatter drops a flat index
past the end of the map.

Reference semantics implemented here:
- interpodaffinity/filtering.go: satisfyExistingPodsAntiAffinity (:352),
  satisfyPodAntiAffinity (:367), satisfyPodAffinity (:382) including the
  first-pod-of-a-group rule.
- interpodaffinity/scoring.go: processExistingPod (:81-123) — incoming
  preferred terms both directions, existing pods' required terms at
  hardPodAffinityWeight, existing pods' preferred terms.
- podtopologyspread/filtering.go: skew = matchNum + selfMatchNum -
  minMatchNum > maxSkew (:311), minDomains (:300), node-inclusion policies.
- podtopologyspread/scoring.go: scoreForCount (:300) with
  topologyNormalizingWeight = log(size + 2) (:292).
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops import common as C
from kubernetes_tpu_torch.ops.features import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NOT_IN,
    ClusterTensors,
    PodFeatures,
)
from kubernetes_tpu_torch.utils.interner import NONE


def _full(like: torch.Tensor, value, dtype=None) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype or like.dtype, device=like.device)


def take_cols(table: torch.Tensor, cols: torch.Tensor, fill
              ) -> torch.Tensor:
    """table: [R, K]; cols: [...] i32 (NONE allowed). -> [R, *cols.shape]."""
    k = table.shape[1]
    safe = cols.clamp(0, k - 1).reshape(-1).long()
    out = table[:, safe].reshape((table.shape[0],) + tuple(cols.shape))
    return torch.where(cols[None] >= 0, out, _full(table, fill))


def slot_topo_dom(ct: ClusterTensors) -> torch.Tensor:
    """[PT, TK]: topology domain of each table pod's node per topo key.
    Shared across the whole batch — compute once per launch."""
    tds = ct.topo_dom[ct.pod_node.clamp(min=0).long()]
    return torch.where(ct.pod_valid[:, None], tds, _full(tds, NONE))


def sel_match(ops: torch.Tensor, vals: torch.Tensor,
              tgt_vals: torch.Tensor) -> torch.Tensor:
    """Full LabelSelector match over op-coded expressions.

    ops: [..., MS] (NONE = unused slot); vals: [..., MS, V]; tgt_vals:
    [..., MS] = target's label value gathered at each expression's column
    (NONE = label absent). Semantics follow apimachinery labels.Requirement:
    In = present & value in set; NotIn = !present | value not in set;
    Exists = present; DoesNotExist = !present; unknown op matches nothing.
    Returns [...] bool: AND over used expressions."""
    present = tgt_vals != NONE
    inin = present & C.isin(tgt_vals, vals)
    false = torch.zeros_like(inin)
    m = torch.where(ops == OP_IN, inin,
        torch.where(ops == OP_NOT_IN, ~inin,
        torch.where(ops == OP_EXISTS, present,
        torch.where(ops == OP_DOES_NOT_EXIST, ~present, false))))
    return torch.all(m | (ops == NONE), dim=-1)


def table_mask(ct: ClusterTensors, pod: PodFeatures,
               include_nominated: bool) -> torch.Tensor:
    """[PT]: which table pods count for this incoming pod. Always excludes
    the pod's own entry (incl. its own nomination); nominated pods count
    only for anti-affinity constraints, not for required-affinity presence,
    scoring, or spread counts (the dual-pass rule of
    RunFilterPluginsWithNominatedPods, runtime/framework.go:989)."""
    m = ct.pod_valid & (ct.pod_uid != pod.uid_id)
    if not include_nominated:
        m = m & ~ct.pod_nominated
    return m


def incoming_terms_vs_table(ct: ClusterTensors, tbl_ok: torch.Tensor,
                            tk: torch.Tensor, ns: torch.Tensor,
                            ns_all: torch.Tensor, sel_cols: torch.Tensor,
                            sel_ops: torch.Tensor, sel_vals: torch.Tensor
                            ) -> torch.Tensor:
    """[PT, A]: does table pod s satisfy the incoming pod's term a?
    (AffinityTerm.Matches: s.ns in term.namespaces (or all-ns) and the
    selector expressions match s's labels). tbl_ok: [PT] from table_mask."""
    ns_ok = C.isin(ct.pod_ns[:, None], ns[None]) | ns_all[None]  # [PT, A]
    tv = take_cols(ct.pt_label_vals, sel_cols, NONE)           # [PT, A, MS]
    sel_ok = sel_match(sel_ops[None], sel_vals[None], tv)      # [PT, A]
    return ns_ok & sel_ok & tbl_ok[:, None] & (tk[None] != NONE)


def table_terms_vs_incoming(ct: ClusterTensors, tbl_ok: torch.Tensor,
                            grp_tk: torch.Tensor, grp_ns: torch.Tensor,
                            grp_ns_all: torch.Tensor,
                            grp_cols: torch.Tensor, grp_ops: torch.Tensor,
                            grp_vals: torch.Tensor,
                            pod: PodFeatures) -> torch.Tensor:
    """[PT, A]: does the incoming pod satisfy table pod s's term a?"""
    ns_ok = (torch.any((grp_ns == pod.ns) & (grp_ns != NONE), dim=-1)
             | grp_ns_all)                                     # [PT, A]
    kp = pod.plabel_vals.shape[0]
    pv = pod.plabel_vals[grp_cols.clamp(0, kp - 1).long()]    # [PT, A, MS]
    pv = torch.where(grp_cols >= 0, pv, _full(pv, NONE))
    sel_ok = sel_match(grp_ops, grp_vals, pv)                  # [PT, A]
    return ns_ok & sel_ok & (grp_tk != NONE) & tbl_ok[:, None]


def scatter_or(tk2d: torch.Tensor, dom2d: torch.Tensor, hit2d: torch.Tensor,
               num_rows: int, d_cap: int) -> torch.Tensor:
    """[num_rows, d_cap] bool: OR of hits at (row=tk2d, col=dom2d)."""
    ok = hit2d & (tk2d != NONE) & (dom2d != NONE)
    flat = tk2d.clamp(min=0).long() * d_cap + dom2d.clamp(min=0).long()
    ok = ok & (flat < num_rows * d_cap)
    m = torch.zeros((num_rows * d_cap,), dtype=torch.bool,
                    device=hit2d.device)
    m[flat[ok]] = True
    return m.reshape(num_rows, d_cap)


def scatter_add(flat: torch.Tensor, upd: torch.Tensor, size: int
                ) -> torch.Tensor:
    """[size] f32: ``upd`` summed at ``flat`` (indices past the end are
    dropped). Every update in this module is an integer below 2^24, so the
    sums are exact in any order."""
    flat = flat.reshape(-1).long()
    upd = upd.reshape(-1)
    keep = flat < size
    out = torch.zeros((size,), dtype=torch.float32, device=upd.device)
    return out.index_put_((flat[keep],), upd[keep], accumulate=True)


def gather_rows(m: torch.Tensor, dom: torch.Tensor) -> torch.Tensor:
    """m: [R, D]; dom: [N, R] domain per node per row -> m[r, dom[n, r]]
    masked where dom is NONE (False/0)."""
    r, d = m.shape
    rows = torch.arange(r, device=m.device)[None, :]
    vals = m[rows, dom.clamp(0, d - 1).long()]
    return torch.where(dom != NONE, vals, torch.zeros_like(vals))


# ----------------- in-batch (committed pods) machinery -----------------
#
# The batched commit scan preserves as-if-serial semantics: pod b sees pods
# 0..b-1's placements exactly as the serial loop's assume step would
# (schedule_one.go:938). Pairwise GROUP<->GROUP term matches are computed
# once per launch (labels and terms don't depend on placement), and the
# scan folds each commit into small node-space carry maps
# (kernels/scan.py).


def pair_term_match(tk: torch.Tensor, ns: torch.Tensor, ns_all: torch.Tensor,
                    cols: torch.Tensor, ops: torch.Tensor, vals: torch.Tensor,
                    tgt_labels: torch.Tensor, tgt_ns: torch.Tensor,
                    tgt_valid: torch.Tensor) -> torch.Tensor:
    """[Bx, A, By]: does batch pod y satisfy batch pod x's term a?

    tk [Bx, A]; ns [Bx, A, NS]; ns_all [Bx, A]; cols/ops [Bx, A, MS];
    vals [Bx, A, MS, V]; tgt_labels [By, Kp]; tgt_ns/tgt_valid [By]."""
    kp = tgt_labels.shape[1]
    pv = tgt_labels.T[cols.clamp(0, kp - 1).long()]     # [Bx, A, MS, By]
    pv = torch.where(cols[..., None] >= 0, pv, _full(pv, NONE))
    pv = torch.movedim(pv, -1, -2)                      # [Bx, A, By, MS]
    sel_ok = sel_match(ops[..., None, :], vals[..., None, :, :], pv)
    ns_ok = (torch.any((ns[..., :, None] == tgt_ns[None, None, None, :])
                       & (ns[..., :, None] != NONE), dim=2)
             | ns_all[..., None])                       # [Bx, A, By]
    return (ns_ok & sel_ok & (tk[..., None] != NONE)
            & tgt_valid[None, None, :])


def pair_tsc_match(pods: PodFeatures) -> torch.Tensor:
    """[Bx, C, By]: does batch pod y match batch pod x's spread constraint c?
    (same namespace + selector expressions over y's labels)"""
    kp = pods.plabel_vals.shape[1]
    pv = pods.plabel_vals.T[pods.tsc_sel_cols.clamp(0, kp - 1).long()]
    pv = torch.where(pods.tsc_sel_cols[..., None] >= 0, pv, _full(pv, NONE))
    pv = torch.movedim(pv, -1, -2)                      # [Bx, C, By, MS]
    sel_ok = sel_match(pods.tsc_sel_ops[..., None, :],
                       pods.tsc_sel_vals[..., None, :, :], pv)
    ns_ok = pods.ns[:, None, None] == pods.ns[None, None, :]
    return (sel_ok & ns_ok & (pods.tsc_tk[..., None] != NONE)
            & pods.valid[None, None, :])


# --------------------------- InterPodAffinity ---------------------------


def anti_affinity_maps(ct: ClusterTensors, pod: PodFeatures,
                       tds: torch.Tensor, d_cap: int) -> torch.Tensor:
    """[TK, D] bool: the domains the pre-batch table forbids to the pod —
    existing pods' required anti-affinity terms that match it (rule 1)
    OR'd with its own required anti-affinity terms' matches (rule 2). A
    node is forbidden when it lies in any of them; the reference keeps the
    two maps apart and ORs their gathers, which is the same."""
    tk_cap = ct.topo_dom.shape[1]
    anti_ok_tbl = table_mask(ct, pod, include_nominated=True)
    # 1. existing pods' required anti-affinity vs incoming pod
    m1 = table_terms_vs_incoming(ct, anti_ok_tbl, ct.pod_anti_tk,
                                 ct.pod_anti_ns, ct.pod_anti_ns_all,
                                 ct.pod_anti_sel_cols, ct.pod_anti_sel_ops,
                                 ct.pod_anti_sel_vals, pod)        # [PT, A]
    dom1 = torch.gather(tds, 1, ct.pod_anti_tk.clamp(0, tk_cap - 1).long())
    dom1 = torch.where(ct.pod_anti_tk != NONE, dom1, _full(dom1, NONE))
    f1 = scatter_or(ct.pod_anti_tk, dom1, m1, tk_cap, d_cap)       # [TK, D]
    # 2. incoming pod's required anti-affinity vs existing pods
    m2 = incoming_terms_vs_table(ct, anti_ok_tbl, pod.anti_tk, pod.anti_ns,
                                 pod.anti_ns_all, pod.anti_sel_cols,
                                 pod.anti_sel_ops, pod.anti_sel_vals)
    dom2 = tds[:, pod.anti_tk.clamp(0, tk_cap - 1).long()]         # [PT, A]
    dom2 = torch.where(pod.anti_tk[None] != NONE, dom2, _full(dom2, NONE))
    tk2 = pod.anti_tk[None].expand_as(m2)
    f2 = scatter_or(tk2, dom2, m2, tk_cap, d_cap)
    return f1 | f2


def affinity_presence(ct: ClusterTensors, pod: PodFeatures,
                      tds: torch.Tensor, d_cap: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rule 3, the pod's required affinity: (present [A, D] — the domains
    holding a table pod that matches term a; any_match — any term matched
    any table pod in a labeled domain)."""
    tk_cap = ct.topo_dom.shape[1]
    pres_tbl = table_mask(ct, pod, include_nominated=False)
    a_cap = pod.aff_tk.shape[0]
    m3 = incoming_terms_vs_table(ct, pres_tbl, pod.aff_tk, pod.aff_ns,
                                 pod.aff_ns_all, pod.aff_sel_cols,
                                 pod.aff_sel_ops, pod.aff_sel_vals)
    dom3 = tds[:, pod.aff_tk.clamp(0, tk_cap - 1).long()]          # [PT, A]
    dom3 = torch.where(pod.aff_tk[None] != NONE, dom3, _full(dom3, NONE))
    rows3 = torch.arange(a_cap, device=m3.device,
                         dtype=torch.int32)[None].expand_as(m3)
    present = scatter_or(rows3, dom3, m3, a_cap, d_cap)            # [A, D]
    term_used = pod.aff_tk != NONE
    any_match = torch.any(m3 & (dom3 != NONE) & term_used[None])
    return present, any_match


def inter_pod_affinity_static(ct: ClusterTensors, pod: PodFeatures,
                              tds: torch.Tensor, d_cap: int):
    """Pre-batch-table part of the Filter (filtering.go): returns
    (anti_ok [N] — rules 1+2 vs the table, present [A, D] — affinity
    presence map from the table, any_match — scalar). The commit scan
    layers in-batch deltas on top."""
    forbid = anti_affinity_maps(ct, pod, tds, d_cap)
    fail = torch.any(gather_rows(forbid, ct.topo_dom), dim=1)      # [N]
    present, any_match = affinity_presence(ct, pod, tds, d_cap)
    return ~fail, present, any_match


def affinity_score_map(ct: ClusterTensors, pod: PodFeatures,
                       tds: torch.Tensor, d_cap: int,
                       hard_weight: float) -> torch.Tensor:
    """[TK, D] f32: the weighted score each domain gives the pod
    (scoring.go processExistingPod), before the node gather."""
    tk_cap = ct.topo_dom.shape[1]
    size = tk_cap * d_cap
    tbl_ok = table_mask(ct, pod, include_nominated=False)
    score = torch.zeros((size,), dtype=torch.float32,
                        device=ct.topo_dom.device)

    def add_incoming(score, tk, ns, ns_all, cols, ops, vals, w, sign):
        m = incoming_terms_vs_table(ct, tbl_ok, tk, ns, ns_all, cols, ops,
                                    vals)
        dom = tds[:, tk.clamp(0, tk_cap - 1).long()]
        ok = m & (dom != NONE) & (tk[None] != NONE)
        flat = tk[None].clamp(min=0).long() * d_cap + dom.clamp(min=0).long()
        upd = torch.where(ok, sign * w[None].to(torch.float32),
                          _full(score, 0.0))
        return score + scatter_add(flat, upd, size)

    def add_table(score, tk, ns, ns_all, cols, ops, vals, w, sign):
        m = table_terms_vs_incoming(ct, tbl_ok, tk, ns, ns_all, cols, ops,
                                    vals, pod)
        dom = torch.gather(tds, 1, tk.clamp(0, tk_cap - 1).long())
        ok = m & (dom != NONE) & (tk != NONE)
        flat = tk.clamp(min=0).long() * d_cap + dom.clamp(min=0).long()
        upd = torch.where(ok, sign * w.to(torch.float32), _full(score, 0.0))
        return score + scatter_add(flat, upd, size)

    score = add_incoming(score, pod.paff_tk, pod.paff_ns, pod.paff_ns_all,
                         pod.paff_sel_cols, pod.paff_sel_ops,
                         pod.paff_sel_vals, pod.paff_weight, 1.0)
    score = add_incoming(score, pod.panti_tk, pod.panti_ns, pod.panti_ns_all,
                         pod.panti_sel_cols, pod.panti_sel_ops,
                         pod.panti_sel_vals, pod.panti_weight, -1.0)
    hw = torch.full(ct.pod_aff_tk.shape, float(hard_weight),
                    dtype=torch.float32, device=score.device)
    score = add_table(score, ct.pod_aff_tk, ct.pod_aff_ns, ct.pod_aff_ns_all,
                      ct.pod_aff_sel_cols, ct.pod_aff_sel_ops,
                      ct.pod_aff_sel_vals, hw, 1.0)
    score = add_table(score, ct.pod_paff_tk, ct.pod_paff_ns,
                      ct.pod_paff_ns_all, ct.pod_paff_sel_cols,
                      ct.pod_paff_sel_ops, ct.pod_paff_sel_vals,
                      ct.pod_paff_weight, 1.0)
    score = add_table(score, ct.pod_panti_tk, ct.pod_panti_ns,
                      ct.pod_panti_ns_all, ct.pod_panti_sel_cols,
                      ct.pod_panti_sel_ops, ct.pod_panti_sel_vals,
                      ct.pod_panti_weight, -1.0)
    return score.reshape(tk_cap, d_cap)


def inter_pod_affinity_score(ct: ClusterTensors, pod: PodFeatures,
                             tds: torch.Tensor, d_cap: int,
                             hard_weight: float) -> torch.Tensor:
    """[N] raw score (scoring.go processExistingPod); normalized max-min at
    aggregation (NormalizeScore :258)."""
    score = affinity_score_map(ct, pod, tds, d_cap, hard_weight)
    return C.sum_last(gather_rows(score, ct.topo_dom))             # [N]


# --------------------------- PodTopologySpread ---------------------------


def _tsc_self_match(pod: PodFeatures) -> torch.Tensor:
    """[C]: does the pod match its own constraint selector? (selfMatchNum)"""
    kp = pod.plabel_vals.shape[0]
    pv = pod.plabel_vals[pod.tsc_sel_cols.clamp(0, kp - 1).long()]  # [C, MS]
    pv = torch.where(pod.tsc_sel_cols >= 0, pv, _full(pv, NONE))
    return sel_match(pod.tsc_sel_ops, pod.tsc_sel_vals, pv)


def _tsc_matches(ct: ClusterTensors, pod: PodFeatures) -> torch.Tensor:
    """[PT, C]: table pod s matches constraint c's selector in pod's ns.
    Nominated pods and the pod's own entry are excluded from spread counts
    (shouldn't double-count itself; nominated pods may never run)."""
    ns_ok = ct.pod_ns[:, None] == pod.ns                           # [PT, 1]
    tv = take_cols(ct.pt_label_vals, pod.tsc_sel_cols, NONE)  # [PT, C, MS]
    sel_ok = sel_match(pod.tsc_sel_ops[None], pod.tsc_sel_vals[None], tv)
    tbl = table_mask(ct, pod, include_nominated=False)
    return sel_ok & ns_ok & tbl[:, None] & (pod.tsc_tk[None] != NONE)


def spread_eligible(ct: ClusterTensors, pod: PodFeatures,
                    nodeaff_ok: torch.Tensor, taint_ok: torch.Tensor,
                    consider: torch.Tensor) -> torch.Tensor:
    """[N, C] node-inclusion eligibility per constraint
    (matchNodeInclusionPolicies, common.go:33-127), plus the
    requireAllTopologies rule: a node missing ANY considered constraint's
    topology label is ignored entirely (filtering.go calPreFilterState).

    ``consider`` [C] selects the constraint set: the Filter path evaluates
    only DoNotSchedule constraints, the Score path only ScheduleAnyway."""
    node_dom = take_cols(ct.topo_dom, pod.tsc_tk, NONE)            # [N, C]
    all_topo = torch.all((node_dom != NONE) | ~consider[None], dim=1)
    base = ct.node_valid & all_topo                                # [N]
    true = torch.ones_like(node_dom, dtype=torch.bool)
    ok = torch.where(pod.tsc_honor_affinity[None], nodeaff_ok[:, None], true)
    ok = ok & torch.where(pod.tsc_honor_taints[None], taint_ok[:, None],
                          true)
    return base[:, None] & ok & consider[None]                     # [N, C]


def spread_cnt(ct: ClusterTensors, pod: PodFeatures, tds: torch.Tensor,
               eligible: torch.Tensor, d_cap: int) -> torch.Tensor:
    """[C, D] f32: matching pods per (constraint, domain), counting only
    pods on nodes eligible for that constraint (TpPairToMatchNum)."""
    tk_cap = ct.topo_dom.shape[1]
    c_cap = pod.tsc_tk.shape[0]
    m = _tsc_matches(ct, pod)                                      # [PT, C]
    m = m & eligible[ct.pod_node.clamp(min=0).long()]              # [PT, C]
    dom = tds[:, pod.tsc_tk.clamp(0, tk_cap - 1).long()]           # [PT, C]
    dom = torch.where(pod.tsc_tk[None] != NONE, dom, _full(dom, NONE))
    ok = m & (dom != NONE)
    flat = (torch.arange(c_cap, device=m.device)[None].expand_as(m) * d_cap
            + dom.clamp(min=0).long())
    cnt = scatter_add(flat, ok.to(torch.float32), c_cap * d_cap)
    return cnt.reshape(c_cap, d_cap)


def spread_exists(ct: ClusterTensors, pod: PodFeatures,
                  node_mask: torch.Tensor, d_cap: int) -> torch.Tensor:
    """[C, D] bool: domains present among masked-in nodes per constraint.
    node_mask: [N, C]."""
    c_cap = pod.tsc_tk.shape[0]
    node_dom = take_cols(ct.topo_dom, pod.tsc_tk, NONE)            # [N, C]
    rows = torch.arange(c_cap, device=node_dom.device,
                        dtype=torch.int32)[None].expand_as(node_dom)
    return scatter_or(rows, node_dom, node_mask, c_cap, d_cap)
