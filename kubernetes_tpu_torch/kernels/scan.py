"""K3 serial_scan: wrapper around csrc/serial_scan.cu and its twin.

The as-if-serial commit scan of one launch (the JAX package's
models/pipeline.py serial path: ``perturb_rows`` :1181, ``port_conf``
:1186, ``queries`` :1193, ``map_updates`` :1291, ``body`` :1358 and the
``lax.scan`` over the batch :1571): pod b is filtered and scored against
the live state that pods 0..b-1's commits left — free resources, in-batch
hostPort clashes, and, on a topology launch, the carry maps of in-batch
(anti)affinity and spread counts — then its argmax node is committed.

``serial_scan_ref`` is the twin: a plain Python loop over the batch of
torch ops over the node axis, mirroring ``body``/``queries``/
``map_updates``. ``serial_scan`` launches the kernel (one thread-block
cluster per batch, csrc/serial_scan.cu) for CUDA tensors and runs the twin
only for CPU tensors. ``plan_scan`` lays out each block's shared memory:
which arrays the block keeps there for the whole launch and which stay in
global memory (the choice is made here, from a byte count).
``free``/``nzr`` are updated in place, and so is ``pct_start`` when the
percentageOfNodesToScore window is on (``pct_window``, the reference's
``body`` :1418-1450). With ``ScanInputs.learned`` set (a kernels/learned.py
LearnedParams), every step adds ``w_learned`` times the learned score term
(K9, csrc/learned_mlp.cuh; twin ops/learned.py) after ``w_ipa * ipa``, from
that step's (windowed) normalized scores (``body`` :1458-1474).

Export outputs (``ScanInputs.exp_feats`` / ``exp_alts``, and with a
learned scorer always the learned magnitude; the reference's ``body``
:1466-1474, :1576-1589): each step writes the chosen (or, unplaced, node
0's) feature row, the top ALT_K of its live totals over its feasible
(windowed) nodes, and its learned magnitude, summed in the kernel's order
(``scan_lmag_sum``, which the twin repeats from the plan's cluster shape,
``lmag_order_of``); ``scan_export`` turns them into BatchResult's
tails. The feature and alternative outputs are the kernel's export
instantiation: the others carry no export bytes.

Caps: R, C, TK and the shape's points size the layout at launch; the one
limit is the block's fixed shared-memory front (``plan_fits``), past
which the launch is refused.

Exactness: the carry updates add integers (counts, and weights <= 100 at
hardPodAffinityWeight 1), so every float sum stays below 2^24 and is exact
in any order; maxima and minima are exact in any order; the score is
formed with the same operations in the same order in twin and kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from kubernetes_tpu_torch.kernels import auction as KA
from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.kernels.topology import (
    HARD_POD_AFFINITY_WEIGHT,
    TopoStatics,
)
from kubernetes_tpu_torch.ops import common as C
from kubernetes_tpu_torch.ops import filters as FL
from kubernetes_tpu_torch.ops import learned as LN
from kubernetes_tpu_torch.ops import scores as SC
from kubernetes_tpu_torch.utils.interner import NONE

# minFeasibleNodesToFind (schedule_one.go:39-45): below this cluster-wide
# feasible count the percentageOfNodesToScore window never truncates
MIN_FEASIBLE_NODES_TO_FIND = 100

# pct sentinel: config percentageOfNodesToScore == 0, the reference's
# adaptive percentage (50 - nodes/125, at least 5)
ADAPTIVE_PCT = -1


def pct_k_find(pct: int, num_valid: int) -> int:
    """numFeasibleNodesToFind (schedule_one.go:668-694): how many feasible
    nodes the window keeps."""
    eff = max(5, 50 - num_valid // 125) if pct == ADAPTIVE_PCT else pct
    return max(MIN_FEASIBLE_NODES_TO_FIND, (num_valid * eff) // 100)


def pct_window(feasible: torch.Tensor, valid: torch.Tensor, start: int,
               k_find: int) -> tuple[torch.Tensor, int]:
    """The window of one scan step (pipeline.py:1418-1450 of the
    reference): keep the first ``k_find`` feasible nodes in rotating
    order from ``start``; advance ``start`` past the nodes processed and
    snap it to the next valid row. Returns (feasible, new start)."""
    n = feasible.shape[0]
    rolled = torch.roll(feasible, -start)
    csum = torch.cumsum(rolled.to(torch.int32), dim=0)
    out = torch.roll(rolled & (csum <= k_find), start)
    reach = csum >= k_find
    processed = (int(torch.argmax(reach.to(torch.int32))) + 1
                 if bool(reach[-1]) else n)
    start = (start + processed) % n
    start = (start + int(torch.argmax(
        torch.roll(valid, -start).to(torch.int32)))) % n
    return out, start

@dataclass
class GroupTerms:
    """The topology groups' own terms and constraints (rows of the group
    representatives): what the scan indexes by a pod's group id."""

    anti_tk: torch.Tensor     # [G, A] i32
    aff_tk: torch.Tensor      # [G, A] i32
    paff_tk: torch.Tensor     # [G, A] i32
    panti_tk: torch.Tensor    # [G, A] i32
    paff_w: torch.Tensor      # [G, A] f32
    panti_w: torch.Tensor     # [G, A] f32
    tsc_tk: torch.Tensor      # [G, C] i32
    tsc_hard: torch.Tensor    # [G, C] bool
    tsc_skew: torch.Tensor    # [G, C] i32
    tsc_mind: torch.Tensor    # [G, C] i32
    aff_self: torch.Tensor    # [G] bool

    @staticmethod
    def of(pods_rep) -> "GroupTerms":
        c = lambda t: t.contiguous()  # noqa: E731
        return GroupTerms(
            c(pods_rep.anti_tk), c(pods_rep.aff_tk), c(pods_rep.paff_tk),
            c(pods_rep.panti_tk), pods_rep.paff_weight.to(torch.float32),
            pods_rep.panti_weight.to(torch.float32), c(pods_rep.tsc_tk),
            c(pods_rep.tsc_hard), c(pods_rep.tsc_max_skew),
            c(pods_rep.tsc_min_domains), c(pods_rep.aff_self_match))


@dataclass
class ScanInputs:
    """One launch's scan state. ``free``/``nzr`` are updated in place."""

    free: torch.Tensor        # [N, R] f32
    nzr: torch.Tensor         # [N, 2] f32
    nom: torch.Tensor         # [N, R] f32 nominated reservations
    alloc2: torch.Tensor      # [N, 2] f32
    req: torch.Tensor         # [B, R] f32
    nzreq: torch.Tensor       # [B, 2] f32
    nominated_row: torch.Tensor  # [B] i32
    uid: torch.Tensor         # [B] i32
    g1: torch.Tensor          # [B] i32 phase-1 row of each pod
    static_ok: torch.Tensor   # [G1, N] bool
    taint_raw: torch.Tensor   # [G1, N] f32
    aff_raw: torch.Tensor     # [G1, N] f32
    img: torch.Tensor         # [G1, N] f32
    hp_port: torch.Tensor     # [B, HP] i32
    hp_proto: torch.Tensor    # [B, HP] i32
    hp_ip: torch.Tensor       # [B, HP] i32
    wildcard_ip: int
    ports: bool               # "ports" active: in-batch hostPort clashes
    weights: tuple            # 7 floats, ScoreWeights order
    fit_on: bool = True
    fit_strategy: str = "LeastAllocated"
    fit_shape: Optional[tuple] = None
    seed: int = 0
    # topology launch only
    gid: Optional[torch.Tensor] = None        # [B] i32 topology group
    topo_dom: Optional[torch.Tensor] = None   # [N, TK] i32
    st: Optional[TopoStatics] = None
    terms: Optional[GroupTerms] = None
    spread_on: bool = False
    ipa_on: bool = False
    # percentageOfNodesToScore window: 0 off, ADAPTIVE_PCT, or a percent
    pct: int = 0
    pct_start: Optional[torch.Tensor] = None  # [1] i32, updated in place
    node_valid: Optional[torch.Tensor] = None  # [N] bool
    # the learned score term (K9): packed params and ScoreWeights.learned
    learned: Optional[KL.LearnedParams] = None
    w_learned: float = 0.0
    # the export outputs: the chosen row's features, the top ALT_K of the
    # live totals; with `learned`, each step's learned magnitude, folded
    # over the valid pods (``pod_valid`` [B] bool)
    exp_feats: bool = False
    exp_alts: bool = False
    pod_valid: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.free.shape[0]

    @property
    def b(self) -> int:
        return self.req.shape[0]

    @property
    def topo(self) -> bool:
        return self.st is not None


class ScanResult(NamedTuple):
    rows: torch.Tensor         # [B] i32
    win: torch.Tensor          # [B] f32
    feas: torch.Tensor         # [B] i32
    rejects: torch.Tensor      # [B, 4] i32: ports, fit, spread, ipa
    # the export outputs (None where off): each step's learned magnitude
    # and their sum over the valid pods in batch order, the chosen (or,
    # unplaced, node 0's) feature row, the top ALT_K rows and totals
    lmag_step: Optional[torch.Tensor] = None   # [B] f32
    lmag_sum: Optional[torch.Tensor] = None    # [1] f32
    chosen_feat: Optional[torch.Tensor] = None  # [B, 9] f32
    alt_row: Optional[torch.Tensor] = None     # [B, ALT_K] i32
    alt_score: Optional[torch.Tensor] = None   # [B, ALT_K] f32


def default_lmag_order(n: int) -> tuple:
    """(cluster, per, threads) of plan_scan's 16-block cluster over n
    nodes: the twin's learned-magnitude order when no plan is given."""
    per = -(-(-(-n // 16)) // 32) * 32
    return 16, per, min(MAX_THREADS, max(128, per))


def lmag_order_of(s: "ScanInputs") -> tuple:
    """The twin's learned-magnitude order for these inputs: on the card,
    the plan the kernel takes there (so a twin run on CUDA tensors sums
    as the kernel does); on the CPU, the 16-block plan."""
    if s.free.device.type == "cuda":
        plan = scan_plan(s)
        return plan.cluster, plan.per, plan.threads
    return default_lmag_order(s.n)


def scan_lmag_sum(v: torch.Tensor, order: tuple) -> torch.Tensor:
    """[] the kernel's sum of a step's [N] values: block r of ``cluster``
    owns nodes [r * per, r * per + per); thread t adds its nodes t, t +
    threads, ... in order; a warp's xor tree, then the block's warps' and
    the cluster's blocks' (zeros past the last) the same way."""
    cluster, per, threads = order
    n = v.shape[0]
    x = torch.cat([v, v.new_zeros(cluster * per - n)]).reshape(cluster, per)
    k = -(-per // threads)
    x = torch.cat([x, x.new_zeros(cluster, k * threads - per)], dim=1)
    x = x.reshape(cluster, k, threads)
    acc = x[:, 0]
    for i in range(1, k):
        acc = acc + x[:, i]
    warps = KA.halving_tree(acc.reshape(cluster, threads // 32, 32))
    warps = torch.cat([warps, warps.new_zeros(cluster, 32 - warps.shape[1])],
                      dim=1)
    blocks = KA.halving_tree(warps)
    return KA.halving_tree(torch.cat([blocks,
                                      blocks.new_zeros(32 - cluster)]))


def scan_export(s: "ScanInputs", res: ScanResult) -> KA.ExportOut:
    """BatchResult's export tails from a scan's outputs: learned_mag the
    mean over the valid pods of the steps' magnitudes (their sum in batch
    order over max(valid, 1)), the rest as the scan wrote them."""
    dev = res.rows.device
    out = KA.empty_export(res.rows.shape[0], dev)
    lmag = out.learned_mag
    if s.learned is not None:
        n_valid = int(s.pod_valid.sum()) if s.pod_valid is not None \
            else res.rows.shape[0]
        lmag = res.lmag_sum[0] / torch.tensor(
            float(max(n_valid, 1)), dtype=torch.float32, device=dev)
    return KA.ExportOut(
        lmag, res.chosen_feat if s.exp_feats else out.chosen_feat,
        res.alt_row if s.exp_alts else out.alt_row,
        res.alt_score if s.exp_alts else out.alt_score)


# ---------------------------------------------------------------- twin


def _queries(s: ScanInputs, g: int, cy: dict):
    """Per-step topology verdicts for a group-g pod from the carry maps
    (pipeline.py queries): (ipa_ok, sp_ok, sp_r, ipa_live), [N] each."""
    st, tm = s.st, s.terms
    nd, pr = st.nodes, st.pairs
    term_used = tm.aff_tk[g] != NONE                              # [A]
    term_ok = nd.term_static[g] | cy["pres"][g].T                 # [N, A]
    pods_exist = torch.all(term_ok | ~term_used[None], dim=1)
    all_lbl = torch.all(nd.has_lbl[g] | ~term_used[None], dim=1)
    any_match = st.maps.any_match[g] | cy["any3"][g]
    self_ok = tm.aff_self[g] & ~any_match & all_lbl
    aff_ok = torch.where(term_used.any(), pods_exist | self_ok,
                         torch.ones_like(pods_exist))
    ipa_ok = nd.anti_ok[g] & ~cy["forbid1"][g] & ~cy["map2"][g] & aff_ok
    used = tm.tsc_tk[g] != NONE
    used_hard = used & tm.tsc_hard[g]
    used_soft = used & ~tm.tsc_hard[g]
    min_cnt = spread_min(st.maps.cnt[g] + cy["cntmap"][g],
                         nd.exists_hard[g], tm.tsc_mind[g],
                         pr.num_domains[g])                       # [C]
    match_num = nd.match_static[g] + cy["cnt_match"][g].T         # [N, C]
    skew = match_num + pr.self_match[g][None] - min_cnt[None]
    max_skew = tm.tsc_skew[g][None].to(torch.float32)
    ok_c = nd.dom_ok[g] & (skew <= max_skew)
    sp_ok = torch.all(ok_c | ~used_hard[None], dim=1)             # [N]
    per_c = match_num * pr.tpw[g][None] + (max_skew - 1.0)
    per_c = torch.where(used_soft[None] & nd.dom_ok[g], per_c,
                        torch.zeros_like(per_c))
    sp_r = torch.where(nd.ign[g], torch.zeros_like(per_c[:, 0]),
                       C.sum_last(per_c))
    ipa_live = nd.ipa_raw[g] + cy["wscore"][g]
    return ipa_ok, sp_ok, sp_r, ipa_live


def spread_min(cnt_live: torch.Tensor, exists: torch.Tensor,
               min_domains: torch.Tensor, num_domains: torch.Tensor
               ) -> torch.Tensor:
    """[..., C] the spread minimum of each constraint over its existing
    domains (pipeline.py queries): 0 when none exists, or when the
    constraint's minDomains exceeds its domain count. ``cnt_live`` and
    ``exists`` are [..., C, D]."""
    m = C.masked_min(cnt_live, exists, dim=-1)
    zero = torch.zeros_like(m)
    m = torch.where(torch.isfinite(m), m, zero)
    return torch.where((min_domains > 0) & (num_domains < min_domains),
                       zero, m)


def _same_dom(topo_dom: torch.Tensor, dom_row: torch.Tensor,
              tk: torch.Tensor) -> torch.Tensor:
    """[N, *tk.shape] bool: node n shares the committed node's domain under
    key tk (an unused key, NONE, shares nothing)."""
    safe = tk.clamp(min=0).long()
    d = dom_row[safe]
    return ((topo_dom[:, safe] == d[None]) & (d[None] != NONE)
            & (tk[None] != NONE))


def _map_updates(s: ScanInputs, g: int, r: int, cy: dict) -> None:
    """Fold ONE commit (group-g pod on node row r) into the carry maps
    (pipeline.py map_updates), in place."""
    st, tm = s.st, s.terms
    m_anti, m_aff, m_paff, m_panti = st.pairs.m_terms
    m_tsc = st.pairs.m_tsc
    dom_row = s.topo_dom[r]                                       # [TK]
    sd = lambda tk: _same_dom(s.topo_dom, dom_row, tk)  # noqa: E731
    # the committed pod's own anti terms forbid its domains to the groups
    # they match; each group's own anti terms forbid the committed pod's
    nd_j = sd(tm.anti_tk[g])                                      # [N, A]
    cy["forbid1"] |= (nd_j[:, :, None] & m_anti[g][None]).any(1).T
    nd_gb = sd(tm.anti_tk)                                        # [N, G, A]
    cy["map2"] |= (nd_gb & m_anti[:, :, g][None]).any(-1).T
    # required affinity: presence of a matching pod in the node's domain
    nd_aff = sd(tm.aff_tk)                                        # [N, G, A]
    cy["pres"] |= (nd_aff & m_aff[:, :, g][None]).permute(1, 2, 0)
    d3 = dom_row[tm.aff_tk.clamp(min=0).long()]                   # [G, A]
    dv3 = (tm.aff_tk != NONE) & (d3 != NONE)
    cy["any3"] |= (m_aff[:, :, g] & dv3).any(1)
    # weighted ipa score deltas (scoring.go processExistingPod): the
    # committed pod's terms (j side) and each group's terms (b side)
    f = lambda x: x.to(torch.float32)  # noqa: E731
    hw = HARD_POD_AFFINITY_WEIGHT
    j_side = (
        (f(sd(tm.aff_tk[g]))[:, :, None] * (f(m_aff[g]) * hw)[None]).sum(1)
        + (f(sd(tm.paff_tk[g]))[:, :, None]
           * (f(m_paff[g]) * tm.paff_w[g][:, None])[None]).sum(1)
        - (f(sd(tm.panti_tk[g]))[:, :, None]
           * (f(m_panti[g]) * tm.panti_w[g][:, None])[None]).sum(1))
    b_side = (
        (f(sd(tm.paff_tk)) * (f(m_paff[:, :, g]) * tm.paff_w)[None]).sum(-1)
        - (f(sd(tm.panti_tk))
           * (f(m_panti[:, :, g]) * tm.panti_w)[None]).sum(-1))   # [N, G]
    cy["wscore"] += j_side.T + b_side.T
    # spread counts: domain space (for the min) + node space (for match)
    hits = m_tsc[:, :, g] & st.nodes.el_node[:, r, :]             # [G, C]
    d_c = dom_row[tm.tsc_tk.clamp(min=0).long()]                  # [G, C]
    dv = hits & (d_c != NONE) & (tm.tsc_tk != NONE)
    d_cap = cy["cntmap"].shape[-1]
    dv = dv & (d_c < d_cap)
    gi, ci = torch.nonzero(dv, as_tuple=True)
    cy["cntmap"][gi, ci, d_c[gi, ci].long()] += 1.0
    nd_tsc = sd(tm.tsc_tk)                                        # [N, G, C]
    cy["cnt_match"] += f(nd_tsc & hits[None]).permute(1, 2, 0)


def serial_scan_ref(s: ScanInputs, carries: Optional[dict] = None
                    ) -> ScanResult:
    """The plain-torch twin of the scan: one step per pod, in batch order.
    ``carries``, when given, receives the final carry maps (CARRIES)."""
    b_n, n = s.b, s.n
    dev = s.free.device
    rows = torch.full((b_n,), -1, dtype=torch.int32, device=dev)
    win = torch.zeros((b_n,), dtype=torch.float32, device=dev)
    feas = torch.zeros((b_n,), dtype=torch.int32, device=dev)
    rejects = torch.zeros((b_n, 4), dtype=torch.int32, device=dev)
    committed = torch.full((b_n,), -1, dtype=torch.int64, device=dev)
    if s.ports:
        port_conf = FL.pod_pair_port_conflict(s, s.wildcard_ip)
    else:
        port_conf = torch.zeros((b_n, b_n), dtype=torch.bool, device=dev)
    cy = None
    if s.topo:
        g_cap = s.st.nodes.anti_ok.shape[0]
        a_cap = s.terms.aff_tk.shape[1]
        c_cap = s.terms.tsc_tk.shape[1]
        d_cap = s.st.maps.cnt.shape[-1]
        zb = lambda *sh: torch.zeros(sh, dtype=torch.bool,  # noqa: E731
                                     device=dev)
        zf = lambda *sh: torch.zeros(sh, dtype=torch.float32,  # noqa: E731
                                     device=dev)
        cy = {"forbid1": zb(g_cap, n), "map2": zb(g_cap, n),
              "pres": zb(g_cap, a_cap, n), "any3": zb(g_cap),
              "wscore": zf(g_cap, n), "cntmap": zf(g_cap, c_cap, d_cap),
              "cnt_match": zf(g_cap, c_cap, n)}
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    zeros_f = torch.zeros((n,), dtype=torch.float32, device=dev)
    w = s.weights
    if s.pct:
        start = int(s.pct_start.reshape(-1)[0])
        k_find = pct_k_find(s.pct, int(s.node_valid.sum()))
    node_idx = torch.arange(n, device=dev)
    lmag_step = lmag_sum = chosen_feat = alt_row = alt_score = None
    if s.learned is not None:
        lmag_step = torch.zeros((b_n,), dtype=torch.float32, device=dev)
        lmag_sum = torch.zeros((1,), dtype=torch.float32, device=dev)
        order = lmag_order_of(s)
    if s.exp_feats:
        chosen_feat = torch.zeros((b_n, LN.NUM_FEATURES),
                                  dtype=torch.float32, device=dev)
    if s.exp_alts:
        alt_row = torch.full((b_n, KA.ALT_K), -1, dtype=torch.int32,
                             device=dev)
        alt_score = torch.full((b_n, KA.ALT_K), KA.ALT_NONE,
                               dtype=torch.float32, device=dev)
    for b in range(b_n):
        g1 = int(s.g1[b])
        ok_s = s.static_ok[g1]
        if s.topo:
            g = int(s.gid[b])
            ipa_ok, sp_ok, sp_r, ipa_live = _queries(s, g, cy)
            if not s.spread_on:
                sp_ok = ones
            if not s.ipa_on:
                ipa_ok = ones
            ign_b = s.st.nodes.ign[g]
            soft_b = bool(s.st.pairs.has_soft[g])
        else:
            sp_ok = ipa_ok = ones
            sp_r = ipa_live = zeros_f
            ign_b = ~ones
            soft_b = False
        req = s.req[b]
        if s.fit_on:
            own = node_idx == s.nominated_row[b]
            eff = (s.free - s.nom) + torch.where(
                own[:, None], req[None], torch.zeros_like(req)[None])
            fit_ok = torch.all(req[None] <= eff, dim=-1)
        else:
            fit_ok = ones
        clash = port_conf[b] & (committed >= 0)
        forbidden = torch.zeros((n,), dtype=torch.bool, device=dev)
        forbidden[committed[clash]] = True
        ports_ok = ~forbidden
        feasible = ok_s & ports_ok & fit_ok & sp_ok & ipa_ok
        if s.pct:
            # the reject counts stay counted over the whole cluster
            feasible, start = pct_window(feasible, s.node_valid, start,
                                         k_find)
        frac = SC.utilization_fractions(s.alloc2, s.nzr, s.nzreq[b:b + 1])
        least = SC.fit_score_from_fractions(frac, s.fit_strategy,
                                            s.fit_shape)[0]
        bal = SC.balanced_allocation_from_fractions(frac)[0]
        fz = feasible[None]
        taint = SC.normalize_inverse(s.taint_raw[g1][None], fz)[0]
        aff = SC.normalize_max(s.aff_raw[g1][None], fz)[0]
        ipa = SC.normalize_maxmin(ipa_live[None], fz)[0]
        spread = (SC.normalize_spread(sp_r[None], fz, ign_b[None])[0]
                  if soft_b else zeros_f)
        total = (w[0] * taint + w[1] * aff + w[2] * least + w[3] * bal
                 + w[4] * s.img[g1] + w[5] * spread + w[6] * ipa)
        if s.learned is not None:
            lt = s.w_learned * LN.learned_term(
                s.learned.layers, frac[0], least, bal, taint, aff,
                s.img[g1], spread, ipa)
            total = total + lt
            ssum = scan_lmag_sum(torch.where(feasible, torch.abs(lt),
                                             zeros_f), order)
            lmag_step[b] = ssum / torch.tensor(
                float(max(int(feasible.sum()), 1)), dtype=torch.float32,
                device=dev)
            if s.pod_valid is None or bool(s.pod_valid[b]):
                lmag_sum[0] = lmag_sum[0] + lmag_step[b]
        perturb = KA.tie_perturb(s.uid[b:b + 1], n, s.seed)
        row = int(C.masked_argmax_random(total[None], fz, perturb)[0])
        if s.exp_feats:
            chosen_feat[b] = LN.feature_row_at(
                max(row, 0), frac[0], least, bal, taint, aff, s.img[g1],
                spread, ipa)
        if s.exp_alts:
            alt_row[b], alt_score[b] = KA.top_alts(torch.where(
                feasible, total, torch.tensor(KA.ALT_NONE, device=dev)))
        ok_ports = ok_s & ports_ok
        ok_fit = ok_ports & fit_ok
        ok_sp = ok_fit & sp_ok
        rejects[b, 0] = int((ok_s & ~ports_ok).sum())
        rejects[b, 1] = int((ok_ports & ~fit_ok).sum())
        rejects[b, 2] = int((ok_fit & ~sp_ok).sum())
        rejects[b, 3] = int((ok_sp & ~ipa_ok).sum())
        feas[b] = int(feasible.sum())
        rows[b] = row
        committed[b] = row
        if row >= 0:
            win[b] = total[row]
            s.free[row] -= req
            s.nzr[row] += s.nzreq[b]
            if s.topo:
                _map_updates(s, int(s.gid[b]), row, cy)
    if s.pct:
        s.pct_start.fill_(start)
    if carries is not None and cy is not None:
        carries.update({k: cy[k] for k in CARRIES})
    return ScanResult(rows, win, feas, rejects, lmag_step, lmag_sum,
                      chosen_feat, alt_row, alt_score)


def serial_scan(s: ScanInputs) -> ScanResult:
    """K3: the kernel for CUDA tensors, the twin for CPU tensors."""
    dev = s.free.device
    if dev.type == "cpu":
        return serial_scan_ref(s)
    if dev.type != "cuda":
        raise ValueError(f"serial_scan: unsupported device {dev}")
    return _scan_kernel(s)


# ---------------------------------------------------------------- kernel

# the carry maps a scan leaves (the kernel writes them back at the end)
CARRIES = ("forbid1", "map2", "pres", "any3", "wscore", "cnt_match")

# csrc/serial_scan.cu's layout constants
SMEM_MAX = 232448          # dynamic shared memory a block can use (227 KB)
MAX_THREADS = 512
MAX_WARPS = 32
RF, RI = 6, 7
SLOT_WORDS = 16
BEST_HEAD = 8
MAX_CLUSTER = 16
ALT_K = KA.ALT_K
CLUSTERS = (16, 8)         # the non-portable 16-block cluster, else 8
K9_WARPS = MAX_THREADS // 32   # the warps K9's shared region is sized by

# The arrays plan_scan places, in priority order, each with its element
# bytes, its kind and its shape in dims (K, J) of a node-space array
# [K, N, J] (a block holds K x per x J elements) or, for a table, its
# element count. Mirrored by csrc/serial_scan.cu's PA_* enum.
PLACED = (
    ("forbid1", 1, "carry", ("G", 1)),
    ("map2", 1, "carry", ("G", 1)),
    ("pres", 1, "carry", ("GA", 1)),
    ("wscore", 4, "carry", ("G", 1)),
    ("cnt_match", 4, "carry", ("GC", 1)),
    ("free", 4, "carry", (1, "R")),
    ("nzr", 4, "carry", (1, 2)),
    ("feas", 1, "scratch", (1, 1)),
    ("ipa", 4, "scratch", (1, 1)),
    ("sp", 4, "scratch", (1, 1)),
    ("forb", 4, "scratch", ("PORTS", 1)),
    ("m_terms", 1, "table", "4GAG"),
    ("m_tsc", 1, "table", "GCG"),
    ("anti_tk", 4, "table", "GA"),
    ("aff_tk", 4, "table", "GA"),
    ("paff_tk", 4, "table", "GA"),
    ("panti_tk", 4, "table", "GA"),
    ("paff_w", 4, "table", "GA"),
    ("panti_w", 4, "table", "GA"),
    ("tsc_tk", 4, "table", "GC"),
    ("tsc_hard", 1, "table", "GC"),
    ("tsc_skew", 4, "table", "GC"),
    ("tsc_mind", 4, "table", "GC"),
    ("tpw", 4, "table", "GC"),
    ("self_match", 4, "table", "GC"),
    ("num_domains", 4, "table", "GC"),
    ("has_soft", 1, "table", "G"),
    ("aff_self", 1, "table", "G"),
    ("t_any_match", 1, "table", "G"),
    ("live", 4, "domain", "GCD"),
    ("static_ok", 1, "row", ("G1", 1)),
    ("taint_raw", 4, "row", ("G1", 1)),
    ("aff_raw", 4, "row", ("G1", 1)),
    ("img", 4, "row", ("G1", 1)),
    ("topo_dom", 4, "row", (1, "TK")),
    ("ign", 1, "row", ("G", 1)),
    ("el_node", 1, "row", ("G", "C")),
    ("match_static", 4, "row", ("G", "C")),
    ("dom_ok", 1, "row", ("G", "C")),
    ("anti_ok", 1, "row", ("G", 1)),
    ("ipa_raw", 4, "row", ("G", 1)),
    ("term_static", 1, "row", ("G", "A")),
    ("has_lbl", 1, "row", ("G", "A")),
    ("nom", 4, "row", (1, "R")),
    ("alloc2", 4, "row", (1, 2)),
)
PLACED_NAMES = tuple(p[0] for p in PLACED)


def _a16(x: int) -> int:
    return (x + 15) & ~15


def best_words(g: int, c: int, tk: int, x: int = 0) -> int:
    """Words of a best slot: its head, the sender's top ALT_K (keys and
    nodes; the export instantiation, ``x`` 1), then the best node's
    topo_dom row (tk ints) and el_node row (g x c bytes), in 16-byte
    steps."""
    return (BEST_HEAD + x * 2 * ALT_K + tk + (g * c + 3) // 4 + 3) & ~3


def dom_words(tk: int) -> int:
    """csrc/serial_scan.cu dom_words: the commit's domain row."""
    return (tk + 3) & ~3 if tk > 64 else 64


def misc_words(tk: int) -> int:
    """The scan scratch and two counts (MISC_DOM words), then the
    commit's domain row."""
    return MAX_WARPS + 32 + dom_words(tk)


def pod_words(r: int) -> int:
    """A step's pod row: 8 words, then its R requests (room for 32 at
    least; 16-byte steps)."""
    return (8 + max(r, 32) + 3) & ~3


def slot_c(c: int) -> int:
    """Rows of per-warp spread minima (room for 16 at least)."""
    return max(c, 16)


def fixed_layout(lf: int, g: int, a: int, c: int, tk: int, r: int,
                 x: int = 0) -> int:
    """Bytes of the fixed front of a block's shared memory: K9's region
    (``lf`` floats, a multiple of 4: kernels/learned.py smem_floats), the
    three exchanges' inboxes (two step parities of a slot from each of
    MAX_CLUSTER ranks), the per-warp reduction slots (RF + RI + 4 + C
    rows) and spread minima (C), the commit's domain row and scalars, the
    pod rows of two steps (R requests each), a commit's spread hits and
    this step's m_tsc row [G, C], its term masks [G, A], any3, the spread
    minima [G, C], the step's term and hit lists, each group's step
    descriptor and, in the export instantiation (``x`` 1), each warp's
    top ALT_K (csrc/serial_scan.cu fixed_layout). Every size follows the
    launch's R, C and TK."""
    return (lf * 4 + 2 * 2 * MAX_CLUSTER * SLOT_WORDS * 4
            + 2 * MAX_CLUSTER * best_words(g, c, tk, x) * 4
            + (RF + RI + 4 + slot_c(c)) * MAX_WARPS * 4
            + MAX_WARPS * slot_c(c) * 4
            + misc_words(tk) * 4 + 2 * pod_words(r) * 4 + 2 * _a16(g * c)
            + _a16(g * a) + _a16(g) + 2 * _a16(g * c * 4) + _a16(g * a * 4)
            + _a16(g * 16) + x * 2 * ALT_K * MAX_WARPS * 4)


@dataclass(frozen=True)
class ScanPlan:
    """One launch's cluster shape and shared-memory layout."""

    cluster: int              # blocks of the cluster
    threads: int              # threads a block
    per: int                  # nodes a block (a multiple of 32)
    fixed_bytes: int
    smem_bytes: int           # dynamic shared memory a block
    off: tuple                # byte offset of each PLACED array, -1: global
    global_carries: tuple     # carries (node or domain space) left global
    all_shared: bool = False  # every array but `live` in shared memory

    @property
    def layout(self) -> str:
        """'shared' when every carry stays in shared memory, else the
        carries left in global memory."""
        if not self.global_carries:
            return "shared"
        return "global:" + ",".join(self.global_carries)


def plan_scan(dims: dict, lf: int, cluster: int) -> ScanPlan:
    """The layout of a scan over ``dims`` (N, R, G1, G, A, C, TK, D,
    ``ports`` and, optional, ``X`` 1 for the export instantiation; G = A =
    C = TK = D = 0 on a no-topology launch) with ``lf`` floats of K9's
    shared region on a cluster of ``cluster`` blocks: the fixed front,
    then each PLACED array, in order, where it still fits under SMEM_MAX
    bytes. A fixed front past SMEM_MAX is the card's limit: the wrapper
    refuses that launch (plan_fits)."""
    n = int(dims["N"])
    per = -(-n // cluster)
    per = -(-per // 32) * 32
    threads = min(MAX_THREADS, max(128, per))
    g, a, c = int(dims["G"]), int(dims["A"]), int(dims["C"])
    val = {"G": g, "GA": g * a, "GC": g * c, "G1": int(dims["G1"]),
           "R": int(dims["R"]), "TK": int(dims["TK"]), "A": a, "C": c,
           "4GAG": 4 * g * a * g, "GCG": g * c * g,
           "GCD": g * c * int(dims["D"]), "PORTS": int(bool(dims["ports"]))}
    fixed = fixed_layout(lf, g, a, c, int(dims["TK"]), int(dims["R"]),
                         int(dims.get("X", 0)))
    used = fixed
    off, left = [], []
    all_shared = True
    for name, es, kind, shape in PLACED:
        if isinstance(shape, tuple):
            k, j = (val[x] if isinstance(x, str) else x for x in shape)
            size = k * per * j * es
        else:
            size = val[shape] * es
        if size and used + _a16(size) <= SMEM_MAX:
            off.append(used)
            used += _a16(size)
        else:
            off.append(-1)
            if size and kind in ("carry", "domain"):
                left.append(name)
            if size and kind != "domain":
                all_shared = False
    return ScanPlan(cluster, threads, per, fixed, used, tuple(off),
                    tuple(left), all_shared)


# csrc/serial_scan.cu NARROW_*: the reference's sizes, up to which a launch
# without K9 or the exports takes the narrow instantiation
NARROW = {"A": 31, "C": 16, "TK": 64, "R": 32}


def narrow_launch(dims: dict, learned: bool, export: bool) -> bool:
    """Does a scan over ``dims`` take the narrow instantiation (no paths
    for terms or constraints past bit 30, compile-time minima and pod
    rows)? csrc/serial_scan.cu scan_narrow decides; this mirrors it."""
    return (not learned and not export
            and all(int(dims[k]) <= v for k, v in NARROW.items()))


def plan_fits(plan: ScanPlan) -> bool:
    """Does the plan's fixed front fit a block's shared memory (227 KB
    on an H100)? The arrays after it stay in global memory when they do
    not; the front cannot."""
    return plan.fixed_bytes <= SMEM_MAX


_PLANS: dict = {}


def _launch_plan(lib, dims: dict, lf: int) -> ScanPlan:
    """The 16-block cluster where the card holds one, else 8; raises when
    it holds neither."""
    key = (tuple(sorted(dims.items())), lf)
    plan = _PLANS.get(key)
    if plan is None:
        for cluster in CLUSTERS:
            plan = plan_scan(dims, lf, cluster)
            if not plan_fits(plan):
                raise ValueError(
                    f"serial_scan: the fixed shared-memory front of {dims} "
                    f"is {plan.fixed_bytes} bytes, past the "
                    f"{SMEM_MAX} a block has")
            n = lib.serial_scan_max_clusters(plan.cluster, plan.threads,
                                             plan.smem_bytes)
            if n < 0:
                KB.check("serial_scan", -n)
            if n > 0:
                break
        else:
            raise RuntimeError(
                f"serial_scan: the card holds no cluster of {CLUSTERS} "
                f"blocks of {plan.threads} threads with {plan.smem_bytes} "
                f"bytes of shared memory")
        _PLANS[key] = plan
    return plan


_DIMS = ("N", "B", "R", "G1", "G", "A", "C", "TK", "D", "HP",
         "topo", "spread_on", "ipa_on", "fit_on", "ports", "wildcard_ip",
         "fit_strategy", "shape_n", "pct")

_LAYOUT = ("cluster", "threads", "per", "smem_bytes", "fixed_bytes",
           "all_shared")

_EXPORT_PTRS = ("pod_valid", "lmag_step", "lmag_sum", "chosen_feat",
                "alt_row", "alt_score")

_PTRS = (
    "free", "nzr", "nom", "alloc2", "req", "nzreq", "nominated_row", "uid",
    "g1", "static_ok", "taint_raw", "aff_raw", "img",
    "hp_port", "hp_proto", "hp_ip",
    "gid", "topo_dom",
    "t_cnt", "t_any_match", "anti_ok", "ipa_raw", "term_static", "has_lbl",
    "ign", "el_node", "match_static", "dom_ok", "exists_hard",
    "m_terms", "m_tsc", "tpw", "self_match", "num_domains", "has_soft",
    "anti_tk", "aff_tk", "paff_tk", "panti_tk", "paff_w", "panti_w",
    "tsc_tk", "tsc_hard", "tsc_skew", "tsc_mind", "aff_self",
    "forbid1", "map2", "pres", "any3", "wscore", "cnt_match",
    "live_g", "feas_g", "ipa_g", "sp_g", "forb_g",
    "port_conf", "plog", "snap",
    "rows", "win", "feas", "rejects",
    "node_valid", "pct_start",
)


class _ScanArgs(ctypes.Structure):
    _fields_ = [
        *[(name, ctypes.c_int) for name in _DIMS],
        ("weights", ctypes.c_float * 7),
        ("shape_x", ctypes.c_void_p), ("shape_y", ctypes.c_void_p),
        ("seed", ctypes.c_uint),
        *[(name, ctypes.c_int) for name in _LAYOUT],
        ("off", ctypes.c_int * len(PLACED)),
        *[(name, ctypes.c_void_p) for name in _PTRS],
        ("learned", KL.LearnedNet), ("w_learned", ctypes.c_float),
        ("exp_feats", ctypes.c_int), ("exp_alts", ctypes.c_int),
        *[(name, ctypes.c_void_p) for name in _EXPORT_PTRS],
    ]


def scan_dims(s: ScanInputs) -> dict:
    """The dims plan_scan reads, from one launch's inputs."""
    dims = {"N": s.n, "R": s.free.shape[1], "G1": s.static_ok.shape[0],
            "G": 0, "A": 0, "C": 0, "TK": 0, "D": 0, "ports": bool(s.ports),
            "X": int(s.exp_feats or s.exp_alts)}
    if s.topo:
        g, a = s.terms.aff_tk.shape
        dims.update(G=g, A=a, C=s.terms.tsc_tk.shape[1],
                    TK=s.topo_dom.shape[1], D=s.st.maps.cnt.shape[-1])
    return dims


def scan_plan(s: ScanInputs) -> ScanPlan:
    """The plan a launch of these inputs takes on this card."""
    lib = KB.library("serial_scan")
    return _launch_plan(lib, scan_dims(s), KL.smem_floats(
        KL.net_of(s.learned, K9_WARPS), K9_WARPS))


def _scan_kernel(s: ScanInputs, carries: Optional[dict] = None,
                 lib=None) -> ScanResult:
    dev = s.free.device
    b_n, n, r = s.b, s.n, s.free.shape[1]
    g1_n = s.static_ok.shape[0]
    hp = s.hp_port.shape[1]
    for name, t, dtype, shape in (
            ("free", s.free, torch.float32, (n, r)),
            ("nzr", s.nzr, torch.float32, (n, 2)),
            ("nom", s.nom, torch.float32, (n, r)),
            ("alloc2", s.alloc2, torch.float32, (n, 2)),
            ("req", s.req, torch.float32, (b_n, r)),
            ("nzreq", s.nzreq, torch.float32, (b_n, 2)),
            ("nominated_row", s.nominated_row, torch.int32, (b_n,)),
            ("uid", s.uid, torch.int32, (b_n,)),
            ("g1", s.g1, torch.int32, (b_n,)),
            ("static_ok", s.static_ok, torch.bool, (g1_n, n)),
            ("taint_raw", s.taint_raw, torch.float32, (g1_n, n)),
            ("aff_raw", s.aff_raw, torch.float32, (g1_n, n)),
            ("img", s.img, torch.float32, (g1_n, n)),
            ("hp_port", s.hp_port, torch.int32, (b_n, hp)),
            ("hp_proto", s.hp_proto, torch.int32, (b_n, hp)),
            ("hp_ip", s.hp_ip, torch.int32, (b_n, hp))):
        KB.require(t, name, dtype, shape, dev)
    ptrs = {name: getattr(s, name) for name in (
        "free", "nzr", "nom", "alloc2", "req", "nzreq", "nominated_row",
        "uid", "g1", "static_ok", "taint_raw", "aff_raw", "img", "hp_port",
        "hp_proto", "hp_ip")}
    dims = {"N": n, "B": b_n, "R": r, "G1": g1_n, "HP": hp,
            "topo": int(s.topo), "spread_on": int(s.spread_on),
            "ipa_on": int(s.ipa_on), "fit_on": int(s.fit_on),
            "ports": int(s.ports), "wildcard_ip": int(s.wildcard_ip),
            "fit_strategy": KA.FIT_STRATEGIES[s.fit_strategy],
            "G": 0, "A": 0, "C": 0, "TK": 0, "D": 0, "shape_n": 0,
            "pct": int(s.pct)}

    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if s.learned is not None:
        KL.require_params(s.learned, dev)
    net = KL.net_of(s.learned, K9_WARPS)
    # a measurement build (``lib``) runs the same scan and is not counted
    counted = lib is None
    lib = KB.library("serial_scan") if lib is None else lib
    plan = _launch_plan(lib, scan_dims(s), KL.smem_floats(net, K9_WARPS))
    # the wide path's global slabs: one a warp of the cluster
    k9_scratch = KL.scratch_for(net, MAX_CLUSTER * K9_WARPS, dev)
    placed = dict(zip(PLACED_NAMES, plan.off))
    if s.topo:
        st, tm = s.st, s.terms
        g, a = tm.aff_tk.shape
        c = tm.tsc_tk.shape[1]
        tk = s.topo_dom.shape[1]
        d = st.maps.cnt.shape[-1]
        KB.require(s.gid, "gid", torch.int32, (b_n,), dev)
        KB.require(s.topo_dom, "topo_dom", torch.int32, (n, tk), dev)
        dims.update(G=g, A=a, C=c, TK=tk, D=d)
        nd, pr = st.nodes, st.pairs
        ptrs.update(
            gid=s.gid, topo_dom=s.topo_dom, t_cnt=st.maps.cnt,
            t_any_match=st.maps.any_match, anti_ok=nd.anti_ok,
            ipa_raw=nd.ipa_raw, term_static=nd.term_static,
            has_lbl=nd.has_lbl, ign=nd.ign, el_node=nd.el_node,
            match_static=nd.match_static, dom_ok=nd.dom_ok,
            exists_hard=nd.exists_hard, m_terms=pr.m_terms, m_tsc=pr.m_tsc,
            tpw=pr.tpw, self_match=pr.self_match,
            num_domains=pr.num_domains, has_soft=pr.has_soft,
            anti_tk=tm.anti_tk, aff_tk=tm.aff_tk, paff_tk=tm.paff_tk,
            panti_tk=tm.panti_tk, paff_w=tm.paff_w, panti_w=tm.panti_w,
            tsc_tk=tm.tsc_tk, tsc_hard=tm.tsc_hard, tsc_skew=tm.tsc_skew,
            tsc_mind=tm.tsc_mind, aff_self=tm.aff_self,
            forbid1=zeros(g, n, dtype=torch.bool),
            map2=zeros(g, n, dtype=torch.bool),
            pres=zeros(g, a, n, dtype=torch.bool),
            any3=zeros(g, dtype=torch.bool),
            wscore=zeros(g, n, dtype=torch.float32),
            cnt_match=zeros(g, c, n, dtype=torch.float32))
        if placed["live"] < 0:
            ptrs["live_g"] = empty(plan.cluster, g, c, d,
                                   dtype=torch.float32)
        for name, t in ptrs.items():
            if not t.is_contiguous():
                raise ValueError(f"serial_scan: {name} not contiguous")
    for name, dtype in (("feas", torch.bool), ("ipa", torch.float32),
                        ("sp", torch.float32)):
        if placed[name] < 0:
            ptrs[f"{name}_g"] = empty(n, dtype=dtype)
    out = ScanResult(empty(b_n, dtype=torch.int32),
                     empty(b_n, dtype=torch.float32),
                     empty(b_n, dtype=torch.int32),
                     empty(b_n, 4, dtype=torch.int32))
    ptrs.update(rows=out.rows, win=out.win, feas=out.feas,
                rejects=out.rejects)
    if s.ports:
        ptrs.update(port_conf=empty(b_n * b_n, dtype=torch.bool),
                    plog=empty(plan.cluster * b_n * 2, dtype=torch.int32))
        if placed["forb"] < 0:
            ptrs["forb_g"] = empty(n, dtype=torch.int32)
    if s.pct:
        KB.require(s.node_valid, "node_valid", torch.bool, (n,), dev)
        KB.require(s.pct_start, "pct_start", torch.int32, (1,), dev)
        ptrs.update(node_valid=s.node_valid, pct_start=s.pct_start,
                    snap=empty(n, dtype=torch.int32))
    if s.learned is not None:
        KB.require(s.pod_valid, "pod_valid", torch.bool, (b_n,), dev)
        ptrs.update(pod_valid=s.pod_valid,
                    lmag_step=empty(b_n, dtype=torch.float32),
                    lmag_sum=empty(1, dtype=torch.float32))
    if s.exp_feats:
        ptrs["chosen_feat"] = empty(b_n, 9, dtype=torch.float32)
    if s.exp_alts:
        ptrs.update(alt_row=empty(b_n, ALT_K, dtype=torch.int32),
                    alt_score=empty(b_n, ALT_K, dtype=torch.float32))
    args = _ScanArgs(**{k: v for k, v in dims.items() if k != "X"})
    for i, wv in enumerate(s.weights):
        args.weights[i] = float(wv)
    if s.fit_shape is not None:
        args.shape_n, args.shape_x, args.shape_y = KA.shape_args(
            s.fit_shape, dev)
    args.seed = int(s.seed) & 0xFFFFFFFF
    for name in _LAYOUT:
        setattr(args, name, getattr(plan, name))
    for i, o in enumerate(plan.off):
        args.off[i] = o
    args.learned = net
    args.w_learned = float(s.w_learned)
    args.exp_feats, args.exp_alts = int(s.exp_feats), int(s.exp_alts)
    for name in _PTRS + _EXPORT_PTRS:
        t = ptrs.get(name)
        setattr(args, name, None if t is None else t.data_ptr())
    stream = KB.stream_handle()
    if s.ports:
        KB.check("serial_scan", lib.serial_scan_port_conf_launch(
            ctypes.byref(args), ctypes.c_void_p(ptrs["port_conf"].data_ptr()),
            stream))
        if counted:
            KB.LAUNCHES["scan_port_conf"] += 1
    KB.check("serial_scan", lib.serial_scan_launch(ctypes.byref(args),
                                                   stream))
    del k9_scratch      # freed in stream order: reused after this launch
    if counted:
        KB.LAUNCHES["serial_scan"] += 1
        if plan.global_carries:
            KB.LAUNCHES["serial_scan_global_carries"] += 1
        if s.learned is not None:
            KB.LAUNCHES["learned_mlp"] += 1
        if narrow_launch(dims, s.learned is not None,
                         s.exp_feats or s.exp_alts):
            KB.LAUNCHES["serial_scan_narrow"] += 1
    if carries is not None and s.topo:
        carries.update({k: ptrs[k] for k in CARRIES})
    return out._replace(**{k: ptrs.get(k) for k in (
        "lmag_step", "lmag_sum", "chosen_feat", "alt_row", "alt_score")})


# the phases of csrc/serial_scan.cu's profile build (SCAN_PROFILE), by
# slot: SM clock cycles of rank 0's thread 0, summed over a launch
PROFILE_PHASES = {
    0: "staging", 1: "step start", 2: "phase A", 3: "partials",
    4: "cluster barriers", 5: "folds", 6: "window", 7: "phase B",
    8: "best", 9: "fold best", 10: "commit", 12: "winner rows",
    13: "map updates", 14: "write back"}


def phase_profile(s: ScanInputs) -> dict:
    """One launch of these inputs through the profile build: {phase: SM
    clock cycles a step} of rank 0's thread 0 (``free``/``nzr``/
    ``pct_start`` change as in any launch). A measurement; counted
    nowhere."""
    lib = KB.build_variant("serial_scan", ("SCAN_PROFILE",))
    lib.serial_scan_read_profile.argtypes = [ctypes.c_void_p]
    _scan_kernel(s, lib=lib)
    buf = (ctypes.c_ulonglong * 16)()
    KB.check("serial_scan", lib.serial_scan_read_profile(buf))
    return {name: buf[k] / max(s.b, 1) for k, name in PROFILE_PHASES.items()
            if buf[k]}


def barrier_probe(n: int, steps: int) -> None:
    """Launch ``steps`` rounds of the previous design's three grid barriers
    alone, on the cooperative grid it ran a scan over ``n`` nodes on (a
    measurement, not a kernel of the scheduling path: no launch counter)."""
    lib = KB.library("serial_scan")
    KB.check("serial_scan", lib.serial_scan_sync_probe(
        int(n), int(steps), KB.stream_handle()))


def cluster_barrier_probe(plan: ScanPlan, steps: int, per_step: int) -> None:
    """Launch ``steps`` rounds of ``per_step`` cluster barriers alone, on
    ``plan``'s cluster shape and shared memory: the barrier floor of a
    ``steps``-pod scan of this design (2 barriers a step, 3 with the
    window). A measurement: no launch counter."""
    lib = KB.library("serial_scan")
    KB.check("serial_scan", lib.serial_scan_cluster_probe(
        plan.cluster, plan.threads, plan.smem_bytes, int(steps),
        int(per_step), KB.stream_handle()))
