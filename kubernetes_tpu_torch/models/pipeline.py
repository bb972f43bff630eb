"""One batched launch schedules a whole batch of pods (port of the JAX
package's models/pipeline.py).

The launch runs in two phases, as in the reference:

1. **Phase 1** (kernel K1, ``kernels/phase1.py``): every static Filter and
   raw Score — unschedulable, nodeName, taints, node affinity, host ports,
   image locality — for all (group, node) pairs, where the groups are the
   batch's distinct pod specs (``Mirror._batch_groups``) or every pod.
2. **The commit**, one of three engines:

   - **the auction** (kernels K2a/K2b, ``kernels/auction.py``) for a batch
     without topology work or host ports: each round, every unplaced pod
     bids for its best feasible node against the round-start usage state;
     per node the first bidder in batch order is accepted (or the first
     ``k_accept`` while their cumulative requests fit when the batch
     outnumbers the nodes); the commit moves free/nzr. The round loop runs
     on the host: ``auction_unroll()`` rounds are launched back to back
     and one progress flag is read after them.
   - **the serial commit scan** (kernel K3, ``kernels/scan.py``): pod by
     pod in batch order, filtered and scored against the live state of
     the commits before it — free resources, in-batch hostPort clashes
     and, on a topology launch, in-batch (anti)affinity and spread
     counts — the reference's as-if-serial path. A topology launch first
     computes the per-group topology statics (kernel K5,
     ``kernels/topology.py``) over the groups' phase-1 masks.
   - **the soft-score auction** for a soft-only topology launch (preferred
     pod (anti)affinity, ScheduleAnyway spread; no required term, no
     DoNotSchedule spread): K5's statics, viewed as the soft statics
     (``kernels/soft.py``), then the auction's rounds with kernel K4
     before the bids of each round — the live soft scores against the
     pods placed so far — and K2a in its soft mode. The Scheduler takes it
     on the card, as the reference does on an accelerator; on the CPU it
     takes the serial scan (the reference's reduced soft scan places the
     same).

Host Filter verdicts (``host_ok`` [B, N], GangScheduling's PreFilter)
AND into phase 1's mask per pod (K1's optional input), as the reference
ANDs them into ``static_ok``: phase 1 then runs per pod, not per group.
On a topology launch K5 still reads the groups' masks without them (the
reference's ``per_group`` recomputes its own), and the commit reads a
second, per-pod K1 with them; such a launch takes the serial scan (the
soft auction's group-indexed statics have no per-pod mask).

DRA claim feasibility (``dra``, a ``ops/dra.py:DraBatch``) fuses after
phase 1 as in the reference (kernel K8, ``kernels/dra.py``): phase 1 runs
per pod, K8 counts each pod's nodes that pass the static filters and fail
only on claims (``BatchResult.dra_reject``) and ANDs the claim verdicts,
then the host verdicts, into the pod's mask. On a topology launch that
per-pod mask is the commit's, as with ``host_ok``.

The percentageOfNodesToScore window (``pct_nodes``, serial scan only)
keeps, at every scan step, the first k feasible nodes in rotating order
from a start row that the scan advances and ``BatchResult.pct_start``
carries to the next launch (``kernels/scan.py:pct_window``).

The learned score term (``learned``, a kernels/learned.py LearnedParams
on the launch's device; kernel K9 inside K2a and K3) adds
``weights.learned`` times the scorer's output to every total, after the
hand terms, on each commit engine (the reference's pipeline.py :634-636
and :1466-1474).

The export tails (``with_feats``, ``with_alts``, and the learned
magnitude whenever a scorer is on; the reference's :740-844 and
:1466-1589): the auction runs K2a's export pass against the end state
after its last round, the scan writes them at every step (K3's export
outputs). BatchResult carries them with the reference's shapes and
sentinels (ALT_K = 4, ALT_NONE, row -1).

``patch_chain`` folds churn into the device-resident usage chain that
the Scheduler carries between launches (kernel K11, ``kernels/chain.py``):
a node's absolute repack replaces its row, a foreign pod's bind or delete
adds its delta.

The reference's ``static_filters`` and ``tie_perturb`` live beside the
kernels that use them (``kernels/phase1.py``, ``kernels/auction.py``).
Host Score plugin verdicts raise NotImplementedError naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.kernels import auction as KA
from kubernetes_tpu_torch.kernels import chain as KC
from kubernetes_tpu_torch.kernels import dra as KD
from kubernetes_tpu_torch.kernels import scan as KS
from kubernetes_tpu_torch.kernels import soft as KSoft
from kubernetes_tpu_torch.kernels import topology as KT
from kubernetes_tpu_torch.kernels import unpack as KU
from kubernetes_tpu_torch.ops import scores as SC
from kubernetes_tpu_torch.kernels.phase1 import NUM_STATIC, phase1_static
from kubernetes_tpu_torch.kernels.scan import (  # noqa: F401 — re-exported
    ADAPTIVE_PCT,
    MIN_FEASIBLE_NODES_TO_FIND,
)
from kubernetes_tpu_torch.ops.features import (
    Capacities,
    ClusterBlobs,
    PodBlobs,
    codecs,
    unpack_cluster,
    unpack_pods,
)

# the top-K alternative export (export v3): how many runner-up (node,
# total) pairs each placement row carries, and the alt_score padding of
# an absent candidate (anything below ALT_NONE / 2 is "no candidate")
ALT_K = KA.ALT_K
ALT_NONE = KA.ALT_NONE

# --- filter plugin order (first-fail attribution; default_plugins.go) ---

FILTER_PLUGINS = (
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodePorts",
    "NodeResourcesFit",
    "PodTopologySpread",
    "InterPodAffinity",
)
NUM_FILTER_PLUGINS = len(FILTER_PLUGINS)

# --- score plugin set with default weights (default_plugins.go:30-58) ---

SCORE_PLUGINS = (
    "TaintToleration",
    "NodeAffinity",
    "NodeResourcesFit",
    "NodeResourcesBalancedAllocation",
    "ImageLocality",
    "PodTopologySpread",
    "InterPodAffinity",
    "LearnedScore",
)


def auction_unroll() -> int:
    """Auction rounds launched back to back between two reads of the
    progress flag (the reference fuses as many rounds per while_loop
    iteration). A round after convergence does nothing; default 4,
    KUBERNETES_TPU_AUCTION_UNROLL overrides (>= 1)."""
    try:
        n = int(os.environ.get("KUBERNETES_TPU_AUCTION_UNROLL", "0"))
    except ValueError:
        n = 0
    return max(1, n if n > 0 else 4)


@dataclass
class ScoreWeights:
    """Per-plugin score weights (scorePluginWeight, runtime/framework.go:57)."""

    taint_toleration: float
    node_affinity: float
    resources_fit: float
    balanced_allocation: float
    image_locality: float
    pod_topology_spread: float
    inter_pod_affinity: float
    learned: float

    def totals(self) -> tuple:
        """The seven hand-tuned weights the auction's and the serial
        scan's totals use, in their order (``learned`` weights the learned
        term, which follows them)."""
        return (self.taint_toleration, self.node_affinity,
                self.resources_fit, self.balanced_allocation,
                self.image_locality, self.pod_topology_spread,
                self.inter_pod_affinity)


def default_weights() -> ScoreWeights:
    return ScoreWeights(
        taint_toleration=3.0, node_affinity=2.0, resources_fit=1.0,
        balanced_allocation=1.0, image_locality=1.0,
        pod_topology_spread=2.0, inter_pod_affinity=2.0, learned=0.0)


@dataclass
class BatchResult:
    """Per-pod outcome of one batched launch (all tensors on the launch's
    device). ``free``/``nzr`` are the post-batch usage state: fed to the
    next launch's ``state`` they chain batches without a mirror re-sync."""

    node_row: torch.Tensor        # [B] i32: chosen node row, -1 = unschedulable
    score: torch.Tensor           # [B] f32: winning aggregate score
    feasible_count: torch.Tensor  # [B] i32: end-state nodes passing all filters
    reject_counts: torch.Tensor   # [B, P] i32: nodes rejected per plugin
    unresolvable_count: torch.Tensor  # [B] i32
    free: torch.Tensor            # [N, R] f32
    nzr: torch.Tensor             # [N, 2] f32
    guard: torch.Tensor           # [] i32: bit 0 NaN score, bit 1 NaN free
    # [1] i32: the percentageOfNodesToScore window's next start row
    # (nextStartNodeIndex, schedule_one.go:620), 0 when the knob is off;
    # the next launch's ``pct_start``
    pct_start: torch.Tensor
    # [B] i32: nodes that passed the static filters and failed only on
    # the pod's resource claims (zeros without DRA work)
    dra_reject: torch.Tensor
    # [] f32: mean |weight x learned term| over the feasible pairs (the
    # auction: end-state (pod, node) pairs; the scan: the mean over valid
    # pods of each step's mean), 0 without a learned scorer
    learned_mag: Optional[torch.Tensor] = None
    # [B, 9] f32: the chosen node's feature row (with_feats), else zeros
    chosen_feat: Optional[torch.Tensor] = None
    # [B, ALT_K] i32 / f32: the top ALT_K candidate nodes by total and
    # their totals (with_alts), else -1 / ALT_NONE
    alt_row: Optional[torch.Tensor] = None
    alt_score: Optional[torch.Tensor] = None
    round_trips: int = 0          # host reads of the progress flag


def _guard_reduction(scores: torch.Tensor, free: torch.Tensor
                     ) -> torch.Tensor:
    """BatchResult.guard: bit 0 = NaN in the winning scores, bit 1 = NaN
    in the post-batch free state."""
    return (torch.isnan(scores).any().to(torch.int32)
            | (torch.isnan(free).any().to(torch.int32) << 1))


def extract_state(cblobs: ClusterBlobs, caps: Capacities) -> KU.Seed:
    """(free, nonzero_requested) of a cluster blob: the seed of the
    device-resident usage chain, new contiguous tensors (kernel K13 on
    the card) that the launch they seed fills in place of copies."""
    return KU.seed(cblobs, caps)


def _working(t: torch.Tensor, fresh: bool) -> torch.Tensor:
    """A launch's working copy of a chain tensor: the tensor itself when
    it is a fresh seed, else a contiguous copy (the caller's chain stays
    as it was)."""
    return t if fresh else t.clone(memory_format=torch.contiguous_format)


def patch_chain(free, nzr, set_rows=(), add_rows=()):
    """Scatter node-row patches into the usage chain (free [N, R], nzr
    [N, 2]) in place of a full snapshot re-sync: ``set_rows`` are
    ``(row, free_row [R], nzr_row [2])`` absolute repacks that replace
    the chain's rows, ``add_rows`` ``(row, dfree [R], dnzr [2])`` deltas
    added to them, after the sets. Returns the patched chain as new
    tensors (an in-flight wave's pending tuple may hold the old ones).
    Kernel K11 (``kernels/chain.py``, which routes CPU tensors to the
    twin)."""
    return KC.chain_patch(free, nzr, set_rows, add_rows)


def full_pod_rows(pblobs: PodBlobs, ptmpl: PodBlobs, caps: Capacities,
                  pfields, rows: torch.Tensor):
    """Full-schema pod rows ([G, PF] f32, [G, PI] i32) for the batch rows
    ``rows``: the template row with the subset blob's fields copied in —
    what phase 1 reads."""
    if pfields is None:
        return pblobs.f32[rows].contiguous(), pblobs.i32[rows].contiguous()
    _, _, pod_codec = codecs(caps)
    g = rows.shape[0]
    f32 = ptmpl.f32.reshape(1, -1).expand(g, -1).clone()
    i32 = ptmpl.i32.reshape(1, -1).expand(g, -1).clone()
    f_cols, i_cols = pod_codec.subset_columns(pfields)
    dev = f32.device
    if f_cols.size:
        f32[:, torch.from_numpy(f_cols).to(dev)] = pblobs.f32[rows]
    if i_cols.size:
        i32[:, torch.from_numpy(i_cols).to(dev)] = pblobs.i32[rows]
    return f32, i32


def round_inputs(ct, pods, gid, p1, weights: ScoreWeights, free0, nzr0,
                 fit_strategy="LeastAllocated", fit_shape=None,
                 tie_seed=None, soft=None, sout=None,
                 learned=None, fresh=False) -> KA.RoundInputs:
    """The auction's per-launch state: the pods' rows, the phase-1 group
    outputs and copies of the (free, nzr) chain (the chain itself when
    ``fresh``: a seed from extract_state), all unplaced; on a
    soft-only topology launch also the soft statics (``soft``, a
    KSoft.SoftTopo) and the live scores K4 rewrites every round
    (``sout``); the learned scorer's packed params (``learned``) or
    None."""
    b = pods.req.shape[0]
    n = ct.node_valid.shape[0]
    dev = free0.device
    k_accept = None
    if b > n:
        # per-node acceptance budget: the share a balanced placement would
        # put on one node (valid pods over valid nodes)
        k_accept = torch.ceil(
            pods.valid.sum().to(torch.float32)
            / torch.clamp(ct.node_valid.sum().to(torch.float32), min=1.0)
        ).to(torch.int32)
    if fit_shape is not None:
        fit_shape = tuple(torch.as_tensor(np.asarray(v, np.float32),
                                          device=dev) for v in fit_shape)
    soft_in = {}
    if soft is not None:
        soft_in = dict(ipa_ok=soft.ipa_ok_g, ipa_live=sout.ipa_live,
                       sp_r=sout.sp_r, ign=soft.ign_g,
                       has_soft=soft.has_soft_g)
    return KA.RoundInputs(
        free=_working(free0, fresh), nzr=_working(nzr0, fresh),
        nom=ct.nominated_req.contiguous(),
        alloc2=SC.alloc_cpu_mem(ct),
        req=pods.req.contiguous(), nzreq=pods.nonzero_req.contiguous(),
        nominated_row=pods.nominated_row.contiguous(),
        uid=pods.uid_id.contiguous(), gid=gid.to(torch.int32).contiguous(),
        static_ok=p1.static_ok, taint_raw=p1.taint_raw, aff_raw=p1.aff_raw,
        img=p1.img,
        placed=torch.full((b,), -1, dtype=torch.int32, device=dev),
        win=torch.zeros((b,), dtype=torch.float32, device=dev),
        weights=weights.totals(), fit_strategy=fit_strategy,
        fit_shape=fit_shape, seed=0 if tie_seed is None else int(tie_seed),
        k_accept=k_accept, learned=learned,
        w_learned=float(weights.learned), **soft_in)


def phase1_rows(gid, rep, b: int, dev):
    """(batch rows phase 1 evaluates, each pod's row among them): the
    group representatives when the batch deduplicates to fewer groups
    than pods, else every pod."""
    if gid is not None and rep.shape[0] < b:
        return rep.long(), gid
    rows = torch.arange(b, device=dev)
    return rows, rows.to(torch.int32)


def _rounds_commit(ct, pods, gid, p1, weights: ScoreWeights, free0, nzr0,
                   fit_strategy="LeastAllocated", fit_shape=None,
                   tie_seed=None, unroll=None, soft=None,
                   learned=None, with_feats=False,
                   with_alts=False, fresh=False) -> BatchResult:
    """The parallel auction (pipeline.py:_rounds_commit of the reference):
    rounds of bids (K2a) and per-node acceptance + commit (K2b) until a
    round accepts nothing; then the end-state feasible / reject counts
    (K2a final mode) and, with a learned scorer or an export on, K2a's
    export pass against the end state. ``soft`` (a KSoft.SoftTopo,
    soft-only topology launches) adds K4 before the bids of every round:
    the live soft scores against the round-start placed set; the round
    that accepts nothing ran K4 on the final placement, so the export
    reads the end-state soft scores."""
    sout = None if soft is None else KSoft.soft_out(soft)
    rin = round_inputs(ct, pods, gid, p1, weights, free0, nzr0,
                       fit_strategy, fit_shape, tie_seed, soft, sout,
                       learned, fresh)
    b = rin.b
    dev = rin.free.device
    prog = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    unroll = auction_unroll() if unroll is None else max(1, int(unroll))
    # on the card, K2b's and K4's launches are checked and built once here
    # (K2a writes its bids into the buffers K2b's launch reads)
    bids = KA.bid_buffers(rin)
    k2b = KA.commit_launch(rin, *bids, prog)
    k4 = (None if soft is None
          else KSoft.soft_launch(soft, rin.placed, prog, sout))
    k = 0
    trips = 0
    while True:
        for _ in range(unroll):
            if soft is not None:
                KSoft.soft_scores(soft, rin.placed, prog, k, sout, launch=k4)
            choice, win_now = KA.auction_score_argmax(rin, prog, k, out=bids)
            KA.auction_accept_commit(rin, choice, win_now, prog, k,
                                     launch=k2b)
            k += 1
        trips += 1
        if not int(prog[k % 2]):
            break
        if k > b + unroll:
            # every productive round places at least one pod
            raise RuntimeError(f"auction did not converge in {k} rounds "
                               f"for {b} pods")
    feas, fit_rejects, ipa_rejects = KA.auction_final(rin)
    ex = KA.auction_export(rin, with_feats, with_alts)
    gid_l = rin.gid.long()
    zeros = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    reject_counts = torch.cat(
        [p1.rejects[gid_l], fit_rejects[:, None], zeros,
         ipa_rejects[:, None]], dim=1)
    return BatchResult(node_row=rin.placed, score=rin.win,
                       feasible_count=feas, reject_counts=reject_counts,
                       unresolvable_count=p1.unres[gid_l], free=rin.free,
                       nzr=rin.nzr, guard=_guard_reduction(rin.win, rin.free),
                       pct_start=torch.zeros((1,), dtype=torch.int32,
                                             device=dev),
                       dra_reject=torch.zeros((b,), dtype=torch.int32,
                                              device=dev),
                       learned_mag=ex.learned_mag,
                       chosen_feat=ex.chosen_feat, alt_row=ex.alt_row,
                       alt_score=ex.alt_score, round_trips=trips)


def _serial_commit(ct, pods, g1, p1, weights: ScoreWeights, free0, nzr0,
                   wk: dict, act, fit_on: bool, fit_strategy, fit_shape,
                   tie_seed, topo=None, pct_nodes=0,
                   pct_start=None, learned=None, with_feats=False,
                   with_alts=False, fresh=False) -> BatchResult:
    """The serial commit scan (K3) and the BatchResult assembly
    (pipeline.py :1571-1606 of the reference). ``topo`` is None on a
    no-topology launch, else (gid, topo_dom, statics, terms, spread_on,
    ipa_on). ``pct_nodes`` (0 off, ADAPTIVE_PCT or a percent) turns on the
    percentageOfNodesToScore window, starting at row ``pct_start``."""
    dev = free0.device
    if fit_shape is not None:
        fit_shape = tuple(torch.as_tensor(np.asarray(v, np.float32),
                                          device=dev) for v in fit_shape)
    sin = KS.ScanInputs(
        free=_working(free0, fresh), nzr=_working(nzr0, fresh),
        nom=ct.nominated_req.contiguous(), alloc2=SC.alloc_cpu_mem(ct),
        req=pods.req.contiguous(), nzreq=pods.nonzero_req.contiguous(),
        nominated_row=pods.nominated_row.contiguous(),
        uid=pods.uid_id.contiguous(), g1=g1.to(torch.int32).contiguous(),
        static_ok=p1.static_ok, taint_raw=p1.taint_raw, aff_raw=p1.aff_raw,
        img=p1.img, hp_port=pods.hp_port.contiguous(),
        hp_proto=pods.hp_proto.contiguous(), hp_ip=pods.hp_ip.contiguous(),
        wildcard_ip=int(wk["wildcard_ip"]), ports="ports" in act,
        weights=weights.totals(), fit_on=fit_on, fit_strategy=fit_strategy,
        fit_shape=fit_shape, seed=0 if tie_seed is None else int(tie_seed),
        learned=learned, w_learned=float(weights.learned),
        exp_feats=bool(with_feats), exp_alts=bool(with_alts),
        pod_valid=pods.valid.contiguous())
    if topo is not None:
        gid, topo_dom, st, terms, spread_on, ipa_on = topo
        sin.gid, sin.topo_dom, sin.st, sin.terms = gid, topo_dom, st, terms
        sin.spread_on, sin.ipa_on = spread_on, ipa_on
    start = torch.zeros((1,), dtype=torch.int32, device=dev)
    if pct_nodes:
        if pct_start is not None:
            start.copy_(torch.as_tensor(pct_start, dtype=torch.int32)
                        .reshape(1))
        sin.pct, sin.pct_start = int(pct_nodes), start
        sin.node_valid = ct.node_valid.contiguous()
    res = KS.serial_scan(sin)
    g1_l = sin.g1.long()
    static_rejects = p1.rejects[g1_l].clone()
    ports_idx = FILTER_PLUGINS.index("NodePorts")
    static_rejects[:, ports_idx] += res.rejects[:, 0]
    reject_counts = torch.cat([static_rejects, res.rejects[:, 1:]], dim=1)
    ex = KS.scan_export(sin, res)
    return BatchResult(node_row=res.rows, score=res.win,
                       feasible_count=res.feas, reject_counts=reject_counts,
                       unresolvable_count=p1.unres[g1_l], free=sin.free,
                       nzr=sin.nzr, guard=_guard_reduction(res.win, sin.free),
                       pct_start=start,
                       dra_reject=torch.zeros((res.rows.shape[0],),
                                              dtype=torch.int32, device=dev),
                       learned_mag=ex.learned_mag,
                       chosen_feat=ex.chosen_feat, alt_row=ex.alt_row,
                       alt_score=ex.alt_score)


def schedule_batch(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                   weights: ScoreWeights, caps: Capacities,
                   enable_topology: bool = False, d_cap: int | None = None,
                   enabled_filters=None, serial_scan: bool = True,
                   state=None, active=None, pfields=None, ptmpl=None,
                   gid=None, rep=None,
                   fit_strategy: str = "LeastAllocated", fit_shape=None,
                   tie_seed=None, topo_soft: bool = False,
                   auction_unroll=None, host_ok=None, dra=None,
                   pct_nodes: int = 0, pct_start=None,
                   learned=None, with_feats: bool = False,
                   with_alts: bool = False) -> BatchResult:
    """Phase 1 per group, then the auction (``serial_scan=False``: a
    launch without topology work or a soft-only topology launch
    (``topo_soft``), without batch host ports) or the serial commit scan.
    A topology launch computes the per-group topology statics (K5) first;
    the soft auction reads them through the soft statics view and adds
    K4's live soft scores every round. ``state`` overrides the cluster's
    (free, nonzero_requested) with the previous launch's post-batch chain
    (copied) or with a seed from ``extract_state`` (filled in place);
    ``gid``/``rep`` (Mirror._batch_groups) dedup phase 1 — and on a
    topology launch the topology statics and the scan's carry maps — to
    one row per distinct pod spec; ``d_cap`` sizes the domain maps.
    ``host_ok`` [B, N] bool ANDs the host Filter verdicts into each pod's
    phase-1 mask, ``dra`` (a DraBatch) the claim verdicts before them
    (K8); ``pct_nodes``/``pct_start`` set the serial scan's
    percentageOfNodesToScore window and ``learned`` (a LearnedParams on
    the blobs' device, or None) the learned score term (module
    docstring); ``with_feats`` / ``with_alts`` turn on the chosen-node
    feature and the top-ALT_K alternative exports."""
    ct = unpack_cluster(cblobs, caps)
    pods = unpack_pods(pblobs, caps, pfields, ptmpl)
    b = pblobs.f32.shape[0]
    dev = pblobs.f32.device
    if enabled_filters is None:
        enabled_filters = (True,) * NUM_FILTER_PLUGINS
    fit_on = enabled_filters[FILTER_PLUGINS.index("NodeResourcesFit")]
    if not serial_scan and ((enable_topology and not topo_soft)
                            or not fit_on):
        raise ValueError(
            "the auction needs a no-topology or soft-only topology launch "
            "with NodeResourcesFit enabled; the serial commit scan takes "
            "the rest")
    act = frozenset(("nodeaffinity", "taints", "ports", "images")
                    if active is None else active)
    if pfields is not None and ptmpl is None:
        raise ValueError("a subset pod blob needs the pod template blob")
    per_pod = host_ok is not None or dra is not None
    if per_pod and enable_topology and not serial_scan:
        raise ValueError("a launch with host or claim verdicts and "
                         "topology work takes the serial commit scan")
    if pct_nodes and not serial_scan:
        raise ValueError(
            "percentageOfNodesToScore truncation only exists in the serial "
            "scan; gate the auction off when the knob is set")
    if enable_topology and gid is None:
        # direct callers without host grouping: every pod its own group
        gid = torch.arange(b, dtype=torch.int32, device=dev)
        rep = gid
    if enable_topology:
        # the topology statics are per group, and so is phase 1
        rows, g_of = rep.long(), gid
    elif per_pod:
        # the host and claim verdicts are per pod: phase 1 runs per pod
        rows = torch.arange(b, device=dev)
        g_of = rows.to(torch.int32)
    else:
        rows, g_of = phase1_rows(gid, rep, b, dev)
    # K1 ANDs the host verdicts itself unless K8 follows it, which ANDs
    # the claim verdicts first (the reference's order)
    k1_host = None if dra is not None else host_ok
    prow_f32, prow_i32 = full_pod_rows(pblobs, ptmpl, caps, pfields, rows)
    p1 = phase1_static(cblobs, prow_f32, prow_i32, caps, wk,
                       enabled_filters[:NUM_STATIC], act,
                       None if enable_topology else k1_host)
    # what the commit reads: phase 1 per group, or per pod with the host
    # and claim verdicts on a topology launch (K5 above keeps the groups'
    # masks)
    p1_commit, g1 = p1, g_of
    if per_pod and enable_topology:
        all_rows = torch.arange(b, device=dev)
        pf32, pi32 = full_pod_rows(pblobs, ptmpl, caps, pfields, all_rows)
        p1_commit = phase1_static(cblobs, pf32, pi32, caps, wk,
                                  enabled_filters[:NUM_STATIC], act, k1_host)
        g1 = all_rows.to(torch.int32)
    dra_reject = None
    if dra is not None:
        ok, dra_reject = KD.fuse_phase1(p1_commit.static_ok, dra, host_ok)
        p1_commit = p1_commit._replace(static_ok=ok)
        if not enable_topology:
            p1 = p1_commit
    free0 = ct.free if state is None else state[0]
    nzr0 = ct.nonzero_requested if state is None else state[1]
    fresh = isinstance(state, KU.Seed)
    topo = soft = None
    if enable_topology:
        d_cap = caps.domain_cap if d_cap is None else int(d_cap)
        st = KT.topo_statics(cblobs, prow_f32, prow_i32, p1.static_ok,
                             p1.taint_ok, p1.nodeaff_ok, caps, d_cap)
        pods_rep = unpack_pods(PodBlobs(f32=prow_f32, i32=prow_i32), caps)
        spread_on = enabled_filters[FILTER_PLUGINS.index(
            "PodTopologySpread")]
        ipa_on = enabled_filters[FILTER_PLUGINS.index("InterPodAffinity")]
        if serial_scan:
            topo = (g_of.to(torch.int32).contiguous(),
                    ct.topo_dom.contiguous(), st,
                    KS.GroupTerms.of(pods_rep), spread_on, ipa_on)
        else:
            soft = KSoft.soft_topo(st, pods_rep, g_of, pods.valid,
                                   ct.topo_dom, d_cap, ipa_on)
    if not serial_scan:
        out = _rounds_commit(ct, pods, g_of, p1, weights, free0, nzr0,
                             fit_strategy, fit_shape, tie_seed,
                             auction_unroll, soft, learned, with_feats,
                             with_alts, fresh)
    else:
        out = _serial_commit(ct, pods, g1, p1_commit, weights, free0, nzr0,
                             wk, act, fit_on, fit_strategy, fit_shape,
                             tie_seed, topo, pct_nodes, pct_start, learned,
                             with_feats, with_alts, fresh)
    if dra_reject is not None:
        out.dra_reject = dra_reject
    return out


def launch_batch(spec, wk, weights, caps, enabled_filters=None,
                 serial_scan=True, state=None, host_ok=None,
                 host_score=None, fit_strategy="LeastAllocated",
                 fit_shape=None, pct_nodes=0, pct_start=None,
                 learned=None, tie_seed=None, with_feats=False,
                 with_alts=False, device="cuda") -> BatchResult:
    """schedule_batch driven by a Mirror.prepare_launch LaunchSpec, on
    ``device`` (the spec's tensors move there; a missing card raises).
    ``learned`` is the learned scorer, a kernels/learned.py LearnedParams
    (moved to ``device`` if it lies elsewhere), or None; ``with_feats``
    / ``with_alts`` turn on the export tails (BatchResult.chosen_feat,
    alt_row, alt_score; learned_mag whenever a scorer is on)."""
    if host_score is not None:
        raise NotImplementedError(
            "host Score plugin verdicts: ROADMAP queue 1 item 7")
    dev = torch.device(device)
    spec = spec.to(dev)
    if state is not None:
        # a seed stays a seed: nothing else holds it on either device
        state = type(state)((state[0].to(dev), state[1].to(dev)))
    if host_ok is not None:
        host_ok = torch.as_tensor(host_ok, dtype=torch.bool).to(dev)
    if pct_start is not None:
        pct_start = torch.as_tensor(pct_start, dtype=torch.int32).to(dev)
    return schedule_batch(
        spec.cblobs, spec.pblobs, wk, weights, caps, spec.enable_topology,
        spec.d_cap, enabled_filters, serial_scan=serial_scan, state=state,
        active=spec.active, pfields=spec.pfields, ptmpl=spec.ptmpl,
        gid=spec.gid, rep=spec.rep, fit_strategy=fit_strategy,
        fit_shape=fit_shape, tie_seed=tie_seed, topo_soft=spec.topo_soft,
        host_ok=host_ok, dra=spec.dra, pct_nodes=pct_nodes,
        pct_start=pct_start, learned=learned, with_feats=with_feats,
        with_alts=with_alts)
