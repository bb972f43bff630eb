"""One batched launch schedules a whole batch of pods (port of the JAX
package's models/pipeline.py, auction arm).

The launch runs in two phases, as in the reference:

1. **Phase 1** (kernel K1, ``kernels/phase1.py``): every static Filter and
   raw Score — unschedulable, nodeName, taints, node affinity, host ports,
   image locality — for all (group, node) pairs, where the groups are the
   batch's distinct pod specs (``Mirror._batch_groups``) or every pod.
2. **The auction** (kernels K2a/K2b, ``kernels/auction.py``): each round,
   every unplaced pod bids for its best feasible node against the
   round-start usage state; per node the first bidder in batch order is
   accepted (or the first ``k_accept`` while their cumulative requests fit
   when the batch outnumbers the nodes); the commit moves free/nzr. The
   round loop runs on the host: ``auction_unroll()`` rounds are launched
   back to back and one progress flag is read after them.

The reference's ``static_filters`` and ``tie_perturb`` live beside the
kernels that use them (``kernels/phase1.py``, ``kernels/auction.py``).
Only the auction arm of the reference exists here. The serial commit scan,
topology, DRA, learned scores, the feature/alternative exports and the
percentageOfNodesToScore window raise NotImplementedError naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_tpu_torch.kernels import auction as KA
from kubernetes_tpu_torch.ops import scores as SC
from kubernetes_tpu_torch.kernels.phase1 import NUM_STATIC, phase1_static
from kubernetes_tpu_torch.ops.features import (
    Capacities,
    ClusterBlobs,
    PodBlobs,
    codecs,
    unpack_cluster,
    unpack_pods,
)

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

    def auction(self) -> tuple:
        """The five weights the auction's totals use, in their order."""
        return (self.taint_toleration, self.node_affinity,
                self.resources_fit, self.balanced_allocation,
                self.image_locality)


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
    round_trips: int = 0          # host reads of the progress flag


def _guard_reduction(scores: torch.Tensor, free: torch.Tensor
                     ) -> torch.Tensor:
    """BatchResult.guard: bit 0 = NaN in the winning scores, bit 1 = NaN
    in the post-batch free state."""
    return (torch.isnan(scores).any().to(torch.int32)
            | (torch.isnan(free).any().to(torch.int32) << 1))


def extract_state(cblobs: ClusterBlobs, caps: Capacities):
    """(free, nonzero_requested) of a cluster blob: the seed of the
    device-resident usage chain (views; a launch copies them)."""
    ct = unpack_cluster(cblobs, caps)
    return ct.free, ct.nonzero_requested


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
                 tie_seed=None) -> KA.RoundInputs:
    """The auction's per-launch state: the pods' rows, the phase-1 group
    outputs and fresh copies of the (free, nzr) chain, all unplaced."""
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
    return KA.RoundInputs(
        free=free0.clone(memory_format=torch.contiguous_format),
        nzr=nzr0.clone(memory_format=torch.contiguous_format),
        nom=ct.nominated_req.contiguous(),
        alloc2=SC.alloc_cpu_mem(ct),
        req=pods.req.contiguous(), nzreq=pods.nonzero_req.contiguous(),
        nominated_row=pods.nominated_row.contiguous(),
        uid=pods.uid_id.contiguous(), gid=gid.to(torch.int32).contiguous(),
        static_ok=p1.static_ok, taint_raw=p1.taint_raw, aff_raw=p1.aff_raw,
        img=p1.img,
        placed=torch.full((b,), -1, dtype=torch.int32, device=dev),
        win=torch.zeros((b,), dtype=torch.float32, device=dev),
        weights=weights.auction(), fit_strategy=fit_strategy,
        fit_shape=fit_shape, seed=0 if tie_seed is None else int(tie_seed),
        k_accept=k_accept)


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
                   tie_seed=None, unroll=None) -> BatchResult:
    """The parallel auction (pipeline.py:_rounds_commit of the reference,
    no topology terms): rounds of bids (K2a) and per-node acceptance +
    commit (K2b) until a round accepts nothing; then the end-state
    feasible / fit-reject counts (K2a final mode)."""
    rin = round_inputs(ct, pods, gid, p1, weights, free0, nzr0,
                       fit_strategy, fit_shape, tie_seed)
    b = rin.b
    dev = rin.free.device
    prog = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    unroll = auction_unroll() if unroll is None else max(1, int(unroll))
    k = 0
    trips = 0
    while True:
        for _ in range(unroll):
            choice, win_now = KA.auction_score_argmax(rin, prog, k)
            KA.auction_accept_commit(rin, choice, win_now, prog, k)
            k += 1
        trips += 1
        if not int(prog[k % 2]):
            break
        if k > b + unroll:
            # every productive round places at least one pod
            raise RuntimeError(f"auction did not converge in {k} rounds "
                               f"for {b} pods")
    feas, fit_rejects = KA.auction_final(rin)
    gid_l = rin.gid.long()
    zeros = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    reject_counts = torch.cat(
        [p1.rejects[gid_l], fit_rejects[:, None], zeros, zeros], dim=1)
    return BatchResult(node_row=rin.placed, score=rin.win,
                       feasible_count=feas, reject_counts=reject_counts,
                       unresolvable_count=p1.unres[gid_l], free=rin.free,
                       nzr=rin.nzr, guard=_guard_reduction(rin.win, rin.free),
                       round_trips=trips)


def schedule_batch(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                   weights: ScoreWeights, caps: Capacities,
                   enabled_filters=None, state=None, active=None,
                   pfields=None, ptmpl=None, gid=None, rep=None,
                   fit_strategy: str = "LeastAllocated", fit_shape=None,
                   tie_seed=None, auction_unroll=None) -> BatchResult:
    """Phase 1 per group, then the auction. ``state`` overrides the
    cluster's (free, nonzero_requested) with the previous launch's
    post-batch chain; ``gid``/``rep`` (Mirror._batch_groups) dedup phase 1
    to one row per distinct pod spec."""
    ct = unpack_cluster(cblobs, caps)
    pods = unpack_pods(pblobs, caps, pfields, ptmpl)
    b = pblobs.f32.shape[0]
    dev = pblobs.f32.device
    if enabled_filters is None:
        enabled_filters = (True,) * NUM_FILTER_PLUGINS
    if not enabled_filters[FILTER_PLUGINS.index("NodeResourcesFit")]:
        raise NotImplementedError(
            "launch with NodeResourcesFit disabled takes the serial commit "
            "scan: ROADMAP queue 1 item 2 (K3)")
    act = frozenset(("nodeaffinity", "taints", "ports", "images")
                    if active is None else active)
    rows, g_of = phase1_rows(gid, rep, b, dev)
    if ptmpl is None:
        raise ValueError("schedule_batch needs the pod template blob")
    prow_f32, prow_i32 = full_pod_rows(pblobs, ptmpl, caps, pfields, rows)
    p1 = phase1_static(cblobs, prow_f32, prow_i32, caps, wk,
                       enabled_filters[:NUM_STATIC], act)
    free0 = ct.free if state is None else state[0]
    nzr0 = ct.nonzero_requested if state is None else state[1]
    return _rounds_commit(ct, pods, g_of, p1, weights, free0, nzr0,
                          fit_strategy, fit_shape, tie_seed, auction_unroll)


def launch_batch(spec, wk, weights, caps, enabled_filters=None,
                 serial_scan=True, state=None, host_ok=None,
                 host_score=None, fit_strategy="LeastAllocated",
                 fit_shape=None, pct_nodes=0, pct_start=None,
                 learned=None, tie_seed=None, with_feats=False,
                 with_alts=False, device="cuda") -> BatchResult:
    """schedule_batch driven by a Mirror.prepare_launch LaunchSpec, on
    ``device`` (the spec's tensors move there; a missing card raises)."""
    if serial_scan:
        raise NotImplementedError(
            "serial commit scan: ROADMAP queue 1 item 2 (K3)")
    if spec.enable_topology:
        raise NotImplementedError(
            "topology launch (InterPodAffinity / PodTopologySpread): "
            "ROADMAP queue 1 item 2 (K3-K5)")
    if learned is not None:
        raise NotImplementedError(
            "learned score term: ROADMAP queue 1 item 6 (K9)")
    if with_feats or with_alts:
        raise NotImplementedError(
            "feature / alternative export: ROADMAP queue 1 item 6 (K9)")
    if pct_nodes:
        raise NotImplementedError(
            "percentageOfNodesToScore window (serial scan): ROADMAP queue 1 "
            "item 2 (K3)")
    if host_ok is not None or host_score is not None:
        raise NotImplementedError(
            "host Filter/Score plugin verdicts: ROADMAP queue 1 item 5")
    dev = torch.device(device)
    spec = spec.to(dev)
    if state is not None:
        state = (state[0].to(dev), state[1].to(dev))
    return schedule_batch(
        spec.cblobs, spec.pblobs, wk, weights, caps, enabled_filters,
        state=state, active=spec.active, pfields=spec.pfields,
        ptmpl=spec.ptmpl, gid=spec.gid, rep=spec.rep,
        fit_strategy=fit_strategy, fit_shape=fit_shape, tie_seed=tie_seed)
