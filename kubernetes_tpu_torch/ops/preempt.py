"""Preemption dry-run as a sweep over victim-prefix removals (port of the
JAX package's ops/preempt.py).

These two functions are the plain-torch statement of kernel K6 — the
executable spec its hand-written kernels (``kernels/preempt.py``,
``csrc/preempt_sweep.cu`` and ``csrc/preempt_feasible.cu``) are held to:
the same signatures and the same NONE encoding as the reference, the pod
axis written out where the reference vmaps. The reference's notes follow.

The reference dry-runs preemption per candidate node: remove all
lower-priority pods, re-run filters, then reprieve victims highest-priority
first (preemption/preemption.go:682 DryRunPreemption,
defaultpreemption/default_preemption.go:219 SelectVictimsOnNode). The
batched formulation evaluates EVERY node's every victim-prefix in one
launch: the host supplies, per node, the priority-ascending victims'
cumulative freed-resource sums ``vic_cumsum [N, K+1, C]`` (k=0 means no
eviction), and the kernel returns the minimal k per node that makes the pod
fit alongside the commit-invariant static filters. Because victims are
removed in ascending-importance order, the minimal resource-feasible prefix
is exactly the reprieve loop's fixed point for resource-driven preemption.

Topology effects of victim removal (an anti-affinity term owned by a victim)
are not modeled in the sweep: the preemptor is re-scheduled through the full
pipeline after its victims exit, so an over-optimistic candidate costs one
extra cycle, never a wrong placement.
"""

from __future__ import annotations

import dataclasses

import torch

from kubernetes_tpu_torch.kernels.phase1 import static_filters
from kubernetes_tpu_torch.kernels.topology import pod_row
from kubernetes_tpu_torch.models.pipeline import (
    FILTER_PLUGINS,
    NUM_FILTER_PLUGINS,
)
from kubernetes_tpu_torch.ops import topology as T
from kubernetes_tpu_torch.ops.features import (
    Capacities,
    ClusterBlobs,
    PodBlobs,
    unpack_cluster,
    unpack_pods,
)
from kubernetes_tpu_torch.utils.interner import NONE

# every phase-1 feature evaluated (the reference's ALL_FEATURES): the dry
# runs are off the hot path, so nothing compiles out
ALL_FEATURES = ("nodeaffinity", "taints", "ports", "images")


def preempt_sweep(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                  vic_cumsum: torch.Tensor, vic_cols: torch.Tensor,
                  caps: Capacities, enabled_filters=None,
                  free: torch.Tensor | None = None) -> torch.Tensor:
    """[P, N] i32: minimal victim count k (1..K) making each pod fit on
    each node; NONE where preemption cannot help (static filter fails,
    request exceeds allocatable, or even evicting every victim is not
    enough). A whole burst of preemptors sweeps in ONE launch.

    pblobs carries P pods (full schema). The freed-resource cumsum is
    COLUMN-SUBSET: ``vic_cols [C] i32`` names the resource columns any
    victim actually frees, ``vic_cumsum [N, K+1, C]`` is their cumulative
    freed request over the first k victims (k=0 row zero). Columns nobody
    frees are k-independent, so the plain fit-vs-base check covers them.
    Padding entries of vic_cols alias an active column: their cumsum rows
    are +BIG so they never constrain.

    ``free`` overrides the snapshot free matrix (ct.free) as the fit
    baseline: the pipelined scheduler passes its live device-resident
    chain here so a preemptor's sweep sees waves still in flight."""
    if enabled_filters is None:
        enabled_filters = (True,) * NUM_FILTER_PLUGINS
    ct = unpack_cluster(cblobs, caps)
    pods = unpack_pods(pblobs, caps)       # [P, ...] — batched preemptors
    dev = ct.free.device
    # columns handled by the k-dependent check
    col_freed = torch.zeros((ct.free.shape[1],), dtype=torch.bool,
                            device=dev)
    col_freed[vic_cols.long()] = True
    masks = static_filters(ct, pods, wk, enabled_filters[:5],
                           frozenset(ALL_FEATURES))            # [5, P, N]
    n = ct.free.shape[0]
    cols = vic_cols.long()
    out = []
    for p in range(pods.valid.shape[0]):
        pod = pod_row(pods, p)
        static_ok = torch.all(masks[:, p], dim=0) & ct.node_valid & pod.valid
        unresolvable = torch.any(pod.req[None] > ct.allocatable, dim=-1)
        # fit after evicting the first k victims, against the same
        # effective free as the pipeline's fit check (nominated
        # reservations subtracted, own nomination handed back): [N, K+1]
        own = torch.arange(n, device=dev) == pod.nominated_row
        base_free = ct.free if free is None else free
        base = (base_free - ct.nominated_req
                + torch.where(own[:, None], pod.req[None],
                              torch.zeros((), device=dev)))
        fit0 = pod.req[None] <= base                           # [N, R]
        ok_rest = torch.all(fit0 | col_freed[None], dim=-1)    # [N]
        base_c = base[:, cols]                                 # [N, C]
        req_c = pod.req[cols]                                  # [C]
        eff = base_c[:, None, :] + vic_cumsum                  # [N, K+1, C]
        fit = ok_rest[:, None] & torch.all(req_c[None, None] <= eff, dim=-1)
        # minimal k with a fit (first True)
        kmin = torch.argmax(fit.to(torch.int32), dim=1).to(torch.int32)
        any_fit = torch.any(fit, dim=1)
        ok = static_ok & ~unresolvable & any_fit
        out.append(torch.where(ok, kmin, torch.full_like(kmin, NONE)))
    return torch.stack(out)                                    # [P, N]


def spread_min(cnt: torch.Tensor, exists_hard: torch.Tensor,
               min_domains: torch.Tensor) -> torch.Tensor:
    """[C] f32: per spread constraint, the least count over the domains
    present among the hard-eligible nodes (0 when none is), and 0 when
    minDomains is set and fewer domains are present."""
    dev = cnt.device
    inf = torch.tensor(float("inf"), device=dev)
    min_cnt = torch.min(torch.where(exists_hard, cnt, inf), dim=1).values
    min_cnt = torch.where(torch.isfinite(min_cnt), min_cnt,
                          torch.zeros((), device=dev))
    num_domains = exists_hard.sum(dim=1)
    return torch.where((min_domains > 0) & (num_domains < min_domains),
                       torch.zeros((), device=dev), min_cnt)


def preempt_feasible(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                     caps: Capacities, table_valid: torch.Tensor,
                     free: torch.Tensor, enable_topology: bool = True,
                     d_cap: int | None = None, enabled_filters=None
                     ) -> torch.Tensor:
    """[N] bool: does ONE pod pass the FULL filter set on each node, with
    ``table_valid`` masking out victim pods and ``free`` overriding the
    per-node free resources?

    This is the exact dry-run the reference runs per candidate node
    (defaultpreemption SelectVictimsOnNode :219: remove victims, re-run
    RunFilterPluginsWithNominatedPods) — evaluated for EVERY node in one
    launch. The host encodes an eviction set as (table mask, freed
    resources); topology filters (anti-affinity, required affinity, hard
    spread) see the post-eviction world because every count/presence map
    is built from the masked table."""
    if enabled_filters is None:
        enabled_filters = (True,) * NUM_FILTER_PLUGINS
    if d_cap is None:
        d_cap = caps.domain_cap
    ct = unpack_cluster(cblobs, caps)
    ct = dataclasses.replace(ct, pod_valid=ct.pod_valid & table_valid)
    pods = unpack_pods(pblobs, caps)
    pod = pod_row(pods, 0)
    valid = ct.node_valid
    dev = valid.device
    masks = static_filters(ct, pods, wk, enabled_filters[:5],
                           frozenset(ALL_FEATURES))[:, 0]       # [5, N]
    ok = torch.all(masks, dim=0) & valid & pod.valid
    # resource fit against the evicted free state
    if enabled_filters[FILTER_PLUGINS.index("NodeResourcesFit")]:
        own = torch.arange(free.shape[0], device=dev) == pod.nominated_row
        eff = free - ct.nominated_req + torch.where(
            own[:, None], pod.req[None], torch.zeros((), device=dev))
        ok = ok & torch.all(pod.req[None] <= eff, dim=-1)
    if not enable_topology:
        return ok
    tds = T.slot_topo_dom(ct)
    taint_ok, nodeaff_ok = masks[2], masks[3]
    spread_on = enabled_filters[FILTER_PLUGINS.index("PodTopologySpread")]
    ipa_on = enabled_filters[FILTER_PLUGINS.index("InterPodAffinity")]
    if spread_on:
        used_c = pod.tsc_tk != NONE
        used_hard = used_c & pod.tsc_hard
        el_hard = T.spread_eligible(ct, pod, nodeaff_ok, taint_ok, used_hard)
        cnt = T.spread_cnt(ct, pod, tds, el_hard, d_cap)        # [C, D]
        exists_hard = T.spread_exists(ct, pod, el_hard, d_cap)
        min_cnt = spread_min(cnt, exists_hard, pod.tsc_min_domains)
        node_dom = T.take_cols(ct.topo_dom, pod.tsc_tk, NONE)
        self_m = T._tsc_self_match(pod).to(torch.float32)
        match_num = T.gather_rows(cnt, node_dom)                # [N, C]
        skew = match_num + self_m[None] - min_cnt[None]
        ok_c = (node_dom != NONE) & (skew <= pod.tsc_max_skew[None])
        ok = ok & torch.all(ok_c | ~used_hard[None], dim=1)
    if ipa_on:
        anti_ok, present, any_match = T.inter_pod_affinity_static(
            ct, pod, tds, d_cap)
        term_used = pod.aff_tk != NONE
        node_dom3 = T.take_cols(ct.topo_dom, pod.aff_tk, NONE)
        has_lbl = node_dom3 != NONE
        term_ok = has_lbl & T.gather_rows(present, node_dom3)
        pods_exist = torch.all(term_ok | ~term_used[None], dim=1)
        all_lbl = torch.all(has_lbl | ~term_used[None], dim=1)
        self_ok = pod.aff_self_match & ~any_match & all_lbl
        aff_ok = (pods_exist | self_ok) if bool(term_used.any()) \
            else torch.ones_like(ok)
        ok = ok & anti_ok & aff_ok
    return ok
