"""Gang admission on the device (port of the JAX package's ops/gang.py): the
fused gang-batch packer that places ALL members of a PodGroup in one
launch, and the async capacity bound the host-fallback PreFilter consults.

These functions are the plain-torch statement of kernel K7 — the
executable spec its hand-written kernels (``kernels/gang.py``,
``csrc/gang_pack.cu`` K7a and ``csrc/gang_capacity.cu`` K7b) are held to:
the reference's signatures and outputs, its scan over gangs written as a
Python loop. The reference's notes follow.

The batch's gang units are packed as one ``[G, N]`` problem over the
cluster mirror — one representative pod row per gang (members of a
device-packable gang are request-identical by construction;
heterogeneous gangs stay on the host Permit path) and a ``need`` count of
members to place. Per gang:

1. **Member capacity per node** — the static Filter masks (phase 1, K1)
   AND a floored free/request division give ``cap_n`` = how many members
   node n can still hold, with nominated reservations subtracted exactly
   like the batched fit predicate.
2. **All-or-nothing feasibility reduction** — ``sum(cap_n) >= need`` is
   the gang's device verdict: every member places or none do. ``cap`` in
   the result is that bound, fed back into the PreFilter memo.
3. **Topology-close packing** — nodes are filled in domain-major order
   under the packing topology key (zone): domains ranked by member
   capacity DESCENDING, the densest nodes first within a domain.
   ``spans`` reports how many domains the placement touched.

Gangs commit SEQUENTIALLY inside the launch: gang g+1 sees g's placements
in the carried free/nzr state. The post-batch ``free``/``nzr`` chain to
the next launch exactly like ``BatchResult.free``/``.nzr``.

Integer arithmetic. The reference ranks domains, keys nodes and takes its
fill-order prefix in int32, which wraps once more than 2^31 member slots
precede a node (NodeResourcesFit off, or a request that binds almost
nothing, on more than 2,048 eligible nodes): a node deep in the fill order
then "takes" 2^20 members. The port sums in int64 and places exactly
``need`` members there; below that size both are identical. ``cap`` is
the f32 sum of the per-node capacities; the twin rounds the exact sum
once, which equals the reference's whenever the total is under 2^24 (the
reference's reduction order is XLA's, so above 2^24 the last bits may
differ; no verdict reads them: members are counted far below 2^24).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_tpu_torch.kernels.phase1 import NUM_STATIC, phase1_static
from kubernetes_tpu_torch.models.pipeline import (
    FILTER_PLUGINS,
    NUM_FILTER_PLUGINS,
    full_pod_rows,
)
from kubernetes_tpu_torch.ops.blobs import Blobs
from kubernetes_tpu_torch.ops.features import (
    Capacities,
    ClusterBlobs,
    PodBlobs,
    codecs,
)

# big sentinel member-count for request columns/pods that bind nothing
UNBOUNDED = 2.0 ** 20

# the composite node sort key packs (domain rank, density) into one int:
# rank * KEY_STRIDE + (KEY_STRIDE - 1 - clipped capacity)
KEY_STRIDE = 4096

# the capacity bound's ceiling (and K7b's answer with no active column)
CAP_LIMIT = 2.0 ** 30


@dataclass
class GangPackResult:
    """Per-gang outcome of one fused packing launch."""

    ok: torch.Tensor        # [G] bool: all-or-nothing verdict
    alloc: torch.Tensor     # [G, N] i32: members placed per node (0s when !ok)
    cap: torch.Tensor       # [G] i32: member-capacity bound over feasible nodes
    spans: torch.Tensor     # [G] i32: topology domains the placement touches
    free: torch.Tensor      # [N, R] f32: post-batch free resources (chains)
    nzr: torch.Tensor       # [N, 2] f32: post-batch nonzero-requested
    guard: torch.Tensor     # [] i32: NaN poison detector (bit 1, like pipeline)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 conversion: NaN -> 0, saturating at the int32
    range, truncation toward zero in between (torch's own cast leaves the
    out-of-range cases undefined)."""
    x = x.to(torch.float64)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.clamp(x, -2.0 ** 31, 2.0 ** 31 - 1).trunc().to(torch.int32)


def pack_domain(topo_dom: torch.Tensor, tk: int, d_cap: int) -> torch.Tensor:
    """[N] i32 node -> packing domain: the ``tk`` column of the topology
    table; NONE labels (and tk = -1, and ids past the bucket) collapse
    into the last slot, the pseudo-domain of topology-less nodes."""
    dom_raw = topo_dom[:, max(int(tk), 0)]
    keep = (int(tk) >= 0) & (dom_raw >= 0) & (dom_raw < d_cap - 1)
    return torch.where(keep, dom_raw,
                       torch.full_like(dom_raw, d_cap - 1)).to(torch.int32)


def pack_core(free0: torch.Tensor, nzr0: torch.Tensor, nom: torch.Tensor,
              static_ok: torch.Tensor, dom: torch.Tensor, req: torch.Tensor,
              nzreq: torch.Tensor, need: torch.Tensor,
              own_nom: torch.Tensor | None, d_cap: int, fit_on: bool
              ) -> GangPackResult:
    """K7a's spec: the reference's ``body`` (ops/gang.py:133-178) for each
    gang in order, over the phase-1 mask ``static_ok`` [G, N] and the
    packing domain ``dom`` [N] (``pack_domain``)."""
    free = free0.clone()
    nzr = nzr0.clone()
    g_n, n = static_ok.shape
    dev = free.device
    dom_l = dom.long()
    oks, allocs, caps, spans = [], [], [], []
    for g in range(g_n):
        m = int(need[g])
        rq = req[g]
        if fit_on:
            onom = (own_nom[g].to(torch.float32) if own_nom is not None
                    else torch.zeros((n,), dtype=torch.float32, device=dev))
            eff = torch.maximum((free - nom) + onom[:, None] * rq[None, :],
                                torch.zeros((), device=dev))
            active = rq > 0.0
            safe = torch.where(active, rq, torch.ones_like(rq))
            per_col = torch.floor(eff / safe[None, :])
            per_col = torch.where(active[None, :], per_col,
                                  torch.full_like(per_col, UNBOUNDED))
            cap_f = per_col.amin(dim=1)
        else:
            cap_f = torch.full((n,), UNBOUNDED, dtype=torch.float32,
                               device=dev)
        cap_f = torch.clamp(cap_f, 0.0, UNBOUNDED)
        cap_n = torch.where(static_ok[g], f32_to_i32(cap_f),
                            torch.zeros((n,), dtype=torch.int32, device=dev))
        cap_l = cap_n.long()
        total = torch.minimum(cap_l.sum().to(torch.float64)
                              .to(torch.float32),
                              torch.tensor(CAP_LIMIT, device=dev))
        cap_total = int(f32_to_i32(total))
        feasible = cap_total >= m and m > 0
        # domain-major greedy fill: domains by capacity descending (lower
        # id first at equal capacity), densest nodes first within a
        # domain (lower index first at equal density)
        dcap = torch.zeros((d_cap,), dtype=torch.int64,
                           device=dev).index_add_(0, dom_l, cap_l)
        d_rank = torch.empty_like(dcap)
        d_rank[torch.argsort(-dcap, stable=True)] = torch.arange(
            d_cap, device=dev)
        key = (d_rank[dom_l] * KEY_STRIDE
               + (KEY_STRIDE - 1 - torch.clamp(cap_l, max=KEY_STRIDE - 1)))
        order = torch.argsort(key, stable=True)
        cap_sorted = cap_l[order]
        prefix = torch.cumsum(cap_sorted, 0) - cap_sorted
        take_sorted = torch.minimum(torch.clamp(m - prefix, min=0),
                                    cap_sorted)
        take = torch.zeros_like(cap_l).scatter_(0, order, take_sorted)
        if not feasible:
            take.zero_()
        take = take.to(torch.int32)
        tf = take.to(torch.float32)
        free = free - tf[:, None] * rq[None, :]
        nzr = nzr + tf[:, None] * nzreq[g][None, :]
        used = torch.zeros((d_cap,), dtype=torch.int64,
                           device=dev).index_add_(0, dom_l,
                                                  (take > 0).long())
        oks.append(feasible)
        allocs.append(take)
        caps.append(cap_total)
        spans.append(int((used > 0).sum()))
    guard = torch.isnan(free).any().to(torch.int32) << 1
    return GangPackResult(
        ok=torch.tensor(oks, dtype=torch.bool, device=dev).reshape(g_n),
        alloc=(torch.stack(allocs) if allocs else
               torch.zeros((0, n), dtype=torch.int32, device=dev)),
        cap=torch.tensor(caps, dtype=torch.int32, device=dev).reshape(g_n),
        spans=torch.tensor(spans, dtype=torch.int32,
                           device=dev).reshape(g_n),
        free=free, nzr=nzr, guard=guard)


def pack_inputs(cblobs: ClusterBlobs, gblobs: PodBlobs, wk: dict,
                caps: Capacities, enabled_filters=None, active=None,
                pfields=None, ptmpl=None, state=None, split=None,
                clock=None):
    """What the packer reads besides ``need``/``tk``: (phase-1 mask
    [G, N], free0, nzr0, nominated_req, gang requests [G, R], nonzero
    requests [G, 2], fit_on, topo_dom [N, TK]). K1 gives the mask (the
    kernel on the card, its twin on the CPU); ``split`` (a dict) adds
    the seconds of K1's call on ``clock`` under "k1". Only the fields it
    reads are sliced from the blobs (the gang rows' from K1's full rows),
    not the whole cluster and pod views."""
    node_codec, _, pod_codec = codecs(caps)
    nodes = Blobs(f32=cblobs.node_f32, i32=cblobs.node_i32)
    if enabled_filters is None:
        enabled_filters = (True,) * NUM_FILTER_PLUGINS
    act = frozenset(active if active is not None else ())
    g = gblobs.f32.shape[0]
    rows = torch.arange(g, device=gblobs.f32.device)
    prow_f32, prow_i32 = full_pod_rows(gblobs, ptmpl, caps, pfields, rows)
    t0 = clock() if split is not None else 0.0
    p1 = phase1_static(cblobs, prow_f32, prow_i32, caps, wk,
                       enabled_filters[:NUM_STATIC], act)
    if split is not None:
        split["k1"] += clock() - t0
    free0 = (node_codec.field(nodes, "free") if state is None
             else state[0])
    nzr0 = (node_codec.field(nodes, "nonzero_requested") if state is None
            else state[1])
    fit_on = enabled_filters[FILTER_PLUGINS.index("NodeResourcesFit")]
    rows = Blobs(f32=prow_f32, i32=prow_i32)
    return (p1.static_ok, free0, nzr0,
            node_codec.field(nodes, "nominated_req"),
            pod_codec.field(rows, "req"),
            pod_codec.field(rows, "nonzero_req"), bool(fit_on),
            node_codec.field(nodes, "topo_dom"))


def pack_gangs(cblobs: ClusterBlobs, gblobs: PodBlobs, wk: dict,
               caps: Capacities, need, tk: int, d_cap: int = 8,
               enabled_filters=None, active=None, pfields=None, ptmpl=None,
               state=None, own_nom=None) -> GangPackResult:
    """Place every gang of the batch in one launch (module docstring; the
    reference's ``pack_gangs``). ``gblobs`` carries ONE representative
    pod row per gang; ``need`` [G] is how many members to place (0 = a
    padding row, a no-op). ``tk`` is the packing topology key's column in
    the topology table; -1 packs capacity-greedy with every node in one
    shared domain. ``d_cap`` bounds the domain space; the last slot is
    the pseudo-domain of unlabeled nodes. ``state`` overrides
    free/nonzero_requested with a previous launch's chain. ``own_nom``
    [G, N] counts the gang's OWN members nominated per node: their
    reserved requests are handed back before the capacity division."""
    (static_ok, free0, nzr0, nom, req, nzreq, fit_on,
     topo_dom) = pack_inputs(cblobs, gblobs, wk, caps, enabled_filters,
                             active, pfields, ptmpl, state)
    dev = static_ok.device
    need_t = torch.as_tensor(need, dtype=torch.int32).to(dev)
    onom = (None if own_nom is None
            else torch.as_tensor(own_nom, dtype=torch.int32).to(dev))
    return pack_core(free0, nzr0, nom, static_ok,
                     pack_domain(topo_dom, tk, d_cap), req, nzreq, need_t,
                     onom, d_cap, fit_on)


def capacity(free: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """K7b's spec (the reference's ``_capacity``): [N, R] free x [R]
    request -> scalar i32, the optimistic member-capacity bound. A request
    with NO active column fits anywhere: 2^30. The f32 sum rounds the
    exact sum once (see the module docstring)."""
    active = req > 0.0
    safe = torch.where(active, req, torch.ones_like(req))
    per_col = torch.floor(torch.clamp(free, min=0.0) / safe[None, :])
    per_col = torch.where(active[None, :], per_col,
                          torch.full_like(per_col, CAP_LIMIT))
    per_node = torch.clamp(per_col.amin(dim=1), 0.0, CAP_LIMIT)
    total = per_node.to(torch.float64).sum().to(torch.float32)
    if not bool(active.any()):
        total = torch.tensor(CAP_LIMIT, dtype=torch.float32,
                             device=free.device)
    return f32_to_i32(total)
