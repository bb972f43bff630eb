"""K4 soft_scores: the soft-score auction's per-round topology scores,
wrapper around csrc/soft_scores.cu, and the soft statics view.

A soft-only topology batch (preferred pod (anti)affinity, ScheduleAnyway
spread; no required term, no DoNotSchedule spread) keeps the auction's
round structure: soft terms are scores, never constraints. The JAX
package's models/pipeline.py computes them in two halves:

- ``_soft_statics`` (:360): the per-group static halves, once a launch.
  Here they are a view (``soft_topo``) over K5's outputs
  (kernels/topology.py), which already computes every one of them; no
  second statics kernel.
- ``_soft_scores`` (:439): the in-batch halves, every round, from the set
  of pods placed so far: the placed pods scattered into per-(group, term)
  domain maps, gathered back at every node's domain into the live
  InterPodAffinity score ``ipa_live`` and the raw spread score ``sp_r``,
  both [G, N]. This is K4, one cooperative launch a round
  (csrc/soft_scores.cu): the maps are the auction launch's state
  (``SoftOut``: they start empty with it, and ``seen`` records the row
  each pod is counted at), each round moves only the pods whose row
  changed since the last round, then gathers. Where the maps fit in
  shared memory (``plan_soft``) each block aggregates its pods' adds
  there and stages the maps there for the gather; else they stay in
  global memory under the same code, and ``LAUNCHES["soft_scores_global"]``
  counts the launch.

K4 follows the auction's round-flag protocol (kernels/auction.py): a round
whose input flag ``prog[k % 2]`` is 0 does nothing, so the host launches
``auction_unroll()`` rounds back to back and reads one flag after them.
``prepare_launch`` checks the arguments and builds the C structs once an
auction launch; ``SoftLaunch.run(k)`` launches round k.

The twins are ``soft_scatter_ref`` and ``soft_gather_ref``,
``_soft_scores`` written with torch ops (the maps from scratch, then the
gather); ``soft_scores_ref`` runs both for one round; ``soft_scores``
launches the kernel for CUDA tensors and runs the twin only for CPU
tensors. The maps the kernel keeps equal the twin's for the same placed
set.

Exactness: every value the scatter adds is an integer-valued float32 (0/1
matches and eligibilities, counts of placed pods) and every gathered
product is an integer weight (<= 100) times such a count, so all the sums
stay below 2^24 and are exact in any order. Only ``sp_r`` rounds: its
per-constraint terms ``match * tpw + (skew - 1)`` are summed left to right
over the constraints, as ``ops/common.sum_last`` does, in twin and kernel
alike.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.kernels.topology import TERM_KINDS, TopoStatics
from kubernetes_tpu_torch.ops import common as C
from kubernetes_tpu_torch.utils.interner import NONE


class SoftTopo(NamedTuple):
    """What the auction needs to score soft topology terms (the reference's
    ``_SoftTopo``, same names; the per-node domain columns ``nd_*`` are not
    materialized: twin and kernel read ``topo_dom`` at the term's key)."""

    gid: torch.Tensor            # [B] i32 topology group per pod
    valid: torch.Tensor          # [B] bool
    ipa_ok_g: torch.Tensor       # [G, N] bool; all True, ipa filter off
    ipa_raw_g: torch.Tensor      # [G, N] f32 static ipa score
    match_static_g: torch.Tensor  # [G, N, C] f32 static spread counts
    tpw_g: torch.Tensor          # [G, C] f32 log(domains + 2)
    used_soft_g: torch.Tensor    # [G, C] bool ScheduleAnyway slots
    dom_ok_g: torch.Tensor       # [G, N, C] bool node carries the key
    ign_g: torch.Tensor          # [G, N] bool ignored for spread scoring
    has_soft_g: torch.Tensor     # [G] bool
    skew_g: torch.Tensor         # [G, C] f32 maxSkew
    el_node_g: torch.Tensor      # [G, N, C] bool commit-target eligibility
    paff_tk_g: torch.Tensor      # [G, A] i32
    panti_tk_g: torch.Tensor     # [G, A] i32
    tsc_tk_g: torch.Tensor       # [G, C] i32
    paff_w_g: torch.Tensor       # [G, A] f32
    panti_w_g: torch.Tensor      # [G, A] f32
    M_paff_gg: torch.Tensor      # [G, A, G] bool
    M_panti_gg: torch.Tensor     # [G, A, G] bool
    M_tsc_gg: torch.Tensor       # [G, C, G] bool
    topo_dom: torch.Tensor       # [N, TK] i32
    d_cap: int


def soft_topo(st: TopoStatics, pods_rep, gid: torch.Tensor,
              valid: torch.Tensor, topo_dom: torch.Tensor, d_cap: int,
              ipa_on: bool) -> SoftTopo:
    """The soft statics of one launch from K5's statics of its groups.

    ``el_node``: K5 writes ``pol & all_s & used_soft`` on a soft-only
    batch, the reference's ``_soft_statics`` also ANDs ``dom_ok``; but
    ``all_s`` already requires the key of every used soft constraint, so
    the two maps are the same (tests/test_torch_soft.py holds them equal,
    nodes without the key included)."""
    nd, pr = st.nodes, st.pairs
    c = lambda t: t.contiguous()  # noqa: E731
    used_soft = (pods_rep.tsc_tk != NONE) & ~pods_rep.tsc_hard
    ipa_ok = nd.anti_ok if ipa_on else torch.ones_like(nd.anti_ok)
    return SoftTopo(
        gid=c(gid.to(torch.int32)), valid=c(valid), ipa_ok_g=c(ipa_ok),
        ipa_raw_g=nd.ipa_raw, match_static_g=nd.match_static, tpw_g=pr.tpw,
        used_soft_g=c(used_soft), dom_ok_g=nd.dom_ok, ign_g=nd.ign,
        has_soft_g=pr.has_soft,
        skew_g=c(pods_rep.tsc_max_skew.to(torch.float32)),
        el_node_g=nd.el_node, paff_tk_g=c(pods_rep.paff_tk),
        panti_tk_g=c(pods_rep.panti_tk), tsc_tk_g=c(pods_rep.tsc_tk),
        paff_w_g=c(pods_rep.paff_weight.to(torch.float32)),
        panti_w_g=c(pods_rep.panti_weight.to(torch.float32)),
        M_paff_gg=c(pr.m_terms[TERM_KINDS.index("paff")]),
        M_panti_gg=c(pr.m_terms[TERM_KINDS.index("panti")]),
        M_tsc_gg=pr.m_tsc, topo_dom=c(topo_dom), d_cap=int(d_cap))


class SoftOut(NamedTuple):
    """One launch's K4 buffers: the live scores K2a reads, rewritten every
    round, and the domain maps of the placed set (on the card the state
    the kernel updates: the pods it counts are recorded in ``seen``)."""

    ipa_live: torch.Tensor       # [G, N] f32
    sp_r: torch.Tensor           # [G, N] f32
    maps: torch.Tensor           # [4, G, A, D] f32: paff b/j, panti b/j
    tmap: torch.Tensor           # [G, C, D] f32: spread
    seen: torch.Tensor           # [B] i32 each pod's row in the maps, -1


def soft_out(soft: SoftTopo) -> SoftOut:
    g, n = soft.ipa_ok_g.shape
    a = soft.paff_tk_g.shape[1]
    c = soft.tsc_tk_g.shape[1]
    dev = soft.ipa_ok_g.device
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa
    return SoftOut(z(g, n), z(g, n), z(4, g, a, soft.d_cap),
                   z(g, c, soft.d_cap),
                   torch.full((soft.gid.shape[0],), -1, dtype=torch.int32,
                              device=dev))


# ---------------------------------------------------------------- twin


def _dom_cols(soft: SoftTopo, rows: torch.Tensor, tk_g: torch.Tensor
              ) -> torch.Tensor:
    """[G, A, len(rows)]: the domain of each node in ``rows`` under term
    (g, a)'s topology key (NONE for an unused term or a row of NONE)."""
    tk_cap = soft.topo_dom.shape[1]
    dom = rows[:, tk_g.clamp(0, tk_cap - 1).long()]              # [R, G, A]
    dom = torch.where(tk_g[None] != NONE, dom, torch.full_like(dom, NONE))
    return dom.permute(1, 2, 0)


def soft_scatter_ref(soft: SoftTopo, placed: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 twin: the placed set ``placed`` [B] (-1 = unplaced)
    scattered into the domain maps, as ``_soft_scores`` does:
    ([4, G, A, D] f32 — paff P_b, P_j, panti P_b, P_j — and [G, C, D] f32
    spread). P_b[g, a, d] counts the placed pods in domain d that group g's
    term a matches; P_j[g, a, d] the placed pods of group g itself; the
    spread map the matching pods placed on eligible commit targets."""
    d_cap = soft.d_cap
    n_cap = soft.topo_dom.shape[0]
    g_n = soft.ipa_ok_g.shape[0]
    dev = placed.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ok = placed >= 0
    r = placed.clamp(0, n_cap - 1).long()
    dom_rows = torch.where(ok[:, None], soft.topo_dom[r],
                           torch.full_like(soft.topo_dom[r], NONE))
    gid_oh = ((soft.gid[:, None].long()
               == torch.arange(g_n, device=dev)[None, :]).to(torch.float32)
              * soft.valid[:, None].to(torch.float32))              # [B, G]

    def scatter(dy_t, val):
        # domain ids are checked against d_cap: the padding group's zeroed
        # term rows name arbitrary keys whose domains may exceed the bucket
        g, a, _ = dy_t.shape
        dv = (dy_t >= 0) & (dy_t < d_cap) & ok[None, None, :]
        flat = (torch.arange(g, device=dev)[:, None, None] * (a * d_cap)
                + torch.arange(a, device=dev)[None, :, None] * d_cap
                + dy_t.clamp(0, d_cap - 1))
        out = torch.zeros((g * a * d_cap,), dtype=torch.float32, device=dev)
        out.index_add_(0, flat.reshape(-1).long(),
                       torch.where(dv, val, zero).reshape(-1))
        return out.reshape(g, a, d_cap)

    maps = []
    for tk_g, m_gg in ((soft.paff_tk_g, soft.M_paff_gg),
                       (soft.panti_tk_g, soft.M_panti_gg)):
        dy_t = _dom_cols(soft, dom_rows, tk_g)                      # [G, A, B]
        # b-side: x's own term a matches committed pod y; j-side: y's own
        # term a, counted for its own group
        maps.append(scatter(dy_t, m_gg.to(torch.float32) @ gid_oh.T))
        maps.append(scatter(dy_t, gid_oh.T[:, None, :].expand_as(dy_t)))
    el_y = soft.el_node_g[:, r, :].permute(0, 2, 1)                # [G, C, B]
    val = (soft.M_tsc_gg.to(torch.float32) @ gid_oh.T) \
        * el_y.to(torch.float32)
    tmap = scatter(_dom_cols(soft, dom_rows, soft.tsc_tk_g), val)
    return torch.stack(maps), tmap


def soft_gather_ref(soft: SoftTopo, maps: torch.Tensor, tmap: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 twin: (ipa_live, sp_r), [G, N] each, gathered from the
    domain maps at every node's domains, as ``_soft_scores`` does."""
    d_cap = soft.d_cap
    zero = torch.zeros((), dtype=torch.float32, device=maps.device)

    def gather(m, nd_g):
        nd_ok = (nd_g >= 0) & (nd_g < d_cap)
        got = torch.gather(m, 2, nd_g.clamp(0, d_cap - 1).long())
        return torch.where(nd_ok, got, zero)

    def pair_delta(p_b, p_j, tk_g, m_gg, w_g):
        # [G, N] weighted same-domain mass from the placed pods, both
        # directions of the preferred terms
        nd_g = _dom_cols(soft, soft.topo_dom, tk_g)                 # [G, A, N]
        delta_b = (gather(p_b, nd_g) * w_g[:, :, None]).sum(dim=1)
        delta_j = torch.einsum("gah,gan->hn",
                               m_gg.to(torch.float32) * w_g[:, :, None],
                               gather(p_j, nd_g))
        return delta_b + delta_j

    ipa_live = soft.ipa_raw_g + (
        pair_delta(maps[0], maps[1], soft.paff_tk_g, soft.M_paff_gg,
                   soft.paff_w_g)
        - pair_delta(maps[2], maps[3], soft.panti_tk_g, soft.M_panti_gg,
                     soft.panti_w_g))
    match = (soft.match_static_g.permute(0, 2, 1)
             + gather(tmap, _dom_cols(soft, soft.topo_dom,
                                      soft.tsc_tk_g)))              # [G, C, N]
    per_c = match * soft.tpw_g[:, :, None] + (soft.skew_g[:, :, None] - 1.0)
    per_c = torch.where(soft.used_soft_g[:, :, None]
                        & soft.dom_ok_g.permute(0, 2, 1), per_c, zero)
    sp_r = torch.where(soft.ign_g, zero,
                       C.sum_last(per_c.permute(0, 2, 1)))
    return ipa_live, sp_r


def live_scores(soft: SoftTopo, placed: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ipa_live, sp_r) for the placed set ``placed``: ``_soft_scores``,
    the two stage twins in order."""
    return soft_gather_ref(soft, *soft_scatter_ref(soft, placed))


def soft_scores_ref(soft: SoftTopo, placed: torch.Tensor,
                    prog: torch.Tensor, k: int, out: SoftOut) -> None:
    """One round of both stages into ``out`` (the maps too); nothing when
    the round's input flag is 0."""
    if int(prog[k % 2]) == 0:
        return
    maps, tmap = soft_scatter_ref(soft, placed)
    out.maps.copy_(maps)
    out.tmap.copy_(tmap)
    ipa_live, sp_r = soft_gather_ref(soft, maps, tmap)
    out.ipa_live.copy_(ipa_live)
    out.sp_r.copy_(sp_r)


# ---------------------------------------------------------------- kernel

SOFT_THREADS = 256
# bytes of shared memory a block may give the maps (the delta's
# aggregation and the gather's staged copy); past it they stay global
MAPS_SMEM_MAX = 64 * 1024

_DIMS = ("B", "G", "N", "TK", "A", "C", "D", "maps_shared")
_POINTERS = (
    "gid", "valid", "placed", "topo_dom", "paff_tk", "panti_tk", "tsc_tk",
    "paff_w", "panti_w", "m_paff", "m_panti", "m_tsc", "el_node", "ipa_raw",
    "match_static", "tpw", "skew", "used_soft", "dom_ok", "ign", "prog_in",
    "seen", "maps", "tmap", "ipa_live", "sp_r")


class _SoftArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in _DIMS]
                + [(name, ctypes.c_void_p) for name in _POINTERS])


class SoftPlan(NamedTuple):
    """K4's layout: the maps in shared memory or not, the dynamic shared
    memory a block (the maps where shared, then the two term lists of
    A + G*A entries of 3 words and their counts) and the gather's
    (group, 256 nodes) items."""

    maps_shared: bool
    smem_bytes: int
    items: int


def plan_soft(g: int, n: int, a: int, c: int, d: int) -> SoftPlan:
    maps = (4 * g * a + g * c) * d * 4
    lists = (2 + 2 * 3 * (a + g * a)) * 4
    shared = maps + lists <= MAPS_SMEM_MAX
    return SoftPlan(shared, (maps if shared else 0) + lists,
                    g * -(-n // SOFT_THREADS))


class SoftLaunch(NamedTuple):
    """K4's launch for one auction launch, built once: one C struct for
    each round parity, the cooperative grid; ``run(k)`` launches round
    k."""

    args: tuple               # (_SoftArgs for k % 2 == 0, for k % 2 == 1)
    plan: SoftPlan
    blocks: int
    tensors: dict             # every tensor the kernel reads or writes
    fn: object
    stream: object

    def run(self, k: int) -> None:
        KB.check("soft_scores", self.fn(
            ctypes.byref(self.args[k % 2]), self.blocks,
            self.plan.smem_bytes, self.stream))
        KB.LAUNCHES["soft_scores"] += 1
        if not self.plan.maps_shared:
            KB.LAUNCHES["soft_scores_global"] += 1


_GRIDS: dict = {}


def _grid(lib, smem: int) -> int:
    """The largest cooperative grid of K4 blocks with ``smem`` bytes."""
    got = _GRIDS.get((id(lib), smem))
    if got is None:
        blocks = ctypes.c_int()
        KB.check("soft_scores", lib.soft_scores_grid(smem,
                                                     ctypes.byref(blocks)))
        if blocks.value < 1:
            raise RuntimeError(f"soft_scores: no block of {smem} B of "
                               "shared memory fits an SM")
        got = _GRIDS[(id(lib), smem)] = blocks.value
    return got


def prepare_launch(soft: SoftTopo, placed: torch.Tensor, prog: torch.Tensor,
                   out: SoftOut) -> SoftLaunch:
    """Check every argument (device, dtype, shape, contiguity) and build
    the C argument structs of one auction launch's rounds."""
    dev = soft.ipa_ok_g.device
    g, n = soft.ipa_ok_g.shape
    b = soft.gid.shape[0]
    a, c = soft.paff_tk_g.shape[1], soft.tsc_tk_g.shape[1]
    tk, d = soft.topo_dom.shape[1], soft.d_cap
    if c < 1:
        raise ValueError("soft_scores: no spread constraint slots")
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    table = {
        "gid": (soft.gid, i32, (b,)), "valid": (soft.valid, u8, (b,)),
        "placed": (placed, i32, (b,)),
        "topo_dom": (soft.topo_dom, i32, (n, tk)),
        "paff_tk": (soft.paff_tk_g, i32, (g, a)),
        "panti_tk": (soft.panti_tk_g, i32, (g, a)),
        "tsc_tk": (soft.tsc_tk_g, i32, (g, c)),
        "paff_w": (soft.paff_w_g, f32, (g, a)),
        "panti_w": (soft.panti_w_g, f32, (g, a)),
        "m_paff": (soft.M_paff_gg, u8, (g, a, g)),
        "m_panti": (soft.M_panti_gg, u8, (g, a, g)),
        "m_tsc": (soft.M_tsc_gg, u8, (g, c, g)),
        "el_node": (soft.el_node_g, u8, (g, n, c)),
        "ipa_raw": (soft.ipa_raw_g, f32, (g, n)),
        "match_static": (soft.match_static_g, f32, (g, n, c)),
        "tpw": (soft.tpw_g, f32, (g, c)), "skew": (soft.skew_g, f32, (g, c)),
        "used_soft": (soft.used_soft_g, u8, (g, c)),
        "dom_ok": (soft.dom_ok_g, u8, (g, n, c)),
        "ign": (soft.ign_g, u8, (g, n)),
        "prog_in": (prog, i32, (2,)),
        "seen": (out.seen, i32, (b,)),
        "maps": (out.maps, f32, (4, g, a, d)),
        "tmap": (out.tmap, f32, (g, c, d)),
        "ipa_live": (out.ipa_live, f32, (g, n)),
        "sp_r": (out.sp_r, f32, (g, n))}
    for name, (t, dtype, shape) in table.items():
        KB.require(t, name, dtype, shape, dev)
    plan = plan_soft(g, n, a, c, d)
    args = []
    for parity in (0, 1):
        s = _SoftArgs(B=b, G=g, N=n, TK=tk, A=a, C=c, D=d,
                      maps_shared=int(plan.maps_shared))
        for name, (t, _, _) in table.items():
            setattr(s, name, t.data_ptr())
        s.prog_in = prog.data_ptr() + 4 * parity
        args.append(s)
    lib = KB.library("soft_scores")
    lib.soft_scores_grid.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn = lib.soft_scores_launch
    fn.argtypes = [ctypes.POINTER(_SoftArgs), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = max(1, min(_grid(lib, plan.smem_bytes),
                        max(plan.items, -(-b * g // SOFT_THREADS))))
    return SoftLaunch(tuple(args), plan, blocks,
                      {name: t for name, (t, _, _) in table.items()}, fn,
                      KB.stream_handle())


def soft_launch(soft: SoftTopo, placed: torch.Tensor, prog: torch.Tensor,
                out: SoftOut) -> SoftLaunch | None:
    """The prebuilt K4 launch of one auction launch on the card; None for
    CPU tensors (the twin needs none)."""
    if soft.ipa_ok_g.device.type != "cuda":
        return None
    return prepare_launch(soft, placed, prog, out)


def soft_scores(soft: SoftTopo, placed: torch.Tensor, prog: torch.Tensor,
                k: int, out: SoftOut, launch: SoftLaunch | None = None) -> None:
    """K4, one round: the kernel for CUDA tensors (``launch``, built once
    for the auction launch, or built here), the twin for CPU tensors."""
    dev = soft.ipa_ok_g.device
    if dev.type == "cpu":
        return soft_scores_ref(soft, placed, prog, k, out)
    if dev.type != "cuda":
        raise ValueError(f"soft_scores: unsupported device {dev}")
    if launch is None or launch.tensors["placed"] is not placed \
            or launch.tensors["seen"] is not out.seen \
            or launch.tensors["prog_in"] is not prog:
        launch = prepare_launch(soft, placed, prog, out)
    launch.run(k)
