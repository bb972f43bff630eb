"""K2 auction round kernels: wrappers around csrc/auction_score_argmax.cu
(K2a, bids + the end-state counts) and csrc/auction_accept_commit.cu
(K2b, per-node acceptance + commit), with their plain-torch twins.

A round reads the progress flag the previous round wrote (``prog[k % 2]``)
and writes its own (``prog[(k + 1) % 2]``); a round whose input flag is 0
does nothing but pass the 0 on, so the host can launch several rounds
back to back and read one flag at the end. K2b's launch is checked and
built once an auction launch (``commit_launch``: one C struct a round
parity, its layout from ``plan_commit``), and K2a writes its bids into
the buffers that launch reads (``bid_buffers``), so a round costs the
host one launch call each. The twins (``*_ref``) are
written as the ported ops/ functions with the batch axis written out and
follow the same flag protocol; the wrappers run them only for CPU
tensors.

On a soft-only topology launch K2a runs in soft mode (``RoundInputs``'
soft fields set): the InterPodAffinity mask joins the feasible set, the
live soft scores K4 (kernels/soft.py) wrote for the round join the totals,
and the final mode also counts the nodes the mask alone rejects.

With ``RoundInputs.learned`` set (a kernels/learned.py LearnedParams), the
bids add ``w_learned`` times the learned score term (K9, the device
function of csrc/learned_mlp.cuh; twin ops/learned.py) to every total,
after the hand terms and, in soft mode, after the spread and ipa terms:
its spread and ipa features are those normalized soft scores, 0 in the
plain mode.

After the last round, a launch with a learned scorer or an export on runs
K2a's export pass (``auction_export``, counter ``auction_export``; twin
``auction_export_ref``): every pod scored against the end state over its
candidates, giving the chosen row's features, the top ALT_K alternatives
and the batch's learned magnitude, summed in a fixed order (``lane_sum``)
so kernel and twin agree bit for bit.

The RequestedToCapacityRatio shape is read from device arrays of any
length (``shape_args``), and the resource columns have no compiled cap:
the one limit is a block's shared memory (``tiling_of`` returns None past
it and the launch is refused).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.ops import common as C
from kubernetes_tpu_torch.ops import learned as LN
from kubernetes_tpu_torch.ops import scores as SC

FIT_STRATEGIES = {"LeastAllocated": 0, "MostAllocated": 1,
                  "RequestedToCapacityRatio": 2}
MAX_P = 16                 # csrc/auction_score_argmax.cu: pods (warps) a block
K9_NARROW = 16             # ... and K9's largest narrow class there
_MASK32 = 0xFFFFFFFF


@dataclass
class RoundInputs:
    """One launch's auction state. ``free``/``nzr``/``placed``/``win`` are
    updated in place by the commit; everything else is read-only."""

    free: torch.Tensor        # [N, R] f32
    nzr: torch.Tensor         # [N, 2] f32
    nom: torch.Tensor         # [N, R] f32 nominated reservations
    alloc2: torch.Tensor      # [N, 2] f32 cpu / memory allocatable
    req: torch.Tensor         # [B, R] f32
    nzreq: torch.Tensor       # [B, 2] f32
    nominated_row: torch.Tensor  # [B] i32
    uid: torch.Tensor         # [B] i32
    gid: torch.Tensor         # [B] i32 phase-1 group of each pod
    static_ok: torch.Tensor   # [G, N] bool
    taint_raw: torch.Tensor   # [G, N] f32
    aff_raw: torch.Tensor     # [G, N] f32
    img: torch.Tensor         # [G, N] f32
    placed: torch.Tensor      # [B] i32, -1 = unplaced
    win: torch.Tensor         # [B] f32
    weights: tuple            # 7 floats, ScoreWeights.totals() order
    fit_strategy: str = "LeastAllocated"
    fit_shape: Optional[tuple] = None   # (xs, ys) for RequestedToCapacityRatio
    seed: int = 0
    k_accept: Optional[torch.Tensor] = None  # [] i32, set iff B > N
    # soft-topology mode (a soft-only topology launch), all set or all None:
    # the static InterPodAffinity mask joins the feasible set, and the
    # normalized live soft scores (K4 writes them every round) the totals
    ipa_ok: Optional[torch.Tensor] = None    # [G, N] bool
    ipa_live: Optional[torch.Tensor] = None  # [G, N] f32
    sp_r: Optional[torch.Tensor] = None      # [G, N] f32
    ign: Optional[torch.Tensor] = None       # [G, N] bool
    has_soft: Optional[torch.Tensor] = None  # [G] bool
    # the learned score term (K9): packed params and ScoreWeights.learned
    learned: Optional[KL.LearnedParams] = None
    w_learned: float = 0.0

    @property
    def soft(self) -> bool:
        return self.ipa_ok is not None

    @property
    def n(self) -> int:
        return self.free.shape[0]

    @property
    def b(self) -> int:
        return self.req.shape[0]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def tie_perturb(b: torch.Tensor, n: int, seed=None) -> torch.Tensor:
    """[B, n] pseudo-random f32 in [0, 1) keyed by (pod uid b, node index):
    models/pipeline.py tie_perturb's uint32 hash, computed in int64 masked
    to 32 bits (torch on the CPU has no right shift for uint32)."""
    dev = b.device
    x = _mul32(torch.arange(n, dtype=torch.int64, device=dev), 2654435761)
    x = x[None, :] ^ _mul32(b.to(torch.int64) & _MASK32, 40503)[:, None]
    if seed is not None:
        x = x ^ _mul32(torch.tensor(int(seed) & _MASK32, device=dev),
                       2654435761)
    x = _mul32(x ^ (x >> 15), 2246822519)
    x = x ^ (x >> 13)
    return (x >> 8).to(torch.float32) / float(1 << 24)


def _flags(prog: torch.Tensor, k: int) -> tuple[int, int]:
    return k % 2, (k + 1) % 2


def _eff(rin: RoundInputs) -> torch.Tensor:
    """[B, N, R] effective free rows: nominated reservations subtracted,
    each pod's own nomination handed back."""
    n = rin.n
    own = (torch.arange(n, device=rin.free.device)[None, :]
           == rin.nominated_row[:, None])
    zero = torch.zeros((), dtype=torch.float32, device=rin.free.device)
    return ((rin.free - rin.nom)[None]
            + torch.where(own[..., None], rin.req[:, None, :], zero))


def _fit(rin: RoundInputs) -> torch.Tensor:
    return torch.all(rin.req[:, None, :] <= _eff(rin), dim=-1)


# ---------------------------------------------------------------- twins


def auction_score_argmax_ref(rin: RoundInputs, prog: torch.Tensor, k: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One round's bids: (choice [B] i32, win_now [B] f32)."""
    fin, fout = _flags(prog, k)
    b, n = rin.b, rin.n
    choice = torch.full((b,), -1, dtype=torch.int32, device=rin.req.device)
    win_now = torch.zeros((b,), dtype=torch.float32, device=rin.req.device)
    if int(prog[fin]) == 0:
        prog[fout] = 0
        return choice, win_now
    prog[fout] = 0
    gid = rin.gid.long()
    feasible = rin.static_ok[gid] & _fit(rin) & (rin.placed < 0)[:, None]
    if rin.soft:
        feasible = feasible & rin.ipa_ok[gid]
    frac = SC.utilization_fractions(rin.alloc2, rin.nzr, rin.nzreq)
    fit = SC.fit_score_from_fractions(frac, rin.fit_strategy, rin.fit_shape)
    bal = SC.balanced_allocation_from_fractions(frac)
    taint = SC.normalize_inverse(rin.taint_raw[gid], feasible)
    aff = SC.normalize_max(rin.aff_raw[gid], feasible)
    w = rin.weights
    total = (w[0] * taint + w[1] * aff + w[2] * fit + w[3] * bal
             + w[4] * rin.img[gid])
    sp_n = ipa_n = None
    if rin.soft:
        # the live soft halves, normalized per pod as in the serial scan
        ipa_n = SC.normalize_maxmin(rin.ipa_live[gid], feasible)
        sp_n = torch.where(rin.has_soft[gid][:, None],
                           SC.normalize_spread(rin.sp_r[gid], feasible,
                                               rin.ign[gid]),
                           torch.zeros((), dtype=torch.float32,
                                       device=total.device))
        total = total + w[5] * sp_n + w[6] * ipa_n
    if rin.learned is not None:
        total = total + rin.w_learned * LN.learned_term(
            rin.learned.layers, frac, fit, bal, taint, aff, rin.img[gid],
            sp_n, ipa_n)
    perturb = tie_perturb(rin.uid, n, rin.seed)
    choice = C.masked_argmax_random(total, feasible, perturb)
    win_now = torch.gather(total, 1,
                           choice.clamp(0, n - 1).long()[:, None])[:, 0]
    return choice, win_now


def auction_accept_commit_ref(rin: RoundInputs, choice: torch.Tensor,
                              win_now: torch.Tensor, prog: torch.Tensor,
                              k: int) -> None:
    """One round's acceptance + commit into rin.free/nzr/placed/win."""
    fin, fout = _flags(prog, k)
    if int(prog[fin]) == 0:
        return
    b, n = rin.b, rin.n
    dev = rin.free.device
    chosen = choice[:, None] == torch.arange(n, device=dev)[None, :]
    idx_b = torch.arange(b, device=dev)
    safe = choice.clamp(0, n - 1).long()
    if rin.k_accept is not None:
        eff = _eff(rin)
        rank = torch.cumsum(chosen.to(torch.int32), dim=0) - 1
        take = chosen & (rank < rin.k_accept)
        cum_ok = torch.ones((b, n), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        for r in range(rin.req.shape[1]):
            cr = torch.cumsum(torch.where(take, rin.req[:, r:r + 1], zero),
                              dim=0)
            cum_ok &= cr <= eff[:, :, r]
        acc_cell = take & cum_ok
        accept = (choice >= 0) & torch.gather(acc_cell, 1, safe[:, None])[:, 0]
    else:
        cand = torch.where(chosen, idx_b[:, None], torch.tensor(b, device=dev))
        first_idx = cand.amin(dim=0)
        accept = (choice >= 0) & (first_idx[safe] == idx_b)
    rows = safe[accept]
    d_free = torch.zeros_like(rin.free).index_add_(0, rows, rin.req[accept])
    d_nzr = torch.zeros_like(rin.nzr).index_add_(0, rows, rin.nzreq[accept])
    rin.free.sub_(d_free)
    rin.nzr.add_(d_nzr)
    rin.placed.copy_(torch.where(accept, choice, rin.placed))
    rin.win.copy_(torch.where(accept, win_now, rin.win))
    prog[fout] = int(bool(accept.any()))


def auction_final_ref(rin: RoundInputs
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """End-state (feasible_count, fit_rejects, ipa_rejects), [B] each, over
    statics + fit (+ the InterPodAffinity mask in soft mode)."""
    gid = rin.gid.long()
    ok = rin.static_ok[gid]
    fit = _fit(rin)
    i32 = torch.int32
    if not rin.soft:
        return ((ok & fit).sum(dim=1).to(i32), (ok & ~fit).sum(dim=1).to(i32),
                torch.zeros((rin.b,), dtype=i32, device=ok.device))
    ipa = rin.ipa_ok[gid]
    return ((ok & fit & ipa).sum(dim=1).to(i32),
            (ok & ~fit).sum(dim=1).to(i32),
            (ok & fit & ~ipa).sum(dim=1).to(i32))


# ---------------------------------------------------------------- kernels


_SOFT = ("ipa_ok", "ipa_live", "sp_r", "ign", "has_soft")
_EXPORT_PTRS = ("chosen_feat", "alt_row", "alt_score", "lmag_part",
                "lmag_cnt", "done", "lmag_out")


class _AuctionArgs(ctypes.Structure):
    _fields_ = [
        ("N", ctypes.c_int), ("B", ctypes.c_int), ("R", ctypes.c_int),
        ("G", ctypes.c_int),
        *[(name, ctypes.c_void_p) for name in (
            "free", "nom", "alloc2", "nzr", "req", "nzreq", "nominated_row",
            "uid", "gid", "static_ok", "taint_raw", "aff_raw", "img",
            "placed")],
        ("w_taint", ctypes.c_float), ("w_aff", ctypes.c_float),
        ("w_fit", ctypes.c_float), ("w_bal", ctypes.c_float),
        ("w_img", ctypes.c_float),
        ("fit_strategy", ctypes.c_int), ("shape_n", ctypes.c_int),
        ("shape_x", ctypes.c_void_p), ("shape_y", ctypes.c_void_p),
        ("seed", ctypes.c_uint),
        *[(name, ctypes.c_void_p) for name in (
            "prog_in", "prog_out", "choice", "win_now", "feas_count",
            "fit_rejects")],
        ("soft", ctypes.c_int), ("w_pts", ctypes.c_float),
        ("w_ipa", ctypes.c_float),
        *[(name, ctypes.c_void_p) for name in _SOFT + ("ipa_rejects",)],
        ("learned", KL.LearnedNet), ("w_learned", ctypes.c_float),
        ("ex_feats", ctypes.c_int), ("ex_alts", ctypes.c_int),
        *[(name, ctypes.c_void_p) for name in _EXPORT_PTRS],
    ]


class _CommitArgs(ctypes.Structure):
    _fields_ = [
        ("N", ctypes.c_int), ("B", ctypes.c_int), ("R", ctypes.c_int),
        ("multi_accept", ctypes.c_int), ("slice", ctypes.c_int),
        ("list_shared", ctypes.c_int),
        *[(name, ctypes.c_void_p) for name in (
            "choice", "win_now", "nom", "req", "nzreq", "nominated_row",
            "k_accept", "prog_in", "prog_out", "free", "nzr", "placed",
            "win", "scratch")],
    ]


def shape_args(fit_shape, dev) -> tuple:
    """(points, x pointer, y pointer) of a RequestedToCapacityRatio shape:
    the kernels read its points from these device arrays (any count)."""
    xs, ys = fit_shape
    n = xs.shape[0]
    for name, t in (("shape_x", xs), ("shape_y", ys)):
        KB.require(t, name, torch.float32, (n,), dev)
    return n, xs.data_ptr(), ys.data_ptr()


def _check_inputs(rin: RoundInputs) -> torch.device:
    dev = rin.free.device
    n, b, r = rin.n, rin.b, rin.req.shape[1]
    g = rin.static_ok.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
            ("free", rin.free, f32, (n, r)), ("nzr", rin.nzr, f32, (n, 2)),
            ("nom", rin.nom, f32, (n, r)), ("alloc2", rin.alloc2, f32, (n, 2)),
            ("req", rin.req, f32, (b, r)), ("nzreq", rin.nzreq, f32, (b, 2)),
            ("nominated_row", rin.nominated_row, i32, (b,)),
            ("uid", rin.uid, i32, (b,)), ("gid", rin.gid, i32, (b,)),
            ("static_ok", rin.static_ok, torch.bool, (g, n)),
            ("taint_raw", rin.taint_raw, f32, (g, n)),
            ("aff_raw", rin.aff_raw, f32, (g, n)),
            ("img", rin.img, f32, (g, n)),
            ("placed", rin.placed, i32, (b,)), ("win", rin.win, f32, (b,))):
        KB.require(t, name, dtype, shape, dev)
    if rin.k_accept is not None:
        KB.require(rin.k_accept, "k_accept", i32, (), dev)
    if rin.soft:
        for name, dtype, shape in (
                ("ipa_ok", torch.bool, (g, n)), ("ipa_live", f32, (g, n)),
                ("sp_r", f32, (g, n)), ("ign", torch.bool, (g, n)),
                ("has_soft", torch.bool, (g,))):
            KB.require(getattr(rin, name), name, dtype, shape, dev)
    if rin.learned is not None:
        KL.require_params(rin.learned, dev)
    return dev


def _auction_args(rin: RoundInputs, prog: torch.Tensor, k: int,
                  out: dict) -> _AuctionArgs:
    fin, fout = _flags(prog, k)
    a = _AuctionArgs()
    a.N, a.B, a.R = rin.n, rin.b, rin.req.shape[1]
    a.G = rin.static_ok.shape[0]
    for name in ("free", "nom", "alloc2", "nzr", "req", "nzreq",
                 "nominated_row", "uid", "gid", "static_ok", "taint_raw",
                 "aff_raw", "img", "placed"):
        setattr(a, name, getattr(rin, name).data_ptr())
    (a.w_taint, a.w_aff, a.w_fit, a.w_bal, a.w_img, a.w_pts, a.w_ipa) = (
        float(x) for x in rin.weights)
    if rin.soft:
        a.soft = 1
        for name in _SOFT:
            setattr(a, name, getattr(rin, name).data_ptr())
    a.fit_strategy = FIT_STRATEGIES[rin.fit_strategy]
    if rin.fit_strategy == "RequestedToCapacityRatio":
        a.shape_n, a.shape_x, a.shape_y = shape_args(rin.fit_shape,
                                                     rin.free.device)
    a.seed = int(rin.seed) & _MASK32
    a.learned = KL.net_of(rin.learned, MAX_P, K9_NARROW)
    # the wide path's global slabs: one a warp of the grid (at most
    # B + MAX_P warps), kept alive with the arguments
    a.k9_scratch = KL.scratch_for(a.learned, rin.b + MAX_P, rin.free.device)
    a.w_learned = float(rin.w_learned)
    a.prog_in = prog.data_ptr() + 4 * fin
    a.prog_out = prog.data_ptr() + 4 * fout
    for name, t in out.items():
        setattr(a, name, t.data_ptr())
    return a


def auction_score_argmax(rin: RoundInputs, prog: torch.Tensor, k: int,
                         out: Optional[tuple] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2a bids: the kernel for CUDA tensors, the twin for CPU tensors.
    ``out`` (bid_buffers) names the kernel's (choice, win_now) buffers, so
    that a prebuilt K2b launch reads the same ones every round."""
    dev = rin.free.device
    if dev.type == "cpu":
        return auction_score_argmax_ref(rin, prog, k)
    if dev.type != "cuda":
        raise ValueError(f"auction_score_argmax: unsupported device {dev}")
    return _bid_kernel(rin, prog, k, out=out)


def bid_buffers(rin: RoundInputs) -> tuple[torch.Tensor, torch.Tensor]:
    """(choice [B] i32, win_now [B] f32) for one launch's bid rounds."""
    dev = rin.free.device
    return (torch.empty((rin.b,), dtype=torch.int32, device=dev),
            torch.empty((rin.b,), dtype=torch.float32, device=dev))


def _bid_kernel(rin: RoundInputs, prog: torch.Tensor, k: int, lib=None,
                out=None):
    dev = _check_inputs(rin)
    KB.require(prog, "prog", torch.int32, (2,), dev)
    if out is None:
        choice, win_now = bid_buffers(rin)
    else:
        choice, win_now = out
        KB.require(choice, "choice", torch.int32, (rin.b,), dev)
        KB.require(win_now, "win_now", torch.float32, (rin.b,), dev)
    args = _auction_args(rin, prog, k, {"choice": choice,
                                        "win_now": win_now})
    # a measurement build (``lib``) bids the same and is not counted
    counted = lib is None
    lib = KB.library("auction_score_argmax") if lib is None else lib
    KB.check("auction_score_argmax", lib.auction_score_argmax_launch(
        ctypes.byref(args), 0, KB.stream_handle()))
    if counted:
        KB.LAUNCHES["auction_score_argmax"] += 1
        if rin.learned is not None:
            KB.LAUNCHES["learned_mlp"] += 1
    return choice, win_now


# the phases of csrc/auction_score_argmax.cu's profile build (BID_PROFILE)
BID_PROFILE_PHASES = ("pod selection", "staging", "tile waits",
                      "tile preparation", "tile bodies",
                      "end-of-tile barriers", "rest")


def bid_profile(rin: RoundInputs, prog: torch.Tensor, k: int) -> dict:
    """One bid round of these inputs through the profile build: {phase: SM
    clock cycles} of block 0's thread 0. A measurement; counted nowhere."""
    lib = KB.build_variant("auction_score_argmax", ("BID_PROFILE",))
    lib.auction_read_profile.argtypes = [ctypes.c_void_p]
    _bid_kernel(rin, prog, k, lib=lib)
    buf = (ctypes.c_ulonglong * 8)()
    KB.check("auction_score_argmax", lib.auction_read_profile(buf))
    return dict(zip(BID_PROFILE_PHASES, list(buf)))


SMEM_MAX = 232448          # dynamic shared memory a block (227 KB)
STAGES = 3                 # node tiles in flight


def _a16(x: int) -> int:
    return (x + 15) & ~15


def tile_bytes(tn: int, r: int) -> int:
    """csrc/auction_score_argmax.cu tile_layout(tn, R).bytes: one staged
    node tile's rows."""
    return (2 * _a16(tn * r * 4) + 2 * _a16(tn * 8) + 6 * _a16(tn * 4)
            + 3 * _a16(tn))


def block_bytes(lf: int, p: int, tn: int, r: int, n: int) -> int:
    """csrc/auction_score_argmax.cu block_layout(...).bytes: K9's region,
    the pods' request rows, indices and reductions, STAGES node tiles and
    the pods' feasibility bits."""
    return (lf * 4 + _a16(p * r * 4) + 64 * 4 + MAX_P * 8 * 4
            + STAGES * tile_bytes(tn, r) + _a16(p * ((n + 31) // 32) * 4))


def tiling_of(lf: int, r: int, n: int) -> Optional[tuple]:
    """csrc/auction_score_argmax.cu auction_tiling: (pods a block, tile
    nodes, bytes), the largest that fits SMEM_MAX, or None: the card's
    shared memory cannot hold one pod and one 32-node tile of these rows,
    and the launch is refused."""
    for p in (16, 8, 4, 2, 1):
        for tn in (256, 128, 64, 32):
            nb = block_bytes(lf, p, tn, r, n)
            if nb <= SMEM_MAX:
                return p, tn, nb
    return None


def bid_tiling(rin: RoundInputs, final_mode: bool = False) -> dict:
    """K2a's launch shape for these inputs on this card: pods a block (one
    warp each), nodes a staged tile and dynamic shared memory a block
    (csrc/auction_score_argmax.cu auction_tiling)."""
    lib = KB.library("auction_score_argmax")
    lf = 0 if final_mode else KL.smem_floats(
        KL.net_of(rin.learned, MAX_P, K9_NARROW), MAX_P)
    p, tn = ctypes.c_int(), ctypes.c_int()
    smem = lib.auction_tiling(lf, rin.req.shape[1], rin.n, ctypes.byref(p),
                              ctypes.byref(tn))
    return {"pods_per_block": p.value, "threads": 32 * p.value,
            "tile_nodes": tn.value, "smem_bytes": smem,
            "blocks": -(-rin.b // max(p.value, 1))}


def auction_final(rin: RoundInputs
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2a in final mode: end-state (feasible_count, fit_rejects,
    ipa_rejects)."""
    dev = rin.free.device
    if dev.type == "cpu":
        return auction_final_ref(rin)
    if dev.type != "cuda":
        raise ValueError(f"auction_final: unsupported device {dev}")
    return _final_kernel(rin)


def _final_kernel(rin: RoundInputs):
    dev = _check_inputs(rin)
    feas, rej, ipa_rej = (torch.empty((rin.b,), dtype=torch.int32,
                                      device=dev) for _ in range(3))
    dummy = torch.ones((2,), dtype=torch.int32, device=dev)
    args = _auction_args(rin, dummy, 0, {"feas_count": feas,
                                         "fit_rejects": rej,
                                         "ipa_rejects": ipa_rej})
    lib = KB.library("auction_score_argmax")
    KB.check("auction_score_argmax", lib.auction_score_argmax_launch(
        ctypes.byref(args), 1, KB.stream_handle()))
    KB.LAUNCHES["auction_score_argmax"] += 1
    return feas, rej, ipa_rej


# ---------------------------------------------------------------- export

# the top-K alternative export (the reference's models/pipeline.py ALT_K,
# ALT_NONE): K runner-up (node, total) pairs a pod; a slot whose score is
# below ALT_NONE / 2 has no candidate (row -1)
ALT_K = 4
ALT_NONE = -1e9


class ExportOut(NamedTuple):
    """The export tails of one launch (the reference's BatchResult
    learned_mag, chosen_feat, alt_row, alt_score)."""

    learned_mag: torch.Tensor   # [] f32, 0 without a learned scorer
    chosen_feat: torch.Tensor   # [B, 9] f32, zeros unless with_feats
    alt_row: torch.Tensor       # [B, ALT_K] i32, -1 unless with_alts
    alt_score: torch.Tensor     # [B, ALT_K] f32, ALT_NONE unless with_alts


def _sentinels(b: int, dev) -> ExportOut:
    return ExportOut(
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.zeros((b, LN.NUM_FEATURES), dtype=torch.float32, device=dev),
        torch.full((b, ALT_K), -1, dtype=torch.int32, device=dev),
        torch.full((b, ALT_K), ALT_NONE, dtype=torch.float32, device=dev))


_EMPTY: dict = {}


def empty_export(b: int, dev) -> ExportOut:
    """The export tails of a launch that computes none of them (zeros,
    row -1, ALT_NONE), made once a batch size and device and shared:
    read-only (a kernel writes into _sentinels' fresh buffers)."""
    key = (b, str(dev))
    if key not in _EMPTY:
        _EMPTY[key] = _sentinels(b, dev)
    return _EMPTY[key]


def halving_tree(x: torch.Tensor) -> torch.Tensor:
    """[..., 32] -> [...]: a warp's xor-shuffle sum as lane 0 ends it
    (x[i] + x[i + 16], then + 8, ...)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def lane_sum(v: torch.Tensor, slice_: Optional[int] = None
             ) -> torch.Tensor:
    """[..., N] -> [...]: the kernels' sum of a row over its node slices
    of ``slice_`` entries (a multiple of 32; None: the whole row is one
    slice): in each slice lane t adds entries t, t + 32, ... in order and
    the warp folds its lanes by the xor tree; then the slices' sums fold
    in order (csrc/auction_score_argmax.cu auction_export: a cluster's
    CTAs in rank order)."""
    n = v.shape[-1]
    s = -(-max(n, 1) // 32) * 32 if slice_ is None else slice_
    k = max(1, -(-n // s))
    pad = torch.zeros(v.shape[:-1] + (k * s - n,), dtype=v.dtype,
                      device=v.device)
    x = torch.cat([v, pad], dim=-1).reshape(v.shape[:-1] + (k, s // 32, 32))
    acc = x[..., 0, :]
    for i in range(1, s // 32):
        acc = acc + x[..., i, :]
    parts = halving_tree(acc)                                 # [..., k]
    out = parts[..., 0]
    for i in range(1, k):
        out = out + parts[..., i]
    return out


# K2a's export pass (csrc/auction_score_argmax.cu, its "export plan"
# block): pods a CTA by instantiation, the cluster's growth and the bytes
# budgets
EXP_P = 16
EXP_P_K9 = 8
EXP_CLUSTER_MAX = 8
EXP_SLICE_MIN = 128
EXP_SMEM_PAIR = 115712
EXP_XCH = 20


class ExportPlan(NamedTuple):
    """csrc/auction_score_argmax.cu ExportPlan: ``pods`` warps a CTA, a
    cluster of ``cluster`` CTAs splitting the node axis into slices of
    ``slice`` nodes, staged once (``resident``) or in tiles of ``tile``;
    ``smem`` dynamic shared bytes a CTA, ``ctas`` and ``threads``."""

    pods: int
    cluster: int
    slice: int
    tile: int
    resident: int
    smem: int
    ctas: int
    threads: int


class _ExportPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in ExportPlan._fields]


def slice_bytes(n: int, r: int, soft: bool) -> int:
    """csrc/auction_score_argmax.cu slice_layout(n, R, soft).bytes: one
    node buffer of n nodes."""
    b = 2 * _a16(n * r * 4) + 2 * _a16(n * 8) + 3 * _a16(n * 4) + _a16(n)
    return b + (2 * _a16(n * 4) + 2 * _a16(n) if soft else 0)


def export_bytes(lf: int, p: int, r: int, slice_: int, tile: int,
                 resident: bool, soft: bool) -> int:
    """csrc/auction_score_argmax.cu export_layout(...).bytes."""
    return (lf * 4 + _a16(p * r * 4) + _a16((p * EXP_XCH + 7) * 4)
            + (1 if resident else STAGES) * slice_bytes(tile, r, soft)
            + _a16(p * (slice_ // 32) * 4) + _a16(tile * 8)
            + _a16(33 * 2 * (ALT_K + 1) * 4) + 64 * 4)


def export_cluster(n: int) -> int:
    """CTAs a cluster of the export pass for N nodes."""
    cs = 1
    while cs < EXP_CLUSTER_MAX and 2 * cs * EXP_SLICE_MIN <= n:
        cs *= 2
    return cs


def export_slice(n: int) -> int:
    """Nodes a CTA of the export pass for N nodes (a multiple of 32): the
    slices whose lane sums the learned magnitude folds in order."""
    cs = export_cluster(n)
    return (-(-n // cs) + 31) // 32 * 32


def plan_export(lf: int, r: int, n: int, b: int, soft: bool, k9: bool
                ) -> Optional[ExportPlan]:
    """csrc/auction_score_argmax.cu export_plan_of: the most pods a CTA
    with its slice resident, else in the largest tile (256 down to 32),
    first within two CTAs an SM, then within one; None (the launch is
    refused) when not one pod and one 32-node tile fit SMEM_MAX."""
    cs, sl = export_cluster(n), export_slice(n)
    for budget in (EXP_SMEM_PAIR, SMEM_MAX):
        p = EXP_P_K9 if k9 else EXP_P
        while p >= 1:
            for t in (sl, 256, 128, 64, 32):
                if t != sl and t >= sl:
                    continue
                nb = export_bytes(lf, p, r, sl, t, t == sl, soft)
                if nb <= budget:
                    return ExportPlan(p, cs, sl, t, int(t == sl), nb,
                                      -(-b // p) * cs, 32 * p)
            p >>= 1
    return None


def export_plan(rin: RoundInputs) -> Optional[ExportPlan]:
    """K2a's export-pass launch for these inputs (plan_export)."""
    net = KL.net_of(rin.learned, MAX_P, K9_NARROW)
    return plan_export(KL.smem_floats(net, MAX_P), rin.req.shape[1], rin.n,
                       rin.b, rin.soft, rin.learned is not None)


def top_alts(masked: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """([..., ALT_K] rows i32, [..., ALT_K] scores) of ``masked`` [..., N]
    (ALT_NONE where no candidate): jax.lax.top_k's order, value
    descending and the lower row first on ties; a slot below ALT_NONE / 2
    has row -1."""
    n = masked.shape[-1]
    k = min(ALT_K, n)
    sc, rows = torch.sort(masked, dim=-1, descending=True, stable=True)
    sc, rows = sc[..., :k], rows[..., :k].to(torch.int32)
    rows = torch.where(sc > ALT_NONE * 0.5, rows,
                       torch.full_like(rows, -1))
    if k < ALT_K:
        pad = masked.shape[:-1] + (ALT_K - k,)
        sc = torch.cat([sc, torch.full(pad, ALT_NONE, dtype=sc.dtype,
                                       device=sc.device)], dim=-1)
        rows = torch.cat([rows, torch.full(pad, -1, dtype=rows.dtype,
                                           device=rows.device)], dim=-1)
    return rows, sc


def auction_export_ref(rin: RoundInputs, with_feats: bool, with_alts: bool
                       ) -> ExportOut:
    """The end-state export pass (pipeline.py :740-844 of the reference,
    ``pod_eval``): every pod scored against the end state over its
    candidates, ``static_ok & fit(end) [& ipa_ok] | chosen``, with its own
    committed non-zero request taken off its chosen node first and, in
    soft mode, the live soft scores K4 left at the final placement. The
    learned magnitude is summed in the kernel's order (lane_sum a pod over
    the export pass's node slices, export_slice; lane_sum over the
    pods)."""
    b, n = rin.b, rin.n
    dev = rin.free.device
    out = empty_export(b, dev)
    if rin.learned is None and not with_feats and not with_alts:
        return out
    gid = rin.gid.long()
    ok_end = rin.static_ok[gid] & _fit(rin)
    if rin.soft:
        ok_end = ok_end & rin.ipa_ok[gid]
    rows_c = rin.placed.clamp(0, n - 1).long()
    chosen = ((torch.arange(n, device=dev)[None, :] == rows_c[:, None])
              & (rin.placed >= 0)[:, None])
    cand = ok_end | chosen
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nzr_i = torch.where(chosen[..., None], rin.nzr[None] - rin.nzreq[:, None],
                        rin.nzr[None])                         # [B, N, 2]
    a = rin.alloc2[None]
    req = nzr_i + rin.nzreq[:, None, :]
    frac = torch.clamp(torch.where(
        a > 0, req / torch.clamp(a, min=torch.tensor(1e-9, device=dev)),
        torch.ones((), dtype=torch.float32, device=dev)), 0.0, 1.0)
    fit = SC.fit_score_from_fractions(frac, rin.fit_strategy, rin.fit_shape)
    bal = SC.balanced_allocation_from_fractions(frac)
    taint = SC.normalize_inverse(rin.taint_raw[gid], cand)
    aff = SC.normalize_max(rin.aff_raw[gid], cand)
    img = rin.img[gid]
    w = rin.weights
    total = (w[0] * taint + w[1] * aff + w[2] * fit + w[3] * bal
             + w[4] * img)
    sp_n = ipa_n = torch.zeros_like(total)
    if rin.soft:
        ipa_n = SC.normalize_maxmin(rin.ipa_live[gid], cand)
        sp_n = torch.where(rin.has_soft[gid][:, None],
                           SC.normalize_spread(rin.sp_r[gid], cand,
                                               rin.ign[gid]), zero)
        total = total + w[5] * sp_n + w[6] * ipa_n
    lmag = out.learned_mag
    if rin.learned is not None:
        lt = rin.w_learned * LN.learned_term(
            rin.learned.layers, frac, fit, bal, taint, aff, img,
            sp_n if rin.soft else None, ipa_n if rin.soft else None)
        total = total + lt
        part = lane_sum(torch.where(ok_end, torch.abs(lt), zero),
                        export_slice(n))                      # [B]
        cnt = int(ok_end.sum())
        lmag = lane_sum(part) / torch.tensor(float(max(cnt, 1)),
                                             dtype=torch.float32, device=dev)
    feat = out.chosen_feat
    if with_feats:
        idx = rows_c[:, None]
        pick = lambda x: torch.gather(x, 1, idx)[:, 0]  # noqa: E731
        fr = torch.gather(frac, 1, idx[..., None].expand(-1, -1, 2))[:, 0]
        feat = LN.feature_rows(fr, pick(fit), pick(bal), pick(taint),
                               pick(aff), pick(img), pick(sp_n),
                               pick(ipa_n))
    alt_row, alt_score = out.alt_row, out.alt_score
    if with_alts:
        alt_row, alt_score = top_alts(torch.where(
            cand, total, torch.tensor(ALT_NONE, device=dev)))
    return ExportOut(lmag, feat, alt_row, alt_score)


def auction_export(rin: RoundInputs, with_feats: bool, with_alts: bool
                   ) -> ExportOut:
    """K2a's export pass after the last round: the kernel for CUDA
    tensors, the twin for CPU tensors. Launched (and counted) only when a
    learned scorer, the feature or the alternative export is on."""
    dev = rin.free.device
    if dev.type == "cpu":
        return auction_export_ref(rin, with_feats, with_alts)
    if dev.type != "cuda":
        raise ValueError(f"auction_export: unsupported device {dev}")
    if rin.learned is None and not with_feats and not with_alts:
        return empty_export(rin.b, dev)
    return _export_kernel(rin, with_feats, with_alts)


def _export_kernel(rin: RoundInputs, with_feats: bool, with_alts: bool,
                   lib=None) -> ExportOut:
    dev = _check_inputs(rin)
    plan = export_plan(rin)
    if plan is None:
        raise ValueError(
            f"auction_export: R={rin.req.shape[1]} resource columns at "
            f"N={rin.n} nodes exceed a CTA's shared memory ({SMEM_MAX} "
            "bytes for one pod and one 32-node tile, three in flight)")
    b = rin.b
    out = _sentinels(b, dev)
    bufs = {"chosen_feat": out.chosen_feat, "alt_row": out.alt_row,
            "alt_score": out.alt_score}
    if rin.learned is not None:
        bufs.update(
            lmag_part=torch.empty((b,), dtype=torch.float32, device=dev),
            lmag_cnt=torch.empty((b,), dtype=torch.int32, device=dev),
            done=torch.zeros((1,), dtype=torch.int32, device=dev),
            lmag_out=torch.zeros((1,), dtype=torch.float32, device=dev))
    dummy = torch.ones((2,), dtype=torch.int32, device=dev)
    args = _auction_args(rin, dummy, 0, bufs)
    # the wide path's global slabs: one a warp of this grid
    args.k9_scratch = KL.scratch_for(args.learned, plan.ctas * plan.pods,
                                     dev)
    args.ex_feats, args.ex_alts = int(with_feats), int(with_alts)
    # a measurement build (``lib``) computes the same and is not counted
    counted = lib is None
    lib = KB.library("auction_score_argmax") if lib is None else lib
    KB.check("auction_score_argmax",
             lib.auction_export_launch(ctypes.byref(args),
                                       KB.stream_handle()))
    if counted:
        KB.LAUNCHES["auction_export"] += 1
        if rin.learned is not None:
            KB.LAUNCHES["learned_mlp"] += 1
    lmag = (bufs["lmag_out"][0] if rin.learned is not None
            else out.learned_mag)
    return ExportOut(lmag, out.chosen_feat, out.alt_row, out.alt_score)


def export_clusters(rin: RoundInputs) -> int:
    """How many of the export pass's clusters the card holds at once for
    these inputs (cudaOccupancyMaxActiveClusters); a measurement."""
    _check_inputs(rin)
    dummy = torch.ones((2,), dtype=torch.int32, device=rin.free.device)
    args = _auction_args(rin, dummy, 0, {})
    n = KB.library("auction_score_argmax").auction_export_clusters(
        ctypes.byref(args))
    if n < 0:
        KB.check("auction_score_argmax", -n)
    return n


# the phases of the export pass's profile build (EXPORT_PROFILE)
EXPORT_PROFILE_PHASES = ("set-up and staging", "pass 1",
                         "normalizers' merge", "pass 2", "pods' merge",
                         "batch fold")


def export_profile(rin: RoundInputs, with_feats: bool, with_alts: bool
                   ) -> dict:
    """One export pass of these inputs through the profile build: {phase:
    SM clock cycles} of CTA 0's thread 0. A measurement; counted
    nowhere."""
    lib = KB.build_variant("auction_score_argmax", ("EXPORT_PROFILE",))
    lib.auction_read_export_profile.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 8)()
    KB.check("auction_score_argmax", lib.auction_read_export_profile(buf))
    before = list(buf)
    _export_kernel(rin, with_feats, with_alts, lib=lib)
    KB.check("auction_score_argmax", lib.auction_read_export_profile(buf))
    return {k: buf[i] - before[i]
            for i, k in enumerate(EXPORT_PROFILE_PHASES)}


# K2b's launch shape (csrc/auction_accept_commit.cu)
COMMIT_THREADS = 256
COMMIT_WARPS = COMMIT_THREADS // 32
H100_SMS = 132
# bytes of a block's K-accept list (B entries) kept in shared memory;
# past it the lists live in a global scratch of B entries a block
LIST_SMEM_MAX = 128 * 1024
# the most nodes a block: its (warp, node) counts stay within 74 KB
MAX_SLICE = 2048


@dataclass(frozen=True)
class CommitPlan:
    """K2b's layout: ``slice`` nodes a block over ``blocks`` blocks; in
    K-accept mode each block's (warp, node) counts and node offsets, and
    its list of B entries in shared memory (``list_shared``) or in a
    global scratch of ``scratch_ints``; ``smem_bytes`` dynamic shared
    memory a block."""

    slice: int
    blocks: int
    multi: bool
    list_shared: bool
    smem_bytes: int
    scratch_ints: int


def plan_commit(n: int, b: int, multi: bool, sms: int = H100_SMS
                ) -> CommitPlan:
    """Node slices (a multiple of 8 nodes, at most MAX_SLICE) that give
    the grid about one block an SM, and where a K-accept block keeps its
    list."""
    per = -(-max(n, 1) // max(sms, 1))
    per = min(-(-per // 8) * 8, MAX_SLICE)
    blocks = -(-max(n, 1) // per)
    if not multi:
        return CommitPlan(per, blocks, False, True, per * 4, 0)
    front = (COMMIT_WARPS * per + per + 1) * 4
    shared = b * 4 <= LIST_SMEM_MAX
    return CommitPlan(per, blocks, True, shared,
                      front + (b * 4 if shared else 0),
                      0 if shared else blocks * max(b, 1))


class CommitLaunch:
    """K2b's launch for one auction launch, checked and built once: one C
    argument struct for each round parity (the flags ``prog[k % 2]`` in,
    ``prog[(k + 1) % 2]`` out); ``run(k)`` launches round k. The bids it
    reads are the ``choice``/``win_now`` buffers it was built with."""

    def __init__(self, rin: RoundInputs, choice: torch.Tensor,
                 win_now: torch.Tensor, prog: torch.Tensor):
        dev = _check_inputs(rin)
        KB.require(choice, "choice", torch.int32, (rin.b,), dev)
        KB.require(win_now, "win_now", torch.float32, (rin.b,), dev)
        KB.require(prog, "prog", torch.int32, (2,), dev)
        multi = rin.k_accept is not None
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.plan = plan = plan_commit(rin.n, rin.b, multi, sms)
        self.rin, self.prog = rin, prog
        self.choice, self.win_now = choice, win_now
        self.scratch = (torch.empty((plan.scratch_ints,), dtype=torch.int32,
                                    device=dev)
                        if plan.scratch_ints else None)
        self.args = []
        for parity in (0, 1):
            a = _CommitArgs()
            a.N, a.B, a.R = rin.n, rin.b, rin.req.shape[1]
            a.multi_accept = int(multi)
            a.slice, a.list_shared = plan.slice, int(plan.list_shared)
            for name in ("nom", "req", "nzreq", "nominated_row", "free",
                         "nzr", "placed", "win"):
                setattr(a, name, getattr(rin, name).data_ptr())
            a.choice, a.win_now = choice.data_ptr(), win_now.data_ptr()
            a.k_accept = rin.k_accept.data_ptr() if multi else None
            a.prog_in = prog.data_ptr() + 4 * parity
            a.prog_out = prog.data_ptr() + 4 * (1 - parity)
            a.scratch = (self.scratch.data_ptr() if self.scratch is not None
                         else None)
            self.args.append(a)
        self.fn = KB.library("auction_accept_commit") \
            .auction_accept_commit_launch
        self.fn.argtypes = [ctypes.POINTER(_CommitArgs), ctypes.c_int,
                            ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        self.stream = KB.stream_handle()
        self.global_list = plan.multi and not plan.list_shared

    def serves(self, rin, choice, win_now, prog) -> bool:
        return (self.rin is rin and self.choice is choice
                and self.win_now is win_now and self.prog is prog)

    def run(self, k: int) -> None:
        KB.check("auction_accept_commit", self.fn(
            ctypes.byref(self.args[k % 2]), self.plan.smem_bytes,
            self.stream))
        KB.LAUNCHES["auction_accept_commit"] += 1
        if self.global_list:
            KB.LAUNCHES["auction_accept_commit_global"] += 1


def commit_launch(rin: RoundInputs, choice: torch.Tensor,
                  win_now: torch.Tensor, prog: torch.Tensor
                  ) -> Optional[CommitLaunch]:
    """The prebuilt K2b launch of one auction launch on the card; None for
    CPU tensors (the twin needs none)."""
    if rin.free.device.type != "cuda":
        return None
    return CommitLaunch(rin, choice, win_now, prog)


def auction_accept_commit(rin: RoundInputs, choice: torch.Tensor,
                          win_now: torch.Tensor, prog: torch.Tensor,
                          k: int, launch: Optional[CommitLaunch] = None
                          ) -> None:
    """K2b acceptance + commit: the kernel for CUDA tensors (``launch``,
    built once for the auction launch, or built here), the twin for CPU
    tensors."""
    dev = rin.free.device
    if dev.type == "cpu":
        return auction_accept_commit_ref(rin, choice, win_now, prog, k)
    if dev.type != "cuda":
        raise ValueError(f"auction_accept_commit: unsupported device {dev}")
    if launch is None or not launch.serves(rin, choice, win_now, prog):
        launch = CommitLaunch(rin, choice, win_now, prog)
    launch.run(k)
