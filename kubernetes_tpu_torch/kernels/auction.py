"""K2 auction round kernels: wrappers around csrc/auction_score_argmax.cu
(K2a, bids + the end-state counts) and csrc/auction_accept_commit.cu
(K2b, per-node acceptance + commit), with their plain-torch twins.

A round reads the progress flag the previous round wrote (``prog[k % 2]``)
and writes its own (``prog[(k + 1) % 2]``); a round whose input flag is 0
does nothing but pass the 0 on, so the host can launch several rounds
back to back and read one flag at the end. The twins (``*_ref``) are
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
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.ops import common as C
from kubernetes_tpu_torch.ops import learned as LN
from kubernetes_tpu_torch.ops import scores as SC

FIT_STRATEGIES = {"LeastAllocated": 0, "MostAllocated": 1,
                  "RequestedToCapacityRatio": 2}
MAX_SHAPE = 16
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
        ("shape_x", ctypes.c_float * MAX_SHAPE),
        ("shape_y", ctypes.c_float * MAX_SHAPE),
        ("seed", ctypes.c_uint),
        *[(name, ctypes.c_void_p) for name in (
            "prog_in", "prog_out", "choice", "win_now", "feas_count",
            "fit_rejects")],
        ("soft", ctypes.c_int), ("w_pts", ctypes.c_float),
        ("w_ipa", ctypes.c_float),
        *[(name, ctypes.c_void_p) for name in _SOFT + ("ipa_rejects",)],
        ("learned", KL.LearnedNet), ("w_learned", ctypes.c_float),
    ]


class _CommitArgs(ctypes.Structure):
    _fields_ = [
        ("N", ctypes.c_int), ("B", ctypes.c_int), ("R", ctypes.c_int),
        ("multi_accept", ctypes.c_int),
        *[(name, ctypes.c_void_p) for name in (
            "choice", "win_now", "nom", "req", "nzreq", "nominated_row",
            "k_accept", "prog_in", "prog_out", "free", "nzr", "placed",
            "win")],
    ]


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
        xs = [float(v) for v in rin.fit_shape[0]]
        ys = [float(v) for v in rin.fit_shape[1]]
        if len(xs) > MAX_SHAPE:
            raise ValueError(f"fit shape has {len(xs)} points, max "
                             f"{MAX_SHAPE}")
        a.shape_n = len(xs)
        for i, (x, y) in enumerate(zip(xs, ys)):
            a.shape_x[i] = x
            a.shape_y[i] = y
    a.seed = int(rin.seed) & _MASK32
    a.learned = KL.net_of(rin.learned)
    a.w_learned = float(rin.w_learned)
    a.prog_in = prog.data_ptr() + 4 * fin
    a.prog_out = prog.data_ptr() + 4 * fout
    for name, t in out.items():
        setattr(a, name, t.data_ptr())
    return a


def auction_score_argmax(rin: RoundInputs, prog: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2a bids: the kernel for CUDA tensors, the twin for CPU tensors."""
    dev = rin.free.device
    if dev.type == "cpu":
        return auction_score_argmax_ref(rin, prog, k)
    if dev.type != "cuda":
        raise ValueError(f"auction_score_argmax: unsupported device {dev}")
    return _bid_kernel(rin, prog, k)


def _bid_kernel(rin: RoundInputs, prog: torch.Tensor, k: int, lib=None):
    dev = _check_inputs(rin)
    KB.require(prog, "prog", torch.int32, (2,), dev)
    choice = torch.empty((rin.b,), dtype=torch.int32, device=dev)
    win_now = torch.empty((rin.b,), dtype=torch.float32, device=dev)
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


def bid_tiling(rin: RoundInputs, final_mode: bool = False) -> dict:
    """K2a's launch shape for these inputs on this card: pods a block (one
    warp each), nodes a staged tile and dynamic shared memory a block
    (csrc/auction_score_argmax.cu auction_tiling)."""
    lib = KB.library("auction_score_argmax")
    lf = 0 if final_mode else KL.smem_floats(KL.net_of(rin.learned))
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


def auction_accept_commit(rin: RoundInputs, choice: torch.Tensor,
                          win_now: torch.Tensor, prog: torch.Tensor,
                          k: int) -> None:
    """K2b acceptance + commit: the kernel for CUDA tensors, the twin for
    CPU tensors."""
    dev = rin.free.device
    if dev.type == "cpu":
        return auction_accept_commit_ref(rin, choice, win_now, prog, k)
    if dev.type != "cuda":
        raise ValueError(f"auction_accept_commit: unsupported device {dev}")
    _commit_kernel(rin, choice, win_now, prog, k)


def _commit_kernel(rin: RoundInputs, choice: torch.Tensor,
                   win_now: torch.Tensor, prog: torch.Tensor, k: int) -> None:
    dev = _check_inputs(rin)
    KB.require(choice, "choice", torch.int32, (rin.b,), dev)
    KB.require(win_now, "win_now", torch.float32, (rin.b,), dev)
    KB.require(prog, "prog", torch.int32, (2,), dev)
    fin, fout = _flags(prog, k)
    a = _CommitArgs()
    a.N, a.B, a.R = rin.n, rin.b, rin.req.shape[1]
    a.multi_accept = int(rin.k_accept is not None)
    for name in ("nom", "req", "nzreq", "nominated_row", "free", "nzr",
                 "placed", "win"):
        setattr(a, name, getattr(rin, name).data_ptr())
    a.choice = choice.data_ptr()
    a.win_now = win_now.data_ptr()
    a.k_accept = (rin.k_accept.data_ptr() if rin.k_accept is not None
                  else None)
    a.prog_in = prog.data_ptr() + 4 * fin
    a.prog_out = prog.data_ptr() + 4 * fout
    lib = KB.library("auction_accept_commit")
    KB.check("auction_accept_commit", lib.auction_accept_commit_launch(
        ctypes.byref(a), KB.stream_handle()))
    KB.LAUNCHES["auction_accept_commit"] += 1
