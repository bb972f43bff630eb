"""K8 DRA allocation feasibility: the wrapper around csrc/dra_feasible.cu
and its twin.

``fuse_phase1`` runs after phase 1 (K1) on the per-pod static mask: it
computes each pod's claim feasibility on every node, counts the nodes
that pass the static filters and fail only on claims (``dra_reject``),
and returns the mask ANDed with the DRA verdicts and, when given, the
host Filter verdicts. The twin is ``ops/dra.py:fuse_phase1``. The wrapper
launches the kernel for CUDA tensors and runs the twin only for CPU
tensors; a build or launch failure raises. Any B, N and D launch; the
request slots a pod are bounded only by a block's shared memory
(``max_requests()``, far past the plugin's MAX_REQS of 32).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.ops import dra as OD

fuse_phase1_ref = OD.fuse_phase1

# csrc/dra_feasible.cu: threads a block, device words a staged chunk,
# selector bits; a block's shared memory (232,448 bytes)
THREADS = 128
WARPS = THREADS // 32
SW = 8
SELBITS = OD.SELBIT_WORDS * 32
SMEM_LIMIT = 232448

_DIMS = ("B", "N", "D", "Q", "nt", "pods", "tiles")
_POINTERS = ("dev_valid", "dev_selbits", "dev_in_use", "req_mask",
             "req_count", "req_all", "pinned", "active", "static_ok",
             "host_ok", "out_ok", "dra_ok", "dra_reject")


class _DraArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in _DIMS]
                + [(name, ctypes.c_void_p) for name in _POINTERS])


class DraPlan(NamedTuple):
    nt: int       # nodes a block, one after the other
    pods: int     # pods a block (THREADS x pods a thread)
    tiles: int    # node tiles
    blocks: int
    smem: int


def dra_smem(q: int, pods: int, nt: int) -> int:
    """A block's shared bytes: the warps' mask unions, the staged free and
    ranked selector-bit words of a chunk, the request state, the bit
    ranks, the tile's bytes."""
    return 4 * (WARPS * OD.SELBIT_WORDS + SW + SELBITS * SW + q * pods) \
        + SELBITS + pods * nt


def max_requests() -> int:
    """The request slots a pod past which no block fits: one node and
    THREADS pods a block (the stated limit; any D and any B launch)."""
    fixed = dra_smem(0, THREADS, 1)
    return (SMEM_LIMIT - fixed) // (4 * THREADS)


def plan_dra(b: int, n: int, d: int, q: int, sms: int = 132) -> DraPlan:
    """K8's launch shape: up to 8 pods a thread and 32 nodes a block,
    fewer pods and then fewer nodes until the launch has about four
    blocks an SM, the pods kept within a quarter of the shared memory.
    Raises ValueError only past ``max_requests()`` request slots."""
    if min(b, n, d, q) < 1:
        raise ValueError(f"dra fuse_phase1: B={b}, N={n}, D={d}, Q={q}")
    if q > max_requests():
        raise ValueError(f"dra fuse_phase1: Q={q} request slots a pod; a "
                         f"block's {SMEM_LIMIT} B of shared memory holds "
                         f"{max_requests()}")
    ppt = min(8, -(-b // THREADS))
    while ppt > 1 and dra_smem(q, ppt * THREADS, 32) > SMEM_LIMIT // 4:
        ppt //= 2
    nt = 32

    def blocks(ppt_, nt_):
        return -(-n // nt_) * -(-b // (ppt_ * THREADS))

    while ppt > 1 and blocks(ppt, nt) < 4 * sms:
        ppt //= 2
    while nt > 1 and blocks(ppt, nt) < 4 * sms:
        nt //= 2
    pods = ppt * THREADS
    return DraPlan(nt, pods, -(-n // nt), blocks(ppt, nt),
                   dra_smem(q, pods, nt))


_PLANS: dict = {}


def _plan_of(b: int, n: int, d: int, q: int, dev) -> DraPlan:
    key = (b, n, d, q, dev)
    got = _PLANS.get(key)
    if got is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        got = _PLANS[key] = plan_dra(b, n, d, q, sms)
    return got


def _entry():
    fn = KB.library("dra_feasible").dra_feasible_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_DraArgs), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fuse_phase1(static_ok: torch.Tensor, dra: OD.DraBatch, host_ok=None,
                want_dra_ok: bool = False):
    """(static_ok & dra_ok [& host_ok] [B, N] bool, dra_reject [B] i32),
    plus dra_ok [B, N] when ``want_dra_ok`` (the card check compares
    it). ``static_ok`` is phase 1's per-pod mask."""
    dev = static_ok.device
    if dev.type == "cpu":
        out, rej = fuse_phase1_ref(static_ok, dra, host_ok)
        if want_dra_ok:
            return out, rej, OD.batch_feasible(dra)
        return out, rej
    if dev.type != "cuda":
        raise ValueError(f"dra fuse_phase1: unsupported device {dev}")
    b, n = static_ok.shape
    n_cap, d_cap = dra.dev_valid.shape
    q_cap = dra.req_mask.shape[1]
    if n_cap != n:
        raise ValueError(f"dra fuse_phase1: {n_cap} inventory rows for a "
                         f"{n}-node mask")
    plan = _plan_of(b, n, d_cap, q_cap, dev)
    u8, i32 = torch.bool, torch.int32
    w = OD.SELBIT_WORDS
    table = {
        "dev_valid": (dra.dev_valid, u8, (n, d_cap)),
        "dev_selbits": (dra.dev_selbits, i32, (n, d_cap, w)),
        "dev_in_use": (dra.dev_in_use, u8, (n, d_cap)),
        "req_mask": (dra.req_mask, i32, (b, q_cap, w)),
        "req_count": (dra.req_count, i32, (b, q_cap)),
        "req_all": (dra.req_all, u8, (b, q_cap)),
        "pinned": (dra.pinned, i32, (b,)),
        "active": (dra.active, u8, (b,)),
        "static_ok": (static_ok.contiguous(), u8, (b, n)),
        "out_ok": (torch.empty((b, n), dtype=u8, device=dev), u8, (b, n)),
        "dra_reject": (torch.zeros((b,), dtype=i32, device=dev), i32, (b,)),
    }
    if host_ok is not None:
        table["host_ok"] = (host_ok.contiguous(), u8, (b, n))
    if want_dra_ok:
        table["dra_ok"] = (torch.empty((b, n), dtype=u8, device=dev), u8,
                           (b, n))
    args = _DraArgs(B=b, N=n, D=d_cap, Q=q_cap, nt=plan.nt, pods=plan.pods,
                    tiles=plan.tiles)
    for name, (t, dtype, shape) in table.items():
        KB.require(t, name, dtype, shape, dev)
        setattr(args, name, t.data_ptr())
    KB.check("dra_feasible", _entry()(ctypes.byref(args), plan.smem,
                                      KB.stream_handle()))
    KB.LAUNCHES["dra_feasible"] += 1
    out = (table["out_ok"][0], table["dra_reject"][0])
    if want_dra_ok:
        return out + (table["dra_ok"][0],)
    return out
