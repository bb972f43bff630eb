"""K8 DRA allocation feasibility: the wrapper around csrc/dra_feasible.cu
and its twin.

``fuse_phase1`` runs after phase 1 (K1) on the per-pod static mask: it
computes each pod's claim feasibility on every node, counts the nodes
that pass the static filters and fail only on claims (``dra_reject``),
and returns the mask ANDed with the DRA verdicts and, when given, the
host Filter verdicts. The twin is ``ops/dra.py:fuse_phase1``. The wrapper
launches the kernel for CUDA tensors and runs the twin only for CPU
tensors; a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.ops import dra as OD

fuse_phase1_ref = OD.fuse_phase1

# csrc/dra_feasible.cu limits: request slots a pod, devices a node, pods
MAX_Q = 64
MAX_D = 64 * 64
MAX_B = 65535

_DIMS = ("B", "N", "D", "Q")
_POINTERS = ("dev_valid", "dev_selbits", "dev_in_use", "req_mask",
             "req_count", "req_all", "pinned", "active", "static_ok",
             "host_ok", "out_ok", "dra_ok", "dra_reject")


class _DraArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in _DIMS]
                + [(name, ctypes.c_void_p) for name in _POINTERS])


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
    if not (1 <= q_cap <= MAX_Q and 1 <= d_cap <= MAX_D and 1 <= b <= MAX_B):
        raise ValueError(f"dra fuse_phase1: Q={q_cap} (<= {MAX_Q}), "
                         f"D={d_cap} (<= {MAX_D}), B={b} (<= {MAX_B})")
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
    args = _DraArgs(B=b, N=n, D=d_cap, Q=q_cap)
    for name, (t, dtype, shape) in table.items():
        KB.require(t, name, dtype, shape, dev)
        setattr(args, name, t.data_ptr())
    launch = KB.library("dra_feasible").dra_feasible_launch
    launch.argtypes = [ctypes.POINTER(_DraArgs), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    KB.check("dra_feasible", launch(ctypes.byref(args), KB.stream_handle()))
    KB.LAUNCHES["dra_feasible"] += 1
    out = (table["out_ok"][0], table["dra_reject"][0])
    if want_dra_ok:
        return out + (table["dra_ok"][0],)
    return out
