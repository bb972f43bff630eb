"""K11 the chain patch: the wrapper around csrc/chain_patch.cu and its
twin (``ops/chain.py`` ``patch_chain_ref``).

``chain_patch`` takes the usage chain (free [N, R], nzr [N, 2], f32; row-
strided views allowed) and the reference's patch lists, ``(row, free_row
[R], nzr_row [2])`` tuples for the sets and for the adds. It packs them
once into the [S + A, R + 3] buffer K11 reads, checks the contract on
that buffer's index column (the lists hold at most the Scheduler's
CHAIN_PATCH_MAX rows, so the check is cheap), and returns the patched
chain as new tensors. This is the one place that routes: CUDA tensors
upload the buffer once and launch K11, CPU tensors run the twin on views
of it. A build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.ops.chain import patch_chain_ref


class _ChainArgs(ctypes.Structure):
    _fields_ = [("N", ctypes.c_int), ("R", ctypes.c_int),
                ("S", ctypes.c_int), ("A", ctypes.c_int),
                ("free_stride", ctypes.c_int), ("nzr_stride", ctypes.c_int),
                ("free", ctypes.c_void_p), ("nzr", ctypes.c_void_p),
                ("patches", ctypes.c_void_p),
                ("out_free", ctypes.c_void_p), ("out_nzr", ctypes.c_void_p)]


def pack_patches(n: int, r: int, set_rows, add_rows
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """The patch lists as K11 reads them: one [S + A, R + 3] f32 row a
    patch (its node row's index as int bits, its R free values, its 2
    nzr values), sets first; with the index column as int64 and S.
    Raises ValueError unless the set indices are unique, the add indices
    are unique, no index is both, and every index is in [0, n)."""
    rows = list(set_rows)
    s = len(rows)
    rows += add_rows
    idx = np.fromiter((row for row, _f, _z in rows), np.int64, len(rows))
    for what, part in (("set", idx[:s]), ("add", idx[s:])):
        if part.size and (part.min() < 0 or part.max() >= n):
            raise ValueError(f"chain_patch: a {what} index is outside "
                             f"[0, {n})")
        if np.unique(part).size != part.size:
            raise ValueError(f"chain_patch: duplicate {what} index")
    if np.intersect1d(idx[:s], idx[s:]).size:
        raise ValueError("chain_patch: an index is both a set and an add")
    buf = np.empty((len(rows), r + 3), np.float32)
    buf[:, 0].view(np.int32)[:] = idx
    if rows:
        buf[:, 1:1 + r] = np.asarray([f for _i, f, _z in rows],
                                     np.float32).reshape(-1, r)
        buf[:, 1 + r:] = np.asarray([z for _i, _f, z in rows],
                                    np.float32).reshape(-1, 2)
    return buf, idx, s


def chain_patch(free: torch.Tensor, nzr: torch.Tensor, set_rows=(),
                add_rows=()) -> tuple[torch.Tensor, torch.Tensor]:
    """K11: new (free, nzr), ``set_rows``' rows replaced, then
    ``add_rows``' rows added; the inputs are never written."""
    n, r = free.shape
    buf, idx, s = pack_patches(n, r, set_rows, add_rows)
    a = idx.size - s
    dev = free.device
    if dev.type == "cpu":
        t, i = torch.from_numpy(buf), torch.from_numpy(idx)
        return patch_chain_ref(free, nzr, i[:s], t[:s, 1:1 + r],
                               t[:s, 1 + r:], i[s:], t[s:, 1:1 + r],
                               t[s:, 1 + r:])
    if dev.type != "cuda":
        raise ValueError(f"chain_patch: unsupported device {dev}")
    for name, x, width in (("free", free, r), ("nzr", nzr, 2)):
        if x.dtype != torch.float32 or x.stride(1) != 1 \
                or x.shape != (n, width) or x.device != dev:
            raise ValueError(f"chain_patch: {name} must be f32 [{n}, "
                             f"{width}] on {dev} with contiguous rows")
    # pageable source: the copy returns once the buffer is staged and
    # waits for no launch already queued on the stream
    patches = torch.from_numpy(buf).to(dev, non_blocking=True)
    out_free = torch.empty((n, r), dtype=torch.float32, device=dev)
    out_nzr = torch.empty((n, 2), dtype=torch.float32, device=dev)
    args = _ChainArgs(N=n, R=r, S=s, A=a,
                      free_stride=int(free.stride(0)),
                      nzr_stride=int(nzr.stride(0)),
                      free=free.data_ptr(), nzr=nzr.data_ptr(),
                      patches=patches.data_ptr() if s + a else None,
                      out_free=out_free.data_ptr(),
                      out_nzr=out_nzr.data_ptr())
    launch = KB.library("chain_patch").chain_patch_launch
    launch.argtypes = [ctypes.POINTER(_ChainArgs), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    KB.check("chain_patch", launch(ctypes.byref(args), KB.stream_handle()))
    KB.LAUNCHES["chain_patch"] += 1
    return out_free, out_nzr
