"""K12 the row scatter: the wrapper around csrc/row_scatter.cu, its twin
(``ops/scatter.py`` ``scatter_rows_ref``), and the fence of the pinned
host buffers the kernel reads.

``scatter_rows`` takes up to MAX_BUFS jobs, each a device-resident
buffer, the host buffer its rows come from and the dirty row indices,
and writes ``dst[idx] = src[idx]`` for every job, in place.
This is the one place that routes: CUDA buffers launch K12 once for all
jobs, reading ``src`` and the indices straight from pinned host memory;
CPU buffers run the twin. A build or launch failure raises. The indices
are checked on the host, where the caller already holds them: a
duplicate or an out-of-range index is a ValueError.

A launch reads pinned memory after the call returns, so two hazards
follow, and both are handled here:

- the host must not rewrite a source row before the card has read it:
  the owner of a pinned buffer records a ``HostFence`` after queueing a
  read and waits on it before its next write;
- the pinned index buffer (and a source the owner drops) must not be
  freed, and so reused by torch's pinned-memory cache, while a queued
  launch still reads it: each launch keeps them alive until its event
  has passed.
"""

from __future__ import annotations

import collections
import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.ops.scatter import scatter_rows_ref

MAX_BUFS = 4


class _ScatterArgs(ctypes.Structure):
    _fields_ = [("nbuf", ctypes.c_int),
                ("width", ctypes.c_int * MAX_BUFS),
                ("rows", ctypes.c_int * MAX_BUFS),
                ("block0", ctypes.c_int * (MAX_BUFS + 1)),
                ("dst_stride", ctypes.c_long * MAX_BUFS),
                ("src_stride", ctypes.c_long * MAX_BUFS),
                ("dst", ctypes.c_void_p * MAX_BUFS),
                ("src", ctypes.c_void_p * MAX_BUFS),
                ("idx", ctypes.c_void_p * MAX_BUFS)]


class Rows(NamedTuple):
    """One job of a scatter: ``dst[idx] = src[idx]``."""

    dst: torch.Tensor   # [M, ...] f32 or i32, rows contiguous
    src: torch.Tensor   # host rows of the same dtype and row shape
    idx: np.ndarray     # [k] int64, unique, below M


# K12 launches whose pinned inputs the card may still read: (event,
# tensors kept alive), oldest first
_INFLIGHT: collections.deque = collections.deque()


def pin(arr: np.ndarray) -> torch.Tensor:
    """A pinned host copy of ``arr`` (raises without a card)."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    out.copy_(src)
    return out


def upload(host: torch.Tensor, device) -> torch.Tensor:
    """A new device copy of a host tensor: an asynchronous copy from a
    pinned one (its owner records a HostFence after it), a clone on the
    CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return host.clone()
    if not host.is_pinned():
        raise ValueError("upload: the host tensor is not pinned")
    out = torch.empty(host.shape, dtype=host.dtype, device=device)
    return out.copy_(host, non_blocking=True)


class HostFence:
    """Orders the host's writes to a pinned buffer after the card's
    queued reads of it. ``record`` after queueing a read (a K12 launch, an
    upload); ``wait`` before writing. A wait that had to block is counted
    in ``stats`` (``<prefix>_waits``, ``<prefix>_wait_us``, host µs)."""

    def __init__(self, stats: dict, prefix: str = "fence"):
        self.stats = stats
        self.keys = (prefix + "_waits", prefix + "_wait_us")
        stats.setdefault(self.keys[0], 0)
        stats.setdefault(self.keys[1], 0.0)
        self.event = None

    def record(self) -> None:
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> None:
        ev = self.event
        if ev is None:
            return
        self.event = None
        if ev.query():
            return
        t0 = time.perf_counter()
        ev.synchronize()
        self.stats[self.keys[0]] += 1
        self.stats[self.keys[1]] += (time.perf_counter() - t0) * 1e6


def _row_words(t: torch.Tensor, name: str) -> tuple[int, int]:
    """(words a row, words between rows) of a [M, ...] tensor whose rows
    are contiguous."""
    if t.dtype not in (torch.float32, torch.int32) or t.dim() < 1:
        raise ValueError(f"row_scatter: {name} must be f32 or i32 rows, "
                         f"got {t.dtype} {tuple(t.shape)}")
    width = 1
    for size, step in reversed(list(zip(t.shape[1:], t.stride()[1:]))):
        if size != 1 and step != width:
            raise ValueError(f"row_scatter: {name}'s rows are not "
                             f"contiguous")
        width *= size
    return width, int(t.stride(0)) if t.shape[0] > 1 else width


def check_rows(idx: np.ndarray, m: int) -> None:
    """The contract on a job's indices: unique and in [0, m)."""
    if idx.ndim != 1 or idx.size == 0:
        raise ValueError("row_scatter: indices must be a non-empty 1-D list")
    if idx.min() < 0 or idx.max() >= m:
        raise ValueError(f"row_scatter: an index is outside [0, {m})")
    # the callers' lists are sorted: strictly increasing is unique
    if not (idx[1:] > idx[:-1]).all() and np.unique(idx).size != idx.size:
        raise ValueError("row_scatter: duplicate index")


def scatter_rows(jobs) -> None:
    """K12: every job's rows written into its device buffer, in place, in
    one launch (module docstring)."""
    jobs = [Rows(*j) for j in jobs]
    if not jobs:
        return
    dev = jobs[0].dst.device
    for k, (dst, src, idx) in enumerate(jobs):
        check_rows(idx, dst.shape[0])
        if dst.device != dev or src.dtype != dst.dtype \
                or src.shape != dst.shape:
            raise ValueError(f"row_scatter: job {k}'s buffers differ in "
                             f"device, dtype or shape")
    if dev.type == "cpu":
        for dst, src, idx in jobs:
            i = torch.from_numpy(idx)
            scatter_rows_ref(dst, i, src[i])
        return
    if dev.type != "cuda":
        raise ValueError(f"row_scatter: unsupported device {dev}")
    if len(jobs) > MAX_BUFS:
        raise ValueError(f"row_scatter: {len(jobs)} jobs, at most "
                         f"{MAX_BUFS} a launch")
    # launches whose event has passed release their pinned inputs first,
    # so the pinned-memory cache hands the index buffer back
    while _INFLIGHT and _INFLIGHT[0][0].query():
        _INFLIGHT.popleft()
    sizes = [j.idx.size for j in jobs]
    idx_all = torch.empty((sum(sizes),), dtype=torch.int32, pin_memory=True)
    np.concatenate([j.idx for j in jobs], out=idx_all.numpy(),
                   casting="unsafe")
    args = _ScatterArgs(nbuf=len(jobs))
    at = 0
    for k, (dst, src, _idx) in enumerate(jobs):
        if not src.is_pinned():
            raise ValueError(f"row_scatter: job {k}'s source is not "
                             f"pinned host memory")
        args.width[k], args.dst_stride[k] = _row_words(dst, "dst")
        _, args.src_stride[k] = _row_words(src, "src")
        args.rows[k] = sizes[k]
        args.dst[k] = dst.data_ptr()
        args.src[k] = src.data_ptr()
        args.idx[k] = idx_all.data_ptr() + 4 * at
        at += sizes[k]
    launch = KB.library("row_scatter").row_scatter_launch
    launch.argtypes = [ctypes.POINTER(_ScatterArgs), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    KB.check("row_scatter", launch(ctypes.byref(args), KB.stream_handle()))
    KB.LAUNCHES["row_scatter"] += 1
    ev = torch.cuda.Event()
    ev.record()
    _INFLIGHT.append((ev, (idx_all, *(j.src for j in jobs))))
