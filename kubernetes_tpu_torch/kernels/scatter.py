"""K12 the row scatter: the wrapper around csrc/row_scatter.cu, its twin
(``ops/scatter.py`` ``scatter_rows_ref``), and the fence of the pinned
host buffers the kernel reads.

``scatter_rows`` takes up to MAX_BUFS jobs, each a device-resident
buffer, the host buffer its rows come from and the dirty row indices,
and writes ``dst[idx] = src[idx]`` for every job, in place.
This is the one place that routes: CUDA buffers launch K12 once for all
jobs, reading ``src`` straight from pinned host memory; CPU buffers run
the twin. A build or launch failure raises. The indices are checked on
the host, where the caller already holds them: a duplicate or an
out-of-range index is a ValueError.

The launch entry plans the work on the host, in C
(csrc/row_scatter.cu ``row_scatter_plan``; ``plan_chunks`` is its plain
statement): each job's sorted rows become runs of consecutive rows, a
run of packed rows one span of words, and each span chunks of at most
CHUNK_WORDS words, as (source address, destination address, words) rows
written into a pinned descriptor slot that the kernel reads. The slots
form a ring: a slot is written again only once the event recorded after
its launch has passed. The entry is bound with its argument types once;
each pinned source tensor's mapped device address is resolved once
while that tensor lives (the same value under unified addressing); a
source that is not pinned is a ValueError, before any launch. A job's rows that are not strictly
increasing are sorted and checked here, then planned again.

A launch reads pinned memory after the call returns, so two hazards
follow, and both are handled here:

- the host must not rewrite a source row before the card has read it:
  the owner of a pinned buffer records a ``HostFence`` after queueing a
  read and waits on it before its next write;
- the pinned descriptor slot (and a source the owner drops) must not be
  reused or freed, and so handed out again by torch's pinned-memory
  cache, while a queued launch still reads it: each slot keeps its
  launch's sources alive until it is taken again, which waits for its
  event.
"""

from __future__ import annotations

import ctypes
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.ops.scatter import scatter_rows_ref

MAX_BUFS = 4
# words a chunk: with a source off 16-byte alignment, a warp's 32 lanes x
# 8 16-byte loads (csrc/row_scatter.cu)
CHUNK_WORDS = 1020
# descriptor rows a new slot holds at least; slots at most (a burst of
# launches past it waits for the oldest)
SLOT_ROWS = 4096
RING_MAX = 64


class _ScatterJob(ctypes.Structure):
    _fields_ = [("idx", ctypes.c_void_p),
                ("rows", ctypes.c_long),
                ("width", ctypes.c_long),
                ("src_stride", ctypes.c_long),
                ("dst_stride", ctypes.c_long),
                ("src", ctypes.c_long),
                ("dst", ctypes.c_long),
                ("m", ctypes.c_long)]


class _ScatterArgs(ctypes.Structure):
    _fields_ = [("nchunks", ctypes.c_int),
                ("chunks", ctypes.c_void_p)]


# row_scatter_plan's codes for a broken contract (csrc/row_scatter.cu)
ERR_ORDER, ERR_RANGE = -1, -2


class Rows(NamedTuple):
    """One job of a scatter: ``dst[idx] = src[idx]``."""

    dst: torch.Tensor   # [M, ...] f32 or i32, rows contiguous
    src: torch.Tensor   # host rows of the same dtype and row shape
    idx: np.ndarray     # [k] int64, unique, below M


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
    in ``stats`` (``<prefix>_waits``, ``<prefix>_wait_us``, host µs). The
    fence records one event of its own again and again: a new event's
    first record also creates it, which costs more host time."""

    def __init__(self, stats: dict, prefix: str = "fence"):
        self.stats = stats
        self.keys = (prefix + "_waits", prefix + "_wait_us")
        stats.setdefault(self.keys[0], 0)
        stats.setdefault(self.keys[1], 0.0)
        self.event = None
        self._own = None

    def record(self) -> None:
        if self._own is None:
            self._own = torch.cuda.Event()
        self._own.record()
        self.event = self._own

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


def check_rows(idx: np.ndarray, m: int) -> np.ndarray:
    """The contract on a job's indices: unique and in [0, m). Returns
    them sorted (the callers' lists already are)."""
    if idx.ndim != 1 or idx.size == 0:
        raise ValueError("row_scatter: indices must be a non-empty 1-D list")
    if not (idx[1:] > idx[:-1]).all():
        idx = np.sort(idx)
        if (idx[1:] == idx[:-1]).any():
            raise ValueError("row_scatter: duplicate index")
    if idx[0] < 0 or idx[-1] >= m:
        raise ValueError(f"row_scatter: an index is outside [0, {m})")
    return idx


def runs_of(idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(first row, rows) of each maximal run of consecutive rows of a
    sorted, unique index list."""
    cut = np.flatnonzero(np.diff(idx) != 1) + 1
    starts = np.concatenate(([0], cut))
    return idx[starts], np.diff(np.concatenate((starts, [idx.size])))


def plan_chunks(jobs) -> np.ndarray:
    """K12's work list, the plain statement of the launch entry's planner
    (csrc/row_scatter.cu row_scatter_plan): ``jobs`` are (sorted unique
    rows, words a row, source words between rows, destination words
    between rows, source address, destination address); the result is
    int64 [chunks, 3] of (source byte address, destination byte address,
    words). A maximal run of consecutive rows is one span where both
    strides are the width, else each row is; each span is cut into
    chunks of CHUNK_WORDS words from its start, the last one shorter."""
    parts = []
    for idx, width, ss, ds, sb, db in jobs:
        if ss == width and ds == width:
            first, rows = runs_of(idx)
            words = rows * width
        else:
            first, words = idx, np.full(idx.size, width, np.int64)
        parts.append((sb + 4 * ss * first, db + 4 * ds * first, words))
    src, dst, words = (np.concatenate(x) for x in zip(*parts))
    k = -(-words // CHUNK_WORDS)
    span = np.repeat(np.arange(k.size), k)
    at = (np.arange(span.size) - np.repeat(np.cumsum(k) - k, k)) \
        * CHUNK_WORDS
    return np.stack([src[span] + 4 * at, dst[span] + 4 * at,
                     np.minimum(words[span] - at, CHUNK_WORDS)], axis=1)


class _Slot:
    """A pinned descriptor list, its host and mapped addresses, the event
    the launch entry records after the launch that read it (its handle;
    torch records it once, which makes it) and that launch's sources."""

    __slots__ = ("host", "rows", "ptr", "addr", "event", "handle", "keep")

    def __init__(self, n: int):
        self.host = torch.empty((max(n, SLOT_ROWS), 3), dtype=torch.int64,
                                pin_memory=True)
        self.rows = self.host.shape[0]
        self.ptr = self.host.data_ptr()
        self.addr = _mapped(self.host)
        self.event = torch.cuda.Event()
        self.event.record()
        self.handle = self.event.cuda_event
        self.keep = None

    def free(self) -> bool:
        return self.keep is None or self.event.query()


# descriptor slots in launch order from _NEXT[0], the oldest
_RING: list = []
_NEXT = [0]
# id of a pinned host tensor -> (a weak reference to it, its data
# address, the mapped device address)
_MAPPED: dict = {}
# the bound launch entry
_ENTRY: list = []


def _device_pointer(p: int) -> int:
    """The mapped device address of pinned host address ``p``."""
    fn = KB.library("row_scatter").row_scatter_mapped
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    fn.restype = ctypes.c_int
    out = ctypes.c_void_p()
    KB.check("row_scatter", fn(p, ctypes.byref(out)))
    return out.value


def _mapped(t: torch.Tensor) -> int:
    """The mapped device address of a pinned tensor's data, resolved once
    for as long as the tensor lives and keeps its data: a tensor that
    holds its storage keeps it pinned, and the entry goes when the tensor
    does. A tensor that is not pinned raises ValueError."""
    p = t.data_ptr()
    hit = _MAPPED.get(id(t))
    if hit is not None and hit[0]() is t and hit[1] == p:
        return hit[2]
    if not t.is_pinned():
        raise ValueError("row_scatter: a source is not pinned host memory")
    key = id(t)

    def drop(ref, key=key):
        if _MAPPED.get(key, (None,))[0] is ref:
            del _MAPPED[key]

    d = _device_pointer(p)
    _MAPPED[key] = (weakref.ref(t, drop), p, d)
    return d


def _entry():
    if not _ENTRY:
        fn = KB.library("row_scatter").row_scatter_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _slot(n: int) -> _Slot:
    """The ring's oldest slot where its launch has passed (made anew
    where it holds fewer than n rows); else a new slot, the ring's newest,
    or, with RING_MAX slots in flight, the oldest once its event passes.
    Launches on one stream finish in order: where the oldest slot is
    busy, every other one is."""
    i = _NEXT[0]
    slot = _RING[i] if i < len(_RING) else None
    if slot is not None and not slot.free():
        if len(_RING) < RING_MAX:
            slot = None
        else:
            slot.event.synchronize()
    if slot is None:
        slot = _Slot(n)
        _RING.insert(i, slot)
    elif slot.rows < n:
        slot = _RING[i] = _Slot(n)
    _NEXT[0] = (i + 1) % len(_RING)
    return slot


def in_flight() -> int:
    """K12 launches whose pinned inputs the card may still read."""
    return sum(not slot.free() for slot in _RING)


# the launch's jobs, one _ScatterJob a row (eight int64 members)
_JOBS = np.zeros((MAX_BUFS, len(_ScatterJob._fields_)), np.int64)
_JOBS_PTR = _JOBS.ctypes.data


def _buffers(jobs) -> None:
    """The contract on each job's buffers: one device, one dtype, one
    shape (raises ValueError)."""
    dev = jobs[0][0].device
    for k, (dst, src, _) in enumerate(jobs):
        if dst.device != dev or src.dtype != dst.dtype \
                or src.shape != dst.shape:
            raise ValueError(f"row_scatter: job {k}'s buffers differ in "
                             f"device, dtype or shape")


def _words(dst: torch.Tensor, src: torch.Tensor) -> tuple[int, int, int]:
    """(words a row, source and destination words between rows) of a job
    whose buffers passed ``_buffers``; rows must be contiguous."""
    if dst.dim() and dst.shape[0] and dst.is_contiguous() \
            and src.is_contiguous() \
            and dst.dtype in (torch.float32, torch.int32):
        width = dst.numel() // dst.shape[0]
        return width, width, width
    width, ds = _row_words(dst, "dst")
    return width, _row_words(src, "src")[1], ds


def scatter_rows(jobs) -> None:
    """K12: every job's rows written into its device buffer, in place, in
    one launch (module docstring). ``jobs`` are ``Rows`` or (dst, src,
    idx) tuples."""
    if not jobs:
        return
    dev = jobs[0][0].device
    if dev.type != "cuda":
        rows = [check_rows(idx, dst.shape[0]) for dst, _, idx in jobs]
        _buffers(jobs)
        if dev.type != "cpu":
            raise ValueError(f"row_scatter: unsupported device {dev}")
        for (dst, src, _), idx in zip(jobs, rows):
            i = torch.from_numpy(idx)
            scatter_rows_ref(dst, i, src[i])
        return
    if len(jobs) > MAX_BUFS:
        raise ValueError(f"row_scatter: {len(jobs)} jobs, at most "
                         f"{MAX_BUFS} a launch")
    _buffers(jobs)
    idxs = []
    cap = 0
    for k, (dst, src, idx) in enumerate(jobs):
        if idx.ndim != 1 or idx.size == 0:
            raise ValueError("row_scatter: indices must be a non-empty 1-D "
                             "list")
        idx = np.ascontiguousarray(idx, np.int64)
        idxs.append(idx)
        width, ss, ds = _words(dst, src)
        _JOBS[k] = (idx.ctypes.data, idx.size, width, ss, ds, _mapped(src),
                    dst.data_ptr(), dst.shape[0])
        cap += idx.size * -(-width // CHUNK_WORDS)
    # at most rows x chunks a row: a run never needs more
    slot = _slot(cap)
    launch = _entry()
    stream = KB.stream_handle(dev.index)
    code = launch(_JOBS_PTR, len(jobs), slot.ptr, slot.addr, cap, stream,
                  slot.handle)
    if code in (ERR_ORDER, ERR_RANGE):
        # unsorted rows are sorted (a duplicate or an out-of-range row
        # raises ValueError here), then planned again
        for k, (dst, _, idx) in enumerate(jobs):
            idxs[k] = check_rows(np.ascontiguousarray(idx, np.int64),
                                 dst.shape[0])
            _JOBS[k, 0] = idxs[k].ctypes.data
        code = launch(_JOBS_PTR, len(jobs), slot.ptr, slot.addr, cap,
                      stream, slot.handle)
    KB.check("row_scatter", code)
    KB.LAUNCHES["row_scatter"] += 1
    slot.keep = tuple(src for _, src, _ in jobs)
