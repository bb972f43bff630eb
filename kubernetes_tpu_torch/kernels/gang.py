"""K7 gang admission: wrappers around csrc/gang_pack.cu (K7a) and
csrc/gang_capacity.cu (K7b), and their twins.

- ``pack_gangs`` (K7a): the fused gang packer. On the card: K1 on the G
  representative rows (the static filter mask), then one launch of the
  packer kernel, one thread-block cluster that walks the gangs in order,
  each block keeping its node slice's carried rows in shared memory
  (``plan_pack`` lays them out), and updates copies of the carried
  free/nzr. A launch that leaves some array in global memory counts
  under ``LAUNCHES["gang_pack_global"]``.
- ``gang_capacity`` (K7b): the host-fallback PreFilter's capacity bound,
  one reduction over a [N, R] free matrix (a view of the mirror's
  device-resident blob is read in place) to a device scalar that the
  caller pulls with its cycle's other verdicts. The request's host row
  rides in the launch's argument block (``cap_plan`` prepares one a
  layout); past CAP_ROWS rows the CTAs fold exact integer partials.

The twins are ``ops/gang.py`` (``pack_gangs``, ``pack_core``,
``capacity``). Each wrapper launches its kernel for CUDA tensors and runs
the twin only for CPU tensors; a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.kernels import unpack as KU
from kubernetes_tpu_torch.ops import gang as OG

pack_gangs_ref = OG.pack_gangs
pack_core_ref = OG.pack_core
capacity_ref = OG.capacity

HIST_BINS = OG.KEY_STRIDE

# ---------------------------------------------------------------- K7a

# csrc/gang_pack.cu's layout constants
SMEM_MAX = 232448          # dynamic shared memory a block can use (227 KB)
MAX_THREADS = 512
MAX_CLUSTER = 16
MIN_CLUSTER = 8
CLUSTERS = (16, 8)         # the non-portable 16-block cluster, else 8
FIXED_BYTES = (HIST_BINS // MIN_CLUSTER) * 8 + 2 * MAX_CLUSTER * 8 \
    + 32 * 8 + 64
# the arrays plan_pack places, in priority order (csrc/gang_pack.cu PO_*)
PLACED = ("domain", "capn", "dom", "free", "nzr", "nom")


def _a16(x: int) -> int:
    return (x + 15) & ~15


def domain_bytes(d_cap: int) -> int:
    """Bytes of a block's domain tables (csrc/gang_pack.cu dom_layout):
    partial sums [D] i64, sorted sums [P2] i64 and ids [P2] i32 (P2 the
    power of two at or above D), ranks [D] i32, two gangs' used flags
    [2, D] i32."""
    p2 = 1
    while p2 < d_cap:
        p2 *= 2
    return (_a16(d_cap * 8) + _a16(p2 * 8) + _a16(p2 * 4) + _a16(d_cap * 4)
            + _a16(2 * d_cap * 4))


@dataclass(frozen=True)
class PackPlan:
    """One K7a launch's cluster shape and shared-memory layout."""

    cluster: int               # blocks of the cluster
    threads: int               # threads a block
    per: int                   # nodes a block (a multiple of 32)
    smem_bytes: int            # dynamic shared memory a block
    off: tuple                 # byte offset of each PLACED array, -1: global

    @property
    def global_arrays(self) -> tuple:
        return tuple(n for n, o in zip(PLACED, self.off) if o < 0)


def plan_pack(n: int, r: int, d_cap: int, cluster: int) -> PackPlan:
    """The layout of a launch over ``n`` nodes of ``r`` columns and
    ``d_cap`` packing domains on a cluster of ``cluster`` blocks: the
    fixed front, then each PLACED array, in order, where it still fits
    under SMEM_MAX bytes (a node-slice array holds ``per`` rows)."""
    per = -(-n // cluster)
    per = -(-per // 32) * 32
    threads = min(MAX_THREADS, max(128, per))
    sizes = {"domain": domain_bytes(d_cap), "capn": per * 4,
             "dom": per * 4, "free": per * r * 4, "nzr": per * 8,
             "nom": per * r * 4}
    used, off = FIXED_BYTES, []
    for name in PLACED:
        size = _a16(sizes[name])
        if used + size <= SMEM_MAX:
            off.append(used)
            used += size
        else:
            off.append(-1)
    return PackPlan(cluster, threads, per, used, tuple(off))


_PLANS: dict = {}


def _launch_plan(lib, n: int, r: int, d_cap: int) -> PackPlan:
    """The 16-block cluster where the card holds one, else 8; raises when
    it holds neither."""
    key = (n, r, d_cap)
    plan = _PLANS.get(key)
    if plan is None:
        for cluster in CLUSTERS:
            plan = plan_pack(n, r, d_cap, cluster)
            got = lib.gang_pack_max_clusters(plan.cluster, plan.threads,
                                             plan.smem_bytes)
            if got < 0:
                KB.check("gang_pack", -got)
            if got > 0:
                break
        else:
            raise RuntimeError(
                f"gang_pack: the card holds no cluster of {CLUSTERS} "
                f"blocks of {plan.threads} threads with {plan.smem_bytes} "
                f"bytes of shared memory")
        _PLANS[key] = plan
    return plan


_PACK_DIMS = ("G", "N", "R", "d_cap", "tk", "fit_on", "dom_stride",
              "cluster", "threads", "per", "smem_bytes", "fixed_bytes")
_PACK_POINTERS = ("free", "nzr", "nom", "static_ok", "topo", "req", "nzreq",
                  "need", "own_nom", "ok", "alloc", "cap", "spans", "guard",
                  "capn", "dom", "dscratch")


class _PackArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in _PACK_DIMS]
                + [("off", ctypes.c_int * len(PLACED))]
                + [(name, ctypes.c_void_p) for name in _PACK_POINTERS])


def pack_core(free0: torch.Tensor, nzr0: torch.Tensor, nom: torch.Tensor,
              static_ok: torch.Tensor, topo_dom: torch.Tensor, tk: int,
              req: torch.Tensor, nzreq: torch.Tensor, need: torch.Tensor,
              own_nom: torch.Tensor | None, d_cap: int, fit_on: bool,
              lib=None, fresh: bool = False) -> OG.GangPackResult:
    """K7a after K1: one launch over the phase-1 mask ``static_ok``
    [G, N]. ``topo_dom`` is the cluster's [N, TK] topology table (read in
    place, column ``tk``); free0/nzr0 are copied, and the copies carry
    the gangs' commits (with ``fresh``, a seed from extract_state, they
    carry them themselves). The twin for CPU tensors. A measurement
    build (``lib``) packs the same and is not counted."""
    dev = free0.device
    if dev.type == "cpu":
        return pack_core_ref(free0, nzr0, nom, static_ok,
                             OG.pack_domain(topo_dom, tk, d_cap), req,
                             nzreq, need, own_nom, d_cap, fit_on)
    if dev.type != "cuda":
        raise ValueError(f"pack_gangs: unsupported device {dev}")
    g, n = static_ok.shape
    r = free0.shape[1]
    if d_cap < 1:
        raise ValueError(f"pack_gangs: d_cap {d_cap} < 1")
    if topo_dom.stride(1) != 1:
        raise ValueError("pack_gangs: topo_dom rows must be contiguous")
    counted = lib is None
    lib = KB.library("gang_pack") if lib is None else lib
    plan = _launch_plan(lib, n, r, int(d_cap))
    placed = dict(zip(PLACED, plan.off))
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    col = max(int(tk), 0)
    topo = topo_dom[:, col]
    table = {
        "free": (free0 if fresh
                 else free0.clone(memory_format=torch.contiguous_format),
                 f32, (n, r)),
        "nzr": (nzr0 if fresh
                else nzr0.clone(memory_format=torch.contiguous_format),
                f32, (n, 2)),
        "nom": (nom.contiguous(), f32, (n, r)),
        "static_ok": (static_ok.contiguous(), u8, (g, n)),
        "req": (req.contiguous(), f32, (g, r)),
        "nzreq": (nzreq.contiguous(), f32, (g, 2)),
        "need": (need.to(i32).contiguous(), i32, (g,)),
        "ok": (torch.empty((g,), dtype=u8, device=dev), u8, (g,)),
        "alloc": (torch.empty((g, n), dtype=i32, device=dev), i32, (g, n)),
        "cap": (torch.empty((g,), dtype=i32, device=dev), i32, (g,)),
        "spans": (torch.empty((g,), dtype=i32, device=dev), i32, (g,)),
        "guard": (torch.zeros((), dtype=i32, device=dev), i32, ()),
    }
    # what the plan leaves in global memory
    for name in ("capn", "dom"):
        if placed[name] < 0:
            table[name] = (torch.empty((n,), dtype=i32, device=dev), i32,
                           (n,))
    if placed["domain"] < 0:
        nb = plan.cluster * domain_bytes(int(d_cap))
        table["dscratch"] = (torch.empty((nb,), dtype=torch.uint8,
                                         device=dev), torch.uint8, (nb,))
    if own_nom is not None:
        table["own_nom"] = (own_nom.to(i32).contiguous(), i32, (g, n))
    args = _PackArgs(G=g, N=n, R=r, d_cap=int(d_cap), tk=int(tk),
                     fit_on=int(bool(fit_on)),
                     dom_stride=int(topo_dom.stride(0)),
                     cluster=plan.cluster, threads=plan.threads,
                     per=plan.per, smem_bytes=plan.smem_bytes,
                     fixed_bytes=FIXED_BYTES)
    for i, o in enumerate(plan.off):
        args.off[i] = o
    for name, (t, dtype, shape) in table.items():
        KB.require(t, name, dtype, shape, dev)
        setattr(args, name, t.data_ptr())
    if topo.device != dev or topo.dtype != i32:
        raise ValueError("pack_gangs: topo_dom must be i32 on the device")
    args.topo = topo.data_ptr()
    launch = lib.gang_pack_launch
    launch.argtypes = [ctypes.POINTER(_PackArgs), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    KB.check("gang_pack", launch(ctypes.byref(args), KB.stream_handle()))
    if counted:
        KB.LAUNCHES["gang_pack"] += 1
        if plan.global_arrays:
            KB.LAUNCHES["gang_pack_global"] += 1
    t = {name: tt for name, (tt, _, _) in table.items()}
    return OG.GangPackResult(ok=t["ok"], alloc=t["alloc"], cap=t["cap"],
                             spans=t["spans"], free=t["free"], nzr=t["nzr"],
                             guard=t["guard"])


def pack_plan(args) -> PackPlan:
    """The plan a K7a launch of these pack_core arguments takes on this
    card."""
    free0, static_ok, d_cap = args[0], args[3], args[10]
    return _launch_plan(KB.library("gang_pack"), static_ok.shape[1],
                        free0.shape[1], int(d_cap))


# the steps of csrc/gang_pack.cu's profile build (PACK_PROFILE), by slot
PACK_PROFILE_STEPS = ("staging", "capacity + domain partials", "barrier A",
                      "spans", "domain fold", "sort", "walk",
                      "histogram adds", "barrier B", "bin totals",
                      "barrier C", "crossing", "threshold totals",
                      "barrier E", "take + commit", "write-back + guard")


def pack_profile(*args, **kw) -> dict:
    """One K7a launch of these pack_core arguments through the profile
    build: {step: SM clock cycles summed over the launch's gangs}. A
    measurement; counted nowhere."""
    lib = KB.build_variant("gang_pack", ("PACK_PROFILE",))
    lib.gang_read_profile.argtypes = [ctypes.c_void_p]
    pack_core(*args, **kw, lib=lib)
    buf = (ctypes.c_ulonglong * len(PACK_PROFILE_STEPS))()
    KB.check("gang_pack", lib.gang_read_profile(buf))
    return dict(zip(PACK_PROFILE_STEPS, list(buf)))


def pack_gangs(cblobs, gblobs, wk: dict, caps, need, tk: int,
               d_cap: int = 8, enabled_filters=None, active=None,
               pfields=None, ptmpl=None, state=None,
               own_nom=None, split=None, clock=time.perf_counter
               ) -> OG.GangPackResult:
    """K7 on the card (K1 on the representative rows, then K7a), the twin
    ``ops/gang.py:pack_gangs`` for CPU tensors. Arguments as the twin's;
    ``own_nom`` None means no gang has a nominated member. ``split`` (a
    dict) adds the host seconds on ``clock`` of K1's inputs (the
    representative rows, the fields the packer reads) under "inputs", of
    K1's wrapper under "k1", of the uploads of ``need`` and ``own_nom``
    under "uploads" and of K7a's wrapper under "k7a" (on the CPU the
    whole twin counts under "k7a")."""
    dev = cblobs.node_f32.device
    if dev.type == "cpu":
        t0 = clock() if split is not None else 0.0
        out = pack_gangs_ref(cblobs, gblobs, wk, caps, need, tk, d_cap,
                             enabled_filters, active, pfields, ptmpl,
                             state, own_nom)
        if split is not None:
            split["k7a"] += clock() - t0
        return out
    t0 = clock() if split is not None else 0.0
    k1 = split["k1"] if split is not None else 0.0
    (static_ok, free0, nzr0, nom, req, nzreq, fit_on,
     topo_dom) = OG.pack_inputs(cblobs, gblobs, wk, caps, enabled_filters,
                                active, pfields, ptmpl, state, split,
                                clock)
    t1 = clock() if split is not None else 0.0
    need_t = torch.as_tensor(need, dtype=torch.int32).to(dev)
    onom = (None if own_nom is None
            else torch.as_tensor(own_nom, dtype=torch.int32).to(dev))
    t2 = clock() if split is not None else 0.0
    out = pack_core(free0, nzr0, nom, static_ok, topo_dom, tk, req, nzreq,
                    need_t, onom, d_cap, fit_on,
                    fresh=isinstance(state, KU.Seed))
    if split is not None:
        split["inputs"] += t1 - t0 - (split["k1"] - k1)
        split["uploads"] += t2 - t1
        split["k7a"] += clock() - t2
    return out


# ---------------------------------------------------------------- K7b

# csrc/gang_capacity.cu: threads a CTA (one row each) and the widest
# request its argument block carries by value
CAP_THREADS = 512
CAP_ROWS = CAP_THREADS
CAP_R_MAX = 128


class _CapArgs(ctypes.Structure):
    _fields_ = [("N", ctypes.c_int), ("R", ctypes.c_int),
                ("free_stride", ctypes.c_int), ("ctas", ctypes.c_int),
                ("free", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("partials", ctypes.c_void_p),
                ("req", ctypes.c_float * CAP_R_MAX)]


_REQ_OFF = _CapArgs.req.offset


def cap_ctas(n: int) -> int:
    """CTAs of K7b's launch over ``n`` rows (csrc/gang_capacity.cu
    gang_capacity_ctas): one a CAP_ROWS rows."""
    return -(-n // CAP_ROWS) if n >= 1 else 0


@dataclass
class CapPlan:
    """K7b's launch for one (N, R, row stride, device, stream), prepared
    once: the argument block with its dimensions and plan (a call fills a
    copy of it with ``free``, the request's values and ``out``), and, past
    one CTA, the partials and ticket the CTAs fold through (zeroed once;
    the last CTA resets the ticket). The scratch is shared by every launch
    of the plan, so it is correct only while those launches run one after
    another: the stream is part of the plan's key, and a launch that fails
    on the card leaves the context unusable (CUDA errors there are
    sticky), so no later launch reads a half-folded ticket."""

    args: _CapArgs
    partials: torch.Tensor | None


_CAP_PLANS: dict = {}
_CAP_ENTRY: list = []


def cap_plan(n: int, r: int, stride: int, dev: torch.device,
             stream: int | None = None) -> CapPlan:
    """The plan of (n, r, stride, dev, stream) (CapPlan); ``stream`` is the
    raw handle the launches go to (None on the CPU)."""
    key = (n, r, stride, dev, stream)
    plan = _CAP_PLANS.get(key)
    if plan is None:
        ctas = cap_ctas(n)
        part = (torch.zeros((ctas * 12 + 4,), dtype=torch.uint8,
                            device=dev) if ctas > 1 else None)
        plan = CapPlan(_CapArgs(N=n, R=r, free_stride=stride, ctas=ctas,
                                partials=(None if part is None
                                          else part.data_ptr())), part)
        _CAP_PLANS[key] = plan
    return plan


def _cap_entry():
    if not _CAP_ENTRY:
        fn = KB.library("gang_capacity").gang_capacity_launch
        fn.argtypes = [ctypes.POINTER(_CapArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _CAP_ENTRY.append(fn)
    return _CAP_ENTRY[0]


def host_request(req) -> np.ndarray:
    """The request as the f32 host row K7b's argument block carries (a
    numpy row or a CPU tensor); a row past CAP_R_MAX columns is
    refused."""
    if isinstance(req, torch.Tensor):
        req = req.numpy()
    row = np.ascontiguousarray(req, dtype=np.float32)
    if row.ndim != 1 or row.shape[0] > CAP_R_MAX:
        raise ValueError(f"gang_capacity: a request of {row.shape} "
                         f"columns; the launch carries at most {CAP_R_MAX} "
                         "by value")
    return row


def prepare_capacity(free: torch.Tensor, req,
                     stream: int | None = None) -> tuple:
    """K7b's argument block for one call, launching nothing: a copy of the
    layout's plan (cap_plan, for launches on ``stream``) with this call's
    ``free`` pointer and the request's values, and a fresh 0-d i32
    ``out``. Returns (args, out)."""
    dev = free.device
    row = host_request(req)
    n, r = free.shape
    if row.shape[0] != r:
        raise ValueError(f"gang_capacity: a request of {row.shape[0]} "
                         f"columns against {r}")
    if free.dtype != torch.float32 or free.stride(1) != 1:
        raise ValueError("gang_capacity: free must be f32 with contiguous "
                         "rows")
    args = _CapArgs.from_buffer_copy(
        cap_plan(n, r, int(free.stride(0)), dev, stream).args)
    out = torch.empty((), dtype=torch.int32, device=dev)
    args.free = free.data_ptr()
    args.out = out.data_ptr()
    ctypes.memmove(ctypes.addressof(args) + _REQ_OFF, row.ctypes.data,
                   4 * r)
    return args, out


def gang_capacity(free: torch.Tensor, req) -> torch.Tensor:
    """K7b: the capacity bound as a 0-d i32 tensor on ``free``'s device,
    never synchronised here (the caller pulls it with its cycle's
    verdicts). ``free`` may be a row-strided view (the mirror's resident
    blob); ``req`` is the request's host row (numpy or a CPU tensor,
    host_request), which the launch carries by value: no host-to-device
    copy. The twin for CPU tensors."""
    dev = free.device
    if isinstance(req, torch.Tensor) and req.device.type != "cpu":
        # reading it back would be the copy the by-value launch avoids
        raise ValueError("gang_capacity: the request travels by value in "
                         "the launch; pass its host row, not a tensor on "
                         f"{req.device}")
    if dev.type == "cpu":
        return capacity_ref(free, torch.as_tensor(req, dtype=torch.float32))
    if dev.type != "cuda":
        raise ValueError(f"gang_capacity: unsupported device {dev}")
    stream = KB.stream_handle()
    args, out = prepare_capacity(free, req, stream.value)
    KB.check("gang_capacity", _cap_entry()(ctypes.byref(args), stream))
    KB.LAUNCHES["gang_capacity"] += 1
    return out
