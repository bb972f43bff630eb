"""K6 preemption: wrappers around csrc/preempt_sweep.cu (K6a) and
csrc/preempt_feasible.cu (K6b), and their twins.

- ``preempt_sweep`` (K6a): the minimal victim prefix per (preemptor,
  node). On the card: K1 on the preemptors' rows with every feature active
  (static_ok), then the sweep kernel.
- ``preempt_feasible`` (K6b): the full-filter dry run of one pod over
  every node against a masked pod table and an overridden free matrix. On
  the card: K1 on the pod's row with every feature active, K5's three
  stages over a copy of the table blob whose pod-valid column is ANDed
  with ``table_valid`` (data movement, in torch), then the fold: one
  launch (counted as ``preempt_feasible``) that takes the spread minima
  itself where the pod has a DoNotSchedule constraint in use. Its
  launch is planned once a layout (``fold_plan``), and a call sets only
  its pointers; nothing is read back to the host.

The twins ``preempt_sweep_ref`` / ``preempt_feasible_ref`` are the literal
port of the reference (ops/preempt.py); ``feasible_min_ref`` is the twin's
spread minimum alone. Each wrapper launches the kernels for CUDA tensors
and runs its twin only for CPU tensors; a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.kernels import topology as KT
from kubernetes_tpu_torch.kernels.phase1 import NUM_STATIC, phase1_static
from kubernetes_tpu_torch.models.pipeline import (
    FILTER_PLUGINS,
    NUM_FILTER_PLUGINS,
)
from kubernetes_tpu_torch.ops import preempt as OP
from kubernetes_tpu_torch.ops.features import (
    Capacities,
    ClusterBlobs,
    PodBlobs,
    codecs,
    unpack_cluster,
    unpack_pods,
)

preempt_sweep_ref = OP.preempt_sweep
preempt_feasible_ref = OP.preempt_feasible
feasible_min_ref = OP.spread_min


def _device(cblobs: ClusterBlobs, name: str) -> torch.device:
    dev = cblobs.node_f32.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------- K6a

_SWEEP_DIMS = ("P", "N", "R", "K1", "C", "node_stride", "free_stride",
               "pod_f32_stride", "pod_i32_stride")
_SWEEP_POINTERS = ("static_ok", "free", "nom", "alloc", "req",
                   "nominated_row", "cumsum", "cols", "kmin")

# csrc/preempt_sweep.cu: threads a CTA, the lanes a group (the most), the
# columns a lane takes before the group widens, the dynamic shared bytes
# a CTA may take
SWEEP_THREADS = 256
SWEEP_LANES = 8
SWEEP_LANES_MAX = 32
SWEEP_SPAN = 8
SWEEP_SMEM_MAX = 49152


class _SweepArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in _SWEEP_DIMS]
                + [(name, ctypes.c_void_p) for name in _SWEEP_POINTERS])


class _SweepPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int)
                for name in ("lanes", "nodes", "ctas_x", "smem")]


class SweepPlan(NamedTuple):
    """csrc/preempt_sweep.cu sweep_plan, stated in Python: ``lanes`` a
    (pod, node) group (8 where R <= 8, a lane a column; 16 up to
    SWEEP_SPAN columns a lane; a warp past that), ``nodes`` a CTA of
    SWEEP_THREADS threads, ``ctas_x`` CTAs along the node axis (the grid is
    ctas_x x P), ``smem`` dynamic shared bytes a CTA (the freed-column
    mask, the pod's request, the column list, each node's row of R
    bases)."""

    lanes: int
    nodes: int
    ctas_x: int
    smem: int

    def ctas(self, p: int) -> int:
        return self.ctas_x * p


def plan_sweep(p: int, n: int, r: int, k1: int, c: int) -> SweepPlan | None:
    """K6a's launch plan (None where the kernel refuses the shape)."""
    if p < 0 or n < 0 or r < 1 or k1 < 1 or c < 1:
        return None
    lanes = SWEEP_LANES if r <= SWEEP_LANES else 2 * SWEEP_LANES
    while lanes * SWEEP_SPAN < r and lanes < SWEEP_LANES_MAX:
        lanes *= 2
    nodes = SWEEP_THREADS // lanes
    smem = 4 * (-(-r // 32) + r + c + nodes * r)
    if smem > SWEEP_SMEM_MAX:
        return None
    return SweepPlan(lanes, nodes, -(-n // nodes), smem)


class SweepLayout(NamedTuple):
    """K6a's launch for one layout, built once: the argument struct with
    its dimensions and strides (``args``, copied for each call), the plan
    and the byte offsets of the fields it reads in place: free, nom and
    alloc in a node row (``node_off``), req and nominated_row in the pod's
    packed rows (``pod_off``)."""

    key: tuple
    args: _SweepArgs
    plan: SweepPlan
    node_off: dict
    pod_off: dict


# (layout key) -> SweepLayout, and the keys whose tensors were checked
_SWEEP_LAYOUTS: dict = {}
_SWEEP_CHECKED: set = set()


def sweep_key(cblobs: ClusterBlobs, pblobs: PodBlobs, caps: Capacities,
              vic_cumsum: torch.Tensor, vic_cols: torch.Tensor,
              free: torch.Tensor | None) -> tuple:
    """What K6a's launch depends on: P, N, R, K + 1, C, the node rows'
    stride, the free override's row stride (None: free is read from the
    blob), the pod rows' two strides and the device."""
    return (pblobs.f32.shape[0], cblobs.node_f32.shape[0], caps.res_cols,
            vic_cumsum.shape[1], vic_cumsum.shape[2],
            cblobs.node_f32.stride(0),
            None if free is None else free.stride(0),
            pblobs.f32.stride(0), pblobs.i32.stride(0),
            str(cblobs.node_f32.device))


def sweep_layout(key: tuple, caps: Capacities) -> SweepLayout:
    """The SweepLayout of one layout key (sweep_key), made once."""
    lay = _SWEEP_LAYOUTS.get(key)
    if lay is not None:
        return lay
    p, n, r, k1, c, node_stride, free_stride, pf, pi = key[:9]
    plan = plan_sweep(p, n, r, k1, c)
    if plan is None:
        raise ValueError(f"preempt_sweep: R={r} and C={c} take more than "
                         f"the sweep's {SWEEP_SMEM_MAX} shared bytes a CTA")
    node_codec, _, pod_codec = codecs(caps)
    args = _SweepArgs(P=p, N=n, R=r, K1=k1, C=c, node_stride=node_stride,
                      free_stride=(node_stride if free_stride is None
                                   else free_stride),
                      pod_f32_stride=pf, pod_i32_stride=pi)
    node_off = {f: node_codec._f32_off[f][0] * 4
                for f in ("free", "nominated_req", "allocatable")}
    pod_off = {"req": pod_codec._f32_off["req"][0] * 4,
               "nominated_row": pod_codec._i32_off["nominated_row"][0] * 4}
    lay = SweepLayout(key, args, plan, node_off, pod_off)
    _SWEEP_LAYOUTS[key] = lay
    return lay


class SweepLaunch:
    """One K6a launch's arguments (K1 already ran; the layout's struct
    with this call's pointers); ``run`` launches the sweep and leaves
    [P, N] i32 in ``out``. ``tensors`` (a measurement's view, built on
    demand) names each input as a typed tensor."""

    __slots__ = ("args", "out", "plan", "_parts")

    def __init__(self, args, out, plan, parts):
        self.args, self.out, self.plan = args, out, plan
        self._parts = parts

    def run(self) -> torch.Tensor:
        KB.check("preempt_sweep", _sweep_entry()(ctypes.byref(self.args),
                                                 KB.stream_handle()))
        KB.LAUNCHES["preempt_sweep"] += 1
        return self.out

    @property
    def tensors(self) -> dict:
        cblobs, pblobs, caps, static_ok, free, cumsum, cols = self._parts
        ct, pods = unpack_cluster(cblobs, caps), unpack_pods(pblobs, caps)
        return {"static_ok": static_ok,
                "free": ct.free if free is None else free,
                "nom": ct.nominated_req, "alloc": ct.allocatable,
                "req": pods.req, "nominated_row": pods.nominated_row,
                "cumsum": cumsum, "cols": cols, "kmin": self.out}


_SWEEP_ENTRY: list = []


def _sweep_entry():
    if not _SWEEP_ENTRY:
        fn = KB.library("preempt_sweep").preempt_sweep_launch
        fn.argtypes = [ctypes.POINTER(_SweepArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _SWEEP_ENTRY.append(fn)
    return _SWEEP_ENTRY[0]


def _check_sweep(lay: SweepLayout, parts, dev) -> None:
    """Every argument of a layout's first launch: the later launches of
    the layout take the same producers' tensors."""
    a = lay.args
    p, n, r = a.P, a.N, a.R
    f32, i32 = torch.float32, torch.int32
    cblobs, pblobs, _, static_ok, free, cumsum, cols = parts
    KB.require(static_ok, "static_ok", torch.bool, (p, n), dev)
    KB.require(cblobs.node_f32, "node_f32", f32,
               (n, cblobs.node_f32.shape[1]), dev)
    if free is not None:
        if free.dtype != f32 or free.device != dev or \
                tuple(free.shape) != (n, r) or free.stride(1) != 1:
            raise ValueError(f"preempt_sweep: free must be f32 [{n}, {r}] "
                             f"rows on {dev}, got {free.dtype} "
                             f"{tuple(free.shape)} strides {free.stride()}")
    for t, name in ((pblobs.f32, "pod f32"), (pblobs.i32, "pod i32")):
        if t.device != dev or t.shape[0] != p or t.stride(1) != 1:
            raise ValueError(f"preempt_sweep: {name} rows on {dev} expected")
    KB.require(cumsum, "cumsum", f32, (n, a.K1, a.C), dev)
    KB.require(cols, "cols", i32, (a.C,), dev)


def prepare_sweep(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                  vic_cumsum: torch.Tensor, vic_cols: torch.Tensor,
                  caps: Capacities, enabled_filters=None,
                  free: torch.Tensor | None = None) -> SweepLaunch:
    """K1 on the P preemptor rows (every feature active), then the sweep's
    arguments: the layout's struct (made and checked once, sweep_layout)
    with this call's pointers. The pod's request and nominated row are
    read in place from its packed rows, free / nom / alloc from the
    cluster blob's rows (the override ``free`` at its own row stride), the
    victim cumsum and columns as the Evaluator keeps them."""
    dev = cblobs.node_f32.device
    if enabled_filters is None:
        enabled_filters = (True,) * NUM_FILTER_PLUGINS
    lay = sweep_layout(sweep_key(cblobs, pblobs, caps, vic_cumsum, vic_cols,
                                 free), caps)
    p1 = phase1_static(cblobs, pblobs.f32, pblobs.i32, caps, wk,
                       enabled_filters[:NUM_STATIC], OP.ALL_FEATURES)
    out = torch.empty((lay.args.P, lay.args.N), dtype=torch.int32,
                      device=dev)
    args = _SweepArgs.from_buffer_copy(lay.args)
    node = cblobs.node_f32.data_ptr()
    args.static_ok = p1.static_ok.data_ptr()
    args.free = (node + lay.node_off["free"] if free is None
                 else free.data_ptr())
    args.nom = node + lay.node_off["nominated_req"]
    args.alloc = node + lay.node_off["allocatable"]
    args.req = pblobs.f32.data_ptr() + lay.pod_off["req"]
    args.nominated_row = (pblobs.i32.data_ptr()
                          + lay.pod_off["nominated_row"])
    args.cumsum = vic_cumsum.data_ptr()
    args.cols = vic_cols.data_ptr()
    args.kmin = out.data_ptr()
    parts = (cblobs, pblobs, caps, p1.static_ok, free, vic_cumsum,
             vic_cols)
    if lay.key not in _SWEEP_CHECKED:
        _check_sweep(lay, parts, dev)
        _SWEEP_CHECKED.add(lay.key)
    return SweepLaunch(args, out, lay.plan, parts)


def preempt_sweep(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                  vic_cumsum: torch.Tensor, vic_cols: torch.Tensor,
                  caps: Capacities, enabled_filters=None,
                  free: torch.Tensor | None = None) -> torch.Tensor:
    """K6a: [P, N] i32 minimal victim prefix, NONE where preemption cannot
    help (ops/preempt.py:preempt_sweep). K1 and the kernel for CUDA
    tensors, the twin for CPU tensors."""
    if _device(cblobs, "preempt_sweep").type == "cpu":
        return preempt_sweep_ref(cblobs, pblobs, wk, vic_cumsum, vic_cols,
                                 caps, enabled_filters, free)
    return prepare_sweep(cblobs, pblobs, wk, vic_cumsum, vic_cols, caps,
                         enabled_filters, free).run()


# ---------------------------------------------------------------- K6b

_FOLD_DIMS = ("N", "R", "C", "A", "D", "fit_on", "topo", "spread_on",
              "ipa_on", "nom_stride")
# the pod's fields the fold reads in place from its packed row: (pointer,
# blob, codec field)
_FOLD_POD = (("req", "f32", "req"), ("nominated_row", "i32", "nominated_row"),
             ("tsc_tk", "i32", "tsc_tk"), ("tsc_hard", "i32", "tsc_hard"),
             ("max_skew", "i32", "tsc_max_skew"),
             ("min_domains", "i32", "tsc_min_domains"),
             ("aff_tk", "i32", "aff_tk"), ("aff_self", "i32",
                                          "aff_self_match"))
# K5's outputs the fold reads (with topology)
_FOLD_TOPO = ("self_match", "cnt", "exists_hard", "match_static", "dom_ok",
              "any_match", "anti_ok", "term_static", "has_lbl")
_FOLD_POINTERS = (("static_ok", "free", "nom")
                  + tuple(p for p, _, _ in _FOLD_POD) + _FOLD_TOPO
                  + ("min_cnt", "out"))

# csrc/preempt_feasible.cu: the fold's one limit (spread constraints and
# affinity terms a launch)
FOLD_C_MAX = 64


class _FoldArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in _FOLD_DIMS]
                + [(name, ctypes.c_void_p) for name in _FOLD_POINTERS])


class FoldPlan(NamedTuple):
    """K6b's launch for one layout, built and checked once: the argument
    struct with its dimensions and flags (``args``, copied for each
    call), the byte offsets of the pod's fields in its packed rows
    (``pod_off``: pointer -> (blob, offset)) and of the nominated
    reservations in a node row (``nom_off``)."""

    key: tuple
    args: _FoldArgs
    pod_off: dict
    nom_off: int


# (layout key) -> FoldPlan, and the keys whose tensors were checked
_FOLD_PLANS: dict = {}
_FOLD_CHECKED: set = set()


def fold_key(cblobs: ClusterBlobs, pblobs: PodBlobs, caps: Capacities,
             free: torch.Tensor, enable_topology: bool, d: int,
             flags: tuple) -> tuple:
    """What K6b's launch depends on: N, R, C, A, D, the four flags (fit,
    topology, spread, inter-pod affinity), the blobs' row widths and the
    device."""
    return (free.shape[0], free.shape[1], caps.spread_constraints,
            caps.aff_terms, d) + tuple(int(bool(f)) for f in flags) + (
        cblobs.node_f32.shape[1], pblobs.f32.shape[1], pblobs.i32.shape[1],
        str(free.device))


def fold_plan(key: tuple, caps: Capacities) -> FoldPlan:
    """The FoldPlan of one layout key (fold_key), made once."""
    plan = _FOLD_PLANS.get(key)
    if plan is not None:
        return plan
    n, r, c, a, d, fit_on, topo, spread_on, ipa_on, row_f32 = key[:10]
    if c > FOLD_C_MAX or a > FOLD_C_MAX:
        raise ValueError(f"preempt_feasible: {c} spread constraints and "
                         f"{a} affinity terms, past the fold's "
                         f"{FOLD_C_MAX} of each")
    node_codec, _, pod_codec = codecs(caps)
    args = _FoldArgs(N=n, R=r, C=c, A=a, D=d, fit_on=fit_on, topo=topo,
                     spread_on=spread_on, ipa_on=ipa_on,
                     nom_stride=row_f32)
    pod_off = {}
    for ptr, blob, field in _FOLD_POD:
        offs = pod_codec._f32_off if blob == "f32" else pod_codec._i32_off
        pod_off[ptr] = (blob, offs[field][0] * 4)
    plan = FoldPlan(key, args, pod_off,
                    node_codec._f32_off["nominated_req"][0] * 4)
    _FOLD_PLANS[key] = plan
    return plan


class FoldLaunch:
    """One K6b fold's arguments (K1 and K5 already ran; the plan's struct
    with this call's pointers); ``run`` launches the fold, one launch, and
    leaves [N] bool in ``out`` and the spread minima it took in
    ``min_cnt``. ``tensors`` (a measurement's view, built on demand) names
    each input as a typed tensor."""

    __slots__ = ("args", "out", "min_cnt", "_parts")

    def __init__(self, args, out, min_cnt, parts):
        self.args, self.out, self.min_cnt = args, out, min_cnt
        self._parts = parts

    def run(self) -> torch.Tensor:
        KB.check("preempt_feasible", _fold_entry()(ctypes.byref(self.args),
                                                   KB.stream_handle()))
        KB.LAUNCHES["preempt_feasible"] += 1
        return self.out

    @property
    def tensors(self) -> dict:
        cblobs, pblobs, caps, free, p1_ok, topo = self._parts
        pod = unpack_pods(pblobs, caps)
        t = {"static_ok": p1_ok, "free": free,
             "nom": unpack_cluster(cblobs, caps).nominated_req,
             "req": pod.req[0], "nominated_row": pod.nominated_row,
             "tsc_tk": pod.tsc_tk[0], "tsc_hard": pod.tsc_hard[0],
             "max_skew": pod.tsc_max_skew[0],
             "min_domains": pod.tsc_min_domains[0], "aff_tk": pod.aff_tk[0],
             "aff_self": pod.aff_self_match.reshape(1),
             "min_cnt": self.min_cnt, "out": self.out}
        t.update(topo)
        return t


_ENTRY: list = []


def _fold_entry():
    if not _ENTRY:
        fn = KB.library("preempt_feasible").preempt_feasible_launch
        fn.argtypes = [ctypes.POINTER(_FoldArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def masked_table(cblobs: ClusterBlobs, caps: Capacities,
                 table_valid: torch.Tensor) -> ClusterBlobs:
    """The cluster blobs with a copy of the pod table whose pod-valid
    column is ANDed with ``table_valid`` [PT] bool (the victims masked
    out); the node blobs are shared."""
    _, table_codec, _ = codecs(caps)
    col = table_codec._i32_off["pod_valid"][0]
    pods_i32 = cblobs.pods_i32.clone()
    pods_i32[:, col] = torch.where(table_valid, pods_i32[:, col],
                                   torch.zeros_like(pods_i32[:, col]))
    return ClusterBlobs(node_f32=cblobs.node_f32, node_i32=cblobs.node_i32,
                        pods_i32=pods_i32)


def _check_fold(launch: FoldLaunch, plan: FoldPlan, dev) -> None:
    """Every argument of a layout's first launch against the struct: the
    later launches of the layout take the same producers' tensors."""
    a = plan.args
    n, r, c, d = a.N, a.R, a.C, a.D
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    cblobs, pblobs, _, free, p1_ok, topo = launch._parts
    KB.require(p1_ok, "static_ok", u8, (n,), dev)
    KB.require(free, "free", f32, (n, r), dev)
    KB.require(cblobs.node_f32, "node_f32", f32, (n, a.nom_stride), dev)
    KB.require(pblobs.f32, "pod f32", f32, (1, pblobs.f32.shape[1]), dev)
    KB.require(pblobs.i32, "pod i32", i32, (1, pblobs.i32.shape[1]), dev)
    if a.topo:
        for name, dtype, shape in (
                ("self_match", f32, (c,)), ("cnt", f32, (c, d)),
                ("exists_hard", u8, (c, d)), ("match_static", f32, (n, c)),
                ("dom_ok", u8, (n, c)), ("any_match", u8, (1,)),
                ("anti_ok", u8, (n,)), ("term_static", u8, (n, a.A)),
                ("has_lbl", u8, (n, a.A))):
            KB.require(topo[name], name, dtype, shape, dev)


def prepare_feasible(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                     caps: Capacities, table_valid: torch.Tensor,
                     free: torch.Tensor, enable_topology: bool = True,
                     d_cap: int | None = None, enabled_filters=None
                     ) -> FoldLaunch:
    """K1 on the pod's row, K5 over the masked table (when
    ``enable_topology``), then the fold's arguments: the layout's plan
    (made and checked once, fold_plan), this call's pointers. Nothing is
    read back from the device: the fold decides on the card whether the
    pod has a DoNotSchedule constraint whose minimum it needs."""
    dev = cblobs.node_f32.device
    if enabled_filters is None:
        enabled_filters = (True,) * NUM_FILTER_PLUGINS
    if d_cap is None:
        d_cap = caps.domain_cap
    if pblobs.f32.shape[0] != 1:
        raise ValueError("preempt_feasible: one pod row expected")
    flags = (enabled_filters[FILTER_PLUGINS.index("NodeResourcesFit")],
             enable_topology,
             enabled_filters[FILTER_PLUGINS.index("PodTopologySpread")],
             enabled_filters[FILTER_PLUGINS.index("InterPodAffinity")])
    d = int(d_cap) if enable_topology else 1
    plan = fold_plan(fold_key(cblobs, pblobs, caps, free, enable_topology,
                              d, flags), caps)
    if not free.is_contiguous():
        free = free.contiguous()
    p1 = phase1_static(cblobs, pblobs.f32, pblobs.i32, caps, wk,
                       enabled_filters[:NUM_STATIC], OP.ALL_FEATURES)
    topo = {}
    if enable_topology:
        st = KT.topo_statics(masked_table(cblobs, caps, table_valid),
                             pblobs.f32, pblobs.i32, p1.static_ok,
                             p1.taint_ok, p1.nodeaff_ok, caps, d)
        topo = {
            "self_match": st.pairs.self_match[0], "cnt": st.maps.cnt[0],
            "exists_hard": st.nodes.exists_hard[0],
            "match_static": st.nodes.match_static[0],
            "dom_ok": st.nodes.dom_ok[0],
            "any_match": st.maps.any_match.reshape(1),
            "anti_ok": st.nodes.anti_ok[0],
            "term_static": st.nodes.term_static[0],
            "has_lbl": st.nodes.has_lbl[0]}
    out = torch.empty((plan.args.N,), dtype=torch.bool, device=dev)
    min_cnt = torch.empty((plan.args.C,), dtype=torch.float32, device=dev)
    args = _FoldArgs.from_buffer_copy(plan.args)
    static_ok = p1.static_ok[0]
    args.static_ok = static_ok.data_ptr()
    args.free = free.data_ptr()
    args.nom = cblobs.node_f32.data_ptr() + plan.nom_off
    base = {"f32": pblobs.f32.data_ptr(), "i32": pblobs.i32.data_ptr()}
    for ptr, (blob, off) in plan.pod_off.items():
        setattr(args, ptr, base[blob] + off)
    for name, t in topo.items():
        setattr(args, name, t.data_ptr())
    args.min_cnt = min_cnt.data_ptr()
    args.out = out.data_ptr()
    launch = FoldLaunch(args, out, min_cnt,
                        (cblobs, pblobs, caps, free, static_ok, topo))
    if plan.key not in _FOLD_CHECKED:
        _check_fold(launch, plan, dev)
        _FOLD_CHECKED.add(plan.key)
    return launch


def preempt_feasible(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                     caps: Capacities, table_valid: torch.Tensor,
                     free: torch.Tensor, enable_topology: bool = True,
                     d_cap: int | None = None, enabled_filters=None
                     ) -> torch.Tensor:
    """K6b: [N] bool full-filter dry run of one pod
    (ops/preempt.py:preempt_feasible). K1, K5 over the masked table and
    the fold for CUDA tensors, the twin for CPU tensors."""
    if _device(cblobs, "preempt_feasible").type == "cpu":
        return preempt_feasible_ref(cblobs, pblobs, wk, caps, table_valid,
                                    free, enable_topology, d_cap,
                                    enabled_filters)
    return prepare_feasible(cblobs, pblobs, wk, caps, table_valid, free,
                            enable_topology, d_cap, enabled_filters).run()
