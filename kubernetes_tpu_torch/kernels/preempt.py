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

_SWEEP_DIMS = ("P", "N", "R", "K1", "C")
_SWEEP_POINTERS = ("static_ok", "free", "nom", "alloc", "req",
                   "nominated_row", "cumsum", "cols", "kmin")


class _SweepArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in _SWEEP_DIMS]
                + [(name, ctypes.c_void_p) for name in _SWEEP_POINTERS])


class SweepLaunch(NamedTuple):
    """One K6a launch's arguments, built once (K1 already ran); ``run``
    launches the sweep and leaves [P, N] i32 in ``out``."""

    args: _SweepArgs
    tensors: dict
    out: torch.Tensor

    def run(self) -> torch.Tensor:
        launch = KB.library("preempt_sweep").preempt_sweep_launch
        launch.argtypes = [ctypes.POINTER(_SweepArgs), ctypes.c_void_p]
        launch.restype = ctypes.c_int
        KB.check("preempt_sweep", launch(ctypes.byref(self.args),
                                         KB.stream_handle()))
        KB.LAUNCHES["preempt_sweep"] += 1
        return self.out


def prepare_sweep(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                  vic_cumsum: torch.Tensor, vic_cols: torch.Tensor,
                  caps: Capacities, enabled_filters=None,
                  free: torch.Tensor | None = None) -> SweepLaunch:
    """K1 on the P preemptor rows (every feature active), then the sweep's
    argument struct, every argument checked."""
    dev = cblobs.node_f32.device
    if enabled_filters is None:
        enabled_filters = (True,) * NUM_FILTER_PLUGINS
    p1 = phase1_static(cblobs, pblobs.f32, pblobs.i32, caps, wk,
                       enabled_filters[:NUM_STATIC], OP.ALL_FEATURES)
    ct = unpack_cluster(cblobs, caps)
    pods = unpack_pods(pblobs, caps)
    n, r = ct.free.shape
    p = pods.req.shape[0]
    k1, c = vic_cumsum.shape[1], vic_cols.shape[0]
    base = ct.free if free is None else free
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    table = {
        "static_ok": (p1.static_ok, u8, (p, n)),
        "free": (base.contiguous(), f32, (n, r)),
        "nom": (ct.nominated_req.contiguous(), f32, (n, r)),
        "alloc": (ct.allocatable.contiguous(), f32, (n, r)),
        "req": (pods.req.contiguous(), f32, (p, r)),
        "nominated_row": (pods.nominated_row.to(i32).contiguous(), i32,
                          (p,)),
        "cumsum": (vic_cumsum.contiguous(), f32, (n, k1, c)),
        "cols": (vic_cols.to(i32).contiguous(), i32, (c,)),
        "kmin": (torch.empty((p, n), dtype=i32, device=dev), i32, (p, n))}
    args = _SweepArgs(P=p, N=n, R=r, K1=k1, C=c)
    for name, (t, dtype, shape) in table.items():
        KB.require(t, name, dtype, shape, dev)
        setattr(args, name, t.data_ptr())
    tensors = {name: t for name, (t, _, _) in table.items()}
    return SweepLaunch(args, tensors, tensors["kmin"])


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
