"""K6 preemption: wrappers around csrc/preempt_sweep.cu (K6a) and
csrc/preempt_feasible.cu (K6b), and their twins.

- ``preempt_sweep`` (K6a): the minimal victim prefix per (preemptor,
  node). On the card: K1 on the preemptors' rows with every feature active
  (static_ok), then the sweep kernel.
- ``preempt_feasible`` (K6b): the full-filter dry run of one pod over
  every node against a masked pod table and an overridden free matrix. On
  the card: K1 on the pod's row with every feature active, K5's three
  stages over a copy of the table blob whose pod-valid column is ANDed
  with ``table_valid`` (data movement, in torch), then the fold kernel's
  two stages: ``feasible_min`` (the spread minimum, only for a pod with
  a DoNotSchedule constraint in use) and the per-node fold, counted as
  ``preempt_feasible``.

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
              "ipa_on")
_FOLD_POINTERS = (
    "static_ok", "free", "nom", "req", "nominated_row", "tsc_tk", "tsc_hard",
    "max_skew", "min_domains", "self_match", "cnt", "exists_hard",
    "match_static", "dom_ok", "aff_tk", "aff_self", "any_match", "anti_ok",
    "term_static", "has_lbl", "min_cnt", "out")


# the fold's stages in launch order, each its own launch counter
FOLD_STAGES = ("feasible_min", "preempt_feasible")


class _FoldArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in _FOLD_DIMS]
                + [(name, ctypes.c_void_p) for name in _FOLD_POINTERS])


class FoldLaunch(NamedTuple):
    """One K6b fold's arguments, built once (K1 and K5 already ran);
    ``run`` launches the spread minimum when ``hard_spread`` and then the
    fold, and leaves [N] bool in ``out``."""

    args: _FoldArgs
    tensors: dict
    out: torch.Tensor
    hard_spread: bool

    def run(self) -> torch.Tensor:
        for stage in FOLD_STAGES:
            if stage != "feasible_min" or self.hard_spread:
                self.launch(stage)
        return self.out

    def launch(self, stage: str) -> None:
        """Launch one stage (in FOLD_STAGES order; ``run`` runs them)."""
        launch = KB.library("preempt_feasible").preempt_feasible_launch
        launch.argtypes = [ctypes.POINTER(_FoldArgs), ctypes.c_int,
                           ctypes.c_void_p]
        launch.restype = ctypes.c_int
        KB.check("preempt_feasible", launch(ctypes.byref(self.args),
                                            FOLD_STAGES.index(stage),
                                            KB.stream_handle()))
        KB.LAUNCHES[stage] += 1


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


def prepare_feasible(cblobs: ClusterBlobs, pblobs: PodBlobs, wk: dict,
                     caps: Capacities, table_valid: torch.Tensor,
                     free: torch.Tensor, enable_topology: bool = True,
                     d_cap: int | None = None, enabled_filters=None
                     ) -> FoldLaunch:
    """K1 on the pod's row, K5 over the masked table (when
    ``enable_topology``), then the fold's argument struct, every argument
    checked."""
    dev = cblobs.node_f32.device
    if enabled_filters is None:
        enabled_filters = (True,) * NUM_FILTER_PLUGINS
    if d_cap is None:
        d_cap = caps.domain_cap
    if pblobs.f32.shape[0] != 1:
        raise ValueError("preempt_feasible: one pod row expected")
    pod = unpack_pods(pblobs, caps)
    spread_on = enabled_filters[FILTER_PLUGINS.index("PodTopologySpread")]
    ipa_on = enabled_filters[FILTER_PLUGINS.index("InterPodAffinity")]
    # read before K1 is queued, so the host waits for the pod row's copy
    # alone: the spread minimum runs only for a DoNotSchedule constraint
    hard_spread = bool(enable_topology and spread_on and bool(
        ((pod.tsc_tk[0] != OP.NONE) & pod.tsc_hard[0]).any()))
    p1 = phase1_static(cblobs, pblobs.f32, pblobs.i32, caps, wk,
                       enabled_filters[:NUM_STATIC], OP.ALL_FEATURES)
    ct = unpack_cluster(cblobs, caps)
    n, r = ct.free.shape
    c, a = pod.tsc_tk.shape[1], pod.aff_tk.shape[1]
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    d = int(d_cap) if enable_topology else 1
    if enable_topology:
        st = KT.topo_statics(masked_table(cblobs, caps, table_valid),
                             pblobs.f32, pblobs.i32, p1.static_ok,
                             p1.taint_ok, p1.nodeaff_ok, caps, d)
        topo = {
            "self_match": st.pairs.self_match[0], "cnt": st.maps.cnt[0],
            "exists_hard": st.nodes.exists_hard[0],
            "match_static": st.nodes.match_static[0],
            "dom_ok": st.nodes.dom_ok[0], "any_match": st.maps.any_match,
            "anti_ok": st.nodes.anti_ok[0],
            "term_static": st.nodes.term_static[0],
            "has_lbl": st.nodes.has_lbl[0]}
    else:
        def zeros(*shape, dtype=u8):
            return torch.zeros(shape, dtype=dtype, device=dev)

        topo = {
            "self_match": zeros(c, dtype=f32), "cnt": zeros(c, d, dtype=f32),
            "exists_hard": zeros(c, d), "match_static": zeros(n, c,
                                                              dtype=f32),
            "dom_ok": zeros(n, c), "any_match": zeros(1),
            "anti_ok": zeros(n), "term_static": zeros(n, a),
            "has_lbl": zeros(n, a)}
    table = {
        "static_ok": (p1.static_ok[0], u8, (n,)),
        "free": (free.contiguous(), f32, (n, r)),
        "nom": (ct.nominated_req.contiguous(), f32, (n, r)),
        "req": (pod.req[0].contiguous(), f32, (r,)),
        "nominated_row": (pod.nominated_row.to(i32).contiguous(), i32,
                          (1,)),
        "tsc_tk": (pod.tsc_tk[0].to(i32).contiguous(), i32, (c,)),
        "tsc_hard": (pod.tsc_hard[0].contiguous(), u8, (c,)),
        "max_skew": (pod.tsc_max_skew[0].to(i32).contiguous(), i32, (c,)),
        "min_domains": (pod.tsc_min_domains[0].to(i32).contiguous(), i32,
                        (c,)),
        "self_match": (topo["self_match"].contiguous(), f32, (c,)),
        "cnt": (topo["cnt"].contiguous(), f32, (c, d)),
        "exists_hard": (topo["exists_hard"].contiguous(), u8, (c, d)),
        "match_static": (topo["match_static"].contiguous(), f32, (n, c)),
        "dom_ok": (topo["dom_ok"].contiguous(), u8, (n, c)),
        "aff_tk": (pod.aff_tk[0].to(i32).contiguous(), i32, (a,)),
        "aff_self": (pod.aff_self_match.reshape(1).contiguous(), u8, (1,)),
        "any_match": (topo["any_match"].reshape(1).contiguous(), u8, (1,)),
        "anti_ok": (topo["anti_ok"].contiguous(), u8, (n,)),
        "term_static": (topo["term_static"].contiguous(), u8, (n, a)),
        "has_lbl": (topo["has_lbl"].contiguous(), u8, (n, a)),
        "min_cnt": (torch.zeros((c,), dtype=f32, device=dev), f32, (c,)),
        "out": (torch.empty((n,), dtype=u8, device=dev), u8, (n,))}
    args = _FoldArgs(
        N=n, R=r, C=c, A=a, D=d,
        fit_on=int(bool(enabled_filters[
            FILTER_PLUGINS.index("NodeResourcesFit")])),
        topo=int(bool(enable_topology)), spread_on=int(bool(spread_on)),
        ipa_on=int(bool(ipa_on)))
    for name, (t, dtype, shape) in table.items():
        KB.require(t, name, dtype, shape, dev)
        setattr(args, name, t.data_ptr())
    tensors = {name: t for name, (t, _, _) in table.items()}
    return FoldLaunch(args, tensors, tensors["out"], hard_spread)


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
