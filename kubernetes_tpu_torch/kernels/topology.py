"""K5 topo_statics: wrapper around csrc/topo_statics.cu and its twins.

The per-group topology statics of one topology launch (the JAX package's
models/pipeline.py phase 1b ``per_group``, :1078-1145, and the pairwise
``M_*_gg`` matches, :1153-1173), in three stages, one ``__global__`` each:

1. ``topo_table`` — the pod table scattered into per-group domain maps:
   the anti-affinity forbid map [TK, D], the required-affinity presence
   map [A, D], the weighted InterPodAffinity score map [TK, D] and the
   spread counts [C, D].
2. ``topo_nodes`` — the maps gathered at every node's domains into the
   node-space statics the commit scan (K3) reads, plus the spread domain
   presence maps.
3. ``topo_pairs`` — the group-by-group term and constraint matches, the
   domain counts (num_domains, the normalizing weight ``tpw``) and the
   per-group self matches.

The twins (``*_ref``) are the ported ops/topology.py functions looped over
the groups, as ``per_group`` is vmapped; ``topo_statics`` launches the
kernels for CUDA tensors and runs the twins only for CPU tensors.

``tpw = log(domains + 2)`` is read from ``log2p_table`` (float32
``torch.log`` on the CPU) by kernel and twin alike, so the card agrees
with the twin exactly; against the reference (XLA's float32 log on the CPU
is not correctly rounded) it may differ by one ulp.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.ops import common as C
from kubernetes_tpu_torch.ops import topology as T
from kubernetes_tpu_torch.ops.features import (
    Capacities,
    ClusterBlobs,
    PodBlobs,
    PodFeatures,
    codecs,
    unpack_cluster,
    unpack_pods,
)
from kubernetes_tpu_torch.utils.interner import NONE

# default HardPodAffinityWeight (apis/config/v1/defaults.go)
HARD_POD_AFFINITY_WEIGHT = 1.0

TERM_KINDS = ("anti", "aff", "paff", "panti")

_LOG2P: dict[tuple, torch.Tensor] = {}


def log2p_table(d_cap: int, device) -> torch.Tensor:
    """[d_cap + 1] f32: log(k + 2) for k = 0..d_cap, computed once in
    float32 by torch on the CPU (correctly rounded there) and shared by
    the kernel and its twin."""
    key = (int(d_cap), str(device))
    t = _LOG2P.get(key)
    if t is None:
        k = torch.arange(d_cap + 1, dtype=torch.float32)
        t = _LOG2P[key] = torch.log(k + 2.0).to(device)
    return t


class TopoMaps(NamedTuple):
    """Stage 1: per-group domain maps of the pre-batch pod table."""

    forbid: torch.Tensor      # [G, TK, D] bool: required anti-affinity
    present: torch.Tensor     # [G, A, D] bool: required-affinity presence
    any_match: torch.Tensor   # [G] bool
    score: torch.Tensor       # [G, TK, D] f32: weighted ipa score
    cnt: torch.Tensor         # [G, C, D] f32: spread match counts


class NodeStatics(NamedTuple):
    """Stage 2: node-space statics + the spread domain presence maps."""

    anti_ok: torch.Tensor       # [G, N] bool
    ipa_raw: torch.Tensor       # [G, N] f32
    term_static: torch.Tensor   # [G, N, A] bool
    has_lbl: torch.Tensor       # [G, N, A] bool
    ign: torch.Tensor           # [G, N] bool: ignored for spread scoring
    el_node: torch.Tensor       # [G, N, C] bool
    match_static: torch.Tensor  # [G, N, C] f32
    dom_ok: torch.Tensor        # [G, N, C] bool
    exists_hard: torch.Tensor   # [G, C, D] bool
    exists_score: torch.Tensor  # [G, C, D] bool


class PairStatics(NamedTuple):
    """Stage 3: group-by-group matches and per-group scalars."""

    m_terms: torch.Tensor     # [4, G, A, G] bool, TERM_KINDS order
    m_tsc: torch.Tensor       # [G, C, G] bool
    tpw: torch.Tensor         # [G, C] f32
    self_match: torch.Tensor  # [G, C] f32
    num_domains: torch.Tensor  # [G, C] i32
    has_soft: torch.Tensor    # [G] bool


class TopoStatics(NamedTuple):
    maps: TopoMaps
    nodes: NodeStatics
    pairs: PairStatics


def pod_row(pods: PodFeatures, g: int) -> PodFeatures:
    """Row ``g`` of a batched PodFeatures (fields without the batch axis)."""
    return PodFeatures(**{f.name: getattr(pods, f.name)[g]
                          for f in dataclasses.fields(PodFeatures)})


def _considered(pod: PodFeatures):
    used = pod.tsc_tk != NONE
    return used, used & pod.tsc_hard, used & ~pod.tsc_hard


# ---------------------------------------------------------------- twins


def topo_table_ref(ct, pods: PodFeatures, taint_ok: torch.Tensor,
                   nodeaff_ok: torch.Tensor, d_cap: int) -> TopoMaps:
    """Stage 1 twin: per group, the table scatters of
    inter_pod_affinity_static / inter_pod_affinity_score / spread_cnt."""
    tds = T.slot_topo_dom(ct)
    out = []
    for g in range(pods.valid.shape[0]):
        pod = pod_row(pods, g)
        forbid = T.anti_affinity_maps(ct, pod, tds, d_cap)
        present, any_match = T.affinity_presence(ct, pod, tds, d_cap)
        score = T.affinity_score_map(ct, pod, tds, d_cap,
                                     HARD_POD_AFFINITY_WEIGHT)
        _, used_hard, used_soft = _considered(pod)
        el_hard = T.spread_eligible(ct, pod, nodeaff_ok[g], taint_ok[g],
                                    used_hard)
        el_soft = T.spread_eligible(ct, pod, nodeaff_ok[g], taint_ok[g],
                                    used_soft)
        el_mixed = torch.where(pod.tsc_hard[None], el_hard, el_soft)
        cnt = T.spread_cnt(ct, pod, tds, el_mixed, d_cap)
        out.append((forbid, present, any_match, score, cnt))
    return TopoMaps(*(torch.stack(x) for x in zip(*out)))


def topo_nodes_ref(ct, pods: PodFeatures, static_ok: torch.Tensor,
                   taint_ok: torch.Tensor, nodeaff_ok: torch.Tensor,
                   maps: TopoMaps, d_cap: int) -> NodeStatics:
    """Stage 2 twin: per group, the node gathers of per_group."""
    valid = ct.node_valid
    out = []
    for g in range(pods.valid.shape[0]):
        pod = pod_row(pods, g)
        anti_ok = ~torch.any(T.gather_rows(maps.forbid[g], ct.topo_dom),
                             dim=1)
        aff_node_dom = T.take_cols(ct.topo_dom, pod.aff_tk, NONE)  # [N, A]
        has_lbl = aff_node_dom != NONE
        term_static = has_lbl & T.gather_rows(maps.present[g],
                                              aff_node_dom)
        ipa_raw = C.sum_last(T.gather_rows(maps.score[g], ct.topo_dom))
        used_c, used_hard, used_soft = _considered(pod)
        el_hard = T.spread_eligible(ct, pod, nodeaff_ok[g], taint_ok[g],
                                    used_hard)
        exists_hard = T.spread_exists(ct, pod, el_hard, d_cap)
        node_dom = T.take_cols(ct.topo_dom, pod.tsc_tk, NONE)      # [N, C]
        ign = torch.any((node_dom == NONE) & used_soft[None], dim=1)
        exists_score = T.spread_exists(
            ct, pod, (static_ok[g] & ~ign)[:, None] & used_soft[None],
            d_cap)
        true = torch.ones_like(node_dom, dtype=torch.bool)
        pol = (torch.where(pod.tsc_honor_affinity[None],
                           (nodeaff_ok[g] & valid)[:, None], true)
               & torch.where(pod.tsc_honor_taints[None],
                             (taint_ok[g] & valid)[:, None], true))
        dom_ok = node_dom != NONE
        all_h = torch.all(dom_ok | ~used_hard[None], dim=1)
        all_s = torch.all(dom_ok | ~used_soft[None], dim=1)
        el_node = (pol & torch.where(used_hard[None], all_h[:, None],
                                     all_s[:, None]) & used_c[None])
        match_static = T.gather_rows(maps.cnt[g], node_dom)
        out.append((anti_ok, ipa_raw, term_static, has_lbl, ign, el_node,
                    match_static, dom_ok, exists_hard, exists_score))
    return NodeStatics(*(torch.stack(x) for x in zip(*out)))


def topo_pairs_ref(pods: PodFeatures, nodes: NodeStatics,
                   log2p: torch.Tensor) -> PairStatics:
    """Stage 3 twin: pair_term_match / pair_tsc_match over the groups, the
    domain counts and the self matches."""
    m_terms = torch.stack([T.pair_term_match(
        getattr(pods, f"{k}_tk"), getattr(pods, f"{k}_ns"),
        getattr(pods, f"{k}_ns_all"), getattr(pods, f"{k}_sel_cols"),
        getattr(pods, f"{k}_sel_ops"), getattr(pods, f"{k}_sel_vals"),
        pods.plabel_vals, pods.ns, pods.valid) for k in TERM_KINDS])
    m_tsc = T.pair_tsc_match(pods)
    n_score = nodes.exists_score.sum(dim=-1)
    tpw = log2p[n_score]
    num_domains = nodes.exists_hard.sum(dim=-1).to(torch.int32)
    self_match = torch.stack([
        T._tsc_self_match(pod_row(pods, g)).to(torch.float32)
        for g in range(pods.valid.shape[0])])
    has_soft = torch.any((pods.tsc_tk != NONE) & ~pods.tsc_hard, dim=-1)
    return PairStatics(m_terms, m_tsc, tpw, self_match, num_domains,
                       has_soft)


def topo_statics_ref(cblobs: ClusterBlobs, prow_f32: torch.Tensor,
                     prow_i32: torch.Tensor, static_ok: torch.Tensor,
                     taint_ok: torch.Tensor, nodeaff_ok: torch.Tensor,
                     caps: Capacities, d_cap: int) -> TopoStatics:
    """The three twins in order over the G group rows."""
    ct = unpack_cluster(cblobs, caps)
    pods = unpack_pods(PodBlobs(f32=prow_f32, i32=prow_i32), caps)
    maps = topo_table_ref(ct, pods, taint_ok, nodeaff_ok, d_cap)
    nodes = topo_nodes_ref(ct, pods, static_ok, taint_ok, nodeaff_ok, maps,
                           d_cap)
    pairs = topo_pairs_ref(pods, nodes,
                           log2p_table(d_cap, static_ok.device))
    return TopoStatics(maps, nodes, pairs)


def topo_statics(cblobs: ClusterBlobs, prow_f32: torch.Tensor,
                 prow_i32: torch.Tensor, static_ok: torch.Tensor,
                 taint_ok: torch.Tensor, nodeaff_ok: torch.Tensor,
                 caps: Capacities, d_cap: int) -> TopoStatics:
    """K5: the kernels for CUDA tensors, the twins for CPU tensors.
    ``static_ok``/``taint_ok``/``nodeaff_ok`` are phase 1's (K1) outputs
    for the same G group rows."""
    dev = cblobs.node_f32.device
    if dev.type == "cpu":
        return topo_statics_ref(cblobs, prow_f32, prow_i32, static_ok,
                                taint_ok, nodeaff_ok, caps, d_cap)
    if dev.type != "cuda":
        raise ValueError(f"topo_statics: unsupported device {dev}")
    return _topo_kernel(cblobs, prow_f32, prow_i32, static_ok, taint_ok,
                        nodeaff_ok, caps, d_cap)


# ---------------------------------------------------------------- kernel

STAGES = ("topo_table", "topo_nodes", "topo_pairs")

_LAYOUT = (
    "N", "G", "PT", "TK", "D", "A", "C", "NS", "MS", "V", "KP", "TI", "PI",
    "t_valid", "t_node", "t_ns", "t_uid", "t_nominated", "t_labels",
    *[f"t_{f}{k}" for f in ("tk", "nsid", "nsall", "cols", "ops", "vals",
                            "w") for k in range(4)],
    "p_valid", "p_ns", "p_uid", "p_labels",
    *[f"p_{f}{k}" for f in ("tk", "nsid", "nsall", "cols", "ops", "vals",
                            "w") for k in range(4)],
    "p_tsc_tk", "p_tsc_hard", "p_tsc_cols", "p_tsc_ops", "p_tsc_vals",
    "p_tsc_honor_aff", "p_tsc_honor_taints",
)

_POINTERS = (
    "table", "pods", "topo_dom", "node_valid", "static_ok", "taint_ok",
    "nodeaff_ok", "log2p",
    "forbid", "present", "any_match", "score", "cnt",
    "anti_ok", "ipa_raw", "term_static", "has_lbl", "ign", "el_node",
    "match_static", "dom_ok", "exists_hard", "exists_score",
    "m_terms", "m_tsc", "tpw", "self_match", "num_domains", "has_soft",
)


class _Layout(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in _LAYOUT]


class _Args(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _POINTERS]


def _layout(caps: Capacities, g: int, d_cap: int) -> _Layout:
    _, table_codec, pod_codec = codecs(caps)
    toff = table_codec._i32_off
    poff = pod_codec._i32_off
    v = {
        "N": caps.nodes, "G": g, "PT": caps.pods, "TK": caps.topo_cols,
        "D": d_cap, "A": caps.aff_terms, "C": caps.spread_constraints,
        "NS": caps.aff_ns, "MS": caps.aff_sel, "V": caps.aff_sel_vals,
        "KP": caps.pod_label_cols, "TI": table_codec.i32_size,
        "PI": pod_codec.i32_size,
        "t_valid": toff["pod_valid"][0], "t_node": toff["pod_node"][0],
        "t_ns": toff["pod_ns"][0], "t_uid": toff["pod_uid"][0],
        "t_nominated": toff["pod_nominated"][0],
        "t_labels": toff["pt_label_vals"][0],
        "p_valid": poff["valid"][0], "p_ns": poff["ns"][0],
        "p_uid": poff["uid_id"][0], "p_labels": poff["plabel_vals"][0],
        "p_tsc_tk": poff["tsc_tk"][0], "p_tsc_hard": poff["tsc_hard"][0],
        "p_tsc_cols": poff["tsc_sel_cols"][0],
        "p_tsc_ops": poff["tsc_sel_ops"][0],
        "p_tsc_vals": poff["tsc_sel_vals"][0],
        "p_tsc_honor_aff": poff["tsc_honor_affinity"][0],
        "p_tsc_honor_taints": poff["tsc_honor_taints"][0],
    }
    fields = {"tk": "tk", "nsid": "ns", "nsall": "ns_all",
              "cols": "sel_cols", "ops": "sel_ops", "vals": "sel_vals",
              "w": "weight"}
    for k, kind in enumerate(TERM_KINDS):
        for f, name in fields.items():
            t = toff.get(f"pod_{kind}_{name}")
            p = poff.get(f"{kind}_{name}")
            v[f"t_{f}{k}"] = t[0] if t is not None else -1
            v[f"p_{f}{k}"] = p[0] if p is not None else -1
    return _Layout(**{k: int(x) for k, x in v.items()})


def _alloc(g, n, tk, a, c, d_cap, zeros, empty):
    maps = TopoMaps(zeros(g, tk, d_cap), zeros(g, a, d_cap), zeros(g),
                    zeros(g, tk, d_cap, dtype=torch.float32),
                    zeros(g, c, d_cap, dtype=torch.float32))
    nodes = NodeStatics(
        empty(g, n), empty(g, n, dtype=torch.float32), empty(g, n, a),
        empty(g, n, a), empty(g, n), empty(g, n, c),
        empty(g, n, c, dtype=torch.float32), empty(g, n, c),
        zeros(g, c, d_cap), zeros(g, c, d_cap))
    pairs = PairStatics(
        empty(4, g, a, g), empty(g, c, g), empty(g, c, dtype=torch.float32),
        empty(g, c, dtype=torch.float32), empty(g, c, dtype=torch.int32),
        empty(g))
    return maps, nodes, pairs


def _topo_kernel(cblobs, prow_f32, prow_i32, static_ok, taint_ok,
                 nodeaff_ok, caps, d_cap) -> TopoStatics:
    launch = prepare_launch(cblobs, prow_f32, prow_i32, static_ok,
                            taint_ok, nodeaff_ok, caps, d_cap)
    for stage in STAGES:
        launch.run(stage)
    return launch.out


class TopoLaunch(NamedTuple):
    """One K5 launch's arguments, built once; ``run`` launches one stage
    (the stages run in STAGES order; the main path runs all three)."""

    layout: _Layout
    args: _Args
    tensors: dict             # every tensor the kernels read or write
    out: TopoStatics

    def run(self, stage: str) -> None:
        lib = KB.library("topo_statics")
        err = lib.topo_statics_launch(ctypes.byref(self.layout),
                                      ctypes.byref(self.args),
                                      STAGES.index(stage),
                                      KB.stream_handle())
        KB.check("topo_statics", err)
        KB.LAUNCHES[stage] += 1


def prepare_launch(cblobs, prow_f32, prow_i32, static_ok, taint_ok,
                   nodeaff_ok, caps, d_cap) -> TopoLaunch:
    """Check the inputs, allocate the outputs (the domain maps zeroed) and
    build the C argument structs."""
    dev = cblobs.node_f32.device
    _, table_codec, pod_codec = codecs(caps)
    n, g = caps.nodes, prow_i32.shape[0]
    tk, a, c = caps.topo_cols, caps.aff_terms, caps.spread_constraints
    KB.require(cblobs.pods_i32, "pods_i32", torch.int32,
               (caps.pods, table_codec.i32_size), dev)
    KB.require(prow_i32, "pod_i32", torch.int32, (g, pod_codec.i32_size),
               dev)
    for name, t in (("static_ok", static_ok), ("taint_ok", taint_ok),
                    ("nodeaff_ok", nodeaff_ok)):
        KB.require(t, name, torch.bool, (g, n), dev)
    ct = unpack_cluster(cblobs, caps)

    def zeros(*shape, dtype=torch.bool):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def empty(*shape, dtype=torch.bool):
        return torch.empty(shape, dtype=dtype, device=dev)

    maps, nodes, pairs = _alloc(g, n, tk, a, c, d_cap, zeros, empty)
    tensors = {
        "table": cblobs.pods_i32, "pods": prow_i32,
        "topo_dom": ct.topo_dom.contiguous(),
        "node_valid": ct.node_valid.contiguous(), "static_ok": static_ok,
        "taint_ok": taint_ok, "nodeaff_ok": nodeaff_ok,
        "log2p": log2p_table(d_cap, dev),
        **maps._asdict(), **nodes._asdict(), **pairs._asdict()}
    args = _Args(**{k: tensors[k].data_ptr() for k in _POINTERS})
    return TopoLaunch(_layout(caps, g, d_cap), args, tensors,
                      TopoStatics(maps, nodes, pairs))
