"""K1 phase1_static: wrapper around csrc/phase1_static.cu and its twin.

Inputs are the resident cluster blobs and FULL-schema pod rows of the G
phase-1 groups (the dedup representatives, or every pod); outputs are
per (group, node). ``phase1_static`` launches the kernel for CUDA tensors
and runs ``phase1_static_ref`` — the plain-torch twin, written as the
ported ops/ functions with the group axis written out — only for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.ops import scores as SC
from kubernetes_tpu_torch.ops.blobs import Blobs
from kubernetes_tpu_torch.ops.features import (
    Capacities,
    ClusterBlobs,
    PodFeatures,
    codecs,
    unpack_cluster,
)

NUM_STATIC = 5

_FIELDS = (
    "N", "G", "NF", "NI", "PF", "PI",
    "R", "K", "T", "P", "I",
    "TO", "PL", "ST", "SE", "SV", "PW", "HP", "IM",
    "n_alloc", "n_label_nums", "n_image_sizes",
    "n_valid", "n_unsched", "n_name", "n_label_vals", "n_taint_keys",
    "n_taint_vals", "n_taint_effects", "n_port_ips", "n_port_protos",
    "n_port_nums", "n_image_ids",
    "p_req", "p_num_containers", "p_sel_num", "p_pref_num",
    "p_valid", "p_node_name", "p_tol_key", "p_tol_op", "p_tol_val",
    "p_tol_effect", "p_tol_valid", "p_aff_pin", "p_nodesel_cols",
    "p_nodesel_vals", "p_sel_term_valid", "p_sel_col", "p_sel_op",
    "p_sel_is_field", "p_sel_vals", "p_pref_weight", "p_pref_col",
    "p_pref_op", "p_pref_is_field", "p_pref_vals", "p_hp_ip", "p_hp_proto",
    "p_hp_port", "p_image_ids",
    "unsched_key", "wildcard_ip",
    "en0", "en1", "en2", "en3", "en4",
    "act_taints", "act_aff_full", "act_aff_pin", "act_ports", "act_images",
)

# layout member -> blob field name (node_* in the node codec, p_* in the
# pod codec)
_NODE_FIELD = {
    "n_alloc": "allocatable", "n_label_nums": "label_col_nums",
    "n_image_sizes": "image_sizes", "n_valid": "node_valid",
    "n_unsched": "unschedulable", "n_name": "node_name_id",
    "n_label_vals": "label_col_vals", "n_taint_keys": "taint_keys",
    "n_taint_vals": "taint_vals", "n_taint_effects": "taint_effects",
    "n_port_ips": "port_ips", "n_port_protos": "port_protos",
    "n_port_nums": "port_nums", "n_image_ids": "image_ids",
}
_POD_FIELD = {
    "p_req": "req", "p_num_containers": "num_containers",
    "p_sel_num": "sel_num", "p_pref_num": "pref_num", "p_valid": "valid",
    "p_node_name": "node_name_id", "p_tol_key": "tol_key",
    "p_tol_op": "tol_op", "p_tol_val": "tol_val",
    "p_tol_effect": "tol_effect", "p_tol_valid": "tol_valid",
    "p_aff_pin": "aff_pin", "p_nodesel_cols": "nodesel_cols",
    "p_nodesel_vals": "nodesel_vals", "p_sel_term_valid": "sel_term_valid",
    "p_sel_col": "sel_col", "p_sel_op": "sel_op",
    "p_sel_is_field": "sel_is_field", "p_sel_vals": "sel_vals",
    "p_pref_weight": "pref_weight", "p_pref_col": "pref_col",
    "p_pref_op": "pref_op", "p_pref_is_field": "pref_is_field",
    "p_pref_vals": "pref_vals", "p_hp_ip": "hp_ip",
    "p_hp_proto": "hp_proto", "p_hp_port": "hp_port",
    "p_image_ids": "image_ids",
}


class _Layout(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in _FIELDS]


class Phase1(NamedTuple):
    static_ok: torch.Tensor   # [G, N] bool
    rejects: torch.Tensor     # [G, 5] i32 first-fail counts
    taint_raw: torch.Tensor   # [G, N] f32
    aff_raw: torch.Tensor     # [G, N] f32
    img: torch.Tensor         # [G, N] f32
    unres: torch.Tensor       # [G] i32
    # the TaintToleration and NodeAffinity masks on their own: spread
    # eligibility (the topology statics, K5) honors them per constraint
    taint_ok: torch.Tensor    # [G, N] bool
    nodeaff_ok: torch.Tensor  # [G, N] bool


def _layout(caps: Capacities, g: int, wk: dict, enabled, active) -> _Layout:
    node_codec, _, pod_codec = codecs(caps)
    v = {
        "N": caps.nodes, "G": g,
        "NF": node_codec.f32_size, "NI": node_codec.i32_size,
        "PF": pod_codec.f32_size, "PI": pod_codec.i32_size,
        "R": caps.res_cols, "K": caps.label_cols, "T": caps.node_taints,
        "P": caps.node_ports, "I": caps.node_images,
        "TO": caps.tolerations, "PL": caps.pod_labels,
        "ST": caps.sel_terms, "SE": caps.sel_exprs, "SV": caps.sel_vals,
        "PW": caps.pref_terms, "HP": caps.pod_ports, "IM": caps.pod_images,
        "unsched_key": int(wk["unschedulable_taint_key"]),
        "wildcard_ip": int(wk["wildcard_ip"]),
        "act_taints": "taints" in active,
        "act_aff_full": "nodeaffinity" in active,
        "act_aff_pin": "nodeaffinity_pin" in active,
        "act_ports": "ports" in active,
        "act_images": "images" in active,
    }
    for i in range(NUM_STATIC):
        v[f"en{i}"] = bool(enabled[i])
    for key, name in _NODE_FIELD.items():
        off = node_codec._f32_off.get(name) or node_codec._i32_off[name]
        v[key] = off[0]
    for key, name in _POD_FIELD.items():
        off = pod_codec._f32_off.get(name) or pod_codec._i32_off[name]
        v[key] = off[0]
    return _Layout(**{k: int(x) for k, x in v.items()})


def static_filters(ct, pod: PodFeatures, wk: dict, enabled, active
                   ) -> torch.Tensor:
    """Commit-invariant Filter plugins for a pod batch over all nodes:
    [5, G, N] masks in FILTER_PLUGINS order (models/pipeline.py
    static_filters with the batch axis written out). A disabled plugin or
    an inactive feature gives an all-True mask."""
    from kubernetes_tpu_torch.ops import filters as FL

    fns = (
        lambda: FL.node_unschedulable(ct, pod, wk["unschedulable_taint_key"]),
        lambda: FL.node_name(ct, pod),
        lambda: (FL.taint_toleration(ct, pod)
                 if "taints" in active else None),
        lambda: (FL.node_affinity(ct, pod, full="nodeaffinity" in active)
                 if ("nodeaffinity" in active
                     or "nodeaffinity_pin" in active) else None),
        lambda: (FL.node_ports(ct, pod, wk["wildcard_ip"])
                 if "ports" in active else None),
    )
    g, n = pod.valid.shape[0], ct.node_valid.shape[0]
    masks = []
    for i, fn in enumerate(fns):
        m = fn() if enabled[i] else None
        masks.append(m if m is not None else torch.ones(
            (g, n), dtype=torch.bool, device=ct.node_valid.device))
    return torch.stack(masks)


def phase1_static_ref(cblobs: ClusterBlobs, prow_f32: torch.Tensor,
                      prow_i32: torch.Tensor, caps: Capacities, wk: dict,
                      enabled, active) -> Phase1:
    """The plain-torch twin: schedule_batch's ``per_pod`` for G rows."""
    ct = unpack_cluster(cblobs, caps)
    _, _, pod_codec = codecs(caps)
    pod = pod_codec.unpack(Blobs(f32=prow_f32, i32=prow_i32), PodFeatures)
    masks = static_filters(ct, pod, wk, enabled, active)      # [5, G, N]
    valid = ct.node_valid
    static_ok = masks.all(dim=0) & valid[None] & pod.valid[:, None]
    prev_ok = torch.cumprod(torch.cat(
        [torch.ones_like(masks[:1]), masks[:-1]]).to(torch.int32),
        dim=0).bool()
    first_fail = prev_ok & ~masks & valid[None, None]
    rejects = first_fail.sum(dim=-1).T.to(torch.int32).contiguous()
    g, n = static_ok.shape
    zeros = torch.zeros((g, n), dtype=torch.float32, device=valid.device)
    taint_raw = (SC.taint_toleration_score(ct, pod)
                 if "taints" in active else zeros)
    aff_raw = (SC.node_affinity_score(ct, pod)
               if "nodeaffinity" in active else zeros)
    img = (SC.image_locality(ct, pod, valid.sum())
           if "images" in active else zeros)
    unresolvable = torch.any(pod.req[:, None, :] > ct.allocatable[None],
                             dim=-1)
    unres = (unresolvable & valid[None]).sum(dim=-1).to(torch.int32)
    return Phase1(static_ok, rejects, taint_raw, aff_raw, img, unres,
                  masks[2], masks[3])


def phase1_static(cblobs: ClusterBlobs, prow_f32: torch.Tensor,
                  prow_i32: torch.Tensor, caps: Capacities, wk: dict,
                  enabled, active) -> Phase1:
    """K1: the kernel for CUDA tensors, the twin for CPU tensors."""
    dev = cblobs.node_f32.device
    if dev.type == "cpu":
        return phase1_static_ref(cblobs, prow_f32, prow_i32, caps, wk,
                                 enabled, active)
    if dev.type != "cuda":
        raise ValueError(f"phase1_static: unsupported device {dev}")
    return _phase1_kernel(cblobs, prow_f32, prow_i32, caps, wk, enabled,
                          active)


def _phase1_kernel(cblobs, prow_f32, prow_i32, caps, wk, enabled, active
                   ) -> Phase1:
    dev = cblobs.node_f32.device
    node_codec, _, pod_codec = codecs(caps)
    g, n = prow_f32.shape[0], caps.nodes
    KB.require(cblobs.node_f32, "node_f32", torch.float32,
               (n, node_codec.f32_size), dev)
    KB.require(cblobs.node_i32, "node_i32", torch.int32,
               (n, node_codec.i32_size), dev)
    KB.require(prow_f32, "pod_f32", torch.float32,
               (g, pod_codec.f32_size), dev)
    KB.require(prow_i32, "pod_i32", torch.int32,
               (g, pod_codec.i32_size), dev)
    static_ok = torch.empty((g, n), dtype=torch.bool, device=dev)
    rejects = torch.zeros((g, NUM_STATIC), dtype=torch.int32, device=dev)
    taint_raw = torch.empty((g, n), dtype=torch.float32, device=dev)
    aff_raw = torch.empty_like(taint_raw)
    img = torch.empty_like(taint_raw)
    unres = torch.zeros((g,), dtype=torch.int32, device=dev)
    have = torch.zeros((g, caps.pod_images), dtype=torch.int32, device=dev)
    num_valid = torch.zeros((1,), dtype=torch.int32, device=dev)
    taint_ok = torch.empty((g, n), dtype=torch.bool, device=dev)
    nodeaff_ok = torch.empty((g, n), dtype=torch.bool, device=dev)
    layout = _layout(caps, g, wk, enabled, active)
    lib = KB.library("phase1_static")
    err = lib.phase1_static_launch(
        ctypes.byref(layout), KB.ptr(cblobs.node_f32),
        KB.ptr(cblobs.node_i32), KB.ptr(prow_f32), KB.ptr(prow_i32),
        KB.ptr(have), KB.ptr(num_valid), KB.ptr(static_ok), KB.ptr(rejects),
        KB.ptr(taint_raw), KB.ptr(aff_raw), KB.ptr(img), KB.ptr(unres),
        KB.ptr(taint_ok), KB.ptr(nodeaff_ok), KB.stream_handle())
    KB.check("phase1_static", err)
    KB.LAUNCHES["phase1_static"] += 1
    return Phase1(static_ok, rejects, taint_raw, aff_raw, img, unres,
                  taint_ok, nodeaff_ok)
