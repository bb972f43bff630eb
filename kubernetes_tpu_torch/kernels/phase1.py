"""K1 phase1_static: wrapper around csrc/phase1_static.cu and its twin.

Inputs are the resident cluster blobs and FULL-schema pod rows of the G
phase-1 groups (the dedup representatives, or every pod) and, optionally,
the host Filter verdicts ``host_ok`` [G, N] of those rows, ANDed into
static_ok after the five filters (never into the reject counts); outputs
are per (group, node). ``phase1_static`` launches the kernel for CUDA tensors
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

# csrc/phase1_static.cu: threads a block, the lanes a pair may take, the
# threads a launch aims at when it widens a pair's lanes
THREADS = 256
LANES = (1, 2, 4, 8)
TARGET_THREADS = 1 << 17
NUM_COUNTS = NUM_STATIC + 1
# the features whose inner loops a pair's lanes split
HEAVY = frozenset(("taints", "nodeaffinity", "ports", "images"))

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
    "lanes", "blocks", "rows", "p_blocks", "p_rows", "smem", "p_smem",
)
_OFFSETS = ("o_taint_raw", "o_aff_raw", "o_img", "o_rejects", "o_unres",
            "o_have", "o_num_valid", "o_static_ok", "o_taint_ok",
            "o_nodeaff_ok", "count_bytes")

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
    _fields_ = ([(name, ctypes.c_int) for name in _FIELDS]
                + [(name, ctypes.c_long) for name in _OFFSETS])


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


class P1Plan(NamedTuple):
    lanes: int       # lanes a (group row, node) pair
    blocks: int      # blocks of THREADS threads
    rows: int        # group rows a block's pairs span (its count rows)
    p_blocks: int    # the presence launch (images active): a thread a pair
    p_rows: int
    smem: int
    p_smem: int


def plan_phase1(g: int, n: int, active, im: int, lanes=None) -> P1Plan:
    """K1's launch shape: a pair's lanes doubled, up to 8, while the
    launch stays within TARGET_THREADS and a feature with inner loops
    (HEAVY) is active; one lane a pair otherwise. ``lanes`` forces a
    width (a measurement of each). Blocks of THREADS threads over the
    G x N pairs, node-major; each block's count rows in shared memory."""
    if lanes is None:
        lanes = 1
        if HEAVY & set(active):
            while lanes < LANES[-1] and 2 * lanes * g * n <= TARGET_THREADS:
                lanes *= 2
    if lanes not in LANES:
        raise ValueError(f"phase1_static: {lanes} lanes a pair "
                         f"(one of {LANES})")

    def span(per):
        return min(g, (per - 1) // n + 2)

    per = THREADS // lanes
    rows, p_rows = span(per), span(THREADS)
    return P1Plan(lanes, -(-g * n // per), rows, -(-g * n // THREADS),
                  p_rows, 4 * rows * NUM_COUNTS, 4 * (p_rows * im + 1))


def out_offsets(g: int, n: int, im: int) -> dict:
    """Byte offsets of the outputs in their one allocation: the three
    float planes, the int32 counts (rejects, unres, have, num_valid; one
    memset), the three byte planes; ``total`` its size."""
    gn = g * n
    o = {"o_taint_raw": 0, "o_aff_raw": 4 * gn, "o_img": 8 * gn,
         "o_rejects": 12 * gn}
    o["o_unres"] = o["o_rejects"] + 4 * g * NUM_STATIC
    o["o_have"] = o["o_unres"] + 4 * g
    o["o_num_valid"] = o["o_have"] + 4 * g * im
    o["count_bytes"] = o["o_num_valid"] + 4 - o["o_rejects"]
    o["o_static_ok"] = o["o_rejects"] + o["count_bytes"]
    o["o_taint_ok"] = o["o_static_ok"] + gn
    o["o_nodeaff_ok"] = o["o_taint_ok"] + gn
    o["total"] = o["o_nodeaff_ok"] + gn
    return o


def _layout(caps: Capacities, g: int, wk: dict, enabled, active,
            lanes=None) -> tuple:
    """(the kernel's P1Layout, its plan, the output offsets)."""
    node_codec, _, pod_codec = codecs(caps)
    plan = plan_phase1(g, caps.nodes, active, caps.pod_images, lanes)
    offs = out_offsets(g, caps.nodes, caps.pod_images)
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
    v.update(plan._asdict())
    for i in range(NUM_STATIC):
        v[f"en{i}"] = bool(enabled[i])
    for key, name in _NODE_FIELD.items():
        off = node_codec._f32_off.get(name) or node_codec._i32_off[name]
        v[key] = off[0]
    for key, name in _POD_FIELD.items():
        off = pod_codec._f32_off.get(name) or pod_codec._i32_off[name]
        v[key] = off[0]
    v.update({k: offs[k] for k in _OFFSETS})
    return _Layout(**{k: int(x) for k, x in v.items()}), plan, offs


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
                      enabled, active, host_ok=None) -> Phase1:
    """The plain-torch twin: schedule_batch's ``per_pod`` for G rows, with
    the host verdicts ANDed in as at pipeline.py:1035-1038."""
    ct = unpack_cluster(cblobs, caps)
    _, _, pod_codec = codecs(caps)
    pod = pod_codec.unpack(Blobs(f32=prow_f32, i32=prow_i32), PodFeatures)
    masks = static_filters(ct, pod, wk, enabled, active)      # [5, G, N]
    valid = ct.node_valid
    static_ok = masks.all(dim=0) & valid[None] & pod.valid[:, None]
    if host_ok is not None:
        static_ok = static_ok & host_ok
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
                  enabled, active, host_ok=None) -> Phase1:
    """K1: the kernel for CUDA tensors, the twin for CPU tensors."""
    dev = cblobs.node_f32.device
    if dev.type == "cpu":
        return phase1_static_ref(cblobs, prow_f32, prow_i32, caps, wk,
                                 enabled, active, host_ok)
    if dev.type != "cuda":
        raise ValueError(f"phase1_static: unsupported device {dev}")
    return _phase1_kernel(cblobs, prow_f32, prow_i32, caps, wk, enabled,
                          active, host_ok)


class P1Launch:
    """K1's launch for one (caps, G, enabled filters, active features,
    well-known ids) key, checked and built once and cached: the argument
    struct, its plan and the C entry point. ``run``
    allocates the outputs as views of one buffer (kept by no launch:
    pipelined waves hold results) and launches; the C entry zeroes the
    counts with one memset."""

    def __init__(self, caps: Capacities, g: int, wk: dict, enabled, active,
                 dev: torch.device, lanes=None):
        node_codec, _, pod_codec = codecs(caps)
        self.dev, self.g, self.n = dev, g, caps.nodes
        self.shapes = ((caps.nodes, node_codec.f32_size),
                       (caps.nodes, node_codec.i32_size),
                       (g, pod_codec.f32_size), (g, pod_codec.i32_size))
        self.layout, self.plan, self.offs = _layout(caps, g, wk, enabled,
                                                    active, lanes)
        self.fn = KB.library("phase1_static").phase1_static_launch
        self.fn.argtypes = [ctypes.POINTER(_Layout)] + [ctypes.c_void_p] * 7
        self.fn.restype = ctypes.c_int

    def run(self, cblobs: ClusterBlobs, prow_f32: torch.Tensor,
            prow_i32: torch.Tensor, host_ok=None) -> Phase1:
        dev, g, n = self.dev, self.g, self.n
        for t, name, dtype, shape in (
                (cblobs.node_f32, "node_f32", torch.float32, self.shapes[0]),
                (cblobs.node_i32, "node_i32", torch.int32, self.shapes[1]),
                (prow_f32, "pod_f32", torch.float32, self.shapes[2]),
                (prow_i32, "pod_i32", torch.int32, self.shapes[3])):
            KB.require(t, name, dtype, shape, dev)
        if host_ok is not None:
            host_ok = host_ok.contiguous()
            KB.require(host_ok, "host_ok", torch.bool, (g, n), dev)
        o = self.offs
        buf = torch.empty((o["total"],), dtype=torch.uint8, device=dev)
        KB.check("phase1_static", self.fn(
            ctypes.byref(self.layout), cblobs.node_f32.data_ptr(),
            cblobs.node_i32.data_ptr(), prow_f32.data_ptr(),
            prow_i32.data_ptr(), buf.data_ptr(),
            None if host_ok is None else host_ok.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
        KB.LAUNCHES["phase1_static"] += 1
        gn = g * n
        floats = buf[:3 * 4 * gn].view(torch.float32).view(3, g, n)
        counts = buf[o["o_rejects"]:o["o_static_ok"]].view(torch.int32)
        masks = buf[o["o_static_ok"]:].view(torch.bool).view(3, g, n)
        return Phase1(masks[0], counts[:g * NUM_STATIC].view(g, NUM_STATIC),
                      floats[0], floats[1], floats[2],
                      counts[g * NUM_STATIC:g * NUM_COUNTS], masks[1],
                      masks[2])


_LAUNCHES: dict = {}


def launch_of(caps: Capacities, g: int, wk: dict, enabled, active,
              dev: torch.device, lanes=None) -> P1Launch:
    """The cached K1 launch of one key (built at its first use);
    ``lanes`` forces a pair's width (measurements)."""
    key = (caps, g, tuple(bool(x) for x in enabled), frozenset(active),
           int(wk["unschedulable_taint_key"]), int(wk["wildcard_ip"]), dev,
           lanes)
    got = _LAUNCHES.get(key)
    if got is None:
        got = _LAUNCHES[key] = P1Launch(caps, g, wk, enabled, active, dev,
                                        lanes)
    return got


def _phase1_kernel(cblobs, prow_f32, prow_i32, caps, wk, enabled, active,
                   host_ok=None) -> Phase1:
    launch = launch_of(caps, prow_f32.shape[0], wk, enabled, active,
                       cblobs.node_f32.device)
    return launch.run(cblobs, prow_f32, prow_i32, host_ok)
