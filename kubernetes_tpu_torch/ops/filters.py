"""Filter extension point as batched predicates (port of the JAX package's
ops/filters.py).

Each function evaluates one plugin's Filter for a pod batch against ALL
nodes at once and returns a [G, N] boolean accept mask: pod fields carry
the leading batch axis [G, ...], cluster fields the node axis [N, ...].

Reference algorithms:
- NodeName:           plugins/nodename/node_name.go (spec.nodeName == node)
- NodeUnschedulable:  plugins/nodeunschedulable (spec.unschedulable unless tolerated)
- TaintToleration:    plugins/tainttoleration/taint_toleration.go:111
- NodeAffinity:       plugins/nodeaffinity/node_affinity.go:206-228
- NodePorts:          plugins/nodeports (HostPortInfo conflict, types.go:1291)
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops import common as C
from kubernetes_tpu_torch.ops.features import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
    ClusterTensors,
    PodFeatures,
)
from kubernetes_tpu_torch.utils.interner import NONE


def node_name(ct: ClusterTensors, pod: PodFeatures) -> torch.Tensor:
    """spec.nodeName pin; unset matches every node."""
    want = pod.node_name_id[:, None]
    return (want == NONE) | (ct.node_name_id[None, :] == want)


def node_unschedulable(ct: ClusterTensors, pod: PodFeatures,
                       unschedulable_taint_key: int) -> torch.Tensor:
    """node.spec.unschedulable rejected unless the pod tolerates the
    node.kubernetes.io/unschedulable:NoSchedule taint."""
    n = ct.unschedulable.shape[0]
    dev = ct.unschedulable.device
    key = torch.full((n, 1), int(unschedulable_taint_key), dtype=torch.int32,
                     device=dev)
    val = torch.zeros((n, 1), dtype=torch.int32, device=dev)  # "" is id 0
    eff = torch.full((n, 1), EFFECT_NO_SCHEDULE, dtype=torch.int32,
                     device=dev)
    tolerated = C.tolerations_tolerate(
        pod.tol_valid, pod.tol_key, pod.tol_op, pod.tol_val, pod.tol_effect,
        key, val, eff)[:, :, 0]
    return ~ct.unschedulable[None, :] | tolerated


def taint_toleration(ct: ClusterTensors, pod: PodFeatures) -> torch.Tensor:
    """Any untolerated NoSchedule/NoExecute taint rejects the node."""
    tolerated = C.tolerations_tolerate(
        pod.tol_valid, pod.tol_key, pod.tol_op, pod.tol_val, pod.tol_effect,
        ct.taint_keys, ct.taint_vals, ct.taint_effects)  # [G, N, T]
    hard = ((ct.taint_effects == EFFECT_NO_SCHEDULE)
            | (ct.taint_effects == EFFECT_NO_EXECUTE))
    untolerated = (hard & (ct.taint_keys != NONE))[None] & ~tolerated
    return ~torch.any(untolerated, dim=-1)


def _take_cols(table: torch.Tensor, cols: torch.Tensor, fill
               ) -> torch.Tensor:
    """table: [N, K]; cols: [G, ...] i32 column indices (NONE = key unseen
    cluster-wide). Returns [G, N, ...] with ``fill`` where col is NONE."""
    k = table.shape[1]
    g = cols.shape[0]
    rest = tuple(cols.shape[1:])
    safe = cols.clamp(0, k - 1).reshape(g, -1).long()       # [G, M]
    out = table[:, safe]                                     # [N, G, M]
    out = out.permute(1, 0, 2).reshape((g, table.shape[0]) + rest)
    ok = (cols >= 0)[:, None]
    return torch.where(ok, out,
                       torch.tensor(fill, dtype=table.dtype,
                                    device=table.device))


def _selector_match(ct: ClusterTensors, cols, ops, is_field, vals, nums):
    """match[G, N, T, E] for node-selector expressions.

    cols/ops/is_field/nums: [G, T, E]; vals: [G, T, E, V]."""
    val = _take_cols(ct.label_col_vals, cols, NONE)         # [G, N, T, E]
    present = val != NONE
    # matchFields: the only supported key is metadata.name -> node name id
    name_val = ct.node_name_id[None, :, None, None].expand_as(val)
    fld = is_field[:, None]
    val = torch.where(fld, name_val, val)
    present = torch.where(fld, torch.ones_like(present), present)
    in_vals = C.isin(val, vals[:, None])                     # [G, N, T, E]
    num_val = _take_cols(ct.label_col_nums, cols, float("nan"))
    rhs = nums[:, None]
    num_ok = ~torch.isnan(num_val) & ~torch.isnan(rhs) & ~fld
    gt = num_ok & (num_val > rhs)
    lt = num_ok & (num_val < rhs)
    op = ops[:, None]
    false = torch.zeros_like(present)
    match = torch.where(op == OP_IN, present & in_vals,
            torch.where(op == OP_NOT_IN, ~(present & in_vals),
            torch.where(op == OP_EXISTS, present,
            torch.where(op == OP_DOES_NOT_EXIST, ~present,
            torch.where(op == OP_GT, present & gt,
            torch.where(op == OP_LT, present & lt, false))))))
    return match


def node_affinity(ct: ClusterTensors, pod: PodFeatures,
                  full: bool = True) -> torch.Tensor:
    """spec.nodeSelector (exact pairs, ANDed) AND required node affinity
    (OR over terms, AND within term). ``full=False`` is the
    "nodeaffinity_pin" launch feature: only the single-node pin compare."""
    pin = pod.aff_pin[:, None]
    pin_ok = (pin == NONE) | (ct.node_name_id[None, :] == pin)   # [G, N]
    if not full:
        return pin_ok
    node_val = _take_cols(ct.label_col_vals, pod.nodesel_cols, NONE)
    used_pair = (pod.nodesel_vals != NONE)[:, None]
    hit = node_val == pod.nodesel_vals[:, None]
    sel_ok = torch.all(hit | ~used_pair, dim=-1)                 # [G, N]
    match = _selector_match(ct, pod.sel_col, pod.sel_op, pod.sel_is_field,
                            pod.sel_vals, pod.sel_num)          # [G,N,T,E]
    used = pod.sel_op != NONE                                    # [G, T, E]
    term_ok = torch.all(match | ~used[:, None], dim=-1)          # [G, N, T]
    term_nonempty = torch.any(used, dim=-1)                      # [G, T]
    term_ok = term_ok & (term_nonempty & pod.sel_term_valid)[:, None]
    any_term = torch.any(pod.sel_term_valid, dim=-1)[:, None]    # [G, 1]
    affinity_ok = torch.where(any_term, torch.any(term_ok, dim=-1),
                              torch.ones_like(pin_ok))
    return sel_ok & affinity_ok & pin_ok


def node_ports(ct: ClusterTensors, pod: PodFeatures,
               wildcard_ip: int) -> torch.Tensor:
    """No requested host port may conflict with an occupied one
    (types.go:1291 CheckConflict: wildcard IP clashes with any IP)."""
    pp = pod.hp_port[:, None, None, :]        # [G, 1, 1, HP]
    pproto = pod.hp_proto[:, None, None, :]
    pip = pod.hp_ip[:, None, None, :]
    np_ = ct.port_nums[None, :, :, None]       # [1, N, P, 1]
    nproto = ct.port_protos[None, :, :, None]
    nip = ct.port_ips[None, :, :, None]
    same = (pp != NONE) & (np_ == pp) & (nproto == pproto)
    ip_clash = (nip == pip) | (nip == wildcard_ip) | (pip == wildcard_ip)
    conflict = same & ip_clash
    return ~torch.any(conflict.flatten(2), dim=-1)


def pod_pair_port_conflict(pods: PodFeatures,
                           wildcard_ip: int) -> torch.Tensor:
    """[B, B] bool: would pods i and j conflict on host ports if co-located?
    Wildcard-IP semantics as types.go:1291 CheckConflict.

    The commit scan uses it to keep NodePorts as-if-serial inside one
    launch: pod j may not land on a node where an earlier batch pod i with
    a conflicting hostPort was just committed."""
    pp = pods.hp_port
    a_port = pp[:, None, :, None]
    b_port = pp[None, :, None, :]
    a_proto = pods.hp_proto[:, None, :, None]
    b_proto = pods.hp_proto[None, :, None, :]
    a_ip = pods.hp_ip[:, None, :, None]
    b_ip = pods.hp_ip[None, :, None, :]
    same = (a_port != NONE) & (a_port == b_port) & (a_proto == b_proto)
    ip_clash = (a_ip == b_ip) | (a_ip == wildcard_ip) | (b_ip == wildcard_ip)
    return torch.any((same & ip_clash).flatten(2), dim=-1)
