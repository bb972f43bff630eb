"""Dense tensor schema for the device-resident cluster mirror and pod batches.

Port of the JAX package's ops/features.py: the schemas, encodings and
Capacities are the same, the unpacked structs hold torch views over the
f32/i32 blobs. The original notes follow.

This is the TPU-native replacement for the reference's per-cycle NodeInfo
snapshot (types.go:780): every string is interned to an int32 id host-side
(kubernetes_tpu_torch.utils.interner) and every set-valued field becomes a
fixed-capacity padded array, so all Filter/Score extension points are pure
integer/float tensor ops vmappable over the node axis and batchable over the
pod axis (SURVEY.md section 7.0).

Shape/capacity notes
- All capacities are static (XLA compiles once per capacity bucket); the
  mirror grows capacities by power-of-two re-bucketing when exceeded.
- Resource units: cpu in milli-cores, memory/ephemeral-storage in MiB
  (float32 is exact for Mi-granular values up to 16 TiB), extended resources
  in raw counts. The host cache keeps exact integers; int->f32 conversion is
  monotonic, so `request <= free` compares identically to the exact-integer
  comparison whenever both sides are Mi-granular.
- `NONE` (-1) marks empty padded slots everywhere.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_tpu_torch.utils.interner import NONE

# Packed as a required selector value for a nil LabelSelector
# (labels.Nothing() in the reference): no real id equals it, so the term
# matches no pod. Distinct from NONE (-1), which marks an unused slot.
IMPOSSIBLE = -2

# --- resource column layout ---

COL_CPU = 0       # milli-cores
COL_MEM = 1       # MiB
COL_EPH = 2       # MiB
COL_PODS = 3      # pod count
NUM_NATIVE_COLS = 4

# taint effect encoding
EFFECT_NO_SCHEDULE = 0
EFFECT_PREFER_NO_SCHEDULE = 1
EFFECT_NO_EXECUTE = 2
EFFECT_UNKNOWN = 3  # unrecognized effect string: ignored by every kernel
_EFFECTS = {"NoSchedule": EFFECT_NO_SCHEDULE,
            "PreferNoSchedule": EFFECT_PREFER_NO_SCHEDULE,
            "NoExecute": EFFECT_NO_EXECUTE}

# node-selector operator encoding
OP_IN = 0
OP_NOT_IN = 1
OP_EXISTS = 2
OP_DOES_NOT_EXIST = 3
OP_GT = 4
OP_LT = 5
OP_UNKNOWN = 6  # unrecognized operator: requirement matches nothing
_OPS = {"In": OP_IN, "NotIn": OP_NOT_IN, "Exists": OP_EXISTS,
        "DoesNotExist": OP_DOES_NOT_EXIST, "Gt": OP_GT, "Lt": OP_LT}

# toleration operator encoding
TOL_EQUAL = 0
TOL_EXISTS = 1


@dataclass(frozen=True)
class Capacities:
    """Static capacity configuration — part of the jit cache key."""

    nodes: int = 1024            # N
    ext_resources: int = 4       # extended/scalar resource columns
    label_cols: int = 32         # K: distinct node-label KEYS cluster-wide.
                                 # Labels are columnized: one dense value
                                 # column per key (TPU-native: no per-node
                                 # key-value pair scans in the kernels)
    pod_label_cols: int = 32     # Kp: distinct POD-label keys cluster-wide
                                 # (pod labels are columnized the same way for
                                 # inter-pod affinity / spread selector kernels)
    topo_cols: int = 8           # TK: topology keys in use by any pod's
                                 # (anti)affinity terms or spread constraints
    domains: int = 0             # per-topo-key compact domain-id space for
                                 # topology aggregation; 0 = same as nodes
    node_taints: int = 8         # T
    node_ports: int = 64         # P: occupied host ports per node
    node_images: int = 16        # I
    pods: int = 4096             # PT: pod-table slots (scheduled pods)
    pod_labels: int = 8          # PL
    sel_terms: int = 4           # node-selector terms per pod
    sel_exprs: int = 6           # expressions per term
    sel_vals: int = 4            # values per expression
    pref_terms: int = 8          # preferred scheduling terms
    tolerations: int = 8
    pod_ports: int = 8
    aff_terms: int = 4           # pod (anti)affinity terms per kind
    aff_ns: int = 4              # namespaces per affinity term (incl. the
                                 # pack-time namespaceSelector unroll, the
                                 # device analog of the reference's
                                 # mergeAffinityTermNamespacesIfNotEmpty,
                                 # interpodaffinity/plugin.go:123)
    aff_sel: int = 6             # selector EXPRESSIONS per affinity/spread
                                 # selector (matchLabels pairs + op-coded
                                 # matchExpressions + merged match/mismatch
                                 # LabelKeys requirements)
    aff_sel_vals: int = 4        # value ids per selector expression
    spread_constraints: int = 4
    pod_images: int = 8
    vocab: int = 65536           # interner id space mirrored to device

    @property
    def res_cols(self) -> int:
        return NUM_NATIVE_COLS + self.ext_resources

    @property
    def domain_cap(self) -> int:
        return self.domains or self.nodes


@dataclass
class ClusterTensors:
    """The HBM-resident cluster mirror: one row per node (+ the pod table).

    Device analog of the reference's Snapshot (snapshot.go:29); refreshed
    incrementally from the host cache's generation diff by backend.mirror.
    """

    # resources (f32): free = allocatable - requested, maintained exactly on host
    allocatable: torch.Tensor       # [N, R]
    free: torch.Tensor              # [N, R]
    nonzero_requested: torch.Tensor  # [N, 2] cpu/mem with 100m/200Mi defaults
    # resources reserved by nominated (preemptor) pods awaiting their victims
    # to exit — the fit check subtracts this (the device analog of
    # RunFilterPluginsWithNominatedPods' AddPod pass, runtime/framework.go:989)
    nominated_req: torch.Tensor     # [N, R]
    # validity + flags
    node_valid: torch.Tensor        # [N] bool
    unschedulable: torch.Tensor     # [N] bool
    node_name_id: torch.Tensor      # [N] i32
    # labels, columnized: one column per distinct label KEY cluster-wide.
    # label_col_vals[n, k] = value id of key k on node n (NONE if absent);
    # label_col_nums = numeric parse of the value (NaN if absent/non-int,
    # for Gt/Lt without a vocab gather).
    label_col_vals: torch.Tensor    # [N, K] i32
    label_col_nums: torch.Tensor    # [N, K] f32
    # topology domains: for each registered topology key tk, the compact
    # per-key domain id of the node's label value (NONE = label absent).
    # Two nodes are in the same topology domain under tk iff their ids match.
    # This is the scatter/gather substrate for InterPodAffinity and
    # PodTopologySpread (SURVEY.md §7.1 step 5).
    topo_dom: torch.Tensor          # [N, TK] i32
    # taints
    taint_keys: torch.Tensor        # [N, T] i32
    taint_vals: torch.Tensor        # [N, T] i32
    taint_effects: torch.Tensor     # [N, T] i32
    # occupied host ports
    port_ips: torch.Tensor          # [N, P] i32
    port_protos: torch.Tensor       # [N, P] i32
    port_nums: torch.Tensor         # [N, P] i32 (-1 empty)
    # images present on node
    image_ids: torch.Tensor         # [N, I] i32
    image_sizes: torch.Tensor       # [N, I] f32 MiB
    # pod table (scheduled pods, for inter-pod affinity / topology spread).
    # Labels columnized over pod-label columns [Kp]; each term group stores
    # (topo tk-index, selected namespaces + all-namespaces flag, op-coded
    # selector expressions); the preferred groups add weights. Term slots
    # with tk = NONE are unused; expression slots with op = NONE are unused.
    # Full LabelSelector semantics (framework/types.go:537 AffinityTerm):
    # matchLabels pairs pack as In exprs, matchExpressions pack op-coded
    # (In/NotIn/Exists/DoesNotExist), match/mismatchLabelKeys merge as
    # In/NotIn exprs (strategy.go applyMatchLabelKeysAndMismatchLabelKeys),
    # namespaceSelector unrolls into the ns list at pack time (empty
    # selector => ns_all).
    pod_valid: torch.Tensor         # [PT] bool
    pod_node: torch.Tensor          # [PT] i32 node row index
    pod_ns: torch.Tensor            # [PT] i32 namespace id
    pod_uid: torch.Tensor           # [PT] i32 interned pod uid (self-exclusion:
                                 # a pod never matches its own table entry)
    pod_nominated: torch.Tensor     # [PT] bool: nominated-not-yet-bound pod —
                                 # counts for anti-affinity, excluded from
                                 # required-affinity presence and scoring
                                 # (the dual-pass rule of framework.go:989)
    pt_label_vals: torch.Tensor     # [PT, Kp] i32 label value per pod-label column
    # REQUIRED anti-affinity terms (satisfyExistingPodsAntiAffinity)
    pod_anti_tk: torch.Tensor       # [PT, A] i32 topo-key index (-1 = unused term)
    pod_anti_ns: torch.Tensor       # [PT, A, NS] i32 namespace ids the term selects
    pod_anti_ns_all: torch.Tensor   # [PT, A] bool: empty namespaceSelector
    pod_anti_sel_cols: torch.Tensor  # [PT, A, MS] i32 pod-label column
    pod_anti_sel_ops: torch.Tensor   # [PT, A, MS] i32 op id (-1 = unused expr)
    pod_anti_sel_vals: torch.Tensor  # [PT, A, MS, V2] i32 value ids
    # REQUIRED affinity terms (hardPodAffinityWeight scoring)
    pod_aff_tk: torch.Tensor        # [PT, A] i32
    pod_aff_ns: torch.Tensor        # [PT, A, NS] i32
    pod_aff_ns_all: torch.Tensor    # [PT, A] bool
    pod_aff_sel_cols: torch.Tensor  # [PT, A, MS] i32
    pod_aff_sel_ops: torch.Tensor   # [PT, A, MS] i32
    pod_aff_sel_vals: torch.Tensor  # [PT, A, MS, V2] i32
    # PREFERRED affinity / anti-affinity terms (scoring)
    pod_paff_tk: torch.Tensor       # [PT, A] i32
    pod_paff_weight: torch.Tensor   # [PT, A] i32
    pod_paff_ns: torch.Tensor       # [PT, A, NS] i32
    pod_paff_ns_all: torch.Tensor   # [PT, A] bool
    pod_paff_sel_cols: torch.Tensor  # [PT, A, MS] i32
    pod_paff_sel_ops: torch.Tensor   # [PT, A, MS] i32
    pod_paff_sel_vals: torch.Tensor  # [PT, A, MS, V2] i32
    pod_panti_tk: torch.Tensor      # [PT, A] i32
    pod_panti_weight: torch.Tensor  # [PT, A] i32
    pod_panti_ns: torch.Tensor      # [PT, A, NS] i32
    pod_panti_ns_all: torch.Tensor  # [PT, A] bool
    pod_panti_sel_cols: torch.Tensor  # [PT, A, MS] i32
    pod_panti_sel_ops: torch.Tensor   # [PT, A, MS] i32
    pod_panti_sel_vals: torch.Tensor  # [PT, A, MS, V2] i32


def node_schema(caps: Capacities) -> dict[str, tuple[tuple[int, ...], str]]:
    """Per-node-row field schema for the blob codec (leading N axis implied)."""
    r = caps.res_cols
    return {
        "allocatable": ((r,), "f32"),
        "free": ((r,), "f32"),
        "nonzero_requested": ((2,), "f32"),
        "nominated_req": ((r,), "f32"),
        "label_col_nums": ((caps.label_cols,), "f32"),
        "image_sizes": ((caps.node_images,), "f32"),
        "node_valid": ((), "bool"),
        "unschedulable": ((), "bool"),
        "node_name_id": ((), "i32"),
        "label_col_vals": ((caps.label_cols,), "i32"),
        "topo_dom": ((caps.topo_cols,), "i32"),
        "taint_keys": ((caps.node_taints,), "i32"),
        "taint_vals": ((caps.node_taints,), "i32"),
        "taint_effects": ((caps.node_taints,), "i32"),
        "port_ips": ((caps.node_ports,), "i32"),
        "port_protos": ((caps.node_ports,), "i32"),
        "port_nums": ((caps.node_ports,), "i32"),
        "image_ids": ((caps.node_images,), "i32"),
    }


def pod_table_schema(caps: Capacities) -> dict[str, tuple[tuple[int, ...], str]]:
    """Per-pod-slot schema for the scheduled-pod table (leading PT axis implied)."""
    a, ns, ms, v2 = caps.aff_terms, caps.aff_ns, caps.aff_sel, caps.aff_sel_vals
    d = {
        "pod_valid": ((), "bool"),
        "pod_node": ((), "i32"),
        "pod_ns": ((), "i32"),
        "pod_uid": ((), "i32"),
        "pod_nominated": ((), "bool"),
        "pt_label_vals": ((caps.pod_label_cols,), "i32"),
    }
    for g in ("anti", "aff", "paff", "panti"):
        d[f"pod_{g}_tk"] = ((a,), "i32")
        if g in ("paff", "panti"):
            d[f"pod_{g}_weight"] = ((a,), "i32")
        d[f"pod_{g}_ns"] = ((a, ns), "i32")
        d[f"pod_{g}_ns_all"] = ((a,), "bool")
        d[f"pod_{g}_sel_cols"] = ((a, ms), "i32")
        d[f"pod_{g}_sel_ops"] = ((a, ms), "i32")
        d[f"pod_{g}_sel_vals"] = ((a, ms, v2), "i32")
    return d


def pod_schema(caps: Capacities) -> dict[str, tuple[tuple[int, ...], str]]:
    """Per-pending-pod PodFeatures schema (batch axis B implied)."""
    r = caps.res_cols
    T, E, V = caps.sel_terms, caps.sel_exprs, caps.sel_vals
    PW, TO, HP = caps.pref_terms, caps.tolerations, caps.pod_ports
    A, NS, MS, C = caps.aff_terms, caps.aff_ns, caps.aff_sel, caps.spread_constraints
    V2 = caps.aff_sel_vals
    PL, IM = caps.pod_labels, caps.pod_images
    d = {
        "req": ((r,), "f32"),
        "nonzero_req": ((2,), "f32"),
        "num_containers": ((), "f32"),
        "sel_num": ((T, E), "f32"),
        "pref_num": ((PW, E), "f32"),
        "priority": ((), "i32"),
        "ns": ((), "i32"),
        "name_id": ((), "i32"),
        "uid_id": ((), "i32"),
        "nominated_row": ((), "i32"),
        "plabel_vals": ((caps.pod_label_cols,), "i32"),
        "nodesel_cols": ((PL,), "i32"),
        "nodesel_vals": ((PL,), "i32"),
        "aff_pin": ((), "i32"),
        "sel_term_valid": ((T,), "bool"),
        "sel_col": ((T, E), "i32"),
        "sel_op": ((T, E), "i32"),
        "sel_is_field": ((T, E), "bool"),
        "sel_vals": ((T, E, V), "i32"),
        "pref_weight": ((PW,), "i32"),
        "pref_col": ((PW, E), "i32"),
        "pref_op": ((PW, E), "i32"),
        "pref_is_field": ((PW, E), "bool"),
        "pref_vals": ((PW, E, V), "i32"),
        "tol_key": ((TO,), "i32"),
        "tol_op": ((TO,), "i32"),
        "tol_val": ((TO,), "i32"),
        "tol_effect": ((TO,), "i32"),
        "tol_valid": ((TO,), "bool"),
        "hp_ip": ((HP,), "i32"),
        "hp_proto": ((HP,), "i32"),
        "hp_port": ((HP,), "i32"),
        "aff_self_match": ((), "bool"),
        "tsc_tk": ((C,), "i32"),
        "tsc_max_skew": ((C,), "i32"),
        "tsc_hard": ((C,), "bool"),
        "tsc_min_domains": ((C,), "i32"),
        "tsc_sel_cols": ((C, MS), "i32"),
        "tsc_sel_ops": ((C, MS), "i32"),
        "tsc_sel_vals": ((C, MS, V2), "i32"),
        "tsc_honor_affinity": ((C,), "bool"),
        "tsc_honor_taints": ((C,), "bool"),
        "image_ids": ((IM,), "i32"),
        "node_name_id": ((), "i32"),
        "valid": ((), "bool"),
    }
    for g in ("aff", "anti", "paff", "panti"):
        d[f"{g}_tk"] = ((A,), "i32")
        if g in ("paff", "panti"):
            d[f"{g}_weight"] = ((A,), "i32")
        d[f"{g}_ns"] = ((A, NS), "i32")
        d[f"{g}_ns_all"] = ((A,), "bool")
        d[f"{g}_sel_cols"] = ((A, MS), "i32")
        d[f"{g}_sel_ops"] = ((A, MS), "i32")
        d[f"{g}_sel_vals"] = ((A, MS, V2), "i32")
    return d


@dataclass
class PodFeatures:
    """One pending pod, fully interned/padded. Batched by stacking (axis 0)."""

    # resources
    req: torch.Tensor               # [R] f32
    nonzero_req: torch.Tensor       # [2] f32
    num_containers: torch.Tensor    # f32 scalar (incl. init; image-locality threshold)
    priority: torch.Tensor          # i32 scalar
    ns: torch.Tensor                # i32 scalar namespace id
    name_id: torch.Tensor           # i32 scalar (pod name, for debugging)
    uid_id: torch.Tensor            # i32 scalar interned uid (self-exclusion
                                 # vs the pod table, incl. own nomination)
    nominated_row: torch.Tensor     # i32 scalar: node row this pod is nominated
                                 # on (-1 none); its own reservation is added
                                 # back to free on that row
    plabel_vals: torch.Tensor       # [Kp] i32 own labels over pod-label columns
    # spec.nodeSelector: exact (label-column, value) pairs, ANDed; a pair on a
    # key no node carries packs col=NONE (matches nothing). Unused slots have
    # val=NONE.
    nodesel_cols: torch.Tensor      # [PL] i32 label-column index (-1 = key unseen)
    nodesel_vals: torch.Tensor      # [PL] i32 (-1 = unused slot)
    # required node affinity, PIN form: the whole required clause reduces
    # to one matchFields metadata.name In [v] term (the daemonset-controller
    # shape) — packed as the target's interned name so the filter is ONE
    # [N] compare instead of the [N, T, E, V] selector kernels (NONE = no
    # pin; the general form below then applies)
    aff_pin: torch.Tensor           # i32 scalar (-1 = no pin)
    # required node affinity: OR over terms, AND within term. Expressions
    # reference label COLUMNS (host-resolved); unused slots have op=NONE.
    sel_term_valid: torch.Tensor    # [T] bool
    sel_col: torch.Tensor           # [T, E] i32 (-1 = key unseen cluster-wide)
    sel_op: torch.Tensor            # [T, E] i32 (-1 = unused expr)
    sel_is_field: torch.Tensor      # [T, E] bool (metadata.name matchFields)
    sel_vals: torch.Tensor          # [T, E, V] i32
    sel_num: torch.Tensor           # [T, E] f32 (rhs for Gt/Lt)
    # preferred node affinity
    pref_weight: torch.Tensor       # [PW] i32 (0 = unused)
    pref_col: torch.Tensor          # [PW, E] i32
    pref_op: torch.Tensor           # [PW, E] i32
    pref_is_field: torch.Tensor     # [PW, E] bool
    pref_vals: torch.Tensor         # [PW, E, V] i32
    pref_num: torch.Tensor          # [PW, E] f32
    # tolerations
    tol_key: torch.Tensor           # [TO] i32 (-1 = unused; key NONE+valid uses empty id 0)
    tol_op: torch.Tensor            # [TO] i32 TOL_EQUAL/TOL_EXISTS
    tol_val: torch.Tensor           # [TO] i32
    tol_effect: torch.Tensor        # [TO] i32 (-1 = all effects)
    tol_valid: torch.Tensor         # [TO] bool
    # requested host ports
    hp_ip: torch.Tensor             # [HP] i32
    hp_proto: torch.Tensor          # [HP] i32
    hp_port: torch.Tensor           # [HP] i32 (-1 unused)
    # pod (anti)affinity terms — required and preferred, both directions.
    # *_tk is the registered topology-key index (NONE = unused term slot);
    # selectors are op-coded expressions over pod-label columns (full
    # LabelSelector semantics; op NONE = unused expr slot); namespaces are
    # an explicit id list (namespaceSelector unrolled at pack time) plus an
    # all-namespaces flag for the empty selector.
    aff_self_match: torch.Tensor    # bool: pod matches ALL its own required
                                 # affinity terms (first-pod-of-group rule,
                                 # filtering.go satisfyPodAffinity)
    aff_tk: torch.Tensor            # [A] i32 required affinity
    aff_ns: torch.Tensor            # [A, NS] i32
    aff_ns_all: torch.Tensor        # [A] bool
    aff_sel_cols: torch.Tensor      # [A, MS] i32
    aff_sel_ops: torch.Tensor       # [A, MS] i32
    aff_sel_vals: torch.Tensor      # [A, MS, V2] i32
    anti_tk: torch.Tensor           # [A] i32 required anti-affinity
    anti_ns: torch.Tensor           # [A, NS] i32
    anti_ns_all: torch.Tensor       # [A] bool
    anti_sel_cols: torch.Tensor     # [A, MS] i32
    anti_sel_ops: torch.Tensor      # [A, MS] i32
    anti_sel_vals: torch.Tensor     # [A, MS, V2] i32
    paff_tk: torch.Tensor           # [A] i32 preferred affinity
    paff_weight: torch.Tensor       # [A] i32
    paff_ns: torch.Tensor           # [A, NS] i32
    paff_ns_all: torch.Tensor       # [A] bool
    paff_sel_cols: torch.Tensor     # [A, MS] i32
    paff_sel_ops: torch.Tensor      # [A, MS] i32
    paff_sel_vals: torch.Tensor     # [A, MS, V2] i32
    panti_tk: torch.Tensor          # [A] i32 preferred anti-affinity
    panti_weight: torch.Tensor      # [A] i32
    panti_ns: torch.Tensor          # [A, NS] i32
    panti_ns_all: torch.Tensor      # [A] bool
    panti_sel_cols: torch.Tensor    # [A, MS] i32
    panti_sel_ops: torch.Tensor     # [A, MS] i32
    panti_sel_vals: torch.Tensor    # [A, MS, V2] i32
    # topology spread constraints
    tsc_tk: torch.Tensor            # [C] i32 (-1 unused)
    tsc_max_skew: torch.Tensor      # [C] i32
    tsc_hard: torch.Tensor          # [C] bool (DoNotSchedule)
    tsc_min_domains: torch.Tensor   # [C] i32 (0 = unset)
    tsc_sel_cols: torch.Tensor      # [C, MS] i32
    tsc_sel_ops: torch.Tensor       # [C, MS] i32
    tsc_sel_vals: torch.Tensor      # [C, MS, V2] i32
    tsc_honor_affinity: torch.Tensor  # [C] bool (nodeAffinityPolicy == Honor)
    tsc_honor_taints: torch.Tensor    # [C] bool (nodeTaintsPolicy == Honor)
    # images referenced by containers
    image_ids: torch.Tensor         # [IM] i32
    # misc
    node_name_id: torch.Tensor      # i32 scalar: spec.nodeName pin (-1 = unset)
    valid: torch.Tensor             # bool scalar: padding rows in a batch are False


@dataclass
class ClusterBlobs:
    """Transfer form of ClusterTensors: three dense buffers + vocab table."""

    node_f32: torch.Tensor   # [N, nf]
    node_i32: torch.Tensor   # [N, ni]
    pods_i32: torch.Tensor   # [PT, pi] (pod table has no f32 fields)


@dataclass
class PodBlobs:
    """Transfer form of a PodFeatures batch."""

    f32: torch.Tensor        # [B, pf]
    i32: torch.Tensor        # [B, pi]


def _codecs(caps: Capacities):
    from kubernetes_tpu_torch.ops.blobs import BlobCodec

    return (BlobCodec(node_schema(caps)), BlobCodec(pod_table_schema(caps)),
            BlobCodec(pod_schema(caps)))


_codec_cache: dict[Capacities, tuple] = {}


def codecs(caps: Capacities):
    c = _codec_cache.get(caps)
    if c is None:
        c = _codec_cache[caps] = _codecs(caps)
    return c


def unpack_cluster(blobs: ClusterBlobs, caps: Capacities) -> ClusterTensors:
    """Slice the blobs into the full ClusterTensors view: torch views over
    the resident blobs (no copies)."""
    from kubernetes_tpu_torch.ops.blobs import Blobs

    node_codec, table_codec, _ = codecs(caps)
    fields = node_codec.unpack(Blobs(f32=blobs.node_f32, i32=blobs.node_i32))
    empty = torch.zeros(blobs.pods_i32.shape[:-1] + (0,),
                        dtype=torch.float32, device=blobs.pods_i32.device)
    fields.update(table_codec.unpack(Blobs(f32=empty, i32=blobs.pods_i32)))
    return ClusterTensors(**fields)


def unpack_pods(blobs: PodBlobs, caps: Capacities,
                fields: tuple[str, ...] | None = None,
                template: PodBlobs | None = None) -> PodFeatures:
    """Full-schema unpack, or — when ``fields`` is given — a subset unpack
    where absent fields broadcast from the 1-row ``template`` blob (see
    BlobCodec.unpack_subset; the transfer-thrift path)."""
    from kubernetes_tpu_torch.ops.blobs import Blobs

    _, _, pod_codec = codecs(caps)
    if fields is None:
        return pod_codec.unpack(Blobs(f32=blobs.f32, i32=blobs.i32),
                                PodFeatures)
    return pod_codec.unpack_subset(
        Blobs(f32=blobs.f32, i32=blobs.i32), fields,
        Blobs(f32=template.f32, i32=template.i32), PodFeatures)


def effect_id(effect: str) -> int:
    """Unknown effect strings map to EFFECT_UNKNOWN: the taint filter only
    acts on NoSchedule/NoExecute, so a malformed node object degrades to
    "effect ignored" instead of killing the pack (the reference tolerates
    arbitrary effect strings)."""
    return _EFFECTS.get(effect, EFFECT_UNKNOWN)


def op_id(op: str) -> int:
    """Unknown operators map to OP_UNKNOWN, which matches nothing in
    _selector_match — the device analog of the reference's
    selector-parse-error → no-match behavior."""
    return _OPS.get(op, OP_UNKNOWN)


# nodesel/PodFeatures helpers live in backend.mirror (the packer); this module
# only defines the schema and encodings so ops/* stay free of host imports.
