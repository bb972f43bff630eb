"""The scheduler-facing object model.

A from-scratch, Python-native equivalent of the slice of ``k8s.io/api/core/v1``
the kube-scheduler consumes (Pod, Node, affinity/taint/spread types) plus
``scheduling.k8s.io/v1`` PriorityClass. Field coverage follows what the
reference scheduler's plugins actually read (see SURVEY.md section 2.4);
reference type definitions live in
kubernetes/staging/src/k8s.io/api/core/v1/types.go.

Objects are plain mutable dataclasses; the hub/cache layers treat stored
objects as immutable and replace them wholesale on update (copy-on-write via
``clone()``), which is what makes the generation-diffed device mirror sound.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Optional

# --- well-known constants -------------------------------------------------

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# taint effects
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# selector / toleration operators
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"
OP_EQUAL = "Equal"

# topology spread UnsatisfiableConstraintAction
DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

# NodeInclusionPolicy
POLICY_HONOR = "Honor"
POLICY_IGNORE = "Ignore"

# well-known topology label keys
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"

# pod phases
PHASE_PENDING = "Pending"
PHASE_RUNNING = "Running"
PHASE_SUCCEEDED = "Succeeded"
PHASE_FAILED = "Failed"

# pod condition types
POD_SCHEDULED = "PodScheduled"

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


# --- metadata ---------------------------------------------------------------


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = field(default_factory=time.time)
    resource_version: int = 0
    deletion_timestamp: Optional[float] = None


# --- label selectors (metav1.LabelSelector) ---------------------------------


@dataclass
class LabelSelectorRequirement:
    key: str
    operator: str  # In / NotIn / Exists / DoesNotExist
    values: list[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: dict[str, str] = field(default_factory=dict)
    match_expressions: list[LabelSelectorRequirement] = field(default_factory=list)


# --- node selectors (v1.NodeSelector) ---------------------------------------


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str  # In / NotIn / Exists / DoesNotExist / Gt / Lt
    values: list[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    match_expressions: list[NodeSelectorRequirement] = field(default_factory=list)
    match_fields: list[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class NodeSelector:
    node_selector_terms: list[NodeSelectorTerm] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class NodeAffinity:
    required: Optional[NodeSelector] = None  # requiredDuringSchedulingIgnoredDuringExecution
    preferred: list[PreferredSchedulingTerm] = field(default_factory=list)


# --- pod (anti)affinity ------------------------------------------------------


@dataclass
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: list[str] = field(default_factory=list)
    namespace_selector: Optional[LabelSelector] = None
    match_label_keys: list[str] = field(default_factory=list)
    mismatch_label_keys: list[str] = field(default_factory=list)


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm


@dataclass
class PodAffinity:
    required: list[PodAffinityTerm] = field(default_factory=list)
    preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required: list[PodAffinityTerm] = field(default_factory=list)
    preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


# --- taints & tolerations -----------------------------------------------------


@dataclass
class Taint:
    # Field order matches v1.Taint (types.go): Key, Value, Effect.
    key: str
    value: str = ""
    effect: str = ""  # NoSchedule / PreferNoSchedule / NoExecute


@dataclass
class Toleration:
    key: str = ""  # empty + Exists tolerates everything
    operator: str = OP_EQUAL  # Exists / Equal
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """Reference: k8s.io/api/core/v1/toleration.go ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == OP_EXISTS:
            return True
        # Equal (or empty operator, which defaults to Equal)
        return self.value == taint.value


# --- topology spread ----------------------------------------------------------


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule / ScheduleAnyway
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None
    node_affinity_policy: str = POLICY_HONOR
    node_taints_policy: str = POLICY_IGNORE
    match_label_keys: list[str] = field(default_factory=list)


# --- containers & resources -----------------------------------------------------


@dataclass
class ResourceRequirements:
    requests: dict[str, str] = field(default_factory=dict)
    limits: dict[str, str] = field(default_factory=dict)


@dataclass
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = ""
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: list[ContainerPort] = field(default_factory=list)
    restart_policy: Optional[str] = None  # "Always" on an init container = sidecar


# --- pod ------------------------------------------------------------------------


@dataclass
class PodSchedulingGate:
    name: str


@dataclass
class PodSpec:
    node_name: str = ""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    overhead: dict[str, str] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: list[Toleration] = field(default_factory=list)
    topology_spread_constraints: list[TopologySpreadConstraint] = field(default_factory=list)
    priority: Optional[int] = None
    priority_class_name: str = ""
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    scheduling_gates: list[PodSchedulingGate] = field(default_factory=list)
    host_network: bool = False
    volumes: list = field(default_factory=list)
    resource_claims: list = field(default_factory=list)  # PodResourceClaim


@dataclass
class PodCondition:
    type: str
    status: str  # "True" / "False" / "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class PodStatus:
    phase: str = PHASE_PENDING
    conditions: list[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""
    # pod.status.resourceClaimStatuses: generated claim name per
    # resourceClaimTemplateName entry (written by the resourceclaim
    # controller, read by the DRA plugin's claim-ref resolution)
    resource_claim_statuses: dict[str, str] = field(default_factory=dict)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def priority(self) -> int:
        return self.spec.priority if self.spec.priority is not None else 0

    def clone(self) -> "Pod":
        """Copy safe for *assigning* top-level metadata/spec/status fields (the
        only mutations the scheduler performs: nodeName, conditions,
        nominatedNodeName, labels). Deeper structures (containers, affinity,
        tolerations...) are shared and must never be mutated in place.

        Shallow ``copy.copy`` per level instead of dataclasses.replace: the
        clone runs once per commit and per hub write — replace() re-derives
        the field list every call and was the hottest line of the commit
        path."""
        import copy as _copy

        c = _copy.copy(self)
        c.metadata = _copy.copy(self.metadata)
        c.metadata.labels = dict(self.metadata.labels)
        c.spec = _copy.copy(self.spec)
        c.status = _copy.copy(self.status)
        c.status.conditions = list(self.status.conditions)
        # containers/overhead are shared, so the parsed resource-request memo
        # (api.resources.pod_request) stays valid for the copy
        memo = self.__dict__.get("_request_memo")
        if memo is not None:
            c._request_memo = memo
        return c


# --- node -------------------------------------------------------------------------


@dataclass
class ContainerImage:
    names: list[str] = field(default_factory=list)
    size_bytes: int = 0


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: list[Taint] = field(default_factory=list)


@dataclass
class NodeStatus:
    capacity: dict[str, str] = field(default_factory=dict)
    allocatable: dict[str, str] = field(default_factory=dict)
    images: list[ContainerImage] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    def clone(self) -> "Node":
        """Same contract as Pod.clone(): top-level field assignment only;
        nested structures shared, never mutated in place."""
        return replace(
            self,
            metadata=replace(self.metadata, labels=dict(self.metadata.labels)),
            spec=replace(self.spec, taints=list(self.spec.taints)),
            status=replace(self.status),
        )


# --- namespace -----------------------------------------------------------------------


@dataclass
class Namespace:
    """v1.Namespace (labels are what the scheduler consumes: affinity
    namespaceSelector unrolling, interpodaffinity/plugin.go:123)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    @property
    def name(self) -> str:
        return self.metadata.name


# --- pod disruption budget ------------------------------------------------------------


@dataclass
class PodDisruptionBudget:
    """policy/v1 PodDisruptionBudget — the slice preemption consumes:
    selector + status.disruptionsAllowed (preemption.go filterPodsWithPDB
    reads DisruptionsAllowed to rank candidates by violation count)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None
    disruptions_allowed: int = 0  # status.disruptionsAllowed


# --- volumes (the slices the volume plugin family consumes) --------------------------


@dataclass
class PersistentVolumeClaimVolumeSource:
    claim_name: str
    read_only: bool = False


@dataclass
class Volume:
    """v1.Volume — the sources the scheduler's volume plugins inspect:
    PVC references (zone/limits/binding) and the directly-attached disk
    types VolumeRestrictions guards (volume_restrictions.go:77-120)."""

    name: str = ""
    persistent_volume_claim: Optional[PersistentVolumeClaimVolumeSource] = None
    gce_pd_name: str = ""        # GCEPersistentDisk.PDName
    aws_ebs_volume_id: str = ""  # AWSElasticBlockStore.VolumeID
    iscsi_iqn: str = ""          # ISCSI.IQN + lun as "iqn:lun"
    rbd_image: str = ""          # RBD "pool:image"
    read_only: bool = False


# access modes (core/types.go)
READ_WRITE_ONCE = "ReadWriteOnce"
READ_ONLY_MANY = "ReadOnlyMany"
READ_WRITE_MANY = "ReadWriteMany"
READ_WRITE_ONCE_POD = "ReadWriteOncePod"


@dataclass
class PersistentVolumeClaimSpec:
    access_modes: list[str] = field(default_factory=list)
    storage_class_name: str = ""
    volume_name: str = ""            # bound PV name ("" = unbound)
    requests: dict[str, str] = field(default_factory=dict)  # {"storage": ...}


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = "Pending"           # Pending / Bound / Lost


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(
        default_factory=PersistentVolumeClaimSpec)
    status: PersistentVolumeClaimStatus = field(
        default_factory=PersistentVolumeClaimStatus)

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def clone(self) -> "PersistentVolumeClaim":
        import copy

        return copy.deepcopy(self)


@dataclass
class ClaimRef:
    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class PersistentVolumeSpec:
    capacity: dict[str, str] = field(default_factory=dict)  # {"storage": ..}
    access_modes: list[str] = field(default_factory=list)
    storage_class_name: str = ""
    claim_ref: Optional[ClaimRef] = None
    # volume_binding.go checks PV.Spec.NodeAffinity.Required against node
    node_affinity: Optional["NodeSelector"] = None
    csi_driver: str = ""             # CSI.Driver (NodeVolumeLimits)


@dataclass
class PersistentVolumeStatus:
    phase: str = "Available"         # Available / Bound / Released


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    status: PersistentVolumeStatus = field(
        default_factory=PersistentVolumeStatus)

    def clone(self) -> "PersistentVolume":
        import copy

        return copy.deepcopy(self)


VOLUME_BINDING_IMMEDIATE = "Immediate"
VOLUME_BINDING_WAIT = "WaitForFirstConsumer"


@dataclass
class TopologySelectorTerm:
    """StorageClass.allowedTopologies entry: every requirement must match
    the node's labels (v1helper.MatchTopologySelectorTerms)."""

    match_label_expressions: list["TopologySelectorLabelRequirement"] = \
        field(default_factory=list)


@dataclass
class TopologySelectorLabelRequirement:
    key: str = ""
    values: list[str] = field(default_factory=list)


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = VOLUME_BINDING_IMMEDIATE
    allowed_topologies: list[TopologySelectorTerm] = \
        field(default_factory=list)


@dataclass
class CSIStorageCapacity:
    """storage.k8s.io CSIStorageCapacity: a CSI driver's published
    capacity for one storage class in one topology segment — the input to
    VolumeBinding's dynamic-provisioning capacity check and Score
    (volumebinding/binder.go hasEnoughCapacity)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: str = ""
    # label selector over NODE labels delimiting the topology segment;
    # None = the whole cluster
    node_topology: Optional[LabelSelector] = None
    capacity: str = "0"


# --- dynamic resource allocation (resource.k8s.io slices/claims) ----------------------


@dataclass
class PodResourceClaim:
    """pod.spec.resourceClaims entry: a named reference to a
    ResourceClaim — direct by name, or via a ResourceClaimTemplate the
    resourceclaim controller instantiates per pod."""

    name: str
    resource_claim_name: str = ""
    resource_claim_template_name: str = ""


@dataclass
class DeviceSelector:
    """resourceclaim selectors entry: a CEL expression over one device's
    driver/attributes/capacity (resource.k8s.io CELDeviceSelector;
    evaluated by utils.cel)."""

    cel_expression: str = ""


ALLOCATION_MODE_EXACT = "ExactCount"
ALLOCATION_MODE_ALL = "All"


@dataclass
class DeviceSubRequest:
    """One alternative of a firstAvailable request (DRAPrioritizedList):
    tried in order, first satisfiable wins."""

    name: str
    device_class_name: str = ""
    count: int = 1
    allocation_mode: str = ALLOCATION_MODE_EXACT
    selectors: list[DeviceSelector] = field(default_factory=list)


@dataclass
class DeviceRequest:
    """resourceclaim.spec.devices.requests entry: ExactCount/All modes,
    CEL selectors, adminAccess, or a firstAvailable alternatives list
    (exactly one of deviceClassName / firstAvailable is set)."""

    name: str
    device_class_name: str = ""
    count: int = 1
    allocation_mode: str = ALLOCATION_MODE_EXACT
    selectors: list[DeviceSelector] = field(default_factory=list)
    admin_access: bool = False
    first_available: list[DeviceSubRequest] = field(default_factory=list)


@dataclass
class DeviceConstraint:
    """spec.devices.constraints entry: all devices allocated for the
    listed requests (all requests when empty) must carry the SAME value
    of match_attribute."""

    requests: list[str] = field(default_factory=list)
    match_attribute: str = ""


@dataclass
class DeviceAllocationResult:
    request: str = ""
    driver: str = ""
    pool: str = ""
    device: str = ""
    admin_access: bool = False


@dataclass
class AllocationResult:
    node_name: str = ""
    devices: list[DeviceAllocationResult] = field(default_factory=list)


@dataclass
class ResourceClaimStatus:
    allocation: Optional[AllocationResult] = None
    reserved_for: list[str] = field(default_factory=list)   # pod uids


@dataclass
class ResourceClaimSpec:
    device_requests: list[DeviceRequest] = field(default_factory=list)
    constraints: list[DeviceConstraint] = field(default_factory=list)


@dataclass
class ResourceClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceClaimSpec = field(default_factory=ResourceClaimSpec)
    status: ResourceClaimStatus = field(default_factory=ResourceClaimStatus)

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def clone(self) -> "ResourceClaim":
        import copy

        return copy.deepcopy(self)


@dataclass
class ResourceClaimTemplate:
    """resource.k8s.io ResourceClaimTemplate: the spec stamped into a
    fresh per-pod ResourceClaim by the resourceclaim controller."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceClaimSpec = field(default_factory=ResourceClaimSpec)

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class Device:
    """One device in a ResourceSlice: attributes (bool/int/string values,
    optionally 'domain/name'-qualified keys) + capacity quantities feed
    CEL selectors; device_class_name is the legacy direct-match shortcut
    kept for slices that publish pre-classified devices."""

    name: str
    device_class_name: str = ""
    attributes: dict[str, object] = field(default_factory=dict)
    capacity: dict[str, str] = field(default_factory=dict)


@dataclass
class ResourceSlice:
    """resource.k8s.io ResourceSlice: one driver's device inventory on one
    node (the publication a DRA driver makes)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    node_name: str = ""
    driver: str = ""
    pool: str = ""
    devices: list[Device] = field(default_factory=list)


@dataclass
class DeviceClass:
    """resource.k8s.io DeviceClass: CEL selectors over devices; a request
    naming this class matches the devices its selectors accept."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selectors: list[DeviceSelector] = field(default_factory=list)


# --- pod groups (gang scheduling / multi-tenant job queues) ---------------------------

# labels binding a pod to its gang and tenant queue (the coscheduling
# convention of pod-group.scheduling.sigs.k8s.io, namespaced to this build)
LABEL_POD_GROUP = "scheduling.k8s.io/pod-group"
LABEL_QUEUE = "scheduling.k8s.io/queue"


@dataclass
class PodGroup:
    """scheduling.sigs.k8s.io PodGroup analog (the Kant/coscheduling gang
    contract): pods carrying ``LABEL_POD_GROUP: <name>`` in this namespace
    form one gang. The job queue releases the gang into the scheduling
    batch only when ``min_member`` members are present (and the tenant's
    quota fits them); the gang Permit plugin then holds reserved members
    in the wait room until ``min_member`` have reserved, committing all
    binds together — or rolling every reservation back atomically after
    ``schedule_timeout_seconds``."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_member: int = 1
    queue: str = "default"                # tenant / job-queue name
    priority: int = 0                     # gang priority (informational;
                                          # pod spec.priority drives order)
    schedule_timeout_seconds: float = 30.0

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


def pod_group_key(pod: "Pod") -> Optional[str]:
    """The gang key ("namespace/groupname") a pod belongs to, or None."""
    g = pod.metadata.labels.get(LABEL_POD_GROUP)
    return f"{pod.metadata.namespace}/{g}" if g else None


# --- priority class ------------------------------------------------------------------


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    preemption_policy: str = "PreemptLowerPriority"


# --- events (core/v1 Event) --------------------------------------------------


@dataclass
class Event:
    """core/v1 Event analog: an object-level notice a controller records
    against a referenced object (``ref_kind``/``ref_key``), deduped by
    (ref, reason) with a bump of ``count`` — how failures that have no
    natural status field (a DeviceClass whose CEL selector does not
    compile) become visible instead of silently parking pods."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    ref_kind: str = ""
    ref_key: str = ""            # "namespace/name" or bare name
    reason: str = ""
    message: str = ""
    count: int = 1
