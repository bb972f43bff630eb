"""Scheduling framework extension points, statuses, and cluster events.

Host-side equivalent of the reference's plugin API
(kubernetes/pkg/scheduler/framework/interface.go:444-960) and event
model (framework/types.go:46-274). The major departure from the reference:
the hot Filter/Score path for the default plugin set is ONE fused device
program (models.pipeline.schedule_batch) rather than per-plugin virtual
calls — host plugins implement the same interfaces below and run around the
device launch (mixed host/device framework, SURVEY.md §7.0).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.api.objects import Node, Pod


class Code(enum.IntEnum):
    """Status codes (interface.go Code)."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5
    PENDING = 6


@dataclass
class Status:
    """Result of running a plugin (interface.go Status)."""

    code: Code = Code.SUCCESS
    reasons: list[str] = field(default_factory=list)
    plugin: str = ""

    @classmethod
    def unschedulable(cls, *reasons: str, plugin: str = "",
                      resolvable: bool = True) -> "Status":
        code = (Code.UNSCHEDULABLE if resolvable
                else Code.UNSCHEDULABLE_AND_UNRESOLVABLE)
        return cls(code=code, reasons=list(reasons), plugin=plugin)

    @classmethod
    def error(cls, msg: str, plugin: str = "") -> "Status":
        return cls(code=Code.ERROR, reasons=[msg], plugin=plugin)

    @classmethod
    def skip(cls) -> "Status":
        return cls(code=Code.SKIP)

    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def is_skip(self) -> bool:
        return self.code == Code.SKIP

    def is_rejected(self) -> bool:
        return self.code in (Code.UNSCHEDULABLE,
                             Code.UNSCHEDULABLE_AND_UNRESOLVABLE)

    def message(self) -> str:
        return "; ".join(self.reasons)


SUCCESS = Status()


class ActionType(enum.IntFlag):
    """What changed about a resource (framework/types.go:46-120)."""

    ADD = 1 << 0
    DELETE = 1 << 1
    UPDATE_NODE_ALLOCATABLE = 1 << 2
    UPDATE_NODE_LABEL = 1 << 3
    UPDATE_NODE_TAINT = 1 << 4
    UPDATE_NODE_CONDITION = 1 << 5
    UPDATE_NODE_ANNOTATION = 1 << 6
    UPDATE_POD_LABEL = 1 << 7
    UPDATE_POD_SCALE_DOWN = 1 << 8
    UPDATE_POD_TOLERATION = 1 << 9
    UPDATE_POD_SCHEDULING_GATES_ELIMINATED = 1 << 10
    UPDATE_POD_GENERATED_RESOURCE_CLAIM = 1 << 11

    UPDATE = (UPDATE_NODE_ALLOCATABLE | UPDATE_NODE_LABEL | UPDATE_NODE_TAINT
              | UPDATE_NODE_CONDITION | UPDATE_NODE_ANNOTATION
              | UPDATE_POD_LABEL | UPDATE_POD_SCALE_DOWN
              | UPDATE_POD_TOLERATION
              | UPDATE_POD_SCHEDULING_GATES_ELIMINATED
              | UPDATE_POD_GENERATED_RESOURCE_CLAIM)
    ALL = ADD | DELETE | UPDATE


class EventResource(str, enum.Enum):
    """Resource kinds events refer to (framework/types.go:121-180)."""

    POD = "Pod"
    ASSIGNED_POD = "AssignedPod"
    UNSCHEDULABLE_POD = "UnschedulablePod"
    NODE = "Node"
    PVC = "PersistentVolumeClaim"
    PV = "PersistentVolume"
    STORAGE_CLASS = "StorageClass"
    CSI_NODE = "CSINode"
    CSI_STORAGE_CAPACITY = "CSIStorageCapacity"
    RESOURCE_CLAIM = "ResourceClaim"
    RESOURCE_SLICE = "ResourceSlice"
    POD_GROUP = "PodGroup"
    WILDCARD = "*"


@dataclass(frozen=True)
class ClusterEvent:
    """A (resource, action) pair informers deliver (framework/types.go)."""

    resource: EventResource
    action_type: ActionType
    label: str = ""

    def match(self, other: "ClusterEvent") -> bool:
        res_ok = (self.resource == EventResource.WILDCARD
                  or self.resource == other.resource)
        return res_ok and bool(self.action_type & other.action_type)


EVENT_WILDCARD = ClusterEvent(EventResource.WILDCARD, ActionType.ALL, "*")


class QueueingHint(enum.IntEnum):
    """Can this event unstick a rejected pod? (framework/types.go:248)"""

    SKIP = 0
    QUEUE = 1


# QueueingHintFn(logger, pod, old_obj, new_obj) -> QueueingHint
QueueingHintFn = Callable[[Pod, Optional[object], Optional[object]],
                          QueueingHint]


@dataclass
class ClusterEventWithHint:
    event: ClusterEvent
    queueing_hint_fn: Optional[QueueingHintFn] = None


# --------------------------- plugin interfaces ---------------------------


class Plugin:
    """Base: every plugin has a unique name (interface.go:444)."""

    NAME = ""

    def name(self) -> str:
        return self.NAME or type(self).__name__


class PreEnqueuePlugin(Plugin):
    """Called before adding a pod to the activeQ (interface.go:453)."""

    def pre_enqueue(self, pod: Pod) -> Status:
        raise NotImplementedError


class QueueSortPlugin(Plugin):
    """Orders pods in the activeQ (interface.go:465)."""

    def less(self, a, b) -> bool:  # a, b: QueuedPodInfo
        raise NotImplementedError


class EnqueueExtensions(Plugin):
    """Which events may unstick pods this plugin rejected (interface.go:488)."""

    def events_to_register(self) -> list[ClusterEventWithHint]:
        raise NotImplementedError


class PreFilterPlugin(Plugin):
    """Per-cycle state build before Filter (interface.go:518)."""

    def pre_filter(self, state, pod: Pod, nodes) -> Status:
        raise NotImplementedError


class FilterPlugin(Plugin):
    """Per-node feasibility check (interface.go:546)."""

    def filter(self, state, pod: Pod, node_info) -> Status:
        raise NotImplementedError


class PostFilterPlugin(Plugin):
    """Runs when no node fit — preemption lives here (interface.go:567)."""

    def post_filter(self, state, pod: Pod, filtered_node_status) -> tuple:
        raise NotImplementedError


class PreScorePlugin(Plugin):
    def pre_score(self, state, pod: Pod, nodes) -> Status:
        raise NotImplementedError


class ScorePlugin(Plugin):
    """Per-node score in [0, 100] (interface.go:613)."""

    def score(self, state, pod: Pod, node_info) -> tuple[float, Status]:
        raise NotImplementedError

    def normalize_scores(self, state, pod: Pod, scores) -> Status:
        return SUCCESS


class ReservePlugin(Plugin):
    def reserve(self, state, pod: Pod, node_name: str) -> Status:
        raise NotImplementedError

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        pass


class PermitPlugin(Plugin):
    """allow / reject / wait-with-timeout (interface.go:666)."""

    def permit(self, state, pod: Pod, node_name: str
               ) -> tuple[Status, float]:
        raise NotImplementedError


class PreBindPlugin(Plugin):
    def pre_bind(self, state, pod: Pod, node_name: str) -> Status:
        raise NotImplementedError


class BindPlugin(Plugin):
    def bind(self, state, pod: Pod, node_name: str) -> Status:
        raise NotImplementedError


class PostBindPlugin(Plugin):
    def post_bind(self, state, pod: Pod, node_name: str) -> None:
        pass


