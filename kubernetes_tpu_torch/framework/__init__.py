from kubernetes_tpu_torch.framework.interface import (  # noqa: F401
    ActionType,
    ClusterEvent,
    Code,
    EventResource,
    QueueingHint,
    Status,
)
from kubernetes_tpu_torch.framework.cycle_state import CycleState  # noqa: F401
