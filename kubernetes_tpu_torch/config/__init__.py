from kubernetes_tpu_torch.config.types import (  # noqa: F401
    SchedulerConfiguration,
    SchedulerProfile,
    default_config,
)
