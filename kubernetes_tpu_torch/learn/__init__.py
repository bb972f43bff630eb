"""The learned scorer's host side (port of the JAX package's learn/):
``learn.checkpoint`` (the versioned checkpoint format and the mtime-polled
hot-reload watcher the scheduler polls at sync time), ``learn.replay``
(the dataset from the scheduler's v3 trace exports and the journal's
outcome labels), ``learn.train`` (the trainer, whose step is kernel K10
on the card), ``learn.regret`` (per-placement regret and the promotion
gate) and ``learn.loop`` (the retrain daemon). CLI:
``python -m kubernetes_tpu_torch.learn --help``.
"""

from kubernetes_tpu_torch.learn.checkpoint import (  # noqa: F401
    CheckpointError,
    CheckpointWatcher,
    load_checkpoint,
    next_version,
    save_checkpoint,
)
from kubernetes_tpu_torch.learn.replay import (  # noqa: F401
    ReplayDataset,
    build_dataset,
    build_dataset_rows,
    iter_placement_rows,
    synthetic_dataset,
    wal_outcomes,
)
