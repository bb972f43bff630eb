"""Per-scheduling-cycle shared state.

Equivalent of the reference's CycleState
(staging/src/k8s.io/kube-scheduler/framework/cycle_state.go:44 and
pkg/scheduler/framework/cycle_state.go): a typed KV store plugins share
within one cycle, plus the Filter/Score skip sets PreFilter/PreScore
populate. In the batched pipeline one CycleState exists per pod per batch.
"""

from __future__ import annotations

from typing import Any, Optional


class CycleState:
    __slots__ = ("_storage", "skip_filter_plugins", "skip_score_plugins",
                 "recorded_plugin_metrics")

    def __init__(self) -> None:
        self._storage: dict[str, Any] = {}
        self.skip_filter_plugins: set[str] = set()
        self.skip_score_plugins: set[str] = set()
        self.recorded_plugin_metrics = False

    def read(self, key: str) -> Optional[Any]:
        return self._storage.get(key)

    def write(self, key: str, value: Any) -> None:
        self._storage[key] = value

    def delete(self, key: str) -> None:
        self._storage.pop(key, None)

    def clone(self) -> "CycleState":
        c = CycleState()
        c._storage = dict(self._storage)
        c.skip_filter_plugins = set(self.skip_filter_plugins)
        c.skip_score_plugins = set(self.skip_score_plugins)
        return c
