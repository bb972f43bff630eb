"""waitingPodsMap: pods parked by a Permit plugin returning WAIT (a copy of
the JAX package's framework/waiting.py).

Equivalent of kubernetes/pkg/scheduler/framework/runtime/
waiting_pods_map.go: a WAIT-ing pod keeps its reservation (it stays
assumed in the cache) until every waiting plugin allows it, one rejects
it, or its timeout passes. Permit plugins reach running waiting pods via
Framework.waiting_pods to Allow/Reject them (interface.go:684).
"""

from __future__ import annotations

import threading
from typing import Optional

from kubernetes_tpu_torch.framework.interface import Status

# a plugin returning WAIT with timeout 0 gets the max (runtime/
# waiting_pods_map.go:58 maxTimeout = 15 minutes)
MAX_PERMIT_TIMEOUT = 15 * 60.0


class WaitingPod:
    """waitingPod (waiting_pods_map.go:50): one pod + its pending plugins
    and the earliest hard deadline."""

    def __init__(self, qp, node_name: str, state,
                 plugin_timeouts: dict[str, float], now: float):
        self.qp = qp
        self.node_name = node_name
        self.state = state
        # per-plugin hard deadlines (the reference arms one AfterFunc timer
        # per WAIT plugin): the pod is rejected when ANY pending plugin's
        # timer fires, so the effective deadline is the EARLIEST one still
        # pending - and it relaxes as plugins allow
        self.deadlines: dict[str, float] = {
            name: now + (t if t > 0 else MAX_PERMIT_TIMEOUT)
            for name, t in plugin_timeouts.items()}
        self.pending: set[str] = set(plugin_timeouts)
        self.rejected: Optional[Status] = None

    @property
    def uid(self) -> str:
        return self.qp.uid

    def deadline_info(self) -> tuple[float, str]:
        # (earliest pending deadline, its plugin)
        if not self.pending:
            return float("inf"), ""
        plugin = min(self.pending, key=lambda p: self.deadlines[p])
        return self.deadlines[plugin], plugin

    def allow(self, plugin: str) -> None:
        self.pending.discard(plugin)

    def reject(self, plugin: str, msg: str) -> None:
        self.rejected = Status.unschedulable(
            f"rejected while waiting at permit: {msg}", plugin=plugin)

    def is_allowed(self) -> bool:
        return not self.pending and self.rejected is None


class WaitingPodsMap:
    """Thread-safe uid -> WaitingPod registry + ready/expired harvesting."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pods: dict[str, WaitingPod] = {}

    def add(self, wp: WaitingPod) -> None:
        with self._lock:
            self._pods[wp.uid] = wp

    def get(self, uid: str) -> Optional[WaitingPod]:
        with self._lock:
            return self._pods.get(uid)

    def remove(self, uid: str) -> Optional[WaitingPod]:
        with self._lock:
            return self._pods.pop(uid, None)

    def __len__(self) -> int:
        return len(self._pods)

    def iterate(self):
        with self._lock:
            return list(self._pods.values())

    def harvest(self, now: float) -> tuple[list[WaitingPod],
                                           list[tuple[WaitingPod, Status]]]:
        """(allowed pods ready to bind, rejected/timed-out pods with their
        status); both sets leave the map."""
        ready: list[WaitingPod] = []
        failed: list[tuple[WaitingPod, Status]] = []
        with self._lock:
            for uid in list(self._pods):
                wp = self._pods[uid]
                if wp.rejected is not None:
                    failed.append((wp, wp.rejected))
                    del self._pods[uid]
                elif wp.is_allowed():
                    ready.append(wp)
                    del self._pods[uid]
                else:
                    deadline, plugin = wp.deadline_info()
                    if now >= deadline:
                        failed.append((wp, Status.unschedulable(
                            "timed out waiting at permit",
                            plugin=plugin or "Permit")))
                        del self._pods[uid]
        return ready, failed
