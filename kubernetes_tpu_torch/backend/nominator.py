"""Nominated-node bookkeeping for preemptor pods.

Equivalent of kubernetes/pkg/scheduler/backend/queue/nominator.go:35:
pods that triggered preemption carry status.nominatedNodeName while their
victims terminate; the scheduler reserves their room during other pods'
filtering (the mirror packs them as nominated table pods, see
Mirror.set_nominated) so the vacated space is not stolen.
"""

from __future__ import annotations

import threading

from kubernetes_tpu_torch.api.objects import Pod


class Nominator:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._node_of: dict[str, str] = {}          # pod uid -> node name
        self._pods: dict[str, Pod] = {}             # pod uid -> pod object

    def add(self, pod: Pod, node_name: str) -> None:
        """AddNominatedPod (nominator.go:68); replaces a prior nomination."""
        with self._lock:
            self._node_of[pod.metadata.uid] = node_name
            self._pods[pod.metadata.uid] = pod

    def delete(self, uid: str) -> None:
        with self._lock:
            self._node_of.pop(uid, None)
            self._pods.pop(uid, None)

    def update(self, pod: Pod) -> None:
        """Refresh the stored pod object (labels/spec may have changed); the
        nomination itself follows status.nominatedNodeName."""
        with self._lock:
            uid = pod.metadata.uid
            if uid in self._node_of:
                if pod.status.nominated_node_name:
                    self._node_of[uid] = pod.status.nominated_node_name
                    self._pods[uid] = pod
                else:
                    self._node_of.pop(uid, None)
                    self._pods.pop(uid, None)
            elif pod.status.nominated_node_name:
                self._node_of[uid] = pod.status.nominated_node_name
                self._pods[uid] = pod

    def node_of(self, uid: str) -> str | None:
        with self._lock:
            return self._node_of.get(uid)

    def by_node(self) -> dict[str, list[Pod]]:
        """node name -> nominated pods (the mirror overlay feed)."""
        with self._lock:
            out: dict[str, list[Pod]] = {}
            for uid, node in self._node_of.items():
                out.setdefault(node, []).append(self._pods[uid])
            return out

    def clear_for_node_below_priority(self, node_name: str,
                                      priority: int) -> list[Pod]:
        """Drop nominations of LOWER-priority pods on a node (preemption.go
        prepareCandidate clears them so they re-evaluate); returns them."""
        with self._lock:
            dropped = [self._pods[uid] for uid, n in self._node_of.items()
                       if n == node_name
                       and self._pods[uid].priority() < priority]
            for p in dropped:
                self._node_of.pop(p.metadata.uid, None)
                self._pods.pop(p.metadata.uid, None)
            return dropped
