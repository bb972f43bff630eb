"""Node lifecycle injection: the one code path for node add / remove /
cordon / uncordon (port of the JAX package's scenario/lifecycle.py), used
by the perf harness's Churn op and, once ported, by the scenario trace
replayer, so traces and hand-built workloads inject node events
identically.

It depends only on api + hub, so scenario and perf.harness can both
import it without a cycle.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.objects import Node


class NodeLifecycle:
    """Apply node lifecycle events to a hub.

    remove / cordon / uncordon address nodes by NAME (traces do not know
    uids: the hub assigns them at create); ``add`` returns the created
    node so callers that track live objects can keep doing so. Every verb
    tolerates an already-gone or already-in-state target: a replayed
    trace must be idempotent across a torn-tail resume, and a churn
    delete racing an eviction is routine.
    """

    def __init__(self, hub) -> None:
        self.hub = hub

    def add(self, node: Node) -> Node:
        self.hub.create_node(node)
        return node

    def remove(self, name: str) -> bool:
        node = self.hub.get_node(name)
        if node is None:
            return False
        try:
            self.hub.delete_node(node.metadata.uid)
        except Exception:  # noqa: BLE001 — lost a race with another delete
            return False
        return True

    def _set_unschedulable(self, name: str, value: bool) -> bool:
        node = self.hub.get_node(name)
        if node is None or node.spec.unschedulable == value:
            return False
        patched = node.clone()
        patched.spec.unschedulable = value
        self.hub.update_node(patched)
        return True

    def cordon(self, name: str) -> bool:
        return self._set_unschedulable(name, True)

    def uncordon(self, name: str) -> bool:
        return self._set_unschedulable(name, False)
