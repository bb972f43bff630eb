"""Zone-aware node ordering.

Equivalent of kubernetes/pkg/scheduler/backend/cache/node_tree.go: nodes
are grouped by their (region, zone) key and listed round-robin across zones so
the snapshot's node order naturally spreads scheduling across zones
(node_tree.go:119-143 list()).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.objects import LABEL_REGION, LABEL_ZONE, Node


def zone_key(node: Node) -> str:
    region = node.metadata.labels.get(LABEL_REGION, "")
    zone = node.metadata.labels.get(LABEL_ZONE, "")
    return f"{region}:\x00:{zone}"


class NodeTree:
    def __init__(self) -> None:
        self._zones: dict[str, list[str]] = {}
        self.num_nodes = 0

    def add_node(self, node: Node) -> None:
        zone = zone_key(node)
        names = self._zones.setdefault(zone, [])
        if node.metadata.name in names:
            return
        names.append(node.metadata.name)
        self.num_nodes += 1

    def remove_node(self, node: Node) -> bool:
        zone = zone_key(node)
        names = self._zones.get(zone)
        if names and node.metadata.name in names:
            names.remove(node.metadata.name)
            if not names:
                del self._zones[zone]
            self.num_nodes -= 1
            return True
        return False

    def update_node(self, old: Node, new: Node) -> None:
        if zone_key(old) == zone_key(new):
            return
        self.remove_node(old)
        self.add_node(new)

    def list(self) -> list[str]:
        """Round-robin across zones (node_tree.go:119): one node from each
        zone per round, exhausted zones dropped from the rotation."""
        out: list[str] = []
        iters = [iter(names) for names in self._zones.values()]
        while iters:
            alive = []
            for it in iters:
                v = next(it, None)
                if v is not None:
                    out.append(v)
                    alive.append(it)
            iters = alive
        return out
