"""Per-cycle immutable cluster view.

Equivalent of kubernetes/pkg/scheduler/backend/cache/snapshot.go:29-44:
a node map plus a zone-interleaved node list and the two affinity sublists
(HavePodsWithAffinityNodeInfoList / HavePodsWithRequiredAntiAffinityNodeInfoList)
that let InterPodAffinity's PreFilter scan only relevant nodes.

The snapshot is refreshed *incrementally* by Cache.update_snapshot (the
generation-diff walk of cache.go:186 UpdateSnapshot); the device mirror in
``backend.mirror`` applies the same diff to HBM rows.
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.backend.node_info import NodeInfo


class Snapshot:
    def __init__(self) -> None:
        self.node_info_map: dict[str, NodeInfo] = {}
        self.node_info_list: list[NodeInfo] = []
        self.have_pods_with_affinity_list: list[NodeInfo] = []
        self.have_pods_with_required_anti_affinity_list: list[NodeInfo] = []
        self.generation: int = 0
        # namespace name -> labels, for affinity namespaceSelector unrolling
        # (the nsLister surface of interpodaffinity/plugin.go:123)
        self.namespaces: dict[str, dict[str, str]] = {}
        self.ns_generation: int = 0
        # monotonically bumped by Cache.update_snapshot whenever anything in
        # the snapshot changed — lets downstream consumers (Mirror.sync) be
        # O(1) no-ops between changes
        self.version: int = 0
        self.node_set_version: int = -1

    # --- lister surface (snapshot.go:158-199) ---

    def num_nodes(self) -> int:
        return len(self.node_info_list)

    def get(self, name: str) -> Optional[NodeInfo]:
        return self.node_info_map.get(name)

    def list_all(self) -> list[NodeInfo]:
        return self.node_info_list

    def index_of(self, name: str) -> int:
        """Stable row index of a node in this snapshot (device tensor row)."""
        for i, ni in enumerate(self.node_info_list):
            if ni.name == name:
                return i
        return -1
