"""NodeInfo / PodInfo — the per-node scheduling view the cache maintains.

Host-side equivalent of ``framework.NodeInfo``
(kubernetes/pkg/scheduler/framework/types.go:780: node, Pods,
PodsWithAffinity, PodsWithRequiredAntiAffinity, UsedPorts, Requested,
NonZeroRequested, Allocatable, ImageStates, Generation) and
``framework.PodInfo`` (types.go:458: pod + pre-parsed affinity terms +
cached resource request).

These are the rows that get packed into the dense HBM feature tensor by
``kubernetes_tpu_torch.backend.mirror``; ``generation`` drives the incremental
row-update diff exactly like the reference's incremental snapshot
(cache.go:186 UpdateSnapshot).
"""

from __future__ import annotations

import itertools
from typing import Optional

from kubernetes_tpu_torch.api.objects import (
    Node,
    Pod,
    PodAffinityTerm,
    WeightedPodAffinityTerm,
)
from kubernetes_tpu_torch.api.resources import Resource, pod_request

_generation = itertools.count(1)


def next_generation() -> int:
    return next(_generation)


class PodInfo:
    """Pod plus pre-computed scheduling state (parsed affinity terms, cached
    resource request) so per-cycle work never re-parses specs."""

    __slots__ = (
        "pod",
        "required_affinity_terms",
        "required_anti_affinity_terms",
        "preferred_affinity_terms",
        "preferred_anti_affinity_terms",
        "request",
        "non_zero_request",
    )

    def __init__(self, pod: Pod):
        self.pod = pod
        aff = pod.spec.affinity
        self.required_affinity_terms: list[PodAffinityTerm] = (
            list(aff.pod_affinity.required) if aff and aff.pod_affinity else []
        )
        self.required_anti_affinity_terms: list[PodAffinityTerm] = (
            list(aff.pod_anti_affinity.required) if aff and aff.pod_anti_affinity else []
        )
        self.preferred_affinity_terms: list[WeightedPodAffinityTerm] = (
            list(aff.pod_affinity.preferred) if aff and aff.pod_affinity else []
        )
        self.preferred_anti_affinity_terms: list[WeightedPodAffinityTerm] = (
            list(aff.pod_anti_affinity.preferred) if aff and aff.pod_anti_affinity else []
        )
        self.request = pod_request(pod)
        self.non_zero_request = pod_request(pod, non_zero=True)

    def update(self, pod: Pod) -> "PodInfo":
        return PodInfo(pod)


class HostPortInfo:
    """(ip, protocol, port) occupancy with 0.0.0.0 wildcard conflict semantics
    (types.go:1291 HostPortInfo)."""

    WILDCARD = "0.0.0.0"

    def __init__(self) -> None:
        # ip -> set of (protocol, port)
        self.ports: dict[str, set[tuple[str, int]]] = {}

    @staticmethod
    def _sanitize(ip: str, protocol: str) -> tuple[str, str]:
        return (ip or HostPortInfo.WILDCARD, protocol or "TCP")

    def add(self, ip: str, protocol: str, port: int) -> None:
        if port <= 0:
            return
        ip, protocol = self._sanitize(ip, protocol)
        self.ports.setdefault(ip, set()).add((protocol, port))

    def remove(self, ip: str, protocol: str, port: int) -> None:
        if port <= 0:
            return
        ip, protocol = self._sanitize(ip, protocol)
        s = self.ports.get(ip)
        if s is not None:
            s.discard((protocol, port))
            if not s:
                del self.ports[ip]

    def conflicts(self, ip: str, protocol: str, port: int) -> bool:
        """True if (ip, protocol, port) clashes with an existing entry.
        Wildcard IP on either side conflicts with any IP (types.go CheckConflict)."""
        if port <= 0:
            return False
        ip, protocol = self._sanitize(ip, protocol)
        key = (protocol, port)
        if ip == self.WILDCARD:
            return any(key in s for s in self.ports.values())
        return key in self.ports.get(ip, ()) or key in self.ports.get(self.WILDCARD, ())

    def clone(self) -> "HostPortInfo":
        c = HostPortInfo()
        c.ports = {ip: set(s) for ip, s in self.ports.items()}
        return c

    def __len__(self) -> int:
        return sum(len(s) for s in self.ports.values())


class NodeInfo:
    """Aggregated scheduling state for one node."""

    __slots__ = (
        "node",
        "pods",
        "pods_with_affinity",
        "pods_with_required_anti_affinity",
        "used_ports",
        "requested",
        "non_zero_requested",
        "allocatable",
        "image_sizes",
        "generation",
    )

    def __init__(self, node: Optional[Node] = None):
        self.node = node
        self.pods: list[PodInfo] = []
        self.pods_with_affinity: list[PodInfo] = []
        self.pods_with_required_anti_affinity: list[PodInfo] = []
        self.used_ports = HostPortInfo()
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = Resource()
        self.image_sizes: dict[str, int] = {}
        self.generation = next_generation()
        if node is not None:
            self.set_node(node)

    @property
    def name(self) -> str:
        return self.node.metadata.name if self.node else ""

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable = Resource.from_map(node.status.allocatable)
        self.image_sizes = {
            name: img.size_bytes for img in node.status.images for name in img.names
        }
        self.generation = next_generation()

    def remove_node(self) -> None:
        """Node object deleted but pods remain (cache.go RemoveNode keeps the
        nodeinfo while pods are still assigned)."""
        self.node = None
        self.generation = next_generation()

    @staticmethod
    def _has_affinity(pi: PodInfo) -> bool:
        return bool(pi.required_affinity_terms or pi.preferred_affinity_terms
                    or pi.required_anti_affinity_terms
                    or pi.preferred_anti_affinity_terms)

    def add_pod(self, pod: Pod | PodInfo) -> None:
        pi = pod if isinstance(pod, PodInfo) else PodInfo(pod)
        self.pods.append(pi)
        if self._has_affinity(pi):
            self.pods_with_affinity.append(pi)
        if pi.required_anti_affinity_terms:
            self.pods_with_required_anti_affinity.append(pi)
        self.requested.add(pi.request)
        self.non_zero_requested.add(pi.non_zero_request)
        for c in pi.pod.spec.containers:
            for p in c.ports:
                if p.host_port > 0:
                    self.used_ports.add(p.host_ip, p.protocol, p.host_port)
        self.generation = next_generation()

    def remove_pod(self, pod: Pod) -> bool:
        uid = pod.metadata.uid
        for i, pi in enumerate(self.pods):
            if pi.pod.metadata.uid == uid:
                del self.pods[i]
                self.pods_with_affinity = [
                    p for p in self.pods_with_affinity if p.pod.metadata.uid != uid
                ]
                self.pods_with_required_anti_affinity = [
                    p for p in self.pods_with_required_anti_affinity
                    if p.pod.metadata.uid != uid
                ]
                self.requested.sub(pi.request)
                self.non_zero_requested.sub(pi.non_zero_request)
                for c in pi.pod.spec.containers:
                    for prt in c.ports:
                        if prt.host_port > 0:
                            self.used_ports.remove(prt.host_ip, prt.protocol, prt.host_port)
                self.generation = next_generation()
                return True
        return False

    def snapshot(self) -> "NodeInfo":
        """Shallow clone for the immutable per-cycle snapshot: lists and
        aggregates copied, PodInfo objects shared (they are immutable)."""
        c = NodeInfo.__new__(NodeInfo)
        c.node = self.node
        c.pods = list(self.pods)
        c.pods_with_affinity = list(self.pods_with_affinity)
        c.pods_with_required_anti_affinity = list(self.pods_with_required_anti_affinity)
        c.used_ports = self.used_ports.clone()
        c.requested = self.requested.clone()
        c.non_zero_requested = self.non_zero_requested.clone()
        c.allocatable = self.allocatable.clone()
        c.image_sizes = dict(self.image_sizes)
        c.generation = self.generation
        return c
