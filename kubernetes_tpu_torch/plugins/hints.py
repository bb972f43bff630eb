"""QueueingHintFns for the big in-tree plugins.

Each fn answers "can THIS event make THIS rejected pod schedulable?"
(QueueingHintFn, framework/types.go:248) so non-helpful events leave pods
parked instead of thundering the activeQ. Semantics mirror the reference's
per-plugin isSchedulableAfter* fns:

- NodeResourcesFit: fit.go:265 isSchedulableAfterNodeChange /
  isSchedulableAfterPodEvent — a node only helps if the pod's request fits
  its allocatable; only a SCHEDULED pod's deletion helps (it frees real
  capacity, including its pod slot).
- NodeAffinity: node_affinity.go:95 — the (new) node must match the pod's
  required affinity/selector.
- TaintToleration: taint_toleration.go:205 — every NoSchedule taint on the
  new node must be tolerated.
- InterPodAffinity: plugin.go:92 — an appearing/relabeled pod only helps a
  required-affinity rejection if it matches a term; a deleted pod only
  helps an anti-affinity rejection if it matched one.
- PodTopologySpread: plugin.go:160 — pod events only help if the pod
  matches some constraint's selector in the pending pod's namespace; node
  events only help if they touch a constraint's topology key.
- DynamicResources: dynamicresources.go — the pod's own claim changing,
  any claim's deletion or deallocation, and slice changes help.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.labels import (
    find_untolerated_taint,
    label_selector_matches,
    pod_matches_node_selector_and_affinity,
)
from kubernetes_tpu_torch.api.objects import Node, Pod
from kubernetes_tpu_torch.api.resources import Resource, pod_request
from kubernetes_tpu_torch.framework.interface import QueueingHint

QUEUE = QueueingHint.QUEUE
SKIP = QueueingHint.SKIP


def _as_node(obj) -> Node | None:
    return obj if isinstance(obj, Node) else None


def _as_pod(obj) -> Pod | None:
    return obj if isinstance(obj, Pod) else None


def fit_hint(pod: Pod, old_obj, new_obj) -> QueueingHint:
    """NodeResourcesFit (fit.go:265): node events QUEUE only when the pod's
    request fits the new node's allocatable; a SCHEDULED pod's deletion
    always queues (it frees its node's pod slot even with zero requests,
    isSchedulableAfterPodEvent), an unscheduled pod's never does."""
    node = _as_node(new_obj)
    if node is not None:
        req = pod_request(pod)
        alloc = Resource.from_map(node.status.allocatable)
        fits = (req.milli_cpu <= alloc.milli_cpu
                and req.memory <= alloc.memory
                and req.ephemeral_storage <= alloc.ephemeral_storage
                and all(alloc.scalar.get(k, 0) >= v
                        for k, v in req.scalar.items()))
        return QUEUE if fits else SKIP
    old_pod = _as_pod(old_obj)
    if old_pod is not None and new_obj is None:     # deletion
        scheduled = (old_pod.spec.node_name
                     or old_pod.status.nominated_node_name)
        return QUEUE if scheduled else SKIP
    return QUEUE    # scale-down / unknown shape: be conservative


def node_affinity_hint(pod: Pod, old_obj, new_obj) -> QueueingHint:
    node = _as_node(new_obj)
    if node is None:
        return QUEUE
    return (QUEUE if pod_matches_node_selector_and_affinity(pod, node)
            else SKIP)


def taint_toleration_hint(pod: Pod, old_obj, new_obj) -> QueueingHint:
    node = _as_node(new_obj)
    if node is None:
        return QUEUE
    untolerated = find_untolerated_taint(node.spec.taints,
                                         pod.spec.tolerations)
    return SKIP if untolerated is not None else QUEUE


def _pod_matches_terms(terms, other: Pod, pending_ns: str) -> bool:
    for term in terms:
        namespaces = term.namespaces or [pending_ns]
        if other.metadata.namespace not in namespaces \
                and term.namespace_selector is None:
            continue
        if label_selector_matches(term.label_selector,
                                  other.metadata.labels):
            return True
    return False


def _anti_terms_could_block(p: Pod, pending: Pod) -> bool:
    """Does p carry a required anti-affinity term whose selector could
    actually select ``pending``? (The departed blocker must have been able
    to block THIS pod, else its exit is noise.)"""
    a = p.spec.affinity
    if a is None or a.pod_anti_affinity is None:
        return False
    return _pod_matches_terms(a.pod_anti_affinity.required, pending,
                              p.metadata.namespace)


def inter_pod_affinity_hint(pod: Pod, old_obj, new_obj) -> QueueingHint:
    """plugin.go:92 isSchedulableAfterPodChange: appearing/relabeled pods
    help required affinity; disappearing (or relabeled-away) pods help
    required anti-affinity — including EXISTING pods' anti-affinity: the
    filter also rejects pods blocked by a running pod's own required
    anti terms (satisfyExistingPodsAntiAffinity), so the departure of any
    anti-affinity-carrying pod can unstick a pod with no terms at all."""
    new_pod = _as_pod(new_obj)
    old_pod = _as_pod(old_obj)
    if new_pod is None and old_pod is None:
        return QUEUE        # node label event: could open a topology domain
    aff = pod.spec.affinity
    if new_pod is not None:
        if aff is not None and aff.pod_affinity is not None \
                and _pod_matches_terms(aff.pod_affinity.required, new_pod,
                                       pod.metadata.namespace):
            return QUEUE
        # label update that moves a pod OUT of the pending pod's required
        # anti selector (or drops the pod's own anti terms)
        if old_pod is not None:
            if aff is not None and aff.pod_anti_affinity is not None \
                    and _pod_matches_terms(aff.pod_anti_affinity.required,
                                           old_pod, pod.metadata.namespace) \
                    and not _pod_matches_terms(
                        aff.pod_anti_affinity.required, new_pod,
                        pod.metadata.namespace):
                return QUEUE
            if _anti_terms_could_block(old_pod, pod) \
                    and not _anti_terms_could_block(new_pod, pod):
                return QUEUE
        return SKIP
    # deletion
    if aff is not None and aff.pod_anti_affinity is not None \
            and _pod_matches_terms(aff.pod_anti_affinity.required, old_pod,
                                   pod.metadata.namespace):
        return QUEUE
    if _anti_terms_could_block(old_pod, pod):
        return QUEUE        # its own anti terms could have blocked us
    return SKIP


def topology_spread_hint(pod: Pod, old_obj, new_obj) -> QueueingHint:
    """plugin.go:160 isSchedulableAfterPodChange: only pods matching some
    constraint's selector in the pending pod's namespace move the skew."""
    other = _as_pod(new_obj) or _as_pod(old_obj)
    if other is None:
        keys = {c.topology_key
                for c in pod.spec.topology_spread_constraints}
        # a key appearing on the NEW node or leaving the OLD one both move
        # the domain math (isSchedulableAfterNodeChange checks both sides)
        for node in (_as_node(new_obj), _as_node(old_obj)):
            if node is not None \
                    and any(k in node.metadata.labels for k in keys):
                return QUEUE
        if _as_node(new_obj) is None and _as_node(old_obj) is None:
            return QUEUE
        return SKIP
    if other.metadata.namespace != pod.metadata.namespace:
        return SKIP
    for c in pod.spec.topology_spread_constraints:
        if label_selector_matches(c.label_selector, other.metadata.labels):
            return QUEUE
        old_pod = _as_pod(old_obj)
        if old_pod is not None and label_selector_matches(
                c.label_selector, old_pod.metadata.labels):
            return QUEUE    # label update out of the matching set
    return SKIP


# ------------- volume family / DRA / gates / ports hints -------------
# The remaining per-plugin isSchedulableAfter* fns: without them every
# PV/PVC/claim/slice event thundered the whole unschedulable pool.


def _pod_host_ports(p: Pod) -> set[tuple[str, int]]:
    out = set()
    for c in p.spec.containers:
        for prt in c.ports:
            if prt.host_port:
                out.add((prt.protocol or "TCP", prt.host_port))
    return out


def node_ports_hint(pod: Pod, old_obj, new_obj) -> QueueingHint:
    """nodeports.go isSchedulableAfterPodDeleted: a deleted pod helps
    only if it held a host port the pending pod wants."""
    old_pod = _as_pod(old_obj)
    if old_pod is not None and new_obj is None:
        if not old_pod.spec.node_name:
            return SKIP
        want = _pod_host_ports(pod)
        held = _pod_host_ports(old_pod)
        return QUEUE if want & held else SKIP
    return QUEUE    # node events: allocatable/new node could host the port


def _pod_claim_names(pod: Pod) -> set[str]:
    from kubernetes_tpu_torch.plugins.dra import claim_name_for

    return {claim_name_for(pod, ref) for ref in pod.spec.resource_claims}


def dra_hint(pod: Pod, old_obj, new_obj) -> QueueingHint:
    """dynamicresources.go isSchedulableAfterClaimChange /
    ...ResourceSliceChange: the pod's OWN claim appearing/changing helps
    (template-generated claims arrive late; deallocation frees its
    devices); ANY claim's deletion frees devices; a new/removed slice
    changes the device inventory."""
    obj = new_obj if new_obj is not None else old_obj
    kind = type(obj).__name__ if obj is not None else ""
    if kind == "ResourceClaim":
        if new_obj is None:
            return QUEUE        # deletion frees its devices for anyone
        if obj.metadata.namespace == pod.metadata.namespace \
                and obj.metadata.name in _pod_claim_names(pod):
            return QUEUE        # the pod's own claim appeared / changed
        old_claim = old_obj
        if old_claim is not None \
                and old_claim.status.allocation is not None \
                and new_obj.status.allocation is None:
            return QUEUE        # a claim deallocated: devices freed
        return SKIP
    if kind == "ResourceSlice":
        return QUEUE            # inventory changed either way
    return QUEUE                # node/pod events: conservative
