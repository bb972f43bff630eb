"""Host-side (reference-semantics) selector matching.

These are the exact-semantics oracles for the device kernels in
``kubernetes_tpu_torch.ops`` and the host fallback path. Reference:
kubernetes/staging/src/k8s.io/apimachinery/pkg/labels (label selectors),
k8s.io/component-helpers/scheduling/corev1/nodeaffinity (node selectors, used
by the NodeAffinity plugin at
kubernetes/pkg/scheduler/framework/plugins/nodeaffinity/node_affinity.go),
and v1helper taint/toleration matching.
"""

from __future__ import annotations

import re
from typing import Optional

from kubernetes_tpu_torch.api.objects import (
    LABEL_HOSTNAME,
    NO_EXECUTE,
    NO_SCHEDULE,
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
    LabelSelector,
    Node,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Pod,
    Taint,
    Toleration,
)


_INT_RE = re.compile(r"^[+-]?[0-9]+$")


def parse_strict_int(s: str) -> Optional[int]:
    """Base-10 integer parse matching Go strconv.ParseInt: optional sign,
    digits only. Returns None on anything else (underscores, spaces, hex...)."""
    if not _INT_RE.match(s):
        return None
    return int(s)


def requirements_match(exprs, labels: dict[str, str]) -> bool:
    """Evaluate (key, operator, values) requirement tuples against a label
    set — apimachinery labels.Requirement semantics (the host oracle twin of
    the device kernel ops.topology.sel_match). exprs=None (nil selector)
    matches nothing; empty list matches everything."""
    if exprs is None:
        return False
    for key, op, values in exprs:
        present = key in labels
        val = labels.get(key)
        if op == OP_IN:
            ok = present and val in values
        elif op == OP_NOT_IN:
            ok = not present or val not in values
        elif op == OP_EXISTS:
            ok = present
        elif op == OP_DOES_NOT_EXIST:
            ok = not present
        else:
            ok = False  # unrecognized operator: no-match
        if not ok:
            return False
    return True


def selector_requirements(sel: LabelSelector):
    """A LabelSelector as (key, operator, values) requirement tuples."""
    return ([(k, OP_IN, [v]) for k, v in sel.match_labels.items()]
            + [(e.key, e.operator, list(e.values))
               for e in sel.match_expressions])


def label_selector_matches(sel: Optional[LabelSelector], labels: dict[str, str]) -> bool:
    """metav1.LabelSelector semantics. A nil selector matches nothing; an empty
    selector matches everything (apimachinery LabelSelectorAsSelector)."""
    if sel is None:
        return False
    return requirements_match(selector_requirements(sel), labels)


def _node_selector_requirement_matches(
    req: NodeSelectorRequirement, labels: dict[str, str]
) -> bool:
    present = req.key in labels
    val = labels.get(req.key)
    if req.operator == OP_IN:
        return present and val in req.values
    if req.operator == OP_NOT_IN:
        return not present or val not in req.values
    if req.operator == OP_EXISTS:
        return present
    if req.operator == OP_DOES_NOT_EXIST:
        return not present
    if req.operator in (OP_GT, OP_LT):
        # both sides parsed as base-10 integers (strconv.ParseInt semantics:
        # optional sign, digits only — no underscores/whitespace); non-integer
        # => no match
        if not present or len(req.values) != 1:
            return False
        lhs = parse_strict_int(val)  # type: ignore[arg-type]
        rhs = parse_strict_int(req.values[0])
        if lhs is None or rhs is None:
            return False
        return lhs > rhs if req.operator == OP_GT else lhs < rhs
    # unrecognized operator: no-match (device parity via OP_UNKNOWN)
    return False


def _match_fields_matches(req: NodeSelectorRequirement, node_name: str) -> bool:
    # the only supported matchField is metadata.name (nodeaffinity validation)
    if req.key != "metadata.name":
        return False
    if req.operator == OP_IN:
        return node_name in req.values
    if req.operator == OP_NOT_IN:
        return node_name not in req.values
    return False


def node_selector_term_matches(term: NodeSelectorTerm, node: Node) -> bool:
    """A term with no expressions and no fields matches nothing; otherwise all
    requirements must match (AND)."""
    if not term.match_expressions and not term.match_fields:
        return False
    for req in term.match_expressions:
        if not _node_selector_requirement_matches(req, node.metadata.labels):
            return False
    for req in term.match_fields:
        if not _match_fields_matches(req, node.metadata.name):
            return False
    return True


def node_selector_matches(sel: Optional[NodeSelector], node: Node) -> bool:
    """OR over terms; nil selector matches everything, empty term list nothing."""
    if sel is None:
        return True
    return any(node_selector_term_matches(t, node) for t in sel.node_selector_terms)


def pod_matches_node_selector_and_affinity(pod: Pod, node: Node) -> bool:
    """The required half of the NodeAffinity plugin's Filter
    (node_affinity.go:206-228): spec.nodeSelector AND
    affinity.nodeAffinity.required."""
    for k, v in pod.spec.node_selector.items():
        if node.metadata.labels.get(k) != v:
            return False
    aff = pod.spec.affinity
    if aff and aff.node_affinity and aff.node_affinity.required is not None:
        if not node_selector_matches(aff.node_affinity.required, node):
            return False
    return True


def find_untolerated_taint(
    taints: list[Taint],
    tolerations: list[Toleration],
    *,
    effects: tuple[str, ...] = (NO_SCHEDULE, NO_EXECUTE),
) -> Optional[Taint]:
    """First taint with an effect in ``effects`` that no toleration tolerates
    (v1helper.FindMatchingUntoleratedTaint, used by the TaintToleration Filter)."""
    for t in taints:
        if t.effect not in effects:
            continue
        if not any(tol.tolerates(t) for tol in tolerations):
            return t
    return None


