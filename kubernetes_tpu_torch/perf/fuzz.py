"""Seeded synthetic clusters that exercise every phase-1 feature of the
launch: hard and PreferNoSchedule taints, unschedulable nodes, label
columns for nodeSelector / required and preferred node affinity (In and
Gt/Lt), container images, and host ports (occupied by bound pods,
requested by some pending pods). Used by the kernel checks of
chip_smoke.py and by the port's tests, which build the same cluster from
the JAX package's object classes."""

from __future__ import annotations


def fuzz_cluster(rng, n_nodes: int, n_pods: int, n_bound: int = 0,
                 ports: bool = True, objects=None):
    """Nodes, bound pods and pending pods exercising every
    phase-1 feature: taints (hard and PreferNoSchedule), unschedulable
    nodes, labels for selectors and affinity (incl. Gt/Lt), images, and
    host ports (bound pods occupy them; some pending pods request them).
    Returns (nodes, bound_pods, pending_pods); bound pods carry
    spec.node_name. ``objects`` is the api.objects module whose classes to
    build (the port's by default; any module with the same dataclasses)."""
    if objects is None:
        from kubernetes_tpu_torch.api import objects
    o = objects
    (Affinity, Container, ContainerImage, ContainerPort, NodeAffinity,
     NodeSelector, NodeSelectorRequirement, NodeSelectorTerm, Node, NodeSpec,
     NodeStatus, ObjectMeta, Pod, PodSpec, PreferredSchedulingTerm,
     ResourceRequirements, Taint, Toleration) = (
        o.Affinity, o.Container, o.ContainerImage, o.ContainerPort,
        o.NodeAffinity, o.NodeSelector, o.NodeSelectorRequirement,
        o.NodeSelectorTerm, o.Node, o.NodeSpec, o.NodeStatus, o.ObjectMeta,
        o.Pod, o.PodSpec, o.PreferredSchedulingTerm,
        o.ResourceRequirements, o.Taint, o.Toleration)

    images = [f"img{k}" for k in range(6)]
    nodes = []
    for i in range(n_nodes):
        name = f"node-{i}"
        labels = {"kubernetes.io/hostname": name,
                  "topology.kubernetes.io/zone": f"z{i % 3}",
                  "rank": str(rng.randrange(10))}
        if rng.random() < 0.5:
            labels["disk"] = rng.choice(["ssd", "hdd"])
        taints = []
        if rng.random() < 0.2:
            taints.append(Taint(key="dedicated", value=rng.choice(["a", "b"]),
                                effect="NoSchedule"))
        if rng.random() < 0.3:
            taints.append(Taint(key="soft", value="x",
                                effect="PreferNoSchedule"))
        imgs = [ContainerImage(names=[im], size_bytes=rng.choice(
                    [50, 300, 800]) * 1024 * 1024)
                for im in rng.sample(images, rng.randrange(3))]
        nodes.append(Node(
            metadata=ObjectMeta(name=name, labels=labels),
            spec=NodeSpec(unschedulable=rng.random() < 0.05, taints=taints),
            status=NodeStatus(allocatable={
                "cpu": f"{rng.choice([2, 4, 8])}",
                "memory": f"{rng.choice([4, 8, 16])}Gi", "pods": "110"},
                images=imgs)))

    def pod(i, prefix):
        spec = PodSpec(containers=[Container(
            name="c", image=rng.choice(images + [""] * 3),
            resources=ResourceRequirements(requests={
                "cpu": f"{rng.choice([100, 250, 500, 1000])}m",
                "memory": f"{rng.choice([128, 256, 512])}Mi"}))])
        r = rng.random()
        if r < 0.15:
            spec.node_selector = {"disk": rng.choice(["ssd", "hdd"])}
        elif r < 0.35:
            req = NodeSelector(node_selector_terms=[NodeSelectorTerm(
                match_expressions=[NodeSelectorRequirement(
                    key="rank", operator=rng.choice(["Gt", "Lt"]),
                    values=[str(rng.randrange(10))])])])
            pref = [PreferredSchedulingTerm(
                weight=rng.randrange(1, 50),
                preference=NodeSelectorTerm(match_expressions=[
                    NodeSelectorRequirement(
                        key="topology.kubernetes.io/zone", operator="In",
                        values=[f"z{rng.randrange(3)}"])]))]
            spec.affinity = Affinity(node_affinity=NodeAffinity(
                required=req if rng.random() < 0.5 else None,
                preferred=pref))
        if rng.random() < 0.3:
            spec.tolerations = [Toleration(
                key=rng.choice(["dedicated", "soft"]),
                operator=rng.choice(["Exists", "Equal"]),
                value=rng.choice(["a", "x"]))]
        if ports and rng.random() < 0.1:
            spec.containers[0].ports = [ContainerPort(
                container_port=80, host_port=rng.choice([8080, 9090]))]
        return Pod(metadata=ObjectMeta(name=f"{prefix}-{i}"), spec=spec)

    bound = []
    for i in range(n_bound):
        p = pod(i, "bound")
        p.spec.tolerations = [Toleration(operator="Exists")]
        p.spec.node_name = f"node-{rng.randrange(n_nodes)}"
        bound.append(p)
    pending = [pod(i, "pod") for i in range(n_pods)]
    return nodes, bound, pending
