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


def topology_fuzz(rng, n_nodes: int, n_bound: int, n_specs: int,
                  ports: bool = True, objects=None):
    """A seeded cluster for the topology statics and the commit scan: nodes
    in 3 zones (most with a rack label too, so some nodes miss a topology
    key; some tainted), bound pods in two namespaces carrying required
    (hostname-keyed, so a large table does not forbid whole zones) and
    preferred pod (anti)affinity and spread constraints, and ``n_specs``
    pending pod specs mixing hard and soft terms — In / NotIn / Exists /
    DoesNotExist selectors, namespace lists, minDomains, node-inclusion
    policies, node selectors, tolerations and host ports. Returns
    (nodes, bound_pods, pending_specs, namespaces); bound pods carry
    spec.node_name. ``objects`` as in fuzz_cluster."""
    if objects is None:
        from kubernetes_tpu_torch.api import objects
    o = objects
    keys = ("kubernetes.io/hostname", "topology.kubernetes.io/zone", "rack")

    def selector():
        r = rng.random()
        if r < 0.4:
            return o.LabelSelector(
                match_labels={"app": f"a{rng.randrange(3)}"})
        req = rng.choice([
            o.LabelSelectorRequirement("app", "In",
                                       [f"a{rng.randrange(3)}", "a1"]),
            o.LabelSelectorRequirement("app", "NotIn", ["a2"]),
            o.LabelSelectorRequirement("tier", "Exists"),
            o.LabelSelectorRequirement("tier", "DoesNotExist")])
        return o.LabelSelector(match_expressions=[req])

    def term(key_choices=keys):
        return o.PodAffinityTerm(
            topology_key=rng.choice(key_choices), label_selector=selector(),
            namespaces=rng.choice([[], ["ns-0"], ["ns-0", "ns-1"]]))

    def weighted():
        return [o.WeightedPodAffinityTerm(weight=rng.randrange(1, 101),
                                          pod_affinity_term=term())]

    def spread():
        hard = rng.random() < 0.6
        return o.TopologySpreadConstraint(
            max_skew=rng.choice([1, 2, 3]), topology_key=rng.choice(keys),
            when_unsatisfiable="DoNotSchedule" if hard else "ScheduleAnyway",
            label_selector=selector(),
            min_domains=rng.choice([None, 2, 5]) if hard else None,
            node_affinity_policy=rng.choice(["Honor", "Ignore"]),
            node_taints_policy=rng.choice(["Honor", "Ignore"]))

    def pod(name, ns, p_req, p_pref, p_spread, req_keys=keys):
        labels = {"app": f"a{rng.randrange(3)}"}
        if rng.random() < 0.4:
            labels["tier"] = "web"
        pa = o.PodAffinity(
            required=[term(req_keys)] if rng.random() < p_req / 2 else [],
            preferred=weighted() if rng.random() < p_pref else [])
        pan = o.PodAntiAffinity(
            required=[term(req_keys)] if rng.random() < p_req else [],
            preferred=weighted() if rng.random() < p_pref else [])
        spec = o.PodSpec(containers=[o.Container(
            name="c", resources=o.ResourceRequirements(requests={
                "cpu": f"{rng.choice([100, 250, 500])}m",
                "memory": f"{rng.choice([128, 256])}Mi"}))],
            affinity=o.Affinity(pod_affinity=pa, pod_anti_affinity=pan),
            topology_spread_constraints=(
                [spread() for _ in range(rng.randrange(1, 3))]
                if rng.random() < p_spread else []))
        return o.Pod(metadata=o.ObjectMeta(name=name, namespace=ns,
                                           labels=labels), spec=spec)

    nodes = []
    for i in range(n_nodes):
        name = f"node-{i}"
        labels = {keys[0]: name, keys[1]: f"z{i % 3}"}
        if rng.random() < 0.8:
            labels["rack"] = f"r{rng.randrange(4)}"
        taints = ([o.Taint(key="dedicated", value="a", effect="NoSchedule")]
                  if rng.random() < 0.15 else [])
        nodes.append(o.Node(
            metadata=o.ObjectMeta(name=name, labels=labels),
            spec=o.NodeSpec(taints=taints),
            status=o.NodeStatus(allocatable={
                "cpu": "8", "memory": "16Gi", "pods": "110"})))
    bound = []
    for i in range(n_bound):
        p = pod(f"bound-{i}", f"ns-{i % 2}", 0.1, 0.3, 0.2, keys[:1])
        p.spec.tolerations = [o.Toleration(operator="Exists")]
        p.spec.node_name = f"node-{rng.randrange(n_nodes)}"
        bound.append(p)
    specs = []
    for i in range(n_specs):
        p = pod(f"pod-{i}", f"ns-{rng.randrange(2)}", 0.4, 0.5, 0.5)
        if rng.random() < 0.3:
            p.spec.tolerations = [o.Toleration(key="dedicated",
                                               operator="Exists")]
        if rng.random() < 0.2:
            p.spec.node_selector = {keys[1]: f"z{rng.randrange(3)}"}
        if ports and rng.random() < 0.3:
            p.spec.containers[0].ports = [o.ContainerPort(
                container_port=80, host_port=rng.choice([8080, 9090]))]
        specs.append(p)
    namespaces = [o.Namespace(metadata=o.ObjectMeta(name=f"ns-{i}"))
                  for i in range(2)]
    return nodes, bound, specs, namespaces


def preemption_fuzz(rng, n_nodes: int, n_preemptors: int,
                    extra_columns: bool = False, objects=None):
    """A seeded cluster for the preemption sweep: fuzz_cluster's nodes
    (taints, labels, images; a tenth of them hold priority-100 bound pods
    occupying host ports), PreemptionAsync's filler layout (up to four
    priority-0 pods of 900m / 500Mi per node, as many as the node's CPU
    holds) plus a sprinkling of priority-1 victims that free memory only
    and, with ``extra_columns``, of priority-2 victims that free
    ephemeral storage and an extended resource (every node then offers
    both) — so the victims free 3 resource columns (a padded column
    subset of 4) or 5 (of 8). Returns (nodes, bound_pods, preemptors):
    ``n_preemptors`` priority-10 pods of fuzz_cluster's pending specs with
    their requests raised to a few CPUs. ``objects`` as in fuzz_cluster."""
    if objects is None:
        from kubernetes_tpu_torch.api import objects
    o = objects
    nodes, bound, pending = fuzz_cluster(rng, n_nodes, n_preemptors,
                                         n_bound=n_nodes // 10,
                                         objects=o)
    for p in bound:
        p.spec.priority = 100
    if extra_columns:
        for n in nodes:
            n.status.allocatable.update({"ephemeral-storage": "100Gi",
                                         "example.com/gpu": "4"})

    def victim(name, node, prio, requests):
        return o.Pod(
            metadata=o.ObjectMeta(name=name,
                                  creation_timestamp=1000.0 + len(bound)),
            spec=o.PodSpec(containers=[o.Container(
                name="c", resources=o.ResourceRequirements(
                    requests=requests))], priority=prio,
                node_name=node, tolerations=[o.Toleration(
                    operator="Exists")]))

    for n in nodes:
        name = n.metadata.name
        cpus = int(n.status.allocatable["cpu"])
        for j in range(min(4, cpus)):
            bound.append(victim(f"filler-{name}-{j}", name, 0,
                                {"cpu": "900m", "memory": "500Mi"}))
        if rng.random() < 0.1:
            bound.append(victim(f"memonly-{name}", name, 1,
                                {"memory": f"{rng.choice([1, 2])}Gi"}))
        if extra_columns and rng.random() < 0.1:
            bound.append(victim(f"extra-{name}", name, 2, {
                "ephemeral-storage": "10Gi", "example.com/gpu": "1"}))
    preemptors = []
    for i, p in enumerate(pending):
        p.spec.priority = 10
        req = {"cpu": f"{rng.choice([1000, 2000, 3000, 9000])}m",
               "memory": f"{rng.choice([500, 2048, 6144])}Mi"}
        if extra_columns and i % 2:
            req.update({"ephemeral-storage": "20Gi",
                        "example.com/gpu": "2"})
        p.spec.containers[0].resources = o.ResourceRequirements(
            requests=req)
        preemptors.append(p)
    return nodes, bound, preemptors


def gang_fuzz(rng, n_nodes: int, n_zones: int, n_bound: int,
              n_reps: int, n_nominated: int = 0, objects=None):
    """A seeded cluster for the gang packer (K7): nodes of 2, 4 or 8 CPUs
    (many ties), zone labels over ``n_zones`` zones (none when 0: the
    packer's tk = -1), a few tainted nodes, bound pods using part of the
    capacity, pending nominated pods (reservations) and ``n_reps`` gang
    representative pods of varied requests, the first of 3,500m (only a
    few nodes hold one) and one of 1m and 1Ki (capacities past 4,095).
    Returns (nodes, bound_pods, nominated_pods, reps)."""
    if objects is None:
        from kubernetes_tpu_torch.api import objects
    o = objects

    def pod(name, cpu, mem, node="", nominated=""):
        p = o.Pod(metadata=o.ObjectMeta(name=name), spec=o.PodSpec(
            containers=[o.Container(name="c", resources=o.ResourceRequirements(
                requests={"cpu": cpu, "memory": mem}))]))
        p.spec.node_name = node
        p.status.nominated_node_name = nominated
        return p

    nodes = []
    for i in range(n_nodes):
        labels = {"kubernetes.io/hostname": f"node-{i}"}
        if n_zones and rng.random() < 0.97:
            labels["topology.kubernetes.io/zone"] = f"z{i % n_zones}"
        taints = ([o.Taint(key="dedicated", value="a", effect="NoSchedule")]
                  if rng.random() < 0.05 else [])
        nodes.append(o.Node(
            metadata=o.ObjectMeta(name=f"node-{i}", labels=labels),
            spec=o.NodeSpec(taints=taints),
            status=o.NodeStatus(allocatable={
                "cpu": f"{rng.choice([2, 4, 4, 8])}", "memory": "32Gi",
                "pods": "110"})))
    bound = [pod(f"bound-{i}", f"{rng.choice([100, 500, 900, 1500])}m",
                 "1Gi", node=f"node-{rng.randrange(n_nodes)}")
             for i in range(n_bound)]
    nominated = [pod(f"nom-{i}", "900m", "200Mi",
                     nominated=f"node-{rng.randrange(n_nodes)}")
                 for i in range(n_nominated)]
    shapes = [("3500m", "200Mi"), ("1m", "1Ki"), ("900m", "200Mi"),
              ("100m", "200Mi"), ("1900m", "1Gi"), ("250m", "512Mi")]
    reps = [pod(f"rep-{k}", *(shapes[k] if k < len(shapes) else
                              (f"{rng.choice([100, 300, 900, 1100])}m",
                               f"{rng.choice([128, 256, 1024])}Mi")))
            for k in range(n_reps)]
    return nodes, bound, nominated, reps


def dra_fuzz(rng, n_nodes: int, n_cap: int, d_cap: int, q_cap: int,
             b: int) -> dict:
    """Seeded inputs of the DRA allocator (K8) as numpy arrays, keyed as
    ops/dra.py:DraBatch's fields plus ``static_ok`` [b, n_cap] and
    ``host_ok`` [b, n_cap]. ``rng`` is a numpy Generator. Nodes carry a
    prefix of 0..d_cap valid devices (some full), a fifth of them in use;
    each device's 256 selector verdicts are random at density 3/4, and
    request masks set 0 to 3 random bits (bit 31 of a word included), or
    a whole word, so masks match some devices and not others. Requests
    mix counts of 0 (unused slot) to past a node's devices with All mode;
    pods mix PIN_ANY, PIN_NONE and pins to valid and padding rows, and
    inactive rows. Node rows past ``n_nodes`` are padding (no devices,
    static_ok False)."""
    import numpy as np

    from kubernetes_tpu_torch.ops.dra import PIN_ANY, PIN_NONE, SELBIT_WORDS

    w = SELBIT_WORDS
    k = rng.integers(0, d_cap + 1, size=n_nodes)
    k[rng.random(n_nodes) < 0.2] = d_cap
    valid = np.zeros((n_cap, d_cap), bool)
    valid[:n_nodes] = np.arange(d_cap)[None, :] < k[:, None]
    in_use = valid & (rng.random((n_cap, d_cap)) < 0.2)
    full = np.uint64(0xFFFFFFFF)
    r1 = rng.integers(0, 1 << 32, size=(n_cap, d_cap, w), dtype=np.uint64)
    r2 = rng.integers(0, 1 << 32, size=(n_cap, d_cap, w), dtype=np.uint64)
    selbits = ((r1 | r2) & full).astype(np.uint32)
    # a few devices carry every selector bit, a few none
    selbits[rng.random((n_cap, d_cap)) < 0.05] = np.uint32(0xFFFFFFFF)
    selbits[rng.random((n_cap, d_cap)) < 0.05] = 0
    selbits[~valid] = 0
    req_mask = np.zeros((b, q_cap, w), np.uint32)
    nbits = rng.integers(0, 4, size=(b, q_cap))
    for i in range(b):
        for q in range(q_cap):
            if rng.random() < 0.03:
                req_mask[i, q, rng.integers(0, w)] = np.uint32(0xFFFFFFFF)
                continue
            for _ in range(int(nbits[i, q])):
                bit = 31 if rng.random() < 0.15 else int(rng.integers(0, 32))
                req_mask[i, q, rng.integers(0, w)] |= np.uint32(1 << bit)
    req_count = rng.choice(np.array([0, 1, 1, 1, 2, 2, 3, d_cap // 2 + 1]),
                           size=(b, q_cap)).astype(np.int32)
    req_all = rng.random((b, q_cap)) < 0.1
    pinned = np.full((b,), PIN_ANY, np.int32)
    u = rng.random(b)
    pinned[u < 0.1] = PIN_NONE
    pin_rows = rng.integers(0, n_cap, size=b).astype(np.int32)
    pinned[(u >= 0.1) & (u < 0.25)] = pin_rows[(u >= 0.1) & (u < 0.25)]
    active = rng.random(b) < 0.85
    static_ok = np.zeros((b, n_cap), bool)
    static_ok[:, :n_nodes] = rng.random((b, n_nodes)) < 0.9
    host_ok = rng.random((b, n_cap)) < 0.95
    return {"dev_valid": valid, "dev_selbits": selbits, "dev_in_use": in_use,
            "req_mask": req_mask, "req_count": req_count,
            "req_all": req_all, "pinned": pinned, "active": active,
            "static_ok": static_ok, "host_ok": host_ok}
