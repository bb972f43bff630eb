"""The slices as a whole: the SchedulingBasic drain and reduced copies of
the three hard-topology drains (TopologySpreading,
SchedulingPodAntiAffinity, SchedulingPodAffinity) and the four soft ones
(SchedulingPreferredPodAffinity, SchedulingPreferredPodAntiAffinity,
PreferredTopologySpreading, MixedSchedulingBasePod) through each package's
own Hub + Scheduler (the port on the CPU, where its kernels' plain twins
run), same perf/workloads.py nodes and pods, same batch size, node bucket
and tie_break_seed, then run_until_idle. The {pod: node} maps must be
identical. Both schedulers get the same deterministic clock, so queue
timestamps (and with them the batches) cannot tie differently."""

import itertools

import pytest

from kubernetes_tpu.api.objects import Namespace, ObjectMeta
from kubernetes_tpu.config.types import default_config as j_config
from kubernetes_tpu.hub import Hub as JHub
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu.perf import workloads as JW
from kubernetes_tpu.perf.workloads import _node, _pod
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.config.types import default_config as t_config
from kubernetes_tpu_torch.hub import Hub as THub
from kubernetes_tpu_torch.ops.features import Capacities as TCaps
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from tests.torch_port_support import to_port

pytestmark = pytest.mark.torch_port


def _clock():
    tick = itertools.count()
    return lambda: 1000.0 + next(tick) * 1e-3


def _drain(port, n_nodes, n_init, n_measure, batch, node_cap, seed,
           cpu="100m"):
    nodes = [_node(i) for i in range(n_nodes)]
    phases = [[_pod(f"init-{i}", cpu=cpu) for i in range(n_init)],
              [_pod(f"measure-{i}", cpu=cpu) for i in range(n_measure)]]
    if port:
        nodes = to_port(nodes)
        phases = [to_port(ph) for ph in phases]
        hub, cfg, caps = THub(), t_config(), TCaps(nodes=node_cap, pods=4096)
    else:
        hub, cfg, caps = JHub(), j_config(), JCaps(nodes=node_cap, pods=4096)
    cfg.batch_size = batch
    cfg.tie_break_seed = seed
    if port:
        sched = TScheduler(hub, cfg, caps=caps, now=_clock(), device="cpu")
    else:
        sched = JScheduler(hub, cfg, caps=caps, now=_clock())
    try:
        for n in nodes:
            hub.create_node(n)
        for phase in phases:
            for p in phase:
                hub.create_pod(p)
            for _ in range(10):
                sched.run_until_idle()
                if all(hub.get_pod(p.metadata.uid).spec.node_name
                       for p in phase):
                    break
    finally:
        sched.close()
    return {p.metadata.name: p.spec.node_name for p in hub.list_pods()}, \
        sched.stats


@pytest.mark.parametrize("n_nodes,n_init,n_measure,batch,node_cap,seed", [
    (500, 100, 1000, 256, 512, 0),     # B <= N: one accept per node
    (40, 100, 500, 128, 64, 0),        # B > N: the K-accept branch
    (500, 100, 1000, 256, 512, 12345),  # a non-zero tie-break seed
], ids=["500n_1100p", "40n_600p_k_accept", "500n_1100p_seeded"])
def test_scheduling_basic_drain_binds_identically(n_nodes, n_init, n_measure,
                                                  batch, node_cap, seed):
    want, _ = _drain(False, n_nodes, n_init, n_measure, batch, node_cap,
                     seed)
    got, stats = _drain(True, n_nodes, n_init, n_measure, batch, node_cap,
                        seed)
    assert len(want) == n_init + n_measure
    assert all(want.values()), "the reference left pods unbound"
    diff = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
    assert not diff, f"{len(diff)} pods bound differently, e.g. " \
        f"{list(diff.items())[:3]}"
    assert stats["launches"] >= 2 and stats["chained_launches"] >= 1


def test_overfull_drain_parks_the_same_pods():
    """More pods than the nodes hold (10 nodes x 4 CPU, 1-CPU pods): the
    same 40 pods bind to the same nodes in both packages and the rest are
    parked unschedulable (NodeResourcesFit) in both."""
    want, jstats = _drain(False, 10, 20, 40, 32, 16, 0, cpu="1")
    got, tstats = _drain(True, 10, 20, 40, 32, 16, 0, cpu="1")
    assert want == got
    assert sum(1 for v in got.values() if v) == 40
    assert tstats["unschedulable"] == jstats["unschedulable"] > 0


def test_schedule_one_batch_binds_identically():
    """The unpipelined entry point: one batch per call, launch then
    commit."""
    maps = []
    for port in (False, True):
        nodes = [_node(i) for i in range(20)]
        pods = [_pod(f"one-{i}") for i in range(50)]
        if port:
            nodes, pods = to_port(nodes), to_port(pods)
            hub, cfg = THub(), t_config()
            caps = TCaps(nodes=32, pods=256)
        else:
            hub, cfg = JHub(), j_config()
            caps = JCaps(nodes=32, pods=256)
        cfg.batch_size = 16
        sched = (TScheduler(hub, cfg, caps=caps, now=_clock(), device="cpu")
                 if port else JScheduler(hub, cfg, caps=caps, now=_clock()))
        try:
            for n in nodes:
                hub.create_node(n)
            for p in pods:
                hub.create_pod(p)
            while sched.schedule_one_batch():
                pass
        finally:
            sched.close()
        maps.append({p.metadata.name: p.spec.node_name
                     for p in hub.list_pods()})
    assert all(maps[1].values())
    assert maps[0] == maps[1]


def _topology_drain(port, nodes, namespaces, phases, batch, node_cap, seed):
    """Nodes, namespaces, then each phase's pods drained to the end; the
    {pod: node} map and the scheduler's stats."""
    if port:
        nodes, namespaces = to_port(nodes), to_port(namespaces)
        phases = [to_port(ph) for ph in phases]
        hub, cfg, caps = THub(), t_config(), TCaps(nodes=node_cap, pods=256)
    else:
        hub, cfg, caps = JHub(), j_config(), JCaps(nodes=node_cap, pods=256)
    cfg.batch_size = batch
    cfg.tie_break_seed = seed
    if port:
        sched = TScheduler(hub, cfg, caps=caps, now=_clock(), device="cpu")
    else:
        sched = JScheduler(hub, cfg, caps=caps, now=_clock())
    try:
        for n in nodes:
            hub.create_node(n)
        for ns in namespaces:
            hub.create_namespace(ns)
        for phase in phases:
            for p in phase:
                hub.create_pod(p)
            for _ in range(10):
                sched.run_until_idle()
                if all(hub.get_pod(p.metadata.uid).spec.node_name
                       for p in phase):
                    break
    finally:
        sched.close()
    return {p.metadata.name: p.spec.node_name for p in hub.list_pods()}, \
        sched.stats


def _sched_ns():
    return [Namespace(metadata=ObjectMeta(name=f"sched-{i}"))
            for i in range(2)]


def _topology_spreading():
    zones = ["moon-1", "moon-2", "moon-3"]
    nodes = [_node(i, zones=zones) for i in range(30)]
    return nodes, [], [[_pod(f"init-{i}") for i in range(60)],
                       [JW._spreading_pod(i) for i in range(90)]], 32, 32


def _pod_anti_affinity():
    nodes = [_node(i) for i in range(40)]
    return nodes, _sched_ns(), [
        [JW._anti_affinity_pod(i, "sched-0") for i in range(10)],
        [JW._anti_affinity_pod(i, "sched-1") for i in range(20)]], 16, 64


def _pod_affinity():
    nodes = [_node(i, zones=["zone1"]) for i in range(24)]
    return nodes, _sched_ns(), [
        [JW._pod_affinity_pod(i, "sched-0") for i in range(30)],
        [JW._pod_affinity_pod(i, "sched-1") for i in range(30)]], 16, 32


def _preferred(anti):
    def build():
        nodes = [_node(i, zones=["z1", "z2", "z3"]) for i in range(30)]
        return nodes, [], [
            [_pod(f"init-{i}") for i in range(20)],
            [JW._preferred_affinity_pod(i, anti=anti) for i in range(70)]], \
            32, 32
    return build


def _preferred_spreading():
    zones = ["moon-1", "moon-2", "moon-3"]
    nodes = [_node(i, zones=zones) for i in range(30)]
    return nodes, [], [[_pod(f"init-{i}") for i in range(60)],
                       [JW._preferred_spreading_pod(i) for i in range(90)]], \
        32, 32


def _mixed_base_pod():
    """Required and preferred terms in the table (the init phase takes
    the scan), then plain pods: soft-only launches at hostname width."""
    nodes = [_node(i, zones=["zone1"]) for i in range(24)]
    namespaces = [Namespace(metadata=ObjectMeta(name="sched-0"))]
    return nodes, namespaces, [
        [JW._mixed_init_pod(i) for i in range(40)],
        [_pod(f"measure-{i}", namespace="sched-0") for i in range(40)]], \
        16, 32


TOPOLOGY = {"topology_spreading": _topology_spreading,
            "pod_anti_affinity": _pod_anti_affinity,
            "pod_affinity": _pod_affinity,
            "preferred_pod_affinity": _preferred(False),
            "preferred_pod_anti_affinity": _preferred(True),
            "preferred_topology_spreading": _preferred_spreading,
            "mixed_scheduling_base_pod": _mixed_base_pod}


@pytest.mark.parametrize("seed", [0, 777])
@pytest.mark.parametrize("case", sorted(TOPOLOGY))
def test_topology_drain_binds_identically(case, seed):
    """The serial commit scan end to end (K5 and K3's twins on the CPU):
    every pod bound, and bound to the same node as the reference. The
    soft-only drains (preferred terms, ScheduleAnyway spread, and plain
    pods against a table with terms) take the scan on the CPU in both
    packages: the reference's reduced soft scan, the port's topology
    branch."""
    nodes, namespaces, phases, batch, node_cap = TOPOLOGY[case]()
    want, _ = _topology_drain(False, nodes, namespaces, phases, batch,
                              node_cap, seed)
    got, stats = _topology_drain(True, nodes, namespaces, phases, batch,
                                 node_cap, seed)
    n_pods = sum(len(ph) for ph in phases)
    assert len(want) == n_pods
    assert all(want.values()), "the reference left pods unbound"
    diff = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
    assert not diff, f"{len(diff)} pods bound differently, e.g. " \
        f"{list(diff.items())[:3]}"
    assert stats["launches"] >= 2
    if case == "pod_anti_affinity":
        assert len(set(got.values())) == n_pods


SOFT_DRAINS = ("preferred_pod_affinity", "preferred_pod_anti_affinity",
               "preferred_topology_spreading", "mixed_scheduling_base_pod")


@pytest.mark.parametrize("case", SOFT_DRAINS)
def test_soft_auction_drain_binds_identically(case, monkeypatch):
    """The soft drains through the soft-score auction in both packages:
    each Scheduler is made to take the engine it takes on an accelerator
    (the reference reads jax.default_backend(), the port its launch
    device; the kernels' twins and XLA on the CPU compute), and every pod
    binds to the same node."""
    import jax
    import torch

    import kubernetes_tpu_torch.scheduler as TS

    real = TS.commit_by_auction
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(TS, "commit_by_auction",
                        lambda spec, ports, fit, dev: real(
                            spec, ports, fit, torch.device("cuda")))
    nodes, namespaces, phases, batch, node_cap = TOPOLOGY[case]()
    want, _ = _topology_drain(False, nodes, namespaces, phases, batch,
                              node_cap, 0)
    got, stats = _topology_drain(True, nodes, namespaces, phases, batch,
                                 node_cap, 0)
    assert all(want.values()), "the reference left pods unbound"
    diff = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
    assert not diff, f"{len(diff)} pods bound differently, e.g. " \
        f"{list(diff.items())[:3]}"
    assert stats["round_trips"] > 0


def _parked(sched):
    return {qp.pod.metadata.name: sorted(qp.unschedulable_plugins)
            for qp in sched.queue._unschedulable.values()}


@pytest.mark.parametrize("kind", ["anti_affinity", "host_port"])
def test_parked_pods_name_the_same_plugins(kind):
    """More pods than the constraint lets bind: the rest park with the
    same diagnosis in both packages — InterPodAffinity for hostname
    anti-affinity, NodePorts for an in-batch hostPort clash (the reject
    columns the serial scan fills)."""
    from kubernetes_tpu.api.objects import ContainerPort

    def pods():
        if kind == "anti_affinity":
            return [JW._anti_affinity_pod(i, "sched-0") for i in range(6)]
        out = [_pod(f"port-{i}") for i in range(6)]
        for p in out:
            p.spec.containers[0].ports = [ContainerPort(host_port=8080)]
        return out

    results = []
    for port in (False, True):
        nodes, batch = [_node(i) for i in range(4)], pods()
        namespaces = _sched_ns()
        if port:
            nodes, batch = to_port(nodes), to_port(batch)
            namespaces = to_port(namespaces)
            hub, cfg = THub(), t_config()
            caps = TCaps(nodes=8, pods=64)
        else:
            hub, cfg = JHub(), j_config()
            caps = JCaps(nodes=8, pods=64)
        cfg.batch_size = 8
        sched = (TScheduler(hub, cfg, caps=caps, now=_clock(), device="cpu")
                 if port else JScheduler(hub, cfg, caps=caps, now=_clock()))
        try:
            for n in nodes:
                hub.create_node(n)
            for ns in namespaces:
                hub.create_namespace(ns)
            for p in batch:
                hub.create_pod(p)
            sched.run_until_idle()
            bound = {p.metadata.name: p.spec.node_name
                     for p in hub.list_pods()}
            results.append((bound, _parked(sched)))
        finally:
            sched.close()
    (jb, jp), (tb, tp) = results
    assert jb == tb
    assert jp == tp and len(tp) == 2
    want = "InterPodAffinity" if kind == "anti_affinity" else "NodePorts"
    assert all(want in v for v in tp.values()), tp


def test_commit_engine_gate():
    """commit_by_auction, the reference's engine rule with the launch
    device standing for jax.default_backend(): a soft-only topology batch
    takes the auction on the card and the scan on the CPU; a hard
    topology batch, a batch with host ports and a profile without
    NodeResourcesFit take the scan on both; a plain batch the auction."""
    from types import SimpleNamespace

    import torch

    from kubernetes_tpu_torch.scheduler import commit_by_auction

    def spec(topology, soft):
        return SimpleNamespace(enable_topology=topology, topo_soft=soft)

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for dev in (cuda, cpu):
        assert commit_by_auction(spec(False, False), False, True, dev)
        assert not commit_by_auction(spec(True, False), False, True, dev)
        assert not commit_by_auction(spec(True, True), True, True, dev)
        assert not commit_by_auction(spec(False, False), True, True, dev)
        assert not commit_by_auction(spec(True, True), False, False, dev)
    assert commit_by_auction(spec(True, True), False, True, cuda)
    assert not commit_by_auction(spec(True, True), False, True, cpu)
