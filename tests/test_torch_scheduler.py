"""The slice as a whole: the SchedulingBasic drain through each package's
own Hub + Scheduler (the port on the CPU, where its kernels' plain twins
run), same perf/workloads.py nodes and pods, same batch size, node bucket
and tie_break_seed, then run_until_idle. The {pod: node} maps must be
identical. Both schedulers get the same deterministic clock, so queue
timestamps (and with them the batches) cannot tie differently."""

import itertools

import pytest

from kubernetes_tpu.config.types import default_config as j_config
from kubernetes_tpu.hub import Hub as JHub
from kubernetes_tpu.ops.features import Capacities as JCaps
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
