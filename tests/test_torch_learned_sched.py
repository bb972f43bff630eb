"""The learned scorer end to end: a LearnedScore profile
(tests/test_learned.py ``_learned_cfg``) through each package's own Hub
+ Scheduler on the CPU, the port running its kernels' twins.

Both Schedulers read the same checkpoint file, get the same nodes and
pods, batch size, node bucket, deterministic clock and tie_break_seed,
and must bind every pod to the same node: plain pods (the auction), a
reduced TopologySpreading (the serial scan) and a reduced
PreferredTopologySpreading (the serial scan on the CPU, where both
packages take it; the soft auction is held in
tests/test_torch_learned_launch.py). A checkpoint published between two
phases is picked up by both (a reload, no new pack per launch); the
perf harness's learned profile (perf/workloads.py learned_config, the
reference's ``bench.py --ab-scorer`` arm) drains in both packages
identically.

Stated deviation: params that carry a NaN past the loader trip the
launch guard and the port's Scheduler raises DeviceFault, where the
reference degrades the batch to hand-tuned weights on its host fallback
ladder (tests/test_learned.py::test_nan_params_fire_fallback_ladder),
which the port gains with ROADMAP queue 1 item 11.
"""

import itertools
import os

import numpy as np
import pytest

from kubernetes_tpu.config.types import Plugin as JPlugin
from kubernetes_tpu.config.types import default_config as j_config
from kubernetes_tpu.hub import Hub as JHub
from kubernetes_tpu.learn import checkpoint as JCK
from kubernetes_tpu.learn.train import init_params as j_init
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu.perf import harness as JH
from kubernetes_tpu.perf import workloads as JW
from kubernetes_tpu.perf.workloads import _node, _pod
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.config.types import Plugin as TPlugin
from kubernetes_tpu_torch.config.types import default_config as t_config
from kubernetes_tpu_torch.hub import Hub as THub
from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.ops.features import Capacities as TCaps
from kubernetes_tpu_torch.perf import harness as TH
from kubernetes_tpu_torch.perf import workloads as TW
from kubernetes_tpu_torch.scheduler import DeviceFault
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from tests.torch_port_support import to_port

pytestmark = pytest.mark.torch_port


def _clock():
    tick = itertools.count()
    return lambda: 1000.0 + next(tick) * 1e-3


def _publish(path, seed, version, hidden=(8,)):
    """A scorer from the JAX package's init_params, the head scaled so the
    term varies inside its clip, written by the JAX package's
    save_checkpoint (the port reads the same document)."""
    params = [[np.asarray(w), np.asarray(b)]
              for w, b in j_init(seed=seed, hidden=hidden)]
    params[-1][0] = params[-1][0] * np.float32(20.0)
    params[-1][1] = np.full((1,), 50.0, np.float32)
    JCK.save_checkpoint(path, tuple(tuple(p) for p in params),
                        meta={"version": version})
    # a distinct mtime, whatever the file system's resolution
    os.utime(path, (1e9 + version, 1e9 + version))


def _learned_cfg(port, ckpt_path, batch, seed, weight=1.0):
    cfg = t_config() if port else j_config()
    cfg.batch_size = batch
    cfg.tie_break_seed = seed
    prof = cfg.profiles[0]
    plugin = TPlugin if port else JPlugin
    prof.plugins.score.enabled.append(plugin("LearnedScore", weight))
    prof.plugin_config["LearnedScore"] = {"checkpoint_path": ckpt_path}
    return cfg


def _drain(port, cfg, nodes, phases, node_cap, between=None):
    """Nodes, then each phase's pods drained to the end (``between(i)``
    runs before phase i > 0); the {pod: node} map and the scheduler."""
    if port:
        nodes = to_port(nodes)
        phases = [to_port(ph) for ph in phases]
        hub, caps = THub(), TCaps(nodes=node_cap, pods=512)
        sched = TScheduler(hub, cfg, caps=caps, now=_clock(), device="cpu")
    else:
        hub, caps = JHub(), JCaps(nodes=node_cap, pods=512)
        sched = JScheduler(hub, cfg, caps=caps, now=_clock())
    try:
        for n in nodes:
            hub.create_node(n)
        for i, phase in enumerate(phases):
            if i and between is not None:
                between(i)
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
        sched


def _plain():
    nodes = [_node(i) for i in range(40)]
    return nodes, [[_pod(f"init-{i}") for i in range(60)],
                   [_pod(f"measure-{i}", cpu=f"{100 + 50 * (i % 5)}m")
                    for i in range(160)]], 64


def _spreading():
    zones = ["moon-1", "moon-2", "moon-3"]
    nodes = [_node(i, zones=zones) for i in range(30)]
    return nodes, [[_pod(f"init-{i}") for i in range(40)],
                   [JW._spreading_pod(i) for i in range(60)]], 32


def _preferred_spreading():
    zones = ["moon-1", "moon-2", "moon-3"]
    nodes = [_node(i, zones=zones) for i in range(30)]
    return nodes, [[_pod(f"init-{i}") for i in range(40)],
                   [JW._preferred_spreading_pod(i) for i in range(60)]], 32


CASES = {"plain": _plain, "topology_spreading": _spreading,
         "preferred_topology_spreading": _preferred_spreading}


def _assert_same(want, got):
    assert all(want.values()), "the reference left pods unbound"
    diff = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
    assert not diff, f"{len(diff)} pods bound differently, e.g. " \
        f"{list(diff.items())[:3]}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_learned_profile_binds_identically(case, tmp_path):
    path = str(tmp_path / "scorer.json")
    _publish(path, seed=0, version=1)
    nodes, phases, node_cap = CASES[case]()
    batch = 32
    want, _ = _drain(False, _learned_cfg(False, path, batch, 11), nodes,
                     phases, node_cap)
    got, sched = _drain(True, _learned_cfg(True, path, batch, 11), nodes,
                        phases, node_cap)
    _assert_same(want, got)
    mgr = sched._profile_cfg["default-scheduler"]["learned"]
    assert isinstance(mgr.params(), KL.LearnedParams)
    assert mgr.stats()["loads"] == 1 and mgr.reloads == 0
    assert sched.stats["launches"] >= 2
    assert sched.stats["time_s"]["learned_score"] > 0
    if case == "plain":
        # the learned term changed the outcome: the hand profile binds
        # differently (same pods, same seed)
        cfg = t_config()
        cfg.batch_size, cfg.tie_break_seed = batch, 11
        hand, _ = _drain(True, cfg, nodes, phases, node_cap)
        assert hand != got


def test_checkpoint_swapped_mid_run_is_picked_up(tmp_path):
    """A second checkpoint (seed 1) published between the phases: both
    Schedulers reload it and bind the second phase identically."""
    path = str(tmp_path / "scorer.json")
    nodes, phases, node_cap = _plain()
    results = []
    for port in (False, True):
        _publish(path, seed=0, version=1)
        got, sched = _drain(port, _learned_cfg(port, path, 32, 5), nodes,
                            phases, node_cap,
                            between=lambda i: _publish(path, seed=1,
                                                       version=2))
        mgr = sched._profile_cfg["default-scheduler"]["learned"]
        assert mgr.version == 2 and mgr.reloads == 1
        results.append(got)
    _assert_same(*results)


def test_nan_params_raise_device_fault(tmp_path):
    """Params that go bad past the loader: every total is NaN, the launch
    guard trips and the port's Scheduler raises DeviceFault (the
    reference's host fallback ladder is ROADMAP queue 1 item 11)."""
    path = str(tmp_path / "good.json")
    _publish(path, seed=0, version=1)
    hub = THub()
    sched = TScheduler(hub, _learned_cfg(True, path, 16, 0),
                       caps=TCaps(nodes=16, pods=64), now=_clock(),
                       device="cpu")
    try:
        mgr = sched._profile_cfg["default-scheduler"]["learned"]
        assert mgr.maybe_reload() and mgr.params() is not None
        nan_w = np.full((9, 1), np.nan, np.float32)
        mgr._device_params = KL.LearnedParams.pack(
            ((nan_w, np.zeros((1,), np.float32)),), "cpu")
        mgr.maybe_reload = lambda: False      # keep the poison served
        for n in to_port([_node(i) for i in range(4)]):
            hub.create_node(n)
        for p in to_port([_pod(f"p{i}") for i in range(3)]):
            hub.create_pod(p)
        with pytest.raises(DeviceFault, match="NaN scores"):
            sched.run_until_idle()
    finally:
        sched.close()


def test_harness_learned_config_drains_identically(tmp_path):
    """perf/workloads.py learned_config, the reference's --ab-scorer arm,
    through both harnesses on a reduced SchedulingBasic (each harness's
    Scheduler captured through its module global): identical bindings."""
    path = str(tmp_path / "scorer.json")
    _publish(path, seed=2, version=1)
    maps = []
    for port in (False, True):
        H, W = (TH, TW) if port else (JH, JW)
        cfg = (TW.learned_config(path, tie_seed=7) if port
               else _learned_cfg(False, path, 0, 7))
        w = W.scheduling_basic(init_nodes=50, init_pods=40,
                               measure_pods=200)
        w.batch_size, w.node_capacity, w.pod_capacity = 64, 64, 512
        seen, real = {}, H.Scheduler

        def capture(*a, real=real, seen=seen, **kw):
            seen["s"] = real(*a, **kw)
            return seen["s"]

        H.Scheduler = capture
        try:
            H.run_workload(w, now=_clock(), sleep=lambda dt: None,
                           config=cfg, **({"device": "cpu"} if port else {}))
        finally:
            H.Scheduler = real
        maps.append({p.metadata.name: p.spec.node_name
                     for p in seen["s"].hub.list_pods()})
    _assert_same(*maps)
    assert len(maps[1]) == 240
    prof = TW.learned_config(path).profiles[0]
    assert ("LearnedScore", 1.0) in [(p.name, p.weight)
                                     for p in prof.plugins.score.enabled]
    assert prof.plugin_config["LearnedScore"] == {"checkpoint_path": path}
