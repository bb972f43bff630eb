"""The port's Mirror packs the same snapshot into the same blobs as the
JAX Mirror, bit for bit: node rows (taints, label columns, ports, images,
directed f32 resource rounding), the scheduled-pod table, the subset pod
batch blobs, the phase-1 and topology dedup groups (gid / rep / g_cap),
and a topology launch's domain bucket (d_cap) and soft-only flag."""

import copy
import random

import numpy as np
import pytest

from kubernetes_tpu.backend.cache import Cache as JCache
from kubernetes_tpu.backend.mirror import Mirror as JMirror
from kubernetes_tpu.backend.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.mirror import Mirror as TMirror
from kubernetes_tpu_torch.backend.snapshot import Snapshot as TSnapshot
from kubernetes_tpu_torch.ops.features import Capacities as TCaps
import kubernetes_tpu.api.objects as jax_objects
from kubernetes_tpu_torch.perf.fuzz import topology_fuzz
from tests.torch_port_support import fuzz_cluster, to_port

pytestmark = pytest.mark.torch_port


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype == np.bool_ else
                  np.dtype(f"u{a.dtype.itemsize}"))


def _specs(seed, n_nodes, n_pods, n_bound, homogeneous):
    nodes, bound, pods = fuzz_cluster(random.Random(seed), n_nodes, n_pods,
                                      n_bound)
    if homogeneous:
        # deployment-shaped batch: few distinct specs, so the phase-1
        # dedup groups engage
        base = pods[:3]
        pods = []
        for i in range(n_pods):
            p = copy.deepcopy(base[i % 3])
            p.metadata.name = f"dep-{i}"
            p.metadata.uid = f"dep-uid-{seed}-{i}"
            pods.append(p)
    return nodes, bound, pods


def _launch_pair(nodes, bound, pods, n_cap, batch, churn=None):
    out = []
    for pkg in ("jax", "torch"):
        conv = (lambda x: x) if pkg == "jax" else to_port
        cache = (JCache if pkg == "jax" else TCache)()
        for n in nodes:
            cache.add_node(conv(n))
        for p in bound:
            cache.add_pod(conv(p))
        snap = (JSnapshot if pkg == "jax" else TSnapshot)()
        cache.update_snapshot(snap)
        if pkg == "jax":
            mirror = JMirror(caps=JCaps(nodes=n_cap, pods=256))
        else:
            mirror = TMirror(caps=TCaps(nodes=n_cap, pods=256), device="cpu")
        mirror.sync(snap)
        if churn is not None:
            # an incremental re-sync: some nodes leave, bound pods move
            churn(cache, conv)
            cache.update_snapshot(snap)
            mirror.sync(snap)
        out.append(mirror.prepare_launch([conv(p) for p in pods], batch))
    return out


def _assert_same(js, ts):
    for f in ("node_f32", "node_i32", "pods_i32"):
        want, got = np.asarray(getattr(js.cblobs, f)), \
            getattr(ts.cblobs, f).numpy()
        assert want.dtype == got.dtype and want.shape == got.shape, f
        assert np.array_equal(_bits(want), _bits(got)), f
    for f in ("f32", "i32"):
        assert np.array_equal(_bits(getattr(js.pblobs, f)),
                              _bits(getattr(ts.pblobs, f).numpy())), f
        assert np.array_equal(_bits(getattr(js.ptmpl, f)),
                              _bits(getattr(ts.ptmpl, f).numpy())), f
    assert js.active == ts.active
    assert js.pfields == ts.pfields
    assert js.enable_topology == ts.enable_topology
    assert js.d_cap == ts.d_cap
    assert js.topo_soft == ts.topo_soft
    assert js.g_cap == ts.g_cap
    assert (js.gid is None) == (ts.gid is None)
    if js.gid is not None:
        assert np.array_equal(np.asarray(js.gid), ts.gid.numpy())
        assert np.array_equal(np.asarray(js.rep), ts.rep.numpy())


@pytest.mark.parametrize("seed,homogeneous", [(1, False), (2, True),
                                              (3, False), (4, True)])
def test_mirror_blobs_bit_identical(seed, homogeneous):
    nodes, bound, pods = _specs(seed, 60, 40, 30, homogeneous)
    js, ts = _launch_pair(nodes, bound, pods, 64, 64)
    if homogeneous:
        assert ts.gid is not None and ts.g_cap == 8
    _assert_same(js, ts)


def test_mirror_incremental_resync_bit_identical():
    nodes, bound, pods = _specs(5, 50, 20, 25, False)
    removed = [n.metadata.name for n in nodes[:5]]

    def churn(cache, conv):
        for name in removed:
            for n in nodes:
                if n.metadata.name == name:
                    cache.remove_node(conv(n))
        for p in bound[:10]:
            if p.spec.node_name not in removed:
                cache.remove_pod(conv(p))

    js, ts = _launch_pair(nodes, bound, pods, 64, 32, churn)
    _assert_same(js, ts)


@pytest.mark.parametrize("seed,soft", [(6, False), (7, False), (8, True)])
def test_topology_launch_bit_identical(seed, soft):
    """A table and a batch carrying required and preferred pod
    (anti)affinity and spread constraints over hostname, zone and rack
    keys (the soft case keeps only preferred terms and ScheduleAnyway
    spread in the batch)."""
    nodes, bound, specs, _ = topology_fuzz(random.Random(seed), 40, 50, 5,
                                           objects=jax_objects)
    pods = []
    for i in range(30):
        p = copy.deepcopy(specs[i % len(specs)])
        p.metadata.name = f"topo-{i}"
        p.metadata.uid = f"topo-uid-{seed}-{i}"
        if soft:
            p.spec.affinity.pod_affinity.required = []
            p.spec.affinity.pod_anti_affinity.required = []
            for t in p.spec.topology_spread_constraints:
                t.when_unsatisfiable = "ScheduleAnyway"
                t.min_domains = None
        pods.append(p)
    js, ts = _launch_pair(nodes, bound, pods, 64, 32)
    assert ts.enable_topology and ts.gid is not None
    assert ts.topo_soft == soft
    assert ts.d_cap == 64     # hostname domains: 40 nodes
    _assert_same(js, ts)
