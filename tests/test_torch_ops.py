"""The port's filter/score twins (kubernetes_tpu_torch/ops) against the JAX
package's ops on the golden tables of tests/test_kernels.py,
tests/test_golden.py and tests/test_golden_more.py, plus seeded fuzz.

The same objects are packed by both packages' Mirrors; each JAX function
is vmapped over the pod batch and compared with the port's batched twin.
Masks and the integer-valued scores must match exactly; the float scores
(image locality, fit strategies, balanced allocation, normalizers) also
match exactly, because the twins keep the reference's operation order."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.objects import (
    NodeSelectorRequirement,
    NodeSelectorTerm,
    PreferredSchedulingTerm,
    Taint,
)
from kubernetes_tpu.backend.cache import Cache as JCache
from kubernetes_tpu.backend.mirror import Mirror as JMirror
from kubernetes_tpu.backend.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu.ops import common as JC
from kubernetes_tpu.ops import filters as JF
from kubernetes_tpu.ops import scores as JS
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.mirror import Mirror as TMirror
from kubernetes_tpu_torch.backend.snapshot import Snapshot as TSnapshot
from kubernetes_tpu_torch.kernels.auction import tie_perturb
from kubernetes_tpu_torch.ops import common as TC
from kubernetes_tpu_torch.ops import filters as TF
from kubernetes_tpu_torch.ops import scores as TS
from kubernetes_tpu_torch.ops.features import Capacities as TCaps
from kubernetes_tpu_torch.ops.features import unpack_cluster, unpack_pods
from tests import test_golden_more as GM
from tests import test_kernels as GK
from tests.test_golden import _mknode, _mkpod
from tests.torch_port_support import fuzz_cluster, to_port

pytestmark = pytest.mark.torch_port


class DualRig:
    """One cluster and pod batch packed by both packages' Mirrors."""

    def __init__(self, nodes, scheduled=(), pods=(), n_cap=16):
        self.n_pods = len(pods)
        b = max(1, len(pods))
        jc, tc = JCache(), TCache()
        for n in nodes:
            jc.add_node(n)
            tc.add_node(to_port(n))
        for p in scheduled:
            jc.add_pod(p)
            tc.add_pod(to_port(p))
        js, ts = JSnapshot(), TSnapshot()
        jc.update_snapshot(js)
        tc.update_snapshot(ts)
        jm = JMirror(caps=JCaps(nodes=n_cap, pods=64))
        tm = TMirror(caps=TCaps(nodes=n_cap, pods=64), device="cpu")
        jm.sync(js)
        tm.sync(ts)
        self.jct = jm.to_device()
        self.jpf = jm.pack_batch(list(pods), b)
        self.tct = unpack_cluster(tm.to_blobs(), tm.caps)
        self.tpf = unpack_pods(
            tm.pack_batch_blobs([to_port(p) for p in pods], b), tm.caps)
        self.jwk, self.twk = jm.well_known(), tm.well_known()

    def jax(self, fn):
        """[B, N] of a one-pod JAX function vmapped over the batch."""
        return np.asarray(jax.vmap(lambda p: fn(self.jct, p))(self.jpf))

    def check(self):
        j, t = self.jax, (lambda fn: fn(self.tct, self.tpf).numpy())
        jwk, twk = self.jwk, self.twk
        pairs = {
            "node_unschedulable": (
                j(lambda c, p: JF.node_unschedulable(
                    c, p, jwk["unschedulable_taint_key"])),
                t(lambda c, p: TF.node_unschedulable(
                    c, p, twk["unschedulable_taint_key"]))),
            "node_name": (j(JF.node_name), t(TF.node_name)),
            "taint_toleration": (j(JF.taint_toleration),
                                 t(TF.taint_toleration)),
            "node_affinity": (j(JF.node_affinity), t(TF.node_affinity)),
            "node_affinity_pin": (
                j(lambda c, p: JF.node_affinity(c, p, full=False)),
                t(lambda c, p: TF.node_affinity(c, p, full=False))),
            "node_ports": (
                j(lambda c, p: JF.node_ports(c, p, jwk["wildcard_ip"])),
                t(lambda c, p: TF.node_ports(c, p, twk["wildcard_ip"]))),
            "taint_toleration_score": (j(JS.taint_toleration_score),
                                       t(TS.taint_toleration_score)),
            "node_affinity_score": (j(JS.node_affinity_score),
                                    t(TS.node_affinity_score)),
            "image_locality": (
                j(lambda c, p: JS.image_locality(
                    c, p, jnp.sum(c.node_valid))),
                t(lambda c, p: TS.image_locality(c, p, c.node_valid.sum()))),
        }
        for name, (want, got) in pairs.items():
            assert want.shape == got.shape, name
            assert np.array_equal(want, got), (
                f"{name}: port differs from JAX at "
                f"{np.argwhere(want != got)[:5].tolist()}")


def _kernels_taints():
    nodes = [GK.mknode(f"n{i}", taints=t)
             for i, (t, _, _) in enumerate(GK.TAINT_CASES)]
    pods = [GK.mkpod(f"p{i}", tolerations=tols)
            for i, (_, tols, _) in enumerate(GK.TAINT_CASES)]
    return nodes, [], pods


def _kernels_affinity():
    pods = list(GK.AFFINITY_PODS) + [GK._affinity_pod(preferred=[
        PreferredSchedulingTerm(weight=5, preference=NodeSelectorTerm(
            match_expressions=[NodeSelectorRequirement(
                "disk", "In", ["ssd"])])),
        PreferredSchedulingTerm(weight=2, preference=NodeSelectorTerm(
            match_expressions=[NodeSelectorRequirement(
                "zone", "Exists")]))])]
    for i, p in enumerate(pods):
        p.metadata.name = f"aff-{i}"
    return list(GK.AFFINITY_NODES), [], pods


def _kernels_ports_images():
    big = 800 * 1024 * 1024
    nodes = [GK.mknode("n1", images=[("redis:7", big)]),
             GK.mknode("n2", images=[("redis:7", 300 * 1024 * 1024),
                                     ("nginx", big)]),
             GK.mknode("n3", unsched=True),
             GK.mknode("n4", taints=[
                 Taint("a", effect="PreferNoSchedule"),
                 Taint("b", effect="PreferNoSchedule")])]
    scheduled = [
        GK.mkpod("busy", node_name="n1", host_ports=[("", "TCP", 8080)]),
        GK.mkpod("busy2", node_name="n2",
                 host_ports=[("10.0.0.1", "TCP", 9000)])]
    pods = [GK.mkpod("p", host_ports=[("", "TCP", 8080)]),
            GK.mkpod("p2", host_ports=[("", "TCP", 9000)]),
            GK.mkpod("p3", host_ports=[("", "UDP", 8080)]),
            GK.mkpod("img", image="redis:7"),
            GK.mkpod("img2", image="nginx", node_name="n2"),
            GK.mkpod("plain", cpu="1", mem="1Gi")]
    return nodes, scheduled, pods


def _more_node_affinity():
    node = _mknode("the-node", labels={"foo": "bar", "gpu": "2"})
    pods = [_mkpod(f"na-{i}", req={"cpu": "100m"}, affinity=aff)
            for i, (_, aff, _) in enumerate(GM.NODE_AFFINITY_CASES)]
    return [node, _mknode("other", labels={"foo": "baz"})], [], pods


def _more_taints():
    nodes, pods = [], []
    for i, (_, taints, tols, _) in enumerate(GM.TAINT_CASES):
        node = _mknode(f"t{i}")
        node.spec.taints = taints
        nodes.append(node)
        pod = _mkpod(f"tp{i}", req={"cpu": "100m"})
        pod.spec.tolerations = tols
        pods.append(pod)
    return nodes, [], pods


def _more_ports():
    nodes, scheduled, pods = [], [], []
    for i, (_, want, existing, _) in enumerate(GM.PORT_CASES):
        nodes.append(_mknode(f"pn{i}"))
        if existing:
            scheduled.append(GM._port_pod(f"run{i}", existing,
                                          node=f"pn{i}"))
        pods.append(GM._port_pod(f"in{i}", want) if want
                    else _mkpod(f"in{i}", req={"cpu": "100m"}))
    return nodes, scheduled, pods


def _fuzz(seed):
    def build():
        nodes, bound, pods = fuzz_cluster(random.Random(seed), 40, 24, 12)
        return nodes, bound, pods
    return build


CASES = {
    "kernels_taints": _kernels_taints,
    "kernels_affinity": _kernels_affinity,
    "kernels_ports_images": _kernels_ports_images,
    "golden_more_node_affinity": _more_node_affinity,
    "golden_more_taints": _more_taints,
    "golden_more_ports": _more_ports,
    "fuzz_1": _fuzz(1),
    "fuzz_2": _fuzz(2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_filters_and_raw_scores_match_jax(case):
    nodes, scheduled, pods = CASES[case]()
    DualRig(nodes, scheduled, pods,
            n_cap=16 if len(nodes) <= 16 else 64).check()


def _fractions(rng, b, n):
    alloc2 = rng.choice([0.0, 1000.0, 4000.0, 32768.0], size=(n, 2))
    nzr = rng.integers(0, 5000, size=(n, 2)).astype(np.float32)
    nzreq = rng.integers(0, 3000, size=(b, 2)).astype(np.float32)
    return (alloc2.astype(np.float32), nzr, nzreq)


@pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated",
                                      "RequestedToCapacityRatio"])
def test_fit_and_balanced_scores_match_jax(strategy):
    rng = np.random.default_rng(3)
    alloc2, nzr, nzreq = _fractions(rng, 6, 40)
    shape = (np.asarray([0.0, 0.3, 0.3, 1.0], np.float32),
             np.asarray([100.0, 40.0, 60.0, 0.0], np.float32))
    jfrac = jax.vmap(lambda q: JS.utilization_fractions(
        jnp.asarray(alloc2), jnp.asarray(nzr), q))(jnp.asarray(nzreq))
    tfrac = TS.utilization_fractions(torch.from_numpy(alloc2),
                                     torch.from_numpy(nzr),
                                     torch.from_numpy(nzreq))
    assert np.array_equal(np.asarray(jfrac), tfrac.numpy())
    jshape = tuple(jnp.asarray(s) for s in shape)
    tshape = tuple(torch.from_numpy(s) for s in shape)
    want = np.asarray(JS.fit_score_from_fractions(jfrac, strategy, jshape))
    got = TS.fit_score_from_fractions(tfrac, strategy, tshape).numpy()
    if strategy == "RequestedToCapacityRatio":
        # XLA on the CPU contracts jnp.interp's `fp + (delta / dx) * df`
        # into one fused multiply-add; the port rounds the product first
        # (its kernels are built -fmad=false), so the two differ by at
        # most an ulp of a 0-100 score: 1e-4 absolute
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        assert np.array_equal(want, got)
    want = np.asarray(JS.balanced_allocation_from_fractions(jfrac))
    got = TS.balanced_allocation_from_fractions(tfrac).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalizers_match_jax(seed):
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 4, size=(8, 32)).astype(np.float32)
    scores[1] = 0.0                                  # max 0 -> top 1
    mask = rng.random((8, 32)) < 0.5
    mask[2] = False                                  # no candidate
    js, jm = jnp.asarray(scores), jnp.asarray(mask)
    ts, tm = torch.from_numpy(scores), torch.from_numpy(mask)
    for jfn, tfn in ((JS.normalize_max, TS.normalize_max),
                     (JS.normalize_inverse, TS.normalize_inverse)):
        want = np.asarray(jax.vmap(jfn)(js, jm))
        assert np.array_equal(want, tfn(ts, tm).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topology_normalizers_match_jax(seed):
    """normalize_maxmin (InterPodAffinity) and normalize_spread
    (PodTopologySpread), and masked_min, on float scores with negative
    values, all-equal rows, empty masks and ignored nodes."""
    rng = np.random.default_rng(100 + seed)
    scores = (rng.integers(-40, 40, size=(8, 32)).astype(np.float32)
              + rng.random((8, 32)).astype(np.float32))
    scores[1] = 3.0                                  # all equal -> 0
    scores[3] = -scores[3]
    mask = rng.random((8, 32)) < 0.6
    mask[2] = False                                  # no candidate
    ignored = rng.random((8, 32)) < 0.2
    ignored[4] = True                                # nothing live
    js, jm, ji = jnp.asarray(scores), jnp.asarray(mask), jnp.asarray(ignored)
    ts, tm, ti = (torch.from_numpy(x) for x in (scores, mask, ignored))
    want = np.asarray(jax.vmap(JS.normalize_maxmin)(js, jm))
    assert np.array_equal(want, TS.normalize_maxmin(ts, tm).numpy())
    spread = np.abs(scores)
    want = np.asarray(jax.vmap(JS.normalize_spread)(jnp.asarray(spread), jm,
                                                    ji))
    got = TS.normalize_spread(torch.from_numpy(spread), tm, ti).numpy()
    assert np.array_equal(want, got)
    want = np.asarray(jax.vmap(JC.masked_min)(js, jm))
    assert np.array_equal(want, TC.masked_min(ts, tm).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_pod_pair_port_conflict_matches_jax(seed):
    """[B, B] in-batch hostPort clashes, wildcard IP included."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    b, hp, wild = 24, 4, 7
    port = rng.choice([-1, -1, 80, 8080, 9090], size=(b, hp)).astype(np.int32)
    proto = rng.integers(0, 2, size=(b, hp)).astype(np.int32)
    ip = rng.choice([wild, 3, 4, 5], size=(b, hp)).astype(np.int32)
    jpods = SimpleNamespace(hp_port=jnp.asarray(port),
                            hp_proto=jnp.asarray(proto), hp_ip=jnp.asarray(ip))
    tpods = SimpleNamespace(hp_port=torch.from_numpy(port),
                            hp_proto=torch.from_numpy(proto),
                            hp_ip=torch.from_numpy(ip))
    want = np.asarray(JF.pod_pair_port_conflict(jpods, jnp.int32(wild)))
    got = TF.pod_pair_port_conflict(tpods, wild).numpy()
    assert want.any() and not want.all()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("seed", [None, 0, 7, 0xFFFFFFFF])
def test_tie_perturb_bit_equal(seed):
    rng = np.random.default_rng(11)
    b = np.concatenate([rng.integers(0, 2 ** 31 - 1, size=30),
                        [0, 1, 2 ** 31 - 1]]).astype(np.int32)
    n = 257
    jseed = None if seed is None else np.uint32(seed)
    want = np.stack([np.asarray(JP.tie_perturb(int(x), n, jseed))
                     for x in b])
    got = tie_perturb(torch.from_numpy(b), n, seed).numpy()
    assert want.dtype == got.dtype
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


def test_masked_argmax_random_engineered_ties():
    score = np.asarray([
        [5.0, 7.0, 7.0, 7.0, 1.0],    # three-way tie on the top score
        [2.0, 2.0, 2.0, 2.0, 2.0],    # all equal, equal perturbs
        [1.0, 9.0, 3.0, 9.0, 0.0],    # top ties masked out partly
        [4.0, 4.0, 4.0, 4.0, 4.0],    # nothing feasible
        [1.0, np.nan, 3.0, 2.0, 0.0],  # NaN candidate
    ], np.float32)
    perturb = np.asarray([
        [0.9, 0.2, 0.6, 0.6, 0.1],
        [0.5, 0.5, 0.5, 0.5, 0.5],
        [0.1, 0.3, 0.9, 0.8, 0.2],
        [0.1, 0.2, 0.3, 0.4, 0.5],
        [0.1, 0.2, 0.3, 0.4, 0.5],
    ], np.float32)
    mask = np.asarray([
        [True, True, True, True, True],
        [True, True, True, True, True],
        [True, False, True, True, True],
        [False, False, False, False, False],
        [True, True, True, True, True],
    ])
    want = np.asarray(jax.vmap(JC.masked_argmax_random)(
        jnp.asarray(score), jnp.asarray(mask), jnp.asarray(perturb)))
    got = TC.masked_argmax_random(torch.from_numpy(score),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(perturb)).numpy()
    assert want.tolist() == got.tolist() == [2, 0, 3, -1, 0]
