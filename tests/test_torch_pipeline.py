"""The port's batched launch (launch_batch: phase 1 + the auction, run
here through the kernels' plain-torch twins) against the JAX package's
launch_batch(serial_scan=False) on the same packed launch.

Each case packs a cluster and a batch with the JAX Mirror, hands the very
same arrays to the port (kubernetes_tpu_torch.convert), and compares the
BatchResults: node rows, feasible and reject counts, unresolvable counts,
the post-batch free/nzr chain and the guard must be EXACT. The winning
scores must agree within 1e-4 absolute (on a 0-900 scale): XLA on the CPU
may fuse a multiply-add of the weighted total into one FMA, while the port
(and its kernels, built -fmad=false) rounds every product separately, so
the two may differ in the last bit; that never moved a placement in these
cases, which the exact node rows check."""

import collections
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.objects import (
    Affinity,
    Container,
    LabelSelectorRequirement,
    NodeAffinity,
    NodeSelector,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodSpec,
    ResourceRequirements,
    Toleration,
)
from kubernetes_tpu.backend.cache import Cache
from kubernetes_tpu.backend.mirror import Mirror
from kubernetes_tpu.backend.snapshot import Snapshot
from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu.models.testbed import make_node as tb_node
from kubernetes_tpu.models.testbed import make_pod as tb_pod
from kubernetes_tpu.ops import scores as JS
from kubernetes_tpu.ops.features import Capacities
from kubernetes_tpu.ops.features import unpack_cluster as j_unpack_cluster
from kubernetes_tpu.ops.features import unpack_pods as j_unpack_pods
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.kernels.phase1 import phase1_static_ref
from kubernetes_tpu_torch.models import pipeline as TP
from kubernetes_tpu_torch.ops.features import Capacities as TCaps
from tests.test_golden import FIT_CASES, _mknode, _mkpod
from tests.test_oracle import fuzz_pod as oracle_pod
from tests.test_oracle import mknode as oracle_node
from tests.torch_port_support import fuzz_cluster

pytestmark = pytest.mark.torch_port

EXACT = ("node_row", "feasible_count", "reject_counts", "unresolvable_count",
         "free", "nzr", "guard")
SCORE_ATOL = 1e-4


def _mirror(nodes, bound, caps):
    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    mirror = Mirror(caps=caps)
    mirror.sync(snap)
    return mirror


def _port_spec(spec):
    """The JAX launch's arrays, handed to the port as numpy."""
    a = np.asarray
    return convert.launch_from_numpy(
        {"node_f32": a(spec.cblobs.node_f32),
         "node_i32": a(spec.cblobs.node_i32),
         "pods_i32": a(spec.cblobs.pods_i32)},
        {"f32": a(spec.pblobs.f32), "i32": a(spec.pblobs.i32)},
        None if spec.gid is None else a(spec.gid),
        None if spec.rep is None else a(spec.rep),
        ptmpl={"f32": a(spec.ptmpl.f32), "i32": a(spec.ptmpl.i32)},
        active=spec.active, pfields=spec.pfields,
        enable_topology=spec.enable_topology, g_cap=spec.g_cap,
        device="cpu")


def _port_caps(caps):
    return TCaps(**{f: getattr(caps, f)
                    for f in caps.__dataclass_fields__})


def _both(mirror, spec, caps, seed=0, state=None, tstate=None):
    weights = convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})
    jout = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                           caps, serial_scan=False,
                           tie_seed=np.uint32(seed), state=state)
    tout = TP.launch_batch(_port_spec(spec), mirror.well_known(), weights,
                           _port_caps(caps), serial_scan=False,
                           tie_seed=seed, state=tstate, device="cpu")
    return jout, tout


def _assert_same(jout, tout):
    for f in EXACT:
        want, got = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        assert want.shape == got.shape, f
        assert np.array_equal(want, got), (
            f"{f}: port differs from JAX at "
            f"{np.argwhere(want != got)[:5].tolist()}")
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score),
                               rtol=0, atol=SCORE_ATOL)


def _testbed(num_nodes, pods, batch, zones=8):
    caps = Capacities(nodes=64, pods=256)
    mirror = _mirror([tb_node(i, zones=zones) for i in range(num_nodes)], [],
                     caps)
    return mirror, mirror.prepare_launch(pods, batch), caps


def _sel_pod(i, zone):
    req = NodeSelector(node_selector_terms=[NodeSelectorTerm(
        match_expressions=[LabelSelectorRequirement(
            key="topology.kubernetes.io/zone", operator="In",
            values=[zone])])])
    return Pod(metadata=ObjectMeta(name=f"sp-{i}"), spec=PodSpec(
        containers=[Container(name="c", resources=ResourceRequirements(
            requests={"cpu": "100m"}))],
        affinity=Affinity(node_affinity=NodeAffinity(required=req)),
        tolerations=[Toleration(key="k", operator="Exists")]))


def _oracle_fuzz(seed):
    rng = random.Random(100 + seed)
    caps = Capacities(nodes=1024, pods=256)
    nodes = [oracle_node(i, rng) for i in range(1000)]
    pods = []
    for i in range(128):
        p = oracle_pod(i, rng)
        p.spec.affinity = None          # no-topology fuzz: auction domain
        p.spec.topology_spread_constraints = []
        pods.append(p)
    mirror = _mirror(nodes, [], caps)
    return mirror, mirror.prepare_launch(pods, 128), caps


def _rich_fuzz(seed, n_nodes, n_pods, node_cap, batch):
    nodes, bound, pods = fuzz_cluster(random.Random(seed), n_nodes, n_pods,
                                      n_nodes // 4)
    caps = Capacities(nodes=node_cap, pods=256)
    mirror = _mirror(nodes, bound, caps)
    return mirror, mirror.prepare_launch(pods, batch), caps


CASES = {
    # tests/test_auction.py
    "auction_places_all": lambda: _testbed(
        16, [tb_pod(i) for i in range(48)], 64),
    "auction_never_overcommits": lambda: _testbed(
        8, [tb_pod(i, cpu="14000m") for i in range(20)], 32),
    "auction_balance": lambda: _testbed(
        40, [tb_pod(i) for i in range(40)], 64),
    "auction_zero_request_ties": lambda: _testbed(
        32, [tb_pod(i, cpu="0m", mem="0Mi") for i in range(16)], 64),
    "auction_tolerations_affinity": lambda: _testbed(
        8, [_sel_pod(i, f"zone-{i % 2}") for i in range(6)], 8, zones=2),
    # tests/test_oracle.py::test_auction_vs_scan_property_1k_nodes
    "oracle_fuzz_1k_nodes_0": lambda: _oracle_fuzz(0),
    "oracle_fuzz_1k_nodes_1": lambda: _oracle_fuzz(1),
    # taints / affinity / images / ports / bound pods
    "rich_fuzz": lambda: _rich_fuzz(21, 300, 200, 512, 256),
    # B > N: the K-accept branch
    "k_accept": lambda: _rich_fuzz(22, 40, 250, 64, 256),
    "k_accept_testbed": lambda: _testbed(
        20, [tb_pod(i, cpu="2000m") for i in range(200)], 256),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 9])
def test_launch_batch_matches_jax(case, seed):
    mirror, spec, caps = CASES[case]()
    jout, tout = _both(mirror, spec, caps, seed)
    _assert_same(jout, tout)
    if case == "auction_never_overcommits":
        rows = [r for r in tout.node_row.tolist()[:20] if r >= 0]
        assert len(rows) == 16
        assert max(collections.Counter(rows).values()) == 2


def test_chained_state_matches_jax():
    """Launch 2 fed launch 1's (free, nzr) chain, in both packages."""
    caps = Capacities(nodes=64, pods=256)
    mirror = _mirror([tb_node(i) for i in range(4)], [], caps)
    first = [tb_pod(i, cpu="20000m") for i in range(4)]
    second = [tb_pod(100 + i, cpu="20000m") for i in range(4)]
    j1, t1 = _both(mirror, mirror.prepare_launch(first, 8), caps)
    _assert_same(j1, t1)
    spec2 = mirror.prepare_launch(second, 8)
    j2, t2 = _both(mirror, spec2, caps, state=(j1.free, j1.nzr),
                   tstate=(t1.free, t1.nzr))
    _assert_same(j2, t2)
    assert (t2.node_row[:4] < 0).all()


@pytest.mark.parametrize("seed", [31, 32])
def test_phase1_twin_matches_jax_per_pod(seed):
    """K1's twin against the JAX static filters + raw scores, pod by pod."""
    nodes, bound, pods = fuzz_cluster(random.Random(seed), 60, 16, 20)
    caps = Capacities(nodes=64, pods=256)
    mirror = _mirror(nodes, bound, caps)
    spec = mirror.prepare_launch(pods, 16)
    act = frozenset(spec.active)
    wk = mirror.well_known()
    enabled = (True,) * len(JP.FILTER_PLUGINS)
    ct = j_unpack_cluster(spec.cblobs, caps)
    jpods = j_unpack_pods(spec.pblobs, caps, spec.pfields, spec.ptmpl)
    valid = ct.node_valid

    def per_pod(pod):
        masks = JP.static_filters(ct, pod, wk, enabled, act)
        ok = jnp.all(masks, axis=0) & valid & pod.valid
        prev = jnp.cumprod(jnp.concatenate(
            [jnp.ones((1, masks.shape[1]), masks.dtype), masks[:-1]]),
            axis=0).astype(bool)
        rej = jnp.sum(prev & ~masks & valid[None], axis=1).astype(jnp.int32)
        zeros = jnp.zeros(valid.shape, jnp.float32)
        taint = JS.taint_toleration_score(ct, pod) if "taints" in act \
            else zeros
        aff = JS.node_affinity_score(ct, pod) if "nodeaffinity" in act \
            else zeros
        img = JS.image_locality(ct, pod, jnp.sum(valid)) \
            if "images" in act else zeros
        unres = jnp.sum(jnp.any(pod.req[None] > ct.allocatable, axis=-1)
                        & valid).astype(jnp.int32)
        return ok, rej, taint, aff, img, unres

    want = jax.vmap(per_pod)(jpods)
    tspec = _port_spec(spec)
    rows = torch.arange(16)
    prow_f32, prow_i32 = TP.full_pod_rows(tspec.pblobs, tspec.ptmpl,
                                          _port_caps(caps), tspec.pfields,
                                          rows)
    got = phase1_static_ref(tspec.cblobs, prow_f32, prow_i32,
                            _port_caps(caps), wk, enabled[:5], act)
    assert set(act) == {"nodeaffinity", "taints", "ports", "images"}
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_fit_golden_cases_match_jax():
    """tests/test_golden.py's FIT_CASES in one launch: one node per case
    carrying the case's existing usage, each case's pod pinned to it
    (spec.nodeName), so the auction's fit and end-state reject counts
    decide every case."""
    nodes, existing, pods = [], [], []
    for i, (_, req, init, used, _) in enumerate(FIT_CASES):
        name = f"node-{i}"
        nodes.append(_mknode(name, cpu="10m", mem="20Mi", pods="32",
                             ext={"example.com/aaa": "5",
                                  "ephemeral-storage": "20000Mi"}))
        if used:
            existing.append(_mkpod(f"used-{i}", req=used, node=name))
        pod = _mkpod(f"fit-{i}", req=req, init=init)
        pod.spec.node_name = name
        pods.append(pod)
    caps = Capacities(nodes=64, pods=256)
    mirror = _mirror(nodes, existing, caps)
    spec = mirror.prepare_launch(pods, 64)
    jout, tout = _both(mirror, spec, caps)
    _assert_same(jout, tout)
    fit_idx = JP.FILTER_PLUGINS.index("NodeResourcesFit")
    for i, (name, *_, want) in enumerate(FIT_CASES):
        placed = int(tout.node_row[i]) >= 0
        assert placed == (want is None), name
        if want is not None:
            assert int(tout.reject_counts[i, fit_idx]) > 0, name
