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
from tests.torch_port_support import fuzz_cluster, port_caps, port_spec

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


_port_spec = port_spec
_port_caps = port_caps


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


# ------------------------------------------------ the serial commit scan
#
# launch_batch(serial_scan=True) in both packages: phase 1, then (on a
# topology launch) the topology statics, then the as-if-serial scan. Node
# rows, counts, free/nzr and guard must be EXACT, and so must the winning
# scores — except where a soft (ScheduleAnyway) spread constraint enters
# the score: its weight log(domains + 2) comes from XLA's float32 log on
# the reference's side, which is not correctly rounded, and may be one ulp
# off the port's torch.log; those cases hold the scores to 1e-4.

SOFT_SPREAD_CASES = {"soft_spread_unlabeled_key"}


def _both_serial(mirror, spec, caps, seed=0):
    weights = convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})
    jout = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                           caps, tie_seed=np.uint32(seed))
    tout = TP.launch_batch(_port_spec(spec), mirror.well_known(), weights,
                           _port_caps(caps), tie_seed=seed, device="cpu")
    return jout, tout


def _assert_same_serial(jout, tout, exact_score=True):
    _assert_same(jout, tout)
    if exact_score:
        assert np.array_equal(tout.score.numpy(), np.asarray(jout.score))


def _hard_scenarios():
    from tests.test_torch_topology import SCENARIOS

    soft_only = {"existing_anti_blocks", "spread_soft",
                 "preferred_affinity", "preferred_anti_affinity"}
    return {k: v for k, v in SCENARIOS.items() if k not in soft_only}


@pytest.mark.parametrize("case", sorted(_hard_scenarios()))
@pytest.mark.parametrize("seed", [0, 5])
def test_topology_scan_matches_jax(case, seed):
    """tests/test_topology.py's scenarios with hard constraints."""
    from tests import test_topology as TT

    nodes, bound, pods = _hard_scenarios()[case]()
    mirror = _mirror(nodes, bound, TT.CAPS)
    spec = mirror.prepare_launch(pods, 8)
    assert spec.enable_topology and not spec.topo_soft
    jout, tout = _both_serial(mirror, spec, TT.CAPS, seed)
    _assert_same_serial(jout, tout, case not in SOFT_SPREAD_CASES)


def test_topology_scan_sequential_launches_match_jax():
    """test_spread_hostname_sequential: one pod per launch, each bound
    into the table before the next launch."""
    from kubernetes_tpu.api.objects import LABEL_HOSTNAME
    from tests import test_topology as TT

    cl = TT.Cluster(TT.ZONES)
    seen = []
    for i in range(3):
        tsc = [TT.hard_spread(LABEL_HOSTNAME, app="s")]
        spec = cl.mirror.prepare_launch(
            [TT.mkpod(f"p{i}", {"app": "s"}, tsc=tsc)], 8)
        jout, tout = _both_serial(cl.mirror, spec, TT.CAPS)
        _assert_same_serial(jout, tout)
        row = int(tout.node_row[0])
        assert row >= 0
        name = cl.mirror.name_of_row(row)
        seen.append(name)
        cl.cache.add_pod(TT.mkpod(f"p{i}", {"app": "s"}, node=name, tsc=tsc))
        cl.cache.update_snapshot(cl.snap)
        cl.mirror.sync(cl.snap)
    assert sorted(seen) == ["n1", "n2", "n3"]


def _host_port_setup():
    """tests/test_pipeline.py::test_in_batch_host_port_conflict."""
    from kubernetes_tpu.api.objects import ContainerPort
    from kubernetes_tpu.models.testbed import build_cluster, make_pod

    caps = Capacities(nodes=16, pods=64)
    _, _, mirror = build_cluster(2, caps=caps)
    pods = []
    for i in range(3):
        p = make_pod(i)
        p.spec.containers[0].ports = [ContainerPort(host_port=8080)]
        pods.append(p)
    return mirror, pods, caps


def _serial_oracle_setup():
    """tests/test_pipeline.py::test_matches_serial_oracle."""
    from kubernetes_tpu.models.testbed import build_cluster, make_pod

    caps = Capacities(nodes=16, pods=64)
    _, _, mirror = build_cluster(5, caps=caps)
    return mirror, [make_pod(i, cpu="3", mem="1Gi") for i in range(10)], caps


@pytest.mark.parametrize("setup", [_host_port_setup, _serial_oracle_setup],
                         ids=["host_port_conflict", "serial_oracle"])
def test_no_topology_scan_matches_jax(setup):
    """The scan without topology work, through the Mirror's launch."""
    mirror, pods, caps = setup()
    spec = mirror.prepare_launch(pods, 16 if len(pods) > 8 else 8)
    assert not spec.enable_topology
    jout, tout = _both_serial(mirror, spec, caps)
    _assert_same_serial(jout, tout)
    if setup is _host_port_setup:
        rows = tout.node_row[:3].tolist()
        assert rows[0] >= 0 and rows[1] >= 0 and rows[0] != rows[1]
        assert rows[2] == -1
        ports_idx = JP.FILTER_PLUGINS.index("NodePorts")
        assert int(tout.reject_counts[2, ports_idx]) == 2


@pytest.mark.parametrize("setup", [_host_port_setup, _serial_oracle_setup],
                         ids=["host_port_conflict", "serial_oracle"])
def test_direct_schedule_batch_matches_jax(setup):
    """tests/test_pipeline.py's own call: schedule_batch on the full pod
    blob with its defaults — a topology launch (every pod its own group,
    the full domain space) that carries no terms."""
    mirror, pods, caps = setup()
    batch = 16 if len(pods) > 8 else 8
    pblobs = mirror.pack_batch_blobs(pods, batch)
    jout = JP.schedule_batch_jit(mirror.to_blobs(), pblobs,
                                 mirror.well_known(), JP.default_weights(),
                                 caps)
    cb = mirror.to_blobs()
    a = np.asarray
    tout = TP.schedule_batch(
        convert.cluster_blobs_from_numpy(a(cb.node_f32), a(cb.node_i32),
                                         a(cb.pods_i32), device="cpu"),
        convert.blobs_from_numpy(a(pblobs.f32), a(pblobs.i32), device="cpu"),
        mirror.well_known(), convert.weights_from_numpy(
            {k: np.asarray(v)
             for k, v in vars(JP.default_weights()).items()}),
        _port_caps(caps), enable_topology=True)
    _assert_same_serial(jout, tout)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_serial_oracle_replay_fuzz_matches_jax(seed):
    """tests/test_oracle.py::test_serial_oracle_replay's fuzz: 12 nodes,
    48 pods with required (anti)affinity and DoNotSchedule spread, one
    launch of 64."""
    rng = random.Random(seed)
    caps = Capacities(nodes=16, pods=128)
    nodes = [oracle_node(i, rng) for i in range(12)]
    pods = [oracle_pod(i, rng) for i in range(48)]
    mirror = _mirror(nodes, [], caps)
    spec = mirror.prepare_launch(pods, 64)
    assert spec.enable_topology and not spec.topo_soft
    jout, tout = _both_serial(mirror, spec, caps, seed)
    _assert_same_serial(jout, tout)
    assert int((tout.node_row >= 0).sum()) > 0


def test_pct_nodes_launch_raises():
    """The percentageOfNodesToScore window (a branch of the serial scan),
    which raised until K3's window was ported, now runs: on a topology
    launch it matches the JAX package's window exactly, the carried start
    row included (tests/test_torch_pct.py holds the rest)."""
    from tests import test_topology as TT
    from tests.test_torch_topology import SCENARIOS

    nodes, bound, pods = SCENARIOS["preferred_affinity"]()
    mirror = _mirror(nodes, bound, TT.CAPS)
    spec = mirror.prepare_launch(pods, 8)
    weights = convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})
    jout = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                           TT.CAPS, serial_scan=True, pct_nodes=50,
                           tie_seed=np.uint32(0))
    tout = TP.launch_batch(_port_spec(spec), mirror.well_known(), weights,
                           _port_caps(TT.CAPS), pct_nodes=50, tie_seed=0,
                           device="cpu")
    _assert_same(jout, tout)
    assert int(tout.pct_start[0]) == int(jout.pct_start)


# the scan's variants: the fit scoring strategies and filters switched off
# by the profile (NodeResourcesFit off takes the scan even without
# topology; PodTopologySpread / InterPodAffinity off keep their scores)
_RTCR = (np.asarray([0.0, 0.5, 1.0], np.float32),
         np.asarray([0.0, 80.0, 30.0], np.float32))
_FILTERS_OFF = {
    "no_fit": "NodeResourcesFit",
    "no_spread_filter": "PodTopologySpread",
    "no_ipa_filter": "InterPodAffinity",
}


@pytest.mark.parametrize("variant", ["MostAllocated",
                                     "RequestedToCapacityRatio",
                                     *sorted(_FILTERS_OFF)])
def test_scan_variants_match_jax(variant):
    rng = random.Random(7)
    caps = Capacities(nodes=16, pods=128)
    nodes = [oracle_node(i, rng) for i in range(12)]
    pods = [oracle_pod(i, rng) for i in range(48)]
    mirror = _mirror(nodes, [], caps)
    spec = mirror.prepare_launch(pods, 64)
    filters = [True] * len(JP.FILTER_PLUGINS)
    strategy, jshape, tshape = "LeastAllocated", None, None
    if variant in _FILTERS_OFF:
        filters[JP.FILTER_PLUGINS.index(_FILTERS_OFF[variant])] = False
    else:
        strategy = variant
        if variant == "RequestedToCapacityRatio":
            jshape = tuple(jnp.asarray(s) for s in _RTCR)
            tshape = _RTCR
    weights = convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})
    jout = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                           caps, tuple(filters), fit_strategy=strategy,
                           fit_shape=jshape)
    tout = TP.launch_batch(_port_spec(spec), mirror.well_known(), weights,
                           _port_caps(caps), tuple(filters),
                           fit_strategy=strategy, fit_shape=tshape,
                           device="cpu")
    # RequestedToCapacityRatio: XLA on the CPU fuses jnp.interp's
    # multiply-add (see the module docstring), so its scores are held to
    # 1e-4; every other variant is exact
    _assert_same_serial(jout, tout,
                        exact_score=variant != "RequestedToCapacityRatio")
