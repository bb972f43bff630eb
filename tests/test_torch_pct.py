"""The percentageOfNodesToScore window of the port's serial scan (kernel
K3's twin, kernels/scan.py:pct_window) against the JAX package's
(models/pipeline.py ``body``, :1418-1450), on the CPU.

The cases of tests/test_pipeline.py:113-190 (the knob, the adaptive
formula, the rotating start, the carry across launches) run through both
packages' launch_batch on the same packed launch, plus a cluster with
fewer feasible nodes than k_find, a start row on a padding row, a
cluster with holes (deleted nodes), a topology launch, and a Scheduler
drain with ``percentage_of_nodes_to_score=0`` (adaptive) through both
Schedulers. Rows, feasible counts, reject counts, free/nzr and the
carried start row must be exact; scores within 1e-4 (as in
tests/test_torch_pipeline.py)."""

import numpy as np
import pytest

from kubernetes_tpu.backend.cache import Cache
from kubernetes_tpu.backend.mirror import Mirror
from kubernetes_tpu.backend.snapshot import Snapshot
from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu.models.testbed import make_node, make_pod
from kubernetes_tpu.ops.features import Capacities
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.kernels import scan as KS
from kubernetes_tpu_torch.models import pipeline as TP
from tests.torch_port_support import port_caps, port_spec

pytestmark = pytest.mark.torch_port

EXACT = ("node_row", "feasible_count", "reject_counts", "unresolvable_count",
         "free", "nzr", "guard")
CAPS = Capacities(nodes=256, pods=64)


def _weights():
    return convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})


def _mirror(n_nodes, caps=CAPS, removed=(), bound=()):
    cache = Cache()
    nodes = [make_node(i) for i in range(n_nodes)]
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    mirror = Mirror(caps=caps)
    mirror.sync(snap)
    for i in removed:
        cache.remove_node(nodes[i])
    if removed:
        cache.update_snapshot(snap)
        mirror.sync(snap)
    return mirror


def _both(mirror, pods, pct, start=None, tstart=None, caps=CAPS, batch=8):
    spec = mirror.prepare_launch(pods, batch)
    jout = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                           caps, serial_scan=True, pct_nodes=pct,
                           pct_start=start, tie_seed=np.uint32(3))
    tout = TP.launch_batch(port_spec(spec), mirror.well_known(), _weights(),
                           port_caps(caps), serial_scan=True, pct_nodes=pct,
                           pct_start=tstart, tie_seed=3, device="cpu")
    for f in EXACT:
        want, got = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        assert np.array_equal(want, got), (f, np.argwhere(want != got)[:5])
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score),
                               rtol=0, atol=1e-4)
    assert int(tout.pct_start[0]) == int(jout.pct_start)
    return jout, tout


def test_pct_knob_adaptive_and_full_match_the_reference():
    """test_pct_nodes_to_score_knob: pct 50, adaptive, 100 and off over 200
    identical nodes (k_find = 100)."""
    mirror = _mirror(200)
    pods = [make_pod(i) for i in range(8)]
    _, capped = _both(mirror, pods, 50)
    assert (capped.feasible_count.numpy()[:8] == 100).all()
    _, adaptive = _both(mirror, pods, JP.ADAPTIVE_PCT)
    assert (adaptive.feasible_count.numpy()[:8] == 100).all()
    _, full = _both(mirror, pods, 0)
    assert (full.feasible_count.numpy()[:8] == 200).all()
    _, same = _both(mirror, pods, 100)
    assert np.array_equal(same.node_row.numpy(), full.node_row.numpy())
    assert TP.ADAPTIVE_PCT == JP.ADAPTIVE_PCT
    assert TP.MIN_FEASIBLE_NODES_TO_FIND == JP.MIN_FEASIBLE_NODES_TO_FIND


def test_pct_rotating_start_matches_the_reference():
    """test_pct_nodes_rotates_start_index: windows alternate over the 200
    real nodes and the start wraps back to 0."""
    _, tout = _both(_mirror(200), [make_pod(i) for i in range(8)], 50)
    rows = tout.node_row.numpy()
    assert all(r < 100 for r in rows[0:8:2])
    assert all(r >= 100 for r in rows[1:8:2])
    assert int(tout.pct_start[0]) == 0


def test_pct_start_carries_across_chained_launches():
    """test_pct_nodes_start_carries_across_launches, over three chained
    launches: each seeded with the previous one's start (and usage
    state)."""
    mirror = _mirror(150)
    caps = CAPS
    j_start = t_start = None
    state = tstate = None
    starts = []
    for k in range(3):
        pods = [make_pod(100 * k + i) for i in range(8)]
        spec = mirror.prepare_launch(pods, 8)
        jout = JP.launch_batch(spec, mirror.well_known(),
                               JP.default_weights(), caps, serial_scan=True,
                               pct_nodes=50, pct_start=j_start, state=state,
                               tie_seed=np.uint32(1))
        tout = TP.launch_batch(port_spec(spec), mirror.well_known(),
                               _weights(), port_caps(caps), serial_scan=True,
                               pct_nodes=50, pct_start=t_start, state=tstate,
                               tie_seed=1, device="cpu")
        for f in EXACT:
            assert np.array_equal(np.asarray(getattr(jout, f)),
                                  getattr(tout, f).numpy()), (k, f)
        assert int(tout.pct_start[0]) == int(jout.pct_start)
        starts.append(int(jout.pct_start))
        j_start, t_start = jout.pct_start, tout.pct_start
        state, tstate = (jout.free, jout.nzr), (tout.free, tout.nzr)
    assert len(set(starts)) > 1


def test_pct_fewer_feasible_than_k_find():
    """Big pods fit on few nodes: fewer feasible nodes than k_find, so
    the window keeps them all and the start stays (then snaps)."""
    mirror = _mirror(200)
    pods = [make_pod(i, cpu="30") for i in range(8)]
    _, tout = _both(mirror, pods, 10, start=np.int32(37),
                    tstart=np.int32(37))
    assert (tout.node_row.numpy()[:8] >= 0).all()


def test_pct_start_on_a_padding_row_and_over_holes():
    """A start past the valid rows (a padding row of the bucket) snaps to
    the next valid row in rotated order; deleted nodes leave invalid rows
    in the middle that the snap skips."""
    mirror = _mirror(200)
    pods = [make_pod(i) for i in range(8)]
    _both(mirror, pods, 50, start=np.int32(230), tstart=np.int32(230))
    holes = _mirror(220, removed=range(90, 130))
    _both(holes, pods, 50, start=np.int32(95), tstart=np.int32(95))
    _both(holes, pods, JP.ADAPTIVE_PCT, start=np.int32(300),
          tstart=np.int32(300))


def test_pct_window_helper_matches_a_loop():
    """kernels/scan.py:pct_window against a plain loop over the rotation."""
    rng = np.random.default_rng(0)
    import torch

    for _ in range(50):
        n = int(rng.integers(1, 40))
        valid = rng.random(n) < 0.8
        feas = valid & (rng.random(n) < 0.6)
        start, k = int(rng.integers(0, n)), int(rng.integers(1, 10))
        out, nxt = KS.pct_window(torch.from_numpy(feas),
                                 torch.from_numpy(valid), start, k)
        keep = np.zeros(n, bool)
        seen = 0
        processed = n
        for i in range(n):
            r = (start + i) % n
            if feas[r]:
                seen += 1
                if seen <= k:
                    keep[r] = True
                if seen == k:
                    processed = i + 1
        s = (start + processed) % n
        for i in range(n):
            if valid[(s + i) % n]:
                s = (s + i) % n
                break
        assert np.array_equal(out.numpy(), keep) and nxt == s


def test_pct_on_a_topology_launch():
    """The window on a hard-topology launch (the serial scan with carry
    maps): spread pods over 200 zoned nodes."""
    from kubernetes_tpu.api.objects import LabelSelector, TopologySpreadConstraint

    mirror = _mirror(200)
    pods = []
    for i in range(8):
        p = make_pod(i)
        p.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=1, topology_key="topology.kubernetes.io/zone",
            when_unsatisfiable="DoNotSchedule",
            label_selector=LabelSelector(match_labels={"app": "app-1"}))]
        p.metadata.labels["app"] = "app-1"
        pods.append(p)
    _both(mirror, pods, 50)


def test_scheduler_drain_with_adaptive_pct_binds_as_the_reference():
    """percentage_of_nodes_to_score=0 (the reference's adaptive percent)
    through both Schedulers: the same bindings, batch after batch (the
    start row rotates across launches)."""
    from kubernetes_tpu.config.types import default_config as j_config
    from kubernetes_tpu.hub import Hub as JHub
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.config.types import default_config as t_config
    from kubernetes_tpu_torch.hub import Hub as THub
    from kubernetes_tpu_torch.ops.features import Capacities as TCaps
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
    from tests.torch_port_support import to_port

    out = []
    for port in (False, True):
        conv = to_port if port else (lambda o: o)
        hub = THub() if port else JHub()
        cfg = t_config() if port else j_config()
        cfg.batch_size = 16
        cfg.percentage_of_nodes_to_score = 0
        cfg.tie_break_seed = 7
        sched = (TScheduler(hub, cfg, caps=TCaps(nodes=256, pods=128),
                            device="cpu") if port
                 else JScheduler(hub, cfg, caps=Capacities(nodes=256,
                                                           pods=128)))
        try:
            for i in range(180):
                hub.create_node(conv(make_node(i)))
            for i in range(48):
                hub.create_pod(conv(make_pod(i)))
            sched.run_until_idle()
            out.append({p.metadata.name: p.spec.node_name
                        for p in hub.list_pods()})
            start = sched._pct_start
            out.append(int(np.asarray(start).reshape(-1)[0])
                       if not port else int(start[0]))
        finally:
            sched.close()
    assert out[0] == out[2] and all(out[0].values())
    assert out[1] == out[3]
