"""launch_batch with the learned score term (``learned=``), the port
against the JAX package on the CPU, where the port runs its kernels'
twins (K2a's and K3's, with ops/learned.py for K9).

The same packed launch and the same scorer (the JAX package's params as
numpy, packed by convert.learned_params) go through both packages on each
commit engine: the plain auction (``serial_scan=False``), the soft-score
auction (a soft-only topology launch), the hard-topology serial scan and
the scan with the percentageOfNodesToScore window. Placements, feasible
and reject counts, free, nzr and guard must be exact; the winning scores
within 1e-4 (XLA's dot on the CPU may reorder the MLP's sums; the totals
are at most 100 times the sum of the weights). A tie that difference
could flip would show as a different placement, which the exact rows
check. Weight 0 equals the hand baseline exactly, and the identity
scorer at weight 1 keeps the baseline's placements
(tests/test_learned.py:317-343), in both packages.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_tpu.learn.train import identity_params as j_identity
from kubernetes_tpu.learn.train import init_params as j_init
from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.learn.checkpoint import CheckpointError
from kubernetes_tpu_torch.models import pipeline as TP
from tests import test_torch_pipeline as TPL
from tests import test_torch_soft as TSO
from tests.test_learned import _mirror_for, mknode, mkpod
from tests.test_torch_pct import _mirror as pct_mirror
from tests.torch_port_support import port_caps, port_spec

pytestmark = pytest.mark.torch_port

EXACT = ("node_row", "feasible_count", "reject_counts", "unresolvable_count",
         "free", "nzr", "guard")
TOL = 1e-4


def _scorer(hidden, seed):
    """The JAX package's init_params as numpy, with non-zero hidden biases
    and a head scaled by 20 around a bias of 50, so the term varies over
    the nodes inside its [0, 100] clip instead of clipping to 0."""
    rng = np.random.default_rng(seed + 7)
    out = [[np.asarray(w), rng.normal(0, 0.5, np.asarray(b).shape)
            .astype(np.float32)]
           for w, b in j_init(seed=seed, hidden=hidden)]
    out[-1][0] = out[-1][0] * np.float32(20.0)
    out[-1][1] = np.full((1,), 50.0, np.float32)
    return tuple(tuple(p) for p in out)


def _weights(w_learned):
    jw = dataclasses.replace(JP.default_weights(),
                             learned=np.float32(w_learned))
    tw = convert.weights_from_numpy({k: np.asarray(v)
                                     for k, v in vars(jw).items()})
    return jw, tw


def _both(mirror, spec, caps, params, w_learned=1.0, serial=False, seed=0,
          **kw):
    """Both packages' launch of one spec with one scorer; every exact field
    equal, scores within TOL. Returns (jax out, port out)."""
    jw, tw = _weights(w_learned)
    jp = (None if params is None else
          tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params))
    tp = None if params is None else convert.learned_params(params, "cpu")
    jout = JP.launch_batch(spec, mirror.well_known(), jw, caps,
                           serial_scan=serial, learned=jp,
                           tie_seed=np.uint32(seed), **kw)
    tkw = dict(kw)
    if "filters" in tkw:
        tkw["enabled_filters"] = tkw.pop("filters")
    tout = TP.launch_batch(port_spec(spec), mirror.well_known(), tw,
                           port_caps(caps), serial_scan=serial, learned=tp,
                           tie_seed=seed, device="cpu", **tkw)
    for f in EXACT:
        want, got = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        assert np.array_equal(want, got), (
            f"{f}: port differs from JAX at "
            f"{np.argwhere(want != got)[:5].tolist()}")
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score),
                               rtol=0, atol=TOL)
    return jout, tout


def _hand(mirror, spec, caps, serial=False, seed=0, **kw):
    """The port's hand-tuned launch of the same spec (no learned term)."""
    _, tw = _weights(0.0)
    return TP.launch_batch(port_spec(spec), mirror.well_known(), tw,
                           port_caps(caps), serial_scan=serial,
                           tie_seed=seed, device="cpu", **kw)


SCORERS = {"h8": (8,), "h16_8": (16, 8)}
AUCTION_CASES = ("auction_balance", "auction_tolerations_affinity",
                 "rich_fuzz", "k_accept")


@pytest.mark.parametrize("scorer", sorted(SCORERS))
@pytest.mark.parametrize("case", AUCTION_CASES)
def test_plain_auction_with_learned_matches_jax(case, scorer):
    mirror, spec, caps = TPL.CASES[case]()
    params = _scorer(SCORERS[scorer], 1)
    _, tout = _both(mirror, spec, caps, params, w_learned=2.0, seed=3)
    assert int((tout.node_row >= 0).sum()) > 0
    # the term moves the totals: the hand launch's winning scores differ
    hand = _hand(mirror, spec, caps, seed=3)
    placed = tout.node_row >= 0
    assert not np.array_equal(hand.score.numpy()[placed.numpy()],
                              tout.score.numpy()[placed.numpy()])


@pytest.mark.parametrize("seed", [0, 4])
def test_soft_auction_with_learned_matches_jax(seed):
    """K2a's soft mode: the learned features carry the normalized soft
    spread and ipa scores."""
    mirror, spec, caps = TSO.fuzz_launch(seed, n_pods=8)
    _both(mirror, spec, caps, _scorer((8,), seed), serial=False, seed=seed)
    _both(mirror, spec, caps, _scorer((16, 8), seed), serial=True, seed=seed)


@pytest.mark.parametrize("case", ["in_batch_anti", "spread_hostname",
                                  "required_affinity", "soft_spread_"
                                  "unlabeled_key"])
def test_hard_topology_scan_with_learned_matches_jax(case):
    from tests import test_topology as TT

    nodes, bound, pods = TPL._hard_scenarios()[case]()
    mirror = TPL._mirror(nodes, bound, TT.CAPS)
    spec = mirror.prepare_launch(pods, 8)
    assert spec.enable_topology and not spec.topo_soft
    _both(mirror, spec, TT.CAPS, _scorer((8,), 2), serial=True, seed=5)


@pytest.mark.parametrize("seed", [0, 2])
def test_oracle_fuzz_scan_with_learned_matches_jax(seed):
    """tests/test_oracle.py's serial fuzz (required (anti)affinity and
    DoNotSchedule spread, 48 pods over 12 nodes) and the no-topology scan
    of the rich fuzz."""
    rng = random.Random(seed)
    caps = TPL.Capacities(nodes=16, pods=128)
    nodes = [TPL.oracle_node(i, rng) for i in range(12)]
    pods = [TPL.oracle_pod(i, rng) for i in range(48)]
    mirror = TPL._mirror(nodes, [], caps)
    spec = mirror.prepare_launch(pods, 64)
    _, tout = _both(mirror, spec, caps, _scorer((8,), seed), serial=True,
                    seed=seed)
    assert int((tout.node_row >= 0).sum()) > 0
    mirror, spec, caps = TPL.CASES["rich_fuzz"]()
    _both(mirror, spec, caps, _scorer((8,), seed), serial=True, seed=seed)


@pytest.mark.parametrize("pct", [50, JP.ADAPTIVE_PCT])
def test_pct_window_scan_with_learned_matches_jax(pct):
    """The window's normalizers feed the learned features: rows, counts
    and the carried start exact over two chained launches."""
    from kubernetes_tpu.models.testbed import make_pod

    mirror = pct_mirror(200)
    caps = TPL.Capacities(nodes=256, pods=64)
    params = _scorer((8,), 3)
    jstart = tstart = None
    for k in range(2):
        spec = mirror.prepare_launch([make_pod(10 * k + i)
                                      for i in range(8)], 8)
        jout, tout = _chained(mirror, spec, caps, params, pct, jstart,
                              tstart)
        assert int(tout.pct_start[0]) == int(jout.pct_start)
        jstart, tstart = jout.pct_start, tout.pct_start
    assert (tout.feasible_count.numpy()[:8] == 100).all()


def _chained(mirror, spec, caps, params, pct, jstart, tstart):
    jw, tw = _weights(1.0)
    jout = JP.launch_batch(spec, mirror.well_known(), jw, caps,
                           serial_scan=True, pct_nodes=pct,
                           pct_start=jstart, tie_seed=np.uint32(1),
                           learned=tuple((jnp.asarray(w), jnp.asarray(b))
                                         for w, b in params))
    tout = TP.launch_batch(port_spec(spec), mirror.well_known(), tw,
                           port_caps(caps), serial_scan=True, pct_nodes=pct,
                           pct_start=tstart, tie_seed=1, device="cpu",
                           learned=convert.learned_params(params, "cpu"))
    for f in EXACT:
        assert np.array_equal(np.asarray(getattr(jout, f)),
                              getattr(tout, f).numpy()), f
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score),
                               rtol=0, atol=TOL)
    return jout, tout


@pytest.mark.parametrize("serial", [False, True], ids=["auction", "scan"])
def test_zero_weight_learned_matches_baseline_exactly(serial):
    """weights.learned == 0: the term adds exactly 0.0, so the launch is
    the hand-tuned one, scores and all, in both packages."""
    nodes = [mknode(i, cpu=str(2 + i)) for i in range(5)]
    pods = [mkpod(f"p{i}", cpu=f"{200 + 100 * i}m") for i in range(6)]
    mirror = _mirror_for(nodes)
    spec = mirror.prepare_launch(pods, 8)
    from tests.test_learned import CAPS

    base = _hand(mirror, spec, CAPS, serial=serial)
    jbase = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                            CAPS, serial_scan=serial)
    jout, tout = _both(mirror, spec, CAPS, _scorer((8,), 9), w_learned=0.0,
                       serial=serial)
    for f in EXACT + ("score",):
        assert np.array_equal(getattr(base, f).numpy(),
                              getattr(tout, f).numpy()), f
    assert np.array_equal(np.asarray(jbase.node_row),
                          np.asarray(jout.node_row))


@pytest.mark.parametrize("serial", [False, True], ids=["auction", "scan"])
def test_identity_learned_keeps_baseline_placements(serial):
    """The identity scorer at weight 1 only rescales the aggregate on a
    topology-free batch: the baseline's placements, in both packages."""
    nodes = [mknode(i, cpu=str(2 + i)) for i in range(5)]
    pods = [mkpod(f"p{i}", cpu=f"{200 + 100 * i}m") for i in range(6)]
    mirror = _mirror_for(nodes)
    spec = mirror.prepare_launch(pods, 8)
    from tests.test_learned import CAPS

    params = tuple((np.asarray(w), np.asarray(b)) for w, b in j_identity())
    base = _hand(mirror, spec, CAPS, serial=serial)
    jout, tout = _both(mirror, spec, CAPS, params, w_learned=1.0,
                       serial=serial)
    assert np.array_equal(base.node_row.numpy(), tout.node_row.numpy())
    assert np.array_equal(np.asarray(jout.node_row)[:6],
                          base.node_row.numpy()[:6])


def test_nan_params_trip_the_guard_in_both():
    """A NaN scorer makes every total NaN: the guard's score bit is set
    in both packages (the Scheduler raises DeviceFault on it)."""
    nodes = [mknode(i) for i in range(4)]
    pods = [mkpod(f"p{i}") for i in range(3)]
    mirror = _mirror_for(nodes)
    spec = mirror.prepare_launch(pods, 4)
    from tests.test_learned import CAPS

    w = np.full((9, 1), np.nan, np.float32)
    params = ((w, np.zeros((1,), np.float32)),)
    for serial in (False, True):
        jout, tout = _both(mirror, spec, CAPS, params, serial=serial)
        assert int(tout.guard) & 1 and int(jout.guard) & 1


def test_launch_moves_params_and_refuses_the_export_tails():
    """launch_batch takes a LearnedParams as it was packed (a copy of the
    buffer gives the same launch); a malformed stack never packs, a wide
    one does; the feature / alternative export tails, once refused, now
    run (tests/test_torch_export.py holds them to the JAX package) and
    give the reference's shapes."""
    mirror, spec, caps = TPL.CASES["auction_balance"]()
    params = convert.learned_params(_scorer((8,), 0), "cpu")
    _, tw = _weights(1.0)
    args = (port_spec(spec), mirror.well_known(), tw, port_caps(caps))
    a = TP.launch_batch(*args, serial_scan=False, device="cpu",
                        learned=params)
    b = TP.launch_batch(*args, serial_scan=False, device="cpu",
                        learned=KL.LearnedParams(buf=params.buf.clone(),
                                                 dims=params.dims))
    assert np.array_equal(a.node_row.numpy(), b.node_row.numpy())
    assert np.array_equal(a.score.numpy(), b.score.numpy())
    (w0, b0), last = _scorer((65,), 0)
    with pytest.raises(CheckpointError):
        convert.learned_params(((w0, b0[:64]), last), "cpu")
    assert convert.learned_params(_scorer((65,), 0), "cpu").dims == (
        9, 65, 1)
    out = TP.launch_batch(*args, device="cpu", with_feats=True,
                          learned=params)
    assert out.chosen_feat.shape == (out.node_row.shape[0], 9)
    assert out.alt_row.shape == (out.node_row.shape[0], TP.ALT_K)
    assert float(out.learned_mag) > 0
