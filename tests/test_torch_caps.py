"""The port at the shapes its kernels used to refuse, against the JAX
package on the CPU (the port runs its kernels' twins here; chip_smoke.py
launches K2a, K3 and K5 at the same shapes on the card against those
twins).

The reference grows every capacity on demand and accepts any strictly
increasing RequestedToCapacityRatio shape of up to 101 points; the port's
K2a and K3 refused more than 32 resource columns and 16 shape points, K3
and K5 more than 16 spread constraints and K3 more than 32 topology
keys. Each case here runs one of those shapes through both packages'
launch_batch on the same packed launch: R = 74 (70 extended resource
columns), a 101-point shape, C = 17 spread constraints over TK = 33
topology keys. Placements, feasible and reject counts, free and nzr are
exact; scores within 1e-4; with the export tails on, as
tests/test_torch_export.py holds them.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu.ops.features import Capacities
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.models import pipeline as TP
from tests.test_torch_export import both
from tests.test_torch_learned_launch import _scorer
from tests.test_torch_pipeline import _mirror
from tests.torch_port_support import port_caps, port_spec

pytestmark = pytest.mark.torch_port

EXACT = ("node_row", "feasible_count", "reject_counts", "unresolvable_count",
         "free", "nzr", "guard")
TOL = 1e-4
EXT = 70          # 4 native + 70 extended columns: R = 74
KEYS = 30         # custom topology keys; with the Mirror's hostname,
                  # zone and region keys TK = 33
C_MAX = 17        # spread constraints a pod


def _objects(n_nodes, n_pods, seed, **kw):
    """perf/fuzz.py caps_fuzz built from the JAX package's classes (the
    cluster chip_smoke.py builds from the port's on the card)."""
    import kubernetes_tpu.api.objects as JO
    from kubernetes_tpu_torch.perf.fuzz import caps_fuzz

    return caps_fuzz(random.Random(seed), n_nodes, n_pods, objects=JO, **kw)


def _exact(mirror, spec, caps, serial, **kw):
    w = JP.default_weights()
    tw = convert.weights_from_numpy({k: np.asarray(v)
                                     for k, v in vars(w).items()})
    jkw, tkw = dict(kw), dict(kw)
    if "fit_shape" in kw:
        jkw["fit_shape"] = tuple(jnp.asarray(x) for x in kw["fit_shape"])
    jout = JP.launch_batch(spec, mirror.well_known(), w, caps,
                           serial_scan=serial, tie_seed=np.uint32(2), **jkw)
    tout = TP.launch_batch(port_spec(spec), mirror.well_known(), tw,
                           port_caps(caps), serial_scan=serial, tie_seed=2,
                           device="cpu", **tkw)
    for f in EXACT:
        assert np.array_equal(np.asarray(getattr(jout, f)),
                              getattr(tout, f).numpy()), f
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score),
                               rtol=0, atol=TOL)
    return jout, tout


def _ext_launch():
    caps = Capacities(nodes=16, pods=64, ext_resources=EXT)
    nodes, pods = _objects(12, 24, 3, ext=66)
    mirror = _mirror(nodes, [], caps)
    spec = mirror.prepare_launch(pods, 32)
    assert port_caps(caps).res_cols == 74
    return mirror, spec, caps


@pytest.mark.parametrize("serial", [False, True], ids=["auction", "scan"])
def test_r74_matches_jax(serial):
    mirror, spec, caps = _ext_launch()
    _, tout = _exact(mirror, spec, caps, serial)
    assert tout.free.shape[1] == 74
    assert int((tout.node_row >= 0).sum()) > 0
    both(mirror, spec, caps, _scorer((8,), 1), serial=serial, seed=2)


SHAPE_101 = (np.linspace(0.0, 1.0, 101).astype(np.float32),
             (50.0 + 50.0 * np.sin(np.linspace(0.0, 6.0, 101)))
             .astype(np.float32))


@pytest.mark.parametrize("serial", [False, True], ids=["auction", "scan"])
def test_101_shape_points_match_jax(serial):
    assert SHAPE_101[0].shape == (101,)
    assert np.all(np.diff(SHAPE_101[0]) > 0)
    mirror, spec, caps = _ext_launch()
    _, tout = _exact(mirror, spec, caps, serial,
                     fit_strategy="RequestedToCapacityRatio",
                     fit_shape=SHAPE_101)
    assert int((tout.node_row >= 0).sum()) > 0


def _spread_launch():
    """Pods with 17 DoNotSchedule spread constraints on keys 0-16 and pods
    with 13 ScheduleAnyway ones on keys 17-29: C = 17, and TK = 33 with
    the hostname, zone and region keys the Mirror registers."""
    caps = Capacities(nodes=32, pods=64, spread_constraints=C_MAX,
                      topo_cols=KEYS + 3, label_cols=64)
    nodes, pods = _objects(20, 16, 5, keys=KEYS, c_hard=C_MAX)
    mirror = _mirror(nodes, [], caps)
    spec = mirror.prepare_launch(pods, 16)
    assert spec.enable_topology and not spec.topo_soft
    return mirror, spec, caps


def test_c17_tk33_scan_matches_jax():
    mirror, spec, caps = _spread_launch()
    assert port_caps(caps).topo_cols == 33
    jout, tout = _exact(mirror, spec, caps, True)
    assert int((tout.node_row >= 0).sum()) > 0
    # the spread filter rejected some nodes: the 17 constraints bite
    sp = JP.FILTER_PLUGINS.index("PodTopologySpread")
    assert int(np.asarray(jout.reject_counts)[:, sp].sum()) > 0
    both(mirror, spec, caps, _scorer((8,), 4), serial=True, seed=2)
