"""The soft-score auction of the port (soft-only topology launches:
preferred pod (anti)affinity, ScheduleAnyway spread) against the JAX
package, on the CPU, where the port runs its kernels' plain twins.

Each case packs one cluster and batch with the JAX Mirror and hands the
same arrays to the port. Held here:

- the soft statics view (kernels/soft.py:soft_topo over K5's twin) against
  the reference's ``_soft_statics``, field by field;
- K4's twin (``live_scores``) against ``_soft_scores`` on random placed
  sets;
- the whole soft-auction launch, ``launch_batch(serial_scan=False)``, in
  both packages;
- the port's serial scan (K3's topology branch) on soft-only launches
  against the reference's reduced soft scan (``topo_soft`` branch of
  ``body``), which the reference takes on the CPU.

Placements, feasible and reject counts, free and nzr must be EXACT, and
so must every bool of the statics, the counts and the InterPodAffinity
scores (integer sums). ``tpw`` = log(domains + 2) may be one ulp off: the
port reads a float32 table built with torch.log, XLA's float32 log on the
CPU is not correctly rounded. So the raw spread score ``sp_r`` and the
winning scores, which carry ``tpw`` (and XLA's multiply-add fusion on the
CPU), are held to 1e-4; a tie that flipped under that difference would
show as a different placement, which the exact node rows check.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.objects import (
    LABEL_ZONE,
    LabelSelector,
    TopologySpreadConstraint,
)
from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu.ops import topology as JT
from kubernetes_tpu.ops.features import unpack_cluster as j_unpack_cluster
from kubernetes_tpu.ops.features import unpack_pods as j_unpack_pods
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.kernels import soft as KSoft
from kubernetes_tpu_torch.kernels import topology as KT
from kubernetes_tpu_torch.kernels.phase1 import phase1_static_ref
from kubernetes_tpu_torch.models import pipeline as TP
from kubernetes_tpu_torch.ops.features import PodBlobs
from kubernetes_tpu_torch.ops.features import unpack_cluster, unpack_pods
from tests import test_soft_auction as SA
from tests.test_torch_topology import SCENARIOS, _mirror
from tests.torch_port_support import port_caps, port_spec

pytestmark = pytest.mark.torch_port

SCORE_ATOL = 1e-4
IPA = JP.FILTER_PLUGINS.index("InterPodAffinity")
SOFT_SCENARIOS = ("existing_anti_blocks", "preferred_affinity",
                  "preferred_anti_affinity", "spread_soft")


def _filters(ipa_on=True):
    f = [True] * len(JP.FILTER_PLUGINS)
    f[IPA] = ipa_on
    return tuple(f)


def _weights():
    return convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})


def fuzz_launch(seed, n_pods=6, unlabeled=False):
    """tests/test_soft_auction.py's build / soft_pod fuzz: 12 nodes in 3
    zones, 8 bound soft pods, ``n_pods`` soft pods in a batch of 8. With
    ``unlabeled``, every fourth node carries no zone label, and the batch
    adds a ScheduleAnyway zone spread pod (nodes without the key)."""
    rng = random.Random(seed)
    table, snap, mirror = SA.build(rng)
    pods = [SA.soft_pod(f"p-{i}", rng) for i in range(n_pods)]
    if unlabeled:
        nodes = [SA.mknode(i) for i in range(12)]
        for i in range(3, 12, 4):
            del nodes[i].metadata.labels[LABEL_ZONE]
        mirror = _mirror(nodes, table, SA.CAPS)
        pods[0].spec.affinity = None
        pods[0].spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=1, topology_key=LABEL_ZONE,
            when_unsatisfiable="ScheduleAnyway",
            label_selector=LabelSelector(match_labels={"app": "a0"}))]
    for i, p in enumerate(pods):
        p.metadata.uid = f"p-{i}"
    spec = mirror.prepare_launch(pods, 8)
    assert spec.enable_topology and spec.topo_soft
    return mirror, spec, SA.CAPS


def scenario_launch(case):
    from tests import test_topology as TT

    nodes, bound, pods = SCENARIOS[case]()
    mirror = _mirror(nodes, bound, TT.CAPS)
    spec = mirror.prepare_launch(pods, 8)
    assert spec.enable_topology and spec.topo_soft
    return mirror, spec, TT.CAPS


# ------------------------------------------------------- the statics view

_FIELDS = ("ipa_ok_g", "ipa_raw_g", "match_static_g", "tpw_g", "used_soft_g",
           "dom_ok_g", "ign_g", "has_soft_g", "skew_g", "el_node_g",
           "paff_tk_g", "panti_tk_g", "tsc_tk_g", "paff_w_g", "panti_w_g",
           "M_paff_gg", "M_panti_gg", "M_tsc_gg", "topo_dom")


@functools.partial(jax.jit, static_argnames=(
    "caps", "pfields", "active", "d_cap", "g_cap", "ipa_on"))
def _jax_soft(cblobs, pblobs, ptmpl, gid, rep, wk, placed, caps, pfields,
              active, d_cap, g_cap, ipa_on):
    """The reference's _soft_statics fields and, for ``placed``, its
    _soft_scores (ipa_live, sp_r)."""
    ct = j_unpack_cluster(cblobs, caps)
    pods = j_unpack_pods(pblobs, caps, pfields, ptmpl)
    pods_rep = jax.tree.map(lambda x: x[rep], pods)
    soft = JP._soft_statics(
        ct, pods, pods_rep, gid, g_cap, d_cap, JT.slot_topo_dom(ct), wk,
        _filters(ipa_on), frozenset(active), ipa_on,
        lambda fn, tree, n: jax.vmap(fn)(tree))
    gid_oh = ((gid[:, None] == jnp.arange(g_cap)[None, :])
              .astype(jnp.float32) * pods.valid[:, None])
    ipa_live, sp_r = JP._soft_scores(soft, placed, gid_oh)
    out = {f: getattr(soft, f) for f in _FIELDS}
    out.update(ipa_live=ipa_live, sp_r=sp_r)
    return out


def jax_soft(spec, caps, wk, placed, ipa_on=True):
    out = _jax_soft(spec.cblobs, spec.pblobs, spec.ptmpl, spec.gid,
                    spec.rep, wk, jnp.asarray(placed, jnp.int32), caps=caps,
                    pfields=spec.pfields, active=tuple(spec.active),
                    d_cap=spec.d_cap, g_cap=spec.g_cap, ipa_on=ipa_on)
    return {k: np.asarray(v) for k, v in out.items()}


def port_soft(spec, caps, wk, ipa_on=True) -> KSoft.SoftTopo:
    """The port's soft statics: K1's and K5's twins over the group rows,
    viewed through soft_topo, as schedule_batch builds them."""
    tspec, tcaps = port_spec(spec), port_caps(caps)
    f32, i32 = TP.full_pod_rows(tspec.pblobs, tspec.ptmpl, tcaps,
                                tspec.pfields, tspec.rep.long())
    p1 = phase1_static_ref(tspec.cblobs, f32, i32, tcaps, wk, (True,) * 5,
                           frozenset(tspec.active))
    st = KT.topo_statics_ref(tspec.cblobs, f32, i32, p1.static_ok,
                             p1.taint_ok, p1.nodeaff_ok, tcaps, tspec.d_cap)
    pods_rep = unpack_pods(PodBlobs(f32=f32, i32=i32), tcaps)
    pods = unpack_pods(tspec.pblobs, tcaps, tspec.pfields, tspec.ptmpl)
    ct = unpack_cluster(tspec.cblobs, tcaps)
    return KSoft.soft_topo(st, pods_rep, tspec.gid, pods.valid, ct.topo_dom,
                           tspec.d_cap, ipa_on)


def random_placed(rng, spec, mirror, frac=0.7):
    """A random placed set: each batch row (padding rows too, which the
    scores must ignore) on a random real node or unplaced."""
    rows = [mirror.row_of(n) for n in mirror._row_of]
    b = np.asarray(spec.gid).shape[0]
    return np.asarray([rng.choice(rows) if rng.random() < frac else -1
                       for _ in range(b)], np.int32)


def assert_view_matches(want, soft):
    for f in _FIELDS:
        got = getattr(soft, f).numpy()
        w = want[f]
        assert got.shape == w.shape, (f, got.shape, w.shape)
        if f == "tpw_g":
            np.testing.assert_array_max_ulp(got, w, maxulp=1)
            continue
        # el_node_g: K5 writes pol & all_s & used_soft, the reference also
        # ANDs dom_ok; all_s already requires every used soft constraint's
        # key, so on a soft-only launch the two are the same map
        assert np.array_equal(got, w.astype(got.dtype)), (
            f"{f}: port differs at {np.argwhere(got != w)[:5].tolist()}")


@pytest.mark.parametrize("case", [f"fuzz{s}" for s in range(4)]
                         + ["unlabeled", "ipa_off"]
                         + list(SOFT_SCENARIOS))
def test_soft_view_and_scores_match_jax(case):
    """soft_topo against _soft_statics, and live_scores against
    _soft_scores on three random placed sets (the empty one first)."""
    ipa_on = case != "ipa_off"
    if case in SOFT_SCENARIOS:
        mirror, spec, caps = scenario_launch(case)
        seed = 0
    else:
        seed = int(case[4:]) if case.startswith("fuzz") else 7
        mirror, spec, caps = fuzz_launch(seed, unlabeled=case == "unlabeled")
    wk = mirror.well_known()
    soft = port_soft(spec, caps, wk, ipa_on)
    rng = random.Random(seed)
    b = np.asarray(spec.gid).shape[0]
    placed_sets = [np.full((b,), -1, np.int32)] + [
        random_placed(rng, spec, mirror) for _ in range(2)]
    for placed in placed_sets:
        want = jax_soft(spec, caps, wk, placed, ipa_on)
        assert_view_matches(want, soft)
        ipa_live, sp_r = KSoft.live_scores(soft, torch.from_numpy(placed))
        assert np.array_equal(ipa_live.numpy(), want["ipa_live"]), case
        np.testing.assert_allclose(sp_r.numpy(), want["sp_r"], rtol=0,
                                   atol=SCORE_ATOL)
    if case == "ipa_off":
        assert soft.ipa_ok_g.all()
    if case == "unlabeled":
        # the case reaches nodes without the spread key
        assert not soft.dom_ok_g[soft.used_soft_g[:, None, :].expand_as(
            soft.dom_ok_g)].all()
    if case == "existing_anti_blocks":
        assert not soft.ipa_ok_g[:, :3].all()


def test_soft_scores_wrapper_follows_the_round_flag():
    """soft_scores on CPU tensors is the twin, both stages (the domain maps
    it fills and the scores gathered from them); a round whose input flag
    is 0 leaves the outputs as they were."""
    mirror, spec, caps = fuzz_launch(1)
    soft = port_soft(spec, caps, mirror.well_known())
    out = KSoft.soft_out(soft)
    placed = torch.from_numpy(random_placed(random.Random(3), spec, mirror))
    prog = torch.tensor([1, 0], dtype=torch.int32)
    KSoft.soft_scores(soft, placed, prog, 0, out)
    maps, tmap = KSoft.soft_scatter_ref(soft, placed)
    ipa_live, sp_r = KSoft.live_scores(soft, placed)
    assert torch.equal(out.maps, maps) and torch.equal(out.tmap, tmap)
    assert maps.sum() > 0 and tmap.sum() > 0
    assert torch.equal(out.ipa_live, ipa_live)
    assert torch.equal(out.sp_r, sp_r)
    before = out.ipa_live.clone()
    KSoft.soft_scores(soft, torch.full_like(placed, -1), prog, 1, out)
    assert torch.equal(out.ipa_live, before)


# -------------------------------------------------- whole launches


EXACT = ("node_row", "feasible_count", "reject_counts", "unresolvable_count",
         "free", "nzr", "guard")


def _both(mirror, spec, caps, serial, seed=0, ipa_on=True):
    jout = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                           caps, _filters(ipa_on), serial_scan=serial,
                           tie_seed=np.uint32(seed))
    tout = TP.launch_batch(port_spec(spec), mirror.well_known(), _weights(),
                           port_caps(caps), _filters(ipa_on),
                           serial_scan=serial, tie_seed=seed, device="cpu")
    for f in EXACT:
        want, got = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        assert np.array_equal(want, got), (
            f"{f}: port differs from JAX at "
            f"{np.argwhere(want != got)[:5].tolist()}")
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score),
                               rtol=0, atol=SCORE_ATOL)
    return tout


@pytest.mark.parametrize("serial", [False, True], ids=["auction", "scan"])
@pytest.mark.parametrize("case", [f"fuzz{s}" for s in range(6)]
                         + ["unlabeled", "ipa_off"]
                         + list(SOFT_SCENARIOS))
def test_soft_launch_matches_jax(case, serial):
    """launch_batch on a soft-only launch in both packages: the soft
    auction (serial_scan=False: K5, then K4 + K2a soft + K2b rounds), and
    the serial scan (the port's topology branch against the reference's
    reduced soft scan)."""
    ipa_on = case != "ipa_off"
    if case in SOFT_SCENARIOS:
        mirror, spec, caps = scenario_launch(case)
        seed = 0
    else:
        seed = int(case[4:]) if case.startswith("fuzz") else 7
        mirror, spec, caps = fuzz_launch(seed, n_pods=8,
                                         unlabeled=case == "unlabeled")
    tout = _both(mirror, spec, caps, serial, seed, ipa_on)
    assert int((tout.node_row >= 0).sum()) > 0
    if case == "existing_anti_blocks":
        # the table's required anti-affinity rejects z1 (column 7: ipa)
        assert int(tout.reject_counts[0, IPA]) == 2
        assert tout.node_row[0].item() == mirror.row_of("n3")


def test_soft_auction_k_accept_matches_jax():
    """B > N: 24 soft pods over 12 nodes take the K-accept rounds."""
    rng = random.Random(11)
    table, snap, mirror = SA.build(rng)
    pods = [SA.soft_pod(f"p-{i}", rng) for i in range(24)]
    for i, p in enumerate(pods):
        p.metadata.uid = f"p-{i}"
    spec = mirror.prepare_launch(pods, 32)
    assert spec.topo_soft
    tout = _both(mirror, spec, SA.CAPS, serial=False, seed=3)
    assert int((tout.node_row >= 0).sum()) == 24


def test_soft_auction_is_the_launch_not_the_scan():
    """The soft auction and the scan are different commit engines: on a
    batch with in-batch preferred terms they may place differently, and
    each must match its own reference route (checked above); here the
    round loop is seen to run (flag round trips > 0) only in the auction."""
    mirror, spec, caps = fuzz_launch(2, n_pods=8)
    args = (port_spec(spec), mirror.well_known(), _weights(),
            port_caps(caps))
    auction = TP.launch_batch(*args, serial_scan=False, device="cpu")
    scan = TP.launch_batch(*args, serial_scan=True, device="cpu")
    assert auction.round_trips >= 1 and scan.round_trips == 0
