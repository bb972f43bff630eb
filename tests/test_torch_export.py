"""The export tails through launch_batch, the port against the JAX
package on the CPU, where the port runs its kernels' twins (K2a's export
pass, K3's export outputs).

The same packed launch goes through both packages with
``with_feats`` / ``with_alts`` and a learned scorer (the JAX package's
params carried across by convert.learned_params) or none, on each commit
engine: the plain auction, the soft-score auction, the hard-topology
scan and the scan with the percentageOfNodesToScore window.

Placements and ``alt_row`` must be identical. An ``alt_row`` that differs
only where the two JAX-side totals are within the tolerance is reported
as a tie flip (the learned term's sums run in another order in XLA), and
still fails. ``chosen_feat`` and ``alt_score`` are held to 1e-4
(absolute, on totals of at most a few hundred), ``learned_mag`` to 1e-4
relative: it is a mean over thousands of (pod, node) pairs whose float32
sum runs in the kernel's fixed lane order in the port and in XLA's order
in the reference, which alone moves the last few bits of a sum of ~1e5.
``learned_mag`` is present whenever a learned scorer is on, and 0 without
one, as in the reference.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.models import pipeline as TP
from tests import test_torch_pipeline as TPL
from tests import test_torch_soft as TSO
from tests.test_torch_learned_launch import _scorer, _weights
from tests.test_torch_pct import _mirror as pct_mirror
from tests.torch_port_support import port_caps, port_spec

pytestmark = pytest.mark.torch_port

TOL = 1e-4


def check_alt_rows(jout, tout):
    want = np.asarray(jout.alt_row)
    got = tout.alt_row.numpy()
    if np.array_equal(want, got):
        return
    bad = np.argwhere(want != got)
    ties = []
    for b, k in bad[:5].tolist():
        ws = np.asarray(jout.alt_score)[b]
        ties.append((b, k, want[b].tolist(), got[b].tolist(), ws.tolist()))
    js = np.asarray(jout.alt_score)
    flips = all(abs(js[b, k] - js[b, k - 1 if k else k + 1]) <= TOL
                for b, k in bad.tolist())
    raise AssertionError(("tie flip: " if flips else "alt_row differs: ")
                         + repr(ties))


def both(mirror, spec, caps, params, serial, seed=0, w_learned=1.0,
         feats=True, alts=True, **kw):
    """Both packages' launch with the export tails on; returns (jax out,
    port out)."""
    jw, tw = _weights(w_learned)
    jp = (None if params is None else
          tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params))
    tp = None if params is None else convert.learned_params(params, "cpu")
    jout = JP.launch_batch(spec, mirror.well_known(), jw, caps,
                           serial_scan=serial, learned=jp,
                           tie_seed=np.uint32(seed), with_feats=feats,
                           with_alts=alts, **kw)
    tout = TP.launch_batch(port_spec(spec), mirror.well_known(), tw,
                           port_caps(caps), serial_scan=serial, learned=tp,
                           tie_seed=seed, device="cpu", with_feats=feats,
                           with_alts=alts, **kw)
    assert np.array_equal(np.asarray(jout.node_row), tout.node_row.numpy())
    check_alt_rows(jout, tout)
    np.testing.assert_allclose(tout.alt_score.numpy(),
                               np.asarray(jout.alt_score), rtol=0, atol=TOL)
    np.testing.assert_allclose(tout.chosen_feat.numpy(),
                               np.asarray(jout.chosen_feat), rtol=0,
                               atol=TOL)
    assert tout.learned_mag is not None
    np.testing.assert_allclose(float(tout.learned_mag),
                               float(jout.learned_mag), rtol=TOL, atol=1e-6)
    if params is None:
        assert float(tout.learned_mag) == 0.0
    assert tout.alt_row.shape == (tout.node_row.shape[0], TP.ALT_K)
    assert tout.chosen_feat.shape == (tout.node_row.shape[0], 9)
    return jout, tout


@pytest.mark.parametrize("learned", [None, (8,), (16, 8)],
                         ids=["hand", "h8", "h16_8"])
@pytest.mark.parametrize("case", ["auction_balance",
                                  "auction_tolerations_affinity",
                                  "rich_fuzz", "k_accept"])
def test_plain_auction_export_matches_jax(case, learned):
    mirror, spec, caps = TPL.CASES[case]()
    params = None if learned is None else _scorer(learned, 1)
    _, tout = both(mirror, spec, caps, params, serial=False, seed=3,
                   w_learned=2.0)
    placed = tout.node_row.numpy() >= 0
    assert placed.any()
    # a placed pod's own node rides its candidate set
    rows = tout.alt_row.numpy()
    assert (rows[placed] >= 0).any()
    if learned is not None:
        assert float(tout.learned_mag) > 0


@pytest.mark.parametrize("feats,alts", [(True, False), (False, True),
                                        (False, False)])
def test_each_export_flag_alone_matches_jax(feats, alts):
    """Each tail alone, and a learned scorer with both off (learned_mag
    only)."""
    mirror, spec, caps = TPL.CASES["rich_fuzz"]()
    for serial in (False, True):
        both(mirror, spec, caps, _scorer((8,), 2), serial=serial, seed=1,
             feats=feats, alts=alts)


@pytest.mark.parametrize("seed", [0, 4, 7])
def test_soft_auction_export_matches_jax(seed):
    """K2a's soft mode: the end-state soft halves (K4 at the final
    placement) feed the totals and the spread / ipa feature columns."""
    mirror, spec, caps = TSO.fuzz_launch(seed, n_pods=8)
    both(mirror, spec, caps, _scorer((8,), seed), serial=False, seed=seed)
    both(mirror, spec, caps, None, serial=False, seed=seed)


@pytest.mark.parametrize("case", ["in_batch_anti", "spread_hostname",
                                  "required_affinity",
                                  "soft_spread_unlabeled_key"])
@pytest.mark.parametrize("learned", [None, (8,)], ids=["hand", "h8"])
def test_scan_export_matches_jax(case, learned):
    from tests import test_topology as TT

    nodes, bound, pods = TPL._hard_scenarios()[case]()
    mirror = TPL._mirror(nodes, bound, TT.CAPS)
    spec = mirror.prepare_launch(pods, 8)
    params = None if learned is None else _scorer(learned, 2)
    both(mirror, spec, TT.CAPS, params, serial=True, seed=5)


@pytest.mark.parametrize("seed", [0, 2])
def test_oracle_fuzz_scan_export_matches_jax(seed):
    rng = random.Random(seed)
    caps = TPL.Capacities(nodes=16, pods=128)
    nodes = [TPL.oracle_node(i, rng) for i in range(12)]
    pods = [TPL.oracle_pod(i, rng) for i in range(48)]
    mirror = TPL._mirror(nodes, [], caps)
    spec = mirror.prepare_launch(pods, 64)
    _, tout = both(mirror, spec, caps, _scorer((8,), seed), serial=True,
                   seed=seed)
    assert int((tout.node_row >= 0).sum()) > 0


@pytest.mark.parametrize("pct", [50, JP.ADAPTIVE_PCT])
@pytest.mark.parametrize("learned", [None, (8,)], ids=["hand", "h8"])
def test_pct_window_scan_export_matches_jax(pct, learned):
    """The window's kept nodes are the candidates: the top ALT_K, the
    features and the step magnitudes over them."""
    from kubernetes_tpu.models.testbed import make_pod

    mirror = pct_mirror(200)
    caps = TPL.Capacities(nodes=256, pods=64)
    params = None if learned is None else _scorer(learned, 3)
    spec = mirror.prepare_launch([make_pod(i) for i in range(8)], 8)
    both(mirror, spec, caps, params, serial=True, seed=1, pct_nodes=pct)


def _slice_sum_model(row, slice_):
    """K2a's export order for one pod, in float32 scalars: in each node
    slice lane t adds entries t, t + 32, ... in order; the lanes fold as
    the xor tree leaves them in lane 0 (x[i] + x[i + 16], then + 8, ...);
    the slices' sums fold in rank order."""
    import numpy as np

    f32 = np.float32
    out = None
    for s0 in range(0, len(row), slice_):
        lanes = [f32(0.0)] * 32
        for i in range(s0, min(s0 + slice_, len(row))):
            t = (i - s0) % 32
            lanes[t] = f32(lanes[t] + f32(row[i]))
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [f32(lanes[i] + lanes[i + h]) for i in range(h)]
        out = lanes[0] if out is None else f32(out + lanes[0])
    return out


def test_lane_sums_are_the_kernels_order():
    """The twins' learned-magnitude order: K2a's export pass sums a pod's
    |term| over each CTA's node slice (lane t adds entries t, t + 32, ...
    then the xor tree) and folds the slices in rank order, bit for bit a
    slice-by-slice model on floats and the plain sum on integers; the
    scan's block / warp / cluster fold reduces to the plain sum on
    integers (exact in any order)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import scan as KS

    v = torch.arange(1, 301, dtype=torch.float32)
    assert float(KA.lane_sum(v)) == float(v.sum())
    for sl in (32, 64, 160):
        assert float(KA.lane_sum(v, sl)) == float(v.sum())
    assert float(KS.scan_lmag_sum(v, (16, 32, 128))) == float(v.sum())
    assert float(KS.scan_lmag_sum(v, KS.default_lmag_order(300))) == float(
        v.sum())
    x = torch.tensor([1e8, 1.0, -1e8] + [0.0] * 29)
    # the tree pairs lane 0 with 16, 8, 4, 2, 1: (1e8 + 1) + -1e8 rounds
    assert float(KA.halving_tree(x)) == float((x[0] + x[2]) + x[1])
    rng = np.random.default_rng(18)
    for n in (100, 1000, 1025, 5000, 8192):
        sl = KA.export_slice(n)
        rows = (rng.standard_normal((2, n)) * 1e3).astype(np.float32)
        got = KA.lane_sum(torch.from_numpy(rows), sl)
        for r in range(2):
            assert float(got[r]) == float(_slice_sum_model(rows[r], sl)), \
                (n, sl, r)
        # summed as one slice the rows take another order: where the
        # cluster splits them, the two orders round apart on these floats
        whole = KA.lane_sum(torch.from_numpy(rows))
        assert bool((whole != got).any()) == (KA.export_cluster(n) > 1)


# --------------------------------------------- a whole drain's v3 export


def _drain_export(port, tmp_path, nodes, phases, node_cap, ckpt):
    """One package's Scheduler drain (tests/test_torch_learned_sched.py's
    harness) with the export on: trace_export_path, features and
    alternatives. Returns ({uid: placement row}, the Scheduler, the
    export path)."""
    import json

    from tests import test_torch_learned_sched as TLS

    cfg = TLS._learned_cfg(port, ckpt, batch=64, seed=3)
    path = str(tmp_path / f"trace-{'port' if port else 'jax'}.jsonl")
    cfg.trace_export_path = path
    cfg.trace_export_features = True
    cfg.trace_export_alts = True
    _, sched = TLS._drain(port, cfg, nodes, phases, node_cap)
    rows = {}
    with open(path) as fh:
        for line in fh:
            doc = json.loads(line)
            assert doc["v"] == 3
            for r in doc.get("placements") or []:
                rows.setdefault(r["uid"], []).append(r)
    return rows, sched, path


@pytest.mark.parametrize("scenario", ["plain", "spread"])
def test_scheduler_drain_writes_the_same_v3_export(tmp_path, scenario):
    """Both Schedulers drain the same pods with a learned profile and the
    export on; every placement row (node, features, alternatives) agrees,
    and the port's export feeds its own replay dataset builder."""
    from tests import test_torch_learned_sched as TLS

    from kubernetes_tpu_torch.learn import replay as TR

    ckpt = str(tmp_path / "scorer.json")
    TLS._publish(ckpt, 1, 1)
    nodes, phases, cap = (TLS._plain() if scenario == "plain"
                          else TLS._spreading())
    want, jsched, _ = _drain_export(False, tmp_path, nodes, phases, cap,
                                    ckpt)
    got, tsched, path = _drain_export(True, tmp_path, nodes, phases, cap,
                                      ckpt)
    assert set(got) == set(want) and got
    n_alt = 0
    for uid, w_rows in want.items():
        g_rows = got[uid]
        assert [r["node"] for r in g_rows] == [r["node"] for r in w_rows]
        for g, w in zip(g_rows, w_rows):
            if w["node"] is None:
                continue
            np.testing.assert_allclose(g["feat"], w["feat"], rtol=0,
                                       atol=2e-4)
            assert [a[0] for a in g["alt"]] == [a[0] for a in w["alt"]]
            np.testing.assert_allclose([a[1] for a in g["alt"]],
                                       [a[1] for a in w["alt"]], rtol=0,
                                       atol=2e-3)
            n_alt += len(g["alt"])
    assert n_alt > 0
    # the learned family of the metrics: the magnitude was observed once
    # a launch with the scorer on, after the guard check
    assert tsched.metrics.learned_magnitude.count() >= 1
    assert list(tsched.metrics.learned_checkpoint_version.collect()
                .values()) == [1.0]
    ds = TR.build_dataset([path])
    assert len(ds) == sum(1 for rs in got.values() for r in rs
                          if r["node"] is not None)
