"""K2b's acceptance at its edges: whole auction launches through both
packages on the CPU (the port runs its kernels' plain twins), on the
launches of kubernetes_tpu_torch/perf/fuzz.py accept_cases, which
chip_smoke.py also runs on the card, kernel against twin:

- a hot node chosen by every pod, B <= N (one accept a round);
- two hot nodes with B > N (the K-accept rounds), the cumulative request
  stopping to fit in the middle of each node's list;
- a pod whose nominated row is its chosen node (in both of the above);
- a launch whose first round bids nothing.

Each case packs one cluster and batch with the JAX Mirror (nominations
through set_nominated) and hands the same arrays to the port. Node rows,
feasible and reject counts, free, nzr and the guard must be EXACT; the
winning scores agree within 1e-4 (XLA may fuse a multiply-add on the CPU,
see tests/test_torch_pipeline.py)."""

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.objects as jax_objects
from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu.ops.features import Capacities
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.kernels import auction as KA
from kubernetes_tpu_torch.models import pipeline as TP
from kubernetes_tpu_torch.perf.fuzz import accept_cases
from tests.test_torch_pipeline import EXACT, SCORE_ATOL, _mirror
from tests.torch_port_support import port_caps, port_spec

pytestmark = pytest.mark.torch_port


def _launch(case):
    nodes, pods, nominated, node_cap, batch = accept_cases(jax_objects)[case]
    caps = Capacities(nodes=node_cap, pods=256)
    mirror = _mirror(nodes, [], caps)
    if nominated:
        mirror.set_nominated(nominated)
    return mirror, mirror.prepare_launch(pods, batch), caps, pods


def _both(case, seed):
    mirror, spec, caps, pods = _launch(case)
    weights = convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})
    jout = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                           caps, serial_scan=False, tie_seed=np.uint32(seed))
    tout = TP.launch_batch(port_spec(spec), mirror.well_known(), weights,
                           port_caps(caps), serial_scan=False,
                           tie_seed=seed, device="cpu")
    for f in EXACT:
        want, got = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        assert want.shape == got.shape, f
        assert np.array_equal(want, got), (
            f"{case} {f}: port differs from JAX at "
            f"{np.argwhere(want != got)[:5].tolist()}")
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score),
                               rtol=0, atol=SCORE_ATOL)
    return tout, pods


@pytest.mark.parametrize("seed", [0, 9])
@pytest.mark.parametrize("case", ["hot_node", "two_hot_nodes", "no_bids"])
def test_accept_edge_launch_matches_jax(case, seed):
    out, pods = _both(case, seed)
    rows = out.node_row.tolist()[:len(pods)]
    if case == "hot_node":
        # node-7 (row 7) takes pods of 200m until its 4 CPUs are spent;
        # the nomination's 200m stays reserved through the launch: 19
        assert {r for r in rows if r >= 0} == {7}
        assert sum(r >= 0 for r in rows) == 19
        assert rows[5] == 7             # the pod nominated there
    elif case == "two_hot_nodes":
        assert rows[1] == 11            # first on node-11's list, nominated
        assert rows[0] == 3 and rows[2] == 3
        assert rows[4] == -1            # past node-3's cumulative request
        assert all(r >= 0 for r in rows[40:])
    else:
        assert rows == [-1] * len(pods)
        assert out.round_trips == 1


def test_k_accept_round_rejects_mid_list(monkeypatch):
    """Round 0 of the two-hot-nodes launch (the port, twins on the CPU):
    each hot node takes its first k_accept = 4 choosers in batch order,
    accepts a prefix of them and rejects the rest (their cumulative
    request is past the node's free row); node-11's list starts with the
    pod nominated there, which fits only with its reservation handed
    back."""
    seen = {}
    real = KA.auction_accept_commit

    def commit(rin, choice, win_now, prog, k, **kw):
        real(rin, choice, win_now, prog, k, **kw)
        if k == 0:
            seen.update(k=int(rin.k_accept), choice=choice.tolist(),
                        placed=rin.placed.tolist(), flag=int(prog[1]))

    monkeypatch.setattr(KA, "auction_accept_commit", commit)
    _both("two_hot_nodes", 0)
    choice, placed = seen["choice"], seen["placed"]
    assert seen["k"] == 4 and seen["flag"] == 1
    on3 = [b for b in range(40) if choice[b] == 3]
    on11 = [b for b in range(40) if choice[b] == 11]
    assert on3[:4] == [0, 2, 4, 6] and on11[:4] == [1, 3, 5, 7]
    assert [placed[b] for b in on3] == [3, 3] + [-1] * (len(on3) - 2)
    assert [placed[b] for b in on11] == [11] + [-1] * (len(on11) - 1)
