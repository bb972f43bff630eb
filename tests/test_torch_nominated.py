"""The port's incremental ``Mirror.set_nominated`` on the CPU: after
seeded random sequences of nominations added, moved to another node,
replaced by a new pod object and removed (with a node removed and re-added
in some sequences), the mirror that refreshed only what changed holds the
same blobs as a port mirror driven through the same sequence with a full
refresh at every call (the reference's algorithm: every nominated slot
released, every nominated row zeroed, every nomination repacked; node
rows byte for byte, each pod's table slot byte for byte, the table as a
set of slots), and the same nominated rows and slots as
the JAX package's ``Mirror.set_nominated`` (a full refresh every call) on
the same sequence. Rows and slots that did not change are neither
rewritten nor marked dirty."""

import copy
import random

import numpy as np
import pytest

from kubernetes_tpu.backend.cache import Cache as JCache
from kubernetes_tpu.backend.mirror import Mirror as JMirror
from kubernetes_tpu.backend.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu.testing import MakeNode, MakePod
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.mirror import Mirror as TMirror
from kubernetes_tpu_torch.backend.node_info import PodInfo
from kubernetes_tpu_torch.backend.snapshot import Snapshot as TSnapshot
from kubernetes_tpu_torch.ops import features as F
from tests.torch_port_support import port_caps, to_port

pytestmark = pytest.mark.torch_port

N_NODES = 10
CAPS = JCaps(nodes=16, pods=96)


def _nodes():
    return [MakeNode().name(f"n{i}").label("zone", f"z{i % 3}")
            .capacity(cpu="8", memory="16Gi", pods="40").obj()
            for i in range(N_NODES)]


def _bound():
    out = []
    for i in range(12):
        p = (MakePod().name(f"b{i}").uid(f"b{i}").label("app", f"a{i % 3}")
             .req(cpu="500m", memory="1Gi").node_name(f"n{i % N_NODES}")
             .obj())
        out.append(p)
    return out


def _preemptor(rng: random.Random, k: int, gen: int):
    """A pending pod; every third carries a required anti-affinity term
    (the slow pack path), the rest take the template path."""
    b = (MakePod().name(f"p{k}").uid(f"p{k}").priority(10)
         .label("app", f"a{rng.randrange(3)}").label("gen", str(gen))
         .req(cpu=f"{rng.choice([100, 250, 900])}m",
              memory=f"{rng.choice([128, 512])}Mi"))
    if k % 3 == 0:
        b = b.pod_anti_affinity("zone", {"app": "a0"})
    return b.obj()


class _Side:
    """One package's cache, snapshot and mirror."""

    def __init__(self, port: bool, nodes, bound):
        self.port = port
        self.conv = to_port if port else (lambda x: x)
        self.cache = (TCache if port else JCache)()
        for nd in nodes:
            self.cache.add_node(self.conv(nd))
        for p in bound:
            self.cache.add_pod(self.conv(p))
        self.snap = (TSnapshot if port else JSnapshot)()
        self.mirror = (TMirror(caps=port_caps(CAPS), device="cpu")
                       if port else JMirror(caps=CAPS))
        self.sync()

    def sync(self):
        self.cache.update_snapshot(self.snap)
        self.mirror.sync(self.snap)


def _full_refresh(m, by_node: dict) -> None:
    """The reference's set_nominated (kubernetes_tpu/backend/mirror.py)
    on a port mirror: release every nominated slot, zero every nominated
    row, repack every nomination."""
    for uid in list(m._nominated_uids):
        m._release_pod_slot(uid)
    m._nominated_uids.clear()
    off, size = m.node_codec._f32_off["nominated_req"]
    for row in list(m._nominated_req_of_row):
        m.node_f32[row, off:off + size] = 0.0
    m._nominated_req_of_row.clear()
    for node_name, pods in by_node.items():
        row = m._row_of.get(node_name)
        if row is None or not pods:
            continue
        req_sum = np.zeros((m.caps.res_cols,), np.float32)
        for pod in pods:
            pi = PodInfo(pod)
            key = "nominated:" + pod.metadata.uid
            m._pack_pod_slot(key, pi, row, node_name, nominated=True)
            m._nominated_uids.add(key)
            req_sum += m._res_row(pi.request)
            req_sum[F.COL_PODS] += 1.0
        m._nominated_req_of_row[row] = req_sum
        m.node_f32[row, off:off + size] = req_sum


def _by_node(noms: dict, objs: dict) -> dict:
    """The nominator's feed: node -> pods in nomination order."""
    out: dict = {}
    for uid, node in noms.items():
        out.setdefault(node, []).append(objs[uid])
    return out


def _slots(m) -> dict:
    """uid -> the bytes of its pod-table slot."""
    return {uid: np.asarray(m.pods_i32[slot]).tobytes()
            for uid, slot in m._pod_slot.items()}


def _same_blobs(got, want) -> None:
    """Node rows byte for byte; every pod's slot byte for byte; the free
    slots empty."""
    for name in ("node_f32", "node_i32"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want,
                                                                  name))
        assert a.tobytes() == b.tobytes(), name
    assert _slots(got) == _slots(want)
    used = set(got._pod_slot.values())
    free = [s for s in range(got.pods_i32.shape[0]) if s not in used]
    assert not np.asarray(got.pods_i32)[free].any()
    assert got._nominated_uids == set(want._nominated_uids)
    assert sorted(got._nominated_req_of_row) == sorted(
        want._nominated_req_of_row)


def _nominated_view(m) -> tuple:
    """The nominated overlay alone: nominated_req of every row, and each
    nominated pod's slot bytes."""
    off, size = m.node_codec._f32_off["nominated_req"]
    rows = np.asarray(m.node_f32)[:, off:off + size].tobytes()
    slots = {k: v for k, v in _slots(m).items()
             if k.startswith("nominated:")}
    return rows, slots


def _step(rng: random.Random, noms: dict, objs: dict, k: list, gen: int):
    """One random change to the nominations: add, move, replace or
    remove (several at once sometimes)."""
    for _ in range(rng.choice([1, 1, 2, 4])):
        op = rng.choice(["add", "add", "move", "replace", "remove"])
        if op == "add" or not noms:
            uid = f"p{k[0]}"
            objs[uid] = _preemptor(rng, k[0], gen)
            noms[uid] = f"n{rng.randrange(N_NODES)}"
            k[0] += 1
        elif op == "move":
            uid = rng.choice(sorted(noms))
            noms[uid] = f"n{rng.randrange(N_NODES)}"
        elif op == "replace":
            uid = rng.choice(sorted(noms))
            objs[uid] = copy.deepcopy(objs[uid])
            objs[uid].metadata.labels["gen"] = str(gen)
        else:
            uid = rng.choice(sorted(noms))
            del noms[uid]


@pytest.mark.parametrize("seed", range(6))
def test_incremental_refresh_equals_full_refresh_and_reference(seed):
    rng = random.Random(seed)
    nodes, bound = _nodes(), _bound()
    jax_side, port = _Side(False, nodes, bound), _Side(True, nodes, bound)
    full = _Side(True, nodes, bound)
    noms: dict = {}
    objs: dict = {}
    port_objs: dict = {}
    k = [0]
    for gen in range(12):
        _step(rng, noms, objs, k, gen)
        if seed % 2 and gen == 6:
            # a node leaves and comes back: its row and slots are released
            gone = nodes[3]
            for side in (jax_side, port, full):
                side.cache.remove_node(side.conv(gone))
                side.sync()
                side.cache.add_node(side.conv(gone))
                side.sync()
        for uid, p in objs.items():
            if uid not in port_objs or port_objs[uid][0] is not p:
                port_objs[uid] = (p, to_port(p))
        jax_side.mirror.set_nominated(_by_node(noms, objs))
        feed = _by_node(noms, {u: port_objs[u][1] for u in noms})
        port.mirror.set_nominated(feed)
        _full_refresh(full.mirror, feed)
        _same_blobs(port.mirror, full.mirror)
        assert _nominated_view(port.mirror) == _nominated_view(
            jax_side.mirror)
        # the same nominations again: nothing moves
        port.mirror._dirty_rows.clear()
        port.mirror._dirty_slots.clear()
        before = _slots(port.mirror)
        port.mirror.set_nominated(feed)
        assert not port.mirror._dirty_rows and not port.mirror._dirty_slots
        assert _slots(port.mirror) == before


def test_only_changed_rows_and_slots_are_written():
    """A move touches its two rows and repacks its one slot; the other
    nominated rows and slots stay clean."""
    side = _Side(True, _nodes(), _bound())
    rng = random.Random(3)
    objs = {f"p{i}": to_port(_preemptor(rng, i, 0)) for i in range(6)}
    noms = {uid: f"n{i}" for i, uid in enumerate(objs)}
    m = side.mirror
    m.set_nominated(_by_node(noms, objs))
    m._dirty_rows.clear()
    m._dirty_slots.clear()
    slot_of = dict(m._pod_slot)
    noms["p1"] = "n7"
    m.set_nominated(_by_node(noms, objs))
    assert m._dirty_rows == {m.row_of("n1"), m.row_of("n7")}
    assert len(m._dirty_slots) <= 2     # p1's old slot freed, its new one
    for uid in ("p0", "p2", "p3", "p4", "p5"):
        assert m._pod_slot["nominated:" + uid] == slot_of["nominated:"
                                                          + uid]
