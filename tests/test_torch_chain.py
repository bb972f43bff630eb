"""Chain-surviving churn in the port, held against the JAX package on the
CPU: the chain patch's twin (kernel K11's plain version) against the
reference's ``patch_chain``, ``Mirror.patch_node`` against the
reference's, the Scheduler's churn bookkeeping (foreign binds and
deletes, bound-pod updates, node add / cordon / delete) against the
reference's placements and against a full re-sync's usage state, its
fallbacks, and K11's wrapper refusing a broken contract. Inputs are made
from seeds with numpy; every comparison is exact."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.backend.cache import Cache as JCache
from kubernetes_tpu.backend.mirror import Mirror as JMirror
from kubernetes_tpu.backend.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.config.types import default_config as j_config
from kubernetes_tpu.hub import Hub as JHub
from kubernetes_tpu.models.pipeline import patch_chain as j_patch_chain
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.testing import MakeNode, MakePod
from kubernetes_tpu_torch import scheduler as S
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.mirror import Mirror as TMirror
from kubernetes_tpu_torch.backend.snapshot import Snapshot as TSnapshot
from kubernetes_tpu_torch.config.types import default_config as t_config
from kubernetes_tpu_torch.hub import Hub as THub
from kubernetes_tpu_torch.kernels import chain as KC
from kubernetes_tpu_torch.models import pipeline as P
from kubernetes_tpu_torch.ops.chain import patch_chain_ref
from kubernetes_tpu_torch.ops.features import Capacities as TCaps
from kubernetes_tpu_torch.scenario.lifecycle import NodeLifecycle
from tests.torch_port_support import to_port

pytestmark = pytest.mark.torch_port


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------- (a) the twin

@pytest.mark.parametrize("r", [4, 74])
@pytest.mark.parametrize("k", [1, 3, 17, 256])
@pytest.mark.parametrize("mode", ["set", "add", "both"])
def test_twin_equals_reference_patch_chain(mode, k, r):
    rng = np.random.default_rng(1000 * k + r)
    n = 1024
    free = rng.normal(0, 1000, (n, r)).astype(np.float32)
    nzr = rng.normal(0, 1000, (n, 2)).astype(np.float32)
    rows = rng.permutation(n)[:2 * k]

    def lists(idx):
        return [(int(i), rng.normal(0, 500, r).astype(np.float32),
                 rng.normal(0, 500, 2).astype(np.float32)) for i in idx]

    sets = lists(rows[:k]) if mode in ("set", "both") else []
    adds = lists(rows[k:]) if mode in ("add", "both") else []
    jf, jn = j_patch_chain(jnp.asarray(free), jnp.asarray(nzr), sets, adds)
    tf, tn = P.patch_chain(torch.from_numpy(free), torch.from_numpy(nzr),
                           sets, adds)
    assert np.array_equal(_bits(jf), _bits(tf.numpy()))
    assert np.array_equal(_bits(jn), _bits(tn.numpy()))
    # the twin itself, on index / row tensors, and out of place
    f0, n0 = torch.from_numpy(free.copy()), torch.from_numpy(nzr.copy())

    def cols(lst, w, j):
        return torch.from_numpy(np.asarray([t[j] for t in lst], np.float32)
                                .reshape(-1, w))

    rf, rn = patch_chain_ref(
        f0, n0, torch.tensor([t[0] for t in sets], dtype=torch.int64),
        cols(sets, r, 1), cols(sets, 2, 2),
        torch.tensor([t[0] for t in adds], dtype=torch.int64),
        cols(adds, r, 1), cols(adds, 2, 2))
    assert torch.equal(rf, tf) and torch.equal(rn, tn)
    assert np.array_equal(f0.numpy(), free) and np.array_equal(n0.numpy(),
                                                               nzr)


# ------------------------------------------------- (g) the K11 contract

@pytest.mark.parametrize("case", ["dup_set", "dup_add", "overlap",
                                  "past_n", "negative"])
def test_k11_wrapper_refuses_a_broken_contract(case):
    n, r = 16, 4
    free, nzr = torch.zeros((n, r)), torch.zeros((n, 2))
    si, ai = {"dup_set": ([1, 1], [2]), "dup_add": ([1], [2, 2]),
              "overlap": ([1, 3], [3]), "past_n": ([n], [2]),
              "negative": ([1], [-1])}[case]
    def rows(idx):
        return [(i, np.zeros(r, np.float32), np.zeros(2, np.float32))
                for i in idx]

    with pytest.raises(ValueError):
        KC.chain_patch(free, nzr, rows(si), rows(ai))


# ---------------------------------------- (b) Mirror.patch_node vs the JAX's

def _node(i, cpu="8", labels=None):
    b = MakeNode().name(f"n-{i}").capacity(cpu=cpu, memory="32Gi",
                                           pods="110")
    for k, v in (labels or {}).items():
        b = b.label(k, v)
    return b.obj()


def _bound(name, node, cpu="500m"):
    return MakePod().name(name).req(cpu=cpu, memory="256Mi") \
        .node_name(node).obj()


def _step(cache, conv, kind, state):
    """Apply one node event to a cache; returns the node name touched."""
    if kind == "add":
        cache.add_node(conv(_node(9, labels={"zone": "z9"})))
        return "n-9"
    if kind == "update":
        cache.update_node(conv(_node(2)),
                          conv(_node(2, labels={"zone": "z-new"})))
        return "n-2"
    if kind == "resources":
        cache.add_pod(conv(_bound("extra", "n-3", cpu="1500m")))
        return "n-3"
    if kind == "remove":
        state["removed"] = conv(_node(1))
        cache.remove_node(state["removed"])
        return "n-1"
    cache.add_node(conv(_node(1, cpu="16", labels={"zone": "back"})))
    return "n-1"


@pytest.mark.parametrize("events", [["add"], ["update"], ["resources"],
                                    ["remove"], ["remove", "readd"]],
                         ids=["add", "update", "resources", "remove",
                              "readd"])
def test_patch_node_matches_reference(events):
    out = []
    for pkg in ("jax", "torch"):
        conv = (lambda x: x) if pkg == "jax" else to_port
        cache = (JCache if pkg == "jax" else TCache)()
        for i in range(6):
            cache.add_node(conv(_node(i, labels={"zone": f"z{i % 2}"})))
        for j in range(12):
            cache.add_pod(conv(_bound(f"b-{j}", f"n-{j % 6}")))
        snap = (JSnapshot if pkg == "jax" else TSnapshot)()
        cache.update_snapshot(snap)
        mirror = (JMirror(caps=JCaps(nodes=16, pods=64)) if pkg == "jax"
                  else TMirror(caps=TCaps(nodes=16, pods=64), device="cpu"))
        mirror.sync(snap)
        state, got = {}, []
        for kind in events:
            name = _step(cache, conv, kind, state)
            res = mirror.patch_node(name, cache.node_info(name))
            got.append((res[0], _bits(res[1]), _bits(res[2])))
            # _row_gen records each row's live generation (generation
            # numbers are process-wide, so compare each to its own cache)
            gens = {nm: g == cache.node_info(nm).generation
                    for nm, g in mirror._row_gen.items()}
            assert all(gens.values())
            got.append((np.asarray(mirror.node_f32).copy(),
                        np.asarray(mirror.node_i32).copy(), gens))
        out.append(got)
    for (want, have) in zip(*out):
        for w, h in zip(want, have):
            if isinstance(w, dict):
                assert w == h
            elif isinstance(w, np.ndarray):
                assert np.array_equal(w.view(np.uint32), h.view(np.uint32))
            else:
                assert w == h


# ------------------------------------------------------- the Schedulers

def _clock():
    tick = itertools.count()
    return lambda: 1000.0 + next(tick) * 1e-3


def _sched(port, hub, pipelined=True, batch=16, nodes=16, pods=256, seed=7):
    cfg = t_config() if port else j_config()
    cfg.batch_size = batch
    cfg.pipelined_waves = pipelined
    cfg.tie_break_seed = seed
    if port:
        return S.Scheduler(hub, cfg, caps=TCaps(nodes=nodes, pods=pods),
                           now=_clock(), device="cpu")
    return JScheduler(hub, cfg, caps=JCaps(nodes=nodes, pods=pods),
                      now=_clock())


def _cluster(port, n=8, cpu="32"):
    hub = THub() if port else JHub()
    conv = to_port if port else (lambda x: x)
    for i in range(n):
        hub.create_node(conv(MakeNode().name(f"node-{i}").capacity(
            cpu=cpu, memory="64Gi", pods="110").obj()))
    return hub, conv


def _pod(name, cpu="100m", mem="64Mi"):
    """A pod whose uid follows its name, so every run of a scenario (each
    arm, each package) feeds the same uids whatever ran before it."""
    return MakePod().name(name).uid(f"uid-{name}").req(cpu=cpu, memory=mem)


def _placements(hub):
    return {p.metadata.name: p.spec.node_name for p in hub.list_pods()}


def _ab_under_churn(port, pipelined):
    """tests/test_pipelined_waves.py::test_pipelined_ab_parity_under_churn's
    sequence: foreign deletes and late arrivals between drains."""
    hub, conv = _cluster(port)
    s = _sched(port, hub, pipelined=pipelined)
    try:
        for i in range(40):
            hub.create_pod(conv(_pod(f"p-{i}").obj()))
        s.run_until_idle()
        victims = sorted((p for p in hub.list_pods() if p.spec.node_name),
                         key=lambda p: p.metadata.name)[:6]
        for v in victims:
            hub.delete_pod(v.metadata.uid)
        for i in range(40, 72):
            hub.create_pod(conv(_pod(f"p-{i}", cpu="150m").obj()))
        s.run_until_idle()
        for p in hub.list_pods():
            cached = s.cache.get_pod(p)
            assert cached is not None \
                and cached.spec.node_name == p.spec.node_name
        return _placements(hub), dict(s.stats)
    finally:
        s.close()


def test_pipelined_ab_parity_under_churn_matches_reference():
    want, jstats = _ab_under_churn(False, True)
    got, tstats = _ab_under_churn(True, True)
    strict, sstats = _ab_under_churn(True, False)
    assert all(want.values())
    assert got == want == strict
    assert tstats["chain_patches"] > 0 and tstats["chain_patch_rows"] > 0
    assert tstats["chain_patches"] == jstats["chain_patches"]
    assert tstats["chain_patch_rows"] == jstats["chain_patch_rows"]
    assert sstats["chain_patches"] == 0


def _resynced_chain(s):
    """extract_state after a full update_snapshot + sync of the
    scheduler's own mirror, and of a fresh mirror, by node name."""
    s.cache.update_snapshot(s.snapshot)
    s.mirror.sync(s.snapshot)
    free, nzr = P.extract_state(s.mirror.to_blobs(), s.caps)
    fresh = TMirror(caps=s.caps, device="cpu")
    snap = TSnapshot()
    s.cache.update_snapshot(snap)
    fresh.sync(snap)
    ffree, fnzr = P.extract_state(fresh.to_blobs(), s.caps)
    names = [n for n in fresh._row_of]
    return free, nzr, {n: (ffree[fresh.row_of(n)], fnzr[fresh.row_of(n)])
                       for n in names}


def test_patched_chain_equals_a_full_resync():
    hub, conv = _cluster(True)
    s = _sched(True, hub)
    life = NodeLifecycle(hub)

    def pods(tag, n, cpu="100m"):
        for i in range(n):
            hub.create_pod(conv(_pod(f"{tag}-{i}", cpu=cpu).obj()))
        s.run_until_idle()

    try:
        pods("a", 40)
        # foreign binds and deletes
        for i in range(5):
            hub.create_pod(conv(_pod(f"f-{i}", cpu="700m", mem="128Mi")
                                .node_name(f"node-{i}").obj()))
        for v in sorted((p for p in hub.list_pods() if p.spec.node_name),
                        key=lambda p: p.metadata.name)[:4]:
            hub.delete_pod(v.metadata.uid)
        pods("b", 16)
        # a bound-pod update (labels and requests move)
        f0 = next(p for p in hub.list_pods() if p.metadata.name == "f-0")
        upd = f0.clone()
        upd.metadata.labels = {"tier": "x"}
        upd.spec.containers[0].resources.requests["cpu"] = "900m"
        hub.update_pod(upd)
        # a node add and a cordon
        life.add(conv(MakeNode().name("node-new").capacity(
            cpu="32", memory="64Gi", pods="110").obj()))
        assert life.cordon("node-3")
        pods("c", 24)
        assert not any(p.spec.node_name == "node-3" for p in hub.list_pods()
                       if p.metadata.name.startswith("c-"))
        # a node delete (its pods stay bound to it in the hub)
        assert life.remove("node-5")
        pods("d", 16)
        st = s.stats
        assert st["chain_patches"] >= 3 and st["chain_patch_fallbacks"] == 0
        chain_free, chain_nzr = (t.clone() for t in s._chain)
        free, nzr, by_name = _resynced_chain(s)
        assert np.array_equal(_bits(chain_free.numpy()), _bits(free.numpy()))
        assert np.array_equal(_bits(chain_nzr.numpy()), _bits(nzr.numpy()))
        for name, (f, n) in by_name.items():
            row = s.mirror.row_of(name)
            assert np.array_equal(_bits(chain_free[row].numpy()),
                                  _bits(f.numpy())), name
            assert np.array_equal(_bits(chain_nzr[row].numpy()),
                                  _bits(n.numpy())), name
        assert "node-5" not in by_name
    finally:
        s.close()


def _count_syncs(s):
    calls = [0]
    real = s.cache.update_snapshot

    def counted(snap):
        calls[0] += 1
        return real(snap)

    s.cache.update_snapshot = counted
    return calls


def test_steady_churn_patches_without_a_resync():
    """The counterpart of test_no_recompiles_in_steady_churn: after a
    first drain, three rounds of steady churn patch the chain, with no
    fallback and no snapshot sync in those batches."""
    hub, conv = _cluster(True)
    s = _sched(True, hub, batch=16)
    try:
        for i in range(48):
            hub.create_pod(conv(_pod(f"w-{i}").obj()))
        s.run_until_idle()
        syncs = _count_syncs(s)
        for rnd in range(3):
            victims = [p for p in hub.list_pods() if p.spec.node_name][:4]
            for v in victims:
                hub.delete_pod(v.metadata.uid)
            for i in range(16):
                hub.create_pod(conv(_pod(f"c-{rnd}-{i}").obj()))
            s.run_until_idle()
        assert s.stats["chain_patches"] >= 3
        assert s.stats["chain_patch_fallbacks"] == 0
        # every fold carried rows, and its split counted it
        assert s.stats["chain_split_s"]["folds"] == s.stats["chain_patches"]
        assert syncs[0] == 0, "steady churn re-synced the snapshot"
        assert all(p.spec.node_name for p in hub.list_pods())
    finally:
        s.close()


def _fallback_run(port, case):
    nodes = 300 if case == "many_nodes" else 16
    hub, conv = _cluster(port, n=8)
    s = _sched(port, hub, nodes=512 if case == "many_nodes" else 16)
    try:
        for i in range(24):
            hub.create_pod(conv(_pod(f"a-{i}").obj()))
        s.run_until_idle()
        if case == "many_nodes":
            # more than CHAIN_PATCH_MAX dirty nodes
            for i in range(S.CHAIN_PATCH_MAX + 1):
                hub.create_node(conv(MakeNode().name(f"x-{i}").capacity(
                    cpu="1", memory="1Gi", pods="110").obj()))
        elif case == "never_mirrored":
            # a foreign bind to a node the mirror never packed
            hub.create_pod(conv(_pod("ghost").node_name("ghost-node").obj()))
        else:
            # the node table is full: the repack overflows it
            for i in range(8, nodes + 1):
                hub.create_node(conv(MakeNode().name(f"node-{i}").capacity(
                    cpu="32", memory="64Gi", pods="110").obj()))
        if port:
            syncs = _count_syncs(s)
        for i in range(16):
            hub.create_pod(conv(_pod(f"b-{i}").obj()))
        s.run_until_idle()
        return _placements(hub), dict(s.stats), syncs[0] if port else None
    finally:
        s.close()


@pytest.mark.parametrize("case", ["many_nodes", "never_mirrored",
                                  "capacity"])
def test_chain_patch_fallbacks_count_and_resync(case):
    want, jstats, _ = _fallback_run(False, case)
    got, tstats, syncs = _fallback_run(True, case)
    assert got == want
    assert tstats["chain_patch_fallbacks"] == \
        jstats["chain_patch_fallbacks"] == 1
    assert syncs >= 1
