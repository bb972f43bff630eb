"""Preemption in the port (K6 and the Evaluator) against the JAX package.

- The silent park is gone: the port's default profile runs
  DefaultPreemption, and a preemptor binds after evicting.
- K6a's twin (ops/preempt.py preempt_sweep, through kernels/preempt.py)
  against ``preempt_sweep_jit`` on seeded clusters, the victim state
  (cumsum with its padding aliases, column list) built by each package's
  own Evaluator, with nominated reservations and a live-free override;
  plus the memory-only inactive-column case. kmin must be EXACT.
- K6b's twin (preempt_feasible) against ``preempt_feasible_jit`` on the
  tests/test_golden.py clusters that use it and on the topology fuzz at 64
  nodes, under table masks, free overrides and enable_topology both ways.
  EXACT (the outputs are bools).
- Every tests/test_preemption.py scenario, a burst of four
  anti-affinity preemptors in one failure batch, chip_smoke.py's
  PostFilter path at 300 nodes and 16 preemptors (collisions included),
  and the preemptor-rides-the-next-wave shape
  of tests/test_pipelined_waves.py, through both packages' Hub +
  Scheduler on the same deterministic clock: identical bindings,
  evictions, nominations and ``stats["preemptions"]``.
- The harness: PreemptionAsync tiny, the AsyncPreemptionEnabled variant,
  churn injected on the clock, and a reduced PreemptionAsync drain (fixed
  preemptors in place of wall-clock churn) against the JAX harness.

No tolerance anywhere: every compared output is an integer or a bool."""

import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest

import kubernetes_tpu.api.objects as jax_objects
from kubernetes_tpu.api.objects import (
    LABEL_HOSTNAME,
    Affinity,
    Container,
    LabelSelector,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodAntiAffinity,
    PodDisruptionBudget,
    PodSpec,
    ResourceRequirements,
)
from kubernetes_tpu.backend.cache import Cache as JCache
from kubernetes_tpu.backend.mirror import Mirror as JMirror
from kubernetes_tpu.backend.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.config.types import default_config as j_config
from kubernetes_tpu.framework.preemption import Evaluator as JEvaluator
from kubernetes_tpu.hub import Hub as JHub
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu.ops.preempt import preempt_feasible_jit, preempt_sweep_jit
from kubernetes_tpu.perf import workloads as JW
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.mirror import Mirror as TMirror
from kubernetes_tpu_torch.backend.snapshot import Snapshot as TSnapshot
from kubernetes_tpu_torch.config.types import default_config as t_config
from kubernetes_tpu_torch.framework.preemption import Evaluator as TEvaluator
from kubernetes_tpu_torch.hub import Hub as THub
from kubernetes_tpu_torch.kernels import preempt as KP
from kubernetes_tpu_torch.ops.features import Capacities as TCaps
from kubernetes_tpu_torch.perf.fuzz import preemption_fuzz, topology_fuzz
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from tests import test_golden as G
from tests import test_preemption as TP
from tests.torch_port_support import (
    port_caps,
    start_uids,
    to_port,
    uid_base,
)

pytestmark = pytest.mark.torch_port


# ------------------------------------------------ the silent park repaired


def test_default_profile_preempts_instead_of_parking():
    """The default profile's PostFilter is DefaultPreemption; one node of
    2 CPUs holding two priority-0 pods of 1 CPU each, then a priority-100
    pod of 2 CPUs: both victims are evicted and the pod binds (the port
    parked it, with no PostFilter at all, before preemption was
    ported)."""
    hub = THub()
    sched = TScheduler(hub, caps=TCaps(nodes=16, pods=64), device="cpu",
                       now=TP.Clock().now)
    try:
        assert [n for n, _ in sched.framework.points["post_filter"]] == \
            ["DefaultPreemption"]
        hub.create_node(to_port(TP.mknode(0, cpu="2")))
        low = [to_port(TP.mkpod(f"low-{i}", cpu="1")) for i in range(2)]
        for p in low:
            hub.create_pod(p)
        sched.run_until_idle()
        high = to_port(TP.mkpod("high", cpu="2", priority=100))
        hub.create_pod(high)
        for _ in range(3):
            sched.run_until_idle()
        assert hub.get_pod(high.metadata.uid).spec.node_name == "node-0"
        assert all(hub.get_pod(p.metadata.uid) is None for p in low)
        assert sched.stats["preemptions"] == 1
    finally:
        sched.close()


def test_unported_preemption_parts_raise_naming_their_roadmap_item():
    """A preemption-capable extender and the fallback ladder's serial host
    preemption are later slices: each raises instead of taking another
    route. Whole-gang eviction of a gang victim is ported (K7's slice): a
    gang victim with no bound co-member expands to itself, unblocked
    (tests/test_torch_gang_sched.py holds the expansion to the JAX
    package)."""
    from kubernetes_tpu_torch.api.objects import LABEL_POD_GROUP

    ev = TEvaluator(THub(), lambda: None, lambda: None,
                    lambda pod=None: None, None)
    gang = to_port(TP.mkpod("member", labels={LABEL_POD_GROUP: "g"}))
    assert ev._expand_gang_victims([gang]) == ([gang], "")

    class Extender:
        supports_preemption = True

        def is_interested(self, pod):
            return True

    ev.extenders_fn = lambda: [Extender()]
    with pytest.raises(NotImplementedError, match="item 7"):
        ev.call_extenders(gang, [])
    with pytest.raises(NotImplementedError, match="item 11"):
        ev.host_preempt(gang, TSnapshot())


@pytest.mark.parametrize("batched", [True, False],
                         ids=["one_delete_pods_wave", "per_victim_deletes"])
def test_flush_evicts_every_victim_and_opens_the_gates(batched):
    """test_soft_auction.py:429's shape: two queued candidates flush
    through ONE delete_pods wave (or, on a hub without the batched verb,
    one delete_pod a victim); every victim is gone, every gate open, and
    a candidate whose victims an earlier one already claimed (no deletion
    of its own) has its preemptor activated."""
    from kubernetes_tpu_torch.api.objects import (
        Container as TContainer,
        ObjectMeta as TMeta,
        Pod as TPod,
        PodSpec as TSpec,
    )
    from kubernetes_tpu_torch.backend.nominator import Nominator
    from kubernetes_tpu_torch.framework.preemption import Candidate

    calls = {"delete_pod": 0, "delete_pods": 0}

    class SpyHub(THub):
        def delete_pod(self, uid):
            calls["delete_pod"] += 1
            return super().delete_pod(uid)

        def delete_pods(self, uids):
            calls["delete_pods"] += 1
            return super().delete_pods(uids)

    class SerialHub:
        """A hub without the batched verb."""

        def __init__(self, hub):
            self._hub = hub

        def __getattr__(self, name):
            if name == "delete_pods":
                raise AttributeError(name)
            return getattr(self._hub, name)

    hub = SpyHub()
    victims = []
    for i in range(6):
        p = TPod(metadata=TMeta(name=f"v-{i}", uid=f"v-{i}"),
                 spec=TSpec(containers=[TContainer(name="c")]))
        p.spec.node_name = f"node-{i % 2}"
        hub.create_pod(p)
        victims.append(p)
    ev = TEvaluator(hub if batched else SerialHub(hub), lambda: None,
                    lambda: None, lambda pod=None: (), Nominator())
    activated = []
    ev.activate_fn = activated.extend
    pre = [TPod(metadata=TMeta(name=f"hi{i}", uid=f"hi{i}"),
                spec=TSpec(containers=[TContainer(name="c")], priority=10))
           for i in range(3)]
    for p, node, vs in ((pre[0], "node-0", victims[:3]),
                        (pre[1], "node-1", victims[3:]),
                        (pre[2], "node-1", victims[3:])):
        ev.prepare_candidate(Candidate(node_name=node, row=-1, victims=vs,
                                       pdb_violations=0), p)
    assert ev.has_pending() and len(ev.preempting) == 3
    assert ev.flush_evictions() == 3
    # the per-victim path also tries the third candidate's victims, already
    # gone (NotFound is swallowed)
    assert calls == ({"delete_pod": 0, "delete_pods": 1} if batched
                     else {"delete_pod": 9, "delete_pods": 0})
    assert all(hub.get_pod(v.metadata.uid) is None for v in victims)
    assert not ev.preempting and not ev.has_pending()
    assert [p.metadata.name for p in activated] == ["hi2"]


# ------------------------------------------------------------ K6a (sweep)


def _mirrors(nodes, bound, jcaps, namespaces=(), nominated=None):
    """The same cluster synced into a JAX mirror and a port mirror (CPU),
    with their snapshots. ``nominated``: {node name: [pods]}."""
    out = []
    for port in (False, True):
        cache = TCache() if port else JCache()
        snap = TSnapshot() if port else JSnapshot()
        conv = to_port if port else (lambda o: o)
        for ns in namespaces:
            cache.set_namespace(ns.metadata.name, ns.metadata.labels)
        for n in nodes:
            cache.add_node(conv(n))
        for p in bound:
            cache.add_pod(conv(p))
        cache.update_snapshot(snap)
        m = (TMirror(caps=port_caps(jcaps), device="cpu") if port
             else JMirror(caps=jcaps))
        m.sync(snap)
        if nominated:
            m.set_nominated({k: [conv(p) for p in v]
                             for k, v in nominated.items()})
        out.append((m, snap))
    return out


def _victim_state(evaluator_cls, mirror, snap, caps, prio):
    ev = evaluator_cls(None, lambda: mirror, lambda: caps,
                       lambda pod=None: None, None)
    return ev._rebuild_victims(prio, snap, mirror, caps)


def _port_blobs(jm, pblobs):
    cb = jm.to_blobs()
    return (convert.cluster_blobs_from_numpy(
        np.asarray(cb.node_f32), np.asarray(cb.node_i32),
        np.asarray(cb.pods_i32), device="cpu"),
        convert.blobs_from_numpy(np.asarray(pblobs.f32),
                                 np.asarray(pblobs.i32), device="cpu"))


def _sweep_case(seed, extra_columns):
    rng = random.Random(seed)
    nodes, bound, pre = preemption_fuzz(rng, 64, 4, extra_columns,
                                        objects=jax_objects)
    # one preemptor nominated to a node: its own reservation is handed
    # back there, the others see it subtracted
    pre[1].status.nominated_node_name = "node-5"
    nominated = {"node-5": [pre[1]], "node-9": [pre[2].clone()]}
    return nodes, bound, pre, nominated


@pytest.mark.parametrize("seed,extra_columns", [(1, False), (2, True)],
                         ids=["C4_padding_alias", "C8_extra_columns"])
def test_sweep_twin_equals_jax(seed, extra_columns):
    nodes, bound, pre, nominated = _sweep_case(seed, extra_columns)
    jcaps = JCaps(nodes=64, pods=512)
    (jm, jsnap), (tm, tsnap) = _mirrors(nodes, bound, jcaps,
                                        nominated=nominated)
    jst = _victim_state(JEvaluator, jm, jsnap, jcaps, 10)
    tst = _victim_state(TEvaluator, tm, tsnap, port_caps(jcaps), 10)
    # the victim state: same rows, same victims in the same order, the
    # same cumsum (padding columns included) and column list
    assert {r: [pi.pod.metadata.name for pi in vs]
            for r, vs in jst[0].items()} == \
        {r: [pi.pod.metadata.name for pi in vs] for r, vs in tst[0].items()}
    n_vic = sum(len(vs) for vs in jst[0].values())
    assert 200 <= n_vic <= 320, n_vic
    cumsum, cols = np.asarray(jst[4]), np.asarray(jst[3])
    assert cumsum.shape[2] == (8 if extra_columns else 4)
    np.testing.assert_array_equal(cumsum, tst[4])
    np.testing.assert_array_equal(cols, tst[3].numpy())
    if not extra_columns:
        # a padding entry aliases the first ACTIVE column, never col 0 of
        # an inactive resource
        assert cols[-1] == cols[0] and (cumsum[:, :, -1] == 3.0e38).all()
    pblobs = jm.pack_batch_blobs(pre, 4)
    tcb, tpb = _port_blobs(jm, pblobs)
    free = jm.free_matrix()
    live = free + np.random.default_rng(seed).choice(
        [-1000.0, 0.0, 0.0, 500.0], size=free.shape).astype(np.float32)
    for override in (None, live):
        want = np.asarray(preempt_sweep_jit(
            jm.to_blobs(), pblobs, jm.well_known(), jnp.asarray(cumsum),
            jnp.asarray(cols), jcaps,
            free=None if override is None else jnp.asarray(override)))
        inp = convert.preempt_inputs_from_numpy(cumsum, cols, override,
                                                device="cpu")
        got = KP.preempt_sweep(tcb, tpb, jm.well_known(),
                               inp["vic_cumsum"], inp["vic_cols"],
                               port_caps(jcaps), free=inp["free"]).numpy()
        assert got.shape == (4, 64) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        # the case is not degenerate: prefixes of several lengths, and
        # rows where preemption cannot help
        assert len(set(want[want >= 0].tolist())) >= 2
        assert (want == -1).any() and (want >= 1).any()


def test_sweep_twin_keeps_an_inactive_column_constraint():
    """test_preemption.py:323's shape at the kernel: victims free memory
    only (cpu is not among the freed columns; the padding aliases an
    active column), the preemptor needs more CPU than is free — no prefix
    may fit, in both packages."""
    node = TP.mknode(0, cpu="4")
    hog = TP.mkpod("cpu-hog", cpu="3500m", priority=100)
    hog.spec.node_name = "node-0"
    bound = [hog]
    for i in range(3):
        v = Pod(metadata=ObjectMeta(name=f"memhog-{i}"),
                spec=PodSpec(containers=[Container(
                    name="c", resources=ResourceRequirements(
                        requests={"memory": "8Gi"}))], priority=50,
                    node_name="node-0"))
        bound.append(v)
    pre = Pod(metadata=ObjectMeta(name="cpu-hungry"),
              spec=PodSpec(containers=[Container(
                  name="c", resources=ResourceRequirements(
                      requests={"cpu": "2", "memory": "8Gi"}))],
                  priority=60))
    jcaps = JCaps(nodes=16, pods=64)
    (jm, jsnap), (tm, tsnap) = _mirrors([node], bound, jcaps)
    jst = _victim_state(JEvaluator, jm, jsnap, jcaps, 60)
    tst = _victim_state(TEvaluator, tm, tsnap, port_caps(jcaps), 60)
    cols = np.asarray(jst[3])
    np.testing.assert_array_equal(cols, tst[3].numpy())
    assert 0 not in cols[:2], "cpu must not be a freed column"
    pblobs = jm.pack_batch_blobs([pre], 1)
    want = np.asarray(preempt_sweep_jit(
        jm.to_blobs(), pblobs, jm.well_known(), jst[2], jst[3], jcaps))
    tcb, tpb = _port_blobs(jm, pblobs)
    got = KP.preempt_sweep(tcb, tpb, jm.well_known(), tst[2], tst[3],
                           port_caps(jcaps)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == -1).all()


# ------------------------------------------------------ K6b (the dry run)


def _feasible_pair(jm, pod, jcaps, tval, free, enable, d_cap):
    pblobs = jm.pack_batch_blobs([pod], 1)
    want = np.asarray(preempt_feasible_jit(
        jm.to_blobs(), pblobs, jm.well_known(), jcaps, jnp.asarray(tval),
        jnp.asarray(free), enable, d_cap))
    tcb, tpb = _port_blobs(jm, pblobs)
    inp = convert.preempt_inputs_from_numpy(free=free, table_valid=tval,
                                            device="cpu")
    got = KP.preempt_feasible(tcb, tpb, jm.well_known(), port_caps(jcaps),
                              inp["table_valid"], inp["free"], enable,
                              d_cap).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    return want


def _golden_variants(jm, existing, rng):
    """(table mask, free override) pairs: nothing masked; every other
    existing pod masked with its node's free raised; every existing pod
    masked."""
    uids = [p.metadata.uid for p in existing]
    free = jm.free_matrix()
    raised = free.copy()
    raised[rng.integers(0, 4, size=2)] += 50.0
    return [(jm.table_valid_mask(()), free),
            (jm.table_valid_mask(uids[::2]), raised),
            (jm.table_valid_mask(uids), raised)]


GOLDEN = ([("spread", c[0]) for c in G.SPREAD_CASES]
          + [("interpod", c[0]) for c in G.AFFINITY_CASES])


@pytest.mark.parametrize("kind,name", GOLDEN,
                         ids=[f"{k}:{n}" for k, n in GOLDEN])
def test_feasible_twin_equals_jax_on_golden(kind, name):
    if kind == "spread":
        _, constraints, existing_map, want = next(
            c for c in G.SPREAD_CASES if c[0] == name)
        nodes = G._grid()
        existing = G._foo_pods(existing_map)
        pod = G._mkpod("p", labels={"foo": ""}, tsc=constraints)
    else:
        _, labels, aff, ex, want = next(
            c for c in G.AFFINITY_CASES if c[0] == name)
        nodes = G._grid()
        existing = [G._mkpod(f"e{i}", labels=lab, node=node)
                    for i, (node, lab) in enumerate(ex)]
        pod = G._mkpod("p", labels=labels, affinity=aff)
    jm = G._build(nodes, list(existing))
    rng = np.random.default_rng(len(name))
    for i, (tval, free) in enumerate(_golden_variants(jm, existing, rng)):
        for enable in (True, False):
            got = _feasible_pair(jm, pod, G.CAPS, tval, free, enable,
                                 jm.domain_bucket())
            if i == 0 and enable:
                # the unmasked dry run is the golden answer itself
                assert {n.metadata.name for n in nodes
                        if got[jm.row_of(n.metadata.name)]} == want


@pytest.mark.parametrize("seed", [3, 4])
def test_feasible_twin_equals_jax_on_topology_fuzz(seed):
    """64 nodes, a 200-pod table in 2 namespaces with required and
    preferred terms and spread constraints, 6 priority-10 specs mixing
    hard and soft terms; one nominated pod. Masks: every lower-priority
    pod, one node's pods, none; free raised on the masked rows; topology
    on and off; D = 8 and the domain bucket."""
    rng = random.Random(seed)
    nodes, bound, specs, namespaces = topology_fuzz(
        rng, 64, 200, 6, objects=jax_objects)
    jcaps = JCaps(nodes=64, pods=256, domains=64)
    (jm, _), _ = _mirrors(nodes, bound, jcaps, namespaces,
                          nominated={"node-7": [specs[0].clone()]})
    lower = [p.metadata.uid for p in bound]
    on_node3 = [p.metadata.uid for p in bound if p.spec.node_name == "node-3"]
    free = jm.free_matrix()
    raised = free.copy()
    raised[jm.row_of("node-3")] += 500.0
    n_false = 0
    for spec in specs:
        spec.spec.priority = 10
        for tval, fr in ((jm.table_valid_mask(lower), raised),
                         (jm.table_valid_mask(on_node3), raised),
                         (jm.table_valid_mask(()), free)):
            for enable, d_cap in ((True, 8), (True, jm.domain_bucket()),
                                  (False, 0)):
                got = _feasible_pair(jm, spec, jcaps, tval, fr, enable,
                                     d_cap)
                n_false += int((~got[:64]).sum())
    assert n_false > 0


# ------------------------------------------- the Scheduler, both packages


class _Side:
    """One package's Hub + Scheduler driven by a scenario script; the
    script's objects are JAX-package objects, handed to the port through
    to_port (uids, names and creation times preserved)."""

    def __init__(self, port: bool, batch=16, pipelined=None, seed=None,
                 caps=(16, 64)):
        self.port = port
        self.hub = THub() if port else JHub()
        self.clock = TP.Clock()
        self.sched = None
        self.batch, self.pipelined, self.seed = batch, pipelined, seed
        self.caps = caps
        self.snaps = []

    def obj(self, o):
        return to_port(o) if self.port else o

    def start(self):
        if self.sched is not None:
            return
        cfg = t_config() if self.port else j_config()
        cfg.batch_size = self.batch
        if self.pipelined is not None:
            cfg.pipelined_waves = self.pipelined
        if self.seed is not None:
            cfg.tie_break_seed = self.seed
        nodes, pods = self.caps
        if self.port:
            self.sched = TScheduler(self.hub, cfg,
                                    caps=TCaps(nodes=nodes, pods=pods),
                                    now=self.clock.now, device="cpu")
        else:
            self.sched = JScheduler(self.hub, cfg,
                                    caps=JCaps(nodes=nodes, pods=pods),
                                    now=self.clock.now)

    def step(self, op, arg):
        if op == "node":
            self.hub.create_node(self.obj(arg))
        elif op == "pod":
            self.hub.create_pod(self.obj(arg))
        elif op == "pdb":
            self.hub.create_pdb(self.obj(arg))
        elif op == "sched":
            self.start()
        elif op == "run":
            self.start()
            self.sched.run_until_idle()
        elif op == "drain":
            self.start()
            for _ in range(arg):
                self.sched.run_until_idle()
                self.clock.tick(3.0)
                self.sched.queue.flush_backoff_completed()
            self.sched.run_until_idle()
        elif op == "snap":
            self.snaps.append(self.state(arg))

    def state(self, names):
        out = {}
        for name in names:
            p = next((q for q in self.hub.list_pods()
                      if q.metadata.name == name), None)
            out[name] = (None if p is None else
                         (p.spec.node_name, p.status.nominated_node_name))
        return out


def _run_both(script, **kw):
    names = [a.metadata.name for op, a in script if op == "pod"]
    sides = []
    base = uid_base()
    for port in (False, True):
        start_uids(port, base)
        side = _Side(port, **kw)
        try:
            for op, arg in script:
                side.step(op, names if op == "snap" else arg)
            side.snaps.append(side.state(names))
            side.preemptions = side.sched.stats.get("preemptions", 0)
        finally:
            if side.sched is not None:
                side.sched.close()
        sides.append(side)
    return sides


def _anti_red():
    return Affinity(pod_anti_affinity=PodAntiAffinity(required=[
        PodAffinityTerm(topology_key=LABEL_HOSTNAME,
                        label_selector=LabelSelector(
                            match_labels={"app": "red"}))]))


def _with_aff(pod, aff):
    pod.spec.affinity = aff
    return pod


def _bound(pod, node):
    pod.spec.node_name = node
    return pod


def _pdb():
    return PodDisruptionBudget(
        metadata=ObjectMeta(name="pdb"),
        selector=LabelSelector(match_labels={"app": "guarded"}),
        disruptions_allowed=0)


def _memhog(i):
    return Pod(metadata=ObjectMeta(name=f"memhog-{i}"),
               spec=PodSpec(containers=[Container(
                   name="c", resources=ResourceRequirements(
                       requests={"memory": "8Gi"}))], priority=50))


def _scenarios():
    n, p = TP.mknode, TP.mkpod
    s = {}
    s["basic"] = (
        [("sched", None), ("node", n(0, cpu="2")), ("node", n(1, cpu="2"))]
        + [("pod", p(f"low-{i}", cpu="1")) for i in range(4)]
        + [("drain", 6), ("pod", p("high", cpu="1500m", priority=100)),
           ("drain", 6)], 1)
    s["equal_priority"] = (
        [("sched", None), ("node", n(0, cpu="2")),
         ("pod", p("incumbent", cpu="2", priority=100)), ("drain", 6),
         ("pod", p("challenger", cpu="1", priority=100)), ("drain", 6)], 0)
    s["policy_never"] = (
        [("sched", None), ("node", n(0, cpu="2")),
         ("pod", p("low", cpu="2")), ("drain", 6),
         ("pod", p("never", cpu="1", priority=100, policy="Never")),
         ("drain", 6)], 0)
    s["minimal_victims"] = (
        [("sched", None), ("node", n(0, cpu="2")),
         ("pod", p("p1", cpu="1", priority=1)),
         ("pod", p("p5", cpu="1", priority=5)), ("drain", 6),
         ("pod", p("high", cpu="1", priority=100)), ("drain", 6)], 1)
    s["pdb_steering"] = (
        [("sched", None), ("node", n(0, cpu="2")), ("node", n(1, cpu="2")),
         ("pod", p("a", cpu="2", labels={"app": "guarded"})),
         ("pod", p("b", cpu="2", labels={"app": "free"})), ("drain", 6),
         ("pdb", _pdb()), ("pod", p("high", cpu="1", priority=100)),
         ("drain", 6)], 1)
    s["nominated_reservation"] = (
        [("sched", None), ("node", n(0, cpu="2")),
         ("pod", p("low", cpu="2")), ("drain", 6),
         ("pod", p("high", cpu="2", priority=100)), ("run", None),
         ("snap", None), ("pod", p("opportunist", cpu="2")),
         ("drain", 6)], 1)
    s["anti_affinity_blocked"] = (
        [("sched", None), ("node", n(0, cpu="8")),
         ("pod", p("blocker", cpu="100m", labels={"app": "red"})),
         ("drain", 6),
         ("pod", _with_aff(p("high", cpu="100m", priority=100),
                           _anti_red())), ("drain", 6)], 1)
    s["anti_affinity_unresolvable"] = (
        [("sched", None), ("node", n(0, cpu="8")),
         ("pod", p("blocker", cpu="100m", priority=200,
                   labels={"app": "red"})),
         ("pod", p("filler", cpu="100m")), ("drain", 6),
         ("pod", _with_aff(p("high", cpu="100m", priority=100),
                           _anti_red())), ("drain", 6)], 0)
    s["pdb_reprieve"] = (
        [("sched", None), ("node", n(0, cpu="2")),
         ("pod", p("protected", cpu="1", labels={"app": "guarded"})),
         ("pod", p("plain", cpu="1")), ("pdb", _pdb()), ("drain", 6),
         ("pod", p("high", cpu="1", priority=100)), ("drain", 6)], 1)
    s["async_gate"] = (
        [("sched", None), ("node", n(0, cpu="2"))]
        + [("pod", p(f"low-{i}", cpu="1")) for i in range(2)]
        + [("drain", 6), ("pod", p("high", cpu="2", priority=100)),
           ("drain", 6)], 1)
    # the full PostFilter path with several preemptors in one failure
    # batch: each node holds an app=red pod, four preemptors repel it;
    # nominations made earlier in the batch are not visible to the later
    # preemptors' dry runs, so two may pick one node (the chip's Path B)
    s["anti_affinity_burst"] = (
        [("sched", None)] + [("node", n(i, cpu="4")) for i in range(8)]
        + [("pod", _bound(p(f"red-{i}", cpu="100m", labels={"app": "red"}),
                          f"node-{i}")) for i in range(8)]
        + [("drain", 1)]
        + [("pod", _with_aff(p(f"pre-{i}", cpu="100m", priority=10),
                             _anti_red())) for i in range(4)]
        + [("drain", 6)], 4)
    cpu_hungry = Pod(metadata=ObjectMeta(name="cpu-hungry"),
                     spec=PodSpec(containers=[Container(
                         name="c", resources=ResourceRequirements(
                             requests={"cpu": "2", "memory": "8Gi"}))],
                         priority=60))
    s["inactive_column"] = (
        [("node", n(0, cpu="4")),
         ("pod", p("cpu-hog", cpu="3500m", priority=100))]
        + [("pod", _memhog(i)) for i in range(3)]
        + [("sched", None), ("drain", 2), ("pod", cpu_hungry),
           ("drain", 3)], 0)
    return s


SCENARIOS = _scenarios()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_preemption_scenario_matches_jax(name):
    script, want_preemptions = SCENARIOS[name]
    j, t = _run_both(script)
    assert t.snaps == j.snaps, f"{name}: port {t.snaps} != jax {j.snaps}"
    assert t.preemptions == j.preemptions == want_preemptions
    assert not t.sched.preemption.preempting


def test_preemptor_rides_next_wave_matches_jax():
    """test_pipelined_waves.py:310's shape, pipelining on (batch 16,
    nodes 16, pods 64, tie_break_seed 7): the flushed preemptor binds in
    the same drain in both packages."""
    n, p = TP.mknode, TP.mkpod
    script = ([("sched", None), ("node", n(0, cpu="2")),
               ("node", n(1, cpu="2"))]
              + [("pod", p(f"low-{i}", cpu="1")) for i in range(4)]
              + [("run", None), ("pod", p("high", cpu="1500m",
                                          priority=100)),
                 ("run", None)])
    j, t = _run_both(script, pipelined=True, seed=7)
    assert t.snaps == j.snaps
    assert t.preemptions == j.preemptions == 1
    assert j.snaps[-1]["high"][0] in ("node-0", "node-1")



def _postfilter_script():
    """test_reduced_postfilter_path_matches_jax's script: its JAX-package
    objects, in the order it draws their uids."""
    spread = jax_objects.TopologySpreadConstraint(
        max_skew=1, topology_key=LABEL_HOSTNAME,
        when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels={"app": "blue"}))
    script = [("node", JW._node(i)) for i in range(300)]
    script += [("pod", _bound(JW._pod(f"red-{i}", labels={"app": "red"}),
                              f"node-{i}")) for i in range(300)]
    script += [("sched", None)]
    script += [("pod", JW._pod(
        f"pre-{i}", priority=10, affinity=_anti_red(),
        labels={"app": "blue"} if i % 8 == 0 else None,
        tsc=[spread] if i % 8 == 0 else None)) for i in range(16)]
    script += [("drain", 8)]
    return script


def test_reduced_postfilter_path_matches_jax():
    """chip_smoke.py's PostFilter path (phase 13b) in small: 300 nodes of
    node-default.yaml, each holding one app=red pod, then 16 preemptors
    with a required hostname anti-affinity term against app=red, every
    eighth also with a DoNotSchedule hostname spread constraint over its
    own app=blue label. Both packages bind every preemptor on the same
    nodes and evict the same red pods; and in both, preemptors of one
    failure batch collide: they bind on fewer distinct nodes than there
    are preemptors, each of those nodes losing its one red pod."""
    j, t = _run_both(_postfilter_script(), batch=256, caps=(512, 512))
    assert t.snaps == j.snaps
    assert t.preemptions == j.preemptions
    end = j.snaps[-1]
    pre_nodes = [end[f"pre-{i}"][0] for i in range(16)]
    gone = {f"node-{i}" for i in range(300) if end[f"red-{i}"] is None}
    assert all(pre_nodes)
    assert len(set(pre_nodes)) < 16
    assert gone == set(pre_nodes)
    assert end["pre-0"][0] != end["pre-8"][0]


# ------------------------------------------------------------ the harness


def _small(w):
    w.node_capacity = 64
    w.pod_capacity = 256
    w.batch_size = 16
    return w


def test_preemption_async_tiny_evicts_and_schedules():
    from kubernetes_tpu_torch.perf.harness import run_workload
    from kubernetes_tpu_torch.perf.workloads import preemption_async

    w = _small(preemption_async(init_nodes=2, init_pods=8, measure_pods=4))
    r = run_workload(w, device="cpu")
    assert r["pods_scheduled"] == 4


def test_preemption_async_enabled_variant_tiny():
    from kubernetes_tpu_torch.perf.harness import run_workload
    from kubernetes_tpu_torch.perf.workloads import preemption_async_enabled

    w = _small(preemption_async_enabled(init_nodes=2, init_pods=8,
                                        measure_pods=4))
    assert w.feature_gates == {"SchedulerAsyncPreemption": True}
    r = run_workload(w, device="cpu")
    assert r["pods_scheduled"] == 4


def test_churn_injects_by_clock():
    from kubernetes_tpu_torch.perf.harness import (
        Churn,
        CreateNodes,
        CreatePods,
        Workload,
        run_workload,
    )
    from kubernetes_tpu_torch.perf.workloads import _node, _pod

    t = [1000.0]

    def sleep(dt):
        t[0] += dt

    w = _small(Workload(name="churn-test", threshold=1, ops=[
        CreateNodes(2, _node),
        Churn([lambda i: _pod(f"c{i}")], interval_ms=100),
        CreatePods(5, lambda i: _pod(f"m-{i}"), collect_metrics=True)]))
    r = run_workload(w, now=lambda: t[0], sleep=sleep, device="cpu")
    assert r["pods_scheduled"] == 5
    assert r["churn_created"] >= 1
    assert r["stats"]["attempts"] >= 5


def test_node_churn_injects_through_node_lifecycle(monkeypatch):
    """A node template's churn goes through the scenario engine's
    NodeLifecycle: recreate mode adds each copy and removes the previous
    one by name."""
    from kubernetes_tpu_torch.hub import Hub
    from kubernetes_tpu_torch.perf import harness as H
    from kubernetes_tpu_torch.perf.workloads import _churn_node
    from kubernetes_tpu_torch.scenario.lifecycle import NodeLifecycle

    calls = []

    class Recording(NodeLifecycle):
        def add(self, node):
            calls.append(("add", node.metadata.name))
            return super().add(node)

        def remove(self, name):
            calls.append(("remove", name))
            return super().remove(name)

    monkeypatch.setattr(H, "NodeLifecycle", Recording)
    hub = Hub()
    st = H._ChurnState(H.Churn([_churn_node], interval_ms=1000,
                               mode="recreate"), now=lambda: 0.0)
    st.inject(hub, 0.0)
    st.inject(hub, 1.0)
    assert calls == [("add", "churn-node-100000-0"),
                     ("remove", "churn-node-100000-0"),
                     ("add", "churn-node-100001-1")]
    assert [n.metadata.name for n in hub.list_nodes()] == \
        ["churn-node-100001-1"]


def _reduced_mixed_churn(port: bool, monkeypatch) -> tuple[dict, dict]:
    """SchedulingWithMixedChurn at 50 nodes and 300 measured pods (bucket
    64, batch 16) on a deterministic clock. The churn's own clock is the
    drain's pump count (one object every fourth pump, in both harnesses),
    so both inject at the same points of the drain."""
    if port:
        from kubernetes_tpu_torch.perf import harness as H
        from kubernetes_tpu_torch.perf import workloads as W
    else:
        from kubernetes_tpu.perf import harness as H
        from kubernetes_tpu.perf import workloads as W
    real_inject = H._ChurnState.inject

    def inject(self, hub, t):
        self.pumps = getattr(self, "pumps", 0) + 1
        return real_inject(self, hub, self.t0 + self.pumps * 0.25)

    monkeypatch.setattr(H._ChurnState, "inject", inject)
    w = _small(W.mixed_churn(init_nodes=50, measure_pods=300))
    w.pod_capacity = 512
    tick = itertools.count()
    clock = dict(now=lambda: 1000.0 + next(tick) * 1e-6,
                 sleep=lambda dt: None)
    seen = {}
    real = H.Scheduler

    def capture(*a, **kw):
        seen["s"] = real(*a, **kw)
        return seen["s"]

    monkeypatch.setattr(H, "Scheduler", capture)
    r = H.run_workload(w, **({"device": "cpu"} if port else {}), **clock)
    monkeypatch.undo()
    return ({p.metadata.name: p.spec.node_name
             for p in seen["s"].hub.list_pods()}, r)


def test_reduced_mixed_churn_matches_jax_harness(monkeypatch):
    want, jr = _reduced_mixed_churn(False, monkeypatch)
    got, tr = _reduced_mixed_churn(True, monkeypatch)
    assert got == want
    assert tr["pods_scheduled"] == jr["pods_scheduled"] == 300
    assert tr["churn_created"] >= 4
    # the churn nodes took pods, and the 9-CPU pods never fit
    assert any(n and n.startswith("churn-node-") for n in got.values())
    assert not any(v for k, v in got.items() if k.startswith("churn-big-"))
    st = tr["stats"]
    assert st["chain_patches"] > 0 and st["chain_patch_fallbacks"] == 0
    for k in ("chain_patches", "chain_patch_rows", "chain_patch_fallbacks"):
        assert st[k] == jr["stats"][k], k
    assert tr["threshold"] == 1500 and tr["vs_baseline"] == round(
        tr["pods_per_sec"] / 265, 2)


def _reduced_preemption_drain(port: bool) -> tuple[dict, int]:
    """20 nodes of 4 CPUs full of 900m fillers, then 5 priority-10 pods
    of 3000m (each must evict 3 fillers) in place of the wall-clock
    churn, then 20 measured pods; deterministic clock."""
    if port:
        from kubernetes_tpu_torch.perf import harness as H
        from kubernetes_tpu_torch.perf import workloads as W
    else:
        from kubernetes_tpu.perf import harness as H
        from kubernetes_tpu.perf import workloads as W
    w = _small(H.Workload(name="PreemptionAsync/20Nodes", threshold=1, ops=[
        H.CreateNodes(20, W._node),
        H.CreatePods(80, W._low_priority_pod),
        H.CreatePods(5, W._high_priority_pod),
        H.CreatePods(20, lambda i: W._pod(f"measure-{i}"),
                     collect_metrics=True)]))
    tick = itertools.count()
    clock = dict(now=lambda: 1000.0 + next(tick) * 1e-3,
                 sleep=lambda dt: None)
    if port:
        end = {}
        r = H.run_workload(w, device="cpu", on_scheduler=lambda s, hub:
                           end.update({p.metadata.name: p.spec.node_name
                                       for p in hub.list_pods()}), **clock)
        return end, r["stats"]["preemptions"]
    # the JAX harness has no end-state hook: read the hub through the
    # Scheduler it builds
    seen = {}
    real = H.Scheduler

    def capture(*a, **kw):
        seen["s"] = real(*a, **kw)
        return seen["s"]

    H.Scheduler = capture
    try:
        r = H.run_workload(w, **clock)
    finally:
        H.Scheduler = real
    return ({p.metadata.name: p.spec.node_name
             for p in seen["s"].hub.list_pods()},
            r["stats"]["preemptions"])


def test_reduced_preemption_drain_matches_jax_harness():
    want, j_pre = _reduced_preemption_drain(False)
    got, t_pre = _reduced_preemption_drain(True)
    assert got == want
    assert t_pre == j_pre == 5
    assert sum(1 for k in want if k.startswith("low-")) == 80 - 15
    assert all(want.values())
