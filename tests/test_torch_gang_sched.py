"""Gangs and tenant job queues in the port's Scheduler against the JAX
package's, on the CPU: the scenarios of tests/test_gang_device.py and
tests/test_gang.py built as the same hub objects for both packages (the
JAX package's objects, carried across with ``to_port``), on the same
deterministic clock. Each case asserts identical bindings (and, where it
applies, evictions, per-tenant admissions and the gang coordinator's
counts), plus the reference's own invariant: all-or-nothing gangs, no
leaked reservation.

No tolerance: every compared output is a name, an integer or a bool."""

import random

import pytest

from kubernetes_tpu.api.objects import (
    LABEL_POD_GROUP,
    LABEL_ZONE,
    LabelSelector,
    ObjectMeta,
    PodDisruptionBudget,
)
from kubernetes_tpu.config.types import default_config as j_config
from kubernetes_tpu.hub import Hub as JHub
from kubernetes_tpu.ops import gang as JG
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.testing import MakeNode, MakePod
from kubernetes_tpu_torch.config.types import default_config as t_config
from kubernetes_tpu_torch.hub import Hub as THub
from kubernetes_tpu_torch.kernels import gang as KG
from kubernetes_tpu_torch.ops.features import Capacities as TCaps
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from tests.test_gang import group as tgroup
from tests.test_gang import tenant_pod
from tests.test_gang_device import Clock, gang_pod, group
from tests.torch_port_support import start_uids, to_port, uid_base

pytestmark = pytest.mark.torch_port


class Side:
    """One package's Hub + Scheduler over the reference's test objects."""

    def __init__(self, port: bool, nodes: int, cpu: str, device=True,
                 zones=None, batch=64, caps=(16, 256)):
        self.port = port
        self.conv = to_port if port else (lambda o: o)
        self.clock = Clock()
        self.hub = THub() if port else JHub()
        for i in range(nodes):
            n = (MakeNode().name(f"n{i}")
                 .capacity(cpu=cpu, memory="8Gi", pods="110").obj())
            if zones is not None:
                n.metadata.labels[LABEL_ZONE] = zones[i % len(zones)]
            self.hub.create_node(self.conv(n))
        cfg = t_config() if port else j_config()
        cfg.batch_size = batch
        cfg.gang_device_packing = device
        if port:
            self.sched = TScheduler(self.hub, cfg, caps=TCaps(
                nodes=caps[0], pods=caps[1]), now=self.clock.now,
                device="cpu")
        else:
            self.sched = JScheduler(self.hub, cfg, caps=JCaps(
                nodes=caps[0], pods=caps[1]), now=self.clock.now)

    def create(self, obj):
        if obj.__class__.__name__ == "PodGroup":
            self.hub.create_pod_group(self.conv(obj))
        else:
            self.hub.create_pod(self.conv(obj))

    def bound(self) -> dict:
        return {p.metadata.name: p.spec.node_name
                for p in self.hub.list_pods()}

    def per_gang(self) -> dict:
        out: dict = {}
        for p in self.hub.list_pods():
            g = p.metadata.labels.get(LABEL_POD_GROUP)
            if g is not None:
                out[g] = out.get(g, 0) + bool(p.spec.node_name)
        return out

    def waiting(self) -> int:
        return sum(len(fw.waiting_pods)
                   for fw in self.sched.frameworks.values())

    def settle(self, waves: int = 4) -> None:
        """tests/test_gang_device.py:_settle on this side."""
        sched, clock = self.sched, self.clock

        def drain_waiters():
            for _ in range(4):
                clock.tick(7.0)
                sched.run_until_idle()
                if self.waiting() == 0 \
                        and sched.cache.assumed_pod_count() == 0:
                    return

        for _ in range(waves):
            drain_waiters()
            clock.tick(301.0)
            sched.queue.flush_backoff_completed()
            sched.queue.flush_unschedulable_timeout()
            sched.run_until_idle()
        drain_waiters()

    def reactivate(self) -> None:
        self.clock.tick(301.0)
        self.sched.queue.flush_backoff_completed()
        self.sched.queue.flush_unschedulable_timeout()
        self.sched.run_until_idle()

    def outcome(self) -> dict:
        g = self.sched._gang.stats
        return {"bound": self.bound(), "assumed":
                self.sched.cache.assumed_pod_count(),
                "waiting": self.waiting(),
                "admitted": g["admitted"],
                "device_admitted": g["device_admitted"],
                "rollbacks": g["rollbacks"], "timeouts": g["timeouts"],
                "launches": self.sched.stats["gang_device_launches"],
                "fallbacks": self.sched.stats["gang_fallbacks"]}


def both(fn, **kw) -> tuple[dict, dict]:
    out = []
    base = uid_base()
    for port in (False, True):
        start_uids(port, base)
        side = Side(port, **kw)
        try:
            out.append(fn(side))
        finally:
            side.sched.close()
    return out[0], out[1]


# ------------------------------------ tests/test_gang_device.py scenarios


def _one_launch(side):
    side.create(group("big", 12))
    for i in range(12):
        side.create(gang_pod(f"b-{i}", "big", cpu="900m"))
    side.sched.run_until_idle()
    return side.outcome()


def _infeasible(side):
    side.create(group("huge", 4))
    for i in range(4):
        side.create(gang_pod(f"x-{i}", "huge", cpu="900m"))
    side.sched.run_until_idle()
    return side.outcome()


def _topology_close(side):
    side.create(group("co", 8))
    for i in range(8):
        side.create(gang_pod(f"c-{i}", "co", cpu="900m"))
    side.sched.run_until_idle()
    return side.outcome()


def _rollback(side, point: str):
    """A member whose Reserve raises (or whose Permit is vetoed) rolls the
    whole unit back; after the fault clears the gang binds whole."""
    side.create(group("frag", 4))
    pods = [gang_pod(f"f-{i}", "frag", cpu="500m") for i in range(4)]
    for p in pods:
        side.create(p)
    victim_uid = pods[2 if point == "reserve" else 1].metadata.uid
    fw = side.sched.framework
    if point == "reserve":
        real = fw.run_reserve_plugins

        def failing(state, pod, node):
            if pod.metadata.uid == victim_uid:
                raise RuntimeError("reserve poison")
            return real(state, pod, node)

        fw.run_reserve_plugins = failing
    else:
        real = fw.run_permit_plugins

        def failing(state, pod, node):
            if pod.metadata.uid == victim_uid:
                if side.port:
                    from kubernetes_tpu_torch.framework.interface import (
                        Status,
                    )
                else:
                    from kubernetes_tpu.framework.interface import Status
                return Status.unschedulable("quota veto",
                                            plugin="ExtraPermit"), 0.0
            return real(state, pod, node)

        fw.run_permit_plugins = failing
    side.sched.run_until_idle()
    first = side.outcome()
    if point == "reserve":
        fw.run_reserve_plugins = real
    else:
        fw.run_permit_plugins = real
    side.reactivate()
    return first, side.outcome()


def _quorum_subset(side):
    side.create(group("sub", 2, timeout=8.0))
    for i in range(4):
        side.create(gang_pod(f"s-{i}", "sub", cpu="900m"))
    side.sched.run_until_idle()
    side.settle(waves=2)
    return side.outcome()


def _chunk_fault(side):
    """More than GANG_PACK_BUCKET units with a fault in the SECOND
    chunk's launch: chunk 1 commits on the device, the rest takes the
    Permit path; every gang lands exactly once."""
    n_units = side.sched.GANG_PACK_BUCKET + 2
    for g in range(n_units):
        side.create(group(f"ch-{g}", 2))
    for g in range(n_units):
        for m in range(2):
            side.create(gang_pod(f"ch-{g}-m{m}", f"ch-{g}", cpu="100m"))
    mod, attr = (KG, "pack_gangs") if side.port else (JG, "pack_gangs_jit")
    real = getattr(mod, attr)
    calls = []

    def second_chunk_boom(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("chunk 2 fault")
        return real(*a, **kw)

    setattr(mod, attr, second_chunk_boom)
    try:
        side.sched.run_until_idle()
    finally:
        setattr(mod, attr, real)
    out = side.outcome()
    out["device_fallbacks"] = side.sched.stats["device_fallbacks"]
    return out


def _prefilter_bound(side):
    """The host-path capacity bound rides the cycle's pull: after a
    settle the memo holds the bound and PreFilter rejects from it."""
    side.create(group("cap", 4, timeout=5.0))
    for i in range(4):
        side.create(gang_pod(f"q-{i}", "cap", cpu="900m"))
    side.sched.run_until_idle()
    gang = side.sched._gang
    seeded = gang._cap_cache.get("default/cap") is not None
    side.settle(waves=1)
    pod = next(iter(side.hub.list_pods()))
    gang.pre_filter(None, pod, None)
    for ckey, ctok, arr in gang.take_pending_caps():
        gang.resolve_cap(ckey, ctok, int(arr))
    s = gang.pre_filter(None, pod, None)
    out = side.outcome()
    out.update(seeded=seeded, rejected=s.is_rejected(), msg=s.message())
    return out


SCENARIOS = {
    "one_launch_per_wave": (_one_launch, dict(nodes=4, cpu="4")),
    "infeasible_parks": (_infeasible, dict(nodes=2, cpu="1")),
    "topology_close": (_topology_close, dict(
        nodes=6, cpu="4", zones=["z0", "z0", "z1", "z1", "z2", "z2"])),
    "reserve_rollback": (lambda s: _rollback(s, "reserve"),
                         dict(nodes=4, cpu="4")),
    "permit_rollback": (lambda s: _rollback(s, "permit"),
                        dict(nodes=4, cpu="4")),
    "quorum_subset": (_quorum_subset, dict(nodes=2, cpu="1")),
    "chunk_fault": (_chunk_fault, dict(nodes=10, cpu="4", batch=256)),
    "prefilter_bound": (_prefilter_bound, dict(nodes=2, cpu="1",
                                               device=False)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gang_device_scenario_matches_jax(name):
    fn, kw = SCENARIOS[name]
    want, got = both(fn, **kw)
    assert got == want
    outs = got if isinstance(got, tuple) else (got,)
    for out in outs:
        assert out["assumed"] == 0 and out["waiting"] == 0
    if name == "one_launch_per_wave":
        assert got["launches"] == 1 and len(
            [v for v in got["bound"].values() if v]) == 12
    if name in ("reserve_rollback", "permit_rollback"):
        first, after = got
        assert not any(first["bound"].values()) and first["rollbacks"] >= 1
        assert all(after["bound"].values())
    if name == "chunk_fault":
        assert all(got["bound"].values()) and got["device_fallbacks"] == 1
    if name == "prefilter_bound":
        assert got["seeded"] and got["rejected"]
        assert "capacity bound 2" in got["msg"]


def _differential(side, seed: int):
    """tests/test_gang_device.py:_run_arm's scenario."""
    rng = random.Random(seed)
    nodes = rng.randint(3, 8)
    node_cpu = rng.choice(["1", "2", "4"])
    member_cpu = rng.choice(["500m", "900m", "1100m"])
    per_node = int(node_cpu) * 1000 // int(member_cpu[:-1])
    capacity = nodes * per_node
    sizes, left = [], capacity
    for _ in range(rng.randint(1, 3)):
        if left <= 0:
            break
        s = rng.randint(1, min(6, left))
        sizes.append(s)
        left -= s
    if rng.random() < 0.5:
        sizes.append(capacity + rng.randint(1, 4))
    rng.shuffle(sizes)
    for g, size in enumerate(sizes):
        side.create(group(f"g{g}", size, timeout=6.0))
    for g, size in enumerate(sizes):
        for m in range(size):
            side.create(gang_pod(f"g{g}-m{m}", f"g{g}", cpu=member_cpu))
    side.sched.run_until_idle()
    side.settle()
    out = side.outcome()
    out["per_gang"] = side.per_gang()
    out["sizes"] = sizes
    out["capacity"] = capacity
    return out


def _diff_nodes(seed):
    rng = random.Random(seed)
    nodes = rng.randint(3, 8)
    return nodes, rng.choice(["1", "2", "4"])


@pytest.mark.parametrize("device", [True, False], ids=["device", "permit"])
@pytest.mark.parametrize("seed", range(8))
def test_differential_arms_match_jax(seed, device):
    """The reference's differential scenario: per arm (device packer, or
    Permit quorum only), both packages bind the same pods; every gang is
    whole or absent, standalone-infeasible gangs bind nothing."""
    nodes, cpu = _diff_nodes(seed)
    want, got = both(lambda s: _differential(s, seed), nodes=nodes,
                     cpu=cpu, device=device)
    assert got == want
    for g, size in enumerate(got["sizes"]):
        want_n = 0 if size > got["capacity"] else size
        assert got["per_gang"][f"g{g}"] == want_n
    assert got["assumed"] == 0


def _contended(side, seed: int):
    """tests/test_gang_device.py:test_contended_gangs_atomic_in_both_arms:
    sizes past capacity; which gang wins is order-dependent, so it must
    be the same gang in both packages."""
    rng = random.Random(seed)
    rng.randint(2, 5)
    sizes = [rng.randint(2, 6) for _ in range(3)]
    for g, size in enumerate(sizes):
        side.create(group(f"g{g}", size, timeout=6.0))
    for g, size in enumerate(sizes):
        for m in range(size):
            side.create(gang_pod(f"g{g}-m{m}", f"g{g}", cpu="900m"))
    side.sched.run_until_idle()
    side.settle(waves=3)
    out = side.outcome()
    out["per_gang"] = side.per_gang()
    out["sizes"] = sizes
    return out


@pytest.mark.parametrize("device", [True, False], ids=["device", "permit"])
@pytest.mark.parametrize("seed", (101, 102, 103))
def test_contended_gangs_match_jax(seed, device):
    nodes = random.Random(seed).randint(2, 5)
    want, got = both(lambda s: _contended(s, seed), nodes=nodes, cpu="2",
                     device=device)
    assert got == want
    assert sum(got["per_gang"].values()) <= nodes * 2
    for g, size in enumerate(got["sizes"]):
        assert got["per_gang"][f"g{g}"] in (0, size)


# ------------------------------------------- tests/test_gang.py scenarios


def _binds_together(side):
    side.create(tgroup("job", 3, queue="t"))
    for i in range(3):
        side.create(tenant_pod(f"m-{i}", "t", gang="job"))
    side.sched.run_until_idle()
    return side.outcome()


def _permit_timeout(side):
    """min_member=3 with 2 members force-fed past the job queue: both
    reserve and WAIT; the gang timeout rolls every reservation back."""
    side.create(tgroup("half", 3, queue="t", timeout=5.0))
    side.create(tenant_pod("h-0", "t", gang="half"))
    side.create(tenant_pod("h-1", "t", gang="half"))
    sched = side.sched
    sched.jobqueue.release(sched.queue, 16)
    for uid, (_, _key) in list(sched.jobqueue._where.items()):
        pod = side.hub.get_pod(uid)
        sched.jobqueue.remove(pod)
        sched.queue.add(pod)
    sched.run_until_idle()
    mid = (side.waiting(), sched.cache.assumed_pod_count())
    side.clock.tick(6.0)
    sched.run_until_idle()
    out = side.outcome()
    out["mid"] = mid
    out["assembling"] = len(sched._gang._assembling)
    return out


def _prefilter_rejects(side):
    side.create(tgroup("huge", 4, queue="t"))
    for i in range(4):
        side.create(tenant_pod(f"x-{i}", "t", gang="huge", cpu="900m"))
    side.sched.run_until_idle()
    return side.outcome()


SCHED_CASES = {
    "binds_together": (_binds_together, dict(nodes=4, cpu="2", batch=16,
                                              caps=(16, 128))),
    "permit_timeout": (_permit_timeout, dict(nodes=4, cpu="2", batch=16,
                                             caps=(16, 128))),
    "prefilter_rejects": (_prefilter_rejects, dict(
        nodes=2, cpu="1", batch=16, caps=(16, 128))),
}


@pytest.mark.parametrize("name", sorted(SCHED_CASES))
def test_gang_scenario_matches_jax(name):
    fn, kw = SCHED_CASES[name]
    want, got = both(fn, **kw)
    assert got == want
    assert got["assumed"] == 0 and got["waiting"] == 0
    if name == "binds_together":
        assert all(got["bound"].values()) and got["admitted"] >= 1
    if name == "permit_timeout":
        assert got["mid"] == (2, 2)
        assert not any(got["bound"].values())
        assert got["rollbacks"] >= 1 and got["timeouts"] >= 1
        assert got["assembling"] == 0
    if name == "prefilter_rejects":
        assert not any(got["bound"].values())


# ------------------------------------------- whole-gang victim expansion


def _expansion(port: bool, pdb_budget: int | None):
    conv = to_port if port else (lambda o: o)
    if port:
        from kubernetes_tpu_torch.framework.preemption import Evaluator
    else:
        from kubernetes_tpu.framework.preemption import Evaluator
    hub = THub() if port else JHub()
    members = []
    for i in range(3):
        p = tenant_pod(f"v-{i}", "t", gang="lowjob")
        p.spec.node_name = f"n{i}"
        members.append(conv(p))
        hub.create_pod(members[-1])
    loner = MakePod().name("loner").req(cpu="100m").obj()
    loner.spec.node_name = "n0"
    hub.create_pod(conv(loner))
    if pdb_budget is not None:
        hub.create_pdb(conv(PodDisruptionBudget(
            metadata=ObjectMeta(name="pdb"),
            selector=LabelSelector(match_labels={LABEL_POD_GROUP: "lowjob"}),
            disruptions_allowed=pdb_budget)))
    ev = Evaluator(hub, lambda: None, lambda: None, lambda: [], None)
    pre = conv(MakePod().name("pre").req(cpu="100m").priority(10).obj())
    out = []
    vs, blocked = ev._expand_gang_victims([members[0]], pre)
    out.append((sorted(p.metadata.name for p in vs), blocked))
    out.append(ev._expand_gang_victims([hub.get_pod(loner.metadata.uid)],
                                       pre)[1])
    if pdb_budget is None:
        # a co-member that outranks the preemptor blocks the WHOLE gang
        high = hub.get_pod(members[2].metadata.uid).clone()
        high.spec.priority = 100
        hub.update_pod(high)
        vs, blocked = ev._expand_gang_victims(
            [hub.get_pod(members[0].metadata.uid)], pre)
        out.append((sorted(p.metadata.name for p in vs), blocked))
    return out


@pytest.mark.parametrize("pdb_budget", [None, 1, 3],
                         ids=["priority_guard", "exhausted_pdb",
                              "pdb_with_room"])
def test_gang_victim_expansion_matches_jax(pdb_budget):
    want = _expansion(False, pdb_budget)
    got = _expansion(True, pdb_budget)
    assert got == want
    names, blocked = got[0]
    if pdb_budget == 1:
        assert "exhausted PDB" in blocked and names == ["v-0"]
    else:
        assert not blocked and names == ["v-0", "v-1", "v-2"]
    if pdb_budget is None:
        assert "outranks" in got[2][1] and got[2][0] == ["v-0"]
