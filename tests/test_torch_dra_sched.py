"""DRA through the port's Scheduler against the JAX package's, on the CPU:
every scenario of tests/test_dra.py and tests/test_dra_structured.py and
the Scheduler case of tests/test_dra_fuzz.py, built from the reference's
test objects (carried across with ``to_port``) for both packages on the
same deterministic clock, plus a Scheduler-level differential over the
tests/test_dra_fuzz.py scenarios. Each case asserts identical bindings,
claim allocations (node, devices, reservedFor), the parked pods'
host_reject_counts, the device allocator's routed / host-fallback counts
and the scheduler's counts — the two restart cases included — plus the
reference test's own assertions on the port's side.

The JAX side runs with the port's one stated DRA deviation applied to
its Scheduler instance (torch_port_support.apply_vanished_retry: a pod
that loses a same-batch device race at Reserve retries after backoff);
where no such race happens the patch changes nothing.
tests/test_torch_dra_workloads.py shows the unpatched reference stall
that the deviation removes.

No tolerance: every compared output is a name, an integer or a bool."""

import pytest

from kubernetes_tpu.api.objects import (
    ALLOCATION_MODE_ALL,
    DeviceClass,
    DeviceConstraint,
    DeviceRequest,
    DeviceSelector,
    DeviceSubRequest,
    Node,
    NodeStatus,
    ObjectMeta,
    ResourceClaim,
    ResourceClaimSpec,
    ResourceClaimTemplate,
)
from kubernetes_tpu.config.types import Plugin as JPlugin
from kubernetes_tpu.config.types import SchedulerProfile as JProfile
from kubernetes_tpu.config.types import default_config as j_config
from kubernetes_tpu.config.types import default_plugins as j_plugins
from kubernetes_tpu.hub import Hub as JHub
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu.plugins.dra import ResourceClaimController as JRCC
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.config.types import Plugin as TPlugin
from kubernetes_tpu_torch.config.types import SchedulerProfile as TProfile
from kubernetes_tpu_torch.config.types import default_config as t_config
from kubernetes_tpu_torch.config.types import default_plugins as t_plugins
from kubernetes_tpu_torch.hub import Hub as THub
from kubernetes_tpu_torch.ops.features import Capacities as TCaps
from kubernetes_tpu_torch.plugins.dra import ResourceClaimController as TRCC
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from tests import test_dra as D
from tests import test_dra_structured as S
from tests.test_dra_fuzz import _scenario
from tests.torch_port_support import (
    apply_vanished_retry,
    start_uids,
    to_port,
    uid_base,
)

pytestmark = pytest.mark.torch_port


class Side:
    """One package's Hub + Scheduler over the reference's test objects, on
    a clock the test advances."""

    def __init__(self, port: bool, controller: bool = False,
                 batch: int = 16, second_profile: bool = False,
                 no_dra: bool = False):
        self.port = port
        self.conv = to_port if port else (lambda o: o)
        self.t = [1000.0]
        self.hub = THub() if port else JHub()
        if controller:
            (TRCC if port else JRCC)(self.hub)
        self.batch = batch
        self.second_profile = second_profile
        self.no_dra = no_dra
        self.sched = self.new_scheduler()

    def now(self) -> float:
        return self.t[0]

    def new_scheduler(self):
        cfg = t_config() if self.port else j_config()
        cfg.batch_size = self.batch
        if self.second_profile:
            prof, plugins = ((TProfile, t_plugins) if self.port
                             else (JProfile, j_plugins))
            cfg.profiles.append(prof(scheduler_name="second",
                                     plugins=plugins()))
        if self.no_dra:
            plugin = TPlugin if self.port else JPlugin
            cfg.profiles[0].plugins.multi_point.disabled.append(
                plugin(name="DynamicResources"))
        if self.port:
            return TScheduler(self.hub, cfg, caps=TCaps(nodes=16, pods=64),
                              now=self.now, device="cpu")
        return apply_vanished_retry(JScheduler(
            self.hub, cfg, caps=JCaps(nodes=16, pods=64), now=self.now))

    def restart(self) -> None:
        self.sched.close()
        self.sched = self.new_scheduler()

    def create(self, obj):
        verb = {"Node": "create_node", "Pod": "create_pod",
                "ResourceSlice": "create_resource_slice",
                "ResourceClaim": "create_resource_claim",
                "ResourceClaimTemplate": "create_resource_claim_template",
                "DeviceClass": "create_device_class"}[type(obj).__name__]
        getattr(self.hub, verb)(self.conv(obj))
        return obj

    def run(self) -> None:
        self.sched.run_until_idle()

    def settle(self, rounds: int = 4, step: float = 3.0) -> None:
        for _ in range(rounds):
            self.sched.run_until_idle()
            self.t[0] += step
            self.sched.queue.flush_backoff_completed()
        self.sched.run_until_idle()

    def bound(self, pod) -> str:
        return self.hub.get_pod(pod.metadata.uid).spec.node_name

    def claim(self, name):
        return self.hub.get_resource_claim("default", name)

    def outcome(self) -> dict:
        # each side builds its own objects: compare pods by name
        names = {p.metadata.uid: p.metadata.name
                 for p in self.hub.list_pods()}
        claims = {}
        for c in self.hub.list_resource_claims():
            a = c.status.allocation
            claims[c.metadata.name] = (
                None if a is None else (
                    a.node_name,
                    tuple((d.request, d.driver, d.pool, d.device,
                           d.admin_access) for d in a.devices)),
                tuple(names.get(u, "deleted") for u in c.status.reserved_for))
        q = self.sched.queue
        parked = {qp.pod.metadata.name: dict(qp.host_reject_counts)
                  for qp in list(q._unschedulable.values())
                  + q._backoff.list()}
        st = self.sched.stats
        return {"bound": {p.metadata.name: p.spec.node_name
                          for p in self.hub.list_pods()},
                "claims": claims, "parked": parked,
                "dra": dict(self.sched._dra.device_view.stats),
                "counts": (st["scheduled"], st["unschedulable"],
                           st["errors"])}


def both(fn, **kw):
    """Run ``fn(side)`` on the reference and on the port; returns (JAX
    outcome, port outcome, port side)."""
    out = []
    sides = []
    base = uid_base()
    for port in (False, True):
        start_uids(port, base)
        side = Side(port, **kw)
        try:
            fn(side)
            out.append(side.outcome())
        finally:
            side.sched.close()
        sides.append(side)
    assert out[0] == out[1]
    return out[0], out[1], sides[1]


# ------------------------------------------------ tests/test_dra.py


def test_claim_backed_pod_schedules_on_device_node():
    def fn(s):
        s.create(D.mknode("plain"))
        s.create(D.mknode("accel"))
        s.create(D.mkslice("accel", 4))
        s.create(D.mkclaim("c1"))
        s.pod = s.create(D.mkpod("p", claim="c1"))
        s.run()

    _, out, s = both(fn)
    assert out["bound"]["p"] == "accel"
    alloc = s.claim("c1").status.allocation
    assert alloc.node_name == "accel" and alloc.devices[0].device == "dev-0"
    assert out["dra"]["device_pods"] >= 1


def test_missing_claim_unresolvable():
    def fn(s):
        s.create(D.mknode("n"))
        s.pod = s.create(D.mkpod("p", claim="nope"))
        s.run()

    _, out, s = both(fn)
    assert out["bound"]["p"] == ""
    msg = s.hub.get_pod(s.pod.metadata.uid).status.conditions[0].message
    assert "DynamicResources" in msg


def test_device_exhaustion_spreads_then_rejects():
    def fn(s):
        s.create(D.mknode("a"))
        s.create(D.mknode("b"))
        s.create(D.mkslice("a", 1))
        s.create(D.mkslice("b", 1))
        for i in range(3):
            s.create(D.mkclaim(f"c{i}"))
            s.create(D.mkpod(f"p{i}", claim=f"c{i}"))
        s.run()

    _, out, _s = both(fn)
    assert sorted(n for n in out["bound"].values() if n) == ["a", "b"]
    # the loser lost the same-batch race at Reserve ("devices vanished")
    loser = [p for p, n in out["bound"].items() if not n]
    assert len(loser) == 1 and loser[0] in out["parked"]


def test_multi_device_claim():
    def fn(s):
        s.create(D.mknode("small"))
        s.create(D.mknode("big"))
        s.create(D.mkslice("small", 1))
        s.create(D.mkslice("big", 4))
        s.create(D.mkclaim("c2", count=2))
        s.create(D.mkpod("p", claim="c2"))
        s.run()

    _, out, _s = both(fn)
    assert out["bound"]["p"] == "big"
    assert len(out["claims"]["c2"][0][1]) == 2


def test_allocation_survives_restart_replay():
    def fn(s):
        s.create(D.mknode("a"))
        s.create(D.mknode("b"))
        s.create(D.mkslice("a", 1))
        s.create(D.mkslice("b", 1))
        s.create(D.mkclaim("c1"))
        s.create(D.mkpod("p1", claim="c1"))
        s.run()
        s.restart()
        s.create(D.mkclaim("c2"))
        s.create(D.mkpod("p2", claim="c2"))
        s.run()

    _, out, _s = both(fn)
    b = out["bound"]
    assert {b["p1"], b["p2"]} == {"a", "b"}
    assert out["claims"]["c1"][0][0] == b["p1"]
    assert out["claims"]["c2"][0][0] == b["p2"]


def test_preallocated_claim_pins_pod_after_restart():
    def fn(s):
        s.create(D.mknode("a"))
        s.create(D.mknode("b"))
        s.create(D.mkslice("a", 2))
        s.create(D.mkslice("b", 2))
        s.create(D.mkclaim("c1"))
        p1 = s.create(D.mkpod("p1", claim="c1"))
        s.run()
        s.node1 = s.bound(p1)
        s.sched.close()
        s.hub.delete_pod(p1.metadata.uid)
        assert s.claim("c1").status.allocation is not None
        s.sched = s.new_scheduler()
        s.create(D.mkpod("p2", claim="c1"))
        s.run()

    _, out, s = both(fn)
    assert out["bound"]["p2"] == s.node1
    assert out["claims"]["c1"][0][0] == s.node1


def test_claim_deletion_frees_devices_pod_deletion_does_not():
    def fn(s):
        s.create(D.mknode("a"))
        s.create(D.mkslice("a", 1))
        s.create(D.mkclaim("c1"))
        s.create(D.mkclaim("c2"))
        p1 = s.create(D.mkpod("p1", claim="c1"))
        p2 = s.create(D.mkpod("p2", claim="c2"))
        s.run()
        first = p1 if s.bound(p1) else p2
        second = p2 if first is p1 else p1
        s.second = second.metadata.name
        held = s.claim("c1" if first is p1 else "c2")
        s.hub.delete_pod(first.metadata.uid)
        held = s.claim(held.metadata.name)
        assert held.status.reserved_for == []
        assert held.status.allocation is not None
        s.settle(rounds=2, step=1.2)
        assert s.bound(second) == ""
        s.hub.delete_resource_claim(held.metadata.uid)
        s.settle(rounds=8, step=2.0)

    _, out, s = both(fn)
    assert out["bound"][s.second] == "a"


def test_dra_shared_across_profiles_no_double_booking():
    def fn(s):
        s.create(D.mknode("n1"))
        s.create(D.mkslice("n1", 1))
        s.create(D.mkclaim("c-a"))
        s.create(D.mkclaim("c-b"))
        insts = {id(fw.instance("DynamicResources"))
                 for fw in s.sched.frameworks.values()}
        assert len(insts) == 1
        s.create(D.mkpod("pod-a", claim="c-a"))
        pb = D.mkpod("pod-b", claim="c-b")
        pb.spec.scheduler_name = "second"
        s.create(pb)
        s.run()

    _, out, _s = both(fn, batch=8, second_profile=True)
    assert sum(1 for n in out["bound"].values() if n) == 1
    assert sum(1 for a, _r in out["claims"].values() if a) == 1
    assert out["counts"][2] == 0


# ------------------------------------- tests/test_dra_structured.py


def test_claim_template_materializes_and_schedules():
    def fn(s):
        s.create(S.mknode("accel"))
        s.create(S.mkslice("accel", [S.mkdevice(f"d{i}", cls="test-class")
                                     for i in range(2)]))
        s.create(ResourceClaimTemplate(
            metadata=ObjectMeta(name="test-claim-template"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="req-0", device_class_name="test-class")])))
        s.pod = s.create(S.mkpod("pod-a",
                                 template_name="test-claim-template"))
        s.run()
        s.statuses = s.hub.get_pod(
            s.pod.metadata.uid).status.resource_claim_statuses

    _, out, s = both(fn, controller=True)
    assert out["bound"]["pod-a"] == "accel"
    assert out["claims"]["pod-a-resource"][0][0] == "accel"
    assert s.statuses == {"resource": "pod-a-resource"}


def _sel_claim(name, expr, cls="test-class"):
    return ResourceClaim(
        metadata=ObjectMeta(name=name),
        spec=ResourceClaimSpec(device_requests=[DeviceRequest(
            name="req-0", device_class_name=cls,
            selectors=[DeviceSelector(cel_expression=expr)])]))


def test_cel_selector_picks_matching_devices_only():
    def fn(s):
        s.create(S.mknode("n1"))
        s.create(S.mknode("n2"))
        s.create(S.mkslice("n1", [
            S.mkdevice("small", cls="test-class", preallocate=True,
                       capacity={"counters": "1"}),
            S.mkdevice("nopre", cls="test-class", preallocate=False,
                       capacity={"counters": "4"})]))
        s.create(S.mkslice("n2", [
            S.mkdevice("good", cls="test-class", preallocate=True,
                       capacity={"counters": "2"})]))
        expr = (f"device.capacity['{S.DRIVER}'].counters"
                ".compareTo(quantity('2')) >= 0 && "
                f"device.attributes['{S.DRIVER}'].preallocate")
        s.create(_sel_claim("sel-claim", expr))
        s.create(S.mkpod("p", claim_name="sel-claim"))
        s.run()

    _, out, _s = both(fn)
    assert out["bound"]["p"] == "n2"
    assert [d[3] for d in out["claims"]["sel-claim"][0][1]] == ["good"]


def test_device_class_cel_selectors():
    def fn(s):
        s.create(S.mknode("n1"))
        s.create(S.mknode("n2"))
        s.create(DeviceClass(
            metadata=ObjectMeta(name="test-class"),
            selectors=[DeviceSelector(
                cel_expression=f'device.driver == "{S.DRIVER}"')]))
        s.create(S.mkslice("n1", [S.mkdevice("other")],
                           driver="other-driver"))
        s.create(S.mkslice("n2", [S.mkdevice("mine")]))
        s.create(ResourceClaim(
            metadata=ObjectMeta(name="c"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="req-0", device_class_name="test-class")])))
        s.create(S.mkpod("p", claim_name="c"))
        s.run()

    _, out, _s = both(fn)
    assert out["bound"]["p"] == "n2"


def test_allocation_mode_all():
    def fn(s):
        s.create(S.mknode("n1"))
        s.create(S.mkslice("n1", [S.mkdevice(f"d{i}", cls="test-class")
                                  for i in range(3)]))
        s.create(ResourceClaim(
            metadata=ObjectMeta(name="all-claim"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="req-0", device_class_name="test-class",
                allocation_mode=ALLOCATION_MODE_ALL)])))
        s.create(S.mkpod("p", claim_name="all-claim"))
        s.run()
        s.create(ResourceClaim(
            metadata=ObjectMeta(name="late"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="r", device_class_name="test-class")])))
        s.create(S.mkpod("p2", claim_name="late"))
        s.run()

    _, out, _s = both(fn)
    assert out["bound"]["p"] == "n1" and out["bound"]["p2"] == ""
    assert sorted(d[3] for d in out["claims"]["all-claim"][0][1]) == [
        "d0", "d1", "d2"]


def test_first_available_prioritized_list():
    def fn(s):
        s.create(S.mknode("n1"))
        s.create(S.mkslice("n1", [S.mkdevice("d0", cls="test-class")]))
        s.create(ResourceClaim(
            metadata=ObjectMeta(name="fa"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="req-0", first_available=[
                    DeviceSubRequest(name="sub-0",
                                     device_class_name="no-such-class"),
                    DeviceSubRequest(name="sub-1",
                                     device_class_name="test-class")])])))
        s.create(S.mkpod("p", claim_name="fa"))
        s.run()

    _, out, _s = both(fn)
    assert out["bound"]["p"] == "n1"
    assert out["claims"]["fa"][0][1][0][0] == "req-0/sub-1"
    assert out["dra"]["host_fallback_pods"] >= 1


def _pair_claim(name, constraint_attr, first_available=False):
    if first_available:
        req = DeviceRequest(name="req-0", first_available=[
            DeviceSubRequest(name="sub-0", device_class_name="no-such-class",
                             count=2),
            DeviceSubRequest(name="sub-1", device_class_name="test-class",
                             count=2)])
    else:
        req = DeviceRequest(name="req-0", device_class_name="test-class",
                            count=2)
    return ResourceClaim(
        metadata=ObjectMeta(name=name),
        spec=ResourceClaimSpec(
            device_requests=[req],
            constraints=[DeviceConstraint(
                requests=["req-0"], match_attribute=constraint_attr)]))


def test_match_attribute_constraint():
    def fn(s):
        s.create(S.mknode("n1"))
        s.create(S.mknode("n2"))
        s.create(S.mkslice("n1", [
            S.mkdevice("a", cls="test-class", **{"dra.example.com/slice": 1}),
            S.mkdevice("b", cls="test-class",
                       **{"dra.example.com/slice": 2})]))
        s.create(S.mkslice("n2", [
            S.mkdevice("c", cls="test-class", **{"dra.example.com/slice": 3}),
            S.mkdevice("d", cls="test-class",
                       **{"dra.example.com/slice": 3})]))
        s.create(_pair_claim("pair", "dra.example.com/slice"))
        s.create(S.mkpod("p", claim_name="pair"))
        s.run()

    _, out, _s = both(fn)
    assert out["bound"]["p"] == "n2"
    assert sorted(d[3] for d in out["claims"]["pair"][0][1]) == ["c", "d"]


@pytest.mark.parametrize("first_available", [False, True])
def test_match_attribute_anchor_backtracking(first_available):
    """...anchor_backtracking, and (first_available) ...
    constraint_binds_first_available_subrequests."""
    def fn(s):
        s.create(S.mknode("n1"))
        s.create(S.mkslice("n1", [
            S.mkdevice("a", cls="test-class", numa="A"),
            S.mkdevice("b1", cls="test-class", numa="B"),
            S.mkdevice("b2", cls="test-class", numa="B")]))
        s.create(_pair_claim("pair", "numa", first_available))
        s.create(S.mkpod("p", claim_name="pair"))
        s.run()

    _, out, _s = both(fn)
    assert out["bound"]["p"] == "n1"
    assert sorted(d[3] for d in out["claims"]["pair"][0][1]) == ["b1", "b2"]


def test_template_created_after_pod_still_materializes():
    def fn(s):
        s.create(S.mknode("accel"))
        s.create(S.mkslice("accel", [S.mkdevice("d0", cls="test-class")]))
        s.create(S.mkpod("late", template_name="late-template"))
        s.run()
        assert s.outcome()["bound"]["late"] == ""
        s.create(ResourceClaimTemplate(
            metadata=ObjectMeta(name="late-template"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="req-0", device_class_name="test-class")])))
        s.settle()

    _, out, _s = both(fn, controller=True)
    assert out["bound"]["late"] == "accel"


def test_admin_access_ignores_and_leaves_in_use():
    def fn(s):
        s.create(S.mknode("n1"))
        s.create(S.mkslice("n1", [S.mkdevice("d0", cls="test-class")]))
        s.create(ResourceClaim(
            metadata=ObjectMeta(name="admin"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="monitor", device_class_name="test-class",
                admin_access=True)])))
        s.create(ResourceClaim(
            metadata=ObjectMeta(name="normal"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="use", device_class_name="test-class")])))
        s.create(S.mkpod("pa", claim_name="admin"))
        s.create(S.mkpod("pb", claim_name="normal"))
        s.run()

    _, out, _s = both(fn)
    assert out["bound"] == {"pa": "n1", "pb": "n1"}
    assert out["claims"]["admin"][0][1][0][4] is True


def test_ledger_tracks_claim_lifecycle():
    def fn(s):
        plugin = s.sched.framework.instance("DynamicResources")
        s.create(S.mknode("n1"))
        s.create(S.mkslice("n1", [S.mkdevice("d0", cls="test-class")]))
        s.create(ResourceClaim(
            metadata=ObjectMeta(name="c1"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="r", device_class_name="test-class")])))
        s.create(S.mkpod("p1", claim_name="c1"))
        s.run()
        assert (S.DRIVER, "n1", "d0") in plugin._in_use_view(set())
        s.create(ResourceClaim(
            metadata=ObjectMeta(name="c2"),
            spec=ResourceClaimSpec(device_requests=[DeviceRequest(
                name="r", device_class_name="test-class")])))
        s.create(S.mkpod("p2", claim_name="c2"))
        s.run()
        s.hub.delete_resource_claim(s.claim("c1").metadata.uid)
        assert (S.DRIVER, "n1", "d0") not in plugin._in_use_view(set())
        s.settle()

    _, out, _s = both(fn)
    assert out["bound"] == {"p1": "n1", "p2": "n1"}


# ---------------------------------------- tests/test_dra_fuzz.py


def test_profile_with_dra_disabled_skips_device_allocator():
    def fn(s):
        assert s.sched._profile_cfg[s.sched._profile_name][
            "dra_filter"] is False
        s.create(D.mknode("bare"))
        s.create(D.mkclaim("c1"))
        s.create(D.mkpod("p", claim="c1"))
        s.run()

    _, out, _s = both(fn, batch=8, no_dra=True)
    assert out["bound"]["p"] == "bare"
    assert out["dra"]["device_pods"] == 0


def _fuzz_node(name):
    return Node(metadata=ObjectMeta(name=name),
                status=NodeStatus(allocatable={"cpu": "16",
                                               "memory": "32Gi",
                                               "pods": "110"}))


@pytest.mark.parametrize("seeds", [range(0, 12), range(12, 24)])
def test_fuzz_scenarios_schedule_as_the_reference(seeds):
    """The tests/test_dra_fuzz.py scenarios (device classes, slices,
    blocker claims, expressible and inexpressible claims, pinned
    pre-allocations) scheduled end to end by both Schedulers."""
    for seed in seeds:
        jhub, _plugin, node_names, pods = _scenario(seed)

        def fn(s):
            for dc in jhub.list_device_classes():
                s.create(dc)
            for sl in jhub.list_resource_slices():
                s.create(sl)
            for c in sorted(jhub.list_resource_claims(),
                            key=lambda c: c.metadata.resource_version):
                s.create(c)
            for n in node_names:
                s.create(_fuzz_node(n))
            for p, _e in pods:
                s.create(p)
            s.settle(rounds=2)

        both(fn)


# ------------------------------------------------------ binder_drain


def test_bind_wait_is_timed_as_binder_drain_not_commit():
    """The loop thread's waits on the binder pool (here: claim pods, whose
    DRA build drains the binds first, on a slow binder) land in
    stats["time_s"]["binder_drain"], not in commit."""
    import time

    hub = THub()
    real_bind = hub.bind

    def slow_bind(pod, node):
        time.sleep(0.05)
        real_bind(pod, node)

    hub.bind = slow_bind
    cfg = t_config()
    cfg.batch_size = 4
    cfg.binding_workers = 1
    sched = TScheduler(hub, cfg, caps=TCaps(nodes=16, pods=64),
                       device="cpu")
    try:
        assert "binder_drain" in sched.stats["time_s"]
        for i in range(2):
            hub.create_node(to_port(D.mknode(f"n{i}")))
            hub.create_resource_slice(to_port(D.mkslice(f"n{i}", 8)))
        for i in range(8):
            hub.create_resource_claim(to_port(D.mkclaim(f"c{i}")))
            hub.create_pod(to_port(D.mkpod(f"p{i}", claim=f"c{i}")))
        sched.run_until_idle()
        assert all(p.spec.node_name for p in hub.list_pods())
        t = sched.stats["time_s"]
        # 8 binds of 50 ms on one worker: the loop waits ~0.4 s for them
        assert t["binder_drain"] >= 0.3, t
        assert t["commit"] < t["binder_drain"] / 2, t
    finally:
        sched.close()


def test_drains_run_with_the_collector_off():
    """run_until_idle keeps CPython's collector off (utils/gcguard.py, as
    the reference does): with thresholds so low that every allocation
    burst would trigger one, no full (generation-2) collection starts
    inside a drain, and the collector is on again after it."""
    import gc

    full = []

    def record(phase, info):
        if phase == "start" and info["generation"] == 2:
            full.append(info)

    def drain(s):
        s.create(D.mknode("n0"))
        s.create(D.mkslice("n0", 8))
        for i in range(6):
            s.create(D.mkclaim(f"c{i}"))
            s.create(D.mkpod(f"p{i}", claim=f"c{i}"))
        seen = []
        gc.callbacks.append(record)
        try:
            s.sched.run_until_idle(on_step=lambda: seen.append(
                gc.isenabled()))
        finally:
            gc.callbacks.remove(record)
        assert seen and not any(seen)

    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        side = Side(True)
        try:
            drain(side)
        finally:
            side.sched.close()
    finally:
        gc.set_threshold(*old)
    assert gc.isenabled()
    assert not full, f"{len(full)} full collections inside the drain"
    assert all(side.bound(p) for p in side.hub.list_pods())
