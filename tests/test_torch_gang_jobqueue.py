"""The port's JobQueue (a copy of the JAX package's backend/jobqueue.py)
against the reference, on the reference's JobQueue cases of
tests/test_gang.py and tests/test_gang_device.py: each case drives both
packages' queues with the same pods and groups (carried across with
``to_port``) and records every release (the pod names, in order), the
tenants' stats and the DRR state; the two traces must be identical. The
PodGroup's wire round trip and the port's hub store are checked too."""

import pytest

import kubernetes_tpu.backend.jobqueue as JJ
import kubernetes_tpu.plugins.gang as JGang
import kubernetes_tpu_torch.backend.jobqueue as TJ
import kubernetes_tpu_torch.plugins.gang as TGang
from kubernetes_tpu.testing import MakePod
from tests.test_gang import FakePQ, group, tenant_pod
from tests.torch_port_support import to_port

pytestmark = pytest.mark.torch_port


class Q:
    """One package's queue + a recording release sink."""

    def __init__(self, port: bool, tenants=None, bound_fn=None):
        self.conv = to_port if port else (lambda o: o)
        mod = TJ if port else JJ
        kw = {} if bound_fn is None else {"bound_fn": bound_fn}
        self.jq = mod.JobQueue(tenants, **kw)
        self.trace: list = []
        self.pq = FakePQ()

    def add(self, pod):
        self.jq.add(self.conv(pod))

    def group(self, g):
        self.jq.set_group(self.conv(g))

    def release(self, budget):
        before = len(self.pq.pods)
        n = self.jq.release(self.pq, budget=budget)
        self.trace.append((n, [p.metadata.name
                               for p in self.pq.pods[before:]]))
        return n

    def remove(self, name):
        pod = next(p for p in self.pq.pods if p.metadata.name == name)
        self.jq.remove(pod)

    def state(self):
        t = {name: (round(x.deficit, 9), round(x.backfill_debt, 9), x.idle)
             for name, x in self.jq._tenants.items()}
        return (self.trace, self.jq.tenant_stats(), t,
                self.jq.pending_count())


def _drr(q):
    for i in range(40):
        q.add(tenant_pod(f"a-{i}", "a"))
        q.add(tenant_pod(f"b-{i}", "b"))
    q.release(30)


def _quota(q):
    for i in range(5):
        q.add(tenant_pod(f"g-{i}", "greedy"))
        q.add(tenant_pod(f"f-{i}", "free"))
    q.release(64)
    q.remove(next(p.metadata.name for p in q.pq.pods
                  if p.metadata.name.startswith("g-")))
    q.release(64)


def _cpu_quota(q):
    q.add(tenant_pod("big", "a", cpu="900m"))
    q.add(tenant_pod("small", "a", cpu="100m"))
    q.release(8)
    q.add(tenant_pod("third", "a", cpu="100m"))
    q.release(8)
    q.remove("big")
    q.release(8)


def _gang_gating(q):
    q.add(tenant_pod("g-0", "a", gang="job1"))
    q.add(tenant_pod("g-1", "a", gang="job1"))
    q.release(8)
    q.group(group("job1", 3, queue="a"))
    q.release(8)
    q.add(tenant_pod("g-2", "a", gang="job1"))
    q.release(8)


def _atomic_over_budget(q):
    q.group(group("big", 4, queue="a"))
    for i in range(4):
        q.add(tenant_pod(f"b-{i}", "a", gang="big"))
    for _ in range(6):
        q.release(2)


def _assembling_no_block(q):
    q.group(group("stuck", 5, queue="a"))
    q.add(tenant_pod("stuck-0", "a", gang="stuck"))
    q.add(tenant_pod("single", "a"))
    q.release(8)


def _group_delete(q):
    q.group(group("j", 2, queue="a"))
    q.add(tenant_pod("j-0", "a", gang="j"))
    q.add(tenant_pod("j-1", "a", gang="j"))
    q.jq.remove_group("default/j")
    q.release(8)
    q.group(group("j", 2, queue="a"))
    q.release(8)


def _quota_blocked_once(q):
    q.add(tenant_pod("p0", "a"))
    q.add(tenant_pod("p1", "a"))
    q.release(64)
    q.release(64)
    q.add(tenant_pod("p2", "a"))
    q.release(64)


def _no_banked_credit(q):
    q.add(tenant_pod("b-keep", "burst"))
    q.release(8)
    for i in range(30):
        q.add(tenant_pod(f"b-{i}", "burst"))
        q.add(tenant_pod(f"s-{i}", "steady"))
    for _ in range(50):
        q.release(4)


def _gang_not_starved(q):
    q.group(group("g8", 8, queue="a"))
    for i in range(8):
        q.add(tenant_pod(f"g-{i}", "a", gang="g8"))
    for cycle in range(20):
        q.add(tenant_pod(f"s-{cycle}", "a"))
        q.add(tenant_pod(f"b-{cycle}", "b"))
        q.release(4)


def _bound_before_group(q):
    p = MakePod().name("old-0").req(cpu="100m").obj()
    p.metadata.labels["scheduling.k8s.io/pod-group"] = "j"
    p.spec.node_name = "n0"
    p = q.conv(p)
    q.jq.note_bound(p)
    q.trace.append(dict(q.jq.tenant_stats()))
    q.jq.set_group(q.conv(group("j", 2, queue="team")))
    q.trace.append(q.jq.was_admitted(p.metadata.uid))
    q.jq.remove(p)


def _group_queue_authoritative(q):
    q.group(group("j", 4, queue="a"))
    for i, tenant in enumerate(["a", "a", "b", "b"]):
        q.add(tenant_pod(f"j-{i}", tenant, gang="j"))
    q.release(8)


def _group_queue_change(q):
    q.group(group("j", 4, queue="a"))
    q.add(tenant_pod("j-0", "a", gang="j"))
    q.add(tenant_pod("j-1", "a", gang="j"))
    q.group(group("j", 4, queue="b"))
    q.add(tenant_pod("j-2", "b", gang="j"))
    q.add(tenant_pod("j-3", "b", gang="j"))
    q.release(8)


def _backfill(q):
    q.group(group("g8", 8, queue="a"))
    for i in range(8):
        q.add(tenant_pod(f"g-{i}", "a", gang="g8"))
    for i in range(4):
        q.add(tenant_pod(f"s-{i}", "a"))
        q.add(tenant_pod(f"b-{i}", "b"))
    q.release(4)
    for _ in range(12):
        q.release(16)


def _ff_idle(q):
    q.add(tenant_pod("b-keep", "blocked"))
    q.release(8)
    for i in range(6):
        q.add(tenant_pod(f"b-{i}", "blocked"))
    q.group(group("g8", 8, queue="gangs"))
    for i in range(8):
        q.add(tenant_pod(f"g-{i}", "gangs", gang="g8"))
    for _ in range(6):
        q.release(8)


def _overdraw(q):
    q.group(group("g20", 20, queue="a"))
    for i in range(20):
        q.add(tenant_pod(f"g-{i}", "a", gang="g20"))
    for i in range(3):
        q.add(tenant_pod(f"s-{i}", "a"))
        q.add(tenant_pod(f"b-{i}", "b"))
    for _ in range(8):
        q.release(32)


def _debt_repaid(q):
    q.group(group("g6", 6, queue="a"))
    for i in range(6):
        q.add(tenant_pod(f"g-{i}", "a", gang="g6"))
    for i in range(20):
        q.add(tenant_pod(f"s-{i}", "a"))
        q.add(tenant_pod(f"b-{i}", "b"))
    q.release(4)
    for _ in range(20):
        q.release(8)


AB = {"a": {"weight": 1.0}, "b": {"weight": 1.0}}
CASES = {
    "drr_weighted": (_drr, {"a": {"weight": 2.0}, "b": {"weight": 1.0}}),
    "quota_pods": (_quota, {"greedy": {"quota": {"pods": "2"}},
                            "free": {}}),
    "quota_cpu": (_cpu_quota, {"a": {"quota": {"cpu": "1"}}}),
    "gang_gating": (_gang_gating, None),
    "gang_atomic_over_budget": (_atomic_over_budget, None),
    "assembling_gang_no_block": (_assembling_no_block, None),
    "group_delete": (_group_delete, None),
    "quota_blocked_once": (_quota_blocked_once,
                           {"a": {"quota": {"pods": "1"}}}),
    "no_banked_credit": (_no_banked_credit,
                         {"burst": {"weight": 1.0,
                                    "quota": {"pods": "1"}},
                          "steady": {"weight": 1.0}}),
    "gang_not_starved": (_gang_not_starved, AB),
    "bound_before_group": (_bound_before_group,
                           {"team": {"quota": {"pods": "4"}}}),
    "group_queue_authoritative": (_group_queue_authoritative, None),
    "group_queue_change": (_group_queue_change, None),
    "singles_backfill": (_backfill, AB),
    "ff_idle_tenant": (_ff_idle, {"blocked": {"quota": {"pods": "1"}},
                                  "gangs": {"weight": 1.0}}),
    "gang_overdraw": (_overdraw, AB),
    "backfill_debt_repaid": (_debt_repaid, AB),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_jobqueue_release_order_matches_jax(name):
    fn, tenants = CASES[name]
    traces = []
    for port in (False, True):
        q = Q(port, tenants)
        fn(q)
        traces.append(q.state())
    assert traces[1] == traces[0]
    assert traces[1][0], "the case released or recorded something"


def test_jobqueue_reads_bound_members_from_the_gang_registry():
    """test_gang.py:300's half-bound gang: 2 queued + 2 bound members
    satisfy min_member=4 through the coordinator's registry."""
    out = []
    for port, gmod in ((False, JGang), (True, TGang)):
        conv = to_port if port else (lambda o: o)
        g = gmod.GangScheduling()
        g.set_group(conv(group("j", 4, queue="a")))
        q = Q(port, bound_fn=g.bound_count)
        q.group(group("j", 4, queue="a"))
        for i in range(2):
            old = tenant_pod(f"old-{i}", "a", gang="j")
            old.spec.node_name = f"n{i}"
            g.note_bound(conv(old))
        q.add(tenant_pod("tail-0", "a", gang="j"))
        q.add(tenant_pod("tail-1", "a", gang="j"))
        q.release(8)
        out.append(q.state())
    assert out[1] == out[0] and out[1][0][0][0] == 2


def test_pod_group_store_and_watch():
    """The port's hub keeps PodGroups by namespace/name and delivers them
    to a watcher; the object is the reference's, field for field."""
    from kubernetes_tpu_torch.hub import EventHandlers, Hub

    hub = Hub()
    seen = []
    hub.watch_pod_groups(EventHandlers(
        on_add=lambda g: seen.append(("add", g.key())),
        on_update=lambda o, n: seen.append(("update", n.min_member)),
        on_delete=lambda g: seen.append(("delete", g.key()))))
    g = to_port(group("j", 3, queue="team-x", timeout=12.5))
    hub.create_pod_group(g)
    assert hub.get_pod_group("default", "j") is g
    g2 = to_port(group("j", 5, queue="team-x"))
    g2.metadata.uid = g.metadata.uid
    hub.update_pod_group(g2)
    hub.delete_pod_group(g.metadata.uid)
    assert seen == [("add", "default/j"), ("update", 5),
                    ("delete", "default/j")]
    assert hub.get_pod_group("default", "j") is None
    ref = group("j", 3, queue="team-x", timeout=12.5)
    assert vars(to_port(ref)) .keys() == vars(ref).keys()
    assert to_port(ref).key() == ref.key() == "default/j"
