"""The four DRA drains (DRASteadyState, ...ClaimTemplates, ...CELIn,
DRAMultiRequest) reduced, through both packages' perf harness on the CPU
on one simulated clock: identical bindings and claim allocations, every
measured pod bound, no device double-booked, every allocated device
accepted by its request's selector. The JAX side runs with the port's
stated DRA deviation applied to its Scheduler instance
(torch_port_support.apply_vanished_retry); the last test shows the
unpatched reference stalling on the claim-template drain, where the port
binds every pod.

No tolerance: every compared output is a name, an integer or a bool."""

import pytest

import kubernetes_tpu.perf.harness as JH
from kubernetes_tpu.perf import workloads as JW
from kubernetes_tpu_torch.perf import harness as TH
from kubernetes_tpu_torch.perf import workloads as TW
from kubernetes_tpu_torch.utils.cel import CelDevice, evaluate
from tests.torch_port_support import apply_vanished_retry

pytestmark = pytest.mark.torch_port

DRA = ("dra_steady_state", "dra_steady_state_templates",
       "dra_steady_state_cel_in", "dra_multi_request")


class Clock:
    def __init__(self):
        self.t = 1000.0

    def now(self) -> float:
        self.t += 1e-4
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _outcome(hub) -> dict:
    claims = {}
    for c in hub.list_resource_claims():
        a = c.status.allocation
        claims[c.metadata.name] = None if a is None else (
            a.node_name, tuple((d.driver, d.pool, d.device)
                               for d in a.devices))
    return {"bound": {p.metadata.name: p.spec.node_name
                      for p in hub.list_pods()}, "claims": claims}


def _check_allocations(hub) -> None:
    """Every pod bound where its claim's devices are; no device booked
    twice; every device accepted by its request's selector."""
    devices = {}
    for sl in hub.list_resource_slices():
        for d in sl.devices:
            devices[(sl.driver, sl.pool, d.name)] = d
    seen = set()
    for c in hub.list_resource_claims():
        a = c.status.allocation
        assert a is not None, c.metadata.name
        reqs = {r.name: r for r in c.spec.device_requests}
        for d in a.devices:
            key = (d.driver, d.pool, d.device)
            assert key not in seen, key
            seen.add(key)
            dev = devices[key]
            req = reqs[d.request]
            if req.device_class_name:
                assert dev.device_class_name == req.device_class_name
            for sel in req.selectors:
                assert evaluate(sel.cel_expression, CelDevice(
                    d.driver, dev.attributes, dev.capacity))
    for p in hub.list_pods():
        assert p.spec.node_name, p.metadata.name


def _run_jax(name: str, scale: float, monkeypatch, deviation=True,
             timeout_s=None):
    got = []

    class Sched(JH.Scheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if deviation:
                apply_vanished_retry(self)
            got.append(self)

    monkeypatch.setattr(JH, "Scheduler", Sched)
    w = getattr(JW, name)()
    if timeout_s is not None:
        for op in w.ops:
            if isinstance(op, JH.CreatePods):
                op.timeout_s = timeout_s
    clock = Clock()
    try:
        r = JH.run_workload(w, now=clock.now, sleep=clock.sleep,
                            scale=scale)
    except JH.WorkloadStuck:
        return None, got[0].hub
    return r, got[0].hub


def _run_port(name: str, scale: float):
    hubs = []
    clock = Clock()
    r = TH.run_workload(getattr(TW, name)(), now=clock.now,
                        sleep=clock.sleep, scale=scale, device="cpu",
                        on_scheduler=lambda s, h: hubs.append(h))
    return r, hubs[0]


@pytest.mark.parametrize("name", DRA)
def test_dra_workload_reduced_matches_the_reference(name, monkeypatch):
    jr, jhub = _run_jax(name, 0.1, monkeypatch)
    tr, thub = _run_port(name, 0.1)
    assert _outcome(jhub) == _outcome(thub)
    _check_allocations(thub)
    assert jr["stats"]["scheduled"] == tr["stats"]["scheduled"]
    assert jr["stats"]["unschedulable"] == tr["stats"]["unschedulable"]
    assert tr["stats"]["launches"] >= 1


def test_unpatched_reference_stalls_where_the_port_retries(monkeypatch):
    """The stated deviation: on the claim-template drain the auction puts
    more claim pods on a node than it has free devices; the losers fail
    Reserve ("devices vanished"). The reference parks them where no event
    wakes them and the drain times out; the port retries them after
    backoff and binds every pod."""
    jr, jhub = _run_jax("dra_steady_state_templates", 0.1, monkeypatch,
                        deviation=False, timeout_s=30.0)
    assert jr is None
    stuck = [p for p in jhub.list_pods() if not p.spec.node_name]
    assert stuck
    tr, thub = _run_port("dra_steady_state_templates", 0.1)
    _check_allocations(thub)
    assert tr["stats"]["unschedulable"] >= len(stuck)
