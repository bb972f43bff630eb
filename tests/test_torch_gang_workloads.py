"""The four gang workloads of the JAX package, reduced through their own
``rescale`` hooks, through both packages' perf harnesses on the CPU and a
deterministic clock: identical bindings (evicted pods included: they are
gone from both hubs), per-tenant admissions and gang counts.
GangTopologyPacking's ``validate`` hook (mean zone spans <= 1.5) holds in
both. The storm also runs with ``gang_device_packing=False`` (every gang
through the Permit wait room) and must bind the same pods there too."""

import itertools

import pytest

import tests.torch_port_support  # noqa: F401 — caps torch's threads

pytestmark = pytest.mark.torch_port


def _run(port: bool, fn: str, scale: float, device_packing=True):
    if port:
        from kubernetes_tpu_torch.config.types import default_config
        from kubernetes_tpu_torch.perf import harness as H
        from kubernetes_tpu_torch.perf import workloads as W
    else:
        from kubernetes_tpu.config.types import default_config
        from kubernetes_tpu.perf import harness as H
        from kubernetes_tpu.perf import workloads as W
    cfg = default_config()
    cfg.gang_device_packing = device_packing
    tick = itertools.count()
    clock = dict(now=lambda: 1000.0 + next(tick) * 1e-3,
                 sleep=lambda dt: None)
    seen = {}
    real = H.Scheduler

    def capture(*a, **kw):
        seen["s"] = real(*a, **kw)
        return seen["s"]

    # both harnesses build their Scheduler through the module global;
    # capturing it reads the end state the same way for both
    H.Scheduler = capture
    try:
        r = H.run_workload(getattr(W, fn)(), scale=scale, config=cfg,
                           **({"device": "cpu"} if port else {}), **clock)
    finally:
        H.Scheduler = real
    bound = {p.metadata.name: p.spec.node_name
             for p in seen["s"].hub.list_pods()}
    tenants = {k: (v["admitted"], v.get("contended_admitted"))
               for k, v in r.get("tenants", {}).items()}
    return {"bound": bound, "tenants": tenants, "gangs": r.get("gangs"),
            "colocation": r.get("colocation"),
            "preemptions": r["stats"].get("preemptions", 0)}


@pytest.mark.parametrize("fn,scale,device_packing", [
    ("multi_tenant_gang_storm", 0.25, True),
    ("multi_tenant_gang_storm", 0.25, False),
    ("quota_exhaustion_churn", 0.05, True),
    ("gang_preemption", 0.1, True),
    ("gang_topology_packing", 1.0, True),
], ids=["storm", "storm_permit_path", "quota_churn", "gang_preemption",
        "topology_packing"])
def test_reduced_gang_workload_matches_jax(fn, scale, device_packing):
    want = _run(False, fn, scale, device_packing)
    got = _run(True, fn, scale, device_packing)
    assert got == want
    if fn == "multi_tenant_gang_storm":
        assert all(got["bound"].values()) and len(got["bound"]) == 252
    if fn == "quota_exhaustion_churn":
        # the burst tenant admits exactly its quota; the steady one all
        assert got["tenants"]["burst"][0] == 5
        assert got["tenants"]["steady"][0] == 100
    if fn == "gang_preemption":
        assert got["preemptions"] > 0
        high = [n for n in got["bound"] if n.startswith("high-")]
        assert high and all(got["bound"][n] for n in high)
        by_gang: dict = {}
        for n in got["bound"]:
            if n.startswith("low-"):
                g = n.rsplit("-m", 1)[0]
                by_gang[g] = by_gang.get(g, 0) + 1
        # every surviving low gang is whole (evictions took whole gangs)
        assert all(c == 4 for c in by_gang.values())
    if fn == "gang_topology_packing":
        assert got["colocation"]["mean_zone_spans"] <= 1.5


def test_gang_device_split_accounts_for_every_chunk():
    """The port's split of gang_device (stats["gang_split_s"]): one chunk
    per packing launch, at least the first re-syncing the mirror, and
    its parts summing to the gang_device phase on the same clock."""
    from kubernetes_tpu_torch import scheduler as S
    from kubernetes_tpu_torch.config.types import default_config
    from kubernetes_tpu_torch.perf import harness as H
    from kubernetes_tpu_torch.perf import workloads as W

    tick = itertools.count()
    r = H.run_workload(W.gang_preemption(), scale=0.1,
                       config=default_config(), device="cpu",
                       now=lambda: 1000.0 + next(tick) * 1e-3,
                       sleep=lambda dt: None)
    st = r["stats"]
    split = st["gang_split_s"]
    assert set(split) == set(S.GANG_SPLIT)
    assert split["chunks"] == st["gang_device_launches"] > 0
    assert 1 <= split["resyncs"] <= split["chunks"]
    parts = sum(split[k] for k in S.GANG_SPLIT
                if k not in ("chunks", "resyncs"))
    assert parts == pytest.approx(st["time_s"]["gang_device"], abs=1e-6)


def test_gang_preemption_folds_evictions_between_chunks():
    """GangPreemption reduced: the whole-gang evictions between packing
    chunks are foreign pod deletes, folded into the usage chain as deltas
    (K11's twin here), so only the first chunk, which seeds the chain,
    re-syncs the mirror; the bindings equal the reference's."""
    from kubernetes_tpu_torch.config.types import default_config
    from kubernetes_tpu_torch.perf import harness as H
    from kubernetes_tpu_torch.perf import workloads as W

    want = _run(False, "gang_preemption", 0.25)
    got = _run(True, "gang_preemption", 0.25)
    assert got == want and got["preemptions"] > 0
    tick = itertools.count()
    r = H.run_workload(W.gang_preemption(), scale=0.25,
                       config=default_config(), device="cpu",
                       now=lambda: 1000.0 + next(tick) * 1e-3,
                       sleep=lambda dt: None)
    st = r["stats"]
    assert st["gang_split_s"]["chunks"] >= 3
    assert st["gang_split_s"]["resyncs"] == 1
    assert st["chain_patches"] >= 1 and st["chain_patch_fallbacks"] == 0
