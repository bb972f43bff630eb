"""K5's twin (kernels/topology.py: topo_table_ref -> topo_nodes_ref ->
topo_pairs_ref) against the JAX package's per-group topology statics.

Each case packs one cluster and batch with the JAX Mirror (Cache ->
Snapshot -> Mirror), hands the same arrays to the port, and compares the
port's statics for every topology group with the JAX package's
``per_group`` (models/pipeline.py :1078-1145, recomputed here from its
ops/topology.py functions, vmapped over the group representatives) and
its pairwise ``M_*_gg`` matches (:1153-1173).

Every bool map, every count and ``ipa_raw`` must be EXACT. ``tpw`` =
log(domains + 2) must be exact or one ulp off: the port reads a float32
table built with torch.log on the CPU (correctly rounded), XLA's float32
log on the CPU is not correctly rounded (log(7) is the first value it
misses), so the two may differ in the last bit."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.objects as jax_objects
from kubernetes_tpu.api.objects import (
    LABEL_HOSTNAME,
    LABEL_ZONE,
    Affinity,
    LabelSelector,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    WeightedPodAffinityTerm,
)
from kubernetes_tpu.backend.cache import Cache
from kubernetes_tpu.backend.mirror import Mirror
from kubernetes_tpu.backend.snapshot import Snapshot
from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu.ops import topology as JT
from kubernetes_tpu.ops.features import Capacities
from kubernetes_tpu.ops.features import unpack_cluster as j_unpack_cluster
from kubernetes_tpu.ops.features import unpack_pods as j_unpack_pods
from kubernetes_tpu.utils.interner import NONE
from kubernetes_tpu_torch.kernels import topology as KT
from kubernetes_tpu_torch.kernels.phase1 import phase1_static_ref
from kubernetes_tpu_torch.models import pipeline as TP
from kubernetes_tpu_torch.perf.fuzz import topology_fuzz
from tests import test_topology as TT
from tests.torch_port_support import port_caps as _port_caps
from tests.torch_port_support import port_spec as _port_spec

pytestmark = pytest.mark.torch_port

FUZZ_CAPS = Capacities(nodes=32, pods=128, domains=32)


def _mirror(nodes, bound, caps, nominated=None):
    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    mirror = Mirror(caps=caps)
    mirror.sync(snap)
    if nominated:
        mirror.set_nominated(nominated)
    return mirror


def jax_per_group(spec, caps, wk):
    """The reference's phase 1b statics and pairwise matches, per group."""
    out = _jax_per_group(spec.cblobs, spec.pblobs, spec.ptmpl, spec.rep, wk,
                         caps=caps, pfields=spec.pfields,
                         active=tuple(spec.active), d_cap=spec.d_cap)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.partial(jax.jit, static_argnames=("caps", "pfields", "active",
                                             "d_cap"))
def _jax_per_group(cblobs, pblobs, ptmpl, rep, wk, caps, pfields, active,
                   d_cap):
    ct = j_unpack_cluster(cblobs, caps)
    pods = j_unpack_pods(pblobs, caps, pfields, ptmpl)
    pods_rep = jax.tree.map(lambda x: x[rep], pods)
    act = frozenset(active)
    enabled = (True,) * len(JP.FILTER_PLUGINS)
    valid = ct.node_valid
    tds = JT.slot_topo_dom(ct)

    def per_group(pod):
        masks = JP.static_filters(ct, pod, wk, enabled, act)
        g_static_ok = jnp.all(masks, axis=0) & valid & pod.valid
        taint_ok, nodeaff_ok = masks[2], masks[3]
        used_c = pod.tsc_tk != jnp.int32(-1)
        used_hard = used_c & pod.tsc_hard
        used_soft = used_c & ~pod.tsc_hard
        el_hard = JT.spread_eligible(ct, pod, nodeaff_ok, taint_ok,
                                     used_hard)
        el_soft = JT.spread_eligible(ct, pod, nodeaff_ok, taint_ok,
                                     used_soft)
        el_mixed = jnp.where(pod.tsc_hard[None], el_hard, el_soft)
        cnt = JT.spread_cnt(ct, pod, tds, el_mixed, d_cap)
        exists_hard = JT.spread_exists(ct, pod, el_hard, d_cap)
        node_dom = JT.take_cols(ct.topo_dom, pod.tsc_tk, jnp.int32(-1))
        spread_ignored = jnp.any((node_dom == jnp.int32(-1))
                                 & used_soft[None], axis=1)
        exists_score = JT.spread_exists(
            ct, pod,
            (g_static_ok & ~spread_ignored)[:, None] & used_soft[None],
            d_cap)
        tp_weight = jnp.log(jnp.sum(exists_score, axis=1)
                            .astype(jnp.float32) + 2.0)
        tsc_self = JT._tsc_self_match(pod).astype(jnp.float32)
        ipa_anti_ok, aff_present, aff_any = JT.inter_pod_affinity_static(
            ct, pod, tds, d_cap)
        ipa_raw = JT.inter_pod_affinity_score(
            ct, pod, tds, d_cap, jnp.float32(JP.HARD_POD_AFFINITY_WEIGHT))
        has_soft = jnp.any(used_soft)
        pol = (jnp.where(pod.tsc_honor_affinity[None],
                         (nodeaff_ok & valid)[:, None], True)
               & jnp.where(pod.tsc_honor_taints[None],
                           (taint_ok & valid)[:, None], True))
        dom_ok = node_dom != jnp.int32(-1)
        all_h = jnp.all(dom_ok | ~used_hard[None], axis=1)
        all_s = jnp.all(dom_ok | ~used_soft[None], axis=1)
        el_node = (pol & jnp.where(used_hard[None], all_h[:, None],
                                   all_s[:, None]) & used_c[None])
        aff_node_dom = JT.take_cols(ct.topo_dom, pod.aff_tk, NONE)
        has_lbl = aff_node_dom != NONE
        term_static = has_lbl & JT.gather_rows(aff_present, aff_node_dom)
        match_static = JT.gather_rows(cnt, node_dom)
        num_domains = jnp.sum(exists_hard, axis=1)
        return dict(cnt=cnt, exists_hard=exists_hard, ign=spread_ignored,
                    tpw=tp_weight, self_match=tsc_self, anti_ok=ipa_anti_ok,
                    any_match=aff_any, ipa_raw=ipa_raw, has_soft=has_soft,
                    el_node=el_node, term_static=term_static,
                    has_lbl=has_lbl, match_static=match_static,
                    dom_ok=dom_ok, num_domains=num_domains)

    out = jax.vmap(per_group)(pods_rep)
    pr = pods_rep
    out["m_terms"] = jnp.stack([JT.pair_term_match(
        getattr(pr, f"{k}_tk"), getattr(pr, f"{k}_ns"),
        getattr(pr, f"{k}_ns_all"), getattr(pr, f"{k}_sel_cols"),
        getattr(pr, f"{k}_sel_ops"), getattr(pr, f"{k}_sel_vals"),
        pr.plabel_vals, pr.ns, pr.valid) for k in KT.TERM_KINDS])
    out["m_tsc"] = JT.pair_tsc_match(pr)
    return out


def port_statics(spec, caps, wk):
    tspec = _port_spec(spec)
    tcaps = _port_caps(caps)
    rows = tspec.rep.long()
    f32, i32 = TP.full_pod_rows(tspec.pblobs, tspec.ptmpl, tcaps,
                                tspec.pfields, rows)
    p1 = phase1_static_ref(tspec.cblobs, f32, i32, tcaps, wk, (True,) * 5,
                           frozenset(tspec.active))
    st = KT.topo_statics_ref(tspec.cblobs, f32, i32, p1.static_ok,
                             p1.taint_ok, p1.nodeaff_ok, tcaps, tspec.d_cap)
    flat = {**st.maps._asdict(), **st.nodes._asdict(), **st.pairs._asdict()}
    return {k: v.numpy() for k, v in flat.items()}


def assert_statics_match(spec, caps, wk):
    want = jax_per_group(spec, caps, wk)
    got = port_statics(spec, caps, wk)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name == "tpw":
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
            continue
        assert np.array_equal(g, w.astype(g.dtype)), (
            f"{name}: port differs at {np.argwhere(g != w)[:5].tolist()}")
    return want


mk = TT.mkpod


def _pref(kind, key, weight=100, **match):
    term = WeightedPodAffinityTerm(weight=weight, pod_affinity_term=(
        PodAffinityTerm(topology_key=key,
                        label_selector=LabelSelector(match_labels=match))))
    if kind == "aff":
        return Affinity(pod_affinity=PodAffinity(preferred=[term]))
    return Affinity(pod_anti_affinity=PodAntiAffinity(preferred=[term]))


def _min_domains():
    t = TT.hard_spread(LABEL_ZONE, app="s")
    t.min_domains = 3
    return t


def _rack_nodes():
    nodes = [TT.mknode("n1", "z1"), TT.mknode("n2", "z2")]
    nodes[0].metadata.labels["rack"] = "r1"
    nodes[1].metadata.labels["rack"] = "r2"
    return nodes


# tests/test_topology.py's scenarios: (nodes, bound pods, batch)
SCENARIOS = {
    "incoming_anti_zone": lambda: (TT.ZONES, [mk("w", {"app": "web"},
                                                 node="n1")],
                                   [mk("p", affinity=TT.anti(
                                       LABEL_ZONE, app="web"))]),
    "incoming_anti_hostname": lambda: (TT.ZONES, [mk("w", {"app": "web"},
                                                     node="n1")],
                                       [mk("p", affinity=TT.anti(
                                           LABEL_HOSTNAME, app="web"))]),
    "existing_anti_blocks": lambda: (TT.ZONES, [mk(
        "guard", {"team": "a"}, node="n1",
        affinity=TT.anti(LABEL_ZONE, app="web"))],
        [mk("p", {"app": "web"})]),
    "required_affinity": lambda: (TT.ZONES, [mk("w", {"app": "db"},
                                                node="n3")],
                                  [mk("p", affinity=TT.aff(LABEL_ZONE,
                                                           app="db"))]),
    "affinity_first_of_group": lambda: (TT.ZONES, [], [mk(
        "p", {"app": "db"}, affinity=TT.aff(LABEL_ZONE, app="db"))]),
    "in_batch_anti": lambda: (TT.ZONES, [], [mk(
        f"p{i}", {"app": "web"}, affinity=TT.anti(LABEL_ZONE, app="web"))
        for i in range(3)]),
    "in_batch_affinity": lambda: (TT.ZONES, [], [
        mk("leader", {"app": "grp"}, affinity=TT.aff(LABEL_ZONE, app="grp")),
        mk("follower", affinity=TT.aff(LABEL_ZONE, app="grp"))]),
    "spread_hostname": lambda: (TT.ZONES, [], [mk(
        f"p{i}", {"app": "s"}, tsc=[TT.hard_spread(LABEL_HOSTNAME, app="s")])
        for i in range(4)]),
    "spread_zone": lambda: (TT.ZONES, [mk("a", {"app": "s"}, node="n1"),
                                       mk("b", {"app": "s"}, node="n2")],
                            [mk("p", {"app": "s"}, tsc=[TT.hard_spread(
                                LABEL_ZONE, app="s")])]),
    "spread_soft": lambda: (TT.ZONES, [mk("a", {"app": "s"}, node="n1"),
                                       mk("b", {"app": "s"}, node="n2")],
                            [mk("p", {"app": "s"}, tsc=[TT.soft_spread(
                                LABEL_ZONE, app="s")])]),
    "min_domains": lambda: (TT.ZONES, [mk("a", {"app": "s"}, node="n1")],
                            [mk("p", {"app": "s"}, tsc=[_min_domains()])]),
    "preferred_affinity": lambda: (TT.ZONES, [mk("db", {"app": "db"},
                                                 node="n3")],
                                   [mk("p", affinity=_pref(
                                       "aff", LABEL_ZONE, app="db"))]),
    "preferred_anti_affinity": lambda: (TT.ZONES, [mk("db", {"app": "db"},
                                                      node="n1")],
                                        [mk("p", affinity=_pref(
                                            "anti", LABEL_ZONE, app="db"))]),
    "new_topology_key": lambda: (_rack_nodes(), [mk("db", {"app": "db"},
                                                    node="n1")],
                                 [mk("p", affinity=TT.aff("rack",
                                                          app="db"))]),
    "soft_spread_unlabeled_key": lambda: (
        TT.ZONES, [mk("a", {"app": "s"}, node="n1"),
                   mk("b", {"app": "s"}, node="n2")],
        [mk("p", {"app": "s"}, tsc=[TT.hard_spread(LABEL_ZONE, app="s"),
                                    TT.soft_spread("rack", app="s")])]),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_statics_match_jax(case):
    nodes, bound, pods = SCENARIOS[case]()
    mirror = _mirror(nodes, bound, TT.CAPS)
    spec = mirror.prepare_launch(pods, 8)
    assert spec.enable_topology
    assert_statics_match(spec, TT.CAPS, mirror.well_known())


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_statics_fuzz_match_jax(seed):
    """Namespaces, In / NotIn / Exists / DoesNotExist selectors, nominated
    slots, node-inclusion policies, minDomains, preferred terms and
    unlabeled keys, over the port's seeded topology cluster."""
    rng = random.Random(40 + seed)
    nodes, bound, specs, _ = topology_fuzz(rng, 24, 40, 6,
                                           objects=jax_objects)
    pods = []
    for i in range(12):
        p = specs[i % len(specs)].clone()
        p.metadata.name = f"{p.metadata.name}-{i}"
        p.metadata.uid = f"{p.metadata.uid}-{i}"
        pods.append(p)
    nominated = {nodes[1].metadata.name: [specs[0].clone()],
                 nodes[2].metadata.name: [bound[0].clone()]}
    mirror = _mirror(nodes, bound, FUZZ_CAPS, nominated)
    spec = mirror.prepare_launch(pods, 16)
    want = assert_statics_match(spec, FUZZ_CAPS, mirror.well_known())
    # the fuzz reaches the parts of the statics it is meant to
    assert want["m_terms"].any() and want["m_tsc"].any()
    assert want["cnt"].any() and want["exists_hard"].any()
    assert not want["anti_ok"].all() and want["ipa_raw"].any()


def test_log2p_table_is_torch_log():
    """The tpw table is float32 torch.log on the CPU, as documented."""
    t = KT.log2p_table(64, "cpu")
    want = torch.log(torch.arange(65, dtype=torch.float32) + 2.0)
    assert torch.equal(t, want)
