"""K7's twins against the JAX package: the gang packer
(``ops/gang.py:pack_gangs`` through ``kernels/gang.py``) against
``kubernetes_tpu.ops.gang.pack_gangs_jit``, and the capacity bound
(``capacity`` through ``kernels/gang.py:gang_capacity``) against
``gang_capacity_device``.

Each case builds one cluster (seeded with numpy) in both packages' Cache +
Mirror, packs the same representative rows, and compares every output:
ok, alloc, spans, free, nzr and guard exactly; ``cap`` exactly, with one
stated tolerance — where the exact member-capacity total reaches 2^24 the
reference's f32 sum rounds in XLA's reduction order and the twin rounds
the exact sum once, so there ``cap`` is held to 2^-20 relative (a few
ulps); no verdict reads those bits (``need`` is far below 2^24), and the
test asserts that the verdicts agree. The capacity bound has the same
tolerance for the same reason.

Cases: the reference's (tests/test_gang_device.py:99-175): all-or-nothing,
three gangs chaining usage, topology-close packing, static filters
rejecting nodes; and a seeded fuzz over 64-512 nodes: zones with tied
domain and node capacities, tk = -1, nodes whose capacity reaches 4,095
(tiny requests, NodeResourcesFit off), nominated reservations with the
gangs' own nominated members handed back, padding rows, a gang that fits
exactly and one that fails by one member, and three chained launches."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetes_tpu.api.objects import LABEL_ZONE
from kubernetes_tpu.backend.cache import Cache as JCache
from kubernetes_tpu.backend.mirror import Mirror as JMirror
from kubernetes_tpu.backend.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.models.pipeline import extract_state_jit
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu.ops.features import PodBlobs as JPodBlobs
from kubernetes_tpu.ops.gang import gang_capacity_device, pack_gangs_jit
from kubernetes_tpu.testing import MakeNode, MakePod
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.mirror import Mirror as TMirror
from kubernetes_tpu_torch.backend.snapshot import Snapshot as TSnapshot
from kubernetes_tpu_torch.kernels import gang as KG
from kubernetes_tpu_torch.ops import gang as OG
from kubernetes_tpu_torch.ops.features import PodBlobs as TPodBlobs
from tests.torch_port_support import port_caps, to_port

pytestmark = pytest.mark.torch_port

FIT_OFF = (True,) * 5 + (False,) + (True, True)


class Both:
    """One cluster mirrored by both packages."""

    def __init__(self, nodes, bound=(), nominated=None, n_cap=None):
        n_cap = n_cap or max(16, 1 << (len(nodes) - 1).bit_length())
        self.caps = JCaps(nodes=n_cap, pods=1024)
        self.jm = JMirror(caps=self.caps)
        self.tm = TMirror(caps=port_caps(self.caps), device="cpu")
        for cache_cls, snap_cls, mirror, conv in (
                (JCache, JSnapshot, self.jm, lambda o: o),
                (TCache, TSnapshot, self.tm, to_port)):
            cache, snap = cache_cls(), snap_cls()
            for n in nodes:
                cache.add_node(conv(n))
            for p in bound:
                cache.add_pod(conv(p))
            cache.update_snapshot(snap)
            mirror.sync(snap)
            by_node = {}
            for p in nominated or ():
                by_node.setdefault(p.status.nominated_node_name,
                                   []).append(conv(p))
            mirror.set_nominated(by_node)

    def pack(self, reps, needs, own_nom=None, filters=None, g_bucket=None,
             jstate=None, tstate=None):
        g_bucket = g_bucket or max(4, len(reps))
        need = np.zeros((g_bucket,), np.int32)
        need[:len(needs)] = needs
        onom = None
        if own_nom is not None:
            onom = np.zeros((g_bucket, self.caps.nodes), np.int32)
            onom[:len(own_nom)] = own_nom
        filters = filters or (True,) * 8
        jm, tm = self.jm, self.tm
        treps = [to_port(p) for p in reps]
        feats = jm.launch_features(reps)
        assert tm.launch_features(treps) == feats
        pf = jm.pod_fields(feats, False)
        f32, i32 = jm._pack_batch_np(reps, g_bucket, pf)
        tf32, ti32 = tm._pack_batch_np(treps, g_bucket, pf)
        np.testing.assert_array_equal(f32, tf32)
        np.testing.assert_array_equal(i32, ti32)
        tk, d_bucket = jm.gang_pack_domain()
        assert tm.gang_pack_domain() == (tk, d_bucket)
        cb = jm.to_blobs()
        jout = pack_gangs_jit(
            cb, JPodBlobs(f32=jnp.asarray(f32), i32=jnp.asarray(i32)),
            jm.well_known(), self.caps, need, np.int32(tk), d_cap=d_bucket,
            enabled_filters=filters, active=feats, pfields=pf,
            ptmpl=jm.pod_template_blobs(),
            state=jstate if jstate is not None
            else extract_state_jit(cb, self.caps),
            own_nom=None if onom is None else jnp.asarray(onom))
        tout = KG.pack_gangs(
            tm.to_blobs(), TPodBlobs(f32=torch.from_numpy(tf32),
                                     i32=torch.from_numpy(ti32)),
            tm.well_known(), port_caps(self.caps), need, tk, d_cap=d_bucket,
            enabled_filters=filters, active=feats, pfields=pf,
            ptmpl=tm.pod_template_blobs(), state=tstate, own_nom=onom)
        compare(jout, tout)
        return jout, tout


def compare(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout.ok), tout.ok.numpy())
    np.testing.assert_array_equal(np.asarray(jout.alloc), tout.alloc.numpy())
    np.testing.assert_array_equal(np.asarray(jout.spans),
                                  tout.spans.numpy())
    np.testing.assert_array_equal(np.asarray(jout.free), tout.free.numpy())
    np.testing.assert_array_equal(np.asarray(jout.nzr), tout.nzr.numpy())
    assert int(jout.guard) == int(tout.guard)
    jcap = np.asarray(jout.cap).astype(np.int64)
    tcap = tout.cap.numpy().astype(np.int64)
    small = tcap < 2 ** 24
    np.testing.assert_array_equal(jcap[small], tcap[small])
    # the stated tolerance: f32 totals past 2^24 (module docstring)
    np.testing.assert_allclose(jcap[~small], tcap[~small], rtol=2.0 ** -20)


def node(i, cpu="4", mem="32Gi", zone=None, taint=False):
    mk = MakeNode().name(f"n{i}").capacity(cpu=cpu, memory=mem, pods="110")
    if taint:
        mk = mk.taint("k", "v", "NoSchedule")
    n = mk.obj()
    if zone is not None:
        n.metadata.labels[LABEL_ZONE] = zone
    return n


def rep(cpu="900m", mem="200Mi", name="r"):
    return MakePod().name(name).req(cpu=cpu, memory=mem).obj()


# ------------------------------------------- the reference's cases


def test_all_or_nothing():
    both = Both([node(i, cpu="2") for i in range(2)])
    _j, out = both.pack([rep(), rep()], [4, 5])
    assert bool(out.ok[0]) and int(out.alloc[0].sum()) == 4
    assert not bool(out.ok[1]) and int(out.alloc[1].sum()) == 0
    assert int(out.cap[1]) == 0


def test_sequential_gangs_chain_usage():
    both = Both([node(i) for i in range(2)])
    r = rep(cpu="1900m")
    _j, out = both.pack([r, r, r], [2, 2, 1])
    assert out.ok[:2].all() and not bool(out.ok[2])
    assert int(out.alloc[:2].sum()) == 4
    assert int(out.cap[1]) == 2


def test_topology_close_packing():
    zones = ["z0", "z0", "z1", "z1", "z2", "z2", "z3", "z3"]
    both = Both([node(i, zone=z) for i, z in enumerate(zones)])
    _j, out = both.pack([rep()], [8])
    assert bool(out.ok[0]) and int(out.spans[0]) == 1
    _j, out = both.pack([rep(), rep()], [12, 0])
    assert bool(out.ok[0]) and int(out.spans[0]) == 2


def test_static_filters_reject_nodes():
    both = Both([node(0, mem="8Gi"), node(1, mem="8Gi", taint=True)])
    _j, out = both.pack([rep()], [8])
    assert not bool(out.ok[0]) and int(out.cap[0]) == 4


# ------------------------------------------- the seeded fuzz


def _fuzz(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.choice([64, 200, 512]))
    zoned = seed % 3 != 2                     # every third case tk = -1
    n_zones = int(rng.choice([2, 4, 8]))
    cpus = ["2", "4", "8"] if seed % 2 else ["4"]   # ties when uniform
    nodes = []
    for i in range(n):
        zone = f"z{i % n_zones}" if zoned and rng.random() < 0.95 else None
        nodes.append(node(i, cpu=str(rng.choice(cpus)), zone=zone,
                          taint=bool(rng.random() < 0.05)))
    bound = []
    for i in range(n // 2):
        p = MakePod().name(f"b{i}").req(
            cpu=f"{int(rng.integers(1, 20)) * 100}m", memory="1Gi").obj()
        p.spec.node_name = f"n{int(rng.integers(0, n))}"
        bound.append(p)
    nominated, own = [], []
    for i in range(int(rng.integers(0, 6))):
        p = MakePod().name(f"nom{i}").req(cpu="900m", memory="200Mi").obj()
        p.status.nominated_node_name = f"n{int(rng.integers(0, n))}"
        nominated.append(p)
        own.append(p)
    return rng, n, nodes, bound, nominated, own


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_matches_reference(seed):
    rng, n, nodes, bound, nominated, own = _fuzz(seed)
    both = Both(nodes, bound, nominated)
    reqs = ["900m", "1100m", "250m", "1m"]    # 1m: capacity past 4,095
    reps = [rep(cpu=str(rng.choice(reqs)), mem="1Ki" if k == 3 else "200Mi",
                name=f"r{k}") for k in range(4)]
    # the gangs' own nominated members hand their reservations back
    onom = np.zeros((8, both.caps.nodes), np.int32)
    for p in own:
        onom[0, both.jm.row_of(p.status.nominated_node_name)] += 1
    needs = [int(rng.integers(2, 65)) for _ in range(3)] + [0]  # padding
    _j, out = both.pack(reps + [rep(name="pad")], needs, own_nom=onom,
                        g_bucket=8)
    # exact fit and fail-by-one for the first gang (its capacity depends
    # only on the launch's start state)
    cap0 = int(out.cap[0])
    if 0 < cap0 < 2 ** 24:
        _j, exact = both.pack(reps[:1], [cap0], own_nom=onom[:1])
        assert bool(exact.ok[0]) and int(exact.alloc[0].sum()) == cap0
        _j, over = both.pack(reps[:1], [cap0 + 1], own_nom=onom[:1])
        assert not bool(over.ok[0]) and int(over.alloc[0].sum()) == 0
    # NodeResourcesFit off: every statically feasible node holds 2^20
    _j, off = both.pack(reps[:2], [5, 7], filters=FIT_OFF)
    assert off.ok[:2].all()


@pytest.mark.parametrize("seed", range(3))
def test_three_chained_launches(seed):
    rng, n, nodes, bound, nominated, _own = _fuzz(10 + seed)
    both = Both(nodes, bound, nominated)
    jstate = tstate = None
    for launch in range(3):
        reps = [rep(cpu=str(rng.choice(["500m", "900m", "1900m"])),
                    name=f"c{launch}-{k}") for k in range(4)]
        needs = [int(rng.integers(1, 3 * n // 4)) for _ in range(4)]
        jout, tout = both.pack(reps, needs, jstate=jstate, tstate=tstate)
        jstate, tstate = (jout.free, jout.nzr), (tout.free, tout.nzr)


# ------------------------------------------- K7b's twin


@pytest.mark.parametrize("case", ["fuzz", "tiny", "inactive", "memory"])
def test_capacity_matches_reference(case):
    rng = np.random.default_rng(7)
    free = (rng.integers(-2, 40, size=(300, 8)) * 100).astype(np.float32)
    req = np.zeros((8,), np.float32)
    if case == "fuzz":
        req[0], req[1] = 900.0, 200.0 * 2 ** 20
        free[:, 1] = rng.integers(0, 64, size=300) * 2.0 ** 28
    elif case == "tiny":
        req[0] = 1.0                            # totals past 2^24
    elif case == "memory":
        req[1] = 1024.0
        free[:, 1] = rng.integers(0, 2 ** 20, size=300).astype(np.float32)
    want = int(gang_capacity_device(free, req))
    got = int(KG.gang_capacity(torch.from_numpy(free),
                               torch.from_numpy(req)))
    if case == "inactive":
        assert want == got == 2 ** 30
    elif got < 2 ** 24:
        assert want == got
    else:
        assert abs(want - got) <= got * 2.0 ** -20, (want, got)


def test_capacity_reads_a_strided_view():
    """K7b reads the free columns of the node blob in place (a row-strided
    view): the twin on the view equals the twin on a copy."""
    rng = np.random.default_rng(3)
    blob = torch.from_numpy(rng.integers(0, 50, size=(64, 20))
                            .astype(np.float32) * 100)
    view = blob[:, 4:12]
    req = torch.tensor([900.0] + [0.0] * 7)
    assert int(KG.gang_capacity(view, req)) == int(
        OG.capacity(view.contiguous(), req))


# ------------------------------------------- K1's host_ok input


def _host_mask(rng, b, n):
    """[B, N] host verdicts: whole rows rejected (a PreFilter), partial
    masks (a Filter), and untouched rows."""
    m = np.ones((b, n), bool)
    for i in range(b):
        kind = rng.integers(0, 3)
        if kind == 0:
            m[i] = False
        elif kind == 1:
            m[i] = rng.random(n) < 0.6
    return m


@pytest.mark.parametrize("case", ["auction_rich_fuzz", "auction_dedup",
                                  "spread_zone", "incoming_anti_zone"])
def test_host_ok_launch_matches_reference(case):
    """launch_batch(host_ok=...) in both packages: the host verdicts AND
    into each pod's phase-1 mask (the port: K1's optional input, phase 1
    per pod; on a topology launch K5 keeps the groups' masks and the scan
    reads a second, per-pod K1). Rows, counts, free/nzr, guard exact;
    scores as tests/test_torch_pipeline.py holds them."""
    from kubernetes_tpu.models import pipeline as JP
    from kubernetes_tpu_torch.models import pipeline as TP
    from tests import test_torch_pipeline as PT

    rng = np.random.default_rng(5)
    if case == "auction_rich_fuzz":
        mirror, spec, caps = PT.CASES["rich_fuzz"]()
        serial = False
    elif case == "auction_dedup":
        caps = JCaps(nodes=16, pods=128)
        mirror = PT._mirror([node(i, cpu="2") for i in range(12)], [], caps)
        spec = mirror.prepare_launch(
            [rep(cpu="300m", name=f"d{i}") for i in range(40)], 64)
        assert spec.gid is not None      # a phase-1 dedup launch
        serial = False
    else:
        from tests import test_topology as TT
        from tests.test_torch_topology import SCENARIOS

        nodes, bound, pods = SCENARIOS[case]()
        mirror = PT._mirror(nodes, bound, TT.CAPS)
        caps = TT.CAPS
        spec = mirror.prepare_launch(pods, 8)
        assert spec.enable_topology
        serial = True
    b = np.asarray(spec.pblobs.f32).shape[0]
    host_ok = _host_mask(rng, b, caps.nodes)
    weights = convert_weights(JP)
    jout = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                           caps, serial_scan=serial, tie_seed=np.uint32(3),
                           host_ok=jnp.asarray(host_ok))
    tout = TP.launch_batch(PT._port_spec(spec), mirror.well_known(), weights,
                           port_caps(caps), serial_scan=serial, tie_seed=3,
                           host_ok=torch.from_numpy(host_ok), device="cpu")
    PT._assert_same(jout, tout)
    rows = tout.node_row.numpy()
    for i in np.flatnonzero(rows >= 0):
        assert host_ok[i, rows[i]]


def convert_weights(JP):
    from kubernetes_tpu_torch import convert

    return convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})


def test_int32_prefix_wrap_is_a_stated_deviation():
    """ROADMAP queue 3: with NodeResourcesFit off every eligible node holds
    2^20 members, so past 2,048 nodes the reference's int32 fill-order
    prefix wraps and nodes deep in the order "take" members too (its
    gang can then never commit); the port's int64 prefix places exactly
    ``need``. The deviation is asserted, not tolerated silently."""
    both = Both([node(i) for i in range(2100)], n_cap=4096)
    with pytest.raises(AssertionError):
        both.pack([rep()], [5], filters=FIT_OFF)
    jm, tm = both.jm, both.tm
    r = [rep()]
    feats = jm.launch_features(r)
    pf = jm.pod_fields(feats, False)
    f32, i32 = jm._pack_batch_np(r, 4, pf)
    tk, d = jm.gang_pack_domain()
    need = np.array([5, 0, 0, 0], np.int32)
    cb = jm.to_blobs()
    jout = pack_gangs_jit(
        cb, JPodBlobs(f32=jnp.asarray(f32), i32=jnp.asarray(i32)),
        jm.well_known(), both.caps, need, np.int32(tk), d_cap=d,
        enabled_filters=FIT_OFF, active=feats, pfields=pf,
        ptmpl=jm.pod_template_blobs(),
        state=extract_state_jit(cb, both.caps))
    tout = KG.pack_gangs(
        tm.to_blobs(), TPodBlobs(f32=torch.from_numpy(f32),
                                 i32=torch.from_numpy(i32)),
        tm.well_known(), port_caps(both.caps), need, tk, d_cap=d,
        enabled_filters=FIT_OFF, active=feats, pfields=pf,
        ptmpl=tm.pod_template_blobs())
    assert int(np.asarray(jout.alloc)[0].sum()) > 5
    assert int(tout.alloc[0].sum()) == 5 and bool(tout.ok[0])
    # the first node in the fill order takes all five in both
    assert int(np.asarray(jout.alloc)[0, 0]) == int(tout.alloc[0, 0]) == 5
