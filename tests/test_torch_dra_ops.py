"""The port's DRA allocator (kernel K8's twin, ops/dra.py, and the plugin's
batch builder, plugins/dra.py) against the JAX package's, on the CPU.

- The twin against ``kubernetes_tpu.ops.dra.batch_feasible_jit`` on
  seeded fuzz (perf/fuzz.py:dra_fuzz: All mode, count 0, PIN_ANY /
  PIN_NONE / pinned rows, inactive rows, in-use devices, bit 31 of the
  selector words), B past DRA_CHUNK included, D = 8,192 (past the
  previous K8's cap) with a few nodes; a model of the redesigned K8's
  chunked, bitsliced pick against the twin.
- The builder: every tests/test_dra_fuzz.py scenario built by both
  packages' DeviceAllocatorView from the same objects gives the same
  tensors, the same routing, and masks equal to the port's own host
  allocator; the inexpressible features and the 257th selector route to
  the host path in both.
- The fused launch: ``dra_reject`` and the ANDed mask through both
  packages' launch_batch (auction and serial scan, with and without host
  verdicts).

Tolerance 0 everywhere: DRA has no floats (the launch's scores are held
to 1e-4 as in tests/test_torch_pipeline.py)."""

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.objects import (
    Device,
    DeviceRequest,
    DeviceSelector,
    ObjectMeta,
    Pod,
    PodResourceClaim,
    PodSpec,
    ResourceClaim,
    ResourceClaimSpec,
    ResourceSlice,
)
from kubernetes_tpu.hub import Hub as JHub
from kubernetes_tpu.models import pipeline as JP
from kubernetes_tpu.ops import dra as JD
from kubernetes_tpu.plugins.dra import DynamicResources as JDynamicResources
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.hub import Hub as THub
from kubernetes_tpu_torch.kernels import dra as KD
from kubernetes_tpu_torch.models import pipeline as TP
from kubernetes_tpu_torch.ops import dra as OD
from kubernetes_tpu_torch.perf.fuzz import dra_fuzz
from kubernetes_tpu_torch.plugins.dra import DynamicResources as TDynamicResources
from tests.test_dra_fuzz import N_NODES, _scenario
from tests.torch_port_support import port_caps, port_spec, to_port

pytestmark = pytest.mark.torch_port

FIELDS = ("dev_valid", "dev_selbits", "dev_in_use", "req_mask", "req_count",
          "req_all", "pinned", "active")


def _port_batch(arrays: dict) -> OD.DraBatch:
    return convert.dra_batch_from_numpy(
        **{f: np.asarray(arrays[f]) for f in FIELDS}, device="cpu")


def _as_ref(fld: str, t: torch.Tensor) -> np.ndarray:
    """A port batch field as the reference holds it (selector words as
    uint32)."""
    a = t.numpy()
    return a.view(np.uint32) if fld in ("dev_selbits", "req_mask") else a


@pytest.mark.parametrize("shape", [
    (20, 32, 8, 1, 16),       # nodes, node bucket, D, Q, B
    (50, 64, 16, 2, 300),     # B past DRA_CHUNK (two chunks)
    (30, 32, 128, 4, 40),     # D past 64: two device words in K8
    (12, 16, 70, 2, 24),      # D not a power of two
    (3, 4, 8192, 2, 16),      # D = 8,192: past the previous K8's 4,096
    (4, 4, 8, 2, 700),        # B in three DRA_CHUNK chunks, the last ragged
])
def test_twin_matches_reference_batch_feasible(shape):
    n, n_cap, d, q, b = shape
    f = dra_fuzz(np.random.default_rng(sum(shape)), n, n_cap, d, q, b)
    want = np.asarray(JD.batch_feasible_jit(
        JD.DraBatch(**{k: f[k] for k in FIELDS})))
    got = OD.batch_feasible(_port_batch(f)).numpy()
    assert np.array_equal(want, got), np.argwhere(want != got)[:5]
    # the fuzz exercises both verdicts, pins and inactive rows
    assert want.any() and not want.all()
    assert (f["pinned"] >= 0).any() and (f["pinned"] == OD.PIN_NONE).any()
    assert (~f["active"]).any() and f["req_all"].any()


def _k8_model(f: dict, sw: int = 8) -> np.ndarray:
    """csrc/dra_feasible.cu's algorithm, pair by pair: a node's devices
    staged ``sw`` 32-device words at a time as the free word and one word
    a selector bit (bitsliced); each request's eligible word the free
    word, less the devices taken in this chunk, ANDed with its mask bits'
    words; the lowest eligible devices taken in order (every one in All
    mode), the devices still wanted carried from chunk to chunk."""
    valid, in_use = f["dev_valid"], f["dev_in_use"]
    sel = np.asarray(f["dev_selbits"]).view(np.uint32)
    mask = np.asarray(f["req_mask"]).view(np.uint32)
    n, d = valid.shape
    b, q = f["req_count"].shape
    ndw = -(-d // 32)

    def words(bits):            # [D] bool -> ndw 32-bit ints
        pad = np.zeros(ndw * 32, bool)
        pad[:d] = bits
        return [int(x) for x in np.packbits(
            pad.reshape(ndw, 32), axis=1, bitorder="little").view(
                np.uint32)[:, 0]]

    out = np.ones((b, n), bool)
    for node in range(n):
        free = words(valid[node] & ~in_use[node])
        sliced = {}
        for bi in range(b):
            pin = int(f["pinned"][bi])
            if not f["active"][bi]:
                continue
            if not (node == pin if pin >= 0 else pin == OD.PIN_ANY):
                out[bi, node] = False
                continue
            rem = {}
            for c0 in range(0, ndw, sw):
                taken = [0] * sw
                for qi in range(q):
                    cnt, al = int(f["req_count"][bi, qi]), \
                        bool(f["req_all"][bi, qi])
                    if not (cnt > 0 or al):
                        continue
                    if c0 == 0:
                        rem[qi] = 1 if al else cnt
                    if not al and rem[qi] <= 0:
                        continue
                    e = [(free[c0 + w] if c0 + w < ndw else 0) & ~taken[w]
                         for w in range(sw)]
                    for j in range(8):
                        for bit in range(32):
                            if not (int(mask[bi, qi, j]) >> bit) & 1:
                                continue
                            key = (j, bit)
                            if key not in sliced:
                                sliced[key] = words(
                                    (sel[node, :, j] >> np.uint32(bit)) & 1)
                            e = [x & (sliced[key][c0 + w] if c0 + w < ndw
                                      else 0) for w, x in enumerate(e)]
                    for w in range(sw):
                        x = e[w]
                        if al:
                            taken[w] |= x
                            if x:
                                rem[qi] = 0
                        elif rem[qi] > 0 and x:
                            while x and rem[qi] > 0:
                                low = x & -x
                                taken[w] |= low
                                x ^= low
                                rem[qi] -= 1
            out[bi, node] = all(v <= 0 for v in rem.values())
    return out


@pytest.mark.parametrize("shape", [
    (6, 8, 600, 3, 10),       # three staged chunks a node
    (5, 8, 70, 4, 12),        # a ragged last word
    (20, 32, 8, 2, 24),       # one word
])
def test_k8_chunked_bitsliced_pick_matches_the_twin(shape):
    """The redesigned K8's pick (bitsliced words, chunks of 8 device
    words, requests in order inside each chunk with the devices still
    wanted carried across chunks) gives the twin's verdicts, which are
    the reference's (test_twin_matches_reference_batch_feasible)."""
    n, n_cap, d, q, b = shape
    f = dra_fuzz(np.random.default_rng(11 + sum(shape)), n, n_cap, d, q, b)
    want = OD.batch_feasible(_port_batch(f)).numpy()
    assert np.array_equal(_k8_model(f), want)
    assert want.any() and not want.all()


def test_fused_phase1_counts_and_ands_as_the_reference():
    """The reference's fusion (pipeline.py:1023-1039) on the reference's
    own verdicts: dra_reject counts static-feasible nodes the claims
    reject; the mask is static_ok & dra_ok & host_ok. The wrapper's CPU
    path (the twin) also returns dra_ok."""
    f = dra_fuzz(np.random.default_rng(7), 40, 64, 16, 2, 64)
    dra_ok = np.asarray(JD.batch_feasible_jit(
        JD.DraBatch(**{k: f[k] for k in FIELDS})))
    st, host = f["static_ok"], f["host_ok"]
    out, rej, ok = KD.fuse_phase1(torch.from_numpy(st), _port_batch(f),
                                  torch.from_numpy(host), want_dra_ok=True)
    assert np.array_equal(ok.numpy(), dra_ok)
    assert np.array_equal(out.numpy(), st & dra_ok & host)
    assert np.array_equal(rej.numpy(),
                          (st & ~dra_ok).sum(1).astype(np.int32))
    out2, rej2 = KD.fuse_phase1(torch.from_numpy(st), _port_batch(f))
    assert np.array_equal(out2.numpy(), st & dra_ok)
    assert np.array_equal(rej2.numpy(), rej.numpy())


@pytest.mark.parametrize("shape", [(3, 4, 8192, 2, 16), (4, 4, 8, 2, 700)],
                         ids=["D=8192", "B=700"])
def test_fused_phase1_at_the_lifted_caps_matches_the_reference(shape):
    """The port's fuse_phase1 (the twin, on the CPU) at the shapes the
    previous K8 refused or chunked: D = 8,192 devices on a few nodes, and
    a batch in three DRA_CHUNK chunks; dra_ok, dra_reject and the mask
    as the reference fuses them."""
    f = dra_fuzz(np.random.default_rng(sum(shape) + 5), *shape)
    dra_ok = np.asarray(JD.batch_feasible_jit(
        JD.DraBatch(**{k: f[k] for k in FIELDS})))
    st, host = f["static_ok"], f["host_ok"]
    out, rej, ok = KD.fuse_phase1(torch.from_numpy(st), _port_batch(f),
                                  torch.from_numpy(host), want_dra_ok=True)
    assert np.array_equal(ok.numpy(), dra_ok)
    assert np.array_equal(out.numpy(), st & dra_ok & host)
    assert np.array_equal(rej.numpy(),
                          (st & ~dra_ok).sum(1).astype(np.int32))
    assert dra_ok.any() and not dra_ok.all()


def _port_hub(jhub: JHub) -> THub:
    """The same DRA objects in a port hub, created in the same order."""
    thub = THub()
    for dc in jhub.list_device_classes():
        thub.create_device_class(to_port(dc))
    for sl in jhub.list_resource_slices():
        thub.create_resource_slice(to_port(sl))
    for c in sorted(jhub.list_resource_claims(),
                    key=lambda c: c.metadata.resource_version):
        thub.create_resource_claim(to_port(c))
    return thub


def _host_mask(plugin, pod, node_names):
    """tests/test_dra_fuzz.py:_host_mask over the port's plugin."""
    claims = [c for _r, c in plugin._pod_claims(pod)]
    exclude = {c.key() for c in claims if c.status.allocation is None}
    in_use = plugin._in_use_view(exclude)
    out = []
    for node in node_names:
        ok = True
        local = set(in_use)
        for claim in claims:
            alloc = claim.status.allocation
            if alloc is not None:
                if alloc.node_name and alloc.node_name != node:
                    ok = False
                    break
                continue
            picked = plugin.allocate_claim(claim, node, local)
            if picked is None:
                ok = False
                break
            local |= {(d.driver, d.pool, d.device)
                      for d in picked if not d.admin_access}
        out.append(ok)
    return out


def test_builder_matches_reference_on_the_fuzz_scenarios():
    """Every tier-1 seed of tests/test_dra_fuzz.py: both builders pack the
    same tensors and route the same pods; the port's twin gives the JAX
    package's mask, which equals the port's host allocator's."""
    routed_total = 0
    for seed in range(200):
        jhub, jplugin, node_names, pods = _scenario(seed)
        thub = _port_hub(jhub)
        tplugin = TDynamicResources(thub)
        names = set(node_names)
        idx = {n: i for i, n in enumerate(node_names)}
        row_of = lambda n: idx[n] if n in names else -1  # noqa: E731
        jpods = [p for p, _e in pods]
        tpods = [to_port(p) for p in jpods]
        jb, jst = jplugin.build_device_batch(jpods, row_of, N_NODES,
                                             len(pods))
        tb, tst = tplugin.build_device_batch(tpods, row_of, N_NODES,
                                             len(pods))
        assert tplugin._device_routed == jplugin._device_routed, seed
        assert (tst["routed"], tst["fallback"]) == (jst["routed"],
                                                    jst["fallback"])
        assert tplugin.device_view.stats == jplugin.device_view.stats
        if jb is None:
            assert tb is None
            continue
        for fld in FIELDS:
            assert np.array_equal(np.asarray(getattr(jb, fld)),
                                  _as_ref(fld, getattr(tb, fld))), (seed, fld)
        want = np.asarray(JD.batch_feasible_jit(jb))
        got = OD.batch_feasible(tb).numpy()
        assert np.array_equal(want, got), seed
        for b, pod in enumerate(tpods):
            if pod.metadata.uid not in tplugin._device_routed:
                continue
            routed_total += 1
            host = _host_mask(tplugin, pod, node_names)
            assert [bool(got[b, idx[n]]) for n in node_names] == host, seed
    assert routed_total >= 300


def _claim_pods(hub, specs, prefix="c"):
    pods = []
    for i, spec in enumerate(specs):
        hub.create_resource_claim(ResourceClaim(
            metadata=ObjectMeta(name=f"{prefix}{i}"), spec=spec))
        pods.append(Pod(metadata=ObjectMeta(name=f"p{i}"),
                        spec=PodSpec(resource_claims=[PodResourceClaim(
                            name="c", resource_claim_name=f"{prefix}{i}")])))
    return pods


def test_inexpressible_features_route_to_host_in_both():
    """tests/test_dra_fuzz.py::test_inexpressible_features_route_to_host
    through both builders: adminAccess, firstAvailable, matchAttribute,
    a broken selector and count 0 never reach the kernel."""
    from tests.test_dra_fuzz import (
        DRIVER,
        DeviceConstraint,
        DeviceSubRequest,
    )

    specs = [
        ResourceClaimSpec(device_requests=[DeviceRequest(
            name="r", device_class_name="cls-a", admin_access=True)]),
        ResourceClaimSpec(device_requests=[DeviceRequest(
            name="r", first_available=[DeviceSubRequest(
                name="a", device_class_name="cls-a")])]),
        ResourceClaimSpec(
            device_requests=[DeviceRequest(name="r",
                                           device_class_name="cls-a")],
            constraints=[DeviceConstraint(match_attribute="model")]),
        ResourceClaimSpec(device_requests=[DeviceRequest(
            name="r", selectors=[DeviceSelector(
                cel_expression="((not cel")])]),
        ResourceClaimSpec(device_requests=[DeviceRequest(
            name="r", device_class_name="cls-a", count=0)]),
    ]
    out = []
    for hub_cls, plugin_cls, conv in ((JHub, JDynamicResources,
                                       lambda o: o),
                                      (THub, TDynamicResources, to_port)):
        hub = hub_cls()
        hub.create_resource_slice(conv(ResourceSlice(
            metadata=ObjectMeta(name="s"), node_name="n0", driver=DRIVER,
            pool="p", devices=[Device(name="d0",
                                      device_class_name="cls-a")])))
        plugin = plugin_cls(hub)
        pods = [conv(p) for p in _claim_pods(hub, [conv(s) for s in specs])]
        batch, stats = plugin.build_device_batch(
            pods, lambda n: 0 if n == "n0" else -1, N_NODES, len(pods))
        assert batch is None and stats["fallback"] == len(specs)
        assert plugin._device_routed == frozenset()
        out.append((plugin.cel_error_stats(), len(hub.list_events())))
    assert out[0] == out[1] and out[1][0] and out[1][1] >= 1


def test_257th_selector_routes_to_host_in_both():
    """SELBIT_WORDS x 32 = 256 compiled selectors: a claim needing a 257th
    distinct selector takes the host path, in both packages."""
    specs = [ResourceClaimSpec(device_requests=[DeviceRequest(
        name="r", selectors=[DeviceSelector(
            cel_expression=f"device.attributes['x.example.com'].k == {i}")
        ])]) for i in range(OD.MAX_SELECTORS + 1)]
    out = []
    for hub_cls, plugin_cls, conv, batch_mod in (
            (JHub, JDynamicResources, lambda o: o, None),
            (THub, TDynamicResources, to_port, OD)):
        hub = hub_cls()
        hub.create_resource_slice(conv(ResourceSlice(
            metadata=ObjectMeta(name="s"), node_name="n0",
            driver="x.example.com", pool="p",
            devices=[Device(name=f"d{i}", attributes={"k": i})
                     for i in (0, 7, 255, 256)])))
        plugin = plugin_cls(hub)
        pods = [conv(p) for p in _claim_pods(hub, [conv(s) for s in specs])]
        batch, stats = plugin.build_device_batch(
            pods, lambda n: 0 if n == "n0" else -1, 8, len(pods))
        assert stats["routed"] == OD.MAX_SELECTORS
        assert stats["fallback"] == 1
        assert pods[-1].metadata.uid not in plugin._device_routed
        mask = (np.asarray(JD.batch_feasible_jit(batch))
                if batch_mod is None
                else batch_mod.batch_feasible(batch).numpy())
        out.append(mask)
    assert np.array_equal(out[0], out[1])
    # the devices with k = 0, 7 and 255 match their selectors' pods
    assert out[1][[0, 7, 255], 0].all() and not out[1][1:7, 0].any()


def _dra_launch(seed: int, n_nodes: int, b: int):
    """A JAX Mirror launch of b pods over n_nodes nodes, and a DraBatch
    from the fuzz on the mirror's node bucket."""
    from tests.test_torch_pipeline import _testbed, tb_pod

    rng = random.Random(seed)
    pods = [tb_pod(i, cpu=f"{rng.choice([100, 500, 2000])}m")
            for i in range(b)]
    mirror, spec, caps = _testbed(n_nodes, pods, b)
    n_cap = caps.nodes
    f = dra_fuzz(np.random.default_rng(seed), n_nodes, n_cap, 16, 2,
                 spec.pblobs.f32.shape[0])
    return mirror, spec, caps, f


@pytest.mark.parametrize("serial_scan", [False, True])
@pytest.mark.parametrize("with_host", [False, True])
def test_launch_fuses_dra_as_the_reference(serial_scan, with_host):
    mirror, spec, caps, f = _dra_launch(3 + with_host, 40, 24)
    spec.dra = JD.DraBatch(**{k: f[k] for k in FIELDS})
    host = f["host_ok"] if with_host else None
    jout = JP.launch_batch(spec, mirror.well_known(), JP.default_weights(),
                           caps, serial_scan=serial_scan, host_ok=host,
                           tie_seed=np.uint32(5))
    tspec = port_spec(spec)
    tspec.dra = _port_batch(f)
    weights = convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})
    tout = TP.launch_batch(tspec, mirror.well_known(), weights,
                           port_caps(caps), serial_scan=serial_scan,
                           host_ok=host, tie_seed=5, device="cpu")
    for fld in ("node_row", "feasible_count", "reject_counts",
                "unresolvable_count", "free", "nzr", "guard",
                "dra_reject"):
        want, got = np.asarray(getattr(jout, fld)), getattr(tout, fld)
        assert np.array_equal(want, got.numpy()), fld
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score),
                               rtol=0, atol=1e-4)
    assert np.asarray(jout.dra_reject).any()
    assert (np.asarray(jout.node_row)[:24] >= 0).any()


def test_launch_without_dra_reports_zero_rejects():
    mirror, spec, caps, _f = _dra_launch(9, 20, 8)
    weights = convert.weights_from_numpy(
        {k: np.asarray(v) for k, v in vars(JP.default_weights()).items()})
    tout = TP.launch_batch(port_spec(spec), mirror.well_known(), weights,
                           port_caps(caps), serial_scan=False, device="cpu")
    assert tout.dra_reject.shape == (spec.pblobs.f32.shape[0],)
    assert not tout.dra_reject.any()
