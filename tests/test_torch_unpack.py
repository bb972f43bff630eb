"""K13, the blob unpack, in the port, held against the JAX package on the
CPU: its twin (through the kernel's wrapper, which routes CPU tensors to
it) against the reference's ``extract_state_jit``, ``_unpack_cluster_jit``
and ``_unpack_pods_jit`` field by field on the same blobs; the port's
``Mirror.to_device`` / ``pack_batch`` / ``extract_state`` against the
reference's on the clusters of tests/test_torch_ops.py (the golden tables
of tests/test_kernels.py and tests/test_golden_more.py, and seeded fuzz);
the seed filling its launch in place of a copy, held by nothing else
after it; the prepared launch (the layout of ``_plan``, its pointers
refreshed and a new allocation each call); and the C argument structs
against their ctypes mirrors. Every comparison is bit for bit (tolerance
zero)."""

import copy
import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.backend.cache import Cache as JCache
from kubernetes_tpu.backend.mirror import Mirror as JMirror
from kubernetes_tpu.backend.mirror import _unpack_cluster_jit, _unpack_pods_jit
from kubernetes_tpu.backend.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.config.types import default_config as j_config
from kubernetes_tpu.hub import Hub as JHub
from kubernetes_tpu.models.pipeline import extract_state_jit
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu.ops.features import PodBlobs as JPodBlobs
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.testing import MakeNode, MakePod
from kubernetes_tpu_torch import scheduler as S
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.mirror import Mirror as TMirror
from kubernetes_tpu_torch.backend.snapshot import Snapshot as TSnapshot
from kubernetes_tpu_torch.config.types import default_config as t_config
from kubernetes_tpu_torch.hub import Hub as THub
from kubernetes_tpu_torch.kernels import unpack as KU
from kubernetes_tpu_torch.models import pipeline as P
from kubernetes_tpu_torch.ops.blobs import fields_ref
from kubernetes_tpu_torch.ops.features import ClusterBlobs, PodBlobs
from tests.test_torch_kernel_layout import (
    _defines,
    _same_type,
    _source,
    struct_members,
)
from tests.test_torch_ops import CASES
from tests.torch_port_support import port_caps, to_port

pytestmark = pytest.mark.torch_port


def _same(name, want, got: torch.Tensor) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape, name
    assert want.dtype == got.dtype, (name, want.dtype, got.dtype)
    if want.dtype == np.float32:
        want, got = want.view(np.uint32), got.view(np.uint32)
    assert np.array_equal(want, got), name


def _fresh(t: torch.Tensor, *blobs) -> None:
    """A contiguous tensor of its own: no storage shared with a blob."""
    assert t.is_contiguous()
    for b in blobs:
        assert t.untyped_storage().data_ptr() != b.untyped_storage(
        ).data_ptr()


def _same_struct(want, got) -> None:
    for f in dataclasses.fields(got):
        _same(f.name, getattr(want, f.name), getattr(got, f.name))


def _rig(case: str):
    """Both packages' Mirrors over one case, synced. The pods are copies
    with uids of their own: the golden tables share pod objects whose
    uids a package assigns at first use, which would give the two sides
    different strings to intern."""
    nodes, scheduled, pods = CASES[case]()
    scheduled = copy.deepcopy(scheduled)
    pods = copy.deepcopy(pods)
    for i, p in enumerate(scheduled + pods):
        p.metadata.uid = f"{case}-uid-{i}"
    n_cap = 16 if len(nodes) <= 16 else 64
    out = []
    for port in (False, True):
        conv = to_port if port else (lambda x: x)
        cache = (TCache if port else JCache)()
        for nd in nodes:
            cache.add_node(conv(nd))
        for p in scheduled:
            cache.add_pod(conv(p))
        snap = (TSnapshot if port else JSnapshot)()
        cache.update_snapshot(snap)
        m = (TMirror(caps=port_caps(JCaps(nodes=n_cap, pods=64)),
                     device="cpu") if port
             else JMirror(caps=JCaps(nodes=n_cap, pods=64)))
        m.sync(snap)
        out.append(m)
    return out[0], out[1], pods


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_to_device_matches_reference(case):
    jm, tm, _ = _rig(case)
    want, got = jm.to_device(), tm.to_device()
    _same_struct(want, got)
    blobs = tm.to_blobs()
    for f in dataclasses.fields(got):
        _fresh(getattr(got, f.name), blobs.node_f32, blobs.node_i32,
               blobs.pods_i32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_pack_batch_matches_reference(case):
    jm, tm, pods = _rig(case)
    b = max(1, len(pods))
    want = jm.pack_batch(list(pods), b)
    got = tm.pack_batch([to_port(p) for p in pods], b)
    _same_struct(want, got)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name).is_contiguous(), f.name


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_state_matches_reference(case):
    jm, tm, _ = _rig(case)
    jfree, jnzr = extract_state_jit(jm.to_blobs(), jm.caps)
    blobs = tm.to_blobs()
    seed = P.extract_state(blobs, tm.caps)
    assert isinstance(seed, KU.Seed)
    _same("free", jfree, seed[0])
    _same("nonzero_requested", jnzr, seed[1])
    for t in seed:
        _fresh(t, blobs.node_f32)


@pytest.mark.parametrize("case", ["kernels_ports_images", "fuzz_1"])
def test_twin_equals_reference_unpacks_on_the_same_blobs(case):
    """K13's twin on the reference mirror's own blobs, field by field."""
    jm, _, pods = _rig(case)
    caps = port_caps(jm.caps)
    jb = jm.to_blobs()
    tb = ClusterBlobs(**{k: torch.from_numpy(np.array(getattr(jb, k)))
                         for k in ("node_f32", "node_i32", "pods_i32")})
    _same_struct(_unpack_cluster_jit(jb, jm.caps),
                 KU.unpack_cluster(tb, caps))
    free, nzr = KU.seed(tb, caps)
    jfree, jnzr = extract_state_jit(jb, jm.caps)
    _same("free", jfree, free)
    _same("nzr", jnzr, nzr)
    pb = jm.pack_batch_blobs(list(pods), max(1, len(pods)))
    tpb = PodBlobs(f32=torch.from_numpy(np.array(pb.f32)),
                   i32=torch.from_numpy(np.array(pb.i32)))
    _same_struct(_unpack_pods_jit(JPodBlobs(f32=jnp.asarray(pb.f32),
                                            i32=jnp.asarray(pb.i32)),
                                  jm.caps),
                 KU.unpack_pods(tpb, caps))


# ------------------------------------------------ the seed in the launch

def _drain(port: bool):
    hub = THub() if port else JHub()
    conv = to_port if port else (lambda x: x)
    for i in range(6):
        hub.create_node(conv(MakeNode().name(f"node-{i}").capacity(
            cpu="8", memory="16Gi", pods="110").obj()))
    cfg = t_config() if port else j_config()
    cfg.batch_size = 8
    cfg.tie_break_seed = 11
    # without pipelined waves a foreign delete drops the chain
    cfg.pipelined_waves = False
    s = (S.Scheduler(hub, cfg, caps=port_caps(JCaps(nodes=8, pods=64)),
                     device="cpu") if port
         else JScheduler(hub, cfg, caps=JCaps(nodes=8, pods=64)))
    try:
        for wave in range(3):
            for i in range(20):
                hub.create_pod(conv(MakePod().name(f"p-{wave}-{i}").uid(
                    f"uid-{wave}-{i}").req(cpu="300m", memory="256Mi")
                    .obj()))
            s.run_until_idle()
            # a foreign delete between waves: the next launch seeds anew
            victim = sorted((p for p in hub.list_pods() if p.spec.node_name),
                            key=lambda p: p.metadata.name)[0]
            hub.delete_pod(victim.metadata.uid)
        return ({p.metadata.name: p.spec.node_name
                 for p in hub.list_pods()}, dict(s.stats))
    finally:
        s.close()


def test_seed_fills_its_launch_and_nothing_else_holds_it(monkeypatch):
    """An unchained launch takes its seed (K13's new tensors) as its
    working state, with no copy; a chained launch copies the chain; the
    seed tuple is held by nothing once its launch returned; and the
    placements equal the reference's."""
    seeds, taken = [], []
    real_seed = S.extract_state

    def spy_seed(cblobs, caps):
        seed = real_seed(cblobs, caps)
        seeds.append((seed[0].data_ptr(), seed[1].data_ptr()))
        return seed

    monkeypatch.setattr(S, "extract_state", spy_seed)
    for mod, name in ((P.KA, "RoundInputs"), (P.KS, "ScanInputs")):
        def spy(*a, _real=getattr(mod, name), **kw):
            taken.append((kw["free"].data_ptr(), kw["nzr"].data_ptr()))
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    got, stats = _drain(True)
    want, _ = _drain(False)
    assert got == want and all(want.values())
    gc.collect()
    assert len(seeds) >= 3 and stats["chained_launches"] > 0
    assert len(taken) == stats["launches"] == len(seeds) + stats[
        "chained_launches"]
    # a tuple subclass takes no weak reference: look for any live one
    assert not [o for o in gc.get_objects() if type(o) is KU.Seed]
    assert all(ptrs in taken for ptrs in seeds)


@pytest.mark.parametrize("what", ["seed", "cluster", "pods"])
def test_launch_plan_lays_out_every_field(what):
    """K13's launch plan (built on the host, whatever the device): each
    field's columns inside its blob, its bytes rows x width x (1 for a
    bool, else 4) at a 16-byte-aligned offset, the fields' ranges
    disjoint and inside the one allocation, and the views it names shaped
    as the twin's."""
    parts = _parts(what)
    args, srcs, total, fields = KU._plan(parts)
    assert args.nfields == len(fields) <= KU.MAX_FIELDS
    assert args.nsrc == len(srcs) <= KU.MAX_SRC
    end = 0
    for f, (p, name, off, nbytes, dtype, shape) in enumerate(fields):
        codec, blobs, _ = parts[p]
        kind = codec.schema[name][1]
        blob = blobs.f32 if kind == "f32" else blobs.i32
        rows = blob.numel() // blob.shape[-1]
        assert srcs[args.f_src[f]] == (p, "f32" if kind == "f32" else "i32")
        assert args.src_rows[args.f_src[f]] == rows
        assert 0 <= args.f_col[f] and args.f_col[f] + args.f_width[f] \
            <= args.src_stride[args.f_src[f]] == blob.shape[-1]
        assert off == args.f_dst[f] and off % KU.ALIGN == 0 and off >= end
        assert nbytes == rows * args.f_width[f] * (1 if kind == "bool"
                                                   else 4)
        assert args.f_bool[f] == (kind == "bool")
        want = codec.field(blobs, name)
        assert (dtype, shape) == (want.dtype, tuple(want.shape))
        end = off + nbytes
    assert end <= total


def _parts(what):
    from kubernetes_tpu_torch.ops.blobs import Blobs

    _jm, tm, pods = _rig("fuzz_1")
    node_c, table_c, pod_c = KU.codecs(tm.caps)
    cb = tm.to_blobs()
    nodes = Blobs(f32=cb.node_f32, i32=cb.node_i32)
    if what == "seed":
        return [(node_c, nodes, KU.SEED_FIELDS)]
    if what == "cluster":
        table = Blobs(f32=torch.zeros((cb.pods_i32.shape[0], 0)),
                      i32=cb.pods_i32)
        return [(node_c, nodes, tuple(node_c.schema)),
                (table_c, table, tuple(table_c.schema))]
    pb = tm.pack_batch_blobs([to_port(p) for p in pods], len(pods))
    return [(pod_c, Blobs(f32=pb.f32, i32=pb.i32), tuple(pod_c.schema))]


@pytest.mark.parametrize("what", ["seed", "cluster", "pods"])
def test_prepared_launch_keeps_the_plan_and_refreshes_pointers(what):
    """K13's prepared launch (built on the host, whatever the device): the
    fields and sources of ``_plan`` in its argument block (the small one
    for a seed); each call's source pointers written anew and a new
    allocation; the views of the allocation disjoint, contiguous, shaped
    as the twin's, and holding the twin's values once written."""
    parts = _parts(what)
    template, srcs, total, fields = KU._plan(parts)
    prep = KU.Prepared(parts)
    assert prep.fields == fields and prep.srcs == srcs
    assert isinstance(prep.args, KU._FewArgs if what == "seed"
                      else KU._UnpackArgs)
    a = prep.args
    assert (a.nsrc, a.nfields) == (template.nsrc, template.nfields)
    for name in ("f_src", "f_col", "f_width", "f_bool", "f_dst"):
        assert list(getattr(a, name))[:a.nfields] == list(
            getattr(template, name))[:a.nfields], name
    assert list(a.src_rows) == list(template.src_rows)
    blobs = [getattr(parts[p][1], kind) for p, kind in srcs]
    bufs, ptrs = [], []
    for call in range(2):
        # the second call's sources are other tensors of the same layout
        cur = blobs if call == 0 else [b.clone() for b in blobs]
        buf = prep.bind(cur)
        assert [a.src[s] for s in range(a.nsrc)] == [b.data_ptr()
                                                     for b in cur]
        assert a.dst == buf.data_ptr() and buf.numel() * \
            buf.element_size() >= total
        bufs.append(buf)
        ptrs.append(buf.data_ptr())
    assert ptrs[0] != ptrs[1]
    outs = prep.outputs(bufs[1])
    want = [fields_ref(codec, blob, names) for codec, blob, names in parts]
    for (p, name, off, nbytes, dtype, shape), t in zip(fields, outs):
        assert t.is_contiguous() and (t.dtype, tuple(t.shape)) == (dtype,
                                                                   shape)
        assert t.data_ptr() == ptrs[1] + off
        assert t.numel() * t.element_size() == nbytes
        t.copy_(want[p][name])
    for (p, name, *_), t in zip(fields, prep.outputs(bufs[1])):
        _same(name, want[p][name].numpy(), t)
    with pytest.raises(ValueError):
        prep.bind([b[:-1] for b in blobs])


def test_prepared_launch_is_kept_per_layout():
    parts = _parts("seed")
    assert KU.prepared(parts) is KU.prepared(list(parts))
    assert KU.prepared(parts) is not KU.prepared(_parts("pods"))


def test_args_struct_matches_ctypes_mirror():
    text = _source("blob_unpack.cu")
    consts = _defines(text)
    for struct, mirror in (("UnpackArgs", KU._UnpackArgs),
                           ("FewArgs", KU._FewArgs)):
        want = struct_members(text, struct, consts)
        got = list(mirror._fields_)
        assert [n for n, _ in got] == [n for n, _ in want], struct
        for (name, a), (_, b) in zip(got, want):
            assert _same_type(a, b), (struct, name, a, b)
    assert (consts["MAX_SRC"], consts["MAX_FIELDS"], consts["MAX_FEW"]) \
        == (KU.MAX_SRC, KU.MAX_FIELDS, KU.MAX_FEW)
    assert "#include <torch" not in text and "jax" not in text
