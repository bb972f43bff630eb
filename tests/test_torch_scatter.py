"""K12, the row scatter, in the port, held against the JAX package on the
CPU: its twin (through the kernel's wrapper, which routes CPU tensors to
it) against the reference's ``_scatter_rows_jit`` (the Mirror's three
blobs) and ``_scatter_rows0_jit`` (the victim cumsum's [N, K+1, C]
rows), the reference fed its pow2-padded index list and the port the
unique rows; the Mirror's incremental push against the reference's; the
wrapper refusing a broken contract; the fence that keeps the host from
repacking a row the card has not read yet; the launch's run and chunk
planner (a property test) and its ring of descriptor slots; and the C
structs against their ctypes mirrors. Inputs are made from seeds with
numpy; every comparison is bit for bit (tolerance zero)."""

import copy
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kubernetes_tpu.backend.cache import Cache as JCache
from kubernetes_tpu.backend.mirror import Mirror as JMirror
from kubernetes_tpu.backend.mirror import _scatter_rows_jit
from kubernetes_tpu.backend.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.framework.preemption import _scatter_rows0_jit
from kubernetes_tpu.ops.features import Capacities as JCaps
from kubernetes_tpu_torch.backend.cache import Cache as TCache
from kubernetes_tpu_torch.backend.mirror import Mirror as TMirror
from kubernetes_tpu_torch.backend.snapshot import Snapshot as TSnapshot
from kubernetes_tpu_torch.kernels import scatter as KSc
from kubernetes_tpu_torch.ops.features import codecs
from kubernetes_tpu_torch.ops.scatter import scatter_rows_ref
from tests.test_torch_kernel_layout import (
    _defines,
    _same_type,
    _source,
    struct_members,
)
from tests.torch_port_support import fuzz_cluster, port_caps, to_port

pytestmark = pytest.mark.torch_port

# the blobs' widths at the 4,096-node bucket (node f32 / i32, pod table)
_CODECS = codecs(port_caps(JCaps(nodes=4096, pods=4096)))
WIDTHS = {"node_f32": _CODECS[0].f32_size, "node_i32": _CODECS[0].i32_size,
          "pods_i32": _CODECS[1].i32_size}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _padded(idx: list[int]) -> np.ndarray:
    """The reference's list: sorted, padded to a power of two with the
    last row repeated (kubernetes_tpu/backend/mirror.py:982-990)."""
    k = 1
    while k < len(idx):
        k *= 2
    return np.asarray(idx + [idx[-1]] * (k - len(idx)), np.int32)


def _blob(rng, key: str, n: int) -> np.ndarray:
    if key == "node_f32":
        return rng.normal(0, 1000, (n, WIDTHS[key])).astype(np.float32)
    return rng.integers(-2**31, 2**31, (n, WIDTHS[key]), dtype=np.int64
                        ).astype(np.int32)


@pytest.mark.parametrize("k", [1, 64, 2048])
@pytest.mark.parametrize("key", sorted(WIDTHS))
def test_twin_equals_reference_scatter_rows(key, k):
    rng = np.random.default_rng(k * 7 + len(key))
    n = 4096
    buf = _blob(rng, key, n)
    host = _blob(rng, key, n)
    idx = sorted(rng.choice(n, k, replace=False).tolist())
    pad = _padded(idx)
    want = _scatter_rows_jit(jnp.asarray(buf), jnp.asarray(pad),
                             jnp.asarray(host[pad]))
    dev = torch.from_numpy(buf.copy())
    KSc.scatter_rows([KSc.Rows(dev, torch.from_numpy(host),
                               np.asarray(idx, np.int64))])
    assert np.array_equal(_bits(want), _bits(dev.numpy()))
    # the twin itself, in place on its buffer
    ref = torch.from_numpy(buf.copy())
    out = scatter_rows_ref(ref, torch.tensor(idx), torch.from_numpy(
        host[idx]))
    assert out is ref and np.array_equal(_bits(want), _bits(ref.numpy()))


def test_three_blobs_in_one_call_equal_the_reference():
    """to_blobs' three jobs in one call (one K12 launch on the card):
    node rows for the two node blobs, other slots for the pod table."""
    rng = np.random.default_rng(3)
    n = 4096
    jobs, wants = [], []
    rows = sorted(rng.choice(n, 100, replace=False).tolist())
    slots = sorted(rng.choice(n, 37, replace=False).tolist())
    for key in ("node_f32", "node_i32", "pods_i32"):
        buf, host = _blob(rng, key, n), _blob(rng, key, n)
        idx = slots if key == "pods_i32" else rows
        pad = _padded(idx)
        wants.append(_scatter_rows_jit(jnp.asarray(buf), jnp.asarray(pad),
                                       jnp.asarray(host[pad])))
        jobs.append(KSc.Rows(torch.from_numpy(buf), torch.from_numpy(host),
                             np.asarray(idx, np.int64)))
    KSc.scatter_rows(jobs)
    for job, want in zip(jobs, wants):
        assert np.array_equal(_bits(want), _bits(job.dst.numpy()))


@pytest.mark.parametrize("k", [1, 64, 2048])
@pytest.mark.parametrize("k_cap,c", [(8, 4), (16, 8)])
def test_twin_equals_reference_cumsum_scatter(k_cap, c, k):
    """The victim cumsum's rows are (K+1) * C words."""
    rng = np.random.default_rng(100 * k + k_cap)
    n = 4096
    buf = rng.normal(0, 1e6, (n, k_cap + 1, c)).astype(np.float32)
    host = rng.normal(0, 1e6, (n, k_cap + 1, c)).astype(np.float32)
    host[:, :, c - 1] = 3.0e38
    idx = sorted(rng.choice(n, k, replace=False).tolist())
    pad = _padded(idx)
    want = _scatter_rows0_jit(jnp.asarray(buf), jnp.asarray(pad),
                              jnp.asarray(host[pad]))
    dev = torch.from_numpy(buf.copy())
    KSc.scatter_rows([KSc.Rows(dev, torch.from_numpy(host),
                               np.asarray(idx, np.int64))])
    assert np.array_equal(_bits(want), _bits(dev.numpy()))


@pytest.mark.parametrize("case", ["duplicate", "negative", "past_end",
                                  "empty", "dtype", "row_shape", "device"])
def test_wrapper_refuses_a_broken_contract(case):
    buf = torch.zeros((16, 5), dtype=torch.float32)
    src = torch.ones((16, 5), dtype=torch.float32)
    idx = np.asarray([1, 4, 9], np.int64)
    jobs = []
    if case == "duplicate":
        idx = np.asarray([1, 4, 4], np.int64)
    elif case == "negative":
        idx = np.asarray([-1, 4], np.int64)
    elif case == "past_end":
        idx = np.asarray([3, 16], np.int64)
    elif case == "empty":
        idx = np.zeros((0,), np.int64)
    elif case == "dtype":
        src = src.to(torch.int32)
    elif case == "row_shape":
        src = torch.ones((16, 6), dtype=torch.float32)
    else:       # a second job on another device
        jobs.append(KSc.Rows(torch.zeros((16, 5), device="meta"),
                             torch.ones((16, 5)), idx))
    with pytest.raises(ValueError):
        KSc.scatter_rows([KSc.Rows(buf, src, idx)] + jobs)
    assert not buf.any()


# ------------------------------------------------------ the Mirror's push

def _mirrors(seed: int, n_cap: int = 64):
    nodes, bound, _ = fuzz_cluster(random.Random(seed), 40, 0, 30)
    out = []
    for port in (False, True):
        conv = to_port if port else (lambda x: x)
        cache = (TCache if port else JCache)()
        for nd in nodes:
            cache.add_node(conv(nd))
        for p in bound:
            cache.add_pod(conv(p))
        snap = (TSnapshot if port else JSnapshot)()
        cache.update_snapshot(snap)
        m = (TMirror(caps=port_caps(JCaps(nodes=n_cap, pods=256)),
                     device="cpu") if port
             else JMirror(caps=JCaps(nodes=n_cap, pods=256)))
        m.sync(snap)
        out.append((cache, snap, m, conv))
    return nodes, bound, out


def _same_blobs(jb, tb) -> None:
    for key in ("node_f32", "node_i32", "pods_i32"):
        assert np.array_equal(_bits(getattr(jb, key)),
                              _bits(getattr(tb, key).numpy())), key


@pytest.mark.parametrize("seed", [1, 2])
def test_incremental_push_matches_reference(seed):
    """A first push (whole uploads), then pod binds, deletes and a node
    removal synced and pushed as dirty rows: the port's resident blobs
    equal the reference's after each push, and the rows went through
    K12's route (one call for the three blobs)."""
    nodes, bound, arms = _mirrors(seed)
    for _c, _s, m, _v in arms:
        m.to_blobs()
    _same_blobs(arms[0][2].to_blobs(), arms[1][2].to_blobs())
    tm = arms[1][2]
    assert tm.stats["full_uploads"] == 3 and tm.stats["row_scatters"] == 0
    gone = nodes[random.Random(seed).randrange(len(nodes))]
    for step in range(3):
        for cache, snap, m, conv in arms:
            for p in bound[step::4]:
                cache.remove_pod(conv(p))
            if step == 2:
                cache.remove_node(conv(gone))
            cache.update_snapshot(snap)
            m.sync(snap)
        jb = arms[0][2].to_blobs()
        tb = arms[1][2].to_blobs()
        _same_blobs(jb, tb)
    assert tm.stats["row_scatters"] == 3
    assert tm.stats["full_uploads"] == 3
    assert tm.stats["rows_scattered"] > 0


class _Queued:
    """A stand-in for a CUDA event whose read has not finished: the first
    query says so, and synchronize records that the host waited."""

    def __init__(self):
        self.waited = 0

    def query(self):
        return False

    def synchronize(self):
        self.waited += 1


class _Done(_Queued):
    def query(self):
        return True


def test_host_fence_counts_only_blocking_waits():
    stats = {}
    fence = KSc.HostFence(stats, "x")
    assert stats == {"x_waits": 0, "x_wait_us": 0.0}
    fence.wait()                      # nothing queued
    done = _Done()
    fence.event = done
    fence.wait()
    assert done.waited == 0 and stats["x_waits"] == 0
    queued = _Queued()
    fence.event = queued
    fence.wait()
    fence.wait()                      # the event is spent
    assert queued.waited == 1 and stats["x_waits"] == 1
    assert stats["x_wait_us"] >= 0.0 and fence.event is None


@pytest.mark.parametrize("write", ["sync", "patch_node", "set_nominated",
                                   "release"])
def test_host_writes_wait_for_a_queued_read(write):
    """Every path that rewrites a host blob row waits on the mirror's
    fence first (a queued K12 or upload may still read the row). The
    nomination refresh rewrites only what changed: it drops a nomination
    made before the read was queued (its slot and its row); an unchanged
    refresh writes nothing and does not wait."""
    nodes, bound, arms = _mirrors(5)
    cache, snap, m, conv = arms[1]
    if write == "set_nominated":
        pending = copy.deepcopy(conv(bound[1]))
        pending.metadata.uid += "-pending"
        pending.spec.node_name = ""
        m.set_nominated({nodes[0].metadata.name: [pending]})
    m.to_blobs()
    queued = _Queued()
    m._fence.event = queued
    if write == "sync":
        cache.remove_pod(conv(bound[0]))
        cache.update_snapshot(snap)
        m.sync(snap)
    elif write == "patch_node":
        name = nodes[0].metadata.name
        m.patch_node(name, cache.node_info(name))
    elif write == "set_nominated":
        m.set_nominated({})
        unchanged = _Queued()
        m._fence.event = unchanged
        m.set_nominated({})
        assert unchanged.waited == 0
        m._fence.event = None
    else:
        m._release_pod_slot(next(iter(m._pod_slot)))
    assert queued.waited == 1
    assert m.stats["fence_waits"] == 1


def test_args_struct_matches_ctypes_mirror():
    text = _source("row_scatter.cu")
    for struct, mirror in (("ScatterArgs", KSc._ScatterArgs),
                           ("ScatterJob", KSc._ScatterJob)):
        want = struct_members(text, struct, _defines(text))
        got = list(mirror._fields_)
        assert [n for n, _ in got] == [n for n, _ in want], struct
        for (name, a), (_, b) in zip(got, want):
            assert _same_type(a, b), (struct, name, a, b)
    consts = _defines(text)
    assert consts["MAX_BUFS"] == KSc.MAX_BUFS
    assert consts["CHUNK_WORDS"] == KSc.CHUNK_WORDS
    codes = dict(re.findall(r"^#define\s+(ERR_\w+)\s+\((-\d+)\)", text,
                            re.M))
    assert (int(codes["ERR_ORDER"]), int(codes["ERR_RANGE"])) == (
        KSc.ERR_ORDER, KSc.ERR_RANGE)
    assert "#include <torch" not in text and "jax" not in text


# ------------------------------------------------ the launch's work list

@st.composite
def _planner_jobs(draw):
    """1 to MAX_BUFS jobs: sorted unique rows of a buffer of m rows (runs
    and gaps), a width around CHUNK_WORDS' multiples, packed or strided
    rows, 4-byte-aligned base addresses."""
    jobs = []
    for _ in range(draw(st.integers(1, KSc.MAX_BUFS))):
        m = draw(st.integers(1, 400))
        rows = draw(st.sets(st.integers(0, m - 1), min_size=1))
        width = draw(st.sampled_from([1, 3, 74, 275, 717, 1019, 1020, 1021,
                                      2868, 5000]))
        ss = width + draw(st.sampled_from([0, 0, 0, 1, 7]))
        ds = width + draw(st.sampled_from([0, 0, 0, 2]))
        base = draw(st.tuples(st.integers(0, 1 << 36),
                              st.integers(0, 1 << 36)))
        jobs.append((np.asarray(sorted(rows), np.int64), width, ss, ds,
                     4 * base[0], 4 * base[1]))
    return jobs


@settings(max_examples=300, deadline=None, database=None)
@given(_planner_jobs())
def test_chunk_planner_covers_every_row_once_in_maximal_runs(jobs):
    """plan_chunks (the launch entry's planner, row_scatter_plan, is held
    to it on the card): the chunks of each span tile it exactly, in
    order, each at most CHUNK_WORDS words and only the last one shorter;
    every dirty row's words are covered once, by the same offsets in the
    source and the destination; a span of packed rows is a maximal run
    of consecutive rows, and a strided row is its own span."""
    chunks = KSc.plan_chunks(jobs)
    assert chunks.dtype == np.int64 and chunks.shape[1] == 3
    at = 0
    for idx, width, ss, ds, sb, db in jobs:
        packed = ss == width and ds == width
        first, lens = KSc.runs_of(idx)
        if packed:
            # maximal: consecutive inside, a gap between two runs
            assert lens.sum() == idx.size
            assert (first[1:] > first[:-1] + lens[:-1]).all()
            spans = list(zip(first.tolist(), lens.tolist()))
        else:
            spans = [(r, 1) for r in idx.tolist()]
        covered = []
        for row, n in spans:
            words = n * width
            k = -(-words // KSc.CHUNK_WORDS)
            part = chunks[at:at + k]
            at += k
            off = (part[:, 0] - sb - 4 * ss * row) // 4
            assert (part[:, 1] - db - 4 * ds * row == 4 * off).all()
            assert off.tolist() == [KSc.CHUNK_WORDS * i for i in range(k)]
            assert (part[:-1, 2] == KSc.CHUNK_WORDS).all()
            assert 1 <= part[-1, 2] <= KSc.CHUNK_WORDS
            assert part[:, 2].sum() == words
            covered += [row + w // width for w in range(0, words, width)]
        assert covered == idx.tolist()
    assert at == chunks.shape[0]


@pytest.mark.parametrize("case", ["sorted", "unsorted", "one"])
def test_check_rows_returns_the_sorted_rows(case):
    idx = {"sorted": [0, 3, 4, 9], "unsorted": [9, 0, 4, 3],
           "one": [5]}[case]
    got = KSc.check_rows(np.asarray(idx, np.int64), 10)
    assert got.tolist() == sorted(idx)
    # the CPU route scatters an unsorted list as the sorted one
    buf = torch.zeros((10, 3), dtype=torch.int32)
    src = torch.arange(30, dtype=torch.int32).reshape(10, 3)
    KSc.scatter_rows([KSc.Rows(buf, src, np.asarray(idx, np.int64))])
    want = torch.zeros_like(buf)
    want[sorted(idx)] = src[sorted(idx)]
    assert torch.equal(buf, want)


class _FakeSlot:
    """A ring slot whose launch has passed (free) or not; its rows; its
    event's host waits."""

    def __init__(self, rows, free):
        self.rows, self._free, self.waited = rows, free, 0
        self.event = self

    def free(self):
        return self._free

    def synchronize(self):
        self.waited += 1
        self._free = True


def test_descriptor_ring_reuses_a_slot_only_after_its_launch(monkeypatch):
    """_slot takes the ring's oldest slot once its launch has passed (made
    anew where it is too small); while the oldest is busy (and so every
    slot, launches on one stream finishing in order) a new slot joins as
    the newest; a full ring waits for its oldest; in_flight counts the
    busy slots."""
    made = []

    def new_slot(n):
        made.append(n)
        return _FakeSlot(max(n, KSc.SLOT_ROWS), False)

    monkeypatch.setattr(KSc, "_Slot", new_slot)
    monkeypatch.setattr(KSc, "_RING", [])
    monkeypatch.setattr(KSc, "_NEXT", [0])
    a = KSc._slot(10)                   # empty ring: a new slot
    b = KSc._slot(10)                   # a busy: b joins before it
    assert KSc._RING == [b, a] and made == [10, 10]
    assert KSc.in_flight() == 2
    a._free = True
    assert KSc._slot(10) is a           # the oldest, passed
    assert KSc.in_flight() == 1
    b._free = True
    c = KSc._slot(5000)                 # b passed, too small: made anew
    assert KSc._RING == [c, a] and made == [10, 10, 5000]
    monkeypatch.setattr(KSc, "RING_MAX", 2)
    a._free = c._free = False
    assert KSc._slot(10) is a and a.waited == 1   # full: waits for a
    assert len(KSc._RING) == 2


def test_mapped_address_is_resolved_once_while_its_tensor_lives(
        monkeypatch):
    """_mapped resolves a pinned source's device address once and reuses
    it while that tensor lives with the same data; the entry goes with
    the tensor, so a later tensor that is not pinned (wherever its data
    lies) is refused with ValueError, never given a stale address."""
    resolved = []

    def device_pointer(p):
        resolved.append(p)
        return p + 1

    monkeypatch.setattr(KSc, "_device_pointer", device_pointer)
    monkeypatch.setattr(KSc, "_MAPPED", {})
    src = torch.zeros((8, 3), dtype=torch.int32)
    src.is_pinned = lambda: True        # stands in for pinned memory
    p = src.data_ptr()
    assert KSc._mapped(src) == p + 1 and KSc._mapped(src) == p + 1
    assert resolved == [p] and len(KSc._MAPPED) == 1
    src.set_(torch.zeros((8, 3), dtype=torch.int32))   # new data: resolved
    assert KSc._mapped(src) == src.data_ptr() + 1
    assert resolved == [p, src.data_ptr()] and len(KSc._MAPPED) == 1
    del src
    assert KSc._MAPPED == {}
    with pytest.raises(ValueError, match="not pinned"):
        KSc._mapped(torch.zeros((8, 3), dtype=torch.int32))
    assert len(resolved) == 2 and KSc._MAPPED == {}
