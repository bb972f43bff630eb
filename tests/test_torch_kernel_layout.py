"""The ctypes mirrors of K3's, K2a's, K9's, K7a's, K10's, K1's and K8's
argument structs (K2a's and K3's with their export outputs), K3's, K7a's,
K1's and K8's shared-memory planners (kernels/scan.py plan_scan,
kernels/gang.py plan_pack, kernels/phase1.py plan_phase1 and staging,
kernels/dra.py plan_dra), K3's choice of its narrow instantiation and
K8's one remaining limit.

The kernels read their arguments as C structs (csrc/serial_scan.cu
ScanArgs, csrc/auction_score_argmax.cu AuctionArgs, csrc/learned_mlp.cuh
LearnedNet, csrc/gang_pack.cu PackArgs) that the wrappers fill through
ctypes structures: a member out of order or of another type there is a
wrong pointer on the card, which no CPU test would see. These tests parse
the members from the sources and hold them, in name, type and order,
against the ctypes ``_fields_``; and the planned arrays' names against
the kernels' PA_* and PO_* enums.

K3's planner is held on the shapes of every chip_smoke.py K3 workload
(the three hard drains, MixedSchedulingBasePod's init scans, the pct
window, the port-clash launches, K3 + K9 with the drain's (8,) scorer,
the largest narrow stack and the (256, 256) wide scorer): every byte
offset inside the block's 227 KB (232,448 bytes), aligned and disjoint,
the node-space carries in shared memory, K9's bytes (learned_smem_floats:
the narrow stack or the wide path's slabs) at the front, and no refusal
of shapes the previous cooperative-grid wrapper served (large N, G1 = B,
ports). The fixed front of the layout is evaluated from the kernel's own
source. K7a's planner is held on phase 15's shapes (8 and 64 zones,
tk = -1, the 16,384 bucket) and on shapes past shared memory, which it
leaves in global memory instead of refusing.

K3 keeps each hard spread constraint's minimum up to date at every commit
(rows of at most SMALL_D domains) instead of taking it over the domains
every step; a model of that rule is held against the twin's full masked
minimum over seeded commit sequences.
"""

from __future__ import annotations

import ctypes
import os
import re

import pytest

import tests.torch_port_support  # noqa: F401  (thread cap)
from kubernetes_tpu_torch.kernels import auction as KA
from kubernetes_tpu_torch.kernels import chain as KC
from kubernetes_tpu_torch.kernels import dra as KD
from kubernetes_tpu_torch.kernels import gang as KG
from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.kernels import phase1 as K1
from kubernetes_tpu_torch.kernels import preempt as KP
from kubernetes_tpu_torch.kernels import scan as KS
from kubernetes_tpu_torch.kernels import soft as KSoft
from kubernetes_tpu_torch.learn.train import init_params
from kubernetes_tpu_torch.ops.features import Capacities, codecs

pytestmark = pytest.mark.torch_port

CSRC = os.path.join(os.path.dirname(KS.__file__), "..", "csrc")

_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "long": ctypes.c_long, "uint8_t": ctypes.c_uint8,
           "unsigned int": ctypes.c_uint, "LearnedNet": KL.LearnedNet}


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name), encoding="utf-8") as fh:
        text = fh.read()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _defines(text: str) -> dict:
    """The integer macros of a source, plain numbers and sums of them."""
    out = {k: int(v) for k, v in
           re.findall(r"^#define\s+(\w+)\s+(\d+)\s*$", text, re.M)}
    for k, expr in re.findall(r"^#define\s+(\w+)\s+\(([\w\s+*]+)\)",
                              text, re.M):
        out[k] = eval(expr, {"__builtins__": {}}, dict(out))  # noqa: S307
    return out


def struct_members(text: str, name: str, consts: dict) -> list:
    """[(member, ctypes type)] of ``struct name { ... };`` in C source
    text: pointers as c_void_p, arrays as ctypes arrays."""
    body = re.search(r"struct\s+" + name + r"\s*\{(.*?)\};", text, re.S)
    assert body, f"struct {name} not found"
    out = []
    for decl in body.group(1).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.match(r"((?:const\s+)?(?:unsigned\s+)?\w+)\s*(\*?)\s*(.*)$",
                     decl)
        base, star, rest = m.groups()
        base = base.replace("const ", "")
        for part in rest.split(","):
            part = part.strip()
            ptr = bool(star) or part.startswith("*")
            part = part.lstrip("* ")
            am = re.match(r"(\w+)\s*(?:\[([^\]]+)\])?$", part)
            assert am, f"unparsed member {part!r} of {name}"
            member, dim = am.groups()
            ctype = ctypes.c_void_p if ptr else _CTYPES[base]
            if dim is not None:
                n = sum(int(t) if t.isdigit() else consts[t]
                        for t in (x.strip() for x in dim.split("+")))
                ctype = ctype * n
            out.append((member, ctype))
    return out


def _same_type(a, b) -> bool:
    if issubclass(a, ctypes.Array) or issubclass(b, ctypes.Array):
        return (issubclass(a, ctypes.Array) and issubclass(b, ctypes.Array)
                and a._length_ == b._length_ and a._type_ is b._type_)
    return a is b


@pytest.mark.parametrize("source,struct,mirror", [
    ("serial_scan.cu", "ScanArgs", KS._ScanArgs),
    ("auction_score_argmax.cu", "AuctionArgs", KA._AuctionArgs),
    ("auction_accept_commit.cu", "CommitArgs", KA._CommitArgs),
    ("soft_scores.cu", "SoftArgs", KSoft._SoftArgs),
    ("learned_train.cu", "TrainArgs", KL._TrainArgs),
    ("chain_patch.cu", "ChainArgs", KC._ChainArgs),
    ("preempt_feasible.cu", "FoldArgs", KP._FoldArgs),
    ("preempt_sweep.cu", "SweepArgs", KP._SweepArgs),
    ("preempt_sweep.cu", "SweepPlan", KP._SweepPlan),
    ("gang_capacity.cu", "CapArgs", KG._CapArgs),
    ("auction_score_argmax.cu", "ExportPlan", KA._ExportPlan),
])
def test_args_struct_matches_ctypes_mirror(source, struct, mirror):
    text = _source(source)
    consts = _defines(text)
    consts["PA_COUNT"] = len(KS.PLACED)
    want = struct_members(text, struct, consts)
    got = list(mirror._fields_)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert _same_type(a, b), (name, a, b)


def test_learned_net_mirror_matches_header():
    text = _source("learned_mlp.cuh")
    want = struct_members(text, "LearnedNet", _defines(text))
    got = list(KL.LearnedNet._fields_)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert _same_type(a, b), (name, a, b)
    assert "dims" in dict(got) and dict(got)["dims"] is ctypes.c_void_p


def test_learned_constants_match_header():
    consts = _defines(_source("learned_mlp.cuh"))
    assert consts["LEARNED_FEATURES"] == KL.LN.NUM_FEATURES
    for name in ("NARROW_MAX", "NARROW_FLOATS", "PAIRS", "SLAB_SHARED_MAX"):
        assert consts["LEARNED_" + name] == getattr(KL, name), name
    probe = _defines(_source("learned_mlp.cu"))
    assert probe["THREADS"] == KL.PROBE_THREADS
    # K2a's largest narrow class, as its wrapper passes it (K3 and the
    # probe take LEARNED_NARROW_MAX)
    bid = _defines(_source("auction_score_argmax.cu"))
    assert bid["K9_NARROW"] == KA.K9_NARROW and bid["MAX_P"] == KA.MAX_P


def test_pack_args_mirror_matches_kernel():
    text = _source("gang_pack.cu")
    consts = _defines(text)
    consts["PO_COUNT"] = len(KG.PLACED)
    want = struct_members(text, "PackArgs", consts)
    got = list(KG._PackArgs._fields_)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert _same_type(a, b), (name, a, b)
    body = re.search(r"enum\s*\{(.*?)\};", text, re.S)
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    assert names[-1] == "PO_COUNT"
    assert [n[3:].lower() for n in names[:-1]] == list(KG.PLACED)
    for name in ("MAX_THREADS", "MAX_CLUSTER", "MIN_CLUSTER", "SMEM_MAX"):
        assert consts[name] == getattr(KG, name), name
    assert consts["KEY_STRIDE"] == KG.HIST_BINS
    fixed = re.search(r"#define FIXED_BYTES \((.*)\)\s*$", text,
                      re.M).group(1).replace("/", "//")
    assert eval(fixed, {"__builtins__": {}}, consts) == KG.FIXED_BYTES  # noqa: S307


def _c_domain_bytes(d: int) -> int:
    """csrc/gang_pack.cu's dom_layout(D).bytes, from its source."""
    body = re.search(r"DomLayout dom_layout\(int D\)\s*\{(.*?)return L;",
                     _source("gang_pack.cu"), re.S).group(1)
    p2 = 1
    while p2 < d:
        p2 *= 2
    env = {"D": d, "p2": p2, "a16": lambda x: (x + 15) & ~15}
    return sum(eval(e, {"__builtins__": {}}, env)  # noqa: S307
               for e in re.findall(r"o \+= ([^;]+);", body))


@pytest.mark.parametrize("d", [1, 8, 16, 128, 1000, 16385])
def test_domain_bytes_match_kernel(d):
    assert KG.domain_bytes(d) == _c_domain_bytes(d)


def _check_pack_plan(plan: KG.PackPlan, n: int, r: int, d: int) -> None:
    assert plan.per % 32 == 0 and plan.per * plan.cluster >= n
    assert 128 <= plan.threads <= KG.MAX_THREADS and plan.threads % 32 == 0
    assert KG.FIXED_BYTES <= plan.smem_bytes <= KG.SMEM_MAX
    sizes = {"domain": KG.domain_bytes(d), "capn": plan.per * 4,
             "dom": plan.per * 4, "free": plan.per * r * 4,
             "nzr": plan.per * 8, "nom": plan.per * r * 4}
    spans = sorted((o, name) for name, o in zip(KG.PLACED, plan.off)
                   if o >= 0)
    for (off, name), nxt in zip(spans, spans[1:] + [(plan.smem_bytes, "")]):
        assert off % 16 == 0 and off >= KG.FIXED_BYTES, name
        assert off + sizes[name] <= nxt[0], (name, nxt[1])


# phase 15's launches: (nodes bucket, domains d_cap) as the mirror's
# gang_pack_domain gives them for 8 zones, 64 zones, no zone label (tk =
# -1) and 8 zones at 10,000 nodes
PACK_SHAPES = (("8 zones", 8192, 16), ("64 zones", 8192, 128),
               ("tk=-1", 8192, 8), ("8 zones, 10k", 16384, 16))


@pytest.mark.parametrize("cluster", KG.CLUSTERS)
@pytest.mark.parametrize("name,n,d", PACK_SHAPES,
                         ids=[s[0] for s in PACK_SHAPES])
def test_pack_plan_fits_phase_15(name, n, d, cluster):
    plan = KG.plan_pack(n, 8, d, cluster)
    _check_pack_plan(plan, n, 8, d)
    assert plan.global_arrays == (), plan
    assert KG.plan_pack(n, 8, d, cluster) == plan


@pytest.mark.parametrize("n,r,d", [(1 << 21, 8, 16), (8192, 8, 1 << 16),
                                   (65536, 74, 16), (64, 1, 1)])
def test_pack_plan_never_refuses_a_shape(n, r, d):
    """Past shared memory the planner leaves arrays in global memory (the
    kernel reads them there; LAUNCHES["gang_pack_global"] counts the
    launch), in priority order: the read-only nominated rows first."""
    for cluster in KG.CLUSTERS:
        plan = KG.plan_pack(n, r, d, cluster)
        _check_pack_plan(plan, n, r, d)
        placed = dict(zip(KG.PLACED, plan.off))
        if plan.global_arrays and placed["domain"] >= 0:
            assert placed["nom"] < 0


def test_commit_and_soft_constants_match_kernels():
    commit = _defines(_source("auction_accept_commit.cu"))
    assert commit["THREADS"] == KA.COMMIT_THREADS
    assert commit["THREADS"] // 32 == KA.COMMIT_WARPS
    assert _defines(_source("soft_scores.cu"))["THREADS"] == \
        KSoft.SOFT_THREADS


def _check_commit_plan(plan: KA.CommitPlan, n: int, b: int, multi: bool,
                       sms: int) -> None:
    """K2b's plan: slices of a multiple of 8 nodes covering the nodes with
    one block each, about one block an SM; a K-accept block's counts,
    offsets and (where shared) its B-entry list inside its dynamic shared
    memory; the global scratch a list of B entries a block."""
    assert plan.slice % 8 == 0 and plan.slice * plan.blocks >= n
    assert (plan.blocks - 1) * plan.slice < n
    assert plan.slice <= KA.MAX_SLICE
    assert plan.blocks <= max(sms, 1) or plan.slice in (8, KA.MAX_SLICE)
    if n >= 8 * sms:
        assert plan.blocks > sms // 2
    assert plan.smem_bytes <= 232448
    if not multi:
        assert plan.smem_bytes == plan.slice * 4 and plan.list_shared
        return
    front = (KA.COMMIT_WARPS * plan.slice + plan.slice + 1) * 4
    if plan.list_shared:
        assert plan.smem_bytes == front + 4 * b and plan.scratch_ints == 0
    else:
        assert plan.smem_bytes == front
        assert plan.scratch_ints == plan.blocks * max(b, 1)


# every K2b launch chip_smoke.py drives: (nodes bucket, batch, K-accept):
# SchedulingBasic and the drains at 8,192 (batch 4,096 or 2,048), phase 4
# and phase 10's B > N launches over 1,024 nodes, the preemption, gang
# and DRA drains' buckets, the edge cases of perf.fuzz.accept_cases
COMMIT_SHAPES = ((8192, 4096, False), (8192, 2048, False),
                 (1024, 4096, True), (1024, 2048, True), (16384, 4096, False),
                 (256, 256, False), (128, 512, True), (64, 64, False),
                 (16, 64, True), (8, 8, False))


@pytest.mark.parametrize("n,b,multi", COMMIT_SHAPES)
def test_commit_plan_fits_every_chip_smoke_launch(n, b, multi):
    plan = KA.plan_commit(n, b, multi)
    _check_commit_plan(plan, n, b, multi, KA.H100_SMS)
    assert plan.list_shared
    if n == 8192:
        assert (plan.slice, plan.blocks) == (64, 128)


@pytest.mark.parametrize("n,b,sms", [(1 << 20, 4096, 132), (8192, 1 << 16,
                                     132), (3, 1 << 20, 132), (1, 1, 1),
                                     (50000, 70000, 114)])
def test_commit_plan_never_refuses_a_shape(n, b, sms):
    """Past LIST_SMEM_MAX a K-accept block keeps its list in the global
    scratch (LAUNCHES["auction_accept_commit_global"] counts the launch);
    no shape is refused."""
    for multi in (False, True):
        plan = KA.plan_commit(n, b, multi, sms)
        _check_commit_plan(plan, n, b, multi, sms)
        if multi:
            assert plan.list_shared == (4 * b <= KA.LIST_SMEM_MAX)


def _check_soft_plan(plan: KSoft.SoftPlan, g, n, a, c, d) -> None:
    lists = (2 + 2 * 3 * (a + g * a)) * 4
    maps = (4 * g * a + g * c) * d * 4
    assert plan.items == g * -(-n // KSoft.SOFT_THREADS)
    if plan.maps_shared:
        assert plan.smem_bytes == maps + lists <= KSoft.MAPS_SMEM_MAX
    else:
        assert plan.smem_bytes == lists and maps + lists > \
            KSoft.MAPS_SMEM_MAX
    assert plan.smem_bytes <= 232448


# every K4 launch chip_smoke.py drives: (groups, nodes, A, C, domains):
# the zone / rack soft drains and phase 10's first launch (D = 8, up to 16
# groups), MixedSchedulingBasePod and phase 10's second launch (hostname,
# D = 8,192), phase 10's B > N launch (D = 1,024); phase 10b's two plans,
# launched there in turns: both past the default 48 KB of dynamic shared
# memory, of different sizes
SOFT_PAST_48K = ((40, 2048, 8, 8, 8), (36, 2048, 8, 8, 8))
SOFT_SHAPES = (((2, 8192, 4, 4, 8), True), ((8, 8192, 4, 4, 8), True),
               ((16, 8192, 4, 4, 8), True), ((8, 8192, 4, 4, 8192), False),
               ((16, 8192, 4, 4, 8192), False),
               ((8, 1024, 4, 4, 1024), False)) \
    + tuple((dims, True) for dims in SOFT_PAST_48K)


@pytest.mark.parametrize("dims,shared", SOFT_SHAPES)
def test_soft_plan_fits_every_chip_smoke_launch(dims, shared):
    plan = KSoft.plan_soft(*dims)
    _check_soft_plan(plan, *dims)
    assert plan.maps_shared == shared


def test_soft_plans_of_phase_10b_pass_48k_by_different_amounts():
    plans = [KSoft.plan_soft(*dims) for dims in SOFT_PAST_48K]
    assert all(p.maps_shared and p.smem_bytes > 48 * 1024 for p in plans)
    assert plans[0].smem_bytes != plans[1].smem_bytes


@pytest.mark.parametrize("dims", [(64, 1 << 20, 8, 8, 1 << 16),
                                  (1, 1, 1, 1, 1), (32, 8192, 4, 4, 8),
                                  (4, 100000, 4, 4, 64)])
def test_soft_plan_never_refuses_a_shape(dims):
    """Past MAPS_SMEM_MAX the maps stay in global memory (the kernel reads
    and adds there; LAUNCHES["soft_scores_global"] counts the launch)."""
    _check_soft_plan(KSoft.plan_soft(*dims), *dims)


def test_placed_arrays_match_kernel_enum():
    body = re.search(r"enum\s*\{(.*?)\};", _source("serial_scan.cu"), re.S)
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    assert names[-1] == "PA_COUNT"
    assert [n[3:].lower() for n in names[:-1]] == list(KS.PLACED_NAMES)


def test_layout_constants_match_kernel():
    consts = _defines(_source("serial_scan.cu"))
    for name in ("MAX_THREADS", "MAX_WARPS", "RF", "RI",
                 "SLOT_WORDS", "BEST_HEAD", "MAX_CLUSTER", "ALT_K"):
        assert consts[name] == getattr(KS, name), name


# ------------------------------------------------------------ the planner

def _k9_floats(hidden) -> int:
    """K9's shared floats in a K3 block (learned_smem_floats over
    K9_WARPS warps) for a scorer of these hidden widths."""
    lp = KL.LearnedParams.pack(init_params(0, hidden), "cpu")
    return KL.smem_floats(KL.net_of(lp, KS.K9_WARPS), KS.K9_WARPS)


# K9 in K3: the drain's (8,) scorer, the largest narrow stack and the
# (256, 256) wide scorer (its slabs in shared memory)
_NARROW_LF = _k9_floats((8,))
_CAP_LF = _k9_floats((32,) * 16)
_WIDE_LF = _k9_floats((256, 256))


def _topo(n=8192, g=2, d=8, g1=None, ports=False, r=8):
    return {"N": n, "R": r, "G1": g if g1 is None else g1, "G": g, "A": 4,
            "C": 4, "TK": 8, "D": d, "ports": ports}


def _plain(n=8192, g1=1, ports=False, r=8):
    return {"N": n, "R": r, "G1": g1, "G": 0, "A": 0, "C": 0, "TK": 0,
            "D": 0, "ports": ports}


# the K3 workloads of chip_smoke.py (their dims as the port's Mirror sets
# them: node bucket 8,192, R = 8, A = 4, C = 4, TK = 8): name, dims, the
# learned floats, the carries that may stay in global memory
WORKLOADS = (
    ("TopologySpreading", _topo(d=8), 0, ()),
    ("SchedulingPodAntiAffinity", _topo(d=8192), 0, ("live",)),
    ("SchedulingPodAffinity", _topo(d=8), 0, ()),
    ("MixedSchedulingBasePod init", _topo(g=8, d=8192), 0, ("live",)),
    ("SchedulingBasic pct window", _plain(g1=2), 0, ()),
    ("pct window, per-pod phase 1", _plain(g1=4096), 0, ()),
    ("3c topology + ports", _topo(g=4, d=8192, ports=True), 0, ("live",)),
    ("3c no-topology ports", _plain(g1=8, ports=True), 0, ()),
    ("10d soft-only", _topo(g=8, d=8), 0, ()),
    ("K3 + K9 (8,)", _topo(d=8), _NARROW_LF, ()),
    ("K3 + K9 (8,), pct", _plain(g1=2), _NARROW_LF, ()),
    ("K3 + K9 largest narrow", _topo(d=8), _CAP_LF, ()),
    ("K3 + K9 largest narrow, pct", _plain(g1=2), _CAP_LF, ()),
    ("K3 + K9 (256, 256)", _topo(d=8), _WIDE_LF, ()),
)


def test_k9_bytes_sit_at_the_front_of_k3():
    """plan_scan counts K9's shared bytes: the narrow stack and its widths,
    or the wide path's 16 slabs (none when they are global)."""
    assert 0 < _NARROW_LF < _CAP_LF and _WIDE_LF * 4 <= KL.SLAB_SHARED_MAX
    dims = _topo(d=8)
    base = KS.plan_scan(dims, 0, 16)
    for lf in (_NARROW_LF, _CAP_LF, _WIDE_LF):
        plan = KS.plan_scan(dims, lf, 16)
        assert plan.fixed_bytes - base.fixed_bytes == lf * 4
    assert _k9_floats((1024,)) == 0    # its slabs go to global scratch


def _check_plan(plan: KS.ScanPlan, dims: dict, lf: int) -> None:
    assert 0 < plan.smem_bytes <= KS.SMEM_MAX
    assert plan.fixed_bytes == KS.fixed_layout(lf, dims["G"], dims["A"],
                                               dims["C"], dims["TK"],
                                               dims["R"], dims.get("X", 0))
    assert plan.fixed_bytes <= plan.smem_bytes
    assert 32 <= plan.threads <= KS.MAX_THREADS and plan.threads % 32 == 0
    assert plan.per % 32 == 0 and plan.per * plan.cluster >= dims["N"]
    spans = []
    for name, off in zip(KS.PLACED_NAMES, plan.off):
        if off < 0:
            continue
        assert off % 16 == 0 and off >= plan.fixed_bytes, name
        spans.append((off, name))
    spans.sort()
    # disjoint and inside: each placed array ends before the next begins
    ends = {}
    fresh = KS.plan_scan(dims, lf, plan.cluster)
    assert fresh == plan
    val = {"G": dims["G"], "GA": dims["G"] * dims["A"],
           "GC": dims["G"] * dims["C"], "G1": dims["G1"], "R": dims["R"],
           "TK": dims["TK"], "A": dims["A"], "C": dims["C"],
           "4GAG": 4 * dims["G"] ** 2 * dims["A"],
           "GCG": dims["G"] ** 2 * dims["C"],
           "GCD": dims["G"] * dims["C"] * dims["D"],
           "PORTS": int(dims["ports"])}
    for name, es, _, shape in KS.PLACED:
        if isinstance(shape, tuple):
            k, j = (val[x] if isinstance(x, str) else x for x in shape)
            ends[name] = k * plan.per * j * es
        else:
            ends[name] = val[shape] * es
    for (off, name), nxt in zip(spans, spans[1:] + [(plan.smem_bytes, "")]):
        assert ends[name] > 0, name
        assert off + ends[name] <= nxt[0], (name, nxt[1])


@pytest.mark.parametrize("cluster", KS.CLUSTERS)
@pytest.mark.parametrize("name,dims,lf,may_be_global", WORKLOADS,
                         ids=[w[0] for w in WORKLOADS])
def test_plan_fits_every_chip_smoke_workload(name, dims, lf, may_be_global,
                                             cluster):
    plan = KS.plan_scan(dims, lf, cluster)
    _check_plan(plan, dims, lf)
    # the node-space carries and the chain rows stay in shared memory on
    # the 16-block cluster; what falls back is named by the plan (and
    # counted at launch: LAUNCHES["serial_scan_global_carries"])
    if cluster == 16:
        assert set(plan.global_carries) <= set(may_be_global), \
            plan.global_carries
    placed = dict(zip(KS.PLACED_NAMES, plan.off))
    for carry in ("free", "nzr"):
        assert placed[carry] >= 0 or cluster == 8
    if dims["G"] == 0:
        assert all(placed[n] < 0 for n, _, kind, _ in KS.PLACED
                   if kind in ("table", "domain")), placed
    assert plan.layout == ("shared" if not plan.global_carries else
                           "global:" + ",".join(plan.global_carries))


@pytest.mark.parametrize("dims,lf", [
    (_plain(n=1 << 21, g1=4096, ports=True), _CAP_LF),
    (_topo(n=1 << 20, g=64, d=1 << 20, g1=4096, ports=True, r=32), _CAP_LF),
    (_topo(n=16384, g=16, d=16384), 0),
    (_plain(n=64, g1=1), 0),
])
def test_plan_never_refuses_a_shape(dims, lf):
    """The previous wrapper served any N (a cooperative grid over the
    card); the planner lays out every shape inside a block, leaving what
    does not fit in global memory."""
    for cluster in KS.CLUSTERS:
        plan = KS.plan_scan(dims, lf, cluster)
        _check_plan(plan, dims, lf)


# a front of 25,668 floats (~100 KB, what K9's stack at the previous
# 64-wide, 8-deep cap took) leaves room for the carries but not every row
_SQUEEZE_LF = 25668


def test_plan_prefers_carries_over_rows():
    """With room for only part of the arrays, the carries are placed and
    the read-only rows fall back first."""
    dims = _topo(g=2, d=8)
    plan = KS.plan_scan(dims, _SQUEEZE_LF, 16)
    placed = dict(zip(KS.PLACED_NAMES, plan.off))
    assert not plan.global_carries
    assert all(placed[c] >= 0 for c in ("forbid1", "map2", "pres", "wscore",
                                        "cnt_match", "free", "nzr"))
    assert any(placed[n] < 0 for n, _, kind, _ in KS.PLACED
               if kind == "row")


def _c_fixed_end(lf: int, g: int, a: int, c: int, tk: int, r: int = 8,
                 x: int = 0) -> int:
    """csrc/serial_scan.cu's fixed_layout, evaluated from its source."""
    text = _source("serial_scan.cu")
    consts = _defines(text)
    body = re.search(r"Fixed fixed_layout\([^)]*\)\s*\{(.*?)return f;",
                     text, re.S).group(1)
    env = {**consts, "lf": lf, "G": g, "A": a, "C": c, "TK": tk, "R": r,
           "X": x, "a16": lambda x: (x + 15) & ~15,
           "best_words": KS.best_words, "misc_words": KS.misc_words,
           "pod_words": KS.pod_words, "slot_c": KS.slot_c, "f": {}}
    for name, expr in re.findall(r"f\.(\w+)\s*=\s*([^;]+);", body):
        expr = re.sub(r"f\.(\w+)", r"f['\1']", expr).replace("/", "//")
        env["f"][name] = eval(expr, {"__builtins__": {}}, env)  # noqa: S307
    return env["f"]["end"]


@pytest.mark.parametrize("lf,g,a,c,tk,r,x", [
    (0, 0, 0, 0, 0, 8, 0), (0, 2, 4, 4, 8, 8, 0), (_CAP_LF, 8, 4, 4, 8, 8, 0),
    (12, 64, 4, 4, 32, 8, 0), (0, 3, 1, 5, 7, 8, 0),
    (0, 2, 4, 17, 33, 74, 0), (0, 2, 4, 17, 33, 74, 1),
    (_CAP_LF, 8, 4, 4, 8, 8, 1)])
def test_fixed_layout_matches_kernel_source(lf, g, a, c, tk, r, x):
    assert KS.fixed_layout(lf, g, a, c, tk, r, x) == _c_fixed_end(
        lf, g, a, c, tk, r, x)
    src = _source("serial_scan.cu")
    env = {**_defines(src), "G": g, "C": c, "TK": tk, "R": r, "X": x}
    for fn, args, want in (
            ("best_words", "int G, int C, int TK, int X",
             KS.best_words(g, c, tk, x)),
            ("dom_words", "int TK", KS.dom_words(tk)),
            ("slot_c", "int C", KS.slot_c(c))):
        m = re.search(fn + r"\(" + args + r"\)\s*\{\s*return\s*([^;]+);",
                      src)
        expr = m.group(1).replace("/", "//")
        if "?" in expr:     # a C conditional: cond ? a : b
            cond, rest = expr.split("?")
            a_, b_ = rest.split(":")
            expr = f"({a_}) if ({cond}) else ({b_})"
        assert eval(expr, {"__builtins__": {}}, env) == want, fn
    # pod_words: 8 words and room for 32 requests at least, 16-byte steps
    assert [KS.pod_words(v) for v in (0, 8, 32, 33, 74)] == [40, 40, 40, 44,
                                                            84]


# ------------------------------------------- the spread minima at commits

KS_SMALL_D = _defines(_source("serial_scan.cu"))["SMALL_D"]


def _kept_minima(t_cnt, exists, mind, ndom, hard, commits):
    """csrc/serial_scan.cu's rule for D <= SMALL_D, step by step: live =
    t_cnt where the domain exists, +inf elsewhere; each hard row's minimum
    (0 when not finite or below minDomains) set at launch and recomputed
    from its row when a commit adds 1 to one of its domains; yields the
    minima after each commit."""
    import numpy as np

    g_n, c_n, _ = t_cnt.shape
    live = np.where(exists, t_cnt, np.inf).astype(np.float32)

    def row_min(g, c):
        m = np.float32(np.min(live[g, c]))
        m = m if np.isfinite(m) else np.float32(0.0)
        return np.float32(0.0) if 0 < mind[g, c] and ndom[g, c] < mind[g, c] \
            else m

    mins = np.zeros((g_n, c_n), np.float32)
    for g in range(g_n):
        for c in range(c_n):
            if hard[g, c]:
                mins[g, c] = row_min(g, c)
    for hits in commits:
        for g, c, d in hits:
            live[g, c, d] += np.float32(1.0)
            if hard[g, c]:
                mins[g, c] = row_min(g, c)
        yield mins.copy()


@pytest.mark.parametrize("seed", range(6))
def test_spread_minima_kept_at_commits_match_full_minimum(seed):
    """The minima the kernel keeps (recomputed for the rows a commit
    changes) equal the twin's full masked minimum (kernels/scan.py
    spread_min over t_cnt + cntmap) after every commit of a seeded
    sequence: zone-like rows (D = 3-8 existing domains), rows with no
    existing domain, minDomains above and below the domain count."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g_n, c_n, d_n = 4, 4, int(rng.integers(3, KS_SMALL_D + 1))
    t_cnt = rng.integers(0, 6, (g_n, c_n, d_n)).astype(np.float32)
    exists = rng.random((g_n, c_n, d_n)) < 0.8
    exists[0, 1] = False                       # a row with no domain
    mind = rng.integers(0, d_n + 2, (g_n, c_n)).astype(np.int32)
    ndom = exists.sum(-1).astype(np.int32)
    hard = rng.random((g_n, c_n)) < 0.7
    commits = [[(int(rng.integers(g_n)), int(rng.integers(c_n)),
                 int(rng.integers(d_n))) for _ in range(rng.integers(0, 4))]
               for _ in range(60)]
    cntmap = np.zeros_like(t_cnt)
    for step, kept in enumerate(_kept_minima(t_cnt, exists, mind, ndom, hard,
                                             commits)):
        for g, c, d in commits[step]:
            cntmap[g, c, d] += 1.0
        full = KS.spread_min(torch.from_numpy(t_cnt + cntmap),
                             torch.from_numpy(exists), torch.from_numpy(mind),
                             torch.from_numpy(ndom)).numpy()
        assert np.array_equal(np.where(hard, kept, 0.0),
                              np.where(hard, full, 0.0)), step



# ------------------------------------------------- the lifted caps (K2a, K3)

# the reference's shapes the caps used to refuse: R = 74 (chip_smoke.py
# phase 12's K6a case), C = 17 spread constraints, TK = 33 topology keys
# (101 RequestedToCapacityRatio points are read from a device array)
CAP_DIMS = {"N": 8192, "R": 74, "G1": 2, "G": 2, "A": 4, "C": 17,
            "TK": 33, "D": 8, "ports": False}


def _c_tile_block(lf, p, tn, r, n):
    """csrc/auction_score_argmax.cu's tile_layout and block_layout,
    evaluated from its source."""
    text = _source("auction_score_argmax.cu")
    consts = _defines(text)
    env = {**consts, "a16": lambda x: (x + 15) & ~15, "tn": tn, "R": r,
           "lf": lf, "P": p, "N": n}
    t = re.search(r"TileLayout tile_layout\([^)]*\)\s*\{(.*?)return t;",
                  text, re.S).group(1)
    o = 0
    for stmt in t.split(";"):
        stmt = stmt.strip()
        m = re.match(r"o \+= (.+)$", stmt)
        if m:
            o += eval(m.group(1), {"__builtins__": {}}, env)  # noqa: S307
    env["tile_bytes"] = o
    body = re.search(r"BlockLayout block_layout\([^)]*\)\s*\{(.*?)return b;",
                     text, re.S).group(1)
    body = body.replace("tile_layout(tn, R).bytes", "tile_bytes")
    b = {}
    for name, expr in re.findall(r"b\.(\w+)\s*=\s*([^;]+);", body):
        expr = re.sub(r"b\.(\w+)", r"b['\1']", expr).replace("/", "//")
        b[name] = eval(expr, {"__builtins__": {}}, {**env, "b": b})  # noqa
    return o, b["bytes"]


@pytest.mark.parametrize("lf,p,tn,r,n", [
    (0, 16, 256, 8, 8192), (0, 16, 64, 74, 8192), (_NARROW_LF, 4, 32, 74,
                                                   8192),
    (0, 1, 32, 300, 16384)])
def test_bid_layout_mirror_matches_kernel_source(lf, p, tn, r, n):
    tile, block = _c_tile_block(lf, p, tn, r, n)
    assert KA.tile_bytes(tn, r) == tile
    assert KA.block_bytes(lf, p, tn, r, n) == block


def test_k2a_serves_r74_and_states_its_shared_memory_limit():
    """K2a (bids, final counts, the export pass) tiles R = 74 on the
    card; its one limit is a block's shared memory: one pod and one
    32-node tile of free + nominated rows, three in flight. At the
    8,192-node bucket that limit lies past 290 resource columns, far
    beyond any test shape of the reference (ROADMAP queue 3)."""
    for lf in (0, _NARROW_LF):
        p, tn, nb = KA.tiling_of(lf, 74, 8192)
        assert nb <= KA.SMEM_MAX and p >= 4
    r = 74
    while KA.tiling_of(0, r + 1, 8192) is not None:
        r += 1
    assert r >= 290
    assert KA.tiling_of(0, r + 1, 8192) is None


@pytest.mark.parametrize("x", [0, 1], ids=["no-export", "export"])
@pytest.mark.parametrize("lf", [0, _NARROW_LF])
def test_scan_plan_serves_the_lifted_caps(x, lf):
    """K3 at R = 74, C = 17, TK = 33, with and without its export
    outputs: the fixed front fits and the planner lays out the rest (74
    free columns a node leave the free rows in global memory on the
    16-block cluster, counted as a global-carries launch)."""
    dims = dict(CAP_DIMS, X=x)
    for cluster in KS.CLUSTERS:
        plan = KS.plan_scan(dims, lf, cluster)
        assert KS.plan_fits(plan)
        _check_plan(plan, dims, lf)
        if cluster == 16:
            assert set(plan.global_carries) <= {"free", "nzr"}


def test_scan_export_adds_no_bytes_to_the_plain_instantiation():
    """The export outputs' shared bytes (each rank's top ALT_K in the
    best slot, each warp's in the alts area) exist only in the export
    instantiation."""
    for dims in (_topo(d=8), _plain(g1=2), CAP_DIMS):
        plain = KS.plan_scan(dict(dims, X=0), 0, 16)
        exp = KS.plan_scan(dict(dims, X=1), 0, 16)
        assert plain.fixed_bytes == KS.fixed_layout(
            0, dims["G"], dims["A"], dims["C"], dims["TK"], dims["R"], 0)
        assert exp.fixed_bytes - plain.fixed_bytes == (
            2 * KS.MAX_CLUSTER * 4 * (KS.best_words(dims["G"], dims["C"],
                                                    dims["TK"], 1)
                                      - KS.best_words(dims["G"], dims["C"],
                                                      dims["TK"], 0))
            + 2 * KS.ALT_K * KS.MAX_WARPS * 4)


def test_scan_states_its_shared_memory_limit():
    """K3's one remaining limit is the block's fixed shared-memory front
    (per-warp slots grow with C, the commit's row with TK, the pod rows
    with R): a launch whose front passes 227 KB is refused with
    ValueError before any launch. At the other dims of CAP_DIMS that lies
    past 600 spread constraints, 25,000 resource columns or 1,600
    topology keys."""
    base = dict(CAP_DIMS)
    for key, past in (("C", 600), ("R", 25000), ("TK", 1600)):
        assert KS.plan_fits(KS.plan_scan(dict(base, **{key: past}), 0, 16))
    huge = dict(base, C=1200)
    plan = KS.plan_scan(huge, 0, 16)
    assert not KS.plan_fits(plan)
    with pytest.raises(ValueError, match="past the"):
        KS._launch_plan(None, huge, 0)


# ---------------------------------------- K3's narrow instantiation

@pytest.mark.parametrize("dims,learned,export,narrow", [
    (_topo(d=8), False, False, True),
    (_topo(g=8, d=8192, ports=True), False, False, True),
    (_plain(g1=2), False, False, True),
    (_topo(d=8), True, False, False),
    (_topo(d=8), False, True, False),
    (CAP_DIMS, False, False, False),
], ids=["topology", "hostname-ports", "plain", "K9", "export",
        "lifted-caps"])
def test_scan_takes_the_narrow_instantiation_at_the_reference_sizes(
        dims, learned, export, narrow):
    """The launches of the reference's sizes without K9 or the exports
    take the narrow instantiation; the lifted-caps case (R = 74,
    C = 17, TK = 33), a scorer or an export takes the wide one. The
    bounds are the kernel's NARROW_* and its launch's rule."""
    consts = _defines(_source("serial_scan.cu"))
    assert KS.NARROW == {k: consts[f"NARROW_{k}"] for k in KS.NARROW}
    rule = re.search(r"static bool scan_narrow\(const ScanArgs& S\) \{"
                     r"\s*return (.*?);\s*\}", _source("serial_scan.cu"),
                     re.S).group(1)
    for k in KS.NARROW:
        assert f"S.{k} <= NARROW_{k}" in rule
    assert "S.learned.n_layers == 0" in rule and "!S.exp_feats" in rule
    assert KS.narrow_launch(dims, learned, export) is narrow


# --------------------------------------------------- K1's launch object

def test_k1_layout_mirror_matches_kernel():
    """K1's P1Layout (the field offsets, the flags, the plan, the output
    offsets) against its ctypes mirror, and the constants the wrapper
    shares with the kernel."""
    text = _source("phase1_static.cu")
    consts = _defines(text)
    want = struct_members(text, "P1Layout", consts)
    got = list(K1._Layout._fields_)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert _same_type(a, b), (name, a, b)
    assert consts["THREADS"] == K1.THREADS
    assert consts["NUM_COUNTS"] == K1.NUM_COUNTS
    assert consts["NUM_STATIC"] == K1.NUM_STATIC
    for lanes in K1.LANES:
        assert f"case {lanes}:" in text and f"p1_pairs<{lanes}>" in text


@pytest.mark.parametrize("g,n,active,lanes", [
    (1, 8192, (), 1),
    (1, 8192, ("nodeaffinity", "taints", "ports", "images"), 8),
    (4, 8192, ("taints",), 4),
    (8, 8192, ("nodeaffinity_pin",), 1),
    (16, 8192, ("images",), 1),
    (256, 128, ("ports",), 4),
    (4096, 8192, ("taints",), 1),
], ids=["basic", "dry-run", "g4-taints", "g8-pin", "gang-images",
        "dra-ports", "per-pod"])
def test_k1_plan_of_every_path(g, n, active, lanes):
    """A pair's lanes widen (up to 8) only for the features with inner
    loops and while the launch stays within TARGET_THREADS; the blocks
    cover the G x N pairs; each block's count rows cover the group rows
    its pairs span; the output offsets lay the float planes, the counts
    and the byte planes end to end."""
    im = 8
    plan = K1.plan_phase1(g, n, active, im)
    assert plan.lanes == lanes
    per = K1.THREADS // lanes
    assert plan.blocks * per >= g * n > (plan.blocks - 1) * per
    for b in range(plan.blocks):
        p0, p1 = b * per, min(g * n, (b + 1) * per) - 1
        assert p1 // n - p0 // n < plan.rows
    assert plan.smem == 4 * plan.rows * K1.NUM_COUNTS
    assert plan.p_blocks == -(-g * n // K1.THREADS)
    assert plan.p_smem == 4 * (plan.p_rows * im + 1)
    for forced in K1.LANES:
        assert K1.plan_phase1(g, n, active, im, forced).lanes == forced
    with pytest.raises(ValueError, match="lanes a pair"):
        K1.plan_phase1(g, n, active, im, 3)
    o = K1.out_offsets(g, n, im)
    assert (o["o_aff_raw"], o["o_img"], o["o_rejects"]) == (
        4 * g * n, 8 * g * n, 12 * g * n)
    assert o["count_bytes"] == 4 * (g * (K1.NUM_COUNTS + im) + 1)
    assert o["total"] == o["o_static_ok"] + 3 * g * n


def test_k1_launch_key_and_struct():
    """The argument struct of one launch key: the shapes, switches and
    field offsets as the codecs give them, the plan's and the outputs'
    numbers."""
    caps = Capacities(nodes=1024)
    active = ("taints", "nodeaffinity")
    layout, plan, offs = K1._layout(
        caps, 3, {"unschedulable_taint_key": 5, "wildcard_ip": 7},
        (True, False, True, True, True), active)
    node_codec, _, pod_codec = codecs(caps)
    assert (layout.N, layout.G, layout.NI, layout.PI) == (
        1024, 3, node_codec.i32_size, pod_codec.i32_size)
    assert (layout.en1, layout.act_taints, layout.act_images) == (0, 1, 0)
    assert (layout.unsched_key, layout.wildcard_ip) == (5, 7)
    assert layout.n_port_nums == node_codec._i32_off["port_nums"][0]
    assert layout.n_alloc == node_codec._f32_off["allocatable"][0]
    assert layout.p_tol_key == pod_codec._i32_off["tol_key"][0]
    assert (layout.lanes, layout.blocks, layout.rows, layout.smem) == (
        plan.lanes, plan.blocks, plan.rows, plan.smem)
    assert layout.o_static_ok == offs["o_static_ok"]


# ------------------------------------------------------ K8's lifted caps

def test_k8_args_mirror_and_constants_match_kernel():
    text = _source("dra_feasible.cu")
    consts = _defines(text)
    want = struct_members(text, "DraArgs", consts)
    got = list(KD._DraArgs._fields_)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert _same_type(a, b), (name, a, b)
    assert (consts["THREADS"], consts["SW"], consts["SELBIT_WORDS"]) == (
        KD.THREADS, KD.SW, KD.SELBITS // 32)


@pytest.mark.parametrize("b,n,d,q", [
    (256, 128, 8, 1), (2048, 8192, 128, 4), (64, 512, 8192, 4),
    (70000, 4, 8, 2), (256, 8192, 16, 32), (1, 1, 1, 1)],
    ids=["drain", "fuzz", "D=8192", "B=70000", "Q=32", "one"])
def test_k8_plan_serves_the_lifted_caps(b, n, d, q):
    """K8 plans any D and any B (the previous design refused D > 4,096
    and B > 65,535) and Q up to the plugin's MAX_REQS of 32: blocks of
    THREADS threads over (node tiles x pod chunks), shared memory within
    a block's 232,448 bytes."""
    plan = KD.plan_dra(b, n, d, q)
    assert 1 <= plan.nt <= 32 and plan.pods % KD.THREADS == 0
    assert plan.tiles == -(-n // plan.nt)
    assert plan.blocks == plan.tiles * -(-b // plan.pods) < 2 ** 31
    assert plan.smem == KD.dra_smem(q, plan.pods, plan.nt) <= KD.SMEM_LIMIT


def test_k8_states_its_shared_memory_limit():
    """K8's one remaining limit: the request state of THREADS pods at one
    node a block with the staged chunk must fit a block's shared memory,
    436 request slots a pod, far past the plugin's MAX_REQS of 32
    (ROADMAP queue 3). Past it the wrapper raises ValueError."""
    from kubernetes_tpu_torch.plugins.dra import DeviceAllocatorView

    assert KD.max_requests() == 436
    assert KD.dra_smem(436, KD.THREADS, 1) <= KD.SMEM_LIMIT
    assert KD.dra_smem(437, KD.THREADS, 1) > KD.SMEM_LIMIT
    assert KD.max_requests() > DeviceAllocatorView.MAX_REQS
    KD.plan_dra(16, 8, 8192, 436)
    with pytest.raises(ValueError, match="request slots"):
        KD.plan_dra(16, 8, 8, 437)


# --------------------------------------------------- K5's one launch

def test_k5_structs_and_outputs_match_kernel():
    """K5's TopoLayout and TopoArgs against their ctypes mirrors, and its
    outputs' one allocation: each array 4-byte aligned and disjoint, the
    arrays the kernel accumulates into (the maps, any_match, the spread
    presence maps) at the front, which the entry's one memset zeroes."""
    from kubernetes_tpu_torch.kernels import topology as KT

    text = _source("topo_statics.cu")
    consts = _defines(text)
    for struct, mirror in (("TopoLayout", KT._Layout),
                           ("TopoArgs", KT._Args)):
        want = []
        for name, ctype in struct_members(text, struct, consts):
            if issubclass(ctype, ctypes.Array):   # mirrored element-wise
                want += [(f"{name}{i}", ctype._type_)
                         for i in range(ctype._length_)]
            else:
                want.append((name, ctype))
        got = list(mirror._fields_)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, a), (_, b) in zip(got, want):
            assert _same_type(a, b), (name, a, b)
    assert consts["THREADS"] == KT.THREADS
    caps = Capacities(nodes=8192, pods=16384)
    assert KT.stage_blocks(caps, 4) == 4 * 16384 // KT.THREADS
    assert KT.stage_blocks(Capacities(nodes=8192, pods=8192), 1) == 32
    outs, zero, total = KT.out_layout(3, 1000, 8, 4, 5, 1024)
    spans = sorted((off, off + nb) for off, _, _, nb in outs.values())
    assert all(a % 4 == 0 for a, _ in spans)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
    assert spans[-1][1] == total
    front = ("score", "cnt", "forbid", "present", "any_match",
             "exists_hard", "exists_score")
    assert max(outs[f][0] + outs[f][3] for f in front) == zero
    assert all(outs[f][0] >= zero for f in outs if f not in front)
    assert set(outs) == set(KT.TopoMaps._fields + KT.NodeStatics._fields
                            + KT.PairStatics._fields)


def test_k10_constants_match_kernel():
    """K10's planner reads the kernel's own constants."""
    consts = _defines(_source("learned_train.cu"))
    assert consts["IN_F"] == KL.LN.NUM_FEATURES
    assert consts["MAX_LAYERS"] == KL.TRAIN_MAX_LAYERS
    assert consts["BLOCKS_PER_SM"] == KL.TRAIN_BLOCKS_PER_SM
    assert consts["GROUP"] == KL.TRAIN_GROUP
    assert consts["SMALL_H"] == KL.SMALL_H
    assert consts["SMALL_THREADS"] == KL.SMALL_THREADS
    assert consts["SMALL_BLOCKS_PER_SM"] == KL.SMALL_BLOCKS_PER_SM
    assert consts["SMEM_MAX"] == KL.TRAIN_SMEM_MAX
    assert consts["SMEM_STATIC"] == KL.TRAIN_SMEM_STATIC
    assert (consts["MODE_LOSS"], consts["MODE_GRAD"]) == (KL.MODE_LOSS,
                                                          KL.MODE_GRAD)
    # the Stack of MAX_LAYERS layers (five int arrays, one longer by one)
    # and the ticket flag, to the dynamic part's 16-byte aligned start
    assert KL.TRAIN_SMEM_STATIC == -(-4 * (5 * KL.TRAIN_MAX_LAYERS + 2)
                                     // 16) * 16
    text = _source("learned_train.cu")
    assert "A.threads != 64 && A.threads != 32 && A.threads != 16" in text
    assert KL.TRAIN_THREADS == (64, 32, 16)
    assert "4L * ((2L * S + IN_F + 1) * (threads + 1) + P + 1)" in text
    assert KL.train_smem((9, 8, 1), 64) == 4 * ((2 * 9 + 9 + 1) * 65 + 90)


@pytest.mark.parametrize("m,dims,small,threads,tiles,blocks", [
    (11_000, (9, 8, 1), True, 64, 1, 172),    # the trainer's own size
    (1 << 20, (9, 8, 1), True, 64, 32, 528),  # 2^20: 4 blocks an SM
    (11_000, (9, 16, 1), False, 64, 1, 172),
    (1 << 20, (9, 16, 1), False, 64, 8, 2048),   # 16 blocks an SM
    (11_000, (9, 64, 64, 1), False, 64, 1, 172),
    (1 << 20, (9, 64, 64, 1), False, 64, 63, 261),  # 2 an SM by smem
    (1, (9, 8, 1), True, 64, 1, 1),
    (1, (9, 4, 4, 1), False, 64, 1, 1),
])
def test_k10_plan_covers_the_sms(m, dims, small, threads, tiles, blocks):
    """The grid covers the 132 SMs at the trainer's 11,000 rows (a row a
    thread, one tile a block) and stays resident at 2^20 (more rows a
    thread on the narrow path, more tiles a block on the tiled one);
    every row has a thread and no block is empty."""
    plan = KL.plan_train(m, dims, sms=132)
    assert (plan.small, plan.threads, plan.tiles, plan.blocks) == (
        small, threads, tiles, blocks)
    assert plan.small == KL.small_path(dims)
    assert plan.blocks * plan.threads * plan.tiles >= m
    if m >= 132 * plan.threads:
        assert plan.blocks >= 132
    if plan.small:
        # rows i, i + blocks * threads, ...: every block has a first row
        assert (plan.blocks - 1) * plan.threads < m
        assert plan.blocks <= KL.SMALL_BLOCKS_PER_SM * 132
        assert plan.smem == 0
        return
    rows = plan.threads * plan.tiles
    assert m > (plan.blocks - 1) * rows
    per_sm = min(KL.TRAIN_BLOCKS_PER_SM, KL.SM_SHARED // (
        plan.smem + KL.TRAIN_SMEM_STATIC + KL.BLOCK_RESERVED))
    assert plan.blocks <= per_sm * 132
    assert plan.smem == KL.train_smem(dims, plan.threads)
    assert plan.chunks == -(-(KL.n_params(dims) + 1) // plan.threads)


def test_k10_widest_stack_and_its_refusal():
    """The widest single hidden layer served (1,279 units) takes 16-row
    tiles within a block's shared memory, its parameter sums in chunks of
    16; one unit more is refused with the stated limit, as are more than
    TRAIN_MAX_LAYERS layers and a head that is not scalar."""
    room = KL.TRAIN_SMEM_MAX - KL.TRAIN_SMEM_STATIC
    widest = (9, 1279, 1)
    plan = KL.plan_train(11_000, widest, sms=132)
    assert plan.threads == 16 and plan.smem <= room
    assert KL.train_smem(widest, 32) > room
    assert plan.chunks == -(-(KL.n_params(widest) + 1) // 16)
    assert plan.blocks * plan.tiles * 16 >= 11_000
    assert KL.plan_train(11_000, (9, 500, 1)).threads == 32
    for dims in ((9, 1280, 1), (9, 900, 800, 1)):
        assert KL.train_smem(dims, 16) > room
        with pytest.raises(ValueError, match="past a block's 231152"):
            KL.plan_train(11_000, dims)
    deep = (9,) + (4,) * KL.TRAIN_MAX_LAYERS + (1,)
    with pytest.raises(ValueError, match="at most 64 layers"):
        KL.plan_train(100, deep)
    KL.plan_train(100, (9,) + deep[2:])     # 64 layers: served
    with pytest.raises(ValueError, match="scalar head"):
        KL.plan_train(100, (9, 8, 2))


# --------------------------------------------- K2a's export pass (cluster)


@pytest.fixture(scope="module")
def export_plan_c(tmp_path_factory):
    """The "export plan" block of csrc/auction_score_argmax.cu compiled
    on the host (it is plain C++ between its markers: the CUDA qualifiers
    defined away, the source's integer macros and a16 given), its C entry
    auction_export_plan loaded with ctypes."""
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the plan block")
    with open(os.path.join(CSRC, "auction_score_argmax.cu"),
              encoding="utf-8") as fh:
        text = fh.read()
    block = text[text.index("// >>> export plan"):
                 text.index("// <<< export plan")]
    consts = _defines(_source("auction_score_argmax.cu"))
    prelude = ("#define __host__\n#define __device__\n"
               + "".join(f"#define {k} {v}\n" for k, v in consts.items())
               + "static inline int a16(int x) { return (x + 15) & ~15; }\n")
    d = tmp_path_factory.mktemp("export_plan")
    src, lib = d / "plan.cpp", d / "libplan.so"
    src.write_text(prelude + block, encoding="utf-8")
    subprocess.run([cxx, "-O1", "-shared", "-fPIC", "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).auction_export_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(KA._ExportPlan)]
    fn.restype = ctypes.c_int

    def plan(lf, r, n, b, soft, k9):
        x = KA._ExportPlan()
        if not fn(lf, r, n, b, int(soft), int(k9), ctypes.byref(x)):
            return None
        return KA.ExportPlan(*(getattr(x, f) for f in KA.ExportPlan._fields))

    return plan


def test_export_constants_match_kernel():
    consts = _defines(_source("auction_score_argmax.cu"))
    for name in ("EXP_P", "EXP_P_K9", "EXP_CLUSTER_MAX", "EXP_SLICE_MIN",
                 "EXP_SMEM_PAIR", "EXP_XCH", "STAGES", "SMEM_MAX"):
        assert getattr(KA, name) == consts[name], name
    assert consts["EXP_SMEM_PAIR"] == 233472 // 2 - 1024


@pytest.mark.parametrize("r", [4, 74])
@pytest.mark.parametrize("n", [100, 5000, 8192])
@pytest.mark.parametrize("b", [1, 1000, 4096])
def test_export_plan_mirror_matches_kernel_source(export_plan_c, b, n, r):
    """kernels/auction.py plan_export against the kernel's own plan, for
    the launches without and with K9 (the drain's (8,) scorer and the
    (256, 256) scorer's shared slabs), plain and soft: the same plan,
    whose grid covers B pods in clusters and N nodes in slices, within a
    CTA's shared memory."""
    for lf, k9 in ((0, False), (_NARROW_LF, True), (_WIDE_LF, True)):
        for soft in (False, True):
            want = export_plan_c(lf, r, n, b, soft, k9)
            got = KA.plan_export(lf, r, n, b, soft, k9)
            assert got == want, (lf, soft)
            assert got is not None
            assert got.pods <= (KA.EXP_P_K9 if k9 else KA.EXP_P)
            assert got.slice % 32 == 0
            assert got.cluster * got.slice >= n
            assert got.ctas == -(-b // got.pods) * got.cluster
            assert got.smem <= KA.SMEM_MAX
            assert got.slice == KA.export_slice(n)
            if got.resident:
                assert got.tile == got.slice
            else:
                assert got.tile < got.slice


def test_export_plan_covers_the_card_at_the_collection_launches():
    """25a's launches (B = 1,000 and 4,096 over the 8,192-node bucket, R
    = 8): clusters of 8 CTAs of 1,024 nodes, the slice resident, two CTAs
    an SM by shared memory, and a grid past the 132 SMs."""
    for b in (1000, 4096):
        for lf, k9 in ((0, False), (_NARROW_LF, True)):
            p = KA.plan_export(lf, 8, 8192, b, False, k9)
            assert (p.cluster, p.slice, p.resident) == (8, 1024, 1)
            assert p.smem <= KA.EXP_SMEM_PAIR
            assert p.ctas >= 132


def test_export_serves_r74_and_states_its_shared_memory_limit():
    """The export pass tiles R = 74 at the 8,192-node bucket; its one
    limit is a CTA's shared memory (one pod, one 32-node tile of its
    slice's rows, three in flight), which lies past 290 resource
    columns."""
    for lf, k9 in ((0, False), (_NARROW_LF, True)):
        p = KA.plan_export(lf, 74, 8192, 4096, False, k9)
        assert p is not None and not p.resident and p.pods >= 4
    r = 74
    while KA.plan_export(0, r + 1, 8192, 1, False, False) is not None:
        r += 1
    assert r >= 290
    assert KA.plan_export(0, r + 1, 8192, 1, False, False) is None


# ------------------------------------------ K6b's one launch a dry run


@pytest.fixture
def own_counters(monkeypatch):
    """The port's object uids and node generations counted apart for the
    test, so that the objects it builds leave the process-wide counters
    where they were for the tests that follow."""
    import itertools

    from kubernetes_tpu_torch.api import objects
    from kubernetes_tpu_torch.backend import node_info

    monkeypatch.setattr(objects, "_uid_counter", itertools.count(1))
    monkeypatch.setattr(node_info, "_generation", itertools.count(1))


def _k6b_case(caps, seed=3):
    """A small topology cluster in a CPU port mirror: (mirror, cluster
    blobs, the first fuzz spec's pod blobs, an all-valid table mask, the
    free matrix)."""
    import random

    import torch

    from kubernetes_tpu_torch.backend.cache import Cache
    from kubernetes_tpu_torch.backend.mirror import Mirror
    from kubernetes_tpu_torch.backend.snapshot import Snapshot
    from kubernetes_tpu_torch.perf.fuzz import topology_fuzz

    nodes, bound, specs, namespaces = topology_fuzz(random.Random(seed), 40,
                                                    120, 2)
    cache, snap = Cache(), Snapshot()
    for ns in namespaces:
        cache.set_namespace(ns.metadata.name, ns.metadata.labels)
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    cache.update_snapshot(snap)
    m = Mirror(caps=caps, device="cpu")
    m.sync(snap)
    return (m, m.to_blobs(), m.pack_batch_blobs([specs[0]], 1),
            torch.tensor(m.table_valid_mask(())),
            torch.tensor(m.free_matrix()))


def test_k6b_constants_match_kernel():
    consts = _defines(_source("preempt_feasible.cu"))
    assert KP.FOLD_C_MAX == consts["FOLD_C_MAX"]
    # the one limit: 64 spread constraints and 64 affinity terms a launch
    caps = Capacities(nodes=64, pods=256)
    for c, a in ((65, 4), (4, 65)):
        with pytest.raises(ValueError, match="past the fold's 64"):
            KP.fold_plan((64, 8, c, a, 8, 1, 1, 1, 1, 74, 83, 1493,
                          "cpu"), caps)


def test_k6b_launch_plan_key_covers_every_dimension_and_flag(own_counters):
    """K6b's launch is planned once a layout: its key changes with each of
    N, R, C, A, D, the four flags (fit, topology, spread, inter-pod
    affinity), the blobs' row widths and the device, and each key's
    struct carries exactly those dimensions and flags."""
    base = Capacities(nodes=64, pods=256)
    variants = {
        "N": Capacities(nodes=128, pods=256),
        "R": Capacities(nodes=64, pods=256, ext_resources=70),
        "C": Capacities(nodes=64, pods=256, spread_constraints=17),
        "A": Capacities(nodes=64, pods=256, aff_terms=6)}
    flags = (True, True, True, True)

    def key_of(caps, d=8, fl=flags):
        _, cb, pb, _, fr = _k6b_case(caps)
        return KP.fold_key(cb, pb, caps, fr, fl[1], d, fl)

    k0 = key_of(base)
    keys = {"base": k0, "D": key_of(base, d=16)}
    for name, caps in variants.items():
        keys[name] = key_of(caps)
    for i in range(4):
        fl = tuple(f if j != i else False for j, f in enumerate(flags))
        keys[f"flag{i}"] = key_of(base, fl=fl)
    assert len(set(keys.values())) == len(keys)
    for name, key in keys.items():
        plan = KP.fold_plan(key, variants.get(name, base))
        a = plan.args
        assert (a.N, a.R, a.C, a.A, a.D) == key[:5], name
        assert (a.fit_on, a.topo, a.spread_on, a.ipa_on) == key[5:9], name
        assert a.nom_stride == key[9]
        assert KP.fold_plan(key, base) is plan      # made once
    assert keys["N"][0] == 128 and keys["R"][1] == 74
    assert keys["C"][2] == 17 and keys["A"][3] == 6


def test_k6b_pointers_read_the_fields_in_place(own_counters):
    """On CPU tensors the struct's pointers are host addresses: each reads
    the field the twin reads (the pod's fields in its packed rows, the
    nominated reservations at the node blob's row stride, K1's and K5's
    outputs, the caller's free matrix); a second call of the layout takes
    the same plan and no copy of a contiguous input."""
    import torch

    from kubernetes_tpu_torch.ops.features import unpack_cluster, unpack_pods

    caps = Capacities(nodes=64, pods=256)
    m, cb, pb, tv, fr = _k6b_case(caps)
    launch = KP.prepare_feasible(cb, pb, m.well_known(), caps, tv, fr, True,
                                 8)
    a, t = launch.args, launch.tensors
    pod, ct = unpack_pods(pb, caps), unpack_cluster(cb, caps)

    def ints(ptr, k):
        return [ctypes.c_int.from_address(ptr + 4 * i).value
                for i in range(k)]

    def floats(ptr, k, stride=1):
        return [ctypes.c_float.from_address(ptr + 4 * i * stride).value
                for i in range(k)]

    assert ints(a.tsc_tk, a.C) == pod.tsc_tk[0].tolist()
    assert ints(a.tsc_hard, a.C) == pod.tsc_hard[0].int().tolist()
    assert ints(a.max_skew, a.C) == pod.tsc_max_skew[0].tolist()
    assert ints(a.min_domains, a.C) == pod.tsc_min_domains[0].tolist()
    assert ints(a.aff_tk, a.A) == pod.aff_tk[0].tolist()
    assert ints(a.aff_self, 1) == [int(pod.aff_self_match.reshape(-1)[0])]
    assert ints(a.nominated_row, 1) == pod.nominated_row.tolist()
    assert floats(a.req, a.R) == pod.req[0].tolist()
    for row in (0, 3, 39):
        assert floats(a.nom + 4 * row * a.nom_stride, a.R) == \
            ct.nominated_req[row].tolist()
    assert a.free == fr.data_ptr()
    for name in ("static_ok", "self_match", "cnt", "exists_hard",
                 "match_static", "dom_ok", "any_match", "anti_ok",
                 "term_static", "has_lbl", "min_cnt", "out"):
        assert getattr(a, name) == t[name].data_ptr(), name
        assert t[name].is_contiguous(), name
    n_plans = len(KP._FOLD_PLANS)
    again = KP.prepare_feasible(cb, pb, m.well_known(), caps, tv, fr, True,
                                8)
    assert len(KP._FOLD_PLANS) == n_plans
    assert again.args.free == fr.data_ptr()
    assert again.args.out != a.out
    # topology off: the fold reads none of K5's outputs
    off = KP.prepare_feasible(cb, pb, m.well_known(), caps, tv, fr, False,
                              0)
    assert off.args.topo == 0 and not off.args.cnt and off.args.D == 1
    assert isinstance(off.out, torch.Tensor)


# ------------------------------------------- K6a's victim-prefix sweep


def _k6a_case(caps, seed=1, extra=False, n_pre=4):
    """A small preemption cluster in a CPU port mirror with its victim
    state: (mirror, cluster blobs, the preemptors' pod blobs, the victim
    cumsum, the freed columns, a live-free override)."""
    import random

    import numpy as np
    import torch

    from kubernetes_tpu_torch.backend.cache import Cache
    from kubernetes_tpu_torch.backend.mirror import Mirror
    from kubernetes_tpu_torch.backend.snapshot import Snapshot
    from kubernetes_tpu_torch.framework.preemption import Evaluator
    from kubernetes_tpu_torch.perf.fuzz import preemption_fuzz

    nodes, bound, pre = preemption_fuzz(random.Random(seed), 64, n_pre,
                                        extra)
    pre[1].status.nominated_node_name = "node-5"
    cache, snap = Cache(), Snapshot()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    cache.update_snapshot(snap)
    m = Mirror(caps=caps, device="cpu")
    m.sync(snap)
    m.set_nominated({"node-5": [pre[1]], "node-9": [pre[2].clone()]})
    ev = Evaluator(None, lambda: m, lambda: caps, lambda pod=None: None,
                   None)
    _, _, cumsum, cols, _, _ = ev._rebuild_victims(10, snap, m, caps)
    free = torch.tensor(m.free_matrix())
    # the override moves the first four columns (cpu, memory and the
    # next two), as in-flight waves move a node's usage
    live = free.clone()
    live[:, :4] += torch.tensor(np.random.default_rng(seed).choice(
        [-1000.0, 0.0, 0.0, 500.0], size=(free.shape[0], 4)),
        dtype=torch.float32)
    return (m, m.to_blobs(), m.pack_batch_blobs(pre, n_pre), cumsum, cols,
            live)


@pytest.fixture(scope="module")
def sweep_plan_c(tmp_path_factory):
    """The "sweep plan" block of csrc/preempt_sweep.cu compiled on the
    host (plain C++ between its markers, the CUDA qualifiers defined away
    and the source's integer macros given), its C entry sweep_plan loaded
    with ctypes."""
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the plan block")
    with open(os.path.join(CSRC, "preempt_sweep.cu"),
              encoding="utf-8") as fh:
        text = fh.read()
    block = text[text.index("// >>> sweep plan"):
                 text.index("// <<< sweep plan")]
    prelude = ("#define __host__\n#define __device__\n"
               + "".join(f"#define {k} {v}\n" for k, v in
                         _defines(_source("preempt_sweep.cu")).items()))
    d = tmp_path_factory.mktemp("sweep_plan")
    src, lib = d / "plan.cpp", d / "libplan.so"
    src.write_text(prelude + block, encoding="utf-8")
    subprocess.run([cxx, "-O1", "-shared", "-fPIC", "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).sweep_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(KP._SweepPlan)]
    fn.restype = ctypes.c_int

    def plan(p, n, r, k1, c):
        x = KP._SweepPlan()
        if not fn(p, n, r, k1, c, ctypes.byref(x)):
            return None
        return KP.SweepPlan(*(getattr(x, f) for f, _ in x._fields_))

    return plan


def test_k6a_constants_match_kernel():
    consts = _defines(_source("preempt_sweep.cu"))
    for name in ("SWEEP_THREADS", "SWEEP_LANES", "SWEEP_LANES_MAX",
                 "SWEEP_SPAN", "SWEEP_SMEM_MAX"):
        assert getattr(KP, name) == consts[name], name


@pytest.mark.parametrize("p,n", [(1, 64), (1, 5000), (1, 8192), (64, 8192)])
@pytest.mark.parametrize("r,k1,c", [(4, 9, 4), (8, 9, 4), (8, 17, 8),
                                    (74, 17, 8), (74, 9, 128)])
def test_k6a_plan_mirror_matches_kernel_source(sweep_plan_c, p, n, r, k1,
                                                c):
    """kernels/preempt.py plan_sweep against the kernel's own plan: the
    same lanes a group (8 up to 8 columns, 16 up to 128, a warp past
    that), the grid over every node, within the shared bytes a CTA takes
    unasked."""
    got, want = KP.plan_sweep(p, n, r, k1, c), sweep_plan_c(p, n, r, k1, c)
    assert got == want
    assert got.lanes == (8 if r <= 8 else 16 if r <= 128 else 32)
    assert got.nodes * got.lanes == KP.SWEEP_THREADS
    assert got.ctas_x * got.nodes >= n > (got.ctas_x - 1) * got.nodes
    assert got.smem <= KP.SWEEP_SMEM_MAX


def test_k6a_plan_at_path_b_and_r74_and_its_limit(sweep_plan_c):
    """Path B's sweep (P = 1 over the 8,192 bucket, R = 8, K + 1 = 9, C =
    4) is 8 lanes a node (a lane a column), 256 CTAs of 32 nodes; phase
    12's R = 74 case 16 lanes a node (five columns a lane), 512 CTAs of
    16. The one limit is a CTA's 48 KB of shared memory (the request row
    and every node's row of bases: past about 1,300 resource columns),
    refused alike by both plans."""
    assert KP.plan_sweep(1, 8192, 8, 9, 4)[:3] == (8, 32, 256)
    assert KP.plan_sweep(1, 8192, 74, 17, 8)[:3] == (16, 16, 512)
    assert KP.plan_sweep(1, 8192, 200, 17, 8)[:3] == (32, 8, 1024)
    assert KP.plan_sweep(64, 8192, 8, 17, 8).ctas(64) == 256 * 64
    r = 74
    while KP.plan_sweep(1, 8192, r + 1, 17, 8) is not None:
        r += 1
    assert 1300 <= r < 1400 and sweep_plan_c(1, 8192, r + 1, 17, 8) is None
    big = (1, 8192, 4096, 17, 2048)
    assert KP.plan_sweep(*big) is None and sweep_plan_c(*big) is None
    with pytest.raises(ValueError, match="shared bytes a CTA"):
        KP.sweep_layout(big[:5] + (100, None, 80, 80, "cpu"),
                        Capacities(nodes=64, pods=256))


def test_k6a_layout_key_covers_every_dimension_and_stride(own_counters):
    """K6a's launch is prepared once a layout: its key changes with each
    of P, N, R, K + 1, C, the node rows' stride, the free override's row
    stride (or none), the pod rows' strides and the device, and each
    key's struct carries exactly those dimensions and strides."""
    import torch

    from kubernetes_tpu_torch.ops.features import PodBlobs

    caps = Capacities(nodes=64, pods=512)
    m, cb, pb, cs, cols, live = _k6a_case(caps)
    key = lambda cb=cb, pb=pb, caps=caps, cs=cs, cols=cols, fr=None: \
        KP.sweep_key(cb, pb, caps, cs, cols, fr)  # noqa: E731
    k0 = key()
    wide = torch.zeros((64, live.shape[1] + 3))
    keys = {"base": k0,
            "P": key(pb=PodBlobs(f32=pb.f32[:2], i32=pb.i32[:2])),
            "pod_strides": key(pb=PodBlobs(
                f32=torch.zeros((4, pb.f32.shape[1] + 5))[:, 5:],
                i32=torch.zeros((4, pb.i32.shape[1] + 3),
                                dtype=torch.int32)[:, 3:])),
            "N": key(cb=_k6a_case(Capacities(nodes=128, pods=512))[1]),
            "K1": key(cs=torch.zeros((64, cs.shape[1] + 8, cs.shape[2]))),
            "C": key(cs=torch.zeros((64, cs.shape[1], 8))),
            "free": key(fr=live), "free_stride": key(fr=wide[:, :8])}
    caps74 = Capacities(nodes=64, pods=512, ext_resources=70)
    _, cb74, pb74, cs74, cols74, _ = _k6a_case(caps74)
    keys["R"] = key(cb=cb74, pb=pb74, caps=caps74, cs=cs74, cols=cols74)
    assert len(set(keys.values())) == len(keys)
    assert keys["free"][6] == live.stride(0) and keys["base"][6] is None
    assert keys["free_stride"][6] == live.shape[1] + 3
    assert k0[5] == cb.node_f32.stride(0) and k0[7:9] == (
        pb.f32.stride(0), pb.i32.stride(0))
    for name, k in keys.items():
        lay = KP.sweep_layout(k, caps74 if name == "R" else caps)
        a = lay.args
        assert (a.P, a.N, a.R, a.K1, a.C) == k[:5], name
        assert (a.node_stride, a.pod_f32_stride, a.pod_i32_stride) == \
            (k[5], k[7], k[8]), name
        assert a.free_stride == (k[5] if k[6] is None else k[6]), name
        assert lay.plan == KP.plan_sweep(*k[:5]), name
        assert KP.sweep_layout(k, caps) is lay


def test_k6a_pointers_read_the_fields_in_place(own_counters):
    """On CPU tensors the struct's pointers are host addresses: each reads
    the field the twin reads (the pods' requests and nominated rows in
    their packed rows, free / nom / alloc in the node blob's rows at its
    stride, the override at its own, the victim cumsum and columns, K1's
    static_ok); a second call of the layout takes the same layout and no
    copy of an input."""
    import torch

    from kubernetes_tpu_torch.ops.features import unpack_cluster, unpack_pods

    caps = Capacities(nodes=64, pods=512)
    m, cb, pb, cs, cols, live = _k6a_case(caps)
    launch = KP.prepare_sweep(cb, pb, m.well_known(), cs, cols, caps)
    a, t = launch.args, launch.tensors
    pods, ct = unpack_pods(pb, caps), unpack_cluster(cb, caps)

    def floats(ptr, k):
        return [ctypes.c_float.from_address(ptr + 4 * i).value
                for i in range(k)]

    assert a.P == 4 and a.R == caps.res_cols
    for p in range(a.P):
        assert floats(a.req + 4 * p * a.pod_f32_stride, a.R) == \
            pods.req[p].tolist()
        assert ctypes.c_int.from_address(
            a.nominated_row + 4 * p * a.pod_i32_stride).value == \
            int(pods.nominated_row[p])
    for row in (0, 5, 63):
        for name, want, stride in (
                ("free", ct.free, a.free_stride),
                ("nom", ct.nominated_req, a.node_stride),
                ("alloc", ct.allocatable, a.node_stride)):
            assert floats(getattr(a, name) + 4 * row * stride, a.R) == \
                want[row].tolist(), (name, row)
    assert a.free_stride == a.node_stride == cb.node_f32.stride(0)
    assert a.cumsum == cs.data_ptr() and a.cols == cols.data_ptr()
    assert a.static_ok == t["static_ok"].data_ptr()
    assert tuple(t["static_ok"].shape) == (4, 64)
    assert a.kmin == launch.out.data_ptr()
    assert launch.plan == KP.plan_sweep(4, 64, caps.res_cols,
                                        cs.shape[1], cs.shape[2])
    again = KP.prepare_sweep(cb, pb, m.well_known(), cs, cols, caps,
                             free=live)
    assert again.args.free == live.data_ptr()
    assert again.args.free_stride == live.stride(0)
    assert again.args.kmin != a.kmin
    n_layouts = len(KP._SWEEP_LAYOUTS)
    for free in (None, live):
        KP.prepare_sweep(cb, pb, m.well_known(), cs, cols, caps, free=free)
    assert len(KP._SWEEP_LAYOUTS) == n_layouts
    assert isinstance(again.out, torch.Tensor)


# ------------------------------------------- K7b's capacity bound


def test_k7b_constants_and_plan_match_kernel():
    """K7b's launch carries the request by value, up to CAP_R_MAX columns
    (past R = 74), one thread a row in CTAs of CAP_THREADS: one CTA at the
    Permit path's 512-node bucket, 16 at 8,192, whose partials and ticket
    the plan allocates once (zeroed)."""
    import numpy as np
    import torch

    consts = _defines(_source("gang_capacity.cu"))
    assert KG.CAP_THREADS == consts["CAP_THREADS"] == KG.CAP_ROWS
    assert KG.CAP_R_MAX == consts["CAP_R_MAX"] >= 74
    assert re.search(r"#define CAP_ROWS CAP_THREADS\b",
                     _source("gang_capacity.cu"))
    assert [KG.cap_ctas(n) for n in (0, 1, 512, 513, 8192)] == \
        [0, 1, 1, 2, 16]
    free = torch.zeros((8192, 20))[:, 4:12]
    args, out = KG.prepare_capacity(free, np.full(8, 250.0, np.float32))
    assert (args.N, args.R, args.free_stride, args.ctas) == (8192, 8, 20,
                                                             16)
    plan = KG.cap_plan(8192, 8, 20, free.device)
    assert plan.args is not args and plan.partials.numel() == 16 * 12 + 4
    assert int(plan.partials.sum()) == 0 and args.partials == \
        plan.partials.data_ptr()
    assert KG.cap_plan(512, 8, 20, free.device).partials is None
    assert args.free == free.data_ptr() and args.out == out.data_ptr()
    assert list(args.req[:8]) == [250.0] * 8
    # a call's block is its own: a second call prepared before the first
    # launches leaves the first's request and out as they were
    args2, out2 = KG.prepare_capacity(free, np.zeros(8, np.float32))
    assert list(args.req[:8]) == [250.0] * 8 and args.out == out.data_ptr()
    assert list(args2.req[:8]) == [0.0] * 8 and args2.out == out2.data_ptr()
    assert plan.args.free is None and plan.args.out is None
    # a plan a stream: launches on two streams share no scratch
    other = KG.cap_plan(8192, 8, 20, free.device, stream=1234)
    assert other is not plan and other.partials.data_ptr() != \
        plan.partials.data_ptr()


def test_k7b_refuses_a_device_request_and_past_its_limit():
    """The request's values ride in the launch's argument block: a request
    tensor on a device is refused (reading it back would be a copy; a
    meta tensor stands for one here), and so is a row past CAP_R_MAX
    columns, with the limit in the message."""
    import numpy as np
    import torch

    free = torch.zeros((64, 8))
    with pytest.raises(ValueError, match="travels by value"):
        KG.gang_capacity(free, torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match=f"at most {KG.CAP_R_MAX}"):
        KG.host_request(np.zeros(KG.CAP_R_MAX + 1, np.float32))
    with pytest.raises(ValueError, match="columns against 8"):
        KG.prepare_capacity(free, np.zeros(9, np.float32))
    assert KG.host_request(torch.ones(74)).dtype == np.float32
