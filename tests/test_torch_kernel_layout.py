"""The ctypes mirrors of K3's and K2a's argument structs, and K3's
shared-memory planner (kernels/scan.py plan_scan).

The kernels read their arguments as C structs (csrc/serial_scan.cu
ScanArgs, csrc/auction_score_argmax.cu AuctionArgs) that the wrappers fill
through ctypes structures: a member out of order or of another type there
is a wrong pointer on the card, which no CPU test would see. These tests
parse the members from the sources and hold them, in name, type and order,
against the ctypes ``_fields_``; and the planned arrays' names against the
kernel's PA_* enum.

The planner is held on the shapes of every chip_smoke.py K3 workload
(the three hard drains, MixedSchedulingBasePod's init scans, the pct
window, the port-clash launches, K3 + K9 at the cap): every byte offset
inside the block's 227 KB (232,448 bytes), aligned and disjoint, the
node-space carries in shared memory, and no refusal of shapes the
previous cooperative-grid wrapper served (large N, G1 = B, ports). The
fixed front of the layout is evaluated from the kernel's own source.

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
from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.kernels import scan as KS

pytestmark = pytest.mark.torch_port

CSRC = os.path.join(os.path.dirname(KS.__file__), "..", "csrc")

_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
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
    assert [n for n, _ in KL.LearnedNet._fields_] == [n for n, _ in want]


def test_placed_arrays_match_kernel_enum():
    body = re.search(r"enum\s*\{(.*?)\};", _source("serial_scan.cu"), re.S)
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    assert names[-1] == "PA_COUNT"
    assert [n[3:].lower() for n in names[:-1]] == list(KS.PLACED_NAMES)


def test_layout_constants_match_kernel():
    consts = _defines(_source("serial_scan.cu"))
    for name in ("MAX_THREADS", "MAX_WARPS", "MAX_C", "RF", "RI",
                 "SLOT_WORDS", "MISC_WORDS", "BEST_HEAD", "MAX_CLUSTER"):
        assert consts[name] == getattr(KS, name), name


# ------------------------------------------------------------ the planner

# K9 at its cap: 9 -> 64 x 7 -> 1 (kernels/learned.py MAX_WIDTH, MAX_LAYERS)
_CAP_DIMS = (9,) + (KL.MAX_WIDTH,) * (KL.MAX_LAYERS - 1) + (1,)
_CAP_LF = (sum(a * b + b for a, b in zip(_CAP_DIMS, _CAP_DIMS[1:])) + 3) & ~3


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
    ("K3 + K9 at the cap", _topo(d=8), _CAP_LF, ()),
    ("K3 + K9 cap, pct", _plain(g1=2), _CAP_LF, ()),
)


def _check_plan(plan: KS.ScanPlan, dims: dict, lf: int) -> None:
    assert 0 < plan.smem_bytes <= KS.SMEM_MAX
    assert plan.fixed_bytes == KS.fixed_layout(lf, dims["G"], dims["A"],
                                               dims["C"], dims["TK"])
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


def test_plan_prefers_carries_over_rows():
    """With room for only part of the arrays, the carries are placed and
    the read-only rows fall back first."""
    dims = _topo(g=2, d=8)
    plan = KS.plan_scan(dims, _CAP_LF, 16)
    placed = dict(zip(KS.PLACED_NAMES, plan.off))
    assert not plan.global_carries
    assert all(placed[c] >= 0 for c in ("forbid1", "map2", "pres", "wscore",
                                        "cnt_match", "free", "nzr"))
    assert any(placed[n] < 0 for n, _, kind, _ in KS.PLACED
               if kind == "row")


def _c_fixed_end(lf: int, g: int, a: int, c: int, tk: int) -> int:
    """csrc/serial_scan.cu's fixed_layout, evaluated from its source."""
    text = _source("serial_scan.cu")
    consts = _defines(text)
    body = re.search(r"Fixed fixed_layout\([^)]*\)\s*\{(.*?)return f;",
                     text, re.S).group(1)
    env = {**consts, "lf": lf, "G": g, "A": a, "C": c, "TK": tk,
           "a16": lambda x: (x + 15) & ~15,
           "best_words": KS.best_words, "f": {}}
    for name, expr in re.findall(r"f\.(\w+)\s*=\s*([^;]+);", body):
        expr = re.sub(r"f\.(\w+)", r"f['\1']", expr).replace("/", "//")
        env["f"][name] = eval(expr, {"__builtins__": {}}, env)  # noqa: S307
    return env["f"]["end"]


@pytest.mark.parametrize("lf,g,a,c,tk", [
    (0, 0, 0, 0, 0), (0, 2, 4, 4, 8), (_CAP_LF, 8, 4, 4, 8),
    (12, 64, 4, 4, 32), (0, 3, 1, 5, 7)])
def test_fixed_layout_matches_kernel_source(lf, g, a, c, tk):
    assert KS.fixed_layout(lf, g, a, c, tk) == _c_fixed_end(lf, g, a, c, tk)
    src = _source("serial_scan.cu")
    m = re.search(r"best_words\(int G, int C, int TK\)\s*\{\s*return"
                  r"\s*([^;]+);", src)
    expr = m.group(1).replace("/", "//")
    env = {**_defines(src), "G": g, "C": c, "TK": tk}
    assert eval(expr, {"__builtins__": {}}, env) == KS.best_words(g, c, tk)


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

