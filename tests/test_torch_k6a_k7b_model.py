"""Models of K6a's and K7b's kernels, run on the CPU through the argument
blocks their wrappers fill, held to the twins.

Neither kernel runs here (no card, no nvcc). What a CPU test can hold is
the arithmetic and the addressing around them: each model below reads
its inputs only through the ctypes argument block the wrapper prepares
(pointers, row strides, the request carried by value) and follows the
kernel's own work split, then the result is compared with the twin on
the same inputs.

- K6a (csrc/preempt_sweep.cu): each CTA stages its pod's request, the
  freed-column bitmask and the columns; a group of ``lanes`` lanes a
  node votes on "unresolvable or a kept column does not fit", keeps its
  columns' bases in the group's shared row, then takes the prefixes
  ``lanes`` at a time, the first fit by ballot. Held exactly against the twin on seeded
  clusters (C = 4 with a padding alias, C = 8; P = 4; with and without
  the live-free override; R = 8 at 8 lanes a node, a lane a column, and
  R = 74 at 16, five columns a lane).
- K7b (csrc/gang_capacity.cu): one thread a row, exact integer partials
  with a NaN flag a CTA, the last CTA's fold in CTA order. Held exactly
  against the twin on rows past 2^24 in total, an inactive request, NaN
  rows, a strided view of a wider blob, at 512 rows (one CTA) and 8,192
  (16 CTAs).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import tests.torch_port_support  # noqa: F401  (thread cap)
from kubernetes_tpu_torch.kernels import gang as KG
from kubernetes_tpu_torch.kernels import preempt as KP
from kubernetes_tpu_torch.ops.features import Capacities
from tests.test_torch_kernel_layout import _k6a_case, own_counters  # noqa: F401

pytestmark = pytest.mark.torch_port

F32 = np.float32


def _f32(ptr: int, k: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_float * k).from_address(ptr))


def _i32(ptr: int, k: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_int * k).from_address(ptr))


def _u8(ptr: int, k: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_uint8 * k).from_address(ptr))


def sweep_model(a, plan) -> np.ndarray:
    """csrc/preempt_sweep.cu's kernel, read through SweepArgs ``a``."""
    out = np.full((a.P, a.N), -7, np.int32)
    lanes, R, C, K1 = plan.lanes, a.R, a.C, a.K1
    cols = _i32(a.cols, C)
    bits = [0] * (-(-R // 32))
    for col in cols:
        if col >= 0 and (col >> 5) < len(bits):
            bits[col >> 5] |= 1 << (col & 31)
    sok = _u8(a.static_ok, a.P * a.N)
    for p in range(a.P):
        s_req = _f32(a.req + 4 * p * a.pod_f32_stride, R).copy()
        own_row = int(_i32(a.nominated_row + 4 * p * a.pod_i32_stride,
                           1)[0])
        for n in range(plan.ctas_x * plan.nodes):
            if n >= a.N:
                continue
            if not sok[p * a.N + n]:
                out[p, n] = -1
                continue
            fr = _f32(a.free + 4 * n * a.free_stride, R)
            nm = _f32(a.nom + 4 * n * a.node_stride, R)
            al = _f32(a.alloc + 4 * n * a.node_stride, R)
            own = n == own_row
            votes, base = [], [None] * R
            for gl in range(lanes):
                bad = False
                for r in range(gl, R, lanes):
                    q = s_req[r]
                    freed = (bits[r >> 5] >> (r & 31)) & 1
                    b = F32(fr[r] - nm[r])
                    b = F32(b + (q if own else F32(0.0)))
                    base[r] = b
                    bad |= bool(q > al[r]) or (not freed and not q <= b)
                votes.append(bad)
            if any(votes):
                out[p, n] = -1
                continue
            cs = _f32(a.cumsum + 4 * n * K1 * C, K1 * C).reshape(K1, C)
            out[p, n] = -1
            for k0 in range(0, K1, lanes):
                hits = []
                for gl in range(lanes):
                    k = k0 + gl
                    fit = k < K1
                    c = 0
                    while fit and c < C:
                        col = cols[c]
                        fit = bool(s_req[col] <= F32(base[col] + cs[k, c]))
                        c += 1
                    hits.append(fit)
                if any(hits):
                    out[p, n] = k0 + hits.index(True)
                    break
    return out


@pytest.mark.parametrize("seed,extra,ext", [(1, False, 4), (2, True, 4),
                                            (2, True, 70)],
                         ids=["C4_R8", "C8_R8", "C8_R74"])
def test_sweep_model_equals_the_twin(own_counters, seed, extra, ext):  # noqa: F811
    caps = Capacities(nodes=64, pods=512, ext_resources=ext)
    m, cb, pb, cs, cols, live = _k6a_case(caps, seed, extra)
    want_c = 8 if extra else 4
    assert cs.shape[2] == want_c
    for free in (None, live):
        launch = KP.prepare_sweep(cb, pb, m.well_known(), cs, cols, caps,
                                  free=free)
        got = sweep_model(launch.args, launch.plan)
        want = KP.preempt_sweep_ref(cb, pb, m.well_known(), cs, cols, caps,
                                    None, free).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want == -1).any() and (want >= 1).any()
        assert len(set(want[want >= 0].tolist())) >= 2
    assert launch.plan.lanes == (16 if ext == 70 else 8)


def capacity_model(a) -> int:
    """csrc/gang_capacity.cu's kernel, read through CapArgs ``a``."""
    limit = F32(2.0 ** 30)
    req = np.array(a.req[:a.R], F32)
    parts, flags = [], []
    for b in range(a.ctas):
        total, nan = 0, False
        for n in range(b * KG.CAP_ROWS, min((b + 1) * KG.CAP_ROWS, a.N)):
            fr = _f32(a.free + 4 * n * a.free_stride, a.R)
            pn = limit
            for r in range(a.R):
                q, pc = req[r], limit
                if q > 0:
                    f = fr[r]
                    f = f if f != f else (f if f > 0 else F32(0.0))
                    pc = np.floor(F32(f / q))
                if r == 0 or pn != pn:
                    pn = pc if r == 0 else pn
                elif pc != pc or pc < pn:
                    pn = pc
            if pn == pn:
                pn = min(max(pn, F32(0.0)), limit)
            nan |= pn != pn
            total += 0 if pn != pn else int(pn)
        parts.append(total)
        flags.append(nan)
    tot = F32("nan") if any(flags) else F32(float(sum(parts)))
    tot = tot if (req > 0).any() else limit
    if tot != tot:
        return 0
    return 2147483647 if tot >= 2.0 ** 31 else int(tot)


@pytest.mark.parametrize("n", [512, 8192])
@pytest.mark.parametrize("case", ["fuzz", "tiny", "inactive", "nan",
                                  "strided"])
def test_capacity_model_equals_the_twin(case, n):
    rng = np.random.default_rng(n + len(case))
    blob = (rng.integers(-2, 40, size=(n, 20)) * 100).astype(F32)
    req = np.zeros((8,), F32)
    req[0], req[1] = 900.0, 200.0 * 2 ** 20
    blob[:, 5] = rng.integers(0, 64, size=n) * 2.0 ** 28
    if case == "tiny":
        req[:] = 0.0
        req[0] = 0.5                        # totals past 2^24
    elif case == "inactive":
        req[:] = 0.0
    elif case == "nan":
        blob[n // 3, 4] = np.nan
    free = torch.from_numpy(blob)[:, 4:12]
    if case != "strided":
        free = free.contiguous()
    args, _out = KG.prepare_capacity(free, req)
    assert args.ctas == n // KG.CAP_ROWS
    got = capacity_model(args)
    want = int(KG.capacity_ref(free, torch.from_numpy(req)))
    assert got == want
    if case == "nan":
        assert want == 0
    elif case == "inactive":
        assert want == 2 ** 30
    elif case == "tiny" and n == 8192:
        assert want > 2 ** 24
