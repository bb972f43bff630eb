#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):

1. Card: the card's name and power limit (nvidia-smi) and torch's name.
2. Build: nvcc builds the three kernels from csrc/*.cu (sm_90a).
3. K1 phase1_static vs its plain-torch twin on the card: a seeded cluster
   of 5,000 nodes (bucket 8,192) with taints, labels, host ports and
   images, and 8 pod rows using every feature. Masks and counts exact;
   scores within 1e-4 absolute on their 0-100 scale (expected exact: the
   kernels are built with -fmad=false and repeat the twin's operations).
4. K2 (auction_score_argmax + auction_accept_commit) vs the twins: one
   whole launch of 4,096 pods over that cluster (B <= N: one accept per
   node) and one of 4,096 pods over 1,000 nodes in a 1,024 bucket (B > N:
   K-accept). Node rows, counts, free, nzr and guard exact; winning scores
   within 1e-4.
5. The main path at full width: SchedulingBasic (5,000 nodes, 1,000 init +
   10,000 measured pods, batch 4,096) through perf.harness.run_workload
   on the card. Every pod bound, no node overcommitted (recomputed on the
   host from the bound pods' requests), every kernel launched. A second,
   profiled run of the drain gives the device's busy and idle share.
6. Reduced drain parity: 500 nodes / 1,100 pods through the same entry
   point on the card (kernels) and on the CPU (twins): identical bindings.
7. One JSON line of per-kernel numbers (launches in phase 5's drain,
   median time over CUDA-event-timed launches at the main path's shapes,
   the twin's time, the bound), then the result line.

Exits non-zero without printing a result when no CUDA device is available
or when the package is missing beside this script.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import random
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor fp32
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SCORE_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warm: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fake_clock():
    """A deterministic clock: distinct, increasing queue timestamps."""
    tick = itertools.count()
    return lambda: 1000.0 + next(tick) * 1e-3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubernetes_tpu_torch.api.resources import Resource, pod_request
    from kubernetes_tpu_torch.backend.cache import Cache
    from kubernetes_tpu_torch.backend.mirror import Mirror
    from kubernetes_tpu_torch.backend.snapshot import Snapshot
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import phase1 as K1
    from kubernetes_tpu_torch.models import pipeline as P
    from kubernetes_tpu_torch.ops.features import (
        Capacities,
        unpack_cluster,
        unpack_pods,
    )
    from kubernetes_tpu_torch.perf import workloads as W
    from kubernetes_tpu_torch.perf.fuzz import fuzz_cluster
    from kubernetes_tpu_torch.perf.harness import (
        CreateNodes,
        CreatePods,
        Workload,
        run_workload,
    )

    dev = torch.device("cuda")
    t_start = time.time()
    errs = {k: 0.0 for k in KB.KERNELS}

    # ---------------------------------------------------------- 1. card
    card = card_line()
    log(f"[1] card: {card} | torch: {torch.cuda.get_device_name(0)} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------------- 2. build
    build_s = KB.build_all()
    log(f"[2] built {', '.join(KB.KERNELS)} in {build_s:.1f} s")

    @contextlib.contextmanager
    def twins():
        """Route the launch through the plain-torch twins (comparison
        only; the wrappers never do this on the card)."""
        saved = (P.phase1_static, KA.auction_score_argmax,
                 KA.auction_accept_commit, KA.auction_final)
        P.phase1_static = K1.phase1_static_ref
        KA.auction_score_argmax = KA.auction_score_argmax_ref
        KA.auction_accept_commit = KA.auction_accept_commit_ref
        KA.auction_final = KA.auction_final_ref
        try:
            yield
        finally:
            (P.phase1_static, KA.auction_score_argmax,
             KA.auction_accept_commit, KA.auction_final) = saved

    def fuzz_mirror(seed, n_nodes, node_cap, n_pods, n_specs):
        """A synced mirror over a fuzz cluster and a batch of ``n_pods``
        pods drawn from ``n_specs`` distinct fuzz specs."""
        rng = random.Random(seed)
        nodes, bound, specs = fuzz_cluster(rng, n_nodes, n_specs,
                                           n_bound=n_nodes // 10)
        caps = Capacities(nodes=node_cap, pods=2048)
        cache = Cache()
        for n in nodes:
            cache.add_node(n)
        for p in bound:
            cache.add_pod(p)
        snap = Snapshot()
        cache.update_snapshot(snap)
        mirror = Mirror(caps=caps, device=dev)
        mirror.sync(snap)
        pods = []
        for i in range(n_pods):
            p = specs[i % n_specs].clone()
            p.metadata.name = f"{p.metadata.name}-{i}"
            p.metadata.uid = f"{p.metadata.uid}-{i}"
            pods.append(p)
        return mirror, caps, pods

    def cmp_exact(name, a, b):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{name}: kernel and twin differ at {bad} "
                                 "entries")

    def cmp_close(name, a, b, kernel):
        err = float((a.double() - b.double()).abs().max()) if a.numel() \
            else 0.0
        errs[kernel] = max(errs[kernel], err)
        if not err <= SCORE_TOL:
            raise AssertionError(f"{name}: max abs err {err} > {SCORE_TOL}")

    # ------------------------------------------------- 3. K1 vs its twin
    mirror, caps, pods = fuzz_mirror(11, 5000, 8192, 8, 8)
    spec = mirror.prepare_launch(pods, 8)
    assert set(spec.active) == {"nodeaffinity", "taints", "ports",
                                "images"}, spec.active
    rows = torch.arange(8, device=dev)
    prow_f32, prow_i32 = P.full_pod_rows(spec.pblobs, spec.ptmpl, caps,
                                         spec.pfields, rows)
    wk = mirror.well_known()
    enabled = (True,) * K1.NUM_STATIC
    got = K1.phase1_static(spec.cblobs, prow_f32, prow_i32, caps, wk,
                           enabled, spec.active)
    want = K1.phase1_static_ref(spec.cblobs, prow_f32, prow_i32, caps, wk,
                                enabled, spec.active)
    torch.cuda.synchronize()
    for field in ("static_ok", "rejects", "unres"):
        cmp_exact(f"K1 {field}", getattr(got, field), getattr(want, field))
    for field in ("taint_raw", "aff_raw", "img"):
        cmp_close(f"K1 {field}", getattr(got, field), getattr(want, field),
                  "phase1_static")
    feasible = int(want.static_ok.sum())
    log(f"[3] K1 phase1_static == twin on G=8 x N=8192 "
        f"({feasible} feasible pairs, rejects {want.rejects.sum(0).tolist()},"
        f" max score err {errs['phase1_static']:g})")

    # ------------------------------------------------- 4. K2 vs its twins
    for tag, (seed, n_nodes, node_cap) in (("B<=N", (12, 5000, 8192)),
                                           ("B>N", (13, 1000, 1024))):
        mirror, caps, pods = fuzz_mirror(seed, n_nodes, node_cap, 4096, 8)
        spec = mirror.prepare_launch(pods, 4096)
        args = (spec, mirror.well_known(), P.default_weights(), caps)
        out = P.launch_batch(*args, serial_scan=False, tie_seed=7, device=dev)
        with twins():
            ref = P.launch_batch(*args, serial_scan=False, tie_seed=7,
                                 device=dev)
        torch.cuda.synchronize()
        for field in ("node_row", "feasible_count", "reject_counts",
                      "unresolvable_count", "guard"):
            cmp_exact(f"K2 {tag} {field}", getattr(out, field),
                      getattr(ref, field))
        cmp_exact(f"K2 {tag} free", out.free, ref.free)
        cmp_exact(f"K2 {tag} nzr", out.nzr, ref.nzr)
        cmp_close(f"K2 {tag} score", out.score, ref.score,
                  "auction_score_argmax")
        placed = int((out.node_row >= 0).sum())
        log(f"[4] K2 {tag} == twin: {placed}/4096 placed over {n_nodes} "
            f"nodes (bucket {node_cap}), {out.round_trips} flag round "
            f"trip(s), max score err {errs['auction_score_argmax']:g}")

    # ------------------------------------------ 5. the main path, full width
    w = W.scheduling_basic()
    end_state = {}

    def check_end_state(sched, hub):
        end_state["pods"] = hub.list_pods()
        end_state["nodes"] = hub.list_nodes()

    KB.reset_launches()
    t0 = time.time()
    res = run_workload(w, device="cuda", on_scheduler=check_end_state)
    drain_s = time.time() - t0
    launches = dict(KB.LAUNCHES)
    pods_all = end_state["pods"]
    unbound = [p.metadata.name for p in pods_all if not p.spec.node_name]
    if len(pods_all) != 11000 or unbound:
        raise AssertionError(f"drain: {len(pods_all)} pods, "
                             f"{len(unbound)} unbound")
    used: dict[str, list] = {}
    for p in pods_all:
        r = pod_request(p)
        u = used.setdefault(p.spec.node_name, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    for n in end_state["nodes"]:
        u = used.get(n.metadata.name, [0, 0, 0])
        alloc = Resource.from_map(n.status.allocatable)
        if u[0] > alloc.milli_cpu or u[1] > alloc.memory \
                or u[2] > alloc.allowed_pod_number:
            raise AssertionError(f"node {n.metadata.name} overcommitted: "
                                 f"{u}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the drain: "
                             f"{missing}")
    st = res["stats"]
    split = {k: round(v, 3) for k, v in st["time_s"].items()}
    log(f"[5] SchedulingBasic 5000 nodes / 11000 pods on {card}: all bound,"
        f" no node overcommitted; measured {res['pods_per_sec']} pods/s "
        f"over {res['elapsed_s']} s (whole drain {drain_s:.1f} s); "
        f"{st['launches']} launches ({st['chained_launches']} chained), "
        f"{st['round_trips'] / max(st['launches'], 1):.2f} flag round "
        f"trips per launch (x{P.auction_unroll()} rounds); host time split "
        f"s {split}; kernel launches {launches}")

    # ----------------------- 5b. the device's busy share of the same drain
    # a second, profiled run of the drain (the first stays unprofiled so
    # its pods/s carries no tracing cost)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_workload(w, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.time() - t0
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
                  for e in prof.key_averages())
    if busy_us > 0:
        log(f"[5b] profiled drain: device busy {busy_us / 1e6:.4f} s of "
            f"{wall_s:.2f} s wall, idle share "
            f"{1.0 - busy_us / 1e6 / wall_s:.4f}")
    else:
        log("[5b] profiled drain: the profiler recorded no device time; "
            "idle share not measured")

    # ------------------------------------------- 6. reduced drain parity
    def reduced():
        return Workload(
            name="SchedulingBasic/500Nodes_1100Pods", batch_size=256,
            node_capacity=512, pod_capacity=4096,
            ops=[CreateNodes(500, W._node),
                 CreatePods(100, lambda i: W._pod(f"init-{i}")),
                 CreatePods(1000, lambda i: W._pod(f"measure-{i}"))])

    placements = {}
    for device in ("cuda", "cpu"):
        got_map = {}
        run_workload(reduced(), now=fake_clock(), device=device,
                     on_scheduler=lambda s, hub, m=got_map: m.update(
                         {p.metadata.name: p.spec.node_name
                          for p in hub.list_pods()}))
        placements[device] = got_map
    diff = [k for k in placements["cpu"]
            if placements["cpu"][k] != placements["cuda"].get(k)]
    if diff or len(placements["cpu"]) != 1100:
        raise AssertionError(f"reduced drain: {len(diff)} of "
                             f"{len(placements['cpu'])} pods bound "
                             "differently on the card and the CPU")
    log("[6] reduced drain 500 nodes / 1100 pods: card (kernels) and CPU "
        "(twins) bind all 1100 pods identically")

    # ------------------------------------------------- 7. kernel numbers
    # the main path's launch: SchedulingBasic nodes, one full batch
    caps = Capacities(nodes=w.node_capacity, pods=w.pod_capacity)
    cache = Cache()
    for i in range(5000):
        cache.add_node(W._node(i))
    snap = Snapshot()
    cache.update_snapshot(snap)
    mirror = Mirror(caps=caps, device=dev)
    mirror.sync(snap)
    spec = mirror.prepare_launch([W._pod(f"t-{i}") for i in range(4096)],
                                 4096)
    wk = mirror.well_known()
    rows, g_of = P.phase1_rows(spec.gid, spec.rep, 4096, dev)
    prow_f32, prow_i32 = P.full_pod_rows(spec.pblobs, spec.ptmpl, caps,
                                         spec.pfields, rows)
    filters = (True,) * K1.NUM_STATIC
    k1 = lambda: K1.phase1_static(spec.cblobs, prow_f32, prow_i32,  # noqa
                                  caps, wk, filters, spec.active)
    k1_ref = lambda: K1.phase1_static_ref(  # noqa: E731
        spec.cblobs, prow_f32, prow_i32, caps, wk, filters, spec.active)
    p1 = k1()
    ct = unpack_cluster(spec.cblobs, caps)
    pods_f = unpack_pods(spec.pblobs, caps, spec.pfields, spec.ptmpl)
    free0, nzr0 = P.extract_state(spec.cblobs, caps)
    rin = P.round_inputs(ct, pods_f, g_of, p1, P.default_weights(), free0,
                         nzr0)
    prog = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    choice, win_now = KA.auction_score_argmax(rin, prog, 0)
    torch.cuda.synchronize()
    accepted = [0]

    def k2b():
        KA.auction_accept_commit(rin, choice, win_now, prog, 0)

    times = {
        "phase1_static": (cuda_ms(torch, k1), cuda_ms(torch, k1_ref)),
        "auction_score_argmax": (
            cuda_ms(torch, lambda: KA.auction_score_argmax(rin, prog, 0)),
            cuda_ms(torch, lambda: KA.auction_score_argmax_ref(rin, prog, 0))),
    }
    snap_state = (rin.free.clone(), rin.nzr.clone(), rin.placed.clone(),
                  rin.win.clone())

    def restore():
        rin.free.copy_(snap_state[0])
        rin.nzr.copy_(snap_state[1])
        rin.placed.copy_(snap_state[2])
        rin.win.copy_(snap_state[3])

    k2b()
    accepted[0] = int((rin.placed >= 0).sum())
    restore()
    times["auction_accept_commit"] = (
        cuda_ms(torch, k2b),
        cuda_ms(torch, lambda: KA.auction_accept_commit_ref(
            rin, choice, win_now, prog, 0)))
    restore()

    n, r = caps.nodes, caps.res_cols
    b = 4096
    g = int(rows.shape[0])
    pf, pi = prow_f32.shape[1], prow_i32.shape[1]
    bidders = b
    # bytes each kernel must move at these shapes (inputs read once,
    # outputs written once) and the operations its data needs
    work = {
        "phase1_static": (
            n * (r + 3) * 4 + g * (pf + pi) * 4 + g * n * 13 + g * 24,
            g * n * (r + 8)),
        "auction_score_argmax": (
            n * (2 * r + 4) * 4 + b * (r + 6) * 4 + g * n * 13 + b * 8,
            bidders * n * (3 * r + 30)),
        "auction_accept_commit": (
            b * (4 + 4 + 4 * r + 8 + 4) + n * (3 * r + 4) * 4 + b * 8,
            accepted[0] * (r + 2)),
    }
    sources = {
        "phase1_static": ("kubernetes_tpu_torch/csrc/phase1_static.cu",
                          "kubernetes_tpu/models/pipeline.py:968"),
        "auction_score_argmax": (
            "kubernetes_tpu_torch/csrc/auction_score_argmax.cu",
            "kubernetes_tpu/models/pipeline.py:649"),
        "auction_accept_commit": (
            "kubernetes_tpu_torch/csrc/auction_accept_commit.cu",
            "kubernetes_tpu/models/pipeline.py:674"),
    }
    kernels = []
    for name in KB.KERNELS:
        nbytes, ops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        ms, plain_ms = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    log(f"[7] kernel times at the main path's shapes (G={g}, B={b}, "
        f"N={n}, R={r}); whole script {time.time() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
