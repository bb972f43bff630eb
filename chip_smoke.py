#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):

1. Card: the card's name and power limit (nvidia-smi) and torch's name.
2. Build: nvcc builds the twelve kernel sources from csrc/*.cu (sm_90a),
   one nvcc each, all started together; ptxas's registers, spills, stack
   and static shared memory of K3 (both instantiations) and K2a's bid.
3. K1 phase1_static vs its plain-torch twin on the card: a seeded cluster
   of 5,000 nodes (bucket 8,192) with taints, labels, host ports and
   images, and 8 pod rows using every feature. Masks (static_ok and the
   TaintToleration / NodeAffinity masks K5 reads) and counts exact;
   scores within 1e-4 absolute on their 0-100 scale (expected exact: the
   kernels are built with -fmad=false and repeat the twin's operations).
4. K2 (auction_score_argmax + auction_accept_commit) vs the twins: one
   whole launch of 4,096 pods over that cluster (B <= N: one accept per
   node) and one of 4,096 pods over 1,000 nodes in a 1,024 bucket (B > N:
   K-accept). Node rows, counts, free, nzr and guard exact; winning scores
   within 1e-4.
3b. K5 (topo_table, topo_nodes, topo_pairs) vs its twins on the card: a
   seeded topology cluster of 5,000 nodes (bucket 8,192) in 3 zones with
   hostnames and racks, a pod table of 16,384 slots in 2 namespaces holding
   12,000 bound pods with required / preferred (anti)affinity and spread
   constraints, and 4 groups mixing hard and soft terms, with a hostname
   key (domain bucket 8,192). K1 on those groups against its twin, and K5
   against its twins with each side fed its own K1's masks; every output
   exact.
3c. K3 (serial_scan) vs its twin on the card: one topology launch of 256
   pods with hard and soft terms plus host ports over the same cluster,
   and one no-topology host-port launch. Every BatchResult field exact;
   the hostPort pre-pass (scan_port_conf) launched once for each.
10. The soft-score auction vs the twins on the card: three soft-only
   launches of 2,048 pods (2,040 and a padding group; 4 specs from the
   seeded topology fuzz, made soft) run whole through the kernels and
   through the twins: zone and rack keys over 5,000 nodes (D = 8); hostname
   keys over 5,000 nodes with a 12,000-pod table whose required terms
   give a real InterPodAffinity mask, with that filter switched off
   (D = 8,192); hostname keys over 1,000 nodes in a 1,024 bucket (B > N,
   the K-accept rounds). K5's statics, the soft view, every round's K4
   outputs (ipa_live, sp_r) and K2a bids (choice, win), and the
   BatchResult (rows, scores, counts, free, nzr, guard) exact.
10d. K3 on a soft-only launch (B = 256, the route launch_batch takes with
   serial_scan=True) vs its twin, every field exact.
5. The main path at full width: SchedulingBasic (5,000 nodes, 1,000 init +
   10,000 measured pods, batch 4,096) through perf.harness.run_workload
   on the card. Every pod bound, no node overcommitted (recomputed on the
   host from the bound pods' requests), every kernel launched. A second,
   profiled run of the drain gives the device's busy and idle share.
6. Reduced drain parity: 500 nodes / 1,100 pods through the same entry
   point on the card (kernels) and on the CPU (twins): identical bindings.
8. The hard-topology paths at full width, each through
   perf.harness.run_workload on the card with the launch counters zeroed
   just before it: TopologySpreading/5000Nodes_5000Pods,
   SchedulingPodAntiAffinity/5000Nodes_2000Pods and
   SchedulingPodAffinity/5000Nodes_5000Pods. Checked on the host from the
   bound pods alone: every pod bound, no node overcommitted, and the
   constraint holds (blue pods' per-zone counts within maxSkew 5; no two
   anti-affinity pods on one node; every affinity pod in a zone holding
   another blue pod); K1, K5 and K3 launched.
8c. On each of those drains' first topology launch and its first launch
   with pods in its table (one launch on TopologySpreading, whose table
   holds the init pods; copies of the inputs kept during the drain;
   B = 2,048, N = 8,192, D = 8 or 8,192): K1, K5 stage by stage and K3
   against their twins, every output exact, K3's carry maps too. On the
   later of the two: CUDA-event times of each, K3 in turns with the
   previous design (old, new, new, old; from build/previous, where
   present); the scan's two cluster barriers a pod launched alone on its
   cluster for B pods (this design's step floor) and the previous
   design's three grid barriers a pod on its grid; K3's cluster shape,
   carries layout and ptxas report; its phases in SM cycles a step (the
   profile build, csrc/serial_scan.cu SCAN_PROFILE); the drain's scans
   whose carries stayed in global memory (serial_scan_global_carries).
8b. A profiled repeat of TopologySpreading gives the device's idle share.
9. Reduced TopologySpreading parity: 300 nodes / 900 pods on the card
   (kernels) and on the CPU (twins): identical bindings.
11. The soft-only topology paths at full width, each through
   perf.harness.run_workload on the card with the launch counters zeroed
   just before it: SchedulingPreferredPodAffinity and
   SchedulingPreferredPodAntiAffinity/5000Nodes_5000Pods,
   PreferredTopologySpreading/5000Nodes_5000Pods and
   MixedSchedulingBasePod/5000Nodes_5000Pods (pod table 32,768). Every
   pod bound, no node overcommitted, the placement profile printed (zones
   and distinct nodes of the measured pods), K1, K5, K4, K2a and K2b
   launched. 11c: copies of each drain's first two soft-only launches (the
   first measured one, and one whose table holds the preferred pods the
   first placed), each run whole through kernels and twins: every output
   exact, as in phase 10. 11e: on the later one, CUDA-event medians of
   K4's stages (the end-state placed set), K2a in soft mode and K2b (the
   first round; K2a in turns with the previous design and its launch
   shape), and the whole launch by each commit engine (the soft
   auction, the serial scan). 11b: a profiled repeat of
   SchedulingPreferredPodAffinity gives the device's idle share.
12. K6a (K1 with every feature, then preempt_sweep) vs its literal twin
   on the card: 5,000 fuzz nodes (bucket 8,192) with taints, labels and
   host ports, PreemptionAsync's fillers plus memory-only and
   extended-resource victims (the Evaluator's victim state: C = 4 with a
   padding alias and k_cap 8; C = 8 and k_cap 16), nominated
   reservations, P = 1 and 64, with and without a live-free override, the
   C = 8 case again at R = 74 (70 extended-resource columns); and the
   inactive-column case of tests/test_preemption.py:323. kmin exact.
12b. K6b (K1 -> K5 over the masked table -> preempt_feasible's fold) vs
   its literal twin: the topology fuzz (5,000 nodes, a 12,000-pod table in
   2 namespaces), preemptors with hard zone spread (with and without
   minDomains), required zone affinity, required hostname anti-affinity
   and fuzz specs; three table masks with the free raised on the masked
   rows; topology on (D = 8, 8,192) and off. [N] exact.
13. PreemptionAsync/5000Nodes at full width (20,000 fillers, a 3,000m
   priority-10 churn pod every 200 ms, 5,000 measured pods) through
   perf.harness.run_workload, launch counters zeroed just before; drained
   until every churn preemptor created before the measured phase ended is
   bound. Every measured pod bound, no priority-10 pod evicted, no node
   overcommitted, every preemptor's node keeps at most one filler; K1,
   K2a, K2b launched; K6's counts printed (0: the batched fit-only path
   sweeps on the host, as the reference does).
13b. The full PostFilter path at full width through a Hub and a
   Scheduler: 5,000 nodes each holding one priority-0 app=red pod, 128
   priority-10 preemptors with a required hostname anti-affinity term
   against app=red, every eighth also with a DoNotSchedule hostname
   spread constraint (maxSkew 1) over its own app=blue label. Every
   preemptor bound, the red pods gone are exactly one on each node
   holding a preemptor (collisions of one failure batch share a node, as
   the JAX package does: tests/test_torch_preempt.py::
   test_reduced_postfilter_path_matches_jax), no node holds both, no two
   spread preemptors share a node, K6a and both K6b stages (spread
   minimum, fold) launched; the first three K6a and K6b calls' inputs and
   a spread preemptor's K6b call held against the twins; K6's kernel and
   twin times and a whole dry run's host wall.
14. Reduced parity, card (kernels) against CPU (twins): a 100-node
   PreemptionAsync with 20 priority-10 pods in place of the churn, and a
   300-node PostFilter path with 16 preemptors: identical bindings and
   evictions.
15. K1 + K7a (gang_pack) vs the twin on the card: seeded gang clusters
   (perf.fuzz.gang_fuzz) of 5,000 nodes (bucket 8,192) with 8 zones, 64
   zones and no zone label (tk = -1), and of 10,000 nodes (bucket 16,384)
   with 8 zones; bound pods, 40 nominated reservations handed back as the
   gangs' own; G = 16 gangs (15 representatives, from 3,500m to 1m / 1Ki,
   and a padding row), NodeResourcesFit on and off, three chained
   launches with sizes 2-64 and a first gang sized to fit exactly, and a
   launch whose first gang fails by one member. ok, alloc, cap, spans,
   free, nzr and guard exact.
15b. K7b (gang_capacity) vs its twin: the clusters' device-resident free
   views with four representatives' requests, a [8,192, 74] free matrix,
   and a request with no active column. Exact.
16. The gang workloads at full width through perf.harness.run_workload on
   the card, launch counters zeroed before each:
   MultiTenantGangStorm at scale 10 through its rescale hook (5,000
   nodes, 2 tenants 2:1, 480 gangs of 2-64, 10,080 members): every member
   bound, no node overcommitted, K7a launched at least once per 16
   device-packed gangs (480 and 30 launches when nothing falls back), no
   device fallback, the first three K7a calls held against the twin, the
   fallback reasons and the tenants' contended-admission ratio printed;
   GangTopologyPacking/96Nodes (its validate: mean zone spans <= 1.5);
   GangPreemption/128Nodes (every high gang bound whole, every evicted
   low gang evicted whole, none in part, no priority-10 pod evicted);
   QuotaExhaustionChurn/200Nodes (the burst tenant admits exactly its
   quota of 100, every steady pod bound). Each prints pods/s, the
   stats["time_s"] split with gang_device and gang_commit, and K7a's and
   K7b's launches.
16b. The Permit path on the card: the storm at scale 1 with
   gang_device_packing=False; every member bound, K7b launched, its first
   three calls held against the twin.
17. Reduced gang parity, card (kernels) against CPU (twins): the storm at
   scale 0.25 in both arms and GangPreemption at scale 0.25: identical
   bindings, evictions and tenant admissions.
18. K8 (dra_feasible) vs its twin: seeded DRA fuzz (perf.fuzz.dra_fuzz)
   over 5,000 nodes (bucket 8,192) with 8, 16 and 128 devices a node,
   1, 2 and 4 request slots and batches of 256 and 2,048 (past
   DRA_CHUNK), All mode, count 0, pins, inactive rows, in-use devices;
   dra_ok, dra_reject and the ANDed static_ok exact, with and without
   host verdicts.
19. The four DRA drains at their own sizes through perf.harness on the
   card (DRASteadyState 500 pods, ...ClaimTemplates 400, ...CELIn 300,
   DRAMultiRequest 250; 100 nodes with 8 or 16 devices, batch 256) and
   ...ClaimTemplates at 5,000 nodes / 5,000 pods: every pod bound, no
   node overcommitted, every claim allocated on its pod's node, no device
   booked twice, every device accepted by its request's class and
   selectors (recomputed on the host); pods/s, the time split with
   binder_drain, K8's launches, device and host-fallback pods; each
   drain's first K8 call held against the twin.
20. Reduced DRA parity, card (kernels) against CPU (twins): each of the
   four DRA drains at scale 0.2 on a simulated clock: identical bindings
   and allocated devices.
21. K3 with the percentageOfNodesToScore window vs its twin over 5,000
   nodes (bucket 8,192): pct 10 and adaptive, three chained launches of
   512 pods carrying pct_start, a start on a padding row, and 60 nodes
   (fewer feasible than k_find); then SchedulingBasic/5000Nodes_10000Pods
   with percentage_of_nodes_to_score=0 on the card (K3 only), its first K3
   call held against the twin and timed in turns with the previous design,
   the three cluster barriers a pod alone (the step floor with the
   window), K3's shape and phases.
22. K9 (the learned score term, csrc/learned_mlp.cuh) through its probe
   (csrc/learned_mlp.cu) vs ops/learned.py's learned_term on the card:
   fuzzed scorers at widths 1, 8, 16/8, 64 and 64 x 7 (the caps) over 2^20
   rows whose scores run past 0-100 both ways, a head driving the output
   past both clip edges, a NaN weight (NaN on every row in both), and the
   drains' scorer init_params(0, (8,)) over 4,096 x 8,192 rows (timed).
   Exact.
23. The learned profile (perf/workloads.py learned_config: the default
   profile with LearnedScore at weight 1.0, as bench.py --ab-scorer
   builds it; a checkpoint of init_params(0, (8,)) written by the port's
   save_checkpoint under build/learned/ and loaded by LearnedScore's
   watcher) on SchedulingBasic/5000Nodes_10000Pods (the auction: K1, K2a
   with K9, K2b), 23b TopologySpreading/5000Nodes_5000Pods (K5, K3 with
   K9) and 23c PreferredTopologySpreading/5000Nodes_5000Pods (K4, K2a's
   soft mode with K9), each beside its hand-tuned arm (same workload,
   same tie-break seed) with the launch counters zeroed just before each:
   every pod bound, no node overcommitted, K9 launched inside K2a / K3 in
   the learned arms and never in the hand arms; the arms run in turns
   (hand, learned, learned, hand), their pods/s and host phase splits on
   one line with the phase-total delta of each pair. SchedulingBasic
   publishes a second checkpoint (seed 1) after its second launch: the
   watcher picks it up (version 2, one reload) and no kernel is rebuilt.
   23d: K2a with K9 (plain and soft mode) on a copy of the first round of
   each auction drain's second learned launch, K3 with K9 on the
   TopologySpreading drain's first two scans, and its second scan launch
   again with the pct 10 window (K1, K5, K3 through launch_batch),
   against the twins: exact; K2a and K3 with and without K9 timed, with
   K9 in turns with the previous design.
   23e: a profiled repeat of the learned SchedulingBasic gives the
   device's idle share.
24. Card-against-CPU bindings of the learned profile at scale 0.2
   (SchedulingBasic 1,000 nodes / 2,200 pods, TopologySpreading 1,000
   nodes / 2,000 pods; batch 512, bucket 1,024 for the CPU twins) under
   a fixed tie-break seed: identical.
7. K2a's first round on the main path in turns with the previous design,
   its shape and block 0's phases (the profile build, BID_PROFILE); one
   line of K3's and K2a's times by path beside the previous design's and
   K3's step floors. One JSON line of per-kernel numbers: K1 and K2 at
   SchedulingBasic's shapes, K5's stages and K3 once per topology path,
   K4's stages, K2a and
   K2b once per soft path, K6a and K6b's two stages at the PostFilter
   path's inputs (named kernel@path), each with its launches in that
   path's own zeroed run, its median time over 20 CUDA-event-timed
   launches, the twin's time and the bound from the bytes and operations
   those inputs need (a kernel that stops early counts what it reads);
   K7a on a copy of the storm's first launch (K7a@MultiTenantGangStorm)
   and K7b on the Permit path's first call (K7b@PermitPath); K8 on each
   DRA drain's first call (K8@<drain>) and K3 with the window on the
   adaptive drain's first call (K3pct@SchedulingBasic); K9's probe at
   4,096 x 8,192 rows (learned_mlp, with its launches inside K2a in the
   learned SchedulingBasic drain), K2a with K9 on the learned auction
   drains' captured rounds and K3 with K9 on the learned
   TopologySpreading scan (name+K9@path); then the result line.

Exits non-zero without printing a result when no CUDA device is available
or when the package is missing beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor fp32
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SCORE_TOL = 1e-4


T_START = time.time()


def log(msg: str) -> None:
    """One phase's line, stamped with the seconds since the script began."""
    print(f"{msg} (t={time.time() - T_START:.1f} s)", flush=True)


# (start, seconds) of every full (generation-2) collection of the process,
# recorded once gc_watch() is installed: a drain's line reports those that
# started inside it
GC_FULL: list = []


def gc_watch() -> None:
    started = [0.0]

    def record(phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            GC_FULL.append((started[0], time.perf_counter() - started[0]))

    gc.callbacks.append(record)


def gc_since(t0: float) -> str:
    got = [d for start, d in GC_FULL if start >= t0]
    return f"{len(got)} full GC pauses ({sum(got):.3f} s)"


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


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def fake_clock():
    """A deterministic clock: distinct, increasing queue timestamps."""
    tick = itertools.count()
    return lambda: 1000.0 + next(tick) * 1e-3


def synced_mirror(torch, nodes, bound, caps, namespaces=()):
    """A mirror on the card synced from a cache of these namespaces, nodes
    and bound pods."""
    from kubernetes_tpu_torch.backend.cache import Cache
    from kubernetes_tpu_torch.backend.mirror import Mirror
    from kubernetes_tpu_torch.backend.snapshot import Snapshot

    cache = Cache()
    for ns in namespaces:
        cache.set_namespace(ns.metadata.name, ns.metadata.labels)
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    mirror = Mirror(caps=caps, device=torch.device("cuda"))
    mirror.sync(snap)
    return mirror


def batch_of(specs, n_pods):
    """``n_pods`` pods cycling through ``specs``, each its own name and
    uid."""
    pods = []
    for i in range(n_pods):
        p = specs[i % len(specs)].clone()
        p.metadata.name = f"{p.metadata.name}-{i}"
        p.metadata.uid = f"{p.metadata.uid}-{i}"
        pods.append(p)
    return pods


def fuzz_mirror(torch, seed, n_nodes, node_cap, n_pods, n_specs):
    """A synced mirror over a fuzz cluster and a batch of ``n_pods`` pods
    drawn from ``n_specs`` distinct fuzz specs."""
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf.fuzz import fuzz_cluster

    nodes, bound, specs = fuzz_cluster(random.Random(seed), n_nodes,
                                       n_specs, n_bound=n_nodes // 10)
    caps = Capacities(nodes=node_cap, pods=2048)
    return (synced_mirror(torch, nodes, bound, caps), caps,
            batch_of(specs, n_pods))


def topology_mirror(torch, seed, n_bound, n_specs, n_pods, ports=True,
                    nominate=True):
    """A synced mirror on the card over the seeded topology cluster
    (perf.fuzz.topology_fuzz: 5,000 nodes in a 8,192 bucket, a 16,384-slot
    pod table in 2 namespaces) and a batch of ``n_pods`` pods drawn from
    ``n_specs`` specs; one nominated pod occupies a table slot."""
    from kubernetes_tpu_torch.api.objects import ContainerPort
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf.fuzz import topology_fuzz

    nodes, bound, specs, namespaces = topology_fuzz(
        random.Random(seed), 5000, n_bound, n_specs, ports=ports)
    caps = Capacities(nodes=8192, pods=16384)
    mirror = synced_mirror(torch, nodes, bound, caps, namespaces)
    if ports:
        # at least one spec requests a host port
        specs[1].spec.containers[0].ports = [ContainerPort(
            container_port=80, host_port=8080)]
    if nominate:
        mirror.set_nominated({nodes[1].metadata.name: [specs[0].clone()]})
    return mirror, caps, batch_of(specs, n_pods)


def check_bound(end_state, want_pods: int, name: str) -> dict:
    """Every pod bound and no node overcommitted (cpu, memory, pod count),
    recomputed on the host from the bound pods' requests. Returns
    {node name: node}."""
    from kubernetes_tpu_torch.api.resources import Resource, pod_request

    pods_all = end_state["pods"]
    unbound = [p.metadata.name for p in pods_all if not p.spec.node_name]
    if len(pods_all) != want_pods or unbound:
        raise AssertionError(f"{name}: {len(pods_all)} pods, "
                             f"{len(unbound)} unbound")
    used: dict[str, list] = {}
    for p in pods_all:
        r = pod_request(p)
        u = used.setdefault(p.spec.node_name, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    nodes = {n.metadata.name: n for n in end_state["nodes"]}
    for n in nodes.values():
        u = used.get(n.metadata.name, [0, 0, 0])
        alloc = Resource.from_map(n.status.allocatable)
        if u[0] > alloc.milli_cpu or u[1] > alloc.memory \
                or u[2] > alloc.allowed_pod_number:
            raise AssertionError(f"{name}: node {n.metadata.name} "
                                 f"overcommitted: {u}")
    return nodes


ZONE = "topology.kubernetes.io/zone"


def check_spread(end_state, nodes) -> str:
    """Blue pods' per-zone counts differ by at most maxSkew 5."""
    counts: dict[str, int] = {}
    for p in end_state["pods"]:
        if p.metadata.labels.get("color") == "blue":
            z = nodes[p.spec.node_name].metadata.labels[ZONE]
            counts[z] = counts.get(z, 0) + 1
    if len(counts) != 3 or max(counts.values()) - min(counts.values()) > 5:
        raise AssertionError(f"TopologySpreading: zone counts {counts}")
    return f"blue pods per zone {dict(sorted(counts.items()))}"


def check_anti(end_state, nodes) -> str:
    """No two anti-affinity (green) pods share a node."""
    seen: dict[str, str] = {}
    for p in end_state["pods"]:
        if p.metadata.labels.get("color") != "green":
            continue
        other = seen.get(p.spec.node_name)
        if other is not None:
            raise AssertionError(f"SchedulingPodAntiAffinity: {other} and "
                                 f"{p.metadata.name} on {p.spec.node_name}")
        seen[p.spec.node_name] = p.metadata.name
    return f"{len(seen)} green pods on {len(seen)} distinct nodes"


def check_affinity(end_state, nodes) -> str:
    """Every affinity (blue) pod lies in a zone holding another blue pod."""
    per_zone: dict[str, int] = {}
    blue = [p for p in end_state["pods"]
            if p.metadata.labels.get("color") == "blue"]
    for p in blue:
        z = nodes[p.spec.node_name].metadata.labels[ZONE]
        per_zone[z] = per_zone.get(z, 0) + 1
    lonely = [p.metadata.name for p in blue
              if per_zone[nodes[p.spec.node_name].metadata.labels[ZONE]] < 2]
    if lonely:
        raise AssertionError(f"SchedulingPodAffinity: {lonely[:3]} alone "
                             "in their zone")
    return f"blue pods per zone {per_zone}"


SOURCES = {
    "soft_scatter": ("kubernetes_tpu_torch/csrc/soft_scores.cu",
                     "kubernetes_tpu/models/pipeline.py:439"),
    "soft_gather": ("kubernetes_tpu_torch/csrc/soft_scores.cu",
                    "kubernetes_tpu/models/pipeline.py:439"),
    "phase1_static": ("kubernetes_tpu_torch/csrc/phase1_static.cu",
                      "kubernetes_tpu/models/pipeline.py:968"),
    "auction_score_argmax": (
        "kubernetes_tpu_torch/csrc/auction_score_argmax.cu",
        "kubernetes_tpu/models/pipeline.py:649"),
    "auction_accept_commit": (
        "kubernetes_tpu_torch/csrc/auction_accept_commit.cu",
        "kubernetes_tpu/models/pipeline.py:674"),
    "topo_table": ("kubernetes_tpu_torch/csrc/topo_statics.cu",
                   "kubernetes_tpu/models/pipeline.py:1078"),
    "topo_nodes": ("kubernetes_tpu_torch/csrc/topo_statics.cu",
                   "kubernetes_tpu/models/pipeline.py:1078"),
    "topo_pairs": ("kubernetes_tpu_torch/csrc/topo_statics.cu",
                   "kubernetes_tpu/models/pipeline.py:1153"),
    "serial_scan": ("kubernetes_tpu_torch/csrc/serial_scan.cu",
                    "kubernetes_tpu/models/pipeline.py:1358"),
    "preempt_sweep": ("kubernetes_tpu_torch/csrc/preempt_sweep.cu",
                      "kubernetes_tpu/ops/preempt.py:44"),
    "preempt_feasible": ("kubernetes_tpu_torch/csrc/preempt_feasible.cu",
                         "kubernetes_tpu/ops/preempt.py:115"),
    "feasible_min": ("kubernetes_tpu_torch/csrc/preempt_feasible.cu",
                     "kubernetes_tpu/ops/preempt.py:166"),
    "gang_pack": ("kubernetes_tpu_torch/csrc/gang_pack.cu",
                  "kubernetes_tpu/ops/gang.py:77"),
    "dra_feasible": ("kubernetes_tpu_torch/csrc/dra_feasible.cu",
                     "kubernetes_tpu/ops/dra.py:104"),
    "serial_scan_pct": ("kubernetes_tpu_torch/csrc/serial_scan.cu",
                        "kubernetes_tpu/models/pipeline.py:1418"),
    "gang_capacity": ("kubernetes_tpu_torch/csrc/gang_capacity.cu",
                      "kubernetes_tpu/ops/gang.py:208"),
    "learned_mlp": ("kubernetes_tpu_torch/csrc/learned_mlp.cuh",
                    "kubernetes_tpu/ops/learned.py:102"),
    "auction_score_argmax_learned": (
        "kubernetes_tpu_torch/csrc/auction_score_argmax.cu",
        "kubernetes_tpu/models/pipeline.py:634"),
    "serial_scan_learned": ("kubernetes_tpu_torch/csrc/serial_scan.cu",
                            "kubernetes_tpu/models/pipeline.py:1466"),
}


def kernel_entry(name, kernel, path, n_launch, err, times, work) -> dict:
    """One entry of the kernels line: ``times`` is (kernel ms, twin ms),
    ``work`` (bytes, operations) of the function at the timed inputs."""
    nbytes, ops = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": SOURCES[kernel][0],
            "replaces": SOURCES[kernel][1], "path": path,
            "launches": n_launch, "max_abs_err": err, "ms": times[0],
            "plain_ms": times[1], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


# The previous design of K3 and K2a: kernels/scan.py, kernels/auction.py
# and their csrc/ sources of the parent commit, copied by `git show` into
# this ignored directory for one like-for-like call and never committed
# (README's port section names the commands). Absent in a plain checkout:
# the comparison is then skipped and says so.
PREVIOUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "previous")
PREVIOUS_FILES = ("csrc/serial_scan.cu", "csrc/auction_score_argmax.cu",
                  "csrc/learned_mlp.cuh", "kernels/scan.py",
                  "kernels/auction.py")
_PREVIOUS: dict = {}


def previous_design():
    """(scan module, auction module) of the previous design, each
    launching its own library (built from PREVIOUS_DIR) and counting into
    a dict of its own, or None where PREVIOUS_DIR is absent."""
    if "mods" in _PREVIOUS:
        return _PREVIOUS["mods"]
    if not all(os.path.exists(os.path.join(PREVIOUS_DIR, f))
               for f in PREVIOUS_FILES):
        _PREVIOUS["mods"] = None
        return None
    import collections
    import importlib.util
    import types

    from kubernetes_tpu_torch.kernels import build as KB

    src = os.path.join(PREVIOUS_DIR, "csrc")
    KB.build_all(("serial_scan", "auction_score_argmax"), src)
    shim = types.SimpleNamespace(**{k: getattr(KB, k) for k in dir(KB)
                                    if not k.startswith("__")})
    shim.library = lambda name: KB.library(name, src)
    shim.LAUNCHES = collections.defaultdict(int)
    mods = []
    for name in ("scan", "auction"):
        spec = importlib.util.spec_from_file_location(
            f"previous_{name}", os.path.join(PREVIOUS_DIR, "kernels",
                                             name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        mod.KB = shim
        mods.append(mod)
    _PREVIOUS["mods"] = tuple(mods)
    return _PREVIOUS["mods"]


def in_turns(torch, new, old, reps: int, reset=None) -> tuple:
    """CUDA-event medians of ``new`` and ``old`` run in turns (old, new,
    new, old; ``reps`` runs a turn, ``reset()`` before each run outside
    the timed span): (new ms, old ms), old ms None without ``old``."""
    def timed(fn):
        if reset is not None:
            reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    runs = {"new": [], "old": []}
    for fn in (new, old):
        if fn is not None:
            timed(fn)
    for tag in ("old", "new", "new", "old") if old else ("new", "new"):
        runs[tag] += [timed(new if tag == "new" else old)
                      for _ in range(reps)]
    return (statistics.median(runs["new"]),
            statistics.median(runs["old"]) if old else None)


# K3's and K2a's readings by path: (ms, the previous design's ms in the
# same call or None, step floor ms or None), for the summary before the
# kernels line
K3_TIMES: dict = {}


def previous_text(ms_new, ms_old) -> str:
    if ms_old is None:
        return ("the previous design not present (build/previous absent): "
                "no same-call comparison")
    return (f"the previous design {ms_old:.5f} ms in turns in this call "
            f"({ms_old / ms_new:.2f}x)")


def ptxas_text(name: str, entry: str) -> str:
    """ptxas's registers, spills, stack and static shared memory of each
    __global__ entry of one built source whose name holds ``entry``."""
    from kubernetes_tpu_torch.kernels import build as KB

    out = []
    for fn, v in sorted(KB.build_log(name).items()):
        if entry not in fn:
            continue
        tag = {"ILb1E": " (all-shared)", "ILb0E": " (generic)"}
        label = entry + next((t for k, t in tag.items() if k in fn), "")
        out.append(f"{label}: {v.get('registers')} registers, spill "
                   f"stores/loads {v.get('spill_stores', 0)}/"
                   f"{v.get('spill_loads', 0)} B, stack {v.get('stack', 0)} "
                   f"B, static shared {v.get('smem', 0)} B")
    return "; ".join(out)


def k3_shape(sin) -> str:
    """K3's launch shape for these inputs and ptxas's report."""
    from kubernetes_tpu_torch.kernels import scan as KS

    plan = KS.scan_plan(sin)
    return (f"cluster of {plan.cluster} blocks x {plan.threads} threads, "
            f"{plan.per} nodes a block, {plan.smem_bytes} B of shared "
            f"memory a block, carries {plan.layout}, "
            f"{'all-shared' if plan.all_shared else 'generic'} views; "
            + ptxas_text("serial_scan", "serial_scan_kernel"))


def k2a_shape(rin) -> str:
    """K2a's launch shape for these inputs and ptxas's report."""
    from kubernetes_tpu_torch.kernels import auction as KA

    t = KA.bid_tiling(rin)
    return (f"{t['blocks']} blocks of {t['pods_per_block']} pods "
            f"({t['threads']} threads) over {t['tile_nodes']}-node tiles, "
            f"{t['smem_bytes']} B of shared memory a block; "
            + ptxas_text("auction_score_argmax", "auction_bid"))


def profile_text(prof: dict, per: str) -> str:
    total = sum(prof.values())
    return (f"SM cycles {per} by phase (profile build): "
            + ", ".join(f"{k} {v:.0f}" for k, v in prof.items())
            + f"; total {total:.0f}")


def profiled(torch, phase, workload, config=None, tag="") -> None:
    """A profiled repeat of a drain: the device's busy and idle share of
    its wall, and the kernels that took most of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch.perf.harness import run_workload

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_workload(workload, config=config, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.time() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = sorted(prof.key_averages(), key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in events)
    name = workload.name.split("/")[0] + tag
    if busy_us > 0:
        top = [(e.key[:40], round(device_us(e) / 1e3, 3), e.count)
               for e in events[:4]]
        log(f"[{phase}] profiled {name} drain: device busy "
            f"{busy_us / 1e6:.4f} s of {wall_s:.2f} s wall, idle share "
            f"{1.0 - busy_us / 1e6 / wall_s:.4f}; top (kernel, ms, "
            f"count) {top}")
    else:
        log(f"[{phase}] profiled {name} drain: the profiler recorded "
            "no device time; idle share not measured")


def clone_tree(x):
    """A copy of every tensor in a launch's arguments (dataclasses,
    NamedTuples and tuples of tensors), so a captured launch keeps its
    values while later batches reuse their buffers."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: clone_tree(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple):
        items = [clone_tree(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k5_work(ct, pods, prow_i32, caps, d) -> dict:
    """Bytes (each input read once, each output written once) and
    operations of K5's three stages at one launch's inputs, counting what
    this data needs. topo_table: every slot's valid word; a valid slot's
    uid; a slot some group considers (valid, not its own) its header, its
    4 x A term keys, the fields of the terms it uses, the label words the
    groups' selectors name and its node's words of the keys in use; one
    namespace and selector test per (group, considered slot, used term);
    the domain maps written once. topo_nodes / topo_pairs: every input and
    output once."""
    none = -1
    g, n, pt = prow_i32.shape[0], caps.nodes, caps.pods
    tk, a, c = caps.topo_cols, caps.aff_terms, caps.spread_constraints
    term_words = caps.aff_ns + 1 + caps.aff_sel * (2 + caps.aff_sel_vals)
    test_ops = caps.aff_ns + caps.aff_sel * caps.aff_sel_vals
    kinds = ("anti", "aff", "paff", "panti")
    own = (ct.pod_uid[None, :] == pods.uid_id[:, None]).all(0)
    cons = ct.pod_valid & ~own
    n_cons = int(cons.sum())
    words = pt + int(ct.pod_valid.sum()) + n_cons * (3 + 4 * a)
    keys, cols = set(), set()
    slot_terms = pod_terms = 0
    for k in kinds:
        t_tk = getattr(ct, f"pod_{k}_tk")[cons]
        used = t_tk != none
        slot_terms += int(used.sum())
        words += int(used.sum()) * (term_words + (k in ("paff", "panti")))
        keys |= set(t_tk[used].tolist())
        p_tk = getattr(pods, f"{k}_tk")
        p_used = p_tk != none
        pod_terms += int(p_used.sum())
        keys |= set(p_tk[p_used].tolist())
        ops_ = getattr(pods, f"{k}_sel_ops")[p_used]
        cols |= set(getattr(pods, f"{k}_sel_cols")[p_used][
            ops_ != none].tolist())
    c_used = pods.tsc_tk != none
    pod_terms += int(c_used.sum())
    keys |= set(pods.tsc_tk[c_used].tolist())
    cols |= set(pods.tsc_sel_cols[c_used][
        pods.tsc_sel_ops[c_used] != none].tolist())
    words += n_cons * len(cols)
    slot_nodes = int(ct.pod_node[cons].clamp(min=0).unique().numel())
    words += slot_nodes * len(keys)
    table_in = words * 4 + g * prow_i32.shape[1] * 4
    if bool(c_used.any()):
        table_in += slot_nodes * (2 * g + 1)   # eligibility masks
    maps = g * (tk * d * 5 + a * d + 1 + c * d * 4)
    return {
        "topo_table": (table_in + maps,
                       (n_cons * pod_terms + g * slot_terms) * test_ops),
        "topo_nodes": (
            n * (tk * 4 + 1) + 3 * g * n + maps
            + g * n * (6 + 2 * a + 6 * c) + 2 * g * c * d,
            g * n * (tk + a + c)),
        "topo_pairs": (
            2 * g * c * d + g * prow_i32.shape[1] * 4
            + g * g * (4 * a + c) + g * c * 12 + g,
            g * g * (4 * a + c) * caps.aff_sel + 2 * g * c * d),
    }


def scan_work(sin) -> tuple:
    """K3's bytes — every input read once; free/nzr and the per-pod
    verdicts written once (the carry maps are the kernel's own scratch) —
    and its operations: ~40 for each (pod, statically feasible node), the
    filters, the score terms and the reductions."""
    ts = [sin.free, sin.nzr, sin.nom, sin.alloc2, sin.req, sin.nzreq,
          sin.nominated_row, sin.uid, sin.g1, sin.static_ok, sin.taint_raw,
          sin.aff_raw, sin.img]
    if sin.ports:
        ts += [sin.hp_port, sin.hp_proto, sin.hp_ip]
    if sin.topo:
        nd = sin.st.nodes
        ts += [sin.gid, sin.topo_dom, sin.st.maps.cnt, sin.st.maps.any_match,
               *(getattr(nd, f) for f in nd._fields if f != "exists_score"),
               *sin.st.pairs, *vars(sin.terms).values()]
    nbytes = _nbytes(ts) + _nbytes([sin.free, sin.nzr]) + sin.b * 28
    ops = 40 * int(sin.static_ok[sin.g1.long()].sum())
    return nbytes, ops


# ------------------------------------------------- the soft-score auction

HOSTNAME = "kubernetes.io/hostname"
SOFT_KERNELS = ("soft_scatter", "soft_gather", "auction_score_argmax",
                "auction_accept_commit")


@contextlib.contextmanager
def twins():
    """Route launches through the plain-torch twins (comparison only; the
    wrappers never do this on the card)."""
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import dra as KD
    from kubernetes_tpu_torch.kernels import phase1 as K1
    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.kernels import soft as KSoft
    from kubernetes_tpu_torch.kernels import topology as KT
    from kubernetes_tpu_torch.models import pipeline as P

    slots = ((P, "phase1_static", K1.phase1_static_ref),
             (KD, "fuse_phase1", KD.fuse_phase1_ref),
             (KA, "auction_score_argmax", KA.auction_score_argmax_ref),
             (KA, "auction_accept_commit", KA.auction_accept_commit_ref),
             (KA, "auction_final", KA.auction_final_ref),
             (KT, "topo_statics", KT.topo_statics_ref),
             (KS, "serial_scan", KS.serial_scan_ref),
             (KSoft, "soft_scores", KSoft.soft_scores_ref))
    saved = [getattr(m, name) for m, name, _ in slots]
    for m, name, twin in slots:
        setattr(m, name, twin)
    try:
        yield
    finally:
        for (m, name, _), fn in zip(slots, saved):
            setattr(m, name, fn)


@contextlib.contextmanager
def recording(log: dict):
    """Record, for the launches run inside, K5's statics, the soft statics
    view, every K4 round's outputs, every K2a bid round's input flag and
    outputs, and the auction state at its first bid round."""
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import soft as KSoft
    from kubernetes_tpu_torch.kernels import topology as KT

    for key in ("k5", "view", "k4", "k2a"):
        log.setdefault(key, [])
    real_k5, real_view = KT.topo_statics, KSoft.soft_topo
    real_k4, real_k2a = KSoft.soft_scores, KA.auction_score_argmax

    def k5(*args):
        st = real_k5(*args)
        log["k5"].append(st)
        return st

    def view(*args):
        soft = real_view(*args)
        log["view"].append(soft)
        return soft

    def k4(soft, placed, prog, k, out):
        active = int(prog[k % 2])
        real_k4(soft, placed, prog, k, out)
        log["k4"].append((active, out.maps.clone(), out.tmap.clone(),
                          out.ipa_live.clone(), out.sp_r.clone()))

    def k2a(rin, prog, k):
        active = int(prog[k % 2])
        if "rin0" not in log:
            log["rin0"] = clone_tree(rin)
        choice, win_now = real_k2a(rin, prog, k)
        log["k2a"].append((active, choice.clone(), win_now.clone()))
        return choice, win_now

    KT.topo_statics, KSoft.soft_topo = k5, view
    KSoft.soft_scores, KA.auction_score_argmax = k4, k2a
    try:
        yield log
    finally:
        KT.topo_statics, KSoft.soft_topo = real_k5, real_view
        KSoft.soft_scores, KA.auction_score_argmax = real_k4, real_k2a


def max_err(a, b) -> float:
    if not a.dtype.is_floating_point or not a.numel():
        return 0.0
    return float((a.double() - b.double()).abs().max())


def cmp_exact(name, a, b) -> None:
    if a.shape != b.shape:
        raise AssertionError(f"{name}: shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)}")
    if not a.equal(b):
        raise AssertionError(f"{name}: kernel and twin differ at "
                             f"{int((a != b).sum())} entries")


def cmp_fields(errs, tag, got, want, kernel) -> None:
    """Every field of two NamedTuples of tensors exact; the float fields'
    largest difference is kept as the kernel's error in ``errs``."""
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        errs[kernel] = max(errs.get(kernel, 0.0), max_err(a, b))
        cmp_exact(f"{tag} {f}", a, b)


def hold_soft_launch(torch, tag, args, kw, errs) -> dict:
    """One whole soft-auction launch through the kernels and through the
    twins on the card, from the same inputs: K5's statics, the soft view,
    every round's K4 outputs and K2a bids, and the BatchResult (rows,
    scores, counts, free, nzr, guard) must agree exactly. ``errs`` keeps
    each kernel's largest float difference (0 when exact). Returns the
    kernel run's log and result."""
    from kubernetes_tpu_torch.kernels import topology as KT
    from kubernetes_tpu_torch.models import pipeline as P

    got, want = {}, {}
    with recording(got):
        out = P.launch_batch(*args, **kw)
    with twins(), recording(want):
        ref = P.launch_batch(*args, **kw)
    torch.cuda.synchronize()
    if not got["view"] or len(got["k4"]) != len(want["k4"]):
        raise AssertionError(f"{tag}: not a soft-auction launch, or the "
                             f"round counts differ ({len(got['k4'])} vs "
                             f"{len(want['k4'])})")
    for g5, w5 in zip(got["k5"], want["k5"]):
        for stage, gp, wp in zip(KT.STAGES, g5, w5):
            cmp_fields(errs, f"{tag} K5 {stage}", gp, wp, stage)
    gv, wv = got["view"][0], want["view"][0]
    for f in wv._fields:
        if isinstance(getattr(wv, f), torch.Tensor):
            cmp_exact(f"{tag} soft view {f}", getattr(gv, f),
                      getattr(wv, f))
    names = (("soft_scatter", "maps"), ("soft_scatter", "tmap"),
             ("soft_gather", "ipa_live"), ("soft_gather", "sp_r"))
    for k, (g4, w4) in enumerate(zip(got["k4"], want["k4"])):
        if g4[0] != w4[0]:
            raise AssertionError(f"{tag}: K4 round {k} flags differ")
        if not g4[0]:
            continue        # a no-op round (the kernel's maps are zeroed)
        for (stage, name), a, b in zip(names, g4[1:], w4[1:]):
            errs[stage] = max(errs.get(stage, 0.0), max_err(a, b))
            cmp_exact(f"{tag} K4 round {k} {name}", a, b)
    for k, ((ga, gc, gw), (wa, wc, ww)) in enumerate(zip(got["k2a"],
                                                         want["k2a"])):
        if ga != wa:
            raise AssertionError(f"{tag}: round {k} flags differ")
        if not ga:
            continue        # a no-op round writes nothing
        cmp_exact(f"{tag} K2a round {k} choice", gc, wc)
        m = gc >= 0
        errs["auction_score_argmax"] = max(
            errs.get("auction_score_argmax", 0.0), max_err(gw[m], ww[m]))
        cmp_exact(f"{tag} K2a round {k} win", gw[m], ww[m])
    for f in ("node_row", "score", "feasible_count", "reject_counts",
              "unresolvable_count", "free", "nzr", "guard"):
        a, b = getattr(out, f), getattr(ref, f)
        if f == "score":
            errs["auction_score_argmax"] = max(
                errs.get("auction_score_argmax", 0.0), max_err(a, b))
        cmp_exact(f"{tag} {f}", a, b)
    return {"log": got, "out": out}


def soften(pod, keep_required: bool, hostname: bool) -> None:
    """Make a fuzz pod's topology work soft: no required terms (unless
    ``keep_required``, for table pods), every spread ScheduleAnyway; and
    without ``hostname``, every hostname-keyed term or spread re-keyed to
    the zone (a zone-width launch, D = 8)."""
    a = pod.spec.affinity
    groups = [g for g in (a.pod_affinity, a.pod_anti_affinity)
              if g is not None] if a is not None else []
    for g in groups:
        if not keep_required:
            g.required = []
        terms = list(g.required) + [w.pod_affinity_term for w in g.preferred]
        for t in terms:
            if not hostname and t.topology_key == HOSTNAME:
                t.topology_key = ZONE
    for c in pod.spec.topology_spread_constraints:
        c.when_unsatisfiable = "ScheduleAnyway"
        c.min_domains = None
        if not hostname and c.topology_key == HOSTNAME:
            c.topology_key = ZONE


def soft_mirror(torch, seed, n_nodes, node_cap, n_bound, n_specs,
                hostname: bool, n_pods: int):
    """A synced mirror on the card over the seeded topology cluster
    (perf.fuzz.topology_fuzz) with soft-only pending specs and a batch of
    ``n_pods`` pods drawn from them. With ``hostname``, the table keeps
    its required hostname-keyed terms (the InterPodAffinity mask) and the
    specs their hostname keys; without, the table has no required terms
    and every key is the zone or the rack."""
    from kubernetes_tpu_torch.api.objects import (
        LabelSelector,
        PodAffinityTerm,
        WeightedPodAffinityTerm,
    )
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf.fuzz import topology_fuzz

    nodes, bound, specs, namespaces = topology_fuzz(
        random.Random(seed), n_nodes, n_bound, n_specs, ports=False)
    for p in bound:
        soften(p, keep_required=hostname, hostname=hostname)
    for p in specs:
        soften(p, keep_required=False, hostname=hostname)
    if hostname:
        # at least one hostname-keyed preferred term in the batch
        specs[0].spec.affinity.pod_affinity.preferred[:] = [
            WeightedPodAffinityTerm(weight=40, pod_affinity_term=(
                PodAffinityTerm(topology_key=HOSTNAME,
                                label_selector=LabelSelector(
                                    match_labels={"app": "a1"}))))]
    caps = Capacities(nodes=node_cap, pods=16384)
    mirror = synced_mirror(torch, nodes, bound, caps, namespaces)
    return mirror, caps, batch_of(specs, n_pods)


def k4_work(soft, placed) -> dict:
    """Bytes (inputs read once, outputs written once) and operations of
    K4's two stages for one round with the placed set ``placed``.
    soft_scatter: the batch's gid/valid/placed words, the topology rows of
    the nodes holding placed pods, the term keys, matches and the
    eligibility rows of those nodes; the domain maps written once; one add
    per (placed pod, group, term). soft_gather: the maps, every node's
    topology row, the [G, N] and [G, N, C] statics, the term rows; two
    [G, N] outputs; ~4 operations per gathered term and constraint."""
    g, n = soft.ipa_ok_g.shape
    a, c = soft.paff_tk_g.shape[1], soft.tsc_tk_g.shape[1]
    tk, d = soft.topo_dom.shape[1], soft.d_cap
    b = soft.gid.shape[0]
    rows = placed[placed >= 0]
    n_placed = int(rows.numel())
    nodes = int(rows.unique().numel())
    terms = g * (2 * a + c)
    term_words = terms * 4 + g * (2 * a + c) * g + 2 * g * a * 4
    maps = g * (4 * a + c) * d * 4
    scatter_in = b * 9 + nodes * tk * 4 + term_words + g * nodes * c
    gather_in = (maps + n * tk * 4 + g * n * (4 + 1) + g * n * c * (4 + 1)
                 + term_words + g * c * 9)
    return {
        "soft_scatter": (scatter_in + maps, n_placed * terms),
        "soft_gather": (gather_in + 2 * g * n * 4,
                        g * n * (4 * (a + g * a) * 2 + 6 * c)),
    }


def auction_work(rin, n_bidders: int, accepted: int) -> dict:
    """K2a's and K2b's bytes and operations at one round's inputs (as
    phase 7 counts them), with K2a's soft-mode inputs: the ipa mask, the
    live ipa and spread scores and the ignore mask, [G, N] each."""
    n, r = rin.n, rin.req.shape[1]
    b, g = rin.b, rin.static_ok.shape[0]
    soft = g * n * 10 if rin.soft else 0
    return {
        "auction_score_argmax": (
            n * (2 * r + 4) * 4 + b * (r + 6) * 4 + g * n * 13 + b * 8 + soft,
            n_bidders * n * (3 * r + 30 + (12 if rin.soft else 0))),
        "auction_accept_commit": (
            b * (4 + 4 + 4 * r + 8 + 4) + n * (3 * r + 4) * 4 + b * 8,
            accepted * (r + 2)),
    }


def time_soft_launch(torch, held) -> tuple:
    """CUDA-event medians of K4's stages (end-state placed set: every pod
    the launch placed), K2a in soft mode and K2b (the first round), and
    the twins' times; the work of each at those inputs. Returns (times,
    work, detail)."""
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import soft as KSoft

    log, out = held["log"], held["out"]
    soft = log["view"][0]
    rin = log["rin0"]
    dev = rin.free.device
    prog = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    placed = out.node_row.clone()
    sout = KSoft.soft_out(soft)
    k4 = KSoft.prepare_launch(soft, placed, prog, 0, sout)
    maps, tmap = KSoft.soft_scatter_ref(soft, placed)
    twin_stage = {
        "soft_scatter": lambda: KSoft.soft_scatter_ref(soft, placed),
        "soft_gather": lambda: KSoft.soft_gather_ref(soft, maps, tmap)}
    times = {stage: (cuda_ms(torch, lambda s=stage: k4.run(s)),
                     cuda_ms(torch, twin_stage[stage], reps=5, warm=1))
             for stage in KSoft.STAGES}
    snap = (rin.free.clone(), rin.nzr.clone(), rin.placed.clone(),
            rin.win.clone())

    def restore():
        for t, s in zip((rin.free, rin.nzr, rin.placed, rin.win), snap):
            t.copy_(s)

    prev = previous_design()
    bid_ms, bid_prev = in_turns(
        torch, lambda: KA.auction_score_argmax(rin, prog, 0),
        (lambda: prev[1]._bid_kernel(rin, prog, 0)) if prev else None, 10)
    times["auction_score_argmax"] = (
        bid_ms,
        cuda_ms(torch, lambda: KA.auction_score_argmax_ref(rin, prog, 0),
                reps=5, warm=1))
    choice, win_now = KA.auction_score_argmax(rin, prog, 0)
    KA.auction_accept_commit(rin, choice, win_now, prog, 0)
    accepted = int((rin.placed >= 0).sum())
    restore()

    def k2b():
        KA.auction_accept_commit(rin, choice, win_now, prog, 0)

    times["auction_accept_commit"] = (
        cuda_ms(torch, k2b),
        cuda_ms(torch, lambda: KA.auction_accept_commit_ref(
            rin, choice, win_now, prog, 0), reps=5, warm=1))
    restore()
    bidders = int(((rin.placed < 0) & (rin.static_ok[rin.gid.long()]
                                       .any(dim=1))).sum())
    work = {**k4_work(soft, placed), **auction_work(rin, bidders, accepted)}
    detail = (f"G={soft.ipa_ok_g.shape[0]}, B={rin.b}, N={rin.n}, "
              f"D={soft.d_cap}, {int((placed >= 0).sum())} placed, "
              f"{accepted} accepted in round 0; K2a soft "
              f"{previous_text(bid_ms, bid_prev)}; {k2a_shape(rin)}")
    return times, work, detail, bid_prev


# ------------------------------------------------------------ preemption

def synced_state(torch, nodes, bound, caps, namespaces=()):
    """A mirror on the card synced from a cache of these namespaces, nodes
    and bound pods, and the snapshot it was synced from."""
    from kubernetes_tpu_torch.backend.cache import Cache
    from kubernetes_tpu_torch.backend.mirror import Mirror
    from kubernetes_tpu_torch.backend.snapshot import Snapshot

    cache = Cache()
    for ns in namespaces:
        cache.set_namespace(ns.metadata.name, ns.metadata.labels)
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    mirror = Mirror(caps=caps, device=torch.device("cuda"))
    mirror.sync(snap)
    return mirror, snap


def sweep_work(launch) -> tuple:
    """(bytes, operations) of one K6a sweep at this run's data, each input
    read once and the [P, N] output written once, counting only what the
    data needs: static_ok for every (pod, node); the pod rows; free, nom
    and alloc rows of the nodes some pod passes K1 on; and of each such
    node's cumsum the prefixes up to the last one a pod tries (kmin + 1,
    all K + 1 where none fits). Operations: three a resource column for
    each (pod, node) past K1, two a column for each prefix tried."""
    import torch

    t = launch.tensors
    sok = t["static_ok"]
    p, n = sok.shape
    r = t["free"].shape[1]
    c = t["cols"].shape[0]
    k1 = t["cumsum"].shape[1]
    # the kernel's early exits, recomputed: unresolvable, ok_rest
    req, alloc = t["req"], t["alloc"]
    freed = torch.zeros(r, dtype=torch.bool, device=req.device)
    freed[t["cols"].long()] = True
    own = (torch.arange(n, device=req.device)[None]
           == t["nominated_row"][:, None])                     # [P, N]
    base = (t["free"] - t["nom"])[None] + torch.where(
        own[..., None], req[:, None], torch.zeros((), device=req.device))
    unres = (req[:, None] > alloc[None]).any(-1)
    ok_rest = ((req[:, None] <= base) | freed).all(-1)
    swept = sok & ~unres & ok_rest
    kmin = t["kmin"]
    tried = torch.where(swept, torch.where(kmin >= 0, kmin + 1, k1), 0)
    rows = int(sok.any(0).sum())
    prefixes = int(tried.max(0).values.sum())
    nbytes = (p * n + p * n * 4 + p * (r + 1) * 4 + c * 4
              + rows * 3 * r * 4 + prefixes * c * 4)
    return nbytes, int(sok.sum()) * 3 * r + int(tried.sum()) * 2 * c


def fold_work(launch) -> tuple:
    """(bytes, operations) of one K6b fold at this run's data, each input
    read once and the [N] output written once, counting only what the data
    needs: static_ok of every node; free and nom rows of the nodes past
    K1 (when the fit runs); of the spread constraints and affinity terms,
    only the DoNotSchedule constraints and the terms in use, and their
    columns only for the nodes that reach that check. Operations: three a
    resource column, four a constraint and three a term per node that
    reaches it. The spread minimum is counted by min_work."""
    import torch

    t, a = launch.tensors, launch.args
    dev = t["static_ok"].device
    n, r = t["free"].shape
    ok = t["static_ok"]
    # static_ok in, out written, the pod's request and nominated row
    nbytes, ops = n + n + (r + 1) * 4, 0
    if a.fit_on:
        past = int(ok.sum())
        nbytes += past * 2 * r * 4
        ops += past * 3 * r
        own = torch.arange(n, device=dev) == t["nominated_row"]
        eff = (t["free"] - t["nom"]) + torch.where(
            own[:, None], t["req"][None], torch.zeros((), device=dev))
        ok = ok & (t["req"][None] <= eff).all(-1)
    if a.topo and a.spread_on:
        used = (t["tsc_tk"] != -1) & t["tsc_hard"]
        u, reach = int(used.sum()), int(ok.sum())
        # tsc_tk of every slot; hard flag, maxSkew, self match and min of
        # each constraint in use; match_static and dom_ok per node reached
        nbytes += t["tsc_tk"].numel() * 4 + u * 13 + reach * u * 5
        ops += reach * u * 4
        skew = (t["match_static"] + t["self_match"][None]) \
            - t["min_cnt"][None]
        ok_c = t["dom_ok"] & (skew <= t["max_skew"][None].float())
        ok = ok & (ok_c | ~used[None]).all(-1)
    if a.topo and a.ipa_on:
        u = int((t["aff_tk"] != -1).sum())
        reach = int(ok.sum())
        # aff_tk of every slot, aff_self and any_match; anti_ok and the
        # used terms' term_static and has_lbl per node reached
        nbytes += t["aff_tk"].numel() * 4 + 2 + reach * (1 + u * 2)
        ops += reach * (3 * u + 1)
    return nbytes, ops


def min_work(launch) -> tuple:
    """(bytes, operations) of K6b's spread minimum: each slot's key and
    hard flag; for each DoNotSchedule constraint in use, exists_hard over
    its D domains, the counts of the domains present, minDomains and the
    minimum written."""
    t = launch.tensors
    used = ((t["tsc_tk"] != -1) & t["tsc_hard"]).nonzero().flatten()
    d = t["cnt"].shape[1]
    present = int(t["exists_hard"][used].sum())
    c = t["tsc_tk"].shape[0]
    return (c * 5 + len(used) * (d + 8) + present * 4,
            len(used) * d + present)


def hold_sweep(torch, errs) -> str:
    """12. K6a (K1 with every feature, then the sweep) against its literal
    twin on the card at full width: 5,000 fuzz nodes (bucket 8,192) with
    PreemptionAsync's fillers and the fuzz's extra victims, the victim
    state built by the Evaluator (C = 4 with a padding alias and k_cap 8;
    C = 8 and k_cap 16 with crowded nodes), nominated reservations, P = 1
    and 64, with and without a live-free override; then the
    inactive-column case of tests/test_preemption.py:323. kmin exact."""
    from kubernetes_tpu_torch.api import objects as o
    from kubernetes_tpu_torch.framework.preemption import Evaluator
    from kubernetes_tpu_torch.kernels import preempt as KP
    from kubernetes_tpu_torch.ops.features import Capacities, unpack_cluster
    from kubernetes_tpu_torch.perf.fuzz import preemption_fuzz

    notes = []
    # the last case repeats the second 70 extended-resource columns wide
    # (R = 74: the sweep keeps no per-thread copy of a node's row)
    for seed, extra, ext in ((31, False, 4), (32, True, 4), (32, True, 70)):
        caps = Capacities(nodes=8192, pods=32768, ext_resources=ext)
        nodes, bound, pre = preemption_fuzz(random.Random(seed), 5000, 64,
                                            extra)
        if extra:
            # crowded nodes: 8 more small victims each (10 to 14 in all),
            # so k_cap grows to 16
            for k in range(4):
                for j in range(8):
                    bound.append(o.Pod(
                        metadata=o.ObjectMeta(name=f"crowd-{k}-{j}"),
                        spec=o.PodSpec(containers=[o.Container(
                            name="c", resources=o.ResourceRequirements(
                                requests={"cpu": "50m",
                                          "memory": "64Mi"}))],
                            node_name=f"node-{k}",
                            tolerations=[o.Toleration(operator="Exists")])))
        mirror, snap = synced_state(torch, nodes, bound, caps)
        # nominated reservations on some rows; preemptor 1 is nominated
        # itself (its own reservation is handed back on its row)
        pre[1].status.nominated_node_name = "node-5"
        nominated = {"node-5": [pre[1]]}
        for i in range(8):
            q = pre[2 + i].clone()
            q.metadata.uid = q.metadata.name = f"nominee-{i}"
            nominated[f"node-{100 * i + 7}"] = [q]
        mirror.set_nominated(nominated)
        ev = Evaluator(None, lambda: mirror, lambda: caps,
                       lambda pod=None: None, None)
        victims_by_row, k_cap, cumsum, cols, _, _ = ev._rebuild_victims(
            10, snap, mirror, caps)
        want_c, want_k = (8, 16) if extra else (4, 8)
        if cumsum.shape[2] != want_c or k_cap != want_k:
            raise AssertionError(f"[12] victim state C={cumsum.shape[2]}, "
                                 f"k_cap={k_cap}")
        cblobs = mirror.to_blobs()
        wk = mirror.well_known()
        free = unpack_cluster(cblobs, caps).free
        noise = torch.tensor(np.random.default_rng(seed).choice(
            [-1000.0, 0.0, 0.0, 500.0], size=tuple(free.shape)),
            dtype=torch.float32, device=free.device)
        live = (free + noise).contiguous()
        hist = {}
        for p in (1, 64):
            pblobs = mirror.pack_batch_blobs(pre[:p], p)
            for tag, override in (("snapshot free", None), ("live", live)):
                got = KP.preempt_sweep(cblobs, pblobs, wk, cumsum, cols,
                                       caps, free=override)
                want = KP.preempt_sweep_ref(cblobs, pblobs, wk, cumsum,
                                            cols, caps, None, override)
                torch.cuda.synchronize()
                cmp_exact(f"[12] K6a R={caps.res_cols} C={want_c} P={p} "
                          f"{tag}", got, want)
                for v in want.flatten().tolist():
                    hist[v] = hist.get(v, 0) + 1
        n_vic = sum(len(vs) for vs in victims_by_row.values())
        notes.append(f"R={caps.res_cols} C={want_c} k_cap={want_k} "
                     f"({n_vic} victims on "
                     f"{len(victims_by_row)} rows): kmin histogram "
                     f"{dict(sorted(hist.items()))}")
    # the inactive-column case: victims free memory only, the preemptor
    # needs CPU no victim frees — no prefix may fit
    node = o.Node(metadata=o.ObjectMeta(name="node-0"),
                  status=o.NodeStatus(allocatable={
                      "cpu": "4", "memory": "32Gi", "pods": "110"}))

    def mk(name, prio, req, node_name=""):
        return o.Pod(metadata=o.ObjectMeta(name=name), spec=o.PodSpec(
            containers=[o.Container(name="c", resources=o.ResourceRequirements(
                requests=req))], priority=prio, node_name=node_name))

    bound = [mk("cpu-hog", 100, {"cpu": "3500m", "memory": "256Mi"},
                "node-0")] + [mk(f"memhog-{i}", 50, {"memory": "8Gi"},
                                 "node-0") for i in range(3)]
    small = Capacities(nodes=16, pods=64)
    mirror, snap = synced_state(torch, [node], bound, small)
    ev = Evaluator(None, lambda: mirror, lambda: small,
                   lambda pod=None: None, None)
    _, _, cumsum, cols, _, _ = ev._rebuild_victims(60, snap, mirror, small)
    if 0 in cols.tolist():
        raise AssertionError(f"[12] inactive case: cpu among {cols}")
    pblobs = mirror.pack_batch_blobs(
        [mk("cpu-hungry", 60, {"cpu": "2", "memory": "8Gi"})], 1)
    args = (mirror.to_blobs(), pblobs, mirror.well_known(), cumsum, cols,
            small)
    got, want = KP.preempt_sweep(*args), KP.preempt_sweep_ref(*args)
    torch.cuda.synchronize()
    cmp_exact("[12] K6a inactive column", got, want)
    if not (got == -1).all():
        raise AssertionError("[12] inactive column: a prefix fits")
    errs["preempt_sweep"] = 0.0
    return ("K6a preempt_sweep == twin (K1 + sweep, every kmin exact) at "
            "N=8192 over 5000 fuzz nodes, P=1 and 64, with and without "
            "the live-free override: " + "; ".join(notes)
            + f"; inactive-column case (cols {cols.tolist()}): NONE "
            "everywhere")


def hold_feasible(torch, errs) -> str:
    """12b. K6b (K1 -> K5 over the masked table -> the fold) against its
    literal twin at full width: the topology fuzz cluster (5,000 nodes,
    a 12,000-pod table in 2 namespaces), preemptors with hard zone spread
    (with and without minDomains), required zone affinity, required
    hostname anti-affinity and two fuzz specs; three table masks (every
    lower-priority pod, one node's victims, none) with the free raised on
    the masked rows; topology on (D = 8 and 8,192) and off. [N] exact."""
    from kubernetes_tpu_torch.api import objects as o
    from kubernetes_tpu_torch.kernels import preempt as KP
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf.fuzz import topology_fuzz

    nodes, bound, specs, namespaces = topology_fuzz(random.Random(41), 5000,
                                                    12000, 2)
    caps = Capacities(nodes=8192, pods=16384)
    mirror, _ = synced_state(torch, nodes, bound, caps, namespaces)
    wk = mirror.well_known()
    cblobs = mirror.to_blobs()

    def pod(name, labels, affinity=None, tsc=()):
        return o.Pod(metadata=o.ObjectMeta(name=name, namespace="ns-0",
                                           labels=labels),
                     spec=o.PodSpec(containers=[o.Container(
                         name="c", resources=o.ResourceRequirements(
                             requests={"cpu": "100m",
                                       "memory": "500Mi"}))],
                         priority=10, affinity=affinity,
                         topology_spread_constraints=list(tsc)))

    def spread(min_domains):
        return o.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE,
            when_unsatisfiable="DoNotSchedule",
            label_selector=o.LabelSelector(match_labels={"app": "a1"}),
            min_domains=min_domains)

    def term(key, app):
        return o.PodAffinityTerm(
            topology_key=key,
            label_selector=o.LabelSelector(match_labels={"app": app}))

    preemptors = [
        pod("spread", {"app": "a1"}, tsc=[spread(None)]),
        pod("spread-mindomains", {"app": "a1"}, tsc=[spread(5)]),
        pod("zone-affinity", {"app": "a0"}, o.Affinity(
            pod_affinity=o.PodAffinity(required=[term(ZONE, "a0")]))),
        pod("host-anti", {"app": "a2"}, o.Affinity(
            pod_anti_affinity=o.PodAntiAffinity(
                required=[term(HOSTNAME, "a2")]))),
    ]
    for s in specs:
        s.spec.priority = 10
        preemptors.append(s)
    node3 = [p.metadata.uid for p in bound if p.spec.node_name == "node-3"]
    base = mirror.free_matrix()
    raised = base.copy()
    raised[[mirror.row_of(p.spec.node_name) for p in bound]] += 100.0
    masks = (("every lower-priority pod",
              mirror.table_valid_mask([p.metadata.uid for p in bound]),
              raised),
             ("node-3's victims", mirror.table_valid_mask(node3), raised),
             ("none", mirror.table_valid_mask(()), base))
    feasible = []
    for pre in preemptors:
        pblobs = mirror.pack_batch_blobs([pre], 1)
        for mtag, tval, free in masks:
            tv = torch.tensor(tval, device="cuda")
            fr = torch.tensor(free, device="cuda")
            for enable, d in ((True, 8), (True, 8192), (False, 0)):
                args = (cblobs, pblobs, wk, caps, tv, fr, enable, d)
                got = KP.preempt_feasible(*args)
                want = KP.preempt_feasible_ref(*args)
                torch.cuda.synchronize()
                cmp_exact(f"[12b] K6b {pre.metadata.name} / {mtag} / "
                          f"topology {enable} D={d}", got, want)
                feasible.append(int(want[:5000].sum()))
    errs["preempt_feasible"] = 0.0
    return (f"K6b preempt_feasible (K1 -> K5 on the masked table -> fold) "
            f"== twin on {len(feasible)} dry runs ({len(preemptors)} "
            "preemptors x 3 masks x topology on D=8 / D=8192 / off) over "
            f"5000 nodes (bucket 8192), PT=16384: feasible-node counts "
            f"range [{min(feasible)}, {max(feasible)}], "
            f"{sum(1 for f in feasible if f < 5000)} runs with some node "
            "rejected")


def path_b(torch, n_nodes, node_cap, n_pre, device, now=time.time,
           capture=None, timeout_s=600.0) -> dict:
    """The full PostFilter path through a Hub and a Scheduler: ``n_nodes``
    nodes of node-default.yaml, one priority-0 100m pod labelled app=red
    created already bound on each, then ``n_pre`` priority-10 preemptors
    of 100m / 500Mi with a required hostname anti-affinity term against
    app=red, driven until every preemptor is bound. Every eighth
    preemptor is labelled app=blue and also carries a DoNotSchedule
    hostname spread constraint over app=blue (maxSkew 1), so its dry runs
    run the spread check. ``capture`` (a dict) keeps the first three K6a
    calls' inputs, the first three K6b calls' and the first of a spread
    preemptor's, and the host wall of every whole dry run. Returns the
    end state and the stats."""
    from kubernetes_tpu_torch.api import objects as o
    from kubernetes_tpu_torch.config.types import default_config
    from kubernetes_tpu_torch.framework import preemption as FP
    from kubernetes_tpu_torch.hub import Hub
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf import workloads as W
    from kubernetes_tpu_torch.scheduler import Scheduler

    hub = Hub()
    sched = Scheduler(hub, default_config(), caps=Capacities(
        nodes=node_cap, pods=node_cap), now=now, device=device)
    anti = o.Affinity(pod_anti_affinity=o.PodAntiAffinity(required=[
        o.PodAffinityTerm(topology_key=HOSTNAME,
                          label_selector=o.LabelSelector(
                              match_labels={"app": "red"}))]))
    spread = o.TopologySpreadConstraint(
        max_skew=1, topology_key=HOSTNAME,
        when_unsatisfiable="DoNotSchedule",
        label_selector=o.LabelSelector(match_labels={"app": "blue"}))
    real = (FP.preempt_sweep, FP.preempt_feasible,
            FP.Evaluator._dryrun_feasible)
    if capture is not None:
        capture.update(sweep=[], feasible=[], spread=[], dryrun_s=[],
                       pod=None)

        def sweep(*args, **kw):
            if len(capture["sweep"]) < 3:
                capture["sweep"].append((clone_tree(args), dict(kw)))
            return real[0](*args, **kw)

        def feasible(*args, **kw):
            key = ("spread" if capture["pod"].spec.topology_spread_constraints
                   else "feasible")
            if len(capture[key]) < (1 if key == "spread" else 3):
                capture[key].append((clone_tree(args), dict(kw)))
            return real[1](*args, **kw)

        def dryrun(self, pod, *args):
            capture["pod"] = pod
            t0 = time.perf_counter()
            out = real[2](self, pod, *args)
            capture["dryrun_s"].append(time.perf_counter() - t0)
            return out

        FP.preempt_sweep, FP.preempt_feasible = sweep, feasible
        FP.Evaluator._dryrun_feasible = dryrun
    try:
        for i in range(n_nodes):
            hub.create_node(W._node(i))
        for i in range(n_nodes):
            p = W._pod(f"red-{i}", labels={"app": "red"})
            p.spec.node_name = f"node-{i}"
            hub.create_pod(p)
        pre = [W._pod(f"pre-{i}", cpu="100m", mem="500Mi", priority=10,
                      affinity=anti,
                      labels={"app": "blue"} if i % 8 == 0 else None,
                      tsc=[spread] if i % 8 == 0 else None)
               for i in range(n_pre)]
        KB.reset_launches()
        t0 = time.time()
        for p in pre:
            hub.create_pod(p)
        deadline = time.time() + timeout_s
        while not all(hub.get_pod(p.metadata.uid).spec.node_name
                      for p in pre):
            if time.time() > deadline:
                raise AssertionError("[13b] preemptors still pending")
            sched.run_until_idle()
            sched.queue.flush_backoff_completed()
        wall = time.time() - t0
        launches = dict(KB.LAUNCHES)
        pods = hub.list_pods()
        stats = dict(sched.stats)
    finally:
        FP.preempt_sweep, FP.preempt_feasible = real[0], real[1]
        FP.Evaluator._dryrun_feasible = real[2]
        sched.close()
    names = {p.metadata.name for p in pods}
    return {"bindings": {p.metadata.name: p.spec.node_name for p in pods},
            "gone": sorted(f"red-{i}" for i in range(n_nodes)
                           if f"red-{i}" not in names),
            "stats": stats, "launches": launches, "wall": wall,
            "n_pre": n_pre}


def check_path_b(res) -> str:
    """Every preemptor bound; the red pods gone are exactly one on each
    node holding a preemptor and none elsewhere; no node holds both a
    preemptor and a red pod; no node holds two spread (app=blue)
    preemptors; no priority-10 pod was evicted."""
    b = res["bindings"]
    pre_nodes = [b.get(f"pre-{i}") for i in range(res["n_pre"])]
    if not all(pre_nodes):
        raise AssertionError(f"[13b] {pre_nodes.count(None)} preemptors "
                             "gone or unbound")
    blue = [pre_nodes[i] for i in range(0, res["n_pre"], 8)]
    if len(set(blue)) != len(blue):
        raise AssertionError(f"[13b] spread preemptors share a node: {blue}")
    red_nodes = {b[k] for k in b if k.startswith("red-")}
    gone_nodes = {f"node-{g.split('-')[1]}" for g in res["gone"]}
    both = set(pre_nodes) & red_nodes
    if both or gone_nodes != set(pre_nodes):
        raise AssertionError(f"[13b] {len(both)} nodes hold a preemptor and "
                             f"a red pod; red pods gone on "
                             f"{len(gone_nodes)} nodes, preemptors on "
                             f"{len(set(pre_nodes))}")
    return (f"all {res['n_pre']} preemptors bound on "
            f"{len(set(pre_nodes))} distinct nodes; {len(res['gone'])} red "
            "pods gone, exactly one on each of those nodes and none "
            f"elsewhere; no node holds both; the {len(blue)} spread "
            "preemptors on distinct nodes")


# ------------------------------------------------------------------ gangs

FIT_OFF = (True,) * 5 + (False,) + (True, True)


def gang_mirror(torch, seed, n_nodes, node_cap, n_zones):
    """A synced mirror on the card over the seeded gang cluster
    (perf.fuzz.gang_fuzz), its nominated reservations set, and the
    cluster's 16 gang representatives (the last one a padding row)."""
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf.fuzz import gang_fuzz

    nodes, bound, nominated, reps = gang_fuzz(
        random.Random(seed), n_nodes, n_zones, n_nodes // 2, 15,
        n_nominated=40)
    caps = Capacities(nodes=node_cap, pods=max(2048, n_nodes))
    mirror = synced_mirror(torch, nodes, bound, caps)
    by_node: dict = {}
    for p in nominated:
        by_node.setdefault(p.status.nominated_node_name, []).append(p)
    mirror.set_nominated(by_node)
    return mirror, caps, nominated, reps


def gang_launch(mirror, caps, reps, needs, nominated, fit_on=True,
                state=None):
    """One gang-pack launch's arguments, built as
    Scheduler._dispatch_gang_chunk builds them (G = 16): the
    representatives' subset rows, ``needs`` padded with 0, the gangs' own
    nominated members (the ``nominated`` pods spread over the first 15
    gangs)."""
    from kubernetes_tpu_torch.models.pipeline import extract_state
    from kubernetes_tpu_torch.ops.features import PodBlobs

    g = 16
    feats = mirror.launch_features(reps)
    pfields = mirror.pod_fields(feats, False)
    f32, i32 = mirror._pack_batch_np(reps, g, pfields)
    tk, d_cap = mirror.gang_pack_domain()
    need = np.zeros((g,), np.int32)
    need[:len(needs)] = needs
    own = np.zeros((g, caps.nodes), np.int32)
    for k, p in enumerate(nominated):
        own[k % 15, mirror.row_of(p.status.nominated_node_name)] += 1
    cblobs = mirror.to_blobs()
    if state is None:
        state = extract_state(cblobs, caps)
    args = (cblobs, mirror._to_dev(PodBlobs(f32=f32, i32=i32)),
            mirror.well_known(), caps, need, tk)
    kw = dict(d_cap=d_cap, enabled_filters=(True,) * 8 if fit_on
              else FIT_OFF, active=feats, pfields=pfields,
              ptmpl=mirror.pod_template_blobs(), state=state, own_nom=own)
    return args, kw


def cmp_pack(tag, got, want) -> None:
    for f in ("ok", "alloc", "cap", "spans", "free", "nzr", "guard"):
        cmp_exact(f"{tag} {f}", getattr(got, f), getattr(want, f))


def hold_gang_pack(torch) -> tuple[str, list]:
    """Phase 15: K1 + K7a against the twin on the card, every output
    exact, over 5,000 fuzz nodes (bucket 8,192) with 8 zones, 64 zones and
    no zone label (tk = -1), then 10,000 nodes (bucket 16,384) with 8
    zones; per cluster, NodeResourcesFit on and off, each as three chained
    launches of G = 16 gangs (sizes 2-64, the first gang sized to fit
    exactly, a padding row) and one launch whose first gang fails by one
    member. Returns the summary and the free matrices seen (phase 15b)."""
    from kubernetes_tpu_torch.kernels import gang as KG

    lines, frees = [], []
    for tag, seed, n_nodes, node_cap, n_zones in (
            ("8 zones", 51, 5000, 8192, 8), ("64 zones", 52, 5000, 8192, 64),
            ("tk=-1", 53, 5000, 8192, 0),
            ("8 zones, 10k", 54, 10000, 16384, 8)):
        mirror, caps, nominated, reps = gang_mirror(torch, seed, n_nodes,
                                                    node_cap, n_zones)
        frees.append((tag, mirror, reps))
        rng = random.Random(seed)
        placed, cap0s = [], []
        for fit_on in (True, False):
            # the first gang's capacity at the launch's start state
            args, kw = gang_launch(mirror, caps, reps[:1], [1], nominated,
                                   fit_on)
            cap0 = int(KG.pack_gangs_ref(*args, **kw).cap[0])
            cap0s.append(cap0)
            k_state = t_state = None
            for launch in range(3):
                sizes = [rng.randint(2, 64) for _ in range(14)]
                needs = ([min(cap0, 2 ** 20)] if launch == 0 else
                         [rng.randint(2, 64)]) + sizes + [0]
                args, kw = gang_launch(mirror, caps, reps, needs, nominated,
                                       fit_on, k_state)
                got = KG.pack_gangs(*args, **kw)
                args_t, kw_t = gang_launch(mirror, caps, reps, needs,
                                           nominated, fit_on, t_state)
                want = KG.pack_gangs_ref(*args_t, **kw_t)
                torch.cuda.synchronize()
                cmp_pack(f"[15] {tag} fit={fit_on} launch {launch}", got,
                         want)
                if launch == 0 and fit_on and not bool(want.ok[0]):
                    raise AssertionError(f"[15] {tag}: the exact-fit gang "
                                         "did not fit")
                k_state, t_state = (got.free, got.nzr), (want.free, want.nzr)
                placed.append(int(want.alloc.sum()))
            args, kw = gang_launch(mirror, caps, reps, [cap0 + 1, 5],
                                   nominated, fit_on)
            got = KG.pack_gangs(*args, **kw)
            want = KG.pack_gangs_ref(*args, **kw)
            torch.cuda.synchronize()
            cmp_pack(f"[15] {tag} fit={fit_on} fail-by-one", got, want)
            if bool(want.ok[0]):
                raise AssertionError(f"[15] {tag}: a gang one member past "
                                     "its capacity fit")
        tk, d_cap = mirror.gang_pack_domain()
        lines.append(f"{tag} (N={n_nodes}, tk={tk}, d_cap={d_cap}, "
                     f"first gang's capacity {cap0s}, members placed "
                     f"{placed})")
    return "; ".join(lines), frees


def hold_gang_capacity(torch, frees) -> str:
    """Phase 15b: K7b against its twin on the card, exact: the fuzz
    clusters' device-resident free views with their representatives'
    requests, a [8192, 74] free matrix (70 extended-resource columns) with
    a request binding a few of them, and a request with no active
    column."""
    from kubernetes_tpu_torch.api.resources import pod_request
    from kubernetes_tpu_torch.kernels import gang as KG

    cases = []
    for tag, mirror, reps in frees:
        free = mirror.device_free()
        cases += [(f"{tag} rep {k}", free, torch.tensor(
            mirror._res_row(pod_request(p)), device="cuda"))
            for k, p in enumerate(reps[:4])]
    rng = np.random.default_rng(74)
    wide = torch.tensor(rng.integers(0, 64, size=(8192, 74))
                        .astype(np.float32) * 250.0, device="cuda")
    req = np.zeros((74,), np.float32)
    req[[0, 1, 5, 40, 73]] = [900.0, 200.0, 1.0, 250.0, 500.0]
    cases.append(("R=74", wide, torch.tensor(req, device="cuda")))
    cases.append(("no active column", wide,
                  torch.zeros((74,), device="cuda")))
    out = []
    for tag, free, r in cases:
        got, want = KG.gang_capacity(free, r), KG.capacity_ref(free, r)
        torch.cuda.synchronize()
        cmp_exact(f"[15b] {tag}", got, want)
        out.append(f"{tag} {int(want)}")
    return ", ".join(out)


def gang_drain(torch, fn, scale, device="cuda", packing=True, capture=None,
               clock=None) -> tuple:
    """One gang workload through perf.harness.run_workload (its own
    ``rescale`` hook at ``scale``), the launch counters zeroed just
    before. ``capture`` (a dict) keeps the inputs of the first three K7a
    (kernels/gang.py:pack_core) and K7b calls. Returns (result, end state,
    launches, wall seconds)."""
    from kubernetes_tpu_torch.config.types import default_config
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import gang as KG
    from kubernetes_tpu_torch.perf import workloads as W
    from kubernetes_tpu_torch.perf.harness import run_workload

    cfg = default_config()
    cfg.gang_device_packing = packing
    end: dict = {}
    real_core, real_cap = KG.pack_core, KG.gang_capacity
    if capture is not None:
        capture.update(pack=[], cap=[])

        def core(*args, **kw):
            if len(capture["pack"]) < 3:
                capture["pack"].append((clone_tree(args), dict(kw)))
            return real_core(*args, **kw)

        def cap(*args):
            if len(capture["cap"]) < 3:
                capture["cap"].append(clone_tree(args))
            return real_cap(*args)

        KG.pack_core, KG.gang_capacity = core, cap
    clock_kw = {} if clock is None else dict(now=clock,
                                              sleep=lambda dt: None)
    KB.reset_launches()
    t0, g0 = time.time(), time.perf_counter()
    try:
        res = run_workload(
            getattr(W, fn)(), scale=scale, config=cfg, device=device,
            on_scheduler=lambda s, hub: end.update(
                pods=hub.list_pods(), nodes=hub.list_nodes(),
                gang=dict(s._gang.stats)), **clock_kw)
    finally:
        KG.pack_core, KG.gang_capacity = real_core, real_cap
    res["gc"] = gc_since(g0)
    return res, end, dict(KB.LAUNCHES), time.time() - t0


def gang_line(name, res, launches, wall) -> str:
    st = res["stats"]
    split = {k: round(v, 3) for k, v in st["time_s"].items()}
    return (f"measured {res['pods_per_sec']} pods/s over {res['elapsed_s']} "
            f"s (whole drain {wall:.1f} s); K7a {launches['gang_pack']} "
            f"launches, K7b {launches['gang_capacity']}, K1 "
            f"{launches['phase1_static']}; gang fallbacks "
            f"{st['gang_fallback_reasons'] or 'none'}; device fallbacks "
            f"{st['device_fallbacks']}; host time split s {split}; "
            f"{res['gc']}")


def check_gang_drain(name, res, end, launches) -> None:
    """No chunk's launch failed, nothing degraded for a device fault, and
    every unit admitted by the device path came from a K7a launch (at
    least one launch per 16 device-packed gangs)."""
    st = res["stats"]
    if st["device_fallbacks"] or "device_fault" in st["gang_fallback_reasons"]:
        raise AssertionError(f"{name}: gang device faults {st}")
    packed = end["gang"]["device_admitted"]
    if launches["gang_pack"] < -(-packed // 16):
        raise AssertionError(f"{name}: {packed} gangs packed on the device "
                             f"by {launches['gang_pack']} K7a launches")


def gang_groups(pods, prefix) -> dict:
    """Member pods per gang (``<gang>-m<k>`` names) of one prefix."""
    out: dict = {}
    for p in pods:
        name = p.metadata.name
        if name.startswith(prefix):
            out.setdefault(name.rsplit("-m", 1)[0], []).append(p)
    return out


def pack_work(args) -> tuple:
    """Bytes (inputs read once, outputs written once) and operations of
    one K7a launch at these inputs (after K1)."""
    (free0, nzr0, nom, static_ok, _topo, _tk, req, nzreq, need, own_nom,
     _d, _fit) = args
    g, n = static_ok.shape
    r = free0.shape[1]
    nbytes = (2 * n * r * 4 + n * 2 * 4 + g * n + n * 4 + g * (r + 3) * 4
              + (g * n * 4 if own_nom is not None else 0)
              + g * n * 4 + n * r * 4 + n * 2 * 4 + g * 9 + 4)
    return nbytes, g * n * (9 * r + 14)


def pack_twin(args):
    """The twin of one captured K7a launch (the domain column as the
    kernel reads it)."""
    from kubernetes_tpu_torch.kernels import gang as KG
    from kubernetes_tpu_torch.ops import gang as OG

    (free0, nzr0, nom, static_ok, topo, tk, req, nzreq, need, own_nom,
     d_cap, fit_on) = args
    return KG.pack_core_ref(free0, nzr0, nom, static_ok,
                            OG.pack_domain(topo, tk, d_cap), req, nzreq,
                            need, own_nom, d_cap, fit_on)


def cap_work(args) -> tuple:
    free, req = args
    n, r = free.shape
    return n * r * 4 + r * 4 + 4, n * r * 4


# -------------------------------------------------------------------- DRA

DRA_FIELDS = ("dev_valid", "dev_selbits", "dev_in_use", "req_mask",
              "req_count", "req_all", "pinned", "active")


def sim_clock():
    """A simulated clock for a parity run: each reading advances it a
    little, and the harness's idle sleeps advance it instead of waiting."""
    t = [1000.0]

    def now():
        t[0] += 1e-4
        return t[0]

    def sleep(dt):
        t[0] += dt

    return now, sleep


def dra_work(dra) -> tuple:
    """K8's bytes — the inventory (8 selector words and 2 flags a device),
    the requests (8 words, a count and a mode a slot), static_ok in and
    out, dra_reject — and its operations: 8 word tests for each free
    device against each used request slot of each active pod, on every
    node (what this run's data needs)."""
    n, d = dra.dev_valid.shape
    b, q, _ = dra.req_mask.shape
    nbytes = n * d * (8 * 4 + 2) + b * q * (8 * 4 + 5) + 2 * b * n + 4 * b
    used = ((dra.req_count > 0) | dra.req_all) & dra.active[:, None]
    free = int((dra.dev_valid & ~dra.dev_in_use).sum())
    return nbytes, int(used.sum()) * free * 8


def check_dra(end, name) -> str:
    """Every pod bound where its claims' devices are, every claim
    allocated, no device booked twice, every allocated device accepted by
    its request's class and selectors (recomputed on the host from the
    claims' allocation results and the slices)."""
    from kubernetes_tpu_torch.utils.cel import CelDevice, evaluate

    devices = {}
    for sl in end["slices"]:
        for d in sl.devices:
            devices[(sl.driver, sl.pool, d.name)] = d
    pods = {p.metadata.uid: p for p in end["pods"]}
    seen = set()
    n_dev = 0
    for c in end["claims"]:
        a = c.status.allocation
        if a is None:
            raise AssertionError(f"{name}: claim {c.metadata.name} not "
                                 "allocated")
        reqs = {r.name: r for r in c.spec.device_requests}
        for d in a.devices:
            key = (d.driver, d.pool, d.device)
            if key in seen:
                raise AssertionError(f"{name}: device {key} double-booked")
            seen.add(key)
            n_dev += 1
            dev, req = devices[key], reqs[d.request]
            if req.device_class_name \
                    and dev.device_class_name != req.device_class_name:
                raise AssertionError(f"{name}: {key} is not of class "
                                     f"{req.device_class_name}")
            for sel in req.selectors:
                if not evaluate(sel.cel_expression, CelDevice(
                        d.driver, dev.attributes, dev.capacity)):
                    raise AssertionError(f"{name}: {key} fails "
                                         f"{sel.cel_expression!r}")
        for uid in c.status.reserved_for:
            owner = pods.get(uid)
            if owner is not None and owner.spec.node_name != a.node_name:
                raise AssertionError(f"{name}: claim {c.metadata.name} on "
                                     f"{a.node_name}, its pod on "
                                     f"{owner.spec.node_name}")
    return f"{len(end['claims'])} claims, {n_dev} devices, none twice"


def dra_drain(torch, workload, device="cuda", capture=None, clock=None,
              scale=1.0):
    """One DRA workload through perf.harness.run_workload at ``scale``,
    the launch counters zeroed just before. ``capture`` (a dict) keeps the
    inputs of the drain's first K8 call; ``clock`` is a (now, sleep)
    pair. Returns (result, end state, launches, wall seconds)."""
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import dra as KD
    from kubernetes_tpu_torch.perf.harness import run_workload

    end: dict = {}
    real = KD.fuse_phase1
    if capture is not None:
        def fuse(static_ok, dra, host_ok=None, want_dra_ok=False):
            if "k8" not in capture:
                capture["k8"] = clone_tree((static_ok, dra, host_ok))
            return real(static_ok, dra, host_ok, want_dra_ok)

        KD.fuse_phase1 = fuse
    clock_kw = {} if clock is None else dict(zip(("now", "sleep"), clock))
    KB.reset_launches()
    t0, g0 = time.time(), time.perf_counter()
    try:
        res = run_workload(
            workload, device=device, scale=scale,
            on_scheduler=lambda s, hub: end.update(
                pods=hub.list_pods(), nodes=hub.list_nodes(),
                claims=hub.list_resource_claims(),
                slices=hub.list_resource_slices(),
                dra=dict(s._dra.device_view.stats)), **clock_kw)
    finally:
        KD.fuse_phase1 = real
    res["gc"] = gc_since(g0)
    return res, end, dict(KB.LAUNCHES), time.time() - t0


def hold_k8(torch, errs) -> str:
    """18: K8 against its twin on seeded DRA fuzz over 5,000 nodes (bucket
    8,192): device buckets of 8, 16 and 128, 1, 2 and 4 request slots,
    batches of 256 and 2,048 (past DRA_CHUNK), with and without host
    verdicts. dra_ok, dra_reject and the ANDed mask exact."""
    from kubernetes_tpu_torch import convert
    from kubernetes_tpu_torch.kernels import dra as KD
    from kubernetes_tpu_torch.ops import dra as OD
    from kubernetes_tpu_torch.perf.fuzz import dra_fuzz

    done = []
    for i, (d, q, b) in enumerate(((8, 1, 256), (16, 2, 2048),
                                   (128, 4, 2048), (128, 1, 256),
                                   (8, 4, 2048))):
        f = dra_fuzz(np.random.default_rng(180 + i), 5000, 8192, d, q, b)
        dra = convert.dra_batch_from_numpy(
            **{k: f[k] for k in DRA_FIELDS}, device="cuda")
        st = torch.from_numpy(f["static_ok"]).cuda()
        host = torch.from_numpy(f["host_ok"]).cuda()
        want_ok = OD.batch_feasible(dra)
        for host_t in (None, host):
            out, rej, ok = KD.fuse_phase1(st, dra, host_t, want_dra_ok=True)
            w_out, w_rej = OD.fuse_phase1(st, dra, host_t)
            torch.cuda.synchronize()
            tag = f"[18] K8 D={d} Q={q} B={b} host={host_t is not None}"
            cmp_exact(f"{tag} dra_ok", ok, want_ok)
            cmp_exact(f"{tag} static_ok", out, w_out)
            cmp_exact(f"{tag} dra_reject", rej, w_rej)
        errs["dra_feasible"] = 0.0
        done.append(f"D={d} Q={q} B={b}: {int(want_ok.sum())} of "
                    f"{want_ok.numel()} pairs feasible, dra_reject sum "
                    f"{int(w_rej.sum())}")
    return "; ".join(done)


def hold_k3_pct(torch, card, errs) -> list:
    """21: K3 with the percentageOfNodesToScore window against its twin,
    then the SchedulingBasic drain with the adaptive window on the card.
    Returns the kernels-line entry of K3pct@SchedulingBasic."""
    from kubernetes_tpu_torch.backend.cache import Cache
    from kubernetes_tpu_torch.backend.mirror import Mirror
    from kubernetes_tpu_torch.backend.snapshot import Snapshot
    from kubernetes_tpu_torch.config.types import default_config
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.models import pipeline as P
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf import workloads as W
    from kubernetes_tpu_torch.perf.harness import run_workload

    dev = torch.device("cuda")
    caps = Capacities(nodes=8192, pods=16384)
    fields = ("node_row", "feasible_count", "reject_counts",
              "unresolvable_count", "free", "nzr", "guard", "pct_start")

    def mirror_of(n_nodes):
        cache = Cache()
        for i in range(n_nodes):
            cache.add_node(W._node(i))
        snap = Snapshot()
        cache.update_snapshot(snap)
        mirror = Mirror(caps=caps, device=dev)
        mirror.sync(snap)
        return mirror

    def chain(tag, mirror, pct, start, n_launch, b):
        state = tstate = None
        kst = tst = start
        seen = []
        for k in range(n_launch):
            pods = [W._pod(f"pct-{k}-{i}") for i in range(b)]
            spec = mirror.prepare_launch(pods, b)
            args = (spec, mirror.well_known(), P.default_weights(), caps)
            out = P.launch_batch(*args, serial_scan=True, state=state,
                                 pct_nodes=pct, pct_start=kst, tie_seed=3,
                                 device=dev)
            with twins():
                ref = P.launch_batch(*args, serial_scan=True, state=tstate,
                                     pct_nodes=pct, pct_start=tst,
                                     tie_seed=3, device=dev)
            torch.cuda.synchronize()
            for f in fields:
                cmp_exact(f"[21] {tag} launch {k} {f}", getattr(out, f),
                          getattr(ref, f))
            err = max_err(out.score, ref.score)
            errs["serial_scan_pct"] = max(errs.get("serial_scan_pct", 0.0),
                                          err)
            if not err <= SCORE_TOL:
                raise AssertionError(f"[21] {tag}: score err {err}")
            state, tstate = (out.free, out.nzr), (ref.free, ref.nzr)
            kst, tst = out.pct_start, ref.pct_start
            seen.append(f"start {int(out.pct_start[0])}, feasible "
                        f"{int(out.feasible_count[:b].max())}")
        return f"{tag}: " + " -> ".join(seen)

    big = mirror_of(5000)
    small = mirror_of(60)
    held = [chain("5000 nodes pct 10", big, 10, None, 3, 512),
            chain("5000 nodes adaptive, start on padding row 5000", big,
                  P.ADAPTIVE_PCT, torch.tensor([5000], dtype=torch.int32),
                  3, 512),
            chain("60 nodes (< k_find) pct 10, start on padding row 100",
                  small, 10, torch.tensor([100], dtype=torch.int32), 2,
                  256)]
    log(f"[21] K3 with the window == twin exactly (rows, feasible and "
        f"reject counts, free, nzr, guard, pct_start) over chained "
        f"launches: {'; '.join(held)}")

    # the SchedulingBasic drain with percentage_of_nodes_to_score = 0
    w = W.scheduling_basic()
    cfg = default_config()
    cfg.percentage_of_nodes_to_score = 0
    kept = {}
    end: dict = {}
    real_scan = KS.serial_scan

    def scan_kept(sin):
        if "sin" not in kept:
            kept["sin"] = clone_tree(sin)
        return real_scan(sin)

    KS.serial_scan = scan_kept
    KB.reset_launches()
    t0, g0 = time.time(), time.perf_counter()
    try:
        res = run_workload(w, config=cfg, device="cuda",
                           on_scheduler=lambda s_, hub: end.update(
                               pods=hub.list_pods(), nodes=hub.list_nodes()))
    finally:
        KS.serial_scan = real_scan
    wall = time.time() - t0
    gc21 = gc_since(g0)
    launches = dict(KB.LAUNCHES)
    check_bound(end, 11000, w.name)
    if launches["serial_scan"] <= 0 or launches["auction_score_argmax"]:
        raise AssertionError(f"[21] launches {nonzero(launches)}")
    st = res["stats"]
    split = {k: round(v, 3) for k, v in st["time_s"].items()}
    sin = kept["sin"]
    free0, nzr0, start0 = (sin.free.clone(), sin.nzr.clone(),
                           sin.pct_start.clone())

    def scan_run(fn):
        sin.free.copy_(free0)
        sin.nzr.copy_(nzr0)
        sin.pct_start.copy_(start0)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(sin)
        stop.record()
        torch.cuda.synchronize()
        return (out, sin.free.clone(), sin.nzr.clone(),
                sin.pct_start.clone(), start.elapsed_time(stop))

    got = scan_run(KS._scan_kernel)
    want = scan_run(KS.serial_scan_ref)
    cmp_fields(errs, "[21] drain's first K3 call", got[0], want[0],
               "serial_scan_pct")
    for i, f in ((1, "free"), (2, "nzr"), (3, "pct_start")):
        cmp_exact(f"[21] drain's first K3 call {f}", got[i], want[i])

    def reset():
        sin.free.copy_(free0)
        sin.nzr.copy_(nzr0)
        sin.pct_start.copy_(start0)

    prev = previous_design()
    k3_ms, k3_prev = in_turns(
        torch, lambda: KS._scan_kernel(sin),
        (lambda: prev[0]._scan_kernel(sin)) if prev else None, 5, reset)
    plan = KS.scan_plan(sin)
    floor_ms = cuda_ms(torch, lambda: KS.cluster_barrier_probe(
        plan, sin.b, 3), reps=5, warm=1)
    reset()
    prof = KS.phase_profile(sin)
    reset()
    K3_TIMES["K3pct@SchedulingBasic"] = (k3_ms, k3_prev, floor_ms)
    log(f"[21] {w.name} with percentage_of_nodes_to_score=0 (adaptive: "
        f"k_find {KS.pct_k_find(P.ADAPTIVE_PCT, 5000)} of 5000 nodes) on "
        f"{card}: all 11000 pods bound, no node overcommitted; measured "
        f"{res['pods_per_sec']} pods/s over {res['elapsed_s']} s (whole "
        f"drain {wall:.1f} s); {st['launches']} launches, K3 "
        f"{launches['serial_scan']}, K1 {launches['phase1_static']}; host "
        f"time split s {split}; {gc21}; its first K3 call (B={sin.b}, "
        f"N={sin.n}) "
        f"== twin exactly: kernel {k3_ms:.5f} ms, "
        f"{previous_text(k3_ms, k3_prev)}, twin {want[4]:.1f} ms; its "
        f"{3 * sin.b} cluster barriers alone {floor_ms:.3f} ms (the step "
        f"floor with the window); {k3_shape(sin)}; "
        f"{profile_text(prof, 'a step')}")
    nbytes, ops = scan_work(sin)
    return [kernel_entry("K3pct@SchedulingBasic", "serial_scan_pct", w.name,
                         launches["serial_scan"],
                         errs.get("serial_scan_pct", 0.0), (k3_ms, want[4]),
                         (nbytes + sin.n, ops))]


# ---------------------------------------------------- the learned scorer

LEARNED_SEED_A, LEARNED_SEED_B = 0, 1
# a fuzzed scorer whose term differs between nodes (k9_layers, head x20,
# bias 50)
LIVELY_SEED = 4
# the packing scorer's slope: its term, 150 x (cpu + memory fraction),
# rises by ~6 a SchedulingBasic pod on a node, past the ~3 by which the
# hand terms (LeastAllocated, BalancedAllocation) fall
PACKING_SLOPE = 150.0


def learned_flops(dims) -> int:
    """Operations of one learned term at layer widths ``dims``: the nine
    feature divisions, each layer's multiplies and adds (its bias
    included), the ReLUs, the clip and the weighted add into the total."""
    ops = 9
    for din, dout in zip(dims[:-1], dims[1:]):
        ops += 2 * din * dout
    return ops + sum(dims[1:-1]) + 2 + 2


def k9_layers(seed, hidden, head=20.0, bias=50.0) -> tuple:
    """A fuzzed scorer's ((W, b), ...) stack (numpy): the port's
    init_params with N(0, 0.5) hidden biases and the head scaled around
    ``bias``, so the term varies inside its clip (and past it for a large
    ``head``)."""
    from kubernetes_tpu_torch.learn.train import init_params

    rng = np.random.default_rng(1000 + seed)
    layers = [[w.numpy(), b.numpy()] for w, b in init_params(seed, hidden)]
    for layer in layers[:-1]:
        layer[1] = rng.normal(0, 0.5, layer[1].shape).astype(np.float32)
    layers[-1][0] = layers[-1][0] * np.float32(head)
    layers[-1][1] = np.full((1,), bias, np.float32)
    return tuple(tuple(x) for x in layers)


def packing_layers() -> tuple:
    """A scorer that prefers loaded nodes: one hidden unit relu(frac_cpu +
    frac_mem), the head PACKING_SLOPE times it (clipped at 100). Against
    LeastAllocated it moves bids even where every node is alike, as on
    SchedulingBasic's cluster, where a fuzzed scorer's term is the same
    on all nodes of one load."""
    w0 = np.zeros((9, 8), np.float32)
    w0[0, 0] = w0[1, 0] = 1.0
    w1 = np.zeros((8, 1), np.float32)
    w1[0, 0] = PACKING_SLOPE
    return ((w0, np.zeros((8,), np.float32)), (w1, np.zeros((1,), np.float32)))


def k9_params(torch, seed, hidden, head=20.0, bias=50.0):
    """k9_layers packed on the card."""
    from kubernetes_tpu_torch.kernels import learned as KL

    return KL.LearnedParams.pack(k9_layers(seed, hidden, head, bias),
                                 torch.device("cuda"))


def k9_rows(torch, m, seed):
    """[m, 9] raw feature rows on the card: the two fractions in [0, 1],
    the seven scores in [-20, 140] (past their 0-100 range both ways)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.empty((m, 9), dtype=torch.float32, device="cuda")
    rows[:, :2].uniform_(0.0, 1.0, generator=gen)
    rows[:, 2:].uniform_(-20.0, 140.0, generator=gen)
    return rows


def hold_k9(torch, errs) -> tuple:
    """22: K9's probe against ops/learned.learned_term on the card, exact:
    fuzzed scorers at widths 1, 8, 16/8, 64 and 64 x 7 (the caps), a head
    that drives the output past both clip edges, a NaN weight (NaN in,
    NaN out), and the drain's scorer (init_params(0, (8,))) over M = 4,096
    x 8,192 rows, timed. Returns (summary, kernel ms, twin ms, work)."""
    from kubernetes_tpu_torch.kernels import learned as KL
    from kubernetes_tpu_torch.learn.train import init_params

    dev = torch.device("cuda")

    def held(tag, lp, rows):
        got = KL.learned_probe(lp, rows)
        want = KL.learned_probe_ref(lp, rows)
        torch.cuda.synchronize()
        nan_g, nan_w = torch.isnan(got), torch.isnan(want)
        cmp_exact(f"[22] K9 {tag} NaN mask", nan_g, nan_w)
        cmp_exact(f"[22] K9 {tag}", got[~nan_g], want[~nan_w])
        errs["learned_mlp"] = max(errs.get("learned_mlp", 0.0),
                                  max_err(got[~nan_g], want[~nan_w]))
        return got

    rows = k9_rows(torch, 1 << 20, 5)
    seen = []
    for hidden in ((1,), (8,), (16, 8), (64,), (64,) * 7):
        for seed in (0, 1):
            out = held(f"{hidden} seed {seed}",
                       k9_params(torch, seed, hidden), rows)
        seen.append(f"{'x'.join(map(str, hidden))}: "
                    f"[{float(out.min()):.3f}, {float(out.max()):.3f}]")
    edges = held("clip edges", k9_params(torch, 2, (8,), head=2000.0), rows)
    n_lo, n_hi = int((edges == 0).sum()), int((edges == 100).sum())
    if not n_lo or not n_hi:
        raise AssertionError(f"[22] clip edges not reached: {n_lo} at 0, "
                             f"{n_hi} at 100")
    nan_lp = k9_params(torch, 3, (8,))
    nan_lp.buf[5] = float("nan")           # W0[0, 5]: feeds every row
    nan_out = held("NaN weight", nan_lp, rows)
    if not bool(torch.isnan(nan_out).all()):
        raise AssertionError("[22] a NaN weight did not reach every output")
    # the drain's scorer at the main path's pair count, timed
    m = 4096 * 8192
    big = k9_rows(torch, m, 6)
    lp = KL.LearnedParams.pack(init_params(LEARNED_SEED_A, (8,)), dev)
    out = held("drain scorer, M = 4096 x 8192", lp, big)
    ms = cuda_ms(torch, lambda: KL.learned_probe(lp, big))
    plain = cuda_ms(torch, lambda: KL.learned_probe_ref(lp, big), reps=3,
                    warm=1)
    work = (m * 40 + lp.buf.numel() * 4, m * (learned_flops(lp.dims) - 2))
    summary = (f"[22] K9 probe == twin exactly on 2^20 fuzzed rows at "
               f"widths {'; '.join(seen)} (output ranges, seed 1); clip "
               f"edges {n_lo} rows at 0, {n_hi} at 100; a NaN weight gives "
               f"NaN on every row in both; the drain's scorer "
               f"init_params(0, (8,)) over M = {m} rows: kernel "
               f"{ms:.5f} ms, twin {plain:.3f} ms, "
               f"{int((out > 0).sum())} rows above 0")
    del big
    return summary, ms, plain, work


def learned_drains(torch, card, errs, k9) -> list:
    """23-23d: the learned profile's three drains at full width, each
    beside its hand-tuned arm in the same call (the reference's
    --ab-scorer arms: same workload, same tie-break seed); copies of their
    K2a and K3 inputs held against the twins (exact) and timed; then the
    card-against-CPU bindings of the learned profile at scale 0.2.
    Returns the kernels-line entries of K9 and of K2a / K3 with K9."""
    from kubernetes_tpu_torch import scheduler as S
    from kubernetes_tpu_torch.config.types import default_config
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import learned as KL
    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.kernels import topology as KT
    from kubernetes_tpu_torch.learn.checkpoint import save_checkpoint
    from kubernetes_tpu_torch.learn.train import init_params
    from kubernetes_tpu_torch.models import pipeline as P
    from kubernetes_tpu_torch.perf import workloads as W
    from kubernetes_tpu_torch.perf.harness import (
        CreateNodes,
        CreatePods,
        Workload,
        run_workload,
    )

    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "learned")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "scorer.json")
    tie_seed = 424242

    def publish(seed, version, layers=None):
        save_checkpoint(path, init_params(seed, (8,)) if layers is None
                        else layers, meta={"version": version, "seed": seed})
        # a distinct stamp whatever the file system's time resolution
        t = time.time() + version
        os.utime(path, (t, t))

    def hand_cfg():
        cfg = default_config()
        cfg.tie_break_seed = tie_seed
        return cfg

    def phase_total(st):
        return sum(st["time_s"].values())

    def drain(workload, n_pods, learned, must, swap_at=None, capture=False):
        """One drain with the counters zeroed just before it; with
        ``learned``, ``swap_at`` publishes the second checkpoint after that
        many launches, and with ``capture`` the first-round K2a inputs of
        its first two learned auction launches of each mode, the K3
        inputs and launch arguments of its first two scans are kept."""
        state, kept = {}, {"plain": [], "soft": [], "k3": [], "launch": []}
        builds = [0]
        real = (S.launch_batch, KA.auction_score_argmax, KS.serial_scan,
                KB.build_all)
        n_launch = [0]

        def launch(*args, **kw):
            if capture and len(kept["launch"]) < 2 \
                    and args[0].enable_topology and not args[0].topo_soft:
                kept["launch"].append((clone_tree(args),
                                       {k: clone_tree(v)
                                        for k, v in kw.items()}))
            out = real[0](*args, **kw)
            n_launch[0] += 1
            if swap_at is not None and n_launch[0] == swap_at:
                publish(LEARNED_SEED_B, 2)
            return out

        def bid(rin, prog, k):
            mode = kept["soft" if rin.soft else "plain"]
            if rin.learned is not None and k == 0 and len(mode) < 2:
                mode.append(clone_tree(rin))
            return real[1](rin, prog, k)

        def scan(sin):
            if sin.learned is not None and len(kept["k3"]) < 2:
                kept["k3"].append(clone_tree(sin))
            return real[2](sin)

        def build(*a, **kw):
            builds[0] += 1
            return real[3](*a, **kw)

        if learned:
            publish(LEARNED_SEED_A, 1)
            S.launch_batch, KB.build_all = launch, build
        if capture:
            KA.auction_score_argmax, KS.serial_scan = bid, scan
        cfg = W.learned_config(path, tie_seed=tie_seed) if learned \
            else hand_cfg()
        KB.reset_launches()
        t0, g0 = time.time(), time.perf_counter()
        try:
            res = run_workload(
                workload, config=cfg, device="cuda",
                on_scheduler=lambda sched, hub: state.update(
                    pods=hub.list_pods(), nodes=hub.list_nodes(),
                    mgr=sched._profile_cfg["default-scheduler"]["learned"]))
        finally:
            (S.launch_batch, KA.auction_score_argmax, KS.serial_scan,
             KB.build_all) = real
        wall = time.time() - t0
        launches = dict(KB.LAUNCHES)
        torch.cuda.synchronize()
        check_bound(state, n_pods, workload.name)
        missing = [k for k in must + (("learned_mlp",) if learned else ())
                   if launches[k] <= 0]
        if missing or (not learned and launches["learned_mlp"]):
            raise AssertionError(f"[23] {workload.name}: launches "
                                 f"{nonzero(launches)}, missing {missing}")
        mgr = state["mgr"]
        if learned:
            want_v = 2 if swap_at is not None else 1
            if mgr.version != want_v or mgr.reloads != want_v - 1 \
                    or builds[0]:
                raise AssertionError(
                    f"[23] {workload.name}: scorer version {mgr.version}, "
                    f"{mgr.reloads} reloads, {builds[0]} kernel builds")
        return {"res": res, "wall": wall, "launches": launches,
                "kept": kept, "gc": gc_since(g0), "mgr": mgr}

    def arm_line(tag, run):
        st = run["res"]["stats"]
        split = {k: round(v, 3) for k, v in st["time_s"].items() if v}
        return (f"{tag} {run['res']['pods_per_sec']} pods/s over "
                f"{run['res']['elapsed_s']} s (whole drain "
                f"{run['wall']:.1f} s), {st['launches']} launches, host "
                f"phases {phase_total(st):.3f} s {split}, kernel launches "
                f"{nonzero(run['launches'])}, {run['gc']}")

    paths = (
        ("23", W.scheduling_basic, 11000,
         ("phase1_static", "auction_score_argmax", "auction_accept_commit"),
         2),
        ("23b", W.topology_spreading, 10000,
         ("phase1_static", *KT.STAGES, "serial_scan"), None),
        ("23c", W.preferred_topology_spreading, 10000,
         ("phase1_static", *KT.STAGES, *SOFT_KERNELS), None))
    runs = {}
    for phase, factory, n_pods, must, swap_at in paths:
        # an untimed learned drain keeps copies of its launches' inputs
        # for 23d (and warms the path); then the hand arm and the learned
        # arm, one drain each, neither paying for a copy
        kept = drain(factory(), n_pods, True, must, swap_at, capture=True)
        hand = drain(factory(), n_pods, False, must)
        learned = drain(factory(), n_pods, True, must, swap_at)
        name = factory().name
        delta = (phase_total(learned["res"]["stats"])
                 / phase_total(hand["res"]["stats"]) - 1.0)
        mgr = learned["mgr"]
        swap = (f"; the seed-{LEARNED_SEED_B} checkpoint published after "
                f"launch {swap_at} was picked up (version {mgr.version}, "
                f"{mgr.reloads} reload, no kernel rebuilt)"
                if swap_at is not None else "")
        arm = "learned (LearnedScore 1.0, init_params(0, (8,)))"
        log(f"[{phase}] {name} on {card}, all {n_pods} pods bound, no node "
            f"overcommitted in every drain (tie-break seed {tie_seed}); an "
            f"untimed learned drain kept its launches' inputs, then "
            f"{arm_line('hand', hand)} | {arm_line(arm, learned)} | host "
            f"phase-total delta learned/hand {delta:+.4f} (the reference's "
            f"--ab-scorer budget: 0.03){swap}")
        runs[name.split("/")[0]] = {"kept": kept["kept"],
                                    "launches": learned["launches"]}
    publish(LEARNED_SEED_A, 1)
    profiled(torch, "23e", W.scheduling_basic(),
             config=W.learned_config(path, tie_seed=tie_seed),
             tag=" (learned)")

    # the drain's scorer moves no bid on these inputs (its term is flat
    # there), so the copies below also go through the packing scorer,
    # whose term decides placements (and K2a's through a fuzzed one)
    lively = k9_params(torch, LIVELY_SEED, (8,))
    packing = KL.LearnedParams.pack(packing_layers(), torch.device("cuda"))
    entries = []
    # 23d: K2a with K9 (plain and soft) on copies of the first round of
    # each drain's second learned launch (its first full batch), and K3
    # with K9 on the TopologySpreading drain's first two scans and on its
    # second scan launch with the pct 10 window
    for path, mode in (("SchedulingBasic", "plain"),
                       ("PreferredTopologySpreading", "soft")):
        run = runs[path]
        rin = run["kept"][mode][-1]
        prog = torch.tensor([1, 0], dtype=torch.int32, device="cuda")
        hand_rin = dataclasses.replace(rin, learned=None)
        hand_bid = KA._bid_kernel(hand_rin, prog, 0)
        key = f"auction_score_argmax+K9@{path}"
        moved = []
        for tag, lp in (("drain", rin.learned), ("fuzzed", lively),
                        ("packing", packing)):
            r_in = dataclasses.replace(rin, learned=lp)
            got = KA._bid_kernel(r_in, prog, 0)
            want = KA.auction_score_argmax_ref(r_in, prog, 0)
            torch.cuda.synchronize()
            for i, f in enumerate(("choice", "win")):
                errs[key] = max(errs.get(key, 0.0), max_err(got[i], want[i]))
                cmp_exact(f"[23d] {path} K2a+K9 ({tag} scorer) {f}", got[i],
                          want[i])
            moved.append(int((got[0] != hand_bid[0]).sum()))
        if not moved[2]:
            raise AssertionError(f"[23d] {path}: the packing scorer changed "
                                 "no bid")
        bidders = int((rin.placed < 0).sum())
        prev = previous_design()
        ms, ms_prev = in_turns(
            torch, lambda: KA._bid_kernel(rin, prog, 0),
            (lambda: prev[1]._bid_kernel(rin, prog, 0)) if prev else None, 10)
        K3_TIMES[key] = (ms, ms_prev, None)
        hand_ms = cuda_ms(torch, lambda: KA._bid_kernel(hand_rin, prog, 0))
        plain = cuda_ms(torch, lambda: KA.auction_score_argmax_ref(
            rin, prog, 0), reps=3, warm=1)
        n, r, b = rin.n, rin.req.shape[1], rin.b
        g = rin.static_ok.shape[0]
        lf = learned_flops(rin.learned.dims)
        soft_bytes = (g * n * 11 + g) if rin.soft else 0
        # the operations this round's data needs: the fit check on each
        # bidder's statically feasible nodes (twice in soft mode, whose
        # first pass takes the score extremes), the hand terms and K9 on
        # each feasible (bidder, node) pair; padding rows are never scored
        gid = rin.gid.long()
        checked = rin.static_ok[gid] & (rin.placed < 0)[:, None]
        if rin.soft:
            checked = checked & rin.ipa_ok[gid]
        scored = int((checked & KA._fit(rin)).sum())
        passes = 2 if rin.soft else 1
        work = (n * (2 * r + 4) * 4 + b * (r + 6) * 4 + g * n * 13 + b * 8
                + soft_bytes + rin.learned.buf.numel() * 4,
                passes * int(checked.sum()) * 3 * r
                + scored * (30 + (12 if rin.soft else 0) + lf))
        log(f"[23d] {path}: K2a ({mode} mode) with K9 == twin exactly on "
            f"the first round of its second learned {mode} launch (B={b}, "
            f"{bidders} bidders, G={g}, N={n}, {scored} feasible pairs "
            f"scored), with the drain's scorer, the fuzzed "
            f"k9_layers({LIVELY_SEED}, (8,)) and the packing scorer: kernel "
            f"{ms:.5f} ms (drain's scorer), {previous_text(ms, ms_prev)}, "
            f"the same round without K9 {hand_ms:.5f} ms, twin "
            f"{plain:.3f} ms; K9 changed {moved[0]} / {moved[1]} / "
            f"{moved[2]} of {bidders} bids with the three; "
            f"{k2a_shape(rin)}")
        entries.append(kernel_entry(
            key, "auction_score_argmax_learned", path,
            run["launches"]["auction_score_argmax"], errs[key], (ms, plain),
            work))
    run = runs["TopologySpreading"]
    key = "serial_scan+K9@TopologySpreading"
    k3_times = None
    for i, sin in enumerate(run["kept"]["k3"]):
        free0, nzr0 = sin.free.clone(), sin.nzr.clone()

        def scan_run(fn, s=sin, f0=free0, n0=nzr0):
            s.free.copy_(f0)
            s.nzr.copy_(n0)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(s)
            stop.record()
            torch.cuda.synchronize()
            return out, s.free.clone(), s.nzr.clone(), \
                start.elapsed_time(stop)

        hand_sin = dataclasses.replace(sin, learned=None)
        hand_rows = scan_run(KS._scan_kernel, s=hand_sin)[0].rows
        moved, twin_ms = [], []
        # the packing scorer on the launch with pods in its table (the
        # second); each twin run of a full scan takes ~20 s
        last = i == len(run["kept"]["k3"]) - 1
        for tag, lp in (("drain", sin.learned),
                        *((("packing", packing),) if last else ())):
            s_in = dataclasses.replace(sin, learned=lp)
            got = scan_run(KS._scan_kernel, s=s_in)
            want = scan_run(KS.serial_scan_ref, s=s_in)
            cmp_fields(errs, f"[23d] TopologySpreading scan {i} K3+K9 "
                       f"({tag} scorer)", got[0], want[0], key)
            cmp_exact(f"[23d] scan {i} ({tag} scorer) free", got[1], want[1])
            cmp_exact(f"[23d] scan {i} ({tag} scorer) nzr", got[2], want[2])
            moved.append(int((got[0].rows != hand_rows).sum()))
            twin_ms.append(want[3])
        if last and not moved[1]:
            raise AssertionError(f"[23d] scan {i}: the packing scorer "
                                 "changed no placement")
        prev = previous_design()
        k3_ms, k3_prev = in_turns(
            torch, lambda s_=sin: KS._scan_kernel(s_),
            (lambda s_=sin: prev[0]._scan_kernel(s_)) if prev else None, 3,
            lambda s_=sin, f0=free0, n0=nzr0: (s_.free.copy_(f0),
                                               s_.nzr.copy_(n0)))
        K3_TIMES[key] = (k3_ms, k3_prev, None)
        hand_ms = statistics.median(
            scan_run(KS._scan_kernel, s=hand_sin)[3] for _ in range(5))
        log(f"[23d] TopologySpreading scan launch {i} (B={sin.b}, "
            f"N={sin.n}, {int((hand_rows >= 0).sum())} placed): K3 with "
            f"K9 == twin exactly (rows, scores, counts, free, nzr) with the "
            f"drain's scorer{' and the packing one' if last else ''}: "
            f"kernel {k3_ms:.5f} ms (drain's scorer), "
            f"{previous_text(k3_ms, k3_prev)}, the same launch "
            f"without K9 {hand_ms:.3f} ms, twin {twin_ms[0]:.1f} ms; K9 "
            f"moved {' / '.join(map(str, moved))} of {sin.b} pods; "
            f"{k3_shape(sin)}")
        nbytes, ops = scan_work(sin)
        lf = learned_flops(sin.learned.dims)
        k3_times = ((k3_ms, twin_ms[0]),
                    (nbytes + sin.learned.buf.numel() * 4,
                     ops + lf * ops // 40))
    # the windowed launch with the packing scorer only: its twin takes
    # another ~19 s, and the drain's scorer moves no placement
    args, kw = run["kept"]["launch"][-1]
    kw = {**kw, "pct_nodes": 10, "pct_start": None, "learned": packing}
    out = P.launch_batch(*args, **kw)
    with twins():
        ref = P.launch_batch(*args, **kw)
    torch.cuda.synchronize()
    for f in ("node_row", "score", "feasible_count", "reject_counts",
              "free", "nzr", "guard", "pct_start"):
        cmp_exact(f"[23d] windowed scan {f}", getattr(out, f),
                  getattr(ref, f))
    log(f"[23d] TopologySpreading's second scan launch again with the pct "
        f"10 window (k_find {KS.pct_k_find(10, 5000)}) and the packing "
        f"scorer: K1, K5 and K3 with K9 == twins exactly "
        f"({int((out.node_row >= 0).sum())} placed, next start "
        f"{int(out.pct_start[0])})")
    entries.append(kernel_entry(
        key, "serial_scan_learned", "TopologySpreading",
        run["launches"]["serial_scan"], errs.get(key, 0.0), *k3_times))
    k9_ms, k9_plain, k9_work = k9
    entries.insert(0, kernel_entry(
        "learned_mlp", "learned_mlp", "SchedulingBasic",
        runs["SchedulingBasic"]["launches"]["learned_mlp"],
        errs.get("learned_mlp", 0.0), (k9_ms, k9_plain), k9_work))

    # 24: card-against-CPU bindings of the learned profile at scale 0.2
    # (batch and node bucket cut for the CPU twins), fixed tie-break seed,
    # with the drain's scorer and with the packing one
    def reduced(name, nodes, ops, batch, node_cap):
        return Workload(name=name, batch_size=batch, node_capacity=node_cap,
                        pod_capacity=8192, ops=[CreateNodes(*nodes), *ops])

    zones = ["moon-1", "moon-2", "moon-3"]
    cases = (
        reduced("SchedulingBasic/1000Nodes_2200Pods", (1000, W._node),
                [CreatePods(200, lambda i: W._pod(f"init-{i}")),
                 CreatePods(2000, lambda i: W._pod(f"measure-{i}"))],
                512, 1024),
        reduced("TopologySpreading/1000Nodes_2000Pods",
                (1000, lambda i: W._node(i, zones=zones)),
                [CreatePods(1000, lambda i: W._pod(f"init-{i}")),
                 CreatePods(1000, W._spreading_pod)], 512, 1024))
    scorers = (("drain", LEARNED_SEED_A, None),
               ("packing", None, packing_layers()))
    for w in cases:
        seen = {}
        for tag, seed, layers in scorers:
            publish(seed, 1, layers)
            placements = {}
            for device in ("cuda", "cpu"):
                got_map = {}
                run_workload(w, now=fake_clock(), device=device,
                             config=W.learned_config(path, tie_seed=tie_seed),
                             on_scheduler=lambda s_, hub, m=got_map: m.update(
                                 {p.metadata.name: p.spec.node_name
                                  for p in hub.list_pods()}))
                placements[device] = got_map
            diff = [k for k in placements["cpu"]
                    if placements["cpu"][k] != placements["cuda"].get(k)]
            n = len(placements["cpu"])
            if diff or not all(placements["cpu"].values()):
                raise AssertionError(
                    f"[24] {w.name} ({tag} scorer): {len(diff)} of {n} pods "
                    "bound differently on the card and the CPU")
            seen[tag] = placements["cpu"]
        moved = sum(seen["packing"][k] != seen["drain"][k]
                    for k in seen["drain"])
        if not moved:
            raise AssertionError(f"[24] {w.name}: the packing scorer bound "
                                 "every pod where the drain's scorer did")
        log(f"[24] learned {w.name} (batch {w.batch_size}, bucket "
            f"{w.node_capacity}): card (kernels) and CPU (twins) bind all "
            f"{n} pods identically with the drain's scorer "
            f"init_params({LEARNED_SEED_A}, (8,)) and with the packing "
            f"scorer, which binds {moved} of them elsewhere")
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubernetes_tpu_torch.api.objects import ContainerPort
    from kubernetes_tpu_torch.backend.cache import Cache
    from kubernetes_tpu_torch.backend.mirror import Mirror
    from kubernetes_tpu_torch.backend.snapshot import Snapshot
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import phase1 as K1
    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.kernels import topology as KT
    from kubernetes_tpu_torch.models import pipeline as P
    from kubernetes_tpu_torch.ops.features import (
        Capacities,
        PodBlobs,
        unpack_cluster,
        unpack_pods,
    )
    from kubernetes_tpu_torch.perf import workloads as W
    from kubernetes_tpu_torch.perf.harness import (
        CreateNodes,
        CreatePods,
        Workload,
        run_workload,
    )

    dev = torch.device("cuda")
    t_start = time.time()
    errs = {k: 0.0 for k in KB.COUNTERS}
    gc_watch()

    # ---------------------------------------------------------- 1. card
    card = card_line()
    log(f"[1] card: {card} | torch: {torch.cuda.get_device_name(0)} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------------- 2. build
    build_s = KB.build_all()
    log(f"[2] built {', '.join(KB.KERNELS)} in {build_s:.1f} s; ptxas: "
        f"{ptxas_text('serial_scan', 'serial_scan_kernel')}; "
        f"{ptxas_text('auction_score_argmax', 'auction_bid')}")

    def cmp_close(name, a, b, kernel):
        err = max_err(a, b)
        errs[kernel] = max(errs[kernel], err)
        if not err <= SCORE_TOL:
            raise AssertionError(f"{name}: max abs err {err} > {SCORE_TOL}")

    def cmp_k1(tag, got, want):
        """K1's masks and counts exact, its raw scores within SCORE_TOL."""
        for field in ("static_ok", "rejects", "unres", "taint_ok",
                      "nodeaff_ok"):
            cmp_exact(f"{tag} {field}", getattr(got, field),
                      getattr(want, field))
        for field in ("taint_raw", "aff_raw", "img"):
            cmp_close(f"{tag} {field}", getattr(got, field),
                      getattr(want, field), "phase1_static")

    # ------------------------------------------------- 3. K1 vs its twin
    mirror, caps, pods = fuzz_mirror(torch, 11, 5000, 8192, 8, 8)
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
    cmp_k1("K1", got, want)
    feasible = int(want.static_ok.sum())
    log(f"[3] K1 phase1_static == twin on G=8 x N=8192 "
        f"({feasible} feasible pairs, rejects {want.rejects.sum(0).tolist()},"
        f" max score err {errs['phase1_static']:g})")

    # ------------------------------------------------- 4. K2 vs its twins
    for tag, (seed, n_nodes, node_cap) in (("B<=N", (12, 5000, 8192)),
                                           ("B>N", (13, 1000, 1024))):
        mirror, caps, pods = fuzz_mirror(torch, seed, n_nodes, node_cap,
                                          4096, 8)
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

    # -------------------------------- 3b. K5 vs its twins at full width
    mirror, caps, pods = topology_mirror(torch, 4, 12000, 4, 256)
    spec = mirror.prepare_launch(pods, 256)
    if spec.topo_soft or spec.g_cap != 4 or spec.d_cap != 8192 \
            or "ports" not in spec.active:
        raise AssertionError(f"K5 launch: g_cap {spec.g_cap}, d_cap "
                             f"{spec.d_cap}, soft {spec.topo_soft}, "
                             f"active {spec.active}")
    wk = mirror.well_known()
    rows = spec.rep.long()
    prow_f32, prow_i32 = P.full_pod_rows(spec.pblobs, spec.ptmpl, caps,
                                         spec.pfields, rows)
    k1_args = (spec.cblobs, prow_f32, prow_i32, caps, wk, enabled,
               spec.active)
    p1 = K1.phase1_static(*k1_args)
    p1_ref = K1.phase1_static_ref(*k1_args)
    # each side's masks from its own K1: a wrong mask shows as a difference
    got = KT.topo_statics(spec.cblobs, prow_f32, prow_i32, p1.static_ok,
                          p1.taint_ok, p1.nodeaff_ok, caps, spec.d_cap)
    want = KT.topo_statics_ref(spec.cblobs, prow_f32, prow_i32,
                               p1_ref.static_ok, p1_ref.taint_ok,
                               p1_ref.nodeaff_ok, caps, spec.d_cap)
    torch.cuda.synchronize()
    cmp_k1("K1 (topology groups)", p1, p1_ref)
    for stage, part in zip(KT.STAGES, ("maps", "nodes", "pairs")):
        cmp_fields(errs, f"K5 {stage}", getattr(got, part),
                   getattr(want, part), stage)
    pr = unpack_pods(PodBlobs(f32=prow_f32, i32=prow_i32), caps)
    used = lambda t: t != -1  # noqa: E731
    hard = int(used(pr.anti_tk).sum() + used(pr.aff_tk).sum()
               + (used(pr.tsc_tk) & pr.tsc_hard).sum())
    soft = int(used(pr.paff_tk).sum() + used(pr.panti_tk).sum()
               + (used(pr.tsc_tk) & ~pr.tsc_hard).sum())
    if not hard or not soft:
        raise AssertionError(f"K5 groups: {hard} hard, {soft} soft terms")
    log(f"[3b] K5 topo_table/topo_nodes/topo_pairs == twins on G=4 groups "
        f"({hard} hard, {soft} soft terms) x N=8192 x PT=16384, D=8192: "
        f"{int(want.nodes.anti_ok.sum())} anti-affinity-free and "
        f"{int(want.nodes.term_static.sum())} affinity-satisfied "
        f"(group, node) pairs, ipa_raw range "
        f"[{float(want.nodes.ipa_raw.min())}, "
        f"{float(want.nodes.ipa_raw.max())}], max err "
        f"{max(errs[s_] for s_ in KT.STAGES):g}")

    # ---------------------------------------- 3c. K3 vs its twin on the card
    mirror2, caps2, pods2 = topology_mirror(torch, 7, 0, 8, 256,
                                            nominate=False)
    for i, p in enumerate(pods2):
        p.spec.affinity = None
        p.spec.topology_spread_constraints = []
        if i % 3 == 0:
            p.spec.containers[0].ports = [ContainerPort(
                container_port=80, host_port=8080 + i % 2)]
    spec2 = mirror2.prepare_launch(pods2, 256)
    if spec2.enable_topology or "ports" not in spec2.active:
        raise AssertionError(f"no-topology launch: topology "
                             f"{spec2.enable_topology}, {spec2.active}")
    port_conf0 = KB.LAUNCHES["scan_port_conf"]
    for tag, (mir, cps, launch) in (("topology", (mirror, caps, spec)),
                                    ("no-topology", (mirror2, caps2,
                                                     spec2))):
        args = (launch, mir.well_known(), P.default_weights(), cps)
        out = P.launch_batch(*args, tie_seed=7, device=dev)
        with twins():
            ref = P.launch_batch(*args, tie_seed=7, device=dev)
        torch.cuda.synchronize()
        for field in ("node_row", "score", "feasible_count",
                      "reject_counts", "unresolvable_count", "free", "nzr",
                      "guard"):
            a, b = getattr(out, field), getattr(ref, field)
            errs["serial_scan"] = max(errs["serial_scan"], max_err(a, b))
            cmp_exact(f"K3 {tag} {field}", a, b)
        placed = int((out.node_row >= 0).sum())
        log(f"[3c] K3 serial_scan {tag} launch == twin: {placed}/256 placed "
            f"over 5000 nodes (bucket 8192), reject counts "
            f"{out.reject_counts.sum(0).tolist()}, max err "
            f"{errs['serial_scan']:g}")
    if KB.LAUNCHES["scan_port_conf"] - port_conf0 != 2:
        raise AssertionError("[3c] the hostPort pre-pass ran "
                             f"{KB.LAUNCHES['scan_port_conf'] - port_conf0} "
                             "times for two host-port launches")

    # ---------------- 10. K4 and K2a's soft mode vs the twins on the card
    ipa_off = [True] * len(P.FILTER_PLUGINS)
    ipa_off[P.FILTER_PLUGINS.index("InterPodAffinity")] = False
    soft_fuzz = (
        ("zone keys, D=8", 8, None,
         dict(seed=21, n_nodes=5000, node_cap=8192, n_bound=3000,
              hostname=False)),
        ("hostname keys, D=8192, InterPodAffinity filter off", 8192,
         tuple(ipa_off),
         dict(seed=22, n_nodes=5000, node_cap=8192, n_bound=12000,
              hostname=True)),
        ("B > N (K-accept), hostname keys, D=1024", 1024, None,
         dict(seed=23, n_nodes=1000, node_cap=1024, n_bound=2000,
              hostname=True)))
    soft_run = dict(serial_scan=False, tie_seed=7, device=dev)
    zone_mirror = None
    for tag, want_d, filters, fz in soft_fuzz:
        mir, cps, pods_s = soft_mirror(torch, n_specs=4, n_pods=2040, **fz)
        launch = mir.prepare_launch(pods_s, 2048)
        if not launch.topo_soft or launch.g_cap < 8 \
                or launch.d_cap != want_d:
            raise AssertionError(f"[10] {tag}: soft {launch.topo_soft}, "
                                 f"g_cap {launch.g_cap}, d_cap "
                                 f"{launch.d_cap}")
        held = hold_soft_launch(
            torch, f"[10] {tag}",
            (launch, mir.well_known(), P.default_weights(), cps, filters),
            soft_run, errs)
        out, rec = held["out"], held["log"]
        rounds = sum(1 for a_, _, _ in rec["k2a"] if a_)
        soft_v = rec["view"][0]
        ipa_col = P.FILTER_PLUGINS.index("InterPodAffinity")
        log(f"[10] soft auction, {tag}: K5, K4 soft_scatter/soft_gather "
            f"({len(rec['k4'])} launches, every bidding round's maps and "
            f"scores) and K2a/K2b in soft mode == twins "
            f"exactly; G={launch.g_cap} groups (padding included), "
            f"B=2048 ({int((out.node_row >= 0).sum())}/2040 placed) over "
            f"{fz['n_nodes']} nodes, {rounds} bid rounds, "
            f"{int((~soft_v.ipa_ok_g).sum())} (group, node) pairs the "
            f"ipa mask rejects, ipa reject column sum "
            f"{int(out.reject_counts[:, ipa_col].sum())}, last round's "
            f"ipa_live range [{float(rec['k4'][-1][3].min())}, "
            f"{float(rec['k4'][-1][3].max())}]")
        if zone_mirror is None:
            zone_mirror = (mir, cps, pods_s)

    # --------------- 10d. K3 on a soft-only launch (the serial_scan route)
    mir, cps, pods_s = zone_mirror
    launch = mir.prepare_launch(pods_s[:250], 256)
    args = (launch, mir.well_known(), P.default_weights(), cps)
    out = P.launch_batch(*args, tie_seed=7, device=dev)
    with twins():
        ref = P.launch_batch(*args, tie_seed=7, device=dev)
    torch.cuda.synchronize()
    for field in ("node_row", "score", "feasible_count", "reject_counts",
                  "unresolvable_count", "free", "nzr", "guard"):
        a, b = getattr(out, field), getattr(ref, field)
        errs["serial_scan"] = max(errs["serial_scan"], max_err(a, b))
        cmp_exact(f"[10d] K3 soft-only {field}", a, b)
    log(f"[10d] K3 serial_scan on a soft-only launch (B=256, D="
        f"{launch.d_cap}) == twin: {int((out.node_row >= 0).sum())}/250 "
        "placed")

    # ------------------------------------------ 5. the main path, full width
    w = W.scheduling_basic()
    end_state = {}

    def check_end_state(sched, hub):
        end_state["pods"] = hub.list_pods()
        end_state["nodes"] = hub.list_nodes()

    KB.reset_launches()
    t0, g0 = time.time(), time.perf_counter()
    res = run_workload(w, device="cuda", on_scheduler=check_end_state)
    drain_s = time.time() - t0
    gc5 = gc_since(g0)
    launches = dict(KB.LAUNCHES)
    check_bound(end_state, 11000, w.name)
    missing = [k for k in KB.KERNELS[:3] if launches[k] <= 0]
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
        f"s {split}; kernel launches {nonzero(launches)}; {gc5}")

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

    # ----------------------- 8. the hard-topology paths at full width
    topo_counters = ("phase1_static", "topo_table", "topo_nodes",
                     "topo_pairs", "serial_scan")
    topo_entries = []

    def run_topology(workload, n_pods, check):
        """One drain with the launch counters zeroed just before it and
        read just after; the scan's launches are bracketed by CUDA events
        (device ms per launch), and copies of K1's, K5's and K3's inputs
        are kept for phase 8c from the first topology launch and from the
        first one whose pod table holds pods (the same launch when the
        drain's first table is not empty)."""
        state, last_k1 = {}, {}
        kept = []
        scan_events = []
        real_k1, real_k5, real_scan = (P.phase1_static, KT.topo_statics,
                                       KS.serial_scan)

        def k1_seen(*args):
            last_k1["args"] = args
            return real_k1(*args)

        def k5_kept(*args):
            filled = not any(k["filled"] for k in kept) and bool(
                unpack_cluster(args[0], args[6]).pod_valid.any())
            if not kept or filled:
                kept.append({"k1": clone_tree(last_k1["args"]),
                             "k5": clone_tree(args), "filled": filled})
            return real_k5(*args)

        def scan_timed(sin):
            if kept and "scan" not in kept[-1]:
                kept[-1]["scan"] = clone_tree(sin)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_scan(sin)
            end.record()
            scan_events.append((start, end))
            return out

        P.phase1_static, KT.topo_statics, KS.serial_scan = (
            k1_seen, k5_kept, scan_timed)
        KB.reset_launches()
        try:
            t0 = time.time()
            res = run_workload(workload, device="cuda",
                               on_scheduler=lambda sched, hub: state.update(
                                   pods=hub.list_pods(),
                                   nodes=hub.list_nodes()))
            wall = time.time() - t0
        finally:
            P.phase1_static, KT.topo_statics, KS.serial_scan = (
                real_k1, real_k5, real_scan)
        launches = dict(KB.LAUNCHES)
        torch.cuda.synchronize()
        nodes = check_bound(state, n_pods, workload.name)
        detail = check(state, nodes)
        missing = [k for k in topo_counters if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{workload.name}: kernels never launched: "
                                 f"{missing}")
        scan_ms = [a.elapsed_time(b) for a, b in scan_events]
        st = res["stats"]
        split = {k: round(v, 3) for k, v in st["time_s"].items()}
        log(f"[8] {workload.name} on {card}: all {n_pods} pods bound, no "
            f"node overcommitted, {detail}; measured {res['pods_per_sec']} "
            f"pods/s over {res['elapsed_s']} s (whole drain {wall:.1f} s); "
            f"{st['launches']} launches; host time split s {split}; kernel "
            f"launches {nonzero(launches)}; scan device ms per launch "
            f"{statistics.mean(scan_ms):.3f} (min {min(scan_ms):.3f}, max "
            f"{max(scan_ms):.3f}) over {len(scan_ms)} launches")
        for i, cap in enumerate(kept):
            entries = hold_topology(workload, cap, launches,
                                    timed=i == len(kept) - 1)
        topo_entries.extend(entries)

    def hold_topology(workload, cap, launches, timed):
        """8c: K1, K5 (stage by stage) and K3 against their twins, exactly,
        on one captured launch of a drain; with ``timed``, also their
        CUDA-event times there, the barrier limit of the scan, and the
        kernels-line entries of K5's stages and K3 on this path."""
        path = workload.name.split("/")[0]
        p1 = K1.phase1_static(*cap["k1"])
        p1_ref = K1.phase1_static_ref(*cap["k1"])
        cmp_k1(f"{path} K1", p1, p1_ref)
        # K5: the kernel on the drain's own inputs, the twin chained on
        # its own stages and on the masks of K1's twin
        cb5, f5, i5, _, _, _, caps5, d5 = cap["k5"]
        k5 = KT.prepare_launch(*cap["k5"])
        for stage in KT.STAGES:
            k5.run(stage)
        ct5 = unpack_cluster(cb5, caps5)
        pods5 = unpack_pods(PodBlobs(f32=f5, i32=i5), caps5)
        log2p = KT.log2p_table(d5, dev)
        twin = {}
        twin_stage = {
            "topo_table": lambda: KT.topo_table_ref(
                ct5, pods5, p1_ref.taint_ok, p1_ref.nodeaff_ok, d5),
            "topo_nodes": lambda: KT.topo_nodes_ref(
                ct5, pods5, p1_ref.static_ok, p1_ref.taint_ok,
                p1_ref.nodeaff_ok, twin["topo_table"], d5),
            "topo_pairs": lambda: KT.topo_pairs_ref(
                pods5, twin["topo_nodes"], log2p)}
        for stage in KT.STAGES:
            twin[stage] = twin_stage[stage]()
        torch.cuda.synchronize()
        for stage, g_part in zip(KT.STAGES, k5.out):
            cmp_fields(errs, f"{path} K5 {stage}", g_part, twin[stage],
                       f"{stage}@{path}")
        work = k5_work(ct5, pods5, i5, caps5, d5)
        # K3: kernel and twin from the same state; the twin's one run is
        # also its time
        sin = cap["scan"]
        free0, nzr0 = sin.free.clone(), sin.nzr.clone()

        def scan_run(fn):
            sin.free.copy_(free0)
            sin.nzr.copy_(nzr0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(sin)
            end.record()
            torch.cuda.synchronize()
            return out, sin.free.clone(), sin.nzr.clone(), \
                start.elapsed_time(end)

        kc, tc = {}, {}
        got3, free_k, nzr_k, _ = scan_run(
            lambda s_: KS._scan_kernel(s_, carries=kc))
        want3, free_t, nzr_t, twin_ms = scan_run(
            lambda s_: KS.serial_scan_ref(s_, carries=tc))
        cmp_fields(errs, f"{path} K3", got3, want3, f"serial_scan@{path}")
        cmp_exact(f"{path} K3 free", free_k, free_t)
        cmp_exact(f"{path} K3 nzr", nzr_k, nzr_t)
        for name in KS.CARRIES:
            cmp_exact(f"{path} K3 carry {name}", kc[name], tc[name])
        table = "pods in its table" if cap["filled"] else "an empty table"
        held = (f"[8c] {workload.name}, launch with {table} (B={sin.b}, "
                f"G={f5.shape[0]}, N={sin.n}, PT={caps5.pods}, D={d5}): K1, "
                f"K5 {'/'.join(KT.STAGES)} and K3 == twins exactly "
                f"({int((got3.rows >= 0).sum())} placed, "
                f"{int(got3.feas.sum())} feasible (pod, node) pairs, reject "
                f"counts {got3.rejects.sum(0).tolist()}, the carry maps "
                f"{'/'.join(KS.CARRIES)} too; twin scan {twin_ms:.1f} ms)")
        if not timed:
            log(held)
            return []
        work["serial_scan"] = scan_work(sin)
        # times: 20 CUDA-event launches of each K5 stage (on the prepared
        # arguments: device time, not the wrapper's), the twins' K5 stages
        # over 5; K3 in turns with the previous design (5 launches a turn);
        # the scan's two cluster barriers a step alone on its cluster for B
        # steps (its step floor) and the previous design's three grid
        # barriers a step on its grid; K3's phases from its profile build
        times = {stage: (cuda_ms(torch, lambda st=stage: k5.run(st)),
                         cuda_ms(torch, twin_stage[stage], reps=5, warm=1))
                 for stage in KT.STAGES}

        def reset():
            sin.free.copy_(free0)
            sin.nzr.copy_(nzr0)

        prev = previous_design()
        k3_ms, k3_prev = in_turns(
            torch, lambda: KS._scan_kernel(sin),
            (lambda: prev[0]._scan_kernel(sin)) if prev else None, 5, reset)
        times["serial_scan"] = (k3_ms, twin_ms)
        plan = KS.scan_plan(sin)
        floor_ms = cuda_ms(torch, lambda: KS.cluster_barrier_probe(
            plan, sin.b, 2), reps=5, warm=1)
        grid_ms = cuda_ms(torch, lambda: KS.barrier_probe(sin.n, sin.b),
                          reps=5, warm=1)
        reset()
        prof = KS.phase_profile(sin)
        reset()
        K3_TIMES[f"K3@{path}"] = (k3_ms, k3_prev, floor_ms)
        log(f"{held}; K3 {k3_ms:.5f} ms a launch, "
            f"{previous_text(k3_ms, k3_prev)}; its {2 * sin.b} cluster "
            f"barriers alone {floor_ms:.3f} ms (the step floor of this "
            f"design, {floor_ms / k3_ms:.3f} of the launch), the previous "
            f"design's {3 * sin.b} grid barriers alone {grid_ms:.3f} ms; "
            f"{k3_shape(sin)}; {profile_text(prof, 'a step')}; K5 stages "
            f"ms {[round(times[s_][0], 5) for s_ in KT.STAGES]}; scans "
            f"whose carries stayed in global memory in the drain: "
            f"{launches['serial_scan_global_carries']} of "
            f"{launches['serial_scan']}")
        return [kernel_entry(f"{name}@{path}", name, workload.name,
                             launches[name], errs.get(f"{name}@{path}", 0.0),
                             times[name], work[name])
                for name in (*KT.STAGES, "serial_scan")]

    run_topology(W.topology_spreading(), 10000, check_spread)
    run_topology(W.scheduling_pod_anti_affinity(), 3000, check_anti)
    run_topology(W.scheduling_pod_affinity(), 10000, check_affinity)

    # ------------ 8b. the device's busy share of a TopologySpreading repeat
    profiled(torch, "8b", W.topology_spreading())

    # ------------------------------ 9. reduced TopologySpreading parity
    def reduced_spread():
        zones = ["moon-1", "moon-2", "moon-3"]
        return Workload(
            name="TopologySpreading/300Nodes_900Pods", batch_size=256,
            node_capacity=512, pod_capacity=2048,
            ops=[CreateNodes(300, lambda i: W._node(i, zones=zones)),
                 CreatePods(300, lambda i: W._pod(f"init-{i}")),
                 CreatePods(600, W._spreading_pod)])

    placements = {}
    for device in ("cuda", "cpu"):
        got_map = {}
        run_workload(reduced_spread(), now=fake_clock(), device=device,
                     on_scheduler=lambda s, hub, m=got_map: m.update(
                         {p.metadata.name: p.spec.node_name
                          for p in hub.list_pods()}))
        placements[device] = got_map
    diff = [k for k in placements["cpu"]
            if placements["cpu"][k] != placements["cuda"].get(k)]
    if diff or len(placements["cpu"]) != 900 \
            or not all(placements["cpu"].values()):
        raise AssertionError(f"reduced TopologySpreading: {len(diff)} of "
                             f"{len(placements['cpu'])} pods bound "
                             "differently on the card and the CPU")
    log("[9] reduced TopologySpreading 300 nodes / 900 pods: card (kernels) "
        "and CPU (twins) bind all 900 pods identically")

    # ------------------- 11. the soft-only topology paths at full width
    from kubernetes_tpu_torch import scheduler as S

    soft_entries = []

    def zones_of(state, nodes, pred) -> dict:
        per_zone: dict[str, int] = {}
        for p in state["pods"]:
            if pred(p):
                z = nodes[p.spec.node_name].metadata.labels.get(ZONE, "-")
                per_zone[z] = per_zone.get(z, 0) + 1
        return dict(sorted(per_zone.items()))

    def profile_named(prefix):
        def profile(state, nodes):
            pods_p = [p for p in state["pods"]
                      if p.metadata.name.startswith(prefix)]
            z = zones_of(state, nodes,
                         lambda p: p.metadata.name.startswith(prefix))
            return (f"{len(pods_p)} {prefix}* pods in {len(z)} zone(s) "
                    f"{z} on {len({p.spec.node_name for p in pods_p})} "
                    "distinct nodes")
        return profile

    def run_soft(workload, n_pods, profile):
        """One soft drain with the launch counters zeroed just before it
        and read just after; copies of its first two soft-only launches'
        arguments are kept (the first measured one, and one whose table
        holds the preferred pods the first placed) and held against the
        twins; the later one is timed."""
        path = workload.name.split("/")[0]
        state, kept = {}, []
        real_launch = S.launch_batch

        def launch_kept(*args, **kw):
            if args[0].topo_soft and len(kept) < 2:
                kept.append((clone_tree(args),
                             {k: clone_tree(v) for k, v in kw.items()}))
            return real_launch(*args, **kw)

        S.launch_batch = launch_kept
        KB.reset_launches()
        try:
            t0 = time.time()
            res = run_workload(workload, device="cuda",
                               on_scheduler=lambda sched, hub: state.update(
                                   pods=hub.list_pods(),
                                   nodes=hub.list_nodes()))
            wall = time.time() - t0
        finally:
            S.launch_batch = real_launch
        launches = dict(KB.LAUNCHES)
        torch.cuda.synchronize()
        nodes = check_bound(state, n_pods, workload.name)
        detail = profile(state, nodes)
        missing = [k for k in ("phase1_static", *KT.STAGES, *SOFT_KERNELS)
                   if launches[k] <= 0]
        if missing or len(kept) < 2:
            raise AssertionError(f"{workload.name}: kernels never launched "
                                 f"{missing}, {len(kept)} soft launches")
        st = res["stats"]
        split = {k: round(v, 3) for k, v in st["time_s"].items()}
        log(f"[11] {workload.name} on {card}: all {n_pods} pods bound, no "
            f"node overcommitted; {detail}; measured {res['pods_per_sec']} "
            f"pods/s over {res['elapsed_s']} s (whole drain {wall:.1f} s); "
            f"{st['launches']} launches, {st['round_trips']} flag round "
            f"trips; host time split s {split}; kernel launches "
            f"{nonzero(launches)}")
        perr = {}
        for i, (args, kw) in enumerate(kept):
            if kw.get("serial_scan", True):
                raise AssertionError(f"{path}: a soft-only launch took the "
                                     "serial scan on the card")
            held = hold_soft_launch(torch, f"[11c] {path} launch {i}",
                                    args, kw, perr)
            out, rec = held["out"], held["log"]
            table = int(unpack_cluster(args[0].cblobs, args[3])
                        .pod_valid.sum())
            log(f"[11c] {path} soft launch {i} (table of {table} pods, "
                f"B={out.node_row.shape[0]}, G={args[0].g_cap}, D="
                f"{args[0].d_cap}): K5, every round's K4 (rounds "
                f"{len(rec['k4'])}), K2a/K2b, placements, scores, counts, "
                f"free and nzr == twins exactly "
                f"({int((out.node_row >= 0).sum())} placed)")
        times, work, tdetail, bid_prev = time_soft_launch(torch, held)
        K3_TIMES[f"auction_score_argmax@{path}"] = (
            times["auction_score_argmax"][0], bid_prev, None)
        # the whole launch by either engine on the same inputs: the soft
        # auction (K1, K5, rounds of K4 + K2a + K2b) and the serial scan
        # (K1, K5, K3), host wall to a synchronize, median of 3
        engine_ms = {}
        for serial in (False, True):
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                P.launch_batch(*args, **{**kw, "serial_scan": serial})
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            engine_ms["scan" if serial else "auction"] = round(
                statistics.median(walls), 3)
        log(f"[11e] {path} times at its later soft launch ({tdetail}): "
            + ", ".join(f"{k} {v[0]:.5f} ms (twin {v[1]:.3f})"
                        for k, v in times.items())
            + f"; whole launch ms by engine {engine_ms}")
        soft_entries.extend(
            kernel_entry(f"{name}@{path}", name, workload.name,
                         launches[name], perr.get(name, 0.0), times[name],
                         work[name])
            for name in SOFT_KERNELS)

    run_soft(W.preferred_pod_affinity(), 6000, profile_named("paff-"))
    run_soft(W.preferred_pod_anti_affinity(), 6000, profile_named("panti-"))
    run_soft(W.preferred_topology_spreading(), 10000,
             profile_named("pspread-"))
    run_soft(W.mixed_scheduling_base_pod(), 15000, profile_named("measure-"))
    profiled(torch, "11b", W.preferred_pod_affinity())

    # ------------------------------- 12 / 12b. K6 vs its twins, full width
    log(f"[12] {hold_sweep(torch, errs)}")
    log(f"[12b] {hold_feasible(torch, errs)}")

    # ------------------ 13. PreemptionAsync/5000Nodes at full width (Path A)
    w_pa = W.preemption_async()
    pa_state = {}

    def settle(sched, hub):
        """Drain on until every churn preemptor created before the measured
        phase ended is bound (no churn is injected meanwhile)."""
        churn = [p for p in hub.list_pods()
                 if p.metadata.name.startswith("churn-")]
        deadline = time.time() + 300.0
        while not all((hub.get_pod(p.metadata.uid) or p).spec.node_name
                      for p in churn):
            if time.time() > deadline:
                raise AssertionError(f"{w_pa.name}: churn preemptors still "
                                     "pending 300 s after the measured phase")
            sched.run_until_idle()
            time.sleep(0.05)
            sched.queue.flush_backoff_completed()
        pa_state.update(pods=hub.list_pods(), nodes=hub.list_nodes(),
                        churn=[p.metadata.name for p in churn])

    KB.reset_launches()
    t0 = time.time()
    res = run_workload(w_pa, device="cuda", on_scheduler=settle)
    pa_wall = time.time() - t0
    pa_launches = dict(KB.LAUNCHES)
    pods_by_name = {p.metadata.name: p for p in pa_state["pods"]}
    n_measured = sum(1 for k, p in pods_by_name.items()
                     if k.startswith("measure-") and p.spec.node_name)
    churn_names = [f"churn-high-{i}-{i}" for i in range(res["churn_created"])]
    lost = [k for k in churn_names if k not in pods_by_name]
    if n_measured != 5000 or lost:
        raise AssertionError(f"{w_pa.name}: {n_measured}/5000 measured pods "
                             f"bound, {len(lost)} priority-10 pods evicted")
    check_bound(pa_state, len(pa_state["pods"]), w_pa.name)
    fillers_on = {}
    for k, p in pods_by_name.items():
        if k.startswith("low-"):
            fillers_on[p.spec.node_name] = fillers_on.get(
                p.spec.node_name, 0) + 1
    crowded = [k for k in pa_state["churn"]
               if fillers_on.get(pods_by_name[k].spec.node_name, 0) > 1]
    if crowded:
        raise AssertionError(f"{w_pa.name}: {len(crowded)} preemptors on a "
                             "node keeping more than one filler")
    missing = [k for k in KB.KERNELS[:3] if pa_launches[k] <= 0]
    if missing:
        raise AssertionError(f"{w_pa.name}: kernels never launched "
                             f"{missing}")
    st = res["stats"]
    split = {k: round(v, 3) for k, v in st["time_s"].items()}
    evicted = 20000 - sum(fillers_on.values())
    log(f"[13] {w_pa.name} on {card}: all 5000 measured pods and all "
        f"{len(pa_state['churn'])} churn preemptors created before the "
        f"measured phase ended bound, none of priority 10 evicted, no node "
        f"overcommitted, every preemptor's node keeps at most one filler; "
        f"measured {res['pods_per_sec']} pods/s over {res['elapsed_s']} s "
        f"(whole drain {pa_wall:.1f} s); {st['preemptions']} preemptions, "
        f"{evicted} fillers evicted, {res['churn_created']} churn pods "
        f"created; {st['launches']} launches; host time split s {split}; "
        f"kernel launches {nonzero(pa_launches)} (K6: preempt_sweep "
        f"{pa_launches['preempt_sweep']}, preempt_feasible "
        f"{pa_launches['preempt_feasible']})")

    # ----------- 13b. the full PostFilter path at full width (Path B)
    from kubernetes_tpu_torch.kernels import preempt as KP

    cap = {}
    pb = path_b(torch, 5000, 8192, 128, "cuda", capture=cap)
    detail = check_path_b(pb)
    pb_launches = pb["launches"]
    missing = [k for k in ("phase1_static", *KT.STAGES, "serial_scan",
                           "preempt_sweep", *KP.FOLD_STAGES)
               if pb_launches[k] <= 0]
    if (missing or len(cap["sweep"]) < 3 or len(cap["feasible"]) < 3
            or not cap["spread"]):
        raise AssertionError(f"[13b] kernels never launched {missing}")
    held = []
    for i, (args, kw) in enumerate(cap["sweep"]):
        got, want = KP.preempt_sweep(*args, **kw), \
            KP.preempt_sweep_ref(*args, **kw)
        torch.cuda.synchronize()
        cmp_exact(f"[13b] K6a call {i}", got, want)
        held.append(f"K6a {i}: {int((want >= 0).sum())} rows")
    for i, (args, kw) in enumerate(cap["feasible"] + cap["spread"]):
        got, want = KP.preempt_feasible(*args, **kw), \
            KP.preempt_feasible_ref(*args, **kw)
        torch.cuda.synchronize()
        cmp_exact(f"[13b] K6b call {i}", got, want)
        held.append(f"K6b {i}: {int(want.sum())} feasible")
    # the spread minimum alone against its twin, on the spread call
    m_args, m_kw = cap["spread"][0]
    m_launch = KP.prepare_feasible(*m_args, **m_kw)
    if not m_launch.hard_spread:
        raise AssertionError("[13b] the spread preemptor's fold has no "
                             "DoNotSchedule constraint")
    mt = m_launch.tensors
    used = (mt["tsc_tk"] != -1) & mt["tsc_hard"]

    def min_ref():
        return KP.feasible_min_ref(mt["cnt"], mt["exists_hard"],
                                   mt["min_domains"])

    m_launch.launch("feasible_min")
    torch.cuda.synchronize()
    cmp_exact("[13b] feasible_min", mt["min_cnt"][used], min_ref()[used])
    held.append(f"spread minimum {mt['min_cnt'][used].tolist()}")
    dry_ms = statistics.median(cap["dryrun_s"]) * 1e3
    log(f"[13b] full PostFilter path, 5000 nodes (bucket 8192) each holding "
        f"one app=red pod, 128 preemptors with hostname anti-affinity to "
        f"app=red, on {card}: {detail}; {pb['stats']['preemptions']} "
        f"preemptions in {pb['wall']:.1f} s ({pb['wall'] / 128 * 1e3:.1f} ms "
        f"a preemptor); kernel launches {nonzero(pb_launches)}; the first "
        f"three K6a and K6b calls' inputs == twins exactly ({', '.join(held)})"
        f"; host wall of a whole dry run (_dryrun_feasible: mask, pack, K1, "
        f"K5, fold, pull) median {dry_ms:.3f} ms over "
        f"{len(cap['dryrun_s'])}")
    # K6 times at Path B's inputs: the kernels alone (CUDA events, median
    # of 20) against the twins of the whole functions (median of 5), and
    # the wrappers' whole chains (K1 + sweep; K1 + K5 + fold)
    s_args, s_kw = cap["sweep"][0]
    f_args, f_kw = cap["feasible"][0]
    s_launch = KP.prepare_sweep(*s_args, **s_kw)
    f_launch = KP.prepare_feasible(*f_args, **f_kw)
    s_launch.run()
    f_launch.run()
    torch.cuda.synchronize()
    k6_times = {
        "preempt_sweep": (cuda_ms(torch, s_launch.run), cuda_ms(
            torch, lambda: KP.preempt_sweep_ref(*s_args, **s_kw), reps=5)),
        "preempt_feasible": (
            cuda_ms(torch, lambda: f_launch.launch("preempt_feasible")),
            cuda_ms(torch, lambda: KP.preempt_feasible_ref(*f_args, **f_kw),
                    reps=5)),
        "feasible_min": (
            cuda_ms(torch, lambda: m_launch.launch("feasible_min")),
            cuda_ms(torch, min_ref))}
    chain_ms = {
        "preempt_sweep": cuda_ms(
            torch, lambda: KP.preempt_sweep(*s_args, **s_kw)),
        "preempt_feasible": cuda_ms(
            torch, lambda: KP.preempt_feasible(*f_args, **f_kw)),
        "feasible_min": cuda_ms(
            torch, lambda: KP.preempt_feasible(*m_args, **m_kw))}
    k6_work = {"preempt_sweep": sweep_work(s_launch),
               "preempt_feasible": fold_work(f_launch),
               "feasible_min": min_work(m_launch)}
    log(f"[13b] K6 at Path B's inputs (N={s_args[0].node_f32.shape[0]}, "
        f"P=1, K+1="
        f"{s_args[3].shape[1]}, C={s_args[3].shape[2]}, D={f_args[7]}): "
        + ", ".join(f"{k} kernel {v[0]:.5f} ms (twin {v[1]:.3f}), whole "
                    f"wrapper chain {chain_ms[k]:.5f} ms, this data's work "
                    f"{k6_work[k][0]} B / {k6_work[k][1]} operations"
                    for k, v in k6_times.items()))
    k6_entries = [
        kernel_entry(f"{name}@PostFilterPath", name,
                     "PostFilter path (5000 nodes, 128 preemptors)",
                     pb_launches[name], 0.0, k6_times[name], k6_work[name])
        for name in ("preempt_sweep", "preempt_feasible", "feasible_min")]

    # --------------- 14. reduced preemption parity, card against the CPU
    def reduced_preemption():
        return Workload(
            name="PreemptionAsync/100Nodes", batch_size=256,
            node_capacity=128, pod_capacity=1024,
            ops=[CreateNodes(100, W._node),
                 CreatePods(400, W._low_priority_pod),
                 CreatePods(20, W._high_priority_pod),
                 CreatePods(100, lambda i: W._pod(f"measure-{i}"))])

    ends = {}
    for device in ("cuda", "cpu"):
        got_map = {}
        r14 = run_workload(reduced_preemption(), now=fake_clock(),
                           sleep=lambda dt: None, device=device,
                           on_scheduler=lambda s, hub, m=got_map: m.update(
                               {p.metadata.name: p.spec.node_name
                                for p in hub.list_pods()}))
        ends[device] = (got_map, r14["stats"]["preemptions"])
    if ends["cuda"] != ends["cpu"] or not all(ends["cpu"][0].values()):
        raise AssertionError("[14] reduced PreemptionAsync: card and CPU "
                             "differ")
    n_gone = 400 - sum(1 for k in ends["cpu"][0] if k.startswith("low-"))
    runs = {d: path_b(torch, 300, 512, 16, d, now=fake_clock())
            for d in ("cuda", "cpu")}
    if (runs["cuda"]["bindings"] != runs["cpu"]["bindings"]
            or runs["cuda"]["gone"] != runs["cpu"]["gone"]):
        raise AssertionError("[14] reduced PostFilter path: card and CPU "
                             "differ")
    log(f"[14] reduced parity, card (kernels) against CPU (twins): "
        f"PreemptionAsync 100 nodes / 400 fillers / 20 priority-10 pods / "
        f"100 measured: identical bindings and evictions ({n_gone} fillers "
        f"evicted, {ends['cpu'][1]} preemptions); PostFilter path 300 nodes "
        f"/ 16 preemptors: identical bindings and evictions "
        f"({check_path_b(runs['cpu'])})")

    # ------------------------------- 15 / 15b. K7 vs its twins, full width
    from kubernetes_tpu_torch.kernels import gang as KG

    summary15, frees = hold_gang_pack(torch)
    log(f"[15] K1 + K7a (gang_pack) == twin exactly (ok, alloc, cap, spans, "
        f"free, nzr, guard), G = 16 with own nominated members, fit on and "
        f"off, three chained launches and a fail-by-one launch each: "
        f"{summary15}")
    log(f"[15b] K7b (gang_capacity) == twin exactly: "
        f"{hold_gang_capacity(torch, frees)}")

    # ---------------- 16. the gang workloads at full width on the card
    cap16: dict = {}
    res, end, storm_launches, wall = gang_drain(
        torch, "multi_tenant_gang_storm", 10.0, capture=cap16)
    storm = res["name"]
    pods = end["pods"]
    check_bound(end, 10080, storm)
    check_gang_drain(storm, res, end, storm_launches)
    gangs = gang_groups(pods, "tenant-")
    packed = end["gang"]["device_admitted"]
    if len(gangs) != 480 or (not res["stats"]["gang_fallbacks"]
                             and (packed != 480
                                  or storm_launches["gang_pack"] < 30)):
        raise AssertionError(f"{storm}: {len(gangs)} gangs, {packed} packed "
                             f"on the device, {storm_launches['gang_pack']} "
                             "K7a launches")
    ten = res["tenants"]
    ratio = (ten["tenant-a"]["contended_admitted"]
             / max(ten["tenant-b"]["contended_admitted"], 1))
    for i, (args, kw) in enumerate(cap16["pack"]):
        got, want = KG.pack_core(*args, **kw), pack_twin(args)
        torch.cuda.synchronize()
        cmp_pack(f"[16] {storm} K7a call {i}", got, want)
    log(f"[16] {storm} at scale 10 (5000 nodes, bucket 8192, 2 tenants "
        f"2:1, 480 gangs of 2-64, 10080 members) on {card}: every member "
        f"bound, every gang whole, no node overcommitted; {packed} gangs "
        f"packed on the device; contended admitted tenant-a "
        f"{ten['tenant-a']['contended_admitted']} / tenant-b "
        f"{ten['tenant-b']['contended_admitted']} = {ratio:.3f}; "
        f"{gang_line(storm, res, storm_launches, wall)}; the first "
        f"{len(cap16['pack'])} K7a calls == twin exactly")
    res, end, gl, wall = gang_drain(torch, "gang_topology_packing", 1.0)
    check_bound(end, len(end["pods"]), res["name"])
    check_gang_drain(res["name"], res, end, gl)
    log(f"[16] {res['name']}: every member bound, no node overcommitted, "
        f"validate holds: {res['colocation']}; {gang_line(res['name'], res, gl, wall)}")
    res, end, gl, wall = gang_drain(torch, "gang_preemption", 1.0)
    check_bound(end, len(end["pods"]), res["name"])
    check_gang_drain(res["name"], res, end, gl)
    high = gang_groups(end["pods"], "high-")
    low = gang_groups(end["pods"], "low-")
    if len(high) != 24 or any(len(m) != 4 for m in high.values()):
        raise AssertionError(f"{res['name']}: high gangs {len(high)}, sizes "
                             f"{sorted({len(m) for m in high.values()})}")
    if any(len(m) != 4 for m in low.values()):
        raise AssertionError(f"{res['name']}: a low gang evicted in part")
    log(f"[16] {res['name']}: all 24 high gangs bound whole, "
        f"{128 - len(low)} low gangs evicted whole, none in part, no "
        f"priority-10 pod evicted, no node overcommitted; "
        f"{res['stats']['preemptions']} preemptions; "
        f"{gang_line(res['name'], res, gl, wall)}")
    res, end, gl, wall = gang_drain(torch, "quota_exhaustion_churn", 1.0)
    bound = [p for p in end["pods"] if p.spec.node_name]
    check_bound({"pods": bound, "nodes": end["nodes"]}, len(bound),
                res["name"])
    steady = [p for p in end["pods"]
              if p.metadata.name.startswith("steady-")]
    burst = res["tenants"]["burst"]["admitted"]
    if burst != 100 or len(steady) != 2000 or not all(
            p.spec.node_name for p in steady):
        raise AssertionError(f"{res['name']}: burst admitted {burst}, "
                             f"{sum(bool(p.spec.node_name) for p in steady)}"
                             f"/{len(steady)} steady pods bound")
    log(f"[16] {res['name']}: the burst tenant admitted exactly its quota "
        f"of 100, all 2000 steady pods bound, no node overcommitted; "
        f"{gang_line(res['name'], res, gl, wall)}")

    # ---------------------------------- 16b. the Permit path on the card
    cap16b: dict = {}
    res, end, permit_launches, wall = gang_drain(
        torch, "multi_tenant_gang_storm", 1.0, packing=False,
        capture=cap16b)
    check_bound(end, 1008, res["name"])
    if permit_launches["gang_capacity"] <= 0 or permit_launches["gang_pack"]:
        raise AssertionError(f"[16b] launches {nonzero(permit_launches)}")
    for i, args in enumerate(cap16b["cap"]):
        got, want = KG.gang_capacity(*args), KG.capacity_ref(*args)
        torch.cuda.synchronize()
        cmp_exact(f"[16b] K7b call {i}", got, want)
    log(f"[16b] {res['name']} with gang_device_packing=False (every gang "
        f"through the Permit wait room): all 1008 members bound, every gang "
        f"whole; admitted {end['gang']['admitted']} gangs, rollbacks "
        f"{end['gang']['rollbacks']}, wait-room timeouts "
        f"{end['gang']['timeouts']}; the first {len(cap16b['cap'])} K7b "
        f"calls == twin exactly; {gang_line(res['name'], res, permit_launches, wall)}")

    # ----------- 17. reduced gang parity, card (kernels) against the CPU
    parity = []
    for fn, scale, packing in (("multi_tenant_gang_storm", 0.25, True),
                               ("multi_tenant_gang_storm", 0.25, False),
                               ("gang_preemption", 0.25, True)):
        ends = {}
        for device in ("cuda", "cpu"):
            r17, e17, _l, _w = gang_drain(torch, fn, scale, device, packing,
                                          clock=fake_clock())
            ends[device] = ({p.metadata.name: p.spec.node_name
                             for p in e17["pods"]}, r17.get("tenants"))
        if ends["cuda"] != ends["cpu"]:
            raise AssertionError(f"[17] {fn} x{scale} packing={packing}: "
                                 "card and CPU differ")
        parity.append(f"{fn} x{scale} packing={packing}: "
                      f"{len(ends['cpu'][0])} pods")
    log(f"[17] reduced gang parity, card (kernels) against CPU (twins): "
        f"identical bindings, evictions and tenant admissions on "
        f"{'; '.join(parity)}")

    # K7 times: K7a on a copy of the storm's first launch, K7b on the
    # Permit path's first call (CUDA events, median of 20; twins of 5)
    pa, pkw = cap16["pack"][0]
    ca = cap16b["cap"][0]
    k7_times = {
        "gang_pack": (cuda_ms(torch, lambda: KG.pack_core(*pa, **pkw)),
                      cuda_ms(torch, lambda: pack_twin(pa), reps=5)),
        "gang_capacity": (cuda_ms(torch, lambda: KG.gang_capacity(*ca)),
                          cuda_ms(torch, lambda: KG.capacity_ref(*ca),
                                  reps=5))}
    log(f"[16] K7 times: K7a on the storm's first launch (G={pa[3].shape[0]}"
        f", N={pa[3].shape[1]}, R={pa[0].shape[1]}, d_cap={pa[10]}) kernel "
        f"{k7_times['gang_pack'][0]:.5f} ms (twin "
        f"{k7_times['gang_pack'][1]:.3f}), this launch's work "
        f"{pack_work(pa)}; K7b on the Permit path's first call (N="
        f"{ca[0].shape[0]}, R={ca[0].shape[1]}) kernel "
        f"{k7_times['gang_capacity'][0]:.5f} ms (twin "
        f"{k7_times['gang_capacity'][1]:.3f}), work {cap_work(ca)}")
    k7_entries = [
        kernel_entry("K7a@MultiTenantGangStorm", "gang_pack",
                     "MultiTenantGangStorm/500Nodes at scale 10",
                     storm_launches["gang_pack"], 0.0,
                     k7_times["gang_pack"], pack_work(pa)),
        kernel_entry("K7b@PermitPath", "gang_capacity",
                     "MultiTenantGangStorm/500Nodes, gang_device_packing="
                     "False", permit_launches["gang_capacity"], 0.0,
                     k7_times["gang_capacity"], cap_work(ca))]

    # ------------------------------- 18. K8 vs its twin, full width
    from kubernetes_tpu_torch.kernels import dra as KD
    from kubernetes_tpu_torch.ops import dra as OD

    log(f"[18] K8 (dra_feasible) == twin exactly (dra_ok, dra_reject, the "
        f"ANDed static_ok; with and without host verdicts) over 5000 nodes "
        f"(bucket 8192) on seeded DRA fuzz: {hold_k8(torch, errs)}")

    # ------------- 19. the four DRA drains at their own sizes on the card
    def big_templates():
        w19 = W.dra_steady_state_templates(init_nodes=5000,
                                           measure_pods=5000)
        w19.node_capacity, w19.pod_capacity = 8192, 16384
        w19.name = "DRASteadyStateClaimTemplates/5000Nodes_5000Pods"
        return w19

    k8_entries = []
    for make, n_pods in ((W.dra_steady_state, 500),
                         (W.dra_steady_state_templates, 400),
                         (W.dra_steady_state_cel_in, 300),
                         (W.dra_multi_request, 250),
                         (big_templates, 5000)):
        cap19: dict = {}
        res, end, dl, wall = dra_drain(torch, make(), capture=cap19)
        name = res["name"]
        check_bound(end, n_pods, name)
        detail = check_dra(end, name)
        if dl["dra_feasible"] <= 0 or "k8" not in cap19:
            raise AssertionError(f"{name}: K8 launched {dl['dra_feasible']} "
                                 "times")
        st_, dra_, host_ = cap19["k8"]
        got = KD.fuse_phase1(st_, dra_, host_)
        want = OD.fuse_phase1(st_, dra_, host_)
        torch.cuda.synchronize()
        cmp_exact(f"[19] {name} K8 first call static_ok", got[0], want[0])
        cmp_exact(f"[19] {name} K8 first call dra_reject", got[1], want[1])
        st = res["stats"]
        split = {k: round(v, 3) for k, v in st["time_s"].items()}
        log(f"[19] {name} on {card}: all {n_pods} pods bound, no node "
            f"overcommitted, {detail}, every device accepted by its "
            f"selectors; measured {res['pods_per_sec']} pods/s over "
            f"{res['elapsed_s']} s (whole drain {wall:.1f} s, floor "
            f"{res['threshold']}); {st['launches']} launches, K8 "
            f"{dl['dra_feasible']}, K1 {dl['phase1_static']}; device pods "
            f"{end['dra']['device_pods']}, host-fallback pods "
            f"{end['dra']['host_fallback_pods']}; unschedulable attempts "
            f"{st['unschedulable']}; host time split s {split}; "
            f"{res['gc']}; the first K8 call (B={dra_.req_mask.shape[0]}, N={st_.shape[1]}, "
            f"D={dra_.dev_valid.shape[1]}, Q={dra_.req_mask.shape[1]}) == "
            f"twin exactly")
        k8_times = (cuda_ms(torch, lambda: KD.fuse_phase1(st_, dra_, host_)),
                    cuda_ms(torch, lambda: OD.fuse_phase1(st_, dra_, host_),
                            reps=5))
        k8_entries.append(kernel_entry(
            f"K8@{name.split('/')[0]}"
            + ("@5000Nodes" if n_pods == 5000 else ""), "dra_feasible",
            name, dl["dra_feasible"], 0.0, k8_times, dra_work(dra_)))

    # ------------ 20. reduced DRA parity, card (kernels) against the CPU
    parity = []
    for fn in ("dra_steady_state", "dra_steady_state_templates",
               "dra_steady_state_cel_in", "dra_multi_request"):
        ends = {}
        for device in ("cuda", "cpu"):
            _r, e20, _l, _w = dra_drain(torch, getattr(W, fn)(), device,
                                        clock=sim_clock(), scale=0.2)
            ends[device] = {
                "pods": {p.metadata.name: p.spec.node_name
                         for p in e20["pods"]},
                "claims": {c.metadata.name: (
                    c.status.allocation.node_name,
                    tuple((d.driver, d.pool, d.device)
                          for d in c.status.allocation.devices))
                    if c.status.allocation else None
                    for c in e20["claims"]}}
        if ends["cuda"] != ends["cpu"]:
            raise AssertionError(f"[20] {fn} x0.2: card and CPU differ")
        if not all(ends["cpu"]["pods"].values()):
            raise AssertionError(f"[20] {fn} x0.2: pods left unbound")
        parity.append(f"{fn} x0.2: {len(ends['cpu']['pods'])} pods, "
                      f"{len(ends['cpu']['claims'])} claims")
    log(f"[20] reduced DRA parity, card (kernels) against CPU (twins): "
        f"identical bindings and allocated devices on {'; '.join(parity)}")

    # ---- 21. K3 with the percentageOfNodesToScore window vs its twin
    k3pct_entries = hold_k3_pct(torch, card, errs)

    # ----------------------- 22. K9's probe vs its twin on the card
    k9_summary, *k9 = hold_k9(torch, errs)
    log(k9_summary)

    # ------ 23-24. the learned profile's drains, K2a / K3 with K9, parity
    learned_entries = learned_drains(torch, card, errs, k9)

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

    prev = previous_design()
    bid_ms, bid_prev = in_turns(
        torch, lambda: KA.auction_score_argmax(rin, prog, 0),
        (lambda: prev[1]._bid_kernel(rin, prog, 0)) if prev else None, 10)
    K3_TIMES["auction_score_argmax@SchedulingBasic"] = (bid_ms, bid_prev,
                                                        None)
    bid_prof = KA.bid_profile(rin, prog, 0)
    times = {
        "phase1_static": (cuda_ms(torch, k1), cuda_ms(torch, k1_ref)),
        "auction_score_argmax": (
            bid_ms,
            cuda_ms(torch, lambda: KA.auction_score_argmax_ref(rin, prog, 0))),
    }
    log(f"[7] K2a's first round on the main path (B=4096, N={rin.n}): "
        f"{bid_ms:.5f} ms, {previous_text(bid_ms, bid_prev)}; "
        f"{k2a_shape(rin)}; block 0's "
        + profile_text(bid_prof, "of the round"))
    log("[7] K3 and K2a by path (ms, the previous design's ms in turns in "
        "this call, K3's step floor ms): " + "; ".join(
            f"{k} {v[0]:.5f} / "
            f"{'-' if v[1] is None else format(v[1], '.5f')} / "
            f"{'-' if v[2] is None else format(v[2], '.3f')}"
            for k, v in K3_TIMES.items()))
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
    kernels = [kernel_entry(name, name, w.name, launches[name], errs[name],
                            times[name], work[name])
               for name in KB.KERNELS[:3]] + topo_entries + soft_entries \
        + k6_entries + k7_entries + k8_entries + k3pct_entries \
        + learned_entries
    log(f"[7] kernel times at the main paths' shapes: K1/K2 SchedulingBasic "
        f"(G={g}, B={b}, N={n}, R={r}); K5/K3 each topology drain's first "
        f"launch with pods in its table (phase 8c); bounds from each function's bytes (inputs "
        f"read once, outputs written once) and operations at these inputs; "
        f"K3's cluster barriers, measured alone in 8c and 21, are its step "
        f"floor; "
        f"whole script {time.time() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
