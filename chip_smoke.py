#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):

1. Card: the card's name and power limit (nvidia-smi) and torch's name.
2. Build: nvcc builds the sixteen kernel sources from csrc/*.cu (sm_90a),
   one nvcc each, all started together, and beside them the five
   measurement builds and (where build/previous holds it) the previous
   design; K3's source, the longest, and those beside it go on while
   2b-3b, 10, 10b, 15, 18 and 18b (no scan among them) run, and are
   waited for before 12 and 15b (which time K6a and K7b in turns with the
   previous design) and 3c, the first scan (the line is printed there);
   each source's nvcc seconds; ptxas's registers, spills, stack and static
   shared memory of K3 (both instantiations), K2a's bid, K9's probe, K7a,
   K2b (both instantiations) and K4.
2b. K11's first use in this process, before any drain folds, in parts:
   a pageable upload, the library's load, its first launch, two more.
3. K1 phase1_static vs its plain-torch twin on the card: a seeded cluster
   of 5,000 nodes (bucket 8,192) with taints, labels, host ports and
   images, and 8 pod rows using every feature, then the first row alone
   (G = 1); the default plan and each width of a pair forced (1, 2, 4
   or 8 lanes splitting the inner loops), with and without host
   verdicts. Masks (static_ok and the
   TaintToleration / NodeAffinity masks K5 reads) and counts exact;
   scores within 1e-4 absolute on their 0-100 scale (expected exact: the
   kernels are built with -fmad=false and repeat the twin's operations).
4. K2 (auction_score_argmax + auction_accept_commit) vs the twins: one
   whole launch of 4,096 pods over that cluster (B <= N: one accept per
   node) and one of 4,096 pods over 1,000 nodes in a 1,024 bucket (B > N:
   K-accept). Node rows, counts, free, nzr and guard exact; winning scores
   within 1e-4. K2b's first K-accept round timed device-only (as in 7).
4b. K2b's edge cases (perf.fuzz.accept_cases, the launches
   tests/test_torch_accept.py holds against the JAX package): a hot node
   every pod selects (B <= N, one pod nominated there), two hot nodes
   with B > N whose lists stop fitting mid-way (the first of one list
   nominated there), a launch that bids nothing; each whole through the
   kernels and the twins, every field exact; the two-hot-nodes launch
   again with its K-accept lists in the global scratch, counted under
   auction_accept_commit_global.
3b. K5 (topo_statics: its three stages, table, nodes and pairs, in one
   cooperative launch) vs its three twins on the card: a
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
   the hostPort pre-pass (scan_port_conf) launched once for each. Both
   launches take K3's narrow instantiation (the reference's sizes, no K9,
   no exports; counted under serial_scan_narrow); 25f holds the wide one.
10. The soft-score auction vs the twins on the card: three soft-only
   launches of 2,048 pods (2,040 and a padding group; 4 specs from the
   seeded topology fuzz, made soft) run whole through the kernels and
   through the twins: zone and rack keys over 5,000 nodes (D = 8); hostname
   keys over 5,000 nodes with a 12,000-pod table whose required terms
   give a real InterPodAffinity mask, with that filter switched off
   (D = 8,192); hostname keys over 1,000 nodes in a 1,024 bucket (B > N,
   the K-accept rounds). K5's statics, the soft view, every round's K4
   outputs (the maps K4 keeps, ipa_live, sp_r) and K2a bids (choice,
   win), and the BatchResult (rows, scores, counts, free, nzr, guard)
   exact; K4's plan and its launches with global maps (the hostname
   launches) printed.
10b. K4 at two plans whose shared memory passes the default 48 KB by
   different amounts (seeded soft statics: 40 and 36 groups, A = C = 8,
   D = 8, maps shared), launched in turns A, B, A, B on changing placed
   sets, each round's outputs against the twin exactly: a launch of the
   smaller plan must not leave the larger one unlaunchable.
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
   B = 2,048, N = 8,192, D = 8 or 8,192): K1, K5 (each stage's outputs
   against its twin) and K3 against their twins, every output exact,
   K3's carry maps too. On the later of the two: CUDA-event times of
   each, K3 in turns with the previous design (old, new, new, old; from
   build/previous, where present), K5's one launch from profiler traces
   in turns with the previous design's three (its kernel against their
   kernels, and every device item of a call) with the wrappers' host us;
   the scan's two cluster barriers a pod launched alone on its
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
   K4 (the end-state placed set, from empty maps, and again with nothing
   moved), K2a in soft mode and K2b (the first round); K2a, K2b and K4 in
   turns with the previous design (K2b and K4 device-only: the prebuilt
   launch alone, state restored outside the timed span; the previous
   K4 is its two memsets and two stages), K2b's and K4's device
   durations from a torch.profiler trace of the same runs (median a
   launch; the previous design's a round), the wrappers' host us a round,
   the launch shapes, and the whole launch by each commit engine (the
   soft auction, the serial scan). 11b: a profiled repeat of
   SchedulingPreferredPodAffinity gives the device's idle share and the
   median device duration of a K2b and of a K4 launch over the drain.
12. K6a (K1 with every feature, then preempt_sweep) vs its literal twin
   on the card: 5,000 fuzz nodes (bucket 8,192) with taints, labels and
   host ports, PreemptionAsync's fillers plus memory-only and
   extended-resource victims (the Evaluator's victim state: C = 4 with a
   padding alias and k_cap 8; C = 8 and k_cap 16), nominated
   reservations, P = 1 and 64, with and without a live-free override, the
   C = 8 case again at R = 74 (70 extended-resource columns); and the
   inactive-column case of tests/test_preemption.py:323. kmin exact. The
   R = 74 case at P = 1 by design, in turns with the previous design
   where build/previous holds it: traced, the wrapper's host us with K1
   stubbed, the whole chain with the pull, each design's grid (CTAs, CTAs
   an SM) and ptxas.
12b. K6b (K1 -> K5 over the masked table -> preempt_feasible's fold) vs
   its literal twin: the topology fuzz (5,000 nodes, a 12,000-pod table in
   2 namespaces), preemptors with hard zone spread (with and without
   minDomains), required zone affinity, required hostname anti-affinity
   and fuzz specs; three table masks with the free raised on the masked
   rows; topology on (D = 8, 8,192) and off. [N] exact. The zone-spread
   preemptors' dry runs (D = 8, 8,192): K6b's one launch traced in turns
   with the previous design where build/previous holds it; the same
   cluster again at R = 74, a spread dry run held at both widths and
   traced in turns with the previous design.
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
   spread preemptors share a node, K6a and K6b launched; the first three
   K6a and K6b calls' inputs and a spread preemptor's K6b call held
   against the twins, and the spread minimum that call's launch took
   against feasible_min_ref; K6's kernel and twin times and a whole dry
   run's host wall; K6a at the first call in turns with the previous
   design (traced; the wrapper's host us with K1 stubbed; the whole chain
   K1, sweep, pull; grids and ptxas) and find_candidates' host ms a call,
   where build/previous holds it also over the path again under the
   previous K6a; K6b at the first dry run and the spread call in turns
   with the previous design (traced; the wrapper's host us with K1 and K5
   stubbed, synced and back to back; the whole chain with the pull), and
   where build/previous holds it the path again under the previous K6b
   for its dry runs' wall; the first dry run's K5
   launch held against its twins and timed in turns with the previous
   design (K5@PostFilterDryRun).
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
   launch whose first gang fails by one member, that one again with every
   node-slice and domain array in global memory (counted under
   gang_pack_global). ok, alloc, cap, spans, free, nzr and guard exact.
15b. K7b (gang_capacity) vs its twin: the clusters' device-resident free
   views with four representatives' host rows, a [8,192, 74] free matrix
   (16 CTAs), again with a NaN row, and a request with no active column.
   Exact. A CUDA request tensor refused; the [8,192, 74] case traced in
   turns with the previous design.
16. The gang workloads at full width through perf.harness.run_workload on
   the card, launch counters zeroed before each:
   MultiTenantGangStorm at scale 10 through its rescale hook (5,000
   nodes, 2 tenants 2:1, 480 gangs of 2-64, 10,080 members): every member
   bound, no node overcommitted, K7a launched at least once per 16
   device-packed gangs (480 and 30 launches when nothing falls back), no
   device fallback, the first three K7a calls held against the twin, the
   fallback reasons and the tenants' contended-admission ratio printed;
   GangTopologyPacking/96Nodes (its validate: mean zone spans <= 1.5);
   GangPreemption/128Nodes five times (every high gang bound whole,
   every evicted low gang evicted whole, none in part, no priority-10 pod
   evicted; for each run's measured phase, each stat less its value when
   the phase began: the whole stats["time_s"] split, the preemption
   Evaluator's host ms a preemptor, and the gang_device split a chunk
   from stats["gang_split_s"]: the mirror re-sync and how many chunks
   re-synced, the host pack by part (the nominations, the features, the
   pod rows, the gangs' own nominations, the blobs), extract_state, K1's
   inputs, K1's wrapper, the uploads, K7a's wrapper, the device wait, the
   pull); 16c, where build/previous holds an earlier commit's package:
   the same drain on that package and on this one, each in a worker
   process of its own, five runs each in turns (with ``--only-new`` also
   this package with each host cache of the gang and preemption cycle
   turned off, CACHE_VARIANTS, in the same turns);
   QuotaExhaustionChurn/200Nodes (the burst tenant admits exactly its
   quota of 100, every steady pod bound). Each prints pods/s, the
   stats["time_s"] split with gang_device and gang_commit, and K7a's and
   K7b's launches. K7a on a copy of the storm's first launch: timed in
   turns with the previous design, its cluster shape and shared-memory
   plan, SM cycles a gang by step (the -DPACK_PROFILE build) and ptxas.
16b. The Permit path on the card: the storm at scale 1 with
   gang_device_packing=False; every member bound, K7b launched, its first
   three calls held against the twin; K7b at the first call in turns with
   the previous design: the kernel traced, the plugin's call
   (GangScheduling.dispatch_capacity) in host us, and its host-to-device
   copies from a profiler trace (none allowed).
17. Reduced gang parity, card (kernels) against CPU (twins): the storm at
   scale 0.25 in both arms and GangPreemption at scale 0.25: identical
   bindings, evictions and tenant admissions.
18. K8 (dra_feasible) vs its twin: seeded DRA fuzz (perf.fuzz.dra_fuzz)
   over 5,000 nodes (bucket 8,192) with 8, 16 and 128 devices a node,
   1, 2 and 4 request slots and batches of 256 and 2,048 (past
   DRA_CHUNK), All mode, count 0, pins, inactive rows, in-use devices;
   dra_ok, dra_reject and the ANDed static_ok exact, with and without
   host verdicts; ptxas's report of K8 and of the previous design's.
18b. K8 vs its twin at the lifted caps (launches, not drains): D = 8,192
   devices a node over 300 nodes (bucket 512, B = 64, Q = 4) and
   B = 70,000 pods over 4 nodes (D = 8, Q = 2), with and without host
   verdicts; exact; the plan and a traced time.
19. The four DRA drains at their own sizes through perf.harness on the
   card (DRASteadyState 500 pods, ...ClaimTemplates 400, ...CELIn 300,
   DRAMultiRequest 250; 100 nodes with 8 or 16 devices, batch 256) and
   ...ClaimTemplates at 5,000 nodes / 5,000 pods: every pod bound, no
   node overcommitted, every claim allocated on its pod's node, no device
   booked twice, every device accepted by its request's class and
   selectors (recomputed on the host); pods/s, the time split with
   binder_drain, K8's launches, device and host-fallback pods; each
   drain's first K8 call held against the twin, its device ms from
   profiler traces in turns with the previous design (build/previous),
   the wrappers' host us a launch and the plan.
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
   fuzzed scorers (K9_FUZZ: widths 1 to 2,048, depths 1 to 16; the narrow
   path's classes 8 to 32, the wide path with its slabs in shared memory
   and in global scratch) over 2^20 rows (2^14 past width 128) whose
   scores run past 0-100 both ways, a head driving the output past both
   clip edges, a NaN weight (NaN on every row in both, narrow and wide),
   the drains' scorer init_params(0, (8,)) over 4,096 x 8,192 rows (timed
   in turns with the previous design) and the (256, 256) scorer over
   65,536 rows (timed). Exact.
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
   K9 in turns with the previous design. Then K2a (plain and soft) and K3
   with the (256, 256) scorer, and K2a plain and K3 with a (1,024,) one
   (the wide path's global slabs), on reduced launches of 64 pods over
   5,000 nodes, against the twins: exact, each first call timed with and
   without K9.
   23e: a profiled repeat of the learned SchedulingBasic gives the
   device's idle share.
24. Card-against-CPU bindings of the learned profile at scale 0.1
   (SchedulingBasic 500 nodes / 1,100 pods, TopologySpreading 500 nodes
   / 1,000 pods; batch 512, bucket 512 for the CPU twins) under a fixed
   tie-break seed: identical.
26. K11 (chain_patch, csrc/chain_patch.cu) vs its twin (ops/chain.py) on
   the card, bit for bit, over the 8,192-node bucket at R = 8 and R = 74,
   for 1, 3, 17 and 256 rows of sets only, adds only, both, and a node
   removal (a zero row set), on contiguous and row-strided inputs, which
   stay unwritten; its traced and event times, its wrapper's host us, its
   bound by bytes and the twin's time at three shapes; ptxas.
27. A deterministic churn drain, card (kernels) against CPU (twins):
   SchedulingWithMixedChurn at 500 nodes (bucket 512) / 2,000 measured
   pods (batch 256), a fake clock, a fixed tie-break seed and the churn
   driven by the drain's pump count: identical placements, the chain
   patched in both arms, K11 launched on the card; its K11 calls with
   their set rows (node repacks) and add rows.
28. SchedulingWithMixedChurn/5000Nodes_10000Pods at full size (the 1 s
   recreate-churn of a node and a 9-CPU priority-10 pod, on the clock):
   every measured pod bound, no 9-CPU pod bound, no node overcommitted;
   pods/s against the 1,500 floor and the reference's 265, the host split
   (with chain_patch), the chain stats with the folds' split (flush,
   repack, K11's host call), and K11's launches with their set and add
   rows (whether a node repack was folded at full size).
29. PreemptionAsync/5000Nodes three times (a re-measure): pods/s, sync and
   chain_patch seconds, chain stats and K11's launches a run; phase 16's
   five GangPreemption drains print their chain stats and resyncs too.
   K11's kernels-line entry is taken at its first call on the full-size
   MixedChurn drain (else the next churn drain that made one), held bit
   for bit again, with its launches in that drain (it must have
   launched there); launches_call sums every drain of the call.
30. K12 (row_scatter, csrc/row_scatter.cu) against its twin's route (the
   rows gathered, uploaded and ``index_copy_``'d) on the card, bit for
   bit, at the 8,192-node bucket: the three blobs' dirty rows in one
   launch (1, 64, 1,000 and 2,048 rows each, scattered and as one run),
   the victim cumsum of the PostFilter path (8,192 x 9 x 4) and 8,192 x
   17 x 8, a strided source, an unsorted list, read from the pinned host
   buffers; the launch entry's C planner equal to plan_chunks in every
   launch; a duplicate and an out-of-range row, and a source in pageable
   memory, refused without a launch.
   30b: K12 alone at the three widths (74, 275, 717 words), 1 to 2,048
   rows, scattered and as one run, traced, in turns with the previous
   design (build/previous), beside the copy engine from the same pinned
   blob (the same bytes; the span the rows cover).
31. K13 (blob_unpack, csrc/blob_unpack.cu) against its twin's views, bit
   for bit, on the seeded topology cluster: the chain's seed (the small
   argument block), every ClusterTensors field (Mirror.to_device) and
   every PodFeatures field of a 256-pod batch (Mirror.pack_batch), each
   contiguous and its own.
32. The hazard: rows pushed by K12 behind a torch.cuda._sleep and
   repacked on the host at once; the device holds the pushed rows, a
   copy queued before K12 the old ones, and the Mirror counts the fence's
   wait.
33. SchedulingPreferredPodAffinity/5000Nodes_5000Pods profiled in turns
   with the previous route (old, new, new, old): pods/s, sync and pack,
   the device ms of pageable and pinned copies, K12 and K13, the Mirror's
   fence waits; K12's launches over the first new run by rows; K12's and
   K13's kernels-line entries at their first calls in the first run with
   the new route (launches from that run), each in turns with the
   previous design (events, traced, host us) and the previous route (K12
   also beside the copy engine, every copy of a run summed, and the
   staging-ring variant: the host gathers the rows into a pinned slot
   that K12 reads; K13 beside .contiguous() of the views).
   ``--only-new`` runs 12, 13b, 15b and 16b alone.
25. The training path (25a-25f): the export collection and its K2a
   export pass (with the scorer build's bound: K9's MLP on every pair it
   evaluates) held on the drain's first launch (its 1,000 init pods in
   a batch of 4,096 rows) and its second (4,096 pods), with the drain's
   state and a lively scorer, and timed there, both builds, traced in
   turns with the previous design where build/previous holds it, with
   each design's CTAs, threads, shared bytes, registers and CTAs an SM and
   CTA 0's SM cycles by phase (the -DEXPORT_PROFILE build), and the scorer
   build in turns with its 255-register measurement build (six rounds,
   each trace's reading kept); the 4,096-pod launch with every CTA's pods
   apart (each warp its own pod's path) held and traced in turns with
   the previous design, both builds; K3's export
   outputs, the dataset, train() on the card (K10 one launch a step), K10
   at the dataset's rows and at 2^20 for the (8,) and (64, 64) stacks
   against its twin (loss 1e-5, gradient 1e-4
   relative; two runs and MLPLoss's two modes bit for bit), timed from
   profiler traces in turns with the previous design and train() in
   turns with it where build/previous holds it, the loop's gate, a
   learned drain, the export's cost in turns, the lifted caps.
7. K2a's first round on the main path in turns with the previous design,
   its shape and block 0's phases (the profile build, BID_PROFILE); one
   line of K3's, K2a's, K9's and K7a's times by path beside the previous
   design's and K3's step floors; K2b's first round on the main path
   device-only in turns with the previous design, and one line of K2b's
   and K4's device-only times by path beside the previous design's, with
   the wrappers' host us a round; the share of K2a's export CTAs whose
   pods are alike in each drain of the call (EXPORT_ALIKE). One JSON
   line of per-kernel numbers: K1 and K2 at
   SchedulingBasic's shapes, K5 and K3 once per topology path,
   K4, K2a and K2b once per soft path, K6a and K6b at the PostFilter
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
   TopologySpreading scan (name+K9@path); K2b's and K4's entries also
   carry trace_ms and trace_ms_previous, their device durations from the
   profiler trace (the CUDA-event readings sit at the events' floor).
   B0: K1 at three inputs (SchedulingBasic's launch; the first K1 of a
   PostFilter dry run, G = 1 with every feature; the storm's first gang
   chunk, G = 16), each width of a pair held against the twin, device ms
   from profiler traces in turns with the previous design and each width
   alone, the wrappers' host us, ptxas of both designs (entries
   K1@<input>); every kernels-line entry of K1, K5, K6a, K6b, K7b and K8
   carries trace_ms (K1, K5 and K8 also trace_ms_previous, host_us,
   host_us_previous; K6b also its spread call's, its wrapper's host us and
   the dry runs' wall, each beside the previous design's), every entry
   launches_call, its kernel's launches summed over every drain of the
   call; one line ranks them by launches x (traced ms - bound ms).
   Then the result line.

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
import types

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
    "soft_scores": ("kubernetes_tpu_torch/csrc/soft_scores.cu",
                    "kubernetes_tpu/models/pipeline.py:439"),
    "phase1_static": ("kubernetes_tpu_torch/csrc/phase1_static.cu",
                      "kubernetes_tpu/models/pipeline.py:968"),
    "auction_score_argmax": (
        "kubernetes_tpu_torch/csrc/auction_score_argmax.cu",
        "kubernetes_tpu/models/pipeline.py:649"),
    "auction_accept_commit": (
        "kubernetes_tpu_torch/csrc/auction_accept_commit.cu",
        "kubernetes_tpu/models/pipeline.py:674"),
    "topo_statics": ("kubernetes_tpu_torch/csrc/topo_statics.cu",
                     "kubernetes_tpu/models/pipeline.py:1078"),
    "serial_scan": ("kubernetes_tpu_torch/csrc/serial_scan.cu",
                    "kubernetes_tpu/models/pipeline.py:1358"),
    "preempt_sweep": ("kubernetes_tpu_torch/csrc/preempt_sweep.cu",
                      "kubernetes_tpu/ops/preempt.py:44"),
    "preempt_feasible": ("kubernetes_tpu_torch/csrc/preempt_feasible.cu",
                         "kubernetes_tpu/ops/preempt.py:115"),
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
    "auction_export": ("kubernetes_tpu_torch/csrc/auction_score_argmax.cu",
                       "kubernetes_tpu/models/pipeline.py:740"),
    "serial_scan_export": ("kubernetes_tpu_torch/csrc/serial_scan.cu",
                           "kubernetes_tpu/models/pipeline.py:1511"),
    "learned_train": ("kubernetes_tpu_torch/csrc/learned_train.cu",
                      "kubernetes_tpu/learn/train.py:101"),
    "chain_patch": ("kubernetes_tpu_torch/csrc/chain_patch.cu",
                    "kubernetes_tpu/models/pipeline.py:1645"),
    "row_scatter": ("kubernetes_tpu_torch/csrc/row_scatter.cu",
                    "kubernetes_tpu/backend/mirror.py:128"),
    "blob_unpack": ("kubernetes_tpu_torch/csrc/blob_unpack.cu",
                    "kubernetes_tpu/models/pipeline.py:1632"),
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
            "library_ms": None,
            "counter": ENTRY_COUNTER.get(kernel, kernel)}


# The previous design of K3, K2a, K2b, K4, K9, K7a, K1, K8, K5, K12, K13,
# K10, K6b, K6a and K7b: kernels/scan.py, kernels/auction.py, kernels/soft.py,
# kernels/learned.py, kernels/gang.py, kernels/phase1.py, kernels/dra.py,
# kernels/topology.py, kernels/scatter.py, kernels/unpack.py,
# kernels/preempt.py and their csrc/
# sources in the port's package of an earlier commit, unpacked by `git
# archive` into this ignored directory for one like-for-like call and never
# committed (README's port section names the commands; phase 16c runs that
# whole package too). Absent in a plain checkout: the comparison is then
# skipped and says so.
HERE = os.path.dirname(os.path.abspath(__file__))
PREVIOUS_TREE = os.path.join(HERE, "build", "previous")
PREVIOUS_DIR = os.path.join(PREVIOUS_TREE, "kubernetes_tpu_torch")
PREVIOUS_FILES = ("csrc/serial_scan.cu", "csrc/auction_score_argmax.cu",
                  "csrc/auction_accept_commit.cu", "csrc/soft_scores.cu",
                  "csrc/learned_mlp.cuh", "csrc/learned_mlp.cu",
                  "csrc/gang_pack.cu", "csrc/phase1_static.cu",
                  "csrc/dra_feasible.cu", "csrc/topo_statics.cu",
                  "csrc/row_scatter.cu", "csrc/blob_unpack.cu",
                  "csrc/learned_train.cu", "csrc/preempt_feasible.cu",
                  "csrc/preempt_sweep.cu", "csrc/gang_capacity.cu",
                  "kernels/scan.py", "kernels/auction.py",
                  "kernels/soft.py", "kernels/learned.py",
                  "kernels/gang.py", "kernels/phase1.py", "kernels/dra.py",
                  "kernels/topology.py", "kernels/scatter.py",
                  "kernels/unpack.py", "kernels/preempt.py")
PREVIOUS_KERNELS = ("serial_scan", "auction_score_argmax",
                    "auction_accept_commit", "soft_scores", "learned_mlp",
                    "gang_pack", "phase1_static", "dra_feasible",
                    "topo_statics", "row_scatter", "blob_unpack",
                    "learned_train", "preempt_feasible", "preempt_sweep",
                    "gang_capacity")
_PREVIOUS: dict = {}


def previous_design():
    """(scan, auction, learned, gang, soft, phase1, dra, topology,
    scatter, unpack, preempt) modules of the previous design, each
    launching its own library (built from PREVIOUS_DIR) and counting into
    a dict of its own, or None where PREVIOUS_DIR is absent. The scan and
    auction modules read the previous learned module's LearnedNet."""
    if "mods" in _PREVIOUS:
        return _PREVIOUS["mods"]
    if not all(os.path.exists(os.path.join(PREVIOUS_DIR, f))
               for f in PREVIOUS_FILES):
        _PREVIOUS["mods"] = None
        return None
    import collections
    import types

    from kubernetes_tpu_torch.kernels import build as KB

    src = os.path.join(PREVIOUS_DIR, "csrc")
    KB.build_all(PREVIOUS_KERNELS, src)
    shim = types.SimpleNamespace(**{k: getattr(KB, k) for k in dir(KB)
                                    if not k.startswith("__")})
    shim.library = lambda name: KB.library(name, src)
    shim.LAUNCHES = collections.defaultdict(int)
    mods = {}
    for name in ("learned", "auction", "scan", "gang", "soft", "phase1",
                 "dra", "topology", "scatter", "unpack", "preempt"):
        path = os.path.join(PREVIOUS_DIR, "kernels", name + ".py")
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        mod = types.ModuleType(f"previous_{name}")
        mod.__file__ = path
        sys.modules[mod.__name__] = mod
        # the previous modules read each other, not this design's
        for dep, alias in (("learned", "KL"), ("auction", "KA")):
            if dep in mods:
                text = text.replace("from kubernetes_tpu_torch.kernels "
                                    f"import {dep} as {alias}\n", "")
                setattr(mod, alias, mods[dep])
        exec(compile(text, path, "exec"), mod.__dict__)  # noqa: S102
        mod.KB = shim
        mods[name] = mod
    _PREVIOUS["mods"] = (mods["scan"], mods["auction"], mods["learned"],
                         mods["gang"], mods["soft"], mods["phase1"],
                         mods["dra"], mods["topology"], mods["scatter"],
                         mods["unpack"], mods["preempt"])
    return _PREVIOUS["mods"]


def previous_changed(name: str) -> bool:
    """Does the previous design's source of kernel ``name`` (with the
    local headers it includes) differ from this checkout's? Only a
    changed kernel is timed against its previous design: an unchanged
    one would be timed against itself."""
    from kubernetes_tpu_torch.kernels import build as KB

    src = os.path.join(PREVIOUS_DIR, "csrc", name + ".cu")
    return os.path.exists(src) and KB.source_digest(src) \
        != KB.source_digest(os.path.join(KB.SRC_DIR, name + ".cu"))


def side_builds() -> list:
    """Threads that build, while the other kernels build and the phases
    before the first scan run, K3's source (serial_scan, the longest
    nvcc), the measurement builds (-DSCAN_PROFILE, -DBID_PROFILE,
    -DEXPORT_PROFILE, -DEXP_K9_MIN_CTAS=1, -DPACK_PROFILE,
    -DK10_TILED_ONLY, K6a's SWEEP_BUILDS) and the previous design where
    PREVIOUS_DIR holds it; each keeps its error in ``.error``."""
    import threading

    from kubernetes_tpu_torch.kernels import build as KB

    jobs = [lambda: KB.build_all(("serial_scan",)),
            lambda: KB.build_variant("serial_scan", ("SCAN_PROFILE",)),
            lambda: KB.build_variant("auction_score_argmax",
                                     ("BID_PROFILE",)),
            lambda: KB.build_variant("auction_score_argmax",
                                     ("EXPORT_PROFILE",)),
            lambda: KB.build_variant("auction_score_argmax",
                                     ("EXP_K9_MIN_CTAS=1",)),
            lambda: KB.build_variant("gang_pack", ("PACK_PROFILE",)),
            lambda: KB.build_variant("learned_train", ("K10_TILED_ONLY",))]
    jobs += [lambda v=v: KB.build_variant("preempt_sweep", v)
             for v in SWEEP_BUILDS]
    if all(os.path.exists(os.path.join(PREVIOUS_DIR, f))
           for f in PREVIOUS_FILES):
        # only the sources that differ from this design's: an unchanged
        # one names the very library the kernels' own build is writing
        src = os.path.join(PREVIOUS_DIR, "csrc")
        changed = tuple(n for n in PREVIOUS_KERNELS
                        if KB.source_digest(os.path.join(src, n + ".cu"))
                        != KB.source_digest(os.path.join(KB.SRC_DIR,
                                                         n + ".cu")))
        jobs.append(lambda: KB.build_all(changed, src))
    threads = []
    for job in jobs:
        def run(job=job):
            try:
                job()
            except Exception as e:  # noqa: BLE001 (re-raised at join)
                threading.current_thread().error = e

        t = threading.Thread(target=run)
        t.error = None
        t.start()
        threads.append(t)
    return threads


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


# K3's, K2a's, K9's and K7a's readings by path: (ms, the previous
# design's ms in the same call or None, step floor ms or None), for the
# summary before the kernels line
K3_TIMES: dict = {}


def resident_ctas(regs: int, threads: int, smem: int) -> int:
    """CTAs an H100 SM holds at once for a kernel of ``regs`` registers a
    thread, ``threads`` a CTA and ``smem`` dynamic shared bytes a CTA: the
    least of the warp (64), register (64 K, 256-register warp units),
    shared-memory (228 KB, 1 KB reserved a CTA) and CTA (32) limits."""
    warps = -(-threads // 32)
    regs_warp = -(-max(regs, 1) * 32 // 256) * 256
    return min(64 // warps, 65536 // (regs_warp * warps),
               233472 // (smem + 1024), 32)


def export_shape(mod, rin) -> dict:
    """K2a's export-pass launch for these inputs under the design of
    ``mod`` (this package's kernels/auction.py, or build/previous's): CTAs,
    threads and dynamic shared bytes a CTA, ptxas's registers of the
    instantiation it runs and the CTAs an SM holds at once."""
    from kubernetes_tpu_torch.kernels import build as KB

    k9 = rin.learned is not None
    if hasattr(mod, "export_plan"):
        pl = mod.export_plan(rin)
        ctas, threads, smem = pl.ctas, pl.threads, pl.smem
        how = ("resident" if pl.resident else f"tiles of {pl.tile}")
        extra = {"cluster_text": f" in clusters of {pl.cluster} "
                                 f"({pl.slice} nodes a CTA, {how}; "
                                 f"{mod.export_clusters(rin)} clusters "
                                 f"resident on the card)"}
    else:
        lf = mod.KL.smem_floats(mod.KL.net_of(rin.learned, mod.MAX_P,
                                              mod.K9_NARROW), mod.MAX_P)
        p, _, smem = mod.tiling_of(lf, rin.req.shape[1], rin.n)
        ctas, threads, extra = -(-rin.b // p), 32 * p, {}
    src = os.path.dirname(os.path.abspath(mod.__file__))
    log_ = KB.build_log("auction_score_argmax",
                        os.path.join(os.path.dirname(src), "csrc"))
    regs = next((v.get("registers", 0) for fn, v in sorted(log_.items())
                 if "auction_export" in fn
                 and ("ILb1E" if k9 else "ILb0E") in fn), 0)
    return {"ctas": ctas, "threads": threads, "smem": smem, "regs": regs,
            "per_sm": resident_ctas(regs, threads, smem), **extra}


def previous_text(ms_new, ms_old) -> str:
    if ms_old is None:
        return ("no previous design in this call (build/previous absent, "
                "or this kernel unchanged since it)")
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
        tag = {"ILb1ELb0ELb0ELb1E": " (all-shared, narrow)",
               "ILb0ELb0ELb0ELb1E": " (generic, narrow)",
               "ILb1ELb0E": " (all-shared)", "ILb1ELb1E": " (all-shared, "
               "K9)", "ILb0ELb0E": " (generic)", "ILb0ELb1E": " (generic, K9)",
               "bidILb0E": " (no K9)", "bidILb1E": " (K9)",
               "ILi8ELb0E": " (narrow 8)", "ILi16ELb0E": " (narrow 16)",
               "ILi32ELb0E": " (narrow 32)", "ILi0ELb1E": " (wide)",
               "fnILi16E": " 16", "fnILi32E": " 32", "fnILi8E": " 8",
               "commitILb0E": " (one accept)", "commitILb1E": " (K-accept)"}
        label = entry + next((t for k, t in tag.items() if k in fn), "")
        regs = (f"{v['registers']} registers, " if "registers" in v
                else "")
        out.append(f"{label}: {regs}spill stores/loads "
                   f"{v.get('spill_stores', 0)}/{v.get('spill_loads', 0)} B, "
                   f"stack {v.get('stack', 0)} B"
                   + (f", static shared {v['smem']} B" if "smem" in v
                      else ""))
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


def profiled(torch, phase, workload, config=None, tag="",
             kernels=None) -> None:
    """A profiled repeat of a drain: the device's busy and idle share of
    its wall, the kernels that took most of the busy time, and the median
    device duration of one launch of each kernel named in ``kernels``."""
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
        medians = ""
        if kernels:
            per = device_durations(prof, kernels)
            got = {k: (statistics.median(d) / 1e3, len(d))
                   for k, d in sorted(per.items())}
            medians = ("; median device ms a launch (kernel, ms, launches) "
                       + ", ".join(f"{k} {v[0]:.5f} {v[1]}"
                                   for k, v in got.items()))
        log(f"[{phase}] profiled {name} drain: device busy "
            f"{busy_us / 1e6:.4f} s of {wall_s:.2f} s wall, idle share "
            f"{1.0 - busy_us / 1e6 / wall_s:.4f}; top (kernel, ms, "
            f"count) {top}{medians}")
    else:
        log(f"[{phase}] profiled {name} drain: the profiler recorded "
            "no device time; idle share not measured")


def scan_head(sin, b):
    """The first ``b`` pods of a captured scan (a shorter twin run) on
    copies of its state; the scan itself where it has no more."""
    if sin.b <= b:
        return sin
    cut = {f: getattr(sin, f)[:b] for f in (
        "req", "nzreq", "nominated_row", "uid", "g1", "hp_port",
        "hp_proto", "hp_ip", "gid", "pod_valid")
        if getattr(sin, f) is not None}
    return dataclasses.replace(clone_tree(sin), **{
        k: v.contiguous() for k, v in cut.items()})


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


def k5_launch_work(ct, pods, prow_i32, caps, d) -> tuple:
    """K5's one launch: its stages' bytes less what one stage reads of
    another's outputs (the maps, the spread presence maps), and their
    operations."""
    work = k5_work(ct, pods, prow_i32, caps, d)
    g = prow_i32.shape[0]
    tk, a, c = caps.topo_cols, caps.aff_terms, caps.spread_constraints
    maps = g * (tk * d * 5 + a * d + 1 + c * d * 4)
    return (sum(b for b, _ in work.values()) - maps - 2 * g * c * d,
            sum(o for _, o in work.values()))


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
SOFT_KERNELS = ("soft_scores", "auction_score_argmax",
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

    def plain(ref):
        # the kernels' launch objects and output buffers (launch=, out=)
        # mean nothing to a twin
        return lambda *args, **_: ref(*args)

    slots = ((P, "phase1_static", K1.phase1_static_ref),
             (KD, "fuse_phase1", KD.fuse_phase1_ref),
             (KA, "auction_score_argmax", plain(KA.auction_score_argmax_ref)),
             (KA, "auction_accept_commit",
              plain(KA.auction_accept_commit_ref)),
             (KA, "auction_final", KA.auction_final_ref),
             (KT, "topo_statics", KT.topo_statics_ref),
             (KS, "serial_scan", KS.serial_scan_ref),
             (KSoft, "soft_scores", plain(KSoft.soft_scores_ref)))
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

    def k4(soft, placed, prog, k, out, **kw):
        active = int(prog[k % 2])
        real_k4(soft, placed, prog, k, out, **kw)
        log["k4"].append((active, out.maps.clone(), out.tmap.clone(),
                          out.ipa_live.clone(), out.sp_r.clone()))

    def k2a(rin, prog, k, **kw):
        active = int(prog[k % 2])
        if "rin0" not in log:
            log["rin0"] = clone_tree(rin)
        choice, win_now = real_k2a(rin, prog, k, **kw)
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
        if a is None and b is None:
            continue        # an output this launch does not compute
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
    names = (("soft_scores", "maps"), ("soft_scores", "tmap"),
             ("soft_scores", "ipa_live"), ("soft_scores", "sp_r"))
    for k, (g4, w4) in enumerate(zip(got["k4"], want["k4"])):
        if g4[0] != w4[0]:
            raise AssertionError(f"{tag}: K4 round {k} flags differ")
        if not g4[0]:
            continue        # a no-op round writes nothing
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
    """Bytes (inputs read once, outputs written once) and operations of one
    K4 round with the placed set ``placed``, as the function needs them
    (the maps from the placed set, then the gather), whatever implements
    it: the batch's gid/valid/placed words, the topology rows of the nodes
    holding placed pods, the term keys, matches and weights, those nodes'
    eligibility rows; every node's topology row, the [G, N] and [G, N, C]
    statics; the maps and the two [G, N] scores written once. Operations:
    one add per (placed pod, group, term); ~4 per gathered term and
    constraint at each (group, node)."""
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
    reads = (b * 9 + nodes * tk * 4 + term_words + g * nodes * c
             + n * tk * 4 + g * n * (4 + 1) + g * n * c * (4 + 1)
             + g * c * 9)
    return {"soft_scores": (reads + maps + 2 * g * n * 4,
                            n_placed * terms
                            + g * n * (4 * (a + g * a) * 2 + 6 * c))}


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


# K2b's and K4's device-only readings by path: {key: (ms, the previous
# design's ms in turns or None, the wrapper's host us a round, the
# previous wrapper's or None, ms a launch of 50 back to back, the previous
# design's, ms of a launch whose input flag is 0)}, for the summary before
# the kernels line
SPLIT: dict = {}
# K2b's and K4's device durations from a torch.profiler trace by path:
# {key: (ms a launch, the previous design's ms a round or None)}
TRACE: dict = {}
BATCH = 50


def device_durations(prof, names=None) -> dict:
    """{kernel name: [us of each launch]} of a torch.profiler trace's
    device items, those of a kernel named in ``names`` (every one where
    None; a trace names ``void auction_commit<false>(CommitArgs)``)."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        base = e.name.split("(")[0].split("<")[0].split(" ")[-1]
        if names is not None and base not in names:
            continue
        out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out


def trace_ms(torch, fn, reps: int, reset=None, names=None,
             whole: bool = False):
    """Device milliseconds of one run of ``fn`` from a torch.profiler
    (CUPTI) trace of ``reps`` runs, ``reset()`` before each: for each
    device item named as in ``device_durations`` (name the kernels when
    ``reset`` launches work of its own), its median duration times its
    launches a run, summed; with ``whole``, every item's duration summed
    over ``reps`` (a mean: for a run whose items of one name differ in
    size, as copies of several blobs do, where a median would stand for
    one of them). None where the trace holds no such item."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):      # a trace that came back empty is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if reset is not None:
                    reset()
                fn()
            torch.cuda.synchronize()
        per = device_durations(prof, names)
        if per:
            break
    if not per:
        return None
    if whole:
        return sum(sum(d) for d in per.values()) / reps / 1e3
    return sum(statistics.median(d) * len(d) / reps
               for d in per.values()) / 1e3


def batch_ms(torch, new, old) -> tuple:
    """Milliseconds a launch of ``new`` (and ``old``) over BATCH launches
    back to back between two CUDA events, medians of turns (old, new, new,
    old, three batches a turn): the events' own floor spread over the
    batch. The state is not restored between the launches."""
    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BATCH):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / BATCH

    runs = {"new": [], "old": []}
    for fn in (new, old):
        if fn is not None:
            timed(fn)
    for tag in ("old", "new", "new", "old") if old else ("new", "new"):
        runs[tag] += [timed(new if tag == "new" else old) for _ in range(3)]
    return (statistics.median(runs["new"]),
            statistics.median(runs["old"]) if old else None)


def launch_floor(torch) -> str:
    """The floor of one launch as CUDA events read it here: a one-element
    torch add alone between two events, and over BATCH back to back."""
    x = torch.zeros(1, device="cuda")
    one = cuda_ms(torch, lambda: x.add_(1))
    many, _ = batch_ms(torch, lambda: x.add_(1), None)
    return (f"one tiny torch op {one:.5f} ms between two events, "
            f"{many:.5f} ms a launch over {BATCH} back to back")


def host_us(torch, fn, reset, reps: int = 30) -> float:
    """Median host microseconds of one Python call of ``fn`` (the
    wrapper: checks, arguments, the launch's enqueue), with ``reset()``
    and a synchronize before each call, outside the span."""
    times = []
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def previous_commit(prev_ka, rin, choice, win_now, prog):
    """The previous design's K2b launch of round 0, its C struct built as
    its wrapper (kernels/auction.py _commit_kernel of the parent commit)
    built it every round, here once, so its launch can be timed alone."""
    import ctypes

    from kubernetes_tpu_torch.kernels import build as KB

    a = prev_ka._CommitArgs()
    a.N, a.B, a.R = rin.n, rin.b, rin.req.shape[1]
    a.multi_accept = int(rin.k_accept is not None)
    for name in ("nom", "req", "nzreq", "nominated_row", "free", "nzr",
                 "placed", "win"):
        setattr(a, name, getattr(rin, name).data_ptr())
    a.choice, a.win_now = choice.data_ptr(), win_now.data_ptr()
    a.k_accept = (rin.k_accept.data_ptr() if rin.k_accept is not None
                  else None)
    a.prog_in, a.prog_out = prog.data_ptr(), prog.data_ptr() + 4
    lib = prev_ka.KB.library("auction_accept_commit")
    stream = KB.stream_handle()
    return lambda: KB.check("auction_accept_commit",
                            lib.auction_accept_commit_launch(
                                ctypes.byref(a), stream))


def time_k2b(torch, key, rin, choice, win_now, prog) -> tuple:
    """K2b's round 0 at these bids (rin unplaced), device-only: CUDA events
    around the prebuilt launch alone, free/nzr/placed/win restored before
    every run outside the timed span, in turns with the previous design's
    launch (old, new, new, old); the wrappers' host us a round; the twin's
    ms; each design's device duration from a profiler trace. Records
    SPLIT[key] and TRACE[key]; returns ((ms, twin ms), accepted
    pods)."""
    from kubernetes_tpu_torch.kernels import auction as KA

    snap = [t.clone() for t in (rin.free, rin.nzr, rin.placed, rin.win)]

    def restore():
        for t, v in zip((rin.free, rin.nzr, rin.placed, rin.win), snap):
            t.copy_(v)
        prog.copy_(torch.tensor([1, 0], dtype=torch.int32))

    launch = KA.CommitLaunch(rin, choice, win_now, prog)
    prev = (previous_design() if previous_changed("auction_accept_commit")
            else None)
    old = previous_commit(prev[1], rin, choice, win_now, prog) \
        if prev else None
    ms, ms_old = in_turns(torch, lambda: launch.run(0), old, 10,
                          reset=restore)
    us = host_us(torch, lambda: KA.auction_accept_commit(
        rin, choice, win_now, prog, 0, launch=launch), restore)
    us_old = host_us(torch, lambda: prev[1]._commit_kernel(
        rin, choice, win_now, prog, 0), restore) if prev else None
    twin_ms, _ = in_turns(torch, lambda: KA.auction_accept_commit_ref(
        rin, choice, win_now, prog, 0), None, 2, reset=restore)
    TRACE[key] = (trace_ms(torch, lambda: launch.run(0), 20, restore,
                           ("auction_commit",)),
                  trace_ms(torch, old, 20, restore, ("auction_commit",))
                  if old else None)
    restore()
    b_ms, b_old = batch_ms(torch, lambda: launch.run(0), old)
    restore()
    idle = KA.CommitLaunch(rin, choice, win_now, torch.zeros_like(prog))
    noop = cuda_ms(torch, lambda: idle.run(0))
    launch.run(0)
    accepted = int((rin.placed >= 0).sum())
    restore()
    SPLIT[key] = (ms, ms_old, us, us_old, b_ms, b_old, noop)
    return (ms, twin_ms), accepted


def time_k4(torch, key, soft, placed) -> tuple:
    """One K4 round at the placed set ``placed``, device-only: from empty
    maps (every placed pod new: the round after a bulk accept; maps and
    seen reset outside the timed span) in turns with the previous design
    (two memsets, scatter, gather), and again with nothing moved (a later
    round); each against the twin's outputs, exactly; the wrappers' host
    us a round; the twin's ms; each design's device duration from empty
    maps from a profiler trace. Records SPLIT[key] (the first reading)
    and TRACE[key]; returns ((ms, twin ms), steady ms)."""
    from kubernetes_tpu_torch.kernels import soft as KSoft

    dev = placed.device
    prog = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    sout = KSoft.soft_out(soft)
    launch = KSoft.prepare_launch(soft, placed, prog, sout)

    def fresh():
        sout.maps.zero_()
        sout.tmap.zero_()
        sout.seen.fill_(-1)

    prev = previous_design() if previous_changed("soft_scores") else None
    old = old_wrapper = None
    if prev:
        pout = KSoft.soft_out(soft)
        plaunch = prev[4].prepare_launch(soft, placed, prog, 0, pout)

        def old():
            pout.maps.zero_()
            pout.tmap.zero_()
            plaunch.run("soft_scatter")
            plaunch.run("soft_gather")

        def old_wrapper():
            prev[4].soft_scores(soft, placed, prog, 0, pout)

    ms, ms_old = in_turns(torch, lambda: launch.run(0), old, 10,
                          reset=fresh)
    fresh()                 # in_turns ends with the previous design's runs
    launch.run(0)
    want = KSoft.soft_out(soft)
    KSoft.soft_scores_ref(soft, placed, prog, 0, want)
    for f in ("maps", "tmap", "ipa_live", "sp_r"):
        cmp_exact(f"{key} K4 {f}", getattr(sout, f), getattr(want, f))
    steady, _ = in_turns(torch, lambda: launch.run(0), None, 10)
    cmp_exact(f"{key} K4 steady ipa_live", sout.ipa_live, want.ipa_live)
    us = host_us(torch, lambda: KSoft.soft_scores(
        soft, placed, prog, 0, sout, launch=launch), lambda: None)
    us_old = host_us(torch, old_wrapper, lambda: None) if prev else None
    twin_ms = cuda_ms(torch, lambda: KSoft.soft_scores_ref(
        soft, placed, prog, 0, want), reps=5, warm=1)
    # back to back: nothing moves after the first (a later round); the
    # previous design redoes its whole round each time
    b_ms, b_old = batch_ms(torch, lambda: launch.run(0), old)
    idle = KSoft.prepare_launch(soft, placed, torch.zeros_like(prog), sout)
    noop = cuda_ms(torch, lambda: idle.run(0))
    SPLIT[key] = (ms, ms_old, us, us_old, b_ms, b_old, noop)
    # the previous round (memsets included) launches nothing else, so its
    # trace counts every device item
    TRACE[key] = (trace_ms(torch, lambda: launch.run(0), 20, fresh,
                           ("soft_scores_kernel",)),
                  trace_ms(torch, old, 20) if prev else None)
    return (ms, twin_ms), steady


def plan_text(rin=None, soft=None) -> str:
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import soft as KSoft

    out = []
    if rin is not None:
        import torch

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        p = KA.plan_commit(rin.n, rin.b, rin.k_accept is not None, sms)
        out.append(f"K2b {p.blocks} blocks of {p.slice} nodes, "
                   f"{p.smem_bytes} B of shared memory a block, lists "
                   f"{'shared' if p.list_shared else 'global'}")
    if soft is not None:
        g, n = soft.ipa_ok_g.shape
        p = KSoft.plan_soft(g, n, soft.paff_tk_g.shape[1],
                            soft.tsc_tk_g.shape[1], soft.d_cap)
        out.append(f"K4 {p.items} gather items, {p.smem_bytes} B of "
                   f"shared memory a block, maps "
                   f"{'shared' if p.maps_shared else 'global'}")
    return "; ".join(out)


def time_soft_launch(torch, held, path) -> tuple:
    """CUDA-event medians of K4 (end-state placed set: every pod the
    launch placed), K2a in soft mode and K2b (the first round; K2a in
    turns with the previous design and its launch shape; K2b and K4
    device-only, in turns with theirs), and the twins' times; the work of
    each at those inputs. Returns (times, work, detail, K2a's previous
    ms)."""
    from kubernetes_tpu_torch.kernels import auction as KA

    log, out = held["log"], held["out"]
    soft = log["view"][0]
    rin = log["rin0"]
    dev = rin.free.device
    prog = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    placed = out.node_row.clone()
    times = {}
    times["soft_scores"], k4_steady = time_k4(
        torch, f"soft_scores@{path}", soft, placed)
    prev = previous_design()
    bid_ms, bid_prev = in_turns(
        torch, lambda: KA.auction_score_argmax(rin, prog, 0),
        (lambda: prev[1]._bid_kernel(rin, prog, 0)) if prev else None, 10)
    times["auction_score_argmax"] = (
        bid_ms,
        cuda_ms(torch, lambda: KA.auction_score_argmax_ref(rin, prog, 0),
                reps=5, warm=1))
    choice, win_now = KA.auction_score_argmax(rin, prog, 0)
    times["auction_accept_commit"], accepted = time_k2b(
        torch, f"auction_accept_commit@{path}", rin, choice, win_now, prog)
    bidders = int(((rin.placed < 0) & (rin.static_ok[rin.gid.long()]
                                       .any(dim=1))).sum())
    work = {**k4_work(soft, placed), **auction_work(rin, bidders, accepted)}
    detail = (f"G={soft.ipa_ok_g.shape[0]}, B={rin.b}, N={rin.n}, "
              f"D={soft.d_cap}, {int((placed >= 0).sum())} placed, "
              f"{accepted} accepted in round 0; K4 with nothing moved "
              f"{k4_steady:.5f} ms; {plan_text(rin, soft)}; "
              f"K2a soft "
              f"{previous_text(bid_ms, bid_prev)}; {k2a_shape(rin)}")
    return times, work, detail, bid_prev


# K4 shapes whose shared memory passes the default 48 KB by different
# amounts, maps shared: (B, G, N, A, C, D, TK)
SMEM_PLANS = ((1024, 40, 2048, 8, 8, 8, 4), (1024, 36, 2048, 8, 8, 8, 4))


def soft_statics_fuzz(torch, seed, b, g, n, a, c, d, tk, dev):
    """Seeded soft statics (kernels/soft.py SoftTopo) of this shape, with
    keys and domains sometimes absent (NONE, -1); weights and counts are
    small integers, so sums in any order are exact."""
    from kubernetes_tpu_torch.kernels import soft as KSoft

    gen = torch.Generator().manual_seed(seed)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32)

    def bits(p, *shape):
        return torch.rand(shape, generator=gen) < p

    def keys(*shape):
        return torch.where(bits(0.9, *shape), ints(0, tk, *shape),
                           torch.full(shape, -1, dtype=torch.int32))

    soft = KSoft.SoftTopo(
        gid=ints(0, g, b), valid=bits(0.95, b),
        ipa_ok_g=torch.ones(g, n, dtype=torch.bool),
        ipa_raw_g=torch.rand(g, n, generator=gen) * 10,
        match_static_g=ints(0, 20, g, n, c).float(),
        tpw_g=torch.log(ints(1, 9, g, c).float() + 2),
        used_soft_g=bits(0.7, g, c), dom_ok_g=bits(0.9, g, n, c),
        ign_g=bits(0.05, g, n), has_soft_g=torch.ones(g, dtype=torch.bool),
        skew_g=ints(1, 4, g, c).float(), el_node_g=bits(0.8, g, n, c),
        paff_tk_g=keys(g, a), panti_tk_g=keys(g, a), tsc_tk_g=keys(g, c),
        paff_w_g=ints(1, 10, g, a).float(),
        panti_w_g=ints(1, 10, g, a).float(),
        M_paff_gg=bits(0.3, g, a, g), M_panti_gg=bits(0.3, g, a, g),
        M_tsc_gg=bits(0.3, g, c, g), topo_dom=ints(-1, d, n, tk), d_cap=d)
    return KSoft.SoftTopo(*(t.to(dev).contiguous()
                            if isinstance(t, torch.Tensor) else t
                            for t in soft))


def hold_soft_plans(torch) -> str:
    """K4 at SMEM_PLANS' two plans (both past 48 KB of shared memory, of
    different sizes), launched in turns A, B, A, B, each on a new placed
    set, every output against the twin exactly: each launch must raise
    the kernel's shared-memory limit that the other's lowered."""
    from kubernetes_tpu_torch.kernels import soft as KSoft

    dev = torch.device("cuda")
    prog = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    plans = []
    for i, (b, g, n, a, c, d, tk) in enumerate(SMEM_PLANS):
        soft = soft_statics_fuzz(torch, 40 + i, b, g, n, a, c, d, tk, dev)
        placed = torch.full((b,), -1, dtype=torch.int32, device=dev)
        out = KSoft.soft_out(soft)
        launch = KSoft.prepare_launch(soft, placed, prog, out)
        plans.append((soft, placed, out, launch))
    sizes = [p[3].plan.smem_bytes for p in plans]
    if not (min(sizes) > 48 * 1024 and sizes[0] != sizes[1]
            and all(p[3].plan.maps_shared for p in plans)):
        raise AssertionError(f"[10b] K4 plans {sizes} B: not two shared "
                             "plans past 48 KB of different sizes")
    gen = torch.Generator().manual_seed(44)
    for turn, i in enumerate((0, 1, 0, 1)):
        soft, placed, out, launch = plans[i]
        n = soft.topo_dom.shape[0]
        placed.copy_(torch.randint(-1, n, placed.shape, generator=gen,
                                   dtype=torch.int32))
        launch.run(0)
        want = KSoft.soft_out(soft)
        KSoft.soft_scores_ref(soft, placed, prog, 0, want)
        for f in ("maps", "tmap", "ipa_live", "sp_r"):
            cmp_exact(f"[10b] K4 plan {'AB'[i]} turn {turn} {f}",
                      getattr(out, f), getattr(want, f))
    return (f"[10b] K4 at two plans past 48 KB ({sizes[0]} and {sizes[1]} B "
            f"of shared memory a block, maps shared), in turns A, B, A, B on "
            f"new placed sets: every output == twin exactly")


def hold_accept_cases(torch, errs) -> str:
    """K2b's edge-case launches (perf.fuzz.accept_cases, the launches
    tests/test_torch_accept.py holds against the JAX package on the CPU)
    whole through the kernels and through the twins on the card, every
    BatchResult field exact; the two-hot-nodes launch once more with its
    K-accept lists in the global scratch (kernels/auction.py LIST_SMEM_MAX
    set to 0 for it), counted under auction_accept_commit_global, exact
    too."""
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.models import pipeline as P
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf.fuzz import accept_cases

    dev = torch.device("cuda")
    lines = []
    for name, (nodes, pods, nominated, node_cap, batch) in \
            accept_cases().items():
        caps = Capacities(nodes=node_cap, pods=256)
        mirror = synced_mirror(torch, nodes, [], caps)
        if nominated:
            mirror.set_nominated(nominated)
        spec = mirror.prepare_launch(pods, batch)
        args = (spec, mirror.well_known(), P.default_weights(), caps)
        runs = [("", KA.LIST_SMEM_MAX)]
        if name == "two_hot_nodes":
            runs.append((" with global lists", 0))
        for label, cap in runs:
            saved, KA.LIST_SMEM_MAX = KA.LIST_SMEM_MAX, cap
            g0 = KB.LAUNCHES["auction_accept_commit_global"]
            try:
                out = P.launch_batch(*args, serial_scan=False, tie_seed=7,
                                     device=dev)
                torch.cuda.synchronize()
            finally:
                KA.LIST_SMEM_MAX = saved
            n_global = KB.LAUNCHES["auction_accept_commit_global"] - g0
            with twins():
                ref = P.launch_batch(*args, serial_scan=False, tie_seed=7,
                                     device=dev)
            torch.cuda.synchronize()
            for f in ("node_row", "score", "feasible_count",
                      "reject_counts", "unresolvable_count", "free", "nzr",
                      "guard"):
                a, b = getattr(out, f), getattr(ref, f)
                errs["auction_accept_commit"] = max(
                    errs["auction_accept_commit"], max_err(a, b))
                cmp_exact(f"[4b] {name}{label} {f}", a, b)
            if cap == 0 and n_global < 1:
                raise AssertionError(f"[4b] {name}{label}: no launch "
                                     "counted under the global lists")
            placed = int((out.node_row >= 0).sum())
            lines.append(f"{name}{label} {placed}/{len(pods)} placed in "
                         f"{out.round_trips} flag round trip(s), "
                         f"global-list launches {n_global}")
    return ("[4b] K2b's edge-case launches == twins exactly (hot node B<=N "
            "with a nomination, two hot nodes B>N rejecting mid-list, no "
            "bids): " + "; ".join(lines))


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


def stubbed_host_us(torch, mod, args, kw, reps: int = 30,
                    name: str = "preempt_feasible") -> tuple:
    """Host us of one call of ``mod.preempt_feasible`` (or of ``name``,
    ``preempt_sweep``: this design's kernels/preempt.py or
    build/previous's) at these inputs with K1 and K5 stubbed to their
    outputs, so only K6's own wrapper (K6b: the masked table's copy, its
    checks and arguments, the launch's enqueue; K6a: its arguments and
    the launch's enqueue) is timed: (median with a synchronize before each
    call, mean of ``reps`` calls back to back, where a call that reads the
    device waits for the work queued before it)."""
    from kubernetes_tpu_torch.kernels import topology as KT

    real_p1, real_k5 = mod.phase1_static, KT.topo_statics
    got = {}

    def p1(*a, **k):
        if "p1" not in got:
            got["p1"] = real_p1(*a, **k)
        return got["p1"]

    def k5(*a, **k):
        if "k5" not in got:
            got["k5"] = real_k5(*a, **k)
        return got["k5"]

    mod.phase1_static, KT.topo_statics = p1, k5
    try:
        def call():
            return getattr(mod, name)(*args, **kw)

        call()
        synced = host_us(torch, call, lambda: None, reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        b2b = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    finally:
        mod.phase1_static, KT.topo_statics = real_p1, real_k5
    return synced, b2b


def wall_turns(torch, new, old, reps: int = 10) -> tuple:
    """Median host ms of ``new()`` and ``old()`` (each ending with its
    result on the host) run in turns (old, new, new, old; ``reps`` runs a
    turn); old None without ``old``."""
    runs = {"new": [], "old": []}
    for fn in (new, old):
        if fn is not None:
            fn()
    for tag in ("old", "new", "new", "old") if old else ("new", "new"):
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (new if tag == "new" else old)()
            runs[tag].append((time.perf_counter() - t0) * 1e3)
    return (statistics.median(runs["new"]),
            statistics.median(runs["old"]) if old else None)


def regs_of(name: str, entry: str, src: str | None = None):
    """ptxas's registers of the first __global__ entry of a built source
    whose name holds ``entry`` (this design's build, or the one from
    ``src``), None without a report."""
    from kubernetes_tpu_torch.kernels import build as KB

    rep = KB.build_log(name) if src is None else KB.build_log(name, src)
    return next((v["registers"] for fn, v in sorted(rep.items())
                 if entry in fn and "registers" in v), None)


def sweep_shape(launch, prev: bool = False) -> str:
    """K6a's grid at a launch's inputs: CTAs, threads and shared bytes a
    CTA, registers, CTAs an SM can hold. The previous design: one thread
    a (pod, node) in CTAs of 256, no shared memory."""
    a = launch.args
    if prev:
        regs = regs_of("preempt_sweep", "preempt_sweep",
                       os.path.join(PREVIOUS_DIR, "csrc"))
        ctas, threads, smem = -(-a.P * a.N // 256), 256, 0
        lanes = ""
    else:
        regs = regs_of("preempt_sweep", "preempt_sweep")
        plan = launch.plan
        ctas, threads, smem = plan.ctas(a.P), 256, plan.smem
        lanes = f", {plan.lanes} lanes a node, {plan.nodes} nodes a CTA"
    an_sm = resident_ctas(regs, threads, smem) if regs else None
    return (f"{ctas} CTAs of {threads} threads ({ctas / 132:.2f} a SM of "
            f"132){lanes}, {smem} B shared, {regs} registers, {an_sm} CTAs "
            "an SM can hold")


# K6a's measurement builds: the same grid with no work (-DSWEEP_EMPTY) and
# each warp's start, barrier and end stamped (-DSWEEP_PROFILE); each runs
# once a hold, not in turns
SWEEP_BUILDS = (("SWEEP_EMPTY",), ("SWEEP_PROFILE",))


def sweep_entry(defines: tuple, args_type):
    """A K6a measurement build's library and launch entry (ctypes)."""
    import ctypes

    from kubernetes_tpu_torch.kernels import build as KB

    lib = KB.build_variant("preempt_sweep", defines)
    fn = lib.preempt_sweep_launch
    fn.argtypes = [ctypes.POINTER(args_type), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def sweep_floor(torch, launch) -> str:
    """What holds K6a back at one launch's arguments: the grid alone (the
    -DSWEEP_EMPTY build, traced once) and each warp's stamps (the
    -DSWEEP_PROFILE build, one launch: sweep_profile)."""
    import ctypes

    from kubernetes_tpu_torch.kernels import build as KB

    a = launch.args
    _, fn = sweep_entry(("SWEEP_EMPTY",), type(a))

    def run():
        KB.check("preempt_sweep", fn(ctypes.byref(a), KB.stream_handle()))

    run()
    empty = trace_ms(torch, run, 20, names=("preempt_sweep",))
    return (f"the grid alone (-DSWEEP_EMPTY) traced {opt_ms(empty)} ms; "
            f"warps by %globaltimer (-DSWEEP_PROFILE): "
            + sweep_profile(torch, launch))


def sweep_profile(torch, launch) -> str:
    """One launch of the -DSWEEP_PROFILE build at a launch's arguments: the
    span from the first warp's start to the last one's end, the warps'
    starts after the first (median, 90th percentile, last), their
    durations (median, most) and the SMs that ran them."""
    import ctypes

    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import preempt as KP

    a, plan = launch.args, launch.plan
    warps = min(plan.ctas(a.P) * (KP.SWEEP_THREADS // 32), 16384)
    lib, fn = sweep_entry(("SWEEP_PROFILE",), type(a))
    read = lib.sweep_read_profile
    read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    t = np.zeros((warps, 3), np.uint64)
    sm = np.zeros((warps,), np.uint32)
    for _ in range(3):              # warm, then the last launch read
        KB.check("preempt_sweep", fn(ctypes.byref(a), KB.stream_handle()))
        torch.cuda.synchronize()
        KB.check("preempt_sweep", read(t.ctypes.data, sm.ctypes.data,
                                       warps))
    t0, tb, t1 = (t[:, i].astype(np.int64) for i in range(3))
    start = t0 - t0.min()
    dur = t1 - t0
    # warps that reached the barrier: start to barrier (the one round of
    # loads and the staging), barrier to end (votes, prefixes, store)
    hit = tb > 0
    to_b, from_b = (tb - t0)[hit], (t1 - tb)[hit]
    return (f"{warps} warps on {len(set(sm.tolist()))} SMs, span "
            f"{(t1.max() - t0.min()) / 1e3:.3f} us, starts "
            f"after the first {np.median(start) / 1e3:.3f} / "
            f"{np.percentile(start, 90) / 1e3:.3f} / {start.max() / 1e3:.3f}"
            f" us, durations {np.median(dur) / 1e3:.3f} / "
            f"{dur.max() / 1e3:.3f} us, of which start to the CTA's barrier "
            f"{np.median(to_b) / 1e3:.3f} / {to_b.max() / 1e3:.3f} us and "
            f"the barrier to the end {np.median(from_b) / 1e3:.3f} / "
            f"{from_b.max() / 1e3:.3f} us (median / most)")


def sweep_turns(torch, KP, args, kw) -> dict:
    """K6a at one captured call by design, in turns with build/previous's
    where it holds it: the sweep's launch traced, the wrapper's host us
    with K1 stubbed (stubbed_host_us) and the whole chain (K1, the sweep,
    the [P, N] verdicts pulled to the host), its host wall; each design's
    grid and ptxas. Returns the line's text and the kernels-line entry's
    fields."""
    prev = (previous_design() if previous_changed("preempt_sweep")
            else None)
    prev_kp = prev[10] if prev else None
    names = ("preempt_sweep",)
    new_l = KP.prepare_sweep(*args, **kw)
    old_l = prev_kp.prepare_sweep(*args, **kw) if prev_kp else None
    keep: list = []
    tr = traced_turns(torch, new_l.run, old_l.run if old_l else None, 20,
                      names, names, rounds=3, keep=keep)
    hu = stubbed_host_us(torch, KP, args, kw, name="preempt_sweep")
    hu_old = (stubbed_host_us(torch, prev_kp, args, kw, name="preempt_sweep")
              if prev_kp else (None, None))
    chain = wall_turns(
        torch, lambda: KP.preempt_sweep(*args, **kw).cpu(),
        (lambda: prev_kp.preempt_sweep(*args, **kw).cpu())
        if prev_kp else None)
    floor = sweep_floor(torch, new_l)
    nb, ops = sweep_work(new_l)
    bound = max(nb / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    text = (f"traced {opt_ms(tr[0])} ms (previous design {opt_ms(tr[1])}),"
            f" bound {bound:.6f} (traces {spread_text(keep)}); {floor}; "
            f"the wrapper with K1 stubbed {hu[0]:.1f} host us synced, "
            f"{hu[1]:.1f} back to back "
            f"(previous {opt_ms(hu_old[0])} / {opt_ms(hu_old[1])}); the "
            f"whole chain with the pull {chain[0]:.3f} host ms (previous "
            f"{opt_ms(chain[1])}); this design {sweep_shape(new_l)}; "
            f"ptxas {ptxas_text('preempt_sweep', 'preempt_sweep')}; the "
            f"previous design "
            + (f"{sweep_shape(old_l, True)}; ptxas "
               f"{previous_ptxas('preempt_sweep', 'preempt_sweep')}"
               if old_l else "absent from this call"))
    return {"trace": tr, "text": text,
            "entry": {"trace_ms_previous": tr[1], "host_us": hu[0],
                      "host_us_previous": hu_old[0], "host_us_b2b": hu[1],
                      "host_us_b2b_previous": hu_old[1],
                      "chain_ms": chain[0], "chain_ms_previous": chain[1],
                      "ctas": new_l.plan.ctas(new_l.args.P)}}


def fold_turns(torch, KP, cap, dry_ms, dry_ms_prev) -> dict:
    """K6b at Path B's captured calls (its first dry run, and the spread
    preemptor's first) by design, in turns with build/previous's where it
    holds it: K6b's launches of one dry run traced (summed), the wrapper's
    host us with K1 and K5 stubbed (stubbed_host_us) and a whole wrapper
    chain (K1, K5, K6b) with its [N] verdicts pulled to the host, its host
    wall; ``dry_ms`` / ``dry_ms_prev``: Path B's median _dryrun_feasible
    under each design. Returns the line's text and the kernels-line
    entry's fields."""
    prev = (previous_design() if previous_changed("preempt_feasible")
            else None)
    prev_kp = prev[10] if prev else None
    names = ("feasible_fold", "feasible_min")
    res, parts = {}, []

    for tag, (args, kw) in (("plain", cap["feasible"][0]),
                            ("spread", cap["spread"][0])):
        new_l = KP.prepare_feasible(*args, **kw)
        old_l = prev_kp.prepare_feasible(*args, **kw) if prev_kp else None
        tr = traced_turns(torch, new_l.run, old_l.run if old_l else None,
                          20, names, names)
        hu = stubbed_host_us(torch, KP, args, kw)
        hu_old = (stubbed_host_us(torch, prev_kp, args, kw) if prev_kp
                  else (None, None))
        chain = wall_turns(
            torch, lambda: KP.preempt_feasible(*args, **kw).cpu(),
            (lambda: prev_kp.preempt_feasible(*args, **kw).cpu())
            if prev_kp else None)
        res[tag] = (tr[0], tr[1], hu, hu_old, chain)
        nb, ops = fold_work(new_l)
        if tag == "spread":
            mb, mo = min_work(new_l)
            nb, ops = nb + mb, ops + mo
        bound = max(nb / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        parts.append(
            f"{tag} call: traced {opt_ms(tr[0])} ms (previous design "
            f"{opt_ms(tr[1])}), bound {bound:.6f}; the wrapper with K1 "
            f"and K5 stubbed {hu[0]:.1f} host us synced, {hu[1]:.1f} back "
            f"to back (previous {opt_ms(hu_old[0])} / {opt_ms(hu_old[1])})"
            f"; the whole chain with the pull {chain[0]:.3f} host ms "
            f"(previous {opt_ms(chain[1])})")
    p, sp = res["plain"], res["spread"]
    return {
        "plain": p,
        "text": "; ".join(parts) + f"; Path B's _dryrun_feasible median "
                f"{dry_ms:.3f} host ms (the previous design's run "
                f"{opt_ms(dry_ms_prev)})",
        "entry": {"trace_ms_previous": p[1], "trace_ms_spread": sp[0],
                  "trace_ms_spread_previous": sp[1], "host_us": p[2][0],
                  "host_us_previous": p[3][0], "host_us_b2b": p[2][1],
                  "host_us_b2b_previous": p[3][1],
                  "chain_ms": p[4][0], "chain_ms_previous": p[4][1],
                  "dryrun_ms": dry_ms, "dryrun_ms_previous": dry_ms_prev}}


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
            if ext == 70 and p == 1:
                wide = (cblobs, pblobs, wk, cumsum, cols, caps)
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
    # the R = 74 case (P = 1, the snapshot's free) by design, in turns
    turns = sweep_turns(torch, KP, wide, {})
    return ("K6a preempt_sweep == twin (K1 + sweep, every kmin exact) at "
            "N=8192 over 5000 fuzz nodes, P=1 and 64, with and without "
            "the live-free override: " + "; ".join(notes)
            + f"; inactive-column case (cols {cols.tolist()}): NONE "
            "everywhere; K6a at R=74, P=1 (K+1="
            f"{wide[3].shape[1]}, C={wide[3].shape[2]}): {turns['text']}")


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
    # the zone-spread preemptors' dry runs (every lower-priority pod
    # masked, D = 8 and 8,192), K6b's launches traced in turns with the
    # previous design where build/previous holds it
    prev = (previous_design() if previous_changed("preempt_feasible")
            else None)
    names = ("feasible_fold", "feasible_min")
    tv = torch.tensor(masks[0][1], device="cuda")
    fr = torch.tensor(masks[0][2], device="cuda")
    turns = []
    for pre in preemptors[:2]:
        pblobs = mirror.pack_batch_blobs([pre], 1)
        for d in (8, 8192):
            args = (cblobs, pblobs, wk, caps, tv, fr, True, d)
            new_l = KP.prepare_feasible(*args)
            old_l = prev[10].prepare_feasible(*args) if prev else None
            ms, ms_old = traced_turns(torch, new_l.run,
                                      old_l.run if old_l else None, 20,
                                      names, names)
            turns.append(f"{pre.metadata.name} D={d} {opt_ms(ms)} "
                         f"(previous {opt_ms(ms_old)})")
    # the same cluster at R = 74 (70 extended-resource columns): the zone
    # spread preemptor's dry run held against the twin and traced in turns
    # with the previous design, at both widths
    caps74 = Capacities(nodes=8192, pods=16384, ext_resources=70)
    mirror74, _ = synced_state(torch, nodes, bound, caps74, namespaces)
    widths = []
    for tag, (mir, cps) in (("R=8", (mirror, caps)),
                            ("R=74", (mirror74, caps74))):
        a74 = (mir.to_blobs(), mir.pack_batch_blobs([preemptors[0]], 1),
               mir.well_known(), cps,
               torch.tensor(mir.table_valid_mask(()), device="cuda"),
               torch.tensor(mir.free_matrix(), device="cuda"), True, 8)
        cmp_exact(f"[12b] K6b {tag}", KP.preempt_feasible(*a74),
                  KP.preempt_feasible_ref(*a74))
        old_l = prev[10].prepare_feasible(*a74) if prev else None
        ms, ms_old = traced_turns(torch, KP.prepare_feasible(*a74).run,
                                  old_l.run if old_l else None, 20, names,
                                  names)
        widths.append(f"{tag} {opt_ms(ms)} (previous {opt_ms(ms_old)})")
    return (f"K6b preempt_feasible (K1 -> K5 on the masked table -> fold) "
            f"== twin on {len(feasible)} dry runs ({len(preemptors)} "
            "preemptors x 3 masks x topology on D=8 / D=8192 / off) over "
            f"5000 nodes (bucket 8192), PT=16384: feasible-node counts "
            f"range [{min(feasible)}, {max(feasible)}], "
            f"{sum(1 for f in feasible if f < 5000)} runs with some node "
            f"rejected; K6b's launches of a dry run traced, ms, in turns "
            f"with the previous design: {'; '.join(turns)}; the spread "
            f"preemptor's dry run (no victim masked, D=8), traced ms in "
            f"turns with the previous design: {'; '.join(widths)}")


def postfilter_path(torch, card, errs) -> tuple:
    """13b: the full PostFilter path at full width (Path B), K6a and K6b
    held against their twins on its captured calls and timed at its
    inputs, K5 at a dry run's masked table. Returns the kernels-line
    entries, the first dry run's K1 inputs and K1's launches on the
    path."""
    from kubernetes_tpu_torch.kernels import topology as KT
    from kubernetes_tpu_torch.ops.features import (
        PodBlobs,
        unpack_cluster,
        unpack_pods,
    )

    from kubernetes_tpu_torch.kernels import preempt as KP

    cap = {}
    pb = path_b(torch, 5000, 8192, 128, "cuda", capture=cap)
    detail = check_path_b(pb)
    pb_launches = pb["launches"]
    missing = [k for k in ("phase1_static", KT.COUNTER, "serial_scan",
                           "preempt_sweep", "preempt_feasible")
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
    # the spread minimum the launch took, against its twin, on the spread
    # call
    m_args, m_kw = cap["spread"][0]
    m_launch = KP.prepare_feasible(*m_args, **m_kw)
    mt = m_launch.tensors
    used = (mt["tsc_tk"] != -1) & mt["tsc_hard"]
    if not bool(used.any()):
        raise AssertionError("[13b] the spread preemptor's fold has no "
                             "DoNotSchedule constraint")
    m_launch.run()
    torch.cuda.synchronize()
    min_want = KP.feasible_min_ref(mt["cnt"], mt["exists_hard"],
                                   mt["min_domains"])
    cmp_exact("[13b] the spread minimum", mt["min_cnt"][used],
              min_want[used])
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
    k1_dry = cap["k1"]
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
            cuda_ms(torch, f_launch.run),
            cuda_ms(torch, lambda: KP.preempt_feasible_ref(*f_args, **f_kw),
                    reps=5))}
    chain_ms = {
        "preempt_sweep": cuda_ms(
            torch, lambda: KP.preempt_sweep(*s_args, **s_kw)),
        "preempt_feasible": cuda_ms(
            torch, lambda: KP.preempt_feasible(*f_args, **f_kw))}
    # K6a at Path B's first call by design, and find_candidates' host ms a
    # preemptor over the path, with the previous K6a where build/previous
    # holds it (the path again, its K6b this design's)
    k6a = sweep_turns(torch, KP, s_args, s_kw)
    B0["preempt_sweep@PostFilterPath"] = k6a["trace"][0]
    find_ms = statistics.median(cap["find_s"]) * 1e3
    find_prev = None
    prev_s = (previous_design() if previous_changed("preempt_sweep")
              else None)
    find_text = f"this run {find_ms:.3f}"
    if prev_s:
        find_ms, find_prev, find_text = find_turns(
            torch, prev_s[10].preempt_sweep, find_ms)
    log(f"[13b] K6a at Path B's first call (N={s_args[0].node_f32.shape[0]}"
        f", P=1, K+1={s_args[3].shape[1]}, C={s_args[3].shape[2]}): "
        f"{k6a['text']}; find_candidates' host ms a call, median over "
        f"{len(cap['find_s'])} a run: {find_text}")
    dry_prev = None
    prev = (previous_design() if previous_changed("preempt_feasible")
            else None)
    if prev:
        # the same path with the previous design's K6b, its dry runs' wall
        cap_old = {}
        path_b(torch, 5000, 8192, 128, "cuda", capture=cap_old,
               feasible=prev[10].preempt_feasible, count=False)
        dry_prev = statistics.median(cap_old["dryrun_s"]) * 1e3
    k6b = fold_turns(torch, KP, cap, dry_ms, dry_prev)
    B0["preempt_feasible@PostFilterPath"] = k6b["plain"][0]
    k6_work = {"preempt_sweep": sweep_work(s_launch),
               "preempt_feasible": fold_work(f_launch)}
    log(f"[13b] K6 at Path B's inputs (N={s_args[0].node_f32.shape[0]}, "
        f"P=1, K+1="
        f"{s_args[3].shape[1]}, C={s_args[3].shape[2]}, D={f_args[7]}): "
        + ", ".join(f"{k} kernel {v[0]:.5f} ms (traced "
                    f"{opt_ms(B0[k + '@PostFilterPath'])}; twin "
                    f"{v[1]:.3f}), whole "
                    f"wrapper chain {chain_ms[k]:.5f} ms, this data's work "
                    f"{k6_work[k][0]} B / {k6_work[k][1]} operations"
                    for k, v in k6_times.items())
        + f"; K6b by design: {k6b['text']}")
    k6_entries = [
        kernel_entry(f"{name}@PostFilterPath", name,
                     "PostFilter path (5000 nodes, 128 preemptors)",
                     pb_launches[name], 0.0, k6_times[name], k6_work[name])
        for name in ("preempt_sweep", "preempt_feasible")]
    k6_entries[0].update(k6a["entry"])
    k6_entries[0].update(find_ms=find_ms, find_ms_previous=find_prev)
    k6_entries[1].update(k6b["entry"])
    # K5 at a dry run's masked table (G = 1): held against its twins and
    # timed as 8c times it
    k5_args = cap["k5"]
    k5_got, k5_want = KT.topo_statics(*k5_args), KT.topo_statics_ref(*k5_args)
    torch.cuda.synchronize()
    for stage, part in zip(KT.STAGES, ("maps", "nodes", "pairs")):
        cmp_fields(errs, f"[13b] K5 {stage}", getattr(k5_got, part),
                   getattr(k5_want, part), stage)
    k5_launch = KT.prepare_launch(*k5_args)
    k5_launch.run()
    k5_t = time_k5(torch, k5_args, k5_launch)
    B0["K5@PostFilterDryRun"] = k5_t[0]
    K1K8["K5@PostFilterDryRun"] = (k5_t[0], k5_t[1], k5_t[4], k5_t[5])
    cb5, f5, i5, _, _, _, caps5, d5 = k5_args
    k6_entries.append(kernel_entry(
        "K5@PostFilterDryRun", "topo_statics",
        "PostFilter path (5000 nodes, 128 preemptors)",
        pb_launches[KT.COUNTER], 0.0,
        (cuda_ms(torch, k5_launch.run),
         cuda_ms(torch, lambda: KT.topo_statics_ref(*k5_args), reps=5,
                 warm=1)),
        k5_launch_work(unpack_cluster(cb5, caps5),
                       unpack_pods(PodBlobs(f32=f5, i32=i5), caps5), i5,
                       caps5, d5)))
    log(f"[13b] K5 at a dry run's masked table (G={f5.shape[0]}, "
        f"PT={caps5.pods}, D={d5}) == its three twins; traced "
        f"{opt_ms(k5_t[0])} ms (the previous design's three stages "
        f"{opt_ms(k5_t[1])} in turns), every device item of a call "
        f"{opt_ms(k5_t[2])} (previous {opt_ms(k5_t[3])}), the wrapper "
        f"{k5_t[4]:.1f} host us (previous {opt_ms(k5_t[5])})")

    return k6_entries, k1_dry, pb_launches["phase1_static"]


def find_turns(torch, old_sweep, first_ms: float) -> tuple:
    """find_candidates' host ms a call over Path B under this K6a and
    under ``old_sweep`` (the previous design's wrapper), the path run in
    turns ((old, new, new, old) twice) after the captured run
    (``first_ms``, its median): each design's median of its runs' medians,
    and the text with each run's medians: find_candidates, the K6a
    wrapper's host us where the path calls it, the wrapper until its
    kernel is done, the dry runs inside a call (how many in the run, ms
    each), find_candidates less K6a and the dry runs; and whether the run
    placed every preemptor where the first run did."""
    runs = {"new": [], "old": []}
    first = None
    for tag in ("old", "new", "new", "old") * 2:
        gc.collect()                # the last run's Scheduler and Hub
        cap = {}
        res = path_b(torch, 5000, 8192, 128, "cuda", capture=cap,
                     sweep=old_sweep if tag == "old" else None, count=False)
        if len(cap["find_s"]) != len(cap["sweep_s"]):
            raise AssertionError(
                f"[13b] {len(cap['find_s'])} find_candidates calls against "
                f"{len(cap['sweep_s'])} K6a calls")
        pre = {k: v for k, v in res["bindings"].items()
               if k.startswith("pre-")}
        first = pre if first is None else first
        med = statistics.median
        runs[tag].append((
            med(cap["find_s"]) * 1e3,
            med(w for w, _ in cap["sweep_s"]) * 1e6,
            med(d for _, d in cap["sweep_s"]) * 1e3,
            len(cap["dryrun_s"]), med(cap["dryrun_s"]) * 1e3,
            med(f - d - sum(dry) for f, (_, d), dry in zip(
                cap["find_s"], cap["sweep_s"], cap["find_dry"])) * 1e3,
            pre == first))
    med = {t: statistics.median(r[0] for r in v) for t, v in runs.items()}

    def runs_text(tag):
        return "; ".join(
            f"{f:.3f} ms (wrapper {w:.1f} us, to done {d:.3f} ms, {n} dry "
            f"runs {dr:.3f} ms each, the rest {r:.3f} ms, placements "
            f"{'as' if same else 'NOT as'} the first run's)"
            for f, w, d, n, dr, r, same in runs[tag])

    text = (f"in turns ((old, new, new, old) twice) after the captured run "
            f"({first_ms:.3f}): this K6a {med['new']:.3f} (runs: "
            f"{runs_text('new')}), the previous K6a {med['old']:.3f} (runs: "
            f"{runs_text('old')})")
    return med["new"], med["old"], text


def path_b(torch, n_nodes, node_cap, n_pre, device, now=time.time,
           capture=None, timeout_s=600.0, feasible=None, sweep=None,
           count=True) -> dict:
    """The full PostFilter path through a Hub and a Scheduler: ``n_nodes``
    nodes of node-default.yaml, one priority-0 100m pod labelled app=red
    created already bound on each, then ``n_pre`` priority-10 preemptors
    of 100m / 500Mi with a required hostname anti-affinity term against
    app=red, driven until every preemptor is bound. Every eighth
    preemptor is labelled app=blue and also carries a DoNotSchedule
    hostname spread constraint over app=blue (maxSkew 1), so its dry runs
    run the spread check. ``capture`` (a dict) keeps the first three K6a
    calls' inputs, the first three K6b calls' and the first of a spread
    preemptor's, and the host wall of every whole dry run and of every
    Evaluator.find_candidates (and the dry runs inside each), and each K6a
    call's wrapper host time and its time until the kernel is done. ``feasible`` (a preempt_feasible) and
    ``sweep`` (a preempt_sweep) replace K6b's and K6a's wrappers for this
    run; ``count`` False keeps the run's launches out of the call's sums.
    Returns the end state and the stats."""
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
    from kubernetes_tpu_torch.kernels import preempt as KPm
    from kubernetes_tpu_torch.kernels import topology as KTm

    own_sweep, own_feasible = FP.preempt_sweep, FP.preempt_feasible
    own_find = FP.Evaluator.find_candidates
    if feasible is not None:
        FP.preempt_feasible = feasible
    if sweep is not None:
        FP.preempt_sweep = sweep
    real = (FP.preempt_sweep, FP.preempt_feasible,
            FP.Evaluator._dryrun_feasible, KPm.phase1_static,
            KTm.topo_statics)
    if capture is not None:
        capture.update(sweep=[], feasible=[], spread=[], dryrun_s=[],
                       find_s=[], find_dry=[], sweep_s=[], pod=None)

        def find(self, *args, **kw):
            i0 = len(capture["dryrun_s"])
            t0 = time.perf_counter()
            out = own_find(self, *args, **kw)
            capture["find_s"].append(time.perf_counter() - t0)
            capture["find_dry"].append(capture["dryrun_s"][i0:])
            return out

        FP.Evaluator.find_candidates = find

        def k1(*args):
            if "k1" not in capture:
                capture["k1"] = clone_tree(args + (None,) * (8 - len(args)))
            return real[3](*args)

        def k5(*args):
            if "k5" not in capture:
                capture["k5"] = clone_tree(args)
            return real[4](*args)

        KPm.phase1_static, KTm.topo_statics = k1, k5

        def sweep(*args, **kw):
            if len(capture["sweep"]) < 3:
                capture["sweep"].append((clone_tree(args), dict(kw)))
            # the wrapper's host time where the path calls it, and until
            # its kernel is done (the caller's pull waits for that anyway)
            t0 = time.perf_counter()
            out = real[0](*args, **kw)
            t1 = time.perf_counter()
            if device != "cpu":
                torch.cuda.synchronize()
            capture["sweep_s"].append((t1 - t0, time.perf_counter() - t0))
            return out

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
        if device != "cpu" and count:
            add_drain(launches)
        pods = hub.list_pods()
        stats = dict(sched.stats)
    finally:
        FP.preempt_sweep, FP.preempt_feasible = own_sweep, own_feasible
        FP.Evaluator._dryrun_feasible = real[2]
        FP.Evaluator.find_candidates = own_find
        KPm.phase1_static, KTm.topo_statics = real[3], real[4]
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
        # a plain tuple: the kernel and its twin both read this seed,
        # so the launch copies it (a Seed would be filled in place)
        state = tuple(extract_state(cblobs, caps))
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
    member, that one again with every node-slice and domain array in
    global memory. Returns the summary and the free matrices seen (phase
    15b)."""
    from kubernetes_tpu_torch.kernels import build as KB
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
            # the same launch with every node-slice and domain array in
            # global memory (the layout past shared memory), exact too
            d_cap = mirror.gang_pack_domain()[1]
            key = next(k for k in KG._PLANS
                       if k[0] == caps.nodes and k[2] == d_cap)
            saved = KG._PLANS[key]
            KG._PLANS[key] = dataclasses.replace(
                saved, smem_bytes=KG.FIXED_BYTES,
                off=(-1,) * len(KG.PLACED))
            n_global = KB.LAUNCHES["gang_pack_global"]
            try:
                got = KG.pack_gangs(*args, **kw)
                torch.cuda.synchronize()
            finally:
                KG._PLANS[key] = saved
            cmp_pack(f"[15] {tag} fit={fit_on} fail-by-one, all global",
                     got, want)
            if KB.LAUNCHES["gang_pack_global"] != n_global + 1:
                raise AssertionError("[15] the all-global launch was not "
                                     "counted")
            if bool(want.ok[0]):
                raise AssertionError(f"[15] {tag}: a gang one member past "
                                     "its capacity fit")
        tk, d_cap = mirror.gang_pack_domain()
        lines.append(f"{tag} (N={n_nodes}, tk={tk}, d_cap={d_cap}, "
                     f"first gang's capacity {cap0s}, members placed "
                     f"{placed})")
    return "; ".join(lines), frees


def hold_gang_capacity(torch, frees=None) -> str:
    """Phase 15b: K7b against its twin on the card, exact: the fuzz
    clusters' device-resident free views (phase 15's; without them one
    cluster of 5,000 nodes, bucket 8,192) with their representatives'
    host rows; a [8,192, 74] free matrix (70 extended-resource columns,
    16 CTAs) with a request binding a few columns, again with a NaN row,
    and with a request with no active column; a CUDA request tensor
    refused. The [8,192, 74] case traced in turns with the previous
    design where build/previous holds it."""
    from kubernetes_tpu_torch.api.resources import pod_request
    from kubernetes_tpu_torch.kernels import gang as KG

    if frees is None:
        mirror, _caps, _nom, reps = gang_mirror(torch, 51, 5000, 8192, 8)
        frees = [("8 zones", mirror, reps)]
    cases = []
    for tag, mirror, reps in frees:
        free = mirror.device_free()
        cases += [(f"{tag} rep {k}", free, mirror._res_row(pod_request(p)))
                  for k, p in enumerate(reps[:4])]
    rng = np.random.default_rng(74)
    wide = torch.tensor(rng.integers(0, 64, size=(8192, 74))
                        .astype(np.float32) * 250.0, device="cuda")
    req = np.zeros((74,), np.float32)
    req[[0, 1, 5, 40, 73]] = [900.0, 200.0, 1.0, 250.0, 500.0]
    holed = wide.clone()
    holed[4321, 40] = float("nan")
    cases += [("R=74", wide, req), ("R=74 with a NaN row", holed, req),
              ("no active column", wide, np.zeros((74,), np.float32))]
    out = []
    for tag, free, r in cases:
        got = KG.gang_capacity(free, r)
        want = KG.capacity_ref(free, torch.tensor(r, device="cuda"))
        torch.cuda.synchronize()
        cmp_exact(f"[15b] {tag}", got, want)
        out.append(f"{tag} {int(want)} ({KG.cap_ctas(free.shape[0])} "
                   "CTAs)")
    try:
        KG.gang_capacity(wide, torch.tensor(req, device="cuda"))
    except ValueError:
        pass
    else:
        raise AssertionError("[15b] a CUDA request tensor was taken")
    prev = previous_design() if previous_changed("gang_capacity") else None
    req_dev = torch.tensor(req, device="cuda")
    tr = traced_turns(
        torch, lambda: KG.gang_capacity(wide, req),
        (lambda: prev[3].gang_capacity(wide, req_dev)) if prev else None,
        20, ("gang_capacity",), ("gang_capacity",))
    nb, ops = cap_work((wide, req))
    return (", ".join(out) + "; a CUDA request tensor refused; the "
            f"[8192, 74] case traced {opt_ms(tr[0])} ms (the previous "
            f"design, one CTA of 1,024 threads, in turns: {opt_ms(tr[1])}), "
            f"bound {max(nb / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3:.6f}"
            f"; ptxas {ptxas_text('gang_capacity', 'gang_capacity')}")


def htod_copies(torch, fn, reps: int = 20) -> float:
    """Host-to-device copies a call of ``fn`` makes, from a torch.profiler
    trace of ``reps`` calls (the device items named Memcpy HtoD)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "HtoD" in e.name) / reps


def host_turns(torch, new, old, reps: int = 30) -> tuple:
    """Median host us of one call of ``new`` and of ``old`` (a synchronize
    before each, outside the span), in turns (old, new, new, old); old
    None without ``old``."""
    runs: dict = {"new": [], "old": []}
    for tag in ("old", "new", "new", "old") if old else ("new", "new"):
        runs[tag].append(host_us(torch, new if tag == "new" else old,
                                 lambda: None, reps))
    return (statistics.median(runs["new"]),
            statistics.median(runs["old"]) if old else None)


def previous_dispatch(torch, prev_kg, mirror, pod):
    """The previous design's route of the gang plugin's K7b call: the
    request's row formed again from the pod (the memo's token had formed
    it once already), uploaded from that pageable host row, then the
    previous wrapper (which casts, checks and allocates its output)."""
    from kubernetes_tpu_torch.api.resources import pod_request

    free = mirror.device_free()
    req = torch.as_tensor(mirror._res_row(pod_request(pod)),
                          dtype=torch.float32, device=free.device)
    return prev_kg.gang_capacity(free, req)


def permit_path(torch, card) -> dict:
    """16b: the Permit path on the card, the storm at scale 1 with
    gang_device_packing=False: every member bound, K7b launched, its first
    three calls held against the twin; K7b at the first call by design,
    in turns with the previous design where build/previous holds it: the
    kernel traced, the plugin's call (GangScheduling.dispatch_capacity:
    the mirror's free view, the wrapper with the request's row, the
    launch; the previous route also formed the row again and uploaded it)
    in host us, and its host-to-device copies from a profiler trace (none
    allowed in this design). Returns the K7b@PermitPath kernels-line
    entry."""
    from kubernetes_tpu_torch.api.resources import pod_request
    from kubernetes_tpu_torch.kernels import gang as KG
    from kubernetes_tpu_torch.plugins.gang import GangScheduling

    cap: dict = {}
    res, end, launches, wall = gang_drain(
        torch, "multi_tenant_gang_storm", 1.0, packing=False, capture=cap)
    check_bound(end, 1008, res["name"])
    if launches["gang_capacity"] <= 0 or launches["gang_pack"]:
        raise AssertionError(f"[16b] launches {nonzero(launches)}")
    for i, (free, row) in enumerate(cap["cap"]):
        got = KG.gang_capacity(free, row)
        want = KG.capacity_ref(free, torch.as_tensor(row, device="cuda"))
        torch.cuda.synchronize()
        cmp_exact(f"[16b] K7b call {i}", got, want)
    log(f"[16b] {res['name']} with gang_device_packing=False (every gang "
        f"through the Permit wait room): all 1008 members bound, every gang "
        f"whole; admitted {end['gang']['admitted']} gangs, rollbacks "
        f"{end['gang']['rollbacks']}, wait-room timeouts "
        f"{end['gang']['timeouts']}; the first {len(cap['cap'])} K7b "
        f"calls == twin exactly; {gang_line(res['name'], res, launches, wall)}")
    ca = cap["cap"][0]
    mirror, row = cap["dispatch"]
    # a member whose request is that row, for the previous route (which
    # formed the row again from the pod)
    pod = next((p for p in end["pods"] if np.array_equal(
        mirror._res_row(pod_request(p)), row)), None)
    prev = previous_design() if previous_changed("gang_capacity") else None
    pk = prev[3] if prev and pod is not None else None
    new_call = lambda: GangScheduling.dispatch_capacity(mirror, row)  # noqa: E731
    old_call = ((lambda: previous_dispatch(torch, pk, mirror, pod)) if pk
                else None)
    names = ("gang_capacity",)
    tr = traced_turns(torch, new_call, old_call, 20, names, names)
    hu = host_turns(torch, new_call, old_call, 50)
    copies = htod_copies(torch, new_call)
    copies_old = htod_copies(torch, old_call) if old_call else None
    if copies:
        raise AssertionError(f"[16b] K7b's call made {copies} host-to-"
                             "device copies a call")
    B0["K7b@PermitPath"] = tr[0]
    times = (cuda_ms(torch, lambda: KG.gang_capacity(*ca)),
             cuda_ms(torch, lambda: KG.capacity_ref(
                 ca[0], torch.as_tensor(ca[1], device="cuda")), reps=5))
    free = mirror.device_free()
    log(f"[16b] K7b at the Permit path's first call (N={free.shape[0]}, "
        f"R={free.shape[1]}, row stride {free.stride(0)}, "
        f"{KG.cap_ctas(free.shape[0])} CTA(s) of {KG.CAP_THREADS}) on "
        f"{card}: traced {opt_ms(tr[0])} ms (previous design in turns "
        f"{opt_ms(tr[1])}); the plugin's call "
        f"(GangScheduling.dispatch_capacity) {hu[0]:.1f} host us "
        f"(previous route {opt_ms(hu[1])}); host-to-device copies a call "
        f"{copies} (previous route {opt_ms(copies_old)}); events "
        f"{times[0]:.5f} ms, twin {times[1]:.3f}; work {cap_work(ca)}")
    entry = kernel_entry("K7b@PermitPath", "gang_capacity",
                         "MultiTenantGangStorm/500Nodes, gang_device_"
                         "packing=False", launches["gang_capacity"], 0.0,
                         times, cap_work(ca))
    entry.update(trace_ms_previous=tr[1], host_us=hu[0],
                 host_us_previous=hu[1], htod_copies=copies,
                 htod_copies_previous=copies_old)
    return entry


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
    from kubernetes_tpu_torch.ops import gang as OG

    from kubernetes_tpu_torch.plugins.gang import GangScheduling as GS

    real_core, real_cap, real_k1 = (KG.pack_core, KG.gang_capacity,
                                    OG.phase1_static)
    real_dispatch = GS.dispatch_capacity
    if capture is not None:
        capture.update(pack=[], cap=[])

        def k1(*args):
            if "k1" not in capture:
                capture["k1"] = clone_tree(args + (None,) * (8 - len(args)))
            return real_k1(*args)

        OG.phase1_static = k1

        def core(*args, **kw):
            if len(capture["pack"]) < 3:
                # the copies are no fresh seed: a replay copies them
                capture["pack"].append((clone_tree(args), {
                    k: v for k, v in kw.items() if k != "fresh"}))
            return real_core(*args, **kw)

        def cap(*args):
            if len(capture["cap"]) < 3:
                capture["cap"].append(clone_tree(args))
            return real_cap(*args)

        def dispatch(mirror, row):
            capture.setdefault("dispatch", (mirror, row))
            return real_dispatch(mirror, row)

        KG.pack_core, KG.gang_capacity = core, cap
        GS.dispatch_capacity = staticmethod(dispatch)
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
        GS.dispatch_capacity = staticmethod(real_dispatch)
        OG.phase1_static = real_k1
    res["gc"] = gc_since(g0)
    return res, end, dict(KB.LAUNCHES), time.time() - t0


def gang_split_text(split: dict) -> str:
    """A measured phase's gang_device split (scheduler.py GANG_SPLIT) a
    chunk: ms of each part (the pack, the sum of its parts, then each
    part), and the chunks that re-synced the mirror."""
    from kubernetes_tpu_torch import scheduler as S

    n = max(int(split["chunks"]), 1)
    pack = sum(split[k] for k in S.GANG_PACK)
    parts = ", ".join(
        f"{k} {split[k] / n * 1e3:.3f}"
        for k in ("resync", "patch", *S.GANG_PACK, "extract", "inputs",
                  "k1", "uploads", "k7a", "device", "pull"))
    return (f"{int(split['chunks'])} chunks, {int(split['resyncs'])} "
            f"re-synced the mirror; ms a chunk: pack {pack / n * 1e3:.3f} "
            f"({', '.join(S.GANG_PACK)} below), {parts}; total "
            f"{sum(split[k] for k in split if k not in ('chunks', 'resyncs')) / n * 1e3:.3f}")


def measured_phase(final: dict, begin: dict) -> dict:
    """A stats dict's measured-phase part: its value at the end less its
    value when ThroughputCollector.begin ran."""
    return {k: v - begin.get(k, 0.0) for k, v in final.items()}


def gang_preemption_repeat(torch, runs: int = 5) -> str:
    """GangPreemption drained ``runs`` times, each held to the workload's
    checks; each run's pods/s, floor verdict, chain stats and K11's
    launches (evictions between chunks fold into the chain), and for the
    measured phase alone (each stat at the end less its value when the
    measured phase began): the whole host split (Scheduler.stats
    ["time_s"]), the preemption Evaluator's host ms a preemptor
    (Evaluator.stats) and the gang_device split a chunk (stats
    ["gang_split_s"]); then the median and the spread (max - min).
    """
    from kubernetes_tpu_torch import scheduler as S
    from kubernetes_tpu_torch.perf import collector as PC

    seen: dict = {}
    real_init, real_begin = S.Scheduler.__init__, \
        PC.ThroughputCollector.begin

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        seen["sched"] = self

    def begin(self, *args, **kw):
        sched = seen["sched"]
        seen["at_begin"] = (dict(sched.stats["gang_split_s"]),
                            dict(sched.stats["time_s"]),
                            dict(sched.preemption.stats))
        return real_begin(self, *args, **kw)

    rows, rates, drains = [], [], []
    S.Scheduler.__init__, PC.ThroughputCollector.begin = init, begin
    try:
        for _ in range(runs):
            seen.clear()
            with capturing_k11("GangPreemption/128Nodes"):
                drain = gang_drain(torch, "gang_preemption", 1.0)
            st = drain[0]["stats"]
            at = seen.get("at_begin", ({}, {}, {}))
            measured = tuple(measured_phase(final, b) for final, b in zip(
                (st["gang_split_s"], st["time_s"],
                 seen["sched"].preemption.stats), at))
            drains.append(drain + measured)
    finally:
        S.Scheduler.__init__, PC.ThroughputCollector.begin = real_init, \
            real_begin
    for k, (res, end, gl, wall, split, phases, ev) in enumerate(drains):
        check_bound(end, len(end["pods"]), res["name"])
        check_gang_drain(res["name"], res, end, gl)
        high = gang_groups(end["pods"], "high-")
        low = gang_groups(end["pods"], "low-")
        if len(high) != 24 or any(len(m) != 4 for m in high.values()):
            raise AssertionError(
                f"{res['name']}: high gangs {len(high)}, sizes "
                f"{sorted({len(m) for m in high.values()})}")
        if any(len(m) != 4 for m in low.values()):
            raise AssertionError(f"{res['name']}: a low gang evicted in "
                                 "part")
        rates.append(res["pods_per_sec"])
        n_pre = int(ev.get("preemptors", 0))
        rows.append(
            f"run {k + 1}: {128 - len(low)} low gangs evicted whole, "
            f"{res['stats']['preemptions']} preemptions; the measured "
            f"phase ({res['elapsed_s']} s): host split s "
            f"{ {p: round(v, 5) for p, v in phases.items() if v} }, the "
            f"Evaluator {n_pre} preemptors, "
            f"{ev.get('host_s', 0.0) / max(n_pre, 1) * 1e3:.4f} host ms "
            f"a preemptor; the gang_device split: "
            f"{gang_split_text(split)}; "
            f"{gang_line(res['name'], res, gl, wall)}")
    return (f"[16] GangPreemption/128Nodes x{runs}: every run all 24 high "
            f"gangs bound whole, low gangs evicted whole and none in part, "
            f"no priority-10 pod evicted, no node overcommitted; pods/s "
            f"{rates}, median {statistics.median(rates)}, spread "
            f"{max(rates) - min(rates):.1f} (floor {res['threshold']}: "
            f"{sum(r >= res['threshold'] for r in rates)}/{runs} passed); "
            + " | ".join(rows))


RESULT = "GANG_RESULT "


class Forget(dict):
    """A memo that never remembers: every lookup misses (a host cache
    turned off for a measurement; what it stores is never read)."""

    def get(self, key, default=None):
        return default


# the host caches of the gang and preemption cycle that phase 16c turns
# off one at a time, in turns with the code as it is: name -> (module,
# class, attribute) of a memo its __init__ makes, a Forget in its place;
# "plain_key" narrows the packed-row cache's key to pods without labels
# or a nomination instead
CACHE_MEMOS = {
    "sweep_memo": ("framework.preemption", "_HostSweep", "memo"),
    "static_verdicts": ("framework.preemption", "_HostSweep", "plain_ok"),
    "reprieves": ("framework.preemption", "_HostSweep", "reprieved"),
    "request_rows": ("framework.preemption", "Evaluator",
                     "_res_by_request"),
    "chain_rows": ("scheduler", "Scheduler", "_chain_rows"),
    "label_rows": ("backend.mirror", "Mirror", "_label_rows"),
}
CACHE_VARIANTS = (*CACHE_MEMOS, "plain_key")


@contextlib.contextmanager
def cache_off(name):
    """The port with host cache ``name`` (CACHE_VARIANTS) turned off while
    the block runs; nothing for None."""
    import importlib

    if name is None:
        yield
        return
    if name == "plain_key":
        from kubernetes_tpu_torch.backend.mirror import Mirror
        cls, attr = Mirror, "_plain_pod_key"
        real = Mirror._plain_pod_key

        def patched(self, pod):
            if pod.metadata.labels or pod.status.nominated_node_name:
                return None
            return real(self, pod)
    else:
        mod, cname, memo = CACHE_MEMOS[name]
        cls = getattr(importlib.import_module("kubernetes_tpu_torch." + mod),
                      cname)
        attr, real = "__init__", cls.__init__

        def patched(self, *args, **kw):
            real(self, *args, **kw)
            setattr(self, memo, Forget())
    setattr(cls, attr, patched)
    try:
        yield
    finally:
        setattr(cls, attr, real)


def gang_measured_run(torch, off=None) -> dict:
    """One GangPreemption drain held to the workload's checks (with host
    cache ``off`` turned off, cache_off), and its measured phase: pods/s,
    seconds, each Scheduler.stats["time_s"] and ["gang_split_s"] part
    less its value when ThroughputCollector.begin ran, and the host ms a
    preemptor of the Evaluator's batch_preempt (timed here, so the same
    on any tree)."""
    from kubernetes_tpu_torch import scheduler as S
    from kubernetes_tpu_torch.framework import preemption as FP
    from kubernetes_tpu_torch.perf import collector as PC

    seen: dict = {}
    ev = {"s": 0.0, "n": 0}
    real = (S.Scheduler.__init__, PC.ThroughputCollector.begin,
            FP.Evaluator.batch_preempt)

    def init(self, *args, **kw):
        real[0](self, *args, **kw)
        seen["sched"] = self

    def begin(self, *args, **kw):
        st = seen["sched"].stats
        seen["at"] = (dict(st["time_s"]), dict(st["gang_split_s"]))
        return real[1](self, *args, **kw)

    def batch_preempt(self, jobs, snapshot):
        t0 = time.perf_counter()
        out = real[2](self, jobs, snapshot)
        if "at" in seen:
            ev["s"] += time.perf_counter() - t0
            ev["n"] += len(jobs)
        return out

    (S.Scheduler.__init__, PC.ThroughputCollector.begin,
     FP.Evaluator.batch_preempt) = init, begin, batch_preempt
    try:
        with cache_off(off):
            res, end, gl, wall = gang_drain(torch, "gang_preemption", 1.0)
    finally:
        (S.Scheduler.__init__, PC.ThroughputCollector.begin,
         FP.Evaluator.batch_preempt) = real
    check_bound(end, len(end["pods"]), res["name"])
    check_gang_drain(res["name"], res, end, gl)
    high = gang_groups(end["pods"], "high-")
    low = gang_groups(end["pods"], "low-")
    if len(high) != 24 or any(len(m) != 4 for m in high.values()) \
            or any(len(m) != 4 for m in low.values()):
        raise AssertionError(f"{res['name']}: high gangs {len(high)}, a "
                             "gang bound or evicted in part")
    st = res["stats"]
    return {"pods_per_sec": res["pods_per_sec"],
            "elapsed_s": res["elapsed_s"],
            "time_s": measured_phase(st["time_s"], seen["at"][0]),
            "gang_split_s": measured_phase(st["gang_split_s"],
                                           seen["at"][1]),
            "evaluator_ms": ev["s"] / max(ev["n"], 1) * 1e3,
            "preemptors": ev["n"], "low_evicted": 128 - len(low)}


def gang_worker(tree: str) -> int:
    """``--gang-worker TREE``: the port's package of TREE drains
    GangPreemption (gang_measured_run) once a "run" line on stdin ("run
    NAME": with host cache NAME off), each answered by one RESULT line on
    stdout, until "quit". Kernels load from this checkout's build
    directory, so an unchanged source is not built twice."""
    sys.path.insert(0, tree)
    import torch

    from kubernetes_tpu_torch.kernels import build as KB

    KB.BUILD_DIR = os.path.join(HERE, "build", "kernels")
    for line in sys.stdin:
        words = line.split()
        if not words or words[0] != "run":
            break
        off = words[1] if len(words) > 1 else None
        print(RESULT + json.dumps(gang_measured_run(torch, off)),
              flush=True)
    return 0


def gang_turns(torch, runs: int = 5, variants: tuple = ()) -> str:
    """GangPreemption drained in turns, each design in a worker process of
    its own: the previous design's package (PREVIOUS_DIR, where present),
    this one, and this one with each host cache of ``variants``
    (CACHE_VARIANTS) turned off; ``runs`` rounds, forwards then backwards
    (previous, new, off..., off..., new, previous, ...), after one warm
    drain a worker: pods/s, the measured phase's seconds, its host split
    and the Evaluator's ms a preemptor, by design."""
    import subprocess as sp

    trees = {"new": HERE}
    if os.path.isdir(PREVIOUS_DIR):
        trees = {"previous": PREVIOUS_TREE, **trees}
    elif not variants:
        return ("[16c] GangPreemption in turns with the previous design: "
                "no previous design in this call (build/previous absent)")
    tags = (*trees, *variants)
    procs = {tag: sp.Popen([sys.executable, os.path.abspath(__file__),
                            "--gang-worker", tree], stdin=sp.PIPE,
                           stdout=sp.PIPE, text=True)
             for tag, tree in trees.items()}

    def ask(tag) -> dict:
        proc = procs.get(tag, procs["new"])
        proc.stdin.write("run\n" if tag in procs else f"run {tag}\n")
        proc.stdin.flush()
        for line in proc.stdout:
            if line.startswith(RESULT):
                return json.loads(line[len(RESULT):])
        raise RuntimeError(f"the {tag} worker ended ({proc.wait()})")

    got: dict = {tag: [] for tag in tags}
    try:
        for tag in procs:
            ask(tag)                    # warm: first use of each kernel
        for r in range(runs):
            for tag in (tags if r % 2 == 0 else tags[::-1]):
                got[tag].append(ask(tag))
    finally:
        for proc in procs.values():
            with contextlib.suppress(OSError):
                proc.stdin.write("quit\n")
                proc.stdin.close()
        for proc in procs.values():
            try:
                proc.wait(timeout=60)
            except sp.TimeoutExpired:
                proc.kill()
                proc.wait()

    def summary(tag) -> str:
        rs = got[tag]
        rates = [r["pods_per_sec"] for r in rs]
        secs = [r["elapsed_s"] for r in rs]
        keys = sorted({k for r in rs for k, v in r["time_s"].items() if v})
        split = {k: round(statistics.median(r["time_s"].get(k, 0.0)
                                            for r in rs), 5) for k in keys}
        gkeys = [k for k in rs[0]["gang_split_s"]
                 if k not in ("chunks", "resyncs")]
        chunks = statistics.median(r["gang_split_s"]["chunks"] for r in rs)
        gsplit = {k: round(statistics.median(r["gang_split_s"][k]
                                             for r in rs) / max(chunks, 1)
                           * 1e3, 3) for k in gkeys}
        ev = statistics.median(r["evaluator_ms"] for r in rs)
        if tag in variants:
            tag = f"new, {tag} off"
        return (f"{tag}: pods/s {rates}, median "
                f"{statistics.median(rates)} ({sum(r >= 800 for r in rates)}"
                f"/{len(rates)} at the 800 floor); measured phase s {secs}, "
                f"median {statistics.median(secs)}; its host split s "
                f"(medians) {split}; the Evaluator "
                f"{ev:.4f} host ms a preemptor; gang_device ms a chunk "
                f"(medians, {chunks:g} chunks) {gsplit}")

    return ("[16c] GangPreemption/128Nodes in turns (" + ", ".join(tags)
            + f", then backwards; {runs} runs each after a warm drain a "
            "worker; every run all 24 high gangs bound whole, low gangs "
            "evicted whole): " + " | ".join(summary(t) for t in tags))


def floor_text(res) -> str:
    """A drain's floor verdict: the JAX package's pods/s floor for the
    workload (perf/harness.py ``result["passed"]``)."""
    if "passed" not in res:
        return "no measured phase, no floor"
    return (f"floor {res['threshold']} pods/s "
            f"{'passed' if res['passed'] else 'MISSED'}")


def gang_line(name, res, launches, wall) -> str:
    st = res["stats"]
    split = {k: round(v, 3) for k, v in st["time_s"].items()}
    return (f"measured {res['pods_per_sec']} pods/s over {res['elapsed_s']} "
            f"s ({floor_text(res)}; whole drain {wall:.1f} s); K7a {launches['gang_pack']} "
            f"launches, K7b {launches['gang_capacity']}, K1 "
            f"{launches['phase1_static']}; gang fallbacks "
            f"{st['gang_fallback_reasons'] or 'none'}; device fallbacks "
            f"{st['device_fallbacks']}; {churn_stats(st)}, K11 "
            f"{launches['chain_patch']}; host time split s {split}; "
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


def dra_work(dra, host=None) -> tuple:
    """K8's bytes at its D and Q — each device slot's validity and in-use
    flags, the 8 selector words of the free devices only (no other
    device's bits decide anything), the requests (8 words, a count and a
    mode a slot), pins and active flags, static_ok in and out, the host
    verdicts where given, dra_reject — and its operations: 8 word tests
    of each free device against each used request slot of each active
    pod, on every node (what this run's data needs)."""
    n, d = dra.dev_valid.shape
    b, q, _ = dra.req_mask.shape
    free = int((dra.dev_valid & ~dra.dev_in_use).sum())
    nbytes = (2 * n * d + 32 * free + b * q * (8 * 4 + 5) + 5 * b
              + 2 * b * n + (b * n if host is not None else 0) + 4 * b)
    used = ((dra.req_count > 0) | dra.req_all) & dra.active[:, None]
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
        f"{res['pods_per_sec']} pods/s over {res['elapsed_s']} s "
        f"({floor_text(res)}; whole "
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


# K9's fuzzed scorers (phase 22): the narrow path's width classes and
# depths, and past the narrow path's 32 (every width and depth runs)
K9_FUZZ = ((1,), (8,), (16, 8), (24,), (32,) * 3, (8,) * 9, (8,) * 12,
           (32,) * 16, (64,), (64,) * 7, (65,), (128,), (65,) * 9,
           (256, 256), (1024,), (2048,), (16,) * 12)


def hold_k9(torch, errs) -> tuple:
    """22: K9's probe against ops/learned.learned_term on the card, exact:
    fuzzed scorers (K9_FUZZ: widths 1 to 2,048, depths 1 to 16, both
    paths, the wide path's slabs in shared memory and, for 2,048, in
    global scratch; 2^20 rows, 2^14 past width 128), a head that drives the output
    past both clip edges, a NaN weight (NaN in, NaN out), and the drain's
    scorer (init_params(0, (8,))) over M = 4,096 x 8,192 rows, timed
    beside the previous design in turns, and the wide scorer over 2^16
    rows. Returns (summary, kernel ms, twin ms, work)."""
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
    for hidden in K9_FUZZ:
        r_in = rows if max(hidden) <= 128 else rows[:1 << 14]
        for seed in (0, 1):
            lp = k9_params(torch, seed, hidden)
            out = held(f"{hidden} seed {seed}", lp, r_in)
        net = KL.net_of(lp, KL.PROBE_THREADS // 32)
        path = (f"narrow {net.narrow}" if net.narrow else
                f"wide {net.pairs} pairs "
                f"{'shared' if net.slab_shared else 'global'}")
        seen.append(f"{'x'.join(map(str, hidden))} ({path}, "
                    f"{r_in.shape[0]} rows): [{float(out.min()):.3f}, "
                    f"{float(out.max()):.3f}]")
    edges = held("clip edges", k9_params(torch, 2, (8,), head=2000.0), rows)
    n_lo, n_hi = int((edges == 0).sum()), int((edges == 100).sum())
    if not n_lo or not n_hi:
        raise AssertionError(f"[22] clip edges not reached: {n_lo} at 0, "
                             f"{n_hi} at 100")
    for hidden in ((8,), (256, 256)):
        nan_lp = k9_params(torch, 3, hidden)
        nan_lp.buf[5] = float("nan")       # W0[0, 5]: feeds every row
        nan_out = held(f"NaN weight {hidden}", nan_lp, rows[:1 << 14])
        if not bool(torch.isnan(nan_out).all()):
            raise AssertionError(f"[22] a NaN weight ({hidden}) did not "
                                 "reach every output")
    # the drain's scorer at the main path's pair count, timed beside the
    # previous design in turns
    m = 4096 * 8192
    big = k9_rows(torch, m, 6)
    lp = KL.LearnedParams.pack(init_params(LEARNED_SEED_A, (8,)), dev)
    out = held("drain scorer, M = 4096 x 8192", lp, big)
    prev = previous_design() if previous_changed("learned_mlp") else None
    ms, ms_prev = in_turns(
        torch, lambda: KL.learned_probe(lp, big),
        (lambda: prev[2].learned_probe(lp, big)) if prev else None, 10)
    K3_TIMES["learned_mlp probe (8,)"] = (ms, ms_prev, None)
    plain = cuda_ms(torch, lambda: KL.learned_probe_ref(lp, big), reps=3,
                    warm=1)
    work = (m * 40 + lp.buf.numel() * 4, m * (learned_flops(lp.dims) - 2))
    wide = k9_params(torch, 7, WIDE_HIDDEN)
    wide_rows = big[:1 << 16]
    wide_ms = cuda_ms(torch, lambda: KL.learned_probe(wide, wide_rows),
                      reps=5, warm=1)
    wide_ops = (1 << 16) * (learned_flops(wide.dims) - 2)
    summary = (f"[22] K9 probe == twin exactly at {'; '.join(seen)} (output "
               f"ranges, seed 1); clip edges {n_lo} rows at 0, {n_hi} at "
               f"100; a NaN weight gives NaN on every row in both, narrow "
               f"and wide; the drain's scorer init_params(0, (8,)) over M = "
               f"{m} rows: kernel {ms:.5f} ms, "
               f"{previous_text(ms, ms_prev)}, twin {plain:.3f} ms, "
               f"{int((out > 0).sum())} rows above 0; the wide scorer "
               f"k9_layers(7, {WIDE_HIDDEN}) over 65,536 rows {wide_ms:.4f} "
               f"ms ({wide_ops / wide_ms / 1e9:.2f} TFLOP/s of fp32, bound "
               f"{wide_ops / FP32_OPS_PER_S * 1e3:.4f} ms); "
               + ptxas_text("learned_mlp", "learned_mlp_probe"))
    del big
    return summary, ms, plain, work


WIDE_HIDDEN = (256, 256)


def hold_wide_scorer(torch, errs) -> str:
    """23d: K2a (plain and soft) and K3 with wide scorers (K9's wide path)
    against the twins, exact, on reduced launches (5,000 nodes in an 8,192
    bucket, 64 pods: a wide pair costs ~137 K flops): a plain auction over
    fuzz specs, a soft-only topology auction, a hard-topology scan, each
    with k9_layers(7, WIDE_HIDDEN) (its slabs in shared memory), the plain
    auction and the scan also with k9_layers(8, (1024,)) (its slabs in
    global scratch). Each kernel's first call of the launch is kept and
    timed with and without K9."""
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import learned as KL
    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.models import pipeline as P

    dev = torch.device("cuda")
    scorers = {WIDE_HIDDEN: KL.LearnedParams.pack(
        k9_layers(7, WIDE_HIDDEN), dev),
        (1024,): KL.LearnedParams.pack(k9_layers(8, (1024,)), dev)}
    weights = dataclasses.replace(P.default_weights(), learned=1.0)
    cases = (
        ("K2a plain", fuzz_mirror(torch, 31, 5000, 8192, 64, 4), False,
         (WIDE_HIDDEN, (1024,))),
        ("K2a soft", soft_mirror(torch, 32, 5000, 8192, 500, 4, False, 64),
         False, (WIDE_HIDDEN,)),
        ("K3", topology_mirror(torch, 33, 500, 8, 64, ports=False), True,
         (WIDE_HIDDEN, (1024,))))
    out_lines = []
    for tag, (mirror, caps, pods), serial, hiddens in cases:
        spec = mirror.prepare_launch(pods, 64)
        args = (spec, mirror.well_known(), weights, caps)
        for hidden in hiddens:
            lp = scorers[hidden]
            net = (KL.net_of(lp, KS.K9_WARPS) if serial else
                   KL.net_of(lp, KA.MAX_P, KA.K9_NARROW))
            path = (f"{net.pairs} pairs a warp, slabs in "
                    f"{'shared memory' if net.slab_shared else 'scratch'}")
            kept = []
            real = (KA.auction_score_argmax, KS.serial_scan)

            def bid(rin, prog, k, kept=kept, real=real, **kw):
                if not kept:
                    kept.append((clone_tree(rin), clone_tree(prog), k))
                return real[0](rin, prog, k, **kw)

            def scan(sin, kept=kept, real=real):
                if not kept:
                    kept.append(clone_tree(sin))
                return real[1](sin)

            KA.auction_score_argmax, KS.serial_scan = bid, scan
            try:
                out = P.launch_batch(*args, serial_scan=serial, learned=lp,
                                     tie_seed=7, device=dev)
            finally:
                KA.auction_score_argmax, KS.serial_scan = real
            with twins():
                ref = P.launch_batch(*args, serial_scan=serial, learned=lp,
                                     tie_seed=7, device=dev)
            torch.cuda.synchronize()
            for f in ("node_row", "score", "feasible_count", "free", "nzr",
                      "guard"):
                a, b = getattr(out, f), getattr(ref, f)
                errs["learned_mlp"] = max(errs.get("learned_mlp", 0.0),
                                          max_err(a, b))
                cmp_exact(f"[23d] {tag} with the {hidden} scorer {f}", a, b)
            if not kept:
                raise AssertionError(f"[23d] {tag}: no K2a or K3 launch")
            if serial:
                sin = kept[0]
                f0, n0 = sin.free.clone(), sin.nzr.clone()

                def reset(s_=sin, f0=f0, n0=n0):
                    s_.free.copy_(f0)
                    s_.nzr.copy_(n0)

                hand = dataclasses.replace(sin, learned=None)
                ms, _ = in_turns(torch, lambda s_=sin: KS._scan_kernel(s_),
                                 None, 2, reset)
                hand_ms, _ = in_turns(
                    torch, lambda s_=hand: KS._scan_kernel(s_), None, 2,
                    reset)
                shape = f"B={sin.b}, N={sin.n}"
            else:
                rin, prog, k = kept[0]
                hand = dataclasses.replace(rin, learned=None)
                ms = cuda_ms(torch, lambda: KA._bid_kernel(rin, prog, k),
                             reps=3, warm=1)
                hand_ms = cuda_ms(
                    torch, lambda: KA._bid_kernel(hand, prog, k), reps=5,
                    warm=1)
                shape = f"B={rin.b}, N={rin.n}, soft={rin.soft}"
            out_lines.append(
                f"{tag} with {hidden} ({path}; {shape}; "
                f"{int((out.node_row >= 0).sum())} placed): == twin "
                f"exactly; its first {'scan' if serial else 'bid round'} "
                f"{ms:.3f} ms with K9, {hand_ms:.5f} ms without")
    return ("[23d] wide scorers k9_layers(7, " + str(WIDE_HIDDEN)
            + ") and k9_layers(8, (1024,)) (K9's wide path): "
            + "; ".join(out_lines))


def learned_drains(torch, card, errs, k9) -> list:
    """23-23d: the learned profile's three drains at full width, each
    beside its hand-tuned arm in the same call (the reference's
    --ab-scorer arms: same workload, same tie-break seed); copies of their
    K2a and K3 inputs held against the twins (exact) and timed; then the
    card-against-CPU bindings of the learned profile at scale 0.1.
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

        def bid(rin, prog, k, **kw):
            mode = kept["soft" if rin.soft else "plain"]
            if rin.learned is not None and k == 0 and len(mode) < 2:
                mode.append(clone_tree(rin))
            return real[1](rin, prog, k, **kw)

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
                f"{run['res']['elapsed_s']} s ({floor_text(run['res'])}; "
                f"whole drain "
                f"{run['wall']:.1f} s), {st['launches']} launches, host "
                f"phases {phase_total(st):.3f} s {split}, kernel launches "
                f"{nonzero(run['launches'])}, {run['gc']}")

    paths = (
        ("23", W.scheduling_basic, 11000,
         ("phase1_static", "auction_score_argmax", "auction_accept_commit"),
         2),
        ("23b", W.topology_spreading, 10000,
         ("phase1_static", KT.COUNTER, "serial_scan"), None),
        ("23c", W.preferred_topology_spreading, 10000,
         ("phase1_static", KT.COUNTER, *SOFT_KERNELS), None))
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

    # 24: card-against-CPU bindings of the learned profile at scale 0.1
    # (batch and node bucket cut for the CPU twins), fixed tie-break seed,
    # with the drain's scorer and with the packing one
    def reduced(name, nodes, ops, batch, node_cap):
        return Workload(name=name, batch_size=batch, node_capacity=node_cap,
                        pod_capacity=8192, ops=[CreateNodes(*nodes), *ops])

    zones = ["moon-1", "moon-2", "moon-3"]
    cases = (
        reduced("SchedulingBasic/500Nodes_1100Pods", (500, W._node),
                [CreatePods(100, lambda i: W._pod(f"init-{i}")),
                 CreatePods(1000, lambda i: W._pod(f"measure-{i}"))],
                512, 512),
        reduced("TopologySpreading/500Nodes_1000Pods",
                (500, lambda i: W._node(i, zones=zones)),
                [CreatePods(500, lambda i: W._pod(f"init-{i}")),
                 CreatePods(500, W._spreading_pod)], 512, 512))
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


# ------------------------------------------- 25. the training path

@contextlib.contextmanager
def export_twins():
    """twins(), and K2a's export pass through its twin too (the scan twin
    on CUDA tensors sums each step's learned magnitude in the order of
    the plan the kernel takes on this card: kernels/scan.py
    lmag_order_of)."""
    from kubernetes_tpu_torch.kernels import auction as KA

    real_e = KA.auction_export
    KA.auction_export = KA.auction_export_ref
    try:
        with twins():
            yield
    finally:
        KA.auction_export = real_e


def cmp_export(errs, tag, got, want, kernel) -> None:
    """A launch's export tails exact, kernel against twin."""
    for f in ("node_row", "score", "feasible_count", "free", "nzr",
              "learned_mag", "chosen_feat", "alt_row", "alt_score"):
        a, b = getattr(got, f), getattr(want, f)
        errs[kernel] = max(errs.get(kernel, 0.0), max_err(a, b))
        cmp_exact(f"{tag} {f}", a, b)


def hold_caps(torch, errs) -> str:
    """The shapes the caps refused, on the card against the twins:
    K2a's bids, final counts and export pass and K3 at R = 74 (and with
    a 101-point RequestedToCapacityRatio shape), K5 and K3 at C = 17
    spread constraints over TK = 33 topology keys; then K3's export
    outputs with the adaptive percentageOfNodesToScore window."""
    import numpy as np

    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.models import pipeline as P
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf.fuzz import caps_fuzz

    dev = torch.device("cuda")
    shape = (np.linspace(0.0, 1.0, 101).astype(np.float32),
             (50.0 + 50.0 * np.sin(np.linspace(0.0, 6.0, 101)))
             .astype(np.float32))
    w = dataclasses.replace(P.default_weights(), learned=1.0)
    lp = k9_params(torch, 5, (8,))
    parts = []
    nodes, pods = caps_fuzz(random.Random(3), 5000, 512, ext=70)
    caps = Capacities(nodes=8192, pods=2048, ext_resources=70)
    mirror = synced_mirror(torch, nodes, [], caps)
    spec = mirror.prepare_launch(pods, 512)
    KB.reset_launches()
    for serial, kw, b in ((False, {}, 512),
                          (False, dict(fit_strategy="RequestedToCapacityRatio",
                                       fit_shape=shape), 512),
                          (True, {}, 128),
                          (True, dict(fit_strategy="RequestedToCapacityRatio",
                                      fit_shape=shape), 128)):
        sp = spec if b == 512 else mirror.prepare_launch(pods[:b], b)
        args = (sp, mirror.well_known(), w, caps)
        kw = dict(kw, serial_scan=serial, tie_seed=3, learned=lp,
                  with_feats=True, with_alts=True, device=dev)
        out = P.launch_batch(*args, **kw)
        with export_twins():
            ref = P.launch_batch(*args, **kw)
        torch.cuda.synchronize()
        kernel = "serial_scan" if serial else "auction_score_argmax"
        tag = (f"caps R={caps.res_cols} {'K3' if serial else 'K2a'} "
               f"{kw.get('fit_strategy', 'LeastAllocated')}")
        cmp_export(errs, tag, out, ref, kernel)
        placed = int((out.node_row >= 0).sum())
        if not placed:
            raise AssertionError(f"{tag}: nothing placed")
        parts.append(f"{'K3' if serial else 'K2a'} "
                     f"{'101-point shape' if kw.get('fit_shape') else 'fit'}"
                     f" {placed}/{b} placed")
    r74 = dict(KB.LAUNCHES)
    nodes, pods = caps_fuzz(random.Random(5), 5000, 128, keys=30,
                            c_hard=17)
    caps = Capacities(nodes=8192, pods=2048, spread_constraints=17,
                      topo_cols=33, label_cols=64)
    mirror = synced_mirror(torch, nodes, [], caps)
    spec = mirror.prepare_launch(pods, 128)
    if not spec.enable_topology or spec.topo_soft:
        raise AssertionError("caps C=17: not a hard topology launch")
    args = (spec, mirror.well_known(), w, caps)
    kw = dict(serial_scan=True, tie_seed=3, learned=lp, with_feats=True,
              with_alts=True, device=dev)
    KB.reset_launches()
    out = P.launch_batch(*args, **kw)
    with export_twins():
        ref = P.launch_batch(*args, **kw)
    torch.cuda.synchronize()
    cmp_export(errs, "caps C=17 TK=33 K5 + K3", out, ref, "serial_scan")
    c17 = dict(KB.LAUNCHES)
    for k in ("topo_statics", "serial_scan"):
        if c17[k] <= 0:
            raise AssertionError(f"caps C=17: {k} not launched")
    parts.append(f"K5 + K3 at C=17, TK=33: "
                 f"{int((out.node_row >= 0).sum())}/128 placed, spread "
                 f"rejects {int(out.reject_counts[:, -2].sum())}")
    # K3's export outputs with the percentageOfNodesToScore window
    mirror, caps, pods = fuzz_mirror(torch, 31, 5000, 8192, 256, 8)
    spec = mirror.prepare_launch(pods, 256)
    args = (spec, mirror.well_known(), w, caps)
    kw = dict(serial_scan=True, tie_seed=3, learned=lp, with_feats=True,
              with_alts=True, pct_nodes=P.ADAPTIVE_PCT, device=dev)
    out = P.launch_batch(*args, **kw)
    with export_twins():
        ref = P.launch_batch(*args, **kw)
    torch.cuda.synchronize()
    cmp_export(errs, "K3 export with the window", out, ref, "serial_scan")
    cmp_exact("K3 export with the window pct_start", out.pct_start,
              ref.pct_start)
    parts.append(f"K3 with the adaptive window (k_find "
                 f"{int(out.feasible_count.max())}) "
                 f"{int((out.node_row >= 0).sum())}/256 placed")
    return (f"[25f] the lifted caps on the card == twins exactly (export "
            f"tails and K9 on): R=74 over 5000 nodes: {'; '.join(parts)} "
            f"(launches at R=74 {nonzero(r74)}; at C=17 {nonzero(c17)})")


def traced(torch, fn, reps, reset=None, names=None) -> tuple:
    """(ms, how): the device duration of one run of ``fn`` from a
    profiler trace, or, where the trace holds no such item, the CUDA-event
    median (which reads its own floor, ~0.02 ms, for short kernels)."""
    ms = trace_ms(torch, fn, reps, reset, names)
    if ms is not None:
        return ms, "traced"
    if reset is None:
        return cuda_ms(torch, fn, reps), "events (no trace items)"
    return in_turns(torch, fn, None, max(1, reps // 4), reset)[0], \
        "events (no trace items)"


K10_NAMES = ("k10_step", "k10_small")
K10_PREVIOUS_NAMES = ("k10_forward", "k10_backward", "k10_fold")


def k10_work(m: int, dims: tuple) -> tuple:
    """K10's bytes (x, y, w read once, 44 B a row; the parameters read
    once; the loss and the gradient written once) and operations a row:
    forward a multiply and an add a weight, the bias and ReLU a unit, the
    loss's 4; backward the deltas' multiply and add a weight above the
    first layer, ReLU' a unit, the head's 3; the sums' multiply and add a
    weight, an add a bias, the loss's add."""
    p = sum((a + 1) * b for a, b in zip(dims, dims[1:]))
    weights = sum(a * b for a, b in zip(dims, dims[1:]))
    units = sum(dims[1:])
    per_row = (2 * weights + 2 * units + 4
               + 2 * (weights - dims[0] * dims[1]) + units + 2
               + 2 * weights + units + 1)
    return m * 44 + 4 * p + 4 * (p + 1), m * per_row


def hold_k10(torch, errs, m, dims, seed, entries, path, launches,
             data=None) -> str:
    """K10 on the card at ``m`` rows (``data``: (x, y, w) numpy arrays,
    else seeded uniform rows) against the plain autograd twin on the same
    inputs (relative errors: the sums run in another order): the one
    launch of mlp_value_and_grad, two runs bit for bit the same, and
    MLPLoss through torch autograd (its loss mode, then its gradient
    mode: two launches, bit for bit the same loss and gradient); the
    prepared launch timed from profiler traces in turns with the previous
    design (build/previous: its forward, backward and folds), beside the
    twin, with its host us."""
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import learned as KL

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    if data is None:
        x = torch.rand((m, 9), generator=g).to(dev)
        y = (torch.rand((m,), generator=g) * 100).to(dev)
        w = (1 + torch.rand((m,), generator=g)).to(dev)
    else:
        x, y, w = (torch.from_numpy(np.ascontiguousarray(a, np.float32))
                   .to(dev) for a in data)
    n_p = sum((a + 1) * b for a, b in zip(dims, dims[1:]))
    buf = (torch.randn((n_p,), generator=g) * 0.5).to(dev)
    before = KB.LAUNCHES["learned_train"]
    loss, grad = KL.mlp_value_and_grad(buf, dims, x, y, w)
    loss2, grad2 = KL.mlp_value_and_grad(buf, dims, x, y, w)
    one = KB.LAUNCHES["learned_train"] - before
    p = buf.clone().requires_grad_(True)
    ref = KL.mlp_loss_ref(p, dims, x, y, w)
    (gref,) = torch.autograd.grad(ref, p)
    before = KB.LAUNCHES["learned_train"]
    q = buf.clone().requires_grad_(True)
    bound_loss = KL.MLPLoss.apply(q, x, y, w, tuple(dims))
    bound_loss.backward()
    modes = KB.LAUNCHES["learned_train"] - before
    torch.cuda.synchronize()
    if one != 2 or modes != 2:
        raise AssertionError(f"K10 M={m}: {one} launches for two steps, "
                             f"{modes} for MLPLoss's two modes")
    if not (torch.equal(loss, loss2) and torch.equal(grad, grad2)):
        raise AssertionError(f"K10 M={m}: two runs differ")
    if not (torch.equal(bound_loss.detach(), loss)
            and torch.equal(q.grad, grad)):
        raise AssertionError(f"K10 M={m}: MLPLoss's modes differ from "
                             "the one-launch step")
    l_err = abs(float(loss) - float(ref)) / abs(float(ref))
    g_err = float((grad - gref).abs().max() / gref.abs().max())
    if l_err > 1e-5 or g_err > 1e-4:
        raise AssertionError(f"K10 M={m} {dims}: loss rel err {l_err}, "
                             f"grad rel err {g_err}")
    errs["learned_train"] = max(errs.get("learned_train", 0.0), g_err)
    step = KL.train_step(m, dims, dev)
    out_l = torch.empty((), dtype=torch.float32, device=dev)
    out_g = torch.empty_like(buf)

    def new():
        step.launch(KL.MODE_GRAD, buf, x, y, w, out_l.data_ptr(),
                    out_g.data_ptr())

    prev = previous_design()
    old = None
    if prev is not None and previous_changed("learned_train"):
        def old():
            prev[2].mlp_value_and_grad(buf, dims, x, y, w)

    ms, ms_old = traced_turns(torch, new, old, 20, K10_NAMES,
                              K10_PREVIOUS_NAMES)
    how = "traced"
    if ms is None:
        ms, how = cuda_ms(torch, new), "events (no trace items)"

    def plain_both():
        r = buf.clone().requires_grad_(True)
        torch.autograd.grad(KL.mlp_loss_ref(r, dims, x, y, w), r)

    plain = cuda_ms(torch, plain_both)
    us = host_us(torch, new, lambda: None)
    tiled = tiled_turns(torch, m, dims, new, (buf, x, y, w), (ref, gref)) \
        if KL.small_path(dims) else None
    e = kernel_entry(f"K10@M={m},{'x'.join(map(str, dims[1:-1]))}",
                     "learned_train", path, launches["learned_train"],
                     g_err, (ms, plain), k10_work(m, dims))
    e.update(trace_ms=ms if how == "traced" else None,
             trace_ms_previous_design=ms_old, host_us=round(us, 1),
             loss_rel_err=l_err)
    if tiled is not None:
        e["trace_ms_tiled_path"] = tiled[1]
    entries.append(e)
    plan = step.plan
    return (f"K10 at M={m} {dims}: one launch a step (plan: {plan.blocks} "
            f"blocks of {plan.threads} rows x {plan.tiles} tiles, "
            f"{plan.smem} B shared), loss and gradient == twin (rel err "
            f"{l_err:.2e} / {g_err:.2e}), bit for bit across runs and "
            f"through MLPLoss's two modes (2 launches); {ms:.5f} ms {how}, "
            f"{previous_text(ms, ms_old)}; "
            + (f"in turns with the tiled path on the same stack (the "
               f"-DK10_TILED_ONLY build, == twin: rel err {tiled[2]:.2e} / "
               f"{tiled[3]:.2e}) {tiled[0]:.5f} against {tiled[1]:.5f} ms "
               f"traced; " if tiled else "")
            + f"twin's autograd {plain:.5f} ms; "
            f"bound {e['bound_ms']:.5f} ms ({e['bound_by']}); wrapper "
            f"{us:.1f} host us")


def tiled_turns(torch, m, dims, narrow, data, ref) -> tuple:
    """A narrow-path stack (9 -> H -> 1) on K10's tiled path: the
    -DK10_TILED_ONLY build launched on the tiled plan, held to the twin's
    loss and gradient ``ref`` (1e-5 / 1e-4 relative), and timed from
    profiler traces in turns with ``narrow`` (the narrow path's prepared
    launch): (narrow ms, tiled ms, loss and gradient relative errors)."""
    import ctypes

    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import learned as KL

    buf, x, y, w = data
    lib = KB.build_variant("learned_train", ("K10_TILED_ONLY",))
    lib.k10_step_launch.argtypes = KL._train_lib().k10_step_launch.argtypes
    lib.k10_step_launch.restype = ctypes.c_int
    real_h = KL.SMALL_H
    KL.SMALL_H = 0                      # plan_train's tiled plan
    try:
        step = KL.TrainStep(m, dims, buf.device)
    finally:
        KL.SMALL_H = real_h
    step.lib = lib
    loss = torch.empty((), dtype=torch.float32, device=buf.device)
    grad = torch.empty_like(buf)

    def tiled():
        step.launch(KL.MODE_GRAD, buf, x, y, w, loss.data_ptr(),
                    grad.data_ptr())

    tiled()
    torch.cuda.synchronize()
    l_err = abs(float(loss) - float(ref[0])) / abs(float(ref[0]))
    g_err = float((grad - ref[1]).abs().max() / ref[1].abs().max())
    if l_err > 1e-5 or g_err > 1e-4:
        raise AssertionError(f"K10's tiled path M={m} {dims}: loss rel err "
                             f"{l_err}, grad rel err {g_err}")
    ms, ms_tiled = traced_turns(torch, narrow, tiled, 20, ("k10_small",),
                                ("k10_step",))
    return ms, ms_tiled, l_err, g_err


def previous_fit(torch, prev_kl, train_mod):
    """The trainer's _fit as the previous design ran it: the previous K10
    module's mlp_value_and_grad (its forward and backward through
    autograd) a step, Adam as now, the losses kept on the card."""
    def fit(buf, dims, x, y, w, epochs, lr):
        m = torch.zeros_like(buf)
        v = torch.zeros_like(buf)
        losses = []
        for t in range(1, max(epochs, 0) + 1):
            loss, g = prev_kl.mlp_value_and_grad(buf, dims, x, y, w)
            buf, m, v = train_mod._adam_step(buf, g, m, v, t, lr)
            if t == 1 or t == epochs:
                losses.append(loss)
        if not losses:
            return buf, None, None
        vals = [float(v_) for v_ in losses]
        return buf, vals[0], vals[-1]
    return fit


def train_turns(torch, ds, cfg) -> str:
    """train() at the defaults in turns with the previous design's _fit
    (old, new, new, old): its wall seconds and host us a step (wall over
    the steps), and the two designs' parameters' largest difference."""
    from kubernetes_tpu_torch.learn import train as TR

    prev = previous_design()
    if prev is None or not previous_changed("learned_train"):
        return "train() in turns: no previous design in this call"
    real_fit = TR._fit
    old_fit = previous_fit(torch, prev[2], TR)
    steps = cfg.bc_epochs + cfg.ft_epochs
    walls: dict = {"old": [], "new": []}
    params = {}
    try:
        for tag in ("old", "new", "new", "old"):
            TR._fit = old_fit if tag == "old" else real_fit
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params[tag], _ = TR.train(ds, cfg)
            torch.cuda.synchronize()
            walls[tag].append(time.perf_counter() - t0)
    finally:
        TR._fit = real_fit
    diff = max(float(np.max(np.abs(a - b))) for (wa, ba), (wb, bb) in zip(
        params["new"], params["old"]) for a, b in ((wa, wb), (ba, bb)))
    per = {k: [round(t / steps * 1e6, 1) for t in v] for k, v in
           walls.items()}
    return (f"train() ({steps} steps) in turns with the previous design: "
            f"wall s {[round(t, 4) for t in walls['new']]} against "
            f"{[round(t, 4) for t in walls['old']]}, host us a step "
            f"{per['new']} against {per['old']}; largest parameter "
            f"difference {diff:.3g}")


def export_paths(torch, rin, lp, errs) -> str:
    """K2a's export pass on variants of a collection launch (4,096 alike
    pods) that take its other paths, each held exactly against the twin
    with the drain's state and with the (8,) scorer ``lp``: one pod's
    request row moved (its CTA's pods not alike: each warp its own pod);
    a few pods' chosen nodes made statically infeasible with the group's
    highest taint score (alike pods whose normalizers differ); the request
    and node rows widened to R = 74 with zero columns (the same function,
    the slices in tiles); and the learned magnitude with neither the
    feature nor the alternative export."""
    from kubernetes_tpu_torch.kernels import auction as KA

    moved = clone_tree(rin)
    moved.req[5] = moved.req[5] + 1.0
    apart = clone_tree(rin)
    for i in (1, 17, 40, 1000):
        n = int(apart.placed[i])
        if n >= 0:
            g = int(apart.gid[i])
            apart.static_ok[g, n] = False
            apart.taint_raw[g, n] = 7.0 + i
    wide = clone_tree(rin)
    for name, rows in (("req", wide.b), ("free", wide.n), ("nom", wide.n)):
        t = getattr(wide, name)
        setattr(wide, name, torch.cat([t, torch.zeros(
            (rows, 66), dtype=t.dtype, device=t.device)], 1).contiguous())
    cases = (("pods not alike", moved, True), ("normalizers apart", apart,
                                               True),
             ("R = 74, tiles", wide, True), ("the magnitude alone", rin,
                                             False))
    out = []
    for tag, r0, flags in cases:
        for build, r in (("drain", r0), ("scorer", dataclasses.replace(
                clone_tree(r0), learned=lp, w_learned=1.0))):
            got = KA.auction_export(r, flags, flags)
            want = KA.auction_export_ref(r, flags, flags)
            torch.cuda.synchronize()
            for fld in ("learned_mag", "chosen_feat", "alt_row",
                        "alt_score"):
                errs["auction_export"] = max(
                    errs.get("auction_export", 0.0),
                    max_err(getattr(got, fld), getattr(want, fld)))
                cmp_exact(f"K2a export, {tag}, {build} {fld}",
                          getattr(got, fld), getattr(want, fld))
        pl = KA.export_plan(r0)
        out.append(f"{tag} ({'resident' if pl.resident else 'tiles of '}"
                   f"{'' if pl.resident else pl.tile})")
    return ("the export's other paths == twin exactly, both builds: "
            + ", ".join(out))


def training_path(torch, card, errs, only_a: bool = False) -> list:
    """25: the learned scorer's training path at full width. (a) a
    hand-tuned SchedulingBasic collection with the feature and
    alternative exports on (K2a's export pass), (b) TopologySpreading
    with the export on (K3's export outputs), each launch kind held
    against its twin on captured launches (with the drain's state and
    with a lively scorer: exact); (c) the dataset from (a)'s export,
    train() on the card (K10, one launch a step), K10 held against its
    twin at the dataset's rows and at 2^20 rows for the (8,) and the
    (64, 64) stacks (in turns with its previous design where
    build/previous holds it, and train() too), LearnLoop.run_once gating
    and publishing; (d) a learned SchedulingBasic drain under the promoted
    checkpoint, a second publish picked up mid-drain without a rebuild;
    (e) the collection's pods/s with the export off and on, in turns.
    ``only_a``: 25a alone. Returns the kernels-line entries."""
    import shutil

    from kubernetes_tpu_torch import scheduler as S
    from kubernetes_tpu_torch.config.types import default_config
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.learn import checkpoint as CK
    from kubernetes_tpu_torch.learn.loop import LearnLoop, LoopConfig
    from kubernetes_tpu_torch.learn.replay import build_dataset
    from kubernetes_tpu_torch.learn.train import TrainConfig, train
    from kubernetes_tpu_torch.perf import workloads as W
    from kubernetes_tpu_torch.perf.harness import run_workload

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "learned", "p25")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tie_seed = 515151
    entries = []

    def export_cfg(path, cfg=None):
        cfg = cfg or default_config()
        cfg.tie_break_seed = tie_seed
        cfg.trace_export_path = path
        cfg.trace_export_features = True
        cfg.trace_export_alts = True
        cfg.trace_export_max_bytes = 0
        return cfg

    def drain(workload, cfg, must, kept=None, n_keep=2, kind="auction"):
        """One drain, the counters zeroed just before it; ``kept`` gets
        copies of the inputs and outputs of its first export launches of
        ``kind`` (the auction's export pass, or the scan)."""
        state = {}
        real_e, real_s = KA.auction_export, KS.serial_scan

        def export(rin, f, a):
            keep = kind == "auction" and kept is not None \
                and len(kept) < n_keep
            copy = clone_tree(rin) if keep else None
            out = real_e(rin, f, a)
            if keep:
                kept.append((copy, f, a, clone_tree(out)))
            return out

        def scan(sin):
            keep = kind == "scan" and kept is not None \
                and len(kept) < n_keep and (sin.exp_feats or sin.exp_alts)
            copy = clone_tree(sin) if keep else None
            out = real_s(sin)
            if keep:
                kept.append((copy, clone_tree(out)))
            return out

        KA.auction_export, KS.serial_scan = export, scan
        KB.reset_launches()
        t0, g0 = time.time(), time.perf_counter()
        try:
            res = run_workload(
                workload, config=cfg, device="cuda",
                on_scheduler=lambda sched, hub: state.update(
                    pods=hub.list_pods(), nodes=hub.list_nodes(),
                    mgr=sched._profile_cfg["default-scheduler"]["learned"],
                    sched=sched))
        finally:
            KA.auction_export, KS.serial_scan = real_e, real_s
        wall = time.time() - t0
        torch.cuda.synchronize()
        launches = dict(KB.LAUNCHES)
        check_bound(state, len(state["pods"]), workload.name)
        missing = [k for k in must if launches[k] <= 0]
        if missing:
            raise AssertionError(f"[25] {workload.name}: launches "
                                 f"{nonzero(launches)}, missing {missing}")
        return res, launches, wall, state, gc_since(g0)

    def line(res, launches, wall, gc):
        st = res["stats"]
        split = {k: round(v, 3) for k, v in st["time_s"].items() if v}
        return (f"{res['pods_per_sec']} pods/s over {res['elapsed_s']} s "
                f"({floor_text(res)}; whole drain {wall:.1f} s), "
                f"{st['launches']} launches, host time split s {split}, "
                f"kernel launches {nonzero(launches)}, {gc}")

    lp = k9_params(torch, 7, (8,))

    # ---- 25a. the collection: K2a's export pass on the auction's path
    path_sb = os.path.join(work, "traces.jsonl")
    kept_a = []
    res_a, la, wall_a, st_a, gc_a = drain(
        W.scheduling_basic(), export_cfg(path_sb),
        ("auction_score_argmax", "auction_accept_commit", "auction_export"),
        kept_a)
    n_exp_a = la["auction_export"]
    held = []
    for i, (rin, f, a, out) in enumerate(kept_a):
        for tag, r in (("drain", rin),
                       ("lively scorer", dataclasses.replace(
                           clone_tree(rin), learned=lp, w_learned=1.0))):
            got = KA.auction_export(r, f, a)
            want = KA.auction_export_ref(r, f, a)
            torch.cuda.synchronize()
            for fld in ("learned_mag", "chosen_feat", "alt_row",
                        "alt_score"):
                errs["auction_export"] = max(
                    errs.get("auction_export", 0.0),
                    max_err(getattr(got, fld), getattr(want, fld)))
                cmp_exact(f"K2a export launch {i} {tag} {fld}",
                          getattr(got, fld), getattr(want, fld))
            if tag == "drain":
                for fld in out._fields:
                    cmp_exact(f"K2a export launch {i} (in the drain) {fld}",
                              getattr(out, fld), getattr(got, fld))
        held.append(f"B={rin.b}, N={rin.n}, "
                    f"{int((rin.placed >= 0).sum())} placed")
    paths = export_paths(torch, kept_a[1][0], lp, errs)
    # each kept launch (the drain's first, its 1,000 init pods in a batch
    # of 4,096 rows, and its second, 4,096 pods), both builds (the
    # drain's, and the (8,) scorer's), traced in turns with the previous
    # design where build/previous holds it
    prev = (previous_design() if previous_changed("auction_score_argmax")
            else None)
    timed = []
    for rin, f, a, _ in kept_a:
        rin_l = dataclasses.replace(clone_tree(rin), learned=lp,
                                    w_learned=1.0)
        t = {"rin": rin, "b": int((rin.placed >= 0).sum())}
        for build, r in (("plain", rin), ("scorer", rin_l)):
            t[build] = traced_turns(
                torch, lambda r=r: KA.auction_export(r, f, a),
                (lambda r=r: prev[1].auction_export(r, f, a)) if prev
                else None, 10, ("auction_export",), ("auction_export",))
            t[build + "_shape"] = export_shape(KA, r)
            t[build + "_shape_prev"] = (export_shape(prev[1], r)
                                        if prev else None)
            t[build + "_prof"] = KA.export_profile(r, f, a)
        # the scorer build at up to 255 registers a thread (one CTA an SM
        # by registers), in turns with this build: six rounds, each
        # trace's reading kept
        k9_lib = KB.build_variant("auction_score_argmax",
                                  ("EXP_K9_MIN_CTAS=1",))
        t["scorer_255_runs"] = []
        t["scorer_255"] = traced_turns(
            torch, lambda: KA.auction_export(rin_l, f, a),
            lambda: KA._export_kernel(rin_l, f, a, lib=k9_lib), 10,
            ("auction_export",), ("auction_export",), rounds=6,
            keep=t["scorer_255_runs"])
        timed.append(t)
    # the 4,096-pod launch with every CTA's pods apart (pod i's first
    # request column raised by i % 16: no pod equals its CTA's first, so
    # every warp takes its own pod's path), held exactly and traced in
    # turns with the previous design, both builds
    rin4, f4, a4, _ = kept_a[1]
    apart4 = clone_tree(rin4)
    apart4.req[:, 0] += (torch.arange(apart4.b, device=apart4.req.device)
                         % 16).to(apart4.req.dtype)
    apart_t = []
    for build, r in (("plain", apart4), ("scorer", dataclasses.replace(
            clone_tree(apart4), learned=lp, w_learned=1.0))):
        got = KA.auction_export(r, f4, a4)
        want = KA.auction_export_ref(r, f4, a4)
        for fld in got._fields:
            errs["auction_export"] = max(
                errs.get("auction_export", 0.0),
                max_err(getattr(got, fld), getattr(want, fld)))
            cmp_exact(f"K2a export, 4,096 pods apart, {build} {fld}",
                      getattr(got, fld), getattr(want, fld))
        share = alike_ctas(r, KA.export_plan(r).pods).tolist()
        ms = traced_turns(
            torch, lambda r=r: KA.auction_export(r, f4, a4),
            (lambda r=r: prev[1].auction_export(r, f4, a4)) if prev
            else None, 10, ("auction_export",), ("auction_export",))
        sh = export_shape(KA, r)
        apart_t.append(f"{build} {opt_ms(ms[0])} ms (previous design "
                       f"{opt_ms(ms[1])}; {share[0]} of {share[1]} CTAs "
                       f"alike; {sh['ctas']} CTAs{sh['cluster_text']}, "
                       f"{sh['per_sm']} an SM; CTA 0's SM cycles by phase "
                       f"{KA.export_profile(r, f4, a4)})")
    rin, f, a, _ = kept_a[0]
    e_plain = cuda_ms(torch, lambda: KA.auction_export_ref(rin, f, a), 3)
    gid = rin.gid.long()
    ok = rin.static_ok[gid]
    r_cols = rin.req.shape[1]
    cand = int((ok & KA._fit(rin)).sum()) + int((rin.placed >= 0).sum())
    e_bytes = (rin.n * (2 * r_cols + 4) * 4 + rin.b * (r_cols + 7) * 4
               + rin.static_ok.shape[0] * rin.n * 13
               + rin.b * (9 + 8) * 4)
    e_ops = int(ok.sum()) * 3 * r_cols + cand * 40
    e_ms = timed[0]["plain"][0]
    ent = kernel_entry("K2aexport@SchedulingBasic", "auction_export",
                       res_a["name"], n_exp_a, errs["auction_export"],
                       (e_ms, e_plain), (e_bytes, e_ops))
    # the scorer build: the same pass plus K9's MLP on every pair it
    # evaluates (its stack read once)
    dims_l = (9, 8, 1)
    el_bytes = e_bytes + 4 * sum((a_ + 1) * b_ for a_, b_ in
                                 zip(dims_l, dims_l[1:]))
    el_ops = e_ops + cand * learned_flops(dims_l)
    el_bound = max(el_bytes / HBM_BYTES_PER_S, el_ops / FP32_OPS_PER_S) * 1e3
    ent.update(trace_ms=e_ms, trace_ms_previous=timed[0]["plain"][1],
               trace_ms_scorer=timed[0]["scorer"][0],
               trace_ms_scorer_previous=timed[0]["scorer"][1],
               bound_ms_scorer=el_bound,
               bound_by_scorer=("bytes" if el_bytes / HBM_BYTES_PER_S
                                >= el_ops / FP32_OPS_PER_S
                                else "operations"),
               by_pods={str(t["b"]): {
                   k: t[k] for k in ("plain", "scorer")} for t in timed})
    entries.append(ent)

    def shape_text(sh):
        return ("-" if sh is None else
                f"{sh['ctas']} CTAs of {sh['threads']} threads"
                f"{sh.get('cluster_text', '')}, {sh['smem']} B shared, "
                f"{sh['regs']} registers, {sh['per_sm']} CTAs an SM")

    turns = "; ".join(
        f"{t['b']} pods: {build} {opt_ms(t[build][0])} ms (previous design "
        f"{opt_ms(t[build][1])}; this design {shape_text(t[build + '_shape'])}"
        f", CTA 0's SM cycles by phase {t[build + '_prof']}"
        f"; previous {shape_text(t[build + '_shape_prev'])})"
        for t in timed for build in ("plain", "scorer")) + "; " + "; ".join(
        f"{t['b']} pods: the scorer build at up to 255 registers "
        f"{opt_ms(t['scorer_255'][1])} ms (this build in turns "
        f"{opt_ms(t['scorer_255'][0])}; {spread_text(t['scorer_255_runs'])})"
        for t in timed) + "; 4,096 pods apart, == twin exactly: " \
        + ", ".join(apart_t)
    k9_255 = [f"{fn}: {v.get('registers')} registers, spill stores/loads "
              f"{v.get('spill_stores', 0)}/{v.get('spill_loads', 0)} B"
              for fn, v in sorted(KB.variant_log(
                  "auction_score_argmax", ("EXP_K9_MIN_CTAS=1",)).items())
              if "auction_export" in fn and "ILb1E" in fn]
    log(f"[25a] {res_a['name']} collection (hand-tuned, trace export with "
        f"features and alternatives) on {card}: all "
        f"{len(st_a['pods'])} pods bound, no node overcommitted; "
        f"{line(res_a, la, wall_a, gc_a)}; K2a's export pass "
        f"{n_exp_a} launches; its kept launches "
        f"({'; '.join(held)}) == twin exactly, with the drain's state and "
        f"with a lively (8,) scorer (learned_mag, chosen_feat, alt_row, "
        f"alt_score); {paths}; traced, in turns with the previous design "
        f"where "
        f"build/previous holds it: {turns}; twin {e_plain:.3f} ms, bound "
        f"{ent['bound_ms']:.5f} ms ({ent['bound_by']}; with the scorer, "
        f"K9 on {cand} pairs: {el_bound:.5f} ms, "
        f"{ent['bound_by_scorer']}); "
        + ptxas_text("auction_score_argmax", "auction_export")
        + f"; the scorer build at up to 255 registers: {'; '.join(k9_255)}"
        + "; previous: " + previous_ptxas("auction_score_argmax",
                                          "auction_export"))
    if only_a:
        shutil.rmtree(work, ignore_errors=True)
        return entries

    # ---- 25b. TopologySpreading: K3's export outputs on the scan's path
    path_ts = os.path.join(work, "traces_topology.jsonl")
    kept_b = []
    res_b, lb, wall_b, st_b, gc_b = drain(
        W.topology_spreading(), export_cfg(path_ts),
        ("phase1_static", "serial_scan"), kept_b, n_keep=1, kind="scan")
    n_exp_b = lb["serial_scan"]
    held = []
    s_plain = None
    for i, (sin, out) in enumerate(kept_b):
        # the drain's launch whole; with a lively scorer its first 256
        # pods (a twin scan takes seconds a 1,000 steps on the card)
        for tag, s0 in (("drain", sin),
                        ("lively scorer, first 256 pods",
                         dataclasses.replace(scan_head(sin, 256), learned=lp,
                                             w_learned=1.0))):
            plan = KS.scan_plan(s0)
            s1, s2 = clone_tree(s0), clone_tree(s0)
            got = KS.serial_scan(s1)
            t0 = time.time()
            want = KS.serial_scan_ref(s2)
            torch.cuda.synchronize()
            if tag == "drain" and s_plain is None:
                s_plain = (time.time() - t0) * 1e3
            for fld in got._fields:
                a_, b_ = getattr(got, fld), getattr(want, fld)
                if a_ is None and b_ is None:
                    continue
                errs["serial_scan_export"] = max(
                    errs.get("serial_scan_export", 0.0), max_err(a_, b_))
                cmp_exact(f"K3 export launch {i} {tag} {fld}", a_, b_)
            if tag == "drain":
                for fld in ("rows", "chosen_feat", "alt_row", "alt_score"):
                    cmp_exact(f"K3 export launch {i} (in the drain) {fld}",
                              getattr(out, fld), getattr(got, fld))
        held.append(f"B={sin.b}, N={sin.n}, {plan.cluster} blocks")
    sin = clone_tree(kept_b[0][0])
    plain_sin = dataclasses.replace(sin, exp_feats=False, exp_alts=False)
    f0, n0 = sin.free.clone(), sin.nzr.clone()

    def reset():
        sin.free.copy_(f0)
        sin.nzr.copy_(n0)

    x_ms, p_ms = in_turns(torch, lambda: KS.serial_scan(sin),
                          lambda: KS.serial_scan(plain_sin), 3, reset=reset)
    s_ms, s_how = traced(torch, lambda: KS.serial_scan(sin), 5, reset,
                         ("serial_scan_kernel",))
    reset()
    nbytes, ops = scan_work(sin)
    ent = kernel_entry("K3export@TopologySpreading", "serial_scan_export",
                       res_b["name"], n_exp_b, errs["serial_scan_export"],
                       (s_ms, s_plain),
                       (nbytes + sin.b * (9 + 8) * 4, ops))
    ent["trace_ms"] = s_ms if s_how == "traced" else None
    entries.append(ent)
    log(f"[25b] {res_b['name']} with the export on, on {card}: all "
        f"{len(st_b['pods'])} pods bound, no node overcommitted; "
        f"{line(res_b, lb, wall_b, gc_b)}; K3 with its export outputs "
        f"{n_exp_b} launches; its first {len(kept_b)} launches "
        f"({'; '.join(held)}) == twin exactly, with the drain's state and "
        f"with a lively (8,) scorer (rows, win, counts, the steps' "
        f"learned magnitudes and their sum, chosen_feat, alt_row, "
        f"alt_score); {s_how} {s_ms:.5f} ms a launch, twin "
        f"{s_plain:.1f} ms (one run), bound {ent['bound_ms']:.5f} ms; the "
        f"same "
        f"launch with and without the export outputs in turns (CUDA "
        f"events): {x_ms:.5f} / {p_ms:.5f} ms; "
        + ptxas_text("serial_scan", "serial_scan_kernel"))

    # ---- 25c. the dataset, the trainer (K10) and the loop's gate
    ds = build_dataset([path_sb])
    KB.reset_launches()
    t0 = time.time()
    params, info = train(ds, TrainConfig(meta={"version": 2,
                                               "source": "chip_smoke"}))
    torch.cuda.synchronize()
    train_s = time.time() - t0
    k10_train = dict(KB.LAUNCHES)
    live = os.path.join(work, "live.json")
    loop = LearnLoop(LoopConfig(trace_path=path_sb,
                                staging_dir=os.path.join(work, "staging"),
                                live_path=live, min_new_rows=64))
    t0 = time.time()
    rep = loop.run_once()
    loop_s = time.time() - t0
    k10 = dict(KB.LAUNCHES)
    if rep.get("status") != "promoted" or not rep["gate"]["bootstrap"]:
        raise AssertionError(f"[25c] the loop's first run: {rep}")
    steps = info["bc_epochs"] + info.get("ft_epochs", 0)
    if k10_train["learned_train"] != steps or k10["learned_train"] <= steps:
        raise AssertionError(f"[25c] K10 launched {k10_train} in train() "
                             f"of {steps} steps, {nonzero(k10)} with the "
                             "loop")
    m = len(ds)
    ones = np.ones_like(ds.y)
    k10_held = [hold_k10(torch, errs, mm, dims, seed, entries, path, k10,
                         data=data)
                for mm, dims, seed, path, data in (
                    (m, (9, 8, 1), 1, "the dataset of 25a",
                     (ds.x, ds.y, ones)),
                    (1 << 20, (9, 8, 1), 2, "synthetic rows", None),
                    (m, (9, 64, 64, 1), 3, "the dataset of 25a",
                     (ds.x, ds.y, ones)),
                    (1 << 20, (9, 64, 64, 1), 4, "synthetic rows", None))]
    turns = train_turns(torch, ds, TrainConfig(
        meta={"version": 2, "source": "chip_smoke"}))
    log(f"[25c] the dataset from 25a's export: {m} rows "
        f"(meta {ds.meta}); train() on the card (K10, "
        f"{info['bc_epochs']} + {info.get('ft_epochs', 0)} epochs): "
        f"{train_s:.2f} s, loss {info['bc_loss_first']} -> "
        f"{info['bc_loss_last']} (fine-tune {info.get('ft_loss_first')} "
        f"-> {info.get('ft_loss_last')}); LearnLoop.run_once: "
        f"{rep['status']} (bootstrap), generation {rep['generation']}, "
        f"version {rep['version']}, {rep['examples']} examples, train "
        f"regret {rep.get('train_regret')}, {loop_s:.2f} s; K10 launches "
        f"{k10_train['learned_train']} in train() (one a step), "
        f"{k10['learned_train']} with the loop; " + "; ".join(k10_held)
        + f"; {turns}; " + ptxas_text("learned_train", "k10_"))

    # ---- 25d. the learned drain under the promoted checkpoint
    builds = [0]
    real_build, real_launch = KB.build_all, S.launch_batch
    n_launch = [0]
    v_promoted = rep["version"]

    def build(*a, **kw):
        builds[0] += 1
        return real_build(*a, **kw)

    def launch(*a, **kw):
        out = real_launch(*a, **kw)
        n_launch[0] += 1
        if n_launch[0] == 2:
            # a second publish mid-drain: train()'s params, the next
            # version
            CK.save_checkpoint(live, params, meta={
                **info, "version": CK.next_version(live)})
            t = time.time() + 5
            os.utime(live, (t, t))
        return out

    cfg = W.learned_config(live, tie_seed=tie_seed)
    KB.build_all, S.launch_batch = build, launch
    try:
        res_d, ld, wall_d, st_d, gc_d = drain(
            W.scheduling_basic(), cfg,
            ("auction_score_argmax", "auction_export", "learned_mlp"))
    finally:
        KB.build_all, S.launch_batch = real_build, real_launch
    mgr = st_d["mgr"]
    if mgr.version != v_promoted + 1 or mgr.reloads != 1 or builds[0]:
        raise AssertionError(f"[25d] scorer version {mgr.version}, "
                             f"{mgr.reloads} reloads, {builds[0]} builds")
    lm = st_d["sched"].metrics.learned_magnitude
    log(f"[25d] {res_d['name']} learned (LearnedScore 1.0, the promoted "
        f"generation {rep['generation']}) on {card}: all "
        f"{len(st_d['pods'])} pods bound, no node overcommitted; "
        f"{line(res_d, ld, wall_d, gc_d)}; the loop's checkpoint (version "
        f"{v_promoted}) loaded at the first sync, train()'s published "
        f"after launch 2 picked up (version {mgr.version}, "
        f"{mgr.reloads} reload, no kernel rebuilt); learned magnitude "
        f"observed {lm.count()} times, median "
        f"{lm.percentile(50):.4f}")

    # ---- 25e. the collection with the export off and on, in turns
    rates = {"off": [], "on": []}
    for tag in ("off", "on", "on", "off"):
        cfg = (export_cfg(os.path.join(work, f"turn_{len(rates['on'])}"
                                             ".jsonl"))
               if tag == "on" else default_config())
        cfg.tie_break_seed = tie_seed
        r, _, _, _, _ = drain(W.scheduling_basic(), cfg,
                              ("auction_score_argmax",))
        rates[tag].append(r["pods_per_sec"])
    log(f"[25e] {res_a['name']} pods/s with the export off / on, in turns "
        f"(off, on, on, off) on {card}: off {rates['off']}, on "
        f"{rates['on']} (reported, not claimed)")
    shutil.rmtree(work, ignore_errors=True)
    return entries


# ------------------------------ this slice: K1 and K8 redesigned; B0

# B0: device ms a launch from a profiler trace, by kernels-line entry name
# (every kernel not yet redesigned, at each path's inputs); DRAIN_LAUNCHES:
# each counter's launches summed over every drain of the call (the
# harness's run_workload and the PostFilter path, counted as they end);
# K1K8: the K1 and K8 comparisons with the previous design by input
B0: dict = {}
DRAIN_LAUNCHES: dict = {}
K1K8: dict = {}
K1_NAMES = ("p1_pairs", "p1_presence")
K1_PREV_NAMES = ("p1_main", "p1_image_presence")
K8_NAMES = ("dra_feasible",)
# a kernels-line entry's counter where its kernel's name is not one
ENTRY_COUNTER = {"serial_scan_pct": "serial_scan",
                 "auction_score_argmax_learned": "learned_mlp",
                 "serial_scan_learned": "learned_mlp",
                 "serial_scan_export": "serial_scan"}


def add_drain(launches: dict, before: dict | None = None) -> None:
    """Fold one drain's launches (less ``before``) into DRAIN_LAUNCHES."""
    for k, v in launches.items():
        d = v - (before or {}).get(k, 0)
        if d:
            DRAIN_LAUNCHES[k] = DRAIN_LAUNCHES.get(k, 0) + d


# K2a's export pass in the call's drains, by workload: its launches and
# their CTAs ([alike, all, alike with a placed pod, with a placed pod];
# device tensors, summed at the end)
EXPORT_ALIKE: dict = {}
_DRAIN_NAME: list = [None]


def alike_ctas(rin, p: int):
    """One export launch's CTAs of ``p`` pods: [alike, all, alike with a
    placed pod, with a placed pod], a device tensor. Alike as the kernel
    decides (csrc/auction_score_argmax.cu auction_export): every pod of
    the CTA has its first pod's group, nominated row, non-zero request and
    request row, bit for bit."""
    import torch

    b = rin.req.shape[0]
    first = torch.arange(b, device=rin.req.device) // p * p

    def eq(t):
        t = t.reshape(b, -1).contiguous()
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        return (t == t[first]).all(1)

    same = eq(rin.gid) & eq(rin.nominated_row) & eq(rin.nzreq) \
        & eq(rin.req)
    pad = (-b) % p
    same = torch.cat([same, same.new_ones(pad)]).view(-1, p).all(1)
    placed = torch.cat([rin.placed >= 0, same.new_zeros(pad)]) \
        .view(-1, p).any(1)
    return torch.stack([same.sum(), torch.full_like(same.sum(), same.numel()),
                        (same & placed).sum(), placed.sum()])


def alike_text() -> str:
    """EXPORT_ALIKE summed, a workload at a time."""
    out = []
    for name, parts in EXPORT_ALIKE.items():
        a, n, ap, np_ = (int(v) for v in sum(parts).tolist())
        out.append(f"{name}: {len(parts)} launches, {a} of {n} CTAs alike "
                   f"({100.0 * a / max(n, 1):.1f} %), {ap} of the {np_} "
                   f"with a placed pod ({100.0 * ap / max(np_, 1):.1f} %)")
    return "; ".join(out) or "no export launch in a drain"


def count_drains() -> None:
    """Every run_workload of the call folds its launches into
    DRAIN_LAUNCHES (the harness's entry wrapped once), and every export
    launch of a drain its CTAs into EXPORT_ALIKE (K2a's export pass
    wrapped once)."""
    from kubernetes_tpu_torch.kernels import auction as KA
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.perf import harness as H

    real = H.run_workload
    if getattr(real, "counted", False):
        return

    def run_workload(*args, **kw):
        before = dict(KB.LAUNCHES)
        outer = _DRAIN_NAME[0]
        w = args[0] if args else kw.get("w")
        _DRAIN_NAME[0] = getattr(w, "name", "?")
        try:
            return real(*args, **kw)
        finally:
            _DRAIN_NAME[0] = outer
            if kw.get("device", "cuda") != "cpu":
                add_drain(KB.LAUNCHES, before)

    real_e = KA.auction_export

    def auction_export(rin, with_feats, with_alts):
        if _DRAIN_NAME[0] is not None and rin.free.is_cuda and (
                rin.learned is not None or with_feats or with_alts):
            EXPORT_ALIKE.setdefault(_DRAIN_NAME[0], []).append(
                alike_ctas(rin, KA.export_plan(rin).pods))
        return real_e(rin, with_feats, with_alts)

    run_workload.counted = True
    H.run_workload = run_workload
    KA.auction_export = auction_export


def traced_turns(torch, new, old, reps, names_new, names_old,
                 reset=None, rounds=2, keep=None, whole=False) -> tuple:
    """Device ms of one run of ``new`` and of ``old`` from profiler traces
    taken in turns (old, new, new, old, ``rounds`` times; ``reps`` runs a
    trace): the medians; old None without ``old``. Each trace holds one
    design; ``keep`` (a list) receives every trace's (design, ms);
    ``whole`` as in ``trace_ms``."""
    runs: dict = {"new": [], "old": []}
    for tag in (("old", "new", "new", "old") if old else ("new", "new")) \
            * rounds:
        fn, names = (new, names_new) if tag == "new" else (old, names_old)
        ms = trace_ms(torch, fn, reps, reset, names, whole)
        if ms is not None:
            runs[tag].append(ms)
        if keep is not None:
            keep.append((tag, ms))
    new_ms = statistics.median(runs["new"]) if runs["new"] else None
    old_ms = statistics.median(runs["old"]) if runs["old"] else None
    return new_ms, old_ms


def spread_text(runs: list) -> str:
    """Each design's traces of a traced_turns ``keep`` list: least,
    median and most ms, and how many."""
    out = []
    for tag, name in (("new", "this build"), ("old", "the other")):
        ms = sorted(m for t, m in runs if t == tag and m is not None)
        if ms:
            out.append(f"{name} {len(ms)} traces {ms[0]:.5f} / "
                       f"{statistics.median(ms):.5f} / {ms[-1]:.5f}")
    return "least / median / most: " + ", ".join(out)


def previous_ptxas(name: str, entry: str) -> str:
    """ptxas's report of the previous design's build of one source."""
    from kubernetes_tpu_torch.kernels import build as KB

    src = os.path.join(PREVIOUS_DIR, "csrc")
    if not os.path.exists(os.path.join(src, name + ".cu")):
        return "no previous design in this call"
    out = []
    for fn, v in sorted(KB.build_log(name, src).items()):
        if entry in fn and "registers" in v:
            out.append(f"{fn}: {v['registers']} registers, spill stores/"
                       f"loads {v.get('spill_stores', 0)}/"
                       f"{v.get('spill_loads', 0)} B")
    return "; ".join(out) or "no report"


def k1_work(caps, g: int, active, host: bool) -> tuple:
    """K1's bytes — the node columns the launch's active features read
    (labels and their numbers, taints, host ports, images; always the
    allocatable row and three flags), K1's pod words of each group row, the
    outputs (three planes of floats, three of bytes, the counts) and the
    host verdicts — and its operations a pair: the resource compares, the
    validity / name / unschedulable tests with their tolerations, and the
    active features' loops (taints x tolerations, node selectors, required
    and preferred expressions x values, host ports x pod ports, images x
    pod images)."""
    n = caps.nodes
    words = caps.res_cols + 3                      # allocatable, flags
    if "nodeaffinity" in active:
        words += 2 * caps.label_cols
    if "taints" in active:
        words += 3 * caps.node_taints
    if "ports" in active:
        words += 3 * caps.node_ports
    if "images" in active:
        words += 2 * caps.node_images
    pod_words = (caps.res_cols + 1 + caps.sel_terms * caps.sel_exprs
                 + caps.pref_terms * caps.sel_exprs + 3 + 5 * caps.tolerations
                 + 1 + 2 * caps.pod_labels + caps.sel_terms
                 + caps.sel_terms * caps.sel_exprs * (3 + caps.sel_vals)
                 + caps.pref_terms * (1 + caps.sel_exprs * (3 + caps.sel_vals))
                 + 3 * caps.pod_ports + caps.pod_images)
    nbytes = (4 * n * words + 4 * g * pod_words + 15 * g * n
              + 4 * g * (6 + caps.pod_images) + (g * n if host else 0))
    ops = caps.res_cols + 3 + caps.tolerations
    if "taints" in active:
        ops += caps.node_taints * caps.tolerations
    if "nodeaffinity" in active:
        ops += caps.pod_labels + (caps.sel_terms + caps.pref_terms) \
            * caps.sel_exprs * (caps.sel_vals + 2)
    if "ports" in active:
        ops += caps.pod_ports * caps.node_ports
    if "images" in active:
        ops += 2 * caps.pod_images * caps.node_images
    return nbytes, g * n * ops


def time_k1(torch, tag: str, args: tuple, errs, key=None) -> tuple:
    """K1 at one path's inputs (``args`` as phase1_static takes them): the
    plan, each width of a pair forced and the default held exactly
    against the twin (scores within SCORE_TOL), device ms from profiler
    traces in turns with the previous design (and each width alone), the
    wrappers' host us a launch, the events' ms, the twin's ms and the
    work, kept under ``key`` (K1@<tag>) for the kernels line. Returns
    (the line's text, (events ms, twin ms), work, traced ms)."""
    from kubernetes_tpu_torch.kernels import phase1 as K1

    cb, f32, i32, caps, wk, enabled, active, host = args
    g = f32.shape[0]
    want = K1.phase1_static_ref(*args)
    launch = {m: K1.launch_of(caps, g, wk, enabled, active,
                              cb.node_f32.device, m)
              for m in (None, *K1.LANES)}
    for m, ln in launch.items():
        got = ln.run(cb, f32, i32, host)
        torch.cuda.synchronize()
        for field in ("static_ok", "rejects", "unres", "taint_ok",
                      "nodeaff_ok"):
            cmp_exact(f"[7] K1 {tag} mode {m} {field}", getattr(got, field),
                      getattr(want, field))
        for field in ("taint_raw", "aff_raw", "img"):
            err = max_err(getattr(got, field), getattr(want, field))
            errs["phase1_static"] = max(errs["phase1_static"], err)
            if not err <= SCORE_TOL:
                raise AssertionError(f"[7] K1 {tag} mode {m} {field}: max "
                                     f"abs err {err}")
    prev = previous_design() if previous_changed("phase1_static") else None
    new = lambda: K1.phase1_static(*args)  # noqa: E731
    old = (lambda: prev[5]._phase1_kernel(*args)) if prev else None
    turns: list = []
    ms, ms_old = traced_turns(torch, new, old, 20, K1_NAMES, K1_PREV_NAMES,
                              keep=turns)
    widths = {m: trace_ms(torch, lambda m=m: launch[m].run(cb, f32, i32,
                                                           host), 20,
                          names=K1_NAMES) for m in K1.LANES}
    us = host_us(torch, new, lambda: None)
    us_old = host_us(torch, old, lambda: None) if old else None
    times = (cuda_ms(torch, new), cuda_ms(torch, lambda: K1.phase1_static_ref(
        *args), reps=5, warm=1))
    work = k1_work(caps, g, active, host is not None)
    plan = launch[None].plan
    key = key or f"K1@{tag}"
    K1K8[key] = (ms, ms_old, us, us_old)
    B0[key] = ms
    text = (f"K1 at {tag} (G={g}, N={caps.nodes}, active "
            f"{sorted(active) or 'none'}, host verdicts "
            f"{host is not None}): {plan.lanes} lanes a pair, "
            f"{plan.blocks} blocks of {K1.THREADS} threads, every width "
            f"and the default == twin; traced {opt_ms(ms)} ms (by lanes a "
            f"pair: " + ", ".join(f"{m} {opt_ms(v)}" for m, v in
                                  widths.items())
            + f"), the previous design "
            f"{opt_ms(ms_old)} in turns (each trace: "
            + ", ".join(f"{t} {opt_ms(v)}" for t, v in turns)
            + f"); wrapper {us:.1f} host us a launch "
            f"(previous {'-' if us_old is None else format(us_old, '.1f')});"
            f" events {times[0]:.5f} ms, twin {times[1]:.3f} ms; work "
            f"{work[0]} B / {work[1]} operations")
    return text, times, work, ms


def time_k5(torch, args: tuple, launch) -> tuple:
    """K5 at one captured launch (``args`` as topo_statics takes them):
    device ms from profiler traces in turns with the previous design, its
    kernel against the previous design's three stage kernels, then every
    device item of a whole call (the memsets and the inputs' copies
    included); the wrappers' host us (``launch`` is this design's
    prepared launch, run once already). Returns (kernel ms, previous
    ms, whole ms, previous whole ms, host us, previous host us)."""
    from kubernetes_tpu_torch.kernels import topology as KT

    prev = previous_design() if previous_changed("topo_statics") else None
    new = lambda: KT.topo_statics(*args)  # noqa: E731
    old = (lambda: prev[7]._topo_kernel(*args)) if prev else None
    ms, ms_old = traced_turns(torch, new, old, 20, ("topo_statics_kernel",),
                              KT.STAGES)
    whole, whole_old = traced_turns(torch, new, old, 20, None, None)
    us = host_us(torch, new, lambda: None)
    us_old = host_us(torch, old, lambda: None) if old else None
    return ms, ms_old, whole, whole_old, us, us_old


def opt_ms(v) -> str:
    return "-" if v is None else format(v, ".5f")


def time_k8(torch, tag: str, st, dra, host) -> tuple:
    """K8 at one drain's first call: traced device ms in turns with the
    previous design, the wrappers' host us, the plan. Returns (text,
    traced ms)."""
    from kubernetes_tpu_torch.kernels import dra as KD

    prev = previous_design() if previous_changed("dra_feasible") else None
    new = lambda: KD.fuse_phase1(st, dra, host)  # noqa: E731
    old = (lambda: prev[6].fuse_phase1(st, dra, host)) if prev else None
    ms, ms_old = traced_turns(torch, new, old, 20, K8_NAMES, K8_NAMES)
    us = host_us(torch, new, lambda: None)
    us_old = host_us(torch, old, lambda: None) if old else None
    b, n = st.shape
    d, q = dra.dev_valid.shape[1], dra.req_mask.shape[1]
    plan = KD.plan_dra(b, n, d, q)
    K1K8[f"K8@{tag}"] = (ms, ms_old, us, us_old)
    B0[f"K8@{tag}"] = ms
    return (f"K8 at {tag} (B={b}, N={n}, D={d}, Q={q}; {plan.nt} nodes x "
            f"{plan.pods} pods a block, {plan.blocks} blocks, {plan.smem} "
            f"B): traced {opt_ms(ms)} ms, the previous design "
            f"{opt_ms(ms_old)} in turns; wrapper {us:.1f} host us a launch "
            f"(previous {'-' if us_old is None else format(us_old, '.1f')})",
            ms)


def cmp_k1_exact(errs, tag, got, want) -> None:
    """K1's masks and counts exact, its raw scores within SCORE_TOL."""
    for field in ("static_ok", "rejects", "unres", "taint_ok", "nodeaff_ok"):
        cmp_exact(f"{tag} {field}", getattr(got, field), getattr(want, field))
    for field in ("taint_raw", "aff_raw", "img"):
        err = max_err(getattr(got, field), getattr(want, field))
        errs["phase1_static"] = max(errs["phase1_static"], err)
        if not err <= SCORE_TOL:
            raise AssertionError(f"{tag} {field}: max abs err {err} > "
                                 f"{SCORE_TOL}")


def hold_k1_fuzz(torch, errs) -> str:
    """3: K1 against its twin on a seeded cluster of 5,000 nodes (bucket
    8,192) with taints, labels, host ports and images and 8 pod rows
    using every feature: the default plan and each width of a pair
    forced, with and without host verdicts, at G = 8 and at G = 1."""
    from kubernetes_tpu_torch.kernels import phase1 as K1
    from kubernetes_tpu_torch.models import pipeline as P

    dev = torch.device("cuda")
    mirror, caps, pods = fuzz_mirror(torch, 11, 5000, 8192, 8, 8)
    spec = mirror.prepare_launch(pods, 8)
    assert set(spec.active) == {"nodeaffinity", "taints", "ports",
                                "images"}, spec.active
    wk = mirror.well_known()
    enabled = (True,) * K1.NUM_STATIC
    gen = torch.Generator(device="cpu").manual_seed(3)
    done = []
    for g in (8, 1):
        rows = torch.arange(g, device=dev)
        f32, i32 = P.full_pod_rows(spec.pblobs, spec.ptmpl, caps,
                                   spec.pfields, rows)
        host = (torch.rand((g, caps.nodes), generator=gen) < 0.9).to(dev)
        for h in (None, host):
            args = (spec.cblobs, f32, i32, caps, wk, enabled, spec.active, h)
            want = K1.phase1_static_ref(*args)
            got = K1.phase1_static(*args)
            torch.cuda.synchronize()
            cmp_k1_exact(errs, f"[3] K1 G={g} host={h is not None}", got,
                         want)
            for lanes in K1.LANES:
                ln = K1.launch_of(caps, g, wk, enabled, spec.active,
                                  f32.device, lanes)
                got = ln.run(spec.cblobs, f32, i32, h)
                torch.cuda.synchronize()
                cmp_k1_exact(errs, f"[3] K1 G={g} host={h is not None} "
                             f"{lanes} lanes a pair", got, want)
        plan = K1.launch_of(caps, g, wk, enabled, spec.active,
                            f32.device).plan
        done.append(f"G={g}: {int(want.static_ok.sum())} feasible pairs, "
                    f"rejects {want.rejects.sum(0).tolist()}, default "
                    f"{plan.lanes} lanes a pair")
    return (f"[3] K1 phase1_static == twin on N=8192 with every feature, "
            f"the default plan and each width of a pair (1, 2, 4, 8 lanes) "
            f"forced, with and without host verdicts: {'; '.join(done)} "
            f"(max score err "
            f"{errs['phase1_static']:g}); "
            + ptxas_text("phase1_static", "p1_"))


def hold_k8_caps(torch, errs) -> str:
    """18b: K8 against its twin at the lifted caps, launches on seeded
    DRA fuzz: D = 8,192 devices a node over 300 nodes (bucket 512, B = 64,
    Q = 4) and B = 70,000 pods over 4 nodes (D = 8, Q = 2), with and
    without host verdicts; dra_ok, dra_reject and the ANDed mask exact."""
    from kubernetes_tpu_torch import convert
    from kubernetes_tpu_torch.kernels import dra as KD
    from kubernetes_tpu_torch.ops import dra as OD
    from kubernetes_tpu_torch.perf.fuzz import dra_fuzz

    done = []
    for i, (n_nodes, n_cap, d, q, b) in enumerate(((300, 512, 8192, 4, 64),
                                                   (4, 4, 8, 2, 70000))):
        f = dra_fuzz(np.random.default_rng(190 + i), n_nodes, n_cap, d, q, b)
        dra = convert.dra_batch_from_numpy(
            **{k: f[k] for k in DRA_FIELDS}, device="cuda")
        st = torch.from_numpy(f["static_ok"]).cuda()
        host = torch.from_numpy(f["host_ok"]).cuda()
        want_ok = OD.batch_feasible(dra)
        for host_t in (None, host):
            out, rej, ok = KD.fuse_phase1(st, dra, host_t, want_dra_ok=True)
            w_out, w_rej = OD.fuse_phase1(st, dra, host_t)
            torch.cuda.synchronize()
            tag = (f"[18b] K8 N={n_nodes} D={d} Q={q} B={b} "
                   f"host={host_t is not None}")
            cmp_exact(f"{tag} dra_ok", ok, want_ok)
            cmp_exact(f"{tag} static_ok", out, w_out)
            cmp_exact(f"{tag} dra_reject", rej, w_rej)
        errs["dra_feasible"] = 0.0
        plan = KD.plan_dra(b, n_cap, d, q)
        ms = trace_ms(torch, lambda: KD.fuse_phase1(st, dra), 5,
                      names=K8_NAMES)
        done.append(f"N={n_nodes} (bucket {n_cap}) D={d} Q={q} B={b}: "
                    f"{int(want_ok.sum())} of {want_ok.numel()} pairs "
                    f"feasible, dra_reject sum {int(w_rej.sum())}; "
                    f"{plan.blocks} blocks of {plan.nt} nodes x {plan.pods} "
                    f"pods; traced {opt_ms(ms)} ms")
    return (f"[18b] K8 at the lifted caps == twin exactly (the previous "
            f"design refused D > 4096 and B > 65535; the limit left: Q <= "
            f"{KD.max_requests()} request slots a pod): " + "; ".join(done))


# ------------------------- chain-surviving churn: K11 and the churn drains

# K11's captured first call on each churn drain, by path: (free, nzr, the
# set rows, the add rows), for its kernels-line entry; K11_LAUNCHES: K11's
# launches in the drain that made that call, by path
K11_CALLS: dict = {}
K11_LAUNCHES: dict = {}
K11_NAMES = ("chain_patch",)
K11_ROWS = (1, 3, 17, 256)


def copy_rows(rows) -> list:
    return [(int(i), np.array(f, np.float32), np.array(z, np.float32))
            for i, f, z in rows]


@contextlib.contextmanager
def capturing_k11(path: str):
    """Around one drain whose launch counters were zeroed just before:
    keep a copy of the first K11 call's inputs on the card (the wrapper
    as models/pipeline.py calls it) under K11_CALLS[path], and K11's
    launches in the drain that made it under K11_LAUNCHES[path]. Yields
    this drain's K11 calls on the card and their set and add rows."""
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import chain as KC

    real, seen = KC.chain_patch, {"calls": 0, "sets": 0, "adds": 0}
    fresh = path not in K11_CALLS

    def chain_patch(free, nzr, set_rows=(), add_rows=()):
        if free.is_cuda:
            if path not in K11_CALLS:
                K11_CALLS[path] = (free.clone(), nzr.clone(),
                                   copy_rows(set_rows), copy_rows(add_rows))
            seen["calls"] += 1
            seen["sets"] += len(set_rows)
            seen["adds"] += len(add_rows)
        return real(free, nzr, set_rows, add_rows)

    KC.chain_patch = chain_patch
    try:
        yield seen
    finally:
        KC.chain_patch = real
    if fresh and path in K11_CALLS:
        K11_LAUNCHES[path] = KB.LAUNCHES["chain_patch"]


def k11_work(n: int, r: int, s: int, a: int) -> tuple:
    """K11's bytes (the input chain read once, the output chain written
    once, the patches read once) and operations (one add an added
    element)."""
    return (2 * n * (r + 2) * 4 + (s + a) * (r + 3) * 4, a * (r + 2))


def k11_lists(rng, n: int, r: int, k: int, mode: str) -> tuple:
    """K11's (set rows, add rows), the reference's ``(row, free_row,
    nzr_row)`` tuples, for ``k`` rows of one mode: sets only, adds only,
    both (k of each, distinct rows) or a node removal (k zero rows set)."""
    rows = rng.permutation(n)[:2 * k]
    s = k if mode in ("set", "both", "remove") else 0
    a = k if mode in ("add", "both") else 0

    def row(i, zero=False):
        f, z = (rng.normal(0, 500, w).astype(np.float32) for w in (r, 2))
        return (int(i), np.zeros_like(f), np.zeros_like(z)) if zero else (
            int(i), f, z)

    return ([row(i, mode == "remove") for i in rows[:s]],
            [row(i) for i in rows[k:k + a]])


def k11_twin(torch, free, nzr, sets, adds):
    """The twin (ops/chain.py) on the card, on the same lists."""
    from kubernetes_tpu_torch.ops.chain import patch_chain_ref

    dev, r = free.device, free.shape[1]

    def cols(rows):
        return (torch.tensor([i for i, _f, _z in rows], dtype=torch.int64,
                             device=dev),
                torch.from_numpy(np.asarray([f for _i, f, _z in rows],
                                            np.float32).reshape(-1, r)
                                 ).to(dev),
                torch.from_numpy(np.asarray([z for _i, _f, z in rows],
                                            np.float32).reshape(-1, 2)
                                 ).to(dev))

    return patch_chain_ref(free, nzr, *cols(sets), *cols(adds))


def cmp_bits(name, a, b) -> None:
    """Bit for bit: equal shapes and equal f32 bit patterns."""
    import torch

    if a.shape != b.shape or not a.view(torch.int32).equal(
            b.view(torch.int32)):
        raise AssertionError(f"{name}: kernel and twin differ")


def k11_first_use(torch) -> str:
    """2b: K11's first use in this process, before any drain folds, in
    parts, each synchronised: a pageable upload of K11's patch buffer on
    a fresh tensor, the library's load (KB.library: the kernels are
    built already), the first call on a tiny chain (1 set + 1 add at 64
    nodes; the first launch loads the kernel's module), then the same
    call twice more. The candidates for the first fold's cost, which a
    drain would otherwise pay inside its measured phase."""
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import chain as KC

    free = torch.zeros((64, 8), device="cuda")
    nzr = torch.zeros((64, 2), device="cuda")
    sets, adds = k11_lists(np.random.default_rng(2), 64, 8, 1, "both")
    buf = KC.pack_patches(64, 8, sets, adds)[0]
    torch.cuda.synchronize()
    ms = []
    for step in (lambda: torch.from_numpy(buf.copy()).to(
                     "cuda", non_blocking=True),
                 lambda: KB.library("chain_patch"),
                 lambda: KC.chain_patch(free, nzr, sets, adds),
                 lambda: KC.chain_patch(free, nzr, sets, adds),
                 lambda: KC.chain_patch(free, nzr, sets, adds)):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return (f"[2b] K11's first use in this process, ms each, synchronised: "
            f"a pageable upload of its patch buffer {ms[0]:.3f}, the "
            f"library's load {ms[1]:.3f}, the first call (its first "
            f"launch) {ms[2]:.3f}, the second {ms[3]:.3f}, the third "
            f"{ms[4]:.3f}")


def hold_k11(torch, errs) -> str:
    """26: K11 against its twin on the card, bit for bit, over the
    8,192-node bucket at SchedulingBasic's R = 8 and at R = 74, for 1, 3,
    17 and 256 rows of sets only, adds only, both, and a node removal (a
    zero row set); once more on row-strided views of a wider buffer (how
    a blob slice arrives); the inputs unchanged after each launch. Then
    K11's traced time, the events' time, its wrapper's host us, its bound
    by bytes and the twin's time at two shapes."""
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import chain as KC

    n, cases = 8192, 0
    for r in (8, 74):
        rng = np.random.default_rng(r)
        base = torch.from_numpy(
            rng.normal(0, 1000, (n, r + 2 + 5)).astype(np.float32)).cuda()
        free, nzr = base[:, :r], base[:, r + 3:r + 5]
        for strided in (True, False):
            f_in = free if strided else free.contiguous()
            n_in = nzr if strided else nzr.contiguous()
            keep = (f_in.clone(), n_in.clone())
            for k in K11_ROWS:
                for mode in ("set", "add", "both", "remove"):
                    lists = k11_lists(rng, n, r, k, mode)
                    got = KC.chain_patch(f_in, n_in, *lists)
                    want = k11_twin(torch, f_in, n_in, *lists)
                    torch.cuda.synchronize()
                    tag = f"K11 R={r} k={k} {mode}{' strided' if strided else ''}"
                    cmp_bits(f"{tag} free", got[0], want[0])
                    cmp_bits(f"{tag} nzr", got[1], want[1])
                    cmp_bits(f"{tag} input free", f_in, keep[0])
                    cmp_bits(f"{tag} input nzr", n_in, keep[1])
                    cases += 1
    errs["chain_patch"] = 0.0
    times = []
    for r, k, mode in ((8, 3, "both"), (8, 256, "both"), (74, 256, "both")):
        rng = np.random.default_rng(100 + k)
        free = torch.from_numpy(
            rng.normal(0, 1000, (n, r)).astype(np.float32)).cuda()
        nzr = torch.from_numpy(
            rng.normal(0, 1000, (n, 2)).astype(np.float32)).cuda()
        lists = k11_lists(rng, n, r, k, mode)
        kern = lambda: KC.chain_patch(free, nzr, *lists)  # noqa: E731
        twin = lambda: k11_twin(torch, free, nzr, *lists)  # noqa: E731
        tr = trace_ms(torch, kern, 20, names=K11_NAMES)
        ev, tw = in_turns(torch, kern, twin, 10)
        us = host_us(torch, kern, lambda: None)
        nb, ops = k11_work(n, r, k, k)
        bound = max(nb / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        times.append(f"R={r}, {k} sets + {k} adds: traced {opt_ms(tr)} ms, "
                     f"events {ev:.5f}, wrapper {us:.1f} host us, bound "
                     f"{bound:.6f} (bytes), twin {tw:.5f}")
    return (f"[26] K11 (chain_patch) == twin bit for bit on the card over "
            f"{n} rows: {cases} cases (R = 8 and 74; 1, 3, 17, 256 rows; "
            f"sets, adds, both, a removal; contiguous and row-strided "
            f"inputs, never written); {'; '.join(times)}; "
            f"{ptxas_text('chain_patch', 'chain_patch')}; launches "
            f"{KB.LAUNCHES['chain_patch']}")


def k11_entry(torch, errs) -> list:
    """K11's kernels-line entry at the first call it made on the
    full-size SchedulingWithMixedChurn drain (else on the next churn
    drain that made one): traced ms, events ms against the twin's, the
    bound of those inputs by bytes; launches in that drain."""
    from kubernetes_tpu_torch.kernels import chain as KC

    for path in ("SchedulingWithMixedChurn/5000Nodes_10000Pods",
                 "PreemptionAsync/5000Nodes", "GangPreemption/128Nodes",
                 "SchedulingWithMixedChurn/500Nodes_2000Pods"):
        if path in K11_CALLS:
            break
    else:
        raise AssertionError("K11 made no call on any churn drain")
    free, nzr, sets, adds = K11_CALLS[path]
    launches = K11_LAUNCHES[path]
    if launches <= 0:
        raise AssertionError(f"K11 made no launch in {path}'s drain")
    kern = lambda: KC.chain_patch(free, nzr, sets, adds)  # noqa: E731
    twin = lambda: k11_twin(torch, free, nzr, sets, adds)  # noqa: E731
    got, want = kern(), twin()
    cmp_bits(f"K11@{path} free", got[0], want[0])
    cmp_bits(f"K11@{path} nzr", got[1], want[1])
    tr = trace_ms(torch, kern, 20, names=K11_NAMES)
    ev, tw = in_turns(torch, kern, twin, 10)
    n, r = free.shape
    s, a = len(sets), len(adds)
    e = kernel_entry("chain_patch", "chain_patch", path, launches,
                     errs["chain_patch"], (ev, tw), k11_work(n, r, s, a))
    B0[f"chain_patch@{path.split('/')[0]}"] = tr
    log(f"[26] K11 at {path}'s first call (N={n}, R={r}, {s} sets, {a} "
        f"adds) == twin bit for bit: traced {opt_ms(tr)} ms, events "
        f"{ev:.5f}, bound {e['bound_ms']:.6f} ({e['bound_by']}), twin "
        f"{tw:.5f}; K11 launches in that drain {launches}, over the "
        f"call's drains {DRAIN_LAUNCHES.get('chain_patch', 0)}")
    return [e]


def churn_stats(st: dict) -> str:
    """A drain's chain stats and the split of its folds (scheduler.py
    CHAIN_SPLIT), seconds summed over its folds."""
    split = st["chain_split_s"]
    parts = ", ".join(f"{k} {split[k]:.6f}" for k in ("flush", "repack",
                                                      "k11"))
    return (f"chain patches {st['chain_patches']} ({st['chain_patch_rows']} "
            f"node patches, {st['chain_patch_fallbacks']} fallbacks; "
            f"{int(split['folds'])} folds, s: {parts})")


def k11_rows_text(seen: dict) -> str:
    """A drain's K11 calls on the card and the rows they folded: set rows
    are node repacks (Mirror.patch_node), add rows foreign pods' deltas."""
    return (f"{seen['calls']} K11 calls: {seen['sets']} set rows, "
            f"{seen['adds']} add rows")


def pumped_churn(H, every: int = 4):
    """Drive a workload's churn by the drain's pump count (one object
    every ``every`` pumps) instead of the clock, so two runs of one drain
    inject at the same points. Returns the original to restore."""
    real = H._ChurnState.inject

    def inject(self, hub, t):
        self.pumps = getattr(self, "pumps", 0) + 1
        return real(self, hub, self.t0 + self.pumps * self.op.interval_ms
                    / 1000.0 / every)

    H._ChurnState.inject = inject
    return real


def churn_parity(torch) -> str:
    """27: SchedulingWithMixedChurn at 500 nodes (bucket 512) and 2,000
    measured pods (batch 256) on the card and on the CPU under a fake
    clock, a fixed tie-break seed and the churn driven by the pump count:
    identical placements, every measured pod bound, no 9-CPU pod bound,
    the chain patched in both arms and K11 launched on the card."""
    from kubernetes_tpu_torch.config.types import default_config
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.perf import harness as H
    from kubernetes_tpu_torch.perf import workloads as W

    path = "SchedulingWithMixedChurn/500Nodes_2000Pods"
    out = {}
    real = pumped_churn(H)
    try:
        for device in ("cuda", "cpu"):
            w = W.mixed_churn(init_nodes=500, measure_pods=2000)
            w.name, w.node_capacity, w.pod_capacity = path, 512, 4096
            w.batch_size = 256
            cfg = default_config()
            cfg.tie_break_seed = 11
            end: dict = {}
            KB.reset_launches()
            with capturing_k11(path) as seen:
                res = H.run_workload(
                    w, now=fake_clock(), sleep=lambda dt: None,
                    device=device, config=cfg,
                    on_scheduler=lambda s, hub, e=end: e.update(
                        {p.metadata.name: p.spec.node_name
                         for p in hub.list_pods()}))
            out[device] = (end, res, dict(KB.LAUNCHES), seen)
    finally:
        H._ChurnState.inject = real
    (got, res, launches, seen), (want, cres, _l, _s) = out["cuda"], \
        out["cpu"]
    diff = [k for k in want if want[k] != got.get(k)]
    measured = [k for k in got if k.startswith("measure-")]
    if diff or len(got) != len(want) or len(measured) != 2000 \
            or not all(got[k] for k in measured):
        raise AssertionError(f"{path}: {len(diff)} pods bound differently "
                             f"on the card and the CPU")
    if any(v for k, v in got.items() if k.startswith("churn-big-")):
        raise AssertionError(f"{path}: a 9-CPU pod was bound")
    st, cst = res["stats"], cres["stats"]
    if not st["chain_patches"] or launches["chain_patch"] <= 0 \
            or cst["chain_patches"] != st["chain_patches"]:
        raise AssertionError(f"{path}: chain patches card {churn_stats(st)}"
                             f", CPU {churn_stats(cst)}, K11 launches "
                             f"{launches['chain_patch']}")
    on_churn = sum(1 for v in got.values() if v and v.startswith("churn-"))
    return (f"[27] {path}, churn by pump count, card (kernels) against CPU "
            f"(twins): identical placements of all {len(got)} pods "
            f"({res['churn_created']} churn objects, {on_churn} pods on "
            f"churn nodes, no 9-CPU pod bound); card {churn_stats(st)}, CPU "
            f"{churn_stats(cst)}; K11 {launches['chain_patch']} launches "
            f"({k11_rows_text(seen)}), kernel launches {nonzero(launches)}")


def mixed_churn_full(torch, card) -> str:
    """28: SchedulingWithMixedChurn/5000Nodes_10000Pods at the reference's
    full size on the card (the 1 s recreate-churn of a node and a 9-CPU
    priority-10 pod, on the clock), the launch counters zeroed just
    before: every measured pod bound, no 9-CPU pod bound, no node
    overcommitted; pods/s against the floor, the host split, the chain
    stats and K11's launches."""
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.perf import harness as H
    from kubernetes_tpu_torch.perf import workloads as W

    w = W.mixed_churn()
    end: dict = {}
    KB.reset_launches()
    t0, g0 = time.time(), time.perf_counter()
    with capturing_k11(w.name) as seen:
        res = H.run_workload(w, device="cuda", on_scheduler=lambda s, hub:
                             end.update(pods=hub.list_pods(),
                                        nodes=hub.list_nodes()))
    wall = time.time() - t0
    launches = dict(KB.LAUNCHES)
    big = [p for p in end["pods"] if p.metadata.name.startswith("churn-big")]
    if any(p.spec.node_name for p in big):
        raise AssertionError(f"{w.name}: a 9-CPU pod was bound")
    rest = {"pods": [p for p in end["pods"] if p not in big],
            "nodes": end["nodes"]}
    check_bound(rest, len(rest["pods"]), w.name)
    n_measure = w.ops[-1].count
    if res["pods_scheduled"] != n_measure:
        raise AssertionError(f"{w.name}: {res['pods_scheduled']} of "
                             f"{n_measure} measured pods bound")
    missing = [k for k in ("phase1_static", "auction_score_argmax",
                           "auction_accept_commit") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{w.name}: kernels never launched {missing}")
    st = res["stats"]
    split = {k: round(v, 3) for k, v in st["time_s"].items()}
    churn_nodes = sum(1 for n in end["nodes"]
                      if n.metadata.name.startswith("churn-"))
    return (f"[28] {w.name} on {card}: all {n_measure} measured pods bound, no "
            f"9-CPU pod bound, no node overcommitted; measured "
            f"{res['pods_per_sec']} pods/s over {res['elapsed_s']} s "
            f"({floor_text(res)}; {res['vs_baseline']}x the reference's "
            f"265; whole drain {wall:.1f} s); {res['churn_created']} churn "
            f"objects ({churn_nodes} churn node live at the end); "
            f"{st['launches']} launches ({st['chained_launches']} chained); "
            f"{churn_stats(st)}; K11 {launches['chain_patch']} launches "
            f"({k11_rows_text(seen)}); "
            f"host time split s {split}; kernel launches "
            f"{nonzero(launches)}; {gc_since(g0)}")


def preemption_async_repeat(torch, runs: int) -> str:
    """29: PreemptionAsync/5000Nodes drained ``runs`` times on the card
    (no claim: a re-measure beside the chain patches): each run's pods/s,
    floor verdict, sync and chain_patch seconds, chain stats and K11's
    launches, then the median and the spread."""
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.perf import harness as H
    from kubernetes_tpu_torch.perf import workloads as W

    rates, rows = [], []
    for k in range(runs):
        w = W.preemption_async()
        KB.reset_launches()
        t0 = time.time()
        with capturing_k11(w.name):
            res = H.run_workload(w, device="cuda")
        wall = time.time() - t0
        launches = dict(KB.LAUNCHES)
        if res["pods_scheduled"] != w.ops[-1].count:
            raise AssertionError(f"{w.name}: {res['pods_scheduled']} "
                                 "measured pods bound")
        st = res["stats"]
        rates.append(res["pods_per_sec"])
        rows.append(f"run {k + 1}: {res['pods_per_sec']} pods/s "
                    f"({floor_text(res)}; whole drain {wall:.1f} s), sync "
                    f"{st['time_s']['sync']:.3f} s, chain_patch "
                    f"{st['time_s']['chain_patch']:.3f} s, "
                    f"{st['preemptions']} preemptions, {churn_stats(st)}, "
                    f"K11 {launches['chain_patch']}, {st['launches']} "
                    f"launches ({st['chained_launches']} chained)")
    return (f"[29] PreemptionAsync/5000Nodes x{runs}: pods/s {rates}, median "
            f"{statistics.median(rates)}, spread "
            f"{max(rates) - min(rates):.1f}; " + " | ".join(rows))


def churn_path(torch, card, errs) -> list:
    """This section's phases in order (26-29; GangPreemption's five
    drains of phase 16 run before them): K11 against its twin, the churn
    drains and K11's kernels-line entry."""
    log(hold_k11(torch, errs))
    log(churn_parity(torch))
    log(mixed_churn_full(torch, card))
    log(preemption_async_repeat(torch, runs=3))
    return k11_entry(torch, errs)


# ------------------- the data movers: K12 (row scatter), K13 (blob unpack)

# the drain of K12's and K13's kernels-line entries; MOVERS: copies of
# each one's first call on the card in that drain's first run with the
# new route, and their launches in that run (counters zeroed just before)
MOVER_PATH = "SchedulingPreferredPodAffinity/5000Nodes_5000Pods"
MOVERS: dict = {}
K12_NAMES = ("row_scatter",)
K13_NAMES = ("blob_unpack", "blob_unpack_few")
# the H100's host link: PCIe 5.0 x16, 64 GB/s each way (PCI-SIG's rate)
PCIE_BYTES_PER_S = 64e9
# GPU clock cycles torch.cuda._sleep spins in the hazard phase (~0.1 s)
SLEEP_CYCLES = 200_000_000


def row_words(t) -> int:
    return int(np.prod(t.shape[1:]))


def run_count(idx) -> int:
    """Runs of consecutive rows in a sorted index list."""
    return int(idx.size and 1 + np.count_nonzero(np.diff(idx) != 1))


def sizes_text(sizes: list) -> str:
    """K12's launches over a drain by rows a launch: a count by size, the
    rows and runs in all, and the rows of the largest launch."""
    bins = ((1, 1), (2, 8), (9, 64), (65, 512), (513, 2048),
            (2049, 1 << 40))
    per = [sum(r for r, _, _ in launch) for launch in sizes]
    counts = [sum(lo <= p <= hi for p in per) for lo, hi in bins]
    jobs = sum(len(launch) for launch in sizes)
    runs = sum(n for launch in sizes for _, n, _ in launch)
    words = sum(r * w for launch in sizes for r, _, w in launch)
    return (f"{len(sizes)} launches, {jobs} jobs, {sum(per)} rows in "
            f"{runs} runs, {words * 4 / 1e6:.3f} MB; launches by rows "
            + ", ".join(f"{lo}-{hi if hi < 1 << 40 else 'more'}: {c}"
                        for (lo, hi), c in zip(bins, counts))
            + (f"; the largest {max(per)} rows" if per else ""))


def k12_case(rng, m: int, k: int, mode: str) -> np.ndarray:
    """k of m rows: sorted scattered rows, or one run of consecutive
    rows at a random start."""
    if mode == "runs":
        s = int(rng.integers(0, m - k + 1))
        return np.arange(s, s + k, dtype=np.int64)
    return np.sort(rng.choice(m, k, replace=False)).astype(np.int64)


def copy_engine(torch, jobs, span: bool = False):
    """The copy engine on the same pinned blobs: for each job one
    contiguous ``copy_(non_blocking=True)`` into a device scratch, of as
    many rows as the job has (from its first dirty row), or of the span
    its rows cover (``span``). Returns (the function, its bytes)."""
    parts = []
    for j in jobs:
        m = j.src.shape[0]
        lo = int(j.idx.min())
        hi = int(j.idx.max()) + 1 if span else lo + int(j.idx.size)
        if hi > m:
            lo, hi = m - (hi - lo), m
        src = j.src[lo:hi]
        parts.append((torch.empty(src.shape, dtype=src.dtype,
                                  device=j.dst.device), src))

    def fn():
        for dst, src in parts:
            dst.copy_(src, non_blocking=True)

    return fn, sum(src.numel() * 4 for _, src in parts)


def gbps(nbytes: int, ms) -> str:
    return "-" if not ms else f"{nbytes / ms / 1e6:.1f} GB/s"


def k12_sweep(torch) -> str:
    """30b: K12 alone at the three blob widths of the 8,192-node bucket
    (node_f32 74 words, node_i32 275, pods_i32 717 of a 16,384-slot
    table), 1, 64, 1,000 and 2,048 rows, scattered and as one run:
    traced ms of this design, of the previous design in turns (where
    build/previous holds it), and of the copy engine from the same pinned
    blob for the same bytes and for the span the rows cover; each beside
    the bytes over PCIe at 64 GB/s."""
    from kubernetes_tpu_torch.kernels import scatter as KSc
    from kubernetes_tpu_torch.ops.features import Capacities, codecs

    node_c, table_c, _ = codecs(Capacities(nodes=8192, pods=16384))
    rng = np.random.default_rng(30)
    prev = previous_design()
    prev_sc = prev[8] if prev is not None else None
    out = []
    for key, shape in (("node_f32", (8192, node_c.f32_size)),
                       ("node_i32", (8192, node_c.i32_size)),
                       ("pods_i32", (16384, table_c.i32_size))):
        host = KSc.pin(rng.integers(-2**31, 2**31, shape, dtype=np.int64
                                    ).astype(np.int32))
        dev = torch.zeros(shape, dtype=torch.int32, device="cuda")
        for k in (1, 64, 1000, 2048):
            for mode in ("scattered", "runs"):
                jobs = [KSc.Rows(dev, host, k12_case(rng, shape[0], k,
                                                     mode))]
                new = lambda j=jobs: KSc.scatter_rows(j)  # noqa: E731
                old = (None if prev_sc is None else
                       lambda j=jobs: prev_sc.scatter_rows(j))
                tr, tr_old = traced_turns(torch, new, old, 10, K12_NAMES,
                                          K12_NAMES, rounds=1)
                ce, nbytes = copy_engine(torch, jobs)
                ce_ms = trace_ms(torch, ce, 10, whole=True)
                cs, span_bytes = copy_engine(torch, jobs, span=True)
                cs_ms = trace_ms(torch, cs, 10, whole=True)
                bound = nbytes / PCIE_BYTES_PER_S * 1e3
                out.append(
                    f"{key} {k} {mode} ({nbytes} B, runs "
                    f"{run_count(jobs[0].idx)}): K12 {opt_ms(tr)} "
                    f"({gbps(nbytes, tr)}), previous {opt_ms(tr_old)} "
                    f"({gbps(nbytes, tr_old)}); copy "
                    f"engine same bytes {opt_ms(ce_ms)} "
                    f"({gbps(nbytes, ce_ms)}), span {span_bytes} B "
                    f"{opt_ms(cs_ms)} ({gbps(span_bytes, cs_ms)}); bound "
                    f"{bound:.5f}")
        del host
    return ("[30b] K12 by width, rows and pattern, traced ms (this "
            "design; the previous design in turns; the copy engine from "
            "the same pinned blob): "
            + " | ".join(out))


def k12_work(jobs) -> tuple:
    """K12's bytes by link: (read from pinned host memory over PCIe: the
    rows and their indices; written to HBM: the rows)."""
    host = sum(j.idx.size * (row_words(j.dst) + 1) * 4 for j in jobs)
    return host, sum(j.idx.size * row_words(j.dst) * 4 for j in jobs)


def k12_bound_ms(jobs) -> float:
    host, hbm = k12_work(jobs)
    return max(host / PCIE_BYTES_PER_S, hbm / HBM_BYTES_PER_S) * 1e3


def previous_push(torch, jobs) -> None:
    """The route K12 replaced, and the library call beside it: per buffer,
    the dirty rows gathered on the host, a pageable upload of them and of
    their indices, and ``index_copy_``."""
    for dst, src, idx in jobs:
        host = src.numpy()
        dst.index_copy_(0, torch.from_numpy(idx).to(dst.device),
                        torch.from_numpy(host[idx]).to(dst.device))


def copy_jobs(jobs) -> list:
    """Jobs on copies: the device buffers cloned, the host rows pinned
    anew, the indices copied (the Mirror's own go on changing)."""
    from kubernetes_tpu_torch.kernels import scatter as KSc

    return [KSc.Rows(j.dst.clone(), KSc.pin(j.src.numpy()), j.idx.copy())
            for j in jobs]


def cmp_field(name, a, b) -> None:
    """Bit for bit, bools as values."""
    import torch

    if a.dtype == torch.bool:
        cmp_exact(name, a, b)
    else:
        cmp_bits(name, a, b)


def c_plan(jobs) -> np.ndarray:
    """The launch entry's own planner (csrc/row_scatter.cu
    row_scatter_plan) on ``jobs`` as kernels/scatter.py plan_chunks takes
    them: its int64 [chunks, 3] rows (a negative code raises)."""
    import ctypes

    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import scatter as KSc

    rows = np.zeros((len(jobs), len(KSc._ScatterJob._fields_)), np.int64)
    keep = [np.ascontiguousarray(j[0], np.int64) for j in jobs]
    cap = 0
    for k, (idx, (_, width, ss, ds, sb, db)) in enumerate(zip(keep, jobs)):
        rows[k] = (idx.ctypes.data, idx.size, width, ss, ds, sb, db,
                   int(idx[-1]) + 1)
        cap += idx.size * -(-width // KSc.CHUNK_WORDS)
    out = np.zeros((max(cap, 1), 3), np.int64)
    fn = KB.library("row_scatter").row_scatter_plan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_long]
    fn.restype = ctypes.c_long
    n = fn(rows.ctypes.data, len(jobs), out.ctypes.data, cap)
    if n < 0:
        raise AssertionError(f"row_scatter_plan: code {n}")
    return out[:n]


def hold_k12(torch, errs) -> str:
    """30: K12 against its twin's route on the card, bit for bit, at the
    8,192-node bucket (a 16,384-slot table): the three blobs' dirty rows
    in one launch, 1, 64, 1,000 and 2,048 rows each, scattered and as one
    run, read from pinned host buffers; the victim cumsum of the
    PostFilter path (N = 8,192, K+1 = 9, C = 4) and a wider one (17, 8);
    a source whose rows are strided (each row its own span); an unsorted
    list (sorted on the host, then planned again); a duplicate and an
    out-of-range row, and a source in pageable memory (after a pinned
    one was launched from), refused with ValueError and no launch. Each
    launch's work list from the entry's C planner equals plan_chunks'."""
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import scatter as KSc
    from kubernetes_tpu_torch.ops.features import Capacities, codecs

    node_c, table_c, _ = codecs(Capacities(nodes=8192, pods=16384))
    rng = np.random.default_rng(12)

    def blob(shape, f32):
        if f32:
            return rng.normal(0, 1000, shape).astype(np.float32)
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
            np.int32)

    # each buffer's device copy and pinned host rows, made once
    bufs = {key: (torch.from_numpy(blob(shape, f32)).cuda(),
                  KSc.pin(blob(shape, f32)))
            for key, shape, f32 in (
                ("node_f32", (8192, node_c.f32_size), True),
                ("node_i32", (8192, node_c.i32_size), False),
                ("pods_i32", (16384, table_c.i32_size), False),
                ("cumsum 9x4", (8192, 9, 4), True),
                ("cumsum 17x8", (8192, 17, 8), True))}
    wide = KSc.pin(blob((8192, node_c.f32_size + 3), True))
    bufs["node_f32 strided"] = (bufs["node_f32"][0],
                                wide[:, :node_c.f32_size])
    cases = planned = 0

    def held(tag, jobs):
        nonlocal cases, planned
        plan = [(np.sort(j.idx), row_words(j.dst), int(j.src.stride(0)),
                 int(j.dst.stride(0)), KSc._mapped(j.src), j.dst.data_ptr())
                for j in jobs]
        if not np.array_equal(c_plan(plan), KSc.plan_chunks(plan)):
            raise AssertionError(f"K12 {tag}: the C planner differs from "
                                 f"plan_chunks")
        planned += len(KSc.plan_chunks(plan))
        got = [KSc.Rows(j.dst.clone(), j.src, j.idx) for j in jobs]
        want = [KSc.Rows(j.dst.clone(), j.src, np.sort(j.idx))
                for j in jobs]
        KSc.scatter_rows(got)
        previous_push(torch, want)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            cmp_bits(f"K12 {tag}", g.dst, w.dst)
        cases += 1

    for k in (1, 64, 1000, 2048):
        for mode in ("scattered", "runs"):
            for group in (("node_f32", "node_i32", "pods_i32"),
                          ("cumsum 9x4",), ("cumsum 17x8",),
                          ("node_f32 strided",)):
                held(f"{group} k={k} {mode}",
                     [KSc.Rows(bufs[key][0], bufs[key][1],
                               k12_case(rng, bufs[key][0].shape[0], k, mode))
                      for key in group])
    dev, host = bufs["node_i32"]
    held("unsorted", [KSc.Rows(dev, host, rng.permutation(
        k12_case(rng, 8192, 500, "scattered")))])
    before = KB.LAUNCHES["row_scatter"]
    for bad in (np.asarray([3, 9, 9, 12], np.int64),
                np.asarray([3, 9, 8192], np.int64),
                np.asarray([12, 3, 3], np.int64)):
        try:
            KSc.scatter_rows([KSc.Rows(dev, host, bad)])
        except ValueError:
            continue
        raise AssertionError(f"K12 took the rows {bad.tolist()}")
    pageable = torch.from_numpy(host.numpy().copy())
    try:
        KSc.scatter_rows([KSc.Rows(dev, pageable, np.arange(4))])
        raise AssertionError("K12 took a source that is not pinned")
    except ValueError:
        pass
    if KB.LAUNCHES["row_scatter"] != before:
        raise AssertionError("K12 launched on a refused list or source")
    errs["row_scatter"] = 0.0
    return (f"[30] K12 (row_scatter) == its twin's route bit for bit on the "
            f"card: {cases} launches ({planned} chunks; the three blobs at "
            f"the 8,192-node bucket in one launch, widths {node_c.f32_size} "
            f"/ {node_c.i32_size} / {table_c.i32_size} words; the victim "
            f"cumsum 8,192 x 9 x 4 and 8,192 x 17 x 8; a strided source; 1, "
            f"64, 1,000 and 2,048 rows, scattered and as one run; an "
            f"unsorted list; read from the pinned host buffers); the entry's "
            f"C planner == plan_chunks in every launch; a duplicate and an "
            f"out-of-range row, and a pageable source, refused, no launch; "
            f"{ptxas_text('row_scatter', 'row_scatter')}")


def hold_k13(torch, errs) -> str:
    """31: K13 against its twin's views on the card, bit for bit, on the
    seeded topology cluster (5,000 nodes in the 8,192 bucket, a
    16,384-slot table holding 12,000 pods): the chain's seed, every
    ClusterTensors field (Mirror.to_device) and every PodFeatures field of
    a full-schema batch of 256 (Mirror.pack_batch); each a contiguous
    tensor of its own."""
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.models import pipeline as P
    from kubernetes_tpu_torch.ops.features import unpack_cluster, unpack_pods

    mirror, caps, pods = topology_mirror(torch, 31, 12000, 4, 256)
    cblobs = mirror.to_blobs()
    before = KB.LAUNCHES["blob_unpack"]
    seed = P.extract_state(cblobs, caps)
    views = unpack_cluster(cblobs, caps)
    ct = mirror.to_device()
    pf = mirror.pack_batch(pods, 256)
    want_pf = unpack_pods(mirror.pack_batch_blobs(pods, 256), caps)
    torch.cuda.synchronize()
    cmp_bits("K13 seed free", seed[0], views.free)
    cmp_bits("K13 seed nzr", seed[1], views.nonzero_requested)
    n = 2
    for got, want in ((ct, views), (pf, want_pf)):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if not a.is_contiguous():
                raise AssertionError(f"K13 {f.name}: not contiguous")
            cmp_field(f"K13 {f.name}", a, b)
            n += 1
    for t in seed:
        if t.untyped_storage().data_ptr() == \
                cblobs.node_f32.untyped_storage().data_ptr():
            raise AssertionError("K13 seed: shares the blob's storage")
    errs["blob_unpack"] = 0.0
    return (f"[31] K13 (blob_unpack) == its twin's views bit for bit on the "
            f"card: the seed (free, nonzero_requested), "
            f"{len(dataclasses.fields(ct))} ClusterTensors fields (N=8192, "
            f"PT=16384) and {len(dataclasses.fields(pf))} PodFeatures "
            f"fields (B=256), {n} fields in "
            f"{KB.LAUNCHES['blob_unpack'] - before} launches; "
            f"{ptxas_text('blob_unpack', 'blob_unpack')}")


def hazard(torch) -> str:
    """32: the pinned host blobs' fence, and K12's in-place write against
    a reader queued before it. Over 5,000 nodes (bucket 8,192), 8 nodes'
    rows are repacked on the host (one bound pod each) and pushed by K12
    behind a ~0.1 s torch.cuda._sleep, after a copy of the device blob
    queued behind the same sleep; then the same rows are repacked again
    on the host at once, and the card is synchronised. The device must
    hold the pushed rows, not the later ones; the copy the old rows; and
    the Mirror must have counted one fence wait."""
    from kubernetes_tpu_torch.backend.cache import Cache
    from kubernetes_tpu_torch.backend.mirror import Mirror
    from kubernetes_tpu_torch.backend.snapshot import Snapshot
    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.kernels import scatter as KSc
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.perf import workloads as W

    cache = Cache()
    for i in range(5000):
        cache.add_node(W._node(i))
    snap = Snapshot()
    cache.update_snapshot(snap)
    mirror = Mirror(caps=Capacities(nodes=8192, pods=16384),
                    device=torch.device("cuda"))
    mirror.sync(snap)
    mirror.to_blobs()
    torch.cuda.synchronize()
    names = [f"node-{i}" for i in range(0, 4000, 500)]
    rows = np.asarray([mirror.row_of(n) for n in names], np.int64)

    def bind(tag):
        for j, name in enumerate(names):
            pod = W._pod(f"hazard-{tag}-{j}")
            pod.spec.node_name = name
            cache.add_pod(pod)
        cache.update_snapshot(snap)
        mirror.sync(snap)

    old = {k: getattr(mirror, k)[rows].copy() for k in ("node_f32",
                                                         "node_i32")}
    bind("a")
    pushed = {k: getattr(mirror, k)[rows].copy() for k in old}
    launches = KB.LAUNCHES["row_scatter"]
    torch.cuda._sleep(SLEEP_CYCLES)
    reader = {k: mirror._dev[k].clone() for k in old}
    mirror.to_blobs()
    queued = KB.LAUNCHES["row_scatter"] - launches
    held = KSc.in_flight()
    t0 = time.perf_counter()
    bind("b")
    bind_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    for k in old:
        dev = mirror._dev[k][torch.from_numpy(rows).cuda()].cpu().numpy()
        later = getattr(mirror, k)[rows]
        seen = reader[k][torch.from_numpy(rows).cuda()].cpu().numpy()
        if not np.array_equal(dev.view(np.int32), pushed[k].view(np.int32)):
            raise AssertionError(f"hazard {k}: the device does not hold the "
                                 f"pushed rows")
        # a bound pod moves the rows' f32 columns (free, nzr) only
        if k == "node_f32" and (
                np.array_equal(later.view(np.int32), pushed[k].view(np.int32))
                or np.array_equal(old[k].view(np.int32),
                                  pushed[k].view(np.int32))):
            raise AssertionError(f"hazard {k}: a repack did not change the "
                                 f"rows")
        if not np.array_equal(seen.view(np.int32), old[k].view(np.int32)):
            raise AssertionError(f"hazard {k}: the reader queued before "
                                 f"K12 saw the pushed rows")
    st = mirror.stats
    if queued != 1 or st["fence_waits"] != 1:
        raise AssertionError(f"hazard: {queued} K12 launches, "
                             f"{st['fence_waits']} fence waits")
    return (f"[32] hazard: 8 node rows pushed by one K12 launch behind a "
            f"torch.cuda._sleep of {SLEEP_CYCLES} cycles (pinned inputs "
            f"of {held} launch(es) kept alive meanwhile), the same rows "
            f"repacked at once on the host: the repack waited "
            f"{st['fence_wait_us']:.0f} host us on the fence (1 wait "
            f"counted; the repack took {bind_ms:.1f} ms), the device holds "
            f"the pushed rows, not the later ones, and a copy of the blob "
            f"queued before K12 holds the old rows")


@contextlib.contextmanager
def previous_route():
    """The Mirror's push and the chain's seed as they were before K12 and
    K13 (a measurement; the port never does this): whole uploads from
    pageable numpy, dirty rows gathered on the host and uploaded pageable
    into an ``index_copy_``, and the seed as views of the blob that each
    launch copies."""
    import torch

    from kubernetes_tpu_torch import scheduler as S
    from kubernetes_tpu_torch.backend import mirror as M
    from kubernetes_tpu_torch.ops.features import ClusterBlobs, unpack_cluster

    def to_blobs(self):
        full_node = self._dirty_full["node"]
        for key, dirty, full in (
                ("node_f32", self._dirty_rows, full_node),
                ("node_i32", self._dirty_rows, full_node),
                ("pods_i32", self._dirty_slots, self._dirty_full["pods"])):
            host, dev = getattr(self, key), self._dev.get(key)
            if dev is None or full or len(dirty) > max(64,
                                                       host.shape[0] // 4):
                self._dev[key] = torch.tensor(host, device=self.device)
            elif dirty:
                arr = np.asarray(sorted(dirty), np.int64)
                dev.index_copy_(0, torch.from_numpy(arr).to(self.device),
                                torch.from_numpy(host[arr]).to(self.device))
        self._dirty_full = {"node": False, "pods": False}
        self._dirty_rows.clear()
        self._dirty_slots.clear()
        return ClusterBlobs(node_f32=self._dev["node_f32"],
                            node_i32=self._dev["node_i32"],
                            pods_i32=self._dev["pods_i32"])

    def extract_state(cblobs, caps):
        ct = unpack_cluster(cblobs, caps)
        return ct.free, ct.nonzero_requested

    real = (M.Mirror.to_blobs, S.extract_state)
    M.Mirror.to_blobs, S.extract_state = to_blobs, extract_state
    try:
        yield
    finally:
        M.Mirror.to_blobs, S.extract_state = real


@contextlib.contextmanager
def capturing_movers():
    """Around the named drain's first run with the new route, launch
    counters zeroed just before: copies of K12's and K13's first calls on
    the card (MOVERS["k12"], MOVERS["k13"])."""
    from kubernetes_tpu_torch.kernels import scatter as KSc
    from kubernetes_tpu_torch.kernels import unpack as KU

    real_scatter, real_seed = KSc.scatter_rows, KU.seed

    def scatter_rows(jobs):
        jobs = [KSc.Rows(*j) for j in jobs]
        if jobs and jobs[0].dst.is_cuda:
            if "k12" not in MOVERS:
                MOVERS["k12"] = copy_jobs(jobs)
            MOVERS.setdefault("k12_sizes", []).append(
                [(int(j.idx.size), run_count(j.idx), row_words(j.dst))
                 for j in jobs])
        return real_scatter(jobs)

    def seed(cblobs, caps):
        if "k13" not in MOVERS and cblobs.node_f32.is_cuda:
            MOVERS["k13"] = (types.SimpleNamespace(
                node_f32=cblobs.node_f32.clone(),
                node_i32=cblobs.node_i32.clone()), caps)
        return real_seed(cblobs, caps)

    KSc.scatter_rows, KU.seed = scatter_rows, seed
    try:
        yield
    finally:
        KSc.scatter_rows, KU.seed = real_scatter, real_seed


def mover_drains(torch, card) -> str:
    """33: SchedulingPreferredPodAffinity/5000Nodes_5000Pods, profiled, in
    turns with the previous route (old, new, new, old): each run's pods/s,
    the host split's sync and pack, the Mirror's K12 launches, whole
    uploads and fence waits, and from the profiler the device ms of
    pageable and pinned host-to-device copies, of K12 and of K13. The
    first run with the new route has its launch counters zeroed just
    before it and keeps K12's and K13's first calls."""
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch.kernels import build as KB
    from kubernetes_tpu_torch.perf import harness as H
    from kubernetes_tpu_torch.perf import workloads as W

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = []
    for k, tag in enumerate(("old", "new", "new", "old")):
        w = W.preferred_pod_affinity()
        mstats: dict = {}
        first = tag == "new" and "k12_launches" not in MOVERS
        ctx = previous_route() if tag == "old" else (
            capturing_movers() if first else contextlib.nullcontext())
        KB.reset_launches()
        with ctx, profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            res = H.run_workload(w, device="cuda", on_scheduler=lambda s, h:
                                 mstats.update(s.mirror.stats))
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = dict(KB.LAUNCHES)
        if first:
            MOVERS["k12_launches"] = launches["row_scatter"]
            MOVERS["k13_launches"] = launches["blob_unpack"]
            if launches["row_scatter"] <= 0 or launches["blob_unpack"] <= 0:
                raise AssertionError(f"{w.name}: K12 {launches['row_scatter']}"
                                     f", K13 {launches['blob_unpack']} "
                                     f"launches")
        if tag == "old" and (launches["row_scatter"]
                             or launches["blob_unpack"]):
            raise AssertionError(f"{w.name}: the previous route launched "
                                 f"K12 or K13")
        if res["pods_scheduled"] != w.ops[-1].count:
            raise AssertionError(f"{w.name}: {res['pods_scheduled']} "
                                 f"measured pods bound")
        dev_ms: dict = {}
        for e in prof.key_averages():
            key = e.key
            if "Memcpy HtoD" in key:
                part = "pageable" if "Pageable" in key else "pinned"
            else:
                part = ("K12" if key.startswith("row_scatter") else "K13"
                        if key.startswith("blob_unpack") else "other")
            dev_ms[part] = dev_ms.get(part, 0.0) + device_us(e) / 1e3
        split = res["stats"]["time_s"]
        rows.append(
            f"{tag} {k + 1}: {res['pods_per_sec']} pods/s, sync "
            f"{split['sync']:.4f} s, pack {split['pack']:.4f} s, whole "
            f"drain {wall:.2f} s; device ms: pageable HtoD "
            f"{dev_ms.get('pageable', 0.0):.3f}, pinned HtoD "
            f"{dev_ms.get('pinned', 0.0):.3f}, K12 "
            f"{dev_ms.get('K12', 0.0):.3f} ({launches['row_scatter']}), K13 "
            f"{dev_ms.get('K13', 0.0):.3f} ({launches['blob_unpack']}), all "
            f"{sum(dev_ms.values()):.3f}; mirror {mstats}")
    return (f"[33] {MOVER_PATH} on {card}, profiled, in turns with the "
            f"previous route (pageable uploads + index_copy_, the seed as "
            f"views each launch copies): " + " | ".join(rows))


def mover_entries(torch, errs) -> list:
    """K12's and K13's kernels-line entries at their first calls on the
    named drain's first run with the new route: each against its twin bit
    for bit; its event ms and traced ms in turns with the previous design
    (build/previous, where present); the previous route in turns (K12:
    the gathered pageable upload + index_copy_, the library call; K13:
    the views' clones, as each launch made them, and the views'
    .contiguous(), the library call); the twin's ms; the wrappers' host
    us; K12 beside the copy engine (every copy of a run summed), and from
    a pinned staging slot (the ring variant, its host gather included)."""
    from kubernetes_tpu_torch.kernels import scatter as KSc
    from kubernetes_tpu_torch.kernels import unpack as KU
    from kubernetes_tpu_torch.ops.blobs import Blobs, fields_ref
    from kubernetes_tpu_torch.ops.features import codecs
    from kubernetes_tpu_torch.ops.scatter import scatter_rows_ref

    path = MOVER_PATH.split("/")[0]
    prev = previous_design()
    jobs = MOVERS["k12"]
    want = copy_jobs(jobs)
    KSc.scatter_rows(jobs)
    previous_push(torch, want)
    torch.cuda.synchronize()
    for j, w in zip(jobs, want):
        cmp_bits(f"K12@{path}", j.dst, w.dst)
    rows_d = [(torch.from_numpy(j.idx).cuda(),
               torch.from_numpy(j.src.numpy()[j.idx]).cuda()) for j in jobs]
    # the staging-ring variant: the host gathers the dirty rows into a
    # pinned slot (here a whole-buffer one, rows at their own places) and
    # K12 reads the slot, so the blobs need no fence
    slots = [KSc.pin(np.zeros_like(j.src.numpy())) for j in jobs]

    def ring():
        for j, slot in zip(jobs, slots):
            slot.numpy()[j.idx] = j.src.numpy()[j.idx]
        KSc.scatter_rows([KSc.Rows(j.dst, slot, j.idx)
                          for j, slot in zip(jobs, slots)])

    new = lambda: KSc.scatter_rows(jobs)  # noqa: E731
    design = (None if prev is None else
              lambda: prev[8].scatter_rows(jobs))
    old = lambda: previous_push(torch, jobs)  # noqa: E731
    twin = lambda: [scatter_rows_ref(j.dst, i, r)  # noqa: E731
                    for j, (i, r) in zip(jobs, rows_d)]
    ce, ce_bytes = copy_engine(torch, jobs)
    ev, ev_design = in_turns(torch, new, design, 10)
    tr, tr_design = traced_turns(torch, new, design, 10, K12_NAMES,
                                 K12_NAMES)
    tr_ce, _ = traced_turns(torch, ce, None, 10, None, None, whole=True)
    ev_new, ev_old = in_turns(torch, new, old, 10)
    _, tr_old = traced_turns(torch, new, old, 10, K12_NAMES, None,
                             rounds=1, whole=True)
    tr_ring, _ = traced_turns(torch, ring, None, 10, K12_NAMES, None,
                              rounds=1)
    us = {name: host_us(torch, fn, lambda: None) for name, fn in
          (("new", new), ("design", design), ("old", old), ("ring", ring))
          if fn is not None}
    ring_ms, _ = in_turns(torch, ring, None, 10)
    nrows = [int(j.idx.size) for j in jobs]
    k12 = {"name": f"row_scatter@{path}", "route": "cuda",
           "source": SOURCES["row_scatter"][0],
           "replaces": SOURCES["row_scatter"][1], "path": MOVER_PATH,
           "launches": MOVERS["k12_launches"], "max_abs_err": 0.0,
           "ms": ev, "plain_ms": cuda_ms(torch, twin),
           "bound_ms": k12_bound_ms(jobs),
           "bound_by": "bytes", "library_ms": ev_old, "trace_ms": tr,
           "trace_ms_previous": tr_old, "host_us": us["new"],
           "host_us_previous": us["old"], "ms_previous_design": ev_design,
           "trace_ms_previous_design": tr_design,
           "host_us_previous_design": us.get("design"),
           "copy_engine_trace_ms": tr_ce, "counter": "row_scatter"}
    log(f"[33] K12 at {path}'s first call ({len(jobs)} buffers, rows "
        f"{nrows}, words a row {[row_words(j.dst) for j in jobs]}) == the "
        f"previous route bit for bit: events {ev:.5f} ms (the previous "
        f"design in turns {opt_ms(ev_design)}), traced {opt_ms(tr)} "
        f"({gbps(ce_bytes, tr)}; the previous design "
        f"{opt_ms(tr_design)}, {gbps(ce_bytes, tr_design)}), the copy "
        f"engine for the same bytes (one contiguous copy_ a blob from the "
        f"same pinned blobs, the copies summed) traced {opt_ms(tr_ce)} "
        f"({gbps(ce_bytes, tr_ce)}); wrapper {us['new']:.1f} host us (the "
        f"previous design {opt_ms(us.get('design'))}); the previous route "
        f"(pageable upload + index_copy_) events {ev_old:.5f} in turns with "
        f"{ev_new:.5f}, its device items traced {opt_ms(tr_old)}, "
        f"{us['old']:.1f} host us; the ring variant (host gather into "
        f"pinned slots + K12 from them) events {ring_ms:.5f} ms, traced "
        f"{opt_ms(tr_ring)}, {us['ring']:.1f} host us; twin (index_copy_ of "
        f"uploaded rows) {k12['plain_ms']:.5f}; bound "
        f"{k12['bound_ms']:.5f} ms (bytes: {k12_work(jobs)[0]} over PCIe "
        f"at 64 GB/s, {k12_work(jobs)[1]} into HBM); K12 launches in the "
        f"drain {MOVERS['k12_launches']}, over the drain's first run with "
        f"the new route: {sizes_text(MOVERS.get('k12_sizes', []))}")

    blobs, caps = MOVERS["k13"]
    node_c = codecs(caps)[0]
    views = Blobs(f32=blobs.node_f32, i32=blobs.node_i32)
    free, nzr = KU.seed(blobs, caps)
    vf, vn = (node_c.field(views, n) for n in ("free", "nonzero_requested"))
    torch.cuda.synchronize()
    cmp_bits(f"K13@{path} free", free, vf)
    cmp_bits(f"K13@{path} nzr", nzr, vn)
    new = lambda: KU.seed(blobs, caps)  # noqa: E731
    design = None if prev is None else lambda: prev[9].seed(blobs, caps)
    old = lambda: (vf.clone(memory_format=torch.contiguous_format),  # noqa
                   vn.clone(memory_format=torch.contiguous_format))
    lib = lambda: (vf.contiguous(), vn.contiguous())  # noqa: E731
    twin = lambda: fields_ref(node_c, views,  # noqa: E731
                              ("free", "nonzero_requested"))
    ev, ev_design = in_turns(torch, new, design, 10)
    ev_lib_new, ev_lib = in_turns(torch, new, lib, 10)
    ev_old_new, ev_old = in_turns(torch, new, old, 10)
    tr, tr_design = traced_turns(torch, new, design, 10, K13_NAMES,
                                 K13_NAMES)
    _, tr_old = traced_turns(torch, new, old, 10, K13_NAMES, None,
                             rounds=1, whole=True)
    us = {name: host_us(torch, fn, lambda: None) for name, fn in
          (("new", new), ("design", design), ("old", old), ("lib", lib))
          if fn is not None}
    n, r = vf.shape
    nbytes = 2 * n * (r + 2) * 4
    k13 = {"name": f"blob_unpack@{path}", "route": "cuda",
           "source": SOURCES["blob_unpack"][0],
           "replaces": SOURCES["blob_unpack"][1], "path": MOVER_PATH,
           "launches": MOVERS["k13_launches"], "max_abs_err": 0.0,
           "ms": ev, "plain_ms": cuda_ms(torch, twin),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": ev_lib, "trace_ms": tr,
           "trace_ms_previous": tr_old, "host_us": us["new"],
           "host_us_previous": us["old"], "ms_previous_design": ev_design,
           "trace_ms_previous_design": tr_design,
           "host_us_previous_design": us.get("design"),
           "counter": "blob_unpack"}
    log(f"[33] K13 at {path}'s first seed (N={n}, R={r}) == the views bit "
        f"for bit: events {ev:.5f} ms (the previous design in turns "
        f"{opt_ms(ev_design)}), {ev_lib_new:.5f} in turns with "
        f".contiguous() of the views {ev_lib:.5f}, {ev_old_new:.5f} in turns "
        f"with the views' two clones (the previous route) {ev_old:.5f}; "
        f"traced {opt_ms(tr)} (the previous design {opt_ms(tr_design)}, "
        f"the clones {opt_ms(tr_old)}); wrapper {us['new']:.1f} host us "
        f"(the previous design {opt_ms(us.get('design'))}, the clones "
        f"{us['old']:.1f}, .contiguous() {us['lib']:.1f}); twin "
        f"{k13['plain_ms']:.5f}; bound {k13['bound_ms']:.6f} ms (bytes); "
        f"K13 launches in the drain {MOVERS['k13_launches']}")
    errs["row_scatter"] = errs["blob_unpack"] = 0.0
    return [k12, k13]


def movers_path(torch, card, errs) -> list:
    """This section's phases in order (30-33): K12 and K13 against their
    twins, the hazard, the named drain in turns with the previous route,
    and their kernels-line entries."""
    log(hold_k12(torch, errs))
    log(k12_sweep(torch))
    log(hold_k13(torch, errs))
    log(hazard(torch))
    log(mover_drains(torch, card))
    return mover_entries(torch, errs)


def finish_entries(kernels: list) -> None:
    """Each kernels-line entry's traced readings (TRACE, B0, K1K8, by
    kernel@path) and its kernel's launches over every drain of the
    call."""
    for e in kernels:
        key = e["name"] if "@" in e["name"] \
            else f"{e['name']}@{e['path'].split('/')[0]}"
        if key in TRACE:
            e["trace_ms"], e["trace_ms_previous"] = TRACE[key]
        if key in B0:
            e["trace_ms"] = B0[key]
        if key in K1K8:
            e["trace_ms_previous"] = K1K8[key][1]
            e["host_us"], e["host_us_previous"] = K1K8[key][2:]
        e["launches_call"] = DRAIN_LAUNCHES.get(e.pop("counter"), 0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    count_drains()
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
    # every kernel, one nvcc each, all started together; K3's (the
    # longest), the profile builds and the previous design build in
    # threads (side_builds) while phases 2b-3b, 10, 10b, 15, 18 and 18b,
    # which launch no scan, run, and are joined before 12, 15b and the
    # first scan (join_builds, at 3c)
    t_build = time.time()
    side = side_builds()
    KB.build_all(tuple(k for k in KB.KERNELS if k != "serial_scan"))

    def join_builds():
        for t in side:
            t.join()
            if t.error is not None:
                raise t.error
        each = ", ".join(f"{k} {v:.1f}" for k, v in
                         KB.BUILD_SECONDS.items())
        log(f"[2] built {', '.join(KB.KERNELS)} in "
            f"{time.time() - t_build:.1f} s (nvcc s each: {each}; K3's, the "
            f"profile builds and the previous design in threads, joined "
            f"here, before the first scan); "
            f"ptxas: {ptxas_text('serial_scan', 'serial_scan_kernel')}; "
            f"{ptxas_text('auction_score_argmax', 'auction_bid')}; "
            f"{ptxas_text('learned_mlp', 'learned_mlp_probe')}; "
            f"{ptxas_text('gang_pack', 'gang_pack')}; "
            f"{ptxas_text('auction_accept_commit', 'auction_commit')}; "
            f"{ptxas_text('soft_scores', 'soft_scores_kernel')}; "
            f"K9's own functions: in "
            f"K3 {ptxas_text('serial_scan', 'learned_')}; in K2a "
            f"{ptxas_text('auction_score_argmax', 'learned_')}")

    log(k11_first_use(torch))

    if "--only-new" in sys.argv:
        join_builds()
        # this slice's phases alone (a rehearsal; without arguments the
        # script runs every phase): K6a at full width (12) and on the
        # PostFilter path (13b), K7b at full width (15b) and on the Permit
        # path (16b), each in turns with the previous design where
        # build/previous holds it
        log(f"[12] {hold_sweep(torch, errs)}")
        entries = postfilter_path(torch, card, errs)[0]
        log(f"[15b] K7b (gang_capacity) == twin exactly: "
            f"{hold_gang_capacity(torch)}")
        entries.append(permit_path(torch, card))
        finish_entries(entries)
        print(card, flush=True)
        print(json.dumps({"kernels": entries}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

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
    log(hold_k1_fuzz(torch, errs))
    enabled = (True,) * K1.NUM_STATIC

    # ------------------------------------------------- 4. K2 vs its twins
    for tag, (seed, n_nodes, node_cap) in (("B<=N", (12, 5000, 8192)),
                                           ("B>N", (13, 1000, 1024))):
        mirror, caps, pods = fuzz_mirror(torch, seed, n_nodes, node_cap,
                                          4096, 8)
        spec = mirror.prepare_launch(pods, 4096)
        args = (spec, mirror.well_known(), P.default_weights(), caps)
        rec = {}
        with recording(rec):
            out = P.launch_batch(*args, serial_scan=False, tie_seed=7,
                                 device=dev)
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
        if tag == "B>N":
            # K2b's first K-accept round, device-only, as phase 7 times
            # the plain one
            rin0 = rec["rin0"]
            _, choice0, win0 = rec["k2a"][0]
            prog0 = torch.tensor([1, 0], dtype=torch.int32, device=dev)
            (k2b_ms, _), acc0 = time_k2b(
                torch, "auction_accept_commit@K-accept", rin0, choice0,
                win0, prog0)
            log(f"[4] K2b's first K-accept round (B=4096, N=1024, k_accept "
                f"{int(rin0.k_accept)}): {k2b_ms:.5f} ms, {acc0} accepted; "
                f"{plan_text(rin0)}")

    # ---------------------------- 4b. K2b's edge-case launches on the card
    log(hold_accept_cases(torch, errs))

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
    log(f"[3b] K5 (one launch) == its table/nodes/pairs twins on G=4 groups "
        f"({hard} hard, {soft} soft terms) x N=8192 x PT=16384, D=8192: "
        f"{int(want.nodes.anti_ok.sum())} anti-affinity-free and "
        f"{int(want.nodes.term_static.sum())} affinity-satisfied "
        f"(group, node) pairs, ipa_raw range "
        f"[{float(want.nodes.ipa_raw.min())}, "
        f"{float(want.nodes.ipa_raw.max())}], max err "
        f"{max(errs[s_] for s_ in KT.STAGES):g}")

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
        k4_global = KB.LAUNCHES["soft_scores_global"]
        held = hold_soft_launch(
            torch, f"[10] {tag}",
            (launch, mir.well_known(), P.default_weights(), cps, filters),
            soft_run, errs)
        out, rec = held["out"], held["log"]
        rounds = sum(1 for a_, _, _ in rec["k2a"] if a_)
        soft_v = rec["view"][0]
        ipa_col = P.FILTER_PLUGINS.index("InterPodAffinity")
        k4_global = KB.LAUNCHES["soft_scores_global"] - k4_global
        log(f"[10] soft auction, {tag}: K5, K4 ({len(rec['k4'])} "
            f"launches, every bidding round's maps and scores; "
            f"{plan_text(None, soft_v)}, {k4_global} launches with global "
            f"maps) and K2a/K2b in soft mode == twins "
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

    log(hold_soft_plans(torch))

    # ------------------------------- 15 / 15b. K7 vs its twins, full width
    from kubernetes_tpu_torch.kernels import gang as KG

    summary15, frees = hold_gang_pack(torch)
    log(f"[15] K1 + K7a (gang_pack) == twin exactly (ok, alloc, cap, spans, "
        f"free, nzr, guard), G = 16 with own nominated members, fit on and "
        f"off, three chained launches and a fail-by-one launch each: "
        f"{summary15}")

    # ------------------------------- 18. K8 vs its twin, full width
    from kubernetes_tpu_torch.kernels import dra as KD
    from kubernetes_tpu_torch.ops import dra as OD

    log(f"[18] K8 (dra_feasible) == twin exactly (dra_ok, dra_reject, the "
        f"ANDed static_ok; with and without host verdicts) over 5000 nodes "
        f"(bucket 8192) on seeded DRA fuzz: {hold_k8(torch, errs)}; "
        + ptxas_text("dra_feasible", "dra_feasible") + "; the previous "
        "design's: " + previous_ptxas("dra_feasible", "dra_feasible"))
    log(hold_k8_caps(torch, errs))

    # ---------------------------------------- 3c. K3 vs its twin on the card
    join_builds()
    # 12 and 15b time K6a and K7b in turns with the previous design where
    # build/previous holds it, whose libraries build in the joined threads
    log(f"[12] {hold_sweep(torch, errs)}")
    log(f"[15b] K7b (gang_capacity) == twin exactly: "
        f"{hold_gang_capacity(torch, frees)}")
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
        f"over {res['elapsed_s']} s ({floor_text(res)}; whole drain "
        f"{drain_s:.1f} s); "
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
    topo_counters = ("phase1_static", KT.COUNTER, "serial_scan")
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
            f"pods/s over {res['elapsed_s']} s ({floor_text(res)}; whole "
            f"drain {wall:.1f} s); "
            f"{st['launches']} launches; host time split s {split}; kernel "
            f"launches {nonzero(launches)}; scan device ms per launch "
            f"{statistics.mean(scan_ms):.3f} (min {min(scan_ms):.3f}, max "
            f"{max(scan_ms):.3f}) over {len(scan_ms)} launches")
        for i, cap in enumerate(kept):
            entries = hold_topology(workload, cap, launches,
                                    timed=i == len(kept) - 1)
        topo_entries.extend(entries)

    def hold_topology(workload, cap, launches, timed):
        """8c: K1, K5 (each stage's outputs) and K3 against their twins,
        exactly,
        on one captured launch of a drain; with ``timed``, also their
        CUDA-event times there, the barrier limit of the scan, and the
        kernels-line entries of K5 and K3 on this path."""
        path = workload.name.split("/")[0]
        p1 = K1.phase1_static(*cap["k1"])
        p1_ref = K1.phase1_static_ref(*cap["k1"])
        cmp_k1(f"{path} K1", p1, p1_ref)
        # K5: the kernel on the drain's own inputs, the twin chained on
        # its own stages and on the masks of K1's twin
        cb5, f5, i5, _, _, _, caps5, d5 = cap["k5"]
        k5 = KT.prepare_launch(*cap["k5"])
        k5.run()
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
        work = {"topo_statics": k5_launch_work(ct5, pods5, i5, caps5, d5)}
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
        # times: 20 CUDA-event launches of K5 (on the prepared arguments:
        # device time, not the wrapper's) and profiler traces in turns with
        # the previous design, the twins' K5 stages over 5; K3 in turns
        # with the previous design (5 launches a turn);
        # the scan's two cluster barriers a step alone on its cluster for B
        # steps (its step floor) and the previous design's three grid
        # barriers a step on its grid; K3's phases from its profile build
        times = {"topo_statics": (cuda_ms(torch, k5.run), sum(
            cuda_ms(torch, twin_stage[st], reps=5, warm=1)
            for st in KT.STAGES))}
        k5_ms, k5_prev, k5_all, k5_all_prev, k5_us, k5_us_prev = time_k5(
            torch, cap["k5"], k5)
        B0[f"topo_statics@{path}"] = k5_ms
        K1K8[f"topo_statics@{path}"] = (k5_ms, k5_prev, k5_us, k5_us_prev)

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
            f"{k3_shape(sin)}; {profile_text(prof, 'a step')}; K5's launch "
            f"{times['topo_statics'][0]:.5f} ms by events, traced "
            f"{opt_ms(k5_ms)} (the previous design's three stages "
            f"{opt_ms(k5_prev)} in turns), every device item of the call "
            f"(the memsets and the inputs' copies included) {opt_ms(k5_all)}"
            f" (previous {opt_ms(k5_all_prev)}), the wrapper "
            f"{k5_us:.1f} host us (previous {opt_ms(k5_us_prev)}); K3 "
            f"launches of the narrow instantiation in the drain "
            f"{launches['serial_scan_narrow']}; scans "
            f"whose carries stayed in global memory in the drain: "
            f"{launches['serial_scan_global_carries']} of "
            f"{launches['serial_scan']}")
        return [kernel_entry(f"{name}@{path}", name, workload.name,
                             launches[name], errs.get(f"{name}@{path}", 0.0),
                             times[name], work[name])
                for name in ("topo_statics", "serial_scan")]

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
        missing = [k for k in ("phase1_static", KT.COUNTER, *SOFT_KERNELS)
                   if launches[k] <= 0]
        if missing or len(kept) < 2:
            raise AssertionError(f"{workload.name}: kernels never launched "
                                 f"{missing}, {len(kept)} soft launches")
        st = res["stats"]
        split = {k: round(v, 3) for k, v in st["time_s"].items()}
        log(f"[11] {workload.name} on {card}: all {n_pods} pods bound, no "
            f"node overcommitted; {detail}; measured {res['pods_per_sec']} "
            f"pods/s over {res['elapsed_s']} s ({floor_text(res)}; whole "
            f"drain {wall:.1f} s); "
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
        times, work, tdetail, bid_prev = time_soft_launch(torch, held,
                                                          path)
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
    profiled(torch, "11b", W.preferred_pod_affinity(),
             kernels=("auction_commit", "soft_scores_kernel"))

    # ------------------------------- 12b. K6b vs its twin, full width
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
        f"({floor_text(res)}; whole drain {pa_wall:.1f} s); "
        f"{st['preemptions']} preemptions, "
        f"{evicted} fillers evicted, {res['churn_created']} churn pods "
        f"created; {st['launches']} launches; host time split s {split}; "
        f"{churn_stats(st)}; "
        f"kernel launches {nonzero(pa_launches)} (K6: preempt_sweep "
        f"{pa_launches['preempt_sweep']}, preempt_feasible "
        f"{pa_launches['preempt_feasible']})")

    k6_entries, k1_dry, k1_dry_n = postfilter_path(torch, card, errs)

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
    log(gang_preemption_repeat(torch))
    log(gang_turns(torch))
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
    k7b_entry = permit_path(torch, card)

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
    k1_gang = cap16["k1"]
    prev = previous_design() if previous_changed("gang_pack") else None
    k7a_ms, k7a_prev = in_turns(
        torch, lambda: KG.pack_core(*pa, **pkw),
        (lambda: prev[3].pack_core(*pa, **pkw)) if prev else None, 10)
    K3_TIMES["gang_pack@MultiTenantGangStorm"] = (k7a_ms, k7a_prev, None)
    k7a_twin = cuda_ms(torch, lambda: pack_twin(pa), reps=5)
    pack_prof = KG.pack_profile(*pa, **pkw)
    plan = KG.pack_plan(pa)
    log(f"[16] K7a on the storm's first launch: cluster of {plan.cluster} "
        f"blocks x {plan.threads} threads, {plan.per} nodes a block, "
        f"{plan.smem_bytes} B of shared memory a block, global arrays "
        f"{plan.global_arrays or 'none'}; {k7a_ms:.5f} ms, "
        f"{previous_text(k7a_ms, k7a_prev)}; "
        + profile_text({k: v / pa[3].shape[0] for k, v in pack_prof.items()},
                       "a gang") + "; " + ptxas_text("gang_pack", "gang_pack"))
    log(f"[16] K7 times: K7a on the storm's first launch (G={pa[3].shape[0]}"
        f", N={pa[3].shape[1]}, R={pa[0].shape[1]}, d_cap={pa[10]}) kernel "
        f"{k7a_ms:.5f} ms (twin {k7a_twin:.3f}), this launch's work "
        f"{pack_work(pa)}; K7b's at [16b]")
    k7_entries = [
        kernel_entry("K7a@MultiTenantGangStorm", "gang_pack",
                     "MultiTenantGangStorm/500Nodes at scale 10",
                     storm_launches["gang_pack"], 0.0, (k7a_ms, k7a_twin),
                     pack_work(pa)),
        k7b_entry]

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
            f"{res['elapsed_s']} s (whole drain {wall:.1f} s, "
            f"{floor_text(res)}); {st['launches']} launches, K8 "
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
        k8_name = (f"K8@{name.split('/')[0]}"
                   + ("@5000Nodes" if n_pods == 5000 else ""))
        k8_text, _ = time_k8(torch, k8_name.split("@", 1)[1], st_, dra_,
                             host_)
        log(f"[19] {k8_text}; work {dra_work(dra_, host_)}")
        k8_entries.append(kernel_entry(
            k8_name, "dra_feasible", name, dl["dra_feasible"], 0.0,
            k8_times, dra_work(dra_, host_)))

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
    log(hold_wide_scorer(torch, errs))

    # ---------------------- 25. the training path; 25f the lifted caps
    learned_entries += training_path(torch, card, errs)
    log(hold_caps(torch, errs))

    # ------------- 26-29. chain-surviving churn: K11 and the churn drains
    churn_k = churn_path(torch, card, errs)

    # ---------------- 30-33. the data movers: K12 and K13 on their paths
    movers_k = movers_path(torch, card, errs)

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
    p1 = k1()
    ct = unpack_cluster(spec.cblobs, caps)
    pods_f = unpack_pods(spec.pblobs, caps, spec.pfields, spec.ptmpl)
    free0, nzr0 = P.extract_state(spec.cblobs, caps)
    rin = P.round_inputs(ct, pods_f, g_of, p1, P.default_weights(), free0,
                         nzr0)
    prog = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    choice, win_now = KA.auction_score_argmax(rin, prog, 0)
    torch.cuda.synchronize()

    prev = previous_design()
    bid_ms, bid_prev = in_turns(
        torch, lambda: KA.auction_score_argmax(rin, prog, 0),
        (lambda: prev[1]._bid_kernel(rin, prog, 0)) if prev else None, 10)
    K3_TIMES["auction_score_argmax@SchedulingBasic"] = (bid_ms, bid_prev,
                                                        None)
    bid_prof = KA.bid_profile(rin, prog, 0)
    k1_text, k1_times, k1_w, _ = time_k1(
        torch, "SchedulingBasic",
        (spec.cblobs, prow_f32, prow_i32, caps, wk, filters, spec.active,
         None), errs, key=f"phase1_static@{w.name.split('/')[0]}")
    k1_more = []
    for tag, args_, n_launch, path_ in (
            ("PostFilterDryRun", k1_dry, k1_dry_n,
             "PostFilter path (5000 nodes, 128 preemptors)"),
            ("GangChunk", k1_gang, storm_launches["phase1_static"],
             "MultiTenantGangStorm/500Nodes at scale 10")):
        text_, times_, work_, _ = time_k1(torch, tag, args_, errs)
        log(f"[7] {text_}")
        k1_more.append(kernel_entry(f"K1@{tag}", "phase1_static", path_,
                                    n_launch, errs["phase1_static"], times_,
                                    work_))
    log(f"[7] {k1_text}; ptxas {ptxas_text('phase1_static', 'p1_')}; the "
        f"previous design's {previous_ptxas('phase1_static', 'p1_')}")
    times = {
        "phase1_static": k1_times,
        "auction_score_argmax": (
            bid_ms,
            cuda_ms(torch, lambda: KA.auction_score_argmax_ref(rin, prog, 0))),
    }
    log(f"[7] K2a's first round on the main path (B=4096, N={rin.n}): "
        f"{bid_ms:.5f} ms, {previous_text(bid_ms, bid_prev)}; "
        f"{k2a_shape(rin)}; block 0's "
        + profile_text(bid_prof, "of the round"))
    log("[7] K3, K2a, K9 and K7a by path (ms, the previous design's ms in "
        "turns in this call, K3's step floor ms): " + "; ".join(
            f"{k} {v[0]:.5f} / "
            f"{'-' if v[1] is None else format(v[1], '.5f')} / "
            f"{'-' if v[2] is None else format(v[2], '.3f')}"
            for k, v in K3_TIMES.items()))
    times["auction_accept_commit"], accepted = time_k2b(
        torch, f"auction_accept_commit@{w.name.split('/')[0]}", rin, choice,
        win_now, prog)
    def opt(v, fmt):
        return "-" if v is None else format(v, fmt)

    log(f"[7] K2b and K4 device-only, each in turns with the previous "
        f"design (ms of one launch between two events, the previous "
        f"design's; the wrapper's host us a round, the previous "
        f"wrapper's; ms a launch over {BATCH} back to back, the previous "
        f"design's; one launch whose input flag is 0, which returns at "
        f"once; K2b at its first round, K4 at its launch's end-state "
        f"placed set from empty maps, back to back with nothing moved): "
        + "; ".join(
            f"{k} {v[0]:.5f} / {opt(v[1], '.5f')} / {v[2]:.1f} / "
            f"{opt(v[3], '.1f')} / {v[4]:.5f} / {opt(v[5], '.5f')} / "
            f"{v[6]:.5f}"
            for k, v in SPLIT.items())
        + f"; the floor: {launch_floor(torch)}; device ms from the "
        f"profiler trace (a launch, the previous design's round): "
        + "; ".join(f"{k} {opt(v[0], '.5f')} / {opt(v[1], '.5f')}"
                    for k, v in TRACE.items())
        + f"; SchedulingBasic K2b: {plan_text(rin)}; "
        + ptxas_text("auction_accept_commit", "auction_commit"))

    n, r = caps.nodes, caps.res_cols
    b = 4096
    g = int(rows.shape[0])
    bidders = b
    # bytes each kernel must move at these shapes (inputs read once,
    # outputs written once) and the operations its data needs
    work = {
        "phase1_static": k1_w,
        "auction_score_argmax": (
            n * (2 * r + 4) * 4 + b * (r + 6) * 4 + g * n * 13 + b * 8,
            bidders * n * (3 * r + 30)),
        "auction_accept_commit": (
            b * (4 + 4 + 4 * r + 8 + 4) + n * (3 * r + 4) * 4 + b * 8,
            accepted * (r + 2)),
    }
    kernels = [kernel_entry(name, name, w.name, launches[name], errs[name],
                            times[name], work[name])
               for name in KB.KERNELS[:3]] + k1_more + topo_entries \
        + soft_entries + k6_entries + k7_entries + k8_entries \
        + k3pct_entries \
        + learned_entries + churn_k + movers_k
    log(f"[7] kernel times at the main paths' shapes: K1/K2 SchedulingBasic "
        f"(G={g}, B={b}, N={n}, R={r}); K5/K3 each topology drain's first "
        f"launch with pods in its table (phase 8c); bounds from each function's bytes (inputs "
        f"read once, outputs written once) and operations at these inputs; "
        f"K3's cluster barriers, measured alone in 8c and 21, are its step "
        f"floor; "
        f"whole script {time.time() - t_start:.1f} s")
    finish_entries(kernels)
    log("[7] B0, every kernel not yet redesigned and K1 / K8, device ms "
        "from profiler traces and launches summed over every drain of the "
        "call (kernel: traced ms, launches, launches x (traced ms - bound "
        "ms)): " + "; ".join(
            f"{e['name']}@{e['path'].split('/')[0]}: "
            f"{opt_ms(e.get('trace_ms'))}, {e['launches_call']}, "
            f"{e['launches_call'] * (e['trace_ms'] - e['bound_ms']):.4f}"
            for e in kernels if e.get("trace_ms") is not None)
        + f"; launches over the call's drains {nonzero(DRAIN_LAUNCHES)}")
    log("[7] K2a's export pass in the call's drains, CTAs whose pods are "
        "alike (one pod's path for the CTA) by workload: " + alike_text())
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--gang-worker" in sys.argv:
        sys.exit(gang_worker(sys.argv[sys.argv.index("--gang-worker") + 1]))
    sys.exit(main())
