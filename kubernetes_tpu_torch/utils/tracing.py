"""Lightweight scheduling traces + the always-on flight recorder (port
of the JAX package's utils/tracing.py; the port's Scheduler wires the
flight recorder's cycle phases and its JSON-lines export, v3).

Two generations of tracing live here:

- ``Trace``: the slice of the reference's tracing the scheduler used
  first (utiltrace in schedule_one.go:404 + the component-base/tracing
  spans) — nested timed steps collected per operation, logged ONLY when
  the whole operation exceeds its threshold. Still used for the
  slow-cycle log line.

- ``CycleTrace`` / ``FlightRecorder``: the always-on successor. EVERY
  scheduling cycle records its fine-grained phases (queue pop, snapshot
  sync, host plugins, DRA allocator, pack, device launch, D2H pull,
  commit, failure handling, binder drain, eviction flush, host
  fallback) into a bounded ring buffer, and each phase feeds a
  per-phase histogram in the metrics Registry — the continuous
  per-stage latency attribution Kant (arxiv 2510.01256) argues
  large-cluster schedulers need, instead of sampling-on-slow. Recording
  a phase is two clock reads plus one dict write, and the ring is a
  deque append.

- ``PodTimelines``: per-pod lifecycle stamps (enqueue, pop/attempt,
  assume, bind, parks) plus the last unschedulable diagnosis (which
  device filter rejected how many nodes, which host plugin rejected),
  bounded LRU — the data behind ``/debug/pod?name=``.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import time
from contextlib import contextmanager
from typing import Callable, Optional

logger = logging.getLogger("kubernetes_tpu_torch.trace")

# canonical cycle phases, in rough hot-path order. Host-tail share (the
# bench --profile headline) is the HOST_PHASES fraction of total cycle
# time; the dra_* phases are VIEWS (the DynamicResources slices of
# pack/host_plugins/commit), not disjoint phases, so they are excluded
# from the share arithmetic.
CYCLE_PHASES = (
    "queue_pop",          # pop_batch + per-pod hub vetting
    "snapshot_sync",      # cache.update_snapshot + mirror.sync (H2D pack)
    "chain_patch",        # churn deltas scattered into the live chain
                          # (chain-surviving churn: the cheap substitute
                          # for a whole-chain invalidate + snapshot_sync)
    "host_plugins",       # host PreFilter/Filter/Score + extenders
    "pack",               # mirror.prepare_launch (pod-side H2D)
    "device_dispatch",    # async launch_batch dispatch
    "device_launch",      # dispatch -> results pulled (device + queue wait)
    "d2h_pull",           # device_get of rows/guard/reject_counts
    "commit",             # assume/reserve/permit per winner
    "failure_handling",   # diagnoses, PostFilter/preemption, parks
    "binder_drain",       # collecting finished binding cycles
    "eviction_flush",     # queued preemption evictions
    "host_fallback",      # serial host path after a device fault
    "dra_mask_compile",   # CEL -> bitmask compile + inventory refresh (view)
    "dra_device_eval",    # per-cycle DRA tensor pack + host-path
                          # DynamicResources PreFilter/Filter time (view;
                          # the fused in-launch eval rides device_launch)
    "dra_commit",         # DynamicResources Reserve/PreBind time (view)
    "learned_score",      # learned-scorer checkpoint mtime poll /
                          # reload / params fetch at snapshot-sync time
                          # (a REAL exclusive phase, counted in totals —
                          # a slow checkpoint path must show up in the
                          # A/B latency gate; the fused MLP eval itself
                          # rides device_launch)
    "device_compile",     # launch walltime of a cycle whose dispatch
                          # triggered an XLA compile (view: the same
                          # seconds already sit in device_launch — the
                          # DeviceProfiler's attribution of WHY that
                          # launch stalled)
    "gang_device",        # fused gang-pack launch: pack + dispatch +
                          # the verdict pull (device + transfer time,
                          # the gang analog of device_launch)
    "gang_commit",        # host commit of device-placed gang units
                          # (reserve-all -> bind-all, atomic rollback)
    "commit_pull",        # pipelined waves only: the commit thread's
                          # device pull, measured on the commit thread
                          # (overlap view: that wall time runs CONCURRENT
                          # with the loop thread's next dispatch, so it is
                          # excluded from totals/host-tail — the loop
                          # thread's actual blocked wait lands in
                          # device_launch)
)

# the dra_* attribution views, excluded from total/host-tail arithmetic
# (they double-count time already inside pack/host_plugins/commit)
DRA_VIEW_PHASES = ("dra_mask_compile", "dra_device_eval", "dra_commit")

# attribution views excluded from cycle totals and the host-tail share.
# NOTE: learned_score is NOT here — its time is exclusive (nothing else
# measures the checkpoint poll), so hiding it would let a slow reload
# path pass the --ab-scorer parity gate unseen
VIEW_PHASES = DRA_VIEW_PHASES + ("device_compile",)

# phases measured on the commit thread, CONCURRENT with loop-thread
# work. Counting them in totals/host-tail would book overlapped wall
# time as if serial (the pipelined arm's host-tail share over-reported
# before these were split out). Like VIEW_PHASES they still render in
# /debug/trace and phase_percentiles — they are attribution, not cost.
OVERLAP_PHASES = ("commit_pull",)

# everything excluded from the serial-cycle-time arithmetic
EXCLUDED_PHASES = VIEW_PHASES + OVERLAP_PHASES

# trace-export JSON-lines format version (CycleTrace.to_dict "v"):
# v2 added per-pod placement rows (pod, chosen node, aggregate score,
# chosen-node learned-feature vector) — the replay-dataset substrate;
# v3 adds the opt-in top-K alternative-node scores per placement
# ("alt": [[node, score], ...], trace_export_alts) — the counterfactual
# substrate behind per-placement regret (learn/regret.py). Additive:
# v2 rows remain valid replay input (learn/replay.py reads >= 2).
EXPORT_VERSION = 3

# phases that are host-side Python work (the "host tail" the ROADMAP's
# sub-10x offenders ask us to attribute); device_launch is device +
# transfer, d2h_pull is transfer, the dra_* views double-count host time
HOST_PHASES = (
    "queue_pop", "snapshot_sync", "chain_patch", "host_plugins", "pack",
    "commit",
    "failure_handling", "binder_drain", "eviction_flush", "host_fallback",
    "learned_score", "gang_commit",
)


class Trace:
    """utiltrace.Trace: nested spans via span(); log_if_long at end."""

    def __init__(self, name: str, now: Callable[[], float] = time.monotonic,
                 **fields):
        self.name = name
        self.fields = fields
        self._now = now
        self.start = now()
        # (name, start offset, secs, depth)
        self.steps: list[tuple[str, float, float, int]] = []
        self._depth = 0

    @contextmanager
    def span(self, name: str):
        self._depth += 1
        t0 = self._now()
        try:
            yield self
        finally:
            self._depth -= 1
            # (name, start offset, secs, depth): the dump sorts by start
            # so parents print above their children
            self.steps.append((name, t0 - self.start,
                               self._now() - t0, self._depth))

    def total(self) -> float:
        return self._now() - self.start

    def log_if_long(self, threshold: float,
                    log: Optional[logging.Logger] = None) -> bool:
        """Emit the trace when total exceeds ``threshold`` (the reference's
        100ms slow-attempt log). Returns whether it logged."""
        total = self.total()
        if total < threshold:
            return False
        log = log or logger
        fields = " ".join(f"{k}={v}" for k, v in self.fields.items())
        lines = [f"Trace[{self.name}] {fields} total={total * 1e3:.0f}ms"]
        for name, _start, secs, depth in sorted(self.steps,
                                                key=lambda s: (s[1], s[3])):
            lines.append(f"{'  ' * (depth + 1)}- {name}: {secs * 1e3:.0f}ms")
        log.info("%s", "\n".join(lines))
        return True


class CycleTrace:
    """One scheduling cycle's phase durations. ``add`` accumulates (a
    phase may be touched several times per cycle, e.g. the re-bucketing
    retry loop re-syncing); the recorder flushes the whole dict to the
    phase histogram when the cycle is recorded."""

    __slots__ = ("cycle", "start", "pods", "scheduled", "failed",
                 "chained", "phases", "plugins", "placements",
                 "occupancy", "depth")

    def __init__(self, cycle: int, start: float, pods: int,
                 chained: bool = False):
        self.cycle = cycle
        self.start = start          # wall-clock cycle start
        self.pods = pods
        self.scheduled = 0
        self.failed = 0
        self.chained = chained
        # device occupancy: fraction of this cycle's wall (dispatch ->
        # finish) with its launch in flight — the pipelining instrument
        # (1.0 = the device never waited on host commit work). None until
        # the cycle finishes; stays None for host-fallback cycles.
        self.occupancy: float | None = None
        # pipeline depth observed right after this cycle dispatched
        # (how many waves were in flight, the stall detector)
        self.depth = 0
        self.phases: dict[str, float] = {}
        self.plugins: dict[str, float] = {}   # "plugin/point" -> secs
        # per-pod placement rows (export v2+): {"pod", "uid", "node",
        # "score"[, "feat"][, "alt"]} — node None for failed attempts,
        # "alt" the v3 top-K alternative (node, score) pairs. Populated
        # by the scheduler only while the export file is open.
        self.placements: list[dict] | None = None

    def add(self, phase: str, secs: float) -> None:
        self.phases[phase] = self.phases.get(phase, 0.0) + secs

    def total(self) -> float:
        # view phases double-count time inside the real phases; overlap
        # phases ran on the commit thread concurrent with the loop
        return sum(v for k, v in self.phases.items()
                   if k not in EXCLUDED_PHASES)

    def to_dict(self) -> dict:
        d = {
            "v": EXPORT_VERSION,
            "cycle": self.cycle,
            "start": round(self.start, 6),
            "pods": self.pods,
            "scheduled": self.scheduled,
            "failed": self.failed,
            "chained": self.chained,
            "depth": self.depth,
            "total_ms": round(self.total() * 1e3, 3),
            "phases_ms": {k: round(v * 1e3, 3)
                          for k, v in self.phases.items()},
        }
        if self.occupancy is not None:
            d["occupancy"] = round(self.occupancy, 4)
        if self.plugins:
            d["plugins_ms"] = {k: round(v * 1e3, 3)
                               for k, v in self.plugins.items()}
        if self.placements is not None:
            d["placements"] = self.placements
        return d


class _NullTrace(CycleTrace):
    """The disabled recorder's trace: add() is a no-op so the scheduler
    keeps one unconditional code path."""

    def __init__(self):
        super().__init__(-1, 0.0, 0)

    def add(self, phase: str, secs: float) -> None:
        pass


_NULL_TRACE = _NullTrace()


class FlightRecorder:
    """Always-on, low-overhead cycle recorder: a bounded ring of
    CycleTraces + per-phase / per-plugin histograms feeding the metrics
    Registry, with an optional JSON-lines export for offline analysis.

    Thread model: begin/record/observe_phase/plugin_observe run on the
    scheduling-loop thread only (binder-thread observations go through
    the scheduler's AsyncRecorder instead); readers (``/debug/trace``)
    take cheap snapshots of the deque."""

    def __init__(self, phase_hist=None, plugin_hist=None,
                 capacity: int = 256, export_path: Optional[str] = None,
                 enabled: bool = True, export_max_bytes: int = 0):
        self.enabled = enabled and capacity > 0
        self.phase_hist = phase_hist
        self.plugin_hist = plugin_hist
        self.ring: collections.deque = collections.deque(
            maxlen=max(1, capacity))
        # device-occupancy ring (floats, same capacity): record() copies
        # each finished cycle's occupancy here so occupancy_stats() needn't
        # walk CycleTrace objects under the readers' snapshot
        self._occ: collections.deque = collections.deque(
            maxlen=max(1, capacity))
        self.current: Optional[CycleTrace] = None
        self._cycle_seq = 0
        self._export_path = export_path
        self._export_file = None
        # size-based rotation (keep-last-1): a long trace-collection run
        # must not fill the disk. 0 = unbounded (tests/offline tooling).
        self._export_max_bytes = max(0, export_max_bytes)
        self._export_bytes = 0
        if export_path and self.enabled:
            self._export_file = open(export_path, "a", buffering=1)
            try:
                self._export_bytes = os.path.getsize(export_path)
            except OSError:
                self._export_bytes = 0

    @property
    def exporting(self) -> bool:
        """True while an export file is open — the scheduler's gate for
        the placement-row pulls (score + feature D2H) that only the
        offline replay consumer needs."""
        return self._export_file is not None

    # ------------- recording (loop thread) -------------

    def begin(self, start: float, pods: int,
              chained: bool = False) -> CycleTrace:
        if not self.enabled:
            return _NULL_TRACE
        self._cycle_seq += 1
        tr = CycleTrace(self._cycle_seq, start, pods, chained)
        self.current = tr
        return tr

    def resume(self, tr: CycleTrace) -> None:
        """Re-attach a dispatched cycle's trace (the pipelined drain
        interleaves dispatch k+1 with finish k) so plugin timings land
        on the cycle whose commit is running."""
        if tr is not _NULL_TRACE:
            self.current = tr

    def record(self, tr: CycleTrace) -> None:
        """Cycle complete: ring + histograms + optional export line."""
        if tr is _NULL_TRACE:
            return
        if self.current is tr:
            self.current = None
        self.ring.append(tr)
        if tr.occupancy is not None:
            self._occ.append(tr.occupancy)
        h = self.phase_hist
        if h is not None:
            for phase, secs in tr.phases.items():
                h.observe(secs, phase=phase)
        if self._export_file is not None:
            line = json.dumps(tr.to_dict()) + "\n"
            if self._export_max_bytes \
                    and self._export_bytes + len(line) \
                    > self._export_max_bytes \
                    and self._export_bytes > 0:
                self._rotate_export()    # may disable the export
            if self._export_file is not None:
                self._export_file.write(line)
                self._export_bytes += len(line)

    def _rotate_export(self) -> None:
        """Keep-last-1 rotation: the current file becomes ``<path>.1``
        (replacing any previous rotation) and a fresh file opens, so the
        on-disk footprint is bounded by ~2x export_max_bytes while the
        newest traces are always intact. A FAILED rotation (permissions
        changed, directory vanished) disables the export outright — the
        bound is the contract; silently resuming unbounded appends would
        reintroduce the disk-fill this exists to prevent."""
        try:
            self._export_file.close()
            os.replace(self._export_path, self._export_path + ".1")
            self._export_file = open(self._export_path, "a", buffering=1)
            self._export_bytes = 0
        except OSError:
            logger.error("trace export rotation failed for %s; "
                         "disabling the export (the size bound is the "
                         "contract)", self._export_path, exc_info=True)
            try:
                self._export_file.close()
            except OSError:
                pass
            self._export_file = None

    def occupancy_stats(self) -> dict:
        """Device-occupancy summary over the ring: mean/p50/p99 fraction
        of cycle wall with a launch in flight. The pipelining headline —
        a mean near 1.0 means commit work fully overlapped device time;
        strict alternation (pipelined_waves off) sits at launch/(launch +
        commit). Empty dict when no device cycle has finished yet."""
        vals = sorted(self._occ)
        n = len(vals)
        if n == 0:
            return {}
        return {
            "n": n,
            "mean": round(sum(vals) / n, 4),
            "p50": round(vals[n // 2], 4),
            "p99": round(vals[min(n - 1, int(n * 0.99))], 4),
        }

    def observe_phase(self, phase: str, secs: float) -> None:
        """A standalone phase observation outside a cycle (binder drain
        between cycles, eviction flush, the host-fallback path)."""
        if not self.enabled:
            return
        if self.phase_hist is not None:
            self.phase_hist.observe(secs, phase=phase)

    def plugin_observe(self, plugin: str, point: str, secs: float) -> None:
        """Per-plugin timing from the framework runners; DynamicResources
        time additionally lands in the current cycle's dra_* view phases
        (the ROADMAP's 'DRA allocator Python time' attribution, split so
        future regressions attribute cleanly): host-path PreFilter/Filter
        evaluation feeds dra_device_eval, Reserve/PreBind commit
        bookkeeping feeds dra_commit (dra_mask_compile is observed
        directly by the Scheduler's tensor-build step)."""
        if not self.enabled:
            return
        if self.plugin_hist is not None:
            self.plugin_hist.observe(secs, plugin=plugin,
                                     extension_point=point)
        cur = self.current
        if cur is not None:
            key = f"{plugin}/{point}"
            cur.plugins[key] = cur.plugins.get(key, 0.0) + secs
            if plugin == "DynamicResources":
                cur.add("dra_commit" if point in ("Reserve", "PreBind")
                        else "dra_device_eval", secs)

    def close(self) -> None:
        if self._export_file is not None:
            self._export_file.close()
            self._export_file = None

    # ------------- reading (/debug/trace, bench --profile) -------------

    def last(self, n: int = 32) -> list[dict]:
        if n <= 0:        # [-0:] would be the WHOLE ring, not none of it
            return []
        return [tr.to_dict() for tr in list(self.ring)[-n:]]

    def phase_percentiles(self) -> dict:
        """{phase: {p50_ms, p90_ms, p99_ms, count, total_s}} from the
        phase histogram (bucket-resolution percentiles, like the rest of
        the registry)."""
        h = self.phase_hist
        if h is None:
            return {}
        out = {}
        for k in list(h._series):
            labels = dict(k)
            phase = labels.get("phase", "?")
            s = h._series.get(k)
            if not s:
                continue
            out[phase] = {
                "p50_ms": round(h.percentile(50, **labels) * 1e3, 3),
                "p90_ms": round(h.percentile(90, **labels) * 1e3, 3),
                "p99_ms": round(h.percentile(99, **labels) * 1e3, 3),
                "count": s[2],
                "total_s": round(s[1], 6),
            }
        return out

    def plugin_percentiles(self) -> dict:
        """{"plugin/point": {p50_ms, p99_ms, count, total_s}} from the
        per-plugin histogram — the host-plugin / DRA-allocator slice of
        the bench --profile breakdown."""
        h = self.plugin_hist
        if h is None:
            return {}
        out = {}
        for k in list(h._series):
            labels = dict(k)
            s = h._series.get(k)
            if not s:
                continue
            key = (f"{labels.get('plugin', '?')}/"
                   f"{labels.get('extension_point', '?')}")
            out[key] = {
                "p50_ms": round(h.percentile(50, **labels) * 1e3, 3),
                "p99_ms": round(h.percentile(99, **labels) * 1e3, 3),
                "count": s[2],
                "total_s": round(s[1], 6),
            }
        return out

    def host_tail_share(self) -> float:
        """Fraction of recorded cycle time spent in host-side phases
        (HOST_PHASES) vs everything measured except the dra_* views —
        the per-phase attribution headline for the sub-10x workloads."""
        h = self.phase_hist
        if h is None:
            return 0.0
        host = total = 0.0
        for k in list(h._series):
            phase = dict(k).get("phase", "?")
            if phase in EXCLUDED_PHASES:
                continue
            s = h._series.get(k)
            if not s:
                continue
            total += s[1]
            if phase in HOST_PHASES:
                host += s[1]
        return host / total if total > 0 else 0.0


# the wire stamps a pod's joined end-to-end latency needs (the JAX
# package's telemetry/trace.py; the port keeps its own copy)
JOIN_REQUIRED = ("created", "bound", "acked")


def joined_latency(timeline: dict | None) -> dict | None:
    """Reduce one pod timeline's wire stamps to the joined end-to-end
    latencies. Returns None when the timeline is missing or incomplete
    (one of ``JOIN_REQUIRED`` absent — the pod is not "joinable")."""
    if not timeline:
        return None
    wire = timeline.get("wire") or {}
    if any(k not in wire for k in JOIN_REQUIRED):
        return None
    created, bound, acked = (wire[k]["t"] for k in JOIN_REQUIRED)
    out = {
        "created_ts": round(created, 6),
        "create_to_bind_s": round(bound - created, 6),
        "create_to_ack_s": round(acked - created, 6),
        "bind_to_ack_s": round(acked - bound, 6),
        "relay_hops": max(int(s.get("hops", 0)) for s in wire.values()),
    }
    kr = wire.get("kubelet_recv")
    if kr is not None:
        out["bind_to_kubelet_s"] = round(kr["t"] - bound, 6)
    return out


class PodTimelines:
    """Per-pod lifecycle timelines + last unschedulable diagnosis,
    bounded LRU over pods (the newest ``capacity`` pods touched). Events
    are (t, event, detail) tuples; the per-pod event list is capped so a
    requeue-storm pod cannot grow without bound. Lookup by name or uid
    (``/debug/pod?name=``)."""

    MAX_EVENTS_PER_POD = 64

    def __init__(self, capacity: int = 4096,
                 now: Callable[[], float] = time.time):
        self._now = now
        self._capacity = max(1, capacity)
        # uid -> {"name", "namespace", "events": [...], "diagnosis"}
        self._pods: collections.OrderedDict = collections.OrderedDict()
        self._by_name: dict[str, str] = {}   # "ns/name" -> uid (last wins)

    def _entry(self, pod) -> dict:
        uid = pod.metadata.uid
        e = self._pods.get(uid)
        if e is None:
            e = {"uid": uid, "name": pod.metadata.name,
                 "namespace": pod.metadata.namespace,
                 "events": [], "diagnosis": None, "wire": {}}
            self._pods[uid] = e
            self._by_name[f"{pod.metadata.namespace}/"
                          f"{pod.metadata.name}"] = uid
            while len(self._pods) > self._capacity:
                old_uid, old = self._pods.popitem(last=False)
                key = f"{old['namespace']}/{old['name']}"
                if self._by_name.get(key) == old_uid:
                    del self._by_name[key]
        else:
            self._pods.move_to_end(uid)
        return e

    def event(self, pod, event: str, detail: str = "",
              t: Optional[float] = None) -> None:
        e = self._entry(pod)
        ev = e["events"]
        ev.append((t if t is not None else self._now(), event, detail))
        if len(ev) > self.MAX_EVENTS_PER_POD:
            # keep the first events (enqueue/first attempt anchor the
            # timeline) and the newest tail
            del ev[8:len(ev) - self.MAX_EVENTS_PER_POD + 8]

    def diagnose(self, pod, device_rejects: dict, host_rejects: dict,
                 message: str = "") -> None:
        """Record why the pod's last attempt failed: device filter ->
        nodes-rejected counts (from the pulled reject_counts) and host
        plugin -> counts (from the host/fallback path)."""
        e = self._entry(pod)
        e["diagnosis"] = {
            "at": self._now(),
            "device_rejects": dict(device_rejects),
            "host_rejects": dict(host_rejects),
            "message": message,
        }

    def wire_stamp(self, pod, stamp: str, t: float, origin: str = "",
                   hops: int = 0) -> None:
        """Record one cross-wire trace stamp (telemetry.trace) on this
        pod's timeline: ``created`` (the pod's hub add commit),
        ``bound`` (the bind's hub commit), ``acked`` (the kubelet's
        status-Running commit), ``kubelet_recv`` (the bound event's
        arrival at the kubelet after its relay hops). Last stamp wins —
        a relist replaying an event re-stamps identically. Also logged
        as an ordinary timeline event so /debug/pod reads as one
        story."""
        e = self._entry(pod)
        e["wire"][stamp] = {"t": round(t, 6), "origin": origin,
                            "hops": hops}
        detail = f"origin={origin} hops={hops}" if origin else ""
        ev = e["events"]
        ev.append((t, f"wire:{stamp}", detail))
        if len(ev) > self.MAX_EVENTS_PER_POD:
            del ev[8:len(ev) - self.MAX_EVENTS_PER_POD + 8]

    def wire_of(self, uid: str) -> Optional[dict]:
        """The raw wire stamps recorded so far for one pod (None when
        the pod is untracked or unstamped) — the export rows' trace
        column reads this at commit time."""
        e = self._pods.get(uid)
        return (e["wire"] or None) if e else None

    def joined(self, uid: str) -> Optional[dict]:
        """The joined end-to-end trace for one pod (or None while
        incomplete) — telemetry.trace.joined_latency over the wire
        stamps."""
        e = self._pods.get(uid)
        return joined_latency(e) if e else None

    def uids(self) -> list[str]:
        return list(self._pods)

    def bind_latencies(self) -> dict[str, float]:
        """uid -> first-enqueued → first-bound seconds for every tracked
        pod that bound — the ONE time-to-bind pass behind both the bench
        quality rows and the scenario replay harness's SLO gate
        (telemetry.slo). Pods that never bound (or whose enqueue stamp
        was LRU-evicted) are absent; callers that need full coverage
        size the timelines to the workload (config.timelines_capacity)."""
        out: dict[str, float] = {}
        for uid, e in self._pods.items():
            enq = bind = None
            for t, ev, _detail in e["events"]:
                if enq is None and ev == "enqueued":
                    enq = t
                elif bind is None and ev == "bound":
                    bind = t
                if enq is not None and bind is not None:
                    break
            if enq is not None and bind is not None and bind >= enq:
                out[uid] = bind - enq
        return out

    def get(self, name: str = "", uid: str = "",
            namespace: str = "default") -> Optional[dict]:
        if not uid and name:
            uid = self._by_name.get(f"{namespace}/{name}", "")
        e = self._pods.get(uid)
        if e is None:
            return None
        return {
            "uid": e["uid"], "name": e["name"],
            "namespace": e["namespace"],
            "events": [{"t": round(t, 6), "event": ev, "detail": d}
                       for t, ev, d in e["events"]],
            "diagnosis": e["diagnosis"],
            "wire": dict(e["wire"]),
            "joined": joined_latency(e),
        }

    def forget(self, uid: str) -> None:
        e = self._pods.pop(uid, None)
        if e is not None:
            key = f"{e['namespace']}/{e['name']}"
            if self._by_name.get(key) == uid:
                del self._by_name[key]

    def __len__(self) -> int:
        return len(self._pods)
