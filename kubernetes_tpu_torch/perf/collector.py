"""Throughput + latency collection for the perf harness.

Equivalent of the reference's throughput collector
(test/integration/scheduler_perf/util.go:442-630): scheduled-pod counts
are bucketed into 1-second windows from the start of the measured phase;
the summary reports the overall average (pods scheduled / elapsed) plus
percentiles over the per-window samples, matching how scheduler_perf's
`SchedulingThroughput` metric items are computed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile (the reference reports p50/90/95/99 via its
    metrics histograms; nearest-rank over raw samples is the exact analog
    for the harness's window samples)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   math.ceil(q / 100.0 * len(sorted_vals)) - 1))
    return sorted_vals[k]


@dataclass
class ThroughputSummary:
    pods_scheduled: int
    elapsed_s: float
    pods_per_sec: float          # overall average over the measured phase
    windows: list[int] = field(default_factory=list)   # per-1s-window counts
    p50: float = 0.0             # percentiles over window samples (pods/s)
    p90: float = 0.0
    p95: float = 0.0
    p99: float = 0.0

    def to_dict(self) -> dict:
        return {
            "pods_scheduled": self.pods_scheduled,
            "elapsed_s": round(self.elapsed_s, 3),
            "pods_per_sec": round(self.pods_per_sec, 1),
            "windows": len(self.windows),
            "p50": round(self.p50, 1),
            "p90": round(self.p90, 1),
            "p95": round(self.p95, 1),
            "p99": round(self.p99, 1),
        }


class ThroughputCollector:
    """Observes bind timestamps for a measured pod set.

    The harness registers a hub pod watch; on each update where a measured
    pod gains spec.nodeName the bind time is recorded (the same signal the
    reference collector reads from the informer: a pod with a non-empty
    NodeName counts as scheduled, util.go:560).
    """

    def __init__(self, measured_uids: set[str], now) -> None:
        self._measured = measured_uids
        self._now = now
        self._times: dict[str, float] = {}   # uid -> bind time (first only)
        self.start: float | None = None

    def begin(self) -> None:
        self.start = self._now()

    # hub watch callbacks -------------------------------------------------

    def on_update(self, old, new) -> None:
        if (new.spec.node_name and new.metadata.uid in self._measured
                and new.metadata.uid not in self._times):
            self._times[new.metadata.uid] = self._now()

    def on_add(self, pod) -> None:
        if (pod.spec.node_name and pod.metadata.uid in self._measured
                and pod.metadata.uid not in self._times):
            self._times[pod.metadata.uid] = self._now()

    # results -------------------------------------------------------------

    def scheduled_count(self) -> int:
        return len(self._times)

    def done(self) -> bool:
        return len(self._times) == len(self._measured)

    def summarize(self, end: float | None = None) -> ThroughputSummary:
        assert self.start is not None, "begin() not called"
        end = end if end is not None else (
            max(self._times.values()) if self._times else self.start)
        elapsed = max(end - self.start, 1e-9)
        n = len(self._times)
        # 1s windows from phase start (util.go:560: one sample per COMPLETED
        # second — a partial tail window would read as a spuriously low
        # pods/s sample, so it's excluded from the percentile samples)
        full = int(elapsed)
        num_windows = max(1, math.ceil(elapsed))
        counts = [0] * num_windows
        for t in self._times.values():
            w = min(int(t - self.start), num_windows - 1)
            counts[w] += 1
        if full >= 1:
            samples = sorted(float(c) for c in counts[:full])
        else:
            samples = [n / elapsed]   # sub-second run: one avg sample
        return ThroughputSummary(
            pods_scheduled=n,
            elapsed_s=elapsed,
            pods_per_sec=n / elapsed,
            windows=counts,
            p50=percentile(samples, 50),
            p90=percentile(samples, 90),
            p95=percentile(samples, 95),
            p99=percentile(samples, 99),
        )
