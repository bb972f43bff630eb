"""Per-placement regret + the promotion gate's replay scorer.

**Regret** (ROADMAP item 4): for each exported placement the export v3
rows carry the top-K alternative node scores the device pipeline
computed in the same launch (``trace_export_alts``). The journal/WAL
outcome labels — evictions (a bound pod's DELETE), slow time-to-bind,
topology-domain crowding — shade the CHOSEN placement's realized value
exactly like the replay dataset's reward shading, and

    regret = max(0, best_alternative_score − chosen_score × outcome)

is the score mass the scheduler gave up by the choice it made, in
aggregate-score points: 0 when the chosen node was best and its
placement stuck, positive when a runner-up would have been better or
the outcome went bad. Summaries (mean/p50/p99) land in every bench
artifact row that ran with the alt export on, in the learn-loop's
metrics, and in the promoted checkpoint's meta (/debug/scorer).

**Replay scoring** (the gate): a candidate checkpoint is compared to
the live one on held-out recent placement rows WITHOUT touching the
cluster — each policy scores the rows it would have preferred, and the
preference mass it concentrates on placements whose measured outcome
was bad on each quality axis is its demerit:

- ``preemptions``   — preference mass on later-evicted placements
- ``spread``        — preference-weighted domain-crowding excess
- ``time_to_bind_p99_s`` — preference-weighted p99 of time-to-bind

Lower is better on all three. ``gate_candidate`` promotes only when
the candidate wins ≥2 metrics (or strictly improves ≥1 with zero
regressions, for near-degenerate clean traffic) at latency parity —
the "Learning to Score" quality bar, evaluated offline so a bad
candidate never serves a single placement.

Everything here is host-side numpy over parsed export rows — no device
work, no JAX import at module load.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np

from kubernetes_tpu_torch.learn.replay import (
    CROWDING_SHADE,
    EVICT_PENALTY,
    HOSTNAME_LABEL,
    SLOW_BIND_SHADE,
    ZONE_LABEL,
)
from kubernetes_tpu_torch.ops.learned import MAX_SCORE, NUM_FEATURES

# the three gated quality metrics, in reporting order
QUALITY_METRICS = ("preemptions", "spread", "time_to_bind_p99_s")


def np_mlp(params, x: np.ndarray) -> np.ndarray:
    """The ops.learned.mlp_apply forward pass in plain numpy — the gate
    scores thousands of held-out rows without a JAX dispatch (and its
    latency probe measures param-stack cost, not jit cache state)."""
    out = np.asarray(x, np.float32)
    last = len(params) - 1
    for i, (w, b) in enumerate(params):
        out = out @ np.asarray(w, np.float32) + np.asarray(b, np.float32)
        if i < last:
            out = np.maximum(out, 0.0)
    return out[..., 0]


def _ttb_map(rows: list[dict]) -> dict[str, float]:
    """uid -> time-to-bind seconds (first exported attempt -> bind
    cycle), the same anchoring as the replay dataset's shading.
    Order-INDEPENDENT (min over timestamps, not first list occurrence):
    callers assemble row windows out of chronological order — e.g. the
    gate's holdout + appended anchor rows."""
    first_seen: dict[str, float] = {}
    bind_at: dict[str, float] = {}
    for r in rows:
        uid = r.get("uid", "")
        if not uid:
            continue
        t = float(r.get("t", 0.0))
        first_seen[uid] = min(first_seen.get(uid, t), t)
        if r.get("node") is not None:
            bind_at[uid] = min(bind_at.get(uid, t), t)
    return {u: bind_at[u] - first_seen.get(u, bind_at[u]) for u in bind_at}


def _domain_counts(rows: list[dict],
                   node_domain: dict) -> tuple[dict, float]:
    counts: dict = {}
    for r in rows:
        n = r.get("node")
        if n is None:
            continue
        d = node_domain.get(n, n)
        counts[d] = counts.get(d, 0) + 1
    mean = (sum(counts.values()) / len(counts)) if counts else 0.0
    return counts, mean


def outcome_factors(rows: list[dict], evicted: Optional[set] = None,
                    node_domain: Optional[dict] = None) -> list[float]:
    """Per-row realized-outcome factor around 1.0, aligned with
    ``rows`` — the exact shading arithmetic the replay dataset applies
    to rewards (evictions, slow binds, domain crowding), reused so
    regret and training read the same outcome labels."""
    evicted = evicted or set()
    node_domain = node_domain or {}
    ttbs = _ttb_map(rows)
    med = float(np.median(list(ttbs.values()))) if ttbs else 0.0
    counts, mean = _domain_counts(rows, node_domain)
    out = []
    for r in rows:
        f = 1.0
        uid = r.get("uid", "")
        node = r.get("node")
        if node is not None:
            if uid in evicted:
                f *= EVICT_PENALTY
            if med > 0:
                rel = ttbs.get(uid, med) / med
                f /= 1.0 + max(0.0, rel - 1.0) * SLOW_BIND_SHADE
            if len(counts) > 1 and mean > 0:
                imb = counts[node_domain.get(node, node)] / mean
                f /= 1.0 + max(0.0, imb - 1.0) * CROWDING_SHADE
        out.append(f)
    return out


def compute_regret(rows: Iterable[dict], evicted: Optional[set] = None,
                   node_domain: Optional[dict] = None) -> list[dict]:
    """Per-placement regret records over flattened placement rows
    (replay.iter_placement_rows shape). Only bound placements that
    carry at least one alternative OTHER than the chosen node
    participate — a row without a counterfactual has nothing to regret
    against. When the chosen node's own entry rides the alt list (the
    export keeps it wherever top_k surfaced it), that entry is the
    chosen value's basis — on the auction path the alt scores are
    end-state attributed while the row's "score" is the decision-round
    win, and regret must compare both sides on ONE basis. Each record:
    {"uid", "node", "t", "score", "best_alt", "outcome", "regret"}."""
    rows = list(rows)
    factors = outcome_factors(rows, evicted, node_domain)
    out = []
    for r, f in zip(rows, factors):
        node = r.get("node")
        alts = r.get("alt") or []
        others = [float(s) for n, s in alts if n != node]
        if node is None or not others:
            continue
        best_alt = max(others)
        chosen_basis = next((float(s) for n, s in alts if n == node),
                            float(r.get("score", 0.0)))
        chosen = chosen_basis * f
        out.append({"uid": r.get("uid", ""), "node": node,
                    "t": float(r.get("t", 0.0)),
                    "score": chosen_basis, "best_alt": best_alt,
                    "outcome": round(f, 6),
                    "regret": max(0.0, best_alt - chosen)})
    return out


def summarize_regret(records: list[dict]) -> dict:
    """{count, regret_mean, regret_p50, regret_p99,
    regret_positive_frac} over compute_regret records — the shape the
    bench artifact rows, the loop metrics, and checkpoint meta embed."""
    if not records:
        return {"count": 0, "regret_mean": 0.0, "regret_p50": 0.0,
                "regret_p99": 0.0, "regret_positive_frac": 0.0}
    reg = np.asarray([r["regret"] for r in records], np.float64)
    return {
        "count": int(reg.size),
        "regret_mean": round(float(reg.mean()), 4),
        "regret_p50": round(float(np.percentile(reg, 50)), 4),
        "regret_p99": round(float(np.percentile(reg, 99)), 4),
        "regret_positive_frac": round(float((reg > 0).mean()), 4),
    }


def harvest_hub_outcomes(hub) -> tuple[set, dict]:
    """(evicted_uids, node -> topology domain) from a LIVE in-process
    hub — the perf harness's analog of replay.wal_outcomes: bound-pod
    DELETE events in the journal are the eviction signal, node labels
    map to zone (hostname fallback) domains. A compacted journal
    (too_old) yields partial eviction data; domains stay complete."""
    evicted: set = set()
    node_domain: dict = {}
    try:
        for n in hub.list_nodes():
            labels = n.metadata.labels or {}
            node_domain[n.metadata.name] = labels.get(
                ZONE_LABEL, labels.get(HOSTNAME_LABEL, n.metadata.name))
    except Exception:  # noqa: BLE001 — hub variant without list_nodes
        pass
    try:
        ans = hub.list_changes(0, kinds=("pods",))
        if not ans.get("too_old"):
            for ch in ans.get("changes", []):
                if ch.get("type") != "delete":
                    continue
                obj = ch.get("obj")
                if obj is not None and getattr(obj.spec, "node_name", ""):
                    evicted.add(obj.metadata.uid)
    except Exception:  # noqa: BLE001 — hub variant without a journal
        pass
    return evicted, node_domain


# ------------------------------------------------ gate replay scoring


def replay_quality(params, rows: list[dict],
                   evicted: Optional[set] = None,
                   node_domain: Optional[dict] = None,
                   latency_repeats: int = 3) -> dict:
    """Score one policy's quality on held-out placement rows (see
    module docstring): preference-mass demerits per quality axis, lower
    is better, plus the batch-eval latency probe. Scored rows must
    carry feature vectors (the gate's holdout is feature-exported);
    failed-attempt anchor rows (node None) should ride along — they
    establish first_seen for the time-to-bind axis."""
    evicted = evicted or set()
    node_domain = node_domain or {}
    rows = list(rows)
    placed = [r for r in rows
              if r.get("node") is not None and r.get("feat")
              and len(r["feat"]) == NUM_FEATURES]
    if not placed:
        raise ValueError("no held-out placement rows with feature "
                         "vectors to replay-score against")
    x = np.asarray([r["feat"] for r in placed], np.float32)
    lat = float("inf")
    for _ in range(max(1, latency_repeats)):
        t0 = time.perf_counter()
        s = np_mlp(params, x)
        lat = min(lat, time.perf_counter() - t0)
    s = np.clip(s, 0.0, MAX_SCORE)
    # preference mass: a policy "prefers" the placements it scores
    # high; the +eps floor keeps an all-zero scorer uniform instead of
    # degenerate
    w = s.astype(np.float64) + 1e-3
    w_sum = float(w.sum())
    ev = np.asarray([1.0 if r.get("uid", "") in evicted else 0.0
                     for r in placed])
    counts, mean = _domain_counts(placed, node_domain)
    crowd = np.asarray([
        max(0.0, counts[node_domain.get(r["node"], r["node"])] / mean
            - 1.0) if mean > 0 else 0.0
        for r in placed])
    # anchored on ALL rows (incl. node=None failed attempts), not just
    # the scored placements — a placement row alone makes every
    # time-to-bind collapse to 0 and the axis permanently tie
    ttbs = _ttb_map(rows)
    ttb = np.asarray([ttbs.get(r.get("uid", ""), 0.0) for r in placed])
    # preference-weighted p99 of time-to-bind: sort by ttb, walk the
    # preference mass to the 99th percentile
    order = np.argsort(ttb)
    cum = np.cumsum(w[order])
    idx = int(np.searchsorted(cum, 0.99 * w_sum))
    ttb_p99 = float(ttb[order][min(idx, len(placed) - 1)])
    return {
        "preemptions": round(float((w * ev).sum() / w_sum), 6),
        "spread": round(float((w * crowd).sum() / w_sum), 6),
        "time_to_bind_p99_s": round(ttb_p99, 6),
        "latency_s": lat,
        "rows": len(placed),
    }


def gate_candidate(cand_params, live_params, rows: list[dict],
                   evicted: Optional[set] = None,
                   node_domain: Optional[dict] = None,
                   quality_eps: float = 0.01,
                   latency_budget: float = 0.5,
                   latency_floor_s: float = 1e-4) -> dict:
    """The promotion verdict: replay-score candidate vs live on the
    held-out rows. Promote when the candidate wins ≥2 of the 3 quality
    metrics — or strictly improves ≥1 with zero regressions, the
    clean-traffic escape hatch where a metric axis is degenerate (no
    evictions at all ties preemptions forever) — at latency parity
    (candidate batch-eval ≤ live × (1 + budget), with an absolute
    floor so microsecond jitter on tiny stacks can't fail parity).
    ``live_params is None`` is the bootstrap: nothing is serving, the
    first trained candidate promotes unconditionally."""
    if live_params is None:
        return {"promote": True, "bootstrap": True, "wins": [],
                "losses": [], "latency_ok": True}
    qc = replay_quality(cand_params, rows, evicted, node_domain)
    ql = replay_quality(live_params, rows, evicted, node_domain)
    wins, losses = [], []
    for k in QUALITY_METRICS:
        margin = quality_eps * max(abs(ql[k]), abs(qc[k]), 1e-6)
        if qc[k] < ql[k] - margin:
            wins.append(k)
        elif qc[k] > ql[k] + margin:
            losses.append(k)
    latency_ok = (qc["latency_s"]
                  <= ql["latency_s"] * (1.0 + latency_budget)
                  + latency_floor_s)
    promote = latency_ok and (len(wins) >= 2
                              or (len(wins) >= 1 and not losses))
    return {"promote": promote, "bootstrap": False,
            "wins": wins, "losses": losses, "latency_ok": latency_ok,
            "candidate": qc, "live": ql}
