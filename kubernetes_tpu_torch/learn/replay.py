"""Replay dataset: training examples for the learned scorer from the
scheduler's trace exports (port of the JAX package's learn/replay.py).

Placement rows of export format v2+ ({pod, uid, chosen node, winning
aggregate, chosen-node feature vector[, top-K alternatives]}) become
[M, 9] feature rows, behavior-cloning targets (the hand-tuned aggregate
rescaled to [0, 100], reconstructed from the features) and outcome
rewards shaded by time-to-bind, evictions (a bound pod's DELETE in the
journal WAL) and topology-domain crowding. Pure numpy: the trainer
(learn/train.py) moves the arrays to its device.

The WAL's records are the wire form of the objects (tagged dicts); this
reader takes the few fields it needs from them directly (a pod's uid and
node, a node's name and labels) instead of decoding whole objects.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

import numpy as np

from kubernetes_tpu_torch.ops.learned import NUM_FEATURES, hand_weight_vector

logger = logging.getLogger("kubernetes_tpu_torch.learn")

# oldest export format this reader accepts: v2 introduced the placement
# rows + feature vectors this dataset is built from. v3 (the "alt"
# top-K alternative scores) is additive, so v2 rows stay valid input —
# the reader keys on its own floor, NOT the writer's EXPORT_VERSION,
# so bumping the writer never silently discards yesterday's traces.
REPLAY_MIN_VERSION = 2


def bc_targets(x: np.ndarray) -> np.ndarray:
    """[M] behavior-cloning targets in [0, 100]: the hand-tuned
    weighted sum over the feature-expressible plugin scores,
    reconstructed from the feature rows (features are score/100, so
    (x @ w) * 100 / sum(w) is exactly the rescaled aggregate — no
    clipping, no topology contamination)."""
    w = hand_weight_vector()
    return ((x @ w) * (100.0 / w.sum())).astype(np.float32)

EVICT_PENALTY = 0.25          # reward factor for later-evicted placements
SLOW_BIND_SHADE = 0.25        # shade per unit of above-median bind time
CROWDING_SHADE = 0.5          # shade per unit of above-mean domain count

ZONE_LABEL = "topology.kubernetes.io/zone"
HOSTNAME_LABEL = "kubernetes.io/hostname"


@dataclass
class ReplayDataset:
    """x [M, F] float32 features; y [M] behavior-clone targets in
    [0, 100]; reward [M] outcome weights around 1.0; agg_score [M] the
    exported winning aggregate (analysis only — includes topology/host
    terms the features cannot express)."""

    x: np.ndarray
    y: np.ndarray
    reward: np.ndarray
    agg_score: np.ndarray = None
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return self.x.shape[0]


def iter_trace_lines(path: str) -> Iterator[dict]:
    """Lazily parse one export file; malformed lines (a torn tail from a
    live scheduler, a rotation boundary) are skipped, not fatal."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue


def apply_wal_record(rec: dict, evicted: set, node_domain: dict) -> None:
    """Fold ONE parsed WAL record into the outcome maps: a bound pod's
    DELETE is the eviction/preemption signal (victims are deleted by
    the scheduler's eviction flush; a completed pod exits through the
    same door — both mean the placement did not stick), and node
    ADD/UPDATE events carry the labels that map each node to its zone
    (hostname fallback) domain. Idempotent (sets/last-wins), so the
    learn-loop's incremental WAL tail can safely re-apply a window."""
    kind = rec.get("kind")
    try:
        if kind == "pods" and rec.get("type") == "delete":
            old = rec.get("old") or {}
            uid = (old.get("metadata") or {}).get("uid")
            if uid and (old.get("spec") or {}).get("node_name"):
                evicted.add(uid)
        elif kind == "nodes" and rec.get("type") in ("add", "update"):
            meta = (rec.get("new") or {}).get("metadata") or {}
            name = meta.get("name")
            if name:
                labels = meta.get("labels") or {}
                node_domain[name] = labels.get(
                    ZONE_LABEL, labels.get(HOSTNAME_LABEL, name))
    except Exception:  # noqa: BLE001 — one bad record is data loss,
        pass           # not a failed build


def wal_outcomes(wal_path: str) -> tuple[set, dict]:
    """(evicted_uids, node -> topology domain) from the whole journal
    WAL (apply_wal_record over every line)."""
    evicted: set = set()
    node_domain: dict = {}
    with open(wal_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue        # torn tail — storage tolerates it too
            apply_wal_record(rec, evicted, node_domain)
    return evicted, node_domain


def iter_placement_rows(lines: Iterable[dict]) -> Iterator[dict]:
    """Flatten trace lines into per-placement row dicts — {"uid",
    "node", "score", "feat", "alt", "t"} with node None for failed
    attempts (time-to-bind anchors). Pre-v2 lines yield nothing. The
    shared substrate of the file-based builder, the learn-loop's
    in-memory tail, and regret computation."""
    for line in lines:
        if not isinstance(line, dict) \
                or line.get("v", 1) < REPLAY_MIN_VERSION:
            continue
        t = float(line.get("start", 0.0))
        for row in line.get("placements") or []:
            yield {"uid": row.get("uid", ""), "node": row.get("node"),
                   "score": float(row.get("score", 0.0)),
                   "feat": row.get("feat"),
                   "alt": row.get("alt"), "t": t}


def build_dataset_rows(rows: Iterable[dict],
                       evicted: Optional[set] = None,
                       node_domain: Optional[dict] = None,
                       max_examples: int = 500_000) -> ReplayDataset:
    """The dataset arithmetic over flattened placement rows
    (iter_placement_rows shape): BC targets from the feature rows,
    outcome rewards shaded by time-to-bind, evictions, and domain
    crowding. Raises ValueError when no row carries a feature vector."""
    feats: list = []
    scores: list = []
    uids: list = []
    nodes: list = []
    first_seen: dict = {}
    bind_at: dict = {}
    rows_seen = 0
    for row in rows:
        rows_seen += 1
        uid = row.get("uid", "")
        t = float(row.get("t", 0.0))
        if uid and uid not in first_seen:
            first_seen[uid] = t
        node = row.get("node")
        if node is None:
            continue        # failed attempt: time-to-bind anchor only
        feat = row.get("feat")
        if not feat or len(feat) != NUM_FEATURES:
            continue
        if len(feats) >= max_examples:
            continue
        bind_at.setdefault(uid, t)
        feats.append(feat)
        scores.append(float(row.get("score", 0.0)))
        uids.append(uid)
        nodes.append(node)
    if not feats:
        raise ValueError(
            f"no placement rows with feature vectors among {rows_seen} "
            "rows; run the scheduler with trace_export_path set AND "
            "trace_export_features=true (the feature export is opt-in)")
    x = np.asarray(feats, np.float32)
    y = bc_targets(x)
    reward = np.ones((len(feats),), np.float32)

    # time-to-bind shading: placements that took longer than the median
    # pod (first attempt -> bind) carry less weight
    ttbs = {u: bind_at[u] - first_seen.get(u, bind_at[u]) for u in bind_at}
    med = float(np.median(list(ttbs.values()))) if ttbs else 0.0
    if med > 0:
        for i, uid in enumerate(uids):
            rel = ttbs.get(uid, med) / med
            reward[i] /= 1.0 + max(0.0, rel - 1.0) * SLOW_BIND_SHADE

    evicted = evicted or set()
    node_domain = node_domain or {}
    for i, uid in enumerate(uids):
        if uid in evicted:
            reward[i] *= EVICT_PENALTY
    # topology-domain crowding: placements into domains that ended up
    # holding more than their share of this replay's pods shade down —
    # the spread-imbalance outcome label
    domains = [node_domain.get(n, n) for n in nodes]
    counts: dict = {}
    for d in domains:
        counts[d] = counts.get(d, 0) + 1
    if len(counts) > 1:
        mean = sum(counts.values()) / len(counts)
        for i, d in enumerate(domains):
            imb = counts[d] / mean
            reward[i] /= 1.0 + max(0.0, imb - 1.0) * CROWDING_SHADE
    return ReplayDataset(
        x=x, y=y, reward=reward,
        agg_score=np.asarray(scores, np.float32),
        meta={"examples": len(feats),
              "evicted": len(evicted),
              "domains": len(counts),
              "uids": uids, "nodes": nodes,
              "ttb_median_s": round(med, 6)})


def build_dataset(trace_paths: Iterable[str],
                  wal_path: Optional[str] = None,
                  max_examples: int = 500_000) -> ReplayDataset:
    """Reconstruct a training set from export files (+ optional WAL for
    outcome labels). Raises ValueError when no usable placement rows are
    found (exports predating format v2 carry no feature rows)."""
    lines = 0
    skipped_old = 0
    raw: list = []
    for path in ([trace_paths] if isinstance(trace_paths, str)
                 else list(trace_paths)):
        for line in iter_trace_lines(path):
            lines += 1
            if line.get("v", 1) < REPLAY_MIN_VERSION:
                skipped_old += 1
                continue
            raw.append(line)
    evicted: set = set()
    node_domain: dict = {}
    if wal_path:
        evicted, node_domain = wal_outcomes(wal_path)
    try:
        ds = build_dataset_rows(iter_placement_rows(raw),
                                evicted=evicted, node_domain=node_domain,
                                max_examples=max_examples)
    except ValueError:
        raise ValueError(
            f"no v{REPLAY_MIN_VERSION}+ placement rows with feature "
            f"vectors found ({lines} trace lines, {skipped_old} "
            f"pre-v{REPLAY_MIN_VERSION}); run the scheduler with "
            "trace_export_path set AND trace_export_features=true "
            "(the feature export is opt-in)") from None
    ds.meta.pop("uids", None)
    ds.meta.pop("nodes", None)
    ds.meta.update({"trace_lines": lines, "skipped_pre_v2": skipped_old})
    return ds


def synthetic_dataset(seed: int = 0, n: int = 512,
                      noise: float = 2.0) -> ReplayDataset:
    """A tiny synthetic replay for smoke training (CI keeps a <30s
    train on this): features uniform in the unit cube, targets the
    hand-tuned-shaped combination plus noise, rewards favoring
    low-utilization placements (a learnable signal distinct from the
    BC target)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(n, NUM_FEATURES)).astype(np.float32)
    y = np.clip(bc_targets(x) + rng.normal(0.0, noise, size=n),
                0.0, 100.0).astype(np.float32)
    reward = (1.25 - 0.5 * (x[:, 0] + x[:, 1]) / 2.0).astype(np.float32)
    return ReplayDataset(x=x, y=y, reward=reward,
                         meta={"examples": n, "synthetic": True,
                               "seed": seed})
