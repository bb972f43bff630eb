"""The retrain daemon: tail exports → retrain → gate → promote (port of
the JAX package's learn/loop.py; the retrain is learn/train.py's, whose
step is kernel K10 on the card: ``LoopConfig.device``).

Closes the learning loop (the JAX package's ROADMAP item 4; the RL
custom-scheduler's online policy tuning, arXiv:2601.13579, and
"Learning to Score"'s reward-driven refresh, arXiv:2603.10545): instead
of a human running ``learn train`` and a new checkpoint going live on
mtime alone,

1. **ExportCursor** tails the scheduler's rotating trace export
   (``path`` + the keep-last-1 ``path.1``) with torn-line- and
   rotation-aware byte cursors: a partial tail line is never consumed
   (the live scheduler is still writing it), a rotation is detected by
   inode and the rotated file's remainder is drained before the fresh
   file, and the cursor persists to the loop state file so a daemon
   restart resumes mid-tail without re-training on duplicate rows.
2. **LearnLoop.run_once** retrains when enough new placement rows
   accumulated: BC warm start, then the regret-weighted
   contextual-bandit fine-tune — each example's outcome reward is
   additionally shaded by its per-placement regret (the export v3
   counterfactual rows), so placements a runner-up would have beaten
   push the scorer hardest. Candidates land in a STAGING path with a
   monotonically-versioned, generation-stamped meta.
3. **Gated promotion**: the candidate is replay-scored against the
   live checkpoint on held-out recent rows (learn.regret.gate_candidate
   — ≥2 quality-metric wins at latency parity) and only a winner is
   published to the path the scheduler's CheckpointWatcher polls.
   The displaced live checkpoint is preserved as ``last-good.json``;
   when the regret observed on traffic scheduled AFTER a promotion
   regresses past the promotion-time baseline, the loop automatically
   republishes last-good (with a fresh version bump so the watcher
   reloads) and counts a rollback.

``python -m kubernetes_tpu_torch.learn loop --once`` runs one iteration and
prints the report; without ``--once`` it polls on a cadence. The
loop's own Registry carries the ``scheduler_learn_loop_*`` metrics.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

from kubernetes_tpu_torch.learn import checkpoint as ck
from kubernetes_tpu_torch.learn import regret as RG
from kubernetes_tpu_torch.learn.replay import (
    apply_wal_record,
    build_dataset_rows,
    iter_placement_rows,
)
from kubernetes_tpu_torch.metrics import Counter, Gauge, Registry
from kubernetes_tpu_torch.ops.learned import MAX_SCORE, NUM_FEATURES

logger = logging.getLogger("kubernetes_tpu_torch.learn.loop")


class LoopMetrics:
    """scheduler_learn_loop_*: the daemon's own registry (it is its own
    process — scraping rides render_text / the report JSON)."""

    def __init__(self, registry: Optional[Registry] = None):
        r = self.registry = registry or Registry()
        self.rows = r.register(Counter(
            "scheduler_learn_loop_rows_total",
            "Placement rows consumed from the trace-export tail"))
        self.retrains = r.register(Counter(
            "scheduler_learn_loop_retrains_total",
            "Retrain rounds completed (a candidate was produced)"))
        self.promotions = r.register(Counter(
            "scheduler_learn_loop_promotions_total",
            "Candidate checkpoints promoted to the live path"))
        self.rejected = r.register(Counter(
            "scheduler_learn_loop_rejected_total",
            "Candidate checkpoints rejected by the promotion gate "
            "(last-good keeps serving)"))
        self.rollbacks = r.register(Counter(
            "scheduler_learn_loop_rollbacks_total",
            "Automatic rollbacks to last-good after a post-promotion "
            "regret regression"))
        self.generation = r.register(Gauge(
            "scheduler_learn_loop_generation",
            "Latest candidate generation this loop produced"))
        self.live_generation = r.register(Gauge(
            "scheduler_learn_loop_live_generation",
            "Generation currently published to the live path"))
        self.regret_mean = r.register(Gauge(
            "scheduler_learn_loop_regret_mean",
            "Mean per-placement regret over the latest consumed rows"))
        self.regret_p99 = r.register(Gauge(
            "scheduler_learn_loop_regret_p99",
            "p99 per-placement regret over the latest consumed rows"))


def _read_complete_lines(fn: str, offset: int,
                         out: list[str]) -> int:
    """Append the COMPLETE lines of ``fn`` after byte ``offset`` to
    ``out``; returns the new offset (never past the last newline, so a
    torn tail a live writer is still producing stays unconsumed). The
    one tail-read primitive both the export cursor and the WAL tail
    build on."""
    try:
        with open(fn, "rb") as f:
            f.seek(offset)
            data = f.read()
    except OSError:
        return offset
    end = data.rfind(b"\n")
    if end < 0:
        return offset
    for raw in data[:end].split(b"\n"):
        if raw.strip():
            out.append(raw.decode("utf-8", "replace"))
    return offset + end + 1


class ExportCursor:
    """Byte cursor over the rotating trace export. ``read_lines``
    returns only COMPLETE new lines (a torn tail stays unconsumed for
    the next poll); rotation (FlightRecorder's keep-last-1
    ``os.replace`` to ``path.1``) is detected by inode, and the rotated
    file's remainder is drained before the fresh file. ``state()`` /
    ``restore()`` round-trip through the loop state file."""

    def __init__(self, path: str):
        self.path = path
        self.ino: Optional[int] = None
        self.offset = 0
        # the rotated predecessor (<path>.1), tracked by its OWN
        # inode+offset so polls while the live file is absent (daemon
        # started first, or a failed rotation disabled the export)
        # never re-consume it from byte 0
        self.prev_ino: Optional[int] = None
        self.prev_offset = 0
        self.lines_read = 0
        # rotations whose predecessor was already replaced again before
        # we polled — those rows are gone (poll faster or raise the
        # export's size bound)
        self.missed_rotations = 0

    def state(self) -> dict:
        return {"ino": self.ino, "offset": self.offset,
                "prev_ino": self.prev_ino,
                "prev_offset": self.prev_offset,
                "lines_read": self.lines_read,
                "missed_rotations": self.missed_rotations}

    def restore(self, st: dict) -> None:
        self.ino = st.get("ino")
        self.offset = int(st.get("offset", 0))
        self.prev_ino = st.get("prev_ino")
        self.prev_offset = int(st.get("prev_offset", 0))
        self.lines_read = int(st.get("lines_read", 0))
        self.missed_rotations = int(st.get("missed_rotations", 0))

    def _consume(self, fn: str, offset: int, out: list[str]) -> int:
        return _read_complete_lines(fn, offset, out)

    def _drain_prev(self, out: list[str]) -> None:
        """Incrementally consume <path>.1 under its own cursor: a fresh
        inode (first sight, or a newer rotation) starts from 0; an
        already-tracked one resumes from prev_offset — repeated polls
        while the live file is absent never duplicate."""
        try:
            st1 = os.stat(self.path + ".1")
        except OSError:
            return
        if st1.st_ino != self.prev_ino:
            self.prev_ino = st1.st_ino
            self.prev_offset = 0
        self.prev_offset = self._consume(self.path + ".1",
                                         self.prev_offset, out)

    def read_lines(self) -> list[str]:
        out: list[str] = []
        try:
            st = os.stat(self.path)
        except OSError:
            st = None
        if self.ino is not None \
                and (st is None or st.st_ino != self.ino):
            # rotation (or the export vanished): our live file should
            # now be path.1 (os.replace keeps the inode) — hand our
            # offset to the predecessor cursor so its tail drains
            try:
                st1 = os.stat(self.path + ".1")
            except OSError:
                st1 = None
            if st1 is not None and st1.st_ino == self.ino:
                self.prev_ino = self.ino
                self.prev_offset = self.offset
            else:
                self.missed_rotations += 1
                logger.warning("export cursor lost a rotation of %s "
                               "(predecessor already replaced)",
                               self.path)
            self.ino = None
            self.offset = 0
        if self.ino is None:
            # (re)attach: drain the rotated predecessor first (oldest
            # rows), then the live file from byte 0
            self._drain_prev(out)
            if st is not None:
                self.ino = st.st_ino
                self.offset = self._consume(self.path, 0, out)
        else:
            # common case: same file, tail from our offset. A file
            # that SHRANK in place (same inode — an operator's
            # `> traces.jsonl`, run_one's warm-pass truncate) restarts
            # from 0 like WalTail: seeking past EOF would silently
            # skip everything written until the file regrows
            if st.st_size < self.offset:
                self.offset = 0
            self.offset = self._consume(self.path, self.offset, out)
        self.lines_read += len(out)
        return out


class WalTail:
    """Incremental outcome harvest over the hub journal WAL: each poll
    parses only the bytes appended since the last one (a daemon body
    must stay O(new events), not O(total WAL size)) and folds them
    into cumulative evicted/node_domain maps. A WAL that SHRANK (boot
    compaction rewrote it) re-reads from 0 — apply_wal_record is
    idempotent, so re-applying a window is merge-safe. Only the
    JSON-lines WAL codec is readable here: a bin1 WAL (the fabric
    default) is detected by its first byte and DISABLES the tail with
    a loud error instead of silently yielding no outcome labels (and
    re-reading binary bytes forever)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.offset = 0
        self.evicted: set = set()
        self.node_domain: dict = {}
        self.disabled = False

    def _sniff(self) -> bool:
        """True when the WAL head looks like JSON lines; a binary head
        (bin1 length-prefixed frames) disables the tail loudly."""
        try:
            with open(self.path, "rb") as f:
                head = f.read(1)
        except OSError:
            return True              # not readable yet — try later
        if not head or head in b"{ \t\n\r":
            return True
        self.disabled = True
        logger.error(
            "WAL %s is not a JSON-lines WAL (first byte %r — a bin1 "
            "fabric WAL?); outcome labels DISABLED. Point --wal at a "
            "wal_codec=json hub WAL, or run without outcome labels.",
            self.path, head)
        return False

    def outcomes(self) -> tuple[set, dict]:
        if not self.path or self.disabled:
            return self.evicted, self.node_domain
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return self.evicted, self.node_domain
        if size < self.offset:
            self.offset = 0          # compacted/rewritten: re-merge
        if size == self.offset or not self._sniff():
            return self.evicted, self.node_domain
        lines: list[str] = []
        self.offset = _read_complete_lines(self.path, self.offset,
                                           lines)
        for ln in lines:
            try:
                rec = json.loads(ln)
            except ValueError:
                continue             # torn record — storage tolerates it
            apply_wal_record(rec, self.evicted, self.node_domain)
        return self.evicted, self.node_domain


@dataclass
class LoopConfig:
    trace_path: str                  # the scheduler's rotating export
    staging_dir: str                 # candidates + last-good + state
    live_path: str                   # what CheckpointWatcher polls
    wal_path: Optional[str] = None   # hub journal WAL (outcome labels)
    state_path: Optional[str] = None  # default: <staging>/loop_state.json
    interval_s: float = 300.0
    min_new_rows: int = 64           # trainable rows before a retrain
    holdout_frac: float = 0.3        # newest rows held out for the gate
    min_holdout_rows: int = 8
    max_buffer_rows: int = 200_000
    seed: int = 0
    hidden: tuple = (8,)
    bc_epochs: int = 120
    ft_epochs: int = 60
    # extra reward shading per unit of normalized regret (the
    # contextual-bandit term: high-regret placements push hardest)
    regret_gain: float = 1.0
    quality_eps: float = 0.01
    latency_budget: float = 0.5
    # post-promotion regret regression that triggers rollback, relative
    # to the promotion-time baseline (plus a small absolute floor so a
    # near-zero baseline doesn't roll back on noise)
    rollback_tolerance: float = 0.25
    rollback_floor: float = 0.5
    min_rollback_rows: int = 16
    # where the retrain runs: "cuda" (kernel K10) or "cpu" (its twin)
    device: str = "cuda"

    def resolved_state_path(self) -> str:
        return self.state_path or os.path.join(self.staging_dir,
                                               "loop_state.json")


class LearnLoop:
    """One retrain daemon instance. ``run_once`` is the whole loop body
    (tail → rollback check → retrain → gate → promote); ``run_forever``
    sleeps ``interval_s`` between bodies."""

    def __init__(self, cfg: LoopConfig,
                 metrics: Optional[LoopMetrics] = None,
                 now=time.time):
        self.cfg = cfg
        self.metrics = metrics or LoopMetrics()
        self.now = now
        os.makedirs(cfg.staging_dir, exist_ok=True)
        self.cursor = ExportCursor(cfg.trace_path)
        self.wal = WalTail(cfg.wal_path)
        self.state = {"generation": 0, "version": 0, "promoted": None}
        self._load_state()
        # the row buffer SPOOLS to staging: the cursor advances past
        # consumed rows immediately, so a sub-threshold window read by
        # a one-shot `--once` invocation (a fresh process every
        # interval) must survive to the next invocation or those rows
        # are unreachable forever and a low-rate deployment never
        # accumulates to min_new_rows
        self._buffer_path = os.path.join(cfg.staging_dir,
                                         "row_buffer.jsonl")
        self._buffer: list[dict] = self._load_buffer()
        # trainable rows since the last retrain (persisted with the
        # state for the same one-shot reason)
        self._pending = int(self.state.pop("pending", 0))

    # ------------------------------------------------------- state ---

    def _load_state(self) -> None:
        try:
            with open(self.cfg.resolved_state_path()) as f:
                st = json.load(f)
        except (OSError, ValueError):
            return
        self.cursor.restore(st.get("cursor") or {})
        for k in ("generation", "version", "promoted", "pending"):
            if k in st:
                self.state[k] = st[k]

    def _save_state(self) -> None:
        path = self.cfg.resolved_state_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"cursor": self.cursor.state(),
                       "pending": self._pending, **self.state}, f)
        os.replace(tmp, path)

    def _load_buffer(self) -> list[dict]:
        rows: list[dict] = []
        try:
            with open(self._buffer_path) as f:
                for line in f:
                    try:
                        rows.append(json.loads(line))
                    except ValueError:
                        continue     # torn tail from a killed writer
        except OSError:
            return []
        return rows[-self.cfg.max_buffer_rows:]

    def _extend_buffer(self, new_rows: list[dict]) -> None:
        """Append to the in-memory buffer AND its on-disk spool;
        an over-bound buffer trims to the newest window (the spool is
        rewritten atomically so a crash never tears it)."""
        if new_rows:
            self._buffer.extend(new_rows)
            try:
                with open(self._buffer_path, "a") as f:
                    for r in new_rows:
                        f.write(json.dumps(r) + "\n")
            except OSError:
                logger.warning("row-buffer spool append failed; "
                               "one-shot restarts may lose this window",
                               exc_info=True)
        if len(self._buffer) > self.cfg.max_buffer_rows:
            self._buffer = self._buffer[-self.cfg.max_buffer_rows:]
            try:
                tmp = f"{self._buffer_path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    for r in self._buffer:
                        f.write(json.dumps(r) + "\n")
                os.replace(tmp, self._buffer_path)
            except OSError:
                logger.warning("row-buffer spool trim failed",
                               exc_info=True)

    def _last_good_path(self) -> str:
        return os.path.join(self.cfg.staging_dir, "last-good.json")

    def _next_version(self) -> int:
        """Monotonic across restarts AND manual publishes: one past the
        max of our own state and whatever currently serves live
        (ck.next_version reads the live checkpoint's sequence)."""
        return max(int(self.state.get("version", 0)) + 1,
                   ck.next_version(self.cfg.live_path))

    # ---------------------------------------------------- rollback ---

    def _check_rollback(self, regret_summary: dict) -> Optional[dict]:
        """Post-promotion watch: regret observed on rows scheduled
        UNDER the promoted generation regressing past the promotion
        baseline republishes last-good. Evidence ACCUMULATES across
        polls (persisted with the state) so low-rate traffic — a few
        placements per interval — still reaches the min_rollback_rows
        bar instead of resetting every body."""
        promoted = self.state.get("promoted")
        if not promoted:
            return None
        n = int(regret_summary.get("count", 0))
        if n:
            promoted["observed_count"] = \
                promoted.get("observed_count", 0) + n
            promoted["observed_sum"] = (
                promoted.get("observed_sum", 0.0)
                + float(regret_summary.get("regret_mean", 0.0)) * n)
        total = int(promoted.get("observed_count", 0))
        if total < self.cfg.min_rollback_rows:
            return None
        baseline = float(promoted.get("regret_mean", 0.0))
        observed = promoted["observed_sum"] / total
        bar = (baseline * (1.0 + self.cfg.rollback_tolerance)
               + self.cfg.rollback_floor)
        if observed <= bar:
            return None
        try:
            params, meta = ck.load_checkpoint(self._last_good_path())
        except ck.CheckpointError as e:
            # no recovery path exists — disarm the watch (logging the
            # same unusable-last-good error every poll forever helps
            # nobody); the next successful retrain takes over
            logger.error("regret regressed (%.3f > %.3f) but last-good "
                         "is unusable; disarming the rollback watch: "
                         "%s", observed, bar, e)
            self.state["promoted"] = None
            return None
        version = self._next_version()
        clean = {k: v for k, v in meta.items()
                 if k not in ("format_version", "feature_version",
                              "fingerprint", "created")}
        clean.update(version=version,
                     rolled_back_from=promoted.get("generation"),
                     rollback_observed_regret=observed,
                     rollback_baseline_regret=baseline)
        ck.save_checkpoint(self.cfg.live_path, params, meta=clean)
        self.state["version"] = version
        self.state["promoted"] = None
        self.metrics.rollbacks.inc()
        self.metrics.live_generation.set(
            float(clean.get("generation", 0)))
        logger.warning("rolled back to last-good (generation %s, "
                       "version %s): observed regret %.3f > %.3f",
                       clean.get("generation"), version, observed, bar)
        return {"rolled_back_to": clean.get("generation"),
                "version": version, "observed": observed,
                "baseline": baseline}

    # ---------------------------------------------------- one body ---

    def run_once(self) -> dict:
        cfg = self.cfg
        lines = self.cursor.read_lines()
        parsed = []
        for ln in lines:
            try:
                parsed.append(json.loads(ln))
            except ValueError:
                continue        # torn/garbled line — skip, not fatal
        new_rows = list(iter_placement_rows(parsed))
        self.metrics.rows.inc(len(new_rows))
        self._extend_buffer(new_rows)
        trainable = sum(1 for r in new_rows
                        if r.get("node") is not None and r.get("feat")
                        and len(r["feat"]) == NUM_FEATURES)
        self._pending += trainable

        evicted, node_domain = self.wal.outcomes()
        new_regret = RG.summarize_regret(
            RG.compute_regret(new_rows, evicted, node_domain))
        if new_regret["count"]:
            self.metrics.regret_mean.set(new_regret["regret_mean"])
            self.metrics.regret_p99.set(new_regret["regret_p99"])

        report = {"at": self.now(), "new_rows": len(new_rows),
                  "new_trainable": trainable,
                  "pending": self._pending,
                  "buffer": len(self._buffer),
                  "regret": new_regret,
                  "cursor": self.cursor.state()}

        # the promoted generation is judged on the traffic it scheduled
        rb = self._check_rollback(new_regret)
        if rb:
            report["rollback"] = rb

        if self._pending < cfg.min_new_rows:
            report["status"] = "waiting"
            self._save_state()
            return report

        # ----- split: newest rows held out for the gate -----
        rows = sorted(self._buffer, key=lambda r: r.get("t", 0.0))
        usable = [r for r in rows
                  if r.get("node") is not None and r.get("feat")
                  and len(r["feat"]) == NUM_FEATURES]
        n_hold = max(cfg.min_holdout_rows,
                     int(len(usable) * cfg.holdout_frac))
        if len(usable) < n_hold + cfg.min_holdout_rows:
            # min_holdout_rows is a FLOOR on the gate's evidence, not a
            # budget to steal from training: too few rows for a real
            # holdout + train split means keep accumulating
            report["status"] = "waiting"
            report["reason"] = "insufficient rows for holdout split"
            self._save_state()
            return report
        holdout = usable[-n_hold:]
        cut_t = holdout[0].get("t", 0.0)
        train_rows = [r for r in rows if r.get("t", 0.0) < cut_t] \
            or usable[:-n_hold] or usable
        # the gate's time-to-bind axis needs the failed-attempt anchor
        # rows (node None) of the held-out pods — they establish
        # first_seen; without them every time-to-bind collapses to 0
        holdout_uids = {r.get("uid", "") for r in holdout}
        gate_rows = holdout + [
            r for r in rows
            if r.get("node") is None and r.get("uid") in holdout_uids]

        # ----- retrain: BC warm start + regret-weighted bandit FT -----
        from kubernetes_tpu_torch.learn.train import TrainConfig, train

        generation = int(self.state.get("generation", 0)) + 1
        version = self._next_version()
        try:
            ds = build_dataset_rows(train_rows, evicted=evicted,
                                    node_domain=node_domain)
        except ValueError as e:
            report["status"] = "no_trainable_rows"
            report["error"] = str(e)
            self._save_state()
            return report
        # contextual-bandit shading: fold each example's per-placement
        # regret (normalized to score scale) into its outcome reward so
        # the fine-tune's advantage pushes hardest where a counterfactual
        # alternative was measurably better
        train_regret = RG.compute_regret(train_rows, evicted, node_domain)
        reg_by_uid: dict = {}
        for rec in train_regret:
            reg_by_uid[rec["uid"]] = rec["regret"]
        uids = ds.meta.get("uids") or []
        for i, uid in enumerate(uids):
            reg = reg_by_uid.get(uid, 0.0)
            if reg > 0:
                ds.reward[i] /= (1.0
                                 + (reg / MAX_SCORE) * cfg.regret_gain)
        train_summary = RG.summarize_regret(train_regret)
        params, info = train(ds, TrainConfig(
            hidden=tuple(cfg.hidden), seed=cfg.seed + generation,
            bc_epochs=cfg.bc_epochs, ft_epochs=cfg.ft_epochs,
            meta={"version": version, "generation": generation,
                  "source": "learn_loop", "regret": train_summary}),
            device=cfg.device)
        cand_path = os.path.join(cfg.staging_dir,
                                 f"scorer-g{generation}.json")
        ck.save_checkpoint(cand_path, params, meta=info)
        self.metrics.retrains.inc()
        self.metrics.generation.set(float(generation))
        self.state["generation"] = generation
        self.state["version"] = version
        report.update(generation=generation, version=version,
                      candidate=cand_path, examples=len(ds),
                      train_regret=train_summary)

        # ----- gate: replay-score candidate vs live on the holdout -----
        live_params = None
        live_meta: dict = {}
        try:
            live_params, live_meta = ck.load_checkpoint(cfg.live_path)
        except ck.CheckpointError:
            pass                      # bootstrap: nothing serving yet
        gate = RG.gate_candidate(
            params, live_params, gate_rows, evicted, node_domain,
            quality_eps=cfg.quality_eps,
            latency_budget=cfg.latency_budget)
        report["gate"] = {k: gate[k] for k in
                          ("promote", "bootstrap", "wins", "losses",
                           "latency_ok")}
        if gate["promote"]:
            if live_params is not None:
                # preserve the displaced live checkpoint for rollback
                clean = {k: v for k, v in live_meta.items()
                         if k not in ("format_version",
                                      "feature_version", "fingerprint",
                                      "created")}
                ck.save_checkpoint(self._last_good_path(), live_params,
                                   meta=clean)
            holdout_regret = RG.summarize_regret(
                RG.compute_regret(gate_rows, evicted, node_domain))
            promote_meta = dict(info)
            promote_meta.update(promoted=True,
                                gate_wins=gate["wins"],
                                holdout_regret=holdout_regret)
            ck.save_checkpoint(cfg.live_path, params, meta=promote_meta)
            self.metrics.promotions.inc()
            self.metrics.live_generation.set(float(generation))
            if live_params is not None:
                # the rollback baseline: regret of the traffic the
                # PREVIOUS policy scheduled — the promoted generation
                # must not do measurably worse than what it replaced.
                # Computed over the FULL row buffer (anchors included)
                # with exactly the methodology _check_rollback applies
                # to new rows, so the comparison is bias-free (anchors
                # drive the time-to-bind shading; stripping them would
                # systematically deflate the baseline and trigger
                # spurious rollbacks)
                baseline = RG.summarize_regret(
                    RG.compute_regret(rows, evicted, node_domain))
                self.state["promoted"] = {
                    "generation": generation, "version": version,
                    "regret_mean": baseline.get("regret_mean", 0.0),
                    "at": self.now()}
            else:
                # bootstrap: nothing was displaced, so there is no
                # last-good to roll back to — arming the watch would
                # only log an unusable-last-good error every poll
                self.state["promoted"] = None
            report["status"] = "promoted"
        else:
            self.metrics.rejected.inc()
            report["status"] = "rejected"
        self._pending = 0
        self._save_state()
        return report

    def run_forever(self, iterations: Optional[int] = None,
                    sleep=time.sleep) -> None:
        n = 0
        while iterations is None or n < iterations:
            try:
                report = self.run_once()
                logger.info("learn loop: %s",
                            json.dumps(report, default=str))
            except Exception:  # noqa: BLE001 — a transient failure
                # (full disk, NFS blip mid-save) must not kill the
                # daemon; the next interval retries from the persisted
                # cursor
                logger.exception("learn loop body failed; retrying "
                                 "next interval")
            n += 1
            if iterations is not None and n >= iterations:
                break
            sleep(self.cfg.interval_s)
