"""Versioned learned-scorer checkpoints + the hot-reload watcher (a copy
of the JAX package's learn/checkpoint.py; the document is the same, so a
checkpoint written by either package loads in the other with the same
fingerprint).

Format (JSON, one document): layer weights as nested lists so the file
is inspectable and diff-able; small by construction (the default scorer
is a few hundred floats).

    {
      "format_version": 1,
      "feature_version": 1,          # ops.learned.FEATURE_VERSION
      "num_features": 7,
      "layers": [{"w": [[...]], "b": [...]}, ...],
      "meta": {"seed": 0, "hidden": [8], "examples": 1234,
               "version": 3, "created": 1700000000.0, ...}
    }

Validation on load covers structure (format/feature version, shape
chain F -> h1 -> ... -> 1, parseable floats) AND finiteness: a NaN/Inf
weight anywhere rejects the file with CheckpointError, so a diverged
training run can never become the watcher's "last good" params — the
params are a few hundred floats, the isfinite scan is free. The device
guard reduction remains the runtime net for params that go bad past
the loader (in-memory corruption, future loader gaps): a poisoned
launch degrades that batch down the fallback ladder, proven by test.

Saves are atomic (tmp file + os.replace) so the scheduler's mtime-based
hot reload can never observe a torn write.

One addition to the reference: ``CheckpointWatcher(path, check=...)``
runs ``check(params)`` after a load, inside the same error handling; the
port's LearnedScore passes the stack's shape checks (kernels/learned.py
``check_caps``), so a stack the kernel cannot read is counted in
``load_errors`` and the last good params keep serving, as for a corrupt
file.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.ops.learned import FEATURE_VERSION, NUM_FEATURES

CHECKPOINT_VERSION = 1


class CheckpointError(ValueError):
    """The checkpoint file is unreadable, malformed, or trained against
    an incompatible feature layout."""


def _fingerprint(doc: dict) -> str:
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


def save_checkpoint(path: str, params, meta: Optional[dict] = None) -> dict:
    """Write ``params`` (a ((W, b), ...) layer stack of array-likes) to
    ``path`` atomically; returns the document written (fingerprint
    included in meta)."""
    layers = []
    for w, b in params:
        w = np.asarray(w, np.float32)
        b = np.asarray(b, np.float32)
        layers.append({"w": w.tolist(), "b": b.tolist()})
    doc = {
        "format_version": CHECKPOINT_VERSION,
        "feature_version": FEATURE_VERSION,
        "num_features": int(np.asarray(params[0][0]).shape[0]),
        "layers": layers,
        "meta": dict(meta or {}),
    }
    doc["meta"].setdefault("created", time.time())
    doc["meta"]["fingerprint"] = _fingerprint(
        {"layers": layers, "feature_version": FEATURE_VERSION})
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return doc


def load_checkpoint(path: str):
    """Returns (params, meta): params a ((W, b), ...) tuple of float32
    numpy arrays, meta the document's meta dict plus format fields.
    Raises CheckpointError on any structural problem."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"unreadable checkpoint {path}: {e}") from e
    if not isinstance(doc, dict):
        raise CheckpointError(f"{path}: not a checkpoint document")
    fv = doc.get("format_version")
    if fv != CHECKPOINT_VERSION:
        raise CheckpointError(
            f"{path}: format_version {fv!r} != {CHECKPOINT_VERSION}")
    featv = doc.get("feature_version")
    if featv != FEATURE_VERSION:
        raise CheckpointError(
            f"{path}: feature_version {featv!r} != {FEATURE_VERSION} "
            "(retrain against the current feature layout)")
    layers = doc.get("layers")
    if not isinstance(layers, list) or not layers:
        raise CheckpointError(f"{path}: empty/missing layers")
    params = []
    prev = NUM_FEATURES
    for i, layer in enumerate(layers):
        try:
            w = np.asarray(layer["w"], np.float32)
            b = np.asarray(layer["b"], np.float32)
        except (KeyError, TypeError, ValueError) as e:
            raise CheckpointError(f"{path}: layer {i} malformed: {e}") \
                from e
        if w.ndim != 2 or b.ndim != 1 or w.shape[1] != b.shape[0]:
            raise CheckpointError(
                f"{path}: layer {i} shape mismatch {w.shape}/{b.shape}")
        if w.shape[0] != prev:
            raise CheckpointError(
                f"{path}: layer {i} expects {w.shape[0]} inputs, "
                f"got {prev}")
        if not (np.isfinite(w).all() and np.isfinite(b).all()):
            raise CheckpointError(
                f"{path}: layer {i} carries non-finite weights "
                "(diverged training run?)")
        prev = w.shape[1]
        params.append((w, b))
    if prev != 1:
        raise CheckpointError(f"{path}: head must be scalar, got {prev}")
    meta = dict(doc.get("meta") or {})
    meta["format_version"] = fv
    meta["feature_version"] = featv
    return tuple(params), meta


def next_version(path: str) -> int:
    """One past the version of the checkpoint currently at ``path``
    (1 when absent/unreadable) — the auto-bump behind ``learn train``
    and the loop daemon, so a forgotten ``--version`` flag can never
    republish version 1 over a live v7 and walk the
    scheduler_learned_checkpoint_version gauge backwards."""
    try:
        _, meta = load_checkpoint(path)
        return int(meta.get("version", 0)) + 1
    except (CheckpointError, TypeError, ValueError):
        return 1


class CheckpointWatcher:
    """mtime-polled checkpoint loader: ``poll()`` is a stat + compare
    (the scheduler calls it once per launch at snapshot-sync time); only
    an mtime/size change pays a load. A failed load KEEPS the previous
    params — a corrupt overwrite degrades to the last good scorer, and
    the error is counted for /debug/scorer and the metrics surface."""

    def __init__(self, path: str, check=None):
        self.path = path
        self.check = check          # check(params) raises CheckpointError
        self.params = None          # last good ((W, b), ...) numpy stack
        self.meta: dict = {}
        self.loads = 0              # successful loads (first one included)
        self.load_errors = 0
        self.last_error: Optional[str] = None
        self._stamp = None          # (mtime_ns, size) last attempted

    def poll(self) -> bool:
        """Returns True when params changed (fresh load succeeded)."""
        try:
            st = os.stat(self.path)
        except OSError as e:
            # a missing checkpoint is NOT a load error: the normal
            # deployment order starts the scheduler before the offline
            # trainer publishes its first file ("waiting"); only a
            # previously-loaded checkpoint VANISHING is worth noting
            # (last good params keep serving either way)
            if self._stamp != () and self.params is not None:
                self.last_error = f"stat: {e}"
            self._stamp = ()
            return False
        stamp = (st.st_mtime_ns, st.st_size)
        if stamp == self._stamp:
            return False
        self._stamp = stamp
        try:
            params, meta = load_checkpoint(self.path)
            if self.check is not None:
                self.check(params)
            self.params, self.meta = params, meta
        except CheckpointError as e:
            self.load_errors += 1
            self.last_error = str(e)
            if isinstance(e.__cause__, OSError):
                # transient READ failure (NFS blip, momentary
                # permissions): forget the stamp so the next poll
                # retries this version instead of skipping it until the
                # trainer happens to publish again. Parse/shape errors
                # keep the stamp — re-parsing a genuinely corrupt file
                # every cycle buys nothing.
                self._stamp = None
            return False
        self.loads += 1
        self.last_error = None
        return True
