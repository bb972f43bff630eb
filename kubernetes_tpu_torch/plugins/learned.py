"""LearnedScore: the profile-gated host manager for the fused learned
score term (port of the JAX package's plugins/learned.py).

Like every other device score plugin, the per-node math lives in a
kernel: K9 (csrc/learned_mlp.cuh) runs inside the auction's bids (K2a)
and the serial scan (K3); this class is only the HOST seam: it owns the
checkpoint watcher (mtime hot-reload, polled by the scheduler at sync
time), packs a freshly loaded numpy stack into one device buffer
(kernels/learned.py LearnedParams) once per reload (params then ride
every launch without re-upload, and a reload never rebuilds a kernel),
and surfaces the /debug/scorer state (``stats()``).

Off by default: the plugin is NOT in the default MultiPoint set; a
profile opts in with

    plugins:  {score: {enabled: [{name: LearnedScore, weight: 1}]}}
    plugin_config:
      LearnedScore: {checkpoint_path: /path/to/scorer.json}

With no loadable checkpoint the manager serves params=None and the
launch carries no learned term, identical to the plugin being disabled.
A corrupt overwrite of a good checkpoint, or one wider or deeper than
the hand kernel holds (kernels/learned.py check_caps, a stated
deviation), keeps the last good params and counts the error. Params
that carry a NaN past the loader trip the launch guard, and the port's
Scheduler raises DeviceFault: the reference's degrade to hand-tuned
weights is the host fallback ladder (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.learn.checkpoint import CheckpointWatcher

logger = logging.getLogger("kubernetes_tpu_torch.learned")


class LearnedScore:
    """Host manager for the fused learned score term (device_score
    descriptor; see kernels/learned.py and ops/learned.py)."""

    NAME = "LearnedScore"

    def __init__(self, args: Optional[dict] = None):
        args = args or {}
        self.checkpoint_path = args.get("checkpoint_path")
        # the launches' device (the Scheduler passes its own)
        self.device = torch.device(args.get("device", "cuda"))
        self._watcher = None
        if self.checkpoint_path:
            self._watcher = CheckpointWatcher(self.checkpoint_path,
                                              check=KL.check_caps)
        self._device_params = None
        self.reloads = 0          # param swaps AFTER the initial load

    def name(self) -> str:
        return self.NAME

    def maybe_reload(self) -> bool:
        """mtime-poll the checkpoint (one stat when unchanged); on a
        fresh load pack the params into one buffer on the device. Returns
        True when the served params changed."""
        w = self._watcher
        if w is None:
            return False
        if not w.poll():
            return False
        had = self._device_params is not None
        self._device_params = KL.LearnedParams.pack(w.params, self.device)
        if had:
            self.reloads += 1
        # generation 0 = a manual publish (learn train / identity);
        # >0 = the learn-loop's gated promotion — the fleet scrape
        # distinguishes the two via the reloads counter's label
        logger.info("learned scorer checkpoint %s loaded (version %s, "
                    "generation %s, fingerprint %s)",
                    self.checkpoint_path, self.version, self.generation,
                    self.fingerprint)
        return True

    def params(self):
        """The packed device params (a LearnedParams), or None when no
        checkpoint has ever loaded (the launch then carries no learned
        term)."""
        return self._device_params

    @property
    def version(self) -> int:
        w = self._watcher
        if w is None or not w.meta:
            return 0
        try:
            return int(w.meta.get("version", 0))
        except (TypeError, ValueError):
            return 0

    @property
    def generation(self) -> int:
        """The learn-loop generation that produced the active
        checkpoint; 0 for manual publishes (learn train / identity)."""
        w = self._watcher
        if w is None or not w.meta:
            return 0
        try:
            return int(w.meta.get("generation", 0))
        except (TypeError, ValueError):
            return 0

    @property
    def fingerprint(self) -> str:
        w = self._watcher
        return (w.meta.get("fingerprint", "") if w is not None else "")

    def stats(self) -> dict:
        """/debug/scorer payload for one profile: checkpoint identity,
        the learn-loop generation + regret summaries stamped by the
        promotion gate, reload/error counts."""
        w = self._watcher
        out = {
            "enabled": True,
            "checkpoint_path": self.checkpoint_path,
            "loaded": self._device_params is not None,
            "version": self.version,
            "generation": self.generation,
            "fingerprint": self.fingerprint,
            "reloads": self.reloads,
        }
        if w is not None:
            out.update(loads=w.loads, load_errors=w.load_errors,
                       last_error=w.last_error)
            if w.meta:
                meta = {k: v for k, v in w.meta.items()
                        if k not in ("fingerprint",)}
                out["meta"] = meta
                # the loop's regret view: training-set regret and the
                # gate's holdout regret ride the promoted meta
                for k in ("regret", "holdout_regret", "gate_wins",
                          "promoted", "rolled_back_from"):
                    if k in meta:
                        out[k] = meta[k]
        return out
