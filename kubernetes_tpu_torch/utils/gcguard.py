"""Scheduling-loop GC management (port of the JAX package's
utils/gcguard.py).

CPython's generational collector stops the world whenever allocation
counts trip a threshold, and a full (generation-2) pass walks every live
object of the process: after a large cluster was built, one such pass
inside a drain stalls it for as long as the walk takes. The guard keeps
the collector off while the scheduling loop drains and sweeps the young
generations at known-idle points, where a bounded pause is invisible.
Reference counting still frees the acyclic bulk of each cycle's garbage
at once; what the guard defers is only cycle detection.
"""

from __future__ import annotations

import gc
import threading


class GCGuard:
    """Re-entrant "collector off while busy" scope.

    ``with guard:`` disables the collector on first entry and on last exit
    re-enables it and sweeps the young generations (gen 0 and 1: bounded
    work, independent of the heap's size). Nested or concurrent scopes
    share one disable. If the collector was already off (a test or an
    embedder turned it off), the guard leaves it alone.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._depth = 0
        self._managed = False

    def __enter__(self) -> "GCGuard":
        with self._lock:
            if self._depth == 0:
                self._managed = gc.isenabled()
                if self._managed:
                    gc.disable()
            self._depth += 1
        return self

    def __exit__(self, *exc) -> None:
        with self._lock:
            self._depth -= 1
            if self._depth == 0 and self._managed:
                gc.enable()
                gc.collect(1)

    def idle_sweep(self) -> None:
        """Bounded young-generation sweep for periodic ticks inside a long
        drain (the 1 s backoff flush): keeps deferred cyclic garbage from
        piling up without a full pass on the hot path."""
        with self._lock:
            if self._depth > 0 and self._managed:
                gc.collect(1)


# one guard for the process, shared by every Scheduler in it (the
# collector is process state; two schedulers must not fight over it)
guard = GCGuard()
