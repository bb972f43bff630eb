"""String interning: the bridge between the host object model and device tensors.

Every string the device-side kernels ever compare — label keys/values, taint
keys/effects, namespaces, node/pod names, resource names, topology keys,
image names — is interned host-side into a dense int32 id. Device predicates
are then pure integer tensor ops (SURVEY.md section 7.0 design stance).

Ids are never reused; id 0 is reserved for the empty string and NONE = -1
marks "absent" in padded tensors. The interner additionally keeps a parsed
numeric value per id (NaN when the string is not an integer) so that node
label values can be compared with Gt/Lt NodeSelector operators on device
(reference semantics: k8s.io/apimachinery/pkg/selection + nodeaffinity
helpers parse the label value as an integer for Gt/Lt).
"""

from __future__ import annotations

import math
import re
import threading

NONE = -1  # padded-slot marker in every id tensor

_INT_RE = re.compile(r"^[+-]?[0-9]+$")


class Interner:
    """Thread-safe append-only string <-> int32 id table."""

    __slots__ = ("_lock", "_to_id", "_to_str", "_numeric", "_version")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._to_id: dict[str, int] = {}
        self._to_str: list[str] = []
        self._numeric: list[float] = []
        self._version = 0
        self.intern("")  # id 0

    def intern(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is not None:
            return i
        with self._lock:
            i = self._to_id.get(s)
            if i is not None:
                return i
            i = len(self._to_str)
            self._to_str.append(s)
            # strconv.ParseInt-strict; stored as float64 — exact for |v| < 2^53,
            # which covers every realistic label value (device-side Gt/Lt uses
            # this table; values beyond 2^53 would compare approximately)
            if _INT_RE.match(s):
                self._numeric.append(float(int(s)))
            else:
                self._numeric.append(math.nan)
            self._to_id[s] = i
            self._version += 1
            return i

    def lookup(self, s: str) -> int:
        """Id for an already-interned string, NONE if unseen (read-only path)."""
        return self._to_id.get(s, NONE)

    def string(self, i: int) -> str:
        return self._to_str[i]

    def numeric(self, i: int) -> float:
        return self._numeric[i]

    def __len__(self) -> int:
        return len(self._to_str)

    @property
    def version(self) -> int:
        """Bumped on every new id — lets the device mirror detect vocab growth."""
        return self._version

    def numeric_table(self) -> list[float]:
        """Snapshot of id -> numeric value (for the device Gt/Lt lookup tensor)."""
        return list(self._numeric)
