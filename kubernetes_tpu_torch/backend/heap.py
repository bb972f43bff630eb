"""Generic heap with a map index, as used by both activeQ and backoffQ.

Equivalent of the reference's backend/heap/heap.go: a binary heap keyed by
an arbitrary less(a, b) with O(1) membership lookup, update-in-place, and
delete-by-key. Copied from the JAX package's pure-Python engine; the
C++ ``KeyedHeap`` engine is not built for the port. With ``sort_key_fn``
the sifts compare precomputed per-item keys (the default PrioritySort is
(-priority, enqueue time)), otherwise they call less_fn.
"""

from __future__ import annotations

from typing import Callable, Generic, Optional, TypeVar


T = TypeVar("T")


class Heap(Generic[T]):
    def __init__(self, key_fn: Callable[[T], str],
                 less_fn: Callable[[T, T], bool],
                 sort_key_fn: Optional[Callable[[T], tuple]] = None):
        self._key = key_fn
        self._less = less_fn
        self._sort_key = sort_key_fn
        # (map key, sort key or None, item); the map key rides along so
        # sifts never re-invoke key_fn
        self._entries: list[tuple[str, object, T]] = []
        self._index: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def get(self, key: str) -> Optional[T]:
        i = self._index.get(key)
        return self._entries[i][2] if i is not None else None

    def add(self, item: T) -> None:
        """Insert or update (re-heapify around the item); the sort key is
        (re)computed here, so updates that change ordering fields must go
        through add."""
        key = self._key(item)
        entry = (key, self._sort_key(item) if self._sort_key else None, item)
        i = self._index.get(key)
        if i is not None:
            self._entries[i] = entry
            self._down(self._up(i))
        else:
            self._entries.append(entry)
            self._index[key] = len(self._entries) - 1
            self._up(len(self._entries) - 1)

    def delete(self, key: str) -> Optional[T]:
        i = self._index.get(key)
        if i is None:
            return None
        return self._remove_at(i)

    def peek(self) -> Optional[T]:
        return self._entries[0][2] if self._entries else None

    def pop(self) -> Optional[T]:
        if not self._entries:
            return None
        return self._remove_at(0)

    def list(self) -> list[T]:
        return [e[2] for e in self._entries]

    def _lt(self, a: tuple[str, object, T], b: tuple[str, object, T]) -> bool:
        if self._sort_key is not None:
            return a[1] < b[1]
        return self._less(a[2], b[2])

    def _remove_at(self, i: int) -> T:
        entry = self._entries[i]
        last = len(self._entries) - 1
        self._swap(i, last)
        self._entries.pop()
        del self._index[entry[0]]
        if i < len(self._entries):
            self._down(self._up(i))
        return entry[2]

    def _swap(self, i: int, j: int) -> None:
        if i == j:
            return
        it, jt = self._entries[i], self._entries[j]
        self._entries[i], self._entries[j] = jt, it
        self._index[it[0]] = j
        self._index[jt[0]] = i

    def _up(self, i: int) -> int:
        entries = self._entries
        while i > 0:
            parent = (i - 1) // 2
            if self._lt(entries[i], entries[parent]):
                self._swap(i, parent)
                i = parent
            else:
                break
        return i

    def _down(self, i: int) -> None:
        entries = self._entries
        n = len(entries)
        while True:
            left, right = 2 * i + 1, 2 * i + 2
            smallest = i
            if left < n and self._lt(entries[left], entries[smallest]):
                smallest = left
            if right < n and self._lt(entries[right], entries[smallest]):
                smallest = right
            if smallest == i:
                return
            self._swap(i, smallest)
            i = smallest
