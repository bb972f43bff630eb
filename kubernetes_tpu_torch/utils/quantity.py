"""Kubernetes-style resource quantity parsing.

The reference models quantities with ``k8s.io/apimachinery/pkg/api/resource``
(arbitrary-precision decimal + binary/decimal SI suffixes). The scheduler only
ever needs integer milli-CPU and integer byte counts, so we parse directly to
ints (reference usage: ``pkg/scheduler/framework/types.go:846`` Resource —
MilliCPU/Memory/EphemeralStorage int64).

Supported syntax: plain integers/decimals ("2", "0.5"), exponents ("129e6"),
milli suffix ("500m"), decimal SI (k, M, G, T, P, E) and binary SI
(Ki, Mi, Gi, Ti, Pi, Ei).
"""

from __future__ import annotations

import math
from decimal import Decimal, InvalidOperation


_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4,
           "Pi": 1024**5, "Ei": 1024**6}
_DECIMAL = {"n": Decimal("1e-9"), "u": Decimal("1e-6"), "m": Decimal("1e-3"),
            "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
            "E": 10**18}


def parse_quantity(s: str | int | float) -> Decimal:
    """Parse a quantity string to an exact Decimal value.

    Raises ValueError on malformed input.
    """
    if isinstance(s, (int, float)):
        return Decimal(str(s))
    s = s.strip()
    if not s:
        raise ValueError("empty quantity")
    try:
        for suf, mult in _BINARY.items():
            if s.endswith(suf):
                return Decimal(s[: -len(suf)]) * mult
        if s[-1] in _DECIMAL:
            return Decimal(s[:-1]) * _DECIMAL[s[-1]]
        return Decimal(s)
    except InvalidOperation:
        raise ValueError(f"malformed quantity {s!r}") from None


def parse_cpu_milli(s: str | int | float) -> int:
    """CPU quantity -> integer milli-cores, rounding up (never under-reserve).

    Mirrors Quantity.MilliValue() semantics (scale by 1000, ceil); exact
    Decimal arithmetic (the JAX package's C++ fast path is not built for
    the port)."""
    return math.ceil(parse_quantity(s) * 1000)


def parse_bytes(s: str | int | float) -> int:
    """Memory/storage quantity -> integer bytes, rounding up."""
    return math.ceil(parse_quantity(s))


def parse_int(s: str | int | float) -> int:
    """Generic scalar resource (pods, GPUs, hugepages counts) -> int, ceil."""
    return math.ceil(parse_quantity(s))
