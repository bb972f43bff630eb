"""CEL-subset evaluator for DRA device selectors.

The reference evaluates device selector expressions with cel-go
(staging/src/k8s.io/dynamic-resource-allocation/cel/compile.go); the
expressions the DRA API uses are small predicates over one ``device``
variable:

    device.driver == "test-driver.cdi.k8s.io"
    device.attributes['test-driver.cdi.k8s.io'].preallocate
    device.capacity['drv'].counters.compareTo(quantity('2')) >= 0

This module evaluates that subset without a CEL engine: the expression is
tokenized into Python-compatible operators (``&&``/``||``/``!`` →
``and``/``or``/``not``), parsed with ``ast.parse``, and walked by a
restricted evaluator that only admits boolean/compare/arithmetic
operations (including ``in`` over list literals), attribute and
subscript access on the ``device`` variable, and the ``quantity()`` /
``.compareTo()`` / ``.matches()`` helpers. Any construct outside the
subset raises ``CelError`` — callers surface that as an unschedulable
status, mirroring the reference's CEL compile errors.

Semantics notes:
- ``device.attributes['qualified.name']`` resolves attributes by their
  qualified name with the driver's domain as default (attributes stored
  under plain names match when the subscript names the driver domain).
- Attribute access on a missing attribute raises (CEL errors on absent
  map keys); use ``'name' in device.attributes['domain']`` — not part of
  the common perf expressions, so unsupported.
- Quantities compare through Quantity.compareTo like the CEL extension.
"""

from __future__ import annotations

import ast
import functools
from dataclasses import dataclass

from kubernetes_tpu_torch.utils.quantity import parse_quantity


class CelError(Exception):
    pass


@dataclass
class _Quantity:
    value: float

    def compareTo(self, other):  # noqa: N802 — CEL method name
        if not isinstance(other, _Quantity):
            raise CelError("compareTo expects a quantity")
        return (self.value > other.value) - (self.value < other.value)

    def __eq__(self, other):
        return isinstance(other, _Quantity) and self.value == other.value

    def __lt__(self, other):
        return self.value < other.value

    def __le__(self, other):
        return self.value <= other.value

    def __gt__(self, other):
        return self.value > other.value

    def __ge__(self, other):
        return self.value >= other.value


def quantity(s) -> _Quantity:
    try:
        return _Quantity(float(parse_quantity(str(s))))
    except Exception as e:  # noqa: BLE001
        raise CelError(f"bad quantity {s!r}: {e}") from e


class _AttrBag:
    """One domain's attributes: CEL sees ``.name`` accessors; values are
    the raw bool/int/str/version payloads."""

    def __init__(self, entries: dict):
        self._entries = entries

    def __getattr__(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise CelError(f"attribute {name!r} not present") from None


class _DomainMap:
    """``device.attributes['<domain>']`` / ``device.capacity['<domain>']``:
    entries are stored under qualified names ``domain/name`` or plain
    names (plain = the slice driver's own domain)."""

    def __init__(self, entries: dict, default_domain: str, wrap=None):
        self._entries = entries
        self._default = default_domain
        self._wrap = wrap

    def __getitem__(self, domain: str):
        picked = {}
        for key, value in self._entries.items():
            if "/" in key:
                dom, name = key.split("/", 1)
            else:
                dom, name = self._default, key
            if dom == domain:
                picked[name] = self._wrap(value) if self._wrap else value
        return _AttrBag(picked)


class CelDevice:
    """The ``device`` variable: driver, attributes, capacity."""

    def __init__(self, driver: str, attributes: dict, capacity: dict):
        self.driver = driver
        self.attributes = _DomainMap(attributes or {}, driver)
        self.capacity = _DomainMap(capacity or {}, driver, wrap=quantity)


_ALLOWED_COMPARE = (ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
                    ast.In, ast.NotIn)


class _Evaluator(ast.NodeVisitor):
    def __init__(self, device: CelDevice):
        self.device = device

    def eval(self, node):
        method = "visit_" + type(node).__name__
        fn = getattr(self, method, None)
        if fn is None:
            raise CelError(
                f"unsupported expression construct {type(node).__name__}")
        return fn(node)

    def visit_Expression(self, node):
        return self.eval(node.body)

    def visit_Constant(self, node):
        if isinstance(node.value, (bool, int, float, str)):
            return node.value
        raise CelError(f"unsupported literal {node.value!r}")

    def visit_List(self, node):
        # CEL list literals, e.g. `device.attributes['d'].model in
        # ['v5e', 'v5p']` — the membership test the reference's selector
        # corpus uses heavily
        return [self.eval(e) for e in node.elts]

    visit_Tuple = visit_List

    def visit_Name(self, node):
        if node.id == "device":
            return self.device
        if node.id == "true":
            return True
        if node.id == "false":
            return False
        raise CelError(f"unknown identifier {node.id!r}")

    def visit_BoolOp(self, node):
        if isinstance(node.op, ast.And):
            return all(bool(self.eval(v)) for v in node.values)
        if isinstance(node.op, ast.Or):
            return any(bool(self.eval(v)) for v in node.values)
        raise CelError("unsupported boolean operator")

    def visit_UnaryOp(self, node):
        if isinstance(node.op, ast.Not):
            return not self.eval(node.operand)
        if isinstance(node.op, ast.USub):
            return -self.eval(node.operand)
        raise CelError("unsupported unary operator")

    def visit_Compare(self, node):
        left = self.eval(node.left)
        for op, comp in zip(node.ops, node.comparators):
            if not isinstance(op, _ALLOWED_COMPARE):
                raise CelError("unsupported comparison")
            right = self.eval(comp)
            ok = {
                ast.Eq: lambda a, b: a == b,
                ast.NotEq: lambda a, b: a != b,
                ast.Lt: lambda a, b: a < b,
                ast.LtE: lambda a, b: a <= b,
                ast.Gt: lambda a, b: a > b,
                ast.GtE: lambda a, b: a >= b,
                ast.In: lambda a, b: a in b,
                ast.NotIn: lambda a, b: a not in b,
            }[type(op)](left, right)
            if not ok:
                return False
            left = right
        return True

    def visit_Attribute(self, node):
        base = self.eval(node.value)
        if node.attr.startswith("_"):
            raise CelError("private attribute access")
        try:
            return getattr(base, node.attr)
        except AttributeError:
            raise CelError(f"no attribute {node.attr!r}") from None

    def visit_Subscript(self, node):
        base = self.eval(node.value)
        key = self.eval(node.slice)
        try:
            return base[key]
        except (KeyError, TypeError, IndexError):
            raise CelError(f"no entry {key!r}") from None

    def visit_Call(self, node):
        if isinstance(node.func, ast.Name):
            if node.func.id == "quantity":
                args = [self.eval(a) for a in node.args]
                if len(args) != 1:
                    raise CelError("quantity() takes one argument")
                return quantity(args[0])
            raise CelError(f"unknown function {node.func.id!r}")
        if isinstance(node.func, ast.Attribute):
            recv = self.eval(node.func.value)
            name = node.func.attr
            args = [self.eval(a) for a in node.args]
            if name == "compareTo" and isinstance(recv, _Quantity):
                return recv.compareTo(*args)
            if name == "matches" and isinstance(recv, str):
                import re

                return re.search(args[0], recv) is not None
            if name in ("startsWith", "endsWith") and isinstance(recv, str):
                fn = recv.startswith if name == "startsWith" else \
                    recv.endswith
                return fn(args[0])
            raise CelError(f"unsupported method {name!r}")
        raise CelError("unsupported call")


def _translate(expr: str) -> str:
    """CEL operator spelling -> Python: &&, ||, and prefix ! (but not !=)."""
    out = []
    i = 0
    in_str: str | None = None
    while i < len(expr):
        ch = expr[i]
        if in_str:
            out.append(ch)
            if ch == in_str and expr[i - 1] != "\\":
                in_str = None
            i += 1
            continue
        if ch in "'\"":
            in_str = ch
            out.append(ch)
            i += 1
            continue
        if expr.startswith("&&", i):
            out.append(" and ")
            i += 2
            continue
        if expr.startswith("||", i):
            out.append(" or ")
            i += 2
            continue
        if ch == "!" and not expr.startswith("!=", i):
            out.append(" not ")
            i += 1
            continue
        out.append(ch)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=1024)
def _parse(expression: str):
    try:
        # parenthesize: eval mode rejects leading whitespace (from a
        # translated leading '!') and bare newlines (multi-line YAML
        # expressions); parens make both legal continuations
        return ast.parse("(" + _translate(expression) + ")", mode="eval")
    except SyntaxError as e:
        raise CelError(f"cannot parse CEL expression: {e}") from e


def evaluate(expression: str, device: CelDevice) -> bool:
    """Evaluate one CEL selector expression against a device (the parsed
    AST is cached per expression — allocator hot path evaluates one
    selector across many devices). Raises CelError for anything outside
    the supported subset."""
    tree = _parse(expression)
    try:
        return bool(_Evaluator(device).eval(tree))
    except CelError:
        raise
    except Exception as e:  # noqa: BLE001 — type mismatches, bad regexes:
        # everything outside the subset must surface as CelError so the
        # caller can turn it into an unschedulable status, not a crash
        raise CelError(f"CEL evaluation failed: {e}") from e
