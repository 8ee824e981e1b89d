"""Systematic invariant layer (reference platform/enforce.h — the
PADDLE_ENFORCE* macro family: condition checks that throw an EnforceNotMet
carrying the failing expression, a formatted message, and the throw site).

The reference attaches a demangled C++ stack; here the Python traceback
already serves that role, so EnforceNotMet adds the *framework-level*
context instead: which op/layer was being built or run, plus the
caller-supplied detail. Helpers mirror the macro family:

    enforce(cond, "msg %s", x)        PADDLE_ENFORCE
    enforce_eq / _ne / _gt / _ge / _lt / _le
    enforce_not_none(val, name)       PADDLE_ENFORCE_NOT_NULL
    enforce_shape_match(a, b)         the InferShape dim checks
    throw_on(...)                     PADDLE_THROW

All raise EnforceNotMet (a ValueError subclass, so existing `except
ValueError` callers and tests keep working).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

__all__ = [
    "EnforceNotMet", "enforce", "enforce_eq", "enforce_ne", "enforce_gt",
    "enforce_ge", "enforce_lt", "enforce_le", "enforce_not_none",
    "enforce_shape_match", "throw_on",
]


class EnforceNotMet(ValueError):
    """reference enforce.h EnforceNotMet: invariant violation with context.

    Subclasses ValueError: every pre-existing raise site in this package
    used ValueError/TypeError, and callers (OpTest harness, book tests)
    catch ValueError — the invariant layer tightens messages without
    breaking their contracts."""

    def __init__(self, message: str, context: Optional[str] = None):
        self.context = context
        super().__init__(f"[{context}] {message}" if context else message)


def _fmt(message: str, args: tuple) -> str:
    if not args:
        return message
    try:
        return message % args
    except (TypeError, ValueError):
        return f"{message} {args}"


def enforce(cond: Any, message: str = "enforce failed", *args,
            context: Optional[str] = None) -> None:
    """PADDLE_ENFORCE(cond, msg, ...) — raise EnforceNotMet unless cond."""
    if not cond:
        raise EnforceNotMet(_fmt(message, args), context)


def throw_on(message: str, *args, context: Optional[str] = None) -> None:
    """PADDLE_THROW — unconditional."""
    raise EnforceNotMet(_fmt(message, args), context)


def _cmp(name, op, a, b, message, args, context):
    if not op(a, b):
        detail = f"expected {a!r} {name} {b!r}"
        if message:
            detail = f"{_fmt(message, args)}: {detail}"
        raise EnforceNotMet(detail, context)


def enforce_eq(a, b, message: str = "", *args, context=None):
    _cmp("==", lambda x, y: x == y, a, b, message, args, context)


def enforce_ne(a, b, message: str = "", *args, context=None):
    _cmp("!=", lambda x, y: x != y, a, b, message, args, context)


def enforce_gt(a, b, message: str = "", *args, context=None):
    _cmp(">", lambda x, y: x > y, a, b, message, args, context)


def enforce_ge(a, b, message: str = "", *args, context=None):
    _cmp(">=", lambda x, y: x >= y, a, b, message, args, context)


def enforce_lt(a, b, message: str = "", *args, context=None):
    _cmp("<", lambda x, y: x < y, a, b, message, args, context)


def enforce_le(a, b, message: str = "", *args, context=None):
    _cmp("<=", lambda x, y: x <= y, a, b, message, args, context)


def enforce_not_none(val, name: str = "value", context=None):
    """PADDLE_ENFORCE_NOT_NULL."""
    if val is None:
        raise EnforceNotMet(f"{name} must not be None", context)
    return val


def enforce_shape_match(a: Sequence[int], b: Sequence[int],
                        message: str = "shape mismatch", context=None):
    """Dim-wise check with -1 (unknown batch) wildcards on either side —
    the InferShape dim-compat rule (reference shape_inference.h users)."""
    a, b = list(a), list(b)
    ok = len(a) == len(b) and all(
        da == db or da == -1 or db == -1 for da, db in zip(a, b)
    )
    if not ok:
        raise EnforceNotMet(f"{message}: {a} vs {b}", context)
