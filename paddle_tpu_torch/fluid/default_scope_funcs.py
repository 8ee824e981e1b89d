"""Default-scope helpers (reference python/paddle/fluid/
default_scope_funcs.py): the current scope is the top of a thread-local
stack (executor.py's scope guards); these helpers new/find variables in it
and push/pop local scopes functionally.

Same API: get_cur_scope, var, find_var, enter_local_scope,
leave_local_scope, scoped_function. A copy of
``paddle_tpu/fluid/default_scope_funcs.py``.
"""
from __future__ import annotations

import threading

from .executor import Scope, _scope_tls, global_scope

__all__ = [
    "get_cur_scope", "var", "find_var", "enter_local_scope",
    "leave_local_scope", "scoped_function",
]


def get_cur_scope() -> Scope:
    return global_scope()


def var(name: str):
    """Find-or-create `name` in the CURRENT scope (reference Scope::Var —
    local-only lookup, so a local var can shadow a parent's). A fresh var
    holds None until the executor or caller sets it."""
    scope = get_cur_scope()
    if name not in scope._vars:
        scope.set_var(name, None)
    return scope._vars[name]


def find_var(name: str):
    """Find `name` in the current scope chain; None if absent (a created-
    but-unset var also reads None)."""
    return get_cur_scope().find_var(name)


# scopes pushed by enter_local_scope, so leave_local_scope can only ever
# pop its OWN frames — never a scope_guard's (they share _scope_tls.stack)
_local_tls = threading.local()


def _stacks():
    stack = getattr(_scope_tls, "stack", None)
    if stack is None:
        stack = _scope_tls.stack = []
    mine = getattr(_local_tls, "stack", None)
    if mine is None:
        mine = _local_tls.stack = []
    # drop records of local scopes a scope_guard already unwound (it pops
    # by identity and discards orphaned frames above its own) so one
    # unmatched enter can't wedge every later leave on this thread
    live = {id(s) for s in stack}
    mine[:] = [s for s in mine if id(s) in live]
    return stack, mine


def enter_local_scope() -> Scope:
    """Push a child of the current scope onto this thread's stack."""
    stack, mine = _stacks()
    child = get_cur_scope().new_scope()
    stack.append(child)
    mine.append(child)
    return child


def leave_local_scope() -> None:
    stack, mine = _stacks()
    if not mine or not stack or stack[-1] is not mine[-1]:
        raise RuntimeError(
            "leave_local_scope without a matching enter_local_scope on "
            "this thread (a scope_guard frame is not ours to pop)")
    stack.pop()
    mine.pop()


def scoped_function(fn):
    """Run `fn` inside a fresh local scope (reference scoped_function)."""
    enter_local_scope()
    try:
        return fn()
    finally:
        leave_local_scope()
