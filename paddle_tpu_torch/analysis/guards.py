"""Guarded-by inference and shared-state race lint ("TSan-lite") — the
JAX package's ``analysis/guards.py``, aimed at the port.

The lock lint (analysis/locks.py) reasons about lock *acquisition
order*; it cannot see which state each lock protects — the bug class
that actually dominated the serving/decode reviews (stop-races-step
double answers, gauge clobbering, check-then-act windows). This pass is
the Python analogue of Clang's ``-Wthread-safety`` / ``GUARDED_BY``:
it infers, per class (and per module for module-level state), the lock
that guards each piece of shared mutable state, then proves every
access on a multi-thread-reachable path holds it.

Pipeline (extending the locks.py AST machinery):

  1. **Thread entries.** A method whose VALUE escapes — passed to
     ``threading.Thread(target=self._loop)``, registered in an
     ``RpcServer({...})`` / handler dict, handed to
     ``atexit.register`` — runs on another thread. Together with the
     public surface (called by arbitrary client threads) they root the
     same-class call-graph closure of multi-thread-reachable methods.
     ``__init__`` (and anything reachable only from it, or only from
     module import time) is exempt: construction is single-threaded.

  2. **Guard inference.** A ``self._x`` attribute is *shared mutable*
     if it is written outside ``__init__``; its guard is either
     declared — a ``# guarded-by: _mu`` comment on the ``__init__``
     assignment — or inferred as the lock held at the (strict)
     majority of its accesses, when one lock covers every
     locked access. Interprocedural: a ``*_locked`` helper called only
     under a lock analyzes with that lock held (intersection over its
     same-scope call sites, ``__init__`` call sites excluded).

  3. **Reports** (all errors):

     L104  shared attribute accessed without its declared/inferred
           guard on a multi-thread-reachable path
     L105  attribute guarded by *different* locks at different sites
           (no single lock covers the locked accesses)
     L106  check-then-act: a guarded read, the lock released, and a
           later re-acquisition writing the same attribute in the same
           function — the double-answer shape

Suppressions (reviewable, at the site)::

    # guarded-by: _mu                 declare the guard (on the
                                      __init__ assignment; also drives
                                      the runtime sanitizer,
                                      PADDLE_TPU_SANITIZE=guards)
    # lint: allow-unguarded(_x)       vet one attribute's lock-free
                                      access on this line (or the whole
                                      function from its def line)
    # lint: allow-unguarded           same, any attribute on the line

The runtime half lives in analysis/sanitize.py: under
``PADDLE_TPU_SANITIZE=guards`` the declared guards are asserted held at
every attribute access, turning the concurrency tests into
dynamic validators of this static model.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .diagnostics import ERROR, Diagnostic
from .locks import _LOCK_CTORS, _contains_lock_ctor, _expr_text

PASS_NAME = "guards"

# method names that mutate their receiver (container writes through a
# read of the attribute binding)
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "remove", "pop",
    "popleft", "popitem", "clear", "add", "discard", "update",
    "setdefault", "sort", "reverse", "move_to_end",
}

# module-level containers these ctors build count as module state
_CONTAINER_CTORS = {"dict", "list", "set", "deque", "OrderedDict",
                    "defaultdict", "Counter"}

# the declaration may ride a comment with leading prose
# ("# rid -> state; guarded-by: _mu"), not only start it
_DECL_RE = re.compile(r"#.*?\bguarded-by:\s*([A-Za-z_]\w*)")
_ALLOW_RE = re.compile(r"#\s*lint:\s*allow-unguarded(?:\(([^)]*)\))?")
_ALIAS_RE = re.compile(r"#\s*lint:\s*lock-alias\b")


def _d(code, msg, where, hint=""):
    return Diagnostic(code=code, severity=ERROR, message=msg, where=where,
                      hint=hint, pass_name=PASS_NAME)


class _Directives:
    """Per-line guarded-by declarations and allow-unguarded vets."""

    def __init__(self, src: str):
        self.decl_by_line: Dict[int, str] = {}
        # line -> set of vetted attr names ('*' = any attr on the line)
        self.allow_by_line: Dict[int, Set[str]] = {}
        # lines carrying '# lint: lock-alias' — the assigned attribute
        # IS a lock, injected by the owner (see locks.py's catalog)
        self.lock_alias_lines: Set[int] = set()
        lines = src.splitlines()
        for i, line in enumerate(lines, start=1):
            if _ALIAS_RE.search(line):
                self.lock_alias_lines.add(i)
            m = _DECL_RE.search(line)
            if m:
                self.decl_by_line[i] = m.group(1)
            m = _ALLOW_RE.search(line)
            if m:
                attrs = {a.strip() for a in (m.group(1) or "").split(",")
                         if a.strip()} or {"*"}
                self.allow_by_line.setdefault(i, set()).update(attrs)
                # a directive inside a standalone comment block also
                # covers the next code line below it (same rule as the
                # locks lint), so a vet can sit above its def/statement
                if line.lstrip().startswith("#"):
                    j = i
                    while j < len(lines) and (
                            not lines[j].strip()
                            or lines[j].lstrip().startswith("#")):
                        j += 1
                    if j < len(lines):
                        self.allow_by_line.setdefault(
                            j + 1, set()).update(attrs)

    def allows(self, attr: str, *lines: int) -> bool:
        for ln in lines:
            if not ln:
                continue
            vetted = self.allow_by_line.get(ln)
            if vetted and ("*" in vetted or attr in vetted):
                return True
        return False

    def decl_for(self, node) -> Optional[str]:
        """The guarded-by declaration riding a (possibly multi-line)
        assignment statement — the comment may sit on a continuation
        line."""
        for ln in range(node.lineno,
                        (getattr(node, "end_lineno", None) or
                         node.lineno) + 1):
            if ln in self.decl_by_line:
                return self.decl_by_line[ln]
        return None


class _Access:
    __slots__ = ("attr", "line", "write", "held", "fn", "with_line")

    def __init__(self, attr, line, write, held, fn, with_line):
        self.attr = attr            # '_queue' / module var name
        self.line = line
        self.write = write
        self.held: FrozenSet[str] = held   # lock ids held LOCALLY
        self.fn = fn                # owning function name
        self.with_line = with_line  # innermost with line (or 0)


class _Fn:
    __slots__ = ("name", "node", "accesses", "calls", "base", "regions")

    def __init__(self, name, node):
        self.name = name
        self.node = node
        self.accesses: List[_Access] = []
        # (callee, frozenset(held), in_init)
        self.calls: List[Tuple[str, FrozenSet[str], bool]] = []
        self.base: Optional[FrozenSet[str]] = None  # caller-held locks
        # L106 regions: (lock_id, with_line, reads, writes) in order
        self.regions: List[Tuple[str, int, Set[str], Set[str]]] = []


class _Scope:
    """One lint scope: a module's top level, or one class."""

    def __init__(self, qual: str, is_class: bool):
        self.qual = qual
        self.is_class = is_class
        self.locks: Dict[str, str] = {}      # expr text -> canonical id
        self.lock_attrs: Set[str] = set()    # short attr/var names of locks
        self.fns: Dict[str, _Fn] = {}
        self.state: Set[str] = set()         # tracked attr/var names
        self.written: Set[str] = set()       # written outside __init__
        self.decls: Dict[str, str] = {}      # attr -> declared lock id
        self.entries: Set[str] = set()       # thread-entry methods
        self.multi: Set[str] = set()         # multi-thread-reachable fns


def _collect_locks(scope: _Scope, body, self_name: str,
                   directives=None):
    """Lock-attribute discovery, mirroring locks.py (Condition(self._mu)
    aliases the wrapped lock; dict-of-locks families get an '[]' id;
    `# lint: lock-alias` marks an injected shared lock — see
    locks.py's directive catalog)."""
    for node in ast.walk(ast.Module(body=list(body), type_ignores=[])):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = _expr_text(node.targets[0])
        if tgt is None:
            continue
        own = tgt.startswith(self_name + ".") if self_name != "<module>" \
            else "." not in tgt
        val = node.value
        if own and directives is not None and \
                node.lineno in directives.lock_alias_lines:
            short = tgt.split(".")[-1]
            scope.locks[tgt] = f"{scope.qual}.{short}"
            scope.lock_attrs.add(short)
            continue
        if isinstance(val, ast.Call):
            fn = val.func
            ctor = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if ctor in _LOCK_CTORS and own:
                short = tgt.split(".")[-1]
                scope.locks[tgt] = f"{scope.qual}.{short}"
                scope.lock_attrs.add(short)
                continue
            if ctor == "Condition" and own:
                alias = None
                if val.args:
                    alias = scope.locks.get(_expr_text(val.args[0]) or "")
                short = tgt.split(".")[-1]
                scope.locks[tgt] = alias or f"{scope.qual}.{short}"
                scope.lock_attrs.add(short)
                continue
        if _contains_lock_ctor(val) and not isinstance(val, ast.Call) \
                and own:
            short = tgt.split(".")[-1]
            scope.locks[tgt + "[]"] = f"{scope.qual}.{short}[]"
            scope.lock_attrs.add(short)


def _walk_own_stmts(stmts):
    """Statements of a body without descending into nested defs."""
    for st in stmts:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue
        yield st


class _Lint:
    def __init__(self, filename: str, src: str):
        self.filename = filename
        self.short = os.path.splitext(os.path.basename(filename))[0]
        self.src = src
        self.directives = _Directives(src)
        self.diags: List[Diagnostic] = []

    def where(self, line: int) -> str:
        return f"{self.filename}:{line}"

    # --- scope construction ----------------------------------------------
    def _class_scope(self, cls: ast.ClassDef, mod: _Scope) -> _Scope:
        scope = _Scope(f"{self.short}.{cls.name}", is_class=True)
        scope.locks.update(mod.locks)     # module locks visible
        scope.lock_attrs |= mod.lock_attrs
        _collect_locks(scope, cls.body, self_name="self",
                       directives=self.directives)
        for n in cls.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope.fns[n.name] = _Fn(n.name, n)
        self._find_state_and_decls(scope)
        self._find_entries(scope)
        return scope

    def _module_scope(self, tree: ast.Module) -> _Scope:
        scope = _Scope(self.short, is_class=False)
        _collect_locks(scope, tree.body, self_name="<module>",
                       directives=self.directives)
        for n in tree.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope.fns[n.name] = _Fn(n.name, n)
        # module state: top-level container assignments + globals
        # rebound from functions
        for n in tree.body:
            targets, val = [], None
            if isinstance(n, ast.Assign):
                targets, val = n.targets, n.value
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                targets, val = [n.target], n.value
            for t in targets:
                if not isinstance(t, ast.Name) or \
                        t.id in scope.lock_attrs or t.id == "__all__":
                    continue
                is_container = isinstance(
                    val, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                          ast.ListComp, ast.SetComp))
                if isinstance(val, ast.Call):
                    fn = val.func
                    ctor = fn.attr if isinstance(fn, ast.Attribute) else (
                        fn.id if isinstance(fn, ast.Name) else None)
                    is_container = ctor in _CONTAINER_CTORS
                if is_container:
                    scope.state.add(t.id)
                    g = self.directives.decl_for(n)
                    if g:
                        gid = scope.locks.get(g)
                        if gid:
                            scope.decls[t.id] = gid
                        else:
                            # same contract as the class-scope path: a
                            # typo'd/renamed lock must not silently
                            # disable checking for this global
                            self.diags.append(_d(
                                "L105",
                                f"'# guarded-by: {g}' on '{t.id}' names "
                                f"no known module-level lock of "
                                f"{scope.qual}",
                                self.where(n.lineno),
                                hint="declare the guard with the lock's "
                                     "module-level name, e.g. "
                                     "'# guarded-by: _mu'"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                for name in node.names:
                    if name not in scope.lock_attrs:
                        scope.state.add(name)
        return scope

    def _find_state_and_decls(self, scope: _Scope):
        """Shared-mutable attrs: written outside __init__ anywhere in the
        class; declarations ride __init__ assignment lines."""
        init = scope.fns.get("__init__")
        if init is not None:
            for st in ast.walk(init.node):
                tgts = []
                if isinstance(st, ast.Assign):
                    tgts = st.targets
                elif isinstance(st, (ast.AnnAssign, ast.AugAssign)):
                    tgts = [st.target]
                for t in tgts:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self" and \
                            t.attr not in scope.lock_attrs:
                        decl = self.directives.decl_for(st)
                        if decl:
                            # the guard may be a class attr ('self._mu')
                            # or a visible module-level lock — both are
                            # legal held-set members, so both declare
                            gid = scope.locks.get("self." + decl) or \
                                scope.locks.get(decl)
                            if gid is None:
                                self.diags.append(_d(
                                    "L105",
                                    f"'# guarded-by: {decl}' on "
                                    f"'self.{t.attr}' names no known lock "
                                    f"attribute of {scope.qual}",
                                    self.where(st.lineno),
                                    hint="declare the guard with the "
                                         "lock's attribute name, e.g. "
                                         "'# guarded-by: _mu'"))
                            else:
                                scope.decls[t.attr] = gid
                                scope.state.add(t.attr)

    def _find_entries(self, scope: _Scope):
        """Functions/methods whose VALUE escapes (Thread targets, RPC
        handler dicts, atexit hooks) run on other threads. Class scope
        matches escaped `self.method` attributes; module scope matches
        escaped bare function names."""
        fn_names = set(scope.fns)

        def escaped_name(node):
            if scope.is_class:
                if isinstance(node, ast.Attribute) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id == "self" and \
                        node.attr in fn_names:
                    return node.attr
            elif isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Load) and \
                    node.id in fn_names:
                return node.id
            return None

        for fn in scope.fns.values():
            call_funcs = set()
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call):
                    call_funcs.add(id(node.func))
            for node in ast.walk(fn.node):
                name = escaped_name(node)
                if name is not None and id(node) not in call_funcs:
                    scope.entries.add(name)

    # --- symbolic walk ----------------------------------------------------
    def _resolve_lock(self, scope: _Scope, node) -> Optional[str]:
        txt = _expr_text(node)
        return scope.locks.get(txt) if txt else None

    def _state_name(self, scope: _Scope, node) -> Optional[str]:
        """The tracked attr/var a node refers to, or None."""
        if scope.is_class:
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and \
                    node.attr not in scope.lock_attrs:
                return node.attr
        else:
            if isinstance(node, ast.Name) and \
                    node.id not in scope.lock_attrs:
                return node.id
        return None

    def _scan_stmt_exprs(self, scope, fn, st, held, with_line,
                         region):
        """Record accesses in one statement's own expressions."""
        consumed: Set[int] = set()
        writes: List[Tuple[str, int]] = []
        reads: List[Tuple[str, int]] = []

        def mark(node):
            for sub in ast.walk(node):
                consumed.add(id(sub))

        for node in ast.walk(st):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                mark(node)
        for node in ast.walk(st):
            if id(node) in consumed:
                continue
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                name = self._state_name(scope, node.func.value)
                if name is not None:
                    writes.append((name, node.lineno))
                    mark(node.func)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                name = self._state_name(scope, node.value)
                if name is not None:
                    writes.append((name, node.lineno))
                    mark(node.value)
        for node in ast.walk(st):
            if id(node) in consumed:
                continue
            name = self._state_name(scope, node)
            if name is None:
                continue
            mark(node)
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                writes.append((name, node.lineno))
            else:
                reads.append((name, node.lineno))
            if isinstance(st, ast.AugAssign) and \
                    st.target is node:  # x += 1 reads AND writes
                reads.append((name, node.lineno))

        in_init = scope.is_class and fn.name == "__init__"
        for name, line, write in (
                [(n, ln, True) for n, ln in writes] +
                [(n, ln, False) for n, ln in reads]):
            if not in_init:
                fn.accesses.append(_Access(name, line, write, held,
                                           fn.name, with_line))
                if write:
                    scope.written.add(name)
            if region is not None:
                (region[3] if write else region[2]).add(name)

        # same-scope calls
        for node in ast.walk(st):
            if not isinstance(node, ast.Call):
                continue
            callee = None
            if scope.is_class:
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == "self":
                    callee = f.attr
            else:
                if isinstance(node.func, ast.Name):
                    callee = node.func.id
            if callee and callee in scope.fns:
                fn.calls.append((callee, held, in_init))

    def _walk_fn(self, scope: _Scope, fn: _Fn):
        def visit(stmts, held: FrozenSet[str], with_line: int,
                  region):
            for st in _walk_own_stmts(stmts):
                if isinstance(st, ast.With):
                    new_held = set(held)
                    lock_id = None
                    for item in st.items:
                        self._scan_stmt_exprs(scope, fn, item.context_expr,
                                              held, with_line, region)
                        cid = self._resolve_lock(scope, item.context_expr)
                        if cid:
                            new_held.add(cid)
                            lock_id = cid
                    sub_region = region
                    if lock_id is not None and region is None:
                        sub_region = (lock_id, st.lineno, set(), set())
                        fn.regions.append(sub_region)
                    visit(st.body, frozenset(new_held), st.lineno,
                          sub_region)
                    continue
                # the statement's own expressions (incl. if/while tests,
                # for iters, call args) — scan a shallow copy without
                # nested statement lists so lines aren't double-counted
                shallow = st
                nested = []
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(st, field, None)
                    if isinstance(sub, list) and sub and \
                            isinstance(sub[0], ast.stmt):
                        nested.append((field, sub))
                handlers = getattr(st, "handlers", [])
                if nested or handlers:
                    shallow = type(st).__new__(type(st))
                    for field, value in ast.iter_fields(st):
                        if field in ("body", "orelse", "finalbody",
                                     "handlers") and isinstance(value, list):
                            setattr(shallow, field, [])
                        else:
                            setattr(shallow, field, value)
                self._scan_stmt_exprs(scope, fn, shallow, held, with_line,
                                      region)
                for _field, sub in nested:
                    visit(sub, held, with_line, region)
                for h in handlers:
                    visit(h.body, held, with_line, region)

        visit(fn.node.body, frozenset(), 0, None)

    # --- interprocedural base sets ---------------------------------------
    def _compute_bases(self, scope: _Scope, roots: Set[str]):
        """base[fn] = locks held at EVERY non-__init__ call site (so a
        *_locked helper analyzes under its callers' lock); roots
        (public surface, thread entries) are callable bare."""
        callers: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
        for fn in scope.fns.values():
            for callee, held, in_init in fn.calls:
                if in_init:
                    continue
                callers.setdefault(callee, []).append((fn.name, held))
        for name, fn in scope.fns.items():
            fn.base = frozenset() if name in roots else None
        for _ in range(len(scope.fns) + 1):
            changed = False
            for name, fn in scope.fns.items():
                if name in roots:
                    continue
                sets = []
                for caller, held in callers.get(name, ()):
                    cb = scope.fns[caller].base
                    if cb is None:
                        continue
                    sets.append(frozenset(cb | held))
                new = (frozenset(sets[0]).intersection(*sets[1:])
                       if sets else None)
                if new != fn.base and new is not None:
                    fn.base = new
                    changed = True
            if not changed:
                break

    def _reachable(self, scope: _Scope, roots: Set[str]) -> Set[str]:
        seen: Set[str] = set()
        stack = [r for r in roots if r in scope.fns]
        while stack:
            name = stack.pop()
            if name in seen:
                continue
            seen.add(name)
            for callee, _held, in_init in scope.fns[name].calls:
                if callee in scope.fns and not in_init:
                    stack.append(callee)
        return seen

    # --- checks -----------------------------------------------------------
    def _check_scope(self, scope: _Scope):
        if not scope.locks:
            return
        # `*_locked` methods are never roots — the repo convention says
        # their callers hold the lock, so they analyze under the
        # intersection of their call sites' held sets
        if scope.is_class:
            public = {n for n in scope.fns
                      if not n.startswith("_") or
                      (n.startswith("__") and n.endswith("__")
                       and n != "__init__")}
            roots = (public | scope.entries) - \
                {n for n in scope.fns if n.endswith("_locked")}
            if not roots:
                return
        else:
            public = {n for n in scope.fns if not n.startswith("_")}
            roots = (public | scope.entries) - \
                {n for n in scope.fns if n.endswith("_locked")}
        for fn in scope.fns.values():
            self._walk_fn(scope, fn)
        scope.multi = self._reachable(scope, roots)
        if scope.is_class:
            scope.multi.discard("__init__")
        self._compute_bases(scope, roots)

        # class scope: any self-attr written outside __init__ (or
        # declared); module scope: additionally restricted to the
        # module-state vars (container globals / `global`-rebound) so
        # plain locals never enter the analysis
        tracked = (scope.written | set(scope.decls)) - scope.lock_attrs
        if not scope.is_class:
            tracked &= scope.state | set(scope.decls)

        # collect effective accesses per attr (reachable fns only)
        per_attr: Dict[str, List[Tuple[_Access, FrozenSet[str]]]] = {}
        for fn in scope.fns.values():
            if fn.name not in scope.multi:
                continue
            base = fn.base or frozenset()
            for a in fn.accesses:
                if a.attr in tracked:
                    per_attr.setdefault(a.attr, []).append(
                        (a, frozenset(a.held | base)))

        prefix = "self." if scope.is_class else ""
        for attr in sorted(per_attr):
            accesses = per_attr[attr]
            locked = [(a, h) for a, h in accesses if h]
            declared = scope.decls.get(attr)
            guard = declared
            if guard is None:
                if len(locked) < 2 or len(locked) * 2 <= len(accesses):
                    continue  # no usable inference
                common = frozenset(locked[0][1]).intersection(
                    *[h for _, h in locked[1:]])
                if not common:
                    self._report_l105(scope, attr, prefix, locked)
                    continue
                guard = sorted(common)[0]
            fn_lines = {f.name: f.node.lineno for f in scope.fns.values()}
            for a, held in accesses:
                if guard in held:
                    continue
                if self.directives.allows(attr, a.line, a.with_line,
                                          fn_lines.get(a.fn, 0)):
                    continue
                kind = "written" if a.write else "read"
                self.diags.append(_d(
                    "L104",
                    f"shared attribute '{prefix}{attr}' (guarded by "
                    f"'{_short(guard)}') is {kind} without its guard in "
                    f"{scope.qual}.{a.fn}() on a multi-thread path",
                    self.where(a.line),
                    hint=f"hold '{_short(guard)}' across this access, or "
                         f"annotate '# lint: allow-unguarded({attr})' "
                         "with a rationale if the lock-free access is "
                         "deliberate"))
            self._check_l106(scope, attr, guard, prefix)

    def _report_l105(self, scope, attr, prefix, locked):
        lock_names = sorted({_short(l) for _, hs in locked for l in hs})
        fn_lines = {f.name: f.node.lineno for f in scope.fns.values()}
        sites = sorted({a.line for a, _ in locked})
        if any(self.directives.allows(attr, a.line, a.with_line,
                                      fn_lines.get(a.fn, 0))
               for a, _ in locked):
            return
        self.diags.append(_d(
            "L105",
            f"shared attribute '{prefix}{attr}' is guarded by DIFFERENT "
            f"locks at different sites ({', '.join(lock_names)}; lines "
            f"{', '.join(str(s) for s in sites[:4])}) — no single lock "
            "covers it",
            self.where(sites[0]),
            hint="pick one guard for the attribute (declare it with "
                 "'# guarded-by: <lock>') and take that lock at every "
                 "site"))

    def _check_l106(self, scope: _Scope, attr: str, guard: str,
                    prefix: str):
        """Read-under-guard, release, later re-acquire + write, in one
        function — the check-then-act shape."""
        fn_lines = {f.name: f.node.lineno for f in scope.fns.values()}
        for fn in scope.fns.values():
            if fn.name not in scope.multi:
                continue
            base = fn.base or frozenset()
            if guard in base:
                continue  # never released between the regions
            regions = [r for r in fn.regions if r[0] == guard]
            for i, (lock, line_r, reads, _w) in enumerate(regions):
                if attr not in reads:
                    continue
                for (_lock2, line_w, _r2, writes) in regions[i + 1:]:
                    if attr not in writes:
                        continue
                    if self.directives.allows(
                            attr, line_r, line_w,
                            fn_lines.get(fn.name, 0)):
                        continue
                    self.diags.append(_d(
                        "L106",
                        f"check-then-act on '{prefix}{attr}' in "
                        f"{scope.qual}.{fn.name}(): read under "
                        f"'{_short(guard)}' at line {line_r}, lock "
                        f"released, dependent write re-acquires it at "
                        f"line {line_w}",
                        self.where(line_w),
                        hint="merge the two critical sections (the "
                             "stop-races-step double-answer shape from "
                             "the serving reviews), or re-validate the "
                             "read inside the second acquisition and "
                             "annotate '# lint: allow-unguarded"
                             f"({attr})'"))
                    break

    # --- entry ------------------------------------------------------------
    def run(self):
        try:
            tree = ast.parse(self.src, filename=self.filename)
        except SyntaxError as e:
            self.diags.append(_d("L104", f"unparseable source: {e}",
                                 self.where(getattr(e, "lineno", 0) or 0)))
            return
        mod = self._module_scope(tree)
        self._find_entries(mod)
        # module-global accesses come from top-level functions AND class
        # methods (e.g. the trace ring's Span.__exit__ appends) — keyed
        # qualified ('Cls.meth'), so a method sharing a module
        # function's bare name still gets analyzed
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for n in node.body:
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        mod.fns[f"{node.name}.{n.name}"] = _Fn(
                            f"{node.name}.{n.name}", n)
        # class-method "functions" in the module scope are reachable
        # from wherever their class is used: treat all non-__init__
        # ones as roots alongside the module's own public surface
        extra_roots = {n for n in mod.fns if "." in n
                       and not n.endswith(".__init__")}
        mod.entries |= extra_roots
        self._check_scope(mod)

        for cls in [n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)]:
            scope = self._class_scope(cls, mod)
            self._check_scope(scope)


def _short(lock_id: str) -> str:
    return lock_id.rsplit(".", 1)[-1]


def lint_source(src: str, filename: str = "<src>") -> List[Diagnostic]:
    """Lint one source string (unit tests / selftest)."""
    lint = _Lint(filename, src)
    lint.run()
    return lint.diags


def lint_paths(paths: Sequence[str]) -> List[Diagnostic]:
    """Lint every .py file under `paths` (files or directories)."""
    from .locks import iter_py_files

    diags: List[Diagnostic] = []
    for f in iter_py_files(paths):
        with open(f, "r", encoding="utf-8") as fh:
            src = fh.read()
        lint = _Lint(os.path.relpath(f), src)
        lint.run()
        diags += lint.diags
    return diags


def default_lint_paths(repo_root: Optional[str] = None) -> List[str]:
    from .locks import default_lint_paths as _locks_paths

    return _locks_paths(repo_root)


def declared_guards(src: str) -> Dict[str, Dict[str, str]]:
    """class name -> {attr: lock attr} of the '# guarded-by:' comments
    in one source file — the shared parser the runtime sanitizer
    (analysis/sanitize.py) uses, so the static model and the dynamic
    assertions can never drift."""
    out: Dict[str, Dict[str, str]] = {}
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return out
    directives = _Directives(src)
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        per: Dict[str, str] = {}
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name != "__init__":
                continue
            for st in ast.walk(fn):
                tgts = []
                if isinstance(st, ast.Assign):
                    tgts = st.targets
                elif isinstance(st, (ast.AnnAssign, ast.AugAssign)):
                    tgts = [st.target]
                decl = directives.decl_for(st) if tgts else None
                if decl is None:
                    continue
                for t in tgts:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        per[t.attr] = decl
        if per:
            out[cls.name] = per
    return out
