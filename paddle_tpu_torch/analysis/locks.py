"""Concurrency lint — lock-acquisition graph + blocking-call-under-lock
(the JAX package's ``analysis/locks.py``, aimed at the port).

An AST pass over the lock-heavy runtime modules (`distributed/`,
`observability/` by default) that proves lock discipline statically
instead of waiting for the deadlock:

  - collects every `threading.Lock`/`RLock`/`Condition` attribute
    (`self._mu = threading.Lock()`, module-level `_clients_mu = ...`,
    dict-of-locks families like `self._param_locks[...]`), aliasing a
    `Condition(self._mu)` to the lock it wraps;
  - symbolically walks each function tracking the held-lock stack
    through `with` statements, recording which locks are acquired (and
    which blocking calls are reached) while other locks are held —
    including one level of same-class `self.method()` calls, closed
    transitively over the class's call graph;
  - reports:

    L101 (error)   lock-order cycle (or a declared-order violation): two
                   code paths acquire the same locks in opposite order
    L102 (error)   blocking call under a lock: `socket.recv`,
                   `RpcClient.call`, `time.sleep`, `Event.wait`,
                   `Thread.join`, frame IO ... reached while a lock is
                   held (a `Condition.wait` on the held condition itself
                   is exempt — it releases the lock while parked)
    L103 (error)   self-deadlock: a non-reentrant lock acquired while
                   already held on the same path (directly or through a
                   same-class call)

Vetted sites are annotated in source:

    # lint: allow-blocking        on the blocking call, its `with` line,
                                  or the function's `def` line
    # lint: allow-lock-order      excludes an acquisition edge from the
                                  order graph
    # lint: lock-order(a<b)       declares the intended order of two
                                  locks (short attr names); an observed
                                  b-then-a path becomes an L101 violation
    # lint: lock-alias            on a `self._mu = mu` assignment:
                                  the attribute IS a lock, injected by
                                  the owner (shared-lock composition —
                                  PrefixIndex runs under its
                                  allocator's mutex); registered as a
                                  lock attribute of the scope so
                                  guarded-by declarations may name it
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import ERROR, Diagnostic

PASS_NAME = "locks"

# attribute method names that block the calling thread
_BLOCKING_ATTRS = {
    "recv", "recv_into", "recvfrom", "accept", "connect",
    "create_connection", "sleep", "wait", "call", "serve_forever",
    "getaddrinfo", "select",
}
# bare-name calls that block (module-level helpers of the RPC framing)
_BLOCKING_NAMES = {
    "read_frame", "read_msg", "write_msg", "write_frame",
    "create_connection", "sleep",
}
_LOCK_CTORS = {"Lock", "RLock", "Semaphore", "BoundedSemaphore"}

_DIRECTIVE_RE = re.compile(r"#\s*lint:\s*([a-z\-]+)(?:\(([^)]*)\))?")


def _d(code, msg, where, hint=""):
    return Diagnostic(code=code, severity=ERROR, message=msg, where=where,
                      hint=hint, pass_name=PASS_NAME)


def _walk_own(fn_node):
    """Yield nodes of a function body WITHOUT descending into nested
    function/class definitions (they run later, under their own locks)."""
    stack = list(fn_node.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _expr_text(node) -> Optional[str]:
    """Dotted/indexed text of a lock expression, or None if unresolvable.
    `self._param_locks[name]` -> 'self._param_locks[]' (a lock family)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _expr_text(node.value)
        return f"{base}.{node.attr}" if base else None
    if isinstance(node, ast.Subscript):
        base = _expr_text(node.value)
        return f"{base}[]" if base else None
    return None


def _contains_lock_ctor(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if name in _LOCK_CTORS or name == "Condition":
                return True
    return False


class _Directives:
    """Per-line `# lint:` comments of one source file."""

    def __init__(self, src: str):
        self.by_line: Dict[int, Set[str]] = {}
        self.order_decls: List[Tuple[str, str]] = []
        lines = src.splitlines()
        try:
            toks = tokenize.generate_tokens(io.StringIO(src).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                for m in _DIRECTIVE_RE.finditer(tok.string):
                    kind, arg = m.group(1), m.group(2)
                    if kind == "lock-order" and arg and "<" in arg:
                        a, b = (s.strip() for s in arg.split("<", 1))
                        self.order_decls.append((a, b))
                        continue
                    ln = tok.start[0]
                    self.by_line.setdefault(ln, set()).add(kind)
                    # a directive in a standalone comment (or a comment
                    # block) also covers the next code line below it
                    if lines[ln - 1].lstrip().startswith("#"):
                        j = ln
                        while j < len(lines) and (
                                not lines[j].strip()
                                or lines[j].lstrip().startswith("#")):
                            j += 1
                        if j < len(lines):
                            self.by_line.setdefault(j + 1, set()).add(kind)
        except tokenize.TokenError:
            pass

    def allows(self, kind: str, *lines: int) -> bool:
        return any(kind in self.by_line.get(ln, ()) for ln in lines if ln)


class _FnSummary:
    __slots__ = ("name", "node", "acquires", "blocking", "calls")

    def __init__(self, name, node):
        self.name = name
        self.node = node
        self.acquires: Set[str] = set()   # lock ids acquired anywhere inside
        self.blocking: bool = False       # reaches a blocking call
        self.calls: Set[str] = set()      # same-scope callee names


class _Scope:
    """One lint scope: a module's top level, or one class."""

    def __init__(self, qual: str):
        self.qual = qual                      # "rpc.RpcClient" / "rpc"
        self.locks: Dict[str, str] = {}       # expr text -> canonical id
        self.rlocks: Set[str] = set()         # canonical ids that reenter
        self.conditions: Set[str] = set()     # canonical ids that are Conditions
        self.fns: Dict[str, _FnSummary] = {}


class _Lint:
    def __init__(self, filename: str, src: str):
        self.filename = filename
        self.short = os.path.splitext(os.path.basename(filename))[0]
        self.src = src
        self.directives = _Directives(src)
        self.diags: List[Diagnostic] = []
        # global (per-run) lock-order edges: (a, b) -> (where, lines)
        self.edges: Dict[Tuple[str, str], Tuple[str, Tuple[int, ...]]] = {}

    def where(self, line: int) -> str:
        return f"{self.filename}:{line}"

    # --- lock discovery --------------------------------------------------
    def _scan_locks(self, scope: _Scope, body, self_name: str):
        """Find lock-attribute assignments anywhere in `body` (methods
        included: locks are usually created in __init__)."""
        for node in ast.walk(ast.Module(body=list(body), type_ignores=[])):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = _expr_text(node.targets[0])
            if tgt is None:
                continue
            val = node.value
            # `self._mu = mu  # lint: lock-alias` — an injected shared
            # lock (the owner passes its own mutex in); same identity
            # rules as a constructed lock
            if self.directives.allows("lock-alias", node.lineno) and \
                    (tgt.startswith(self_name + ".") or "." not in tgt):
                cid = f"{scope.qual}.{tgt.split('.')[-1]}"
                scope.locks[tgt] = cid
                continue
            if isinstance(val, ast.Call):
                fn = val.func
                ctor = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else None)
                if ctor in _LOCK_CTORS:
                    cid = f"{scope.qual}.{tgt.split('.')[-1]}" \
                        if tgt.startswith(self_name + ".") else \
                        f"{scope.qual}.{tgt}" if "." not in tgt else None
                    if cid:
                        scope.locks[tgt] = cid
                        if ctor == "RLock":
                            scope.rlocks.add(cid)
                    continue
                if ctor == "Condition":
                    # Condition(self._mu) shares _mu's identity; a bare
                    # Condition() owns a private lock
                    alias = None
                    if val.args:
                        alias = scope.locks.get(_expr_text(val.args[0]) or "")
                    cid = alias or (f"{scope.qual}.{tgt.split('.')[-1]}"
                                    if tgt.startswith(self_name + ".")
                                    or "." not in tgt else None)
                    if cid:
                        scope.locks[tgt] = cid
                        scope.conditions.add(cid)
                    continue
            # dict/comprehension of locks -> a family id
            if _contains_lock_ctor(val) and not isinstance(val, ast.Call):
                if tgt.startswith(self_name + ".") or "." not in tgt:
                    scope.locks[tgt + "[]"] = \
                        f"{scope.qual}.{tgt.split('.')[-1]}[]"

    # --- per-function symbolic walk --------------------------------------
    def _resolve_lock(self, scope: _Scope, node) -> Optional[str]:
        txt = _expr_text(node)
        if txt is None:
            return None
        return scope.locks.get(txt)

    def _summarize(self, scope: _Scope, fn: _FnSummary):
        for node in _walk_own(fn.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    cid = self._resolve_lock(scope, item.context_expr)
                    if cid:
                        fn.acquires.add(cid)
            elif isinstance(node, ast.Call):
                if self._is_blocking_call(scope, node, held=None):
                    fn.blocking = True
                callee = self._self_callee(node)
                if callee:
                    fn.calls.add(callee)

    @staticmethod
    def _self_callee(node: ast.Call) -> Optional[str]:
        fn = node.func
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "self":
            return fn.attr
        return None

    def _is_blocking_call(self, scope: _Scope, node: ast.Call,
                          held: Optional[List[str]]) -> bool:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr not in _BLOCKING_ATTRS:
                return False
            if fn.attr == "wait":
                # Condition.wait on the held condition releases it — it
                # only parks other holders when MORE locks are held.
                # During summary (held=None) any wait counts as blocking;
                # the symbolic walk refines it.
                cid = self._resolve_lock(scope, fn.value)
                if held is not None and cid is not None and \
                        cid in held and len(held) == 1:
                    return False
            if fn.attr == "join":
                # keep str.join / os.path.join out: only thread-ish
                # receivers count
                txt = _expr_text(fn.value) or ""
                if "thread" not in txt.lower() and not any(
                        kw.arg == "timeout" for kw in node.keywords):
                    return False
            return True
        if isinstance(fn, ast.Name):
            return fn.id in _BLOCKING_NAMES
        return False

    def _walk_fn(self, scope: _Scope, fn: _FnSummary):
        def_line = fn.node.lineno

        def scan_exprs(node, held):
            """Check calls in an expression subtree (no statements inside
            except lambdas/comprehensions, which share the held set)."""
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and held:
                    self._check_call(scope, fn, sub, held, def_line)

        def visit(stmts, held: List[Tuple[str, int]]):
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue  # runs later, with no inherited locks
                if isinstance(st, ast.With):
                    new_held = list(held)
                    with_line = st.lineno
                    for item in st.items:
                        scan_exprs(item.context_expr, held)
                        cid = self._resolve_lock(scope, item.context_expr)
                        if cid is None:
                            continue
                        self._note_acquire(scope, fn, cid, new_held,
                                           with_line, def_line)
                        new_held.append((cid, with_line))
                    visit(st.body, new_held)
                    continue
                # expressions hanging directly off this statement
                for field, value in ast.iter_fields(st):
                    if isinstance(value, ast.expr):
                        scan_exprs(value, held)
                    elif isinstance(value, list):
                        for v in value:
                            if isinstance(v, ast.expr):
                                scan_exprs(v, held)
                # nested statement lists (if/for/try/while bodies)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(st, field, None)
                    if isinstance(sub, list) and sub and \
                            isinstance(sub[0], ast.stmt):
                        visit(sub, held)
                for h in getattr(st, "handlers", []):
                    visit(h.body, held)

        visit(fn.node.body, [])

    def _note_acquire(self, scope, fn, cid, held, line, def_line):
        held_ids = [c for c, _ in held]
        if cid in held_ids and cid not in scope.rlocks:
            self.diags.append(_d(
                "L103",
                f"lock '{cid}' acquired at line {line} while already "
                "held on this path (non-reentrant: self-deadlock)",
                self.where(line),
                hint="split the critical section or use the *_locked "
                     "convention"))
        for h, _hl in held:
            if h == cid:
                continue
            if self.directives.allows("allow-lock-order", line, def_line):
                continue
            self.edges.setdefault((h, cid), (self.where(line),
                                             (line, def_line)))

    def _check_call(self, scope, fn, node: ast.Call, held, def_line):
        held_ids = [c for c, _ in held]
        lines = [node.lineno, def_line] + [hl for _, hl in held]
        callee = self._self_callee(node)
        if callee and callee in scope.fns:
            summ = self._closure(scope, callee)
            for cid in summ.acquires:
                if cid in held_ids and cid not in scope.rlocks:
                    self.diags.append(_d(
                        "L103",
                        f"call to self.{callee}() at line {node.lineno} "
                        f"re-acquires held lock '{cid}'",
                        self.where(node.lineno)))
                elif cid not in held_ids:
                    if not self.directives.allows("allow-lock-order",
                                                  *lines):
                        for h in held_ids:
                            self.edges.setdefault(
                                (h, cid),
                                (self.where(node.lineno),
                                 tuple(lines)))
            if summ.blocking and not self.directives.allows(
                    "allow-blocking", *lines):
                self.diags.append(_d(
                    "L102",
                    f"self.{callee}() blocks (transitively) while "
                    f"holding {held_ids}",
                    self.where(node.lineno),
                    hint="move the blocking work outside the lock, or "
                         "annotate '# lint: allow-blocking' if vetted"))
            return
        if self._is_blocking_call(scope, node, held=held_ids):
            if not self.directives.allows("allow-blocking", *lines):
                call_txt = _expr_text(node.func) or "<call>"
                self.diags.append(_d(
                    "L102",
                    f"blocking call {call_txt}() while holding "
                    f"{held_ids}",
                    self.where(node.lineno),
                    hint="a peer needing this lock parks behind network/"
                         "sleep time; move the call outside the lock or "
                         "annotate '# lint: allow-blocking' if vetted"))

    def _closure(self, scope: _Scope, name: str,
                 _seen: Optional[Set[str]] = None) -> _FnSummary:
        """Transitive acquires/blocking over the same-scope call graph."""
        _seen = _seen or set()
        fn = scope.fns[name]
        if name in _seen:
            return fn
        _seen.add(name)
        out = _FnSummary(fn.name, fn.node)
        out.acquires |= fn.acquires
        out.blocking = fn.blocking
        for callee in fn.calls:
            if callee in scope.fns:
                sub = self._closure(scope, callee, _seen)
                out.acquires |= sub.acquires
                out.blocking = out.blocking or sub.blocking
        return out

    # --- entry ----------------------------------------------------------
    def run(self) -> None:
        try:
            tree = ast.parse(self.src, filename=self.filename)
        except SyntaxError as e:
            self.diags.append(_d("L101", f"unparseable source: {e}",
                                 self.where(getattr(e, "lineno", 0) or 0)))
            return
        mod_scope = _Scope(self.short)
        top_fns = [n for n in tree.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        self._scan_locks(mod_scope, tree.body, self_name="<module>")
        for n in top_fns:
            mod_scope.fns[n.name] = _FnSummary(n.name, n)
        for fn in mod_scope.fns.values():
            self._summarize(mod_scope, fn)
        for fn in mod_scope.fns.values():
            self._walk_fn(mod_scope, fn)

        for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
            scope = _Scope(f"{self.short}.{cls.name}")
            scope.locks.update(mod_scope.locks)  # module locks visible
            scope.rlocks |= mod_scope.rlocks
            scope.conditions |= mod_scope.conditions
            self._scan_locks(scope, cls.body, self_name="self")
            for n in cls.body:
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scope.fns[n.name] = _FnSummary(n.name, n)
            for fn in scope.fns.values():
                self._summarize(scope, fn)
            for fn in scope.fns.values():
                self._walk_fn(scope, fn)


def _short(lock_id: str) -> str:
    return lock_id.rsplit(".", 1)[-1]


def _check_order(edges, decls) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    # declared-order violations (short-name matching)
    for (a, b), (where, _) in edges.items():
        for (x, y) in decls:
            if _short(a) == y and _short(b) == x:
                diags.append(_d(
                    "L101",
                    f"lock order violation: '{a}' acquired before '{b}' "
                    f"but '# lint: lock-order({x}<{y})' declares the "
                    "opposite",
                    where))
    # cycles
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    state: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(u):
        state[u] = 1
        stack.append(u)
        for v in graph.get(u, ()):
            if state.get(v, 0) == 0:
                cyc = dfs(v)
                if cyc:
                    return cyc
            elif state.get(v) == 1:
                return stack[stack.index(v):] + [v]
        stack.pop()
        state[u] = 2
        return None

    for u in list(graph):
        if state.get(u, 0) == 0:
            cyc = dfs(u)
            if cyc:
                where = edges.get((cyc[0], cyc[1]), ("", ()))[0]
                diags.append(_d(
                    "L101",
                    "lock-order cycle: " + " -> ".join(cyc),
                    where,
                    hint="two paths take these locks in opposite order "
                         "— pick one order and declare it with "
                         "'# lint: lock-order(a<b)'"))
                break
    return diags


def lint_source(src: str, filename: str = "<src>") -> List[Diagnostic]:
    """Lint one source string (unit tests / selftest)."""
    lint = _Lint(filename, src)
    lint.run()
    return lint.diags + _check_order(lint.edges,
                                     lint.directives.order_decls)


def iter_py_files(paths) -> List[str]:
    """Every .py file under `paths` (files or directories), sorted and
    deduped, __pycache__ skipped — the one walk both concurrency lints
    (this pass and guards.py) share."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                if "__pycache__" in root:
                    continue
                files += [os.path.join(root, n) for n in sorted(names)
                          if n.endswith(".py")]
        elif p.endswith(".py"):
            files.append(p)
    return sorted(set(files))


def lint_paths(paths) -> List[Diagnostic]:
    """Lint every .py file under `paths` (files or directories); the
    lock-order graph is global across all of them."""
    diags: List[Diagnostic] = []
    edges: Dict[Tuple[str, str], Tuple[str, Tuple[int, ...]]] = {}
    decls: List[Tuple[str, str]] = []
    for f in iter_py_files(paths):
        with open(f, "r", encoding="utf-8") as fh:
            src = fh.read()
        lint = _Lint(os.path.relpath(f), src)
        lint.run()
        diags += lint.diags
        for k, v in lint.edges.items():
            edges.setdefault(k, v)
        decls += lint.directives.order_decls
    return diags + _check_order(edges, decls)


def default_lint_paths(repo_root: Optional[str] = None) -> List[str]:
    """The port's seven runtime directories, the JAX package's seven."""
    root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    pkg = os.path.join(root, "paddle_tpu_torch")
    return [os.path.join(pkg, "distributed"),
            os.path.join(pkg, "observability"),
            os.path.join(pkg, "serving"),
            os.path.join(pkg, "autotune"),
            os.path.join(pkg, "fleet"),
            os.path.join(pkg, "checkpoint"),
            os.path.join(pkg, "mesh")]
