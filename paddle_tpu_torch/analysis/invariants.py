"""Invariant lint — cross-checks for stringly-typed registries that
drift silently: the JAX package's ``analysis/invariants.py``, aimed at
the port (``paddle_tpu_torch/``, its ``flags.py``, the port's tests
``tests/test_torch_*.py`` and ``chip_smoke.py``).

Three registries are keyed by bare strings, with the producers and
consumers in different files (and different processes):

  - fault-injection sites: `faults.fire("<site>")` calls in the runtime
    vs. the `kind@site:sel` specs tests and tools install;
  - metric / gauge / histogram / span names: `metrics.counter("x.y")` /
    `tracing.span("x.y")` registrations in the package vs. the names
    tests assert on;
  - FLAGS keys: `FLAGS["k"]` reads vs. the keys defined in
    `paddle_tpu_torch/flags.py`.

    N201 (error)   fault spec names a site no injection point declares
    N202 (error)   metric/span name asserted in tests that no source
                   registration declares
    N203 (error)   FLAGS key read/written that paddle_tpu_torch/flags.py
                   does not define
    N204 (warning) FLAGS key defined but never read anywhere
    N205 (error)   an instance-keyed gauge registration (an f-string
                   gauge name) with no zero-at-retirement `.set(0)` site
                   outside `__init__` in the same class: during a
                   hot-swap drain the old version's final value would
                   linger (or clobber the live engine's) forever

The port's tests drive both packages side by side, so a FLAGS read or
write is resolved by the import that binds the name in its file and
scope: `FLAGS`, `set_flags`, `get_flag` and `effective_flag` (under any
alias, or reached through a module alias) bound from `paddle_tpu…` are
the JAX package's and are not checked against the port's keys. A name
no import binds is the port's. The JAX package's docs describe the JAX
package, so this pass reads none.

Suppress a deliberate bad name with `# lint: allow-site` /
`# lint: allow-name` on the same line; a versioned gauge whose lifetime
really is the process's with `# lint: allow-unzeroed`.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .diagnostics import ERROR, WARNING, Diagnostic

PASS_NAME = "invariants"


def _d(code, sev, msg, where="", hint=""):
    return Diagnostic(code=code, severity=sev, message=msg, where=where,
                      hint=hint, pass_name=PASS_NAME)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _py_files(*dirs: str) -> List[str]:
    out: List[str] = []
    for d in dirs:
        if os.path.isfile(d) and d.endswith(".py"):
            out.append(d)
            continue
        for root, _subdirs, names in os.walk(d):
            if "__pycache__" in root:
                continue
            out += [os.path.join(root, n) for n in sorted(names)
                    if n.endswith(".py")]
    return sorted(set(out))


def _read(path: str) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def _parse(path: str, src: Optional[str] = None):
    try:
        return ast.parse(src if src is not None else _read(path),
                         filename=path)
    except SyntaxError:
        return None


def _mentions(path: str, words: Iterable[str]) -> bool:
    """Does the file's source contain one of `words`? Every AST match a
    collector looks for spells one of them, so a file without any is
    skipped unparsed."""
    src = _read(path)
    return any(w in src for w in words)


def _suppressed_lines(src: str, token: str) -> Set[int]:
    out = set()
    for i, line in enumerate(src.splitlines(), start=1):
        if f"lint: {token}" in line:
            out.add(i)
    return out


def _joinedstr_pattern(node: ast.JoinedStr) -> str:
    """f"handler.{method}" -> 'handler.*' (wildcard per placeholder)."""
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            parts.append("*")
    return "".join(parts)


def _match(name: str, exact: Set[str], patterns: Set[str]) -> bool:
    if name in exact:
        return True
    for pat in patterns:
        if re.fullmatch(re.escape(pat).replace(r"\*", r"[^\s]+"), name):
            return True
    return False


# --- fault sites -------------------------------------------------------

_SPEC_RULE_RE = re.compile(
    r"(?:refuse|drop|delay|error|crash)@([\w.\-]+):")


def collect_declared_sites(pkg_dir: str) -> Tuple[Set[str], Set[str]]:
    """(exact sites, wildcard patterns) from `faults.fire(...)` /
    `_faults.fire(...)` call sites in the runtime package."""
    exact: Set[str] = set()
    patterns: Set[str] = set()
    for path in _py_files(pkg_dir):
        tree = _parse(path) if _mentions(path, ("fire",)) else None
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr == "fire"):
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                exact.add(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                patterns.add(_joinedstr_pattern(arg))
    return exact, patterns


def collect_used_sites(paths: Iterable[str]
                       ) -> List[Tuple[str, str, int, bool]]:
    """(site, file, line, suppressed) for every `kind@site:` occurrence
    inside string constants of the given files/dirs."""
    out: List[Tuple[str, str, int, bool]] = []
    for path in _py_files(*paths):
        src = _read(path)
        if "@" not in src:
            continue
        suppressed = _suppressed_lines(src, "allow-site")
        tree = _parse(path, src)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                for m in _SPEC_RULE_RE.finditer(node.value):
                    out.append((m.group(1), path, node.lineno,
                                node.lineno in suppressed))
            elif isinstance(node, ast.JoinedStr):
                for v in node.values:
                    if isinstance(v, ast.Constant) and \
                            isinstance(v.value, str):
                        for m in _SPEC_RULE_RE.finditer(v.value):
                            out.append((m.group(1), path, node.lineno,
                                        node.lineno in suppressed))
    return out


def check_fault_sites(declared: Tuple[Set[str], Set[str]],
                      used: List[Tuple[str, str, int, bool]]
                      ) -> List[Diagnostic]:
    exact, patterns = declared
    diags: List[Diagnostic] = []
    for site, path, line, suppressed in used:
        if suppressed:
            continue
        if _match(site, exact, patterns):
            continue
        diags.append(_d(
            "N201", ERROR,
            f"fault spec targets site '{site}', but no "
            "faults.fire() call declares it",
            where=f"{os.path.relpath(path, _repo_root())}:{line}",
            hint="declared sites: " + ", ".join(
                sorted(exact | patterns)) +
            "; annotate '# lint: allow-site' for grammar-only specs"))
    return diags


# --- metric / span names ----------------------------------------------

_METRIC_FNS = {"counter", "gauge", "histogram"}
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_*]+)+$")


def collect_declared_names(pkg_dir: str) -> Tuple[Set[str], Set[str]]:
    """(exact, patterns) of metric AND span registrations in the
    package: literal or f-string first args of metrics.counter/gauge/
    histogram and tracing.span calls."""
    exact: Set[str] = set()
    patterns: Set[str] = set()
    for path in _py_files(pkg_dir):
        tree = _parse(path) if _mentions(
            path, tuple(_METRIC_FNS) + ("span",)) else None
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if name not in _METRIC_FNS and name != "span":
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                exact.add(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                patterns.add(_joinedstr_pattern(arg))
    return exact, patterns


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


class NameUniverse:
    """Everything a dotted name in a test may legitimately refer to:
    declared metrics/spans (dotted or prometheus-sanitized), fault
    sites, or an actual attribute of a paddle_tpu_torch module."""

    # first path segment -> module to getattr against
    _MODULES = {
        "tracing": "paddle_tpu_torch.observability.tracing",
        "metrics": "paddle_tpu_torch.observability.metrics",
        "timeline": "paddle_tpu_torch.observability.timeline",
        "debug_server": "paddle_tpu_torch.observability.debug_server",
        "faults": "paddle_tpu_torch.distributed.faults",
        "elastic": "paddle_tpu_torch.distributed.elastic",
        "master": "paddle_tpu_torch.distributed.master",
        "fluid": "paddle_tpu_torch.fluid",
        "executor": "paddle_tpu_torch.fluid.executor",
        "io": "paddle_tpu_torch.fluid.io",
        "serving": "paddle_tpu_torch.serving",
        "autotune": "paddle_tpu_torch.autotune",
        "fleet": "paddle_tpu_torch.fleet",
        "checkpoint": "paddle_tpu_torch.checkpoint",
        "mesh": "paddle_tpu_torch.mesh",
    }

    def __init__(self, names: Tuple[Set[str], Set[str]],
                 sites: Tuple[Set[str], Set[str]]):
        self.exact, self.patterns = names
        self.site_exact, self.site_patterns = sites
        self.sanitized = {_sanitize(n) for n in self.exact}
        # sanitize but keep the wildcard character live
        self.sanitized_patterns = {
            "".join(c if (c.isalnum() or c in "_:*") else "_" for c in p)
            for p in self.patterns}
        # prefixes that make a dotted string "one of ours"
        self.prefixes = {n.split(".", 1)[0] for n in self.exact} | \
            {p.split(".", 1)[0] for p in self.patterns if "*" not in
             p.split(".", 1)[0]}

    def claims(self, name: str) -> bool:
        """Does this dotted name LOOK like one of our registry names
        (and therefore must resolve)?"""
        return _NAME_RE.match(name) is not None and \
            name.split(".", 1)[0] in self.prefixes

    def resolves(self, name: str) -> bool:
        if _match(name, self.exact, self.patterns):
            return True
        if _match(name, self.site_exact, self.site_patterns):
            return True
        if "_" in name and _match(name, self.sanitized,
                                  self.sanitized_patterns):
            return True
        # module attribute (docs reference code in the same style)
        head, _, rest = name.partition(".")
        mod_name = self._MODULES.get(head)
        if mod_name and rest:
            try:
                import importlib

                obj = importlib.import_module(mod_name)
                for part in rest.split("."):
                    obj = getattr(obj, part)
                return True
            except (ImportError, AttributeError):
                return False
        return False


def collect_test_name_refs(paths: Iterable[str], universe: NameUniverse
                           ) -> List[Tuple[str, str, int, bool]]:
    out: List[Tuple[str, str, int, bool]] = []
    for path in _py_files(*paths):
        src = _read(path)
        suppressed = _suppressed_lines(src, "allow-name")
        tree = _parse(path, src)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    universe.claims(node.value):
                out.append((node.value, path, node.lineno,
                            node.lineno in suppressed))
    return out


_BACKTICK_RE = re.compile(r"`([^`\s]+)`")


def collect_doc_name_refs(doc_paths: Iterable[str], universe: NameUniverse
                          ) -> List[Tuple[str, str, int, bool]]:
    out: List[Tuple[str, str, int, bool]] = []
    for path in doc_paths:
        if not os.path.exists(path):
            continue
        for lineno, line in enumerate(_read(path).splitlines(), start=1):
            suppressed = "lint: allow-name" in line
            for m in _BACKTICK_RE.finditer(line):
                token = m.group(1).strip("*`,.;:()")
                if universe.claims(token):
                    out.append((token, path, lineno, suppressed))
    return out


def check_names(universe: NameUniverse,
                refs: List[Tuple[str, str, int, bool]]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    seen: Set[Tuple[str, str, int]] = set()
    for name, path, line, suppressed in refs:
        if suppressed or universe.resolves(name):
            continue
        key = (name, path, line)
        if key in seen:
            continue
        seen.add(key)
        diags.append(_d(
            "N202", ERROR,
            f"name '{name}' is asserted/documented but no "
            "metrics.counter/gauge/histogram or tracing.span "
            "registration declares it",
            where=f"{os.path.relpath(path, _repo_root())}:{line}",
            hint="rename the reference to the registered name, or "
                 "annotate 'lint: allow-name' if deliberate"))
    return diags


# --- FLAGS keys --------------------------------------------------------

def _readthrough_keys(flags_path: str) -> Set[str]:
    """Keys _Flags.__getitem__ special-cases via `k == "..."` dispatch
    — defined (and consumed) without ever appearing in a subscript."""
    tree = _parse(flags_path)
    out: Set[str] = set()
    if tree is None:
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare) and \
                isinstance(node.left, ast.Name) and node.left.id == "k":
            for cmp in node.comparators:
                if isinstance(cmp, ast.Constant) and \
                        isinstance(cmp.value, str):
                    out.add(cmp.value)
    return out


def collect_defined_flags(flags_path: str) -> Set[str]:
    """Literal keys of the FLAGS dict in flags.py (including the
    read-through keys its _Flags.__getitem__ special-cases)."""
    tree = _parse(flags_path)
    defined: Set[str] = set(_readthrough_keys(flags_path))
    if tree is None:
        return defined
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if targets and any(isinstance(t, ast.Name) and t.id == "FLAGS"
                           for t in targets):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Dict):
                    for k in sub.keys:
                        if isinstance(k, ast.Constant) and \
                                isinstance(k.value, str):
                            defined.add(k.value)
    return defined


_FLAG_API = frozenset({"FLAGS", "set_flags", "get_flag", "effective_flag"})
_PORT, _OTHER = "port", "other"
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _module_owner(module: str, level: int) -> Optional[str]:
    """Which package an import names: a relative import is the port's
    (the pass reads the port's package), ``paddle_tpu_torch…`` the
    port's, ``paddle_tpu…`` the other package's; else neither."""
    if level:
        return _PORT
    root = module.split(".", 1)[0]
    if root == "paddle_tpu_torch":
        return _PORT
    if root == "paddle_tpu":
        return _OTHER
    return None


def _own_nodes(scope):
    """The nodes of one scope, not descending into nested scopes."""
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, _SCOPES):
            todo.extend(ast.iter_child_nodes(node))


def _bindings(scope) -> Dict[str, Tuple[str, str]]:
    """local name -> (owner, what) for the imports of one scope: `what`
    is the flag-API name an import binds, or "module" for a module (or
    any other object) of a package."""
    out: Dict[str, Tuple[str, str]] = {}
    for node in _own_nodes(scope):
        if isinstance(node, ast.Import):
            for a in node.names:
                owner = _module_owner(a.name, 0)
                if owner is not None:
                    out[a.asname or a.name.split(".", 1)[0]] = \
                        (owner, "module")
        elif isinstance(node, ast.ImportFrom):
            owner = _module_owner(node.module or "", node.level)
            if owner is None:
                continue
            for a in node.names:
                out[a.asname or a.name] = (
                    owner, a.name if a.name in _FLAG_API else "module")
    return out


def _root_name(node) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _api_owner(node, chain) -> Tuple[Optional[str], Optional[str]]:
    """(flag-API name, owning package) of an expression naming FLAGS or
    a flag function — directly, under an import alias, or as an
    attribute of a module alias; (None, None) for anything else."""
    def lookup(name):
        for b in reversed(chain):
            if name in b:
                return b[name]
        return None

    if isinstance(node, ast.Name):
        bound = lookup(node.id)
        if bound is not None:
            owner, what = bound
            return (what, owner) if what in _FLAG_API else (None, None)
        return (node.id, _PORT) if node.id in _FLAG_API else (None, None)
    if isinstance(node, ast.Attribute) and node.attr in _FLAG_API:
        bound = lookup(_root_name(node.value) or "")
        return node.attr, (bound[0] if bound is not None else _PORT)
    return None, None


def collect_flag_refs(paths: Iterable[str], skip_files: Set[str] = frozenset()
                      ) -> List[Tuple[str, str, int, str]]:
    """(key, file, line, kind) of the port's FLAGS["k"] subscripts,
    get_flag("k") / effective_flag("k") calls (the tuner read-through is
    still a FLAGS read — the entry is its cold-cache default), and
    set_flags({"k": ...}) literal keys. Each name is resolved by the
    import that binds it in its scope; refs of the other package's
    flags are left out."""
    out: List[Tuple[str, str, int, str]] = []

    def visit(node, chain, path):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str):
            api, owner = _api_owner(node.value, chain)
            if api == "FLAGS" and owner == _PORT:
                kind = "write" if isinstance(
                    getattr(node, "ctx", None), ast.Store) else "read"
                out.append((node.slice.value, path, node.lineno, kind))
        elif isinstance(node, ast.Call):
            api, owner = _api_owner(node.func, chain)
            if owner == _PORT and api in ("get_flag", "effective_flag") \
                    and node.args and isinstance(node.args[0], ast.Constant):
                out.append((node.args[0].value, path, node.lineno, "read"))
            elif owner == _PORT and api == "set_flags" and node.args and \
                    isinstance(node.args[0], ast.Dict):
                for k in node.args[0].keys:
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str):
                        out.append((k.value, path, node.lineno, "write"))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SCOPES):
                visit(child, chain + [_bindings(child)], path)
            else:
                visit(child, chain, path)

    for path in _py_files(*paths):
        if os.path.abspath(path) in skip_files or \
                not _mentions(path, _FLAG_API):
            continue
        tree = _parse(path)
        if tree is None:
            continue
        visit(tree, [_bindings(tree)], path)
    return out


def check_flags(defined: Set[str],
                refs: List[Tuple[str, str, int, str]],
                warn_unread: bool = True) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    read_keys = {k for k, _p, _l, kind in refs if kind == "read"}
    for key, path, line, _kind in refs:
        if key not in defined:
            diags.append(_d(
                "N203", ERROR,
                f"FLAGS key '{key}' is not defined in "
                "paddle_tpu_torch/flags.py",
                where=f"{os.path.relpath(path, _repo_root())}:{line}",
                hint="defined keys: " + ", ".join(sorted(defined))))
    if warn_unread:
        for key in sorted(defined - read_keys):
            diags.append(_d(
                "N204", WARNING,
                f"FLAGS key '{key}' is defined but never read",
                where="paddle_tpu_torch/flags.py",
                hint="dead configuration surface — wire it up or "
                     "remove it"))
    return diags


# --- instance-keyed gauges (N205) --------------------------------------

def check_versioned_gauge_source(src: str, path: str = "<src>"
                                 ) -> List[Diagnostic]:
    """N205 over one source file: every class attribute assigned a
    gauge with an INTERPOLATED (f-string) name — a per-instance series,
    whether the key is spelled `<model>.v<version>` directly or built
    through a label variable (`f"serving.kv.pages_used{sfx}"`) — must
    have a `self.<attr>.set(0)` zero-at-retirement site in the same
    class, OUTSIDE `__init__` (an init-time zero is initialization, not
    retirement, and would let the clobber class back in)."""
    diags: List[Diagnostic] = []
    tree = _parse(path, src)
    if tree is None:
        return diags
    suppressed = _suppressed_lines(src, "allow-unzeroed")
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        registered: List[Tuple[str, str, int]] = []  # attr, pattern, line
        zeroed: Set[str] = set()
        init_nodes: Set[int] = set()
        # registration and zero site must be in the SAME class: nodes of
        # nested ClassDefs are excluded (a nested class's same-named
        # `self._g.set(0)` must not satisfy the outer class's rule)
        nested: Set[int] = set()
        for sub in ast.walk(cls):
            if isinstance(sub, ast.ClassDef) and sub is not cls:
                nested |= {id(x) for x in ast.walk(sub)}
        for meth in cls.body:
            if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and meth.name == "__init__":
                init_nodes = {id(sub) for sub in ast.walk(meth)}
        for node in ast.walk(cls):
            if id(node) in nested:
                continue
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and isinstance(node.targets[0].value, ast.Name) \
                    and node.targets[0].value.id == "self" \
                    and isinstance(node.value, ast.Call):
                fn = node.value.func
                name = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else None)
                if name == "gauge" and node.value.args and \
                        isinstance(node.value.args[0], ast.JoinedStr):
                    pat = _joinedstr_pattern(node.value.args[0])
                    if "*" in pat:  # >=1 interpolated segment
                        # a suppression anywhere on the (possibly
                        # multi-line) registration statement counts
                        span = range(node.lineno,
                                     (node.end_lineno or node.lineno) + 1)
                        if not any(ln in suppressed for ln in span):
                            registered.append(
                                (node.targets[0].attr, pat, node.lineno))
            if isinstance(node, ast.Call) and \
                    id(node) not in init_nodes and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "set" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    node.args[0].value in (0, 0.0):
                base = node.func.value
                if isinstance(base, ast.Attribute) and \
                        isinstance(base.value, ast.Name) and \
                        base.value.id == "self":
                    zeroed.add(base.attr)
        for attr, pat, line in registered:
            if attr in zeroed:
                continue
            diags.append(_d(
                "N205", ERROR,
                f"instance-keyed gauge '{pat}' (self.{attr} in class "
                f"{cls.name}) has no zero-at-retirement site: no "
                f"'self.{attr}.set(0)' outside __init__ anywhere in "
                "the class",
                where=f"{path}:{line}",
                hint="zero the gauge when the owning engine/version "
                     "retires (the hot-swap drain otherwise leaves the "
                     "old version's last value lingering as live "
                     "occupancy — the gauge-clobber bug class); "
                     "or annotate '# lint: allow-unzeroed' if the "
                     "series genuinely lives as long as the process"))
    return diags


def check_versioned_gauges(pkg_dir: str) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for path in _py_files(pkg_dir):
        if _mentions(path, ("gauge",)):
            rel = os.path.relpath(path, _repo_root())
            diags += check_versioned_gauge_source(_read(path), rel)
    return diags


# --- the pass over the port ------------------------------------------

def port_test_files(root: str) -> List[str]:
    """The port's tests and its card script: tests/test_torch_*.py and
    chip_smoke.py."""
    tests = os.path.join(root, "tests")
    out = [os.path.join(tests, n) for n in sorted(os.listdir(tests))
           if n.startswith("test_torch_") and n.endswith(".py")] \
        if os.path.isdir(tests) else []
    smoke = os.path.join(root, "chip_smoke.py")
    return out + ([smoke] if os.path.isfile(smoke) else [])


def check_repo(root: Optional[str] = None) -> List[Diagnostic]:
    root = root or _repo_root()
    pkg = os.path.join(root, "paddle_tpu_torch")
    tests = port_test_files(root)
    diags: List[Diagnostic] = []

    sites = collect_declared_sites(pkg)
    diags += check_fault_sites(sites, collect_used_sites(tests + [pkg]))

    universe = NameUniverse(collect_declared_names(pkg), sites)
    diags += check_names(universe, collect_test_name_refs(tests, universe))

    flags_path = os.path.join(pkg, "flags.py")
    defined = collect_defined_flags(flags_path)
    refs = collect_flag_refs([pkg] + tests)
    # read-through keys ('trace'/'trace_buffer'/'faults') are consumed
    # inside _Flags.__getitem__ via `k == "..."` dispatch, not a
    # subscript — count them as read so N204 doesn't cry wolf
    refs += [(k, flags_path, 0, "read")
             for k in _readthrough_keys(flags_path)]
    diags += check_flags(defined, refs)

    diags += check_versioned_gauges(pkg)
    return diags
