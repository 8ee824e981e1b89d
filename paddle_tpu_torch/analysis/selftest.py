"""One synthetic bad input per diagnostic code — the JAX package's
``analysis/selftest.py`` cases, built with the port's Program IR.

`CASES` maps every implemented code to a zero-arg callable that builds
the minimal bad Program / source snippet / registry universe, runs the
owning pass, and returns its diagnostics. The CLI's ``--selftest``
asserts each case actually fires its code (a pass whose detector rots
stops being trusted the day it rots, not the day a real bug slips by);
tests/test_torch_analysis.py runs the same registry against the JAX
package's."""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from .diagnostics import Diagnostic


def _mk_program(var_specs, ops):
    """Hand-assemble a Program from raw descs, BYPASSING build-time
    shape inference — exactly how a buggy transpiler or a desc edit
    corrupts a graph.

    var_specs: name -> dict(shape=..., dtype=..., persistable=...)
    ops: (type, inputs, outputs, attrs) tuples appended verbatim."""
    from paddle_tpu_torch.fluid.framework import Operator, Program
    from paddle_tpu_torch.fluid.proto import OpDesc

    prog = Program()
    block = prog.global_block()
    for name, spec in var_specs.items():
        block.create_var(name=name, **spec)
    for (t, ins, outs, attrs) in ops:
        op = Operator.__new__(Operator)
        op.block = block
        op.desc = OpDesc(type=t, inputs=dict(ins or {}),
                         outputs=dict(outs or {}), attrs=dict(attrs or {}))
        block.ops.append(op)
    return prog


def _verify(prog, **kw) -> List[Diagnostic]:
    from .verify import verify_program

    return verify_program(prog, **kw)


# --- verifier cases ----------------------------------------------------

def case_v001():
    # 't' is read by the first op but only produced by the second
    prog = _mk_program(
        {"a": dict(shape=[2], dtype="float32"),
         "t": dict(shape=[2], dtype="float32"),
         "b": dict(shape=[2], dtype="float32")},
        [("relu", {"X": ["t"]}, {"Out": ["b"]}, {}),
         ("relu", {"X": ["a"]}, {"Out": ["t"]}, {})],
    )
    return _verify(prog, check_shapes=False)


def case_v002():
    prog = _mk_program(
        {"a": dict(shape=[2], dtype="float32")},
        [("relu", {"X": ["ghost"]}, {"Out": ["a"]}, {})],
    )
    return _verify(prog, check_shapes=False)


def case_v003():
    # declared output shape contradicts the emitter's abstract eval
    prog = _mk_program(
        {"a": dict(shape=[2, 3], dtype="float32"),
         "b": dict(shape=[9, 9], dtype="float32")},
        [("relu", {"X": ["a"]}, {"Out": ["b"]}, {})],
    )
    return _verify(prog, check_shapes=True)


def case_v004():
    prog = _mk_program(
        {"a": dict(shape=[2, 3], dtype="float32"),
         "b": dict(shape=[2, 3], dtype="int64")},
        [("relu", {"X": ["a"]}, {"Out": ["b"]}, {})],
    )
    return _verify(prog, check_shapes=True)


def case_v005():
    prog = _mk_program(
        {"x@GRAD": dict(shape=[2], dtype="float32")},
        [],
    )
    return _verify(prog, check_shapes=False)


def case_v006():
    # 'dead' is computed and never consumed
    prog = _mk_program(
        {"a": dict(shape=[2], dtype="float32"),
         "dead": dict(shape=[2], dtype="float32")},
        [("relu", {"X": ["a"]}, {"Out": ["dead"]}, {})],
    )
    return _verify(prog, check_shapes=False)


def case_v007():
    prog = _mk_program(
        {"a": dict(shape=[2], dtype="float32"),
         "b": dict(shape=[2], dtype="float32"),
         "t": dict(shape=[2], dtype="float32")},
        [("relu", {"X": ["a"]}, {"Out": ["t"]}, {}),
         ("relu", {"X": ["b"]}, {"Out": ["t"]}, {}),
         ("relu", {"X": ["t"]}, {"Out": ["a"]}, {})],
    )
    return _verify(prog, check_shapes=False)


def case_v008():
    prog = _mk_program(
        {"c": dict(shape=[1], dtype="bool")},
        [("conditional_block", {"Cond": ["c"]}, {},
          {"sub_block": 99})],
    )
    return _verify(prog, check_shapes=False)


def case_v009():
    prog = _mk_program(
        {"a": dict(shape=[2], dtype="float32")},
        [("totally_bogus_op", {"X": ["a"]}, {"Out": ["a"]}, {})],
    )
    return _verify(prog, check_shapes=False)


def case_v010():
    # synthetic reuse log: 'buf' is merged into at op 0 while its
    # storage is still used at op 2
    from paddle_tpu_torch.fluid.memory_optimization_transpiler import (
        ControlFlowGraph,
    )
    from .verify import check_reuse_events

    prog = _mk_program(
        {"a": dict(shape=[2], dtype="float32"),
         "buf": dict(shape=[2], dtype="float32"),
         "out": dict(shape=[2], dtype="float32"),
         "z": dict(shape=[2], dtype="float32")},
        [("relu", {"X": ["a"]}, {"Out": ["out"]}, {}),
         ("relu", {"X": ["buf"]}, {"Out": ["z"]}, {}),
         ("relu", {"X": ["buf"]}, {"Out": ["z"]}, {})],
    )
    cfg = ControlFlowGraph(prog.global_block())
    return check_reuse_events(cfg, [(0, "out", "buf")])


# --- concurrency-lint cases -------------------------------------------

_L101_SRC = '''
import threading

class S:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def one(self):
        with self._a:
            with self._b:
                pass

    def two(self):
        with self._b:
            with self._a:
                pass
'''

_L102_SRC = '''
import threading

class S:
    def __init__(self, sock):
        self._mu = threading.Lock()
        self._sock = sock

    def pull(self):
        with self._mu:
            return self._sock.recv(4096)
'''

_L103_SRC = '''
import threading

class S:
    def __init__(self):
        self._mu = threading.Lock()

    def outer(self):
        with self._mu:
            self.inner()

    def inner(self):
        with self._mu:
            pass
'''


def case_l101():
    from .locks import lint_source

    return lint_source(_L101_SRC, "snippet_l101.py")


def case_l102():
    from .locks import lint_source

    return lint_source(_L102_SRC, "snippet_l102.py")


def case_l103():
    from .locks import lint_source

    return lint_source(_L103_SRC, "snippet_l103.py")


# --- guards-lint cases --------------------------------------------------

# a thread-entry (Thread target) and a public method share _n; one
# access (the scheduler's write) skips the majority guard
_L104_SRC = '''
import threading

class S:
    def __init__(self):
        self._mu = threading.Lock()
        self._n = 0
        self._t = threading.Thread(target=self._loop)

    def read(self):
        with self._mu:
            return self._n

    def bump(self):
        with self._mu:
            self._n += 1

    def _loop(self):
        self._n = 0
'''

# declared guard: every unguarded access fires even without a majority
_L104_DECL_SRC = '''
import threading

class S:
    def __init__(self):
        self._mu = threading.Lock()
        self._q = []  # guarded-by: _mu

    def put(self, x):
        self._q.append(x)
'''

_L105_SRC = '''
import threading

class S:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self._n = 0

    def one(self):
        with self._a:
            self._n += 1

    def two(self):
        with self._b:
            self._n += 1
'''

# the double-answer shape: a guarded read, the lock released,
# and the dependent write re-acquiring it
_L106_SRC = '''
import threading

class S:
    def __init__(self):
        self._mu = threading.Lock()
        self._n = 0  # guarded-by: _mu

    def bump(self):
        with self._mu:
            seen = self._n
        with self._mu:
            self._n = seen + 1
'''


def case_l104():
    from .guards import lint_source

    diags = lint_source(_L104_SRC, "snippet_l104.py")
    # the declared-guard form must fire too — inference and declaration
    # are both load-bearing, so the case covers both or fails
    diags += lint_source(_L104_DECL_SRC, "snippet_l104_decl.py")
    if sum(1 for d in diags if d.code == "L104") < 2:
        raise AssertionError(
            "L104 must fire for BOTH the inferred and the declared "
            f"guard: {[d.format() for d in diags]}")
    return diags


def case_l105():
    from .guards import lint_source

    return lint_source(_L105_SRC, "snippet_l105.py")


def case_l106():
    from .guards import lint_source

    return lint_source(_L106_SRC, "snippet_l106.py")


# --- invariant-lint cases ---------------------------------------------

def case_n201():
    from .invariants import check_fault_sites

    # exact names plus f-string wildcard FAMILIES — `serving.*` is the
    # real one serving/server.py declares via `fire(f"serving.{method}")`
    declared = ({"connect", "master.snapshot"},
                {"recv.*", "send.*", "serving.*"})
    used = [("nope.bogus_site", "snippet.py", 1, False),
            ("serving.infer", "snippet.py", 2, False)]
    diags = check_fault_sites(declared, used)
    # the family must CLAIM serving.infer: a second, spurious N201 here
    # means wildcard matching rotted — crash the case so it fails
    if any("serving.infer" in d.message for d in diags):
        raise AssertionError(
            "wildcard site family 'serving.*' did not match "
            "'serving.infer'")
    return diags


def case_n202():
    from .invariants import NameUniverse, check_names

    universe = NameUniverse(({"rpc.client.retries"}, {"rpc.server.*.ms"}),
                            (set(), set()))
    refs = [("rpc.client.bogus_metric", "snippet.py", 1, False)]
    return check_names(universe, refs)


def case_n203():
    from .invariants import check_flags

    defined = {"benchmark", "trace"}
    refs = [("not_a_flag", "snippet.py", 1, "read")]
    return check_flags(defined, refs, warn_unread=False)


def case_n204():
    from .invariants import check_flags

    defined = {"benchmark", "never_read_flag"}
    refs = [("benchmark", "snippet.py", 1, "read")]
    return check_flags(defined, refs, warn_unread=True)


def case_n205():
    from .invariants import check_versioned_gauge_source

    # a per-<model>.v<version> gauge with no .set(0) retirement site —
    # the hot-swap gauge-clobber shape, mechanized
    src = '''
class Engine:
    def __init__(self, name, version):
        self._g_depth = _metrics.gauge(
            f"serving.queue_depth.{name}.v{version}")
        self._g_ok = _metrics.gauge(f"serving.live.{name}.v{version}")

    def stop(self):
        self._g_ok.set(0)
'''
    diags = check_versioned_gauge_source(src, "snippet_n205.py")
    # the zeroed gauge must NOT fire: a spurious hit here means the
    # zero-site matcher rotted — crash the case so it fails
    if any("_g_ok" in d.message for d in diags):
        raise AssertionError(
            "N205 fired on a gauge that HAS a .set(0) site")
    return diags


CASES: Dict[str, Callable[[], List[Diagnostic]]] = {
    "V001": case_v001,
    "V002": case_v002,
    "V003": case_v003,
    "V004": case_v004,
    "V005": case_v005,
    "V006": case_v006,
    "V007": case_v007,
    "V008": case_v008,
    "V009": case_v009,
    "V010": case_v010,
    "L101": case_l101,
    "L102": case_l102,
    "L103": case_l103,
    "L104": case_l104,
    "L105": case_l105,
    "L106": case_l106,
    "N201": case_n201,
    "N202": case_n202,
    "N203": case_n203,
    "N204": case_n204,
    "N205": case_n205,
}


def run_selftest() -> List[Tuple[str, bool, List[Diagnostic]]]:
    """(code, fired, diagnostics) per case. A case passes iff its own
    code appears in the diagnostics its bad input produces."""
    results = []
    for code, fn in sorted(CASES.items()):
        try:
            diags = fn()
            fired = any(d.code == code for d in diags)
        except Exception as e:  # a crashing detector is a failing case
            diags = [Diagnostic(code=code, severity="error",
                                message=f"selftest case crashed: "
                                        f"{type(e).__name__}: {e}")]
            fired = False
        results.append((code, fired, diags))
    return results
