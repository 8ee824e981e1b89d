"""The port's source lints on the CPU (``paddle_tpu_torch.analysis``
``locks``, ``guards`` and ``invariants`` against the JAX package's):

  - each lint of a selftest source gives the JAX package's diagnostics;
  - the port's lints over its seven runtime directories, and its
    ``check_repo`` over its package, its tests and ``chip_smoke.py``,
    report no error;
  - FLAGS reads and writes resolve by import: a test-shaped source that
    writes the JAX package's flags (``JFLAGS[...]``, a ``set_flags``
    bound from ``paddle_tpu``) is clean, the same key written through
    the port's ``set_flags`` fails N203, and the unresolved rule would
    have flagged the port's real tests;
  - ``python -m paddle_tpu_torch.analysis --selftest`` runs every case
    and fires every code, touching no device.
"""
import json
import os
import subprocess
import sys

import pytest

from paddle_tpu.analysis import guards as jguards
from paddle_tpu.analysis import invariants as jinv
from paddle_tpu.analysis import locks as jlocks
from paddle_tpu.analysis import selftest as jselftest
from paddle_tpu_torch.analysis import errors
from paddle_tpu_torch.analysis import guards as tguards
from paddle_tpu_torch.analysis import invariants as tinv
from paddle_tpu_torch.analysis import locks as tlocks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    "L101": (jlocks, tlocks, jselftest._L101_SRC),
    "L102": (jlocks, tlocks, jselftest._L102_SRC),
    "L103": (jlocks, tlocks, jselftest._L103_SRC),
    "L104": (jguards, tguards, jselftest._L104_SRC),
    "L104_decl": (jguards, tguards, jselftest._L104_DECL_SRC),
    "L105": (jguards, tguards, jselftest._L105_SRC),
    "L106": (jguards, tguards, jselftest._L106_SRC),
}


def _rows(diags):
    return [(d.code, d.severity, d.where, d.message) for d in diags]


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_lint_of_each_selftest_source_equals_jax(case):
    jmod, tmod, src = SOURCES[case]
    want = _rows(jmod.lint_source(src, f"snippet_{case}.py"))
    got = _rows(tmod.lint_source(src, f"snippet_{case}.py"))
    assert got == want and got
    assert case.split("_")[0] in {r[0] for r in got}


def test_port_runtime_lints_report_no_error():
    paths = tlocks.default_lint_paths()
    assert [os.path.relpath(p, REPO) for p in paths] == [
        os.path.join("paddle_tpu_torch", d) for d in (
            "distributed", "observability", "serving", "autotune", "fleet",
            "checkpoint", "mesh")]
    assert tguards.default_lint_paths() == paths
    locks = tlocks.lint_paths(paths)
    guards = tguards.lint_paths(paths)
    assert not locks, [d.format() for d in locks]
    assert not guards, [d.format() for d in guards]
    # the guarded-by surface the sanitizer asserts is present
    decls = {}
    for rel in ("serving/decode.py", "serving/lockstep.py",
                "serving/kv_cache.py", "distributed/rpc.py"):
        with open(os.path.join(REPO, "paddle_tpu_torch", rel)) as f:
            decls.update(tguards.declared_guards(f.read()))
    assert "_cond" in decls["DecodeEngine"].values()
    assert "_cond" in decls["Lockstep"].values()
    assert "_mu" in decls["PageAllocator"].values()
    assert "_mu" in decls["RpcClient"].values()


def test_port_check_repo_reports_no_error():
    diags = tinv.check_repo()
    assert not errors(diags), [d.format() for d in errors(diags)]
    # every FLAGS key of the port is read somewhere (no N204 either)
    assert not diags, [d.format() for d in diags]


_JAX_FLAGS_SRC = '''
from paddle_tpu.fluid.flags import FLAGS as JFLAGS, set_flags
from paddle_tpu_torch.flags import FLAGS as TFLAGS


def test_a():
    saved = JFLAGS["use_pallas_kernels"]
    set_flags({"use_pallas_kernels": True, "flash_min_seq": 0})
    JFLAGS["flash_min_seq"] = 0
    TFLAGS["amp"] = True
    set_flags({"use_pallas_kernels": saved})


def test_b():
    from paddle_tpu_torch.flags import set_flags

    set_flags({"mesh_axes": ""})
'''

_PORT_FLAGS_SRC = '''
from paddle_tpu.fluid.flags import FLAGS as JFLAGS
from paddle_tpu_torch.flags import set_flags


def test_a():
    saved = JFLAGS["use_pallas_kernels"]
    set_flags({"use_pallas_kernels": saved})


def test_b():
    from paddle_tpu.fluid.flags import set_flags

    set_flags({"flash_min_seq": 0})
'''


def _n203(tmp_path, src):
    path = tmp_path / "test_torch_shape.py"
    path.write_text(src)
    defined = tinv.collect_defined_flags(
        os.path.join(REPO, "paddle_tpu_torch", "flags.py"))
    refs = tinv.collect_flag_refs([str(path)])
    diags = tinv.check_flags(defined, refs, warn_unread=False)
    return refs, [(d.code, d.where.rsplit(":", 1)[1], d.message)
                  for d in diags]


def test_flags_resolve_by_import(tmp_path):
    refs, diags = _n203(tmp_path, _JAX_FLAGS_SRC)
    assert diags == []
    assert sorted((k, kind) for k, _, _, kind in refs) == [
        ("amp", "write"), ("mesh_axes", "write")]
    refs, diags = _n203(tmp_path, _PORT_FLAGS_SRC)
    assert diags == [("N203", "8", "FLAGS key 'use_pallas_kernels' is not "
                      "defined in paddle_tpu_torch/flags.py")]


def test_unresolved_rule_would_flag_the_jax_flags_in_port_tests():
    """The JAX package's collector takes every FLAGS/set_flags by name:
    over the port's tests against the port's keys it reports the JAX
    package's flags those tests set; the import-resolved collector
    reports none, with no test edited or annotated."""
    defined = tinv.collect_defined_flags(
        os.path.join(REPO, "paddle_tpu_torch", "flags.py"))
    tests = tinv.port_test_files(REPO)
    naive = jinv.check_flags(defined, jinv.collect_flag_refs(tests),
                             warn_unread=False)
    where = {d.where.split(":")[0] for d in naive}
    assert len(naive) >= 7
    assert {"tests/test_torch_resnet.py", "tests/test_torch_conv_bn_relu.py",
            "tests/test_torch_flash_bf16.py",
            "tests/test_torch_layer_norm_bf16.py"} <= where
    resolved = tinv.check_flags(defined, tinv.collect_flag_refs(tests),
                                warn_unread=False)
    assert resolved == []


def test_cli_selftest_fires_every_code():
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", "--selftest",
         "--json"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout)
    assert doc["ok"] and {r["code"] for r in doc["selftest"]} == \
        set(jselftest.CASES)
    assert all(r["fired"] for r in doc["selftest"])
