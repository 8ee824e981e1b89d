"""paddle_tpu_torch.analysis — static analysis for the port's
define-then-run stack, the counterpart of ``paddle_tpu.analysis`` with
the same codes (the JAX package's docs/STATIC_ANALYSIS.md is the
catalog).

Four passes and a CLI:

  - `verify` — Program/IR verifier (V0xx): runs between graph
    construction and execution; `FLAGS["verify_programs"]` gates the
    Executor on it, and the memory-optimization transpiler proves its
    rewrites against it. Its V003/V004 re-run each emitter on meta
    tensors.
  - `locks` — concurrency lint (L101–L103): lock-order graph +
    blocking-call-under-lock over the port's runtime directories.
  - `guards` — shared-state race lint (L104–L106): guarded-by
    inference + declarations over the same modules, with a runtime
    sanitizer twin (PADDLE_TPU_SANITIZE=guards, analysis/sanitize.py)
    asserting the declared guards at attribute access.
  - `invariants` — registry drift lint (N2xx): fault sites, metric/span
    names, FLAGS keys (resolved by import, so the JAX package's flags
    in the port's tests are not the port's), per-version gauge
    retirement.

CLI: ``python -m paddle_tpu_torch.analysis [--json] [--selftest]``.
"""
from .diagnostics import (  # noqa: F401
    ERROR, WARNING, AnalysisError, Diagnostic, ProgramVerifyError,
    errors, warnings,
)
from .verify import assert_valid, verify_program  # noqa: F401

__all__ = [
    "ERROR", "WARNING", "AnalysisError", "Diagnostic",
    "ProgramVerifyError", "errors", "warnings",
    "assert_valid", "verify_program",
]
