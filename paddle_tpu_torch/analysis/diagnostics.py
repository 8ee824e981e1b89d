"""Shared diagnostic model for the port's static-analysis passes — a
copy of ``paddle_tpu/analysis/diagnostics.py``.

Every pass (verify / locks / invariants) reports `Diagnostic` records —
a stable CODE, a severity, a human message, a location, and a fix hint —
so the CLI, the executor's pre-run hook, and tests all consume
one shape. Codes are namespaced by pass:

    Vxxx  program verifier        (analysis/verify.py)
    Lxxx  concurrency lint        (analysis/locks.py)
    Nxxx  invariant lint          (analysis/invariants.py)

The codes are the JAX package's (its docs/STATIC_ANALYSIS.md is the
catalog); the CLI's ``--selftest`` proves every code still fires on a
synthetic bad input.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass
class Diagnostic:
    code: str           # e.g. "V001"
    severity: str       # ERROR | WARNING
    message: str
    where: str = ""     # "block 0 / op 3 (mul)" or "file.py:42"
    hint: str = ""
    pass_name: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def key(self):
        """Identity for before/after comparisons (the transpiler gate)."""
        return (self.code, self.where, self.message)

    def format(self) -> str:
        sev = self.severity.upper()
        loc = f" [{self.where}]" if self.where else ""
        hint = f" (hint: {self.hint})" if self.hint else ""
        return f"{sev} {self.code}{loc}: {self.message}{hint}"


def errors(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def warnings(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == WARNING]


class AnalysisError(RuntimeError):
    """Raised when a gate (executor pre-run hook, transpiler rewrite
    check) refuses to proceed over error-level diagnostics. Carries the
    diagnostics so callers/tests can assert on codes."""

    def __init__(self, header: str, diags: List[Diagnostic]):
        self.diagnostics = list(diags)
        lines = [header] + ["  " + d.format() for d in self.diagnostics]
        super().__init__("\n".join(lines))


# Backwards-friendly alias: the verifier's gate raises this name.
ProgramVerifyError = AnalysisError
