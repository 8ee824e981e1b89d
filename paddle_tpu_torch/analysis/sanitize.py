"""Runtime guard sanitizer — the dynamic half of the guards lint, the
JAX package's ``analysis/sanitize.py`` over the port's runtime classes.

``PADDLE_TPU_SANITIZE=guards`` (read through ``FLAGS["sanitize"]``)
instruments the annotated runtime classes so every access to a
``# guarded-by:``-declared attribute asserts, at runtime, that the
declared lock is held. The declarations are parsed from SOURCE by the
same parser the static pass uses (``guards.declared_guards``), so the
static model and the dynamic assertions can never drift — the same
static-claim→runtime-check pairing ``verify_programs`` (executor gate)
and ``memory_optimize`` (liveness-proved rewrites) already use. With
the sanitizer on, every existing concurrency test (serving acceptance,
decode churn, chaos) doubles as a validator of the guard model.

Mechanics:

  - ``install()`` patches each registered class's ``__getattribute__``
    / ``__setattr__`` / ``__init__``; ``uninstall()`` restores the
    originals (tests toggle per-case).
  - Checks arm only AFTER ``__init__`` returns — construction is
    single-threaded, and declarations sit on ``__init__`` assignments
    whose locks may not exist yet.
  - "Held" is best-effort, matching ``threading.Condition._is_owned``:
    locks exposing ``_is_owned`` (RLock, Condition) answer exactly;
    a plain ``Lock`` is probed with a non-blocking acquire, which
    cannot distinguish *this* thread from another holder — the
    sanitizer therefore catches the common bug (access with the lock
    not held at all) and documents the residual blind spot rather than
    pretending to be a full happens-before TSan.
  - A violation raises ``GuardViolation`` (an AssertionError) AND is
    recorded in ``violations()`` — a scheduler thread that swallows
    the raise still leaves evidence a test can assert on.
  - Static ``# lint: allow-unguarded(attr)`` vets on the ACCESS line
    (or a comment block just above it) are honored at runtime too, so
    a deliberately lock-free access the guards lint accepts never
    trips the sanitizer (checked only on the violation path — clean
    accesses never read source).
"""
from __future__ import annotations

import inspect
import sys
import threading
from typing import Dict, List, Tuple

__all__ = ["GuardViolation", "install", "uninstall", "maybe_install",
           "enabled", "violations", "clear_violations", "install_class",
           "uninstall_class"]

# the annotated runtime surface: every class here carries # guarded-by
# declarations that the guards lint checks statically — the JAX
# package's twenty classes, plus the port's lockstep scheduler of
# mesh-sharded decode
_RUNTIME_CLASSES: Tuple[Tuple[str, str], ...] = (
    ("paddle_tpu_torch.serving.decode", "DecodeEngine"),
    ("paddle_tpu_torch.serving.engine", "InferenceEngine"),
    ("paddle_tpu_torch.serving.registry", "ModelRegistry"),
    ("paddle_tpu_torch.serving.kv_cache", "PageAllocator"),
    ("paddle_tpu_torch.serving.kv_cache", "PrefixIndex"),
    ("paddle_tpu_torch.serving.kv_cache", "HostSpillStore"),
    ("paddle_tpu_torch.distributed.rpc", "_DedupCache"),
    ("paddle_tpu_torch.distributed.rpc", "RpcClient"),
    ("paddle_tpu_torch.distributed.param_server", "ParameterServer"),
    ("paddle_tpu_torch.distributed.master", "MasterClient"),
    ("paddle_tpu_torch.autotune.cache", "TuningCache"),
    ("paddle_tpu_torch.autotune.ladder", "ShapeHistogram"),
    ("paddle_tpu_torch.fleet.controller", "FleetController"),
    ("paddle_tpu_torch.fleet.router", "FleetRouter"),
    ("paddle_tpu_torch.fleet.member", "FleetMember"),
    ("paddle_tpu_torch.fleet.policy", "FleetPolicy"),
    ("paddle_tpu_torch.fleet.launcher", "ReplicaLauncher"),
    ("paddle_tpu_torch.fleet.auth", "NonceWindow"),
    ("paddle_tpu_torch.checkpoint.format", "CheckpointWriter"),
    ("paddle_tpu_torch.mesh.observe", "_MeshStats"),
    ("paddle_tpu_torch.serving.lockstep", "Lockstep"),
)

_ARMED_FLAG = "_guard_sanitizer_armed_"

_violations: List[str] = []
_violations_mu = threading.Lock()
_installed: Dict[type, Tuple] = {}


class GuardViolation(AssertionError):
    """A guarded attribute was accessed without its declared lock."""


def enabled() -> bool:
    from ..flags import FLAGS

    return FLAGS["sanitize"] == "guards"


def violations() -> List[str]:
    with _violations_mu:
        return list(_violations)


def clear_violations():
    with _violations_mu:
        _violations.clear()


def _lock_held(lock) -> bool:
    """Best-effort 'is this lock held' (see module docstring)."""
    is_owned = getattr(lock, "_is_owned", None)
    if callable(is_owned):
        try:
            return bool(is_owned())
        except Exception:  # pragma: no cover - exotic lock type
            pass
    acquire = getattr(lock, "acquire", None)
    if callable(acquire):
        if lock.acquire(False):
            lock.release()
            return False
        return True
    return True  # not a lock we can probe: never false-positive


# file -> guards._Directives, for honoring static allow-unguarded vets
# at runtime (only consulted on the violation path — zero cost clean)
_directive_cache: Dict[str, object] = {}


def _site_vetted(attr: str) -> bool:
    """Does the ACCESSING source line carry a
    '# lint: allow-unguarded(attr)' vet? Mirrors the static pass so a
    statically-vetted deliberate lock-free access never trips the
    runtime check. (Line-level only: a def-line vet must be repeated on
    the access line — or in a comment block just above it — to cover
    the runtime side.)"""
    from .guards import _Directives

    f = sys._getframe(1)
    here = __file__
    for _ in range(6):  # skip sanitize.py's own wrapper frames
        if f is None:
            return False
        if f.f_code.co_filename != here:
            break
        f = f.f_back
    if f is None:
        return False
    fname = f.f_code.co_filename
    d = _directive_cache.get(fname)
    if d is None:
        try:
            with open(fname, "r", encoding="utf-8") as fh:
                d = _Directives(fh.read())
        except OSError:
            d = _Directives("")
        _directive_cache[fname] = d
    return d.allows(attr, f.f_lineno)


def _note_violation(cls_name: str, attr: str, guard: str, kind: str):
    msg = (f"guard sanitizer: {cls_name}.{attr} {kind} without its "
           f"declared guard '{guard}' held "
           f"(thread {threading.current_thread().name})")
    with _violations_mu:
        _violations.append(msg)
    raise GuardViolation(msg)


def _declarations(cls) -> Dict[str, str]:
    """attr -> guard-lock attr name, parsed from the class's source by
    the static pass's parser."""
    from .guards import declared_guards

    try:
        src = inspect.getsource(inspect.getmodule(cls))
    except (OSError, TypeError):  # pragma: no cover - frozen/interactive
        return {}
    return declared_guards(src).get(cls.__name__, {})


def install_class(cls) -> bool:
    """Instrument one class in place. Returns True if it carried any
    declarations (and was patched)."""
    if cls in _installed:
        return True
    guarded = _declarations(cls)
    if not guarded:
        return False
    orig_init = cls.__init__
    orig_get = cls.__getattribute__
    orig_set = cls.__setattr__
    cls_name = cls.__name__

    def _check(self, name, kind):
        try:
            armed = _ARMED_FLAG in orig_get(self, "__dict__")
        except AttributeError:  # pragma: no cover - __slots__ classes
            armed = False
        if not armed:
            return
        guard_name = guarded[name]
        try:
            lock = orig_get(self, guard_name)
        except AttributeError:
            # guard not constructed (partial init), or a declaration
            # naming a module-level lock (unreachable through self —
            # the static pass still checks those): nothing to assert
            return
        if not _lock_held(lock) and not _site_vetted(name):
            _note_violation(cls_name, name, guard_name, kind)

    def __init__(self, *args, **kw):
        orig_init(self, *args, **kw)
        # arm via the original setattr: arming must not self-trip
        orig_set(self, _ARMED_FLAG, True)

    def __getattribute__(self, name):
        if name in guarded:
            _check(self, name, "read")
        return orig_get(self, name)

    def __setattr__(self, name, value):
        if name in guarded:
            _check(self, name, "written")
        orig_set(self, name, value)

    _installed[cls] = (orig_init, orig_get, orig_set)
    cls.__init__ = __init__
    cls.__getattribute__ = __getattribute__
    cls.__setattr__ = __setattr__
    return True


def uninstall_class(cls):
    orig = _installed.pop(cls, None)
    if orig is None:
        return
    cls.__init__, cls.__getattribute__, cls.__setattr__ = orig


def install() -> List[str]:
    """Instrument every registered runtime class; returns the list of
    instrumented 'module.Class' names."""
    import importlib

    done = []
    for mod_name, cls_name in _RUNTIME_CLASSES:
        mod = importlib.import_module(mod_name)
        cls = getattr(mod, cls_name)
        if install_class(cls):
            done.append(f"{mod_name}.{cls_name}")
    return done


def uninstall():
    for cls in list(_installed):
        uninstall_class(cls)


def maybe_install() -> bool:
    """The process-start hook (paddle_tpu_torch/__init__): instrument iff
    FLAGS['sanitize'] (env PADDLE_TPU_SANITIZE) says 'guards'."""
    if not enabled():
        return False
    install()
    return True
