"""The port's guard sanitizer (``paddle_tpu_torch.analysis.sanitize``)
on the CPU: PADDLE_TPU_SANITIZE=guards turns the ``# guarded-by``
declarations of the port's runtime classes into runtime assertions.

  - the shim itself: a declared-guard access without the lock raises
    GuardViolation (and is recorded), a statically vetted lock-free
    access does not, and ``uninstall()`` restores the class;
  - the registered classes are the JAX package's twenty counterparts
    plus the port's ``Lockstep``, and each carries declarations;
  - a port ``DecodeEngine`` serving seeded requests with every declared
    guard asserted gives tokens bitwise equal to the unsanitized
    engine's (and to the JAX engine's), with no violation; reading a
    guarded attribute of it without its lock trips;
  - ``PADDLE_TPU_SANITIZE=guards`` installs it when the package is
    imported.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from paddle_tpu_torch.analysis import sanitize
from paddle_tpu_torch.flags import FLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            seed=11)
ENGINE = dict(slots=[1, 2, 4], page_size=4, num_pages=64, max_seq_len=40,
              prefill_chunk=4)


@pytest.fixture
def guard_sanitizer(monkeypatch):
    """Install the sanitizer as PADDLE_TPU_SANITIZE=guards would at
    import, and restore the classes afterwards."""
    monkeypatch.setitem(FLAGS, "sanitize", "guards")
    assert sanitize.enabled()
    installed = sanitize.install()
    sanitize.clear_violations()
    try:
        yield installed
    finally:
        sanitize.uninstall()
        sanitize.clear_violations()


class _Toy:
    """Minimal annotated class — declarations parse from THIS file."""

    def __init__(self):
        self._mu = threading.Lock()
        self._n = 0  # guarded-by: _mu

    def good(self):
        with self._mu:
            self._n += 1
            return self._n

    def bad_read(self):
        return self._n

    def bad_write(self):
        self._n = 99

    def vetted_read(self):
        # deliberate lock-free read, statically vetted — the sanitizer
        # honours the same vet the guards lint does
        return self._n  # lint: allow-unguarded(_n)


def test_sanitizer_trips_on_unguarded_access_and_uninstalls():
    orig = (_Toy.__init__, _Toy.__getattribute__, _Toy.__setattr__)
    assert sanitize.install_class(_Toy)
    try:
        t = _Toy()
        assert t.good() == 1
        with pytest.raises(sanitize.GuardViolation, match="_n read"):
            t.bad_read()
        with pytest.raises(sanitize.GuardViolation, match="_n written"):
            t.bad_write()
        assert len(sanitize.violations()) == 2
        assert "_Toy._n" in sanitize.violations()[0]
        assert "'_mu'" in sanitize.violations()[0]
        assert t.vetted_read() == 1
        assert len(sanitize.violations()) == 2
    finally:
        sanitize.uninstall_class(_Toy)
        sanitize.clear_violations()
    assert (_Toy.__init__, _Toy.__getattribute__, _Toy.__setattr__) == orig
    assert _Toy().bad_read() == 0


def test_registered_classes_are_the_jax_twenty_and_lockstep(
        guard_sanitizer):
    from paddle_tpu.analysis import sanitize as jsan

    jax_names = {(m.replace("paddle_tpu.", "paddle_tpu_torch.", 1), c)
                 for m, c in jsan._RUNTIME_CLASSES}
    port = set(sanitize._RUNTIME_CLASSES)
    assert port - jax_names == {("paddle_tpu_torch.serving.lockstep",
                                 "Lockstep")}
    assert jax_names <= port
    # every registered class carries declarations, so every one patched
    assert set(guard_sanitizer) == {f"{m}.{c}" for m, c in port}


def _serve(mod, prompts, **extra):
    eng = mod.DecodeEngine(mod.DecoderSpec(**SPEC), name="san", **ENGINE,
                           **extra)
    try:
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        for r in reqs:
            assert r.ev.wait(120)
            if r.error is not None:
                raise r.error
        return [r.result["tokens"] for r in reqs]
    finally:
        eng.stop()


def _prompts():
    rng = np.random.RandomState(5)
    return [[int(t) for t in rng.randint(0, SPEC["vocab"], size=n)]
            for n in (3, 9, 14, 6, 11)]


def test_sanitized_decode_engine_tokens_bitwise_plain_and_jax(
        guard_sanitizer):
    from paddle_tpu.serving import decode as jd
    from paddle_tpu_torch.serving import decode as td

    prompts = _prompts()
    sanitized = _serve(td, prompts, device="cpu")
    assert sanitize.violations() == []
    sanitize.uninstall()
    plain = _serve(td, prompts, device="cpu")
    want = _serve(jd, prompts, warm=False)
    assert sanitized == plain == want


def test_unguarded_read_of_a_live_engine_trips(guard_sanitizer):
    from paddle_tpu_torch.serving import decode as td

    eng = td.DecodeEngine(td.DecoderSpec(**SPEC), name="san", **ENGINE,
                          device="cpu")
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=4)
        for _ in range(10):
            eng.stats()  # the guarded scrape path stays clean
        assert req.ev.wait(120) and req.error is None
        assert sanitize.violations() == []
        with pytest.raises(sanitize.GuardViolation, match="_queue read"):
            len(eng._queue)
        assert len(sanitize.violations()) == 1
        sanitize.clear_violations()
    finally:
        eng.stop()
    assert sanitize.violations() == []


def test_env_installs_the_sanitizer_at_package_import():
    code = ("import paddle_tpu_torch, sys\n"
            "from paddle_tpu_torch.analysis import sanitize\n"
            "print(len(sanitize._installed), len(sanitize._RUNTIME_CLASSES),"
            " sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('paddle_tpu.')))\n")
    env = dict(os.environ, PADDLE_TPU_SANITIZE="guards")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["21", "21", "[]"]
    env.pop("PADDLE_TPU_SANITIZE")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "21", "[]"]
