"""The kernel build's cache key (paddle_tpu_torch/kernels/_build.py), on
the CPU: a library's file name carries a digest of its source and of
every shared header in csrc/, so an edited header never loads a stale
build. Nothing is compiled here."""
from paddle_tpu_torch.kernels import _build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "h.cuh"\n')
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "h.cuh").write_text("// helpers\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return csrc


def test_library_name_follows_source_and_headers(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    assert _build.kernel_sources() == ["a", "b"]
    first = {n: _build._lib_path(n) for n in ("a", "b")}
    assert first["a"] != first["b"]
    assert first == {n: _build._lib_path(n) for n in ("a", "b")}
    (csrc / "h.cuh").write_text("// helpers, edited\n")
    edited = {n: _build._lib_path(n) for n in ("a", "b")}
    assert all(edited[n] != first[n] for n in edited)
    (csrc / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._lib_path("a") != edited["a"]
    assert _build._lib_path("b") == edited["b"]


def test_a_new_header_changes_every_name(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build._lib_path("b")
    (csrc / "g.cuh").write_text("// more helpers\n")
    assert _build._lib_path("b") != before
    assert _build._lib_path("b").startswith(str(tmp_path / "_build"))
