"""The build of the port's CUDA sources, without a compiler: which sources
it lists and when a built library is stale (its source is newer)."""
import os

from repro_torch.kernels import build


def _touch(path, mtime):
    path.write_text("")
    os.utime(path, (mtime, mtime))


def _tree(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    _touch(csrc / "a.cu", 100)
    _touch(csrc / "b.cu", 100)
    return csrc, out


def test_sources_lists_the_cu_files(tmp_path, monkeypatch):
    csrc, _ = _tree(tmp_path, monkeypatch)
    _touch(csrc / "notes.txt", 100)
    assert build.sources() == ["a", "b"]


def test_stale_follows_the_source(tmp_path, monkeypatch):
    csrc, out = _tree(tmp_path, monkeypatch)
    assert build._stale("a")                       # never built
    _touch(out / "liba.so", 200)
    assert not build._stale("a")
    _touch(csrc / "a.cu", 300)                     # source edited
    assert build._stale("a")
    _touch(out / "liba.so", 400)
    assert not build._stale("a")
    assert build._stale("b")                       # each library on its own


def test_build_of_fresh_libraries_runs_no_compiler(tmp_path, monkeypatch):
    _, out = _tree(tmp_path, monkeypatch)
    _touch(out / "liba.so", 200)
    _touch(out / "libb.so", 200)
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(
        AssertionError("nvcc called")))
    assert build.build(["a", "b"]) == []


def test_stale_follows_the_shared_headers(tmp_path, monkeypatch):
    csrc, out = _tree(tmp_path, monkeypatch)
    _touch(csrc / "shared.cuh", 100)
    _touch(out / "liba.so", 200)
    _touch(out / "libb.so", 200)
    assert not build._stale("a") and not build._stale("b")
    _touch(csrc / "shared.cuh", 300)               # a header edited
    assert build._stale("a") and build._stale("b")  # every library it may feed
    _touch(out / "liba.so", 400)
    assert not build._stale("a")
    assert build._stale("b")
    _touch(csrc / "other.cuh", 500)                # any header counts
    assert build._stale("a")
    assert build.sources() == ["a", "b"]           # headers are not sources
