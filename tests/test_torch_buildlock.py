"""The port's kernel build plumbing, on the CPU: content-keyed library
paths (source, included headers, flags), reuse of a built library, a
lock per library, and an nvcc run (a stand-in compiler here, since the
real one exists only beside the card)."""

import os
import stat
import sys

import pytest
import torch

from edl_tpu_torch.utils import buildlock

from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture()
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(buildlock, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path


def _source(path, text):
    path.write_text(text)
    return str(path)


def test_library_path_is_keyed_by_content(build_dir):
    src = _source(build_dir / "k.cu", "// one\n")
    first = buildlock.library_path(src)
    assert os.path.basename(first).startswith("libk_")
    assert buildlock.library_path(src) == first
    _source(build_dir / "k.cu", "// two\n")
    assert buildlock.library_path(src) != first


def test_library_path_covers_included_headers(build_dir):
    """An edit to a header that the source includes (directly or through
    another header) rebuilds; a header it does not include does not."""
    src = _source(build_dir / "k.cu", '#include "a.cuh"\n#include <x.h>\n')
    _source(build_dir / "a.cuh", '#include "b.cuh"\n')
    _source(build_dir / "b.cuh", "// b one\n")
    _source(build_dir / "other.cuh", "// other one\n")
    first = buildlock.library_path(src)
    _source(build_dir / "other.cuh", "// other two\n")
    assert buildlock.library_path(src) == first
    _source(build_dir / "b.cuh", "// b two\n")
    second = buildlock.library_path(src)
    assert second != first
    _source(build_dir / "a.cuh", '#include "b.cuh"\n// a edited\n')
    assert buildlock.library_path(src) not in (first, second)


def test_library_path_covers_nvcc_flags(build_dir, monkeypatch):
    src = _source(build_dir / "k.cu", "// kernel\n")
    first = buildlock.library_path(src)
    monkeypatch.setattr(buildlock, "NVCC_FLAGS",
                        buildlock.NVCC_FLAGS + ("-lineinfo",))
    assert buildlock.library_path(src) != first


def test_build_runs_nvcc_once_then_reuses(build_dir, monkeypatch):
    calls = build_dir / "calls"
    fake = build_dir / "nvcc"
    fake.write_text(
        "#!%s\nimport sys\nout = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\nopen(%r, 'a').write('x')\n"
        "print('ptxas info    : Used 42 registers')\n"
        % (sys.executable, str(calls)))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(buildlock, "_nvcc", lambda: str(fake))
    src = _source(build_dir / "k.cu", "// kernel\n")
    path, secs, log = buildlock.build(src)
    assert path == buildlock.library_path(src) and os.path.exists(path)
    assert "Used 42 registers" in log and secs >= 0.0
    assert not [f for f in os.listdir(buildlock.BUILD_DIR)
                if f.endswith(".tmp")]
    assert buildlock.build(src) == (path, 0.0, "")
    assert calls.read_text() == "x"  # the second call built nothing


def test_build_reports_compiler_errors(build_dir, monkeypatch):
    fake = build_dir / "nvcc"
    fake.write_text(
        "#!%s\nimport sys\nout = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('partial')\n"
        "print('error: bad kernel', file=sys.stderr)\nsys.exit(1)\n"
        % sys.executable)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(buildlock, "_nvcc", lambda: str(fake))
    src = _source(build_dir / "k.cu", "// kernel\n")
    with pytest.raises(RuntimeError, match="bad kernel"):
        buildlock.build(src)
    assert not os.path.exists(buildlock.library_path(src))
    assert os.listdir(buildlock.BUILD_DIR) == [".k.lock"]


def test_build_into_another_directory(build_dir, monkeypatch):
    fake = build_dir / "nvcc"
    fake.write_text(
        "#!%s\nimport sys\nout = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n" % sys.executable)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(buildlock, "_nvcc", lambda: str(fake))
    src = _source(build_dir / "k.cu", "// kernel\n")
    other = str(build_dir / "other")
    path, _, _ = buildlock.build(src, other)
    assert path == buildlock.library_path(src, other)
    assert os.path.dirname(path) == other and os.path.exists(path)
    assert not os.path.exists(buildlock.BUILD_DIR)


def test_each_library_builds_under_its_own_lock(build_dir, monkeypatch):
    """Two sources take two lockfiles, so their nvcc runs can overlap."""
    fake = build_dir / "nvcc"
    fake.write_text(
        "#!%s\nimport sys\nout = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n" % sys.executable)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(buildlock, "_nvcc", lambda: str(fake))
    paths = [buildlock.build(_source(build_dir / name, "// %s\n" % name))[0]
             for name in ("a.cu", "b.cu")]
    assert all(os.path.exists(p) for p in paths)
    assert sorted(f for f in os.listdir(buildlock.BUILD_DIR)
                  if f.endswith(".lock")) == [".a.lock", ".b.lock"]
