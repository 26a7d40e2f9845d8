"""The port's kernel build plumbing, on the CPU: content-keyed library
paths, reuse of a built library, and an nvcc run (a stand-in compiler
here, since the real one exists only beside the card)."""

import os
import stat
import sys

import pytest

from edl_tpu_torch.utils import buildlock


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
    assert os.listdir(buildlock.BUILD_DIR) == [".build.lock"]


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
