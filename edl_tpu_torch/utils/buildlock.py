"""Serialized, content-keyed nvcc builds of the port's CUDA kernels.

Each kernel source under ``ops/csrc`` compiles with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library's file name carries a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused. An exclusive
flock on the build directory's lockfile serializes concurrent builders
(processes of one host starting together): the losers find the library
already there. Nothing builds at import time; callers build on first
use.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

from edl_tpu_torch.utils.logger import logger

#: where built libraries go (listed in .gitignore)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ops", "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels build with "
                       "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")


def library_path(source, build_dir=None):
    """The content-keyed path of ``source``'s built library in
    ``build_dir`` (default ``BUILD_DIR``)."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(build_dir or BUILD_DIR, "lib%s_%s.so" % (
        name, digest.hexdigest()[:16]))


def build(source, build_dir=None):
    """Compile ``source`` into ``build_dir`` (default ``BUILD_DIR``)
    unless its library exists; returns ``(path, seconds, log)`` where
    ``log`` is nvcc's output (ptxas register and shared-memory report)
    or "" when nothing was built."""
    build_dir = build_dir or BUILD_DIR
    out = library_path(source, build_dir)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return out, 0.0, ""
            t0 = time.monotonic()
            tmp = out + ".%d.tmp" % os.getpid()
            result = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                capture_output=True, text=True)
            if result.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise RuntimeError("nvcc failed for %s:\n%s%s" % (
                    source, result.stdout, result.stderr))
            os.replace(tmp, out)  # a reader never sees a half-written .so
            seconds = time.monotonic() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    logger.info("built %s in %.1fs", out, seconds)
    return out, seconds, result.stdout + result.stderr


def load(source, build_dir=None):
    """Build ``source`` if needed and return its ``ctypes.CDLL``."""
    return ctypes.CDLL(build(source, build_dir)[0])
