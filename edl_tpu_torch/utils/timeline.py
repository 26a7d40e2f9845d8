"""Env-gated stopwatch profiling + torch.profiler trace helper.

Reference parity: edl/distill/timeline.py:20-46 — a Nop/Real stopwatch pair
switched by an env var, recording per-pid op latencies to stderr. Here the
stopwatch is backed by the unified metrics registry (``edl_timeline_op_ms``
histogram, labeled by op) so timeline spans land on the same fleet
snapshot as every other metric; EDL_TPU_PROFILE=1 (or the reference's
DISTILL_READER_PROFILE=1) additionally keeps the legacy stderr line sink.
torch_trace() adds the device path: a torch.profiler trace context
(the CUDA device too, where there is one) writing a chrome trace.

The environment is read ONCE, at first :func:`get_timeline` call; the
instance is cached per process (hot loops used to re-read os.environ on
every construction). Tests that flip the env call :func:`reset`.
"""

import contextlib
import os
import sys
import time

from edl_tpu_torch.obs import metrics as obs_metrics

_OP_MS = obs_metrics.histogram(
    "edl_timeline_op_ms", "env-gated stopwatch span latencies",
    labels=("op",))

_cached = None


class TimeLine(object):
    """Registry-backed stopwatch. ``verbose`` adds the legacy
    ``[timeline] pid= op= ms=`` stderr lines (the profile-env sink)."""

    def __init__(self, verbose=False, out=None):
        self._pid = os.getpid()
        self._last = time.monotonic()
        self._verbose = verbose
        self._out = out or sys.stderr

    def _emit(self, op, ms):
        _OP_MS.labels(op).observe(ms)
        if self._verbose:
            self._out.write("[timeline] pid=%d op=%s ms=%.3f\n"
                            % (self._pid, op, ms))

    def record(self, op):
        """Lap timer: time since the previous record()."""
        now = time.monotonic()
        self._emit(op, (now - self._last) * 1000)
        self._last = now

    @contextlib.contextmanager
    def span(self, op):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._emit(op, (time.monotonic() - t0) * 1000)


# legacy aliases: pre-registry callers constructed these directly
_RealTimeLine = TimeLine


class _NopTimeLine(TimeLine):
    """Kept for API compatibility; records to the registry like every
    timeline now (near-zero cost, and EDL_TPU_OBS=0 disables it), just
    never to stderr."""


def enabled():
    return (os.environ.get("EDL_TPU_PROFILE") == "1"
            or os.environ.get("DISTILL_READER_PROFILE") == "1")


def get_timeline(out=None):
    """The process's shared timeline (env read once, instance cached).
    Passing ``out`` bypasses the cache — explicit sinks are for tests."""
    global _cached
    if out is not None:
        return TimeLine(verbose=True, out=out)
    if _cached is None:
        _cached = TimeLine(verbose=True) if enabled() else _NopTimeLine()
    return _cached


def reset():
    """Drop the cached timeline so the next get_timeline() re-reads the
    environment (test hook)."""
    global _cached
    _cached = None


@contextlib.contextmanager
def torch_trace(logdir=None):
    """torch.profiler trace context, active iff EDL_TPU_PROFILE_DIR (or
    the ``logdir`` arg) is set — the replacement for the reference's
    Paddle profiler window (train_with_fleet.py:521-530). On exit it
    writes ``trace_<pid>.json`` (chrome-trace JSON, Perfetto-readable)
    into ``logdir``."""
    logdir = logdir or os.environ.get("EDL_TPU_PROFILE_DIR")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, "trace_%d.json" % os.getpid()))
