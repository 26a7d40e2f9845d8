"""Dapper-style trace-context propagation for the RPC substrate.

A **span** is one timed operation; spans in one causal chain share a
``trace_id`` and link parent→child through ``parent_id``. The RPC
client stamps its active context into the request envelope as
``"tr": [trace_id, span_id]`` (only after the peer advertised the
``obs.trace`` feature — a legacy peer never sees the key and nothing
about the frame changes: byte-compatible fallback). The server adopts
the header as the parent of its dispatch span and re-activates the
context around the handler, so a nested RPC issued inside the handler
carries the SAME trace onward: client → server → nested-RPC across
processes, one ``trace_id`` end to end.

Recording is bounded and pull-based: finished spans land in a ring
buffer (:data:`TRACER`, default 4096 spans) and are exported on demand
— :meth:`Tracer.chrome_trace` emits ``chrome://tracing`` /
Perfetto-loadable JSON. Nothing is written anywhere at runtime.

Cost model: with tracing disabled and no propagated context (the
default), ``begin_span`` is one attr load + two falsy checks →
``None``; every downstream call no-ops on ``span is None``. Tracing
turns on per-process via ``EDL_TPU_TRACE=1`` or ``TRACER.enable()``;
a propagated remote context is honored even when local sampling is
off, so one traced client lights up the whole call tree.
"""

import contextlib
import os
import random
import threading
import time
from collections import deque

_tls = threading.local()

#: env switch for root sampling (child spans of a propagated context
#: are always recorded — the caller already paid for the trace)
TRACE_ENV = "EDL_TPU_TRACE"


def _new_id():
    return "%016x" % random.getrandbits(64)


class Span(object):
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "ts", "_t0", "dur_ms", "tags", "pid")

    def __init__(self, trace_id, span_id, parent_id, name, kind, tags):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind            # "client" | "server" | "local"
        self.ts = time.time()
        self._t0 = time.monotonic()
        self.dur_ms = None
        self.tags = tags
        self.pid = os.getpid()

    def to_dict(self):
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "kind": self.kind, "ts": self.ts, "dur_ms": self.dur_ms,
                "tags": self.tags or {}, "pid": self.pid}


class Tracer(object):
    """Span factory + bounded ring of finished spans."""

    def __init__(self, capacity=4096):
        self._lock = threading.Lock()
        self._ring = deque(maxlen=int(capacity))
        self._enabled = os.environ.get(TRACE_ENV, "") == "1"

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    @property
    def enabled(self):
        return self._enabled

    def clear(self):
        with self._lock:
            self._ring.clear()

    def spans(self):
        """Finished spans, oldest first (dict copies)."""
        with self._lock:
            return [s.to_dict() for s in self._ring]

    def find(self, **match):
        """Finished spans whose fields equal every ``match`` item."""
        return [s for s in self.spans()
                if all(s.get(k) == v for k, v in match.items())]

    def _record(self, span):
        with self._lock:
            self._ring.append(span)

    def chrome_trace(self):
        """``chrome://tracing`` / Perfetto JSON: complete ("X") events,
        one row per pid, span ids threaded through args for hand-tracing
        a chain across processes."""
        events = []
        for s in self.spans():
            events.append({
                "name": s["name"], "ph": "X", "cat": s["kind"],
                "ts": s["ts"] * 1e6, "dur": (s["dur_ms"] or 0.0) * 1e3,
                "pid": s["pid"], "tid": 0,
                "args": {"trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"],
                         **(s["tags"] or {})}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


#: THE process tracer
TRACER = Tracer()


def current():
    """The active ``(trace_id, span_id)`` context of this thread, or
    None. This is exactly what :func:`inject` stamps on the wire."""
    return getattr(_tls, "ctx", None)


def _set_ctx(ctx):
    _tls.ctx = ctx


def inject():
    """Wire header for the active context (``[trace_id, span_id]``) or
    None when this thread isn't inside a trace."""
    ctx = getattr(_tls, "ctx", None)
    return [ctx[0], ctx[1]] if ctx is not None else None


def begin_span(name, kind="local", parent=None, root=False, tags=None):
    """Open a span, or return None when nothing is tracing.

    A span is created iff one of: ``parent`` (a remote ``[trace_id,
    span_id]`` header) is given; this thread has an active context;
    ``root=True``/sampling is enabled (starts a fresh trace). The
    caller must pass the result to :func:`end_span` (None is fine).
    """
    ctx = getattr(_tls, "ctx", None)
    if parent is None and ctx is None and not (root or TRACER._enabled):
        return None
    if parent is not None:
        try:
            trace_id, parent_id = str(parent[0]), str(parent[1])
        except (TypeError, IndexError, KeyError):
            return None  # malformed header: trace nothing, serve normally
    elif ctx is not None:
        trace_id, parent_id = ctx
    else:
        trace_id, parent_id = _new_id() + _new_id(), None
    return Span(trace_id, _new_id(), parent_id, name, kind, tags)


def end_span(span, **extra_tags):
    """Close + record ``span`` (no-op for None; idempotent — error
    unwinding may race a resolve path that already closed it)."""
    if span is None or span.dur_ms is not None:
        return
    span.dur_ms = (time.monotonic() - span._t0) * 1e3
    if extra_tags:
        span.tags = dict(span.tags or {}, **extra_tags)
    TRACER._record(span)


@contextlib.contextmanager
def span(name, kind="local", root=False, **tags):
    """Span context manager; activates the span as this thread's
    context so nested spans / outbound RPCs chain under it."""
    sp = begin_span(name, kind=kind, root=root, tags=tags or None)
    if sp is None:
        yield None
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (sp.trace_id, sp.span_id)
    try:
        yield sp
    finally:
        _tls.ctx = prev
        end_span(sp)


@contextlib.contextmanager
def server_span(name, header, **tags):
    """Dispatch-side span adopting a remote ``[trace_id, span_id]``
    header as parent (None header → plain :func:`span` semantics, which
    usually means "no span at all"). Activates the context for the
    handler's duration so nested client calls propagate the trace."""
    sp = begin_span(name, kind="server", parent=header, tags=tags or None)
    if sp is None:
        yield None
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (sp.trace_id, sp.span_id)
    try:
        yield sp
    finally:
        _tls.ctx = prev
        end_span(sp)
