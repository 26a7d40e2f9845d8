"""Crash flight recorder: the observability plane's black box.

The trace ring and event ring are in-memory — a pod killed by chaos,
preemption, or a live-resize rollback evaporates exactly the evidence
the doctor needs (the Dapper lesson inverted: the most valuable traces
are the ones from requests that died). :class:`FlightRecorder` fixes
that: on SIGTERM, unhandled exception, live-resize rollback, or
launcher-observed child death, :meth:`FlightRecorder.dump` writes one
bounded ``blackbox/v1`` artifact — tail of the event ring (cause
chains intact), recent trace spans, a final metrics snapshot, the
ledger totals, the last ``_resize_timing`` record, and all-thread
tracebacks via :mod:`faulthandler` — to local disk and, best-effort,
to the coordination store, where ``job_doctor --postmortem`` renders
it into the ordinary causal-evidence-chain format.

THE contract: a dump NEVER masks the original failure. Every byte of
work happens inside one catch-all; the chaos point ``obs.flight.dump``
(fired first thing inside it) exists to prove that a recorder failing
in any way leaves the original exception/exit path byte-identical
(``tests/test_flight.py``).

Artifacts are bounded (event/span tails, truncated thread dump) so a
black box is always shippable through the store's value limits.
"""

import faulthandler
import json
import os
import tempfile
import threading
import time
import traceback

from edl_tpu_torch.obs import events as events_mod
from edl_tpu_torch.obs import ledger as ledger_mod
from edl_tpu_torch.obs import metrics as metrics_mod
from edl_tpu_torch.obs import trace as trace_mod
from edl_tpu_torch.utils.logger import logger

#: value of controller.constants.SERVICE_HEALTH, inlined so obs stays
#: a leaf package (guarded by a test against drift)
SERVICE_HEALTH = "health"

#: store keys: ``blackbox_<pod_key>`` under SERVICE_HEALTH
KEY_PREFIX = "blackbox_"

#: artifact bounds — the box must fit through the store value limit
MAX_EVENTS = 256
MAX_SPANS = 128
MAX_THREAD_DUMP = 32768

#: local artifact directory override
BLACKBOX_DIR_ENV = "EDL_TPU_BLACKBOX_DIR"


def _thread_dump():
    """All-thread tracebacks via faulthandler (needs a real fd, so a
    temp file round-trip), bounded to MAX_THREAD_DUMP chars."""
    with tempfile.TemporaryFile(mode="w+") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        text = f.read()
    if len(text) > MAX_THREAD_DUMP:
        text = text[-MAX_THREAD_DUMP:]
    return text


def _exc_record(exc):
    if exc is None:
        return None
    tb = "".join(traceback.format_exception(
        type(exc), exc, getattr(exc, "__traceback__", None)))
    if len(tb) > MAX_THREAD_DUMP:
        tb = tb[-MAX_THREAD_DUMP:]
    return {"type": type(exc).__name__, "message": str(exc),
            "traceback": tb}


class FlightRecorder(object):
    """``pod_key``: stable identity stamped on the artifact (pod id,
    or pod id + rank). ``coord``: optional CoordClient for the
    best-effort store copy. ``out_dir``: local artifact directory
    (default ``$EDL_TPU_BLACKBOX_DIR`` or the system temp dir).
    ``providers``: late-bound context — the trainer registers a
    ``resize_timing`` provider so the box carries the live record
    without the recorder importing the runtime (obs stays a leaf)."""

    def __init__(self, pod_key, coord=None, out_dir=None, registry=None,
                 events=None, tracer=None, ledger=None,
                 clock=time.time):
        self._pod_key = str(pod_key)
        self._coord = coord
        self._out_dir = (out_dir or os.environ.get(BLACKBOX_DIR_ENV)
                         or tempfile.gettempdir())
        self._registry = registry or metrics_mod.REGISTRY
        self._events = events or events_mod.EVENTS
        self._tracer = tracer or trace_mod.TRACER
        self._ledger = ledger or ledger_mod.LEDGER
        self._clock = clock
        self._providers = {}
        self._lock = threading.Lock()
        self._dumping = False
        self._prev_excepthook = None
        self.last_path = None

    def register_provider(self, name, fn):
        """``fn()`` is called at dump time (inside the catch-all) and
        its JSON-able return lands under ``context[name]``."""
        self._providers[str(name)] = fn

    # -- the dump itself ----------------------------------------------------

    def _build(self, reason, exc):
        events = self._events.snapshot()
        if len(events) > MAX_EVENTS:
            events = events[-MAX_EVENTS:]
        spans = self._tracer.spans()
        if len(spans) > MAX_SPANS:
            spans = spans[-MAX_SPANS:]
        self._ledger.flush()
        context = {}
        for name, fn in sorted(self._providers.items()):
            try:
                context[name] = fn()
            except Exception as e:  # noqa: BLE001 — providers best-effort
                context[name] = {"provider_error": repr(e)}
        return {
            "schema": "blackbox/v1",
            "ts": self._clock(),
            "pod": self._pod_key,
            "pid": os.getpid(),
            "reason": reason,
            "exception": _exc_record(exc),
            "events": events,
            "spans": spans,
            "metrics": self._registry.snapshot(),
            "ledger": {s: round(v, 3)
                       for s, v in self._ledger.totals().items()},
            "threads": _thread_dump(),
            "context": context,
        }

    def dump(self, reason, exc=None):
        """Write the black box; returns the local path or None. NEVER
        raises and never re-enters (a failure inside the dump must not
        recurse through the excepthook back into the dump)."""
        with self._lock:
            if self._dumping:
                return None
            self._dumping = True
        try:
            # the chaos hook comes FIRST so an injected failure proves
            # the no-masking contract against the whole dump path; the
            # lazy import keeps obs a leaf (robustness imports obs)
            from edl_tpu_torch.robustness import faults
            if faults.PLANE is not None:
                faults.PLANE.fire("obs.flight.dump", reason=str(reason),
                                  pod=self._pod_key)
            doc = self._build(str(reason), exc)
            payload = json.dumps(doc)
            path = os.path.join(
                self._out_dir, "%s%s_%d.json"
                % (KEY_PREFIX, self._pod_key.replace(os.sep, "_"),
                   int(doc["ts"] * 1000)))
            with open(path, "w") as f:
                f.write(payload)
            self.last_path = path
            logger.error("flight recorder: %s black box for pod %s "
                         "-> %s", reason, self._pod_key, path)
            if self._coord is not None:
                try:
                    self._coord.set_server_permanent(
                        SERVICE_HEALTH, KEY_PREFIX + self._pod_key,
                        payload)
                except Exception as e:  # noqa: BLE001 — best-effort
                    logger.warning("black box store copy failed: %r", e)
            return path
        except BaseException as e:  # noqa: BLE001 — NEVER mask the crash
            try:
                logger.exception("flight recorder dump failed "
                                 "(original failure unaffected): %r", e)
            except BaseException:
                pass
            return None
        finally:
            with self._lock:
                self._dumping = False

    # -- process hooks ------------------------------------------------------

    def install_excepthook(self):
        """Chain onto ``sys.excepthook``: dump, then defer to the
        previous hook (the crash still prints and the exit code is
        untouched)."""
        import sys
        if self._prev_excepthook is not None:
            return self
        prev = sys.excepthook

        def hook(exc_type, exc, tb):
            self.dump("unhandled_exception", exc)
            prev(exc_type, exc, tb)

        self._prev_excepthook = prev
        sys.excepthook = hook
        return self

    def install_sigterm(self):
        """Chain onto SIGTERM (main thread only, best-effort): dump the
        box, then defer to the previous disposition — a chained Python
        handler runs as-is; SIG_DFL is re-raised so the exit status
        still says "killed by SIGTERM". The TRAINER must not use this:
        its PreemptionGuard owns SIGTERM (flag-only handler) and the
        box is dumped on the PreemptedError path instead."""
        import signal as signal_mod
        try:
            prev = signal_mod.getsignal(signal_mod.SIGTERM)

            def handler(signum, frame):
                self.dump("sigterm")
                if callable(prev):
                    prev(signum, frame)
                elif prev != signal_mod.SIG_IGN:
                    signal_mod.signal(signum, signal_mod.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal_mod.signal(signal_mod.SIGTERM, handler)
        except (ValueError, OSError) as e:  # not the main thread
            logger.debug("flight SIGTERM hook not installed: %r", e)
        return self

    def uninstall(self):
        import sys
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None


#: THE process recorder (installed once, by the launcher or trainer)
RECORDER = None


def install(pod_key, coord=None, out_dir=None, excepthook=True,
            sigterm=False):
    """Create/replace the process recorder; returns it."""
    global RECORDER
    if RECORDER is not None:
        RECORDER.uninstall()
    RECORDER = FlightRecorder(pod_key, coord=coord, out_dir=out_dir)
    if excepthook:
        RECORDER.install_excepthook()
    if sigterm:
        RECORDER.install_sigterm()
    return RECORDER


def dump(reason, exc=None):
    """Dump through the process recorder; no-op (None) before
    :func:`install`."""
    if RECORDER is None:
        return None
    return RECORDER.dump(reason, exc=exc)


def load_blackboxes(coord, service=SERVICE_HEALTH):
    """Every ``blackbox/v1`` doc in the store: ``{pod_key: doc}``."""
    out = {}
    try:
        for key, raw in coord.get_service(service):
            if not key.startswith(KEY_PREFIX):
                continue
            try:
                doc = json.loads(raw)
            except ValueError:
                continue
            if isinstance(doc, dict) \
                    and doc.get("schema") == "blackbox/v1":
                out[key[len(KEY_PREFIX):]] = doc
    except Exception as e:  # noqa: BLE001 — absent store == no boxes
        logger.debug("black box scan failed: %r", e)
    return out
