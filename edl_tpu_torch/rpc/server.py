"""Threaded RPC server: method-name dispatch over framed msgpack TCP.

Replaces the reference's three gRPC services (PodServer, DataServer,
DiscoveryService — protos/*.proto) and its raw epoll server with one
substrate. Handlers raise EdlError subclasses; the error envelope carries the
class name so clients re-raise the same type (reference parity:
edl/utils/exceptions.py:93-114 serialize/deserialize).

Pipelining: a request whose envelope carries ``"pl": 1`` announces that
its sender matches responses by id and tolerates out-of-order replies.
Those requests are dispatched to a bounded worker pool and their
responses written whenever they finish, under a per-connection write
lock so frames never interleave. Requests without the flag (every
pre-pipelining client) are served inline on the connection thread —
strict request-reply order, byte-for-byte the old behavior. Servers
advertise the capability via the auto-registered ``__features__``
method (and the teacher server mirrors it into ``get_feed_fetch``).
"""

import os
import socket
import socketserver
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.robustness import faults
from edl_tpu_torch.rpc import framing
from edl_tpu_torch.utils import errors
from edl_tpu_torch.utils.logger import logger

#: capabilities every in-tree server advertises through __features__.
#: obs.trace: requests may carry a ``"tr": [trace_id, span_id]`` header
#: and the dispatch runs under a server span adopting it as parent.
#: obs.metrics: the ``__metrics__`` method serves this process's
#: registry snapshot / Prometheus text.
#: obs.profile: the ``__profile__`` method captures an on-demand
#: chrome-trace window (torch.profiler when available, else the tracer
#: ring) — ``job_doctor --profile`` fans it out fleet-wide.
FEATURES = ("rpc.pipeline", "obs.trace", "obs.metrics", "obs.profile")

_REQS = obs_metrics.counter(
    "edl_rpc_server_requests_total", "requests dispatched",
    labels=("method",))
_ERRS = obs_metrics.counter(
    "edl_rpc_server_errors_total", "requests answered with an error "
    "envelope", labels=("method",))
_HANDLE_MS = obs_metrics.histogram(
    "edl_rpc_server_handle_ms", "request wall time: dequeue to "
    "response written", labels=("method",))
_INFLIGHT = obs_metrics.gauge(
    "edl_rpc_server_inflight", "requests currently executing")

# per-connection cap on pooled requests in flight: when a client
# pipelines deeper than this the read loop stops pulling frames and TCP
# backpressure does the rest — one flooding connection cannot occupy
# the whole worker pool
MAX_CONN_INFLIGHT = 32


def uds_path_for_port(port):
    """Conventional AF_UNIX path for a server's TCP port: same-host
    clients auto-dial it (kernel loopback TCP measured 997 MB/s vs UDS
    1381 MB/s on the v2 tensor-frame path, r5). uid-scoped so multiple
    users can't collide; the file itself is chmod 0600."""
    return "/tmp/edl_tpu_rpc_%d_%d.sock" % (os.getuid(), port)


def _metrics_method(fmt="json", events_since=0):
    """Auto-registered ``__metrics__``: this process's observability
    surface. ``fmt="prom"`` returns Prometheus text exposition;
    ``fmt="json"`` returns the registry snapshot plus the event
    timeline (incrementally, via ``events_since`` id watermark)."""
    if fmt == "prom":
        return obs_metrics.REGISTRY.prometheus_text()
    return {"metrics": obs_metrics.REGISTRY.snapshot(),
            "events": obs_events.EVENTS.snapshot(since_id=events_since)}


#: cap on trace events shipped per __profile__ response: a busy device
#: window can emit hundreds of thousands; the RPC reply must stay
#: deliverable through the framing limits
MAX_PROFILE_EVENTS = 20000

#: cap on the requested capture window
MAX_PROFILE_S = 60.0


def _try_torch_profile(duration_s):
    """Capture ``duration_s`` of ``torch.profiler`` activity (the CUDA
    device too, where there is one) and export it as a chrome trace
    into a temp dir, then parse it back out. Returns the trace dict or
    None wherever any part is unavailable (no torch, no profiler, no
    trace file emitted) — callers fall back to the tracer ring."""
    import json
    import shutil
    import tempfile
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        tmp = tempfile.mkdtemp(prefix="edl_profile_")
        try:
            with profile(activities=activities) as prof:
                time.sleep(duration_s)
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            if not os.path.exists(path):
                return None
            with open(path) as f:
                doc = json.load(f)
            events = doc.get("traceEvents") or []
            if len(events) > MAX_PROFILE_EVENTS:
                events = events[:MAX_PROFILE_EVENTS]
            return {"traceEvents": events, "displayTimeUnit": "ms"}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    except Exception as e:  # noqa: BLE001 — any failure => fallback
        logger.debug("torch.profiler capture unavailable: %r", e)
        return None


def _profile_method(duration_s=2.0, source="auto"):
    """Auto-registered ``__profile__``: on-demand profiling of THIS
    process. ``source``: "auto" tries ``torch.profiler`` first and falls
    back to the span tracer's ring; "tracer" skips straight to the
    ring (cheap — no device profiling session). Returns a
    ``profile/v1`` doc whose ``trace`` is chrome-trace JSON either
    way, so ``job_doctor --profile`` merges pods into one Perfetto
    file without caring which path answered."""
    duration_s = max(0.0, min(float(duration_s), MAX_PROFILE_S))
    trace = None
    used = "tracer_ring"
    if source == "auto":
        trace = _try_torch_profile(duration_s)
        if trace is not None:
            used = "torch.profiler"
    if trace is None:
        # ring fallback: wait out the window so activity DURING it is
        # in the ring, then snapshot (older spans ride along — the
        # ring is bounded, not windowed)
        if duration_s > 0:
            time.sleep(duration_s)
        trace = obs_trace.TRACER.chrome_trace()
    return {"schema": "profile/v1", "ts": time.time(),
            "pid": os.getpid(), "duration_s": duration_s,
            "source": used, "trace": trace}


def _default_workers():
    env = os.environ.get("EDL_TPU_RPC_WORKERS")
    if env is not None:
        return int(env)
    return min(16, (os.cpu_count() or 4) * 2)


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        self.server.connections.add(self.request)

    def finish(self):
        self.server.connections.discard(self.request)

    def handle(self):
        framing.set_keepalive(self.request)
        if faults.PLANE is not None:
            # accept-path chaos: a drop here severs the fresh connection
            # before any request is served (error/delay act in fire())
            f = faults.PLANE.fire("rpc.server.conn")
            if f is not None:
                return
        wlock = threading.Lock()  # at most one frame mid-write per conn
        sem = threading.BoundedSemaphore(MAX_CONN_INFLIGHT)
        pool = self.server.pool
        while True:
            try:
                req = framing.read_frame(self.request)
            except (ConnectionError, OSError, framing.FramingError):
                return
            if req.get("pl") and pool is not None:
                sem.acquire()
                try:
                    pool.submit(self._serve_pooled, req, wlock, sem)
                    continue
                except RuntimeError:  # pool shut down mid-stop
                    sem.release()
            if not self._serve_one(req, wlock):
                return

    def _serve_pooled(self, req, wlock, sem):
        try:
            # a dead connection surfaces as a write failure inside
            # _serve_one; the read loop notices on its own recv
            self._serve_one(req, wlock)
        finally:
            sem.release()

    def _serve_one(self, req, wlock):
        """Execute one request and write its response; False means the
        connection is gone and the read loop should exit."""
        resp = {"id": req.get("id")}
        t0 = time.monotonic()
        _INFLIGHT.inc()
        try:
            method = req["method"]
            if faults.PLANE is not None:
                # inside the try: an injected error comes back to the
                # client as a typed error envelope for that method
                f = faults.PLANE.fire("rpc.server.request",
                                      method=method)
                if f is not None and f.kind == "drop":
                    return True  # swallow: the client waits until timeout
            fn = self.server.methods.get(method)
            if fn is None:
                raise errors.RpcError("no such method: %s" % method)
            resp["ok"] = True
            # the server span adopts the envelope's trace header as
            # parent and activates the context, so a nested RPC issued
            # inside the handler carries the same trace onward
            with obs_trace.server_span("rpc/%s" % method,
                                       req.get("tr")):
                resp["result"] = fn(*req.get("args", []),
                                    **req.get("kwargs", {}))
        except Exception as e:  # noqa: BLE001 — envelope every failure
            if not isinstance(e, errors.EdlError):
                logger.exception("rpc handler %s failed",
                                 req.get("method"))
            name, detail = errors.serialize_error(e)
            resp["ok"] = False
            resp["error"] = {"name": name, "detail": detail}
            _ERRS.labels(str(req.get("method"))).inc()
        finally:
            _INFLIGHT.dec()
            method_lbl = str(req.get("method"))
            _REQS.labels(method_lbl).inc()
            _HANDLE_MS.labels(method_lbl).observe(
                (time.monotonic() - t0) * 1e3)
        try:
            with wlock:
                try:
                    framing.write_frame(self.request, resp)
                except (TypeError, ValueError, framing.FramingError) as e:
                    # result not wire-encodable → error envelope, keep
                    # the connection (packb fails before any byte is
                    # sent, so the stream cannot be torn mid-frame)
                    framing.write_frame(self.request, {
                        "id": resp.get("id"), "ok": False,
                        "error": {"name": "RpcError",
                                  "detail": "unencodable response: %s"
                                  % e}})
        except (ConnectionError, OSError):
            return False
        return True


class _TCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.connections = set()
        self.pool = None


if hasattr(socketserver, "ThreadingUnixStreamServer"):
    class _UDSServer(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True
        request_queue_size = 128

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.connections = set()
            self.pool = None
else:  # non-POSIX: TCP only
    _UDSServer = None


class RpcServer(object):
    """Register callables by name, serve them on host:port.

    port=0 picks a free port; the bound port is available as ``.port`` after
    ``start()`` (reference parity: pod_server started on port 0 then wrote the
    real port back into the pod — edl/utils/pod_server.py:130-147).

    ``workers``: size of the pooled-dispatch executor for pipelined
    requests (default: EDL_TPU_RPC_WORKERS or 2×cores capped at 16;
    0 disables pooling — every request is served inline in strict
    request-reply order, the pre-pipelining behavior).
    """

    def __init__(self, host="0.0.0.0", port=0, workers=None):
        self._host = host
        self._port = port
        self._server = None
        self._thread = None
        self._pool = None
        self._workers = _default_workers() if workers is None else workers
        self.methods = {}
        self.register("__features__", lambda: list(FEATURES))
        self.register("__identity__", self._identity)
        self.register("__metrics__", _metrics_method)
        self.register("__profile__", _profile_method)

    def _identity(self):
        """Who answers on this listener: the bind host + bound TCP
        port. UDS paths are keyed by port number alone, so two servers
        bound to distinct addresses sharing a port number collide on
        the socket path — clients probe this after a UDS connect and
        fall back to TCP when the answer isn't the server they dialed."""
        return {"host": self._host, "port": self.port}

    def register(self, name, fn):
        self.methods[name] = fn
        return self

    def register_object(self, obj, prefix=""):
        """Expose every public method of ``obj`` as ``prefix + name``."""
        for name in dir(obj):
            if name.startswith("_"):
                continue
            fn = getattr(obj, name)
            if callable(fn):
                self.register(prefix + name, fn)
        return self

    def start(self):
        if self._workers > 0:
            self._pool = ThreadPoolExecutor(
                max_workers=self._workers,
                thread_name_prefix="rpc-worker")
        self._server = _TCPServer((self._host, self._port), _Handler)
        self._server.methods = self.methods
        self._server.pool = self._pool
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="rpc-server")
        self._thread.start()
        self._start_uds()
        return self

    def _start_uds(self):
        """Best-effort same-host fast path: a second listener on the
        conventional AF_UNIX path for our TCP port. Failure never
        blocks the TCP server."""
        self._uds_server = None
        self._uds_path = None
        self._uds_lock_fd = None
        if _UDSServer is None or os.environ.get("EDL_TPU_DISABLE_UDS"):
            return
        path = uds_path_for_port(self.port)
        # Sidecar lockfile closes the probe→unlink→bind TOCTOU: two
        # servers can legitimately race for one path (distinct bind
        # addresses share a port number), and between our liveness
        # probe and our bind the other could unlink the file we just
        # created. flock is advisory but both racers are THIS code, so
        # whoever holds the lock owns the path for its lifetime. The
        # lockfile is never unlinked (unlink+recreate would hand out a
        # second lockable inode and resurrect the race).
        lock_fd = None
        try:
            import fcntl
            lock_fd = os.open(path + ".lock",
                              os.O_CREAT | os.O_RDWR, 0o600)
            fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except (OSError, ImportError) as e:
            if lock_fd is not None:
                os.close(lock_fd)
            logger.warning("uds path %s lock held elsewhere (%r); "
                           "tcp only", path, e)
            return
        # A LIVE listener may still own the path without holding the
        # lock (pre-lockfile server generations). Probe-connect —
        # only a dead (stale) socket may be unlinked and taken.
        if os.path.lexists(path):
            probe = socket.socket(socket.AF_UNIX)
            try:
                probe.settimeout(1.0)
                probe.connect(path)
                logger.warning("uds path %s owned by a live server; "
                               "tcp only", path)
                os.close(lock_fd)
                return
            except OSError:
                pass  # stale — safe to take
            finally:
                probe.close()
        srv = None
        # umask, not post-bind chmod: the listener accepts connections
        # the moment bind+listen complete inside __init__, so the file
        # must never exist with permissive bits
        old_umask = os.umask(0o177)
        try:
            if os.path.lexists(path):
                os.unlink(path)
            srv = _UDSServer(path, _Handler)
            srv.methods = self.methods
            srv.pool = self._pool
            self._uds_thread = threading.Thread(
                target=srv.serve_forever, kwargs={"poll_interval": 0.1},
                daemon=True, name="rpc-server-uds")
            self._uds_thread.start()
            self._uds_server = srv
            self._uds_path = path
            self._uds_lock_fd = lock_fd  # held until stop()
        except Exception as e:  # noqa: BLE001 — fast path is optional
            logger.warning("uds listener unavailable (%r); tcp only", e)
            if srv is not None:  # bound but thread never started
                try:
                    srv.server_close()
                    os.unlink(path)
                except OSError:
                    pass
            os.close(lock_fd)
        finally:
            os.umask(old_umask)

    @property
    def port(self):
        return self._server.server_address[1]

    @property
    def endpoint(self):
        host = self._host if self._host != "0.0.0.0" else "127.0.0.1"
        return "%s:%d" % (host, self.port)

    def stop(self):
        # UDS teardown FIRST: once TCP server_close releases the port,
        # a rapid successor can bind it and recreate the same socket
        # path — unlinking after that would delete the successor's
        # live fast-path file
        if getattr(self, "_uds_server", None) is not None:
            self._uds_server.shutdown()
            for sock in list(self._uds_server.connections):
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            self._uds_server.server_close()
            self._uds_server = None
            try:
                os.unlink(self._uds_path)
            except OSError:
                pass
        if getattr(self, "_uds_lock_fd", None) is not None:
            # releases the flock; the lockfile itself stays (see
            # _start_uds — unlinking it would reopen the bind race)
            os.close(self._uds_lock_fd)
            self._uds_lock_fd = None
        if self._server is not None:
            self._server.shutdown()
            # sever live connections so a stop behaves like a real process
            # death — clients must reconnect, not keep talking to a zombie
            for sock in list(self._server.connections):
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            self._server.server_close()
            self._server = None
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
