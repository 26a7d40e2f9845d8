"""Pipelined RPC client with reconnect and per-endpoint channel cache.

One connection now carries MANY requests in flight: the send path is
serialized by a lock, a per-connection reader thread matches response
frames back to callers by the envelope ``id``, and :meth:`RpcClient.
call_async` hands the caller an :class:`RpcFuture`. The blocking
:meth:`RpcClient.call` is ``call_async(...).result()`` with the exact
pre-pipelining semantics (per-call timeout, deadline budget capping,
retry-on-ConnectError with idempotency gating, fault points).

Ordering/compat: responses are matched by id, never by arrival order,
so this client interoperates with both the pooled out-of-order server
and a strict request-reply peer (which simply answers in order).
Requests sent via ``call_async`` carry ``"pl": 1`` so the server knows
the sender tolerates out-of-order responses; plain ``call`` requests
omit it and are served inline exactly as before.

Reference parity: edl/utils/client.py + data_server_client.py channel
cache; errors re-raise by class name (edl/utils/exceptions.py:93-103).
"""

import itertools
import os
import select
import socket
import threading
import time

from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.robustness import faults
from edl_tpu_torch.rpc import framing
from edl_tpu_torch.utils import errors

_CALL_MS = obs_metrics.histogram(
    "edl_rpc_client_call_ms", "request send to response resolve",
    labels=("method",))
_INFLIGHT = obs_metrics.gauge(
    "edl_rpc_client_inflight", "requests awaiting a response")
_RETRIES = obs_metrics.counter(
    "edl_rpc_client_retries_total", "transport-failure retries",
    labels=("method",))
_CALL_ERRS = obs_metrics.counter(
    "edl_rpc_client_errors_total", "calls resolved with an error",
    labels=("method",))
_DIALS = obs_metrics.counter(
    "edl_rpc_client_connects_total", "connections dialed")

_LOCAL_HOSTS = None
_LOCAL_LOCK = threading.Lock()


def _local_hosts():
    """Addresses that mean "this machine" — loopback plus this host's
    own IP (a same-host peer usually advertises the real IP). Cached
    only once the real IP resolves: get_host_ip falls back to loopback
    before the network settles, and freezing that would silently
    disable the fast path for real-IP endpoints forever."""
    global _LOCAL_HOSTS
    with _LOCAL_LOCK:
        if _LOCAL_HOSTS is not None:
            return _LOCAL_HOSTS
        hosts = {"127.0.0.1", "localhost", "::1", "0.0.0.0"}
        try:
            from edl_tpu_torch.utils.network import get_host_ip
            ip = get_host_ip()
        except Exception:  # noqa: BLE001 — fast path is optional
            ip = None
        if ip and not ip.startswith("127."):
            hosts.add(ip)
            _LOCAL_HOSTS = hosts  # resolved: safe to freeze
        return hosts


class RpcFuture(object):
    """The pending response of one pipelined call.

    ``result(timeout)`` keeps the old blocking-call contract: a typed
    server error re-raises as its class; a transport failure (or a
    response that never arrives within the budget) tears the connection
    down and raises ConnectError, failing every other call in flight on
    the same connection — exactly what a died socket did before.
    """

    __slots__ = ("_client", "_conn", "method", "_budget", "_sent_at",
                 "_event", "_value", "_error", "_span", "_counted")

    def __init__(self, client, conn, method, budget):
        self._client = client
        self._conn = conn
        self.method = method
        self._budget = budget
        self._sent_at = time.monotonic()
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._span = None     # client trace span, closed at resolve
        self._counted = False  # in-flight gauge held (set post-send)

    def _resolve(self, value=None, error=None):
        if self._event.is_set():
            return
        self._value, self._error = value, error
        _CALL_MS.labels(self.method).observe(
            (time.monotonic() - self._sent_at) * 1e3)
        if self._counted:
            _INFLIGHT.dec()
            self._counted = False
        if error is not None:
            _CALL_ERRS.labels(self.method).inc()
        obs_trace.end_span(self._span, ok=error is None)
        self._span = None
        self._event.set()

    def done(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        """Non-destructive wait; True iff the response has arrived."""
        return self._event.wait(timeout)

    def remaining(self):
        """Seconds left of this call's send-time budget (None = unbounded)."""
        if self._budget is None:
            return None
        return self._budget - (time.monotonic() - self._sent_at)

    def result(self, timeout=-1):
        """Block for the response. ``timeout=-1`` (default) means "the
        budget computed at send time", mirroring what the socket
        timeout enforced for serial calls."""
        if timeout == -1:
            timeout = self.remaining()
        if not self._event.wait(timeout):
            # no response within budget: the connection is torn down
            # (same observable behavior as the old per-call socket
            # timeout) unless the response raced the teardown in
            self._client._kill_conn(
                self._conn,
                errors.ConnectError(
                    "rpc %s to %s failed: no response within %.1fs"
                    % (self.method, self._client.endpoint,
                       timeout if timeout is not None else -1.0)))
            if not self._event.is_set():
                raise errors.ConnectError(
                    "rpc %s to %s timed out after %.1fs"
                    % (self.method, self._client.endpoint,
                       timeout if timeout is not None else -1.0))
        if self._error is not None:
            raise self._error
        return self._value


class _Conn(object):
    """One live connection: the socket, the pending-by-id map, and the
    reader thread."""

    __slots__ = ("sock", "transport", "wlock", "plock",
                 "pending", "dead", "reader")

    def __init__(self, sock, transport):
        self.sock = sock
        self.transport = transport
        self.wlock = threading.Lock()   # serializes write_frame
        self.plock = threading.Lock()   # guards pending/dead
        self.pending = {}               # id -> RpcFuture
        self.dead = False
        self.reader = None


class RpcClient(object):
    def __init__(self, endpoint, timeout=60.0, retry=None):
        """``retry``: an optional robustness.policy.RetryPolicy; when
        set, calls marked ``idempotent=True`` (and any call that failed
        before its request hit the wire) reconnect and retry with
        jittered backoff instead of failing fast."""
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self.endpoint = endpoint
        self._timeout = timeout
        self._retry = retry
        self._conn = None
        self._ids = itertools.count()
        self._lock = threading.Lock()   # guards _conn (re)creation
        self._features = None  # peer's __features__, probed lazily
        self.transport = None  # "uds" | "tcp" after connect

    def _try_uds(self):
        """Same-host fast path (r5: 1381 vs 997 MB/s on tensor
        frames): dial the server's conventional AF_UNIX path if it
        exists, is OURS (0600 + uid check — /tmp is world-writable,
        a squatter must not receive our payloads), and answers.
        Any failure falls back to TCP silently."""
        if os.environ.get("EDL_TPU_DISABLE_UDS") \
                or not hasattr(socket, "AF_UNIX") \
                or self._addr[0] not in _local_hosts():
            return None
        import stat as stat_mod

        from edl_tpu_torch.rpc.server import uds_path_for_port
        path = uds_path_for_port(self._addr[1])
        s = None
        try:
            # lstat + S_ISSOCK: a symlink planted in world-writable
            # /tmp must not redirect us (stat would follow it)
            st = os.lstat(path)
            if st.st_uid != os.getuid() \
                    or not stat_mod.S_ISSOCK(st.st_mode):
                return None
            s = socket.socket(socket.AF_UNIX)
            s.settimeout(self._timeout)
            s.connect(path)
            if not self._verify_uds_identity(s):
                s.close()
                return None
            return s
        except OSError:
            if s is not None:
                s.close()  # no fd leak on stale-file fallback
            return None

    def _verify_uds_identity(self, sock):
        """The UDS path is keyed by port NUMBER alone, but two servers
        bound to distinct specific addresses (127.0.0.1 vs the real IP)
        can legitimately share a port number — whichever started first
        owns the socket path, and it may not be the server we dialed.
        Ask who answers before trusting the fast path; any failure or
        mismatch means "use TCP", which always reaches the right peer."""
        try:
            framing.write_frame(sock, {"id": -1,
                                       "method": "__identity__"})
            resp = framing.read_frame(sock)
            if not resp.get("ok"):
                return False  # pre-identity server: can't verify
            ident = resp.get("result") or {}
            if int(ident.get("port", -1)) != self._addr[1]:
                return False
            bind = str(ident.get("host", ""))
            if bind in ("0.0.0.0", "::"):
                return True  # wildcard bind answers every local address
            loop = {"127.0.0.1", "localhost", "::1"}
            # dialing 0.0.0.0 over TCP lands on loopback, so a
            # loopback-bound server is the right peer for it too
            if bind in loop and self._addr[0] in (loop | {"0.0.0.0"}):
                return True
            return bind == self._addr[0]
        except (OSError, ValueError, TypeError, framing.FramingError):
            return False

    def _ensure_conn(self):
        """Dial if needed; returns the live _Conn. Caller holds no locks."""
        with self._lock:
            conn = self._conn
            if conn is not None:
                return conn
            if faults.PLANE is not None:
                # partition/error/delay on the dial path (site kinds
                # degrade to "unreachable")
                f = faults.PLANE.fire("rpc.client.connect",
                                      endpoint=self.endpoint)
                if f is not None:
                    raise errors.ConnectError(
                        "fault: connect to %s cut" % self.endpoint)
            sock = self._try_uds()
            if sock is not None:
                transport = "uds"
            else:
                try:
                    sock = socket.create_connection(
                        self._addr, timeout=self._timeout)
                    framing.set_keepalive(sock)
                    transport = "tcp"
                except OSError as e:
                    raise errors.ConnectError(
                        "connect %s:%s failed: %s" % (*self._addr, e))
            _DIALS.inc()
            conn = _Conn(sock, transport)
            conn.reader = threading.Thread(
                target=self._read_loop, args=(conn,), daemon=True,
                name="rpc-reader-%s" % self.endpoint)
            self._conn = conn
            self.transport = transport
            conn.reader.start()
            return conn

    def _read_loop(self, conn):
        """Match response frames to pending futures by envelope id.
        Any transport failure fails EVERY call in flight — the peer is
        a stream, so one torn frame desyncs all of them.

        The reader polls for readability before touching the socket:
        the socket's timeout is owned by the SEND path (per-call
        budget), and an idle connection must not be torn down just
        because no response arrived within one call's budget. A
        timeout that fires mid-frame, by contrast, really is a dead
        peer and kills the connection like any transport error."""
        poller = select.poll()
        poller.register(conn.sock.fileno(), select.POLLIN)
        try:
            while True:
                try:
                    events = poller.poll(1000)  # ms; idle wakeup only
                    if not events:
                        continue
                    if events[0][1] & select.POLLNVAL:
                        raise ConnectionError("connection closed")
                    resp = framing.read_frame(conn.sock)
                except (OSError, ConnectionError, ValueError,
                        framing.FramingError) as e:
                    self._kill_conn(conn, errors.ConnectError(
                        "rpc to %s failed: %s" % (self.endpoint, e)))
                    return
                with conn.plock:
                    fut = conn.pending.pop(resp.get("id"), None)
                if fut is None:
                    continue  # response for a call that already timed out
                if resp.get("ok"):
                    fut._resolve(value=resp.get("result"))
                else:
                    err = resp.get("error", {})
                    fut._resolve(error=errors.deserialize_error(
                        err.get("name", "RpcError"), err.get("detail", "")))
        finally:
            # the reader owns the fd's lifetime: closing it anywhere
            # else would race this thread's poll() against fd-number
            # reuse (kill only shuts the connection down)
            try:
                conn.sock.close()
            except OSError:
                pass

    def _kill_conn(self, conn, exc):
        """Tear down ``conn`` and fail everything pending on it with
        ``exc``. Idempotent; callable from any thread (reader, a timed
        -out caller, close())."""
        if conn is None:
            return
        with self._lock:
            if self._conn is conn:
                self._conn = None
        with conn.plock:
            if conn.dead:
                return
            conn.dead = True
            pending = list(conn.pending.values())
            conn.pending.clear()
        try:
            # shutdown, NOT close: the reader thread polls this fd and
            # closes it on exit; closing here would race fd reuse
            conn.sock.shutdown(socket.SHUT_RDWR)  # wakes a blocked reader
        except OSError:
            pass
        for fut in pending:
            fut._resolve(error=exc)

    def close(self):
        self._kill_conn(self._conn,
                        errors.ConnectError("client for %s closed"
                                            % self.endpoint))

    # -- the call surface --------------------------------------------------

    def call_async(self, method, *args, timeout=None, deadline=None,
                   **kwargs):
        """Send ``method`` without waiting; returns an :class:`RpcFuture`.

        Many calls may be in flight on one connection; responses are
        matched by id, so completion order is whatever the server
        chooses. The request carries ``"pl": 1`` (pipelined) so a
        feature-aware server may dispatch it to its worker pool and
        answer out of order; a strict request-reply server just answers
        in order — both are correct for this client.
        """
        return self._send(method, args, kwargs, timeout, deadline,
                          pipelined=True)

    def server_features(self):
        """The peer's advertised feature set (empty for pre-pipelining
        servers, which lack the ``__features__`` method). Cached on the
        client — the trace-header gate consults the cache on every
        send, and a pool retire discards the whole client anyway."""
        if self._features is not None:
            return self._features
        try:
            feats = tuple(self.call("__features__"))
        except errors.RpcError:
            feats = ()
        self._features = feats
        return feats

    def _trace_header(self, span, method):
        """The ``[trace_id, span_id]`` header for ``span`` — but only
        once the peer negotiated ``obs.trace`` (probed lazily, once per
        client). A legacy peer never sees the key: byte-compatible
        fallback, same negotiation pattern as rpc.pipeline. Internal
        dunder methods never probe (the probe itself is one)."""
        if span is None:
            return None
        feats = self._features
        if feats is None:
            if method.startswith("__"):
                return None
            try:
                feats = self.server_features()
            except errors.EdlError:
                self._features = feats = ()
        if "obs.trace" not in feats:
            return None
        return [span.trace_id, span.span_id]

    def _send(self, method, args, kwargs, timeout, deadline,
              pipelined, wrote=None):
        # span + header resolved BEFORE taking the write lock: the
        # first traced call may probe __features__, a full nested call
        span = obs_trace.begin_span("rpc.client/%s" % method,
                                    kind="client",
                                    tags={"endpoint": self.endpoint})
        header = self._trace_header(span, method)
        try:
            conn = self._ensure_conn()
            budget = timeout or self._timeout
            if deadline is not None:
                budget = deadline.remaining(cap=budget)
                if budget is not None and budget <= 0:
                    raise errors.DeadlineExceededError(
                        "rpc %s to %s: no budget left"
                        % (method, self.endpoint))
            with conn.wlock:
                if faults.PLANE is not None:
                    f = faults.PLANE.fire("rpc.client.call",
                                          endpoint=self.endpoint,
                                          method=method)
                    if f is not None:
                        # a dropped request manifests to the caller as
                        # a timed-out connection
                        self._kill_conn(conn, errors.ConnectError(
                            "rpc %s to %s failed: fault: request dropped"
                            % (method, self.endpoint)))
                        raise errors.ConnectError(
                            "rpc %s to %s failed: fault: request dropped"
                            % (method, self.endpoint))
                call_id = next(self._ids)
                req = {"id": call_id, "method": method,
                       "args": list(args), "kwargs": kwargs}
                if pipelined:
                    req["pl"] = 1
                if header is not None:
                    req["tr"] = header
                fut = RpcFuture(self, conn, method, budget)
                fut._span = span
                with conn.plock:
                    if conn.dead:
                        raise errors.ConnectError(
                            "rpc %s to %s failed: connection died"
                            % (method, self.endpoint))
                    # registered BEFORE the write: the response can
                    # arrive the instant the last request byte hits the
                    # wire
                    conn.pending[call_id] = fut
                _INFLIGHT.inc()
                fut._counted = True
                try:
                    conn.sock.settimeout(budget)
                    framing.write_frame(conn.sock, req)
                    if wrote is not None:
                        wrote[0] = True
                except (OSError, ConnectionError,
                        framing.FramingError) as e:
                    self._kill_conn(conn, errors.ConnectError(
                        "rpc %s to %s failed: %s"
                        % (method, self.endpoint, e)))
                    raise errors.ConnectError(
                        "rpc %s to %s failed: %s"
                        % (method, self.endpoint, e))
        except Exception:
            # a send that never reached _resolve closes its span here
            # (end_span is idempotent, so the _kill_conn path — which
            # resolves the registered future and closes the span — is
            # safe to race)
            obs_trace.end_span(span, ok=False)
            raise
        return fut

    def call(self, method, *args, timeout=None, deadline=None,
             idempotent=False, **kwargs):
        """Invoke ``method`` remotely and block for its result.

        ``deadline``: an optional robustness.policy.Deadline — the
        caller's remaining budget caps this call's socket timeout, so a
        nested call chain can never outlive its outermost budget.
        ``idempotent``: with a retry policy configured, lets this call
        be re-sent after a transport failure even though the original
        request may have reached the server.
        """
        if self._retry is None:
            return self._call_once(method, args, kwargs, timeout, deadline)
        attempt = 0
        while True:
            attempt += 1
            if deadline is not None:
                deadline.check("rpc %s to %s" % (method, self.endpoint))
            wrote = [False]
            try:
                return self._call_once(method, args, kwargs, timeout,
                                       deadline, wrote)
            except errors.ConnectError as e:
                # a request that never hit the wire is always safe to
                # retry; one that did is only safe if idempotent
                if not (idempotent or not wrote[0]):
                    raise
                if not self._retry.sleep(attempt, deadline):
                    if deadline is not None and deadline.expired():
                        raise errors.DeadlineExceededError(
                            "rpc %s to %s: deadline exceeded after %d "
                            "attempts; last error: %r"
                            % (method, self.endpoint, attempt, e)) from e
                    raise
                _RETRIES.labels(method).inc()

    def _call_once(self, method, args, kwargs, timeout, deadline,
                   wrote=None):
        # pipelined=False: a plain blocking call asks for the server's
        # strict inline dispatch (lowest latency, pre-pipelining order)
        fut = self._send(method, args, kwargs, timeout, deadline,
                         pipelined=False, wrote=wrote)
        return fut.result()


def call(endpoint, method, *args, **kwargs):
    """One-shot convenience call (opens and closes a connection)."""
    c = RpcClient(endpoint)
    try:
        return c.call(method, *args, **kwargs)
    finally:
        c.close()
