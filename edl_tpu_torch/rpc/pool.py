"""Shared, thread-safe RPC client pool keyed by endpoint.

The elastic data plane used to dial a **fresh TCP connection per stolen
batch** (ElasticReader._fetch constructed and closed an RpcClient around
every ``get_batch``), and the distill reader redialed every teacher on
every worker restart. RpcClient is already thread-safe and pipelined
(locked send path, per-connection reader thread matching responses by
envelope id), so one client per endpoint can carry every caller in the
process — the pool makes that sharing explicit and adds the two
lifecycle behaviors connection reuse needs:

- **idle reaping**: a client that has moved no traffic for ``idle_ttl``
  seconds is closed and dropped by a lazy daemon reaper, so a fleet
  that shrank does not leak sockets to departed peers;
- **retire-on-error**: a caller that sees a transport error retires the
  endpoint — the client is closed, dropped, and its cached feature set
  invalidated, so the next caller redials fresh (the peer may have
  restarted as a different generation).

``channel`` separates traffic classes onto distinct connections to the
same endpoint: a long-poll (``ds_get_assignment(wait_ms=...)``) is
served inline on its own server connection thread, so putting it on its
own channel keeps it from head-of-line-blocking bulk ``get_batches``
frames — without touching the shared worker pool on either side.

Leases: ``lease(endpoint)`` (a context manager) marks the client in
active use; the reaper never closes a leased client, so a caller
holding a lease across a long blocking call cannot have the socket
closed out from under it. Plain ``get()`` is the cheap path for
fire-and-forget callers (heartbeats) that tolerate a redial.
"""

import contextlib
import threading
import time

from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.utils import errors
from edl_tpu_torch.utils.logger import logger

_POOL_OPEN = obs_metrics.gauge(
    "edl_rpc_pool_open", "pooled clients currently open")
_POOL_DIALS = obs_metrics.counter(
    "edl_rpc_pool_dials_total", "pooled clients ever created (churn)")
_POOL_REAPS = obs_metrics.counter(
    "edl_rpc_pool_reaps_total", "idle clients reaped")
_POOL_RETIRES = obs_metrics.counter(
    "edl_rpc_pool_retires_total", "clients retired after transport "
    "errors")


class _Entry(object):
    __slots__ = ("client", "last_used", "leases")

    def __init__(self, client):
        self.client = client
        self.last_used = time.monotonic()
        self.leases = 0


class ClientPool(object):
    """``timeout``/``retry`` are passed through to every RpcClient the
    pool creates. ``idle_ttl`` bounds how long an unused connection is
    kept; ``reap_interval`` (default ``idle_ttl/4``) is the reaper's
    wake cadence."""

    def __init__(self, timeout=30.0, idle_ttl=120.0, reap_interval=None,
                 retry=None):
        self._timeout = timeout
        self._retry = retry
        self._idle_ttl = float(idle_ttl)
        self._reap_interval = (max(0.05, self._idle_ttl / 4.0)
                               if reap_interval is None
                               else float(reap_interval))
        self._lock = threading.Lock()
        self._entries = {}   # (endpoint, channel) -> _Entry
        self._features = {}  # endpoint -> tuple of advertised features
        self._stop = threading.Event()
        self._reaper = None
        self.dials = 0       # clients ever created (churn metric)
        self.reaps = 0       # idle clients closed by the reaper
        self.retires = 0     # clients dropped after transport errors

    # -- checkout ----------------------------------------------------------

    def get(self, endpoint, channel=None):
        """The shared client for ``endpoint`` (dialing lazily). The
        returned client may be reaped once idle; hold a :meth:`lease`
        around long blocking calls instead."""
        entry = self._checkout(endpoint, channel)
        with self._lock:
            entry.leases -= 1
        return entry.client

    @contextlib.contextmanager
    def lease(self, endpoint, channel=None):
        """Context manager yielding the shared client, protected from
        the idle reaper for the duration."""
        entry = self._checkout(endpoint, channel)
        try:
            yield entry.client
        finally:
            with self._lock:
                entry.leases -= 1
                entry.last_used = time.monotonic()

    def _checkout(self, endpoint, channel):
        key = (endpoint, channel)
        with self._lock:
            if self._stop.is_set():
                raise errors.StatusError("client pool is closed")
            entry = self._entries.get(key)
            if entry is None:
                entry = _Entry(RpcClient(endpoint, timeout=self._timeout,
                                         retry=self._retry))
                self._entries[key] = entry
                self.dials += 1
                _POOL_DIALS.inc()
                _POOL_OPEN.set(len(self._entries))
            entry.last_used = time.monotonic()
            entry.leases += 1
            if self._reaper is None:
                self._reaper = threading.Thread(
                    target=self._reap_loop, daemon=True,
                    name="rpc-pool-reaper")
                self._reaper.start()
        return entry

    # -- convenience call surface -----------------------------------------

    def call(self, endpoint, method, *args, channel=None, **kwargs):
        """Blocking call on the shared client, leased for the duration
        (safe across long-polls)."""
        with self.lease(endpoint, channel=channel) as client:
            return client.call(method, *args, **kwargs)

    def call_async(self, endpoint, method, *args, channel=None, **kwargs):
        """Pipelined call on the shared client. The lease covers only
        the send; the response rides the connection's reader thread
        (idle_ttl is orders of magnitude above any call timeout, so a
        pending future cannot be reaped out from under the caller)."""
        with self.lease(endpoint, channel=channel) as client:
            return client.call_async(method, *args, **kwargs)

    def features(self, endpoint):
        """The endpoint's advertised ``__features__``, probed once and
        cached until the endpoint is retired. Empty tuple for
        pre-pipelining peers (no such method) — never raises for a
        feature-less server, but transport failures propagate."""
        with self._lock:
            cached = self._features.get(endpoint)
        if cached is not None:
            return cached
        with self.lease(endpoint) as client:
            feats = client.server_features()
        with self._lock:
            self._features[endpoint] = feats
        return feats

    # -- lifecycle ---------------------------------------------------------

    def retire(self, endpoint, channel=None):
        """Drop and close the endpoint's client(s) after a transport
        error; the cached feature set is invalidated too (the peer may
        have restarted as a different generation). ``channel=None``
        retires EVERY channel to the endpoint — a dead peer is dead on
        all of them."""
        with self._lock:
            if channel is None:
                keys = [k for k in self._entries if k[0] == endpoint]
            else:
                keys = [(endpoint, channel)]
            dropped = [self._entries.pop(k) for k in keys
                       if k in self._entries]
            self._features.pop(endpoint, None)
            self.retires += len(dropped)
            _POOL_RETIRES.inc(len(dropped))
            _POOL_OPEN.set(len(self._entries))
        for entry in dropped:
            entry.client.close()

    def _reap_loop(self):
        while not self._stop.wait(self._reap_interval):
            now = time.monotonic()
            with self._lock:
                idle = [k for k, e in self._entries.items()
                        if e.leases <= 0
                        and now - e.last_used > self._idle_ttl]
                dropped = [self._entries.pop(k) for k in idle]
                self.reaps += len(dropped)
                _POOL_REAPS.inc(len(dropped))
                _POOL_OPEN.set(len(self._entries))
            for entry in dropped:
                logger.debug("pool: reaping idle client for %s",
                             entry.client.endpoint)
                entry.client.close()

    def stats(self):
        with self._lock:
            stats = {"open": len(self._entries), "dials": self.dials,
                     "reaps": self.reaps, "retires": self.retires}
        return obs_metrics.mirror_stats("edl_rpc_pool", stats)

    def close(self):
        """Close every client and stop the reaper. Idempotent; in-flight
        calls on pooled clients fail with ConnectError — intentional, so
        an owner's stop() promptly unblocks its fetch threads."""
        with self._lock:
            if self._stop.is_set():
                return
            self._stop.set()
            dropped = list(self._entries.values())
            self._entries.clear()
            self._features.clear()
            reaper = self._reaper
        for entry in dropped:
            entry.client.close()
        if reaper is not None:
            reaper.join(timeout=self._reap_interval + 5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
