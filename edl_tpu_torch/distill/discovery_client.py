"""Student-side discovery client: register, heartbeat, follow redirects,
surface the current teacher list.

Reference parity: edl/distill/discovery_client.py (response-code dispatch
:70-80, 2s versioned heartbeat :169-182, redirect reconnect :115-131,
client uuid :184).

The discovery server (``edl_tpu/distill/discovery_server.py``) is not
ported yet (ROADMAP slice 5c); its four response codes are copied here
byte for byte, so this client speaks to the JAX package's server.
"""

import os
import threading
import uuid

from edl_tpu_torch.robustness import faults
from edl_tpu_torch.robustness.policy import CircuitBreaker, Deadline, \
    RetryPolicy
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.utils import errors
from edl_tpu_torch.utils.logger import logger

# the discovery server's response codes (its module's CODE_* values)
CODE_OK = "OK"
CODE_REDIRECT = "REDIRECT"
CODE_UNREGISTERED = "UNREGISTERED"
CODE_NO_READY = "NO_READY"


def _gen_client_id():
    return "%s-%d-%s" % (os.uname().nodename, os.getpid(),
                         uuid.uuid4().hex[:8])


class DiscoveryClient(object):
    def __init__(self, endpoint, service_name, require_num=1,
                 heartbeat_interval=2.0, phase=None):
        self._endpoint = endpoint
        self._service = service_name
        self._require = require_num
        # serving-phase affinity (None | "prefill" | "decode"): which
        # advertised teacher capacity this client weighs against in the
        # balance table (distill/balance.py phase disaggregation)
        self._phase = phase
        self._interval = heartbeat_interval
        self.client_id = _gen_client_id()
        self._rpc = None
        self._version = -1
        self._servers = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        # discovery-outage degradation (stale-but-serving): a dead
        # discovery server opens this breaker — exactly one
        # ``breaker.open`` event per outage — and re-register probes
        # run at the bounded half-open rate (one per heartbeat
        # interval) instead of hammering; the last-known teacher table
        # keeps serving untouched the whole time, and a returned
        # server is re-joined within one probe period
        self._breaker = CircuitBreaker(failure_threshold=1,
                                       reset_timeout=heartbeat_interval)
        self._poll = RetryPolicy(base_delay=0.2, max_delay=1.0,
                                 multiplier=1.5, jitter=0.5)

    # -- wire helpers -----------------------------------------------------------

    def _connect(self, endpoint):
        if self._rpc is not None:
            self._rpc.close()
        self._rpc = RpcClient(endpoint, timeout=10)

    def _register(self):
        """Register, following redirects to the shard owner."""
        endpoint = self._endpoint
        for _ in range(8):
            self._connect(endpoint)
            resp = self._rpc.call("register_client", self.client_id,
                                  self._service, self._require,
                                  self._phase)
            code = resp.get("code")
            if code == CODE_REDIRECT:
                endpoint = resp["endpoint"]
                continue
            if code in (CODE_OK, CODE_NO_READY):
                with self._lock:
                    self._version = resp["version"]
                    self._servers = list(resp.get("servers", []))
                self._breaker.record_success(self._endpoint)
                return
            raise errors.RpcError("register failed: %r" % resp)
        raise errors.RpcError("too many discovery redirects")

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self._register()
        self._thread = threading.Thread(target=self._heartbeat_loop,
                                        daemon=True,
                                        name="discovery-heartbeat")
        self._thread.start()
        return self

    def _heartbeat_loop(self):
        while not self._stop.wait(self._interval):
            if self._breaker.state(self._endpoint) \
                    != CircuitBreaker.CLOSED:
                # outage mode: the last-known table keeps serving; a
                # re-register probe runs at the breaker's bounded
                # half-open rate (one per interval) — a returned
                # server closes the breaker inside _register()
                if self._breaker.allow(self._endpoint):
                    try:
                        self._register()
                    except errors.EdlError:
                        self._breaker.record_failure(self._endpoint)
                continue
            try:
                resp = self._rpc.call("heartbeat", self.client_id,
                                      self._service, self._version)
                code = resp.get("code")
                self._breaker.record_success(self._endpoint)
                if code == CODE_REDIRECT:
                    self._connect(resp["endpoint"])
                    self._register()
                    continue
                if code == CODE_UNREGISTERED:
                    logger.info("discovery dropped us; re-registering")
                    self._register()
                    continue
                if "servers" in resp:
                    with self._lock:
                        self._version = resp["version"]
                        self._servers = list(resp["servers"])
            except errors.EdlError as e:
                # the table in self._servers is NOT cleared: clients
                # keep routing on the last-known membership while the
                # discovery server is away (stale-but-serving). The
                # closed→open transition logs exactly ONE breaker.open
                # event per outage (half-open re-probes mark
                # ``reopened`` instead).
                logger.warning("discovery heartbeat error: %r", e)
                self._breaker.record_failure(self._endpoint)

    def get_servers(self):
        if faults.PLANE is not None:
            # chaos: a "drop" here makes the whole teacher fleet vanish
            # from this client's view (endpoint flap drills)
            f = faults.PLANE.fire("distill.discovery",
                                  service=self._service)
            if f is not None:
                return []
        with self._lock:
            return list(self._servers)

    def wait_for_servers(self, timeout=60):
        deadline = Deadline(timeout)
        attempt = 0
        while True:
            servers = self.get_servers()
            if servers:
                return servers
            attempt += 1
            if not self._poll.sleep(attempt, deadline):
                raise errors.TimeoutError_(
                    "no teachers discovered within %ss" % timeout)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval * 2 + 1)
        if self._rpc is not None:
            try:
                self._rpc.call("unregister_client", self.client_id,
                               self._service)
            except errors.EdlError:
                pass
            self._rpc.close()


class FixedDiscover(object):
    """A static teacher list (reference FixedServiceDiscover,
    distill_reader.py:38-45)."""

    def __init__(self, endpoints):
        self._endpoints = list(endpoints)

    def start(self):
        return self

    def get_servers(self):
        if faults.PLANE is not None:
            # same flap drill as the dynamic client: fixed fleets are
            # what chaos tests usually stand up
            f = faults.PLANE.fire("distill.discovery", service="fixed")
            if f is not None:
                return []
        return list(self._endpoints)

    def wait_for_servers(self, timeout=0):
        return list(self._endpoints)

    def stop(self):
        pass
