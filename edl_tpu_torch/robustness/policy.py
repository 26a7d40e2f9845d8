"""Unified retry / deadline / circuit-breaker policy.

The three primitives every control-plane subsystem composes instead of
hand-rolling failure handling (the pre-existing idioms they replace:
``RpcClient.call`` failing fast, CoordClient's inline rotation-with-
grace loop, DistillReader's ``_recent_failures`` timestamp map, and
liveft's bare fixed-interval polls):

- :class:`Deadline` — a time **budget** created once at the outermost
  caller and passed down through nested calls, so a 60s caller budget
  caps every inner RPC and backoff sleep instead of each layer starting
  its own fresh timer (the classic unbounded-total-latency bug).
- :class:`RetryPolicy` — jittered exponential backoff with retryable
  -error classification and optional max attempts. Deterministic under
  test via ``seed``.
- :class:`CircuitBreaker` — per-key (endpoint) open / half-open /
  closed, so a flapping peer is probed at a bounded rate instead of
  hammered by every caller.
"""

import random
import threading
import time

from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils import errors

_BREAKER_TRIPS = obs_metrics.counter(
    "edl_breaker_trips_total", "circuit-breaker closed/half-open -> "
    "open transitions")


class Deadline(object):
    """An absolute point in time shared by a whole call tree.

    ``Deadline(None)`` is the unbounded deadline: ``remaining()`` is
    None, ``expired()`` is False, ``sleep`` always sleeps fully.
    """

    __slots__ = ("_at",)

    def __init__(self, seconds=None):
        self._at = None if seconds is None else time.monotonic() + seconds

    @classmethod
    def after(cls, seconds):
        return cls(seconds)

    def remaining(self, cap=None):
        """Seconds left (None = unbounded), optionally capped — the
        shape RPC ``timeout=`` parameters want: never longer than the
        layer's own default, never longer than the caller's budget."""
        if self._at is None:
            return cap
        rem = self._at - time.monotonic()
        return rem if cap is None else min(rem, cap)

    def expired(self):
        return self._at is not None and time.monotonic() >= self._at

    def check(self, what=""):
        if self.expired():
            raise errors.DeadlineExceededError(
                "deadline exceeded%s" % (": " + what if what else ""))

    def sleep(self, seconds):
        """Sleep up to ``seconds`` but never past the deadline; returns
        False iff the deadline is exhausted (before or by the sleep)."""
        rem = self.remaining()
        if rem is not None and rem <= 0:
            return False
        time.sleep(seconds if rem is None else min(seconds, rem))
        return not self.expired()

    def union(self, other):
        """The earlier of two deadlines (budget intersection)."""
        if other is None or other._at is None:
            return self
        if self._at is None:
            return other
        return self if self._at <= other._at else other

    def __repr__(self):
        if self._at is None:
            return "Deadline(unbounded)"
        return "Deadline(%.3fs left)" % (self._at - time.monotonic())


FOREVER = Deadline(None)


class RetryPolicy(object):
    """Jittered exponential backoff + retryable-error classification.

    delay(attempt) = min(max_delay, base_delay * multiplier**(attempt-1))
                     scaled by uniform(1-jitter, 1+jitter)

    ``max_attempts=None`` retries until the deadline (callers without a
    deadline and without max_attempts retry forever — by design for
    supervision loops; everything user-facing passes one or both).
    ``seed`` pins the jitter stream for deterministic tests.
    """

    def __init__(self, max_attempts=None, base_delay=0.1, max_delay=5.0,
                 multiplier=2.0, jitter=0.5, retry_on=(errors.EdlError,),
                 give_up_on=(errors.StopError,), seed=None):
        self.max_attempts = max_attempts
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retry_on = tuple(retry_on)
        self.give_up_on = tuple(give_up_on)
        self._rng = random.Random(seed) if seed is not None else random
        self._lock = threading.Lock()

    def delay(self, attempt):
        """Backoff before attempt ``attempt + 1`` (attempt counts from 1)."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** max(0, attempt - 1))
        if self.jitter:
            with self._lock:  # Random isn't thread-safe for our seeded use
                u = self._rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)
            d *= u
        return max(0.0, d)

    def sleep(self, attempt, deadline=None):
        """Back off after failed attempt ``attempt``. Returns False iff
        retrying is pointless: attempts exhausted or deadline spent."""
        if self.max_attempts is not None and attempt >= self.max_attempts:
            return False
        d = self.delay(attempt)
        if deadline is None:
            time.sleep(d)
            return True
        return deadline.sleep(d)

    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy. Keyword-only:
        ``deadline`` (a :class:`Deadline`) and ``on_retry(attempt, exc)``.

        Raises the last error when attempts run out; raises
        DeadlineExceededError (carrying the last error as ``__cause__``)
        when the budget runs out.
        """
        deadline = kwargs.pop("deadline", None)
        on_retry = kwargs.pop("on_retry", None)
        attempt = 0
        while True:
            attempt += 1
            if deadline is not None:
                deadline.check(getattr(fn, "__name__", "call"))
            try:
                return fn(*args, **kwargs)
            except self.give_up_on:
                raise
            except self.retry_on as e:
                if not self.sleep(attempt, deadline):
                    if (deadline is not None and deadline.expired()
                            and (self.max_attempts is None
                                 or attempt < self.max_attempts)):
                        raise errors.DeadlineExceededError(
                            "%s: deadline exceeded after %d attempts; "
                            "last error: %r"
                            % (getattr(fn, "__name__", "call"), attempt,
                               e)) from e
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)


class CircuitBreaker(object):
    """Per-key circuit breaker (key = endpoint, typically).

    closed → (``failure_threshold`` consecutive failures) → open →
    (``reset_timeout`` elapses) → half-open: up to ``half_open_max``
    concurrent probes allowed; one success closes, one failure re-opens
    (and restarts the reset clock).

    State is bounded: :meth:`prune` drops keys outside the live set, so
    endpoint churn (teachers coming and going for days) cannot grow the
    map without bound — the regression the old ``_recent_failures``
    timestamp map had.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold=3, reset_timeout=5.0,
                 half_open_max=1, clock=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self.half_open_max = int(half_open_max)
        self._clock = clock
        self._lock = threading.Lock()
        self._s = {}  # key -> [state, consecutive_failures, opened_at, probes]

    def _cell(self, key):
        cell = self._s.get(key)
        if cell is None:
            cell = self._s[key] = [self.CLOSED, 0, 0.0, 0]
        return cell

    def allow(self, key):
        """May a call to ``key`` proceed right now? An allowed call in
        half-open counts as a probe until success/failure is recorded."""
        with self._lock:
            cell = self._cell(key)
            if cell[0] == self.CLOSED:
                return True
            if cell[0] == self.OPEN:
                if self._clock() - cell[2] < self.reset_timeout:
                    return False
                cell[0] = self.HALF_OPEN
                cell[3] = 0
            if cell[3] >= self.half_open_max:
                return False
            cell[3] += 1
            return True

    def record_success(self, key):
        with self._lock:
            self._s[key] = [self.CLOSED, 0, 0.0, 0]

    def record_failure(self, key):
        with self._lock:
            cell = self._cell(key)
            cell[1] += 1
            tripped = cell[0] == self.HALF_OPEN \
                or cell[1] >= self.failure_threshold
            if tripped:
                reopened = cell[0] == self.HALF_OPEN
                self._s[key] = [self.OPEN, 0, self._clock(), 0]
        if tripped:
            # outside the lock: the timeline write takes its own lock
            _BREAKER_TRIPS.inc()
            obs_events.emit("breaker.open", key=str(key),
                            reopened=reopened)

    def state(self, key):
        with self._lock:
            cell = self._s.get(key)
            return self.CLOSED if cell is None else cell[0]

    def keys(self):
        with self._lock:
            return list(self._s)

    def prune(self, keep):
        """Forget every key not in ``keep`` — bounds state to the live
        endpoint set."""
        keep = set(keep)
        with self._lock:
            for key in [k for k in self._s if k not in keep]:
                del self._s[key]
