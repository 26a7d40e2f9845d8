"""Exception taxonomy and the retry-until-timeout resilience idiom.

Reference parity: edl/utils/exceptions.py (17 Edl* types, serialize/deserialize
by class name) and edl/utils/error_utils.py:22-39 (@handle_errors_until_timeout).
"""

import functools
import re as _re


class EdlError(Exception):
    """Base class for all framework errors; retryable by default."""


class DeserializeError(EdlError):
    pass


class ConnectError(EdlError):
    pass


class RpcError(EdlError):
    pass


class NotFoundError(EdlError):
    pass


class LeaseExpiredError(EdlError):
    pass


class KeyExistsError(EdlError):
    pass


class TxnFailedError(EdlError):
    pass


class NotLeaderError(EdlError):
    pass


class BarrierError(EdlError):
    pass


class JobFailedError(EdlError):
    """The job was marked FAILED while this actor was waiting on it."""
    pass


class ClusterChangedError(EdlError):
    pass


class RankError(EdlError):
    pass


class StatusError(EdlError):
    pass


class TrainProcessError(EdlError):
    pass


class DataAccessError(EdlError):
    pass


class FeedSpecError(DataAccessError):
    """A predict feed violates the teacher's declared spec (missing
    feed, batch mismatch, empty, over max_batch). Subclass of
    DataAccessError so the reader's poisoned-task path surfaces it to
    the consumer in order instead of retrying a permanently bad feed.
    ``spec``/``shape`` name the offending feed; both are folded into
    the message so they survive the wire (only the message string is
    serialized)."""

    def __init__(self, message, spec=None, shape=None):
        if spec is not None:
            message = "%s [spec=%s shape=%s]" % (message, spec, shape)
        super(FeedSpecError, self).__init__(message)
        self.spec = spec if spec is not None else self._parse("spec")
        self.shape = shape if shape is not None else self._parse("shape")

    def _parse(self, field):
        # rebuilt from the wire: recover the field from the message
        m = _re.search(r"\[spec=(\S+) shape=(.*?)\]$", str(self))
        if m is None:
            return None
        return m.group(1) if field == "spec" else m.group(2)


class OverloadedError(EdlError):
    """The serving tier shed this request — admission queue full, rate
    limited, past its deadline, projected queue wait over the SLO, or
    the server is draining. Retryable AGAINST ANOTHER SERVER: the
    reader requeues the task and opens the endpoint's breaker so it
    backs off instead of hammering. Carries a ``retry_after_s=`` hint
    in the message (messages are all that survive serialization)."""

    @classmethod
    def shed(cls, reason, retry_after_s=None):
        msg = "overloaded: %s" % reason
        if retry_after_s is not None:
            msg += " (retry_after_s=%.3f)" % max(0.0, retry_after_s)
        return cls(msg)

    @property
    def retry_after_s(self):
        m = _re.search(r"retry_after_s=([0-9.]+)", str(self))
        if m is None:
            return None
        try:
            return float(m.group(1))
        except ValueError:
            return None


class DecodeStepError(EdlError):
    """A fused decode step failed for this sequence (device fault mid-
    generation). The sequence's slot has been freed and its partial
    output discarded; the engine itself keeps running — only the
    sequences that were active in the faulted step see this error.
    Retryable by resubmitting the prompt (generation restarts from the
    prefill; there is no partial-state resume)."""


class DataEndError(EdlError):
    """All data has been consumed for this epoch."""


class StopError(EdlError):
    """A component was asked to stop; not retryable."""


class TimeoutError_(EdlError):
    """Raised when handle_errors_until_timeout gives up."""


class DeadlineExceededError(TimeoutError_):
    """A Deadline budget (edl_tpu_torch.robustness.policy) ran out. Subclass
    of TimeoutError_ so existing timeout handling catches it."""


class CircuitOpenError(EdlError):
    """A CircuitBreaker is open for the target endpoint; the call was
    refused without touching the wire."""


class PreemptedError(EdlError):
    """The trainer was preempted (SIGTERM) and saved an emergency
    checkpoint; the process should exit so the restart resumes from it."""


class StaleStateError(EdlError):
    """A peer StateServer no longer holds the requested snapshot version
    (a newer save superseded it mid-fetch). The fetcher drops the peer
    and falls back — alternates first, then the shared FS."""


class PeerRestoreError(EdlError):
    """No usable peer path for a placed restore (no live peers, none at
    the requested version, or the FS per-span fallback is unavailable);
    the caller restores wholesale from the shared FS."""


class RedundancyError(EdlError):
    """The erasure-coded parity rung could not rebuild the requested
    state (no live holders, insufficient/stale shards, decode
    failure). Carries a ``reason`` attribute when known (stale_version,
    insufficient_partners); the caller falls through to the FS rung —
    the parity tier is strictly best-effort."""


class EmbedLookupError(EdlError):
    """A sharded embedding gather could not complete after the retry
    budget (owner dead, persistent fault, or a shape-corrupt response
    — a short/zero-row answer is promoted to this error, NEVER padded
    with silent zeros). The training step that needed the rows fails
    loudly instead of learning on fabricated embeddings."""


class EmbedWritebackError(EdlError):
    """A sparse embedding optimizer write-back could not be applied
    after the retry budget. The owner either applied the update or
    never saw it (the writeback RPC is one fused subtract); the caller
    must treat the step as failed rather than proceed with the table
    and cache divergent."""


class LiveResizeError(EdlError):
    """The in-place live resize could not complete (out of scope,
    drain/reshard failure, rolled back). The trainer is left on its
    OLD mesh, numerically untouched; the caller falls back to the
    stop-resume ladder."""


_NAME_TO_CLS = None


def _name_to_cls():
    global _NAME_TO_CLS
    if _NAME_TO_CLS is None:
        _NAME_TO_CLS = {
            c.__name__: c for c in list(globals().values())
            if isinstance(c, type) and issubclass(c, EdlError)
        }
    return _NAME_TO_CLS


def serialize_error(exc):
    """Encode an exception as (class_name, detail) for the RPC envelope."""
    return type(exc).__name__, str(exc)


def deserialize_error(name, detail):
    """Rebuild an exception from its class name; unknown names → RpcError."""
    cls = _name_to_cls().get(name)
    if cls is None:
        return RpcError("%s: %s" % (name, detail))
    return cls(detail)


def handle_errors_until_timeout(func):
    """Retry ``func`` on EdlError every ``interval`` seconds until ``timeout``.

    The wrapped function must be called with a ``timeout`` kwarg (seconds);
    optional ``interval`` kwarg (default 1s). StopError is never retried.
    Mirrors the universal resilience idiom of the reference
    (edl/utils/error_utils.py:22-39, which used a 3s fixed interval).
    """

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        # local import: robustness.policy imports this module
        from edl_tpu_torch.robustness.policy import Deadline, RetryPolicy
        timeout = kwargs.pop("timeout")
        interval = kwargs.pop("interval", 1.0)
        policy = RetryPolicy(base_delay=interval, max_delay=interval,
                             multiplier=1.0, jitter=0.25)
        deadline = Deadline(timeout)
        attempt = 0
        while True:
            attempt += 1
            try:
                return func(*args, **kwargs)
            except StopError:
                raise
            except EdlError as e:
                if deadline.expired():
                    raise TimeoutError_(
                        "%s timed out after %ss; last error: %r"
                        % (func.__name__, timeout, e))
                # clipped to the remaining budget; one final attempt
                # runs after the last (possibly shortened) backoff
                policy.sleep(attempt, deadline)

    return wrapper
