"""Admission control + load shedding for the teacher serving tier.

Clipper-style layered serving: the decision whether a request may even
enter the device queue is made HERE, at the front door, so overload
turns into a fast typed :class:`~edl_tpu_torch.utils.errors.OverloadedError`
(with a retry-after hint) instead of a timeout pile-up deep in the
batching pipeline. Four shed reasons, checked in order:

- ``draining``    — the server is decommissioning (new work must go
                    elsewhere; admitted work is still served).
- ``queue_full``  — the bounded admission queue is at ``max_queue_rows``.
- ``rate_limit``  — the token bucket (``rate`` rows/s, ``burst`` rows)
                    is empty; the hint is the bucket's refill time.
- ``slo``         — queue-wait projection: pending rows × the EWMA of
                    per-row service time exceeds ``slo_ms`` (the
                    predict-latency SLO, default the ``predict_p99``
                    threshold from ``obs/slo.py``). Early shedding —
                    the request would have missed its SLO anyway, so
                    shedding it NOW preserves goodput for the queue.

The projection needs a service-time estimate, so it never sheds before
the first completed batch — a cold server admits freely — and an IDLE
server (zero pending rows) always admits regardless of the estimate:
the EWMA only updates when admitted work completes, so shedding on an
empty queue would freeze a poisoned estimate (a first-batch jit
compile spike) into shedding forever. Per-request
deadlines ride along as ``deadline_ms``; the device loop calls
:meth:`expired` and sheds dead-on-arrival items (their budget elapsed
while queued) rather than burning device time on them.

The ``serve.admit`` fault point fires before the decision, so chaos
drills can delay or fail admission deterministically. Health/stats
RPCs never pass through here — admission guards ``predict`` only, and
the RPC substrate serves plain (non-pipelined) calls inline on the
connection read thread, so observability survives overload by
construction (docs/distill_dataplane.md §"The serving plane").

:class:`DecodeAdmission` is the PER-PHASE variant for the
autoregressive decode engine: a sequence's cost splits into a prefill
phase (one batched forward, governs time-to-first-token) and a decode
phase (one slot for its whole lifetime, governs everyone's inter-token
latency), so the front door projects against BOTH — TTFT for the
prefill queue, ITL for the slot plane — plus slot-occupancy shedding
(docs/distill_dataplane.md §"Autoregressive decode").
"""

import threading
import time

from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.robustness import faults
from edl_tpu_torch.utils import errors

_ADMITTED = obs_metrics.counter(
    "edl_serve_admitted_total", "predict rows admitted to the device "
    "queue")
_SHED = obs_metrics.counter(
    "edl_serve_shed_total", "predict rows shed by admission control",
    labels=("reason",))
_PENDING = obs_metrics.gauge(
    "edl_serve_pending_rows", "admitted rows not yet served")

SHED_REASONS = ("draining", "queue_full", "rate_limit", "slo",
                "deadline")

# decode-phase taxonomy: prefill-phase reasons (queue_full, ttft) speak
# about the waiting queue; decode-phase reasons (slots, itl, deadline)
# speak about the slot plane
DECODE_SHED_REASONS = ("draining", "queue_full", "slots", "ttft", "itl",
                       "deadline")

_DECODE_SHED = obs_metrics.counter(
    "edl_decode_shed_total", "sequences shed by per-phase decode "
    "admission", labels=("reason",))


class AdmissionController(object):
    """Front-door policy for one teacher server. Thread-safe; one
    instance per :class:`TeacherServer`.

    ``max_queue_rows``: bound on admitted-but-unserved rows (the
    admission queue). ``slo_ms``: queue-wait projection threshold
    (None disables projection shedding). ``rate``/``burst``: token
    bucket in rows/s and rows (``rate=None`` disables). ``ewma_alpha``:
    smoothing for the per-row service-time estimate."""

    def __init__(self, max_queue_rows=4096, slo_ms=500.0, rate=None,
                 burst=None, ewma_alpha=0.2, clock=time.monotonic):
        self._max_queue_rows = int(max_queue_rows)
        self._slo_ms = None if slo_ms is None else float(slo_ms)
        self._rate = None if rate in (None, 0) else float(rate)
        self._burst = float(burst) if burst is not None else (
            self._rate if self._rate is not None else 0.0)
        self._alpha = float(ewma_alpha)
        self._clock = clock
        self._lock = threading.Lock()
        self._pending_rows = 0
        self._tokens = self._burst
        self._refill_at = clock()
        self._row_ms = None  # EWMA of per-row device service time
        self._draining = False
        self._admitted = 0
        self._shed = {r: 0 for r in SHED_REASONS}

    # -- policy inputs -----------------------------------------------------

    def set_draining(self, flag=True):
        with self._lock:
            self._draining = bool(flag)

    @property
    def draining(self):
        with self._lock:
            return self._draining

    def _refill_locked(self, now):
        if self._rate is None:
            return
        dt = max(0.0, now - self._refill_at)
        self._refill_at = now
        self._tokens = min(self._burst, self._tokens + dt * self._rate)

    def _projected_wait_ms_locked(self, extra_rows=0):
        if self._row_ms is None:
            return None
        return (self._pending_rows + extra_rows) * self._row_ms

    # -- the decision ------------------------------------------------------

    def admit(self, rows=1):
        """Admit ``rows`` or raise :class:`OverloadedError`. The caller
        MUST balance every successful admit with :meth:`release` (the
        device loop does, on every resolution path)."""
        if faults.PLANE is not None:
            faults.PLANE.fire("serve.admit", rows=rows,
                              pending=self._pending_rows)
        now = self._clock()
        with self._lock:
            if self._draining:
                raise self._shed_locked("draining", retry_after_s=0.1)
            if self._pending_rows + rows > self._max_queue_rows:
                wait = self._projected_wait_ms_locked()
                raise self._shed_locked(
                    "queue_full",
                    retry_after_s=(wait / 1000.0) if wait else 0.2)
            self._refill_locked(now)
            if self._rate is not None and self._tokens < rows:
                deficit = rows - self._tokens
                raise self._shed_locked(
                    "rate_limit", retry_after_s=deficit / self._rate)
            # liveness: an EMPTY queue never SLO-sheds, whatever the
            # estimate says. The EWMA only updates when admitted work
            # completes, so shedding at pending == 0 would freeze a
            # poisoned estimate (e.g. a first-batch jit compile spike)
            # into shedding forever — admitting is the only way the
            # projection can recover.
            if self._slo_ms is not None and self._pending_rows > 0:
                wait = self._projected_wait_ms_locked(extra_rows=rows)
                if wait is not None and wait > self._slo_ms:
                    raise self._shed_locked(
                        "slo",
                        retry_after_s=(wait - self._slo_ms) / 1000.0)
            if self._rate is not None:
                self._tokens -= rows
            self._pending_rows += rows
            self._admitted += rows
        _ADMITTED.inc(rows)
        _PENDING.set(self._pending_rows)
        return now  # admit timestamp, for queue-wait accounting

    def _shed_locked(self, reason, retry_after_s=None):
        self._shed[reason] += 1
        _SHED.labels(reason).inc()
        return errors.OverloadedError.shed(reason,
                                           retry_after_s=retry_after_s)

    def expired(self, admitted_at, deadline_ms):
        """True when a queued item's per-request budget has elapsed
        (the device loop sheds it dead-on-arrival as ``deadline``)."""
        if deadline_ms is None:
            return False
        return (self._clock() - admitted_at) * 1000.0 > float(deadline_ms)

    def shed_expired(self, rows):
        """Account one dead-on-arrival shed (rows already admitted)."""
        with self._lock:
            err = self._shed_locked("deadline")
            self._pending_rows = max(0, self._pending_rows - rows)
        _PENDING.set(self._pending_rows)
        return err

    def release(self, rows, service_s=None):
        """Balance an admit: ``rows`` left the queue. ``service_s``
        (device wall time for the batch that served them) updates the
        per-row EWMA feeding the queue-wait projection."""
        with self._lock:
            self._pending_rows = max(0, self._pending_rows - rows)
            if service_s is not None and rows > 0:
                ms = service_s * 1000.0 / rows
                self._row_ms = ms if self._row_ms is None else (
                    self._alpha * ms + (1.0 - self._alpha) * self._row_ms)
        _PENDING.set(self._pending_rows)

    def idle(self):
        with self._lock:
            return self._pending_rows == 0

    def stats(self):
        with self._lock:
            wait = self._projected_wait_ms_locked()
            return {
                "pending_rows": self._pending_rows,
                "max_queue_rows": self._max_queue_rows,
                "queue_frac": (self._pending_rows
                               / float(self._max_queue_rows)),
                "projected_wait_ms": wait,
                "row_ms": self._row_ms,
                "slo_ms": self._slo_ms,
                "draining": self._draining,
                "admitted": self._admitted,
                "shed": dict(self._shed),
                "shed_total": sum(self._shed.values()),
            }


class DecodeAdmission(object):
    """Per-phase front door for :class:`~edl_tpu_torch.serve.decode_engine.
    DecodeEngine`. Thread-safe; one instance per engine.

    The engine feeds it two service-time estimates (EWMAs it measures on
    the device loop): ``prefill_ms_per_token`` — prefill wall time
    NORMALIZED by the tokens it prefilled (per-seq EWMAs let one long
    prompt poison the projection into shedding short prompts; see
    :meth:`observe_prefill_ms`) — and ``itl_ms`` — wall time of one
    fused decode step, which IS the inter-token latency every occupied
    slot experiences. Admission then checks, in order:

    - ``draining``    — decommissioning; new sequences go elsewhere.
    - ``queue_full``  — the waiting (pre-prefill) queue is at
                        ``max_waiting``.
    - ``slots``       — zero free slots AND the waiting queue already
                        holds ``slot_slack`` sequences (default: one
                        full slot refill) — occupancy shedding: more
                        queueing cannot be served before slots turn
                        over.
    - ``ttft``        — TTFT projection: the prefill WORK ahead of this
                        sequence — queued prefill tokens (waiting
                        suffixes + the remainder of any half-prefilled
                        chunked sequence) plus its own
                        suffix-after-prefix-reuse — times the per-token
                        prefill EWMA exceeds ``ttft_slo_ms``. A prompt
                        whose prefix is cached projects only its
                        suffix, so reuse directly buys admission
                        headroom. Callers without token accounting fall
                        back to the coarse (waiting+1) x EWMA form.
    - ``itl``         — the measured ITL EWMA exceeds ``itl_slo_ms``
                        while slots are occupied: every admitted
                        sequence inflates EVERY resident sequence's
                        ITL, so the decode plane protects residents by
                        shedding arrivals.

    Same liveness rules as :class:`AdmissionController`: a cold engine
    (no estimate yet) admits freely, and an idle one (no waiting work /
    no occupied slots) never projection-sheds — the EWMAs only update
    while work flows, so shedding at idle would freeze a poisoned
    estimate forever. ``deadline`` accounts decode-phase evictions
    (sequence exceeded its budget mid-generation; the device loop calls
    :meth:`shed_evicted`)."""

    def __init__(self, max_waiting=64, ttft_slo_ms=None, itl_slo_ms=None,
                 slot_slack=None, ewma_alpha=0.2, clock=time.monotonic):
        self._max_waiting = int(max_waiting)
        self._ttft_slo_ms = (None if ttft_slo_ms is None
                             else float(ttft_slo_ms))
        self._itl_slo_ms = (None if itl_slo_ms is None
                            else float(itl_slo_ms))
        self._slot_slack = slot_slack  # None -> slots, resolved per call
        self._alpha = float(ewma_alpha)
        self._clock = clock
        self._lock = threading.Lock()
        self._prefill_ms_tok = None  # EWMA, prefill ms PER TOKEN
        self._itl_ms = None          # EWMA, one fused decode step
        self._draining = False
        self._admitted = 0
        self._shed = {r: 0 for r in DECODE_SHED_REASONS}

    def set_draining(self, flag=True):
        with self._lock:
            self._draining = bool(flag)

    @property
    def draining(self):
        with self._lock:
            return self._draining

    # -- estimates (fed by the engine's device loop) -----------------------

    def observe_prefill_ms(self, ms, tokens=1):
        """Fold one prefill interval into the PER-TOKEN EWMA. ``tokens``
        is how many prompt tokens that interval prefilled (the padded
        bucket's valid span; the chunk's valid span under chunking). A
        per-sequence EWMA would let one long prompt inflate the estimate
        ~bucket-fold and poison the TTFT projection into shedding SHORT
        prompts for the next ~1/alpha arrivals; normalizing makes the
        estimate prompt-length-invariant."""
        per_tok = float(ms) / max(1, int(tokens))
        with self._lock:
            self._prefill_ms_tok = (
                per_tok if self._prefill_ms_tok is None else
                self._alpha * per_tok
                + (1.0 - self._alpha) * self._prefill_ms_tok)

    def observe_itl_ms(self, ms):
        with self._lock:
            self._itl_ms = ms if self._itl_ms is None else (
                self._alpha * ms + (1.0 - self._alpha) * self._itl_ms)

    # -- the decision ------------------------------------------------------

    def admit(self, free_slots, waiting, occupied, slots,
              suffix_tokens=None, queued_prefill_tokens=None):
        """Admit one sequence or raise :class:`OverloadedError`.
        ``free_slots``/``occupied``/``slots`` describe the slot plane,
        ``waiting`` the pre-prefill queue, at the instant of arrival.
        ``suffix_tokens`` — tokens THIS prompt still needs prefilled
        after prefix reuse — and ``queued_prefill_tokens`` — prefill
        tokens already ahead of it (waiting suffixes + unprefilled
        chunk remainders) — switch the TTFT projection to token
        accounting; omitted, it falls back to the coarse per-sequence
        form."""
        with self._lock:
            if self._draining:
                raise self._shed_locked("draining", retry_after_s=0.1)
            if waiting >= self._max_waiting:
                raise self._shed_locked(
                    "queue_full", retry_after_s=self._turnover_s_locked())
            slack = (int(slots) if self._slot_slack is None
                     else int(self._slot_slack))
            if free_slots <= 0 and waiting >= slack:
                raise self._shed_locked(
                    "slots", retry_after_s=self._turnover_s_locked())
            if (self._ttft_slo_ms is not None
                    and self._prefill_ms_tok is not None):
                if suffix_tokens is not None:
                    # token-accurate projection; liveness: only sheds
                    # when prefill work is ALREADY queued ahead (an
                    # idle engine admits whatever the estimate says)
                    queued = int(queued_prefill_tokens or 0)
                    ttft = ((queued + int(suffix_tokens))
                            * self._prefill_ms_tok)
                    if queued > 0 and ttft > self._ttft_slo_ms:
                        raise self._shed_locked(
                            "ttft", retry_after_s=(
                                ttft - self._ttft_slo_ms) / 1000.0)
                elif waiting > 0:
                    ttft = (waiting + 1) * self._prefill_ms_tok
                    if ttft > self._ttft_slo_ms:
                        raise self._shed_locked(
                            "ttft", retry_after_s=(
                                ttft - self._ttft_slo_ms) / 1000.0)
            if (self._itl_slo_ms is not None and occupied > 0
                    and self._itl_ms is not None
                    and self._itl_ms > self._itl_slo_ms):
                raise self._shed_locked(
                    "itl", retry_after_s=self._turnover_s_locked())
            self._admitted += 1

    def _turnover_s_locked(self):
        # a slot frees after roughly one sequence tail: O(itl) per token;
        # without an estimate fall back to a fixed polite backoff
        if self._itl_ms is not None:
            return max(0.05, self._itl_ms / 100.0)
        return 0.2

    def _shed_locked(self, reason, retry_after_s=None):
        self._shed[reason] += 1
        _DECODE_SHED.labels(reason).inc()
        return errors.OverloadedError.shed(reason,
                                           retry_after_s=retry_after_s)

    def shed_evicted(self):
        """Account a decode-phase deadline eviction (the device loop
        already freed the slot)."""
        with self._lock:
            return self._shed_locked("deadline")

    def stats(self):
        with self._lock:
            return {
                "max_waiting": self._max_waiting,
                "prefill_ms_per_token": self._prefill_ms_tok,
                "itl_ms": self._itl_ms,
                "ttft_slo_ms": self._ttft_slo_ms,
                "itl_slo_ms": self._itl_slo_ms,
                "draining": self._draining,
                "admitted": self._admitted,
                "shed": dict(self._shed),
                "shed_total": sum(self._shed.values()),
            }
