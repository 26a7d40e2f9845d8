"""The elastic-event timeline: structured, causally-linked records.

Every state transition an operator asks "what happened?" about —
resize phases, leader elections, store failovers, breaker trips,
fault-plane injections — lands here as one bounded-ring record:

    {"id": 17, "ts": <unix>, "pid": ..., "kind": "resize.restore",
     "cause": 15, "trace_id": <active trace or None>, "attrs": {...}}

``cause`` is the id of the event that triggered this one (same
process), forming explicit causal chains; ``trace_id`` links an event
into an RPC trace when one is active. The ring replaces the one-off
``resize_timing_r<rank>`` JSON blobs as the substrate: the trainer
still derives its per-resize record from these events, and the fleet
publisher ships the ring to the coordination store where ``job_stats``
merges all pods into one chronological timeline.

Emission also feeds ``edl_events_total{kind}`` in the metrics
registry, so event RATES (breaker trips/min, elections/hour) are
queryable without reading the ring.
"""

import itertools
import os
import threading
import time
from collections import deque

from edl_tpu_torch.obs import metrics, trace

_EVENTS_TOTAL = metrics.counter(
    "edl_events_total", "timeline events emitted", labels=("kind",))


class EventLog(object):
    def __init__(self, capacity=2048):
        self._lock = threading.Lock()
        self._ring = deque(maxlen=int(capacity))
        self._ids = itertools.count(1)

    def emit(self, kind, cause=None, **attrs):
        """Record one event; returns its id (pass as ``cause=`` to a
        follow-up event to link them). Near-free when metrics are
        disabled process-wide."""
        if not metrics.enabled():
            return 0
        ctx = trace.current()
        event = {"id": next(self._ids), "ts": time.time(),
                 "pid": os.getpid(), "kind": kind, "cause": cause,
                 "trace_id": ctx[0] if ctx else None,
                 "attrs": attrs}
        with self._lock:
            self._ring.append(event)
        _EVENTS_TOTAL.labels(kind).inc()
        return event["id"]

    def snapshot(self, since_id=0, kinds=None):
        """Events with id > ``since_id`` (oldest first), optionally
        filtered to a kind prefix tuple/set."""
        with self._lock:
            out = [dict(e) for e in self._ring if e["id"] > since_id]
        if kinds:
            kinds = tuple(kinds)
            out = [e for e in out
                   if any(e["kind"].startswith(k) for k in kinds)]
        return out

    def last(self, kind=None):
        """Most recent event (of ``kind``, when given) or None."""
        with self._lock:
            for e in reversed(self._ring):
                if kind is None or e["kind"] == kind:
                    return dict(e)
        return None

    def clear(self):
        with self._lock:
            self._ring.clear()


#: THE process event timeline
EVENTS = EventLog()


def emit(kind, cause=None, **attrs):
    return EVENTS.emit(kind, cause=cause, **attrs)


def merge_timelines(per_pod):
    """Merge per-pod event lists into one chronological fleet timeline;
    each event gains a ``pod`` field. ``per_pod`` is
    ``{pod_key: [event, ...]}``."""
    merged = []
    for pod, events in per_pod.items():
        for e in events or ():
            e = dict(e)
            e["pod"] = pod
            merged.append(e)
    merged.sort(key=lambda e: (e.get("ts") or 0, e.get("id") or 0))
    return merged
