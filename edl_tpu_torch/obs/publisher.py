"""Periodic fleet publication: registry + event snapshots → the store.

Each process runs (at most) one :class:`MetricsPublisher`; every
``interval`` seconds it writes one JSON document to the coordination
store under ``SERVICE_METRICS`` (service name passed in — this module
stays import-leaf) keyed ``obs_<pod_key>``:

    {"schema": "obs_pub/v1", "key": ..., "ts": ...,
     "metrics": <registry snapshot>, "events": [<new events only>]}

Events are published incrementally (id watermark), so the store holds
the pod's recent timeline without rewriting history on every tick.
``job_stats`` reads every ``obs_*`` key and renders the fleet view
(metrics merged via :func:`edl_tpu_torch.obs.metrics.merge_snapshots`,
events via :func:`edl_tpu_torch.obs.events.merge_timelines`).

Publication is strictly best-effort: a store hiccup is logged at
debug and retried next tick — observability must never take down the
plane it observes.
"""

import json
import threading
import time

from edl_tpu_torch.obs import events as events_mod
from edl_tpu_torch.obs import ledger as ledger_mod
from edl_tpu_torch.obs import metrics as metrics_mod
from edl_tpu_torch.utils.logger import logger

#: value of controller.constants.SERVICE_METRICS, inlined so obs stays
#: a leaf package (guarded by a test against drift)
SERVICE_METRICS = "metrics"

KEY_PREFIX = "obs_"


class MetricsPublisher(object):
    """``coord``: a CoordClient (anything with ``set_server_permanent``).
    ``pod_key``: stable per-process identity (pod id, or pod id +
    rank). ``max_events``: cap on events carried per published doc —
    the store value stays bounded even after an event storm."""

    def __init__(self, coord, pod_key, interval=10.0,
                 registry=None, events=None, max_events=512,
                 service=SERVICE_METRICS):
        self._coord = coord
        self._key = KEY_PREFIX + str(pod_key)
        self._interval = float(interval)
        self._registry = registry or metrics_mod.REGISTRY
        self._events = events or events_mod.EVENTS
        self._max_events = int(max_events)
        self._service = service
        self._since = 0
        self._stop = threading.Event()
        self._thread = None

    def publish_once(self):
        """One publication tick; returns the published doc (also used
        directly by tests and by the trainer's final flush)."""
        fresh = self._events.snapshot(since_id=self._since)
        if len(fresh) > self._max_events:
            fresh = fresh[-self._max_events:]
        # close the time ledger's open interval so the shipped
        # edl_time_seconds_total counters cover right up to this tick
        ledger_mod.LEDGER.flush()
        # "ts" is the staleness detector's liveness signal (obs/health):
        # a doc whose ts stops advancing means the publisher is dead or
        # partitioned, even though the stale doc itself stays readable
        doc = {"schema": "obs_pub/v1", "key": self._key,
               "ts": time.time(),
               "metrics": self._registry.snapshot(),
               "events": fresh}
        # publish_obs routes through the relay tree when the client has
        # one attached (subtree aggregation into obs_agg/v1 — one store
        # write per subtree per tick); plain clients and the fakes in
        # tests take the permanent-put path unchanged
        sink = getattr(self._coord, "publish_obs", None)
        if sink is not None:
            sink(self._service, self._key, json.dumps(doc))
        else:
            self._coord.set_server_permanent(self._service, self._key,
                                             json.dumps(doc))
        if fresh:
            self._since = fresh[-1]["id"]
        return doc

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self.publish_once()
            except Exception as e:  # noqa: BLE001 — best-effort by contract
                logger.debug("obs publish failed (will retry): %r", e)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="obs-publisher")
            self._thread.start()
        return self

    def stop(self, final_flush=True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 5)
            self._thread = None
        if final_flush:
            try:
                self.publish_once()
            except Exception as e:  # noqa: BLE001 — best-effort by contract
                logger.debug("obs final flush failed: %r", e)
