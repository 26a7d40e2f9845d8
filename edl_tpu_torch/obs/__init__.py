"""Observability for the port: metrics, traces, events.

The port carries the three leaf modules the RPC substrate and the
teacher server instrument themselves with, the SLO evaluator, and the
planes the elastic trainer uses: the goodput ledger, the crash flight
recorder and the metrics publisher. Health and the autopilot come with
the launcher (ROADMAP A18).

- :mod:`edl_tpu_torch.obs.metrics` — process-local registry of
  labeled counters / gauges / histograms, served through the
  ``__metrics__`` RPC method of every RpcServer.
- :mod:`edl_tpu_torch.obs.trace` — trace-context propagation over the
  RPC envelope and a bounded span ring exportable as Chrome trace.
- :mod:`edl_tpu_torch.obs.events` — the structured event timeline.
- :mod:`edl_tpu_torch.obs.ledger` — the per-process
  :class:`~edl_tpu_torch.obs.ledger.TimeLedger` of where each
  wall-clock second went (compute, ckpt_block, restore, ...).
- :mod:`edl_tpu_torch.obs.flight` — the crash flight recorder's
  ``blackbox/v1`` artifact on any death path.
- :mod:`edl_tpu_torch.obs.publisher` — periodic publication of the
  registry into the coordination store.
"""

from edl_tpu_torch.obs import events, flight, ledger, metrics, trace
from edl_tpu_torch.obs.events import EVENTS, emit
from edl_tpu_torch.obs.flight import FlightRecorder
from edl_tpu_torch.obs.ledger import LEDGER, TimeLedger
from edl_tpu_torch.obs.metrics import (REGISTRY, counter, gauge, histogram,
                                       mirror_stats, set_enabled)
from edl_tpu_torch.obs.publisher import MetricsPublisher

__all__ = ["metrics", "trace", "events", "ledger", "flight", "REGISTRY",
           "EVENTS", "LEDGER", "counter", "gauge", "histogram",
           "mirror_stats", "set_enabled", "emit", "TimeLedger",
           "FlightRecorder", "MetricsPublisher"]
