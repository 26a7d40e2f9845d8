"""Observability for the port: metrics, traces, events.

The port carries the three leaf modules the RPC substrate and the
teacher server instrument themselves with; the fleet-level planes of
``edl_tpu.obs`` (publisher, health, SLO, ledger, flight, autopilot)
come with the elasticity slice.

- :mod:`edl_tpu_torch.obs.metrics` — process-local registry of
  labeled counters / gauges / histograms, served through the
  ``__metrics__`` RPC method of every RpcServer.
- :mod:`edl_tpu_torch.obs.trace` — trace-context propagation over the
  RPC envelope and a bounded span ring exportable as Chrome trace.
- :mod:`edl_tpu_torch.obs.events` — the structured event timeline.
"""

from edl_tpu_torch.obs import events, metrics, trace
from edl_tpu_torch.obs.events import EVENTS, emit
from edl_tpu_torch.obs.metrics import (REGISTRY, counter, gauge, histogram,
                                       mirror_stats, set_enabled)

__all__ = ["metrics", "trace", "events", "REGISTRY", "EVENTS", "counter",
           "gauge", "histogram", "mirror_stats", "set_enabled", "emit"]
