"""Robustness layer for the elastic control plane.

Two halves, one contract:

- :mod:`edl_tpu_torch.robustness.faults` — a deterministic, seeded
  fault-injection registry (the "chaos plane"). Named fault points are
  threaded through the RPC transport, the coordination store, and the
  distill discovery layer; tests (or an operator via
  ``EDL_TPU_FAULT_SPEC``) arm faults against those points and the
  schedule is reproducible from the seed.
- :mod:`edl_tpu_torch.robustness.policy` — the unified failure-handling
  vocabulary every control-plane subsystem uses instead of hand-rolled
  sleep loops: :class:`RetryPolicy` (jittered exponential backoff),
  :class:`Deadline` (one budget propagated through nested calls), and
  :class:`CircuitBreaker` (per-endpoint open/half-open/closed).

``tools/check_no_ad_hoc_retries.py`` enforces adoption: control-plane
modules may not grow new raw ``time.sleep`` retry loops.
"""

from edl_tpu_torch.robustness.faults import FaultPlane, plane_from_spec
from edl_tpu_torch.robustness.policy import CircuitBreaker, Deadline, RetryPolicy

__all__ = ["FaultPlane", "plane_from_spec", "CircuitBreaker", "Deadline",
           "RetryPolicy"]
