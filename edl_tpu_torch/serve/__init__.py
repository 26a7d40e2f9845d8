"""SLO-guarded serving plane of the port (``edl_tpu/serve``):

- :mod:`~edl_tpu_torch.serve.admission` — bounded admission queue,
  rate limiting and queue-wait-projection shedding with a typed
  OverloadedError, in front of the teacher server;
- :mod:`~edl_tpu_torch.serve.scaler` — the SLO-driven autoscaler;
- :mod:`~edl_tpu_torch.serve.drain` — the drain-safe decommission
  protocol;
- :mod:`~edl_tpu_torch.serve.decode_engine` +
  :mod:`~edl_tpu_torch.serve.kv_cache` — the autoregressive plane: a
  slot KV cache with continuous batching at decode-step granularity,
  fronted by per-phase admission (``DecodeAdmission``).
"""

from edl_tpu_torch.serve.admission import AdmissionController, \
    DecodeAdmission
from edl_tpu_torch.serve.decode_engine import DecodeEngine
from edl_tpu_torch.serve.drain import decommission
from edl_tpu_torch.serve.kv_cache import SlotKvCache
from edl_tpu_torch.serve.scaler import ServeScaler, load_actions

__all__ = ["AdmissionController", "DecodeAdmission", "DecodeEngine",
           "ServeScaler", "SlotKvCache", "decommission", "load_actions"]
