"""Serving plane of the port: admission control in front of the teacher
server (bounded queue, rate limit, queue-wait-projection shedding with
a typed OverloadedError). The decode engine and KV cache come with the
``lm_teacher`` slice."""

from edl_tpu_torch.serve.admission import AdmissionController

__all__ = ["AdmissionController"]
