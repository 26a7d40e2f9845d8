"""Drain-safe teacher decommission: zero stranded requests by protocol.

The scale-in actuator. Order matters, and each step exists to close
one loss window:

1. **Stop advertising** — ``register.drain()`` revokes the TTL lease
   and never re-registers, so discovery stops handing the endpoint to
   NEW clients immediately.
2. **Let the discovery TTL lapse** — clients that already hold the
   endpoint keep it until their next table refresh; waiting out the
   TTL (plus one heartbeat) means no client still routes here when
   admission closes.
3. **Finish in-flight work** — ``teacher.drain()`` flips admission to
   ``draining`` (new predicts get a typed OverloadedError the reader
   requeues elsewhere — a race with a stale table loses nothing) and
   waits for the device queue and every admitted row to resolve.
4. **Exit** — ``teacher.stop()`` tears the RPC server down only after
   the queue is provably empty.

The ``serve.drain`` fault point fires inside ``teacher.drain()``
(teacher_server.py), so a chaos drill hits the real drain path; the
teacher-kill-mid-predict drill (tests/test_serve.py) SIGKILL-semantics
-stops the server instead and asserts the reader's requeue still
loses zero predicts — the protocol is the optimization, the reader's
delivery guarantee is the backstop.
"""

from edl_tpu_torch.robustness.policy import Deadline
from edl_tpu_torch.utils.logger import logger


def decommission(teacher, register=None, ttl_s=0.0, deadline_s=30.0):
    """Run the four-step drain protocol. Returns the teacher's drain
    report (``{"drained": bool, "pending_rows": int, ...}``) with the
    protocol steps annotated. Raises nothing on a slow drain — a
    ``drained: False`` report is the caller's signal that in-flight
    work outlived ``deadline_s`` (the journaled outcome, not an
    exception mid-actuator)."""
    deadline = Deadline(deadline_s)
    endpoint = teacher.endpoint
    if register is not None:
        register.drain()
    if ttl_s:
        # step 2: wait out the discovery TTL so no live table names us
        Deadline(min(float(ttl_s), deadline.remaining() or float(ttl_s))
                 ).sleep(float(ttl_s))
    report = teacher.drain(deadline_s=deadline.remaining(cap=deadline_s))
    teacher.stop()
    report["ttl_waited_s"] = float(ttl_s)
    report["advertised"] = register is not None
    logger.info("decommissioned teacher %s: %r", endpoint, report)
    return report
