"""ServeScaler: the SLO-driven teacher-fleet autoscaler.

The port's copy of ``edl_tpu/serve/scaler.py``. The serving-plane
sibling of the JAX package's ``obs.autopilot.Autopilot``, with the same
safety model — every decision is a journaled ``action/v1``
record in a bounded store journal, gated by per-kind cooldowns, burst
bounds, and streak hysteresis so the engine provably never flaps, with
a global ``off|dry|on`` mode where dry-run journals the IDENTICAL
action stream while applying nothing.

Signals, folded from the fleet's ``stats()`` RPCs each tick (the
admission controller enriches every teacher's stats with queue depth,
projected wait, and shed counters — serve/admission.py):

- **occupancy** — mean compiled-batch fill across live teachers;
- **slot occupancy** — worst KV-slot fill across decode engines
  (``decode_slot_frac`` from serve/decode_engine.py): a fleet can be
  decode-bound with near-empty predict batches, so slot pressure is a
  first-class overload signal;
- **queue pressure** — worst projected queue wait vs the predict SLO
  (fallback: queue fill fraction when no service estimate exists yet);
- **sheds** — any admission shed since the last tick is overload by
  definition (the front door is already refusing work), decode-phase
  sheds included;
- **burn** — the ``predict_p99`` multi-window burn-rate severity from
  :class:`edl_tpu_torch.obs.slo.BurnRateEvaluator`, fed cumulative
  (total, bad) predict-latency counts by the host.

Scale-out fires after ``out_streak`` CONSECUTIVE overloaded ticks
(bounded by ``max_teachers``); scale-in after ``in_streak`` consecutive
idle ticks (zero sheds, low occupancy, no burn; bounded by
``min_teachers``) and decommissions the least-loaded teacher through
the drain-safe protocol (serve/drain.py) — the actuator owns the
actual drain, so a dry-run never touches the fleet. Opposite signals
reset each other's streaks, and each kind's cooldown spans several
in-streaks worth of ticks, so out→in oscillation cannot sustain.

Like the autopilot, this module is an obs-adjacent LEAF: the
coordination client and both actuators are injected, robustness
imports are lazy.
"""

import json
import os
import threading
import time
from collections import deque

from edl_tpu_torch.obs import slo as slo_mod
from edl_tpu_torch.utils.logger import logger

#: store service key for the serve-plane action journal
SERVICE_SERVE = "serve"

#: the single bounded action journal under SERVICE_SERVE
#: (leader-written, last-writer-wins — one scaler per fleet)
JOURNAL_KEY = "journal"

ENV_VAR = "EDL_TPU_SERVE_SCALER"
MODE_OFF = "off"
MODE_DRY = "dry"
MODE_ON = "on"

ACTION_KINDS = ("scale_out", "scale_in")


def mode_from_env(value=None):
    """``on`` applies, ``dry`` journals without applying, anything
    else is ``off`` (the default — zero behavior unless enabled)."""
    raw = (os.environ.get(ENV_VAR, MODE_OFF) if value is None else value)
    raw = str(raw).strip().lower()
    if raw in (MODE_ON, "1", "true", "enabled"):
        return MODE_ON
    if raw in (MODE_DRY, "dry_run", "dryrun"):
        return MODE_DRY
    return MODE_OFF


class ServeScaler(object):
    """``tick(stats_by_endpoint, predict_sample=None, now=None)`` is
    the whole runtime surface: the host (bench, launcher, or test)
    scrapes each teacher's ``stats()`` and calls it once per interval.
    The policy is a pure fold over the stats — identical inputs
    produce an identical decision stream regardless of mode, which is
    exactly what the dry≡on parity criterion asserts.

    Actuators (injected, optional — a decision without its actuator is
    journaled ``outcome: failed``):

    - ``scale_out_fn()`` — start one more teacher; returns its
      endpoint (or any JSON-able receipt).
    - ``scale_in_fn(endpoint)`` — drain-safe decommission of
      ``endpoint`` (serve.drain.decommission or equivalent).
    """

    def __init__(self, coord, pod_id, mode=None, interval=10.0,
                 scale_out_fn=None, scale_in_fn=None,
                 min_teachers=1, max_teachers=8,
                 occupancy_high=0.8, occupancy_low=0.3,
                 queue_wait_frac_high=1.0, out_streak=2, in_streak=4,
                 cooldowns=None, burst=3, burst_window_s=None,
                 burn_short_s=None, burn_long_s=None,
                 journal_cap=64, retry=None, clock=time.time):
        self._coord = coord
        self._pod_id = pod_id
        self._mode = mode_from_env(mode)
        self._interval = float(interval)
        self._scale_out_fn = scale_out_fn
        self._scale_in_fn = scale_in_fn
        self._min = max(0, int(min_teachers))
        self._max = max(self._min, int(max_teachers))
        self._occ_high = float(occupancy_high)
        self._occ_low = float(occupancy_low)
        self._wait_frac_high = float(queue_wait_frac_high)
        self._out_streak_need = max(1, int(out_streak))
        self._in_streak_need = max(1, int(in_streak))
        self._cooldowns = {
            # scale-in waits out several idle streaks AND any recent
            # scale-out, so a grow→shrink→grow loop cannot sustain
            "scale_out": 3.0 * self._interval,
            "scale_in": 6.0 * self._interval,
        }
        self._cooldowns.update(cooldowns or {})
        self._burst = max(1, int(burst))
        self._burst_window_s = (float(burst_window_s)
                                if burst_window_s is not None
                                else 60.0 * self._interval)
        self._journal_cap = max(1, int(journal_cap))
        self._clock = clock
        if retry is None:
            # lazy: robustness imports obs; serve sits next to obs
            from edl_tpu_torch.robustness.policy import RetryPolicy
            retry = RetryPolicy(max_attempts=3, base_delay=0.05,
                                max_delay=0.5, jitter=0.0)
        self._retry = retry
        # the predict_p99 burn evaluator; windows default to a few
        # ticks so the bench's compressed timeline still burns
        self._burn = slo_mod.BurnRateEvaluator(
            slos=[s for s in slo_mod.DEFAULT_SLOS
                  if s.name == "predict_p99"],
            short_window=(burn_short_s if burn_short_s is not None
                          else 3.0 * self._interval),
            long_window=(burn_long_s if burn_long_s is not None
                         else 12.0 * self._interval),
            clock=clock)

        self._lock = threading.Lock()
        self._seq = None  # lazily anchored on the stored journal
        self._actions = []
        self._last_action_ts = {}
        self._recent = {k: deque() for k in ACTION_KINDS}
        self._out_streak = 0
        self._in_streak = 0
        self._last_shed_total = None

    # -- public surface ----------------------------------------------------

    @property
    def mode(self):
        return self._mode

    def actions(self):
        """Records journaled by THIS engine instance (in order)."""
        with self._lock:
            return list(self._actions)

    def tick(self, stats_by_endpoint, predict_sample=None, now=None):
        """One policy pass. ``stats_by_endpoint``: {endpoint: the
        teacher's ``stats()`` dict}. ``predict_sample``: optional
        cumulative ``(total, bad)`` predict-latency counts for the
        burn evaluator. Returns the ``action/v1`` records journaled
        this tick. Never raises — the host loop must survive any
        policy bug."""
        if self._mode == MODE_OFF:
            return []
        now = self._clock() if now is None else now
        try:
            return self._tick(stats_by_endpoint or {}, predict_sample,
                              now)
        except Exception:  # noqa: BLE001 — policy bug must not kill host
            logger.exception("serve scaler tick failed")
            return []

    # -- signal fold -------------------------------------------------------

    @staticmethod
    def _signals(stats_by_endpoint):
        live = {ep: s for ep, s in stats_by_endpoint.items()
                if isinstance(s, dict) and not s.get("draining")}
        occs, wait_fracs, shed_total = [], [], 0
        slot_fracs, reuse_fracs = [], []
        for s in live.values():
            occs.append(float(s.get("occupancy") or 0.0))
            slo_ms = s.get("slo_ms")
            wait = s.get("projected_wait_ms")
            if slo_ms and wait is not None:
                wait_fracs.append(float(wait) / float(slo_ms))
            elif s.get("queue_frac") is not None:
                wait_fracs.append(float(s["queue_frac"]))
            shed_total += int(s.get("shed_total") or 0)
            # the decode plane (serve/decode_engine.py): KV-slot
            # occupancy is the decode-phase analog of batch fill, and
            # its sheds are part of the same overload signal
            if s.get("decode_slot_frac") is not None:
                slot_fracs.append(float(s["decode_slot_frac"]))
            adm = s.get("decode_admission")
            if isinstance(adm, dict):
                shed_total += int(adm.get("shed_total") or 0)
            # prefix reuse discounts the prefill work a nominal token
            # of traffic actually costs — journaled so a scale decision
            # under cache-heavy traffic is explainable from the record
            pfx = s.get("decode_prefix")
            if isinstance(pfx, dict) and pfx.get("enabled"):
                reuse_fracs.append(float(pfx.get("reuse_frac") or 0.0))
        return {
            "teachers": len(live),
            "occupancy": (sum(occs) / len(occs)) if occs else 0.0,
            "wait_frac": max(wait_fracs) if wait_fracs else 0.0,
            "slot_frac": max(slot_fracs) if slot_fracs else 0.0,
            "prefix_reuse_frac": (sum(reuse_fracs) / len(reuse_fracs)
                                  if reuse_fracs else 0.0),
            "shed_total": shed_total,
        }

    def _tick(self, stats_by_endpoint, predict_sample, now):
        sig = self._signals(stats_by_endpoint)
        n = sig["teachers"]
        severity = None
        if predict_sample is not None:
            total, bad = predict_sample
            self._burn.observe("predict_p99", total, bad, now=now)
        for row in self._burn.evaluate(now=now):
            severity = row["severity"]
        prev_shed = self._last_shed_total
        self._last_shed_total = sig["shed_total"]
        sheds_delta = (0 if prev_shed is None
                       else max(0, sig["shed_total"] - prev_shed))

        overloaded = (sig["occupancy"] >= self._occ_high
                      or sig["slot_frac"] >= self._occ_high
                      or sig["wait_frac"] >= self._wait_frac_high
                      or sheds_delta > 0
                      or severity is not None)
        idle = (sig["occupancy"] <= self._occ_low
                and sig["slot_frac"] <= self._occ_low
                and sig["wait_frac"] < 0.5 * self._wait_frac_high
                and sheds_delta == 0
                and severity is None)

        if overloaded:
            self._out_streak += 1
            self._in_streak = 0
        elif idle:
            self._in_streak += 1
            self._out_streak = 0
        else:
            # hysteresis dead band: neither signal, both streaks decay
            self._out_streak = 0
            self._in_streak = 0

        why = ("occupancy %.2f, slots %.2f, wait %.2fx slo, reuse %.2f, "
               "%d sheds this tick, burn %s, %d teachers"
               % (sig["occupancy"], sig["slot_frac"], sig["wait_frac"],
                  sig["prefix_reuse_frac"], sheds_delta,
                  severity or "ok", n))
        cause = {"signals": sig, "sheds_delta": sheds_delta,
                 "burn_severity": severity}

        if (self._out_streak >= self._out_streak_need and n < self._max
                and self._gate_ok("scale_out", now)):
            self._out_streak = 0
            outcome, attempts, error, result = self._apply(
                "scale_out", self._scale_out_fn)
            reason = ("overloaded for %d consecutive ticks (%s); "
                      "scaling out to %d teachers"
                      % (self._out_streak_need, why, n + 1))
            return [self._record("scale_out", "fleet", reason, cause,
                                 outcome, attempts, error, result, now,
                                 extra={"teachers": n,
                                        "decision": "grow"})]

        if (self._in_streak >= self._in_streak_need and n > self._min
                and self._gate_ok("scale_in", now)):
            victim = self._victim(stats_by_endpoint)
            if victim is None:
                return []
            self._in_streak = 0
            outcome, attempts, error, result = self._apply(
                "scale_in", self._scale_in_fn, victim)
            reason = ("idle for %d consecutive ticks (%s); drain-safe "
                      "decommission of %s"
                      % (self._in_streak_need, why, victim))
            return [self._record("scale_in", victim, reason, cause,
                                 outcome, attempts, error, result, now,
                                 extra={"teachers": n,
                                        "decision": "shrink"})]
        return []

    @staticmethod
    def _victim(stats_by_endpoint):
        """Deterministic scale-in choice: least-loaded live teacher,
        endpoint order breaking ties — identical inputs pick the
        identical victim (the dry≡on parity contract)."""
        live = sorted((float(s.get("occupancy") or 0.0),
                       float(s.get("pending_rows") or 0), ep)
                      for ep, s in stats_by_endpoint.items()
                      if isinstance(s, dict) and not s.get("draining"))
        return live[0][2] if live else None

    # -- gating / apply / journal (the autopilot contract) -----------------

    def _gate_ok(self, kind, now):
        last = self._last_action_ts.get(kind)
        if last is not None and now - last < self._cooldowns.get(kind,
                                                                 0.0):
            return False
        ring = self._recent[kind]
        while ring and now - ring[0] > self._burst_window_s:
            ring.popleft()
        return len(ring) < self._burst

    def _apply(self, kind, actuator, *args):
        """Dry-run short-circuits (nothing applies); otherwise the
        actuator runs under the standard retry policy. The actuator
        itself owns any chaos exposure — scale-in's drain fires
        ``serve.drain`` inside the teacher (serve/drain.py), so a
        drill hits the REAL drain path, not a scaler shim."""
        if self._mode == MODE_DRY:
            return "dry_run", 0, None, None
        if actuator is None:
            return "failed", 0, "no actuator bound for %r" % kind, None
        attempts = [0]

        def once():
            attempts[0] += 1
            return actuator(*args)

        try:
            result = self._retry.call(once)
            if result is not None and not isinstance(
                    result, (str, int, float, bool, list, dict)):
                result = repr(result)
            return "applied", attempts[0], None, result
        except Exception as e:  # noqa: BLE001 — journaled, not raised
            return "failed", attempts[0], repr(e), None

    def _next_seq(self):
        # caller holds self._lock; anchor once on the stored journal so
        # a re-elected host's scaler continues the sequence
        if self._seq is None:
            self._seq = 0
            try:
                for a in load_actions(self._coord):
                    self._seq = max(self._seq, int(a.get("seq", 0)))
            except Exception:  # noqa: BLE001 — fresh store: start at 0
                pass
        self._seq += 1
        return self._seq

    def _record(self, kind, target, reason, cause, outcome, attempts,
                error, result, now, extra=None):
        with self._lock:
            seq = self._next_seq()
            action = {
                "schema": "action/v1",
                "id": "serve-act-%d" % seq,
                "seq": seq,
                "ts": now,
                "kind": kind,
                "mode": ("dry_run" if self._mode == MODE_DRY
                         else "applied"),
                "actor": self._pod_id,
                "target": target,
                "reason": reason,
                "cause": cause,
                "outcome": outcome,
                "attempts": attempts,
                "error": error,
                "result": result,
            }
            if extra:
                action.update(extra)
            self._actions.append(action)
            self._last_action_ts[kind] = now
            self._recent[kind].append(now)
        try:
            raw = self._coord.get_value(SERVICE_SERVE, JOURNAL_KEY) \
                or "[]"
            journal = json.loads(raw)
            if not isinstance(journal, list):
                journal = []
        except Exception:  # noqa: BLE001 — corrupt/absent: restart it
            journal = []
        journal = journal[-(self._journal_cap - 1):]
        journal.append(action)
        try:
            self._coord.set_server_permanent(SERVICE_SERVE, JOURNAL_KEY,
                                             json.dumps(journal))
        except Exception as e:  # noqa: BLE001 — best-effort by contract
            logger.debug("serve scaler journal write failed: %r", e)
        logger.warning("serve scaler %s: %s %s -> %s%s", self._mode,
                       kind, target, outcome,
                       (" (%s)" % error) if error else "")
        return action


def load_actions(coord, service=SERVICE_SERVE):
    """The stored serve-plane ``action/v1`` journal (oldest first)."""
    try:
        raw = coord.get_value(service, JOURNAL_KEY)
        if not raw:
            return []
        journal = json.loads(raw)
        if not isinstance(journal, list):
            return []
        return [a for a in journal
                if isinstance(a, dict) and a.get("schema") == "action/v1"]
    except Exception as e:  # noqa: BLE001 — absent store == no journal
        logger.debug("serve scaler journal read failed: %r", e)
        return []
