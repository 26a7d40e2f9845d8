"""Goodput accounting: where every wall-clock second actually went.

The health plane can say *that* a pod is slow; this module says *where the time
goes* — the precondition for Pollux-style goodput scheduling (OSDI
'21) and the fair-share arbiter ROADMAP item #2 presupposes. Two
layers:

- :class:`TimeLedger` — a per-process state machine classifying every
  wall-clock second into EXCLUSIVE states (:data:`STATES`): exactly
  one state owns the clock at any instant, so the per-state totals sum
  to elapsed time and "goodput %" is well-defined as
  ``compute / total``. The trainer step loop, checkpoint drain, both
  resize paths, the elastic reader's consumer wait, and the launcher
  barrier each mark their boundaries; everything unclaimed is
  ``idle``. Accrued seconds land in the
  ``edl_time_seconds_total{state}`` counter family, so the totals ride
  the ordinary ``obs_pub/v1`` publication for free.
- :class:`GoodputMerger` — the leader-side streaming merger
  (HealthMonitor-hosted): per-pod cumulative counters from the
  published docs, counter-reset re-anchored exactly like the health
  detectors (a restarted pod's counters re-zero; a negative delta
  must re-anchor, never subtract), folded into one fleet
  ``goodput/v1`` document under ``SERVICE_HEALTH`` with goodput %,
  ranked badput attribution, and per-pod spreads. The SLO burn-rate
  evaluator consumes the same cumulative (total, badput) pair as its
  denominator (the ``goodput`` SLO kind in :mod:`edl_tpu_torch.obs.slo`).

Cost model: one :meth:`TimeLedger.transition` is a clock read + one
short lock + one float add; the ``edl_time_seconds_total`` registry
counters catch up lazily in :meth:`TimeLedger.flush` (publisher tick),
keeping the registry entirely off the hot path. With the
``EDL_TPU_OBS`` kill switch off a transition is one global load +
branch. The ``ledger`` section of ``obs_bench`` measures exactly this
on/off delta on a synthetic step loop (<1% criterion).

Threading: the ledger models the TRAINING thread's wall clock. Scopes
(:meth:`TimeLedger.state`) nest via a stack — a drain inside a live
resize accrues ``ckpt_block`` and returns to ``resize_pause`` — but
background threads (async checkpoint writers, publishers) must NOT
push states; their concurrency is not this thread's lost time.
"""

import json
import threading
import time

from edl_tpu_torch.obs import metrics
from edl_tpu_torch.utils.logger import logger

#: value of controller.constants.SERVICE_HEALTH, inlined so obs stays
#: a leaf package (guarded by a test against drift)
SERVICE_HEALTH = "health"

#: the fleet goodput doc's key under SERVICE_HEALTH (leader-written,
#: last-writer-wins — the same contract as health.HEALTH_KEY)
GOODPUT_KEY = "goodput"

#: the exclusive states, in display order. ``compute`` is goodput;
#: everything else is attributed badput; ``idle`` is the default owner
#: of any second no instrumentation point claimed.
STATES = ("compute", "data_wait", "embed_wait", "ckpt_block",
          "resize_pause", "restore", "barrier_wait", "idle")

GOODPUT_STATE = "compute"

_TIME_TOTAL = metrics.counter(
    "edl_time_seconds_total",
    "wall-clock seconds attributed per exclusive ledger state",
    labels=("state",))


class _Scope(object):
    """Context manager returned by :meth:`TimeLedger.state`."""

    __slots__ = ("_ledger", "_name")

    def __init__(self, ledger, name):
        self._ledger = ledger
        self._name = name

    def __enter__(self):
        self._ledger.push(self._name)
        return self

    def __exit__(self, *exc):
        self._ledger.pop()
        return False


class TimeLedger(object):
    """Exclusive wall-clock state machine (see module docstring).

    ``transition(state)`` replaces the CURRENT state (step-boundary
    marks: the step loop flips to ``compute`` once per step);
    ``push``/``pop`` (or the ``state()`` scope) nest a temporary state
    over the current one (waits inside a step). Totals accrue lazily:
    time is charged to the owning state whenever the machine is
    touched, and :meth:`flush` closes the open interval so a snapshot
    (publisher tick, final dump) sees everything up to "now"."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._stack = ["idle"]
        self._mark = None  # clock value at the last accrual, lazy-armed
        self._totals = {s: 0.0 for s in STATES}
        # pre-bound counter children: label resolution off the hot path
        self._children = {s: _TIME_TOTAL.labels(s) for s in STATES}
        # counter seconds already pushed to the registry; the delta is
        # synced in flush() so the hot path pays exactly one lock
        self._synced = {s: 0.0 for s in STATES}

    def _accrue(self, now):
        # caller holds the lock
        if self._mark is not None:
            dt = now - self._mark
            if dt > 0:
                self._totals[self._stack[-1]] += dt
        self._mark = now

    def _sync_counters(self):
        # caller holds the lock; registry counters catch up to _totals
        for state, total in self._totals.items():
            delta = total - self._synced[state]
            if delta > 0:
                self._children[state].inc(delta)
                self._synced[state] = total

    def transition(self, state):
        """Make ``state`` the current owner of the clock (top of the
        stack is replaced, nesting depth unchanged)."""
        if not metrics.enabled():
            return
        with self._lock:
            self._accrue(self._clock())
            self._stack[-1] = state

    def push(self, state):
        """Nest ``state`` over the current one until :meth:`pop`."""
        if not metrics.enabled():
            return
        with self._lock:
            self._accrue(self._clock())
            self._stack.append(state)

    def pop(self):
        """Return to the state active before the matching push."""
        if not metrics.enabled():
            return
        with self._lock:
            self._accrue(self._clock())
            if len(self._stack) > 1:
                self._stack.pop()

    def state(self, name):
        """``with ledger.state("ckpt_block"):`` — push/pop scope."""
        return _Scope(self, name)

    def current(self):
        with self._lock:
            return self._stack[-1]

    def flush(self):
        """Charge the open interval to the current state and push the
        accrued seconds into the ``edl_time_seconds_total`` registry
        counters (publisher tick / final dump hook); the state machine
        itself is unchanged."""
        if not metrics.enabled():
            return
        with self._lock:
            if self._mark is None:
                return  # never engaged: a supervisor process's ledger
                # must not manufacture idle time out of publisher ticks
            self._accrue(self._clock())
            self._sync_counters()

    def totals(self):
        """``{state: seconds}`` including the open interval. Reads do
        not require the kill switch — disabled periods simply never
        accrued."""
        with self._lock:
            if metrics.enabled() and self._mark is not None:
                self._accrue(self._clock())
            return dict(self._totals)

    def reset(self):
        """Zero the per-instance totals and return to ``idle`` (bench
        arcs and tests; the registry counters are monotonic and stay)."""
        with self._lock:
            self._stack = ["idle"]
            self._mark = None
            self._totals = {s: 0.0 for s in STATES}
            self._synced = {s: 0.0 for s in STATES}


#: THE process ledger — every in-tree instrumentation point marks this
#: one instance, keeping the exclusive-states invariant process-wide.
LEDGER = TimeLedger()


def pod_states(obs_doc):
    """Extract ``{state: cumulative_seconds}`` from one ``obs_pub/v1``
    doc (or None when the pod publishes no ledger counters — absent is
    not zero: old pods predate the ledger)."""
    fam = (((obs_doc.get("metrics") or {}).get("metrics") or {})
           .get(_TIME_TOTAL.name))
    if not fam:
        return None
    out = {}
    for s in fam.get("series") or ():
        state = (s.get("labels") or {}).get("state")
        if state:
            out[state] = float(s.get("value") or 0.0)
    return out or None


class GoodputMerger(object):
    """Leader-side streaming accumulation of per-pod ledger counters.

    Counters are cumulative-per-incarnation: they start at zero with
    the process and re-zero on restart. :meth:`update` therefore
    re-anchors on any backwards total (the health detectors' idiom) —
    the restarted incarnation's doc is again a delta from zero, so it
    is folded in whole; only the dead incarnation's never-republished
    tail is lost, which is exactly the information that died with it."""

    def __init__(self):
        self._pods = {}  # pod -> {"last": {state: v}|None, "acc": {...}}

    def update(self, pod, states):
        """Fold one pod's cumulative ``{state: seconds}`` sample in."""
        cell = self._pods.setdefault(pod, {"last": None, "acc": {}})
        last = cell["last"]
        if last is not None \
                and sum(states.values()) < sum(last.values()):
            last = None  # counters went backwards: pod restarted
        acc = cell["acc"]
        for state, value in states.items():
            prev = (last or {}).get(state, 0.0)
            delta = value - prev
            if delta > 0:
                acc[state] = acc.get(state, 0.0) + delta
        cell["last"] = dict(states)

    def update_from_docs(self, docs):
        """Fold every pod's ``obs_pub/v1`` doc in. Pods without ledger
        counters are skipped, not zeroed — and so are all-zero ones: a
        process that never engaged its ledger (the launcher supervisor)
        still carries the zero-valued series, but has no time to
        attribute and must not pad the fleet report."""
        for pod, doc in sorted(docs.items()):
            states = pod_states(doc)
            if states and any(states.values()):
                self.update(pod, states)

    def forget(self, pod):
        self._pods.pop(pod, None)

    def pods(self):
        return sorted(self._pods)

    def fleet_cumulative(self):
        """``(total_s, badput_s)`` summed over every pod's accumulated
        history — the cumulative pair the SLO burn-rate evaluator
        consumes as its denominator."""
        total = badput = 0.0
        for cell in self._pods.values():
            for state, sec in cell["acc"].items():
                total += sec
                if state != GOODPUT_STATE:
                    badput += sec
        return total, badput

    def doc(self, now=None):
        """The fleet ``goodput/v1`` document."""
        now = time.time() if now is None else now
        pods_out = {}
        fleet_states = {}
        pcts = []
        for pod, cell in sorted(self._pods.items()):
            acc = cell["acc"]
            total = sum(acc.values())
            good = acc.get(GOODPUT_STATE, 0.0)
            pct = (100.0 * good / total) if total > 0 else None
            badput = {s: v for s, v in acc.items()
                      if s != GOODPUT_STATE and v > 0}
            top = max(badput, key=badput.get) if badput else None
            pods_out[pod] = {
                "total_s": round(total, 3),
                "goodput_s": round(good, 3),
                "goodput_pct": (round(pct, 2) if pct is not None
                                else None),
                "top_badput": top,
                "states": {s: round(v, 3)
                           for s, v in sorted(acc.items())},
            }
            if pct is not None:
                pcts.append(pct)
            for state, sec in acc.items():
                fleet_states[state] = fleet_states.get(state, 0.0) + sec
        total = sum(fleet_states.values())
        good = fleet_states.get(GOODPUT_STATE, 0.0)
        ranked = sorted(((s, v) for s, v in fleet_states.items()
                         if s != GOODPUT_STATE and v > 0),
                        key=lambda kv: -kv[1])
        spread = {}
        for state in sorted(fleet_states):
            vals = [cell["acc"].get(state, 0.0)
                    for cell in self._pods.values()]
            if vals:
                spread[state] = {"min_s": round(min(vals), 3),
                                 "max_s": round(max(vals), 3)}
        return {
            "schema": "goodput/v1",
            "ts": now,
            "pods_reporting": sorted(self._pods),
            "pods": pods_out,
            "fleet": {
                "total_s": round(total, 3),
                "goodput_s": round(good, 3),
                "goodput_pct": (round(100.0 * good / total, 2)
                                if total > 0 else None),
                "badput": [{"state": s, "seconds": round(v, 3),
                            "share_pct": round(100.0 * v / total, 2)}
                           for s, v in ranked],
            },
            "spread": {
                "goodput_pct_min": (round(min(pcts), 2) if pcts
                                    else None),
                "goodput_pct_max": (round(max(pcts), 2) if pcts
                                    else None),
                "states": spread,
            },
        }


def resize_payback_s(pause_s, world_from, world_to, goodput_frac):
    """Seconds until a resize pause is repaid by marginal goodput.

    The pause idles all ``world_from`` pods outright, costing
    ``pause_s * world_from`` compute-seconds. After the resize the
    fleet gains ``(world_to - world_from) * goodput_frac``
    compute-seconds per wall-clock second (the marginal pods convert
    wall time into goodput at the fleet's observed rate). The payback
    horizon is cost / gain-rate; the autopilot triggers a scale-out
    only when this falls inside its configured horizon.

    Returns ``inf`` when the resize gains nothing (``world_to <=
    world_from``), when the fleet converts no time into compute
    (``goodput_frac <= 0``), or on a nonsensical negative pause —
    an infinite horizon is an automatic veto."""
    gain = (float(world_to) - float(world_from)) * float(goodput_frac)
    if gain <= 0.0 or pause_s < 0.0 or goodput_frac <= 0.0:
        return float("inf")
    return float(pause_s) * float(world_from) / gain


def load_goodput(coord, service=SERVICE_HEALTH):
    """Latest ``goodput/v1`` doc from the store, or None."""
    try:
        raw = coord.get_value(service, GOODPUT_KEY)
        if not raw:
            return None
        doc = json.loads(raw)
        if isinstance(doc, dict) and doc.get("schema") == "goodput/v1":
            return doc
    except Exception as e:  # noqa: BLE001 — absent store == no doc
        logger.debug("goodput read failed: %r", e)
    return None
