"""Per-plane SLO declarations + multi-window burn-rate evaluation.

An :class:`Slo` names an objective over one of the fleet's planes and
comes in two shapes:

- **latency**: a compliance target over a histogram family ("95% of
  ``edl_train_step_ms`` observations <= 1000ms"). Good/bad counts come
  straight from the published bucket counts — the threshold is snapped
  to the nearest bucket bound at or above it, so evaluation costs one
  pass over ~18 ints and needs no raw samples.
- **event**: a compliance target over durations derived from the causal
  event timeline ("90% of resizes complete <= 30s"), paired from a
  start/end event kind per pod.
- **goodput**: a compliance target over the time ledger's wall-clock
  attribution ("80% of fleet seconds are compute"). The HealthMonitor
  feeds the evaluator the JAX package's ``obs.ledger.GoodputMerger``'s
  cumulative ``(total_s, badput_s)`` pair — the ledger IS the
  denominator, so burning this SLO means the fleet is paying wall
  clock to something other than training.

:class:`BurnRateEvaluator` implements the SRE multi-window burn-rate
alert: it keeps a ring of ``(ts, total, bad)`` samples per SLO (fed
with CUMULATIVE totals each tick by the HealthMonitor) and computes

    burn = (bad_delta / total_delta) / (1 - target)

over a short and a long window. A burn of 1.0 spends the error budget
exactly at the sustainable rate; the evaluator raises ``critical``
when BOTH windows burn >= ``fast_burn`` (default 14.4 — budget gone in
~2 days at a 30-day horizon) and ``warn`` when both >= ``slow_burn``
(default 6.0). Requiring both windows is the standard guard: the long
window alone alerts on stale history, the short window alone on a
transient spike. Counter resets (a pod restart re-zeroes its
histograms) clear the ring instead of producing negative deltas.

This module is stdlib-only — the obs package stays an import LEAF.
"""

import threading
import time
from collections import deque

class Slo(object):
    """One declared objective. Use :meth:`latency` / :meth:`event`."""

    __slots__ = ("name", "plane", "kind", "family", "labels",
                 "threshold_ms", "threshold_s", "start_kind", "end_kind",
                 "target", "description")

    def __init__(self, name, plane, kind, target, family=None, labels=None,
                 threshold_ms=None, threshold_s=None, start_kind=None,
                 end_kind=None, description=""):
        if kind not in ("latency", "event", "goodput"):
            raise ValueError("unknown SLO kind %r" % kind)
        self.name = name
        self.plane = plane
        self.kind = kind
        self.target = float(target)
        self.family = family
        self.labels = dict(labels or {})
        self.threshold_ms = threshold_ms
        self.threshold_s = threshold_s
        self.start_kind = start_kind
        self.end_kind = end_kind
        self.description = description

    @classmethod
    def latency(cls, name, plane, family, threshold_ms, target,
                labels=None, description=""):
        return cls(name, plane, "latency", target, family=family,
                   labels=labels, threshold_ms=float(threshold_ms),
                   description=description)

    @classmethod
    def event(cls, name, plane, start_kind, end_kind, threshold_s, target,
              description=""):
        return cls(name, plane, "event", target, start_kind=start_kind,
                   end_kind=end_kind, threshold_s=float(threshold_s),
                   description=description)

    @classmethod
    def goodput(cls, name, plane, target, description=""):
        """``target`` is the compliant fraction of wall-clock seconds
        (good = ledger ``compute``; bad = every other state)."""
        return cls(name, plane, "goodput", target,
                   description=description)

    def declare(self):
        """JSON-able declaration (embedded in every evaluation row)."""
        out = {"name": self.name, "plane": self.plane, "kind": self.kind,
               "target": self.target, "description": self.description}
        if self.kind == "latency":
            out.update(family=self.family, threshold_ms=self.threshold_ms)
            if self.labels:
                out["labels"] = dict(self.labels)
        elif self.kind == "event":
            out.update(start_kind=self.start_kind, end_kind=self.end_kind,
                       threshold_s=self.threshold_s)
        return out

    def __repr__(self):
        return "Slo(%s/%s %s target=%g)" % (self.plane, self.name,
                                            self.kind, self.target)


#: the default objectives, one per plane the repo ships today. Bounds
#: and targets are tuning knobs (docs/observability.md "Health & SLOs");
#: they are deliberately loose — an SLO that pages on CI noise trains
#: operators to ignore it.
DEFAULT_SLOS = (
    Slo.latency("step_p95", "train", "edl_train_step_ms",
                threshold_ms=2500.0, target=0.95,
                description="95% of train steps <= 2.5s"),
    Slo.latency("predict_p99", "distill", "edl_rpc_client_call_ms",
                threshold_ms=500.0, target=0.99,
                labels={"method": "predict"},
                description="99% of teacher predict RPCs <= 500ms"),
    Slo.event("resize_downtime", "elastic",
              start_kind="resize.coordinated_stop", end_kind="resize.resumed",
              threshold_s=30.0, target=0.90,
              description="90% of elastic resizes resume <= 30s"),
    Slo.event("failover_downtime", "store",
              start_kind="store.stepdown", end_kind="store.leader_elected",
              threshold_s=5.0, target=0.90,
              description="90% of store failovers re-elect <= 5s"),
    Slo.goodput("train_goodput", "train", target=0.80,
                description="80% of fleet wall-clock seconds are "
                            "compute (time-ledger attribution)"),
)


def labels_match(series_labels, want):
    """True when every wanted label is present with a matching value."""
    series_labels = series_labels or {}
    return all(str(series_labels.get(k)) == str(v)
               for k, v in want.items())


def hist_good_bad(fam_entry, threshold_ms, labels=None):
    """(total, bad) observation counts for one histogram family entry
    (snapshot or fleet-merged shape — both carry non-cumulative
    ``buckets`` aligned with ``bounds`` + implicit +Inf). ``bad`` is
    everything ABOVE the effective threshold, which is ``threshold_ms``
    snapped UP to the nearest bucket bound (bucket-resolution is the
    published contract; a threshold past the last bound means only
    +Inf observations are bad)."""
    bounds = list(fam_entry.get("bounds") or ())
    idx = len(bounds) - 1
    for i, b in enumerate(bounds):
        if b >= threshold_ms:
            idx = i
            break
    total = bad = 0
    for s in fam_entry.get("series", ()):
        if labels and not labels_match(s.get("labels"), labels):
            continue
        buckets = s.get("buckets") or ()
        total += s.get("count", 0)
        bad += sum(buckets[idx + 1:])
    return total, bad


def pair_event_durations(events, start_kind, end_kind):
    """Pair start/end event kinds per pod into durations. ``events`` is
    an iterable of merged-timeline records (each may carry a ``pod``
    field; same-pod pairing, chronological). Returns
    ``[{"pod", "duration_s", "start_id", "end_id", "end_ts"}, ...]``;
    an end with no prior unmatched start is dropped (its start happened
    before the observation window), a start with no end is left pending
    (still in flight — the caller sees it next tick)."""
    open_starts = {}
    out = []
    for e in sorted(events, key=lambda e: (e.get("ts") or 0,
                                           e.get("id") or 0)):
        pod = e.get("pod")
        kind = e.get("kind")
        if kind == start_kind:
            open_starts[pod] = e
        elif kind == end_kind:
            start = open_starts.pop(pod, None)
            if start is not None:
                out.append({
                    "pod": pod,
                    "duration_s": max(0.0, (e.get("ts") or 0)
                                      - (start.get("ts") or 0)),
                    "start_id": start.get("id"),
                    "end_id": e.get("id"),
                    "end_ts": e.get("ts"),
                })
    return out


class BurnRateEvaluator(object):
    """Streaming multi-window burn-rate evaluation over cumulative
    (total, bad) counts per SLO. Thread-safe; one instance per
    HealthMonitor."""

    def __init__(self, slos=DEFAULT_SLOS, short_window=300.0,
                 long_window=3600.0, fast_burn=14.4, slow_burn=6.0,
                 clock=time.time):
        self.slos = tuple(slos)
        self._short = float(short_window)
        self._long = float(long_window)
        self._fast = float(fast_burn)
        self._slow = float(slow_burn)
        self._clock = clock
        self._lock = threading.Lock()
        # slo name -> deque of (ts, total, bad); bounded by the long
        # window in observe()
        self._rings = {}

    def by_name(self, name):
        for s in self.slos:
            if s.name == name:
                return s
        return None

    def last_sample(self, name):
        """Most recent (ts, total, bad) cumulative sample for ``name``,
        or None before the first observe()."""
        with self._lock:
            ring = self._rings.get(name)
            return ring[-1] if ring else None

    def observe(self, name, total, bad, now=None):
        """Feed one cumulative sample for ``name``. A total that went
        BACKWARDS (fleet restart re-zeroed the counters) clears the
        ring — a negative delta must not read as negative burn."""
        now = self._clock() if now is None else now
        with self._lock:
            ring = self._rings.setdefault(name, deque())
            if ring and total < ring[-1][1]:
                ring.clear()
            ring.append((now, float(total), float(bad)))
            horizon = now - self._long - 1.0
            while len(ring) > 1 and ring[0][0] < horizon:
                ring.popleft()

    def _window_burn(self, ring, now, window, budget):
        """(burn, total_delta, bad_delta) over [now-window, now]."""
        if len(ring) < 2:
            return None, 0.0, 0.0
        cutoff = now - window
        base = ring[0]
        for sample in ring:
            if sample[0] <= cutoff:
                base = sample
            else:
                break
        head = ring[-1]
        d_total = head[1] - base[1]
        d_bad = head[2] - base[2]
        if d_total <= 0:
            return None, d_total, d_bad
        return (d_bad / d_total) / budget, d_total, d_bad

    def evaluate(self, now=None):
        """One row per declared SLO:
        ``{"slo": <declaration>, "burn_short", "burn_long",
        "short_window_s", "long_window_s", "severity": None|"warn"|
        "critical", "budget": 1-target}`` (burns are None with no
        traffic in the window — no traffic is not an SLO violation)."""
        now = self._clock() if now is None else now
        rows = []
        with self._lock:
            for slo in self.slos:
                budget = max(1e-9, 1.0 - slo.target)
                ring = self._rings.get(slo.name, ())
                b_short, _, _ = self._window_burn(ring, now, self._short,
                                                  budget)
                b_long, d_total, d_bad = self._window_burn(
                    ring, now, self._long, budget)
                severity = None
                if b_short is not None and b_long is not None:
                    if b_short >= self._fast and b_long >= self._fast:
                        severity = "critical"
                    elif b_short >= self._slow and b_long >= self._slow:
                        severity = "warn"
                rows.append({
                    "slo": slo.declare(),
                    "burn_short": (round(b_short, 3)
                                   if b_short is not None else None),
                    "burn_long": (round(b_long, 3)
                                  if b_long is not None else None),
                    "short_window_s": self._short,
                    "long_window_s": self._long,
                    "window_total": d_total,
                    "window_bad": d_bad,
                    "budget": round(budget, 6),
                    "severity": severity,
                })
        return rows
