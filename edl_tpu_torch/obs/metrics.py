"""Process-local metrics registry: labeled counters, gauges, histograms.

Design constraints, in priority order:

1. **Hot-path cost**: instrumentation sits inside the RPC dispatch
   loop and the data-plane fetch pipeline, so the per-observation path
   is one module-global load (the kill switch), one short lock, one
   float add. Label resolution is the expensive part — hot callers
   pre-bind a child once (``HIST.labels(method)``) and hold the
   handle; ``labels()`` itself is a dict lookup on the common path.
2. **Bounded memory**: every family caps its live label sets
   (``max_series``, default 256). Past the cap, new label sets
   collapse into one ``__overflow__`` series and the registry counts
   the drop — unbounded cardinality (per-batch ids, per-peer
   endpoints on a 10k-pod fleet) degrades, never OOMs.
3. **Two exposition formats** from one store: Prometheus text
   (``prometheus_text()``, for scrapes) and a JSON snapshot
   (``snapshot()``, for the coordination-store fleet publisher and
   ``job_stats`` aggregation).

``EDL_TPU_OBS=0`` (or :func:`set_enabled`\\ (False)) turns every handle
into a near-no-op: one global load + branch, no lock. ``obs_bench``
measures exactly this on/off delta on the data-plane hot loop.
"""

import os
import threading
import time

# THE kill switch. Checked at observation time (not bind time) so
# pre-bound handles in long-lived planes honor a runtime toggle — the
# on/off arcs of obs_bench flip it mid-process.
_ENABLED = os.environ.get("EDL_TPU_OBS", "1") != "0"

#: ms-oriented latency buckets (wire RPCs to checkpoint persists);
#: +Inf is implicit. Bounded at 17 buckets so one histogram series is
#: ~20 floats.
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
                   30000.0)

#: per-family live-series cap (see module docstring, point 2)
MAX_SERIES = 256

_OVERFLOW = "__overflow__"


def set_enabled(flag):
    """Flip the process-wide metrics kill switch; returns the previous
    value (so benches can restore it)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


def enabled():
    return _ENABLED


class _Counter(object):
    """One bound (child) counter series."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount=1.0):
        if not _ENABLED:
            return
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class _Gauge(object):
    """One bound gauge series (set/add semantics)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value):
        if not _ENABLED:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        if not _ENABLED:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)

    @property
    def value(self):
        with self._lock:
            return self._value


class _Histogram(object):
    """One bound histogram series: cumulative-on-read bucket counts,
    sum, count. ``observe`` pays one binary search + two adds."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds):
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        if not _ENABLED:
            return
        bounds = self._bounds
        lo, hi = 0, len(bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._sum += value
            self._count += 1

    def time_ms(self):
        """Context manager observing the block's wall time in ms."""
        return _HistTimer(self)

    def read(self):
        """(cumulative bucket counts incl +Inf, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total_count = self._sum, self._count
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return cum, total_sum, total_count

    def percentile(self, q):
        """Bucket-resolution quantile estimate (upper bound of the
        bucket holding the q-th observation); None when empty."""
        cum, _, count = self.read()
        if not count:
            return None
        rank = q * count
        for i, c in enumerate(cum):
            if c >= rank:
                if i < len(self._bounds):
                    return self._bounds[i]
                return float("inf")
        return float("inf")


class _HistTimer(object):
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._hist.observe((time.monotonic() - self._t0) * 1e3)
        return False


_CHILD_FACTORY = {
    "counter": lambda fam: _Counter(),
    "gauge": lambda fam: _Gauge(),
    "histogram": lambda fam: _Histogram(fam.buckets),
}


class Family(object):
    """One named metric with N label sets (children). An unlabeled
    family proxies the single default child, so ``counter("x").inc()``
    works without a ``labels()`` hop."""

    def __init__(self, registry, kind, name, help="", labelnames=(),
                 buckets=DEFAULT_BUCKETS, max_series=MAX_SERIES):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self.max_series = max_series
        self._registry = registry
        self._lock = threading.Lock()
        self._children = {}  # tuple(labelvalues) -> child
        self._default = None
        if not self.labelnames:
            self._default = _CHILD_FACTORY[kind](self)
            self._children[()] = self._default

    def labels(self, *values, **kv):
        """The bound child for one label set. Accepts positional values
        (in ``labelnames`` order) or keywords. Past ``max_series`` the
        overflow child absorbs new sets (and the registry counts it)."""
        if kv:
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError("%s expects labels %r, got %r"
                             % (self.name, self.labelnames, values))
        child = self._children.get(values)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(values)
            if child is not None:
                return child
            if len(self._children) >= self.max_series:
                self._registry._series_dropped.inc()
                over = (_OVERFLOW,) * len(self.labelnames)
                child = self._children.get(over)
                if child is None:
                    child = _CHILD_FACTORY[self.kind](self)
                    self._children[over] = child
                return child
            child = _CHILD_FACTORY[self.kind](self)
            self._children[values] = child
            return child

    # unlabeled convenience surface -------------------------------------
    def _d(self):
        if self._default is None:
            raise ValueError("%s is labeled (%r); bind with .labels()"
                             % (self.name, self.labelnames))
        return self._default

    def inc(self, amount=1.0):
        self._d().inc(amount)

    def dec(self, amount=1.0):
        self._d().dec(amount)

    def set(self, value):
        self._d().set(value)

    def observe(self, value):
        self._d().observe(value)

    def time_ms(self):
        return self._d().time_ms()

    @property
    def value(self):
        return self._d().value

    def percentile(self, q):
        return self._d().percentile(q)

    def series(self):
        with self._lock:
            return dict(self._children)


class MetricsRegistry(object):
    """Thread-safe family store + the two exposition formats.

    Families are create-once: re-declaring an existing name returns
    the SAME family (declarations live at module scope in every plane,
    and two planes may share a name), but kind/labels must agree.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}  # name -> Family
        self._series_dropped = _Counter()

    def _family(self, kind, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind \
                        or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        "metric %s re-declared as %s%r (was %s%r)"
                        % (name, kind, tuple(labelnames), fam.kind,
                           fam.labelnames))
                return fam
            fam = Family(self, kind, name, help=help,
                         labelnames=labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labels=()):
        return self._family("counter", name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._family("gauge", name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS):
        return self._family("histogram", name, help, labels,
                            buckets=buckets)

    def mirror_stats(self, prefix, stats):
        """Mirror a component's legacy ``stats()`` dict into gauges
        (``<prefix>_<key>``). Numeric scalars only — lists/strings keep
        living in the dict; the point is that ``job_stats`` gets ONE
        uniform snapshot shape instead of special-casing key formats."""
        if not _ENABLED:
            return stats
        for key, val in stats.items():
            if isinstance(val, bool):
                val = int(val)
            if isinstance(val, (int, float)):
                self.gauge("%s_%s" % (prefix, key)).set(val)
        return stats

    def families(self):
        with self._lock:
            return dict(self._families)

    def unregister(self, name):
        with self._lock:
            self._families.pop(name, None)

    @property
    def series_dropped(self):
        return self._series_dropped.value

    # -- exposition -----------------------------------------------------

    def snapshot(self):
        """JSON-able snapshot: the shape the fleet publisher ships and
        job_stats aggregates. Histograms carry non-cumulative bucket
        counts so cross-pod merging is pure elementwise addition."""
        out = {}
        for name, fam in sorted(self.families().items()):
            series = []
            for values, child in sorted(fam.series().items()):
                lbl = dict(zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    with child._lock:
                        series.append({
                            "labels": lbl,
                            "buckets": list(child._counts),
                            "sum": child._sum,
                            "count": child._count})
                else:
                    series.append({"labels": lbl, "value": child.value})
            entry = {"kind": fam.kind, "help": fam.help,
                     "labelnames": list(fam.labelnames),
                     "series": series}
            if fam.kind == "histogram":
                entry["bounds"] = list(fam.buckets)
            out[name] = entry
        return {"schema": "obs_snapshot/v1", "ts": time.time(),
                "pid": os.getpid(), "series_dropped": self.series_dropped,
                "metrics": out}

    def prometheus_text(self):
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        for name, fam in sorted(self.families().items()):
            if fam.help:
                lines.append("# HELP %s %s" % (name, fam.help))
            lines.append("# TYPE %s %s" % (name, fam.kind))
            for values, child in sorted(fam.series().items()):
                lbl = ",".join('%s="%s"' % (n, v.replace('"', '\\"'))
                               for n, v in zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    cum, total_sum, count = child.read()
                    for bound, c in zip(fam.buckets, cum):
                        ble = (lbl + "," if lbl else "") \
                            + 'le="%s"' % _fmt(bound)
                        lines.append("%s_bucket{%s} %d"
                                     % (name, ble, c))
                    binf = (lbl + "," if lbl else "") + 'le="+Inf"'
                    lines.append("%s_bucket{%s} %d" % (name, binf, count))
                    lines.append("%s_sum%s %s"
                                 % (name, "{%s}" % lbl if lbl else "",
                                    _fmt(total_sum)))
                    lines.append("%s_count%s %d"
                                 % (name, "{%s}" % lbl if lbl else "",
                                    count))
                else:
                    lines.append("%s%s %s"
                                 % (name, "{%s}" % lbl if lbl else "",
                                    _fmt(child.value)))
        return "\n".join(lines) + "\n"


def _fmt(v):
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def merge_snapshots(snaps):
    """Aggregate per-pod ``snapshot()`` docs into one fleet view:
    counters and histogram buckets sum elementwise across pods, gauges
    keep per-pod values plus min/max/sum. ``snaps`` is
    ``{pod_key: snapshot_doc}``."""
    fleet = {}
    for pod, snap in sorted(snaps.items()):
        for name, fam in (snap.get("metrics") or {}).items():
            agg = fleet.setdefault(name, {
                "kind": fam["kind"], "help": fam.get("help", ""),
                "labelnames": fam.get("labelnames", []),
                "series": {}})
            if fam["kind"] == "histogram" and "bounds" not in agg:
                agg["bounds"] = fam.get("bounds", [])
            for s in fam.get("series", []):
                key = tuple(sorted((s.get("labels") or {}).items()))
                cell = agg["series"].get(key)
                if fam["kind"] == "histogram":
                    if cell is None:
                        cell = agg["series"][key] = {
                            "labels": dict(key),
                            "buckets": list(s["buckets"]),
                            "sum": s["sum"], "count": s["count"]}
                    else:
                        cell["buckets"] = [
                            a + b for a, b in zip(cell["buckets"],
                                                  s["buckets"])]
                        cell["sum"] += s["sum"]
                        cell["count"] += s["count"]
                elif fam["kind"] == "counter":
                    if cell is None:
                        cell = agg["series"][key] = {
                            "labels": dict(key), "value": 0.0,
                            "pods": {}}
                    cell["value"] += s["value"]
                    cell["pods"][pod] = s["value"]
                else:  # gauge: per-pod values + spread
                    if cell is None:
                        cell = agg["series"][key] = {
                            "labels": dict(key), "pods": {},
                            "min": s["value"], "max": s["value"],
                            "sum": 0.0}
                    cell["pods"][pod] = s["value"]
                    cell["min"] = min(cell["min"], s["value"])
                    cell["max"] = max(cell["max"], s["value"])
                    cell["sum"] += s["value"]
    for agg in fleet.values():
        agg["series"] = list(agg["series"].values())
    return {"schema": "obs_fleet/v1", "pods": sorted(snaps),
            "metrics": fleet}


#: THE process registry — every in-tree plane instruments against it.
REGISTRY = MetricsRegistry()


def counter(name, help="", labels=()):
    return REGISTRY.counter(name, help=help, labels=labels)


def gauge(name, help="", labels=()):
    return REGISTRY.gauge(name, help=help, labels=labels)


def histogram(name, help="", labels=(), buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help=help, labels=labels,
                              buckets=buckets)


def mirror_stats(prefix, stats):
    return REGISTRY.mirror_stats(prefix, stats)
