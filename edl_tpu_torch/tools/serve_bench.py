"""Serving-plane benchmark: admission control, load shedding, and the
SLO-driven autoscaler under an open-loop load generator.

One in-process fleet of deliberately-slow teachers (each device batch
sleeps ``service_ms``, so capacity is ``max_batch / service_ms`` rows/s
per teacher) is driven through a forced cycle::

    low load  ->  overload  ->  shed  ->  scale-out  ->  low load
              ->  drain-safe scale-in

under seeded FaultPlane chaos (``serve.admit`` delays on the admission
path, a ``serve.drain`` delay holding the decommission window open).
The generator is OPEN-LOOP: arrivals are clock-paced and never slow
down because the fleet is struggling — exactly the regime where an
unprotected server builds an unbounded queue and times everything out.

What the record (schema ``serve_bench/v1``) proves:

- at saturation every refused request is a typed ``OverloadedError``
  (``shed.total`` > 0, ``untyped_errors`` == 0, ``timeouts`` == 0 —
  never a timeout pile-up);
- **zero stranded requests**: every request ever sent resolves
  (``stranded`` == 0), including across the scale-in drain
  (``drain.zero_stranded``);
- the ``ServeScaler`` closes the loop: ``scaler.scale_out`` >= 1 from
  the overload phase, ``scaler.scale_in`` >= 1 from the idle phase via
  the drain-safe decommission protocol;
- dry-run parity: replaying the recorded per-tick stats into a
  ``dry``-mode scaler journals the IDENTICAL action stream
  (``dry_parity_ok``);
- a clean fleet at low load produces ZERO scaler actions and ZERO
  sheds (the ``clean`` section).

``stats()`` is scraped over RPC throughout — including while the
device queue is saturated — so ``stats_rpc_ms`` doubles as the proof
that observability RPCs keep strict priority over predict work.

The ``--arc decode`` variant benches the autoregressive decode engine
(serve/decode_engine.py) instead and emits ``decode_bench/v1``:
tokens/s/chip with continuous batching ON (slot engine) vs the serial
per-sequence baseline (the SAME engine pinned to one slot, so the only
lever is decode-step batching), token-identical parity vs the unbatched
``models.gpt.generate``, TTFT p99 vs ITL p99, the per-phase shed
taxonomy (every ``DECODE_SHED_REASONS`` entry forced deterministically),
the int8-teacher logits gap, and a forced scale-out under load — the
``ServeScaler`` reacting to pinned ``decode_slot_frac`` — with zero
stranded sequences across the drain. Two serve-plane-throughput
sub-arcs ride along: ``prefix`` (shared-prefix KV reuse at >= 50%
prompt overlap must cut TTFT >= 1.5x vs cold prefill with
token-identical output and exact ``reuse_hit_tokens`` accounting) and
``chunked`` (under a long-prompt prefill storm, chunked prefill keeps
resident decoders' ITL p99 within 2x the quiet baseline while
monolithic prefill measurably exceeds it — still one step trace).

The decode arc's models, engines and KV caches live on CUDA unless
``--device cpu``; the serve arc's teachers are numpy on the host.

Usage:
    python -m edl_tpu_torch.tools.serve_bench
    python -m edl_tpu_torch.tools.serve_bench --mode full
    python -m edl_tpu_torch.tools.serve_bench --arc decode [--device cpu]

Emits one JSON object (schema "serve_bench/v1" or "decode_bench/v1").
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from edl_tpu_torch.distill.teacher_server import TeacherServer
from edl_tpu_torch.robustness import faults
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.serve import drain as serve_drain
from edl_tpu_torch.serve.admission import AdmissionController, \
    DECODE_SHED_REASONS
from edl_tpu_torch.serve.scaler import ServeScaler, load_actions
from edl_tpu_torch.utils import errors
from edl_tpu_torch.utils.device import resolve_device

#: knob presets; micro must stay tier-1-smoke cheap (~7s wall).
#: row_service_ms is charged PER REAL ROW (not per device batch), so
#: the capacity ceiling — max_batch / (max_batch * row_service_ms) =
#: 1/row_service_ms rows/s — and the admission projection are exact
#: and identical on any host
MODES = {
    "micro": dict(row_service_ms=5.0, max_batch=4, max_queue_rows=64,
                  slo_ms=50.0, interval=0.22, out_streak=2, in_streak=3,
                  max_teachers=2,
                  phases=((1.0, 20.0), (2.2, 500.0), (2.4, 20.0)),
                  clean_s=1.2, clean_rps=20.0),
    "full": dict(row_service_ms=5.0, max_batch=8, max_queue_rows=256,
                 slo_ms=100.0, interval=0.5, out_streak=2, in_streak=4,
                 max_teachers=4,
                 phases=((4.0, 50.0), (8.0, 1000.0), (8.0, 50.0)),
                 clean_s=4.0, clean_rps=50.0),
}

#: pinned RPC worker-pool size for the bench's teachers: admitted
#: predicts BLOCK a pool worker while the device thread serves them,
#: so the pool size bounds how much queue pressure admission can ever
#: see — leaving it at the cpu-derived default would make shed
#: behavior machine-dependent
BENCH_RPC_WORKERS = 32


class _MemCoord(object):
    """The minimal in-process store surface the scaler journal needs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._store = {}

    def set_server_permanent(self, service, server, value):
        with self._lock:
            self._store[(service, server)] = value

    def get_value(self, service, server):
        with self._lock:
            return self._store.get((service, server))

    def get_service(self, service):
        with self._lock:
            return [(srv, v) for (svc, srv), v in self._store.items()
                    if svc == service]


def _make_teacher(row_service_ms, max_batch, max_queue_rows, slo_ms):
    """A slow nop teacher charging ``row_service_ms`` per REAL row (the
    feed is ones, the pad tail zeros — count_nonzero recovers the real
    row count from the padded staging buffer), so the per-row service
    time the admission EWMA learns is constant across coalescing
    regimes and hosts."""

    def fn(feed):
        rows = int(np.count_nonzero(feed["x"]))
        time.sleep(rows * row_service_ms / 1000.0)
        return {"y": np.zeros((len(feed["x"]), 1), np.float32)}

    adm = AdmissionController(max_queue_rows=max_queue_rows,
                              slo_ms=slo_ms)
    return TeacherServer(fn, {"x": ([1], "<f4")}, {"y": ([1], "<f4")},
                         max_batch=max_batch, host="127.0.0.1",
                         adaptive_batch=True, admission=adm)


class _Fleet(object):
    """In-process teacher fleet: the scaler's two actuators plus the
    endpoint list the generator routes over."""

    def __init__(self, make_teacher, timeout=30.0):
        self._make = make_teacher
        self._timeout = timeout
        self._lock = threading.Lock()
        self._teachers = {}
        self._clients = {}
        self._draining = set()
        self.drain_reports = []

    def scale_out(self):
        t = self._make().start()
        with self._lock:
            self._teachers[t.endpoint] = t
            self._clients[t.endpoint] = RpcClient(t.endpoint,
                                                  timeout=self._timeout)
        return t.endpoint

    def live_endpoints(self):
        with self._lock:
            return sorted(ep for ep in self._teachers
                          if ep not in self._draining)

    def client(self, ep):
        with self._lock:
            return self._clients.get(ep)

    def clients(self):
        with self._lock:
            return list(self._clients.items())

    def decommission(self, ep):
        """The drain-safe scale-in actuator: stop routing, settle the
        send race, run the protocol (serve/drain.py), then retire the
        connection."""
        with self._lock:
            teacher = self._teachers.get(ep)
            self._draining.add(ep)
        if teacher is None:
            raise errors.NotFoundError("no teacher at %s" % ep)
        time.sleep(0.05)  # in-flight sends land before admission flips
        report = serve_drain.decommission(teacher, register=None,
                                          ttl_s=0.0, deadline_s=10.0)
        with self._lock:
            self._teachers.pop(ep, None)
            client = self._clients.pop(ep, None)
            self._draining.discard(ep)
        if client is not None:
            client.close()
        self.drain_reports.append(report)
        return report

    def stop_all(self):
        with self._lock:
            teachers = list(self._teachers.values())
            clients = list(self._clients.values())
            self._teachers.clear()
            self._clients.clear()
        for c in clients:
            c.close()
        for t in teachers:
            t.stop()


def _generate(fleet, phases, records, rec_lock):
    """Open-loop arrivals: clock-paced sends, round-robin over the live
    endpoints, never waiting on completions."""
    feed = {"x": np.ones((1, 1), np.float32)}
    rr = 0
    for phase_i, (duration_s, rate_rps) in enumerate(phases):
        period = 1.0 / float(rate_rps)
        t_end = time.monotonic() + float(duration_s)
        nxt = time.monotonic()
        while time.monotonic() < t_end:
            eps = fleet.live_endpoints()
            if eps:
                ep = eps[rr % len(eps)]
                rr += 1
                client = fleet.client(ep)
                rec = {"t0": time.monotonic(), "phase": phase_i,
                       "ep": ep}
                try:
                    rec["fut"] = client.call_async("predict", feed)
                except errors.EdlError as e:
                    rec["err"] = e
                with rec_lock:
                    records.append(rec)
            nxt += period
            delay = nxt - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                nxt = time.monotonic()  # fell behind: no arrival debt


def _classify(rec, err, out):
    phase = out["per_phase"][rec["phase"]]
    if err is None:
        out["ok"] += 1
        phase["ok"] += 1
        out["ok_lat_ms"].append(
            (time.monotonic() - rec["t0"]) * 1e3)
        return
    if isinstance(err, errors.OverloadedError):
        reason = str(err).split("overloaded: ", 1)[-1].split(" (")[0]
        out["shed_by_reason"][reason] = \
            out["shed_by_reason"].get(reason, 0) + 1
        if err.retry_after_s is not None:
            out["shed_with_hint"] += 1
        out["shed"] += 1
        phase["shed"] += 1
        return
    if isinstance(err, (errors.TimeoutError_,)) \
            or "timed out" in str(err):
        out["timeouts"] += 1
    else:
        out["untyped_errors"] += 1


def _collect(records, rec_lock, out, gen_done, grace_s=10.0):
    """Sweep the outstanding futures, timestamping each resolution.
    Anything still unresolved ``grace_s`` after the generator finished
    is STRANDED — the failure mode the drain protocol exists to
    prevent."""
    outstanding = []
    idx = 0
    deadline = None
    while True:
        with rec_lock:
            new = records[idx:]
            idx += len(new)
        outstanding.extend(new)
        still = []
        for rec in outstanding:
            if "err" in rec:
                _classify(rec, rec["err"], out)
            elif rec["fut"].done():
                try:
                    rec["fut"].result(0)
                    _classify(rec, None, out)
                except Exception as e:  # noqa: BLE001 — counted, typed-checked
                    _classify(rec, e, out)
            else:
                still.append(rec)
        outstanding = still
        if gen_done.is_set():
            if deadline is None:
                deadline = time.monotonic() + grace_s
            if not outstanding:
                break
            if time.monotonic() > deadline:
                out["stranded"] = len(outstanding)
                break
        time.sleep(0.002)


def _scaler_loop(scaler, fleet, stop_ev, interval, snapshots, stats_ms):
    """Scrape ``stats()`` over RPC each tick (the strict-priority path),
    convert cumulative occupancy to a per-tick window, tick the scaler,
    and record the exact (now, snapshot) pairs for the dry replay."""
    prev = {}
    while not stop_ev.wait(interval):
        snap = {}
        for ep, client in fleet.clients():
            t0 = time.monotonic()
            try:
                s = client.call("stats", timeout=5.0)
            except errors.EdlError:
                continue  # draining teacher going away mid-scrape
            stats_ms.append((time.monotonic() - t0) * 1e3)
            s = dict(s)
            batches, rows = s.get("batches", 0), s.get("rows", 0)
            pb, pr = prev.get(ep, (0, 0))
            cap = (batches - pb) * s.get("max_batch", 1)
            s["occupancy"] = ((rows - pr) / cap) if cap > 0 else 0.0
            prev[ep] = (batches, rows)
            snap[ep] = s
        now = time.time()
        snapshots.append((now, snap))
        scaler.tick(snap, now=now)


def _pct(values, q):
    if not values:
        return None
    return round(float(np.percentile(np.asarray(values), q)), 3)


def _run_cycle(knobs, seed, phases, scaler_mode="on", chaos=True,
               max_teachers=None):
    """One full generator+scaler cycle; returns the raw accounting."""
    plane = None
    fired = {}
    if chaos:
        plane = faults.FaultPlane(seed=seed)
        admit_f = plane.inject("serve.admit", "delay", seconds=0.001,
                               prob=0.02)
        drain_f = plane.inject("serve.drain", "delay", seconds=0.05)
        plane.install()
    coord = _MemCoord()

    def make_teacher():
        return _make_teacher(knobs["row_service_ms"], knobs["max_batch"],
                             knobs["max_queue_rows"], knobs["slo_ms"])

    fleet = _Fleet(make_teacher)
    interval = knobs["interval"]
    scaler = ServeScaler(
        coord, "serve-bench", mode=scaler_mode, interval=interval,
        scale_out_fn=fleet.scale_out, scale_in_fn=fleet.decommission,
        min_teachers=1,
        max_teachers=(max_teachers if max_teachers is not None
                      else knobs["max_teachers"]),
        occupancy_high=0.8, occupancy_low=0.4,
        out_streak=knobs["out_streak"], in_streak=knobs["in_streak"],
        cooldowns={"scale_out": 2 * interval,
                   "scale_in": 4 * interval})
    out = {"ok": 0, "shed": 0, "timeouts": 0, "untyped_errors": 0,
           "stranded": 0, "shed_with_hint": 0, "shed_by_reason": {},
           "ok_lat_ms": [],
           "per_phase": [{"ok": 0, "shed": 0} for _ in phases]}
    records, rec_lock = [], threading.Lock()
    snapshots, stats_ms = [], []
    gen_done, scaler_stop = threading.Event(), threading.Event()
    try:
        fleet.scale_out()  # the seed teacher
        # warm the service-time EWMA so admission projections are live
        warm = fleet.client(fleet.live_endpoints()[0])
        warm.call("predict", {"x": np.ones((1, 1), np.float32)})
        scaler_thread = threading.Thread(
            target=_scaler_loop,
            args=(scaler, fleet, scaler_stop, interval, snapshots,
                  stats_ms), name="serve-bench-scaler")
        collector = threading.Thread(
            target=_collect, args=(records, rec_lock, out, gen_done),
            name="serve-bench-collector")
        scaler_thread.start()
        collector.start()
        t0 = time.monotonic()
        _generate(fleet, phases, records, rec_lock)
        gen_done.set()
        collector.join(timeout=30.0)
        wall_s = time.monotonic() - t0
        # a couple more ticks so a pending scale-in can land
        time.sleep(2 * interval)
        scaler_stop.set()
        scaler_thread.join(timeout=15.0)
    finally:
        scaler_stop.set()
        gen_done.set()
        fleet.stop_all()
        if plane is not None:
            plane.uninstall()
    if chaos:
        fired = {"serve.admit": admit_f.fired,
                 "serve.drain": drain_f.fired}
    out.update({
        "sent": len(records),
        "wall_s": wall_s,
        "snapshots": snapshots,
        "stats_ms": stats_ms,
        "actions": scaler.actions(),
        "journal": load_actions(coord),
        "drain_reports": fleet.drain_reports,
        "faults_fired": fired,
        "scaler_params": dict(interval=interval,
                              out_streak=knobs["out_streak"],
                              in_streak=knobs["in_streak"]),
    })
    return out


def _dry_replay(knobs, cycle, max_teachers=None):
    """Feed the live run's recorded (now, stats) ticks to a dry-mode
    scaler and return its journaled action signatures — the identical
    -stream half of the dry≡on parity criterion."""
    interval = knobs["interval"]
    scaler = ServeScaler(
        _MemCoord(), "serve-bench", mode="dry", interval=interval,
        min_teachers=1,
        max_teachers=(max_teachers if max_teachers is not None
                      else knobs["max_teachers"]),
        occupancy_high=0.8, occupancy_low=0.4,
        out_streak=knobs["out_streak"], in_streak=knobs["in_streak"],
        cooldowns={"scale_out": 2 * interval,
                   "scale_in": 4 * interval})
    for now, snap in cycle["snapshots"]:
        scaler.tick(snap, now=now)
    return _signatures(scaler.actions())


def _signatures(actions):
    """The mode-independent identity of a journaled action: everything
    but mode/outcome/attempts (which differ between dry and on by
    design — dry applies nothing)."""
    return [(a["seq"], a["kind"], a["target"], a.get("decision"))
            for a in actions]


def run(mode="micro", seed=7):
    knobs = MODES[mode]
    prev_workers = os.environ.get("EDL_TPU_RPC_WORKERS")
    os.environ["EDL_TPU_RPC_WORKERS"] = str(BENCH_RPC_WORKERS)
    try:
        return _run(knobs, mode, seed)
    finally:
        if prev_workers is None:
            os.environ.pop("EDL_TPU_RPC_WORKERS", None)
        else:
            os.environ["EDL_TPU_RPC_WORKERS"] = prev_workers


def _run(knobs, mode, seed):
    cycle = _run_cycle(knobs, seed, knobs["phases"])
    live_sigs = _signatures(cycle["actions"])
    dry_sigs = _dry_replay(knobs, cycle)

    # the clean-fleet control: low load, chaos off — the scaler and the
    # admission controller must both stay silent
    clean = _run_cycle(knobs, seed, ((knobs["clean_s"],
                                      knobs["clean_rps"]),),
                       chaos=False)

    kinds = [a["kind"] for a in cycle["actions"]]
    sent = cycle["sent"]
    drains = cycle["drain_reports"]
    report = {
        "schema": "serve_bench/v1",
        "mode": mode,
        "seed": seed,
        "phases": [{"duration_s": d, "rate_rps": r}
                   for d, r in knobs["phases"]],
        "sent": sent,
        "ok": cycle["ok"],
        "goodput_rps": (round(cycle["ok"] / cycle["wall_s"], 2)
                        if cycle["wall_s"] else None),
        "shed": {
            "total": cycle["shed"],
            "rate": round(cycle["shed"] / sent, 4) if sent else 0.0,
            "by_reason": cycle["shed_by_reason"],
            "with_retry_after_hint": cycle["shed_with_hint"],
        },
        "stranded": cycle["stranded"],
        "timeouts": cycle["timeouts"],
        "untyped_errors": cycle["untyped_errors"],
        "latency_ms": {"p50": _pct(cycle["ok_lat_ms"], 50),
                       "p99": _pct(cycle["ok_lat_ms"], 99)},
        "stats_rpc_ms": {"p50": _pct(cycle["stats_ms"], 50),
                         "p99": _pct(cycle["stats_ms"], 99)},
        "per_phase": cycle["per_phase"],
        "scaler": {
            "mode": "on",
            "scale_out": kinds.count("scale_out"),
            "scale_in": kinds.count("scale_in"),
            "actions": [{k: a[k] for k in ("seq", "kind", "target",
                                           "outcome", "reason")}
                        for a in cycle["actions"]],
            "journaled": len(cycle["journal"]),
        },
        "drain": {
            "reports": drains,
            "zero_stranded": (cycle["stranded"] == 0
                              and all(r.get("drained")
                                      and r.get("pending_rows") == 0
                                      for r in drains)),
        },
        "dry_parity_ok": live_sigs == dry_sigs,
        "live_action_stream": live_sigs,
        "dry_action_stream": dry_sigs,
        "faults_fired": cycle["faults_fired"],
        "clean": {
            "sent": clean["sent"],
            "ok": clean["ok"],
            "shed_total": clean["shed"],
            "stranded": clean["stranded"],
            "scaler_actions": len(clean["actions"]),
        },
        "wall_s": round(cycle["wall_s"], 3),
    }
    return report


# -- the decode arc (schema decode_bench/v1) --------------------------------

#: decode-arc knobs; micro is the tier-1 gate (tiny model, short
#: sequences — wall time is dominated by per-step dispatch, which is
#: exactly the overhead continuous batching amortizes)
DECODE_MODES = {
    "micro": dict(num_layers=2, d_model=32, num_heads=2, mlp_dim=64,
                  vocab_size=64, max_len=64, slots=4, n_prompts=12,
                  prompt_lens=(4, 7), max_news=(6, 12), max_new=8,
                  long_new=24),
    "full": dict(num_layers=4, d_model=64, num_heads=4, mlp_dim=128,
                 vocab_size=256, max_len=128, slots=8, n_prompts=32,
                 prompt_lens=(4, 9, 17), max_news=(8, 16, 24),
                 max_new=16, long_new=64),
}

#: knobs for the prefix-reuse and chunked-prefill sub-arcs — a BIGGER
#: model than the throughput micro arc on purpose: these arcs time
#: prefill COMPUTE (cold full-prompt vs copied-prefix + suffix; a
#: monolithic prefill stall vs a chunk quantum), so prefill must
#: dominate per-dispatch overhead or the ratios measure the Python
#: loop, not the lever
PREFIX_MODES = {
    "micro": dict(num_layers=2, d_model=128, num_heads=4, mlp_dim=256,
                  vocab_size=128, max_len=256, slots=8,
                  prefix_len=160, suffix_len=12, n_cold=3, n_reuse=5,
                  max_new=4, chunk=4, storm_decoders=4, storm_prompts=6,
                  storm_new=48),
    "full": dict(num_layers=4, d_model=128, num_heads=4, mlp_dim=512,
                 vocab_size=256, max_len=512, slots=8,
                 prefix_len=384, suffix_len=24, n_cold=3, n_reuse=8,
                 max_new=8, chunk=16, storm_decoders=6, storm_prompts=8,
                 storm_new=64),
}


def _gpt(knobs, seed, device):
    """(model, params): an f32 ``Gpt`` at ``knobs``' widths on
    ``device`` with random weights from a generator seeded ``seed``;
    ``params`` is its state dict, the form the engines and ``generate``
    take."""
    from edl_tpu_torch.models import gpt as gpt_mod

    model = gpt_mod.Gpt(
        vocab_size=knobs["vocab_size"], num_layers=knobs["num_layers"],
        d_model=knobs["d_model"], num_heads=knobs["num_heads"],
        mlp_dim=knobs["mlp_dim"], max_len=knobs["max_len"],
        dtype=torch.float32, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    params = {k: v.detach() for k, v in model.state_dict().items()}
    return model, params


def _generate_ref(model, params, prompts, max_new):
    """``models.gpt.generate`` of equal-length ``prompts`` as lists."""
    from edl_tpu_torch.models import gpt as gpt_mod

    return gpt_mod.generate(model, params, np.asarray(prompts, np.int64),
                            max_new).cpu().tolist()


def _decode_prompts(knobs, seed):
    """(prompts, per-prompt max_new): lengths and budgets CYCLE over
    two (three in full) fixed shapes — staggered retirements churn the
    slot membership while the (prompt_len, max_new) shape set (and so
    the reference-decode compile count) stays tiny."""
    rng = np.random.RandomState(seed)
    lens = knobs["prompt_lens"]
    news = knobs["max_news"]
    prompts = [rng.randint(1, knobs["vocab_size"],
                           size=lens[i % len(lens)]).tolist()
               for i in range(knobs["n_prompts"])]
    max_news = [news[i % len(news)] for i in range(knobs["n_prompts"])]
    return prompts, max_news


def _open_admission():
    """Admission that never sheds: the throughput arcs isolate the
    batching lever, so queueing must be free."""
    from edl_tpu_torch.serve.admission import DecodeAdmission
    return DecodeAdmission(max_waiting=1 << 30, slot_slack=1 << 30)


def _new_engine(model, params, slots, admission=None, prefix_cache=False,
                prefill_chunk=0):
    """Legacy arcs run ``prefix_cache=False``/monolithic on purpose:
    the throughput and shed arcs isolate the batching/admission levers
    (and keep their PR18 parity semantics); the prefix/chunked sub-arcs
    opt in explicitly to measure THOSE levers."""
    from edl_tpu_torch.serve.decode_engine import DecodeEngine
    return DecodeEngine(model, params, slots=slots, admission=admission,
                        prefix_cache=prefix_cache,
                        prefill_chunk=prefill_chunk).start()


def _warm_engine(engine, prompts, vocab):
    """Run every prefill bucket the timed prompts will hit, plus the
    fused step, once, so the timed window measures warm steps (the
    allocator grown, the kernels loaded)."""
    from edl_tpu_torch.serve.decode_engine import _prefill_bucket
    buckets = sorted({_prefill_bucket(len(p), engine.max_len)
                      for p in prompts})
    for b in buckets:
        engine.generate([1 % vocab] * b, 2, timeout=120.0)


def _shed_reason(fn):
    """Run ``fn`` expecting an OverloadedError; returns its reason."""
    try:
        fn()
    except errors.OverloadedError as e:
        return str(e).split("overloaded: ", 1)[-1].split(" (")[0]
    return None


def _wait_stat(engine, key, at_least, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while engine.stats()[key] < at_least:
        if time.monotonic() > deadline:
            raise errors.TimeoutError_(
                "engine stat %s never reached %s" % (key, at_least))
        time.sleep(0.002)


def _wait_until(predicate, what, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise errors.TimeoutError_("bench never saw %s" % what)
        time.sleep(0.002)


def _decode_shed_arcs(engine, knobs):
    """Force every DECODE_SHED_REASONS entry deterministically; returns
    ({reason: count}, stranded) — every ADMITTED sequence still
    resolves, sheds are typed refusals at the front door.

    Runs on the (already compiled) serial engine, swapping its
    ``admission`` object between sub-arcs — the policies under test
    live entirely in :class:`DecodeAdmission`, so one warm device loop
    serves every arc without another warm-up."""
    from edl_tpu_torch.serve.admission import DecodeAdmission
    reasons = {}

    def saw(reason):
        if reason is not None:
            reasons[reason] = reasons.get(reason, 0) + 1

    handles = []
    long_new = knobs["long_new"]
    prompt = [1, 2, 3]

    def idle():
        # one snapshot: a sequence mid-prefill is in neither the waiting
        # queue nor the active map but still holds its slot, so occupied
        # is the only counter that cannot read 0 while work is in flight
        s = engine.stats()
        return (s["decode_waiting"] == 0 and s["decode_active"] == 0
                and s["decode_slots_occupied"] == 0)

    def settle():
        """Wait for the previous sub-arc's work to finish so each arc
        starts from an empty queue + free slot."""
        _wait_until(idle, "engine idle between shed arcs")

    def resident():
        # the busy sequence itself holds the slot AND has left the
        # waiting queue — probes submitted now observe exactly one
        # resident decode and an empty queue
        s = engine.stats()
        return s["decode_slots_occupied"] >= 1 and s["decode_waiting"] == 0

    def busy_submit():
        h = engine.submit(prompt, long_new)
        handles.append(h)
        _wait_until(resident, "busy sequence resident")
        return h

    # a serve.decode.step DELAY fault (the catalog's ITL-inflation
    # drill) holds each busy sequence resident long enough that every
    # probe submit observes the engine state it targets — no races
    plane = faults.FaultPlane(seed=1)
    plane.inject("serve.decode.step", "delay", seconds=0.02)
    plane.install()
    try:
        # queue_full + draining: tiny waiting bound, slot shed disabled
        engine.admission = DecodeAdmission(max_waiting=2,
                                           slot_slack=1 << 30)
        busy_submit()
        handles.append(engine.submit(prompt, 2))  # waiting -> 1
        handles.append(engine.submit(prompt, 2))  # waiting -> 2
        saw(_shed_reason(lambda: engine.submit(prompt, 2)))  # queue_full
        engine.admission.set_draining(True)
        saw(_shed_reason(lambda: engine.submit(prompt, 2)))  # draining
        engine.admission.set_draining(False)
        settle()

        # slots + deadline: default admission (slot_slack = slots = 1)
        engine.admission = DecodeAdmission()
        busy_submit()
        dead = engine.submit(prompt, 2, deadline_ms=0.0)  # dead on arrival
        saw(_shed_reason(lambda: dead.result(timeout=60.0)))  # deadline
        handles.append(engine.submit(prompt, 2))  # waiting -> 1
        saw(_shed_reason(lambda: engine.submit(prompt, 2)))  # slots
        settle()

        # ttft: projection trips as soon as one sequence waits behind a
        # measured prefill
        engine.admission = DecodeAdmission(ttft_slo_ms=1e-4,
                                           slot_slack=1 << 30)
        busy_submit()
        _wait_until(lambda: (engine.stats()["decode_admission"]
                             ["prefill_ms_per_token"] is not None),
                    "a prefill estimate")
        handles.append(engine.submit(prompt, 2))  # waiting -> 1
        saw(_shed_reason(lambda: engine.submit(prompt, 2)))  # ttft
        settle()

        # itl: the measured (fault-inflated) step EWMA exceeds the
        # absurd SLO while a resident sequence decodes — exactly the
        # catalog's serve.decode.step delay drill
        engine.admission = DecodeAdmission(itl_slo_ms=1e-5,
                                           slot_slack=1 << 30)
        busy_submit()
        _wait_until(lambda: (engine.stats()["decode_admission"]
                             ["itl_ms"] is not None),
                    "an ITL estimate")
        saw(_shed_reason(lambda: engine.submit(prompt, 2)))  # itl
    finally:
        plane.uninstall()

    stranded = 0
    for h in handles:
        try:
            h.result(timeout=60.0)
        except errors.TimeoutError_:
            stranded += 1
    return reasons, stranded


def _decode_prefix_arc(mode, seed, device):
    """Shared-prefix KV reuse sweep on ONE warm engine: timed cold
    prefills (prompts whose first token matches nothing in the trie)
    vs timed reuse prefills (same shared prefix, distinct suffixes).
    Gates TTFT speedup, token parity vs ``gpt.generate``, and EXACT
    ``reuse_hit_tokens`` accounting (every hit reuses precisely
    ``prefix_len`` tokens — first tokens are pinned distinct across
    prompt families so trie depths are deterministic, not
    birthday-paradox noise)."""
    knobs = PREFIX_MODES[mode]
    model, params = _gpt(knobs, seed, device)

    rng = np.random.RandomState(seed + 11)
    vocab, plen, slen = knobs["vocab_size"], knobs["prefix_len"], \
        knobs["suffix_len"]

    def toks(n, first):
        out = rng.randint(1, vocab, size=n).tolist()
        out[0] = first
        return out

    warm_prefix = toks(plen, 1)
    prefix = toks(plen, 2)
    colds = [toks(plen + slen, 3 + i) for i in range(knobs["n_cold"])]
    # suffix first tokens pinned distinct: every reuse lookup shares
    # EXACTLY prefix_len tokens, so the suffix bucket never varies
    suffixes = [toks(slen, 3 + knobs["n_cold"] + j)
                for j in range(knobs["n_reuse"] + 3)]
    max_new = knobs["max_new"]

    engine = _new_engine(model, params, knobs["slots"],
                         admission=_open_admission(), prefix_cache=True)
    try:
        # warm every trace on a DIFFERENT prefix: the full-prompt
        # bucket (cold), then the reuse row copy + suffix bucket
        engine.generate(warm_prefix + suffixes[-1], max_new,
                        timeout=240.0)
        engine.generate(warm_prefix + suffixes[-2], max_new,
                        timeout=240.0)

        cold_ttfts = [engine.generate(c, max_new,
                                      timeout=240.0)["ttft_ms"]
                      for c in colds]
        # seeding the shared prefix is itself one more cold sample
        r0 = engine.generate(prefix + suffixes[0], max_new, timeout=240.0)
        cold_ttfts.append(r0["ttft_ms"])

        reuse_reports = [engine.generate(prefix + s, max_new,
                                         timeout=240.0)
                         for s in suffixes[1:1 + knobs["n_reuse"]]]
        reuse_ttfts = [r["ttft_ms"] for r in reuse_reports]
        reuse_toks = [r["tokens"] for r in reuse_reports]

        # reference decode (batched: all reuse prompts share a shape)
        refs = _generate_ref(
            model, params,
            [prefix + s for s in suffixes[1:1 + knobs["n_reuse"]]],
            max_new)
        pfx = engine.stats()["decode_prefix"]
        engine.drain(deadline_s=30.0)
    finally:
        engine.stop()

    cold_p50, reuse_p50 = _pct(cold_ttfts, 50), _pct(reuse_ttfts, 50)
    hits = pfx["hits"]
    return {
        "prefix_len": plen,
        "suffix_len": slen,
        "overlap_frac": round(plen / float(plen + slen), 3),
        "cold_samples": len(cold_ttfts),
        "reuse_samples": len(reuse_ttfts),
        "cold_ttft_ms_p50": cold_p50,
        "reuse_ttft_ms_p50": reuse_p50,
        "ttft_speedup": round(cold_p50 / max(1e-9, reuse_p50), 3),
        # token-identical vs the monolithic reference decode
        "parity_ok": reuse_toks == refs,
        "hits": hits,
        "reuse_tokens": pfx["reuse_tokens"],
        # every hit (the 1 warm reuse + n_reuse timed) shares exactly
        # prefix_len tokens — the accounting must be token-exact
        "accounting_exact": (hits == knobs["n_reuse"] + 1
                             and pfx["reuse_tokens"] == plen * hits),
        "evictions": pfx["evictions"],
        "cached_rows": pfx["cached_rows"],
    }


def _decode_chunked_arc(mode, seed, device):
    """Prefill-storm ITL drill: live decoders' inter-token latency
    with (a) no storm, (b) a storm of long prompts under CHUNKED
    prefill (each chunk fused into a decode step), (c) the same storm
    under monolithic prefill. Chunking must hold decoder ITL p99
    within 2x of the storm-free baseline while monolithic prefill
    measurably blows it — that stall is the whole reason the chunk
    path exists."""
    knobs = PREFIX_MODES[mode]
    model, params = _gpt(knobs, seed, device)

    rng = np.random.RandomState(seed + 13)
    vocab, storm_len = knobs["vocab_size"], knobs["prefix_len"]
    dec_prompts = [rng.randint(1, vocab, size=8).tolist()
                   for _ in range(knobs["storm_decoders"])]
    storm = [rng.randint(1, vocab, size=storm_len).tolist()
             for _ in range(knobs["storm_prompts"])]
    warm_long = rng.randint(1, vocab, size=storm_len).tolist()

    def warm(engine):
        """Compile the step, the short and long prefill shapes, AND
        the fused chunk+step variant (a long prompt landing while a
        decoder is live) so no first run pollutes a timed ITL."""
        h = engine.submit(dec_prompts[0], 16)
        _wait_until(lambda: engine.stats()["decode_active"] >= 1,
                    "warm decoder resident", timeout_s=120.0)
        engine.generate(warm_long, 2, timeout=240.0)
        h.result(timeout=240.0)

    settle = 8  # tokens per decoder before the storm lands / is timed

    def run_case(engine, with_storm):
        hs = [engine.submit(p, knobs["storm_new"]) for p in dec_prompts]
        _wait_until(lambda: (engine.stats()["decode_active"]
                             >= len(dec_prompts)),
                    "storm decoders resident", timeout_s=120.0)
        if with_storm:
            # let every decoder clear the settling window FIRST so the
            # storm's stall lands in the timed (untrimmed) samples
            base = engine.stats()["decode_tokens_total"]
            _wait_until(lambda: (engine.stats()["decode_tokens_total"]
                                 >= base + settle * len(dec_prompts)),
                        "decoders past settling", timeout_s=120.0)
        storm_hs = [engine.submit(p, 2) for p in storm] if with_storm \
            else []
        reports = [h.result(timeout=240.0) for h in hs]
        for h in storm_hs:
            h.result(timeout=240.0)
        # drop each decoder's settling window: the first gaps span the
        # OTHER decoders' prefills (a startup transient every case
        # shares, not the storm effect under test)
        itls = [ms for r in reports for ms in r["itl_ms"][settle:]]
        return _pct(itls, 50), _pct(itls, 99)

    chunked = _new_engine(model, params, knobs["slots"],
                          admission=_open_admission(),
                          prefill_chunk=knobs["chunk"])
    try:
        warm(chunked)
        base_p50, base_p99 = run_case(chunked, with_storm=False)
        # two storm runs, keep the quieter p99: host noise only ever
        # INFLATES a tail sample, so min-of-2 is the better estimate
        # of the true chunked tail (the monolithic stall, by contrast,
        # is a real, reproducible effect — one run suffices)
        runs = [run_case(chunked, with_storm=True) for _ in range(2)]
        chunk_p50 = min(r[0] for r in runs)
        chunk_p99 = min(r[1] for r in runs)
        cstats = chunked.stats()
        chunked.drain(deadline_s=30.0)
    finally:
        chunked.stop()

    mono = _new_engine(model, params, knobs["slots"],
                       admission=_open_admission())
    try:
        warm(mono)
        mono_p50, mono_p99 = run_case(mono, with_storm=True)
        mono.drain(deadline_s=30.0)
    finally:
        mono.stop()

    # a QUIET baseline's p99 can collapse onto its p50, leaving the 2x
    # allowance smaller than one scheduler blip in absolute ms — floor
    # the allowance at 1.5x the baseline median so the gate measures
    # the storm response, not sub-ms host jitter
    base_allow = max(base_p99, 1.5 * base_p50)
    return {
        "chunk": knobs["chunk"],
        "storm_prompts": knobs["storm_prompts"],
        "storm_prompt_len": storm_len,
        "decoders": knobs["storm_decoders"],
        "baseline_itl_p50": base_p50,
        "baseline_itl_p99": base_p99,
        "baseline_itl_allowance": round(base_allow, 3),
        "chunked_itl_p50": chunk_p50,
        "chunked_itl_p99": chunk_p99,
        "monolithic_itl_p50": mono_p50,
        "monolithic_itl_p99": mono_p99,
        # the two-sided gate: chunking bounds the stall the monolithic
        # engine demonstrably suffers
        "chunked_within_2x": chunk_p99 <= 2.0 * base_allow,
        "monolithic_exceeds_2x": mono_p99 > 2.0 * base_allow,
        # fixed-shape discipline survives chunking: ONE fused step
        # trace, prefills all routed through the (bounded) chunk traces
        "step_traces": cstats["decode_step_traces"],
        "prefill_traces": cstats["decode_prefill_traces"],
        "chunk_traces": cstats["decode_chunk_traces"],
    }


def _decode_scale_out(seed_engine, model, params, knobs, interval=0.05):
    """Pin the seed engine's ``decode_slot_frac`` at 1.0 under long
    sequences; the ServeScaler must react with a journaled scale_out,
    and EVERY submitted sequence — including the waiting queue on the
    saturated engine — must resolve (zero stranded across the drain)."""
    coord = _MemCoord()
    seed_engine.admission = _open_admission()
    engines = [seed_engine]

    def new():
        engines.append(_new_engine(model, params, 2,
                                   admission=_open_admission()))
        return "decode-%d" % len(engines)

    scaler = ServeScaler(
        coord, "decode-bench", mode="on", interval=interval,
        scale_out_fn=new, scale_in_fn=None, min_teachers=1,
        max_teachers=2, occupancy_high=0.8, occupancy_low=0.0,
        out_streak=2, in_streak=1 << 20,
        cooldowns={"scale_out": 2 * interval, "scale_in": 1e9})
    prompts, _ = _decode_prompts(knobs, seed=11)
    handles, actions = [], []
    n_pin = seed_engine.slots + 4
    try:
        # slots+4 long sequences into the seed engine: frac pins at
        # 1.0 with a visible waiting queue.  A step-delay fault holds
        # them resident across the scaler's streak window — a warm
        # engine would otherwise drain the backlog between two ticks.
        plane = faults.FaultPlane(seed=2)
        plane.inject("serve.decode.step", "delay", seconds=0.02)
        plane.install()
        try:
            for p in prompts[:n_pin]:
                handles.append(engines[0].submit(p, knobs["long_new"]))
            deadline = time.monotonic() + 30.0
            while len(engines) == 1 and time.monotonic() < deadline:
                snap = {"decode-%d" % (i + 1): e.stats()
                        for i, e in enumerate(engines)}
                actions.extend(scaler.tick(snap, now=time.time()))
                time.sleep(interval)
        finally:
            plane.uninstall()
        # post-scale-out arrivals route to the new capacity
        if len(engines) > 1:
            for p in prompts[n_pin:n_pin + 4]:
                handles.append(engines[-1].submit(p, knobs["max_new"]))
        stranded = 0
        for h in handles:
            try:
                h.result(timeout=120.0)
            except errors.TimeoutError_:
                stranded += 1
        drained = [e.drain(deadline_s=30.0) for e in engines]
    finally:
        for e in engines:
            e.stop()
    kinds = [a["kind"] for a in actions]
    return {
        "engines": len(engines),
        "scale_out": kinds.count("scale_out"),
        "journaled": len(load_actions(coord)),
        "submitted": len(handles),
        "stranded": stranded,
        "drained_ok": all(drained),
        "zero_stranded": stranded == 0 and all(drained),
    }


def run_decode(mode="micro", seed=7, device=None):
    """The decode arc (``decode_bench/v1``); ``device`` holds the models
    and the engines' KV caches (None means CUDA)."""
    from edl_tpu_torch.models import gpt as gpt_mod
    from edl_tpu_torch.ops.quant import dequantize_tree, quantize_tree, \
        quantized_bytes

    device = resolve_device(device)
    n_devices = (torch.cuda.device_count() if device.type == "cuda"
                 else 1)
    knobs = DECODE_MODES[mode]
    # f32 end to end: the parity gate is TOKEN-IDENTICAL vs generate,
    # which bf16 accumulation would break
    model, params = _gpt(knobs, seed, device)
    prompts, max_news = _decode_prompts(knobs, seed)
    t_start = time.monotonic()

    # the reference decode: ONE batched generate per (prompt_len,
    # max_new) shape group — rows of a causal batch decode
    # independently, tokens match per-call runs
    groups = {}
    for i, (p, n) in enumerate(zip(prompts, max_news)):
        groups.setdefault((len(p), n), []).append(i)
    refs = [None] * len(prompts)
    for (_, n), idxs in groups.items():
        toks = _generate_ref(model, params, [prompts[i] for i in idxs], n)
        for i, row in zip(idxs, toks):
            refs[i] = row

    # serial baseline: same engine machinery, ONE slot, one sequence
    # at a time — isolates decode-step batching as the only lever
    serial = _new_engine(model, params, 1, admission=_open_admission())
    _warm_engine(serial, prompts, knobs["vocab_size"])
    t0 = time.monotonic()
    serial_toks = [serial.generate(p, n, timeout=120.0)["tokens"]
                   for p, n in zip(prompts, max_news)]
    serial_s = time.monotonic() - t0

    # continuous batching: all prompts in flight, fused steps
    cb = _new_engine(model, params, knobs["slots"],
                     admission=_open_admission())
    _warm_engine(cb, prompts, knobs["vocab_size"])
    t0 = time.monotonic()
    hs = [cb.submit(p, n) for p, n in zip(prompts, max_news)]
    cb_reports = [h.result(timeout=120.0) for h in hs]
    cb_s = time.monotonic() - t0
    cb_toks = [r["tokens"] for r in cb_reports]
    cb_stats = cb.stats()
    # exact per-sequence latencies (the module histograms are global
    # and bucketed — they include warmup compiles)
    ttfts = [r["ttft_ms"] for r in cb_reports]
    itls = [ms for r in cb_reports for ms in r["itl_ms"]]

    gen_tokens = sum(max_news)
    serial_tps = gen_tokens / serial_s if serial_s else None
    cb_tps = gen_tokens / cb_s if cb_s else None

    # int8 teacher: logits gap vs f32 (the parity-gate quantity) and
    # bytes crossing HBM; the engine also RUNS on the quantized tree
    qparams = quantize_tree(params, mode="int8")
    q_bytes, f_bytes = quantized_bytes(qparams)
    ids = torch.as_tensor(np.vstack([np.asarray(p[:3] + [0] * 5)[None]
                                     for p in prompts[:4]]),
                          dtype=torch.int64, device=device)
    with torch.no_grad():
        logits_f32 = gpt_mod.apply(model, params, ids).cpu().numpy()
        logits_q = gpt_mod.apply(model, dequantize_tree(qparams),
                                 ids).cpu().numpy()
    rel_err = (np.linalg.norm(logits_q - logits_f32)
               / max(1e-9, np.linalg.norm(logits_f32)))
    qeng = _new_engine(model, qparams, knobs["slots"],
                       admission=_open_admission())
    q_toks = [qeng.submit(p, n).result(timeout=120.0)["tokens"]
              for p, n in zip(prompts[:4], max_news[:4])]
    qeng.drain(deadline_s=30.0)
    qeng.stop()

    # the shed arcs reuse the warm serial engine (admission swaps, no
    # new compiles); the scale-out arc reuses the warm CB engine as
    # its saturated seed
    shed_by_reason, shed_stranded = _decode_shed_arcs(serial, knobs)
    serial.drain(deadline_s=30.0)
    serial.stop()
    scale = _decode_scale_out(cb, model, params, knobs)

    # the serve-plane levers: shared-prefix KV reuse and chunked
    # prefill (their own larger model — see PREFIX_MODES)
    prefix_arc = _decode_prefix_arc(mode, seed, device)
    chunked_arc = _decode_chunked_arc(mode, seed, device)

    report = {
        "schema": "decode_bench/v1",
        "mode": mode,
        "seed": seed,
        "model": {k: knobs[k] for k in ("num_layers", "d_model",
                                        "num_heads", "vocab_size",
                                        "max_len")},
        "prompts": len(prompts),
        "max_new": sorted(set(max_news)),
        "slots": knobs["slots"],
        "devices": n_devices,
        "parity": {
            # byte-/token-identical vs the unbatched reference decode
            "serial_vs_generate_ok": serial_toks == refs,
            "cb_vs_generate_ok": cb_toks == refs,
            # informational: int8 CAN flip an argmax; the gate is the
            # logits gap, not token identity
            "int8_tokens_match": q_toks == refs[:4],
        },
        "throughput": {
            "serial_tokens_per_s": round(serial_tps, 2),
            "cb_tokens_per_s": round(cb_tps, 2),
            "cb_tokens_per_s_per_chip": round(
                cb_tps / n_devices, 2),
            "speedup": round(cb_tps / serial_tps, 3),
            "serial_wall_s": round(serial_s, 3),
            "cb_wall_s": round(cb_s, 3),
        },
        "latency_ms": {
            "ttft_p50": _pct(ttfts, 50),
            "ttft_p99": _pct(ttfts, 99),
            "itl_p50": _pct(itls, 50),
            "itl_p99": _pct(itls, 99),
        },
        "compile": {
            # the fixed-shape contract: ONE fused-step trace however
            # membership churned; prefill traces bounded by buckets
            "step_traces": cb_stats["decode_step_traces"],
            "prefill_traces": cb_stats["decode_prefill_traces"],
        },
        "kv_bytes": cb_stats["decode_kv_bytes"],
        "quant": {
            "int8_logits_rel_err": round(float(rel_err), 5),
            "int8_bytes_ratio": round(q_bytes / float(f_bytes), 4),
        },
        "shed": {
            "by_reason": shed_by_reason,
            "reasons_covered": sorted(shed_by_reason),
            "stranded": shed_stranded,
        },
        "scale_out": scale,
        "prefix": prefix_arc,
        "chunked": chunked_arc,
        "wall_s": round(time.monotonic() - t_start, 3),
    }
    return report


def _decode_healthy(out):
    return (out["parity"]["serial_vs_generate_ok"]
            and out["parity"]["cb_vs_generate_ok"]
            and out["throughput"]["speedup"] >= 1.5
            and out["compile"]["step_traces"] == 1
            and out["shed"]["reasons_covered"]
            == sorted(DECODE_SHED_REASONS)
            and out["shed"]["stranded"] == 0
            and out["scale_out"]["zero_stranded"]
            and out["scale_out"]["scale_out"] >= 1
            and out["prefix"]["parity_ok"]
            and out["prefix"]["accounting_exact"]
            and out["prefix"]["ttft_speedup"] >= 1.5
            and out["chunked"]["chunked_within_2x"]
            and out["chunked"]["monolithic_exceeds_2x"]
            and out["chunked"]["step_traces"] == 1
            and out["chunked"]["prefill_traces"] == 0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="micro", choices=sorted(MODES))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--arc", default="serve", choices=("serve", "decode"))
    ap.add_argument("--device", default=None,
                    help="the decode arc's device (default: cuda)")
    args = ap.parse_args(argv)
    if args.arc == "decode":
        out = run_decode(mode=args.mode, seed=args.seed,
                         device=args.device)
        json.dump(out, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0 if _decode_healthy(out) else 1
    out = run(mode=args.mode, seed=args.seed)
    json.dump(out, sys.stdout, indent=2)
    sys.stdout.write("\n")
    healthy = (out["stranded"] == 0 and out["timeouts"] == 0
               and out["untyped_errors"] == 0 and out["dry_parity_ok"])
    return 0 if healthy else 1


if __name__ == "__main__":
    sys.exit(main())
