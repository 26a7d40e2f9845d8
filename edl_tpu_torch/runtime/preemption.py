"""Coordinated preemption stop: agree on a common stop STEP across all
ranks through the coordination store, so the grace-window emergency
checkpoint can use the normal cooperative save even for cross-host
SHARDED state (tp/sp over hosts).

Why: SIGTERMs land on each host at slightly different wall-clock times,
so ranks observe the flag at different step boundaries. Any cooperative
save (collective gather, or the sharded save's filesystem barrier)
started from misaligned boundaries deadlocks or times out. The protocol:

  1. a flagged rank publishes   preempt:<stage>/req_<rank> = its step
  2. rank 0 (watcher thread) sees any req and publishes (put-if-absent)
                                preempt:<stage>/stop_at = its step + margin
  3. every rank's watcher reads stop_at; the trainer stops at that exact
     step boundary, where the cooperative save is safe, and raises
     PreemptedError on ALL ranks.

Keys carry a TTL, republished periodically while the preemption is
pending, so they self-expire after the job moves on — a restarted job
can never trip over its predecessor's stop_at — and are namespaced by
the cluster stage uuid (a new incarnation never sees the old stage's
keys even within the TTL). The stop step is chosen ahead of every
rank: max(leader step, all requesters' steps) plus a margin ADAPTIVE to
the observation latency (the step-equivalent of a few watcher poll
intervals, from the leader's measured step time) — with fast steps a
fixed step count would already be in the past by the time a watcher
polls. If a rank still overshoots (extreme skew), the aligned save is
impossible: that rank raises PreemptedError without saving, the
stopped ranks' save barrier times out, and every rank still exits via
PreemptedError with the restart falling back to the last epoch
checkpoint; a rank blocked inside a dispatched collective is freed by
the supervisor's SIGKILL after the grace period. The checkpoint is
best-effort under pathological skew — never corrupted, and the failure
mode equals not having the feature.

Caveat: the stop is enforced at HOST step boundaries, so a training
loop that never synchronizes (no loss fetch, no metrics) can dispatch
far past the agreed step before its watcher observes it — the margin
covers normal dispatch-ahead, not a free-running dispatch loop. Real
loops sync every step or few (loss logging, metrics), which is the
cadence the adaptive margin is computed from.

Reference role: the reference had no mid-epoch preemption save at all
(per-epoch checkpoints only, train_with_fleet.py:562); this is net-new
elasticity depth for TPU pods, where preemption is routine.
"""

import threading
import time

from edl_tpu_torch.utils.logger import logger

KEY_TTL = 120.0


class PreemptionGuard(object):
    """Async-signal-safe preemption flag + checkpoint drain hook.

    The handler only flips ``preempted`` (no I/O, no locks — the only
    things legal in a signal context); the trainer polls the flag at
    step boundaries. ``drain()`` runs the supplied callable (the async
    checkpoint engine's drain) and is called on EVERY preemption exit
    path — including the ones that save nothing — so a SIGTERM can
    never lose the in-flight async checkpoint version."""

    def __init__(self, drain=None):
        self._drain = drain
        self.preempted = False
        self.installed = False

    def install(self, signals=None):
        """Arm the flag-only handler (idempotent; main thread only —
        CPython restricts signal.signal to it). Default: SIGTERM."""
        import signal as signal_mod
        if signals is None:
            signals = (signal_mod.SIGTERM,)
        for s in signals:
            signal_mod.signal(s, self._on_signal)
        self.installed = True
        return self

    def _on_signal(self, signum, frame):
        self.preempted = True

    def drain(self):
        """Wait out the in-flight async checkpoint persist (best-effort:
        a drain failure must not mask the PreemptedError being raised)."""
        if self._drain is None:
            return
        try:
            self._drain()
        except Exception:
            logger.exception("preemption drain failed")


class CoordinatedStop(object):
    """One per trainer process. ``stop_at`` becomes the agreed stop step
    (read it each boundary); ``request(step)`` publishes this rank's
    preemption flag. A daemon watcher thread polls the store."""

    def __init__(self, coord, rank, stage="default", margin=4,
                 poll_interval=0.25, current_step=None, min_step=0,
                 step_time=None, grace_budget=8.0,
                 heartbeat_interval=2.0):
        self._coord = coord
        self._rank = rank
        self._service = "preempt:%s" % (stage or "default")
        self._margin = margin
        self._poll = poll_interval
        self._current_step = current_step or (lambda: 0)
        # seconds per train step (callable), for the adaptive margin; 0
        # or None falls back to the fixed step margin
        self._step_time = step_time or (lambda: 0.0)
        # the stop lead in WALL-CLOCK terms must fit inside the
        # SIGTERM->SIGKILL grace window: with multi-second steps a fixed
        # 4-step margin would overshoot it and the save would be killed
        # mid-flight, so the lead is capped at grace_budget seconds
        self._grace_budget = grace_budget
        # every rank (not just requesters) publishes step_<rank> at this
        # cadence so the leader's stop_at clears the furthest-ahead
        # rank's counter, not just the requesters'/leader's. It must
        # run BEFORE any preemption is pending (stop_at is computed
        # from whatever is on the store at request time), so the cost
        # is bounded instead: one lease granted once then refreshed,
        # one leased put (no fsync) per interval, 2s default cadence
        self._hb_interval = heartbeat_interval
        self._last_hb = 0.0
        self._hb_lease = None
        # leader-side per-rank heartbeat history: key -> (step, t_seen).
        # Lets the stop lead use each rank's ACTUAL heartbeat staleness
        # (observed age of its current value) instead of a blanket
        # worst-case hb_interval term, which ballooned the lead to ~30
        # steps at fast cadences (r4) and forced tests onto long epochs.
        self._hb_obs = {}
        self.stop_at = None
        # stop_at values at or below min_step are STALE (left by a prior
        # incarnation within the key TTL when the stage uuid did not
        # change). The trainer raises this to the resumed step after
        # checkpoint restore; a legitimate stop is always published
        # ahead of every live rank's step.
        self.min_step = min_step
        self._requested = False
        self._last_pub = 0.0
        self._stop_evt = threading.Event()
        self._thread = None

    @property
    def started(self):
        return self._thread is not None

    def start(self):
        """Idempotent. Callers should start the watcher only once the
        baseline step is final (after any checkpoint resume): a watcher
        polling with a too-low min_step would accept a stale stop_at in
        the window before the baseline is raised."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="preempt-watch-r%d"
                                            % self._rank)
            self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()

    def request(self, step):
        """Publish this rank's preemption flag (TTL'd, republished every
        few seconds while pending — a single put could expire during a
        long compile before the leader's watcher ever polls). The
        published step is clamped above min_step so the leader's
        staleness filter never discards a live request."""
        now = time.monotonic()
        if self._requested and now - self._last_pub < min(2.0,
                                                          KEY_TTL / 3.0):
            return
        self._requested = True
        self._last_pub = now
        try:
            value = str(max(int(step), self.min_step + 1))
            if self._coord.set_server_not_exists(
                    self._service, "req_%d" % self._rank, value,
                    ttl=KEY_TTL) is None:
                # the key exists — either our own earlier publish (an
                # overwrite is an idempotent refresh) or a STALE one
                # from a prior same-stage incarnation, which would
                # shadow this live request past the leader's staleness
                # filter: overwrite unconditionally
                self._coord.set_server_with_lease(
                    self._service, "req_%d" % self._rank, value,
                    ttl=KEY_TTL)
        except Exception:
            logger.exception("preempt request publish failed")

    # -- watcher ------------------------------------------------------------

    @staticmethod
    def _as_step(value):
        """Store value -> int step, None when absent/garbled (the one
        decoder for stop_at and request values)."""
        if isinstance(value, bytes):
            value = value.decode("utf-8", "replace")
        try:
            return None if value is None else int(value)
        except (TypeError, ValueError):
            return None

    @staticmethod
    def _as_step_hb(value):
        """Heartbeat value -> (step, step_time|None). Heartbeats carry
        the rank's own measured step time ("<step>:<dt>") so the leader
        can project each rank's position per-rank; bare ints (older
        writers) decode with no rate."""
        if isinstance(value, bytes):
            value = value.decode("utf-8", "replace")
        if value is None:
            return None, None
        step_s, _, dt_s = str(value).partition(":")
        try:
            step = int(step_s)
        except (TypeError, ValueError):
            return None, None
        try:
            dt = float(dt_s) if dt_s else None
        except ValueError:
            dt = None
        return step, (dt if dt and dt > 0 else None)

    def _read_stop_at(self):
        try:
            v = self._coord.get_value(self._service, "stop_at")
        except Exception:
            logger.exception("preempt stop_at read failed")
            return None
        return self._as_step(v)

    def _leader_maybe_publish(self):
        try:
            reqs = self._coord.get_service(self._service)
        except Exception:
            return

        # reqs at or below min_step are a prior incarnation's leftovers
        # (same stage uuid within the key TTL) — not a live preemption;
        # step_<rank> heartbeats widen the max to EVERY live rank's
        # counter so a fast non-requesting rank cannot already be past
        # the stop when its watcher observes it.
        now = time.monotonic()
        dt = float(self._step_time() or 0.0)
        # Per-rank position PROJECTION: a heartbeat value is stale by
        # its observed age (tracked across polls: a value first seen
        # this poll was written within the last poll interval; on the
        # leader's very first sighting the age is unknown — assume a
        # full heartbeat period, it refines at the next beat). Project
        # each rank forward by age/its-own-step-rate, so the stop
        # clears where the rank IS, not where its last beat was. This
        # replaces the old blanket worst-case hb_interval term in the
        # lead, which at fast cadences ballooned the stop ~30 steps out.
        hb_steps = []
        for name, v in reqs:
            if not name.startswith("step_"):
                continue
            s, rank_dt = self._as_step_hb(v)
            if s is None or s <= self.min_step:
                continue
            prev = self._hb_obs.get(name)
            if prev is None:
                self._hb_obs[name] = (s, now - self._hb_interval)
            elif prev[0] != s:
                self._hb_obs[name] = (s, now)
            age = now - self._hb_obs[name][1]
            rate = rank_dt or dt
            # floor, not ceil: the lead below already covers sub-step
            # observation latency for every rank. CAPPED at
            # grace_budget worth of stepping: an unchanged beat can
            # mean a PAUSED rank (epoch save, eval, recompile) whose
            # age grows without the rank advancing at all — an
            # unbounded projection would push stop_at past anything
            # reachable inside the kill grace and forfeit the save.
            if rate > 0:
                ahead = min(int((age + self._poll) / rate),
                            max(1, int(self._grace_budget / rate)))
            else:
                ahead = 0
            hb_steps.append(s + ahead)
        req_steps = [s for name, v in reqs
                     if name.startswith("req_")
                     and (s := self._as_step(v)) is not None
                     and s > self.min_step]
        if not req_steps:
            return
        # the stop must land AHEAD of every rank's (projected) counter
        # when its watcher observes it: steps are fast (ms) while
        # observation is poll-paced (100s of ms), so a fixed step margin
        # would already be in the past — convert a few poll intervals of
        # observation latency into steps using the measured step time.
        # With SLOW steps the lead is capped so lead*step_time stays
        # inside the kill grace window.
        lead = self._margin
        if dt > 0:
            adaptive = int(4.0 * self._poll / dt) + 1
            lead = max(self._margin, adaptive)
            max_lead = max(1, int(self._grace_budget / dt))
            lead = min(lead, max_lead)
        stop = (max([int(self._current_step())] + req_steps + hb_steps)
                + lead)
        try:
            existing = self._read_stop_at()
            if existing is not None and existing <= self.min_step:
                # a stale key from a prior incarnation blocks the
                # put-if-absent: overwrite it (one leader per job)
                self._coord.set_server_with_lease(
                    self._service, "stop_at", str(stop), ttl=KEY_TTL)
                logger.info("preemption leader: stop_at=%d published "
                            "(over stale %d)", stop, existing)
            elif existing is None and self._coord.set_server_not_exists(
                    self._service, "stop_at", str(stop),
                    ttl=KEY_TTL) is not None:
                logger.info("preemption leader: stop_at=%d published", stop)
        except Exception:
            logger.exception("preempt stop_at publish failed")

    def _publish_step_heartbeat(self):
        """Publish this rank's current step (TTL'd) so the leader's
        stop_at computation covers the furthest-ahead rank, not just
        requesters. One lease is granted once and refreshed; each
        interval costs refresh + leased put (no fsync)."""
        now = time.monotonic()
        if now - self._last_hb < self._hb_interval:
            return
        self._last_hb = now
        step = max(int(self._current_step()), self.min_step + 1)
        dt = float(self._step_time() or 0.0)
        # carry this rank's own step rate so the leader can project the
        # beat's staleness per-rank (see _leader_maybe_publish)
        value = ("%d:%.6f" % (step, dt)) if dt > 0 else str(step)
        key = self._coord.server_key(self._service,
                                     "step_%d" % self._rank)
        ttl = max(10.0, 4 * self._hb_interval)
        try:
            if self._hb_lease is not None and \
                    self._coord.lease_refresh(self._hb_lease):
                self._coord.put(key, value, lease_id=self._hb_lease)
            else:
                self._hb_lease = self._coord.lease_grant(ttl)
                self._coord.put(key, value, lease_id=self._hb_lease)
        except Exception:
            self._hb_lease = None
            logger.exception("preempt step heartbeat failed")

    def _run(self):
        warned_stale = False
        while not self._stop_evt.wait(self._poll):
            self._publish_step_heartbeat()
            got = self._read_stop_at()
            if got is not None:
                if got <= self.min_step:
                    if not warned_stale:
                        warned_stale = True
                        logger.warning(
                            "ignoring stale preemption stop_at=%d "
                            "(<= min_step %d)", got, self.min_step)
                else:
                    self.stop_at = got
                    logger.info("preemption stop_at=%d observed (rank %d)",
                                got, self._rank)
                    return
            if self._rank == 0:
                self._leader_maybe_publish()
