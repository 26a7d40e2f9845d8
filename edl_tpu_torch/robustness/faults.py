"""Deterministic fault injection for the elastic control plane.

The chaos plane: named **fault points** are compiled into the RPC
transport, the coordination store, and the distill discovery layer.
When no plane is installed every hook site reduces to a single module
-attribute load and ``is None`` test (``faults.PLANE is None``) — no
allocation, no locking, no measurable cost on the tensor-frame hot
path. When a plane IS installed, armed faults fire deterministically:
each fault draws from its own :class:`random.Random` seeded from
``(plane seed, point, kind)``, so the same seed always produces the
same fault schedule regardless of thread interleaving or how many
other faults are armed.

Fault points (the catalog; see docs/fault_tolerance.md):

======================== ===============================================
point                    fired
======================== ===============================================
rpc.frame.write          before a frame is written (framing.write_frame)
rpc.frame.read           before a frame is read (framing.read_frame)
rpc.client.connect       before a client dials (ctx: endpoint)
rpc.client.call          before a request is sent (ctx: endpoint, method)
rpc.server.conn          when the server accepts a connection
rpc.server.request       before a request dispatches (ctx: method)
store.lease.grant        before a lease is granted (ctx: ttl)
store.lease.refresh      before a lease refresh (ctx: lease_id)
store.lease.expire       after the sweeper expired leases (ctx: lease_ids)
store.watch.deliver      before wait_events blocks (ctx: prefix)
distill.discovery        when a discovery client lists teachers
standby.witness.probe    before the standby asks a witness (ctx: endpoint)
peer_restore.connect     before a restorer dials a peer StateServer
                         (ctx: endpoint, rank)
peer_restore.read        before each peer span fetch (ctx: endpoint,
                         key)
data.assign              before a consumer asks the data leader for an
                         assignment (ctx: pod, endpoint)
data.fetch               before a batch fetch is issued to a producer
                         (ctx: pod, endpoint, batch)
data.fetch.delay         producer-side, inside get_batch/get_batches
                         before the cache is read (ctx: pod, batch) —
                         the latency twin of data.fetch: an armed delay
                         extends the RPC wall time and lands inside the
                         consumer's measured fetch window, so a slow
                         data plane is seeded-reproducible
store.repl.propose       before a leader logs a client op (ctx: kind)
store.repl.append        before a follower handles repl_append (ctx:
                         term, leader, n)
store.repl.vote          before a replica handles a vote request (ctx:
                         term, candidate)
store.repl.snapshot      before a follower installs a leader snapshot
                         (ctx: term, index)
store.repl.apply         before a committed entry is applied (ctx:
                         index, kind)
resize.live.drain        in live_resize before the save-engine drain
                         (ctx: from_devices, to_devices) — a failure
                         here rolls back before anything moved
resize.live.reshard      in live_resize after the new mesh is built,
                         before any state is resharded (ctx:
                         from_devices, to_devices) — the mid-reshard
                         crash drill; rollback must leave the old mesh
                         byte-identical and the 2PC must abort to
                         stop-resume
autopilot.apply          before an autopilot action's actuator runs
                         (ctx: action, pod) — fired INSIDE the retried
                         apply step, so ``error_once`` proves the
                         failed→retried→never-double-applied contract
                         and ``error`` proves a persistent failure is
                         journaled ``outcome: failed``
serve.admit              before the teacher admission controller decides
                         (ctx: rows, pending) — an armed ``error`` turns
                         every predict into a typed shed; ``delay``
                         inflates queue wait so the SLO projection trips
serve.drain              when a teacher starts draining (ctx: endpoint,
                         pending) — arm ``delay`` to hold the drain
                         window open or ``error`` to drill a teacher
                         dying mid-decommission
serve.decode.step        before each fused decode step of the
                         continuous-batching engine (ctx: active,
                         step) — an armed ``error`` fails ONLY the
                         sequences active in that step (typed
                         DecodeStepError, slots freed) and the device
                         loop keeps serving; ``delay`` inflates the
                         inter-token latency so the per-phase ``itl``
                         shed trips
serve.decode.prefix_lookup  before the prefix-cache trie lookup that
                         starts a prefill (ctx: seq, prompt_len) — an
                         armed ``error`` makes the lookup LOSSLESS-fail:
                         the sequence cold-prefills its full prompt
                         (counted as a miss, never a wrong token), so
                         the drill proves reuse is an optimization, not
                         a correctness dependency
relay.attach             child side, when a relay attachment adopts a
                         candidate endpoint (ctx: endpoint, pod) — an
                         armed ``error`` skips the candidate, driving
                         the fall-through to the grandparent / direct
                         store path
relay.forward            relay side, before a child's wait_events
                         long-poll is served from the cache (ctx:
                         prefix, child) — ``drop`` mimics a timed-out
                         poll (delay, never loss), ``error`` forces
                         the child through the since_rev-lossless
                         reattach path
redundancy.encode        push path, before the committed snapshot is
                         erasure-coded (ctx: owner, version) — an
                         armed ``error`` means this version gets no
                         parity cover; the restore ladder must stay
                         lossless via peers/FS
redundancy.push          before each shard is sent to a ring partner
                         (ctx: endpoint, owner, shard) — per-shard
                         failures shrink the rebuild margin, never
                         the commit
redundancy.rebuild       rebuild side, before a dead owner's shards
                         are fetched and decoded (ctx: owner,
                         version) — an armed ``error`` is THE
                         fallback drill: the restore must degrade to
                         the FS rung byte-identically and emit a
                         redundancy.fallback event (reason: fault)
embed.lookup             client side, before a coalesced embedding
                         gather leaves (ctx: table, member, endpoint)
                         — fired INSIDE the retried closure, so
                         ``error_once`` proves fail → requeue → the
                         exact rows (retries counted, no silently-
                         zero rows); a persistent ``error`` surfaces
                         as a typed EmbedLookupError
embed.writeback          client side, before a sparse optimizer
                         write-back leaves (ctx: table, member,
                         endpoint) — same requeue contract; a
                         persistent ``error`` is EmbedWritebackError
                         and the step fails rather than letting table
                         and cache diverge
======================== ===============================================

Fault kinds:

- ``delay``      sleep ``seconds`` (default 0.05), then continue.
- ``error``      raise ``error`` (an EdlError subclass name, or
                 ``ConnectionError``/``OSError``/``timeout``).
- ``error_once`` same, but ``times`` defaults to 1.
- ``partition``  raise ConnectError — arm with an ``endpoint=`` filter
                 to cut specific links.
- ``drop``       site-handled: the frame/request/refresh/event/teacher
                 list silently vanishes (write appears to succeed, the
                 server never answers, the refresh reports the lease
                 gone, the watch delivers nothing, discovery returns no
                 teachers).
- ``corrupt``    site-handled: a garbage header goes on the wire so the
                 peer sees a FramingError.
- ``half_close`` site-handled: the writer shuts down its send side.

Matching: any parameter that is not an action parameter (``seconds``,
``error``) is a **filter** matched as a substring against the fired
context, e.g. ``method="barrier"`` or ``endpoint="127.0.0.1:7021"``.
Scheduling parameters: ``after=K`` skips the first K matches,
``times=N`` fires at most N times, ``prob=p`` fires each match with
probability p from the fault's seeded RNG.

``EDL_TPU_FAULT_SPEC`` grammar (parsed once at import, so any process
— including subprocesses spawned by integration tests — can be placed
under chaos from the environment)::

    SPEC  := [ "seed=" INT ";" ] FAULT { ";" FAULT }
    FAULT := POINT ":" KIND [ "(" k "=" v { "," k "=" v } ")" ]

    EDL_TPU_FAULT_SPEC="seed=7;rpc.server.request:drop(method=barrier,times=2);store.lease.refresh:drop(times=3)"
"""

import os
import threading
import time
import zlib

from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.utils import errors
from edl_tpu_torch.utils.logger import logger

# THE hot-path gate. None == disabled: hook sites are
# ``if faults.PLANE is not None: ...`` and nothing else.
PLANE = None

_ACTION_PARAMS = frozenset(("seconds", "error"))
SITE_KINDS = frozenset(("drop", "corrupt", "half_close"))
GENERIC_KINDS = frozenset(("delay", "error", "error_once", "partition"))
KINDS = SITE_KINDS | GENERIC_KINDS


class FaultSpecError(Exception):
    """EDL_TPU_FAULT_SPEC (or a programmatic inject) is malformed."""


def _resolve_error(name):
    """Error class for the ``error`` kind: the EdlError taxonomy by
    class name, plus the transport-level builtins a socket can raise."""
    builtin = {"ConnectionError": ConnectionError, "OSError": OSError,
               "timeout": TimeoutError}
    cls = errors._name_to_cls().get(name) or builtin.get(name)
    if cls is None:
        raise FaultSpecError("unknown error class %r" % name)
    return cls


class Fault(object):
    """One armed fault at one point. Thread-safe via the plane's lock
    (all counter mutation happens inside FaultPlane.fire)."""

    __slots__ = ("point", "kind", "params", "filters", "times", "after",
                 "prob", "matched", "fired", "_rng")

    def __init__(self, point, kind, seed=0, times=None, after=0, prob=1.0,
                 **params):
        if kind not in KINDS:
            raise FaultSpecError("unknown fault kind %r (want one of %s)"
                                 % (kind, sorted(KINDS)))
        if kind == "error_once" and times is None:
            times = 1
        self.point = point
        self.kind = kind
        self.params = {k: v for k, v in params.items()
                       if k in _ACTION_PARAMS}
        self.filters = {k: v for k, v in params.items()
                        if k not in _ACTION_PARAMS}
        self.times = times
        self.after = int(after)
        self.prob = float(prob)
        self.matched = 0
        self.fired = 0
        # per-fault stream: independent of arming order and of every
        # other fault's draws — the determinism contract
        import random
        self._rng = random.Random(
            (int(seed) << 32) ^ zlib.crc32(("%s:%s" % (point, kind))
                                           .encode("utf-8")))

    def _matches(self, ctx):
        for key, want in self.filters.items():
            if str(want) not in str(ctx.get(key, "")):
                return False
        return True

    def _decide(self, ctx):
        """Counter/RNG advance; call only under the plane lock."""
        if not self._matches(ctx):
            return False
        self.matched += 1
        if self.matched <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self._rng.random() >= self.prob:
            return False
        self.fired += 1
        return True

    def make_error(self):
        cls = _resolve_error(self.params.get("error", "ConnectError"))
        return cls("fault injected at %s" % self.point)

    def __repr__(self):
        return "Fault(%s:%s times=%r after=%d prob=%g fired=%d)" % (
            self.point, self.kind, self.times, self.after, self.prob,
            self.fired)


class FaultPlane(object):
    """Registry of armed faults + the fire() entry point hook sites call.

    ``log`` records every firing as ``(point, kind)`` in order — the
    observable fault schedule; two planes with equal seeds driven
    through equal match sequences produce equal logs.
    """

    def __init__(self, seed=0):
        self.seed = int(seed)
        self.log = []
        self._faults = {}  # point -> [Fault]
        self._lock = threading.Lock()

    # -- arming ------------------------------------------------------------

    def inject(self, point, kind, **params):
        """Arm ``kind`` at ``point``; returns the Fault (counters are
        inspectable: ``f.fired``)."""
        f = Fault(point, kind, seed=self.seed, **params)
        with self._lock:
            self._faults.setdefault(point, []).append(f)
        return f

    def clear(self, point=None):
        with self._lock:
            if point is None:
                self._faults.clear()
            else:
                self._faults.pop(point, None)

    def install(self):
        """Make this plane THE process-global plane."""
        global PLANE
        PLANE = self
        return self

    def uninstall(self):
        global PLANE
        if PLANE is self:
            PLANE = None

    # -- firing ------------------------------------------------------------

    def fire(self, point, **ctx):
        """Evaluate the point. Generic kinds act here (delay sleeps,
        error/partition raise); site-handled kinds (drop / corrupt /
        half_close) are returned for the hook site to apply. At most one
        site-handled fault is returned per firing (the first armed)."""
        with self._lock:
            flist = self._faults.get(point)
            if not flist:
                return None
            hits = [f for f in flist if f._decide(ctx)]
            for f in hits:
                self.log.append((point, f.kind))
        out = None
        for f in hits:
            logger.warning("fault fired: %s:%s %r", point, f.kind, ctx)
            # the injection lands on the elastic-event timeline, so a
            # chaos drill's observed recovery is causally attributable
            obs_events.emit("fault.fired", point=point, fault=f.kind,
                            ctx={k: str(v) for k, v in ctx.items()})
            if f.kind == "delay":
                time.sleep(float(f.params.get("seconds", 0.05)))
            elif f.kind in ("error", "error_once"):
                raise f.make_error()
            elif f.kind == "partition":
                raise errors.ConnectError(
                    "fault: partition at %s %r" % (point, ctx))
            elif out is None:
                out = f
        return out


def plane_from_spec(spec, seed=0):
    """Build a FaultPlane from the EDL_TPU_FAULT_SPEC grammar (module
    docstring). Does NOT install it."""
    plane = None
    entries = [e.strip() for e in spec.split(";") if e.strip()]
    if not entries:
        raise FaultSpecError("empty fault spec")
    if entries[0].startswith("seed="):
        seed = int(entries.pop(0)[len("seed="):])
    plane = FaultPlane(seed=seed)
    for entry in entries:
        if ":" not in entry:
            raise FaultSpecError("bad fault entry %r (want point:kind)"
                                 % entry)
        point, _, action = entry.partition(":")
        kind, params = action, {}
        if "(" in action:
            if not action.endswith(")"):
                raise FaultSpecError("unbalanced parens in %r" % entry)
            kind, _, arglist = action[:-1].partition("(")
            for pair in arglist.split(","):
                if not pair.strip():
                    continue
                if "=" not in pair:
                    raise FaultSpecError("bad param %r in %r"
                                         % (pair, entry))
                k, _, v = pair.partition("=")
                params[k.strip()] = _coerce(v.strip())
        plane.inject(point.strip(), kind.strip(), **params)
    return plane


def _coerce(value):
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


# Opt-in environment activation: any process started with a spec is
# under chaos from its first import. A malformed spec fails loudly —
# silently ignoring it would report a chaos run as green without ever
# injecting anything.
_env_spec = os.environ.get("EDL_TPU_FAULT_SPEC")
if _env_spec:
    plane_from_spec(_env_spec).install()
    logger.warning("fault plane installed from EDL_TPU_FAULT_SPEC=%r",
                   _env_spec)
