"""Continuous-batching autoregressive decode engine for the serving plane.

The port of ``edl_tpu/serve/decode_engine.py``. Decode-step-level
scheduling (Orca, Yu et al. OSDI'22) on top of the
slot KV cache (:mod:`edl_tpu_torch.serve.kv_cache`): instead of batching at
request granularity — where every sequence in a batch waits for the
longest one — the device loop makes an admission decision EVERY DECODE
STEP. Each iteration it

1. admits newly arrived sequences into free slots (one prefill forward
   per arrival fills the slot's cache rows ``[0:prompt_len)`` via the
   path ``models/gpt.py`` exposes, and yields the first token),
2. runs ONE fused decode step over all occupied slots — a fixed-shape
   forward over ``[slots]`` tokens and ``[slots]`` per-row positions
   (vector ``decode_index``), so slot membership churn never changes
   a shape; free rows ride along masked-out on the host side,
3. retires finished sequences (slot back to the free list, future
   resolved) and evicts ones past their deadline,

and streams tokens back over the pipelined RPC plane (``lm_submit`` /
``lm_poll`` on :class:`~edl_tpu_torch.distill.teacher_server.TeacherServer`,
or blocking ``lm_generate``).

Generation is greedy (argmax) — deliberately: tier-1 gates the engine
on TOKEN-IDENTICAL output vs the unbatched ``models.gpt.generate`` for
the same prompts, which pins down the whole slot machinery (prefill
padding, scatter, per-row masks, cache reuse without zeroing).

Two serving fast paths ride the same machinery:

- **Shared-prefix KV reuse** (SGLang RadixAttention): retired rows are
  RETAINED as cached prefixes in a host-side token trie
  (:class:`~edl_tpu_torch.serve.kv_cache.PrefixCache`); a prompt sharing a
  stored prefix copies the donor row on-device and prefills only the
  suffix. Causality makes the reuse exact — K/V at position i depends
  only on tokens <= i — and the suffix path is token-parity-gated vs
  cold prefill. ``EDL_TPU_PREFIX_CACHE=0`` (or ``prefix_cache=False``)
  kills the path byte-identically.
- **Chunked prefill** (Sarathi-Serve, OSDI'24): with
  ``prefill_chunk=C`` (or ``EDL_TPU_PREFILL_CHUNK``), prefills split
  into fixed-width chunks and AT MOST ONE chunk rides each fused decode
  step in the SAME dispatch, so a long prompt costs every resident
  sequence one slightly-heavier step per chunk instead of a full
  prefill-sized ITL stall. Chunk calls write K/V at the chunk's offset
  (``models/gpt.py prefill_offset``) and the final chunk yields the
  first token.

Idle rows (free, cached, or mid-chunked-prefill) ride fused steps with
a junk write pointed at position ``max_len - 1`` — a position every
future tenant overwrites before attending — so step traffic can never
corrupt a cached prefix or a half-prefilled row.

Faults: the ``serve.decode.step`` point fires before every fused step;
a faulted step fails ONLY the sequences active in it (typed
:class:`~edl_tpu_torch.utils.errors.DecodeStepError`, slots freed) and the
loop keeps serving — chaos-drilled in tests/test_decode_engine.py.
``serve.decode.prefix_lookup`` fires before each trie lookup; a fault
there falls back LOSSLESSLY to cold prefill (never a wrong token).

Quantization: pass ``params`` straight from
:func:`edl_tpu_torch.ops.quant.quantize_tree` — every prefill/step
forward calls :func:`~edl_tpu_torch.ops.quant.dequantize_tree` first,
so int8/bf16 weights are what stays in device memory (identity on f32
states). In eager PyTorch that re-materializes f32 kernels on every
forward, as the JAX package's dequant under jit does.

Where the JAX package has five donated jits, the port has five plain
methods that update ``self.kv.cache`` in place (the ``_*_impl``
methods). There is no trace: the ``decode_*_traces`` counters count
the DISTINCT INPUT SHAPES each function has run at, so the fixed-shape
discipline still shows as ``decode_step_traces == 1``. The device loop
runs in its own thread under ``torch.no_grad()``; the cache is made
outside inference mode (``models.gpt.init_cache``), so the loop may
update it whichever thread built the engine.

The device is the one ``params`` lives on. Prompt ids outside
``[0, vocab)`` are refused at :meth:`DecodeEngine.submit` with a
``FeedSpecError``: on CUDA an out-of-range gather is a device assert
that would end the process.
"""

import collections
import itertools
import os
import threading
import time

import numpy as np
import torch

from edl_tpu_torch.models.gpt import _state_device, apply, init_cache
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.ops.quant import dequantize_tree
from edl_tpu_torch.robustness import faults
from edl_tpu_torch.serve.admission import DecodeAdmission
from edl_tpu_torch.serve.kv_cache import PrefixCache, SlotKvCache
from edl_tpu_torch.utils import errors

_MS_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500)

_SLOTS_OCCUPIED = obs_metrics.gauge(
    "edl_decode_slots_occupied", "KV-cache slots holding a live sequence")
_SLOTS_TOTAL = obs_metrics.gauge(
    "edl_decode_slots_total", "preallocated KV-cache slots")
_PREFILL_QUEUE = obs_metrics.gauge(
    "edl_decode_prefill_queue", "admitted sequences waiting for a slot "
    "+ prefill")
_TTFT = obs_metrics.histogram(
    "edl_decode_ttft_ms", "submit -> first token (prefill phase)",
    buckets=_MS_BUCKETS)
_ITL = obs_metrics.histogram(
    "edl_decode_itl_ms", "inter-token latency (one fused decode step)",
    buckets=_MS_BUCKETS)
_TOKENS = obs_metrics.counter(
    "edl_decode_tokens_total", "tokens generated across all sequences")
_EVICTED = obs_metrics.counter(
    "edl_decode_evicted_sequences_total", "sequences evicted before "
    "completion (deadline or faulted step)")
_STEPS = obs_metrics.counter(
    "edl_decode_steps_total", "fused decode steps executed")


class _Seq(object):
    __slots__ = ("id", "prompt", "max_new", "deadline_ms", "submitted_at",
                 "slot", "pos", "tok", "tokens", "ttft_ms", "itl_ms",
                 "done", "error", "event", "next_off", "reuse_tokens",
                 "suffix_est", "last_emit")

    def __init__(self, seq_id, prompt, max_new, deadline_ms, submitted_at):
        self.id = seq_id
        self.prompt = prompt
        self.max_new = max_new
        self.deadline_ms = deadline_ms
        self.submitted_at = submitted_at
        self.slot = None
        self.pos = None      # position the NEXT fed token occupies
        self.tok = None      # the next token to feed
        self.tokens = []     # generated tokens (streamed via poll)
        self.ttft_ms = None
        self.itl_ms = []
        self.done = False
        self.error = None
        self.event = threading.Event()
        self.next_off = None            # prefill frontier (chunked path)
        self.reuse_tokens = 0           # prefix tokens reused from cache
        self.suffix_est = len(prompt)   # projected prefill work at submit
        self.last_emit = None           # clock stamp of the last token


class SeqHandle(object):
    """Client-side handle: stream via :meth:`tokens_from`, or block on
    :meth:`result`."""

    def __init__(self, engine, seq):
        self._engine = engine
        self._seq = seq

    @property
    def seq_id(self):
        return self._seq.id

    def tokens_from(self, start):
        """(new_tokens, done) — tokens generated since index ``start``.
        Raises the sequence's typed error once it has failed."""
        return self._engine._poll(self._seq, start)

    def result(self, timeout=None):
        """Block until the sequence finishes; returns a report dict
        (tokens, ttft_ms, itl p50/p99) or raises its typed error."""
        if not self._seq.event.wait(timeout):
            raise errors.TimeoutError_(
                "sequence %d still decoding after %ss"
                % (self._seq.id, timeout))
        return self._engine._report(self._seq)


class DecodeEngine(object):
    """One device loop + slot cache + per-phase admission, serving a
    single causal-LM ``model`` with KV-cache decode (``models/gpt.py``).

    ``params`` is the model's state dict (``{name: tensor}``, on the
    device to serve from): plain f32, or the output of
    :func:`~edl_tpu_torch.ops.quant.quantize_tree`. The model module
    supplies only the structure (it may live on ``meta``). ``slots``
    bounds resident
    sequences; ``admission`` is a :class:`DecodeAdmission` (``None`` =
    defaults, ``False`` = admit everything except when draining).

    ``prefix_cache``: ``None`` = on unless ``EDL_TPU_PREFIX_CACHE=0``,
    ``False`` = off (cold prefill only, byte-identical to the pre-reuse
    engine), ``True`` = on regardless of the env knob, or a
    :class:`~edl_tpu_torch.serve.kv_cache.PrefixCache` to share or pre-seed
    one. ``prefill_chunk``: chunk width in tokens for
    Sarathi-style chunked prefill (``None`` = ``EDL_TPU_PREFILL_CHUNK``,
    0/unset = monolithic prefill)."""

    def __init__(self, model, params, slots=8, admission=None,
                 clock=time.monotonic, prefix_cache=None,
                 prefill_chunk=None):
        self.model = model
        self.params = params
        self.slots = int(slots)
        self.max_len = int(model.max_len)
        self.vocab_size = int(model.vocab_size)
        self._device = _state_device(params)
        self._clock = clock
        if admission is None:
            admission = DecodeAdmission(clock=clock)
        self.admission = admission or DecodeAdmission(
            max_waiting=1 << 30, clock=clock)
        if prefix_cache is None:
            env = os.environ.get("EDL_TPU_PREFIX_CACHE", "1").lower()
            prefix_cache = (PrefixCache()
                            if env not in ("0", "off", "false") else None)
        elif prefix_cache is False:
            prefix_cache = None
        elif prefix_cache is True:  # force on, ignoring the env knob
            prefix_cache = PrefixCache()
        self.prefix = prefix_cache
        if prefill_chunk is None:
            prefill_chunk = int(
                os.environ.get("EDL_TPU_PREFILL_CHUNK", "0") or 0)
        self.prefill_chunk = min(max(0, int(prefill_chunk)), self.max_len)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._waiting = collections.deque()
        self._prefill_q = collections.deque()  # chunked: slot held, prefill
        self._seqs = {}      # id -> _Seq (live + recently finished)
        self._by_slot = {}   # slot -> _Seq (active only)
        self._ids = itertools.count(1)
        self._stop = False
        self._thread = None
        self._sequences_done = 0
        self._evicted = 0
        self._tokens_total = 0
        self._steps_total = 0
        self._prefilled_tokens = 0  # tokens cold-prefilled (not reused)
        # distinct input shapes per device function (the JAX package's
        # trace counts): the step must stay at 1, prefill is bounded by
        # the power-of-two buckets, chunk by 1 width under chunking (solo
        # + fused) and the buckets of suffixes
        self._step_shapes = set()
        self._prefill_shapes = set()
        self._chunk_shapes = set()

        self.kv = SlotKvCache(
            lambda n: init_cache(model, params, n), self.slots)
        _SLOTS_TOTAL.set(self.slots)

    # -- device functions (in place on self.kv.cache) -----------------------

    def _device_ids(self, arr):
        return torch.from_numpy(np.asarray(arr, np.int64)).to(self._device)

    def _row(self, slot):
        """Slot ``slot``'s cache row as [1, ...] views: writes through
        them land in ``self.kv.cache``."""
        return {name: full[slot:slot + 1]
                for name, full in self.kv.cache.items()}

    def _prefill_impl(self, qparams, ids, prompt_len, slot):
        """Fills slot ``slot`` from a padded prompt ``ids [1, P]`` and
        returns the last prompt position's logits. The WHOLE row is
        written — prompt K/V in ``[0, P)``, zeros beyond, as the JAX
        package's full-row scatter does — so any previous tenant is
        erased; junk K/V at padded positions ``[prompt_len, P)`` is
        overwritten by the decode step at each position before it is
        ever attended."""
        self._prefill_shapes.add(tuple(ids.shape))
        row = self._row(slot)
        for full in row.values():
            full[:, ids.shape[1]:] = 0
        logits = apply(self.model, qparams, self._device_ids(ids),
                       cache=row, prefill=True)
        return logits[0, prompt_len - 1]

    def _step_impl(self, qparams, toks, pos):
        """ONE fused decode step over every slot: fixed shapes
        ``toks [slots]`` / ``pos [slots]`` whatever subset is live (idle
        rows carry a junk write at ``max_len - 1``). Returns logits
        [slots, vocab]."""
        self._step_shapes.add((toks.shape, pos.shape))
        logits = apply(self.model, qparams,
                       self._device_ids(toks)[:, None],
                       cache=self.kv.cache, decode=True, decode_index=pos)
        return logits[:, 0]

    def _reuse_impl(self, src, dst):
        """Copy slot row ``src`` (a cached prefix donor) onto ``dst``.
        The WHOLE row is copied — positions beyond the reused depth hold
        junk, but the suffix prefill / decode writes overwrite every
        position before it is attended (the no-zeroing invariant)."""
        for full in self.kv.cache.values():
            full[dst] = full[src]

    def _apply_chunk(self, params, ids, offset, slot):
        """Shared chunk body: one offset-prefill chunk over slot
        ``slot``'s row (K/V written at ``offset``, rows attend the
        already-written prefix). Returns chunk logits [1, W, vocab]."""
        return apply(self.model, params, self._device_ids(ids),
                     cache=self._row(slot), prefill=True,
                     prefill_offset=offset)

    def _chunk_impl(self, qparams, ids, offset, last, slot):
        """One solo prefill chunk (no live decode rows to fuse with):
        suffix prefill after a prefix hit, or a chunked-prefill quantum
        on an otherwise idle engine. ``last`` indexes the final valid
        prompt position in the window (its logits yield the first
        token when this is the final chunk)."""
        self._chunk_shapes.add(("solo", ids.shape))
        return self._apply_chunk(qparams, ids, offset, slot)[0, last]

    def _fused_impl(self, qparams, ids, offset, last, slot, toks, pos):
        """Sarathi-style fused quantum: one call prefills one chunk into
        slot ``slot`` AND advances every live decode row. The chunk
        runs first, and the step only writes real K/V for live rows
        (the chunking row rides the decode side as junk at max_len-1),
        so the chunk's window survives the step intact. Returns (step
        logits [slots, vocab], the chunk's logits at ``last``)."""
        self._chunk_shapes.add(("fused", ids.shape, toks.shape))
        params = dequantize_tree(qparams)
        clogits = self._apply_chunk(params, ids, offset, slot)
        logits = apply(self.model, params, self._device_ids(toks)[:, None],
                       cache=self.kv.cache, decode=True,
                       decode_index=pos)
        return logits[:, 0], clogits[0, last]

    # -- client surface ----------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens, deadline_ms=None):
        """Admit one sequence (or raise ``OverloadedError``); returns a
        :class:`SeqHandle`. ``prompt_ids`` is a 1-D int sequence."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise errors.FeedSpecError("empty prompt")
        if min(prompt) < 0 or max(prompt) >= self.vocab_size:
            raise errors.FeedSpecError(
                "prompt ids outside [0, %d)" % self.vocab_size,
                spec="prompt", shape=(len(prompt),))
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise errors.FeedSpecError("max_new_tokens must be >= 1")
        total = len(prompt) + max_new
        if total > self.max_len:
            raise errors.FeedSpecError(
                "prompt+new %d exceeds max_len %d" % (total, self.max_len))
        now = self._clock()
        with self._work:
            suffix_est = len(prompt)
            if self.prefix is not None:
                suffix_est -= self.prefix.peek_len(prompt)
            queued_tok = sum(s.suffix_est for s in self._waiting)
            for s in self._prefill_q:
                queued_tok += max(0, len(s.prompt) - (s.next_off or 0))
            free = self.kv.free_slots
            if self.prefix is not None:
                # cached prefix rows are reclaimable on demand (LRU
                # evict), so they count as capacity, not occupancy
                free += self.kv.cached_rows
            self.admission.admit(
                free_slots=free, waiting=len(self._waiting),
                occupied=self.kv.occupied, slots=self.slots,
                suffix_tokens=suffix_est,
                queued_prefill_tokens=queued_tok)
            seq = _Seq(next(self._ids), prompt, max_new, deadline_ms, now)
            seq.suffix_est = suffix_est
            self._seqs[seq.id] = seq
            self._waiting.append(seq)
            _PREFILL_QUEUE.set(len(self._waiting))
            self._work.notify()
        return SeqHandle(self, seq)

    def generate(self, prompt_ids, max_new_tokens, deadline_ms=None,
                 timeout=None):
        """Blocking submit: the full report dict when the sequence
        finishes (tokens include the prompt, matching
        ``models.gpt.generate``)."""
        return self.submit(prompt_ids, max_new_tokens,
                           deadline_ms=deadline_ms).result(timeout)

    def handle(self, seq_id):
        with self._lock:
            seq = self._seqs.get(int(seq_id))
        if seq is None:
            raise errors.NotFoundError("unknown sequence %s" % seq_id)
        return SeqHandle(self, seq)

    def _poll(self, seq, start):
        with self._lock:
            if seq.error is not None:
                raise seq.error
            return list(seq.tokens[int(start):]), seq.done

    def _report(self, seq):
        with self._lock:
            if seq.error is not None:
                raise seq.error
            itl = sorted(seq.itl_ms)
            return {
                "tokens": seq.prompt + list(seq.tokens),
                "generated": list(seq.tokens),
                "ttft_ms": seq.ttft_ms,
                "itl_ms": list(seq.itl_ms),
                "itl_p50_ms": _pct(itl, 0.50),
                "itl_p99_ms": _pct(itl, 0.99),
            }

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self):
        return self._thread is not None

    def start(self):
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="decode-engine", daemon=True)
        self._thread.start()
        return self

    def drain(self, deadline_s=30.0):
        """Stop admitting, finish every in-flight sequence (waiting AND
        active), then return True; False if ``deadline_s`` elapsed with
        work still live. Zero stranded: nothing is dropped — waiting
        sequences still get slots as they free up. (The wait rides the
        engine condition var — every retire/evict notifies — not a
        poll.)"""
        self.admission.set_draining(True)
        deadline = self._clock() + deadline_s
        with self._work:
            self._work.notify_all()
            while self._waiting or self._by_slot or self._prefill_q:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return False
                self._work.wait(timeout=min(0.05, remaining))
            return True

    def stop(self):
        """Stop the device loop. Any sequence still live is resolved
        with a typed ``StopError`` so no client blocks forever — call
        :meth:`drain` first for a zero-stranded shutdown."""
        with self._work:
            self._stop = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        with self._lock:
            leftovers = (list(self._waiting) + list(self._prefill_q)
                         + list(self._by_slot.values()))
            self._waiting.clear()
            self._prefill_q.clear()
            for seq in leftovers:
                if seq.slot is not None:
                    self._by_slot.pop(seq.slot, None)
                    if self.prefix is not None:
                        self.prefix.forget(seq.slot)
                    self.kv.free(seq.slot)
                    seq.slot = None
                self._resolve_locked(seq, error=errors.StopError(
                    "engine stopped with sequence %d live" % seq.id))

    # -- the device loop ---------------------------------------------------

    def _loop(self):
        # grad mode is per thread: the caller's no_grad or inference
        # mode does not reach this one
        with torch.no_grad():
            self._serve_loop()

    def _serve_loop(self):
        while True:
            with self._work:
                if self._stop:
                    return
                if (not self._by_slot and not self._waiting
                        and not self._prefill_q):
                    self._work.wait(timeout=0.05)
                    if self._stop:
                        return
            self._admit_arrivals()
            self._service()

    def _service(self):
        """One scheduling quantum: at most ONE prefill chunk, fused
        with the decode step when rows are live (the Sarathi budget —
        residents pay one bounded chunk per step, never a monolithic
        prefill stall)."""
        with self._lock:
            chunk_seq = self._prefill_q[0] if self._prefill_q else None
        if chunk_seq is not None:
            now = self._clock()
            if (chunk_seq.deadline_ms is not None
                    and (now - chunk_seq.submitted_at) * 1000.0
                    > chunk_seq.deadline_ms):
                # budget burned mid-prefill: drop before device work
                with self._lock:
                    if self._prefill_q and self._prefill_q[0] is chunk_seq:
                        self._prefill_q.popleft()
                    self._evict_locked(chunk_seq)
                _SLOTS_OCCUPIED.set(self.kv.occupied)
                return
            self._run_chunk(chunk_seq)
        elif self._by_slot:
            self._run_step()

    def _admit_arrivals(self):
        while True:
            with self._lock:
                if not self._waiting:
                    return
                seq = self._waiting[0]
                if (seq.deadline_ms is not None
                        and (self._clock() - seq.submitted_at) * 1000.0
                        > seq.deadline_ms):
                    # dead on arrival: budget burned in the queue
                    self._waiting.popleft()
                    _PREFILL_QUEUE.set(len(self._waiting))
                    self._resolve_locked(
                        seq, error=self.admission.shed_evicted())
                    self._evicted += 1
                    _EVICTED.inc()
                    continue
                slot = self.kv.alloc()
                if slot is None and self.prefix is not None:
                    # allocator dry but idle cached rows exist: evict
                    # the LRU stored prefix and reclaim its row — reuse
                    # never reduces decode capacity
                    victim = self.prefix.evict_lru(self.kv.cached())
                    if victim is not None:
                        self.kv.release(victim)
                        slot = self.kv.alloc()
                if slot is None:
                    return
                self._waiting.popleft()
                _PREFILL_QUEUE.set(len(self._waiting))
            self._start_prefill(seq, slot)

    def _start_prefill(self, seq, slot):
        """Route one admitted sequence onto its prefill path: prefix
        lookup + row copy first (chaos point ``serve.decode.
        prefix_lookup``; any fault falls back losslessly to cold
        prefill), then either a monolithic/suffix prefill now, or —
        under chunking — park the sequence on the chunk queue and let
        its prefill ride the fused steps."""
        src, reused = None, 0
        if self.prefix is not None:
            try:
                if faults.PLANE is not None:
                    faults.PLANE.fire("serve.decode.prefix_lookup",
                                      seq=seq.id,
                                      prompt_len=len(seq.prompt))
                src, reused = self.prefix.lookup(seq.prompt)
            except Exception:  # noqa: BLE001 — lossless cold fallback
                self.prefix.note_miss()
                src, reused = None, 0
        if src is not None and reused > 0:
            try:
                self._reuse_impl(src, slot)
            except Exception:  # noqa: BLE001 — lossless cold fallback
                reused = 0
        seq.reuse_tokens = reused
        seq.next_off = reused
        if self.prefill_chunk:
            with self._work:
                seq.slot = slot
                self._prefill_q.append(seq)
                self._work.notify_all()
        elif reused > 0:
            self._prefill_suffix(seq, slot)
        else:
            self._prefill(seq, slot)

    def _prefill(self, seq, slot):
        plen = len(seq.prompt)
        bucket = _prefill_bucket(plen, self.max_len)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :plen] = seq.prompt
        t0 = time.monotonic()
        try:
            first = _argmax(self._prefill_impl(self.params, ids, plen, slot))
        except Exception as exc:  # noqa: BLE001 — fail one seq, not the loop
            self._drop_slot(slot)
            with self._lock:
                self._resolve_locked(seq, error=errors.DecodeStepError(
                    "prefill failed: %s" % exc))
                self._evicted += 1
            _EVICTED.inc()
            return
        # TTFT = submit -> first token; one interval feeds the histogram,
        # the admission EWMA and the per-seq report
        prefill_ms = (time.monotonic() - t0) * 1000.0
        self.admission.observe_prefill_ms(prefill_ms, tokens=plen)
        with self._lock:
            self._prefilled_tokens += plen
        self._finish_prefill(seq, slot, first)

    def _prefill_suffix(self, seq, slot):
        """Prefill ONLY the suffix after a prefix hit: one offset-chunk
        call over a power-of-two window ending at the prompt's tail.
        The window may slide back over the reused span (when the padded
        width overruns ``max_len``) — overlap recomputes bit-identical
        K/V, so correctness never depends on the slide."""
        plen = len(seq.prompt)
        width = _prefill_bucket(plen - seq.next_off, self.max_len)
        start = min(seq.next_off, self.max_len - width)
        span = min(width, plen - start)
        ids = np.zeros((1, width), np.int32)
        ids[0, :span] = seq.prompt[start:start + span]
        t0 = time.monotonic()
        try:
            first = _argmax(self._chunk_impl(self.params, ids, start,
                                             plen - 1 - start, slot))
        except Exception as exc:  # noqa: BLE001 — fail one seq, not the loop
            self._drop_slot(slot)
            with self._lock:
                self._resolve_locked(seq, error=errors.DecodeStepError(
                    "suffix prefill failed: %s" % exc))
                self._evicted += 1
            _EVICTED.inc()
            return
        # same stopwatch-pair contract as _prefill (allowlisted site)
        suffix_ms = (time.monotonic() - t0) * 1000.0
        suffix_tokens = plen - seq.next_off
        self.admission.observe_prefill_ms(suffix_ms, tokens=suffix_tokens)
        with self._lock:
            self._prefilled_tokens += suffix_tokens
        self._finish_prefill(seq, slot, first)

    def _finish_prefill(self, seq, slot, first):
        """Common prefill completion: store the prompt's path in the
        trie (the row is a valid donor from here on — decode only
        writes positions >= prompt_len) and activate the sequence."""
        if self.prefix is not None:
            self.prefix.insert(seq.prompt, slot)
        with self._lock:
            seq.slot = slot
            seq.pos = len(seq.prompt)
            seq.tok = first
            seq.tokens.append(first)
            now = self._clock()
            seq.ttft_ms = (now - seq.submitted_at) * 1000.0
            seq.last_emit = now
            self._tokens_total += 1
            self._by_slot[slot] = seq
            ttft = seq.ttft_ms
            if len(seq.tokens) >= seq.max_new:
                self._retire_locked(seq)
        _TTFT.observe(ttft)
        _TOKENS.inc()
        _SLOTS_OCCUPIED.set(self.kv.occupied)

    def _plan_chunk(self, seq):
        """Host-side plan for the next chunk of ``seq``'s prefill:
        (padded ids [1, C], window start, last-valid index, tokens of
        NEW progress, final?). The window slides back when it would
        overrun ``max_len`` (or, on the final chunk, past the prompt
        tail) — overlapped positions recompute identical K/V."""
        plen = len(seq.prompt)
        width = self.prefill_chunk
        start = min(seq.next_off, max(0, self.max_len - width))
        span = min(width, plen - start)
        ids = np.zeros((1, width), np.int32)
        ids[0, :span] = seq.prompt[start:start + span]
        end = start + span
        progress = end - seq.next_off
        final = end >= plen
        last = (plen - 1 - start) if final else (span - 1)
        return ids, start, last, progress, final

    def _run_chunk(self, seq):
        """One chunked-prefill quantum: fuse the chunk with the decode
        step when rows are live (ONE dispatch — residents' ITL pays a
        bounded chunk, not a monolithic prefill), solo otherwise."""
        ids, start, last, progress, final = self._plan_chunk(seq)
        toks = np.zeros(self.slots, np.int32)
        # junk writes for non-live rows land at max_len-1: a position
        # every future tenant overwrites before attending, so steps
        # never corrupt cached prefixes or half-prefilled rows
        pos = np.full(self.slots, self.max_len - 1, np.int32)
        with self._lock:
            active = dict(self._by_slot)
            for slot, s in active.items():
                toks[slot] = s.tok
                pos[slot] = s.pos
        t0 = time.monotonic()
        try:
            if active:
                if faults.PLANE is not None:
                    faults.PLANE.fire("serve.decode.step",
                                      active=len(active),
                                      step=self._steps_total)
                logits, clog = self._fused_impl(
                    self.params, ids, start, last, seq.slot, toks, pos)
                nxt = _argmax_rows(logits)
            else:
                clog = self._chunk_impl(self.params, ids, start, last,
                                        seq.slot)
                nxt = None
            first = _argmax(clog) if final else None
        except Exception as exc:  # noqa: BLE001 — fail the quantum's
            with self._lock:      # seqs, never the loop
                if self._prefill_q and self._prefill_q[0] is seq:
                    self._prefill_q.popleft()
                self._evict_locked(seq, error=errors.DecodeStepError(
                    "prefill chunk faulted for seq %d: %s"
                    % (seq.id, exc)))
            self._fail_step(active, exc)
            return
        quantum_ms = (time.monotonic() - t0) * 1000.0
        # the chunk's EWMA charge includes the fused step's share — a
        # conservative (early-shedding) per-token estimate
        self.admission.observe_prefill_ms(quantum_ms,
                                          tokens=max(1, progress))
        with self._lock:
            self._prefilled_tokens += progress
            seq.next_off += progress
        if active:
            self._finish_step(active, nxt, quantum_ms)
        if final:
            with self._lock:
                if self._prefill_q and self._prefill_q[0] is seq:
                    self._prefill_q.popleft()
            self._finish_prefill(seq, seq.slot, first)

    def _run_step(self):
        toks = np.zeros(self.slots, np.int32)
        # junk writes for non-live rows land at max_len-1 (see
        # _run_chunk) — never position 0, which a cached prefix row's
        # donor span may need intact
        pos = np.full(self.slots, self.max_len - 1, np.int32)
        with self._lock:
            active = dict(self._by_slot)
            for slot, seq in active.items():
                toks[slot] = seq.tok
                pos[slot] = seq.pos
        t0 = time.monotonic()
        try:
            if faults.PLANE is not None:
                faults.PLANE.fire("serve.decode.step",
                                  active=len(active),
                                  step=self._steps_total)
            nxt = _argmax_rows(self._step_impl(self.params, toks, pos))
        except Exception as exc:  # noqa: BLE001 — fail the step's seqs,
            self._fail_step(active, exc)  # never the loop
            return
        step_ms = (time.monotonic() - t0) * 1000.0
        self._finish_step(active, nxt, step_ms)

    def _finish_step(self, active, nxt_tokens, step_ms):
        """Post-step bookkeeping shared by the pure and fused paths:
        fold the interval into the ITL plane and advance every active
        row (append its token of ``nxt_tokens``, the argmax of each
        slot's logits; retire/evict on completion/deadline).

        Two ITL planes on purpose: the admission EWMA and the _ITL
        histogram see ``step_ms`` (the device step cost the shed
        projection prices), while each sequence's report ``itl_ms``
        records the CLIENT-VISIBLE wall gap since its previous token —
        the gap is what a monolithic prefill stall inflates and what
        chunked prefill bounds."""
        self.admission.observe_itl_ms(step_ms)
        _ITL.observe(step_ms)
        _STEPS.inc()
        now = self._clock()
        done_or_evicted = False
        with self._lock:
            self._steps_total += 1
            for slot, seq in active.items():
                nxt = int(nxt_tokens[slot])
                seq.tokens.append(nxt)
                seq.itl_ms.append((now - seq.last_emit) * 1000.0)
                seq.last_emit = now
                seq.pos += 1
                seq.tok = nxt
                self._tokens_total += 1
                _TOKENS.inc()
                if len(seq.tokens) >= seq.max_new:
                    self._retire_locked(seq)
                    done_or_evicted = True
                elif (seq.deadline_ms is not None
                        and (now - seq.submitted_at) * 1000.0
                        > seq.deadline_ms):
                    self._evict_locked(seq)
                    done_or_evicted = True
        if done_or_evicted:
            _SLOTS_OCCUPIED.set(self.kv.occupied)

    def _fail_step(self, active, exc):
        """A faulted fused step fails ONLY the sequences in it: typed
        error, slots freed, loop keeps running (never wedged)."""
        with self._lock:
            for seq in active.values():
                self._evict_locked(seq, error=errors.DecodeStepError(
                    "decode step faulted for seq %d: %s" % (seq.id, exc)))
        _SLOTS_OCCUPIED.set(self.kv.occupied)

    def _retire_locked(self, seq):
        if seq.slot is not None:
            self._by_slot.pop(seq.slot, None)
            self._release_slot_locked(seq.slot)
            seq.slot = None
        self._sequences_done += 1
        self._resolve_locked(seq)

    def _evict_locked(self, seq, error=None):
        if seq.slot is not None:
            self._by_slot.pop(seq.slot, None)
            self._release_slot_locked(seq.slot, keep_cached=False)
            seq.slot = None
        self._evicted += 1
        _EVICTED.inc()
        if error is None:
            error = self.admission.shed_evicted()
        self._resolve_locked(seq, error=error)

    def _release_slot_locked(self, slot, keep_cached=True):
        """Return a slot to the allocator — or, on the RETIRE path with
        its prompt stored in the trie, retain it as a cached prefix
        donor (decode only wrote positions >= prompt_len, so the prefix
        span is intact). Evictions always forget+free: a faulted or
        deadline-killed row is not a trustworthy donor."""
        if (keep_cached and self.prefix is not None
                and self.prefix.has(slot)):
            self.kv.retain(slot)
        else:
            if self.prefix is not None:
                self.prefix.forget(slot)
            self.kv.free(slot)

    def _drop_slot(self, slot):
        """Failure-path slot return (outside the engine lock)."""
        if self.prefix is not None:
            self.prefix.forget(slot)
        self.kv.free(slot)

    def _resolve_locked(self, seq, error=None):
        seq.error = error
        seq.done = True
        seq.event.set()
        self._work.notify_all()  # wake drain()

    # -- observability -----------------------------------------------------

    def stats(self):
        with self._lock:
            waiting = len(self._waiting)
            prefilling = len(self._prefill_q)
            active = len(self._by_slot)
            steps = self._steps_total
            prefilled = self._prefilled_tokens
        occ = self.kv.occupied
        if self.prefix is not None:
            prefix = self.prefix.stats()
            prefix["enabled"] = True
            prefix["cached_rows"] = self.kv.cached_rows
            reused = prefix["reuse_tokens"]
            prefix["reuse_frac"] = (
                reused / float(reused + prefilled)
                if (reused + prefilled) else 0.0)
        else:
            prefix = {"enabled": False}
        return {
            "decode_slots_total": self.slots,
            "decode_slots_occupied": occ,
            "decode_slot_frac": occ / float(self.slots),
            "decode_waiting": waiting,
            "decode_prefilling": prefilling,
            "decode_active": active,
            "decode_steps_total": steps,
            "decode_step_traces": len(self._step_shapes),
            "decode_prefill_traces": len(self._prefill_shapes),
            "decode_chunk_traces": len(self._chunk_shapes),
            "decode_prefill_chunk": self.prefill_chunk,
            "decode_prefilled_tokens": prefilled,
            "decode_prefix": prefix,
            "decode_tokens_total": self._tokens_total,
            "decode_sequences_total": self._sequences_done,
            "decode_evicted_total": self._evicted,
            "decode_ttft_p50_ms": _TTFT.percentile(0.50),
            "decode_ttft_p99_ms": _TTFT.percentile(0.99),
            "decode_itl_p50_ms": _ITL.percentile(0.50),
            "decode_itl_p99_ms": _ITL.percentile(0.99),
            "decode_kv_bytes": self.kv.bytes(),
            "decode_admission": self.admission.stats(),
        }


def _argmax(logits):
    """The greedy token of one logits row, as a Python int (first index
    on ties, as numpy's argmax)."""
    return int(torch.argmax(logits))


def _argmax_rows(logits):
    """The greedy token of every row of [rows, vocab] logits, as a numpy
    array (one device-to-host copy of ``rows`` ints)."""
    return torch.argmax(logits, dim=-1).cpu().numpy()


def _prefill_bucket(prompt_len, max_len):
    """Pad prompts to power-of-two buckets: prefill compile count is
    O(log max_len), not O(distinct prompt lengths)."""
    b = 1
    while b < prompt_len:
        b <<= 1
    return min(b, max_len)


def _pct(sorted_vals, q):
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]
