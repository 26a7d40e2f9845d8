"""Teacher inference server — the port of ``edl_tpu/distill/teacher_server.py``.

Serves a model function over the framed-RPC substrate (wire-compatible
with the JAX package's, so either side's clients and servers interoperate):

- ``get_feed_fetch()`` — feed/fetch name+shape introspection;
- ``predict(feed)`` — feed dict of ndarrays → fetch dict of ndarrays.
  Inputs are padded to a fixed batch size (``max_batch``);
- ``stats()`` — device-batch occupancy counters.

Adaptive batching: handler threads enqueue (feed, future) items and a
single device thread coalesces queued requests from any client into one
device batch, copying rows into a reused staging buffer and scattering
row slices of the output back to each waiter.

The model builders run on CUDA unless the caller passes
``device="cpu"``. ``gpt_teacher`` is the ported one; ``lm_teacher`` (the
decode engine) and the ResNet teachers come with later slices.
"""

import argparse
import queue
import signal
import threading
import time

import numpy as np
import torch
from torch.func import functional_call

from edl_tpu_torch.models import gpt
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.ops import quant
from edl_tpu_torch.robustness import faults
from edl_tpu_torch.robustness.policy import Deadline
from edl_tpu_torch.rpc import ndarray as nd
from edl_tpu_torch.rpc.server import FEATURES as _RPC_FEATURES
from edl_tpu_torch.rpc.server import RpcServer
from edl_tpu_torch.serve.admission import AdmissionController
from edl_tpu_torch.utils import errors
from edl_tpu_torch.utils.device import resolve_device
from edl_tpu_torch.utils.logger import logger

_DEVICE_BATCHES = obs_metrics.counter(
    "edl_teacher_batches_total", "teacher device-batch executions")
_DEVICE_ROWS = obs_metrics.counter(
    "edl_teacher_rows_total", "real (unpadded) rows served")
_BATCH_FILL = obs_metrics.histogram(
    "edl_teacher_batch_fill", "real rows per device execution as a "
    "fraction of max_batch",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_TEACHER_QUEUE = obs_metrics.gauge(
    "edl_teacher_queue_depth", "requests waiting for the device thread")

#: seed of the random weights a model teacher serves without ``params``
INIT_SEED = 0


class _ItemFuture(object):
    """Rendezvous between a handler thread and the device thread."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None

    def set(self, value=None, error=None):
        self._value, self._error = value, error
        self._event.set()

    def result(self, timeout):
        if not self._event.wait(timeout):
            raise errors.RpcError("device thread never served the batch")
        if self._error is not None:
            raise self._error
        return self._value


class _BatchItem(object):
    __slots__ = ("feed", "n", "future", "admitted_at", "deadline_ms")

    def __init__(self, feed, n, admitted_at=None, deadline_ms=None):
        self.feed = feed
        self.n = n
        self.future = _ItemFuture()
        self.admitted_at = admitted_at
        self.deadline_ms = deadline_ms


class TeacherServer(object):
    """Wrap ``predict_fn(feed: dict[str, np.ndarray]) -> dict`` behind RPC.

    Contract: ``predict_fn`` must treat the feed arrays as READ-ONLY
    (they may be zero-copy views into the decoded request, or — under
    adaptive batching — slices of a reused staging buffer that is only
    valid for the duration of the call); copy first to keep or mutate.

    ``feed_specs``/``fetch_specs``: {name: (shape_without_batch, dtype_str)}.
    ``max_batch``: server-side device batch size; requests are padded up
    and sliced back, so every device batch has one shape.
    ``adaptive_batch``: coalesce concurrent requests into shared device
    batches on a single device thread (default). False restores the
    serial pad-and-lock path (the bench baseline / escape hatch).
    ``batch_timeout_ms``: how long the device thread may wait for more
    requests when a batch is still short of ``max_batch``. The default
    0 never delays — it coalesces whatever is already queued (pipelined
    clients keep the queue full), so a lone request pays no latency tax.
    """

    def __init__(self, predict_fn, feed_specs, fetch_specs, max_batch=128,
                 host="0.0.0.0", port=0, adaptive_batch=True,
                 batch_timeout_ms=0.0, admission=None):
        self._fn = predict_fn
        # admission control (serve/admission.py): None/True builds the
        # default controller (bounded queue only — no rate limit, no
        # projection shed until configured, so plain fleets behave as
        # before); False disables it; an AdmissionController instance
        # is used as-is (the serve-plane configuration surface)
        if admission is False:
            self._admission = None
        elif admission is None or admission is True:
            self._admission = AdmissionController()
        else:
            self._admission = admission
        self._feed_specs = {k: (list(s), d) for k, (s, d)
                            in feed_specs.items()}
        self._fetch_specs = {k: (list(s), d) for k, (s, d)
                             in fetch_specs.items()}
        self._max_batch = max_batch
        self._adaptive = bool(adaptive_batch)
        self._batch_timeout = max(0.0, float(batch_timeout_ms)) / 1000.0
        self._lock = threading.Lock()  # serializes device access (sync path)
        self._queue = queue.Queue()
        self._stop_ev = threading.Event()
        self._device_thread = None
        self._bufs = {}  # group key -> {name: staging array}
        self._stats_lock = threading.Lock()
        self._batches = 0   # device executions
        self._rows = 0      # real (unpadded) rows served
        self._rpc = RpcServer(host=host, port=port)
        self._rpc.register("get_feed_fetch", self.get_feed_fetch)
        self._rpc.register("predict", self._predict_rpc)
        self._rpc.register("stats", self.stats)
        self._rpc.register("set_knobs", self.apply_knobs)
        self._rpc.register("drain", self.drain)

    def get_feed_fetch(self):
        features = list(_RPC_FEATURES)
        if self._adaptive:
            features.append("adaptive_batch")
        if self._admission is not None:
            features.append("serve.admission")
        return {"feed": self._feed_specs, "fetch": self._fetch_specs,
                "max_batch": self._max_batch, "features": features,
                "batch_timeout_ms": self._batch_timeout * 1000.0}

    def apply_knobs(self, knobs):
        """Runtime tuning surface (``set_knobs`` RPC — the same contract
        as the reader's: apply known knobs, ignore unknown ones, return
        what was applied). ``batch_timeout_ms`` (clamped >= 0, <= 1000)
        retunes the device thread's coalescing wait on the fly; the
        thread reads it per batch, so the new value takes effect on the
        next coalescing round."""
        if not isinstance(knobs, dict):
            return {}
        applied = {}
        if "batch_timeout_ms" in knobs:
            try:
                ms = max(0.0, min(1000.0,
                                  float(knobs["batch_timeout_ms"])))
            except (TypeError, ValueError):
                ms = None
            if ms is not None:
                self._batch_timeout = ms / 1000.0
                applied["batch_timeout_ms"] = ms
        return applied

    def stats(self):
        """Batch-occupancy counters (``occupancy`` is the fraction of
        device-batch rows that carried real requests) plus — with
        admission control on — the serving-plane signals the
        ``ServeScaler`` folds: queue depth, pending rows, projected
        queue wait, shed counters, and the draining flag. Served as a
        plain (non-pipelined) RPC the substrate dispatches inline on
        the connection read thread, so this stays answerable while the
        device queue is saturated — observability survives overload."""
        with self._stats_lock:
            batches, rows = self._batches, self._rows
        cap = batches * self._max_batch
        out = {
            "batches": batches, "rows": rows,
            "max_batch": self._max_batch,
            "occupancy": (rows / cap) if cap else 0.0,
            "queue_depth": self._queue.qsize(),
        }
        if self._admission is not None:
            out.update(self._admission.stats())
        return obs_metrics.mirror_stats("edl_teacher", out)

    def drain(self, deadline_s=30.0):
        """Drain-safe shutdown, step 3 of the decommission protocol
        (serve/drain.py): flip admission to ``draining`` (new predicts
        get a typed OverloadedError the reader requeues elsewhere),
        then wait until the device queue and every admitted row have
        resolved. Returns a report; ``drained: False`` means in-flight
        work outlived ``deadline_s`` — the caller decides whether to
        stop anyway (the device loop's shutdown drain still resolves
        every queued future, so nothing is ever silently lost)."""
        if faults.PLANE is not None:
            faults.PLANE.fire("serve.drain", endpoint=self.endpoint,
                              pending=self._queue.qsize())
        if self._admission is not None:
            self._admission.set_draining(True)
        deadline = Deadline(deadline_s if deadline_s else 30.0)
        served_before = self._rows
        while not self._drained():
            if not deadline.sleep(0.02):
                break
        with self._stats_lock:
            served = self._rows - served_before
        return {"drained": self._drained(),
                "endpoint": self.endpoint,
                "queue_depth": self._queue.qsize(),
                "pending_rows": (0 if self._admission is None
                                 else self._admission.stats()
                                 ["pending_rows"]),
                "served_during_drain": served}

    def _drained(self):
        if self._adaptive and self._queue.qsize() > 0:
            return False
        return self._admission is None or self._admission.idle()

    def _validate(self, feed):
        """Reject malformed feeds with a typed FeedSpecError naming the
        offending spec and shape. FeedSpecError subclasses
        DataAccessError, so the reader surfaces it to the consumer in
        order (poisoned task, never retried) — retrying a permanently
        bad feed against other teachers would ping-pong it forever."""
        missing = set(self._feed_specs) - set(feed)
        if missing:
            name = sorted(missing)[0]
            raise errors.FeedSpecError(
                "missing feeds: %s" % sorted(missing), spec=name,
                shape=tuple(self._feed_specs[name][0]))
        n, first = None, None
        for name, arr in feed.items():
            if n is None:
                n, first = len(arr), name
            elif len(arr) != n:
                raise errors.FeedSpecError(
                    "feed batch mismatch: %s has %d rows, %s has %d"
                    % (first, n, name, len(arr)), spec=name,
                    shape=tuple(np.asarray(arr).shape))
        if n == 0:
            raise errors.FeedSpecError("empty batch", spec=first,
                                       shape=(0,))
        if n > self._max_batch:
            raise errors.FeedSpecError(
                "batch %d exceeds max_batch %d" % (n, self._max_batch),
                spec=first, shape=tuple(np.asarray(feed[first]).shape))
        return n

    def _predict_rpc(self, feed_encoded, deadline_ms=None):
        # v2 tensor frames deliver feeds as owned arrays recv'd
        # straight off the socket (framing.py MAGIC_V2); decode_tree
        # is then a no-op but keeps pre-v2 senders (tagged-dict
        # payloads) working. Contract stays uniform: treat feeds as
        # immutable — copy first if an implementation must mutate.
        feed = nd.decode_tree(feed_encoded, copy=False)
        feed = {k: np.asarray(v) for k, v in feed.items()}
        n = self._validate(feed)
        # the admission decision (serve/admission.py): shed NOW with a
        # typed OverloadedError instead of queueing work the SLO has
        # already lost; ``deadline_ms`` is the caller's per-request
        # budget — the device loop sheds dead-on-arrival items
        admitted_at = None
        if self._admission is not None:
            admitted_at = self._admission.admit(n)
        if not self._adaptive:
            t0 = time.monotonic()
            try:
                return self._predict_serial(feed, n)
            finally:
                if self._admission is not None:
                    self._admission.release(
                        n, service_s=time.monotonic() - t0)
        item = _BatchItem(feed, n, admitted_at=admitted_at,
                          deadline_ms=deadline_ms)
        self._queue.put(item)
        _TEACHER_QUEUE.set(self._queue.qsize())
        # generous rendezvous bound: the device thread always resolves
        # every item it dequeues (success, error, or shutdown drain)
        return item.future.result(timeout=600.0)

    def _predict_serial(self, feed, n):
        """The pre-batching path: pad this request alone to max_batch
        behind the device lock. Kept as the bench baseline and the
        ``adaptive_batch=False`` escape hatch."""
        padded = {}
        for name, arr in feed.items():
            if n < self._max_batch:
                pad = np.zeros((self._max_batch - n,) + arr.shape[1:],
                               arr.dtype)
                arr = np.concatenate([arr, pad], axis=0)
            padded[name] = arr
        with self._lock:
            out = self._fn(padded)
            with self._stats_lock:
                self._batches += 1
                self._rows += n
        _DEVICE_BATCHES.inc()
        _DEVICE_ROWS.inc(n)
        _BATCH_FILL.observe(n / float(self._max_batch))
        # raw arrays: the v2 tensor frame ships them out-of-band with
        # no tobytes()/msgpack-bin copies (framing.py MAGIC_V2)
        return {k: np.asarray(v)[:n] for k, v in out.items()}

    # -- the device thread -------------------------------------------------

    @staticmethod
    def _group_key(feed):
        """Requests may only share a device batch when their feeds
        agree on everything but the row count."""
        return tuple(sorted((name, arr.shape[1:], arr.dtype.str)
                            for name, arr in feed.items()))

    def _buffers(self, key):
        bufs = self._bufs.get(key)
        if bufs is None:
            if len(self._bufs) >= 8:  # bound staging memory under churn
                self._bufs.pop(next(iter(self._bufs)))
            bufs = self._bufs[key] = {
                name: np.zeros((self._max_batch,) + tuple(trail),
                               np.dtype(dt))
                for name, trail, dt in key}
        return bufs

    def _dead_on_arrival(self, item):
        """Shed a queued item whose per-request deadline elapsed while
        it waited — running it would burn device time on a reply the
        caller has already abandoned."""
        if (self._admission is None or item.admitted_at is None
                or not self._admission.expired(item.admitted_at,
                                               item.deadline_ms)):
            return False
        item.future.set(error=self._admission.shed_expired(item.n))
        return True

    def _device_loop(self):
        carry = None
        while not self._stop_ev.is_set():
            if carry is not None:
                item, carry = carry, None
            else:
                try:
                    item = self._queue.get(timeout=0.2)
                except queue.Empty:
                    continue
            if self._dead_on_arrival(item):
                continue
            key = self._group_key(item.feed)
            group, rows = [item], item.n
            deadline = time.monotonic() + self._batch_timeout
            while rows < self._max_batch:
                # timeout 0 = drain only what is already queued; a
                # positive budget waits for stragglers but a full
                # batch always flushes immediately
                try:
                    nxt = self._queue.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if self._dead_on_arrival(nxt):
                    continue
                if (self._group_key(nxt.feed) != key
                        or rows + nxt.n > self._max_batch):
                    carry = nxt  # incompatible: heads the next batch
                    break
                group.append(nxt)
                rows += nxt.n
            self._run_group(key, group, rows)
        # shutdown drain: never leave a handler thread parked forever
        pending = [carry] if carry is not None else []
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for item in pending:
            item.future.set(error=errors.StopError("teacher stopping"))
            if self._admission is not None and item.admitted_at \
                    is not None:
                self._admission.release(item.n)

    def _run_group(self, key, group, rows):
        t0 = time.monotonic()
        try:
            if len(group) == 1 and rows == self._max_batch:
                feed = group[0].feed  # already full: run it in place
            else:
                bufs = self._buffers(key)
                lo = 0
                for item in group:
                    for name, arr in item.feed.items():
                        bufs[name][lo:lo + item.n] = arr
                    lo += item.n
                if rows < self._max_batch:
                    # zero the pad tail: stale rows from the previous
                    # batch must not leak into this execution (keeps
                    # outputs bit-identical with the serial zero-pad)
                    for name in bufs:
                        bufs[name][rows:] = 0
                feed = bufs
            out = self._fn(feed)
            outs = {}
            for k, v in out.items():
                v = np.asarray(v)
                if any(np.may_share_memory(v, b) for b in feed.values()):
                    # a passthrough fn returned (a view of) the staging
                    # buffer; the next batch would overwrite it while
                    # responses are still being serialized
                    v = v.copy()
                outs[k] = v
            with self._stats_lock:
                self._batches += 1
                self._rows += rows
            _DEVICE_BATCHES.inc()
            _DEVICE_ROWS.inc(rows)
            _BATCH_FILL.observe(rows / float(self._max_batch))
        except Exception as e:  # noqa: BLE001 — fail every waiter, keep serving
            for item in group:
                item.future.set(error=e)
            if self._admission is not None:
                self._admission.release(rows)
            return
        if self._admission is not None:
            # the device wall time of this batch feeds the queue-wait
            # projection (the EWMA admission sheds against)
            self._admission.release(rows,
                                    service_s=time.monotonic() - t0)
        lo = 0
        for item in group:
            item.future.set(value={k: v[lo:lo + item.n]
                                   for k, v in outs.items()})
            lo += item.n

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._adaptive and self._device_thread is None:
            self._stop_ev.clear()
            self._device_thread = threading.Thread(
                target=self._device_loop, daemon=True,
                name="teacher-device")
            self._device_thread.start()
        self._rpc.start()
        logger.info("teacher serving on %s (max_batch=%d, adaptive=%s)",
                    self._rpc.endpoint, self._max_batch, self._adaptive)
        return self

    @property
    def endpoint(self):
        return self._rpc.endpoint

    @property
    def port(self):
        return self._rpc.port

    def stop(self):
        self._rpc.stop()
        if self._device_thread is not None:
            self._stop_ev.set()
            self._device_thread.join(timeout=5)
            self._device_thread = None


def nop_teacher(fetch_specs, max_batch=128, host="0.0.0.0", port=0,
                feed_specs=None, **kwargs):
    """A fake teacher returning zeros — the test backend (reference parity:
    _TestNopPaddlePredictServer, distill_worker.py:324-333)."""
    feed_specs = feed_specs or {"ins": ([1], "<f4")}

    def predict(feed):
        n = max_batch
        return {name: np.zeros((n,) + tuple(shape), np.dtype(dtype))
                for name, (shape, dtype) in fetch_specs.items()}

    return TeacherServer(predict, feed_specs, fetch_specs,
                         max_batch=max_batch, host=host, port=port,
                         **kwargs)


def gpt_teacher(num_layers=2, d_model=64, num_heads=4, mlp_dim=128,
                vocab_size=256, seq_len=32, max_batch=64, host="0.0.0.0",
                port=0, params=None, quantize=None, device=None, **kwargs):
    """A causal-LM teacher: per-position next-token logits + probs —
    sequence-level knowledge distillation. Fixed ``seq_len``; clients
    pad shorter sequences.

    ``params``: a trained flax ``Gpt`` param tree (nested dicts of
    arrays, as the JAX package's ``gpt_teacher`` takes it) makes it a
    real teacher; ``None`` serves random weights from ``INIT_SEED`` as
    a shape-true stand-in. ``quantize``: None | "int8" | "bf16" — serve
    from absmax per-channel int8 (or bf16) kernels (ops/quant.py),
    dequantized inside each forward so the quantized tensors are what
    stays in device memory. ``device``: None means CUDA (raises without
    a card); pass "cpu" to run on the CPU."""
    device = resolve_device(device)
    model = gpt.Gpt(num_layers=num_layers, d_model=d_model,
                    num_heads=num_heads, mlp_dim=mlp_dim,
                    vocab_size=vocab_size, max_len=max(seq_len, 16),
                    dtype=torch.bfloat16, device=device)
    if params is None:
        model.init_weights(
            torch.Generator(device=device).manual_seed(INIT_SEED))
    else:
        model.load_state_dict(gpt.params_from_flax(params))
    state = {k: v.detach() for k, v in model.state_dict().items()}
    if quantize is not None:
        state = quant.quantize_tree(state, quantize)
    # the module keeps only its structure: ``state`` holds the weights
    model.to("meta")

    def predict(feed):
        # np.array copies: the feed may be a view of a staging buffer
        # that the next batch overwrites
        ids = np.array(feed["input_ids"], np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= vocab_size):
            raise errors.FeedSpecError(
                "input_ids outside [0, %d)" % vocab_size,
                spec="input_ids", shape=ids.shape)
        with torch.inference_mode():
            ids = torch.from_numpy(ids).to(device)
            logits = functional_call(model, quant.dequantize_tree(state),
                                     (ids,))
            probs = torch.softmax(logits, dim=-1)
            return {"logits": logits.cpu().numpy(),
                    "probs": probs.cpu().numpy()}

    return TeacherServer(
        predict,
        feed_specs={"input_ids": ([seq_len], "<i4")},
        fetch_specs={"logits": ([seq_len, vocab_size], "<f4"),
                     "probs": ([seq_len, vocab_size], "<f4")},
        max_batch=max_batch, host=host, port=port, **kwargs)


def main():
    p = argparse.ArgumentParser("edl_tpu_torch teacher server")
    p.add_argument("--model", default="nop", choices=["nop", "gpt"],
                   help="nop: zeros; gpt: the causal-LM teacher. The "
                   "resnet/resnext and lm teachers are not ported yet")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device for the model (default: cuda)")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--vocab_size", type=int, default=256)
    p.add_argument("--seq_len", type=int, default=32)
    args = p.parse_args()
    if args.model == "gpt":
        server = gpt_teacher(vocab_size=args.vocab_size,
                             seq_len=args.seq_len,
                             max_batch=args.max_batch, port=args.port,
                             device=args.device)
    else:
        # image-shaped feeds, interchangeable with an image teacher
        server = nop_teacher(
            {"logits": ([args.num_classes], "<f4"),
             "probs": ([args.num_classes], "<f4")},
            feed_specs={"image": ([args.image_size, args.image_size, 3],
                                  "<f4")},
            max_batch=args.max_batch, port=args.port)
    server.start()
    print("TEACHER_ENDPOINT=%s" % server.endpoint, flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.stop()


if __name__ == "__main__":
    main()
