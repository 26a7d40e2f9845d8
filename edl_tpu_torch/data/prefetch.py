"""Host-to-device prefetch: ``edl_tpu/data/prefetch.py``'s
``DevicePrefetcher`` on one torch device.

A background thread pulls host batches, copies them onto the device and
keeps ``size`` batches in flight; the training loop consumes batches
already on the device, so the host work and the copy run behind the
previous step's compute.

On CUDA each batch is staged in pinned host memory and copied on a side
stream; the batch goes into the queue with an event recorded after its
copy. The consumer's stream waits on that event, and each tensor is
marked as used by the consumer's stream (``record_stream``), so a batch
is never read before it lands and its memory is not reused while the
consumer's kernels still read it. Pinning is what a CUDA target is
given, by the caller's choice of device; a CPU target takes the host
tensors as they are.
"""

import queue
import threading
import time

import torch

from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils.device import resolve_device

_END = object()

_PREFETCH_DEPTH = obs_metrics.gauge(
    "edl_prefetch_queue_depth", "device-resident batches staged ahead")


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


class DevicePrefetcher(object):
    """Iterate device-resident batches, ``size`` transfers ahead.

    host_iter: yields batches, nested dicts/lists/tuples of numpy arrays
    or CPU tensors. device: the target torch device (None means CUDA,
    and raises without a card). transform: optional host-side function
    applied to each host batch before the transfer (e.g. a dtype cast).
    Stop early with ``close()``; the thread is a daemon, so an abandoned
    prefetcher never blocks interpreter exit.
    """

    def __init__(self, host_iter, device=None, size=2, transform=None):
        self.device = resolve_device(device)
        self._q = queue.Queue(maxsize=max(1, size))
        self._stop = threading.Event()
        self._err = None
        self._exhausted = False
        self._closed = False
        # overlap accounting: how long the consumer waited on __next__
        # vs how long the pump waited on the host iterator — the two
        # numbers that say which side of the pipeline is the bottleneck
        self._stats_lock = threading.Lock()
        self._batches = 0
        self._consumer_wait_s = 0.0
        self._pump_wait_s = 0.0
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None

        def pump():
            try:
                it = iter(host_iter)
                while True:
                    t0 = time.monotonic()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    finally:
                        with self._stats_lock:
                            self._pump_wait_s += time.monotonic() - t0
                    if self._stop.is_set():
                        return
                    if transform is not None:
                        batch = transform(batch)
                    item = self._transfer(batch)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001 — surface on next()
                self._err = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(_END, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=pump, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _transfer(self, batch):
        """``(device batch, event)``: on CUDA the pinned copy on the side
        stream and the event recorded after it; elsewhere (batch, None)."""
        if self._stream is None:
            return _map(lambda x: torch.as_tensor(x).to(self.device),
                        batch), None
        with torch.cuda.stream(self._stream):
            out = _map(lambda x: torch.as_tensor(x).pin_memory().to(
                self.device, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def __iter__(self):
        return self

    def __next__(self):
        # iterator contract: keep raising StopIteration after exhaustion
        # or close() — never park on the empty queue
        if self._exhausted or self._stop.is_set():
            raise StopIteration
        t0 = time.monotonic()
        item = self._q.get()
        _PREFETCH_DEPTH.set(self._q.qsize())
        with self._stats_lock:
            self._consumer_wait_s += time.monotonic() - t0
            if item is not _END:
                self._batches += 1
        if item is _END:
            self._exhausted = True
            if self._err is not None:
                # re-raise on the CONSUMER thread as the same type,
                # explicitly chained so the pump's traceback (the real
                # failure site inside host_iter / transform / the copy)
                # survives into the report instead of pointing here
                err = self._err
                try:
                    wrapper = type(err)(*err.args)
                except TypeError:
                    # exotic __init__ signature: wrap rather than lose it
                    wrapper = RuntimeError(
                        "device prefetch pump failed: %r" % (err,))
                raise wrapper from err
            raise StopIteration
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for leaf in _leaves(batch):
                leaf.record_stream(stream)
        return batch

    def stats(self):
        """Overlap accounting: ``consumer_wait_s`` is time __next__
        spent blocked (input-bound step), ``pump_wait_s`` is time the
        pump spent blocked in the host iterator (step-bound input)."""
        with self._stats_lock:
            stats = {
                "batches": self._batches,
                "consumer_wait_s": self._consumer_wait_s,
                "pump_wait_s": self._pump_wait_s,
            }
        return obs_metrics.mirror_stats("edl_prefetch", stats)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # drain so the pump's blocked put wakes up
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # the pump's put/get waits are all 0.2s-bounded and re-check
        # _stop, so this join converges; bounded anyway so a wedged copy
        # cannot hang teardown (the thread is a daemon)
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
