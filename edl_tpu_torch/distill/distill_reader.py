"""DistillReader: wrap a student's data generator so every batch is
augmented with teacher-model predictions fetched from an elastic fleet of
inference servers.

Reference parity: edl/distill/distill_reader.py + distill_worker.py —
the same observable protocol, re-implemented with threads instead of forked
processes (the heavy lifting is remote inference + msgpack IO, which
threads overlap fine):

- user data is framed into ordered tasks; a bounded semaphore provides
  ordering back-pressure (reference task_semaphore, distill_worker.py:599);
- one predict worker per teacher connection; the manage loop diffs the
  discovered teacher set, starts workers for new teachers and stops workers
  for dropped ones (reference predict_manage_worker :58-171);
- a failed task is re-queued and its worker retires the connection; the
  epoch completes only when every fed task has a result — the accounting
  the reference implemented with poison pills + feed/predict counters
  (:435-506) is expressed here with per-epoch fed/done counters;
- results are re-ordered by task id so the student sees its batches in the
  original order (reference fetch_out :720-769).

Pipelining: each worker keeps up to ``pipeline_depth`` predicts in
flight on its connection via ``RpcClient.call_async`` (and an oversized
batch's max_batch chunks ride the same pipeline), so the wire streams
the next feeds while the teacher's device computes the current batch —
the overlap the zero-copy v2 tensor frames were built for. Depth falls
back to 1 against a teacher that does not advertise ``rpc.pipeline`` in
``get_feed_fetch``. On a connection failure every in-flight task is
requeued (the per-endpoint in-flight registry holds the full set, not
just one task), so the delivery guarantee is unchanged.
"""

import collections
import queue
import threading
import time

import numpy as np

from edl_tpu_torch.distill.discovery_client import DiscoveryClient, \
    FixedDiscover
from edl_tpu_torch.robustness.policy import CircuitBreaker
from edl_tpu_torch.rpc import ndarray as nd
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.rpc.pool import ClientPool
from edl_tpu_torch.utils import errors, timeline
from edl_tpu_torch.utils.logger import logger

#: sentinel payload marking a result slot that carries a permanent
#: per-task error instead of predictions (raised to the consumer in
#: order, so a poisoned batch cannot requeue forever)
_TASK_ERROR = object()


class _PredictFuture(object):
    """All chunk replies of one logical predict; ``result()`` joins."""

    __slots__ = ("_futs",)

    def __init__(self, futs):
        self._futs = futs

    def result(self):
        # raw arrays rode the v2 tensor frame (out-of-band zero-copy
        # segments); decode_tree is a no-op on the already-decoded
        # reply but keeps pre-v2 peers working
        outs = [nd.decode_tree(f.result()) for f in self._futs]
        if len(outs) == 1:
            return outs[0]
        return {k: np.concatenate([o[k] for o in outs], axis=0)
                for k in outs[0]}


class _TeacherConn(object):
    """One connection to one teacher; splits oversized batches to the
    teacher's compiled max_batch. With a :class:`ClientPool` the
    connection is the pool's shared client for the endpoint (redialed
    only when retired); without one the conn owns a private client —
    the pre-pool behavior."""

    def __init__(self, endpoint, timeout=60.0, pool=None):
        self.endpoint = endpoint
        self._pool = pool
        self._rpc = (pool.get(endpoint) if pool is not None
                     else RpcClient(endpoint, timeout=timeout))
        spec = self._rpc.call("get_feed_fetch")
        self.max_batch = spec.get("max_batch", 64)
        self.fetch_names = list(spec.get("fetch", {}))
        self.features = tuple(spec.get("features", ()))
        self.pipelined = "rpc.pipeline" in self.features

    def predict_async(self, feed):
        """Issue one logical predict; oversized feeds are split into
        max_batch chunks that are ALL sent before any reply is awaited,
        so a 4-chunk batch costs ~1 round trip instead of 4."""
        if not feed:
            raise errors.DataAccessError("empty feed: no input arrays")
        n = len(next(iter(feed.values())))
        if n == 0:
            # fail fast client-side: the teacher would reject it anyway,
            # and an empty chunk list used to IndexError in the join
            raise errors.DataAccessError("empty feed: zero-row batch")
        futs = []
        for lo in range(0, n, self.max_batch):
            chunk = {k: v[lo:lo + self.max_batch] for k, v in feed.items()}
            futs.append(self._rpc.call_async("predict", chunk))
        return _PredictFuture(futs)

    def predict(self, feed):
        return self.predict_async(feed).result()

    def close(self):
        # a pooled client is shared: its lifetime belongs to the pool
        # (idle reaping / retire-on-error), not to this worker
        if self._pool is None:
            self._rpc.close()


class DistillReader(object):
    """``pipeline_depth``: predicts kept in flight per teacher
    connection (1 = the pre-pipelining lockstep behavior; also forced
    to 1 when the teacher doesn't advertise ``rpc.pipeline``).
    ``predict_timeout``: per-RPC deadline for one predict chunk."""

    def __init__(self, ins, predicts, max_in_flight=8,
                 teacher_backoff=5.0, pipeline_depth=4,
                 predict_timeout=60.0, pool=None):
        self._ins = list(ins)
        self._predicts = list(predicts)
        self._max_in_flight = max_in_flight
        self._pipeline_depth = max(1, int(pipeline_depth))
        self._predict_timeout = predict_timeout
        # shared client pool: one connection per teacher across worker
        # generations (a worker restart used to redial), retired on
        # transport failure so the next worker dials fresh
        self._pool = pool if pool is not None \
            else ClientPool(timeout=predict_timeout)
        self._owns_pool = pool is None

        self._gen = None
        self._gen_kind = None
        self._discover = None

        self._in_q = queue.Queue()
        self._results = {}
        self._results_cond = threading.Condition()
        self._stop = threading.Event()
        self._workers = {}          # endpoint -> (thread, stop_event)
        # per-teacher circuit breaker (replaces an ad-hoc timestamp map
        # that grew without bound as teacher endpoints churned): one
        # failure opens the circuit for ``teacher_backoff`` seconds,
        # then a single half-open probe worker decides recovery
        self._breaker = CircuitBreaker(failure_threshold=1,
                                       reset_timeout=teacher_backoff)
        self._inflight = {}         # endpoint -> [tasks being predicted]
        self._inflight_lock = threading.Lock()
        self._manager = None
        self._started = False
        self._epoch = 0             # generation token fencing epochs
        self.stall_timeout = 300.0  # no-progress watchdog for the consumer

    # -- configuration (reference setter surface) ------------------------------

    def set_sample_generator(self, gen, batch_size):
        """gen yields one sample tuple; batched here to ``batch_size``."""
        self._gen, self._gen_kind = gen, ("sample", batch_size)
        return self

    def set_sample_list_generator(self, gen):
        """gen yields a list of sample tuples (one student batch)."""
        self._gen, self._gen_kind = gen, ("sample_list", None)
        return self

    def set_batch_generator(self, gen):
        """gen yields a tuple/list of batched arrays matching ``ins``."""
        self._gen, self._gen_kind = gen, ("batch", None)
        return self

    def set_fixed_teacher(self, endpoints):
        self._discover = FixedDiscover(endpoints).start()
        return self

    def set_dynamic_teacher(self, discovery_endpoint, service_name,
                            require_num=1):
        self._discover = DiscoveryClient(
            discovery_endpoint, service_name, require_num).start()
        return self

    # -- worker management -------------------------------------------------------

    def _ensure_started(self):
        if self._started:
            return
        if self._gen is None or self._discover is None:
            raise errors.StatusError(
                "DistillReader needs a generator and a teacher source")
        self._manager = threading.Thread(target=self._manage_loop,
                                         daemon=True,
                                         name="distill-manager")
        self._manager.start()
        self._started = True

    def _manage_loop(self):
        while not self._stop.wait(1.0):
            self._sync_workers()

    def _sync_workers(self):
        want = set(self._discover.get_servers())
        # breaker state only for teachers that still exist: endpoint
        # churn must not grow the map without bound
        self._breaker.prune(want)
        # drop workers whose teacher disappeared; requeue anything a dead
        # worker was still holding so no task is ever lost
        for ep in list(self._workers):
            thread, stop_ev = self._workers[ep]
            if ep not in want:
                stop_ev.set()
            if not thread.is_alive():
                del self._workers[ep]
                with self._inflight_lock:
                    orphans = self._inflight.pop(ep, None) or []
                for orphan in orphans:
                    logger.warning("requeueing task %d orphaned by dead "
                                   "worker %s", orphan[1], ep)
                    self._in_q.put(orphan)
        # start workers for new teachers; an open circuit (recent
        # failure) gates the endpoint until its half-open probe window
        for ep in want:
            if ep in self._workers:
                continue
            if not self._breaker.allow(ep):
                continue
            stop_ev = threading.Event()
            thread = threading.Thread(
                target=self._predict_loop, args=(ep, stop_ev), daemon=True,
                name="distill-predict-%s" % ep)
            thread.start()
            self._workers[ep] = (thread, stop_ev)

    # -- the per-teacher worker --------------------------------------------------

    def _track(self, endpoint, task, add):
        with self._inflight_lock:
            tasks = self._inflight.setdefault(endpoint, [])
            if add:
                tasks.append(task)
            else:
                try:
                    tasks.remove(task)
                except ValueError:
                    pass  # already handed to _sync_workers' requeue

    def _post_result(self, epoch, task_id, payload, preds):
        with self._results_cond:
            self._results[(epoch, task_id)] = (payload, preds)
            self._results_cond.notify_all()

    def _fill_pipeline(self, conn, endpoint, pending, depth):
        """Issue predicts until ``depth`` are in flight or the task
        queue is (momentarily) empty. Returns False when the
        connection failed and the worker must retire."""
        while len(pending) < depth:
            try:
                # block only when idle; with work in flight just top up
                task = self._in_q.get(timeout=0.0 if pending else 0.2)
            except queue.Empty:
                return True
            epoch, task_id, feed, payload = task
            if epoch != self._epoch:  # stale task from an abandoned epoch
                continue
            self._track(endpoint, task, add=True)
            try:
                fut = conn.predict_async(feed)
            except errors.OverloadedError as e:
                # the teacher SHED this task (typed, with a retry-after
                # hint): the task is fine, the endpoint is saturated —
                # requeue for another teacher and back off this one
                self._track(endpoint, task, add=False)
                self._in_q.put(task)
                self._back_off_teacher(endpoint, e)
                return False
            except errors.DataAccessError as e:
                # the task itself is poisoned (empty/malformed feed):
                # requeueing would ping-pong it between teachers forever,
                # so surface it to the consumer in order
                self._track(endpoint, task, add=False)
                self._post_result(epoch, task_id, _TASK_ERROR, e)
            except Exception as e:  # noqa: BLE001 — transport: requeue
                self._track(endpoint, task, add=False)
                logger.warning("teacher %s failed task %d (%r); "
                               "requeueing", endpoint, task_id, e)
                self._in_q.put(task)
                self._retire_teacher(endpoint)
                return False
            else:
                pending.append((task, fut))
        return True

    def _retire_teacher(self, endpoint):
        """A transport failure opens the breaker AND retires the pooled
        client — the teacher may have restarted as a new generation, so
        the next worker must dial fresh."""
        self._breaker.record_failure(endpoint)
        self._pool.retire(endpoint)

    def _back_off_teacher(self, endpoint, e):
        """A typed shed (OverloadedError) opens the breaker — the
        manage loop gates the endpoint for ``teacher_backoff`` before
        a half-open probe — but the connection is HEALTHY (the teacher
        answered, fast), so the pooled client stays: backing off must
        not force a redial storm against an overloaded server."""
        hint = e.retry_after_s
        logger.warning("teacher %s shed work (%r); backing off%s",
                       endpoint, e,
                       "" if hint is None
                       else " (server hints %.2fs)" % hint)
        self._breaker.record_failure(endpoint)

    def _predict_loop(self, endpoint, stop_ev):
        try:
            conn = _TeacherConn(endpoint, timeout=self._predict_timeout,
                                pool=self._pool)
        except errors.EdlError as e:
            logger.warning("teacher %s unreachable: %r", endpoint, e)
            self._retire_teacher(endpoint)
            return
        # feature negotiation: a pre-pipelining teacher gets lockstep
        # depth 1 — exactly the old strict call/response traffic
        depth = self._pipeline_depth if conn.pipelined else 1
        logger.info("distill worker up for teacher %s (depth=%d)",
                    endpoint, depth)
        tl = timeline.get_timeline()
        pending = collections.deque()  # (task, _PredictFuture) in flight
        ok = True
        while not (stop_ev.is_set() or self._stop.is_set()):
            if not self._fill_pipeline(conn, endpoint, pending, depth):
                ok = False
                break
            if not pending:
                continue
            task, fut = pending.popleft()
            epoch, task_id, feed, payload = task
            try:
                with tl.span("predict@%s" % endpoint):
                    preds = fut.result()
            except errors.OverloadedError as e:
                # typed shed from admission control: requeue elsewhere,
                # open the breaker, keep the (healthy) pooled client
                self._track(endpoint, task, add=False)
                self._in_q.put(task)
                self._back_off_teacher(endpoint, e)
                ok = False
                break
            except errors.DataAccessError as e:
                self._track(endpoint, task, add=False)
                self._post_result(epoch, task_id, _TASK_ERROR, e)
                continue
            except Exception as e:  # noqa: BLE001 — transport: requeue
                self._track(endpoint, task, add=False)
                logger.warning("teacher %s failed task %d (%r); requeueing",
                               endpoint, task_id, e)
                self._in_q.put(task)
                self._retire_teacher(endpoint)
                ok = False
                break
            self._track(endpoint, task, add=False)
            self._breaker.record_success(endpoint)
            self._post_result(epoch, task_id, payload, preds)
        # a dead connection fails every in-flight future, so anything
        # still pending is requeued here, not lost (requeue-safe drain)
        for task, _ in pending:
            self._track(endpoint, task, add=False)
            if ok:
                logger.warning("requeueing task %d in flight at worker "
                               "%s retirement", task[1], endpoint)
            self._in_q.put(task)
        conn.close()
        logger.info("distill worker for %s retired", endpoint)

    # -- epoch iteration -----------------------------------------------------------

    def _frame_tasks(self):
        """Yield (feed_dict, payload) per student batch."""
        kind, batch_size = self._gen_kind
        if kind == "batch":
            for arrays in self._gen():
                arrays = [np.asarray(a) for a in arrays]
                feed = dict(zip(self._ins, arrays))
                yield feed, arrays
        else:
            def batches():
                if kind == "sample_list":
                    yield from self._gen()
                else:
                    buf = []
                    for sample in self._gen():
                        buf.append(sample)
                        if len(buf) >= batch_size:
                            yield buf
                            buf = []
                    if buf:
                        yield buf
            for samples in batches():
                cols = list(zip(*samples))
                arrays = [np.asarray(np.stack(c)) for c in cols]
                feed = dict(zip(self._ins, arrays[:len(self._ins)]))
                yield feed, samples

    def __call__(self):
        """One pass over the student data, each batch augmented with the
        teacher predictions, in the original order."""
        self._ensure_started()
        # bump the epoch token: workers drop tasks/results from abandoned
        # epochs, and any feeder thread from a previous epoch exits
        self._epoch += 1
        epoch = self._epoch
        while True:
            try:
                self._in_q.get_nowait()
            except queue.Empty:
                break
        with self._results_cond:
            self._results.clear()
        sem = threading.Semaphore(self._max_in_flight)
        fed = {"n": 0, "done_feeding": False, "error": None}

        def feeder():
            try:
                for task_id, (feed, payload) in enumerate(
                        self._frame_tasks()):
                    if self._stop.is_set() or self._epoch != epoch:
                        return
                    sem.acquire()
                    fed["n"] = task_id + 1
                    self._in_q.put((epoch, task_id, feed, payload))
            except BaseException as e:  # noqa: BLE001 — re-raised in __call__
                # a generator that raises mid-epoch must NOT look like a
                # clean completion to the consumer (silent data loss)
                fed["error"] = e
            finally:
                fed["done_feeding"] = True
                with self._results_cond:
                    self._results_cond.notify_all()

        feeder_thread = threading.Thread(target=feeder, daemon=True,
                                         name="distill-feeder")
        feeder_thread.start()

        next_id = 0
        last_progress = time.monotonic()
        while True:
            with self._results_cond:
                while (epoch, next_id) not in self._results:
                    if (fed["done_feeding"] and next_id >= fed["n"]):
                        feeder_thread.join(timeout=5)
                        if fed["error"] is not None:
                            raise fed["error"]
                        return
                    self._results_cond.wait(timeout=0.5)
                    if self._stop.is_set():
                        return
                    if (time.monotonic() - last_progress
                            > self.stall_timeout):
                        raise errors.DataAccessError(
                            "distill pipeline stalled %.0fs waiting for "
                            "task %d (workers=%s, queued=%d)"
                            % (self.stall_timeout, next_id,
                               sorted(self._workers), self._in_q.qsize()))
                payload, preds = self._results.pop((epoch, next_id))
            sem.release()
            last_progress = time.monotonic()
            if payload is _TASK_ERROR:
                raise preds  # the per-task DataAccessError, in order
            yield self._assemble(payload, preds)
            next_id += 1

    def _assemble(self, payload, preds):
        pred_arrays = [preds[name] for name in self._predicts]
        if self._gen_kind[0] == "batch":
            return tuple(payload) + tuple(pred_arrays)
        out = []
        for i, sample in enumerate(payload):
            out.append(tuple(sample) + tuple(a[i] for a in pred_arrays))
        return out

    def stop(self):
        self._stop.set()
        for _, stop_ev in self._workers.values():
            stop_ev.set()
        if self._discover is not None:
            self._discover.stop()
        if self._owns_pool:
            # failing the in-flight predicts wakes any worker blocked
            # in fut.result(); the requeue-safe drain handles the rest
            self._pool.close()
