"""Distill data-plane benchmark: pipelined RPC + teacher adaptive
batching vs the serial strict call/response path.

Drives N concurrent students against one in-process teacher twice with
identical feeds:

- ``serial``     — adaptive batching off (per-request pad-and-lock) and
                   one predict in flight per student (lockstep), the
                   pre-pipelining data plane;
- ``pipelined``  — adaptive batching on and ``--depth`` predicts in
                   flight per student via ``call_async``.

The numbers that matter: ``predicts_s`` (predict RPCs completed per
second — the student-visible feed rate), ``goodput_mb_s`` (feed + soft
-label payload bytes moved per second), and ``occupancy_pct`` (the
fraction of compiled-batch rows that carried real requests — how much
of every device execution the fleet actually used). ``identical_ok``
gates it all: both modes must return byte-identical predictions.

Usage:
    python -m edl_tpu_torch.tools.distill_bench
    python -m edl_tpu_torch.tools.distill_bench --model gpt --students 4

``--model gpt`` serves the port's ``gpt_teacher`` on CUDA unless
``--device cpu``; ``linear`` and ``nop`` are numpy teachers on the host.

Emits one JSON object (schema "distill_bench/v1").
"""

import argparse
import collections
import json
import sys
import threading
import time

import numpy as np


#: warm-up predicts of one student batch before each mode's timed window
WARM_CALLS = 32


def _linear_model(feed_dim, fetch_dim):
    """A deterministic row-wise transform: cheap enough for CPU CI,
    non-trivial enough that byte-identity across modes means the
    scatter/padding machinery is correct."""
    w = (np.arange(feed_dim * fetch_dim, dtype=np.float32)
         .reshape(feed_dim, fetch_dim) % 7.0) * 0.25

    def fn(feed):
        return {"soft_label": feed["x"] @ w + 1.0}

    return fn, {"x": ([feed_dim], "<f4")}, {"soft_label": ([fetch_dim],
                                                           "<f4")}


def _teacher(model, max_batch, adaptive, batch_timeout_ms, feed_dim,
             fetch_dim, seq_len, device=None):
    from edl_tpu_torch.distill.teacher_server import TeacherServer, gpt_teacher

    if model == "gpt":
        return gpt_teacher(seq_len=seq_len, max_batch=max_batch,
                           host="127.0.0.1",
                           adaptive_batch=adaptive,
                           batch_timeout_ms=batch_timeout_ms,
                           device=device).start()
    if model == "nop":
        def fn(feed):
            n = len(feed["x"])
            return {"soft_label": np.zeros((n, fetch_dim), np.float32)}
        feeds = {"x": ([feed_dim], "<f4")}
        fetches = {"soft_label": ([fetch_dim], "<f4")}
    else:
        fn, feeds, fetches = _linear_model(feed_dim, fetch_dim)
    return TeacherServer(fn, feeds, fetches, max_batch=max_batch,
                         host="127.0.0.1", adaptive_batch=adaptive,
                         batch_timeout_ms=batch_timeout_ms).start()


def _make_feeds(model, students, batches, batch_size, feed_dim, seq_len,
                seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(students):
        if model == "gpt":
            out.append([{"input_ids": rng.randint(
                0, 255, size=(batch_size, seq_len)).astype(np.int32)}
                for _ in range(batches)])
        else:
            out.append([{"x": rng.rand(batch_size, feed_dim)
                         .astype(np.float32)} for _ in range(batches)])
    return out


def _student(endpoint, feeds, depth, results, errs, timeout):
    """Stream ``feeds`` keeping ``depth`` predicts in flight; depth=1 is
    the lockstep pre-pipelining client behavior."""
    from edl_tpu_torch.distill.distill_reader import _TeacherConn

    try:
        conn = _TeacherConn(endpoint, timeout=timeout)
        pending = collections.deque()
        try:
            for i, feed in enumerate(feeds):
                while len(pending) >= depth:
                    j, fut = pending.popleft()
                    results[j] = fut.result()
                pending.append((i, conn.predict_async(feed)))
            while pending:
                j, fut = pending.popleft()
                results[j] = fut.result()
        finally:
            conn.close()
    except Exception as e:  # noqa: BLE001 — surfaced by the driver
        errs.append(e)


def _run_mode(model, feeds, depth, adaptive, batch_timeout_ms, max_batch,
              feed_dim, fetch_dim, seq_len, timeout, device=None):
    from edl_tpu_torch.rpc.client import RpcClient

    teacher = _teacher(model, max_batch, adaptive, batch_timeout_ms,
                       feed_dim, fetch_dim, seq_len, device)
    try:
        # path warmup outside the timed window. The first batch's wall
        # time (the device's lazy initialisation) is the admission
        # EWMA's first per-row sample; one 1-row call left it there, and
        # the students' overlapping requests were then shed as SLO
        # misses. WARM_CALLS calls of a student's batch decay it (by
        # 0.8 each) to the warm service time.
        warm = RpcClient(teacher.endpoint, timeout=timeout)
        for _ in range(WARM_CALLS):
            warm.call("predict", feeds[0][0])
        stats0 = warm.call("stats")
        warm.close()
        results = [[None] * len(f) for f in feeds]
        errs = []
        threads = [threading.Thread(
            target=_student,
            args=(teacher.endpoint, f, depth, results[i], errs, timeout),
            name="student-%d" % i) for i, f in enumerate(feeds)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        if errs:
            raise errs[0]
        c = RpcClient(teacher.endpoint, timeout=timeout)
        stats1 = c.call("stats")
        c.close()
    finally:
        teacher.stop()
    n_predicts = sum(len(f) for f in feeds)
    payload = sum(a.nbytes for f in feeds for d in f
                  for a in d.values())
    payload += sum(a.nbytes for rs in results for r in rs
                   for a in r.values())
    rows = stats1["rows"] - stats0["rows"]
    cap = (stats1["batches"] - stats0["batches"]) * max_batch
    return results, {
        "wall_ms": round(wall * 1e3, 3),
        "predicts_s": round(n_predicts / wall, 2),
        "goodput_mb_s": round(payload / (1 << 20) / wall, 2),
        "device_batches": stats1["batches"] - stats0["batches"],
        "occupancy_pct": round(100.0 * rows / cap, 2) if cap else 0.0,
    }


def _identical(a, b):
    for sa, sb in zip(a, b):
        for ra, rb in zip(sa, sb):
            if sorted(ra) != sorted(rb):
                return False
            for k in ra:
                va, vb = np.asarray(ra[k]), np.asarray(rb[k])
                if va.dtype != vb.dtype or va.shape != vb.shape \
                        or va.tobytes() != vb.tobytes():
                    return False
    return True


def run(model="linear", students=2, batches=32, batch_size=16,
        feed_dim=256, fetch_dim=256, max_batch=64, depth=4,
        batch_timeout_ms=0.0, seq_len=32, timeout=120.0, device=None):
    """Run both modes over identical feeds; returns the report dict.
    ``device`` places the ``gpt`` teacher (None means CUDA)."""
    feeds = _make_feeds(model, students, batches, batch_size, feed_dim,
                        seq_len)
    serial_out, serial = _run_mode(
        model, feeds, depth=1, adaptive=False, batch_timeout_ms=0.0,
        max_batch=max_batch, feed_dim=feed_dim, fetch_dim=fetch_dim,
        seq_len=seq_len, timeout=timeout, device=device)
    piped_out, piped = _run_mode(
        model, feeds, depth=depth, adaptive=True,
        batch_timeout_ms=batch_timeout_ms, max_batch=max_batch,
        feed_dim=feed_dim, fetch_dim=fetch_dim, seq_len=seq_len,
        timeout=timeout, device=device)
    return {
        "schema": "distill_bench/v1",
        "model": model,
        "students": students,
        "batches": batches,
        "batch_size": batch_size,
        "max_batch": max_batch,
        "pipeline_depth": depth,
        "batch_timeout_ms": batch_timeout_ms,
        "serial": serial,
        "pipelined": piped,
        "speedup_predicts_s": round(
            piped["predicts_s"] / serial["predicts_s"], 3)
        if serial["predicts_s"] else None,
        "identical_ok": _identical(serial_out, piped_out),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="linear",
                    choices=["linear", "nop", "gpt"])
    ap.add_argument("--students", type=int, default=2,
                    help="concurrent student connections")
    ap.add_argument("--batches", type=int, default=32,
                    help="predict requests per student")
    ap.add_argument("--batch-size", type=int, default=16,
                    help="rows per student request")
    ap.add_argument("--feed-dim", type=int, default=256)
    ap.add_argument("--fetch-dim", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=64,
                    help="teacher compiled batch size")
    ap.add_argument("--depth", type=int, default=4,
                    help="in-flight predicts per student (pipelined mode)")
    ap.add_argument("--batch-timeout-ms", type=float, default=0.0,
                    help="teacher coalescing window (pipelined mode); 0 "
                    "= coalesce only what is already queued")
    ap.add_argument("--seq-len", type=int, default=32,
                    help="gpt model sequence length")
    ap.add_argument("--device", default=None,
                    help="gpt teacher's device (default: cuda)")
    args = ap.parse_args(argv)
    out = run(model=args.model, students=args.students,
              batches=args.batches, batch_size=args.batch_size,
              feed_dim=args.feed_dim, fetch_dim=args.fetch_dim,
              max_batch=args.max_batch, depth=args.depth,
              batch_timeout_ms=args.batch_timeout_ms,
              seq_len=args.seq_len, device=args.device)
    json.dump(out, sys.stdout, indent=2)
    sys.stdout.write("\n")
    return 0 if out["identical_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
