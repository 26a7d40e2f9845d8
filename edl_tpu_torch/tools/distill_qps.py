"""Distill pipeline QPS microbenchmark.

Reference parity: example/distill/qps_tools (throughput probes for the
DistillReader pipeline). Measures student-side samples/sec through the full
task-framing → predict-worker → reorder pipeline against N teachers
(NOP teachers by default, so the number isolates pipeline overhead; point
--teachers at real teacher servers to measure end-to-end serving QPS).

    python -m edl_tpu_torch.tools.distill_qps --num-teachers 4 --batches 200
"""

import argparse
import json
import sys
import time

import numpy as np

from edl_tpu_torch.distill.distill_reader import DistillReader
from edl_tpu_torch.distill.teacher_server import nop_teacher


def run(num_teachers=2, batches=100, batch_size=32, feature_dim=128,
        num_classes=1000, teachers=None, max_in_flight=8):
    own_teachers = []
    if not teachers:
        for _ in range(num_teachers):
            own_teachers.append(nop_teacher(
                {"logits": ([num_classes], "<f4")},
                feed_specs={"ins": ([feature_dim], "<f4")},
                max_batch=max(batch_size, 8), host="127.0.0.1").start())
        teachers = [t.endpoint for t in own_teachers]

    data = np.random.RandomState(0).randn(
        batch_size, feature_dim).astype(np.float32)

    def gen():
        for _ in range(batches):
            yield (data,)

    dr = DistillReader(ins=["ins"], predicts=["logits"],
                       max_in_flight=max_in_flight)
    dr.set_batch_generator(gen)
    dr.set_fixed_teacher(teachers)
    try:
        # warmup epoch (connections, worker spin-up)
        for _ in dr():
            break
        t0 = time.perf_counter()
        n = sum(1 for _ in dr())
        dt = time.perf_counter() - t0
    finally:
        dr.stop()
        for t in own_teachers:
            t.stop()
    return {
        "teachers": len(teachers),
        "batches": n,
        "batch_size": batch_size,
        "samples_per_sec": round(n * batch_size / dt, 1),
        "batches_per_sec": round(n / dt, 2),
    }


def main():
    p = argparse.ArgumentParser("edl_tpu_torch distill qps bench")
    p.add_argument("--num-teachers", type=int, default=2)
    p.add_argument("--batches", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--teachers", default="",
                   help="comma list of real teacher endpoints")
    args = p.parse_args()
    result = run(num_teachers=args.num_teachers, batches=args.batches,
                 batch_size=args.batch_size, feature_dim=args.feature_dim,
                 teachers=[e for e in args.teachers.split(",") if e])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
