"""Checkpoint engine benchmark: sync save wall time vs the async
engine's training-blocked (snapshot) time, with a CRC-verified
round-trip so the speedup is measured on checkpoints that actually
restore bit-identically: ``edl_tpu/tools/ckpt_bench.py`` over torch
tensors on the device (CUDA unless ``--device cpu``).

The number that matters is ``blocked_ms`` — the time the training loop
cannot step because a save is in progress. The sync path blocks for the
whole device->host copy, serialize and write; the async engine blocks
only while it queues the snapshot's copies into pinned host buffers and
streams the bytes out on a background writer pool
(edl_tpu_torch/runtime/checkpoint.py).

Usage:
    python -m edl_tpu_torch.tools.ckpt_bench --tree-mb 64

Emits one JSON object (schema "ckpt_bench/v1"):
    sync.wall_ms        full blocking save, best of --repeats
    async.blocked_ms    snapshot time (training-thread cost), best-of
    async.persist_ms    background copy-wait+stream+commit time for that
                        run
    *.mb_s              tree bytes / the respective wall time
    blocked_frac_of_sync   async.blocked_ms / sync.wall_ms
    roundtrip_ok        both versions restored and compared bit-exact
"""

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from edl_tpu_torch.runtime import checkpoint as checkpoint_mod
from edl_tpu_torch.utils.device import resolve_device


def build_tree(tree_mb, seed=0, leaves=8, device="cpu"):
    """A float32 tree of ~tree_mb MB spread over ``leaves`` tensors on
    ``device`` (plus a scalar step), shaped like a small model's
    param/opt state."""
    rng = np.random.RandomState(seed)
    per_leaf = max(1, int(tree_mb * (1 << 20)) // (4 * leaves))
    tree = {"step": torch.tensor(123, dtype=torch.int64)}
    for i in range(leaves):
        tree["layer%02d" % i] = {
            "w": torch.from_numpy(rng.rand(per_leaf).astype(np.float32))
            .to(device)}
    return tree


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size()
               for _, t in checkpoint_mod._flatten(tree))


def _trees_identical(a, b):
    fa = checkpoint_mod._flatten(a)
    fb = dict(checkpoint_mod._flatten(b))
    if len(fa) != len(fb):
        return False
    for key, va in fa:
        vb = fb.get(key)
        if vb is None or va.dtype != vb.dtype or va.shape != vb.shape \
                or not torch.equal(va.cpu(), vb.cpu()):
            return False
    return True


def run(tree_mb=64, workers=4, directory=None, repeats=3, device=None):
    """Run the bench; returns the result dict (see module docstring)."""
    device = resolve_device(device)
    tmp = None
    if directory is None:
        tmp = tempfile.mkdtemp(prefix="ckpt_bench_")
        directory = tmp
    tree = build_tree(tree_mb, device=device)
    nbytes = _tree_bytes(tree)
    cm = checkpoint_mod.CheckpointManager(directory, keep=2 * repeats + 2,
                                          workers=workers)
    try:
        sync_walls = []
        for i in range(repeats):
            t0 = time.perf_counter()
            cm.save(100 + i, tree, meta={"bench": "sync"})
            sync_walls.append(time.perf_counter() - t0)
        blocked = []
        persists = []
        for i in range(repeats):
            handle = cm.save_async(200 + i, tree,
                                   meta={"bench": "async"})
            handle.result(600)  # also surfaces persist failures
            blocked.append(handle.blocked_s)
            persists.append(handle.persist_s)
        # the round-trip gate: both formats restore bit-identically
        # (stream entries are CRC-checked file-by-file on read)
        _, sync_tree, _ = cm.restore(100, target=tree)
        _, async_tree, _ = cm.restore(200, target=tree)
        roundtrip_ok = (_trees_identical(tree, sync_tree)
                        and _trees_identical(tree, async_tree))
    finally:
        cm.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    sync_wall = min(sync_walls)
    best = min(range(repeats), key=lambda i: blocked[i])
    blocked_s, persist_s = blocked[best], persists[best]
    mb = nbytes / (1 << 20)
    return {
        "schema": "ckpt_bench/v1",
        "tree_mb": round(mb, 3),
        "workers": workers,
        "repeats": repeats,
        "sync": {
            "wall_ms": round(sync_wall * 1e3, 3),
            "mb_s": round(mb / sync_wall, 1) if sync_wall else None,
        },
        "async": {
            "blocked_ms": round(blocked_s * 1e3, 3),
            "persist_ms": round(persist_s * 1e3, 3),
            "mb_s": round(mb / persist_s, 1) if persist_s else None,
        },
        "blocked_frac_of_sync": round(blocked_s / sync_wall, 4)
        if sync_wall else None,
        "roundtrip_ok": roundtrip_ok,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree-mb", type=float, default=64.0,
                    help="approximate tree size in MB")
    ap.add_argument("--workers", type=int, default=4,
                    help="writer-pool size")
    ap.add_argument("--repeats", type=int, default=3,
                    help="saves per mode; best-of is reported")
    ap.add_argument("--dir", default=None,
                    help="checkpoint directory (default: a tempdir)")
    ap.add_argument("--device", default=None,
                    help="where the tree lives (default: CUDA)")
    args = ap.parse_args(argv)
    out = run(tree_mb=args.tree_mb, workers=args.workers,
              directory=args.dir, repeats=args.repeats, device=args.device)
    json.dump(out, sys.stdout, indent=2)
    sys.stdout.write("\n")
    return 0 if out["roundtrip_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
