"""The port's slot KV cache and prefix trie (``serve/kv_cache.py``)
against the JAX package's: one script of allocator calls (alloc, free,
retain, release and the state queries) and trie calls (insert, lookup,
peek, forget, evict, stats) is replayed on both, and every result —
value or error class — must be identical. Scripts are a hand-written
one plus random ones drawn from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.serve import kv_cache as jkv
from edl_tpu_torch.serve import kv_cache as tkv

SLOTS = 4
ROW = (6, 2, 4)  # max_len, heads, head_dim


def _pair():
    """(JAX side, port side): each a SlotKvCache and a PrefixCache."""
    jside = (jkv.SlotKvCache(lambda n: {"k": jnp.zeros((n,) + ROW),
                                        "v": jnp.zeros((n,) + ROW)},
                             slots=SLOTS), jkv.PrefixCache())
    tside = (tkv.SlotKvCache(lambda n: {"k": torch.zeros((n,) + ROW),
                                        "v": torch.zeros((n,) + ROW)},
                             slots=SLOTS), tkv.PrefixCache())
    return jside, tside


def _call(side, op, args):
    kv, trie = side
    target = {"alloc": kv, "free": kv, "retain": kv, "release": kv,
              "live": kv, "cached": kv, "bytes": kv}.get(op, trie)
    try:
        if op in ("occupied", "free_slots", "cached_rows"):
            return getattr(kv, op)
        if op == "evict_lru":
            return trie.evict_lru(kv.cached() if args is None else args)
        return getattr(target, op)(*args)
    except Exception as exc:  # noqa: BLE001 — the error IS the result
        return ("raised", type(exc).__name__)


def _replay(script):
    jside, tside = _pair()
    for i, (op, args) in enumerate(script):
        want = _call(jside, op, args)
        got = _call(tside, op, args)
        assert got == want, (i, op, args, got, want)
    assert tside[1].stats() == jside[1].stats()
    return tside


HAND_SCRIPT = [
    ("alloc", ()), ("alloc", ()), ("occupied", None), ("free_slots", None),
    ("insert", ([1, 2, 3, 4], 0)), ("insert", ([1, 2, 5], 1)),
    ("lookup", ([1, 2, 3, 4, 9],)), ("lookup", ([1, 2, 3, 4],)),
    ("lookup", ([7, 7],)), ("peek_len", ([1, 2, 9],)),
    ("retain", (0,)), ("cached_rows", None), ("cached", ()),
    ("free", (0,)),                      # cached, not live: raises
    ("release", (1,)),                   # live, not cached: raises
    ("alloc", ()), ("alloc", ()), ("alloc", ()),  # the last is None
    ("evict_lru", None), ("release", (0,)), ("alloc", ()),
    ("has", (0,)), ("has", (1,)), ("forget", (1,)), ("has", (1,)),
    ("lookup", ([1, 2, 5, 6],)), ("note_miss", ()),
    ("insert", ([9, 9, 9], 2)), ("insert", ([9, 9, 8], 2)),
    ("lookup", ([9, 9, 9, 1],)), ("lookup", ([9, 9, 8, 1],)),
    ("evict_lru", ([5],)), ("free", (2,)), ("free", (2,)),
    ("live", ()), ("bytes", ()), ("stats", ()),
]


def test_hand_script_replays_identically():
    kv, trie = _replay(HAND_SCRIPT)
    assert kv.bytes() == 2 * SLOTS * int(np.prod(ROW)) * 4
    s = trie.stats()
    assert s["hits"] >= 3 and s["misses"] >= 2 and s["evictions"] == 1


def _random_script(seed, n=120):
    rng = np.random.RandomState(seed)
    ops = ["alloc", "free", "retain", "release", "insert", "lookup",
           "peek_len", "forget", "evict_lru", "note_miss", "has",
           "occupied", "free_slots", "cached_rows", "live", "cached",
           "stats"]
    script = []
    for _ in range(n):
        op = ops[rng.randint(len(ops))]
        slot = int(rng.randint(SLOTS + 1))  # SLOTS is never a slot
        tokens = rng.randint(0, 3, rng.randint(1, 6)).tolist()
        args = {"alloc": (), "free": (slot,), "retain": (slot,),
                "release": (slot,), "insert": (tokens, slot),
                "lookup": (tokens,), "peek_len": (tokens,),
                "forget": (slot,), "note_miss": (), "has": (slot,),
                "live": (), "cached": (), "stats": ()}.get(op)
        if op == "evict_lru":
            args = None if rng.rand() < 0.7 else [slot, (slot + 1) % SLOTS]
        script.append((op, args))
    return script


@pytest.mark.parametrize("seed", range(6))
def test_random_script_replays_identically(seed):
    _replay(_random_script(seed))
