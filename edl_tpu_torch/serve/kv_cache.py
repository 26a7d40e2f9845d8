"""Preallocated slot-based KV cache for continuous-batching decode.

The port of ``edl_tpu/serve/kv_cache.py``. The paged-attention insight
(vLLM, Kwon et al. SOSP'23) applied at slot granularity: the engine owns
ONE device-resident cache dict with a k and a v tensor shaped
``[slots, max_len, heads, head_dim]`` per layer
(``models/gpt.py:init_cache`` at ``batch=slots``), and a
host-side free-slot allocator maps live sequences onto rows. Admitting
a sequence scatters its prefill cache into a free row; retiring one
just returns the row to the free list — no device work, because decode
correctness never reads a position that hasn't been written by the
CURRENT tenant:

- prefill overwrites the ENTIRE row ``[0:max_len]`` (prompt K/V in
  ``[0:bucket)``, zeros beyond), erasing any previous tenant, and
- the decode step at position ``i`` writes K/V at ``i`` BEFORE attending
  ``<= i``, so the zeros beyond the prompt are always replaced before
  they are ever attended.

Slot rows are therefore reused without zeroing, and the fused decode
step runs at a FIXED shape ``[slots, ...]`` whatever subset of rows is
live — membership churn costs a mask update, never a recompile.

Shared-prefix KV reuse (SGLang RadixAttention, Zheng et al. 2023) adds
a THIRD slot state: a retired sequence's row can be RETAINED as a
cached prefix instead of freed — :class:`PrefixCache` keeps a host-side
token trie mapping prompt prefixes to the slot rows holding their K/V,
so a later prompt sharing a stored prefix copies the row and prefills
only the suffix. Cached rows are evictable (LRU) the moment the
allocator runs dry, so reuse never reduces decode capacity — it only
recycles idle rows that would otherwise sit on the free list.
"""

import threading

from edl_tpu_torch.obs import metrics as obs_metrics

_PREFIX_HITS = obs_metrics.counter(
    "edl_decode_prefix_hits_total",
    "prompt lookups that reused a cached KV prefix")
_PREFIX_EVICTIONS = obs_metrics.counter(
    "edl_decode_prefix_evictions_total",
    "cached prefix rows reclaimed by the slot allocator (LRU)")
_PREFIX_REUSE_TOKENS = obs_metrics.counter(
    "edl_decode_prefix_reuse_tokens_total",
    "prompt tokens whose prefill was skipped via prefix reuse")
_PREFIX_ROWS = obs_metrics.gauge(
    "edl_decode_prefix_cached_rows",
    "idle KV slot rows retained as cached prefixes")


class SlotKvCache(object):
    """``slots`` preallocated cache rows + a free-slot allocator.

    The device tensors live in ``self.cache`` (a dict of tensors with
    leading dim ``slots``); the allocator is host-side and thread-safe.
    The device loop is the only writer of ``self.cache`` (in place);
    ``alloc`` / ``free`` only move slot ids between the free list and
    the live set.

    Slots move through three states: free -> live (``alloc``), live ->
    free (``free``), and — for prefix reuse — live -> cached
    (``retain``) and cached -> free (``release``). Cached rows hold a
    retired sequence's K/V for the prefix trie; they are NOT allocatable
    until released, so a cached row's contents stay valid until the
    allocator (under pressure) evicts it via the trie's LRU.
    """

    def __init__(self, init_cache_fn, slots):
        if slots < 1:
            raise ValueError("need at least one slot, got %d" % slots)
        self.slots = int(slots)
        self.cache = init_cache_fn(self.slots)
        self._lock = threading.Lock()
        self._free = list(range(self.slots - 1, -1, -1))  # pop -> slot 0 first
        self._live = set()
        self._cached = set()

    def alloc(self):
        """A free slot id, or ``None`` when fully occupied."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._live.add(slot)
            return slot

    def free(self, slot):
        with self._lock:
            if slot not in self._live:
                raise ValueError("slot %d is not live" % slot)
            self._live.discard(slot)
            self._free.append(slot)

    def retain(self, slot):
        """live -> cached: keep the row's K/V for prefix reuse instead
        of returning it to the free list."""
        with self._lock:
            if slot not in self._live:
                raise ValueError("slot %d is not live" % slot)
            self._live.discard(slot)
            self._cached.add(slot)
            _PREFIX_ROWS.set(len(self._cached))

    def release(self, slot):
        """cached -> free: the trie evicted this row; its contents are
        no longer reachable and the allocator may hand it out."""
        with self._lock:
            if slot not in self._cached:
                raise ValueError("slot %d is not cached" % slot)
            self._cached.discard(slot)
            self._free.append(slot)
            _PREFIX_ROWS.set(len(self._cached))

    @property
    def occupied(self):
        with self._lock:
            return len(self._live)

    @property
    def free_slots(self):
        with self._lock:
            return len(self._free)

    @property
    def cached_rows(self):
        with self._lock:
            return len(self._cached)

    def live(self):
        with self._lock:
            return sorted(self._live)

    def cached(self):
        with self._lock:
            return sorted(self._cached)

    def bytes(self):
        return sum(t.numel() * t.element_size()
                   for t in self.cache.values())


class _TrieNode(object):
    __slots__ = ("kids", "slots")

    def __init__(self):
        self.kids = {}    # token -> _TrieNode
        self.slots = set()  # slot rows whose stored path passes here


class PrefixCache(object):
    """Host-side token trie: prompt prefixes -> slot rows holding their
    K/V (the RadixAttention index at slot granularity).

    Every completed prefill inserts its full prompt path; a lookup walks
    the trie and returns the DEEPEST stored prefix strictly shorter than
    the prompt (at least one suffix token must remain, because the
    first output token comes from the last prompt position's logits).
    Causality makes the reuse exact: K/V at position i depends only on
    tokens ``<= i``, so a row whose stored path shares the first d
    tokens holds bit-identical K/V for positions ``[0, d)``.

    One path per slot (a slot's row holds exactly one sequence's K/V);
    re-inserting a slot replaces its previous path. ``evict_lru``
    reclaims the least-recently-USED slot among the candidates the
    engine passes (its idle cached rows) — live rows are never victims.
    Thread-safe; the engine's device loop is the only inserter/evictor,
    but ``peek_len`` is called from submit threads for TTFT projection.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._root = _TrieNode()
        self._paths = {}   # slot -> tuple of prompt tokens
        self._stamp = {}   # slot -> last-use tick (LRU order)
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.reuse_tokens = 0

    def insert(self, tokens, slot):
        path = tuple(int(t) for t in tokens)
        with self._lock:
            self._forget_locked(slot)
            node = self._root
            for t in path:
                node = node.kids.setdefault(t, _TrieNode())
                node.slots.add(slot)
            self._paths[slot] = path
            self._tick += 1
            self._stamp[slot] = self._tick

    def lookup(self, tokens):
        """(slot, depth) of the deepest reusable stored prefix, or
        ``(None, 0)``. Counts the hit/miss and bumps the donor's LRU
        stamp (a reused row is hot — evict colder ones first)."""
        path = [int(t) for t in tokens]
        with self._lock:
            node = self._root
            best_slot, best_depth, depth = None, 0, 0
            for t in path[:max(0, len(path) - 1)]:
                node = node.kids.get(t)
                if node is None:
                    break
                depth += 1
                if node.slots:
                    # any slot through this node shares >= depth tokens;
                    # prefer the most recently used (coldest stay LRU)
                    best_slot = max(
                        node.slots, key=lambda s: self._stamp.get(s, 0))
                    best_depth = depth
            if best_slot is None:
                self.misses += 1
                return None, 0
            self.hits += 1
            self.reuse_tokens += best_depth
            self._tick += 1
            self._stamp[best_slot] = self._tick
        _PREFIX_HITS.inc()
        _PREFIX_REUSE_TOKENS.inc(best_depth)
        return best_slot, best_depth

    def peek_len(self, tokens):
        """Reusable prefix length for ``tokens`` WITHOUT counting a
        hit or touching LRU — the admission TTFT projection's view."""
        path = [int(t) for t in tokens]
        with self._lock:
            node = self._root
            best, depth = 0, 0
            for t in path[:max(0, len(path) - 1)]:
                node = node.kids.get(t)
                if node is None:
                    break
                depth += 1
                if node.slots:
                    best = depth
        return best

    def note_miss(self):
        """Count a lookup that never reached the trie (e.g. a faulted
        ``serve.decode.prefix_lookup`` falling back to cold prefill)."""
        with self._lock:
            self.misses += 1

    def has(self, slot):
        with self._lock:
            return slot in self._paths

    def forget(self, slot):
        """Drop ``slot``'s path (slot freed/evicted or being re-filled);
        no-op when the slot has no stored path."""
        with self._lock:
            self._forget_locked(slot)

    def _forget_locked(self, slot):
        path = self._paths.pop(slot, None)
        self._stamp.pop(slot, None)
        if path is None:
            return
        node, chain = self._root, []
        for t in path:
            nxt = node.kids.get(t)
            if nxt is None:
                break
            chain.append((node, t, nxt))
            nxt.slots.discard(slot)
            node = nxt
        for parent, t, child in reversed(chain):
            if not child.slots and not child.kids:
                del parent.kids[t]

    def evict_lru(self, candidates):
        """Forget the least-recently-used stored path among
        ``candidates`` (the engine's idle cached rows) and return its
        slot, or ``None`` when no candidate has a path."""
        pool = set(candidates)
        with self._lock:
            eligible = [s for s in self._paths if s in pool]
            if not eligible:
                return None
            victim = min(eligible, key=lambda s: self._stamp.get(s, 0))
            self._forget_locked(victim)
            self.evictions += 1
        _PREFIX_EVICTIONS.inc()
        return victim

    def stats(self):
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "reuse_tokens": self.reuse_tokens,
                "stored_paths": len(self._paths),
                "hit_rate": (self.hits / lookups) if lookups else None,
            }
