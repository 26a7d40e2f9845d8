"""Atomic, versioned checkpointing of torch state trees with
manifest-last commit: ``edl_tpu/runtime/checkpoint.py`` on torch, with
its on-disk formats byte for byte, so that either package reads what
the other writes.

A state tree is nested dicts, lists and tuples (a NamedTuple's fields
by name) of ``torch.Tensor`` leaves; numpy arrays and Python scalars
are leaves too, and None is an empty subtree, as in a JAX pytree. A
leaf's key is its path joined with ``/``: dict keys in sorted order,
sequence indices, ``.field`` for a NamedTuple field (the JAX package's
``_path_key``), so the entry order, and with it the stream layout's
``a<j>.bin`` numbering, is the JAX package's.

Layout (dense, the default):
    <dir>/v_00000012/arrays.npz   flat {path: ndarray} of the leaves
    <dir>/v_00000012/meta.json    user metadata + dtype tags (bfloat16)
    <dir>/v_00000012/MANIFEST     written last: {"version", "crc"}

Layout (stream, the async snapshot-then-persist engine):
    <dir>/v_00000012/a0000.bin    one raw chunk-streamed file per entry
    <dir>/v_00000012/meta.json    user metadata + dtype tags
    <dir>/v_00000012/MANIFEST     written last: per-entry spans, files,
                                  crcs ("format": "stream")

Layout (sharded, written by the JAX package's ``save_sharded`` and
``save_sharded_async``): per-rank ``arrays.r<k>.npz`` or
``r<k>_a<j>.bin`` files whose keys are ``path@s0:e0;s1:e1;...``. The
port reads it whole (:meth:`CheckpointManager.restore` with a target);
the sharded writers and the placed restore come with the mesh (ROADMAP
A12) and raise until then.

bf16 has no numpy dtype on the card's machine (no ``ml_dtypes``): a
bf16 tensor goes to disk through its int16 view as uint16 with the
``"bfloat16"`` tag, as the JAX package writes ``ml_dtypes.bfloat16``,
and comes back as a bf16 tensor. A restore returns tensors on the
target leaf's device (the CPU without a target), never numpy bf16.

The async save (:meth:`CheckpointManager.save_async`): phase 1
("snapshot", on the training thread) copies every CUDA leaf into a
reused pinned host buffer with ``non_blocking=True`` on a side stream
that has waited on the training stream, marks each source tensor as in
use by that stream (``record_stream``: a functional step's old state
goes back to the caching allocator as soon as the caller drops it,
while the copy may still be reading it) and records one event, which
the training stream then waits on (a step that updates a leaf in place
would otherwise race the copy: the training stream stalls for the
device-to-host copy, the host does not); CPU leaves are copied on the
spot. Phase 2
("persist", a background writer pool) waits on the event before it
reads a byte, streams each entry to its own file in fixed-size chunks
with an incremental crc32, and commits the MANIFEST last. max_inflight
is 1: a new save first drains the previous one, which is what makes
reusing the buffers safe. Crashed attempts leave no MANIFEST and are
removed by clean_uncommitted(). No ``torch.save``, no pickle.
"""

import io
import json
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import ledger as obs_ledger
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.runtime.fs import get_fs
from edl_tpu_torch.utils.logger import logger

_SAVE_MS = obs_metrics.histogram(
    "edl_ckpt_save_ms", "checkpoint save wall time to manifest commit",
    labels=("mode",))
_RESTORE_MS = obs_metrics.histogram(
    "edl_ckpt_restore_ms", "checkpoint restore wall time")

_SEP = "/"
_A12 = ("not ported to edl_tpu_torch yet (ROADMAP A12: the mesh, "
        "sharded writes and the placed restore across ranks)")


class MissingKeysError(IOError):
    """The checkpoint is valid but lacks keys the restore target needs
    (e.g. a legacy checkpoint without the model's extra state)."""

    def __init__(self, keys):
        super().__init__("checkpoint missing keys: %s" % sorted(keys))
        self.keys = frozenset(keys)


# -- trees: JAX's flatten order and path keys -----------------------------

def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(path component, child) pairs of an inner node in JAX's order,
    or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix=()):
    """[(key, leaf)] in JAX's ``tree_flatten_with_path`` order; None is
    an empty subtree."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(_SEP.join(str(p) for p in prefix), tree)]
    out = []
    for part, child in kids:
        out.extend(_flatten(child, prefix + (part,)))
    return out


def _unflatten(target, leaves):
    """``target``'s structure with each leaf replaced by
    ``leaves[key]`` (dicts keep the target's key order)."""
    def build(node, prefix):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v, prefix + (k,)) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*[build(getattr(node, f), prefix + ("." + f,))
                                for f in node._fields])
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (i,))
                              for i, v in enumerate(node))
        return leaves[_SEP.join(str(p) for p in prefix)]
    return build(target, ())


def _paths(tree):
    return [key for key, _ in _flatten(tree)]


def _unflatten_to_nested(arrays):
    """Rebuild a nested dict from flat path keys (lists come back as dicts
    keyed by index strings; fine for structure-free inspection)."""
    root = {}
    for key, arr in arrays.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root


# -- leaves: tensors <-> wire arrays ---------------------------------------

def _wire_tensor(t):
    """(wire ndarray, tag|None) of a CPU tensor, sharing its memory:
    bf16 as its uint16 bits with the ``"bfloat16"`` tag."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _wire_entry(arr):
    """(wire_array, dtype_tag|None) of a host array: dtypes without the
    buffer protocol ship as a POD view — bfloat16 as uint16,
    datetime/timedelta as int64 — and the tag restores the view on
    read."""
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array from a caller
        return arr.view(np.uint16), "bfloat16"
    if arr.dtype.kind in "mM":
        return arr.view(np.int64), arr.dtype.str
    return arr, None


def _host_leaf(leaf):
    """(wire ndarray, tag|None) of any leaf, copied to the host."""
    if isinstance(leaf, torch.Tensor):
        return _wire_tensor(leaf.detach().cpu())
    return _wire_entry(np.asarray(leaf))


def _to_tensor(arr, tag, device=None):
    """The inverse of the wire: a tensor (on ``device``) from a wire
    array and its tag; a datetime tag gives the numpy view back (torch
    has no such dtype)."""
    # np.require keeps a 0-d array 0-d (ascontiguousarray would not)
    arr = np.require(arr, requirements=("C", "W"))
    if tag == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif tag:
        return arr.view(np.dtype(tag))
    else:
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def _leaf_device(leaf):
    dev = getattr(leaf, "device", None)
    return dev if isinstance(dev, torch.device) else None


# -- shard-span codec: the ONE encode/decode pair for "s0:e0;s1:e1;..." --

def _spans_str(spans):
    return ";".join("%d:%d" % ab for ab in spans)


def _parse_spans(s):
    return tuple((int(a), int(b))
                 for part in s.split(";") if part
                 for a, b in [part.split(":")])


def _full_key(key, shape):
    return "%s@%s" % (key, _spans_str((0, d) for d in shape))


def sharding_record(tree):
    """The JAX package's sharding record of a state on one device: no
    mesh, and every leaf unsharded (``None`` reads back as
    replicated)."""
    return {"mesh": None, "specs": {key: None for key in _paths(tree)}}


# -- stream-format plumbing (the async snapshot/persist engine) -----------

_CHUNK = 4 << 20  # fixed-size streaming chunk for entry files


class _HostBufferPool(object):
    """Reusable host staging buffers for snapshots, keyed by entry key:
    pinned tensors for CUDA leaves (the target of a non-blocking D2H
    copy), numpy arrays for host leaves. Reuse across versions avoids a
    fresh multi-GB allocation per save; it is safe exactly because
    max_inflight=1 — the previous persist is drained before a new
    snapshot touches the buffers."""

    def __init__(self):
        self._bufs = {}

    def tensor(self, key, like, pinned):
        buf = self._bufs.get(key)
        if not isinstance(buf, torch.Tensor) or buf.shape != like.shape \
                or buf.dtype != like.dtype or buf.is_pinned() != pinned:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=pinned)
            self._bufs[key] = buf
        return buf

    def copy_in(self, key, arr):
        arr = np.asarray(arr)
        buf = self._bufs.get(key)
        if not isinstance(buf, np.ndarray) or buf.shape != arr.shape \
                or buf.dtype != arr.dtype:
            buf = np.empty(arr.shape, arr.dtype)
            self._bufs[key] = buf
        np.copyto(buf, arr)
        return buf


class SaveHandle(object):
    """Completion handle for an async checkpoint save.

    ``blocked_s`` is the training-thread (snapshot) time; ``persist_s``
    the background write time, set once the persist finishes; ``nbytes``
    the bytes written. wait() blocks without raising; result() re-raises
    any persist failure."""

    def __init__(self, version):
        self.version = version
        self.blocked_s = 0.0
        self.persist_s = None
        self.nbytes = None
        self._evt = threading.Event()
        self._vdir = None
        self._exc = None

    def done(self):
        return self._evt.is_set()

    def wait(self, timeout=None):
        return self._evt.wait(timeout)

    def exception(self):
        return self._exc

    def result(self, timeout=None):
        if not self._evt.wait(timeout):
            raise TimeoutError("checkpoint v%d persist still running"
                               % self.version)
        if self._exc is not None:
            raise self._exc
        return self._vdir

    def _finish(self, vdir, exc=None, persist_s=None):
        self._vdir = vdir
        self._exc = exc
        self.persist_s = persist_s
        self._evt.set()


class CheckpointManager(object):
    def __init__(self, directory, keep=3, fs=None, workers=4):
        self._dir = str(directory)
        self._fs = fs or get_fs(directory)
        self._keep = keep
        self._workers = max(1, int(workers))
        self._pool = None           # lazy writer/reader thread pool
        self._host_bufs = _HostBufferPool()
        self._inflight = None       # the (single) in-flight SaveHandle
        self._async_lock = threading.Lock()
        self._side_streams = {}     # CUDA device -> snapshot copy stream

    # -- helpers -------------------------------------------------------------

    def _io_pool(self):
        """The shared writer/reader pool: persist fan-out AND the
        parallel restore reads ride the same threads."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._workers, thread_name_prefix="ckpt-io")
        return self._pool

    def drain(self):
        """Block until the in-flight async save (if any) finishes;
        returns its SaveHandle or None. A persist failure is logged, not
        raised (the manifest-last invariant already keeps the failed
        version invisible) — callers that must see the exception hold
        the handle and call result()."""
        with self._async_lock:
            h, self._inflight = self._inflight, None
        if h is not None:
            # drain() runs on the TRAINING thread (step boundary): the
            # wait is attributed checkpoint-blocked time. The writer
            # pool's own concurrency is never ledgered.
            with obs_ledger.LEDGER.state("ckpt_block"):
                h.wait()
            if h.exception() is not None:
                logger.error("async checkpoint v%d failed: %r",
                             h.version, h.exception())
        return h

    def close(self):
        """Drain the in-flight save and shut the writer pool down."""
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _vdir(self, version):
        return "%s/v_%08d" % (self._dir, version)

    def versions(self):
        """Committed (manifest-valid) versions, ascending."""
        out = []
        for name in self._fs.listdir(self._dir):
            if name.startswith("v_"):
                try:
                    v = int(name[2:])
                except ValueError:
                    continue
                if self._fs.exists("%s/%s/MANIFEST" % (self._dir, name)):
                    out.append(v)
        return sorted(out)

    def meta(self, version):
        """User metadata of a committed version (the ``meta=`` blob the
        saver passed), or None when the version/meta is unreadable."""
        try:
            with self._fs.open(self._vdir(version) + "/meta.json",
                               "r") as f:
                return json.load(f).get("meta")
        except (IOError, OSError, ValueError):
            return None

    def clean_uncommitted(self):
        """Delete version dirs without a MANIFEST — garbage from crashed
        save attempts (the manifest-last invariant makes them invisible
        to restore). Call at process start, before any save."""
        removed = []
        for name in self._fs.listdir(self._dir):
            if not name.startswith("v_"):
                continue
            try:
                int(name[2:])
            except ValueError:
                continue
            if not self._fs.exists("%s/%s/MANIFEST" % (self._dir, name)):
                self._fs.delete_tree("%s/%s" % (self._dir, name))
                removed.append(name)
        if removed:
            logger.info("cleaned %d uncommitted checkpoint dir(s): %s",
                        len(removed), removed)
        return removed

    # -- save ---------------------------------------------------------------

    def save(self, version, tree, meta=None):
        """Write checkpoint ``version``; commit is the MANIFEST write."""
        with obs_ledger.LEDGER.state("ckpt_block"):
            return self._save(version, tree, meta=meta)

    def _save(self, version, tree, meta=None):
        t0 = time.monotonic()
        vdir = self._vdir(version)
        self._fs.delete_tree(vdir)  # clear any half-written attempt
        self._fs.makedirs(vdir)

        dtypes = {}
        to_save = {}
        for key, leaf in _flatten(tree):
            arr, tag = _host_leaf(leaf)
            if tag == "bfloat16":
                dtypes[key] = tag
            elif tag:  # the dense npz stores datetimes natively
                arr = arr.view(np.dtype(tag))
            to_save[key] = arr
        buf = io.BytesIO()
        np.savez(buf, **to_save)
        payload = buf.getvalue()
        crc = zlib.crc32(payload)
        with self._fs.open(vdir + "/arrays.npz", "wb") as f:
            f.write(payload)
        with self._fs.open(vdir + "/meta.json", "w") as f:
            json.dump({"meta": meta or {}, "dtypes": dtypes}, f)
        # the commit point:
        with self._fs.open(vdir + "/MANIFEST", "w") as f:
            json.dump({"version": version, "crc": crc,
                       "nbytes": len(payload)}, f)
        logger.info("checkpoint v%d committed (%d arrays, %.1f MB)", version,
                    len(to_save), len(payload) / 1e6)
        _SAVE_MS.labels("sync").observe((time.monotonic() - t0) * 1e3)
        obs_events.emit("ckpt.saved", version=version, mode="sync",
                        nbytes=len(payload))
        self._gc()
        return vdir

    def _gc(self):
        versions = self.versions()
        for v in versions[:-self._keep] if self._keep else []:
            self._fs.delete_tree(self._vdir(v))

    # -- async save: snapshot phase ------------------------------------------

    def _side_stream(self, device):
        stream = self._side_streams.get(device)
        if stream is None:
            stream = torch.cuda.Stream(device=device)
            self._side_streams[device] = stream
        return stream

    def _snapshot_dense(self, tree):
        """Phase-1 snapshot of a full tree: ({span_key: host buffer},
        dtype tags, events). CUDA leaves are copied into pooled pinned
        buffers on a side stream, which first waits on the training
        stream; each source tensor is marked in use by that stream, and
        one event per device marks the end of its copies: the buffers
        must not be read before it, and the training stream waits on it,
        so a step that writes a leaf in place cannot race the copy.
        Host leaves are copied here."""
        entries = {}
        dtypes = {}
        streams = {}
        for key, leaf in _flatten(tree):
            if isinstance(leaf, torch.Tensor):
                t = leaf.detach()
                skey = _full_key(key, t.shape)
                buf = self._host_bufs.tensor(skey, t, pinned=t.is_cuda)
                if t.is_cuda:
                    side = streams.get(t.device)
                    if side is None:
                        side = self._side_stream(t.device)
                        side.wait_stream(torch.cuda.current_stream(t.device))
                        streams[t.device] = side
                    with torch.cuda.stream(side):
                        buf.copy_(t, non_blocking=True)
                    t.record_stream(side)
                else:
                    buf.copy_(t)
                if t.dtype == torch.bfloat16:
                    dtypes[key] = "bfloat16"
            else:
                arr, tag = _wire_entry(np.asarray(leaf))
                if tag:
                    dtypes[key] = tag
                skey = _full_key(key, arr.shape)
                buf = self._host_bufs.copy_in(skey, arr)
            entries[skey] = buf
        events = []
        for device, side in streams.items():
            evt = torch.cuda.Event()
            evt.record(side)
            torch.cuda.current_stream(device).wait_event(evt)
            events.append(evt)
        return entries, dtypes, events

    # -- async save: persist phase -------------------------------------------

    def _write_entry_file(self, path, arr):
        """Stream one (contiguous, wire-dtype) array to its own file in
        fixed-size chunks with an incremental crc. Returns (nbytes, crc,
        chunk_crcs): the per-chunk crc list lands in the manifest, as
        the JAX package's range reads expect."""
        arr = np.ascontiguousarray(arr)
        chunk_crcs = []
        if arr.nbytes == 0:
            nbytes, crc = self._fs.write_chunks(path, ())
            return nbytes, crc, chunk_crcs

        def chunks():
            view = memoryview(arr.reshape(-1)).cast("B")
            for off in range(0, len(view), _CHUNK):
                chunk = view[off:off + _CHUNK]
                chunk_crcs.append(zlib.crc32(chunk))
                yield chunk

        nbytes, crc = self._fs.write_chunks(path, chunks())
        return nbytes, crc, chunk_crcs

    def _read_entry_file(self, path, entry):
        """Read one stream entry back (chunked, incremental crc check),
        returning the wire-dtype array."""
        dtype = np.dtype(entry["dtype"])
        arr = np.empty(tuple(entry["shape"]), dtype)
        nbytes = int(entry["nbytes"])
        if arr.nbytes != nbytes:
            raise IOError("entry %s: %d bytes recorded vs %d expected"
                          % (path, nbytes, arr.nbytes))
        crc = 0
        got = 0
        view = memoryview(arr.reshape(-1)).cast("B") if nbytes else None
        with self._fs.open(path, "rb") as f:
            while got < nbytes:
                chunk = f.read(min(_CHUNK, nbytes - got))
                if not chunk:
                    raise IOError("entry %s truncated at %d/%d bytes"
                                  % (path, got, nbytes))
                view[got:got + len(chunk)] = chunk
                crc = zlib.crc32(chunk, crc)
                got += len(chunk)
        if crc != int(entry["crc"]):
            raise IOError("checksum mismatch in %s" % path)
        return arr

    def _write_entries(self, vdir, prefix, entries):
        """Fan the entry files out across the writer pool; returns the
        manifest entry table {span_key: {file, dtype, shape, crc,
        nbytes, chunk, chunk_crcs}} and the total byte count."""
        pool = self._io_pool()
        futs = []
        for i, skey in enumerate(sorted(entries)):
            fname = "%sa%04d.bin" % (prefix, i)
            arr = entries[skey]
            if isinstance(arr, torch.Tensor):
                arr = _wire_tensor(arr)[0]
            futs.append((skey, fname, arr,
                         pool.submit(self._write_entry_file,
                                     "%s/%s" % (vdir, fname), arr)))
        table = {}
        total = 0
        for skey, fname, arr, fut in futs:
            nbytes, crc, chunk_crcs = fut.result()
            table[skey] = {"file": fname, "dtype": arr.dtype.str,
                           "shape": list(arr.shape), "crc": crc,
                           "nbytes": nbytes, "chunk": _CHUNK,
                           "chunk_crcs": chunk_crcs}
            total += nbytes
        return table, total

    def save_async(self, version, tree, meta=None, on_commit=None):
        """Two-phase async save. The snapshot runs HERE (device->host
        copies into pooled buffers, queued on a side stream), then
        control returns while a background thread waits for the copies,
        streams the entries to per-array files and commits the MANIFEST
        last. Returns a SaveHandle; max_inflight is 1 — this call first
        drains any previous async save. ``on_commit`` (optional) runs on
        the background thread right after the manifest commit; a failure
        there is logged, never surfaced as a save failure."""
        self.drain()
        t0 = time.perf_counter()
        # the snapshot is the async save's only training-thread cost
        with obs_ledger.LEDGER.state("ckpt_block"):
            entries, dtypes, events = self._snapshot_dense(tree)
        handle = SaveHandle(version)
        handle.blocked_s = time.perf_counter() - t0

        def persist():
            p0 = time.perf_counter()
            try:
                # no byte of a pinned buffer is read before its copy ends
                for evt in events:
                    evt.synchronize()
                vdir = self._vdir(version)
                self._fs.delete_tree(vdir)
                self._fs.makedirs(vdir)
                table, total = self._write_entries(vdir, "", entries)
                with self._fs.open(vdir + "/meta.json", "w") as f:
                    json.dump({"meta": meta or {}, "dtypes": dtypes}, f)
                # the commit point:
                with self._fs.open(vdir + "/MANIFEST", "w") as f:
                    json.dump({"version": version, "format": "stream",
                               "entries": table, "nbytes": total}, f)
                handle.nbytes = total
                logger.info("checkpoint v%d committed async (%d entries,"
                            " %.1f MB)", version, len(table),
                            total / 1e6)
                _SAVE_MS.labels("async").observe(
                    (time.perf_counter() - p0) * 1e3)
                obs_events.emit("ckpt.saved", version=version,
                                mode="async", nbytes=total)
                self._gc()
                if on_commit is not None:
                    # the manifest is already durable: a failing commit
                    # observer must not mark the save failed
                    try:
                        on_commit()
                    except Exception:
                        logger.exception(
                            "on_commit callback for v%d failed",
                            version)
                handle._finish(vdir,
                               persist_s=time.perf_counter() - p0)
            except BaseException as e:  # noqa: BLE001 — surfaces via result()
                handle._finish(None, exc=e,
                               persist_s=time.perf_counter() - p0)

        with self._async_lock:
            self._inflight = handle
        threading.Thread(target=persist, daemon=False,
                         name="ckpt-persist-%d" % version).start()
        return handle

    # -- across ranks: ROADMAP A12 -------------------------------------------

    def save_sharded(self, *args, **kwargs):
        raise NotImplementedError("save_sharded is " + _A12)

    def save_sharded_async(self, *args, **kwargs):
        raise NotImplementedError("save_sharded_async is " + _A12)

    def restore_placed(self, *args, **kwargs):
        raise NotImplementedError("restore_placed is " + _A12)

    # -- restore -------------------------------------------------------------

    def load_manifest(self, version):
        """(vdir, manifest, meta_blob) of a committed version."""
        vdir = self._vdir(version)
        with self._fs.open(vdir + "/MANIFEST", "r") as f:
            manifest = json.load(f)
        with self._fs.open(vdir + "/meta.json", "r") as f:
            meta_blob = json.load(f)
        return vdir, manifest, meta_blob

    def restore_latest(self, target=None):
        """Restore the newest valid checkpoint.

        Returns (version, tree, meta) or None. Corrupt versions (bad crc /
        missing manifest) are skipped, falling back to the previous one.
        If ``target`` is given, leaves are restored into its structure.
        """
        for version in reversed(self.versions()):
            try:
                return self.restore(version, target)
            except Exception as e:  # noqa: BLE001 — fall back to older ckpt
                logger.warning("checkpoint v%d unreadable (%r); trying older",
                               version, e)
        return None

    def restore(self, version, target=None):
        """(version, tree, meta) of ``version``: tensors in ``target``'s
        structure, each on its target leaf's device (the CPU where the
        leaf has none), in the saved dtype; without a target, a nested
        dict of CPU tensors. A sharded checkpoint needs a target, whose
        leaves give the shapes (and dtypes, cast to as the JAX package
        does)."""
        t0 = time.monotonic()
        try:
            out = self._restore(version, target)
        except Exception:
            obs_events.emit("ckpt.restore_failed", version=version)
            raise
        _RESTORE_MS.observe((time.monotonic() - t0) * 1e3)
        obs_events.emit("ckpt.restored", version=version)
        return out

    def _restore(self, version, target=None):
        vdir, manifest, meta_blob = self.load_manifest(version)
        tags = meta_blob["dtypes"]
        if manifest.get("sharded"):
            tree = self._restore_sharded(vdir, manifest, tags, target)
            return version, tree, meta_blob["meta"]
        if manifest.get("format") == "stream":
            pool = self._io_pool()
            futs = [(skey, pool.submit(self._read_entry_file,
                                       "%s/%s" % (vdir, entry["file"]),
                                       entry))
                    for skey, entry in manifest["entries"].items()]
            arrays = {skey.rpartition("@")[0]: fut.result()
                      for skey, fut in futs}
        else:
            with self._fs.open(vdir + "/arrays.npz", "rb") as f:
                payload = f.read()
            if zlib.crc32(payload) != manifest["crc"]:
                raise IOError("checksum mismatch in %s" % vdir)
            npz = np.load(io.BytesIO(payload))
            arrays = {key: npz[key] for key in npz.files}
        return version, self._place(arrays, tags, target), meta_blob["meta"]

    @staticmethod
    def _place(arrays, tags, target):
        if target is None:
            return _unflatten_to_nested(
                {k: _to_tensor(a, tags.get(k)) for k, a in arrays.items()})
        flat = _flatten(target)
        missing = {k for k, _ in flat} - set(arrays)
        if missing:
            raise MissingKeysError(missing)
        return _unflatten(target, {
            k: _to_tensor(arrays[k], tags.get(k), _leaf_device(leaf))
            for k, leaf in flat})

    def _restore_sharded(self, vdir, manifest, tags, target):
        """Assemble a sharded checkpoint (the JAX package's rank files,
        npz or stream) whole: every saved span pasted into one host
        array per key, which must be covered completely."""
        if target is None:
            raise IOError("sharded checkpoint restore needs a target "
                          "structure (shapes/dtypes)")
        flat = _flatten(target)
        specs = {key: leaf for key, leaf in flat}
        buffers = {}
        filled = {k: 0 for k in specs}

        def paste(skey, arr):
            key, _, spans = skey.rpartition("@")
            if key not in buffers:
                buffers[key] = np.zeros(tuple(specs[key].shape), arr.dtype)
            idx = tuple(slice(a, b) for a, b in _parse_spans(spans))
            buffers[key][idx] = arr
            filled[key] += arr.size

        if manifest.get("format") == "stream":
            pool = self._io_pool()
            futs = [(skey, pool.submit(self._read_entry_file,
                                       "%s/%s" % (vdir, entry["file"]),
                                       entry))
                    for skey, entry in manifest["entries"].items()
                    if skey.rpartition("@")[0] in specs]
            for skey, fut in futs:
                paste(skey, fut.result())
        else:
            def read_rank(r):
                with self._fs.open("%s/arrays.r%d.npz" % (vdir, r),
                                   "rb") as f:
                    payload = f.read()
                if zlib.crc32(payload) != manifest["crcs"][str(r)]:
                    raise IOError("checksum mismatch in %s rank %d"
                                  % (vdir, r))
                return payload
            for payload in self._io_pool().map(
                    read_rank, range(int(manifest["ranks"]))):
                npz = np.load(io.BytesIO(payload))
                for skey in npz.files:
                    if skey.rpartition("@")[0] in specs:
                        paste(skey, npz[skey])
        # scalars: prod(())==1, filled must be >= 1
        missing = {k for k, leaf in specs.items()
                   if filled[k] < int(np.prod(tuple(leaf.shape),
                                              dtype=np.int64))}
        if missing:
            raise MissingKeysError(missing)
        leaves = {}
        for key, leaf in specs.items():
            t = _to_tensor(buffers[key], tags.get(key), _leaf_device(leaf))
            dtype = getattr(leaf, "dtype", None)
            if isinstance(dtype, torch.dtype) and isinstance(t, torch.Tensor):
                t = t.to(dtype)
            leaves[key] = t
        return _unflatten(target, leaves)
