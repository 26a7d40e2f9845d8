"""Numpy arrays over the msgpack wire: tag-encode ndarrays inside pytrees,
plus the columnar batch encoding the elastic data plane ships batches in.

Used by the distill plane to ship feature batches and teacher predictions
(the role paddle-serving's protobuf tensors played in the reference), and
by the data plane's ``get_batches`` to turn a list of records into a
handful of ndarray columns that ride the v2 tensor frames out-of-band —
one contiguous segment per column instead of one msgpack object (or one
frame segment) per record.
"""

import numpy as np

_TAG = "__nd__"


def encode_tree(obj):
    if isinstance(obj, np.ndarray):
        return {_TAG: True, "dtype": obj.dtype.str,
                "shape": list(obj.shape),
                "data": obj.tobytes()}
    if isinstance(obj, (np.generic,)):
        return encode_tree(np.asarray(obj))
    if isinstance(obj, dict):
        return {k: encode_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_tree(v) for v in obj]
    return obj


def decode_tree(obj, copy=True):
    """``copy=False`` returns READ-ONLY views into the decoded message
    bytes (zero-copy) — right for consumers that only feed the arrays
    onward (device upload, jnp conversion); the distill teacher's feed
    path saves a full batch-size memcpy per request this way. Default
    stays copying (owned, writable arrays)."""
    if isinstance(obj, dict):
        if obj.get(_TAG):
            arr = np.frombuffer(
                obj["data"], dtype=np.dtype(obj["dtype"])
            ).reshape(obj["shape"])
            return arr.copy() if copy else arr
        return {k: decode_tree(v, copy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_tree(v, copy) for v in obj]
    return obj


# -- columnar batch encoding ------------------------------------------------
#
# pack_columns turns a HOMOGENEOUS list of records into a small dict of
# ndarray columns; unpack_columns restores the exact original records
# (types included), so the row and columnar wire formats are
# interchangeable — the negotiation can fall back per producer without
# the consumer seeing any difference. Returns None for record shapes it
# cannot represent exactly; callers then keep the row format.
#
# Column kinds:
#   nd     records are ndarrays of one dtype+shape  -> one stacked array
#   str    utf-8 bytes blob + per-record lengths
#   bytes  raw blob + per-record lengths
#   i64    python ints that fit int64               -> one int64 array
#   f64    python floats                            -> one float64 array
#   tuple / list  fixed-arity rows; one column per field

def pack_columns(records):
    """Columnar form of ``records`` (a non-empty list), or None when the
    records are heterogeneous / unsupported and the row format must be
    kept."""
    if not records:
        return None
    first = records[0]
    if isinstance(first, str):
        if not all(type(r) is str for r in records):
            return None
        blobs = [r.encode("utf-8") for r in records]
        return {"kind": "str",
                "data": np.frombuffer(b"".join(blobs), dtype=np.uint8),
                "lens": np.array([len(b) for b in blobs], "<i8")}
    if isinstance(first, bytes):
        if not all(type(r) is bytes for r in records):
            return None
        return {"kind": "bytes",
                "data": np.frombuffer(b"".join(records), dtype=np.uint8),
                "lens": np.array([len(b) for b in records], "<i8")}
    if isinstance(first, np.ndarray):
        dtype, shape = first.dtype, first.shape
        if dtype.hasobject:
            return None
        if not all(isinstance(r, np.ndarray) and r.dtype == dtype
                   and r.shape == shape for r in records):
            return None
        return {"kind": "nd", "data": np.stack(records)}
    if type(first) is int:  # bool is an int subclass: keep it row-form
        if not all(type(r) is int for r in records):
            return None
        try:
            col = np.array(records, "<i8")
        except OverflowError:
            return None
        return {"kind": "i64", "data": col}
    if type(first) is float:
        if not all(type(r) is float for r in records):
            return None
        return {"kind": "f64", "data": np.array(records, "<f8")}
    if isinstance(first, (tuple, list)):
        arity = len(first)
        seq = type(first)
        if not all(type(r) is seq and len(r) == arity for r in records):
            return None
        fields = []
        for i in range(arity):
            col = pack_columns([r[i] for r in records])
            if col is None:
                return None
            fields.append(col)
        return {"kind": "tuple" if seq is tuple else "list",
                "fields": fields, "n": len(records)}
    return None


def _col_array(data, copy):
    """Normalize a column that crossed the wire: v2 tensor frames hand
    us a real ndarray already; the v1 tagged fallback (or a msgpack
    bin) arrives as a tagged dict / raw bytes."""
    if isinstance(data, np.ndarray):
        return data
    return decode_tree(data, copy=copy)


def unpack_columns(col, copy=False):
    """The exact record list ``pack_columns`` encoded. ``copy=False``
    returns views into the received buffers for ``nd`` columns (the
    zero-copy path into device upload); blob-backed kinds (str/bytes)
    materialize per-record objects either way."""
    kind = col["kind"]
    if kind in ("tuple", "list"):
        cols = [unpack_columns(f, copy=copy) for f in col["fields"]]
        rows = zip(*cols) if cols else [() for _ in range(col["n"])]
        if kind == "tuple":
            return [tuple(r) for r in rows]
        return [list(r) for r in rows]
    data = _col_array(col["data"], copy)
    if kind == "nd":
        return [r.copy() if copy else r for r in data]
    if kind in ("str", "bytes"):
        lens = _col_array(col["lens"], copy)
        blob = data.tobytes()  # one copy for the whole column
        out, off = [], 0
        for n in lens.tolist():
            chunk = blob[off:off + n]
            out.append(chunk.decode("utf-8") if kind == "str" else chunk)
            off += n
        return out
    if kind == "i64":
        return [int(v) for v in data.tolist()]
    if kind == "f64":
        return [float(v) for v in data.tolist()]
    raise ValueError("unknown column kind %r" % kind)
