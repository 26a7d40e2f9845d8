"""Filesystem abstraction behind checkpointing.

Reference parity: the LocalFS/BDFS(HDFS) wrapper Paddle Fleet used for
checkpoints (example/collective/resnet50/train_with_fleet.py:422-424). The
TPU equivalent targets POSIX (NFS/local) and GCS; GCS has no atomic rename,
so the checkpoint layer commits via manifest-last writes instead of relying
on rename (SURVEY.md §7 "hard parts").

GCSFS speaks the GCS JSON API directly over urllib (no google-cloud-storage
dependency): point it at a real endpoint with auth via a bearer token, or
at any GCS emulator via STORAGE_EMULATOR_HOST (the in-tree one lives in
edl_tpu/tools/fake_gcs.py).
"""

import io
import json
import os
import shutil
import urllib.error
import urllib.parse
import urllib.request
import zlib


class FileSystem(object):
    def exists(self, path):
        raise NotImplementedError

    def makedirs(self, path):
        raise NotImplementedError

    def open(self, path, mode):
        raise NotImplementedError

    def write_chunks(self, path, chunks):
        """Stream an iterable of byte chunks to ``path``, computing
        zlib.crc32 incrementally; returns (nbytes, crc). The streaming
        write primitive of the async checkpoint engine — backends that
        can pipeline (resumable uploads, O_DIRECT) override this; the
        default rides open()."""
        nbytes = 0
        crc = 0
        with self.open(path, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
                crc = zlib.crc32(chunk, crc)
                nbytes += len(chunk)
        return nbytes, crc

    def read_range(self, path, offset, length):
        """Read ``length`` bytes starting at ``offset``. Reads past EOF
        return the available suffix (may be shorter than ``length``);
        an offset at/past EOF returns b"". The random-access primitive
        behind placed restores: a process that owns one device block of
        a leaf pulls just that byte span instead of the whole file."""
        raise NotImplementedError

    def listdir(self, path):
        raise NotImplementedError

    def delete_tree(self, path):
        raise NotImplementedError

    def delete(self, path):
        """Delete a single file; missing files are not an error."""
        raise NotImplementedError

    def rename(self, src, dst):
        raise NotImplementedError


class LocalFS(FileSystem):
    def exists(self, path):
        return os.path.exists(path)

    def makedirs(self, path):
        os.makedirs(path, exist_ok=True)

    def open(self, path, mode):
        return open(path, mode)

    def read_range(self, path, offset, length):
        if length <= 0:
            return b""
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def listdir(self, path):
        try:
            return sorted(os.listdir(path))
        except FileNotFoundError:
            return []

    def delete_tree(self, path):
        shutil.rmtree(path, ignore_errors=True)

    def delete(self, path):
        try:
            os.remove(path)
        except FileNotFoundError:
            pass

    def rename(self, src, dst):
        os.replace(src, dst)


def _split_gs(path):
    """gs://bucket/a/b -> (bucket, "a/b")."""
    if not str(path).startswith("gs://"):
        raise ValueError("not a gs:// path: %r" % (path,))
    rest = str(path)[len("gs://"):]
    bucket, _, obj = rest.partition("/")
    return bucket, obj.strip("/")


class _GCSWriter(io.BytesIO):
    """Buffers locally; uploads the object on close (GCS objects are
    immutable blobs — there is no partial append)."""

    def __init__(self, fs, bucket, name):
        super().__init__()
        self._fs, self._bucket, self._name = fs, bucket, name
        self._closed_once = False

    def close(self):
        if not self._closed_once:
            self._closed_once = True
            self._fs._upload(self._bucket, self._name, self.getvalue())
        super().close()


class GCSFS(FileSystem):
    """GCS over the JSON API: flat object namespace, no rename — the
    checkpoint layer's manifest-last commit is designed for exactly this
    (a version is valid iff its MANIFEST object exists).

    endpoint: emulator/base URL; defaults to $STORAGE_EMULATOR_HOST or the
    public GCS endpoint. token: OAuth bearer for real GCS (emulators need
    none).
    """

    def __init__(self, endpoint=None, token=None, timeout=30.0):
        self._base = (endpoint or os.environ.get("STORAGE_EMULATOR_HOST")
                      or "https://storage.googleapis.com").rstrip("/")
        self._token = token
        self._timeout = timeout

    # -- http plumbing ----------------------------------------------------

    def _request(self, method, url, data=None, ctype=None, headers=None):
        req = urllib.request.Request(url, data=data, method=method)
        if ctype:
            req.add_header("Content-Type", ctype)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        if self._token:
            req.add_header("Authorization", "Bearer %s" % self._token)
        return urllib.request.urlopen(req, timeout=self._timeout)

    def _obj_url(self, bucket, name, **params):
        url = "%s/storage/v1/b/%s/o/%s" % (
            self._base, urllib.parse.quote(bucket, safe=""),
            urllib.parse.quote(name, safe=""))
        if params:
            url += "?" + urllib.parse.urlencode(params)
        return url

    def _upload(self, bucket, name, data):
        url = "%s/upload/storage/v1/b/%s/o?%s" % (
            self._base, urllib.parse.quote(bucket, safe=""),
            urllib.parse.urlencode({"uploadType": "media", "name": name}))
        with self._request("POST", url, data=data,
                           ctype="application/octet-stream") as resp:
            resp.read()

    def _download(self, bucket, name):
        with self._request("GET", self._obj_url(bucket, name,
                                                alt="media")) as resp:
            return resp.read()

    def _download_range(self, bucket, name, offset, length):
        rng = "bytes=%d-%d" % (offset, offset + length - 1)
        try:
            with self._request("GET", self._obj_url(bucket, name,
                                                    alt="media"),
                               headers={"Range": rng}) as resp:
                data = resp.read()
                if resp.status == 206:
                    return data
        except urllib.error.HTTPError as e:
            if e.code == 416:  # offset at/past EOF
                return b""
            raise
        # a server that ignores Range answers 200 with the full object
        return data[offset:offset + length]

    def _list(self, bucket, prefix, delimiter=None):
        params = {"prefix": prefix}
        if delimiter:
            params["delimiter"] = delimiter
        url = "%s/storage/v1/b/%s/o?%s" % (
            self._base, urllib.parse.quote(bucket, safe=""),
            urllib.parse.urlencode(params))
        with self._request("GET", url) as resp:
            out = json.loads(resp.read().decode())
        return ([it["name"] for it in out.get("items", [])],
                out.get("prefixes", []))

    # -- FileSystem API ---------------------------------------------------

    def exists(self, path):
        bucket, obj = _split_gs(path)
        if not obj:
            return True
        try:
            with self._request("GET", self._obj_url(bucket, obj)) as resp:
                resp.read()
            return True
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
        # "directory": any object under the prefix
        items, prefixes = self._list(bucket, obj + "/", delimiter="/")
        return bool(items or prefixes)

    def makedirs(self, path):
        pass  # GCS has no directories

    def open(self, path, mode):
        bucket, obj = _split_gs(path)
        if "w" in mode:
            raw = _GCSWriter(self, bucket, obj)
            return raw if "b" in mode else io.TextIOWrapper(raw)
        try:
            data = self._download(bucket, obj)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(path)
            raise
        return (io.BytesIO(data) if "b" in mode
                else io.StringIO(data.decode()))

    def read_range(self, path, offset, length):
        if length <= 0:
            return b""
        bucket, obj = _split_gs(path)
        try:
            return self._download_range(bucket, obj, offset, length)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(path)
            raise

    def listdir(self, path):
        bucket, obj = _split_gs(path)
        prefix = obj + "/" if obj else ""
        items, prefixes = self._list(bucket, prefix, delimiter="/")
        names = [n[len(prefix):] for n in items]
        names += [p[len(prefix):].rstrip("/") for p in prefixes]
        return sorted(n for n in names if n)

    def delete_tree(self, path):
        bucket, obj = _split_gs(path)
        items, _ = self._list(bucket, obj + "/" if obj else "")
        for name in items + [obj]:
            try:
                with self._request(
                        "DELETE", self._obj_url(bucket, name)) as resp:
                    resp.read()
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    raise

    def delete(self, path):
        bucket, obj = _split_gs(path)
        try:
            with self._request(
                    "DELETE", self._obj_url(bucket, obj)) as resp:
                resp.read()
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def rename(self, src, dst):
        raise NotImplementedError(
            "GCS has no atomic rename; the checkpoint layer commits "
            "manifest-last and never calls rename on object stores")


def get_fs(path):
    if str(path).startswith("gs://"):
        return GCSFS()
    return LocalFS()
