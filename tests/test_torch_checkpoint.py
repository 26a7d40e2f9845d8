"""The port's checkpoint engine (``edl_tpu_torch/runtime/checkpoint.py``)
against the JAX package's, on the CPU: what one package writes, the
other restores bit for bit, in both directions and both layouts (dense
npz and the async engine's stream), and a sharded checkpoint that the
JAX package writes with two ranks (threads as ranks, as
tests/test_checkpoint.py runs them) restores whole in the port.

The trees are nested dicts and lists of f32, bf16, int32 and uint8
leaves from a seed; the JAX package's side holds numpy arrays (bf16 as
``ml_dtypes``), the port's torch tensors with the same bits. Leaves are
compared by their bytes, dtype and shape. The engine's own contract
(manifest-last commit, corrupt-version fallback, ``MissingKeysError``,
the async snapshot) is held on the port alone.
"""

import json
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from edl_tpu.runtime import checkpoint as jckpt
from edl_tpu.runtime.fs import GCSFS as JaxGCSFS
from edl_tpu_torch.runtime import checkpoint as tckpt
from edl_tpu_torch.runtime.fs import GCSFS, LocalFS
from edl_tpu_torch.tools import ckpt_bench

from _torch_threads import _one_torch_thread  # noqa: F401


def _bf16_bits(rng, shape):
    return (rng.randn(*shape) * 3).astype(np.float32).astype(
        ml_dtypes.bfloat16).view(np.uint16)


def _trees(seed):
    """(JAX-side numpy tree, port-side tensor tree) with the same bits."""
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    raw = {
        "params": {"dense": {"w": f32(4, 3), "b": f32(3)},
                   "emb": ("bf16", _bf16_bits(rng, (10, 4)))},
        "opt": [{"mu": f32(4, 3), "count": np.int32(seed)},
                {"trace": [f32(2), ("bf16", _bf16_bits(rng, (3, 2)))]}],
        "mask": rng.randint(0, 256, (5,)).astype(np.uint8),
        "ids": rng.randint(-2 ** 31, 2 ** 31 - 1, (2, 3)).astype(np.int32),
        "step": np.int32(seed),
    }

    def side(node, port):
        if isinstance(node, dict):
            return {k: side(v, port) for k, v in node.items()}
        if isinstance(node, list):
            return [side(v, port) for v in node]
        if isinstance(node, tuple):  # ("bf16", uint16 bits)
            bits = node[1]
            return (torch.from_numpy(bits.view(np.int16).copy())
                    .view(torch.bfloat16) if port
                    else bits.view(ml_dtypes.bfloat16))
        return torch.from_numpy(np.array(node)) if port else node

    return side(raw, False), side(raw, True)


def _bits(x):
    """(dtype name, shape, bytes) of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return name, tuple(t.shape), raw.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, np.ascontiguousarray(a).tobytes()


def _assert_same(jax_tree, port_tree):
    want = {k: _bits(v) for k, v in jckpt._flatten(jax_tree)[0].items()}
    got = {k: _bits(v) for k, v in tckpt._flatten(port_tree)}
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.fixture(params=["local", "gcs"])
def two_fs(request, tmp_path):
    """(base, JAX package's FileSystem, port's FileSystem) on each
    backend: local disk and the JAX package's fake GCS server (a flat
    object namespace, no rename)."""
    if request.param == "local":
        from edl_tpu.runtime.fs import LocalFS as JaxLocalFS
        yield str(tmp_path), JaxLocalFS(), LocalFS()
    else:
        from edl_tpu.tools.fake_gcs import FakeGCSServer
        with FakeGCSServer() as srv:
            yield ("gs://ckpt-bucket/job/ckpt", JaxGCSFS(endpoint=srv.endpoint),
                   GCSFS(endpoint=srv.endpoint))


@pytest.mark.parametrize("layout", ["dense", "stream"])
def test_jax_writes_port_restores(two_fs, layout):
    base, jfs, tfs = two_fs
    jtree, ttree = _trees(3)
    jcm = jckpt.CheckpointManager(base, fs=jfs)
    if layout == "dense":
        jcm.save(3, jtree, meta={"epoch": 1})
    else:
        jcm.save_async(3, jtree, meta={"epoch": 1}).result(60)
    jcm.close()
    tcm = tckpt.CheckpointManager(base, fs=tfs)
    assert tcm.versions() == [3]
    version, restored, meta = tcm.restore_latest(target=ttree)
    assert version == 3 and meta == {"epoch": 1}
    _assert_same(jtree, restored)
    # the structure follows the target: lists stay lists
    assert isinstance(restored["opt"], list)
    # without a target: a nested dict of CPU tensors, lists keyed "0", "1"
    _, plain, _ = tcm.restore(3)
    assert plain["opt"]["1"]["trace"]["1"].dtype == torch.bfloat16
    _assert_same(jtree["opt"][1]["trace"][1], plain["opt"]["1"]["trace"]["1"])
    tcm.close()


@pytest.mark.parametrize("layout", ["dense", "stream"])
def test_port_writes_jax_restores_same_keys_and_crcs(two_fs, layout):
    base, jfs, tfs = two_fs
    jtree, ttree = _trees(5)
    tcm = tckpt.CheckpointManager(base, fs=tfs)
    jcm = jckpt.CheckpointManager(base, fs=jfs)
    if layout == "dense":
        tcm.save(5, ttree, meta={"by": "port"})
        jcm.save(6, jtree, meta={"by": "port"})
    else:
        tcm.save_async(5, ttree, meta={"by": "port"}).result(60)
        jcm.save_async(6, jtree, meta={"by": "port"}).result(60)
    version, restored, meta = jcm.restore(5, target=jtree)
    assert meta == {"by": "port"}
    _assert_same(restored, ttree)
    assert restored["params"]["emb"].dtype == ml_dtypes.bfloat16

    def load(version, name):
        with jfs.open("%s/v_%08d/%s" % (base, version, name), "r") as f:
            return json.load(f)

    # the same meta.json (dtype tags) as the JAX package writes
    assert load(5, "meta.json") == load(6, "meta.json")
    port_man, jax_man = load(5, "MANIFEST"), load(6, "MANIFEST")
    if layout == "stream":
        # the same entry table: keys, file numbering, dtypes, shapes,
        # crcs and chunk crcs
        assert port_man["entries"] == jax_man["entries"]
        assert port_man["nbytes"] == jax_man["nbytes"]
    else:
        # the npz carries a zip timestamp, so the whole-file crc is
        # each save's own: it must verify, and the members agree
        import io
        import zlib
        with jfs.open("%s/v_%08d/arrays.npz" % (base, 5), "rb") as f:
            payload = f.read()
        assert zlib.crc32(payload) == port_man["crc"]
        assert port_man["nbytes"] == len(payload)
        npz = np.load(io.BytesIO(payload))
        assert sorted(npz.files) == sorted(jckpt._flatten(jtree)[0])
        assert npz["params/emb"].dtype == np.uint16
    jcm.close()
    tcm.close()


def _sharded_jax_tree(seed):
    """A train-state-shaped tree over the 8-device CPU mesh: dp-sharded,
    replicated, bf16 and host leaves (tests/test_checkpoint.py's)."""
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    rng = np.random.RandomState(seed)
    w = rng.randn(16, 4).astype(np.float32)
    mu = rng.randn(16, 4).astype(np.float32)
    bf = rng.randn(8, 2).astype(np.float32).astype(ml_dtypes.bfloat16)
    tree = {"params": {"w": jax.device_put(w, NamedSharding(mesh, P()))},
            "opt": {"mu": jax.device_put(mu, NamedSharding(mesh, P("dp")))},
            "bf16": jax.device_put(bf, NamedSharding(mesh, P("dp"))),
            "step": np.int32(seed)}
    host = {"params": {"w": w}, "opt": {"mu": mu}, "bf16": bf,
            "step": np.int32(seed)}
    return tree, host


@pytest.mark.parametrize("layout", ["npz", "stream"])
def test_jax_sharded_two_ranks_restores_whole_in_port(tmp_path, layout):
    base = str(tmp_path)
    tree, host = _sharded_jax_tree(9)
    cm0, cm1 = jckpt.CheckpointManager(base), jckpt.CheckpointManager(base)
    errs = []

    def rank1():
        try:
            if layout == "npz":
                cm1.save_sharded(9, {}, rank=1, nranks=2)
            else:
                cm1.save_sharded_async(9, {}, rank=1, nranks=2).result(60)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=rank1)
    t.start()
    if layout == "npz":
        cm0.save_sharded(9, tree, meta={"k": 1}, rank=0, nranks=2)
    else:
        cm0.save_sharded_async(9, tree, meta={"k": 1}, rank=0,
                               nranks=2).result(60)
    t.join(timeout=60)
    assert not t.is_alive() and not errs, errs
    with open(base + "/v_00000009/MANIFEST") as f:
        manifest = json.load(f)
    assert manifest["sharded"] and manifest["ranks"] == 2
    # the port's target: tensors of the shapes and dtypes to fill
    target = {"params": {"w": torch.zeros(16, 4)},
              "opt": {"mu": torch.zeros(16, 4)},
              "bf16": torch.zeros(8, 2, dtype=torch.bfloat16),
              "step": torch.zeros((), dtype=torch.int32)}
    tcm = tckpt.CheckpointManager(base)
    version, restored, meta = tcm.restore_latest(target=target)
    assert version == 9 and meta == {"k": 1}
    _assert_same(host, restored)
    # a target the rank files do not cover is MissingKeysError
    with pytest.raises(tckpt.MissingKeysError) as err:
        tcm.restore(9, target=dict(target, extra=torch.zeros(2)))
    assert err.value.keys == {"extra"}
    cm0.close(), cm1.close(), tcm.close()


def test_manifest_last_skips_and_cleans(tmp_path):
    base = str(tmp_path)
    cm = tckpt.CheckpointManager(base, keep=5)
    _, t1 = _trees(1)
    _, t2 = _trees(2)
    cm.save(1, t1)
    cm.save_async(2, t2).result(60)
    # a crashed attempt: data but no MANIFEST
    cm.save(3, t2)
    (tmp_path / "v_00000003" / "MANIFEST").unlink()
    assert cm.versions() == [1, 2]
    assert cm.restore_latest(target=t1)[0] == 2
    assert cm.clean_uncommitted() == ["v_00000003"]
    assert not (tmp_path / "v_00000003").exists()
    # a bad crc in the newest stream entry: skipped, the older dense one
    # restores
    entry = tmp_path / "v_00000002" / "a0000.bin"
    data = bytearray(entry.read_bytes())
    data[0] ^= 0xFF
    entry.write_bytes(bytes(data))
    with pytest.raises(IOError, match="checksum"):
        cm.restore(2, target=t2)
    version, restored, _ = cm.restore_latest(target=t1)
    assert version == 1
    _assert_same(_trees(1)[0], restored)
    # and a bad crc in a dense npz
    npz = tmp_path / "v_00000001" / "arrays.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF
    npz.write_bytes(bytes(data))
    assert cm.restore_latest(target=t1) is None
    cm.close()


def test_missing_keys_error(tmp_path):
    cm = tckpt.CheckpointManager(str(tmp_path))
    _, tree = _trees(4)
    cm.save(4, tree)
    with pytest.raises(tckpt.MissingKeysError) as err:
        cm.restore(4, target=dict(tree, extra={"pos": torch.zeros(())}))
    assert err.value.keys == {"extra/pos"}
    assert isinstance(err.value, IOError)


def test_save_async_keeps_the_snapshot(tmp_path):
    """The caller's state replaced and its tensors changed in place
    right after save_async: the committed version is the snapshot. The
    next save reuses the pooled buffers after draining."""
    cm = tckpt.CheckpointManager(str(tmp_path), keep=5)
    jtree, tree = _trees(6)
    handle = cm.save_async(6, tree)
    for _, leaf in tckpt._flatten(tree):
        leaf.add_(1) if leaf.dtype != torch.bool else None
    tree = {"replaced": torch.ones(3)}
    assert handle.result(60).endswith("v_00000006")
    assert handle.blocked_s > 0 and handle.persist_s > 0
    j7, t7 = _trees(7)
    cm.save_async(7, t7).result(60)
    _, tree6, _ = cm.restore(6, target=_trees(6)[1])
    _assert_same(jtree, tree6)
    _, tree7, _ = cm.restore(7, target=t7)
    _assert_same(j7, tree7)
    cm.close()


def test_port_restore_places_on_the_target_device(tmp_path):
    cm = tckpt.CheckpointManager(str(tmp_path))
    _, tree = _trees(8)
    cm.save(8, tree)
    target = tckpt._unflatten(tree, {k: torch.empty(0, device="meta")
                                     for k, _ in tckpt._flatten(tree)})
    _, restored, _ = cm.restore(8, target=target)
    assert all(t.device.type == "meta"
               for _, t in tckpt._flatten(restored))
    with pytest.raises(NotImplementedError, match="A12"):
        cm.save_sharded(9, tree)
    with pytest.raises(NotImplementedError, match="A12"):
        cm.restore_placed(8, tree, None)


def test_ckpt_bench_round_trip_on_cpu(tmp_path):
    out = ckpt_bench.run(tree_mb=0.5, repeats=1, device="cpu",
                         directory=str(tmp_path))
    assert out["schema"] == "ckpt_bench/v1" and out["roundtrip_ok"]
    assert out["async"]["blocked_ms"] > 0 and out["sync"]["wall_ms"] > 0
