"""The port's ResNet input side, bench loop and teacher on the CPU, held
against the JAX package's.

- ``data/prefetch.py``: the cases of tests/test_prefetch.py on
  ``device="cpu"`` (order and content, transform, error surfacing with
  the pump's traceback chained, close, the iterator contract, stats),
  and the queue-depth gauge;
- ``data/input_pipeline.py``: ``synthetic_pipeline`` byte for byte
  against the JAX package's, ``list_image_files`` on the same tree,
  ``image_folder_pipeline`` refused;
- ``bench.py``: ``run`` on the CPU at 32 px, batch 2 (the device and
  host feeds, ``steps_per_call``): the JAX bench's metric names and
  units, ``vs_baseline`` over 228.5 img/s; the CLI's refusals and
  ``run``'s;
- ``resnet_teacher(params=, batch_stats=)``: served logits against the
  port's model and the JAX package's on the same flax trees (bf16:
  within 2^-6 of the logits' magnitude), probs rows summing to 1,
  driven by the JAX package's ``RpcClient``.
"""

import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.data import input_pipeline as jpipe
from edl_tpu.models import resnet as jresnet
from edl_tpu.rpc.client import RpcClient as JaxRpcClient
from edl_tpu_torch import bench
from edl_tpu_torch.data import input_pipeline as tpipe
from edl_tpu_torch.data.prefetch import DevicePrefetcher
from edl_tpu_torch.distill import teacher_server as tts
from edl_tpu_torch.models import resnet as tresnet
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.serve.admission import AdmissionController

TEACHER_TOL = 2.0 ** -6
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run faster on one thread, and the driver's run
    shares the cores among six workers: intra-op threads there only
    oversubscribe them. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(n, d=4):
    for i in range(n):
        yield {"x": np.full((8, d), i, np.float32),
               "i": np.full((8,), i, np.int32)}


def test_prefetch_order_and_content():
    with DevicePrefetcher(_batches(7), "cpu", size=3) as it:
        out = list(it)
    assert [int(b["i"][0]) for b in out] == list(range(7))
    assert isinstance(out[0]["x"], torch.Tensor)
    assert out[0]["x"].device.type == "cpu"
    assert out[3]["i"].dtype == torch.int32


def test_prefetch_transform_and_nesting():
    it = DevicePrefetcher(
        ({"x": b["x"], "pair": (b["i"], [b["x"]])} for b in _batches(3)),
        "cpu", size=2,
        transform=lambda b: dict(b, x=torch.from_numpy(b["x"] * 2.0).to(
            torch.bfloat16)))
    out = list(it)
    assert float(out[1]["x"][0, 0]) == 2.0
    assert out[1]["x"].dtype == torch.bfloat16
    assert isinstance(out[2]["pair"], tuple)
    assert int(out[2]["pair"][0][0]) == 2


def test_prefetch_surfaces_producer_error():
    def boom():
        yield {"x": np.zeros((8, 4), np.float32)}
        raise RuntimeError("producer died")

    it = DevicePrefetcher(boom(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)


def test_prefetch_close_unblocks_producer():
    produced = []

    def infinite():
        for i in itertools.count():
            produced.append(i)
            yield {"x": np.zeros((8, 4), np.float32)}

    it = DevicePrefetcher(infinite(), "cpu", size=2)
    next(it)
    it.close()  # must not hang; the producer parks on a bounded queue
    assert len(produced) < 10


def test_prefetch_iterator_contract_after_exhaustion_and_close():
    it = DevicePrefetcher(_batches(2), "cpu")
    assert len(list(it)) == 2
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(it)       # repeated next() keeps raising, never hangs
    it2 = DevicePrefetcher(_batches(5), "cpu")
    next(it2)
    it2.close()
    with pytest.raises(StopIteration):
        next(it2)          # closed: StopIteration, not a blocked get()


def test_prefetch_feeds_training_loop():
    w = torch.zeros(4)
    with DevicePrefetcher(_batches(5), "cpu", size=2) as it:
        for batch in it:
            w = w + batch["x"].mean(0)
    torch.testing.assert_close(w, torch.full((4,), 10.0))


def test_prefetch_pump_error_chained_with_original_traceback():
    class FeedError(ValueError):
        pass

    def boom():
        yield {"x": np.zeros((8, 2), np.float32)}
        raise FeedError("bad shard spec")

    it = DevicePrefetcher(boom(), "cpu")
    next(it)
    with pytest.raises(FeedError) as ei:
        next(it)
    assert ei.value.args == ("bad shard spec",)
    cause = ei.value.__cause__
    assert isinstance(cause, FeedError) and cause is not ei.value
    frames, tb = [], cause.__traceback__
    while tb is not None:
        frames.append(tb.tb_frame.f_code.co_name)
        tb = tb.tb_next
    assert "boom" in frames  # the producer's frame survived the hop
    it.close()


def test_prefetch_pump_error_exotic_signature_wrapped():
    class Picky(Exception):
        def __init__(self, *, code):
            super().__init__("code=%d" % code)
            self.code = code

    def boom():
        if False:
            yield
        raise Picky(code=7)

    it = DevicePrefetcher(boom(), "cpu")
    with pytest.raises(RuntimeError, match="device prefetch pump") as ei:
        next(it)
    assert isinstance(ei.value.__cause__, Picky)
    assert ei.value.__cause__.code == 7
    it.close()


def test_prefetch_close_is_idempotent_and_joins():
    def slow_infinite():
        for i in itertools.count():
            time.sleep(0.01)
            yield {"x": np.full((8, 2), i, np.float32)}

    it = DevicePrefetcher(slow_infinite(), "cpu", size=2)
    next(it)
    it.close()
    assert not it._thread.is_alive()
    it.close()
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_stats_overlap_accounting_and_gauge():
    def slow_batches(n):
        for i in range(n):
            time.sleep(0.02)
            yield {"x": np.full((8, 4), i, np.float32)}

    with DevicePrefetcher(slow_batches(5), "cpu", size=2) as it:
        assert len(list(it)) == 5
        s = it.stats()
    assert s["batches"] == 5
    assert s["pump_wait_s"] >= 5 * 0.02 * 0.8  # the host iterator was slow
    assert s["consumer_wait_s"] >= 0.0
    families = obs_metrics.REGISTRY.families()
    assert "edl_prefetch_queue_depth" in families
    assert "edl_prefetch_batches" in families


def test_prefetch_and_bench_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(_batches(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.resnet_teacher()


def test_synthetic_pipeline_matches_jax_byte_for_byte():
    got = tpipe.synthetic_pipeline(3, image_size=8, num_classes=10, steps=3,
                                   seed=2)
    want = jpipe.synthetic_pipeline(3, image_size=8, num_classes=10,
                                    steps=3, seed=2)
    pairs = list(zip(got, want))
    assert len(pairs) == 3
    for g, w in pairs:
        for key in ("image", "label"):
            assert g[key].dtype == w[key].dtype
            assert g[key].tobytes() == w[key].tobytes()


def test_list_image_files_matches_jax_and_folder_pipeline_refused(tmp_path):
    for cls, names in (("b_dog", ["2.JPG", "1.png", "x.txt"]),
                       ("a_cat", ["z.jpeg"])):
        os.makedirs(tmp_path / cls)
        for name in names:
            (tmp_path / cls / name).write_bytes(b"")
    (tmp_path / "stray.jpg").write_bytes(b"")
    assert tpipe.list_image_files(str(tmp_path)) == \
        jpipe.list_image_files(str(tmp_path))
    files, classes = tpipe.list_image_files(str(tmp_path))
    assert classes == ["a_cat", "b_dog"] and len(files) == 3
    with pytest.raises(NotImplementedError, match="A18"):
        tpipe.image_folder_pipeline(str(tmp_path), 2)


def test_bench_run_schema_on_cpu(monkeypatch):
    """The ResNet loop end to end at 32 px, batch 2 (ResNet50_vd's depth
    at narrow widths, to keep it quick), K = 2 steps per call on the
    device feed, then the host feed: the JAX bench's metric names, units
    and baseline."""
    narrow = dict(stage_filters=(8, 16, 32, 64))
    for name in ("create_model_and_loss", "flops_per_image"):
        fn = getattr(tresnet, name)
        monkeypatch.setattr(tresnet, name,
                            lambda *a, _fn=fn, **kw: _fn(*a, **kw, **narrow))
    stats = {}
    out = bench.run(batch_per_chip=2, image_size=32, warmup=1, iters=1,
                    steps_per_call=2, device="cpu", stats=stats)
    assert out["metric"] == \
        "resnet50_vd_train_imgs_per_sec_per_chip_scan2_b2"
    assert out["unit"] == "img/s/chip"
    # from the unrounded rate, as the JAX bench divides it
    assert out["vs_baseline"] == round(stats["imgs_per_s"] / 228.5, 3)
    assert out["value"] == round(stats["imgs_per_s"], 1)
    # warm-up, probe and timed calls, two steps each
    assert len(stats["losses"]) == 6 and np.isfinite(stats["losses"]).all()
    assert stats["flops_per_image"] == 3 * tresnet.flops_per_image(
        32, depth=50, vd=True, space_to_depth=True)
    assert stats["prefetch"] is None and stats["peak_bytes"] is None
    stats = {}
    out = bench.run(batch_per_chip=2, image_size=32, warmup=1, iters=1,
                    feed="host", device="cpu", stats=stats)
    assert out["metric"] == \
        "resnet50_vd_train_imgs_per_sec_per_chip_hostfed_b2"
    assert stats["prefetch"]["batches"] >= 2
    assert np.isfinite(stats["losses"]).all()


def test_flops_per_image_counts_convs_and_head():
    """ResNet50_vd at 224: 4.34 G multiply-adds forward (the published
    ResNet50-vd count), 2 FLOPs each; the s2d stem adds its zero taps."""
    plain = tresnet.flops_per_image(224, depth=50, vd=True)
    s2d = tresnet.flops_per_image(224, depth=50, vd=True,
                                  space_to_depth=True)
    assert 8.6e9 < plain < 8.7e9
    # stem1: 112 x 112 x 32 outputs, 27 taps plain, 48 with s2d
    assert s2d - plain == 2 * 112 * 112 * 32 * (48 - 27)


@pytest.mark.parametrize("argv,match", [
    (["--bn_stats_every", "16"], "stats batch of 8"),
    (["--bn_stats_every", "0"], "must be >= 1"),
    (["--batch_per_chip", "32", "--bn_stats_every", "4"], "stats batch of 8"),
    (["--steps_per_call", "0"], "must be >= 1"),
])
def test_bench_cli_refusals(argv, match, capsys):
    with pytest.raises(SystemExit):
        bench.main(argv)
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("argv,error,match", [
    (["--feed", "native"], NotImplementedError, "A18"),
    (["--feed", "host", "--steps_per_call", "2"], ValueError,
     "pure device rate"),
])
def test_bench_run_refuses_before_any_device(argv, error, match,
                                             monkeypatch):
    """``run`` refuses these (the CLI passes them through), before it
    looks for a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        bench.main(argv)


def test_bench_cli_defaults_to_resnet_and_native_feed_raises():
    args = bench._build_parser().parse_args([])
    assert args.model == "resnet" and args.s2d and args.feed == "device"
    with pytest.raises(NotImplementedError, match="A18"):
        bench.main(["--feed", "native", "--device", "cpu"])


def _teacher_trees(model, seed):
    """Flax trees (``params``, ``batch_stats``) for the port's ``model``,
    as a trained JAX model holds them (conv kernels HWIO): values from
    numpy, lecun-scaled kernels, BN scales in [0.8, 1.2] but [0.1, 0.3]
    on each residual branch's last norm, small biases and means,
    variances in [0.5, 1.5], so that every layer is live."""
    rng = np.random.RandomState(seed)

    def put(root, name, arr):
        *path, leaf = name.split(".")
        for key in path:
            root = root.setdefault(key, {})
        root[leaf] = arr.astype(np.float32)

    tree, stats_tree = {}, {}
    for name, val in model.state_dict().items():
        shape = tuple(val.shape)
        if name.endswith("kernel"):
            shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape
            arr = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("scale"):
            last = name.startswith("stage") and ".bn2." in name
            arr = rng.uniform(*((0.1, 0.3) if last else (0.8, 1.2)), shape)
        else:
            arr = rng.randn(*shape) * 0.1
        put(tree, name, arr)
    for name, val in tresnet.init_batch_stats(model).items():
        arr = rng.uniform(0.5, 1.5, val.shape) if name.endswith("var") \
            else rng.randn(*val.shape) * 0.1
        put(stats_tree, name, arr)
    return tree, stats_tree


def _teacher_jax_logits(tree, stats_tree, x):
    """The JAX package's ResNet18_vd (bf16) on the flax trees, fed bf16
    as its teacher feeds it."""
    jmodel = jresnet.ResNet(depth=18, num_classes=10, vd=True,
                            dtype=jnp.bfloat16)
    args = ({"params": tree, "batch_stats": stats_tree},
            x.astype(jnp.bfloat16))
    infer = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    return np.asarray(infer.lower(*args).compile(FAST_COMPILE)(*args),
                      np.float64)


@pytest.fixture(autouse=True, scope="module")
def teacher_case():
    """The teacher test's trees and images, and its JAX logits (~2 s to
    trace and compile), started on a thread with the module: the test
    comes last, and the others run meanwhile."""
    model = tresnet.ResNet(depth=18, num_classes=10, vd=True,
                           dtype=torch.bfloat16, device="cpu")
    tree, stats_tree = _teacher_trees(model, seed=1)
    x = np.random.RandomState(0).randn(5, 32, 32, 3).astype(np.float32)
    with ThreadPoolExecutor(1) as pool:
        yield model, tree, stats_tree, x, pool.submit(
            _teacher_jax_logits, tree, stats_tree, x)


def test_resnet_teacher_serves_the_model(monkeypatch, teacher_case):
    """``resnet_teacher`` (ResNet18_vd, 10 classes, 32 px) serving a flax
    tree, driven by the JAX package's client (the wire is the same).
    Each row's logits are held, within 2^-6 of the logits' magnitude,
    against the port's model with the same tree (the server batches rows
    with other requests and zero padding, which may change the conv's
    order of summation) and against the JAX package's model applied to
    the same trees, fed bf16 as its teacher feeds it (two bf16 forwards
    that round at different points: 4.8e-3 apart here, 2.4 bf16 ulps of
    the largest logit)."""
    monkeypatch.setenv("EDL_TPU_DISABLE_UDS", "1")
    model, tree, stats_tree, x, jax_logits = teacher_case
    state, stats = tresnet.params_from_flax(tree, stats_tree)
    model.load_state_dict(state)
    with torch.no_grad():
        want = model(torch.from_numpy(x), stats)[0].numpy()
    server = tts.resnet_teacher(
        depth=18, num_classes=10, image_size=32, max_batch=4,
        host="127.0.0.1", params=tree, batch_stats=stats_tree,
        device="cpu", admission=AdmissionController(slo_ms=None)).start()
    client = JaxRpcClient(server.endpoint)
    try:
        assert client.call("get_feed_fetch")["feed"] == {
            "image": [[32, 32, 3], "<f4"]}
        futs = [client.call_async("predict", {"image": x[:2]}),
                client.call_async("predict", {"image": x[2:5]})]
        got = [f.result(timeout=120) for f in futs]
    finally:
        client.close()
        server.stop()
    logits = np.concatenate([g["logits"] for g in got])
    probs = np.concatenate([g["probs"] for g in got])
    assert logits.shape == (5, 10) and logits.dtype == np.float32
    np.testing.assert_allclose(
        logits, want, rtol=0,
        atol=TEACHER_TOL * max(1.0, float(np.abs(want).max())))
    jax_logits = jax_logits.result()
    np.testing.assert_allclose(
        logits, jax_logits, rtol=0,
        atol=TEACHER_TOL * max(1.0, float(np.abs(jax_logits).max())))
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        probs, torch.softmax(torch.from_numpy(logits), -1).numpy(),
        atol=1e-6)
