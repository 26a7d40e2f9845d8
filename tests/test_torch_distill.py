"""The port's distillation examples and tools, against the JAX package's.

- ``gpt_distill``'s loss ((1-w) hard next-token CE + w soft CE against
  the teacher's probs) on a flax ``Gpt`` tree converted by
  ``params_from_flax``: loss and gradients against the same expression
  built from optax in JAX, f32, within 1e-4 of each tensor's largest
  magnitude (tests/test_torch_train_step.py's tolerance);
- ``resnet_distill``'s loss (hard CE + soft CE against the softmaxed
  teacher logits, BN statistics as the aux) at narrow ResNet18 widths,
  both sides in f64 within 1e-6 (tests/test_torch_resnet.py's); the JAX
  side compiles on a thread started with the module;
- ``mnist_distill``: ``synth_digits`` byte-equal to the reference's, the
  MLP's flax initialisers, and its forward, loss and gradients against
  flax's ``Mlp`` and optax at 1e-5 (f32); the whole example runs on the
  card (chip_smoke.py);
- ``gpt_distill.main`` and ``resnet_distill.main`` at their defaults on
  ``--device cpu`` against in-process teachers: exit 0 and the final
  JSON line;
- ``distill_bench.run(model="linear")`` held to the schema and the
  byte-identity gate of tests/test_bench_guard.py, ``model="gpt"`` to
  byte identity on the CPU, ``distill_qps.run`` to its output.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import gpt as jgpt
from edl_tpu.models import resnet as jresnet
from examples.distill import mnist_distill as j_mnist
from edl_tpu_torch.distill.teacher_server import TeacherServer, gpt_teacher
from edl_tpu_torch.examples.distill import gpt_distill, mnist_distill, \
    resnet_distill
from edl_tpu_torch.models import gpt as tgpt
from edl_tpu_torch.models import resnet as tresnet
from edl_tpu_torch.runtime import trainer as ttrainer
from edl_tpu_torch.tools import distill_bench, distill_qps

from _torch_threads import _one_torch_thread  # noqa: F401


TOL = 1e-4
F64_TOL = 1e-6
MLP_TOL = 1e-5
W = 0.5
GPT = dict(num_layers=2, d_model=64, num_heads=4, mlp_dim=128,
           vocab_size=64, max_len=16)
SEQ, BATCH = 16, 4
RESNET = dict(depth=18, num_classes=10, vd=True,
              stage_filters=(4, 8, 8, 8))
IMAGE = 32
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _close(got, want, tol, what):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = prefix + k
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _soft_probs(shape, seed):
    logits = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# -- the JAX references, started with the module ---------------------------

def _gpt_reference():
    """flax tree, batch, and the JAX loss and gradients of the
    reference example's expression (examples/distill/gpt_distill.py)."""
    model = jgpt.Gpt(dtype=jnp.float32, **GPT)
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"])()
    batch = {"input_ids": jgpt.synthetic_lm_batch(
        BATCH, SEQ, GPT["vocab_size"], seed=3)["input_ids"],
        "soft_label": _soft_probs((BATCH, SEQ, GPT["vocab_size"]), 4)}

    def loss_fn(params, batch):
        ids = batch["input_ids"]
        logits = model.apply({"params": params}, ids)
        hard = optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], ids[:, 1:]).mean()
        tprobs = batch["soft_label"].astype(jnp.float32)[:, :-1]
        soft = optax.softmax_cross_entropy(logits[:, :-1], tprobs).mean()
        return (1 - W) * hard + W * soft

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    return jax.device_get((params, batch, loss, grads))


def _resnet_reference(tree, batch):
    """The JAX loss, gradients and updated statistics of the reference
    example's ResNet expression (examples/distill/resnet_distill.py),
    in f64."""
    classes = RESNET["num_classes"]
    with jax.enable_x64(True):
        model = jresnet.ResNet(dtype=jnp.float64, **RESNET)

        def loss_fn(params, extra, batch):
            logits, updated = model.apply(
                {"params": params, "batch_stats": extra["batch_stats"]},
                batch["image"], train=True, mutable=["batch_stats"])
            one_hot = jax.nn.one_hot(batch["label"], classes)
            hard = optax.softmax_cross_entropy(logits, one_hot).mean()
            teacher_probs = jax.nn.softmax(
                batch["soft_label"].astype(jnp.float64), axis=-1)
            soft = optax.softmax_cross_entropy(logits, teacher_probs).mean()
            return (1 - W) * hard + W * soft, updated["batch_stats"]

        @jax.jit
        def reference(variables, batch):
            v = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                       variables)
            b = dict(batch, image=batch["image"].astype(jnp.float64),
                     soft_label=batch["soft_label"].astype(jnp.float64))
            (loss, stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(v["params"],
                                       {"batch_stats": v["batch_stats"]}, b)
            return loss, grads, stats

        return jax.device_get(reference.lower(tree, batch).compile(
            FAST_COMPILE)(tree, batch))


def _resnet_case():
    """The port's f32 init at RESNET widths with every BN scale drawn
    from [0.5, 1.5] (flax starts each block's last one at 0, which would
    leave the branch convs' gradients zero), its flax tree, a batch."""
    model, params, extra, _ = tresnet.create_model_and_loss(
        dtype=torch.float32, device="cpu", seed=0, **RESNET)
    rng = np.random.RandomState(5)
    for name, p in params.items():
        if name.endswith(".scale"):
            p.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, p.shape).astype(np.float32)))
    tree = {"params": _to_flax(params),
            "batch_stats": _to_flax(extra["batch_stats"])}
    batch = {"image": rng.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32),
             "label": rng.randint(0, RESNET["num_classes"], BATCH)
             .astype(np.int32),
             "soft_label": rng.randn(BATCH, RESNET["num_classes"])
             .astype(np.float32)}
    return params, extra, tree, batch


def _to_flax(flat):
    """The port's flat tensors as a flax tree (conv OIHW -> HWIO)."""
    tree = {}
    for name, val in flat.items():
        arr = val.detach().float().numpy()
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
    return tree


@pytest.fixture(autouse=True, scope="module")
def _references_started():
    """The JAX references compile outside the GIL on threads started
    with the module (``jax.enable_x64`` is thread-local); the tests
    that need them come last."""
    case = _resnet_case()
    with ThreadPoolExecutor(2) as pool:
        yield {"gpt": pool.submit(_gpt_reference),
               "resnet": (case, pool.submit(_resnet_reference, *case[2:]))}


# -- mnist_distill's pieces ------------------------------------------------

def test_mnist_synth_digits_byte_equal():
    for n, seed in ((64, 0), (64, 10_017), (512, 999)):
        got, want = mnist_distill.synth_digits(n, seed), \
            j_mnist.synth_digits(n, seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


def test_mnist_mlp_initialisers_are_flax_defaults():
    model, params = mnist_distill.make_mlp(256, seed=0, device="cpu")
    from flax import linen as nn

    class Mlp(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = x.reshape((x.shape[0], -1))
            x = nn.relu(nn.Dense(256)(x))
            return nn.Dense(10)(x)

    shapes = jax.eval_shape(lambda: Mlp().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1))))["params"]
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "%s.%s" % (mod, leaf): tuple(v.shape)
        for mod, leaves in shapes.items() for leaf, v in leaves.items()}
    for name, p in params.items():
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        std = (1.0 / p.shape[0]) ** 0.5  # lecun normal: variance 1/fan_in
        assert float(p.abs().max()) <= 2 * std / 0.87962566103423978
        assert abs(float(p.std()) / std - 1) < 0.05, name


def test_mnist_loss_and_grads_match_flax():
    model, params = mnist_distill.make_mlp(32, seed=1, device="cpu")
    from flax import linen as nn

    class Mlp(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = x.reshape((x.shape[0], -1))
            x = nn.relu(nn.Dense(32)(x))
            return nn.Dense(10)(x)

    imgs, labels = mnist_distill.synth_digits(16, seed=7)
    soft = np.random.RandomState(8).randn(16, 10).astype(np.float32)
    tree = {}
    for name, p in params.items():
        mod, leaf = name.split(".")
        tree.setdefault(mod, {})[leaf] = p.numpy()

    def j_loss(p):
        logits = Mlp().apply({"params": p}, imgs)
        hard = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        soft_targets = jax.nn.softmax(soft, -1)
        return 0.3 * hard + 0.7 * optax.softmax_cross_entropy(
            logits, soft_targets).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(j_loss))(tree)

    def t_loss(p):
        logits = torch.func.functional_call(model, p,
                                            (torch.from_numpy(imgs),))
        return mnist_distill.distill_loss(
            logits, torch.from_numpy(labels), torch.from_numpy(soft), 0.7)

    loss, _, grads = ttrainer._value_and_grad(t_loss, params, False)
    _close(loss, want_loss, MLP_TOL, "loss")
    for name, g in _flat(jax.device_get(want_grads)).items():
        _close(grads[name], g, MLP_TOL, name)


# -- the examples' main() and the tools, on the CPU -------------------------

def test_gpt_distill_main_cpu(capsys):
    # admission off: the default SLO sheds a pipelined reader's bursts on
    # a CPU, and each shed backs the reader off for seconds
    teacher = gpt_teacher(vocab_size=64, seq_len=16, max_batch=8,
                          host="127.0.0.1", device="cpu",
                          admission=False).start()
    try:
        rc = gpt_distill.main(["--device", "cpu", "--teachers",
                               teacher.endpoint])
    finally:
        teacher.stop()
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 8 and np.isfinite(out["final_loss"])


def test_resnet_distill_main_cpu(capsys):
    def teacher_fn(feed):
        # a deterministic "teacher": logits from the channel means
        base = feed["image"].mean(axis=(1, 2, 3))
        return {"logits": np.stack([base * (i + 1) for i in range(10)],
                                   axis=1).astype(np.float32)}

    teacher = TeacherServer(
        teacher_fn, {"image": ([32, 32, 3], "<f4")},
        {"logits": ([10], "<f4")}, max_batch=16, host="127.0.0.1",
        admission=False).start()
    try:
        rc = resnet_distill.main(["--device", "cpu", "--teachers",
                                  teacher.endpoint])
    finally:
        teacher.stop()
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 8 and np.isfinite(out["final_loss"])


def test_distill_bench_linear_schema_and_identity():
    """tests/test_bench_guard.py's distill_bench gate on the port."""
    out = distill_bench.run(model="linear", students=2, batches=6,
                            batch_size=4, feed_dim=16, fetch_dim=16,
                            max_batch=8, depth=3)
    assert out["schema"] == "distill_bench/v1"
    assert out["identical_ok"] is True
    for mode in ("serial", "pipelined"):
        assert out[mode]["wall_ms"] > 0
        assert out[mode]["predicts_s"] > 0
        assert out[mode]["goodput_mb_s"] > 0
        assert out[mode]["device_batches"] > 0
        assert 0 < out[mode]["occupancy_pct"] <= 100
    assert out["speedup_predicts_s"] > 0
    json.dumps(out)


def test_distill_bench_gpt_cpu_identity():
    """``--model gpt`` with the port's gpt_teacher on the CPU: the two
    modes give byte-identical predictions and nothing is shed. (The JAX
    package's bench sheds here: its 1-row warm-up leaves the cold first
    batch as the admission EWMA's per-row estimate.)"""
    out = distill_bench.run(model="gpt", students=2, batches=4,
                            device="cpu")
    assert out["identical_ok"] is True
    assert out["serial"]["device_batches"] > 0
    assert out["pipelined"]["device_batches"] > 0


def test_distill_qps_output():
    out = distill_qps.run(num_teachers=2, batches=20, batch_size=8,
                          feature_dim=16, num_classes=10)
    assert sorted(out) == ["batch_size", "batches", "batches_per_sec",
                           "samples_per_sec", "teachers"]
    assert out["teachers"] == 2 and out["batches"] == 20
    assert out["batch_size"] == 8
    assert out["samples_per_sec"] > 0 and out["batches_per_sec"] > 0
    json.dumps(out)


# -- the losses against the JAX references (last: they wait on them) -------

def test_gpt_distill_loss_and_grads_match_jax(_references_started):
    tree, batch, want_loss, want_grads = \
        _references_started["gpt"].result()
    model = tgpt.Gpt(dtype=torch.float32, device="cpu", **GPT)
    params = tgpt.params_from_flax(tree)
    loss_fn = gpt_distill.make_loss_fn(model, W)
    loss, _, grads = ttrainer._value_and_grad(
        lambda p: loss_fn(p, batch, None), params, False)
    _close(loss, want_loss, TOL, "loss")
    want = tgpt.params_from_flax(want_grads)
    assert set(grads) == set(want)
    for name in grads:
        _close(grads[name], want[name], TOL, name)


def test_resnet_distill_loss_and_grads_match_jax(_references_started):
    (params, extra, tree, batch), fut = _references_started["resnet"]
    want_loss, want_grads, want_stats = fut.result()
    model, _, _, _ = tresnet.create_model_and_loss(
        dtype=torch.float64, device="cpu", **RESNET)
    params = {k: v.double() for k, v in params.items()}
    extra = {"batch_stats": {k: v.double()
                             for k, v in extra["batch_stats"].items()}}
    loss_fn = resnet_distill.make_loss_fn(model, RESNET["num_classes"], W)
    b64 = dict(batch, image=batch["image"].astype(np.float64),
               soft_label=batch["soft_label"].astype(np.float64))
    loss, aux, grads = ttrainer._value_and_grad(
        lambda p: loss_fn(p, extra, b64, None), params, True)
    _close(loss, want_loss, F64_TOL, "loss")
    want_p, want_s = tresnet.params_from_flax(want_grads, want_stats)
    assert set(grads) == set(want_p)
    for name in grads:
        _close(grads[name], want_p[name], F64_TOL, name)
    for name, s in aux["batch_stats"].items():
        _close(s, want_s[name], F64_TOL, name)
