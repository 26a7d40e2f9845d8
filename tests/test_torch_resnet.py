"""Parity of the port's ResNet family (``edl_tpu_torch/models/resnet.py``)
with the JAX package's on the CPU.

The whole model: ``ResNet(depth=50, vd, space_to_depth)`` at
``stage_filters=(8, 16, 32, 64)``, 10 classes, 32x32 images, batch 4,
from one flax param tree (values from numpy with a seed; BN scales
random, so no residual branch starts dead). The eval logits, the
train-mode logits and updated batch statistics, the loss and gradients
of one step, and one ``sgd(0.1, momentum=0.9)`` update (the port's
``make_train_step`` against optax's) are held against the JAX
package's, both sides in f64 (the JAX side under ``jax.enable_x64``,
one jitted function): the same algorithm agrees to 1e-6 relative to
each tensor's largest magnitude (the JAX suite's 1e-5 and 1e-4,
tests/test_resnet.py:43,50, tightened). In bf16 (the dtype the card
trains in) the train logits, the statistics and the loss are held
against the JAX package's bf16 model on the same tree, within twice
the JAX package's own bf16 error, and the eval logits to f64. In f32
this size is badly conditioned (BatchNorm over 4 values in the last
stage amplifies rounding: the port's own f32 gradients sit up to 1.6e-3
from its f64 ones), so the port's f32 run is held to the f64 reference
at 1e-5 on eval logits, 1e-5 relative on the loss and train logits,
1e-5 on statistics and 1e-2 relative Frobenius on each gradient. Run as
a script, the file prints both packages' bf16 gradient against their
f64 one at ResNet50_vd's widths (``bf16_gradient_noise``).

Blocks (f32, the JAX suite's 1e-5 on outputs and statistics, 1e-4 on
gradients, relative to the largest magnitude): ``BasicBlock``, a grouped
ResNeXt ``BottleneckBlock``, an odd input size, ``bn_stats_every=2``
(bf16 is tests/test_torch_batch_norm.py's and the card's).
The vanilla stem (7x7/2, SAME pads (2, 3) at an even size) and the max
pool at 1e-5. Port-only, on a small depth-18 model: ``remat=True``
gives the same loss, gradients and statistics as without (the update
applied once), ``make_multi_step(2)`` equals two steps; the s2d stem
equals the plain one on the same kernel.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

# the repo's root, for ``python tests/test_torch_resnet.py``
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from edl_tpu.models import resnet as jresnet  # noqa: E402
from edl_tpu_torch.models import resnet as tresnet  # noqa: E402
from edl_tpu_torch.runtime import optim as toptim  # noqa: E402
from edl_tpu_torch.runtime import trainer as ttrainer  # noqa: E402

SF = (8, 16, 32, 64)
CLASSES, IMAGE, BATCH = 10, 32, 4
F64_TOL = 1e-6
TOL, GRAD_TOL = 1e-5, 1e-4
F32_LOSS_RTOL, F32_STATS_TOL, F32_GRAD_RFRO = 1e-5, 1e-5, 1e-2
# bf16: the port within BF16_SPREAD times the JAX package's own bf16
# error (floored at one bf16 ulp) of the JAX bf16 value and of f64's
BF16_SPREAD, BF16_ULP = 2.0, 2.0 ** -7
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# a small ResNet for the port-only step checks
SMALL = dict(depth=18, num_classes=CLASSES, vd=True,
             stage_filters=(4, 8, 8, 8), space_to_depth=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run faster on one thread, and the driver's run
    shares the cores among six workers: intra-op threads there only
    oversubscribe them. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fill(shapes, seed):
    """Values for a flax variable tree of ``shapes``: lecun-scaled
    kernels; BN scales in [0.8, 1.2] but [0.1, 0.3] on each residual
    branch's last norm (flax starts it at 0: small, not dead, keeps the
    50 layers well conditioned); small biases and means; variances in
    [0.5, 1.5]."""
    rng = np.random.RandomState(seed)

    def value(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "'bn3'" in name and "scale" in name:
            return rng.uniform(0.1, 0.3, s.shape).astype(np.float32)
        if "scale" in name:
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(value, shapes)


def _flax_shapes(module):
    """The flax variable tree's shapes of the port's ``module`` (a model
    or a block: the same names; conv kernels OIHW -> HWIO), in place of
    a slower ``jax.eval_shape`` of flax's init."""
    tree = {"params": {}, "batch_stats": {}}

    def put(root, name, shape):
        *path, leaf = name.split(".")
        for key in path:
            root = root.setdefault(key, {})
        root[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)

    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        put(tree["params"], name, shape[2:] + shape[1::-1]
            if len(shape) == 4 else shape)
    for name, v in tresnet.init_batch_stats(
            tresnet.name_norms(module)).items():
        put(tree["batch_stats"], name, tuple(v.shape))
    return tree


def _close(got, want, tol, what):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _close_tree(got, want_tree, tol, what, is_stats=False):
    want = (tresnet.params_from_flax({}, want_tree)[1] if is_stats
            else tresnet.params_from_flax(want_tree)[0])
    assert set(got) == set(want), set(got) ^ set(want)
    for name in got:
        _close(got[name], want[name], tol, "%s %s" % (what, name))


def _jax_loss(model, classes=CLASSES):
    """The JAX package's ResNet loss (create_model_and_loss's), for a
    model built at test widths."""
    def loss_fn(params, extra, batch, rng):
        logits, updated = model.apply(
            {"params": params, "batch_stats": extra["batch_stats"]},
            batch["image"], train=True, mutable=["batch_stats"])
        one_hot = optax.smooth_labels(
            jax.nn.one_hot(batch["label"], classes), 0.1)
        loss = optax.softmax_cross_entropy(logits, one_hot).mean()
        return loss, ({"batch_stats": updated["batch_stats"]}, logits)
    return loss_fn


def _case():
    """(model kwargs, flax tree, batch) of the whole-model tests."""
    kw = dict(depth=50, num_classes=CLASSES, vd=True, stage_filters=SF,
              space_to_depth=True)
    tree = _fill(_flax_shapes(tresnet.ResNet(device="meta", **kw)), seed=0)
    rng = np.random.RandomState(1)
    batch = {"image": rng.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32),
             "label": rng.randint(0, CLASSES, BATCH).astype(np.int32)}
    return kw, tree, batch


def _jax_reference_bf16(kw, tree, batch):
    """The JAX package's bf16 model (f32 params and statistics) on the
    same tree and batch: train logits, statistics and loss, in one
    jitted call (its eval forward is held in
    tests/test_torch_resnet_data.py's teacher test)."""
    model = jresnet.ResNet(dtype=jnp.bfloat16, **kw)
    loss_with_logits = _jax_loss(model)

    @jax.jit
    def reference(variables, batch):
        loss, (aux, logits) = loss_with_logits(
            variables["params"], {"batch_stats": variables["batch_stats"]},
            batch, None)
        return logits, aux["batch_stats"], loss

    return jax.device_get(reference.lower(tree, batch).compile(
        FAST_COMPILE)(tree, batch))


def _jax_reference(kw, tree, batch):
    """The JAX package's reference in f64: eval logits, train logits,
    statistics, loss, gradients and one sgd step, in one jitted call.
    Returns (model kwargs, flax tree, batch, results)."""
    with jax.enable_x64(True):
        model = jresnet.ResNet(dtype=jnp.float64, **kw)
        loss_with_logits = _jax_loss(model)
        tx = optax.sgd(0.1, momentum=0.9)

        @jax.jit
        def reference(variables, batch):
            variables = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.float64), variables)
            b64 = dict(batch, image=batch["image"].astype(jnp.float64))
            params = variables["params"]
            extra = {"batch_stats": variables["batch_stats"]}
            logits_eval = model.apply(variables, b64["image"], train=False)
            (loss, (aux, logits)), grads = jax.value_and_grad(
                loss_with_logits, has_aux=True)(params, extra, b64, None)
            updates, opt_state = tx.update(grads, tx.init(params), params)
            return (logits_eval, logits, aux["batch_stats"], loss, grads,
                    optax.apply_updates(params, updates), opt_state[0].trace)

        # the reference runs once: a light backend optimization level
        # halves its compile time
        ref = jax.device_get(reference.lower(tree, batch).compile(
            FAST_COMPILE)(tree, batch))
    return kw, tree, batch, ref


@pytest.fixture(autouse=True, scope="module")
def _reference_started():
    """The whole-model references take ~10 s (f64) and ~3 s (bf16) to
    trace and compile, the compiles outside the GIL: they start on
    threads with the module, and the tests that need them come last, so
    the port-only tests run meanwhile (``jax.enable_x64`` is
    thread-local)."""
    case = _case()
    with ThreadPoolExecutor(2) as pool:
        yield {"f64": pool.submit(_jax_reference, *case),
               "bf16": pool.submit(_jax_reference_bf16, *case)}


@pytest.fixture(scope="module")
def model_case(_reference_started):
    return _reference_started["f64"].result()


@pytest.fixture(scope="module")
def bf16_case(_reference_started):
    return _reference_started["bf16"].result()


def _port(kw, tree, dtype):
    model, _, _, loss_fn = tresnet.create_model_and_loss(
        dtype=dtype, device="cpu", **kw)
    params, stats = tresnet.params_from_flax(tree["params"],
                                             tree["batch_stats"])
    to = lambda d: {k: v.to(dtype) for k, v in d.items()}
    return model, to(params), to(stats), loss_fn


def _forward(model, params, stats, image, train):
    with torch.no_grad():
        return torch.func.functional_call(
            model, params, (torch.from_numpy(image), stats),
            {"train": train})


def _small_case(seed=2, **kw):
    model, params, extra, loss_fn = tresnet.create_model_and_loss(
        dtype=torch.float32, device="cpu", seed=seed, **dict(SMALL, **kw))
    batch = tresnet.synthetic_image_batch(BATCH, IMAGE, CLASSES, seed=seed)
    return model, params, extra, loss_fn, batch


def test_make_multi_step_equals_two_steps():
    _, params, extra, loss_fn, batch = _small_case()
    second = tresnet.synthetic_image_batch(BATCH, IMAGE, CLASSES, seed=3)
    tx = toptim.sgd(0.1, momentum=0.9)
    state = ttrainer.make_train_state(params, tx, extra)
    step = ttrainer.make_train_step(loss_fn, tx, has_aux=True)
    s1, l1 = step(state, batch, 0)
    s2, l2 = step(s1, second, 0)
    both = {k: np.stack([batch[k], second[k]]) for k in batch}
    sm, losses = ttrainer.make_multi_step(loss_fn, tx, 2, has_aux=True)(
        state, both, 0)
    torch.testing.assert_close(losses, torch.stack([l1, l2]), rtol=0,
                               atol=0)
    for tree in ("params", "extra"):
        flat = (lambda s: s[tree]) if tree == "params" else (
            lambda s: s[tree]["batch_stats"])
        for name, val in flat(sm).items():
            torch.testing.assert_close(val, flat(s2)[name], rtol=0, atol=0)
    assert int(sm["step"]) == 2


def test_remat_same_step_and_statistics_updated_once():
    out = {}
    for remat in (False, True):
        model, params, extra, loss_fn, batch = _small_case(remat=remat)
        stats = extra["batch_stats"]
        calls = []
        hooks = [m.register_forward_hook(lambda *a: calls.append(1))
                 for m in model.modules()
                 if isinstance(m, tresnet.BatchNorm)]
        loss, aux, grads = ttrainer._value_and_grad(
            lambda p: loss_fn(p, extra, batch, None), params, True)
        for h in hooks:
            h.remove()
        out[remat] = loss, aux["batch_stats"], grads, len(calls)
    n_norms = len(stats) // 2
    # the recompute ran the blocks' norms again, and changed nothing
    assert out[False][3] == n_norms and out[True][3] > n_norms
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0,
                               atol=1e-6)
    for name in stats:
        torch.testing.assert_close(out[True][1][name], out[False][1][name],
                                   rtol=0, atol=0)
        # one update: 0.9 * running + 0.1 * batch (mean 0 / var 1 before)
        assert not torch.equal(out[True][1][name], stats[name])
    for name in params:
        torch.testing.assert_close(out[True][2][name], out[False][2][name],
                                   rtol=0, atol=1e-6)


def test_space_to_depth_stem_exact():
    gen = torch.Generator().manual_seed(0)
    kw = dict(SMALL, dtype=torch.float32, device="cpu")
    plain = tresnet.ResNet(**dict(kw, space_to_depth=False)).init_weights(
        gen)
    s2d = tresnet.ResNet(**kw)
    s2d.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, IMAGE, IMAGE, 3).astype(np.float32))
    stats = tresnet.init_batch_stats(plain)
    with torch.no_grad():
        a, _ = plain(x, stats, train=False)
        b, _ = s2d(x, stats, train=False)
    torch.testing.assert_close(b, a, rtol=0, atol=TOL)
    # the scattered kernel: tap (u // 2, v // 2), channel ((u%2)*2 + v%2)*3
    w = s2d.stem1.kernel.detach()
    w2 = s2d.stem1.s2d_kernel().detach()
    for u in range(4):
        for v in range(4):
            ch = ((u % 2) * 2 + v % 2) * 3
            want = w[:, :, u, v] if u < 3 and v < 3 else torch.zeros_like(
                w[:, :, 0, 0])
            torch.testing.assert_close(w2[:, ch:ch + 3, u // 2, v // 2],
                                       want, rtol=0, atol=0)


def test_same_padding_matches_flax_formula():
    assert tresnet.same_pads(112, 3, 2) == (0, 1)
    assert tresnet.same_pads(7, 3, 2) == (1, 1)
    assert tresnet.same_pads(224, 7, 2) == (2, 3)
    assert tresnet.same_pads(7, 3, 1) == (1, 1)
    assert tresnet.same_pads(14, 1, 2) == (0, 0)


BLOCKS = {
    # name: (JAX block, port block, input [b, h, w, c])
    "basic_vd_stride2": (
        lambda: jresnet.BasicBlock(8, 2, True, jnp.float32),
        lambda: tresnet.BasicBlock(4, 8, 2, True, torch.float32,
                                   device="cpu"),
        (4, 8, 8, 4)),
    "resnext_grouped": (
        lambda: jresnet.BottleneckBlock(8, 2, True, jnp.float32, groups=4,
                                        base_width=8),
        lambda: tresnet.BottleneckBlock(16, 8, 2, True, torch.float32,
                                        groups=4, base_width=8,
                                        device="cpu"),
        (4, 8, 8, 16)),
    "odd_size_strided_1x1": (
        lambda: jresnet.BottleneckBlock(4, 2, False, jnp.float32),
        lambda: tresnet.BottleneckBlock(8, 4, 2, False, torch.float32,
                                        device="cpu"),
        (4, 7, 7, 8)),
    "bn_stats_every_2": (
        lambda: jresnet.BottleneckBlock(4, 2, True, jnp.float32,
                                        bn_stats_every=2),
        lambda: tresnet.BottleneckBlock(8, 4, 2, True, torch.float32,
                                        bn_stats_every=2, device="cpu"),
        (8, 6, 6, 8)),
}


def _block_inputs(name):
    """x, the flax variables and the cotangent w of block ``name``."""
    _, tblock, shape = BLOCKS[name]
    seed = len(name)
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    block = tblock()
    tree = _fill(_flax_shapes(block), seed)
    with torch.no_grad():
        y, _ = block.to("meta")(torch.empty(
            shape, device="meta").permute(0, 3, 1, 2),
            tresnet.init_batch_stats(block), True)
    w = rng.randn(y.shape[0], y.shape[2], y.shape[3], y.shape[1])
    return x, tree, w.astype(np.float32)


@pytest.fixture(scope="module")
def block_results():
    """Each block's inputs, and the JAX block's train-mode output,
    statistics and gradients of sum(w * y) in its params and x, all in
    one jitted call."""
    inputs = {name: _block_inputs(name) for name in BLOCKS}

    @jax.jit
    def run(inputs):
        out = {}
        for name, (x, tree, w) in inputs.items():
            block = BLOCKS[name][0]()

            def loss(params, x):
                y, upd = block.apply(
                    {"params": params, "batch_stats": tree["batch_stats"]},
                    x, True, mutable=["batch_stats"])
                return jnp.sum(y * w), (y, upd)

            (_, (y, upd)), (gp, gx) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(tree["params"], x)
            out[name] = (y, upd["batch_stats"], gp, gx)
        return out

    return inputs, jax.device_get(
        run.lower(inputs).compile(FAST_COMPILE)(inputs))


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, block_results):
    x, tree, w = block_results[0][name]
    want = block_results[1][name]
    tblock = tresnet.name_norms(BLOCKS[name][1]())
    params, stats = tresnet.params_from_flax(tree["params"],
                                             tree["batch_stats"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y, upd = torch.func.functional_call(tblock, leaves, (xt, stats, True))
    (y * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    _close(y.permute(0, 2, 3, 1), want[0], TOL, "y")
    _close_tree(upd, want[1], TOL, "batch_stats", True)
    _close_tree({k: v.grad for k, v in leaves.items()}, want[2], GRAD_TOL,
                "grad")
    _close(xt.grad.permute(0, 2, 3, 1), want[3], GRAD_TOL, "dx")


def test_vanilla_stem_and_max_pool_match_flax():
    """The non-vd stem: a 7x7/2 conv (SAME pads (2, 3) at an even size,
    (3, 3) at an odd one), then the 3x3/2 max pool padded with -inf."""
    import flax.linen as fnn

    for size in (32, 33):
        x = np.random.RandomState(size).randn(2, size, size, 3).astype(
            np.float32)
        conv = fnn.Conv(8, (7, 7), strides=(2, 2), use_bias=False,
                        dtype=jnp.float32)
        v = _fill(jax.eval_shape(conv.init, jax.random.PRNGKey(0), x),
                  seed=size)
        want = jax.jit(lambda v, x: fnn.max_pool(
            conv.apply(v, x), (3, 3), strides=(2, 2), padding="SAME"))(v, x)
        port = tresnet.Conv(3, 8, 7, 2, dtype=torch.float32, device="cpu")
        port.load_state_dict({"kernel": tresnet.params_from_flax(
            v["params"])[0]["kernel"]})
        with torch.no_grad():
            y = port(torch.from_numpy(x).permute(0, 3, 1, 2))
            y, pad = tresnet._pad_same(y, 3, 2, value=-np.inf)
            y = torch.nn.functional.max_pool2d(y, 3, 2, padding=pad)
        _close(y.permute(0, 2, 3, 1), want, TOL, "stem %d" % size)


def test_create_model_and_loss_init_and_first_loss():
    """flax's init: lecun-normal kernels (truncated, variance 1/fan_in),
    zero biases, BN scale 1 and 0 on each block's last norm, running
    mean 0 / var 1; with bn3 at zero the first loss is within 1 of
    ln(classes)."""
    model, params, extra, loss_fn = tresnet.create_model_and_loss(
        depth=50, num_classes=CLASSES, dtype=torch.float32,
        stage_filters=SF, space_to_depth=True, device="cpu", seed=0)
    assert params["stage0_block0.bn3.scale"].abs().max() == 0
    assert params["stage0_block0.bn1.scale"].eq(1).all()
    k = params["stage2_block0.conv2.kernel"]
    assert k.shape == (32, 32, 3, 3)
    std = k.std().item() * np.sqrt(32 * 9)
    assert 0.85 < std < 1.15 and k.abs().max() * np.sqrt(32 * 9) <= 2.0 / \
        tresnet._TRUNC_STD + 1e-6
    assert set(extra["batch_stats"]) == {
        n[:-len("scale")] + s for n in params if n.endswith(".scale")
        for s in ("mean", "var")}
    batch = jresnet.synthetic_image_batch(BATCH, IMAGE, CLASSES, seed=0)
    loss, aux = loss_fn(params, extra, batch, None)
    # chip_smoke.py's bound (RESNET_LOSS0_TOL): O(1) logits
    assert abs(float(loss) - np.log(CLASSES)) < 1.0
    assert set(aux["batch_stats"]) == set(extra["batch_stats"])
    np.testing.assert_array_equal(
        tresnet.synthetic_image_batch(BATCH, IMAGE, CLASSES)["image"],
        batch["image"])


def test_params_from_flax_layouts():
    tree = {"stem1": {"kernel": np.arange(3 * 3 * 3 * 32, dtype=np.float32)
                      .reshape(3, 3, 3, 32)},
            "head": {"kernel": np.ones((64, 10), np.float32),
                     "bias": np.zeros(10, np.float32)}}
    params, stats = tresnet.params_from_flax(tree, {"bn": {"mean": [0.0]}})
    assert params["stem1.kernel"].shape == (32, 3, 3, 3)
    assert params["stem1.kernel"][5, 2, 1, 0] == tree["stem1"]["kernel"][
        1, 0, 2, 5]
    assert params["head.kernel"].shape == (64, 10)
    assert set(stats) == {"bn.mean"}
    with pytest.raises(TypeError):
        tresnet.params_from_flax({"x": {"kernel": np.zeros(2, np.int32)}})


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tresnet.ResNet50_vd()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tresnet.create_model_and_loss()


def test_whole_model_f64_matches_jax(model_case):
    kw, tree, batch, ref = model_case
    logits_eval, logits, new_stats, loss, grads, params1, trace1 = ref
    model, params, stats, loss_fn = _port(kw, tree, torch.float64)
    got, same = _forward(model, params, stats, batch["image"], False)
    _close(got, logits_eval, F64_TOL, "eval logits")
    assert all(same[k] is stats[k] for k in stats)
    got, got_stats = _forward(model, params, stats, batch["image"], True)
    _close(got, logits, F64_TOL, "train logits")
    _close_tree(got_stats, new_stats, F64_TOL, "batch_stats", True)

    tx = toptim.sgd(0.1, momentum=0.9)
    state = ttrainer.make_train_state(params, tx, {"batch_stats": stats})
    loss_got, aux, grads_got = ttrainer._value_and_grad(
        lambda p: loss_fn(p, state["extra"], batch, None), params, True)
    _close(loss_got, loss, F64_TOL, "loss")
    _close_tree(grads_got, grads, F64_TOL, "grad")
    _close_tree(aux["batch_stats"], new_stats, F64_TOL, "aux batch_stats",
                True)
    state1, loss1 = ttrainer.make_train_step(loss_fn, tx, has_aux=True)(
        state, batch, None)
    _close(loss1, loss, F64_TOL, "step loss")
    _close_tree(state1["params"], params1, F64_TOL, "sgd params")
    _close_tree(state1["opt_state"][0]["trace"], trace1, F64_TOL,
                "sgd trace")
    _close_tree(state1["extra"]["batch_stats"], new_stats, F64_TOL,
                "step batch_stats", True)
    assert int(state1["step"]) == 1


def test_whole_model_f32_within_conditioning(model_case):
    kw, tree, batch, ref = model_case
    logits_eval, logits, new_stats, loss, grads, _, _ = ref
    model, params, stats, loss_fn = _port(kw, tree, torch.float32)
    got, _ = _forward(model, params, stats, batch["image"], False)
    _close(got, logits_eval, TOL, "eval logits")
    got, got_stats = _forward(model, params, stats, batch["image"], True)
    _close(got, logits, F32_LOSS_RTOL, "train logits")
    _close_tree(got_stats, new_stats, F32_STATS_TOL, "batch_stats", True)
    loss_got, _, grads_got = ttrainer._value_and_grad(
        lambda p: loss_fn(p, {"batch_stats": stats}, batch, None), params,
        True)
    assert abs(float(loss_got) - float(loss)) <= F32_LOSS_RTOL * abs(
        float(loss))
    want = tresnet.params_from_flax(grads)[0]
    for name, g in grads_got.items():
        w = want[name].double()
        err = ((g.double() - w).norm() / w.norm().clamp_min(1e-12)).item()
        assert err <= F32_GRAD_RFRO, (name, err)


def _spread(got, want):
    """max |got - want| over max |want| (at least 1), for tensors or
    arrays."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max()))


def test_whole_model_bf16_matches_jax_bf16(model_case, bf16_case):
    """The bf16 model (f32 params and statistics) against the JAX
    package's bf16 model on the same tree and batch: train logits, each
    updated statistic, the loss. The two round to bf16 at different
    points, so each is held by the JAX package's own bf16 error, its
    distance from the f64 reference (``d``, floored at one bf16 ulp,
    2^-7): the port within ``BF16_SPREAD * d`` of the JAX bf16 value and
    of the f64 one. Measured here (port vs JAX bf16, JAX bf16 vs f64):
    train logits 8.9e-2, 7.5e-2 (BatchNorm over 4 values in the last
    stage amplifies rounding); running means 5.6e-3, under the floor,
    and variances 3.2e-2, 2.8e-2 (worst leaf); loss 7.2e-3, 1.25e-2.
    The eval logits (the JAX package's bf16 eval is 5.9e-3 from f64,
    under the floor; the port's 4.1e-3) are held to f64 within
    ``BF16_SPREAD`` ulps; the teacher test holds a bf16 eval forward
    against the JAX package's."""
    kw, tree, batch, ref = model_case
    model, _, _, loss_fn = tresnet.create_model_and_loss(
        dtype=torch.bfloat16, device="cpu", **kw)
    params, stats = tresnet.params_from_flax(tree["params"],
                                             tree["batch_stats"])
    got_eval, _ = _forward(model, params, stats, batch["image"], False)
    got_train, got_stats = _forward(model, params, stats, batch["image"],
                                    True)
    with torch.no_grad():
        got_loss, aux = loss_fn(params, {"batch_stats": stats}, batch, None)
    assert got_eval.dtype == torch.float32 and all(
        v.dtype == torch.float32 for v in got_stats.values())
    want_stats = tresnet.params_from_flax({}, bf16_case[1])[1]
    exact_stats = tresnet.params_from_flax({}, ref[2])[1]
    # (got, JAX bf16, f64) triples; a group's spread is its worst
    assert _spread(got_eval, ref[0]) <= BF16_SPREAD * BF16_ULP, _spread(
        got_eval, ref[0])
    groups = {
        "train logits": [(got_train, bf16_case[0], ref[1])],
        "loss": [(got_loss, bf16_case[2], ref[3])],
    }
    for kind in ("mean", "var"):
        groups["batch_stats " + kind] = [
            (got_stats[n], want_stats[n], exact_stats[n])
            for n in got_stats if n.endswith(kind)]
    for what, triples in groups.items():
        d = max(BF16_ULP, max(_spread(w, e) for _, w, e in triples))
        to_jax = max(_spread(g, w) for g, w, _ in triples)
        to_exact = max(_spread(g, e) for g, _, e in triples)
        assert to_jax <= BF16_SPREAD * d, (what, to_jax, d)
        assert to_exact <= BF16_SPREAD * d, (what, to_exact, d)
    torch.testing.assert_close(aux["batch_stats"], got_stats, rtol=0,
                               atol=0)


def _to_flax(flat):
    """A flat dict of the port's tensors as a flax tree (numpy, f32;
    conv kernels OIHW -> HWIO)."""
    tree = {}
    for name, val in flat.items():
        arr = val.detach().float().cpu().numpy()
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
    return tree


def bf16_gradient_noise(batch=16, image=64, seed=0):
    """How far each package's first-step bf16 gradient lies from its own
    f64 one at ResNet50_vd's widths (1000 classes, s2d), on the same
    weights (the port's init from ``seed`` with each bn3 scale at 0.25,
    as chip_smoke.py's ``resnet_parity`` sets them) and batch: relative
    Frobenius norm over all leaves together, of the median leaf and of
    the worst leaf. Returns {name: (all, median, worst, worst leaf)}
    for "port", "jax" and "port vs jax" (the two bf16 gradients)."""
    kw = dict(depth=50, num_classes=1000, vd=True, space_to_depth=True)
    _, params, extra, _ = tresnet.create_model_and_loss(
        dtype=torch.float32, device="cpu", seed=seed, **kw)
    for name in params:
        if name.endswith("bn3.scale"):
            params[name].fill_(0.25)
    rng = np.random.RandomState(seed + 1)
    data = {"image": rng.randn(batch, image, image, 3).astype(np.float32),
            "label": rng.randint(0, 1000, batch).astype(np.int32)}
    grads = {}
    for dtype in (torch.bfloat16, torch.float64):
        _, _, _, loss_fn = tresnet.create_model_and_loss(
            dtype=dtype, device="cpu", seed=seed, **kw)
        to = (lambda t: t.double()) if dtype == torch.float64 else (
            lambda t: t)
        p = {k: to(v) for k, v in params.items()}
        e = {"batch_stats": {k: to(v)
                             for k, v in extra["batch_stats"].items()}}
        _, _, g = ttrainer._value_and_grad(
            lambda q: loss_fn(q, e, data, None), p, True)
        grads["port", dtype] = {k: v.double() for k, v in g.items()}
    variables = {"params": _to_flax(params),
                 "batch_stats": _to_flax(extra["batch_stats"])}
    for dtype in (jnp.bfloat16, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            model = jresnet.ResNet(dtype=dtype, **kw)
            loss_fn = _jax_loss(model, classes=1000)

            @jax.jit
            def grad(variables, data):
                v = jax.tree_util.tree_map(lambda a: a.astype(
                    jnp.promote_types(a.dtype, dtype)), variables)
                d = dict(data, image=data["image"].astype(
                    jnp.promote_types(jnp.float32, dtype)))
                return jax.grad(loss_fn, has_aux=True)(
                    v["params"], {"batch_stats": v["batch_stats"]}, d,
                    None)[0]

            g = tresnet.params_from_flax(jax.device_get(
                grad(variables, data)))[0]
        grads["jax", dtype == jnp.float64] = {
            k: v.double() for k, v in g.items()}

    def spread(got, want):
        leaves = sorted(((got[n] - want[n]).norm() / want[n].norm()).item()
                        for n in want)
        worst = max(want, key=lambda n: ((got[n] - want[n]).norm()
                                         / want[n].norm()).item())
        whole = (sum(((got[n] - want[n]) ** 2).sum() for n in want) ** 0.5
                 / sum((w ** 2).sum() for w in want.values()) ** 0.5)
        return whole.item(), leaves[len(leaves) // 2], leaves[-1], worst

    return {"port": spread(grads["port", torch.bfloat16],
                           grads["port", torch.float64]),
            "jax": spread(grads["jax", False], grads["jax", True]),
            "port vs jax": spread(grads["port", torch.bfloat16],
                                  grads["jax", False])}


if __name__ == "__main__":
    # python tests/test_torch_resnet.py: the bf16 gradient noise of both
    # packages at ResNet50_vd's widths (a few minutes on the CPU)
    import time

    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    for batch, image in ((16, 64), (32, 128)):
        for name, (whole, median, worst, leaf) in bf16_gradient_noise(
                batch, image).items():
            print("ResNet50_vd b%d x %d px, bf16 gradient, %s vs f64: all "
                  "leaves %.4f, median leaf %.4f, worst leaf %.4f (%s)"
                  % (batch, image, name, whole, median, worst, leaf)
                  if name != "port vs jax" else
                  "ResNet50_vd b%d x %d px, port's bf16 gradient vs the JAX "
                  "package's: all leaves %.4f, median leaf %.4f, worst leaf "
                  "%.4f (%s)" % (batch, image, whole, median, worst, leaf))
    print("%.1f s" % (time.time() - t0))
