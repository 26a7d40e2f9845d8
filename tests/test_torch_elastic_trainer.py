"""The port's ``ElasticTrainer`` (``edl_tpu_torch/runtime/trainer.py``)
against the JAX package's on a one-device mesh, on the CPU.

Two cases, f64 on both sides (the JAX side under ``jax.enable_x64``,
the port's under torch's float64 default, its form of the same
switch): tests/test_runtime.py's linear regression, and a
small ResNet-vd (tests/test_torch_resnet.py's ``SMALL`` widths, one flax
tree from numpy with a seed, converted by ``params_from_flax``) trained
with ``sgd`` over ``lr_schedules``' warm-up and cosine, BN statistics
carried as extra state. The linear regression's losses agree within
1e-10 relative and its params within 1e-10. The JAX package's ResNet
head is an f32 Dense even in f64 (flax ``dtype=jnp.float32``), where
the port's head computes in its params' dtype, so the ResNet's f64
runs agree to that f32 rounding: losses within 1e-6 relative and every
leaf of the final state (params, momentum, statistics) within 1e-6 of
its largest magnitude. The linear regression with ``grad_accum=2``
and with a ``max_per_device_batch`` budget runs in f32 on both sides
(the JAX package's accumulation scan carries an f32 loss, which x64
refuses): losses within 1e-6 relative, params within 1e-6.

Port-only: save, a fresh trainer, resume gives a bit-equal state and a
bit-equal continuation on the CPU (sync and async saves); an in-process
SIGTERM gives an emergency checkpoint at the current step, PreemptedError
and a resume that re-runs the interrupted epoch; ``fit`` resumes,
exits 101 when preempted, reports NEARTHEEND after RUNNING; adjust hooks
and the extra state survive a resume; 64-bit extra leaves are refused;
what is not ported raises NotImplementedError naming its ROADMAP item.
``lr_schedules`` and ``Evaluator`` match the JAX package's.
"""

import contextlib
import json
import os
import signal
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import resnet as jresnet
from edl_tpu.runtime import evaluation as jevaluation
from edl_tpu.runtime import lr_schedules as jlr
from edl_tpu.runtime.mesh import make_mesh
from edl_tpu.runtime.trainer import ElasticTrainer as JaxTrainer
from edl_tpu_torch.controller.env import TrainerEnv
from edl_tpu_torch.controller.train_status import TrainStatus
from edl_tpu_torch.models import resnet as tresnet
from edl_tpu_torch.runtime import evaluation as tevaluation
from edl_tpu_torch.runtime import lr_schedules as tlr
from edl_tpu_torch.runtime import optim as toptim
from edl_tpu_torch.runtime import trainer as ttrainer
from edl_tpu_torch.runtime.trainer import ElasticTrainer
from edl_tpu_torch.utils.errors import PreemptedError

from _torch_threads import _one_torch_thread  # noqa: F401

F64_TOL = 1e-10
LOSS_RTOL = 1e-10
F32_TOL = 1e-6
# the JAX package's f32 head inside its f64 ResNet
RESNET_TOL = 1e-6
# a schedule's value within LR_ULPS float32 ulps of 1.0, times its
# peak rate, of the JAX package's: numpy's and XLA's float32 cos differ
# by an ulp at some steps, which (1 + cos) magnifies near the end
LR_ULPS = 2
CLASSES, IMAGE, BATCH = 10, 64, 4
SMALL = dict(depth=18, num_classes=CLASSES, vd=True,
             stage_filters=(4, 8, 8, 8), space_to_depth=True)
RESNET_STEPS = 3
W_TRUE = np.arange(1, 5, dtype=np.float64)


@contextlib.contextmanager
def _x64():
    """The port's form of ``jax.enable_x64``: torch's float64 default."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(before)


def _linreg_batch(seed, total=64, dtype=np.float64):
    rng = np.random.RandomState(seed)
    x = rng.randn(total, 4)
    y = x @ W_TRUE + 0.01 * rng.randn(total)
    return {"x": x.astype(dtype), "y": y.astype(dtype)}


def _port_linreg_loss(params, batch, rng):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _port_linreg(tmp_path=None, dtype=torch.float64, **kw):
    params = {"w": torch.zeros(4, dtype=dtype),
              "b": torch.zeros((), dtype=dtype)}
    kw.setdefault("checkpoint_dir",
                  str(tmp_path / "ckpt") if tmp_path else "")
    return ElasticTrainer(_port_linreg_loss, params, toptim.sgd(0.1),
                          total_batch_size=64, device="cpu", **kw)


def _jax_linreg_losses(steps, dtype, **kw):
    def loss_fn(params, batch, rng):
        pred = batch["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    with jax.enable_x64(dtype == np.float64):
        params = {"w": jnp.zeros(4, dtype), "b": jnp.zeros((), dtype)}
        trainer = JaxTrainer(loss_fn, params, optax.sgd(0.1),
                             total_batch_size=64, checkpoint_dir="",
                             mesh=make_mesh(devices=jax.devices()[:1]),
                             **kw)
        losses = [float(trainer.train_step(_linreg_batch(i, dtype=dtype)))
                  for i in range(steps)]
        return losses, jax.device_get(trainer.train_state["params"])


# -- the small ResNet-vd, both packages from one flax tree -----------------

def _flax_tree(seed=0):
    """A flax variable tree for the port's SMALL model (conv kernels
    OIHW -> HWIO), values from numpy: lecun-scaled kernels, BN scales in
    [0.8, 1.2] ([0.1, 0.3] on each block's last norm), variances in
    [0.5, 1.5], small biases and means."""
    rng = np.random.RandomState(seed)
    model = tresnet.ResNet(device="meta", **SMALL)
    tree = {"params": {}, "batch_stats": {}}

    def put(root, name, value):
        *path, leaf = name.split(".")
        for key in path:
            root = root.setdefault(key, {})
        root[leaf] = value

    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if len(shape) == 4:
            shape = shape[2:] + shape[1::-1]
        if name.endswith("kernel"):
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("scale"):
            lo, hi = (0.1, 0.3) if ".bn2." in name or ".bn3." in name \
                else (0.8, 1.2)
            v = rng.uniform(lo, hi, shape)
        else:
            v = rng.randn(*shape) * 0.1
        put(tree["params"], name, v.astype(np.float32))
    for name, v in tresnet.init_batch_stats(model).items():
        value = (rng.uniform(0.5, 1.5, tuple(v.shape)) if name.endswith("var")
                 else rng.randn(*v.shape) * 0.1)
        put(tree["batch_stats"], name, value.astype(np.float32))
    return tree


def _flat_flax(tree, prefix=""):
    """A flax tree as the port's flat names, conv kernels HWIO -> OIHW,
    in its own dtype (``params_from_flax`` makes float32)."""
    out = {}
    for key, val in tree.items():
        name = "%s.%s" % (prefix, key) if prefix else str(key)
        if hasattr(val, "items"):
            out.update(_flat_flax(val, name))
        else:
            arr = np.asarray(val)
            out[name] = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    return out


def _image_batch(step):
    return tresnet.synthetic_image_batch(BATCH, IMAGE, CLASSES,
                                         seed=100 + step)


def _schedules(mod):
    return mod.linear_warmup(mod.cosine_decay(0.05, 6), 2)


def _jax_resnet_run():
    """The JAX package's trainer on the SMALL ResNet in f64: losses and
    the final params, momentum and statistics (numpy)."""
    tree = _flax_tree()
    with jax.enable_x64(True):
        model = jresnet.ResNet(dtype=jnp.float64, **SMALL)

        def loss_fn(params, extra, batch, rng):
            logits, updated = model.apply(
                {"params": params, "batch_stats": extra["batch_stats"]},
                batch["image"], train=True, mutable=["batch_stats"])
            one_hot = optax.smooth_labels(
                jax.nn.one_hot(batch["label"], CLASSES), 0.1)
            loss = optax.softmax_cross_entropy(logits, one_hot).mean()
            return loss, {"batch_stats": updated["batch_stats"]}

        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t)
        trainer = JaxTrainer(
            loss_fn, f64(tree["params"]),
            optax.sgd(_schedules(jlr), momentum=0.9),
            total_batch_size=BATCH, checkpoint_dir="", has_aux=True,
            extra_state={"batch_stats": f64(tree["batch_stats"])},
            mesh=make_mesh(devices=jax.devices()[:1]))
        losses = [float(trainer.train_step(_image_batch(i)))
                  for i in range(RESNET_STEPS)]
        state = jax.device_get(trainer.train_state)
    return tree, losses, state


@pytest.fixture(autouse=True, scope="module")
def _jax_resnet_started():
    """The JAX ResNet run (a trace and compile of a few seconds, mostly
    outside the GIL) starts on a thread with the module; the test that
    needs it comes last (``jax.enable_x64`` is thread-local)."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_resnet_run)


def _port_resnet(tmp_path=None, dtype=torch.float32, tree=None,
                 schedule=None, **kw):
    """The port's trainer on the SMALL ResNet (weights from ``tree``, or
    the model's own seeded init)."""
    model, params, extra, loss_fn = tresnet.create_model_and_loss(
        dtype=dtype, device="cpu", seed=2, **SMALL)
    if tree is not None:
        params, stats = tresnet.params_from_flax(tree["params"],
                                                 tree["batch_stats"])
        extra = {"batch_stats": stats}
    to = lambda d: {k: v.to(dtype) for k, v in d.items()}
    kw.setdefault("checkpoint_dir", str(tmp_path / "ckpt") if tmp_path
                  else "")
    return model, ElasticTrainer(
        loss_fn, to(params),
        toptim.sgd(schedule or 0.05, momentum=0.9),
        total_batch_size=BATCH, extra_state={
            "batch_stats": to(extra["batch_stats"])},
        has_aux=True, device="cpu", **kw)


def _flat_state(state):
    """{name: tensor} of a port train state's params, momentum and
    statistics, and its step."""
    out = {"params/" + k: v for k, v in state["params"].items()}
    out.update({"trace/" + k: v
                for k, v in state["opt_state"][0]["trace"].items()})
    out.update({"stats/" + k: v
                for k, v in state["extra"]["batch_stats"].items()})
    out["step"] = state["step"]
    return out


def _assert_bit_equal(a, b):
    fa, fb = _flat_state(a), _flat_state(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name].dtype == fb[name].dtype, name
        assert torch.equal(fa[name], fb[name]), name


# -- port-only: checkpoint round trips ------------------------------------

@pytest.mark.parametrize("async_save", [False, True])
def test_resume_is_bit_equal_and_continues_bit_equal(tmp_path, async_save):
    _, tr = _port_resnet(tmp_path, async_save=async_save)
    tr.begin_epoch(0)
    for i in range(2):
        tr.train_step(_image_batch(i))
    tr.end_epoch(save=True)
    saved = {k: v.clone() for k, v in _flat_state(tr.train_state).items()}
    # keep training: with async_save the persist runs meanwhile
    tr.begin_epoch(1)
    cont = [float(tr.train_step(_image_batch(i))) for i in (2, 3)]
    tr.wait_for_save()
    fmt = "a0000.bin" if async_save else "arrays.npz"
    assert (tmp_path / "ckpt" / "v_00000002" / fmt).exists()

    _, fresh = _port_resnet(tmp_path)
    assert fresh.resume() and fresh.global_step == 2
    restored = _flat_state(fresh.train_state)
    for name, val in saved.items():
        assert restored[name].dtype == val.dtype, name
        assert torch.equal(restored[name], val), name
    assert fresh.train_state["step"].dtype == torch.int32
    assert fresh.state.next_epoch() == 1
    again = [float(fresh.train_step(_image_batch(i))) for i in (2, 3)]
    assert again == cont
    _assert_bit_equal(fresh.train_state, tr.train_state)
    tr.close()
    fresh.close()


def test_sigterm_saves_at_the_current_step_and_reruns_the_epoch(tmp_path):
    try:
        tr = _port_linreg(tmp_path, dtype=torch.float32)
        tr.install_preemption_handler()
        tr.begin_epoch(0)
        for i in range(5):
            tr.train_step(_linreg_batch(i, dtype=np.float32))
        assert not tr.preempted
        os.kill(os.getpid(), signal.SIGTERM)  # launcher / k8s preemption
        with pytest.raises(PreemptedError, match="step 6"):
            tr.train_step(_linreg_batch(5, dtype=np.float32))
        assert tr.preempted
        assert tr._ckpt.meta(6)["state"]["epochs"]["0"]["ended"] is False

        tr2 = _port_linreg(tmp_path, dtype=torch.float32)
        assert tr2.resume() and tr2.global_step == 6
        assert tr2.state.next_epoch() == 0  # the interrupted epoch again
        for name in ("w", "b"):
            assert torch.equal(tr2.train_state["params"][name],
                               tr.train_state["params"][name])
        tr2.train_step(_linreg_batch(6, dtype=np.float32))
        assert tr2.global_step == 7
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_fit_trains_resumes_and_exits_101_when_preempted(tmp_path):
    def batches(epoch, kill_at=None):
        for i in range(15):
            if i == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield _linreg_batch(epoch * 100 + i, dtype=np.float32)

    try:
        tr = _port_linreg(tmp_path, dtype=torch.float32)
        out = tr.fit(2, batches)
        assert out["steps"] == 30 and not out["resumed"]
        assert out["final_loss"] < 0.05 and out["world"] == 1
        np.testing.assert_allclose(tr.train_state["params"]["w"].numpy(),
                                   W_TRUE, atol=0.2)
        out2 = _port_linreg(tmp_path, dtype=torch.float32).fit(3, batches)
        assert out2["resumed"] and out2["steps"] == 45

        with pytest.raises(SystemExit) as exit_:
            _port_linreg(tmp_path, dtype=torch.float32).fit(
                9, lambda e: batches(e, kill_at=4))
        assert exit_.value.code == 101
        tr4 = _port_linreg(tmp_path, dtype=torch.float32)
        assert tr4.resume() and tr4.global_step == 50
        with pytest.raises(PreemptedError):
            tr4.fit(9, lambda e: batches(e, kill_at=2),
                    preemption_exit_code=None)
        # epoch 3 again from step 50: two steps, then the third saved
        tr5 = _port_linreg(tmp_path, dtype=torch.float32)
        assert tr5.resume() and tr5.global_step == 53
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


class _Coord(object):
    """The store calls a trainer makes, recorded."""

    def __init__(self):
        self.puts = []

    def set_server_permanent(self, service, key, value):
        self.puts.append((service, key, value))

    def get_value(self, service, key):
        return None

    def get_service(self, service):
        return []


def test_fit_reports_neartheend_after_running(tmp_path, monkeypatch):
    tr = _port_linreg(tmp_path)
    calls = []
    tr.report_status = calls.append
    tr.fit(2, lambda e: (_linreg_batch(e * 10 + i) for i in range(3)))
    assert calls[-1] == TrainStatus.SUCCEED
    near = calls.index(TrainStatus.NEARTHEEND)
    assert calls[near - 1] == TrainStatus.RUNNING
    assert calls[near + 1:] == [TrainStatus.SUCCEED]
    # through a store: the statuses land under train_status/<pod id>
    monkeypatch.setenv("EDL_TPU_PEER_RESTORE", "0")
    coord = _Coord()
    tr2 = _port_linreg(tmp_path / "b", coord=coord,
                       env=TrainerEnv({"EDL_TPU_POD_ID": "pod0"}))
    tr2.fit(2, lambda e: (_linreg_batch(e * 10 + i) for i in range(3)))
    statuses = [v for s, k, v in coord.puts
                if s == "train_status" and k == "pod0"]
    assert statuses == [TrainStatus.RUNNING, TrainStatus.RUNNING,
                        TrainStatus.NEARTHEEND, TrainStatus.SUCCEED]
    assert any(s == "state" for s, _, _ in coord.puts)


def test_resume_keeps_adjust_hooks_and_extra_state(tmp_path):
    tr = _port_linreg(tmp_path, dtype=torch.float32)
    tr.begin_epoch(0)
    tr.train_step(_linreg_batch(0, dtype=np.float32))
    tr.end_epoch(save=True)

    def make2():
        return _port_linreg(tmp_path, dtype=torch.float32,
                            extra_state={"loader_pos": np.int32(123)})

    # 64-bit extra leaves are refused, numpy's and torch's default int
    for wide in (np.int64(1 << 40), torch.tensor(0), torch.zeros(2).double()):
        with pytest.raises(ValueError, match="64-bit"):
            _port_linreg(tmp_path, dtype=torch.float32,
                         extra_state={"pos": wide})
    # a Python int takes JAX's weak int32
    assert _port_linreg(tmp_path, dtype=torch.float32, extra_state={
        "pos": 7}).extra_state["pos"].dtype == torch.int32

    t2 = make2()
    calls = []
    t2.state.register_adjust_function(lambda s, w: calls.append(w))
    assert t2.resume() and t2.global_step == 1  # core-only: no extra
    assert int(t2.extra_state["loader_pos"]) == 123
    t2.state.epochs[str(t2.state.epoch_no)]["world_size"] = 4
    t2.state.adjust(t2.world_size)
    assert calls == [1]  # the hook survived the state swap
    t2.begin_epoch(1)
    t2.train_step(_linreg_batch(1, dtype=np.float32))
    t2.end_epoch(save=True)
    # a world of 4 recorded in the checkpoint: resume runs the hooks
    # registered before it, carried onto the restored State
    meta_path = tmp_path / "ckpt" / "v_00000002" / "meta.json"
    blob = json.loads(meta_path.read_text())
    blob["meta"]["state"]["epochs"]["1"]["world_size"] = 4
    meta_path.write_text(json.dumps(blob))
    t3 = make2()
    t3.state.register_adjust_function(lambda s, w: calls.append(("t3", w)))
    assert t3.resume() and int(t3.extra_state["loader_pos"]) == 123
    assert calls[-1] == ("t3", 1)
    assert t3.state._adjust_fns


def test_unported_options_raise_naming_the_roadmap_item(tmp_path,
                                                        monkeypatch):
    cases = [(dict(mesh=object()), "A12"), (dict(zero1=True), "A12/A19"),
             (dict(param_shardings={}), "A19"),
             (dict(env=TrainerEnv({"EDL_TPU_JOB_ID": "j",
                                   "EDL_TPU_TRAINER_ID": "t"})), "A17"),
             (dict(coord=_Coord()), "A17"),
             (dict(env=TrainerEnv({"EDL_TPU_WORLD_SIZE": "2"})), "A12")]
    for kw, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            _port_linreg(tmp_path, **kw)
    with pytest.raises(NotImplementedError, match="A12"):
        ttrainer.maybe_init_distributed(
            TrainerEnv({"EDL_TPU_WORLD_SIZE": "4"}))
    tr = _port_linreg(tmp_path)
    for call in (lambda: tr.prewarm_resize_compiles([1]),
                 lambda: tr.live_resize(2), tr.enable_live_resize,
                 lambda: tr.install_preemption_handler(coordinated=True)):
        with pytest.raises(NotImplementedError, match="A17"):
            call()
    # the JAX package's own checks still come first
    with pytest.raises(ValueError, match="dp_overlap requires"):
        _port_linreg(tmp_path, dp_overlap=True, zero1=True)
    with pytest.raises(ValueError, match="step_fn owns"):
        _port_linreg(tmp_path, step_fn=lambda *a: a, grad_accum=2)
    # without a card, the default device is an error, not the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticTrainer(_port_linreg_loss, {"w": torch.zeros(4)},
                       toptim.sgd(0.1), total_batch_size=64)


@pytest.mark.parametrize("argv,item", [
    (["--data_dir", "d"], "A18"), (["--eval_dir", "d"], "A18"),
    (["--loader", "tf"], "A18"), (["--seed", "0"], "A18"),
    (["--zero1"], "A12/A19"), (["--prewarm_worlds", "2"], "A17")])
def test_example_unported_flags_raise(argv, item):
    from edl_tpu_torch.examples.resnet import train as example
    with pytest.raises(NotImplementedError, match=item):
        example.parse_args(argv)


def test_lr_schedules_and_evaluator_match_jax():
    for mod_pair in ((jlr, tlr),):
        jm, tm = mod_pair
        made = [(0.4, jm.linear_warmup(jm.cosine_decay(0.4, 50), 5, 0.01),
                 tm.linear_warmup(tm.cosine_decay(0.4, 50), 5, 0.01)),
                (0.1, jm.piecewise_decay(0.1, [10, 20]),
                 tm.piecewise_decay(0.1, [10, 20])),
                (0.2, jm.linear_warmup(jm.piecewise_decay(0.2, [9]), 4),
                 tm.linear_warmup(tm.piecewise_decay(0.2, [9]), 4))]
        for peak, js, ts in made:
            for step in range(60):
                assert abs(ts(step) - float(js(step))) <= \
                    LR_ULPS * 2.0 ** -23 * peak, step
    assert tlr.scale_lr_for_batch(0.1, 1024) == \
        jlr.scale_lr_for_batch(0.1, 1024)

    rng = np.random.RandomState(0)
    w = rng.randn(6, 10).astype(np.float32)
    batches = [{"x": rng.randn(n, 6).astype(np.float32),
                "label": rng.randint(0, 10, n).astype(np.int32)}
               for n in (8, 5, 8)]
    jev = jevaluation.Evaluator(lambda p, e, b: b["x"] @ p["w"])
    tev = tevaluation.Evaluator(
        lambda p, e, b: torch.from_numpy(b["x"]) @ p["w"], ks=(1, 5))
    assert tev.evaluate({"w": torch.from_numpy(w)}, {}, batches) == \
        jev.evaluate({"w": w}, {}, batches)
    assert tev.evaluate({"w": torch.from_numpy(w)}, {}, []) == {}


@pytest.mark.parametrize("kw,k,dtype", [
    ({}, 1, np.float64), ({"grad_accum": 2}, 2, np.float32),
    ({"max_per_device_batch": 16}, 4, np.float32)],
    ids=["plain_f64", "accum2_f32", "budget16_f32"])
def test_linreg_matches_jax_trainer(kw, k, dtype):
    want, want_params = _jax_linreg_losses(6, dtype, **kw)
    x64 = dtype == np.float64
    with _x64() if x64 else contextlib.nullcontext():
        tr = _port_linreg(dtype=torch.float64 if x64 else torch.float32,
                          **kw)
    assert tr._grad_accum == k
    got = [float(tr.train_step(_linreg_batch(i, dtype=dtype)))
           for i in range(6)]
    tol = F64_TOL if x64 else F32_TOL
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL if x64 else tol,
                               atol=0)
    for name in ("w", "b"):
        np.testing.assert_allclose(tr.train_state["params"][name].numpy(),
                                   want_params[name], rtol=0, atol=tol)
    assert tr.global_step == 6


def test_small_resnet_matches_jax_trainer(_jax_resnet_started):
    tree, want_losses, want = _jax_resnet_started.result()
    with _x64():
        _, tr = _port_resnet(dtype=torch.float64, tree=tree,
                             schedule=_schedules(tlr))
    got_losses = [float(tr.train_step(_image_batch(i)))
                  for i in range(RESNET_STEPS)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=RESNET_TOL,
                               atol=0)
    got = _flat_state(tr.train_state)
    for prefix, tree_ in (("params/", want["params"]),
                          ("trace/", want["opt_state"][0].trace),
                          ("stats/", want["extra"]["batch_stats"])):
        for name, val in _flat_flax(tree_).items():
            ref = np.asarray(val, np.float64)
            atol = RESNET_TOL * max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(got[prefix + name].numpy(), ref,
                                       rtol=0, atol=atol,
                                       err_msg=prefix + name)
    assert int(got["step"]) == int(want["step"]) == RESNET_STEPS
