"""Parity of the port's training path with the JAX package's, on the CPU:
``create_model_and_loss`` -> ``make_train_step`` -> ``runtime/optim.py``
for ``gpt_tiny`` and ``bert_tiny``, the accumulation and multi-step
builders, remat, the optax-default optimizers, and the bench's LM loop.

Both packages start from one flax param tree (``params_from_flax``) and
numpy batches from a seed; the models run in f32, the port's attention
through its flash path (on the CPU: the plain forward and backward), the
JAX package's dense. Each model's JAX side is one jitted function (one
compile). Tolerances: 1e-4 on f32 losses, gradients and parameters (the
JAX suite's gradient tolerance, tests/test_flash_attention.py), relative
to the leaf's largest magnitude; 1e-6 between the port's own remat
variants (the same arithmetic, recomputed); 1e-6 against optax on the
same gradients.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import bert as jbert
from edl_tpu.models import gpt as jgpt
from edl_tpu.runtime import trainer as jtrainer
from edl_tpu_torch import bench as tbench
from edl_tpu_torch.models import bert as tbert
from edl_tpu_torch.models import gpt as tgpt
from edl_tpu_torch.runtime import optim as toptim
from edl_tpu_torch.runtime import trainer as ttrainer

from _torch_threads import _one_torch_thread  # noqa: F401


TOL = 1e-4
REMAT_TOL = 1e-6
OPTAX_TOL = 1e-6
LR = 1e-3
TINY = dict(num_layers=2, dtype=jnp.float32)


def _gpt_batches():
    whole = jgpt.synthetic_lm_batch(4, 32, 256, seed=1)
    return whole, {"input_ids": whole["input_ids"].reshape(2, 2, 32)}


def _bert_batches():
    whole = jbert.synthetic_text_batch(4, 32, 1000, seed=1)
    return whole, {key: val.reshape((2, 2) + val.shape[1:])
                   for key, val in whole.items()}


def _jax_reference(family, model, batches, accum=True):
    """The JAX side, in three jitted functions: the package's
    create_model_and_loss (its init), one adamw
    step that also returns the loss and grads at the params it starts
    from, called three times; one make_accum_step(2) update from fresh
    state (``accum``). Returns the param tree and (loss, grads, the three
    losses, the params after them, accum loss, accum params)."""
    built = {}

    def build():  # the package's own builder, its init traced once
        _, params, built["loss_fn"] = family.create_model_and_loss(
            model=model)
        return params

    params = jax.jit(build)()
    loss_fn = built["loss_fn"]
    whole, micro = batches
    tx = optax.adamw(LR)
    step = jtrainer.make_train_step(loss_fn, tx)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def step_and_grads(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state["params"], batch,
                                                  None)
        return loss, grads, step(state, batch, key)[0]

    state = jax.jit(jtrainer.make_train_state, static_argnums=1)(params, tx)
    losses = []
    for i in range(3):
        loss, grads_i, state = step_and_grads(state, whole)
        losses.append(loss)
        if i == 0:
            grads = grads_i
    out = [losses[0], grads, np.stack(losses), state["params"], None, None]
    if accum:
        acc_state, out[4] = jax.jit(jtrainer.make_accum_step(
            loss_fn, tx, 2))(jtrainer.make_train_state(params, tx), micro,
                             key)
        out[5] = acc_state["params"]
    return jax.device_get(params), jax.device_get(out)


@pytest.fixture(scope="module")
def gpt_case():
    batches = _gpt_batches()
    tree, ref = _jax_reference(jgpt, jgpt.gpt_tiny(**TINY), batches)
    model = tgpt.gpt_tiny(num_layers=2, dtype=torch.float32, use_flash=True,
                          device="cpu")
    _, _, loss_fn = tgpt.create_model_and_loss(model)
    return model, tgpt.params_from_flax(tree), loss_fn, batches, ref


@pytest.fixture(scope="module")
def bert_case():
    batches = _bert_batches()
    tree, ref = _jax_reference(jbert, jbert.bert_tiny(**TINY), batches,
                               accum=False)
    model = tbert.bert_tiny(num_layers=2, dtype=torch.float32,
                            use_flash=True, device="cpu")
    _, _, loss_fn = tbert.create_model_and_loss(model)
    return model, tbert.params_from_flax(tree), loss_fn, batches, ref


def _noise_driven(name):
    """Leaves whose true gradient is exactly zero: a key bias adds one
    constant to every score of a row, which the softmax ignores. Their
    computed gradients are rounding noise (|g| < 1e-6 in both packages,
    checked by the gradient test), and Adam turns noise into steps of
    about the learning rate whose sign is the noise's. After n Adam
    steps they are held to 2 n lr (each side moved at most n lr)."""
    return name.endswith("attention.key.bias")


def _close(got, want, what, adam_steps=0):
    """Each leaf within TOL of its largest magnitude (noise-driven
    leaves after ``adam_steps`` Adam steps: within 2 adam_steps LR)."""
    if isinstance(got, dict):
        want = tgpt.params_from_flax(want)
        assert set(got) == set(want), set(got) ^ set(want)
        for name in got:
            _close(got[name], want[name].numpy(), "%s %s" % (what, name),
                   adam_steps if _noise_driven(name) else 0)
        return
    got, want = got.detach().float().numpy(), np.asarray(want)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    if adam_steps:
        atol = 2 * adam_steps * LR
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", ["gpt_case", "bert_case"])
def test_loss_and_grads_match_jax(case, request):
    model, params, loss_fn, (whole, _), ref = request.getfixturevalue(case)
    loss, _, grads = ttrainer._value_and_grad(
        lambda p: loss_fn(p, whole, None), params, False)
    _close(loss, ref[0], "loss")
    _close(grads, ref[1], "grad")
    for name, g in grads.items():
        if _noise_driven(name):
            assert float(g.abs().max()) < 1e-6, name


@pytest.mark.parametrize("case", ["gpt_case", "bert_case"])
def test_three_adamw_steps_match_jax(case, request):
    model, params, loss_fn, (whole, _), ref = request.getfixturevalue(case)
    tx = toptim.adamw(LR)
    step = ttrainer.make_train_step(loss_fn, tx)
    state = ttrainer.make_train_state(params, tx)
    losses = []
    for _ in range(3):
        state, loss = step(state, whole, 0)
        losses.append(loss)
    _close(torch.stack(losses), ref[2], "losses")
    _close(state["params"], ref[3], "params", adam_steps=3)
    assert int(state["step"]) == 3
    assert int(state["opt_state"][0]["count"]) == 3
    # the step is functional: the state it was given is unchanged
    assert all(torch.equal(params[n], p) for n, p in
               ttrainer.make_train_state(params, tx)["params"].items())


@pytest.mark.parametrize("case", ["gpt_case", "bert_case"])
def test_accum_step_matches_whole_batch_and_jax(case, request):
    model, params, loss_fn, (whole, micro), ref = \
        request.getfixturevalue(case)
    tx = toptim.adamw(LR)
    accum = ttrainer.make_accum_step(loss_fn, tx, 2)
    state, loss = accum(ttrainer.make_train_state(params, tx), micro, 0)
    if ref[4] is not None:  # against JAX's on gpt_tiny (one compile)
        _close(loss, ref[4], "accum loss")
        _close(state["params"], ref[5], "accum params", adam_steps=1)
    one, _ = ttrainer.make_train_step(loss_fn, tx)(
        ttrainer.make_train_state(params, tx), whole, 0)
    for name, p in state["params"].items():
        tol = 2 * LR if _noise_driven(name) else TOL
        torch.testing.assert_close(p, one["params"][name], rtol=TOL,
                                   atol=tol)
    # the overlap without a mesh is the eager step; with one it raises
    eager = ttrainer.make_accum_step(loss_fn, tx, 2, overlap_axis="dp")
    again, _ = eager(ttrainer.make_train_state(params, tx), micro, 0)
    assert all(torch.equal(again["params"][n], p)
               for n, p in state["params"].items())
    with pytest.raises(NotImplementedError, match="A12"):
        ttrainer.make_accum_step(loss_fn, tx, 2, overlap_axis="dp",
                                 mesh=object())


def test_multi_step_is_single_steps_with_folded_generators(gpt_case):
    model, params, loss_fn, (whole, _), _ = gpt_case
    seen = []

    def recording_loss(p, batch, rng):
        seen.append(torch.randint(0, 2 ** 30, (1,), generator=rng).item())
        return loss_fn(p, batch, rng)

    tx = toptim.sgd(0.1)
    batches = {"input_ids": np.stack([whole["input_ids"]] * 3)}
    multi = ttrainer.make_multi_step(recording_loss, tx, 3)
    state, losses = multi(ttrainer.make_train_state(params, tx), batches, 7)
    assert losses.shape == (3,) and int(state["step"]) == 3
    single = ttrainer.make_train_step(loss_fn, tx)
    ref = ttrainer.make_train_state(params, tx)
    for i in range(3):
        ref, loss = single(ref, whole, None)
        torch.testing.assert_close(losses[i], loss, rtol=0, atol=0)
    for name, p in ref["params"].items():
        torch.testing.assert_close(state["params"][name], p, rtol=0, atol=0)
    # each step's stream is fold_in(seed, step): distinct, reproducible
    want = [torch.randint(0, 2 ** 30, (1,), generator=ttrainer.fold_in(
        7, i)).item() for i in range(3)]
    assert seen == want and len(set(seen)) == 3
    with pytest.raises(ValueError):
        ttrainer.make_multi_step(loss_fn, tx, 0)


@pytest.mark.parametrize("remat", ["model", "full", "dots",
                                   "dots_no_batch"])
def test_remat_matches_no_remat(gpt_case, remat):
    model, params, loss_fn, (whole, _), _ = gpt_case
    tx = toptim.sgd(0.1)
    plain, plain_loss = ttrainer.make_train_step(loss_fn, tx)(
        ttrainer.make_train_state(params, tx), whole, None)
    if remat == "model":
        model.remat = True
        try:
            got, loss = ttrainer.make_train_step(loss_fn, tx)(
                ttrainer.make_train_state(params, tx), whole, None)
        finally:
            model.remat = False
    else:
        got, loss = ttrainer.make_train_step(loss_fn, tx,
                                             remat_policy=remat)(
            ttrainer.make_train_state(params, tx), whole, None)
    torch.testing.assert_close(loss, plain_loss, rtol=REMAT_TOL,
                               atol=REMAT_TOL)
    for name, p in plain["params"].items():
        torch.testing.assert_close(got["params"][name], p, rtol=REMAT_TOL,
                                   atol=REMAT_TOL)
    with pytest.raises(ValueError, match="remat_policy"):
        ttrainer.make_train_step(loss_fn, tx, remat_policy="bogus")


def test_bert_remat_matches_no_remat(bert_case):
    model, params, loss_fn, (whole, _), _ = bert_case
    tx = toptim.sgd(0.1)
    step = ttrainer.make_train_step(loss_fn, tx)
    plain, plain_loss = step(ttrainer.make_train_state(params, tx), whole,
                             None)
    model.remat = True
    try:
        got, loss = step(ttrainer.make_train_state(params, tx), whole, None)
    finally:
        model.remat = False
    torch.testing.assert_close(loss, plain_loss, rtol=REMAT_TOL,
                               atol=REMAT_TOL)
    for name, p in plain["params"].items():
        torch.testing.assert_close(got["params"][name], p, rtol=REMAT_TOL,
                                   atol=REMAT_TOL)


OPTIMIZERS = [
    ("sgd", lambda m: m.sgd(0.1)),
    ("sgd_momentum", lambda m: m.sgd(0.1, momentum=0.9)),
    ("sgd_nesterov", lambda m: m.sgd(0.1, momentum=0.9, nesterov=True)),
    ("sgd_schedule", lambda m: m.sgd(lambda c: 0.1 / (1.0 + c))),
    ("adam", lambda m: m.adam(1e-2)),
    ("adamw", lambda m: m.adamw(1e-2)),
    ("adamw_decay", lambda m: m.adamw(1e-2, weight_decay=0.1)),
]


@pytest.mark.parametrize("name,make", OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_matches_optax(name, make):
    """Five updates on the same gradients from numpy, params and state
    against optax's."""
    rng = np.random.RandomState(3)
    shapes = {"w": (5, 3), "b": (3,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    jtx, ttx = make(optax), make(toptim)
    jp, tp = dict(params), {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        tp = toptim.apply_updates(tp, tu)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=OPTAX_TOL, atol=OPTAX_TOL)
    if name.startswith("adam"):
        # the state as optax lays it out: count, mu, nu
        assert int(ts[0]["count"]) == int(js[0].count) == 5
        for k in shapes:
            np.testing.assert_allclose(ts[0]["mu"][k].numpy(),
                                       np.asarray(js[0].mu[k]),
                                       rtol=OPTAX_TOL, atol=OPTAX_TOL)
            np.testing.assert_allclose(ts[0]["nu"][k].numpy(),
                                       np.asarray(js[0].nu[k]),
                                       rtol=OPTAX_TOL, atol=OPTAX_TOL)
    if name == "sgd_momentum":
        for k in shapes:
            np.testing.assert_allclose(ts[0]["trace"][k].numpy(),
                                       np.asarray(js[0].trace[k]),
                                       rtol=OPTAX_TOL, atol=OPTAX_TOL)


def test_adamw_default_decay_is_optax_not_torch():
    p = {"w": torch.ones(2)}
    tx = toptim.adamw(0.0)
    u, _ = tx.update({"w": torch.zeros(2)}, tx.init(p), p)
    assert torch.equal(u["w"], torch.zeros(2))  # lr 0: no step at all
    tx = toptim.adamw(1.0)
    u, _ = tx.update({"w": torch.zeros(2)}, tx.init(p), p)
    torch.testing.assert_close(u["w"], torch.full((2,), -1e-4))


@pytest.mark.parametrize("per_device,budget,want", [
    (8, 8, 1), (8, 4, 2), (8, 3, 4), (8, 1, 8), (6, 4, 2), (7, 3, 7),
    (12, 5, 3)])
def test_auto_grad_accum_matches_jax(per_device, budget, want):
    got = ttrainer.auto_grad_accum(per_device, budget)
    assert got == jtrainer.auto_grad_accum(per_device, budget) == want


def test_auto_grad_accum_refuses_bad_budgets():
    for args in ((8, 0), (0, 4)):
        with pytest.raises(ValueError):
            ttrainer.auto_grad_accum(*args)
        with pytest.raises(ValueError):
            jtrainer.auto_grad_accum(*args)


def test_bert_token_types_mask_and_encoder_output_match_jax():
    """``token_type_ids`` (the type embedding flax creates only when they
    are given), an attention mask (the dense path) and
    ``num_classes=None`` (sequence output and pooled vector), against
    the JAX package's Bert in one jitted init + apply."""
    kw = dict(num_layers=1, dtype=jnp.float32, num_classes=None)
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 1000, (2, 16)).astype(np.int32)
    types = rng.randint(0, 2, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), bool)
    mask[1, 11:] = False
    jmodel = jbert.bert_tiny(**kw)

    @jax.jit
    def init_apply(ids, mask, types):
        params = jmodel.init(jax.random.PRNGKey(1), ids, mask,
                             types)["params"]
        return params, jmodel.apply({"params": params}, ids, mask, types)

    tree, (x, pooled) = jax.device_get(init_apply(ids, mask, types))
    model = tbert.bert_tiny(num_layers=1, dtype=torch.float32,
                            num_classes=None, device="cpu")
    model.load_state_dict(tbert.params_from_flax(tree))
    with torch.no_grad():
        got_x, got_pooled = model(*(torch.from_numpy(a) for a in
                                    (ids.astype(np.int64), mask,
                                     types.astype(np.int64))))
    np.testing.assert_allclose(got_x.numpy(), x, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_pooled.numpy(), pooled, rtol=TOL,
                               atol=TOL)


def test_has_aux_chains_extra_through_steps_and_microbatches(gpt_case):
    """``has_aux``: the loss takes and returns ``extra`` (here a count of
    rows seen, as BatchNorm statistics would be); a step stores the new
    one, accumulation chains it through the microbatches in order."""
    model, params, loss_fn, (whole, micro), _ = gpt_case

    def aux_loss(p, extra, batch, rng):
        rows = extra["rows"] + len(batch["input_ids"])
        return loss_fn(p, batch, rng), {"rows": rows}

    tx = toptim.sgd(0.1)
    state = ttrainer.make_train_state(params, tx, {"rows": 0})
    state, loss = ttrainer.make_train_step(aux_loss, tx, has_aux=True)(
        state, whole, None)
    assert state["extra"] == {"rows": 4}
    plain, plain_loss = ttrainer.make_train_step(loss_fn, tx)(
        ttrainer.make_train_state(params, tx), whole, None)
    torch.testing.assert_close(loss, plain_loss, rtol=0, atol=0)
    state, _ = ttrainer.make_accum_step(aux_loss, tx, 2, has_aux=True)(
        state, micro, None)
    assert state["extra"] == {"rows": 8} and int(state["step"]) == 2
    with pytest.raises(ValueError, match="has_aux"):
        ttrainer.make_accum_step(aux_loss, tx, 2, has_aux=True,
                                 overlap_axis="dp")


def test_bert_refuses_moe_and_ring():
    with pytest.raises(NotImplementedError, match="A20"):
        tbert.bert_tiny(moe_experts=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A20"):
        tbert.bert_tiny(use_ring=True, device="cpu")


@pytest.mark.parametrize("kind", ["gpt", "bert"])
@pytest.mark.parametrize("flash", [False, True])
def test_bench_lm_loop_schema_on_cpu(kind, flash, capsys):
    """The bench's LM loop at tiny size on the CPU: the JAX bench's metric
    names, suffixes and one-line JSON schema (unit tok/s/chip,
    vs_baseline 0.0). Off the card ``flash`` is ignored, as the JAX
    bench ignores it off the TPU, so no ``_flash`` suffix here; a
    non-default batch is named."""
    run = tbench.run_gpt if kind == "gpt" else tbench.run_bert
    stats = {}
    result = run(batch_per_chip=3, seq_len=16, warmup=1, iters=2,
                 tiny=True, flash=flash, device="cpu", stats=stats)
    prefix = "gpt_tiny" if kind == "gpt" else "bert_tiny"
    assert result["metric"] == prefix + "_train_tokens_per_sec_per_chip" \
        + "_seq16_b3"
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert result["unit"] == "tok/s/chip" and result["vs_baseline"] == 0.0
    assert result["value"] > 0
    assert len(stats["losses"]) == 1 + 1 + stats["iters"]
    assert np.isfinite(stats["losses"]).all()
    assert stats["mfu"] == pytest.approx(stats["implied_tflops"] / 989.0)
    json.loads(json.dumps(result))


def test_bench_cli(capsys, monkeypatch):
    """``python -m edl_tpu_torch.bench`` prints one JSON line; ``--model
    resnet`` (the default) runs on the card, and without one raises."""
    assert tbench.main(["--model", "bert", "--gpt_tiny", "--device", "cpu",
                        "--seq_len", "16", "--iters", "1", "--warmup",
                        "0"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["metric"] == \
        "bert_tiny_train_tokens_per_sec_per_chip_seq16"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--model", "resnet"])
