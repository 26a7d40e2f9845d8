"""Parity of the port's BatchNorm (``edl_tpu_torch/ops/batch_norm.py``)
with flax's ``BatchNorm`` and the JAX package's ``SubsetBatchNorm`` on
the CPU: outputs, updated running statistics, and the gradients in x,
scale and bias against ``jax.grad``, in train and eval mode, f32 and
bf16, ``stats_every`` 1, 2 and 4 (eval at 1: the subset plays no part
there).

Inputs are NHWC numpy arrays from a seed; the port takes the same tensor
as NCHW in the ``channels_last`` memory format. Tolerances: f32 1e-5 on
outputs and statistics (the JAX suite's, tests/test_batch_norm.py) and
1e-4 on gradients, each relative to the largest magnitude of the
reference. In bf16: outputs within one bf16 ulp (2^-7 relative) of
jax's bf16 output, statistics (f32 from the same bf16 input) within
1e-5, and gradients within 2^-6 (two ulps: each side rounds its own
cotangents). The inputs and cotangents are bf16 values, and the scale
and bias gradients in bf16 are held to ``jax.grad`` of the f32 case:
jax's bf16 path sums them in bf16 (1-5% off the f32 value at these
sizes), where the port sums in f32 and rounds once.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import ml_dtypes
import pytest
import torch

from edl_tpu.ops.batch_norm import SubsetBatchNorm as JSubsetBatchNorm
from edl_tpu_torch.ops import batch_norm as tbn

F32_TOL, F32_GRAD_TOL = 1e-5, 1e-4
BF16_TOL, BF16_GRAD_TOL = 2.0 ** -7, 2.0 ** -6
SHAPE = (8, 5, 5, 6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run faster on one thread, and the driver's run
    shares the cores among six workers: intra-op threads there only
    oversubscribe them. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_module(kind, train, dtype, k):
    if kind == "flax":
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                             epsilon=1e-5, dtype=dtype,
                             param_dtype=jnp.float32)
    return JSubsetBatchNorm(use_running_average=not train, momentum=0.9,
                            epsilon=1e-5, dtype=dtype, stats_every=k)


def _torch_module(kind, dtype, k):
    if kind == "flax":
        return tbn.BatchNorm(SHAPE[-1], dtype=dtype, device="cpu")
    return tbn.SubsetBatchNorm(SHAPE[-1], dtype=dtype, device="cpu",
                               stats_every=k)


def _inputs(seed=0):
    """x, the flax variables and a cotangent w, x and w bf16-representable
    (so the f32 case on them is the bf16 case's exact function)."""
    rng = np.random.RandomState(seed)
    rounded = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float32)
    x = rounded(rng.randn(*SHAPE) * 1.7 + 0.6)
    c = SHAPE[-1]
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.randn(c).astype(np.float32) * 0.3},
        "batch_stats": {"mean": rng.randn(c).astype(np.float32) * 0.2,
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)},
    }
    # a cotangent that weights positions unevenly, so every term of the
    # gradient through the statistics shows
    w = rounded(rng.randn(*SHAPE))
    return x, variables, w


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _jax_side(kind, train, jdtype, k, x, variables, w):
    """Output, updated statistics and the gradient of sum(w * y) in x,
    scale and bias, from jax.grad (traced: call it under jit)."""
    mod = _jax_module(kind, train, jdtype, k)

    def loss(xj, params):
        y, upd = mod.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           xj.astype(jdtype), mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, upd)

    (_, (y, upd)), (gx, gp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(x, variables["params"])
    return (y.astype(jnp.float32), upd["batch_stats"],
            gx.astype(jnp.float32), gp)


def _torch_side(kind, train, tdtype, k, x, variables, w):
    mod = _torch_module(kind, tdtype, k)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(variables["params"]["scale"]))
        mod.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
    xt = torch.from_numpy(x).to(tdtype).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    stats = variables["batch_stats"]
    y, mean, var = mod(xt, torch.from_numpy(stats["mean"]),
                       torch.from_numpy(stats["var"]), train)
    assert y.dtype == tdtype and mean.dtype == var.dtype == torch.float32
    wt = torch.from_numpy(w).permute(0, 3, 1, 2)
    (y.float() * wt).sum().backward()
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()
    return (nhwc(y), {"mean": mean.numpy(), "var": var.numpy()},
            nhwc(xt.grad), {"scale": mod.scale.grad.numpy(),
                            "bias": mod.bias.grad.numpy()})


def _case_inputs(k, train):
    return _inputs(seed=k + 10 * train)


CASES = ([("flax", 1)] + [("subset", k) for k in (1, 2, 4)])
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_results():
    """Every case's jax.grad results, in one jitted call (one compile),
    keyed (kind, k, dtype, train)."""
    keys = [(kind, k, dtype, train) for kind, k in CASES
            for dtype in DTYPES for train in (True, False)
            if train or k == 1]
    inputs = {key: _case_inputs(key[1], key[3]) for key in keys}

    @jax.jit
    def run(inputs):
        return {key: _jax_side(key[0], key[3], DTYPES[key[2]][0], key[1],
                               *args) for key, args in inputs.items()}

    # one call: a light backend optimization level halves its compile
    return jax.device_get(run.lower(inputs).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})(inputs))


# in eval mode stats_every plays no part: the subset module's eval case
# is checked once, at k = 1
@pytest.mark.parametrize("kind,k,train", [
    case + (train,) for case in CASES for train in (True, False)
    if train or case[1] == 1], ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batch_norm_matches_jax(kind, k, dtype, train, jax_results):
    x, variables, w = _case_inputs(k, train)
    key = (kind, k, dtype, train)
    jy, jstats, jgx, jgp = jax_results[key]
    ty, tstats, tgx, tgp = _torch_side(kind, train, DTYPES[dtype][1], k, x,
                                       variables, w)
    if dtype == "f32":
        tol, grad_tol, param_ref = F32_TOL, F32_GRAD_TOL, jgp
    else:
        tol, grad_tol = BF16_TOL, BF16_GRAD_TOL
        # the f32 case: the same bf16-representable inputs
        param_ref = jax_results[(kind, k, "f32", train)][3]
    _close(ty, jy, tol, "y")
    for name in ("mean", "var"):
        _close(tstats[name], jstats[name], F32_TOL, name)
    _close(tgx, jgx, grad_tol, "dx")
    for name in ("scale", "bias"):
        _close(tgp[name], param_ref[name], grad_tol, "d" + name)


def test_running_statistics_are_biased_and_not_in_place():
    """The running variance blends the *biased* batch variance (not
    F.batch_norm's unbiased one), and the statistics passed in are
    returned updated, never written."""
    x, variables, _ = _inputs(seed=3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ra_mean = torch.from_numpy(variables["batch_stats"]["mean"].copy())
    ra_var = torch.from_numpy(variables["batch_stats"]["var"].copy())
    before = ra_mean.clone(), ra_var.clone()
    mod = tbn.BatchNorm(SHAPE[-1], device="cpu")
    _, mean, var = mod(xt, ra_mean, ra_var, True)
    torch.testing.assert_close(ra_mean, before[0], rtol=0, atol=0)
    torch.testing.assert_close(ra_var, before[1], rtol=0, atol=0)
    batch_var = x.reshape(-1, SHAPE[-1]).var(0)  # numpy: biased
    np.testing.assert_allclose(var.numpy(),
                               0.9 * before[1].numpy() + 0.1 * batch_var,
                               rtol=1e-5)
    np.testing.assert_allclose(
        mean.numpy(), 0.9 * before[0].numpy()
        + 0.1 * x.reshape(-1, SHAPE[-1]).mean(0), rtol=1e-5, atol=1e-6)


def test_constant_channel_gradient_matches_jax():
    """A channel with zero spread (var clamped at 0, the tie of jax's
    max) takes half the gradient through E[x^2] - E[x]^2, as jax.grad
    gives it."""
    x, variables, w = _inputs(seed=4)
    x[..., 2] = 0.0
    jy, _, jgx, jgp = jax.device_get(jax.jit(
        lambda *a: _jax_side("flax", True, jnp.float32, 1, *a))(
            x, variables, w))
    ty, _, tgx, tgp = _torch_side("flax", True, torch.float32, 1, x,
                                  variables, w)
    _close(ty, jy, F32_TOL, "y")
    _close(tgx, jgx, F32_GRAD_TOL, "dx")
    _close(tgp["scale"], jgp["scale"], F32_GRAD_TOL, "dscale")
