"""BatchNorm of the port: ``flax.linen.BatchNorm`` and the JAX package's
``SubsetBatchNorm`` (``edl_tpu/ops/batch_norm.py``), each in its own
order of operations, over dim 1 (the channels of NCHW; the JAX modules
normalize the trailing axis of NHWC, which is the same tensor in the
``channels_last`` memory format).

Variables carry flax's names and dtypes: parameters ``scale`` and
``bias`` (f32), batch statistics ``mean`` and ``var`` (f32, running
averages). The running statistics are state passed in and returned,
never buffers updated in place, so a recompute under activation
checkpointing cannot apply an update twice.

Train statistics, as both JAX modules take them: ``E[x]`` and ``E[x^2]``
in f32, ``var = max(E[x^2] - E[x]^2, 0)`` (the *biased* variance, where
``F.batch_norm`` keeps an unbiased running variance), running update
``momentum * running + (1 - momentum) * batch``. The two differ in how
they normalize:

- :class:`BatchNorm` (flax 0.12's ``_normalize``): ``(x - mean) *
  (rsqrt(var + eps) * scale) + bias`` in f32 (a bf16 input is promoted
  by the f32 mean), cast to the compute dtype once at the end. Its
  train-mode forward and backward are one ``torch.autograd.Function``
  with the closed-form gradient (through the statistics, as
  ``jax.grad`` differentiates them), which saves only the input and
  per-channel f32 vectors;
- :class:`SubsetBatchNorm`: statistics from ``x[::k]`` along the batch
  (a strided view) when the batch holds at least ``k`` rows, and the
  folded form ``x * a + b`` with ``a = scale * rsqrt(var + eps)`` and
  ``b = bias - mean * a`` cast to the compute dtype first (in bf16 at
  bf16 rounding). Plain autograd differentiates it, as JAX does.
"""

import contextlib

import torch
from torch import nn


def _dims(x):
    """Every dim but the channels (dim 1)."""
    return (0,) + tuple(range(2, x.ndim))


def _channel(v, x):
    """A per-channel [C] vector shaped to broadcast against ``x``."""
    return v.reshape((1, -1) + (1,) * (x.ndim - 2))


def _f32(x):
    """``x`` promoted to at least f32, as flax promotes its statistics."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scope(name):
    """A profiler range named ``name`` while a profiler records (so a
    profile can tell BatchNorm's kernels from the other elementwise
    ones), else nothing: an idle range still costs a dispatcher call."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _fast_stats(x32):
    """``(E[x], E[x^2] - E[x]^2)`` of the f32 ``x32`` over every dim but
    1 (flax's ``use_fast_variance`` form); the variance is the second
    clamped at 0."""
    dims = _dims(x32)
    mean = x32.mean(dims)
    return mean, x32.square().mean(dims) - mean * mean


def _normalize(x32, scale, bias, mean, var, eps, dtype):
    """flax's ``_normalize`` of the f32 ``x32``: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in f32, then ``dtype``."""
    mul = torch.rsqrt(var + eps) * scale
    y = torch.addcmul(_channel(bias, x32), x32 - _channel(mean, x32),
                      _channel(mul, x32))
    return y.to(dtype)


class _BatchNormTrain(torch.autograd.Function):
    """flax BatchNorm in train mode: statistics of ``x``, normalized
    output, and the closed-form backward of both (what ``jax.grad``
    gives for flax's forward). Returns ``(y, mean, var)``; the
    statistics are not differentiable outputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, dtype):
        with _scope("batch_norm"):
            # one f32 copy for the statistics and the output; the
            # backward saves x itself (half the bytes in bf16)
            x32 = _f32(x)
            mean, spread = _fast_stats(x32)
            var = torch.clamp_min(spread, 0.0)
            y = _normalize(x32, scale, bias, mean, var, eps, dtype)
        ctx.save_for_backward(x, scale, mean, spread)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _gmean, _gvar):
        with _scope("batch_norm_backward"):
            x, scale, mean, spread = ctx.saved_tensors
            dims = _dims(x)
            n = x.numel() // x.shape[1]
            g32 = _f32(g)
            xc = _f32(x) - _channel(mean, x)
            sum_g = g32.sum(dims)
            sum_gxc = (g32 * xc).sum(dims)
            var = torch.clamp_min(spread, 0.0)
            r = torch.rsqrt(var + ctx.eps)
            # y = xc * (r * scale) + bias; d rsqrt(a) = -0.5 rsqrt(a) / a
            # (jax's rule); var = max(spread, 0) passes its gradient where
            # spread > 0 and half of it at 0 (jax's tie rule for max)
            dvar = scale * sum_gxc * (-0.5 * r / (var + ctx.eps))
            dm2 = dvar * torch.where(spread > 0, 1.0,
                                     torch.where(spread == 0, 0.5, 0.0))
            dmean = -(r * scale) * sum_g - 2.0 * mean * dm2
            # x enters through (x - mean), E[x] and E[x^2]:
            # dx = g r scale + dmean / n + 2 x dm2 / n, with x = xc + mean
            b = 2.0 * dm2 / n
            c = dmean / n + mean * b
            dx = torch.addcmul(_channel(c, x), xc, _channel(b, x))
            dx.addcmul_(g32, _channel(r * scale, x))
            return dx.to(x.dtype), sum_gxc * r, sum_g, None, None


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum, epsilon, dtype, param_dtype=f32)``
    over dim 1. ``scale_init`` is the constant the scale starts at (1,
    or 0 for a residual branch's last norm)."""

    def __init__(self, features, dtype=torch.float32, device=None,
                 momentum=0.9, epsilon=1e-5, scale_init=1.0):
        super().__init__()
        self.dtype, self.momentum, self.epsilon = dtype, momentum, epsilon
        self.scale_init = float(scale_init)
        self.scale = nn.Parameter(torch.full((features,), self.scale_init,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def init_weights(self, generator=None):
        self.scale.fill_(self.scale_init)
        self.bias.zero_()

    def _update(self, ra_mean, ra_var, mean, var):
        m = self.momentum
        return (m * ra_mean + (1 - m) * mean.detach(),
                m * ra_var + (1 - m) * var.detach())

    def forward(self, x, ra_mean, ra_var, train):
        """``(y, mean, var)``: the output in ``dtype`` and the running
        statistics, updated when ``train`` (else those given)."""
        if not train:
            with _scope("batch_norm"):
                y = _normalize(_f32(x), self.scale, self.bias, ra_mean,
                               ra_var, self.epsilon, self.dtype)
            return y, ra_mean, ra_var
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                             self.epsilon, self.dtype)
        return (y,) + self._update(ra_mean, ra_var, mean, var)


class SubsetBatchNorm(BatchNorm):
    """The JAX package's ``SubsetBatchNorm``: train statistics from
    every ``stats_every``-th row of the batch (all rows when
    ``stats_every <= 1`` or the batch is smaller), and the folded
    ``x * a + b`` in the compute dtype."""

    def __init__(self, features, dtype=torch.float32, device=None,
                 momentum=0.9, epsilon=1e-5, scale_init=1.0, stats_every=1):
        super().__init__(features, dtype, device, momentum, epsilon,
                         scale_init)
        self.stats_every = stats_every

    def forward(self, x, ra_mean, ra_var, train):
        if train:
            k = max(1, self.stats_every)
            s = x[::k] if k > 1 and x.shape[0] >= k else x
            dims = _dims(s)
            mean = _f32(s).mean(dims)
            m2 = _f32(s).square().mean(dims)
            # torch.maximum splits a tie's gradient, as jnp.maximum does
            var = torch.maximum(m2 - mean * mean, m2.new_zeros(()))
        else:
            mean, var = ra_mean, ra_var
        inv = self.scale * torch.rsqrt(var + self.epsilon)
        a = _channel(inv.to(self.dtype), x)
        b = _channel((self.bias - mean * inv).to(self.dtype), x)
        y = x.to(self.dtype) * a + b
        if not train:
            return y, ra_mean, ra_var
        return (y,) + self._update(ra_mean, ra_var, mean, var)
