"""The optax transforms the JAX package trains with, on dicts of tensors.

``sgd``, ``adam`` and ``adamw`` with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8, eps_root 0, and AdamW's weight decay **1e-4**, where torch's
``AdamW`` defaults to 0.01), built as optax builds them: a chain of
``trace`` / ``scale_by_adam``, ``add_decayed_weights`` and
``scale_by_learning_rate``. Each is an ``init / update`` pair over a
params dict ``{name: tensor}``, and :func:`apply_updates` adds the
updates. The state is laid out as optax's, one entry per link of the
chain: ``{"count", "mu", "nu"}`` for Adam (count an int32 scalar
tensor, kept on the host), ``{"trace"}`` for momentum, ``{"count"}``
where a schedule drives the learning rate, ``{}`` for a stateless link,
so a checkpoint can carry it leaf for leaf.

The arithmetic is optax's, in f32 and in its order (``(1 - b1) g + b1
mu``; the bias correction ``1 - b**count`` taken in f32); the
multi-tensor ``torch._foreach_*`` calls do it for all leaves at once.
``update`` is functional: it returns new update and state tensors and
leaves its inputs untouched, as optax does.
"""

from typing import Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and
    ``update(updates, state, params=None) -> (updates, state)``."""
    init: Callable
    update: Callable


def _values(tree, names):
    return [tree[n] for n in names]


def _zeros_like(params):
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _count0(params):
    # on the host, so that the bias correction and a schedule read it
    # without waiting for the device
    return torch.zeros((), dtype=torch.int32)


def _count_inc(count):
    # optax's safe_increment: saturate at the int32 maximum
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1,
                       count)


def identity():
    """The stateless no-op link."""
    return GradientTransformation(lambda params: {},
                                  lambda updates, state, params=None:
                                  (updates, state))


def chain(*transforms):
    """Apply ``transforms`` in order; the state is the tuple of theirs."""
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def trace(decay, nesterov=False):
    """Momentum: ``t = g + decay * t``; the update is ``t`` (or ``g +
    decay * t`` with nesterov)."""
    def init(params):
        return {"trace": _zeros_like(params)}

    def update(updates, state, params=None):
        names = list(updates)
        g = _values(updates, names)
        t = torch._foreach_add(g, torch._foreach_mul(
            _values(state["trace"], names), decay))
        out = torch._foreach_add(g, torch._foreach_mul(t, decay)) \
            if nesterov else t
        return dict(zip(names, out)), {"trace": dict(zip(names, t))}

    return GradientTransformation(init, update)


def _bias_correction(moments, decay, count):
    """optax's ``moment / (1 - decay**count)``, the factor in f32."""
    factor = 1.0 - torch.pow(torch.tensor(decay, dtype=torch.float32),
                             count.to(torch.float32))
    return torch._foreach_div(moments, factor.item())


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """Adam's rescaling: bias-corrected first moment over the root of
    the bias-corrected second, plus eps."""
    def init(params):
        return {"count": _count0(params), "mu": _zeros_like(params),
                "nu": _zeros_like(params)}

    def update(updates, state, params=None):
        names = list(updates)
        g = _values(updates, names)
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1),
                                torch._foreach_mul(
                                    _values(state["mu"], names), b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2),
            torch._foreach_mul(_values(state["nu"], names), b2))
        count = _count_inc(state["count"])
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        if eps_root:
            nu_hat = torch._foreach_add(nu_hat, eps_root)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
        out = torch._foreach_div(mu_hat, denom)
        return dict(zip(names, out)), {"count": count,
                                       "mu": dict(zip(names, mu)),
                                       "nu": dict(zip(names, nu))}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay=0.0, mask=None):
    """``g + weight_decay * p`` (where ``mask(params)[name]`` is true, if
    a mask is given)."""
    def init(params):
        return {}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        keep = mask(params) if callable(mask) else mask
        out = dict(updates)
        names = [n for n in updates if keep is None or keep[n]]
        decayed = torch._foreach_add(
            _values(updates, names),
            torch._foreach_mul(_values(params, names), weight_decay))
        out.update(zip(names, decayed))
        return out, state

    return GradientTransformation(init, update)


def scale_by_schedule(step_size_fn):
    """Multiply by ``step_size_fn(count)``, count from 0."""
    def init(params):
        return {"count": _count0(params)}

    def update(updates, state, params=None):
        names = list(updates)
        step = float(step_size_fn(int(state["count"])))
        out = torch._foreach_mul(_values(updates, names), step)
        return dict(zip(names, out)), {"count": _count_inc(state["count"])}

    return GradientTransformation(init, update)


def scale(step_size):
    """Multiply by a constant."""
    def update(updates, state, params=None):
        names = list(updates)
        out = torch._foreach_mul(_values(updates, names), step_size)
        return dict(zip(names, out)), state

    return GradientTransformation(lambda params: {}, update)


def scale_by_learning_rate(learning_rate):
    """``-learning_rate`` times the updates: a constant, or a schedule
    ``count -> rate``."""
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -learning_rate(count))
    return scale(-learning_rate)


def sgd(learning_rate, momentum=None, nesterov=False):
    """optax.sgd: plain, or with momentum (``trace``)."""
    return chain(trace(momentum, nesterov) if momentum is not None
                 else identity(),
                 scale_by_learning_rate(learning_rate))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """optax.adam."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          weight_decay=1e-4, mask=None):
    """optax.adamw: decoupled weight decay, optax's default of 1e-4."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(learning_rate))


def apply_updates(params, updates):
    """``p + u`` for every leaf, in the param's dtype."""
    names = list(params)
    out = torch._foreach_add(_values(params, names),
                             _values(updates, names))
    return {n: o.to(params[n].dtype) for n, o in zip(names, out)}
