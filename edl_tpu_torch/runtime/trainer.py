"""Train-step builders of the port: ``edl_tpu/runtime/trainer.py``'s
``make_train_state``, named remat policies, ``make_train_step``,
``make_multi_step``, the eager ``make_accum_step`` and
``auto_grad_accum``, on one device.

A train state is the JAX package's dict ``{"params", "opt_state",
"step", "extra"}``: ``params`` a flat ``{name: tensor}`` state (as
``models.gpt.create_model_and_loss`` returns it), ``opt_state`` a
``runtime.optim`` state, ``step`` an int32 scalar tensor on the host.
A step returns a new state and leaves the old one as it was, as a jitted
JAX step does (``update`` and ``apply_updates`` are functional).
Gradients come from ``torch.autograd.grad`` over fresh leaves of the
params, which the loss reads through ``torch.func.functional_call``.

Where JAX splits a key with ``jax.random.fold_in``, the port derives a
``torch.Generator`` from ``(seed, index)`` (:func:`fold_in`): the streams
differ from JAX's, as any two frameworks' do.

``ElasticTrainer`` (slice 5) and the mesh, DDP and the overlapped
accumulation (ROADMAP A12) are not ported yet.
"""

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from edl_tpu_torch.runtime import optim
from edl_tpu_torch.utils.logger import logger

_aten = torch.ops.aten


def make_train_state(params, tx, extra_state=None):
    """The canonical train-state dict shared by the step builders and
    the bench."""
    return {
        "params": params,
        "opt_state": tx.init(params),
        "step": torch.zeros((), dtype=torch.int32),
        "extra": extra_state if extra_state is not None else {},
    }


def _save_only(*ops):
    """Selective checkpointing that keeps the outputs of ``ops`` (aten
    op packets) and recomputes everything else."""
    def policy(ctx, op, *args, **kwargs):
        if getattr(op, "overloadpacket", op) in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: create_selective_checkpoint_contexts(policy)


# named activation-recompute policies over the whole loss, the JAX
# package's jax.checkpoint policies: "full" saves nothing, "dots" the
# outputs of the matrix products, "dots_no_batch" those without a batch
# dimension. Per-layer recompute is the models' own ``remat`` flag.
_REMAT_POLICIES = {
    "full": lambda: None,
    "dots": lambda: _save_only(_aten.mm, _aten.addmm, _aten.bmm),
    "dots_no_batch": lambda: _save_only(_aten.mm, _aten.addmm),
}


def _remat_wrapper(remat_policy):
    """Validate ``remat_policy`` eagerly and return the loss wrapper
    (identity for None): ``torch.utils.checkpoint`` (non-reentrant) with
    the policy's context."""
    if remat_policy is not None and remat_policy not in _REMAT_POLICIES:
        raise ValueError("remat_policy %r not in %s"
                         % (remat_policy, sorted(_REMAT_POLICIES)))

    def wrap(fn):
        if remat_policy is None:
            return fn
        context_fn = _REMAT_POLICIES[remat_policy]()
        kw = {"context_fn": context_fn} if context_fn else {}
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        **kw)

    return wrap


def fold_in(rng, data, device="cpu"):
    """A generator for stream ``data`` of ``rng`` (an int seed or a
    ``torch.Generator``, whose initial seed is used), seeded from the
    pair by numpy's ``SeedSequence``: the port's ``jax.random.fold_in``.
    None stays None."""
    if rng is None:
        return None
    seed = rng.initial_seed() if isinstance(rng, torch.Generator) \
        else int(rng)
    mixed = np.random.SeedSequence([seed, int(data)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(v) for v in tree)
    return tree


def _value_and_grad(compute, params, has_aux):
    """(loss, aux, grads) of ``compute(params)`` by
    ``torch.autograd.grad`` over fresh leaves; a param the loss does not
    reach gets a zero gradient, as in JAX."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    with torch.enable_grad():
        out = compute(leaves)
        loss, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(leaves.items(), grads)}
    return loss.detach(), _detach(aux), grads


def _apply(train_state, tx, grads, extra):
    params = train_state["params"]
    updates, opt_state = tx.update(grads, train_state["opt_state"], params)
    return {
        "params": optim.apply_updates(params, updates),
        "opt_state": opt_state,
        "step": train_state["step"] + 1,
        "extra": extra,
    }


def make_train_step(loss_fn, tx, has_aux=False, remat_policy=None):
    """Build the canonical step over a :func:`make_train_state` dict.

    loss_fn: (params, batch, rng) -> loss, or with has_aux
    (params, extra, batch, rng) -> (loss, new_extra). Returns
    step(train_state, batch, rng) -> (train_state, loss).

    remat_policy: None or one of "full"|"dots"|"dots_no_batch" — wraps
    the loss in ``torch.utils.checkpoint`` with the named policy. Combine
    with the models' own per-layer ``remat`` flag."""
    maybe_remat = _remat_wrapper(remat_policy)

    def step(train_state, batch, rng):
        if has_aux:
            compute = maybe_remat(lambda p: loss_fn(
                p, train_state["extra"], batch, rng))
        else:
            compute = maybe_remat(lambda p: loss_fn(p, batch, rng))
        loss, aux, grads = _value_and_grad(compute, train_state["params"],
                                           has_aux)
        extra = aux if has_aux else train_state["extra"]
        return _apply(train_state, tx, grads, extra), loss

    return step


def _microbatch(batches, i):
    return {key: val[i] for key, val in batches.items()}


def make_multi_step(loss_fn, tx, steps_per_call, has_aux=False,
                    remat_policy=None):
    """``steps_per_call`` canonical steps in one call:
    step(train_state, batches, rng) -> (train_state, losses), every leaf
    of ``batches`` with a leading [steps_per_call] axis, losses a
    [steps_per_call] tensor.

    A Python loop (eager PyTorch has no scan to fuse it into). Each step
    gets its own generator, ``fold_in(rng, state["step"])`` seeded from
    the pair (seed, step) in place of JAX's ``fold_in`` of the key with
    the step counter, so a step's stream depends on its index alone."""
    if steps_per_call < 1:
        raise ValueError("steps_per_call must be >= 1")
    base = make_train_step(loss_fn, tx, has_aux=has_aux,
                           remat_policy=remat_policy)

    def step(train_state, batches, rng):
        losses = []
        for i in range(steps_per_call):
            train_state, loss = base(
                train_state, _microbatch(batches, i),
                fold_in(rng, int(train_state["step"])))
            losses.append(loss)
        return train_state, torch.stack(losses)

    return step


def make_accum_step(loss_fn, tx, accum_steps, has_aux=False,
                    remat_policy=None, overlap_axis=None, mesh=None):
    """Gradient accumulation: ONE optimizer update from ``accum_steps``
    microbatches.

    step(train_state, batches, rng) -> (train_state, loss) where every
    leaf of ``batches`` has a leading [accum_steps] axis and loss is the
    mean microbatch loss. Gradients are averaged over microbatches, so
    for a mean-reduced loss the update equals the whole batch's (up to
    rounding); ``extra`` chains through the microbatches in order;
    microbatch i's rng is ``fold_in(rng, i)``.

    ``overlap_axis`` without a mesh is the JAX package's degenerate case:
    there are no collectives to hide, and the eager step is returned (the
    no-op is logged). With a mesh it raises: the data-parallel overlap
    comes with the mesh (ROADMAP A12)."""
    if accum_steps < 1:
        raise ValueError("accum_steps must be >= 1")
    maybe_remat = _remat_wrapper(remat_policy)
    if overlap_axis is not None:
        if has_aux:
            raise ValueError(
                "overlap_axis is incompatible with has_aux: extra "
                "state is per-shard under shard_map and has no defined "
                "reduction")
        if mesh is not None:
            raise NotImplementedError(
                "make_accum_step over a mesh is not ported to "
                "edl_tpu_torch yet (ROADMAP A12: the mesh, DDP and the "
                "overlapped gradient reduction)")
        logger.info(
            "make_accum_step: dp overlap over %s is a no-op (no mesh) — "
            "no collectives to hide, returning the eager accumulation "
            "step unchanged", overlap_axis)

    def step(train_state, batches, rng):
        params = train_state["params"]
        extra = train_state["extra"]
        grad_sum = loss_sum = None
        for i in range(accum_steps):
            batch, rng_i = _microbatch(batches, i), fold_in(rng, i)
            if has_aux:
                compute = maybe_remat(
                    lambda p, e=extra: loss_fn(p, e, batch, rng_i))
            else:
                compute = maybe_remat(lambda p: loss_fn(p, batch, rng_i))
            loss, aux, grads = _value_and_grad(compute, params, has_aux)
            if has_aux:
                extra = aux
            if grad_sum is None:
                grad_sum, loss_sum = grads, loss
            else:
                names = list(grad_sum)
                torch._foreach_add_([grad_sum[n] for n in names],
                                    [grads[n] for n in names])
                loss_sum = loss_sum + loss
        grads = {n: g / accum_steps for n, g in grad_sum.items()}
        return _apply(train_state, tx, grads, extra), loss_sum / accum_steps

    return step


def auto_grad_accum(per_device_batch, max_per_device_batch):
    """Smallest microbatch count k (dividing ``per_device_batch``) whose
    per-device microbatch fits ``max_per_device_batch``.

    The elastic memory policy: state the per-device activation budget
    once; each stop-resume restart computes the accumulation that keeps
    total_batch_size (and so convergence) constant at the new world
    size. k = per_device_batch is always feasible (microbatch 1)."""
    if max_per_device_batch <= 0:
        raise ValueError("max_per_device_batch must be positive")
    if per_device_batch < 1:
        raise ValueError("per_device_batch must be >= 1")
    for k in range(1, per_device_batch + 1):
        if per_device_batch % k == 0 \
                and per_device_batch // k <= max_per_device_batch:
            return k
    raise AssertionError("unreachable: k == per_device_batch always fits")
