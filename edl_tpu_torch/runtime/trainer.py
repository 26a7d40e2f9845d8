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

:class:`ElasticTrainer` is the JAX package's elastic harness on one
device and one process: checkpoint save (dense, or the async stream
engine) and resume with the State's adjust hooks, the flag-only SIGTERM
handler with its emergency checkpoint and exit-101 convention, epochs
and status reports, and :meth:`ElasticTrainer.fit`. What needs more
than one device or the launcher raises ``NotImplementedError`` naming
its ROADMAP item: a mesh, ZeRO-1 and param shardings (A12, A19), a
launcher world above 1 (A12), the launcher's store client, the peer
restore and redundancy planes, prewarm and live resize (A17).
"""

import atexit
import json
import os
import sys
import time
import weakref

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from edl_tpu_torch.controller import train_status as train_status_mod
from edl_tpu_torch.controller.env import TrainerEnv
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import flight as obs_flight
from edl_tpu_torch.obs import ledger as obs_ledger
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.runtime import checkpoint as checkpoint_mod
from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime import state as state_mod
from edl_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                              MissingKeysError)
from edl_tpu_torch.runtime.preemption import PreemptionGuard
from edl_tpu_torch.utils.device import resolve_device
from edl_tpu_torch.utils.errors import PreemptedError
from edl_tpu_torch.utils.logger import logger

_STEP_MS = obs_metrics.histogram(
    "edl_train_step_ms", "train_step wall time (host dispatch)")

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


def _not_ported(what, item):
    return NotImplementedError(
        "%s is not ported to edl_tpu_torch yet (ROADMAP %s)" % (what, item))


def maybe_init_distributed(env=None):
    """The launcher's env contract on one process: returns the
    ``TrainerEnv``. A world above 1 (``torch.distributed`` from the
    contract) comes with the mesh and raises until then."""
    env = env or TrainerEnv()
    if env.world_size > 1:
        raise _not_ported("a launcher world of %d processes"
                          % env.world_size, "A12")
    return env


def _x64():
    """The port's ``jax_enable_x64``: torch's default dtype is float64."""
    return torch.get_default_dtype() == torch.float64


def _as_tensor(leaf, device):
    """A state leaf as a tensor on ``device``. Python scalars take
    JAX's weak types: int32 and float32 (64-bit under :func:`_x64`)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device)
    if isinstance(leaf, (bool, int, float)) and not isinstance(
            leaf, np.generic):
        dtype = (torch.bool if isinstance(leaf, bool) else
                 torch.get_default_dtype() if isinstance(leaf, float) else
                 torch.int64 if _x64() else torch.int32)
        return torch.tensor(leaf, dtype=dtype, device=device)
    return torch.from_numpy(np.array(leaf)).to(device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _leaves(tree):
    return [leaf for _, leaf in checkpoint_mod._flatten(tree)]


class ElasticTrainer(object):
    """Data-parallel elastic trainer, on one device: the JAX package's
    ``ElasticTrainer`` with its arguments and checks.

    Args:
      loss_fn: (params, batch, rng) -> scalar loss, or with has_aux=True
        (params, extra, batch, rng) -> (loss, new_extra) where ``extra`` is
        non-differentiated model state updated each step (e.g. BatchNorm
        running stats) — kept inside the train_state.
      params: initial parameter dict ``{name: tensor}``.
      tx: a ``runtime.optim`` GradientTransformation.
      total_batch_size: GLOBAL batch size (the batch of one update).
      checkpoint_dir: shared directory for elastic resume ('' disables;
        None takes the launcher's ``EDL_TPU_CHECKPOINT_PATH``).
      grad_accum / max_per_device_batch: microbatches per update, or
        a per-device batch budget they are chosen from
        (``auto_grad_accum``).
      step_fn: a custom step (train_state, batch, rng) -> (train_state,
        loss) replacing the canonical one; exclusive with the loss-level
        knobs.
      async_save: save through the async stream engine (also
        ``EDL_TPU_ASYNC_SAVE``).
      device: where the state lives; None means CUDA (and raises
        without a card).

    ``mesh``, ``zero1``, ``param_shardings``, a coordination store under
    the launcher and the peer-restore plane raise ``NotImplementedError``
    naming their ROADMAP item. ``dp_overlap`` on one device is the JAX
    package's no-op (there are no collectives to hide).
    """

    def __init__(self, loss_fn, params, tx, total_batch_size,
                 checkpoint_dir=None, mesh=None, env=None, coord=None,
                 keep_checkpoints=3, extra_state=None, has_aux=False,
                 async_save=False, remat_policy=None,
                 param_shardings=None, grad_accum=1, zero1=False,
                 max_per_device_batch=None, step_fn=None,
                 dp_overlap=False, device=None):
        if step_fn is not None and (has_aux or grad_accum != 1
                                    or remat_policy is not None
                                    or max_per_device_batch is not None
                                    or dp_overlap):
            raise ValueError(
                "step_fn owns the whole step: has_aux/grad_accum/"
                "remat_policy/max_per_device_batch/dp_overlap do not "
                "apply")
        if dp_overlap and has_aux:
            raise ValueError("dp_overlap is incompatible with has_aux "
                             "(see make_accum_step)")
        if dp_overlap and (zero1 or param_shardings is not None):
            raise ValueError(
                "dp_overlap requires replicated params/opt state "
                "(plain DP): zero1/param_shardings shard the state, and "
                "the overlap shard_map only builds replicated specs")
        if mesh is not None:
            raise _not_ported("ElasticTrainer over a mesh", "A12")
        if zero1:
            raise _not_ported("ZeRO-1 (optimizer state sharded over dp)",
                              "A12/A19")
        if param_shardings is not None:
            raise _not_ported("param_shardings", "A19")
        self._dp_overlap = dp_overlap
        self._step_fn = step_fn
        self.env = env or TrainerEnv()
        maybe_init_distributed(self.env)
        self.device = resolve_device(device)
        if checkpoint_dir is None:
            # default to the launcher-provided shared checkpoint path
            checkpoint_dir = self.env.checkpoint_path
        self.total_batch_size = total_batch_size
        self._loss_fn = loss_fn
        self._tx = tx
        self._has_aux = has_aux
        self._remat_policy = remat_policy
        if grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        # one device: every row of the global batch is this device's
        self.per_device_batch = total_batch_size
        self.per_host_batch = total_batch_size
        if max_per_device_batch is not None:
            if grad_accum != 1:
                raise ValueError(
                    "pass either grad_accum or max_per_device_batch, not "
                    "both — the budget exists to CHOOSE the accumulation")
            grad_accum = auto_grad_accum(self.per_device_batch,
                                         max_per_device_batch)
        if grad_accum > 1 and total_batch_size % grad_accum != 0:
            raise ValueError("per-device batch %d not divisible by "
                             "grad_accum %d" % (total_batch_size,
                                                grad_accum))
        self._grad_accum = grad_accum
        if extra_state is not None and not _x64():
            for leaf in _leaves(extra_state):
                # explicit 64-bit leaves only: Python scalars take the
                # weak 32-bit types. torch.tensor(0) is int64: the trap
                dt = (leaf.dtype if isinstance(leaf, torch.Tensor)
                      else leaf.dtype
                      if isinstance(leaf, (np.ndarray, np.generic))
                      else None)
                if dt is None:
                    continue
                wide = (dt.itemsize == 8 and not dt.is_complex
                        if isinstance(dt, torch.dtype)
                        else dt.kind in "iuf" and dt.itemsize == 8)
                if wide:
                    raise ValueError(
                        "extra_state leaf has 64-bit dtype %s, which the "
                        "JAX package would silently truncate to 32-bit "
                        "on device (its checkpoints would not carry "
                        "across); keep host-side metadata (file offsets, "
                        "loader positions) in trainer.state.user_defined "
                        "instead" % dt)
        self.state = state_mod.State(total_batch_size=total_batch_size)
        params = {n: p.detach().to(self.device) for n, p in params.items()}
        self.train_state = make_train_state(
            params, tx, _tree_map(lambda x: _as_tensor(x, self.device),
                                  extra_state)
            if extra_state is not None else None)

        self._ckpt = (CheckpointManager(checkpoint_dir,
                                        keep=keep_checkpoints)
                      if checkpoint_dir else None)
        if self._ckpt is not None and self.env.global_rank == 0:
            # crashed-attempt garbage
            try:
                self._ckpt.clean_uncommitted()
            except Exception:
                logger.exception("uncommitted-checkpoint cleanup failed")
        self.coord = coord
        if self.coord is None and self.env.under_launcher:
            raise _not_ported("the launcher's coordination-store client "
                              "(CoordClient)", "A17")
        if (self._ckpt is not None and self.coord is not None
                and os.environ.get("EDL_TPU_PEER_RESTORE", "1") != "0"):
            raise _not_ported("the peer-restore and redundancy planes "
                              "(set EDL_TPU_PEER_RESTORE=0 to restore "
                              "from the filesystem only)", "A17")
        # per-incarnation resize timing record (docs/elastic_resize.md)
        self._resize_timing = {"t_construct": time.time(),
                               "mode": "stop_resume"}
        self._run_step = self._build_step()
        # the first step of this incarnation stamps compile_s and
        # first_step_s into _resize_timing
        self._stamp_first_step = True
        self._step_times = []
        # host-side mirror of the step counter: seeds default rngs
        self._host_step = 0
        env_async = os.environ.get("EDL_TPU_ASYNC_SAVE")
        if env_async is not None:
            async_save = env_async not in ("0", "")
        self._async_save = async_save
        # flag-only SIGTERM handler + drain hook: every preemption exit
        # path drains the checkpoint engine's in-flight async persist
        self._guard = PreemptionGuard(drain=self.wait_for_save)
        self._preempt_armed = False
        # process exit must not lose the final checkpoint mid-write;
        # registered via weakref so the registry pins no trainer
        ref = weakref.ref(self)
        atexit.register(lambda: (lambda t: t and t.wait_for_save())(ref()))

    # -- the step ------------------------------------------------------------

    def _build_step(self):
        if self._step_fn is not None:
            return self._step_fn
        if self._grad_accum > 1:
            return make_accum_step(self._loss_fn, self._tx,
                                   self._grad_accum, self._has_aux,
                                   remat_policy=self._remat_policy,
                                   overlap_axis="dp" if self._dp_overlap
                                   else None)
        if self._dp_overlap:
            logger.info("dp_overlap ignored: grad_accum == 1 leaves no "
                        "next microbatch to overlap the gradient "
                        "all-reduce with")
        return make_train_step(self._loss_fn, self._tx, self._has_aux,
                               remat_policy=self._remat_policy)

    def prewarm_resize_compiles(self, world_sizes, block=True):
        raise _not_ported("prewarm_resize_compiles", "A17")

    def live_resize(self, n_devices, mesh_shape=None):
        raise _not_ported("live_resize", "A17")

    def enable_live_resize(self, who=None):
        raise _not_ported("enable_live_resize", "A17")

    def local_batch_slice(self, full_batch):
        """Slice a FULL global batch down to the rows this process must
        supply: the first ``total_batch_size``, all of them on one
        device."""
        return _tree_map(lambda x: x[:self.per_host_batch], full_batch)

    def shard_batch(self, host_batch):
        """The host batch on the trainer's device (one H2D copy per
        leaf)."""
        def put(x):
            if isinstance(x, torch.Tensor):
                return x.to(self.device)
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return _tree_map(put, host_batch)

    def train_step(self, host_batch, rng=None):
        t0 = time.perf_counter()
        if not self._stamp_first_step:
            obs_ledger.LEDGER.transition("compute")
        if rng is None:
            rng = fold_in(0, self._host_step, device=self.device)
        if self._grad_accum > 1:
            k = self._grad_accum
            host_batch = _tree_map(
                lambda x: x.reshape((k, x.shape[0] // k) + tuple(
                    x.shape[1:])), host_batch)
        batch = self.shard_batch(host_batch)
        self.train_state, loss = self._run_step(self.train_state, batch,
                                                rng)
        if self._stamp_first_step:
            self._stamp_first_step = False
            # the first call's wall is mostly one-time setup (cuDNN's
            # algorithm search, the allocator's growth); the wait to
            # its result is the first real step
            c1 = time.perf_counter()
            self._resize_timing["compile_s"] = c1 - t0
            if loss.is_cuda:
                torch.cuda.synchronize(loss.device)
            self._resize_timing["first_step_s"] = time.perf_counter() - c1
            self._resize_timing["t_first_step"] = time.time()
            obs_ledger.LEDGER.transition("compute")
            self._publish_resize_timing()
            obs_events.emit("resize.first_step",
                            rank=self.env.global_rank,
                            compile_s=self._resize_timing["compile_s"],
                            first_step_s=self._resize_timing
                            ["first_step_s"])
        self._host_step += 1
        step_s = time.perf_counter() - t0
        self._step_times.append(step_s)
        _STEP_MS.observe(step_s * 1e3)
        if self._preempted:
            self._emergency_save()
        return loss

    # -- the high-level loop -------------------------------------------------

    def fit(self, epochs, batches_fn, eval_fn=None, resume=True,
            preemption_exit_code=101, log_fn=None, signals=None,
            coordinated=None):
        """The full elastic training loop in one call: arm the
        preemption handler, resume from the newest checkpoint, iterate
        epochs (begin → train_step over ``batches_fn(epoch)`` → end +
        save), rank-0 eval, and the final SUCCEED status report.

        batches_fn(epoch) -> iterable of host batches. eval_fn(trainer,
        epoch) runs on rank 0 after each epoch's save. On preemption the
        emergency checkpoint is already written; the process exits with
        ``preemption_exit_code`` (the exit-101 restart convention) —
        pass None to get PreemptedError raised instead. Returns
        {"resumed", "steps", "final_loss", "world"}.
        """
        if not self._preempt_armed:
            self.install_preemption_handler(signals=signals,
                                            coordinated=coordinated)
        # arm the black box for this incarnation
        if obs_flight.RECORDER is None:
            obs_flight.install("trainer_r%d" % self.env.global_rank,
                               coord=self.coord)
        obs_flight.RECORDER.register_provider(
            "resize_timing", lambda: dict(self._resize_timing))
        publisher = None
        if self.coord is not None:
            from edl_tpu_torch.obs.publisher import MetricsPublisher
            pod_key = ("%s_r%d" % (self.env.pod_id,
                                   self.env.global_rank)
                       if self.env.pod_id
                       else "trainer_r%d" % self.env.global_rank)
            publisher = MetricsPublisher(self.coord, pod_key).start()
        resumed = self.resume() if resume else False
        start_epoch = self.state.next_epoch() if resumed else 0
        say = log_fn or logger.info
        say("fit: rank=%d world=%d start_epoch=%d resumed=%s"
            % (self.env.global_rank, self.world_size, start_epoch,
               resumed))
        loss = None
        try:
            for epoch in range(start_epoch, epochs):
                self.begin_epoch(epoch)
                if epoch == epochs - 1:
                    # AFTER begin_epoch: it reports RUNNING, which would
                    # clobber the scale-out-stopping NEARTHEEND verdict
                    self.report_status(train_status_mod.TrainStatus
                                       .NEARTHEEND)
                for batch in batches_fn(epoch):
                    loss = self.train_step(batch)
                self.end_epoch(save=True)
                say("fit: epoch %d done step=%d loss=%s"
                    % (epoch, self.global_step,
                       "%.5f" % float(loss) if loss is not None
                       else "n/a"))
                if eval_fn is not None and self.env.global_rank == 0:
                    eval_fn(self, epoch)
        except PreemptedError as e:
            obs_flight.dump("preempted", e)
            say("fit: preempted: %s" % e)
            if preemption_exit_code is None:
                raise
            sys.exit(preemption_exit_code)
        finally:
            obs_ledger.LEDGER.transition("idle")
            obs_ledger.LEDGER.flush()
            if publisher is not None:
                publisher.stop()  # final flush ships the full ledger
        self.report_status(train_status_mod.TrainStatus.SUCCEED)
        return {"resumed": resumed, "steps": self.global_step,
                "final_loss": None if loss is None else float(loss),
                "world": self.world_size}

    # -- preemption (grace-window emergency checkpoint) ----------------------

    def install_preemption_handler(self, signals=None, coordinated=None):
        """Arm the grace-window emergency checkpoint.

        The handler only sets a flag — async-signal-safe, and a save
        cannot run mid-step — and the next step/epoch boundary writes a
        checkpoint at the CURRENT step, then raises PreemptedError. The
        restart resumes the model at that step and RE-RUNS the
        interrupted epoch from its start (State.next_epoch). Returns
        self. ``coordinated`` (the CoordinatedStop protocol that aligns
        the stop step across ranks through the store) comes with the
        launcher and raises."""
        if coordinated:
            raise _not_ported("coordinated preemption across ranks",
                              "A17")
        self._guard.install(signals)
        self._preempt_armed = True
        return self

    @property
    def _preempted(self):
        return self._guard.preempted

    @_preempted.setter
    def _preempted(self, value):
        self._guard.preempted = bool(value)

    @property
    def preempted(self):
        return self._preempted

    def _emergency_save(self, already_saved=False):
        """Write the grace-window checkpoint and raise PreemptedError:
        the one process holds the whole state, so the normal dense save
        runs (synchronously)."""
        # drain before ANY exit below — the no-save paths must still
        # land the in-flight async version before the process dies
        self._guard.drain()
        if self._ckpt is None:
            raise PreemptedError(
                "preempted at step %d; no checkpoint dir configured — "
                "nothing saved, restart begins fresh" % self._host_step)
        if already_saved:
            raise PreemptedError(
                "preempted; checkpoint saved at step %d" % self._host_step)
        self.state.global_step = self.global_step
        logger.info("preemption signal: emergency checkpoint at "
                    "step %d", self._host_step)
        self.wait_for_save()
        was_async, self._async_save = self._async_save, False
        try:
            self.save()
        finally:
            self._async_save = was_async
        raise PreemptedError(
            "preempted; checkpoint saved at step %d" % self._host_step)

    @property
    def global_step(self):
        return int(self.train_state["step"])

    @property
    def world_size(self):
        return 1

    # -- epochs / status -----------------------------------------------------

    def begin_epoch(self, epoch_no):
        if self._preempted:
            # SIGTERM landed between epochs (eval, data setup): save at
            # this boundary rather than silently swallowing the stop
            self._emergency_save()
        self.state.begin_epoch(epoch_no, self.world_size)
        self._step_times = []
        self.report_status(train_status_mod.TrainStatus.RUNNING)

    def end_epoch(self, save=True):
        n = len(self._step_times)
        avg = sum(self._step_times) / n if n else 0.0
        self.state.end_epoch(n, avg)
        self.state.global_step = self.global_step
        if save:
            self.save()
        if self._preempted:
            # the epoch-end save (if any) already covers this step
            self._emergency_save(already_saved=save)

    def report_status(self, status):
        if self.coord is not None and self.env.pod_id:
            try:
                train_status_mod.save_train_status(self.coord,
                                                   self.env.pod_id, status)
            except Exception:
                logger.exception("train status report failed")

    # -- checkpoint / resume -------------------------------------------------

    @property
    def extra_state(self):
        return self.train_state["extra"]

    def save(self):
        """Write the versioned checkpoint + State at the current step:
        the dense npz, or with ``async_save`` the engine's two-phase
        path (a snapshot into pooled host buffers here, the write on a
        background pool, the manifest last; a new save drains the
        previous one)."""
        if self._ckpt is None:
            return
        version = self.global_step
        # deep-snapshot the control-plane state NOW — the background
        # writer must not see the live State's nested dicts mutating
        state_snapshot = json.loads(self.state.to_json())
        meta = {"state": state_snapshot,
                "sharding": checkpoint_mod.sharding_record(
                    self.train_state)}
        self.wait_for_save()
        if self.env.global_rank != 0:
            return
        if self._async_save:
            self._ckpt.save_async(
                version, dict(self.train_state), meta=meta,
                on_commit=lambda: self._save_state_to_store(
                    state_snapshot))
            return
        self._ckpt.save(version, dict(self.train_state), meta=meta)
        self._save_state_to_store(state_snapshot)

    def wait_for_save(self):
        """Block until any in-flight async checkpoint persist finishes
        (the engine's drain; a persist failure is logged there, and the
        manifest-last commit keeps the failed version invisible)."""
        if self._ckpt is not None:
            self._ckpt.drain()

    def close(self):
        """Drain any in-flight async save and shut the checkpoint
        engine's writer pool down. Idempotent."""
        self.wait_for_save()
        if self._ckpt is not None:
            self._ckpt.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _save_state_to_store(self, state_dict):
        if self.coord is not None:
            snap = state_mod.State()
            snap.from_dict(dict(state_dict))
            state_mod.save_to_store(self.coord, snap)

    def _publish_resize_timing(self):
        """Write this incarnation's resume timings to the coordination
        store (SERVICE_METRICS / resize_timing_r<rank>). Best-effort."""
        if self.coord is None:
            return
        from edl_tpu_torch.controller import constants
        doc = dict(self._resize_timing)
        doc["mesh"] = {"dp": 1}
        doc["ledger"] = {s: round(v, 6) for s, v
                         in obs_ledger.LEDGER.totals().items()}
        try:
            self.coord.set_server_permanent(
                constants.SERVICE_METRICS,
                "resize_timing_r%d" % self.env.global_rank,
                json.dumps(doc))
        except Exception:
            logger.exception("resize timing publish failed")

    @staticmethod
    def _like(tree, target):
        """``tree``'s leaves held to ``target``'s: the same shape (a
        mismatch raises), cast to the target's dtype."""
        flat = dict(checkpoint_mod._flatten(tree))
        out = {}
        for key, want in checkpoint_mod._flatten(target):
            got = flat[key]
            if tuple(got.shape) != tuple(want.shape):
                raise IOError("checkpoint shape mismatch for %r: saved %s "
                              "vs target shape %s"
                              % (key, tuple(got.shape), tuple(want.shape)))
            out[key] = got.to(want.dtype)
        return checkpoint_mod._unflatten(target, out)

    def _restore(self, version, target):
        v, tree, meta = self._ckpt.restore(version, target)
        return v, self._like(tree, target), meta or {}

    def resume(self):
        """Restore the newest valid checkpoint; apply resize adjust hooks if
        the world size changed. Returns True if something was restored."""
        if self._ckpt is None:
            return False
        # newest-first: per version, try the full state; when only the
        # extra keys are missing (legacy checkpoint), retry THAT version
        # core-only rather than falling back to an older checkpoint
        target = dict(self.train_state)
        restored = None
        self._resize_timing["t_resume_start"] = time.time()
        obs_ledger.LEDGER.transition("restore")
        obs_events.emit("resize.resume_start", rank=self.env.global_rank,
                        world_size=self.world_size)
        for version in reversed(self._ckpt.versions()):
            try:
                restored = self._restore(version, target)
                break
            except Exception as e:  # noqa: BLE001
                if isinstance(e, MissingKeysError) \
                        and _leaves(target["extra"]):
                    core = dict(target)
                    core.pop("extra")
                    try:
                        restored = self._restore(version, core)
                        logger.info("checkpoint v%d has no extra state; "
                                    "keeping the initial one", version)
                        restored[1]["extra"] = self.train_state["extra"]
                        break
                    except Exception as e2:  # noqa: BLE001
                        e = e2
                logger.warning("checkpoint v%d unusable (%r); trying older",
                               version, e)
        if restored is None:
            obs_ledger.LEDGER.transition("idle")
            return False
        version, tree, meta = restored
        self.train_state = tree
        self._resize_timing["restore_source"] = "fs"
        if meta.get("state"):
            # hooks are process-local: carry them onto the restored state
            self.state = self.state.carry_hooks_to(
                state_mod.State().from_dict(meta["state"]))
            self.state.total_batch_size = self.total_batch_size
        prev_world = (self.state.epochs.get(str(self.state.epoch_no), {})
                      .get("world_size", self.world_size))
        if prev_world != self.world_size:
            logger.info("world resized %s -> %s; applying adjust hooks",
                        prev_world, self.world_size)
            self.state.adjust(self.world_size)
        self._host_step = self.global_step
        obs_ledger.LEDGER.transition("resize_pause")
        self._resize_timing["t_resume_end"] = time.time()
        self._resize_timing["restore_s"] = (
            self._resize_timing["t_resume_end"]
            - self._resize_timing["t_resume_start"])
        self._resize_timing["version"] = version
        obs_events.emit("resize.resumed", rank=self.env.global_rank,
                        version=version,
                        restore_s=self._resize_timing["restore_s"],
                        source="fs")
        logger.info("resumed from checkpoint v%d (epoch %d, step %d)",
                    version, self.state.epoch_no, self.global_step)
        return True
