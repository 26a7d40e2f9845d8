"""Learning-rate schedules with the reference's semantics, as step -> lr
callables: ``edl_tpu/runtime/lr_schedules.py`` in plain Python over the
step count, for :func:`edl_tpu_torch.runtime.optim.scale_by_schedule`
(which calls a schedule with the optimizer's int count).

Reference parity: example/collective/resnet50/train_with_fleet.py:114-225 —
linear warmup followed by piecewise or cosine decay, with the base lr
linearly scaled by total batch size / 256 ("lr_scale" rule). The
arithmetic is the JAX package's, in float32 (numpy scalars), and a
schedule returns the float32 value as a Python float.
"""

import math

import numpy as np

_F32 = np.float32


def linear_warmup(base_schedule, warmup_steps, start_lr=0.0):
    def schedule(step):
        step = _F32(step)
        if step < warmup_steps:
            return float(_F32(start_lr) + (
                _F32(base_schedule(warmup_steps)) - _F32(start_lr))
                * (step / _F32(max(warmup_steps, 1))))
        return base_schedule(step)
    return schedule


def piecewise_decay(base_lr, boundaries, gamma=0.1):
    """lr = base_lr * gamma^(number of boundaries passed)."""
    bs = np.asarray(boundaries, np.float32)

    def schedule(step):
        idx = int(np.sum(_F32(step) >= bs))
        return float(_F32(base_lr) * np.power(_F32(gamma), _F32(idx)))
    return schedule


def cosine_decay(base_lr, total_steps, final_lr=0.0):
    def schedule(step):
        frac = np.clip(_F32(step) / _F32(max(total_steps, 1)),
                       _F32(0.0), _F32(1.0))
        return float(_F32(final_lr) + (_F32(base_lr) - _F32(final_lr))
                     * _F32(0.5) * (_F32(1.0) + np.cos(_F32(math.pi)
                                                       * frac)))
    return schedule


def scale_lr_for_batch(base_lr, total_batch_size, base_batch_size=256):
    """The linear-scaling rule the reference applies (train_with_fleet.py
    lr = lr * total_batch/256)."""
    return base_lr * (total_batch_size / float(base_batch_size))
