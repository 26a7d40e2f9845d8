"""Absmax per-channel weight quantization for the teacher forward.

The port's counterpart of ``edl_tpu/ops/quant.py``, in plain torch (no
kernel). Serving at small batch is weight-bandwidth-bound, so teacher
kernels can be stored as int8 (absmax per output channel, f32 scales) or
bf16 and dequantized inside the forward.

Scheme (int8): for a kernel ``w`` with input axis 0 (the port keeps the
JAX package's DenseGeneral layout — axis 0 contracts, trailing axes are
output features), ``scale = max(|w|, axis=0) / 127`` and
``q = round(w / scale)``, so each output channel keeps its own range.

What gets quantized: 2-D+ entries whose name ends in ``kernel``
(attention q/k/v/out, MLP up/down). Embeddings, biases and LayerNorm
scales stay f32 — the word embedding doubles as the tied LM head.

A state here is a flat ``{name: tensor}`` dict (a module's
``state_dict``); :func:`dequantize_tree` restores one that
``torch.func.functional_call`` can run the model on.
"""

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    """int8 values + per-output-channel f32 scales (axis 0 reduced)."""
    values: torch.Tensor   # int8 [in, *out]
    scale: torch.Tensor    # f32  [1, *out]


def absmax_quantize(w, axis=0):
    """``(q, scale)`` with ``q*scale ~= w``; absmax per channel over
    ``axis`` (the contracting axis)."""
    w = w.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def _is_kernel(name):
    return name.rsplit(".", 1)[-1] == "kernel"


def quantize_tree(state, mode="int8"):
    """Quantize a state for serving.

    mode="int8": 2-D+ ``kernel`` entries become :class:`QTensor`;
    everything else is left as is. mode="bf16": kernels are cast to bf16
    (pure storage cast, no scales). Returns a state
    :func:`dequantize_tree` restores."""
    if mode not in ("int8", "bf16"):
        raise ValueError("quantize mode must be int8|bf16, got %r" % mode)
    out = {}
    for name, leaf in state.items():
        if not (_is_kernel(name) and leaf.ndim >= 2):
            out[name] = leaf
        elif mode == "bf16":
            out[name] = leaf.to(torch.bfloat16)
        else:
            out[name] = QTensor(*absmax_quantize(leaf, axis=0))
    return out


def dequantize_tree(state, dtype=torch.float32):
    """Inverse of :func:`quantize_tree`, run inside the forward so the
    int8 (or bf16) tensors are what stays in device memory."""
    out = {}
    for name, leaf in state.items():
        if isinstance(leaf, QTensor):
            out[name] = dequantize(leaf.values, leaf.scale, dtype)
        elif leaf.dtype == torch.bfloat16:
            out[name] = leaf.to(dtype)
        else:
            out[name] = leaf
    return out
