"""GPT decoder family: the causal LM of ``edl_tpu/models/gpt.py``, ported
to PyTorch on its full-sequence path.

A pre-LN decoder-only transformer with a weight-tied LM head. Attention
goes through :func:`edl_tpu_torch.ops.attention.attention_context`,
which auto-dispatches to the CUDA flash kernel on kernel-legal shapes.
The incremental-decode, offset-prefill and ``generate`` paths come with
the ``lm_teacher`` slice.

Numerics follow the JAX package (flax ``linen``) so that one set of
weights gives the same logits in both:

- parameters are f32; activations run in ``dtype`` (bf16 by default):
  every dense layer casts its input and its kernel to ``dtype``;
- the word embedding is looked up in f32 and cast down; the position
  embedding table is cast to ``dtype`` before its lookup;
- LayerNorm (eps 1e-6) takes its statistics in f32 and returns
  ``dtype``; the MLP's GELU is the tanh approximation;
- the tied head is ``x.float() @ word_embedding.T``: logits are f32.

Parameter names and kernel layouts are flax's (``block_0.attention.
query.kernel`` is [d_model, heads, head_dim], ``...out.kernel`` is
[heads, head_dim, d_model]), so :func:`params_from_flax` is a flatten.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.ops.attention import attention_context
from edl_tpu_torch.utils.device import resolve_device


class DenseGeneral(nn.Module):
    """``x[..., *in] . kernel[*in, *out] + bias[*out]`` in ``dtype`` —
    flax's ``DenseGeneral`` (and ``Dense`` when both shapes are 1-D)."""

    def __init__(self, in_shape, out_shape, dtype, device):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            self.in_shape + self.out_shape, device=device))
        self.bias = nn.Parameter(torch.zeros(self.out_shape, device=device))

    def init_weights(self, generator):
        # lecun normal, as flax's default kernel init (untruncated)
        std = math.prod(self.in_shape) ** -0.5
        _normal_(self.kernel, std, generator)
        self.bias.zero_()

    def forward(self, x):
        lead = x.shape[:x.ndim - len(self.in_shape)]
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        w = self.kernel.reshape(n_in, n_out).to(self.dtype)
        y = x.reshape(*lead, n_in).to(self.dtype) @ w
        y = y + self.bias.reshape(n_out).to(self.dtype)
        return y.reshape(*lead, *self.out_shape)


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: f32 statistics (E[x^2] - E[x]^2), eps 1e-6,
    f32 scale and bias, output in ``dtype``."""

    def __init__(self, features, dtype, device, eps=1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def init_weights(self, generator):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(-1, keepdim=True)
                              - mean * mean, 0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(self.dtype)


class Embed(nn.Module):
    """An embedding table ``[num, features]`` (flax ``Embed``)."""

    def __init__(self, num, features, device):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features,
                                                  device=device))

    def init_weights(self, generator):
        # flax's default: variance scaling 1.0, fan_in = features
        _normal_(self.embedding, self.embedding.shape[1] ** -0.5, generator)


def _normal_(param, std, generator):
    param.copy_(torch.randn(param.shape, generator=generator,
                            device=generator.device) * std)


class CausalSelfAttention(nn.Module):
    """Causal multi-head self-attention on the full sequence.

    ``use_flash``: None = auto-dispatch (the CUDA flash kernel where
    legal), True/False force a path."""

    def __init__(self, d_model, num_heads, dtype, use_flash, device):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model %d not divisible by num_heads %d"
                             % (d_model, num_heads))
        head_dim = d_model // num_heads
        self.dtype, self.use_flash = dtype, use_flash
        qkv = lambda: DenseGeneral((d_model,), (num_heads, head_dim), dtype,
                                   device)
        self.query, self.key, self.value = qkv(), qkv(), qkv()
        self.out = DenseGeneral((num_heads, head_dim), (d_model,), dtype,
                                device)

    def forward(self, x):
        ctx = attention_context(self.query(x), self.key(x), self.value(x),
                                causal=True, mask=None, dtype=self.dtype,
                                use_flash=self.use_flash)
        return self.out(ctx)


class GptBlock(nn.Module):
    """Pre-LN decoder block: x + attn(ln(x)); x + mlp(ln(x))."""

    def __init__(self, d_model, num_heads, mlp_dim, dtype, use_flash,
                 device):
        super().__init__()
        self.ln_attn = LayerNorm(d_model, dtype, device)
        self.attention = CausalSelfAttention(d_model, num_heads, dtype,
                                             use_flash, device)
        self.ln_mlp = LayerNorm(d_model, dtype, device)
        self.mlp_up = DenseGeneral((d_model,), (mlp_dim,), dtype, device)
        self.mlp_down = DenseGeneral((mlp_dim,), (d_model,), dtype, device)

    def forward(self, x):
        x = x + self.attention(self.ln_attn(x))
        h = F.gelu(self.mlp_up(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_down(h)


class Gpt(nn.Module):
    """Decoder-only causal LM; logits via the tied word embedding.

    The defaults are GPT-2 small's widths at a 32000 vocab (the JAX
    package's ``Gpt()``). ``use_flash``: None = auto-dispatch, True =
    force flash, False = force dense. ``device`` None means CUDA (and
    raises without one). Parameters start uninitialized: call
    :meth:`init_weights` with a generator, or load a state
    (:func:`params_from_flax`)."""

    def __init__(self, vocab_size=32000, num_layers=12, d_model=768,
                 num_heads=12, mlp_dim=3072, max_len=1024,
                 dtype=torch.bfloat16, use_flash=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.max_len, self.num_layers = dtype, max_len, num_layers
        self.word_embed = Embed(vocab_size, d_model, device)
        self.pos_embed = Embed(max_len, d_model, device)
        for i in range(num_layers):
            # flax's names, so a flax param tree maps one to one
            self.add_module("block_%d" % i, GptBlock(
                d_model, num_heads, mlp_dim, dtype, use_flash, device))
        self.ln_final = LayerNorm(d_model, dtype, device)

    @torch.no_grad()
    def init_weights(self, generator):
        """Random weights from ``generator`` (on the model's device)."""
        for module in self.modules():
            if module is not self and hasattr(module, "init_weights"):
                module.init_weights(generator)
        return self

    def forward(self, input_ids):
        s = input_ids.shape[1]
        if s > self.max_len:
            raise ValueError("sequence %d exceeds max_len %d"
                             % (s, self.max_len))
        x = self.word_embed.embedding[input_ids].to(self.dtype)
        pos = torch.arange(s, device=input_ids.device)
        x = x + self.pos_embed.embedding.to(self.dtype)[pos][None]
        for i in range(self.num_layers):
            x = getattr(self, "block_%d" % i)(x)
        x = self.ln_final(x)
        # weight-tied LM head in f32
        return x.float() @ self.word_embed.embedding.float().t()


def params_from_flax(tree):
    """The port's state (``{name: f32 tensor}`` on the CPU, for
    ``Gpt.load_state_dict``) from a flax ``Gpt`` param tree given as
    nested dicts of arrays. Names join the flax path with dots; kernel
    layouts are kept as they are."""
    state = {}

    def walk(prefix, node):
        for key, val in node.items():
            name = "%s.%s" % (prefix, key) if prefix else str(key)
            if hasattr(val, "items"):  # dict or flax FrozenDict
                walk(name, val)
            else:
                arr = np.asarray(val)
                if arr.dtype.kind != "f":
                    raise TypeError("param %s is %s, not floating"
                                    % (name, arr.dtype))
                state[name] = torch.from_numpy(
                    np.array(arr, dtype=np.float32))

    walk("", tree)
    return state
