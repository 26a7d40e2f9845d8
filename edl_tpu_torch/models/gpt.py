"""GPT decoder family: the causal LM of ``edl_tpu/models/gpt.py``, ported
to PyTorch, with its KV-cache paths.

A pre-LN decoder-only transformer with a weight-tied LM head. Attention
goes through :func:`edl_tpu_torch.ops.attention.attention_context`,
which auto-dispatches to the CUDA flash kernel on kernel-legal shapes.

Three cache modes serve incremental decoding (``generate`` and the
decode engine of ``serve/decode_engine.py``):

- ``prefill=True``: one causal forward over the whole prompt that also
  writes its K/V into the cache at ``[0, s)`` (flash where legal);
- ``prefill=True, prefill_offset=off``: a chunk of the prompt whose
  first token sits at ``off`` writes its K/V at ``[off, off + s)`` and
  attends the cache under the shifted causal mask (dense);
- ``decode=True``: one token per row at ``decode_index`` (a scalar for
  every row, or a ``[b]`` vector, one position per row), written into
  the cache and attended against it (dense).

The flax ``"cache"`` collection becomes explicit tensors: a cache is a
dict ``{"block_i.attention.k": [b, max_len, heads, head_dim], ...v}``
in the model dtype (:func:`init_cache`), named by flax's path, and the
forward UPDATES IT IN PLACE where JAX returned a new one. Positions
are host values (ints or numpy arrays) and are checked against
``max_len``: where ``jax.lax.dynamic_update_slice`` clamps a start that
would overrun, the port raises.

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
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from edl_tpu_torch.ops import quant
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
    """Causal multi-head self-attention, with the cache modes of the
    module docstring.

    ``use_flash``: None = auto-dispatch (the CUDA flash kernel where
    legal), True/False force a path. Only the full-sequence and the
    offset-0 prefill paths dispatch; offset chunks and decode steps are
    dense, as in the JAX package."""

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

    def forward(self, x, cache=None, decode=False, decode_index=None,
                prefill=False, prefill_offset=None):
        """``cache`` is this block's ``(k, v)`` pair, updated in place;
        ``decode_index`` and ``prefill_offset`` come checked from
        :meth:`Gpt.forward` (an int, or a [b] tensor of positions)."""
        q, k, v = self.query(x), self.key(x), self.value(x)
        if prefill and prefill_offset is None:
            ck, cv = cache
            s = x.shape[1]
            ck[:, :s] = k
            cv[:, :s] = v
            ctx = attention_context(q, k, v, causal=True, mask=None,
                                    dtype=self.dtype,
                                    use_flash=self.use_flash)
        elif prefill or decode:
            ck, cv = cache
            key_pos = torch.arange(ck.shape[1], device=x.device)
            if prefill:
                # chunk row i sees keys [0, off + i]: the prefix already
                # written plus its own chunk's prefix; junk beyond is
                # never attended
                off, s = prefill_offset, x.shape[1]
                ck[:, off:off + s] = k
                cv[:, off:off + s] = v
                q_pos = off + torch.arange(s, device=x.device)
                mask = key_pos[None, None, None, :] <= q_pos[None, None, :,
                                                             None]
            elif isinstance(decode_index, int):
                ck[:, decode_index] = k[:, 0]
                cv[:, decode_index] = v[:, 0]
                mask = key_pos[None, None, None, :] <= decode_index
            else:
                # one position per row (the slot layout of the decode
                # engine): a per-row write and a per-row prefix mask
                rows = torch.arange(x.shape[0], device=x.device)
                ck[rows, decode_index] = k[:, 0]
                cv[rows, decode_index] = v[:, 0]
                mask = (key_pos[None, None, None, :]
                        <= decode_index[:, None, None, None])
            # the JAX package's dense masked path: f32 scores, -1e30 mask
            scale = q.shape[-1] ** -0.5
            scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(),
                                  ck.float())
            probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs,
                               cv.float()).to(self.dtype)
        else:
            ctx = attention_context(q, k, v, causal=True, mask=None,
                                    dtype=self.dtype,
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

    def forward(self, x, **cache_kw):
        x = x + self.attention(self.ln_attn(x), **cache_kw)
        h = F.gelu(self.mlp_up(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_down(h)


class Gpt(nn.Module):
    """Decoder-only causal LM; logits via the tied word embedding.

    The defaults are GPT-2 small's widths at a 32000 vocab (the JAX
    package's ``Gpt()``). ``use_flash``: None = auto-dispatch, True =
    force flash, False = force dense. ``remat``: recompute each block in
    the backward (``torch.utils.checkpoint``, non-reentrant) on the
    full-sequence path, never on the cache paths, as the JAX package's
    ``nn.remat``. ``device`` None means CUDA (and raises without one).
    Parameters start uninitialized: call :meth:`init_weights` with a
    generator, or load a state (:func:`params_from_flax`)."""

    def __init__(self, vocab_size=32000, num_layers=12, d_model=768,
                 num_heads=12, mlp_dim=3072, max_len=1024,
                 dtype=torch.bfloat16, use_flash=None, remat=False,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.max_len, self.num_layers = dtype, max_len, num_layers
        self.vocab_size, self.num_heads = vocab_size, num_heads
        self.d_model, self.remat = d_model, remat
        self.head_dim = d_model // num_heads
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

    def forward(self, input_ids, cache=None, decode=False,
                decode_index=None, prefill=False, prefill_offset=None):
        """Logits [b, s, vocab] in f32. ``decode``/``prefill`` need a
        ``cache`` (:func:`init_cache`), which they update in place."""
        b, s = input_ids.shape
        device = input_ids.device
        if (decode or prefill) and cache is None:
            raise ValueError("decode and prefill need a cache "
                             "(models.gpt.init_cache)")
        if decode:
            if s != 1:
                raise ValueError("decode mode feeds one token at a time")
            if decode_index is None:
                raise ValueError("decode mode needs decode_index")
            decode_index = _position(decode_index, 1, self.max_len,
                                     "decode_index")
            if isinstance(decode_index, int):
                pos = torch.full((1, 1), decode_index, device=device)
            else:
                if decode_index.shape != (b,):
                    raise ValueError(
                        "vector decode_index must be [batch]=%d, got %s"
                        % (b, tuple(decode_index.shape)))
                decode_index = decode_index.to(device)
                pos = decode_index[:, None]
        else:
            off = 0
            if prefill and prefill_offset is not None:
                prefill_offset = off = _position(prefill_offset, s,
                                                 self.max_len,
                                                 "prefill_offset")
            elif s > self.max_len:
                raise ValueError("sequence %d exceeds max_len %d"
                                 % (s, self.max_len))
            pos = off + torch.arange(s, device=device)[None]
        x = self.word_embed.embedding[input_ids].to(self.dtype)
        x = x + self.pos_embed.embedding.to(self.dtype)[pos]
        kw = dict(decode=decode, decode_index=decode_index, prefill=prefill,
                  prefill_offset=prefill_offset)
        # remat is a training lever: the cache paths never take it
        use_remat = self.remat and cache is None and torch.is_grad_enabled()
        for i in range(self.num_layers):
            name = "block_%d" % i
            if cache is not None:
                kw["cache"] = (cache[name + ".attention.k"],
                               cache[name + ".attention.v"])
            if use_remat:
                x = remat_call(getattr(self, name), x)
            else:
                x = getattr(self, name)(x, **kw)
        x = self.ln_final(x)
        # weight-tied LM head in f32
        return x.float() @ self.word_embed.embedding.float().t()


def remat_call(module, *args):
    """``module(*args)``, recomputed in the backward: a non-reentrant
    ``torch.utils.checkpoint`` that passes the module's parameters in
    explicitly. The recompute runs outside any ``functional_call`` that
    substituted them (the train step's), so it puts the same tensors back
    itself."""
    names, values = zip(*module.named_parameters())

    def run(args, values):
        return functional_call(module, dict(zip(names, values)), args)

    return checkpoint(run, args, values, use_reentrant=False)


def _position(value, span, max_len, what):
    """A host position (int, or numpy/CPU-tensor vector) checked so that
    ``[value, value + span)`` lies in ``[0, max_len)``: an int, or a
    [b] int64 CPU tensor."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise TypeError("%s must be a host value (int, numpy, or a CPU "
                            "tensor), not a %s tensor" % (what, value.device))
        value = value.numpy()
    arr = np.asarray(value)
    if arr.dtype.kind not in "iu":
        raise TypeError("%s must be integer, got %s" % (what, arr.dtype))
    if arr.size and (arr.min() < 0 or arr.max() + span > max_len):
        raise ValueError("%s %s with span %d overruns max_len %d"
                         % (what, arr.tolist(), span, max_len))
    if arr.ndim == 0:
        return int(arr)
    return torch.from_numpy(arr.astype(np.int64))


def _state_device(params):
    """Device of a (possibly quantized) state dict's first tensor."""
    for leaf in params.values():
        if isinstance(leaf, quant.QTensor):
            leaf = leaf.values
        return leaf.device
    raise ValueError("empty state")


def init_cache(model, params, batch_size):
    """Zeroed KV caches for incremental decode: ``{"block_i.attention.k"
    and ".v": [batch_size, max_len, heads, head_dim]}`` in the model
    dtype, on the device of ``params`` (a state dict), or of the model's
    own parameters when ``params`` is None.

    The tensors are made outside inference mode, so that the decode
    paths (which run under ``torch.no_grad()``) may update them in
    place from any thread."""
    device = (_state_device(params) if params is not None
              else next(model.parameters()).device)
    shape = (batch_size, model.max_len, model.num_heads, model.head_dim)
    with torch.inference_mode(False):
        return {"block_%d.attention.%s" % (i, kv): torch.zeros(
                    shape, dtype=model.dtype, device=device)
                for i in range(model.num_layers) for kv in "kv"}


def apply(model, params, *args, **kwargs):
    """Run ``model`` on the state ``params`` (plain, or from
    :func:`edl_tpu_torch.ops.quant.quantize_tree`: dequantized here, in
    the forward), or on its own parameters when ``params`` is None."""
    if params is None:
        return model(*args, **kwargs)
    return functional_call(model, quant.dequantize_tree(params), args,
                           kwargs)


def _filter_logits(logits, top_k=0, top_p=0.0):
    """Mask logits outside the sampling nucleus: keep the top_k largest
    (0 = all) and/or the smallest prefix of the sorted distribution whose
    probability mass reaches top_p (0 = all)."""
    if top_k and top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p and 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep ranks whose PRECEDING mass is < top_p (always >= 1 token)
        keep = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                         dim=-1) < top_p
        cutoff = torch.where(keep, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def generate(model, params, prompt_ids, max_new_tokens, generator=None,
             temperature=0.0, top_k=0, top_p=0.0):
    """Autoregressive sampling with the KV cache: ONE batched prefill
    forward fills the cache over the whole prompt, then a loop decodes
    ``max_new_tokens`` (greedy at temperature 0, first index on ties;
    temperature > 0 samples from ``generator``, default one seeded 0,
    optionally truncated to the ``top_k`` largest logits and/or the
    ``top_p`` nucleus). ``params`` as for :func:`apply`. Returns
    [b, prompt+new] int64 ids on the model's device."""
    device = (_state_device(params) if params is not None
              else next(model.parameters()).device)
    ids = torch.as_tensor(np.asarray(prompt_ids), device=device).long()
    b, prompt_len = ids.shape
    total = prompt_len + max_new_tokens
    if total > model.max_len:
        raise ValueError("prompt+new %d exceeds max_len %d"
                         % (total, model.max_len))
    if max_new_tokens < 1:
        return ids
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if params is not None:
        params = quant.dequantize_tree(params)

    def sample(logits):
        if temperature > 0:
            # temperature FIRST, then the nucleus: top_p is a mass of
            # the actual sampling distribution
            scaled = _filter_logits(logits / temperature, top_k=top_k,
                                    top_p=top_p)
            return torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                     generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)

    with torch.no_grad():
        cache = init_cache(model, params, b)
        logits = apply(model, params, ids, cache=cache, prefill=True)
        tok = sample(logits[:, -1])
        out = [ids, tok[:, None]]
        # position t produces token t + 1
        for t in range(prompt_len, total - 1):
            logits = apply(model, params, tok[:, None], cache=cache,
                           decode=True, decode_index=t)
            tok = sample(logits[:, 0])
            out.append(tok[:, None])
    return torch.cat(out, dim=1)


def gpt_tiny(**kw):
    kw.setdefault("num_layers", 4)
    kw.setdefault("d_model", 64)
    kw.setdefault("num_heads", 4)
    kw.setdefault("mlp_dim", 128)
    kw.setdefault("vocab_size", 256)
    kw.setdefault("max_len", 128)
    return Gpt(**kw)


def create_model_and_loss(model=None, dummy_batch=1, dummy_seq=16,
                          device=None, seed=0, **kw):
    """(model, params, loss_fn) for the train-step builders of
    ``runtime/trainer.py`` — next-token cross-entropy over
    ``batch["input_ids"]`` (shift inside), as the JAX package's.

    ``model`` defaults to ``gpt_tiny(device=device, **kw)``; its weights
    come from a generator seeded ``seed`` (``dummy_batch`` and
    ``dummy_seq`` size the JAX package's init trace and are accepted for
    its signature). ``params`` is the flat flax-named state
    (``{name: f32 tensor}``), the layout :func:`params_from_flax`
    produces. ``loss_fn(params, batch, rng)`` takes ids as a numpy array
    or a tensor and returns the f32 mean loss over ``logits[:, :-1]``
    against ``ids[:, 1:]``; ``rng`` is unused (no dropout)."""
    del dummy_batch, dummy_seq
    model = model or gpt_tiny(device=device, **kw)
    dev = next(model.parameters()).device
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    params = {name: p.detach().clone()
              for name, p in model.named_parameters()}

    def loss_fn(params, batch, rng):
        ids = torch.as_tensor(batch["input_ids"],
                              device=_state_device(params)).long()
        logits = functional_call(model, params, (ids,))
        # predict token t+1 from the prefix <= t
        return F.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]).float(),
            ids[:, 1:].reshape(-1))

    return model, params, loss_fn


def synthetic_lm_batch(batch_size, seq_len=32, vocab_size=256, seed=0):
    """Learnable synthetic stream: arithmetic sequences mod vocab (each
    next token is prev + step, a pattern a causal LM can learn)."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, vocab_size, (batch_size, 1))
    step = rng.randint(1, 7, (batch_size, 1))
    pos = np.arange(seq_len)[None, :]
    ids = (start + step * pos) % vocab_size
    return {"input_ids": ids.astype(np.int32)}


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
