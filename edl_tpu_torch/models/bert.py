"""BERT encoder family: ``edl_tpu/models/bert.py`` ported to PyTorch,
without its mixture-of-experts FFN, ring attention or pipeline stages
(those come with the parallelism slice, ROADMAP A20).

A post-LN encoder with an f32 tanh pooler over the first token and an
f32 classifier. Attention goes through
:func:`edl_tpu_torch.ops.attention.attention_context` (non-causal; an
attention mask forces the dense path), so on the card a maskless batch
runs the CUDA flash kernels, forward and backward.

Numerics and names follow the JAX package (flax ``linen``), so one flax
param tree gives the same logits in both (:func:`params_from_flax`):
f32 parameters, activations in ``dtype`` (bf16 by default), LayerNorm
eps 1e-6 with f32 statistics, tanh-approximated GELU, the pooler and
classifier in f32 on the upcast first token. The embeddings
(``word_embed``, ``pos_embed``, ``type_embed``) are looked up and cast
to ``dtype``; ``type_embed`` is used only when ``token_type_ids`` is
given, as flax creates it only then.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from edl_tpu_torch.models.gpt import (DenseGeneral, Embed, LayerNorm,
                                      _state_device, params_from_flax,
                                      remat_call)
from edl_tpu_torch.ops.attention import attention_context
from edl_tpu_torch.utils.device import resolve_device

__all__ = ["Bert", "BertLayer", "BertSelfAttention", "bert_base",
           "bert_tiny", "create_model_and_loss", "params_from_flax",
           "synthetic_text_batch"]


def _not_ported(what):
    return NotImplementedError(
        "%s is not ported to edl_tpu_torch yet (ROADMAP A20: ring "
        "attention, MoE and the pipeline come with the parallelism slice)"
        % what)


class BertSelfAttention(nn.Module):
    """Bidirectional multi-head self-attention. ``use_flash``: None =
    auto-dispatch (a mask always forces dense), True/False force a
    path."""

    def __init__(self, d_model, num_heads, dtype, use_flash, device):
        super().__init__()
        head_dim = d_model // num_heads
        self.dtype, self.use_flash = dtype, use_flash
        qkv = lambda: DenseGeneral((d_model,), (num_heads, head_dim), dtype,
                                   device)
        self.query, self.key, self.value = qkv(), qkv(), qkv()
        self.out = DenseGeneral((num_heads, head_dim), (d_model,), dtype,
                                device)

    def forward(self, x, mask=None):
        q, k, v = self.query(x), self.key(x), self.value(x)
        ctx = attention_context(q, k, v, causal=False, mask=mask,
                                dtype=self.dtype, use_flash=self.use_flash)
        return self.out(ctx)


class BertLayer(nn.Module):
    """Post-LN encoder layer: ln(x + attn(x)); ln(x + mlp(x))."""

    def __init__(self, d_model, num_heads, mlp_dim, dtype, use_flash,
                 device):
        super().__init__()
        self.attention = BertSelfAttention(d_model, num_heads, dtype,
                                           use_flash, device)
        self.ln_attn = LayerNorm(d_model, dtype, device)
        self.mlp_up = DenseGeneral((d_model,), (mlp_dim,), dtype, device)
        self.mlp_down = DenseGeneral((mlp_dim,), (d_model,), dtype, device)
        self.ln_mlp = LayerNorm(d_model, dtype, device)

    def forward(self, x, mask=None):
        x = self.ln_attn(x + self.attention(x, mask))
        h = F.gelu(self.mlp_up(x), approximate="tanh")
        return self.ln_mlp(x + self.mlp_down(h))


class Bert(nn.Module):
    """BERT encoder; bert-base = the defaults (12 layers, 768 wide, 12
    heads, mlp 3072, vocab 30522, max_len 512).

    ``num_classes`` None returns ``(sequence output, pooled)``, else f32
    logits. ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant). ``moe_experts > 0`` and
    ``use_ring`` raise (ROADMAP A20). ``device`` None means CUDA (and
    raises without one); weights start uninitialized: call
    :meth:`init_weights` or load a state."""

    def __init__(self, vocab_size=30522, num_layers=12, d_model=768,
                 num_heads=12, mlp_dim=3072, max_len=512, num_classes=2,
                 dtype=torch.bfloat16, use_ring=False, use_flash=None,
                 remat=False, moe_experts=0, moe_k=1, device=None):
        super().__init__()
        if moe_experts:
            raise _not_ported("Bert(moe_experts > 0)")
        if use_ring:
            raise _not_ported("Bert(use_ring=True)")
        device = resolve_device(device)
        self.vocab_size, self.num_layers, self.d_model = (vocab_size,
                                                          num_layers, d_model)
        self.num_heads, self.max_len = num_heads, max_len
        self.num_classes, self.dtype, self.remat = num_classes, dtype, remat
        self.word_embed = Embed(vocab_size, d_model, device)
        self.pos_embed = Embed(max_len, d_model, device)
        self.type_embed = Embed(2, d_model, device)
        self.ln_embed = LayerNorm(d_model, dtype, device)
        for i in range(num_layers):
            self.add_module("layer_%d" % i, BertLayer(
                d_model, num_heads, mlp_dim, dtype, use_flash, device))
        self.pooler = DenseGeneral((d_model,), (d_model,), torch.float32,
                                   device)
        if num_classes is not None:
            self.classifier = DenseGeneral((d_model,), (num_classes,),
                                           torch.float32, device)

    @torch.no_grad()
    def init_weights(self, generator):
        """Random weights from ``generator`` (on the model's device)."""
        for module in self.modules():
            if module is not self and hasattr(module, "init_weights"):
                module.init_weights(generator)
        return self

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        s = input_ids.shape[1]
        if s > self.max_len:
            raise ValueError("sequence %d exceeds max_len %d"
                             % (s, self.max_len))
        x = self.word_embed.embedding[input_ids].to(self.dtype)
        x = x + self.pos_embed.embedding[:s].to(self.dtype)[None]
        if token_type_ids is not None:
            x = x + self.type_embed.embedding[token_type_ids].to(self.dtype)
        x = self.ln_embed(x)
        mask = None if attention_mask is None else attention_mask.bool()
        for i in range(self.num_layers):
            layer = getattr(self, "layer_%d" % i)
            if self.remat and torch.is_grad_enabled():
                x = remat_call(layer, x, mask)
            else:
                x = layer(x, mask)
        pooled = torch.tanh(self.pooler(x[:, 0].float()))
        if self.num_classes is None:
            return x, pooled
        return self.classifier(pooled)


def bert_base(**kw):
    return Bert(**kw)


def bert_tiny(**kw):
    """4-layer test-size config."""
    kw.setdefault("num_layers", 4)
    kw.setdefault("d_model", 64)
    kw.setdefault("num_heads", 4)
    kw.setdefault("mlp_dim", 128)
    kw.setdefault("vocab_size", 1000)
    kw.setdefault("max_len", 128)
    return Bert(**kw)


def create_model_and_loss(model=None, dummy_batch=1, dummy_seq=16,
                          moe_aux_weight=0.01, moe_z_weight=1e-3,
                          device=None, seed=0, **kw):
    """(model, params, loss_fn) for the train-step builders: softmax
    cross-entropy of the classifier's logits against ``batch["label"]``
    (mean), the attention mask ``batch.get("attention_mask")`` passed
    through, as the JAX package's non-MoE path.

    ``model`` defaults to ``bert_tiny(device=device, **kw)``; weights
    come from a generator seeded ``seed``. ``params`` is the flat
    flax-named state of what the JAX package's init creates for
    ``input_ids`` alone: without ``type_embed``. MoE models raise
    (ROADMAP A20); ``moe_aux_weight``, ``moe_z_weight``, ``dummy_batch``
    and ``dummy_seq`` are accepted for the JAX signature."""
    del dummy_batch, dummy_seq, moe_aux_weight, moe_z_weight
    model = model or bert_tiny(device=device, **kw)
    dev = next(model.parameters()).device
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    params = {name: p.detach().clone()
              for name, p in model.named_parameters()
              if not name.startswith("type_embed.")}

    def loss_fn(params, batch, rng):
        device = _state_device(params)
        ids = torch.as_tensor(batch["input_ids"], device=device).long()
        mask = batch.get("attention_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=device)
        logits = functional_call(model, params, (ids, mask))
        labels = torch.as_tensor(batch["label"], device=device).long()
        return F.cross_entropy(logits.float(), labels)

    return model, params, loss_fn


def synthetic_text_batch(batch_size, seq_len=64, vocab_size=1000,
                         num_classes=2, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "input_ids": rng.randint(0, vocab_size,
                                 (batch_size, seq_len)).astype(np.int32),
        "label": rng.randint(0, num_classes,
                             (batch_size,)).astype(np.int32),
    }
