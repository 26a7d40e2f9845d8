"""Attention-impl dispatch for the port's model families: the CUDA flash
kernel or dense — one copy of the -1e30 mask convention, sm_scale, and
the choice between the two.

``use_flash=None`` (the default) auto-dispatches: on a CUDA device,
shapes the flash kernel handles exactly take the flash path; everything
else stays dense. Explicit ``True``/``False`` force a path (``True`` on
a CPU tensor runs the kernel's plain version). Ring attention over a
sequence-parallel mesh comes with the parallelism slice.
"""

import os

import torch

from edl_tpu_torch.ops.flash_attention import (HEAD_MULT, MAX_HEAD_DIM,
                                               mha)

# the JAX package's Pallas kernel tiles q in 128-row blocks and does not
# mask ragged q blocks; the dispatch keeps its conservative seq rule
_FLASH_BLOCK = 128


def flash_dispatch_reason(seq_len, head_dim, *, mask=None, device=None,
                          seq_kv=None, offset=None):
    """Why auto-dispatch would (not) pick flash for this shape.

    Returns ``None`` when the flash path is legal and profitable, else a
    human-readable reason string (the dense path is taken). Pure shape
    math — safe to call from tests and benches.

    ``device``: where the tensors live; only a CUDA device runs the
    kernel (on the CPU its plain version is slower than dense).

    ``seq_kv`` (default: ``seq_len``) is the K/V sequence length.
    Decode-shaped queries — seq_q != seq_kv against a cached K/V — are
    never flash-legal: the kernel anchors its causal diagonal at
    position 0, so with q shorter than kv it would mask against the
    wrong diagonal. ``offset`` (chunked/suffix prefill: the chunk's KV
    write offset) marks a chunk-shaped query whose causal frontier sits
    at ``offset + i``; it is dense-only for the same reason.
    """
    if mask is not None:
        return "attention_mask set (flash kernel has no mask support)"
    if offset is not None:
        return ("chunk-shaped query (prefill_offset set): flash causal "
                "masking anchors the diagonal at position 0, not at the "
                "chunk offset")
    if seq_kv is not None and seq_kv != seq_len:
        return ("decode-shaped query (seq_q %d != seq_kv %d): flash "
                "causal masking assumes square q/kv" % (seq_len, seq_kv))
    if os.environ.get("EDL_TPU_FLASH_AUTO", "") == "0":
        return "disabled via EDL_TPU_FLASH_AUTO=0"
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return ("device %r (the kernel runs on CUDA; its plain version is "
                "slower than dense)" % device.type)
    if head_dim % HEAD_MULT != 0:
        return "head_dim %d not a multiple of %d" % (head_dim, HEAD_MULT)
    if head_dim > MAX_HEAD_DIM:
        return "head_dim %d above the kernel's %d" % (head_dim,
                                                      MAX_HEAD_DIM)
    if seq_len > _FLASH_BLOCK and seq_len % _FLASH_BLOCK != 0:
        return "seq_len %d not a multiple of block %d" % (seq_len,
                                                          _FLASH_BLOCK)
    return None


def attention_context(q, k, v, *, causal, mask, dtype, use_flash=None):
    """Attention over [batch, seq, heads, head_dim] q/k/v, returned in
    the same layout and in ``dtype``.

    ``use_flash``: ``True`` forces the flash kernel, ``False`` forces
    dense, ``None`` (default) auto-dispatches by
    :func:`flash_dispatch_reason`. ``mask`` is a [batch, seq_kv] bool
    key mask (dense path only)."""
    head_dim = q.shape[-1]
    scale = head_dim ** -0.5
    if use_flash is None:
        use_flash = flash_dispatch_reason(q.shape[1], head_dim, mask=mask,
                                          device=q.device,
                                          seq_kv=k.shape[1]) is None
    if use_flash:
        if mask is not None:
            raise ValueError(
                "use_flash does not support attention_mask yet; drop "
                "the mask (fixed-length batches) or use the dense path")
        if q.shape[1] != k.shape[1]:
            raise ValueError(
                "use_flash=True with decode-shaped q (seq_q %d != "
                "seq_kv %d): the flash kernel's causal mask assumes "
                "square q/kv; use the cached dense decode path"
                % (q.shape[1], k.shape[1]))
        return mha(q, k, v, causal=causal)
    # q * scale in q's dtype before the upcast, as the JAX package does
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    if causal:
        s = q.shape[1]
        tri = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(tri, scores, -1e30)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(dtype)
