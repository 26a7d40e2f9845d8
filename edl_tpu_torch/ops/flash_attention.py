"""Flash attention forward: a hand-written CUDA kernel and its plain
PyTorch version.

The port's counterpart of ``edl_tpu/ops/flash_attention.py``. Exact
attention that never materializes the [seq, seq] score matrix:

- on a CUDA tensor, :func:`flash_attention` launches the kernel of
  ``csrc/flash_fwd.cu`` (one thread block per (batch*head, 64-row q
  tile), a loop over 64-row kv tiles in shared memory, f32 online
  softmax), built with nvcc on first use and bound with ctypes;
- on a CPU tensor it runs :func:`blockwise_reference`, the port of the
  JAX package's ``_blockwise_reference`` (a loop over kv blocks with the
  same mask and online-softmax convention), which is also what the
  tests and ``chip_smoke.py`` hold the kernel against.

There is no fallback between the two: a CUDA tensor launches the kernel
or raises. The backward is not ported yet (serving needs none), so
asking for a gradient raises.

Layout: q, k, v are [batch, heads, seq, head_dim] (``mha`` takes the
model code's [batch, seq, heads, head_dim]).
"""

import ctypes
import os
import threading

import torch
import torch.nn.functional as F

from edl_tpu_torch.utils import buildlock

_NEG_INF = -1e30
_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "flash_fwd.cu")
#: head_dim the kernel takes: a multiple of 8 (16-byte bf16 rows), <= 256
HEAD_MULT = 8
MAX_HEAD_DIM = 256
_MAX_BH = 65535  # gridDim.y
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


def bind(lib):
    """Declare the C entry points' types on a loaded kernel library."""
    p = ctypes.c_void_p
    lib.edl_flash_fwd.argtypes = [
        p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, p]
    lib.edl_flash_fwd.restype = ctypes.c_int
    lib.edl_flash_error_string.argtypes = [ctypes.c_int]
    lib.edl_flash_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_lib():
    """The built kernel library (nvcc on first use, under a file lock)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(buildlock.load(_SOURCE))
        return _lib


def build():
    """Build (if needed) and load the kernel; returns nvcc's
    ``(path, seconds, log)`` for the build report."""
    report = buildlock.build(_SOURCE)
    _kernel_lib()
    return report


def _block_layout(k, v, block_k):
    """Pad kv to whole blocks: (kb, vb) are [n_blocks, b, h, block_k, d]
    f32."""
    b, h, sk, d = k.shape
    n_blocks = (sk + block_k - 1) // block_k
    pad = n_blocks * block_k - sk
    kb = F.pad(k, (0, 0, 0, pad)).reshape(b, h, n_blocks, block_k, d)
    vb = F.pad(v, (0, 0, 0, pad)).reshape(b, h, n_blocks, block_k, d)
    return (kb.float().permute(2, 0, 1, 3, 4),
            vb.float().permute(2, 0, 1, 3, 4), n_blocks)


def _block_mask(ki, block_k, s, sk, causal, device):
    """[s, block_k] validity of kv block ``ki``: keys at or beyond sk are
    invalid; under causal, q row i may not attend ahead of key i."""
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = ki * block_k + torch.arange(block_k, device=device)[None, :]
    mask = k_pos < sk
    if causal:
        mask = mask & (q_pos >= k_pos)
    return mask


def blockwise_reference(q, k, v, causal, sm_scale, block_k=512):
    """The plain version of the kernel: O(seq)-memory attention by a loop
    over kv blocks with f32 online softmax — the port of the JAX
    package's ``_blockwise_reference``."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    q32 = q.float() * sm_scale
    kb, vb, n_blocks = _block_layout(k, v, block_k)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    for ki in range(n_blocks):
        mask = _block_mask(ki, block_k, s, sk, causal, q.device)
        scores = torch.einsum("bhqd,bhkd->bhqk", q32, kb[ki])
        scores = torch.where(mask, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   vb[ki])
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [batch, heads, seq, dim] "
                         "tensors, got shapes %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError("flash_attention shape mismatch: q %s k %s v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError("q, k, v on different devices: %s" % devices)
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError("q, k, v dtypes differ: %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))


def _launch(q, k, v, causal, sm_scale):
    """Launch the CUDA kernel on the current stream; raises on anything
    it does not take."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError("flash kernel takes float32 or bfloat16, got %s"
                        % q.dtype)
    if d % HEAD_MULT != 0 or d > MAX_HEAD_DIM:
        raise ValueError("flash kernel takes head_dim a multiple of %d up to "
                         "%d, got %d" % (HEAD_MULT, MAX_HEAD_DIM, d))
    if b * h > _MAX_BH or s == 0 or sk == 0:
        raise ValueError("flash kernel takes 1 <= batch*heads <= %d and "
                         "non-empty sequences, got %s %s"
                         % (_MAX_BH, tuple(q.shape), tuple(k.shape)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError("flash kernel takes contiguous tensors; %s is "
                             "not" % name)
        if t.data_ptr() % 16:
            raise ValueError("flash kernel takes 16-byte aligned tensors; "
                             "%s is not" % name)
    lib = _kernel_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.edl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), b * h, s, sk, d,
                                float(sm_scale), int(bool(causal)),
                                _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash kernel launch failed: CUDA error %d (%s)"
                           % (err, lib.edl_flash_error_string(err).decode()))
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Blockwise exact attention; q/k/v/out are [batch, heads, seq, dim].

    CUDA tensors run the kernel, CPU tensors its plain version. The
    causal diagonal is anchored at position 0 (row i sees keys 0..i)."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward in edl_tpu_torch yet; run it "
            "under torch.inference_mode() / no_grad, or use the dense path")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return blockwise_reference(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention runs on cuda or cpu, not %s"
                         % q.device)
    return _launch(q, k, v, causal, sm_scale)


#: kernel launches since the last reset (the main path's proof of use)
flash_attention.launches = 0


def mha(q, k, v, causal=False, sm_scale=None):
    """:func:`flash_attention` for [batch, seq, heads, dim] layouts (the
    model code's layout): transposes in and out around it."""
    t = lambda x: x.transpose(1, 2).contiguous()
    out = flash_attention(t(q), t(k), t(v), causal, sm_scale)
    return out.transpose(1, 2)
