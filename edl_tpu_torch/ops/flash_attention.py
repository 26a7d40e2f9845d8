"""Flash attention: three hand-written CUDA forward kernels, a CUDA
backward in three kernels (two of them in a bf16 wgmma form too), and
their plain PyTorch versions.

The port's counterpart of ``edl_tpu/ops/flash_attention.py``. Exact
attention that never materializes the [seq, seq] score matrix:

- on a CUDA tensor, :func:`flash_attention` launches one of three
  kernels, chosen before launch by :func:`kernel_for` from the dtype and
  head_dim:
  - ``sm90`` (``csrc/flash_fwd_sm90.cu``) for bf16 at head_dim 64 or
    128, the served path: wgmma on the tensor cores, K/V tiles fed by
    TMA into a ring of shared-memory slots, f32 online softmax, P·V as
    two bf16 products (P's bf16 rounding and its remainder) so that it
    keeps the f32 reference's accuracy;
  - ``tf32x3`` (``csrc/flash_fwd_tf32x3.cu``) for float32 at head_dim
    64, lm_teacher's prefills: the same TMA ring, both products as TF32
    wgmma with every operand split into its TF32 rounding and the
    remainder (3xTF32), which keeps f32 accuracy;
  - ``ffma`` (``csrc/flash_fwd.cu``) for the rest (float32 or bf16 at
    head_dims that are multiples of 8 up to 256): f32 FFMA on the CUDA
    cores;
  each is built with nvcc on first use and bound with ctypes;
- on a CPU tensor it runs :func:`blockwise_reference`, the port of the
  JAX package's ``_blockwise_reference`` (a loop over kv blocks with the
  same mask and online-softmax convention), which is also what the
  tests and ``chip_smoke.py`` hold every kernel against.

The gradient (:class:`FlashAttentionFunction`, a
``torch.autograd.Function`` in place of the JAX package's
``custom_vjp``) saves q, k, v, the output and each q row's lse = m +
log(max(l, 1e-30)) over the scaled, masked scores, which the forward
kernel writes beside the output (the plain forward on the CPU returns
it too). The backward does not recompute the softmax statistics, as the
JAX package's ``_flash_bwd`` does in its pass 1; the function is the
same. It runs:

- on a CUDA tensor, three kernels in FlashAttention-2's order:
  ``bwd_delta`` (``csrc/flash_bwd.cu``: delta = rowsum(g * out), a row
  reduction), then dq (one block per q tile, looping over kv tiles)
  and dk/dv (one block per kv tile, looping over q tiles), by the pair
  :func:`bwd_kernel_for` picks:
  - ``sm90`` (``csrc/flash_bwd_sm90.cu``: ``bwd_dq_sm90``,
    ``bwd_dkdv_sm90``) for bf16 at head_dim 64 (the training path) and
    128: bf16 wgmma with f32 accumulators, tiles fed by TMA, P and dS
    split into bf16 hi and lo before the products that take them;
  - ``ffma`` (``csrc/flash_bwd.cu``: ``bwd_dq``, ``bwd_dkdv``) for the
    rest: f32 FFMA on the CUDA cores;
- on a CPU tensor, :func:`flash_bwd_reference` given the forward's lse:
  the port of the JAX package's ``_flash_bwd`` with pass 1 reduced to
  delta.

There is no fallback between any of them: a CUDA tensor launches the
kernel :func:`kernel_for` names (or the backward's three, as
:func:`bwd_kernel_for` names them) or raises, and a CUDA backward
without the forward's lse raises rather than recompute it.
Under ``torch.inference_mode()`` or ``no_grad`` the forward builds no
graph, writes no lse and saves nothing.

Layout: q, k, v are [batch, heads, seq, head_dim] (``mha`` takes the
model code's [batch, seq, heads, head_dim]).
"""

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from edl_tpu_torch.utils import buildlock

_NEG_INF = -1e30
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCE = os.path.join(_CSRC, "flash_fwd.cu")
_SOURCE_SM90 = os.path.join(_CSRC, "flash_fwd_sm90.cu")
_SOURCE_TF32X3 = os.path.join(_CSRC, "flash_fwd_tf32x3.cu")
_SOURCE_BWD = os.path.join(_CSRC, "flash_bwd.cu")
_SOURCE_BWD_SM90 = os.path.join(_CSRC, "flash_bwd_sm90.cu")
#: each forward kernel's source, by the name kernel_for gives it
SOURCES = {"sm90": _SOURCE_SM90, "tf32x3": _SOURCE_TF32X3, "ffma": _SOURCE}
#: the backward's three FFMA kernels, all in _SOURCE_BWD, by launch-count
#: name
BWD_KERNELS = ("bwd_delta", "bwd_dq", "bwd_dkdv")
#: the bf16 wgmma dq and dk/dv kernels, in _SOURCE_BWD_SM90
BWD_SM90_KERNELS = ("bwd_dq_sm90", "bwd_dkdv_sm90")
#: each backward source, by the name bwd_kernel_for gives it
SOURCES_BWD = {"sm90": _SOURCE_BWD_SM90, "ffma": _SOURCE_BWD}
#: head_dim the kernels take: a multiple of 8 (16-byte bf16 rows), <= 256
HEAD_MULT = 8
MAX_HEAD_DIM = 256
#: head_dim the sm90 kernel takes (bf16 only)
SM90_HEAD_DIMS = (64, 128)
#: head_dim the tf32x3 kernel takes (float32 only)
TF32X3_HEAD_DIM = 64
#: head_dim the sm90 backward takes (bf16 only)
BWD_SM90_HEAD_DIMS = (64, 128)
#: what each wgmma kernel takes, for the refusal of a launch by name
_TAKES = {"sm90": "bfloat16 at head_dim %s" % (SM90_HEAD_DIMS,),
          "tf32x3": "float32 at head_dim %d" % TF32X3_HEAD_DIM}
_MAX_BH = 65535  # gridDim.y of the ffma kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None        # flash_fwd.cu's library
_lib_sm90 = None   # flash_fwd_sm90.cu's library
_lib_tf32x3 = None  # flash_fwd_tf32x3.cu's library
_lib_bwd = None    # flash_bwd.cu's library
_lib_bwd_sm90 = None  # flash_bwd_sm90.cu's library
_lib_lock = threading.Lock()


def kernel_for(dtype, head_dim):
    """The kernel a CUDA launch takes: ``"sm90"`` for bf16 at head_dim
    64 or 128, ``"tf32x3"`` for float32 at head_dim 64, ``"ffma"`` for
    everything else the wrapper accepts."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    if dtype == torch.float32 and head_dim == TF32X3_HEAD_DIM:
        return "tf32x3"
    return "ffma"


def bwd_kernel_for(dtype, head_dim):
    """The dq and dk/dv kernels a CUDA backward takes: ``"sm90"`` for
    bf16 at head_dim 64 or 128, ``"ffma"`` for everything else the
    wrapper accepts. The one place that decides; ``bwd_delta`` runs
    before either."""
    if dtype == torch.bfloat16 and head_dim in BWD_SM90_HEAD_DIMS:
        return "sm90"
    return "ffma"


def bwd_kernel_names(kernel):
    """The launch-count names of a backward by ``kernel`` (``"sm90"``
    or ``"ffma"``): delta, dq, dk/dv."""
    sfx = "_sm90" if kernel == "sm90" else ""
    return ("bwd_delta", "bwd_dq" + sfx, "bwd_dkdv" + sfx)


def bind(lib):
    """Declare flash_fwd.cu's C entry points' types on its library."""
    p = ctypes.c_void_p
    # q k v o lse bh s sk d sm_scale causal dtype stream
    lib.edl_flash_fwd.argtypes = [
        p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, p]
    lib.edl_flash_fwd.restype = ctypes.c_int
    lib.edl_flash_error_string.argtypes = [ctypes.c_int]
    lib.edl_flash_error_string.restype = ctypes.c_char_p
    return lib


def _bind_wgmma(lib, kernel):
    """Declare the C entry points of a wgmma kernel's library
    (``edl_flash_fwd_<kernel>`` and ``edl_flash_<kernel>_error_string``,
    the same types for both wgmma kernels)."""
    p = ctypes.c_void_p
    fn = getattr(lib, "edl_flash_fwd_" + kernel)
    # q k v o lse bh s sk d sm_scale causal stream
    fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    what = getattr(lib, "edl_flash_%s_error_string" % kernel)
    what.argtypes = [ctypes.c_int]
    what.restype = ctypes.c_char_p
    return lib


def bind_sm90(lib):
    """Declare flash_fwd_sm90.cu's C entry points' types on its
    library."""
    return _bind_wgmma(lib, "sm90")


def bind_tf32x3(lib):
    """Declare flash_fwd_tf32x3.cu's C entry points' types on its
    library."""
    return _bind_wgmma(lib, "tf32x3")


def bind_bwd(lib):
    """Declare flash_bwd.cu's C entry points' types on its library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i, i, i, i, f, i, i, p]  # bh s sk d sm_scale causal dtype stream
    # o g delta bh s d dtype stream
    lib.edl_flash_bwd_delta.argtypes = [p, p, p, i, i, i, i, p]
    lib.edl_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p] + dims
    lib.edl_flash_bwd_dkdv.argtypes = [p, p, p, p, p, p, p, p] + dims
    for name in ("delta", "dq", "dkdv"):
        getattr(lib, "edl_flash_bwd_" + name).restype = ctypes.c_int
    lib.edl_flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.edl_flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bind_bwd_sm90(lib):
    """Declare flash_bwd_sm90.cu's C entry points' types on its
    library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i, i, i, i, f, i, p]  # bh s sk d sm_scale causal stream
    lib.edl_flash_bwd_dq_sm90.argtypes = [p, p, p, p, p, p, p] + dims
    lib.edl_flash_bwd_dkdv_sm90.argtypes = [p, p, p, p, p, p, p, p] + dims
    for name in ("dq", "dkdv"):
        getattr(lib, "edl_flash_bwd_%s_sm90" % name).restype = ctypes.c_int
    lib.edl_flash_bwd_sm90_error_string.argtypes = [ctypes.c_int]
    lib.edl_flash_bwd_sm90_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_lib(kernel="ffma"):
    """The built library of ``kernel`` (a forward kernel's name,
    ``"bwd"`` or ``"bwd_sm90"``; nvcc on first use, under a file
    lock)."""
    global _lib, _lib_sm90, _lib_tf32x3, _lib_bwd, _lib_bwd_sm90
    with _lib_lock:
        if kernel == "bwd":
            if _lib_bwd is None:
                _lib_bwd = bind_bwd(buildlock.load(_SOURCE_BWD))
            return _lib_bwd
        if kernel == "bwd_sm90":
            if _lib_bwd_sm90 is None:
                _lib_bwd_sm90 = bind_bwd_sm90(buildlock.load(
                    _SOURCE_BWD_SM90))
            return _lib_bwd_sm90
        if kernel == "sm90":
            if _lib_sm90 is None:
                _lib_sm90 = bind_sm90(buildlock.load(_SOURCE_SM90))
            return _lib_sm90
        if kernel == "tf32x3":
            if _lib_tf32x3 is None:
                _lib_tf32x3 = bind_tf32x3(buildlock.load(_SOURCE_TF32X3))
            return _lib_tf32x3
        if _lib is None:
            _lib = bind(buildlock.load(_SOURCE))
        return _lib


def build():
    """Build (if needed) and load every kernel source, one nvcc each,
    side by side; returns ``{name: (path, seconds, log)}`` for the build
    report, the backward's sources under ``"bwd"`` and
    ``"bwd_sm90"``."""
    sources = dict(SOURCES, bwd=_SOURCE_BWD, bwd_sm90=_SOURCE_BWD_SM90)
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(buildlock.build, src)
                   for name, src in sources.items()}
        reports = {name: f.result() for name, f in futures.items()}
    for name in sources:
        _kernel_lib(name)
    return reports


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


def blockwise_reference(q, k, v, causal, sm_scale, block_k=512,
                        return_lse=False):
    """The plain version of the kernel: O(seq)-memory attention by a loop
    over kv blocks with f32 online softmax — the port of the JAX
    package's ``_blockwise_reference``. With ``return_lse``, (out, lse):
    lse = m + log(max(l, 1e-30)), f32 [b, h, s], from the same loop, as
    the kernels write it for the backward."""
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
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return (out, m + torch.log(l)) if return_lse else out


def _row_stats(q32, kb, n_blocks, block_k, s, sk, causal):
    """The backward's pass 1: each q row's running max m and sum l of
    exp(scores - m) over the masked scores (l not clamped)."""
    b, h = q32.shape[:2]
    m = torch.full((b, h, s), _NEG_INF, dtype=torch.float32,
                   device=q32.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q32.device)
    for ki in range(n_blocks):
        mask = _block_mask(ki, block_k, s, sk, causal, q32.device)
        scores = torch.einsum("bhqd,bhkd->bhqk", q32, kb[ki])
        scores = torch.where(mask, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        l = l * torch.exp(m - m_new) + torch.where(
            mask, torch.exp(scores - m_new[..., None]), 0.0).sum(-1)
        m = m_new
    return m, l


def flash_bwd_reference(q, k, v, out, g, causal, sm_scale, block_k=512,
                        lse=None):
    """The plain version of the backward kernels: the port of the JAX
    package's ``_flash_bwd``, step by step. Pass 1 recomputes the row
    statistics (m, l), l clamped at 1e-30, and delta = rowsum(g * out);
    given the forward's ``lse`` (f32 [b, h, s]) it takes p = exp(s - lse)
    from it instead, as the kernels do, and pass 1 is delta alone. Pass
    2, per kv block: dv = p^T g, dp = g v^T, ds = p (dp - delta), dq +=
    sm_scale ds k, dk = ds^T (q sm_scale). Memory stays O(seq x (d +
    block_k)). Returns (dq, dk, dv) in the inputs' dtype."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    q32 = q.float() * sm_scale
    g32 = g.float()
    kb, vb, n_blocks = _block_layout(k, v, block_k)
    if lse is None:
        m, l = _row_stats(q32, kb, n_blocks, block_k, s, sk, causal)
        l = torch.clamp_min(l, 1e-30)
        probs = lambda scores: (torch.exp(scores - m[..., None])
                                / l[..., None])
    else:
        probs = lambda scores: torch.exp(scores - lse[..., None])
    delta = flash_bwd_delta_reference(out, g)
    dq = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for ki in range(n_blocks):
        mask = _block_mask(ki, block_k, s, sk, causal, q.device)
        scores = torch.einsum("bhqd,bhkd->bhqk", q32, kb[ki])
        scores = torch.where(mask, scores, _NEG_INF)
        p = torch.where(mask, probs(scores), 0.0)
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, g32))
        dp = torch.einsum("bhqd,bhkd->bhqk", g32, vb[ki])
        ds = p * (dp - delta[..., None])
        dq = dq + sm_scale * torch.einsum("bhqk,bhkd->bhqd", ds, kb[ki])
        # q32 carries one sm_scale: dk_j = sm_scale * sum_i ds_ij q_i
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, q32))
    dk = torch.cat(dks, dim=2)[:, :, :sk]
    dv = torch.cat(dvs, dim=2)[:, :, :sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_stats_reference(q, k, out, g, causal, sm_scale, block_k=512):
    """The JAX backward's pass 1 alone: (lse, delta), f32 [b, h, s], with
    lse = m + log(max(l, 1e-30)) from (m, l) recomputed over the masked
    scores and delta = rowsum(g * out). The plain version that the
    forward kernels' lse and ``bwd_delta`` are held against."""
    s, sk = q.shape[2], k.shape[2]
    kb, _, n_blocks = _block_layout(k, k, block_k)
    m, l = _row_stats(q.float() * sm_scale, kb, n_blocks, block_k, s, sk,
                      causal)
    return (m + torch.log(torch.clamp_min(l, 1e-30)),
            flash_bwd_delta_reference(out, g))


def flash_bwd_delta_reference(out, g):
    """The plain version of the ``bwd_delta`` kernel: delta =
    rowsum(g * out) in f32, [b, h, s]."""
    return (g.float() * out.float()).sum(-1)


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


def _check_launch(q, k, tensors):
    """Raise on what the CUDA kernels do not take: the dtype, head_dim,
    batch*heads and lengths of q [b, h, s, d] and k [b, h, sk, d], and
    each of ``tensors`` ({name: tensor}) not contiguous or not 16-byte
    aligned."""
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
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError("flash kernel takes contiguous tensors; %s is "
                             "not" % name)
        if t.data_ptr() % 16:
            raise ValueError("flash kernel takes 16-byte aligned tensors; "
                             "%s is not" % name)


def _check_lse(q, lse, what):
    """Raise unless ``lse`` is f32 [b, h, s] of q [b, h, s, d], on q's
    device (contiguity and alignment: :func:`_check_launch`)."""
    if lse.dtype != torch.float32 or lse.shape != q.shape[:3] \
            or lse.device != q.device:
        raise ValueError("%s takes lse as float32 %s on %s, got %s %s on %s"
                         % (what, tuple(q.shape[:3]), q.device, lse.dtype,
                            tuple(lse.shape), lse.device))


def _launch(q, k, v, causal, sm_scale, kernel=None, lse=None):
    """Launch a CUDA kernel on the current stream: ``kernel`` ("sm90",
    "tf32x3" or "ffma"), by default the one :func:`kernel_for` picks.
    Given ``lse`` (f32 [b, h, s]), the kernel also writes each q row's
    m + log(max(l, 1e-30)) there, for the backward. Raises on anything
    that kernel does not take, before any library loads."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    tensors = dict(q=q, k=k, v=v)
    if lse is not None:
        _check_lse(q, lse, "the flash forward")
        tensors["lse"] = lse
    _check_launch(q, k, tensors)
    kernel = kernel or kernel_for(q.dtype, d)
    if kernel in _TAKES and kernel_for(q.dtype, d) != kernel:
        raise ValueError("the %s flash kernel takes %s, got %s at %d"
                         % (kernel, _TAKES[kernel], q.dtype, d))
    if kernel not in SOURCES:
        raise ValueError("no flash kernel %r" % (kernel,))
    lib = _kernel_lib(kernel)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b * h, s, sk, d,
            float(sm_scale), int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == "ffma":
            err = lib.edl_flash_fwd(*args, _DTYPES[q.dtype], stream)
            what = lib.edl_flash_error_string
        else:
            err = getattr(lib, "edl_flash_fwd_" + kernel)(*args, stream)
            what = getattr(lib, "edl_flash_%s_error_string" % kernel)
    if err != 0:
        raise RuntimeError("flash kernel %s launch failed: error %d (%s)"
                           % (kernel, err, what(err).decode()))
    flash_attention.launches += 1
    flash_attention.kernel_launches[kernel] += 1
    return out


def _bwd_call(name, fn, what, *args):
    """Run the backward entry point ``fn`` on the current stream and
    count its launch under ``name``; raise on its error code, worded by
    ``what``."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError("flash kernel %s launch failed: error %d (%s)"
                           % (name, err, what(err).decode()))
    flash_attention.launches += 1
    flash_attention.kernel_launches[name] += 1


def _bwd_entry(kernel, stage):
    """The launch-count name, C entry point and error-string function of
    ``stage`` ("dq" or "dkdv") of the backward by ``kernel``."""
    if kernel == "sm90":
        lib = _kernel_lib("bwd_sm90")
        return ("bwd_%s_sm90" % stage,
                getattr(lib, "edl_flash_bwd_%s_sm90" % stage),
                lib.edl_flash_bwd_sm90_error_string)
    lib = _kernel_lib("bwd")
    return ("bwd_" + stage, getattr(lib, "edl_flash_bwd_" + stage),
            lib.edl_flash_bwd_error_string)


def _bwd_dims(q, k, causal, sm_scale, kernel="ffma"):
    """The trailing arguments of a backward entry point: bh, s, sk, d,
    sm_scale, causal, (FFMA's dtype code), the current stream."""
    b, h, s, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dtype = () if kernel == "sm90" else (_DTYPES[q.dtype],)
    return (b * h, s, k.shape[2], d, float(sm_scale), int(bool(causal)),
            *dtype, stream)


def _bwd_kernel(q, k, tensors, kernel):
    """Check what the dq or dk/dv kernels take (``tensors``: {name:
    tensor}) and resolve ``kernel`` (default: :func:`bwd_kernel_for`'s
    pick); raise on a named kernel that does not take the tensors,
    before any library loads."""
    _check_launch(q, k, tensors)
    picked = bwd_kernel_for(q.dtype, q.shape[3])
    kernel = kernel or picked
    if kernel not in SOURCES_BWD:
        raise ValueError("no flash backward kernel %r" % (kernel,))
    if kernel == "sm90" and picked != "sm90":
        raise ValueError("the sm90 flash backward takes bfloat16 at "
                         "head_dim %s, got %s at %d"
                         % (BWD_SM90_HEAD_DIMS, q.dtype, q.shape[3]))
    return kernel


def _bwd_delta(out, g):
    """The ``bwd_delta`` kernel: delta = rowsum(g * out), f32 [b, h, s]."""
    if out.shape != g.shape or out.dtype != g.dtype:
        raise ValueError("bwd_delta takes out and g of one shape and dtype, "
                         "got %s %s and %s %s" % (out.dtype, tuple(out.shape),
                                                  g.dtype, tuple(g.shape)))
    _check_launch(out, g, dict(out=out, g=g))
    b, h, s, d = out.shape
    lib = _kernel_lib("bwd")
    delta = torch.empty((b, h, s), dtype=torch.float32, device=out.device)
    with torch.cuda.device(out.device):
        _bwd_call("bwd_delta", lib.edl_flash_bwd_delta,
                  lib.edl_flash_bwd_error_string, out.data_ptr(),
                  g.data_ptr(), delta.data_ptr(), b * h, s, d,
                  _DTYPES[out.dtype],
                  torch.cuda.current_stream(out.device).cuda_stream)
    return delta


def _bwd_dq(q, k, v, g, lse, delta, causal, sm_scale, kernel=None):
    """The dq kernel: ``kernel`` ("sm90" or "ffma"), by default the one
    :func:`bwd_kernel_for` picks; dq in q's dtype."""
    kernel = _bwd_kernel(q, k, dict(q=q, k=k, v=v, g=g, lse=lse,
                                    delta=delta), kernel)
    entry = _bwd_entry(kernel, "dq")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _bwd_call(*entry, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(),
                  *_bwd_dims(q, k, causal, sm_scale, kernel))
    return dq


def _bwd_dkdv(q, k, v, g, lse, delta, causal, sm_scale, kernel=None):
    """The dk/dv kernel: ``kernel`` ("sm90" or "ffma"), by default the
    one :func:`bwd_kernel_for` picks; (dk, dv) in k's dtype."""
    kernel = _bwd_kernel(q, k, dict(q=q, k=k, v=v, g=g, lse=lse,
                                    delta=delta), kernel)
    entry = _bwd_entry(kernel, "dkdv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _bwd_call(*entry, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  *_bwd_dims(q, k, causal, sm_scale, kernel))
    return dk, dv


def flash_bwd(q, k, v, out, g, lse, causal, sm_scale, kernel=None):
    """The backward on the card: (dq, dk, dv) in the inputs' dtype, from
    the forward's ``lse`` (f32 [b, h, s]), by ``bwd_delta`` and the dq
    and dk/dv kernels of ``kernel`` (default: :func:`bwd_kernel_for`'s
    pick) on the current stream. Raises on what they do not take (the
    forward kernels' domain; ``sm90`` only bf16 at head_dim 64 or 128)
    and on a missing lse, before any library loads: nothing recomputes
    the softmax statistics."""
    if q.dtype != g.dtype or out.dtype != q.dtype:
        raise TypeError("flash backward: q %s, out %s, g %s dtypes differ"
                        % (q.dtype, out.dtype, g.dtype))
    if lse is None:
        raise ValueError("flash backward: no lse from the forward (the CUDA "
                         "backward does not recompute it)")
    _check_lse(q, lse, "the flash backward")
    tensors = dict(q=q, k=k, v=v, out=out, g=g, lse=lse)
    kernel = _bwd_kernel(q, k, tensors, kernel)
    delta = _bwd_delta(out, g)
    dq = _bwd_dq(q, k, v, g, lse, delta, causal, sm_scale, kernel)
    dk, dv = _bwd_dkdv(q, k, v, g, lse, delta, causal, sm_scale, kernel)
    return dq, dk, dv


def _forward(q, k, v, causal, sm_scale, with_lse=False):
    """The output, or with ``with_lse`` (out, lse): the plain version on
    the CPU, the kernel :func:`kernel_for` picks on CUDA."""
    if q.device.type == "cpu":
        return blockwise_reference(q, k, v, causal, sm_scale,
                                   return_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError("flash_attention runs on cuda or cpu, not %s"
                         % q.device)
    if not with_lse:
        return _launch(q, k, v, causal, sm_scale)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, sm_scale, lse=lse), lse


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward dispatches as
    :func:`flash_attention` does and saves (q, k, v, out) as the JAX
    package's ``_vjp_fwd``, and the forward's lse beside them; the
    backward takes p from that lse, by :func:`flash_bwd` on CUDA (the
    kernels :func:`bwd_kernel_for` picks), :func:`flash_bwd_reference`
    on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = _forward(q, k, v, causal, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        if q.device.type == "cpu":
            grads = flash_bwd_reference(q, k, v, out, g, ctx.causal,
                                        ctx.sm_scale, lse=lse)
        else:
            if g.data_ptr() % 16:
                g = g.clone()
            grads = flash_bwd(q, k, v, out, g, lse, ctx.causal, ctx.sm_scale)
        return grads + (None, None)


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Blockwise exact attention; q/k/v/out are [batch, heads, seq, dim].

    CUDA tensors run the kernel :func:`kernel_for` names, CPU tensors
    the plain version. The causal diagonal is anchored at position 0
    (row i sees keys 0..i). Differentiable: when a gradient is wanted,
    the call goes through :class:`FlashAttentionFunction`; otherwise it
    builds no graph."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, sm_scale)
    return _forward(q, k, v, causal, sm_scale)


#: kernel launches since the last reset (the main path's proof of use):
#: the total, and by kernel
flash_attention.launches = 0
flash_attention.kernel_launches = {
    name: 0 for name in tuple(SOURCES) + BWD_KERNELS + BWD_SM90_KERNELS}


def reset_launches():
    """Set every launch count to 0."""
    flash_attention.launches = 0
    for name in flash_attention.kernel_launches:
        flash_attention.kernel_launches[name] = 0


def mha(q, k, v, causal=False, sm_scale=None):
    """:func:`flash_attention` for [batch, seq, heads, dim] layouts (the
    model code's layout): transposes in and out around it."""
    t = lambda x: x.transpose(1, 2).contiguous()
    out = flash_attention(t(q), t(k), t(v), causal, sm_scale)
    return out.transpose(1, 2)
