"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: compile every CUDA kernel of the port from the sources in
   this checkout, one nvcc per source, side by side;
2. kernels: hold each kernel against its plain PyTorch version on the
   card at the shapes the serving path gives it (and in the regimes of
   the TPU kernels it replaces), and time kernel, plain version, and
   one PyTorch library call of the same function as a yardstick. The
   flash forward has three kernels: ``sm90`` (wgmma, bf16 at head_dim
   64 and 128, the served path), ``tf32x3`` (3xTF32 wgmma, f32 at
   head_dim 64, lm_teacher's prefills) and ``ffma`` (the other head
   dims); all are held and timed, ``ffma`` also by name at the served
   bf16 shape and at lm_teacher's longest prefill, and beside every
   f32 ``tf32x3`` row on the same inputs, for the comparison. Every
   case launches its kernel once more with an lse buffer, as the
   training path does: the output must be bit-identical to the launch
   without it, every row's lse within ``LSE_TOL`` of the backward's pass
   1 (``flash_bwd_stats_reference``) and nothing written past the
   rows; that launch is timed too;
3. slice: start the port's full-width GPT-2s ``gpt_teacher`` on the
   card, send ``predict`` requests through the port's ``RpcClient``
   (some concurrent), check the replies, check that every layer's
   attention went through the ``sm90`` kernel and none through the
   others, and check the served logits against the same model run
   with dense attention;
3b. backward kernels: hold the flash backward, as ``flash_bwd``
   dispatches it on the lse that the forward kernel wrote
   (``bwd_delta`` from ``flash_bwd.cu``, then the dq and dk/dv kernels
   ``bwd_kernel_for`` picks: ``flash_bwd_sm90.cu``'s bf16 wgmma
   ``bwd_dq_sm90``/``bwd_dkdv_sm90`` at head_dim 64 and 128,
   ``flash_bwd.cu``'s FFMA ``bwd_dq``/``bwd_dkdv`` otherwise), against
   ``flash_bwd_reference`` (which recomputes the row statistics, as the
   JAX backward does) on the card at the training shapes (GPT-2s
   b8 h12 s1024 causal, BERT-base b32 h12 s512 full, bf16), in f32, at
   ragged, unequal and short kv, d128, d96, the K2 regime and on
   ``paired_inputs`` (nearly cancelling pairs, where a bf16 rounding of
   P or dS would show); at the
   two training shapes also the FFMA dq and dk/dv by name, held to the
   same check; ``bwd_delta`` alone against the plain rowsum(g * out)
   within ``DELTA_RTOL``. Time each kernel, the whole backward, the
   plain version and SDPA's backward (``torch.autograd.grad`` on a
   retained graph, a yardstick the port never calls);
4. decode: start the port's full-width GPT-2s ``lm_teacher`` (f32,
   8 KV slots) on the card and drive its decode plane through the
   ``RpcClient``: 10 concurrent ``lm_generate`` calls (two wait for a
   slot), three prompts sharing a 256-token prefix (one streamed by
   ``lm_submit`` + ``lm_poll``), one ``predict``. Every sequence must
   decode to the tokens of the port's ``generate`` on the same weights
   with dense attention (a mismatch only where the reference's top-2
   logit gap is below the measured logits error between the two
   paths), with one step shape, 12 ``tf32x3`` launches per monolithic
   prefill and none elsewhere, exact prefix-reuse accounting; a second
   engine with chunked prefill must decode two prompts to the same
   tokens, and an int8 ``lm_teacher`` must pass the JAX package's
   quantized gate. Then a closed-loop load of 250 requests from 10
   concurrent clients at the same mix gives TTFT and ITL percentiles
   and tokens/s. The load and a profiled 700-token prefill run twice:
   on ``tf32x3``, the path under test, and again with the f32
   attention sent to ``ffma`` (the kernel it replaced), so that one
   run shows what the kernel moved end to end. Prints those, KV bytes,
   peak memory and a profile of one decode step;
5. train: ``edl_tpu_torch.bench.run_gpt`` at full GPT-2s width (bf16
   over f32 params, remat, ``adamw(1e-4)``, batch 8 x 1024) with flash
   and again with dense attention, then ``run_bert`` at bert-base
   (batch 32 x 512) with flash. Each flash step must launch 24 ``sm90``
   forwards (remat runs the forward twice; each writes its lse) and 12
   each of ``bwd_delta``, ``bwd_dq_sm90`` and ``bwd_dkdv_sm90`` (none of
   the FFMA dq and dk/dv; there is no stats kernel), the dense run
   none; on the same weights and batch the flash
   first-step loss must be within 1e-2 relative of the dense one and
   each parameter's gradient within relative Frobenius 2e-2; every
   loss finite. Prints tokens/s, step ms, implied TFLOP/s, MFU against
   the H100's 989 TFLOP/s bf16, peak memory and a profile of one step
   with the device-busy share;
6. resnet: ``edl_tpu_torch.bench.run`` trains ResNet50_vd at full
   width and depth (batch 128 x 224, s2d stem, bf16 over f32 params
   and BN statistics, ``sgd(0.1, momentum=0.9)``) on the device feed:
   every loss finite, the first within ``RESNET_LOSS0_TOL`` of ln(1000)
   (each block's last BN scale starts at zero). On the same weights and
   batch the first step runs in bf16, f32 (TF32 off) and f64: losses
   and gradients held to f64's (``RESNET_*_RTOL``); the s2d stem is held
   to the plain stride-2 stem on one kernel. A short host-fed run
   (``synthetic_pipeline`` through ``DevicePrefetcher``) prints the
   prefetcher's ``stats()``. Then ``resnet_teacher`` (ResNet50_vd at
   224) serves predicts of 1-64 rows through the port's ``RpcClient``,
   each reply's logits held to the model's direct eval forward of the
   same padded rows, probs rows summing to 1. None of these paths runs
   attention: each must launch no flash kernel. Prints img/s, step ms,
   FLOPs per image, implied TFLOP/s, MFU, peak memory and a profile of
   one step (top kernels, device time by kind, BatchNorm's own device
   time from its profiler ranges, the device-busy share, aten calls).

Prints a ``kernels`` JSON line (the three forward kernels, with and
without lse, and the backward's five, launches by path, the ResNet
paths' zeros included), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when CUDA is unavailable.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from edl_tpu_torch import bench
from edl_tpu_torch.distill.teacher_server import (INIT_SEED, gpt_teacher,
                                                  lm_teacher, resnet_teacher)
from edl_tpu_torch.models import gpt, resnet
from edl_tpu_torch.models.gpt import Gpt
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.runtime import trainer
from edl_tpu_torch.serve.admission import AdmissionController
from edl_tpu_torch.serve.decode_engine import DecodeEngine, _prefill_bucket

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# TF32 on the tensor cores: an f32 product by the 3xTF32 split costs three
PEAK_TF32 = 495e12

# GPT-2 small at a 32000 vocab: edl_tpu_torch Gpt()'s defaults, served as
# gpt_teacher builds it (bf16 activations over f32 params)
GPT2S = dict(num_layers=12, d_model=768, num_heads=12, mlp_dim=3072,
             vocab_size=32000, seq_len=1024)
MAX_BATCH = 4
SEED = 0

# the decode plane at the same widths: lm_teacher builds it in f32
LM = dict(num_layers=12, d_model=768, num_heads=12, mlp_dim=3072,
          vocab_size=32000, max_len=1024)
LM_SLOTS = 8
LM_NEW = 32
# 10 concurrent prompts over 8 slots, lengths spread over 17-700
LM_LENGTHS = [int(n) for n in np.linspace(17, 700, 10).round()]
LM_SHARED, LM_SUFFIXES = 256, (40, 60, 80)
# the engine's warm-up request, before the checked traffic
LM_WARMUP = [50, 51, 52]
# the serving metrics' load: closed loop, LM_LOAD_CLIENTS clients each
# sending its next request when its last one returns, LM_LOAD requests
# in all, prompt lengths uniform over LM_LENGTHS' range
LM_LOAD, LM_LOAD_CLIENTS = 250, 10
# the JAX package's quantized-teacher gate (tests/test_decode_engine.py)
INT8_MAX_REL, INT8_MIN_TOP1 = 0.05, 0.9

# kernel inputs: k and v are unit normal and q has a std of 2.5, so the
# scores (q . k * d**-0.5) have a std of 2.5. The softmax is then peaked:
# the running max and the rescale of the accumulator decide the output,
# whose mean magnitude is 0.2-0.5.
Q_STD = 2.5
# kernel vs plain version on the same inputs, elementwise:
# |out - ref| <= atol + rtol * |ref|. In bf16 both round f32 results that
# agree to about 2e-6, so they differ by at most one bf16 ulp (at most
# 2**-7 of the value); in f32 only the order of summation differs.
KERNEL_TOL = {torch.bfloat16: (1e-4, 2.0 ** -7),
              torch.float32: (1e-5, 1e-5)}
# a forward kernel's lse vs the backward's pass 1 on the same inputs
# (flash_bwd_stats_reference), elementwise: |lse - ref| <= atol + rtol
# |ref|. Both are f32 m + log(max(l, 1e-30)) over the same scaled scores,
# of magnitude up to ~10 at Q_STD, summed in other orders (and, where the
# scale is not a power of two, scaled after the product where the
# reference scales q first): they differ by about 1e-6. An lse without
# log(l) is off by up to log(sk).
LSE_TOL = (1e-4, 1e-5)
# bwd_delta vs the plain rowsum(g * out) on the same inputs, by row:
# |got - ref| <= DELTA_RTOL * rowsum(|g * out|). Both sum the same f32
# products (exact from bf16) in other orders: d * 2**-24 of the sum of
# magnitudes bounds that at d = 256, the widest head the kernel takes.
DELTA_RTOL = 2.0 ** -16
# served logits (flash) vs the same model with dense attention: the dense
# path rounds q * scale to bf16 before its f32 upcast, flash scales after
# it, and the difference passes through 12 bf16 layers. Allowed: four
# bf16 ulps at |logits| < 8 (4 * 2**-5); the run checks the magnitude.
SERVE_TOL = 4 * 2.0 ** -5
# the backward kernels vs flash_bwd_reference on the same inputs,
# elementwise: |got - ref| <= rtol * |ref| + atol. f32: the reference
# suite's gradient tolerance (tests/test_flash_attention.py:61), atol
# 1e-4 and rtol 1e-4. bf16: both compute in f32 from the same bf16
# inputs and round once at the end, so one bf16 ulp (2**-7 of the value)
# plus, where terms cancel, 2**-9 of the gradient's largest magnitude.
BWD_TOL = {torch.float32: lambda ref: (1e-4, 1e-4),
           torch.bfloat16: lambda ref: (2.0 ** -9 * ref.abs().max().item(),
                                        2.0 ** -7)}
# paired_inputs' noise: at b1 h2 s=sk=256 and b4 h12 s=sk=1024 (full), a
# bf16 rounding of P or dS in one product misses BWD_TOL by 16-88x and
# the hi/lo split passes it within 0.06 of the atol (CPU emulation,
# tests/test_torch_flash_numerics.py)
PAIR_EPS = 0.05
# the train phase: GPT-2s training as bench.py runs it, a few steps
TRAIN_WARMUP, TRAIN_ITERS = 2, 8
# flash vs dense attention on the same weights and batch, both in bf16
# activations: the first-step loss within 1e-2 relative, each parameter's
# gradient within relative Frobenius 2e-2
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-2, 2e-2
# the resnet phase: ResNet50_vd as bench.run trains it (batch 128 x 224,
# s2d, bf16 over f32 params and BN statistics, sgd(0.1, momentum 0.9))
RESNET_BATCH, RESNET_IMAGE = 128, 224
RESNET_WARMUP, RESNET_ITERS = 3, 10
HOSTFED_WARMUP, HOSTFED_ITERS = 2, 5
# the first loss: bn3 starts at zero, so every residual branch is off
# and the head sees the shortcut path alone; its logits are O(1), the
# loss within RESNET_LOSS0_TOL of ln(1000)
RESNET_LOSS0_TOL = 1.0
# the first step on the same weights (each bn3 scale set to 0.25, so
# that no gradient is zero by construction) and batch, in bf16, f32 (TF32
# off) and f64: the f32 loss within RESNET_F32_LOSS_RTOL of f64 and each
# f32 gradient within relative Frobenius RESNET_GRAD_RTOL (GPT's limit)
# of f64's; the bf16 loss within RESNET_LOSS_RTOL relative (GPT's) and
# the bf16 gradient, all leaves together and its median leaf, within
# relative Frobenius RESNET_BF16_GRAD_RTOL of f64's. BatchNorm's backward
# subtracts from each cotangent its projections on 1 and on the
# normalized input, so the bf16 rounding of the cotangents leaves the
# gradient noisy. The JAX package's own bf16 gradient does the same: at
# ResNet50_vd's widths on the CPU (`python tests/test_torch_resnet.py`,
# the same weights as here, batch 16 at 64 px) it sits 0.45 from its f64
# one over all leaves, 0.43 for the median leaf, 0.69 for its worst
# leaf (b32 at 128 px: 0.43, 0.44, 0.65). The limit is 4/3 of that, well
# apart from the 1.0 that a zero gradient reads; each leaf is held within
# RESNET_BF16_LEAF_RTOL, under that 1.0 (a sign flip reads 2)
RESNET_F32_LOSS_RTOL, RESNET_LOSS_RTOL = 1e-5, 1e-2
RESNET_GRAD_RTOL, RESNET_BF16_GRAD_RTOL = 2e-2, 0.6
RESNET_BF16_LEAF_RTOL = 0.9
# the s2d stem vs the plain stride-2 stem on the same kernel and images,
# both in f32 with TF32 off: only the order of the 27 products differs
S2D_TOL = 1e-5
# the served logits vs the model's direct eval forward of the same rows
# padded as the server pads them (zeros), relative to |logits| max: one
# bf16 ulp, for a batch position that changes the conv algorithm's order
TEACHER_TOL = 2.0 ** -7
# a ResNet step's kernels by kind, from their names (first match wins):
# the pools, PyTorch's reductions (BN statistics and their backward
# sums), its elementwise kernels (BN, ReLU, adds, casts, the optimizer),
# and cuDNN's and CUTLASS's convolutions with their layout transforms
RESNET_KERNEL_GROUPS = {
    "pool": ("pool",),
    "reduce": ("reduce_kernel",),
    "elementwise": ("elementwise", "foreach", "CatArrayBatched",
                    "copy_kernel"),
    "conv": ("xmma", "cutlass", "cudnn", "conv", "implicit", "gemm",
             "wgrad", "dgrad", "fprop", "nchw", "nhwc"),
}


# ops/batch_norm.py's profiler ranges: BatchNorm's own kernels (its
# casts, statistics, normalization and backward), apart from the
# elementwise kernels of ReLU, the residual adds and the optimizer
BN_RANGES = ("batch_norm", "batch_norm_backward")


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def log(msg):
    print(msg, flush=True)


def build(gpu):
    """Phase 1: nvcc on each kernel source (side by side), with ptxas's
    register report."""
    t0 = time.monotonic()
    reports = fa.build()
    for name, (path, secs, text) in reports.items():
        log("build: %s %s in %.1fs [%s]" % (name, os.path.basename(path),
                                             secs, gpu))
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
    log("build: %d kernel sources in %.1fs of wall time"
        % (len(reports), time.monotonic() - t0))


def only(kernel, n, **more):
    """Launch counts by kernel: ``n`` of ``kernel`` and ``more`` of the
    kernels it names, none of the rest."""
    want = dict(more, **{kernel: n})
    return {name: want.get(name, 0)
            for name in fa.flash_attention.kernel_launches}


@contextlib.contextmanager
def f32_attention_on(kernel):
    """Send the port's f32 head_dim-64 attention to ``kernel`` inside the
    block (``"ffma"``: the path as it was before ``tf32x3``), for a
    comparison within one run."""
    pick = fa.kernel_for
    fa.kernel_for = lambda dtype, d: (
        kernel if (dtype, d) == (torch.float32, 64) else pick(dtype, d))
    try:
        yield
    finally:
        fa.kernel_for = pick


def time_ms(fn, flush, reps):
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush (the serving path finds its q/k/v cold), by CUDA events."""
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, key="flash_fwd", flush=None, reps=5):
    """Device time of one call of ``fn`` by torch.profiler, the mean over
    ``reps`` calls: the time of the kernels whose name holds ``key``
    (None: every kernel), without the idle gaps that CUDA events also
    count around a launch that takes tens of microseconds. Calls run
    back to back (L2 warm), or each after an L2 flush by ``flush`` (then
    ``key`` names the kernel, so the flush's own is not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and (key is None or key in e.key))
    return us / 1e3 / reps


def flash_bound_ms(b, h, s, sk, d, dtype, causal):
    """Least time for the function: q, k, v read once, o written once,
    over the memory rate; or the operations these inputs need (two
    products, 2 flops per multiply-add; under causal, row i meets
    min(i + 1, sk) keys) over the peak rate for the input type, the
    larger. f32 operations take the smaller of the CUDA cores' f32 time
    and three TF32 passes on the tensor cores (the 3xTF32 split).
    Returns (ms, "bytes" or "operations", the rate the operations
    took)."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * (2 * s * d + 2 * sk * d) * item
    keys = sum(min(i + 1, sk) for i in range(s)) if causal else s * sk
    flops = 4 * d * keys * b * h
    t_ops, rate = flops / PEAK_FLOPS[dtype], (
        "bf16 tensor cores" if dtype == torch.bfloat16 else "f32 CUDA cores")
    if dtype == torch.float32 and 3 * flops / PEAK_TF32 < t_ops:
        t_ops, rate = 3 * flops / PEAK_TF32, "3xTF32 tensor cores"
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), rate


def flash_inputs(b, h, s, sk, d, dtype, gen, device="cuda"):
    """q [b, h, s, d] and k, v [b, h, sk, d] on ``device`` (the card),
    from ``gen``."""
    mk = lambda n, std: (torch.randn((b, h, n, d), generator=gen,
                                     device=device) * std).to(dtype)
    return mk(s, Q_STD), mk(sk, 1.0), mk(sk, 1.0)


def paired_inputs(b, h, s, sk, d, dtype, gen, device="cuda"):
    """The backward's cancellation case: q, k, v as ``flash_inputs`` and g
    unit normal, then query rows and keys in pairs (s and sk even): each
    odd row of q and k is the even one plus ``PAIR_EPS`` of unit noise,
    each odd row of g and v the even one negated. dq, dk and dv are then
    sums of nearly cancelling pairs, where a bf16 rounding of P or dS
    shows."""
    mk = lambda n, std: torch.randn((b, h, n, d), generator=gen,
                                    device=device) * std
    q, k, v, g = mk(s, Q_STD), mk(sk, 1.0), mk(sk, 1.0), mk(s, 1.0)
    q[:, :, 1::2] = q[:, :, 0::2] + PAIR_EPS * mk(s // 2, 1.0)
    k[:, :, 1::2] = k[:, :, 0::2] + PAIR_EPS * mk(sk // 2, 1.0)
    g[:, :, 1::2] = -g[:, :, 0::2]
    v[:, :, 1::2] = -v[:, :, 0::2]
    return tuple(x.to(dtype) for x in (q, k, v, g))


def check_flash(out, ref, dtype, case):
    """Hold a kernel output against its plain version's within
    ``KERNEL_TOL``; returns the max abs error."""
    atol, rtol = KERNEL_TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    excess = (diff - rtol * ref.float().abs()).max().item()
    err = diff.max().item()
    if not torch.isfinite(out).all() or not excess <= atol:
        raise AssertionError(
            "flash kernel disagrees with its plain version: %s max_abs_err "
            "%g, max of |out - ref| - %g |ref| is %g > %g"
            % (case, err, rtol, excess, atol))
    return err


def launch_with_lse(q, k, v, causal, kernel=None, tail=0):
    """The forward kernel ``kernel`` (default: the one ``kernel_for``
    picks) with an lse buffer, as the training path launches it: (out,
    lse). With ``tail``, lse is the front of a NaN buffer ``tail`` values
    longer (lse's own rows NaN too before the launch), so that a row
    left unwritten, or a write past the rows, shows."""
    d = q.shape[-1]
    n = q.shape[:3].numel()
    buf = torch.full((n + tail,), float("nan"), device=q.device)
    lse = buf[:n].view(q.shape[:3])
    out = fa._launch(q, k, v, causal, d ** -0.5, kernel, lse=lse)
    if tail:
        torch.cuda.synchronize()
        if not torch.isnan(buf[n:]).all():
            raise AssertionError("flash kernel %s wrote past lse's rows"
                                 % kernel)
    return out, lse


def check_lse(lse, ref, case):
    """Hold a forward kernel's lse against the backward's pass 1 within
    ``LSE_TOL``; returns the max abs error."""
    atol, rtol = LSE_TOL
    diff = (lse - ref).abs()
    excess = (diff - rtol * ref.abs()).max().item()
    err = diff.max().item()
    if not torch.isfinite(lse).all() or not excess <= atol:
        raise AssertionError(
            "flash kernel lse disagrees with the backward's pass 1: %s "
            "max_abs_err %g, max of |lse - ref| - %g |ref| is %g > %g"
            % (case, err, rtol, excess, atol))
    return err


def check_delta(delta, out, g, case):
    """Hold ``bwd_delta``'s output against the plain rowsum(g * out)
    within ``DELTA_RTOL`` of each row's sum of magnitudes; returns the
    max abs error."""
    prod = g.float() * out.float()
    diff = (delta - prod.sum(-1)).abs()
    limit = DELTA_RTOL * prod.abs().sum(-1)
    if not torch.isfinite(delta).all() or not (diff <= limit).all():
        raise AssertionError(
            "bwd_delta disagrees with its plain version: %s max_abs_err %g, "
            "worst |got - ref| / rowsum|g * out| %g > %g"
            % (case, diff.max().item(),
               (diff / limit.clamp_min(1e-30)).max().item() * DELTA_RTOL,
               DELTA_RTOL))
    return diff.max().item()


def kernel_phase(gpu):
    """Phase 2: the flash kernels vs their plain version, timed. A case
    names its kernel: None for the one ``kernel_for`` picks, the way the
    served path launches it, or "ffma" to run flash_fwd.cu on a shape
    that the served path sends to another kernel. Every f32 row of
    ``tf32x3`` also times ``ffma`` on the same inputs. Every case also
    launches its kernel with an lse buffer (``launch_with_lse``): the
    output bit-identical, the lse within ``LSE_TOL`` of the backward's
    pass 1, timed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (b, h, s, sk, d, dtype, causal, what, kernel)
        (MAX_BATCH, 12, 1024, 1024, 64, bf16, True, "slice"),
        (MAX_BATCH, 12, 1024, 1024, 64, bf16, False, "slice"),
        (MAX_BATCH, 12, 1024, 1024, 64, bf16, True, "slice", "ffma"),
        (MAX_BATCH, 6, 1024, 1024, 128, bf16, True, "d128"),
        (MAX_BATCH, 6, 1024, 1024, 128, bf16, False, "d128"),
        (MAX_BATCH, 12, 1000, 1000, 64, bf16, True, "ragged sk"),
        (MAX_BATCH, 12, 1000, 1000, 64, bf16, False, "ragged sk"),
        (MAX_BATCH, 12, 100, 1000, 64, bf16, False, "sk != s"),
        (MAX_BATCH, 12, 100, 1000, 64, bf16, True, "sk != s"),
        # 40 of the one kv tile's 64 rows lie beyond sk: the ragged mask
        # decides the output
        (MAX_BATCH, 12, 1024, 24, 64, bf16, False, "short sk"),
        (1, 2, 16640, 16640, 64, bf16, True, "K+V > 4 MiB"),
        # f32 at head_dim 64 (tf32x3) in the same regimes
        (MAX_BATCH, 12, 1024, 1024, 64, f32, True, "f32"),
        (MAX_BATCH, 12, 1024, 1024, 64, f32, False, "f32"),
        (MAX_BATCH, 12, 1000, 1000, 64, f32, True, "ragged sk"),
        (MAX_BATCH, 12, 100, 1000, 64, f32, False, "sk != s"),
        (MAX_BATCH, 12, 100, 1000, 64, f32, True, "sk != s"),
        (MAX_BATCH, 12, 1024, 24, 64, f32, False, "short sk"),
        (1, 2, 16640, 16640, 64, f32, True, "K+V > 4 MiB"),
    ]
    # lm_teacher's monolithic prefills: b1 h12 d64 f32 causal at every
    # power-of-two prompt bucket that the decode phase sends; the longest
    # also on the kernel tf32x3 replaced there
    cases += [(1, 12, s, s, 64, f32, True, "lm prefill")
              for s in lm_buckets()]
    cases += [(1, 12, LM["max_len"], LM["max_len"], 64, f32, True,
               "lm prefill", "ffma")]
    results = []
    for b, h, s, sk, d, dtype, causal, what, *forced in cases:
        kernel = forced[0] if forced else fa.kernel_for(dtype, d)
        q, k, v = flash_inputs(b, h, s, sk, d, dtype, gen)
        by_name = lambda name: fa._launch(q, k, v, causal, d ** -0.5, name)
        if forced:
            run = lambda: by_name(kernel)
        else:
            run = lambda: fa.flash_attention(q, k, v, causal)
        out = run()
        torch.cuda.synchronize()
        ref = fa.blockwise_reference(q, k, v, causal, d ** -0.5)
        err = check_flash(out, ref, dtype,
                          (kernel, b, h, s, sk, d, dtype, causal))
        atol, rtol = KERNEL_TOL[dtype]
        margin = ((out.float() - ref.float()).abs()
                  - rtol * ref.float().abs()).max().item() / atol
        mean_ref = ref.float().abs().mean().item()
        out_lse, lse = launch_with_lse(q, k, v, causal, kernel, tail=64)
        if not torch.equal(out_lse, out):
            raise AssertionError("flash kernel %s: the output with lse is "
                                 "not the output without it" % kernel)
        lse_err = check_lse(lse, fa.flash_bwd_stats_reference(  # its lse
            q, k, out, out, causal, d ** -0.5)[0],
            (kernel, b, h, s, sk, d, dtype, causal))
        del out_lse, lse
        reps = 20 if s <= 1024 else 5
        ms = time_ms(run, flush, reps)
        # the training path's launch: lse allocated, not filled
        lse_buf = torch.empty(q.shape[:3], device="cuda")
        with_lse = lambda: fa._launch(q, k, v, causal, d ** -0.5, kernel,
                                      lse=lse_buf)
        lse_ms = time_ms(with_lse, flush, reps)
        ffma_ms = dev_ms = lse_dev_ms = ffma_dev_ms = None
        if kernel == "tf32x3":
            ffma_ms = time_ms(lambda: by_name("ffma"), flush, reps)
        if what in ("slice", "lm prefill"):
            dev_ms, lse_dev_ms = device_ms(run), device_ms(with_lse)
            if kernel == "tf32x3":
                ffma_dev_ms = device_ms(lambda: by_name("ffma"))
        plain_ms = time_ms(lambda: fa.blockwise_reference(
            q, k, v, causal, d ** -0.5), flush, max(3, reps // 4))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal), flush, reps)
        bound_ms, bound_by, bound_rate = flash_bound_ms(b, h, s, sk, d,
                                                        dtype, causal)
        row = dict(kernel=kernel, shape=[b, h, s, sk, d],
                   dtype=str(dtype).split(".")[-1],
                   causal=causal, what=what, max_abs_err=err,
                   excess_over_atol=margin, mean_abs_out=mean_ref, ms=ms,
                   lse_ms=lse_ms, lse_max_abs_err=lse_err,
                   ffma_ms=ffma_ms, device_ms=dev_ms,
                   lse_device_ms=lse_dev_ms,
                   ffma_device_ms=ffma_dev_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_rate=bound_rate)
        log("kernel flash_fwd %s b=%d h=%d s=%d sk=%d d=%d %s %s (%s): "
            "max_abs_err %.3g (tol %g + %g |ref|, worst excess %.3g of the "
            "atol; mean |ref| %.3g), lse max_abs_err %.3g; kernel %.4f ms, "
            "with lse %.4f ms%s, plain %.4f ms, sdpa %.4f ms, bound %.2f us "
            "(%s, %s)%s [%s]"
            % (kernel, b, h, s, sk, d, row["dtype"],
               "causal" if causal else "full", what, err,
               *KERNEL_TOL[dtype], margin, mean_ref, lse_err, ms, lse_ms,
               "" if ffma_ms is None else ", ffma %.4f ms" % ffma_ms,
               plain_ms, library_ms, bound_ms * 1e3, bound_by, bound_rate,
               "" if dev_ms is None else "; profiled device time %.4f ms, "
               "with lse %.4f ms%s" % (dev_ms, lse_dev_ms,
                                       "" if ffma_dev_ms is None
                                       else ", ffma %.4f ms" % ffma_dev_ms),
               gpu))
        results.append(row)
    del flush
    return results


def check_grads(got, want, dtype, case):
    """Hold the backward kernels' (dq, dk, dv) against the plain
    version's within ``BWD_TOL``; returns (max abs error, worst excess
    over the check as a share of its atol)."""
    err, margin = 0.0, 0.0
    for name, out, ref in zip(("dq", "dk", "dv"), got, want):
        atol, rtol = BWD_TOL[dtype](ref.float())
        diff = (out.float() - ref.float()).abs()
        excess = (diff - rtol * ref.float().abs()).max().item()
        if not torch.isfinite(out).all() or not excess <= atol:
            raise AssertionError(
                "flash backward disagrees with its plain version: %s %s "
                "max_abs_err %g, max of |got - ref| - %g |ref| is %g > %g"
                % (case, name, diff.max().item(), rtol, excess, atol))
        err = max(err, diff.max().item())
        # an all-zero reference (one key per row: dq and dk vanish) has a
        # zero atol; the check then held got to zero as well
        margin = max(margin, excess / atol if atol else 0.0)
    return err, margin


def bwd_bound_ms(b, h, s, sk, d, dtype, causal, stage):
    """Least time for one stage of the backward (``"bwd_delta"``,
    ``"bwd_dq"``, ``"bwd_dkdv"``, or ``"all"``: the whole function): its
    inputs read once and outputs written once over the memory rate, or
    its products (2 d flops per (query, key) pair each; under causal,
    row i meets min(i + 1, sk) keys) over the input type's peak (f32:
    three TF32 passes, the 3xTF32 split, as the forward's bound). The
    whole backward needs five products (s, dp, dv, dq, dk), reads q, k,
    v, out, g and the forward's lse and writes dq, dk, dv; the delta
    kernel reads out and g and writes delta (no product), dq does three
    products (s, dp, dq), dk/dv four (s, dp, dv, dk), with lse and delta
    (f32) read by both. Returns (ms, "bytes" or "operations")."""
    item = torch.tensor([], dtype=dtype).element_size()
    keys = sum(min(i + 1, sk) for i in range(s)) if causal else s * sk
    qs, ks, st = s * d * item, sk * d * item, s * 4   # one (b, h)'s rows
    products, nbytes = {
        "all": (5, 3 * qs + 2 * ks + st + qs + 2 * ks),
        "bwd_delta": (0, 2 * qs + st),
        "bwd_dq": (3, 2 * qs + 2 * ks + 2 * st + qs),
        "bwd_dkdv": (4, 2 * qs + 2 * ks + 2 * st + 2 * ks),
    }[stage]
    flops = 2 * d * keys * products * b * h
    t_ops = (3 * flops / PEAK_TF32 if dtype == torch.float32
             else flops / PEAK_FLOPS[dtype])
    t_bytes = nbytes * b * h / PEAK_BYTES_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bwd_phase(gpu):
    """Phase 3b: the backward as ``flash_bwd`` dispatches it, on the lse
    that the forward kernel wrote, against ``flash_bwd_reference`` (which
    recomputes the row statistics) on the same (q, k, v, out, g), timed:
    each kernel alone (dq and dk/dv on that lse and ``bwd_delta``'s
    delta), the three in turn (``flash_bwd``), the plain version (given
    the same lse, the kernels' data flow), and SDPA's backward. The
    forward's lse is held against the backward's pass 1 and
    ``bwd_delta`` against the plain delta. At the training shapes the
    FFMA dq and dk/dv kernels also run by name, held to the same check
    and timed beside the kernels that replaced them there."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (b, h, s, sk, d, dtype, causal, what)
        (8, 12, 1024, 1024, 64, bf16, True, "gpt2s train"),
        (32, 12, 512, 512, 64, bf16, False, "bert-base train"),
        (4, 12, 1024, 1024, 64, bf16, False, "paired"),
        (1, 12, 1024, 1024, 64, f32, True, "f32"),
        (4, 12, 1000, 1000, 64, bf16, True, "ragged sk"),
        (4, 12, 1000, 1000, 64, f32, True, "ragged sk"),
        (4, 12, 100, 1000, 64, bf16, False, "sk != s"),
        (4, 12, 100, 1000, 64, bf16, True, "sk != s"),
        (4, 12, 1024, 24, 64, bf16, False, "short sk"),
        (4, 6, 1024, 1024, 128, bf16, True, "d128"),
        (4, 8, 1024, 1024, 96, bf16, True, "d96"),
        (1, 2, 16640, 16640, 64, bf16, True, "K+V > 4 MiB"),
    ]
    rows = []
    for b, h, s, sk, d, dtype, causal, what in cases:
        scale = d ** -0.5
        kernel = fa.bwd_kernel_for(dtype, d)
        delta_name, dq_name, dkdv_name = fa.bwd_kernel_names(kernel)
        by_name = what.endswith("train") and kernel != "ffma"
        if what == "paired":
            q, k, v, g = paired_inputs(b, h, s, sk, d, dtype, gen)
        else:
            q, k, v = flash_inputs(b, h, s, sk, d, dtype, gen)
            g = torch.randn((b, h, s, d), generator=gen,
                            device="cuda").to(dtype)
        out, lse = launch_with_lse(q, k, v, causal)
        got = fa.flash_bwd(q, k, v, out, g, lse, causal, scale)
        torch.cuda.synchronize()
        want = fa.flash_bwd_reference(q, k, v, out, g, causal, scale)
        case = (b, h, s, sk, d, str(dtype).split(".")[-1], causal)
        err, margin = check_grads(got, want, dtype, case + (kernel,))
        ffma_err = ffma_margin = None
        if by_name:
            ffma_err, ffma_margin = check_grads(
                fa.flash_bwd(q, k, v, out, g, lse, causal, scale, "ffma"),
                want, dtype, case + ("ffma",))
        lse_err = check_lse(lse, fa.flash_bwd_stats_reference(
            q, k, out, g, causal, scale)[0], case)
        delta = fa._bwd_delta(out, g)
        delta_err = check_delta(delta, out, g, case)
        reps = 10 if s <= 1024 else 3
        stage_ms = {
            delta_name: time_ms(lambda: fa._bwd_delta(out, g), flush, reps),
            dq_name: time_ms(lambda: fa._bwd_dq(
                q, k, v, g, lse, delta, causal, scale), flush, reps),
            dkdv_name: time_ms(lambda: fa._bwd_dkdv(
                q, k, v, g, lse, delta, causal, scale), flush, reps),
            "all": time_ms(lambda: fa.flash_bwd(
                q, k, v, out, g, lse, causal, scale), flush, reps),
        }
        if by_name:
            stage_ms.update({
                "bwd_dq": time_ms(lambda: fa._bwd_dq(
                    q, k, v, g, lse, delta, causal, scale, "ffma"), flush,
                    reps),
                "bwd_dkdv": time_ms(lambda: fa._bwd_dkdv(
                    q, k, v, g, lse, delta, causal, scale, "ffma"), flush,
                    reps),
                "all_ffma": time_ms(lambda: fa.flash_bwd(
                    q, k, v, out, g, lse, causal, scale, "ffma"), flush,
                    reps),
            })
        plain_ms = time_ms(lambda: fa.flash_bwd_reference(
            q, k, v, out, g, causal, scale, lse=lse), flush,
            max(2, reps // 4))
        plain_delta_ms = time_ms(lambda: fa.flash_bwd_delta_reference(
            out, g), flush, reps)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal)
        sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, leaves, g,
                                               retain_graph=True)
        library_ms = time_ms(sdpa_bwd, flush, reps)
        # device times by torch.profiler: bwd_delta after an L2 flush (its
        # inputs fit in L2); the whole backward and SDPA's, L2 warm, every
        # kernel they launch
        dev_ms = {
            "bwd_delta": device_ms(lambda: fa._bwd_delta(out, g),
                                   "bwd_delta", flush),
            "all": device_ms(lambda: fa.flash_bwd(
                q, k, v, out, g, lse, causal, scale), None),
            "library": device_ms(sdpa_bwd, None),
        }
        del sdpa_out, leaves, sdpa_bwd
        # a kernel's bound is its stage's, whichever kernel runs it
        bounds = {stage: bwd_bound_ms(b, h, s, sk, d, dtype, causal,
                                      stage.replace("_sm90", "")
                                      .replace("all_ffma", "all"))
                  for stage in stage_ms}
        row = dict(shape=[b, h, s, sk, d], dtype=case[5], causal=causal,
                   what=what, kernel=kernel, max_abs_err=err,
                   excess_over_atol=margin, ffma_max_abs_err=ffma_err,
                   ffma_excess_over_atol=ffma_margin,
                   lse_max_abs_err=lse_err, delta_max_abs_err=delta_err,
                   ms=stage_ms, device_ms=dev_ms, plain_ms=plain_ms,
                   plain_delta_ms=plain_delta_ms, library_ms=library_ms,
                   bound_ms={k_: v_[0] for k_, v_ in bounds.items()},
                   bound_by={k_: v_[1] for k_, v_ in bounds.items()})
        log("kernel flash_bwd %s b=%d h=%d s=%d sk=%d d=%d %s %s (%s): "
            "dq/dk/dv max_abs_err %.3g (worst excess %.3g of the atol), "
            "forward lse %.3g, delta %.3g; delta %.4f ms (device %.4f ms, "
            "bound %.2f us, plain %.4f ms), dq %.4f ms, dkdv %.4f ms, all "
            "three %.4f ms (device %.4f ms; bound %.2f us, %s; dq %.2f us, "
            "dkdv %.2f us); plain %.4f ms, sdpa backward %.4f ms (device "
            "%.4f ms) [%s]"
            % (kernel, b, h, s, sk, d, case[5],
               "causal" if causal else "full", what, err, margin, lse_err,
               delta_err, stage_ms[delta_name], dev_ms["bwd_delta"],
               bounds[delta_name][0] * 1e3, plain_delta_ms,
               stage_ms[dq_name], stage_ms[dkdv_name], stage_ms["all"],
               dev_ms["all"], bounds["all"][0] * 1e3, bounds["all"][1],
               bounds[dq_name][0] * 1e3, bounds[dkdv_name][0] * 1e3,
               plain_ms, library_ms, dev_ms["library"], gpu))
        if by_name:
            log("kernel flash_bwd ffma by name, same inputs (%s): dq/dk/dv "
                "max_abs_err %.3g (worst excess %.3g of the atol); dq %.4f "
                "ms, dkdv %.4f ms, all three %.4f ms [%s]"
                % (what, ffma_err, ffma_margin, stage_ms["bwd_dq"],
                   stage_ms["bwd_dkdv"], stage_ms["all_ffma"], gpu))
        rows.append(row)
        del q, k, v, g, out, lse, delta, got, want
    del flush
    return rows


def slice_phase(gpu):
    """Phase 3: the port's full-width GPT-2s teacher serving predicts."""
    os.environ["EDL_TPU_DISABLE_UDS"] = "1"  # TCP on loopback only
    seq, vocab = GPT2S["seq_len"], GPT2S["vocab_size"]
    t0 = time.monotonic()
    # one device batch returns 4 x 1024 x 32000 f32 logits and probs
    # (1 GB): the default 500 ms queue-wait SLO would shed the concurrent
    # wave, so this teacher's operator sets an SLO that fits the model
    server = gpt_teacher(**GPT2S, max_batch=MAX_BATCH, host="127.0.0.1",
                         device="cuda",
                         admission=AdmissionController(slo_ms=60000.0)
                         ).start()
    log("slice: gpt_teacher (GPT-2s: 12 x 768, 12 heads, mlp 3072, vocab "
        "32000, seq 1024, max_batch %d) up in %.2fs [%s]"
        % (MAX_BATCH, time.monotonic() - t0, gpu))
    client = RpcClient(server.endpoint, timeout=600.0)
    rng = np.random.RandomState(SEED)
    feed = lambda rows: {"input_ids": rng.randint(
        0, vocab, (rows, seq)).astype(np.int32)}
    try:
        t0 = time.monotonic()
        client.call("predict", feed(1))
        log("slice: first predict (cold) %.3fs [%s]"
            % (time.monotonic() - t0, gpu))
        stats0 = client.call("stats")
        # the main path: every count to 0 just before, read just after
        fa.reset_launches()
        latencies, replies, feeds = [], [], []
        t_all = time.monotonic()
        for rows in (2, 1):                      # sequential
            f = feed(rows)
            t0 = time.monotonic()
            replies.append(client.call("predict", f))
            latencies.append(time.monotonic() - t0)
            feeds.append(f)
        wave = [feed(r) for r in (2, 1, 1)]       # concurrent
        t0 = time.monotonic()
        futs = [client.call_async("predict", f) for f in wave]
        for f, fut in zip(wave, futs):
            replies.append(fut.result(timeout=600))
            latencies.append(time.monotonic() - t0)
            feeds.append(f)
        wall = time.monotonic() - t_all
        launches = dict(fa.flash_attention.kernel_launches)
        total = fa.flash_attention.launches
        stats = client.call("stats")
    finally:
        client.close()
        server.stop()
    batches = stats["batches"] - stats0["batches"]
    rows = stats["rows"] - stats0["rows"]
    if batches < 1 or launches != only("sm90", 12 * batches) \
            or total != 12 * batches:
        raise AssertionError("flash launches %s (total %d) are not 12 sm90 "
                             "and no other x %d device batches"
                             % (launches, total, batches))
    for f, rep in zip(feeds, replies):
        n = len(f["input_ids"])
        for key in ("logits", "probs"):
            if rep[key].shape != (n, seq, vocab) or \
                    rep[key].dtype != np.float32:
                raise AssertionError("%s reply shape %s dtype %s"
                                     % (key, rep[key].shape, rep[key].dtype))
            if not np.isfinite(rep[key]).all():
                raise AssertionError("non-finite %s" % key)
        sums = rep["probs"].sum(-1, dtype=np.float64)
        if np.abs(sums - 1.0).max() > 1e-3:
            raise AssertionError("probs rows sum to %s" % sums)
    tokens = rows * seq
    log("slice: %d requests (%d rows) in %d device batches, flash "
        "launches %s (12 sm90 per batch); latency per request %s s; %.1f "
        "tokens/s; wall %.3fs [%s]"
        % (len(replies), rows, batches, launches,
           ["%.3f" % x for x in latencies], tokens / wall, wall, gpu))

    # the served logits against the same weights with dense attention
    ref = Gpt(**{k: v for k, v in GPT2S.items() if k != "seq_len"},
              max_len=seq, dtype=torch.bfloat16, use_flash=False,
              device="cuda")
    ref.init_weights(torch.Generator(device="cuda").manual_seed(INIT_SEED))
    with torch.inference_mode():
        ids = torch.from_numpy(feeds[0]["input_ids"].astype(np.int64))
        want = ref(ids.cuda()).cpu().numpy()
    got = replies[0]["logits"]
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    log("slice: served logits vs dense-attention model max_abs_err %.4g "
        "(tol %g, |logits| max %.3f); peak device memory %.2f GB"
        % (err, SERVE_TOL, scale, torch.cuda.max_memory_allocated() / 1e9))
    if not (scale < 8.0 and err <= SERVE_TOL):
        raise AssertionError("served logits disagree with the dense model")
    forward_breakdown(ref, gpu)
    return launches


def forward_breakdown(model, gpu):
    """Where a device batch's time goes: the model forward with flash and
    with dense attention (CUDA events), the predict tail (softmax, copy
    of logits and probs to the host; host clock), and the forward's
    device time by kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from edl_tpu_torch.models.gpt import CausalSelfAttention

    seq, vocab = GPT2S["seq_len"], GPT2S["vocab_size"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ids = torch.randint(0, vocab, (MAX_BATCH, seq), device="cuda",
                        generator=gen)

    def forward(flash):
        for m in model.modules():
            if isinstance(m, CausalSelfAttention):
                m.use_flash = flash
        with torch.inference_mode():
            return model(ids)

    ms = {}
    for flash in (True, False, True, False):  # warm, then in turns
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        forward(flash)
        e1.record()
        e1.synchronize()
        ms[flash] = e0.elapsed_time(e1)
    t0 = time.monotonic()
    with torch.inference_mode():
        logits = forward(True)
        probs = torch.softmax(logits, dim=-1)
        logits.cpu(), probs.cpu()
    predict_s = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        forward(True)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total]
    total_us = sum(e.self_device_time_total for e in events)
    flash_us = sum(e.self_device_time_total for e in events
                   if "flash_fwd" in e.key)
    log("breakdown: forward of %d x %d tokens %.3f ms with flash, %.3f ms "
        "dense; forward + softmax + copy of logits and probs to host "
        "%.3f s [%s]" % (MAX_BATCH, seq, ms[True], ms[False], predict_s,
                          gpu))
    if total_us:
        log("breakdown: profiled forward device time %.3f ms, flash kernel "
            "%.3f ms (%.1f%%) [%s]" % (total_us / 1e3, flash_us / 1e3,
                                       100.0 * flash_us / total_us, gpu))
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        for e in top:
            log("  %8.3f ms x%-4d %s" % (e.self_device_time_total / 1e3,
                                          e.count, e.key[:90]))
    else:
        log("breakdown: torch.profiler recorded no device time")


def lm_prompts():
    """The decode phase's prompts, seeded numpy ids: the 10 of the
    concurrent wave and the 3 that share a 256-token prefix. First
    tokens are made distinct (0-9, the shared prefix's 100, and each
    shared suffix starts at its own 200+j), so the prefix trie hits
    exactly where the traffic plan says."""
    vocab = LM["vocab_size"]
    rng = np.random.RandomState(SEED)
    wave = [rng.randint(0, vocab, n).tolist() for n in LM_LENGTHS]
    for i, p in enumerate(wave):
        p[0] = i
    shared = rng.randint(0, vocab, LM_SHARED).tolist()
    shared[0] = 100
    tails = []
    for j, n in enumerate(LM_SUFFIXES):
        tail = rng.randint(0, vocab, n).tolist()
        tail[0] = 200 + j
        tails.append(shared + tail)
    return wave, tails


def load_prompts(first=1000):
    """The load's prompts: seeded numpy ids, lengths uniform over
    LM_LENGTHS' range. Each first token (``first`` + i) is its own, so
    every request is a cold, monolithic prefill, as in the concurrent
    wave; a second load with another ``first`` sends the same work and
    still misses the prefix cache."""
    rng = np.random.RandomState(SEED + 3)
    lengths = rng.randint(LM_LENGTHS[0], LM_LENGTHS[-1] + 1, LM_LOAD)
    prompts = [rng.randint(0, LM["vocab_size"], n).tolist()
               for n in lengths]
    for i, p in enumerate(prompts):
        p[0] = first + i
    return prompts


def lm_buckets():
    """The prefill buckets of every prompt the decode phase sends, and
    of its 1-row predict (max_len)."""
    wave, tails = lm_prompts()
    lengths = [len(p) for p in [LM_WARMUP] + wave + tails + load_prompts()]
    return sorted({_prefill_bucket(n, LM["max_len"]) for n in lengths}
                  | {LM["max_len"]})


def pct(vals, q):
    return float(np.percentile(np.asarray(vals, np.float64), q))


def last_logits(model, params, prompt, bucket=None):
    """The logits at a prompt's last position from a prefill into a
    fresh 1-row cache: at the prompt's own length (``generate``'s path)
    or zero-padded to ``bucket`` (the engine's monolithic path)."""
    ids = np.zeros((1, bucket or len(prompt)), np.int64)
    ids[0, :len(prompt)] = prompt
    with torch.no_grad():
        cache = gpt.init_cache(model, params, 1)
        logits = gpt.apply(model, params, torch.from_numpy(ids).to("cuda"),
                           cache=cache, prefill=True)
    return logits[0, len(prompt) - 1]


def hold_tokens(model, params, prompt, got, want, err, what, gpu):
    """Hold generated tokens ``got`` against the reference ``want``: equal,
    or first differing at a step where the reference's top-2 logit gap
    (teacher-forced) is below ``err``, the logits error measured between
    the two paths. Returns the first differing step or None."""
    if got == want:
        return None
    if len(got) != len(want):
        raise AssertionError("%s: %d tokens, reference %d"
                             % (what, len(got), len(want)))
    step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    ids = torch.tensor([prompt + want[:step]], device="cuda")
    with torch.no_grad():
        top2 = torch.topk(gpt.apply(model, params, ids)[0, -1], 2).values
    gap = float(top2[0] - top2[1])
    log("decode: %s differs from the reference at step %d: top-2 gap %.3g, "
        "logits error %.3g [%s]" % (what, step, gap, err, gpu))
    if not gap < err:
        raise AssertionError("%s: token %d differs where the reference's "
                             "top-2 gap %.3g is not below the logits error "
                             "%.3g" % (what, step, gap, err))
    return step


def decode_phase(gpu):
    """Phase 4: the port's full-width GPT-2s lm_teacher serving its
    decode plane. Returns the flash launches by path."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on (allow_tf32 %s, precision %s): "
                             "f32 token parity needs it off"
                             % (torch.backends.cuda.matmul.allow_tf32,
                                torch.get_float32_matmul_precision()))
    os.environ["EDL_TPU_DISABLE_UDS"] = "1"  # TCP on loopback only
    vocab, max_len = LM["vocab_size"], LM["max_len"]
    layers = LM["num_layers"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    # a 1-row predict returns 1 x 1024 x 32000 f32 logits and probs
    # (262 MB): the operator's SLO fits the model, as in the slice phase
    server = lm_teacher(**LM, slots=LM_SLOTS, max_batch=1,
                        host="127.0.0.1", device="cuda",
                        admission=AdmissionController(slo_ms=60000.0)
                        ).start()
    engine = server.decode_engine
    model, params = engine.model, engine.params
    log("decode: lm_teacher (GPT-2s: 12 x 768, 12 heads, mlp 3072, vocab "
        "32000, max_len 1024, f32, %d slots) up in %.2fs [%s]"
        % (LM_SLOTS, time.monotonic() - t0, gpu))
    wave, tails = lm_prompts()
    client = RpcClient(server.endpoint, timeout=600.0)
    by_path = {}
    try:
        client.call("lm_generate", LM_WARMUP, 4)  # warm-up (a miss)
        before = client.call("stats")
        # the main path: every count to 0 just before, read just after
        fa.reset_launches()
        t_wave = time.monotonic()
        futs = [client.call_async("lm_generate", p, LM_NEW) for p in wave]
        reports = [f.result(timeout=600) for f in futs]
        wave_s = time.monotonic() - t_wave
        reports.append(client.call("lm_generate", tails[0], LM_NEW))
        seq = client.call("lm_submit", tails[1], LM_NEW)["seq"]
        streamed, polls, done = [], 0, False
        while not done:
            time.sleep(0.005)  # a streaming client's poll interval
            out = client.call("lm_poll", seq, len(streamed))
            streamed += out["tokens"]
            done, polls = out["done"], polls + 1
        reports.append({"tokens": tails[1] + streamed,
                        "generated": streamed})
        reports.append(client.call("lm_generate", tails[2], LM_NEW))
        by_path["decode"] = dict(fa.flash_attention.kernel_launches)
        stats = client.call("stats")
        # the predict plane of the same teacher, one row
        feed = {"input_ids": np.random.RandomState(SEED + 2).randint(
            0, vocab, (1, max_len)).astype(np.int32)}
        fa.reset_launches()
        f32_reply = client.call("predict", feed)
        by_path["lm_predict"] = dict(fa.flash_attention.kernel_launches)
        fa.reset_launches()
        load, load_s = load_run(server.endpoint, load_prompts())
        by_path["decode_load"] = dict(fa.flash_attention.kernel_launches)
        after = client.call("stats")
        # the same load again with the f32 attention on ffma: what
        # tf32x3 moved end to end, in this run (not a main-path count)
        fa.reset_launches()
        with f32_attention_on("ffma"):
            load_ffma, load_ffma_s = load_run(server.endpoint,
                                              load_prompts(first=2000))
        ffma_load = dict(fa.flash_attention.kernel_launches)
        after_ffma = client.call("stats")
    finally:
        client.close()
        server.stop()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    prompts = wave + tails
    pfx, pfx0 = stats["decode_prefix"], before["decode_prefix"]
    cold = pfx["misses"] - pfx0["misses"]
    hits = pfx["hits"] - pfx0["hits"]
    reused = pfx["reuse_tokens"] - pfx0["reuse_tokens"]
    log("decode: %d sequences of %d new tokens; flash launches %s for %d "
        "monolithic prefills (%d tf32x3 each); prefix hits %d, "
        "reuse_tokens %d; step shapes %d; %d polls streamed seq %d [%s]"
        % (len(prompts), LM_NEW, by_path["decode"], cold, layers, hits,
           reused, stats["decode_step_traces"], polls, seq, gpu))
    if cold != len(wave) + 1 or \
            by_path["decode"] != only("tf32x3", layers * cold):
        raise AssertionError("decode flash launches %s for %d monolithic "
                             "prefills: want %d tf32x3 each and no other, "
                             "and %d prefills" % (by_path["decode"], cold,
                                                  layers, len(wave) + 1))
    if hits != 2 or reused != 2 * LM_SHARED:
        raise AssertionError("prefix hits %d reuse_tokens %d, want 2 and %d"
                             % (hits, reused, 2 * LM_SHARED))
    if stats["decode_step_traces"] != 1:
        raise AssertionError("decode step ran at %d shapes"
                             % stats["decode_step_traces"])
    if by_path["lm_predict"] != only("tf32x3", layers):
        raise AssertionError("lm predict launches %s"
                             % by_path["lm_predict"])
    logits = f32_reply["logits"]
    if logits.shape != (1, max_len, vocab) or not np.isfinite(logits).all():
        raise AssertionError("lm predict logits %s" % (logits.shape,))
    log("decode: the concurrent wave of %d requests (%d tokens) took "
        "%.3fs [%s]" % (len(wave), len(wave) * LM_NEW, wave_s, gpu))

    # serving metrics: TTFT and ITL of the closed-loop load, by request,
    # on tf32x3 (the path under test) and on ffma (as before it)
    for kernel, load_i, load_s_i, launches, st0, st1 in (
            ("tf32x3", load, load_s, by_path["decode_load"], stats, after),
            ("ffma", load_ffma, load_ffma_s, ffma_load, after, after_ffma)):
        log_load(kernel, load_i, load_s_i, launches, st0, st1, gpu)
    log("decode: decode_kv_bytes %d (%.1f MB); peak device memory %.2f GB "
        "[%s]" % (stats["decode_kv_bytes"], stats["decode_kv_bytes"] / 1e6,
                  peak_gb, gpu))

    # every sequence against the port's generate on the same weights, in
    # a model with dense attention: the reference shares no kernel with
    # the path under test
    dense = Gpt(**LM, dtype=torch.float32, use_flash=False, device="cuda")
    err = 0.0
    for p in [p for p in prompts if p is not tails[1] and p is not tails[2]]:
        diff = (last_logits(model, params, p, _prefill_bucket(len(p),
                                                                max_len))
                - last_logits(dense, params, p)).abs().max()
        err = max(err, float(diff))
    log("decode: engine-path (flash, bucket) vs dense generate-path "
        "prefill logits max_abs_err %.3g [%s]" % (err, gpu))
    mismatched = 0
    for i, (p, rep) in enumerate(zip(prompts, reports)):
        if rep["tokens"][:len(p)] != p:
            raise AssertionError("sequence %d does not echo its prompt" % i)
        want = gpt.generate(dense, params, [p], LM_NEW)[0, len(p):].tolist()
        if hold_tokens(dense, params, p, rep["generated"], want, err,
                       "sequence %d (prompt %d)" % (i, len(p)),
                       gpu) is not None:
            mismatched += 1
    log("decode: %d of %d sequences token-identical to generate [%s]"
        % (len(prompts) - mismatched, len(prompts), gpu))

    # chunked prefill on the same weights: two prompts, same tokens
    chunked = DecodeEngine(model, params, slots=2, admission=False,
                           prefix_cache=False, prefill_chunk=256).start()
    try:
        fa.reset_launches()
        picks = (len(wave) - 1, 4)
        handles = [chunked.submit(wave[i], LM_NEW) for i in picks]
        outs = [h.result(timeout=600)["generated"] for h in handles]
        by_path["chunked"] = dict(fa.flash_attention.kernel_launches)
        cstats = chunked.stats()
    finally:
        chunked.stop()
    for i, out in zip(picks, outs):
        hold_tokens(dense, params, wave[i], out, reports[i]["generated"],
                    err, "chunked sequence %d (prompt %d)"
                    % (i, len(wave[i])), gpu)
    if by_path["chunked"] != only("tf32x3", 0) or \
            cstats["decode_step_traces"] != 1:
        raise AssertionError("chunked engine: launches %s, step shapes %d"
                             % (by_path["chunked"],
                                cstats["decode_step_traces"]))
    log("decode: chunked engine (prefill_chunk 256) decoded prompts %s: "
        "flash launches %s, chunk shapes %d [%s]"
        % ([len(wave[i]) for i in picks], by_path["chunked"],
           cstats["decode_chunk_traces"], gpu))

    decode_step_profile(engine, "f32 decode step", gpu)
    for kernel in ("tf32x3", "ffma", "tf32x3", "ffma"):  # in turns
        fa.reset_launches()
        with f32_attention_on(kernel):
            prefill_profile(engine, wave[-1], kernel, gpu)
        if fa.flash_attention.kernel_launches != only(kernel, 5 * layers):
            raise AssertionError(
                "the profiled prefills on %s launched %s"
                % (kernel, fa.flash_attention.kernel_launches))
    int8_gate(feed, logits, gpu)
    return by_path


def train_phase(gpu):
    """Phase 5: GPT-2s and BERT-base training through the bench's LM loop
    (``create_model_and_loss`` -> ``make_train_step`` -> ``adamw``), with
    flash and with dense attention. Returns the flash launches by path."""
    layers = GPT2S["num_layers"]
    by_path, first_loss = {}, {}
    for kind, flash in (("gpt", True), ("gpt", False), ("bert", True)):
        run = bench.run_gpt if kind == "gpt" else bench.run_bert
        stats = {}
        torch.cuda.empty_cache()
        fa.reset_launches()
        result = run(warmup=TRAIN_WARMUP, iters=TRAIN_ITERS, flash=flash,
                     device="cuda", stats=stats)
        launches = dict(fa.flash_attention.kernel_launches)
        steps = len(stats["losses"])
        path = "train_%s%s" % (kind, "" if flash else "_dense")
        # bf16 at head_dim 64: bwd_delta, then the sm90 dq and dk/dv
        want = (only("sm90", 2 * layers * steps,
                     **{k: layers * steps
                        for k in fa.bwd_kernel_names("sm90")})
                if flash else only("sm90", 0))
        log("train: %s %s: %.1f tokens/s per card, %.3f ms per step (%d "
            "timed of %d), implied %.1f TFLOP/s, MFU %.4f of 989 TFLOP/s "
            "bf16; peak device memory %.2f GB; losses %s; flash launches %s "
            "[%s]" % (kind, "flash" if flash else "dense",
                      stats["tokens_per_s"], stats["step_ms"],
                      stats["iters"], steps, stats["implied_tflops"],
                      stats["mfu"], stats["peak_bytes"] / 1e9,
                      ["%.4f" % x for x in stats["losses"]], launches, gpu))
        log("train: %s [%s]" % (json.dumps(result), gpu))
        if launches != want:
            raise AssertionError("%s: flash launches %s over %d steps, want "
                                 "%s" % (path, launches, steps, want))
        if not np.isfinite(stats["losses"]).all():
            raise AssertionError("%s: non-finite loss %s"
                                 % (path, stats["losses"]))
        if flash:
            by_path[path] = launches
            step_profile(stats, "train: one %s step (flash)" % kind, gpu)
        first_loss[kind, flash] = stats["losses"][0]
        del stats
    rel = abs(first_loss["gpt", True] - first_loss["gpt", False]) / abs(
        first_loss["gpt", False])
    log("train: first-step loss flash %.6f, dense %.6f, relative %.3g "
        "(limit %g) [%s]" % (first_loss["gpt", True],
                             first_loss["gpt", False], rel, TRAIN_LOSS_RTOL,
                             gpu))
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("flash and dense first-step losses differ by "
                             "%g relative" % rel)
    grad_parity(gpu)
    return by_path


def resnet_phase(gpu):
    """Phase 6: ResNet50_vd training through ``bench.run`` (the device
    feed, then the host feed), the first step in bf16 and f32 against
    f64 and the s2d stem against the plain one, and ``resnet_teacher``
    serving predicts. None of it
    runs attention: every path must launch no flash kernel. Returns the
    flash launches by path (all zero)."""
    by_path = {}
    stats = {}
    torch.cuda.empty_cache()
    fa.reset_launches()
    result = bench.run(batch_per_chip=RESNET_BATCH, image_size=RESNET_IMAGE,
                       warmup=RESNET_WARMUP, iters=RESNET_ITERS, s2d=True,
                       feed="device", device="cuda", stats=stats)
    by_path["train_resnet"] = dict(fa.flash_attention.kernel_launches)
    losses = stats["losses"]
    log("resnet: ResNet50_vd b%d x %d s2d, device feed: %.1f img/s per "
        "card, %.3f ms per step (%d timed of %d), %.3f GFLOP per image "
        "(forward %.3f, x3), implied %.1f TFLOP/s, MFU %.4f of 989 TFLOP/s "
        "bf16; peak device memory %.2f GB; losses %s [%s]"
        % (RESNET_BATCH, RESNET_IMAGE, stats["imgs_per_s"], stats["step_ms"],
           stats["iters"], len(losses), stats["flops_per_image"] / 1e9,
           stats["flops_per_image"] / 3e9, stats["implied_tflops"],
           stats["mfu"], stats["peak_bytes"] / 1e9,
           ["%.4f" % x for x in losses], gpu))
    log("resnet: %s [%s]" % (json.dumps(result), gpu))
    if not np.isfinite(losses).all():
        raise AssertionError("resnet: non-finite loss %s" % losses)
    if abs(losses[0] - np.log(1000.0)) > RESNET_LOSS0_TOL:
        raise AssertionError("resnet: first loss %.4f is not within %g of "
                             "ln(1000)" % (losses[0], RESNET_LOSS0_TOL))
    step_profile(stats, "resnet: one ResNet50_vd train step", gpu,
                 groups=RESNET_KERNEL_GROUPS, ranges=BN_RANGES)
    del stats
    resnet_parity(gpu)

    stats = {}
    torch.cuda.empty_cache()
    fa.reset_launches()
    result = bench.run(batch_per_chip=RESNET_BATCH, image_size=RESNET_IMAGE,
                       warmup=HOSTFED_WARMUP, iters=HOSTFED_ITERS, s2d=True,
                       feed="host", device="cuda", stats=stats)
    by_path["train_resnet_hostfed"] = dict(fa.flash_attention.kernel_launches)
    feed = stats["prefetch"]
    log("resnet: host feed (synthetic_pipeline -> DevicePrefetcher, bf16 "
        "cast on the host): %.1f img/s per card, %.3f ms per step; "
        "prefetch %s; losses %s [%s]"
        % (stats["imgs_per_s"], stats["step_ms"], feed,
           ["%.4f" % x for x in stats["losses"]], gpu))
    log("resnet: %s [%s]" % (json.dumps(result), gpu))
    if not np.isfinite(stats["losses"]).all():
        raise AssertionError("resnet host feed: non-finite loss")
    if feed["batches"] < len(stats["losses"]):
        raise AssertionError("resnet host feed: %d steps from %d batches"
                             % (len(stats["losses"]), feed["batches"]))
    del stats
    by_path["predict_resnet"] = resnet_teacher_phase(gpu)
    for path, counts in by_path.items():
        if any(counts.values()):
            raise AssertionError("%s launched flash kernels: %s"
                                 % (path, counts))
    return by_path


def resnet_parity(gpu):
    """The first step of ResNet50_vd in bf16, f32 and f64 on the same
    weights and batch: losses and every parameter's gradient (limits
    above); and the s2d stem vs the plain stride-2 stem on one kernel."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"image": torch.randn(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE,
                                  3, generator=gen, device="cuda"),
             "label": torch.randint(0, 1000, (RESNET_BATCH,), generator=gen,
                                    device="cuda")}
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype in (torch.bfloat16, torch.float32, torch.float64):
            _, params, extra, loss_fn = resnet.create_model_and_loss(
                dtype=dtype, space_to_depth=True, device="cuda", seed=0)
            for name in params:
                if name.endswith("bn3.scale"):
                    params[name].fill_(0.25)
            if dtype == torch.float64:
                params = {k: v.double() for k, v in params.items()}
                extra = {"batch_stats": {
                    k: v.double() for k, v in extra["batch_stats"].items()}}
            loss, _, grads = trainer._value_and_grad(
                lambda p: loss_fn(p, extra, batch, None), params, True)
            out[dtype] = float(loss), {k: g.double() for k, g in
                                       grads.items()}
            del params, extra, loss_fn, grads
        exact = out[torch.float64]
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        report = {}
        for dtype in (torch.float32, torch.bfloat16):
            loss, grads = out[dtype]
            leaves = sorted((rel(g, exact[1][n]), n) for n, g in
                            grads.items())
            whole = (sum(((g - exact[1][n]) ** 2).sum()
                         for n, g in grads.items()) ** 0.5
                     / sum((g ** 2).sum() for g in exact[1].values())
                     ** 0.5).item()
            report[dtype] = (abs(loss - exact[0]) / abs(exact[0]), whole,
                             leaves[-1], leaves[len(leaves) // 2][0])
        f32, bf16 = report[torch.float32], report[torch.bfloat16]
        log("resnet: first step vs f64 (loss %.6f): f32 loss %.6f "
            "(relative %.3g, limit %g), gradients all leaves %.4g, worst "
            "leaf %.4g (%s, limit %g), median leaf %.4g; bf16 loss %.6f "
            "(relative %.3g, limit %g), gradients all leaves %.4g and "
            "median leaf %.4g (limit %g), worst leaf %.4g (%s, limit %g) "
            "[%s]"
            % (exact[0], out[torch.float32][0], f32[0],
               RESNET_F32_LOSS_RTOL, f32[1], f32[2][0], f32[2][1],
               RESNET_GRAD_RTOL, f32[3], out[torch.bfloat16][0], bf16[0],
               RESNET_LOSS_RTOL, bf16[1], bf16[3], RESNET_BF16_GRAD_RTOL,
               bf16[2][0], bf16[2][1], RESNET_BF16_LEAF_RTOL, gpu))
        if not (f32[0] <= RESNET_F32_LOSS_RTOL
                and f32[2][0] <= RESNET_GRAD_RTOL):
            raise AssertionError("resnet: the f32 step disagrees with f64")
        if not (bf16[0] <= RESNET_LOSS_RTOL
                and bf16[1] <= RESNET_BF16_GRAD_RTOL
                and bf16[3] <= RESNET_BF16_GRAD_RTOL
                and bf16[2][0] <= RESNET_BF16_LEAF_RTOL):
            raise AssertionError("resnet: the bf16 step disagrees with f64")
        del out, exact
        # the s2d stem against the plain stride-2 stem, same kernel
        plain = resnet.Conv(3, 32, 3, 2, dtype=torch.float32, device="cuda")
        s2d = resnet.S2DStemConv(32, torch.float32, "cuda")
        with torch.no_grad():
            plain.init_weights(torch.Generator(device="cuda").manual_seed(2))
            s2d.kernel.copy_(plain.kernel)
            x = batch["image"]
            want = plain(x.permute(0, 3, 1, 2))
            got = s2d(resnet.space_to_depth(x).permute(0, 3, 1, 2))
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log("resnet: s2d stem vs plain stride-2 stem (f32, TF32 off) at "
            "%s: max_abs_err %.3g of |out| max %.3f (limit %g relative) "
            "[%s]" % (tuple(want.shape), err, scale, S2D_TOL, gpu))
        if not err <= S2D_TOL * max(1.0, scale):
            raise AssertionError("resnet: the s2d stem disagrees with the "
                                 "plain one: %g" % err)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def resnet_teacher_phase(gpu):
    """``resnet_teacher`` (ResNet50_vd at 224, bf16, max_batch 64) serving
    predicts of 1-64 rows through the port's RpcClient, some concurrent;
    each reply's logits against the model's direct eval forward of the
    same rows padded with zeros to the device batch, as the server pads
    them. Returns the flash launches of the served requests."""
    os.environ["EDL_TPU_DISABLE_UDS"] = "1"  # TCP on loopback only
    max_batch = 64
    t0 = time.monotonic()
    # the first device batches build cuDNN's plans: a queue-wait SLO of
    # a minute keeps the default 500 ms from shedding the concurrent wave
    server = resnet_teacher(depth=50, image_size=RESNET_IMAGE,
                            max_batch=max_batch, host="127.0.0.1",
                            device="cuda",
                            admission=AdmissionController(slo_ms=60000.0)
                            ).start()
    log("resnet: resnet_teacher (ResNet50_vd, 224, max_batch %d) up in "
        "%.2fs [%s]" % (max_batch, time.monotonic() - t0, gpu))
    client = RpcClient(server.endpoint, timeout=600.0)
    rng = np.random.RandomState(SEED)
    feed = lambda rows: {"image": rng.randn(
        rows, RESNET_IMAGE, RESNET_IMAGE, 3).astype(np.float32)}
    try:
        client.call("predict", feed(1))
        stats0 = client.call("stats")
        fa.reset_launches()
        replies, feeds, latencies = [], [], []
        t_all = time.monotonic()
        for rows in (1, 64, 7):                    # sequential
            f = feed(rows)
            t0 = time.monotonic()
            replies.append(client.call("predict", f))
            latencies.append(time.monotonic() - t0)
            feeds.append(f)
        wave = [feed(r) for r in (3, 5, 2)]        # concurrent
        t0 = time.monotonic()
        futs = [client.call_async("predict", f) for f in wave]
        for f, fut in zip(wave, futs):
            replies.append(fut.result(timeout=600))
            latencies.append(time.monotonic() - t0)
            feeds.append(f)
        wall = time.monotonic() - t_all
        launches = dict(fa.flash_attention.kernel_launches)
        stats = client.call("stats")
    finally:
        client.close()
        server.stop()
    rows = stats["rows"] - stats0["rows"]
    batches = stats["batches"] - stats0["batches"]
    # the same weights as the server's: INIT_SEED, flax's initial stats
    model = resnet.ResNet(depth=50, dtype=torch.bfloat16, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(INIT_SEED))
    batch_stats = resnet.init_batch_stats(model)
    worst = 0.0
    for f, rep in zip(feeds, replies):
        n = len(f["image"])
        for key in ("logits", "probs"):
            if rep[key].shape != (n, 1000) or rep[key].dtype != np.float32:
                raise AssertionError("%s reply shape %s dtype %s"
                                     % (key, rep[key].shape, rep[key].dtype))
            if not np.isfinite(rep[key]).all():
                raise AssertionError("non-finite %s" % key)
        sums = rep["probs"].sum(-1, dtype=np.float64)
        if np.abs(sums - 1.0).max() > 1e-3:
            raise AssertionError("probs rows sum to %s" % sums)
        padded = np.zeros((max_batch, RESNET_IMAGE, RESNET_IMAGE, 3),
                          np.float32)
        padded[:n] = f["image"]
        with torch.no_grad():
            want, _ = model(torch.from_numpy(padded).cuda().to(
                torch.bfloat16), batch_stats)
        want = want[:n].cpu().numpy()
        err = float(np.abs(rep["logits"] - want).max()) / max(
            1.0, float(np.abs(want).max()))
        worst = max(worst, err)
    log("resnet: teacher served %d requests (%d rows) in %d device "
        "batches, latency per request %s s, %.1f images/s; logits vs the "
        "direct eval forward: worst %.3g relative (limit %g); flash "
        "launches %s [%s]"
        % (len(replies), rows, batches, ["%.3f" % x for x in latencies],
           rows / wall, worst, TEACHER_TOL, launches, gpu))
    if not worst <= TEACHER_TOL:
        raise AssertionError("resnet teacher logits disagree with the "
                             "model's eval forward: %g" % worst)
    return launches


def step_profile(stats, what, gpu, groups=None, ranges=()):
    """One more step of a bench run, profiled: device time by kernel and
    its share of the step's time (the device-busy share)."""
    total_us = log_profile(stats["dispatch"], what, gpu, top=10,
                           also=("flash_", "bwd_"), groups=groups,
                           ranges=ranges)
    if total_us:
        log("%s: device busy %.1f%% of the %.3f ms step [%s]"
            % (what, 100.0 * total_us / 1e3 / stats["step_ms"],
               stats["step_ms"], gpu))


def grad_parity(gpu):
    """The first step's gradients on the same GPT-2s weights and batch as
    the bench (seed 0): bf16 with flash, bf16 dense, and dense in f32 (the
    exact gradient's stand-in). Each parameter's flash gradient must be
    within relative Frobenius TRAIN_GRAD_RTOL of the dense one, except:

    - the attention query and key projections (kernel and query bias):
      their gradients come from dq and dk, where ds = p (dp - delta)
      cancels, and delta = rowsum(g * out) is taken from the output
      rounded to bf16, as the JAX package's ``_flash_bwd`` (and
      FlashAttention-2) take it; the dense path differentiates its f32
      probabilities instead. So the flash path's bf16 rounding there is
      amplified, not wrong: these are held to the f32 gradient, within
      TRAIN_GRAD_RTOL plus twice the dense bf16 path's own distance from
      it (a fault in a kernel gives errors of order 1);
    - a key bias, reported, not held: its true gradient is zero (adding
      one constant to a row's scores does not change the softmax), so
      every path gives rounding noise there."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, GPT2S["vocab_size"], (8, GPT2S["seq_len"]),
                        generator=gen, device="cuda")
    grads = {}
    for dtype, flash in ((torch.bfloat16, True), (torch.bfloat16, False),
                         (torch.float32, False)):
        model = Gpt(dtype=dtype, remat=True, use_flash=flash, device="cuda")
        model, params, loss_fn = gpt.create_model_and_loss(model=model)
        fa.reset_launches()
        _, _, got = trainer._value_and_grad(
            lambda p: loss_fn(p, {"input_ids": ids}, None), params, False)
        grads[dtype, flash] = {n: g.float() for n, g in got.items()}
        del model, params, loss_fn
    flash, dense = grads[torch.bfloat16, True], grads[torch.bfloat16, False]
    exact = grads[torch.float32, False]
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    worst, worst_qk, noise = (0.0, ""), (0.0, 0.0, ""), []
    for name, g in flash.items():
        if name.endswith("attention.key.bias"):
            noise.append("%.3g/%.3g" % (g.norm().item(),
                                        dense[name].norm().item()))
            continue
        if ".attention.query." in name or ".attention.key." in name:
            to_exact, dense_to_exact = rel(g, exact[name]), rel(
                dense[name], exact[name])
            limit = TRAIN_GRAD_RTOL + 2 * dense_to_exact
            if not to_exact <= limit:
                raise AssertionError(
                    "gradient of %s: flash vs f32 relative Frobenius %g > "
                    "%g (the dense bf16 path's is %g)"
                    % (name, to_exact, limit, dense_to_exact))
            worst_qk = max(worst_qk, (to_exact, dense_to_exact, name))
            continue
        err = rel(g, dense[name])
        if not err <= TRAIN_GRAD_RTOL:
            raise AssertionError("gradient of %s: flash vs dense relative "
                                 "Frobenius %g > %g"
                                 % (name, err, TRAIN_GRAD_RTOL))
        worst = max(worst, (err, name))
    log("train: first-step gradients flash vs dense (bf16): worst relative "
        "Frobenius %.4g (%s, limit %g); query/key projections vs the f32 "
        "gradient: worst %.4g, the dense bf16 path's %.4g (%s); key-bias "
        "gradient norms flash/dense (true gradient 0) %s [%s]"
        % (worst[0], worst[1], TRAIN_GRAD_RTOL, worst_qk[0], worst_qk[1],
           worst_qk[2], noise[:3], gpu))
    del grads


def load_run(endpoint, prompts):
    """Closed loop: LM_LOAD_CLIENTS threads, each with its own
    ``RpcClient`` (a blocking call is dispatched inline, so one
    connection serves one call at a time), client k sending prompts k,
    k + LM_LOAD_CLIENTS, ... as ``lm_generate`` calls, each when its last
    returns. Returns the reports, each checked for its prompt echo and
    LM_NEW generated tokens, and the wall time."""
    def run(k):
        out = []
        client = RpcClient(endpoint, timeout=600.0)
        try:
            for i in range(k, len(prompts), LM_LOAD_CLIENTS):
                rep = client.call("lm_generate", prompts[i], LM_NEW)
                if rep["tokens"][:len(prompts[i])] != prompts[i] or \
                        len(rep["generated"]) != LM_NEW:
                    raise AssertionError("load request %d: %d generated"
                                         % (i, len(rep["generated"])))
                out.append(rep)
        finally:
            client.close()
        return out

    t0 = time.monotonic()
    with ThreadPoolExecutor(LM_LOAD_CLIENTS) as pool:
        reports = [r for rs in pool.map(run, range(LM_LOAD_CLIENTS))
                   for r in rs]
    return reports, time.monotonic() - t0


def log_load(kernel, load, load_s, launches, st0, st1, gpu):
    """Check one closed-loop load (every prefill cold, 12 launches of
    ``kernel`` each and no other, one step shape) and log its TTFT, ITL
    and tokens/s; ``st0`` and ``st1`` are the server's stats before and
    after it."""
    layers = LM["num_layers"]
    cold = st1["decode_prefix"]["misses"] - st0["decode_prefix"]["misses"]
    hits = st1["decode_prefix"]["hits"] - st0["decode_prefix"]["hits"]
    if cold != LM_LOAD or hits or launches != only(kernel, layers * LM_LOAD) \
            or st1["decode_step_traces"] != 1:
        raise AssertionError("load on %s: %d cold prefills, %d prefix hits, "
                             "launches %s, step shapes %d; want %d cold, "
                             "%d %s launches and no other, one step shape"
                             % (kernel, cold, hits, launches,
                                st1["decode_step_traces"], LM_LOAD,
                                layers * LM_LOAD, kernel))
    ttft = [r["ttft_ms"] for r in load]
    itl = [x for r in load for x in r["itl_ms"]]
    steps = st1["decode_steps_total"] - st0["decode_steps_total"]
    log("decode: closed-loop load on %s, %d requests from %d clients "
        "(prompts %d-%d, %d new tokens each): TTFT p50 %.2f ms, p90 %.2f "
        "ms, p99 %.2f ms over %d requests; ITL p50 %.2f ms, p90 %.2f ms, "
        "p99 %.2f ms over %d intervals; %.1f decode tokens/s (%d generated "
        "in %.3fs; %d fused steps, %.2f live slots per step); the engine's "
        "step EWMA at the end %.2f ms [%s]"
        % (kernel, LM_LOAD, LM_LOAD_CLIENTS, LM_LENGTHS[0], LM_LENGTHS[-1],
           LM_NEW, pct(ttft, 50), pct(ttft, 90), pct(ttft, 99), len(ttft),
           pct(itl, 50), pct(itl, 90), pct(itl, 99), len(itl),
           LM_LOAD * LM_NEW / load_s, LM_LOAD * LM_NEW, load_s, steps,
           LM_LOAD * (LM_NEW - 1) / max(steps, 1),
           st1["decode_admission"]["itl_ms"], gpu))


def time_calls(fn, reps):
    """Median (device ms by CUDA events, host ms) of ``reps`` calls of
    ``fn`` after one warm-up call; each call ends in a synchronize."""
    fn()
    device_ms, host_ms = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        device_ms.append(e0.elapsed_time(e1))
        host_ms.append(1e3 * (time.monotonic() - t0))
    return statistics.median(device_ms), statistics.median(host_ms)


def log_profile(fn, what, gpu, top=8, also=(), groups=None, ranges=()):
    """torch.profiler over one call of ``fn``: device time by kernel (the
    ``top`` largest, and beyond them every kernel whose name holds one of
    ``also``) and the host's aten op calls (nested calls included);
    with ``groups`` ({group: name fragments}, first match wins, the rest
    "other") also the device time by group; with ``ranges`` (names of
    ``record_function`` ranges) also the device time of the kernels
    launched inside each range. Returns the device time in microseconds
    (0 when none was recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    ops = sum(e.count for e in averages if e.key.startswith("aten::"))
    # a range's twin on the device timeline is no kernel
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA
               and e.self_device_time_total
               and not getattr(e, "is_user_annotation", False)]
    total_us = sum(e.self_device_time_total for e in kernels)
    if not total_us:
        log("%s: torch.profiler recorded no device time (%d aten op calls "
            "on the host)" % (what, ops))
        return 0
    log("%s: profiled device time %.3f ms in %d kernel launches; %d aten "
        "op calls on the host [%s]" % (what, total_us / 1e3,
                                       sum(e.count for e in kernels), ops,
                                       gpu))
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < top or any(name in e.key for name in also):
            log("  %8.3f ms x%-4d %s" % (e.self_device_time_total / 1e3,
                                          e.count, e.key[:90]))
    if groups:
        by_group = {}
        for e in kernels:
            group = next((g for g, frags in groups.items()
                          if any(f in e.key for f in frags)), "other")
            us, n = by_group.get(group, (0, 0))
            by_group[group] = us + e.self_device_time_total, n + e.count
        log("%s: device time by group: %s [%s]" % (what, ", ".join(
            "%s %.3f ms (%.1f%%, %d launches)"
            % (g, us / 1e3, 100.0 * us / total_us, n)
            for g, (us, n) in sorted(by_group.items(),
                                     key=lambda kv: -kv[1][0])), gpu))
    if ranges:
        spans = {name: [0.0, 0] for name in ranges}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name in spans:
                spans[e.name][0] += e.device_time_total
                spans[e.name][1] += 1
        inside = sum(us for us, _ in spans.values())
        log("%s: device time inside ranges: %s; together %.3f ms (%.1f%%) "
            "[%s]" % (what, ", ".join(
                "%s %.3f ms (%.1f%%, %d ranges)"
                % (name, us / 1e3, 100.0 * us / total_us, n)
                for name, (us, n) in spans.items()),
                inside / 1e3, 100.0 * inside / total_us, gpu))
    return total_us


def decode_step_profile(engine, what, gpu):
    """Where one fused decode step's time goes: every slot, each row's
    write at max_len - 1 (a position each tenant rewrites before it is
    read, as the engine's idle rows do); 10 timed steps, one profiled."""
    toks = np.zeros(engine.slots, np.int32)
    pos = np.full(engine.slots, engine.max_len - 1, np.int32)

    def step():
        with torch.no_grad():
            return engine._step_impl(engine.params, toks, pos)

    device_ms, host_ms = time_calls(step, 10)
    log("%s (%d slots): %.3f ms by CUDA events, %.3f ms host (median of "
        "10) [%s]" % (what, engine.slots, device_ms, host_ms, gpu))
    log_profile(step, what, gpu)


def prefill_profile(engine, prompt, kernel, gpu):
    """Where a time-to-first-token goes: one monolithic prefill of
    ``prompt`` (its power-of-two bucket, flash on ``kernel``) and one
    suffix chunk of up to 128 tokens at the shared prefix's end (dense,
    as after a prefix hit), each into slot 0 of the idle engine (median
    of 3); then the prefill's device time by kernel."""
    bucket = _prefill_bucket(len(prompt), engine.max_len)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :len(prompt)] = prompt
    off = LM_SHARED
    chunk = np.asarray([prompt[off:off + 128]], np.int32)
    width = chunk.shape[1]

    def prefill():
        with torch.no_grad():
            engine._prefill_impl(engine.params, ids, len(prompt), 0)

    def suffix():
        with torch.no_grad():
            engine._chunk_impl(engine.params, chunk, off, width - 1, 0)

    for what, fn in (("prefill %d (bucket %d) on %s"
                      % (len(prompt), bucket, kernel), prefill),
                     ("suffix chunk %d at %d" % (width, off), suffix)):
        device_ms, host_ms = time_calls(fn, 3)
        log("ttft: %s: %.3f ms by CUDA events, %.3f ms host (median of 3) "
            "[%s]" % (what, device_ms, host_ms, gpu))
    log_profile(prefill, "ttft: the prefill on %s" % kernel, gpu, top=6)


def int8_gate(feed, f32_logits, gpu):
    """An int8 lm_teacher (the same random weights, absmax per-channel
    kernels) against the f32 one on one 1024-token row: the JAX
    package's gate, relative Frobenius error < 0.05 and top-1
    agreement >= 0.9. Then the cost of dequantizing inside every
    forward: its decode step, timed and profiled."""
    server = lm_teacher(**LM, slots=LM_SLOTS, max_batch=1,
                        host="127.0.0.1", device="cuda", quantize="int8",
                        admission=AdmissionController(slo_ms=60000.0)
                        ).start()
    client = RpcClient(server.endpoint, timeout=600.0)
    try:
        got = client.call("predict", feed)["logits"]
    finally:
        client.close()
        server.stop()
    rel = float(np.linalg.norm(got - f32_logits) /
                np.linalg.norm(f32_logits))
    top1 = float(np.mean(got.argmax(-1) == f32_logits.argmax(-1)))
    log("decode: int8 lm_teacher vs f32 on 1 x 1024 tokens: relative "
        "Frobenius error %.4f (limit %g), top-1 agreement %.4f (min %g) "
        "[%s]" % (rel, INT8_MAX_REL, top1, INT8_MIN_TOP1, gpu))
    if not (rel < INT8_MAX_REL and top1 >= INT8_MIN_TOP1):
        raise AssertionError("int8 lm_teacher fails the quantized gate")
    decode_step_profile(server.decode_engine, "int8 decode step", gpu)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    gpu = card()
    log("device: %s [%s]" % (torch.cuda.get_device_name(0), gpu))
    build(gpu)
    kernel_rows = kernel_phase(gpu)
    bwd_rows = bwd_phase(gpu)
    by_path = {"predict": slice_phase(gpu)}
    by_path.update(decode_phase(gpu))
    by_path.update(train_phase(gpu))
    by_path.update(resnet_phase(gpu))
    repo = os.path.dirname(os.path.abspath(__file__))
    # each kernel's numbers at its main path's shape: sm90 at the served
    # predict (bf16 causal, b4); tf32x3 at lm_teacher's longest prefill,
    # and ffma, which it replaced there, by name on the same shape
    main_case = {"sm90": ("slice", 1024), "tf32x3": ("lm prefill", 1024),
                 "ffma": ("lm prefill", 1024)}
    kernels = []
    for name, source in fa.SOURCES.items():
        what, s = main_case[name]
        row = next(r for r in kernel_rows if r["kernel"] == name
                   and r["what"] == what and r["causal"]
                   and r["shape"][2] == s)
        launches = {path: counts[name] for path, counts in by_path.items()}
        kernels.append({
            "name": "flash_fwd_" + name, "route": "cuda",
            "source": os.path.relpath(source, repo),
            "replaces": "edl_tpu/ops/flash_attention.py:82",
            "replaces_also": "edl_tpu/ops/flash_attention.py:30",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "lse_ms": row["lse_ms"], "lse_max_abs_err": row["lse_max_abs_err"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bound_rate": row["bound_rate"],
            "library_ms": row["library_ms"], "ffma_ms": row["ffma_ms"],
            "device_ms": row["device_ms"],
            "lse_device_ms": row["lse_device_ms"],
            "shapes": [r for r in kernel_rows if r["kernel"] == name],
        })
    # the backward's kernels at the GPT-2s training shape (the FFMA dq and
    # dk/dv by name there); "plain" is flash_bwd_reference given the
    # forward's lse (the whole backward; the plain delta for bwd_delta),
    # "library" SDPA's whole backward, none for bwd_delta: no one PyTorch
    # call sums bf16 products into f32 rows
    train = {r["what"]: r for r in bwd_rows if r["what"].endswith("train")}
    gpt2s = train["gpt2s train"]
    for name in fa.BWD_KERNELS + fa.BWD_SM90_KERNELS:
        launches = {path: counts[name] for path, counts in by_path.items()}
        sm90 = name.endswith("_sm90")
        kernels.append({
            "name": "flash_" + name, "route": "cuda",
            "source": os.path.relpath(
                fa._SOURCE_BWD_SM90 if sm90 else fa._SOURCE_BWD, repo),
            "replaces": "edl_tpu/ops/flash_attention.py:254",
            "replaces_note": "_flash_bwd, an XLA lax.scan custom_vjp "
                             "backward, not Pallas",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": (gpt2s["delta_max_abs_err"]
                            if name == "bwd_delta" else
                            gpt2s["max_abs_err"] if sm90 else
                            gpt2s["ffma_max_abs_err"]),
            "ms": gpt2s["ms"][name],
            "bert_ms": train["bert-base train"]["ms"][name],
            **({"device_ms": gpt2s["device_ms"]["bwd_delta"],
                "bert_device_ms":
                    train["bert-base train"]["device_ms"]["bwd_delta"]}
               if name == "bwd_delta" else {}),
            "plain_ms": (gpt2s["plain_delta_ms"] if name == "bwd_delta"
                         else gpt2s["plain_ms"]),
            "bound_ms": gpt2s["bound_ms"][name],
            "bound_by": gpt2s["bound_by"][name],
            "library_ms": (None if name == "bwd_delta"
                           else gpt2s["library_ms"]),
            "backward_library_ms": gpt2s["library_ms"],
            "backward_ms": gpt2s["ms"]["all"],
            "backward_device_ms": gpt2s["device_ms"]["all"],
            "backward_library_device_ms": gpt2s["device_ms"]["library"],
            "backward_ffma_ms": gpt2s["ms"]["all_ffma"],
            "backward_bound_ms": gpt2s["bound_ms"]["all"],
            # every case of the backward, once
            **({"shapes": bwd_rows} if name == "bwd_delta" else
               {"shapes_in": "flash_bwd_delta"}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
