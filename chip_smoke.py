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
   time from its profiler ranges, the device-busy share, aten calls);
7. elastic: the checkpoint engine and ``ElasticTrainer`` on the card.
   (a) ResNet50_vd as the resnet phase trains it, with sgd over
   ``lr_schedules``' warm-up and cosine, and (b) GPT-2s with flash and
   adamw, each through an ``ElasticTrainer``: 2 epochs of 3 steps with
   epoch-end saves, once sync (dense npz) and once async (the stream
   engine: pinned snapshot on a side stream, background persist), 4
   steps more (with the async persist in flight) and 4 after it; a
   fresh trainer on the same directory resumes, every leaf of its state
   (params, momentum or adamw's count, mu and nu, BN statistics, step)
   must equal the saved one bit for bit, and its next 4 steps must give
   the uninterrupted run's losses and state bit for bit. GPT-2s's steps
   must launch the sm90 forward and backward kernels as the train
   phase's do, ResNet none. First a ResNet step repeated from one state
   says whether cuDNN's default algorithms repeat it bit for bit; only
   where they do not are the ResNet continuations and the drill held to
   ``RESUME_RTOL`` instead, naming the leaves that differ.
   (c) the drill: ``python -m edl_tpu_torch.examples.resnet.train`` in a
   subprocess, SIGTERMed mid-epoch, must exit 101 with an emergency
   checkpoint at its current step; its restart must resume at that step
   and exit 0, and its final state must match the same batches run in
   this process without a stop. A ``save_async`` followed at once by an
   in-place write to every leaf must restore the values at the save.
   (d) ``tools/ckpt_bench``'s CRC-gated
   round trip of a 1 GB state. Prints save, snapshot, persist and
   restore seconds, bytes and GB/s, and step ms with and without a
   persist in flight;
8. distill: two ``gpt_teacher`` children at GPT-2s width (seq 256,
   compiled batch 8, the same weights from INIT_SEED) serve a GPT-2s
   student (flash, remat, adamw) that trains on their ``probs`` through
   the port's ``DistillReader`` (fixed teachers) with
   ``examples/distill/gpt_distill.py``'s loss: 2 epochs of 8 batches,
   one teacher SIGKILLed mid-way through the last. Every batch must come
   once, in the generator's order, with probs bit-equal to one teacher's
   direct reply for the same ids; the student's losses and final state
   must equal, bit for bit, a replay of the same steps from the same
   initial state on the direct replies; the surviving teacher must
   launch 12 ``sm90`` per device batch and the student 24 ``sm90`` and
   12 of each sm90 backward kernel per step; the card's memory must come
   back once the children are reaped. Prints the step with and without
   the reader, the wait per batch and its share, bytes per reply, the
   teachers' stats and the peak host RSS; as a control, the replay's
   step again while clients pull the surviving teacher's replies in
   threads of this process, then in other processes;
9. distill examples: ``python -m edl_tpu_torch.examples.distill.
   {gpt,resnet,mnist}_distill`` as subprocesses at their defaults
   against the port's teacher CLI (mnist_distill serves its own): each
   exits 0 with its final JSON line, mnist_distill's student meets the
   reference's accuracy rule, and gpt_distill SIGTERMed mid-epoch exits
   101; each child reports its flash launches at exit, held to what
   auto-dispatch picks. Then ``tools/distill_bench`` with the gpt
   teacher on the card (serial and pipelined byte-identical) and
   ``tools/distill_qps``;
10. serve_bench: ``tools/serve_bench``'s ``run("micro")`` under the
   reference's gates (typed sheds only, none stranded, scale-out and
   scale-in, the drain fault, dry-replay parity; its environment and
   fault plane restored) and ``run_decode("micro")`` with its models
   and KV caches on the card under its correctness gates (tokens equal
   to ``generate`` serial, batched and int8; int8 logits and bytes; one
   step shape; every shed reason; none stranded; the journaled
   scale-out; prefix parity and exact accounting; no monolithic prefill
   under chunking). Its three timing ratios and ``_decode_healthy``'s
   verdict are printed, not gated.

Prints each phase's wall seconds, a ``kernels`` JSON line (the three
forward kernels, with and without lse, and the backward's five,
launches by path, the ResNet, elastic, distill, example and bench paths
included), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when CUDA is unavailable.
"""

import contextlib
import gc
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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
from edl_tpu_torch.runtime import checkpoint as checkpoint_mod
from edl_tpu_torch.runtime import lr_schedules, optim, trainer
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
# the elastic phase: ElasticTrainer over ResNet50_vd as the bench trains
# it (1000 classes, b128 x 224, s2d, bf16 over f32 params and BN
# statistics) with sgd(momentum 0.9) over lr_schedules' warm-up and
# cosine, and over GPT-2s with flash (b8 x 1024, remat, adamw(1e-4)):
# ELASTIC_EPOCHS epochs of ELASTIC_STEPS steps with epoch-end saves (sync,
# then async), ELASTIC_CONT steps more, then a fresh trainer resumes on
# the same directory and takes the same ELASTIC_CONT steps
ELASTIC_EPOCHS, ELASTIC_STEPS, ELASTIC_CONT = 2, 3, 4
ELASTIC_LR, ELASTIC_WARMUP = 0.1, 3
GPT_BATCH = 8
# a resumed run's next steps against the uninterrupted run's, from a
# bit-equal state: bit for bit, GPT-2s always and ResNet50_vd (here and
# in the drill) wherever its step repeats bit for bit from one state with
# cuDNN's default algorithms (determinism_probe); where it does not, each
# loss within RESUME_RTOL relative and each leaf of the state within
# relative Frobenius RESUME_RTOL, naming the leaves the probe saw differ
# (a step's nondeterminism is a summation order: ~1e-7 relative per f32
# sum, which a few bf16 steps grow but keep far under 1e-3)
RESUME_RTOL = 1e-3
# the drill: the port's examples/resnet entry point in subprocesses
# (ResNet50_vd in bf16, 100 classes, b64 x 128, 2 epochs of 4 steps, a
# line per step); SIGTERM once epoch 1's first step is printed
DRILL_ARGS = ["--depth", "50", "--dtype", "bf16", "--num_classes", "100",
              "--total_batch_size", "64", "--image_size", "128",
              "--epochs", "2", "--steps_per_epoch", "4", "--fetch_steps",
              "1", "--warmup_epochs", "1"]
DRILL_KILL_AFTER = "epoch 1 step 1 "
DRILL_TIMEOUT = 300
# tools/ckpt_bench's CRC-gated round trip at a GB-scale state
CKPT_BENCH_MB = 1024
# the async snapshot under a step that writes in place: INPLACE_LEAVES
# f32 leaves of INPLACE_MB each
INPLACE_LEAVES, INPLACE_MB = 4, 128
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
# the distill phase: a GPT-2s student (flash, bf16 over f32 params, remat,
# adamw(DISTILL_LR)) at DISTILL_BATCH x DISTILL_SEQ trains with
# examples/distill/gpt_distill.py's loss (weight DISTILL_W on the soft
# term), fed by a DistillReader over two gpt_teacher children at GPT-2s
# width whose compiled batch is the student's, so that every request is
# one device batch of the same shape: DISTILL_EPOCHS epochs of
# DISTILL_STEPS batches, one teacher SIGKILLed once DISTILL_KILL_AT
# batches of the last epoch are out
DISTILL_SEQ, DISTILL_BATCH, DISTILL_STEPS = 256, 8, 8
DISTILL_EPOCHS, DISTILL_KILL_AT = 2, 3
DISTILL_W, DISTILL_LR = 0.5, 1e-3
# each reply carries f32 logits and probs, 2 x 8 x 256 x 32000 x 4 B = 524
# MB: the reader feeds at most DISTILL_IN_FLIGHT batches ahead of the
# student and keeps DISTILL_DEPTH requests on each teacher's connection
DISTILL_IN_FLIGHT, DISTILL_DEPTH = 4, 2
# the controls after the replay: DISTILL_CONTROL_STEPS more steps while
# DISTILL_PULLERS clients keep the surviving teacher's replies streaming
# into this process (threads) and into other processes, after
# DISTILL_CONTROL_LEAD seconds of traffic
DISTILL_CONTROL_STEPS, DISTILL_PULLERS, DISTILL_CONTROL_LEAD = 12, 2, 2.0
# a child's start (import, CUDA context, weights) and any one RPC, seconds
CHILD_TIMEOUT = 300
# the card's free memory once the teacher children are reaped, against
# before they started (this process's cache emptied both times): at most
# CHILD_MEM_SLACK less
CHILD_MEM_SLACK = 1 << 30
# the examples phase: the port's distill examples as subprocesses at their
# defaults, against the port's teacher CLI at the sizes the examples feed
EXAMPLE_TIMEOUT = 300
GPT_TEACHER_ARGS = ["--model", "gpt", "--seq_len", "16", "--vocab_size",
                    "64"]
RESNET_TEACHER_ARGS = ["--model", "resnet", "--depth", "18", "--image_size",
                       "32", "--num_classes", "10"]
# the examples' GPT (gpt_distill's student, the teacher CLI's and
# distill_bench's gpt_teacher): 2 layers, d 64 over 4 heads
EX_LAYERS, EX_HEAD_DIM = 2, 64 // 4
# gpt_distill SIGTERMed once this line is printed (mid-epoch: the run has
# GPT_SIGTERM_STEPS steps)
GPT_SIGTERM_STEPS, GPT_SIGTERM_AFTER = 1000, "epoch 0 step 3 "
# mnist_distill's rule (the reference's tests/test_distill_accuracy.py):
# the 32-unit student recovers the 256-unit teacher's accuracy
MNIST_TEACHER_ACC, MNIST_STUDENT_ACC, MNIST_STEPS, MNIST_LOSS = (0.95, 0.9,
                                                                60, 0.67)
# the serve-bench phase: tools/serve_bench's micro arcs and its int8 gate
SERVE_SEED = 7
INT8_BENCH_REL, INT8_BENCH_BYTES = 0.05, 0.6


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


def flat_state(state):
    """{key: tensor} of a train state, keyed as the checkpoint is."""
    return dict(checkpoint_mod._flatten(state))


def state_bytes(state):
    return sum(t.numel() * t.element_size()
               for t in flat_state(state).values())


def clone_state(state):
    return {k: v.detach().clone() for k, v in flat_state(state).items()}


def hold_bit_equal(got, want, what):
    """Every leaf of ``got`` (a train state) equal to ``want`` (a flat
    state) bit for bit, in dtype and shape."""
    got = flat_state(got)
    if sorted(got) != sorted(want):
        raise AssertionError("%s: keys differ: %s" % (
            what, sorted(set(got) ^ set(want))[:5]))
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or got[k].shape != want[k].shape
           or not torch.equal(got[k].to(want[k].device), want[k])]
    if bad:
        raise AssertionError("%s: %d of %d leaves differ, e.g. %s"
                             % (what, len(bad), len(want), bad[:3]))
    return len(want)


def hold_continuation(got_losses, want_losses, got_state, want, what,
                      nondeterministic=None):
    """A resumed run's next steps against the uninterrupted run's: bit for
    bit, or within RESUME_RTOL where ``nondeterministic`` says why the
    step cannot repeat. Returns (bitwise, worst loss relative error,
    worst leaf relative Frobenius)."""
    got = flat_state(got_state)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got_losses,
                                                       want_losses))
    worst = 0.0
    for key, ref in want.items():
        g = got[key].to(ref.device)
        if torch.equal(g, ref):
            continue
        diff = (g.double() - ref.double()).norm().item()
        worst = max(worst, diff / max(ref.double().norm().item(), 1e-30))
    bitwise = got_losses == want_losses and worst == 0.0
    if not bitwise and (nondeterministic is None
                        or loss_err > RESUME_RTOL or worst > RESUME_RTOL):
        raise AssertionError(
            "%s: resumed steps' losses %s vs %s (worst %.3g relative), "
            "state worst leaf %.3g relative Frobenius (limit %s)"
            % (what, got_losses, want_losses, loss_err, worst,
               "bit for bit" if nondeterministic is None else
               "%g: %s" % (RESUME_RTOL, nondeterministic)))
    return bitwise, loss_err, worst


def timed_steps(tr, batch, first, n, handle=None):
    """``n`` steps from batch index ``first``: losses and ms each (the
    loss read ends each step), and for each whether ``handle``'s persist
    was still running when the step ended."""
    losses, ms, persisting = [], [], []
    for i in range(first, first + n):
        t0 = time.perf_counter()
        losses.append(float(tr.train_step(batch(ELASTIC_EPOCHS, i))))
        ms.append((time.perf_counter() - t0) * 1e3)
        persisting.append(handle is not None and not handle.done())
    return losses, ms, persisting


def manifest_nbytes(directory, version):
    with open("%s/v_%08d/MANIFEST" % (directory, version)) as f:
        return json.load(f)["nbytes"]


def elastic_round_trip(make, batch, what, async_save, gpu,
                       nondeterministic=None):
    """ELASTIC_EPOCHS epochs of ELASTIC_STEPS steps with epoch-end saves,
    ELASTIC_CONT steps more (with ``async_save`` the last save's persist
    runs meanwhile) and ELASTIC_CONT with no persist in flight; then a
    fresh trainer on the same directory resumes, its state must be the
    saved one bit for bit, and its ELASTIC_CONT steps must give the
    uninterrupted run's (``hold_continuation``). Returns the numbers."""
    directory = tempfile.mkdtemp(prefix="elastic_")
    mode = "async" if async_save else "sync"
    try:
        tr = make(directory, async_save)
        for epoch in range(ELASTIC_EPOCHS):
            tr.begin_epoch(epoch)
            for i in range(ELASTIC_STEPS):
                tr.train_step(batch(epoch, i))
            torch.cuda.synchronize()
            if epoch == ELASTIC_EPOCHS - 1:
                saved = clone_state(tr.train_state)
            t0 = time.perf_counter()
            tr.end_epoch(save=True)
            save_s = time.perf_counter() - t0
        version = tr.global_step
        # the engine's handle of the last async save (None when sync)
        handle = tr._ckpt._inflight if async_save else None
        cont, inflight_ms, persisting = timed_steps(tr, batch, 0,
                                                    ELASTIC_CONT, handle)
        after = clone_state(tr.train_state)
        tr._ckpt.drain()
        if handle is not None:
            handle.result()  # a failed persist raises here
        _, quiet_ms, _ = timed_steps(tr, batch, ELASTIC_CONT, ELASTIC_CONT)
        nbytes = (handle.nbytes if handle is not None
                  else manifest_nbytes(directory, version))
        tr.close()
        del tr
        torch.cuda.empty_cache()

        fresh = make(directory, False)
        t0 = time.perf_counter()
        if not fresh.resume():
            raise AssertionError("%s: nothing to resume" % what)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if fresh.global_step != version:
            raise AssertionError("%s: resumed at step %d, saved %d"
                                 % (what, fresh.global_step, version))
        leaves = hold_bit_equal(fresh.train_state, saved,
                                "%s %s restore" % (what, mode))
        again, _, _ = timed_steps(fresh, batch, 0, ELASTIC_CONT)
        bitwise, loss_err, leaf_err = hold_continuation(
            again, cont, fresh.train_state, after,
            "%s %s continuation" % (what, mode), nondeterministic)
        fresh.close()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    out = {"mode": mode, "version": version, "bytes": nbytes,
           "leaves": leaves, "save_s": save_s, "restore_s": restore_s,
           "restore_gb_s": nbytes / restore_s / 1e9,
           "inflight_ms": inflight_ms, "persisting": persisting,
           "quiet_ms": quiet_ms,
           "losses": cont, "resumed_losses": again, "bitwise": bitwise,
           "loss_rel_err": loss_err, "leaf_rel_err": leaf_err}
    if handle is not None:
        out.update(snapshot_s=handle.blocked_s, persist_s=handle.persist_s,
                   persist_gb_s=nbytes / handle.persist_s / 1e9)
        save_what = ("snapshot %.4f s on the training thread, persist "
                     "%.4f s (%.3f GB/s) in the background"
                     % (handle.blocked_s, handle.persist_s,
                        out["persist_gb_s"]))
    else:
        save_what = "sync save %.4f s (%.3f GB/s)" % (
            save_s, nbytes / save_s / 1e9)
    log("elastic: %s %s: v%d, %d leaves, %.1f MB; %s; restore %.4f s "
        "(%.3f GB/s), every leaf bit-equal; step ms after the save %s "
        "(* the persist still running at the step's end), then %s; "
        "continuation losses %s vs %s: %s (loss %.3g, leaf %.3g "
        "relative) [%s]"
        % (what, mode, version, leaves, nbytes / 1e6, save_what, restore_s,
           out["restore_gb_s"],
           ["%.2f%s" % (x, "*" if p else "")
            for x, p in zip(inflight_ms, persisting)],
           ["%.2f" % x for x in quiet_ms], cont, again,
           "bitwise" if bitwise else "within %g" % RESUME_RTOL, loss_err,
           leaf_err, gpu))
    return out


def resnet_elastic_trainer(directory, async_save):
    """The elastic ResNet50_vd: the bench's model and batch size, sgd
    over the warm-up + cosine schedule."""
    model, params, extra, loss_fn = resnet.create_model_and_loss(
        depth=50, num_classes=1000, vd=True, space_to_depth=True,
        dtype=torch.bfloat16, device="cuda")
    total = (ELASTIC_EPOCHS + 1) * ELASTIC_STEPS
    schedule = lr_schedules.linear_warmup(
        lr_schedules.cosine_decay(lr_schedules.scale_lr_for_batch(
            ELASTIC_LR, RESNET_BATCH), total), ELASTIC_WARMUP)
    return trainer.ElasticTrainer(
        loss_fn, params, optim.sgd(schedule, momentum=0.9),
        total_batch_size=RESNET_BATCH, extra_state=extra, has_aux=True,
        checkpoint_dir=directory, async_save=async_save, device="cuda",
        keep_checkpoints=2)


def resnet_elastic_batch(epoch, i):
    gen = torch.Generator(device="cuda").manual_seed(1000 * epoch + i)
    return {"image": torch.randn(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3,
                                 generator=gen, device="cuda"),
            "label": torch.randint(0, 1000, (RESNET_BATCH,), generator=gen,
                                   device="cuda")}


def gpt_elastic_trainer(directory, async_save):
    model = Gpt(dtype=torch.bfloat16, remat=True, use_flash=True,
                device="cuda")
    _, params, loss_fn = gpt.create_model_and_loss(model=model)
    return trainer.ElasticTrainer(
        loss_fn, params, optim.adamw(1e-4), total_batch_size=GPT_BATCH,
        checkpoint_dir=directory, async_save=async_save, device="cuda",
        keep_checkpoints=2)


def gpt_elastic_batch(epoch, i):
    gen = torch.Generator(device="cuda").manual_seed(1000 * epoch + i)
    return {"input_ids": torch.randint(0, GPT2S["vocab_size"],
                                       (GPT_BATCH, GPT2S["seq_len"]),
                                       generator=gen, device="cuda")}


def determinism_probe(gpu):
    """One ResNet50_vd step twice from the same state and batch, with
    cuDNN's default algorithms and with ``cudnn.deterministic``: which
    of the two repeats itself bit for bit. Returns None where the default
    algorithms repeat, else what differs (the ResNet continuations and
    the drill are then held to RESUME_RTOL)."""
    model, params, extra, loss_fn = resnet.create_model_and_loss(
        depth=50, num_classes=1000, vd=True, space_to_depth=True,
        dtype=torch.bfloat16, device="cuda")
    tx = optim.sgd(0.1, momentum=0.9)
    step = trainer.make_train_step(loss_fn, tx, has_aux=True)
    state = trainer.make_train_state(params, tx, extra)
    batch = resnet_elastic_batch(9, 0)
    out = {}
    before = torch.backends.cudnn.deterministic
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            runs = [step(state, batch, None) for _ in range(2)]
            a, b = (flat_state(s) for s, _ in runs)
            differ = [k for k in a if not torch.equal(a[k], b[k])]
            out[det] = (runs[0][1].item() == runs[1][1].item(), differ)
    finally:
        torch.backends.cudnn.deterministic = before
    for det, (same_loss, differ) in out.items():
        log("elastic: ResNet50_vd step repeated from one state, "
            "cudnn.deterministic=%s: loss %s, %d leaves differ%s [%s]"
            % (det, "equal" if same_loss else "differs", len(differ),
               " (e.g. %s)" % differ[:4] if differ else "", gpu))
    same_loss, differ = out[False]
    if same_loss and not differ:
        return None
    return ("a ResNet50_vd step does not repeat with cuDNN's default "
            "algorithms (leaves %s differ; with cudnn.deterministic %s)"
            % (differ[:4], "they do not" if out[True][1] else "none do"))


def elastic_drill(gpu, args=DRILL_ARGS, device="cuda",
                  nondeterministic=None):
    """The stop-resume drill through ``python -m
    edl_tpu_torch.examples.resnet.train``: a run SIGTERMed once epoch
    1's first step is printed must exit 101 with an emergency checkpoint
    at its current step, mid-epoch; its restart must resume at that step
    and exit 0; its final state must match a run in this process over
    the same batches (epoch 0, the interrupted epoch's first steps, then
    that epoch again: a restart re-runs the interrupted epoch) bit for
    bit, or within RESUME_RTOL where ``nondeterministic`` says why the
    step cannot repeat."""
    from edl_tpu_torch.examples.resnet import train as example

    repo = os.path.dirname(os.path.abspath(__file__))
    directory = tempfile.mkdtemp(prefix="drill_")
    env = dict(os.environ, EDL_TPU_CHECKPOINT_PATH=directory,
               PYTHONPATH=repo)
    cmd = ([sys.executable, "-m", "edl_tpu_torch.examples.resnet.train"]
           + list(args) + ["--device", device])
    parsed = example.parse_args(list(args) + ["--device", device])
    spe = parsed.steps_per_epoch

    def run(kill_after=None):
        t0 = time.monotonic()
        lines = []
        with tempfile.TemporaryFile("w+") as err:
            proc = subprocess.Popen(cmd, cwd=repo, env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=err)
            try:
                for line in proc.stdout:
                    lines.append(line.rstrip())
                    if kill_after and line.startswith(kill_after):
                        proc.send_signal(signal.SIGTERM)
                        kill_after = None
                rc = proc.wait(timeout=DRILL_TIMEOUT)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if rc not in (0, 101):
                err.seek(0)
                log("\n".join(err.read().splitlines()[-30:]))
        return rc, lines, time.monotonic() - t0

    try:
        rc, lines, first_s = run(kill_after=DRILL_KILL_AFTER)
        cm = checkpoint_mod.CheckpointManager(directory)
        versions = cm.versions()
        if rc != 101 or not versions:
            raise AssertionError("drill: the SIGTERMed run exited %s with "
                                 "versions %s: %s" % (rc, versions,
                                                      lines[-5:]))
        stop = versions[-1]
        ended = cm.meta(stop)["state"]["epochs"]["1"]["ended"]
        if not spe < stop < 2 * spe or ended:
            raise AssertionError("drill: emergency checkpoint v%d (epoch 1 "
                                 "ended: %s) is not mid-epoch 1" % (stop,
                                                                    ended))
        rc2, lines2, second_s = run()
        want_line = "resumed=True step=%d" % stop
        if rc2 != 0 or not any(want_line in ln for ln in lines2):
            raise AssertionError("drill: the restart exited %s without "
                                 "%r: %s" % (rc2, want_line, lines2[:3]))
        result = json.loads(lines2[-1])
        final = stop + spe  # the interrupted epoch runs again in full
        if result["steps"] != final or cm.versions()[-1] != final:
            raise AssertionError("drill: restart ended at step %s, v%s; "
                                 "want %d" % (result["steps"],
                                              cm.versions()[-1], final))
        # the same batches in this process, with no stop
        _, ref = example.build(parsed, checkpoint_dir="")
        seq = ([(0, i) for i in range(spe)]
               + [(1, i) for i in range(stop - spe)]
               + [(1, i) for i in range(spe)])
        streams = {e: list(example.host_batches(parsed, ref, e))
                   for e in (0, 1)}
        for epoch, i in seq:
            ref.train_step(streams[epoch][i])
        _, restored, _ = cm.restore(final, target=dict(ref.train_state))
        got = flat_state(restored)
        want = flat_state(ref.train_state)
        worst = 0.0
        for key, w in want.items():
            g = got[key].to(w.device)
            if not torch.equal(g, w):
                worst = max(worst, (g.double() - w.double()).norm().item()
                            / max(w.double().norm().item(), 1e-30))
        if worst > (0.0 if nondeterministic is None else RESUME_RTOL):
            raise AssertionError(
                "drill: final state %.3g relative Frobenius from the same "
                "batches run without a stop (limit %s)"
                % (worst, "bit for bit" if nondeterministic is None else
                   "%g: %s" % (RESUME_RTOL, nondeterministic)))
        log("elastic: drill (%s): SIGTERM after %r -> exit 101 with an "
            "emergency checkpoint at step %d of epoch 1 (%.1f s); restart "
            "resumed at step %d, exit 0 at step %d (%.1f s); final state "
            "vs the same batches without a stop: %s [%s]"
            % (" ".join(args), DRILL_KILL_AFTER.strip(), stop, first_s,
               stop, final, second_s,
               "bit-equal" if worst == 0.0 else
               "worst leaf %.3g relative Frobenius" % worst, gpu))
        return {"stop": stop, "final": final, "first_s": first_s,
                "second_s": second_s, "leaf_rel_err": worst}
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def hold_async_snapshot_in_place(gpu):
    """``save_async`` of f32 leaves on the card, then at once an in-place
    write to every leaf on the training stream, while the snapshot's
    device-to-host copies may still run: the restored leaves must be the
    values at the save. The same leaves copied on a side stream that the
    training stream does not wait on show whether such a write races
    the copy (how many leaves it reached), so that the check can fail."""
    directory = tempfile.mkdtemp(prefix="inplace_")
    try:
        gen = torch.Generator(device="cuda").manual_seed(11)
        n = INPLACE_MB << 18  # f32 elements
        tree = {"w%d" % i: torch.randn(n, generator=gen, device="cuda")
                for i in range(INPLACE_LEAVES)}
        want = {k: v.cpu() for k, v in tree.items()}
        cm = checkpoint_mod.CheckpointManager(directory)
        handle = cm.save_async(1, tree)
        for v in tree.values():
            v.neg_()
        handle.result()
        _, restored, _ = cm.restore(1)
        cm.close()
        bad = [k for k in want if not torch.equal(restored[k], want[k])]
        if bad:
            raise AssertionError("async snapshot: leaves %s were restored "
                                 "with an in-place write made after "
                                 "save_async returned" % bad)
        # the hazard: a copy that the training stream does not wait on
        side = torch.cuda.Stream()
        host = {k: torch.empty(n, pin_memory=True) for k in tree}
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for k, v in tree.items():
                host[k].copy_(v, non_blocking=True)
        for v in tree.values():
            v.neg_()
        side.synchronize()
        raced = sum(not torch.equal(host[k], -want[k]) for k in want)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    log("elastic: save_async of %d f32 leaves of %d MB, each written in "
        "place at once: restored as saved; the same write reached %d of "
        "%d leaves of a copy the training stream does not wait on [%s]"
        % (INPLACE_LEAVES, INPLACE_MB, raced, INPLACE_LEAVES, gpu))
    return {"leaves": INPLACE_LEAVES, "mb": INPLACE_MB,
            "unordered_copy_raced": raced}


def ckpt_phase(gpu):
    """tools/ckpt_bench's CRC-gated round trip of a CKPT_BENCH_MB state
    on the card."""
    from edl_tpu_torch.tools import ckpt_bench

    directory = tempfile.mkdtemp(prefix="ckpt_bench_")
    try:
        out = ckpt_bench.run(tree_mb=CKPT_BENCH_MB, repeats=2,
                             device="cuda", directory=directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    log("elastic: ckpt_bench %s [%s]" % (json.dumps(out), gpu))
    if not out["roundtrip_ok"]:
        raise AssertionError("ckpt_bench: the round trip is not bit-exact")
    return out


def elastic_phase(gpu):
    """Phase 7: the checkpoint engine and ElasticTrainer on the card.
    Returns the flash launches of its in-process paths."""
    by_path = {}
    torch.cuda.empty_cache()
    fa.reset_launches()
    resnet_nondet = determinism_probe(gpu)
    resnet_runs = [elastic_round_trip(resnet_elastic_trainer,
                                      resnet_elastic_batch, "ResNet50_vd",
                                      async_save, gpu, resnet_nondet)
                   for async_save in (False, True)]
    by_path["elastic_resnet"] = dict(fa.flash_attention.kernel_launches)
    if any(by_path["elastic_resnet"].values()):
        raise AssertionError("elastic_resnet launched flash kernels: %s"
                             % by_path["elastic_resnet"])
    torch.cuda.empty_cache()
    fa.reset_launches()
    gpt_runs = [elastic_round_trip(gpt_elastic_trainer, gpt_elastic_batch,
                                   "GPT-2s", async_save, gpu)
                for async_save in (False, True)]
    launches = dict(fa.flash_attention.kernel_launches)
    # each round trip: the saved epochs, ELASTIC_CONT steps in flight and
    # ELASTIC_CONT quiet, and the resumed ELASTIC_CONT
    steps = 2 * (ELASTIC_EPOCHS * ELASTIC_STEPS + 3 * ELASTIC_CONT)
    layers = GPT2S["num_layers"]
    want = only("sm90", 2 * layers * steps,
                **{k: layers * steps for k in fa.bwd_kernel_names("sm90")})
    if launches != want:
        raise AssertionError("elastic_gpt: flash launches %s over %d steps, "
                             "want %s" % (launches, steps, want))
    by_path["elastic_gpt"] = launches
    torch.cuda.empty_cache()
    drill = elastic_drill(gpu, nondeterministic=resnet_nondet)
    in_place = hold_async_snapshot_in_place(gpu)
    bench_out = ckpt_phase(gpu)
    log("elastic: %s [%s]" % (json.dumps({
        "resnet": [{k: v for k, v in r.items() if k != "leaves"}
                   for r in resnet_runs],
        "gpt2s": [{k: v for k, v in r.items() if k != "leaves"}
                  for r in gpt_runs],
        "resnet_nondeterministic": resnet_nondet,
        "drill": drill, "async_in_place": in_place,
        "ckpt_bench": bench_out}), gpu))
    return by_path


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


class Child(object):
    """A subprocess of the smoke: a thread collects its stdout lines, its
    stderr goes to a temporary file (``tail`` shows its end)."""

    def __init__(self, cmd, repo, name):
        self.name = name
        self.err = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(
            cmd, cwd=repo, env=dict(os.environ, PYTHONPATH=repo), text=True,
            stdout=subprocess.PIPE, stderr=self.err)
        self.lines = []
        self._eof = False
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append(line.rstrip("\n"))
                self._cond.notify_all()
        with self._cond:
            self._eof = True
            self._cond.notify_all()

    def tail(self, n=30):
        self.err.seek(0)
        return "\n".join(self.err.read().splitlines()[-n:])

    def wait_line(self, prefix, timeout=CHILD_TIMEOUT):
        """The rest of the first stdout line starting with ``prefix``."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                for line in self.lines:
                    if line.startswith(prefix):
                        return line[len(prefix):]
                left = deadline - time.monotonic()
                if self._eof or left <= 0:
                    raise AssertionError(
                        "%s: no %r line (exit %s); stdout %s; stderr:\n%s"
                        % (self.name, prefix, self.proc.poll(),
                           self.lines[-5:], self.tail()))
                self._cond.wait(left)

    def finish(self, sig=None, timeout=CHILD_TIMEOUT):
        """Send ``sig`` (if any), wait for the exit; returns its code."""
        if sig is not None and self.proc.poll() is None:
            self.proc.send_signal(sig)
        rc = self.proc.wait(timeout=timeout)
        self._reader.join(timeout=10)
        return rc

    def reap(self):
        """Kill the child if it still runs; wait for it."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._reader.join(timeout=10)
        self.err.close()


# run ``python -m <module> <args>`` with the flash launch counts printed
# as FLASH_LAUNCHES=<json> at its exit (after the module's own output)
COUNTED = (
    "import atexit, json, runpy, sys\n"
    "from edl_tpu_torch.ops import flash_attention as fa\n"
    "atexit.register(lambda: print('FLASH_LAUNCHES=' + json.dumps(\n"
    "    fa.flash_attention.kernel_launches), flush=True))\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


def counted(module, *args):
    return [sys.executable, "-c", COUNTED, module] + list(args)


def child_launches(child):
    return json.loads(child.wait_line("FLASH_LAUNCHES=", timeout=30))


def lm_step_launches(dtype, head_dim, seq, layers, steps):
    """The flash launches of ``steps`` training steps (no remat) of a
    ``layers``-deep LM at ``seq`` tokens, as auto-dispatch and
    ``kernel_for`` / ``bwd_kernel_for`` decide them on the card (none
    when dispatch keeps the shape dense)."""
    from edl_tpu_torch.ops.attention import flash_dispatch_reason

    if flash_dispatch_reason(seq, head_dim, device="cuda") is not None:
        return only("sm90", 0)
    bwd = fa.bwd_kernel_names(fa.bwd_kernel_for(dtype, head_dim))
    return only(fa.kernel_for(dtype, head_dim), layers * steps,
                **{k: layers * steps for k in bwd})


def forward_only(counts, kernel, layers):
    """``counts`` launch ``kernel`` alone, a positive multiple of
    ``layers`` times (forwards of whole device batches)."""
    n = counts[kernel]
    return n > 0 and n % layers == 0 and counts == only(kernel, n)


class RssSampler(object):
    """Peak resident memory of this process while it runs, sampled from
    /proc/self/statm every ``period`` seconds."""

    def __init__(self, period=0.02):
        self.period = period
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while True:
            self.peak = max(self.peak, self.rss())
            if self._stop.wait(self.period):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def distill_ids(i):
    """Batch ``i`` of the distill phase's student: ids from a seed."""
    return np.random.RandomState(1000 + i).randint(
        0, GPT2S["vocab_size"], (DISTILL_BATCH, DISTILL_SEQ)).astype(np.int32)


def bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def distill_teacher_child():
    """A teacher child of the distill phase: ``gpt_teacher`` at GPT-2s
    width on the card (random weights from INIT_SEED, seq DISTILL_SEQ,
    compiled batch DISTILL_BATCH, no projection shed: a reply takes
    longer than the default 500 ms SLO). Prints TEACHER_ENDPOINT=, serves
    until SIGTERM, then prints TEACHER_STATS= (its stats and flash
    launches) and returns 0."""
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    server = gpt_teacher(**dict(GPT2S, seq_len=DISTILL_SEQ),
                         max_batch=DISTILL_BATCH, host="127.0.0.1",
                         admission=AdmissionController(slo_ms=None),
                         device="cuda").start()
    fa.reset_launches()
    print("TEACHER_ENDPOINT=%s" % server.endpoint, flush=True)
    stop.wait()
    # stopped first: a batch still running when the signal came has then
    # been counted in both the stats and the launches
    server.stop()
    stats = server.stats()
    print("TEACHER_STATS=%s" % json.dumps({
        "launches": dict(fa.flash_attention.kernel_launches),
        "batches": stats["batches"], "rows": stats["rows"],
        "occupancy": stats["occupancy"]}), flush=True)
    return 0


# a process that asks the teacher at argv[1] for one batch's predictions
# over and over, printing a line per reply, until it is killed
PULL_REPLIES = (
    "import sys\n"
    "import numpy as np\n"
    "from edl_tpu_torch.rpc.client import RpcClient\n"
    "client = RpcClient(sys.argv[1], timeout=300)\n"
    "ids = np.zeros((%d, %d), np.int32)\n"
    "while True:\n"
    "    client.call('predict', {'input_ids': ids})\n"
    "    print('reply', flush=True)\n")


def reply_traffic_steps(tr, probs, endpoint, where, repo):
    """DISTILL_CONTROL_STEPS steps of ``tr`` on distill batches (their
    soft labels ``probs``) while DISTILL_PULLERS clients keep asking the
    teacher at ``endpoint`` for predictions, in threads of this process
    (``where`` "thread") or in other processes ("process"). Returns
    (step ms, replies received meanwhile)."""
    stop, count = threading.Event(), [0]

    def pull():
        client = RpcClient(endpoint, timeout=CHILD_TIMEOUT)
        while not stop.is_set():
            client.call("predict", {"input_ids": distill_ids(0)})
            count[0] += 1
        client.close()

    if where == "thread":
        pullers = [threading.Thread(target=pull, daemon=True)
                   for _ in range(DISTILL_PULLERS)]
        for t in pullers:
            t.start()
        replies = lambda: count[0]  # noqa: E731
    else:
        pullers = [Child([sys.executable, "-c", PULL_REPLIES % (
            DISTILL_BATCH, DISTILL_SEQ), endpoint], repo, "reply puller")
            for _ in range(DISTILL_PULLERS)]
        replies = lambda: sum(len(c.lines) for c in pullers)  # noqa: E731
    try:
        time.sleep(DISTILL_CONTROL_LEAD)
        n0, ms = replies(), []
        for i in range(DISTILL_CONTROL_STEPS):
            t0 = time.perf_counter()
            float(tr.train_step({"input_ids": distill_ids(i % DISTILL_STEPS),
                                 "soft_label": probs[i % DISTILL_STEPS]}))
            ms.append((time.perf_counter() - t0) * 1e3)
        n1 = replies()
    finally:
        stop.set()
        for puller in pullers:
            if where == "thread":
                puller.join(timeout=CHILD_TIMEOUT)
            else:
                puller.reap()
    return ms, n1 - n0


def distill_phase(gpu):
    """Phase 8: a GPT-2s student trains on two GPT-2s teachers'
    predictions through the port's DistillReader. Returns the flash
    launches of the student and of the surviving teacher."""
    from edl_tpu_torch.distill.distill_reader import DistillReader
    from edl_tpu_torch.examples.distill import gpt_distill

    repo = os.path.dirname(os.path.abspath(__file__))
    layers = GPT2S["num_layers"]
    steps = DISTILL_EPOCHS * DISTILL_STEPS
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    reserved0 = torch.cuda.memory_reserved()
    rss0 = RssSampler.rss()
    cmd = [sys.executable, "-c", "import sys, chip_smoke; "
           "sys.exit(chip_smoke.distill_teacher_child())"]
    children = [Child(cmd, repo, "distill teacher %d" % i) for i in (0, 1)]
    dr = None
    try:
        with RssSampler() as rss:
            eps = [c.wait_line("TEACHER_ENDPOINT=") for c in children]
            clients = [RpcClient(ep, timeout=CHILD_TIMEOUT) for ep in eps]
            # the probs each batch must carry: teacher 1 called directly
            # (it survives the kill); teacher 0 must give batch 0 the
            # same bits
            direct, reply_bytes, direct_s = [], 0, []
            for i in range(DISTILL_STEPS):
                t0 = time.perf_counter()
                out = clients[1].call("predict",
                                      {"input_ids": distill_ids(i)})
                direct_s.append(time.perf_counter() - t0)
                reply_bytes = sum(np.asarray(a).nbytes
                                  for a in out.values())
                direct.append(np.array(out["probs"]))
                del out
            if not bit_equal(clients[0].call(
                    "predict", {"input_ids": distill_ids(0)})["probs"],
                    direct[0]):
                raise AssertionError("distill: the two teachers' probs for "
                                     "one batch differ")

            model = Gpt(**{k: v for k, v in GPT2S.items()
                           if k != "seq_len"}, dtype=torch.bfloat16,
                        remat=True, use_flash=True, device="cuda")
            _, params, _ = gpt.create_model_and_loss(model=model)
            init = {k: v.clone() for k, v in params.items()}
            loss_fn = gpt_distill.make_loss_fn(model, DISTILL_W)

            def student(p):
                return trainer.ElasticTrainer(
                    loss_fn, p, optim.adamw(DISTILL_LR),
                    total_batch_size=DISTILL_BATCH, checkpoint_dir="",
                    device="cuda")

            def gen():
                for i in range(DISTILL_STEPS):
                    yield distill_ids(i), np.full(DISTILL_BATCH, i, np.int32)

            tr = student(params)
            dr = DistillReader(ins=["input_ids"], predicts=["probs"],
                               max_in_flight=DISTILL_IN_FLIGHT,
                               pipeline_depth=DISTILL_DEPTH,
                               teacher_backoff=1.0,
                               predict_timeout=CHILD_TIMEOUT)
            dr.set_batch_generator(gen)
            dr.set_fixed_teacher(eps)
            fa.reset_launches()
            losses, wait_ms, step_ms, kill = [], [], [], None
            t_read = time.perf_counter()
            for epoch in range(DISTILL_EPOCHS):
                order = []
                batches = dr()
                while True:
                    t0 = time.perf_counter()
                    item = next(batches, None)
                    if item is None:
                        break
                    ids, tag, probs = item
                    t1 = time.perf_counter()
                    i = int(tag[0])
                    order.append(i)
                    if not bit_equal(ids, distill_ids(i)):
                        raise AssertionError("distill: epoch %d batch %d: "
                                             "ids differ" % (epoch, i))
                    if not bit_equal(probs, direct[i]):
                        raise AssertionError(
                            "distill: epoch %d batch %d: probs differ from "
                            "the teacher's direct reply" % (epoch, i))
                    losses.append(float(tr.train_step(
                        {"input_ids": ids, "soft_label": probs})))
                    wait_ms.append((t1 - t0) * 1e3)
                    step_ms.append((time.perf_counter() - t1) * 1e3)
                    del ids, tag, probs, item
                    if (epoch == DISTILL_EPOCHS - 1
                            and len(order) == DISTILL_KILL_AT):
                        kill = {"stats": clients[0].call("stats"),
                                "after": len(order)}
                        children[0].proc.kill()
                        kill["rc"] = children[0].proc.wait(timeout=60)
                if order != list(range(DISTILL_STEPS)):
                    raise AssertionError("distill: epoch %d delivered %s"
                                         % (epoch, order))
            read_s = time.perf_counter() - t_read
            student_launches = dict(fa.flash_attention.kernel_launches)
            # remat runs each forward twice
            want = only("sm90", 2 * layers * steps,
                        **{k: layers * steps
                           for k in fa.bwd_kernel_names("sm90")})
            if student_launches != want:
                raise AssertionError("distill: the student launched %s over "
                                     "%d steps, want %s"
                                     % (student_launches, steps, want))
            dr.stop()
            dr = None

            # the replay: the same steps from the same initial state on the
            # directly fetched probs, without the reader
            fa.reset_launches()
            tr2 = student(init)
            replay, replay_ms = [], []
            for _ in range(DISTILL_EPOCHS):
                for i in range(DISTILL_STEPS):
                    t0 = time.perf_counter()
                    replay.append(float(tr2.train_step(
                        {"input_ids": distill_ids(i),
                         "soft_label": direct[i]})))
                    replay_ms.append((time.perf_counter() - t0) * 1e3)
            if dict(fa.flash_attention.kernel_launches) != want:
                raise AssertionError("distill: the replay launched %s"
                                     % fa.flash_attention.kernel_launches)
            if replay != losses:
                raise AssertionError("distill: losses %s, replay %s"
                                     % (losses, replay))
            leaves = hold_bit_equal(tr2.train_state,
                                    clone_state(tr.train_state),
                                    "distill: the replay's final state")
            control = {where: reply_traffic_steps(tr2, direct, eps[1],
                                                  where, repo)
                       for where in ("thread", "process")}
            stats = clients[1].call("stats")
            free_alive = torch.cuda.mem_get_info()[0]
            for c in clients:
                c.close()
            if children[1].finish(signal.SIGTERM) != 0:
                raise AssertionError("distill: teacher 1 exited %s:\n%s"
                                     % (children[1].proc.returncode,
                                        children[1].tail()))
            survivor = json.loads(children[1].wait_line("TEACHER_STATS="))
        if survivor["launches"] != only("sm90", layers
                                        * survivor["batches"]):
            raise AssertionError("distill: teacher 1 launched %s over %d "
                                 "device batches" % (survivor["launches"],
                                                     survivor["batches"]))
        # the trainers hold their preemption guards in reference cycles
        del tr, tr2, init, params, model, direct, loss_fn, student
        gc.collect()
        torch.cuda.empty_cache()
        free1 = torch.cuda.mem_get_info()[0]
        # what the card lacks against before the children started, less
        # what this process's allocator still holds
        lost = (free0 - free1) - (torch.cuda.memory_reserved() - reserved0)
        if lost > CHILD_MEM_SLACK:
            raise AssertionError(
                "distill: %.2f GB of the card not returned after the "
                "children exited (free %.2f GB before them, %.2f with them, "
                "%.2f after)" % (lost / 1e9, free0 / 1e9, free_alive / 1e9,
                                 free1 / 1e9))
    finally:
        if dr is not None:
            dr.stop()
        for c in children:
            c.reap()
    tokens = DISTILL_BATCH * DISTILL_SEQ
    wall = [w + s for w, s in zip(wait_ms, step_ms)]
    med = statistics.median
    log("distill: GPT-2s student b%d x s%d on 2 GPT-2s teachers, %d epochs "
        "of %d batches, teacher 0 SIGKILLed after batch %d of the last "
        "(exit %s): every batch once, in order, probs bit-equal to the "
        "direct reply; losses and final state (%d leaves) bit-equal to the "
        "replay without the reader [%s]"
        % (DISTILL_BATCH, DISTILL_SEQ, DISTILL_EPOCHS, DISTILL_STEPS,
           kill["after"], kill["rc"], leaves, gpu))
    log("distill: with the reader %.3f ms per step (median; wait %.3f + "
        "train_step %.3f), %.1f tokens/s, wait share %.3f; %.1f s for %d "
        "steps; without it (the replay) train_step %.3f ms, %.1f tokens/s "
        "[%s]" % (med(wall), med(wait_ms), med(step_ms),
                  tokens / med(wall) * 1e3, sum(wait_ms) / sum(wall),
                  read_s, steps, med(replay_ms),
                  tokens / med(replay_ms) * 1e3, gpu))
    log("distill: card memory free %.2f GB before the children, %.2f GB "
        "with them and this process's student, %.2f GB after they were "
        "reaped [%s]" % (free0 / 1e9, free_alive / 1e9, free1 / 1e9, gpu))
    log("distill: reply %d bytes (logits + probs), a direct predict %.3f s "
        "(median of %d, %.2f GB/s); host RSS %.2f GB at the phase's start, "
        "peak %.2f GB during it; "
        "teacher 0 before the kill %s; teacher 1 at the end %s (its own "
        "count: %d device batches, %d rows, occupancy %.3f, flash %s); "
        "student launches %s [%s]"
        % (reply_bytes, med(direct_s), len(direct_s),
           reply_bytes / med(direct_s) / 1e9, rss0 / 1e9, rss.peak / 1e9,
           {k: kill["stats"][k] for k in ("batches", "rows", "occupancy")},
           {k: stats[k] for k in ("batches", "rows", "occupancy")},
           survivor["batches"], survivor["rows"], survivor["occupancy"],
           survivor["launches"], student_launches, gpu))
    log("distill: losses %s; train_step ms with the reader %s, wait ms %s; "
        "replay ms %s [%s]" % (["%.4f" % x for x in losses],
                               ["%.1f" % x for x in step_ms],
                               ["%.1f" % x for x in wait_ms],
                               ["%.1f" % x for x in replay_ms], gpu))
    log("distill: control, the replay's train_step while %d clients pull "
        "the surviving teacher's replies in threads of this process: %s ms "
        "(%d replies meanwhile); in other processes: %s ms (%d) [%s]"
        % (DISTILL_PULLERS, ["%.1f" % x for x in control["thread"][0]],
           control["thread"][1],
           ["%.1f" % x for x in control["process"][0]],
           control["process"][1], gpu))
    return {"distill_student": student_launches,
            "distill_teacher": survivor["launches"]}


def distill_examples_phase(gpu):
    """Phase 9: the port's three distill examples as subprocesses at their
    defaults against the port's teacher CLI (or, for mnist_distill, its
    own in-process teacher), gpt_distill SIGTERMed mid-epoch, then
    distill_bench (gpt on the card) and distill_qps in this process.
    Returns the flash launches by path."""
    from edl_tpu_torch.examples.distill import gpt_distill, resnet_distill
    from edl_tpu_torch.tools import distill_bench, distill_qps

    repo = os.path.dirname(os.path.abspath(__file__))
    teacher = "edl_tpu_torch.distill.teacher_server"
    ex = "edl_tpu_torch.examples.distill."
    by_path, children = {}, []

    def start(name, cmd):
        child = Child(cmd, repo, name)
        children.append(child)
        return child

    def final_json(child):
        rc = child.finish(timeout=EXAMPLE_TIMEOUT)
        if rc != 0:
            raise AssertionError("%s exited %s; stdout %s; stderr:\n%s"
                                 % (child.name, rc, child.lines[-5:],
                                    child.tail()))
        return json.loads(next(ln for ln in reversed(child.lines)
                               if ln.startswith("{")))

    t0 = time.monotonic()
    try:
        gpt_t = start("gpt teacher", counted(teacher, *GPT_TEACHER_ARGS))
        res_t = start("resnet teacher", counted(teacher,
                                                *RESNET_TEACHER_ARGS))
        mnist = start("mnist_distill", counted(ex + "mnist_distill"))
        gpt_ep = gpt_t.wait_line("TEACHER_ENDPOINT=")
        res_ep = res_t.wait_line("TEACHER_ENDPOINT=")
        gpt_s = start("gpt_distill", counted(ex + "gpt_distill",
                                             "--teachers", gpt_ep))
        res_s = start("resnet_distill", counted(ex + "resnet_distill",
                                                "--teachers", res_ep))
        gpt_out, res_out = final_json(gpt_s), final_json(res_s)
        by_path["example_gpt_distill"] = child_launches(gpt_s)
        by_path["example_resnet_distill"] = child_launches(res_s)
        # the same student, SIGTERMed mid-epoch: exit 101
        term = start("gpt_distill (SIGTERM)", counted(
            ex + "gpt_distill", "--teachers", gpt_ep, "--steps_per_epoch",
            str(GPT_SIGTERM_STEPS), "--fetch_steps", "1"))
        term.wait_line(GPT_SIGTERM_AFTER, timeout=EXAMPLE_TIMEOUT)
        term_rc = term.finish(signal.SIGTERM, timeout=EXAMPLE_TIMEOUT)
        term_steps = sum(1 for ln in term.lines if ln.startswith("epoch 0 "
                                                                 "step "))
        if term_rc != 101 or not any(ln.startswith("preempted:")
                                     for ln in term.lines):
            raise AssertionError("gpt_distill under SIGTERM exited %s: %s\n"
                                 "%s" % (term_rc, term.lines[-5:],
                                         term.tail()))
        by_path["example_gpt_distill_sigterm"] = child_launches(term)
        mnist_out = final_json(mnist)
        by_path["example_mnist_distill"] = child_launches(mnist)
        for child, path in ((gpt_t, "example_gpt_teacher"),
                            (res_t, "example_resnet_teacher")):
            if child.finish(signal.SIGTERM) != 0:
                raise AssertionError("%s exited %s:\n%s"
                                     % (child.name, child.proc.returncode,
                                        child.tail()))
            by_path[path] = child_launches(child)
    finally:
        for child in children:
            child.reap()
    examples_s = time.monotonic() - t0
    # gpt_distill's student and the gpt teacher CLI: 2 layers, d 64 over 4
    # heads (head_dim 16), seq 16; the student in f32, the teacher in bf16
    ex_args = gpt_distill.parse_args([])

    def student(steps):
        return lm_step_launches(torch.float32, EX_HEAD_DIM, ex_args.seq_len,
                                EX_LAYERS, steps)

    want = student(ex_args.steps_per_epoch * ex_args.epochs)
    if by_path["example_gpt_distill"] != want:
        raise AssertionError("gpt_distill launched %s, want %s"
                             % (by_path["example_gpt_distill"], want))
    # the step that sees the signal runs, then raises before it prints
    if by_path["example_gpt_distill_sigterm"] not in (
            student(term_steps), student(term_steps + 1)):
        raise AssertionError("gpt_distill under SIGTERM launched %s after "
                             "%d printed steps" % (
                                 by_path["example_gpt_distill_sigterm"],
                                 term_steps))
    teacher_kernel = fa.kernel_for(torch.bfloat16, EX_HEAD_DIM)
    if not forward_only(by_path["example_gpt_teacher"], teacher_kernel,
                        EX_LAYERS):
        raise AssertionError("the gpt teacher CLI launched %s"
                             % by_path["example_gpt_teacher"])
    for path in ("example_resnet_distill", "example_resnet_teacher",
                 "example_mnist_distill"):
        if any(by_path[path].values()):
            raise AssertionError("%s launched flash kernels: %s"
                                 % (path, by_path[path]))
    res_args = resnet_distill.parse_args([])
    for out, args, what in ((gpt_out, ex_args, "gpt_distill"),
                            (res_out, res_args, "resnet_distill")):
        if (out["steps"] != args.steps_per_epoch * args.epochs
                or not np.isfinite(out["final_loss"])):
            raise AssertionError("%s: %s" % (what, out))
    if not (mnist_out["teacher_acc"] > MNIST_TEACHER_ACC
            and mnist_out["student_acc"] > MNIST_STUDENT_ACC
            and mnist_out["steps"] == MNIST_STEPS
            and mnist_out["final_loss"] < MNIST_LOSS):
        raise AssertionError("mnist_distill misses its rule: %s" % mnist_out)
    log("distill examples: gpt_distill %s, resnet_distill %s, mnist_distill "
        "%s (rule: teacher > %g, student > %g, %d steps, loss < %g); "
        "gpt_distill SIGTERMed after %d printed steps -> exit 101; "
        "subprocesses %.1f s in all [%s]"
        % (json.dumps(gpt_out), json.dumps(res_out), json.dumps(mnist_out),
           MNIST_TEACHER_ACC, MNIST_STUDENT_ACC, MNIST_STEPS, MNIST_LOSS,
           term_steps, examples_s, gpu))
    log("distill examples: flash launches %s [%s]"
        % (json.dumps(by_path), gpu))

    fa.reset_launches()
    bench_out = distill_bench.run(model="gpt", device="cuda")
    by_path["distill_bench_gpt"] = dict(fa.flash_attention.kernel_launches)
    if not bench_out["identical_ok"]:
        raise AssertionError("distill_bench: serial and pipelined "
                             "predictions differ: %s" % bench_out)
    # distill_bench's gpt_teacher: the same widths, seq 32
    if not forward_only(by_path["distill_bench_gpt"], teacher_kernel,
                        EX_LAYERS):
        raise AssertionError("distill_bench launched %s"
                             % by_path["distill_bench_gpt"])
    qps = distill_qps.run()
    if qps["batches"] != 100 or not qps["samples_per_sec"] > 0:
        raise AssertionError("distill_qps: %s" % qps)
    log("distill examples: distill_bench %s [%s]" % (json.dumps(bench_out),
                                                     gpu))
    log("distill examples: distill_qps %s [%s]" % (json.dumps(qps), gpu))
    return by_path


def serve_bench_phase(gpu):
    """Phase 10: tools/serve_bench's micro serve arc and decode arc, the
    decode arc's models and KV caches on the card. Returns the flash
    launches of both."""
    from edl_tpu_torch.robustness import faults
    from edl_tpu_torch.serve.admission import DECODE_SHED_REASONS
    from edl_tpu_torch.tools import serve_bench

    by_path = {}
    workers = os.environ.get("EDL_TPU_RPC_WORKERS")
    fa.reset_launches()
    out = serve_bench.run("micro", seed=SERVE_SEED)
    by_path["serve_bench"] = dict(fa.flash_attention.kernel_launches)
    # tests/test_bench_guard.py's test_serve_bench_micro_schema
    gates = {
        "sent and served": out["sent"] > 0 and out["ok"] > 0,
        "typed sheds only": (out["shed"]["total"] > 0
                             and out["shed"]["with_retry_after_hint"] > 0
                             and sum(out["shed"]["by_reason"].values())
                             == out["shed"]["total"]
                             and out["timeouts"] == 0
                             and out["untyped_errors"] == 0),
        "zero stranded": (out["stranded"] == 0
                          and out["drain"]["zero_stranded"] is True),
        "scale-out and scale-in": (out["scaler"]["scale_out"] >= 1
                                   and out["scaler"]["scale_in"] >= 1),
        "drain fault fired": out["faults_fired"].get("serve.drain", 0) >= 1,
        "dry-replay parity": (out["dry_parity_ok"] is True
                              and out["live_action_stream"]
                              == out["dry_action_stream"]),
        "stats under overload": (out["stats_rpc_ms"]["p99"] is not None
                                 and out["stats_rpc_ms"]["p99"]
                                 < out["latency_ms"]["p99"]),
        "environment and fault plane restored": (
            os.environ.get("EDL_TPU_RPC_WORKERS") == workers
            and faults.PLANE is None),
        "no flash kernel": not any(by_path["serve_bench"].values()),
    }
    failed = [k for k, ok in gates.items() if not ok]
    log("serve_bench: run('micro'): sent %d, ok %d, goodput %s rps, shed %s "
        "(%s), stranded %d, scaler %d out / %d in, latency %s ms, stats RPC "
        "%s ms, wall %.1f s; gates failed: %s [%s]"
        % (out["sent"], out["ok"], out["goodput_rps"], out["shed"]["total"],
           out["shed"]["by_reason"], out["stranded"],
           out["scaler"]["scale_out"], out["scaler"]["scale_in"],
           out["latency_ms"], out["stats_rpc_ms"], out["wall_s"], failed,
           gpu))
    if failed:
        raise AssertionError("serve_bench run('micro') fails %s: %s"
                             % (failed, json.dumps(out)))

    fa.reset_launches()
    dec = serve_bench.run_decode("micro", seed=SERVE_SEED, device="cuda")
    by_path["serve_decode"] = dict(fa.flash_attention.kernel_launches)
    par, sc, pfx, ch = (dec["parity"], dec["scale_out"], dec["prefix"],
                        dec["chunked"])
    gates = {
        "serial tokens == generate": par["serial_vs_generate_ok"],
        "batched tokens == generate": par["cb_vs_generate_ok"],
        "int8 tokens == generate": par["int8_tokens_match"],
        "int8 logits": dec["quant"]["int8_logits_rel_err"] < INT8_BENCH_REL,
        "int8 bytes": dec["quant"]["int8_bytes_ratio"] < INT8_BENCH_BYTES,
        "one step shape": dec["compile"]["step_traces"] == 1,
        "every shed reason": (dec["shed"]["reasons_covered"]
                              == sorted(DECODE_SHED_REASONS)),
        "shed arcs strand none": dec["shed"]["stranded"] == 0,
        "journaled scale-out, none stranded": (
            sc["scale_out"] >= 1 and sc["journaled"] >= 1
            and sc["zero_stranded"]),
        "prefix parity": pfx["parity_ok"],
        "prefix accounting exact": pfx["accounting_exact"],
        "chunked: no monolithic prefill": ch["prefill_traces"] == 0,
        "chunked: one step shape": ch["step_traces"] == 1,
        "ffma alone": by_path["serve_decode"] == only(
            "ffma", by_path["serve_decode"]["ffma"]),
    }
    failed = [k for k, ok in gates.items() if not ok]
    log("serve_bench: run_decode('micro') on the card: tokens/s serial %s, "
        "batched %s, throughput.speedup %s (reference gate 1.5); "
        "prefix.ttft_speedup %s (cold %s / reuse %s ms; gate 1.5); chunked "
        "ITL p99 %s vs allowance 2 x %s (within: %s), monolithic %s "
        "(exceeds: %s); TTFT %s; int8 %s; shed %s; scale-out %s; flash %s; "
        "wall %.1f s; _decode_healthy: %s; gates failed: %s [%s]"
        % (dec["throughput"]["serial_tokens_per_s"],
           dec["throughput"]["cb_tokens_per_s"],
           dec["throughput"]["speedup"], pfx["ttft_speedup"],
           pfx["cold_ttft_ms_p50"], pfx["reuse_ttft_ms_p50"],
           ch["chunked_itl_p99"], ch["baseline_itl_allowance"],
           ch["chunked_within_2x"], ch["monolithic_itl_p99"],
           ch["monolithic_exceeds_2x"], dec["latency_ms"], dec["quant"],
           dec["shed"]["by_reason"], sc, by_path["serve_decode"],
           dec["wall_s"], serve_bench._decode_healthy(dec), failed, gpu))
    log("serve_bench: decode_bench %s [%s]" % (json.dumps(dec), gpu))
    if failed:
        raise AssertionError("serve_bench run_decode('micro') fails %s"
                             % failed)
    return by_path


def run_phase(name, fn, *args):
    """``fn(*args)``, its wall seconds logged."""
    t0 = time.monotonic()
    out = fn(*args)
    log("phase %s: %.1f s" % (name, time.monotonic() - t0))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    gpu = card()
    log("device: %s [%s]" % (torch.cuda.get_device_name(0), gpu))
    t0 = time.monotonic()
    run_phase("build", build, gpu)
    kernel_rows = run_phase("kernels", kernel_phase, gpu)
    bwd_rows = run_phase("backward", bwd_phase, gpu)
    by_path = {"predict": run_phase("slice", slice_phase, gpu)}
    for name, fn in (("decode", decode_phase), ("train", train_phase),
                     ("resnet", resnet_phase), ("elastic", elastic_phase),
                     ("distill", distill_phase),
                     ("distill examples", distill_examples_phase),
                     ("serve_bench", serve_bench_phase)):
        by_path.update(run_phase(name, fn, gpu))
    log("all phases: %.1f s" % (time.monotonic() - t0))
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
