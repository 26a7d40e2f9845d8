"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: compile every CUDA kernel of the port from the sources in
   this checkout, one nvcc per source, side by side;
2. kernels: hold each kernel against its plain PyTorch version on the
   card at the shapes the serving path gives it (and in the regimes of
   the TPU kernels it replaces), and time kernel, plain version, and
   one PyTorch library call of the same function as a yardstick. The
   flash forward has two kernels: ``sm90`` (wgmma, bf16 at head_dim 64
   and 128, the served path) and ``ffma`` (f32 and the other head
   dims); both are held and timed, ``ffma`` also at the served bf16
   shape, for the comparison;
3. slice: start the port's full-width GPT-2s ``gpt_teacher`` on the
   card, send ``predict`` requests through the port's ``RpcClient``
   (some concurrent), check the replies, check that every layer's
   attention went through the ``sm90`` kernel and none through
   ``ffma``, and check the served logits against the same model run
   with dense attention;
4. decode: start the port's full-width GPT-2s ``lm_teacher`` (f32,
   8 KV slots) on the card and drive its decode plane through the
   ``RpcClient``: 10 concurrent ``lm_generate`` calls (two wait for a
   slot), three prompts sharing a 256-token prefix (one streamed by
   ``lm_submit`` + ``lm_poll``), one ``predict``. Every sequence must
   decode to the tokens of the port's ``generate`` on the same weights
   with dense attention (a mismatch only where the reference's top-2
   logit gap is below the measured logits error between the two
   paths), with one step shape, 12 ``ffma`` launches per monolithic
   prefill and none elsewhere, exact prefix-reuse accounting; a second
   engine with chunked prefill must decode two prompts to the same
   tokens, and an int8 ``lm_teacher`` must pass the JAX package's
   quantized gate. Then a closed-loop load of 250 requests from 10
   concurrent clients at the same mix gives TTFT and ITL percentiles
   and tokens/s. Prints those, KV bytes, peak memory and a profile of
   one decode step.

Prints a ``kernels`` JSON line (launches by path), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when CUDA is unavailable.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from edl_tpu_torch.distill.teacher_server import (INIT_SEED, gpt_teacher,
                                                  lm_teacher)
from edl_tpu_torch.models import gpt
from edl_tpu_torch.models.gpt import Gpt
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.serve.admission import AdmissionController
from edl_tpu_torch.serve.decode_engine import DecodeEngine, _prefill_bucket

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

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
# served logits (flash) vs the same model with dense attention: the dense
# path rounds q * scale to bf16 before its f32 upcast, flash scales after
# it, and the difference passes through 12 bf16 layers. Allowed: four
# bf16 ulps at |logits| < 8 (4 * 2**-5); the run checks the magnitude.
SERVE_TOL = 4 * 2.0 ** -5


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
    for name, (path, secs, text) in fa.build().items():
        log("build: %s %s in %.1fs [%s]" % (name, os.path.basename(path),
                                             secs, gpu))
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
    log("build: both kernels in %.1fs of wall time" % (time.monotonic() - t0))


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


def flash_bound_ms(b, h, s, sk, d, dtype, causal):
    """Least time for the function: q, k, v read once, o written once,
    over the memory rate; or the operations these inputs need (two
    products, 2 flops per multiply-add; under causal, row i meets
    min(i + 1, sk) keys) over the peak rate for the input type."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * (2 * s * d + 2 * sk * d) * item
    keys = sum(min(i + 1, sk) for i in range(s)) if causal else s * sk
    flops = 4 * d * keys * b * h
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_inputs(b, h, s, sk, d, dtype, gen, device="cuda"):
    """q [b, h, s, d] and k, v [b, h, sk, d] on ``device`` (the card),
    from ``gen``."""
    mk = lambda n, std: (torch.randn((b, h, n, d), generator=gen,
                                     device=device) * std).to(dtype)
    return mk(s, Q_STD), mk(sk, 1.0), mk(sk, 1.0)


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


def kernel_phase(gpu):
    """Phase 2: both flash kernels vs their plain version, timed. A case
    names its kernel: None for the one ``kernel_for`` picks, the way the
    served path launches it, or "ffma" to run flash_fwd.cu on a shape
    that the served path sends to sm90."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # (b, h, s, sk, d, dtype, causal, what, kernel)
        (MAX_BATCH, 12, 1024, 1024, 64, torch.bfloat16, True, "slice"),
        (MAX_BATCH, 12, 1024, 1024, 64, torch.bfloat16, False, "slice"),
        (MAX_BATCH, 12, 1024, 1024, 64, torch.float32, True, "f32"),
        (MAX_BATCH, 12, 1024, 1024, 64, torch.bfloat16, True, "slice",
         "ffma"),
        (MAX_BATCH, 6, 1024, 1024, 128, torch.bfloat16, True, "d128"),
        (MAX_BATCH, 6, 1024, 1024, 128, torch.bfloat16, False, "d128"),
        (MAX_BATCH, 12, 1000, 1000, 64, torch.bfloat16, True, "ragged sk"),
        (MAX_BATCH, 12, 1000, 1000, 64, torch.bfloat16, False, "ragged sk"),
        (MAX_BATCH, 12, 100, 1000, 64, torch.bfloat16, False, "sk != s"),
        (MAX_BATCH, 12, 100, 1000, 64, torch.bfloat16, True, "sk != s"),
        # 40 of the one kv tile's 64 rows lie beyond sk: the ragged mask
        # decides the output
        (MAX_BATCH, 12, 1024, 24, 64, torch.bfloat16, False, "short sk"),
        (1, 2, 16640, 16640, 64, torch.bfloat16, True, "K+V > 4 MiB"),
    ]
    # lm_teacher's monolithic prefills: b1 h12 d64 f32 causal at every
    # power-of-two prompt bucket that the decode phase sends
    cases += [(1, 12, s, s, 64, torch.float32, True, "lm prefill")
              for s in lm_buckets()]
    results = []
    for b, h, s, sk, d, dtype, causal, what, *forced in cases:
        kernel = forced[0] if forced else fa.kernel_for(dtype, d)
        q, k, v = flash_inputs(b, h, s, sk, d, dtype, gen)
        if forced:
            run = lambda: fa._launch(q, k, v, causal, d ** -0.5, kernel)
        else:
            run = lambda: fa.flash_attention(q, k, v, causal)
        out = run()
        torch.cuda.synchronize()
        ref = fa.blockwise_reference(q, k, v, causal, d ** -0.5)
        err = check_flash(out, ref, dtype,
                          (kernel, b, h, s, sk, d, dtype, causal))
        mean_ref = ref.float().abs().mean().item()
        reps = 20 if s <= 1024 else 5
        ms = time_ms(run, flush, reps)
        plain_ms = time_ms(lambda: fa.blockwise_reference(
            q, k, v, causal, d ** -0.5), flush, max(3, reps // 4))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal), flush, reps)
        bound_ms, bound_by = flash_bound_ms(b, h, s, sk, d, dtype, causal)
        row = dict(kernel=kernel, shape=[b, h, s, sk, d],
                   dtype=str(dtype).split(".")[-1],
                   causal=causal, what=what, max_abs_err=err,
                   mean_abs_out=mean_ref, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        log("kernel flash_fwd %s b=%d h=%d s=%d sk=%d d=%d %s %s (%s): "
            "max_abs_err %.3g (tol %g + %g |ref|; mean |ref| %.3g); kernel "
            "%.4f ms, plain %.4f ms, sdpa %.4f ms, bound %.2f us (%s) [%s]"
            % (kernel, b, h, s, sk, d, row["dtype"],
               "causal" if causal else "full",
               what, err, *KERNEL_TOL[dtype], mean_ref, ms, plain_ms,
               library_ms, bound_ms * 1e3, bound_by, gpu))
        results.append(row)
    del flush
    return results


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
    if batches < 1 or launches["sm90"] != 12 * batches \
            or launches["ffma"] != 0 or total != 12 * batches:
        raise AssertionError("flash launches %s (total %d) are not 12 sm90 "
                             "and 0 ffma x %d device batches"
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
        "launches sm90 %d, ffma %d (12 sm90 per batch); latency per "
        "request %s s; %.1f tokens/s; wall %.3fs [%s]"
        % (len(replies), rows, batches, launches["sm90"], launches["ffma"],
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


def load_prompts():
    """The load's prompts: seeded numpy ids, lengths uniform over
    LM_LENGTHS' range. Each first token (1000 + i) is its own, so every
    request is a cold, monolithic prefill, as in the concurrent wave."""
    rng = np.random.RandomState(SEED + 3)
    lengths = rng.randint(LM_LENGTHS[0], LM_LENGTHS[-1] + 1, LM_LOAD)
    prompts = [rng.randint(0, LM["vocab_size"], n).tolist()
               for n in lengths]
    for i, p in enumerate(prompts):
        p[0] = 1000 + i
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
    finally:
        client.close()
        server.stop()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    prompts = wave + tails
    pfx, pfx0 = stats["decode_prefix"], before["decode_prefix"]
    cold = pfx["misses"] - pfx0["misses"]
    hits = pfx["hits"] - pfx0["hits"]
    reused = pfx["reuse_tokens"] - pfx0["reuse_tokens"]
    log("decode: %d sequences of %d new tokens; flash launches ffma %d, "
        "sm90 %d for %d monolithic prefills (%d ffma each); prefix hits "
        "%d, reuse_tokens %d; step shapes %d; %d polls streamed seq %d "
        "[%s]" % (len(prompts), LM_NEW, by_path["decode"]["ffma"],
                  by_path["decode"]["sm90"], cold, layers, hits, reused,
                  stats["decode_step_traces"], polls, seq, gpu))
    if cold != len(wave) + 1 or by_path["decode"] != {
            "ffma": layers * cold, "sm90": 0}:
        raise AssertionError("decode flash launches %s for %d monolithic "
                             "prefills: want %d ffma each, 0 sm90, and %d "
                             "prefills" % (by_path["decode"], cold, layers,
                                           len(wave) + 1))
    if hits != 2 or reused != 2 * LM_SHARED:
        raise AssertionError("prefix hits %d reuse_tokens %d, want 2 and %d"
                             % (hits, reused, 2 * LM_SHARED))
    if stats["decode_step_traces"] != 1:
        raise AssertionError("decode step ran at %d shapes"
                             % stats["decode_step_traces"])
    if by_path["lm_predict"] != {"ffma": layers, "sm90": 0}:
        raise AssertionError("lm predict launches %s"
                             % by_path["lm_predict"])
    logits = f32_reply["logits"]
    if logits.shape != (1, max_len, vocab) or not np.isfinite(logits).all():
        raise AssertionError("lm predict logits %s" % (logits.shape,))
    log("decode: the concurrent wave of %d requests (%d tokens) took "
        "%.3fs [%s]" % (len(wave), len(wave) * LM_NEW, wave_s, gpu))

    # serving metrics: TTFT and ITL of the closed-loop load, by request
    load_cold = after["decode_prefix"]["misses"] - pfx["misses"]
    load_hits = after["decode_prefix"]["hits"] - pfx["hits"]
    if load_cold != LM_LOAD or load_hits or by_path["decode_load"] != {
            "ffma": layers * LM_LOAD, "sm90": 0} or \
            after["decode_step_traces"] != 1:
        raise AssertionError("load: %d cold prefills, %d prefix hits, "
                             "launches %s, step shapes %d; want %d cold, "
                             "%d ffma, one step shape"
                             % (load_cold, load_hits, by_path["decode_load"],
                                after["decode_step_traces"], LM_LOAD,
                                layers * LM_LOAD))
    ttft = [r["ttft_ms"] for r in load]
    itl = [x for r in load for x in r["itl_ms"]]
    steps = after["decode_steps_total"] - stats["decode_steps_total"]
    log("decode: closed-loop load, %d requests from %d clients (prompts "
        "%d-%d, %d new tokens each): TTFT p50 %.2f ms, p90 %.2f ms, p99 "
        "%.2f ms over %d requests; ITL p50 %.2f ms, p90 %.2f ms, p99 %.2f "
        "ms over %d intervals; %.1f decode tokens/s (%d generated in "
        "%.3fs; %d fused steps, %.2f live slots per step); the engine's "
        "step EWMA at the end %.2f ms [%s]"
        % (LM_LOAD, LM_LOAD_CLIENTS, LM_LENGTHS[0], LM_LENGTHS[-1], LM_NEW,
           pct(ttft, 50), pct(ttft, 90), pct(ttft, 99), len(ttft),
           pct(itl, 50), pct(itl, 90), pct(itl, 99), len(itl),
           LM_LOAD * LM_NEW / load_s, LM_LOAD * LM_NEW, load_s, steps,
           LM_LOAD * (LM_NEW - 1) / max(steps, 1),
           after["decode_admission"]["itl_ms"], gpu))
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
    if by_path["chunked"] != {"ffma": 0, "sm90": 0} or \
            cstats["decode_step_traces"] != 1:
        raise AssertionError("chunked engine: launches %s, step shapes %d"
                             % (by_path["chunked"],
                                cstats["decode_step_traces"]))
    log("decode: chunked engine (prefill_chunk 256) decoded prompts %s: "
        "flash launches %s, chunk shapes %d [%s]"
        % ([len(wave[i]) for i in picks], by_path["chunked"],
           cstats["decode_chunk_traces"], gpu))

    decode_step_profile(engine, "f32 decode step", gpu)
    fa.reset_launches()
    prefill_profile(engine, wave[-1], gpu)
    if fa.flash_attention.kernel_launches["ffma"] != 5 * layers:
        raise AssertionError("the profiled prefills launched %s"
                             % fa.flash_attention.kernel_launches)
    int8_gate(feed, logits, gpu)
    return by_path


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


def log_profile(fn, what, gpu, top=8):
    """torch.profiler over one call of ``fn``: device time by kernel and
    the host's aten op calls (nested calls included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    ops = sum(e.count for e in averages if e.key.startswith("aten::"))
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA
               and e.self_device_time_total]
    total_us = sum(e.self_device_time_total for e in kernels)
    if not total_us:
        log("%s: torch.profiler recorded no device time (%d aten op calls "
            "on the host)" % (what, ops))
        return
    log("%s: profiled device time %.3f ms in %d kernel launches; %d aten "
        "op calls on the host [%s]" % (what, total_us / 1e3,
                                       sum(e.count for e in kernels), ops,
                                       gpu))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log("  %8.3f ms x%-4d %s" % (e.self_device_time_total / 1e3,
                                      e.count, e.key[:90]))


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


def prefill_profile(engine, prompt, gpu):
    """Where a time-to-first-token goes: one monolithic prefill of
    ``prompt`` (its power-of-two bucket, flash) and one suffix chunk of
    up to 128 tokens at the shared prefix's end (dense, as after a
    prefix hit), each into slot 0 of the idle engine (median of 3);
    then the prefill's device time by kernel."""
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

    for what, fn in (("prefill %d (bucket %d)" % (len(prompt), bucket),
                      prefill),
                     ("suffix chunk %d at %d" % (width, off), suffix)):
        device_ms, host_ms = time_calls(fn, 3)
        log("ttft: %s: %.3f ms by CUDA events, %.3f ms host (median of 3) "
            "[%s]" % (what, device_ms, host_ms, gpu))
    log_profile(prefill, "ttft: the prefill", gpu, top=6)


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
    by_path = {"predict": slice_phase(gpu)}
    by_path.update(decode_phase(gpu))
    repo = os.path.dirname(os.path.abspath(__file__))
    # each kernel's numbers at its main path's shape: sm90 at the served
    # predict (bf16 causal, b4); ffma at lm_teacher's longest prefill
    main_case = {"sm90": ("slice", 1024), "ffma": ("lm prefill", 1024)}
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
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shapes": [r for r in kernel_rows if r["kernel"] == name],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
