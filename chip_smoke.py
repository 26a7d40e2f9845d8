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
   with dense attention.

Prints a ``kernels`` JSON line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when CUDA is unavailable.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from edl_tpu_torch.distill.teacher_server import INIT_SEED, gpt_teacher
from edl_tpu_torch.models.gpt import Gpt
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.rpc.client import RpcClient
from edl_tpu_torch.serve.admission import AdmissionController

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# GPT-2 small at a 32000 vocab: edl_tpu_torch Gpt()'s defaults, served as
# gpt_teacher builds it (bf16 activations over f32 params)
GPT2S = dict(num_layers=12, d_model=768, num_heads=12, mlp_dim=3072,
             vocab_size=32000, seq_len=1024)
MAX_BATCH = 4
SEED = 0

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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    gpu = card()
    log("device: %s [%s]" % (torch.cuda.get_device_name(0), gpu))
    build(gpu)
    kernel_rows = kernel_phase(gpu)
    launches = slice_phase(gpu)
    repo = os.path.dirname(os.path.abspath(__file__))
    kernels = []
    for name, source in fa.SOURCES.items():
        # each kernel's numbers at the served shape (bf16 causal, d 64):
        # the first case that ran it there
        row = next(r for r in kernel_rows if r["kernel"] == name
                   and r["what"] == "slice" and r["causal"])
        kernels.append({
            "name": "flash_fwd_" + name, "route": "cuda",
            "source": os.path.relpath(source, repo),
            "replaces": "edl_tpu/ops/flash_attention.py:82",
            "replaces_also": "edl_tpu/ops/flash_attention.py:30",
            "launches": launches[name],
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
