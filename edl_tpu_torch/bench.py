"""Training-throughput bench of the port: ``bench.py``'s ResNet50_vd loop
(``--model resnet``, the default) and its LM loop (``--model gpt|bert``)
on one CUDA card.

    python -m edl_tpu_torch.bench                       # ResNet50_vd
    python -m edl_tpu_torch.bench --feed host           # host-fed
    python -m edl_tpu_torch.bench --model gpt --flash
    python -m edl_tpu_torch.bench --model bert --flash [--no-remat]

Prints ONE JSON line, the JAX bench's: ``{"metric", "value", "unit",
"vs_baseline"}`` with its metric names and suffixes. ResNet:
``resnet50_vd_train_imgs_per_sec_per_chip[_suspect][_hostfed][_scanK]
[_bnK][_bN][_slowstep]``, unit ``img/s/chip``, ``vs_baseline`` = img/s
over 228.5, the reference's published per-GPU figure (1828 img/s on 8
V100s). LM: ``gpt2s_train_tokens_per_sec_per_chip[_seqN][_bN]
[_noremat][_flash][_slowstep][_suspect]``, unit ``tok/s/chip``,
vs_baseline 0.0 (the reference published no LM number). Before it, on
stderr, the step time, the implied TFLOP/s and the MFU against the
H100's 989 TFLOP/s bf16 dense peak.

What it keeps of the JAX bench: bf16 activations over f32 params (and
f32 BN statistics), ResNet50_vd at 224 with ``sgd(0.1, momentum=0.9)``
and the space-to-depth stem by default, ``--steps_per_call`` (K steps
per call, ``make_multi_step``), ``--bn_stats_every`` with its floor of
16 on the statistics batch, the feeds ``device`` (random images staged
on the device once) and ``host`` (``synthetic_pipeline`` through
``DevicePrefetcher``, cast to bf16 on the host), ``adamw(1e-4)`` and
random ids for the LM loop, the guarded timed loop (a slow step becomes
a measurement, not a hang) and the ``_suspect`` gate at 1.25x the peak.
What it changes: one card and no mesh (the mesh comes with ROADMAP
A12), CUDA events in place of ``block_until_ready``, no retry
subprocesses or CPU fallback (without a card it raises), the H100's
peak in place of v5e's 197 TFLOP/s, and ResNet's FLOP count: 2 per
multiply-add of the convs and the dense head as the port runs them
(``resnet_flops_per_image``, the s2d stem's zero taps included), times 3
for a training step, in place of the v5e XLA cost model's 25 GFLOP per
image. ``--feed native`` (the C++ JPEG loader) is not ported (ROADMAP
A18). ``flash=False`` is dense attention, as in JAX; ``--flash`` runs
the CUDA flash kernels forward and backward (off CUDA it is ignored, as
the JAX bench ignores it off the TPU).
"""

import argparse
import json
import os
import sys
import time

import torch

from edl_tpu_torch.runtime import optim
from edl_tpu_torch.runtime.trainer import make_train_state, make_train_step
from edl_tpu_torch.utils.device import resolve_device

#: the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
#: the reference's headline: ResNet50_vd at 1828 img/s on 8 V100s
BASELINE_IMGS_PER_SEC_PER_CHIP = 1828.0 / 8.0

# per-model CLI defaults, used both to fill unset args and to name
# non-default configurations in the metric
MODEL_DEFAULT_BATCH = {"gpt": 8, "bert": 32, "resnet": 128}
MODEL_DEFAULT_SEQ = {"gpt": 1024, "bert": 512}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _stopwatch(device):
    """Start a clock on ``device``; the returned function stops it and
    gives seconds: CUDA events on a card (after a synchronize of the
    end event), the host clock elsewhere."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        start.record()

        def stop():
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return stop
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


def _block(x):
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x


def _guarded_timed_loop(dispatch, iters, device):
    """The timed measurement loop, with the JAX bench's slow-step guard:
    time one blocked dispatch, size the loop to what fits the loop budget
    (``BENCH_LOOP_BUDGET`` seconds, default 150), then run it queued.

    ``dispatch`` issues one step and returns a value to block on.
    Returns (iters, seconds, slowstep): the iters actually measured, the
    loop's time, and whether the sample is a pathology report (a probe
    alone, or a loop whose measured rate would blow the budget at the
    requested length)."""
    stop = _stopwatch(device)
    _block(dispatch())
    probe_s = stop()
    loop_budget_s = float(os.environ.get("BENCH_LOOP_BUDGET", "150"))
    requested_iters = iters
    truncated = probe_s * iters > loop_budget_s
    if truncated:
        slow_iters = int(loop_budget_s / probe_s)
        log("probe dispatch took %.2fs — %d iters would blow the %.0fs "
            "loop budget; %s"
            % (probe_s, iters, loop_budget_s,
               "reporting the probe step as the measurement"
               if slow_iters < 2
               else "measuring %d iters instead" % slow_iters))
        if slow_iters < 2:
            return 1, probe_s, True
        iters = slow_iters
    stop = _stopwatch(device)
    out = None
    for _ in range(iters):
        out = dispatch()
    _block(out)
    dt = stop()
    slowstep = truncated and (dt / iters) * requested_iters > loop_budget_s
    return iters, dt, slowstep


def run(batch_per_chip=128, image_size=224, warmup=3, iters=20, s2d=True,
        feed="device", steps_per_call=1, bn_stats_every=1, device=None,
        stats=None):
    """ResNet50_vd training throughput (img/s on one card): the JAX
    bench's ``run``. ``feed``: "device" stages one random bf16 batch on
    the device once (the compute rate); "host" pulls
    ``synthetic_pipeline`` batches through ``DevicePrefetcher`` every
    step, cast to bf16 on the host (the rate a real loop sees); "native"
    is not ported. ``stats``, if a dict, receives step ms, img/s, losses,
    FLOPs per image, implied TFLOP/s, MFU, peak memory, the prefetcher's
    ``stats()`` (host feed) and ``dispatch``, a function that runs one
    more call of the same state (for a profile)."""
    from edl_tpu_torch.models import resnet
    from edl_tpu_torch.runtime.trainer import make_multi_step

    if feed == "native":
        raise NotImplementedError(
            "--feed native (the C++ JPEG loader on real images) is not "
            "ported to edl_tpu_torch (ROADMAP A18)")
    if feed not in ("device", "host"):
        raise ValueError("feed must be device or host, got %r" % feed)
    if feed != "device" and steps_per_call > 1:
        raise ValueError("steps_per_call measures the pure device rate and "
                         "skips the per-step feed; use it with feed=device")
    device = resolve_device(device)
    log("bench: 1 card (%s), batch %d, image %d, s2d=%s, feed=%s, "
        "steps_per_call=%d, bn_stats_every=%d"
        % (torch.cuda.get_device_name(device) if device.type == "cuda"
           else device.type, batch_per_chip, image_size, s2d, feed,
           steps_per_call, bn_stats_every))
    model_kw = dict(depth=50, num_classes=1000, vd=True,
                    space_to_depth=s2d, bn_stats_every=bn_stats_every)
    model, params, extra, loss_fn = resnet.create_model_and_loss(
        dtype=torch.bfloat16, device=device, **model_kw)
    tx = optim.sgd(0.1, momentum=0.9)
    # the same step the trainer runs (make_train_step), K per call
    state = make_train_state(params, tx, extra)
    if steps_per_call > 1:
        step = make_multi_step(loss_fn, tx, steps_per_call, has_aux=True)
    else:
        step = make_train_step(loss_fn, tx, has_aux=True)

    prefetcher = None
    if feed == "host":
        from edl_tpu_torch.data.input_pipeline import synthetic_pipeline
        from edl_tpu_torch.data.prefetch import DevicePrefetcher

        def to_bf16(b):
            return {"image": torch.from_numpy(b["image"]).to(torch.bfloat16),
                    "label": b["label"]}

        prefetcher = DevicePrefetcher(
            synthetic_pipeline(batch_per_chip, image_size=image_size),
            device, size=2, transform=to_bf16)
        next_batch = lambda: next(prefetcher)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        staged = {
            "image": torch.randn(batch_per_chip, image_size, image_size, 3,
                                 generator=gen, device=device,
                                 dtype=torch.bfloat16),
            "label": torch.randint(0, 1000, (batch_per_chip,),
                                   generator=gen, device=device,
                                   dtype=torch.int32),
        }
        if steps_per_call > 1:
            staged = {k: v.expand((steps_per_call,) + v.shape)
                      for k, v in staged.items()}
        next_batch = lambda: staged
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    losses = []

    def dispatch():
        nonlocal state
        state, loss = step(state, next_batch(), None)
        losses.extend(loss.reshape(-1))
        return loss

    try:
        log("warmup (%d steps)..." % warmup)
        t0 = time.perf_counter()
        for _ in range(warmup):
            dispatch()
        _block(losses[-1] if losses else None)
        if losses:
            log("warmup done in %.1fs (loss=%.3f)"
                % (time.perf_counter() - t0, float(losses[-1])))
        iters, dt, guard_fired = _guarded_timed_loop(dispatch, iters, device)
    finally:
        # a failed run must not leave the prefetch thread holding
        # device batches
        if prefetcher is not None:
            prefetcher.close()
    ms_per_step = 1000 * dt / (iters * steps_per_call)
    per_chip = batch_per_chip * iters * steps_per_call / dt
    log("throughput: %.1f img/s per card (%.3f ms/step)"
        % (per_chip, ms_per_step))
    # physics gate: the port's own count (see the module docstring)
    flops_per_image = 3 * resnet.flops_per_image(image_size, **model_kw)
    implied_tflops = per_chip * flops_per_image / 1e12
    mfu = implied_tflops * 1e12 / PEAK_BF16_FLOPS
    log("implied %.1f TFLOP/s per card (%.2f GFLOP per image), MFU %.4f "
        "of the H100's %.0f TFLOP/s bf16"
        % (implied_tflops, flops_per_image / 1e9, mfu,
           PEAK_BF16_FLOPS / 1e12))
    suspect = implied_tflops * 1e12 > PEAK_BF16_FLOPS * 1.25
    if suspect:
        log("WARNING: implied TFLOP/s exceeds the H100's physical peak — "
            "marking metric _suspect")
    metric = "resnet50_vd_train_imgs_per_sec_per_chip"
    if suspect:
        metric += "_suspect"
    if feed == "host":
        metric += "_hostfed"
    if steps_per_call > 1:
        metric += "_scan%d" % steps_per_call
    if bn_stats_every > 1:
        metric += "_bn%d" % bn_stats_every
    if batch_per_chip != MODEL_DEFAULT_BATCH["resnet"]:
        metric += "_b%d" % batch_per_chip
    if guard_fired:
        metric += "_slowstep"
    if stats is not None:
        stats.update(
            step_ms=ms_per_step, iters=iters, seconds=dt,
            imgs_per_s=per_chip, implied_tflops=implied_tflops, mfu=mfu,
            flops_per_image=flops_per_image,
            losses=[float(x) for x in losses], dispatch=dispatch,
            prefetch=prefetcher.stats() if prefetcher is not None else None,
            peak_bytes=torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return {"metric": metric, "value": round(per_chip, 1),
            "unit": "img/s/chip",
            "vs_baseline": round(per_chip / BASELINE_IMGS_PER_SEC_PER_CHIP,
                                 3)}


def _run_lm(kind, batch_per_chip, seq_len, warmup, iters, tiny, flash,
            remat=True, device=None, stats=None):
    """Shared LM/encoder train-throughput loop (tokens/s on one card)
    for --model gpt and --model bert. ``stats``, if a dict, receives the
    run's details: step ms, losses, implied TFLOP/s, MFU, peak memory,
    parameter count, and ``dispatch``, a function that runs one more
    step of the same state and batch (for a profile)."""
    device = resolve_device(device)
    if flash and device.type != "cuda":
        # the plain version on the CPU would bench the reference loop
        log("bench[%s]: --flash ignored off CUDA (device %s)"
            % (kind, device))
        flash = False
    dtype = torch.bfloat16
    if kind == "gpt":
        from edl_tpu_torch.models import gpt as family
        model = (family.gpt_tiny(dtype=dtype, use_flash=flash,
                                 device=device)
                 if tiny else family.Gpt(dtype=dtype, remat=remat,
                                         use_flash=flash, device=device))
        prefix = "gpt_tiny" if tiny else "gpt2s"
    else:
        from edl_tpu_torch.models import bert as family
        model = (family.bert_tiny(dtype=dtype, use_flash=flash,
                                  device=device)
                 if tiny else family.bert_base(dtype=dtype, use_flash=flash,
                                               remat=remat, device=device))
        prefix = "bert_tiny" if tiny else "bert_base"
    requested_seq = seq_len
    seq_len = min(seq_len, model.max_len)
    if requested_seq != seq_len:
        log("bench[%s]: seq_len %d clamped to the model max %d"
            % (kind, requested_seq, seq_len))
    log("bench[%s]: 1 card (%s), batch %d, seq %d, tiny=%s, flash=%s, "
        "remat=%s" % (kind, torch.cuda.get_device_name(device)
                      if device.type == "cuda" else device.type,
                      batch_per_chip, seq_len, tiny, flash, remat))
    model, params, loss_fn = family.create_model_and_loss(model=model)
    tx = optim.adamw(1e-4)
    state = make_train_state(params, tx)
    step = make_train_step(loss_fn, tx)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = {"input_ids": torch.randint(
        0, model.vocab_size, (batch_per_chip, seq_len), generator=gen,
        device=device)}
    if kind == "bert":
        batch["label"] = torch.randint(0, model.num_classes,
                                       (batch_per_chip,), generator=gen,
                                       device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    losses = []

    def dispatch():
        nonlocal state
        state, loss = step(state, batch, None)
        losses.append(loss)
        return loss

    log("warmup (%d steps)..." % warmup)
    t0 = time.perf_counter()
    for _ in range(warmup):
        dispatch()
    _block(losses[-1] if losses else None)
    if losses:
        log("warmup done in %.1fs (loss=%.3f)"
            % (time.perf_counter() - t0, float(losses[-1])))
    iters, dt, guard_fired = _guarded_timed_loop(dispatch, iters, device)
    per_chip = batch_per_chip * seq_len * iters / dt
    n_params = sum(p.numel() for p in state["params"].values())
    # physics gate: ~6 N per token + the attention term
    flops_per_token = 6.0 * n_params + 12.0 * model.num_layers \
        * model.d_model * seq_len
    implied_tflops = per_chip * flops_per_token / 1e12
    mfu = implied_tflops * 1e12 / PEAK_BF16_FLOPS
    log("throughput: %.0f tok/s per card (%.3f ms/step)"
        % (per_chip, 1000 * dt / iters))
    log("implied %.1f TFLOP/s per card, MFU %.4f of the H100's %.0f "
        "TFLOP/s bf16" % (implied_tflops, mfu, PEAK_BF16_FLOPS / 1e12))
    metric = prefix + "_train_tokens_per_sec_per_chip"
    if seq_len != min(MODEL_DEFAULT_SEQ[kind], model.max_len):
        metric += "_seq%d" % seq_len
    if batch_per_chip != (2 if tiny else MODEL_DEFAULT_BATCH[kind]):
        metric += "_b%d" % batch_per_chip
    if not remat and not tiny:
        metric += "_noremat"
    if flash:
        metric += "_flash"
    if guard_fired:
        metric += "_slowstep"
    if implied_tflops * 1e12 > PEAK_BF16_FLOPS * 1.25:
        log("WARNING: implied TFLOP/s exceeds the H100's physical peak — "
            "marking metric _suspect")
        metric += "_suspect"
    if stats is not None:
        stats.update(
            step_ms=1000.0 * dt / iters, iters=iters, seconds=dt,
            tokens_per_s=per_chip, implied_tflops=implied_tflops, mfu=mfu,
            n_params=n_params, flops_per_token=flops_per_token,
            losses=[float(x) for x in losses], dispatch=dispatch,
            peak_bytes=torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return {"metric": metric, "value": round(per_chip, 1),
            "unit": "tok/s/chip", "vs_baseline": 0.0}


def run_gpt(batch_per_chip=8, seq_len=1024, warmup=3, iters=20,
            tiny=False, flash=False, remat=True, device=None, stats=None):
    """GPT causal-LM training throughput, GPT-2-small shape by default
    (12L/768d/12h, vocab 32k) — see _run_lm."""
    return _run_lm("gpt", batch_per_chip, seq_len, warmup, iters, tiny,
                   flash, remat=remat, device=device, stats=stats)


def run_bert(batch_per_chip=32, seq_len=512, warmup=3, iters=20,
             tiny=False, flash=False, remat=True, device=None, stats=None):
    """BERT-base encoder training throughput (classification head,
    seq 512) — the flash-attention A/B vehicle; see _run_lm."""
    return _run_lm("bert", batch_per_chip, seq_len, warmup, iters, tiny,
                   flash, remat=remat, device=device, stats=stats)


def _build_parser():
    ap = argparse.ArgumentParser(prog="python -m edl_tpu_torch.bench")
    ap.add_argument("--model", choices=("resnet", "gpt", "bert"),
                    default="resnet",
                    help="resnet = the headline (img/s, ResNet50_vd @ "
                         "224); gpt = the LM surface (tok/s, GPT-2-small "
                         "shape); bert = the encoder surface (tok/s, "
                         "bert-base @ seq 512)")
    ap.add_argument("--batch_per_chip", type=int, default=None,
                    help="default: 128 (resnet) / 8 (gpt) / 32 (bert)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--seq_len", type=int, default=None,
                    help="sequence length (default: 1024 gpt / 512 bert)")
    ap.add_argument("--flash", action="store_true",
                    help="gpt/bert: the CUDA flash-attention kernels, "
                         "forward and backward (ignored off CUDA)")
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="gpt/bert non-tiny: per-layer activation "
                         "recompute")
    ap.add_argument("--gpt_tiny", action="store_true",
                    help="gpt/bert: the tiny test-size model of the family")
    ap.add_argument("--s2d", dest="s2d", action="store_true")
    ap.add_argument("--no-s2d", dest="s2d", action="store_false")
    ap.set_defaults(s2d=True)
    ap.add_argument("--feed", choices=("device", "host", "native"),
                    default="device",
                    help="device = staged-once compute rate; host = "
                         "synthetic pipeline fed per step; native is not "
                         "ported (ROADMAP A18)")
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="K train steps per call (make_multi_step)")
    ap.add_argument("--bn_stats_every", type=int, default=1,
                    help="BN train statistics from every k-th batch row "
                         "(4 at batch 128 = the reference's per-GPU "
                         "stats batch of 32)")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card); cpu for "
                         "a schema run")
    return ap


def main(argv=None):
    ap = _build_parser()
    args = ap.parse_args(argv)
    if args.batch_per_chip is None:
        args.batch_per_chip = 2 if args.gpt_tiny else \
            MODEL_DEFAULT_BATCH[args.model]
    if args.steps_per_call < 1:
        ap.error("--steps_per_call must be >= 1")
    if args.bn_stats_every < 1:
        ap.error("--bn_stats_every must be >= 1")
    if args.model == "resnet" and args.bn_stats_every > 1 \
            and args.batch_per_chip // args.bn_stats_every < 16:
        # the JAX package's r4 gate experiment: 8-sample BN statistics
        # (batch 32 / every 4) cost real accuracy (0.8 vs 0.85+); refuse
        # stats batches below half the gated 32
        ap.error("--bn_stats_every %d at batch %d leaves a BN stats "
                 "batch of %d (< 16); subset statistics this small "
                 "measurably hurt convergence"
                 % (args.bn_stats_every, args.batch_per_chip,
                    args.batch_per_chip // args.bn_stats_every))
    if args.model == "resnet":
        result = run(batch_per_chip=args.batch_per_chip,
                     image_size=args.image_size, warmup=args.warmup,
                     iters=args.iters, s2d=args.s2d, feed=args.feed,
                     steps_per_call=args.steps_per_call,
                     bn_stats_every=args.bn_stats_every,
                     device=args.device)
    else:
        if args.seq_len is None:
            args.seq_len = MODEL_DEFAULT_SEQ[args.model]
        lm = run_gpt if args.model == "gpt" else run_bert
        result = lm(batch_per_chip=args.batch_per_chip,
                    seq_len=args.seq_len, warmup=args.warmup,
                    iters=args.iters, tiny=args.gpt_tiny, flash=args.flash,
                    remat=args.remat, device=args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
