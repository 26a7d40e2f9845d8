"""ResNet-vd elastic training on one card: ``examples/resnet/train.py``
on the port.

Reference parity: example/collective/resnet50/train_with_fleet.py — the
headline config (SURVEY.md §3.2): ResNet50_vd, warmup + cosine/
piecewise LR with the batch-scaling rule, per-epoch rank-0 checkpoints,
throughput logging every ``fetch_steps`` and a final benchmark-log JSON
(reference :532-548,642-658). Synthetic data.

    EDL_TPU_CHECKPOINT_PATH=/ckpt python -m edl_tpu_torch.examples.resnet.train

Checkpoints go to ``EDL_TPU_CHECKPOINT_PATH`` (the launcher's contract)
at every epoch end. On SIGTERM the next step boundary writes an
emergency checkpoint at the current step and the process exits 101
(the restart convention); run again with the same arguments to resume
at that step, re-running the interrupted epoch. Runs on CUDA unless
``--device cpu``. ``--data_dir``/``--eval_dir``/``--loader`` (the
image-folder pipelines, ROADMAP A18), ``--zero1`` (A12/A19) and
``--prewarm_worlds`` (A17) are not ported and raise.
"""

import argparse
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.examples.resnet.train")
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps_per_epoch", type=int, default=10)
    p.add_argument("--total_batch_size", type=int, default=32)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=100)
    p.add_argument("--base_lr", type=float, default=0.1)
    p.add_argument("--warmup_epochs", type=int, default=1)
    p.add_argument("--lr_schedule", choices=["cosine", "piecewise"],
                   default="cosine")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="f32")
    p.add_argument("--bn_stats_every", type=int, default=1,
                   help="BN train statistics from every k-th batch row "
                        "(throughput knob for large per-chip batches)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer update; raise after "
                        "a scale-down to keep global batch AND per-chip "
                        "memory constant")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 weight-update sharding (not ported)")
    p.add_argument("--max_per_device_batch", type=int, default=None,
                   help="per-device batch budget; grad accumulation is "
                        "chosen per world size to fit it")
    p.add_argument("--fetch_steps", type=int, default=10)
    p.add_argument("--eval_steps", type=int, default=0,
                   help="eval batches per epoch on rank 0 (0 = off)")
    p.add_argument("--data_dir", default=None,
                   help="image-folder dataset root (not ported)")
    p.add_argument("--eval_dir", default=None,
                   help="image-folder eval split (not ported)")
    p.add_argument("--loader", choices=["tf", "native"], default=None,
                   help="host decode pipeline for --data_dir (not "
                        "ported)")
    p.add_argument("--seed", type=int, default=None,
                   help="augmentation seed of the image-folder pipeline "
                        "(not ported)")
    p.add_argument("--prewarm_worlds", default="",
                   help="chip counts to compile the step for ahead of a "
                        "resize (not ported)")
    p.add_argument("--device", default=None,
                   help="default: cuda (raises without a card)")
    args = p.parse_args(argv)
    for flag, item in (("data_dir", "A18"), ("eval_dir", "A18"),
                       ("loader", "A18"), ("seed", "A18"),
                       ("zero1", "A12/A19"), ("prewarm_worlds", "A17")):
        value = getattr(args, flag)
        if value is not None and value is not False and value != "":
            raise NotImplementedError(
                "--%s is not ported to edl_tpu_torch yet (ROADMAP %s)"
                % (flag, item))
    return args


def build(args, checkpoint_dir=None):
    """(model, trainer) for ``args``: ResNet-vd with random weights
    (seed 0), sgd(momentum 0.9) over the warm-up + decay schedule, BN
    statistics as extra state. ``checkpoint_dir`` None takes the
    launcher's ``EDL_TPU_CHECKPOINT_PATH``."""
    import torch

    from edl_tpu_torch.models import resnet
    from edl_tpu_torch.runtime import lr_schedules, optim
    from edl_tpu_torch.runtime.trainer import ElasticTrainer

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    total_steps = args.epochs * args.steps_per_epoch
    lr = lr_schedules.scale_lr_for_batch(args.base_lr,
                                         args.total_batch_size)
    if args.lr_schedule == "cosine":
        base = lr_schedules.cosine_decay(lr, total_steps)
    else:
        bounds = [total_steps // 3, 2 * total_steps // 3]
        base = lr_schedules.piecewise_decay(lr, bounds)
    schedule = lr_schedules.linear_warmup(
        base, args.warmup_epochs * args.steps_per_epoch)
    model, params, extra, loss_fn = resnet.create_model_and_loss(
        depth=args.depth, num_classes=args.num_classes, dtype=dtype,
        bn_stats_every=args.bn_stats_every, device=args.device)
    trainer = ElasticTrainer(
        loss_fn, params, optim.sgd(schedule, momentum=0.9),
        total_batch_size=args.total_batch_size, extra_state=extra,
        has_aux=True, grad_accum=args.grad_accum,
        max_per_device_batch=args.max_per_device_batch,
        checkpoint_dir=checkpoint_dir, device=args.device)
    return model, trainer


def host_batches(args, trainer, epoch):
    """The host batch stream of one epoch: the deterministic synthetic
    stream, ``steps_per_epoch`` batches."""
    from edl_tpu_torch.models import resnet

    for step in range(args.steps_per_epoch):
        full = resnet.synthetic_image_batch(
            args.total_batch_size, image_size=args.image_size,
            num_classes=args.num_classes, seed=epoch * 100000 + step)
        yield trainer.local_batch_slice(full)


def eval_batches(args):
    from edl_tpu_torch.models import resnet

    return (resnet.synthetic_image_batch(
        args.total_batch_size, image_size=args.image_size,
        num_classes=args.num_classes, seed=2**31 - 1 - i)
        for i in range(args.eval_steps))


def main(argv=None):
    from edl_tpu_torch.runtime.trainer import maybe_init_distributed
    maybe_init_distributed()

    import torch

    from edl_tpu_torch.controller import train_status as ts
    from edl_tpu_torch.utils.errors import PreemptedError

    args = parse_args(argv)
    model, trainer = build(args)
    env = trainer.env
    trainer.install_preemption_handler()
    resumed = trainer.resume()
    start_epoch = trainer.state.next_epoch() if resumed else 0
    print("resnet%d_vd: rank=%d world=%d start_epoch=%d resumed=%s "
          "step=%d" % (args.depth, env.global_rank, trainer.world_size,
                       start_epoch, resumed, trainer.global_step),
          flush=True)

    evaluator = None
    if args.eval_steps and env.global_rank == 0:
        from edl_tpu_torch.runtime.evaluation import Evaluator

        def eval_apply(params, extra, batch):
            image = torch.as_tensor(batch["image"], device=trainer.device)
            logits, _ = torch.func.functional_call(
                model, params, (image, extra["batch_stats"]),
                {"train": False})
            return logits
        evaluator = Evaluator(eval_apply)

    loss = None
    accs = None
    imgs_seen = 0
    t_start = time.perf_counter()
    try:
        for epoch in range(start_epoch, args.epochs):
            trainer.begin_epoch(epoch)
            if epoch == args.epochs - 1:
                # after begin_epoch: it reports RUNNING, which would
                # clobber the scale-out-stopping NEARTHEEND verdict
                trainer.report_status(ts.TrainStatus.NEARTHEEND)
            t_epoch = time.perf_counter()
            for step, host_batch in enumerate(
                    host_batches(args, trainer, epoch)):
                loss = float(trainer.train_step(host_batch))
                imgs_seen += args.total_batch_size
                if (step + 1) % args.fetch_steps == 0:
                    dt = time.perf_counter() - t_epoch
                    print("epoch %d step %d loss %.4f  %.1f img/s"
                          % (epoch, step + 1, loss,
                             args.total_batch_size * (step + 1) / dt),
                          flush=True)
            trainer.end_epoch(save=True)
            if evaluator is not None:
                # rank-0 eval, reference parity: train_with_fleet.py:573-610
                accs = evaluator.evaluate(trainer.train_state["params"],
                                          trainer.extra_state,
                                          eval_batches(args))
                print("epoch %d eval: %s" % (epoch, accs), flush=True)
    except PreemptedError as e:
        # emergency checkpoint already written; exit with the restart
        # convention code (liveft's exit-101) so supervisors restart us
        print("preempted: %s" % e, flush=True)
        return 101
    finally:
        trainer.close()

    trainer.report_status(ts.TrainStatus.SUCCEED)
    wall = time.perf_counter() - t_start
    # benchmark-log emission (reference train_with_fleet.py:642-658)
    result = {
        "model": "ResNet%d_vd" % args.depth,
        "final_loss": loss,
        "steps": trainer.global_step,
        "world": trainer.world_size,
        "imgs_per_sec": round(imgs_seen / wall, 1),
    }
    if accs:
        result.update({"eval_" + k: v for k, v in accs.items()})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
