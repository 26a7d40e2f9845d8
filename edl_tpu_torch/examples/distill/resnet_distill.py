"""ResNet student training against a fleet of teacher servers, on the
port.

Reference parity: example/distill/resnet/train_with_fleet.py — the student
wraps its reader in a DistillReader and adds a soft-label term to the loss
(reference :103-104,445-449); teachers are ResNet-class models served by
edl_tpu_torch.distill.teacher_server instead of Paddle Serving.

    python -m edl_tpu_torch.distill.teacher_server --model resnet \\
        --depth 18 --image_size 32 --num_classes 10   # TEACHER_ENDPOINT=
    python -m edl_tpu_torch.examples.distill.resnet_distill --teachers <ep>

Runs on CUDA unless ``--device cpu``. On SIGTERM the next step boundary
raises ``PreemptedError`` and the process exits 101.
"""

import argparse
import json
import sys


def distill_loss(logits, label, soft_label, num_classes, w):
    """(1-w) * the softmax cross-entropy of ``logits`` against one-hot
    ``label`` + w * the cross-entropy against softmax(``soft_label``),
    the teacher's logits; each a mean over the batch, in f32."""
    import torch
    import torch.nn.functional as F

    logp = F.log_softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(label.long(), num_classes).to(logp.dtype)
    hard = -(one_hot * logp).sum(-1).mean()
    teacher_probs = torch.softmax(soft_label.float(), dim=-1)
    soft = -(teacher_probs * logp).sum(-1).mean()
    return (1 - w) * hard + w * soft


def make_loss_fn(model, num_classes, w):
    """``loss_fn(params, extra, batch, rng) -> (loss, {"batch_stats"})``
    for the train-step builders with ``has_aux=True``: :func:`distill_loss`
    of the train-mode logits of ``batch["image"]`` (NHWC), the updated
    BatchNorm statistics as the aux."""
    import torch
    from torch.func import functional_call

    def loss_fn(params, extra, batch, rng):
        dev = next(iter(params.values())).device
        image = torch.as_tensor(batch["image"], device=dev)
        label = torch.as_tensor(batch["label"], device=dev)
        soft = torch.as_tensor(batch["soft_label"], device=dev)
        logits, stats = functional_call(
            model, params, (image, extra["batch_stats"]), {"train": True})
        return (distill_loss(logits, label, soft, num_classes, w),
                {"batch_stats": stats})

    return loss_fn


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.examples.distill.resnet_distill")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps_per_epoch", type=int, default=8)
    p.add_argument("--total_batch_size", type=int, default=16)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--distill_weight", type=float, default=0.5)
    p.add_argument("--teachers", default="",
                   help="comma list of fixed teacher endpoints")
    p.add_argument("--discovery", default="",
                   help="discovery server endpoint (dynamic teachers)")
    p.add_argument("--service_name", default="resnet_teacher")
    p.add_argument("--require_num", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="default: cuda (raises without a card)")
    return p.parse_args(argv)


def main(argv=None):
    from edl_tpu_torch.runtime.trainer import maybe_init_distributed
    maybe_init_distributed()

    import numpy as np
    import torch

    from edl_tpu_torch.distill.distill_reader import DistillReader
    from edl_tpu_torch.models import resnet
    from edl_tpu_torch.runtime import optim
    from edl_tpu_torch.runtime.trainer import ElasticTrainer
    from edl_tpu_torch.utils.errors import PreemptedError

    args = parse_args(argv)
    model, params, extra, _ = resnet.create_model_and_loss(
        depth=18, num_classes=args.num_classes, dtype=torch.float32,
        device=args.device)
    trainer = ElasticTrainer(
        make_loss_fn(model, args.num_classes, args.distill_weight), params,
        optim.sgd(0.05, momentum=0.9),
        total_batch_size=args.total_batch_size, extra_state=extra,
        has_aux=True, device=args.device)
    trainer.install_preemption_handler()

    def gen():
        for step in range(args.steps_per_epoch):
            b = resnet.synthetic_image_batch(
                args.total_batch_size, image_size=args.image_size,
                num_classes=args.num_classes, seed=step)
            yield b["image"], b["label"]

    dr = DistillReader(ins=["image"], predicts=["logits"])
    dr.set_batch_generator(gen)
    if args.discovery:
        dr.set_dynamic_teacher(args.discovery, args.service_name,
                               args.require_num)
    else:
        dr.set_fixed_teacher([e for e in args.teachers.split(",") if e])

    loss = None
    try:
        for epoch in range(args.epochs):
            trainer.begin_epoch(epoch)
            for image, label, soft_label in dr():
                loss = float(trainer.train_step(trainer.local_batch_slice({
                    "image": np.asarray(image),
                    "label": np.asarray(label),
                    "soft_label": np.asarray(soft_label),
                })))
            trainer.end_epoch(save=False)
            print("epoch %d loss %.4f" % (epoch, loss), flush=True)
    except PreemptedError as e:
        # emergency checkpoint written (when a checkpoint dir is
        # configured); exit-101 is the restart convention
        print("preempted: %s" % e, flush=True)
        dr.stop()
        return 101
    dr.stop()
    print(json.dumps({"final_loss": loss, "steps": trainer.global_step}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
