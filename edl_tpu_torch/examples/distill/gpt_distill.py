"""Sequence-level knowledge distillation for a causal LM, on the port.

The LM counterpart of examples/distill/resnet_distill.py (reference
soft-label pattern: example/distill/resnet/train_with_fleet.py:103-104,
445-449, applied per position): a student GPT trains against the
per-position next-token distributions of a GPT teacher served by
`edl_tpu_torch.distill.teacher_server --model gpt`, wired through the
DistillReader (fixed or discovered teacher fleet).

Loss = (1-w) * hard next-token CE + w * per-position soft CE against
the teacher's probs (positions 0..L-2 predict token t+1, matching the
teacher's alignment).

    python -m edl_tpu_torch.distill.teacher_server --model gpt \\
        --seq_len 16 --vocab_size 64          # prints TEACHER_ENDPOINT=
    python -m edl_tpu_torch.examples.distill.gpt_distill --teachers <ep>

Runs on CUDA unless ``--device cpu``. On SIGTERM the next step boundary
raises ``PreemptedError`` (an emergency checkpoint when
``EDL_TPU_CHECKPOINT_PATH`` is set) and the process exits 101.
``--fetch_steps N`` prints a line every N steps.
"""

import argparse
import json
import sys


def distill_loss(logits, ids, soft_label, w):
    """(1-w) * the mean next-token cross-entropy of ``logits`` [b, L, V]
    against ``ids`` [b, L] shifted by one, + w * the mean soft
    cross-entropy against the teacher's ``soft_label`` probs [b, L, V]
    over positions 0..L-2 (``optax.softmax_cross_entropy`` with the
    probs as labels). f32 throughout."""
    import torch
    import torch.nn.functional as F

    logits = logits[:, :-1].float()
    logp = F.log_softmax(logits, dim=-1)
    hard = F.nll_loss(logp.reshape(-1, logp.shape[-1]),
                      ids[:, 1:].reshape(-1).long())
    # teacher probs share the student's alignment: position t predicts
    # token t+1; the last position has no target
    tprobs = soft_label.float()[:, :-1]
    soft = -(tprobs * logp).sum(-1).mean()
    return (1 - w) * hard + w * soft


def make_loss_fn(model, w):
    """``loss_fn(params, batch, rng)`` for the train-step builders:
    :func:`distill_loss` of ``model`` run on ``params`` over
    ``batch["input_ids"]`` and ``batch["soft_label"]`` (numpy or
    tensors)."""
    import torch
    from torch.func import functional_call

    def loss_fn(params, batch, rng):
        dev = next(iter(params.values())).device
        ids = torch.as_tensor(batch["input_ids"], device=dev).long()
        soft = torch.as_tensor(batch["soft_label"], device=dev)
        logits = functional_call(model, params, (ids,))
        return distill_loss(logits, ids, soft, w)

    return loss_fn


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.examples.distill.gpt_distill")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps_per_epoch", type=int, default=8)
    p.add_argument("--total_batch_size", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=16)
    p.add_argument("--vocab_size", type=int, default=64)
    p.add_argument("--distill_weight", type=float, default=0.5)
    p.add_argument("--teachers", default="",
                   help="comma list of fixed teacher endpoints")
    p.add_argument("--discovery", default="",
                   help="discovery server endpoint (dynamic teachers)")
    p.add_argument("--service_name", default="gpt_teacher")
    p.add_argument("--require_num", type=int, default=1)
    p.add_argument("--fetch_steps", type=int, default=0,
                   help="print a line every N steps (0: per epoch only)")
    p.add_argument("--device", default=None,
                   help="default: cuda (raises without a card)")
    return p.parse_args(argv)


def main(argv=None):
    from edl_tpu_torch.runtime.trainer import maybe_init_distributed
    maybe_init_distributed()

    import numpy as np
    import torch

    from edl_tpu_torch.distill.distill_reader import DistillReader
    from edl_tpu_torch.models import gpt
    from edl_tpu_torch.runtime import optim
    from edl_tpu_torch.runtime.trainer import ElasticTrainer
    from edl_tpu_torch.utils.errors import PreemptedError

    args = parse_args(argv)
    model = gpt.Gpt(num_layers=2, d_model=64, num_heads=4, mlp_dim=128,
                    vocab_size=args.vocab_size,
                    max_len=max(args.seq_len, 16), dtype=torch.float32,
                    device=args.device)
    model, params, _ = gpt.create_model_and_loss(
        model=model, dummy_seq=args.seq_len)
    trainer = ElasticTrainer(
        make_loss_fn(model, args.distill_weight), params,
        optim.adamw(1e-3), total_batch_size=args.total_batch_size,
        device=args.device)
    trainer.install_preemption_handler()

    def gen():
        for step in range(args.steps_per_epoch):
            b = gpt.synthetic_lm_batch(
                args.total_batch_size, seq_len=args.seq_len,
                vocab_size=args.vocab_size, seed=step)
            # label slot unused (the hard loss shifts input_ids itself)
            yield b["input_ids"], np.zeros(
                (args.total_batch_size,), np.int32)

    dr = DistillReader(ins=["input_ids"], predicts=["probs"])
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
            for step, (input_ids, _label, probs) in enumerate(dr()):
                loss = float(trainer.train_step(trainer.local_batch_slice({
                    "input_ids": np.asarray(input_ids),
                    "soft_label": np.asarray(probs),
                })))
                if args.fetch_steps and (step + 1) % args.fetch_steps == 0:
                    print("epoch %d step %d loss %.4f"
                          % (epoch, step + 1, loss), flush=True)
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
