"""Minimal single-file distillation example on the port — the
mnist_distill of the framework (reference parity: example/distill/
mnist_distill/train_with_fleet.py:135-143, where the student's reader is
wrapped in a DistillReader and the teacher's soft logits join the loss).

Self-contained and dataset-free: a small MLP TEACHER is trained
in-process on synthetic digit-like images, served through the real
TeacherServer (RPC + ndarray codec + pad-to-compiled-batch), and a
smaller STUDENT trains against hard labels + the served soft labels via
a DistillReader. Run:

    python -m edl_tpu_torch.examples.distill.mnist_distill [--device cpu]

Prints one JSON line: teacher/student eval accuracy; the student must
recover the teacher's accuracy with 8x fewer hidden units.
"""

import argparse
import json
import math
import sys


def synth_digits(n, seed=0):
    """28x28 'digits': class c lights a 3-row band at row 2+2c plus
    noise — linearly separable but only through the pixel grid."""
    import numpy as np
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    imgs = rng.randn(n, 28, 28, 1).astype("float32") * 0.3
    for i, c in enumerate(labels):
        imgs[i, 2 + 2 * c: 5 + 2 * c, :, 0] += 2.0
    return imgs, labels.astype("int32")


def _lecun_normal_(kernel, generator):
    """flax's default Dense kernel init: a normal truncated at two
    standard deviations, scaled to variance 1/fan_in."""
    import torch

    fan_in = kernel.shape[0]
    # the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(kernel, std=std, a=-2 * std,
                                    b=2 * std, generator=generator)


def make_mlp(hidden, seed, device):
    """(model, params): flax's ``Mlp`` — flatten, Dense(hidden), relu,
    Dense(10) — with flax's default initialisers (lecun-normal kernels
    [in, out], zero biases) from a generator seeded ``seed``; params are
    named as the flax tree (``Dense_0.kernel``, ...)."""
    import torch
    from torch import nn

    class Dense(nn.Module):
        def __init__(self, n_in, n_out):
            super().__init__()
            self.kernel = nn.Parameter(torch.empty(n_in, n_out,
                                                   device=device))
            self.bias = nn.Parameter(torch.zeros(n_out, device=device))

        def forward(self, x):
            return x @ self.kernel + self.bias

    class Mlp(nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(28 * 28, hidden)
            self.Dense_1 = Dense(hidden, 10)

        def forward(self, x):
            x = x.reshape(x.shape[0], -1)
            x = torch.relu(self.Dense_0(x))
            return self.Dense_1(x)

    model = Mlp()
    gen = torch.Generator(device=device).manual_seed(seed)
    for dense in (model.Dense_0, model.Dense_1):
        _lecun_normal_(dense.kernel, gen)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return model, params


def distill_loss(logits, label, soft_label, w):
    """(1-w) * the cross-entropy against the integer ``label`` + w * the
    cross-entropy against softmax(``soft_label``), each a mean over the
    batch, in f32."""
    import torch
    import torch.nn.functional as F

    logp = F.log_softmax(logits.float(), dim=-1)
    hard = F.nll_loss(logp, label.long())
    soft_targets = torch.softmax(soft_label.float(), dim=-1)
    soft = -(soft_targets * logp).sum(-1).mean()
    return (1 - w) * hard + w * soft


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.examples.distill.mnist_distill")
    p.add_argument("--teacher_steps", type=int, default=60)
    p.add_argument("--student_steps", type=int, default=60)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--distill_weight", type=float, default=0.7)
    p.add_argument("--device", default=None,
                   help="default: cuda (raises without a card)")
    return p.parse_args(argv)


def main(argv=None):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call

    from edl_tpu_torch.distill.distill_reader import DistillReader
    from edl_tpu_torch.distill.teacher_server import TeacherServer
    from edl_tpu_torch.runtime import optim
    from edl_tpu_torch.runtime.trainer import (ElasticTrainer,
                                               make_train_state,
                                               make_train_step)
    from edl_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)

    def on_device(x):
        return torch.as_tensor(np.asarray(x), device=device)

    def accuracy(model, params, imgs, labels):
        with torch.no_grad():
            logits = functional_call(model, params, (on_device(imgs),))
        return float((logits.argmax(-1).cpu().numpy()
                      == np.asarray(labels)).mean())

    eval_x, eval_y = synth_digits(512, seed=999)

    # -- 1. teacher: train in-process ------------------------------------
    teacher, t_params = make_mlp(256, seed=0, device=device)

    def t_loss(params, batch, rng):
        logits = functional_call(teacher, params, (batch["image"],))
        return F.cross_entropy(logits, batch["label"].long())

    tx = optim.adam(1e-3)
    t_step = make_train_step(t_loss, tx)
    t_state = make_train_state(t_params, tx)
    for step in range(args.teacher_steps):
        x, y = synth_digits(args.batch_size, seed=step)
        t_state, _ = t_step(t_state, {"image": on_device(x),
                                      "label": on_device(y)}, None)
    t_params = t_state["params"]
    teacher_acc = accuracy(teacher, t_params, eval_x, eval_y)

    # -- 2. serve it (the real RPC path students use) --------------------
    def predict(feed):
        # np.array copies: the feed may view a reused staging buffer
        with torch.no_grad():
            logits = functional_call(teacher, t_params,
                                     (on_device(np.array(feed["image"])),))
        return {"logits": logits.cpu().numpy()}

    server = TeacherServer(
        predict, feed_specs={"image": ([28, 28, 1], "<f4")},
        fetch_specs={"logits": ([10], "<f4")},
        max_batch=args.batch_size, host="127.0.0.1").start()

    # -- 3. student: distill through a DistillReader ---------------------
    student, s_params = make_mlp(32, seed=1, device=device)
    w = args.distill_weight

    def loss_fn(params, batch, rng):
        logits = functional_call(student, params, (batch["image"],))
        return distill_loss(logits, batch["label"], batch["soft_label"], w)

    trainer = ElasticTrainer(loss_fn, s_params, optim.adam(1e-3),
                             total_batch_size=args.batch_size,
                             device=device)
    trainer.install_preemption_handler()

    def gen():
        for step in range(args.student_steps):
            x, y = synth_digits(args.batch_size, seed=10_000 + step)
            yield x, y

    dr = DistillReader(ins=["image"], predicts=["logits"])
    dr.set_batch_generator(gen)
    dr.set_fixed_teacher([server.endpoint])
    loss = None
    try:
        trainer.begin_epoch(0)
        for imgs, labels, soft in dr():
            loss = float(trainer.train_step({
                "image": imgs, "label": labels, "soft_label": soft}))
        trainer.end_epoch(save=False)
    finally:
        dr.stop()
        server.stop()
        trainer.close()
    student_acc = accuracy(student, trainer.train_state["params"],
                           eval_x, eval_y)

    print(json.dumps({
        "teacher_acc": round(teacher_acc, 4),
        "student_acc": round(student_acc, 4),
        "steps": trainer.global_step,
        "final_loss": loss,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
