"""Evaluation helpers: top-k accuracy and an eval loop over a batch
stream, ``edl_tpu/runtime/evaluation.py`` on torch.

Reference parity: the rank-0 test loop + acc1/acc5 reporting of the
collective example (train_with_fleet.py:573-610, the acc numbers in
README.md:83-85 / BASELINE.md).
"""

import numpy as np
import torch


def top_k_accuracies(logits, labels, ks=(1, 5)):
    """{k: fraction of rows whose label is in the top-k logits}."""
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels, device=logits.device)
    max_k = min(max(ks), logits.shape[-1])
    top = torch.topk(logits, max_k, dim=-1).indices      # [batch, max_k]
    hits = top == labels[:, None].long()
    return {k: hits[:, :min(k, max_k)].any(dim=1).float().mean()
            for k in ks}


class Evaluator(object):
    """Accuracy evaluation over a batch stream.

    apply_fn(params, extra, batch) -> logits. ``extra`` carries frozen
    model state (BatchNorm running stats) in eval mode.
    """

    def __init__(self, apply_fn, ks=(1, 5)):
        self._ks = tuple(ks)
        self._apply = apply_fn

    def _step(self, params, extra, batch):
        with torch.no_grad():
            logits = self._apply(params, extra, batch)
            accs = top_k_accuracies(logits, batch["label"], self._ks)
        return torch.stack([accs[k] for k in self._ks]), logits.shape[0]

    def evaluate(self, params, extra, batches):
        """Weighted-average top-k accuracies over ``batches``; returns
        {"acc1": ..., "acc5": ...}-style dict."""
        totals = np.zeros(len(self._ks))
        n = 0
        for batch in batches:
            accs, bs = self._step(params, extra, batch)
            totals += accs.cpu().numpy() * int(bs)
            n += int(bs)
        if n == 0:
            return {}
        return {"acc%d" % k: round(float(t / n), 4)
                for k, t in zip(self._ks, totals)}
