"""The port's copies of the repo's distillation examples (``python -m
edl_tpu_torch.examples.distill.<name>``)."""
