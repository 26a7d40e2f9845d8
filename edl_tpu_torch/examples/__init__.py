"""The port's copies of the repo's ``examples/`` entry points
(``python -m edl_tpu_torch.examples.<name>.train``)."""
