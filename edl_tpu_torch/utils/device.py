"""Device choice for the port's entry points: CUDA unless the caller
asks for the CPU. A missing card is an error, never a silent CPU run."""

import torch


def resolve_device(device=None):
    """``torch.device`` for ``device``; ``None`` means CUDA and raises
    when there is no CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: edl_tpu_torch runs on CUDA unless the "
                "caller passes device='cpu'")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but CUDA is not available"
                           % device)
    return device
