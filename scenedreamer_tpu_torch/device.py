"""The device rule of the port's entry points.

Entry points default to CUDA. Without a GPU they raise unless the
caller asked for the CPU explicitly; nothing falls back quietly.
"""
import torch


def resolve_device(device=None):
    """`None` means CUDA. Returns a `torch.device`; raises RuntimeError
    when CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run the plain '
            'PyTorch path on the CPU')
    return dev
