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


def device_from_flags(device=None, platform=None):
    """The device of a CLI's `--device` and `--platform` flags: --device
    when given, else --platform ('cpu' -> the CPU; 'gpu' / 'cuda' ->
    CUDA), else None (CUDA, by `resolve_device`)."""
    if device is not None or platform is None:
        return device
    if platform == 'cpu':
        return 'cpu'
    if platform in ('gpu', 'cuda'):
        return 'cuda'
    raise ValueError(f'--platform {platform!r}: the port runs on cpu or '
                     f'gpu / cuda')
