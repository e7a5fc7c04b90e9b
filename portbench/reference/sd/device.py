"""The device rule of the port's entry points, and the cache of small
constant tensors made on a device.

Entry points default to CUDA. Without a GPU they raise unless the
caller asked for the CPU explicitly; nothing falls back quietly.
"""
import functools

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


def tensor_cache(maxsize=None):
    """`functools.lru_cache` for a function that makes constant tensors
    (a table's scales on a device, say: a host-to-device copy per call
    would wait for the device's queue to drain). While `torch.export` or
    `torch.compile` traces, the call bypasses the cache: a tensor made
    there is a fake one and must not outlive the trace, and one made
    before it is a constant of the traced program either way. The
    wrapper keeps `cache_clear`."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if torch.compiler.is_compiling():
                return fn(*args)
            return cached(*args)
        call.cache_clear = cached.cache_clear
        return call
    return wrap
