"""Phase timing for `--speed-benchmark`.

Counterpart of `scenedreamer_tpu/utils/profiling.py` (reference
`trainers/base.py:876-940`: per-phase wall timers with an explicit
device barrier). The barrier is `torch.cuda.synchronize`; on the CPU
there is nothing to wait for.
"""
import contextlib
import time

import torch


def host_sync(device=None):
    """Wait until the device has finished everything enqueued so far."""
    if device is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall time per named phase across iterations; each
    phase ends with a device barrier so it is charged its own work."""

    def __init__(self, device=None):
        self.device = device
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            host_sync(self.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self):
        """Start a fresh window (drop the accumulated totals)."""
        self.totals = {}
        self.counts = {}

    def means(self):
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def report(self):
        lines = [f'{k}: {v * 1000:.2f} ms/iter'
                 for k, v in sorted(self.means().items())]
        return '\n'.join(lines)
