"""Tracing and phase timing.

Counterpart of `scenedreamer_tpu/utils/profiling.py` (reference
`train.py:129-151`, `trainers/base.py:876-940`):
  * `trace(logdir)`: a region profiled by `torch.profiler` (CPU and,
    where present, CUDA activity), written as a Chrome trace
    `trace.json` under `logdir` (JAX's `jax.profiler` trace);
  * `annotate(name)`: a named span inside it (`record_function`);
  * `PhaseTimer`: per-phase wall timers for `--speed-benchmark`, each
    phase ending with a device barrier (`torch.cuda.synchronize`; on the
    CPU there is nothing to wait for).
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


@contextlib.contextmanager
def trace(logdir):
    """Profile a code region to `<logdir>/trace.json` (Chrome trace;
    view in Perfetto or chrome://tracing)."""
    import os
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


@contextlib.contextmanager
def annotate(name):
    """Named sub-span inside an active trace."""
    with torch.profiler.record_function(name):
        yield


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
