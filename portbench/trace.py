"""Reduction of a `torch.profiler` trace of a steady part of the window
to what the per-layer metrics read.

`Trace` profiles the device's activity (CUDA only: the host side of
every operator would cost the host ~20 us an operator, which slows a
host-paced step by a third and inflates its idle share) around a part
of the window; the driver marks the host's phases in it (`mark`).
`reduce()`, called after the window has closed, gives:
  * `busy_s`: seconds in which at least one kernel or copy ran on the
    device, the union of the device events' intervals (a sum would count
    concurrent kernels twice);
  * `window_s`: the host clock over the traced part;
  * `kernel_s(pattern)`: device seconds of the kernels whose name matches
    a regular expression;
  * `gemm_s()`: device seconds of the matrix products: kernels named
    like a GEMM (`gemm`) that are not a convolution's (`fprop`, `dgrad`,
    `wgrad`, `implicit`, `conv`, `winograd`);
  * `breakdown`: the ten device operations that took most time and the
    ten longest idle gaps of the device, each named by the host phase
    the driver had marked last before the gap's middle.
If the trace holds no device event at all, `busy_s` is 0 and every
reading by name is None.
"""
import re
import time

import torch

GEMM = re.compile(r'gemm', re.I)
CONV = re.compile(r'fprop|dgrad|wgrad|implicit|conv|winograd', re.I)


def _union(spans):
    busy, end = 0.0, float('-inf')
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


class Trace:
    """Context manager profiling its block; see the module docstring."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.marks = []
        self._kernels = {}
        self.breakdown = {'device_ops': [], 'idle_gaps': []}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == 'cuda'
        if cuda:
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                        else ProfilerActivity.CPU],
                            acc_events=True)
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def mark(self, name):
        """The host enters phase `name` now."""
        self.marks.append((time.perf_counter() - self._t0, name))

    def __exit__(self, *exc):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        return False

    def reduce(self):
        """Read the profiler's events (after the window: this takes the
        host seconds)."""
        dev = [e for e in self.prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = [(e.time_range.start, e.time_range.end) for e in dev]
        self.busy_s = _union(spans) / 1e6
        for e in dev:
            s, n = self._kernels.get(e.name, (0.0, 0))
            self._kernels[e.name] = (s + (e.time_range.end
                                          - e.time_range.start) / 1e6, n + 1)
        top = sorted(self._kernels.items(), key=lambda kv: -kv[1][0])[:10]
        self.breakdown['device_ops'] = [[k[:120], v[0]] for k, v in top]
        self.breakdown['idle_gaps'] = self._gaps(spans)
        self.prof = None
        return self

    def _gaps(self, spans):
        """The ten longest gaps between device activity (profiler
        microseconds from the trace's start), each named by the host
        phase marked last before its middle."""
        gaps, end = [], None
        for start, stop in sorted(spans):
            if end is not None and start > end:
                gaps.append((start - end, end, start))
            end = stop if end is None else max(end, stop)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:10]:
            mid = (a + b) / 2e6
            names = [n for t, n in self.marks if t <= mid]
            out.append([names[-1] if names else 'start', length / 1e6])
        return out

    def kernel_s(self, pattern):
        """Device seconds of kernels whose name matches `pattern`, or None
        when none ran."""
        rx = re.compile(pattern)
        hits = [s for name, (s, _) in self._kernels.items()
                if rx.search(name)]
        return sum(hits) if hits else None

    def gemm_s(self):
        """Device seconds of the GEMM kernels that are no convolution's,
        or None when none ran."""
        hits = [s for name, (s, _) in self._kernels.items()
                if GEMM.search(name) and not CONV.search(name)]
        return sum(hits) if hits else None
