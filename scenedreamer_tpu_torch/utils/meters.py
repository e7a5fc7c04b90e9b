"""Metric meters and experiment logging.

Counterpart of `scenedreamer_tpu/utils/meters.py` (reference
`imaginaire/utils/meters.py:76-149` Meter with mean reduction on flush,
`imaginaire/utils/logging.py:13-51` date-uid logdir): an always-on
`metrics.jsonl` sink with the JAX package's record layout
({'t', 'step', name: value}) and a tensorboard sink when
`torch.utils.tensorboard` imports; snapshot images also land as PNG
files under `<logdir>/images`. Across processes (`torch.distributed`),
each flush means every meter over the ranks; a writer without a logdir
takes part in that mean and writes nothing (the ranks other than 0).
"""
import datetime
import json
import os
import time
import zlib

import numpy as np
import torch.distributed as dist

from scenedreamer_tpu_torch.utils.png import write_png


def make_logging_dir(logdir_root, config_name):
    """logs/<date>_<config> (`utils/logging.py:13-51`)."""
    date_uid = datetime.datetime.now().strftime('%Y_%m%d_%H%M_%S')
    logdir = os.path.join(logdir_root, f'{date_uid}_{config_name}')
    os.makedirs(logdir, exist_ok=True)
    return logdir


def _cross_process_mean(names, means):
    """Mean the per-process meter means across the ranks (JAX
    `utils/meters.py:29-62`).

    One all_gather of a float64 vector per flush: the CRC32 fingerprint
    of the name set, then the means (NaN for a meter with no values of
    its own), reduced with nanmean. Every rank must register the same
    meter names, or meters would be averaged by index with unrelated
    ones: differing fingerprints raise. The vectors go as objects, so a
    rank with more names raises too instead of breaking the collective.
    Returns plain Python floats; one process returns `means`."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return means
    fp = float(zlib.crc32('\x00'.join(names).encode()))
    vec = np.asarray([fp] + [means.get(n, np.nan) for n in names],
                     np.float64)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, vec)
    if not all(len(v) == len(vec) and v[0] == fp for v in every):
        raise RuntimeError(
            'meter name sets diverge across processes; register the '
            'same meters on every rank (rank-local metrics must be '
            'flushed through a separate writer)')
    with np.errstate(invalid='ignore'):
        red = np.nanmean(np.stack(every)[:, 1:], axis=0)
    return {n: float(red[i]) for i, n in enumerate(names)
            if red[i] == red[i]}


class Meter:
    """Buffers scalars between flushes; means on flush, non-finite
    values dropped (`utils/meters.py:76-149`)."""

    def __init__(self, name, writer):
        self.name = name
        self.writer = writer
        self.values = []

    def write(self, value):
        if value is not None:
            self.values.append(float(value))

    def local_mean(self):
        vals = [v for v in self.values
                if v == v and abs(v) != float('inf')]
        return sum(vals) / len(vals) if vals else None

    def flush(self, step):
        m = self.local_mean()
        if m is not None:
            self.writer.scalar(self.name, m, step)
        self.values.clear()


class MetricsWriter:
    """jsonl + optional tensorboard sinks with meter reduction on
    flush. `logdir` None keeps no sink: the writer only takes part in the
    cross-process mean."""

    def __init__(self, logdir, use_tensorboard=True):
        self.logdir = logdir
        self._jsonl = self._tb = None
        self._meters = {}
        if logdir is None:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, 'metrics.jsonl'), 'a')
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(logdir)
            except ImportError:
                self._tb = None

    def meter(self, name):
        if name not in self._meters:
            self._meters[name] = Meter(name, self)
        return self._meters[name]

    def scalar(self, name, value, step):
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(
            {'t': time.time(), 'step': int(step), name: value}) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def image(self, name, img_uint8_hwc, step):
        if self.logdir is None:
            return
        out = os.path.join(self.logdir, 'images')
        os.makedirs(out, exist_ok=True)
        write_png(os.path.join(
            out, f'{name.replace("/", "_")}_{int(step):08d}.png'),
            img_uint8_hwc)
        if self._tb is not None:
            self._tb.add_image(name, img_uint8_hwc, step, dataformats='HWC')

    def flush_meters(self, step):
        """Mean every meter (sorted by name) and emit through the
        sinks."""
        names = sorted(self._meters)
        means = {}
        for n in names:
            m = self._meters[n].local_mean()
            if m is not None:
                means[n] = m
            self._meters[n].values.clear()
        for n, v in _cross_process_mean(names, means).items():
            self.scalar(n, v, step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
