"""Metric meters and experiment logging.

Counterpart of `scenedreamer_tpu/utils/meters.py` (reference
`imaginaire/utils/meters.py:76-149` Meter with mean reduction on flush,
`imaginaire/utils/logging.py:13-51` date-uid logdir): an always-on
`metrics.jsonl` sink with the JAX package's record layout
({'t', 'step', name: value}) and a tensorboard sink when
`torch.utils.tensorboard` imports; snapshot images also land as PNG
files under `<logdir>/images`. One process: the cross-process mean is
the identity (its `torch.distributed` form comes with multi-GPU
training).
"""
import datetime
import json
import os
import time

from scenedreamer_tpu_torch.utils.png import write_png


def make_logging_dir(logdir_root, config_name):
    """logs/<date>_<config> (`utils/logging.py:13-51`)."""
    date_uid = datetime.datetime.now().strftime('%Y_%m%d_%H%M_%S')
    logdir = os.path.join(logdir_root, f'{date_uid}_{config_name}')
    os.makedirs(logdir, exist_ok=True)
    return logdir


def _cross_process_mean(names, means):
    """Mean of the per-process meter means; one process, so `means`."""
    return means


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
    flush."""

    def __init__(self, logdir, use_tensorboard=True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, 'metrics.jsonl'), 'a')
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(logdir)
            except ImportError:
                self._tb = None
        self._meters = {}

    def meter(self, name):
        if name not in self._meters:
            self._meters[name] = Meter(name, self)
        return self._meters[name]

    def scalar(self, name, value, step):
        self._jsonl.write(json.dumps(
            {'t': time.time(), 'step': int(step), name: value}) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def image(self, name, img_uint8_hwc, step):
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
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
