"""The port's spans and counters, and its profiler trace.

Counterpart of `scenedreamer_tpu/utils/profiling.py` (reference
`train.py:129-151`, `trainers/base.py:876-940`), as one recorder:
  * `span(name, kind=None, reads=None, unit=None, tag=None)`: a context
    manager recording the host's time in a block: its name, start and
    end, its parent (the span open around it on the same thread), the
    thread, and the frame or step it belongs to. `kind='read'` marks a
    deliberate blocking read of the device: `reads` is what the block
    reads (a tensor, or a list, tuple or dict of them), whose values the
    recorder adds to the counter `host_reads` when it records the span.
    `tag` is one free label (a field chunk's route);
  * `begin_unit(kind, name)`: the root span `name` of the next frame or
    step (`kind` 'frame' or 'step'); the spans opened inside it on its
    thread carry its id, `.unit`. Inside a unit already open on the
    thread it opens nothing (`train_step`'s D and G steps are one step);
  * `upload(data, device)`: `torch.as_tensor` onto a device; a copy
    from pageable memory to a GPU waits for the device's queue, so it is
    a blocking span `upload` of kind 'upload' (its `values` the elements
    copied; not a read, so not in `host_reads`);
  * `count(name, n)`: adds `n` to a named counter;
  * `take()`: hands over what was recorded (and forgets it): the spans,
    completed, in the order they ended; the counters; each unit's kind.
    Nothing is written while the program runs;
  * `trace(logdir)`: a region profiled by `torch.profiler` (CPU and,
    where present, CUDA activity) with the recorder on, written as a
    Chrome trace `trace.json` under `logdir` (JAX's `jax.profiler`
    trace); the spans show in it.

The recorder is off by default. `enable()` and `disable()` switch it;
it is also on while a `torch.profiler` profile runs, as seen at the
start of each frame or step (`begin_unit`), so a profiled stretch of
frames or steps carries the spans whoever profiles it. What a profiler
alone switched on is kept for at most `KEEP_UNITS` units between two
`take()`s: the unit after that starts the record anew. Off, `span` is
one test of a flag that returns a shared object doing nothing (no
allocation, no clock, no `record_function`), `count` one test, and
`begin_unit` reads the profiler's state besides. On, each span enters
`torch.profiler.record_function(name)` and is stamped with
`time.time_ns()` just inside it: the profiler's events carry the same
clock (Unix-epoch nanoseconds, `start_ns()`, `trace_start_ns()`), so a
span is placed exactly against the device's activity. The recorder
never synchronises the device and reads nothing from it.

JAX's `annotate` is `span`; its `PhaseTimer` (a device barrier after
each phase) has no counterpart: `cli/train.py --speed-benchmark`
reports the spans' host times and the counters.
"""
import contextlib
import itertools
import threading
import time

import torch

# on: spans and counters are recorded. _HELD: `enable()` holds it on
# whether or not a profiler runs
_ON = False
_HELD = False
_LOCAL = threading.local()      # .stack: open spans; .unit: open unit id
_LOCK = threading.Lock()
_SPANS = []
_COUNTERS = {}
_UNITS = {}
_IDS = itertools.count(1)
# units kept between two `take()`s while only a profiler holds it on
KEEP_UNITS = 1000


class _Off:
    """The span of the recorder when off: does nothing."""
    __slots__ = ()
    unit = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded span (see the module docstring). `start_ns`,
    `end_ns`: `time.time_ns()`; `parent`: the id of the span open
    around it on its thread, or None; `unit`: its frame's or step's id,
    or None outside any; `values`: the values a read read or an upload
    copied (0 for other spans)."""
    __slots__ = ('name', 'kind', 'values', 'tag', 'id', 'parent', 'thread',
                 'unit', 'start_ns', 'end_ns', '_rf', '_root', '_reads')

    def __init__(self, name, kind, reads, unit, tag, root=False):
        self.name, self.kind, self.tag = name, kind, tag
        self.unit, self._root, self._reads = unit, root, reads
        self.values = 0

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_IDS)
        self.thread = threading.get_ident()
        if self._root:
            _LOCAL.unit = self.unit
        elif self.unit is None:
            self.unit = getattr(_LOCAL, 'unit', None)
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        _stack().pop()
        if self._root:
            _LOCAL.unit = None
        _SPANS.append(self)
        if self.kind == 'read':
            self.values = _n_values(self._reads)
            count('host_reads', self.values)
        self._reads = None
        return False

    @property
    def ms(self):
        return (self.end_ns - self.start_ns) / 1e6

    def __repr__(self):
        return (f'Span({self.name!r}, kind={self.kind!r}, id={self.id}, '
                f'parent={self.parent}, unit={self.unit}, ms={self.ms:.3f})')


def _stack():
    stack = getattr(_LOCAL, 'stack', None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _n_values(x):
    """The values of the tensors in `x` (a tensor, or a list, tuple or
    dict of them; anything else holds none)."""
    if torch.is_tensor(x):
        return x.numel()
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return 0
    return sum(_n_values(v) for v in x)


def span(name, kind=None, reads=None, unit=None, tag=None):
    """A recorded span around a block (see the module docstring); `unit`
    gives the frame or step explicitly (a frame's fetch, called after
    the next frame has begun)."""
    if not _ON:
        return _OFF
    return Span(name, kind, reads, unit, tag)


def begin_unit(kind, name):
    """The root span `name` of a new frame or step of `kind`, whose id
    (`.unit`) the spans inside carry; the shared do-nothing span when
    the recorder is off or a unit is already open on this thread. Turns
    the recorder on or off with a `torch.profiler` profile that started
    or stopped since (unless `enable()` holds it on); drops what was
    recorded when a profiler alone has kept it on for `KEEP_UNITS` units
    that nobody took."""
    global _ON
    _ON = _HELD or getattr(torch.autograd.profiler, '_is_profiler_enabled',
                           False)
    if not _ON or getattr(_LOCAL, 'unit', None) is not None:
        return _OFF
    if not _HELD and len(_UNITS) >= KEEP_UNITS:
        take()
    uid = next(_IDS)
    _UNITS[uid] = kind
    return Span(name, None, None, uid, None, root=True)


def upload(data, device, dtype=None, tag=None):
    """`torch.as_tensor(data, dtype, device)`. A copy from pageable host
    memory to a GPU waits until the device's queue has drained, so it is
    recorded as a span `upload` of kind 'upload' (its `values` the
    elements copied, `tag` what they are)."""
    if not _ON or torch.device(device).type == 'cpu' or (
            torch.is_tensor(data) and data.device.type != 'cpu'):
        return torch.as_tensor(data, dtype=dtype, device=device)
    with Span('upload', 'upload', None, None, tag) as s:
        t = torch.as_tensor(data, dtype=dtype, device=device)
        s.values = t.numel()
    return t


def count(name, n):
    """Add `n` to the counter `name`."""
    if not _ON:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def current():
    """The innermost span open on this thread, or None."""
    stack = getattr(_LOCAL, 'stack', None)
    return stack[-1] if stack else None


def enable():
    """Record spans and counters until `disable()`."""
    global _ON, _HELD
    _ON = _HELD = True


def disable():
    """Stop recording (a running profiler turns it on again at the next
    frame or step)."""
    global _ON, _HELD
    _ON = _HELD = False


def enabled():
    return _ON


def take():
    """What was recorded since the last `take()`: {'spans': [Span, ...]
    (completed, in the order they ended), 'counters': {name: total},
    'units': {unit id: kind}}; the recorder forgets it."""
    global _SPANS, _COUNTERS, _UNITS
    with _LOCK:
        out = {'spans': _SPANS, 'counters': _COUNTERS, 'units': _UNITS}
        _SPANS, _COUNTERS, _UNITS = [], {}, {}
    return out


@contextlib.contextmanager
def trace(logdir):
    """Profile a code region, with the recorder on, to
    `<logdir>/trace.json` (Chrome trace; view in Perfetto or
    chrome://tracing). The recorder is switched back as it was after."""
    import os
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    held = _HELD
    enable()
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        if not held:
            disable()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
