"""CPU tests of the readings of the program's spans and counters
(`portbench/spans.py` and the metrics that read them): synthetic spans
with known answers for every reading, a program without the recorder
reading None, and the tiny cells: `--trace 0` leaves the recorder off,
`--trace 1` reports the new metrics. On a card, the spans' clock against
the device's idle intervals in a `Trace`."""
import json
import os
import time
from types import SimpleNamespace

import pytest

import pb_support as S

from portbench import harness

MS = 1_000_000      # ns


def _span(sid, name, start, end, parent=None, unit=None, kind=None):
    """A recorded span (times in ms from 0, stored in ns)."""
    return SimpleNamespace(id=sid, name=name, kind=kind, parent=parent,
                           unit=unit, start_ns=start * MS, end_ns=end * MS,
                           ms=end - start)


def _frames():
    """Two frames (units 1, 2) of 10 ms: each root holds rays (with a
    0.5 ms camera upload), a 2 ms hit-count read and a chunk; a fetch
    read of 1 ms outside each root; one gap of the benchmark loop between
    them (no span)."""
    sp = []
    for u, t in ((1, 0), (2, 20)):
        r = 10 * u
        sp += [_span(r + 5, 'upload', t, t + 0.5, r + 1, u, 'upload'),
               _span(r + 1, 'render.rays', t, t + 1, r, u),
               _span(r + 2, 'render.hit_counts', t + 1, t + 3, r, u, 'read'),
               _span(r + 3, 'render.field_chunk', t + 3, t + 9, r, u),
               _span(r, 'render.frame', t, t + 10, None, u),
               _span(r + 4, 'render.fetch', t + 12, t + 13, None, u, 'read')]
    return {'spans': sp, 'counters': {'host_reads': 8},
            'units': {1: 'frame', 2: 'frame'}}


def _steps(n=2):
    """n steps of 100 ms: two updates, each with a 1 ms `clip_read` and a
    2 ms `metrics_read` and an exchange entered at 30 and 70 ms past the
    step's start; 400 MB all-reduced a step."""
    sp, sid = [], 1000
    for u in range(1, n + 1):
        t, root = 100 * (u - 1), sid
        sp.append(_span(root, 'train.step', t, t + 100, None, u))
        for e in (30, 70):
            sid += 4
            sp += [_span(sid + 1, 'mesh.all_mean', t + e, t + e + 5, sid,
                         u),
                   _span(sid + 2, 'clip_read', t + e + 6, t + e + 7, sid, u,
                         'read'),
                   _span(sid + 3, 'metrics_read', t + e + 8, t + e + 10,
                         sid, u, 'read'),
                   _span(sid, 'train.dis_update', t + e - 5, t + e + 10,
                         root, u)]
        sid += 10
    return {'spans': sp, 'counters': {'allreduce_bytes': 400e6 * n,
                                      'allreduce_calls': 2 * n},
            'units': {u: 'step' for u in range(1, n + 1)}}


def _read(metric, taken):
    ctx = SimpleNamespace(program_spans=taken)
    return harness.Bench().reader(metric)(ctx)


@pytest.mark.parametrize('metric,taken,want', [
    ('read_wait_ms.serve', _frames(), 2.5),         # the fetch is outside
    ('read_wait_ms.train', _steps(), 6.0),
    ('allreduce_mb.dp4', _steps(), 400.0),
    ('read_wait_ms.serve', {'spans': [], 'counters': {}, 'units': {}},
     None),
    ('allreduce_mb.dp4', {'spans': [], 'counters': {},
                          'units': {1: 'step'}}, None),
    ('read_wait_ms.train', None, None)])            # no recorder
def test_metrics_read_the_spans(metric, taken, want):
    got = _read(metric, taken)
    assert got == (None if want is None else pytest.approx(want))


def test_trace_0_leaves_the_recorder_off_and_trace_1_reads_it(tmp_path):
    """A tiny serving run with `--trace 0` records nothing (the recorder
    stays off); with `--trace 1` the traced frames are recorded and the
    new metric reads them."""
    from scenedreamer_tpu_torch.utils import profiling
    profiling.disable()
    profiling.take()
    code, line, err = S.run_tiny(str(tmp_path), 'tiny.serve', trace=0)
    assert code == 0, err
    assert not profiling.enabled()
    assert profiling.take() == {'spans': [], 'counters': {}, 'units': {}}
    assert 'read_wait_ms.serve' not in line['metrics']
    code, line, err = S.run_tiny(str(tmp_path), 'tiny.serve', trace=1)
    assert code == 0, err
    assert line['metrics']['read_wait_ms.serve']['value'] > 0
    assert line['metrics']['read_wait_ms.serve']['unit'] == 'ms'
    profiling.disable()
    profiling.take()


def _traced_rank(rank, world, device, tmp):
    """A rank of a traced tiny data-parallel run (gloo)."""
    import contextlib
    import io
    from portbench import run as R
    bench = harness.Bench(os.path.join(tmp, 'BENCHMARK.json'),
                          root=S.ROOT, dirs=(S.FIX, S.PB))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = R.run_one(S._args('tiny.dp', 2 ** 31 + 7, 2.0, 1), bench,
                         rank, world, device=device,
                         world_cache=os.path.join(tmp, 'worlds'))
    if rank == 0:
        with open(os.path.join(tmp, 'rank0.out'), 'w') as f:
            f.write(out.getvalue())
    return code


def test_traced_ranks_report_the_exchange(tmp_path):
    """Two gloo ranks of the tiny data-parallel cell under `--trace 1`:
    rank 0 reports the bytes it all-reduced a traced step (the tiny
    generator's and discriminator's gradients, the metrics and D's
    buffers, in float32) and its reads."""
    from portbench.ranks import spawn
    tmp = str(tmp_path)
    S.tiny_bench(tmp)
    codes = spawn(_traced_rank, 2, (tmp,), device='cpu', timeout=900)
    assert codes == [0, 0]
    with open(os.path.join(tmp, 'rank0.out')) as f:
        line = json.loads(f.read().strip().splitlines()[-1])
    m = line['metrics']
    assert m['allreduce_mb.dp4']['value'] > 0
    assert m['read_wait_ms.train']['value'] > 0


def _idle_ns(prof):
    """The gaps between the union of a finished profile's device events
    [(start_ns, end_ns)], on the Unix-epoch clock of its events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    busy = []
    for a, b in sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in prof.profiler.kineto_results.events()
                       if e.device_type() == cuda):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]


def test_spans_hold_the_device_idle_of_a_wait():
    """On a card: a span around a 2 ms wait of the host between two
    kernels lies inside the device's idle interval there in a `Trace`
    (CUDA activity only), on the profiler's own clock, and the interval
    outruns it by under 0.1 ms at each end, the median over 9 waits after
    one to warm up. The host waits spinning (on the first kernel's
    event, then for 2 ms), as a host-bound program is busy; a single
    wait's ends can lie further out where the host was taken off its
    core (up to ~0.2 ms seen on an H100 machine's shared cores)."""
    import statistics
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (the device trace has no CPU mode)')
    from portbench.trace import Trace
    from scenedreamer_tpu_torch.utils import profiling

    def spin(seconds):
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            pass
    x = torch.zeros(1 << 20, device='cuda')
    x.add_(1.0)
    torch.cuda.synchronize()
    profiling.enable()
    profiling.take()
    try:
        with Trace(torch.device('cuda')) as trace:
            for _ in range(10):
                x.add_(1.0)
                done = torch.cuda.Event()
                done.record()
                while not done.query():
                    pass
                with profiling.span('wait'):
                    spin(0.002)
                x.add_(1.0)
        waits = [s for s in profiling.take()['spans'] if s.name == 'wait']
    finally:
        profiling.disable()
    idle = _idle_ns(trace.prof)
    gaps = []
    for s in waits:
        (a, b), = [(a, b) for a, b in idle
                   if a < s.end_ns and b > s.start_ns]
        gaps.append(((s.start_ns - a) / 1e3, (b - s.end_ns) / 1e3))
    assert len(gaps) == 10
    assert all(g >= 0 for pair in gaps for g in pair), gaps
    assert statistics.median(g for g, _ in gaps[1:]) < 100, gaps
    assert statistics.median(g for _, g in gaps[1:]) < 100, gaps
