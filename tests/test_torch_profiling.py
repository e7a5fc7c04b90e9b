"""The port's span and counter recorder (`utils/profiling.py`) on the CPU:
the off path, nesting, threads, frame and step units, counters, a
running profiler switching it on, and its clock against the profiler's
own events. The spans of `frame_async`, of the training step and of the
gradient exchange are tested beside their fixtures
(`test_torch_pipeline.py`, `test_torch_train.py`,
`test_torch_parallel.py`)."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from scenedreamer_tpu_torch.utils import profiling as P


@pytest.fixture(autouse=True)
def fresh():
    """Every test starts and ends with the recorder off and empty."""
    P.disable()
    P.take()
    yield
    P.disable()
    P.take()


def test_off_path_records_nothing_and_shares_one_object(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError('the off path read a clock or entered '
                             'record_function')
    monkeypatch.setattr(P.time, 'time_ns', boom)
    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    a = P.span('a')
    b = P.span('b', kind='read', reads=torch.ones(3), unit=7, tag='full')
    assert a is b and P.begin_unit('step', 'train.step') is a
    with a as s:
        assert s.unit is None
    P.count('host_reads', 5)
    assert not P.enabled() and P.current() is None
    before = sys.getallocatedblocks()
    for _ in range(10000):
        with P.span('x', kind='read', reads=a):
            P.count('y', 1)
    assert sys.getallocatedblocks() - before < 100
    got = P.take()
    assert got == {'spans': [], 'counters': {}, 'units': {}}


def test_nesting_parents_threads_and_units():
    P.enable()
    with P.begin_unit('step', 'train.step') as root:
        assert P.current() is root and root.unit is not None
        # a unit inside a unit opens nothing
        with P.begin_unit('step', 'train.step') as nested:
            assert P.current() is root and nested.unit is None
        with P.span('train.dis_update') as outer:
            with P.span('backward') as inner:
                assert P.current() is inner
        other = {}

        def work():
            with P.span('worker') as s:
                other['span'] = s
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    with P.span('render.fetch', kind='read', unit=root.unit) as late:
        pass
    with P.span('outside') as outside:
        pass
    got = P.take()
    names = [s.name for s in got['spans']]
    assert names == ['backward', 'train.dis_update', 'worker', 'train.step',
                     'render.fetch', 'outside']
    assert got['units'] == {root.unit: 'step'}
    assert root.parent is None and outer.parent == root.id
    assert inner.parent == outer.id
    assert outer.unit == inner.unit == late.unit == root.unit
    assert outside.unit is None and outside.parent is None
    w = other['span']
    assert w.thread != root.thread and w.parent is None and w.unit is None
    assert inner.thread == root.thread == threading.get_ident()
    for s in got['spans']:
        assert 0 < s.start_ns <= s.end_ns
    assert root.start_ns <= outer.start_ns <= inner.start_ns
    assert inner.end_ns <= outer.end_ns <= root.end_ns
    # units are numbered anew
    with P.begin_unit('frame', 'render.frame') as second:
        pass
    assert second.unit != root.unit
    assert P.take()['units'] == {second.unit: 'frame'}


def test_counters_and_reads():
    """A read span adds the values of the tensors it reads (a tensor, or a
    list, tuple or dict of them; host values hold none) to `host_reads`
    when it ends; other spans count nothing."""
    P.enable()
    P.count('allreduce_bytes', 400)
    P.count('allreduce_bytes', 12)
    with P.span('clip_read', kind='read', reads=torch.tensor(2.0)) as clip:
        pass
    metrics = {'a': torch.tensor(1.0), 'b': 0.5, 'c': [torch.ones(2, 2)]}
    with P.span('metrics_read', kind='read', reads=metrics) as read:
        pass
    with P.span('render.field_chunk', tag='compacted',
                reads=torch.ones(9)) as chunk:
        pass
    got = P.take()
    assert got['counters'] == {'allreduce_bytes': 412, 'host_reads': 6}
    assert (clip.values, read.values, chunk.values) == (1, 5, 0)
    assert chunk.tag == 'compacted' and chunk.kind is None
    assert P.take()['counters'] == {}


def test_upload_to_the_host_records_nothing():
    """`upload` is `torch.as_tensor`; only a copy from host memory to a GPU
    (a card test) is a read span."""
    P.enable()
    t = P.upload([[1, 0], [0, 1]], torch.device('cpu'), tag='bits')
    f = P.upload(np.arange(3.0), 'cpu', torch.float32)
    assert t.dtype == torch.int64 and t.tolist() == [[1, 0], [0, 1]]
    assert f.dtype == torch.float32 and f.tolist() == [0.0, 1.0, 2.0]
    assert P.take() == {'spans': [], 'counters': {}, 'units': {}}


def test_a_running_profiler_switches_it_at_the_next_unit():
    from torch.profiler import ProfilerActivity, profile
    with P.begin_unit('step', 'train.step'):
        pass
    assert not P.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        with P.begin_unit('step', 'train.step') as root:
            with P.span('train.render'):
                pass
    assert P.enabled()          # seen again at the next unit
    with P.begin_unit('step', 'train.step') as off:
        with P.span('train.render'):
            pass
    assert not P.enabled() and off.unit is None
    got = P.take()
    assert [s.name for s in got['spans']] == ['train.render', 'train.step']
    assert got['units'] == {root.unit: 'step'}


def test_a_profiler_alone_keeps_a_bounded_record(monkeypatch):
    """Switched on by a profiler alone, the recorder keeps at most
    `KEEP_UNITS` units that nobody took: the next starts it anew.
    `enable()` holds everything until `take()`. A torch without the
    profiler's flag leaves the recorder off."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(P, 'KEEP_UNITS', 3)
    with profile(activities=[ProfilerActivity.CPU]):
        roots = []
        for _ in range(5):
            with P.begin_unit('frame', 'render.frame') as root:
                roots.append(root.unit)
    got = P.take()
    assert sorted(got['units']) == roots[3:]
    assert [s.unit for s in got['spans']] == roots[3:]
    P.enable()
    for _ in range(5):
        with P.begin_unit('frame', 'render.frame'):
            pass
    assert len(P.take()['units']) == 5
    P.disable()
    monkeypatch.delattr(torch.autograd.profiler, '_is_profiler_enabled')
    with P.begin_unit('frame', 'render.frame') as off:
        pass
    assert off.unit is None and not P.enabled()


def _clock_gaps():
    """{span name: (start gap, end gap) in ns} of spans against their
    `record_function` events, in one profiled stretch after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    P.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with P.span('warm'):
                torch.ones(4).sum()
        P.take()
        for i in range(5):
            with P.span(f'span{i}'):
                with P.span(f'inner{i}', kind='read'):
                    torch.ones(64).sum()
                time.sleep(0.001)
    spans = {s.name: s for s in P.take()['spans']}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in spans}
    assert set(events) == set(spans)
    return {n: (s.start_ns - events[n].start_ns(),
                s.end_ns - events[n].start_ns() - events[n].duration_ns())
            for n, s in spans.items()}


def test_spans_sit_on_the_profilers_clock():
    """After a warm-up, each span's start lies within 50 us of its
    `record_function` event's `start_ns()` in the profiler's results,
    and its end within 200 us of the event's end. A stretch is measured
    again (up to three times) where the host was descheduled inside
    one: an offset of the clocks fails every stretch."""
    for _ in range(3):
        gaps = _clock_gaps()
        worst = max(max(abs(a), abs(b) / 4) for a, b in gaps.values())
        if worst < 50_000:
            break
    assert worst < 50_000, gaps
