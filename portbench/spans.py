"""Readings of the program's own spans and counters
(`scenedreamer_tpu_torch/utils/profiling.py`) for the per-layer metrics.

The program's recorder is on while a `torch.profiler` profile runs, as
seen at the start of each frame or step: under `--trace 1` it records the
traced frames or steps (`Trace` profiles them), and under `--trace 0`
nothing. After the window a metric reads what it recorded through
`taken(ctx)`: the first reader of a run takes it from the program, the
others share it. A program without the recorder gives nothing, and every
reading is None.

The reductions, each over the frame or step units of one `kind`
('frame' or 'step') whose root span is `root` ('render.frame',
'train.step'):
  * `read_ms_per_unit`: host ms per unit in the spans that wait on the
    device's queue inside the units' roots: the reads (kind 'read') and
    the uploads from pageable memory (kind 'upload');
  * `counter_per_unit`: a counter's total per unit.
"""
# the kinds of span that wait on the device's queue
WAITS = ('read', 'upload')


def taken(ctx):
    """What the program recorded in this run ({'spans', 'counters',
    'units'}, `profiling.take()`), or None from a program without the
    recorder."""
    if not hasattr(ctx, 'program_spans'):
        from scenedreamer_tpu_torch.utils import profiling
        take = getattr(profiling, 'take', None)
        ctx.program_spans = take() if take is not None else None
    return ctx.program_spans


def _units(t, kind):
    return {u for u, k in t['units'].items() if k == kind}


def _inside(t, kind, root):
    """The spans nested in the root spans of the units of `kind`."""
    units = _units(t, kind)
    by_id = {s.id: s for s in t['spans']}
    roots = {s.id for s in t['spans'] if s.name == root and s.unit in units}
    out = []
    for s in t['spans']:
        p = s.parent
        while p is not None and p not in roots:
            p = by_id[p].parent if p in by_id else None
        if p is not None:
            out.append(s)
    return out


def read_ms_per_unit(t, kind, root):
    """Host ms per unit of `kind` in read and upload spans inside its
    root, or None without units."""
    n = len(_units(t, kind)) if t else 0
    if not n:
        return None
    return sum(s.ms for s in _inside(t, kind, root) if s.kind in WAITS) / n


def counter_per_unit(t, name, kind):
    """Counter `name`'s total per unit of `kind`, or None without units or
    without the counter."""
    n = len(_units(t, kind)) if t else 0
    if not n or name not in t['counters']:
        return None
    return t['counters'][name] / n
