"""Finding a cell's files by name, and the result line.

A cell of `BENCHMARK.json` names a configuration, whose file the entry
gives, and a traffic mix. Everything else is found by name:
  * the traffic mix: `traffic/<traffic>.json`, whose `driver` names the
    module `drivers/<driver>.py` that runs it (its `main(run)`);
  * the limits of the cell's correctness check: `limits/<workload>.json`;
  * a per-layer metric: `metrics/<metric name>.py`, whose `read(ctx)`
    returns the number or None when it finds nothing to read.
Each lookup searches the directories of `Bench.dirs` in order (this
folder, and in the tests a fixture folder before it), so a later cell,
mix or metric is new files and new entries, never an edit.
"""
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ('jax', 'jaxlib', 'flax', 'scenedreamer_tpu')


def banned_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one
    of BANNED, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names
                   if m.split('.')[0] in BANNED})


class Bench:
    """`BENCHMARK.json` and the folders its names resolve in."""

    def __init__(self, bench_json=None, root=ROOT, dirs=(HERE,)):
        self.root = root
        path = bench_json or os.path.join(root, 'BENCHMARK.json')
        with open(path) as f:
            self.spec = json.load(f)
        self.dirs = tuple(dirs)

    def find(self, sub, name, ext):
        for d in self.dirs:
            path = os.path.join(d, sub, name + ext)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f'no {sub}/{name}{ext} in {self.dirs}')

    def cell(self, workload):
        """(workload entry, configuration entry, configuration, traffic,
        limits) of a cell."""
        cells = {w['name']: w for w in self.spec['workloads']}
        if workload not in cells:
            raise KeyError(f'unknown workload {workload!r}; known: '
                           f'{sorted(cells)}')
        w = cells[workload]
        conf = {c['name']: c for c in self.spec['configs']}[w['config']]
        with open(os.path.join(self.root, conf['file'])) as f:
            config = json.load(f)
        with open(self.find('traffic', w['traffic'], '.json')) as f:
            traffic = json.load(f)
        with open(self.find('limits', workload, '.json')) as f:
            limits = json.load(f)
        return w, conf, config, traffic, limits

    def driver(self, traffic):
        return _load(self.find('drivers', traffic['driver'], '.py'))

    def metrics_for(self, workload, kind):
        """The cell's metric entries of `kind` ('end_to_end' or
        'per_layer'): those that list it, or list no cells and move an
        end-to-end metric the cell reports."""
        e2e = [m for m in self.spec['end_to_end']
               if workload in m.get('workloads', [workload])]
        if kind == 'end_to_end':
            return e2e
        names = {m['name'] for m in e2e}
        return [m for m in self.spec['per_layer']
                if (workload in m['workloads'] if 'workloads' in m
                    else m['moves'] in names)]

    def reader(self, metric):
        return _load(self.find('metrics', metric, '.py')).read


def _load(path):
    """Import a file by path (its name may hold dots)."""
    name = 'portbench_file_' + os.path.basename(path)[:-3].replace(
        '.', '_').replace('-', '_')
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def result_line(bench, workload, trace, out):
    """The result object of one run from the driver's `out` (a dict with
    'e2e' {name: value}, 'ctx' the per-layer readers' context, 'checks'
    [(name, value, limit)], 'attempted', 'failed', 'device'). A check
    passes when its value is at most its limit; `correct` is True when
    every check passes and nothing failed."""
    kind = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in bench.metrics_for(workload, kind):
        if trace:
            value = bench.reader(m['name'])(out['ctx'])
        else:
            value = out['e2e'].get(m['name'])
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    checks = out['checks']
    correct = bool(checks) and out['failed'] == 0 and all(
        passes(v, lim) for _, v, lim in checks)
    line = {'correct': correct, 'attempted': out['attempted'],
            'failed': out['failed'], 'metrics': metrics,
            'device': out['device']}
    if trace:
        t = out['ctx'].trace
        line['breakdown'] = t.breakdown if t else {'device_ops': [],
                                                   'idle_gaps': []}
    line['checks'] = {name: {'value': v, 'limit': lim}
                      for name, v, lim in checks}
    return line


def passes(value, limit):
    """A compared number passes when it is a number (not None or NaN) at
    most its limit."""
    return value is not None and value == value and value <= limit


def check_lines(checks):
    return [f'check {name}: {v!r} (limit {lim!r}) '
            f'{"ok" if passes(v, lim) else "FAIL"}'
            for name, v, lim in checks]
