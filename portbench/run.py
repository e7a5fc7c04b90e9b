"""Run one cell of the benchmark of `scenedreamer_tpu_torch` once.

    python portbench/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

Finds the cell in `BENCHMARK.json` and its files by name (`harness.py`),
checks that the card holds the cell's chips, runs the traffic's driver
(set-up, a window of `--seconds`, the check against the plain
reference), and prints the comparisons on standard error and, as the
last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number compared beside its limit. A cell on several chips
runs one process per chip (NCCL over localhost; rank 0 prints). Exits
with code 2 and prints no result without the chips the cell asks for,
or when JAX, flax or the JAX package is loaded, in any rank's process,
once the window has closed. Builds stay in the checkout, each at a fixed
path, so only a checkout's first run makes them: the program's kernels
in its own `scenedreamer_tpu_torch/_build/`; under `portbench/_cache/`
the worlds,
Python's bytecode (`pycache`: where the installed packages' bytecode
cannot be written, every process compiles PyTorch's ~1,900 modules
again, ~10 s), and anything PyTorch or Triton would compile.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, '_cache')

import argparse  # noqa: E402
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


class Run:
    """One process's part of a run: the cell's files, the device, and the
    set-up clock and trace hooks a driver calls."""

    def __init__(self, bench, args, device, rank=0, world_size=1,
                 t_start=None, world_cache=None):
        import torch
        self.workload = args.workload
        _, _, self.config, self.traffic, self.limits = \
            bench.cell(args.workload)
        self.seed, self.seconds = int(args.seed), float(args.seconds)
        self.trace = bool(int(args.trace))
        self.device = torch.device(device)
        self.rank, self.world_size = rank, world_size
        self.t_start = T_START if t_start is None else t_start
        self.world_cache = world_cache
        self.setup_s = None
        self.last_trace = self.current_trace = None
        self.traced_s = 0.0

    def sync(self):
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def log(self, what):
        """A line on standard error: seconds since the process started."""
        if self.rank == 0:
            print(f'[portbench] {time.perf_counter() - self.t_start:8.2f} s '
                  f'{what}', file=sys.stderr, flush=True)

    def setup_done(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        self.log('set-up done')

    def open_trace(self):
        """Start profiling a part of the window."""
        from portbench.trace import Trace
        self._trace_t0 = time.perf_counter()
        self.current_trace = Trace(self.device).__enter__()
        return self.current_trace

    def mark(self, name):
        """The host enters phase `name` (recorded in an open trace)."""
        if self.current_trace is not None:
            self.current_trace.mark(name)

    def close_trace(self):
        """Stop profiling; `traced_s` is the host time the traced part
        took, profiler start and stop included."""
        self.current_trace.__exit__(None, None, None)
        self.last_trace, self.current_trace = self.current_trace, None
        self.traced_s = time.perf_counter() - self._trace_t0

    def reduce_trace(self):
        """Read the trace, once the window has closed."""
        if self.last_trace is not None:
            self.last_trace.reduce()
        return self.last_trace

    def memory_peak(self):
        import torch
        self.sync()
        if self.device.type != 'cuda':
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', required=True, type=int)
    p.add_argument('--seconds', required=True, type=float)
    p.add_argument('--trace', type=int, default=0, choices=(0, 1))
    return p.parse_args(argv)


def finish(bench, run, out, found):
    """Print the comparisons and the result line (rank 0), or refuse to
    when `found` ({rank: banned modules it holds}) names any. Returns the
    exit code."""
    import json
    if found:
        print(f'refused: loaded {found}', file=sys.stderr, flush=True)
        return 2
    out['e2e']['setup_s'] = run.setup_s
    out['device']['memory_peak_bytes'] = out.pop('memory_peak_bytes')
    if run.trace:
        t = out['ctx'].trace
        out['device']['busy_s'] = out.pop('busy_s', t.busy_s if t else 0.0)
        out['device']['window_s'] = out.pop('window_s',
                                            t.window_s if t else 0.0)
    line = harness.result_line(bench, run.workload, run.trace, out)
    for text in harness.check_lines(out['checks']):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def device_info(device, count):
    import subprocess
    import torch
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': count}
    limit = ''
    try:
        limit = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.split('\n')[0].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': count, 'power_limit': limit}


def run_one(args, bench, rank=0, world_size=1, t_start=None, device=None,
            world_cache=None):
    """The whole run in this process: rank `rank` of `world_size` (whose
    process group is set up), on CUDA device `rank` unless `device` says
    otherwise (the CPU tests run the tiny cells so, with `world_cache`).
    Rank 0 prints; returns the exit code. Once the window has closed
    every rank looks for banned modules in its own process, and rank 0
    refuses when any rank holds one."""
    import torch
    device = torch.device(device or f'cuda:{rank}')
    run = Run(bench, args, device, rank, world_size, t_start, world_cache)
    out = bench.driver(run.traffic).main(run)
    mine = harness.banned_modules()
    if world_size > 1:
        from portbench.ranks import host_gather
        found = {r: f for r, f in enumerate(host_gather(mine)) if f}
    else:
        found = {0: mine} if mine else {}
    if rank != 0:
        if mine:
            print(f'rank {rank} refused: loaded {mine}', file=sys.stderr,
                  flush=True)
        return 2 if found else 0
    out['device'] = device_info(device, world_size)
    return finish(bench, run, out, found)


def _rank_main(rank, world, device, args, t_start):
    return run_one(args, harness.Bench(), rank, world, t_start, device)


def checkout_caches():
    """Point this process's and its children's caches into the checkout,
    before anything imports PyTorch."""
    os.environ['PYTHONPYCACHEPREFIX'] = os.path.join(CACHE, 'pycache')
    os.environ.pop('PYTHONDONTWRITEBYTECODE', None)
    sys.pycache_prefix = os.environ['PYTHONPYCACHEPREFIX']
    sys.dont_write_bytecode = False
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
    os.environ['USE_FLAX'] = '0'


def main(argv=None):
    checkout_caches()
    args = parse(argv)
    bench = harness.Bench()
    chips = int(bench.cell(args.workload)[0]['chips'])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'refused: the cell needs {chips} CUDA device(s); '
              f'available {torch.cuda.is_available()}, count '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    if chips == 1:
        return run_one(args, bench)
    from portbench.ranks import spawn
    return max(spawn(_rank_main, chips, (args, T_START)))


if __name__ == '__main__':
    sys.exit(main())
