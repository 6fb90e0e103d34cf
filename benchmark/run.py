"""Runs one cell of the port's benchmark and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds `automerge_tpu_torch`.  The cell
is an entry of `workloads` in `BENCHMARK.json`; its configuration, its
traffic mix, the loop that drives its window and its metrics are files
found by name (`harness.py`).  A run:

1. fails, printing no result, unless CUDA has as many cards as the cell
   asks for: the program under test is `automerge_tpu_torch.native.
   make_pool('cuda')`, and there is no fallback to the CPU;
2. sets up (inputs drawn from `--seed`, the C++ core and the CUDA
   kernels built or loaded, every shape of the traffic warmed up):
   `setup_s` runs from the first statement here to the first timed call;
3. drives the window for `--seconds`, closed loop; with `--trace 1`
   under `torch.profiler`, with the port's span tracing on;
4. reads the device's memory peak, frees the program's state, and judges
   every answer against the plain reference (`reference/`) in worker
   processes;
5. fails if a JAX module or the JAX package is loaded, and otherwise
   prints the numbers compared, with their limits, as its last lines on
   standard error, and the result as one JSON line on standard output.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import devtrace, harness, hostref  # noqa: E402

#: kernel and compiler caches of the run, at fixed places in the checkout
CACHE_DIRS = {'TRITON_CACHE_DIR': 'triton',
              'TORCH_EXTENSIONS_DIR': 'torch_extensions',
              'CUDA_CACHE_PATH': 'cuda'}


class Run:
    """One run of one cell: what the loop measured and what the judges
    found."""

    def __init__(self, cell, seed, seconds, trace, device, make_pool=None,
                 t0=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace = trace
        self.device = device
        self._make_pool = make_pool
        self.t0 = _T0 if t0 is None else t0
        self.setup_s = None
        self.window_start = self.window_end = None
        self.latencies = []
        self.attempted = self.failed = 0
        self.work = {}
        self.spans, self.counters = {}, {}
        self.profile = self.breakdown = None
        self.device_info = {}
        self.verdict = None
        self.judge_s = None
        self.cpu_s = None       # process CPU seconds over the window

    # -- the program ------------------------------------------------------

    def load_runtime(self):
        from automerge_tpu_torch import native
        native.load_runtime(self.device)

    def make_pool(self):
        if self._make_pool is not None:
            return self._make_pool(self.device)
        from automerge_tpu_torch.native import make_pool
        return make_pool(self.device)

    # -- the window -------------------------------------------------------

    def more(self):
        """Whether another call starts: the first opens the window."""
        now = time.perf_counter()
        if self.window_start is None:
            self.window_start = now
            self.setup_s = now - self.t0
            return True
        return now - self.window_start < self.seconds

    def timed(self, fn, *args):
        """One timed call; its result, or None where it raised."""
        self.attempted += 1
        t = time.perf_counter()
        try:
            if self.trace:
                import torch
                with torch.profiler.record_function(devtrace.CALL_RANGE):
                    out = fn(*args)
            else:
                out = fn(*args)
        except Exception as e:  # a failed call is counted, not fatal
            print('call %d failed: %s: %s' % (self.attempted,
                                              type(e).__name__, e),
                  file=sys.stderr)
            self.failed += 1
            out = None
        end = time.perf_counter()
        self.latencies.append(end - t)
        self.window_end = end
        return out

    @property
    def window_s(self):
        return self.window_end - self.window_start

    # -- the verdict ------------------------------------------------------

    def checks(self):
        v = self.verdict
        return {'wrong_answers': {'value': v.wrong, 'limit': 0},
                'missing_answers': {'value': v.missing, 'limit': 0},
                'failed_calls': {'value': self.failed, 'limit': 0}}

    def correct(self):
        return all(c['value'] <= c['limit'] for c in self.checks().values())


def _snapshot(trace_mod, telemetry):
    snap = trace_mod.snapshot()
    counters = dict(snap['metrics'])
    for name, v in telemetry.phase_snapshot().items():
        counters[name] = counters.get(name, 0) + v['n']
    return snap['spans'], counters


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def run_cell(cell, seed, seconds, trace, device, make_pool=None, t0=None,
             workers=None):
    """Sets up, drives and judges one run; returns (Run, metrics)."""
    import torch

    from automerge_tpu_torch import telemetry
    from automerge_tpu_torch import trace as trace_mod
    from benchmark.reference import judge

    device = torch.device(device)
    run = Run(cell, seed, seconds, trace, device, make_pool, t0)
    loop = cell.loop()
    on_card = device.type == 'cuda'
    if trace:
        telemetry.enable()
    st = loop.setup(run)
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.synchronize(device)
    spans0, counters0 = _snapshot(trace_mod, telemetry)
    prof = devtrace.start() if trace and on_card else None
    cpu0 = hostref.cpu_s()
    loop.window(run, st)
    run.cpu_s = hostref.cpu_s() - cpu0
    if prof is not None:
        devtrace.stop(prof)
    spans1, counters1 = _snapshot(trace_mod, telemetry)
    if trace:
        telemetry.disable()
    run.spans = _delta(spans1, spans0)
    run.counters = _delta(counters1, counters0)
    run.device_info = {'platform': 'gpu' if on_card else device.type,
                       'kind': torch.cuda.get_device_name(device)
                       if on_card else device.type,
                       'count': cell.chips,
                       'memory_peak_bytes': torch.cuda.max_memory_allocated(
                           device) if on_card else 0}
    loop.release(run, st)
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if prof is not None:
        kernels = devtrace.port_kernel_names(os.path.join(
            os.path.dirname(os.path.abspath(
                sys.modules['automerge_tpu_torch'].__file__)), 'csrc'))
        run.profile = devtrace.summarize(devtrace.events_of(prof), kernels)
        del prof
        if run.profile is not None:
            run.device_info['busy_s'] = run.profile['busy_s']
            run.device_info['window_s'] = run.profile['window_s']
            run.breakdown = {'device_ops': run.profile['device_ops'],
                             'idle_gaps': run.profile['idle_gaps']}
    workers = workers or min(os.cpu_count() or 1, 8)
    t_judge = time.perf_counter()
    run.verdict = judge.run_judges(loop.judge_tasks(run, st, workers),
                                   workers)
    run.judge_s = time.perf_counter() - t_judge
    metrics = harness.read_metrics(cell, run, trace)
    return run, metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_spec(), args.workload)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(_ROOT, 'build', 'benchmark', sub)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print('%s needs %d CUDA device(s); this machine has %d' % (
            cell.name, cell.chips,
            torch.cuda.device_count() if torch.cuda.is_available() else 0),
            file=sys.stderr)
        return 2
    run, metrics = run_cell(cell, args.seed, args.seconds, args.trace,
                            'cuda')
    barred = harness.barred_modules()
    if barred:
        print('barred modules loaded: %s' % ', '.join(barred),
              file=sys.stderr)
        return 3
    line = harness.result_line(run, metrics)
    print('setup %.3f s, window %.3f s, judges %.3f s, %d answers judged'
          % (run.setup_s, run.window_s, run.judge_s, run.verdict.answers),
          file=sys.stderr)
    if run.verdict.note:
        print('first difference: %s' % run.verdict.note, file=sys.stderr)
    for name, c in run.checks().items():
        print('%s %s limit %s' % (name, c['value'], c['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
