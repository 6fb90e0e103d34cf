"""Reads the control of a cell's comparison at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--flushes <n>]

For each seed, the control (`reference/control.py`: the reference with
the list order's guarantee broken) answers every call a run of the cell
would answer, in the program's place, and the benchmark's own judges
judge it.  Prints one JSON line per seed with the numbers compared; a
sound comparison reads `wrong_answers` above its limit, 0.  A keystroke
cell answers `--flushes` flushes (default: its warm-up and the flushes
`run_seconds` would draw ahead).  The benchmark's runs never run this.
"""

import argparse
import json
import math
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402
from benchmark.reference import control, judge  # noqa: E402


def read(cell, seed, n_flushes, workers):
    t = time.perf_counter()
    v = judge.run_judges(control.tasks(cell, seed, n_flushes, workers),
                         workers)
    return {'workload': cell.name, 'seed': seed,
            'wrong_answers': v.wrong, 'missing_answers': v.missing,
            'answers': v.answers, 'seconds': time.perf_counter() - t,
            'first_difference': v.note[:300]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--flushes', type=int)
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.Cell(spec, args.workload)
    traffic = cell.traffic
    n_flushes = args.flushes or (traffic.get('warmup_flushes', 0) + math.ceil(
        spec['run_seconds'] * traffic.get('prefill_per_s', 0)))
    workers = min(os.cpu_count() or 1, 8)
    for seed in args.seeds:
        print(json.dumps(read(cell, seed, n_flushes, workers)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
