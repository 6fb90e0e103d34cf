"""What every cell shares: finding a cell, its configuration, its traffic
and its metrics by name, and the result line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name `BENCHMARK.json` gives:

* configuration `<c>`: the JSON file its entry names (`file`);
* traffic mix `<t>`: `benchmark/traffic/<t>.json`, whose `loop` names
  the loop that drives the timed window, `benchmark/loops/<loop>.py`;
* metric `<m>`: `benchmark/metrics/<m>.py`, whose `read(run)` returns
  the number or None where it finds nothing to read; where there is no
  such file, `benchmark/metrics/<base>.py`, `<base>` being the name
  before its first dot (one reader for `kernel_ms.catchup` and
  `kernel_ms.edit`).

So a later change adds a cell, a mix or a metric as new files and new
entries, and edits no file that is here.
"""

import importlib.util
import json
import os
import sys

from benchmark import stats

#: the benchmark's folder and the root of the checkout holding it
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

#: top-level module names no process of the benchmark may hold
BARRED = ('jax', 'jaxlib', 'flax', 'automerge_tpu')


class Cell:
    """One entry of `workloads`, with its configuration and traffic
    read."""

    def __init__(self, spec, name, root=ROOT):
        cells = {w['name']: w for w in spec['workloads']}
        if name not in cells:
            raise SystemExit('no workload %r in BENCHMARK.json (there are '
                             '%s)' % (name, ', '.join(sorted(cells))))
        self.spec = spec
        self.root = root
        self.entry = cells[name]
        self.name = name
        configs = {c['name']: c for c in spec['configs']}
        self.config_entry = configs[self.entry['config']]
        self.config = _read_json(os.path.join(root,
                                              self.config_entry['file']))
        self.traffic = _read_json(os.path.join(
            root, 'benchmark', 'traffic', self.entry['traffic'] + '.json'))
        self.chips = int(self.entry['chips'])

    def metrics(self, trace):
        """The metric entries this cell reports: the end-to-end ones with
        `trace` 0, the per-layer ones with `trace` 1."""
        key = 'per_layer' if trace else 'end_to_end'
        return [m for m in self.spec[key]
                if self.name in m.get('workloads', [self.name])]

    def loop(self):
        return load_module('loops', self.traffic['loop'], self.root)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def load_spec(root=ROOT):
    return _read_json(os.path.join(root, 'BENCHMARK.json'))


def load_module(kind, name, root=ROOT):
    """`benchmark/<kind>/<name>.py` as a module (a name may hold dots)."""
    path = os.path.join(root, 'benchmark', kind, name + '.py')
    if not os.path.exists(path):
        raise SystemExit('no %s file %s' % (kind, path))
    spec = importlib.util.spec_from_file_location(
        'benchmark_%s_%s' % (kind, name.replace('.', '_')), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name, root=ROOT):
    """The module that reads metric `name`: its own file, or else the
    file of the name before its first dot."""
    own = os.path.join(root, 'benchmark', 'metrics', name + '.py')
    if not os.path.exists(own) and '.' in name:
        name = name.split('.', 1)[0]
    return load_module('metrics', name, root)


def read_metrics(cell, run, trace):
    """{name: {'value', 'unit'}} of every metric of the cell that its
    reader found."""
    out = {}
    for m in cell.metrics(trace):
        value = metric_reader(m['name'], cell.root).read(run)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def barred_modules():
    """Modules in this process whose top-level name is barred."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.', 1)[0] in BARRED)


def result_line(run, metrics):
    """The last line of standard output: the keys the contract asks for,
    the counters and spans read, and the numbers compared with their
    limits last."""
    line = {'correct': run.correct(), 'attempted': run.attempted,
            'failed': run.failed, 'metrics': metrics,
            'device': run.device_info}
    if run.breakdown is not None:
        line['breakdown'] = run.breakdown
    line['work'] = run.work
    line['latency_ms'] = {
        'calls': len(run.latencies),
        **{'p%d' % q: stats.percentile(run.latencies, q) * 1e3
           for q in (50, 90, 99, 100) if run.latencies}}
    line['spans_ms_per_call'] = {
        k: v * 1e3 / max(run.attempted, 1) for k, v in sorted(
            run.spans.items()) if not k.startswith('cxx.')}
    line['counters'] = run.counters
    line['host'] = {'cpu_ms_per_call': run.cpu_s * 1e3 / max(
        run.attempted, 1)}
    line['check'] = run.checks()
    return json.dumps(line)
