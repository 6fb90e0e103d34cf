"""A configuration, a traffic mix and a per-layer metric added as new
files and new entries are found by name, and no file already there is
edited."""

import hashlib
import json
import os
import time

from benchmark import harness, run

from conftest import make_root

NEW_METRIC = '''"""Flushes in the window (a test metric)."""


def read(run):
    return float(run.work['flushes'])
'''


def _digests(root):
    out = {}
    for dirpath, _dirs, files in os.walk(os.path.join(root, 'benchmark')):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, 'rb') as fh:
                out[path] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    before = _digests(root)
    bench = os.path.join(root, 'benchmark')
    with open(os.path.join(bench, 'configs', 'long_text.json')) as f:
        cfg = json.load(f)
    cfg.update(inserts=900, deletes=300, delete_share=0.5,
               cursor_jump_every=7)
    with open(os.path.join(bench, 'configs', 'short_text.json'), 'w') as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, 'traffic', 'two_docs.json'), 'w') as f:
        json.dump({'loop': 'keystroke_flushes', 'docs': 2,
                   'keystrokes_per_doc': 2, 'warmup_flushes': 3,
                   'prefill_per_s': 10}, f)
    with open(os.path.join(bench, 'metrics', 'flushes.test.py'), 'w') as f:
        f.write(NEW_METRIC)
    spec_path = os.path.join(root, 'BENCHMARK.json')
    with open(spec_path) as f:
        spec = json.load(f)
    spec['configs'].append({
        'name': 'short_text', 'source': 'https://example.org/test',
        'file': 'benchmark/configs/short_text.json', 'reduced': ['inserts', 'deletes'],
        'why': 'a test configuration'})
    spec['workloads'].append({
        'name': 'short_text.two_docs', 'config': 'short_text',
        'traffic': 'two_docs', 'chips': 1, 'why': 'a test cell'})
    for m in spec['end_to_end']:
        if m['name'] in ('edit_ms_p95', 'keystrokes_per_s'):
            m['workloads'].append('short_text.two_docs')
    spec['per_layer'].append({
        'name': 'flushes.test', 'unit': 'flushes', 'better': 'higher',
        'source': 'host_clock', 'layer': 'test', 'moves': 'edit_ms_p95',
        'workloads': ['short_text.two_docs']})
    with open(spec_path, 'w') as f:
        json.dump(spec, f)

    cell = harness.Cell(harness.load_spec(root), 'short_text.two_docs',
                        root=root)
    assert cell.config['inserts'] == 900
    assert cell.traffic['docs'] == 2
    r, metrics = run.run_cell(cell, 12, 0.3, 1, 'cpu',
                              t0=time.perf_counter(), workers=1)
    assert r.correct(), (r.checks(), r.verdict.note)
    assert metrics['flushes.test']['value'] == r.work['flushes'] > 0
    assert r.work['keystrokes'] == 4 * r.work['flushes']
    r, metrics = run.run_cell(cell, 12, 0.3, 0, 'cpu',
                              t0=time.perf_counter(), workers=1)
    assert {'edit_ms_p95', 'keystrokes_per_s', 'setup_s'} == set(metrics)
    after = _digests(root)
    assert {p: after[p] for p in before} == before
