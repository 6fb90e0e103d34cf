"""No module the benchmark runs is JAX's or the JAX package's, and the
reference imports nothing of the program either.  Top-level names are
compared whole: `automerge_tpu_torch` is the program, `automerge_tpu`
the JAX package."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

BARRED = {'jax', 'jaxlib', 'flax', 'automerge_tpu'}
PROGRAM = 'automerge_tpu_torch'
BENCH = os.path.join(ROOT, 'benchmark')


def _py_files(*parts):
    top = os.path.join(BENCH, *parts)
    for dirpath, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def _imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split('.', 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split('.', 1)[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in _py_files():
        assert not _imported_tops(path) & BARRED, path


def test_reference_and_traffic_sources_import_nothing_of_the_program():
    for path in list(_py_files('reference')) + list(_py_files('traffic')):
        assert not _imported_tops(path) & (BARRED | {PROGRAM, 'torch'}), \
            path


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys\n'
         'print(" ".join(sorted({m.split(".", 1)[0] '
         'for m in sys.modules})))'],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_reference_process_holds_no_program_module():
    tops = _modules_after(
        'from benchmark.reference import control, judge, oracle, compare\n'
        'from benchmark.traffic import generate')
    assert not tops & (BARRED | {PROGRAM, 'torch'}), tops


def test_a_whole_run_holds_no_barred_module(small_root):
    code = (
        'import time\n'
        'from benchmark import harness, run\n'
        'for name in ("text_catchup.backlog", "long_text.one_doc",\n'
        '             "long_text.many_docs"):\n'
        '    cell = harness.Cell(harness.load_spec(%r), name, root=%r)\n'
        '    r, m = run.run_cell(cell, 7, 0.3, 0, "cpu",\n'
        '                        t0=time.perf_counter(), workers=1)\n'
        '    assert r.correct(), (name, r.checks(), r.verdict.note)\n'
        'assert not harness.barred_modules(), harness.barred_modules()\n'
        % (small_root, small_root))
    tops = _modules_after(code)
    assert PROGRAM in tops
    assert not tops & BARRED, tops
