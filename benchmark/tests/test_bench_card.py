"""Each cell on a card, briefly, as `run.py` runs it: correct, and the
resident route taken by every flush of `long_text.one_doc` and by none
of `long_text.many_docs`."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(cell, trace):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', cell, '--seed',
         str(2 ** 31 + 77), '--seconds', '3', '--trace', str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['text_catchup.backlog',
                                  'long_text.one_doc',
                                  'long_text.many_docs'])
def test_cell_on_the_card(card, cell):
    line = _run(cell, 1)
    assert line['correct'] is True, line['check']
    assert line['device']['platform'] == 'gpu'
    assert 0 < line['device']['busy_s'] <= line['device']['window_s']
    flushes = line['work'].get('flushes')
    resident = line['counters'].get('resident.dispatches', 0)
    if cell == 'long_text.one_doc':
        assert resident == flushes
    elif cell == 'long_text.many_docs':
        assert resident == 0


def test_no_card_no_result():
    """Without CUDA (or with fewer cards than the cell asks for) a run
    exits with an error and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'long_text.one_doc', '--seed', '1', '--seconds', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
