"""Tests of the benchmark itself, on the CPU (and one marked `cuda`, for
a card).  Run them from the root of the repository:

    python3 -m pytest benchmark/tests -q            # here, on the CPU
    python3 -m pytest benchmark/tests -q -m cuda    # on a card

They are not collected by `pytest tests/`.  A test marked `cuda` decides
inside its fixture whether there is a card, and skips without one.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the test sizes of the configurations: the shapes kept, the scale cut
SMALL = {'text_catchup': {'docs_per_batch': 48},
         'long_text': {'inserts': 1500, 'deletes': 640}}


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skips where there is none')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card on this machine')
    return torch.device('cuda')


def make_root(dest, sizes=SMALL):
    """A checkout-like copy of the benchmark under `dest` (BENCHMARK.json
    and benchmark/), its configurations cut to `sizes`."""
    shutil.copytree(os.path.join(ROOT, 'benchmark'),
                    os.path.join(dest, 'benchmark'),
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), dest)
    with open(os.path.join(dest, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    for c in spec['configs']:
        path = os.path.join(dest, c['file'])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(sizes.get(c['name'], {}))
        with open(path, 'w') as f:
            json.dump(cfg, f)
    return str(dest)


@pytest.fixture(scope='session')
def small_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp('bench'))
