"""The port's static gate (`automerge_tpu_torch/analysis/`) and its
runtime alias sanitizer, the counterpart of `tests/test_analysis.py`.

Two-sided per checker: it must stay silent on the port's tree (parsed
once for the file) and fire on a seeded violation, only there.  The
env map is held to the JAX package's spec, value for value.  The
sanitizer lane runs in process on CPU pools: armed, it is invisible
while the upload contract holds, and a deliberately re-opened alias
(the clock table keeping a zero-copy view of its staging rows) shows
as different patch bytes.
"""

import ctypes
import importlib
import os
import textwrap

import numpy as np
import pytest

from automerge_tpu.analysis.env_spec import ENV_FLAGS, SPEC
from automerge_tpu_torch import native, resilience
from automerge_tpu_torch.analysis import engine, sanitize
from automerge_tpu_torch.analysis.env_spec import (
    KNOBS, PORT_KNOBS, PORT_VALUES, expected_value)
from automerge_tpu_torch.native import NativeDocPool
from automerge_tpu_torch.native import clock_cache
from automerge_tpu_torch.ops import registers as register_ops
from automerge_tpu_torch.tools import static_check
from torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKERS = ('dispatch-alias', 'env-latch', 'lock-discipline',
            'telemetry-key')


@pytest.fixture(scope='module')
def tree():
    """The port's sources, parsed once for every lane of this file."""
    sources, broken = engine.load_sources(REPO)
    assert broken == []
    return sources


def _format(findings):
    return '\n'.join(f.format(REPO) for f in findings)


@pytest.mark.parametrize('checker', CHECKERS)
def test_tree_is_clean(tree, checker):
    findings = engine.check_sources(REPO, tree, [checker])
    assert findings == [], _format(findings)


def _on_fixture(tree, tmp_path, checker, text):
    """(findings on the fixture, findings elsewhere) of `checker` run over
    the tree plus the fixture file."""
    path = str(tmp_path / 'fixture.py')
    with open(path, 'w') as f:
        f.write(textwrap.dedent(text))
    src = engine.Source(path, os.path.relpath(path, REPO),
                        open(path).read())
    findings = engine.check_sources(REPO, tree + [src], [checker])
    return ([(f.code, f.line) for f in findings if f.path == path],
            [f for f in findings if f.path != path])


LOCK_FIXTURE = '''
import threading


class Queue:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []          # guarded-by: self._lock
        self._built = None        # guarded-by(w): self._lock

    def push(self, x):
        with self._lock:
            self._items.append(x)
        self._items.append(x)

    def peek(self):
        return self._built

    def build(self):
        self._built = 1

    def drain(self):  # holds-lock: self._lock
        self._items.clear()
'''

TELEMETRY_FIXTURE = '''
from automerge_tpu_torch import trace


def count(n):
    trace.metric('resident.batch_hits')
    trace.metric('resident.not_a_seed', n)
    trace.metric('fallback.escalated.w%d' % n)
    trace.metric('collect.x%d' % n)
'''

ALIAS_FIXTURE = '''
import numpy as np
import torch

from automerge_tpu_torch.ops.registers import upload


def zero_copy(x):
    t = torch.from_numpy(x)
    x[0] = 1
    return t


def private_copy(x):
    t = torch.from_numpy(np.array(x))
    x[0] = 1
    return t


def rebound(x):
    t = torch.from_numpy(x)
    x = np.zeros(4)
    x[0] = 1
    return t


def refill(chunks, dev):
    buf = np.zeros(8)
    out = []
    for c in chunks:
        buf[:len(c)] = c
        out.append(upload(buf, dev))
    return out


def early(x, dev):
    t = upload(x, dev)
    np.copyto(x, 0)
    x.fill(3)
    return t


def async_copy(x, dev):
    return torch.from_numpy(np.array(x)).to(dev, non_blocking=True)


def fetch(t):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host, t.to('cpu', non_blocking=True)


def cxx_view(L, bh, n, dev):
    return upload(np.ctypeslib.as_array(L.col(bh), shape=(n,)), dev)


def cxx_view_bound(L, bh, n, dev):
    src = np.ctypeslib.as_array(L.col(bh), shape=(n,))
    return upload(src[:4], dev), upload(np.array(src), dev)
'''

ENV_FIXTURE = '''
import os


def knobs():
    a = os.environ['AMTPU_X']
    b = os.environ.get('AMTPU_Y', '1')
    c = os.getenv('AMTPU_Z')
    d = 'AMTPU_W' in os.environ
    e = os.environ.get('HOME')
    return a, b, c, d, e
'''


def test_lock_checker_fires_on_fixture(tree, tmp_path):
    hits, off = _on_fixture(tree, tmp_path, 'lock-discipline',
                            LOCK_FIXTURE)
    assert off == [], _format(off)
    # the unguarded append and the unguarded write of a (w) attribute;
    # the racy read of the (w) attribute and the holds-lock method pass
    assert hits == [('unguarded-access', 14), ('unguarded-access', 20)]


def test_telemetry_checker_fires_on_fixture(tree, tmp_path):
    hits, off = _on_fixture(tree, tmp_path, 'telemetry-key',
                            TELEMETRY_FIXTURE)
    assert off == [], _format(off)
    assert sorted(hits) == [('undeclared-dynamic-key', 9),
                            ('undocumented-key', 7),
                            ('unseeded-key', 7)]


def test_alias_checker_fires_on_fixture(tree, tmp_path):
    hits, off = _on_fixture(tree, tmp_path, 'dispatch-alias',
                            ALIAS_FIXTURE)
    assert off == [], _format(off)
    # the private copy, the rebound name, the device->host copies and
    # the copied view pass
    assert sorted(hits) == [
        ('async-upload', 44),
        ('cxx-view-upload', 54), ('cxx-view-upload', 59),
        ('loop-staging-reuse', 31),
        ('post-seam-mutation', 10), ('post-seam-mutation', 38),
        ('post-seam-mutation', 39)]


def test_env_checker_fires_on_fixture(tree, tmp_path):
    hits, off = _on_fixture(tree, tmp_path, 'env-latch', ENV_FIXTURE)
    assert off == [], _format(off)
    assert hits == [('direct-read', 6), ('direct-read', 7),
                    ('direct-read', 8), ('direct-read', 9)]


@pytest.mark.parametrize('marker', [
    '# static-ok: dispatch-alias',
    '# static-ok',
    '# static-ok: lock-discipline,dispatch-alias -- reviewed: a test',
])
def test_suppression_comment_silences(tree, tmp_path, marker):
    text = ('import torch\n\n\ndef f(x):\n    t = torch.from_numpy(x)\n'
            '    x[0] = 1  %s\n    return t\n' % marker)
    hits, _ = _on_fixture(tree, tmp_path, 'dispatch-alias', text)
    assert hits == []
    # a comment-only block right above the line counts too
    above = text.replace('    x[0] = 1  %s\n' % marker,
                         '    %s\n    # (the reason)\n    x[0] = 1\n'
                         % marker)
    hits, _ = _on_fixture(tree, tmp_path, 'dispatch-alias', above)
    assert hits == []
    # another checker's name does not
    other = text.replace(marker, '# static-ok: env-latch')
    hits, _ = _on_fixture(tree, tmp_path, 'dispatch-alias', other)
    assert hits == [('post-seam-mutation', 6)]


def test_cli_exit_codes(tmp_path, capsys):
    path = tmp_path / 'bad.py'
    path.write_text(textwrap.dedent(LOCK_FIXTURE))
    assert static_check.main(['--only', 'lock-discipline', '--extra',
                              str(path)]) == 1
    out = capsys.readouterr().out
    assert '[lock-discipline] unguarded-access' in out
    assert 'static-check: FAIL (2 findings)' in out
    assert static_check.main(['--only', 'lock-discipline']) == 0
    assert static_check.main(['--only', 'no-such-checker']) == 2


# ---------------------------------------------------------------------------
# the port's map of the JAX package's flags
# ---------------------------------------------------------------------------

def test_every_jax_flag_has_a_port_row():
    assert [k.flag for k in PORT_KNOBS] == [f.name for f in ENV_FLAGS]
    assert len(KNOBS) == len(PORT_KNOBS) == 104


def test_port_rows_hold_the_jax_defaults():
    for knob in PORT_KNOBS:
        spec = SPEC[knob.flag]
        assert knob.default == spec.default and \
            type(knob.default) is type(spec.default), knob
        assert knob.core == ('core.cpp' in spec.consumer), knob
        if knob.constant is None:
            assert knob.note, knob
            continue
        mod, _, name = knob.constant.rpartition('.')
        value = getattr(importlib.import_module('automerge_tpu_torch.'
                                                + mod), name)
        assert value == expected_value(knob), knob
        if knob.flag not in PORT_VALUES:
            assert value == spec.default, knob


# ---------------------------------------------------------------------------
# the runtime sanitizer, in process on CPU pools
# ---------------------------------------------------------------------------

ROOT = '00000000-0000-0000-0000-000000000000'


def _round(r, docs=64, actors=8):
    """`tests/test_analysis.py::BATCH_WORKLOAD`: every doc's actors write
    one key of the round, so each round appends fresh clock rows."""
    return {'doc%d' % d: [{'actor': 'w%d' % a, 'seq': r, 'deps': {},
                           'ops': [{'action': 'set', 'obj': ROOT,
                                    'key': 'shared%d' % (r % 3),
                                    'value': 'a%d r%d' % (a, r)}]}
                          for a in range(actors)]
            for d in range(docs)}


def _run_rounds():
    pool = NativeDocPool(device='cpu')
    out = [pool.apply_batch_bytes(native.msgpack.packb(
        _round(r), use_bin_type=True)) for r in (1, 2, 3)]
    return out + [pool.get_patch('doc%d' % i) for i in range(64)]


@pytest.fixture
def sanitizer(monkeypatch):
    monkeypatch.setattr(native, 'PIPELINE_DEPTH', 1)
    monkeypatch.setattr(resilience, 'ENABLED', False)
    yield
    sanitize.arm(False)


def _aliasing_table(orig):
    """The clock cache with its delta re-opened as an alias: the table
    becomes a zero-copy view of one host staging buffer, which is then
    poisoned as the clean delta's rows are."""
    def table(self, L, pool):
        info = (ctypes.c_int64 * 4)()
        L.amtpu_resclk_info(pool, info)
        n, ap, gen = int(info[0]), int(info[1]), int(info[2])
        if self.tab is None or gen != self.gen or ap != self.ap \
                or n <= self.n:
            return orig(self, L, pool)
        rows = np.zeros((max(self.cap, n), self.tab.shape[1]), np.int32)
        rows[:n, :ap] = np.ctypeslib.as_array(L.amtpu_resclk_tab(pool),
                                              shape=(n, ap))
        self.tab = register_ops.upload(rows, self.device)
        sanitize.poison(rows)
        self.n, self.cap = n, rows.shape[0]
        return self.tab
    return table


def test_sanitizer_clean_then_catches_deliberate_alias(sanitizer,
                                                       monkeypatch):
    ref = _run_rounds()
    n0 = sanitize.poisoned_count()
    assert sanitize.arm()
    assert _run_rounds() == ref, 'the sanitizer changed a clean pipeline'
    assert sanitize.poisoned_count() > n0, 'no delta staging was poisoned'
    monkeypatch.setattr(clock_cache.PoolClockCache, 'table',
                        _aliasing_table(clock_cache.PoolClockCache.table))
    assert _run_rounds() != ref, 'the sanitizer missed the alias'
    # disarmed, the same alias is invisible: the poison is what shows it
    sanitize.arm(False)
    assert _run_rounds() == ref
