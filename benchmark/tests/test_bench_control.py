"""The comparison that decides `correct` fails what it must.

* The control, the reference with its list-order guarantee broken
  (`reference/control.py`), answers in the program's place and is judged
  wrong, in each cell's shape; the reference itself is judged right.
* A whole run, the look for a card skipped, with the timed path broken
  underneath comes out not correct, for each fault a cell can have: a
  call that leaves the state unchanged, half of the batch left out, and
  an answer altered where it is produced.  (The cells run on one chip:
  there is no exchange between chips to leave out.)
"""

import time

import msgpack
import pytest

from benchmark import harness, run
from benchmark.reference import control, judge

CELLS = ('text_catchup.backlog', 'long_text.one_doc', 'long_text.many_docs')


@pytest.mark.parametrize('name', CELLS)
def test_the_control_is_judged_wrong(small_root, name):
    cell = harness.Cell(harness.load_spec(small_root), name,
                        root=small_root)
    v = judge.run_judges(control.tasks(cell, 31, 60, 2), 1)
    assert v.missing == 0
    assert v.wrong > 0 and v.wrong >= v.answers // 2, v


def test_the_reference_in_the_program_place_is_judged_right(small_root,
                                                           monkeypatch):
    cell = harness.Cell(harness.load_spec(small_root), 'long_text.one_doc',
                        root=small_root)
    monkeypatch.setattr(control, 'AscendingSiblings', control.Doc)
    v = judge.run_judges(control.tasks(cell, 31, 60, 2), 1)
    assert (v.answers, v.wrong, v.missing) == (60, 0, 0)


class Faulty:
    """The program with one fault planted in the timed path: every pool
    it makes breaks each call after the first `calls_before` calls to
    any of them (the set-up's, which stay sound)."""

    def __init__(self, fault, calls_before):
        self.fault = fault
        self.calls = 0
        self.calls_before = calls_before

    def make_pool(self, device):
        return Broken(self, device)


class Broken:
    def __init__(self, program, device):
        from automerge_tpu_torch.native import make_pool
        self.pool = make_pool(device)
        self.program = program
        self.fault = program.fault

    def apply_batch_bytes(self, payload):
        self.program.calls += 1
        if self.program.calls <= self.program.calls_before:
            return self.pool.apply_batch_bytes(payload)
        batch = msgpack.unpackb(payload, raw=False, strict_map_key=False)
        docs = sorted(batch)
        if self.fault == 'unchanged':
            batch = {d: [] for d in docs}
        elif self.fault == 'half_left_out':
            if len(docs) > 1:
                batch = {d: batch[d] for d in docs[:len(docs) // 2]}
            elif self.program.calls % 2:
                batch = {d: [] for d in docs}
        out = self.pool.apply_batch_bytes(
            msgpack.packb(batch, use_bin_type=True))
        if self.fault == 'altered':
            res = msgpack.unpackb(out, raw=False, strict_map_key=False)
            diffs = res[docs[-1]]['diffs']
            if diffs:
                diffs[-1]['index'] = diffs[-1].get('index', 0) + 1
            else:
                res[docs[-1]]['clock']['x'] = 1
            out = msgpack.packb(res, use_bin_type=True)
        return out


@pytest.mark.parametrize('fault', ['unchanged', 'half_left_out', 'altered'])
@pytest.mark.parametrize('name', CELLS)
def test_a_broken_timed_path_is_not_correct(small_root, name, fault):
    cell = harness.Cell(harness.load_spec(small_root), name,
                        root=small_root)
    # the set-up's calls stay sound: only the window's are broken
    before = cell.traffic.get('distinct_payloads',
                              1 + cell.traffic.get('warmup_flushes', 0))
    program = Faulty(fault, before)
    r, _ = run.run_cell(cell, 2 ** 32 + 9, 0.3, 0, 'cpu',
                        make_pool=program.make_pool,
                        t0=time.perf_counter(), workers=1)
    assert program.calls > before
    assert r.attempted > 0
    assert not r.correct(), r.checks()


@pytest.mark.parametrize('name', CELLS)
def test_a_sound_run_is_correct(small_root, name):
    cell = harness.Cell(harness.load_spec(small_root), name,
                        root=small_root)
    r, metrics = run.run_cell(cell, 2 ** 32 + 9, 0.3, 0, 'cpu',
                              t0=time.perf_counter(), workers=2)
    assert r.correct(), (r.checks(), r.verdict.note)
    assert r.verdict.answers > 0
    assert 'setup_s' in metrics
