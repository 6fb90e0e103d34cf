"""Judging the program's answers against the plain reference, per doc.

Documents are independent, so the docs are shared out over worker
processes (`python3 -m benchmark.reference.judge`, tasks in and verdicts
out as pickles over its standard input and output): a worker rebuilds
each doc's changes from the seed (`traffic/generate.py`), applies them
to the reference (`oracle.Doc`) and compares every answer the program
gave for that doc with the reference's patch (`compare.same`).  An
answer that never came is `None` and counts as missing.  Each judge
returns a `Verdict`.  The workers are plain subprocesses, each waited
for: no process outlives the call and nothing is made in shared memory.
"""

import os
import pickle
import subprocess
import sys
from dataclasses import astuple, dataclass

from ..traffic import generate
from .compare import decode, first_difference, same
from .oracle import Doc, apply_changes


#: characters of the first difference a verdict keeps
NOTE_MAX = 600


@dataclass
class Verdict:
    answers: int = 0
    wrong: int = 0
    missing: int = 0
    note: str = ''

    def add(self, other):
        self.answers += other.answers
        self.wrong += other.wrong
        self.missing += other.missing
        self.note = self.note or other.note
        return self

    def judge(self, raw, want, where, times=1):
        """One answer (`raw` patch bytes, or None) given `times` times."""
        self.answers += times
        if raw is None:
            self.missing += times
            self.note = self.note or '%s: no answer' % where
            return
        got = decode(raw)
        if not same(got, want):
            self.wrong += times
            self.note = self.note or first_difference(got, want,
                                                      where)[:NOTE_MAX]


def judge_backlog(config, seed, payload, docs):
    """`docs`: [(d, [(raw patch or None, times), ...])], one pair per
    distinct answer the program gave for doc `d` of backlog payload
    `payload`, each from a fresh pool."""
    v = Verdict()
    for d, answers in docs:
        want = apply_changes(Doc(), generate.backlog_doc(config, seed,
                                                         payload, d))
        for raw, times in answers:
            v.judge(raw, want, '%s of payload %d' % (generate.doc_id(d),
                                                     payload), times)
    return v


def typed(doc, config, seed, d):
    """`doc` with doc `d`'s starting history applied, and the Typist
    that types on from there."""
    typist = generate.Typist(config, seed, d)
    for chunk in _chunks(typist.history(), 4096):
        apply_changes(doc, chunk)
    return doc, typist


def _chunks(items, n):
    chunk = []
    for x in items:
        chunk.append(x)
        if len(chunk) == n:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def judge_typist(config, seed, d, per_flush, answers):
    """Doc `d` of a keystroke stream: its starting history, then
    `per_flush` keystrokes per flush; `answers` holds the program's
    patch for this doc at each flush, in order."""
    doc, typist = typed(Doc(), config, seed, d)
    v = Verdict()
    for i, raw in enumerate(answers):
        want = apply_changes(doc, [typist.next_change()
                                   for _ in range(per_flush)])
        v.judge(raw, want, '%s flush %d' % (generate.doc_id(d), i))
    return v


def _call(task):
    fn, args = task
    return fn(*args)


def _judge_all(tasks):
    total = Verdict()
    for task in tasks:
        total.add(_call(task))
    return total


def run_judges(tasks, workers=None):
    """Runs (function, args) tasks, shared out over `workers` worker
    processes; the summed Verdict."""
    workers = min(workers or os.cpu_count() or 1, len(tasks), 8)
    if workers <= 1:
        return _judge_all(tasks)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get('PYTHONPATH')) if p))
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'benchmark.reference.judge'], cwd=root,
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        for _ in range(workers)]
    total = Verdict()
    try:
        for i, proc in enumerate(procs):
            pickle.dump(tasks[i::workers], proc.stdin)
            proc.stdin.close()
        for proc in procs:
            out = proc.stdout.read()
            if proc.wait() != 0:
                raise RuntimeError('a judge worker exited with %d'
                                   % proc.returncode)
            # bytes a worker of this module wrote
            total.add(Verdict(*pickle.loads(out)))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return total


if __name__ == '__main__':
    pickle.dump(astuple(_judge_all(pickle.load(sys.stdin.buffer))),
                sys.stdout.buffer)
