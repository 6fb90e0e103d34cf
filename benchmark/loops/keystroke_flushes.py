"""A collaboration server's editing traffic: keystroke flushes into long
documents.

Set-up draws `docs` documents' starting histories from the seed, one
change per keystroke, and builds them on the pool in one batch, then
draws each author's further keystrokes (`generate.Typist`) and packs
them into flushes: one call carries
`keystrokes_per_doc` keystroke changes of every open doc, as a server's
flush of what its clients sent.  `warmup_flushes` flushes are applied in
set-up.  Flushes for `prefill_per_s` flushes a second of the window are
packed ahead; a faster program gets more, drawn inside the window.

The window sends the flushes one at a time, closed loop.  A flush's
latency runs from the call to its return.  The work is every keystroke
change applied.  Every answer (warm-up included) is judged against the
reference replaying the same keystrokes, one task per doc.
"""

import collections
import math

import msgpack

from benchmark.reference import compare, judge
from benchmark.traffic import generate


class State:
    def __init__(self, n_docs, per_doc):
        self.n_docs, self.per_doc = n_docs, per_doc
        self.typists = []
        self.flushes = collections.deque()     # packed, not yet sent
        self.answers = []       # raw result or None per flush sent
        self.pool = None

    def draw(self, n):
        for _ in range(n):
            flush = {generate.doc_id(d): [t.next_change()
                                          for _ in range(self.per_doc)]
                     for d, t in enumerate(self.typists)}
            self.flushes.append(msgpack.packb(flush, use_bin_type=True))

    def next_flush(self):
        if not self.flushes:
            self.draw(64)
        return self.flushes.popleft()


def setup(run):
    cfg, traffic = run.cell.config, run.cell.traffic
    n_docs = traffic['docs']
    st = State(n_docs, traffic['keystrokes_per_doc'])
    build, st.typists = generate.long_text_build(cfg, run.seed,
                                                 range(n_docs))
    st.draw(traffic['warmup_flushes'] + math.ceil(
        run.seconds * traffic['prefill_per_s']))
    run.load_runtime()
    st.pool = run.make_pool()
    st.pool.apply_batch_bytes(build)
    del build
    for _ in range(traffic['warmup_flushes']):
        st.answers.append(st.pool.apply_batch_bytes(
            st.next_flush()))
    return st


def window(run, st):
    n = 0
    while run.more():
        payload = st.next_flush()
        st.answers.append(run.timed(st.pool.apply_batch_bytes, payload))
        n += 1
    run.work['flushes'] = n
    run.work['keystrokes'] = n * st.n_docs * st.per_doc


def release(run, st):
    st.pool = None
    st.flushes.clear()


def judge_tasks(run, st, workers):
    per_doc = [[] for _ in range(st.n_docs)]
    for out in st.answers:
        split = compare.entries(out) if out is not None else {}
        for d in range(st.n_docs):
            per_doc[d].append(split.get(generate.doc_id(d)))
    st.answers = None
    return [(judge.judge_typist, (run.cell.config, run.seed, d,
                                  st.per_doc, answers))
            for d, answers in enumerate(per_doc)]
