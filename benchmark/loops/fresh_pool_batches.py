"""A sync server's catch-up backlog: whole batches into fresh pools.

Set-up draws `distinct_payloads` payloads from the seed, each the whole
history of `docs_per_batch` docs, packs them as the wire's msgpack and
applies each once to a fresh pool (the warm-up).  The window then takes
the payloads in turn, each into a fresh pool, one call in flight: a
closed loop.  The work is every op applied; the rate is taken over the
window's whole time, pool creation and release included.

Every answer is judged: a fresh pool given the same payload owes the
same patches, so each distinct answer to a payload is judged doc by doc
against the reference once, and counts as many times as it came.
"""

import msgpack

from benchmark.reference import compare, judge
from benchmark.traffic import generate


class State:
    def __init__(self):
        self.payloads = []      # packed payloads
        self.ops = []           # ops per payload
        self.answers = []       # per payload: [raw result or None, ...]


def setup(run):
    cfg, traffic = run.cell.config, run.cell.traffic
    st = State()
    for p in range(traffic['distinct_payloads']):
        batch = generate.backlog_payload(cfg, run.seed, p)
        st.ops.append(generate.op_count(batch))
        st.payloads.append(msgpack.packb(batch, use_bin_type=True))
        st.answers.append([])
    del batch
    run.load_runtime()
    for p, payload in enumerate(st.payloads):
        st.answers[p].append(_apply(run, payload))
    return st


def _apply(run, payload):
    return run.make_pool().apply_batch_bytes(payload)


def window(run, st):
    run.work['ops'] = 0
    i = 0
    while run.more():
        p = i % len(st.payloads)
        out = run.timed(_apply, run, st.payloads[p])
        st.answers[p].append(out)
        if out is not None:
            run.work['ops'] += st.ops[p]
        i += 1
    run.work['batches'] = i


def release(run, st):
    st.payloads.clear()


def judge_tasks(run, st, workers):
    """Each payload's docs, split over `workers` tasks; a task gets each
    distinct answer's patch for its docs, with how often it came."""
    cfg = run.cell.config
    n_docs = cfg['docs_per_batch']
    tasks = []
    for p, outs in enumerate(st.answers):
        distinct = {}
        for out in outs:
            distinct[out] = distinct.get(out, 0) + 1
        split = [(compare.entries(out) if out is not None else {}, times)
                 for out, times in distinct.items()]
        st.answers[p] = None
        per = -(-n_docs // workers)
        for lo in range(0, n_docs, per):
            docs = [(d, [(e.get(generate.doc_id(d)), times)
                         for e, times in split])
                    for d in range(lo, min(lo + per, n_docs))]
            tasks.append((judge.judge_backlog, (cfg, run.seed, p, docs)))
    return tasks
