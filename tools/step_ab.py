#!/usr/bin/env python3
"""Times the port's single-device step of two checkouts in turns, on one
card, and holds the step-timing loops `chip_smoke.py` uses.

    python3 tools/step_ab.py PARENT_DIR [CHANGE_DIR] [--runs N]
    python3 tools/step_ab.py --child ROOT N

PARENT_DIR and CHANGE_DIR (default: this checkout) each hold an
`automerge_tpu_torch/`.  Every side runs in a process of its own (both
packages have one name), in the order parent, change, change, parent.
Each process (`--child`) builds its kernels and, on config 1
(`workloads.build_config_1`, sp = 1) and on
`mesh_encode.scaling_workload(2048)`, runs one warm-up step and N timed
steps of `mesh.single_step` (`time_steps`), then times the step's
schedule and route wrappers on the inputs the step gave them, back to
back and as a CUDA graph (`timed_ms`).  It prints one JSON line; the
parent prints each child's line and a summary line with each side's
medians over its processes, beside the card's name and power limit.
Needs a CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys
import time

#: the step's trace spans, in the order `mesh.single_step` closes them
STEP_SPANS = ('step.uploads', 'step.schedule', 'step.registers',
              'step.linearize', 'step.op_metadata', 'step.route')
LANES = ('config1', 'scaling2048')


def timed_ms(torch, fn, reps=20, rounds=5, graph=False):
    """Per-call device ms of fn(): `reps` calls between two CUDA events,
    divided by `reps`, the median over `rounds`.  Back to back (host work
    between the launches included) or, with `graph`, the calls captured
    once in a CUDA graph and replayed (the kernels' device time alone)."""
    fn()
    torch.cuda.synchronize()
    run = None
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        run = torch.cuda.CUDAGraph()
        with torch.cuda.graph(run):
            for _ in range(reps):
                fn()
        run.replay()
        torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        if graph:
            run.replay()
        else:
            for _ in range(reps):
                fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / reps)
    per.sort()
    return per[len(per) // 2]


def time_steps(torch, mesh, trace, batch, n_iters, runs=3):
    """`runs` card steps on `batch`.  Per run the host wall (ending in a
    synchronize); per stage (STEP_SPANS, hooked at `trace.add` as each
    span closes) the host's issue ms (the span) and the card's ms between
    CUDA events recorded as each span closes, the first before the step.
    Returns {'walls', 'stages', 'loop_s', 'loop_cpu_s'}: the stages of
    the median-wall run (empty for a checkout whose step has no such
    spans), and the wall and the main thread's CPU seconds over all the
    runs (one reading: the thread clock may tick in 10 ms)."""
    add = trace.add
    out = []
    t0, c0 = time.perf_counter(), time.thread_time()
    for _ in range(runs):
        closed = []

        def hook(name, seconds):
            add(name, seconds)
            if name in STEP_SPANS:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                closed.append((name, seconds, e))
        torch.cuda.synchronize()
        first = torch.cuda.Event(enable_timing=True)
        first.record()
        trace.add = hook
        try:
            t = time.perf_counter()
            mesh.single_step(batch, n_iters)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            trace.add = add
        stages, prev = {}, first
        for name, seconds, e in closed:
            stages[name] = {'issue_ms': seconds * 1e3,
                            'event_ms': prev.elapsed_time(e)}
            prev = e
        if closed and list(stages) != list(STEP_SPANS):
            raise AssertionError('step spans %s, expected %s'
                                 % (list(stages), list(STEP_SPANS)))
        out.append((wall, stages))
    loop_s, loop_cpu_s = time.perf_counter() - t0, time.thread_time() - c0
    return {'walls': [w for w, _ in out],
            'stages': sorted(out, key=lambda x: x[0])[len(out) // 2][1],
            'loop_s': loop_s, 'loop_cpu_s': loop_cpu_s}


def lane_batches(workloads, mesh_encode, list_rank):
    """(lane, batch, linearize iterations) of config 1 at sp = 1 and of
    the scaling workload at 2,048 docs."""
    import random
    for lane, wl, kw in (
            ('config1', workloads.build_config_1(random.Random(7)),
             {'sp': 1}),
            ('scaling2048', mesh_encode.scaling_workload(2048), {})):
        batch, meta = mesh_encode.encode_batch(wl, **kw)
        n_iters = list_rank.ceil_log2(max(meta['max_arena'], 1)) + 1
        yield lane, batch, n_iters


def step_calls(mesh, batch, n_iters):
    """The step's schedule and route wrappers with the arguments one step
    gave them: {'schedule' | 'dominance_indexes': (wrapper, args,
    kwargs)}."""
    from automerge_tpu_torch.ops import clock_kernel, dominance_kernel
    got = {}
    wrapped = ((clock_kernel, 'schedule_queue_cuda', 'schedule'),
               (dominance_kernel, 'dominance_indexes_cuda',
                'dominance_indexes'))
    originals = [getattr(mod, name) for mod, name, _ in wrapped]

    def catching(key, fn):
        def call(*a, **kw):
            got[key] = (fn, a, kw)
            return fn(*a, **kw)
        return call
    for (mod, name, key), fn in zip(wrapped, originals):
        setattr(mod, name, catching(key, fn))
    try:
        mesh.single_step(batch, n_iters)
    finally:
        for (mod, name, _), fn in zip(wrapped, originals):
            setattr(mod, name, fn)
    return got


def child(root, runs):
    sys.path.insert(0, root)
    import torch

    from automerge_tpu_torch import trace, workloads
    from automerge_tpu_torch.ops import _build, list_rank
    from automerge_tpu_torch.parallel import mesh, mesh_encode
    _build.build_all()
    out, calls = {'root': root}, {}
    for lane, batch, n_iters in lane_batches(workloads, mesh_encode,
                                             list_rank):
        mesh.single_step(batch, n_iters)
        out[lane] = time_steps(torch, mesh, trace, batch, n_iters, runs)
        calls[lane] = step_calls(mesh, batch, n_iters)
        out[lane]['kernels'] = {
            key: {'ms': timed_ms(torch, lambda: fn(*a, **kw))}
            for key, (fn, a, kw) in calls[lane].items()}
    # graphs last: a wrapper that reads the card back cannot be captured
    # (graph_ms None), and a failed capture may spoil later work
    for key in ('schedule', 'dominance_indexes'):
        for lane in LANES:
            fn, a, kw = calls[lane][key]
            try:
                ms = timed_ms(torch, lambda: fn(*a, **kw), graph=True)
            except RuntimeError:
                ms = None
            out[lane]['kernels'][key]['graph_ms'] = ms
    print(json.dumps(out), flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def run_child(root, runs):
    """One `--child` process on `root`; its JSON line, parsed."""
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), '--child', root,
         str(runs)], capture_output=True, text=True, check=True,
        timeout=900)
    return json.loads(res.stdout.strip().splitlines()[-1])


def summary(got):
    """Medians over one side's processes: step walls (over every run),
    each stage's issue and event ms, each kernel's ms and graph ms."""
    def med(xs):
        xs = [x for x in xs if x is not None]
        return statistics.median(xs) if xs else None
    out = {}
    for lane in LANES:
        rows = [r[lane] for r in got]
        out[lane] = {
            'step_s': med([w for r in rows for w in r['walls']]),
            'cpu_share': med([r['loop_cpu_s'] / r['loop_s'] for r in rows]),
            'stages': {s: {k: med([r['stages'][s][k] for r in rows
                                   if s in r['stages']])
                           for k in ('issue_ms', 'event_ms')}
                       for s in STEP_SPANS if s in rows[0]['stages']},
            'kernels': {k: {m: med([r['kernels'][k][m] for r in rows])
                            for m in ('ms', 'graph_ms')}
                        for k in rows[0]['kernels']}}
    return out


def main(argv):
    if '--child' in argv:
        i = argv.index('--child')
        child(os.path.abspath(argv[i + 1]), int(argv[i + 2]))
        return 0
    runs = 20
    if '--runs' in argv:
        i = argv.index('--runs')
        runs = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(argv[0])
    change = os.path.abspath(argv[1]) if len(argv) > 1 else \
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    card = card_line()
    sides = {'parent': [], 'change': []}
    for side in ('parent', 'change', 'change', 'parent'):
        got = run_child(parent if side == 'parent' else change, runs)
        print(side, json.dumps(got), flush=True)
        sides[side].append(got)
    print(json.dumps({'median': {side: summary(got)
                                 for side, got in sides.items()},
                      'runs_per_process': runs, 'card': card}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
