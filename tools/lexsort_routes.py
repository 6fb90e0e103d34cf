#!/usr/bin/env python3
"""Checks and times the routes of the port's lexsort kernel
(`automerge_tpu_torch/csrc/lexsort.cu`) on one card: the measurement
behind its design constants and the "earlier" column of PERF.md's
lexsort rows.

    python3 tools/lexsort_routes.py [--variants default,grid,...]
        [--define NAME=VALUE,...] [--parent DIR] [--check] [--ptxas]
        [--rounds N]

Each variant is the source built with `nvcc` into a temporary directory
with some of its constants set (`VARIANTS`), a baseline for the shipped
build (`default`): `grid` kClusterMax = 0, every L on the cooperative
grid; `cluster8` the largest cluster of 8 CTAs (the route of a card
without the non-portable cluster sizes); `radix` kSegmented = false, the
register order on the radix; `phases` the readout's pass slots stamping
the phases of the second pass (kStampPhases); `--define NAME=VALUE,...`
one more, `defined`.
`--parent DIR` also builds `DIR`'s `csrc/lexsort.cu` (a checkout of the
parent commit, e.g. `git archive HEAD | tar -x -C DIR` before
committing) and calls its entry points with its own signature (no
readout): the same card and host, in the same process.  `--check` first
runs every edge case of `tests/torch_lexsort_cases.py` (both entry
points, and the cluster's capacity and one row above it) through every
variant, each held bit-equal to the plain version
(`list_rank.sibling_sort`, `parallel.mesh.register_order`), and the
readouts of `default`, `grid` and `cluster8` to the numpy model's
(`lexsort_model` at the card's largest cluster).  Then the main path's
shapes (the sibling sort of a seeded forest, `forest_of_size`, and of a
text typed left to right, `chain`, at `SIBLING_SIZES`; the register
order at `REGISTER_SHAPES`) are timed on every variant: each call as
the wrapper makes it (its output and scratch allocated, `ms`) back to
back, and the same calls in a CUDA graph (`graph`, device time alone;
`tools/step_ab.timed_ms`), in the order parent, variants, variants
reversed, parent (the lowest and highest of the two are printed), with
each variant's route, barriers and readout stamps (ns), beside torch's
stable sorts.  Prints one line per shape, the SM clock and the card's
name and power limit.  Needs a CUDA card and the CUDA toolkit.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: variant name -> constants it sets
VARIANTS = {
    'default': (),
    'grid': (('kClusterMax', '0'),),
    'cluster8': (('kClusterMax', '8'),),
    'radix': (('kSegmented', 'false'),),
    'phases': (('kStampPhases', 'true'),),
}
SIBLING_SIZES = (16384, 32768, 65536, 262144, 393216)
REGISTER_SHAPES = ((2048, 32), (1, 16384), (2, 64))


def set_constant(text, name, value):
    m = re.search(r'constexpr [\w ]+ %s = ' % re.escape(name), text)
    if m is None:
        raise ValueError('no constant %s in lexsort.cu' % name)
    start = m.end()
    return text[:start] + value + text[text.index(';', start):]


def build(_build, src, name, defines, out_dir, ptxas=False):
    """The kernel library of `src` with each (constant, value) of
    `defines` set; returns the path of the shared library."""
    with open(src) as f:
        text = f.read()
    for const, value in defines:
        text = set_constant(text, const, value)
    cu = os.path.join(out_dir, name + '.cu')
    with open(cu, 'w') as f:
        f.write(text)
    so = os.path.join(out_dir, name + '.so')
    flags = _build.NVCC_FLAGS + (['-Xptxas', '-v'] if ptxas else [])
    done = subprocess.run([_build._nvcc()] + flags + [cu, '-o', so],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError('nvcc failed for %s:\n%s' % (name, done.stderr))
    if ptxas:
        for line in done.stderr.splitlines():
            if 'registers' in line or 'spill' in line:
                print('ptxas %s: %s' % (name, line.strip()), flush=True)
    return so


class Lib:
    """One built library and how to call it: the current source takes a
    readout pointer after the scratch, an earlier one does not."""

    def __init__(self, torch, _build, so, readout):
        self.torch = torch
        self.lib = ctypes.CDLL(so)
        self.readout = readout
        for fn, (restype, argtypes) in _build.KERNELS['lexsort'].items():
            if not readout and fn != 'amtpu_torch_lexsort_scratch':
                argtypes = [a for i, a in enumerate(argtypes)
                            if i != (7 if 'sibling' in fn else 4)]
            getattr(self.lib, fn).restype = restype
            getattr(self.lib, fn).argtypes = argtypes

    def __call__(self, site, cols, info=None):
        """One launch on CUDA tensors, its output and scratch allocated
        as the wrapper allocates them."""
        torch = self.torch
        dev = cols[0].device
        L = cols[0].numel()
        out = torch.empty((L,), dtype=torch.int32, device=dev)
        if L == 0:
            return out
        n = self.lib.amtpu_torch_lexsort_scratch(L)
        scratch = torch.empty((n,), dtype=torch.uint8, device=dev) \
            if n else None
        sp = None if scratch is None else scratch.data_ptr()
        extra = [None if info is None else info.data_ptr()] \
            if self.readout else []
        stream = torch.cuda.current_stream().cuda_stream
        if site == 'sibling':
            err = self.lib.amtpu_torch_sibling_sort(
                *[x.data_ptr() for x in cols], out.data_ptr(), sp, *extra,
                L, stream)
        else:
            D, T = cols[0].shape
            err = self.lib.amtpu_torch_register_sort(
                cols[0].data_ptr(), cols[1].data_ptr(), out.data_ptr(), sp,
                *extra, D, T, cols[2], stream)
        if err:
            raise RuntimeError('lexsort launch failed: cudaError %d' % err)
        return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--variants', default=','.join(VARIANTS))
    ap.add_argument('--define', default='',
                    help='NAME=VALUE,... : one more variant, "defined"')
    ap.add_argument('--parent', default=None)
    ap.add_argument('--check', action='store_true')
    ap.add_argument('--ptxas', action='store_true')
    ap.add_argument('--rounds', type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('lexsort_routes: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, 'tests'))
    sys.path.append(os.path.join(ROOT, 'tools'))
    from automerge_tpu_torch.ops import _build, lexsort_kernel, list_rank
    from automerge_tpu_torch.parallel.mesh import register_order
    from step_ab import timed_ms
    from torch_lexsort_cases import (capacity_cases, lexsort_model,
                                     register_cases, sibling_cases,
                                     sized_forest)
    from torch_linearize_cases import chain
    dev = torch.device('cuda')
    variants = {v: VARIANTS[v] for v in args.variants.split(',') if v}
    if args.define:
        variants['defined'] = tuple(
            tuple(x.split('=', 1)) for x in args.define.split(','))

    def on_card(case):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) if
                isinstance(x, np.ndarray) else x for x in case]

    def plain(site, cols):
        return list_rank.sibling_sort(*cols) if site == 'sibling' \
            else register_order(*cols)

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(_build.CSRC, 'lexsort.cu')
        jobs = {v: (src, d, True) for v, d in variants.items()}
        if args.parent:
            jobs['parent'] = (os.path.join(
                args.parent, 'automerge_tpu_torch', 'csrc', 'lexsort.cu'),
                (), False)
        with ThreadPoolExecutor(len(jobs)) as ex:
            built = {v: ex.submit(build, _build, s, v, d, tmp, args.ptxas)
                     for v, (s, d, _r) in jobs.items()}
            libs = {v: Lib(torch, _build, f.result(), jobs[v][2])
                    for v, f in built.items()}
        info = torch.zeros((lexsort_kernel.INFO_WORDS,), dtype=torch.int32,
                           device=dev)
        if args.check:
            cases = [('sibling', label, case) for label, case in
                     sibling_cases(np.random.RandomState(18))
                     + capacity_cases(np.random.RandomState(20))]
            cases += [('register', label, case) for label, case in
                      register_cases(np.random.RandomState(19))]
            n = 0
            for site, label, case in cases:
                cols = on_card(case)
                want = plain(site, cols)
                for v, lib in libs.items():
                    info.zero_()
                    got = lib(site, cols, info if lib.readout else None)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError('%s %s, %s: %d rows differ' % (
                            site, label, v, int((got != want).sum())))
                    if v not in ('default', 'grid', 'cluster8') or \
                            not cols[0].numel():
                        continue
                    ro = lexsort_kernel.readout(info)
                    mi = lexsort_model(site, case, ro['cluster_max'])[1]
                    bad = {k: (ro[k], mi[k]) for k in (
                        'route', 'ctas', 'rows', 'passes', 'run', 'skipped',
                        'barriers', 'in_range') if ro[k] != mi[k]}
                    if bad:
                        raise AssertionError('%s %s, %s: readout (card, '
                                             'model) %s' % (site, label, v,
                                                            bad))
                n += 1
            print('edge cases: %d, bit-equal on %s; the readouts of '
                  'default, grid and cluster8 equal the model\'s'
                  % (n, ', '.join(libs)), flush=True)
        shapes = []
        for L in SIBLING_SIZES:
            shapes.append(('sibling', 'forest L=%d' % L, sized_forest(
                np.random.RandomState(L), L)))
            shapes.append(('sibling', 'typed left to right L=%d' % L,
                           chain(L)[:5]))
        rs = np.random.RandomState(3)
        for D, T in REGISTER_SHAPES:
            rg = rs.randint(-1, 8, (D, T)).astype(np.int32)
            rt = rs.randint(0, 2 * T, (D, T)).astype(np.int32)
            shapes.append(('register', 'D=%d T=%d' % (D, T), (rg, rt, 8)))
        order = (['parent'] if 'parent' in libs else []) + list(variants)
        order = order + order[::-1]
        for site, label, case in shapes:
            cols = on_card(case)
            want = plain(site, cols)
            times = {}
            for v in order:
                lib = libs[v]
                if not torch.equal(lib(site, cols), want):
                    raise AssertionError('%s %s: %s differs' % (site, label,
                                                                 v))
                fn = (lambda lib=lib: lib(site, cols))
                times.setdefault(v, []).append((
                    timed_ms(torch, fn, rounds=args.rounds),
                    timed_ms(torch, fn, rounds=args.rounds, graph=True)))
            out = []
            for v in times:
                ms = sorted(t[0] for t in times[v])
                gs = sorted(t[1] for t in times[v])
                line = '%s %.4f/%.4f ms, graph %.4f/%.4f' % (
                    v, ms[0], ms[-1], gs[0], gs[-1])
                if libs[v].readout:
                    info.zero_()
                    libs[v](site, cols, info)
                    ro = lexsort_kernel.readout(info)
                    stamps = [int(x) for x in info[len(
                        lexsort_kernel.INFO_FIELDS):].tolist()]
                    line += ' [%s C=%d rows=%d passes %d run %d barriers %d;' \
                        ' ns plan, passes (phases) and end %s]' % (
                            ro['route'], ro['ctas'], ro['rows'],
                            ro['passes'], ro['run'], ro['barriers'], stamps)
                out.append(line)
            lib_ms = timed_ms(torch, lambda: plain(site, cols),
                              rounds=args.rounds)
            print('%s %s: %s; torch\'s sorts %.4f ms' % (
                site, label, '; '.join(out), lib_ms), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm',
                          '--format=csv'], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
