#!/usr/bin/env python3
"""Checks and times both routes of the port's lexsort kernel
(`automerge_tpu_torch/csrc/lexsort.cu`) on one card: the measurement
behind route (a)'s limit (`kOneCtaMax`).

    python3 tools/lexsort_routes.py [--sizes 1024,16384,...] [--a-limit N]

The source is built with `nvcc -Xptxas -v` into a temporary directory
twice, with route (a)'s limit set to `--a-limit` (default 16,384, what
one block's shared memory holds beside its histograms) and to 0 (every
L on route (b), the cooperative grid), and the compiler's register and
shared-memory report is printed.  Every edge case of
`tests/torch_lexsort_cases.py` (both entry points) goes through the
package's wrappers and through the route-(b) library, each held
bit-equal to the plain version (`list_rank.sibling_sort`,
`parallel.mesh.register_order`).  Then at each L the sibling sort of a
seeded forest (`forest_of_size`, about 40 elements an object), of a
text typed left to right (`chain`) and of one typed at its head (one
sibling group, `head_typed`), and the register order at a few
(D, T), are timed on each route (route (a) up to `--a-limit`) back to
back and as a CUDA graph
(`tools/step_ab.timed_ms`), beside torch's stable sorts (the plain
version, `library`).  Prints one line per shape and the card's name and
power limit.  Needs a CUDA card and the CUDA toolkit.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 'constexpr int64_t kOneCtaMax = '
SIZES = (1024, 2048, 4096, 6144, 8192, 10240, 12288, 16384, 32768, 65536,
         262144, 393216, 1048576)
REGISTER_SHAPES = ((1, 16384), (2048, 32), (4096, 256))


def build(_build, src, limit, out_dir):
    """The kernel library with route (a)'s limit set to `limit`, loaded
    with the wrapper's argument types; prints ptxas's report."""
    with open(src) as f:
        text = f.read()
    start = text.index(LIMIT) + len(LIMIT)
    text = text[:start] + str(limit) + text[text.index(';', start):]
    name = 'lexsort_%d' % limit
    cu = os.path.join(out_dir, name + '.cu')
    with open(cu, 'w') as f:
        f.write(text)
    so = os.path.join(out_dir, name + '.so')
    out = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + [
        '-Xptxas', '-v', cu, '-o', so], check=True, capture_output=True,
        text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print('ptxas (limit %s): %s' % (limit, line.strip()))
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in _build.KERNELS['lexsort'].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def call(torch, lib, site, cols):
    """One launch of `lib`'s entry point for `site` on CUDA tensors."""
    if site == 'sibling':
        L = cols[0].shape[0]
    else:
        D, T = cols[0].shape
        L = D * T
    out = torch.empty((L,), dtype=torch.int32, device=cols[0].device)
    if L == 0:
        return out
    scratch = torch.empty((lib.amtpu_torch_lexsort_scratch(L),),
                          dtype=torch.uint8, device=cols[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    if site == 'sibling':
        err = lib.amtpu_torch_sibling_sort(
            *[x.data_ptr() for x in cols], out.data_ptr(),
            scratch.data_ptr(), L, stream)
    else:
        err = lib.amtpu_torch_register_sort(
            cols[0].data_ptr(), cols[1].data_ptr(), out.data_ptr(),
            scratch.data_ptr(), D, T, cols[2], stream)
    if err:
        raise RuntimeError('lexsort launch failed: cudaError %d' % err)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--sizes', default=','.join(map(str, SIZES)))
    ap.add_argument('--a-limit', type=int, default=16384)
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
    from torch_lexsort_cases import (head_typed, register_cases,
                                     sibling_cases, sized_forest)
    from torch_linearize_cases import chain
    src = os.path.join(_build.CSRC, 'lexsort.cu')
    dev = torch.device('cuda')

    def on_card(case):
        return [torch.from_numpy(np.asarray(x)).to(dev) if
                isinstance(x, np.ndarray) else x for x in case]

    def plain(site, cols):
        return list_rank.sibling_sort(*cols) if site == 'sibling' \
            else register_order(*cols)

    def wrapper(site, cols):
        return lexsort_kernel.sibling_sort_cuda(*cols) if site == \
            'sibling' else lexsort_kernel.register_sort_cuda(*cols)
    with tempfile.TemporaryDirectory() as tmp:
        lib_a = build(_build, src, args.a_limit, tmp)
        lib_b = build(_build, src, 0, tmp)
        n = 0
        for site, cases in (('sibling', sibling_cases(
                np.random.RandomState(18))), ('register', register_cases(
                    np.random.RandomState(19)))):
            for label, case in cases:
                cols = on_card(case)
                want = plain(site, cols)
                for route, got in (('wrapper', wrapper(site, cols)),
                                   ('route (b)', call(torch, lib_b, site,
                                                      cols))):
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError('%s %s, %s: %d rows differ' % (
                            site, label, route, int((got != want).sum())))
                n += 1
        print('edge cases: %d bit-equal on both routes' % n, flush=True)
        shapes = []
        for L in (int(x) for x in args.sizes.split(',')):
            shapes.append(('sibling', 'forest L=%d' % L, sized_forest(
                np.random.RandomState(L), L)))
            shapes.append(('sibling', 'typed left to right L=%d' % L,
                           chain(L)[:5]))
            shapes.append(('sibling', 'typed at its head L=%d' % L,
                           head_typed(L)))
        rs = np.random.RandomState(3)
        for D, T in REGISTER_SHAPES:
            rg = rs.randint(-1, 8, (D, T)).astype(np.int32)
            rt = rs.randint(0, 2 * T, (D, T)).astype(np.int32)
            shapes.append(('register', 'D=%d T=%d' % (D, T), (rg, rt, 8)))
        for site, label, case in shapes:
            cols = on_card(case)
            L = cols[0].numel()
            want = plain(site, cols)
            out = []
            for route, fn in (('a', lambda: call(torch, lib_a, site, cols)),
                              ('b', lambda: call(torch, lib_b, site,
                                                 cols))):
                if route == 'a' and L > args.a_limit:
                    continue
                if not torch.equal(fn(), want):
                    raise AssertionError('%s %s route (%s) differs' % (
                        site, label, route))
                out.append('route (%s) %.4f ms, graph %.4f ms' % (
                    route, timed_ms(torch, fn), timed_ms(torch, fn,
                                                         graph=True)))
            lib_ms = timed_ms(torch, lambda: plain(site, cols))
            print('%s %s: %s; library %.4f ms' % (
                site, label, '; '.join(out), lib_ms), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
