#!/usr/bin/env python3
"""Times both routes of the port's linearize kernel
(`automerge_tpu_torch/csrc/linearize.cu`) at each L, on one card: the
measurement behind route (a)'s limit (`kOneCtaMax`).

    python3 tools/linearize_routes.py [--sizes 64,1024,...]

The source is built twice with `nvcc` into a temporary directory, with
route (a)'s limit set to `--a-limit` (default 14,336, about what one
block's 227 KB of shared memory holds at 16 bytes an element) and to 0
(every L on route (b), the cooperative grid), and both libraries are
called directly on the same inputs: a seeded forest of about 192
elements an object (`tests/torch_linearize_cases.forest_of_size`) and
one chain of L elements (`chain`), each with the host's sibling sort and
ceil(log2(L)) + 1 rounds.  Each call is held bit-equal to the plain
`list_rank.linearize` and timed back to back and as a CUDA graph
(`tools/step_ab.timed_ms`).  Route (a) is timed up to `--a-limit`.
Prints one line per (L, input) and the card's name and power limit.
Needs a CUDA card and the CUDA toolkit.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 'constexpr int64_t kOneCtaMax = '
SIZES = (64, 1024, 4096, 8192, 12288, 14336, 16384, 65536, 131072,
         393216, 786432)


def build(_build, src, limit, out_dir):
    """The kernel library with route (a)'s limit set to `limit`, loaded
    with the wrapper's argument types."""
    with open(src) as f:
        text = f.read()
    start = text.index(LIMIT) + len(LIMIT)
    text = text[:start] + str(limit) + text[text.index(';', start):]
    name = 'lin_%d' % limit
    cu = os.path.join(out_dir, name + '.cu')
    with open(cu, 'w') as f:
        f.write(text)
    so = os.path.join(out_dir, name + '.so')
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + [cu, '-o', so],
                   check=True)
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in _build.KERNELS['linearize'].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def launch(torch, lib, cols, n_iters):
    obj, _parent, _ctr, _actor, valid, sort_idx = cols
    L = obj.shape[0]
    rank = torch.empty((L,), dtype=torch.int32, device=obj.device)
    words = lib.amtpu_torch_linearize_scratch(L)
    scratch = torch.empty((max(words, 1),), dtype=torch.int32,
                          device=obj.device)
    err = lib.amtpu_torch_linearize(
        obj.data_ptr(), cols[1].data_ptr(), valid.data_ptr(),
        sort_idx.data_ptr(), rank.data_ptr(),
        scratch.data_ptr() if words else None, L, n_iters,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError('linearize launch failed: cudaError %d' % err)
    return rank


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--sizes', default=','.join(map(str, SIZES)))
    ap.add_argument('--a-limit', type=int, default=14336)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('linearize_routes: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, 'tests'))
    sys.path.append(os.path.join(ROOT, 'tools'))
    from automerge_tpu_torch.ops import _build, list_rank
    from step_ab import timed_ms
    from torch_linearize_cases import chain, forest_of_size
    src = os.path.join(_build.CSRC, 'linearize.cu')
    dev = torch.device('cuda')
    with tempfile.TemporaryDirectory() as tmp:
        lib_a = build(_build, src, args.a_limit, tmp)
        lib_b = build(_build, src, 0, tmp)
        for L in (int(x) for x in args.sizes.split(',')):
            n_iters = list_rank.ceil_log2(L) + 1
            for kind in ('forest', 'chain'):
                case = chain(L) if kind == 'chain' else forest_of_size(
                    np.random.RandomState(L), L, max(1, L // 192))
                cols = [torch.from_numpy(np.asarray(x)).to(dev)
                        for x in case]
                want = list_rank.linearize(*cols[:5], n_iters,
                                           sort_idx=cols[5])
                out = []
                for name, lib in (('a', lib_a), ('b', lib_b)):
                    if name == 'a' and L > args.a_limit:
                        continue
                    got = launch(torch, lib, cols, n_iters)
                    if not bool((got == want).all()):
                        raise AssertionError('route (%s) L=%d %s differs '
                                             'from the plain version'
                                             % (name, L, kind))
                    ms = timed_ms(torch, lambda: launch(torch, lib, cols,
                                                        n_iters))
                    g_ms = timed_ms(torch, lambda: launch(
                        torch, lib, cols, n_iters), graph=True)
                    out.append('route (%s) %.4f ms, graph %.4f ms'
                               % (name, ms, g_ms))
                print('L=%d %s n_iters=%d: %s' % (L, kind, n_iters,
                                                 '; '.join(out)), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
