#!/usr/bin/env python3
"""Times the port's linearize kernel (`automerge_tpu_torch/csrc/linearize.cu`)
at each L on one card: its list-ranking route (the tour) against its
rounds route on the same inputs, each on route (a) (one block) and route
(b) (the cooperative grid): the measurement behind route (a)'s limit
(`kOneCtaMax`) and the tour's aims.

    python3 tools/linearize_routes.py [--sizes 64,1024,...] [--check]

The source is built four times with `nvcc` into a temporary directory:
route (a)'s limit set to `--a-limit` (default 14,336, about what one
block's 227 KB of shared memory holds at 16 bytes an element) and to 0
(every L on route b), each with the tour on and off (`kTour`: off, every
call takes the rounds).  The libraries are called directly on the same
inputs: a seeded forest of about 192 elements an object
(`tests/torch_linearize_cases.forest_of_size`) and one chain of L
elements (`chain`), each with the host's sibling sort and
ceil(log2(L)) + 1 rounds.  Each call is held bit-equal to the plain
`list_rank.linearize`, its route readout to the numpy model's
(`kernel_model`: the route, the barriers, the longest walks), and timed
back to back and as a CUDA graph (`tools/step_ab.timed_ms`).  Route (a)
is timed up to `--a-limit`.  `--check` first runs every edge and tour
case of `tests/torch_linearize_cases.py` through the four builds
(bit-equal, the model's route), then times.  `--ptxas` prints the
compiler's register and shared-memory report.  Prints one line per (L,
input) and the card's name and power limit.  Needs a CUDA card and the
CUDA toolkit.
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
LIMIT = 'constexpr int64_t kOneCtaMax = '
TOUR = 'constexpr bool kTour = '
SIZES = (64, 1024, 4096, 8192, 12288, 14336, 16384, 65536, 131072,
         262144, 393216, 786432)


def set_constant(text, prefix, value):
    start = text.index(prefix) + len(prefix)
    return text[:start] + value + text[text.index(';', start):]


def build(_build, src, limit, tour, out_dir, ptxas=False, defines=()):
    """The kernel library with route (a)'s limit set to `limit`, the tour
    on or off and each (name, value) of `defines` set, loaded with the
    wrapper's argument types."""
    with open(src) as f:
        text = f.read()
    text = set_constant(set_constant(text, LIMIT, str(limit)), TOUR,
                        'true' if tour else 'false')
    for name, value in defines:
        m = re.search(r'constexpr [\w ]+ %s = ' % re.escape(name), text)
        if m is None:
            raise ValueError('no constant %s in %s' % (name, src))
        text = set_constant(text, m.group(0), value)
    name = 'lin_%d_%s%s' % (limit, 'tour' if tour else 'rounds',
                            ''.join('_%s%s' % d for d in defines))
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
        print('%s:\n%s' % (name, done.stderr.strip()), flush=True)
    lib = ctypes.CDLL(so)
    for fn, (restype, argtypes) in _build.KERNELS['linearize'].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def launch(torch, lib, cols, n_iters, info=None):
    obj, _parent, _ctr, _actor, valid, sort_idx = cols
    L = obj.shape[0]
    rank = torch.empty((L,), dtype=torch.int32, device=obj.device)
    words = lib.amtpu_torch_linearize_scratch(L)
    scratch = torch.empty((max(words, 1),), dtype=torch.int32,
                          device=obj.device)
    err = lib.amtpu_torch_linearize(
        obj.data_ptr(), cols[1].data_ptr(), valid.data_ptr(),
        sort_idx.data_ptr(), rank.data_ptr(),
        scratch.data_ptr() if words else None,
        None if info is None else info.data_ptr(), L, n_iters,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError('linearize launch failed: cudaError %d' % err)
    return rank


def stamps(model, info):
    """The readout's barrier times, us from the kernel's start (route b:
    then the top's block has the splitters loaded / ranked)."""
    n = min(info[model.INFO_BARRIERS],
            model.INFO_TOP_LOADED - model.INFO_STAMPS)
    out = ' '.join('%.1f' % (info[model.INFO_STAMPS + j] / 1e3)
                   for j in range(n))
    if info[model.INFO_GRID]:
        out += ' (top loaded %.1f, ranked %.1f)' % (
            info[model.INFO_TOP_LOADED] / 1e3, info[model.INFO_TOP_DONE] / 1e3)
    return out


def timed_info(torch, model, lib, cols, n_iters):
    """A variant's readout on one call, held bit-equal to the plain
    version (the model's walks are the default build's)."""
    from automerge_tpu_torch.ops import list_rank
    want = list_rank.linearize(*cols[:5], n_iters, sort_idx=cols[5])
    info = torch.zeros((model.INFO_WORDS,), dtype=torch.int32,
                       device=cols[0].device)
    got = launch(torch, lib, cols, n_iters, info)
    if not bool((got == want).all()):
        raise AssertionError('a variant differs from the plain version')
    return info.cpu().tolist()


def checked(torch, np, model, lib, label, case, cols, n_iters, one_cta_max,
            tour_on):
    """One call held bit-equal to the plain version and its readout to
    the model's; returns the readout (a list of ints)."""
    from automerge_tpu_torch.ops import list_rank
    want = list_rank.linearize(*cols[:5], n_iters, sort_idx=cols[5])
    info = torch.zeros((model.INFO_WORDS,), dtype=torch.int32,
                       device=cols[0].device)
    got = launch(torch, lib, cols, n_iters, info)
    torch.cuda.synchronize()
    if not bool((got == want).all()):
        raise AssertionError('%s: %d mismatches with the plain version' % (
            label, int((got != want).sum())))
    info = info.cpu().tolist()
    obj, parent, _c, _a, valid, sort_idx = case
    route = model.route_of(obj, parent, valid, n_iters)[0] if tour_on \
        else model.ROUTE_ROUNDS
    if info[model.INFO_ROUTE] != route or \
            info[model.INFO_GRID] != int(obj.shape[0] > one_cta_max):
        raise AssertionError('%s: readout %s, the model takes route %d'
                             % (label, info, route))
    if route == model.ROUTE_TOUR:
        m_info = model.tour_model(obj, parent, valid, sort_idx,
                                  one_cta_max)[1].tolist()
        keys = (model.INFO_BARRIERS, model.INFO_WALK1, model.INFO_WALK2,
                model.INFO_TOP, model.INFO_TOP_ROUNDS)
        if [info[k] for k in keys] != [m_info[k] for k in keys]:
            raise AssertionError('%s: readout %s, the model\'s %s' % (
                label, info, m_info))
    return info


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--sizes', default=','.join(map(str, SIZES)))
    ap.add_argument('--a-limit', type=int, default=14336)
    ap.add_argument('--check', action='store_true')
    ap.add_argument('--ptxas', action='store_true')
    ap.add_argument('--define', action='append', default=[],
                    metavar='NAME=VALUE',
                    help='another build of the tour on route (b) with a '
                    'constant of the source set (repeatable; each variant '
                    'is built, held to the plain version and timed)')
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
    import torch_linearize_cases as model
    src = os.path.join(_build.CSRC, 'linearize.cu')
    dev = torch.device('cuda')
    variants = [(lim, tour, ()) for lim in (args.a_limit, 0)
                for tour in (True, False)] + [
        (0, True, (tuple(d.split('=', 1)),)) for d in args.define]
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(variants)) as ex:
            libs = dict(zip(variants, ex.map(lambda v: build(
                _build, src, v[0], v[1], tmp, args.ptxas, v[2]),
                variants)))
        if args.check:
            rs = np.random.RandomState(19)
            cases = [(l, c, n) for l, c, n in model.edge_cases(rs)] + [
                (l, c, n) for l, c, n, _r in model.tour_cases(rs)] + [
                ('%s x8' % l, c, n) for l, c, n, _r in
                model.tour_cases(rs, scale=8)]
            for label, case, n_iters in cases:
                cols = [torch.from_numpy(np.asarray(x)).to(dev)
                        for x in case]
                for (lim, tour, defs), lib in libs.items():
                    if defs:
                        continue
                    info = checked(torch, np, model, lib, label, case, cols,
                                   n_iters, lim, tour)
                    if tour:
                        print('check %s L=%d n_iters=%d a-limit %d: %s'
                              % (label, case[0].shape[0], n_iters, lim,
                                 info), flush=True)
            print('check: %d cases bit-equal on four builds, readouts as '
                  'the model gives' % len(cases), flush=True)
        for L in (int(x) for x in args.sizes.split(',')):
            n_iters = list_rank.ceil_log2(L) + 1
            for kind in ('forest', 'chain'):
                case = model.chain(L) if kind == 'chain' else \
                    model.forest_of_size(np.random.RandomState(L), L,
                                         max(1, L // 192))
                cols = [torch.from_numpy(np.asarray(x)).to(dev)
                        for x in case]
                out = []
                for (lim, tour, defs), lib in libs.items():
                    if lim and L > lim:
                        continue
                    if defs:
                        info = timed_info(torch, model, lib, cols, n_iters)
                    else:
                        info = checked(torch, np, model, lib, kind, case,
                                       cols, n_iters, lim, tour)
                    ms = timed_ms(torch, lambda: launch(torch, lib, cols,
                                                        n_iters))
                    g_ms = timed_ms(torch, lambda: launch(
                        torch, lib, cols, n_iters), graph=True)
                    out.append('route (%s) %s%s %.4f ms, graph %.4f ms%s' % (
                        'a' if lim else 'b', 'tour' if tour else 'rounds',
                        ''.join(' %s=%s' % d for d in defs),
                        ms, g_ms, ' (barriers %d, walks %d / %d, top %d in '
                        '%d rounds; us at barriers %s, end %.1f)' % (
                            tuple(info[2:7]) + (stamps(model, info),
                                                info[model.INFO_END] / 1e3))
                        if tour else ''))
                print('L=%d %s n_iters=%d: %s' % (L, kind, n_iters,
                                                 '; '.join(out)), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
