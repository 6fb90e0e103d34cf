#!/usr/bin/env python3
"""Times the long text's build batch and keystrokes on the sharded
resident route of two checkouts in turns, on one card.

    python3 tools/sp_probe_ab.py PARENT_DIR [CHANGE_DIR]
    python3 tools/sp_probe_ab.py --child ROOT

PARENT_DIR and CHANGE_DIR (default: this checkout) each hold an
`automerge_tpu_torch/`.  Every side runs in a process of its own (both
packages have one name), in the order parent, change, change, parent.
Each process (`--child`) builds its runtime and kernels and, in a
`MeshDocPool(1, 2, sp_min=16)` (every resident batch of a list of 16
elements or more runs the sp-block route on two blocks, as phase 16 (d)
of `chip_smoke.py`'s sp-min-16 arm), applies a 20,000-character text as
a warm-up, then for texts of 131,072 and 262,144 characters
(`workloads.long_text_doc`) the build batch (host clock ending in a
synchronize) and 7 keystrokes (`workloads.keystroke_edits`; the first
not counted).  It prints one JSON line; the parent prints each child's
line and a summary line with each side's median build ms and median
keystroke ms over its processes, beside the card's name and power
limit.  Needs a CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys

#: the texts' lengths (characters)
SIZES = (131072, 262144)
#: keystrokes a text (the first not counted)
KEYS = 7


def child(root):
    sys.path.insert(0, root)
    import time

    import msgpack
    import torch

    from automerge_tpu_torch import workloads
    from automerge_tpu_torch.native import _lib
    from automerge_tpu_torch.native.mesh_pool import MeshDocPool
    from automerge_tpu_torch.ops import _build
    _lib.build()
    _build.build_all()
    pool = MeshDocPool(1, 2, sp_min=16)

    def apply(doc, body):
        pool.apply_batch_bytes(msgpack.packb({doc: body}, use_bin_type=True))
        torch.cuda.synchronize()

    apply('warm-up', workloads.long_text_doc(20000))
    out = {}
    for n in SIZES:
        doc = 'text-%d' % n
        t = time.perf_counter()
        apply(doc, workloads.long_text_doc(n))
        out['build_ms_%d' % n] = (time.perf_counter() - t) * 1e3
        keys = []
        for kind, body, _single in workloads.keystroke_edits(
                n, n_keys=KEYS)[:KEYS]:
            assert kind == 'batch'
            t = time.perf_counter()
            apply(doc, body)
            keys.append((time.perf_counter() - t) * 1e3)
        out['key_ms_%d' % n] = statistics.median(keys[1:])
    print('SP-PROBE ' + json.dumps(out), flush=True)


def run_side(root):
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        '--child', root], cwd=root, env=env,
                       capture_output=True, text=True, timeout=900)
    for line in r.stdout.splitlines():
        if line.startswith('SP-PROBE '):
            return json.loads(line[len('SP-PROBE '):])
    raise RuntimeError('%s: no result (rc %d)\n%s' % (
        root, r.returncode, r.stderr[-3000:]))


def main(argv):
    if '--child' in argv:
        child(os.path.abspath(argv[argv.index('--child') + 1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(argv[0])
    change = os.path.abspath(argv[1]) if len(argv) > 1 else \
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sides = {'parent': [], 'change': []}
    for name, root in (('parent', parent), ('change', change),
                       ('change', change), ('parent', parent)):
        got = run_side(root)
        sides[name].append(got)
        print('%s %s' % (name, json.dumps(got)), flush=True)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    summary = {name: {k: statistics.median(r[k] for r in runs)
                      for k in runs[0]} for name, runs in sides.items()}
    print('summary %s on %s' % (json.dumps(summary), card), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
