"""The port's driver entry points: the resolver step on one device and
over a dp x sp grid of devices.

entry(device=None)  -- the single-device step of the flagship pipeline
                       (causal schedule, LWW registers, RGA linearization,
                       list indexes) over a real document batch: wire-format
                       changes through the step's encoder.  Returns (fn,
                       args); fn(*args) runs it.
dryrun_multichip(n_devices, devices=None)
                    -- one full sharded step over an n-device grid (dp
                       docs x sp list elements) on real text, map and table
                       workloads, each verified against the port engine's
                       patches and the text one bit-equal to the single step,
                       then the scaling table over
                       `mesh_encode.scaling_workload` at dp 1, 2 and 4 and
                       one dp x sp row, every run verified and bit-equal to
                       the other runs of its sp encoding.

Both run on the card unless `device` / `devices` say otherwise; a grid
cell may repeat a device (`parallel/mesh.make_mesh`), so on a host with
one card every cell is `cuda:0` and the table shows no speed-up.
"""

import time
from functools import partial

#: docs of the scaling table's workload
SCALING_DOCS = 2048


def entry(device=None):
    """(fn, args): `single_step` over eight demo text docs, its chunk 16."""
    from .parallel import mesh as M
    from .parallel import mesh_encode

    batch, meta = mesh_encode.encode_batch(mesh_encode.demo_text_workload(8))
    n_iters = M.list_rank.ceil_log2(meta['max_arena']) + 1
    fn = partial(M.single_step, n_linearize_iters=n_iters, chunk=16,
                 device=device)
    return fn, (batch,)


def _equal(got, want, label):
    import numpy as np
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      want[k].cpu().numpy(),
                                      err_msg='%s: %s' % (label, k))


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def dryrun_multichip(n_devices, devices=None, scaling_docs=SCALING_DOCS):
    """The sharded step over an `n_devices` grid: sp = 2 when n_devices
    is even, else 1, and dp = n_devices / sp.  `devices` places the cells
    (`make_mesh`); None puts every cell on the card.  Raises on any
    mismatch.  Returns the scaling table: one dict per run with dp, sp,
    the step's median wall of 3 (seconds, after a first run) and its
    ops/s."""
    from .parallel import mesh as M
    from .parallel import mesh_encode

    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // sp
    mesh = M.make_mesh(dp, sp, devices=devices)
    first = mesh.devices[0][0]
    verify_dev = first.type

    def n_iters_of(meta):
        return M.list_rank.ceil_log2(max(meta['max_arena'], 1)) + 1

    # text, map and table workloads through one sharded step each,
    # verified against the port engine's patches; the text one also
    # bit-equal to the single step
    for name, workload in (
            ('text', mesh_encode.demo_text_workload(2 * dp)),
            ('map', mesh_encode.demo_map_workload(n_docs=2 * dp)),
            ('table', mesh_encode.demo_table_workload(n_docs=2 * dp))):
        batch, meta = mesh_encode.encode_batch(workload, sp=sp)
        n_iters = n_iters_of(meta)
        step = M.build_sharded_step(mesh, n_iters, chunk=16)
        out = step(M.shard_batch(mesh, batch))
        mesh_encode.verify_against_pool(workload, meta, out,
                                        device=verify_dev)
        if name == 'text':
            ref = M.single_step(batch, n_iters, chunk=16, device=first)
            _equal(out, ref, 'sharded vs single step')
        print('dryrun %s: %d docs over dp=%d x sp=%d verified' % (
            name, len(workload), dp, sp), flush=True)

    # the scaling table: dp rows, then one dp x sp row; outputs equal
    # within each sp encoding (sp changes the arena's padding)
    t0 = time.perf_counter()
    big = mesh_encode.scaling_workload(scaling_docs)
    total_ops = sum(len(c['ops']) for chs in big.values() for c in chs)
    enc = {s: mesh_encode.encode_batch(big, sp=s) for s in sorted({1, sp})}
    print('scaling workload: %d docs, %d ops (built and encoded in %.1f s)'
          % (scaling_docs, total_ops, time.perf_counter() - t0), flush=True)
    runs = [(x, 1) for x in (1, 2, 4) if x <= n_devices]
    if sp > 1:
        runs.append((dp, sp))
    table, baselines = [], {}
    for run_dp, run_sp in runs:
        m = M.make_mesh(run_dp, run_sp, devices=devices)
        batch, meta = enc[run_sp]
        step = M.build_sharded_step(m, n_iters_of(meta), chunk=16)
        sb = M.shard_batch(m, batch)
        out = step(sb)
        _sync(first)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            out = step(sb)
            _sync(first)
            times.append(time.perf_counter() - t)
        med = sorted(times)[1]
        mesh_encode.verify_against_pool(big, meta, out, device=verify_dev)
        if run_sp not in baselines:
            baselines[run_sp] = out
        else:
            _equal(out, baselines[run_sp],
                   'dp=%d sp=%d against dp=1' % (run_dp, run_sp))
        table.append({'dp': run_dp, 'sp': run_sp, 'median_s': med,
                      'ops_per_s': total_ops / med})
        print('scaling dp=%d sp=%d: step %.6f s (median of 3), %.0f ops/s, '
              'verified' % (run_dp, run_sp, med, total_ops / med),
              flush=True)
    return table
