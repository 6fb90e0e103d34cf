"""The port's device-resident arena (`automerge_tpu_torch/native/
resident.py`, `NativeDocPool._dispatch_resident`) against the JAX pool's,
and its device functions against the JAX ones.  Integer outputs: the
tolerance is exact equality.

C++ decides which batches qualify (one list object of at least
AMTPU_RESIDENT_MIN elements) from statics that latch at each library
copy's first batch, and other test files leave those knobs at their
defaults in the same worker process.  So the pool scenario runs once, in a
subprocess with AMTPU_RESIDENT=1 and AMTPU_RESIDENT_MIN=16: a 600-
character text and `workloads.keystroke_edits` go through a JAX pool, a
port pool with `RESIDENT = True` and a port pool with the default
(`RESIDENT = None`, which declines on a CPU pool), step by step.  The
tests below read its per-step record.
"""

import json
import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automerge_tpu.ops import list_rank as jax_list_rank
from automerge_tpu.ops import registers as jax_registers
from automerge_tpu_torch.ops import list_rank as LR
from automerge_tpu_torch.ops import registers as R
from test_ops_kernels import TestPallasRegisters as _RegisterCases
from torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENARIO = r'''
import json
import sys
sys.path.insert(0, REPO_PATH)
import jax
jax.config.update('jax_platforms', 'cpu')
import msgpack
from automerge_tpu import trace as jax_trace
from automerge_tpu.errors import AutomergeError as JaxError
from automerge_tpu.native import NativeDocPool as JaxPool
from automerge_tpu_torch import native, telemetry, trace, workloads
from automerge_tpu_torch.errors import AutomergeError
from automerge_tpu_torch.native import NativeDocPool, live_batch_handles

COUNTERS = ('resident.dispatch', 'resident.full_upload_rows',
            'resident.delta_upload_rows', 'resident.no_upload',
            'resident.actor_invalidation',
            'resident.cross_path_invalidation')
jax_trace.ENABLED = True
telemetry.enable()
N = 600


def jax_counts():
    snap = jax_trace.snapshot()
    out = {k: snap[k]['n'] for k in COUNTERS if k in snap}
    n = jax_trace.metrics_snapshot().get('resident.dispatches', 0)
    if n:
        out['resident.dispatches'] = n
    return out


def port_counts():
    snap = telemetry.phase_snapshot()
    out = {k: snap[k]['n'] for k in COUNTERS if k in snap}
    n = trace.metrics().get('resident.dispatches', 0)
    if n:
        out['resident.dispatches'] = n
    return out


def run(pool, resident, kind, body):
    native.RESIDENT = resident
    if kind == 'batch':
        return pool.apply_batch_bytes(msgpack.packb({'doc': body},
                                                    use_bin_type=True))
    return pool.apply_local_change('doc', dict(body))


steps = [('batch', workloads.long_text_doc(N), True)] + \
    workloads.keystroke_edits(N)
# after the delete, a batch that raises at begin: it types into the text
# and then sets a key of an object that does not exist
bad = [{'actor': 'zz', 'seq': 1, 'deps': {}, 'ops': [
    {'action': 'ins', 'obj': 't', 'key': 'a0:5', 'elem': 99999},
    {'action': 'set', 'obj': 't', 'key': 'zz:99999', 'value': '!'},
    {'action': 'set', 'obj': 'no-such-object', 'key': 'k', 'value': 1}]}]
at = next(i for i, s in enumerate(steps)
          if s[1][0]['ops'][0]['action'] == 'del') + 1
steps.insert(at, ('bad', bad, False))

jax_pool = JaxPool()
port = NativeDocPool(device='cpu')
default = NativeDocPool(device='cpu')
record = []
for kind, body, single in steps:
    trace.reset()
    telemetry.phase_reset()
    jax_trace.reset()
    jax_trace.metrics_reset()
    if kind == 'bad':
        for pool, resident in ((port, True), (default, None)):
            try:
                run(pool, resident, 'batch', body)
                raise SystemExit('the bad batch did not raise')
            except AutomergeError:
                pass
        try:
            run(jax_pool, None, 'batch', body)
            raise SystemExit('the bad batch did not raise in the JAX pool')
        except JaxError:
            pass
        record.append({'kind': kind, 'single': single, 'port': port_counts(),
                       'jax': jax_counts(), 'equal': True})
        continue
    want = run(jax_pool, None, kind, body)
    got = run(port, True, kind, body)
    counts, jcounts = port_counts(), jax_counts()
    trace.reset()
    telemetry.phase_reset()
    plain = run(default, None, kind, body)
    record.append({'kind': kind, 'single': single, 'port': counts,
                   'jax': jcounts, 'equal': got == want,
                   'default_equal': plain == want,
                   'default': port_counts()})
final = {
    'patch_equal': port.get_patch('doc') == jax_pool.get_patch('doc')
    == default.get_patch('doc'),
    'save_equal': port.save('doc') == jax_pool.save('doc')
    == default.save('doc'),
    'live_batches': live_batch_handles(),
    'entries': len(port._resident.entries),
    'default_entries': len(default._resident.entries),
}
print('RESIDENT-RECORD ' + json.dumps({'steps': record, 'final': final}))
'''.replace('REPO_PATH', repr(REPO))


@pytest.fixture(scope='module')
def scenario():
    env = dict(os.environ, JAX_PLATFORMS='cpu', AMTPU_RESIDENT='1',
               AMTPU_RESIDENT_MIN='16', AMTPU_HOST_FULL='0',
               AMTPU_HOST_DOM='0', AMTPU_ESCALATE='1', AMTPU_HOST_REG='0',
               AMTPU_RESIDENT_CLK='1')
    env.pop('AMTPU_STORAGE_FORMAT', None)
    out = subprocess.run([sys.executable, '-c', SCENARIO], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith('RESIDENT-RECORD ')]
    assert line, out.stdout[-4000:] + out.stderr[-4000:]
    return json.loads(line[0][len('RESIDENT-RECORD '):])


def test_resident_bytes_match_jax(scenario):
    """Every step's result (batch bytes or local-change patch) and the
    final patch and save equal the JAX pool's."""
    assert all(s['equal'] for s in scenario['steps'])
    final = scenario['final']
    assert final['patch_equal'] and final['save_equal']
    assert final['live_batches'] == 0


def test_resident_counters_match_jax(scenario):
    """Both pools take the route on the same steps and count the same
    uploads and invalidations."""
    for i, s in enumerate(scenario['steps']):
        assert s['port'] == s['jax'], (i, s)


def test_resident_route_uploads_per_batch(scenario):
    """The route engages on every single-list step; after the first
    batch a keystroke uploads one row; a delete or an undo uploads
    nothing; the whole arena crosses again only after a middle-sorting
    actor or a batch that also touched another list; a batch that raised
    at begin leaves the arena as it was."""
    steps = scenario['steps']
    n_keys = 24
    for i, s in enumerate(steps):
        c = s['port']
        if s['single']:
            assert c['resident.dispatch'] == c['resident.dispatches'] == 1, i
        else:
            assert 'resident.dispatch' not in c, i
    first = steps[0]['port']
    assert first['resident.full_upload_rows'] == 600
    for s in steps[1:1 + n_keys]:
        assert s['port'] == {'resident.dispatch': 1,
                             'resident.dispatches': 1,
                             'resident.delta_upload_rows': 1}
    delete, bad, concurrent, middle, local, undo, cross = \
        steps[1 + n_keys:8 + n_keys]
    assert delete['port']['resident.no_upload'] == 1
    assert bad['kind'] == 'bad' and bad['port'] == {}
    assert concurrent['port']['resident.delta_upload_rows'] == 1
    assert middle['port']['resident.actor_invalidation'] == 1
    assert middle['port']['resident.full_upload_rows'] == 600 + n_keys + 2
    assert local['port']['resident.delta_upload_rows'] == 1
    assert undo['port']['resident.no_upload'] == 1
    assert cross['port'] == {'resident.cross_path_invalidation': 1}
    tail = steps[8 + n_keys:]
    assert len(tail) == 4
    assert tail[0]['port']['resident.full_upload_rows'] == 600 + n_keys + 4
    for s in tail[1:]:
        assert s['port']['resident.delta_upload_rows'] == 1
        assert 'resident.full_upload_rows' not in s['port']
    assert scenario['final']['entries'] == 1


def test_resident_declined_by_default_on_cpu(scenario):
    """RESIDENT = None on a CPU pool declines the route, as the JAX pool
    declines it on its CPU backend, with the same bytes."""
    for s in scenario['steps']:
        if s['kind'] != 'bad':
            assert s['default_equal']
            assert not any(k.startswith('resident.dispatch')
                           for k in s['default'])
    assert scenario['final']['default_entries'] == 0


# -- the device functions ----------------------------------------------------

def _sibling_forest(seed, n_objs=5, max_elems=80, pad=9):
    """Random insertion forests over several list objects, with many
    siblings that share a counter across actors, exact duplicates of
    (obj, parent, ctr, actor) and invalid padding rows (which tie on
    every key)."""
    rng = random.Random(seed)
    obj, parent, ctr, actor = [], [], [], []
    for o in range(n_objs):
        base = len(obj)
        for i in range(rng.randint(1, max_elems)):
            obj.append(o)
            parent.append(-1 if i == 0 or rng.random() < 0.15
                          else base + rng.randrange(min(i, 4)))
            ctr.append(rng.randint(1, 6))
            actor.append(rng.randrange(3))
    n = len(obj)
    valid = np.array([True] * n + [False] * pad)
    cols = [np.array(x + [f] * pad, np.int32)
            for x, f in ((obj, 0), (parent, -1), (ctr, 0), (actor, 0))]
    perm = np.random.RandomState(seed).permutation(n + pad)
    return [c[perm] for c in cols] + [valid[perm]]


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 4, 5])
def test_sibling_sort_and_linearize_match_jax(seed):
    """The device sibling sort gives jnp.lexsort's permutation, and
    linearize with sort_idx=None the JAX in-graph ranks."""
    obj, parent, ctr, actor, valid = _sibling_forest(seed)
    n_iters = LR.ceil_log2(len(obj)) + 1
    t = torch.from_numpy
    perm = LR.sibling_sort(t(obj), t(parent), t(ctr), t(actor), t(valid))
    want_perm = np.asarray(jnp.lexsort((
        -jnp.asarray(actor), -jnp.asarray(ctr), jnp.asarray(parent),
        jnp.where(jnp.asarray(valid), jnp.asarray(obj), 2 ** 30))))
    assert perm.dtype == torch.int32
    assert (perm.numpy() == want_perm).all()
    want = np.asarray(jax_list_rank.linearize(obj, parent, ctr, actor, valid,
                                              n_iters, sort_idx=None))
    got = LR.linearize(t(obj), t(parent), t(ctr), t(actor), t(valid),
                       n_iters)
    assert (got.numpy() == want).all()


def _resident_case(seed, C=256, window=4, Tp=128):
    """Register columns and a single-object arena of capacity C with
    n_elems live rows, its visibility and [1, Tp] op arrays."""
    regs = _RegisterCases()._random_case(seed, window=window)
    T = len(regs[0])
    rs = np.random.RandomState(seed)
    n = int(rs.randint(C // 2, C))
    par = np.full(C, -1, np.int32)
    for i in range(1, n):
        par[i] = -1 if rs.random_sample() < 0.1 else rs.randint(0, i)
    ctr = np.zeros(C, np.int32)
    ctr[:n] = rs.randint(1, 30, n)
    act = np.zeros(C, np.int32)
    act[:n] = rs.randint(0, 4, n)
    ev = np.zeros(C, np.float32)
    ev[:n] = rs.random_sample(n) < 0.7
    n_ops = int(rs.randint(1, Tp))
    ov = np.zeros((1, Tp), bool)
    ov[0, :n_ops] = True
    oe = np.where(ov, rs.randint(0, n, (1, Tp)), -1).astype(np.int32)
    dom_src = np.where(ov & (rs.random_sample((1, Tp)) < 0.9),
                       rs.randint(0, T, (1, Tp)), -1).astype(np.int32)
    return regs, (par, ctr, act, ev, n, oe, dom_src, ov)


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_resolve_rank_dominate_resident_matches_jax(seed):
    window = 4
    regs, (par, ctr, act, ev, n, oe, dom_src, ov) = _resident_case(
        seed, window=window)
    group, time, actor, seq, is_del, sort_idx, clock_table, idx = regs
    n_iters = LR.ceil_log2(len(par)) + 1
    reg_w, rank_w, combo_w = jax_registers.resolve_rank_dominate_resident(
        group, time, actor, seq, clock_table, idx, is_del,
        np.ones_like(is_del), sort_idx, par, ctr, act, ev, np.int32(n), oe,
        dom_src, ov, n_iters=n_iters, window=window)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    reg, rank, combo = R.resolve_rank_dominate_resident(
        t(group), t(time), t(actor), t(seq), t(clock_table).to(torch.int32),
        t(idx), t(is_del), t(sort_idx), t(par), t(ctr), t(act), t(ev), n,
        t(oe), t(dom_src), t(ov), n_iters=n_iters, window=window)
    assert (rank.numpy() == np.asarray(rank_w)).all()
    for k in ('winner', 'alive_after', 'conflicts', 'visible_before',
              'packed'):
        assert (reg[k].numpy() == np.asarray(reg_w[k])).all(), k
    assert combo.dtype == torch.int32
    assert (combo.numpy() == np.asarray(combo_w)).all()
