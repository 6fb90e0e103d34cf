"""The sp fence of the port's `MeshDocPool(dp=1, sp=2)` against the JAX
package's mesh pool under AMTPU_MESH=1,2.

A long text and `workloads.keystroke_edits` go, step by step, through a
JAX mesh pool and a port `MeshDocPool(1, 2, device='cpu')` (its resident
arena forced on, as a CPU pool declines it), in two arms: the sharded
arm (the JAX pool's AMTPU_MESH_SP_MIN and the port pool's `sp_min` at
16, so every resident dispatch shards the arena over two sp blocks: the
block kernel's plain version on each, one sum) and the fenced arm (the
default crossover, 131,072 elements: every resident dispatch stays on
one device).  Every step's bytes and the counters `mesh.sp_engaged`,
`mesh.sp_fenced`, `resident.dispatches` and `resident.sharded_dispatch`
must be equal.  C++ decides which batches qualify for the resident arena
from statics that latch at a library copy's first batch, and the JAX
pool's AMTPU_MESH latches too, so the scenario runs in a subprocess with
AMTPU_RESIDENT=1, AMTPU_RESIDENT_MIN=16 and AMTPU_MESH=1,2.
"""

import json
import os
import subprocess
import sys

import pytest
from torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENARIO = r'''
import json
import os
import sys
sys.path.insert(0, REPO_PATH)
import jax
jax.config.update('jax_platforms', 'cpu')
import msgpack
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu import trace as jax_trace
from automerge_tpu.native import make_pool as jax_make_pool
from automerge_tpu_torch import native, telemetry, workloads
from automerge_tpu_torch.native import live_batch_handles
from automerge_tpu_torch.native.mesh_pool import MeshDocPool

METRICS = ('mesh.sp_engaged', 'mesh.sp_fenced', 'resident.dispatches')
N = 600
jax_trace.ENABLED = True
telemetry.enable()
native.RESIDENT = True


def jax_counts():
    snap = jax_telemetry.metrics_snapshot()
    out = {k: snap[k] for k in METRICS if snap.get(k)}
    n = jax_trace.snapshot().get('resident.sharded_dispatch', {}).get('n')
    if n:
        out['resident.sharded_dispatch'] = n
    return out


def port_counts():
    snap = telemetry.metrics_snapshot()
    out = {k: snap[k] for k in METRICS if snap.get(k)}
    n = telemetry.phase_snapshot().get('resident.sharded_dispatch',
                                       {}).get('n')
    if n:
        out['resident.sharded_dispatch'] = n
    return out


def run(pool, kind, body):
    if kind == 'batch':
        return pool.apply_batch_bytes(msgpack.packb({'doc': body},
                                                    use_bin_type=True))
    return pool.apply_local_change('doc', dict(body))


steps = [('batch', workloads.long_text_doc(N), True)] + \
    workloads.keystroke_edits(N, n_keys=8)
out = {}
for arm, sp_min in (('sharded', 16), ('fenced', None)):
    if sp_min is None:
        os.environ.pop('AMTPU_MESH_SP_MIN', None)
        port = MeshDocPool(1, 2, device='cpu')
    else:
        os.environ['AMTPU_MESH_SP_MIN'] = str(sp_min)
        port = MeshDocPool(1, 2, device='cpu', sp_min=sp_min)
    jax_pool = jax_make_pool()
    assert (jax_pool.dp, jax_pool.sp) == (1, 2), type(jax_pool)
    record = []
    for kind, body, single in steps:
        jax_telemetry.metrics_reset()
        jax_trace.reset()
        telemetry.metrics_reset()
        telemetry.phase_reset()
        want = run(jax_pool, kind, body)
        got = run(port, kind, body)
        record.append({'single': single, 'equal': got == want,
                       'jax': jax_counts(), 'port': port_counts()})
    out[arm] = {'steps': record,
                'patch_equal': port.get_patch('doc') ==
                jax_pool.get_patch('doc'),
                'save_equal': port.save('doc') == jax_pool.save('doc')}
out['live_batches'] = live_batch_handles()
print('FENCE-RECORD ' + json.dumps(out))
'''.replace('REPO_PATH', repr(REPO))


@pytest.fixture(scope='module')
def scenario():
    env = dict(os.environ, JAX_PLATFORMS='cpu', AMTPU_RESIDENT='1',
               AMTPU_RESIDENT_MIN='16', AMTPU_MESH='1,2',
               AMTPU_HOST_FULL='0', AMTPU_HOST_DOM='0', AMTPU_ESCALATE='1',
               AMTPU_HOST_REG='0', AMTPU_RESIDENT_CLK='1')
    env.pop('AMTPU_STORAGE_FORMAT', None)
    env.pop('AMTPU_MESH_SP_MIN', None)
    out = subprocess.run([sys.executable, '-c', SCENARIO], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith('FENCE-RECORD ')]
    assert line, out.stdout[-4000:] + out.stderr[-4000:]
    return json.loads(line[0][len('FENCE-RECORD '):])


@pytest.mark.parametrize('arm', ['sharded', 'fenced'])
def test_fence_bytes_match_jax(scenario, arm):
    rec = scenario[arm]
    assert all(s['equal'] for s in rec['steps'])
    assert rec['patch_equal'] and rec['save_equal']
    assert scenario['live_batches'] == 0


@pytest.mark.parametrize('arm', ['sharded', 'fenced'])
def test_fence_counters_match_jax(scenario, arm):
    for i, s in enumerate(scenario[arm]['steps']):
        assert s['port'] == s['jax'], (arm, i, s)


def test_fence_decides_every_resident_dispatch(scenario):
    """Every single-list step takes the resident arena; in the sharded arm
    each one engages the sp blocks, in the fenced arm each is fenced."""
    for arm, key in (('sharded', 'mesh.sp_engaged'),
                     ('fenced', 'mesh.sp_fenced')):
        for s in scenario[arm]['steps']:
            c = s['port']
            if s['single']:
                assert c.get('resident.dispatches') == 1 == c.get(key), s
                assert c.get('resident.sharded_dispatch', 0) == \
                    (1 if arm == 'sharded' else 0)
            else:
                assert 'resident.dispatches' not in c, s
