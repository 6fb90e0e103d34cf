"""The port's `MeshDocPool` against the JAX package's.

`automerge_tpu_torch.native.mesh_pool.MeshDocPool(dp, device='cpu')`
(dp chips, every one on the CPU: the kernels' plain versions) must give
the result bytes of the JAX `MeshDocPool(dp)` (on `tests/conftest.py`'s 8
virtual CPU devices) on `tests/test_meshpool.py`'s workload at dp 1, 2
and 4, answer the per-doc queries of the chip that owns the doc,
quarantine one poisoned doc and no other, count what the JAX pool counts
under `mesh.*`, and keep `fallback.oracle` at 0 where the JAX pool does.
The sp fence runs in `tests/test_torch_mesh_fence.py` (a subprocess: its
knobs latch per process).
"""

import msgpack
import pytest

from automerge_tpu import faults as jax_faults
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.native.mesh_pool import MeshDocPool as JaxMeshPool
from automerge_tpu_torch import faults, resilience, telemetry
from automerge_tpu_torch.native import NativeDocPool, make_pool
from automerge_tpu_torch.native.mesh_pool import (MeshChipPool, MeshDocPool,
                                                  parse_mesh)
from automerge_tpu_torch.sidecar.server import SidecarBackend
from test_meshpool import _per_doc, _real_workload
from torch_threads import cap_threads

cap_threads()

#: the mesh counters the two pools must agree on (the rest are times)
MESH_COUNTS = ('mesh.batches', 'mesh.shards', 'mesh.chip_docs',
               'mesh.occupancy_skew')


@pytest.fixture(autouse=True)
def kernel_path_env(monkeypatch):
    for k, v in (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                 ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                 ('AMTPU_RESIDENT_CLK', '1')):
        monkeypatch.setenv(k, v)


@pytest.fixture(scope='module')
def workload():
    docs = _real_workload()
    return docs, msgpack.packb(docs, use_bin_type=True)


def counts(snap):
    return {k: snap.get(k, 0) for k in MESH_COUNTS + ('fallback.oracle',)}


@pytest.mark.parametrize('dp', [1, 2, 4])
def test_mesh_pool_bytes_match_jax(dp, workload):
    docs, payload = workload
    jax_telemetry.metrics_reset()
    jax_pool = JaxMeshPool(dp=dp)
    want = jax_pool.apply_batch_bytes(payload)
    jax_counts = counts(jax_telemetry.metrics_snapshot())
    telemetry.metrics_reset()
    pool = MeshDocPool(dp, device='cpu')
    got = pool.apply_batch_bytes(payload)
    assert got == want
    snap = telemetry.metrics_snapshot()
    assert counts(snap) == jax_counts
    assert jax_counts['fallback.oracle'] == 0
    assert snap.get('mesh.device_shortfall', 0) == (1 if dp > 1 else 0)
    assert len(pool.pools) == dp and all(
        isinstance(p, MeshChipPool) and p.stream is None for p in pool.pools)
    for d in list(docs)[:6]:
        assert pool.get_patch(d) == jax_pool.get_patch(d)
        assert pool.get_clock(d) == jax_pool.get_clock(d)
        assert pool.save(d) == jax_pool.save(d)


def test_mesh_pool_second_batch_and_dict_api(workload):
    """A second batch on the same chips (their clock tables and arenas
    from the first) and the dict API equal the JAX pool's."""
    docs, payload = workload
    jax_pool, pool = JaxMeshPool(dp=2), MeshDocPool(2, device='cpu')
    assert pool.apply_batch_bytes(payload) == \
        jax_pool.apply_batch_bytes(payload)
    doc = sorted(docs)[0]
    more = {doc: [{'actor': 'zz', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': '00000000-0000-0000-0000-000000000000',
         'key': 'late', 'value': 7}]}]}
    assert pool.apply_batch(more) == jax_pool.apply_batch(more)
    assert pool.get_patch(doc) == jax_pool.get_patch(doc)


def test_mesh_pool_poison_doc_quarantines_only_that_doc(workload):
    docs, payload = workload
    want = _per_doc(JaxMeshPool(dp=4).apply_batch_bytes(payload))
    poison = sorted(docs)[len(docs) // 2]
    jax_faults.arm('device.dispatch', 'permanent', 1.0, match=poison)
    try:
        jax_got = _per_doc(JaxMeshPool(dp=4).apply_batch_bytes_resilient(
            payload))
    finally:
        jax_faults.disarm()
    telemetry.metrics_reset()
    faults.arm('device.dispatch', 'permanent', 1.0, match=poison)
    try:
        got = _per_doc(MeshDocPool(4, device='cpu')
                       .apply_batch_bytes_resilient(payload))
    finally:
        faults.disarm()
    quarantined = [d for d in got if resilience.is_quarantined(
        msgpack.unpackb(got[d], raw=False, strict_map_key=False))]
    assert quarantined == [poison]
    assert telemetry.metrics_snapshot().get('resilience.quarantined') == 1
    assert got == jax_got
    assert all(got[d] == want[d] for d in want if d != poison)


def test_make_pool_builds_a_mesh_pool():
    pool = make_pool('cpu', mesh=(2, 1))
    assert isinstance(pool, MeshDocPool) and (pool.dp, pool.sp) == (2, 1)
    pool = make_pool('cpu', mesh=(1, 4))
    assert (pool.dp, pool.sp) == (1, 4)
    assert pool.pools[0]._resident.sp_devices is not None
    assert type(make_pool('cpu')) is NativeDocPool
    assert type(make_pool('cpu', mesh=(0, 1))) is NativeDocPool
    backend = SidecarBackend(device='cpu', mesh=(2, 1))
    assert isinstance(backend.pool, MeshDocPool)


def test_parse_mesh_is_the_jax_packages_parse():
    from automerge_tpu.utils.common import parse_mesh_env
    for text in ('4', '4,2', '2,', ' 1,2', '0', '0,3', '-1', '', '3,0'):
        assert parse_mesh(text) == parse_mesh_env(text), text
    for bad in ('banana', '1,2,3', 'dp=2'):
        with pytest.raises(ValueError):
            parse_mesh(bad)
        with pytest.raises(ValueError):
            parse_mesh_env(bad)


def test_mesh_pool_sp_blocks_only_for_one_chip():
    """The sp fence's placement: a resident arena shards only in a
    MeshDocPool of dp = 1, over the largest power of two of blocks at
    most sp, and only from sp_min elements on (counted per decision)."""
    assert MeshDocPool(2, 2, device='cpu').pools[0]._resident \
        .sp_devices is None
    res = MeshDocPool(1, 3, device='cpu', sp_min=64).pools[0]._resident
    assert len(res.sp_devices) == 2
    telemetry.metrics_reset()
    assert res.sp_blocks(32, count=True) is None
    assert res.sp_blocks(128, count=True) is not None
    assert res.sp_blocks(129) is None
    snap = telemetry.metrics_snapshot()
    assert (snap.get('mesh.sp_fenced'), snap.get('mesh.sp_engaged')) == \
        (1, 1)


def test_mesh_pool_default_device_is_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        MeshDocPool(2)
    with pytest.raises(ValueError):
        MeshDocPool(0, device='cpu')
