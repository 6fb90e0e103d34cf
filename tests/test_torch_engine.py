"""The port's batched engine against the JAX package's.

`automerge_tpu_torch.parallel.engine.TPUDocPool(device='cpu')` (the
kernels' plain versions) and `automerge_tpu.parallel.engine.TPUDocPool`
get the same changes; their patches, their `fallback.*` counters, their
query answers and their checkpoint bytes must be equal.  Workloads: the
first 64 docs of bench config 3, the first 32 of config 4, hot keys of
9, 16, 40 and 200 concurrent writers (through the escalation tiers),
local changes with undo and redo, shuffled and duplicated delivery and
the engines' errors.
"""

import random

import numpy as np
import pytest
import torch

from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.parallel.engine import TPUDocPool as JaxEngine
from automerge_tpu_torch import native, trace, workloads
from automerge_tpu_torch.parallel.engine import TPUDocPool
from torch_threads import cap_threads

cap_threads()

ROOT = '00000000-0000-0000-0000-000000000000'


def fallback(metrics):
    return {k: v for k, v in metrics.items() if k.startswith('fallback.')}


class Twin:
    """A port engine and a JAX engine fed the same calls; every answer
    and every exception must be equal."""

    def __init__(self):
        self.port = TPUDocPool(device='cpu')
        self.ref = JaxEngine()

    def call(self, name, *args):
        try:
            want = getattr(self.ref, name)(*args)
        except Exception as e:
            # the packages' error classes are distinct: equal names
            with pytest.raises(Exception) as got:
                getattr(self.port, name)(*args)
            assert (type(got.value).__name__, str(got.value)) == \
                (type(e).__name__, str(e))
            return None
        got = getattr(self.port, name)(*args)
        assert got == want, name
        return got

    def apply_batch(self, batch):
        """One batch through both; also returns each side's fallback.*
        counters of the batch."""
        jax_telemetry.metrics_reset()
        trace.reset()
        out = self.call('apply_batch', batch)
        want = fallback(jax_telemetry.metrics_snapshot())
        got = fallback(trace.metrics())
        assert got == want
        return out, got


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default engine is valid')
    with pytest.raises(RuntimeError, match='TPUDocPool.*CUDA'):
        TPUDocPool()


def test_unknown_device_rejected():
    with pytest.raises(ValueError):
        TPUDocPool(device='meta')


def test_config3_first_64_docs():
    twin = Twin()
    batch = workloads.build_config_3(random.Random(7), n_docs=64)
    patches, counters = twin.apply_batch(batch)
    assert len(patches) == 64 and counters == {}
    for d in (0, 17, 63):
        twin.call('get_patch', d)
        twin.call('save', d)


def test_config4_first_32_docs():
    twin = Twin()
    patches, _ = twin.apply_batch(
        workloads.build_config_4(random.Random(7), n_docs=32))
    assert len(patches) == 32
    twin.call('get_patch', 5)


@pytest.mark.parametrize('n_writers', [9, 16, 40, 200])
def test_hot_key(n_writers):
    """One hot key beside a list: the sliding window saturates and the
    group climbs the tiers (16 for 9 and 16 writers, 64 for 40, 256 for
    200), with no oracle row, in both engines."""
    twin = Twin()
    setup, writers = workloads.hot_key_batch(n_writers)
    twin.apply_batch(setup)
    _, counters = twin.apply_batch(writers)
    tier = 16 if n_writers <= 16 else 64 if n_writers <= 64 else 256
    assert counters == {'fallback.escalated.w%d' % tier: n_writers}
    twin.call('get_patch', 'doc')


def test_config5_cut_counters():
    """Two cut config-5 docs (64 concurrent writers per key) in one batch:
    every tier row and the patches equal."""
    twin = Twin()
    _, counters = twin.apply_batch(workloads.build_config_5(
        random.Random(3), n_docs=2, n_changes=2))
    assert counters and 'fallback.oracle' not in counters


def local_request(actor, seq, request_type='change', ops=(), deps=None):
    req = {'requestType': request_type, 'actor': actor, 'seq': seq,
           'deps': deps or {}}
    if request_type == 'change':
        req['ops'] = list(ops)
    return req


def test_local_changes_undo_redo():
    twin = Twin()
    twin.call('apply_local_change', 'd', local_request('a', 1, ops=[
        {'action': 'makeList', 'obj': 'L'},
        {'action': 'link', 'obj': ROOT, 'key': 'l', 'value': 'L'},
        {'action': 'ins', 'obj': 'L', 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': 'L', 'key': 'a:1', 'value': 'x'},
        {'action': 'set', 'obj': ROOT, 'key': 'k', 'value': 1}]))
    twin.call('apply_local_change', 'd', local_request('a', 2, ops=[
        {'action': 'set', 'obj': ROOT, 'key': 'k', 'value': 2},
        {'action': 'del', 'obj': 'L', 'key': 'a:1'}]))
    twin.call('apply_batch', {'d': [{'actor': 'b', 'seq': 1,
                                     'deps': {'a': 1}, 'ops': [
                                         {'action': 'set', 'obj': ROOT,
                                          'key': 'k', 'value': 'b'}]}]})
    twin.call('apply_local_change', 'd', local_request('a', 3, 'undo'))
    twin.call('apply_local_change', 'd', local_request('a', 4, 'redo'))
    twin.call('apply_local_change', 'd', local_request('a', 5, 'undo'))
    twin.call('apply_local_change', 'd', local_request('a', 6, 'undo'))
    # errors: nothing to redo after a change, a reused seq, bad requests
    twin.call('apply_local_change', 'd', local_request('a', 7, ops=[
        {'action': 'set', 'obj': ROOT, 'key': 'z', 'value': 0}]))
    twin.call('apply_local_change', 'd', local_request('a', 8, 'redo'))
    twin.call('apply_local_change', 'd', local_request('a', 3, ops=[]))
    twin.call('apply_local_change', 'd', {'requestType': 'change'})
    twin.call('apply_local_change', 'd', local_request('a', 9, 'bogus'))
    twin.call('get_patch', 'd')


def test_queries_under_shuffled_and_duplicated_delivery():
    twin = Twin()
    batch = workloads.build_config_3(random.Random(3), n_docs=3,
                                     n_actors=3)
    rng = random.Random(5)
    for d, chs in batch.items():
        chs = list(chs) + [chs[1]]
        rng.shuffle(chs)
        for k in range(0, len(chs), 2):
            twin.call('apply_batch', {d: chs[k:k + 2]})
            twin.call('get_missing_deps', d)
            twin.call('get_clock', d)
    for d in batch:
        twin.call('get_patch', d)
        twin.call('get_missing_changes', d, {})
        twin.call('get_missing_changes', d, {'a0': 2, 'a1': 1})
        twin.call('get_changes_for_actor', d, 'a1')
        twin.call('get_changes_for_actor', d, 'a0', 1)
    twin.call('get_patch', 'never-seen')
    twin.call('get_missing_deps', 'never-seen')


def test_errors_roll_back_equally():
    twin = Twin()
    good = {'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': 'T'},
        {'action': 'ins', 'obj': 'T', 'key': '_head', 'elem': 1}]}
    twin.call('apply_batch', {'d': [good]})
    for bad in (
            [{'action': 'set', 'obj': 'nope', 'key': 'k', 'value': 1}],
            [{'action': 'ins', 'obj': 'T', 'key': 'a:1', 'elem': 1}],
            [{'action': 'ins', 'obj': 'T', 'key': 'zz:9', 'elem': 2}],
            [{'action': 'set', 'obj': 'T', 'key': 'zz:9', 'value': 1}],
            [{'action': 'makeMap', 'obj': 'T'}],
            [{'action': 'frobnicate', 'obj': ROOT, 'key': 'k'}]):
        twin.call('apply_batch', {'d': [{'actor': 'b', 'seq': 1,
                                         'deps': {'a': 1}, 'ops': bad}]})
    # an inconsistent reuse of a seq
    twin.call('apply_batch', {'d': [dict(good, ops=[])]})
    twin.call('get_patch', 'd')


@pytest.mark.parametrize('fmt', ['columnar', 'json'])
def test_save_and_load_jax_bytes(fmt, monkeypatch):
    monkeypatch.setattr(native, 'STORAGE_FORMAT', fmt)
    monkeypatch.setenv('AMTPU_STORAGE_FORMAT', fmt)
    twin = Twin()
    batch = workloads.build_config_3(random.Random(11), n_docs=4)
    twin.apply_batch(batch)
    twin.call('apply_batch', {0: [{'actor': 'zz', 'seq': 1,
                                   'deps': {'a0': 1}, 'ops': [
                                       {'action': 'set', 'obj': ROOT,
                                        'key': 'k', 'value': 1.5}]}]})
    for d in batch:
        blob = twin.call('save', d)
        fresh = Twin()
        # the port loads the JAX engine's bytes and saves them again
        assert fresh.port.load(d, blob) == fresh.ref.load(d, blob)
        assert fresh.port.save(d) == blob
    twin.call('load', 'x', b'not a checkpoint')


def random_register_rows(rs, T, A, n_groups):
    """Register columns with a few wide groups (same-actor successors and
    same-seq duplicates among them) in shuffled row order."""
    group = rs.randint(0, n_groups, T).astype(np.int32)
    group[rs.random_sample(T) < 0.05] = -1
    time_ = rs.permutation(T).astype(np.int32)
    actor = rs.randint(0, A, T).astype(np.int32)
    seq = rs.randint(1, 4, T).astype(np.int32)
    is_del = rs.random_sample(T) < 0.1
    clock = rs.randint(0, 3, (T, A)).astype(np.int32)
    return group, time_, actor, seq, is_del, clock


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_member_windows_and_ladder_equal_jax(seed):
    """`_member_windows` gives the JAX package's CSR records, and the
    ladder over them (`escalate_overflow`, then `merge_escalated`) the
    JAX package's rows and tier counts."""
    from automerge_tpu.ops import registers as JR
    from automerge_tpu_torch.ops import registers as PR
    rs = np.random.RandomState(seed)
    group, time_, actor, seq, is_del, clock = random_register_rows(
        rs, 600, 40, 6)
    for g in range(6):
        rows = np.nonzero(group == g)[0]
        rows = rows[np.argsort(time_[rows], kind='stable')]
        got = PR._member_windows(rows, actor, seq)
        want = JR._member_windows(rows, actor, seq)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    overflow = rs.random_sample(600) < 0.02
    cidx = np.arange(600, dtype=np.int32)
    want, w_oracle, w_tiers = JR.escalate_overflow(
        group, time_, actor, seq, is_del, clock, cidx, overflow)
    got, g_oracle, g_tiers = PR.escalate_overflow(
        group, time_, actor, seq, is_del, torch.from_numpy(clock), cidx,
        overflow)
    assert got and got == want and g_tiers == w_tiers
    np.testing.assert_array_equal(g_oracle, w_oracle)
    base = [np.full(600, -1, np.int32), np.full((600, 8), -1, np.int32),
            np.zeros(600, np.int32), overflow.copy()]
    merged = PR.merge_escalated(*[x.copy() for x in base], got)
    ref = JR.merge_escalated(*[x.copy() for x in base], want)
    for x, y in zip(merged, ref):
        np.testing.assert_array_equal(x, y)
