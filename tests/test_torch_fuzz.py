"""The reference's fuzz schedules against the port.

Every lane of tests/test_adversarial_fuzz.py and
tests/test_engine_differential.py runs here with the reference's own
generators and assertions, with `PortTwin` in place of the JAX engine
pool (`TPUDocPool`): a port CPU pool and a JAX NativeDocPool that get
the same payload bytes at every delivery and must return the same bytes
(apply, local change, save, load, missing deps, patches), and the port's
own engine (`automerge_tpu_torch.parallel.engine.TPUDocPool(device=
'cpu')`) that gets the same changes and must return the same patches,
checkpoint bytes and errors.  The lanes still check each pool against
the scalar oracle, so every delivery is held four ways.  The engine's
counters are kept apart from the pools' (`ENGINE_COUNTERS`), so the
lanes' counter checks read the pools' alone.  Both execution modes of the JAX pool face the
adversarial lanes, as in the reference (the port has one: its kernel
path); where a reference lane asserts JAX telemetry, the port lane also
asserts the port's own counters from `automerge_tpu_torch.trace`.
"""

import msgpack
import pytest

from automerge_tpu.native import NativeDocPool as JaxPool
from automerge_tpu_torch import telemetry, trace
from automerge_tpu_torch.native import NativeDocPool, live_batch_handles
from automerge_tpu_torch.parallel.engine import TPUDocPool
from automerge_tpu_torch.ops import registers as R
from automerge_tpu_torch.utils import doc_key
from tests import test_adversarial_fuzz as adv
from tests import test_engine_differential as diff


#: the `fallback.*` counters the port engines of a lane added
ENGINE_COUNTERS = {}


class PortTwin:
    """A port CPU pool with a JAX NativeDocPool beside it: every call
    goes to both, with the same bytes, and their answers must be
    equal.  The port's engine gets the same call and must answer alike:
    the same patches, bytes and query answers, or an error of the same
    name and message."""

    def __init__(self):
        self.port = NativeDocPool(device='cpu')
        self.ref = JaxPool()
        self.engine = TPUDocPool(device='cpu')

    def _engine(self, name, *args):
        """(result, None) or (None, exception) of the engine's call, its
        counters moved from the shared table into ENGINE_COUNTERS."""
        before = telemetry.metrics_snapshot()
        try:
            return getattr(self.engine, name)(*args), None
        except Exception as e:
            return None, e
        finally:
            after = telemetry.metrics_snapshot()
            telemetry.metrics_reset()
            for k, v in before.items():
                telemetry.metric(k, v)
            for k, v in after.items():
                if k.startswith('fallback.') and v != before.get(k, 0):
                    ENGINE_COUNTERS[k] = ENGINE_COUNTERS.get(k, 0) + \
                        v - before.get(k, 0)

    def _engine_equal(self, want, name, *args):
        got, err = self._engine(name, *args)
        assert err is None, (name, err)
        assert got == want, 'engine %s' % name

    def _engine_raises(self, exc, name, *args):
        _, err = self._engine(name, *args)
        assert err is not None, 'engine %s did not raise %r' % (name, exc)
        assert (type(err).__name__, str(err)) == \
            (type(exc).__name__, str(exc)), name

    def apply_batch(self, batch):
        payload = msgpack.packb({doc_key(d): chs for d, chs in batch.items()},
                                use_bin_type=True)
        try:
            got = self.port.apply_batch_bytes(payload)
        except Exception as e:
            self._engine_raises(e, 'apply_batch', batch)
            raise
        assert got == self.ref.apply_batch_bytes(payload)
        out = msgpack.unpackb(got, raw=False, strict_map_key=False)
        out = {d: out[doc_key(d)] for d in batch}
        self._engine_equal(out, 'apply_batch', batch)
        return out

    def _both(self, name, *args):
        try:
            got = getattr(self.port, name)(*args)
        except Exception as e:
            self._engine_raises(e, name, *args)
            raise
        assert got == getattr(self.ref, name)(*args), name
        self._engine_equal(got, name, *args)
        return got

    def apply_local_change(self, doc_id, request):
        return self._both('apply_local_change', doc_id, request)

    def get_patch(self, doc_id):
        return self._both('get_patch', doc_id)

    def get_missing_deps(self, doc_id):
        return self._both('get_missing_deps', doc_id)

    def save(self, doc_id):
        return self._both('save', doc_id)

    def load(self, doc_id, data):
        return self._both('load', doc_id, data)


@pytest.fixture(autouse=True)
def port_twin(monkeypatch):
    monkeypatch.setattr(adv, 'TPUDocPool', PortTwin)
    monkeypatch.setattr(diff, 'TPUDocPool', PortTwin)
    monkeypatch.setenv('AMTPU_RESIDENT_CLK', '1')
    trace.reset()
    ENGINE_COUNTERS.clear()
    yield
    assert live_batch_handles() == 0
    assert ENGINE_COUNTERS.get('fallback.oracle', 0) == 0, ENGINE_COUNTERS


@pytest.fixture(params=['default', 'kernel'])
def exec_mode(request, monkeypatch):
    """The JAX pools' two execution modes, as the reference lanes run
    them: the CPU default (full host path) and the kernel path."""
    if request.param == 'kernel':
        monkeypatch.setenv('AMTPU_HOST_FULL', '0')
    return request.param


@pytest.fixture(params=['packed', 'unpacked'])
def packed_epilogue(request, monkeypatch):
    monkeypatch.setenv('AMTPU_PACKED_EPILOGUE',
                       '1' if request.param == 'packed' else '0')
    return request.param


def port_counters():
    m = trace.metrics()
    assert m.get('fallback.oracle', 0) == 0, m
    return m


def resolved_on_device(m):
    """Rows of groups wider than the member window went up the ladder
    or, up to SLIDING_MAX rows, into one wide sliding window."""
    return any(k.startswith('fallback.escalated.w') for k in m) or \
        m.get('registers.sliding_over_members', 0) > 0


# -- tests/test_adversarial_fuzz.py ------------------------------------------

@pytest.mark.parametrize('n_writers', [9, 12, 15, 17, 20, 33])
def test_map_hot_keys(n_writers, exec_mode):
    adv.TestWideAntichains().test_map_hot_keys(n_writers, exec_mode)
    port_counters()


def test_list_element_antichain(exec_mode):
    adv.TestWideAntichains().test_list_element_antichain(exec_mode)
    port_counters()


def fallback_free_on_port(run, exec_mode, expect_escalated=True):
    """The port's stand-in for the reference's check of JAX telemetry
    (which only its engine pool fed): no row took the port's C++ oracle,
    and the wide groups resolved on the device."""
    trace.reset()
    run()
    m = port_counters()
    if expect_escalated:
        assert resolved_on_device(m), (exec_mode, m)
    return m


def escalation_lanes():
    lanes = adv.TestEscalationFallbackFree()
    lanes._assert_kernel_fallback_free = fallback_free_on_port
    return lanes


@pytest.mark.parametrize('n_writers', [9, 15, 17, 33, 100, 120])
def test_concurrent_live_writers_one_key(n_writers, exec_mode):
    escalation_lanes().test_concurrent_live_writers_one_key(n_writers,
                                                            exec_mode)
    m = trace.metrics()
    tiers = {k for k in m if k.startswith('fallback.escalated.w')}
    if n_writers <= R.SLIDING_MAX:
        assert not tiers and m['registers.sliding_over_members'] > 0, m
    else:
        assert tiers, m


def test_table_shape_dup_assigns(exec_mode):
    escalation_lanes().test_table_shape_dup_assigns(exec_mode)


def test_oracle_referee_parity(exec_mode, monkeypatch):
    """The reference lane's workload with AMTPU_ESCALATE=0: the JAX pools
    resolve the 20-writer key through their C++ oracle (counted on the
    kernel path, where the host-register shortcut is off), the port,
    which has no such switch, through its ladder, to the same bytes."""
    from automerge_tpu import telemetry
    monkeypatch.setenv('AMTPU_ESCALATE', '0')
    if exec_mode == 'kernel':
        monkeypatch.setenv('AMTPU_HOST_REG', '0')
    telemetry.metrics_reset()
    writers = [{'actor': 'w%02d' % a, 'seq': 1, 'deps': {},
                'ops': [{'action': 'set', 'obj': adv.ROOT_ID, 'key': 'k',
                         'value': a}]}
               for a in range(20)]
    adv.deliver_all([{0: writers}])
    if exec_mode == 'kernel':
        assert telemetry.metrics_snapshot().get('fallback.oracle', 0) > 0
    assert 'fallback.escalated.w32' in port_counters()


def test_wide_antichain_with_list_dominance(exec_mode):
    escalation_lanes().test_wide_antichain_with_list_dominance(exec_mode)
    assert 'fallback.escalated.w32' in trace.metrics()


def test_member_epilogue_byte_parity(packed_epilogue, exec_mode):
    """The JAX toggle picks its member epilogue; the port's member
    batches always take the packed one (below PACKED_ROWS_MAX rows)."""
    adv.TestPackedEpilogueParity().test_member_epilogue_byte_parity(
        packed_epilogue, exec_mode)
    m = port_counters()
    assert m.get('collect.packed_member_batches', 0) > 0, m


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_rotating_hot_key_fuzz(seed, packed_epilogue, exec_mode):
    adv.TestPackedEpilogueParity().test_rotating_hot_key_fuzz(
        seed, packed_epilogue, exec_mode)
    port_counters()


def test_deep_chain_reversed(exec_mode):
    adv.TestReversedCausalChains().test_deep_chain_reversed(exec_mode)
    port_counters()


def test_cross_doc_reversed_streams(exec_mode):
    adv.TestReversedCausalChains().test_cross_doc_reversed_streams(exec_mode)
    port_counters()


def test_undo_redo_interleaved_with_remote_batches():
    adv.TestUndoRedoUnderMerge(
    ).test_undo_redo_interleaved_with_remote_batches()
    port_counters()


@pytest.mark.parametrize('seed', [801, 802])
def test_checkpoint_restore_continue(seed):
    """Save mid-stream, load into fresh pools, redeliver everything: the
    saves, loads, every delivery and the final `get_missing_deps` equal
    the JAX pool's."""
    adv.TestSaveLoadMidStream().test_checkpoint_restore_continue(seed)
    m = port_counters()
    assert m.get('storage.native_loads', 0) == 1


def test_concurrent_row_lifecycle(exec_mode):
    adv.TestTableAdversarial().test_concurrent_row_lifecycle(exec_mode)
    port_counters()


def test_two_parent_row_first_link_removed(exec_mode):
    adv.TestTableAdversarial().test_two_parent_row_first_link_removed(
        exec_mode)
    port_counters()


def test_nested_map_written_around_link(exec_mode):
    adv.TestTableAdversarial().test_nested_map_written_around_link(exec_mode)
    port_counters()


# -- tests/test_engine_differential.py ---------------------------------------

@pytest.mark.parametrize('lane', [
    'test_simple_sets', 'test_concurrent_conflict',
    'test_nested_maps_and_links', 'test_out_of_order_buffering',
    'test_timestamps'])
def test_map_parity(lane):
    getattr(diff.TestMapParity(), lane)()
    port_counters()


@pytest.mark.parametrize('lane', [
    'test_create_and_insert', 'test_interleaved_inserts_deletes',
    'test_concurrent_same_position_inserts',
    'test_concurrent_set_and_delete_resurrection'])
def test_list_parity(lane):
    getattr(diff.TestListParity(), lane)()
    port_counters()


@pytest.mark.parametrize('seed,structure', [
    (1, 'map'), (2, 'map'), (3, 'list'), (4, 'list'),
    (5, 'mixed'), (6, 'mixed'), (7, 'mixed')])
def test_in_order_delivery(seed, structure):
    diff.TestRandomWorkloads().test_in_order_delivery(seed, structure)
    port_counters()


@pytest.mark.parametrize('seed', [11, 12, 13])
def test_shuffled_delivery(seed):
    diff.TestRandomWorkloads().test_shuffled_delivery(seed)
    port_counters()


@pytest.mark.parametrize('seed', [21, 22])
def test_batched_delivery(seed):
    diff.TestRandomWorkloads().test_batched_delivery(seed)
    port_counters()


def test_multi_doc_batch():
    diff.TestRandomWorkloads().test_multi_doc_batch()
    port_counters()


@pytest.mark.parametrize('lane', range(3))
def test_rotating_three_backend_fuzz(lane):
    diff.TestRotatingFuzz().test_rotating_three_backend_fuzz(lane)
    port_counters()


def test_rotating_multi_doc_fuzz():
    diff.TestRotatingFuzz().test_rotating_multi_doc_fuzz()
    port_counters()
