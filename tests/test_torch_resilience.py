"""The port's resilience layer and fault sites against the JAX package's.

The pool-level lanes of tests/test_chaos.py, each run on a port pool
(NativeDocPool(device='cpu'), the plain version of every kernel) and a
JAX pool armed with the same fault spec.  The JAX pool runs its kernel
exec mode (AMTPU_HOST_FULL=0, AMTPU_HOST_REG=0, the escalation ladder
on): the port has no full host default, so the device sites fire in
both.  Quarantine envelopes, surviving docs' patch bytes and the
`resilience.*` counters must be equal, and neither package may leave a
C++ batch handle live.  The sidecar lanes of test_chaos.py wait for the
port's serving layer.
"""

import msgpack
import pytest

from automerge_tpu import errors as jax_errors
from automerge_tpu import faults as jax_faults
from automerge_tpu import native as jax_native
from automerge_tpu import resilience as jax_resilience
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu_torch import faults, native, resilience, trace
from automerge_tpu_torch.errors import AutomergeError
from automerge_tpu_torch.native import NativeDocPool, ShardedNativePool
from automerge_tpu_torch.ops import registers as register_ops
from automerge_tpu_torch.utils import ROOT_ID
from torch_threads import cap_threads

cap_threads()

#: the poison doc permanent faults are pinned to
POISON = 'd3'


@pytest.fixture(autouse=True)
def kernel_path(monkeypatch):
    """The JAX pool on its kernel path, both packages disarmed with
    their counters cleared, and no retry backoff (the counts do not
    depend on it)."""
    for k, v in (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                 ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                 ('AMTPU_RESIDENT_CLK', '1'),
                 ('AMTPU_RETRY_BACKOFF_S', '0')):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(resilience, 'RETRY_BACKOFF_S', 0.0)
    faults.disarm()
    jax_faults.disarm()
    trace.reset()
    jax_telemetry.metrics_reset()
    yield
    faults.disarm()
    jax_faults.disarm()
    assert native.live_batch_handles() == 0
    assert jax_native.live_batch_handles() == 0


def build_docs():
    """Six plain map docs plus one 20-writer hot doc, whose key climbs
    the escalation ladder (tests/test_chaos.py::build_docs)."""
    docs = {('d%d' % i): [
        {'actor': 'a%d' % i, 'seq': s + 1, 'deps': {},
         'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'k%d' % s,
                  'value': s}]}
        for s in range(3)] for i in range(6)}
    docs['hot'] = [
        {'actor': 'w%03d' % a, 'seq': 1, 'deps': {},
         'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'k',
                  'value': 'w%03d' % a}]}
        for a in range(20)]
    return docs


def reference_patches():
    """The fault-free run (a fresh port pool, nothing armed)."""
    return NativeDocPool(device='cpu').apply_batch(build_docs())


def _packed(result):
    return {d: msgpack.packb(v, use_bin_type=True) for d, v in result.items()}


def _resilience_counts(metrics):
    return {k: int(v) for k, v in metrics.items()
            if k.startswith('resilience.')}


def arm_both(*args, **kwargs):
    faults.arm(*args, **kwargs)
    jax_faults.arm(*args, **kwargs)


def run_twin(make_port, make_jax, fn):
    """fn(pool) on a port pool and on a JAX pool armed alike: the results
    must be byte-equal per doc and the resilience counters equal.
    Returns (port result, port pool, counters)."""
    port_pool, jax_pool = make_port(), make_jax()
    got = fn(port_pool)
    want = fn(jax_pool)
    assert _packed(got) == _packed(want)
    counts = _resilience_counts(trace.metrics())
    assert counts == _resilience_counts(jax_telemetry.metrics_snapshot())
    return got, port_pool, counts


def run_plain_twin(fn):
    return run_twin(lambda: NativeDocPool(device='cpu'),
                    jax_native.NativeDocPool, fn)


def assert_byte_parity(got, want, skip=()):
    assert set(got) == set(want)
    for doc in want:
        if doc not in skip:
            assert msgpack.packb(got[doc], use_bin_type=True) == \
                msgpack.packb(want[doc], use_bin_type=True), doc


SITES = ('native.begin', 'native.mid', 'device.dispatch', 'device.collect',
         'escalation.tier')


@pytest.mark.parametrize('site', SITES)
def test_transient_retries_to_parity(site):
    """Two transient faults: the batch retries to bytes equal to the
    fault-free run, every fire rolled back."""
    want = reference_patches()
    arm_both(site, 'transient', 1.0, count=2)
    got, _pool, snap = run_plain_twin(lambda p: p.apply_batch(build_docs()))
    assert_byte_parity(got, want)
    assert snap['resilience.fault_injected'] == 2
    assert snap['resilience.retry.success'] >= 1
    assert snap['resilience.rollback'] >= 2
    assert not snap.get('resilience.quarantined')


@pytest.mark.parametrize('site', SITES)
def test_permanent_quarantines_poison_doc(site):
    """A permanent fault pinned to one doc quarantines exactly it (the
    tier dispatch has no doc scope: unpinned, it converges on the hot
    doc); nothing of that doc commits and it heals on a fault-free
    delivery."""
    if site == 'escalation.tier':
        poison, kwargs = 'hot', {}
    else:
        poison, kwargs = POISON, {'match': POISON}
    want = reference_patches()
    arm_both(site, 'permanent', 1.0, **kwargs)
    got, pool, snap = run_plain_twin(lambda p: p.apply_batch(build_docs()))
    assert_byte_parity(got, want, skip=(poison,))
    assert resilience.is_quarantined(got[poison])
    assert got[poison]['errorType'] == 'PermanentFault'
    assert snap['resilience.quarantined'] == 1
    assert snap['resilience.bisect.rounds'] >= 1
    faults.disarm()
    assert pool.get_patch(poison)['clock'] == {}
    healed = pool.apply_changes(poison, build_docs()[poison])
    assert msgpack.packb(healed, use_bin_type=True) == \
        msgpack.packb(want[poison], use_bin_type=True)


def test_transient_budget_exhaustion_quarantines():
    want = reference_patches()
    arm_both('native.mid', 'transient', 1.0, match=POISON)
    got, _pool, snap = run_plain_twin(lambda p: p.apply_batch(build_docs()))
    assert_byte_parity(got, want, skip=(POISON,))
    assert resilience.is_quarantined(got[POISON])
    assert snap['resilience.retry.exhausted'] >= 1
    assert snap['resilience.quarantined'] == 1


def test_degraded_route_heals_device_poison(monkeypatch):
    """DEGRADE: a doc whose device path is poisoned commits through the
    C++ full host path of its own pool; counted resilience.degraded, not
    fallback.oracle, and no doc is quarantined."""
    want = reference_patches()
    monkeypatch.setenv('AMTPU_DEGRADE', '1')
    monkeypatch.setattr(resilience, 'DEGRADE', True)
    arm_both('device.dispatch', 'permanent', 1.0, match=POISON)
    got, pool, snap = run_plain_twin(lambda p: p.apply_batch(build_docs()))
    assert_byte_parity(got, want)
    assert snap['resilience.degraded'] == 1
    assert not snap.get('resilience.quarantined')
    assert not trace.metrics().get('fallback.oracle')
    # the pool is back on the kernel path for the next batch
    faults.disarm()
    assert pool.apply_changes('d9', build_docs()['d0'])['clock'] == \
        {'a0': 3}


def test_degraded_route_keeps_phase_a_refusal():
    """The host-full pin is the degraded route's own: any other
    host-full batch is still refused by phase a."""
    pool = NativeDocPool(device='cpu')
    payload = msgpack.packb(build_docs(), use_bin_type=True)
    L = native.lib()
    L.amtpu_pool_set_hostfull(pool._pool, 1)
    try:
        with pytest.raises(AutomergeError, match='host path'):
            pool.apply_batch_bytes(payload)
    finally:
        L.amtpu_pool_set_hostfull(pool._pool, 0)
    assert pool._apply_host_full(payload) == \
        NativeDocPool(device='cpu').apply_batch_bytes(payload)


def test_checkpoint_load_fault_surfaces_and_clears():
    src = NativeDocPool(device='cpu')
    src.apply_batch(build_docs())
    blobs = {d: src.save(d) for d in build_docs()}
    for pkg, dst in ((faults, NativeDocPool(device='cpu')),
                     (jax_faults, jax_native.NativeDocPool())):
        pkg.arm('checkpoint.load', 'transient', 1.0, count=1)
        with pytest.raises(pkg.TransientFault):
            dst.load_batch(blobs)
        assert dst.doc_count() == 0
        dst.load_batch(blobs)
        for d in blobs:
            assert dst.get_patch(d) == src.get_patch(d)
    assert trace.metrics()['resilience.fault_injected.checkpoint.load'] == \
        jax_telemetry.metrics_snapshot()[
            'resilience.fault_injected.checkpoint.load'] == 1


def test_spec_string_arms_like_the_api():
    """`load_spec` takes the JAX package's AMTPU_FAULT grammar."""
    want = reference_patches()
    faults.reset('native.begin:transient:1.0:2')
    jax_faults.reset('native.begin:transient:1.0:2')
    got, _pool, snap = run_plain_twin(lambda p: p.apply_batch(build_docs()))
    assert_byte_parity(got, want)
    assert snap['resilience.fault_injected'] == 2
    assert snap['resilience.retry.success'] >= 1


@pytest.mark.parametrize('spec', ['nonsense', 'no.such.site:transient:1.0',
                                  'native.mid:sometimes:1.0',
                                  'native.mid:transient:2.0',
                                  'native.mid:transient:1.0:0'])
def test_bad_spec_raises(spec):
    with pytest.raises(ValueError):
        faults.load_spec(spec)
    with pytest.raises(ValueError):
        jax_faults.load_env(spec)
    assert not faults.ARMED


def test_is_transient_and_should_isolate_classify_alike():
    """The same exception, in each package's types, is retried and
    isolated alike."""
    def both(make):
        return make(faults, AutomergeError), make(jax_faults,
                                                  jax_errors.AutomergeError)
    cases = [lambda f, _e: f.TransientFault('native.mid'),
             lambda f, _e: f.PermanentFault('native.mid'),
             lambda _f, _e: TimeoutError('t'),
             lambda _f, _e: RuntimeError('CUDA kernel failed to launch'),
             lambda _f, _e: OSError('dev'), lambda _f, e: e('bad'),
             lambda _f, _e: TypeError('t'), lambda _f, _e: KeyError('k'),
             lambda _f, _e: ValueError('v')]
    for make in cases:
        mine, theirs = both(make)
        assert faults.is_transient(mine) == jax_faults.is_transient(theirs)
        assert resilience.should_isolate(mine) == \
            jax_resilience.should_isolate(theirs)
    suspect = RuntimeError('after emit')
    suspect.amtpu_state_suspect = True
    assert not resilience.should_isolate(suspect)


def test_quarantine_raise_marker_on_apply_changes():
    """A single-doc entry point raises a quarantine as the error it
    stands for, with QUARANTINE_RAISE_MARKER, as the JAX pool does."""
    arm_both('native.mid', 'permanent', 1.0, match=POISON)
    raised = []
    for pool in (NativeDocPool(device='cpu'), jax_native.NativeDocPool()):
        with pytest.raises(Exception) as ei:
            pool.apply_changes(POISON, build_docs()['d0'])
        raised.append(ei.value)
    assert type(raised[0]).__name__ == type(raised[1]).__name__ == \
        'AutomergeError'
    assert str(raised[0]) == str(raised[1])
    assert resilience.QUARANTINE_RAISE_MARKER == \
        jax_resilience.QUARANTINE_RAISE_MARKER
    assert resilience.QUARANTINE_RAISE_MARKER in str(raised[0])
    assert resilience.is_quarantine_error(
        {'errorType': 'AutomergeError', 'error': str(raised[0])})


def test_apply_batch_isolates_poison_doc():
    """The dict API repaired: one doc poisoned at native.mid comes back
    as its envelope through the port's apply_batch, every other doc
    commits (the parent commit raised for the whole batch)."""
    want = reference_patches()
    faults.arm('native.mid', 'permanent', 1.0, match=POISON)
    pool = NativeDocPool(device='cpu')
    got = pool.apply_batch(build_docs())
    assert_byte_parity(got, want, skip=(POISON,))
    assert got[POISON] == {
        'error': 'injected permanent fault at native.mid (%s)' % POISON,
        'errorType': 'PermanentFault'}


def test_kernel_launch_failure_is_isolated(monkeypatch):
    """A RuntimeError from a kernel launch (what `ops._build.check`
    raises on a CUDA error) in the escalation dispatch of the hot doc:
    the hot doc alone is quarantined, the others commit."""
    want = reference_patches()
    real = register_ops.escalate_dispatch_groups

    def failing(*args, **kwargs):
        raise RuntimeError('CUDA kernel members failed to launch: '
                           'cudaError 700')
    monkeypatch.setattr(register_ops, 'escalate_dispatch_groups', failing)
    got = NativeDocPool(device='cpu').apply_batch(build_docs())
    assert_byte_parity(got, want, skip=('hot',))
    assert got['hot']['errorType'] == 'RuntimeError'
    assert trace.metrics()['resilience.quarantined'] == 1
    monkeypatch.setattr(register_ops, 'escalate_dispatch_groups', real)


def test_resilience_off_reraises(monkeypatch):
    monkeypatch.setattr(resilience, 'ENABLED', False)
    faults.arm('native.mid', 'permanent', 1.0, match=POISON)
    pool = NativeDocPool(device='cpu')
    with pytest.raises(faults.PermanentFault):
        pool.apply_batch(build_docs())
    assert pool.get_patch('d0')['clock'] == {}


# -- the sharded pool ------------------------------------------------------

def _sharded_twin(mode):
    return (lambda: ShardedNativePool(4, mode, device='cpu'),
            lambda: jax_native.ShardedNativePool(n_shards=4, mode=mode))


@pytest.mark.parametrize('mode', ['pipeline', 'threads'])
def test_poison_doc_stays_inside_its_shard(mode):
    want = reference_patches()
    arm_both('native.mid', 'permanent', 1.0, match=POISON)
    got, _pool, snap = run_twin(*_sharded_twin(mode),
                                lambda p: p.apply_batch(build_docs()))
    assert_byte_parity(got, want, skip=(POISON,))
    assert resilience.is_quarantined(got[POISON])
    assert snap['resilience.quarantined'] == 1


@pytest.mark.parametrize('mode', ['pipeline', 'threads'])
def test_transient_shard_failure_retries_to_parity(mode):
    want = reference_patches()
    arm_both('native.begin', 'transient', 1.0, count=1)
    got, _pool, snap = run_twin(*_sharded_twin(mode),
                                lambda p: p.apply_batch(build_docs()))
    assert_byte_parity(got, want)
    assert snap['resilience.retry.success'] >= 1


@pytest.mark.parametrize('site', ['device.dispatch', 'device.collect',
                                  'escalation.tier'])
@pytest.mark.parametrize('mode', ['pipeline', 'threads'])
def test_sharded_device_sites(mode, site):
    """The device sites on a sharded pool: a pinned permanent fault
    quarantines one doc of one shard (the tier site, unpinned, the hot
    doc: the only one that escalates)."""
    if site == 'escalation.tier':
        poison, kwargs = 'hot', {}
    else:
        poison, kwargs = POISON, {'match': POISON}
    want = reference_patches()
    arm_both(site, 'permanent', 1.0, **kwargs)
    got, _pool, snap = run_twin(*_sharded_twin(mode),
                                lambda p: p.apply_batch(build_docs()))
    assert_byte_parity(got, want, skip=(poison,))
    assert resilience.is_quarantined(got[poison])
    assert snap['resilience.quarantined'] == 1


def test_validation_error_preempts_isolation_atomically():
    """A begin-level validation error fires before any injected fault:
    the whole batch raises and commits nothing; without the bad doc the
    armed fault isolates normally."""
    docs = build_docs()
    docs['bad'] = [{'actor': 'X', 'seq': 1, 'deps': {},
                    'ops': [{'action': 'set', 'obj': 'nonexistent',
                             'key': 'k', 'value': 1}]}]
    want = reference_patches()
    arm_both('native.mid', 'permanent', 1.0, match=POISON)
    for pool in (NativeDocPool(device='cpu'), jax_native.NativeDocPool()):
        with pytest.raises(Exception, match='unknown object') as ei:
            pool.apply_batch(docs)
        assert type(ei.value).__name__ == 'AutomergeError'
        assert pool.get_patch('d0')['clock'] == {}
    del docs['bad']
    trace.reset()
    jax_telemetry.metrics_reset()
    got, _pool, snap = run_plain_twin(lambda p: p.apply_batch(docs))
    assert_byte_parity(got, want, skip=(POISON,))
    assert resilience.is_quarantined(got[POISON])
    assert snap['resilience.quarantined'] == 1


def test_protocol_errors_still_raise():
    ch = {'actor': 'A', 'seq': 1, 'deps': {},
          'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'k', 'value': 1}]}
    bad = dict(ch, ops=[dict(ch['ops'][0], value='other')])
    for pool in (NativeDocPool(device='cpu'), jax_native.NativeDocPool()):
        pool.apply_changes('d', [ch])
        with pytest.raises(Exception, match='Inconsistent reuse') as ei:
            pool.apply_changes('d', [bad])
        assert type(ei.value).__name__ == 'AutomergeError'
