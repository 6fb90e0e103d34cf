"""The port's Python columnar codec (`automerge_tpu_torch/storage/
columnar.py`) against the JAX package's, and against the C++ codec of
the port's build.

Inputs: the random corpora of the JAX codec tests
(`test_storage_native._rand_change_dicts`, `test_storage._rand_changes`),
the port's workloads (config 3, a hot key), and the foreign-encoding and
residual cases (`test_storage_native._mangled_raws`, msgpack ext, null
deps or ops, Unicode-digit keys, a non-canonical int).  Bytes compare
exactly: the blobs, the decoded raws, the meta tuples and the
`storage.*` counters.  `native.STORAGE_NATIVE` picks the port's codec,
AMTPU_STORAGE_NATIVE the JAX package's (both read per call).
"""

import random

import msgpack
import pytest

from automerge_tpu import storage as jax_storage
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu_torch import native, storage, telemetry, workloads
from automerge_tpu_torch.storage import columnar
from test_storage import _rand_changes
from test_storage_native import _mangled_raws, _rand_change_dicts
from torch_threads import cap_threads

cap_threads()

ROOT = '00000000-0000-0000-0000-000000000000'


def _packed(changes):
    return [msgpack.packb(c, use_bin_type=True) for c in changes]


def _workload_raws(batch):
    return _packed([ch for d in sorted(batch, key=str) for ch in batch[d]])


def _canonical_cases():
    """name -> raws that every encoder columnarizes alike."""
    cases = {'rand_dicts_%d' % s: _packed(_rand_change_dicts(
        random.Random(s))) for s in (7, 23)}
    cases['rand_text'] = _packed(_rand_changes(random.Random(11),
                                               n_rounds=60))
    cases['config3'] = _workload_raws(workloads.build_config_3(
        random.Random(7), n_docs=4))
    cases['hot_key'] = _workload_raws(workloads.hot_key_batch(40)[0])
    cases['unicode_digit_keys'] = _packed([{
        'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'set', 'obj': ROOT, 'key': k, 'value': i}
            for i, k in enumerate(('x:\u00b2', 'y:\u0663', 'z:007'))]}])
    cases['empty'] = []
    return cases


def _residual_cases():
    """name -> raws holding changes that ride the residual column."""
    good = _packed(_rand_change_dicts(random.Random(5), n=20))
    mixed = []
    for i, raw in enumerate(good):
        mixed.append(raw)
        if i < len(_mangled_raws()):
            mixed.append(_mangled_raws()[i])
    c = {'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT, 'key': 'k', 'value': 5}]}
    raw = msgpack.packb(c, use_bin_type=True)
    return {
        'mangled': mixed,
        'ext': [msgpack.packb({'actor': 'a', 'seq': 1}, use_bin_type=True),
                msgpack.packb(msgpack.ExtType(4, b'\x01\x02'))],
        'null_deps_ops': _packed([
            {'actor': 'a', 'seq': 1, 'deps': None, 'ops': [
                {'action': 'set', 'obj': ROOT, 'key': 'k', 'value': 1}]},
            {'actor': 'a', 'seq': 2, 'deps': {}, 'ops': None}]),
        'non_canonical_int': [raw, raw.replace(b'\x05', b'\xcd\x00\x05'),
                              raw],
    }


CANONICAL = _canonical_cases()
RESIDUAL = _residual_cases()
ALL = dict(CANONICAL, **RESIDUAL)


@pytest.fixture(autouse=True)
def reset():
    telemetry.metrics_reset()
    jax_telemetry.metrics_reset()


def _port(raws_or_blob, fn, cxx, monkeypatch):
    monkeypatch.setattr(native, 'STORAGE_NATIVE', cxx)
    return getattr(storage, fn)(raws_or_blob)


def _jax(raws_or_blob, fn, monkeypatch):
    monkeypatch.setenv('AMTPU_STORAGE_NATIVE', '0')
    return getattr(jax_storage, fn)(raws_or_blob)


def _storage_counts(snap):
    return {k: v for k, v in snap.items() if k.startswith('storage.')}


@pytest.mark.parametrize('case', sorted(ALL))
def test_python_encoders_write_the_same_blob(case, monkeypatch):
    """The port's Python encoder and the JAX package's write the same
    bytes, and count the same `storage.*` keys."""
    raws = ALL[case]
    got = _port(raws, 'encode_columnar', False, monkeypatch)
    assert got == _jax(raws, 'encode_columnar', monkeypatch)
    assert _storage_counts(telemetry.metrics_snapshot()) == \
        _storage_counts(jax_telemetry.metrics_snapshot())
    assert telemetry.metrics_snapshot()['storage.python_encodes'] == 1


@pytest.mark.parametrize('case', sorted(ALL))
def test_cxx_encoder_writes_the_python_blob(case, monkeypatch):
    """With STORAGE_NATIVE on, the C++ codec's bytes are the Python
    codec's on every corpus, the residual ones included."""
    raws = ALL[case]
    assert _port(raws, 'encode_columnar', True, monkeypatch) == \
        _port(raws, 'encode_columnar', False, monkeypatch)
    snap = telemetry.metrics_snapshot()
    assert snap['storage.native_encodes'] == \
        snap['storage.python_encodes'] == 1


@pytest.mark.parametrize('case', sorted(ALL))
def test_every_decoder_gives_back_the_input(case, monkeypatch):
    """Each blob (the Python encoder's and the C++ one's) decodes to the
    input bytes through both port decoders and the JAX one."""
    raws = ALL[case]
    for cxx in (False, True):
        blob = _port(raws, 'encode_columnar', cxx, monkeypatch)
        assert _port(blob, 'decode_columnar', False, monkeypatch) == raws
        assert _port(blob, 'decode_columnar', True, monkeypatch) == raws
        assert _jax(blob, 'decode_columnar', monkeypatch) == raws
        if case in CANONICAL:
            assert storage.decode_columnar_dicts(blob) == \
                jax_storage.decode_columnar_dicts(blob)


@pytest.mark.parametrize('case', sorted(ALL))
def test_decode_meta_matches_jax(case, monkeypatch):
    blob = _port(ALL[case], 'encode_columnar', False, monkeypatch)
    telemetry.metrics_reset()
    jax_telemetry.metrics_reset()
    assert storage.decode_columnar_meta(blob) == \
        jax_storage.decode_columnar_meta(blob)
    assert _storage_counts(telemetry.metrics_snapshot()) == \
        _storage_counts(jax_telemetry.metrics_snapshot())


def test_dict_encoders_match_jax(monkeypatch):
    changes = _rand_change_dicts(random.Random(9), n=40)
    monkeypatch.setattr(native, 'STORAGE_NATIVE', False)
    monkeypatch.setenv('AMTPU_STORAGE_NATIVE', '0')
    assert storage.encode_columnar_dicts(changes) == \
        jax_storage.encode_columnar_dicts(changes)


@pytest.mark.parametrize('cxx', [False, True], ids=['python', 'cxx'])
def test_corrupt_blob_raises_value_error(cxx, monkeypatch):
    blob = _port(CANONICAL['rand_text'], 'encode_columnar', False,
                 monkeypatch)
    for bad in (b'AMTX' + blob[4:],              # magic
                blob[:4] + b'\x07' + blob[5:],   # version
                blob[:6] + b'garbage',           # body
                blob[:-3],                       # truncated
                b'AMTC\x01\x01not-zlib'):
        with pytest.raises(ValueError):
            _port(bad, 'decode_columnar', cxx, monkeypatch)
        if not cxx:
            with pytest.raises(ValueError):
                storage.decode_columnar_meta(bad)


def test_cxx_failure_falls_back_to_python(monkeypatch):
    """A failing C++ encode falls back to the Python encoder (the same
    bytes), counted `storage.python_encodes`; a save never fails for
    it."""
    raws = CANONICAL['config3']
    want = _port(raws, 'encode_columnar', False, monkeypatch)

    def fail(lib, raws):
        raise ValueError('columnar encode failed: injected')
    monkeypatch.setattr(columnar, '_native_encode', fail)
    telemetry.metrics_reset()
    assert _port(raws, 'encode_columnar', True, monkeypatch) == want
    snap = telemetry.metrics_snapshot()
    assert snap['storage.python_encodes'] == 1
    assert 'storage.native_encodes' not in snap
    pool = native.NativeDocPool(device='cpu')
    pool.apply_batch({'d': [
        {'actor': 'a', 'seq': s, 'deps': {}, 'ops': [
            {'action': 'set', 'obj': ROOT, 'key': 'k', 'value': s}]}
        for s in (1, 2, 3)]})
    blob = pool.save('d')
    assert storage.checkpoint_raw_changes(blob) == pool._tail_raws('d')
    assert telemetry.metrics_snapshot()['storage.python_encodes'] == 2
