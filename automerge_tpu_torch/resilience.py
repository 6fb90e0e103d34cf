"""Poison-batch isolation and graceful degradation for the pool.

A device- or native-path failure inside ``NativeDocPool.apply_batch`` /
``ShardedNativePool`` takes the smallest possible blast radius:

  1. **retry**: transient failures (``faults.is_transient``) get bounded
     retries with exponential backoff (``resilience.retry.*``);
  2. **bisect**: a failure that persists splits the doc set in half and
     re-applies each half, converging on the poison doc(s) in O(log n)
     extra applies (``resilience.bisect.rounds``);
  3. **quarantine / degrade**: a poisoned singleton either runs on the
     C++ full host path of the same pool (DEGRADE; no device work;
     ``resilience.degraded``, distinct from ``fallback.oracle``) or is
     quarantined: its slot in the result carries the per-doc error
     envelope ``{'error': ..., 'errorType': ...}`` while every healthy
     doc's patch commits (``resilience.quarantined``).

This is byte-safe because a failed batch rolls back
(`amtpu_batch_rollback` restores the pool to its pre-begin state on any
pre-emit failure), so re-applying the same changes is not swallowed by
seq dedup.  An exception marked ``amtpu_state_suspect`` (emit already
ran) is never retried or bisected.

Protocol errors (`AutomergeError`, `RangeError`, `TypeError`,
`KeyError`) never start isolation: they re-raise whole-batch.  Once
isolation has begun, sibling groups may have committed, so even
validation errors then resolve per doc.

The layer retries and quarantines what the JAX package's does, and
nothing else: it never moves a batch to another device or to a plain
version of a kernel.
"""

import ctypes
import time

import msgpack

from . import faults, telemetry, trace
from .telemetry import recorder
from .errors import AutomergeError
from .utils import map_header, read_map_header

#: the layer on (the JAX package's AMTPU_RESILIENCE); False re-raises
#: every failure after its rollback
ENABLED = True
#: retries of a transient failure per doc group (AMTPU_RETRY_MAX)
RETRY_MAX = 3
#: first backoff, doubled per retry (AMTPU_RETRY_BACKOFF_S)
RETRY_BACKOFF_S = 0.05
#: a poisoned singleton runs on the C++ full host path of its pool
#: instead of being quarantined (AMTPU_DEGRADE; off, as in JAX)
DEGRADE = False

#: exponential backoff ceiling
_BACKOFF_CAP_S = 1.0


def should_isolate(exc):
    """Whether the resilience machinery may handle ``exc`` at all:
    injected faults always; infrastructure failures (RuntimeError,
    which a failed kernel launch raises, OSError, MemoryError,
    SystemError) unless the batch is state-suspect; protocol validation
    errors never."""
    if not ENABLED:
        return False
    if getattr(exc, 'amtpu_state_suspect', False):
        return False
    if isinstance(exc, faults.InjectedFault):
        return True
    if isinstance(exc, (AutomergeError, TypeError, KeyError)):
        return False
    return isinstance(exc, (RuntimeError, OSError, MemoryError,
                            SystemError))


def error_envelope(exc):
    """The protocol's per-doc error envelope for a quarantined doc."""
    return {'error': str(exc) or type(exc).__name__,
            'errorType': type(exc).__name__}


def is_quarantined(result):
    """True when a per-doc batch result is an error envelope rather
    than a patch."""
    return isinstance(result, dict) and 'errorType' in result \
        and 'error' in result and 'clock' not in result


#: the message shape a single-doc entry point raises a quarantine
#: envelope with (`native._raise_if_quarantined`)
QUARANTINE_RAISE_MARKER = ' quarantined: ['


def is_quarantine_error(resp):
    """True when a protocol error response is the single-doc surface of
    a quarantine rather than a validation error."""
    return isinstance(resp, dict) \
        and resp.get('errorType') == 'AutomergeError' \
        and QUARANTINE_RAISE_MARKER in str(resp.get('error', ''))


def apply_payload(pool, payload, first_exc=None):
    """``apply_batch_bytes`` with retry/bisect/quarantine semantics.

    Returns result bytes in ``apply_batch_bytes``'s format (msgpack
    ``{doc_key: patch}``), quarantined docs mapped to their error
    envelope.  Exceptions the layer must not isolate re-raise unchanged.
    ``first_exc`` carries a failure the caller already observed (the
    sharded pool's failed shard)."""
    if first_exc is None:
        try:
            return pool.apply_batch_bytes(payload)
        except Exception as e:
            if not should_isolate(e):
                if getattr(e, 'amtpu_state_suspect', False):
                    recorder.record('resilience.state_suspect',
                                    detail=type(e).__name__)
                    recorder.dump('state_suspect')
                raise
            first_exc = e
    if isinstance(payload, tuple):   # zero-copy shard view: materialize
        payload = ctypes.string_at(payload[0], payload[1])
    keyed = msgpack.unpackb(payload, raw=False, strict_map_key=False)
    # results merge at the byte level: every surviving doc's patch bytes
    # stay exactly as C++ emitted them
    parts = []                       # (n_docs, body bytes)
    _apply_group(pool, keyed, list(keyed), parts, pending_exc=first_exc)
    total = sum(n for n, _ in parts)
    return map_header(total) + b''.join(b for _, b in parts)


def _append_raw(parts, raw):
    n, off = read_map_header(raw)
    parts.append((n, memoryview(raw)[off:]))


def _apply_group(pool, keyed, doc_list, parts, pending_exc=None):
    """Recursive retry/bisect over one doc subset.  Healthy docs'
    raw patch bytes land in ``parts``; poisoned docs land as packed
    error envelopes."""
    delay = RETRY_BACKOFF_S
    attempts_left = RETRY_MAX
    retried = False
    exc = pending_exc
    sub = None          # built once; retries re-send the same bytes
    while True:
        if exc is None:
            try:
                if sub is None:
                    sub = msgpack.packb({k: keyed[k] for k in doc_list},
                                        use_bin_type=True)
                _append_raw(parts, pool.apply_batch_bytes(sub))
                if retried:
                    trace.metric('resilience.retry.success')
                return
            except Exception as e:
                # isolation has begun: only a state-suspect failure
                # still re-raises
                if getattr(e, 'amtpu_state_suspect', False):
                    recorder.record('resilience.state_suspect',
                                    n=len(doc_list),
                                    detail=type(e).__name__)
                    recorder.dump('state_suspect')
                    raise
                exc = e
        if faults.is_transient(exc) and attempts_left > 0:
            attempts_left -= 1
            retried = True
            trace.metric('resilience.retry.attempts')
            recorder.record('resilience.retry', n=len(doc_list),
                            detail=type(exc).__name__)
            time.sleep(delay)
            delay = min(delay * 2, _BACKOFF_CAP_S)
            exc = None
            continue
        break
    if faults.is_transient(exc):
        trace.metric('resilience.retry.exhausted')
    if len(doc_list) > 1:
        trace.metric('resilience.bisect.rounds')
        recorder.record('resilience.bisect', n=len(doc_list))
        mid = len(doc_list) // 2
        _apply_group(pool, keyed, doc_list[:mid], parts)
        _apply_group(pool, keyed, doc_list[mid:], parts)
        return
    key = doc_list[0]
    if DEGRADE:
        try:
            _append_raw(parts, _apply_degraded(pool, key, keyed[key]))
            trace.metric('resilience.degraded')
            telemetry.note_degraded()
            return
        except Exception as e:
            if getattr(e, 'amtpu_state_suspect', False):
                raise
            exc = e
    trace.metric('resilience.quarantined')
    telemetry.note_degraded()
    # the quarantine is the post-mortem moment: stamp the event and dump
    # the ring around it (rate-limited per reason)
    recorder.record('resilience.quarantine', doc=key,
                    detail=type(exc).__name__)
    recorder.dump('quarantine')
    parts.append((1, msgpack.packb(key, use_bin_type=True) +
                  msgpack.packb(error_envelope(exc), use_bin_type=True)))


def _apply_degraded(pool, key, changes):
    """Applies one poisoned doc on the C++ full host path of the pool
    that owns it: registers and list indexes resolve in C++, with no
    device dispatch.  Returns the raw result bytes."""
    base = pool
    if hasattr(pool, '_shard_of'):       # route to the doc's shard pool
        base = pool.pools[pool._shard_of(key)]
    if getattr(base, '_pool', None) is None:
        raise RuntimeError('degraded path needs a native pool')
    return base._apply_host_full(
        msgpack.packb({key: changes}, use_bin_type=True))
