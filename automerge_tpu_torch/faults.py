"""Fault injection registry: named sites in the pool's hot paths.

Arming a site makes the next matching pass raise a typed fault exactly
where a real device, kernel or runtime error would surface, so the
resilience layer (`automerge_tpu_torch.resilience`) can be driven
deterministically in tests and on the card.  The sites, their kinds and
the counters are the JAX package's.

Sites:

  native.begin      C++ decode/schedule/encode (amtpu_begin succeeded,
                    the fault fires before any dispatch)
  device.dispatch   kernel dispatch (phase a, after the clock table's
                    upload, before the kernels are enqueued)
  device.collect    device->host result collection (phase b, pre-mid)
  native.mid        C++ mid phase (fires before any amtpu_mid* call)
  escalation.tier   the escalation ladder's tier dispatch
  checkpoint.load   checkpoint restore (`load_batch`)
  storage.save      cold-store blob write, mid-stream (a partial
                    tempfile exists, the atomic rename has not run)

  sidecar.frame, fanout.write, fanout.stall, router.forward and
  router.heartbeat are sites of the serving layers; they are accepted
  here so that a spec written for the JAX package arms unchanged.

Arming:

  * ``load_spec('site:kind:prob[:count][,spec...]')`` where kind is
    ``transient`` | ``permanent``, prob in [0, 1], count bounds total
    fires (omitted = unlimited); the caller feeds the string.
  * ``arm(site, kind, prob, count=..., match=...)``; ``match`` pins the
    fault to batches containing a doc key with that substring.

Disarmed, a hot path pays one module-attribute read per site
(``if faults.ARMED:``).
"""

import random
import threading

from . import telemetry, trace

#: the site universe: arm() rejects anything else
SITES = ('native.begin', 'native.mid', 'device.dispatch',
         'device.collect', 'escalation.tier', 'sidecar.frame',
         'checkpoint.load', 'fanout.write', 'fanout.stall',
         'storage.save', 'router.forward', 'router.heartbeat')

KINDS = ('transient', 'permanent')

#: True iff any spec is armed; hot paths read this one attribute
ARMED = False


class InjectedFault(Exception):
    """Base of the injected fault types; carries its site and kind."""

    kind = 'permanent'

    def __init__(self, site, detail=''):
        self.site = site
        super().__init__('injected %s fault at %s%s'
                         % (self.kind, site,
                            ' (%s)' % detail if detail else ''))


class TransientFault(InjectedFault):
    """A retryable condition: bounded retries with backoff clear it."""

    kind = 'transient'


class PermanentFault(InjectedFault):
    """A deterministic failure: only isolation or quarantine clears it."""

    kind = 'permanent'


class _Spec:
    __slots__ = ('site', 'kind', 'prob', 'count', 'match')

    def __init__(self, site, kind, prob, count, match):
        self.site = site
        self.kind = kind
        self.prob = prob
        self.count = count       # remaining fires; None = unlimited
        self.match = match       # doc-key substring pin; None = any


_lock = threading.Lock()
_specs = []
_rng = random.Random()


def _refresh_armed():
    global ARMED
    ARMED = bool(_specs)


def arm(site, kind='transient', prob=1.0, count=None, match=None):
    """Arms one fault spec; returns it (pass to :func:`disarm`)."""
    if site not in SITES:
        raise ValueError('unknown fault site %r (one of %s)'
                         % (site, ', '.join(SITES)))
    if kind not in KINDS:
        raise ValueError('unknown fault kind %r (transient|permanent)'
                         % (kind,))
    prob = float(prob)
    if not 0.0 <= prob <= 1.0:
        raise ValueError('fault probability %r outside [0, 1]' % (prob,))
    if count is not None and int(count) < 1:
        raise ValueError('fault count must be >= 1, got %r' % (count,))
    spec = _Spec(site, kind, prob,
                 None if count is None else int(count), match)
    with _lock:
        _specs.append(spec)
        _refresh_armed()
    return spec


def disarm(spec=None):
    """Removes one spec, or every spec when called without arguments."""
    with _lock:
        if spec is None:
            del _specs[:]
        else:
            try:
                _specs.remove(spec)
            except ValueError:
                pass
        _refresh_armed()


def reset(spec=''):
    """Drops every armed spec, then arms `spec` (the `load_spec`
    grammar; '' arms nothing)."""
    disarm()
    load_spec(spec)


def load_spec(value):
    """Parses ``site:kind:prob[:count][,spec...]`` and arms each spec.
    A malformed spec raises (a run with a typo'd fault must not silently
    test nothing)."""
    for part in filter(None, (p.strip() for p in value.split(','))):
        bits = part.split(':')
        if len(bits) not in (3, 4):
            raise ValueError(
                'bad fault spec %r (want site:kind:prob[:count])' % (part,))
        arm(bits[0], bits[1], float(bits[2]),
            count=int(bits[3]) if len(bits) == 4 else None)


def fire(site, docs=None):
    """Raises a typed fault when an armed spec matches this pass.

    ``docs`` is the batch's doc-key list where the site has one; a spec
    armed with ``match`` fires only when some doc key contains the pin,
    so bisection converges on exactly the poisoned doc(s).  Called only
    behind the ``faults.ARMED`` gate."""
    with _lock:
        for spec in _specs:
            if spec.site != site:
                continue
            if spec.match is not None:
                if docs is None or not any(spec.match in d for d in docs):
                    continue
            if spec.prob < 1.0 and _rng.random() >= spec.prob:
                continue
            if spec.count is not None:
                spec.count -= 1
                if spec.count <= 0:
                    _specs.remove(spec)
                    _refresh_armed()
            kind = spec.kind
            break
        else:
            return
    trace.metric('resilience.fault_injected')
    trace.metric('resilience.fault_injected.' + site)
    telemetry.recorder.record('fault.injected', n=1, doc=spec.match,
                              detail='%s:%s' % (site, kind))
    cls = TransientFault if kind == 'transient' else PermanentFault
    raise cls(site, spec.match if spec.match is not None else '')


def is_transient(exc):
    """Whether bounded retries are worth attempting for ``exc``.

    Injected faults declare themselves.  Otherwise a narrow allowlist:
    OS-level hiccups, and the device allocator running out of memory
    (the JAX package's RESOURCE_EXHAUSTED status).  Everything else, and
    every :class:`PermanentFault`, is permanent."""
    if isinstance(exc, TransientFault):
        return True
    if isinstance(exc, InjectedFault):
        return False
    if isinstance(exc, (BrokenPipeError, ConnectionError, InterruptedError,
                        TimeoutError)):
        return True
    return type(exc).__name__ == 'OutOfMemoryError'
