"""Always-on flight recorder: a fixed-size ring of compact structured
events, stamped from the hot paths at one-append cost, dumped as JSONL
when something goes wrong (docs/OBSERVABILITY.md event catalog;
docs/RESILIENCE.md quarantine story).

The stack's counters say HOW OFTEN things happen; when a doc
quarantines or a request lands at p99.9 they cannot say WHAT HAPPENED
in the seconds before.  The recorder closes that gap without span
machinery: every interesting transition (batch begin/commit/rollback,
retry/bisect/quarantine, wave dispatch/collect, eviction/reload,
fan-out flush, shed transitions, injected faults, sidecar respawns)
appends one tuple into a pre-sized ring.  No lock: slot index comes
from an atomic ``itertools.count`` and each slot store is a single
opaque reference write, so concurrent writers can interleave but never
tear a record or block each other -- the CPython-level guarantee the
hot paths need (a torn *ring* would mean a lost event, which the
overwrite semantics already permit).

Dump triggers (each rate-limited per reason, ``force`` overrides):
quarantine and state-suspect batches (`automerge_tpu_torch.resilience`),
sidecar respawn (`sidecar/client.py`), SIGTERM (`sidecar/server.py`),
the ``dump`` sidecar request, and the HTTP ``/debug/recorder`` endpoint
(`telemetry/httpd.py`, which serves the ring in place rather than
writing a file).  Dumps are JSONL files under ``RECORDER_DIR``
(default: a per-process tempdir) named
``amtpu-recorder-<pid>-<reason>-<seq>.jsonl``.

Sizing: ``RECORDER_EVENTS`` slots (default 4096; read once at
import -- the ring is pre-allocated).  At gateway rates the ring spans
the last O(seconds) of activity, exactly the window a post-mortem
needs.
"""

import itertools
import json
import os
import sys
import tempfile
import threading
import time

#: ring slots, read once at import (AMTPU_RECORDER_EVENTS)
RECORDER_EVENTS = 4096
#: dump directory ('' = a per-process tempdir; AMTPU_RECORDER_DIR)
RECORDER_DIR = ''
#: per-reason dump rate limit in seconds (AMTPU_RECORDER_MIN_DUMP_S)
RECORDER_MIN_DUMP_S = 5.0

#: the event-name universe (docs/OBSERVABILITY.md has the catalog);
#: informational -- record() does not validate against it (an append
#: must stay one tuple), but tests and the docs lockstep use it
EVENTS = (
    'batch.begin', 'batch.commit', 'batch.rollback',
    'wave.dispatch', 'wave.collect',
    'resilience.retry', 'resilience.bisect', 'resilience.quarantine',
    'resilience.state_suspect',
    'fault.injected',
    'storage.evict', 'storage.reload',
    'fanout.flush',
    'egress.shed', 'egress.resync', 'egress.evict',
    'shed.on', 'shed.off',
    'sidecar.respawn',
    'request.slow',
)


class Recorder(object):
    """One pre-sized event ring.  ``record`` is the hot-path append;
    everything else is cold (dump/snapshot copy the slots)."""

    def __init__(self, size):
        self.size = max(16, int(size))
        # fixed-size slot vector: index = seq % size.  Writers race
        # benignly (an overwritten slot simply loses the older event,
        # which is the ring's contract); no slot ever holds a torn
        # record because the store is one reference assignment.
        self._slots = [None] * self.size
        self._seq = itertools.count()
        self._last_dump = {}      # reason -> monotonic ts (dump-side)
        self._dump_lock = threading.Lock()
        self._dump_n = itertools.count()
        self._dumps_written = 0   # successful dumps (healthz)

    # -- hot path -------------------------------------------------------

    def record(self, event, doc=None, n=0, detail=None, trace=None):
        """Appends one event: (seq, wall-clock ts, name, doc, n,
        detail, trace).  One counter bump + one tuple + one slot store.
        `trace` is the originating request's 32-hex trace id when the
        caller has one -- it makes ring events correlatable
        with the cross-process trace tree at zero extra cost."""
        i = next(self._seq)
        self._slots[i % self.size] = (i, time.time(), event, doc, n,
                                      detail, trace)

    # -- cold surface ---------------------------------------------------

    def snapshot(self):
        """Events currently in the ring, oldest first.  Records racing
        with writers may skew a little at the wrap point; every entry
        returned is internally consistent."""
        slots = list(self._slots)
        out = [s for s in slots if s is not None]
        out.sort(key=lambda s: s[0])
        return out

    def events_json(self):
        """The snapshot as JSON-safe dicts (the /debug/recorder body
        and the per-line dump shape)."""
        return self.tail(float('-inf'))

    def tail(self, since_ts, limit=None):
        """Events at or after wall-clock `since_ts`, newest last -- the
        exemplar attachment window (telemetry/attribution.py).  `limit`
        bounds to the newest N BEFORE any dicts are built, so a hot
        sampler never pays for the whole ring."""
        slots = self.snapshot()
        if limit is not None:
            slots = slots[-int(limit):]
        return [{'seq': s[0], 'ts': round(s[1], 6), 'event': s[2],
                 'doc': s[3], 'n': s[4], 'detail': s[5],
                 'trace': s[6] if len(s) > 6 else None}
                for s in slots if s[1] >= since_ts]

    def dump(self, reason, force=False):
        """Writes the ring as JSONL under ``RECORDER_DIR`` and
        returns ``{'path', 'events', 'reason'}`` -- or None when the
        per-reason rate limit (``RECORDER_MIN_DUMP_S``) says this
        trigger fired too recently (a quarantine storm must not turn
        into a disk-write storm).  Never raises: a full disk degrades
        the DUMP, not the failing operation that triggered it."""
        now = time.monotonic()
        with self._dump_lock:
            last = self._last_dump.get(reason)
            if not force and last is not None \
                    and now - last < RECORDER_MIN_DUMP_S:
                return None
            self._last_dump[reason] = now
            seq = next(self._dump_n)
        events = self.events_json()
        path = None
        try:
            # _dump_dir() may itself raise (uncreatable RECORDER_DIR,
            # read-only FS): it must degrade like a failed write,
            # never propagate into the quarantine/suspect path that
            # triggered the dump
            path = os.path.join(
                _dump_dir(), 'amtpu-recorder-%d-%s-%d.jsonl'
                % (os.getpid(), reason.replace(os.sep, '_'), seq))
            with open(path, 'w') as f:
                f.write(json.dumps({'recorder_dump': reason,
                                    'ts': round(time.time(), 6),
                                    'pid': os.getpid(),
                                    'events': len(events)}) + '\n')
                for e in events:
                    f.write(json.dumps(e, default=str) + '\n')
        except OSError as e:
            metric('recorder.dump_failed')
            print('amtpu recorder: %s dump to %r failed (%s)'
                  % (reason, path, e), file=sys.stderr)
            return None
        metric('recorder.dumps')
        self._dumps_written += 1
        return {'path': path, 'events': len(events), 'reason': reason}

    def healthz_section(self):
        slots = list(self._slots)
        n = sum(1 for s in slots if s is not None)
        newest = max((s[0] for s in slots if s is not None),
                     default=-1)
        return {'size': self.size, 'events': n,
                'last_seq': newest,
                'dumps': self._dumps_written}


def metric(name, v=1):
    """Thin forwarder to the package counter (late-bound: this module
    loads while telemetry/__init__ is still executing, and the static
    telemetry-key checker keys on `metric(...)` call sites)."""
    from . import metric as _m
    _m(name, v)


_dump_dir_cached = None


def _dump_dir():
    """``RECORDER_DIR`` or a per-process tempdir (created lazily:
    a process that never dumps never touches the filesystem)."""
    global _dump_dir_cached
    if RECORDER_DIR:
        os.makedirs(RECORDER_DIR, exist_ok=True)
        return RECORDER_DIR
    if _dump_dir_cached is None:
        _dump_dir_cached = tempfile.mkdtemp(prefix='amtpu-recorder-')
    return _dump_dir_cached


RECORDER = Recorder(RECORDER_EVENTS)


def record(event, doc=None, n=0, detail=None, trace=None):
    """Module-level hot-path append (patchable by the overhead gate)."""
    RECORDER.record(event, doc=doc, n=n, detail=detail, trace=trace)


def dump(reason, force=False):
    return RECORDER.dump(reason, force=force)


def snapshot():
    return RECORDER.snapshot()


def events_json():
    return RECORDER.events_json()


def tail(since_ts, limit=None):
    return RECORDER.tail(since_ts, limit=limit)
