"""Per-connection bounded egress queues (docs/SERVING.md
backpressure section; degradation tiers: docs/RESILIENCE.md).

Before this module, every byte the gateway sent -- responses AND
fan-out event frames -- was written on whichever thread produced it,
under a per-connection lock, straight into a blocking socket.  One
subscriber that stopped reading therefore stalled the dispatcher (and
with it every doc and every other connection) the moment its kernel
socket buffer filled.  The egress queue fully decouples the
dispatcher/flush critical path from subscriber socket health:

  * **staging never blocks** -- producers (`stage`) append a frame to a
    byte-bounded queue (``EGRESS_MAX_BYTES``) and return; a
    dedicated writer thread per connection drains it through a
    select()-paced non-stalling send loop.  Per-frame completion
    callbacks fire on the writer thread, which is where the fan-out
    engine moves believed-clock advancement and
    ``amtpu_fanout_latency_ms`` observation.
  * **tier 1 -- event shedding** -- on overflow, queued *event* frames
    (kind ``'event'``: fan-out deltas, presence) are dropped and their
    ``on_drop`` callbacks run (the fan-out engine regresses the peer's
    believed clock to its acked row, so the next flush classifies it
    as a straggler and the transitive-deps filtered delta heals it --
    no dup, no gap).  Response frames (kind ``'response'``: request
    answers, control envelopes) are never shed.
  * **tier 2 -- drop-to-resubscribe** -- a connection that keeps
    overflowing without ever draining (``EGRESS_RESYNC_SHEDS``
    consecutive sheds) triggers ``on_overflow`` once: the gateway
    frees the connection's subscription rows and stages a typed
    ``{"event": "resync"}`` envelope (`SidecarClient` auto-resubscribes
    at its last-seen clock; the subscribe backfill closes the gap).
  * **tier 3 -- wedge eviction** -- a consumer whose socket accepts no
    bytes at all for ``EGRESS_WEDGE_S`` seconds is disconnected
    (``on_dead``), with recorder + telemetry breadcrumbs
    (``egress.wedge_evictions``, the ``egress.evict`` ring event).
    The writer paces on select(), so teardown never stalls on the dead
    socket.

Fault sites (docs/RESILIENCE.md): ``fanout.write`` fires as a per
-connection write failure inside the send loop; ``fanout.stall`` is an
armed wedge -- while it fires, the writer makes no progress, so a
permanent stall deterministically drives tier-3 eviction.  Disarmed
cost is the standard one module-attribute read (`faults.ARMED`).
"""

import select
import socket as _socket
import threading
import time

from .. import faults, telemetry

#: queued bytes per connection before tier-1 shedding (the JAX
#: package's AMTPU_EGRESS_MAX_BYTES)
EGRESS_MAX_BYTES = 1048576
#: zero-progress seconds before a consumer is evicted
#: (AMTPU_EGRESS_WEDGE_S)
EGRESS_WEDGE_S = 10.0
#: consecutive sheds before drop-to-resubscribe
#: (AMTPU_EGRESS_RESYNC_SHEDS)
EGRESS_RESYNC_SHEDS = 3

#: bytes per send() slice -- bounds how long one send can occupy the
#: writer after select() reports writability
_CHUNK = 65536

#: per-call non-blocking send: select() only guarantees SOME buffer
#: space, and a blocking send() of a full chunk would stall the writer
#: past the wedge deadline (AF_UNIX stream sends queue the whole
#: request).  Zero on platforms without it -- select pacing plus the
#: chunk bound still applies.
_DONTWAIT = getattr(_socket, 'MSG_DONTWAIT', 0)

#: select() pacing ceiling; the effective poll is min of this and a
#: quarter of the wedge deadline so eviction resolution stays sharp
_POLL_S = 0.25


def egress_max_bytes():
    """Queued-byte bound per connection before tier-1 shedding
    (``EGRESS_MAX_BYTES``, default 1 MiB)."""
    return max(1, EGRESS_MAX_BYTES)


def egress_wedge_s():
    """Zero-progress seconds before a consumer is evicted
    (``EGRESS_WEDGE_S``, default 10)."""
    return EGRESS_WEDGE_S


def egress_resync_sheds():
    """Consecutive tier-1 sheds (without a full drain between) before
    tier-2 drop-to-resubscribe (``EGRESS_RESYNC_SHEDS``,
    default 3)."""
    return max(1, EGRESS_RESYNC_SHEDS)


class _Frame(object):
    __slots__ = ('buf', 'kind', 'on_write', 'on_drop')

    def __init__(self, buf, kind, on_write, on_drop):
        self.buf = buf
        self.kind = kind
        self.on_write = on_write
        self.on_drop = on_drop


def _safe(cb):
    """Completion callbacks must never kill the writer thread or the
    staging caller."""
    if cb is None:
        return
    try:
        cb()
    except Exception:
        pass


class EgressQueue(object):
    """One connection's bounded egress: FIFO frame queue + writer
    thread.  ``stage`` is the only producer entry point and never
    blocks; it is safe from any thread (dispatcher, reader, healthz).

    The object's identity is stable for the connection's lifetime --
    the fan-out engine groups subscription rows sharing a transport by
    it, exactly as it grouped the pre-egress ``raw_send`` callables.
    """

    def __init__(self, sock, label='', max_bytes=None, wedge_s=None,
                 resync_sheds=None, on_overflow=None, on_dead=None):
        self._sock = sock
        self.label = label
        self._max_bytes = max_bytes if max_bytes is not None \
            else egress_max_bytes()
        self._wedge_s = wedge_s if wedge_s is not None else egress_wedge_s()
        self._resync_sheds = resync_sheds if resync_sheds is not None \
            else egress_resync_sheds()
        self._on_overflow = on_overflow   # tier 2 (fired once per backlog)
        self._on_dead = on_dead           # write error / tier-3 eviction
        self._cond = threading.Condition()
        self._frames = []         # guarded-by: self._cond
        self._bytes = 0           # guarded-by: self._cond
        # writes under the cond; the writer's mid-send peeks are
        # deliberately racy (a stale False only delays exit one poll)
        self._closed = False      # guarded-by(w): self._cond
        self._sheds = 0           # guarded-by: self._cond
        self._resynced = False    # guarded-by: self._cond
        self._thread = None       # guarded-by: self._cond
        self._dead = False

    # -- producer side ---------------------------------------------------

    def stage(self, buf, kind='event', on_write=None, on_drop=None):
        """Queues one already-encoded frame; returns False (after
        running ``on_drop``) when the queue is closed.  ``kind`` is the
        shed class: ``'event'`` frames are droppable under overflow,
        ``'response'`` frames are not.

        An event frame LARGER than the whole bound staged into an
        otherwise-empty queue is exempt from shedding (the same
        principle as the admission queue's oversized-op rule: the
        bound limits backlog, it is not a frame-size limit) --
        otherwise a single oversized coalesced delta would shed
        itself, regress, be re-staged as the same oversized straggler
        delta, and starve a healthy peer forever."""
        if kind == 'event' and len(buf) > self._max_bytes:
            with self._cond:
                if not self._frames:
                    kind = 'jumbo'    # unsheddable; delivery bounds it
        frame = _Frame(buf, kind, on_write, on_drop)
        dropped, overflowed = (), False
        evict = False
        with self._cond:
            if self._closed:
                _safe(on_drop)
                return False
            self._frames.append(frame)
            self._bytes += len(buf)
            telemetry.metric('egress.staged_frames')
            telemetry.metric('egress.staged_bytes', len(buf))
            if self._bytes > self._max_bytes:
                dropped, overflowed = self._shed_locked()
                if self._bytes > 4 * self._max_bytes \
                        and len(self._frames) > 1:
                    # unsheddable backlog (responses/jumbo) past the
                    # hard cap: the consumer is hopeless -- evict
                    # rather than grow without bound (a trickling
                    # reader defeats the wedge clock, so tier 3 alone
                    # cannot cover this).  A SINGLE oversized frame is
                    # exempt like the jumbo rule: delivery bounds it.
                    evict = True
            if self._thread is None and not evict:
                # lazy spawn: a connection that never sends never owns
                # a writer thread (hand-assembled test conns included)
                self._thread = threading.Thread(
                    target=self._writer, daemon=True,
                    name='amtpu-egress-%s' % (self.label or id(self)))
                self._thread.start()
            self._cond.notify()
        for f in dropped:
            _safe(f.on_drop)
        if evict:
            telemetry.metric('egress.overflow_evictions')
            telemetry.recorder.record('egress.evict', n=1,
                                      detail='%s:overflow' % self.label)
            self.close()
            if self._on_dead is not None:
                _safe(lambda: self._on_dead('overflow'))
            return False
        if overflowed and self._on_overflow is not None:
            # tier 2: fired once per persistent backlog, outside the
            # queue lock (the callback stages the resync envelope)
            _safe(lambda: self._on_overflow(self))
        return True

    def _shed_locked(self):  # holds-lock: self._cond
        """Tier 1: drop every queued event frame (responses survive).
        Returns (dropped frames, tier-2-due flag)."""
        kept, dropped, freed = [], [], 0
        for f in self._frames:
            if f.kind == 'event':
                dropped.append(f)
                freed += len(f.buf)
            else:
                kept.append(f)
        if not dropped:
            return (), False
        self._frames = kept
        self._bytes -= freed
        self._sheds += 1
        telemetry.metric('egress.sheds')
        telemetry.metric('egress.shed_frames', len(dropped))
        telemetry.metric('egress.shed_bytes', freed)
        telemetry.recorder.record('egress.shed', n=len(dropped),
                                  detail=self.label)
        due = self._sheds >= self._resync_sheds and not self._resynced
        if due:
            self._resynced = True
        return dropped, due

    def close(self):
        """Stops the writer and drops everything queued (their
        ``on_drop`` callbacks run).  Idempotent; never blocks on the
        socket."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            dropped, self._frames = self._frames, []
            self._bytes = 0
            self._cond.notify_all()
        for f in dropped:
            _safe(f.on_drop)

    def join(self, timeout=None):
        with self._cond:
            t = self._thread
        if t is not None:
            t.join(timeout)

    def stats(self):
        with self._cond:
            return {'queued_frames': len(self._frames),
                    'queued_bytes': self._bytes,
                    'sheds': self._sheds,
                    'resynced': self._resynced,
                    'dead': self._dead}

    # -- the writer thread -----------------------------------------------

    def _make_poller(self):
        """Writability poller: poll() where available -- select() caps
        out at FD_SETSIZE (1024) fds, exactly the regime a
        subscriber-scale gateway runs in -- with a select() fallback.
        Returns a callable(timeout_s) -> bool(writable)."""
        if hasattr(select, 'poll'):
            p = select.poll()
            p.register(self._sock, select.POLLOUT)
            return lambda t: bool(p.poll(t * 1000.0))
        return lambda t: bool(select.select((), (self._sock,), (),
                                            t)[1])

    def _writer(self):
        try:
            poller = self._make_poller()
        except (OSError, ValueError):
            poller = None
        while True:
            with self._cond:
                while not self._frames and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return          # close() already drained
                frame = self._frames.pop(0)
                self._bytes -= len(frame.buf)
            reason = self._write_out(frame.buf, poller)
            if reason is None:
                telemetry.metric('egress.writes')
                _safe(frame.on_write)
                with self._cond:
                    if not self._frames:
                        # a full drain means the consumer recovered:
                        # the persistent-slow escalation starts over
                        self._sheds = 0
                        self._resynced = False
                continue
            # the connection is gone (write error, wedge eviction, or
            # a racing close): drop the in-flight frame + everything
            # queued, then tear the connection down -- off the socket's
            # critical path, never blocking on it
            _safe(frame.on_drop)
            with self._cond:
                self._dead = reason != 'closed'
                dropped, self._frames = self._frames, []
                self._bytes = 0
                closed = self._closed
            for f in dropped:
                _safe(f.on_drop)
            if not closed and self._on_dead is not None:
                _safe(lambda: self._on_dead(reason))
            return

    def _write_out(self, buf, poller):
        """Sends one frame fully.  Returns None on success, else the
        failure reason ('error' | 'wedge' | 'closed').  Paced by the
        writability poller: a consumer that accepts nothing for the
        wedge deadline is declared wedged instead of blocking
        forever."""
        if poller is None:
            return 'error' if not self._closed else 'closed'
        mv = memoryview(buf)
        poll = min(_POLL_S, max(0.01, self._wedge_s / 4.0))
        last_progress = time.monotonic()
        while mv:
            if self._closed:
                return 'closed'
            if faults.ARMED:
                try:
                    faults.fire('fanout.write')
                except faults.InjectedFault:
                    telemetry.metric('egress.write_errors')
                    return 'error'
                try:
                    faults.fire('fanout.stall')
                except faults.InjectedFault:
                    # armed wedge: no bytes move this poll; a permanent
                    # stall runs the zero-progress clock into tier-3
                    # eviction exactly like a real non-draining peer
                    time.sleep(poll)
                    if time.monotonic() - last_progress >= self._wedge_s:
                        return self._wedged()
                    continue
            try:
                writable = poller(poll)
            except (OSError, ValueError):
                return 'error' if not self._closed else 'closed'
            if not writable:
                if time.monotonic() - last_progress >= self._wedge_s:
                    return self._wedged()
                continue
            try:
                n = self._sock.send(mv[:_CHUNK], _DONTWAIT)
            except (BlockingIOError, InterruptedError):
                # select raced a buffer refill away: no progress this
                # poll, the wedge clock keeps running
                if time.monotonic() - last_progress >= self._wedge_s:
                    return self._wedged()
                continue
            except (OSError, ValueError):
                telemetry.metric('egress.write_errors')
                return 'error' if not self._closed else 'closed'
            if n:
                last_progress = time.monotonic()
                mv = mv[n:]
        return None

    def _wedged(self):
        telemetry.metric('egress.wedge_evictions')
        telemetry.recorder.record('egress.evict', n=1, detail=self.label)
        return 'wedge'
