"""Typed client-side objects for fan-out event frames (docs/SERVING.md
read path).

`SidecarClient.next_event()` historically returned raw frame dicts and
every consumer demuxed on ``ev['event']`` strings.  With patch mode the
frame zoo grew, so each frame kind gets a typed wrapper -- every class
here SUBCLASSES dict, so ``ev['event']``/``ev.get('doc')`` consumers
keep working unchanged while new code reads ``ev.doc`` / ``ev.patch``
/ ``isinstance(ev, PatchEvent)``.

`typed_event` is the factory the client pump applies on the way out;
an unrecognized ``event`` string stays a plain dict (forward
compatibility: an old client must not crash on a new server frame).
"""


class FanoutEvent(dict):
    """Base: a fan-out frame with the common fields as attributes."""

    @property
    def event(self):
        return self.get('event')

    @property
    def doc(self):
        return self.get('doc')

    @property
    def clock(self):
        return self.get('clock') or {}

    @property
    def trace(self):
        return self.get('trace')

    @property
    def is_resync_backfill(self):
        """True for the synthetic frames an auto-resubscribe surfaces
        (marked ``"resync": true``) so consumers can tell a live flush
        frame from catch-up history."""
        return bool(self.get('resync'))


class ChangeEvent(FanoutEvent):
    """``{"event": "change", ...}``: change bytes for a CRDT-capable
    subscriber (the classic mode)."""

    @property
    def changes(self):
        return self.get('changes') or []

    @property
    def presence(self):
        return self.get('presence') or {}


class PatchEvent(FanoutEvent):
    """``{"event": "patch", ...}``: a server-computed patch for a thin
    client (``mode: "patch"`` subscriptions).  ``full`` means the
    patch REPLACES the local view (straggler/resync recovery, or the
    subscribe backfill) rather than applying incrementally."""

    @property
    def patch(self):
        return self.get('patch')

    @property
    def full(self):
        return bool(self.get('full'))

    @property
    def presence(self):
        return self.get('presence') or {}


class PresenceEvent(FanoutEvent):
    """``{"event": "presence", ...}``: ephemeral per-peer state only."""

    @property
    def presence(self):
        return self.get('presence') or {}


class QuarantinedEvent(FanoutEvent):
    """``{"event": "quarantined", ...}``: the resilience envelope for a
    doc whose flush was refused (docs/RESILIENCE.md)."""

    @property
    def error(self):
        return self.get('error')

    @property
    def error_type(self):
        return self.get('errorType')


class ResyncEvent(FanoutEvent):
    """``{"event": "resync", ...}``: egress tier-2 drop-to-resubscribe
    (the client's auto-resubscribe machinery usually consumes this
    before the application sees it)."""

    @property
    def docs(self):
        return self.get('docs') or []

    @property
    def retry_after_ms(self):
        return self.get('retryAfterMs')


class Snapshot(dict):
    """A ``snapshot`` response: the doc's v2 container bytes plus the
    frontier clock they were built at (the cache key -- equal clocks
    mean byte-identical artifacts)."""

    @property
    def doc(self):
        return self.get('doc')

    @property
    def clock(self):
        return self.get('clock') or {}

    @property
    def data(self):
        """The container bytes (base64-decoded from the wire)."""
        raw = self.get('snapshot_b64')
        if raw is None:
            return None
        if isinstance(raw, bytes):
            return raw
        import base64
        return base64.b64decode(raw)


_EVENT_TYPES = {
    'change': ChangeEvent,
    'patch': PatchEvent,
    'presence': PresenceEvent,
    'quarantined': QuarantinedEvent,
    'resync': ResyncEvent,
    'resync_failed': ResyncEvent,
}


def typed_event(frame):
    """Wraps one raw frame dict in its typed class (identity for
    non-dicts and unknown ``event`` strings)."""
    if not isinstance(frame, dict):
        return frame
    cls = _EVENT_TYPES.get(frame.get('event'))
    return cls(frame) if cls is not None else frame
