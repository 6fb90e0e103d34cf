"""Connection -- per-peer, multi-document sync state machine
(reference: `src/connection.js`, 111 LoC).

Tracks `their_clock` (most recent vector clock we believe the peer has) and
`our_clock` (what we've advertised); ships `{docId, clock, changes}` messages
through a user-supplied `send_msg` callback, so any transport works.  The
message schema is kept verbatim from the reference; across the port's
pools the same clock-union/missing-changes algebra runs batched
(`sync/replica_set.py`).
"""

from .. import backend as Backend
from .. import frontend as Frontend
from .. import telemetry
from ..utils import less_or_equal


def clock_union(clock_map, doc_id, clock):
    """Merges `clock` into clock_map[doc_id] componentwise-max
    (reference: connection.js:9-12).

    The reference rebuilds the whole immutable multi-doc map per merge;
    only per-DOC isolation is observable (messages copy the clock they
    embed), so this updates the map in place and rebuilds just the one
    doc's entry -- O(actors) per send instead of O(docs), which is what
    lets one Connection track thousands of documents."""
    merged = dict(clock_map.get(doc_id) or {})
    for actor, seq in clock.items():
        if seq > merged.get(actor, 0):
            merged[actor] = seq
    clock_map[doc_id] = merged
    return clock_map


class Connection:
    def __init__(self, doc_set, send_msg):
        self._doc_set = doc_set
        self._send_msg = send_msg
        self._their_clock = {}
        self._our_clock = {}

    def open(self):
        """Advertises every doc in one batched pass, then registers for
        changes (reference: connection.js:42-45).  Each doc's backend
        state is fetched once and threaded through validation AND the
        missing-changes decision (the per-doc serial path fetched it
        twice per advertisement)."""
        for doc_id in self._doc_set.doc_ids:
            self.doc_changed(doc_id, self._doc_set.get_doc(doc_id))
        self._doc_set.register_handler(self.doc_changed)

    def close(self):
        self._doc_set.unregister_handler(self.doc_changed)

    def send_msg(self, doc_id, clock, changes=None):
        """(reference: connection.js:51-56)"""
        msg = {'docId': doc_id, 'clock': dict(clock)}
        self._our_clock = clock_union(self._our_clock, doc_id, clock)
        if changes is not None:
            msg['changes'] = changes
        telemetry.SYNC_MSGS.labels('out').inc()
        with telemetry.span('sync.send', doc=doc_id,
                            changes=len(changes) if changes else 0):
            self._send_msg(msg)

    def maybe_send_changes(self, doc_id, _state=None):
        """Ships changes the peer is missing, or advertises our clock
        (reference: connection.js:58-73).  `_state` lets doc_changed
        pass the backend state it already fetched for validation."""
        state = _state if _state is not None else \
            Frontend.get_backend_state(self._doc_set.get_doc(doc_id))
        clock = state['opSet']['clock']

        if doc_id in self._their_clock:
            changes = Backend.get_missing_changes(
                state, self._their_clock[doc_id])
            if changes:
                self._their_clock = clock_union(self._their_clock, doc_id, clock)
                self.send_msg(doc_id, clock, changes)
                return

        if dict(clock) != self._our_clock.get(doc_id, {}):
            self.send_msg(doc_id, clock)

    def doc_changed(self, doc_id, doc):
        """DocSet handler (reference: connection.js:76-89)."""
        state = Frontend.get_backend_state(doc)
        if state is None or 'opSet' not in state:
            raise TypeError(
                'This object cannot be used for network sync. '
                'Are you trying to sync a snapshot from the history?')
        clock = state['opSet']['clock']
        if not less_or_equal(self._our_clock.get(doc_id, {}), clock):
            raise AssertionError('Cannot pass an old state object to a connection')
        self.maybe_send_changes(doc_id, _state=state)

    def receive_msg(self, msg):
        """(reference: connection.js:91-108)"""
        telemetry.SYNC_MSGS.labels('in').inc()
        with telemetry.span('sync.receive', doc=msg.get('docId'),
                            changes=len(msg.get('changes') or ())):
            return self._receive_msg(msg)

    def _receive_msg(self, msg):
        if 'clock' in msg and msg['clock'] is not None:
            self._their_clock = clock_union(self._their_clock, msg['docId'],
                                            msg['clock'])
        if 'changes' in msg and msg['changes'] is not None:
            return self._doc_set.apply_changes(msg['docId'], msg['changes'])

        if self._doc_set.get_doc(msg['docId']) is not None:
            self.maybe_send_changes(msg['docId'])
        elif msg['docId'] not in self._our_clock:
            # The remote has a document we don't: ask for it
            self.send_msg(msg['docId'], {})

        return self._doc_set.get_doc(msg['docId'])

    # camelCase aliases (reference API surface)
    sendMsg = send_msg
    maybeSendChanges = maybe_send_changes
    docChanged = doc_changed
    receiveMsg = receive_msg
