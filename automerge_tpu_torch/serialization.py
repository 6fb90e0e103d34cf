"""Serialization: save/load of documents.

The reference serializes the full change history with transit-JSON and
replays it through a fresh backend on load
(`src/automerge.js:45-52`).  Here the format is plain JSON:
`{"version": 1, "changes": [...]}` -- the change schema is already
JSON-native, so the checkpoint format doubles as the wire format of the
sidecar protocol.  Load replays through one batched `apply_changes` call
(O(history), like the reference), and the pool can replay the same
history in one device pass.  The format is the JAX package's, so a
document saved by either package loads in the other.
"""

import json

FORMAT_VERSION = 1


def serialize_changes(changes):
    return json.dumps({'version': FORMAT_VERSION, 'changes': changes},
                      separators=(',', ':'), sort_keys=True)


def deserialize_changes(string):
    data = json.loads(string)
    if isinstance(data, list):  # bare change-list form is also accepted
        return data
    if data.get('version') != FORMAT_VERSION:
        raise ValueError('Unsupported save format version: %r'
                         % (data.get('version'),))
    return data['changes']
