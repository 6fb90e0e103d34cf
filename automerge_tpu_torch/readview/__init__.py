"""The read path over the port's pool (docs/SERVING.md read path).

  * **Server-side patch shipping** -- subscriptions with
    ``mode: "patch"`` receive the flush's server-computed patch instead
    of change bytes, fanned through the encode-once FanoutEngine and
    the egress tiers (`sync/fanout.py` and `scheduler/gateway.py` own
    the hot path).
  * **Snapshot serving** (`snapshot.py` + the ``snapshot`` protocol
    command) -- a doc's v2 container bytes, cache-keyed by frontier
    clock, as the cold-open artifact.

`events.py` holds the typed client-side event objects
`SidecarClient.next_event()` demuxes into (dict subclasses, so
``ev['event']`` consumers are untouched).  `replica.py` holds the
materialized read replica (`ReadReplica`): a subscriber that applies
an upstream gateway's fan-out stream into its own pool and serves reads
on a read-only gateway.
"""

from .events import (ChangeEvent, PatchEvent, PresenceEvent,  # noqa: F401
                     QuarantinedEvent, ResyncEvent, Snapshot,
                     typed_event)
from .snapshot import SnapshotCache  # noqa: F401
