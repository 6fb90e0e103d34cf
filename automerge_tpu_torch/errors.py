"""Error types mirroring the reference's use of JS Error/RangeError/TypeError."""


class AutomergeError(Exception):
    pass


class RangeError(AutomergeError, ValueError):
    """Mirrors JS RangeError (invalid value / out of range)."""


class OverloadedError(AutomergeError):
    """The serve gateway refused a mutating request at admission
    (docs/SERVING.md): the request queue crossed its high watermark and
    is shedding until it drains below the low one.  ``retry_after_ms``
    carries the server's backoff hint (the wire envelope's
    ``retryAfterMs``); retrying after that delay is expected to be
    admitted once the queue drains."""

    def __init__(self, msg, retry_after_ms=None):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms


class ReplicaUnavailableError(AutomergeError):
    """The fleet router lost its transport to the replica that owns the
    request's doc mid-flight (docs/SERVING.md failover section): the op
    MAY not have executed, so the wire envelope (``errorType:
    "ReplicaUnavailable"``) is retryable -- re-sending the same change
    is exactly-once under the CRDT's (actor, seq) dedup.
    ``retry_after_ms`` carries the router's hint; by then the health
    monitor has either recovered the member or failed its docs over to
    survivors."""

    def __init__(self, msg, retry_after_ms=None):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms


class ReplicaFailedError(AutomergeError):
    """A replica died and fleet failover could NOT recover this doc
    (docs/RESILIENCE.md fleet degradation tiers): nothing durable to
    restore from, or the restore itself failed on every survivor.  The
    wire envelope (``errorType: "ReplicaFailed"``) names the doc;
    retrying cannot help -- the caller must treat the doc's
    unreplicated tail as lost."""

    def __init__(self, msg, doc=None):
        super().__init__(msg)
        self.doc = doc


class WrongReplicaError(AutomergeError):
    """A replica answered an op for a doc it no longer owns
    (docs/SERVING.md routing section): the doc was migrated away and
    the wire envelope (``errorType: "WrongReplica"``) names the new
    owner (``owner``) and the ring version of the move
    (``ring_version``).  The fleet router redirects transparently;
    ``SidecarClient`` retries a bounded number of times
    (`sidecar.client.ROUTE_REDIRECTS`) for the stale-direct-connection
    case and
    then surfaces this so the caller can re-resolve placement."""

    def __init__(self, msg, owner=None, ring_version=None):
        super().__init__(msg)
        self.owner = owner
        self.ring_version = ring_version
