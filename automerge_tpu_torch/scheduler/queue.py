"""Admission-controlled request queue for the serve gateway
(docs/SERVING.md).

Connection reader threads `offer()` decoded mutating requests; the
single dispatcher thread `wait_for_work()`s until the coalescing window
closes and then `claim()`s one flush's worth of work.  Three invariants
live here:

  * **Bounded memory** -- the queue admits at most ``QUEUE_MAX_OPS``
    queued ops (high watermark).  Past it the queue enters *shedding*:
    new mutating requests raise :class:`Overloaded` (the gateway answers
    the typed ``{"errorType": "Overloaded", "retryAfterMs": ...}``
    envelope) until the backlog drains below the low watermark
    (``QUEUE_LOW_FRAC`` of max, default 0.5) -- hysteresis so one
    burst doesn't flap admission per request.  Read-only requests that
    must queue for ordering are admitted unconditionally (they answer
    from state, shedding them saves nothing).
  * **Per-doc FIFO** -- ``claim()`` walks the queue in arrival order and
    takes at most ONE op per doc per flush; an op whose doc is already
    taken parks (stays queued), and parking a doc blocks every later op
    touching it, so cross-doc reordering never reorders one doc's ops.
  * **Read-your-writes** -- ``doc_pending()`` tells the gateway whether
    a doc still has un-answered mutating ops (queued or in-flight until
    the response is written), which is what routes a read through the
    queue instead of the inline bypass.
"""

import threading
import time

from .. import telemetry

#: coalescing window in ms (the JAX package's AMTPU_FLUSH_DEADLINE_MS)
FLUSH_DEADLINE_MS = 2.0
#: docs per coalesced flush (AMTPU_MAX_BATCH_DOCS)
MAX_BATCH_DOCS = 256
#: queued ops per flush (AMTPU_MAX_BATCH_OPS)
MAX_BATCH_OPS = 2048
#: high watermark in queued ops (AMTPU_QUEUE_MAX_OPS)
QUEUE_MAX_OPS = 4096
#: low watermark as a fraction of the high one (AMTPU_QUEUE_LOW_FRAC)
QUEUE_LOW_FRAC = 0.5


def flush_deadline_s():
    """Coalescing window: how long the dispatcher lets mutating requests
    accumulate after the first one before flushing
    (``FLUSH_DEADLINE_MS``, default 2ms)."""
    return max(0.0, FLUSH_DEADLINE_MS) / 1000.0


def max_batch_docs():
    """Docs per coalesced flush cap (``MAX_BATCH_DOCS``)."""
    return max(1, MAX_BATCH_DOCS)


def max_batch_ops():
    """Queued-ops-per-flush cap -- a third flush trigger next to the
    deadline and the doc cap (``MAX_BATCH_OPS``)."""
    return max(1, MAX_BATCH_OPS)


#: read-only commands: the gateway's routing table for the inline
#: bypass, and this module's pending-doc accounting (reads never count
#: as pending mutations -- counting them would wedge doc_pending when a
#: read queues behind another read).  Owned here so the two users
#: cannot drift.
READ_CMDS = ('get_patch', 'save', 'get_missing_deps',
             'get_missing_changes', 'get_changes_for_actor',
             'snapshot', 'get_clock')


class Overloaded(Exception):
    """Raised by ``offer()`` while shedding; carries the retry hint the
    wire envelope ships as ``retryAfterMs``."""

    def __init__(self, msg, retry_after_ms):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms


class PendingOp(object):
    """One decoded request parked between its reader thread and the
    dispatcher.  ``docs`` is the tuple of doc keys the op touches (one
    for apply_changes/apply_local_change/load/reads, many for a
    client-sent apply_batch); ``batchable`` marks ops the dispatcher may
    coalesce into one pool batch."""

    __slots__ = ('conn', 'rid', 'cmd', 'req', 'docs', 'n_ops',
                 'batchable', 'enq_t', 'clock', 'failed', 'answered')

    def __init__(self, conn, rid, cmd, req, docs, n_ops, batchable):
        self.conn = conn
        self.rid = rid
        self.cmd = cmd
        self.req = req
        self.docs = tuple(docs)
        self.n_ops = max(1, int(n_ops))
        self.batchable = bool(batchable)
        self.enq_t = time.perf_counter()
        # critical-path attribution (telemetry/attribution.py): the
        # gateway attaches a stage Clock before offer() and clears it
        # at finalization; `failed` records the response outcome;
        # `answered` guards the dispatcher's crash sweep from double
        # -finishing ops a partial flush already answered
        self.clock = None
        self.failed = False
        self.answered = False


class AdmissionQueue(object):
    def __init__(self, max_ops=None, low_frac=None):
        if max_ops is None:
            max_ops = QUEUE_MAX_OPS
        if low_frac is None:
            low_frac = QUEUE_LOW_FRAC
        self.max_ops = max(1, int(max_ops))
        self.low_ops = max(0, min(self.max_ops - 1,
                                  int(self.max_ops * low_frac)))
        # `_work` is a Condition ON `_lock`: holding either IS holding
        # the one queue lock, so the guarded-by annotations (enforced
        # by `make static-check`, docs/ANALYSIS.md) accept both.
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # arrival order; parked ops stay put
        self._items = []          # guarded-by: self._lock|self._work
        # queued (unclaimed) ops
        self.depth_ops = 0        # guarded-by: self._lock|self._work
        self.shedding = False     # guarded-by: self._lock|self._work
        # doc -> mutating ops not yet answered
        self._pending_docs = {}   # guarded-by: self._lock|self._work
        self._closed = False      # guarded-by: self._lock|self._work

    # -- producer side (connection reader threads) ----------------------

    def offer(self, op, admit_always=False):
        """Enqueues `op` or raises :class:`Overloaded`.  `admit_always`
        bypasses admission (ordered read-only ops: rejecting a read
        frees no meaningful memory and would break read-your-writes).
        An op bigger than the whole queue is admitted iff the queue is
        empty (see below) -- the watermark bounds backlog, not request
        size."""
        with self._work:
            if self._closed:
                raise Overloaded('gateway is shutting down', 0)
            if not admit_always:
                if self.shedding and self.depth_ops <= self.low_ops:
                    self.shedding = False
                    telemetry.recorder.record('shed.off',
                                              n=self.depth_ops)
                # a single request LARGER than the whole queue is
                # admitted when the queue is empty (the --serial loop
                # accepts it, and claim() serves an oversized op as its
                # own flush) -- the watermark bounds backlog, it is not
                # a request-size limit; depth then overshoots by at
                # most one request
                over = self.depth_ops + op.n_ops > self.max_ops \
                    and self.depth_ops > 0
                if self.shedding or over:
                    if not self.shedding:
                        # flight-recorder transition event (the per
                        # -request counter below stays per shed)
                        telemetry.recorder.record('shed.on',
                                                  n=self.depth_ops)
                    self.shedding = True
                    telemetry.metric('scheduler.shed')
                    raise Overloaded(
                        'gateway queue full (%d/%d queued ops); retry '
                        'after backoff' % (self.depth_ops, self.max_ops),
                        self.retry_after_ms())
            self._items.append(op)
            self.depth_ops += op.n_ops
            if op.cmd not in READ_CMDS:
                for d in op.docs:
                    self._pending_docs[d] = \
                        self._pending_docs.get(d, 0) + 1
            self._work.notify()

    def retry_after_ms(self):
        """Backoff hint: a couple of flush windows, floored at 1ms."""
        return max(1, int(4 * flush_deadline_s() * 1000))

    def doc_pending(self, doc):
        """True while `doc` has mutating ops that were admitted but not
        yet answered -- the read-bypass routing test."""
        with self._lock:
            return self._pending_docs.get(doc, 0) > 0

    def note_complete(self, op):
        """The response for a claimed op was written; releases its docs
        for the inline read bypass."""
        if op.cmd in READ_CMDS:
            return
        with self._lock:
            for d in op.docs:
                n = self._pending_docs.get(d, 0) - 1
                if n > 0:
                    self._pending_docs[d] = n
                else:
                    self._pending_docs.pop(d, None)

    # -- consumer side (the dispatcher thread) --------------------------

    def wait_for_work(self, deadline_s=None, max_docs=None,
                      max_ops=None):
        """Blocks until at least one op is queued, then holds the
        coalescing window open until the OLDEST queued op is
        `deadline_s` old, the queue holds `max_docs` candidate ops or
        `max_ops` queued ops, or the queue closes.  Returns False only
        when closed and drained."""
        if deadline_s is None:
            deadline_s = flush_deadline_s()
        if max_docs is None:
            max_docs = max_batch_docs()
        if max_ops is None:
            max_ops = max_batch_ops()
        with self._work:
            while not self._items and not self._closed:
                self._work.wait()
            if not self._items:
                return False
            first = self._items[0].enq_t
            while not self._closed:
                age = time.perf_counter() - first
                if age >= deadline_s:
                    break
                if len(self._items) >= max_docs:
                    break
                if self.depth_ops >= max_ops:
                    break
                self._work.wait(deadline_s - age)
            return True

    def claim(self, max_docs=None, max_ops=None):
        """One coalescing pass in arrival order.  Returns
        ``(batch_ops, exec_ops)``: `batch_ops` coalesce into one pool
        batch (disjoint docs, caps respected); `exec_ops` run serially
        in claim order (local changes, loads, ordered reads).  Ops left
        behind (doc conflict or caps) stay queued for the next flush;
        every doc they touch blocks later claims this pass, preserving
        per-doc FIFO."""
        if max_docs is None:
            max_docs = max_batch_docs()
        if max_ops is None:
            max_ops = max_batch_ops()
        with self._lock:
            taken, blocked = set(), set()
            batch, execs, remaining = [], [], []
            n_docs = n_ops = parked = 0
            for op in self._items:
                conflict = any(d in taken or d in blocked
                               for d in op.docs)
                # caps bound ADDITIONAL coalescing, never singleton
                # service: an op bigger than a cap still claims into an
                # empty flush (otherwise it would park forever, wedging
                # its doc and hot-spinning the dispatcher)
                over = op.batchable and batch and (
                    n_docs + len(op.docs) > max_docs
                    or n_ops + op.n_ops > max_ops)
                if conflict or over:
                    blocked.update(op.docs)
                    remaining.append(op)
                    parked += 1
                    continue
                taken.update(op.docs)
                self.depth_ops -= op.n_ops
                if op.batchable:
                    n_docs += len(op.docs)
                    n_ops += op.n_ops
                    batch.append(op)
                else:
                    execs.append(op)
            self._items = remaining
        if parked:
            telemetry.metric('scheduler.parked', parked)
        return batch, execs

    def close(self):
        with self._work:
            self._closed = True
            self._work.notify_all()

    def stats(self):
        with self._lock:
            return {'depth_ops': self.depth_ops,
                    'queued': len(self._items),
                    'shedding': self.shedding,
                    'max_ops': self.max_ops,
                    'low_ops': self.low_ops,
                    'pending_docs': len(self._pending_docs)}
