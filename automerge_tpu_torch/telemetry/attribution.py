"""Per-request critical-path attribution + the SLO surface
(docs/OBSERVABILITY.md request-stage glossary).

Always on, no span machinery: the gateway threads one
:class:`Clock` -- a monotonic timestamp vector -- through every
request's life (admission -> queue -> flush claim -> pool dispatch ->
device collect -> emit -> fan-out write).  Each stage is the DELTA
between consecutive marks, so the stages partition the request wall
exactly: `sum(stages through emit) == total` by construction, which is
what `make obs-check` gates.  Per-stage milliseconds land in the
``amtpu_request_stage_ms{stage=...}`` histogram family (stage
``total`` is the through-emit wall; ``fanout`` is the post-response
subscriber-write tail, attributed on top of the total).

Tail-sampled exemplars: a request whose total exceeds ``SLOW_MS``
(and every failed/quarantined one) retroactively emits a full span
tree -- one root ``request.exemplar`` record plus one child per stage,
with the flight recorder's surrounding events attached -- through the
span JSONL exporter (``spans.TRACE_FILE``; written even while span
tracing is disabled, exemplars ARE the tail sample) and into a bounded
in-memory deque (``recent_exemplars()``, served by /debug/recorder's
sibling surface and tests).

SLO surface: every attributed request also lands in per-class rolling
windows (10 s slots), from which the healthz ``slo`` section derives
rolling p50/p99 per request class (``mutate`` / ``read`` / ``control``)
and multi-window error-budget burn rates against ``SLO_P99_MS``
(budget: 1% of requests may exceed the target; burn 1.0 = spending
exactly budget, >1 = on track to exhaust it).

Flush-phase seams: the native driver stamps always-on per-batch
dispatch/collect seconds into a thread-local accumulator
(:func:`note_flush_phase`); the gateway brackets its pool call with
:func:`flush_phases_begin` / :func:`flush_phases_end` to split the
shared apply wall into the ``dispatch`` and ``collect`` stages.
Outside a bracket the seam is one thread-local read returning None --
the cost `make telemetry-check` keeps inside the idle-overhead budget.
"""

import collections
import threading
import time

#: exemplar threshold in ms (the JAX package's AMTPU_SLOW_MS)
SLOW_MS = 250.0
#: the p99 target the burn rates measure against (AMTPU_SLO_P99_MS)
SLO_P99_MS = 100.0
#: least seconds between two exemplars (AMTPU_EXEMPLAR_MIN_S)
EXEMPLAR_MIN_S = 0.05

#: the stage universe, in pipeline order (docs/OBSERVABILITY.md)
REQUEST_STAGES = ('admit', 'queue', 'claim', 'dispatch', 'collect',
                  'emit', 'fanout')

#: request classes the SLO windows track
CLASSES = ('mutate', 'read', 'control')

_MUTATE_CMDS = ('apply_changes', 'apply_batch', 'apply_local_change',
                'load')
_CONTROL_CMDS = ('subscribe', 'unsubscribe', 'presence')


def class_of(cmd):
    if cmd in _MUTATE_CMDS:
        return 'mutate'
    if cmd in _CONTROL_CMDS:
        return 'control'
    return 'read'


def slow_ms():
    """Exemplar threshold: requests slower than this (ms) emit a full
    retroactive span tree (``SLOW_MS``)."""
    return SLOW_MS


def slo_p99_ms():
    """The p99 latency target the burn rates measure against
    (``SLO_P99_MS``)."""
    return SLO_P99_MS


def _family():
    """The stage histogram family, resolved lazily: this module is
    imported while telemetry/__init__ is still executing."""
    global _STAGE_MS
    if _STAGE_MS is None:
        from . import QUEUE_WAIT_BUCKETS, registry
        _STAGE_MS = registry.histogram(
            'amtpu_request_stage_ms',
            'Milliseconds one gateway request spent in each pipeline '
            'stage (admit/queue/claim/dispatch/collect/emit; "total" '
            'is the through-emit wall the stages partition exactly; '
            '"fanout" is the post-response subscriber-write tail)',
            ('stage',), buckets=QUEUE_WAIT_BUCKETS)
    return _STAGE_MS


_STAGE_MS = None


class Clock(object):
    """One request's timestamp vector.  `mark(stage)` closes the stage
    begun at the previous mark; `mark_split` closes one wall segment as
    two stages (the shared flush apply, split dispatch/collect);
    `add(stage, s)` attributes extra seconds outside the partition
    (the fan-out tail)."""

    __slots__ = ('t0', 'prev', 'stages', 'cls', 'trace')

    def __init__(self, cls, t0=None, trace=None):
        """`t0` backdates the clock to frame receipt (the gateway reader
        stamps it before decoding), so `admit` really covers decode ->
        routing -> admission, not just Clock construction.  `trace` is
        the request's wire context (`{'traceId','spanId'}` or None):
        the exemplar tree adopts it so cross-process assembly sees one
        trace, not a freshly minted island."""
        t = time.perf_counter() if t0 is None else t0
        self.t0 = t
        self.prev = t
        self.stages = []
        self.cls = cls
        self.trace = trace

    def mark(self, stage):
        t = time.perf_counter()
        self.stages.append((stage, t - self.prev))
        self.prev = t

    def mark_split(self, stage1, stage2, stage2_s):
        """Closes the segment since the previous mark as `stage1` +
        `stage2`, giving `stage2` at most `stage2_s` of it -- `stage1`
        absorbs the remainder, so the partition stays exact even when
        the measured sub-phase is smaller than the wall segment."""
        t = time.perf_counter()
        seg = t - self.prev
        s2 = min(max(stage2_s, 0.0), seg)
        self.stages.append((stage1, seg - s2))
        self.stages.append((stage2, s2))
        self.prev = t

    def add(self, stage, seconds):
        self.stages.append((stage, max(0.0, seconds)))


def finish(clock, ok=True, cmd=None, rid=None, doc=None):
    """Final accounting for one request: stage histograms, SLO windows,
    and (slow or failed) the exemplar span tree.  `total` is the sum of
    the partition stages (everything except the fan-out tail)."""
    from . import metric
    fam = _family()
    total_s = 0.0
    for stage, dur in clock.stages:
        fam.labels(stage).observe(dur * 1000.0)
        if stage != 'fanout':
            total_s += dur
    total_ms = total_s * 1000.0
    fam.labels('total').observe(total_ms)
    metric('slo.requests')
    breach = total_ms > slo_p99_ms()
    if breach:
        metric('slo.breaches')
    _SLO.observe(clock.cls, total_ms, breach)
    if not ok or total_ms > slow_ms():
        _emit_exemplar(clock, ok, total_ms, cmd, rid, doc)


# ---------------------------------------------------------------------------
# flush-phase seams (native driver -> gateway)
# ---------------------------------------------------------------------------

_flush_local = threading.local()


def flush_phases_begin():
    """Gateway-side: start accumulating the pool call's per-batch
    dispatch/collect seconds on this thread."""
    _flush_local.phases = {}


def note_flush_phase(stage, seconds):
    """Native-driver seam: accumulate always-on per-batch phase seconds
    into the active bracket (one thread-local read + dict add; a no-op
    costing one attribute miss outside a bracket)."""
    d = getattr(_flush_local, 'phases', None)
    if d is not None:
        d[stage] = d.get(stage, 0.0) + seconds


def flush_phases_end():
    """Gateway-side: close the bracket, returning {stage: seconds}."""
    d = getattr(_flush_local, 'phases', None)
    _flush_local.phases = None
    return d or {}


# ---------------------------------------------------------------------------
# exemplars (the tail sample)
# ---------------------------------------------------------------------------

_EXEMPLAR_KEEP = 32

#: events attached per exemplar (the recorder ring can be huge; the
#: post-mortem only needs the immediate neighbourhood)
_EXEMPLAR_EVENTS_MAX = 256

_exemplars = collections.deque(maxlen=_EXEMPLAR_KEEP)
_exemplar_last = 0.0


def _emit_exemplar(clock, ok, total_ms, cmd, rid, doc):
    global _exemplar_last
    from . import metric
    from .recorder import RECORDER, record
    from .spans import export_record, new_id, new_trace_id
    # rate limit (EXEMPLAR_MIN_S, default 50ms): exemplars are a
    # TAIL SAMPLE, not a log -- under a quarantine storm or an error
    # -spamming client, every failing request would otherwise pay a
    # full ring snapshot + JSONL write on the dispatcher's critical
    # path, collapsing flush throughput exactly when the server is
    # already unhealthy.  Benign write-write race: two threads racing
    # the stamp emit two exemplars, which the sample survives.
    now_mono = time.monotonic()
    if now_mono - _exemplar_last < EXEMPLAR_MIN_S:
        return
    _exemplar_last = now_mono
    metric('slo.exemplars')
    # adopt the request's wire trace context: the exemplar
    # tree and the recorder event join the cross-process trace the
    # client started, so `amtpu_trace` assembles one tree per request
    # instead of per-process islands; parent = the client's span id
    tctx = clock.trace if isinstance(clock.trace, dict) else {}
    trace_id = tctx.get('traceId') or new_trace_id()
    parent_id = tctx.get('spanId')
    root_id = new_id()
    record('request.slow', doc=doc, n=int(total_ms),
           detail=cmd if ok else '%s!' % (cmd,), trace=trace_id)
    now = time.time()
    start = now - (time.perf_counter() - clock.t0)
    root = {'name': 'request.exemplar', 'trace': trace_id,
            'span': root_id, 'parent': parent_id,
            'start': round(start, 6), 'dur_s': round(total_ms / 1e3, 6),
            'attrs': {'cmd': cmd, 'rid': rid, 'doc': doc,
                      'class': clock.cls, 'ok': bool(ok),
                      'total_ms': round(total_ms, 3)},
            # the recorder's surrounding events: what the ring still
            # holds from just before this request began (newest
            # _EXEMPLAR_EVENTS_MAX -- the neighbourhood, not the ring)
            'events': RECORDER.tail(start - 1.0,
                                    limit=_EXEMPLAR_EVENTS_MAX)}
    children = []
    t = start
    for stage, dur in clock.stages:
        children.append({'name': 'request.stage.%s' % stage,
                         'trace': trace_id, 'span': new_id(),
                         'parent': root_id, 'start': round(t, 6),
                         'dur_s': round(dur, 9)})
        if stage != 'fanout':
            t += dur
    _exemplars.append(root)
    export_record(root)
    for ch in children:
        export_record(ch)


def recent_exemplars():
    """The last few exemplar roots (bounded deque), newest last."""
    return list(_exemplars)


# ---------------------------------------------------------------------------
# SLO windows (rolling slots -> healthz `slo` section)
# ---------------------------------------------------------------------------

#: slot granularity and horizon: 10 s slots x 360 = one hour of history
_SLOT_S = 10
_SLOTS = 360

#: the windows healthz reports (seconds); burn rates use the last two
#: (the SRE multi-window pattern: a fast window catches a cliff, a slow
#: one catches a leak)
WINDOWS_S = (60, 300, 3600)


class _SloWindows(object):
    """Per-class rolling latency/breach slots.  One lock; observe() is
    one bucket increment, section() walks at most _SLOTS entries per
    class (cold: healthz only)."""

    def __init__(self):
        self._lock = threading.Lock()
        # class -> {slot_index: [bucket_counts, total, breaches]}
        self._slots = {c: collections.OrderedDict() for c in CLASSES}
        self._bounds = None       # resolved lazily (QUEUE_WAIT_BUCKETS)

    def _bucket(self, ms):
        # the bucket search and quantile estimator are metrics.py's --
        # healthz slo p99s must agree with histogram_quantile over the
        # exposition for the same data
        from .metrics import bucket_index
        if self._bounds is None:
            from . import QUEUE_WAIT_BUCKETS
            self._bounds = QUEUE_WAIT_BUCKETS
        return bucket_index(self._bounds, ms)

    def observe(self, cls, ms, breach):
        slot = int(time.time()) // _SLOT_S
        b = self._bucket(ms)
        with self._lock:
            slots = self._slots.get(cls)
            if slots is None:
                return
            ent = slots.get(slot)
            if ent is None:
                ent = slots[slot] = [[0] * (len(self._bounds) + 1),
                                     0, 0]
                while len(slots) > _SLOTS:
                    slots.popitem(last=False)
            ent[0][b] += 1
            ent[1] += 1
            if breach:
                ent[2] += 1

    def slots_snapshot(self):
        """JSON-safe deep copy of the raw mergeable slot state:
        ``{class: {slot_index: [bucket_counts, total, breaches]}}``.
        This -- not the derived percentiles -- is the unit the fleet
        plane aggregates: slots from N replicas SUM element-wise, and
        :func:`section_from_slots` over the sum is bit-identical to one
        replica having observed all the traffic (percentile averaging
        is a lie; docs/OBSERVABILITY.md fleet section).  Served raw by
        ``/debug/slo_slots`` (telemetry/httpd.py)."""
        with self._lock:
            return {cls: {slot: [list(ent[0]), ent[1], ent[2]]
                          for slot, ent in slots.items()}
                    for cls, slots in self._slots.items()}

    def section(self):
        """The healthz ``slo`` payload: per class per window
        {count, p50_ms, p99_ms, breach_frac}, plus burn rates for the
        two slowest windows against the 1% budget."""
        out = section_from_slots(self.slots_snapshot())
        out['exemplars_kept'] = len(_exemplars)
        return out


def section_from_slots(slots_by_class, now_slot=None, bounds=None):
    """Derives the ``slo`` section from a slot snapshot
    (:meth:`_SloWindows.slots_snapshot` shape; slot keys may be ints or
    the strings JSON made of them).  PURE and deterministic: the single
    -replica healthz section and the fleet-merged section both come
    from here, so an N-replica merge is bit-consistent with a
    per-replica recompute by construction -- integer bucket counts sum
    in any order, and the quantile estimator is metrics.py's."""
    from .metrics import quantile_from_counts
    if bounds is None:
        from . import QUEUE_WAIT_BUCKETS
        bounds = QUEUE_WAIT_BUCKETS
    if now_slot is None:
        now_slot = int(time.time()) // _SLOT_S

    def merged(cls, window_s):
        cutoff = now_slot - max(1, window_s // _SLOT_S)
        counts = None
        total = breaches = 0
        for slot in sorted(slots_by_class.get(cls, {})):
            bc, t, br = slots_by_class[cls][slot]
            if int(slot) <= cutoff:
                continue
            if counts is None:
                counts = list(bc)
            else:
                counts = [a + b for a, b in zip(counts, bc)]
            total += t
            breaches += br
        return counts, total, breaches

    def quant(counts, total, q):
        if counts is None:
            return 0.0
        return quantile_from_counts(bounds, counts, total, q)

    classes = {}
    for cls in CLASSES:
        per = {}
        for w in WINDOWS_S:
            counts, total, breaches = merged(cls, w)
            per['%ds' % w] = {
                'count': total,
                'p50_ms': round(quant(counts, total, 0.50), 3),
                'p99_ms': round(quant(counts, total, 0.99), 3),
                'breach_frac': round(breaches / total, 6)
                if total else 0.0,
            }
        classes[cls] = per
    burn = {}
    for w in WINDOWS_S[-2:]:
        tot = br = 0
        for cls in CLASSES:
            _c, t, b = merged(cls, w)
            tot += t
            br += b
        # budget: 1% of requests may exceed the p99 target; burn
        # 1.0 = spending exactly budget over this window
        burn['%ds' % w] = round((br / tot) / 0.01, 3) if tot else 0.0
    return {'target_p99_ms': slo_p99_ms(),
            'slow_ms': slow_ms(),
            'classes': classes,
            'burn': burn}


_SLO = _SloWindows()


def slo_section():
    return _SLO.section()


def slo_slots():
    """The raw mergeable slot snapshot of this process (the fleet
    plane's scrape unit)."""
    return _SLO.slots_snapshot()
