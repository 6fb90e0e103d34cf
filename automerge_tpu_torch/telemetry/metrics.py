"""Metric primitives: counters, gauges, log-bucketed histograms, and a
thread-safe registry rendering Prometheus text exposition (format 0.0.4).

Design constraints (docs/OBSERVABILITY.md):
  * near-zero cost when idle -- a metric that is never touched costs one
    dict entry; an update is one lock acquire + O(1) arithmetic.  Every
    call site in the batch pipeline fires per BATCH (or per sidecar
    request), never per op.
  * thread-safe -- `ShardedNativePool` drives shards from concurrent
    threads, so every child shares the registry's lock (contention is
    negligible at batch granularity; tests/test_telemetry.py hammers it).
  * percentiles derivable offline -- histograms use fixed log2 bucket
    bounds, so p50/p95/p99 come from the bucket counts alone and two
    scrapes can be subtracted before quantiling.

Stdlib-only: this module is imported before numpy/torch are safe to load
(the sidecar pins the platform first).
"""

import threading

# log2-spaced latency bounds: 1us .. ~67s, 27 finite buckets (+Inf is
# implicit).  Wide enough for a single-op host batch and a multi-minute
# cold-compile batch alike.
DEFAULT_BUCKETS = tuple(1e-6 * 2 ** i for i in range(27))

_ESCAPES = {'\\': '\\\\', '"': '\\"', '\n': '\\n'}


def _escape(s, quote=False):
    out = []
    for ch in str(s):
        if ch in _ESCAPES and (quote or ch != '"'):
            out.append(_ESCAPES[ch])
        else:
            out.append(ch)
    return ''.join(out)


def format_value(v):
    """Prometheus sample value: integers render bare, floats via repr
    (full precision; scientific notation is valid exposition)."""
    if isinstance(v, float):
        if v == float('inf'):
            return '+Inf'
        if v != v:
            return 'NaN'
        if v.is_integer() and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def bucket_index(bounds, v):
    """Index of the bucket holding `v` against fixed sorted `bounds`
    (len(bounds) = the +Inf bucket).  Bisection: the binary search
    beats log() calls and stays exact at the boundaries.  The ONE
    bucket search shared by HistogramChild and the SLO windows
    (telemetry/attribution.py)."""
    lo, hi = 0, len(bounds)
    while lo < hi:
        mid = (lo + hi) // 2
        if v <= bounds[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def quantile_from_counts(bounds, counts, total, q):
    """Linear-interpolated quantile from bucket counts (the same
    estimate Prometheus' histogram_quantile computes server-side; +Inf
    observations clamp to the top finite bound).  Returns 0.0 on an
    empty histogram.  Shared by HistogramChild and the SLO windows so
    healthz p99s cannot drift from the exposition's."""
    if total == 0:
        return 0.0
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c > 0:
            lo = bounds[i - 1] if i > 0 else 0.0
            if i >= len(bounds):          # +Inf bucket: clamp
                return bounds[-1]
            hi = bounds[i]
            return lo + (hi - lo) * (target - (cum - c)) / c
    return bounds[-1]


def _labels_text(labelnames, labelvalues):
    if not labelnames:
        return ''
    return '{%s}' % ','.join(
        '%s="%s"' % (n, _escape(v, quote=True))
        for n, v in zip(labelnames, labelvalues))


class _Child(object):
    """One time series (a concrete label-value binding of a family)."""

    __slots__ = ('_lock',)

    def __init__(self, lock):
        self._lock = lock


class CounterChild(_Child):
    __slots__ = ('value',)

    def __init__(self, lock):
        _Child.__init__(self, lock)
        self.value = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError('counters only go up (got %r)' % (n,))
        with self._lock:
            self.value += n


class GaugeChild(_Child):
    __slots__ = ('value',)

    def __init__(self, lock):
        _Child.__init__(self, lock)
        self.value = 0.0

    def set(self, v):
        with self._lock:
            self.value = float(v)

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def dec(self, n=1):
        self.inc(-n)


class HistogramChild(_Child):
    __slots__ = ('bounds', 'counts', 'sum', 'count')

    def __init__(self, lock, bounds):
        _Child.__init__(self, lock)
        self.bounds = bounds
        # counts[i] observations in (bounds[i-1], bounds[i]]; the last
        # slot is the +Inf bucket
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def _bucket_index(self, v):
        return bucket_index(self.bounds, v)

    def observe(self, v):
        i = self._bucket_index(v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def read(self):
        """Atomic (counts copy, sum, count) -- scrapes and summaries must
        not tear against a concurrent observe(), or the exposition's
        +Inf bucket can disagree with _count."""
        with self._lock:
            return list(self.counts), self.sum, self.count

    def quantile(self, q):
        """Linear-interpolated quantile from the bucket counts (the same
        estimate Prometheus' histogram_quantile computes server-side).
        Returns 0.0 on an empty histogram."""
        counts, _sum, total = self.read()
        return self._quantile_from(counts, total, q)

    def _quantile_from(self, counts, total, q):
        return quantile_from_counts(self.bounds, counts, total, q)

    def summary(self):
        """{count, sum, p50, p95, p99} -- the bench-line embed shape;
        all fields derive from ONE atomic read."""
        counts, sum_, count = self.read()
        return {'count': count, 'sum': round(sum_, 6),
                'p50': round(self._quantile_from(counts, count, 0.50), 6),
                'p95': round(self._quantile_from(counts, count, 0.95), 6),
                'p99': round(self._quantile_from(counts, count, 0.99), 6)}


_CHILD_TYPES = {'counter': CounterChild, 'gauge': GaugeChild,
                'histogram': HistogramChild}


class MetricFamily(object):
    """A named metric with a fixed label schema; children are the
    concrete series.  An unlabeled family proxies child methods
    directly (family.inc(...) == family.labels().inc(...))."""

    def __init__(self, name, help_, type_, labelnames, lock, buckets=None):
        self.name = name
        self.help = help_
        self.type = type_
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self._lock = lock
        self._children = {}       # guarded-by: self._lock
        if not self.labelnames:
            self.labels()   # materialize the single series eagerly

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError('pass label values positionally OR by '
                                 'name, not both')
            if set(kw) != set(self.labelnames):
                raise ValueError('%s expects labels %r, got %r'
                                 % (self.name, self.labelnames,
                                    tuple(sorted(kw))))
            values = tuple(str(kw[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError('%s expects labels %r, got %r'
                             % (self.name, self.labelnames, values))
        with self._lock:
            child = self._children.get(values)
            if child is None:
                cls = _CHILD_TYPES[self.type]
                child = (cls(self._lock, self.buckets)
                         if self.type == 'histogram' else cls(self._lock))
                self._children[values] = child
        return child

    # unlabeled convenience surface
    def inc(self, n=1):
        self.labels().inc(n)

    def set(self, v):
        self.labels().set(v)

    def dec(self, n=1):
        self.labels().dec(n)

    def observe(self, v):
        self.labels().observe(v)

    def quantile(self, q):
        return self.labels().quantile(q)

    def summary(self):
        return self.labels().summary()

    @property
    def value(self):
        return self.labels().value

    # -- exposition -----------------------------------------------------

    def render(self, out):
        out.append('# HELP %s %s' % (self.name, _escape(self.help)))
        out.append('# TYPE %s %s' % (self.name, self.type))
        with self._lock:
            items = sorted(self._children.items())
        for values, child in items:
            lt = _labels_text(self.labelnames, values)
            if self.type == 'histogram':
                counts, sum_, count = child.read()
                cum = 0
                for i, bound in enumerate(child.bounds):
                    cum += counts[i]
                    blt = _labels_text(
                        self.labelnames + ('le',),
                        values + (format_value(float(bound)),))
                    out.append('%s_bucket%s %d' % (self.name, blt, cum))
                cum += counts[-1]
                blt = _labels_text(self.labelnames + ('le',),
                                   values + ('+Inf',))
                out.append('%s_bucket%s %d' % (self.name, blt, cum))
                out.append('%s_sum%s %s' % (self.name, lt,
                                            format_value(sum_)))
                out.append('%s_count%s %d' % (self.name, lt, count))
            else:
                out.append('%s%s %s' % (self.name, lt,
                                        format_value(child.value)))

    def snapshot(self):
        """Plain-dict view for bench embedding: scalar for an unlabeled
        family, {label-values: scalar} otherwise; histograms summarize."""
        with self._lock:
            items = sorted(self._children.items())

        def one(child):
            return child.summary() if self.type == 'histogram' \
                else child.value
        if not self.labelnames:
            return one(items[0][1]) if items else None
        return {','.join(v): one(c) for v, c in items}

    def reset(self):
        with self._lock:
            for child in self._children.values():
                if self.type == 'histogram':
                    child.counts = [0] * (len(child.bounds) + 1)
                    child.sum = 0.0
                    child.count = 0
                else:
                    child.value = 0.0


class MetricRegistry(object):
    """Ordered collection of families sharing one lock; `render()` is
    the full Prometheus exposition body."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}       # guarded-by: self._lock

    def _get_or_make(self, name, help_, type_, labelnames, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != type_ or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        'metric %s re-registered with a different '
                        'type/label schema' % name)
                return fam
            fam = MetricFamily(name, help_, type_, labelnames,
                               threading.Lock(), buckets)
            self._families[name] = fam
            return fam

    def counter(self, name, help_, labelnames=()):
        return self._get_or_make(name, help_, 'counter', labelnames)

    def gauge(self, name, help_, labelnames=()):
        return self._get_or_make(name, help_, 'gauge', labelnames)

    def histogram(self, name, help_, labelnames=(), buckets=None):
        return self._get_or_make(name, help_, 'histogram', labelnames,
                                 buckets)

    def families(self):
        with self._lock:
            return list(self._families.values())

    def render(self):
        out = []
        for fam in self.families():
            fam.render(out)
        return '\n'.join(out) + '\n'

    def snapshot(self):
        return {fam.name: fam.snapshot() for fam in self.families()}

    def reset(self):
        for fam in self.families():
            fam.reset()
