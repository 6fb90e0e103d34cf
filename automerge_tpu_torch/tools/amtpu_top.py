"""amtpu-top: a live terminal view of one serving sidecar -- stage
waterfall, queue depth, shed/quarantine state, SLO burn -- by polling
the HTTP listener's /metrics + /healthz (docs/OBSERVABILITY.md).

No dependencies beyond the stdlib: Prometheus exposition is parsed
with a regex, the healthz payload is JSON.  Between polls the tool
differences the cumulative stage histograms, so the waterfall shows
the LAST interval's mean milliseconds per stage (and each stage's
share of the total as a bar), not the process-lifetime average.

A restarted sidecar resets every cumulative counter to zero; the tool
detects the backwards step, drops the stale baseline (the frame falls
back to lifetime means instead of printing garbage negative shares),
clamps the rate at 0, and flags the frame RESTARTED.

Run:  python -m automerge_tpu_torch.tools.amtpu_top \
          --url http://127.0.0.1:9464
      ... --url ... --once        # one frame (CI)
      ... --url ... --interval 2
      ... --fleet --url http://h1:9464 \
          --url http://h2:9464     # merged multi-replica view

Stdlib plus the port's telemetry/fleet.py (for --fleet); it reads a
server of either package.
"""

import argparse
import json
import re
import sys
import time
import urllib.request

STAGES = ('admit', 'queue', 'claim', 'dispatch', 'collect', 'emit',
          'fanout')
BAR_W = 28

_SAMPLE_RE = re.compile(
    r'^amtpu_request_stage_ms_(sum|count)\{stage="([a-z]+)"\}\s+(\S+)$')
_RUNTIME_RE = re.compile(
    r'^amtpu_runtime_counter\{name="([^"]+)"\}\s+(\S+)$')


def fetch(url, timeout):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def parse_metrics(text):
    """({stage: {'sum': ms, 'count': n}}, {runtime counter: value})."""
    stages = {}
    runtime = {}
    for line in text.splitlines():
        m = _SAMPLE_RE.match(line)
        if m:
            kind, stage, val = m.groups()
            stages.setdefault(stage, {})[kind] = float(val)
            continue
        m = _RUNTIME_RE.match(line)
        if m:
            runtime[m.group(1)] = float(m.group(2))
    return stages, runtime


def _bar(frac, width=BAR_W):
    n = max(0, min(width, int(round(frac * width))))
    return '#' * n + '.' * (width - n)


def _mb(n):
    try:
        return '%.1fMB' % (float(n) / 1048576.0)
    except (TypeError, ValueError):
        return '?'


def render_capacity(health, out):
    """The capacity panel: headroom bar, eviction pressure
    state, and the top-K hot docs by arena / disk / fanned bytes from
    the healthz `capacity` + `storage` sections."""
    cap = health.get('capacity') or {}
    if not cap or 'error' in cap:
        return
    sto = health.get('storage') or {}
    head = cap.get('headroom') or {}
    tot = cap.get('totals') or {}
    budget = head.get('budget_bytes') or 0
    used = head.get('used_bytes') or 0
    pressure = head.get('pressure') or 0.0
    out.append('')
    if budget:
        eta = head.get('exhaustion_s')
        # CURRENT pressure state, not the cumulative eviction counter
        # (which would stay lit forever after one eviction)
        evict_frac = head.get('pressure_evict') or 0
        hot_now = evict_frac > 0 and pressure >= evict_frac
        out.append('capacity: used %s / %s |%s| %5.1f%%  burn %s/s  '
                   'eta %s%s'
                   % (_mb(used), _mb(budget), _bar(min(1.0, pressure)),
                      100 * pressure, _mb(head.get('burn_bytes_s') or 0),
                      '%.0fs' % eta if eta is not None else '-',
                      '  PRESSURE' if hot_now else ''))
    else:
        out.append('capacity: used %s (no memory budget set)'
                   % _mb(used))
    out.append('  arena %s  clock %s  disk %s (%s cold docs)  fanned %s  '
               'egress %s  | evictions %s (%s freed, %s pressure)'
               % (_mb(tot.get('arena_bytes', 0)),
                  _mb(tot.get('clock_bytes', 0)),
                  _mb(tot.get('disk_bytes', 0)),
                  tot.get('cold_docs', 0),
                  _mb(tot.get('fanned_bytes', 0)),
                  _mb(tot.get('egress_bytes', 0)),
                  sto.get('evictions', 0),
                  _mb(sto.get('evicted_bytes', 0)),
                  sto.get('pressure_evictions', 0)))
    top = cap.get('top') or {}
    for tier, field in (('arena', 'arena_bytes'), ('clock', 'clock_bytes'),
                        ('disk', 'disk_bytes'),
                        ('fanned', 'fanned_bytes')):
        rows = top.get(tier) or []
        if not rows:
            continue
        cells = []
        for r in rows[:5]:
            cell = '%s=%s' % (r.get('doc'), _mb(r.get(field, 0)))
            if r.get('subscribers'):
                cell += '(%d subs)' % r['subscribers']
            cells.append(cell)
        out.append('  hot(%s): %s' % (tier, '  '.join(cells)))


def counters_reset(stages, prev_stages, runtime, prev_runtime):
    """True when any cumulative counter moved BACKWARDS since the last
    poll -- the server restarted (counters are monotone within one
    process lifetime).  The caller drops its stale baseline: keeping
    it would difference a fresh process against the dead one and
    render negative rates / garbage share bars."""
    for cur, prev in ((runtime, prev_runtime),):
        for k, v in (prev or {}).items():
            if cur.get(k, v) < v:
                return True
    for s, prev_kinds in (prev_stages or {}).items():
        cur_kinds = stages.get(s, {})
        for kind, v in prev_kinds.items():
            if cur_kinds.get(kind, v) < v:
                return True
    return False


def render(health, stages, prev_stages, runtime, prev_runtime,
           interval_s, restarted=False):
    out = []
    sched = health.get('scheduler') or {}
    slo = health.get('slo') or {}
    rec = health.get('recorder') or {}
    res = health.get('resilience') or {}
    reqs = runtime.get('slo.requests', 0.0)
    rate = max(0.0, (reqs - prev_runtime.get('slo.requests', reqs))
               / interval_s) if prev_runtime else 0.0
    out.append('amtpu-top  up %ss  conns %s  req/s %.1f  %s%s%s'
               % (health.get('uptime_s', '?'),
                  sched.get('connections', '?'), rate,
                  'RESTARTED  ' if restarted else '',
                  'SHEDDING  ' if sched.get('shedding') else '',
                  'DEGRADED' if health.get('degraded') else ''))
    out.append('queue: depth %s/%s ops  queued %s  pending docs %s  '
               'shed total %s'
               % (sched.get('depth_ops', '?'), sched.get('max_ops', '?'),
                  sched.get('queued', '?'),
                  sched.get('pending_docs', '?'),
                  int(runtime.get('scheduler.shed', 0))))
    out.append('')
    out.append('stage waterfall (last interval mean ms per request):')
    # interval deltas of the cumulative histograms.  The lifetime
    # fallback applies to the WHOLE frame (no attributed requests this
    # interval), never per stage -- mixing an interval total with a
    # lifetime stage mean would print shares past 100%
    deltas = {}
    tot = stages.get('total', {})
    tot_prev = (prev_stages or {}).get('total', {})
    frame_idle = prev_stages is None or \
        tot.get('count', 0.0) - tot_prev.get('count', 0.0) <= 0
    for s in STAGES + ('total',):
        cur = stages.get(s, {})
        prev = (prev_stages or {}).get(s, {})
        if frame_idle:
            dc, ds = cur.get('count', 0.0), cur.get('sum', 0.0)
        else:
            dc = max(0.0, cur.get('count', 0.0) - prev.get('count', 0.0))
            ds = max(0.0, cur.get('sum', 0.0) - prev.get('sum', 0.0))
        deltas[s] = (ds / dc if dc else 0.0, int(dc))
    total_ms = deltas.get('total', (0.0, 0))[0] or \
        sum(deltas[s][0] for s in STAGES if s != 'fanout')
    for s in STAGES:
        mean, n = deltas[s]
        share = mean / total_ms if total_ms else 0.0
        out.append('  %-9s %8.3f ms  |%s| %5.1f%%  n=%d'
                   % (s, mean, _bar(share), 100 * share, n))
    out.append('  %-9s %8.3f ms' % ('total', total_ms))
    out.append('')
    burn = (slo.get('burn') or {})
    out.append('slo: p99 target %s ms  slow %s ms  burn %s  '
               'breaches %d  exemplars %d'
               % (slo.get('target_p99_ms', '?'),
                  slo.get('slow_ms', '?'),
                  ' '.join('%s=%.2f' % kv
                           for kv in sorted(burn.items())),
                  int(runtime.get('slo.breaches', 0)),
                  int(runtime.get('slo.exemplars', 0))))
    for cls, wins in sorted((slo.get('classes') or {}).items()):
        parts = []
        for w in ('60s', '300s', '3600s'):
            d = wins.get(w) or {}
            parts.append('%s: n=%d p50=%.1f p99=%.1f'
                         % (w, d.get('count', 0), d.get('p50_ms', 0.0),
                            d.get('p99_ms', 0.0)))
        out.append('  %-8s %s' % (cls, '   '.join(parts)))
    out.append('')
    out.append('resilience: quarantined %d  retries %d  rollbacks %d  '
               '| recorder: %s/%s events  dumps %d'
               % (int(res.get('quarantined', 0)),
                  int(res.get('retry.attempts', 0)),
                  int(res.get('rollback', 0)),
                  rec.get('events', '?'), rec.get('size', '?'),
                  int(runtime.get('recorder.dumps', 0))))
    render_capacity(health, out)
    return '\n'.join(out)


def _fleet_loop(args):
    """--fleet mode: scrape EVERY --url replica and render the merged
    fleet view (summed SLO slots recomputed through the per-replica
    code path, headroom skew table) via telemetry/fleet.py."""
    from ..telemetry import fleet
    from .amtpu_fleet import render as fleet_render
    while True:
        scrapes, section = fleet.scrape_fleet(
            [u.rstrip('/') for u in args.url], timeout=args.timeout)
        if args.once:
            fleet_render(scrapes, section)
            return 1 if section['errors'] else 0
        sys.stdout.write('\x1b[2J\x1b[H')
        fleet_render(scrapes, section)
        sys.stdout.flush()
        time.sleep(args.interval)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--url', action='append', required=True,
                    help='base URL of the sidecar metrics listener, '
                         'e.g. http://127.0.0.1:9464 (repeat with '
                         '--fleet for a multi-replica view)')
    ap.add_argument('--interval', type=float, default=2.0)
    ap.add_argument('--once', action='store_true',
                    help='print one frame and exit (no screen clears; '
                         'the obs-check CI mode)')
    ap.add_argument('--timeout', type=float, default=10.0)
    ap.add_argument('--fleet', action='store_true',
                    help='aggregate ALL --url replicas into one '
                         'merged view (telemetry/fleet.py)')
    args = ap.parse_args(argv)
    if args.fleet:
        return _fleet_loop(args)
    if len(args.url) > 1:
        ap.error('multiple --url endpoints require --fleet')
    base = args.url[0].rstrip('/')
    prev_stages = prev_runtime = None
    while True:
        try:
            health = json.loads(fetch(base + '/healthz', args.timeout))
            stages, runtime = parse_metrics(
                fetch(base + '/metrics', args.timeout))
        except (OSError, ValueError) as e:
            print('amtpu-top: poll failed: %s' % e, file=sys.stderr)
            if args.once:
                return 1
            time.sleep(args.interval)
            continue
        restarted = counters_reset(stages, prev_stages, runtime,
                                   prev_runtime)
        if restarted:
            # the dead process's counters are not a baseline for the
            # fresh one: fall back to lifetime means for this frame
            prev_stages = prev_runtime = None
        frame = render(health, stages, prev_stages, runtime,
                       prev_runtime, args.interval,
                       restarted=restarted)
        if args.once:
            print(frame)
            return 0
        sys.stdout.write('\x1b[2J\x1b[H' + frame + '\n')
        sys.stdout.flush()
        prev_stages, prev_runtime = stages, runtime
        time.sleep(args.interval)


if __name__ == '__main__':
    sys.exit(main())
