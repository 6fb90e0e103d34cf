"""Fleet observability CLI: scrape N replicas' /healthz +
/debug/slo_slots endpoints and print ONE merged view -- per-class SLO
windows recomputed from summed slots (never averaged percentiles),
error-budget burn, and a per-replica headroom/skew table
(automerge_tpu_torch/telemetry/fleet.py).  Stdlib plus that module.

Usage:
  python -m automerge_tpu_torch.tools.amtpu_fleet \
      --url http://h1:9100 --url http://h2:9100 --once
  ... --url ... --interval 5        # refresh loop
  ... --url ... --once --json       # machine-readable
"""

import argparse
import json
import sys
import time


def _fmt_mb(n):
    if n is None:
        return '-'
    return '%.1fMB' % (n / (1024.0 * 1024.0))


def render(scrapes, section, out=sys.stdout):
    w = out.write
    w('amtpu fleet: %d replicas up, %d unreachable\n'
      % (len(section['replicas']), len(section['errors'])))
    for r in section['replicas']:
        w('  up   %-24s %s  uptime %ss\n'
          % (r.get('replica_id'), r['url'], r.get('uptime_s')))
    for e in section['errors']:
        w('  DOWN %-24s %s\n' % (e['url'], e['error']))
    slo = section['slo']
    w('slo (merged windows; target p99 %dms, slow %dms)\n'
      % (slo['target_p99_ms'], slo['slow_ms']))
    for cls, windows in sorted(slo['classes'].items()):
        for win, row in sorted(windows.items(),
                               key=lambda kv: int(kv[0][:-1])):
            w('  %-10s %-5s n=%-7d p50=%-8s p99=%-8s breach=%s\n'
              % (cls, win, row['count'],
                 row['p50_ms'] if row['p50_ms'] is not None else '-',
                 row['p99_ms'] if row['p99_ms'] is not None else '-',
                 row['breach_frac']))
    w('burn (merged): %s\n' % slo['burn'])
    hr = section['headroom']
    w('headroom: used %s / budget %s  pressure %.3f  skew %.3f\n'
      % (_fmt_mb(hr['used_bytes']),
         _fmt_mb(hr['budget_bytes']) if hr['budget_bytes'] else '(none)',
         hr['pressure'], hr['pressure_skew']))
    for r in hr['replicas']:
        w('  %-24s used %-9s pressure %-6s exhaustion %s\n'
          % (r.get('replica_id'), _fmt_mb(r.get('used_bytes')),
             r.get('pressure') if r.get('pressure') is not None else '-',
             '%ss' % r['exhaustion_s']
             if r.get('exhaustion_s') is not None else '-'))
    rt = section.get('routing') or {}
    if rt.get('members'):
        w('routing: ring v%s..v%s  %s\n'
          % (rt.get('ring_version_min'), rt.get('ring_version_max'),
             'consistent' if rt.get('consistent')
             else 'CONVERGING (rebalance in flight)'))
        for m in rt['members']:
            if m.get('role') == 'router':
                w('  %-24s router  ring v%-4s members=%s overrides=%s'
                  ' migrating=%s\n'
                  % (m.get('replica_id'), m.get('ring_version'),
                     len(m.get('members') or ()), m.get('overrides'),
                     m.get('migrating_docs')))
            else:
                w('  %-24s replica ring v%-4s owned=%-6s disowned=%-4s'
                  ' mig in/out=%s/%s\n'
                  % (m.get('replica_id'), m.get('ring_version'),
                     m.get('owned_docs'), m.get('disowned_docs'),
                     m.get('migrations_in'), m.get('migrations_out')))
    fh = section.get('health')
    if fh:
        w('health: %d up / %d suspect / %d dead / %d quarantined'
          '  parked %d docs (%s)\n'
          % (fh['up'], fh['suspect'], fh['dead'], fh['quarantined'],
             fh['parked_docs'], _fmt_mb(fh['parked_bytes'])))
        for m, st in sorted(fh['members'].items()):
            if st.get('state') != 'up':
                w('  %-24s %-11s misses=%-3s for %ss\n'
                  % (m, st.get('state'), st.get('misses'),
                     st.get('for_s')))


def main(argv=None):
    from ..telemetry import fleet
    ap = argparse.ArgumentParser(
        description='merged multi-replica amtpu observability view')
    ap.add_argument('--url', action='append', required=True,
                    help='replica metrics base url (repeatable)')
    ap.add_argument('--once', action='store_true',
                    help='scrape once, print, exit non-zero if any '
                         'replica was unreachable')
    ap.add_argument('--interval', type=float, default=5.0)
    ap.add_argument('--json', action='store_true',
                    help='print the fleet section as JSON')
    ap.add_argument('--timeout', type=float, default=2.0)
    args = ap.parse_args(argv)
    while True:
        scrapes, section = fleet.scrape_fleet(args.url,
                                              timeout=args.timeout)
        if args.json:
            print(json.dumps(section, default=str))
        else:
            if not args.once:
                sys.stdout.write('\x1b[2J\x1b[H')
            render(scrapes, section)
        if args.once:
            return 1 if section['errors'] else 0
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == '__main__':
    sys.exit(main())
