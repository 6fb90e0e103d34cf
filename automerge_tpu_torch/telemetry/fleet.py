"""Fleet aggregation plane: scrape N replicas' observability
endpoints and merge them into ONE coherent view
(docs/OBSERVABILITY.md fleet section).

The per-replica SLO surface (telemetry/attribution.py) keeps raw
10-second window slots -- per-class latency bucket counts + totals +
breach counts -- precisely so a fleet can aggregate them CORRECTLY:
slots from different replicas sum element-wise, and the merged
percentiles/burn recompute from the summed counts via the same pure
function (`attribution.section_from_slots`) each replica's own healthz
uses.  Averaging per-replica p99s would be statistically meaningless;
summing slots makes the fleet merge bit-identical to what a single
replica would report had it served all the traffic.

Scraping uses only stdlib HTTP (`/healthz` + `/debug/slo_slots` per
replica, telemetry/httpd.py); a dead replica degrades to an error row,
never the whole fleet view.  ``python -m
automerge_tpu_torch.tools.amtpu_fleet`` is the CLI; ``amtpu_top
--fleet`` renders the same sections live.  The sections are the JAX
package's, key for key (`tests/test_torch_fleet.py`).
"""

import json
import urllib.request

from .attribution import section_from_slots


def metric(name, v=1):
    """Late-bound forwarder to the package counter (mirrors
    telemetry/recorder.py; the static telemetry-key checker keys on
    `metric(...)` call sites)."""
    from . import metric as _m
    _m(name, v)


def _get_json(url, timeout):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def scrape(base_url, timeout=2.0):
    """One replica's observability snapshot: ``/healthz`` plus the raw
    mergeable SLO slots from ``/debug/slo_slots``.  Returns
    ``{'url', 'replica_id', 'uptime_s', 'healthz', 'slots'}`` -- or a
    degraded ``{'url', 'error'}`` row when the replica is unreachable
    (counted in ``fleet.scrape_errors``; the caller keeps aggregating
    the survivors)."""
    url = base_url.rstrip('/')
    try:
        health = _get_json(url + '/healthz', timeout)
        slots = _get_json(url + '/debug/slo_slots', timeout)
        metric('fleet.scrapes')
        return {'url': url,
                'replica_id': slots.get('replica_id')
                or health.get('replica_id') or url,
                'uptime_s': slots.get('uptime_s',
                                      health.get('uptime_s')),
                'healthz': health,
                'slots': slots.get('slots') or {}}
    except Exception as e:
        metric('fleet.scrape_errors')
        return {'url': url,
                'error': '%s: %s' % (type(e).__name__, e)}


def merge_slots(slots_by_replica):
    """Element-wise sum of per-class SLO window slots across replicas:
    ``[{cls: {slot: [bucket_counts, total, breaches]}}, ...]`` -> one
    merged map of the same shape.  Slot keys arrive as JSON strings
    from the wire and ints from in-process snapshots; both normalize
    to int so the cutoff arithmetic in `section_from_slots` holds."""
    merged = {}
    for slots_by_class in slots_by_replica:
        for cls, slots in (slots_by_class or {}).items():
            dst = merged.setdefault(cls, {})
            for slot, entry in slots.items():
                counts, total, breaches = entry[0], entry[1], entry[2]
                key = int(slot)
                cur = dst.get(key)
                if cur is None:
                    dst[key] = [list(counts), int(total),
                                int(breaches)]
                    continue
                if len(counts) > len(cur[0]):
                    cur[0].extend([0] * (len(counts) - len(cur[0])))
                for i, c in enumerate(counts):
                    cur[0][i] += c
                cur[1] += int(total)
                cur[2] += int(breaches)
    return merged


def fleet_slo_section(scrapes, now_slot=None):
    """The merged fleet SLO section: sum the live replicas' slots, then
    recompute percentiles/burn through the SAME pure function each
    replica's healthz uses -- merged-equals-recompute by construction."""
    merged = merge_slots([s.get('slots') for s in scrapes
                          if 'error' not in s])
    return section_from_slots(merged, now_slot=now_slot)


def fleet_headroom(scrapes):
    """Capacity/headroom across the fleet: per-replica rows (the skew
    table -- one hot replica hides inside a healthy fleet average) plus
    the aggregate used/budget and the max-min pressure skew."""
    rows = []
    used_sum = budget_sum = 0
    pressures = []
    for s in scrapes:
        if 'error' in s:
            continue
        cap = (s.get('healthz') or {}).get('capacity') or {}
        hr = cap.get('headroom') or {}
        totals = cap.get('totals') or {}
        row = {'replica_id': s.get('replica_id'),
               'uptime_s': s.get('uptime_s'),
               'used_bytes': hr.get('used_bytes'),
               'budget_bytes': hr.get('budget_bytes'),
               'pressure': hr.get('pressure'),
               'exhaustion_s': hr.get('exhaustion_s'),
               'arena_bytes': totals.get('arena_bytes'),
               'egress_bytes': totals.get('egress_bytes')}
        rows.append(row)
        used_sum += int(hr.get('used_bytes') or 0)
        budget_sum += int(hr.get('budget_bytes') or 0)
        if isinstance(hr.get('pressure'), (int, float)):
            pressures.append(float(hr['pressure']))
    out = {'replicas': rows,
           'used_bytes': used_sum,
           'budget_bytes': budget_sum,
           'pressure': round(used_sum / budget_sum, 4)
           if budget_sum > 0 else 0.0}
    out['pressure_skew'] = round(max(pressures) - min(pressures), 4) \
        if pressures else 0.0
    return out


def fleet_routing(scrapes):
    """Doc-placement view across the fleet: one row per
    member that serves a ``routing`` healthz section (replicas report
    owned/disowned docs and migration counters; a router reports ring
    membership and live migrations), plus a ring-version consistency
    verdict -- during a rebalance the versions legitimately diverge,
    and ``consistent`` flips back once every member has seen the
    latest placement."""
    rows, versions = [], []
    for s in scrapes:
        if 'error' in s:
            continue
        rt = (s.get('healthz') or {}).get('routing')
        if not isinstance(rt, dict):
            continue
        row = {'replica_id': rt.get('replica_id') or s.get('replica_id'),
               'role': rt.get('role', 'replica'),
               'ring_version': rt.get('ring_version')}
        for k in ('owned_docs', 'disowned_docs', 'migrations_in',
                  'migrations_out', 'members', 'overrides',
                  'migrating_docs'):
            if k in rt:
                row[k] = rt[k]
        rows.append(row)
        if isinstance(rt.get('ring_version'), int):
            versions.append(rt['ring_version'])
    return {'members': rows,
            'ring_version_min': min(versions) if versions else None,
            'ring_version_max': max(versions) if versions else None,
            'consistent': len(set(versions)) <= 1}


def fleet_health(scrapes):
    """Member liveness across the fleet: the router's
    healthz ``fleet_health`` section (per-member up/suspect/dead/
    quarantined state from the heartbeat monitor + current park
    budget) merged across whichever scraped processes serve one --
    normally just the router; rows from several routers union."""
    members = {}
    park = {'parked_docs': 0, 'parked_bytes': 0}
    seen = False
    for s in scrapes:
        if 'error' in s:
            continue
        fh = (s.get('healthz') or {}).get('fleet_health')
        if not isinstance(fh, dict):
            continue
        seen = True
        members.update(fh.get('members') or {})
        park['parked_docs'] += int(fh.get('parked_docs') or 0)
        park['parked_bytes'] += int(fh.get('parked_bytes') or 0)
    if not seen:
        return None
    states = [m.get('state') for m in members.values()]
    out = {'members': members,
           'up': states.count('up'),
           'suspect': states.count('suspect'),
           'dead': states.count('dead'),
           'quarantined': states.count('quarantined')}
    out.update(park)
    return out


def fleet_section(scrapes, now_slot=None):
    """The whole fleet view from a list of `scrape()` results: replica
    roll-call (live/error rows), the merged SLO section, the headroom
    table, the routing/placement table, and (when a router is in the
    scrape set) the member-liveness table.  Pure given its inputs --
    tests and the obs-check gate recompute it from captured scrapes."""
    errors = [{'url': s['url'], 'error': s['error']}
              for s in scrapes if 'error' in s]
    live = [s for s in scrapes if 'error' not in s]
    out = {'replicas': [{'replica_id': s.get('replica_id'),
                         'url': s['url'],
                         'uptime_s': s.get('uptime_s')}
                        for s in live],
           'errors': errors,
           'slo': fleet_slo_section(scrapes, now_slot=now_slot),
           'headroom': fleet_headroom(scrapes),
           'routing': fleet_routing(scrapes)}
    health = fleet_health(scrapes)
    if health is not None:
        out['health'] = health
    return out


def scrape_fleet(urls, timeout=2.0):
    """Scrape every url and assemble the fleet section; the one-call
    surface `amtpu_fleet --once` and `amtpu_top --fleet` use."""
    scrapes = [scrape(u, timeout=timeout) for u in urls]
    return scrapes, fleet_section(scrapes)
