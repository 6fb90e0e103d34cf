"""Cross-process trace assembly: merge the per-process JSONL trace
files (a port server's ``--trace-file``, ``telemetry.spans.TRACE_FILE``,
or the JAX package's ``AMTPU_TRACE_FILE``) of a client + N servers into
per-request trace trees, normalize per-process clock skew, and render a
waterfall with the critical-path hop flagged (docs/OBSERVABILITY.md
distributed-tracing section).  Stdlib only.

Each process exports only its OWN spans; what joins them is the wire
trace context (``{"trace": {"traceId", "spanId"}}``) the client stamps
on every request: the server's ``sidecar.request`` span names the
client's span as its parent, so the cross-process edge is an ordinary
parent link that happens to resolve in another file.  Rotated
siblings (``<path>.1``) load automatically.

Clock skew: span ``start`` stamps come from each process's own
``time.time()``.  For every cross-process parent->child edge we know
the child started AFTER the parent (the request had to cross the
wire), so ``min(child.start - parent.start)`` over a process pair's
edges bounds that process's clock offset (tightest when the fastest
request's wire time ~ 0).  Offsets propagate from the root process
(offset 0) across the edge graph; every rendered start is
offset-corrected.  With one edge the estimate absorbs that request's
wire time -- good enough to order hops, not to measure sub-wire
intervals.

Usage (``python -m automerge_tpu_torch.tools.amtpu_trace``):
  amtpu_trace FILE [FILE...]           # list assembled traces
  amtpu_trace --trace ID FILE...       # waterfall one trace
  amtpu_trace --json FILE...           # machine-readable summaries
"""

import argparse
import json
import os
import sys


def load_files(paths):
    """All span records from `paths` (plus their ``.1`` rotation
    siblings), each tagged with ``_proc`` = the file it came from --
    the clock-skew domain.  Lines that are not span-shaped JSON (e.g.
    a torn tail line) are skipped, not fatal."""
    records = []
    for path in paths:
        for p in (path + '.1', path):
            if not os.path.exists(p):
                continue
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if not isinstance(rec, dict) \
                            or 'trace' not in rec or 'span' not in rec \
                            or 'start' not in rec:
                        continue
                    rec['_proc'] = path
                    records.append(rec)
    return records


def group_traces(records):
    """{trace_id: [records]} preserving file order within a trace."""
    traces = {}
    for rec in records:
        traces.setdefault(rec['trace'], []).append(rec)
    return traces


def estimate_offsets(nodes):
    """{proc: clock offset seconds} for one trace's nodes, relative to
    the root span's process (offset 0).  Edge estimate per ordered
    process pair (P -> Q): ``min(child.start - parent.start)`` over the
    cross-process parent/child pairs; offsets propagate breadth-first
    over the pair graph.  Processes unreachable from the root's (no
    cross edge at all) keep offset 0."""
    by_span = {n['span']: n for n in nodes}
    edges = {}      # (parent_proc, child_proc) -> min delta
    for n in nodes:
        parent = by_span.get(n.get('parent'))
        if parent is None or parent['_proc'] == n['_proc']:
            continue
        key = (parent['_proc'], n['_proc'])
        delta = n['start'] - parent['start']
        if key not in edges or delta < edges[key]:
            edges[key] = delta
    roots = [n for n in nodes if n.get('parent') not in by_span]
    root_proc = roots[0]['_proc'] if roots else nodes[0]['_proc']
    offsets = {root_proc: 0.0}
    frontier = [root_proc]
    while frontier:
        cur = frontier.pop()
        for (pp, cp), delta in edges.items():
            if pp == cur and cp not in offsets:
                offsets[cp] = offsets[cur] + delta
                frontier.append(cp)
            elif cp == cur and pp not in offsets:
                offsets[pp] = offsets[cur] - delta
                frontier.append(pp)
    for n in nodes:
        offsets.setdefault(n['_proc'], 0.0)
    return offsets


def build_tree(nodes):
    """Skew-normalize and link one trace's nodes: each gains
    ``start_n`` (offset-corrected start) and ``children`` (sorted by
    normalized start); returns the roots (parent unknown), earliest
    first."""
    offsets = estimate_offsets(nodes)
    by_span = {}
    for n in nodes:
        n = dict(n)
        n['start_n'] = n['start'] - offsets[n['_proc']]
        n['children'] = []
        by_span[n['span']] = n
    roots = []
    for n in by_span.values():
        parent = by_span.get(n.get('parent'))
        if parent is not None:
            parent['children'].append(n)
        else:
            roots.append(n)
    for n in by_span.values():
        n['children'].sort(key=lambda c: c['start_n'])
    roots.sort(key=lambda r: r['start_n'])
    return roots


def critical_path(root):
    """Span ids of the longest-duration child chain from `root` -- the
    hop to look at first when the request was slow."""
    path = set()
    node = root
    while node is not None:
        path.add(node['span'])
        node = max(node['children'], key=lambda c: c.get('dur_s', 0.0),
                   default=None)
    return path


def summarize(trace_id, nodes):
    """One trace's gate-facing numbers: the client wall (root
    ``sidecar.client.request`` span), the summed server request time
    under it, and the residual wire+overhead share -- what the
    obs-check two-process arm asserts a budget on."""
    roots = build_tree(nodes)
    procs = sorted({n['_proc'] for n in nodes})
    out = {'trace': trace_id, 'spans': len(nodes), 'procs': len(procs),
           'proc_files': procs,
           'roots': [r['name'] for r in roots]}
    client = next((r for r in roots
                   if r['name'] == 'sidecar.client.request'), None)
    if client is not None:
        server_s = sum(n.get('dur_s', 0.0) for n in nodes
                       if n['name'] == 'sidecar.request')
        wall = client.get('dur_s', 0.0)
        out['client_wall_s'] = round(wall, 9)
        out['server_s'] = round(server_s, 9)
        out['wire_s'] = round(max(0.0, wall - server_s), 9)
        out['cmd'] = (client.get('attrs') or {}).get('cmd')
    return out


def render_waterfall(trace_id, nodes, out=sys.stdout):
    roots = build_tree(nodes)
    if not roots:
        return
    t0 = roots[0]['start_n']
    crit = set()
    for r in roots:
        crit |= critical_path(r)
    procs = sorted({n['_proc'] for n in nodes})
    out.write('trace %s  (%d spans, %d process files)\n'
              % (trace_id, len(nodes), len(procs)))
    for i, p in enumerate(procs):
        out.write('  proc[%d] %s\n' % (i, p))
    pidx = {p: i for i, p in enumerate(procs)}

    def walk(node, depth):
        mark = '*' if node['span'] in crit else ' '
        out.write('%s %8.3fms %9.3fms  p%d %s%s\n'
                  % (mark, (node['start_n'] - t0) * 1e3,
                     node.get('dur_s', 0.0) * 1e3,
                     pidx[node['_proc']],
                     '  ' * depth, node['name']))
        for c in node['children']:
            walk(c, depth + 1)

    out.write('    start      duration  proc  span '
              '(* = critical path)\n')
    for r in roots:
        walk(r, 0)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='assemble cross-process amtpu trace trees')
    ap.add_argument('files', nargs='+',
                    help='per-process trace file paths '
                         '(.1 rotations load automatically)')
    ap.add_argument('--trace', help='render one trace id as a '
                                    'waterfall')
    ap.add_argument('--json', action='store_true',
                    help='print per-trace summaries as JSON lines')
    args = ap.parse_args(argv)
    traces = group_traces(load_files(args.files))
    if args.trace:
        nodes = traces.get(args.trace)
        if not nodes:
            print('trace %r not found' % args.trace, file=sys.stderr)
            return 1
        render_waterfall(args.trace, nodes)
        return 0
    summaries = [summarize(tid, nodes)
                 for tid, nodes in traces.items()]
    summaries.sort(key=lambda s: -s.get('client_wall_s', 0.0))
    if args.json:
        for s in summaries:
            print(json.dumps(s))
        return 0
    print('%d traces from %d files' % (len(summaries),
                                       len(args.files)))
    for s in summaries:
        wall = s.get('client_wall_s')
        print('  %s  spans=%-3d procs=%d  %s%s'
              % (s['trace'], s['spans'], s['procs'],
                 ('wall=%.3fms wire=%.3fms '
                  % (wall * 1e3, s['wire_s'] * 1e3))
                 if wall is not None else '',
                 s.get('cmd') or '/'.join(s['roots'])))
    return 0


if __name__ == '__main__':
    sys.exit(main())
