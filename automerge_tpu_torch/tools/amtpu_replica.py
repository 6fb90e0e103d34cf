"""Run a materialized read replica of the port (docs/SERVING.md).

    python -m automerge_tpu_torch.tools.amtpu_replica \
        --upstream /run/amtpu/gw.sock --listen /run/amtpu/read0.sock \
        --store /var/lib/amtpu/cold --prefix doc/ [--device cpu]

Consumes the upstream gateway's fan-out stream into a local pool and
serves reads (`get_patch`, `snapshot`, `healthz`, ...) on `--listen`
as a read-only gateway; mutations answer a typed ``ReadOnly`` error.
With `--store` the pool bootstraps arena-direct from the ColdStore
manifest before subscribing, so upstream only backfills the tail.  The
pool runs on the card unless `--device cpu` is given; with no CUDA
device and no `--device cpu` the replica exits 2.

Staleness SLO: every `--probe-s` seconds (`replica.READ_RESYNC_S`) the
replica probes the upstream frontier per doc; a doc behind for longer
than `--slo-s` (`replica.READ_STALENESS_SLO_S`) is force-caught-up via
one ``get_missing_changes`` walk.  `--status-interval N` prints the
healthz ``readview`` section as a JSON line every N seconds.
"""

import argparse
import json
import signal
import sys
import time


def main(argv=None):
    from ..readview.replica import ReadReplica
    ap = argparse.ArgumentParser(
        description='materialized read replica over one gateway')
    ap.add_argument('--upstream', required=True,
                    help='authoritative gateway unix socket path')
    ap.add_argument('--listen', required=True,
                    help='unix socket path this replica serves reads on')
    ap.add_argument('--doc', action='append', default=[],
                    help='doc id to follow (repeatable)')
    ap.add_argument('--prefix',
                    help='follow every doc under this id prefix')
    ap.add_argument('--store',
                    help='ColdStore root to bootstrap the pool from')
    ap.add_argument('--peer', default='replica',
                    help='peer name for the upstream subscription')
    ap.add_argument('--msgpack', action='store_true',
                    help='msgpack framing on both sockets')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='where the replica\'s pool runs: the card '
                         '(default; exits 2 when there is no CUDA '
                         'device) or the plain PyTorch versions on the '
                         'CPU')
    ap.add_argument('--slo-s', type=float, default=None,
                    help='staleness SLO in seconds before a forced '
                         'catch-up')
    ap.add_argument('--probe-s', type=float, default=None,
                    help='seconds between staleness probes')
    ap.add_argument('--status-interval', type=float, default=0.0,
                    help='print the readview healthz section as JSON '
                         'every N seconds (0: quiet)')
    args = ap.parse_args(argv)
    if not args.doc and args.prefix is None and not args.store:
        ap.error('nothing to follow: pass --doc/--prefix/--store')
    replica = ReadReplica(args.upstream, args.listen, docs=args.doc,
                          prefix=args.prefix, store_dir=args.store,
                          peer=args.peer, use_msgpack=args.msgpack,
                          slo_s=args.slo_s, probe_s=args.probe_s,
                          device=args.device)
    try:
        replica.start()
    except RuntimeError as e:
        # no card (and no --device cpu), or the kernels did not build:
        # never a silent move to the CPU
        print('replica: %s' % e, file=sys.stderr)
        replica.stop()
        return 2
    print('replica: serving reads on %s (upstream %s)'
          % (args.listen, args.upstream), file=sys.stderr)
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    try:
        last = time.monotonic()
        while not stop:
            time.sleep(0.2)
            if args.status_interval and \
                    time.monotonic() - last >= args.status_interval:
                last = time.monotonic()
                print(json.dumps({'readview':
                                  replica.healthz_section()}))
                sys.stdout.flush()
    finally:
        replica.stop()
    return 0


if __name__ == '__main__':
    sys.exit(main())
