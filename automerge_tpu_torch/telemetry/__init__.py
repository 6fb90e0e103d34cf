"""automerge_tpu_torch.telemetry -- the observability layer.

Replaces the flat `trace.py` occupancy counter with three composable
pieces, threaded through every layer of the stack (frontend -> sidecar
-> pool -> kernels -> sync):

  * a metric REGISTRY (`registry`): counters, gauges, log-bucketed
    histograms; thread-safe; near-zero-cost when idle.  The standard
    families below fire per batch / per sidecar request, never per op.
  * structured SPANS (`span`, `span_with_context`): request/batch-scoped
    timing carrying a trace id and attributes, propagated across the
    sidecar process boundary, exportable as JSONL
    (`spans.TRACE_FILE`).  Spans are opt-in: `enable()` / `disable()`
    at runtime.
  * PROMETHEUS exposition (`render_prometheus`): the registry plus
    families derived from the span occupancy table and the always-on
    flat metric map, served by the sidecar's `metrics` request type and
    the optional HTTP listener (`httpd.start_metrics_server`).

The always-on flat map (`metric` / `metrics_snapshot`) is kept verbatim
from trace.py: the handful of numbers every bench line must report
unconditionally -- oracle-fallback and degradation counters, kernel
launch counts.  Incremented once per BATCH, never per op.  Counts stay
ints (`trace.snapshot()` and the launch counts read them as such).

`automerge_tpu_torch.trace` is a shim over this module: `trace.metric`
writes the same flat map, and its always-on span table feeds the phase
occupancy table here while tracing is enabled.

Metric catalog: docs/OBSERVABILITY.md.
"""

import threading
import time
import os
import socket

from .metrics import (DEFAULT_BUCKETS, MetricRegistry,  # noqa: F401
                      format_value)
from .spans import (NULL_SPAN, current_span,  # noqa: F401
                    current_trace_context, disable, enable, enabled,
                    new_id, new_root_context, new_trace_id,
                    open_range, close_range, phase_add,
                    phase_count, phase_report, phase_reset,
                    phase_snapshot, set_trace_file, span,
                    span_with_context, trace_file)

_START_TIME = time.time()

#: this replica's name in healthz ('' = <hostname>:<pid>; the JAX
#: package's AMTPU_REPLICA_ID)
REPLICA_ID = ''
#: seconds a quarantine keeps healthz `degraded` true
#: (AMTPU_DEGRADED_WINDOW_S)
DEGRADED_WINDOW_S = 300.0
#: per-dispatch device timing (the JAX package's AMTPU_DEVTIME): the
#: pool brackets each dispatch with CUDA events on a card (the host clock
#: on a CPU pool) and waits for the end, feeding the device-seconds
#: families; off, they read 0
DEVTIME = False
#: the supervising client's respawn count, set by the server's
#: `--restarts` flag (the JAX package passes AMTPU_SIDECAR_RESTARTS)
RESTARTS = 0


def uptime_s():
    """Seconds since this process imported telemetry -- the per-replica
    uptime healthz and /debug/slo_slots report (fleet skew tables key
    on it to spot the freshly-restarted replica)."""
    return time.time() - _START_TIME


_replica_id_cached = None


def replica_id():
    """A stable identity for THIS replica, latched at first use:
    ``REPLICA_ID`` when set (a fleet operator names replicas),
    else ``<hostname>:<pid>`` -- unique per process, stable for its
    lifetime, and debuggable at a glance.  Carried by healthz and
    ``/debug/slo_slots`` so the fleet plane (telemetry/fleet.py) can
    attribute merged windows and headroom skew per replica."""
    global _replica_id_cached
    if _replica_id_cached is None:
        _replica_id_cached = REPLICA_ID \
            or '%s:%d' % (socket.gethostname(), os.getpid())
    return _replica_id_cached

registry = MetricRegistry()

# -- standard families (the catalog's core; docs/OBSERVABILITY.md) ----------

BATCHES = registry.counter(
    'amtpu_batches_total', 'Batches applied, by pool entry point',
    ('pool',))
BATCH_LATENCY = registry.histogram(
    'amtpu_batch_latency_seconds',
    'Wall-clock latency of one apply-batch pass, by pool entry point',
    ('pool',))
OPS = registry.counter(
    'amtpu_ops_total', 'Operations counted on committed batches only '
    '(engine path: exact causally-applied ops; dict-level native path: '
    'submitted ops incl. duplicates/queued -- the bytes path cannot '
    'count without a decode it avoids)')
DOCS = registry.counter(
    'amtpu_docs_total', 'Documents touched by committed batches')
SIDECAR_REQS = registry.counter(
    'amtpu_sidecar_requests_total', 'Sidecar protocol requests served',
    ('cmd', 'outcome'))
SIDECAR_LATENCY = registry.histogram(
    'amtpu_sidecar_request_seconds', 'Sidecar request service time',
    ('cmd',))
SYNC_MSGS = registry.counter(
    'amtpu_sync_messages_total', 'Connection sync messages processed',
    ('direction',))
SIDECAR_INTERNAL = registry.counter(
    'amtpu_sidecar_internal_errors_total',
    'Unexpected exceptions the sidecar dispatch answered as the '
    'InternalError envelope (the serve loop survived them)')

# The key sets below are the JAX package's, pre-seeded alike so that
# both packages' healthz and bench blocks carry one key set.  Where a
# glossary names an AMTPU_* knob, it is the JAX package's, for a layer
# or switch the port has no counterpart for yet (mesh, fleet router,
# read replicas, the packed-epilogue switch).
#
# fallback reasons pre-seeded into the exposition AND every bench_block
# so dashboards/gates see explicit zeros before the first degradation
# (the same names trace.metric('fallback.<reason>') call sites emit).
# 'oracle' counts register rows that actually reached the host oracle
# after the escalation ladder; 'escalated.wN' counts rows resolved on
# device by the W=N tier (make fallback-check asserts oracle == 0 with
# the tier counters present).
KNOWN_FALLBACK_REASONS = ('layout_batches', 'overflow_batches',
                          # static-ok: telemetry-key -- the port's sliding
                          # window covers the widest group, so its fused
                          # path flags no row (analysis/glossary.md)
                          'overflow_rows',
                          'member_overflow_rows',
                          'oracle', 'escalated.w16', 'escalated.w32',
                          'escalated.w64')

# collect-path counters (`trace.metric('collect.<name>')` call sites),
# pre-seeded into every bench_block so gates can assert explicit zeros:
# packed_member_batches  -- member-mode batches served by the packed
#                           epilogue (ONE i32/row + sparse conflicts)
# full_matrix_readback   -- batches that read back the full
#                           winner/conflicts/alive/overflow matrices
#                           (AMTPU_PACKED_EPILOGUE=0, Tp >= 2^24, or the
#                           kernel-overflow fused fallback)
# conflict_sparse/dense  -- which side of the native.CONF_DENSE_THRESH
#                           switch each conflicts fetch took
# ready_reorder          -- pipelined phase-b picks served out of
#                           submission order because their device
#                           outputs resolved first
# wait_in_order          -- rounds where nothing was ready and collect
#                           blocked on the oldest submission
KNOWN_COLLECT_KEYS = ('packed_member_batches', 'full_matrix_readback',
                      'conflict_sparse', 'conflict_dense',
                      'ready_reorder', 'wait_in_order',
                      'device_merge_chunks', 'overlap_s')

# pool-resident batch state (glossary: docs/OBSERVABILITY.md),
# pre-seeded so the perf-smoke resident gate reads zeros -- not
# missing keys -- when the cache is disabled or cold
KNOWN_RESIDENT_BATCH_KEYS = ('batch_hits', 'batch_noop',
                             'batch_full_uploads',
                             'batch_full_upload_rows',
                             'batch_delta_rows', 'batch_hit_rows',
                             'batch_gen_invalidation',
                             'batch_grow_uploads',
                             'batch_cache_dropped',
                             # static-ok: telemetry-key -- the port has
                             # no env latches (analysis/glossary.md)
                             'latch_flip_ignored',
                             'dispatches')

# cross-batch wave pipelining, pre-seeded so bench
# artifacts distinguish "never engaged" (explicit zeros) from "not
# recorded": batches that took the wave path / total doc-disjoint waves
KNOWN_PIPELINE_KEYS = ('batches', 'waves', 'serial_replay')

# mesh execution mode (`trace.metric('mesh.<name>')` call
# sites in native/mesh_pool.py + the sp fence in native/resident.py;
# glossary: docs/OBSERVABILITY.md), pre-seeded into every bench_block
# so a MULTICHIP line always carries the full mesh story:
# batches / shards        mesh-driven batches and the dp chips that
#                           carried payload across them
# chip_docs               docs placed on chips (sum; / shards = mean
#                           per-chip occupancy)
# occupancy_skew          per-batch max-min docs across chips (FNV
#                           routing imbalance)
# encode_shard_skew_s     per-batch max-min of the chips' threaded
#                           phase-a (host decode/begin+dispatch) walls
# collective_wait_s       time a collector blocked on a chip whose
#                           device outputs had not resolved (nothing
#                           else was ready)
# device_shortfall        mesh pools built with fewer devices than
#                           dp x sp (round-robin placement degradation)
# sp_fenced / sp_engaged  resident dispatches the sp-axis crossover
#                           fence kept single-chip vs routed sharded
# latch_flip_ignored      AMTPU_MESH* env flips after the first batch
#                           (warned once, ignored -- the topology and
#                           jit caches latched)
KNOWN_MESH_KEYS = ('batches', 'shards', 'chip_docs', 'occupancy_skew',
                   'encode_shard_skew_s', 'collective_wait_s',
                   'device_shortfall', 'sp_fenced', 'sp_engaged',
                   # static-ok: telemetry-key -- the port has no env
                   # latches (analysis/glossary.md)
                   'latch_flip_ignored')

# resilience counters (`telemetry.metric('resilience.<name>')` call
# sites; glossary: docs/RESILIENCE.md), pre-seeded into every
# bench_block and the healthz payload so gates and dashboards see
# explicit zeros before the first fault:
# retry.attempts/success/    bounded-backoff retries of transient
#   exhausted                  failures and their outcomes
# bisect.rounds              doc-set splits while isolating poison docs
# quarantined                docs answered as per-doc error envelopes
# degraded                   docs healed on the full-host path
#                              (resilience.DEGRADE; DISTINCT from
#                              fallback.oracle -- perf gates stay
#                              meaningful)
# rollback /                 failed batches rolled back to the pre-begin
#   rollback_unavailable       pool state, or found past the point of
#                              rollback (emit already ran)
# fault_injected             armed `automerge_tpu_torch.faults` sites that
#                              fired (also per-site subkeys)
KNOWN_RESILIENCE_KEYS = ('retry.attempts', 'retry.success',
                         'retry.exhausted', 'bisect.rounds',
                         'quarantined', 'degraded', 'rollback',
                         'rollback_unavailable', 'fault_injected')

# scheduler counters (`telemetry.metric('scheduler.<name>')` call sites
# in automerge_tpu_torch/scheduler/; glossary: docs/OBSERVABILITY.md,
# architecture: docs/SERVING.md), pre-seeded into every bench_block so
# gates and dashboards see explicit zeros before the first gateway
# request:
# flushes            dispatcher flush cycles that executed work
# coalesced_ops      mutating requests coalesced into batch flushes
# batched_docs       docs carried by gateway batch flushes
# exec_ops           ordered ops the dispatcher ran serially (local
#                      changes, loads, queued reads, serial replays)
# bypass_reads       read-only requests served inline off the reader
#                      thread (no queue, no flush wait)
# parked             claim passes that left an op queued because its
#                      doc already had an op in the flush
# shed               mutating requests refused with the Overloaded
#                      envelope (admission control)
# serial_fallback    flushes replayed serially after a whole-batch
#                      protocol error (per-request results restored)
# quarantined        per-doc resilience envelopes routed back to the
#                      originating request by a flush
KNOWN_SCHEDULER_KEYS = ('flushes', 'coalesced_ops', 'batched_docs',
                        'exec_ops', 'bypass_reads', 'parked', 'shed',
                        'serial_fallback', 'quarantined')

# batched sync fan-out counters (`telemetry.metric('sync.fanout.<name>')`
# call sites in sync/fanout.py + scheduler/gateway.py; glossary:
# docs/OBSERVABILITY.md, architecture: docs/SERVING.md), pre-seeded into
# every bench_block's `fanout` sub-object so the fanout-check gate and
# the BENCH_FANOUT artifact read explicit zeros, never missing keys:
# flushes / docs        fan-out passes that had work, and the dirty
#                         docs they evaluated
# frames                event frames written to subscriber connections
# encode_reuse          coalesced sends served from an ALREADY-encoded
#                         frame (N subscribers -> N-1 reuses); the
#                         encode-once proof fanout-check gates
# coalesced_peers       subscribers served the shared coalesced frame
# straggler_peers       subscribers with divergent clocks served a
#                         per-peer filtered delta
# uptodate_peers        subscribers whose clock already covered the
#                         flush (incl. the originator echo)
# bytes_encoded /       wire bytes encoded vs written; on_wire /
#   bytes_on_wire         encoded = the fan-out amplification factor
# subscribes /          subscription lifecycle events (drops = peers
#   unsubscribes / drops   torn down with their connection)
# backfills             subscribe-time missing-changes backfills
# presence_frames       ephemeral (cursor) frames, incl. piggybacked
# quarantine_frames     resilience envelopes fanned to subscribers of a
#                         quarantined doc
# vector_passes /       classification passes served by the vectorized
#   scalar_passes         matrix vs the per-peer scalar loop (the port
#                         runs the vectorized pass only; the key stays
#                         for the JAX package's key set)
# errors                fan-out passes that raised (flush survived)
# patch_subscribes      mode:"patch" subscriptions accepted (thin
#                         clients; docs/SERVING.md read path)
# patch_frames          incremental patch frames staged (the flush's
#                         captured patch, encoded once per doc)
# patch_full_frames     full-state patch frames staged (stragglers,
#                         resyncs, flushes with no captured patch)
# patch_full_builds /   get_patch materializations for full-state
#   patch_full_reuse      frames vs auth-clock memo hits
KNOWN_FANOUT_KEYS = ('flushes', 'docs', 'frames', 'encode_reuse',
                     'coalesced_peers', 'straggler_peers',
                     'uptodate_peers', 'bytes_encoded',
                     'bytes_on_wire', 'writes_coalesced', 'subscribes',
                     'unsubscribes', 'drops', 'backfills',
                     'presence_frames', 'quarantine_frames',
                     'vector_passes',
                     # static-ok: telemetry-key -- the port has no
                     # scalar fan-out pass (analysis/glossary.md)
                     'scalar_passes',
                     'errors',
                     'straggler_reuse', 'backfill_reuse',
                     'regressed_peers', 'prefix_subscribes',
                     'prefix_attaches', 'subscribe_shed',
                     'patch_subscribes', 'patch_frames',
                     'patch_full_frames', 'patch_full_builds',
                     'patch_full_reuse')

# bounded-egress counters (`telemetry.metric('egress.<name>')` call
# sites in scheduler/egress.py + scheduler/gateway.py; glossary:
# docs/OBSERVABILITY.md, degradation tiers: docs/RESILIENCE.md),
# pre-seeded into every bench_block's `egress` sub-object and surfaced
# by the healthz `egress` section:
# staged_frames/staged_bytes  frames/bytes staged on per-conn egress
#                               queues (responses AND events)
# writes / write_errors       frames fully written / transports that
#                               died on a write error
# sheds / shed_frames /       tier-1 overflow events, the event frames
#   shed_bytes                  they dropped, and the bytes freed
# resyncs                     tier-2 drop-to-resubscribe envelopes
#                               (subscription rows freed)
# wedge_evictions             tier-3 consumers disconnected after
#                               egress.EGRESS_WEDGE_S of zero progress
KNOWN_EGRESS_KEYS = ('staged_frames', 'staged_bytes', 'writes',
                     'write_errors', 'sheds', 'shed_frames',
                     'shed_bytes', 'resyncs', 'wedge_evictions',
                     'overflow_evictions')

# columnar storage tier counters (`telemetry.metric('storage.<name>')`
# call sites in automerge_tpu_torch/storage/ + native/__init__.py +
# scheduler/gateway.py; glossary: docs/OBSERVABILITY.md, architecture:
# docs/STORAGE.md), pre-seeded into every bench_block's `storage` sub
# -object so the storage-check gate reads explicit zeros:
# columnar.encodes/decodes   codec passes
# columnar.changes           changes columnar-encoded
# columnar.residual_changes  changes carried verbatim (non-canonical
#                              bytes / exotic shapes; byte round-trip
#                              holds either way)
# columnar.bytes_in/_out     raw change bytes in vs blob bytes out (the
#                              compression ratio the gate bounds)
# save_v2                    v2 columnar containers emitted by save()
# snapshot_backfills         straggler queries served by merging the
#                              columnar snapshot with the C++ tail
# gc.compactions             settled-prefix folds into the snapshot
# gc.changes_folded          changes those folds moved out of the arena
# gc.bytes_freed             raw-change bytes released by truncation
# gc.skipped_json            compactions no-op'd by the
#                              native.STORAGE_FORMAT = 'json' arm
# gc.failed                  compactions that raised (flush survived)
# evictions / reloads        cold-doc LRU evictions and reload-on-touch
#                              restores
# evict_failed               docs that refused to checkpoint (kept
#                              resident)
# cold_bytes_written         checkpoint bytes written to the cold store
# gc.clocks_folded           per-change all_deps clock pairs freed by
#                              folding into the densified clock table
# restore.docs/.bytes        docs + blob bytes restored from the cold
#                              store by restore_from_store
# restore.batches            decode+apply batches the restore ran
# restore.corrupt            blobs quarantined on checksum failure
#                              (doc skipped, restore continues)
# restore.failed             docs whose decode/apply raised (skipped
#                              via the resilience path)
# sync_saves / sync_failed   write-through checkpoints (the JAX
#                              gateway's; not in the port yet, the keys
#                              stay for the JAX package's key set)
KNOWN_STORAGE_KEYS = ('columnar.encodes', 'columnar.decodes',
                      'columnar.changes', 'columnar.residual_changes',
                      'columnar.bytes_in', 'columnar.bytes_out',
                      'save_v2', 'snapshot_backfills',
                      'gc.compactions', 'gc.changes_folded',
                      'gc.bytes_freed', 'gc.skipped_json', 'gc.failed',
                      'gc.ops_folded', 'gc.rechunks',
                      'evictions', 'reloads', 'reload_failed',
                      'evict_failed', 'cold_bytes_written',
                      'evicted_bytes', 'pressure_evictions',
                      'native_encodes', 'python_encodes',
                      'native_decodes', 'python_decodes',
                      'native_loads', 'durable_writes',
                      'manifest_writes', 'manifest_recovered',
                      'manifest_corrupt', 'checksum_failed',
                      'gc.clocks_folded',
                      'restore.docs', 'restore.bytes',
                      'restore.batches', 'restore.corrupt',
                      'restore.failed',
                      'sync_saves', 'sync_failed')

# flight-recorder counters (`telemetry.metric('recorder.<name>')` call
# sites in telemetry/recorder.py; event catalog: docs/OBSERVABILITY.md),
# pre-seeded into every bench_block so gates read explicit zeros:
# dumps         JSONL ring dumps written (quarantine, state-suspect,
#                 respawn, SIGTERM, the `dump` request)
# dump_failed   dumps that could not be written (full disk, bad dir);
#                 the triggering failure is never re-raised
KNOWN_RECORDER_KEYS = ('dumps', 'dump_failed')

# per-doc capacity accounting counters (`telemetry.metric(
# 'capacity.<name>')` call sites in telemetry/capacity.py; capacity
# section: docs/OBSERVABILITY.md), pre-seeded into every bench_block:
# refreshes       native per-doc stats passes (throttled by
#                   capacity.CAPACITY_REFRESH_S; healthz scrapes and
#                   per-flush pressure checks share one)
# pressure_high   refreshes that measured memory pressure at or past
#                   capacity.MEM_PRESSURE_EVICT (the proactive-eviction
#                   signal)
KNOWN_CAPACITY_KEYS = ('refreshes', 'pressure_high')

# SLO / attribution counters (`telemetry.metric('slo.<name>')` call
# sites in telemetry/attribution.py; request-stage glossary:
# docs/OBSERVABILITY.md), pre-seeded into every bench_block:
# requests    gateway requests the critical-path attribution finished
# breaches    attributed requests whose through-emit wall exceeded
#               attribution.SLO_P99_MS
# exemplars   tail-sampled exemplar span trees emitted (slow or
#               failed/quarantined requests)
KNOWN_SLO_KEYS = ('requests', 'breaches', 'exemplars')

# distributed-tracing counters (`telemetry.metric('trace.<name>')` call
# sites in telemetry/spans.py + sidecar/client.py; distributed-tracing
# section: docs/OBSERVABILITY.md), pre-seeded into every bench_block:
# roots        outbound sidecar requests stamped with a freshly minted
#                root wire context (the caller had no ambient span)
# propagated   outbound requests that carried the caller's ambient span
#                context across the wire instead
# rotations    size-capped trace-file rotations (keep-1; the single
#                -winner path of the rotation-race fix)
KNOWN_TRACE_KEYS = ('roots', 'propagated', 'rotations')

# fleet aggregation counters (`telemetry.metric('fleet.<name>')` call
# sites in telemetry/fleet.py; fleet section: docs/OBSERVABILITY.md),
# pre-seeded into every bench_block:
# scrapes        replica healthz/slo-slot scrapes that answered
# scrape_errors  replicas that failed to answer a scrape (the merged
#                  surface marks them down instead of silently
#                  shrinking the fleet)
KNOWN_FLEET_KEYS = ('scrapes', 'scrape_errors')

# fleet-router counters (`telemetry.metric('router.<name>')` call sites
# in router/gateway.py; routing section: docs/OBSERVABILITY.md),
# pre-seeded into every bench_block:
# requests         frames forwarded to an owner replica
# local            pure commands (ping/metrics/healthz/dump) answered
#                    from the router process itself
# split_ops        requests that spanned owners and fanned into
#                    per-owner sub-requests (apply_batch / doc-set or
#                    prefix subscribe)
# parked           frames queued in a per-doc FIFO behind a live
#                    migration (released in arrival order at commit)
# redirects        WrongReplica answers re-forwarded to the owner the
#                    envelope named (bounded by sidecar.client.ROUTE_REDIRECTS)
# upstream_errors  forwards answered with a retryable Overloaded
#                    envelope because the owner replica was unreachable
#                    or its connection died mid-request
# resyncs          migration-handoff resync events staged to
#                    subscribed connections (their auto-resubscribe
#                    re-homes the stream on the new owner)
# health.probes        heartbeat pings the fleet health monitor sent
# health.misses        probe deadlines missed or transport deaths
#                        reported (each feeds the per-member machine)
# health.suspects      up -> suspect transitions (first miss)
# health.deaths        suspect/up -> dead transitions (miss ladder,
#                        transport storm, or supervisor kill report)
# health.recoveries    suspect -> up transitions (a probe answered
#                        again; that member's parked frames replay)
# health.parked        mutating frames parked for a suspect/dead
#                        member's docs (released or failed by the
#                        failover executor)
# health.park_overflow frames refused the park because the
#                        AMTPU_FLEET_PARK_MB byte budget was full
#                        (answered with the retryable envelope)
# health.park_expired  parked frames flushed with the retryable
#                        envelope after AMTPU_FLEET_PARK_S (a wedged
#                        failover must not hold clients hostage)
KNOWN_ROUTER_KEYS = ('requests', 'local', 'split_ops', 'parked',
                     'redirects', 'upstream_errors', 'resyncs',
                     'health.probes', 'health.misses',
                     'health.suspects', 'health.deaths',
                     'health.recoveries', 'health.parked',
                     'health.park_overflow', 'health.park_expired')

# fleet-failover counters (`telemetry.metric('failover.<name>')` call
# sites in router/failover.py, router/supervisor.py, router/gateway.py;
# docs/RESILIENCE.md fleet degradation tiers), pre-seeded into every
# bench_block:
# failovers       dead members the executor finished re-placing
# docs_recovered  docs restored onto survivors from the dead member's
#                   durable store (exactly-once under (actor,seq) dedup)
# docs_lost       docs with nothing durable to restore (their parked
#                   frames answered the terminal ReplicaFailed envelope)
# replayed        parked frames released (or failed) by a failover
# rejoins         supervised respawns that joined the ring as a new
#                   generation member
# respawns        supervisor respawn attempts (capped backoff)
# quarantined     lineages barred from respawn after
#                   AMTPU_FLEET_FLAP_MAX deaths
# retried_reads   read-only frames whose upstream died mid-flight and
#                   were parked for one transparent post-failover retry
KNOWN_FAILOVER_KEYS = ('failovers', 'docs_recovered', 'docs_lost',
                       'replayed', 'rejoins', 'respawns',
                       'quarantined', 'retried_reads')

# live-migration counters (`telemetry.metric('migrate.<name>')` call
# sites in scheduler/gateway.py + router/rebalance.py; migration
# section: docs/OBSERVABILITY.md), pre-seeded into every bench_block:
# out_docs / out_bytes   docs / handoff bytes a source replica saved
#                          into the durable handoff store (migrate_out)
# in_docs / in_bytes     docs / handoff bytes a target replica restored
#                          (migrate_in; retries re-count)
# wrong_replica          ops a replica refused with the typed
#                          WrongReplica envelope (doc migrated away)
# migrations             docs whose move fully committed (ring override
#                          installed)
# failed                 migrations abandoned past the executor deadline
#                          (drain or migrate_in never completed)
# errors                 unexpected migrate_out/migrate_in/scan faults
#                          answered as InternalError
# rebalance_passes       rebalancer scrape->score->plan passes
KNOWN_MIGRATE_KEYS = ('out_docs', 'out_bytes', 'in_docs', 'in_bytes',
                      'wrong_replica', 'migrations', 'failed',
                      'errors', 'rebalance_passes')

# read-path counters (`telemetry.metric('readview.<name>')` call sites
# in readview/snapshot.py, readview/replica.py, sidecar/server.py,
# scheduler/gateway.py; read-path section: docs/SERVING.md, glossary:
# docs/OBSERVABILITY.md), pre-seeded into every bench_block:
# snapshots_served        `snapshot` requests answered (container bytes
#                           + frontier clock)
# snapshot_hits /         frontier-clock cache hits vs container builds
#   snapshot_builds         (an unchanged doc serves cached bytes)
# read_only_refused       mutations a read-only replica answered with
#                           the typed ReadOnly envelope (read replicas
#                           are not in the port yet)
# replica_bootstrap_docs  docs a read replica restored arena-direct
#                           from its ColdStore before subscribing
# replica_events          fan-out frames the replica consumer drained
# replica_changes         change bytes applied into the replica pool
#                           (live frames, backfill, and resyncs)
# replica_apply_errors    frames whose apply raised (the consumer
#                           survives and forces a catch-up)
# replica_probes          upstream frontier probes the staleness SLO
#                           loop completed
# replica_slo_breaches    docs stale past AMTPU_READ_STALENESS_SLO_S
#                           (each forces a catch-up)
# replica_resyncs         forced get_missing_changes catch-up walks
KNOWN_READVIEW_KEYS = ('snapshots_served', 'snapshot_hits',
                       'snapshot_builds', 'read_only_refused',
                       'replica_bootstrap_docs', 'replica_events',
                       'replica_changes', 'replica_apply_errors',
                       'replica_probes', 'replica_slo_breaches',
                       'replica_resyncs')

# docs per gateway flush are effectively powers of two: exact log2 bounds
BATCH_OCCUPANCY_BUCKETS = tuple(float(2 ** i) for i in range(13))

BATCH_OCCUPANCY = registry.histogram(
    'amtpu_batch_occupancy',
    'Documents coalesced into one gateway batch flush (docs/SERVING.md; '
    'median > 4 is the serve-check gate on concurrent traffic)',
    buckets=BATCH_OCCUPANCY_BUCKETS)

# queue wait in MILLISECONDS: 0.001ms .. ~67s, log2
QUEUE_WAIT_BUCKETS = tuple(1e-3 * 2 ** i for i in range(27))

QUEUE_WAIT = registry.histogram(
    'amtpu_queue_wait_ms',
    'Milliseconds a mutating request waited in the gateway queue '
    'between arrival and the start of its flush',
    buckets=QUEUE_WAIT_BUCKETS)

# change->fanout latency shares the queue-wait bucket layout (ms, log2)
FANOUT_LATENCY = registry.histogram(
    'amtpu_fanout_latency_ms',
    'Milliseconds from a mutating request\'s gateway admission to a '
    'subscriber fan-out frame write for its doc (docs/SERVING.md '
    'fan-out section; bounded by the flush window + flush execution)',
    buckets=QUEUE_WAIT_BUCKETS)

# escalation tier widths are powers of two: exact log2 bucket bounds
ESCALATION_TIER_BUCKETS = tuple(float(2 ** i) for i in range(4, 15))

# tier histogram: one observation per escalated register GROUP at the
# tier width that resolved it -- the distribution of live-writer
# antichain widths the ladder actually served
ESCALATION_TIER = registry.histogram(
    'amtpu_escalation_tier_width',
    'Escalation-ladder tier width (W) observed per escalated register '
    'group', buckets=ESCALATION_TIER_BUCKETS)


# ---------------------------------------------------------------------------
# always-on flat metrics (trace.metric compat; one dict update per batch)
# ---------------------------------------------------------------------------

_flat_lock = threading.Lock()
_flat = {}


def metric(name, n=1):
    """Unconditionally accumulates `n` into the always-on counter."""
    with _flat_lock:
        _flat[name] = _flat.get(name, 0) + n


# healthz's `degraded` flag must mean "degrading RECENTLY", not "ever
# degraded since process start" -- a long-lived server that quarantined
# one poison doc at t0 must not look drain-worthy forever.  Resilience
# events stamp this; healthz compares against the window.
_last_degraded_ts = 0.0


def note_degraded():
    """One quarantine/degrade event happened now (called by
    automerge_tpu_torch.resilience alongside its counters)."""
    global _last_degraded_ts
    _last_degraded_ts = time.time()


def _degraded_window_s():
    return DEGRADED_WINDOW_S


def metrics_reset():
    with _flat_lock:
        _flat.clear()


# healthz payload extensions: long-lived subsystems (the serve gateway's
# scheduler) register a section provider so BOTH healthz surfaces -- the
# in-band `healthz` command and the HTTP /healthz listener -- report
# their state without either transport knowing the subsystem exists.
_healthz_sections = {}


def register_healthz_section(name, provider):
    """Adds `provider()` (returning a JSON-safe dict) under `name` in
    every healthz payload; re-registering a name replaces it, None
    removes it."""
    if provider is None:
        _healthz_sections.pop(name, None)
    else:
        _healthz_sections[name] = provider


def metrics_snapshot():
    """{name: value} of the always-on counters since metrics_reset()."""
    with _flat_lock:
        return dict(_flat)


# ---------------------------------------------------------------------------
# batch + device helpers (the per-layer call sites)
# ---------------------------------------------------------------------------

def observe_batch(pool, seconds, docs=0, ops=0):
    """One apply-batch pass completed: latency histogram + counters.
    `pool` names the entry point ('engine' | 'native' | 'sharded'), so
    whole-batch and per-shard latencies stay separate series."""
    BATCHES.labels(pool).inc()
    BATCH_LATENCY.labels(pool).observe(seconds)
    if docs:
        DOCS.inc(docs)
    if ops:
        OPS.inc(ops)
    # flight-recorder commit event (begin/rollback stamp in native/):
    # one ring append per completed batch, any entry point
    recorder.record('batch.commit', n=docs, detail=pool)


def devtime_on():
    """Per-dispatch device timing (`DEVTIME`, read per call, so a caller
    may flip it for one pass)."""
    return DEVTIME


def observe_device_dispatch(seconds, n=1):
    """One timed kernel dispatch (the card's time between its CUDA
    events): lands in the flat map under the JAX package's names."""
    metric('device.dispatch_sync_s', seconds)
    metric('device.dispatches', n)


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------

def _render_derived(out):
    """Families derived at scrape time from the span occupancy table and
    the flat map -- keeps the hot paths at one dict update while the
    scrape surface stays fully structured."""
    from .metrics import _labels_text

    phases = phase_snapshot()
    out.append('# HELP amtpu_phase_seconds_total Per-phase host occupancy '
               'seconds (sums across shard threads; exceeds wall time '
               'when shards overlap); only populated while tracing is '
               'enabled')
    out.append('# TYPE amtpu_phase_seconds_total counter')
    for name in sorted(phases):
        out.append('amtpu_phase_seconds_total%s %s' % (
            _labels_text(('phase',), (name,)),
            format_value(float(phases[name]['s']))))
    out.append('# HELP amtpu_phase_calls_total Per-phase call counts '
               '(see amtpu_phase_seconds_total)')
    out.append('# TYPE amtpu_phase_calls_total counter')
    for name in sorted(phases):
        out.append('amtpu_phase_calls_total%s %s' % (
            _labels_text(('phase',), (name,)),
            format_value(phases[name]['n'])))

    flat = metrics_snapshot()
    fallbacks = {r: 0.0 for r in KNOWN_FALLBACK_REASONS}
    rest = {}
    for k, v in flat.items():
        if k.startswith('fallback.'):
            fallbacks[k.split('.', 1)[1]] = v
        elif k not in ('device.dispatch_sync_s', 'device.dispatches'):
            rest[k] = v
    out.append('# HELP amtpu_fallback_total Oracle-fallback / degradation '
               'events by reason (always on; nonzero means a batch left '
               'the fast path)')
    out.append('# TYPE amtpu_fallback_total counter')
    for reason in sorted(fallbacks):
        out.append('amtpu_fallback_total%s %s' % (
            _labels_text(('reason',), (reason,)),
            format_value(fallbacks[reason])))
    out.append('# HELP amtpu_device_seconds_total Measured device time '
               '(between CUDA events around each dispatch; populated '
               'under DEVTIME)')
    out.append('# TYPE amtpu_device_seconds_total counter')
    out.append('amtpu_device_seconds_total %s'
               % format_value(float(flat.get('device.dispatch_sync_s',
                                             0.0))))
    out.append('# HELP amtpu_device_dispatches_total Timed kernel '
               'dispatches (DEVTIME)')
    out.append('# TYPE amtpu_device_dispatches_total counter')
    out.append('amtpu_device_dispatches_total %s'
               % format_value(float(flat.get('device.dispatches', 0.0))))
    out.append('# HELP amtpu_runtime_counter Remaining always-on flat '
               'counters, exported verbatim by name')
    out.append('# TYPE amtpu_runtime_counter gauge')
    for k in sorted(rest):
        out.append('amtpu_runtime_counter%s %s' % (
            _labels_text(('name',), (k,)), format_value(float(rest[k]))))

    out.append('# HELP amtpu_telemetry_enabled Whether span tracing is '
               'currently enabled (1) or idle (0)')
    out.append('# TYPE amtpu_telemetry_enabled gauge')
    out.append('amtpu_telemetry_enabled %d' % (1 if enabled() else 0))
    out.append('# HELP amtpu_up Process liveness (constant 1 while the '
               'exporter answers)')
    out.append('# TYPE amtpu_up gauge')
    out.append('amtpu_up 1')


def render_prometheus():
    """Full Prometheus text exposition (format 0.0.4) for this process."""
    out = []
    for fam in registry.families():
        fam.render(out)
    _render_derived(out)
    return '\n'.join(out) + '\n'


def healthz():
    """Liveness payload for /healthz and the in-band `healthz` command.
    Batch counts report per pool label (summing them would double-count
    a sharded batch against its per-shard sub-batches).  The resilience
    block surfaces degraded/quarantine state (docs/RESILIENCE.md):
    `degraded` is WINDOWED -- true only when a quarantine/degrade event
    happened within the last DEGRADED_WINDOW_S seconds (default
    300) -- so one poison doc at t0 doesn't mark a long-lived server
    drain-worthy forever; the cumulative counters stay in `resilience`.
    `restarts` is the supervising client's respawn count (exported into
    this process by the server's `--restarts` flag on each respawn)."""
    flat = metrics_snapshot()
    res = {k: 0.0 for k in KNOWN_RESILIENCE_KEYS}
    res.update({k.split('.', 1)[1]: v for k, v in flat.items()
                if k.startswith('resilience.')})
    restarts = RESTARTS
    degraded_age = time.time() - _last_degraded_ts if _last_degraded_ts \
        else None
    extra = {}
    for name, provider in list(_healthz_sections.items()):
        try:
            extra[name] = provider()
        except Exception as e:
            # a broken section provider degrades ITS section, never the
            # liveness answer itself
            extra[name] = {'error': '%s: %s' % (type(e).__name__, e)}
    return dict(extra, **{
        'ok': True, 'uptime_s': round(uptime_s(), 3),
            'replica_id': replica_id(),
            'telemetry_enabled': enabled(),
            'batches': BATCHES.snapshot() or {},
            'restarts': restarts,
            'degraded': (degraded_age is not None
                         and degraded_age < _degraded_window_s()),
            'last_degraded_age_s': (None if degraded_age is None
                                    else round(degraded_age, 3)),
            'resilience': res,
            # the SLO surface (docs/OBSERVABILITY.md): rolling
            # per-class p50/p99 + multi-window burn rates, and the
            # flight recorder's ring state -- process-wide, so both
            # healthz transports carry them without registration
            'slo': attribution.slo_section(),
            'recorder': recorder.RECORDER.healthz_section()})


def bench_block():
    """The per-BENCH-line embed: fallback rates, device seconds, batch
    latency summaries, and (when tracing) the phase occupancy table."""
    flat = metrics_snapshot()
    fallbacks = {r: 0.0 for r in KNOWN_FALLBACK_REASONS}
    fallbacks.update({k.split('.', 1)[1]: round(v, 6)
                      for k, v in flat.items()
                      if k.startswith('fallback.')})
    collect = {r: 0.0 for r in KNOWN_COLLECT_KEYS}
    collect.update({k.split('.', 1)[1]: round(v, 6)
                    for k, v in flat.items()
                    if k.startswith('collect.')})
    resilience = {r: 0.0 for r in KNOWN_RESILIENCE_KEYS}
    resilience.update({k.split('.', 1)[1]: round(v, 6)
                       for k, v in flat.items()
                       if k.startswith('resilience.')})
    scheduler = {r: 0.0 for r in KNOWN_SCHEDULER_KEYS}
    scheduler.update({k.split('.', 1)[1]: round(v, 6)
                      for k, v in flat.items()
                      if k.startswith('scheduler.')})
    resident = {r: 0.0 for r in KNOWN_RESIDENT_BATCH_KEYS}
    resident.update({k.split('.', 1)[1]: round(v, 6)
                     for k, v in flat.items()
                     if k.startswith('resident.')})
    pipeline = {r: 0.0 for r in KNOWN_PIPELINE_KEYS}
    pipeline.update({k.split('.', 1)[1]: round(v, 6)
                     for k, v in flat.items()
                     if k.startswith('pipeline.')})
    mesh = {r: 0.0 for r in KNOWN_MESH_KEYS}
    mesh.update({k.split('.', 1)[1]: round(v, 6)
                 for k, v in flat.items()
                 if k.startswith('mesh.')})
    fanout = {r: 0.0 for r in KNOWN_FANOUT_KEYS}
    fanout.update({k.split('sync.fanout.', 1)[1]: round(v, 6)
                   for k, v in flat.items()
                   if k.startswith('sync.fanout.')})
    fanout['latency_ms'] = FANOUT_LATENCY.summary() or {}
    egress = {r: 0.0 for r in KNOWN_EGRESS_KEYS}
    egress.update({k.split('.', 1)[1]: round(v, 6)
                   for k, v in flat.items()
                   if k.startswith('egress.')})
    storage = {r: 0.0 for r in KNOWN_STORAGE_KEYS}
    storage.update({k.split('.', 1)[1]: round(v, 6)
                    for k, v in flat.items()
                    if k.startswith('storage.')})
    rec = {r: 0.0 for r in KNOWN_RECORDER_KEYS}
    rec.update({k.split('.', 1)[1]: round(v, 6)
                for k, v in flat.items()
                if k.startswith('recorder.')})
    slo = {r: 0.0 for r in KNOWN_SLO_KEYS}
    slo.update({k.split('.', 1)[1]: round(v, 6)
                for k, v in flat.items()
                if k.startswith('slo.')})
    cap = {r: 0.0 for r in KNOWN_CAPACITY_KEYS}
    cap.update({k.split('.', 1)[1]: round(v, 6)
                for k, v in flat.items()
                if k.startswith('capacity.')})
    trc = {r: 0.0 for r in KNOWN_TRACE_KEYS}
    trc.update({k.split('.', 1)[1]: round(v, 6)
                for k, v in flat.items()
                if k.startswith('trace.')})
    fleet = {r: 0.0 for r in KNOWN_FLEET_KEYS}
    fleet.update({k.split('.', 1)[1]: round(v, 6)
                  for k, v in flat.items()
                  if k.startswith('fleet.')})
    router = {r: 0.0 for r in KNOWN_ROUTER_KEYS}
    router.update({k.split('.', 1)[1]: round(v, 6)
                   for k, v in flat.items()
                   if k.startswith('router.')})
    migrate = {r: 0.0 for r in KNOWN_MIGRATE_KEYS}
    migrate.update({k.split('.', 1)[1]: round(v, 6)
                    for k, v in flat.items()
                    if k.startswith('migrate.')})
    failover = {r: 0.0 for r in KNOWN_FAILOVER_KEYS}
    failover.update({k.split('.', 1)[1]: round(v, 6)
                     for k, v in flat.items()
                     if k.startswith('failover.')})
    readview = {r: 0.0 for r in KNOWN_READVIEW_KEYS}
    readview.update({k.split('.', 1)[1]: round(v, 6)
                     for k, v in flat.items()
                     if k.startswith('readview.')})
    block = {
        'fallbacks': fallbacks,
        'collect': collect,
        'resilience': resilience,
        'scheduler': scheduler,
        'resident': resident,
        'pipeline': pipeline,
        'mesh': mesh,
        'fanout': fanout,
        'egress': egress,
        'storage': storage,
        'recorder': rec,
        'slo': slo,
        'capacity': cap,
        'trace': trc,
        'fleet': fleet,
        'router': router,
        'migrate': migrate,
        'failover': failover,
        'readview': readview,
        'device_s': round(flat.get('device.dispatch_sync_s', 0.0), 4),
        'device_dispatches': int(flat.get('device.dispatches', 0)),
        'batch_latency': BATCH_LATENCY.snapshot() or {},
        'ops_total': OPS.value,
        'docs_total': DOCS.value,
    }
    if enabled():
        block['phases'] = {k: {'s': round(v['s'], 4), 'n': v['n']}
                           for k, v in phase_snapshot().items()}
    return block


def collect_share(block):
    """(share, collect_s, basis_s) of `device.collect` against the
    summed native batch time, read from one bench_block-shaped dict.
    The ONE definition both bench.py's `collect_share` artifact field
    and the perf-smoke gate divide by -- if the latency-block shape or
    the native-vs-sharded fallback rule changes, it changes for both."""
    lat = block.get('batch_latency') or {}
    basis = ((lat.get('native') or {}).get('sum', 0.0)
             or (lat.get('sharded') or {}).get('sum', 0.0)
             or (lat.get('mesh') or {}).get('sum', 0.0))
    coll = ((block.get('phases') or {}).get('device.collect')
            or {}).get('s', 0.0)
    return (coll / basis if basis else 0.0), coll, basis


def reset_all():
    """Test/bench isolation: zero the registry, the flat map, and the
    phase occupancy table (enable state and exporter are untouched)."""
    registry.reset()
    metrics_reset()
    phase_reset()


# imported LAST: these modules resolve names from this module (registry,
# buckets, metric) lazily, so they must load after those exist
from . import attribution, capacity, recorder  # noqa: E402,F401

