"""The port's map of the JAX package's ``AMTPU_*`` environment flags.

The port reads no environment variable: each knob of the JAX package is
a module constant here (set it, or monkeypatch it in a test), a command
line flag of an entry point, or a path the port does not have.
`PORT_KNOBS` holds one row per flag of the JAX package's spec, its
default copied as a literal (`check_env` never imports the JAX
package; the test holds the copy to it):

  * `constant`: the port's module-level constant that stands for the
    flag, as a dotted path under `automerge_tpu_torch` (for example
    `scheduler.queue.FLUSH_DEADLINE_MS`), or None, with the reason in
    `note`;
  * `core`: True where the C++ core the port builds from
    `native/core.cpp` reads the flag itself (its ``getenv`` sites, which
    latch at the first batch of the process);
  * `default`: the JAX package's default.  A constant holds the same
    value, or the value `PORT_VALUES` gives with its reason.

`check_env` fails the gate when a named constant is missing or holds
another value, when core.cpp reads a flag no row marks, and when a latch
default drifts from what the port's build of the library reports.
"""

import collections

PortKnob = collections.namedtuple(
    'PortKnob', ('flag', 'constant', 'default', 'core', 'note'))

#: the C++ core's own knobs: it reads them at its first batch
_CORE = 'read by the C++ core at its first batch in the process'
#: the port drives one path where the JAX package had a switch
_ONE_PATH = 'the port has one path here and no switch'

PORT_KNOBS = (
    # -- observability ------------------------------------------------------
    PortKnob('AMTPU_TRACE', None, False, False,
             'span tracing is switched at run time: telemetry.enable(), '
             'the server\'s --trace'),
    PortKnob('AMTPU_TRACE_FILE', 'telemetry.spans.TRACE_FILE', '', False,
             'also the server\'s --trace-file'),
    PortKnob('AMTPU_TRACE_FILE_MAX_MB', 'telemetry.spans.TRACE_FILE_MAX_MB',
             256, False, ''),
    PortKnob('AMTPU_TRACE_WIRE', 'sidecar.client.TRACE_WIRE', True, False,
             ''),
    PortKnob('AMTPU_REPLICA_ID', 'telemetry.REPLICA_ID', '', False,
             'also the server\'s --replica-id'),
    PortKnob('AMTPU_RECORDER_EVENTS', 'telemetry.recorder.RECORDER_EVENTS',
             4096, False, ''),
    PortKnob('AMTPU_RECORDER_DIR', 'telemetry.recorder.RECORDER_DIR', '',
             False, ''),
    PortKnob('AMTPU_RECORDER_MIN_DUMP_S',
             'telemetry.recorder.RECORDER_MIN_DUMP_S', 5.0, False, ''),
    PortKnob('AMTPU_SLOW_MS', 'telemetry.attribution.SLOW_MS', 250.0,
             False, ''),
    PortKnob('AMTPU_SLO_P99_MS', 'telemetry.attribution.SLO_P99_MS', 100.0,
             False, ''),
    PortKnob('AMTPU_EXEMPLAR_MIN_S', 'telemetry.attribution.EXEMPLAR_MIN_S',
             0.05, False, ''),
    PortKnob('AMTPU_DEVTIME', 'telemetry.DEVTIME', False, False, ''),
    PortKnob('AMTPU_DEGRADED_WINDOW_S', 'telemetry.DEGRADED_WINDOW_S',
             300.0, False, ''),
    PortKnob('AMTPU_SIDECAR_RESTARTS', 'telemetry.RESTARTS', 0, False,
             'set by the server\'s --restarts'),
    PortKnob('AMTPU_METRICS_PORT', None, -1, False,
             'the server\'s --metrics-port (default -1)'),
    PortKnob('AMTPU_METRICS_HOST', None, '127.0.0.1', False,
             'the server\'s --metrics-host (default 127.0.0.1)'),
    # -- capacity accounting and headroom -----------------------------------
    PortKnob('AMTPU_MEM_BUDGET_MB', 'telemetry.capacity.MEM_BUDGET_MB', 0,
             False, ''),
    PortKnob('AMTPU_MEM_PRESSURE_EVICT',
             'telemetry.capacity.MEM_PRESSURE_EVICT', 0.85, False, ''),
    PortKnob('AMTPU_PRESSURE_EVICT_DOCS',
             'storage.coldstore.PRESSURE_EVICT_DOCS', 16, False, ''),
    PortKnob('AMTPU_PRESSURE_EVICT_COOLDOWN_S',
             'telemetry.capacity.PRESSURE_EVICT_COOLDOWN_S', 30.0, False,
             ''),
    PortKnob('AMTPU_CAPACITY_TOPK', 'telemetry.capacity.CAPACITY_TOPK', 10,
             False, ''),
    PortKnob('AMTPU_CAPACITY_REFRESH_S',
             'telemetry.capacity.CAPACITY_REFRESH_S', 1.0, False, ''),
    PortKnob('AMTPU_CAPACITY_SKETCH', 'telemetry.capacity.CAPACITY_SKETCH',
             128, False, ''),
    # -- kernel path --------------------------------------------------------
    PortKnob('AMTPU_PACKED_EPILOGUE', None, True, False,
             _ONE_PATH + ': the packed epilogue is always on'),
    PortKnob('AMTPU_CONF_DENSE_THRESH', 'native.CONF_DENSE_THRESH', 4,
             False, ''),
    PortKnob('AMTPU_HOST_DOM', None, None, False,
             'the port resolves list indexes on the device only'),
    PortKnob('AMTPU_HOST_FULL', None, None, False,
             'the port drives the kernel path only; a batch C++ pins to '
             'the host path raises'),
    PortKnob('AMTPU_HOST_REG', None, True, False,
             'the port resolves registers on the device only'),
    PortKnob('AMTPU_WEFF', None, None, False,
             'a test-only window narrowing of the JAX pool; the port '
             'sizes its sliding window to the widest group'),
    PortKnob('AMTPU_SHARD_MODE', 'native.SHARD_MODE', '', False, ''),
    PortKnob('AMTPU_NO_PALLAS', None, False, False,
             'Pallas is JAX-only; the port\'s kernels are CUDA'),
    PortKnob('AMTPU_ESCALATE', None, True, False,
             _ONE_PATH + ': the escalation ladder is always on'),
    PortKnob('AMTPU_MAX_TIER', 'ops.registers.DEFAULT_MAX_TIER', 1024,
             False, ''),
    PortKnob('AMTPU_ESCALATE_BUDGET_MB',
             'ops.registers.DEFAULT_ESCALATION_BUDGET', -1, False, ''),
    PortKnob('AMTPU_ESC_CHUNK', 'ops.registers.DEFAULT_ESC_CHUNK', 32768,
             False, ''),
    PortKnob('AMTPU_DEVICE_MERGE', None, True, False,
             _ONE_PATH + ': the tier merge is always on the device'),
    PortKnob('AMTPU_PIPELINE_DEPTH', 'native.PIPELINE_DEPTH', 2, False, ''),
    PortKnob('AMTPU_PIPELINE_MIN_DOCS', 'native.PIPELINE_MIN_DOCS', 64,
             False, ''),
    PortKnob('AMTPU_NATIVE_LIB', None, '', False,
             'the port builds its own library from native/core.cpp '
             '(native/_lib.py)'),
    # -- the C++ core's latches ----------------------------------------------
    PortKnob('AMTPU_RESIDENT', 'native.RESIDENT', None, True,
             'native.RESIDENT decides the Python route; ' + _CORE),
    PortKnob('AMTPU_RESIDENT_MIN', None, 16384, True, _CORE),
    PortKnob('AMTPU_RESIDENT_CLK', None, None, True, _CORE),
    PortKnob('AMTPU_RESCLK_MAX_ACTORS', None, 512, True, _CORE),
    PortKnob('AMTPU_RESCLK_MAX_ROWS', None, 1048576, True, _CORE),
    PortKnob('AMTPU_TRIVIAL_HOST', None, True, True, _CORE),
    PortKnob('AMTPU_TRACE_BEGIN', None, None, True,
             'a debug trace of the C++ begin; ' + _CORE),
    # -- mesh ---------------------------------------------------------------
    PortKnob('AMTPU_MESH', None, None, False,
             'the mesh is an argument: make_pool(mesh=(dp, sp)), '
             'MeshDocPool(dp, sp), the server\'s --mesh'),
    PortKnob('AMTPU_MESH_SP_MIN', 'native.resident.SP_CROSSOVER_ELEMS',
             131072, False, 'also MeshDocPool(sp_min=)'),
    PortKnob('AMTPU_MESH_CONNECT_DEADLINE_S',
             'sync.distributed.CONNECT_DEADLINE_S', 60, False, ''),
    # -- resilience and faults ----------------------------------------------
    PortKnob('AMTPU_RESILIENCE', 'resilience.ENABLED', True, False, ''),
    PortKnob('AMTPU_RETRY_MAX', 'resilience.RETRY_MAX', 3, False, ''),
    PortKnob('AMTPU_RETRY_BACKOFF_S', 'resilience.RETRY_BACKOFF_S', 0.05,
             False, ''),
    PortKnob('AMTPU_DEGRADE', 'resilience.DEGRADE', False, False, ''),
    PortKnob('AMTPU_FAULT', None, '', False,
             'fault specs are armed by call: faults.load_spec(spec)'),
    PortKnob('AMTPU_FAULT_SEED', None, None, False,
             'fault draws are seeded by call: faults.load_spec'),
    # -- columnar storage and the cold-state tier ---------------------------
    PortKnob('AMTPU_STORAGE_FORMAT', 'native.STORAGE_FORMAT', 'columnar',
             False, ''),
    PortKnob('AMTPU_STORAGE_NATIVE', 'native.STORAGE_NATIVE', True, False,
             'the C++ codec and arena-direct load; False: the Python '
             'codec and the replay'),
    PortKnob('AMTPU_STORAGE_FOLD', 'native.STORAGE_FOLD', True, False, ''),
    PortKnob('AMTPU_STORAGE_CHUNK_MAX', 'native.STORAGE_CHUNK_MAX', 8,
             False, ''),
    PortKnob('AMTPU_STORAGE_DURABLE', 'storage.coldstore.STORAGE_DURABLE',
             False, False, 'also the server\'s --durable'),
    PortKnob('AMTPU_STORAGE_DIR', 'storage.coldstore.STORAGE_DIR', '',
             False, 'also the server\'s --storage-dir'),
    PortKnob('AMTPU_STORAGE_GC_MIN', 'storage.coldstore.STORAGE_GC_MIN',
             256, False, ''),
    PortKnob('AMTPU_RESIDENT_DOCS_MAX', 'storage.coldstore.RESIDENT_DOCS_MAX',
             0, False, ''),
    PortKnob('AMTPU_STORAGE_FOLD_CLOCKS', 'native.STORAGE_FOLD_CLOCKS', True,
             False, ''),
    PortKnob('AMTPU_FOLDCLK_MAX_ACTORS', 'native.FOLDCLK_MAX_ACTORS', 256,
             False, ''),
    PortKnob('AMTPU_RESTORE_THREADS', 'native.RESTORE_THREADS', 0, False,
             ''),
    PortKnob('AMTPU_RESTORE_BATCH', 'native.RESTORE_BATCH', 8192, False,
             ''),
    # -- sidecar client -----------------------------------------------------
    PortKnob('AMTPU_WAL_COMPACT', 'sidecar.client.WAL_COMPACT', 32, False,
             ''),
    PortKnob('AMTPU_WAL_MAX_BYTES', 'sidecar.client.WAL_MAX_BYTES',
             67108864, False, ''),
    PortKnob('AMTPU_SIDECAR_DEADLINE_S', 'sidecar.client.DEADLINE_S', 0,
             False, ''),
    PortKnob('AMTPU_SIDECAR_HEARTBEAT_S', 'sidecar.client.HEARTBEAT_S', 0,
             False, ''),
    PortKnob('AMTPU_SIDECAR_MAX_RESPAWNS', 'sidecar.client.MAX_RESPAWNS', 3,
             False, ''),
    PortKnob('AMTPU_SIDECAR_RESPAWN_DEADLINE_S',
             'sidecar.client.RESPAWN_DEADLINE_S', 30.0, False, ''),
    # -- serve gateway ------------------------------------------------------
    PortKnob('AMTPU_GATEWAY', None, True, False,
             'the server\'s --serial turns the gateway off'),
    PortKnob('AMTPU_FLUSH_DEADLINE_MS', 'scheduler.queue.FLUSH_DEADLINE_MS',
             2.0, False, ''),
    PortKnob('AMTPU_MAX_BATCH_DOCS', 'scheduler.queue.MAX_BATCH_DOCS', 256,
             False, ''),
    PortKnob('AMTPU_MAX_BATCH_OPS', 'scheduler.queue.MAX_BATCH_OPS', 2048,
             False, ''),
    PortKnob('AMTPU_QUEUE_MAX_OPS', 'scheduler.queue.QUEUE_MAX_OPS', 4096,
             False, ''),
    PortKnob('AMTPU_QUEUE_LOW_FRAC', 'scheduler.queue.QUEUE_LOW_FRAC', 0.5,
             False, ''),
    # -- bounded egress and backpressure ------------------------------------
    PortKnob('AMTPU_EGRESS_MAX_BYTES', 'scheduler.egress.EGRESS_MAX_BYTES',
             1048576, False, ''),
    PortKnob('AMTPU_EGRESS_WEDGE_S', 'scheduler.egress.EGRESS_WEDGE_S',
             10.0, False, ''),
    PortKnob('AMTPU_EGRESS_RESYNC_SHEDS',
             'scheduler.egress.EGRESS_RESYNC_SHEDS', 3, False, ''),
    # -- batched sync fan-out -----------------------------------------------
    PortKnob('AMTPU_FANOUT', None, True, False,
             _ONE_PATH + ': the gateway always fans out in batches'),
    PortKnob('AMTPU_FANOUT_VECTOR', None, True, False,
             _ONE_PATH + ': the vectorised pass (classify_scalar is its '
             'reference in the tests)'),
    PortKnob('AMTPU_FANOUT_PRESENCE', None, True, False,
             _ONE_PATH + ': presence is always served'),
    # -- analysis and sanitizer ---------------------------------------------
    PortKnob('AMTPU_SANITIZE', 'analysis.sanitize.ARMED', False, False,
             'armed by call: sanitize.arm()'),
    # -- fleet router and rebalancer ----------------------------------------
    PortKnob('AMTPU_ROUTE_VNODES', 'router.ring.ROUTE_VNODES', 64, False,
             ''),
    PortKnob('AMTPU_ROUTE_REDIRECTS', 'router.gateway.ROUTE_REDIRECTS', 3,
             False, 'also sidecar.client.ROUTE_REDIRECTS'),
    PortKnob('AMTPU_ROUTE_HANDOFF_DIR', None, '', False,
             'an argument: MigrationExecutor(handoff_dir=), a fresh '
             'tempdir by default'),
    PortKnob('AMTPU_REBALANCE_INTERVAL_S',
             'router.rebalance.REBALANCE_INTERVAL_S', 5.0, False, ''),
    PortKnob('AMTPU_REBALANCE_TOPK', 'router.rebalance.REBALANCE_TOPK', 4,
             False, ''),
    PortKnob('AMTPU_REBALANCE_MIN_SKEW',
             'router.rebalance.REBALANCE_MIN_SKEW', 0.5, False, ''),
    PortKnob('AMTPU_REBALANCE_PRESSURE',
             'router.rebalance.REBALANCE_PRESSURE', 0.8, False, ''),
    # -- fleet failover -----------------------------------------------------
    PortKnob('AMTPU_FLEET_HEARTBEAT_S', 'router.health.FLEET_HEARTBEAT_S',
             0.5, False, ''),
    PortKnob('AMTPU_FLEET_DEADLINE_S', 'router.health.FLEET_DEADLINE_S',
             0.5, False, ''),
    PortKnob('AMTPU_FLEET_MISS_MAX', 'router.health.FLEET_MISS_MAX', 3,
             False, ''),
    PortKnob('AMTPU_FLEET_PARK_S', 'router.gateway.FLEET_PARK_S', 10.0,
             False, ''),
    PortKnob('AMTPU_FLEET_PARK_MB', 'router.gateway.FLEET_PARK_MB', 8,
             False, ''),
    PortKnob('AMTPU_FLEET_FLAP_MAX', 'router.supervisor.FLEET_FLAP_MAX', 3,
             False, ''),
    PortKnob('AMTPU_STORAGE_SYNC', None, False, False,
             'an argument: GatewayServer(sync_dir=), the server\'s --sync'),
    # -- read path ----------------------------------------------------------
    PortKnob('AMTPU_READ_PATCH', None, True, False,
             _ONE_PATH + ': patch-mode subscriptions are always served'),
    PortKnob('AMTPU_READ_SNAPSHOT_CACHE', 'readview.snapshot.CACHE_ENTRIES',
             64, False, ''),
    PortKnob('AMTPU_READ_STALENESS_SLO_S',
             'readview.replica.READ_STALENESS_SLO_S', 5.0, False, ''),
    PortKnob('AMTPU_READ_RESYNC_S', 'readview.replica.READ_RESYNC_S', 2.0,
             False, ''),
)

KNOBS = {k.flag: k for k in PORT_KNOBS}

#: flags whose port constant holds the JAX default in another form:
#: flag -> (the constant's value, why it means the same)
PORT_VALUES = {
    'AMTPU_SHARD_MODE': (None, 'None picks the drive mode by core count, '
                               'as the unset flag does'),
    'AMTPU_ESCALATE_BUDGET_MB': (256 << 20, 'bytes; the flag\'s -1 means '
                                            'its built-in 256 MB'),
}

#: the numeric latch defaults the `amtpu_latch_defaults` ABI reports, in
#: ABI order
ABI_LATCH_DEFAULTS = ('AMTPU_RESIDENT_MIN', 'AMTPU_RESCLK_MAX_ACTORS',
                      'AMTPU_RESCLK_MAX_ROWS')


def expected_value(knob):
    """The value `knob.constant` must hold."""
    return PORT_VALUES[knob.flag][0] if knob.flag in PORT_VALUES \
        else knob.default
