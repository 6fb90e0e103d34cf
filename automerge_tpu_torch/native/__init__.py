"""`NativeDocPool`: the C++ host runtime driving the port's device kernels.

The C++ runtime (`native/core.cpp`, loaded through `_lib`) decodes a
msgpack batch {doc_id: [change, ...]}, schedules it causally and encodes
register and list-arena columns (begin); the device resolves every
register, linearizes every list and computes every list index in one
pass (`ops.registers.resolve_rank_dominate`); the C++ mid and emit
phases then write the patch bytes.

A pool runs on one device.  `NativeDocPool()` means CUDA and raises when
there is none; the kernels there are the hand-written CUDA ones.
`NativeDocPool(device='cpu')` runs the same path with the plain PyTorch
version of each kernel.  Nothing switches device or implementation
behind the caller's back.

Per batch (`apply_batch_bytes`):
  phase a: C++ begin, private copies of the C++ columns uploaded to the
    device, one fused dispatch, the packed result copied into pinned
    host memory, and one CUDA event recorded after the last enqueue;
  phase b: wait for that event, C++ mid (fed the packed register words,
    the conflict rows that need them and the dominance indexes), C++
    emit -> patch bytes.
A payload of PIPELINE_MIN_DOCS docs or more is split into PIPELINE_DEPTH
doc-disjoint waves by the C++ FNV doc hash (`_apply_waves`, the JAX
pool's wave pipelining): every wave runs phase a before any wave blocks,
so wave k+1's C++ begin overlaps wave k's kernels; phase b drains the
waves ready-first, and the result maps are concatenated in wave order,
as the JAX pool returns them.
Batches whose layout does not fit the fused dispatch (several dominance
size classes, member-mode overflow, T >= 2^24) resolve registers and
ranks first and run dominance after the mid phase, one dispatch per
size class.  Member-mode rows the host flagged (more concurrent writers
than the window, or one change assigning a key twice) go up the
escalation ladder (`ops.registers.escalate_dispatch_groups`): in phase a
one member-kernel pass per tier chunk right after the base dispatch; in
phase b the tier words merge into the packed word on the device and
only their conflict rows come back.  Groups too wide for every tier or
over the scratch budget are resolved by the C++ oracle replay inside mid
and counted as `fallback.oracle`.
A batch whose list work falls on one long list object (C++ flags it
`resident_ok`) takes the device-resident arena on a CUDA pool
(`_dispatch_resident`, `native/resident.py`): the object's columns stay
on the card between batches, only the batch's new rows and touched
visibility cross, and the sibling sort runs on the card.

Checkpoints (`save`, `load_batch`) are the v2 columnar container by
default, byte for byte the JAX pool's.  `load_batch` restores
arena-direct (`amtpu_begin_columnar`: the blobs decode straight into
C++ arena state, the batch resolves on the host as the JAX pool's
does on every backend) or, with STORAGE_NATIVE = False, replays the
decoded raw changes through the device kernels; either way a v2
checkpoint's settled snapshot is adopted afterwards, so a reloaded doc
keeps its compacted history.  `compact` folds a doc's settled history
prefix into such a snapshot; the queries (`get_missing_changes`,
`get_changes_for_actor_bytes`) splice the snapshot's changes back in
where a requester's clock reaches behind it.

After every batch's emit, C++'s stage CPU times and scheduler counts go
into the trace (`cxx.*` spans, `sched.*` counters).

The dict API (`apply_batch`, `apply_changes`) goes through the
resilience layer (`automerge_tpu_torch.resilience`): an infrastructure
failure is retried, bisected and at worst quarantined as one doc's
error envelope while every healthy doc commits.  The fault sites of
`automerge_tpu_torch.faults` sit where the JAX pool has them.

`ShardedNativePool` spreads docs over independent pools by the C++ FNV
doc hash, driven pipelined (phase a of every shard, then phase b ready-
first) or with one thread per shard (the C++ stages release the GIL);
`restore_from_store` restores a `ColdStore`'s docs onto any pool, one
worker per base pool.
"""

import concurrent.futures
import ctypes
import os
import threading
import time

import msgpack
import numpy as np
import torch

from .. import faults, resilience, storage, telemetry, trace
from ..errors import AutomergeError, RangeError
from ..ops import list_rank
from ..ops import registers as register_ops
from ..ops.dominance_kernel import dominance_grouped_auto
from ..ops.linearize_kernel import linearize_auto
from ..telemetry import attribution, recorder
from ..utils import doc_key, map_header, read_map_header
from ._lib import lib, loaded, take_buf
from .clock_cache import PoolClockCache
from .resident import ResidentCache

#: row count from which the packed word's 24-bit winner field is too
#: narrow: larger batches read the unpacked register outputs and merge
#: the escalation tiers on the host (`_escalate`)
PACKED_ROWS_MAX = 1 << 24
#: the conflict rows of a batch come back as one dense [Tp, W] transfer,
#: sliced on the host, once more than 1 / CONF_DENSE_THRESH of its rows
#: need one; below that, as a row gather on the device (the JAX pool's
#: AMTPU_CONF_DENSE_THRESH)
CONF_DENSE_THRESH = 4
#: waves a pipelined payload splits into (below 2: never split); the JAX
#: pool's default AMTPU_PIPELINE_DEPTH
PIPELINE_DEPTH = 2
#: smallest doc count a payload is split at; the JAX pool's default
#: AMTPU_PIPELINE_MIN_DOCS
PIPELINE_MIN_DOCS = 64
#: the device-resident arena (the JAX pool's AMTPU_RESIDENT): None takes
#: it on a CUDA pool and declines it on a CPU pool, as the JAX pool does
#: on an accelerator and on its CPU backend; True / False force it.  C++
#: decides which batches qualify (its own AMTPU_RESIDENT* knobs latch at
#: the library's first batch)
RESIDENT = None
#: the container `save` writes (the JAX pool's AMTPU_STORAGE_FORMAT):
#: 'columnar' (v2) or 'json' (v1, the raw change history, and no
#: snapshot adopted on load)
STORAGE_FORMAT = 'columnar'
#: most actors a doc's folded clock table holds when a loaded snapshot
#: folds its settled clocks (the JAX pool's AMTPU_FOLDCLK_MAX_ACTORS)
FOLDCLK_MAX_ACTORS = 256
#: fold the op records of settled changes when a snapshot is compacted
#: or adopted (the JAX pool's AMTPU_STORAGE_FOLD)
STORAGE_FOLD = True
#: fold the clock vectors of settled changes likewise (the JAX pool's
#: AMTPU_STORAGE_FOLD_CLOCKS)
STORAGE_FOLD_CLOCKS = True
#: snapshot chunks a doc keeps before `compact` merges them into one
#: (the JAX pool's AMTPU_STORAGE_CHUNK_MAX; 0: never merge)
STORAGE_CHUNK_MAX = 8
#: `load_batch` restores arena-direct (the JAX pool's
#: AMTPU_STORAGE_NATIVE); False replays the decoded raw changes as one
#: batch through the device kernels
STORAGE_NATIVE = True
#: the drive mode of a `ShardedNativePool` built without one
#: ('pipeline' | 'threads'; None: pipeline on a one-core host, threads
#: elsewhere; the JAX pool's AMTPU_SHARD_MODE)
SHARD_MODE = None
#: restore fan-out of `restore_from_store` (0: one worker per core, at
#: most 8; 1: serial; the JAX pool's AMTPU_RESTORE_THREADS)
RESTORE_THREADS = 0
#: docs per restore batch within one base pool (AMTPU_RESTORE_BATCH)
RESTORE_BATCH = 8192

#: the stage CPU times amtpu_batch_trace writes, in its order
_CXX_STAGES = ('decode', 'schedule', 'encode', 'mid', 'emit', 'domlay')

# ---------------------------------------------------------------------------
# batch handles: every successful begin is paired with exactly one free
# ---------------------------------------------------------------------------

_live_lock = threading.Lock()
_live_batches = 0


def _track_begin():
    global _live_batches
    with _live_lock:
        _live_batches += 1


def _free_batch(bh):
    global _live_batches
    L = lib()
    with trace.span('batch.free'):
        L.amtpu_batch_free(bh)
    with _live_lock:
        _live_batches -= 1


def live_batch_handles():
    """Currently allocated C++ batch handles (leak-audit hook)."""
    with _live_lock:
        return _live_batches


def _rollback_batch(bh, exc=None):
    """Rolls a failed batch back to the pre-begin pool state; False when
    emit had already run: the pool state is then suspect, and `exc` is
    marked ``amtpu_state_suspect`` so that no caller replays the batch."""
    if lib().amtpu_batch_rollback(bh) != 0:
        if exc is not None:
            exc.amtpu_state_suspect = True
        trace.metric('resilience.rollback_unavailable')
        recorder.record('batch.rollback', detail='state_suspect')
        return False
    trace.metric('resilience.rollback')
    recorder.record('batch.rollback',
                    detail=type(exc).__name__ if exc is not None else None)
    return True


def _raise_last():
    msg = lib().amtpu_last_error().decode()
    kind = lib().amtpu_last_error_kind()
    if kind == 2:
        raise TypeError(msg)
    raise (RangeError if kind == 1 else AutomergeError)(msg)


def _view(ptr, shape):
    """numpy view of a C++ column (zero-size shapes never touch ptr)."""
    if int(np.prod(shape)) == 0:
        return np.zeros(shape, np.dtype(ptr._type_))
    return np.ctypeslib.as_array(ptr, shape=shape)


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _up(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _to_host(t):
    return np.ascontiguousarray(t.cpu().numpy())


def _cxx_trace(L, bh):
    """The batch's C++ stage CPU times (spans `cxx.*`) and scheduler
    counts (`sched.*`), read after its emit, as the JAX pool emits them."""
    tr = (ctypes.c_double * len(_CXX_STAGES))()
    L.amtpu_batch_trace(bh, tr)
    for name, val in zip(_CXX_STAGES, tr):
        trace.add('cxx.' + name, float(val))
    sc = (ctypes.c_int64 * 4)()
    L.amtpu_sched_counts(bh, sc)
    trace.count('sched.fast_path', int(sc[0]))
    trace.count('sched.queued', int(sc[1]))
    if sc[2]:
        trace.count('sched.trivial_rows', int(sc[2]))
        trace.count('sched.trivial_groups', int(sc[3]))


def _batch_docs(bh, payload):
    """Doc keys of a begun batch, for pinning armed faults (the
    disarmed path never calls this)."""
    if isinstance(payload, tuple):
        head = ctypes.string_at(payload[0], min(payload[1], 16))
    else:
        head = bytes(payload[:16])
    L = lib()
    return [L.amtpu_batch_doc_id(bh, i).decode()
            for i in range(read_map_header(head)[0])]


def _raw_actor_seq(raw):
    """(raw, actor, seq) of one raw change."""
    c = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    if not isinstance(c, dict):
        return raw, None, None
    return raw, c.get('actor'), c.get('seq')


# ---------------------------------------------------------------------------
# ready-first collect over begun batches (waves of one pool, or pools)
# ---------------------------------------------------------------------------

def _ctx_ready(ctx):
    """True once every kernel and copy phase a enqueued for `ctx` has run
    (its CUDA event); a CPU context is always ready."""
    ev = ctx['event']
    return ev is None or ev.query()


def _run_phase_b_entry(key, pool, ctx, on_result=None, on_error=None):
    """Phase b of one (key, pool, ctx) entry: rolls the batch back on
    failure and always frees its handle.  Every device input is a private
    copy, so the C++ batch may be freed while its kernels still run."""
    try:
        result = pool._phase_b(ctx)
        if on_result is not None:
            on_result(key, result)
    except Exception as e:
        _rollback_batch(ctx['bh'], e)
        if on_error is None:
            raise
        on_error(key, e)
    finally:
        _free_batch(ctx['bh'])


def _collect_ready_order(entries, on_result=None, on_error=None):
    """Runs phase b over (key, pool, ctx) entries ready-first: each round
    takes the first entry whose device work has finished, and blocks on
    the oldest only when none has.  Every entry runs to completion
    whatever failed before it (their begins have committed state); errors
    go to `on_error(key, exc)`."""
    pending = list(entries)
    while pending:
        pick = next((i for i, (_k, _p, ctx) in enumerate(pending)
                     if _ctx_ready(ctx)), None)
        if pick is None:
            pick = 0
            trace.metric('collect.wait_in_order')
        elif pick > 0:
            trace.metric('collect.ready_reorder')
        key, pool, ctx = pending.pop(pick)
        _run_phase_b_entry(key, pool, ctx, on_result, on_error)


def apply_payloads_pipelined(pools_payloads):
    """Applies (NativeDocPool, payload bytes) pairs with host/device
    overlap: every pool's begin and dispatch run first (phase a), then
    the results collect ready-first (phase b).  A pool may appear more
    than once.  Pools that began still run to completion when a later one
    fails; the first error is raised afterwards."""
    ctxs = []
    errors = []
    for pool, payload in pools_payloads:
        try:
            ctxs.append((None, pool, pool._start(payload)))
        except Exception as e:
            errors.append(e)
    _collect_ready_order(ctxs, on_error=lambda _k, e: errors.append(e))
    if errors:
        raise errors[0]


def _pool_device(device, name='NativeDocPool'):
    """The torch device a pool (class `name`) runs on: CUDA when `device`
    is None (and an error when there is none), else `device`, which must
    be cuda or cpu."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                '%s() runs on CUDA and no CUDA device is available; pass '
                'device="cpu" for the plain PyTorch versions of the '
                'kernels' % name)
        device = 'cuda'
    device = torch.device(device)
    if device.type not in ('cuda', 'cpu'):
        raise ValueError('%s runs on cuda or cpu, not %s' % (name, device))
    return device


class NativeDocPool:
    """C++ host runtime + the port's device kernels on one device."""

    #: member-window width of the C++ layout (ops.registers.WINDOW)
    WINDOW = register_ops.WINDOW
    #: entries amtpu_batch_dims writes -- must match core.cpp exactly
    N_DIMS = 14

    def __init__(self, device=None):
        self.device = _pool_device(device)
        L = lib()
        with trace.span('pool.new'):
            self._pool = L.amtpu_pool_new()
            # the port is the kernel path on both devices: C++ never
            # takes the full host path
            L.amtpu_pool_set_hostfull(self._pool, 0)
            self._resclk = PoolClockCache(self.device)
            self._resident = ResidentCache(self.device)
        # doc key -> {'frontier', 'chunks'}: the settled snapshot a v2
        # checkpoint brought in, whose changes C++ no longer holds
        self._storage = {}

    def __del__(self):
        # at interpreter shutdown this module's globals may be gone
        L = loaded() if loaded is not None else None
        if getattr(self, '_pool', None) and L is not None:
            with trace.span('pool.free'):
                L.amtpu_pool_free(self._pool)
            self._pool = None

    def doc_count(self):
        return lib().amtpu_doc_count(self._pool)

    # -- wire path ------------------------------------------------------

    def apply_batch_bytes(self, payload):
        """msgpack {doc_id: [change...]} -> msgpack {doc_id: patch}.

        Telemetry as in the JAX pool: a `batch.begin` recorder event, the
        `native` batch latency series (and `batch.commit`) on success,
        and the dispatch/collect flush-phase seams the gateway reads."""
        t0 = time.perf_counter()
        docs = 0
        if isinstance(payload, (bytes, bytearray)):
            try:
                docs = read_map_header(payload)[0]
            except (ValueError, IndexError):
                pass    # malformed: C++ begin raises its typed error
        recorder.record('batch.begin', n=docs)
        out = None
        # armed faults pin exact single-batch rollback semantics: no waves,
        # as in the JAX pool
        if docs >= max(2, PIPELINE_MIN_DOCS) and PIPELINE_DEPTH >= 2 \
                and not faults.ARMED:
            try:
                out = self._apply_waves(payload, docs)
            except Exception as e:
                if getattr(e, 'amtpu_state_suspect', False):
                    raise
                # every wave rolled back before emit: the serial replay
                # raises a multi-error payload's FIRST error in
                # application order, whatever the waves' hash order
                trace.metric('pipeline.serial_replay')
        if out is None:
            t_begin = time.perf_counter()
            out = self._run_batch(*self._begin(payload), t0=t_begin)
        telemetry.observe_batch('native', time.perf_counter() - t0,
                                docs=docs)
        return out

    def _begin(self, payload):
        """C++ begin over msgpack bytes or a (ctypes pointer, length) pair
        (a wave's or shard's buffer, passed without a copy: begin copies
        what it keeps).  Returns (the tracked batch handle, the batch's
        doc keys when faults are armed, else None)."""
        data, n = payload if isinstance(payload, tuple) else \
            (payload, len(payload))
        with trace.span('host.begin'):
            bh = lib().amtpu_begin(self._pool, data, n)
        if not bh:
            _raise_last()
        _track_begin()
        fault_docs = None
        if faults.ARMED:
            fault_docs = _batch_docs(bh, payload)
            self._fire_begin(bh, fault_docs)
        return bh, fault_docs

    @staticmethod
    def _fire_begin(bh, fault_docs):
        """The `native.begin` site: a fault there leaves the pool as a
        failed begin would, rolled back and the handle freed."""
        try:
            faults.fire('native.begin', fault_docs)
        except Exception as e:
            _rollback_batch(bh, e)
            _free_batch(bh)
            raise

    def _start(self, payload):
        """Begin + phase a; a phase-a failure rolls the batch back and
        frees it.  Returns the context phase b takes."""
        bh, fault_docs = self._begin(payload)
        try:
            return self._phase_a(bh, fault_docs)
        except Exception as e:
            _rollback_batch(bh, e)
            _free_batch(bh)
            raise

    def _apply_waves(self, payload, docs):
        """The payload split into doc-disjoint waves (the C++ FNV doc
        hash), every wave's begin and dispatch before any wave blocks,
        phase b ready-first, the result maps concatenated in wave order.
        Doc-disjointness makes the interleaved begins sound: begin's
        journal and arenas are doc-scoped, and the pool's intern and
        clock tables only grow (each wave's context holds the clock table
        its kernels read, so a later wave's full upload cannot free it).

        A phase-a error rolls every begun wave back in reverse begin
        order: nothing has emitted, so the call stays atomic.  A phase-b
        error lets the other waves finish, and the raised error is marked
        ``amtpu_state_suspect`` when any wave committed."""
        L = lib()
        depth = min(PIPELINE_DEPTH, docs)
        with trace.span('pipeline.split'):
            sp = L.amtpu_shard_split(payload, len(payload), depth)
            if not sp:
                _raise_last()
        try:
            subs = []
            for s in range(depth):
                n = ctypes.c_int64()
                ptr = L.amtpu_shard_buf(sp, s, ctypes.byref(n))
                if n.value > 1:         # 1 byte: the empty map
                    subs.append((ctypes.cast(ptr, ctypes.c_char_p), n.value))
            ctxs = []
            t_a0 = None
            t_loop0 = time.perf_counter()
            try:
                for i, sub in enumerate(subs):
                    ctxs.append((i, self, self._start(sub)))
                    if i == 0:
                        t_a0 = time.perf_counter()
            except Exception as e:
                for _i, _p, ctx in reversed(ctxs):
                    _rollback_batch(ctx['bh'], e)
                    _free_batch(ctx['bh'])
                raise
            if len(ctxs) > 1:
                # begin + dispatch of the waves after the first: host work
                # that ran while wave 0's kernels were in flight
                trace.metric('collect.overlap_s', time.perf_counter() - t_a0)
            trace.metric('pipeline.batches')
            trace.metric('pipeline.waves', len(ctxs))
            t_disp = time.perf_counter()
            attribution.note_flush_phase('dispatch', t_disp - t_loop0)
            recorder.record('wave.dispatch', n=len(ctxs))
            results = [None] * len(ctxs)
            errors = []
            _collect_ready_order(ctxs, on_result=results.__setitem__,
                                 on_error=lambda i, e: errors.append(e))
            attribution.note_flush_phase('collect',
                                         time.perf_counter() - t_disp)
            recorder.record('wave.collect', n=len(ctxs))
            if errors:
                err = errors[0]
                if any(r is not None for r in results) or any(
                        getattr(e, 'amtpu_state_suspect', False)
                        for e in errors):
                    err.amtpu_state_suspect = True
                raise err
            total = 0
            bodies = []
            for r in results:
                cnt, off = read_map_header(r)
                total += cnt
                bodies.append(memoryview(r)[off:])
            return map_header(total) + b''.join(bodies)
        finally:
            with trace.span('batch.free'):
                L.amtpu_shard_free(sp)

    def apply_local_change(self, doc_id, request):
        """Applies one local change request (requestType change / undo /
        redo) and returns its patch."""
        key = doc_key(doc_id)
        payload = msgpack.packb(request, use_bin_type=True)
        with trace.span('host.begin'):
            bh = lib().amtpu_begin_local(self._pool, key.encode(), payload,
                                         len(payload))
        if not bh:
            _raise_last()
        _track_begin()
        fault_docs = [key] if faults.ARMED else None
        if fault_docs:
            self._fire_begin(bh, fault_docs)
        out = self._run_batch(bh, fault_docs)
        return msgpack.unpackb(out, raw=False, strict_map_key=False)[key]

    def _run_batch(self, bh, fault_docs=None, t0=None):
        """Phase a + b over a begun batch, unpipelined; rolls back on
        failure and always frees the handle.  The flush-phase seams split
        the wall at the phase boundary: `dispatch` = begin (from `t0`)
        and the enqueue of the device work, `collect` = the wait on the
        card (the CUDA event's synchronize) and the host mid and emit."""
        t0 = time.perf_counter() if t0 is None else t0
        try:
            ctx = self._phase_a(bh, fault_docs)
            t1 = time.perf_counter()
            attribution.note_flush_phase('dispatch', t1 - t0)
            try:
                return self._phase_b(ctx)
            finally:
                attribution.note_flush_phase('collect',
                                             time.perf_counter() - t1)
        except Exception as e:
            _rollback_batch(bh, e)
            raise
        finally:
            _free_batch(bh)

    def _upload(self, view, dtype=None):
        """Private host copy of a C++ column, then the device upload, in
        one span: the C++ buffers never back a tensor (they are freed
        with the batch)."""
        return register_ops.upload(view, self.device, copy=True, dtype=dtype)

    def _phase_a(self, bh, fault_docs=None):
        """Reads the batch dims and dispatches the device work; the
        context's `event` is recorded after the last enqueue, whatever the
        route (None on the CPU).  `fault_docs` are the doc keys armed
        faults pin to."""
        L = lib()
        ctx = {'bh': bh, 'event': None, 'fault_docs': fault_docs}
        dims = (ctypes.c_int64 * self.N_DIMS)()
        L.amtpu_batch_dims(bh, dims)
        (T, Tp, A, Ap, Larena, Lp, n_blocks, max_obj, CTp, use_members,
         any_ovf, max_group, pre_ovf, host_full) = [int(x) for x in dims]
        if host_full:
            raise AutomergeError('batch pinned to the host path; the '
                                 'port drives the kernel path only')
        fdims = (ctypes.c_int64 * 6)()
        L.amtpu_fused_dims(bh, fdims)
        fused_ok, W, dLp, dTp, resident_ok, res_clock = \
            [int(x) for x in fdims]
        trace.count('ops.register_rows', T)
        # C++ builds member windows once a register group is wider than
        # WINDOW.  A sliding window that covers the widest group is exact
        # and cannot saturate, so up to SLIDING_MAX the register kernel
        # resolves the batch in sliding mode in one pass and the member
        # layout (whose host overflow flags would send rows up the
        # escalation ladder) goes unused.
        # The C++ batch still holds use_members, any_ovf, n_pre_ovf,
        # mem_idx/host_ovf and the escalation layout it built at begin.
        # They only shaped begin's own choices (fused_ok, the resident
        # arena): mid, the oracle replay and emit read the overflow flags
        # this driver passes (k_overflow), and it passes none here, so the
        # stale member state is never read.  The member windows are still
        # built in begin; skipping them belongs in core.cpp (ROADMAP).
        if use_members and max_group <= register_ops.SLIDING_MAX:
            trace.count('registers.sliding_over_members')
            use_members = 0
        mem = hovf = None
        if use_members and Tp > 0:
            with trace.span('host.columns'):
                mem = _view(L.amtpu_col_memidx(bh), (Tp, self.WINDOW))
                hovf = np.array(_view(L.amtpu_col_hostovf(bh), (Tp,)))
        # the smallest power of two that holds the widest group: a sliding
        # window of weff predecessors never fills (no overflow flag)
        if use_members:
            weff = self.WINDOW
        else:
            weff = 2
            while weff < max_group:
                weff *= 2
        ctx.update(dims=(T, Tp, A, Ap, Larena, Lp, n_blocks, max_obj, CTp),
                   mem=mem, hovf=hovf, weff=weff, resident_ok=resident_ok)
        if res_clock and Tp > 0:
            ctx['ctab_dev'] = self._resclk.table(L, self._pool)
            stats = (ctypes.c_int64 * 2)()
            L.amtpu_resclk_batch_stats(bh, stats)
            if stats[0]:
                trace.metric('resident.batch_hit_rows', int(stats[0]))
        elif not res_clock:
            self._resclk.drop_if_disabled(L, self._pool)
        if faults.ARMED:
            faults.fire('device.dispatch', fault_docs)
        dev_t0 = self._devtime_start()
        with trace.span('device.dispatch'):
            if fused_ok:
                self._dispatch_fused(L, ctx, Tp, Ap, CTp, Lp, max_obj,
                                     n_blocks, W, dLp, dTp)
            else:
                trace.metric('fallback.layout_batches')
                reg_out, rank = self._run_resolver(
                    L, bh, Tp, Ap, CTp, Lp, max_obj, ctx)
                ctx.update(mode='old', reg_out=reg_out, rank=rank)
                # member-mode overflow flags come from the host, so the
                # escalation tiers launch right behind the base dispatch
                # and are collected in phase b
                if hovf is not None and hovf.any():
                    ctx['esc'] = self._escalation_dispatch(L, ctx)
        if self.device.type == 'cuda':
            ctx['event'] = torch.cuda.Event(enable_timing=dev_t0 is not None)
            ctx['event'].record()
            ctx['dev_t0'] = dev_t0
        else:
            self._devtime_end(dev_t0)
        return ctx

    def _devtime_start(self):
        """The start of one timed dispatch under `telemetry.DEVTIME`: a
        CUDA event recorded on a card pool, the host clock on a CPU pool
        (where the dispatch runs synchronously); None while it is off."""
        if not telemetry.devtime_on():
            return None
        if self.device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            return start
        return time.perf_counter()

    def _devtime_end(self, start, end=None):
        """Closes a dispatch `_devtime_start` opened: on a card pool the
        card's time from the start event to `end` (recorded here when not
        given), waited for; on a CPU pool the host time since `start`."""
        if start is None:
            return
        if self.device.type == 'cuda':
            if end is None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = time.perf_counter() - start
        telemetry.observe_device_dispatch(seconds)

    def _register_views(self, L, bh, Tp, Ap, CTp, ctab_dev=None):
        """The register columns on the device.  `ctab_dev` (the pool-
        resident clock table) replaces the batch-local table when the
        batch was encoded against pool-global clock rows (CTp == 0)."""
        with trace.span('host.columns'):
            views = {k: _view(getattr(L, 'amtpu_col_' + c)(bh), (Tp,))
                     for k, c in (('g', 'g'), ('t', 't'), ('a', 'a'),
                                  ('s', 's'), ('cidx', 'clockidx'),
                                  ('si', 'sort'))}
            d = _view(L.amtpu_col_d(bh), (Tp,))
            if ctab_dev is None:
                ctab = _view(L.amtpu_col_clocktab(bh), (CTp, Ap))
        cols = {k: self._upload(v) for k, v in views.items()}
        cols['d'] = self._upload(d, bool)
        cols['ctab'] = self._upload(ctab) if ctab_dev is None else ctab_dev
        return cols

    def _arena_views(self, L, bh, Lp):
        """The list-arena columns on the device."""
        with trace.span('host.columns'):
            views = {k: _view(getattr(L, 'amtpu_col_' + c)(bh), (Lp,))
                     for k, c in (('obj', 'obj'), ('par', 'par'),
                                  ('ctr', 'ctr'), ('act', 'act'),
                                  ('lsi', 'linsort'))}
            val = _view(L.amtpu_col_val(bh), (Lp,))
        cols = {k: self._upload(v) for k, v in views.items()}
        cols['val'] = self._upload(val, bool)
        return cols

    def _fetch_async(self, ctx, t):
        """Starts the device->host copy of `t` into pinned memory (phase
        b reads it after the context's event)."""
        with trace.span('device.launch'):
            if self.device.type == 'cuda':
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                ctx['combo_host'] = host
            else:
                ctx['combo_host'] = t

    def _dispatch_fused(self, L, ctx, Tp, Ap, CTp, Lp, max_obj, n_blocks,
                        W, dLp, dTp):
        bh = ctx['bh']
        ctx.update(mode='fused', combo=None, reg_out=None, rank=None)
        if Tp == 0:
            # no register ops: nothing to resolve and no list timelines
            return
        r = self._register_views(L, bh, Tp, Ap, CTp, ctx.get('ctab_dev'))
        mem = ctx['mem']
        mem_dev = None if mem is None else self._upload(mem)
        if n_blocks == 0:
            # map-only batch: register resolution alone
            with trace.span('device.launch'):
                reg_out = register_ops._resolve(
                    r['g'], r['t'], r['a'], r['s'], r['ctab'], r['cidx'],
                    r['d'], r['si'], mem_dev, ctx['weff'],
                    want_visible_before=False)
            combo = reg_out['packed']
        elif ctx['resident_ok'] and mem is None and self._dispatch_resident(
                L, ctx, r, max_obj, dLp, dTp):
            return
        else:
            e = self._arena_views(L, bh, Lp)
            n_iters = list_rank.ceil_log2(max(max_obj, 1)) + 1
            shape_l, shape_t = (W, dLp), (W, dTp)
            with trace.span('host.columns'):
                # v0 and er_src fill lazily in C++ on first read
                dom = [_view(L.amtpu_dom_v0(bh, 0), shape_l),
                       _view(L.amtpu_fdom_ersrc(bh), shape_l),
                       _view(L.amtpu_dom_oe(bh, 0), shape_t),
                       _view(L.amtpu_fdom_oranksrc(bh), shape_t),
                       _view(L.amtpu_fdom_domsrc(bh), shape_t)]
                ov = _view(L.amtpu_dom_ov(bh, 0), shape_t)
            dom = [self._upload(v) for v in dom] + [self._upload(ov, bool)]
            with trace.span('device.launch'):
                reg_out, rank, combo = register_ops.resolve_rank_dominate(
                    r['g'], r['t'], r['a'], r['s'], r['ctab'], r['cidx'],
                    r['d'], r['si'], e['obj'], e['par'], e['ctr'], e['act'],
                    e['val'], e['lsi'], n_iters, *dom,
                    window=ctx['weff'], mem_idx=mem_dev)
            ctx['rank'] = rank
        self._fetch_async(ctx, combo)
        ctx.update(combo=combo, reg_out=reg_out)

    def _resident_on(self):
        return self.device.type == 'cuda' if RESIDENT is None \
            else bool(RESIDENT)

    def _dispatch_resident(self, L, ctx, r, max_obj, dLp, dTp):
        """The fused dispatch over the device-resident arena of the
        batch's one list object: only the per-batch rows are uploaded.
        Returns False, before any device work, where the JAX pool
        declines too (the route is off, the object does not start the
        batch layout, its length is out of range, or C++ has no raw
        arena); the standard fused path then runs with the same
        kernels."""
        if not self._resident_on():
            return False
        bh = ctx['bh']
        meta = (ctypes.c_int64 * 4)()
        with trace.span('host.columns'):
            L.amtpu_dom_obj_meta(bh, 0, meta)
            doc_idx, obj_sid, base, n_now = [int(x) for x in meta]
            if base != 0 or n_now <= 0 or n_now > dLp:
                return False
            doc_id = L.amtpu_batch_doc_id(bh, doc_idx)
        entry = self._resident.get_entry(L, self._pool, doc_id, obj_sid,
                                         n_now, dLp)
        if entry is None:
            return False
        with trace.span('host.columns'):
            oe_v = _view(L.amtpu_dom_oe(bh, 0), (1, dTp))
            ds_v = _view(L.amtpu_fdom_domsrc(bh), (1, dTp))
            ov_v = _view(L.amtpu_dom_ov(bh, 0), (1, dTp))
        oe, dom_src = self._upload(oe_v), self._upload(ds_v)
        ov = self._upload(ov_v, bool)
        n_iters = list_rank.ceil_log2(max(max_obj, 1)) + 1
        # dirty until the post-emit visibility sync: a batch that fails
        # in between leaves the device visibility unsynced
        entry.dirty = True
        if self._resident.sp_blocks(dLp, count=True) is not None:
            # a MeshDocPool(dp=1, sp>1) past the sp fence: the element
            # axis sharded over the sp blocks (get_entry placed them)
            resolve = register_ops.resolve_rank_dominate_resident_sharded
            trace.count('resident.sharded_dispatch')
        else:
            resolve = register_ops.resolve_rank_dominate_resident
        with trace.span('device.launch'):
            reg_out, rank, combo = resolve(
                r['g'], r['t'], r['a'], r['s'], r['ctab'], r['cidx'],
                r['d'], r['si'], entry.par, entry.ctr, entry.act, entry.ev,
                n_now, oe, dom_src, ov, n_iters=n_iters, window=ctx['weff'])
        self._fetch_async(ctx, combo)
        # the batch (and so the views) lives until its emit
        touched = np.unique(oe_v[0][(ov_v[0] != 0) & (oe_v[0] >= 0)]
                            ).astype(np.int32)
        ctx.update(combo=combo, reg_out=reg_out, rank=rank,
                   resident=(entry, doc_id, obj_sid, n_now, touched))
        trace.count('resident.dispatch')
        trace.metric('resident.dispatches')
        return True

    def _mark_resident_stale(self, L, ctx):
        """Marks the resident entry of every list object this non-resident
        batch touched as dirty: its emit changed C++ visibility without a
        device sync."""
        bh = ctx['bh']
        bdims = (ctypes.c_int64 * 3)()
        for blk in range(ctx['dims'][6]):
            L.amtpu_dom_dims(bh, blk, bdims)
            meta = (ctypes.c_int64 * (4 * int(bdims[0])))()
            for o in range(int(L.amtpu_dom_obj_meta(bh, blk, meta))):
                doc_id = L.amtpu_batch_doc_id(bh, int(meta[o * 4]))
                entry = self._resident.entries.get(
                    (doc_id, int(meta[o * 4 + 1])))
                if entry is not None:
                    entry.dirty = True
                    trace.count('resident.cross_path_invalidation')

    def _phase_b(self, ctx):
        """Collect device results, run host mid + emit, return patch bytes."""
        L = lib()
        bh = ctx['bh']
        if faults.ARMED:
            # both sites fire before their phase mutates anything, so a
            # rollback and re-apply reproduce the fault-free bytes.  The
            # kernels phase a enqueued may still be running: every device
            # input is a private copy (`ops.registers.upload`), so the
            # C++ batch may be rolled back and freed under them
            faults.fire('device.collect', ctx['fault_docs'])
            faults.fire('native.mid', ctx['fault_docs'])
        if ctx.get('dev_t0') is not None:
            self._devtime_end(ctx['dev_t0'], ctx['event'])
        T, Tp, A, Ap, Larena, Lp, n_blocks, max_obj, CTp = ctx['dims']
        if ctx['mode'] == 'fused':
            with trace.span('device.collect'):
                if ctx['combo'] is None:
                    packed = dom_idx = np.zeros(0, np.int32)
                else:
                    if ctx['event'] is not None:
                        ctx['event'].synchronize()
                    combo = ctx['combo_host'].numpy()
                    packed = np.ascontiguousarray(combo[:Tp])
                    dom_idx = np.ascontiguousarray(combo[Tp:])
                # no row can be flagged: a sliding window holds the widest
                # group, member mode flags nothing on the device, and host-
                # flagged member overflow sends the batch to the layout
                # fallback
                if ((packed >> register_ops.PACKED_OVF_SHIFT) & 1).any():
                    raise AssertionError('a register row was flagged '
                                         'overflow on the fused path')
                conf_rows = np.nonzero(
                    ((packed >> register_ops.PACKED_ALIVE_SHIFT)
                     & register_ops.PACKED_ALIVE_MASK) > 1)[0].astype(
                         np.int32)
                conf_vals = self._fetch_conflict_rows(ctx['reg_out'],
                                                      conf_rows, Tp)
            conf_offs = np.arange(conf_rows.size + 1,
                                  dtype=np.int32) * ctx['weff']
            with trace.span('host.mid'):
                if L.amtpu_mid_packed(
                        bh, _ip(packed), ctx['weff'], _ip(conf_rows),
                        _ip(conf_offs), _ip(conf_vals), len(conf_rows),
                        None, None, _ip(dom_idx), 0) != 0:
                    _raise_last()
        elif Tp > 0 and ctx['hovf'] is not None and Tp < PACKED_ROWS_MAX:
            # packed member epilogue: one [Tp] word (the tier results
            # merged into it on the device) and a sparse CSR of conflict
            # rows at per-row widths; only the ladder's residue rides the
            # oracle replay
            with trace.span('device.collect'):
                packed, conf_rows, conf_offs, conf_vals, residual = \
                    self._collect_member_packed(ctx, ctx['reg_out'], Tp)
                rank = np.ascontiguousarray(ctx['rank'], np.int32)
            trace.metric('collect.packed_member_batches')
            with trace.span('host.mid'):
                if L.amtpu_mid_packed(
                        bh, _ip(packed), ctx['weff'], _ip(conf_rows),
                        _ip(conf_offs), _ip(conf_vals), len(conf_rows),
                        None if residual is None else _up(residual),
                        _ip(rank), None, 0) != 0:
                    _raise_last()
            self._run_dominance(L, bh)
        else:
            with trace.span('device.collect'):
                if Tp > 0:
                    trace.metric('collect.full_matrix_readback')
                    winner, conflicts, alive, overflow = \
                        self._unpack_register_out(ctx['reg_out'], Tp)
                    if ctx['hovf'] is not None:
                        # member mode: overflow is decided by the host
                        overflow = ctx['hovf'].astype(np.uint8)
                        n_ovf = int(overflow.sum())
                        if n_ovf:
                            trace.metric('fallback.member_overflow_rows',
                                         n_ovf)
                            trace.metric('fallback.overflow_batches')
                            winner, conflicts, alive, overflow = \
                                self._escalate(ctx, winner, conflicts, alive,
                                               overflow)
                    elif overflow.any():
                        raise AssertionError('a register row was flagged '
                                             'overflow in sliding mode')
                else:
                    winner = conflicts = alive = np.zeros(0, np.int32)
                    overflow = np.zeros(0, np.uint8)
                rank = ctx['rank']
            self._mid(L, bh, winner, conflicts, alive, overflow, rank,
                      self._mid_window(ctx, conflicts))
            self._run_dominance(L, bh)
        return self._emit(L, ctx)

    def _emit(self, L, ctx):
        """C++ emit, the resident arena's upkeep after it and the C++
        stage trace; returns the patch bytes."""
        bh = ctx['bh']
        with trace.span('host.finish'):
            if L.amtpu_finish(bh) != 0:
                _raise_last()
        if ctx.get('resident') is not None:
            # post-emit visibility sync from the C++ arena
            self._resident.sync_after_emit(L, self._pool, *ctx['resident'])
        elif self._resident.entries:
            self._mark_resident_stale(L, ctx)
        _cxx_trace(L, bh)
        out_len = ctypes.c_int64()
        ptr = L.amtpu_result(bh, ctypes.byref(out_len))
        return ctypes.string_at(ptr, out_len.value) \
            if out_len.value else b'\x80'

    @staticmethod
    def _count_oracle(overflow):
        """Counts the rows still flagged after the escalation ladder: the
        groups wider than every tier or over the scratch budget, which
        the C++ oracle replay in amtpu_mid resolves.  Returns the count."""
        n_oracle = int(np.asarray(overflow, bool).sum())
        if n_oracle:
            trace.metric('fallback.oracle', n_oracle)
        return n_oracle

    @staticmethod
    def _mid_window(ctx, conflicts):
        """Conflicts-matrix width handed to amtpu_mid: the escalation
        merge may have widened it beyond the dispatch window."""
        return int(conflicts.shape[1]) if conflicts.ndim == 2 \
            else ctx['weff']

    def _mid(self, L, bh, winner, conflicts, alive, overflow, rank, width):
        winner = np.ascontiguousarray(winner, np.int32)
        conflicts = np.ascontiguousarray(conflicts, np.int32)
        alive = np.ascontiguousarray(alive, np.int32)
        overflow = np.ascontiguousarray(overflow, np.uint8)
        rank = np.ascontiguousarray(rank, np.int32)
        with trace.span('host.mid'):
            if L.amtpu_mid(bh, _ip(winner), _ip(conflicts), width,
                           _ip(alive), _up(overflow), _ip(rank), 0) != 0:
                _raise_last()

    def _gather_conflict_rows(self, reg_out, rows):
        """Conflict rows only where a register kept >1 member, gathered on
        the device.  Returns [n, W] int32."""
        if not rows.size:
            return np.zeros(0, np.int32)
        got = register_ops.gather_rows(
            reg_out['conflicts'], register_ops.upload(rows, self.device))
        return _to_host(got).astype(np.int32)

    def _gather_conflicts(self, reg_out, alive, Tp):
        """Dense [Tp, W] conflicts, -1 where a register kept <= 1 member."""
        width = int(reg_out['conflicts'].shape[1])
        conflicts = np.full((Tp, width), -1, np.int32)
        rows = np.nonzero(alive > 1)[0].astype(np.int32)
        if rows.size:
            conflicts[rows] = self._gather_conflict_rows(reg_out, rows)
        return conflicts

    def _unpack_register_out(self, reg_out, Tp):
        """Host winner/conflicts/alive/overflow: one packed transfer plus
        the conflict rows that need it; the unpacked outputs once the
        packed winner field (24 bits) is too narrow."""
        if Tp >= PACKED_ROWS_MAX:
            return (_to_host(reg_out['winner']),
                    _to_host(reg_out['conflicts']),
                    _to_host(reg_out['alive_after']),
                    _to_host(reg_out['overflow']).astype(np.uint8))
        winner, alive, overflow = self._unpack_packed(
            _to_host(reg_out['packed']))
        return winner, self._gather_conflicts(reg_out, alive, Tp), alive, \
            overflow

    @staticmethod
    def _unpack_packed(packed):
        """Splits the packed [T] int32 register word (decode twin of
        ops.registers.pack_register_word)."""
        winner = np.ascontiguousarray(
            packed & register_ops.PACKED_WINNER_MASK, np.int32)
        winner[winner == register_ops.PACKED_WINNER_NONE] = -1
        alive = np.ascontiguousarray(
            (packed >> register_ops.PACKED_ALIVE_SHIFT)
            & register_ops.PACKED_ALIVE_MASK, np.int32)
        overflow = np.ascontiguousarray(
            (packed >> register_ops.PACKED_OVF_SHIFT) & 1, np.uint8)
        return winner, alive, overflow

    # -- the escalation ladder ------------------------------------------

    @staticmethod
    def _esc_layout_groups(L, bh):
        """CSR group records (rows, lens, vals, width) from the escalation
        layout C++ built at begin for member-mode overflow, read through
        private copies (the C++ buffers go with the batch)."""
        dims = (ctypes.c_int64 * 3)()
        L.amtpu_esc_dims(bh, dims)
        n_groups, R, M = [int(x) for x in dims]
        if n_groups == 0:
            return []
        meta = np.array(_view(L.amtpu_esc_group_meta(bh), (n_groups, 3)))
        rows_all = np.array(_view(L.amtpu_esc_rows(bh), (R,)))
        off = np.array(_view(L.amtpu_esc_mem_off(bh), (R + 1,)))
        vals_all = np.array(_view(L.amtpu_esc_mem(bh), (M,)))
        groups = []
        for rs, k, width in meta.tolist():
            groups.append((rows_all[rs:rs + k], np.diff(off[rs:rs + k + 1]),
                           vals_all[off[rs]:off[rs + k]], width))
        return groups

    def _escalation_dispatch(self, L, ctx):
        """Tier-ladder dispatch for the batch's flagged rows over the
        escalation layout C++ built at begin: it builds one whenever a row
        is flagged, with a group record for every flagged group.  Columns
        are private host copies; the tiers read the base dispatch's device
        clock table."""
        bh = ctx['bh']
        Tp = ctx['dims'][1]
        groups = self._esc_layout_groups(L, bh)
        if not groups:
            raise AssertionError('member rows are flagged but C++ built no '
                                 'escalation layout')
        col = {k: np.array(_view(getattr(L, 'amtpu_col_' + c)(bh), (Tp,)))
               for k, c in (('t', 't'), ('a', 'a'), ('s', 's'),
                            ('cidx', 'clockidx'))}
        is_del = np.array(_view(L.amtpu_col_d(bh), (Tp,)), bool)
        return register_ops.escalate_dispatch_groups(
            groups, col['t'], col['a'], col['s'], is_del, ctx['ctab'],
            col['cidx'], want_visible_before=False)

    def _escalate(self, ctx, winner, conflicts, alive, overflow):
        """The ladder on the full-matrix route (Tp >= PACKED_ROWS_MAX):
        collects the tiers phase a dispatched and merges them into the
        host arrays, clearing the flags of the rows they resolved.  Rows
        still flagged take the oracle replay."""
        esc = ctx.pop('esc')
        chunks = register_ops.escalate_overflow_collect_arrays(esc[0])
        if chunks:
            winner, conflicts, alive, overflow = \
                register_ops.merge_escalated_arrays(
                    np.array(winner, np.int32), np.array(conflicts, np.int32),
                    np.array(alive, np.int32), np.array(overflow, np.uint8),
                    chunks)
        self._count_oracle(overflow)
        return winner, conflicts, alive, overflow

    def _collect_member_packed(self, ctx, reg_out, Tp):
        """Packed member epilogue: each tier chunk's packed words scatter
        into the base word on the device (`merge_packed_rows`), ONE [Tp]
        word comes back, and the conflict rows that need it (base rows
        outside flagged groups, tier rows) come back as a CSR at per-row
        widths.  Rows the ladder could not hold stay flagged in the
        residual vector for the oracle replay.

        Returns (packed [Tp] int32, conf_rows, conf_offs, conf_vals,
        residual uint8 [Tp] | None)."""
        flagged = ctx['hovf'].astype(bool)
        residual = None
        pending = []
        if flagged.any():
            trace.metric('fallback.member_overflow_rows', int(flagged.sum()))
            trace.metric('fallback.overflow_batches')
            pending = ctx.pop('esc')[0]
        base = reg_out['packed']
        for _W, sub_rows, out in pending:
            rows = register_ops.upload(np.asarray(sub_rows, np.int64),
                                       self.device)
            register_ops.merge_packed_rows(base, rows, out['packed'])
        if pending:
            trace.metric('collect.device_merge_chunks', len(pending))
        packed = _to_host(base)
        esc_parts = []            # (global rows, global conflicts) pairs
        if flagged.any():
            residual = ctx['hovf'].astype(np.uint8)
            for ch in register_ops.escalate_overflow_collect_arrays(
                    pending, need_winner=False):
                residual[ch.rows] = 0
                if ch.conf_rows.size:
                    esc_parts.append((ch.rows[ch.conf_rows], ch.conflicts))
            if not self._count_oracle(residual):
                residual = None
        # base conflict rows: registers outside flagged groups that kept
        # more than one member (a flagged group's base output is void: it
        # resolved in the tiers or takes the oracle)
        base_mask = ((packed >> register_ops.PACKED_ALIVE_SHIFT)
                     & register_ops.PACKED_ALIVE_MASK) > 1
        base_mask &= ~flagged
        conf_rows_b = np.nonzero(base_mask)[0].astype(np.int32)
        conf_vals_b = self._fetch_conflict_rows(reg_out, conf_rows_b, Tp)
        weff = ctx['weff']
        rows_parts = [conf_rows_b]
        vals_parts = [np.ascontiguousarray(conf_vals_b, np.int32).reshape(-1)]
        lens = [np.full(conf_rows_b.size, weff, np.int32)]
        for rows_g, conf_g in esc_parts:
            rows_parts.append(np.ascontiguousarray(rows_g, np.int32))
            vals_parts.append(np.ascontiguousarray(conf_g,
                                                   np.int32).reshape(-1))
            lens.append(np.full(rows_g.size, conf_g.shape[1], np.int32))
        conf_rows = np.ascontiguousarray(np.concatenate(rows_parts), np.int32)
        conf_offs = np.zeros(conf_rows.size + 1, np.int32)
        np.cumsum(np.concatenate(lens), out=conf_offs[1:])
        conf_vals = np.ascontiguousarray(np.concatenate(vals_parts), np.int32)
        return packed, conf_rows, conf_offs, conf_vals, residual

    def _fetch_conflict_rows(self, reg_out, conf_rows, Tp):
        """Conflict rows of a batch: a row gather on the device while
        they are rare, the whole [Tp, W] matrix sliced on the host once
        more than Tp / CONF_DENSE_THRESH rows need one.  Each choice is
        counted: collect.conflict_sparse / collect.conflict_dense."""
        if conf_rows.size * CONF_DENSE_THRESH > Tp:
            trace.metric('collect.conflict_dense')
            return np.ascontiguousarray(
                _to_host(reg_out['conflicts'])[conf_rows], np.int32)
        if conf_rows.size:
            trace.metric('collect.conflict_sparse')
        return self._gather_conflict_rows(reg_out, conf_rows)

    def _run_resolver(self, L, bh, Tp, Ap, CTp, Lp, max_obj, ctx):
        """Registers + ranks for the layout-fallback path.  Returns
        (reg_out device dict | None, rank host int32 [Lp])."""
        mem = ctx['mem']
        reg_out = None
        if Tp > 0:
            r = self._register_views(L, bh, Tp, Ap, CTp, ctx.get('ctab_dev'))
            mem_dev = None if mem is None else self._upload(mem)
            ctx['ctab'] = r['ctab']          # the escalation tiers read it
        if Lp > 0:
            e = self._arena_views(L, bh, Lp)
            n_iters = list_rank.ceil_log2(max(max_obj, 1)) + 1
        with trace.span('device.launch'):
            if Tp > 0 and Lp > 0:
                reg_out, rank_dev = register_ops.resolve_and_rank(
                    r['g'], r['t'], r['a'], r['s'], r['ctab'], r['cidx'],
                    r['d'], r['si'], e['obj'], e['par'], e['ctr'], e['act'],
                    e['val'], e['lsi'], n_iters, window=ctx['weff'],
                    mem_idx=mem_dev)
            elif Tp > 0:
                reg_out = register_ops._resolve(
                    r['g'], r['t'], r['a'], r['s'], r['ctab'], r['cidx'],
                    r['d'], r['si'], mem_dev, ctx['weff'],
                    want_visible_before=False)
            elif Lp > 0:
                rank_dev = linearize_auto(
                    e['obj'], e['par'], e['ctr'], e['act'], e['val'],
                    n_iters, sort_idx=e['lsi'])
        rank = _to_host(rank_dev) if Lp > 0 else np.zeros((0,), np.int32)
        return reg_out, rank

    def _run_dominance(self, L, bh):
        """Layout-fallback dominance: one dispatch per size class over the
        er/orank/od mirrors C++ filled in mid."""
        dims = (ctypes.c_int64 * self.N_DIMS)()
        L.amtpu_batch_dims(bh, dims)
        bdims = (ctypes.c_int64 * 3)()
        dev_t0 = self._devtime_start()
        with trace.span('device.dominance'):
            for blk in range(int(dims[6])):
                L.amtpu_dom_dims(bh, blk, bdims)
                W, Lp, Tp = [int(x) for x in bdims]
                sl, st = (W, Lp), (W, Tp)
                idx = _to_host(dominance_grouped_auto(
                    self._upload(_view(L.amtpu_dom_v0(bh, blk), sl)),
                    self._upload(_view(L.amtpu_dom_er(bh, blk), sl)),
                    self._upload(_view(L.amtpu_dom_oe(bh, blk), st)),
                    self._upload(_view(L.amtpu_dom_orank(bh, blk), st)),
                    self._upload(_view(L.amtpu_dom_od(bh, blk), st)),
                    self._upload(_view(L.amtpu_dom_ov(bh, blk), st), bool),
                    chunk=64)).astype(np.int32)
                L.amtpu_dom_set_indexes(bh, blk, _ip(idx))
        self._devtime_end(dev_t0)

    # -- the degraded route ---------------------------------------------

    def _apply_host_full(self, payload):
        """One batch on the C++ full host path of this pool: registers and
        list indexes resolve in C++ (mid through `amtpu_mid_hostreg`, then
        emit), nothing is uploaded and no kernel runs.  Only the
        resilience layer's degraded route (`resilience.DEGRADE`) takes it,
        for one poisoned doc, as the JAX pool's `_apply_degraded` does.
        The batch's docs' resident entries are marked stale after."""
        L = lib()
        L.amtpu_pool_set_hostfull(self._pool, 1)
        try:
            bh, fault_docs = self._begin(payload)
        finally:
            L.amtpu_pool_set_hostfull(self._pool, 0)
        try:
            dims = (ctypes.c_int64 * self.N_DIMS)()
            L.amtpu_batch_dims(bh, dims)
            if not dims[13]:
                raise AssertionError('a degraded batch was not pinned '
                                     'host-full')
            if faults.ARMED:
                faults.fire('native.mid', fault_docs)
            with trace.span('host.mid'):
                if L.amtpu_mid_hostreg(bh) != 0:
                    _raise_last()
            for key in _batch_docs(bh, payload):
                self._resident.invalidate_doc(key.encode())
            return self._emit(L, {'bh': bh, 'dims': tuple(dims)[:9]})
        except Exception as e:
            _rollback_batch(bh, e)
            raise
        finally:
            _free_batch(bh)

    # -- dict-level API -------------------------------------------------

    def apply_batch_bytes_resilient(self, payload):
        """`apply_batch_bytes` behind the resilience layer: transient
        failures retry with backoff, persistent ones bisect down to the
        poison doc(s), which quarantine as per-doc error envelopes while
        every healthy doc commits."""
        return resilience.apply_payload(self, payload)

    def apply_batch(self, changes_by_doc):
        """{doc_id: [change dict, ...]} -> {doc_id: patch dict}, a
        quarantined doc's value its error envelope."""
        return _apply_batch_dicts(self, changes_by_doc)

    def apply_changes(self, doc_id, changes):
        out = self.apply_batch({doc_id: changes})[doc_id]
        _raise_if_quarantined(doc_id, out)
        return out

    def _query(self, fn, doc_id):
        out_len = ctypes.c_int64()
        ptr = fn(self._pool, doc_key(doc_id).encode(), ctypes.byref(out_len))
        if not ptr:
            _raise_last()
        return take_buf(ptr, out_len.value)

    def get_patch(self, doc_id):
        return msgpack.unpackb(self._query(lib().amtpu_get_patch, doc_id),
                               raw=False)

    def get_clock(self, doc_id):
        """{'clock': ..., 'deps': ...} without materializing the doc."""
        return msgpack.unpackb(self._query(lib().amtpu_get_clock, doc_id),
                               raw=False)

    def get_missing_deps(self, doc_id):
        """{actor: seq} of the changes the doc's causal queue waits on."""
        return msgpack.unpackb(
            self._query(lib().amtpu_get_missing_deps, doc_id), raw=False)

    def _query_have(self, fn, key, have_deps):
        have = msgpack.packb(dict(have_deps), use_bin_type=True)
        out_len = ctypes.c_int64()
        ptr = fn(self._pool, key.encode(), have, len(have),
                 ctypes.byref(out_len))
        if not ptr:
            _raise_last()
        return take_buf(ptr, out_len.value)

    def _missing_clock(self, key, have_deps):
        """The transitively closed {actor: from_seq} clock the C++
        missing-changes walk serves from."""
        return msgpack.unpackb(self._query_have(
            lib().amtpu_get_missing_clock, key, have_deps), raw=False)

    def _missing_changes_raw(self, key, have_deps):
        return self._query_have(lib().amtpu_get_missing_changes, key,
                                have_deps)

    def get_missing_changes(self, doc_id, have_deps):
        """The changes a requester with clock `have_deps` lacks.  A doc
        compacted behind its settled frontier serves a requester whose
        closure reaches into the snapshot by merging the snapshot's
        changes with the C++ tail, in the order the walk over the whole
        history gives."""
        key = doc_key(doc_id)
        st = self._storage.get(key)
        if st and st['chunks']:
            from_clock = self._missing_clock(key, have_deps)
            if any(from_clock.get(a, 0) < s
                   for a, s in st['frontier'].items()):
                trace.metric('storage.snapshot_backfills')
                return [msgpack.unpackb(r, raw=False, strict_map_key=False)
                        for r in self._merged_missing_raws(key, st,
                                                           from_clock)]
        return msgpack.unpackb(self._missing_changes_raw(key, have_deps),
                               raw=False)

    def _snapshot_meta(self, st):
        """(raw, actor, seq) of every change of a snapshot's chunks, in
        application order (`storage.decode_columnar_meta`, the Python
        decoder, as the JAX pool reads them)."""
        return [meta for chunk in st['chunks']
                for meta in storage.decode_columnar_meta(chunk)]

    def _merged_missing_raws(self, key, st, from_clock):
        """Snapshot + tail merge: per actor in first-seen application
        order, changes with seq > from_clock[actor], seq ascending."""
        full = self._snapshot_meta(st)
        full += [_raw_actor_seq(raw) for raw in self._tail_raws(key)]
        actor_order, per_actor = [], {}
        for raw, actor, seq in full:
            if actor not in per_actor:
                actor_order.append(actor)
                per_actor[actor] = []
            per_actor[actor].append((seq, raw))
        out = []
        for actor in actor_order:
            frm = from_clock.get(actor, 0)
            out.extend(raw for seq, raw in per_actor[actor]
                       if seq is not None and seq > frm)
        return out

    def get_register(self, doc_id, obj, key):
        """Current field ops of one (obj, key), winner first."""
        out_len = ctypes.c_int64()
        ptr = lib().amtpu_get_register(
            self._pool, doc_key(doc_id).encode(), obj.encode(),
            key.encode(), ctypes.byref(out_len))
        if not ptr:
            _raise_last()
        return msgpack.unpackb(take_buf(ptr, out_len.value), raw=False)

    def get_changes_for_actor(self, doc_id, actor, after_seq=0):
        return msgpack.unpackb(
            self.get_changes_for_actor_bytes(doc_id, actor, after_seq),
            raw=False)

    def get_changes_for_actor_bytes(self, doc_id, actor, after_seq=0):
        """Raw msgpack array of the actor's changes after `after_seq`:
        the bytes replica catch-up ships.  A compacted doc splices its
        snapshot's changes ahead of the C++ tail."""
        key = doc_key(doc_id)
        out_len = ctypes.c_int64()
        ptr = lib().amtpu_get_changes_for_actor(
            self._pool, key.encode(), actor.encode(), after_seq,
            ctypes.byref(out_len))
        if not ptr:
            _raise_last()
        buf = take_buf(ptr, out_len.value)
        st = self._storage.get(key)
        if not st or not st['chunks'] \
                or after_seq >= st['frontier'].get(actor, 0):
            return buf
        trace.metric('storage.snapshot_backfills')
        head = [raw for raw, a, seq in self._snapshot_meta(st)
                if a == actor and seq is not None and seq > after_seq]
        return storage.join_changes_array(
            head + storage.split_changes_array(buf))

    # -- checkpoints ----------------------------------------------------

    def _tail_raws(self, doc_id):
        """Raw bytes of the changes C++ still holds for the doc (those
        after an adopted snapshot), application order."""
        raw = self._query(lib().amtpu_save, doc_id)
        return storage.split_changes_array(
            memoryview(raw)[len(storage.CKPT_V1_PREFIX):])

    def save(self, doc_id):
        """The doc as a checkpoint: the v2 columnar container (its adopted
        snapshot's frontier and chunks, if any, and the tail C++ holds),
        or under STORAGE_FORMAT = 'json' the v1 container of the whole
        history."""
        st = self._storage.get(doc_key(doc_id))
        tail = self._tail_raws(doc_id)
        if STORAGE_FORMAT == 'json':
            head = [] if st is None else [
                raw for chunk in st['chunks']
                for raw in storage.decode_columnar(chunk)]
            return storage.pack_checkpoint_v1(head + tail)
        if st is None:
            return storage.pack_checkpoint({}, [], tail)
        return storage.pack_checkpoint(st['frontier'], st['chunks'], tail)

    def load_batch(self, blobs):
        """Restores many checkpoints ({doc_id: bytes}, v1 or v2) in ONE
        batch: arena-direct (the default, STORAGE_NATIVE) or, as the
        second arm, one replay of the decoded raw changes through the
        device kernels (`_load_batch`)."""
        _load_batch(self, blobs)

    def restore_from_store(self, store, doc_ids=None, batch=None,
                           threads=None):
        """Restores a `ColdStore`'s docs into this pool (module-level
        `restore_from_store`: batches applied in turn, the next batch's
        blob reads prefetching)."""
        return restore_from_store(self, store, doc_ids=doc_ids,
                                  batch=batch, threads=threads)

    def _apply_columnar(self, keyed):
        """One arena-direct batch (`amtpu_begin_columnar`) of {doc key:
        [part, ...]}, each part a columnar blob or a raw msgpack changes
        array.  C++ pins the batch host-full, so it takes its own short
        phase (mid on the host, then emit) and no device work: the JAX
        pool does the same on every backend."""
        L = lib()
        payload = msgpack.packb(keyed, use_bin_type=True)
        t0 = time.perf_counter()
        with trace.span('host.begin'):
            bh = L.amtpu_begin_columnar(self._pool, payload, len(payload))
        if not bh:
            _raise_last()
        _track_begin()
        trace.metric('storage.native_loads')
        # no device work to dispatch: the begin is the dispatch phase,
        # mid and emit the collect phase, as the JAX pool splits them
        t1 = time.perf_counter()
        attribution.note_flush_phase('dispatch', t1 - t0)
        try:
            dims = (ctypes.c_int64 * self.N_DIMS)()
            L.amtpu_batch_dims(bh, dims)
            if not dims[13]:
                raise AssertionError('an arena-direct batch was not '
                                     'pinned host-full')
            # counted as the JAX pool's phase a counts a pinned batch
            trace.count('hostfull.batches')
            trace.metric('hostfull.batches')
            with trace.span('host.mid'):
                if L.amtpu_mid_hostreg(bh) != 0:
                    _raise_last()
            for key in keyed:
                self._resident.invalidate_doc(key.encode())
            return self._emit(L, {'bh': bh, 'dims': tuple(dims)[:9]})
        except Exception as e:
            _rollback_batch(bh, e)
            raise
        finally:
            attribution.note_flush_phase('collect',
                                         time.perf_counter() - t1)
            _free_batch(bh)

    def load(self, doc_id, data):
        """Restores one checkpoint; returns the doc's whole-state patch."""
        if not storage.is_checkpoint(bytes(data)):
            raise RangeError('not an amtpu-doc checkpoint')
        self.load_batch({doc_id: data})
        return self.get_patch(doc_id)

    def _has_clock(self, doc_id):
        try:
            return bool(self.get_clock(doc_id).get('clock'))
        except Exception:
            return False

    # -- settled-history upkeep -----------------------------------------

    def _adopt_snapshot(self, key, frontier, chunks):
        """Installs a loaded snapshot for doc `key`: C++ drops the history
        behind its frontier (so `save` does not repeat those changes in
        the tail) and folds the settled op records and clocks, as the JAX
        pool does after a load."""
        self._storage[key] = {'frontier': dict(frontier),
                              'chunks': list(chunks)}
        self._settle(key, frontier)

    def _settle(self, key, frontier):
        """C++ drops the doc's history at or behind `frontier` and folds
        its settled op records and clocks."""
        self._truncate(key, frontier)
        self._fold_settled(key, frontier)
        self._fold_clocks(key, frontier)

    def _frontier_call(self, fn, key, frontier, *extra):
        fb = msgpack.packb(dict(frontier), use_bin_type=True)
        n = fn(self._pool, key.encode(), fb, len(fb), *extra)
        if n < 0:
            _raise_last()
        return int(n)

    def _truncate(self, key, frontier):
        freed = self._frontier_call(lib().amtpu_truncate_history, key,
                                    frontier)
        trace.metric('storage.gc.bytes_freed', freed)
        return freed

    def _fold_settled(self, key, frontier):
        """Frees the op records, deps and messages of the settled changes
        at or behind `frontier` (STORAGE_FOLD)."""
        if not frontier or not STORAGE_FOLD:
            return 0
        n = self._frontier_call(lib().amtpu_fold_settled, key, frontier)
        if n:
            trace.metric('storage.gc.ops_folded', n)
        return n

    def _fold_clocks(self, key, frontier):
        """Moves the clock vectors of the settled changes into the doc's
        folded clock table, up to FOLDCLK_MAX_ACTORS actors
        (STORAGE_FOLD_CLOCKS)."""
        if not frontier or not STORAGE_FOLD_CLOCKS:
            return 0
        n = self._frontier_call(lib().amtpu_fold_clocks, key, frontier,
                                FOLDCLK_MAX_ACTORS)
        if n:
            trace.metric('storage.gc.clocks_folded', n)
        return n

    def compact(self, doc_id, frontier=None, min_changes=0):
        """Folds the settled PREFIX of the doc's history into its columnar
        snapshot and truncates the C++ history behind it.  `frontier` is
        the settled {actor: seq} clock (None: everything applied is
        settled); only the longest application-order prefix at or behind
        it folds.  Returns the number of changes folded (always 0 under
        STORAGE_FORMAT = 'json')."""
        key = doc_key(doc_id)
        if STORAGE_FORMAT == 'json':
            trace.metric('storage.gc.skipped_json')
            return 0
        clock = self.get_clock(doc_id).get('clock') or {}
        if not clock:
            return 0
        if frontier is None:
            limit = dict(clock)
        else:
            limit = {}
            for a, s in frontier.items():
                s = min(int(s), int(clock.get(a, 0)))
                if s > 0:
                    limit[a] = s
            if not limit:
                return 0
        fold, prefix_clock = [], {}
        for raw, actor, seq in map(_raw_actor_seq, self._tail_raws(key)):
            seq = seq or 0
            if seq > limit.get(actor, 0):
                break            # the first unsettled change ends the prefix
            fold.append(raw)
            prefix_clock[actor] = max(prefix_clock.get(actor, 0), seq)
        if not fold or len(fold) < min_changes:
            return 0
        st = self._storage.setdefault(key, {'frontier': {}, 'chunks': []})
        st['chunks'].append(storage.encode_columnar(fold))
        for a, s in prefix_clock.items():
            st['frontier'][a] = max(st['frontier'].get(a, 0), s)
        self._settle(key, st['frontier'])
        self._maybe_rechunk(st)
        trace.metric('storage.gc.compactions')
        trace.metric('storage.gc.changes_folded', len(fold))
        return len(fold)

    def _maybe_rechunk(self, st):
        """Merges a doc's snapshot chunks into one columnar blob once it
        holds STORAGE_CHUNK_MAX of them (0: never)."""
        if STORAGE_CHUNK_MAX <= 0 or len(st['chunks']) < STORAGE_CHUNK_MAX:
            return 0
        raws = [raw for chunk in st['chunks']
                for raw in storage.decode_columnar(chunk)]
        st['chunks'] = [storage.encode_columnar(raws)]
        trace.metric('storage.gc.rechunks')
        return len(raws)

    def _pool_count(self, fn, doc_id):
        """A C++ count over one doc, or the whole pool (doc_id None)."""
        key = '' if doc_id is None else doc_key(doc_id)
        n = fn(self._pool, key.encode())
        if n < 0:
            _raise_last()
        return int(n)

    def clock_pairs(self, doc_id=None):
        """Retained sparse clock-vector pairs, walked afresh in C++."""
        return self._pool_count(lib().amtpu_clock_pairs, doc_id)

    def op_count(self, doc_id=None):
        """Retained op records (applied and causally queued)."""
        return self._pool_count(lib().amtpu_op_count, doc_id)

    def history_bytes(self, doc_id=None):
        """Retained raw-change bytes in the C++ history."""
        return self._pool_count(lib().amtpu_history_bytes, doc_id)

    def resclk_row_bytes(self):
        """Bytes of one row of the pool-resident clock table."""
        info = (ctypes.c_int64 * 4)()
        lib().amtpu_resclk_info(self._pool, info)
        return int(info[1]) * 4

    def drop_doc(self, doc_id):
        """Removes the doc's whole state from the pool (save it first).
        Returns True if the doc existed."""
        key = doc_key(doc_id)
        found = self._pool_count(lib().amtpu_drop_doc, doc_id)
        self._storage.pop(key, None)
        self._resident.invalidate_doc(key.encode())
        return bool(found)

    #: amtpu_doc_stats columns, in its order
    DOC_STAT_COLS = ('hist_bytes', 'ops', 'folded_ops', 'changes',
                     'queued', 'resclk_rows', 'clk_pairs',
                     'foldclk_bytes')

    def doc_stats(self):
        """Per-doc accounting in one C call: (doc keys, int64 array of
        shape (n_docs, len(DOC_STAT_COLS))), rows in the keys' order.
        Column totals equal `history_bytes()` and `op_count()`."""
        L = lib()
        n = int(L.amtpu_doc_count(self._pool))
        ncols = len(self.DOC_STAT_COLS)
        if n <= 0:
            return [], np.zeros((0, ncols), np.int64)
        buf = (ctypes.c_int64 * (n * ncols))()
        rows = L.amtpu_doc_stats(self._pool, buf, n * ncols)
        if rows < 0:
            _raise_last()
        ln = ctypes.c_int64()
        ptr = L.amtpu_doc_ids(self._pool, ctypes.byref(ln))
        if not ptr:
            _raise_last()
        ids = msgpack.unpackb(take_buf(ptr, ln.value), raw=False)
        rows = int(rows)
        stats = np.frombuffer(buf, dtype=np.int64,
                              count=rows * ncols).reshape(rows, ncols)
        return ids[:rows], stats.copy()


# ---------------------------------------------------------------------------
# the dict API's resilient path
# ---------------------------------------------------------------------------

def _apply_batch_dicts(pool, changes_by_doc):
    """The dict-level apply_batch of every pool: a msgpack round trip
    through the pool's resilient wire path (`apply_batch_bytes_resilient`),
    so a device or native failure is retried, bisected and at worst
    quarantined per doc instead of failing every doc of the batch.  The
    submitted ops of a committed batch count into `telemetry.OPS` here,
    where the changes exist as dicts (duplicates and queued changes
    included, as in the JAX pool)."""
    keyed = {doc_key(d): chs for d, chs in changes_by_doc.items()}
    out = msgpack.unpackb(pool.apply_batch_bytes_resilient(
        msgpack.packb(keyed, use_bin_type=True)),
        raw=False, strict_map_key=False)
    telemetry.OPS.inc(sum(len(c.get('ops', ()))
                          for chs in changes_by_doc.values() for c in chs))
    return {d: out[doc_key(d)] for d in changes_by_doc}


def _raise_if_quarantined(doc_id, result):
    """Single-doc entry points keep their raise contract: a quarantine
    envelope there surfaces as the exception it stands for, its message
    carrying `resilience.QUARANTINE_RAISE_MARKER`."""
    if resilience.is_quarantined(result):
        raise AutomergeError('doc %r%s%s] %s'
                             % (doc_id, resilience.QUARANTINE_RAISE_MARKER,
                                result['errorType'], result['error']))


# ---------------------------------------------------------------------------
# checkpoint loads, grouped per base pool
# ---------------------------------------------------------------------------

def _base_pool_of(pool, doc_id):
    """The NativeDocPool that owns `doc_id`'s state: a sharded pool
    routes per doc; a plain pool is its own base."""
    if hasattr(pool, '_shard_of'):
        return pool.pools[pool._shard_of(doc_id)]
    return pool


def _v2_adopt_info(pool, doc_id, key, adopts, frontier, chunks,
                   empty_pools):
    """Queues the post-apply snapshot adoption of a v2 container, only
    into docs that held no state before the load: a live doc keeps its
    own history (an older checkpoint replays as no-ops there, and its
    snapshot need not be a prefix of the doc's history).  `empty_pools`
    caches each base pool's emptiness, so a restore into fresh pools
    asks no per-doc clock."""
    if not (frontier and chunks and STORAGE_FORMAT != 'json'):
        return
    bp = _base_pool_of(pool, doc_id)
    empty = empty_pools.get(id(bp))
    if empty is None:
        empty = empty_pools[id(bp)] = bp.doc_count() == 0
    if empty or not bp._has_clock(doc_id):
        adopts.append((bp, key, frontier, chunks))


def _load_batch(pool, blobs):
    """Restores many checkpoints ({doc_id: bytes}, v1 or v2) into `pool`
    (a NativeDocPool or a ShardedNativePool).

    Arena-direct (STORAGE_NATIVE, the default): docs group per base pool
    and each group is one `amtpu_begin_columnar` batch, host-resolved in
    C++; more than one group restore concurrently on a thread pool (the
    C++ stages release the GIL), the first error raised after every
    group ran.  The replay arm (STORAGE_NATIVE = False): one
    `apply_batch_bytes` of every doc's decoded raw changes through the
    device kernels, which a sharded pool splits by shard.  Either way a
    v2 checkpoint's snapshot is adopted afterwards (`_v2_adopt_info`)."""
    if faults.ARMED:
        faults.fire('checkpoint.load', [doc_key(d) for d in blobs])
    groups = {}          # id(base pool) -> (base pool, {key: [part, ...]})
    v1_keys = set()      # docs whose one part is a raw changes array
    adopts = []          # (base pool, key, frontier, chunks) post-apply
    empty_pools = {}     # id(base pool) -> held no doc before the load
    for doc_id, data in blobs.items():
        key = doc_key(doc_id)
        data = bytes(data)
        bp = _base_pool_of(pool, doc_id)
        keyed = groups.setdefault(id(bp), (bp, {}))[1]
        if data.startswith(storage.CKPT_V1_PREFIX):
            keyed[key] = [data[len(storage.CKPT_V1_PREFIX):]]
            v1_keys.add(key)
            continue
        if not data.startswith(storage.CKPT_V2_PREFIX):
            raise RangeError('not an amtpu-doc checkpoint: %r' % (doc_id,))
        try:
            frontier, chunks, tail = storage.unpack_checkpoint_parts(data)
        except ValueError as e:
            raise RangeError('corrupt checkpoint for %r: %s' % (doc_id, e))
        keyed[key] = chunks + [tail]
        _v2_adopt_info(pool, doc_id, key, adopts, frontier, chunks,
                       empty_pools)
    if STORAGE_NATIVE:
        def apply_group(bp, keyed):
            try:
                bp._apply_columnar(keyed)
            except RangeError as e:
                raise RangeError('corrupt checkpoint (docs %s): %s'
                                 % (sorted(keyed), e))
        if len(groups) > 1:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(len(groups), os.cpu_count() or 1)) as ex:
                futs = [ex.submit(apply_group, bp, keyed)
                        for bp, keyed in groups.values()]
                errors = [f.exception() for f in futs
                          if f.exception() is not None]
            if errors:
                raise errors[0]
        else:
            for bp, keyed in groups.values():
                apply_group(bp, keyed)
    else:
        _replay_checkpoints(pool, [kv for _bp, keyed in groups.values()
                                   for kv in keyed.items()], v1_keys)
    for bp, key, frontier, chunks in adopts:
        bp._adopt_snapshot(key, frontier, chunks)


def _replay_checkpoints(pool, items, v1_keys):
    """The replay arm: one `apply_batch_bytes` of every doc's raw
    changes (a v1 body as it is, v2 chunks and tail decoded)."""
    parts = [map_header(len(items))]
    for key, doc_parts in items:
        parts.append(msgpack.packb(key, use_bin_type=True))
        if key in v1_keys:
            parts.append(doc_parts[0])
            continue
        try:
            raws = [raw for part in doc_parts
                    for raw in storage.decode_columnar(part)]
        except ValueError as e:
            raise RangeError('corrupt checkpoint for %r: %s' % (key, e))
        parts.append(storage.join_changes_array(raws))
    pool.apply_batch_bytes(b''.join(parts))


def restore_threads():
    """The restore fan-out RESTORE_THREADS gives (0: one worker per core,
    at most 8)."""
    n = RESTORE_THREADS
    if n <= 0:
        n = min(8, os.cpu_count() or 1)
    return n


def restore_from_store(pool, store, doc_ids=None, batch=None,
                       threads=None):
    """Restores docs of a `ColdStore` (all of them, in sorted order, or
    `doc_ids`) into `pool`, a NativeDocPool or a ShardedNativePool.

    * Docs group per base pool (`_base_pool_of`); each group restores on
      its own worker (at most `threads`, default `restore_threads()`), in
      batches of `batch` docs (default RESTORE_BATCH) through
      `_load_batch`.  Within a group a one-thread reader prefetches the
      next batch's blobs while the current batch applies.
    * A corrupt blob (`ColdStoreCorrupt`) quarantines that doc into the
      summary's `corrupt` map; a batch that fails is applied again doc by
      doc, and docs that still fail land in `failed`, each as a
      resilience error envelope.
    * Counters `storage.restore.{docs,bytes,batches,corrupt,failed}`,
      and `restore.start/corrupt/failed/done` recorder events.

    Returns {'docs', 'bytes', 'batches', 'corrupt': {doc: envelope},
    'failed': {doc: envelope}, 'elapsed_s'}."""
    from ..storage.coldstore import ColdStoreCorrupt
    t0 = time.perf_counter()
    doc_ids = sorted(store.doc_ids()) if doc_ids is None else list(doc_ids)
    if batch is None:
        batch = max(1, RESTORE_BATCH)
    if threads is None:
        threads = restore_threads()
    recorder.record('restore.start', n=len(doc_ids),
                    detail='threads=%d batch=%d' % (threads, batch))
    groups = {}          # id(base pool) -> (base pool, [doc ids])
    if hasattr(pool, '_shard_of'):
        pool.pools       # build the shards (and load the kernels) here
    for d in doc_ids:
        bp = _base_pool_of(pool, d)
        groups.setdefault(id(bp), (bp, []))[1].append(d)
    lock = threading.Lock()
    summary = {'docs': 0, 'bytes': 0, 'batches': 0,
               'corrupt': {}, 'failed': {}}

    def read_blobs(ids):
        blobs = {}
        for d in ids:
            try:
                blobs[d] = store.get(d)
            except ColdStoreCorrupt as e:
                trace.metric('storage.restore.corrupt')
                recorder.record('restore.corrupt', doc=doc_key(d),
                                detail=str(e))
                with lock:
                    summary['corrupt'][d] = resilience.error_envelope(e)
            except KeyError:
                pass     # dropped between the inventory walk and the read
        return blobs

    def apply_blobs(bp, blobs):
        if not blobs:
            return
        try:
            _load_batch(bp, blobs)
        except Exception:
            # one poison blob must not fail the other docs of its batch
            for d, data in blobs.items():
                try:
                    _load_batch(bp, {d: data})
                except Exception as e:
                    trace.metric('storage.restore.failed')
                    recorder.record('restore.failed', doc=doc_key(d),
                                    detail=str(e))
                    with lock:
                        summary['failed'][d] = resilience.error_envelope(e)
        n_bytes = sum(len(v) for v in blobs.values())
        with lock:
            summary['docs'] += len(blobs)
            summary['bytes'] += n_bytes
            summary['batches'] += 1
        trace.metric('storage.restore.docs', len(blobs))
        trace.metric('storage.restore.bytes', n_bytes)
        trace.metric('storage.restore.batches')

    def run_group(bp, ids):
        chunks = [ids[i:i + batch] for i in range(0, len(ids), batch)]
        with concurrent.futures.ThreadPoolExecutor(1) as reader:
            pending = reader.submit(read_blobs, chunks[0]) \
                if chunks else None
            for i in range(len(chunks)):
                blobs = pending.result()
                pending = reader.submit(read_blobs, chunks[i + 1]) \
                    if i + 1 < len(chunks) else None
                apply_blobs(bp, blobs)

    group_list = [g for g in groups.values() if g[1]]
    if len(group_list) > 1 and threads > 1:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(threads, len(group_list))) as ex:
            futs = [ex.submit(run_group, bp, ids) for bp, ids in group_list]
            errors = [f.exception() for f in futs
                      if f.exception() is not None]
        if errors:
            raise errors[0]
    else:
        for bp, ids in group_list:
            run_group(bp, ids)
    summary['elapsed_s'] = round(time.perf_counter() - t0, 3)
    recorder.record('restore.done', n=summary['docs'],
                    detail='%.3fs corrupt=%d failed=%d'
                           % (summary['elapsed_s'], len(summary['corrupt']),
                              len(summary['failed'])))
    return summary


# ---------------------------------------------------------------------------
# the sharded pool
# ---------------------------------------------------------------------------

def _raise_shard_errors(errors):
    """Per-shard error reporting: a single failure re-raises with its
    shard named; several aggregate every shard's message, keeping the
    exception class when every shard failed the same way."""
    if not errors:
        return
    if len(errors) == 1:
        shard, err = errors[0]
        err.args = ('[shard %d] %s' % (shard, err.args[0] if err.args
                                       else err),) + err.args[1:]
        raise err
    types = {type(e) for _, e in errors}
    cls = types.pop() if len(types) == 1 else AutomergeError
    try:
        probe = cls('probe')          # must accept a lone message arg
    except Exception:
        cls, probe = AutomergeError, None
    if probe is not None and not isinstance(probe, Exception):
        cls = AutomergeError
    raise cls(
        '%d shards failed: ' % len(errors) +
        '; '.join('[shard %d] %s: %s' % (s, type(e).__name__, e)
                  for s, e in errors)) from errors[0][1]


def load_runtime(device):
    """Builds and loads the C++ core and, for a card device, every CUDA
    kernel (one `nvcc` per source, all at once) on the calling thread,
    and creates torch's CUDA context, so that no request a server
    answers waits on a build or on the context, and a server that
    cannot use its card fails before it binds."""
    lib()
    device = torch.device(device)
    if device.type == 'cuda':
        from ..ops import _build
        _build.build_all()
        _load_kernels(device)
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)


def _load_kernels(device):
    """Builds and loads every CUDA kernel of a card pool on the calling
    thread: the loaders take no lock, so worker threads must find them
    loaded."""
    if device.type == 'cuda':
        from ..ops import _build
        for name in _build.KERNELS:
            _build.kernel(name)


class ShardedNativePool:
    """S independent NativeDocPools on one device, driven pipelined or
    threaded.

    * pipeline: one thread; phase a (C++ begin, uploads, kernel
      enqueue) of every shard first, then phase b (wait, C++ mid, emit)
      ready-first (`_collect_ready_order`), so shard k's kernels overlap
      shard k+1's begin.  Shards are not split into waves.
    * threads: one thread per shard, each calling its pool's
      `apply_batch_bytes` on its sub-payload; the C++ stages release the
      GIL, so begin and emit of the shards run concurrently.  Every
      thread launches on its current stream, the default stream.

    Doc -> shard routing is the C++ payload splitter's FNV-1a hash
    (`amtpu_doc_shard`).  Result maps merge at the byte level in shard
    order.  Shards commit independently: a failed shard's sub-payload
    re-applies through the resilience layer while the healthy shards'
    results stand.  Every shard is a `NativeDocPool(device)`: CUDA
    unless the caller passes device='cpu'.
    """

    @staticmethod
    def resolve_mode(mode=None):
        cores = os.cpu_count() or 1
        mode = mode or SHARD_MODE
        if not mode:
            mode = 'pipeline' if cores == 1 else 'threads'
        if mode not in ('pipeline', 'threads'):
            raise ValueError('unknown shard mode %r' % (mode,))
        return mode

    @classmethod
    def default_shards(cls, mode=None):
        """The mode's shard count: 20 in pipeline mode (more shards than
        cores give finer overlap), one per core (at most 8) in threads
        mode.  The port is the kernel path on every device, so the JAX
        pool's one-shard host-full default has no counterpart."""
        if cls.resolve_mode(mode) == 'pipeline':
            return 20
        return min(8, os.cpu_count() or 1)

    #: the batch latency series of a whole payload (`MeshDocPool`:
    #: 'mesh')
    _batch_label = 'sharded'

    def __init__(self, n_shards=None, mode=None, device=None):
        self.mode = self.resolve_mode(mode)
        if n_shards is not None and n_shards < 1:
            raise ValueError('n_shards must be >= 1, got %r' % (n_shards,))
        self.device = _pool_device(device)
        self._n_shards = n_shards        # guarded-by(w): self._pools_lock
        self._pools = None               # guarded-by(w): self._pools_lock
        # any entry point may be the first to build the shards, from any
        # thread: the lock makes every caller see one pool list
        self._pools_lock = threading.Lock()

    @property
    def n_shards(self):
        if self._n_shards is None:
            with self._pools_lock:
                if self._n_shards is None:
                    self._n_shards = self.default_shards(self.mode)
        return self._n_shards

    @property
    def pools(self):
        if self._pools is None:
            n = self.n_shards        # takes the same lock: resolve first
            with self._pools_lock:
                if self._pools is None:
                    pools = [NativeDocPool(self.device) for _ in range(n)]
                    _load_kernels(self.device)
                    self._pools = pools
        return self._pools

    def _shard_of(self, doc_id):
        key = doc_key(doc_id).encode()
        return int(lib().amtpu_doc_shard(key, len(key), self.n_shards))

    def apply_batch_bytes(self, payload):
        """msgpack {doc_id: [change...]} -> msgpack {doc_id: patch}, the
        shards' maps concatenated in shard order (the `sharded` batch
        latency series; threads mode's shard calls land under
        `native`)."""
        t_batch = time.perf_counter()
        L = lib()
        self.pools       # build the shards and load the kernels here
        with trace.span('shard.split'):
            sp = L.amtpu_shard_split(payload, len(payload), self.n_shards)
            if not sp:
                _raise_last()
        try:
            # zero-copy: sub-payloads stay in the splitter's buffers,
            # which outlive every begin (freed below)
            subs = []
            for s in range(self.n_shards):
                n = ctypes.c_int64()
                ptr = L.amtpu_shard_buf(sp, s, ctypes.byref(n))
                subs.append((ctypes.cast(ptr, ctypes.c_char_p), n.value)
                            if n.value > 1 else None)
            with trace.span('shard.run'):
                results, errors = self._run(subs)
            if errors:
                # a failed shard rolled its pool back: its sub-payload
                # re-applies through the resilience layer while the
                # healthy shards' results stand
                errors = self._retry_failed_shards(subs, results, errors)
            _raise_shard_errors(errors)
        finally:
            with trace.span('batch.free'):
                L.amtpu_shard_free(sp)
        total = 0
        bodies = []
        for r in results:
            if r is None:
                continue
            n, off = read_map_header(r)
            total += n
            bodies.append(memoryview(r)[off:])
        out = map_header(total) + b''.join(bodies)
        telemetry.observe_batch(self._batch_label,
                                time.perf_counter() - t_batch,
                                docs=read_map_header(payload)[0])
        return out

    def _run(self, subs):
        if self.mode == 'pipeline':
            return self._run_pipelined(subs)
        return self._run_threaded(subs)

    def _run_pipelined(self, subs):
        """Phase a for every shard, then phase b ready-first.  Every
        shard that began runs to completion whatever failed before it;
        errors come back per shard."""
        ctxs = []
        results = [None] * self.n_shards
        errors = []
        for s, sub in enumerate(subs):
            if sub is None:
                continue
            try:
                ctxs.append((s, self.pools[s], self.pools[s]._start(sub)))
            except Exception as e:
                errors.append((s, e))
        _collect_ready_order(ctxs, on_result=results.__setitem__,
                             on_error=lambda s, e: errors.append((s, e)))
        return results, errors

    def _run_threaded(self, subs):
        results = [None] * self.n_shards
        errors = []

        def run(s):
            try:
                results[s] = self.pools[s].apply_batch_bytes(subs[s])
            except Exception as e:         # re-raised on the caller thread
                errors.append((s, e))

        threads = [threading.Thread(target=run, args=(s,))
                   for s, sub in enumerate(subs) if sub is not None]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results, sorted(errors, key=lambda se: se[0])

    def _retry_failed_shards(self, subs, results, errors):
        """Re-applies each failed shard's sub-payload through the
        resilience layer on that shard's pool; returns the errors it
        must not isolate (they re-raise)."""
        remaining = []
        for s, e in errors:
            if not resilience.should_isolate(e):
                remaining.append((s, e))
                continue
            try:
                results[s] = resilience.apply_payload(
                    self.pools[s], subs[s], first_exc=e)
            except Exception as e2:
                remaining.append((s, e2))
        return remaining

    def apply_batch_bytes_resilient(self, payload):
        """`apply_batch_bytes`: the sharded pool isolates failures per
        shard itself."""
        return self.apply_batch_bytes(payload)

    def apply_batch(self, changes_by_doc):
        return _apply_batch_dicts(self, changes_by_doc)

    def _pool_of(self, doc_id):
        return self.pools[self._shard_of(doc_id)]

    def apply_changes(self, doc_id, changes):
        # one doc: its shard's pool raises a quarantine itself
        return self._pool_of(doc_id).apply_changes(doc_id, changes)

    def apply_local_change(self, doc_id, request):
        return self._pool_of(doc_id).apply_local_change(doc_id, request)

    def get_patch(self, doc_id):
        return self._pool_of(doc_id).get_patch(doc_id)

    def get_clock(self, doc_id):
        return self._pool_of(doc_id).get_clock(doc_id)

    def save(self, doc_id):
        return self._pool_of(doc_id).save(doc_id)

    def load(self, doc_id, data):
        return self._pool_of(doc_id).load(doc_id, data)

    def load_batch(self, blobs):
        """Many checkpoints at once, grouped per shard (`_load_batch`)."""
        _load_batch(self, blobs)

    def restore_from_store(self, store, doc_ids=None, batch=None,
                           threads=None):
        """A `ColdStore`'s docs restored shard by shard, one worker per
        shard (module-level `restore_from_store`)."""
        return restore_from_store(self, store, doc_ids=doc_ids,
                                  batch=batch, threads=threads)

    def get_missing_deps(self, doc_id):
        return self._pool_of(doc_id).get_missing_deps(doc_id)

    def get_missing_changes(self, doc_id, have_deps):
        return self._pool_of(doc_id).get_missing_changes(doc_id, have_deps)

    def get_register(self, doc_id, obj, key):
        return self._pool_of(doc_id).get_register(doc_id, obj, key)

    def get_changes_for_actor(self, doc_id, actor, after_seq=0):
        return self._pool_of(doc_id).get_changes_for_actor(
            doc_id, actor, after_seq)

    def get_changes_for_actor_bytes(self, doc_id, actor, after_seq=0):
        return self._pool_of(doc_id).get_changes_for_actor_bytes(
            doc_id, actor, after_seq)

    def compact(self, doc_id, frontier=None, min_changes=0):
        return self._pool_of(doc_id).compact(doc_id, frontier, min_changes)

    def drop_doc(self, doc_id):
        return self._pool_of(doc_id).drop_doc(doc_id)

    def _sum(self, name, doc_id):
        if doc_id is not None:
            return getattr(self._pool_of(doc_id), name)(doc_id)
        return sum(getattr(p, name)() for p in self.pools)

    def history_bytes(self, doc_id=None):
        return self._sum('history_bytes', doc_id)

    def op_count(self, doc_id=None):
        return self._sum('op_count', doc_id)

    def clock_pairs(self, doc_id=None):
        return self._sum('clock_pairs', doc_id)

    def resclk_row_bytes(self):
        """The widest shard's clock-table row."""
        return max(p.resclk_row_bytes() for p in self.pools)

    DOC_STAT_COLS = NativeDocPool.DOC_STAT_COLS

    def doc_stats(self):
        """Per-doc stats of every shard, concatenated in shard order."""
        ids, mats = [], []
        for p in self.pools:
            pids, pstats = p.doc_stats()
            ids.extend(pids)
            if len(pids):
                mats.append(pstats)
        if not mats:
            return ids, np.zeros((0, len(self.DOC_STAT_COLS)), np.int64)
        return ids, np.concatenate(mats, axis=0)


def make_pool(device=None, mesh=None):
    """The pool factory: a `NativeDocPool(device)`, or with `mesh=(dp,
    sp)` a `MeshDocPool` of dp chips on `device` (the JAX package's
    factory under AMTPU_MESH=dp[,sp]; a dp of 0 or less means no mesh,
    as there)."""
    if mesh is None or mesh[0] <= 0:
        return NativeDocPool(device)
    from .mesh_pool import MeshDocPool
    return MeshDocPool(mesh[0], max(mesh[1], 1), device=device)


def _indexed_device(device):
    """`device` as a torch device with its CUDA index filled in (a tensor
    on the card reports one)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device
