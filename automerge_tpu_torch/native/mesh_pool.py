"""The doc-partitioned pool over a grid of devices.

`MeshDocPool(dp, sp)` spreads a payload's docs over dp chips by the C++
FNV doc hash (the payload splitter the sharded pool uses), each chip a
`MeshChipPool`: a `NativeDocPool` whose every upload, kernel launch,
resident clock table and escalation tier runs on its own device and its
own CUDA stream.  It speaks the `apply_batch` / `apply_batch_bytes`
contract of `NativeDocPool`, so the gateway, the resilience layer and the
sidecar (`--mesh dp[,sp]`, `native.make_pool(mesh=...)`) serve it as
they serve one pool.

The drive (`_run`): one thread per chip runs the chip's phase a (C++
begin, uploads, the kernels enqueued on the chip's stream), publishes
its context and joins a shared ready-first collector
(`_collect_one_ready_first`) that claims any chip whose CUDA event has
completed; there is no barrier between the phases, so one chip's C++
mid and emit overlap another's begin and device wait.  Counters (the
port's one counter table): `mesh.batches`, `mesh.shards`,
`mesh.chip_docs`, `mesh.occupancy_skew` (max - min docs a chip),
`mesh.encode_shard_skew_s` (max - min phase-a wall), `mesh.
collective_wait_s` (a collector blocked with nothing ready),
`mesh.device_shortfall`; the span `mesh.drive`.

The sp axis is fenced (`native/resident.py`): only a `MeshDocPool(dp=1,
sp>1)` shards a resident arena's element axis over sp blocks, and only
past `sp_min` elements.  The grid's devices come from `devices` (placed
round-robin); a grid larger than its distinct devices counts
`mesh.device_shortfall` and warns once, as on a host with one card,
where every chip shares `cuda:0` (placement changes no byte).

Errors are the sharded pool's: chips commit independently, and a failed
chip's sub-payload re-applies through the resilience layer on that chip
alone.
"""

import contextlib
import ctypes
import threading
import time
import warnings

import torch

from .. import trace
from ..utils import read_map_header
from . import (NativeDocPool, ShardedNativePool, _ctx_ready,
               _indexed_device, _load_kernels, _run_phase_b_entry)
from .resident import SP_CROSSOVER_ELEMS, sp_block_count

#: (dp, sp, distinct devices) shortfalls already warned of
_warned = set()


def parse_mesh(text):
    """'dp[,sp]' -> (dp, sp), or None for an empty text or a dp of 0 or
    less (no mesh), as the JAX package parses AMTPU_MESH; raises
    ValueError on anything else."""
    if text is None or not text.strip():
        return None
    parts = text.split(',')
    try:
        if len(parts) > 2:
            raise ValueError
        dp = int(parts[0])
        sp = int(parts[1]) if len(parts) > 1 and parts[1].strip() else 1
    except ValueError:
        raise ValueError('a mesh is dp[,sp] (e.g. "4" or "4,2"), got %r'
                         % (text,))
    if dp <= 0:
        return None
    return dp, max(sp, 1)


class MeshChipPool(NativeDocPool):
    """One dp chip: a `NativeDocPool` whose phases (and so
    `apply_local_change`, the dict API and the resilience re-applies,
    which run them) execute under its device and its own CUDA stream:
    the current device and stream are per thread, and every kernel and
    copy of the phase goes to the current stream.  `sp_devices` (a
    MeshDocPool of dp = 1) lets its resident arena shard over sp blocks
    past `sp_min` elements."""

    def __init__(self, device, sp_devices=None, sp_min=SP_CROSSOVER_ELEMS):
        super().__init__(device)
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == 'cuda' else None
        self._resident.sp_devices = sp_devices
        self._resident.sp_min = sp_min

    @contextlib.contextmanager
    def _device_ctx(self):
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def _phase_a(self, bh, fault_docs=None):
        with self._device_ctx():
            return super()._phase_a(bh, fault_docs)

    def _phase_b(self, ctx):
        with self._device_ctx():
            return super()._phase_b(ctx)


def _collect_one_ready_first(produced, state, cv, on_result, on_error):
    """One claim of the shared collector: under the condition variable,
    wait for a produced (key, pool, ctx) entry or for production to end,
    claim the first whose CUDA event has completed (the oldest when none
    has), then, outside the lock, wait for its event if needed and run
    phase b (`_run_phase_b_entry`).  Returns False when nothing is left
    to collect."""
    with cv:
        while not produced and state['outstanding'] > 0:
            cv.wait()
        if not produced:
            return False
        pick = next((i for i, (_k, _p, ctx) in enumerate(produced)
                     if _ctx_ready(ctx)), None)
        if pick is None:
            pick = 0
            trace.metric('collect.wait_in_order')
        elif pick > 0:
            trace.metric('collect.ready_reorder')
        key, pool, ctx = produced.pop(pick)
    if not _ctx_ready(ctx):
        # the chip is still computing: block outside the lock so the
        # other chip threads keep draining ready entries
        t0 = time.perf_counter()
        ctx['event'].synchronize()
        trace.metric('mesh.collective_wait_s', time.perf_counter() - t0)
    _run_phase_b_entry(key, pool, ctx, on_result, on_error)
    return True


class MeshDocPool(ShardedNativePool):
    """Docs partitioned over dp chips (`MeshChipPool`), one thread a chip
    and no barrier between the phases; the batch and query surface of
    `NativeDocPool`.  `devices` places the grid's cells round-robin (chip
    s on devices[s * sp], its sp blocks on the next ones); `device` puts
    every cell on one device ('cpu' runs the plain versions); with
    neither, the cells go over every CUDA device.  `sp_min` is the sp
    fence's element count."""

    _batch_label = 'mesh'

    def __init__(self, dp, sp=1, devices=None, sp_min=SP_CROSSOVER_ELEMS,
                 device=None):
        if dp < 1 or sp < 1:
            raise ValueError('mesh axes must be >= 1, got dp=%r sp=%r'
                             % (dp, sp))
        if devices is None and device is not None:
            devices = [device]
        if devices is not None:
            devices = [_indexed_device(d) for d in devices]
            if not devices:
                raise ValueError('MeshDocPool needs at least one device')
            device = devices[0]
        super().__init__(n_shards=dp, mode='threads', device=device)
        self.dp = dp
        self.sp = sp
        self.sp_min = sp_min
        self._device_list = devices
        self._chip_devices = None

    def _resolve_devices(self):
        """(primary device, sp block devices or None) per chip.  A grid
        larger than its distinct devices places chips round-robin:
        counted as `mesh.device_shortfall` and warned once."""
        if self._chip_devices is None:
            devs = self._device_list or [
                torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
            want = self.dp * self.sp
            have = len(set(devs))
            if have < want:
                trace.metric('mesh.device_shortfall')
                if (self.dp, self.sp, have) not in _warned:
                    _warned.add((self.dp, self.sp, have))
                    warnings.warn(
                        'the mesh wants %d devices (dp=%d x sp=%d) and has '
                        '%d: chips share devices round-robin (the bytes '
                        'are the same; the scaling is not)'
                        % (want, self.dp, self.sp, have), RuntimeWarning,
                        stacklevel=3)
            n_blocks = sp_block_count(self.sp) if self.dp == 1 else 1
            self._chip_devices = [
                (devs[(s * self.sp) % len(devs)],
                 [devs[(s * self.sp + k) % len(devs)]
                  for k in range(n_blocks)] if n_blocks > 1 else None)
                for s in range(self.dp)]
        return self._chip_devices

    @property
    def pools(self):
        if self._pools is None:
            chips = self._resolve_devices()
            with self._pools_lock:
                if self._pools is None:
                    pools = [MeshChipPool(dev, sp_devices=blocks,
                                          sp_min=self.sp_min)
                             for dev, blocks in chips]
                    for dev in {dev for dev, _ in chips}:
                        _load_kernels(dev)
                    self._pools = pools
        return self._pools

    def _run(self, subs):
        """One thread per chip with payload: phase a, publish the
        context, then the shared ready-first collector until every
        chip's context is collected."""
        pools = self.pools
        results = [None] * self.n_shards
        errors = []
        live = [s for s in range(self.n_shards) if subs[s] is not None]
        trace.metric('mesh.batches')
        trace.metric('mesh.shards', len(live))
        chip_docs = []
        for s in live:
            try:
                head = ctypes.string_at(subs[s][0], min(subs[s][1], 16))
                chip_docs.append(read_map_header(head)[0])
            except (ValueError, IndexError):
                chip_docs.append(0)
        if chip_docs:
            trace.metric('mesh.chip_docs', sum(chip_docs))
            trace.metric('mesh.occupancy_skew',
                         max(chip_docs) - min(chip_docs))

        produced = []                    # phase-a contexts to collect
        state = {'outstanding': len(live)}
        cv = threading.Condition()
        t_a = {}

        def keep(s, result):
            results[s] = result          # one slot per chip: no lock

        def err(s, e):
            with cv:
                errors.append((s, e))

        def chip(s):
            try:
                t0 = time.perf_counter()
                ctx = pools[s]._start(subs[s])
                t_a[s] = time.perf_counter() - t0
            except Exception as e:
                with cv:
                    errors.append((s, e))
                    state['outstanding'] -= 1
                    cv.notify_all()
            else:
                with cv:
                    produced.append((s, pools[s], ctx))
                    state['outstanding'] -= 1
                    cv.notify_all()
            while _collect_one_ready_first(produced, state, cv, keep, err):
                pass

        if len(live) <= 1:
            for s in live:
                chip(s)
        else:
            threads = [threading.Thread(target=chip, args=(s,))
                       for s in live]
            with trace.span('mesh.drive'):
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        if len(t_a) > 1:
            trace.metric('mesh.encode_shard_skew_s',
                         max(t_a.values()) - min(t_a.values()))
        return results, sorted(errors, key=lambda se: se[0])
