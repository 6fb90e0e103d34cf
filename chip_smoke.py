#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and g++.  It builds the
port's C++ host runtime and its eight CUDA kernel sources from this
checkout (registers K1, dominance K2, members K3, the causal schedule
`clock.cu`, the whole-doc dominance route `dominance_indexes.cu`, the
sp-block route `dominance_block.cu`, the RGA linearize kernel
`linearize.cu`, which every path with list work runs, and the stable
sort `lexsort.cu`, which every path that sorts on the card runs: the
step and the resident routes), then:

  0. runs the first-call lane (right after the build, before this
     process calls any kernel; `first_call_lane`): six fresh processes
     of this script, two at a time, each starting eight threads on eight
     CUDA streams of `cuda:0`, released together by a barrier, whose
     calls are the process's first of the lexsort kernel (the sibling
     sort on its grid route at 131,072 rows, the register order per doc
     at D = 2,048, T = 32), the linearize kernel (16,384 rows on route
     (b), 4,096 on route (a)), K2 on its long route, then, each at a
     larger shape and on two threads a smaller one, of the kernels that
     set their shared-memory attribute (K2's short route and the
     schedule above 48 KB a block, the whole-doc route, the sp-block
     kernel), the barrier releasing every thread into each call, all on
     one seeded input set: every output bit-equal to its plain version
     and every route readout equal across the threads and processes; beside
     them one more fresh process in which
     a `MeshDocPool(4)` (four chip threads on `cuda:0`) takes config 3's
     first 512 docs as its first batch, every doc's bytes equal to a CPU
     pool's.  A child that dies by a signal fails the run with its
     status and stderr.  The kernels' per-device state and the library
     caches are per process, so only fresh processes can show a race at
     first use;
  1. applies the headline catch-up batch (bench config 3: 4096 Text docs,
     8 actors, 2 rounds, 16 ops per change, about 1.06 M ops) as ONE
     `apply_batch_bytes` on an `automerge_tpu_torch` pool on the card,
     and the same payload on a CPU pool (the plain PyTorch versions):
     the patch bytes must be equal, no register row may take the C++
     oracle, K1 and K2 must have launched, and the payload must have
     gone through two waves (wave pipelining: `pipeline.waves` = 2);
     then once more unpipelined (depth 1) on a fresh card pool: every
     doc's patch must equal the pipelined run's;
  2. applies the map-only batch (bench config 4: 1024 Table docs) the
     same way, in two waves: K1 must have launched;
  3. loads v1 checkpoints saved by the CPU pool into a card pool as one
     batched replay in two waves (the replay arm, STORAGE_NATIVE =
     False): every doc's patch must equal the CPU pool's; saves the
     same docs from the config-3 card pool as v2 checkpoints (the
     default): the bytes must equal the CPU pool's saves, and a fresh
     card pool replays them in one batch of two waves with every patch
     equal to the CPU pool's; loads both sets again arena-direct (the
     default `load_batch`, host-resolved in C++): patches, clocks and
     `doc_stats` rows must equal the replay arm's; then applies a
     pipelined batch of 256 docs with every private host array
     overwritten as soon as its upload returned (hostile staging): the
     bytes must still equal the CPU pool's;
  4. applies the 64-replica catch-up backlog (bench config 5: 8 docs x
     64 replicas x 13 changes x 15 ops, 99,840 ops, every register group
     wider than the member window) as ONE batch: K3 must have launched
     for the base window and at least one escalation tier, no row may
     take the oracle, and the bytes must equal a CPU pool's;
  5. runs config 5 as the bench runs it: a `BatchedReplicaSet` of 64
     card pools, each loading its own replica's backlog, then the full
     catch-up (every receiver's batch of the 63 other replicas'
     changes, 6,289,920 op-applications, delivered pipelined across the
     pools): K3 must launch, no row may take the oracle (the JAX set's
     count), the set must converge and every replica's tree of every
     doc must equal phase 4's union pool's;
  6. runs configs 3 and 4 as `bench.py::run_config` runs them, on a
     card `ShardedNativePool`: config 3 in threads mode (one shard per
     host core, at most 8) and in pipeline mode (20 shards), config 4 in
     threads mode; K1 (and K2) must launch, no row may take the oracle
     and every doc's patch must equal phases 1 and 2's one-pool result;
     prints wall, ops/s, shard and core counts and the spans (in threads
     mode a span sums over the shard threads and can exceed the wall);
  7. arms a fault at each site (native.begin, device.dispatch,
     device.collect, native.mid, escalation.tier) against a card
     `ShardedNativePool(4)` in each drive mode applying 256 config-3
     docs and one 20-writer hot key (which climbs into K3 and a tier):
     a permanent fault pinned to one doc must quarantine exactly that
     doc with every other doc's bytes equal to the fault-free run's, two
     transient faults must retry to equal bytes with a rollback, and no
     C++ batch handle may be left live;
  8. runs the cold start of `bench.py --coldstart` at 50,000 of its 100,000
     docs (850,000 changes; cut for the time limit): builds the corpus on a
     card pool (K1 and K2 launch), compacts every other doc, saves all into
     a durable `ColdStore`, restores it into a card `ShardedNativePool(4)`
     serially and fanned out (every doc counted, sampled saves and patches
     equal to the source's), restores the first 4,096 docs again through
     the replay arm on four shard threads (K1 and K2 launch, patches equal
     to the arena-direct restore's), and quarantines a blob corrupted on
     disk while every other doc restores;
  9. applies one hot map key beside a list object with 40, 200 and 300
     concurrent writers: the first two climb to tiers 64 and 256 with no
     oracle row (K3 and K2 launch), the third is over the scratch budget
     and all 300 rows take the oracle, as in the JAX package; the bytes
     must equal a CPU pool's in each case;
  10. edits a long text document (`workloads.long_text_doc`, then
     `workloads.keystroke_edits`: keystrokes one per batch, a delete, a
     concurrent insert, an actor that sorts between two known ones, a
     local change and its undo, a batch that also fills a second list)
     of 32,768 and 262,144 characters on a card pool, where the batches
     whose list work falls on the text alone take the device-resident
     arena: every such batch must take it, a keystroke must upload one
     row, the whole arena may cross only at the first batch and after
     the two invalidations, K1 and K2 must launch, and every result
     must equal that of a CPU pool (32,768) and of a card pool with the
     route off (both sizes); prints the per-edit wall time, spans (the
     C++ stage times `cxx.*` among them) and counters of both routes,
     and times one resident dispatch alone;
  11. holds each kernel against its plain PyTorch version on the card,
     bit-equal (integer outputs, tolerance 0), at the inputs the main paths
     gave it, at random shapes and at the edges of each design (register
     groups of exactly W and W + 1 rows across tile edges; elementless
     dominance ops at chunk edges, objects past the shared-memory budget,
     one 100,000-element list, 65,537 objects on the long route, past the
     grid's y limit, tiled from 8 seeded ones; member windows at every W
     from 8 to 1024, all empty, full of concurrent members, same-actor
     same-seq duplicates, deletes winning, one actor, tier chunks with
     groups of 1, W, W + 1 and 71 rows, repeated members, indexes clipped
     at T and a group too long for a block's span), and times kernel and
     plain version with CUDA events beside each call's bound
     (every call of a driven path is held bit-equal; the first call of
     each path is timed, and of the 64-pool catch-up and the fault lanes
     the first batch's member calls).  The step's two kernels (the
     schedule and the route) are also held at their edge cases (A of 32
     and 33, a queue needing C passes, a duplicate in its original's
     window; a doc with no valid op, a chunk boundary at T, docs of both
     route branches in one batch, object starts past shared memory),
     the route's branch counters against the model's per-doc flags, and
     timed as a CUDA graph of their launches (device time alone) beside
     the wrapper's back-to-back calls.  The linearize kernel is held
     bit-equal to the plain `list_rank.linearize` at every call of every
     driven path (the largest call of each path timed as the wrapper, as
     a CUDA graph and against the plain version; each call's route
     readout must name the list-ranking route, and every call on route
     (b) must run the same 4 grid barriers at any L) and at the edges of
     its design (`tests/torch_linearize_cases.py`: route (a)'s limit of
     8,192 elements and one above, L = 1, rounds too few for a chain, a
     garbage tail, the resident arena, config 3's 786,432 rows, and the
     tour's cases at two scales: a comb, deep nesting, heads only,
     one-element objects, malformed parents, n_iters at the route rule's
     threshold and one below; each case's route as the model's
     `route_of` gives it) and on four streams at once.  The lexsort kernel is held bit-equal (the
     whole permutation, garbage and padding rows included) to its plain
     versions (`list_rank.sibling_sort`, `mesh.register_order`) at every
     call of both entry points on every driven path (the largest call of
     each path timed as the wrapper and as a CUDA graph beside torch's
     stable sorts, `library_ms`), at the edges of its design
     (`tests/torch_lexsort_cases.py`, with the cluster's capacity and
     one row above it, and group ids at n_groups, -2 and their in-range
     twins), one call of each entry point on each route counted as one
     kernel and no copy by the profiler (right after phase 10), and on
     four streams at once beside the linearize kernel's cooperative grid
     (both on their grids); every main-path call's route readout is
     logged per path: each register order of the step on a per-doc route
     (a warp or a block a doc, or one doc on the cluster), each sibling
     sort up to the cluster's capacity on the cluster route; a
     resident dispatch must launch fewer than 69 kernels (the count with
     torch's sorts).  The sp-block kernel is held to the plain
     block mode at every call of phase 16 and at the route's seeded
     random and chunk-dependent cases split into sp = 2 and 4 blocks
     (chunks 64, 128 and 1024), whose sum must equal the
     whole-doc route's output, at a batch of docs of both of its
     branches and at a one-object arena of the long text's build shape,
     each call run once under the sync-debug mode 'error' and its
     branch counters held to the model's per-doc test (since PR 14); its
     timed calls are also set beside the whole-doc route's time on a
     seeded doc of the same shape.

  12. serves the Backend protocol from the card (run before the checks of
     phase 11, which hold its kernel calls bit-equal too): (a) 32
     connections x 6 rounds of the serve-check traffic against a real
     `python -m automerge_tpu_torch.sidecar.server --socket` subprocess,
     every response equal to the same traffic sent serially to a CPU
     gateway, median occupancy over 4 docs a flush, the queue drained, no
     oracle row and no live handle (single-writer registers resolve on
     the host: no kernel); then in-process card gateways, each lane's
     responses or frames equal to a CPU gateway's on the same traffic:
     (b) a queue of 8 ops sheds a burst with typed Overloaded envelopes
     and recovers; (c) 256 config-3 docs in apply_batch requests of 32
     from 8 connections (K1 + K2), then a 40-writer hot key (K3), oracle
     0; (d) `bench.py --fanout` at its defaults (1,024 peers, 24 docs,
     16 connections, 96 writes): every connection's frames, change->
     fan-out p50/p95/p99, amplification, encode reuse (K2); (e) one doc
     x 200 subscribers with a straggler and a patch-mode peer: encode
     reuse at least 199, no echo, patch frames, and the doc's `snapshot`
     loaded into a card pool equal to the replay of its history, the
     second fetch a cache hit.
  13. runs the port's fleet (after phase 12, before the checks of phase
     11, which hold its in-process kernel calls too): (a) three
     `--device cuda` replica server subprocesses behind an in-process
     `RouterGateway`, `tools/route_check.py`'s traffic (18 docs, zipf,
     6 writers, 160 requests): every response and final patch equal to
     one CPU gateway's serial replay, oracle 0 on every replica, then
     `Rebalancer` passes under the writers commit a migration with every
     (doc, seq) acked once and in order; (b) config 3's 4,096 docs in
     requests of 32 from 8 connections through the router (split across
     owners and joined): every doc's patch equal to phase 1's, each
     replica's K1 and K2 launches (read over its socket) above 0, then
     a 40-writer hot key whose owner launches K3; (e) `scrape_fleet` over
     the replicas' HTTP listeners: the section's pinned keys and a doc
     count of 4,096 + 18 + 1; (c) a `ReplicaSupervisor` of three card
     replicas with write-through stores, `HealthMonitor` and
     `FailoverExecutor` (`tools/failover_check.py`'s shape, 15 docs, 5
     writers): a SIGKILL mid-flush loses and duplicates no ack, the
     final patches equal a serial CPU replay, a subscriber resyncs with
     no gap, the respawned generation rejoins and takes a doc back, and
     every member launches K1 on a probe batch; (d) a card
     `ReadReplica` follows a card gateway through 15 flushes of two
     concurrent writers (its own pool launches K1 and K2), closes a
     forced gap of 5 changes by resync, answers a write with ReadOnly,
     and a second replica bootstraps from the gateway's write-through
     store, all equal to the upstream and to a CPU gateway; then
     `tools/readpath_check.py` arm 1 on the card gateway: a change-mode
     client with a full port backend and a patch-mode thin client follow
     20 writer flushes of one doc and both end equal to its `get_patch`
     (their apply CPU is printed, not asserted).
  14. runs the batched Python engine and the single-device resolver
     step (after phase 13, before the checks of phase 11, which hold
     their kernel calls too): (a) `TPUDocPool(device='cuda')` applies
     config 3 (4,096 docs, 1,064,960 ops) as one `apply_batch`, every
     patch equal to phase 1's and every whole-doc patch to the card
     pool's (K1 at W = 8, K2); (b) hot keys of 40 and 200 writers
     through the card engine (K3, tiers 64 and 256, no oracle row),
     patches and counters equal to a CPU engine's; (c) `single_step`
     over `mesh_encode.scaling_workload(2048)` (73,728 ops): every output
     key bit-equal to the CPU step's, the schedule kernel (`clock.cu`),
     K1 and the whole-doc dominance route (`dominance_indexes.cu`)
     launch, and `verify_against_pool` passes through a card engine; (d)
     config 1 (one Text doc, 10,000 inserts) through the step as
     `bench.py::run_config_1_mesh` runs it at sp = 1 (a warm-up, then
     the median of 3 timed runs), bit-equal to the CPU step and
     verified, and through one card `NativeDocPool`, its patch equal to
     the card engine's.  On (c) and (d) the step after its uploads runs
     under `torch.cuda.set_sync_debug_mode('error')` (no read of the card
     back to the host) and logs its per-stage times (uploads, schedule,
     registers, linearize, op metadata and deltas, the route: each
     stage's trace span on the host and CUDA events on the card); then
     20 steps of each lane here, 20 with the garbage collector off and
     20 in a fresh process of this checkout (`tools/step_ab.py --child`)
     show whether this long-lived process slows the step, with the main
     thread's share of CPU.  Phase 3's hostile-staging lane also runs
     the card engine and the step with every uploaded host array
     overwritten.
  15. drives port frontends (`import automerge_tpu_torch as am`) with
     the `backend=tpu` adapter's Backend surface as their immediate
     backend (after phase 14, before the checks of phase 11, which hold
     their kernel calls too; `tests/torch_frontend_cases.py`): (a) the
     reference-shaped session (changes with a Text and a Table,
     applyChanges, merge, undo and redo, getPatch, save then load)
     against a `python -m automerge_tpu_torch.sidecar.server --device
     cuda` subprocess on the adapter's stdio framing; (b) BASELINE config
     1 (10,000 characters in 200 changes of 50, actors a0 and a1 taking
     turns, each change applied locally by the writer's replica and
     remotely by the other's) and (c) three rounds of two frontends
     assigning the same keys and list elements, then 40 writers on one
     key, both through an in-process card `SidecarBackend.handle`: every
     request, patch and materialized document equal, as JSON, to the
     same lane on the port's scalar oracle; (b) and (c) must launch K1
     and K2, (c) K3 too; (b) logs its wall and the median and p99 round
     trip of one change.
  16. drives the multi-device path with every dp x sp cell on `cuda:0`
     (after phase 15, before the checks of phase 11, which hold its
     block-kernel calls too; `mesh_phase`): (a) the port's
     `dryrun_multichip(4)`: text, map and table workloads through the
     sharded step at dp = 2 x sp = 2, then `scaling_workload(2048)` at
     (dp, sp) = (1, 1), (2, 1), (4, 1), (2, 2), each verified against a
     card engine and bit-equal within its sp encoding (median of 3), and
     the (2, 2) step after its uploads under the sync-debug mode 'error';
     (b) config 1 through the sharded step at sp = 1, 2, 4, equal to
     `single_step`; (c) `MeshDocPool(dp)` at dp = 1, 2, 4 on config 3,
     every patch equal to phase 1's; (d) the sp-crossover probe, texts of
     8,192 to 262,144 characters in `MeshDocPool(1, 2)` with `sp_min` 16
     and the default, patches equal across the arms, each text's build
     batch timed (since PR 14); (e)
     `sync/distributed.launch(2)`, the workers' pools on `cuda:0`, gossip
     over gloo.  Phase 3's hostile-staging lane also runs a
     `MeshDocPool(2)` and the dp = 2 x sp = 2 sharded step.  The block
     route's branch counters over (a), (b) and (d) must show every doc
     on its fast branch.
  17. checks the port's static gate and its alias sanitizer (after phase
     16, before the checks of phase 11, which hold its kernel calls too;
     `analysis_phase`): (a) `python -m
     automerge_tpu_torch.tools.static_check --no-lint` on this checkout
     must report 0 findings; (b) three rounds of
     `tests/test_analysis.py::BATCH_WORKLOAD`'s shape at 4,096 docs x 8
     actors (32,768 fresh clock rows a round) on card pools with the
     resident clock cache engaged, unarmed and with `sanitize.arm()`:
     equal bytes, equal to a CPU pool's, buffers poisoned
     (`sanitize.poisoned_buffers`); (c) the deliberate alias: a patched
     delta hands the clock table its staging rows from page-locked
     memory in a non_blocking copy queued behind `torch.cuda._sleep`,
     the sanitizer poisons them, and the bytes must diverge.  The
     scheduler's and the resident route's tallies (`sched.*`,
     `ops.register_rows`, `resident.*_upload_rows`, ...) are phase
     counters, as in the JAX package: phases 5, 10 and 12 (a) read them
     from the phase table with span tracing on.

The launch counts of each path are zeroed just before the path runs and
read just after; launches made for the comparisons do not count.  The
last three lines are the kernel table (JSON), the card's name and power
limit, and {"ok": true, "device": {...}}.  Any failed phase exits
nonzero without the last line.
"""

import concurrent.futures
import json
import os
import random
import re
import subprocess
import sys
import threading
import time
import traceback

#: when this process started running the script (the lane's children
#: report their start-up from it)
T_START = time.perf_counter()
#: the checkout this script runs from
ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_INT_OPS_PER_S = 67e12          # non-tensor 32-bit rate (fp32 entry)

#: long-document sizes of the resident phase (characters once the edit
#: stream has run, so the arena keeps one capacity), the keystrokes of
#: its stream and the edits its per-edit time is the median of (every
#: keystroke after the first two)
RESIDENT_SIZES = (32768, 262144)
N_KEYS = 24
TIMED_EDITS = slice(3, 1 + N_KEYS)
CXX_SPANS = ('cxx.decode', 'cxx.schedule', 'cxx.encode', 'cxx.mid',
             'cxx.emit', 'cxx.domlay')
EDIT_SPANS = ('host.begin', 'device.dispatch', 'device.collect', 'host.mid',
              'host.finish') + CXX_SPANS
#: the 64-pool catch-up's driven path, whose kernel calls are all held
#: bit-equal but timed only for the first receiver
CATCH_UP = 'config5 catch-up gpu'
#: the member kernel's paths whose calls are all held bit-equal but
#: timed only up to the second base pass (the first batch's calls)
FIRST_BATCH_TIMED = (CATCH_UP, 'faults pipeline gpu', 'faults threads gpu')
N_REPLICAS = 64
#: kernels one resident dispatch launched while torch's four stable sorts
#: did its sibling sort (PERF.md §5); the lexsort kernel's one launch must
#: leave fewer
RESIDENT_KERNELS_BEFORE = 69
RESIDENT_COUNTERS = ('resident.dispatches', 'resident.full_upload_rows',
                     'resident.delta_upload_rows', 'resident.no_upload',
                     'resident.actor_invalidation',
                     'resident.cross_path_invalidation')
#: the pool's per-batch tallies that count in telemetry's phase table
#: (`trace.count`, while span tracing is on), as the JAX package's do;
#: a path driven with `phases=True` reads them beside the flat counters
PHASE_COUNTERS = ('sched.fast_path', 'sched.queued', 'sched.trivial_rows',
                  'sched.trivial_groups', 'ops.register_rows',
                  'registers.sliding_over_members', 'resident.dispatch',
                  'resident.sharded_dispatch', 'resident.full_upload_rows',
                  'resident.delta_upload_rows', 'resident.no_upload',
                  'resident.actor_invalidation',
                  'resident.cross_path_invalidation',
                  'sanitize.poisoned_buffers')


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def device_ms(torch, fn, reps=20, rounds=5, graph=False):
    """Per-call device time of fn(): `reps` back-to-back calls between two
    CUDA events, divided by `reps`; the median over `rounds`.  With
    `graph`, the calls captured in one CUDA graph (the kernels' device
    time alone); `tools/step_ab.timed_ms`."""
    from step_ab import timed_ms
    return timed_ms(torch, fn, reps, rounds, graph=graph)


def registers_launcher(torch, _build, args, window):
    """The register kernel's C entry point alone, on outputs allocated
    once: what `ms` times (the wrapper adds allocation and checks)."""
    ins = [a.contiguous() for a in args]
    T = ins[0].numel()
    dev = ins[0].device
    outs = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in (
        ((T,), torch.int32), ((T, window), torch.int32),
        ((T,), torch.int32), ((T,), torch.bool), ((T,), torch.bool),
        ((T,), torch.int32))]
    lib = _build.kernel('registers')
    ptrs = [t.data_ptr() for t in ins + outs]
    extra = (T, window, ins[6].shape[1], _build.stream_of(ins[0]))

    def launch(keep=(ins, outs)):
        _build.check(lib.amtpu_torch_registers(*ptrs, *extra), 'registers')
    return launch


def dominance_launcher(torch, _build, dominance_kernel, args, chunk):
    """The dominance kernel's C entry point alone, on an output (and the
    scratch the kernel asks for) allocated once."""
    vis0 = args[0].to(torch.float32).contiguous()
    ins = [vis0] + [a.to(torch.int32).contiguous() for a in args[1:5]] + \
        [args[5].to(torch.bool).contiguous()]
    O, L = vis0.shape
    T = ins[2].shape[1]
    index = torch.empty((O, T), dtype=torch.int32, device=vis0.device)
    lib = _build.kernel('dominance')
    scratch = dominance_kernel.scratch_for(lib, O, L, T, chunk, vis0.device)
    ptrs = [t.data_ptr() for t in ins + [index]] + \
        [None if scratch is None else scratch.data_ptr()]
    extra = (O, L, T, chunk, _build.stream_of(vis0))

    def launch(keep=(ins, index, scratch)):
        _build.check(lib.amtpu_torch_dominance(*ptrs, *extra), 'dominance')
    return launch


def members_launcher(torch, _build, args, window, want_vb):
    """The member kernel's C entry point alone, on outputs allocated once
    (args as `resolve_registers_members`: time, actor, seq, mem_idx,
    is_del, clock_table, clock_idx)."""
    time_, actor, seq, mem, is_del, table, cidx = [a.contiguous()
                                                  for a in args]
    T = time_.numel()
    dev = time_.device
    outs = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in (
        ((T,), torch.int32), ((T, window), torch.int32),
        ((T,), torch.int32), ((T,), torch.bool), ((T,), torch.bool),
        ((T,), torch.int32))]
    lib = _build.kernel('members')
    ins = [time_, actor, seq, cidx, is_del, mem, table]
    ptrs = [t.data_ptr() for t in ins] + [o.data_ptr() for o in outs]
    if not want_vb:
        ptrs[10] = None
    extra = (T, window, table.shape[1], _build.stream_of(time_))

    def launch(keep=(ins, outs)):
        _build.check(lib.amtpu_torch_members(*ptrs, *extra), 'members')
    return launch


# -- random kernel inputs (numpy, from a seed) ------------------------------

def registers_case(np, rs, T, A, W):
    n_groups = max(T // 3, 1)
    group = rs.randint(0, n_groups, T).astype(np.int32)
    group[rs.random_sample(T) < 0.05] = -1                 # padding rows
    time_ = rs.permutation(T).astype(np.int32)
    state = np.nonzero(rs.random_sample(T) < 0.05)[0]      # state rows
    time_[state] = -1 - np.arange(state.size, dtype=np.int32)
    actor = rs.randint(0, A, T).astype(np.int32)
    seq = rs.randint(1, 12, T).astype(np.int32)
    C = max(T // 4, 1)
    table = rs.randint(0, 12, (C, A)).astype(np.int32)
    cidx = rs.randint(0, C, T).astype(np.int32)
    is_del = rs.random_sample(T) < 0.1
    sort_idx = np.lexsort((time_, group)).astype(np.int32)
    return (group, time_, actor, seq, is_del, sort_idx, table, cidx)


def registers_groups_case(np, rs, sizes, A, pad):
    """Register groups of the given row counts, in (group, time) order
    after `pad` padding rows (group -1 sorts first), so groups sit at
    chosen offsets against the kernel's 128-row tiles; state rows (negative
    times) open every eighth group; original row order is shuffled."""
    sizes = np.asarray(sizes)
    group = np.concatenate([np.full(pad, -1), np.repeat(
        np.arange(sizes.size), sizes)]).astype(np.int32)
    T = group.size
    time_ = np.arange(T, dtype=np.int32)
    starts = pad + np.concatenate([[0], np.cumsum(sizes)[:-1]])
    time_[starts[::8]] = -1 - np.arange(starts[::8].size, dtype=np.int32)
    C = max(T // 4, 1)
    cols = [group, time_, rs.randint(0, A, T).astype(np.int32),
            rs.randint(1, 12, T).astype(np.int32),
            rs.random_sample(T) < 0.1,
            rs.randint(0, C, T).astype(np.int32)]
    inv = np.argsort(rs.permutation(T))
    group, time_, actor, seq, is_del, cidx = [c[inv] for c in cols]
    table = rs.randint(0, 12, (C, A)).astype(np.int32)
    sort_idx = np.lexsort((time_, group)).astype(np.int32)
    return (group, time_, actor, seq, is_del, sort_idx, table, cidx)


def dominance_case(np, rs, O, L, T, all_visible=False):
    n = rs.randint(1, L + 1, O) if not all_visible else np.full(O, L)
    t = rs.randint(1, T + 1, O) if not all_visible else np.full(O, T)
    valid_e = np.arange(L)[None] < n[:, None]
    keys = np.where(valid_e, rs.random_sample((O, L)), 2.0)
    er = np.argsort(np.argsort(keys, axis=1), axis=1)
    er = np.where(valid_e, er, -1).astype(np.int32)
    vis = valid_e if all_visible else valid_e & (rs.random_sample((O, L))
                                                 < 0.5)
    v0 = vis.astype(np.float32)
    ov = np.arange(T)[None] < t[:, None]
    oe = np.where(ov, (rs.random_sample((O, T)) * n[:, None]).astype(
        np.int32), -1).astype(np.int32)
    orank = np.where(ov, np.take_along_axis(er, np.maximum(oe, 0), axis=1),
                     -1).astype(np.int32)
    od = np.where(ov, rs.randint(-1, 2, (O, T)), 0).astype(np.int32)
    return (v0, er, oe, orank, od, ov)


def elementless_at_chunk_edges(np, case, chunk):
    """Valid ops with op_elem == -1 and a nonzero delta as the first and
    the last op of every chunk: they count inside their chunk only."""
    v0, er, oe, orank, od, ov = [np.array(a) for a in case]
    for c0 in range(0, oe.shape[1], chunk):
        for t in (c0, c0 + chunk - 1):
            oe[ov[:, t], t] = -1
            od[ov[:, t], t] = 1 if t % 2 else -1
    return v0, er, oe, orank, od, ov


# -- bounds: the least time the card could take for the same work ---------

def registers_bound(torch, args, window):
    """Bytes: the eight input columns, the clock-table rows that
    clock_idx references (not the unused rows of a pool table) and the
    outputs, each once.  Operations: one compare and one add per window
    slot and row, the floor of any form of this function."""
    group, clock_table, clock_idx = args[0], args[6], args[7]
    T = group.numel()
    rows = int(torch.unique(clock_idx).numel())
    read = T * (6 * 4 + 1) + rows * clock_table.shape[1] * 4
    written = T * (3 * 4 + 4 * window + 2)
    ops = T * (window + 1) * 2
    t_bytes = (read + written) / H100_BYTES_PER_S
    t_ops = ops / H100_INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def dominance_bound(args, chunk):
    """Bytes: vis0 and elem_rank, the four op columns and the index,
    each once.  Operations: the least the closed form needs -- one add
    per rank bucket and object for the start-state prefix (L + 2), and a
    compare and an add per pair of valid ops s < t in one chunk for the
    in-chunk term (the earlier-chunk term is folded into the prefix)."""
    vis0, op_valid = args[0], args[5]
    O, L = vis0.shape
    T = op_valid.shape[1]
    moved = O * L * 8 + O * T * (3 * 4 + 1) + O * T * 4
    v = op_valid.reshape(O, T // chunk, chunk).sum(2).long()
    ops = O * (L + 2) + 2 * int((v * (v - 1) // 2).sum())
    t_bytes = moved / H100_BYTES_PER_S
    t_ops = ops / H100_INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def members_bound(torch, args, window, alive_after, want_vb):
    """Bytes: the [T, W] member matrix, the five columns, the clock-table
    rows clock_idx references and the outputs (winner, alive_after,
    packed, the [T, W] conflicts, overflow and, when asked for,
    visible_before), each once.  Operations, counted from this call's
    data: per row, one supersession test per unordered pair of valid
    members (only the later of two can supersede the earlier: two clock
    compares, the concurrency and, and the or into the flag -- 4), and
    one ordering step per ordered pair of alive members (the actor
    compare, the tie compare on time and the add -- 3)."""
    mem, table, cidx = args[3], args[5], args[6]
    T = mem.shape[0]
    rows = int(torch.unique(cidx).numel())
    read = T * window * 4 + T * (4 * 4 + 1) + rows * table.shape[1] * 4
    written = T * (3 * 4 + 4 * window + 1 + (1 if want_vb else 0))
    n_valid = 1 + (mem >= 0).sum(1).long()
    n_alive = alive_after.long()
    ops = 4 * int((n_valid * (n_valid - 1) // 2).sum()) + \
        3 * int((n_alive * (n_alive - 1)).sum())
    t_bytes = (read + written) / H100_BYTES_PER_S
    t_ops = ops / H100_INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def schedule_bound(args):
    """Bytes: the clock, the three change columns, the dependency rows
    and `valid` read once, the order and the new clock written once.
    Operations: one pass over every valid change (the least any schedule
    needs: each change's readiness is tested at least once), one compare
    per actor of its dependency row and a few for the clock update."""
    clock, actor, _seq, deps, valid = args
    D, A = clock.shape
    C = actor.shape[1]
    moved = D * A * 4 * 2 + D * C * (4 * 2 + 1 + 4) + D * C * A * 4
    ops = int(valid.sum()) * (A + 4)
    t_bytes = moved / H100_BYTES_PER_S
    t_ops = ops / H100_INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def indexes_bound(args):
    """Bytes: the three element columns and the five op columns read
    once, the index written once.  Operations: per doc one add per
    element for the start-state prefix, and a compare and an add per pair
    of valid ops in one chunk of 64 ops (as `dominance_bound` counts the
    regrouped form, whose chunk that is)."""
    chunk = 64
    elem_obj, op_valid = args[0], args[7]
    D, L = elem_obj.shape
    T = op_valid.shape[1]
    moved = D * L * 12 + D * T * (4 * 4 + 1) + D * T * 4
    import torch
    v = op_valid.long()
    v = torch.cat([v, v.new_zeros((D, (-T) % chunk))], dim=1)
    v = v.reshape(D, -1, chunk).sum(2)
    ops = D * (L + 2) + 2 * int((v * (v - 1) // 2).sum())
    t_bytes = moved / H100_BYTES_PER_S
    t_ops = ops / H100_INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


# -- each kernel against its plain version on the card ---------------------

def check_registers(torch, card, label, args, window, timed=True):
    """Bit-equality of the register kernel with its plain version, and
    (`timed`) the kernel's own time; returns (max abs error, ms or
    None)."""
    from automerge_tpu_torch.ops import _build, registers_kernel
    from automerge_tpu_torch.ops import registers as R
    got = registers_kernel.resolve_registers_cuda(*args, window=window)
    want = R.resolve_registers(*args, window=window)
    bad = sum(int((got[k] != want[k]).sum()) for k in want)
    err = max(int((got[k].long() - want[k].long()).abs().max())
              if want[k].numel() else 0 for k in want)
    if bad:
        raise AssertionError('registers %s: %d mismatches' % (label, bad))
    if not timed:
        return err, None
    ms = device_ms(torch, registers_launcher(torch, _build, args, window))
    log('registers %s: mismatches %d, kernel %.4f ms on %s'
        % (label, bad, ms, card))
    if bad:
        raise AssertionError('registers %s: %d mismatches' % (label, bad))
    return err, ms


def check_dominance(torch, card, label, args, chunk=64, timed=True):
    """Bit-equality of the dominance kernel with its plain version where
    op_valid holds, and (`timed`) the kernel's own time; returns (error,
    ms or None)."""
    from automerge_tpu_torch.ops import _build, dominance_kernel, list_rank
    got = dominance_kernel.dominance_grouped_cuda(*args, chunk=chunk)
    want = list_rank.dominance_grouped(*args, chunk=chunk)
    ov = args[5]
    bad = int((got[ov] != want[ov]).sum())
    err = int((got[ov].long() - want[ov].long()).abs().max()) \
        if ov.any() else 0
    if bad:
        raise AssertionError('dominance %s: %d mismatches' % (label, bad))
    if not timed:
        return err, None
    ms = device_ms(torch, dominance_launcher(torch, _build, dominance_kernel,
                                             args, chunk))
    bound, by = dominance_bound(args, chunk)
    log('dominance %s: mismatches %d (max count %d), kernel %.4f ms, '
        'bound %.3g ms (%s) on %s' % (label, bad, int(want.max()), ms,
                                      bound, by, card))
    if bad:
        raise AssertionError('dominance %s: %d mismatches' % (label, bad))
    return err, ms


def check_members(torch, card, label, args, window, want_vb=True,
                  timed=True):
    """Bit-equality of the member kernel with its plain version, and
    (`timed`) the kernel's own time; returns (max abs error, ms, bound
    ms, bound by), the last three None when not timed."""
    from automerge_tpu_torch.ops import _build, members_kernel
    from automerge_tpu_torch.ops import registers as R
    kw = dict(window=window, want_visible_before=want_vb)
    got = members_kernel.resolve_registers_members_cuda(*args, **kw)
    want = R.resolve_registers_members(*args, **kw)
    if set(got) != set(want):
        raise AssertionError('members %s: outputs %s, plain %s'
                             % (label, sorted(got), sorted(want)))
    bad = sum(int((got[k] != want[k]).sum()) for k in want)
    err = max(int((got[k].long() - want[k].long()).abs().max())
              if want[k].numel() else 0 for k in want)
    if not timed:
        if bad:
            raise AssertionError('members %s: %d mismatches' % (label, bad))
        return err, None, None, None
    ms = device_ms(torch, members_launcher(torch, _build, args, window,
                                           want_vb))
    bound, by = members_bound(torch, args, window, want['alive_after'],
                              want_vb)
    log('members %s: mismatches %d (max alive %d), kernel %.4f ms, bound '
        '%.3g ms (%s) on %s' % (label, bad, int(want['alive_after'].max())
                                if want['alive_after'].numel() else 0, ms,
                                bound, by, card))
    if bad:
        raise AssertionError('members %s: %d mismatches' % (label, bad))
    return err, ms, bound, by


def check_schedule(torch, card, label, args, timed=True):
    """Bit-equality of the schedule kernel with its plain version (torch
    ops on the card), and (`timed`) the wrapper's time (`ms`: back-to-
    back calls, host work included), the kernel's device time alone (a
    CUDA graph of its launches) and the plain version's; returns (max
    abs error, ms, plain ms, bound ms, bound by, graph ms), the last
    five None when not timed."""
    from automerge_tpu_torch.ops import clock, clock_kernel
    got = clock_kernel.schedule_queue_cuda(*args)
    want = clock.schedule_queue_batch(*args)
    bad = sum(int((g != w).sum()) for g, w in zip(got, want))
    err = max(int((g.long() - w.long()).abs().max()) if w.numel() else 0
              for g, w in zip(got, want))
    if bad:
        raise AssertionError('schedule %s: %d mismatches' % (label, bad))
    if not timed:
        return err, None, None, None, None, None
    ms = device_ms(torch, lambda: clock_kernel.schedule_queue_cuda(*args))
    g_ms = device_ms(torch, lambda: clock_kernel.schedule_queue_cuda(*args),
                     graph=True)
    plain_ms = device_ms(torch, lambda: clock.schedule_queue_batch(*args),
                         reps=2, rounds=3)
    bound, by = schedule_bound(args)
    D, A = args[0].shape
    order, valid = want[0], args[4]
    log('schedule %s D=%d C=%d A=%d: mismatches 0 (of %d valid changes %d '
        'applied, %d duplicates, %d never ready), wrapper %.4f ms, kernel '
        'as a CUDA graph %.4f ms, plain %.4f ms, bound %.3g ms (%s) on %s' % (
            label, D, args[1].shape[1], A, int(valid.sum()),
            int(((order >= 0) & (order != clock.NOT_APPLIED)).sum()),
            int((order == clock.DUPLICATE).sum()),
            int(((order == clock.NOT_APPLIED) & valid).sum()), ms,
            g_ms, plain_ms, bound, by, card))
    return err, ms, plain_ms, bound, by, g_ms


def check_indexes(torch, card, label, args, timed=True, fast=None):
    """Bit-equality of the whole-doc dominance route
    (`csrc/dominance_indexes.cu`) with the plain
    `list_rank.dominance_indexes` (chunk 128, the step's default) on the
    card, its docs' branches (`fast`: the docs that must take the fast
    branch, every doc when None; read from the route's device counters
    once the timing is done), and (`timed`) the wrapper's time (`ms`:
    back-to-back calls), the route's device time alone (a CUDA graph of
    its launches) and the plain version's; returns (max abs error, ms,
    plain ms, bound ms, bound by, graph ms), the last five None when not
    timed."""
    from automerge_tpu_torch.ops import dominance_kernel, list_rank
    D = args[0].shape[0] if args[0].dim() == 2 else 1
    counts = dominance_kernel.branch_counts(args[0].device)
    counts.zero_()
    got = dominance_kernel.dominance_indexes_cuda(*args)
    want = list_rank.dominance_indexes(*args, chunk=128)
    bad = int((got != want).sum())
    err = int((got.long() - want.long()).abs().max()) if want.numel() else 0
    if bad:
        raise AssertionError('dominance_indexes %s: %d mismatches'
                             % (label, bad))
    ms = plain_ms = bound = by = g_ms = None
    if timed:
        ms = device_ms(torch, lambda: dominance_kernel.dominance_indexes_cuda(
            *args))
        g_ms = device_ms(torch, lambda: dominance_kernel
                         .dominance_indexes_cuda(*args), graph=True)
        plain_ms = device_ms(torch, lambda: list_rank.dominance_indexes(
            *args, chunk=128), reps=2, rounds=3)
        bound, by = indexes_bound(args)
    # every run of the route adds (fast docs, scan docs) to the counters
    n_fast, n_scan = counts.tolist()
    want_fast = D if fast is None else fast
    runs = (n_fast + n_scan) // max(D, 1)
    if args[3].shape[-1] and (runs < 1 or n_fast + n_scan != runs * D
                              or n_fast != runs * want_fast):
        raise AssertionError('dominance_indexes %s: branch counters %d fast '
                             '%d scan, expected %d of %d docs fast a run'
                             % (label, n_fast, n_scan, want_fast, D))
    if timed:
        L = args[0].shape[-1]
        log('dominance_indexes %s D=%d L=%d T=%d: mismatches 0 (max index '
            '%d), %d fast / %d chunk-scan docs a run, wrapper %.4f ms, '
            'route as a CUDA graph %.4f ms, plain %.4f ms, bound %.3g ms '
            '(%s) on %s' % (
                label, D, L, args[3].shape[-1], int(want.max())
                if want.numel() else 0, want_fast, D - want_fast, ms,
                g_ms, plain_ms, bound, by, card))
    return err, ms, plain_ms, bound, by, g_ms


def step_cases(torch, np, card):
    """The schedule kernel and the whole-doc dominance route at seeded
    random shapes (duplicates, never-ready changes, padding rows, A above
    a warp; invalid ops and padding elements), at their edge cases
    (`torch_step_cases.schedule_edge_cases`, `indexes_edge_cases`: A of
    32 and 33, a queue of C passes, a duplicate in its original's
    window, a doc of padding; a doc with no valid op, ops ending at a
    chunk boundary, docs of both branches in one batch, object starts
    past shared memory), and on inputs that do not regroup (the route's
    chunk-scan branch, chunks 16 and 128); each route call's branches
    are held to the model's per-doc flags.  Returns the largest error of
    each (0: bit-equal)."""
    from torch_step_cases import (INDEXES_SHAPES, SCAN_SHAPES,
                                  SCHEDULE_SHAPES, dominance_indexes_case,
                                  dominance_scan_case, indexes_edge_cases,
                                  route_regroups, schedule_case,
                                  schedule_edge_cases)
    dev = torch.device('cuda')

    def on_card(case):
        return [torch.from_numpy(np.asarray(x)).to(dev) for x in case]

    def model_fast(case):
        return sum(route_regroups(*[np.asarray(x[d]) for x in case])
                   for d in range(case[0].shape[0]))

    err_s = err_i = 0
    for shape in SCHEDULE_SHAPES:
        e = check_schedule(torch, card, 'random', on_card(schedule_case(
            np.random.RandomState(sum(shape)), *shape)))[0]
        err_s = max(err_s, e)
    for label, case in schedule_edge_cases(np.random.RandomState(12)):
        err_s = max(err_s, check_schedule(torch, card, 'edge: ' + label,
                                          on_card(case), timed=False)[0])
    log('schedule: %d edge cases bit-equal to the plain version on %s'
        % (len(schedule_edge_cases(np.random.RandomState(12))), card))
    for shape in INDEXES_SHAPES:
        e = check_indexes(torch, card, 'random', on_card(
            dominance_indexes_case(np.random.RandomState(sum(shape)),
                                   *shape)))[0]
        err_i = max(err_i, e)
    for shape in SCAN_SHAPES:
        case = dominance_scan_case(np.random.RandomState(sum(shape)), *shape)
        if model_fast(case):
            raise AssertionError('a chunk-dependent case regroups')
        e = check_indexes(torch, card, 'chunk-dependent (chunk-scan branch, '
                          'chunk 128)', on_card(case), fast=0)[0]
        err_i = max(err_i, e)
    edges = indexes_edge_cases(np.random.RandomState(13))
    for label, case in edges:
        fast = model_fast(case)
        e = check_indexes(torch, card, 'edge: ' + label, on_card(case),
                          timed=False, fast=fast)[0]
        err_i = max(err_i, e)
        log('dominance_indexes edge: %s: bit-equal, %d of %d docs on the '
            'fast branch (the model\'s flags) on %s'
            % (label, fast, case[0].shape[0], card))
    return err_s, err_i


def check_block(torch, card, label, args, kw, timed=True, fast=None):
    """Bit-equality of the sp-block kernel (`csrc/dominance_block.cu`)
    with the block mode of the plain `list_rank.dominance_indexes` on the
    card, at the call's chunk and l_offset (the kernel also takes the
    docs' object starts, `kw['starts']`), the kernel run once under the
    sync-debug mode 'error' (no host read); its docs' branches (`fast`:
    the docs that must take the fast branch, every doc when None; from
    `block_branch_counts`, read once the run and the timing are done);
    and (`timed`) the wrapper's time (`ms`: back-to-back calls), its
    device time alone (a CUDA graph of its launches), the plain
    version's, and as a yardstick the whole-doc route's on a seeded
    regrouping doc of the same shape (`route_ms`, `route_graph_ms`).
    Returns (max abs error, ms, plain ms, bound ms, bound by, graph ms,
    route ms, route graph ms), the last seven None when not timed.  The
    bound counts, as `indexes_bound` does, the regrouped form's work over
    the block's elements."""
    import numpy as np

    from automerge_tpu_torch.ops import dominance_kernel, list_rank
    from torch_step_cases import dominance_indexes_case
    plain_kw = {'chunk': kw.get('chunk', 64),
                'l_offset': kw.get('l_offset', 0)}
    kw = dict(plain_kw, starts=kw['starts'])
    counts = dominance_kernel.block_branch_counts(args[0].device)
    counts.zero_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = dominance_kernel.dominance_indexes_block_cuda(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = list_rank.dominance_indexes(*args, block=True, **plain_kw)
    bad = int((got != want).sum())
    err = int((got.long() - want.long()).abs().max()) if want.numel() else 0
    if bad:
        raise AssertionError('dominance_block %s: %d mismatches'
                             % (label, bad))
    out = [None] * 7
    D = args[0].shape[0] if args[0].dim() == 2 else 1
    if timed:
        # a call of tens of ms (the long text's build) is timed in fewer runs
        heavy = args[0].numel() * args[3].shape[-1] > (1 << 28)
        reps, rounds = (2, 3) if heavy else (20, 5)

        def call():
            return dominance_kernel.dominance_indexes_block_cuda(*args, **kw)
        ms = device_ms(torch, call, reps, rounds)
        g_ms = device_ms(torch, call, reps, rounds, graph=True)
        plain_ms = device_ms(torch, lambda: list_rank.dominance_indexes(
            *args, block=True, **plain_kw), reps=1 if heavy else 2,
            rounds=1 if heavy else 3)
        bound, by = indexes_bound(args if args[0].dim() == 2
                                  else [a[None] for a in args])
        Ll, T = args[0].shape[-1], args[3].shape[-1]
        yard = [torch.from_numpy(np.asarray(x)).to(args[0].device)
                for x in dominance_indexes_case(np.random.RandomState(0), D,
                                                Ll, T, 1)]

        def route():
            return dominance_kernel.dominance_indexes_cuda(*yard)
        route_ms = device_ms(torch, route, reps, rounds)
        route_g = device_ms(torch, route, reps, rounds, graph=True)
        out = [ms, plain_ms, bound, by, g_ms, route_ms, route_g]
    # every run of the kernel adds (fast docs, scan docs) to the counters
    n_fast, n_scan = counts.tolist()
    want_fast = D if fast is None else fast
    runs = (n_fast + n_scan) // max(D, 1)
    if args[3].shape[-1] and (runs < 1 or n_fast + n_scan != runs * D
                              or n_fast != runs * want_fast):
        raise AssertionError('dominance_block %s: branch counters %d fast '
                             '%d scan, expected %d of %d docs fast a run'
                             % (label, n_fast, n_scan, want_fast, D))
    if timed:
        log('dominance_block %s D=%d Ll=%d T=%d chunk=%d l_offset=%d: '
            'mismatches 0, %d fast / %d scan docs a run, no host read, '
            'wrapper %.4f ms, kernel as a CUDA graph %.4f ms, plain %.4f '
            'ms, the whole-doc route at the shape %.4f ms (graph %.4f), '
            'bound %.3g ms (%s) on %s' % (
                label, D, args[0].shape[-1], args[3].shape[-1],
                plain_kw['chunk'], plain_kw['l_offset'], want_fast,
                D - want_fast, out[0], out[4], out[1], out[5], out[6],
                out[2], out[3], card))
    return tuple([err] + out)


def block_flags(np, case, starts, l_offset):
    """The model's per-doc regroup test (`torch_step_cases.
    block_regroups`) of one block's numpy columns: the docs that take the
    fast branch."""
    from torch_step_cases import block_regroups
    return sum(block_regroups(case[0][d], case[1][d], case[2][d], starts[d],
                              *[x[d] for x in case[3:]], l_offset)
               for d in range(case[0].shape[0]))


def block_cases(torch, np, card):
    """The sp-block kernel at the seeded random and chunk-dependent cases
    of the whole-doc route (`torch_step_cases`), each doc's elements split
    into sp = 2 and 4 blocks: every block bit-equal to the plain block
    mode at chunks 64, 128 and 1024, and the blocks' sum at chunk 128
    bit-equal to the whole-doc route's output (`csrc/dominance_indexes.cu`,
    the chunk-scan branch on the chunk-dependent cases); then a batch of
    both branches (`mixed_block_case`, chunks 16 and 1024) and a seeded
    one-object arena at the long text's build shape (`resident_block_case`,
    262,144 elements and ops, two blocks, chunk 64).  Every call runs
    under the sync-debug mode 'error' and its branch counters are held to
    the model's per-doc test (`block_regroups`): the fast branch on the
    random and one-object cases, the scan branch on the chunk-dependent
    ones.  Returns the largest error (0: bit-equal)."""
    from automerge_tpu_torch.ops import dominance_kernel
    from torch_step_cases import (INDEXES_SHAPES, SCAN_SHAPES,
                                  dominance_indexes_case,
                                  dominance_scan_case, mixed_block_case,
                                  resident_block_case)
    dev = torch.device('cuda')
    err = n_calls = 0
    branches = [0, 0]

    def blocks(label, case, sps, chunks, route_chunk=None, want=None):
        nonlocal err, n_calls
        cc = [torch.from_numpy(np.asarray(x)).to(dev) for x in case]
        starts = dominance_kernel.object_starts(cc[0])
        st = starts.cpu().numpy()
        route = None if route_chunk is None else \
            dominance_kernel.dominance_indexes_cuda(*cc, chunk=route_chunk)
        L = cc[0].shape[1]
        for sp in sps:
            Ll = L // sp
            if Ll * sp != L:
                raise AssertionError('block case L=%d: sp=%d' % (L, sp))
            flags = []
            for s in range(sp):
                b = slice(s * Ll, (s + 1) * Ll)
                flags.append(block_flags(np, [x[:, b] for x in case[:3]]
                                         + list(case[3:]), st, s * Ll))
                if want is not None and flags[-1] != want * len(cc[0]):
                    raise AssertionError('block case %s: the model gives %d '
                                         'fast docs' % (label, flags[-1]))
            for chunk in chunks:
                parts = []
                for s in range(sp):
                    b = slice(s * Ll, (s + 1) * Ll)
                    args = [cc[0][:, b], cc[1][:, b], cc[2][:, b]] + cc[3:]
                    kw = {'chunk': chunk, 'l_offset': s * Ll,
                          'starts': starts}
                    fast = flags[s]
                    err = max(err, check_block(
                        torch, card, '%s sp=%d' % (label, sp), args, kw,
                        timed=False, fast=fast)[0])
                    n_calls += 1
                    branches[0] += fast
                    branches[1] += len(cc[0]) - fast
                    parts.append(dominance_kernel
                                 .dominance_indexes_block_cuda(*args, **kw))
                if chunk == route_chunk and not bool(
                        (torch.stack(parts).sum(0, dtype=torch.int32)
                         == route).all()):
                    raise AssertionError(
                        'dominance_block %s sp=%d: the blocks\' sum '
                        'differs from the whole-doc route' % (label, sp))

    for make, shapes, want in ((dominance_indexes_case, INDEXES_SHAPES, 1),
                               (dominance_scan_case, SCAN_SHAPES, 0)):
        for shape in shapes:
            blocks('%s %s' % (make.__name__, shape), make(
                np.random.RandomState(sum(shape)), *shape), (2, 4),
                (64, 128, 1024), route_chunk=128, want=want)
    for L, T in ((48, 32), (400, 600)):
        blocks('mixed branches L=%d T=%d' % (L, T), mixed_block_case(
            np.random.RandomState(L + T), 6, L, T), (2, 4), (16, 1024),
            route_chunk=16)
    blocks('one object at the build\'s shape', resident_block_case(
        np.random.RandomState(5), 262144, 262144, 262144), (2,), (64,),
        route_chunk=64, want=1)
    log('dominance_block: %d seeded calls (random and chunk-dependent cases '
        'split at sp 2 and 4, chunks 64, 128 and 1024; a batch of both '
        'branches at chunks 16 and 1024; a one-object arena at the build\'s '
        'shape) bit-equal to the plain block mode, each case\'s blocks '
        'summed bit-equal to the whole-doc route, every call without a '
        'host read; %d fast / %d scan docs, as the model\'s test gives, '
        'on %s' % (n_calls, branches[0], branches[1], card))
    return err


def linearize_bound(L):
    """Bytes: obj, parent and the sibling sort read once (4 bytes an
    element each), valid (1) and the rank written once (4), 17 bytes an
    element.  Operations: a sequential walk of the forest, the least any
    order needs, a few per element (about 8), far under the bytes."""
    t_bytes = 17 * L / H100_BYTES_PER_S
    t_ops = 8 * L / H100_INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def linearize_readout(info):
    """The kernel's route readout (`linearize_cuda(..., info=)`) as a
    dict (`tests/torch_linearize_cases.py`'s INFO_* words)."""
    import torch_linearize_cases as m
    w = info.cpu().tolist()
    return {'route': 'tour' if w[m.INFO_ROUTE] == m.ROUTE_TOUR else
            'rounds', 'grid': bool(w[m.INFO_GRID]),
            'barriers': w[m.INFO_BARRIERS], 'walk': w[m.INFO_WALK1],
            'slot_walk': w[m.INFO_WALK2], 'top': w[m.INFO_TOP],
            'top_rounds': w[m.INFO_TOP_ROUNDS], 'why': w[m.INFO_WHY],
            'us': w[m.INFO_END] / 1e3}


#: route (b)'s grid barriers on the list-ranking route, at every L
LINEARIZE_TOUR_GRID_BARRIERS = 4


def check_linearize(torch, card, label, args, kw, timed=True, route=None):
    """Bit-equality of the linearize kernel (`csrc/linearize.cu`) with
    the plain `list_rank.linearize` on the card, its route readout (the
    route taken must be `route` when given; route (b)'s list ranking
    must run LINEARIZE_TOUR_GRID_BARRIERS grid barriers), and (`timed`) the
    wrapper's time as the path calls it (`ms`: back-to-back calls, the
    sibling sort on the card included where the path sorts there), the
    same calls as a CUDA graph (`graph_ms`: device time alone; None, with
    the reason logged, if the launch does not capture), the plain
    version's and the bound; where the path sorts on the card, also the
    kernel alone on that sort (`kernel_ms`), the sort (`sort_ms`: the
    lexsort kernel's wrapper) and torch's four stable sorts in its place
    (`torch_sort_ms`, the plain `list_rank.sibling_sort`), and the kernel
    alone as a CUDA graph (`kernel_graph_ms`).
    Returns (max abs error, timing dict or None, readout)."""
    from automerge_tpu_torch.ops import (lexsort_kernel, linearize_kernel,
                                         list_rank)
    info = torch.zeros((linearize_kernel.INFO_WORDS,), dtype=torch.int32,
                       device=args[0].device)
    got = linearize_kernel.linearize_cuda(*args, **kw, info=info)
    want = list_rank.linearize(*args, **kw)
    bad = int((got != want).sum())
    err = int((got.long() - want.long()).abs().max()) if want.numel() else 0
    if bad:
        raise AssertionError('linearize %s: %d mismatches' % (label, bad))
    L = args[0].shape[0]
    ro = dict(linearize_readout(info), L=L)
    if L == 0:
        ro['route'] = route or 'tour'  # no launch, nothing read
    if route is not None and ro['route'] != route:
        raise AssertionError('linearize %s (L=%d n_iters=%d): took the %s '
                             'route, not the %s' % (label, L, args[5],
                                                   ro['route'], route))
    if ro['route'] == 'tour' and ro['grid'] and \
            ro['barriers'] != LINEARIZE_TOUR_GRID_BARRIERS:
        raise AssertionError('linearize %s: %d grid barriers at L=%d' % (
            label, ro['barriers'], L))
    if not timed:
        return err, None, ro

    def wrapper():
        return linearize_kernel.linearize_cuda(*args, **kw)
    ms = device_ms(torch, wrapper)
    try:
        g_ms = device_ms(torch, wrapper, graph=True)
    except RuntimeError as e:
        g_ms = None
        log('linearize %s: the launch does not capture in a CUDA graph '
            '(%s)' % (label, e))
    plain_ms = device_ms(torch, lambda: list_rank.linearize(*args, **kw),
                         reps=2, rounds=3)
    bound, by = linearize_bound(L)
    out = {'shape': 'L=%d n_iters=%d sort=%s' % (
        L, args[5], 'card' if kw.get('sort_idx') is None else 'host'),
        'ms': ms, 'graph_ms': g_ms, 'plain_ms': plain_ms,
        'bound_ms': bound, 'bound_by': by, 'x_bound': ms / bound}
    if kw.get('sort_idx') is None:
        si = lexsort_kernel.sibling_sort_cuda(*args[:5])
        out['kernel_ms'] = device_ms(torch, lambda: linearize_kernel
                                     .linearize_cuda(*args, sort_idx=si))
        out['kernel_graph_ms'] = device_ms(
            torch, lambda: linearize_kernel.linearize_cuda(*args, sort_idx=si),
            graph=True)
        out['sort_ms'] = device_ms(torch, lambda: lexsort_kernel
                                   .sibling_sort_cuda(*args[:5]))
        out['torch_sort_ms'] = device_ms(torch, lambda: list_rank
                                         .sibling_sort(*args[:5]))
    log('linearize %s %s: mismatches 0, wrapper %.4f ms, as a CUDA graph '
        '%s ms, plain %.4f ms, bound %.3g ms (%s), x bound %.0f%s on %s' % (
            label, out['shape'], ms, 'n/a' if g_ms is None else
            '%.4f' % g_ms, plain_ms, bound, by, ms / bound,
            '' if 'kernel_ms' not in out else ', kernel alone %.4f ms (as '
            'a CUDA graph %.4f ms), card sort %.4f ms (torch\'s sorts %.4f '
            'ms)' % (out['kernel_ms'], out['kernel_graph_ms'],
                     out['sort_ms'], out['torch_sort_ms']),
            card))
    out['readout'] = ro
    return err, out, ro


def readout_summary(readouts):
    """What the readouts of many linearize calls show: calls per route,
    route (b)'s grid barriers on the list ranking (one value at every L)
    and the L it ran at, the longest walks."""
    tours = [r for r in readouts if r['route'] == 'tour']
    grid = [r for r in tours if r['grid']]
    return {'calls': len(readouts), 'tour': len(tours),
            'rounds': len(readouts) - len(tours),
            'grid_barriers': sorted({r['barriers'] for r in grid}),
            'grid_L': sorted({r['L'] for r in grid}),
            'longest_walk': max([r['walk'] for r in tours], default=0),
            'longest_slot_walk': max([r['slot_walk'] for r in tours],
                                     default=0),
            'largest_top': max([r['top'] for r in grid], default=0)}


def linearize_cases(torch, np, card):
    """The linearize kernel at the edges of its design
    (`torch_linearize_cases.edge_cases`: route (a)'s limit and one above,
    L = 1, rounds too few for chains of 4,096 and 20,000, a garbage tail,
    the resident arena) with the host's sort and the card's, at config
    3's size (786,432 rows over 4,096 objects) and at the 262,144-
    character text's resident arena (393,216 rows, the card's sort), and
    the tour's cases (`tour_cases`, at scales 1 and 8, and 120,000
    one-element objects, more splitters than one block's shared memory
    ranks), each on the route the model's `route_of` gives; the two
    routes' edges and the two large shapes timed.  Then route (b) on
    four streams from four threads at once (the mesh pool's pattern), 20
    launches each, every result bit-equal.  Returns (largest error,
    {label: timing, 'readouts': summary})."""
    from automerge_tpu_torch.ops import linearize_kernel, list_rank
    from torch_linearize_cases import (edge_cases, forest_of_size,
                                       resident_arena, route_of, singletons,
                                       tour_cases)
    dev = torch.device('cuda')
    rs = np.random.RandomState(16)
    cases = edge_cases(rs) + [
        ('config 3 size', forest_of_size(rs, 786432, 4096), 9),
        ('resident arena of the 262,144-character text',
         resident_arena(rs, 262144, 393216), 20)]
    timed_labels = (cases[0][0], cases[1][0], cases[-2][0], cases[-1][0])
    tours = tour_cases(rs) + [('%s x8' % l, c, n, r) for l, c, n, r in
                              tour_cases(rs, scale=8)] + [
        ('one-element objects past the shared top', singletons(120000), 0,
         None)]
    err, timings, readouts = 0, {}, []
    for label, case, n_iters, want_route in [
            (l, c, n, None) for l, c, n in cases] + tours:
        route = ('tour', 'rounds')[route_of(case[0], case[1], case[4],
                                            n_iters)[0] == 0]
        if want_route is not None and \
                route != ('rounds', 'tour')[want_route]:
            raise AssertionError('linearize %s: the model takes the %s '
                                 'route' % (label, route))
        c = [torch.from_numpy(np.asarray(x)).to(dev) for x in case]
        for si in (c[5], None):
            timed = label in timed_labels and \
                (si is None) == label.startswith('resident')
            e, t, ro = check_linearize(
                torch, card, 'edge: ' + label, c[:5] + [n_iters],
                {'sort_idx': si}, timed=timed, route=route)
            err = max(err, e)
            readouts.append(ro)
            if t is not None:
                timings[label] = t
    timings['readouts'] = readout_summary(readouts)
    log('linearize: %d edge and tour cases bit-equal to the plain version '
        'with the host\'s and the card\'s sort, each on the model\'s '
        'route: %s on %s' % (len(cases) + len(tours), timings['readouts'],
                             card))
    case = forest_of_size(np.random.RandomState(17), 100000, 500)
    c = [torch.from_numpy(np.asarray(x)).to(dev) for x in case]
    want = list_rank.linearize(*c[:5], 18, sort_idx=c[5])
    torch.cuda.synchronize()
    bad = []

    def worker(k):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            outs = [linearize_kernel.linearize_cuda(*c[:5], 18,
                                                    sort_idx=c[5])
                    for _ in range(20)]
            s.synchronize()
        bad.extend(k for o in outs if not bool((o == want).all()))
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    if any(th.is_alive() for th in threads) or bad:
        raise AssertionError('linearize on four streams: threads alive %s, '
                             'mismatching streams %s' % (
                                 [th.is_alive() for th in threads], bad))
    log('linearize: 80 cooperative launches (L=100,000) from four threads '
        'on four streams, bit-equal, in %.3f s on %s'
        % (time.perf_counter() - t, card))
    return err, timings


def lexsort_bound(site, L):
    """Bytes: the sibling sort reads obj, parent, ctr and actor (4 bytes a
    row each) and valid (1) and writes the permutation (4), 21 bytes a
    row; the register order reads rg and rt and writes the permutation,
    12.  Operations: the composite key's few a row (about 8; a radix sort
    compares nothing), far under the bytes."""
    t_bytes = (21 if site == 'sibling' else 12) * L / H100_BYTES_PER_S
    t_ops = 8 * L / H100_INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def lexsort_entry(site):
    """(kernel wrapper, plain version) of one lexsort entry point."""
    from automerge_tpu_torch.ops import lexsort_kernel, list_rank
    from automerge_tpu_torch.parallel import mesh
    if site == 'sibling':
        return lexsort_kernel.sibling_sort_cuda, list_rank.sibling_sort
    return lexsort_kernel.register_sort_cuda, mesh.register_order


def check_lexsort(torch, card, label, site, args, timed=True):
    """Bit-equality of the lexsort kernel (`csrc/lexsort.cu`) at one entry
    point (`site`: 'sibling' or 'register') with its plain version on the
    card, the whole permutation (invalid and padding rows included), its
    route readout (`lexsort_kernel.readout`), and (`timed`) the wrapper
    back to back (`ms`), the same calls as a CUDA graph (`graph_ms`; a
    launch that does not capture fails), torch's stable sorts of the same
    function (`library_ms`: the plain version, the four or two sorts the
    kernel replaces; `plain_ms` is that call) and the bound.  Returns
    (max abs error, timing dict or None, readout)."""
    from automerge_tpu_torch.ops import lexsort_kernel
    kernel, plain = lexsort_entry(site)
    info = torch.zeros((lexsort_kernel.INFO_WORDS,), dtype=torch.int32,
                       device=args[0].device)
    got = kernel(*args, info=info)
    want = plain(*args)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError('lexsort %s %s: %s %s, plain %s %s' % (
            site, label, tuple(got.shape), got.dtype, tuple(want.shape),
            want.dtype))
    bad = int((got != want).sum())
    if bad:
        raise AssertionError('lexsort %s %s: %d mismatches' % (site, label,
                                                               bad))
    err = int((got.long() - want.long()).abs().max()) if want.numel() else 0
    L = args[0].numel()
    ro = dict(lexsort_kernel.readout(info), L=L)
    if site == 'register':
        ro['D'] = int(args[0].shape[0])
    if not timed:
        return err, None, ro
    ms = device_ms(torch, lambda: kernel(*args))
    g_ms = device_ms(torch, lambda: kernel(*args), graph=True)
    lib_ms = device_ms(torch, lambda: plain(*args))
    bound, by = lexsort_bound(site, L)
    shape = 'L=%d' % L if site == 'sibling' else 'D=%d T=%d' % tuple(
        args[0].shape)
    log('lexsort %s %s %s: mismatches 0, %s route (%d CTAs, %d rows a CTA, '
        '%d of %d passes, %d barriers), wrapper %.4f ms, as a CUDA graph '
        '%.4f ms, torch\'s sorts (library, plain) %.4f ms, bound %.3g ms '
        '(%s), x bound %.0f on %s' % (
            site, label, shape, ro['route'], ro['ctas'], ro['rows'],
            ro['run'], ro['passes'], ro['barriers'], ms, g_ms, lib_ms,
            bound, by, ms / bound, card))
    return err, {'entry': site, 'shape': shape, 'ms': ms, 'graph_ms': g_ms,
                 'plain_ms': lib_ms, 'library_ms': lib_ms, 'bound_ms': bound,
                 'bound_by': by, 'x_bound': ms / bound,
                 'route': ro['route'], 'barriers': ro['barriers']}, ro


def lexsort_per_doc(ro):
    """Whether a register-order readout shows a per-doc sort: a warp or a
    block a doc, or one doc in range on the radix (its key holds no doc
    bits: the cluster or grid sorts the doc alone)."""
    return ro['route'] in ('warp', 'block') or (
        ro['in_range'] and ro.get('D') == 1) or ro['L'] == 0


def lexsort_routes(readouts):
    """What the readouts of many lexsort calls show: calls per route, the
    sizes each route took, the cluster sizes, barriers and passes run."""
    out = {}
    for ro in readouts:
        r = out.setdefault(ro['route'], {'calls': 0, 'L': set(),
                                         'ctas': set(), 'barriers': set(),
                                         'run': set()})
        r['calls'] += 1
        for k in ('L', 'ctas', 'barriers', 'run'):
            r[k].add(ro[k])
    return {k: {f: sorted(v) if isinstance(v, set) else v
                for f, v in r.items()} for k, r in out.items()}


def cases_on_card(torch, np):
    """case -> its numpy arrays on the card (other items as they are)."""
    dev = torch.device('cuda')
    return lambda case: [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                         if isinstance(x, np.ndarray) else x for x in case]


def lexsort_launch_counts(torch, np, card):
    """(kernels, copies and fills) that one call of each lexsort entry
    point puts on the card on each route, from the profiler (right after
    phase 10: by phase 11 the profiler sees no CUDA activity); fails
    unless a measured call is one kernel and no copy."""
    from torch_lexsort_cases import sized_forest
    on_card = cases_on_card(torch, np)
    rs = np.random.RandomState(20)

    def register(D, T):
        return on_card((rs.randint(-1, 9, (D, T)).astype(np.int32),
                        rs.randint(0, 99, (D, T)).astype(np.int32), 9))
    per_call = {}
    for name, site, args in (
            ('sibling L=16384 (cluster)', 'sibling',
             on_card(sized_forest(rs, 16384))),
            ('sibling L=262144 (grid)', 'sibling',
             on_card(sized_forest(rs, 262144))),
            ('register D=2048 T=32 (a warp a doc)', 'register',
             register(2048, 32)),
            ('register D=2 T=64 (a block\'s docs)', 'register',
             register(2, 64)),
            ('register D=1 T=16384 (one doc, cluster)', 'register',
             register(1, 16384))):
        kernel = lexsort_entry(site)[0]
        got = count_launches(torch, lambda: kernel(*args))
        per_call[name] = got
        if got is not None and tuple(got) != (1, 0):
            raise AssertionError('lexsort %s: (kernels, copies) a call %s, '
                                 'not (1, 0)' % (name, got))
    log('lexsort: (kernels, copies and fills) of one call: %s on %s'
        % (per_call, card))
    return per_call


def lexsort_cases(torch, np, card):
    """The lexsort kernel at the edges of its design
    (`tests/torch_lexsort_cases.py`: both entry points; L = 0 and 1, a warp
    and a tile +-1, one CTA's tile and one above, the cluster's capacity
    and one row above it, a text typed at its head (one sibling group of
    every row), a hot register key of 700 rows, all-padding docs, docs of
    a warp and of one row more, group ids at n_groups and -2 beside their
    in-range twins, an id keyed into another doc's rows, garbage in
    invalid rows, padding equal on every key, counters, actors and times
    at INT_MIN, objects at 2**30, any int32 everywhere), each bit-equal
    to its plain version and its route readout equal to the numpy
    model's (`lexsort_model` at the card's largest cluster); then the
    grid on four streams from four threads at once, each alternating a
    sibling sort and a linearize that sorts on the card (both
    cooperative, serialized across the streams), 20 launches each, every
    result bit-equal.  Returns (largest error, {'edges', 'edge_routes'})."""
    from automerge_tpu_torch.ops import lexsort_kernel, linearize_kernel
    from automerge_tpu_torch.ops import list_rank
    from torch_lexsort_cases import (capacity_cases, lexsort_model,
                                     register_cases, sibling_cases,
                                     sized_forest)
    on_card = cases_on_card(torch, np)
    err, n, routes = 0, 0, {}
    cmax = None
    # the grid: one block an SM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for site, cases in (('sibling', sibling_cases(np.random.RandomState(
            18))), ('register', register_cases(np.random.RandomState(19)))):
        for label, case in cases:
            e, _, ro = check_lexsort(torch, card, 'edge: ' + label, site,
                                     on_card(case), timed=False)
            err = max(err, e)
            n += 1
            if not ro['L']:
                continue
            cmax = ro['cluster_max']
            mi = lexsort_model(site, case, cmax, sms)[1]
            bad = {k: (ro[k], mi[k]) for k in (
                'route', 'ctas', 'rows', 'passes', 'run', 'skipped',
                'barriers', 'in_range') if ro[k] != mi[k]}
            if bad:
                raise AssertionError('lexsort %s %s: readout (card, model) '
                                     '%s' % (site, label, bad))
            routes[ro['route']] = routes.get(ro['route'], 0) + 1
    for label, case in capacity_cases(np.random.RandomState(20), cmax):
        e, _, ro = check_lexsort(torch, card, 'edge: ' + label, 'sibling',
                                 on_card(case), timed=False)
        err = max(err, e)
        n += 1
        if ro['route'] != lexsort_model('sibling', case, cmax,
                                        sms)[1]['route']:
            raise AssertionError('lexsort %s: took the %s route' % (
                label, ro['route']))
        routes[ro['route']] = routes.get(ro['route'], 0) + 1
    log('lexsort: %d edge cases of both entry points bit-equal to the plain '
        'versions, each readout the model\'s (largest cluster %d; calls per '
        'route %s) on %s' % (n, cmax, routes, card))
    c = on_card(sized_forest(np.random.RandomState(21), 200000))
    want_sort = list_rank.sibling_sort(*c)
    want_rank = list_rank.linearize(*c, 19)
    torch.cuda.synchronize()
    bad = []

    def worker(k):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            outs = [lexsort_kernel.sibling_sort_cuda(*c) if i % 2 else
                    linearize_kernel.linearize_cuda(*c, 19)
                    for i in range(20)]
            s.synchronize()
        bad.extend(k for i, o in enumerate(outs) if not bool(
            (o == (want_sort if i % 2 else want_rank)).all()))
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    if any(th.is_alive() for th in threads) or bad:
        raise AssertionError('lexsort on four streams: threads alive %s, '
                             'mismatching streams %s' % (
                                 [th.is_alive() for th in threads], bad))
    log('lexsort: 40 sibling sorts and 40 linearize calls sorting on the '
        'card (L=200,000: both on their cooperative grids) from four '
        'threads on four streams, bit-equal, in %.3f s on %s'
        % (time.perf_counter() - t, card))
    return err, {'edges': n, 'edge_routes': routes}


def member_cases(torch, np, card):
    """The member kernel at every window it takes, random and edge
    cases; returns the largest error (0: bit-equal)."""
    from automerge_tpu_torch.ops.members_kernel import KERNEL_WINDOWS
    from torch_member_cases import members_case, members_edge_cases
    dev = torch.device('cuda')
    rs = np.random.RandomState(2025)

    def on_card(case):
        return [torch.from_numpy(np.asarray(x)).to(dev) for x in case]

    err = 0
    for i, W in enumerate(KERNEL_WINDOWS):
        T = max(128, (1 << 17) // W)
        for A in (8, 64):
            e = check_members(torch, card, 'W=%d T=%d A=%d' % (W, T, A),
                              on_card(members_case(rs, T, A, W)), W,
                              want_vb=(i + A) % 2 == 0)[0]
            err = max(err, e)
        for label, case in members_edge_cases(rs, W):
            for want_vb in (True, False):
                e = check_members(torch, card, 'W=%d %s' % (W, label),
                                  on_card(case), W, want_vb)[0]
                err = max(err, e)
    return err


def kernel_cases(torch, np, card):
    """Both kernels at random shapes and at the edges of their designs;
    returns the largest error of each (0: bit-equal)."""
    dev = torch.device('cuda')
    rs = np.random.RandomState(2024)

    def on_card(case):
        return [torch.from_numpy(np.asarray(x)).to(dev) for x in case]

    err1 = 0
    for W in (2, 4, 8, 16):
        for T in (1000, 65536):
            for A in (8, 64):
                e, _ = check_registers(torch, card, 'W=%d T=%d A=%d'
                                       % (W, T, A), on_card(registers_case(
                                           np, rs, T, A, W)), W)
                err1 = max(err1, e)
        # groups of exactly W and W + 1 rows (the overflow bit) and of
        # random widths, offset so that they cross 128-row tile edges
        sizes = np.concatenate([np.tile([W, W + 1], 1500),
                                rs.randint(1, 2 * W + 2, 1500)])
        e, _ = check_registers(torch, card, 'W=%d groups W and W+1 across '
                               'tile edges' % W, on_card(
                                   registers_groups_case(np, rs, sizes, 8,
                                                         pad=5)), W)
        err1 = max(err1, e)
    e, _ = check_registers(torch, card, 'W=16 T=262149 all groups 16 rows',
                           on_card(registers_groups_case(
                               np, rs, [16] * 16384, 8, pad=5)), 16)
    err1 = max(err1, e)

    err2 = 0
    for O, L, T in ((4096, 64, 128), (4096, 256, 320), (4096, 256, 512)):
        e, _ = check_dominance(torch, card, 'O=%d L=%d T=%d' % (O, L, T),
                               on_card(dominance_case(np, rs, O, L, T)))
        err2 = max(err2, e)
    e, _ = check_dominance(torch, card, 'O=1000 L=100 T=48 chunk=16',
                           on_card(dominance_case(np, rs, 1000, 100, 48)),
                           chunk=16)
    err2 = max(err2, e)
    e, _ = check_dominance(torch, card, 'O=4096 L=192 T=192 elementless '
                           'ops at chunk edges', on_card(
                               elementless_at_chunk_edges(
                                   np, dominance_case(np, rs, 4096, 192, 192),
                                   64)))
    err2 = max(err2, e)
    for label, (O, L, T) in (
            ('O=64 L=30000 T=512 (past shared memory)', (64, 30000, 512)),
            ('O=2 L=50000 T=4096 (long, many chunks)', (2, 50000, 4096)),
            ('O=1 L=100000 T=512 (long list)', (1, 100000, 512))):
        e, _ = check_dominance(torch, card, label, on_card(dominance_case(
            np, rs, O, L, T, all_visible=(O == 1))))
        err2 = max(err2, e)
    dominance_past_grid_y(torch, np, card, rs)
    return err1, err2


def count_launches(torch, fn):
    """(kernels, copies and fills) that one call of fn puts on the card,
    from torch.profiler's CUDA activity; None when the profiler gives
    none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except Exception as e:                    # the profiler is a probe
        log('resident dispatch launches: not measured (%s)' % e)
        return None
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    copies = sum(1 for n in dev if 'memcpy' in n.lower()
                 or 'memset' in n.lower())
    return len(dev) - copies, copies


def counts_of(trace, telemetry):
    """The flat counters and, beside them, the phase counters of
    PHASE_COUNTERS (their call counts) in one table."""
    m = dict(trace.snapshot()['metrics'])
    m.update({k: v['n'] for k, v in telemetry.phase_snapshot().items()
              if k in PHASE_COUNTERS})
    return m


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def run_stream(torch, trace, pool, steps, payloads):
    """Applies an edit stream to one pool, step by step.  Returns the
    results (batch bytes or local-change patches) and, per step, the
    wall seconds (host clock, ending in a device synchronize) and the
    counters and spans the step added (its phase counters too, counted
    while span tracing is on)."""
    from automerge_tpu_torch import telemetry
    out = {'results': [], 'wall': [], 'counts': [], 'spans': []}
    for (kind, body, _single), payload in zip(steps, payloads):
        m0 = trace.snapshot()
        c0 = counts_of(trace, telemetry)
        t = time.perf_counter()
        if kind == 'batch':
            res = pool.apply_batch_bytes(payload)
        else:
            res = pool.apply_local_change('doc', dict(body))
        torch.cuda.synchronize()
        out['wall'].append(time.perf_counter() - t)
        m1 = trace.snapshot()
        out['counts'].append(_delta(c0, counts_of(trace, telemetry)))
        out['spans'].append(_delta(m0['spans'], m1['spans']))
        out['results'].append(res)
    return out


def check_resident_counts(label, steps, counts):
    """The route took every single-list step and no other; a step
    uploads at most one row as a delta; the whole arena crossed only at
    the first batch, at the middle-sorting actor's keystroke and at the
    keystroke after the two-list batch."""
    singles = [single for _k, _b, single in steps]
    took = [c.get('resident.dispatches', 0) for c in counts]
    if took != [int(x) for x in singles]:
        raise AssertionError('%s: resident dispatches per step %s, single-'
                             'list steps %s' % (label, took, singles))
    if any(c.get('resident.delta_upload_rows', 0) > 1 for c in counts):
        raise AssertionError('%s: a step uploaded more than one row as a '
                             'delta' % label)
    middle = next(i for i, (k, b, _s) in enumerate(steps)
                  if k == 'batch' and b[0]['actor'] == 'a00')
    cross = singles.index(False)
    full = [i for i, c in enumerate(counts)
            if c.get('resident.full_upload_rows', 0)]
    if full != [0, middle, cross + 1]:
        raise AssertionError('%s: full uploads at steps %s, expected %s'
                             % (label, full, [0, middle, cross + 1]))


def edit_summary(run_out):
    """Median per-edit wall (ms) and spans (ms) over the timed edits, the
    mean per edit of the C++ stage times (a thread CPU clock that may
    advance in coarse steps, so a median of a few ms reads 0) and the
    stream's counters."""
    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] * 1e3
    walls = run_out['wall'][TIMED_EDITS]
    timed = run_out['spans'][TIMED_EDITS]
    spans = {k: med([s.get(k, 0.0) for s in timed]) for k in EDIT_SPANS}
    cxx_mean = {k: sum(s.get(k, 0.0) for s in timed) / len(timed) * 1e3
                for k in CXX_SPANS}
    counts = {}
    for c in run_out['counts']:
        for k in RESIDENT_COUNTERS:
            if c.get(k):
                counts[k] = counts.get(k, 0) + c[k]
    return {'edits': len(walls), 'wall_ms': med(walls), 'spans_ms': spans,
            'cxx_mean_ms': cxx_mean, 'counters': counts}


def resident_phase(torch, card, workloads, native, NativeDocPool, R, drive,
                   K1, K2):
    """Phase 6: the long-document edit stream at each size on the
    resident route (a default card pool), against the route off (a card
    pool with RESIDENT = False) and, at the smaller size, a CPU pool.
    Returns {size: {'resident': summary, 'off': summary, 'dispatch_ms',
    'dispatch_launches'}}."""
    import msgpack

    from automerge_tpu_torch import trace
    report = {}
    orig = R.resolve_rank_dominate_resident
    last = []

    def keep_last(*args, **kw):
        last[:] = [[a.clone() if torch.is_tensor(a) else a for a in args],
                   dict(kw)]
        return orig(*args, **kw)
    for size in RESIDENT_SIZES:
        n = size - workloads.edit_inserts(N_KEYS)
        steps = [('batch', workloads.long_text_doc(n), True)] + \
            workloads.keystroke_edits(n, N_KEYS)
        payloads = [msgpack.packb({'doc': body}, use_bin_type=True)
                    if kind == 'batch' else None
                    for kind, body, _s in steps]
        on_pool = NativeDocPool()
        R.resolve_rank_dominate_resident = keep_last
        try:
            on, _, _ = drive('resident %d gpu' % size, lambda: run_stream(
                torch, trace, on_pool, steps, payloads), need=(K1, K2),
                phases=True)
        finally:
            R.resolve_rank_dominate_resident = orig
        check_resident_counts('resident %d' % size, steps, on['counts'])
        native.RESIDENT = False
        try:
            off_pool = NativeDocPool()
            off, _, m_off = drive('resident off %d gpu' % size,
                                  lambda: run_stream(torch, trace, off_pool,
                                                     steps, payloads),
                                  need=(K1, K2), phases=True)
        finally:
            native.RESIDENT = None
        if m_off.get('resident.dispatches', 0):
            raise AssertionError('route off %d: the resident route ran'
                                 % size)
        refs = [('card pool, route off', off['results'], off_pool)]
        if size == RESIDENT_SIZES[0]:
            cpu_pool = NativeDocPool(device='cpu')
            cpu = run_stream(torch, trace, cpu_pool, steps, payloads)
            refs.append(('CPU pool', cpu['results'], cpu_pool))
        for name, results, pool in refs:
            bad = [i for i, (a, b) in enumerate(zip(on['results'], results))
                   if a != b]
            if bad:
                raise AssertionError('resident %d: steps %s differ from the '
                                     '%s' % (size, bad, name))
            if pool.get_patch('doc') != on_pool.get_patch('doc'):
                raise AssertionError('resident %d: final patch differs from '
                                     'the %s' % (size, name))
        text = on_pool.get_patch('doc')
        args, kw = last
        fn = lambda: orig(*args, **kw)  # noqa: E731
        dispatch_ms = device_ms(torch, fn)
        launches = count_launches(torch, fn)
        if launches is not None and launches[0] >= RESIDENT_KERNELS_BEFORE:
            raise AssertionError('resident %d: one dispatch launches %d '
                                 'kernels, not fewer than %d' % (
                                     size, launches[0],
                                     RESIDENT_KERNELS_BEFORE))
        report[size] = {'resident': edit_summary(on),
                        'off': edit_summary(off),
                        'dispatch_ms': dispatch_ms,
                        'dispatch_launches': launches,
                        'steps': len(steps)}
        log('resident %d: %d steps, results equal to %s, final patch equal '
            '(%d diffs); resident route %s; route off %s; one resident '
            'dispatch (C=%d, Tp=%d) %.4f ms between CUDA events, launches '
            '(kernels, copies) %s on %s' % (
                size, len(steps), ' and '.join(r[0] for r in refs),
                len(text['diffs']), json.dumps(report[size]['resident']),
                json.dumps(report[size]['off']), args[8].shape[0],
                args[13].shape[1], dispatch_ms, launches, card))
    return report


def arms_equal(np, label, direct, replayed, docs):
    """Patches, clocks and doc_stats rows of an arena-direct load equal
    those of the replay arm.  `resclk_rows` counts rows of the pool-
    resident clock table, which only the replay's device route stages:
    0 on the direct arm.  Rows compare per doc: a pool lists its docs in
    first-seen order, which the replay's waves change."""
    for d in docs:
        for name in ('get_patch', 'get_clock'):
            if getattr(direct, name)(d) != getattr(replayed, name)(d):
                raise AssertionError('%s: doc %s %s differs from the replay '
                                     'arm' % (label, d, name))
    (ids_d, st_d), (ids_r, st_r) = direct.doc_stats(), replayed.doc_stats()
    col = direct.DOC_STAT_COLS.index('resclk_rows')
    keep = [i for i in range(st_d.shape[1]) if i != col]
    st_r = st_r[[ids_r.index(d) for d in ids_d]] \
        if sorted(ids_d) == sorted(ids_r) else None
    if st_r is None or not np.array_equal(st_d[:, keep], st_r[:, keep]) \
            or st_d[:, col].any():
        raise AssertionError('%s: doc_stats differ from the replay arm'
                             % label)


def replica_phase(torch, card, workloads, drive, K1, K3, union_pool):
    """Phase 5: bench config 5 uncut (`bench.py::run_config_5`, the same
    rng draws as phase 4's union batch): a BatchedReplicaSet of 64 card
    pools loads each replica's own backlog, then catches up.  The set
    must converge with no oracle row, and every replica's tree of every
    doc must equal that of `union_pool` (phase 4's pool, whose bytes
    equal the CPU pool's)."""
    from automerge_tpu_torch.sync.replica_set import BatchedReplicaSet, \
        patch_to_tree
    by_replica, union = workloads.build_config_5_replicas(random.Random(7))
    backlog = workloads.op_count(union)
    applications = backlog * (N_REPLICAS - 1)
    rs = BatchedReplicaSet(N_REPLICAS)
    _, wall_load, m_load = drive('config5 replicas load gpu', lambda: [
        rs.apply_batch(r, by_doc) for r, by_doc in enumerate(by_replica)],
        need=(), phases=True)
    if rs.converged():
        raise AssertionError('config5 replicas: converged before catch-up')
    rounds, wall, m = drive(CATCH_UP, rs.catch_up, need=(K3,), phases=True)
    n_changes = sum(len(chs) for chs in union.values())
    if not rs.converged() or rounds[-1] != 0 or \
            sum(rounds) != n_changes * (N_REPLICAS - 1):
        raise AssertionError('config5 catch-up: not converged or not every '
                             'change shipped once per receiver (rounds %s)'
                             % rounds)
    for d in union:
        want = patch_to_tree(union_pool.get_patch(str(d)))
        for r, pool in enumerate(rs.replicas):
            if patch_to_tree(pool.get_patch(d)) != want:
                raise AssertionError('config5 catch-up: replica %d doc %d '
                                     'differs from the union pool' % (r, d))
    keys = (('launch.members', 'launch.registers') +
            tuple(k for k in sorted(m) if k.startswith('fallback.')) +
            EDIT_SPANS + ('collect.ready_reorder', 'collect.wait_in_order',
                          'sched.fast_path', 'sched.queued',
                          'sched.trivial_rows', 'ops.register_rows'))
    log('config5 catch-up: ' + json.dumps({
        'replicas': N_REPLICAS, 'docs': len(union), 'backlog_ops': backlog,
        'op_applications': applications, 'rounds': rounds,
        'catch_up_s': wall, 'op_applications_per_s': applications / wall,
        'load_s': wall_load, 'load_trivial_rows': m_load.get(
            'sched.trivial_rows', 0), 'load_register_rows': m_load.get(
            'ops.register_rows', 0), 'load_launch_registers': m_load.get(
            K1, 0), 'counts': {k: m.get(k, 0) for k in keys},
        'card': card}))
    log('config5 catch-up: %d replicas converged in %d rounds, every '
        'replica\'s tree of every doc equal to the union pool\'s; %.3f s, '
        '%.0f op-applications/s on %s' % (
            N_REPLICAS, len(rounds), wall, applications / wall, card))


#: the spans of a sharded run; in threads mode each is a sum over the
#: shards' threads and can exceed the wall
SHARD_SPANS = ('shard.split', 'shard.run', 'host.begin', 'device.dispatch',
               'device.collect', 'host.mid', 'host.finish') + CXX_SPANS


def sharded_phase(card, workloads, drive, K1, K2, one_pool):
    """Phase 6: configs 3 and 4 as `bench.py::run_config` runs them, on a
    card `ShardedNativePool`: config 3 in threads mode (`bench_shards`,
    one shard per core up to 8) and in pipeline mode (20 shards), config
    4 in threads mode.  K1 (and K2 for config 3) must launch, no row may
    take the oracle, and every doc's patch must equal the one-pool run's
    (`one_pool`: {config: (payload, ops, result bytes, wall s)} of
    phases 1 and 2)."""
    from automerge_tpu_torch.native import ShardedNativePool
    cores = os.cpu_count()
    out = {}
    for config, mode, n_docs, need in (
            ('config3', 'threads', 4096, (K1, K2)),
            ('config3', 'pipeline', 4096, (K1, K2)),
            ('config4', 'threads', 1024, (K1,))):
        n = 20 if mode == 'pipeline' else workloads.bench_shards(n_docs,
                                                                 mode)
        pool = ShardedNativePool(n, mode)
        pool.pools
        label = '%s %s gpu' % (config, mode)
        payload, n_ops, want, wall_one = one_pool[config]
        got, wall, m = drive(label, lambda: pool.apply_batch_bytes(payload),
                             need=need)
        if patch_slices(got) != patch_slices(want):
            raise AssertionError('%s: a patch differs from the one-pool '
                                 'run\'s' % label)
        out[label] = {'wall_s': wall, 'one_pool_wall_s': wall_one,
                      'ops_per_s': n_ops / wall, 'shards': n,
                      'host_cores': cores,
                      'spans_s': {k: m.get(k, 0.0) for k in SHARD_SPANS}}
        log('%s: %d shards, %d host cores, %.3f s wall (one pool %.3f s), '
            '%.0f ops/s, every patch equal to the one-pool run\'s on %s'
            % (label, n, cores, wall, wall_one, n_ops / wall, card))
    log('sharded: ' + json.dumps({
        'runs': out, 'note': 'threads mode: each span sums over the '
        'shard threads and can exceed the wall', 'card': card}))
    return out


def fault_batch(workloads):
    """256 config-3 docs and one 20-writer hot map key, the key that
    climbs the ladder into K3 and a tier (tests/test_chaos.py)."""
    from automerge_tpu_torch.utils import ROOT_ID
    batch = {'c3-%03d' % d: chs for d, chs in workloads.build_config_3(
        random.Random(11), n_docs=256).items()}
    batch['hot-key'] = [{'actor': 'w%03d' % a, 'seq': 1, 'deps': {},
                         'ops': [{'action': 'set', 'obj': ROOT_ID,
                                  'key': 'k', 'value': 'w%03d' % a}]}
                        for a in range(20)]
    return batch


FAULT_SITES = ('native.begin', 'device.dispatch', 'device.collect',
               'native.mid', 'escalation.tier')
FAULT_POISON = 'c3-017'


def fault_phase(card, drive, K1, K2, K3, workloads):
    """Phase 7: faults on the card.  For each drive mode, a card
    `ShardedNativePool(4)` per lane applies `fault_batch` through the
    dict API with a fault armed at each site: a permanent fault pinned
    to one doc (the tier site, which has no doc scope, unpinned: it
    converges on the hot key) must quarantine exactly that doc with
    every other doc's bytes equal to the fault-free run's; two transient
    faults must retry to byte equality with at least one rollback; no
    C++ batch handle may be left live.  Nothing here is timed."""
    import msgpack
    from automerge_tpu_torch import faults, native, resilience, trace
    from automerge_tpu_torch.native import ShardedNativePool
    batch = fault_batch(workloads)

    def packed_docs(result):
        return {d: msgpack.packb(v, use_bin_type=True)
                for d, v in result.items()}

    for mode in ('pipeline', 'threads'):
        def lanes():
            ref = packed_docs(ShardedNativePool(4, mode).apply_batch(batch))
            done = []
            for site in FAULT_SITES:
                for kind in ('permanent', 'transient'):
                    if kind == 'transient':
                        poison, kw = None, {'count': 2}
                    elif site == 'escalation.tier':
                        poison, kw = 'hot-key', {}
                    else:
                        poison, kw = FAULT_POISON, {'match': FAULT_POISON}
                    m0 = trace.metrics()
                    faults.arm(site, kind, 1.0, **kw)
                    try:
                        got = ShardedNativePool(4, mode).apply_batch(batch)
                    finally:
                        faults.disarm()
                    m1 = trace.metrics()
                    delta = {k: m1[k] - m0.get(k, 0) for k in m1
                             if k.startswith('resilience.')
                             and m1[k] != m0.get(k, 0)}
                    lane = '%s %s %s' % (mode, site, kind)
                    got_b = packed_docs(got)
                    bad = [d for d in ref if d != poison
                           and got_b.get(d) != ref[d]]
                    if bad or set(got_b) != set(ref):
                        raise AssertionError('faults %s: %d healthy docs '
                                             'differ' % (lane, len(bad)))
                    if poison is not None and not (
                            resilience.is_quarantined(got[poison])
                            and got[poison]['errorType'] == 'PermanentFault'
                            and delta.get('resilience.quarantined') == 1):
                        raise AssertionError('faults %s: %s not quarantined '
                                             '(%s)' % (lane, poison, delta))
                    if poison is None and (got_b != ref or delta.get(
                            'resilience.rollback', 0) < 1):
                        raise AssertionError('faults %s: no retry to equal '
                                             'bytes (%s)' % (lane, delta))
                    if native.live_batch_handles():
                        raise AssertionError('faults %s: %d batch handles '
                                             'left live' % (
                                                 lane, native.
                                                 live_batch_handles()))
                    done.append((lane, delta))
            return done
        # a retry after a counted spec is spent is unarmed, so a shard's
        # re-applied sub-payload may split into waves: not checked here
        done, _wall, _m = drive('faults %s gpu' % mode, lanes,
                                need=(K1, K2, K3), waves=None)
        for lane, delta in done:
            log('faults %s: healthy docs byte-equal to the fault-free run, '
                'no live batch handle; %s on %s' % (lane, delta, card))


#: the cold-start corpus: a quarter of `bench.py --coldstart`'s default
#: of 100,000 docs (cut so that the whole script, first-call lane
#: included, keeps inside its time limit), its sample stride for the save
#: and patch comparison (32 docs), and the docs the replay arm restores
COLDSTART_DOCS = 50000
COLDSTART_SAMPLE = 1562
COLDSTART_REPLAY_DOCS = 4096


def _rss_mb():
    """The process's current resident set (MB)."""
    with open('/proc/self/statm') as f:
        return int(f.read().split()[1]) * os.sysconf('SC_PAGE_SIZE') / 1e6


def coldstart_phase(torch, card, workloads, native, drive, K1, K2):
    """Phase 8: the cold start as `bench.py --coldstart` runs it, at
    COLDSTART_DOCS docs (17 changes each).  The corpus is
    built on a card pool (batches of 512 docs, two waves each, K1 and K2
    launching), every other doc compacted, every doc saved into a
    durable `ColdStore` in a temporary directory; then restored into a
    card `ShardedNativePool(4)` serially (threads=1) and with the default
    fan-out: each summary counts every doc and the store's bytes, with no
    corrupt or failed doc, and every COLDSTART_SAMPLE-th doc's save and
    patch equal the source's.  The first COLDSTART_REPLAY_DOCS docs then
    restore through the replay arm (STORAGE_NATIVE = False) into a
    threads-mode sharded pool (K1 and K2 launch from four worker
    threads): every patch equal to the arena-direct restore's.  Last, a
    blob corrupted on disk: a fresh restore lists it under `corrupt` and
    restores every other doc."""
    import gc
    import resource
    import tempfile
    from automerge_tpu_torch.native import NativeDocPool, ShardedNativePool
    from automerge_tpu_torch.storage.coldstore import ColdStore
    n_docs = COLDSTART_DOCS
    n_changes = 17 * n_docs
    n_batches = (n_docs + 511) // 512
    source = NativeDocPool()
    blobs, build_s, _m = drive('coldstart build gpu', lambda: workloads
                               .build_coldstart_blobs(source, n_docs,
                                                      random.Random(7)),
                               need=(K1, K2), waves=2 * n_batches)
    docs = sorted(blobs)
    sample = {d: source.get_patch(d) for d in docs[::COLDSTART_SAMPLE]}
    del source
    gc.collect()
    cold_bytes = sum(map(len, blobs.values()))
    tmp = tempfile.TemporaryDirectory(prefix='amtpu-coldstart-')
    try:
        t = time.perf_counter()
        store = ColdStore(root=tmp.name, durable=True)
        store.put_many(blobs)
        put_s = time.perf_counter() - t
        if store.bytes != cold_bytes or len(store) != n_docs:
            raise AssertionError('coldstart: the store holds %d docs, %d B'
                                 % (len(store), store.bytes))
        log('coldstart: built %d docs (%d changes, %d cold bytes) in %.1f s, '
            'durable store written in %.1f s on %s' % (
                n_docs, n_changes, cold_bytes, build_s, put_s, card))

        def restored(label, threads):
            pool = ShardedNativePool(4)
            summary, wall, _m = drive(label, lambda: pool.restore_from_store(
                store, threads=threads), need=())
            if summary['docs'] != n_docs or summary['bytes'] != cold_bytes \
                    or summary['corrupt'] or summary['failed']:
                raise AssertionError('%s: summary %s' % (label, {
                    k: summary[k] for k in ('docs', 'bytes', 'batches')}))
            for d, patch in sample.items():
                if pool.save(d) != blobs[d] or pool.get_patch(d) != patch:
                    raise AssertionError('%s: doc %s differs from the '
                                         'source' % (label, d))
            return pool, wall, summary
        serial_pool, serial_s, _ = restored('coldstart restore serial gpu', 1)
        del serial_pool
        gc.collect()
        pool, par_s, summary = restored('coldstart restore parallel gpu',
                                        None)
        resident_mb = _rss_mb()
        peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        result = {
            'docs': n_docs, 'changes': n_changes, 'cold_bytes': cold_bytes,
            'build_s': build_s, 'store_put_s': put_s,
            'serial_s': serial_s, 'parallel_s': par_s,
            'threads': native.restore_threads(), 'host_cores': os.cpu_count(),
            'serial_changes_per_s': n_changes / serial_s,
            'parallel_changes_per_s': n_changes / par_s,
            'restore_s_per_doc': par_s / n_docs, 'peak_rss_mb': peak_mb,
            # bench.py's measure: the whole process's resident set, which
            # here also holds every pool of the earlier phases
            'resident_rss_mb': resident_mb,
            'docs_per_gb': n_docs / (resident_mb / 1024.0),
            'batches': summary['batches'], 'sampled_docs': len(sample),
            'card': card}
        log('coldstart: ' + json.dumps(result))

        replay_docs = docs[:COLDSTART_REPLAY_DOCS]
        replay_pool = ShardedNativePool(4, 'threads')
        native.STORAGE_NATIVE = False
        try:
            # each shard's group is one batch of one wave: the wave split
            # hashes a doc as the shard split does (FNV mod 2 and mod 4),
            # so a shard's docs all fall into one wave
            summary_r, wall_r, _m = drive(
                'coldstart replay threads gpu', lambda: replay_pool
                .restore_from_store(store, doc_ids=replay_docs),
                need=(K1, K2), waves=4)
        finally:
            native.STORAGE_NATIVE = True
        if summary_r['docs'] != len(replay_docs) or summary_r['failed']:
            raise AssertionError('coldstart replay: summary %s' % summary_r)
        for d in replay_docs:
            if replay_pool.get_patch(d) != pool.get_patch(d):
                raise AssertionError('coldstart replay: doc %s differs from '
                                     'the arena-direct restore' % d)
        log('coldstart replay: %d docs through the kernels on 4 shard '
            'threads in %.3f s, every patch equal to the arena-direct '
            'restore\'s on %s' % (len(replay_docs), wall_r, card))
        del pool, replay_pool
        gc.collect()

        victim = docs[n_docs // 3]
        with open(store._index[victim][0], 'r+b') as f:
            f.write(b'\xde\xad\xbe\xef')
        fresh = ShardedNativePool(4)
        summary_c = fresh.restore_from_store(store)
        if list(summary_c['corrupt']) != [victim] or \
                summary_c['docs'] != n_docs - 1 or summary_c['failed'] or \
                sum(p.doc_count() for p in fresh.pools) != n_docs - 1:
            raise AssertionError('coldstart corrupt blob: corrupt %s, %d docs'
                                 % (list(summary_c['corrupt']),
                                    summary_c['docs']))
        log('coldstart: a corrupted blob (%s) quarantined as %s, the other '
            '%d docs restored on %s' % (
                victim, summary_c['corrupt'][victim]['errorType'],
                summary_c['docs'], card))
    finally:
        tmp.cleanup()
    return result


#: the serving phase (12): lane (a)'s connections and rounds, lane (c)'s
#: fan-in docs, connections and docs a request, and `bench.py --fanout`'s
#: defaults for lane (d)
SERVE_CONNS, SERVE_ROUNDS = 32, 6
FANIN_DOCS, FANIN_CONNS, FANIN_PER_REQ = 256, 8, 32
FANOUT_BENCH = {'n_peers': 1024, 'n_docs': 24, 'n_rounds': 96,
                'zipf_s': 1.2, 'seed': 7}
FANOUT_CONNS = 16


def _prom_counter(body, name):
    import re
    m = re.search(r'^amtpu_runtime_counter\{name="%s"\} (\S+)$'
                  % re.escape(name), body, re.M)
    return float(m.group(1)) if m else 0.0


def _prom_phase_calls(body, name):
    """A phase counter of a `--trace` server's exposition."""
    m = re.search(r'^amtpu_phase_calls_total\{phase="%s"\} (\S+)$'
                  % re.escape(name), body, re.M)
    return float(m.group(1)) if m else 0.0


def _gateway(device, path, **kw):
    from automerge_tpu_torch.scheduler import GatewayServer
    from automerge_tpu_torch.sidecar.server import SidecarBackend
    return GatewayServer(path, backend=SidecarBackend(device=device),
                         **kw).start()


def _on_gateway(device, path, fn, **kw):
    """fn() against a fresh in-process gateway over a fresh pool on
    `device`; the gateway is stopped, and no C++ batch handle may be left
    live, when fn returns."""
    from automerge_tpu_torch import native
    gw = _gateway(device, path, **kw)
    try:
        return fn()
    finally:
        gw.stop()
        if native.live_batch_handles():
            raise AssertionError('%s: %d live batch handles after the lane'
                                 % (path, native.live_batch_handles()))


def _flush_shares(telemetry, spans, busy_s):
    """Where a lane's pool batches spent their wall: flushes, mean docs a
    flush, the `native` batch latency sum, and three shares of it: the
    host's wait on the card's results (`device.collect`, a host clock),
    the card's span between the CUDA events around each dispatch
    (`telemetry.DEVTIME`: device time, idle gaps while the host enqueues
    included) and the card's busy time (`busy_s`, from the profiler)."""
    occ = telemetry.BATCH_OCCUPANCY.summary() or {}
    lat = (telemetry.BATCH_LATENCY.snapshot() or {}).get('native') or {}
    flat = telemetry.metrics_snapshot()
    wall = lat.get('sum', 0.0)
    n = occ.get('count', 0)
    out = {'flushes': n, 'docs': occ.get('sum', 0.0) / n if n else 0.0,
           'batch_wall_s': wall,
           'host_wait_s': spans.get('device.collect', 0.0),
           'span_s': flat.get('device.dispatch_sync_s', 0.0),
           'dispatches': int(flat.get('device.dispatches', 0)),
           'busy_s': busy_s}
    for k in ('host_wait', 'span', 'busy'):
        v = out[k + '_s']
        out[k + '_share'] = None if v is None or not wall else v / wall
    return out


def _shares_text(sh):
    def one(k):
        if sh[k + '_s'] is None:
            return 'not measured'
        return '%.4f s (%.4f)' % (sh[k + '_s'], sh[k + '_share'])
    return ('%d flushes, %.1f docs a flush, batch wall %.4f s; host wait '
            'on the card (device.collect) %s, card span between CUDA '
            'events %s over %d dispatches, card busy (profiler: kernels, '
            'copies, fills) %s' % (
                sh['flushes'], sh['docs'], sh['batch_wall_s'],
                one('host_wait'), one('span'), sh['dispatches'],
                one('busy')))


def card_busy(torch, fn):
    """(fn(), its wall seconds, the seconds the card was busy while it
    ran): busy is the union of the kernel, copy and fill intervals in
    torch.profiler's CUDA activity, from any thread of the process (None
    when the profiler saw none); the wall leaves out the profiler's own
    processing after fn."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return out, wall, None
    busy, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return out, wall, busy / 1e6


def serving_phase(card, workloads, drive, K1, K2, K3):
    """Phase 12: the port's server on the card.  Lane (a) runs against a
    real `python -m automerge_tpu_torch.sidecar.server --socket`
    subprocess, lanes (b) to (e) against in-process card gateways; each
    lane's card responses and frames must equal a CPU gateway's on the
    same traffic."""
    import random as _random
    import shutil
    import tempfile

    import msgpack
    import torch
    import torch_serving_cases as S

    from automerge_tpu_torch import native, telemetry
    from automerge_tpu_torch.native import NativeDocPool
    from automerge_tpu_torch.scheduler import AdmissionQueue
    from automerge_tpu_torch.scheduler import queue as gw_queue
    from automerge_tpu_torch.tools import proc as P

    work = tempfile.mkdtemp(prefix='amgw-')
    cwd = os.getcwd()
    # unix socket paths are short (108 bytes): bind relative names
    os.chdir(work)
    t_phase = time.perf_counter()
    try:
        # -- (a) the serve-check shape, a server subprocess ---------------
        t0 = time.perf_counter()
        # --trace: the scheduler's tallies are phase counters
        proc = P.spawn_server('a.sock', 'cuda', args=('--trace',),
                              deadline_s=300, cwd=work)
        try:
            log('serve a: server subprocess up in %.1f s on %s'
                % (time.perf_counter() - t0, card))
            (patches, finals, errors), wall_a, _ = drive(
                'serve a card', lambda: S.concurrent_stream(
                    'a.sock', SERVE_CONNS, SERVE_ROUNDS), need=())
            if errors:
                raise AssertionError('serve a: clients failed: %s' % errors)
            with S.RawConn('a.sock') as c:
                health = c.result({'cmd': 'healthz'})
                body = c.result({'cmd': 'metrics'})['body']
        finally:
            P.stop_server(proc, timeout=60)
        want = _on_gateway('cpu', 'a-cpu.sock', lambda: S.serial_stream(
            'a-cpu.sock', SERVE_CONNS, SERVE_ROUNDS))
        if (patches, finals) != want:
            raise AssertionError('serve a: card responses differ from the '
                                 'CPU gateway\'s serial run')
        sched = health['scheduler']
        occ = sched['occupancy']
        trivial = _prom_phase_calls(body, 'sched.trivial_rows')
        if not occ['p50'] > 4:
            raise AssertionError('serve a: median occupancy %r' % occ)
        if sched['fallback_oracle'] or sched['live_batch_handles'] or \
                sched['depth_ops'] or sched['queued'] or sched['shedding']:
            raise AssertionError('serve a: not drained: %r' % sched)
        if trivial <= 0:
            raise AssertionError('serve a: no trivial rows counted')
        log('serve a: %d conns x %d rounds in %.3f s, responses equal to '
            'the CPU gateway\'s serial run; occupancy %s docs/flush; queue '
            'wait %s ms; no kernel expected: single-writer registers go '
            'to the host (sched.trivial_rows %d) on %s' % (
                SERVE_CONNS, SERVE_ROUNDS, wall_a, occ,
                sched['queue_wait_ms'], trivial, card))

        # -- (b) overload -------------------------------------------------
        deadline_ms = gw_queue.FLUSH_DEADLINE_MS
        gw_queue.FLUSH_DEADLINE_MS = 25.0

        def lane_b():
            out = S.overload_burst('b.sock')
            with S.RawConn('b.sock') as c:
                until = time.monotonic() + 60
                while True:
                    resp = json.loads(c.call({
                        'cmd': 'apply_changes', 'doc': 'after',
                        'changes': [S.set_change('z', 1, 'k', 1)]}))
                    if resp.get('errorType') != 'Overloaded':
                        break
                    if time.monotonic() > until:
                        raise AssertionError('serve b: never recovered')
                    time.sleep(0.05)
                return out, resp, c.result({'cmd': 'healthz'})
        try:
            (out, resp, health), wall_b, _ = drive(
                'serve b overload card', lambda: _on_gateway(
                    'cuda', 'b.sock', lane_b, queue=AdmissionQueue(
                        max_ops=8)), need=())
        finally:
            gw_queue.FLUSH_DEADLINE_MS = deadline_ms
        shed = [r for r in out if 'error' in r]
        if not shed or any(r['errorType'] != 'Overloaded'
                           or r['retryAfterMs'] < 1 for r in shed) or \
                resp['result']['clock'] != {'z': 1} or not health['ok']:
            raise AssertionError('serve b: %r / %r' % (out, resp))
        log('serve b: %d of %d burst requests shed with Overloaded '
            '(retryAfterMs %d), the rest applied; healthz and a fresh '
            'write answered after the burst; %.3f s on %s' % (
                len(shed), len(out), shed[0]['retryAfterMs'], wall_b, card))

        # -- (c) fan-in through the gateway: K1 + K2, then K3 -------------
        batch = workloads.build_config_3(_random.Random(11),
                                         n_docs=FANIN_DOCS)
        keys = sorted(batch, key=str)
        reqs = [{str(k): batch[k] for k in keys[i:i + FANIN_PER_REQ]}
                for i in range(0, len(keys), FANIN_PER_REQ)]
        hot = [{str(k): v for k, v in b.items()}
               for b in workloads.hot_key_batch(40)]

        def fan_in(path):
            out, errors = [None] * len(reqs), []
            barrier = threading.Barrier(FANIN_CONNS, timeout=120)

            def send(ci):
                try:
                    with S.RawConn(path, 300) as c:
                        barrier.wait()
                        for r in range(ci, len(reqs), FANIN_CONNS):
                            out[r] = c.call({'id': r, 'cmd': 'apply_batch',
                                             'docs': reqs[r]})
                except Exception as e:
                    errors.append('%s: %s' % (type(e).__name__, e))
            threads = [threading.Thread(target=send, args=(ci,))
                       for ci in range(FANIN_CONNS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            if errors:
                raise AssertionError('serve c: %s' % errors)
            return out

        def hot_key(path):
            with S.RawConn(path, 300) as c:
                return [c.call({'id': i, 'cmd': 'apply_batch', 'docs': b})
                        for i, b in enumerate(hot)]

        def lane_c(path):
            telemetry.reset_all()
            (got, wall, busy), _, m = drive(
                'serve c fan-in card', lambda: card_busy(
                    torch, lambda: fan_in(path)), need=(K1, K2), waves=None)
            shares = _flush_shares(telemetry, m, busy)
            got_hot, _, mh = drive('serve c hot key card',
                                   lambda: hot_key(path), need=(K3,))
            return got, wall, m, shares, got_hot, mh
        # the card lanes (c) and (d) time every dispatch between CUDA
        # events and run under the profiler
        telemetry.DEVTIME = True
        try:
            got, wall_c, m_c, shares, got_hot, m_hot = _on_gateway(
                'cuda', 'c.sock', lambda: lane_c('c.sock'))
        finally:
            telemetry.DEVTIME = False
        want = _on_gateway('cpu', 'c-cpu.sock', lambda: (
            fan_in('c-cpu.sock'), hot_key('c-cpu.sock')))
        if got != want[0] or got_hot != want[1]:
            raise AssertionError('serve c: card responses differ from the '
                                 'CPU gateway\'s')
        if any('error' in json.loads(r) for r in got + got_hot):
            raise AssertionError('serve c: an error envelope')
        tiers = {k: v for k, v in m_hot.items()
                 if k.startswith('fallback.escalated.w')}
        log('serve c: %d docs of config 3 in %d apply_batch requests from '
            '%d connections, %d ops, in %.3f s: %d waves, launches K1 %d '
            'K2 %d; %s; hot key of 40 writers: K3 %d, tiers %s, oracle 0; '
            'responses equal to the CPU gateway\'s on %s' % (
                FANIN_DOCS, len(reqs), FANIN_CONNS, workloads.op_count(batch),
                wall_c, m_c.get('pipeline.waves', 0), m_c.get(K1, 0),
                m_c.get(K2, 0), _shares_text(shares), m_hot.get(K3, 0), tiers,
                card))

        # -- (d) bench.py --fanout at its defaults ------------------------
        traffic = S.fanout_bench_traffic(workloads.text_doc_changes,
                                         **FANOUT_BENCH)

        def lane_d():
            telemetry.reset_all()
            ((frames, expected, wall), _, busy), _, m = drive(
                'serve d fanout card', lambda: card_busy(
                    torch, lambda: S.run_fanout_bench(
                        'd.sock', traffic, FANOUT_CONNS)), need=(K2,),
                waves=None)
            snap = telemetry.metrics_snapshot()
            return frames, expected, wall, m, snap, \
                telemetry.FANOUT_LATENCY.summary() or {}, \
                _flush_shares(telemetry, m, busy)
        telemetry.DEVTIME = True
        try:
            frames, expected, wall_d, m_d, snap, lat, shares_d = \
                _on_gateway('cuda', 'd.sock', lane_d)
        finally:
            telemetry.DEVTIME = False
        cpu_frames = _on_gateway('cpu', 'd-cpu.sock', lambda: (
            S.run_fanout_bench('d-cpu.sock', traffic, FANOUT_CONNS)[0]))
        n_frames = sum(len(f) for f in frames)
        if n_frames != expected or snap.get('sync.fanout.frames', 0) \
                < expected:
            raise AssertionError('serve d: %d frames drained, %s sent, %d '
                                 'expected' % (n_frames, snap.get(
                                     'sync.fanout.frames'), expected))
        if frames != cpu_frames:
            raise AssertionError('serve d: card frames differ from the CPU '
                                 'gateway\'s')
        enc = snap.get('sync.fanout.bytes_encoded', 0)
        wire = snap.get('sync.fanout.bytes_on_wire', 0)
        log('serve d: bench --fanout defaults (%d peers, %d docs, %d conns, '
            '%d write rounds, zipf %.1f): %d frames, every connection\'s '
            'frames (all %d peers, not a sample) equal to the CPU '
            'gateway\'s; change->fan-out p50 %s p95 %s p99 %s ms; '
            'amplification %.2f; write wall %.3f s; encode_reuse %d; '
            'launches K1 %d K2 %d; %s on %s' % (
                FANOUT_BENCH['n_peers'], FANOUT_BENCH['n_docs'],
                FANOUT_CONNS, FANOUT_BENCH['n_rounds'],
                FANOUT_BENCH['zipf_s'], n_frames, FANOUT_BENCH['n_peers'],
                lat.get('p50'), lat.get('p95'), lat.get('p99'),
                wire / enc if enc else 0.0, wall_d,
                snap.get('sync.fanout.encode_reuse', 0), m_d.get(K1, 0),
                m_d.get(K2, 0), _shares_text(shares_d), card))

        # -- (e) the fanout-check shape, then snapshot reads --------------
        def lane_e(path):
            subs = S.fanout_subscribers(path, 'hot-doc', 8, 25)
            thin = S.RawConn(path)
            thin.result({'cmd': 'subscribe', 'doc': 'hot-doc', 'clock': {},
                         'peer': 'thin', 'mode': 'patch'})
            writer = S.RawConn(path)
            writer.result({'cmd': 'subscribe', 'doc': 'hot-doc',
                           'clock': {}, 'peer': 'writer'})
            late = S.RawConn(path)
            chs = [S.set_change('writer', s, 'k%d' % (s % 3), s)
                   for s in range(1, 7)]
            reuse0 = telemetry.metrics_snapshot().get(
                'sync.fanout.encode_reuse', 0)
            for s, ch in enumerate(chs, 1):
                writer.result({'cmd': 'apply_changes', 'doc': 'hot-doc',
                               'changes': [ch]})
                if s == 3:
                    late.result({'cmd': 'subscribe', 'doc': 'hot-doc',
                                 'clock': {'writer': 1}, 'peer': 'late',
                                 'backfill': False})
            for c in subs:
                c.wait_events(25 * len(chs))
            thin.wait_events(len(chs))
            late.wait_events(3)
            writer.result({'cmd': 'ping'})
            reuse = telemetry.metrics_snapshot().get(
                'sync.fanout.encode_reuse', 0) - reuse0
            snaps = [writer.result({'cmd': 'snapshot', 'doc': 'hot-doc'})
                     for _ in range(2)]
            hits = telemetry.metrics_snapshot().get(
                'readview.snapshot_hits', 0)
            frames = [c.events for c in subs + [thin, late, writer]]
            for c in subs + [thin, late, writer]:
                c.close()
            return frames, reuse, snaps, hits, chs
        (frames_e, reuse, snaps, hits, chs), wall_e, _ = drive(
            'serve e fanout-check card', lambda: _on_gateway(
                'cuda', 'e.sock', lambda: lane_e('e.sock')), need=())
        cpu_e = _on_gateway('cpu', 'e-cpu.sock',
                            lambda: lane_e('e-cpu.sock'))
        if frames_e != cpu_e[0]:
            raise AssertionError('serve e: card frames differ from the CPU '
                                 'gateway\'s')
        kinds = [json.loads(f)['event'] for f in frames_e[8]]
        if reuse < 199 or frames_e[10] or kinds != ['patch'] * len(chs) \
                or json.loads(frames_e[9][0])['changes'][0]['seq'] != 2:
            raise AssertionError('serve e: reuse %d, writer echo %d, thin '
                                 'kinds %s' % (reuse, len(frames_e[10]),
                                               kinds))
        if snaps[0] != snaps[1] or hits < 1:
            raise AssertionError('serve e: the second snapshot missed the '
                                 'cache')
        import base64
        loaded = NativeDocPool()
        got_patch = loaded.load('x', base64.b64decode(
            snaps[0]['snapshot_b64']))
        replay = NativeDocPool()
        replay.apply_changes('x', chs)
        if msgpack.packb(got_patch) != msgpack.packb(replay.get_patch('x')):
            raise AssertionError('serve e: the snapshot loaded on the card '
                                 'differs from the replay of its history')
        log('serve e: 1 doc x 200 subscribers + a straggler + a patch-mode '
            'peer, %d writes in %.3f s: encode_reuse %d, no echo, %d patch '
            'frames, frames equal to the CPU gateway\'s; snapshot %d B '
            'loaded into a card pool equals the replay, second fetch a '
            'cache hit on %s' % (
                len(chs), wall_e, reuse, len(kinds),
                len(base64.b64decode(snaps[0]['snapshot_b64'])), card))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    if native.live_batch_handles():
        raise AssertionError('serving: live batch handles left')
    log('serving phase: %.1f s wall on %s' % (time.perf_counter() - t_phase,
                                               card))


FLEET_REPLICAS = 3
#: lane (a), `tools/route_check.py`'s shape: docs, writers, the zipf
#: ops of the parity arm and of the rebalance arm
ROUTE_DOCS, ROUTE_WRITERS, ROUTE_OPS, ROUTE_OPS2 = 18, 6, 160, 120
#: lane (c), `tools/failover_check.py`'s shape
FAILOVER_DOCS, FAILOVER_WRITERS, FAILOVER_OPS = 15, 5, (120, 150)
#: lane (d), `tools/readpath_check.py` arm 2: churn flushes, forced gap;
#: then arm 1's writer flushes
READ_CHURN, READ_GAP, READ_AB_ROUNDS = 15, 5, 20
FLEET_COUNTERS = ('launch.registers', 'launch.dominance', 'launch.members',
                  'launch.linearize')


def _prom_value(body, family, label, value):
    import re
    m = re.search(r'^%s\{%s="%s"\} (\S+)$' % (
        re.escape(family), label, re.escape(value)), body, re.M)
    return float(m.group(1)) if m else 0.0


def _free_port():
    import socket
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def replica_counts(path, healthz=True):
    """One replica server's kernel launches, oracle rows, stage spans,
    flushes and docs, read over its own socket (`metrics` and
    `healthz`), and the bytes torch holds on its card (0 on a CPU
    pool).  With `healthz` false, only what `metrics` gives: a healthz
    refreshes the capacity section, which a refresh throttle then holds
    for a second, and a rebalance pass reads it."""
    import torch_serving_cases as S
    with S.RawConn(path, 120) as c:
        if healthz:
            hz = c.result({'cmd': 'healthz'})     # refreshes the mem gauges
        body = c.result({'cmd': 'metrics'})['body']
    out = {k: _prom_counter(body, k) for k in FLEET_COUNTERS}
    out['fallback.oracle'] = _prom_value(body, 'amtpu_fallback_total',
                                         'reason', 'oracle')
    for span in ('host.begin', 'device.dispatch'):
        out[span] = _prom_value(body, 'amtpu_phase_seconds_total', 'phase',
                                span)
    if not healthz:
        return out
    occ = hz['scheduler']['occupancy']
    out['flushes'], out['flushed_docs'] = occ['count'], occ['sum']
    out['owned'] = hz['routing']['owned_docs']
    out['device_bytes'] = _prom_value(body, 'amtpu_mem_used_bytes',
                                      'component', 'device')
    return out


def _deltas(before, after):
    return {k: after[k] - before[k] for k in before
            if isinstance(before[k], (int, float))}


def replica_flushes(path, tids, reqs, ring, member):
    """The flushes of one replica server, in the order it ran them: per
    flush the docs of `member` from the requests it took, {doc: changes}
    in request order.  Read from the server's span file (`--trace
    --trace-file`): the `sidecar.request` span of each batched request
    carries the request's trace id (`tids` maps it to its index in
    `reqs`) and its flush span's id.  Waits for the last spans, which
    the server writes just after it answers."""
    want = sum(1 for r in reqs if any(ring.owner(d) == member for d in r))
    deadline = time.monotonic() + 30
    while True:
        by_flush = {}
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                i = tids.get(rec.get('trace'))
                if i is not None and rec['name'] == 'sidecar.request':
                    by_flush.setdefault(rec['attrs']['flush'], []).append(i)
        if sum(map(len, by_flush.values())) >= want or \
                time.monotonic() > deadline:
            break
        time.sleep(0.05)
    return [{d: reqs[i][d] for i in idxs for d in reqs[i]
             if ring.owner(d) == member} for idxs in by_flush.values()]


def _read_churn(workloads):
    """Lane (d)'s flushes on one Text doc: the setup change, then per
    flush two concurrent changes (two actors inserting and setting text
    elements, both setting one root key): K1 resolves the key's group,
    K2 ranks the inserts."""
    chs = workloads.text_doc_changes('read-text', 2, READ_CHURN, 4,
                                     lambda *a: False)
    for ch in chs[1:]:
        ch['ops'].append({'action': 'set', 'obj': workloads.ROOT_ID,
                          'key': 'hot', 'value': '%s-%d' % (ch['actor'],
                                                            ch['seq'])})
    return [chs[:1]] + [chs[i:i + 2] for i in range(1, len(chs), 2)]


def fleet_phase(card, workloads, drive, K1, K2, K3, batch3, slices3,
                note_remote, capture_as, threads):
    """Phase 13: the port's fleet on the card.  Lanes (a), (b) and (e)
    ('routed') run on three `--device cuda` replica server subprocesses
    behind an in-process `RouterGateway`, lane (c) ('failover') on three
    more under a `ReplicaSupervisor`, lane (d) ('read') on an in-process
    card gateway and two in-process card read replicas.  Every lane
    holds its responses and final docs against a CPU reference.
    `note_remote(label, counts)` adds a replica's launches to the kernel
    line; `capture_as(label, fn)` runs fn with the kernel calls captured
    for phase 11 (not counted); `threads` counts captured calls by
    thread name."""
    import shutil
    import tempfile
    import types

    from automerge_tpu_torch import native

    ctx = types.SimpleNamespace(
        card=card, workloads=workloads, drive=drive, K1=K1, K2=K2, K3=K3,
        batch3=batch3, slices3=slices3, note_remote=note_remote,
        capture_as=capture_as, threads=threads)
    work = tempfile.mkdtemp(prefix='amfl-')
    cwd = os.getcwd()
    os.chdir(work)        # unix socket paths are short: bind relative names
    t_phase = time.perf_counter()
    try:
        for lane, fn in (('routed', _fleet_routed),
                         ('failover', _fleet_failover),
                         ('read', _fleet_read)):
            t = time.perf_counter()
            fn(ctx, work)
            log('fleet %s lanes: %.1f s wall on %s' % (
                lane, time.perf_counter() - t, card))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    if native.live_batch_handles():
        raise AssertionError('fleet: live batch handles left')
    log('fleet phase: %.1f s wall on %s' % (time.perf_counter() - t_phase,
                                             card))


def _fleet_routed(ctx, work):
    """Lanes (a), (b) and (e): three replica servers behind a router."""
    import msgpack
    import torch_serving_cases as S

    from automerge_tpu_torch.native import NativeDocPool
    from automerge_tpu_torch.router import (MigrationExecutor, Rebalancer,
                                            RouterGateway)
    from automerge_tpu_torch.telemetry import fleet as fleet_tel
    from automerge_tpu_torch.tools import proc as P

    card, workloads, drive = ctx.card, ctx.workloads, ctx.drive
    K1, K2, K3 = ctx.K1, ctx.K2, ctx.K3
    batch3, slices3 = ctx.batch3, ctx.slices3
    note_remote, capture_as = ctx.note_remote, ctx.capture_as
    procs, router = {}, None
    try:
        # -- three card replicas behind one router ------------------------
        ports = {'r%d' % i: _free_port() for i in range(FLEET_REPLICAS)}
        paths = {r: '%s.sock' % r for r in ports}
        spans = {r: '%s.spans.jsonl' % r for r in ports}
        t0 = time.perf_counter()
        procs = P.spawn_servers(
            [(paths[r], ['--replica-id', r, '--metrics-port', str(ports[r]),
                         '--trace', '--trace-file', spans[r]])
             for r in sorted(paths)], device='cuda', deadline_s=300,
            cwd=work)
        log('fleet: %d replica servers (--device cuda) up in %.1f s on %s'
            % (len(procs), time.perf_counter() - t0, card))
        base = {r: replica_counts(p, healthz=False) for r, p in paths.items()}
        router = RouterGateway('router.sock', paths).start()
        ring = router.ring

        # -- (a) routed parity, placement, rebalance under writers --------
        docs = S.pick_docs(ring, ROUTE_DOCS)
        seqs = S.zipf_seqs(docs, ROUTE_OPS)
        streams = [(d, [S.route_change(d, s) for s in range(1, seqs[d] + 1)])
                   for d in docs]
        (acks, raw, retries, errors), wall_a, _ = drive(
            'fleet a routed card', lambda: S.routed_writers(
                'router.sock', streams, ROUTE_WRITERS), need=(), waves=None)
        if errors:
            raise AssertionError('fleet a: writers failed: %s' % errors)
        with S.RawConn('router.sock') as c:
            finals = {d: c.call({'id': 'final', 'cmd': 'get_patch',
                                 'doc': d}) for d in docs}
        want_raw, want_finals = _on_gateway(
            'cpu', 'a-cpu.sock', lambda: S.serial_route_replay(
                'a-cpu.sock', seqs))
        if raw != want_raw or finals != want_finals:
            raise AssertionError('fleet a: routed responses differ from the '
                                 'serial CPU gateway\'s')
        owners0 = {d: ring.owner(d) for d in docs}
        counts = {r: replica_counts(p) for r, p in paths.items()}
        if any(c['fallback.oracle'] for c in counts.values()):
            raise AssertionError('fleet a: oracle rows %r' % counts)
        for r in sorted(paths):
            note_remote('fleet a routed %s' % r, _deltas(base[r], counts[r]))
        log('fleet a: %d docs zipf over %d replicas (hot ranks on %s), %d '
            'requests from %d writers in %.3f s, %d retried; every response '
            'and final patch equal to one CPU gateway\'s serial replay; '
            'oracle 0 on every replica on %s' % (
                len(docs), len(paths), owners0[docs[0]], len(raw),
                ROUTE_WRITERS, wall_a, len(retries), card))
        seqs2 = S.zipf_seqs(docs, ROUTE_OPS2)
        streams2 = [(d, [S.route_change(d, s) for s in range(
            seqs[d] + 1, seqs[d] + seqs2[d] + 1)]) for d in docs]
        load_out = []
        load = threading.Thread(target=lambda: load_out.append(
            S.routed_writers('router.sock', streams2, ROUTE_WRITERS)))
        rb = Rebalancer(router, executor=MigrationExecutor(
            router, handoff_dir='handoff', timeout_s=60.0),
            interval_s=3600, topk=4, min_skew=0.2, pressure=0.8)
        moved, passes = [], 0
        t0 = time.perf_counter()
        load.start()
        try:
            for _ in range(4):
                res = rb.scan()
                passes += 1
                if res is None:
                    break
                if res['failed']:
                    raise AssertionError('fleet a: migration failed %r'
                                         % res)
                moved += res['docs']
        finally:
            load.join(timeout=300)
        wall_a2 = time.perf_counter() - t0
        acks2, _, retries2, errors2 = load_out[0]
        if errors2 or not moved:
            raise AssertionError('fleet a: writers %s, moved %r'
                                 % (errors2, moved))
        for d in docs:
            if acks2[d] != list(range(seqs[d] + 1, seqs[d] + seqs2[d] + 1)):
                raise AssertionError('fleet a: acks of %s lost, duplicated '
                                     'or reordered: %r' % (d, acks2[d]))
        for r, p in sorted(paths.items()):
            note_remote('fleet a rebalance %s' % r,
                        _deltas(counts[r], replica_counts(p)))
        total = {d: seqs[d] + seqs2[d] for d in docs}
        with S.RawConn('router.sock') as c:
            finals = {d: c.call({'id': 'final', 'cmd': 'get_patch',
                                 'doc': d}) for d in docs}
        if finals != _on_gateway('cpu', 'a2-cpu.sock', lambda: (
                S.serial_route_replay('a2-cpu.sock', total)[1])):
            raise AssertionError('fleet a: final patches after the '
                                 'migrations differ from the CPU replay')
        log('fleet a: rebalance under %d writers moved %s (%d passes) in '
            '%.3f s; every (doc, seq) acked once and in order (%d retried); '
            'final patches equal to the CPU replay; ring v%d on %s' % (
                ROUTE_WRITERS, moved, passes, wall_a2,
                len(retries2), ring.version, card))

        # -- (b) config 3 fanned in through the router --------------------
        keys = sorted(batch3, key=str)
        reqs = [{str(k): batch3[k] for k in keys[i:i + FANIN_PER_REQ]}
                for i in range(0, len(keys), FANIN_PER_REQ)]
        split = sum(1 for r in reqs if len({ring.owner(d) for d in r}) > 1)
        # each request's own trace id: a replica's span file then says
        # which requests each of its flushes took
        tids = {'fb%030x' % i: i for i in range(len(reqs))}
        tctx = {i: {'traceId': t, 'spanId': '%016x' % (i + 1)}
                for t, i in tids.items()}

        def fan_in(path):
            out, errors = [None] * len(reqs), []
            barrier = threading.Barrier(FANIN_CONNS, timeout=300)

            def send(ci):
                try:
                    with S.RawConn(path, 600) as c:
                        barrier.wait()
                        for r in range(ci, len(reqs), FANIN_CONNS):
                            out[r] = c.call({'id': r, 'cmd': 'apply_batch',
                                             'docs': reqs[r],
                                             'trace': tctx[r]})
                except Exception as e:
                    errors.append('%s: %s' % (type(e).__name__, e))
            ts = [threading.Thread(target=send, args=(ci,))
                  for ci in range(FANIN_CONNS)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=600)
            if errors:
                raise AssertionError('fleet b: %s' % errors)
            return out
        before = {r: replica_counts(p) for r, p in paths.items()}
        got, wall_b, _ = drive('fleet b fan-in card', lambda: fan_in(
            'router.sock'), need=(), waves=None)
        after = {r: replica_counts(p) for r, p in paths.items()}
        n_docs = 0
        for i, line in enumerate(got):
            resp = json.loads(line)
            if resp.get('id') != i or 'result' not in resp:
                raise AssertionError('fleet b: request %d answered %.200s'
                                     % (i, line))
            if sorted(resp['result']) != sorted(reqs[i]):
                raise AssertionError('fleet b: request %d joined the wrong '
                                     'docs' % i)
            for d, patch in resp['result'].items():
                if patch != msgpack.unpackb(slices3[d], raw=False):
                    raise AssertionError('fleet b: doc %s differs from '
                                         'phase 1\'s patch' % d)
                n_docs += 1
        delta = {r: _deltas(before[r], after[r]) for r in paths}
        for r, dl in sorted(delta.items()):
            if dl[K1] <= 0 or dl[K2] <= 0 or dl['launch.linearize'] <= 0 \
                    or dl['fallback.oracle']:
                raise AssertionError('fleet b: replica %s launched K1 %d K2 '
                                     '%d linearize %d, oracle %d' % (
                                         r, dl[K1], dl[K2],
                                         dl['launch.linearize'],
                                         dl['fallback.oracle']))
            note_remote('fleet b fan-in %s' % r, dl)
        log('fleet b: %d docs of config 3 (%d ops) in %d apply_batch '
            'requests of %d from %d connections (%d split across owners and '
            'joined) in %.3f s; every doc\'s patch equal to phase 1\'s on '
            '%s' % (n_docs, workloads.op_count(batch3), len(reqs),
                    FANIN_PER_REQ, FANIN_CONNS, split, wall_b, card))
        for r in sorted(paths):
            dl = delta[r]
            log('fleet b %s: %d docs, %d flushes (%.1f docs a flush), '
                'launches K1 %d K2 %d K3 %d, oracle 0, host.begin %.4f s, '
                'device.dispatch %.4f s, %d B on the card, on %s' % (
                    r, sum(1 for k in keys if ring.owner(str(k)) == r),
                    dl['flushes'], dl['flushed_docs'] / max(1, dl['flushes']),
                    dl[K1], dl[K2], dl[K3], dl['host.begin'],
                    dl['device.dispatch'], after[r]['device_bytes'], card))
        log('fleet b: summed over the replicas host.begin %.4f s, '
            'device.dispatch %.4f s on %s' % (
                sum(d['host.begin'] for d in delta.values()),
                sum(d['device.dispatch'] for d in delta.values()), card))
        # each replica's real flushes, regrouped from its span file; the
        # largest is replayed here on a fresh card pool for phase 11
        for r in sorted(paths):
            flushes = replica_flushes(spans[r], tids, reqs, ring, r)
            sizes = [len(f) for f in flushes]
            if len(flushes) != delta[r]['flushes'] or \
                    sum(sizes) != delta[r]['flushed_docs']:
                raise AssertionError(
                    'fleet b: %s span file holds %d flushes of %d docs, its '
                    'occupancy %d of %d' % (r, len(flushes), sum(sizes),
                                            delta[r]['flushes'],
                                            delta[r]['flushed_docs']))
            big = max(flushes, key=lambda f: (len(f), workloads.op_count(f)))
            log('fleet b %s: flushes of %d to %d docs (mean %.1f) from its '
                'span file; the largest (%d docs, %d ops) replayed for phase '
                '11 on %s' % (r, min(sizes), max(sizes),
                              sum(sizes) / len(sizes), len(big),
                              workloads.op_count(big), card))
            pool = NativeDocPool(device='cuda')
            capture_as('fleet b %s largest flush (%d docs)' % (r, len(big)),
                       lambda: pool.apply_batch_bytes(msgpack.packb(
                           big, use_bin_type=True)))
        hot = [{str(k): v for k, v in b.items()}
               for b in workloads.hot_key_batch(40)]

        def hot_key(path):
            with S.RawConn(path, 300) as c:
                return [c.call({'id': i, 'cmd': 'apply_batch', 'docs': b})
                        for i, b in enumerate(hot)]
        owner = ring.owner('doc')
        before = replica_counts(paths[owner])
        got_hot, wall_h, _ = drive('fleet b hot key card', lambda: hot_key(
            'router.sock'), need=(), waves=None)
        dl = _deltas(before, replica_counts(paths[owner]))
        if got_hot != _on_gateway('cpu', 'h-cpu.sock',
                                  lambda: hot_key('h-cpu.sock')):
            raise AssertionError('fleet b: hot-key responses differ from '
                                 'the CPU gateway\'s')
        if dl[K3] <= 0 or dl['fallback.oracle']:
            raise AssertionError('fleet b: hot key on %s: K3 %d, oracle %d'
                                 % (owner, dl[K3], dl['fallback.oracle']))
        note_remote('fleet b hot key %s' % owner, dl)
        pool = NativeDocPool(device='cuda')
        capture_as('fleet b replay hot key', lambda: [
            pool.apply_batch_bytes(msgpack.packb(b, use_bin_type=True))
            for b in hot])
        log('fleet b: hot key of 40 writers through the router to %s in '
            '%.3f s: launches K1 %d K2 %d K3 %d, oracle 0, responses equal '
            'to the CPU gateway\'s on %s' % (owner, wall_h, dl[K1], dl[K2],
                                             dl[K3], card))

        # -- (e) fleet telemetry over the replicas' HTTP listeners --------
        scrapes, section = fleet_tel.scrape_fleet(
            ['http://127.0.0.1:%d' % ports[r] for r in sorted(ports)])
        owned = sum(m.get('owned_docs') or 0
                    for m in section['routing']['members'])
        want_docs = len(batch3) + len(docs) + 1
        if section['errors'] or \
                tuple(sorted(section)) != S.FLEET_SECTION_KEYS or \
                tuple(sorted(section['headroom'])) != \
                S.FLEET_HEADROOM_KEYS or \
                tuple(sorted(section['routing'])) != S.FLEET_ROUTING_KEYS or \
                any(tuple(sorted(r)) != S.FLEET_REPLICA_KEYS
                    for r in section['replicas']) or \
                sorted(r['replica_id'] for r in section['replicas']) != \
                sorted(ports) or owned != want_docs:
            raise AssertionError('fleet e: section %s' % json.dumps(
                section, default=str)[:2000])
        log('fleet e: scrape_fleet over %d listeners: keys as pinned, docs '
            '%s = %d (%d + %d + the hot-key doc), merged mutate 3600s '
            'count %s, headroom used %s B on %s' % (
                len(scrapes), {m['replica_id']: m.get('owned_docs')
                               for m in section['routing']['members']},
                owned, len(batch3), len(docs), section['slo']['classes'].get(
                    'mutate', {}).get('3600s', {}).get('count'),
                section['headroom']['used_bytes'], card))
    finally:
        if router is not None:
            router.stop()
        P.stop_all(procs)


def _fleet_failover(ctx, work):
    """Lane (c): a SIGKILL under a supervisor with health and failover."""
    import torch_serving_cases as S

    from automerge_tpu_torch import telemetry
    from automerge_tpu_torch.router import (FailoverExecutor, HealthMonitor,
                                            MigrationExecutor, Rebalancer,
                                            ReplicaSupervisor, RouterGateway)
    from automerge_tpu_torch.sidecar.client import SidecarClient

    card, workloads = ctx.card, ctx.workloads
    K1, note_remote = ctx.K1, ctx.note_remote
    router = sup = hm = None
    try:
        # -- (c) failover under a supervisor ------------------------------
        os.makedirs('c')
        router = RouterGateway('c/router.sock', {},
                               journal_path='c/placement.json').start()
        ex = FailoverExecutor(router)
        hm = HealthMonitor(router, heartbeat_s=0.1, deadline_s=0.5,
                           miss_max=3, on_dead=ex.fail_over).start()
        sup = ReplicaSupervisor(router, 'c', health=hm, failover=ex,
                                device='cuda', spawn_deadline_s=300.0)
        t0 = time.perf_counter()
        spawned, errs = [], []

        def spawn(base):
            try:
                spawned.append(sup.spawn(base))
            except Exception as e:
                errs.append(e)
        ts = [threading.Thread(target=spawn, args=('r%d' % i,))
              for i in range(FLEET_REPLICAS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        if errs or len(spawned) != FLEET_REPLICAS:
            raise AssertionError('fleet c: spawn failed: %r' % errs)
        sup.start()
        log('fleet c: %d supervised replicas (--device cuda --durable --sync) '
            'up in %.1f s on %s' % (len(spawned), time.perf_counter() - t0,
                                    card))
        cring = router.ring
        fdocs = ['doc-%03d' % i for i in range(FAILOVER_DOCS)]
        seqs1 = S.zipf_seqs(fdocs, FAILOVER_OPS[0])
        seqs2 = S.zipf_seqs(fdocs, FAILOVER_OPS[1])
        ftotal = {d: seqs1[d] + seqs2[d] for d in fdocs}
        acks1, _, _, errs1 = S.routed_writers('c/router.sock', [
            (d, [S.route_change(d, s) for s in range(1, seqs1[d] + 1)])
            for d in fdocs], FAILOVER_WRITERS)
        if errs1:
            raise AssertionError('fleet c: writers failed: %s' % errs1)
        victim = cring.owner(fdocs[0])
        victim_docs = [d for d in fdocs if cring.owner(d) == victim]
        sub_doc = victim_docs[0]
        sub = SidecarClient(sock_path='c/router.sock')
        seen = set(ch['seq'] for ch in sub.subscribe(
            sub_doc, peer='failover-watch').get('changes') or ())
        load_out = []
        load = threading.Thread(target=lambda: load_out.append(
            S.routed_writers('c/router.sock', [
                (d, [S.route_change(d, s)
                     for s in range(seqs1[d] + 1, ftotal[d] + 1)])
                for d in fdocs], FAILOVER_WRITERS)))

        def poll(cond, limit, what):
            t = time.perf_counter()
            while not cond():
                if time.perf_counter() - t > limit:
                    raise AssertionError('fleet c: timed out on %s' % what)
                time.sleep(0.01)
        load.start()
        time.sleep(0.3)                   # the writers are mid-stream
        t_kill = time.perf_counter()
        sup.proc(victim).kill()
        poll(lambda: hm.state(victim) == 'dead', 60, 'death detection')
        detect_s = time.perf_counter() - t_kill
        poll(lambda: victim not in router.replicas, 120, 'the failover')
        restore_s = time.perf_counter() - t_kill
        poll(lambda: any(m.endswith('-g1') for m in router.replicas), 300,
             'the respawned generation')
        rejoin_s = time.perf_counter() - t_kill
        load.join(timeout=600)
        acks2, _, retries2, errs2 = load_out[0]
        if errs2:
            raise AssertionError('fleet c: hard failures: %s' % errs2)
        # every launch the live members made since they came up (all of
        # it lane (c)'s writes); the victim's died with it
        for m, path in sorted(router.replicas.items()):
            note_remote('fleet c writers %s' % m, replica_counts(path))
        for d in fdocs:
            if acks2[d] != list(range(seqs1[d] + 1, ftotal[d] + 1)):
                raise AssertionError('fleet c: acks of %s lost, duplicated '
                                     'or reordered: %r' % (d, acks2[d]))
        with S.RawConn('c/router.sock') as c:
            ffinals = {d: c.call({'id': 'final', 'cmd': 'get_patch',
                                  'doc': d}) for d in fdocs}
        if ffinals != _on_gateway('cpu', 'c-cpu.sock', lambda: (
                S.serial_route_replay('c-cpu.sock', ftotal)[1])):
            raise AssertionError('fleet c: final patches differ from the '
                                 'serial CPU replay')
        deadline = time.monotonic() + 60
        while not set(range(1, ftotal[sub_doc] + 1)) <= seen:
            if time.monotonic() > deadline:
                raise AssertionError('fleet c: the subscriber saw %s'
                                     % sorted(seen))
            ev = sub.next_event(timeout=30)
            if ev is not None and ev.get('event') == 'change':
                seen.update(ch['seq'] for ch in ev.get('changes') or ())
        sub.close()
        flat = telemetry.metrics_snapshot()
        joiner = next(m for m in router.replicas if m.endswith('-g1'))
        rb = Rebalancer(router, executor=MigrationExecutor(
            router, handoff_dir='c/handoff', timeout_s=60.0),
            interval_s=3600, topk=4, min_skew=0.2, pressure=0.8)
        drained = []
        for _ in range(4):
            res = rb.scan()
            if res is None:
                break
            drained += [d for d in res['docs'] if cring.owner(d) == joiner]
        # every live member's pool is on the card: a two-writer batch
        # sent to each directly launches K1 there
        probe = [{'probe': v} for b in workloads.hot_key_batch(2)
                 for v in b.values()]
        live = {}
        for m, path in sorted(router.replicas.items()):
            before = replica_counts(path)
            with S.RawConn(path) as c:
                for b in probe:
                    c.result({'cmd': 'apply_batch', 'docs': b})
            live[m] = _deltas(before, replica_counts(path))
            note_remote('fleet c probe %s' % m, live[m])
        flat = telemetry.metrics_snapshot()
        if flat.get('router.resyncs', 0) < 1 or not drained or \
                flat.get('failover.docs_lost', 0) or \
                flat.get('failover.failovers') != 1 or \
                flat.get('router.health.deaths') != 1 or \
                len(router.replicas) != FLEET_REPLICAS or any(
                    c['fallback.oracle'] or c[K1] <= 0
                    for c in live.values()):
            raise AssertionError('fleet c: resyncs %s, drained %r, lost %s, '
                                 'failovers %s, deaths %s, members %s, '
                                 'probes %r' % (
                                     flat.get('router.resyncs'), drained,
                                     flat.get('failover.docs_lost'),
                                     flat.get('failover.failovers'),
                                     flat.get('router.health.deaths'),
                                     hm.members(), live))
        log('fleet c: SIGKILL of %s (%d of %d docs) mid-flush: detect_s '
            '%.3f restore_s %.3f rejoin_s %.3f (as %s); %d retried '
            'requests, no ack lost or duplicated; final patches equal to the '
            'serial CPU replay; the subscriber resynced with no gap (seqs '
            '1-%d of %s); recovered %d, replayed %d; %d docs drained back '
            'onto %s; oracle 0; each member launched K1 on a probe batch '
            '(%s) on %s' % (
                victim, len(victim_docs), len(fdocs), detect_s, restore_s,
                rejoin_s, joiner, len(retries2), ftotal[sub_doc], sub_doc,
                flat.get('failover.docs_recovered', 0),
                flat.get('failover.replayed', 0), len(drained), joiner,
                {m: int(c[K1]) for m, c in live.items()}, card))
    finally:
        # the monitor first: replicas the supervisor stops must not be
        # failed over
        for obj in (hm, sup, router):
            if obj is not None:
                obj.stop()


def _fleet_read(ctx, work):
    """Lane (d): two card read replicas following one card gateway."""
    import torch_frontend_cases as FC
    import torch_serving_cases as S

    import automerge_tpu_torch as am
    from automerge_tpu_torch import telemetry
    from automerge_tpu_torch.readview.replica import ReadReplica

    card, workloads, drive = ctx.card, ctx.workloads, ctx.drive
    K1, K2 = ctx.K1, ctx.K2
    threads = ctx.threads
    # -- (d) read replicas on the card --------------------------------
    os.makedirs('d')
    churn = _read_churn(workloads)
    doc = 'read-doc'
    gw = _gateway('cuda', 'd/up.sock', sync_dir='d/store')
    rep = rep2 = None
    try:
        with S.RawConn('d/up.sock') as up:
            up.result({'cmd': 'apply_changes', 'doc': doc,
                       'changes': churn[0]})
            rep = ReadReplica('d/up.sock', 'd/read.sock', docs=[doc],
                              device='cuda', probe_s=0.2, slo_s=30.0)

            def lane_d():
                rep.start()
                with S.RawConn('d/read.sock') as rd:
                    for flush in churn[1:]:
                        up.result({'cmd': 'apply_changes', 'doc': doc,
                                   'changes': flush})
                        rd.result({'cmd': 'get_patch', 'doc': doc})
                    for s in range(1, READ_GAP + 1):
                        up.result({'cmd': 'apply_changes',
                                   'doc': 'gap-doc', 'changes': [
                                       S.route_change('gap-doc', s)]})
                    n_gap = rep.resync_doc('gap-doc')
                    refused = rd.call({'id': 'w', 'cmd': 'apply_changes',
                                       'doc': doc,
                                       'changes': [S.route_change(
                                           doc, 1)]})
                    deadline = time.monotonic() + 60
                    while True:
                        want = [up.call({'id': 'p', 'cmd': 'get_patch',
                                         'doc': d})
                                for d in (doc, 'gap-doc')]
                        got = [rd.call({'id': 'p', 'cmd': 'get_patch',
                                        'doc': d})
                               for d in (doc, 'gap-doc')]
                        if got == want or time.monotonic() > deadline:
                            return n_gap, refused, got, want
                        time.sleep(0.02)
            threads.clear()
            (n_gap, refused, got, want), wall_d, _ = drive(
                'fleet d read replica card', lane_d, need=(K1, K2),
                waves=None)
            by_replica = {k: sum(n for t, n in v.items()
                                 if t.startswith('amtpu-replica'))
                          for k, v in threads.items()}
            stale = rep.healthz_section()
            # readpath arm 1: a change-mode client with a full port
            # backend and a patch-mode thin client on the card gateway
            t_ab = time.perf_counter()
            end_ab, ab = FC.readpath_arm(am, 'd/up.sock',
                                         READ_AB_ROUNDS)
            wall_ab = time.perf_counter() - t_ab
            rep.stop()
            rep = None
            rep2 = ReadReplica('d/up.sock', 'd/read2.sock',
                               store_dir='d/store', device='cuda',
                               probe_s=0.2, slo_s=30.0).start()
            with S.RawConn('d/read2.sock') as rd2:
                deadline = time.monotonic() + 60
                while True:
                    got2 = [rd2.call({'id': 'p', 'cmd': 'get_patch',
                                      'doc': d}) for d in (doc, 'gap-doc')]
                    if got2 == want or time.monotonic() > deadline:
                        break
                    time.sleep(0.02)
            boot = telemetry.metrics_snapshot().get(
                'readview.replica_bootstrap_docs', 0)
    finally:
        for r in (rep, rep2):
            if r is not None:
                r.stop()
        gw.stop()
    envelope = json.loads(refused)
    cpu_want = _on_gateway('cpu', 'd-cpu.sock', lambda: _read_ref(
        'd-cpu.sock', doc, churn))
    if n_gap != READ_GAP or got != want or got2 != want or \
            want != cpu_want or envelope.get('errorType') != 'ReadOnly' \
            or boot < 2 or by_replica.get('registers', 0) <= 0 \
            or by_replica.get('dominance', 0) <= 0:
        raise AssertionError('fleet d: gap %d, equal %s/%s/%s, %r, '
                             'bootstrap %s, replica calls %r' % (
                                 n_gap, got == want, got2 == want,
                                 want == cpu_want, envelope, boot,
                                 by_replica))
    log('fleet d: a card read replica followed %d churn flushes of 2 '
        'concurrent writers in %.3f s (its pool called K1 %d, K2 %d '
        'times), closed a forced gap of %d changes by resync, answered '
        'a write with ReadOnly; get_patch equal to the upstream\'s and '
        'to a CPU gateway\'s; a second replica bootstrapped %d docs from '
        'the upstream\'s write-through store and ends equal; staleness '
        '%s on %s' % (len(churn) - 1, wall_d,
                      by_replica.get('registers', 0),
                      by_replica.get('dominance', 0), n_gap, boot,
                      stale, card))
    log('fleet d readpath arm 1: %d writer flushes of one doc on the card '
        'gateway; the change-mode client (full port backend) and the '
        'patch-mode thin client both end equal to get_patch (%d keys) in '
        '%.3f s; thin-client apply CPU %.3f ms (patch) against %.3f ms '
        '(change), wire %d B against %d B (printed, not asserted; host '
        'CPU beside %s)' % (
            READ_AB_ROUNDS, len(end_ab), wall_ab, ab['patch_cpu_s'] * 1e3,
            ab['change_cpu_s'] * 1e3, ab['patch_wire_bytes'],
            ab['change_wire_bytes'], card))


def _read_ref(path, doc, churn):
    """Lane (d)'s writes on one gateway: the final patches of the
    followed doc and the gap doc."""
    import torch_serving_cases as S
    with S.RawConn(path) as c:
        for flush in churn:
            c.result({'cmd': 'apply_changes', 'doc': doc, 'changes': flush})
        for s in range(1, READ_GAP + 1):
            c.result({'cmd': 'apply_changes', 'doc': 'gap-doc',
                      'changes': [S.route_change('gap-doc', s)]})
        return [c.call({'id': 'p', 'cmd': 'get_patch', 'doc': d})
                for d in (doc, 'gap-doc')]


def patch_slices(buf):
    """{doc key: raw patch bytes} of a batch result map."""
    import msgpack
    u = msgpack.Unpacker(None, max_buffer_size=0, raw=False)
    u.feed(buf)
    out = {}
    for _ in range(u.read_map_header()):
        key = u.unpack()
        start = u.tell()
        u.skip()
        out[key] = buf[start:u.tell()]
    return out


#: phase 15: lane (b) is BASELINE config 1 (10,000 characters in changes
#: of 50); lane (c) has this many writers on one hot key (past the
#: sliding window, as `hot_key_batch(40)`) after this many rounds of two
#: frontends
FRONTEND_CHARS, FRONTEND_PER_CHANGE = 10000, 50
FRONTEND_WRITERS, FRONTEND_ROUNDS = 40, 3
#: lane (b)'s calls are held in phase 11 with the largest first, so that
#: its timed call is the one on the 10,000-element object
LARGEST_FIRST = 'frontend b typing gpu'


def _quantile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _stdio_counts(conn):
    """A stdio server's kernel launches and oracle rows (`metrics`)."""
    import torch_frontend_cases as FC
    body = FC.metrics_body(conn)
    out = {k: _prom_counter(body, k) for k in FLEET_COUNTERS}
    out['fallback.oracle'] = _prom_value(body, 'amtpu_fallback_total',
                                         'reason', 'oracle')
    return out


def frontend_phase(card, drive, K1, K2, K3, note_remote):
    """Phase 15: port frontends with the `backend=tpu` adapter's Backend
    surface (`tests/torch_frontend_cases.PortMirror`) as their immediate
    backend, on the card.  (a) the reference-shaped session against a
    `python -m automerge_tpu_torch.sidecar.server --device cuda` stdio
    subprocess; (b) config 1 typed by two frontends and (c) concurrent
    assignments, 40 writers on one key, through an in-process card
    `SidecarBackend.handle`.  Every lane's transcript (each request,
    patch and materialized document) must equal, as JSON, the same lane
    with the port's scalar oracle as the immediate backend; lanes (b) and
    (c) must launch K1 and K2 (c: K3 too)."""
    import torch_frontend_cases as FC

    import automerge_tpu_torch as am
    from automerge_tpu_torch import errors, native
    from automerge_tpu_torch.sidecar.server import SidecarBackend

    oracle = FC.OracleSurface(am)
    t_phase = time.perf_counter()

    # -- (a) the reference-shaped session, a server subprocess ----------
    t0 = time.perf_counter()
    conn = FC.StdioServer('cuda')
    try:
        FC.request(conn, errors, 'ping', {})
        log('frontend a: stdio server subprocess up in %.1f s on %s'
            % (time.perf_counter() - t0, card))
        before = _stdio_counts(conn)
        got_a, wall_a, _ = drive('frontend a session server',
                                 lambda: FC.session_lane(
                                     am, FC.PortMirror(conn, errors)),
                                 need=())
        counts_a = _deltas(before, _stdio_counts(conn))
    finally:
        conn.close()
    if conn.proc.returncode != 0:
        raise AssertionError('frontend a: the server exited %s'
                             % conn.proc.returncode)
    if got_a != FC.session_lane(am, oracle):
        raise AssertionError('frontend a: the card server\'s session '
                             'differs from the oracle\'s')
    if counts_a['fallback.oracle']:
        raise AssertionError('frontend a: %d oracle rows' %
                             counts_a['fallback.oracle'])
    note_remote('frontend a session server', counts_a)
    log('frontend a: the session (init, 9 changes with a Text and a Table, '
        'applyChanges, merge, undo and redo, getPatch, save then load) in '
        '%.3f s, %d transcript records equal to the oracle\'s; the server '
        'launched K1 %d, K2 %d, K3 %d times on %s' % (
            wall_a, len(json.loads(got_a)), counts_a['launch.registers'],
            counts_a['launch.dominance'], counts_a['launch.members'], card))

    # -- (b) config 1 through two frontends, in process ------------------
    backend = SidecarBackend(device='cuda')
    inproc = FC.InProcess(backend)
    mirror = FC.PortMirror(inproc, errors)
    body0 = backend.handle({'cmd': 'metrics'})['result']['body']
    (got_b, texts, rtt), wall_b, m_b = drive(
        LARGEST_FIRST, lambda: FC.typing_lane(
            am, mirror, FRONTEND_CHARS, FRONTEND_PER_CHANGE),
        need=(K1, K2))
    body1 = backend.handle({'cmd': 'metrics'})['result']['body']
    want_b, want_texts, _ = FC.typing_lane(am, oracle, FRONTEND_CHARS,
                                           FRONTEND_PER_CHANGE)
    if got_b != want_b or texts != want_texts or texts[0] != texts[1] or \
            len(texts[0]) != FRONTEND_CHARS:
        raise AssertionError('frontend b: the card transcript or texts '
                             'differ from the oracle\'s (%d, %d chars)'
                             % tuple(len(t) for t in texts))
    server_b = {k: _prom_counter(body1, k) - _prom_counter(body0, k)
                for k in FLEET_COUNTERS}
    if server_b['launch.registers'] != m_b.get(K1, 0) or \
            server_b['launch.dominance'] != m_b.get(K2, 0) or \
            server_b['launch.linearize'] != m_b.get('launch.linearize', 0):
        raise AssertionError('frontend b: the server\'s counters %r '
                             'disagree with the trace' % server_b)
    slowest = sorted(range(len(rtt)), key=lambda i: -rtt[i])[:3]
    log('frontend b: %d characters in %d changes of %d by actors a0 and '
        'a1 in %.3f s wall, %.3f s of it in the sidecar\'s handle (the '
        'pool; the rest frontend Python and JSON); round trip of one '
        'change (local change, then the other replica\'s remote apply): '
        'median %.3f ms, p99 %.3f ms, slowest %s; %d transcript records; '
        'the server counted %s; both texts equal, transcript equal to the '
        'oracle\'s on %s' % (
            FRONTEND_CHARS, len(rtt), FRONTEND_PER_CHANGE, wall_b,
            inproc.seconds, _quantile(rtt, 0.5) * 1e3,
            _quantile(rtt, 0.99) * 1e3,
            ', '.join('#%d %.3f ms' % (i, rtt[i] * 1e3) for i in slowest),
            len(json.loads(got_b)),
            {k: int(v) for k, v in server_b.items()}, card))

    # -- (c) concurrent assignments, 40 writers on one key --------------
    got_c, wall_c, m_c = drive('frontend c conflicts gpu', lambda: FC
                               .conflict_lane(am, mirror, FRONTEND_WRITERS,
                                              FRONTEND_ROUNDS),
                               need=(K1, K2, K3))
    if got_c != FC.conflict_lane(am, oracle, FRONTEND_WRITERS,
                                 FRONTEND_ROUNDS):
        raise AssertionError('frontend c: the card transcript differs from '
                             'the oracle\'s')
    tiers = {k: v for k, v in m_c.items()
             if k.startswith('fallback.escalated.w')}
    log('frontend c: %d rounds of two frontends on the same keys and list '
        'elements, then %d writers on one key, in %.3f s; conflicts and '
        'transcript equal to the oracle\'s; launches K1 %d, K2 %d, K3 %d, '
        'tiers %s on %s' % (FRONTEND_ROUNDS, FRONTEND_WRITERS, wall_c,
                            m_c.get(K1, 0), m_c.get(K2, 0), m_c.get(K3, 0),
                            tiers, card))
    if native.live_batch_handles():
        raise AssertionError('frontend: live batch handles left')
    log('frontend phase: %.1f s wall on %s' % (time.perf_counter() - t_phase,
                                                card))


#: the batched engine's stage spans (phase 14 lane (a))
ENGINE_SPANS = ('engine.schedule', 'engine.prepass', 'engine.encode',
                'engine.kernels', 'engine.emit', 'engine.materialize')


def step_equal(label, got, want):
    """Every output key of two `single_step` results bit-equal."""
    for k in want:
        if not bool((got[k].cpu() == want[k].cpu()).all()):
            raise AssertionError('%s: output %s differs from the CPU step'
                                 % (label, k))


def stages_text(stages):
    """One line of `step_ab.time_steps`'s stages: each span's issue ms on
    the host and ms between CUDA events on the card."""
    return ', '.join('%s issued %.3f / card %.3f' % (
        k[len('step.'):], v['issue_ms'], v['event_ms'])
        for k, v in stages.items())


def step_process_check(torch, mesh, trace, card, lanes):
    """Whether the step is slower in this long-lived process than in a
    fresh one, and why: for each lane (name, batch, linearize
    iterations) 20 steps here with the garbage collector on, 20 with it
    off, and 20 in a fresh process of this checkout (`tools/step_ab.py
    --child`), each with its main thread's share of CPU over the runs
    and its stages' issue times; beside this process's live threads."""
    import collections
    import gc

    from step_ab import run_child, time_steps
    out = {'threads': dict(collections.Counter(
        re.sub(r'\d+', 'N', t.name) for t in threading.enumerate()))}
    for lane, batch, n_iters in lanes:
        here = time_steps(torch, mesh, trace, batch, n_iters, runs=20)
        gc.disable()
        try:
            gc_off = time_steps(torch, mesh, trace, batch, n_iters,
                                runs=20)
        finally:
            gc.enable()
        out[lane] = {'here': here, 'gc_off': gc_off}
    fresh = run_child(ROOT, 20)
    for lane, _, _ in lanes:
        out[lane]['fresh'] = fresh[lane]
        for arm in ('here', 'gc_off', 'fresh'):
            got = out[lane][arm]
            walls = sorted(got['walls'])
            log('step %s, %s: median %.4f s (min %.4f) of %d runs, main '
                'thread CPU %.3f of %.3f s; %s on %s' % (
                    lane, {'here': 'this process',
                           'gc_off': 'this process, gc off',
                           'fresh': 'a fresh process'}[arm],
                    walls[len(walls) // 2], walls[0], len(walls),
                    got['loop_cpu_s'], got['loop_s'],
                    stages_text(got['stages']), card))
    log('step process check: %d threads alive here %s on %s'
        % (sum(out['threads'].values()), json.dumps(out['threads']), card))
    return out


def step_without_host_reads(torch, mesh, label, batch, n_iters, want):
    """The step's post-upload part (`mesh.step_tensors`: schedule through
    the route) under torch.cuda.set_sync_debug_mode('error'): any read of
    the card back to the host raises.  Its outputs must equal `want`."""
    b = mesh.upload_batch(batch, torch.device('cuda'))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = mesh.step_tensors(b, mesh.n_groups_of(batch), n_iters)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_equal(label + ' (sync-debug error mode)', out, want)


def engine_phase(torch, card, workloads, drive, K1, K2, K3, KS, KI,
                 batch3, out_gpu3, pool3, packed):
    """Phase 14: the batched engine and the single-device step.
    (a) `TPUDocPool(device='cuda')` applies config 3 (4,096 docs,
    1,064,960 ops) as one `apply_batch`: every doc's patch equal to phase
    1's (the card pool's bytes), every whole-doc `get_patch` equal to the
    card pool's; logs wall, op/s, the six `engine.*` spans and the K1 and
    K2 launches.  (b) hot keys of 40 and 200 writers: K3 launches, no
    oracle row, patches and `fallback.*` counters equal to a CPU
    engine's.  (c) `single_step` on `scaling_workload(2048)` (73,728 ops,
    the multichip workload at dp = 1): every output key bit-equal to the
    CPU step's, the schedule kernel, K1 and the whole-doc route launch,
    `verify_against_pool` through a card engine.  (d) config 1 (one Text
    doc, 10,000 inserts) as `bench.py::run_config_1_mesh` runs it at sp
    = 1: a counted warm-up run, then the median of 3 timed runs,
    bit-equal to the CPU step, verified against a card engine; and
    config 1 through one card `NativeDocPool`, its patch equal to the
    card engine's.  On both step lanes the post-upload part runs once
    more under the sync-debug mode 'error' (no host read; outputs equal
    to the CPU step's), and 3 runs log per-stage times (`step_ab.
    time_steps`, the median run's); then `step_process_check`.  Returns
    the phase's report."""
    import msgpack

    from automerge_tpu_torch import telemetry, trace
    from automerge_tpu_torch.native import NativeDocPool
    from automerge_tpu_torch.ops import list_rank
    from automerge_tpu_torch.parallel import mesh, mesh_encode
    from automerge_tpu_torch.parallel.engine import TPUDocPool
    from step_ab import time_steps
    t_phase = time.perf_counter()
    report = {}

    # -- (a) config 3 through the card engine ----------------------------
    n_ops3 = workloads.op_count(batch3)
    want = msgpack.unpackb(out_gpu3, raw=False)
    engine = TPUDocPool(device='cuda')
    was_on = telemetry.enabled()
    telemetry.phase_reset()
    telemetry.enable()
    try:
        got, wall, m = drive('engine config3 gpu', lambda: engine.apply_batch(
            batch3), need=(K1, K2), waves=None)
        t = time.perf_counter()
        mat = {d: engine.get_patch(d) for d in batch3}
        mat_s = time.perf_counter() - t
    finally:
        if not was_on:
            telemetry.disable()
    spans = {k: v['s'] for k, v in telemetry.phase_snapshot().items()
             if k in ENGINE_SPANS}
    bad = [d for d in batch3 if got[d] != want[str(d)]]
    if bad:
        raise AssertionError('engine config3: %d patches differ from phase '
                             '1\'s, first doc %r' % (len(bad), bad[0]))
    bad = [d for d in batch3 if mat[d] != pool3.get_patch(str(d))]
    if bad:
        raise AssertionError('engine config3: %d whole-doc patches differ '
                             'from the card pool\'s' % len(bad))
    report['config3'] = {'docs': len(batch3), 'ops': n_ops3, 'wall_s': wall,
                         'ops_per_s': n_ops3 / wall,
                         'get_patch_all_s': mat_s, 'spans_s': spans,
                         'launches': {k: m.get(k, 0) for k in (K1, K2)}}
    log('engine config3 gpu: %d docs, %d ops in %.3f s (%.0f op/s); every '
        'patch equal to phase 1\'s, %d whole-doc patches equal to the card '
        'pool\'s in %.3f s; spans %s; launches K1 %d K2 %d on %s' % (
            len(batch3), n_ops3, wall, n_ops3 / wall, len(mat), mat_s,
            {k: round(v, 3) for k, v in spans.items()}, m.get(K1, 0),
            m.get(K2, 0), card))
    del engine, got, mat

    # -- (b) hot keys through the card engine ----------------------------
    for n_writers in (40, 200):
        payloads = workloads.hot_key_batch(n_writers)
        eg = TPUDocPool(device='cuda')
        outs, _, mh = drive('engine hot key %d gpu' % n_writers, lambda: [
            eg.apply_batch(b) for b in payloads], need=(K3,), waves=None)
        trace.reset()
        ec = TPUDocPool(device='cpu')
        outs_c = [ec.apply_batch(b) for b in payloads]
        tiers = {k: v for k, v in mh.items() if k.startswith('fallback.')}
        tiers_c = {k: v for k, v in trace.metrics().items()
                   if k.startswith('fallback.')}
        if outs != outs_c or tiers != tiers_c:
            raise AssertionError('engine hot key %d: card %s, CPU %s'
                                 % (n_writers, tiers, tiers_c))
        report['hot_key_%d' % n_writers] = tiers
        log('engine hot key %d writers: patches equal to the CPU engine\'s, '
            'counters %s on both, K3 launches %d on %s' % (
                n_writers, tiers, mh.get(K3, 0), card))

    # -- (c) the step on the multichip workload at dp = 1 -----------------
    wl = mesh_encode.scaling_workload(2048)
    t = time.perf_counter()
    batch, meta = mesh_encode.encode_batch(wl)
    enc_s = time.perf_counter() - t
    n_iters = list_rank.ceil_log2(max(meta['max_arena'], 1)) + 1
    n_ops = workloads.op_count(wl)
    out, wall_c, mc = drive('step scaling 2048 gpu', lambda: mesh.single_step(
        batch, n_iters), need=(KS, K1, KI), waves=None)
    cpu_out = mesh.single_step(batch, n_iters, device='cpu')
    step_equal('step scaling 2048', out, cpu_out)
    step_without_host_reads(torch, mesh, 'step scaling 2048', batch, n_iters,
                            cpu_out)
    stepped = time_steps(torch, mesh, trace, batch, n_iters)
    walls_c, stages_c = stepped['walls'], stepped['stages']
    t = time.perf_counter()
    mesh_encode.verify_against_pool(wl, meta, out)
    ver_s = time.perf_counter() - t
    report['scaling_2048'] = {'docs': len(wl), 'ops': n_ops,
                              'encode_s': enc_s, 'step_s': wall_c,
                              'verify_s': ver_s, 'step_runs_s': walls_c,
                              'stages_ms': stages_c,
                              'shapes': {k: list(batch[k].shape) for k in (
                                  'ch_deps', 'rc', 'eo', 'op_elem')}}
    log('step scaling 2048 gpu: %d docs, %d ops, encode %.3f s, step %.4f s '
        '(first run), every output key bit-equal to the CPU step, verified '
        'against a card engine in %.3f s; launches %s on %s' % (
            len(wl), n_ops, enc_s, wall_c, ver_s,
            {k: mc.get(k, 0) for k in (KS, K1, K2, KI)}, card))
    log('step scaling 2048 gpu: no host read after the uploads (sync-debug '
        'error mode), outputs equal; stages of the median of 3 runs (walls '
        '%s s), ms issued on the host and between CUDA events as each '
        'span closes: %s on %s' % (['%.4f' % w for w in walls_c],
                                   stages_text(stages_c), card))

    # -- (d) config 1: the step and one card pool -------------------------
    wl1 = workloads.build_config_1(random.Random(7))
    n_ops1 = workloads.op_count(wl1)
    batch1, meta1 = mesh_encode.encode_batch(wl1, sp=1)
    n_iters1 = list_rank.ceil_log2(max(meta1['max_arena'], 1)) + 1
    out1, wall_w, _ = drive('step config1 gpu', lambda: mesh.single_step(
        batch1, n_iters1), need=(KS, K1, KI), waves=None)
    stepped = time_steps(torch, mesh, trace, batch1, n_iters1)
    times, stages1 = stepped['walls'], stepped['stages']
    med = sorted(times)[1]
    cpu_out1 = mesh.single_step(batch1, n_iters1, device='cpu')
    step_equal('step config1', out1, cpu_out1)
    step_without_host_reads(torch, mesh, 'step config1', batch1, n_iters1,
                            cpu_out1)
    mesh_encode.verify_against_pool(wl1, meta1, out1)
    pool1 = NativeDocPool()
    payload1 = packed(wl1)
    out_p, wall_p, _ = drive('config1 gpu', lambda: pool1.apply_batch_bytes(
        payload1), need=(K1, K2))
    eng1 = TPUDocPool(device='cuda').apply_batch(wl1)
    if msgpack.unpackb(out_p, raw=False)['0'] != eng1[0] or \
            out_p != NativeDocPool(device='cpu').apply_batch_bytes(payload1):
        raise AssertionError('config1: the card pool\'s patch differs from '
                             'the card engine\'s or the CPU pool\'s')
    report['config1'] = {'ops': n_ops1, 'warm_up_s': wall_w,
                         'step_runs_s': times, 'step_median_s': med,
                         'stages_ms': stages1,
                         'step_ops_per_s': n_ops1 / med,
                         'pool_wall_s': wall_p}
    log('step config1 gpu: %d ops, warm-up %.4f s, runs %s, median %.4f s '
        '(%.0f op/s), bit-equal to the CPU step, verified against a card '
        'engine; one card pool %.4f s, patch equal to the card engine\'s on '
        '%s' % (n_ops1, wall_w, ['%.4f' % x for x in times], med,
                n_ops1 / med, wall_p, card))
    log('step config1 gpu: no host read after the uploads (sync-debug error '
        'mode), outputs equal; stages of the median run, ms issued on the '
        'host and between CUDA events as each span closes: %s on %s'
        % (stages_text(stages1), card))
    t = time.perf_counter()
    report['process_check'] = step_process_check(
        torch, mesh, trace, card, (('config1', batch1, n_iters1),
                                   ('scaling2048', batch, n_iters)))
    log('step process check: %.1f s' % (time.perf_counter() - t))
    report['phase_s'] = time.perf_counter() - t_phase
    log('engine phase: %.1f s wall on %s' % (report['phase_s'], card))
    log('engine: ' + json.dumps(report))
    return report


#: phase 16 (d): the sp-crossover probe's text sizes (characters) and the
#: keystrokes a size (the first is not timed)
SP_SIZES = (8192, 32768, 131072, 262144)
SP_EDITS = 6


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def mesh_phase(torch, card, workloads, drive, K1, K2, KS, KB, payload3,
               out_gpu3):
    """Phase 16: the multi-device path, every dp x sp cell on `cuda:0`.
    (a) `dryrun.dryrun_multichip(4)`: the text, map and table workloads
    through the sharded step at dp = 2 x sp = 2, verified against a card
    engine (the text one bit-equal to the single step), then the step on
    `scaling_workload(2048)` at (dp, sp) = (1, 1), (2, 1), (4, 1) and (2,
    2), each verified and bit-equal to the first run of its sp encoding,
    the median of 3 recorded; then the (2, 2) step after its uploads once
    under the sync-debug mode 'error', every output equal to `single_step`
    on the same batch.  (b) config 1 through the sharded step at dp = 1,
    sp = 1, 2 and 4: every output equal to `single_step`'s, the median of
    3.  (c) `MeshDocPool(dp)` at dp = 1, 2 and 4 on config 3: every doc's
    patch equal to phase 1's one-pool bytes; the wall and the `mesh.*`
    counters.  (d) the sp-crossover probe (`bench.py::
    run_multichip_sp_child`): a text of each of SP_SIZES characters built
    in `MeshDocPool(1, 2)`, then SP_EDITS keystrokes, resident, with
    `sp_min` 16 (the sharded arm: every resident batch runs the block
    kernel on two sp blocks) and the default (131,072: the texts below it
    fenced, K2 on one device, the others sharded); every batch's bytes
    and the final patches equal across the arms; the median edit ms (the
    first keystroke not counted), each build batch's ms,
    `mesh.sp_engaged` and `mesh.sp_fenced`.  (e) `sync/distributed.
    launch(2)`: two worker processes, each with two replica pools on
    `cuda:0`, gossip over gloo; every replica of every process equal to
    the port oracle's tree (the workers check); rounds and walls.  Over
    (a), (b) and (d) every doc of the block route's calls must take its
    fast branch (`block_branch_counts`, `report['block_branches']`).
    Returns the phase's report."""
    import msgpack

    from automerge_tpu_torch import dryrun, trace
    from automerge_tpu_torch.native.mesh_pool import MeshDocPool
    from automerge_tpu_torch.ops import dominance_kernel, list_rank
    from automerge_tpu_torch.parallel import mesh, mesh_encode
    from automerge_tpu_torch.sync import distributed
    t_phase = time.perf_counter()
    report = {'block_branches': {'fast': 0, 'scan': 0, 'lanes': {}}}
    branch = dominance_kernel.block_branch_counts(torch.device('cuda'))

    def block_branches(lane):
        """The block route's branch counters over `lane` (zeroed before
        it): every doc of every block call on the fast branch."""
        fast, scan = branch.tolist()
        branch.zero_()
        if scan or not fast:
            raise AssertionError('mesh (%s): block route branches %d fast, '
                                 '%d scan' % (lane, fast, scan))
        report['block_branches']['fast'] += fast
        report['block_branches']['lanes'][lane] = fast
        log('mesh (%s): %d docs of the block route\'s calls, all on its '
            'fast branch (device counters) on %s' % (lane, fast, card))

    # -- (a) the dryrun: three workloads, then the scaling table ----------
    branch.zero_()
    table, wall_a, _ = drive('mesh (a) dryrun gpu', lambda: dryrun
                             .dryrun_multichip(4),
                             need=(KS, K1, KB), waves=None)
    report['a_scaling'] = table
    big = mesh_encode.scaling_workload(dryrun.SCALING_DOCS)
    batch, meta = mesh_encode.encode_batch(big, sp=2)
    n_iters = list_rank.ceil_log2(max(meta['max_arena'], 1)) + 1
    grid = mesh.make_mesh(2, 2)
    step = mesh.build_sharded_step(grid, n_iters, chunk=16)
    sb = mesh.shard_batch(grid, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = step(sb)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_equal('mesh (a) dp=2 sp=2 (sync-debug error mode)', out,
               mesh.single_step(batch, n_iters))
    block_branches('a')
    log('mesh (a): dryrun %.3f s; scaling 2048 step medians %s; the dp=2 '
        'x sp=2 step after its uploads read nothing back (sync-debug error '
        'mode) and equals single_step on every key, on %s' % (
            wall_a, ['dp=%d sp=%d %.4f s' % (r['dp'], r['sp'], r['median_s'])
                     for r in table], card))

    # -- (b) config 1 through the sharded step at dp = 1 ------------------
    wl1 = workloads.build_config_1(random.Random(7))
    report['b_config1'] = {}
    for sp in (1, 2, 4):
        batch1, meta1 = mesh_encode.encode_batch(wl1, sp=sp)
        it1 = list_rank.ceil_log2(max(meta1['max_arena'], 1)) + 1
        g1 = mesh.make_mesh(1, sp)
        step1 = mesh.build_sharded_step(g1, it1)
        sb1 = mesh.shard_batch(g1, batch1)
        out1, first, m1 = drive('mesh (b) config1 sp=%d gpu' % sp,
                                lambda: step1(sb1), need=(KS, K1, KB),
                                waves=None)
        step_equal('mesh (b) config1 sp=%d' % sp, out1,
                   mesh.single_step(batch1, it1))
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            step1(sb1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        report['b_config1'][sp] = {'first_s': first, 'runs_s': walls,
                                   'median_s': _median(walls),
                                   'block_launches': m1.get(KB, 0)}
        log('mesh (b) config1 sp=%d: %d elements a block, first %.4f s, '
            'median of 3 %.4f s, equal to single_step on every key on %s'
            % (sp, batch1['eo'].shape[1] // sp, first, _median(walls), card))

    block_branches('b')

    # -- (c) the mesh pool on config 3 -------------------------------------
    want3 = patch_slices(out_gpu3)
    report['c_config3'] = {}
    for dp in (1, 2, 4):
        out_m, wall_m, mm = drive('mesh (c) config3 dp=%d gpu' % dp,
                                  lambda: MeshDocPool(dp).apply_batch_bytes(
                                      payload3), need=(K1, K2), waves=None)
        if patch_slices(out_m) != want3:
            raise AssertionError('mesh (c) dp=%d: patches differ from one '
                                 'card pool\'s' % dp)
        counters = {k: v for k, v in mm.items() if k.startswith('mesh.')}
        report['c_config3'][dp] = {'wall_s': wall_m, 'mesh': counters}
        log('mesh (c) config3 dp=%d: %.3f s, every patch equal to one card '
            'pool\'s; %s on %s' % (dp, wall_m, counters, card))

    # -- (d) the sp-crossover probe ----------------------------------------
    branch.zero_()
    report['d_sp_probe'] = {}
    results = {}
    for arm, sp_min in (('sp_min 16', 16), ('default', None)):
        kw = {} if sp_min is None else {'sp_min': sp_min}
        pool = MeshDocPool(1, 2, **kw)
        rows, builds, outs = {}, {}, []

        def probe(pool=pool, rows=rows, builds=builds, outs=outs):
            for n in SP_SIZES:
                doc = 'sp-%d' % n
                t = time.perf_counter()
                outs.append(pool.apply_batch_bytes(msgpack.packb(
                    {doc: workloads.long_text_doc(n)}, use_bin_type=True)))
                torch.cuda.synchronize()
                builds[n] = (time.perf_counter() - t) * 1e3
                times = []
                for kind, body, _single in workloads.keystroke_edits(
                        n, n_keys=SP_EDITS)[:SP_EDITS]:
                    assert kind == 'batch'
                    payload = msgpack.packb({doc: body}, use_bin_type=True)
                    t = time.perf_counter()
                    outs.append(pool.apply_batch_bytes(payload))
                    times.append(time.perf_counter() - t)
                rows[n] = _median(times[1:]) * 1e3
                outs.append(pool.get_patch(doc))
        _, wall_d, md = drive('mesh (d) sp probe %s gpu' % arm, probe,
                              need=(KB,) if sp_min else (K2, KB),
                              waves=None)
        results[arm] = outs
        report['d_sp_probe'][arm] = {
            'edit_ms': rows, 'build_ms': builds, 'wall_s': wall_d,
            'sp_engaged': md.get('mesh.sp_engaged', 0),
            'sp_fenced': md.get('mesh.sp_fenced', 0),
            'resident_dispatches': md.get('resident.dispatches', 0)}
        log('mesh (d) sp probe, %s arm: median keystroke ms %s, build '
            'batch ms %s, sp_engaged %d, sp_fenced %d, resident dispatches '
            '%d, %.1f s on %s' % (
                arm, {k: round(v, 4) for k, v in rows.items()},
                {k: round(v, 2) for k, v in builds.items()},
                md.get('mesh.sp_engaged', 0), md.get('mesh.sp_fenced', 0),
                md.get('resident.dispatches', 0), wall_d, card))
    if results['sp_min 16'] != results['default']:
        raise AssertionError('mesh (d): the two arms\' patches differ')
    block_branches('d')
    d = report['d_sp_probe']
    lo, hi = d['sp_min 16'], d['default']
    if lo['sp_fenced'] or lo['sp_engaged'] != lo['resident_dispatches'] or \
            not hi['sp_fenced'] or not hi['sp_engaged'] or \
            hi['sp_engaged'] + hi['sp_fenced'] != hi['resident_dispatches'] \
            or lo['resident_dispatches'] != hi['resident_dispatches']:
        raise AssertionError('mesh (d): fence counters %s' % d)

    # -- (e) two processes over gloo, replicas on the card ----------------
    t = time.perf_counter()
    outs_e = distributed.launch(2, timeout=300)
    wall_e = time.perf_counter() - t
    rounds, views = [], []
    for pid, o in enumerate(outs_e):
        m = re.search(r'DISTRIBUTED-OK pid=%d rounds=\[([0-9, ]+)\] '
                      r'wall=([0-9.]+)' % pid, o)
        v = re.search(r'DISTRIBUTED-TREES pid=%d (.*)$' % pid, o, re.M)
        if not m or not v:
            raise AssertionError('mesh (e): worker %d did not report:\n%s'
                                 % (pid, o[-2000:]))
        rounds.append(([int(x) for x in m.group(1).split(',')],
                       float(m.group(2))))
        views.append(json.loads(v.group(1)))
    if any(r[-1] != 0 or not sum(r) for r, _w in rounds) or \
            any(v != views[0] for v in views):
        raise AssertionError('mesh (e): rounds %s or trees differ' % rounds)
    report['e_distributed'] = {'rounds': [r for r, _w in rounds],
                               'catch_up_s': [w for _r, w in rounds],
                               'launch_s': wall_e}
    log('mesh (e) launch(2): rounds %s, catch-up %s s in the workers, %.2f '
        's with the processes\' start; every replica of every process '
        'equal to the oracle\'s tree on %s' % (
            [r for r, _w in rounds], [w for _r, w in rounds], wall_e, card))
    report['phase_s'] = time.perf_counter() - t_phase
    log('mesh phase: %.1f s wall on %s' % (report['phase_s'], card))
    log('mesh: ' + json.dumps(report))
    return report


#: phase 17: the sanitizer lane's workload (`tests/test_analysis.py::
#: BATCH_WORKLOAD`: each doc's 8 actors set one key a round) at 4,096
#: docs, so 32,768 fresh clock rows a round, and the device wait queued
#: ahead of the deliberate alias's copy (`torch.cuda._sleep` cycles, about
#: 0.1 s at the H100's clock)
SANITIZE_DOCS = 4096
SANITIZE_ROUNDS = (1, 2, 3)
ALIAS_SLEEP_CYCLES = 200000000


def sanitize_round(r, docs=SANITIZE_DOCS, actors=8):
    root = '00000000-0000-0000-0000-000000000000'
    return {'doc%d' % d: [{'actor': 'w%d' % a, 'seq': r, 'deps': {},
                           'ops': [{'action': 'set', 'obj': root,
                                    'key': 'shared%d' % (r % 3),
                                    'value': 'a%d r%d' % (a, r)}]}
                          for a in range(actors)]
            for d in range(docs)}


def aliasing_table(torch, np, sanitize, clock_cache, orig):
    """`PoolClockCache.table` with its delta re-opened as an alias: the
    staging rows live in page-locked memory and cross in a non_blocking
    copy queued behind a long device wait on the same stream, so the
    card reads them only after the host has poisoned them."""
    def table(self, L, pool):
        import ctypes
        info = (ctypes.c_int64 * 4)()
        L.amtpu_resclk_info(pool, info)
        n, ap, gen = int(info[0]), int(info[1]), int(info[2])
        if self.tab is None or gen != self.gen or ap != self.ap \
                or n <= self.n:
            return orig(self, L, pool)
        if n > self.cap:
            grown = torch.zeros((clock_cache._bucket_pow2(n, floor=64),
                                 self.tab.shape[1]), dtype=torch.int32,
                                device=self.device)
            grown[:self.cap] = self.tab
            self.tab, self.cap = grown, grown.shape[0]
        host = torch.zeros((n - self.n, self.tab.shape[1]),
                           dtype=torch.int32, pin_memory=True)
        rows = host.numpy()
        rows[:, :ap] = np.ctypeslib.as_array(L.amtpu_resclk_tab(pool),
                                             shape=(n, ap))[self.n:n]
        dev_rows = torch.empty(rows.shape, dtype=torch.int32,
                               device=self.device)
        torch.cuda._sleep(ALIAS_SLEEP_CYCLES)
        # static-ok: dispatch-alias -- the lane's deliberate alias
        dev_rows.copy_(host, non_blocking=True)
        self.tab.index_copy_(0, torch.arange(self.n, n, device=self.device),
                             dev_rows)
        sanitize.poison(rows)
        self.gen, self.n, self.ap = gen, n, ap
        return self.tab
    return table


def analysis_phase(torch, card, drive, K1, packed):
    """Phase 17: (a) the port's static gate on this checkout; (b) the
    sanitizer armed on a clean card pipeline (the resident clock cache
    engaged): the bytes equal to the unarmed run and to a CPU pool's,
    and buffers poisoned; (c) the deliberate alias: a patched delta
    hands the clock table the staging rows through an asynchronous copy
    from page-locked memory, then the sanitizer poisons them, and the
    bytes must diverge from the reference.  Returns the phase's report."""
    import numpy as np

    from automerge_tpu_torch.analysis import sanitize
    from automerge_tpu_torch.native import NativeDocPool, clock_cache
    t_phase = time.perf_counter()
    report = {}

    # -- (a) the static gate ----------------------------------------------
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'automerge_tpu_torch.tools.static_check',
         '--no-lint'], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    report['gate_s'] = time.perf_counter() - t0
    out = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0 or \
            'static-check: PASS (4 checkers)' not in out:
        raise AssertionError('static gate: exit %d\n%s'
                             % (proc.returncode, out[-4000:]))
    log('static gate: 0 findings from 4 checkers in %.3f s on %s'
        % (report['gate_s'], card))

    # -- (b) the sanitizer armed on a clean pipeline ----------------------
    payloads = [packed(sanitize_round(r)) for r in SANITIZE_ROUNDS]

    def rounds(device=None):
        pool = NativeDocPool(device=device)
        return [pool.apply_batch_bytes(p) for p in payloads]
    ref, report['unarmed_s'], m_ref = drive(
        'sanitize unarmed gpu', rounds, need=(K1,), waves=None)
    if not m_ref.get('resident.batch_delta_rows'):
        raise AssertionError('sanitize: the resident clock cache took no '
                             'delta (%s)' % {k: v for k, v in m_ref.items()
                                             if k.startswith('resident.')})
    n0 = sanitize.poisoned_count()
    sanitize.arm()
    try:
        armed, report['armed_s'], m_armed = drive(
            'sanitize armed gpu', rounds, need=(K1,), waves=None,
            phases=True)
    finally:
        sanitize.arm(False)
    report['poisoned_buffers'] = sanitize.poisoned_count() - n0
    if armed != ref:
        raise AssertionError('sanitize: the armed sanitizer changed the '
                             'bytes of a clean pipeline')
    if report['poisoned_buffers'] <= 0 or \
            m_armed.get('sanitize.poisoned_buffers') != \
            report['poisoned_buffers']:
        raise AssertionError('sanitize: %d buffers poisoned, counter %r'
                             % (report['poisoned_buffers'],
                                m_armed.get('sanitize.poisoned_buffers')))
    t0 = time.perf_counter()
    if rounds('cpu') != ref:
        raise AssertionError('sanitize: the card\'s bytes differ from a CPU '
                             'pool\'s')
    report['cpu_s'] = time.perf_counter() - t0
    report['delta_rows'] = m_armed.get('resident.batch_delta_rows', 0)
    log('sanitizer armed: %d docs x 8 actors x %d rounds, %d clock rows '
        'delta-uploaded, %d buffers poisoned (sanitize.poisoned_buffers '
        '%d); bytes equal to the unarmed run and to a CPU pool\'s; walls '
        'unarmed %.3f s, armed %.3f s, CPU %.3f s on %s' % (
            SANITIZE_DOCS, len(SANITIZE_ROUNDS), report['delta_rows'],
            report['poisoned_buffers'],
            m_armed.get('sanitize.poisoned_buffers'), report['unarmed_s'],
            report['armed_s'], report['cpu_s'], card))

    # -- (c) the deliberate alias on the card -----------------------------
    orig = clock_cache.PoolClockCache.table
    clock_cache.PoolClockCache.table = aliasing_table(
        torch, np, sanitize, clock_cache, orig)
    n0 = sanitize.poisoned_count()
    sanitize.arm()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aliased = rounds()
        torch.cuda.synchronize()
        report['alias_s'] = time.perf_counter() - t0
    finally:
        sanitize.arm(False)
        clock_cache.PoolClockCache.table = orig
    report['alias_poisoned'] = sanitize.poisoned_count() - n0
    diff = []
    for got, want in zip(aliased, ref):
        want = patch_slices(want)
        diff.append(sum(1 for k, v in patch_slices(got).items()
                        if want.get(k) != v))
    report['alias_docs_differing'] = diff
    if not any(diff):
        raise AssertionError('sanitize: the deliberate alias was not caught '
                             '(%d buffers poisoned)'
                             % report['alias_poisoned'])
    report['phase_s'] = time.perf_counter() - t_phase
    log('deliberate alias caught: %d staging buffers poisoned behind the '
        'in-flight copy, docs differing per round %s, %.3f s; analysis '
        'phase %.1f s wall on %s' % (report['alias_poisoned'], diff,
                                     report['alias_s'], report['phase_s'],
                                     card))
    return report


def hostile_staging(torch, np, card, workloads, NativeDocPool, R, packed):
    """A pipelined batch of 256 docs on the card (254 Text docs of config
    3 and two cut config-5 docs, whose register groups climb the
    escalation ladder) with every private host array (the pool's copies
    of C++ columns, tier chunks and clock rows, all of which reach the
    card through `ops.registers.upload`) overwritten with 0x5B bytes as
    soon as its upload returned; the bytes must equal a CPU pool's.
    Kernel launches here are not counted."""
    import random as _random
    from automerge_tpu_torch import trace
    batch = workloads.build_config_3(_random.Random(5), n_docs=254)
    for d, chs in workloads.build_config_5(_random.Random(5), n_docs=2,
                                           n_changes=2).items():
        batch['c5-%d' % d] = chs
    payload = packed(batch)
    orig = R.upload
    n = [0]

    def hostile(host, device):
        out = orig(host, device)
        if out.device.type == 'cuda':
            host.view(np.uint8)[...] = 0x5B
            n[0] += 1
        return out
    R.upload = hostile
    try:
        trace.reset()
        got = NativeDocPool().apply_batch_bytes(payload)
        torch.cuda.synchronize()
        waves = trace.metrics().get('pipeline.waves', 0)
    finally:
        R.upload = orig
    if got != NativeDocPool(device='cpu').apply_batch_bytes(payload):
        raise AssertionError('hostile staging: GPU and CPU bytes differ')
    tiers = sum(v for k, v in trace.metrics().items()
                if k.startswith('fallback.escalated.w'))
    if waves != 2 or n[0] == 0 or tiers == 0:
        raise AssertionError('hostile staging: %d waves, %d arrays, %d tier '
                             'rows' % (waves, n[0], tiers))
    log('hostile staging: 256 docs in %d waves (%d tier rows), %d host '
        'arrays overwritten after upload, bytes equal to the CPU pool on %s'
        % (waves, tiers, n[0], card))
    # the batched engine's seams (register, linearize, tier and dominance
    # uploads) on the same batch, and the step's on 64 multichip docs
    from automerge_tpu_torch.ops import list_rank
    from automerge_tpu_torch.parallel import mesh, mesh_encode
    from automerge_tpu_torch.parallel.engine import TPUDocPool
    wl = mesh_encode.scaling_workload(64)
    step_batch, meta = mesh_encode.encode_batch(wl)
    n_iters = list_rank.ceil_log2(max(meta['max_arena'], 1)) + 1
    n_pool = n[0]
    R.upload = hostile
    try:
        trace.reset()
        eng = TPUDocPool().apply_batch(batch)
        step = mesh.single_step(step_batch, n_iters)
        torch.cuda.synchronize()
        tiers = sum(v for k, v in trace.metrics().items()
                    if k.startswith('fallback.escalated.w'))
    finally:
        R.upload = orig
    if eng != TPUDocPool(device='cpu').apply_batch(batch):
        raise AssertionError('hostile staging: the card engine\'s patches '
                             'differ from the CPU engine\'s')
    step_equal('hostile staging step', step,
               mesh.single_step(step_batch, n_iters, device='cpu'))
    if n[0] - n_pool < len(mesh.BATCH_KEYS) or tiers == 0:
        raise AssertionError('hostile staging: engine and step uploaded %d '
                             'arrays, %d tier rows' % (n[0] - n_pool, tiers))
    log('hostile staging: the card engine (256 docs, %d tier rows) and the '
        'step (64 docs) with %d host arrays overwritten after upload, equal '
        'to the CPU engine and step on %s' % (tiers, n[0] - n_pool, card))
    # the mesh pool's chips (each on its own stream) and the sharded
    # step's cells, on the same batches
    from automerge_tpu_torch.native.mesh_pool import MeshDocPool
    grid, cpu_grid = mesh.make_mesh(2, 2), mesh.make_mesh(2, 2, ['cpu'])
    sp_batch, sp_meta = mesh_encode.encode_batch(wl, sp=2)
    sp_iters = list_rank.ceil_log2(max(sp_meta['max_arena'], 1)) + 1
    n_step = n[0]
    R.upload = hostile
    try:
        got_m = MeshDocPool(2).apply_batch_bytes(payload)
        sharded = mesh.build_sharded_step(grid, sp_iters)(
            mesh.shard_batch(grid, sp_batch))
        torch.cuda.synchronize()
    finally:
        R.upload = orig
    if patch_slices(got_m) != patch_slices(
            NativeDocPool(device='cpu').apply_batch_bytes(payload)):
        raise AssertionError('hostile staging: the mesh pool\'s patches '
                             'differ from the CPU pool\'s')
    step_equal('hostile staging sharded step', sharded,
               mesh.build_sharded_step(cpu_grid, sp_iters)(
                   mesh.shard_batch(cpu_grid, sp_batch)))
    if n[0] - n_step < 4 * len(mesh.BATCH_KEYS):
        raise AssertionError('hostile staging: the mesh pool and sharded '
                             'step uploaded %d arrays' % (n[0] - n_step))
    log('hostile staging: a MeshDocPool(2) (256 docs) and the dp=2 x sp=2 '
        'sharded step (64 docs) with %d host arrays overwritten after '
        'upload, equal to the CPU pool and sharded step on %s'
        % (n[0] - n_step, card))


#: the first-call lane: fresh processes of FIRST_CALL_THREADS threads
#: each, FIRST_CALL_AT_ONCE at a time, and one more in which a
#: MeshDocPool(FIRST_CALL_DP) takes config 3's first FIRST_CALL_DOCS docs
FIRST_CALL_PROCS, FIRST_CALL_AT_ONCE, FIRST_CALL_THREADS = 6, 2, 8
#: the threads of a child that take a call's smaller shape, where it has one
FIRST_CALL_SMALL = 2
FIRST_CALL_DP, FIRST_CALL_DOCS = 4, 512
#: a fresh process's limit (seconds)
FIRST_CALL_TIMEOUT = 240
#: the calls every thread makes, in this order, all threads released into
#: each by the barrier: the sibling sort on the grid route (with its
#: scratch query), the register order per doc, linearize on route (b)
#: and (a), K2 on its long route; then the kernels that set their
#: shared-memory attribute, each at a larger shape and, on
#: FIRST_CALL_SMALL threads, a smaller one: K2's short route and the
#: schedule above 48 KB a block at both (62.0 and 52.0 KiB, 72.0 and
#: 63.0 KiB), the whole-doc route and the sp-block kernel (which set it
#: on every call) at one doc of 16,384 elements and 10,000 ops beside 64
#: docs of 300 and 700.  (name, size, smaller size or None)
FIRST_CALLS = (('sibling_sort', 131072, None),
               ('register_sort', (2048, 32), None),
               ('linearize_b', 16384, None), ('linearize_a', 4096, None),
               ('dominance_long', (16, 8192, 64), None),
               ('dominance_short', (16, 7680, 64), (16, 6400, 64)),
               ('schedule', (64, 64, 32), (64, 56, 32)),
               ('route', (1, 16384, 10000, 1), (64, 300, 700, 5)),
               ('route_block', (1, 16384, 10000, 1), (64, 300, 700, 5)))
#: K2's long route past the grid's y limit: objects, elements, ops, and
#: the seeded objects tiled over them
WIDE_DOMINANCE = (65537, 8192, 64, 8)


def first_call_size(i, size, small):
    """The shape thread i takes of a call of the lane."""
    return small if small is not None and \
        i >= FIRST_CALL_THREADS - FIRST_CALL_SMALL else size


def first_call_inputs(torch, np):
    """The lane's inputs (seed 100, the same in every process) on the
    card, each with a readout tensor where its call fills one: {(call,
    size): (args, info or None)}."""
    from automerge_tpu_torch.ops import dominance_kernel, lexsort_kernel
    from automerge_tpu_torch.ops import linearize_kernel
    from torch_lexsort_cases import sized_forest
    from torch_step_cases import dominance_indexes_case, schedule_case
    on_card = cases_on_card(torch, np)
    rs = np.random.RandomState(100)

    def info(words):
        return torch.zeros((words,), dtype=torch.int32, device='cuda')

    def make(name, size):
        if name == 'sibling_sort':
            return (on_card(sized_forest(rs, size)),
                    info(lexsort_kernel.INFO_WORDS))
        if name == 'register_sort':
            rg = rs.randint(0, 8, size).astype(np.int32)
            rg[rs.rand(*size) < 0.2] = -1
            rt = rs.randint(0, 2 * size[1] + 1, size).astype(np.int32)
            return (on_card((rg, rt)) + [8], info(lexsort_kernel.INFO_WORDS))
        if name.startswith('linearize'):
            n_iters = int(np.ceil(np.log2(size))) + 1
            return (on_card(sized_forest(rs, size)) + [n_iters],
                    info(linearize_kernel.INFO_WORDS))
        if name.startswith('dominance'):
            return on_card(dominance_case(np, rs, *size)), None
        if name == 'schedule':
            return on_card(schedule_case(rs, *size)), None
        args = on_card(dominance_indexes_case(rs, *size))
        if name == 'route_block':
            # the docs' object starts, which the block kernel takes
            args.append(dominance_kernel.object_starts(args[0]))
        return args, None
    return {(name, size): make(name, size)
            for name, *sizes in FIRST_CALLS for size in sizes
            if size is not None}


def first_call(name, args, info):
    """One kernel wrapper's call of the lane."""
    from automerge_tpu_torch.ops import clock_kernel, dominance_kernel
    from automerge_tpu_torch.ops import lexsort_kernel, linearize_kernel
    if name == 'sibling_sort':
        return lexsort_kernel.sibling_sort_cuda(*args, info=info)
    if name == 'register_sort':
        return lexsort_kernel.register_sort_cuda(*args, info=info)
    if name.startswith('linearize'):
        return linearize_kernel.linearize_cuda(*args, info=info)
    if name.startswith('dominance'):
        return dominance_kernel.dominance_grouped_cuda(*args, chunk=64)
    if name == 'schedule':
        return clock_kernel.schedule_queue_cuda(*args)
    if name == 'route':
        return dominance_kernel.dominance_indexes_cuda(*args, chunk=128)
    return dominance_kernel.dominance_indexes_block_cuda(
        *args[:-1], chunk=64, starts=args[-1])


def first_call_plain(name, args):
    """The plain version of `first_call` (torch on the card)."""
    from automerge_tpu_torch.ops import clock, list_rank
    from automerge_tpu_torch.parallel import mesh
    if name == 'sibling_sort':
        return list_rank.sibling_sort(*args)
    if name == 'register_sort':
        return mesh.register_order(*args)
    if name.startswith('linearize'):
        return list_rank.linearize(*args)
    if name.startswith('dominance'):
        return list_rank.dominance_grouped(*args, chunk=64)
    if name == 'schedule':
        return clock.schedule_queue_batch(*args)
    if name == 'route':
        return list_rank.dominance_indexes(*args, chunk=128)
    return list_rank.dominance_indexes(*args[:-1], chunk=64, block=True)


def first_call_equal(name, args, got, want):
    """Whether a call's output is bit-equal to its plain version's (K2's
    where op_valid holds; the schedule's order and clock both)."""
    if name.startswith('dominance'):
        got, want = got[args[5]], want[args[5]]
    pairs = zip(got, want) if name == 'schedule' else [(got, want)]
    return all(g.shape == w.shape and bool((g == w).all())
               for g, w in pairs)


def first_call_readout(name, info):
    """A call's route readout without its clock stamps."""
    from automerge_tpu_torch.ops import lexsort_kernel
    from torch_linearize_cases import INFO_STAMPS
    if name in ('sibling_sort', 'register_sort'):
        ro = lexsort_kernel.readout(info)
        return {k: v for k, v in ro.items()
                if k not in ('plan_ns', 'pass_ns', 'end_ns')}
    return info.tolist()[:INFO_STAMPS]


def first_call_child(torch, np):
    """One fresh process of the first-call lane: FIRST_CALL_THREADS
    threads, each on its own CUDA stream on cuda:0, make this process's
    first calls of the kernels (FIRST_CALLS in order), a barrier
    releasing every thread into each call together, so that every
    library load, every kernel's once-per-device state and every
    shared-memory attribute is reached by several threads at once (at
    two shapes where a call has a smaller one).  After every thread has
    joined, each output is held bit-equal to its plain version and K2's
    shapes to their routes (long, short).  Prints one JSON line,
    {'readouts': [per thread {call: readout}], 'mismatches', 'wall_s',
    'stages_s'}; returns 0 when every output is equal.  Every thread of
    a shape takes the same inputs, so the plain versions run once a
    shape and every thread's readouts must agree."""
    from automerge_tpu_torch.ops import _build, dominance_kernel
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    t_ready = time.perf_counter()
    shared = first_call_inputs(torch, np)
    inputs = [{key: (args, None if info is None else torch.zeros_like(info))
               for key, (args, info) in shared.items()}
              for _ in range(FIRST_CALL_THREADS)]
    streams = [torch.cuda.Stream(dev) for _ in range(FIRST_CALL_THREADS)]
    torch.cuda.synchronize()
    barrier = threading.Barrier(FIRST_CALL_THREADS, timeout=60)
    outs = [{} for _ in range(FIRST_CALL_THREADS)]
    errors = []

    def work(i):
        try:
            with torch.cuda.stream(streams[i]):
                for name, size, small in FIRST_CALLS:
                    key = (name, first_call_size(i, size, small))
                    barrier.wait()
                    outs[i][name] = first_call(name, *inputs[i][key])
        except Exception as e:
            errors.append('thread %d: %s: %s' % (i, type(e).__name__, e))
            barrier.abort()
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(FIRST_CALL_THREADS)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    t_check = time.perf_counter()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError('first calls: %s, threads alive %s' % (
            errors, [th.is_alive() for th in threads]))
    mismatches, readouts = [], []
    plain = {key: first_call_plain(key[0], args)
             for key, (args, _) in shared.items()}
    for i in range(FIRST_CALL_THREADS):
        readouts.append({})
        for name, size, small in FIRST_CALLS:
            key = (name, first_call_size(i, size, small))
            args, info = inputs[i][key]
            if not first_call_equal(name, args, outs[i][name], plain[key]):
                mismatches.append('thread %d %s %s' % (i, name, key[1]))
            if info is not None:
                readouts[i][name] = first_call_readout(name, info)
    lib = _build.kernel('dominance')
    for name, size in shared:
        if not name.startswith('dominance'):
            continue
        long_route = dominance_kernel.scratch_for(lib, *size, 64,
                                                  dev) is not None
        if long_route != (name == 'dominance_long'):
            mismatches.append('%s %s: the %s route' % (
                name, size, 'long' if long_route else 'short'))
    print(json.dumps({'readouts': readouts, 'mismatches': mismatches,
                      'wall_s': wall, 'stages_s': {
                          'start': t_ready - T_START,
                          'inputs': t - t_ready,
                          'check': time.perf_counter() - t_check}}),
          flush=True)
    return 1 if mismatches else 0


def first_call_mesh_child(torch):
    """The lane's mesh process: a MeshDocPool(FIRST_CALL_DP), its chip
    threads all on cuda:0, takes config 3's first FIRST_CALL_DOCS docs
    as this process's first batch, so that its threads make the first
    kernel calls; every doc's patch bytes must equal a CPU pool's.
    Prints one JSON line ({'docs', 'launches', 'wall_s'}); returns 0 when
    every doc is equal and K1, K2 and the linearize kernel launched."""
    import msgpack

    from automerge_tpu_torch import trace, workloads
    from automerge_tpu_torch.native import NativeDocPool
    from automerge_tpu_torch.native.mesh_pool import MeshDocPool
    t_ready = time.perf_counter()
    batch = workloads.build_config_3(random.Random(7),
                                     n_docs=FIRST_CALL_DOCS)
    payload = msgpack.packb({str(k): v for k, v in batch.items()},
                            use_bin_type=True)
    trace.reset()
    t = time.perf_counter()
    got = MeshDocPool(FIRST_CALL_DP).apply_batch_bytes(payload)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    metrics = trace.snapshot()['metrics']
    launches = {k: int(v) for k, v in metrics.items()
                if k.startswith('launch.')}
    want = patch_slices(NativeDocPool(device='cpu').apply_batch_bytes(
        payload))
    got = patch_slices(got)
    differ = sorted(k for k in want if got.get(k) != want[k])
    print(json.dumps({'docs': len(got), 'differ': differ[:8],
                      'launches': launches, 'wall_s': wall,
                      'start_s': t_ready - T_START,
                      'end_s': time.perf_counter() - T_START}), flush=True)
    missing = [k for k in ('launch.registers', 'launch.dominance',
                           'launch.linearize') if not launches.get(k)]
    return 1 if differ or len(got) != len(want) or missing else 0


def _child(kind):
    """A fresh process of this script in lane mode `kind`."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--first-call-child',
         kind], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _reap(kind, proc):
    """A child's JSON line; fails with its exit status and stderr when it
    died by a signal, exited nonzero or printed no result."""
    try:
        out, err = proc.communicate(timeout=FIRST_CALL_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    rc = proc.returncode
    lines = out.decode(errors='replace').strip().splitlines()
    if rc != 0 or not lines:
        why = 'signal %d' % -rc if rc < 0 else 'exit %d' % rc
        raise AssertionError('first-call lane: %s child died (%s):\n%s\n%s'
                             % (kind, why, '\n'.join(lines[-5:]),
                                err.decode(errors='replace')[-4000:]))
    return json.loads(lines[-1])


def first_call_lane(card):
    """The first-call lane: FIRST_CALL_PROCS fresh processes of
    `first_call_child`, FIRST_CALL_AT_ONCE at a time, beside one of
    `first_call_mesh_child`.  The per-device state and the library caches
    are per process, so only a fresh process's first calls can race.
    Every child must exit 0 (a signal or an unequal output fails the
    lane), every thread's route readouts must be equal in every process
    (same inputs), and the routes the lane aims at must be the ones
    taken: the sibling sort on the grid, linearize's 16,384 rows on
    route (b) and 4,096 on route (a)."""
    from torch_linearize_cases import INFO_GRID, INFO_ROUTE, ROUTE_TOUR
    t0 = time.perf_counter()
    mesh = _child('mesh')
    try:
        # FIRST_CALL_AT_ONCE slots, each refilled as soon as its child ends
        with concurrent.futures.ThreadPoolExecutor(FIRST_CALL_AT_ONCE) as ex:
            results = list(ex.map(
                lambda _: _reap('threads', _child('threads')),
                range(FIRST_CALL_PROCS)))
        mesh_out = _reap('mesh', mesh)
    finally:
        if mesh.poll() is None:
            mesh.kill()
            mesh.communicate()
    wall = time.perf_counter() - t0
    first = results[0]['readouts']
    for n, r in enumerate(results):
        if any(ro != first[0] for ro in r['readouts']):
            raise AssertionError('first-call lane: process %d\'s route '
                                 'readouts differ from its first thread\'s '
                                 'or process 0\'s:\n%s\n%s'
                                 % (n, r['readouts'], first[0]))
    ro = first[0]
    if ro['sibling_sort']['route'] != 'grid' or \
            ro['linearize_b'][INFO_GRID] != 1 or \
            ro['linearize_a'][INFO_GRID] != 0 or \
            ro['linearize_b'][INFO_ROUTE] != ROUTE_TOUR:
        raise AssertionError('first-call lane: routes %s' % ro)
    log('first-call lane: %d fresh processes x %d threads (%d at a time) '
        'and one MeshDocPool(%d) process, every child exit 0, every output '
        'bit-equal to its plain version, every route readout equal (the '
        'sibling sort on the grid, the register order on the %s route, '
        'linearize on routes b and a), K2 long and short, the schedule, '
        'the route and the block kernel at two shapes each (%d threads at '
        'the smaller); threads\' walls %s s, each child\'s '
        'start-up, inputs and checks %s s; mesh: %d docs equal to a CPU '
        'pool\'s, first batch %.3f s (start-up %.2f s, %.2f s in all), '
        'launches %s; lane %.1f s wall on %s' % (
            FIRST_CALL_PROCS, FIRST_CALL_THREADS, FIRST_CALL_AT_ONCE,
            FIRST_CALL_DP, ro['register_sort']['route'], FIRST_CALL_SMALL,
            [round(r['wall_s'], 3) for r in results],
            [[round(r['stages_s'][k], 2) for k in ('start', 'inputs', 'check')]
             for r in results], mesh_out['docs'],
            mesh_out['wall_s'], mesh_out['start_s'], mesh_out['end_s'],
            mesh_out['launches'], wall, card))


def dominance_past_grid_y(torch, np, card, rs):
    """K2's long route at WIDE_DOMINANCE's 65,537 objects (past the grid's
    y limit of 65,535, so the launch goes in two slices): 8 seeded
    objects tiled over them, the kernel's output bit-equal to the plain
    version of those 8 objects repeated (where op_valid holds; a plain
    call at the full count would not fit); then the kernel's time."""
    from automerge_tpu_torch.ops import _build, dominance_kernel, list_rank
    O, L, T, n = WIDE_DOMINANCE
    case = cases_on_card(torch, np)(dominance_case(np, rs, n, L, T))
    reps = -(-O // n)
    wide = [x.repeat(reps, 1)[:O] for x in case]
    if dominance_kernel.scratch_for(_build.kernel('dominance'), O, L, T, 64,
                                    wide[0].device) is None:
        raise AssertionError('dominance O=%d L=%d T=%d: not the long route'
                             % (O, L, T))
    got = dominance_kernel.dominance_grouped_cuda(*wide, chunk=64)
    want = list_rank.dominance_grouped(*case, chunk=64).repeat(reps, 1)[:O]
    ov = wide[5]
    bad = int((got[ov] != want[ov]).sum())
    if bad:
        raise AssertionError('dominance O=%d L=%d T=%d (tiled): %d '
                             'mismatches' % (O, L, T, bad))
    del got, want
    ms = device_ms(torch, lambda: dominance_kernel.dominance_grouped_cuda(
        *wide, chunk=64), reps=3, rounds=3)
    bound, by = dominance_bound(wide, 64)
    gb = sum(x.numel() * x.element_size() for x in wide) / 1e9
    log('dominance O=%d L=%d T=%d (long route in two slices, %d seeded '
        'objects tiled, %.2f GB of inputs): bit-equal to the plain version '
        'of the %d objects repeated; kernel %.4f ms, bound %.3g ms (%s), x '
        'bound %.1f on %s' % (O, L, T, n, gb, n, ms, bound, by, ms / bound,
                              card))


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the member kernel's random and edge-case inputs, shared with the
    # CPU tests
    sys.path.insert(1, os.path.join(ROOT, 'tests'))
    # the step-timing loops (`tools/step_ab.py`), shared with the A/B tool
    sys.path.append(os.path.join(ROOT, 'tools'))
    try:
        import automerge_tpu_torch  # noqa: F401
    except ImportError:
        print('chip_smoke: run from a checkout holding automerge_tpu_torch/',
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ['--first-call-child']:
        # a fresh process of the first-call lane (first_call_lane)
        import numpy as np
        return first_call_child(torch, np) if sys.argv[2:] == ['threads'] \
            else first_call_mesh_child(torch)
    try:
        kernels = run(torch)
    except Exception:
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1
    log('chip_smoke: %.1f s wall' % (time.perf_counter() - t_start))
    log(json.dumps({'kernels': kernels}))
    log(card_line())
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def run(torch):
    import msgpack
    import numpy as np

    from automerge_tpu_torch import native, storage, telemetry, trace
    from automerge_tpu_torch import workloads
    from automerge_tpu_torch.native import NativeDocPool, _lib
    from automerge_tpu_torch.ops import _build, dominance_kernel, list_rank
    from automerge_tpu_torch.ops import clock_kernel, linearize_kernel
    from automerge_tpu_torch.ops import lexsort_kernel, members_kernel
    from automerge_tpu_torch.ops import registers as R
    from automerge_tpu_torch.ops import registers_kernel

    card = card_line()
    log('card: %s | torch %s cuda %s' % (card, torch.__version__,
                                          torch.version.cuda))
    dev = torch.device('cuda')

    # -- build: the C++ runtime and one nvcc per kernel, all at once -----
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        core = ex.submit(_lib.build)
        kern = ex.submit(_build.build_all)
        core_path, kern_paths = core.result(), kern.result()
    log('build: %.1f s (%s, %s) on %s' % (
        time.perf_counter() - t0, os.path.basename(core_path),
        ', '.join(os.path.basename(p) for p in kern_paths.values()), card))

    # -- phase 0: the first-call lane, in fresh processes ----------------
    first_call_lane(card)

    # -- capture the kernels' main-path inputs (largest call of each) ----
    captured = {'registers': [], 'dominance': [], 'members': [],
                'schedule': [], 'indexes': [], 'block': [], 'linearize': [],
                'sibling_sort': [], 'register_sort': []}
    # captured calls by the thread that made them (the fleet phase tells
    # a read replica's pool from its upstream gateway's in one process)
    by_thread = {}
    originals = []
    current = {'path': 'warm-up'}

    def capture(mod, name, key):
        orig = getattr(mod, name)
        originals.append((mod, name, orig))

        def wrapper(*args, **kw):
            if current['path'] is not None:
                name = threading.current_thread().name
                by_thread.setdefault(key, {})[name] = \
                    by_thread.get(key, {}).get(name, 0) + 1
                captured[key].append((current['path'], [
                    a.clone() if torch.is_tensor(a) else a for a in args],
                    {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in kw.items()}))
            return orig(*args, **kw)
        setattr(mod, name, wrapper)

    capture(registers_kernel, 'resolve_registers_cuda', 'registers')
    capture(dominance_kernel, 'dominance_grouped_cuda', 'dominance')
    capture(members_kernel, 'resolve_registers_members_cuda', 'members')
    capture(clock_kernel, 'schedule_queue_cuda', 'schedule')
    capture(dominance_kernel, 'dominance_indexes_cuda', 'indexes')
    capture(dominance_kernel, 'dominance_indexes_block_cuda', 'block')
    capture(linearize_kernel, 'linearize_cuda', 'linearize')
    capture(lexsort_kernel, 'sibling_sort_cuda', 'sibling_sort')
    capture(lexsort_kernel, 'register_sort_cuda', 'register_sort')

    K1, K2 = registers_kernel.LAUNCH_METRIC, dominance_kernel.LAUNCH_METRIC
    K3 = members_kernel.LAUNCH_METRIC
    KS, KI = clock_kernel.LAUNCH_METRIC, dominance_kernel.INDEXES_METRIC
    KB, KL = dominance_kernel.BLOCK_METRIC, linearize_kernel.LAUNCH_METRIC
    KX = lexsort_kernel.LAUNCH_METRIC
    launches = {K1: 0, K2: 0, K3: 0, KS: 0, KI: 0, KB: 0, KL: 0, KX: 0}
    by_path = {k: {} for k in launches}

    def drive(label, fn, need, oracle=0, waves=0, phases=False):
        """Runs one main path with the counts zeroed just before and read
        just after; fails if a kernel it needs never launched, if the
        C++ oracle resolved other than `oracle` register rows or if the
        payload went through other than `waves` waves (0: unsplit; None:
        not checked).  With `phases`, span tracing is on for the path and
        its metrics hold the phase counters (PHASE_COUNTERS) too.  A path
        that needs a list kernel (K2, the whole-doc or the block route)
        needs the linearize kernel too: every list index is a count over
        its ranks.  A path that runs the step (the schedule kernel) or
        takes the resident route needs the lexsort kernel too: both sort
        on the card.  Returns (result, wall s, metrics)."""
        if set(need) & {K2, KI, KB}:
            need = tuple(need) + (KL,)
        torch.cuda.synchronize()
        current['path'] = label
        trace.reset()
        was_on = telemetry.enabled()
        if phases:
            telemetry.phase_reset()
            telemetry.enable()
        try:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            if phases and not was_on:
                telemetry.disable()
        current['path'] = None
        snap = trace.snapshot()
        m = dict(snap['spans'], **snap['metrics'])
        if phases:
            m.update(counts_of(trace, telemetry))
        got = {k: int(m.get(k, 0)) for k in launches}
        if KS in need or m.get('resident.dispatches', 0):
            need = tuple(need) + (KX,)
        for k in need:
            if got[k] == 0:
                raise AssertionError('%s: kernel %s never launched' %
                                     (label, k))
        if m.get('fallback.oracle', 0) != oracle:
            raise AssertionError('%s: %d register rows took the C++ oracle, '
                                 'expected %d' % (
                                     label, m.get('fallback.oracle', 0),
                                     oracle))
        if waves is not None and m.get('pipeline.waves', 0) != waves:
            raise AssertionError('%s: %d waves, expected %d' % (
                label, m.get('pipeline.waves', 0), waves))
        for k in got:
            launches[k] += got[k]
            by_path[k][label] = got[k]
        log('%s: %.3f s wall, launches %s, spans %s, waves %s on %s' % (
            label, wall, got, {k: round(v, 4)
                               for k, v in sorted(snap['spans'].items())},
            {k: m[k] for k in ('pipeline.waves', 'collect.overlap_s',
                               'collect.ready_reorder',
                               'collect.wait_in_order') if k in m}, card))
        return out, wall, m

    def packed(batch):
        return msgpack.packb({str(k): v for k, v in batch.items()},
                             use_bin_type=True)

    # warm-up: CUDA context, kernel modules, allocator (separate pools)
    NativeDocPool().apply_batch_bytes(packed(workloads.build_config_3(
        random.Random(1), n_docs=64)))
    NativeDocPool().apply_batch_bytes(packed(workloads.build_config_5(
        random.Random(1), n_docs=1, n_changes=2)))
    torch.cuda.synchronize()
    for calls in captured.values():
        calls.clear()

    # -- phase 1: config 3, the headline catch-up batch ------------------
    batch3 = workloads.build_config_3(random.Random(7))
    n_ops3 = workloads.op_count(batch3)
    payload3 = msgpack.packb({str(k): v for k, v in batch3.items()},
                             use_bin_type=True)
    pool3 = NativeDocPool()
    # whether each wave's device work had finished when the next wave's
    # dispatch began (after its C++ begin): only unfinished work can hold
    # up the next wave's synchronous pageable uploads
    events, done_at_next = [], []
    phase_a = NativeDocPool._phase_a

    def phase_a_spy(self, bh, *rest):
        done_at_next.extend(e.query() for e in events[-1:])
        ctx = phase_a(self, bh, *rest)
        events.append(ctx['event'])
        return ctx
    NativeDocPool._phase_a = phase_a_spy
    try:
        out_gpu, wall3, _ = drive('config3 gpu', lambda: pool3
                                  .apply_batch_bytes(payload3),
                                  need=(K1, K2), waves=2)
    finally:
        NativeDocPool._phase_a = phase_a
    log('config3: wave 0 device work finished before wave 1 dispatched: %s '
        'on %s' % (done_at_next, card))
    cpu3 = NativeDocPool(device='cpu')
    t = time.perf_counter()
    out_cpu = cpu3.apply_batch_bytes(payload3)
    log('config3 cpu (plain versions): %.3f s (host CPU, beside %s)'
        % (time.perf_counter() - t, card))
    if out_gpu != out_cpu:
        raise AssertionError('config3: GPU and CPU patch bytes differ')
    patches = msgpack.unpackb(out_gpu, raw=False)
    if len(patches) != len(batch3) or any(
            len(p['clock']) != workloads.N_ACTORS or not p['diffs']
            for p in patches.values()):
        raise AssertionError('config3: malformed patches')
    log('config3: %d docs, %d ops, patch bytes equal (%d B); %.0f ops/s on '
        '%s' % (len(patches), n_ops3, len(out_gpu), n_ops3 / wall3, card))
    native.PIPELINE_DEPTH = 1
    try:
        pool3u = NativeDocPool()
        out_u, wall3u, _ = drive('config3 gpu depth 1', lambda: pool3u
                                 .apply_batch_bytes(payload3), need=(K1, K2))
    finally:
        native.PIPELINE_DEPTH = 2
    if patch_slices(out_u) != patch_slices(out_gpu):
        raise AssertionError('config3: depth 1 and depth 2 patches differ')
    log('config3: per-doc patches of depth 1 equal depth 2; wall %.3f s '
        'at depth 2, %.3f s at depth 1 on %s' % (wall3, wall3u, card))

    # -- phase 2: config 4, the map-only batch ---------------------------
    batch4 = workloads.build_config_4(random.Random(7))
    n_ops4 = workloads.op_count(batch4)
    payload4 = msgpack.packb({str(k): v for k, v in batch4.items()},
                             use_bin_type=True)
    pool4 = NativeDocPool()
    out_gpu4, wall4, _ = drive('config4 gpu', lambda: pool4.apply_batch_bytes(
        payload4), need=(K1,), waves=2)
    if out_gpu4 != NativeDocPool(device='cpu').apply_batch_bytes(payload4):
        raise AssertionError('config4: GPU and CPU patch bytes differ')
    log('config4: %d docs, %d ops, patch bytes equal; %.0f ops/s on %s'
        % (len(batch4), n_ops4, n_ops4 / wall4, card))

    # -- phase 3: carry-across (v1 checkpoints, CPU pool -> GPU pool) -----
    docs = [str(d) for d in range(512)]
    native.STORAGE_FORMAT = 'json'
    try:
        blobs = {d: cpu3.save(d) for d in docs}
    finally:
        native.STORAGE_FORMAT = 'columnar'
    pool_l = NativeDocPool()
    native.STORAGE_NATIVE = False
    try:
        _, wall_l, _ = drive('load gpu', lambda: pool_l.load_batch(blobs),
                             need=(K1, K2), waves=2)
    finally:
        native.STORAGE_NATIVE = True
    for d in docs:
        if pool_l.get_patch(d) != cpu3.get_patch(d):
            raise AssertionError('load: doc %s patch differs' % d)
    log('load: %d v1 checkpoints replayed, patches equal' % len(docs))
    blobs2 = {}
    for d in docs:
        blobs2[d] = pool3.save(d)
        if not blobs2[d].startswith(storage.CKPT_V2_PREFIX) or \
                blobs2[d] != cpu3.save(d):
            raise AssertionError('v2 save: doc %s differs from the CPU '
                                 'pool\'s' % d)
    pool_v2 = NativeDocPool()
    native.STORAGE_NATIVE = False
    try:
        _, wall_v2, _ = drive('load v2 gpu', lambda: pool_v2.load_batch(
            blobs2), need=(K1, K2), waves=2)
    finally:
        native.STORAGE_NATIVE = True
    for d in docs:
        if pool_v2.get_patch(d) != cpu3.get_patch(d):
            raise AssertionError('load v2: doc %s patch differs' % d)
    log('v2: %d checkpoints saved on the card equal to the CPU pool\'s '
        '(%d B), replayed in one batch, patches equal on %s'
        % (len(docs), sum(map(len, blobs2.values())), card))
    for label, blobs_x, replayed, wall_r in (
            ('load direct gpu', blobs, pool_l, wall_l),
            ('load v2 direct gpu', blobs2, pool_v2, wall_v2)):
        pool_d = NativeDocPool()
        _, wall_d, m_d = drive(label, lambda p=pool_d, b=blobs_x:
                               p.load_batch(b), need=())
        arms_equal(np, label, pool_d, replayed, docs)
        log('%s: %d checkpoints arena-direct in %.4f s against %.4f s '
            'replayed (two waves, K1 + K2); patches, clocks and doc_stats '
            'equal to the replay arm\'s; cxx %s on %s' % (
                label, len(docs), wall_d, wall_r,
                {k: round(m_d.get(k, 0.0), 4) for k in CXX_SPANS}, card))
    hostile_staging(torch, np, card, workloads, NativeDocPool, R, packed)

    # -- phase 4: config 5, the 64-replica catch-up backlog --------------
    batch5 = workloads.build_config_5(random.Random(7))
    n_ops5 = workloads.op_count(batch5)
    payload5 = packed(batch5)
    pool5 = NativeDocPool()
    out_gpu5, wall5, m5 = drive('config5 gpu', lambda: pool5
                                .apply_batch_bytes(payload5), need=(K3,))
    if m5.get(K3, 0) < 2 or not any(k.startswith('fallback.escalated.w')
                                    for k in m5):
        raise AssertionError('config5: K3 ran %d times, tiers %s'
                             % (m5.get(K3, 0), m5))
    t = time.perf_counter()
    out_cpu5 = NativeDocPool(device='cpu').apply_batch_bytes(payload5)
    log('config5 cpu (plain versions): %.3f s (host CPU, beside %s)'
        % (time.perf_counter() - t, card))
    if out_gpu5 != out_cpu5:
        raise AssertionError('config5: GPU and CPU patch bytes differ')
    patches = msgpack.unpackb(out_gpu5, raw=False)
    if len(patches) != len(batch5) or any(
            len(p['clock']) != 64 or not p['diffs'] for p in patches.values()):
        raise AssertionError('config5: malformed patches')
    log('config5: %d docs, %d ops, patch bytes equal (%d B); %d K3 launches, '
        'tiers %s; %.0f ops/s on %s' % (
            len(patches), n_ops5, len(out_gpu5), m5[K3],
            {k: v for k, v in sorted(m5.items())
             if k.startswith('fallback.')}, n_ops5 / wall5, card))

    # -- phase 5: config 5 as the bench runs it, 64 replica pools --------
    replica_phase(torch, card, workloads, drive, K1, K3, pool5)

    # -- phase 6: configs 3 and 4 as bench.py runs them, sharded ---------
    sharded_phase(card, workloads, drive, K1, K2, {
        'config3': (payload3, n_ops3, out_gpu, wall3),
        'config4': (payload4, n_ops4, out_gpu4, wall4)})

    # -- phase 7: faults on the card -------------------------------------
    fault_phase(card, drive, K1, K2, K3, workloads)

    # -- phase 8: the cold start (50,000 docs) ---------------------------
    coldstart_phase(torch, card, workloads, native, drive, K1, K2)

    # -- phase 9: one hot key beside a list, three widths ----------------
    for n_writers, tier, oracle in ((40, 64, 0), (200, 256, 0),
                                    (300, None, 300)):
        payloads = [packed(b) for b in workloads.hot_key_batch(n_writers)]
        pool_h = NativeDocPool()
        outs, _, mh = drive('hot key %d gpu' % n_writers, lambda: [
            pool_h.apply_batch_bytes(p) for p in payloads], need=(K2, K3),
            oracle=oracle)
        tiers = {k: v for k, v in mh.items()
                 if k.startswith('fallback.escalated.w')}
        want = {} if tier is None else {'fallback.escalated.w%d' % tier:
                                        n_writers}
        if tiers != want:
            raise AssertionError('hot key %d: tiers %s, expected %s'
                                 % (n_writers, tiers, want))
        cpu_h = NativeDocPool(device='cpu')
        if outs != [cpu_h.apply_batch_bytes(p) for p in payloads]:
            raise AssertionError('hot key %d: GPU and CPU patch bytes '
                                 'differ' % n_writers)
        log('hot key %d writers: tiers %s, oracle rows %d, patch bytes '
            'equal' % (n_writers, tiers, oracle))

    # -- phase 10: the long document, resident route and route off -----
    resident = resident_phase(torch, card, workloads, native, NativeDocPool,
                              R, drive, K1, K2)
    sort_launches = lexsort_launch_counts(torch, np, card)

    # -- phase 12: the port's server on the card (before the checks of
    # phase 11, which hold its kernel calls against the plain versions) --
    serving_phase(card, workloads, drive, K1, K2, K3)

    # -- phase 13: the fleet over card replicas (before the checks of
    # phase 11, which hold its in-process kernel calls too) -------------
    def note_remote(label, counts):
        """A replica server's launches on a driven path (read over its
        socket as the difference across the path) join the kernel
        line's counts."""
        for k in (K1, K2, K3, KL, KX):
            n = int(counts.get(k, 0))
            launches[k] += n
            if n:
                by_path[k][label] = n

    def capture_as(label, fn):
        """fn() with its kernel calls captured for phase 11 under
        `label`; they count toward no path's launches."""
        torch.cuda.synchronize()
        current['path'] = label
        try:
            return fn()
        finally:
            torch.cuda.synchronize()
            current['path'] = None
    fleet_phase(card, workloads, drive, K1, K2, K3, batch3,
                patch_slices(out_gpu), note_remote, capture_as, by_thread)

    # -- phase 14: the batched engine and the single-device step (before
    # the checks of phase 11, which hold their kernel calls too) ---------
    engine_phase(torch, card, workloads, drive, K1, K2, K3, KS, KI,
                 batch3, out_gpu, pool3, packed)

    # -- phase 15: port frontends over the card (before the checks of
    # phase 11, which hold their kernel calls too) ----------------------
    frontend_phase(card, drive, K1, K2, K3, note_remote)

    # -- phase 16: the multi-device path, every cell on cuda:0 (before
    # the checks of phase 11, which hold its kernel calls too) ----------
    mesh_report = mesh_phase(torch, card, workloads, drive, K1, K2, KS, KB,
                             payload3, out_gpu)

    # -- phase 17: the static gate and the alias sanitizer (before the
    # checks of phase 11, which hold its kernel calls too) --------------
    analysis_phase(torch, card, drive, K1, packed)

    # -- phase 11: kernels against their plain versions on the card ------
    for mod, name, orig in originals:
        setattr(mod, name, orig)
    # of the long-document paths, the largest call of each kernel and the
    # last (a keystroke); of the route-off paths the keystroke only (their
    # build batch is the resident path's, input for input)
    for key, size_of in (('registers', lambda c: c[1][0].numel()),
                         ('dominance', lambda c: c[1][0].numel()
                          * c[1][2].numel())):
        kept, long_doc = [], {}
        for c in captured[key]:
            if c[0].startswith('resident'):
                long_doc.setdefault(c[0], []).append(c)
            else:
                kept.append(c)
        for path, calls in long_doc.items():
            big = max(calls, key=size_of)
            if not path.startswith('resident off'):
                kept.append(big)
            if calls[-1] is not big:
                kept.append((path + ' keystroke',) + tuple(calls[-1][1:]))
        captured[key] = kept
        # a path held largest call first has that call timed
        calls = [c for c in captured[key] if c[0] == LARGEST_FIRST]
        rest = [c for c in captured[key] if c[0] != LARGEST_FIRST]
        captured[key] = sorted(calls, key=size_of, reverse=True) + rest
    rows = {}
    keystroke = {}
    err1, err2 = kernel_cases(torch, np, card)
    err3 = member_cases(torch, np, card)
    t_cases = time.perf_counter()
    err_s, err_i = step_cases(torch, np, card)
    err_b = block_cases(torch, np, card)
    err_l, lin_edges = linearize_cases(torch, np, card)
    t_sort = time.perf_counter()
    err_x, sort_edges = lexsort_cases(torch, np, card)
    log('lexsort edge cases and four-stream lane: %.1f s'
        % (time.perf_counter() - t_sort))
    log('schedule, route, block, linearize and lexsort seeded and edge '
        'cases: %.1f s' % (time.perf_counter() - t_cases))

    # at the main paths' own inputs (every call of the driven paths,
    # each held bit-equal): kernel, wrapper and plain times of the first
    # call of each path (`paths`).  A row's `launches` sums the driven
    # paths (`launches_by_path` splits it); its times and shape are
    # those of the largest timed call, made on `timed_path`
    path_rows = {'registers': {}, 'dominance': {}}
    untimed_calls = {'registers': 0, 'dominance': 0}
    for path, args, kw in captured['registers']:
        window = kw.get('window', R.WINDOW)
        T = args[0].numel()
        timed = path not in path_rows['registers']
        e, ms = check_registers(torch, card, 'main path T=%d W=%d'
                                % (T, window), args, window, timed=timed)
        err1 = max(err1, e)
        if not timed:
            untimed_calls['registers'] += 1
            continue
        wrapper_ms = device_ms(torch, lambda: registers_kernel
                               .resolve_registers_cuda(*args, window=window))
        plain_ms = device_ms(torch, lambda: R.resolve_registers(
            *args, window=window), reps=3, rounds=3)
        bound, by = registers_bound(torch, args, window)
        log('registers %s T=%d W=%d: kernel %.4f ms, wrapper %.4f ms, '
            'plain %.4f ms, bound %.3g ms (%s) on %s' % (
                path, T, window, ms, wrapper_ms, plain_ms, bound, by, card))
        path_rows['registers'][path] = {
            'shape': 'T=%d W=%d' % (T, window), 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by}
        if path.startswith('resident'):
            if not path.startswith('resident off'):
                keystroke.setdefault(K1, {})[path] = {
                    'shape': 'T=%d W=%d' % (T, window), 'ms': ms,
                    'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by}
        elif 'registers' not in rows or T * window > rows['registers'][0]:
            rows['registers'] = (T * window, {
                'name': 'registers', 'route': 'cuda',
                'source': 'automerge_tpu_torch/csrc/registers.cu',
                'replaces': 'automerge_tpu/ops/pallas_registers.py:48',
                'launches': launches[K1], 'launches_by_path': by_path[K1],
                'timed_path': path, 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': bound, 'bound_by': by, 'library_ms': None,
                'wrapper_ms': wrapper_ms, 'shape': 'T=%d W=%d A=%d' % (
                    T, window, args[6].shape[1])})

    for path, args, kw in captured['dominance']:
        chunk = kw.get('chunk', 64)
        O, L = args[0].shape
        T = args[2].shape[1]
        timed = path not in path_rows['dominance']
        e, ms = check_dominance(torch, card, 'main path O=%d L=%d T=%d'
                                % (O, L, T), args, chunk, timed=timed)
        err2 = max(err2, e)
        if not timed:
            untimed_calls['dominance'] += 1
            continue
        wrapper_ms = device_ms(torch, lambda: dominance_kernel
                               .dominance_grouped_cuda(*args, chunk=chunk))
        plain_ms = device_ms(torch, lambda: list_rank.dominance_grouped(
            *args, chunk=chunk), reps=3, rounds=3)
        bound, by = dominance_bound(args, chunk)
        log('dominance %s O=%d L=%d T=%d: kernel %.4f ms, wrapper '
            '%.4f ms, plain %.4f ms, bound %.3g ms (%s) on %s' % (
                path, O, L, T, ms, wrapper_ms, plain_ms, bound, by, card))
        path_rows['dominance'][path] = {
            'shape': 'O=%d L=%d T=%d' % (O, L, T), 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by}
        if path.startswith('resident'):
            if not path.startswith('resident off'):
                keystroke.setdefault(K2, {})[path] = {
                    'shape': 'O=%d L=%d T=%d' % (O, L, T), 'ms': ms,
                    'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by}
        elif 'dominance' not in rows or O * L * T > rows['dominance'][0]:
            rows['dominance'] = (O * L * T, {
                'name': 'dominance', 'route': 'cuda',
                'source': 'automerge_tpu_torch/csrc/dominance.cu',
                'replaces': 'automerge_tpu/ops/pallas_dominance.py:42',
                'launches': launches[K2], 'launches_by_path': by_path[K2],
                'timed_path': path, 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': bound, 'bound_by': by, 'library_ms': None,
                'wrapper_ms': wrapper_ms,
                'shape': 'O=%d L=%d T=%d chunk=%d' % (O, L, T, chunk)})
    path_ms = {}
    base_passes = {}
    untimed = 0
    for path, args, kw in captured['members']:
        window = kw.get('window', R.WINDOW)
        want_vb = kw.get('want_visible_before', True)
        T = args[0].numel()
        # of the catch-up, the first receiver's calls (its base pass and
        # the tier chunks after it) are timed; every call is checked
        if window == R.WINDOW:
            base_passes[path] = base_passes.get(path, 0) + 1
        timed = path not in FIRST_BATCH_TIMED or \
            base_passes.get(path, 0) <= 1
        e, ms, bound, by = check_members(
            torch, card, 'main path %s T=%d W=%d' % (path, T, window), args,
            window, want_vb, timed=timed)
        err3 = max(err3, e)
        if not timed:
            untimed += 1
            continue
        wrapper_ms = device_ms(torch, lambda: members_kernel
                               .resolve_registers_members_cuda(
                                   *args, window=window,
                                   want_visible_before=want_vb))
        plain_ms = device_ms(torch, lambda: R.resolve_registers_members(
            *args, window=window, want_visible_before=want_vb),
            reps=2, rounds=3)
        log('members %s T=%d W=%d: kernel %.4f ms, wrapper %.4f ms, plain '
            '%.4f ms, bound %.3g ms (%s) on %s' % (
                path, T, window, ms, wrapper_ms, plain_ms, bound, by, card))
        tot = path_ms.setdefault(path, [0.0, 0.0, 0.0])
        tot[0] += ms
        tot[1] += bound
        tot[2] += plain_ms
        pairs = T * (window + 1) ** 2
        if 'members' not in rows or pairs > rows['members'][0]:
            rows['members'] = (pairs, {
                'name': 'members', 'route': 'cuda',
                'source': 'automerge_tpu_torch/csrc/members.cu',
                'replaces': 'automerge_tpu/ops/registers.py:126 (XLA, no '
                            'Pallas kernel)',
                'launches': launches[K3], 'launches_by_path': by_path[K3],
                'timed_path': path, 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': bound, 'bound_by': by, 'library_ms': None,
                'wrapper_ms': wrapper_ms, 'shape': 'T=%d W=%d A=%d' % (
                    T, window, args[5].shape[1])})
    for path, (ms, bound, plain_ms) in sorted(path_ms.items()):
        log('members %s, all timed calls: kernel %.4f ms, bound %.3g ms, '
            'plain %.4f ms on %s' % (path, ms, bound, plain_ms, card))
    log('members %s: %d calls of %d receivers bit-equal to the plain '
        'version, the first receiver\'s timed above, on %s' % (
            CATCH_UP, sum(1 for c in captured['members']
                          if c[0] == CATCH_UP),
            base_passes.get(CATCH_UP, 0), card))
    rows['members'][1]['path_ms'] = {p: v[0] for p, v in path_ms.items()}
    for name in ('registers', 'dominance'):
        rows[name][1]['paths'] = path_rows[name]
        log('%s: %d more calls of the driven paths bit-equal to the plain '
            'version, untimed, on %s' % (name, untimed_calls[name], card))
    # the resident route's calls: per size, launches per step of the
    # stream (every step launches K1; K2 where it has list work)
    for name, k in (('registers', K1), ('dominance', K2)):
        rows[name][1]['resident'] = keystroke.get(k, {})
        rows[name][1]['resident_launches_per_step'] = {
            size: by_path[k].get('resident %d gpu' % size, 0)
            / resident[size]['steps'] for size in resident}
    # the schedule kernel and the whole-doc dominance route at the step's
    # inputs (phase 14's lanes (c) and (d)): every call held bit-equal
    # (every doc of the route's calls on the fast branch), the first call
    # of each path timed beside its plain version; `ms` is back-to-back
    # wrapper calls (as for these two since they were ported), `graph_ms`
    # the kernels' device time alone (a CUDA graph of the launches)
    t_step_kernels = time.perf_counter()
    for key, name, check, size_of, shape_of, source, replaces, err in (
            ('schedule', 'schedule', check_schedule,
             lambda a: a[3].numel(),
             lambda a: 'D=%d C=%d A=%d' % tuple(a[3].shape),
             'automerge_tpu_torch/csrc/clock.cu',
             'automerge_tpu/ops/clock.py:27 (XLA, no Pallas kernel)',
             err_s),
            ('indexes', 'dominance_indexes', check_indexes,
             lambda a: a[0].numel() * a[3].shape[1],
             lambda a: 'D=%d L=%d T=%d' % (tuple(a[0].shape)
                                          + (a[3].shape[1],)),
             'automerge_tpu_torch/csrc/dominance_indexes.cu',
             'automerge_tpu/ops/list_rank.py:195 (XLA, no Pallas kernel)',
             err_i)):
        metric = KS if key == 'schedule' else KI
        seen = {}
        best = None
        for path, args, _kw in captured[key]:
            timed = path not in seen
            e, ms, plain_ms, bound, by, g_ms = check(
                torch, card, 'main path %s' % path, args, timed=timed)
            err = max(err, e)
            if not timed:
                continue
            seen[path] = {'shape': shape_of(args),
                          'ms': ms, 'graph_ms': g_ms,
                          'plain_ms': plain_ms, 'bound_ms': bound,
                          'bound_by': by}
            if best is None or size_of(args) > best[0]:
                best = (size_of(args), path, seen[path])
        if best is None:
            raise AssertionError('%s: no main-path call was captured' % key)
        _, path, timing = best
        rows[name] = (0, dict({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches[metric],
            'launches_by_path': by_path[metric], 'timed_path': path,
            'library_ms': None, 'paths': seen, 'max_abs_err': err},
            **timing))
    # the sp-block kernel at phase 16's calls: every call held bit-equal;
    # of each path the largest call timed, and the last (in the sp probe,
    # a keystroke) too; the row's times are the largest timed call's
    def block_size(c):
        return c[1][0].numel() * c[1][3].shape[-1]
    timed_calls = {}
    for i, c in enumerate(captured['block']):
        big = timed_calls.setdefault(c[0], {'largest': i})
        if block_size(c) > block_size(captured['block'][big['largest']]):
            big['largest'] = i
        big['last'] = i
    seen = {}
    best = None
    for i, (path, args, kw) in enumerate(captured['block']):
        which = [k for k, j in sorted(timed_calls[path].items()) if j == i]
        timed = bool(which)
        e, ms, plain_ms, bound, by, g_ms, r_ms, r_g = check_block(
            torch, card, 'main path %s' % path, args, kw, timed=timed)
        err_b = max(err_b, e)
        if not timed:
            continue
        label = path if 'largest' in which else path + ' last call'
        seen[label] = {'shape': 'D=%d Ll=%d T=%d chunk=%d' % (
            args[0].shape[0] if args[0].dim() == 2 else 1,
            args[0].shape[-1], args[3].shape[-1], kw.get('chunk', 64)),
            'ms': ms, 'graph_ms': g_ms,
            'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by,
            'route_ms': r_ms, 'route_graph_ms': r_g}
        if best is None or block_size((path, args)) > best[0]:
            best = (block_size((path, args)), label, seen[label])
    if best is None:
        raise AssertionError('dominance_block: no main-path call was '
                             'captured')
    log('dominance_block: %d main-path calls bit-equal to the plain block '
        'mode on %s' % (len(captured['block']), card))
    rows['dominance_block'] = (0, dict({
        'name': 'dominance_block', 'route': 'cuda',
        'source': 'automerge_tpu_torch/csrc/dominance_block.cu',
        'replaces': 'automerge_tpu/ops/list_rank.py:195 (sp mode: '
                    'axis_name, l_offset; XLA, no Pallas kernel)',
        'launches': launches[KB], 'launches_by_path': by_path[KB],
        'branch_counts': mesh_report['block_branches'],
        'timed_path': best[1], 'library_ms': None, 'paths': seen,
        'max_abs_err': err_b}, **best[2]))
    # the linearize kernel at every call of the driven paths, each held
    # bit-equal; the largest call of each path timed; the row's times are
    # the largest timed call's
    largest = {}
    for i, (path, args, _kw) in enumerate(captured['linearize']):
        j = largest.setdefault(path, i)
        if args[0].shape[0] > captured['linearize'][j][1][0].shape[0]:
            largest[path] = i
    seen = {}
    best = None
    readouts = {}
    for i, (path, args, kw) in enumerate(captured['linearize']):
        timed = largest[path] == i
        e, timing, ro = check_linearize(torch, card, 'main path %s' % path,
                                        args, kw, timed=timed, route='tour')
        err_l = max(err_l, e)
        readouts.setdefault(path, []).append(ro)
        if not timed:
            continue
        seen[path] = timing
        if best is None or args[0].shape[0] > best[0]:
            best = (args[0].shape[0], path, timing)
    if best is None:
        raise AssertionError('linearize: no main-path call was captured')
    readouts = {path: readout_summary(r) for path, r in readouts.items()}
    log('linearize: %d main-path calls of %d paths bit-equal to the plain '
        'version, every one on the list-ranking route; per path: %s on %s'
        % (len(captured['linearize']), len(seen), readouts, card))
    rows['linearize'] = (0, dict({
        'name': 'linearize', 'route': 'cuda',
        'source': 'automerge_tpu_torch/csrc/linearize.cu',
        'replaces': 'automerge_tpu/ops/list_rank.py:42 (XLA, no Pallas '
                    'kernel)',
        'launches': launches[KL], 'launches_by_path': by_path[KL],
        'calls_checked': len(captured['linearize']),
        'readouts': readouts,
        'timed_path': best[1], 'library_ms': None, 'paths': seen,
        'edges': lin_edges, 'max_abs_err': err_l}, **best[2]))
    # the lexsort kernel at every call of the driven paths, both entry
    # points, each held bit-equal with its route readout; the largest call
    # of each path timed; the row's times are the largest timed sibling
    # sort's
    entries = {}
    t_sort = time.perf_counter()
    for key, site in (('sibling_sort', 'sibling'),
                      ('register_sort', 'register')):
        calls = captured[key]
        largest = {}
        for i, (path, args, _kw) in enumerate(calls):
            j = largest.setdefault(path, i)
            if args[0].numel() > calls[j][1][0].numel():
                largest[path] = i
        seen = {}
        best = None
        readouts = {}
        for i, (path, args, _kw) in enumerate(calls):
            e, timing, ro = check_lexsort(torch, card, 'main path %s' % path,
                                          site, args,
                                          timed=largest[path] == i)
            err_x = max(err_x, e)
            readouts.setdefault(path, []).append(ro)
            if site == 'register' and not lexsort_per_doc(ro):
                raise AssertionError('lexsort register main path %s (D=%d, '
                                     'L=%d): not per doc (%s)' % (
                                         path, ro['D'], ro['L'], ro))
            if site == 'sibling' and ro['L'] and ro['route'] != (
                    'cluster' if ro['L'] <= ro['cluster_max']
                    * lexsort_kernel.TILE_MAX else 'grid'):
                raise AssertionError('lexsort sibling main path %s (L=%d): '
                                     'the %s route' % (path, ro['L'],
                                                       ro['route']))
            if timing is None:
                continue
            seen[path] = timing
            if best is None or args[0].numel() > best[0]:
                best = (args[0].numel(), path, timing)
        if best is None:
            raise AssertionError('lexsort %s: no main-path call was '
                                 'captured' % site)
        routes = {path: lexsort_routes(r) for path, r in readouts.items()}
        log('lexsort %s: %d main-path calls of %d paths bit-equal to the '
            'plain version; routes per path: %s on %s'
            % (site, len(calls), len(seen), routes, card))
        entries[site] = dict(best[2], timed_path=best[1], paths=seen,
                             calls_checked=len(calls), routes=routes)
    log('lexsort main-path checks and timing: %.1f s'
        % (time.perf_counter() - t_sort))
    rows['lexsort'] = (0, dict({
        'name': 'lexsort', 'route': 'cuda',
        'source': 'automerge_tpu_torch/csrc/lexsort.cu',
        'replaces': 'automerge_tpu/ops/list_rank.py:73 and '
                    'automerge_tpu/ops/registers.py:267 (jnp.lexsort; XLA, '
                    'no Pallas kernel)',
        'launches': launches[KX], 'launches_by_path': by_path[KX],
        'entry_points': entries, 'launches_per_call': sort_launches,
        'max_abs_err': err_x},
        **dict(sort_edges, **{k: entries['sibling'][k] for k in (
            'timed_path', 'shape', 'ms', 'graph_ms', 'plain_ms',
            'library_ms', 'bound_ms', 'bound_by')})))
    log('schedule, route, block, linearize and lexsort main-path checks and '
        'timing: %.1f s' % (time.perf_counter() - t_step_kernels))
    rows['registers'][1]['max_abs_err'] = err1
    rows['dominance'][1]['max_abs_err'] = err2
    rows['members'][1]['max_abs_err'] = err3
    return [rows[k][1] for k in ('registers', 'dominance', 'members',
                                 'schedule', 'dominance_indexes',
                                 'dominance_block', 'linearize', 'lexsort')]


if __name__ == '__main__':
    sys.exit(main())
