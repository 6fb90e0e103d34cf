"""The single-device resolver step over a batch of docs.

The port of the single-chip half of `automerge_tpu/parallel/mesh.py`:
`single_step` takes the numpy batch dict of `mesh_encode.encode_batch`
and runs, on one device, the JAX package's flagship pipeline in one
step per stage: the causal schedule of every doc's change queue, LWW
register resolution, RGA linearization, and per-op list indexes whose
visibility deltas derive from the register outputs (as the fused
single-device dispatch `ops/registers.resolve_rank_dominate` does).

The JAX step vmaps each stage over docs.  Here each stage is ONE launch
over the whole batch: the schedule kernel takes the doc axis as its grid
(`csrc/clock.cu`); the register kernel (`csrc/registers.cu`, W = 8) and
`linearize` run over the docs flattened into one array, with group and
object ids offset per doc and parents rebased, sorted by (doc, group,
time) so that each doc's padding rows (group -1) sort first within the
doc, and the winners and conflicts mapped back to rows within the doc;
the list indexes go through the whole-doc route
(`ops/dominance_kernel.dominance_indexes_cuda`, `csrc/
dominance_indexes.cu`).  After the uploads nothing reads the card
back: the register groups' bound comes from the host's batch.  On the
CPU the same flattening runs the kernels' plain versions.

The sharded step runs the same stages over a dp x sp grid of devices
(`make_mesh`): documents split over dp, and the element axis of the
arena columns (eo/ep/ec/ea/ev/vis0) over sp (`shard_batch`, after the
JAX package's `_BATCH_SPECS`).  `build_sharded_step` gives, per dp
shard on its first device, the JAX step's shard_map body: the sp blocks
gathered for `linearize`, the stages above, the frontier as a max over
the dp shards (`replica.frontier_pmax`), op metadata from the full
rank, and each sp block's partial list indexes on its own device (the
block kernel, `dominance_kernel.dominance_indexes_block_auto`, against
the block's own slice of the rank), summed once.  The collectives are
explicit copies (`Tensor.to`) and `torch.cat` / `amax` / `sum`: a grid
cell may repeat a device, as every cell does on a one-card host.
"""

import numpy as np
import torch

from .. import trace
from ..ops import list_rank, registers
from ..ops.clock_kernel import schedule_queue_auto
from ..ops.dominance_kernel import (block_count_bound,
                                    dominance_indexes_auto,
                                    dominance_indexes_block_auto,
                                    object_starts, on_device)
from ..ops.lexsort_kernel import register_sort_auto
from ..ops.linearize_kernel import linearize_auto
from ..ops.registers import WINDOW
from ..ops.registers_kernel import resolve_registers_auto
from . import replica

#: the batch keys `single_step` reads
BATCH_KEYS = ('clock', 'ch_actor', 'ch_seq', 'ch_deps', 'ch_valid',
              'rg', 'rt', 'ra', 'rs', 'rc', 'rd',
              'eo', 'ep', 'ec', 'ea', 'ev',
              'vis0', 'op_elem', 'op_row', 'op_valid')


def _op_metadata(elem_obj, elem_rank, op_elem, op_valid):
    """Per-op (object, rank) of the touched element, [D, Tops] each;
    invalid ops get the sentinels the dominance indexes exclude (obj -2
    never matches an element, rank -1)."""
    ge = op_elem.clamp(0, max(elem_obj.shape[1] - 1, 0)).long()
    orank = torch.where(op_valid, elem_rank.gather(1, ge), -1)
    oobj = torch.where(op_valid, elem_obj.gather(1, ge), -2)
    return oobj.to(torch.int32), orank.to(torch.int32)


def register_order(rg, rt, n_groups):
    """The register rows of D docs ([D, T] int32 rg, rt) in (doc, group,
    time) order with each doc's padding (group -1) first, stable: two
    stable sorts.  Per doc it is the JAX step's `jnp.lexsort((time,
    group))` offset by the doc's first row.  The plain version of
    `lexsort_kernel.register_sort_cuda`.  Returns [D * T] int32."""
    D, T = rg.shape
    docs = torch.arange(D, device=rg.device, dtype=torch.int64)[:, None]
    perm = torch.sort(rt.reshape(-1), stable=True).indices
    key = (docs * (n_groups + 1) + rg.to(torch.int64) + 1).reshape(-1)
    perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm.to(torch.int32)


def _registers(rg, rt, ra, rs, rc, rd, n_groups):
    """`resolve_registers` per doc ([D, T] columns, rc [D, T, A]) as one
    launch over the flattened docs; `n_groups` bounds the docs' group ids
    (`n_groups_of`, from the host's batch).  Returns the JAX step's
    [D, T] outputs (conflicts [D, T, WINDOW]) with winner and conflicts
    as rows within the doc."""
    D, T = rg.shape
    dev = rg.device
    docs = torch.arange(D, device=dev, dtype=torch.int64)[:, None]
    group = torch.where(rg >= 0, docs * n_groups + rg, -1)
    # (doc, group, time) with each doc's padding first
    perm = register_sort_auto(rg, rt, n_groups)
    A = rc.shape[2]
    out = resolve_registers_auto(
        group.reshape(-1).to(torch.int32), rt.reshape(-1), ra.reshape(-1),
        rs.reshape(-1), rd.reshape(-1), None, perm,
        rc.reshape(D * T, A), torch.arange(D * T, device=dev,
                                           dtype=torch.int32),
        window=WINDOW)
    base = (docs * T).to(torch.int32)

    def local(rows, shape):
        rows = rows.reshape(shape)
        off = base if rows.dim() == 2 else base[:, :, None]
        return torch.where(rows >= 0, rows - off, -1).to(torch.int32)

    return {
        'alive_after': out['alive_after'].reshape(D, T),
        'winner': local(out['winner'], (D, T)),
        'conflicts': local(out['conflicts'], (D, T, WINDOW)),
        'visible_before': out['visible_before'].reshape(D, T),
        'overflow': out['overflow'].reshape(D, T),
    }


def _linearize(eo, ep, ec, ea, ev, n_iters):
    """`linearize` per doc ([D, L] arena columns) as one pass over the
    flattened docs: each doc's object ids and parents offset by its
    first row (d * L).  Returns rank [D, L]."""
    D, L = eo.shape
    base = torch.arange(D, device=eo.device, dtype=torch.int32)[:, None] * L
    rank = linearize_auto(
        (eo + base).reshape(-1), torch.where(ep >= 0, ep + base,
                                             -1).reshape(-1),
        ec.reshape(-1), ea.reshape(-1), ev.reshape(-1), n_iters)
    return rank.reshape(D, L)


def _op_deltas(reg, op_row, op_valid):
    """Visibility delta per list op from the register outputs: +1 insert,
    -1 remove, 0 no visibility change (the reference toggles element
    visibility the same way per applied assign)."""
    T = reg['alive_after'].shape[1]
    row = op_row.clamp(0, max(T - 1, 0)).long()
    alive = reg['alive_after'].gather(1, row) > 0
    before = reg['visible_before'].gather(1, row)
    return torch.where((op_row >= 0) & op_valid,
                       alive.to(torch.int32) - before.to(torch.int32), 0)


def _step_device(device):
    from ..native import _pool_device
    return _pool_device(device, 'single_step')


def n_groups_of(batch):
    """One past the largest register group id of a numpy batch (at least
    1): the bound `_registers` offsets each doc's groups by."""
    rg = np.asarray(batch['rg'])
    return max(int(rg.max()) + 1, 1) if rg.size else 1


def upload_batch(batch, device):
    """The step's input tensors on `device`: every array of BATCH_KEYS as
    a private copy (`ops/registers.upload`)."""
    return {k: registers.upload(np.array(batch[k]), device)
            for k in BATCH_KEYS}


def _stages(b, n_groups, n_linearize_iters):
    """The step's stages before the list indexes, each issued inside its
    trace span: (order, doc_clock, register outputs, rank, op deltas,
    op objects, op ranks)."""
    with trace.span('step.schedule'):
        order, doc_clock = schedule_queue_auto(
            b['clock'], b['ch_actor'], b['ch_seq'], b['ch_deps'],
            b['ch_valid'])
    with trace.span('step.registers'):
        reg = _registers(b['rg'], b['rt'], b['ra'], b['rs'], b['rc'],
                         b['rd'], n_groups)
    with trace.span('step.linearize'):
        rank = _linearize(b['eo'], b['ep'], b['ec'], b['ea'], b['ev'],
                          n_linearize_iters)
    with trace.span('step.op_metadata'):
        od = _op_deltas(reg, b['op_row'], b['op_valid'])
        oobj, orank = _op_metadata(b['eo'], rank, b['op_elem'],
                                   b['op_valid'])
    return order, doc_clock, reg, rank, od, oobj, orank


def _outputs(order, doc_clock, reg, rank, indexes):
    """The step's per-doc outputs under the JAX step's keys (all but the
    frontier)."""
    return {
        'order': order, 'doc_clock': doc_clock,
        'alive_after': reg['alive_after'], 'winner': reg['winner'],
        'conflicts': reg['conflicts'],
        'visible_before': reg['visible_before'],
        'overflow': reg['overflow'], 'rank': rank, 'indexes': indexes,
    }


def step_tensors(b, n_groups, n_linearize_iters, chunk=128):
    """The step on uploaded tensors `b` (`upload_batch`), each stage
    issued inside its trace span (`step.schedule`, `step.registers`,
    `step.linearize`, `step.op_metadata`, `step.route`: the host's issue
    time).  On the card nothing here reads the device back: every size
    comes from the shapes or from `n_groups`."""
    order, doc_clock, reg, rank, od, oobj, orank = _stages(
        b, n_groups, n_linearize_iters)
    with trace.span('step.route'):
        indexes = dominance_indexes_auto(
            b['eo'], rank, b['vis0'], b['op_elem'], oobj, orank, od,
            b['op_valid'], chunk=chunk)
    return dict(_outputs(order, doc_clock, reg, rank, indexes),
                frontier=doc_clock.max(dim=0).values)


def single_step(batch, n_linearize_iters, chunk=128, device=None):
    """The resolver step on one device: the card unless `device` says
    'cpu' (the kernels' plain versions).

    `batch` is the numpy dict of `mesh_encode.encode_batch` (or
    `demo_batch`); every array crosses to the device as a private copy
    (`upload_batch`, in the trace span `step.uploads`), then
    `step_tensors` runs the stages.  Returns tensors on the device under
    the JAX step's keys: order [D, C], doc_clock [D, A], frontier [A],
    alive_after / winner / visible_before / overflow [D, T], conflicts
    [D, T, WINDOW], rank [D, L] and indexes [D, Tops].  `chunk` is the op
    chunk of the plain dominance indexes; the card's route gives the
    same integers whatever the chunk on the step's inputs."""
    dev = _step_device(device)
    with trace.span('step.uploads'):
        b = upload_batch(batch, dev)
    return step_tensors(b, n_groups_of(batch), n_linearize_iters,
                        chunk=chunk)


# ---------------------------------------------------------------------------
# the sharded step over a dp x sp grid of devices
# ---------------------------------------------------------------------------

#: the batch keys split over sp (the arena columns); every other key is
#: split over dp only and copied to each sp cell of its dp shard
SP_KEYS = ('eo', 'ep', 'ec', 'ea', 'ev', 'vis0')


class Mesh:
    """A dp x sp grid of torch devices: `devices[i][s]` holds sp block s
    of dp shard i.  A device may fill several cells."""

    def __init__(self, devices):
        self.devices = [list(row) for row in devices]
        self.dp = len(self.devices)
        self.sp = len(self.devices[0]) if self.devices else 0
        if self.dp < 1 or self.sp < 1 or \
                any(len(row) != self.sp for row in self.devices):
            raise ValueError('a mesh is a non-empty dp x sp grid')

    @property
    def shape(self):
        return {'dp': self.dp, 'sp': self.sp}

    def __repr__(self):
        return 'Mesh(dp=%d, sp=%d, %s)' % (self.dp, self.sp, self.devices)


def make_mesh(dp, sp=1, devices=None):
    """A dp x sp `Mesh`.  `devices` is one device or a list of them,
    placed row by row (cell (i, s) takes devices[(i * sp + s) %
    len(devices)]); None means the card, `cuda:0`, in every cell (and an
    error when there is no CUDA device)."""
    if dp < 1 or sp < 1:
        raise ValueError('mesh axes must be >= 1, got dp=%r sp=%r'
                         % (dp, sp))
    from ..native import _indexed_device, _pool_device
    if devices is None:
        devices = [None]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [_indexed_device(_pool_device(d, 'make_mesh'))
               for d in devices]
    if not devices:
        raise ValueError('make_mesh needs at least one device')
    return Mesh([[devices[(i * sp + s) % len(devices)] for s in range(sp)]
                 for i in range(dp)])


class ShardedBatch:
    """A global batch placed on a mesh (`shard_batch`): `cells[i][s]` is
    the dict of tensors of dp shard i, sp block s, on its device."""

    def __init__(self, mesh, cells, n_groups, shape):
        self.mesh = mesh
        self.cells = cells
        self.n_groups = n_groups
        #: (D, L, T) of the global batch
        self.shape = shape


def shard_batch(mesh, batch):
    """Places the global numpy batch (`mesh_encode.encode_batch`,
    `demo_batch`) on `mesh`: docs split over dp, the arena columns
    (`SP_KEYS`) over sp, so that block s holds elements [s * Ll, (s + 1)
    * Ll); every other column is copied to each sp cell of its dp shard.
    Every array crosses as a private copy (`ops/registers.upload`).  dp
    must divide the doc count and sp the element count."""
    D, L = np.shape(batch['eo'])
    T = np.shape(batch['op_elem'])[1]
    if D % mesh.dp:
        raise ValueError('dp=%d must divide the %d docs' % (mesh.dp, D))
    if L % mesh.sp:
        raise ValueError('sp=%d must divide the %d elements' % (mesh.sp, L))
    Dl, Ll = D // mesh.dp, L // mesh.sp
    cells = []
    for i, row in enumerate(mesh.devices):
        docs = slice(i * Dl, (i + 1) * Dl)
        cells.append([{
            k: registers.upload(np.array(
                np.asarray(batch[k])[docs, s * Ll:(s + 1) * Ll]
                if k in SP_KEYS else np.asarray(batch[k])[docs]), dev)
            for k in BATCH_KEYS} for s, dev in enumerate(row)])
    return ShardedBatch(mesh, cells, n_groups_of(batch), (D, L, T))


def build_sharded_step(mesh, n_linearize_iters, chunk=64):
    """The resolver step over `mesh`, the counterpart of the JAX
    package's `build_sharded_step`.  Returns a callable taking a
    `shard_batch` of this mesh and returning the JAX step's outputs as
    global [D, ...] tensors in dp order on the grid's first device:
    order [D, C], doc_clock [D, A], frontier [A] (the max over every doc
    of every dp shard), alive_after / winner / visible_before / overflow
    [D, T], conflicts [D, T, WINDOW], rank [D, L] and indexes [D, Tops].

    Per dp shard, on its first device: the sp blocks of the arena
    columns gathered for `linearize`, the single step's stages, and the
    op metadata from the full rank and the docs' object starts (the
    block kernel's extra input, `object_starts` of the gathered
    objects); then each sp block's partial indexes on the block's device
    against its own slice of the rank (op chunks of `chunk`), summed
    once.  Nothing reads the card back."""

    def step(sb):
        if (sb.mesh.dp, sb.mesh.sp) != (mesh.dp, mesh.sp):
            raise ValueError('the batch was sharded over %r, the step '
                             'runs over %r' % (sb.mesh, mesh))
        _D, L, T = sb.shape
        block_count_bound(L, T, chunk)
        outs, local_clocks = [], []
        for i, row in enumerate(mesh.devices):
            cells = sb.cells[i]
            first = row[0]
            with on_device(first):
                b = dict(cells[0])
                if mesh.sp > 1:
                    with trace.span('step.gather'):
                        for k in SP_KEYS:
                            b[k] = torch.cat([c[k].to(first) for c in cells],
                                             dim=1)
                order, doc_clock, reg, rank, od, oobj, orank = _stages(
                    b, sb.n_groups, n_linearize_iters)
                local_clocks.append(torch.amax(doc_clock, dim=0))
                Ll = cells[0]['eo'].shape[1]
                with trace.span('step.route'):
                    starts = object_starts(b['eo'])
                    parts = []
                    for s, (c, dev) in enumerate(zip(cells, row)):
                        with on_device(dev):
                            parts.append(dominance_indexes_block_auto(
                                c['eo'], rank[:, s * Ll:(s + 1) * Ll].to(dev),
                                c['vis0'], c['op_elem'], oobj.to(dev),
                                orank.to(dev), od.to(dev), c['op_valid'],
                                chunk=chunk, l_offset=s * Ll,
                                starts=starts.to(dev)).to(first))
                    indexes = parts[0] if len(parts) == 1 else \
                        torch.stack(parts).sum(dim=0, dtype=torch.int32)
            outs.append(_outputs(order, doc_clock, reg, rank, indexes))
        top = mesh.devices[0][0]
        out = {k: torch.cat([o[k].to(top) for o in outs]) for k in outs[0]}
        out['frontier'] = replica.frontier_pmax(local_clocks, mesh)
        return out

    return step


def demo_batch(n_docs=8, n_changes=4, n_actors=4, n_regs=8, n_elems=8,
               n_list_ops=8):
    """A tiny synthetic-but-consistent workload (numpy) for compile checks
    and the differential tests.

    Per doc: n_changes causally-chained changes round-robin over actors;
    one register group with n_regs sequential writers; one list object
    whose n_elems elements form an insertion chain, each made visible by
    one op."""
    D, C, A, T, L, To = (n_docs, n_changes, n_actors, n_regs, n_elems,
                         n_list_ops)
    rng = np.random.RandomState(0)

    clock = np.zeros((D, A), np.int32)
    ch_actor = np.tile(np.arange(C, dtype=np.int32) % A, (D, 1))
    ch_seq = np.tile((np.arange(C, dtype=np.int32) // A) + 1, (D, 1))
    ch_deps = np.zeros((D, C, A), np.int32)
    for i in range(1, C):
        # each change depends on the previous one in round-robin order
        ch_deps[:, i, (i - 1) % A] = ((i - 1) // A) + 1
    ch_valid = np.ones((D, C), bool)

    rg = np.tile((np.arange(T, dtype=np.int32) % 2), (D, 1))
    rt = np.tile(np.arange(T, dtype=np.int32), (D, 1))
    ra = rng.randint(0, A, size=(D, T)).astype(np.int32)
    rs = np.ones((D, T), np.int32)
    rc = np.zeros((D, T, A), np.int32)
    for t in range(1, T):
        rc[:, t] = rc[:, t - 1]
        np.put_along_axis(rc[:, t], ra[:, t - 1][:, None],
                          rs[:, t - 1][:, None], axis=1)
    rd = np.zeros((D, T), bool)

    eo = np.zeros((D, L), np.int32)
    ep = np.tile(np.arange(-1, L - 1, dtype=np.int32), (D, 1))
    ec = np.tile(np.arange(1, L + 1, dtype=np.int32), (D, 1))
    ea = rng.randint(0, A, size=(D, L)).astype(np.int32)
    ev = np.ones((D, L), bool)

    vis0 = np.zeros((D, L), np.float32)
    op_elem = np.tile(np.arange(To, dtype=np.int32) % L, (D, 1))
    # each list op points at a register row; its visibility delta derives
    # from the register outputs on the device
    op_row = np.tile(np.arange(To, dtype=np.int32) % T, (D, 1))
    op_valid = np.ones((D, To), bool)

    return {
        'clock': clock, 'ch_actor': ch_actor, 'ch_seq': ch_seq,
        'ch_deps': ch_deps, 'ch_valid': ch_valid,
        'rg': rg, 'rt': rt, 'ra': ra, 'rs': rs, 'rc': rc, 'rd': rd,
        'eo': eo, 'ep': ep, 'ec': ec, 'ea': ea, 'ev': ev,
        'vis0': vis0, 'op_elem': op_elem, 'op_row': op_row,
        'op_valid': op_valid,
    }
