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

The sharded step (`make_mesh`, `build_sharded_step`, `shard_batch` and
the dp/sp specs) belongs to the multi-GPU slice.
"""

import numpy as np
import torch

from .. import trace
from ..ops import list_rank, registers
from ..ops.clock_kernel import schedule_queue_auto
from ..ops.dominance_kernel import dominance_indexes_auto
from ..ops.registers import WINDOW
from ..ops.registers_kernel import resolve_registers_auto

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


def _registers(rg, rt, ra, rs, rc, rd, n_groups):
    """`resolve_registers` per doc ([D, T] columns, rc [D, T, A]) as one
    launch over the flattened docs; `n_groups` bounds the docs' group ids
    (`n_groups_of`, from the host's batch).  Returns the JAX step's
    [D, T] outputs (conflicts [D, T, WINDOW]) with winner and conflicts
    as rows within the doc."""
    D, T = rg.shape
    dev = rg.device
    i64 = torch.int64
    docs = torch.arange(D, device=dev, dtype=i64)[:, None]
    group = torch.where(rg >= 0, docs * n_groups + rg, -1)
    # (doc, group, time) with each doc's padding first: two stable sorts
    perm = torch.sort(rt.reshape(-1), stable=True).indices
    key = (docs * (n_groups + 1) + rg.to(i64) + 1).reshape(-1)
    perm = perm[torch.sort(key[perm], stable=True).indices]
    A = rc.shape[2]
    out = resolve_registers_auto(
        group.reshape(-1).to(torch.int32), rt.reshape(-1), ra.reshape(-1),
        rs.reshape(-1), rd.reshape(-1), None, perm.to(torch.int32),
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
    rank = list_rank.linearize(
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


def step_tensors(b, n_groups, n_linearize_iters, chunk=128):
    """The step on uploaded tensors `b` (`upload_batch`), each stage
    issued inside its trace span (`step.schedule`, `step.registers`,
    `step.linearize`, `step.op_metadata`, `step.route`: the host's issue
    time).  On the card nothing here reads the device back: every size
    comes from the shapes or from `n_groups`."""
    with trace.span('step.schedule'):
        order, doc_clock = schedule_queue_auto(
            b['clock'], b['ch_actor'], b['ch_seq'], b['ch_deps'],
            b['ch_valid'])
        frontier = doc_clock.max(dim=0).values
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
    with trace.span('step.route'):
        indexes = dominance_indexes_auto(
            b['eo'], rank, b['vis0'], b['op_elem'], oobj, orank, od,
            b['op_valid'], chunk=chunk)
    return {
        'order': order, 'doc_clock': doc_clock, 'frontier': frontier,
        'alive_after': reg['alive_after'], 'winner': reg['winner'],
        'conflicts': reg['conflicts'],
        'visible_before': reg['visible_before'],
        'overflow': reg['overflow'], 'rank': rank, 'indexes': indexes,
    }


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
