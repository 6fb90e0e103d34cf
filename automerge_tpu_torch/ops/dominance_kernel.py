"""Per-object dominance indexes: the CUDA kernel and its switch.

`dominance_grouped_cuda` launches `csrc/dominance.cu` (the port of the
TPU kernel `automerge_tpu/ops/pallas_dominance.py::_kernel`);
`dominance_grouped_auto` picks by device: the kernel for CUDA tensors,
the plain version `list_rank.dominance_grouped` for CPU tensors.  A
kernel that fails to build or launch raises.

`dominance_indexes_cuda` is the card's route of the whole-doc form
`list_rank.dominance_indexes` (which the JAX package leaves to XLA): a
kernel of its own, `csrc/dominance_indexes.cu`, in which each doc
decides on the card whether it regroups by object or walks the chunks
as the JAX scan does, with no host read.  A doc that regroups takes
the fast branch: `prep_kernel` gives each element and op a dense
position (object start + rank), and `query_kernel` rebuilds each op
chunk's start state over those positions and scans it window by window
(a warp a doc when the doc fits 32 elements and 32 ops).
`dominance_indexes_auto` picks by device.

`dominance_indexes_block_cuda` is the card's form of the block mode of
`list_rank.dominance_indexes` (the JAX function's sequence-parallel
mode): `csrc/dominance_block.cu`, in which each doc decides on the card
whether one sp block regroups (the whole-doc route's dense positions
compacted to the block: a bitmap over the doc's object starts,
`object_starts`, and time chunks rebuilt and scanned in parallel) or
walks the caller's chunks; `block_branch_counts` counts them and
`dominance_indexes_block_auto` picks by device.
"""

import contextlib
import threading

import torch

from .. import trace
from . import _build
from .list_rank import dominance_grouped, dominance_indexes

#: launches of the CUDA kernel (the trace counter's name)
LAUNCH_METRIC = 'launch.dominance'
#: launches of the whole-doc route (`csrc/dominance_indexes.cu`)
INDEXES_METRIC = 'launch.dominance_indexes'
#: launches of the sp-block route (`csrc/dominance_block.cu`)
BLOCK_METRIC = 'launch.dominance_block'
#: counts stay exact in float32 below this (the plain version's sums)
EXACT_COUNTS = 1 << 24
#: device -> the route's branch counters (`branch_counts`)
_BRANCH_COUNTS = {}
#: device -> the sp-block route's branch counters (`block_branch_counts`)
_BLOCK_BRANCH_COUNTS = {}
#: both tables are filled under this lock: a second tensor for a device
#: would leave the first thread's launches counting where nobody reads
_COUNTERS_LOCK = threading.Lock()


def scratch_for(lib, O, L, T, chunk, device):
    """The global scratch the kernel asks for at this shape (None when
    every object's histogram fits shared memory): int32 histogram and
    tile-sum rows for long objects."""
    n = lib.amtpu_torch_dominance_scratch(O, L, T, chunk)
    if n == 0:
        return None
    return torch.empty((n // 4,), dtype=torch.int32, device=device)


def dominance_grouped_cuda(vis0, elem_rank, op_elem, op_rank, op_delta,
                           op_valid, chunk=64):
    """The CUDA kernel; same arguments and output as
    `list_rank.dominance_grouped`.  Inputs must lie on one CUDA device.
    Element ranks must lie in [-1, L), as `linearize` gives them (an
    object's rank is below its element count, which its padded row
    holds)."""
    if vis0.device.type != 'cuda':
        raise ValueError('the dominance kernel takes CUDA tensors, got %s'
                         % vis0.device)
    O, L = vis0.shape
    T = op_elem.shape[1]
    if chunk < 1 or T % chunk != 0:
        raise ValueError('T=%d must be a multiple of chunk=%d'
                         % (T, chunk))
    vis0 = vis0.to(torch.float32).contiguous()
    elem_rank = elem_rank.to(torch.int32).contiguous()
    ops = [x.to(torch.int32).contiguous()
           for x in (op_elem, op_rank, op_delta)]
    op_valid = op_valid.to(torch.bool).contiguous()
    for x in [elem_rank] + ops + [op_valid]:
        if x.device != vis0.device:
            raise ValueError('dominance inputs must share one device')
    if elem_rank.shape != (O, L) or any(x.shape != (O, T)
                                        for x in ops + [op_valid]):
        raise ValueError('dominance inputs must be [O, L] and [O, T]')
    index = torch.empty((O, T), dtype=torch.int32, device=vis0.device)
    if O == 0 or T == 0:
        return index
    lib = _build.kernel('dominance')
    scratch = scratch_for(lib, O, L, T, chunk, vis0.device)
    err = lib.amtpu_torch_dominance(
        vis0.data_ptr(), elem_rank.data_ptr(), ops[0].data_ptr(),
        ops[1].data_ptr(), ops[2].data_ptr(), op_valid.data_ptr(),
        index.data_ptr(), None if scratch is None else scratch.data_ptr(),
        O, L, T, chunk, _build.stream_of(vis0))
    _build.check(err, 'dominance')
    trace.metric(LAUNCH_METRIC)
    return index


def dominance_grouped_auto(vis0, elem_rank, op_elem, op_rank, op_delta,
                           op_valid, chunk=64):
    """The kernel on a CUDA device, the plain version on the CPU; the
    outputs are bit-equal."""
    if vis0.device.type == 'cuda':
        return dominance_grouped_cuda(vis0, elem_rank, op_elem, op_rank,
                                      op_delta, op_valid, chunk=chunk)
    if vis0.device.type != 'cpu':
        raise ValueError('no dominance kernel for device %s' % vis0.device)
    return dominance_grouped(vis0, elem_rank, op_elem, op_rank, op_delta,
                             op_valid, chunk=chunk)


def _counters(table, device):
    """The int64 [2] device counters of `table` on `device`, made zero at
    first use: one tensor a device, whichever threads ask at once."""
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    counts = table.get(dev)
    if counts is not None:
        return counts
    with _COUNTERS_LOCK:
        counts = table.get(dev)
        if counts is None:
            counts = torch.zeros((2,), dtype=torch.int64, device=dev)
            table[dev] = counts
    return counts


def branch_counts(device):
    """The route's device counters on `device`, int64 [2]: docs that took
    the fast branch and docs that took the chunk scan, summed over every
    call since the tensor was made or last zeroed (`.zero_()`).  Reading
    them is a host read: do it outside the timed or checked region."""
    return _counters(_BRANCH_COUNTS, device)


def block_branch_counts(device):
    """The sp-block route's device counters on `device`, as
    `branch_counts`: int64 [2], (doc, block) calls that took the fast
    branch and those that walked the caller's chunks."""
    return _counters(_BLOCK_BRANCH_COUNTS, device)


def dominance_indexes_cuda(elem_obj, elem_rank, vis0, op_elem, op_obj,
                           op_rank, op_delta, op_valid, chunk=128):
    """The card's route of `list_rank.dominance_indexes` ([D, ...] or one
    doc), bit-equal to the plain version at `chunk` (1 to 1024):
    `csrc/dominance_indexes.cu`, one launch for docs of at most 32
    elements and ops, two for longer ones.  Each doc decides on the card
    whether it regroups by object (its counts then do not depend on the
    chunking: the fast branch) or walks the chunks as the JAX scan does;
    `branch_counts` counts the docs of each branch.  Nothing is read
    back to the host; the scratch is sized from the shapes."""
    if elem_obj.device.type != 'cuda':
        raise ValueError('the dominance kernel takes CUDA tensors, got %s'
                         % elem_obj.device)
    if elem_obj.dim() == 1:
        return dominance_indexes_cuda(
            elem_obj[None], elem_rank[None], vis0[None], op_elem[None],
            op_obj[None], op_rank[None], op_delta[None], op_valid[None],
            chunk=chunk)[0]
    if not 1 <= chunk <= 1024:
        raise ValueError('the dominance route takes a chunk in [1, 1024], '
                         'got %d' % chunk)
    dev = elem_obj.device
    D, L = elem_obj.shape
    T = op_elem.shape[1]
    elems = [x.to(torch.int32).contiguous() for x in (elem_obj, elem_rank)]
    vis = vis0.to(torch.float32).contiguous()
    ops = [x.to(torch.int32).contiguous()
           for x in (op_elem, op_obj, op_rank, op_delta)]
    valid = op_valid.to(torch.bool).contiguous()
    for x in elems + ops + [vis, valid]:
        if x.device != dev:
            raise ValueError('dominance inputs must share one device')
    if any(x.shape != (D, L) for x in elems + [vis]) or \
            any(x.shape != (D, T) for x in ops + [valid]):
        raise ValueError('dominance inputs must be [D, L] and [D, T]')
    index = torch.empty((D, T), dtype=torch.int32, device=dev)
    if D == 0 or T == 0:
        return index
    lib = _build.kernel('dominance_indexes')
    scratch = torch.empty((lib.amtpu_torch_route_scratch(D, L, T),),
                          dtype=torch.int32, device=dev)
    err = lib.amtpu_torch_route(
        elems[0].data_ptr(), elems[1].data_ptr(), vis.data_ptr(),
        ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
        ops[3].data_ptr(), valid.data_ptr(), index.data_ptr(),
        scratch.data_ptr(), branch_counts(dev).data_ptr(), D, L, T, chunk,
        _build.stream_of(index))
    _build.check(err, 'dominance_indexes')
    trace.metric(INDEXES_METRIC)
    return index


def dominance_indexes_auto(elem_obj, elem_rank, vis0, op_elem, op_obj,
                           op_rank, op_delta, op_valid, chunk=128):
    """The card's route on a CUDA device, the plain version on the CPU;
    the outputs are bit-equal (at `chunk`)."""
    if elem_obj.device.type == 'cuda':
        return dominance_indexes_cuda(elem_obj, elem_rank, vis0, op_elem,
                                      op_obj, op_rank, op_delta, op_valid,
                                      chunk=chunk)
    if elem_obj.device.type != 'cpu':
        raise ValueError('no dominance route for device %s'
                         % elem_obj.device)
    return dominance_indexes(elem_obj, elem_rank, vis0, op_elem, op_obj,
                             op_rank, op_delta, op_valid, chunk=chunk)


def on_device(device):
    """The device context a launch on `device` runs under (CUDA only: a
    kernel goes to the current stream of the device it is launched on)."""
    return torch.cuda.device(device) if device.type == 'cuda' \
        else contextlib.nullcontext()


def object_starts(elem_obj):
    """The docs' object starts, the block route's extra input: [D, L]
    objects of the whole docs -> [D, L + 1] int32, object o spanning
    count(o) + 1 dense positions from start(o) = sum over o' < o of
    (count(o') + 1); objects outside [0, L) count nowhere.  Plain torch
    on the objects' device, no host read."""
    D, L = elem_obj.shape
    dev = elem_obj.device
    o = elem_obj.long()
    ok = (o >= 0) & (o < L)
    cnt = torch.zeros((D, L + 1), dtype=torch.int32, device=dev)
    cnt.scatter_add_(1, torch.where(ok, o, L), ok.to(torch.int32))
    starts = torch.zeros((D, L + 1), dtype=torch.int32, device=dev)
    torch.cumsum(cnt[:, :L] + 1, dim=1, out=starts[:, 1:])
    return starts


def block_count_bound(L, T, chunk):
    """Checks, from the shapes alone, that every count of the block route
    over L elements (one block, or the sum of a doc's blocks) and T ops
    stays below 2^24, where the float32 sums are exact and the blocks'
    int32 partial counts sum to the JAX function's psum: a count is at
    most the elements (visibility 0/1 at the start, each op moving one
    element by at most 1) plus the T deltas plus a chunk's term."""
    if L + T + chunk >= EXACT_COUNTS:
        raise ValueError('dominance counts over %d elements and %d ops '
                         'may reach 2^24, past exact float32 sums'
                         % (L, T))


def dominance_indexes_block_cuda(elem_obj, elem_rank, vis0, op_elem, op_obj,
                                 op_rank, op_delta, op_valid, chunk=64,
                                 l_offset=0, starts=None):
    """The card's form of `list_rank.dominance_indexes(..., block=True)`
    ([D, ...] or one doc), bit-equal to it at `chunk` (1 to 1024): each
    op's partial count over this sp block, whose first element is global
    index `l_offset`; the block at l_offset 0 adds the within-chunk term.
    `starts` ([D, L + 1] int32, or [L + 1] for one doc) holds each doc's
    object starts over its whole L elements (`object_starts` of the
    gathered doc's objects); the plain version does not take it.
    `csrc/dominance_block.cu`: each doc decides on the card whether the
    block regroups (dense positions over the block: the fast branch) or
    walks the caller's chunks; `block_branch_counts` counts the docs of
    each branch.  Nothing is read back to the host; the scratch is sized
    from the shapes."""
    if elem_obj.device.type != 'cuda':
        raise ValueError('the dominance block kernel takes CUDA tensors, '
                         'got %s' % elem_obj.device)
    if starts is None:
        raise ValueError('the dominance block kernel takes the docs\' '
                         'object starts (object_starts)')
    if elem_obj.dim() == 1:
        return dominance_indexes_block_cuda(
            elem_obj[None], elem_rank[None], vis0[None], op_elem[None],
            op_obj[None], op_rank[None], op_delta[None], op_valid[None],
            chunk=chunk, l_offset=l_offset, starts=starts[None])[0]
    if not 1 <= chunk <= 1024:
        raise ValueError('the dominance block kernel takes a chunk in '
                         '[1, 1024], got %d' % chunk)
    dev = elem_obj.device
    D, L = elem_obj.shape
    T = op_elem.shape[1]
    Lg = starts.shape[-1] - 1
    block_count_bound(L, T, chunk)
    elems = [x.to(torch.int32).contiguous() for x in (elem_obj, elem_rank)]
    vis = vis0.to(torch.float32).contiguous()
    starts = starts.to(torch.int32).contiguous()
    ops = [x.to(torch.int32).contiguous()
           for x in (op_elem, op_obj, op_rank, op_delta)]
    valid = op_valid.to(torch.bool).contiguous()
    for x in elems + ops + [vis, valid, starts]:
        if x.device != dev:
            raise ValueError('dominance inputs must share one device')
    if any(x.shape != (D, L) for x in elems + [vis]) or \
            any(x.shape != (D, T) for x in ops + [valid]):
        raise ValueError('dominance inputs must be [D, L] and [D, T]')
    if starts.shape != (D, Lg + 1) or not 0 <= l_offset <= Lg - L or \
            Lg >= 1 << 29:
        raise ValueError('object starts must be [D, L + 1] over docs that '
                         'hold the block (%d elements at %d), L < 2^29'
                         % (L, l_offset))
    index = torch.empty((D, T), dtype=torch.int32, device=dev)
    if D == 0 or T == 0:
        return index
    lib = _build.kernel('dominance_block')
    scratch = torch.empty(
        (max(lib.amtpu_torch_route_block_scratch(D, L, Lg, T, chunk), 1),),
        dtype=torch.int32, device=dev)
    err = lib.amtpu_torch_route_block(
        elems[0].data_ptr(), elems[1].data_ptr(), vis.data_ptr(),
        starts.data_ptr(), ops[0].data_ptr(), ops[1].data_ptr(),
        ops[2].data_ptr(), ops[3].data_ptr(), valid.data_ptr(),
        index.data_ptr(), scratch.data_ptr(),
        block_branch_counts(dev).data_ptr(), D, L, Lg, T, chunk,
        int(l_offset), 1 if l_offset == 0 else 0, _build.stream_of(index))
    _build.check(err, 'dominance_block')
    trace.metric(BLOCK_METRIC)
    return index


def dominance_indexes_block_auto(elem_obj, elem_rank, vis0, op_elem, op_obj,
                                 op_rank, op_delta, op_valid, chunk=64,
                                 l_offset=0, starts=None):
    """The block kernel on a CUDA device (which takes `starts`), the plain
    version's block mode on the CPU (which does not); the outputs are
    bit-equal (at `chunk`)."""
    if elem_obj.device.type == 'cuda':
        return dominance_indexes_block_cuda(
            elem_obj, elem_rank, vis0, op_elem, op_obj, op_rank, op_delta,
            op_valid, chunk=chunk, l_offset=l_offset, starts=starts)
    if elem_obj.device.type != 'cpu':
        raise ValueError('no dominance block route for device %s'
                         % elem_obj.device)
    block_count_bound(elem_obj.shape[-1], op_elem.shape[-1], chunk)
    return dominance_indexes(elem_obj, elem_rank, vis0, op_elem, op_obj,
                             op_rank, op_delta, op_valid, chunk=chunk,
                             l_offset=l_offset, block=True)
