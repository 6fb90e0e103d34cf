"""Per-object dominance indexes: the CUDA kernel and its switch.

`dominance_grouped_cuda` launches `csrc/dominance.cu` (the port of the
TPU kernel `automerge_tpu/ops/pallas_dominance.py::_kernel`);
`dominance_grouped_auto` picks by device: the kernel for CUDA tensors,
the plain version `list_rank.dominance_grouped` for CPU tensors.  A
kernel that fails to build or launch raises.

`dominance_indexes_cuda` is the card's route of the whole-doc form
`list_rank.dominance_indexes` (which the JAX package leaves to XLA): it
regroups the docs' elements and ops by object on the device and
launches the same kernel, as the JAX engine's `_dominance` regroups on
the host.  Inputs that do not regroup exactly (`regroupable`: their
counts depend on the chunking) take a kernel of their own instead,
`csrc/dominance_indexes.cu`, which walks the chunks as the JAX scan
does.  `dominance_indexes_auto` picks by device.
"""

import torch

from .. import trace
from . import _build
from .list_rank import dominance_grouped, dominance_indexes

#: launches of the CUDA kernel (the trace counter's name)
LAUNCH_METRIC = 'launch.dominance'
#: launches of the whole-doc route (each launches the kernel once)
INDEXES_METRIC = 'launch.dominance_indexes'
#: launches of the chunk-scan kernel (inputs that do not regroup)
SCAN_METRIC = 'launch.dominance_scan'
#: the kernel's chunk on the whole-doc route (the engine's _DOM_CHUNK)
INDEXES_CHUNK = 64


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


def regroupable(elem_obj, elem_rank, vis0, op_elem, op_obj, op_rank,
                op_delta, op_valid):
    """Whether the whole-doc inputs [D, ...] regroup by object exactly:
    every element has an object >= 0 and a visibility of 0 or 1; every
    valid op touches an element 0 <= op_elem < L whose object and rank
    are op_obj and op_rank; every invalid op has op_obj == -2 and delta 0
    (as `parallel/mesh.py::_op_metadata` and `_op_deltas` make them).
    Then an op's index is its object's visible elements of lower rank at
    batch start plus the deltas of the earlier valid ops of its object
    that touched a lower rank, whatever the chunking, and an invalid
    op's is 0.  One bool, read back to the host."""
    L = elem_obj.shape[1]
    if L == 0:
        return False
    e = op_elem.clamp(0, L - 1).long()
    ok_valid = (op_elem >= 0) & (op_elem < L) & \
        (op_obj == elem_obj.gather(1, e)) & (op_rank == elem_rank.gather(1, e))
    ok_ops = torch.where(op_valid, ok_valid, (op_obj == -2) & (op_delta == 0))
    ok_elems = (elem_obj >= 0) & ((vis0 == 0) | (vis0 == 1))
    return bool(ok_ops.all()) and bool(ok_elems.all())


def _runs(keys):
    """For int64 keys [N]: (unique sorted keys, row of each key, position
    of each key within its row in index order)."""
    uniq, row = torch.unique(keys, return_inverse=True)
    order = torch.argsort(row, stable=True)
    starts = torch.searchsorted(row[order], row[order])
    pos = torch.empty_like(row)
    pos[order] = torch.arange(keys.shape[0], device=keys.device) - starts
    return uniq, row, pos


def dominance_indexes_cuda(elem_obj, elem_rank, vis0, op_elem, op_obj,
                           op_rank, op_delta, op_valid, chunk=128):
    """The card's route of `list_rank.dominance_indexes` ([D, ...] or one
    doc).  Inputs that pass `regroupable` (the step's always do) go to
    rows of one object per (doc, object), elements at their index order
    and ops at their time order within the row, then one launch of the
    dominance kernel at INDEXES_CHUNK, and the indexes gathered back (0
    for invalid ops): bit-equal to the plain version at every chunk.
    Other inputs launch the chunk-scan kernel at `chunk`
    (`csrc/dominance_indexes.cu`), bit-equal to the plain version at the
    same chunk."""
    if elem_obj.device.type != 'cuda':
        raise ValueError('the dominance kernel takes CUDA tensors, got %s'
                         % elem_obj.device)
    if elem_obj.dim() == 1:
        return dominance_indexes_cuda(
            elem_obj[None], elem_rank[None], vis0[None], op_elem[None],
            op_obj[None], op_rank[None], op_delta[None], op_valid[None],
            chunk=chunk)[0]
    if not regroupable(elem_obj, elem_rank, vis0, op_elem, op_obj, op_rank,
                       op_delta, op_valid):
        return dominance_scan_cuda(elem_obj, elem_rank, vis0, op_elem,
                                   op_obj, op_rank, op_delta, op_valid,
                                   chunk)
    out = indexes_by_object(elem_obj, elem_rank, vis0, op_elem, op_obj,
                            op_rank, op_delta, op_valid,
                            dominance_grouped_cuda)
    trace.metric(INDEXES_METRIC)
    return out


def dominance_scan_cuda(elem_obj, elem_rank, vis0, op_elem, op_obj, op_rank,
                        op_delta, op_valid, chunk=128):
    """The chunk-scan kernel (`csrc/dominance_indexes.cu`) over [D, ...]
    inputs on one CUDA device; same output as `list_rank.
    dominance_indexes` at `chunk` (1 to 1024), for any inputs."""
    dev = elem_obj.device
    if dev.type != 'cuda':
        raise ValueError('the dominance scan kernel takes CUDA tensors, got '
                         '%s' % dev)
    if not 1 <= chunk <= 1024:
        raise ValueError('the dominance scan kernel takes a chunk in '
                         '[1, 1024], got %d' % chunk)
    D, L = elem_obj.shape
    T = op_elem.shape[1]
    elems = [x.to(torch.int32).contiguous() for x in (elem_obj, elem_rank)]
    ops = [x.to(torch.int32).contiguous()
           for x in (op_elem, op_obj, op_rank, op_delta)]
    valid = op_valid.to(torch.bool).contiguous()
    for x in elems + ops + [valid, vis0]:
        if x.device != dev:
            raise ValueError('dominance inputs must share one device')
    if any(x.shape != (D, L) for x in elems + [vis0]) or \
            any(x.shape != (D, T) for x in ops + [valid]):
        raise ValueError('dominance inputs must be [D, L] and [D, T]')
    vis = vis0.to(torch.float32).clone()
    index = torch.empty((D, T), dtype=torch.int32, device=dev)
    if D == 0 or T == 0:
        return index
    lib = _build.kernel('dominance_indexes')
    err = lib.amtpu_torch_dominance_scan(
        elems[0].data_ptr(), elems[1].data_ptr(), vis.data_ptr(),
        ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
        ops[3].data_ptr(), valid.data_ptr(), index.data_ptr(), D, L, T,
        chunk, _build.stream_of(vis))
    _build.check(err, 'dominance_indexes')
    trace.metric(SCAN_METRIC)
    return index


def indexes_by_object(elem_obj, elem_rank, vis0, op_elem, op_obj, op_rank,
                      op_delta, op_valid, grouped):
    """The regroup of `dominance_indexes_cuda` on the inputs' device
    around `grouped` (the kernel, or its plain version in the CPU
    tests)."""
    dev = elem_obj.device
    D, L = elem_obj.shape
    T = op_elem.shape[1]
    out = torch.zeros((D, T), dtype=torch.int32, device=dev)
    if D == 0 or L == 0 or T == 0:
        return out
    if not regroupable(elem_obj, elem_rank, vis0, op_elem, op_obj, op_rank,
                       op_delta, op_valid):
        raise ValueError('dominance_indexes inputs do not regroup by object '
                         '(see dominance_kernel.regroupable)')
    i64 = torch.int64
    n_obj = int(elem_obj.max()) + 1
    docs = torch.arange(D, device=dev, dtype=i64)
    # element rows: (doc, object), elements in index order
    uniq, e_row, e_pos = _runs((docs[:, None] * n_obj
                                + elem_obj.to(i64)).reshape(-1))
    O = uniq.shape[0]
    Lp = max(int(e_pos.max()) + 1, int(elem_rank.max()) + 1, 1)
    v0 = torch.zeros((O, Lp), dtype=torch.float32, device=dev)
    er = torch.full((O, Lp), -1, dtype=torch.int32, device=dev)
    v0[e_row, e_pos] = vis0.reshape(-1).to(torch.float32)
    er[e_row, e_pos] = elem_rank.reshape(-1).to(torch.int32)
    # op rows: the row of the touched element, ops in time order
    vd, vt = torch.nonzero(op_valid, as_tuple=True)
    flat_e = vd * L + op_elem[vd, vt].to(i64)
    o_row = e_row[flat_e]
    _, _, o_pos = _runs(o_row)
    n_t = int(o_pos.max()) + 1 if o_pos.numel() else 1
    Tp = (n_t + INDEXES_CHUNK - 1) // INDEXES_CHUNK * INDEXES_CHUNK
    oe = torch.full((O, Tp), -1, dtype=torch.int32, device=dev)
    orank = torch.full((O, Tp), -1, dtype=torch.int32, device=dev)
    od = torch.zeros((O, Tp), dtype=torch.int32, device=dev)
    ov = torch.zeros((O, Tp), dtype=torch.bool, device=dev)
    oe[o_row, o_pos] = e_pos[flat_e].to(torch.int32)
    orank[o_row, o_pos] = op_rank[vd, vt].to(torch.int32)
    od[o_row, o_pos] = op_delta[vd, vt].to(torch.int32)
    ov[o_row, o_pos] = True
    idx = grouped(v0, er, oe, orank, od, ov, chunk=INDEXES_CHUNK)
    out[vd, vt] = idx[o_row, o_pos]
    return out


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
