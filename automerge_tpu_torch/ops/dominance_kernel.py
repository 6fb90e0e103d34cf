"""Per-object dominance indexes: the CUDA kernel and its switch.

`dominance_grouped_cuda` launches `csrc/dominance.cu` (the port of the
TPU kernel `automerge_tpu/ops/pallas_dominance.py::_kernel`);
`dominance_grouped_auto` picks by device: the kernel for CUDA tensors,
the plain version `list_rank.dominance_grouped` for CPU tensors.  A
kernel that fails to build or launch raises.
"""

import torch

from .. import trace
from . import _build
from .list_rank import dominance_grouped

#: launches of the CUDA kernel (the trace counter's name)
LAUNCH_METRIC = 'launch.dominance'


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
