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

#: largest L whose int32 visibility + rank rows (8 * L bytes) the kernel
#: keeps in shared memory (227 KB per block on Hopper, minus headroom);
#: longer objects keep visibility in a global scratch row
SMEM_MAX_L = 25600


def dominance_grouped_cuda(vis0, elem_rank, op_elem, op_rank, op_delta,
                           op_valid, chunk=64):
    """The CUDA kernel; same arguments and output as
    `list_rank.dominance_grouped`.  Inputs must lie on one CUDA device."""
    if vis0.device.type != 'cuda':
        raise ValueError('the dominance kernel takes CUDA tensors, got %s'
                         % vis0.device)
    O, L = vis0.shape
    T = op_elem.shape[1]
    if T % chunk != 0 or not 1 <= chunk <= 128:
        raise ValueError('T=%d must be a multiple of chunk=%d (<= 128)'
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
    use_smem = L <= SMEM_MAX_L
    scratch = None if use_smem else torch.empty(
        (O, L), dtype=torch.int32, device=vis0.device)
    lib = _build.kernel('dominance')
    err = lib.amtpu_torch_dominance(
        vis0.data_ptr(), elem_rank.data_ptr(), ops[0].data_ptr(),
        ops[1].data_ptr(), ops[2].data_ptr(), op_valid.data_ptr(),
        index.data_ptr(), None if scratch is None else scratch.data_ptr(),
        O, L, T, chunk, 1 if use_smem else 0, _build.stream_of(vis0))
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
