"""Sliding-window register resolution: the CUDA kernel and its switch.

`resolve_registers_cuda` launches `csrc/registers.cu` (the port of the
TPU kernel `automerge_tpu/ops/pallas_registers.py::_kernel`);
`resolve_registers_auto` picks by device: the kernel for CUDA tensors,
the plain version `registers.resolve_registers` for CPU tensors.  There
is no other route: a kernel that fails to build or launch raises.
"""

import torch

from .. import trace
from . import _build
from .registers import SLIDING_MAX, WINDOW, resolve_registers

#: launches of the CUDA kernel (the trace counter's name)
LAUNCH_METRIC = 'launch.registers'
#: window widths the kernel is instantiated for (csrc/registers.cu): the
#: powers of two the pool picks, up to SLIDING_MAX
KERNEL_WINDOWS = (2, 4, WINDOW, SLIDING_MAX)


def _check_inputs(cols, is_del, clock_table, window):
    if window not in KERNEL_WINDOWS:
        raise ValueError('the register kernel takes a window in %s, got %d'
                         % (KERNEL_WINDOWS, window))
    dev = clock_table.device
    if dev.type != 'cuda':
        raise ValueError('the register kernel takes CUDA tensors, got %s'
                         % dev)
    T = cols[0].shape[0]
    for col in cols:
        if col.dtype != torch.int32 or col.shape != (T,) or \
                col.device != dev:
            raise ValueError('register columns must be [T] int32 on %s'
                             % dev)
    if is_del.dtype != torch.bool or is_del.shape != (T,):
        raise ValueError('is_del must be [T] bool')
    if clock_table.dtype != torch.int32 or clock_table.dim() != 2:
        raise ValueError('clock_table must be [C, A] int32')


def resolve_registers_cuda(group, time, actor, seq, is_del, sort_idx,
                           clock_table, clock_idx, window=WINDOW):
    """The CUDA kernel; same arguments and outputs as
    `registers.resolve_registers`.  Inputs must lie on one CUDA device;
    sort_idx must be a permutation of [0, T) (every row is written)."""
    cols = [c.contiguous() for c in (group, time, actor, seq, sort_idx,
                                     clock_idx)]
    is_del = is_del.contiguous()
    clock_table = clock_table.contiguous()
    _check_inputs(cols, is_del, clock_table, window)
    group, time, actor, seq, sort_idx, clock_idx = cols
    T = group.shape[0]
    dev = group.device
    out = {
        'winner': torch.empty((T,), dtype=torch.int32, device=dev),
        'conflicts': torch.empty((T, window), dtype=torch.int32, device=dev),
        'alive_after': torch.empty((T,), dtype=torch.int32, device=dev),
        'visible_before': torch.empty((T,), dtype=torch.bool, device=dev),
        'overflow': torch.empty((T,), dtype=torch.bool, device=dev),
        'packed': torch.empty((T,), dtype=torch.int32, device=dev),
    }
    if T == 0:
        return out
    lib = _build.kernel('registers')
    err = lib.amtpu_torch_registers(
        group.data_ptr(), time.data_ptr(), actor.data_ptr(), seq.data_ptr(),
        is_del.data_ptr(), sort_idx.data_ptr(), clock_table.data_ptr(),
        clock_idx.data_ptr(), out['winner'].data_ptr(),
        out['conflicts'].data_ptr(), out['alive_after'].data_ptr(),
        out['visible_before'].data_ptr(), out['overflow'].data_ptr(),
        out['packed'].data_ptr(), T, window, clock_table.shape[1],
        _build.stream_of(group))
    _build.check(err, 'registers')
    trace.metric(LAUNCH_METRIC)
    return out


def resolve_registers_auto(group, time, actor, seq, is_del, alive_in,
                           sort_idx, clock_table, clock_idx, window=WINDOW):
    """The kernel on a CUDA device, the plain version on the CPU; the
    outputs are bit-equal.  Like the TPU kernel, this assumes every row
    starts alive: `alive_in` must be None or all true."""
    if alive_in is not None and not bool(torch.as_tensor(alive_in).all()):
        raise ValueError('resolve_registers_auto assumes alive_in is all '
                         'true')
    if group.device.type == 'cuda':
        return resolve_registers_cuda(group, time, actor, seq, is_del,
                                      sort_idx, clock_table, clock_idx,
                                      window=window)
    if group.device.type != 'cpu':
        raise ValueError('no register kernel for device %s' % group.device)
    return resolve_registers(group, time, actor, seq, is_del, sort_idx,
                             clock_table, clock_idx, window=window)
