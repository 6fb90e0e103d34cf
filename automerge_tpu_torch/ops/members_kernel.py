"""Member-window register resolution: the CUDA kernel and its switch.

`resolve_registers_members_cuda` launches `csrc/members.cu` (K3), the
hand-written form of `automerge_tpu/ops/registers.py::
resolve_registers_members`, which the JAX package leaves to XLA.  It
serves the pool's member-mode base dispatch (W = WINDOW) and every tier
of the escalation ladder (W = 16 ... 1024).
`resolve_registers_members_auto` picks by device: the kernel for CUDA
tensors, the plain version `registers.resolve_registers_members` for
CPU tensors.  There is no other route: a kernel that fails to build or
launch raises.
"""

import torch

from .. import trace
from . import _build
from .registers import WINDOW, resolve_registers_members

#: launches of the CUDA kernel (the trace counter's name)
LAUNCH_METRIC = 'launch.members'
#: window widths the kernel is instantiated for (csrc/members.cu): the
#: base member window and every tier of the escalation ladder
KERNEL_WINDOWS = (WINDOW, 16, 32, 64, 128, 256, 512, 1024)


def _check_window(mem_idx, window):
    if window not in KERNEL_WINDOWS:
        raise ValueError('the member kernel takes a window in %s, got %d'
                         % (KERNEL_WINDOWS, window))
    if mem_idx.dim() != 2 or mem_idx.shape[1] != window:
        raise ValueError('mem_idx must be [T, %d], got %s'
                         % (window, tuple(mem_idx.shape)))


def _check_inputs(cols, mem_idx, is_del, clock_table):
    dev = clock_table.device
    if dev.type != 'cuda':
        raise ValueError('the member kernel takes CUDA tensors, got %s' % dev)
    T = cols[0].shape[0]
    for col in cols + [mem_idx]:
        if col.dtype != torch.int32 or col.shape[0] != T or \
                col.device != dev:
            raise ValueError('member columns must be [T] / [T, W] int32 on '
                             '%s' % dev)
    if is_del.dtype != torch.bool or is_del.shape != (T,) or \
            is_del.device != dev:
        raise ValueError('is_del must be [T] bool on %s' % dev)
    if clock_table.dtype != torch.int32 or clock_table.dim() != 2:
        raise ValueError('clock_table must be [C, A] int32')
    if T and clock_table.numel() == 0:
        raise ValueError('clock_table is empty')


def resolve_registers_members_cuda(time, actor, seq, mem_idx, is_del,
                                   clock_table, clock_idx, window=WINDOW,
                                   want_visible_before=True):
    """The CUDA kernel; same arguments and outputs as
    `registers.resolve_registers_members` (`alive_after` unsaturated,
    `overflow` all false).  Inputs must lie on one CUDA device."""
    _check_window(mem_idx, window)
    cols = [c.contiguous() for c in (time, actor, seq, clock_idx)]
    mem_idx = mem_idx.contiguous()
    is_del = is_del.contiguous()
    clock_table = clock_table.contiguous()
    _check_inputs(cols, mem_idx, is_del, clock_table)
    time, actor, seq, clock_idx = cols
    T = time.shape[0]
    dev = time.device
    out = {
        'winner': torch.empty((T,), dtype=torch.int32, device=dev),
        'conflicts': torch.empty((T, window), dtype=torch.int32, device=dev),
        'alive_after': torch.empty((T,), dtype=torch.int32, device=dev),
        'overflow': torch.empty((T,), dtype=torch.bool, device=dev),
        'packed': torch.empty((T,), dtype=torch.int32, device=dev),
    }
    if want_visible_before:
        out['visible_before'] = torch.empty((T,), dtype=torch.bool,
                                            device=dev)
    if T == 0:
        return out
    lib = _build.kernel('members')
    err = lib.amtpu_torch_members(
        time.data_ptr(), actor.data_ptr(), seq.data_ptr(),
        clock_idx.data_ptr(), is_del.data_ptr(), mem_idx.data_ptr(),
        clock_table.data_ptr(), out['winner'].data_ptr(),
        out['conflicts'].data_ptr(), out['alive_after'].data_ptr(),
        out['visible_before'].data_ptr() if want_visible_before else None,
        out['overflow'].data_ptr(), out['packed'].data_ptr(), T, window,
        clock_table.shape[1], _build.stream_of(time))
    _build.check(err, 'members')
    trace.metric(LAUNCH_METRIC)
    return out


def resolve_registers_members_auto(time, actor, seq, mem_idx, is_del,
                                   clock_table, clock_idx, window=WINDOW,
                                   want_visible_before=True):
    """The kernel on a CUDA device, the plain version on the CPU; the
    outputs are bit-equal.  Both reject a window the kernel is not
    instantiated for."""
    _check_window(mem_idx, window)
    if time.device.type == 'cuda':
        return resolve_registers_members_cuda(
            time, actor, seq, mem_idx, is_del, clock_table, clock_idx,
            window=window, want_visible_before=want_visible_before)
    if time.device.type != 'cpu':
        raise ValueError('no member kernel for device %s' % time.device)
    return resolve_registers_members(
        time, actor, seq, mem_idx, is_del, clock_table, clock_idx,
        window=window, want_visible_before=want_visible_before)
