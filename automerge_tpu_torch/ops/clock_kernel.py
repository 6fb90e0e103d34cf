"""Causal scheduling: the CUDA kernel and its switch.

`schedule_queue_cuda` launches `csrc/clock.cu`, the hand-written form of
`automerge_tpu/ops/clock.py::schedule_queue_batch`, which the JAX package
leaves to XLA; `schedule_queue_auto` picks by device: the kernel for CUDA
tensors, the plain version `clock.schedule_queue_batch` for CPU tensors.
A kernel that fails to build or launch raises.
"""

import torch

from .. import trace
from . import _build
from .clock import schedule_queue_batch

#: launches of the CUDA kernel (the trace counter's name)
LAUNCH_METRIC = 'launch.schedule'


def schedule_queue_cuda(clock, actor, seq, deps, valid):
    """The CUDA kernel; same arguments and outputs as
    `clock.schedule_queue_batch`.  Inputs must lie on one CUDA device;
    actor ranks lie in [-1, A)."""
    dev = clock.device
    if dev.type != 'cuda':
        raise ValueError('the schedule kernel takes CUDA tensors, got %s'
                         % dev)
    if clock.dim() != 2 or actor.dim() != 2:
        raise ValueError('clock must be [D, A] and actor [D, C]')
    D, A = clock.shape
    C = actor.shape[1]
    cols = [x.contiguous() for x in (clock, actor, seq, deps)]
    valid = valid.contiguous()
    for x, shape in zip(cols, ((D, A), (D, C), (D, C), (D, C, A))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape or \
                x.device != dev:
            raise ValueError('schedule inputs must be int32 clock [D, A], '
                             'actor/seq [D, C] and deps [D, C, A] on %s'
                             % dev)
    if valid.dtype != torch.bool or tuple(valid.shape) != (D, C) or \
            valid.device != dev:
        raise ValueError('valid must be [D, C] bool on %s' % dev)
    order = torch.empty((D, C), dtype=torch.int32, device=dev)
    new_clock = torch.empty((D, A), dtype=torch.int32, device=dev)
    if D == 0:
        return order, new_clock
    if A == 0:
        raise ValueError('the schedule kernel needs at least one actor')
    lib = _build.kernel('clock')
    err = lib.amtpu_torch_schedule(
        cols[0].data_ptr(), cols[1].data_ptr(), cols[2].data_ptr(),
        cols[3].data_ptr(), valid.data_ptr(), order.data_ptr(),
        new_clock.data_ptr(), D, C, A, _build.stream_of(clock))
    _build.check(err, 'clock')
    trace.metric(LAUNCH_METRIC)
    return order, new_clock


def schedule_queue_auto(clock, actor, seq, deps, valid):
    """The kernel on a CUDA device, the plain version on the CPU; the
    outputs are bit-equal."""
    if clock.device.type == 'cuda':
        return schedule_queue_cuda(clock, actor, seq, deps, valid)
    if clock.device.type != 'cpu':
        raise ValueError('no schedule kernel for device %s' % clock.device)
    return schedule_queue_batch(clock, actor, seq, deps, valid)
