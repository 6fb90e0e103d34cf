"""RGA list linearization: the CUDA kernel and its switch.

`linearize_cuda` launches `csrc/linearize.cu`, the hand-written form of
`automerge_tpu/ops/list_rank.py::linearize`, which the JAX package
leaves to XLA, in one launch (one block with the state in shared memory
up to 8,192 elements, one cooperative launch above), where the plain
version `list_rank.linearize` issues every round from the host.  On a
well-formed forest with enough rounds (every caller's arena) the kernel
ranks an Euler tour of each object by walks between hashed splitters;
on any other input it runs the plain version's pointer-doubling rounds;
both give the plain version's ranks.  `linearize_auto` picks by
device: the kernel for CUDA tensors, the plain version for CPU tensors.
A kernel that fails to build or launch raises.
"""

import numbers

import torch

from .. import trace
from . import _build, lexsort_kernel
from .list_rank import linearize

#: launches of the CUDA kernel (the trace counter's name)
LAUNCH_METRIC = 'launch.linearize'
#: the route readout `linearize_cuda(..., info=)` fills, int32 words:
#: the route (1 the tour, 0 the rounds), route (b) (1) or (a) (0), the
#: barriers run (grid barriers on route b, block barriers on route a),
#: the longest walk over the tour and over the level-1 slots (route b),
#: the splitters ranked by pointer doubling and its rounds, why the
#: rounds ran (bits), then ns from the kernel's start to its first 5
#: barriers, to route (b)'s splitters loaded and ranked, and to its end
#: (`tests/torch_linearize_cases.py`'s INFO_* name the words)
INFO_WORDS = 16
#: the kernel's largest L (its tour's half-edge indices fit 31 bits)
MAX_L = (1 << 30) - 1


def linearize_cuda(obj, parent, ctr, actor, valid, n_iters, sort_idx=None,
                   info=None):
    """The CUDA kernel; same arguments and output as
    `list_rank.linearize`: rank [L] int32, bit-equal to the plain
    version at any n_iters >= 0.  Inputs lie on one CUDA device: obj,
    parent, ctr, actor and sort_idx [L] int32, valid [L] bool, L <=
    MAX_L; sort_idx, when given, is a permutation of [0, L) (the host's
    sibling sort); None sorts on the card
    (`lexsort_kernel.sibling_sort_cuda`, the hand-written form of
    `list_rank.sibling_sort`).  `info`, an int32 [INFO_WORDS] tensor on
    the same device, gets the route readout (the main path passes None).
    The kernel reads obj, parent, valid and the sort; ctr and actor only
    feed the sort.  Nothing is read back to the host."""
    if obj.dim() != 1:
        raise ValueError('obj must be [L], got %s' % (tuple(obj.shape),))
    L = obj.shape[0]
    if L > MAX_L:
        raise ValueError('the linearize kernel takes L <= %d, got %d'
                         % (MAX_L, L))
    if not isinstance(n_iters, numbers.Integral) or \
            isinstance(n_iters, bool) or n_iters < 0:
        raise ValueError('n_iters must be an integer >= 0, got %r'
                         % (n_iters,))
    cols = [x.contiguous() for x in (obj, parent, ctr, actor)]
    valid = valid.contiguous()
    if any(x.dtype != torch.int32 or tuple(x.shape) != (L,) for x in cols):
        raise ValueError('obj, parent, ctr and actor must be [L] int32')
    if valid.dtype != torch.bool or tuple(valid.shape) != (L,):
        raise ValueError('valid must be [L] bool')
    if sort_idx is not None and (sort_idx.dtype != torch.int32
                                 or tuple(sort_idx.shape) != (L,)):
        raise ValueError('sort_idx must be [L] int32')
    if info is not None and (info.dtype != torch.int32 or tuple(
            info.shape) != (INFO_WORDS,) or not info.is_contiguous()):
        raise ValueError('info must be a contiguous [%d] int32 tensor'
                         % INFO_WORDS)
    dev = obj.device
    if dev.type != 'cuda':
        raise ValueError('the linearize kernel takes CUDA tensors, got %s'
                         % dev)
    if any(x.device != dev for x in cols + [valid] + (
            [] if sort_idx is None else [sort_idx]) + (
            [] if info is None else [info])):
        raise ValueError('linearize inputs must share one device')
    sort_idx = lexsort_kernel.sibling_sort_cuda(*cols, valid) \
        if sort_idx is None else sort_idx.contiguous()
    rank = torch.empty((L,), dtype=torch.int32, device=dev)
    if L == 0:
        return rank
    lib = _build.kernel('linearize')
    words = lib.amtpu_torch_linearize_scratch(L)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev) \
        if words else None

    def launch():
        return lib.amtpu_torch_linearize(
            cols[0].data_ptr(), cols[1].data_ptr(), valid.data_ptr(),
            sort_idx.data_ptr(), rank.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if info is None else info.data_ptr(), L, int(n_iters),
            _build.stream_of(rank))
    with torch.cuda.device(dev):
        err = launch() if scratch is None else _build.serialized(dev,
                                                                   launch)
    _build.check(err, 'linearize')
    trace.metric(LAUNCH_METRIC)
    return rank


def linearize_auto(obj, parent, ctr, actor, valid, n_iters, sort_idx=None):
    """The kernel on a CUDA device, the plain version on the CPU; the
    outputs are bit-equal."""
    if obj.device.type == 'cuda':
        return linearize_cuda(obj, parent, ctr, actor, valid, n_iters,
                              sort_idx=sort_idx)
    if obj.device.type != 'cpu':
        raise ValueError('no linearize kernel for device %s' % obj.device)
    return linearize(obj, parent, ctr, actor, valid, n_iters,
                     sort_idx=sort_idx)
