"""RGA list linearization: the CUDA kernel and its switch.

`linearize_cuda` launches `csrc/linearize.cu`, the hand-written form of
`automerge_tpu/ops/list_rank.py::linearize`, which the JAX package
leaves to XLA: both pointer-doubling loops run on the card in one launch
(one block with the state in shared memory up to 12,288 elements, one
cooperative launch above), where the plain version `list_rank.linearize`
issues every round from the host.  `linearize_auto` picks by device: the
kernel for CUDA tensors, the plain version for CPU tensors.  A kernel
that fails to build or launch raises.
"""

import numbers
import threading

import torch

from .. import trace
from . import _build
from .list_rank import linearize, sibling_sort

#: launches of the CUDA kernel (the trace counter's name)
LAUNCH_METRIC = 'launch.linearize'

#: cooperative launches (the large-L route) wait for the device's
#: previous one when it went on another stream: a grid barrier needs every
#: block of its grid resident at once, so two such grids must not share
#: the card (the mesh pool launches from one stream a chip thread)
_COOP_LOCK = threading.Lock()
#: device index -> (stream handle, event after the last cooperative launch)
_LAST_COOP = {}


def _serialized(dev, launch):
    """Runs launch() (a cooperative launch on `dev`'s current stream)
    after the device's previous cooperative launch.  Under CUDA graph
    capture the replay's stream orders the launches."""
    stream = torch.cuda.current_stream(dev)
    if torch.cuda.is_current_stream_capturing():
        return launch()
    with _COOP_LOCK:
        last = _LAST_COOP.get(dev.index)
        if last is None:
            last = (stream.cuda_stream, torch.cuda.Event())
        elif last[0] != stream.cuda_stream:
            stream.wait_event(last[1])
        err = launch()
        last[1].record(stream)
        _LAST_COOP[dev.index] = (stream.cuda_stream, last[1])
    return err


def linearize_cuda(obj, parent, ctr, actor, valid, n_iters, sort_idx=None):
    """The CUDA kernel; same arguments and output as
    `list_rank.linearize`: rank [L] int32, bit-equal to the plain
    version at any n_iters >= 0.  Inputs lie on one CUDA device: obj,
    parent, ctr, actor and sort_idx [L] int32, valid [L] bool; sort_idx,
    when given, is a permutation of [0, L) (the host's sibling sort);
    None sorts on the card (`list_rank.sibling_sort`, torch's sort).
    The kernel reads obj, parent, valid and the sort; ctr and actor only
    feed the sort.  Nothing is read back to the host."""
    if obj.dim() != 1:
        raise ValueError('obj must be [L], got %s' % (tuple(obj.shape),))
    L = obj.shape[0]
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
    dev = obj.device
    if dev.type != 'cuda':
        raise ValueError('the linearize kernel takes CUDA tensors, got %s'
                         % dev)
    if any(x.device != dev for x in cols + [valid] + (
            [] if sort_idx is None else [sort_idx])):
        raise ValueError('linearize inputs must share one device')
    sort_idx = sibling_sort(*cols, valid) if sort_idx is None \
        else sort_idx.contiguous()
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
            None if scratch is None else scratch.data_ptr(), L,
            int(n_iters), _build.stream_of(rank))
    with torch.cuda.device(dev):
        err = launch() if scratch is None else _serialized(dev, launch)
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
