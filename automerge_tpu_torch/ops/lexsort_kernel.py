"""The card's stable lexicographic sorts: the CUDA kernel and its switch.

`csrc/lexsort.cu` is one hand-written sort machine (LSD radix over the
bits that vary, one launch: a thread-block cluster with the rows in its
CTAs' shared memory up to the cluster's capacity, one cooperative launch
above; the register order's docs sorted each within its own rows where
every group id is in range) with two entry points, the two sorts the
port runs on the card:

- `sibling_sort_cuda`: the sibling sort under RGA linearize, the
  permutation of np.lexsort((-actor, -ctr, parent, where(valid, obj,
  2**30))); plain version `list_rank.sibling_sort` (four stable torch
  sorts; the JAX package's `jnp.lexsort` at
  `automerge_tpu/ops/list_rank.py:73`);
- `register_sort_cuda`: the step's register order, rows of D docs by
  (doc, group, time) with each doc's padding first; plain version
  `parallel/mesh.py::register_order` (two stable torch sorts; the JAX
  step's `jnp.lexsort((time, group))` per doc,
  `automerge_tpu/ops/registers.py:267`).

Each `*_auto` runs the kernel for CUDA tensors and the plain version for
CPU tensors, and raises on any other device.  A kernel that fails to
build or launch raises.  `info=` (an int32 [INFO_WORDS] tensor on the
same device; the main path passes None) gets the route readout:
`readout(info)` names its words.
"""

import numbers

import torch

from .. import trace
from . import _build
from .list_rank import sibling_sort

#: launches of the CUDA kernel, either entry point (the trace counter)
LAUNCH_METRIC = 'launch.lexsort'
#: a CTA's most rows (`kTileMax` in csrc/lexsort.cu): the cluster route
#: holds up to this times the largest cluster the card schedules (16 or
#: 8 CTAs); above it the launch is cooperative (the only one that asks for
#: scratch) and goes through `_build.serialized`
TILE_MAX = 4096
#: the cluster's rows a CTA it aims at (`kClusterRows`)
CLUSTER_ROWS = 1024
#: the route readout's int32 words (`Info` in csrc/lexsort.cu), in order,
#: then ns from the kernel's start (CTA or block 0) to its plan, to the
#: end of each of its first STAMP_PASSES passes (0: not reached; on the
#: grid, skipped) and to its end
INFO_FIELDS = ('route', 'ctas', 'digit_bits', 'bits', 'passes', 'run',
               'skipped', 'barriers', 'in_range', 'rows', 'tiles',
               'cluster_max')
STAMP_PASSES = 8
INFO_WORDS = len(INFO_FIELDS) + STAMP_PASSES + 2
#: the readout's route codes (`Route`)
ROUTES = ('cluster', 'grid', 'warp', 'block')


def _check_sibling(obj, parent, ctr, actor, valid):
    """The sibling sort's columns, contiguous: obj, parent, ctr, actor
    [L] int32 and valid [L] bool on one device."""
    if obj.dim() != 1:
        raise ValueError('obj must be [L], got %s' % (tuple(obj.shape),))
    L = obj.shape[0]
    cols = [x.contiguous() for x in (obj, parent, ctr, actor)]
    if any(x.dtype != torch.int32 or tuple(x.shape) != (L,) for x in cols):
        raise ValueError('obj, parent, ctr and actor must be [L] int32')
    if valid.dtype != torch.bool or tuple(valid.shape) != (L,):
        raise ValueError('valid must be [L] bool')
    if any(x.device != obj.device for x in cols + [valid]):
        raise ValueError('sibling sort inputs must share one device')
    return cols + [valid.contiguous()]


def _check_register(rg, rt, n_groups):
    """The register order's columns, contiguous: rg, rt [D, T] int32 on
    one device; n_groups an integer >= 0 (the host's bound)."""
    if rg.dim() != 2 or rg.dtype != torch.int32:
        raise ValueError('rg must be [D, T] int32, got %s %s'
                         % (tuple(rg.shape), rg.dtype))
    if rt.dtype != torch.int32 or rt.shape != rg.shape:
        raise ValueError('rt must be [D, T] int32 like rg')
    if rt.device != rg.device:
        raise ValueError('register sort inputs must share one device')
    if not isinstance(n_groups, numbers.Integral) or \
            isinstance(n_groups, bool) or n_groups < 0:
        raise ValueError('n_groups must be an integer >= 0, got %r'
                         % (n_groups,))
    return rg.contiguous(), rt.contiguous(), int(n_groups)


def _device_of(x):
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError('the lexsort kernel takes CUDA tensors, got %s'
                         % dev)
    return dev


def _check_info(info, dev):
    if info is not None and (info.dtype != torch.int32 or tuple(
            info.shape) != (INFO_WORDS,) or not info.is_contiguous()
            or info.device != dev):
        raise ValueError('info must be a contiguous [%d] int32 tensor on %s'
                         % (INFO_WORDS, dev))


def readout(info):
    """The route readout as a dict: `route` by name (ROUTES), `skipped`
    the list of skipped passes, `plan_ns`, `pass_ns` (each pass's end)
    and `end_ns`, the other words as ints."""
    words = [int(x) for x in info.tolist()]
    out = dict(zip(INFO_FIELDS, words))
    out['route'] = ROUTES[out['route']]
    out['skipped'] = [q for q in range(32) if out['skipped'] >> q & 1]
    at = len(INFO_FIELDS)
    out['plan_ns'] = words[at]
    out['pass_ns'] = words[at + 1:at + 1 + min(out['passes'],
                                                STAMP_PASSES)]
    out['end_ns'] = words[at + 1 + STAMP_PASSES]
    return out


def _launch(dev, L, name, call, info):
    """[L] int32 from call(lib, out_ptr, scratch_ptr, info_ptr, stream),
    the kernel launched once on `dev`'s current stream; a launch that asks
    for scratch is the cooperative grid, serialized with the card's other
    cooperative grids."""
    _check_info(info, dev)
    out = torch.empty((L,), dtype=torch.int32, device=dev)
    if L == 0:
        return out
    lib = _build.kernel('lexsort')
    with torch.cuda.device(dev):
        n = lib.amtpu_torch_lexsort_scratch(L)
        if n < 0:
            raise RuntimeError('CUDA kernel lexsort: no route on %s' % dev)
        scratch = torch.empty((n,), dtype=torch.uint8, device=dev) \
            if n else None

        def launch():
            return call(lib, out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        None if info is None else info.data_ptr(),
                        _build.stream_of(out))
        err = launch() if scratch is None else _build.serialized(dev, launch)
    _build.check(err, name)
    trace.metric(LAUNCH_METRIC)
    return out


def sibling_sort_cuda(obj, parent, ctr, actor, valid, info=None):
    """The CUDA kernel's sibling sort; same arguments and output as
    `list_rank.sibling_sort` ([L] int32, bit-equal), the columns on one
    CUDA device; `info` gets the route readout.  One launch, nothing read
    back to the host."""
    cols = _check_sibling(obj, parent, ctr, actor, valid)
    dev = _device_of(obj)
    L = obj.shape[0]
    return _launch(dev, L, 'lexsort (sibling sort)',
                   lambda lib, out, scratch, inf, stream:
                   lib.amtpu_torch_sibling_sort(
                       *[x.data_ptr() for x in cols], out, scratch, inf, L,
                       stream), info)


def sibling_sort_auto(obj, parent, ctr, actor, valid):
    """The kernel on a CUDA device, `list_rank.sibling_sort` on the CPU;
    the outputs are bit-equal."""
    cols = _check_sibling(obj, parent, ctr, actor, valid)
    if obj.device.type == 'cuda':
        return sibling_sort_cuda(*cols)
    if obj.device.type != 'cpu':
        raise ValueError('no lexsort kernel for device %s' % obj.device)
    return sibling_sort(*cols)


def register_sort_cuda(rg, rt, n_groups, info=None):
    """The CUDA kernel's register order; same arguments and output as
    `parallel.mesh.register_order` ([D * T] int32, bit-equal), rg and rt
    on one CUDA device; `info` gets the route readout.  One launch,
    nothing read back to the host."""
    rg, rt, n_groups = _check_register(rg, rt, n_groups)
    dev = _device_of(rg)
    D, T = rg.shape
    return _launch(dev, D * T, 'lexsort (register sort)',
                   lambda lib, out, scratch, inf, stream:
                   lib.amtpu_torch_register_sort(
                       rg.data_ptr(), rt.data_ptr(), out, scratch, inf, D,
                       T, n_groups, stream), info)


def register_sort_auto(rg, rt, n_groups):
    """The kernel on a CUDA device, `parallel.mesh.register_order` on the
    CPU; the outputs are bit-equal."""
    rg, rt, n_groups = _check_register(rg, rt, n_groups)
    if rg.device.type == 'cuda':
        return register_sort_cuda(rg, rt, n_groups)
    if rg.device.type != 'cpu':
        raise ValueError('no lexsort kernel for device %s' % rg.device)
    from ..parallel.mesh import register_order
    return register_order(rg, rt, n_groups)
