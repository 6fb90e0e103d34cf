"""The card's stable lexicographic sorts: the CUDA kernel and its switch.

`csrc/lexsort.cu` is one hand-written sort machine (LSD radix over the
bits that vary, one launch: one block with the permutation in shared
memory up to `ONE_CTA_MAX` rows, one cooperative launch above) with two
entry points, the two sorts the port runs on the card:

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
build or launch raises.
"""

import numbers

import torch

from .. import trace
from . import _build
from .list_rank import sibling_sort

#: launches of the CUDA kernel, either entry point (the trace counter)
LAUNCH_METRIC = 'launch.lexsort'
#: route (a)'s largest row count (`kOneCtaMax` in csrc/lexsort.cu): above
#: it the launch is cooperative and goes through `_build.serialized`
ONE_CTA_MAX = 4096


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


def _launch(dev, L, name, call):
    """[L] int32 from call(lib, out_ptr, scratch_ptr, stream), the kernel
    launched once on `dev`'s current stream (serialized with the card's
    other cooperative grids above ONE_CTA_MAX rows)."""
    out = torch.empty((L,), dtype=torch.int32, device=dev)
    if L == 0:
        return out
    lib = _build.kernel('lexsort')
    with torch.cuda.device(dev):
        n = lib.amtpu_torch_lexsort_scratch(L)
        if n < 0:
            raise RuntimeError('CUDA kernel lexsort: no cooperative grid on '
                               '%s' % dev)
        scratch = torch.empty((n,), dtype=torch.uint8, device=dev)

        def launch():
            return call(lib, out.data_ptr(), scratch.data_ptr(),
                        _build.stream_of(out))
        err = launch() if L <= ONE_CTA_MAX else _build.serialized(dev, launch)
    _build.check(err, name)
    trace.metric(LAUNCH_METRIC)
    return out


def sibling_sort_cuda(obj, parent, ctr, actor, valid):
    """The CUDA kernel's sibling sort; same arguments and output as
    `list_rank.sibling_sort` ([L] int32, bit-equal), the columns on one
    CUDA device.  One launch, nothing read back to the host."""
    cols = _check_sibling(obj, parent, ctr, actor, valid)
    dev = _device_of(obj)
    L = obj.shape[0]
    return _launch(dev, L, 'lexsort (sibling sort)',
                   lambda lib, out, scratch, stream:
                   lib.amtpu_torch_sibling_sort(
                       *[x.data_ptr() for x in cols], out, scratch, L,
                       stream))


def sibling_sort_auto(obj, parent, ctr, actor, valid):
    """The kernel on a CUDA device, `list_rank.sibling_sort` on the CPU;
    the outputs are bit-equal."""
    cols = _check_sibling(obj, parent, ctr, actor, valid)
    if obj.device.type == 'cuda':
        return sibling_sort_cuda(*cols)
    if obj.device.type != 'cpu':
        raise ValueError('no lexsort kernel for device %s' % obj.device)
    return sibling_sort(*cols)


def register_sort_cuda(rg, rt, n_groups):
    """The CUDA kernel's register order; same arguments and output as
    `parallel.mesh.register_order` ([D * T] int32, bit-equal), rg and rt
    on one CUDA device.  One launch, nothing read back to the host."""
    rg, rt, n_groups = _check_register(rg, rt, n_groups)
    dev = _device_of(rg)
    D, T = rg.shape
    return _launch(dev, D * T, 'lexsort (register sort)',
                   lambda lib, out, scratch, stream:
                   lib.amtpu_torch_register_sort(
                       rg.data_ptr(), rt.data_ptr(), out, scratch, D, T,
                       n_groups, stream))


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
