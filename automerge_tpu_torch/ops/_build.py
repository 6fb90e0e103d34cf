"""Builds and loads the package's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and compiles with
`nvcc` for Hopper (`sm_90a`) into its own shared library under
`build/automerge_tpu_torch/kernels/` (through `buildcache`: named by a
hash of the source and flags, built under a lock, renamed into place
when complete); it is loaded with ctypes at first use.  Tensors cross as
`data_ptr()` integers and the launch goes on PyTorch's current stream.
Every launching entry point returns the `cudaError_t` of its launch,
which `check` turns into an exception.  A failed build or launch raises:
nothing here falls back to another implementation.

`build_all()` starts one `nvcc` per source at once and waits for all of
them, so a cold start pays the slowest build, not the sum.

The kernels are not built with `torch.utils.cpp_extension.load`: that
compiles a pybind binding against PyTorch's headers (minutes per build,
against seconds for a plain C file) and needs `ninja`.  Nothing of the
kernels needs PyTorch's C++ API; the ctypes call takes raw pointers and
the stream.
"""

import ctypes
import os
import shutil
import threading

from .. import buildcache

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
BUILD_DIR = os.path.join(buildcache.BUILD_ROOT, 'kernels')
NVCC_FLAGS = ['-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

#: kernel name -> {C function: (restype, argtypes)}
KERNELS = {
    'registers': {
        'amtpu_torch_registers': (ctypes.c_int, [ctypes.c_void_p] * 14 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]),
    },
    'dominance': {
        'amtpu_torch_dominance': (ctypes.c_int, [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p]),
        'amtpu_torch_dominance_scratch': (ctypes.c_int64, [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]),
    },
    'members': {
        'amtpu_torch_members': (ctypes.c_int, [ctypes.c_void_p] * 13 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]),
    },
    'clock': {
        'amtpu_torch_schedule': (ctypes.c_int, [ctypes.c_void_p] * 7 + [
            ctypes.c_int64] * 3 + [ctypes.c_void_p]),
    },
    'dominance_indexes': {
        'amtpu_torch_route': (ctypes.c_int, [ctypes.c_void_p] * 11 + [
            ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]),
        'amtpu_torch_route_scratch': (ctypes.c_int64, [ctypes.c_int64] * 3),
    },
    'dominance_block': {
        'amtpu_torch_route_block': (ctypes.c_int, [ctypes.c_void_p] * 12 + [
            ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_void_p]),
        'amtpu_torch_route_block_scratch': (ctypes.c_int64, [
            ctypes.c_int64] * 4 + [ctypes.c_int]),
    },
    'linearize': {
        'amtpu_torch_linearize': (ctypes.c_int, [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]),
        'amtpu_torch_linearize_scratch': (ctypes.c_int64, [ctypes.c_int64]),
    },
    'lexsort': {
        'amtpu_torch_sibling_sort': (ctypes.c_int, [ctypes.c_void_p] * 7 + [
            ctypes.c_int64, ctypes.c_void_p]),
        'amtpu_torch_register_sort': (ctypes.c_int, [ctypes.c_void_p] * 4 + [
            ctypes.c_int64] * 3 + [ctypes.c_void_p]),
        'amtpu_torch_lexsort_scratch': (ctypes.c_int64, [ctypes.c_int64]),
    },
}

_loaded = {}

#: cooperative launches (the large-L routes of the linearize and lexsort
#: kernels) wait for the device's previous one when it went on another
#: stream: a grid barrier needs every block of its grid resident at once,
#: so two such grids must not share the card (the mesh pool launches from
#: one stream a chip thread)
_COOP_LOCK = threading.Lock()
#: device index -> (stream handle, event after the last cooperative launch)
_LAST_COOP = {}


def _nvcc():
    for home in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH'),
                 '/usr/local/cuda'):
        if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'automerge_tpu_torch build with the CUDA toolkit')
    return found


def _start(name):
    src = os.path.join(CSRC, name + '.cu')
    path = buildcache.artifact(BUILD_DIR, 'lib' + name, [src], NVCC_FLAGS)
    return buildcache.start(
        path, lambda out: [_nvcc()] + NVCC_FLAGS + [src, '-o', out],
        'csrc/%s.cu' % name)


def build_all():
    """Builds every kernel library in parallel; returns {name: path}."""
    started = {name: _start(name) for name in KERNELS}
    return {name: buildcache.finish(b) for name, b in started.items()}


def kernel(name):
    """The ctypes library of kernel `name`, built and loaded on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(buildcache.finish(_start(name)))
        for fn_name, (restype, argtypes) in KERNELS[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _loaded[name] = lib
    return lib


def check(err, name):
    """Raises when a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError('CUDA kernel %s failed to launch: cudaError %d'
                           % (name, err))


def serialized(dev, launch):
    """Runs launch() (a cooperative launch on `dev`'s current stream)
    after the device's previous cooperative launch, whichever kernel made
    it.  Under CUDA graph capture the replay's stream orders the
    launches."""
    import torch
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


def stream_of(tensor):
    """PyTorch's current CUDA stream on the tensor's device, as an int."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
