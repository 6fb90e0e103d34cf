"""automerge_tpu_torch: the batched CRDT apply path on PyTorch and CUDA.

A second package beside `automerge_tpu` (the JAX reference).  It imports
neither JAX nor `automerge_tpu`: the C++ host runtime is built from the
repository's `native/` sources into this package's own build directory,
and the register and dominance kernels are hand-written CUDA for Hopper
(`csrc/`), each beside its plain PyTorch version.

Entry point: `automerge_tpu_torch.native.NativeDocPool` (CUDA by
default; `device='cpu'` runs the plain versions).
"""
