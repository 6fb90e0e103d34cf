"""The plain reference: the op set, the patch comparer and the judges.

It imports nothing of `automerge_tpu_torch`, `automerge_tpu` or JAX."""
