"""Entry points of the port's serving fleet, run as modules:

  * ``python -m automerge_tpu_torch.tools.amtpu_replica`` -- a
    materialized read replica over one gateway (``--device cuda|cpu``);
  * ``python -m automerge_tpu_torch.tools.amtpu_fleet`` -- the merged
    observability view of N replicas' HTTP listeners;
  * ``python -m automerge_tpu_torch.tools.amtpu_top`` -- a live view of
    one server (``--fleet`` for N);
  * ``python -m automerge_tpu_torch.tools.amtpu_trace`` -- cross-process
    trace trees from per-process span files.

`proc.py` spawns and stops the port's server subprocesses.
"""
