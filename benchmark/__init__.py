"""The benchmark of the PyTorch and CUDA port (`automerge_tpu_torch`).

Run one cell with `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of the repository; see
`run.py`."""
