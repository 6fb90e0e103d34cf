"""Kernel and torch-op enqueue per batch or flush, as the host sees it:
span `device.launch` (its tensors uploaded before it opens); None where
the program has no such span or no call was made."""

from benchmark import stats


def read(run):
    if 'device.launch' not in run.spans:
        return None
    return stats.span_ms_per_call(run, 'device.launch')
