"""The device dispatch per batch or flush as the host sees it: span
`device.dispatch` (uploads and kernel enqueues)."""

from benchmark import stats


def read(run):
    return stats.span_ms_per_call(run, 'device.dispatch')
