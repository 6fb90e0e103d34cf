"""Device time of the port's own CUDA kernels per batch or flush, from
the profiler's trace."""

from benchmark import stats


def read(run):
    return stats.device_ms_per_call(run, 'kernel_s')
