"""Ops applied per second over the whole window."""

from benchmark import stats


def read(run):
    return stats.rate(run.work['ops'], run.window_s)
