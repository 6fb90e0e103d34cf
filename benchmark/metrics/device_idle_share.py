"""Per cent of the traced window with no kernel, copy or fill on the
card."""

from benchmark import stats


def read(run):
    return stats.idle_share(run)
