"""Seconds from the harness's first statement to the first timed call:
imports, inputs drawn, the C++ core and kernels built or loaded, the
documents built and the traffic's shapes warmed up."""


def read(run):
    return run.setup_s
