"""The process's CPU time per batch or flush over the window, in ms: user
and system, all threads, the port's C++ threads with them
(`getrusage`)."""


def read(run):
    if not run.attempted or run.cpu_s is None:
        return None
    return run.cpu_s * 1e3 / run.attempted
