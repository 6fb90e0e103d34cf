"""The host's CPU time over the window, read by the benchmark itself.

Every cell is bound by the host.  `cpu_s()` is the process's CPU
seconds, user and system, of all its threads (`getrusage`), the port's
C++ threads with them; read at the window's ends, it gives the host work
a call costs, apart from the time a call waits.
"""

import resource


def cpu_s():
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime
