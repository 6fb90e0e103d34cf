"""The runtime alias sanitizer: the dynamic net behind `check_alias`.

The static checker sees lexical reuse of a captured buffer; this module
catches the rest at run time.  Armed, every staging buffer a site hands
to the device is poisoned (filled with a sentinel) as soon as the call
that consumed it returns.  The upload contract says the device received
a private copy, so the poison is invisible; if a path aliased the
buffer instead (a zero-copy `torch.from_numpy` on a CPU pool, an
asynchronous copy from page-locked memory still in flight on a card),
the device reads the sentinel and the byte comparisons fail loudly.

It is wired at one site, the pool-resident clock delta
(`native/clock_cache.py`), after `index_copy_` has returned: on a card
the upload there is a synchronous pageable copy, and on the CPU
`index_copy_` has copied the rows itself.

    sanitize.arm()              # before the batches to check
    ...
    sanitize.poison(rows)       # at the site; a no-op while disarmed

Disarmed, `poison` costs one module-attribute check.
"""

import numpy as np

#: the sentinel byte: int32 0x5B5B5B5B, a value no workload emits
POISON_BYTE = 0x5B

#: armed flag (`arm`); the port reads no environment variable
ARMED = False

_poisoned = 0


def arm(on=True):
    """Arms (or, with on=False, disarms) the sanitizer; returns the new
    state."""
    global ARMED
    ARMED = bool(on)
    return ARMED


def poison(*arrays):
    """Overwrites each writable numpy array with the sentinel while
    armed.  Call it on the host staging buffers right after the call
    that consumed them returns."""
    if not ARMED:
        return
    global _poisoned
    n = 0
    for a in arrays:
        if isinstance(a, np.ndarray) and a.flags.writeable and a.size:
            if a.flags.c_contiguous:
                a.view(np.uint8).fill(POISON_BYTE)
            else:
                # a strided view cannot be reinterpreted as bytes; the
                # elementwise sentinel still poisons every slot
                a.fill(POISON_BYTE)
            n += 1
    if n:
        _poisoned += n
        from .. import trace
        trace.count('sanitize.poisoned_buffers', n)


def poisoned_count():
    """Buffers poisoned since import."""
    return _poisoned
