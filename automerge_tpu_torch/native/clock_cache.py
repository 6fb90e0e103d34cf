"""Device-resident copy of a pool's clock table.

`native/core.cpp` persists the densified all_deps rows of applied
changes across batches (struct ResClock); rows are immutable once
written, so the device copy only needs the rows appended since the last
batch.  Consistency rides the C++ generation counter:

* gen and Ap unchanged, n_rows grew: copy rows [cached_n, n_rows) into
  the table in place (`index_copy_`);
* gen bumped (rollback, new actor, row-cap restart), Ap changed, or
  n_rows shrank: full upload at a pow2 row capacity;
* n_rows outgrew the capacity with gen/Ap unchanged: the table grows on
  the device (device-to-device copy into the next pow2 bucket), then
  takes the delta;
* n_rows unchanged: no upload at all.

Every upload goes from a private host copy of the C++ rows, never a
view of them: the C++ buffer may be reallocated or freed while an
asynchronous copy is still reading.  The table is handed to the register
kernels in place of the batch-local clock table; batch `clock_idx`
columns then index pool-global rows.
"""

import ctypes

import numpy as np
import torch

from .. import trace
from ..analysis import sanitize
from ..ops import registers as register_ops


def _bucket_pow2(n, floor):
    b = floor
    while b < n:
        b *= 2
    return b


class PoolClockCache:
    """Device copy of one pool's ResClock table."""

    __slots__ = ('device', 'tab', 'gen', 'n', 'ap', 'cap')

    def __init__(self, device):
        self.device = device
        self.tab = None
        self.gen = -1
        self.n = 0
        self.ap = 0
        self.cap = 0

    def table(self, L, pool):
        """The device table [cap, max(Ap, 1)] covering the pool's current
        rows.  Call once per batch, after begin."""
        info = (ctypes.c_int64 * 4)()
        L.amtpu_resclk_info(pool, info)
        n, ap, gen = int(info[0]), int(info[1]), int(info[2])
        need_full = (self.tab is None or gen != self.gen
                     or ap != self.ap or n < self.n)
        if not need_full and n > self.cap:
            cap = _bucket_pow2(n, floor=64)
            grown = torch.zeros((cap, self.tab.shape[1]), dtype=torch.int32,
                                device=self.device)
            grown[:self.cap] = self.tab
            self.tab, self.cap = grown, cap
            trace.metric('resident.batch_grow_uploads')
        if need_full:
            if gen != self.gen and self.tab is not None:
                trace.metric('resident.batch_gen_invalidation')
            cap = _bucket_pow2(max(n, 1), floor=64)
            host = np.zeros((cap, max(ap, 1)), np.int32)
            if n:
                host[:n] = np.ctypeslib.as_array(L.amtpu_resclk_tab(pool),
                                                 shape=(n, ap))
            self.tab = register_ops.upload(host, self.device)
            self.cap = cap
            trace.metric('resident.batch_full_uploads')
            trace.metric('resident.batch_full_upload_rows', n)
        elif n > self.n:
            src = np.ctypeslib.as_array(L.amtpu_resclk_tab(pool),
                                        shape=(n, ap))
            rows = np.zeros((n - self.n, self.tab.shape[1]), np.int32)
            rows[:, :ap] = src[self.n:n]
            idx = torch.arange(self.n, n, device=self.device)
            self.tab.index_copy_(0, idx, register_ops.upload(rows,
                                                          self.device))
            # the upload took a private copy (a synchronous pageable copy
            # on a card, `index_copy_` itself on the CPU), so the staging
            # rows are dead here: armed, the sanitizer poisons them, and
            # any alias of them in the table shows as wrong bytes
            sanitize.poison(rows)
            trace.metric('resident.batch_hits')
            trace.metric('resident.batch_delta_rows', n - self.n)
        else:
            # every clock row of this batch was already resident
            trace.metric('resident.batch_hits')
            trace.metric('resident.batch_noop')
        self.gen, self.n, self.ap = gen, n, ap
        return self.tab

    def drop_if_disabled(self, L, pool):
        """Releases the table once C++ disabled the pool's resident clock
        cache for good (actor population past its cap)."""
        if self.tab is None:
            return
        info = (ctypes.c_int64 * 4)()
        L.amtpu_resclk_info(pool, info)
        if int(info[3]):
            self.tab = None
            self.gen = -1
            self.n = self.ap = self.cap = 0
            trace.metric('resident.batch_cache_dropped')
