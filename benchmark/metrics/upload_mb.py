"""Megabytes (1e6 bytes) uploaded to the card per batch or flush: the
port's phase counter `upload.bytes` (counted while span tracing is on);
None where the program has no such counter or no call was made."""


def read(run):
    if not run.attempted or 'upload.bytes' not in run.counters:
        return None
    return run.counters['upload.bytes'] / 1e6 / run.attempted
