"""Error types mirroring the reference's use of JS Error/RangeError/TypeError."""


class AutomergeError(Exception):
    pass


class RangeError(AutomergeError, ValueError):
    """Mirrors JS RangeError (invalid value / out of range)."""
