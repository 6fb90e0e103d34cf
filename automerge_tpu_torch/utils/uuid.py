"""UUID provider with a swappable factory, mirroring the reference's
deterministic-test hook (`src/uuid.js:1-12`)."""

import uuid as _uuid

_default_factory = lambda: str(_uuid.uuid4())
_factory = _default_factory


def uuid():
    return _factory()


def set_factory(factory):
    global _factory
    _factory = factory


def reset():
    global _factory
    _factory = _default_factory


# camelCase alias for API parity with the reference
setFactory = set_factory
