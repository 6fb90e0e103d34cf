"""Plain-data snapshots of document trees (the analogue of the reference's
`JSON.parse(JSON.stringify(doc))`, `src/automerge.js:102-104`)."""

from datetime import datetime

from ..models.table import Table
from ..models.text import Text


def to_plain(value):
    """Recursively converts a document (sub)tree into plain dicts/lists/
    primitives.  Text becomes its string content; Table becomes
    {columns, rows: {id: row}}; datetime stays a datetime."""
    if isinstance(value, Text):
        return str(value)
    if isinstance(value, Table):
        return {
            'columns': to_plain(value.columns),
            'rows': {id_: to_plain(value.by_id(id_)) for id_ in value.ids},
        }
    if isinstance(value, dict):
        return {k: to_plain(v) for k, v in value.items()}
    if isinstance(value, list):
        return [to_plain(v) for v in value]
    if isinstance(value, datetime):
        return value
    return value
