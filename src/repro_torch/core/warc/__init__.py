"""WARC streams, records and the FastWARC-style parser (gzip and
uncompressed)."""
from .errors import LedgerEntry, RecordReadError
from .fastwarc import FastWARCIterator, read_record_at
from .record import (HttpHeaderMap, WarcHeaderMap, WarcRecord,
                     WarcRecordType)
from .writer import WarcWriter, serialize_record

__all__ = [
    "FastWARCIterator",
    "HttpHeaderMap",
    "LedgerEntry",
    "RecordReadError",
    "WarcHeaderMap",
    "WarcRecord",
    "WarcRecordType",
    "WarcWriter",
    "read_record_at",
    "serialize_record",
]
