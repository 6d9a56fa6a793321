"""WARC core: the FastWARC-style parser, its streams and codecs, and its
baseline (WARCIO).

>>> from repro_torch.core.warc import FastWARCIterator, WarcRecordType
>>> for record in FastWARCIterator("crawl.warc.gz",
...                                record_types=WarcRecordType.response):
...     process(record.http_payload)
"""
from .record import (
    HttpHeaderMap,
    WarcHeaderMap,
    WarcRecord,
    WarcRecordType,
)
from .errors import ErrorLedger, LedgerEntry, RecordReadError
from .fastwarc import FastWARCIterator, parse_header_block, read_record_at
from .warcio_ref import BaselineRecord, WARCIOArchiveIterator
from .writer import WarcWriter, recompress, serialize_record
from .checksum import block_digest, verify_digest, verify_digests_bulk
from . import lz4, streams, xxh32

__all__ = [
    "BaselineRecord",
    "ErrorLedger",
    "FastWARCIterator",
    "HttpHeaderMap",
    "LedgerEntry",
    "RecordReadError",
    "WARCIOArchiveIterator",
    "WarcHeaderMap",
    "WarcRecord",
    "WarcRecordType",
    "WarcWriter",
    "block_digest",
    "lz4",
    "parse_header_block",
    "read_record_at",
    "recompress",
    "serialize_record",
    "streams",
    "verify_digest",
    "verify_digests_bulk",
    "xxh32",
]
