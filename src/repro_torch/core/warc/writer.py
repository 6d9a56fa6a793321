"""WARC writer: serialize records, one gzip member per record.

Writes the member-per-record layout all WARC tooling expects, so readers
can random-access and skip at record granularity. Covers uncompressed
and gzip output.
"""
from __future__ import annotations

import uuid
import zlib
from datetime import datetime, timezone
from typing import BinaryIO

from .checksum import block_digest
from .record import CRLF, WarcHeaderMap

_WARC_VERSION = b"WARC/1.1"


def _utcnow() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def serialize_record(
    record_type: str,
    content: bytes,
    headers: dict[str, str] | None = None,
    *,
    digests: bool = False,
) -> bytes:
    """Serialize one record to uncompressed WARC bytes."""
    h = WarcHeaderMap(_WARC_VERSION)
    h.append(b"WARC-Type", record_type.encode("ascii"))
    headers = headers or {}
    if "WARC-Record-ID" not in headers:
        h.append(b"WARC-Record-ID",
                 f"<urn:uuid:{uuid.uuid4()}>".encode("ascii"))
    if "WARC-Date" not in headers:
        h.append(b"WARC-Date", _utcnow().encode("ascii"))
    for name, value in headers.items():
        h.set(name, value)
    if digests:
        h.set("WARC-Block-Digest", block_digest(content, "sha1"))
    h.set("Content-Length", str(len(content)))
    out = bytearray(h.status_line + CRLF)
    for name, value in h.items_bytes():
        out += name + b": " + value + CRLF
    out += CRLF
    out += content
    out += CRLF + CRLF
    return bytes(out)


class WarcWriter:
    """Streaming writer, uncompressed or one gzip member per record."""

    def __init__(self, sink: BinaryIO, compression: str = "none") -> None:
        if compression in ("lz4", "zstd"):
            raise NotImplementedError(
                f"{compression} output is not ported yet (ROADMAP: LZ4, "
                f"zstd and xxh32 streams)")
        if compression not in ("none", "gzip"):
            raise ValueError(f"unknown compression {compression!r}")
        self._sink = sink
        self.compression = compression
        self.records_written = 0
        self.bytes_written = 0

    def write_serialized(self, raw: bytes) -> None:
        if self.compression == "gzip":
            co = zlib.compressobj(6, zlib.DEFLATED, 31)
            out = co.compress(raw) + co.flush()
        else:
            out = raw
        self._sink.write(out)
        self.records_written += 1
        self.bytes_written += len(out)

    def write_record(self, record_type: str, content: bytes,
                     headers: dict[str, str] | None = None,
                     *, digests: bool = False) -> None:
        self.write_serialized(
            serialize_record(record_type, content, headers, digests=digests))
