"""Error taxonomy for fault-tolerant archive processing.

Production crawl data is riddled with malformed records, truncated
members, and mid-job process failures (the WARC-DL and Common Crawl
longitudinal papers both call this out as the dominant operational
cost). The tolerant paths never silently drop bytes: every damaged or
skipped byte range is accounted for in an :class:`ErrorLedger` entry so
a shard job can report exactly *what* it could not parse and *where*.

Error classes (the ``error_class`` field of :class:`LedgerEntry`):

``garbage``             bytes between records that match no ``WARC/`` magic
``bad_content_length``  header's Content-Length does not land on a record
                        terminator (or is missing/non-numeric)
``truncated_tail``      EOF inside the final record / member
``bad_gzip_member``     gzip member failed to decode (header or deflate)
``bad_lz4_frame``       LZ4 frame failed to parse or decode
``bad_member``          decoded member does not contain a parseable record
``bad_zstd_stream``     zstd stream failed mid-decode (rest of shard lost)
``shard_quarantined``   a supervised worker died twice on this shard
"""
from __future__ import annotations

import struct
import threading
import zlib
from dataclasses import dataclass

__all__ = [
    "LedgerEntry",
    "ErrorLedger",
    "RecordReadError",
    "classify_member_error",
]


@dataclass(frozen=True)
class LedgerEntry:
    """One quarantined byte range (picklable: crosses process boundaries).

    ``offset`` is in the *addressing domain* of the stream that produced
    it: compressed-file offsets for gzip/LZ4 member archives (the same
    domain CDX offsets live in), decompressed offsets for uncompressed
    and zstd streams.
    """

    shard: str | None
    offset: int
    error_class: str
    bytes_skipped: int
    message: str = ""

    @property
    def end(self) -> int:
        return self.offset + self.bytes_skipped

    def covers(self, start: int, stop: int) -> bool:
        """Does this entry's range overlap ``[start, stop)``?"""
        return self.offset < stop and start < self.end


class ErrorLedger:
    """Append-only, thread-safe ledger of damaged byte ranges.

    Shared between an iterator and its readahead decoder thread (and
    merged across processes by the tolerant index build), so appends are
    lock-guarded; reads take a snapshot.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: list[LedgerEntry] = []

    def record(self, shard: str | None, offset: int, error_class: str,
               bytes_skipped: int, message: str = "") -> LedgerEntry:
        entry = LedgerEntry(shard, offset, error_class, bytes_skipped, message)
        with self._lock:
            self._entries.append(entry)
        return entry

    def extend(self, entries) -> None:
        with self._lock:
            self._entries.extend(entries)

    def merge(self, other: "ErrorLedger") -> None:
        self.extend(other.entries())

    def entries(self) -> list[LedgerEntry]:
        with self._lock:
            return list(self._entries)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.entries():
            out[e.error_class] = out.get(e.error_class, 0) + 1
        return out

    @property
    def bytes_skipped(self) -> int:
        return sum(e.bytes_skipped for e in self.entries())

    def covers(self, start: int, stop: int, shard: str | None = None) -> bool:
        """Is ``[start, stop)`` fully inside quarantined ranges of ``shard``?

        Damaged ranges from one fault are contiguous per entry, so this
        checks any-overlap entry containment (good enough for the fault
        harness, which damages record-aligned spans).
        """
        for e in self.entries():
            if shard is not None and e.shard is not None and e.shard != shard:
                continue
            if e.offset <= start and stop <= e.end:
                return True
        return False

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __iter__(self):
        return iter(self.entries())

    def __bool__(self) -> bool:
        return len(self) > 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ErrorLedger({self.counts()}, bytes={self.bytes_skipped})"


class RecordReadError(RuntimeError):
    """A random-access record read (CDX offset -> record) failed.

    Raised by :func:`repro_torch.core.warc.fastwarc.read_record_at` and
    :class:`repro_torch.index.cdx.RandomAccessReader` instead of leaking bare
    ``zlib.error`` / ``struct.error`` / ``LZ4Error`` out of the decode
    internals — the serving gateway maps it to a clean per-request
    error, not a scheduler-wedging 500-equivalent.
    """

    def __init__(self, message: str, *, offset: int = -1,
                 shard: str | None = None) -> None:
        super().__init__(message)
        self.offset = offset
        self.shard = shard

    def __str__(self) -> str:
        base = super().__str__()
        where = f"offset {self.offset}"
        if self.shard is not None:
            where += f" of {self.shard}"
        return f"{base} ({where})"


def classify_member_error(exc: BaseException) -> str:
    """Map a decode exception to a ledger error class."""
    from .lz4 import LZ4Error  # local: record/errors must not import lz4 eagerly

    if isinstance(exc, zlib.error):
        return "bad_gzip_member"
    if isinstance(exc, LZ4Error):
        return "bad_lz4_frame"
    if isinstance(exc, (struct.error, IndexError)):
        return "truncated_tail"
    return "bad_member"
