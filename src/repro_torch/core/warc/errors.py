"""Errors of the record readers, and the damage ledger's entry.

A :class:`LedgerEntry` accounts for one byte range a shard job could not
process. The process pool's supervisor reports a shard that keeps
killing workers as one entry of class ``shard_quarantined`` covering the
whole file.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["LedgerEntry", "RecordReadError"]


@dataclass(frozen=True)
class LedgerEntry:
    """One quarantined byte range (picklable: crosses process boundaries).

    ``offset`` is in the addressing domain of the stream that produced
    it: compressed-file offsets for gzip member archives (the domain CDX
    offsets live in), decompressed offsets for uncompressed streams.
    """

    shard: str | None
    offset: int
    error_class: str
    bytes_skipped: int
    message: str = ""


class RecordReadError(RuntimeError):
    """A random-access record read (CDX offset -> record) failed.

    Raised by :func:`repro_torch.core.warc.fastwarc.read_record_at` and
    :class:`repro_torch.index.cdx.RandomAccessReader` instead of leaking
    bare ``zlib.error`` / ``struct.error`` out of the decode internals.
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
