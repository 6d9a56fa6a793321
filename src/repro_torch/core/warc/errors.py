"""Errors of the record readers."""
from __future__ import annotations

__all__ = ["RecordReadError"]


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
