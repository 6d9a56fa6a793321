"""WARC record model: record types, case-insensitive header maps, records.

Mirrors the data model of ISO 28500 (WARC/1.1) as implemented by
FastWARC: a record is a version line, a block of ``Name: value``
headers, and a content block of ``Content-Length`` bytes, followed by
two CRLFs. :class:`WarcHeaderMap` stores raw ``bytes`` pairs, preserves
order, and looks up case-insensitively.
"""
from __future__ import annotations

import enum


class WarcRecordType(enum.IntFlag):
    """WARC-Type values as a bit mask (so iterators can filter cheaply)."""

    warcinfo = 2
    response = 4
    resource = 8
    request = 16
    metadata = 32
    revisit = 64
    conversion = 128
    continuation = 256
    unknown = 512
    any_type = 2 | 4 | 8 | 16 | 32 | 64 | 128 | 256 | 512
    no_type = 0


#: raw ``WARC-Type`` value -> plain int mask (the hot path masks with ints
#: and materializes the enum member only for yielded records)
RECORD_TYPE_VALUES: dict[bytes, int] = {
    b"warcinfo": int(WarcRecordType.warcinfo),
    b"response": int(WarcRecordType.response),
    b"resource": int(WarcRecordType.resource),
    b"request": int(WarcRecordType.request),
    b"metadata": int(WarcRecordType.metadata),
    b"revisit": int(WarcRecordType.revisit),
    b"conversion": int(WarcRecordType.conversion),
    b"continuation": int(WarcRecordType.continuation),
}
RECORD_TYPE_FROM_VALUE: dict[int, WarcRecordType] = {
    int(v): v for v in WarcRecordType if v.name not in ("any_type", "no_type")
}
UNKNOWN_TYPE_VALUE = int(WarcRecordType.unknown)
HTTP_TYPE_MASK = int(WarcRecordType.response | WarcRecordType.request)


def scan_header_field(block: bytes, needle: bytes) -> bytes | None:
    """Grab one ``Name:``-prefixed field value from a raw header block
    without parsing the block. ``needle`` must include the colon."""
    i = block.find(needle)
    while i > 0 and block[i - 1] != 0x0A:  # must start a line
        i = block.find(needle, i + 1)
    if i < 0:
        return None
    end = block.find(b"\r\n", i)
    if end < 0:
        end = len(block)
    return block[i + len(needle):end].strip()


def scan_header_field_in(buf, needle: bytes, start: int, end: int
                         ) -> bytes | None:
    """:func:`scan_header_field` over a region ``[start, end)`` of a larger
    buffer (``bytes`` or ``bytearray``), without slicing the region out:
    the arena parse paths sniff type and length straight off the arena.
    ``needle`` must include the colon.
    """
    i = buf.find(needle, start, end)
    while i > start and buf[i - 1] != 0x0A:  # must start a line
        i = buf.find(needle, i + 1, end)
    if i < 0:
        return None
    vend = buf.find(b"\r\n", i, end)
    if vend < 0:
        vend = end
    return bytes(buf[i + len(needle):vend]).strip()


class WarcHeaderMap:
    """Ordered, case-insensitive multi-map over raw header bytes (the
    writer builds records with it; HTTP headers parse into it)."""

    __slots__ = ("_pairs", "_index", "status_line")

    def __init__(self, status_line: bytes = b"WARC/1.1") -> None:
        self.status_line = status_line
        self._pairs: list[tuple[bytes, bytes]] = []
        self._index: dict[bytes, int] | None = None

    # -- construction ------------------------------------------------------
    def append(self, name: bytes, value: bytes) -> None:
        self._pairs.append((name, value))
        self._index = None

    def append_continuation(self, value: bytes) -> None:
        """RFC 822 folded header continuation line."""
        if not self._pairs:  # malformed; treat as headerless value
            self._pairs.append((b"", value))
            return
        name, prev = self._pairs[-1]
        self._pairs[-1] = (name, prev + b" " + value)
        self._index = None

    def set(self, name: bytes | str, value: bytes | str) -> None:
        if isinstance(name, str):
            name = name.encode("latin-1")
        if isinstance(value, str):
            value = value.encode("latin-1")
        key = name.lower()
        for i, (n, _) in enumerate(self._pairs):
            if n.lower() == key:
                self._pairs[i] = (name, value)
                self._index = None
                return
        self.append(name, value)

    # -- lookup ------------------------------------------------------------
    def _build_index(self) -> dict[bytes, int]:
        index: dict[bytes, int] = {}
        for i, (name, _) in enumerate(self._pairs):
            index.setdefault(name.lower(), i)
        self._index = index
        return index

    def get_bytes(self, name: bytes, default: bytes | None = None
                  ) -> bytes | None:
        index = self._index or self._build_index()
        i = index.get(name.lower())
        return self._pairs[i][1] if i is not None else default

    def items_bytes(self) -> list[tuple[bytes, bytes]]:
        return list(self._pairs)


class HttpHeaderMap(WarcHeaderMap):
    """HTTP status line + headers; same storage, different status semantics."""

    @property
    def status_code(self) -> int | None:
        parts = self.status_line.split(None, 2)
        if len(parts) >= 2 and parts[1].isdigit():
            return int(parts[1])
        return None


class WarcRecord:
    """A parsed WARC record.

    The record carries its raw header block; single fields are read with
    :meth:`header_bytes` without building a header map.

    ``content`` may be a zero-copy ``memoryview`` into the parser's
    pooled arena (``http_headers`` is populated only when HTTP parsing is
    enabled). Borrowed views pin their arena: holding many un-detached
    records costs arena memory, never correctness. :meth:`detach` copies
    the content out and releases the pin; :meth:`content_view` is the
    **borrow-only** zero-copy accessor.
    """

    __slots__ = (
        "_header_block",
        "record_type",
        "content_length",
        "_content",
        "_stats",
        "http_headers",
        "http_content_offset",
        "stream_offset",
    )

    def __init__(self, header_block: bytes, record_type: WarcRecordType,
                 content: bytes | memoryview = b"", stream_offset: int = -1,
                 stats=None) -> None:
        self._header_block = header_block
        self.record_type = record_type
        self._content = content
        self.content_length = len(content)
        self._stats = stats  # CopyStats ledger shared with the iterator
        self.http_headers: HttpHeaderMap | None = None
        self.http_content_offset = -1
        self.stream_offset = stream_offset

    @property
    def content(self) -> bytes:
        """Owning ``bytes`` of the content block (copies a borrowed view
        on first access — counted against the parse ledger)."""
        if isinstance(self._content, memoryview):
            if self._stats is not None:
                self._stats.count_copy(len(self._content))
            self._content = self._content.tobytes()
        return self._content

    def content_view(self) -> memoryview:
        """**Borrow-only** zero-copy view of the record block. It aliases
        the parser's arena: call :meth:`detach` (or read :attr:`content`)
        for an owning copy that outlives the iterator."""
        if isinstance(self._content, memoryview):
            return self._content
        return memoryview(self._content)

    def detach(self) -> "WarcRecord":
        """Copy this record's content out of the parse arena (returns
        ``self``)."""
        self.content  # noqa: B018 - property materializes the borrow
        return self

    def header_bytes(self, needle: bytes) -> bytes | None:
        """Single-field access on the raw header block. ``needle`` is the
        raw header name *with* trailing colon, e.g. ``b"WARC-Target-URI:"``.
        """
        return scan_header_field(self._header_block, needle)

    @property
    def is_http(self) -> bool:
        ctype = self.header_bytes(b"Content-Type:") or b""
        return ctype.startswith(b"application/http")


CRLF = b"\r\n"
HEADER_TERMINATOR = b"\r\n\r\n"
WARC_MAGIC = b"WARC/"
