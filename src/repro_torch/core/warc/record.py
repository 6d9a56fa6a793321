"""WARC record model: record types, case-insensitive header maps, records.

Mirrors the data model of ISO 28500 (WARC/1.1) as implemented by FastWARC
(Bevendorff et al., 2021): a record is a version line, a block of
``Name: value`` headers, and a content block of ``Content-Length`` bytes,
followed by two CRLFs.

Two header-map implementations are provided:

* :class:`WarcHeaderMap` — the *optimized* representation used by the
  FastWARC-style parser: stores raw ``bytes`` pairs, decodes lazily on
  access, preserves order, O(1) case-insensitive lookup via a side index.
* The baseline (WARCIO-style) parser in ``warcio_ref.py`` deliberately
  uses eager ``str`` decoding and per-line regex splitting instead — that
  difference is one of the paper's three measured bottlenecks.
"""
from __future__ import annotations

import enum
from typing import Iterator


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


#: raw ``WARC-Type`` value -> enum member (bytes keys: the hot path never decodes)
_RECORD_TYPE_BY_NAME: dict[bytes, WarcRecordType] = {
    b"warcinfo": WarcRecordType.warcinfo,
    b"response": WarcRecordType.response,
    b"resource": WarcRecordType.resource,
    b"request": WarcRecordType.request,
    b"metadata": WarcRecordType.metadata,
    b"revisit": WarcRecordType.revisit,
    b"conversion": WarcRecordType.conversion,
    b"continuation": WarcRecordType.continuation,
}

#: same map to plain ints — ``IntFlag.__and__`` showed up in profiles at
#: ~10 % of parse time; the hot path masks with ints and materializes the
#: enum member only for records that are actually yielded.
RECORD_TYPE_VALUES: dict[bytes, int] = {
    k: int(v) for k, v in _RECORD_TYPE_BY_NAME.items()
}
RECORD_TYPE_FROM_VALUE: dict[int, WarcRecordType] = {
    int(v): v for v in WarcRecordType if v.name not in ("any_type", "no_type")
}
UNKNOWN_TYPE_VALUE = int(WarcRecordType.unknown)
HTTP_TYPE_MASK = int(WarcRecordType.response | WarcRecordType.request)


def record_type_from_bytes(value: bytes) -> WarcRecordType:
    return _RECORD_TYPE_BY_NAME.get(value.strip().lower(), WarcRecordType.unknown)


def parse_content_length(raw: bytes | None) -> int | None:
    """Strict ``Content-Length`` validation: non-negative decimal or bust.

    The hot parse paths historically coerced a missing/garbled length to
    ``0`` and kept going — fine for well-formed archives, catastrophic
    for damaged ones (a wrong length desynchronizes the framing scan and
    every subsequent "record" is garbage). The tolerant paths use this
    instead and treat ``None`` as a resync trigger.
    """
    if raw is None:
        return None
    raw = raw.strip()
    if not raw or not raw.isdigit():  # isdigit() rejects b"-1", b"1e3", b""
        return None
    try:
        return int(raw)
    except ValueError:  # pragma: no cover - isdigit makes this unreachable
        return None


def scan_header_field(block: bytes, needle: bytes) -> bytes | None:
    """Grab one ``Name:``-prefixed field value from a raw header block
    without parsing the block. The backbone of both the record-type
    pre-filter and lazy header access: for skipped records this is the only
    work ever done on their headers. ``needle`` must include the colon."""
    i = block.find(needle)
    while i > 0 and block[i - 1] != 0x0A:  # must start a line
        i = block.find(needle, i + 1)
    if i < 0:
        return None
    end = block.find(b"\r\n", i)
    if end < 0:
        end = len(block)
    return block[i + len(needle):end].strip()


def scan_header_field_in(buf, needle: bytes, start: int, end: int) -> bytes | None:
    """:func:`scan_header_field` over a region ``[start, end)`` of a larger
    buffer (``bytes`` or ``bytearray``), without slicing the region out.

    The zero-copy twin used by the arena parse paths (the pooled record
    buffer and the member-decode slots): skipped records get their
    type/length sniffed straight off the arena — only the (tiny) field
    value is ever materialized. ``needle`` must include the colon.
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
    """Ordered, case-insensitive multi-map over raw header bytes.

    Values stay ``bytes`` until accessed (lazy decode — one of the
    FastWARC-vs-WARCIO differences this system reproduces).
    """

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

    def get_bytes(self, name: bytes, default: bytes | None = None) -> bytes | None:
        index = self._index or self._build_index()
        i = index.get(name.lower())
        return self._pairs[i][1] if i is not None else default

    def get(self, name: str, default: str | None = None) -> str | None:
        raw = self.get_bytes(name.encode("latin-1"))
        return raw.decode("latin-1", "replace") if raw is not None else default

    def __getitem__(self, name: str) -> str:
        value = self.get(name)
        if value is None:
            raise KeyError(name)
        return value

    def __contains__(self, name: str) -> bool:
        return self.get(name) is not None

    def __iter__(self) -> Iterator[tuple[str, str]]:
        for name, value in self._pairs:
            yield name.decode("latin-1", "replace"), value.decode("latin-1", "replace")

    def items_bytes(self) -> list[tuple[bytes, bytes]]:
        return list(self._pairs)

    def __len__(self) -> int:
        return len(self._pairs)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"WarcHeaderMap({self.status_line!r}, {len(self._pairs)} headers)"


class HttpHeaderMap(WarcHeaderMap):
    """HTTP status line + headers; same storage, different status semantics."""

    @property
    def status_code(self) -> int | None:
        parts = self.status_line.split(None, 2)
        if len(parts) >= 2 and parts[1].isdigit():
            return int(parts[1])
        return None

    @property
    def reason(self) -> str:
        parts = self.status_line.split(None, 2)
        return parts[2].decode("latin-1", "replace") if len(parts) == 3 else ""


class WarcRecord:
    """A parsed WARC record.

    Headers are **lazy**: the record carries the raw header block and the
    :class:`WarcHeaderMap` is built on first ``.headers`` access. Iterating
    an archive without touching headers therefore costs no header parsing
    at all — the same work-avoidance insight the paper applies to HTTP
    parsing, pushed one level up (profiled: header-map construction was the
    single hottest phase of the Python hot loop).

    ``content`` may be a zero-copy ``memoryview`` into the parser's
    pooled arena (``http_headers`` is populated only when HTTP parsing is
    enabled — lazy HTTP parsing is bottleneck (2) of the paper). Borrowed
    views pin their arena: holding many un-detached records costs arena
    memory, never correctness. :meth:`detach` copies the record out and
    releases the pin; :meth:`content_view` / :meth:`payload_view` are the
    **borrow-only** zero-copy accessors.
    """

    __slots__ = (
        "_header_block",
        "_headers",
        "record_type",
        "content_length",
        "_content",
        "_stats",
        "http_headers",
        "http_content_offset",
        "stream_offset",
        "verified_block_digest",
        "verified_payload_digest",
    )

    def __init__(
        self,
        headers: "WarcHeaderMap | bytes",
        record_type: WarcRecordType,
        content: bytes | memoryview = b"",
        stream_offset: int = -1,
        stats=None,
    ) -> None:
        if isinstance(headers, WarcHeaderMap):
            self._headers: WarcHeaderMap | None = headers
            self._header_block = b""
        else:
            self._headers = None
            self._header_block = headers
        self.record_type = record_type
        self._content = content
        self.content_length = len(content)
        self._stats = stats  # CopyStats ledger shared with the iterator
        self.http_headers: HttpHeaderMap | None = None
        self.http_content_offset = -1
        self.stream_offset = stream_offset
        self.verified_block_digest: bool | None = None
        self.verified_payload_digest: bool | None = None

    @property
    def headers(self) -> "WarcHeaderMap":
        if self._headers is None:
            from .fastwarc import parse_header_block  # local: no cycle at import
            self._headers = parse_header_block(self._header_block)
        return self._headers

    # -- convenience accessors ----------------------------------------------
    @property
    def record_id(self) -> str | None:
        return self.headers.get("WARC-Record-ID")

    @property
    def record_date(self) -> str | None:
        return self.headers.get("WARC-Date")

    @property
    def target_uri(self) -> str | None:
        return self.headers.get("WARC-Target-URI")

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
        """**Borrow-only** zero-copy view of the record block.

        The view aliases the parser's arena; it pins that arena while
        referenced but must not be stored past the record's own lifetime
        — call :meth:`detach` (or read :attr:`content`) for an owning
        copy that outlives the iterator.
        """
        if isinstance(self._content, memoryview):
            return self._content
        return memoryview(self._content)

    def detach(self) -> "WarcRecord":
        """Copy this record out of the parse arena (returns ``self``).

        After ``detach()`` the record owns its content and raw header
        block outright: it survives arena recycling, pickling, and the
        iterator's teardown. The one copy it costs is counted in the
        iterator's :class:`~repro_torch.core.warc.streams.CopyStats`.
        """
        self.content  # noqa: B018 - property materializes the borrow
        if isinstance(self._header_block, memoryview):
            if self._stats is not None:
                self._stats.count_copy(len(self._header_block))
            self._header_block = bytes(self._header_block)
        return self

    @property
    def is_detached(self) -> bool:
        return not (isinstance(self._content, memoryview)
                    or isinstance(self._header_block, memoryview))

    @property
    def http_payload(self) -> bytes:
        """Owning body after the HTTP header block (requires HTTP parsing)."""
        if self.http_content_offset < 0:
            return self.content
        return self.content[self.http_content_offset:]

    def payload_view(self) -> memoryview:
        """Borrow-only zero-copy view of the HTTP body (or whole block).

        Same lifetime contract as :meth:`content_view`.
        """
        view = self.content_view()
        if self.http_content_offset < 0:
            return view
        return view[self.http_content_offset:]

    def header_bytes(self, needle: bytes) -> bytes | None:
        """Single-field access without building the header map (when lazy).

        ``needle`` is the raw header name *with* trailing colon, e.g.
        ``b"WARC-Target-URI:"``.
        """
        if self._headers is not None:
            return self._headers.get_bytes(needle.rstrip(b":"))
        return scan_header_field(self._header_block, needle)

    @property
    def is_http(self) -> bool:
        ctype = self.header_bytes(b"Content-Type:") or b""
        return ctype.startswith(b"application/http")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"WarcRecord({self.record_type.name}, id={self.record_id}, "
            f"len={self.content_length})"
        )


CRLF = b"\r\n"
HEADER_TERMINATOR = b"\r\n\r\n"
WARC_MAGIC = b"WARC/"
