"""FastWARC-style WARC parser on the zero-copy arena paths.

1. **Stream decompression** — member-granular C-call gzip decode
   (:class:`~.streams.GZipStream`), inflated straight into pooled arena
   slots, optionally ahead of the parser on a decoder thread.
2. **Record parsing** — bulk buffer scans: one ``find(b"\\r\\n\\r\\n")``
   bounds the header block, type and length are sniffed off the arena,
   other header fields are scanned off the raw block on demand, record
   content is a zero-copy ``memoryview``, HTTP parsing only when
   requested.
3. **Digest checks on read** (``verify_digests=True``) — the record's
   ``WARC-Block-Digest`` / ``WARC-Payload-Digest`` headers checked on the
   host (:func:`~.checksum.verify_digest`).

Covers gzip and uncompressed WARCs. LZ4 and zstd shards raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

import io
import os
from typing import BinaryIO, Iterator

from repro_torch import obs

from .checksum import verify_digest
from .errors import RecordReadError
from .http import parse_http_fast
from .record import (
    HEADER_TERMINATOR,
    HTTP_TYPE_MASK,
    RECORD_TYPE_FROM_VALUE,
    RECORD_TYPE_VALUES,
    UNKNOWN_TYPE_VALUE,
    WARC_MAGIC,
    WarcRecord,
    scan_header_field,
    scan_header_field_in,
)
from .streams import (
    CopyStats,
    GZipStream,
    MemberArena,
    ReadaheadDecoder,
    RecordBuffer,
    detect_compression,
)

__all__ = ["FastWARCIterator", "read_record_at"]

_READ_BLOCK = 1 << 20
_TYPE_NEEDLE = b"WARC-Type:"
_CLEN_NEEDLE = b"Content-Length:"


def _type_value(type_raw: bytes | None) -> int:
    if type_raw is None:
        return UNKNOWN_TYPE_VALUE
    return RECORD_TYPE_VALUES.get(type_raw.lower(), UNKNOWN_TYPE_VALUE)


class FastWARCIterator:
    """Iterate WARC records with lazy HTTP parsing and optional digests.

    Parameters
    ----------
    source:
        path, or seekable binary file object, of a gzip or uncompressed
        WARC file.
    parse_http:
        parse HTTP headers of ``application/http`` payloads on yield.
    verify_digests:
        verify ``WARC-Block-Digest`` / ``WARC-Payload-Digest`` and record
        the outcome on ``verified_block_digest`` /
        ``verified_payload_digest`` (``None`` where the header is absent).
    readahead:
        gzip only: inflate members on a decoder thread
        (:class:`~.streams.ReadaheadDecoder`) ahead of the parser through
        a bounded slot ring. Default ``None`` enables it (members must be
        inflated to find their boundaries anyway); ``close()`` joins it.

    Record content is a borrowed ``memoryview`` into a pooled arena, see
    :meth:`WarcRecord.detach`. Every Python-level byte copy is tallied in
    ``self.copy_stats``; terminal counters publish to the ``ingest.*``
    counters of :func:`repro_torch.obs.registry` on exhaustion or close.
    """

    def __init__(self, source: BinaryIO | str, *, parse_http: bool = True,
                 verify_digests: bool = False,
                 readahead: bool | None = None) -> None:
        self._owned_file: BinaryIO | None = None
        if isinstance(source, str):
            source = open(source, "rb")
            self._owned_file = source
        self._raw = source
        self.parse_http = parse_http
        self.verify_digests = verify_digests
        self.readahead = readahead
        self._decoder: ReadaheadDecoder | None = None
        self.copy_stats = CopyStats()
        self.records_yielded = 0
        self._obs_published = False

        head = source.read(8)
        source.seek(-len(head), io.SEEK_CUR)
        self._kind = detect_compression(head)
        if self._kind in ("lz4", "zstd"):
            self.close()
            raise NotImplementedError(
                f"{self._kind} WARC shards are not ported yet (ROADMAP: "
                f"LZ4, zstd and xxh32 streams)")
        self._stream = GZipStream(source) if self._kind == "gzip" else None

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[WarcRecord]:
        if self.closed:
            return  # exhausted path-owned source: empty, like reading EOF
        try:
            if self._stream is None:
                yield from self._iter_uncompressed()
            elif self.readahead is False:
                yield from self._iter_members()
            else:
                yield from self._iter_members_readahead()
        finally:
            # files *we* opened (str paths) are released on exhaustion or
            # generator teardown
            self._stop_decoder()
            self._publish_obs()
            if self._owned_file is not None:
                self.close()

    # -- lifecycle -------------------------------------------------------
    @property
    def closed(self) -> bool:
        f = self._owned_file
        return f is not None and f.closed

    def _stop_decoder(self) -> None:
        decoder = self._decoder
        if decoder is not None:
            self._decoder = None
            decoder.close()

    def close(self) -> None:
        """Join the readahead decoder thread if one is running, and close
        the underlying file if this iterator opened it."""
        self._stop_decoder()
        self._publish_obs()
        if self._owned_file is not None and not self._owned_file.closed:
            self._owned_file.close()

    def __enter__(self) -> "FastWARCIterator":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def _publish_obs(self) -> None:
        """Fold this iterator's terminal counters into the process-default
        registry (``ingest.*``). Idempotent."""
        if self._obs_published:
            return
        self._obs_published = True
        reg = obs.registry()
        reg.fold_counters(self.copy_stats.as_dict(), prefix="ingest.")
        reg.fold_counters({"records": self.records_yielded, "shards": 1},
                          prefix="ingest.")

    # -- shared record assembly -----------------------------------------
    def _finalize(self, header_block: bytes, type_value: int,
                  content, offset: int) -> WarcRecord:
        """Assemble a record from its raw header block."""
        record = WarcRecord(header_block, RECORD_TYPE_FROM_VALUE[type_value],
                            content, offset, stats=self.copy_stats)
        if self.verify_digests:
            bd = scan_header_field(header_block, b"WARC-Block-Digest:")
            if bd is not None:
                record.verified_block_digest = verify_digest(
                    record.content_view(), bd.decode("latin-1"))
        if self.parse_http and (type_value & HTTP_TYPE_MASK) and \
                record.is_http:
            http, body_off = parse_http_fast(record.content_view())
            record.http_headers = http
            record.http_content_offset = body_off if http is not None else -1
            if self.verify_digests and http is not None:
                pd = scan_header_field(header_block, b"WARC-Payload-Digest:")
                if pd is not None:
                    record.verified_payload_digest = verify_digest(
                        record.payload_view(), pd.decode("latin-1"))
        self.records_yielded += 1
        return record

    # -- uncompressed: pooled-arena zero-copy splitting ------------------
    def _iter_uncompressed(self) -> Iterator[WarcRecord]:
        # Absolute-offset parse over a RecordBuffer: fills land in a
        # reusable bytearray arena via readinto, record content is a
        # borrowed memoryview into it, and the only copies left are the
        # records' (small) header blocks plus the arena-roll tail.
        rb = RecordBuffer(self._raw, stats=self.copy_stats)
        magic_len = len(WARC_MAGIC)
        pos = 0  # absolute stream offset of the next unconsumed byte
        while True:
            rb.discard(pos)
            if not rb.ensure(pos, magic_len):
                return
            if not rb.startswith(WARC_MAGIC, pos):
                nxt = rb.find(WARC_MAGIC, pos)
                if nxt < 0:
                    if rb.eof:
                        return
                    # garbage: keep only a magic-straddle tail, read on
                    pos = max(pos, rb.end_abs - magic_len + 1)
                    rb.discard(pos)
                    rb.ensure(pos, rb.end_abs - pos + 1)
                    continue
                pos = nxt
                rb.discard(pos)
            hdr_end = rb.find(HEADER_TERMINATOR, pos)
            while hdr_end < 0:
                if rb.eof:
                    return
                rb.ensure(pos, rb.end_abs - pos + _READ_BLOCK)
                hdr_end = rb.find(HEADER_TERMINATOR, pos)
            clen_raw = rb.scan_field(_CLEN_NEEDLE, pos, hdr_end)
            clen = int(clen_raw) if clen_raw and clen_raw.isdigit() else 0
            body_start = hdr_end + 4
            record_end = body_start + clen + 4
            type_value = _type_value(rb.scan_field(_TYPE_NEEDLE, pos,
                                                   hdr_end))
            if not rb.ensure(pos, record_end - pos):
                return  # truncated final record: silent stop
            header_block = rb.take_bytes(pos, hdr_end)
            content = rb.view(body_start, body_start + clen)
            record = self._finalize(header_block, type_value, content, pos)
            pos = record_end
            yield record

    # -- gzip: decode-into-arena members ---------------------------------
    def _iter_members(self) -> Iterator[WarcRecord]:
        stream = self._stream
        arena = MemberArena(stats=self.copy_stats)
        while True:
            offset = stream.tell_compressed()
            slot = arena.acquire()
            n = stream.next_member_into(slot, self.copy_stats)
            if n is None:
                arena.release(slot)
                return
            record = self._record_from_slot(slot, 0, n, offset)
            arena.release(slot)
            if record is not None:
                yield record

    def _iter_members_readahead(self) -> Iterator[WarcRecord]:
        # a decoder thread inflates members into slot batches ahead of
        # this parse loop (bounded ring); it dies with this generator
        # (finally) and with close()
        stream = self._stream
        stats = self.copy_stats

        def decode_member(slot: bytearray):
            offset = stream.tell_compressed()
            n = stream.next_member_into(slot, stats)
            return None if n is None else (n, offset)

        decoder = ReadaheadDecoder(decode_member, MemberArena(stats=stats))
        self._decoder = decoder
        try:
            while True:
                item = decoder.get()
                if item is None:
                    return
                _, slot, members = item
                for start, nbytes, offset in members:
                    record = self._record_from_slot(slot, start, nbytes,
                                                    offset)
                    if record is not None:
                        yield record
                decoder.release(slot)
        finally:
            self._stop_decoder()

    def _record_from_slot(self, slot: bytearray, at: int, nbytes: int,
                          offset: int) -> WarcRecord | None:
        """Parse one decoded member in place: type/length sniffed off the
        slot, header block copied out (small, counted), content borrowed
        as a ``memoryview`` of the slot."""
        end = at + nbytes
        start = slot.find(WARC_MAGIC, at, end)
        if start < 0:
            return None
        hdr_end = slot.find(HEADER_TERMINATOR, start, end)
        if hdr_end < 0:
            return None
        type_value = _type_value(scan_header_field_in(slot, _TYPE_NEEDLE,
                                                      start, hdr_end))
        clen_raw = scan_header_field_in(slot, _CLEN_NEEDLE, start, hdr_end)
        clen = int(clen_raw) if clen_raw and clen_raw.isdigit() else 0
        header_block = bytes(memoryview(slot)[start:hdr_end])
        self.copy_stats.count_copy(len(header_block))
        body_start = hdr_end + 4
        content = memoryview(slot)[body_start:min(body_start + clen, end)]
        return self._finalize(header_block, type_value, content, offset)

    def read_one(self) -> WarcRecord | None:
        """Parse and return the next record only (random-access support):
        exactly one member is decompressed and one record parsed."""
        # random-access reads are serving-side: a throwaway iterator
        # publishing ingest counters per fetch would drown the sweep's
        self._obs_published = True
        return next(iter(self), None)


def read_record_at(source, offset: int, *, parse_http: bool = True,
                   verify_digests: bool = False,
                   shard: str | None = None) -> WarcRecord:
    """Parse exactly one record at absolute ``offset`` in ``source``.

    ``source`` is a seekable file object over the *addressable* stream —
    the compressed file for gzip members, the raw file for uncompressed
    WARCs — or a filesystem path, opened and closed around the read.
    Cost is one seek + one member decode + one record parse, independent
    of archive size. The returned record owns its bytes and its
    ``stream_offset`` is the absolute ``offset``.

    An offset that addresses no record raises :class:`RecordReadError`
    carrying the offset and shard.
    """
    if isinstance(source, (str, os.PathLike)):
        if shard is None:
            shard = os.fspath(source)
        with open(source, "rb") as f:
            return read_record_at(f, offset, parse_http=parse_http,
                                  verify_digests=verify_digests, shard=shard)
    try:
        source.seek(offset)
        # readahead off: one member is parsed and the iterator abandoned
        it = FastWARCIterator(source, parse_http=parse_http,
                              verify_digests=verify_digests,
                              readahead=False)
        record = it.read_one()
    except (OSError, RecordReadError, NotImplementedError):
        raise
    except Exception as exc:
        raise RecordReadError(
            f"damaged record: {exc!r}", offset=offset, shard=shard) from exc
    if record is None:
        raise RecordReadError("offset addresses no record "
                              "(stale index or truncated shard)",
                              offset=offset, shard=shard)
    # content may be a zero-copy borrow of the iterator's arena;
    # detach so the record outlives the abandoned iterator
    record.detach()
    record.stream_offset = offset
    return record
