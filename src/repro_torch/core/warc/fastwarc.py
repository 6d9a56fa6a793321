"""FastWARC-style optimized WARC parser.

Implements the paper's three fixes:

1. **Stream decompression** — member-granular single-C-call gzip decode
   (:class:`GZipStream`), LZ4 frames with lazy first-block decode, zstd
   bulk C-speed streaming.
2. **Record parsing** — bulk buffer scans: one ``find(b"\\r\\n\\r\\n")`` to
   bound the header block, one ``split(b"\\r\\n")`` to cut headers, raw
   ``bytes`` values decoded lazily; record content exposed as a zero-copy
   ``memoryview``; HTTP parsing deferred until requested.
3. **Cheap skipping** — a record-type pre-filter string-scans the raw
   header block *before* any header-map construction; skipped records cost
   a ``Content-Length`` seek (uncompressed/zstd), a frame hop (LZ4), or a
   member decode only (gzip — boundaries are unknowable without inflate).

The public API mirrors FastWARC's ``ArchiveIterator``. Hot-path style note:
this file deliberately trades a little elegance (int masks instead of
IntFlag math, pre-bound locals) for measured wins. Every path parses
through the pooled zero-copy arenas; the reference package's
``zero_copy=False`` bytes-slicing loops are not part of this package.
"""
from __future__ import annotations

import io
import os
from typing import BinaryIO, Callable, Iterator

from repro_torch import obs

from .checksum import verify_digest
from .errors import ErrorLedger, RecordReadError
from .http import parse_http_fast
from .record import (
    CRLF,
    HEADER_TERMINATOR,
    HTTP_TYPE_MASK,
    RECORD_TYPE_FROM_VALUE,
    RECORD_TYPE_VALUES,
    UNKNOWN_TYPE_VALUE,
    WARC_MAGIC,
    WarcHeaderMap,
    WarcRecord,
    WarcRecordType,
    parse_content_length,
)
from .record import scan_header_field_in as _scan_field_in
from .streams import (
    _ARENA_BYTES,
    CopyStats,
    GZipStream,
    LZ4Stream,
    MemberArena,
    ProcessReadaheadDecoder,
    ReadaheadDecoder,
    RecordBuffer,
    ZstdStream,
    detect_compression,
    next_member_tolerant,
)

__all__ = ["FastWARCIterator", "parse_header_block", "read_record_at"]

_READ_BLOCK = 1 << 20
_TYPE_NEEDLE = b"WARC-Type:"
_CLEN_NEEDLE = b"Content-Length:"


from .record import scan_header_field as _scan_header_field  # hot-path alias


def parse_header_block(block: bytes | memoryview) -> WarcHeaderMap:
    """One-pass split of a raw WARC header block into a lazy header map."""
    if isinstance(block, memoryview):
        block = bytes(block)
    lines = block.split(CRLF)
    headers = WarcHeaderMap(lines[0])
    pairs = headers._pairs  # direct fill: append() indirection profiled hot
    for line in lines[1:]:
        if not line:
            continue
        c0 = line[0]
        if c0 == 0x20 or c0 == 0x09:  # folded continuation
            if pairs:
                name, prev = pairs[-1]
                pairs[-1] = (name, prev + b" " + line.strip())
            continue
        colon = line.find(b":")
        if colon < 0:
            continue
        value = line[colon + 1:]
        # single leading space is the overwhelmingly common layout
        pairs.append((line[:colon],
                      value[1:] if value[:1] == b" " else value.strip()))
    return headers


class _TolerantReadGuard:
    """Wrap a decompressing reader so a mid-stream decode error becomes
    EOF plus an ``ErrorLedger`` entry instead of an exception.

    Used for tolerant zstd parsing: unlike gzip/LZ4 there are no member
    boundaries to resync on, so a damaged stream loses its tail — the
    ledger records where (decompressed-domain offset; the skipped length
    is unknowable without a decodable stream, recorded as 0).
    """

    def __init__(self, raw, report) -> None:
        self._raw = raw
        self._report = report
        self._produced = 0
        self._dead = False

    def _fail(self, exc: BaseException) -> None:
        self._dead = True
        self._report(self._produced, "bad_zstd_stream", 0, repr(exc))

    def read(self, n: int = -1) -> bytes:
        if self._dead:
            return b""
        try:
            data = self._raw.read(n)
        except Exception as exc:  # noqa: BLE001 - tolerant by contract
            self._fail(exc)
            return b""
        self._produced += len(data)
        return data

    def readinto(self, buf) -> int:
        if self._dead:
            return 0
        try:
            n = self._raw.readinto(buf)
        except Exception as exc:  # noqa: BLE001 - tolerant by contract
            self._fail(exc)
            return 0
        self._produced += n
        return n


class FastWARCIterator:
    """Iterate WARC records with filtering, lazy HTTP, optional digests.

    Parameters
    ----------
    source:
        file object, path, or bytes of a (possibly compressed) WARC file.
    record_types:
        bit mask of :class:`WarcRecordType` to yield; everything else is
        skipped via the cheap pre-filter path.
    parse_http:
        parse HTTP headers of ``application/http`` payloads on yield.
    verify_digests:
        verify ``WARC-Block-Digest`` / ``WARC-Payload-Digest``.
    func_filter:
        optional predicate applied after header parse, before HTTP parse.
    arena_bytes:
        initial arena size for the zero-copy path (default 1 MiB; grows
        geometrically past oversized records); also the readahead
        decoder's slot-packing watermark. Exposed for memory tuning and
        for tests that force arena recycling.
    readahead:
        overlap member decode with record parsing: a decoder thread
        inflates gzip/LZ4 members into arena slots ahead of the parser
        through a bounded slot ring
        (:class:`~repro_torch.core.warc.streams.ReadaheadDecoder`), or in
        a forked child process
        (:class:`~repro_torch.core.warc.streams.ProcessReadaheadDecoder`)
        for path and bytes sources outside a daemonic process. Default
        ``None`` enables it wherever it cannot lose work: gzip always
        (members must be inflated to find their boundaries anyway), LZ4
        only when no type filter is active (the filtered LZ4 path keeps
        the lazy first-block sniff + frame-hop skip, which readahead's
        decode-everything would defeat; pass ``readahead=True`` to
        force it regardless). ``close()`` joins the thread or reaps the
        child.
    readahead_depth:
        slot-batches the decoder may run ahead of the parser (ring
        bound; default 3 — double buffering plus one slot of slack
        against scheduler jitter on busy hosts).
    tolerant:
        recover from malformed input instead of raising: bad
        ``Content-Length``, garbage headers, truncated payloads and
        corrupt gzip/LZ4 members trigger a *resync scan* to the next
        record/member magic; each damaged byte range is quarantined
        into ``self.error_ledger`` (offset, shard, error class, bytes
        skipped) and parsing continues. Good records keep full
        zero-copy semantics. Strict mode behavior is bit-for-bit
        unchanged.
    error_ledger:
        optional shared :class:`~repro_torch.core.warc.errors.ErrorLedger` to
        append into (the tolerant index build aggregates one ledger
        across shards); default: a fresh per-iterator ledger.

    Record content is a borrowed ``memoryview`` into a pooled arena, see
    :meth:`WarcRecord.detach`. Every Python-level byte copy is tallied in
    ``self.copy_stats`` (:class:`~repro_torch.core.warc.streams.CopyStats`;
    decompressor output lands in ``decode_into_arena``); terminal
    counters publish to the ``ingest.*`` counters of
    :func:`repro_torch.obs.registry` on exhaustion or close, and
    ``ingest.readahead.process`` / ``ingest.readahead.thread`` count the
    readahead stages started.
    """

    def __init__(
        self,
        source: BinaryIO | bytes | str,
        *,
        record_types: WarcRecordType = WarcRecordType.any_type,
        parse_http: bool = True,
        verify_digests: bool = False,
        func_filter: Callable[[WarcRecord], bool] | None = None,
        arena_bytes: int | None = None,
        readahead: bool | None = None,
        readahead_depth: int = 3,
        tolerant: bool = False,
        error_ledger: ErrorLedger | None = None,
    ) -> None:
        self.tolerant = tolerant
        self.error_ledger = error_ledger if error_ledger is not None \
            else ErrorLedger()
        self._shard = source if isinstance(source, str) else None
        self._slot_damaged = False  # set by _record_from_slot on bad members
        self._owned_file: BinaryIO | None = None
        # path / bytes sources can be re-opened by a readahead decoder
        # *process* (fork ships bytes for free); file objects cannot
        self._source_spec: str | bytes | None = None
        if isinstance(source, str):
            self._source_spec = source
            source = open(source, "rb")
            self._owned_file = source
        elif isinstance(source, (bytes, bytearray, memoryview)):
            self._source_spec = bytes(source)
            source = io.BytesIO(self._source_spec)
        self._raw = source
        self.record_types = record_types
        self._types_mask = int(record_types)
        self._filter_active = self._types_mask != int(WarcRecordType.any_type)
        self.parse_http = parse_http
        self.verify_digests = verify_digests
        self.func_filter = func_filter
        self.arena_bytes = arena_bytes  # None: streams._ARENA_BYTES default
        self.readahead = readahead
        self.readahead_depth = readahead_depth
        self._decoder: ReadaheadDecoder | ProcessReadaheadDecoder | None = None
        self.copy_stats = CopyStats()
        self.records_skipped = 0
        self.records_yielded = 0
        self._obs_published = False
        # an externally-shared ledger (tolerant index build) predates this
        # iterator: publish only the entries added past this watermark
        self._ledger_base = len(self.error_ledger.entries())

        head = source.read(8)
        source.seek(-len(head), io.SEEK_CUR)
        self._kind = detect_compression(head)
        self._stream = None
        if self._kind == "gzip":
            # FastWARC-style raw deflate: the redundant per-member CRC is
            # off, end-to-end integrity comes from verify_digests
            self._stream = GZipStream(source)
        elif self._kind == "lz4":
            self._stream = LZ4Stream(source)
        elif self._kind == "zstd":
            # bulk C decode + in-buffer splitting (see ZstdStream docstring);
            # the arena path readintos straight out of the decompressor
            self._raw = ZstdStream(source)
            if tolerant:
                # zstd has no member boundaries to resync on: a damaged
                # stream truncates at the error point, ledgered as a tail
                self._raw = _TolerantReadGuard(self._raw, self._ledger)

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[WarcRecord]:
        if self.closed:
            return  # exhausted path-owned source: empty, like re-reading EOF
        try:
            if self._stream is None:
                yield from self._iter_uncompressed_arena()
            else:
                yield from self._iter_members_arena()
        finally:
            # files *we* opened (str paths) are released on exhaustion or
            # generator teardown — callers iterating many shards per epoch
            # must not accumulate fds (WarcTokenLoader does exactly that)
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
        """Release everything this iterator owns: join the readahead
        decoder thread (and free its ring slots) if one is running, and
        close the underlying file if this iterator opened it."""
        self._stop_decoder()
        self._publish_obs()
        if self._owned_file is not None and not self._owned_file.closed:
            self._owned_file.close()

    def __enter__(self) -> "FastWARCIterator":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- observability ----------------------------------------------------
    def _publish_obs(self) -> None:
        """Fold this iterator's terminal counters into the process-default
        registry (``ingest.*``): CopyStats, records yielded/skipped, and
        the ledger entries this iterator added. Idempotent — the first of
        exhaustion/close wins, so double-close never double-counts."""
        if self._obs_published:
            return
        self._obs_published = True
        reg = obs.registry()
        reg.fold_counters(self.copy_stats.as_dict(), prefix="ingest.")
        reg.fold_counters({
            "records": self.records_yielded,
            "records_skipped": self.records_skipped,
            "shards": 1,
            "ledger_entries":
                len(self.error_ledger.entries()) - self._ledger_base,
        }, prefix="ingest.")

    # -- fault accounting -------------------------------------------------
    def _ledger(self, offset: int, error_class: str, bytes_skipped: int,
                message: str = "") -> None:
        self.error_ledger.record(self._shard, offset, error_class,
                                 bytes_skipped, message)

    @staticmethod
    def _find_magic_anchored(rb: RecordBuffer, pos: int) -> int:
        """Next ``WARC/`` magic at a line start (tolerant resync target).

        Record payloads may legitimately contain ``WARC/`` (warcinfo
        bodies quote it); anchoring to a preceding LF keeps the resync
        scan from latching onto payload text mid-damaged-region.
        """
        nxt = rb.find(WARC_MAGIC, pos)
        while nxt > 0:
            if rb.startswith(b"\n", nxt - 1):
                return nxt
            nxt = rb.find(WARC_MAGIC, nxt + 1)
        return nxt

    # -- shared record assembly -----------------------------------------
    def _finalize(self, header_block: bytes, type_value: int,
                  content, offset: int) -> WarcRecord | None:
        """Assemble a record from its raw header block (headers stay lazy)."""
        rtype = RECORD_TYPE_FROM_VALUE[type_value]
        record = WarcRecord(header_block, rtype, content, offset,
                            stats=self.copy_stats)
        if self.func_filter is not None and not self.func_filter(record):
            self.records_skipped += 1
            return None
        if self.verify_digests:
            bd = _scan_header_field(header_block, b"WARC-Block-Digest:")
            if bd is not None:
                record.verified_block_digest = verify_digest(
                    record.content_view(), bd.decode("latin-1"))
        if self.parse_http and (type_value & HTTP_TYPE_MASK) and record.is_http:
            http, body_off = parse_http_fast(record.content_view())
            record.http_headers = http
            record.http_content_offset = body_off if http is not None else -1
            if self.verify_digests and record.http_headers is not None:
                pd = _scan_header_field(header_block, b"WARC-Payload-Digest:")
                if pd is not None:
                    record.verified_payload_digest = verify_digest(
                        record.payload_view(), pd.decode("latin-1"))
        self.records_yielded += 1
        return record

    # -- uncompressed / zstd: pooled-arena zero-copy splitting (default) --
    def _iter_uncompressed_arena(self) -> Iterator[WarcRecord]:
        # Absolute-offset parse over a RecordBuffer: fills land in a
        # reusable bytearray arena via readinto, record content is a
        # borrowed memoryview into it, and the only copies left are the
        # yielded records' (small) header blocks plus the arena-roll
        # tail — all tallied in self.copy_stats.
        raw = self._raw
        if self.arena_bytes is not None:
            rb = RecordBuffer(raw, stats=self.copy_stats,
                              arena_bytes=self.arena_bytes)
        else:
            rb = RecordBuffer(raw, stats=self.copy_stats)
        types_mask = self._types_mask
        filter_active = self._filter_active
        tolerant = self.tolerant
        magic_len = len(WARC_MAGIC)
        pos = 0  # absolute stream offset of the next unconsumed byte
        # tolerant bookkeeping: [damage_start, <next good magic>) is one
        # quarantined range of class damage_class when set
        damage_start: int | None = None
        damage_class = "garbage"
        while True:
            rb.discard(pos)
            if not rb.ensure(pos, magic_len):
                if tolerant and damage_start is not None \
                        and rb.end_abs > damage_start:
                    self._ledger(damage_start, damage_class,
                                 rb.end_abs - damage_start)
                return
            if not rb.startswith(WARC_MAGIC, pos):
                if tolerant and damage_start is None:
                    damage_start = pos
                nxt = self._find_magic_anchored(rb, pos) if tolerant \
                    else rb.find(WARC_MAGIC, pos)
                if nxt < 0:
                    if rb.eof:
                        if tolerant and damage_start is not None:
                            self._ledger(damage_start, damage_class,
                                         rb.end_abs - damage_start)
                        return
                    # garbage: keep only a magic-straddle tail, read on
                    pos = max(pos, rb.end_abs - magic_len + 1)
                    rb.discard(pos)
                    rb.ensure(pos, rb.end_abs - pos + 1)
                    continue
                pos = nxt
                rb.discard(pos)
            if tolerant and damage_start is not None:
                if pos > damage_start:
                    self._ledger(damage_start, damage_class,
                                 pos - damage_start)
                damage_start = None
                damage_class = "garbage"
            hdr_end = rb.find(HEADER_TERMINATOR, pos)
            while hdr_end < 0:
                if rb.eof:
                    if tolerant:
                        self._ledger(pos, "truncated_tail",
                                     rb.end_abs - pos)
                    return
                rb.ensure(pos, rb.end_abs - pos + _READ_BLOCK)
                hdr_end = rb.find(HEADER_TERMINATOR, pos)
            clen_raw = rb.scan_field(_CLEN_NEEDLE, pos, hdr_end)
            if tolerant:
                clen_opt = parse_content_length(clen_raw)
                if clen_opt is None:
                    # untrustworthy framing: quarantine from this record's
                    # magic and resync to the next one
                    damage_start = pos
                    damage_class = "bad_content_length"
                    pos += magic_len
                    continue
                clen = clen_opt
            else:
                clen = int(clen_raw) if clen_raw and clen_raw.isdigit() else 0
            body_start = hdr_end + 4
            record_end = body_start + clen + 4
            if tolerant:
                if not rb.ensure(pos, record_end - pos):
                    # EOF inside the claimed body. The whole tail is
                    # buffered now (ensure grew the arena to EOF), so a
                    # *bogus-but-numeric* length mid-file can still be
                    # resynced past instead of eating the rest of the
                    # shard; only a tail with no further record start is
                    # a true truncation.
                    nxt = self._find_magic_anchored(rb, pos + magic_len)
                    if nxt < 0:
                        self._ledger(pos, "truncated_tail",
                                     rb.end_abs - pos)
                        return
                    self._ledger(pos, "bad_content_length", nxt - pos)
                    pos = nxt
                    continue
                if not rb.startswith(HEADER_TERMINATOR, body_start + clen):
                    # Content-Length does not land on a record terminator:
                    # the framing is lies, resync rather than desync
                    damage_start = pos
                    damage_class = "bad_content_length"
                    pos += magic_len
                    continue

            type_raw = rb.scan_field(_TYPE_NEEDLE, pos, hdr_end)
            type_value = (UNKNOWN_TYPE_VALUE if type_raw is None else
                          RECORD_TYPE_VALUES.get(type_raw.lower(),
                                                 UNKNOWN_TYPE_VALUE))
            if filter_active and not (type_value & types_mask):
                # bottleneck (3): skipped records never leave the arena —
                # not even their header block is sliced out
                self.records_skipped += 1
                pos = record_end if rb.ensure(pos, record_end - pos) \
                    else rb.end_abs
                continue
            if not rb.ensure(pos, record_end - pos):
                return  # truncated final record (strict: silent stop)
            header_block = rb.take_bytes(pos, hdr_end)
            content = rb.view(body_start, body_start + clen)
            record = self._finalize(header_block, type_value, content, pos)
            pos = record_end
            if record is not None:
                yield record

    # -- gzip/lz4: decode-into-arena members ------------------------------
    def _resolve_readahead(self, is_lz4: bool) -> bool:
        if self.readahead is not None:
            return self.readahead
        # auto: on wherever it cannot lose work — gzip members must be
        # inflated to find their boundaries anyway; filtered LZ4 keeps
        # the lazy sniff + frame-hop skip instead
        return not (is_lz4 and self._filter_active)

    def _iter_members_arena(self) -> Iterator[WarcRecord]:
        stream = self._stream
        arena = MemberArena(stats=self.copy_stats)
        is_lz4 = isinstance(stream, LZ4Stream)
        if self._resolve_readahead(is_lz4):
            yield from self._iter_members_readahead(stream, arena)
        elif is_lz4 and self._filter_active:
            yield from self._iter_lz4_arena_lazy(stream, arena)
        elif self.tolerant:
            stats = self.copy_stats
            while True:
                slot = arena.acquire()
                item = next_member_tolerant(stream, slot, stats,
                                            self._ledger)
                if item is None:
                    arena.release(slot)
                    return
                n, offset = item
                record = self._record_from_slot(slot, 0, n, offset)
                if record is None and self._slot_damaged:
                    self._ledger(offset, "bad_member",
                                 stream.tell_compressed() - offset,
                                 "member decoded but contains no record")
                arena.release(slot)
                if record is not None:
                    yield record
        else:
            stats = self.copy_stats
            while True:
                offset = stream.tell_compressed()
                slot = arena.acquire()
                n = stream.next_member_into(slot, stats)
                if n is None:
                    arena.release(slot)
                    return
                record = self._record_from_slot(slot, 0, n, offset)
                arena.release(slot)
                if record is not None:
                    yield record

    def _iter_members_readahead(self, stream,
                                arena: MemberArena) -> Iterator[WarcRecord]:
        # a decoder stage inflates members into slot batches ahead of this
        # parse loop (bounded ring). Preferred implementation is a child
        # *process* (true CPU overlap — the GIL serializes a decoder
        # thread against a hot parse loop, see ProcessReadaheadDecoder);
        # in-memory/file-object sources without a fork context use the
        # decoder thread. Lifecycle contract either way: the stage dies
        # with this generator (finally) and with close().
        stats = self.copy_stats
        tolerant = self.tolerant
        watermark = self.arena_bytes if self.arena_bytes else _ARENA_BYTES
        decoder = None
        if self._source_spec is not None:
            try:
                decoder = ProcessReadaheadDecoder(
                    self._source_spec, arena, depth=self.readahead_depth,
                    watermark=watermark, tolerant=tolerant,
                    on_ledger=self._ledger)
            except (RuntimeError, OSError):
                decoder = None  # no fork / constrained /dev/shm: thread
        obs.registry().counter_add(
            "ingest.readahead.thread" if decoder is None
            else "ingest.readahead.process")
        if decoder is None:
            if tolerant:
                def decode_member(slot: bytearray):
                    return next_member_tolerant(stream, slot, stats,
                                                self._ledger)
            else:
                def decode_member(slot: bytearray):
                    offset = stream.tell_compressed()
                    n = stream.next_member_into(slot, stats)
                    return None if n is None else (n, offset)

            decoder = ReadaheadDecoder(decode_member, arena,
                                       depth=self.readahead_depth,
                                       watermark=watermark)
        self._decoder = decoder
        get = decoder.get
        release = decoder.release
        record_from_slot = self._record_from_slot
        try:
            while True:
                item = get()
                if item is None:
                    return
                _, slot, members = item
                for start, nbytes, offset in members:
                    record = record_from_slot(slot, start, nbytes, offset)
                    if record is None:
                        if tolerant and self._slot_damaged:
                            self._ledger(
                                offset, "bad_member", 0,
                                "member decoded but contains no record")
                        continue
                    yield record
                release(slot)
        finally:
            self._stop_decoder()

    def _iter_lz4_arena_lazy(self, stream,
                             arena: MemberArena) -> Iterator[WarcRecord]:
        # filtered LZ4: first block decodes into the slot for the type
        # sniff; skipped frames roll the prefix back off the slot and hop
        # block headers only — cheap skipping *and* arena decode
        types_mask = self._types_mask
        stats = self.copy_stats
        tolerant = self.tolerant
        while True:
            offset = stream.tell_compressed()
            slot = arena.acquire()
            try:
                member = stream.begin_member_into(slot)
                if member is None:
                    arena.release(slot)
                    return
                hdr_end = slot.find(HEADER_TERMINATOR, 0, member.prefix_len)
                sniff_end = hdr_end if hdr_end >= 0 else member.prefix_len
                type_raw = _scan_field_in(slot, _TYPE_NEEDLE, 0, sniff_end)
                type_value = (UNKNOWN_TYPE_VALUE if type_raw is None else
                              RECORD_TYPE_VALUES.get(type_raw.lower(),
                                                     UNKNOWN_TYPE_VALUE))
                if not (type_value & types_mask):
                    self.records_skipped += 1
                    member.skip()
                    arena.release(slot)
                    continue
                n = member.finish(stats)
            except Exception as exc:  # noqa: BLE001 - tolerant by contract
                if not tolerant:
                    arena.release(slot)
                    raise
                from .errors import classify_member_error

                del slot[:]  # partial first-block decode: roll it off
                arena.release(slot)
                skipped = stream.resync(offset)
                if skipped is None:
                    self._ledger(offset, "truncated_tail",
                                 stream.tell_compressed() - offset,
                                 repr(exc))
                    return
                self._ledger(offset, classify_member_error(exc), skipped,
                             repr(exc))
                continue
            record = self._record_from_slot(slot, 0, n, offset)
            if record is None and tolerant and self._slot_damaged:
                self._ledger(offset, "bad_member",
                             stream.tell_compressed() - offset,
                             "member decoded but contains no record")
            arena.release(slot)
            if record is not None:
                yield record

    def _record_from_slot(self, slot: bytearray, at: int, nbytes: int,
                          offset: int) -> WarcRecord | None:
        """Parse one decoded member in place: type/length sniffed off the
        slot, header block copied out (small, counted), content borrowed
        as a ``memoryview`` of the slot — the member-path twin of the
        :class:`RecordBuffer` parse."""
        self._slot_damaged = False
        end = at + nbytes
        start = slot.find(WARC_MAGIC, at, end)
        if start < 0:
            self._slot_damaged = True  # decoded fine, but no record in it
            return None
        hdr_end = slot.find(HEADER_TERMINATOR, start, end)
        if hdr_end < 0:
            self._slot_damaged = True
            return None
        type_raw = _scan_field_in(slot, _TYPE_NEEDLE, start, hdr_end)
        type_value = (UNKNOWN_TYPE_VALUE if type_raw is None else
                      RECORD_TYPE_VALUES.get(type_raw.lower(),
                                             UNKNOWN_TYPE_VALUE))
        if self._filter_active and not (type_value & self._types_mask):
            self.records_skipped += 1
            return None
        clen_raw = _scan_field_in(slot, _CLEN_NEEDLE, start, hdr_end)
        clen = int(clen_raw) if clen_raw and clen_raw.isdigit() else 0
        header_block = bytes(memoryview(slot)[start:hdr_end])
        self.copy_stats.count_copy(len(header_block))
        body_start = hdr_end + 4
        content = memoryview(slot)[body_start:min(body_start + clen, end)]
        return self._finalize(header_block, type_value, content, offset)

    def read_one(self) -> WarcRecord | None:
        """Parse and return the next record only (random-access support).

        Used by :class:`repro_torch.index.cdx.RandomAccessReader`: position the
        underlying file at a record boundary (a CDX offset), construct the
        iterator, call ``read_one()`` — exactly one member is decompressed
        and one record parsed; the rest of the archive is never touched.
        """
        # random-access reads are serving-side: the caller counts them
        # (gateway.records_fetched); a throwaway iterator publishing
        # ingest.shards/records per fetch would drown the real sweep
        # counters in the merged snapshot
        self._obs_published = True
        return next(iter(self), None)


def read_record_at(source, offset: int, *,
                   parse_http: bool = True,
                   verify_digests: bool = False,
                   shard: str | None = None) -> WarcRecord:
    """Parse exactly one record at absolute ``offset`` in ``source``.

    ``source`` is a seekable file object over the *addressable* stream —
    the compressed file for gzip/LZ4 members, the raw file for
    uncompressed WARCs (zstd has no cheap member boundaries — callers
    decompress first; see ``streams.ZstdStream``) — or a filesystem
    path, opened and closed around the read. This is the paper's
    "constant-time random access" claim made executable: cost is one
    seek + one member decode + one record parse, independent of archive
    size. The returned record's ``stream_offset`` is rebased to the
    absolute ``offset``.

    An offset that addresses no record raises
    :class:`~repro_torch.core.warc.errors.RecordReadError` carrying the offset
    and shard — never a bare ``zlib.error`` / ``struct.error`` /
    ``LZ4Error`` from the decode internals, and never a silent ``None``:
    whether the bytes there fail to decode (corrupted member) or decode
    to nothing (stale index, truncated shard), the caller asked for a
    record that does not exist.
    """
    if isinstance(source, (str, os.PathLike)):
        if shard is None:
            shard = os.fspath(source)
        with open(source, "rb") as f:
            return read_record_at(f, offset, parse_http=parse_http,
                                  verify_digests=verify_digests, shard=shard)
    try:
        source.seek(offset)
        # readahead off: one member is parsed and the iterator abandoned —
        # spinning a decoder thread per random-access read would be pure
        # cost
        it = FastWARCIterator(source, parse_http=parse_http,
                              verify_digests=verify_digests,
                              readahead=False)
        record = it.read_one()
    except (OSError, RecordReadError):
        raise
    except Exception as exc:
        raise RecordReadError(
            f"damaged record: {exc!r}", offset=offset, shard=shard) from exc
    if record is None:
        # e.g. a mid-member gzip offset: the member scan sees no magic
        # and reports a clean end-of-stream rather than an error
        raise RecordReadError("offset addresses no record "
                              "(stale index or truncated shard)",
                              offset=offset, shard=shard)
    # content may be a zero-copy borrow of the iterator's arena;
    # detach so the record outlives the abandoned iterator
    record.detach()
    record.stream_offset = offset
    return record
