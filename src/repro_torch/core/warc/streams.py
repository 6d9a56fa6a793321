"""Stream layer: compression-aware byte streams for WARC processing.

* :class:`ChunkedGzipReader` / :class:`PlainBufferedReader` — WARCIO's
  design: a fixed 16 KiB chunk loop with per-``read()`` Python
  buffering. Used only by the baseline parser
  (:mod:`~repro_torch.core.warc.warcio_ref`).
* :class:`GZipStream` — FastWARC-style: inflates whole gzip members in
  C calls and exposes *member boundaries* (one member per record), so
  the iterator can resync past damaged members.
* :class:`LZ4Stream` — frame-per-record streams over the pure-Python
  codec in :mod:`repro_torch.core.warc.lz4`; frames can be skipped
  without decompression (block-header hops).
* :class:`ZstdStream` — one streaming pass of the ``zstandard`` C
  decoder across all frames (imported on first use: every other codec
  runs without the package); :class:`ForwardWindow` makes a stream
  opened at a frame boundary seekable for random access.

Decode-into-arena layer: every member stream exposes
``next_member_into(slot)`` — the member's decompressed bytes are
*appended* to a pooled :class:`MemberArena` ``bytearray`` slot instead
of materializing per-record ``bytes``. Two readahead stages run that
decode ahead of the parser: :class:`ReadaheadDecoder` on a thread, and
:class:`ProcessReadaheadDecoder` in a forked child process that hands
batches over through a shared-memory slot ring (no GIL shared with the
parse loop). The child runs only the stdlib ``zlib`` and this package's
LZ4 code, so forking it beside a live CUDA context is safe. zstd needs
no member API: it streams through ``ZstdStream.readinto`` into the
:class:`RecordBuffer` arena.
"""
from __future__ import annotations

import io
import mmap
import os
import pickle
import queue
import select
import struct
import sys
import threading
import time
import zlib
from typing import BinaryIO, Iterator

try:
    from multiprocessing import shared_memory as _shm_mod
except ImportError:  # pragma: no cover - py>=3.8 everywhere we run
    _shm_mod = None

from repro_torch.obs.registry import ObsSnapshot
from repro_torch.obs.shmstats import (STATS_SLOT_BYTES, StatsSlotReader,
                                StatsSlotWriter)

from . import lz4 as _lz4
from .record import scan_header_field_in

GZIP_MAGIC = b"\x1f\x8b"
GZIP_MEMBER_MAGIC = b"\x1f\x8b\x08"  # magic + CM=deflate: the resync needle
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
LZ4_MAGIC_BYTES = b"\x04\x22\x4d\x18"

#: fault hook of the decoder child (armed by
#: :func:`repro_torch.testing.faults.arm_decoder_stall`)
FAULT_DECODER_STALL_ENV = "REPRO_TORCH_FAULT_DECODER_STALL"
#: seconds of silence after which the parent declares a decoder child
#: stalled and respawns it (unset: wait forever)
DECODER_STALL_S_ENV = "REPRO_TORCH_DECODER_STALL_S"

_CHUNK = 16 * 1024  # WARCIO's default read chunk
_READ_BLOCK = 1 << 20  # FastWARC-style bulk read
_DECODE_CHUNK = 256 * 1024  # max zlib output temporary on the into-path


def detect_compression(head: bytes) -> str:
    if head.startswith(GZIP_MAGIC):
        return "gzip"
    if head.startswith(LZ4_MAGIC_BYTES):
        return "lz4"
    if head.startswith(ZSTD_MAGIC):
        return "zstd"
    return "none"


# --------------------------------------------------------------------------
# Member-oriented decompressed-payload iterators (FastWARC-style fast path)
# --------------------------------------------------------------------------

class MemberStream:
    """Iterator over per-record compression members/frames.

    ``next_member()`` returns the decompressed bytes of the next member, or
    ``None`` at EOF. ``skip_member()`` advances without (fully) materializing
    where the format allows it. ``next_member_into()`` is the streaming
    decode-into API: the member's decompressed bytes are
    *appended* to a caller-provided ``bytearray`` (an arena slot), so no
    member-sized ``bytes`` object is ever allocated — consecutive members
    pack back-to-back in one slot.
    """

    def next_member(self) -> bytes | None:
        raise NotImplementedError

    def next_member_into(self, out: bytearray,
                         stats: "CopyStats | None" = None) -> int | None:
        """Append the next member's decompressed bytes to ``out``; returns
        the byte count, or ``None`` at EOF.

        Base implementation materializes via :meth:`next_member` and
        copies (counted); subclasses override with true decode-into.
        """
        data = self.next_member()
        if data is None:
            return None
        out += data
        if stats is not None:
            stats.count_copy(len(data))
        return len(data)

    def skip_member(self) -> bool:
        data = self.next_member()
        return data is not None

    def tell_compressed(self) -> int:
        raise NotImplementedError


class GZipStream(MemberStream):
    """Concatenated-gzip-member reader with C-call member decode.

    Feeds the decompressor bounded ``memoryview`` slices so the
    ``unused_data`` tail copy stays O(feed) per member instead of
    O(remaining buffer) — the latter is quadratic over a file.

    Member headers are parsed by hand and the deflate stream inflated
    raw (``wbits=-15``) — the real FastWARC's design: the per-member
    CRC32 is not checked (end-to-end integrity belongs to
    ``verify_digests``), which saves ~16 % of member decode time at
    Common-Crawl-ish member sizes.
    """

    # first feed per member: covers p99 of Common-Crawl-ish compressed
    # members in one C call while keeping the per-member unused_data
    # tail copy ~half the 16 KiB it used to be (measured ~0.7 µs/member)
    _FEED = 8 * 1024

    def __init__(self, raw: BinaryIO) -> None:
        self._raw = raw
        self._buf = b""
        self._off = 0
        self._abs = 0  # compressed offset of _buf[0]
        self._eof = False

    def _fill(self) -> bool:
        chunk = self._raw.read(_READ_BLOCK)
        if not chunk:
            self._eof = True
            return False
        if self._off:
            self._abs += self._off
            self._buf = self._buf[self._off:] + chunk
            self._off = 0
        else:
            self._buf += chunk  # bytes: rebind, never resize
        return True

    def _ensure(self, need: int) -> bool:
        """At least ``need`` bytes buffered past the cursor."""
        while len(self._buf) - self._off < need:
            if not self._fill():
                return False
        return True

    def _skip_member_header(self) -> bool | None:
        """Advance the cursor past one gzip member header.

        ``None`` at clean EOF (cursor on end-of-stream); raises
        ``zlib.error`` on malformed or truncated headers. Handles the
        full RFC 1952 layout: FEXTRA, FNAME, FCOMMENT, FHCRC.
        """
        if not self._ensure(1):
            return None
        if not self._ensure(10):
            raise zlib.error("truncated gzip member header")
        buf, off = self._buf, self._off
        if buf[off] != 0x1F or buf[off + 1] != 0x8B:
            raise zlib.error("bad gzip member magic")
        if buf[off + 2] != 8:
            raise zlib.error("unsupported gzip compression method")
        flg = buf[off + 3]
        self._off = off + 10
        if flg & 0x04:  # FEXTRA: 2-byte little-endian length + payload
            if not self._ensure(2):
                raise zlib.error("truncated gzip member header")
            buf = self._buf
            xlen = buf[self._off] | (buf[self._off + 1] << 8)
            if not self._ensure(2 + xlen):
                raise zlib.error("truncated gzip member header")
            self._off += 2 + xlen
        for bit in (0x08, 0x10):  # FNAME / FCOMMENT: zero-terminated
            if flg & bit:
                while True:
                    i = self._buf.find(b"\x00", self._off)
                    if i >= 0:
                        self._off = i + 1
                        break
                    self._off = len(self._buf)
                    if not self._fill():
                        raise zlib.error("truncated gzip member header")
        if flg & 0x02:  # FHCRC
            if not self._ensure(2):
                raise zlib.error("truncated gzip member header")
            self._off += 2
        return True

    def _decode_member_body(self, sink_append) -> int:
        """Inflate one member's raw-deflate body + consume the trailer.

        ``sink_append`` receives ``_DECODE_CHUNK``-bounded output chunks
        (a list's ``append`` for the bytes API, a slot's ``extend`` for
        decode-into). Returns the decompressed byte count.
        """
        d = zlib.decompressobj(-15)
        written = 0
        feed_size = self._FEED
        while True:
            if self._off >= len(self._buf) and not self._fill():
                raise zlib.error("truncated gzip member")
            view = memoryview(self._buf)
            feed = view[self._off:self._off + feed_size]
            chunk = d.decompress(feed, _DECODE_CHUNK)
            while True:
                if chunk:
                    sink_append(chunk)
                    written += len(chunk)
                if d.eof or not d.unconsumed_tail:
                    break
                chunk = d.decompress(d.unconsumed_tail, _DECODE_CHUNK)
            if d.eof:
                self._off += len(feed) - len(d.unused_data)
                break
            self._off += len(feed)
            feed_size = _READ_BLOCK  # big member: switch to large feeds
        if not self._ensure(8):  # trailer: CRC32 + ISIZE (mod 2^32)
            raise zlib.error("truncated gzip member")
        self._off += 8
        return written

    def next_member(self) -> bytes | None:
        if self._skip_member_header() is None:
            return None
        parts: list[bytes] = []
        self._decode_member_body(parts.append)
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def next_member_into(self, out: bytearray,
                         stats: "CopyStats | None" = None) -> int | None:
        """Decode the next gzip member by appending it to ``out``.

        zlib exposes no decompress-into API, so "into" here means
        ``max_length``-bounded chunks appended straight onto the
        caller's arena slot: the member-sized join and ``bytes`` object
        of :meth:`next_member` are gone, temporaries are capped at
        ``_DECODE_CHUNK``. Appended bytes are tallied in the ledger's
        ``decode_into_arena`` counter.
        """
        if self._skip_member_header() is None:
            return None
        written = self._decode_member_body(out.extend)
        if stats is not None:
            stats.count_decode_into(written)
        return written

    def tell_compressed(self) -> int:
        return self._abs + self._off

    def resync(self, start_abs: int) -> int | None:
        """Seek forward from a damaged member to the next plausible one.

        Scans for the next gzip member magic (``1f 8b 08``) strictly
        after ``start_abs``, leaves the cursor on it, and returns the
        number of bytes skipped from ``start_abs``; ``None`` when EOF
        arrives first (cursor parked at end-of-stream). Bytes before the
        current buffer window are gone (already compacted), so a decode
        error detected deep inside a member can at worst resync to a
        *later* member — the skipped range is still accounted exactly.
        """
        pos = max(start_abs + 1 - self._abs, 0)
        while True:
            i = self._buf.find(GZIP_MEMBER_MAGIC, pos)
            if i >= 0:
                self._off = i
                return self._abs + i - start_abs
            # keep a straddle tail shorter than the needle, read more
            keep = max(len(self._buf) - (len(GZIP_MEMBER_MAGIC) - 1), pos, 0)
            self._off = min(keep, len(self._buf))
            if not self._fill():
                self._off = len(self._buf)
                return None
            pos = 0  # _fill compacted the buffer down to the kept tail


def _map_file(raw) -> "mmap.mmap | None":
    """A read-only map of the whole regular file behind ``raw``, or
    ``None`` for a source without one (in-memory buffers, empty files)."""
    try:
        fd = raw.fileno()
        if os.fstat(fd).st_size == 0:
            return None
        return mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
    except (AttributeError, OSError, ValueError):
        return None


class LZ4Stream(MemberStream):
    """Frame-per-record LZ4 reader; ``skip_member`` hops block headers only.

    Frame skipping needs random access, so the frames are addressed in
    one buffer: a read-only map of the file where the source has one
    (a random-access read then touches only its own frame's pages, not
    the rest of the shard), else the source's remaining bytes. Positions
    inside the buffer are absolute; :meth:`tell_compressed` and
    :meth:`resync` count from where the source stood when the stream
    was opened.
    """

    def __init__(self, raw: BinaryIO) -> None:
        mapped = _map_file(raw)
        if mapped is not None:
            self._buf = mapped
            self._base = raw.tell()
        else:
            self._buf = raw.read()
            self._base = 0
        self._pos = self._base

    def next_member(self) -> bytes | None:
        if self._pos >= len(self._buf):
            return None
        # content checksums are not checked: end-to-end integrity
        # belongs to verify_digests, as for gzip members
        data, self._pos = _lz4.decompress_frame(
            self._buf, self._pos, verify_checksum=False)
        return data

    def next_member_into(self, out: bytearray,
                         stats: "CopyStats | None" = None) -> int | None:
        """Decode the next frame by appending it to ``out`` — true
        decode-into: blocks land straight in the caller's arena slot
        (:func:`repro_torch.core.warc.lz4.decompress_frame_into`), nothing
        member- or block-sized is materialized or joined."""
        if self._pos >= len(self._buf):
            return None
        n, self._pos = _lz4.decompress_frame_into(
            self._buf, self._pos, out, verify_checksum=False)
        if stats is not None:
            stats.count_decode_into(n)
        return n

    def skip_member(self) -> bool:
        if self._pos >= len(self._buf):
            return False
        self._pos = _lz4.skip_frame(self._buf, self._pos)
        return True

    def begin_member(self) -> "_LazyLZ4Member | None":
        """Start reading the next frame lazily: only the first block is
        decompressed up front (enough to sniff the WARC header block); the
        caller then either ``read_all()`` or ``skip()`` — skipping costs
        block-header hops only. This is bottleneck (3) of the paper realized
        for a compressed stream."""
        if self._pos >= len(self._buf):
            return None
        return _LazyLZ4Member(self, self._pos)

    def begin_member_into(self, out: bytearray) -> "_LazyLZ4MemberInto | None":
        """Decode-into twin of :meth:`begin_member`: the first block is
        appended to the caller's arena slot for the type sniff; the
        caller then either ``finish()``es the member in place or
        ``skip()``s — rolling the prefix back off the slot and hopping
        the remaining block headers without decompression."""
        if self._pos >= len(self._buf):
            return None
        return _LazyLZ4MemberInto(self, self._pos, out)

    def tell_compressed(self) -> int:
        return self._pos - self._base

    def resync(self, start_abs: int) -> int | None:
        """Seek forward to the next *valid* frame header after ``start_abs``.

        Candidate magics are validated with :func:`lz4.parse_frame_header`
        (version bits + block-size code + header checksum), so false
        positives inside damaged compressed data are skipped over.
        Returns bytes skipped from ``start_abs``; ``None`` at EOF.
        """
        i = self._buf.find(LZ4_MAGIC_BYTES, self._base + start_abs + 1)
        while i >= 0:
            try:
                _lz4.parse_frame_header(self._buf, i)
            except _lz4.LZ4Error:
                i = self._buf.find(LZ4_MAGIC_BYTES, i + 1)
                continue
            self._pos = i
            return i - self._base - start_abs
        self._pos = len(self._buf)
        return None


class _LazyLZ4Member:
    __slots__ = ("_stream", "_start", "_info", "_first_end", "_ended", "prefix")

    def __init__(self, stream: "LZ4Stream", start: int) -> None:
        self._stream = stream
        self._start = start
        buf = stream._buf
        self._info = _lz4.parse_frame_header(buf, start)
        pos = start + self._info.header_len
        (bsz,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if bsz == 0:  # empty frame: EndMark immediately
            self.prefix = b""
            self._first_end = pos
            self._ended = True
            return
        self._ended = False
        raw = bool(bsz & 0x80000000)
        bsz &= 0x7FFFFFFF
        chunk = memoryview(buf)[pos:pos + bsz]
        self.prefix = bytes(chunk) if raw else _lz4.decompress_block(
            chunk, max_size=self._info.block_size)
        self._first_end = pos + bsz

    def read_all(self) -> bytes:
        """Decompress the remaining blocks and advance the stream."""
        buf = self._stream._buf
        parts = [self.prefix]
        pos = self._first_end
        if not self._ended:
            while True:
                (bsz,) = struct.unpack_from("<I", buf, pos)
                pos += 4
                if bsz == 0:
                    break
                raw = bool(bsz & 0x80000000)
                bsz &= 0x7FFFFFFF
                chunk = memoryview(buf)[pos:pos + bsz]
                parts.append(bytes(chunk) if raw else _lz4.decompress_block(
                    chunk, max_size=self._info.block_size))
                pos += bsz
        if self._info.content_checksum:
            pos += 4
        self._stream._pos = pos
        return b"".join(parts) if len(parts) > 1 else self.prefix

    def skip(self) -> None:
        """Advance past the frame without decompressing remaining blocks."""
        self._stream._pos = _lz4.skip_frame(self._stream._buf, self._start)


class _LazyLZ4MemberInto:
    """Into-arena twin of :class:`_LazyLZ4Member`.

    The first block is *appended* to the caller's slot (enough to sniff
    the WARC header); ``finish()`` appends the remaining blocks in
    place, ``skip()`` rolls the appended prefix back off the slot and
    hops the rest of the frame without decompressing. ``prefix_len``
    bytes starting at the slot length observed at construction hold the
    sniffable prefix.
    """

    __slots__ = ("_stream", "_start", "_info", "_pos", "_out", "_base",
                 "prefix_len", "_ended")

    def __init__(self, stream: "LZ4Stream", start: int,
                 out: bytearray) -> None:
        self._stream = stream
        self._start = start
        self._out = out
        self._base = len(out)
        buf = stream._buf
        self._info = _lz4.parse_frame_header(buf, start)
        n, pos, ended = _lz4._decode_blocks_into(
            memoryview(buf), start + self._info.header_len, out,
            self._info, max_blocks=1)
        self.prefix_len = n
        self._pos = pos
        self._ended = ended

    def finish(self, stats: "CopyStats | None" = None) -> int:
        """Append the remaining blocks and advance the stream past the
        frame; returns the member's total byte count."""
        n = self.prefix_len
        pos = self._pos
        if not self._ended:
            buf = self._stream._buf
            more, pos, _ = _lz4._decode_blocks_into(
                memoryview(buf), pos, self._out, self._info)
            n += more
        if self._info.content_checksum:
            pos += 4
        self._stream._pos = pos
        if stats is not None:
            stats.count_decode_into(n)
        return n

    def skip(self) -> None:
        """Roll the appended prefix back and hop past the frame without
        decompressing the remaining blocks."""
        del self._out[self._base:]
        self._stream._pos = _lz4.skip_frame(self._stream._buf, self._start)


class ZstdStream:
    """Bulk zstd reader: one C-speed streaming pass across all frames.

    zstd frames do not expose their compressed length without a block walk,
    so per-member random access buys nothing over gzip; the fast parser
    instead decompresses the stream lazily (``read()``) and does in-buffer
    record splitting, which also preserves Content-Length skipping on the
    decompressed bytes. (Read-path counterpart of ``WarcWriter('zstd')``.)
    """

    def __init__(self, raw: BinaryIO) -> None:
        try:
            import zstandard as _zstd
        except ImportError as exc:
            raise RuntimeError("zstandard not available") from exc
        self._reader = _zstd.ZstdDecompressor().stream_reader(
            raw, read_across_frames=True)

    def read(self, n: int = -1) -> bytes:
        return self._reader.read(n if n >= 0 else -1)

    def readinto(self, buf) -> int:
        """Decompress directly into ``buf`` (zero-copy arena fills)."""
        return self._reader.readinto(buf)


class ForwardWindow:
    """Seekable facade over a forward-only reader, at an offset origin.

    Wraps a streaming decompressor (e.g. :class:`ZstdStream` opened at a
    frame boundary) so :func:`repro_torch.core.warc.read_record_at` can use it
    like a file positioned in the *decompressed* stream: position ``base``
    corresponds to the wrapped reader's byte 0, forward seeks discard,
    and a small pushback tail absorbs the parser's short look-behind
    (the 8-byte compression sniff). Backward seeks past the tail raise —
    the record parser never does that.
    """

    _KEEP = 64  # pushback capacity; the parser rewinds ≤ 8 bytes

    def __init__(self, reader, base: int = 0) -> None:
        self._r = reader
        self._pos = base
        self._origin = base
        self._pending = b""   # pushed-back bytes, next to be read
        self._tail = b""      # most recent _KEEP bytes handed out

    def read(self, n: int = -1) -> bytes:
        parts: list[bytes] = []
        if self._pending:
            take = self._pending if n < 0 else self._pending[:n]
            self._pending = self._pending[len(take):]
            parts.append(take)
        need = -1 if n < 0 else n - sum(len(p) for p in parts)
        while need != 0:
            chunk = self._r.read(_READ_BLOCK if need < 0 else need)
            if not chunk:
                break
            parts.append(chunk)
            if need > 0:
                need -= len(chunk)
        out = b"".join(parts)
        self._pos += len(out)
        self._tail = (self._tail + out)[-self._KEEP:]
        return out

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_CUR:
            target = self._pos + offset
        elif whence == io.SEEK_SET:
            target = offset
        else:  # SEEK_END needs the stream length, which is unknowable here
            raise ValueError(f"unsupported whence {whence}")
        if target < self._origin:
            raise ValueError(f"seek before window origin {self._origin}")
        delta = target - self._pos
        if delta < 0:
            if -delta > len(self._tail):
                raise ValueError("seek beyond the pushback tail")
            self._pending = self._tail[delta:] + self._pending
            self._tail = self._tail[:delta]
            self._pos = target
        elif delta > 0:
            while self._pos < target:
                if not self.read(min(target - self._pos, _READ_BLOCK)):
                    break  # short stream: behave like file seek past EOF
        return self._pos

    def tell(self) -> int:
        return self._pos


class UncompressedMemberStream(MemberStream):
    """Degenerate member stream: one member == the whole file.

    The fast parser does its own in-buffer record splitting for the
    uncompressed case, so this exists only for API uniformity.
    """

    def __init__(self, raw: BinaryIO) -> None:
        self._raw = raw
        self._done = False
        self._pos = 0

    def next_member(self) -> bytes | None:
        if self._done:
            return None
        self._done = True
        data = self._raw.read()
        self._pos = len(data)
        return data

    def tell_compressed(self) -> int:
        return self._pos


def open_member_stream(raw: BinaryIO) -> tuple[MemberStream | None, str]:
    """Sniff compression and return the matching member stream.

    zstd returns ``(None, "zstd")`` — it has no cheap member boundaries;
    callers should wrap the source in :class:`ZstdStream` for bulk reads.
    """
    head = raw.read(8)
    if not raw.seekable():  # pragma: no cover - all our sources are seekable
        raise ValueError("non-seekable source")
    raw.seek(-len(head), io.SEEK_CUR)
    kind = detect_compression(head)
    if kind == "gzip":
        return GZipStream(raw), kind
    if kind == "lz4":
        return LZ4Stream(raw), kind
    return None, kind


def open_member_stream_at(raw: BinaryIO,
                          offset: int) -> tuple[MemberStream | None, str]:
    """:func:`open_member_stream`, positioned at compressed ``offset``.

    The respawn path of :class:`ProcessReadaheadDecoder`: a replacement
    decode child resumes exactly where the last fully-received batch of
    its predecessor ended, so parent-visible offsets stay absolute and
    results stay deterministic across child deaths.
    """
    stream, kind = open_member_stream(raw)
    if offset and stream is not None:
        if kind == "gzip":
            raw.seek(offset)
            stream._buf = b""
            stream._abs = offset
        else:  # lz4: the whole file is addressable from its start
            stream._pos = stream._base + offset
    return stream, kind


def next_member_tolerant(stream: MemberStream, out: bytearray, stats,
                         report) -> tuple[int, int] | None:
    """Decode the next member, resyncing past damaged ones.

    The tolerant-mode twin of ``stream.next_member_into``: a member that
    fails to decode (bad header, corrupt deflate/LZ4 blocks, truncated
    tail) has its partial output rolled back off ``out``, the stream
    resynced to the next member header, and the damaged compressed range
    reported via ``report(offset, error_class, bytes_skipped, message)``.

    Returns ``(nbytes, member_offset)`` for the next good member, or
    ``None`` at EOF. Catches ``Exception`` broadly: damaged compressed
    data surfaces as ``zlib.error``, ``LZ4Error``, ``struct.error``,
    ``IndexError``... — any of them means "this member is gone", and in
    tolerant mode no member may take down the shard.
    """
    from .errors import classify_member_error

    while True:
        offset = stream.tell_compressed()
        base = len(out)
        try:
            n = stream.next_member_into(out, stats)
        except Exception as exc:  # noqa: BLE001 - tolerant by contract
            del out[base:]  # roll the partial decode off the slot
            skipped = stream.resync(offset)
            if skipped is None:
                report(offset, "truncated_tail",
                       stream.tell_compressed() - offset, repr(exc))
                return None
            report(offset, classify_member_error(exc), skipped, repr(exc))
            continue
        if n is None:
            return None
        return n, offset


# --------------------------------------------------------------------------
# WARCIO-faithful chunked decompressing reader (baseline parser only)
# --------------------------------------------------------------------------

class ChunkedGzipReader:
    """Python-chunked gzip reader modeled on WARCIO's
    ``DecompressingBufferedReader``: 16 KiB compressed chunks, incremental
    decompress on every ``read``/``readline``, member restart on EOF of a
    member. This *is* the measured baseline behaviour, do not optimize."""

    def __init__(self, raw: BinaryIO) -> None:
        self._raw = raw
        self._decomp = zlib.decompressobj(31)
        self._buf = b""
        self._off = 0
        self._comp_tail = b""
        self._eof = False

    def _fill(self) -> None:
        while not self._eof and self._off >= len(self._buf):
            comp = self._comp_tail or self._raw.read(_CHUNK)
            self._comp_tail = b""
            if not comp:
                self._eof = True
                return
            out = self._decomp.decompress(comp)
            if self._decomp.eof:
                self._comp_tail = self._decomp.unused_data
                self._decomp = zlib.decompressobj(31)
            if out:
                self._buf = out
                self._off = 0
                return

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            parts = [self._buf[self._off:]]
            self._off = len(self._buf)
            while True:
                self._fill()
                if self._off >= len(self._buf):
                    break
                parts.append(self._buf[self._off:])
                self._off = len(self._buf)
            return b"".join(parts)
        parts = []
        need = n
        while need > 0:
            if self._off >= len(self._buf):
                self._fill()
                if self._off >= len(self._buf):
                    break
            take = self._buf[self._off:self._off + need]
            self._off += len(take)
            need -= len(take)
            parts.append(take)
        return b"".join(parts)

    def readline(self) -> bytes:
        parts = []
        while True:
            if self._off >= len(self._buf):
                self._fill()
                if self._off >= len(self._buf):
                    break
            i = self._buf.find(b"\n", self._off)
            if i >= 0:
                parts.append(self._buf[self._off:i + 1])
                self._off = i + 1
                break
            parts.append(self._buf[self._off:])
            self._off = len(self._buf)
        return b"".join(parts)


class PlainBufferedReader:
    """Uncompressed counterpart of :class:`ChunkedGzipReader` (baseline)."""

    def __init__(self, raw: BinaryIO) -> None:
        self._raw = raw
        self._buf = b""
        self._off = 0

    def _fill(self) -> None:
        if self._off >= len(self._buf):
            self._buf = self._raw.read(_CHUNK)
            self._off = 0

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            rest = self._buf[self._off:] + self._raw.read()
            self._buf = b""
            self._off = 0
            return rest
        parts = []
        need = n
        while need > 0:
            self._fill()
            if self._off >= len(self._buf):
                break
            take = self._buf[self._off:self._off + need]
            self._off += len(take)
            need -= len(take)
            parts.append(take)
        return b"".join(parts)

    def readline(self) -> bytes:
        parts = []
        while True:
            self._fill()
            if self._off >= len(self._buf):
                break
            i = self._buf.find(b"\n", self._off)
            if i >= 0:
                parts.append(self._buf[self._off:i + 1])
                self._off = i + 1
                break
            parts.append(self._buf[self._off:])
            self._off = len(self._buf)
        return b"".join(parts)


# --------------------------------------------------------------------------
# Zero-copy pooled parse arena (FastWARC-style buffered reader)
# --------------------------------------------------------------------------

class CopyStats:
    """Byte-copy / allocation ledger for the ingest hot path.

    Every Python-level copy of payload bytes (buffer joins, compaction,
    header-block slices, ``detach()``/``content`` materialization) and
    every arena allocation is counted here, so the ingest benchmark can
    *prove* — not eyeball — that the zero-copy path stopped copying.
    Decompressor output is deliberately not counted: producing those
    bytes is the work itself, not overhead.

    Member decode is split the same way: member paths that
    materialize every decompressed member as a fresh ``bytes`` object —
    those bytes are tallied in ``member_bytes_copied`` — while the
    decode-into-arena paths append decompressor output straight onto a
    pooled slot, tallied in ``decode_into_arena`` (informational: it is
    the decompression work itself, not copy overhead). A gzip/LZ4 sweep
    whose ``bytes_copied + member_bytes_copied`` per record collapses to
    the uncompressed path's header-copy budget has stopped paying the
    per-record member-allocation tax.
    """

    __slots__ = ("copies", "bytes_copied", "allocs", "bytes_allocated",
                 "arena_reuses", "member_bytes_copied", "decode_into_arena")

    def __init__(self) -> None:
        self.copies = 0
        self.bytes_copied = 0
        self.allocs = 0
        self.bytes_allocated = 0
        self.arena_reuses = 0
        self.member_bytes_copied = 0
        self.decode_into_arena = 0

    def count_copy(self, nbytes: int) -> None:
        self.copies += 1
        self.bytes_copied += nbytes

    def count_alloc(self, nbytes: int) -> None:
        self.allocs += 1
        self.bytes_allocated += nbytes

    def count_member_copy(self, nbytes: int) -> None:
        """A decompressed member materialized as a per-record ``bytes``."""
        self.member_bytes_copied += nbytes

    def count_decode_into(self, nbytes: int) -> None:
        """Member bytes decoded directly into a pooled arena slot."""
        self.decode_into_arena += nbytes

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"CopyStats(copies={self.copies}, "
                f"bytes_copied={self.bytes_copied}, "
                f"member_bytes_copied={self.member_bytes_copied}, "
                f"allocs={self.allocs}, reuses={self.arena_reuses})")


_ARENA_BYTES = 1 << 20   # default arena size; grows geometrically per record
_ARENA_POOL_MAX = 4      # retired arenas kept for recycling


class RecordBuffer:
    """Pooled-arena buffered reader: the zero-copy parse surface.

    The parser addresses the stream by **absolute offset**; this class
    maps those offsets onto a reusable ``bytearray`` arena filled with
    ``readinto`` (no intermediate ``bytes`` objects where the source
    supports it). Record content is handed out as :meth:`view`
    ``memoryview`` slices — no per-record ``bytes`` slicing.

    Lifetime contract: a view pins its arena. Retired arenas go to a
    small pool and are recycled **only when no outstanding view
    references them** (checked via the arena's refcount), so borrowed
    views are never silently clobbered — consumers that drop records as
    they stream get steady-state zero allocation, consumers that hold
    records trade memory (fresh arenas) for safety. ``WarcRecord.detach``
    copies a record out and releases its pin.
    """

    def __init__(self, raw, *, arena_bytes: int = _ARENA_BYTES,
                 stats: CopyStats | None = None) -> None:
        self._raw = raw
        self._readinto = getattr(raw, "readinto", None)
        self._arena_bytes = max(arena_bytes, 4096)
        self.stats = stats if stats is not None else CopyStats()
        self._buf = bytearray(self._arena_bytes)
        self.stats.count_alloc(self._arena_bytes)
        self._pool: list[bytearray] = []
        self._start = 0   # discard watermark (buffer-relative)
        self._end = 0     # fill watermark (buffer-relative)
        self._base = 0    # absolute stream offset of _buf[0]
        self.eof = False

    # -- addressing ------------------------------------------------------
    @property
    def end_abs(self) -> int:
        """Absolute offset one past the last buffered byte."""
        return self._base + self._end

    def ensure(self, pos: int, need: int) -> bool:
        """Make ``[pos, pos + need)`` addressable; never moves ``pos``."""
        while True:
            if self._base + self._end - pos >= need:
                return True
            if self.eof:
                return False
            if self._end >= len(self._buf) or \
                    pos - self._base + need > len(self._buf):
                self._roll(pos, need)
            self._fill_tail()

    def find(self, needle: bytes, pos: int, end: int | None = None) -> int:
        """Absolute offset of ``needle`` in the buffered region, or -1."""
        rel_end = self._end if end is None else min(end - self._base,
                                                   self._end)
        i = self._buf.find(needle, max(pos - self._base, 0), rel_end)
        return -1 if i < 0 else self._base + i

    def startswith(self, needle: bytes, pos: int) -> bool:
        return self._buf.startswith(needle, pos - self._base)

    def view(self, a: int, b: int) -> memoryview:
        """Zero-copy borrow of ``[a, b)``; pins the arena (see class doc)."""
        return memoryview(self._buf)[a - self._base:b - self._base]

    def take_bytes(self, a: int, b: int) -> bytes:
        """Owning ``bytes`` copy of ``[a, b)`` (counted)."""
        out = bytes(memoryview(self._buf)[a - self._base:b - self._base])
        self.stats.count_copy(len(out))
        return out

    def discard(self, pos: int) -> None:
        """Mark everything below absolute ``pos`` consumed (reusable)."""
        rel = pos - self._base
        if rel > self._start:
            self._start = rel

    def scan_field(self, needle: bytes, a: int, b: int) -> bytes | None:
        """Line-anchored ``Name:``-field scan inside ``[a, b)``, in-arena.

        Delegates to :func:`repro_torch.core.warc.record.scan_header_field_in`
        (shared with the member-decode slots): skipped records get their
        type/length sniffed straight off the arena — no header block is
        ever sliced out for them. Only the (tiny) field value is
        materialized.
        """
        return scan_header_field_in(self._buf, needle,
                                    a - self._base, b - self._base)

    # -- internals -------------------------------------------------------
    def _take_arena(self, capacity: int) -> bytearray:
        """Recycle a retired arena iff nothing references it anymore."""
        import sys

        for i in range(len(self._pool)):
            cand = self._pool[i]
            # refs: pool list + `cand` local + getrefcount argument == 3;
            # any outstanding memoryview/ndarray raises the count
            if len(cand) >= capacity and sys.getrefcount(cand) <= 3:
                self.stats.arena_reuses += 1
                return self._pool.pop(i)
        cap = self._arena_bytes
        while cap < capacity:
            cap *= 2
        self.stats.count_alloc(cap)
        return bytearray(cap)

    def _roll(self, pos: int, need: int) -> None:
        """Move the live tail onto a fresh/recycled arena.

        The only copy on the whole parse path: the bytes of the record
        currently straddling the arena edge (amortized: a fraction of one
        record per arena, not per record). Growth is geometric — at most
        a doubling per roll, never ``need`` upfront: a hostile or corrupt
        ``Content-Length`` (terabyte ``need``) must not allocate anything
        the stream hasn't backed with bytes; ``ensure`` keeps rolling as
        real data arrives and surfaces EOF as a truncated record instead.
        """
        live_start = min(self._start, pos - self._base)
        live = self._end - live_start
        cap_limit = max(2 * len(self._buf), self._arena_bytes)
        new = self._take_arena(max(min(live + need, cap_limit), live + 1))
        if live:
            new[:live] = memoryview(self._buf)[live_start:self._end]
            self.stats.count_copy(live)
        old = self._buf
        self._buf = new
        self._base += live_start
        self._end = live
        self._start = 0
        if len(self._pool) >= _ARENA_POOL_MAX:
            self._pool.pop(0)  # dropped; freed once its views die
        self._pool.append(old)

    def _fill_tail(self) -> None:
        space = len(self._buf) - self._end
        if space <= 0:
            return
        if self._readinto is not None:
            n = self._readinto(memoryview(self._buf)[self._end:])
            if not n:
                self.eof = True
            else:
                self._end += n
            return
        chunk = self._raw.read(space)
        if not chunk:
            self.eof = True
            return
        self._buf[self._end:self._end + len(chunk)] = chunk
        self.stats.count_copy(len(chunk))  # copy-in: source lacks readinto
        self._end += len(chunk)


# --------------------------------------------------------------------------
# Member decode arenas + pipelined readahead decoders
# --------------------------------------------------------------------------

class MemberArena:
    """Pooled decode-target slots for member-oriented zero-copy parsing.

    The member-stream twin of :class:`RecordBuffer`'s arena pool:
    decode targets are reusable ``bytearray`` slots filled through the
    ``next_member_into`` append API; records borrow ``memoryview``
    slices of a slot, so a released slot is recycled **only when nothing
    references it anymore** (refcount check, exactly the
    :class:`RecordBuffer` contract) — held records cost fresh slots,
    never corruption. A recycled slot keeps no stale content
    (``clear()``) but its growth history keeps Python's allocator warm
    at the high-water member size. Thread-safe: the readahead decoder
    acquires from its thread while the parser releases from the
    consumer side.
    """

    __slots__ = ("stats", "_pool", "_pool_max", "_lock")

    def __init__(self, *, stats: CopyStats | None = None,
                 pool_max: int = _ARENA_POOL_MAX) -> None:
        self.stats = stats if stats is not None else CopyStats()
        self._pool: list[bytearray] = []
        self._pool_max = pool_max
        self._lock = threading.Lock()

    def acquire(self) -> bytearray:
        """An empty slot: recycled if a pooled one is reference-free."""
        with self._lock:
            for i in range(len(self._pool)):
                cand = self._pool[i]
                # refs: pool list + `cand` local + getrefcount argument == 3;
                # any outstanding record view raises the count
                if sys.getrefcount(cand) <= 3:
                    self.stats.arena_reuses += 1
                    slot = self._pool.pop(i)
                    slot.clear()
                    return slot
        self.stats.allocs += 1  # byte volume grows with appends, not here
        return bytearray()

    def release(self, slot: bytearray) -> None:
        """Return a slot to the pool (parser done; borrowed views keep it
        alive until their records die)."""
        with self._lock:
            if len(self._pool) >= self._pool_max:
                self._pool.pop(0)  # dropped; freed once its views die
            self._pool.append(slot)


class ReadaheadDecoder:
    """Double-buffered member-decode stage: one decoder thread per stream.

    The thread pulls slots from a :class:`MemberArena`, packs
    consecutive decompressed members into each slot (amortizing queue
    hand-offs over up to ``max_members`` records), and posts
    ``(slot, [(start, nbytes, comp_offset), ...])`` batches into a
    bounded ring; the consumer parses records straight out of borrowed
    slot views while the thread inflates the next batch — file I/O and
    member decode overlap record parsing (zlib releases the GIL during
    inflate, so the overlap is real on ≥2 cores). Decode errors are
    posted in-band *after* the members decoded before them, so the
    consumer yields exactly the records the synchronous path would have
    yielded before re-raising. ``close()`` is idempotent: stops the
    thread, drains the ring (releasing slots), joins.
    """

    _IDLE = 0.05  # poll quantum for stop-responsive queue ops

    def __init__(self, decode_member, arena: MemberArena, *,
                 depth: int = 3, watermark: int = _ARENA_BYTES,
                 max_members: int = 128) -> None:
        # decode_member(slot) appends one member: -> (nbytes, comp_offset)
        # or None at EOF; called only from the decoder thread.
        self._decode = decode_member
        self._arena = arena
        self._watermark = watermark
        self._max_members = max_members
        self._ring: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run,
                                       name="warc-readahead", daemon=True)
        self.thread.start()

    # -- decoder thread --------------------------------------------------
    def _post(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._ring.put(item, timeout=self._IDLE)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        eof = False
        batch_cap = min(32, self._max_members)  # ramp-up (fill bubble)
        while not eof and not self._stop.is_set():
            slot = self._arena.acquire()
            members: list[tuple[int, int, int]] = []
            fill = 0
            error: BaseException | None = None
            while len(members) < batch_cap and \
                    fill < self._watermark:
                try:
                    res = self._decode(slot)
                except BaseException as exc:
                    error = exc
                    break
                if res is None:
                    eof = True
                    break
                nbytes, offset = res
                members.append((fill, nbytes, offset))
                fill += nbytes
            batch_cap = self._max_members
            if members:
                if not self._post(("batch", slot, members)):
                    return
            else:
                self._arena.release(slot)
            if error is not None:
                self._post(("raise", error))
                return
        if eof:
            self._post(("eof",))

    # -- consumer side ---------------------------------------------------
    def get(self):
        """Next ``("batch", slot, members)`` or ``None`` after EOF /
        close; re-raises errors the decoder thread hit, in stream
        order."""
        while True:
            try:
                item = self._ring.get(timeout=self._IDLE)
            except queue.Empty:
                if self._stop.is_set():
                    return None
                if not self.thread.is_alive() and self._ring.empty():
                    return None  # defensive: thread died without posting
                continue
            if item[0] == "batch":
                return item
            if item[0] == "raise":
                raise item[1]
            return None  # eof

    def release(self, slot: bytearray) -> None:
        """Hand a consumed batch's slot back for recycling."""
        self._arena.release(slot)

    def close(self) -> None:
        """Stop decoding, drain the ring (releasing slots), join the
        thread. Safe to call repeatedly and from ``finally`` blocks."""
        self._stop.set()
        while True:
            try:
                item = self._ring.get_nowait()
            except queue.Empty:
                break
            if item[0] == "batch":
                self._arena.release(item[1])
        self.thread.join(timeout=5.0)


# pipe protocol: [u8 kind][u32 len][payload]. Batch payload = slot/blob
# header + a packed member table. A raw pipe written from the child's
# *main* thread replaces mp.Queue: the queue's feeder thread would
# contend with the decode loop for the child's GIL (the same convoy the
# process exists to escape) and pickle every descriptor.
_RA_BATCH, _RA_BLOB, _RA_EOF, _RA_RAISE, _RA_LEDGER = 0, 1, 2, 3, 4
_RA_HDR = struct.Struct("<BI")
_RA_BATCH_HDR = struct.Struct("<IIQ")  # slot_idx, nbytes, next_offset
_RA_MEMBER = struct.Struct("<IIQ")     # start, nbytes, offset


def _ra_send(wfd: int, kind: int, payload: bytes) -> None:
    msg = _RA_HDR.pack(kind, len(payload)) + payload
    mv = memoryview(msg)
    while mv:
        written = os.write(wfd, mv)
        mv = mv[written:]


def _ra_send_ledger(wfd: int, offset: int, error_class: str,
                    bytes_skipped: int, message: str) -> None:
    _ra_send(wfd, _RA_LEDGER,
             pickle.dumps((offset, error_class, bytes_skipped, message)))


def _maybe_member_fault(count: int) -> None:
    """Deterministic decoder-child fault hook (chaos tests only).

    ``REPRO_TORCH_FAULT_DECODER_STALL=<latch-path>:<member-N>:<seconds>``
    stalls the decode loop at member ``count == N`` — exactly once
    globally, via an ``O_EXCL`` latch file, so the respawned child sails
    past the same member. Environment-variable plumbing survives both
    fork and spawn; a no-op unless the variable is set.
    """
    spec = os.environ.get(FAULT_DECODER_STALL_ENV)
    if not spec:
        return
    try:
        latch, n_s, secs_s = spec.rsplit(":", 2)
        n, secs = int(n_s), float(secs_s)
    except ValueError:
        return
    if count != n:
        return
    try:
        fd = os.open(latch, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return
    os.close(fd)
    time.sleep(secs)


class _MvSink:
    """Member-decode sink writing straight into a shared-memory slot.

    Output chunks land at ``pos`` in the slot's memoryview; once a chunk
    would cross ``limit`` (a member bigger than the slot), the remainder
    spills into a bytearray so the caller can reassemble the oversized
    member for the pipe-blob fallback.
    """

    __slots__ = ("mv", "pos", "limit", "spill")

    def __init__(self, mv, pos: int, limit: int) -> None:
        self.mv = mv
        self.pos = pos
        self.limit = limit
        self.spill: bytearray | None = None

    def append(self, chunk) -> None:
        if self.spill is not None:
            self.spill += chunk
            return
        end = self.pos + len(chunk)
        if end > self.limit:
            self.spill = bytearray(chunk)
            return
        self.mv[self.pos:end] = chunk
        self.pos = end


class _ChildObs:
    """Decoder-child counter surface: a plain dict published through a
    seqlock stats slot after every batch (and at EOF/error), so the
    parent can harvest the child's cumulative ``decoder.*`` counters even
    if the child is later SIGKILLed. ``writer=None`` (no stats slot, e.g.
    an old-style spawn) degrades to counting without publishing."""

    __slots__ = ("counters", "_writer")

    def __init__(self, writer: StatsSlotWriter | None) -> None:
        self.counters = {
            "decoder.members": 0, "decoder.batches": 0,
            "decoder.bytes": 0, "decoder.giant_blobs": 0,
            "decoder.ledger_entries": 0,
        }
        self._writer = writer

    def bump(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def publish(self) -> None:
        if self._writer is not None:
            self._writer.publish(ObsSnapshot(
                counters=dict(self.counters),
                sources=("readahead-decoder",)))


def _member_decode_child(src, shm_name: str, slot_bytes: int, slots: int,
                         sem, rfd: int, wfd: int, watermark: int,
                         max_members: int, start_offset: int = 0,
                         tolerant: bool = False,
                         stats_off: int = 0) -> None:
    """Child-process main of :class:`ProcessReadaheadDecoder`.

    Opens its own view of the source (a path, or forked bytes), inflates
    members back-to-back into local batches, memcpys each batch into its
    shared-memory ring slot and writes a tiny packed descriptor to the
    pipe — all from one thread. Runs only stdlib zlib + the from-scratch
    LZ4 — never touches torch or CUDA, so it is safe under the fork
    start method beside the parent's CUDA context
    (all imports it needs are at module top, so it cannot trip over a
    fork-held import lock). Errors are shipped in-band *after* the
    members decoded before them (the parent then re-raises in stream
    order, matching the synchronous path).
    """
    os.close(rfd)  # parent's read end: child must not hold it open
    try:
        raw = open(src, "rb") if isinstance(src, str) else io.BytesIO(src)
        stream, _kind = open_member_stream_at(raw, start_offset)
        if stream is None:
            _ra_send(wfd, _RA_EOF, b"")
            return
        # parent owns the segment's lifetime: attach without registering
        # (see repro_torch.core.parallel._ShmSlotWriter for the rationale)
        from multiprocessing import resource_tracker

        orig_register = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            shm = _shm_mod.SharedMemory(name=shm_name)
        finally:
            resource_tracker.register = orig_register
        sbuf = shm.buf[stats_off:stats_off + STATS_SLOT_BYTES] \
            if stats_off else None
        cobs = _ChildObs(StatsSlotWriter(sbuf) if sbuf is not None else None)
        try:
            if isinstance(stream, GZipStream):
                _gzip_decode_into_ring(stream, shm, slot_bytes, slots, sem,
                                       wfd, watermark, max_members, tolerant,
                                       cobs)
            else:
                _member_decode_into_ring(stream, shm, slot_bytes, slots,
                                         sem, wfd, watermark, max_members,
                                         tolerant, cobs)
        finally:
            # memoryview exports must be gone before shm.close()
            if cobs._writer is not None:
                cobs._writer.close()
            if sbuf is not None:
                sbuf.release()
            shm.close()
    except BaseException as exc:  # attach/open failures etc.
        try:
            _ra_send(wfd, _RA_RAISE, pickle.dumps(RuntimeError(repr(exc))))
        except Exception:  # pragma: no cover - pipe already torn down
            pass


def _ra_send_error(wfd: int, error: BaseException) -> None:
    try:
        blob = pickle.dumps(error)
    except Exception:
        blob = pickle.dumps(RuntimeError(repr(error)))
    _ra_send(wfd, _RA_RAISE, blob)


def _member_decode_into_ring(stream, shm, slot_bytes: int, slots: int,
                             sem, wfd: int, watermark: int,
                             max_members: int, tolerant: bool = False,
                             cobs: "_ChildObs | None" = None) -> None:
    """Generic child decode loop: members append to a local bytearray
    batch, then one memcpy into the ring slot (LZ4's decode-into API is
    append-based). gzip uses :func:`_gzip_decode_into_ring` instead,
    which skips the local buffer entirely. With ``tolerant``, damaged
    members resync instead of erroring, shipping a ledger message."""
    from .errors import classify_member_error

    if cobs is None:
        cobs = _ChildObs(None)
    slot_idx = 0
    local = bytearray()
    eof = False
    decoded = 0
    # ramp-up: a small first batch shortens the pipeline-fill bubble
    # (the parent would otherwise idle a full batch time)
    batch_cap = min(32, max_members)
    while not eof:
        local.clear()
        members: list[tuple[int, int, int]] = []
        error: BaseException | None = None
        while len(members) < batch_cap and len(local) < watermark:
            offset = stream.tell_compressed()
            base = len(local)
            try:
                n = stream.next_member_into(local)
            except Exception as exc:
                if tolerant:
                    del local[base:]  # roll the partial decode off
                    skipped = stream.resync(offset)
                    if skipped is None:
                        _ra_send_ledger(
                            wfd, offset, "truncated_tail",
                            stream.tell_compressed() - offset, repr(exc))
                        cobs.bump("decoder.ledger_entries")
                        eof = True
                        break
                    _ra_send_ledger(wfd, offset, classify_member_error(exc),
                                    skipped, repr(exc))
                    cobs.bump("decoder.ledger_entries")
                    continue
                error = exc
                break
            except BaseException as exc:
                error = exc
                break
            if n is None:
                eof = True
                break
            members.append((len(local) - n, n, offset))
            decoded += 1
            _maybe_member_fault(decoded)
        batch_cap = max_members
        if members:
            nbytes = len(local)
            next_off = stream.tell_compressed()
            table = b"".join(_RA_MEMBER.pack(*m) for m in members)
            if nbytes <= slot_bytes:
                sem.acquire()  # FIFO drain: target slot is free
                base = slot_idx * slot_bytes
                shm.buf[base:base + nbytes] = local
                _ra_send(wfd, _RA_BATCH,
                         _RA_BATCH_HDR.pack(slot_idx, nbytes, next_off)
                         + table)
                slot_idx = (slot_idx + 1) % slots
            else:  # oversized batch (huge member): pipe fallback
                _ra_send(wfd, _RA_BLOB,
                         _RA_BATCH_HDR.pack(0, nbytes, next_off)
                         + table + local)
                cobs.bump("decoder.giant_blobs")
            cobs.bump("decoder.members", len(members))
            cobs.bump("decoder.batches")
            cobs.bump("decoder.bytes", nbytes)
            cobs.publish()
        if error is not None:
            _ra_send_error(wfd, error)
            cobs.publish()
            return
    _ra_send(wfd, _RA_EOF, b"")
    cobs.publish()


def _gzip_decode_into_ring(stream: "GZipStream", shm, slot_bytes: int,
                           slots: int, sem, wfd: int, watermark: int,
                           max_members: int, tolerant: bool = False,
                           cobs: "_ChildObs | None" = None) -> None:
    """gzip child decode loop: members inflate **directly into the ring
    slot** through a :class:`_MvSink` — no local batch buffer, no batch
    memcpy, each output byte written once. A member that outgrows its
    slot spills and travels as a pipe blob instead. With ``tolerant``,
    damaged members are rolled back off the slot, the stream resyncs to
    the next member magic, and a ledger message ships in-band."""
    from .errors import classify_member_error

    if cobs is None:
        cobs = _ChildObs(None)
    slot_idx = 0
    eof = False
    decoded = 0
    batch_cap = min(32, max_members)  # ramp-up (fill bubble)
    buf = shm.buf
    while not eof:
        sem.acquire()  # slot needed up front: decode writes straight in
        base = slot_idx * slot_bytes
        sink = _MvSink(buf, base, base + slot_bytes)
        members: list[tuple[int, int, int]] = []
        error: BaseException | None = None
        giant: tuple[bytes, int] | None = None
        while len(members) < batch_cap and sink.pos - base < watermark:
            offset = stream._abs + stream._off  # inlined tell_compressed
            member_start = sink.pos
            try:
                if stream._skip_member_header() is None:
                    eof = True
                    break
                stream._decode_member_body(sink.append)
            except Exception as exc:
                if tolerant:
                    sink.pos = member_start  # roll the partial back off
                    sink.spill = None
                    skipped = stream.resync(offset)
                    if skipped is None:
                        _ra_send_ledger(
                            wfd, offset, "truncated_tail",
                            stream.tell_compressed() - offset, repr(exc))
                        cobs.bump("decoder.ledger_entries")
                        eof = True
                        break
                    _ra_send_ledger(wfd, offset, classify_member_error(exc),
                                    skipped, repr(exc))
                    cobs.bump("decoder.ledger_entries")
                    continue
                error = exc
                break
            except BaseException as exc:
                error = exc
                break
            if sink.spill is not None:  # member outgrew the slot
                giant = (bytes(buf[member_start:sink.pos])
                         + bytes(sink.spill), offset)
                sink.spill = None
                sink.pos = member_start  # roll it back off the slot
                break
            members.append((member_start - base,
                            sink.pos - member_start, offset))
            decoded += 1
            _maybe_member_fault(decoded)
        batch_cap = max_members
        next_off = stream._abs + stream._off
        if members:
            # resume cursor of the *batch* message stops short of a giant
            # member sent separately below — a death between the two must
            # re-drive the giant, not skip it
            batch_next = giant[1] if giant is not None else next_off
            table = b"".join(_RA_MEMBER.pack(*m) for m in members)
            _ra_send(wfd, _RA_BATCH,
                     _RA_BATCH_HDR.pack(slot_idx, sink.pos - base,
                                        batch_next) + table)
            slot_idx = (slot_idx + 1) % slots
            cobs.bump("decoder.members", len(members))
            cobs.bump("decoder.batches")
            cobs.bump("decoder.bytes", sink.pos - base)
            cobs.publish()
        else:
            sem.release()  # nothing landed: hand the slot straight back
        if giant is not None:
            data, offset = giant
            _ra_send(wfd, _RA_BLOB,
                     _RA_BATCH_HDR.pack(0, len(data), next_off)
                     + _RA_MEMBER.pack(0, len(data), offset) + data)
            cobs.bump("decoder.members")
            cobs.bump("decoder.giant_blobs")
            cobs.bump("decoder.bytes", len(data))
            cobs.publish()
        if error is not None:
            _ra_send_error(wfd, error)
            cobs.publish()
            return
    _ra_send(wfd, _RA_EOF, b"")
    cobs.publish()


class ProcessReadaheadDecoder:
    """True-parallel readahead: member decode in a child process, batches
    handed over through a shared-memory slot ring.

    Why a process: the thread decoder cannot overlap a CPU-bound parse
    loop under CPython's GIL — after every ~10 µs GIL-released inflate
    the decoder waits up to the 5 ms switch interval for a hot consumer
    to yield (measured ~10 ms reacquire latency on a contended 2-core
    host), which degenerates any two-thread CPU
    pipeline to serial. A child process decodes on its own core.

    The parent lands each ring batch in a :class:`MemberArena` slot with
    one memcpy — decompressor-output transport, tallied as
    ``decode_into_arena`` exactly like the thread path's chunk appends,
    never as parse-path copies — and releases the ring slot immediately,
    so slot lifetime never crosses the process boundary and borrowed
    record views keep the plain arena refcount contract.

    Consumer API is identical to :class:`ReadaheadDecoder`:
    ``get()`` → ``("batch", slot, members)`` / ``None``, ``release()``,
    ``close()``. Construction raises where shared memory or a safe fork
    context is unavailable — callers fall back to the thread decoder.
    """

    _IDLE = 0.05
    _BACKOFF = 0.05  # first respawn delay; doubles per attempt, capped
    _BACKOFF_CAP = 1.0

    def __init__(self, src, arena: MemberArena, *, depth: int = 3,
                 watermark: int = _ARENA_BYTES,
                 max_members: int = 128, tolerant: bool = False,
                 on_ledger=None, max_respawns: int = 2,
                 stall_timeout_s: float | None = None) -> None:
        import multiprocessing as mp

        # pre-import in the parent so the forked child's function-level
        # import is a sys.modules hit, never a fork-held import lock
        from multiprocessing import resource_tracker  # noqa: F401

        if _shm_mod is None:  # pragma: no cover - py>=3.8 everywhere
            raise RuntimeError("shared_memory unavailable")
        if mp.current_process().daemon:
            # daemonic processes (e.g. ParallelWarcPool workers) may not
            # have children — those parses use the thread decoder, which
            # is the right shape anyway: the shards are already fanned
            # out one per core, there is no spare core to decode on
            raise RuntimeError("daemonic parent cannot fork a decoder")
        if "fork" not in mp.get_all_start_methods():
            # spawn/forkserver pay ~100 ms interpreter startup per stream;
            # the thread decoder is the right fallback there. Unlike pool
            # workers (repro_torch.core.parallel forbids fork once CUDA is
            # up because workers run arbitrary code), this child executes
            # only the pre-imported stdlib zlib / pure-Python LZ4 paths
            # below — it never calls into torch or CUDA, so fork stays
            # safe with a live CUDA context in the parent.
            raise RuntimeError("no fork start method on this platform")
        self._ctx = mp.get_context("fork")
        self._src = src
        self._arena = arena
        self._slot_bytes = max(2 * watermark, 1 << 16)
        self._slots = depth
        self._watermark = watermark
        self._max_members = max_members
        self._tolerant = tolerant
        self._on_ledger = on_ledger
        self._max_respawns = max_respawns
        if stall_timeout_s is None:
            env = os.environ.get(DECODER_STALL_S_ENV)
            stall_timeout_s = float(env) if env else None
        self._stall_timeout_s = stall_timeout_s
        self._resume = 0        # compressed offset the next child starts at
        self._respawns = 0
        self._closed = False
        self._shm = None
        self._rfd = None
        self._spawn()

    def _spawn(self) -> None:
        """Create segment + semaphore + pipe and start a decode child.

        Called at construction and again by :meth:`_recover` after a
        child death/stall — every spawn gets a *fresh* ring (segment and
        semaphore), so permits a dead child took to its grave can never
        shrink the replacement's ring.
        """
        from .. import reaper as _reaper

        # ring slots plus one trailing seqlock stats slot the child
        # publishes its cumulative decoder.* counters into (harvested by
        # the parent at teardown — survives a SIGKILLed child)
        stats_off = self._slot_bytes * self._slots
        self._shm = _reaper.create_segment(stats_off + STATS_SLOT_BYTES)
        self._rfd = wfd = None
        try:
            self._sem = self._ctx.Semaphore(self._slots)
            self._rfd, wfd = os.pipe()
            self.process = self._ctx.Process(
                target=_member_decode_child,
                args=(self._src, self._shm.name, self._slot_bytes,
                      self._slots, self._sem, self._rfd, wfd,
                      self._watermark, self._max_members, self._resume,
                      self._tolerant, stats_off),
                name="warc-readahead-decoder", daemon=True)
            import warnings

            with warnings.catch_warnings():
                # Python warns on any fork from a multi-threaded process
                # (torch and CUDA start threads); this child runs only
                # pre-imported stdlib / LZ4 code and takes no lock a
                # parent thread may hold (see class doc), so the blanket
                # warning is suppressed narrowly
                warnings.filterwarnings(
                    "ignore", message=r"This process .* is multi-threaded",
                    category=DeprecationWarning)
                self.process.start()
        except BaseException:
            # partial construction (sem ENOSPC, pipe EMFILE, fork EAGAIN)
            # must not leak the segment/fds: callers fall back to the
            # thread decoder per shard, and silent leaks would fill
            # /dev/shm under exactly the pressure that triggers them
            for fd in (self._rfd, wfd):
                if fd is not None:
                    try:
                        os.close(fd)
                    except OSError:  # pragma: no cover - teardown race
                        pass
            self._rfd = None
            self._unlink_segment()
            raise
        os.close(wfd)  # child holds the only write end: EOF == child gone

    def _unlink_segment(self) -> None:
        from .. import reaper as _reaper

        if self._shm is None:
            return
        try:
            self._shm.close()
            self._shm.unlink()
        except (OSError, FileNotFoundError):  # pragma: no cover - race
            pass
        _reaper.unregister(self._shm)
        self._shm = None

    def _harvest_stats(self) -> None:
        """Absorb the child's last published ``decoder.*`` counters into
        the process-default registry. Best effort: a child killed between
        publishes loses only its in-flight batch's counts; a respawned
        child re-decoding from the resume cursor may re-count members the
        dead child decoded but never shipped."""
        if self._shm is None:
            return
        stats_off = self._slot_bytes * self._slots
        view = self._shm.buf[stats_off:stats_off + STATS_SLOT_BYTES]
        reader = StatsSlotReader(view)
        snap = reader.read()
        reader.close()
        view.release()  # export must be gone before close/unlink
        if snap is not None:
            from repro_torch import obs

            obs.registry().absorb(snap)

    def _teardown_child(self) -> None:
        if self.process.is_alive():
            self.process.terminate()
        self.process.join(timeout=5.0)
        if self._rfd is not None:
            try:
                os.close(self._rfd)
            except OSError:  # pragma: no cover - teardown race
                pass
            self._rfd = None
        self._harvest_stats()
        self._unlink_segment()

    def _recover(self, reason: str) -> None:
        """Reap a dead/stalled child and respawn from the resume cursor.

        Every batch the parent has fully received is final (its bytes
        were copied into the arena at ``get()`` time), so the
        replacement child restarts decoding at ``self._resume`` — the
        compressed offset just past the last received batch — and the
        member stream continues deterministically. Capped exponential
        backoff; budget exhaustion re-raises the underlying failure.
        """
        if self._respawns >= self._max_respawns:
            raise RuntimeError(
                f"readahead decoder process {reason}; respawn budget "
                f"({self._max_respawns}) exhausted")
        self._respawns += 1
        from repro_torch import obs

        obs.registry().counter_add("decoder.respawns")
        delay = min(self._BACKOFF * (2 ** (self._respawns - 1)),
                    self._BACKOFF_CAP)
        self._teardown_child()
        time.sleep(delay)
        self._spawn()

    # -- consumer side ---------------------------------------------------
    def _read_exact(self, n: int) -> bytes | None:
        """Read exactly ``n`` pipe bytes; ``None`` on EOF (child gone)."""
        parts = []
        need = n
        while need:
            chunk = os.read(self._rfd, need)
            if not chunk:
                return None
            parts.append(chunk)
            need -= len(chunk)
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def get(self):
        """Next ``("batch", slot, members)`` with ``slot`` already landed
        in the parent arena, or ``None`` after EOF / close; re-raises
        child decode errors in stream order. A child that dies or stalls
        mid-stream is reaped and respawned from the resume cursor
        (capped backoff) instead of failing the whole shard."""
        waited = 0.0
        while True:
            ready, _, _ = select.select([self._rfd], [], [], self._IDLE)
            if not ready:
                if self._closed:
                    return None
                waited += self._IDLE
                if (self._stall_timeout_s is not None
                        and waited >= self._stall_timeout_s):
                    self._recover(
                        f"stalled (> {self._stall_timeout_s:.1f}s silent)")
                    waited = 0.0
                continue
            waited = 0.0
            hdr = self._read_exact(_RA_HDR.size)
            if hdr is None:
                if self._closed:
                    return None
                self._recover(f"died (exit {self.process.exitcode})")
                continue
            kind, plen = _RA_HDR.unpack(hdr)
            payload = self._read_exact(plen) if plen else b""
            if payload is None:
                if self._closed:
                    return None
                self._recover("died mid-message (pipe truncated)")
                continue
            if kind == _RA_EOF:
                return None
            if kind == _RA_RAISE:
                raise pickle.loads(payload)
            if kind == _RA_LEDGER:
                if self._on_ledger is not None:
                    self._on_ledger(*pickle.loads(payload))
                continue
            slot_idx, nbytes, next_off = _RA_BATCH_HDR.unpack_from(payload)
            table_end = len(payload) if kind == _RA_BATCH else \
                len(payload) - nbytes
            members = list(_RA_MEMBER.iter_unpack(
                payload[_RA_BATCH_HDR.size:table_end]))
            slot = self._arena.acquire()
            if kind == _RA_BATCH:
                base = slot_idx * self._slot_bytes
                slot += self._shm.buf[base:base + nbytes]
                self._sem.release()  # ring slot free before parsing starts
            else:  # _RA_BLOB: oversized batch travelled in the pipe
                slot += memoryview(payload)[table_end:]
            # the batch is now owned by the parent: a replacement child
            # may resume just past it without losing or repeating data
            self._resume = next_off
            self._arena.stats.count_decode_into(nbytes)
            return ("batch", slot, members)

    def release(self, slot: bytearray) -> None:
        self._arena.release(slot)

    def close(self) -> None:
        """Terminate the child, close the pipe, release the segment.
        Safe to call repeatedly and from ``finally`` blocks."""
        if self._closed:
            return
        self._closed = True
        self._teardown_child()


def iter_members(path_or_buf, kind: str | None = None) -> Iterator[bytes]:
    """Convenience: yield decompressed members of a WARC file."""
    raw = open(path_or_buf, "rb") if isinstance(path_or_buf, str) else io.BytesIO(path_or_buf)
    try:
        stream, detected = open_member_stream(raw)
        if stream is None:
            data = ZstdStream(raw).read() if detected == "zstd" else raw.read()
            if data:
                yield data
            return
        while True:
            member = stream.next_member()
            if member is None:
                return
            yield member
    finally:
        if isinstance(path_or_buf, str):
            raw.close()
