"""Stream layer: gzip member decode, pooled parse arenas, readahead.

* :class:`GZipStream` — FastWARC-style: inflates whole gzip members in
  C calls and exposes *member boundaries* (one member per record).
  ``next_member_into(slot)`` appends a member's decompressed bytes to a
  pooled :class:`MemberArena` ``bytearray`` slot instead of
  materializing per-record ``bytes``.
* :class:`RecordBuffer` — the zero-copy parse surface of uncompressed
  WARCs: a reusable arena filled with ``readinto``.
* :class:`ReadaheadDecoder` — runs member decode on its own thread,
  packing members into slots and posting them through a bounded ring so
  member inflate overlaps record parsing.

Only gzip and uncompressed WARCs are covered; LZ4 and zstd shards are
detected and refused by the iterator.
"""
from __future__ import annotations

import queue
import sys
import threading
import zlib
from typing import BinaryIO

__all__ = ["CopyStats", "GZipStream", "MemberArena", "ReadaheadDecoder",
           "RecordBuffer", "detect_compression"]

GZIP_MAGIC = b"\x1f\x8b"
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
LZ4_MAGIC_BYTES = b"\x04\x22\x4d\x18"

_READ_BLOCK = 1 << 20       # FastWARC-style bulk read
_DECODE_CHUNK = 256 * 1024  # max zlib output temporary on the into-path


def detect_compression(head: bytes) -> str:
    if head.startswith(GZIP_MAGIC):
        return "gzip"
    if head.startswith(LZ4_MAGIC_BYTES):
        return "lz4"
    if head.startswith(ZSTD_MAGIC):
        return "zstd"
    return "none"


class GZipStream:
    """Concatenated-gzip-member reader with C-call member decode.

    Feeds the decompressor bounded ``memoryview`` slices so the
    ``unused_data`` tail copy stays O(feed) per member instead of
    O(remaining buffer). Member headers are parsed by hand and the
    deflate stream inflated raw (``wbits=-15``); the per-member CRC32 is
    not verified (record digests carry end-to-end integrity).
    """

    # first feed per member: covers most compressed record members in
    # one C call while keeping the unused_data tail copy small
    _FEED = 8 * 1024

    def __init__(self, raw: BinaryIO) -> None:
        self._raw = raw
        self._buf = b""
        self._off = 0
        self._abs = 0  # compressed offset of _buf[0]

    def _fill(self) -> bool:
        chunk = self._raw.read(_READ_BLOCK)
        if not chunk:
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

        ``None`` at clean EOF; raises ``zlib.error`` on malformed or
        truncated headers. Handles the full RFC 1952 layout: FEXTRA,
        FNAME, FCOMMENT, FHCRC.
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

        ``sink_append`` receives ``_DECODE_CHUNK``-bounded output chunks.
        Returns the decompressed byte count.
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

    def next_member_into(self, out: bytearray,
                         stats: "CopyStats | None" = None) -> int | None:
        """Decode the next gzip member by appending it to ``out``; returns
        the byte count, or ``None`` at EOF. Appended bytes are tallied in
        ``stats.decode_into_arena``."""
        if self._skip_member_header() is None:
            return None
        written = self._decode_member_body(out.extend)
        if stats is not None:
            stats.count_decode_into(written)
        return written

    def tell_compressed(self) -> int:
        return self._abs + self._off


class CopyStats:
    """Byte-copy / allocation ledger for the ingest hot path.

    Every Python-level copy of payload bytes (arena rolls, header-block
    slices, ``detach()``/``content`` materialization) and every arena
    allocation is counted here. Decompressor output appended straight
    onto a pooled slot is tallied separately in ``decode_into_arena``.
    """

    __slots__ = ("copies", "bytes_copied", "allocs", "bytes_allocated",
                 "arena_reuses", "decode_into_arena")

    def __init__(self) -> None:
        self.copies = 0
        self.bytes_copied = 0
        self.allocs = 0
        self.bytes_allocated = 0
        self.arena_reuses = 0
        self.decode_into_arena = 0

    def count_copy(self, nbytes: int) -> None:
        self.copies += 1
        self.bytes_copied += nbytes

    def count_alloc(self, nbytes: int) -> None:
        self.allocs += 1
        self.bytes_allocated += nbytes

    def count_decode_into(self, nbytes: int) -> None:
        """Member bytes decoded directly into a pooled arena slot."""
        self.decode_into_arena += nbytes

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


_ARENA_BYTES = 1 << 20   # default arena size; grows geometrically per record
_ARENA_POOL_MAX = 4      # retired arenas kept for recycling


class RecordBuffer:
    """Pooled-arena buffered reader: the zero-copy parse surface.

    The parser addresses the stream by **absolute offset**; this class
    maps those offsets onto a reusable ``bytearray`` arena filled with
    ``readinto``. Record content is handed out as :meth:`view`
    ``memoryview`` slices — no per-record ``bytes`` slicing.

    Lifetime contract: a view pins its arena. Retired arenas go to a
    small pool and are recycled **only when no outstanding view
    references them** (checked via the arena's refcount), so borrowed
    views are never silently clobbered.
    """

    def __init__(self, raw, *, stats: CopyStats) -> None:
        self._raw = raw
        self._readinto = getattr(raw, "readinto", None)
        self.stats = stats
        self._buf = bytearray(_ARENA_BYTES)
        self.stats.count_alloc(_ARENA_BYTES)
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
        """Line-anchored ``Name:``-field scan inside ``[a, b)``, in-arena."""
        from .record import scan_header_field_in

        return scan_header_field_in(self._buf, needle,
                                    a - self._base, b - self._base)

    # -- internals -------------------------------------------------------
    def _take_arena(self, capacity: int) -> bytearray:
        """Recycle a retired arena iff nothing references it anymore."""
        for i in range(len(self._pool)):
            cand = self._pool[i]
            # refs: pool list + `cand` local + getrefcount argument == 3;
            # any outstanding memoryview/ndarray raises the count
            if len(cand) >= capacity and sys.getrefcount(cand) <= 3:
                self.stats.arena_reuses += 1
                return self._pool.pop(i)
        cap = _ARENA_BYTES
        while cap < capacity:
            cap *= 2
        self.stats.count_alloc(cap)
        return bytearray(cap)

    def _roll(self, pos: int, need: int) -> None:
        """Move the live tail onto a fresh/recycled arena.

        The only copy on the parse path: the bytes of the record
        straddling the arena edge. Growth is geometric — at most a
        doubling per roll, never ``need`` upfront, so a corrupt
        ``Content-Length`` cannot allocate what the stream has not backed
        with bytes.
        """
        live_start = min(self._start, pos - self._base)
        live = self._end - live_start
        cap_limit = max(2 * len(self._buf), _ARENA_BYTES)
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


class MemberArena:
    """Pooled decode-target slots for member-oriented zero-copy parsing.

    Decode targets are reusable ``bytearray`` slots filled through the
    ``next_member_into`` append API; records borrow ``memoryview``
    slices of a slot, so a released slot is recycled **only when nothing
    references it anymore** (refcount check, the :class:`RecordBuffer`
    contract). Thread-safe: the readahead decoder acquires from its
    thread while the parser releases from the consumer side.
    """

    __slots__ = ("stats", "_pool", "_lock")

    def __init__(self, *, stats: CopyStats) -> None:
        self.stats = stats
        self._pool: list[bytearray] = []
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
        """Return a slot to the pool (borrowed views keep it alive until
        their records die)."""
        with self._lock:
            if len(self._pool) >= _ARENA_POOL_MAX:
                self._pool.pop(0)  # dropped; freed once its views die
            self._pool.append(slot)


class ReadaheadDecoder:
    """Double-buffered member-decode stage: one decoder thread per stream.

    The thread pulls slots from a :class:`MemberArena`, packs consecutive
    decompressed members into each slot (up to ``_MAX_MEMBERS`` records
    or ``_ARENA_BYTES`` bytes), and posts ``(slot, [(start, nbytes,
    comp_offset), ...])`` batches into a bounded ring; the consumer
    parses records straight out of borrowed slot views while the thread
    inflates the next batch (zlib releases the GIL during inflate).
    Decode errors are posted in-band *after* the members decoded before
    them, so the consumer yields exactly the records the synchronous path
    would have yielded before re-raising. ``close()`` is idempotent:
    stops the thread, drains the ring (releasing slots), joins.

    The stage is a thread, not a forked process: the process that parses
    may hold a live CUDA context, and a thread shares it safely.
    """

    _IDLE = 0.05      # poll quantum for stop-responsive queue ops
    _DEPTH = 3        # slot batches the decoder may run ahead (ring bound)
    _MAX_MEMBERS = 128

    def __init__(self, decode_member, arena: MemberArena) -> None:
        # decode_member(slot) appends one member: -> (nbytes, comp_offset)
        # or None at EOF; called only from the decoder thread.
        self._decode = decode_member
        self._arena = arena
        self._ring: queue.Queue = queue.Queue(maxsize=self._DEPTH)
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
        batch_cap = min(32, self._MAX_MEMBERS)  # ramp-up (fill bubble)
        while not eof and not self._stop.is_set():
            slot = self._arena.acquire()
            members: list[tuple[int, int, int]] = []
            fill = 0
            error: BaseException | None = None
            while len(members) < batch_cap and fill < _ARENA_BYTES:
                try:
                    res = self._decode(slot)
                except BaseException as exc:  # re-raised by the consumer
                    error = exc
                    break
                if res is None:
                    eof = True
                    break
                nbytes, offset = res
                members.append((fill, nbytes, offset))
                fill += nbytes
            batch_cap = self._MAX_MEMBERS
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
        close; re-raises errors the decoder thread hit, in stream order."""
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
