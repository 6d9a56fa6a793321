"""CDX-style record index: build, merge, persist, random-access.

An archive (or a sharded corpus) is swept **once** with the parser and
every record's location and metadata are captured into a compact binary
*columnar* index:

    shard_id · offset · comp_len · uncomp_len · type · status ·
    uri · mime · adler32 digest · n-gram signature bitmap

Columns are numpy arrays (header predicates evaluate as vector compares
over the whole corpus, see :mod:`repro_torch.index.query`); URIs/MIMEs
live in shared byte heaps addressed by offset columns, and the
per-record Bloom-style signature (:mod:`repro_torch.index.signature`)
lets pattern queries skip decompression of records that cannot match.

The build computes digest and signature of each batch of record payloads
in one fused kernel sweep on the device
(:func:`repro_torch.kernels.digest_sig.digest_signature_batch`), or on
the host (``zlib.adler32`` and :func:`~repro_torch.index.signature.
signature_of`); ``build_index(workers=N)`` sweeps the shards in a
process pool (:func:`repro_torch.core.parallel.map_shards`).
:class:`RandomAccessReader` opens a shard at an indexed offset and
parses exactly one record; :func:`verify_index` re-reads every indexed
record and checks its stored digest (and optionally its signature) in
batched kernel launches. ``offset`` is the absolute position in the
*addressable* stream: the compressed file for gzip/LZ4 members, the raw
file for uncompressed WARCs, and the decompressed stream for zstd. zstd
rows additionally store the compressed offset of the frame containing
the record and that frame's decompressed base (walked without
decompression at build time, :mod:`repro_torch.core.warc.zstd_frames`),
so random access seeks to the containing frame and decompresses only
from there; for member formats the two frame columns are an identity
copy of ``offset``. The ``.cdx`` byte format is the reference package's
v2 format, byte for byte.
"""
from __future__ import annotations

import functools
import io
import os
import struct
import time
import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.warc.fastwarc import FastWARCIterator, read_record_at
from repro_torch.core.warc.record import (
    RECORD_TYPE_FROM_VALUE,
    UNKNOWN_TYPE_VALUE,
    WarcRecord,
    WarcRecordType,
)
from repro_torch.core.warc.streams import (ForwardWindow, ZstdStream,
                                           detect_compression)
from .signature import SIG_BITS, SIG_HASHES, SIG_NGRAM, signature_of

__all__ = ["CdxEntry", "CdxIndex", "NO_FRAME", "RandomAccessReader",
           "build_index", "verify_index"]

_MAGIC = b"REPROCDX"
_VERSION = 2  # v2 adds the zstd frame columns (frame_off / frame_base)
_KIND_CODES = {"none": 0, "gzip": 1, "lz4": 2, "zstd": 3}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}

# rows without a usable compressed-frame mapping (zstd rows of legacy v1
# indexes) carry this sentinel
NO_FRAME = np.uint64(0xFFFFFFFFFFFFFFFF)

# column name -> dtype of the fixed v2 column schema, in file order
# (uri_off / mime_off hold n + 1 entries, signatures (n, bits // 64))
_COLUMNS = (
    ("shard_id", np.uint32), ("offset", np.uint64), ("comp_len", np.uint64),
    ("uncomp_len", np.uint64), ("rtype", np.uint16), ("status", np.int16),
    ("digest", np.uint32), ("signatures", np.uint64),
    ("frame_off", np.uint64), ("frame_base", np.uint64),
    ("uri_off", np.uint64), ("mime_off", np.uint64),
)


@dataclass
class CdxEntry:
    """One materialized index row (columnar storage is the truth)."""

    shard: str
    kind: str
    offset: int
    comp_len: int
    uncomp_len: int
    record_type: WarcRecordType
    status: int            # HTTP status, -1 when not an HTTP record
    uri: bytes
    mime: bytes
    digest: int            # adler32 of the record content block


class CdxIndex:
    """Columnar CDX index over one or many WARC shards."""

    def __init__(self, shard_paths: list[str], shard_kinds: list[str],
                 columns: dict[str, np.ndarray],
                 uri_heap: bytes, mime_heap: bytes,
                 *, sig_bits: int = SIG_BITS, sig_ngram: int = SIG_NGRAM,
                 sig_hashes: int = SIG_HASHES) -> None:
        self.shard_paths = list(shard_paths)
        self.shard_kinds = list(shard_kinds)
        self.shard_id = columns["shard_id"]
        self.offset = columns["offset"]
        self.comp_len = columns["comp_len"]
        self.uncomp_len = columns["uncomp_len"]
        self.rtype = columns["rtype"]
        self.status = columns["status"]
        self.digest = columns["digest"]
        self.signatures = columns["signatures"]
        if "frame_off" in columns:
            self.frame_off = columns["frame_off"]
            self.frame_base = columns["frame_base"]
        else:  # v1 index: identity for member formats, NO_FRAME for zstd
            self.frame_off = self.offset.copy()
            self.frame_base = self.offset.copy()
            zstd_rows = np.asarray(
                [k == "zstd" for k in shard_kinds], bool)[self.shard_id]
            self.frame_off[zstd_rows] = NO_FRAME
            self.frame_base[zstd_rows] = NO_FRAME
        self.uri_off = columns["uri_off"]
        self.mime_off = columns["mime_off"]
        self.uri_heap = uri_heap
        self.mime_heap = mime_heap
        self.sig_bits = sig_bits
        self.sig_ngram = sig_ngram
        self.sig_hashes = sig_hashes
        # LedgerEntry rows of the build: a shard the supervised pool
        # quarantined. In-memory only — not persisted by save()/load()
        self.errors: list = []
        # build_index attaches the merged ObsSnapshot of its sweep
        # (parent + pool + workers). In-memory only, like errors
        self.obs = None
        self._uris: np.ndarray | None = None
        self._mimes: np.ndarray | None = None

    @classmethod
    def from_columns(cls, columns: dict[str, np.ndarray], uri_heap: bytes,
                     mime_heap: bytes, *, shard_paths: list[str],
                     shard_kinds: list[str], sig_bits: int,
                     sig_ngram: int, sig_hashes: int) -> "CdxIndex":
        """An index from another index's columns as numpy arrays (e.g. the
        reference package's ``CdxIndex`` attributes of the same names).

        Every v2 column must be present with its schema dtype and length;
        the arrays are copied, so the new index owns its storage.
        """
        n = len(columns["offset"])
        words = sig_bits // 64
        if sig_bits <= 0 or sig_bits % 64:
            raise ValueError(f"sig_bits must be a positive multiple of 64, "
                             f"got {sig_bits}")
        if len(shard_paths) != len(shard_kinds):
            raise ValueError("shard_paths and shard_kinds must pair up")
        own = {}
        for name, dtype in _COLUMNS:
            arr = np.asarray(columns[name])
            want = {"signatures": (n, words), "uri_off": (n + 1,),
                    "mime_off": (n + 1,)}.get(name, (n,))
            if arr.dtype != dtype or arr.shape != want:
                raise ValueError(f"column {name}: need {np.dtype(dtype)} "
                                 f"{want}, got {arr.dtype} {arr.shape}")
            own[name] = arr.copy()
        if n and int(own["shard_id"].max()) >= len(shard_paths):
            raise ValueError("shard_id out of range of shard_paths")
        if int(own["uri_off"][-1]) != len(uri_heap) or \
                int(own["mime_off"][-1]) != len(mime_heap):
            raise ValueError("heap offsets do not end at the heap sizes")
        return cls(shard_paths, shard_kinds, own, bytes(uri_heap),
                   bytes(mime_heap), sig_bits=sig_bits, sig_ngram=sig_ngram,
                   sig_hashes=sig_hashes)

    # -- access ----------------------------------------------------------
    def __len__(self) -> int:
        return int(self.offset.size)

    def uri(self, i: int) -> bytes:
        return self.uri_heap[self.uri_off[i]:self.uri_off[i + 1]]

    def mime(self, i: int) -> bytes:
        return self.mime_heap[self.mime_off[i]:self.mime_off[i + 1]]

    def uris(self) -> np.ndarray:
        """Fixed-width bytes array of URIs (built once; the URL-prefix
        predicate is a ``np.char`` vector compare)."""
        if self._uris is None:
            self._uris = np.array(
                [self.uri(i) for i in range(len(self))], dtype=np.bytes_)
        return self._uris

    def mimes(self) -> np.ndarray:
        """Fixed-width bytes array of MIME values (vector prefix filters)."""
        if self._mimes is None:
            self._mimes = np.array(
                [self.mime(i) for i in range(len(self))], dtype=np.bytes_)
        return self._mimes

    def frame_hint(self, i: int) -> tuple[int, int] | None:
        """``(frame_off, frame_base)`` for seek-to-frame reads of row ``i``,
        or ``None`` when no usable mapping is stored (legacy indexes)."""
        fo = int(self.frame_off[i])
        if np.uint64(fo) == NO_FRAME:
            return None
        return fo, int(self.frame_base[i])

    def entry(self, i: int) -> CdxEntry:
        i = int(i)
        sid = int(self.shard_id[i])
        return CdxEntry(
            shard=self.shard_paths[sid],
            kind=self.shard_kinds[sid],
            offset=int(self.offset[i]),
            comp_len=int(self.comp_len[i]),
            uncomp_len=int(self.uncomp_len[i]),
            record_type=RECORD_TYPE_FROM_VALUE.get(
                int(self.rtype[i]),
                RECORD_TYPE_FROM_VALUE[UNKNOWN_TYPE_VALUE]),
            status=int(self.status[i]),
            uri=self.uri(i),
            mime=self.mime(i),
            digest=int(self.digest[i]),
        )

    # -- persistence -----------------------------------------------------
    def save(self, path: str) -> int:
        """Write the binary columnar v2 layout; returns bytes written."""
        from repro_torch.columnar.codec import pack_arrays

        out = io.BytesIO()
        out.write(_MAGIC)
        out.write(struct.pack("<IIIIIQ", _VERSION, self.sig_bits,
                              self.sig_ngram, self.sig_hashes,
                              len(self.shard_paths), len(self)))
        for p, kind in zip(self.shard_paths, self.shard_kinds):
            raw = p.encode("utf-8")
            out.write(struct.pack("<IB", len(raw), _KIND_CODES[kind]))
            out.write(raw)
        pack_arrays(out, (getattr(self, name) for name, _ in _COLUMNS))
        out.write(struct.pack("<Q", len(self.uri_heap)))
        out.write(self.uri_heap)
        out.write(struct.pack("<Q", len(self.mime_heap)))
        out.write(self.mime_heap)
        blob = out.getvalue()
        with open(path, "wb") as f:
            f.write(blob)
        return len(blob)

    @classmethod
    def load(cls, path: str) -> "CdxIndex":
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:8] != _MAGIC:
            raise ValueError(f"{path}: not a CDX index (bad magic)")
        version, bits, ngram, hashes, n_shards, n = struct.unpack_from(
            "<IIIIIQ", blob, 8)
        if version not in (1, _VERSION):  # v1 readable: frame cols absent
            raise ValueError(f"{path}: unsupported CDX version {version}")
        # signature geometry is a per-index build parameter — validate it
        # before trusting it to slice the column region
        if bits == 0 or bits % 64:
            raise ValueError(
                f"{path}: invalid signature width {bits} (need a positive "
                f"multiple of 64)")
        if ngram == 0 or hashes == 0:
            raise ValueError(
                f"{path}: invalid signature parameters "
                f"(ngram={ngram}, hashes={hashes})")
        from repro_torch.columnar.codec import ArrayCursor

        pos = 8 + struct.calcsize("<IIIIIQ")
        shard_paths, shard_kinds = [], []
        for _ in range(n_shards):
            plen, kcode = struct.unpack_from("<IB", blob, pos)
            pos += struct.calcsize("<IB")
            shard_paths.append(blob[pos:pos + plen].decode("utf-8"))
            shard_kinds.append(_KIND_NAMES[kcode])
            pos += plen
        cur = ArrayCursor(blob, pos)
        words = bits // 64
        columns = {}
        for name, dtype in _COLUMNS:
            if version < 2 and name in ("frame_off", "frame_base"):
                continue  # v1: constructor synthesizes the frame columns
            if name == "signatures":
                columns[name] = cur.take(dtype, n * words, (n, words))
            elif name in ("uri_off", "mime_off"):
                columns[name] = cur.take(dtype, n + 1)
            else:
                columns[name] = cur.take(dtype, n)
        pos = cur.pos
        (uri_len,) = struct.unpack_from("<Q", blob, pos)
        pos += 8
        uri_heap = blob[pos:pos + uri_len]
        pos += uri_len
        (mime_len,) = struct.unpack_from("<Q", blob, pos)
        pos += 8
        mime_heap = blob[pos:pos + mime_len]
        return cls(shard_paths, shard_kinds, columns, uri_heap, mime_heap,
                   sig_bits=bits, sig_ngram=ngram, sig_hashes=hashes)

    # -- merge -----------------------------------------------------------
    @classmethod
    def merge(cls, partials: list["CdxIndex"]) -> "CdxIndex":
        """Concatenate per-shard partial indexes (deterministic: input
        order is preserved; shard ids and heap offsets are rebased)."""
        if not partials:
            raise ValueError("nothing to merge")
        ref = partials[0]
        for p in partials[1:]:
            if (p.sig_bits, p.sig_ngram, p.sig_hashes) != (
                    ref.sig_bits, ref.sig_ngram, ref.sig_hashes):
                raise ValueError("signature parameter mismatch across "
                                 "partials")
        plain = [name for name, _ in _COLUMNS
                 if name not in ("shard_id", "uri_off", "mime_off")]
        shard_paths: list[str] = []
        shard_kinds: list[str] = []
        cols: dict[str, list[np.ndarray]] = {k: [] for k in plain}
        cols["shard_id"] = []
        uri_offs = [np.zeros(1, np.uint64)]
        mime_offs = [np.zeros(1, np.uint64)]
        uri_base = mime_base = 0
        for p in partials:
            cols["shard_id"].append(p.shard_id + np.uint32(len(shard_paths)))
            shard_paths.extend(p.shard_paths)
            shard_kinds.extend(p.shard_kinds)
            for name in plain:
                cols[name].append(getattr(p, name))
            uri_offs.append(p.uri_off[1:] + np.uint64(uri_base))
            mime_offs.append(p.mime_off[1:] + np.uint64(mime_base))
            uri_base += len(p.uri_heap)
            mime_base += len(p.mime_heap)
        merged = {name: np.concatenate(parts) for name, parts in cols.items()}
        merged["uri_off"] = np.concatenate(uri_offs)
        merged["mime_off"] = np.concatenate(mime_offs)
        out = cls(shard_paths, shard_kinds, merged,
                  b"".join(p.uri_heap for p in partials),
                  b"".join(p.mime_heap for p in partials),
                  sig_bits=ref.sig_bits, sig_ngram=ref.sig_ngram,
                  sig_hashes=ref.sig_hashes)
        for p in partials:
            out.errors.extend(p.errors)
        return out


# --------------------------------------------------------------------------
# Builder
# --------------------------------------------------------------------------

def _record_span(record: WarcRecord) -> int:
    """Serialized record length in the decompressed stream (zstd tail)."""
    hdr = record._header_block  # raw block kept by the lazy-header parser
    hdr_len = len(hdr) if hdr else sum(
        len(n) + len(v) + 4 for n, v in record.headers.items_bytes()) + len(
            record.headers.status_line) + 2
    return hdr_len + 4 + record.content_length + 4


def _frame_columns(path: str, off: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Map each record's decompressed offset of a zstd shard onto the
    compressed frame containing it: ``(frame_off, frame_base)``, or
    ``NO_FRAME`` rows when the frames cannot be walked."""
    import mmap

    from repro_torch.core.warc.zstd_frames import frame_table

    try:
        with open(path, "rb") as f, \
                mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            # the walk touches a few bytes per block header; mmap keeps
            # it O(1) resident even for multi-GB shards
            comp_offs, bases = frame_table(mm)
        which = np.searchsorted(bases, off, side="right") - 1
        return comp_offs[which], bases[which]
    except (ValueError, RuntimeError):
        # unwalkable frames: the index stays usable, reads fall back to
        # the decompress-whole-shard path
        return (np.full(off.size, NO_FRAME, np.uint64),
                np.full(off.size, NO_FRAME, np.uint64))


_FUSED_BATCH = 512             # records per fused-kernel flush
_FUSED_BATCH_BYTES = 32 << 20  # …or payload bytes, whichever trips first:
                               # pending borrowed views pin their arenas and
                               # the kernel pads a matching batch matrix, so
                               # MB-scale records must flush early


def _fused_supported(sig_bits: int, sig_ngram: int) -> bool:
    """Geometry the fused kernel path covers (else: host signatures)."""
    from repro_torch.kernels.digest_sig.digest_sig import HPAD

    return (sig_bits & (sig_bits - 1) == 0
            and 2 <= sig_ngram <= HPAD + 1)


def _index_shard(path: str, *, sig_bits: int, sig_ngram: int,
                 sig_hashes: int, fused: bool = True,
                 readahead: bool | None = None, tolerant: bool = False,
                 device="cuda") -> CdxIndex:
    """One-pass sweep of one shard into a single-shard partial index
    (module-level: a pool worker runs it, under spawn too).

    ``fused=True``: digest + signature go through the batched fused
    kernel sweep on ``device`` (resolved here, so a pool worker opens
    its own CUDA context): record payloads are borrowed zero-copy out of
    the parse arena (``content_view()`` — the pending batch pins its
    arenas, bounded by ``_FUSED_BATCH`` records *and*
    ``_FUSED_BATCH_BYTES`` payload bytes) and copied into the padded
    batch matrix by the flush, before the pins are released.
    ``fused=False``: the host path, ``zlib.adler32`` and
    :func:`~repro_torch.index.signature.signature_of` per record; the
    columns are bit-identical either way. ``readahead`` and ``tolerant``
    go to the :class:`~repro_torch.core.warc.FastWARCIterator`; with
    ``tolerant`` the sweep's damage ledger rides the partial back on its
    ``errors``.

    Publishes per-stage wall time to the process obs registry
    (``index.stage.parse_us`` / ``digest_sig_us`` / ``frame_walk_us`` /
    ``assemble_us``).
    """
    from repro_torch import obs
    from repro_torch._device import resolve_device
    from repro_torch.kernels.digest_sig import digest_signature_batch

    if fused:
        device = resolve_device(device)

    t_sweep0 = time.perf_counter()
    t_sig = 0.0
    with open(path, "rb") as f:
        kind = detect_compression(f.read(8))
    offsets: list[int] = []
    uncomp: list[int] = []
    rtypes: list[int] = []
    statuses: list[int] = []
    digests: list = []           # uint32 arrays (fused) / ints (host)
    sigs: list[np.ndarray] = []  # (B, words) (fused) / (words,) rows (host)
    pending: list[np.ndarray] = []  # borrowed payload views awaiting a flush
    pending_bytes = 0
    uri_parts: list[bytes] = []
    mime_parts: list[bytes] = []
    uri_off = [0]
    mime_off = [0]
    last_span = 0

    def flush() -> None:
        nonlocal pending_bytes, t_sig
        t0 = time.perf_counter()
        d, s = digest_signature_batch(pending, bits=sig_bits, n=sig_ngram,
                                      k=sig_hashes, device=device)
        t_sig += time.perf_counter() - t0
        digests.append(d)
        sigs.append(s)
        pending.clear()  # releases the arena pins
        pending_bytes = 0

    # gzip members (and unfiltered LZ4 frames) inflate in a decoder
    # child process, or on a thread, ahead of this loop
    it = FastWARCIterator(path, parse_http=True, readahead=readahead,
                          tolerant=tolerant)
    try:
        for record in it:
            offsets.append(record.stream_offset)
            uncomp.append(record.content_length)
            rtypes.append(int(record.record_type))
            http = record.http_headers
            status = (http.status_code if http is not None
                      and http.status_code is not None else -1)
            # anything outside the int16 column is as good as no status
            statuses.append(status if 0 <= status <= 0x7FFF else -1)
            if fused:
                pending.append(np.frombuffer(record.content_view(),
                                             np.uint8))
                pending_bytes += record.content_length
                if len(pending) >= _FUSED_BATCH or \
                        pending_bytes >= _FUSED_BATCH_BYTES:
                    flush()
            else:
                t0 = time.perf_counter()
                content = record.content_view()
                digests.append(zlib.adler32(content))
                sigs.append(signature_of(content, bits=sig_bits,
                                         n=sig_ngram, k=sig_hashes))
                t_sig += time.perf_counter() - t0
            uri = record.header_bytes(b"WARC-Target-URI:") or b""
            mime = (http.get_bytes(b"Content-Type", b"") if http is not None
                    else record.header_bytes(b"Content-Type:") or b"")
            uri_parts.append(uri)
            mime_parts.append(mime)
            uri_off.append(uri_off[-1] + len(uri))
            mime_off.append(mime_off[-1] + len(mime))
            last_span = _record_span(record)
        if pending:
            flush()
    finally:
        it.close()  # a failed sweep must still join the decoder thread
    t_parse = time.perf_counter() - t_sweep0 - t_sig
    t_frame0 = time.perf_counter()
    n = len(offsets)
    off = np.asarray(offsets, np.uint64)
    # comp_len = distance to the next record in the addressable stream;
    # the tail record ends at the file size (member formats) or at its
    # own serialized span (zstd: the addressable space is the
    # decompressed stream, whose length the file size says nothing about)
    if n:
        end = (off[-1] + np.uint64(last_span)) if kind == "zstd" \
            else np.uint64(os.path.getsize(path))
        comp = np.diff(np.concatenate([off, [end]])).astype(np.uint64)
    else:
        comp = np.empty(0, np.uint64)
    # member formats address the compressed stream, so a record's
    # "frame" is itself; zstd rows map onto their compressed frame
    frame_off, frame_base = off.copy(), off.copy()
    if kind == "zstd" and n:
        frame_off, frame_base = _frame_columns(path, off)
    t_assemble0 = time.perf_counter()
    if not sigs:
        digest_col = np.empty(0, np.uint32)
        sig_col = np.empty((0, sig_bits // 64), np.uint64)
    elif fused:
        digest_col = np.concatenate(digests)
        sig_col = np.concatenate(sigs, axis=0)
    else:
        digest_col = np.asarray(digests, np.uint32)
        sig_col = np.stack(sigs)
    columns = {
        "shard_id": np.zeros(n, np.uint32),
        "offset": off,
        "comp_len": comp,
        "uncomp_len": np.asarray(uncomp, np.uint64),
        "rtype": np.asarray(rtypes, np.uint16),
        "status": np.asarray(statuses, np.int16),
        "digest": digest_col,
        "signatures": sig_col,
        "frame_off": frame_off,
        "frame_base": frame_base,
        "uri_off": np.asarray(uri_off, np.uint64),
        "mime_off": np.asarray(mime_off, np.uint64),
    }
    out = CdxIndex([path], [kind], columns, b"".join(uri_parts),
                   b"".join(mime_parts), sig_bits=sig_bits,
                   sig_ngram=sig_ngram, sig_hashes=sig_hashes)
    reg = obs.registry()
    reg.counter_add("index.shards", 1)
    reg.counter_add("index.records", n)
    reg.counter_add("index.stage.parse_us", int(t_parse * 1e6))
    reg.counter_add("index.stage.digest_sig_us", int(t_sig * 1e6))
    reg.counter_add("index.stage.frame_walk_us",
                    int((t_assemble0 - t_frame0) * 1e6))
    reg.counter_add("index.stage.assemble_us",
                    int((time.perf_counter() - t_assemble0) * 1e6))
    if tolerant:
        # the damage ledger rides the (picklable) partial back to the
        # build_index parent, across the worker process boundary
        out.errors = list(it.error_ledger.entries())
    return out


def build_index(paths, *, workers: int = 0, sig_bits: int = SIG_BITS,
                sig_ngram: int = SIG_NGRAM, sig_hashes: int = SIG_HASHES,
                fused: bool | None = None, readahead: bool | None = None,
                tolerant: bool = False, supervise: bool = False,
                device="cuda") -> CdxIndex:
    """Index a sharded corpus: one parser sweep per shard, merged in
    shard order; the columns are bit-identical to the reference
    package's ``build_index``.

    ``workers > 0`` fans the per-shard sweeps out through
    :func:`repro_torch.core.parallel.map_shards` (each partial is a
    picklable single-shard :class:`CdxIndex`); ``workers=0`` sweeps
    serially. Either way the merge is deterministic in shard order.

    ``fused`` selects the fused digest + signature kernel on ``device``
    (``digest_sig``) over the host path (``zlib.adler32`` +
    ``signature_of``); both give the same columns. Default (None): the
    kernel on a GPU, in the workers too; on the CPU the kernel's plain
    version for serial builds and the host path in pool workers, as the
    reference does. ``fused=False`` keeps a GPU build on the host. With
    the kernel and ``workers > 0`` on a GPU, each worker resolves
    ``device`` itself and launches the kernel there: the kernels are
    built first, in this process, and the workers are started with
    ``forkserver`` or ``spawn``, never ``fork``.

    ``readahead`` (default auto) runs member decompression ahead of each
    sweep: in a forked decoder child for serial sweeps, on a thread in
    pool workers (daemonic processes may not fork).

    ``tolerant`` sweeps each shard in recovery mode: damaged records are
    resynced past instead of aborting the build, and every skipped byte
    range is reported on the returned index's ``errors`` list
    (:class:`~repro_torch.core.warc.errors.LedgerEntry` rows, in shard
    order). ``supervise`` (with ``workers > 0``) retries worker deaths; a shard
    that keeps killing workers is dropped from the merge and reported as
    one ``shard_quarantined`` :class:`~repro_torch.core.warc.errors.
    LedgerEntry` on the returned index's ``errors``. The index carries
    the build's merged observability snapshot on ``index.obs``: parent
    registry counters plus, for worker builds, the pool's transport and
    supervisor counters and every worker's published counters
    (``index.stage.*``, ``kernel.*``, ``ingest.*``).

    The signature geometry (``sig_bits``/``sig_ngram``/``sig_hashes``)
    is persisted in the CDX header; ``sig_bits`` must be a power of two
    multiple of 64, ``2 <= sig_ngram <= 129`` and ``sig_hashes >= 1``.
    Raises ``ValueError`` for a geometry the kernel does not cover.
    """
    from repro_torch._device import resolve_device
    from repro_torch.core.parallel import map_shards
    from repro_torch.core.warc.errors import LedgerEntry
    from repro_torch.kernels.digest_sig.ops import _sig_geometry

    dev = resolve_device(device)
    _sig_geometry(sig_bits, sig_ngram, sig_hashes)
    if fused is None:
        fused = dev.type == "cuda" or workers == 0
    cuda_workers = bool(workers) and fused and dev.type == "cuda"
    if cuda_workers:
        from repro_torch.kernels._build import build_all

        build_all()  # once, here: the workers only load the libraries
    sweep = functools.partial(_index_shard, sig_bits=sig_bits,
                              sig_ngram=sig_ngram, sig_hashes=sig_hashes,
                              fused=fused, readahead=readahead,
                              tolerant=tolerant,
                              device=device if cuda_workers else dev)
    paths = [str(p) for p in paths]
    partials, obs_snap = map_shards(sweep, paths, workers=workers,
                                    supervise=supervise, with_obs=True,
                                    cuda_workers=cuda_workers)
    live: list[CdxIndex] = []
    dropped: list = []
    for path, part in zip(paths, partials):
        if part is None:  # quarantined by the pool supervisor
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            dropped.append(LedgerEntry(
                shard=path, offset=0, error_class="shard_quarantined",
                bytes_skipped=size,
                message="shard repeatedly killed indexing workers"))
            continue
        live.append(part)
    merged = CdxIndex.merge(live)
    merged.errors.extend(dropped)
    merged.obs = obs_snap
    return merged


# --------------------------------------------------------------------------
# Random access
# --------------------------------------------------------------------------

class RandomAccessReader:
    """Fetch single records from one shard by CDX offset.

    The shard is opened once; every :meth:`read` is one seek + one member
    decode + one record parse — cost independent of archive size.
    zstd shards have no compressed-domain member boundaries; when the
    caller supplies a ``frame`` hint (the v2 CDX stores one per record,
    see :meth:`CdxIndex.frame_hint`), the reader seeks straight to the
    containing compressed frame and decompresses only from there —
    without a hint it decompresses the stream once on first access
    (reads then become in-memory seeks). ``verify_digests=True`` checks
    each read record's WARC digest headers
    (``WarcRecord.verified_block_digest`` / ``verified_payload_digest``).
    """

    def __init__(self, path: str, *, parse_http: bool = True,
                 verify_digests: bool = False) -> None:
        self.path = path
        self._f = open(path, "rb")
        self.kind = detect_compression(self._f.read(8))
        self._f.seek(0)
        self._parse_http = parse_http
        self._verify = verify_digests
        self._zbuf: bytes | None = None

    def read(self, offset: int,
             frame: tuple[int, int] | None = None) -> WarcRecord:
        """Parse exactly the record starting at ``offset``.

        ``frame`` — optional ``(frame_off, frame_base)`` pair for zstd
        shards: the compressed offset of the frame containing the record
        and that frame's decompressed base. Ignored for member formats
        (their offsets already address the compressed stream).
        """
        source = self._f
        if self.kind == "zstd":
            if frame is not None and self._zbuf is None:
                frame_off, frame_base = frame
                self._f.seek(int(frame_off))
                source = ForwardWindow(ZstdStream(self._f),
                                       base=int(frame_base))
            else:
                if self._zbuf is None:
                    self._f.seek(0)
                    self._zbuf = ZstdStream(self._f).read()
                source = io.BytesIO(self._zbuf)
        return read_record_at(source, int(offset),
                              parse_http=self._parse_http,
                              verify_digests=self._verify, shard=self.path)

    def read_entry(self, entry: CdxEntry) -> WarcRecord:
        return self.read(entry.offset)

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        self._f.close()
        self._zbuf = None

    def __enter__(self) -> "RandomAccessReader":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def verify_index(index: CdxIndex, *, limit: int | None = None,
                 check_signatures: bool = False,
                 device="cuda") -> list[bool]:
    """Bulk-verify indexed adler32 digests against re-read record content.

    Every checked record (the first ``limit`` rows, default all) is
    fetched through :class:`RandomAccessReader` and the whole batch is
    verified in batched kernel launches on ``device`` — one per width
    bucket, never one per record. Digest-only verification (the default)
    goes through :func:`~repro_torch.core.warc.checksum.verify_digests_bulk`
    (the ``adler32`` kernel); ``check_signatures=True`` routes the batch
    through the fused
    :func:`repro_torch.kernels.digest_sig.digest_signature_batch` sweep
    the build uses, in the build's flush-sized chunks, and additionally
    requires each recomputed n-gram signature to equal the stored row.

    A signature geometry the fused kernel does not cover (an index the
    reference package built with, say, ``sig_bits=192``) raises
    ``ValueError`` on the GPU, as :func:`build_index` does; with
    ``device="cpu"`` its digests go through the ``adler32`` wrapper and
    its signatures are recomputed on the host.
    """
    from repro_torch._device import resolve_device
    from repro_torch.core.warc.checksum import verify_digests_bulk

    dev = resolve_device(device)
    fused = check_signatures and _fused_supported(index.sig_bits,
                                                  index.sig_ngram)
    if check_signatures and not fused and dev.type != "cpu":
        raise ValueError(
            f"the digest_sig kernel does not cover this index's signature "
            f"geometry ({index.sig_bits} bits, {index.sig_ngram}-grams); "
            f"verify its signatures with device='cpu'")
    n = len(index) if limit is None else min(limit, len(index))
    datas: list[bytes] = []
    readers: dict[int, RandomAccessReader] = {}
    try:
        for i in range(n):
            sid = int(index.shard_id[i])
            reader = readers.get(sid)
            if reader is None:
                reader = readers[sid] = RandomAccessReader(
                    index.shard_paths[sid], parse_http=False)
            datas.append(reader.read(int(index.offset[i]),
                                     frame=index.frame_hint(i)).content)
    finally:
        for reader in readers.values():
            reader.close()
    expected = index.digest[:n].astype(np.uint32)
    if fused:
        from repro_torch.kernels.digest_sig import digest_signature_batch

        # chunked like the build's flushes: one unbounded sweep would pad
        # the whole corpus into int32 hash matrices (4x the payload bytes)
        ok = np.empty(n, bool)
        start = 0
        while start < n:
            end = start + 1
            nbytes = len(datas[start])
            while end < n and end - start < _FUSED_BATCH and \
                    nbytes < _FUSED_BATCH_BYTES:
                nbytes += len(datas[end])
                end += 1
            digests, sigs = digest_signature_batch(
                datas[start:end], bits=index.sig_bits, n=index.sig_ngram,
                k=index.sig_hashes, device=dev)
            ok[start:end] = ((digests == expected[start:end])
                             & (sigs == index.signatures[start:end])
                             .all(axis=1))
            start = end
        return [bool(b) for b in ok]
    headers = [f"adler32:{int(d):08x}" for d in expected]
    results = verify_digests_bulk(datas, headers, device=dev)
    if check_signatures:
        for i, data in enumerate(datas):
            sig = signature_of(data, bits=index.sig_bits,
                               n=index.sig_ngram, k=index.sig_hashes)
            results[i] = results[i] and bool(
                (sig == index.signatures[i]).all())
    return results
