"""Columnar derived store: analytics-native shards of a WARC corpus.

The on-disk product of :mod:`repro_torch.columnar.derive`, byte for
byte the reference package's ``.repcol`` format: one TOC'd container
(:mod:`repro_torch.columnar.codec`) holding, per record of the source
corpus —

* fixed-width metadata columns: ``offset`` (source stream offset),
  ``length`` (content bytes), ``rtype`` / ``status`` / ``timestamp``
  (WARC-Date as epoch seconds, 0 when unparsable), the Adler-32
  ``digest`` and the ``(n, bits//64)`` n-gram ``signatures`` matrix —
  the exact byte columns the CDX index stores, derived from the same
  single parse;
* URI / MIME byte heaps with ``(n+1)`` offset columns (CDX layout);
* the record's placement: ``rg_id`` / ``rg_row``;

plus the **payload row-groups**: extracted content blocks packed into
``(padded_rows, width + ROWGROUP_PAD)`` uint8 matrices in the kernels'
native layout — payload left-justified, zero tail — one matrix per
row-group, concatenated in one blob. Rows are grouped by half-step
width bucket at derive time (:func:`pack_plan`), so a full-corpus
kernel scan reads mmapped matrices **directly**: no per-record
decompression, HTTP parse or re-bucketing on the query path.

Ownership: every matrix/column access is a zero-copy view on the
container mapping; :meth:`ColumnStore.close` raises ``BufferError``
while views are alive (see :mod:`repro_torch.columnar.codec`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.kernels.bucketing import (
    ROWGROUP_PAD,
    payload_width,
    quantize_count,
)
from .codec import ColumnFile

__all__ = ["ColumnStore", "FORMAT", "RowGroupSpec", "STORE_VERSION",
           "pack_plan"]

FORMAT = "repro-columnar"
STORE_VERSION = 1

# Row-group caps: bound the transient matrix a derive holds in RAM while
# streaming the blob, and the matrix one scan launch copies to the device.
# Part of the store format: the reference package plans with the same caps.
RG_MAX_ROWS = 1024
RG_MAX_BYTES = 8 << 20  # padded bytes per group

_BLOCK = 2048  # digest kernel Adler block (import-free: meta-validated)


@dataclass
class RowGroupSpec:
    """One planned row-group: which record rows share one matrix."""

    width: int            # payload columns (excl. ROWGROUP_PAD tail)
    rows: np.ndarray      # record rows packed here, in-group order
    padded_rows: int      # half-step quantized row count of the matrix

    @property
    def nbytes(self) -> int:
        return self.padded_rows * (self.width + ROWGROUP_PAD)


def pack_plan(lengths, *, block: int = _BLOCK, max_rows: int = RG_MAX_ROWS,
              max_bytes: int = RG_MAX_BYTES) -> list[RowGroupSpec]:
    """Plan row-groups for a corpus of payload lengths.

    Records are grouped by their half-step width bucket (equivalently:
    sorted by length and cut at bucket boundaries — every row in a group
    pads to the group width with ≤ 1.5× individual waste), then each
    bucket is chunked under the row/byte caps and its row count
    half-step quantized. Returned specs are ordered by ascending width,
    record order preserved within a bucket, so ``rg_id`` assignment is
    deterministic for a given corpus.
    """
    buckets: dict[int, list[int]] = {}
    for i, ln in enumerate(lengths):
        buckets.setdefault(payload_width(int(ln), block), []).append(i)
    plan: list[RowGroupSpec] = []
    for width in sorted(buckets):
        idxs = buckets[width]
        cap = max(1, min(max_rows, max_bytes // (width + ROWGROUP_PAD)))
        for s in range(0, len(idxs), cap):
            chunk = np.asarray(idxs[s:s + cap], np.int64)
            plan.append(RowGroupSpec(width=width, rows=chunk,
                                     padded_rows=quantize_count(chunk.size)))
    return plan


class ColumnStore:
    """mmap-backed reader over one derived columnar shard file."""

    def __init__(self, path: str) -> None:
        self._file = ColumnFile(path)
        meta = self._file.meta
        if meta.get("format") != FORMAT:
            self._file.close()
            raise ValueError(f"{path}: not a columnar store "
                             f"(format={meta.get('format')!r})")
        if meta.get("store_version") != STORE_VERSION:
            self._file.close()
            raise ValueError(f"{path}: unsupported store version "
                             f"{meta.get('store_version')}")
        self.path = path
        self.shard_paths: list[str] = list(meta["shard_paths"])
        self.shard_kinds: list[str] = list(meta["shard_kinds"])
        self.sig_bits: int = int(meta["sig_bits"])
        self.sig_ngram: int = int(meta["sig_ngram"])
        self.sig_hashes: int = int(meta["sig_hashes"])
        self.block: int = int(meta["block"])
        self.pad: int = int(meta["rowgroup_pad"])
        if self.pad != ROWGROUP_PAD:
            self._file.close()
            raise ValueError(
                f"{path}: row-group pad {self.pad} != kernel layout "
                f"{ROWGROUP_PAD}; re-derive with this build")
        f = self._file
        # per-record columns (zero-copy views on the mapping)
        self.shard_id = f.array("shard_id")
        self.offset = f.array("offset")
        self.length = f.array("length")
        self.rtype = f.array("rtype")
        self.status = f.array("status")
        self.timestamp = f.array("timestamp")
        self.digest = f.array("digest")
        self.signatures = f.array("signatures")
        self.rg_id = f.array("rg_id")
        self.rg_row = f.array("rg_row")
        self.uri_off = f.array("uri_off")
        self.mime_off = f.array("mime_off")
        # row-group table
        self.rg_width = f.array("rg_width")
        self.rg_rows = f.array("rg_rows")
        self.rg_padded = f.array("rg_padded")
        self.rg_byte_off = f.array("rg_byte_off")
        # record rows in row-group order: members of group g are
        # rg_order[rg_start[g]:rg_start[g+1]] in rg_row order
        self.rg_order = f.array("rg_order")
        self.rg_start = np.concatenate(
            [[0], np.cumsum(self.rg_rows)]).astype(np.int64)
        # heaps copied out (small): bytes slicing semantics, and uri()/
        # mime() results must outlive close()
        self.uri_heap: bytes = f.blob("uri_heap")
        self.mime_heap: bytes = f.blob("mime_heap")
        # in-memory only (not in the file): derive attaches its merged
        # ObsSnapshot and the LedgerEntry rows of quarantined shards
        self.obs = None
        self.errors: list = []

    # -- access ----------------------------------------------------------
    def __len__(self) -> int:
        return int(self.offset.size)

    @property
    def n_rowgroups(self) -> int:
        return int(self.rg_width.size)

    def rowgroup(self, g: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One packed row-group, kernel-ready and zero-copy.

        Returns ``(matrix, record_rows, lengths)``: the mmapped
        ``(padded_rows, width + pad)`` uint8 matrix, the record rows
        occupying its live rows (in row order), and their true payload
        lengths — exactly the inputs
        :func:`repro_torch.kernels.pattern_scan.find_pattern_mask_rowgroup`
        and :func:`repro_torch.kernels.digest_sig.digest_signature_rowgroup`
        take.
        """
        width = int(self.rg_width[g])
        matrix = self._file.view(
            "payload", int(self.rg_byte_off[g]),
            (int(self.rg_padded[g]), width + self.pad))
        record_rows = self.rg_order[self.rg_start[g]:self.rg_start[g + 1]]
        return matrix, record_rows, self.length[record_rows].astype(np.int64)

    def payload(self, row: int) -> bytes:
        """One record's content block, copied out of its row-group —
        byte-identical to ``WarcRecord.content`` of the source record
        (the store's fetch path: no seek, decompress, or parse)."""
        g = int(self.rg_id[row])
        width = int(self.rg_width[g])
        start = (int(self.rg_byte_off[g])
                 + int(self.rg_row[row]) * (width + self.pad))
        view = self._file.view("payload", start, (int(self.length[row]),))
        return view.tobytes()

    def uri(self, i: int) -> bytes:
        return self.uri_heap[self.uri_off[i]:self.uri_off[i + 1]]

    def mime(self, i: int) -> bytes:
        return self.mime_heap[self.mime_off[i]:self.mime_off[i + 1]]

    def pad_waste_ratio(self) -> float:
        """Padding share of the stored row-group bytes (the derive-time
        answer to the ragged-batch pad-waste counter)."""
        padded = int((self.rg_padded * (self.rg_width + self.pad)).sum())
        useful = int(self.length.sum())
        return 1.0 - useful / padded if padded else 0.0

    # -- interop ----------------------------------------------------------
    def as_index(self):
        """An in-memory :class:`~repro_torch.index.cdx.CdxIndex` over this
        store's metadata columns — same rows, same row order, bit-equal
        digest/signature columns (the derive round-trip test asserts
        this against a real CDX build of the same corpus).

        Lets a :class:`~repro_torch.index.query.QueryEngine` run standalone on
        a store, no CDX file needed: planner stages read these columns,
        the scan stage reads the row-groups. ``comp_len`` is zero (the
        store does not address compressed members) and zstd rows carry
        ``NO_FRAME`` — fetches should go through the store, not a
        reader; the columns exist so the engine's planner and hit
        assembly work unchanged.
        """
        from repro_torch.index.cdx import NO_FRAME, CdxIndex

        n = len(self)
        frame_off = self.offset.copy()
        frame_base = self.offset.copy()
        zstd_rows = np.asarray(
            [k == "zstd" for k in self.shard_kinds], bool)[self.shard_id]
        frame_off[zstd_rows] = NO_FRAME
        frame_base[zstd_rows] = NO_FRAME
        columns = {
            "shard_id": self.shard_id,
            "offset": self.offset,
            "comp_len": np.zeros(n, np.uint64),
            "uncomp_len": self.length,
            "rtype": self.rtype,
            "status": self.status,
            "digest": self.digest,
            "signatures": self.signatures,
            "frame_off": frame_off,
            "frame_base": frame_base,
            "uri_off": self.uri_off,
            "mime_off": self.mime_off,
        }
        return CdxIndex(self.shard_paths, self.shard_kinds, columns,
                        self.uri_heap, self.mime_heap,
                        sig_bits=self.sig_bits, sig_ngram=self.sig_ngram,
                        sig_hashes=self.sig_hashes)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        """Release the mapping. The column attributes and any row-group
        matrices handed out are borrowed views — drop them first or this
        raises ``BufferError`` (see module docstring)."""
        for name in ("shard_id", "offset", "length", "rtype", "status",
                     "timestamp", "digest", "signatures", "rg_id", "rg_row",
                     "uri_off", "mime_off", "rg_width", "rg_rows",
                     "rg_padded", "rg_byte_off", "rg_order"):
            if hasattr(self, name):
                delattr(self, name)
        self._file.close()

    def __enter__(self) -> "ColumnStore":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
