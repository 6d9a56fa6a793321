"""Indexed archive query engine: header predicates + batched pattern scan.

The filter-first pipeline over a :class:`repro_torch.index.cdx.CdxIndex`.
A query narrows the corpus in three strictly cheaper-to-more-expensive
stages:

1. **header predicates** — record type / HTTP status / MIME prefix /
   URL prefix evaluate as vector compares over the columnar index; no
   archive byte is touched.
2. **signature pre-filter** — the per-record n-gram bitmap
   (:mod:`repro_torch.index.signature`) eliminates records that *cannot*
   contain the pattern; eliminated records are never decompressed.
3. **batched payload scan** — surviving candidates are fetched through
   per-shard :class:`~repro_torch.index.cdx.RandomAccessReader`\\ s
   (offsets sorted for locality), gathered into ragged batches, and each
   batch goes through :func:`repro_torch.kernels.pattern_scan.\
find_pattern_mask_batch` on the engine's device — one kernel launch per
   width bucket.

Stages 1–2 are reified as a :class:`QueryPlan` (``engine.plan`` /
``engine.plan_regex``); ``engine.execute`` runs a plan to hits.

**Columnar path**: with a derived
:class:`repro_torch.columnar.ColumnStore` attached (``attach_store`` /
``from_store``), stage 3 becomes ``execute_columnar`` — candidates are
grouped by the row-group that already holds their payload in the
kernel's packed layout, and each group is **one**
:func:`repro_torch.kernels.pattern_scan.find_pattern_mask_rowgroup`
launch over the mmapped matrix. No per-record seek, decompression or
HTTP parse on the query path; payload bytes are materialized only for
candidates whose scan stage hit and that need verification. Hits are
identical to the CDX+seek path's. The store also carries the WARC-Date
``timestamp`` column that ``HeaderFilter.time_range`` reads.

**Regex queries** (``search_regex``) compile to the same shape: the
regex's required literal runs drive the signature pre-filter and the
kernel scan, and surviving candidates are host-verified with ``re``. A
regex with no usable literal degrades to host ``re`` over the
header-filtered candidates.

``engine.stats`` records how much work each stage avoided (candidate
counts, records scanned, kernel dispatches).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from re import _parser as _sre_parse  # type: ignore[attr-defined]
from typing import TYPE_CHECKING

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.warc.record import WarcRecordType
from .cdx import CdxIndex, RandomAccessReader
from .signature import candidate_mask

if TYPE_CHECKING:  # annotation only (no import cycle)
    from repro_torch.columnar.store import ColumnStore

__all__ = ["HeaderFilter", "PatternHit", "QueryEngine", "QueryPlan",
           "full_scan_search", "full_scan_regex", "host_positions",
           "required_literals"]

_DEFAULT_BATCH_RECORDS = 64     # candidates per scan batch, or…
_DEFAULT_BATCH_BYTES = 4 << 20  # …payload bytes, whichever trips first
_DEFAULT_SCAN_BLOCK = 8192      # width-bucket granularity: few-KiB records
                                # pad ≤2×, not to the 64 KiB whole-buffer
                                # default
_COLUMNAR_DENSITY = 0.25  # candidate share above which scanning the whole
                          # row-group beats gathering candidates into a
                          # compact matrix (gather copies; whole-group reads
                          # the mapping in place)


@dataclass
class HeaderFilter:
    """Columnar header predicates (all optional, AND-combined).

    ``time_range`` — ``(lo, hi)`` epoch seconds, half-open — evaluates
    against the derived store's WARC-Date timestamp column and therefore
    needs a store-attached engine (the CDX index does not carry
    timestamps).
    """

    record_type: WarcRecordType | None = None
    status: int | None = None
    mime_prefix: bytes | None = None
    url_prefix: bytes | None = None
    time_range: tuple[int, int] | None = None

    def key(self) -> tuple:
        """Hashable identity (dataclass __hash__ is suppressed by eq)."""
        return (None if self.record_type is None else int(self.record_type),
                self.status, self.mime_prefix, self.url_prefix,
                self.time_range)


@dataclass
class PatternHit:
    """One matching record with its in-content match positions."""

    index_row: int
    shard: str
    offset: int
    uri: bytes
    n_matches: int
    positions: np.ndarray = field(repr=False)
    excerpt: bytes = b""


@dataclass
class QueryPlan:
    """Stages 1–2 of one query, reified: what to scan and how to verify.

    ``rows`` is the candidate set in fetch order (shard-grouped,
    offset-sorted). Stage 3 scans each candidate for ``kernel_pattern``
    on the device (``None`` → host-only scan), then :meth:`verify` maps
    a candidate's literal hits to its final match positions —
    full-literal compare for patterns longer than the kernel window,
    ``re`` for regex queries.
    """

    pattern: bytes               # the query as submitted (literal / source)
    rows: np.ndarray             # candidate index rows, fetch order
    kernel_pattern: bytes | None  # device-scannable literal prefix
    literal: bytes | None        # full required literal (None: regex w/o one)
    regex: "re.Pattern | None" = None

    def verify(self, buf: bytes,
               literal_positions: np.ndarray) -> tuple[np.ndarray, int]:
        """Final match positions in ``buf`` + first-match byte length."""
        if self.regex is not None:
            if self.literal is not None and literal_positions.size == 0:
                return np.empty(0, np.int64), 0
            matches = list(self.regex.finditer(buf))
            if not matches:
                return np.empty(0, np.int64), 0
            first = matches[0]
            return (np.asarray([m.start() for m in matches], np.int64),
                    max(first.end() - first.start(), 1))
        lit = self.literal if self.literal is not None else self.pattern
        positions = literal_positions
        if self.kernel_pattern is not None and len(lit) > len(
                self.kernel_pattern):
            # kernel scanned a prefix; confirm the (few) survivors
            positions = np.asarray(
                [p for p in positions if buf[p:p + len(lit)] == lit],
                np.int64)
        return positions, len(lit)

    @property
    def needs_host_scan(self) -> bool:
        """True when the scan stage itself must run on the host (no
        device-safe literal: all-zero prefix, or a literal-free regex)."""
        return self.kernel_pattern is None

    def host_scan(self, buf: bytes) -> np.ndarray:
        """Host-side scan-stage positions for one candidate payload. A
        literal-free regex has nothing to pre-scan for: a non-empty
        sentinel makes verify() run the regex on every candidate."""
        if self.regex is not None and self.literal is None:
            return np.zeros(1, np.int64)
        return host_positions(
            buf, self.literal if self.literal is not None else self.pattern)


def host_positions(buf: bytes, pattern: bytes) -> np.ndarray:
    """All (overlapping) occurrences of ``pattern`` — host scan path."""
    pos, i = [], buf.find(pattern)
    while i >= 0:
        pos.append(i)
        i = buf.find(pattern, i + 1)
    return np.asarray(pos, np.int64)


def required_literals(pattern: bytes, flags: int = 0) -> list[bytes]:
    """Literal byte runs every match of ``pattern`` must contain.

    Conservative walk of the parsed regex: top-level concatenation
    literals form runs; a group or a repeat with ``min >= 1`` is entered;
    branches, classes, optional parts contribute nothing.
    Case-insensitive patterns return no literals. Every returned literal
    occurs in every match; literals only *pre-filter*, ``re`` confirms.
    """
    if flags & re.IGNORECASE:
        return []
    try:
        parsed = _sre_parse.parse(pattern, flags)
    except re.error:
        return []
    # inline flags ((?i)...) surface only after the parse
    if getattr(parsed.state, "flags", 0) & re.IGNORECASE:
        return []
    literals: list[bytes] = []

    def walk(ops) -> None:
        run = bytearray()

        def flush() -> None:
            if run:
                literals.append(bytes(run))
                run.clear()

        for op, args in ops:
            name = str(op)
            if name == "LITERAL" and args <= 0xFF:
                run.append(args)
                continue
            flush()
            if name in ("MAX_REPEAT", "MIN_REPEAT"):
                lo, _hi, sub = args
                if lo >= 1:
                    walk(sub)
            elif name == "SUBPATTERN":
                # scoped inline flags ((?i:...)) make the group's bytes
                # not-required-as-written: contribute nothing from it
                if not args[1] & re.IGNORECASE:
                    walk(args[3])
            elif name == "ATOMIC_GROUP":
                walk(args)
            # BRANCH / IN / ANY / AT / NOT_LITERAL / ...: no requirement
        flush()

    walk(parsed)
    return [lit for lit in literals if lit]


class QueryEngine:
    """Run header + pattern queries against an indexed corpus on
    ``device`` (default the GPU; ``"cpu"`` only when asked).

    ``batch_records`` / ``batch_bytes`` bound one CDX+seek scan batch
    (and one gateway scan chunk), ``scan_block`` is the batch kernel's
    width-bucket granularity, ``excerpt_bytes`` the hit excerpt length
    after the first match.
    """

    def __init__(self, index: CdxIndex, *,
                 store: "ColumnStore | None" = None,
                 batch_records: int = _DEFAULT_BATCH_RECORDS,
                 batch_bytes: int = _DEFAULT_BATCH_BYTES,
                 scan_block: int = _DEFAULT_SCAN_BLOCK,
                 excerpt_bytes: int = 80, device="cuda") -> None:
        self.device = resolve_device(device)
        self.index = index
        self.batch_records = max(1, batch_records)
        self.batch_bytes = max(1, batch_bytes)
        self.scan_block = scan_block
        self.excerpt_bytes = excerpt_bytes
        self._readers: dict[int, RandomAccessReader] = {}
        self._store: "ColumnStore | None" = None
        self.stats = {"queries": 0, "header_candidates": 0,
                      "sig_candidates": 0, "records_scanned": 0,
                      "bytes_scanned": 0, "kernel_dispatches": 0,
                      "batches": 0, "store_fetches": 0}
        if store is not None:
            self.attach_store(store)

    @classmethod
    def from_store(cls, store: "ColumnStore", **kwargs) -> "QueryEngine":
        """An engine running standalone on a derived store — planner
        stages over :meth:`~repro_torch.columnar.ColumnStore.as_index`'s
        columns, scan stage over the store's row-groups. No CDX file
        and no archive readers involved."""
        engine = cls(store.as_index(), **kwargs)
        engine.attach_store(store, validate=False)
        return engine

    def attach_store(self, store: "ColumnStore",
                     validate: bool = True) -> None:
        """Attach a derived columnar store covering this engine's corpus.

        Attached, the engine routes ``execute`` through
        :meth:`execute_columnar` and serves ``_fetch`` from the store's
        row-groups (no seek/decompress). ``validate`` checks the store
        rows are 1:1 with the index rows (derive and CDX build share row
        order by construction; a store derived from a *different* corpus
        is rejected here rather than silently mis-scanned).
        """
        if validate:
            if len(store) != len(self.index):
                raise ValueError(
                    f"store has {len(store)} rows, index has "
                    f"{len(self.index)} — not the same corpus")
            if list(store.shard_paths) != list(self.index.shard_paths):
                raise ValueError("store and index cover different shards")
            if not np.array_equal(np.asarray(store.offset),
                                  np.asarray(self.index.offset)):
                raise ValueError("store row order does not match the "
                                 "index (offset columns differ)")
        self._store = store

    @property
    def store(self) -> "ColumnStore | None":
        return self._store

    # -- stage 1: header predicates (pure columnar) ----------------------
    def header_mask(self, flt: HeaderFilter | None) -> np.ndarray:
        """Boolean row mask from the metadata columns alone."""
        idx = self.index
        mask = np.ones(len(idx), dtype=bool)
        if flt is None:
            return mask
        if flt.record_type is not None:
            mask &= (idx.rtype.astype(np.int64)
                     & np.int64(int(flt.record_type))) != 0
        if flt.status is not None:
            # int64 compare: a bad user-supplied status (out of int16
            # range) selects nothing instead of raising OverflowError
            mask &= idx.status.astype(np.int64) == int(flt.status)
        if flt.mime_prefix is not None:
            mask &= np.char.startswith(idx.mimes(), bytes(flt.mime_prefix))
        if flt.url_prefix is not None:
            mask &= np.char.startswith(idx.uris(), bytes(flt.url_prefix))
        if flt.time_range is not None:
            if self._store is None:
                raise ValueError(
                    "time_range filters read the derived store's "
                    "timestamp column — attach_store() first (the CDX "
                    "index carries no WARC-Date)")
            lo, hi = flt.time_range
            ts = self._store.timestamp.astype(np.int64)
            mask &= (ts >= int(lo)) & (ts < int(hi))
        return mask

    # -- stages 1+2: plan construction -----------------------------------
    def _finish_plan(self, mask: np.ndarray, literals: list[bytes],
                     prefilter: bool) -> np.ndarray:
        """Apply the signature pre-filter and fix the fetch order."""
        self.stats["queries"] += 1
        self.stats["header_candidates"] += int(mask.sum())
        if prefilter:
            for lit in literals:
                mask &= candidate_mask(self.index.signatures, lit,
                                       n=self.index.sig_ngram,
                                       k=self.index.sig_hashes)
        rows = np.flatnonzero(mask)
        self.stats["sig_candidates"] += int(rows.size)
        # shard-grouped, offset-sorted fetch order for read locality
        order = np.lexsort((self.index.offset[rows],
                            self.index.shard_id[rows]))
        return rows[order]

    @staticmethod
    def _kernel_literal(literal: bytes) -> bytes | None:
        """Device-scannable prefix of a literal, or None (host scan)."""
        from repro_torch.kernels.pattern_scan.pattern_scan import MAX_PATTERN

        kpat = literal[:MAX_PATTERN]
        # all-zero prefix: the kernel wrapper rejects it (zero padding
        # could false-positive); those rare queries scan on the host
        return kpat if any(kpat) else None

    def plan(self, pattern: bytes, flt: HeaderFilter | None = None, *,
             prefilter: bool = True) -> QueryPlan:
        """Stages 1+2 for a literal pattern query."""
        pattern = bytes(pattern)
        if not pattern:
            raise ValueError("empty pattern")
        rows = self._finish_plan(self.header_mask(flt), [pattern], prefilter)
        return QueryPlan(pattern=pattern, rows=rows,
                         kernel_pattern=self._kernel_literal(pattern),
                         literal=pattern)

    def plan_regex(self, regex: "bytes | re.Pattern",
                   flt: HeaderFilter | None = None, *,
                   prefilter: bool = True) -> QueryPlan:
        """Stages 1+2 for a regex query: required literals drive the
        pre-filter and the kernel scan; ``re`` verifies survivors."""
        compiled = regex if isinstance(regex, re.Pattern) else re.compile(
            regex)
        if not isinstance(compiled.pattern, bytes):
            raise TypeError("content scans need a bytes regex")
        literals = required_literals(compiled.pattern, compiled.flags
                                     & ~re.UNICODE)
        rows = self._finish_plan(self.header_mask(flt), literals, prefilter)
        scan_literal = max(literals, key=len) if literals else None
        return QueryPlan(
            pattern=compiled.pattern, rows=rows,
            kernel_pattern=(self._kernel_literal(scan_literal)
                            if scan_literal else None),
            literal=scan_literal, regex=compiled)

    # -- stage 3: execution ----------------------------------------------
    def search(self, pattern: bytes, flt: HeaderFilter | None = None, *,
               prefilter: bool = True) -> list[PatternHit]:
        """All records whose content block contains ``pattern``.

        Results are in index order. Candidates are fetched shard-by-shard
        in ascending offset order and scanned in ragged batches of at
        most ``batch_records`` records / ``batch_bytes`` bytes.
        """
        return self.execute(self.plan(pattern, flt, prefilter=prefilter))

    def search_regex(self, regex: "bytes | re.Pattern",
                     flt: HeaderFilter | None = None, *,
                     prefilter: bool = True) -> list[PatternHit]:
        """All records whose content block matches ``regex`` (bytes);
        ``n_matches``/``positions`` follow ``re.finditer`` semantics."""
        return self.execute(self.plan_regex(regex, flt, prefilter=prefilter))

    def execute(self, plan: QueryPlan, *,
                columnar: bool | None = None) -> list[PatternHit]:
        """Run a plan's scan stage: fetch, batch, launch, verify.

        With a store attached the scan routes through
        :meth:`execute_columnar` (identical hits); pass
        ``columnar=False`` to force the fetch-and-batch path, or
        ``columnar=True`` to require the store (raises if absent).
        """
        if columnar is None:
            columnar = self._store is not None
        if columnar:
            return self.execute_columnar(plan)
        hits: list[PatternHit] = []
        batch_rows: list[int] = []
        batch_bufs: list[bytes] = []
        pending = 0
        for r in plan.rows:
            content = self._fetch(int(r))
            batch_rows.append(int(r))
            batch_bufs.append(content)
            pending += len(content)
            if (len(batch_rows) >= self.batch_records
                    or pending >= self.batch_bytes):
                hits.extend(self._scan_batch(batch_rows, batch_bufs, plan))
                batch_rows, batch_bufs, pending = [], [], 0
        if batch_rows:
            hits.extend(self._scan_batch(batch_rows, batch_bufs, plan))
        hits.sort(key=lambda h: h.index_row)
        return hits

    # -- stage 3, columnar: kernels over mmapped row-groups ---------------
    def execute_columnar(self, plan: QueryPlan) -> list[PatternHit]:
        """Run a plan's scan stage against the attached derived store.

        Candidates are grouped by row-group; each group is one row-group
        kernel launch — **dense** groups (candidate share ≥
        ``_COLUMNAR_DENSITY`` of the group's live rows) scan the mmapped
        matrix in place, **sparse** groups gather just the candidate rows
        into a compact matrix first. Payload bytes are copied out only
        for candidates whose scan stage hit and that need verification;
        everything else never leaves the mapping. Hits are identical to
        :meth:`execute` over the CDX+seek path.
        """
        store = self._store
        if store is None:
            raise ValueError("no columnar store attached — attach_store() "
                             "or QueryEngine.from_store()")
        hits: list[PatternHit] = []
        if plan.rows.size == 0:
            return hits
        from repro_torch.kernels.pattern_scan import find_pattern_mask_rowgroup

        gids = store.rg_id[plan.rows].astype(np.int64)
        order = np.argsort(gids, kind="stable")
        ordered = plan.rows[order]
        bounds = np.flatnonzero(np.diff(gids[order])) + 1
        # short-literal plans need no per-candidate verification: the
        # kernel positions are final and the excerpt window slices
        # straight out of the row-group matrix — no payload copy at all
        lit = plan.literal if plan.literal is not None else plan.pattern
        fast_literal = (plan.regex is None and plan.kernel_pattern is not None
                        and len(lit) <= len(plan.kernel_pattern))
        for chunk in np.split(ordered, bounds):
            g = int(store.rg_id[chunk[0]])
            lengths = store.length[chunk].astype(np.int64)
            self.stats["batches"] += 1
            self.stats["records_scanned"] += int(chunk.size)
            self.stats["bytes_scanned"] += int(lengths.sum())
            if plan.needs_host_scan:  # materialize each candidate
                for r in chunk:
                    buf = store.payload(int(r))
                    positions, first_len = plan.verify(buf,
                                                       plan.host_scan(buf))
                    if positions.size:
                        hits.append(self.make_hit(int(r), buf, positions,
                                                  first_len))
                continue
            matrix, _, all_lens = store.rowgroup(g)
            if chunk.size >= _COLUMNAR_DENSITY * int(store.rg_rows[g]):
                # dense: one launch over the whole mmapped matrix
                source = matrix
                mask_rows = store.rg_row[chunk].astype(np.int64)
                mask_lens = all_lens
            else:
                # sparse: gather the candidates into a compact matrix
                source = matrix[store.rg_row[chunk].astype(np.int64)]
                mask_rows = np.arange(chunk.size)
                mask_lens = lengths
            masks = find_pattern_mask_rowgroup(
                source, mask_lens, plan.kernel_pattern, trim=False,
                device=self.device)
            self.stats["kernel_dispatches"] += 1
            # one pass over the whole group mask instead of a
            # flatnonzero per candidate; row-major order keeps each
            # candidate's positions one contiguous hit_cols run
            flat = np.flatnonzero(masks.view(bool))
            hit_rows, hit_cols = np.divmod(flat, masks.shape[1])
            # trim=False left windows past each row's true end in the
            # mask; drop them here on the compact hit list
            valid = hit_cols < np.maximum(
                mask_lens - len(plan.kernel_pattern) + 1, 0)[hit_rows]
            hit_rows = hit_rows[valid]
            hit_cols = hit_cols[valid]
            starts = np.searchsorted(hit_rows, mask_rows, side="left")
            ends = np.searchsorted(hit_rows, mask_rows, side="right")
            for i in np.flatnonzero(ends > starts):
                r = int(chunk[i])
                lpos = hit_cols[starts[i]:ends[i]].astype(np.int64)
                if fast_literal:  # positions final; excerpt off the row
                    row = source[int(mask_rows[i])][:int(lengths[i])]
                    hits.append(self.make_hit(r, row, lpos, len(lit)))
                    continue
                buf = store.payload(r)
                positions, first_len = plan.verify(buf, lpos)
                if positions.size:
                    hits.append(self.make_hit(r, buf, positions,
                                              first_len))
        hits.sort(key=lambda h: h.index_row)
        return hits

    # -- internals -------------------------------------------------------
    def _fetch(self, row: int) -> bytes:
        if self._store is not None:  # row-group copy-out: no seek/inflate
            self.stats["store_fetches"] += 1
            return self._store.payload(row)
        sid = int(self.index.shard_id[row])
        reader = self._readers.get(sid)
        if reader is None:
            reader = self._readers[sid] = RandomAccessReader(
                self.index.shard_paths[sid], parse_http=False)
        return reader.read(int(self.index.offset[row]),
                           frame=self.index.frame_hint(row)).content

    def make_hit(self, row: int, buf: bytes, positions: np.ndarray,
                 first_len: int) -> PatternHit:
        """Assemble one hit."""
        first = int(positions[0])
        excerpt = bytes(buf[max(0, first - 16):
                            first + first_len + self.excerpt_bytes])
        sid = int(self.index.shard_id[row])
        return PatternHit(
            index_row=row, shard=self.index.shard_paths[sid],
            offset=int(self.index.offset[row]), uri=self.index.uri(row),
            n_matches=int(positions.size), positions=positions,
            excerpt=excerpt)

    def _scan_batch(self, rows: list[int], bufs: list[bytes],
                    plan: QueryPlan) -> list[PatternHit]:
        self.stats["batches"] += 1
        self.stats["records_scanned"] += len(rows)
        self.stats["bytes_scanned"] += sum(len(b) for b in bufs)
        if not plan.needs_host_scan:
            from repro_torch.kernels.bucketing import dispatch_count
            from repro_torch.kernels.pattern_scan import (
                find_pattern_mask_batch)

            masks = find_pattern_mask_batch(bufs, plan.kernel_pattern,
                                            block=self.scan_block,
                                            device=self.device)
            lit_positions = [np.flatnonzero(m) for m in masks]
            self.stats["kernel_dispatches"] += dispatch_count(
                [len(b) for b in bufs], self.scan_block)
        else:  # host path: plain bytes.find sweep (or regex verify-all)
            lit_positions = [plan.host_scan(buf) for buf in bufs]
        hits = []
        for row, buf, lpos in zip(rows, bufs, lit_positions):
            positions, first_len = plan.verify(buf, lpos)
            if positions.size:
                hits.append(self.make_hit(row, buf, positions, first_len))
        return hits

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        for reader in self._readers.values():
            reader.close()
        self._readers.clear()

    def __enter__(self) -> "QueryEngine":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def full_scan_search(paths, pattern: bytes) -> dict[tuple[str, int], int]:
    """Naive baseline: decompress + scan **every** record of every shard.

    Returns ``{(shard, offset): n_matches}`` for records containing the
    pattern — the host oracle the indexed path is held against.
    """
    from repro_torch.core.warc.fastwarc import FastWARCIterator

    pattern = bytes(pattern)
    out: dict[tuple[str, int], int] = {}
    for path in paths:
        for record in FastWARCIterator(str(path), parse_http=False):
            content = record.content
            n, i = 0, content.find(pattern)
            while i >= 0:
                n += 1
                i = content.find(pattern, i + 1)
            if n:
                out[(str(path), record.stream_offset)] = n
    return out


def full_scan_regex(paths, regex: "bytes | re.Pattern"
                    ) -> dict[tuple[str, int], int]:
    """Regex oracle: ``re.finditer`` over every record of every shard."""
    from repro_torch.core.warc.fastwarc import FastWARCIterator

    compiled = regex if isinstance(regex, re.Pattern) else re.compile(regex)
    out: dict[tuple[str, int], int] = {}
    for path in paths:
        for record in FastWARCIterator(str(path), parse_http=False):
            n = sum(1 for _ in compiled.finditer(record.content))
            if n:
                out[(str(path), record.stream_offset)] = n
    return out
