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

**Regex queries** (``search_regex``) compile to the same shape: the
regex's required literal runs drive the signature pre-filter and the
kernel scan, and surviving candidates are host-verified with ``re``. A
regex with no usable literal degrades to host ``re`` over the
header-filtered candidates.

The columnar store path of the reference (``attach_store``,
``from_store``, ``execute_columnar``, ``time_range`` filters) is not
ported yet and raises.

``engine.stats`` records how much work each stage avoided (candidate
counts, records scanned, kernel dispatches).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from re import _parser as _sre_parse  # type: ignore[attr-defined]

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.warc.record import WarcRecordType
from .cdx import CdxIndex, RandomAccessReader
from .signature import candidate_mask

__all__ = ["HeaderFilter", "PatternHit", "QueryEngine", "QueryPlan",
           "full_scan_search", "full_scan_regex", "host_positions",
           "required_literals"]

_BATCH_RECORDS = 64      # candidates per scan batch, or…
_BATCH_BYTES = 4 << 20   # …payload bytes, whichever trips first
_SCAN_BLOCK = 8192       # width-bucket granularity: few-KiB records pad
                         # ≤2×, not to the 64 KiB whole-buffer default
_EXCERPT_BYTES = 80      # hit excerpt length after the first match
_NOT_PORTED = ("the columnar store path is not ported yet (ROADMAP: "
               "columnar store and derive)")


@dataclass
class HeaderFilter:
    """Columnar header predicates (all optional, AND-combined).

    ``time_range`` — ``(lo, hi)`` epoch seconds, half-open — needs the
    derived store's timestamp column, which the CDX index does not carry.
    """

    record_type: WarcRecordType | None = None
    status: int | None = None
    mime_prefix: bytes | None = None
    url_prefix: bytes | None = None
    time_range: tuple[int, int] | None = None


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
    ``device`` (default the GPU; ``"cpu"`` only when asked)."""

    def __init__(self, index: CdxIndex, *, device="cuda") -> None:
        self.device = resolve_device(device)
        self.index = index
        self._readers: dict[int, RandomAccessReader] = {}
        self.stats = {"queries": 0, "header_candidates": 0,
                      "sig_candidates": 0, "records_scanned": 0,
                      "bytes_scanned": 0, "kernel_dispatches": 0,
                      "batches": 0}

    @classmethod
    def from_store(cls, store, **kwargs) -> "QueryEngine":
        raise NotImplementedError(_NOT_PORTED)

    def attach_store(self, store, validate: bool = True) -> None:
        raise NotImplementedError(_NOT_PORTED)

    def execute_columnar(self, plan: "QueryPlan") -> list["PatternHit"]:
        raise NotImplementedError(_NOT_PORTED)

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
            raise ValueError(
                "time_range filters read the derived store's timestamp "
                "column (the CDX index carries no WARC-Date); "
                + _NOT_PORTED)
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
        most ``_BATCH_RECORDS`` records / ``_BATCH_BYTES`` bytes.
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

        ``columnar=True`` asks for the columnar store path, which is not
        ported yet and raises.
        """
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
            if (len(batch_rows) >= _BATCH_RECORDS
                    or pending >= _BATCH_BYTES):
                hits.extend(self._scan_batch(batch_rows, batch_bufs, plan))
                batch_rows, batch_bufs, pending = [], [], 0
        if batch_rows:
            hits.extend(self._scan_batch(batch_rows, batch_bufs, plan))
        hits.sort(key=lambda h: h.index_row)
        return hits

    # -- internals -------------------------------------------------------
    def _fetch(self, row: int) -> bytes:
        sid = int(self.index.shard_id[row])
        reader = self._readers.get(sid)
        if reader is None:
            reader = self._readers[sid] = RandomAccessReader(
                self.index.shard_paths[sid], parse_http=False)
        return reader.read(int(self.index.offset[row])).content

    def make_hit(self, row: int, buf: bytes, positions: np.ndarray,
                 first_len: int) -> PatternHit:
        """Assemble one hit."""
        first = int(positions[0])
        excerpt = bytes(buf[max(0, first - 16):
                            first + first_len + _EXCERPT_BYTES])
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
                                            block=_SCAN_BLOCK,
                                            device=self.device)
            lit_positions = [np.flatnonzero(m) for m in masks]
            self.stats["kernel_dispatches"] += dispatch_count(
                [len(b) for b in bufs], _SCAN_BLOCK)
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
