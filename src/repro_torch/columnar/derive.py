"""Derivation pipeline: parse a WARC corpus once → columnar shards.

``derive()`` sweeps every source shard exactly once with the zero-copy
parser (gzip members inflate on a decoder thread ahead of the parse),
and everything a query will ever touch comes out the other side as
:mod:`repro_torch.columnar.store` columns —

* per-shard extraction: stream offsets, content lengths, record types,
  HTTP statuses, WARC-Date timestamps, URI/MIME heaps, and the raw
  content blocks concatenated into one buffer;
* packing: a global :func:`~repro_torch.columnar.store.pack_plan` over
  the merged lengths cuts half-step width-bucketed row-groups; each
  matrix is assembled once, streamed into the payload blob, and swept
  once on the device by the fused row-group kernel
  (:func:`repro_torch.kernels.digest_sig.digest_signature_rowgroup`) for
  the digest + signature columns — bit-identical to a CDX build of the
  same corpus.

The ``.repcol`` file is byte-identical to the reference package's
derive of the same corpus.
"""
from __future__ import annotations

import calendar
import time

import numpy as np

from repro_torch.core.warc.fastwarc import FastWARCIterator
from repro_torch.core.warc.streams import detect_compression
from repro_torch.index.signature import SIG_BITS, SIG_HASHES, SIG_NGRAM
from repro_torch.kernels.bucketing import ROWGROUP_PAD
from .codec import ColumnWriter
from .store import FORMAT, STORE_VERSION, ColumnStore, pack_plan

__all__ = ["derive", "parse_warc_date"]

_DATE_FMT = "%Y-%m-%dT%H:%M:%SZ"
_BLOCK = 2048  # digest kernel Adler block (persisted in store meta)


def parse_warc_date(raw: bytes | None) -> int:
    """WARC-Date → epoch seconds (uint64 column value); 0 if unparsable.

    Zero is the documented "no timestamp" sentinel, not 1970-01-01T00:00:00
    — a real record carrying exactly the epoch would collide, which the
    synthetic and Common-Crawl corpora cannot produce.
    """
    if not raw:
        return 0
    try:
        return max(0, calendar.timegm(
            time.strptime(raw.decode("ascii").strip(), _DATE_FMT)))
    except (ValueError, UnicodeDecodeError):
        return 0


def _extract_shard(path: str) -> dict:
    """Single sweep of one shard → column partial.

    Same iterator, per-record fields and row order as the CDX build's
    sweep, but carries the payload bytes out instead of digesting them in
    place. Content is appended to one buffer immediately, so the borrowed
    arena views never outlive the loop iteration.
    """
    with open(path, "rb") as f:
        kind = detect_compression(f.read(8))
    offsets: list[int] = []
    rtypes: list[int] = []
    statuses: list[int] = []
    stamps: list[int] = []
    payload = bytearray()
    pay_off = [0]
    uri_parts: list[bytes] = []
    mime_parts: list[bytes] = []
    uri_off = [0]
    mime_off = [0]
    it = FastWARCIterator(path, parse_http=True)
    try:
        for record in it:
            offsets.append(record.stream_offset)
            payload += record.content_view()
            pay_off.append(len(payload))
            rtypes.append(int(record.record_type))
            http = record.http_headers
            status = (http.status_code if http is not None
                      and http.status_code is not None else -1)
            statuses.append(status if 0 <= status <= 0x7FFF else -1)
            stamps.append(parse_warc_date(
                record.header_bytes(b"WARC-Date:")))
            uri = record.header_bytes(b"WARC-Target-URI:") or b""
            mime = (http.get_bytes(b"Content-Type", b"") if http is not None
                    else record.header_bytes(b"Content-Type:") or b"")
            uri_parts.append(uri)
            mime_parts.append(mime)
            uri_off.append(uri_off[-1] + len(uri))
            mime_off.append(mime_off[-1] + len(mime))
    finally:
        it.close()  # a failed sweep must still join the decoder thread
    return {
        "path": path, "kind": kind,
        "offsets": np.asarray(offsets, np.uint64),
        "rtypes": np.asarray(rtypes, np.uint16),
        "statuses": np.asarray(statuses, np.int16),
        "timestamps": np.asarray(stamps, np.uint64),
        "payload": bytes(payload),
        "pay_off": np.asarray(pay_off, np.uint64),
        "uri_heap": b"".join(uri_parts),
        "uri_off": np.asarray(uri_off, np.uint64),
        "mime_heap": b"".join(mime_parts),
        "mime_off": np.asarray(mime_off, np.uint64),
    }


def derive(paths, out_path: str, *, workers: int = 0,
           sig_bits: int = SIG_BITS, sig_ngram: int = SIG_NGRAM,
           sig_hashes: int = SIG_HASHES, tolerant: bool = False,
           supervise: bool = False, device="cuda") -> ColumnStore:
    """Derive columnar shards from a WARC corpus; returns the opened store.

    One parser sweep per source shard, in shard order (record rows match
    a CDX build of the same corpus 1:1), then one fused kernel launch on
    ``device`` per packed row-group. Stage timings are published to the
    process obs registry as ``derive.stage.{parse,digest_sig,
    pack_write}_us`` beside ``derive.records`` / ``derive.payload_bytes``
    / ``derive.rowgroups``.

    The sweep is serial: ``workers > 0`` (the process pool) and
    ``tolerant`` / ``supervise`` (recovering parser, supervised pool)
    raise ``NotImplementedError``. LZ4 and zstd shards raise
    ``NotImplementedError`` from the parser. A signature geometry the
    kernel does not cover raises ``ValueError``.
    """
    from repro_torch import obs
    from repro_torch._device import resolve_device
    from repro_torch.kernels.digest_sig.ops import (_sig_geometry,
                                                    digest_signature_rowgroup)

    if workers:
        raise NotImplementedError("derive(workers>0) needs the process pool, "
                                  "which is not ported yet (ROADMAP: the "
                                  "process pool)")
    if tolerant or supervise:
        raise NotImplementedError("tolerant/supervised derive is not ported "
                                  "yet (ROADMAP: the process pool, tolerant "
                                  "parsing)")
    _sig_geometry(sig_bits, sig_ngram, sig_hashes)
    dev = resolve_device(device)
    reg = obs.registry()
    paths = [str(p) for p in paths]
    t0 = time.perf_counter()
    parts = [_extract_shard(p) for p in paths]
    t_parse = time.perf_counter()
    if not parts:
        raise ValueError("nothing to derive")
    shard_paths = [p["path"] for p in parts]
    shard_kinds = [p["kind"] for p in parts]

    # merge in shard order: row r of the store is row r of a CDX build
    shard_id = np.concatenate(
        [np.full(p["offsets"].size, sid, np.uint32)
         for sid, p in enumerate(parts)])
    offset = np.concatenate([p["offsets"] for p in parts])
    rtype = np.concatenate([p["rtypes"] for p in parts])
    status = np.concatenate([p["statuses"] for p in parts])
    timestamp = np.concatenate([p["timestamps"] for p in parts])
    uri_off = [np.zeros(1, np.uint64)]
    mime_off = [np.zeros(1, np.uint64)]
    uri_base = mime_base = 0
    views: list[memoryview] = []  # per-record payload slices, row order
    lengths_l: list[np.ndarray] = []
    for p in parts:
        uri_off.append(p["uri_off"][1:] + np.uint64(uri_base))
        mime_off.append(p["mime_off"][1:] + np.uint64(mime_base))
        uri_base += len(p["uri_heap"])
        mime_base += len(p["mime_heap"])
        mv = memoryview(p["payload"])
        po = p["pay_off"]
        views.extend(mv[int(po[i]):int(po[i + 1])]
                     for i in range(po.size - 1))
        lengths_l.append(np.diff(po).astype(np.uint64))
    length = np.concatenate(lengths_l)
    n = int(length.size)
    plan = pack_plan(length, block=_BLOCK)

    digest = np.zeros(n, np.uint32)
    signatures = np.zeros((n, sig_bits // 64), np.uint64)
    rg_id = np.zeros(n, np.uint32)
    rg_row = np.zeros(n, np.uint32)
    rg_width = np.asarray([g.width for g in plan], np.uint64)
    rg_rows = np.asarray([g.rows.size for g in plan], np.uint64)
    rg_padded = np.asarray([g.padded_rows for g in plan], np.uint64)
    rg_byte_off = np.zeros(len(plan), np.uint64)
    rg_order = (np.concatenate([g.rows for g in plan]).astype(np.uint64)
                if plan else np.empty(0, np.uint64))

    t_sig = 0.0
    # leaving the block by an exception closes the file without a TOC: the
    # partial file never opens as a store
    with ColumnWriter(out_path, meta={
            "format": FORMAT, "store_version": STORE_VERSION,
            "sig_bits": sig_bits, "sig_ngram": sig_ngram,
            "sig_hashes": sig_hashes, "block": _BLOCK,
            "rowgroup_pad": ROWGROUP_PAD,
            "shard_paths": shard_paths, "shard_kinds": shard_kinds,
            "n_records": n}) as writer:
        # payload first, streamed group-by-group: one transient matrix in
        # RAM at a time, and the same matrix feeds the fused sweep —
        # packing cost is paid exactly once
        writer.begin_blob("payload")
        for g, spec in enumerate(plan):
            mat = np.zeros((spec.padded_rows, spec.width + ROWGROUP_PAD),
                           np.uint8)
            for row, rec in enumerate(spec.rows):
                buf = views[rec]
                mat[row, :len(buf)] = np.frombuffer(buf, np.uint8)
            rg_byte_off[g] = writer.append(mat)
            rg_id[spec.rows] = g
            rg_row[spec.rows] = np.arange(spec.rows.size, dtype=np.uint32)
            ts = time.perf_counter()
            d, s = digest_signature_rowgroup(
                mat, length[spec.rows].astype(np.int64), bits=sig_bits,
                n=sig_ngram, k=sig_hashes, block=min(_BLOCK, spec.width),
                device=dev)
            t_sig += time.perf_counter() - ts
            digest[spec.rows] = d
            signatures[spec.rows] = s
        writer.end_blob()
        for name, arr in (
                ("shard_id", shard_id), ("offset", offset),
                ("length", length), ("rtype", rtype), ("status", status),
                ("timestamp", timestamp), ("digest", digest),
                ("signatures", signatures), ("rg_id", rg_id),
                ("rg_row", rg_row),
                ("uri_off", np.concatenate(uri_off)),
                ("mime_off", np.concatenate(mime_off)),
                ("rg_width", rg_width), ("rg_rows", rg_rows),
                ("rg_padded", rg_padded), ("rg_byte_off", rg_byte_off),
                ("rg_order", rg_order)):
            writer.add_array(name, arr)
        writer.add_blob("uri_heap", b"".join(p["uri_heap"] for p in parts))
        writer.add_blob("mime_heap", b"".join(p["mime_heap"] for p in parts))
    t_end = time.perf_counter()
    reg.counter_add("derive.records", n)
    reg.counter_add("derive.payload_bytes", int(length.sum()))
    reg.counter_add("derive.rowgroups", len(plan))
    reg.counter_add("derive.stage.parse_us", int((t_parse - t0) * 1e6))
    reg.counter_add("derive.stage.digest_sig_us", int(t_sig * 1e6))
    reg.counter_add("derive.stage.pack_write_us",
                    int((t_end - t_parse - t_sig) * 1e6))
    return ColumnStore(out_path)
