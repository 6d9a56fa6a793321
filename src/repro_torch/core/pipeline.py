"""Streaming analytics pipeline: WARC bytes → clean text documents.

The deployment context the paper targets (§Introduction: "web search and
other large-scale web data analytics"): pull response records out of
archive shards, extract payload text, and hand documents downstream (the
LM tokenizer/packer in :mod:`repro_torch.data`). Stages::

    shard file → FastWARCIterator(record_types=response, lazy HTTP)
               → status/content-type gate → HTML → text extraction

A copy of the reference's ``repro.core.pipeline`` on the port's WARC
core; all host code (the web-graph map runs on
:func:`repro_torch.core.parallel.map_shards`).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.core.warc import FastWARCIterator, WarcRecordType

__all__ = ["Document", "extract_links", "host_of", "html_to_text",
           "iter_documents", "merge_web_graphs", "web_graph_from_warc",
           "web_graph_from_warcs"]

_SCRIPT_RE = re.compile(rb"<(script|style)\b.*?</\1\s*>", re.S | re.I)
_TAG_RE = re.compile(rb"<[^>]*>")
_WS_RE = re.compile(rb"\s+")
_ENTITIES = {b"&amp;": b"&", b"&lt;": b"<", b"&gt;": b">",
             b"&quot;": b'"', b"&#39;": b"'", b"&nbsp;": b" "}


def html_to_text(html: bytes | memoryview) -> bytes:
    """Cheap, allocation-light HTML→text (analytics-grade, not a browser).

    Accepts a borrowed ``memoryview`` directly (``re`` scans any
    bytes-like buffer): the parse path feeds ``record.payload_view()``
    straight in.
    """
    text = _SCRIPT_RE.sub(b" ", html)
    text = _TAG_RE.sub(b" ", text)
    for ent, rep in _ENTITIES.items():
        if ent in text:
            text = text.replace(ent, rep)
    return _WS_RE.sub(b" ", text).strip()


@dataclass
class Document:
    uri: str | None
    text: bytes
    record_offset: int


def iter_documents(source, *, min_length: int = 64,
                   status_ok_only: bool = True,
                   readahead: bool | None = None,
                   tolerant: bool = False) -> Iterator[Document]:
    """Yield text documents from one WARC file (path, bytes, or fileobj).

    ``readahead`` is forwarded to :class:`FastWARCIterator`. The iterator
    is closed on generator teardown, so an abandoned consumer (the token
    loader stopping mid-shard) joins the decoder and releases the
    shard's fd. ``tolerant`` recovers from damaged records instead of
    aborting the shard (the skipped ranges land in the iterator's error
    ledger).
    """
    it = FastWARCIterator(source, record_types=WarcRecordType.response,
                          parse_http=True, readahead=readahead,
                          tolerant=tolerant)
    try:
        for record in it:
            http = record.http_headers
            if http is None:
                continue
            if status_ok_only and http.status_code != 200:
                continue
            ctype = http.get_bytes(b"Content-Type", b"")
            if not ctype.startswith(b"text/html"):
                continue
            # borrow-only: only the extracted text is materialized
            text = html_to_text(record.payload_view())
            if len(text) < min_length:
                continue
            yield Document(record.target_uri, text, record.stream_offset)
    finally:
        it.close()


_HREF_RE = re.compile(rb"""href\s*=\s*["']?(https?://[^"'\s>]+)""", re.I)


def extract_links(html: bytes | memoryview) -> list[bytes]:
    """Outgoing absolute links of a page (web-graph edge extraction)."""
    return [m.group(1) for m in _HREF_RE.finditer(html)]


def host_of(uri: bytes | str) -> str:
    s = (uri.decode("utf-8", "replace")
         if isinstance(uri, (bytes, memoryview)) else uri)
    rest = s.split("://", 1)[-1]
    return rest.split("/", 1)[0].lower()


def web_graph_from_warc(source, *, min_length: int = 0) -> dict:
    """Host-level web graph from a WARC file's response records:
    ``{"hosts": [str], "edge_src": int32 array, "edge_dst": int32
    array}`` with an edge page host → link host for every link."""
    host_ids: dict[str, int] = {}
    src_list: list[int] = []
    dst_list: list[int] = []

    def hid(h: str) -> int:
        if h not in host_ids:
            host_ids[h] = len(host_ids)
        return host_ids[h]

    it = FastWARCIterator(source, record_types=WarcRecordType.response,
                          parse_http=True)
    try:
        for record in it:
            if record.http_headers is None or record.target_uri is None:
                continue
            page_host = hid(host_of(record.target_uri))
            for link in extract_links(record.payload_view()):
                src_list.append(page_host)
                dst_list.append(hid(host_of(link)))
    finally:
        it.close()
    return {"hosts": list(host_ids),
            "edge_src": np.asarray(src_list, np.int32),
            "edge_dst": np.asarray(dst_list, np.int32)}


def merge_web_graphs(partials: list[dict]) -> dict:
    """Reduce per-shard partial graphs into one host-level graph.

    Host ids are shard-local (numbered by first appearance), so edges are
    remapped through a global host table before concatenation;
    first-appearance order across the partial list keeps it
    deterministic.
    """
    host_ids: dict[str, int] = {}
    src_parts: list[np.ndarray] = []
    dst_parts: list[np.ndarray] = []
    for g in partials:
        remap = np.empty(len(g["hosts"]), np.int32)
        for local, host in enumerate(g["hosts"]):
            if host not in host_ids:
                host_ids[host] = len(host_ids)
            remap[local] = host_ids[host]
        if g["edge_src"].size:
            src_parts.append(remap[g["edge_src"]])
            dst_parts.append(remap[g["edge_dst"]])

    def cat(parts):
        return np.concatenate(parts) if parts else np.empty(0, np.int32)

    return {"hosts": list(host_ids),
            "edge_src": cat(src_parts).astype(np.int32),
            "edge_dst": cat(dst_parts).astype(np.int32)}


def _web_graph_partial(source) -> dict:
    # module-level so the process pool can pickle it
    return web_graph_from_warc(source)


def web_graph_from_warcs(sources, *, workers: int = 0) -> dict:
    """Host-level web graph over many shards (map-reduce form):
    ``workers > 0`` builds the per-shard partials in the process pool,
    ``workers=0`` serially; both give the same graph."""
    from repro_torch.core.parallel import map_shards

    partials = map_shards(_web_graph_partial, list(sources), workers=workers)
    return merge_web_graphs(partials)
