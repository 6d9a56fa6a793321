"""Deterministic synthetic Common-Crawl-like WARC corpus generator.

Realistic record-type mix (request/response/metadata per page + one
warcinfo per file, mirroring Common Crawl's layout), HTTP response
headers, and HTML payloads with Zipf-ish token distributions. Everything
is seeded: a :class:`CorpusSpec` and a compression give the same bytes
as the reference package's generator.
"""
from __future__ import annotations

import io
import random
import uuid
from dataclasses import dataclass

from repro_torch.core.warc.checksum import block_digest
from repro_torch.core.warc.writer import WarcWriter

__all__ = ["CorpusSpec", "generate_warc", "records_in", "write_corpus"]

_WORDS = (
    "the of and to in is was for that on as with by at from web archive "
    "crawl data page http html search index text content link site user "
    "time year service new system information large scale analytics record "
    "format library performance processing python research common format "
    "university science compute storage stream parser benchmark result "
).split()

_PATHS = ("index.html", "about", "news/2021/item", "products/view",
          "blog/post", "search?q=warc", "static/page", "docs/spec",
          "api/v1/items", "home")

_HOSTS = ("example.com", "research.edu", "webarchive.org", "news.example.net",
          "shop.example.io", "wiki.example.org")


@dataclass
class CorpusSpec:
    n_pages: int = 200
    seed: int = 0
    html_words_lo: int = 300
    html_words_hi: int = 3000
    with_requests: bool = True
    with_metadata: bool = True
    digests: bool = True


def _make_html(rng: random.Random, spec: CorpusSpec) -> bytes:
    n = rng.randint(spec.html_words_lo, spec.html_words_hi)
    # Zipf-ish: sample from a small head most of the time
    words = []
    for _ in range(n):
        if rng.random() < 0.8:
            words.append(_WORDS[rng.randrange(12)])
        else:
            words.append(_WORDS[rng.randrange(len(_WORDS))])
    body = " ".join(words)
    title = " ".join(rng.sample(_WORDS, 3))
    links = "".join(
        f'<a href="https://{rng.choice(_HOSTS)}/{rng.choice(_PATHS)}">'
        f"{rng.choice(_WORDS)}</a> " for _ in range(rng.randint(2, 8)))
    return (f"<!doctype html><html><head><title>{title}</title></head>"
            f"<body><p>{body}</p><nav>{links}</nav></body></html>"
            ).encode("utf-8")


def _http_response(rng: random.Random, html: bytes) -> bytes:
    headers = (
        f"HTTP/1.1 200 OK\r\n"
        f"Content-Type: text/html; charset=utf-8\r\n"
        f"Content-Length: {len(html)}\r\n"
        f"Server: nginx/1.{rng.randint(10, 25)}\r\n"
        f"Date: Mon, 01 Mar 2021 0{rng.randint(0, 9)}:00:00 GMT\r\n"
        f"X-Cache: {'HIT' if rng.random() < 0.5 else 'MISS'}\r\n"
        f"\r\n").encode("ascii")
    return headers + html


def _http_request(host: str, path: str) -> bytes:
    return (f"GET /{path} HTTP/1.1\r\nHost: {host}\r\n"
            f"User-Agent: repro-crawler/0.1\r\nAccept: text/html\r\n\r\n"
            ).encode("ascii")


def generate_warc(spec: CorpusSpec, compression: str = "none") -> bytes:
    """Generate one synthetic WARC file; returns the file bytes."""
    rng = random.Random(spec.seed)

    def _rid() -> str:  # deterministic record ids: corpora are reproducible
        return f"<urn:uuid:{uuid.UUID(int=rng.getrandbits(128))}>"

    _date = "2021-03-01T12:00:00Z"
    sink = io.BytesIO()
    writer = WarcWriter(sink, compression)
    writer.write_record(
        "warcinfo",
        b"software: repro-fastwarc-synth/0.1\r\n"
        b"format: WARC File Format 1.1\r\n"
        + f"isPartOf: synthetic-crawl-{spec.seed}\r\n".encode(),
        {"Content-Type": "application/warc-fields",
         "WARC-Record-ID": _rid(), "WARC-Date": _date})
    for _ in range(spec.n_pages):
        host = rng.choice(_HOSTS)
        path = rng.choice(_PATHS)
        uri = f"https://{host}/{path}"
        html = _make_html(rng, spec)
        response = _http_response(rng, html)
        common = {"WARC-Target-URI": uri, "WARC-Date": _date}
        if spec.with_requests:
            writer.write_record(
                "request", _http_request(host, path),
                {**common, "WARC-Record-ID": _rid(),
                 "Content-Type": "application/http; msgtype=request"},
                digests=spec.digests)
        writer.write_record(
            "response", response,
            {**common, "WARC-Record-ID": _rid(),
             "Content-Type": "application/http; msgtype=response",
             "WARC-Payload-Digest": block_digest(html, "sha1")},
            digests=spec.digests)
        if spec.with_metadata:
            meta = (f"fetchTimeMs: {rng.randint(20, 900)}\r\n"
                    f"charset-detected: utf-8\r\n").encode("ascii")
            writer.write_record(
                "metadata", meta,
                {**common, "WARC-Record-ID": _rid(),
                 "Content-Type": "application/warc-fields"},
                digests=spec.digests)
    return sink.getvalue()


def records_in(spec: CorpusSpec) -> int:
    """Total records a spec generates (warcinfo + per-page records)."""
    per_page = 1 + int(spec.with_requests) + int(spec.with_metadata)
    return 1 + spec.n_pages * per_page


def write_corpus(path: str, spec: CorpusSpec,
                 compression: str = "none") -> int:
    data = generate_warc(spec, compression)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
