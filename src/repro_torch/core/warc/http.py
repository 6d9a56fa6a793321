"""HTTP message parsing for ``application/http`` WARC payloads.

Two implementations, matching the benchmark axes of the paper's Table 1
("+HTTP" rows):

* :func:`parse_http_fast` — FastWARC-style: one ``find(b"\\r\\n\\r\\n")``
  to bound the header block, one ``split(b"\\r\\n")``, lazy byte values.
* :func:`parse_http_baseline` — WARCIO-style: per-line ``readline()``-shaped
  iteration with eager ``str`` decode and regex-ish splitting.
"""
from __future__ import annotations

import re

from .record import HttpHeaderMap, HEADER_TERMINATOR, CRLF

_BASELINE_SPLIT = re.compile(r":\s*")

# Adversarial payloads can pack tens of thousands of tiny "a:b\r\n" lines
# into the 64 KiB header window; cap how many we ever materialize so a
# hostile record costs O(cap) header-map appends, not O(window).
_MAX_HEADER_LINES = 512


def parse_http_fast(payload: bytes | memoryview) -> tuple[HttpHeaderMap | None, int]:
    """Parse HTTP headers from ``payload``.

    Returns ``(headers, body_offset)``; ``headers`` is ``None`` when the
    payload does not look like an HTTP message. Values stay raw bytes.
    """
    # headers are nearly always < 4 KiB: copy the small window first and
    # only escalate to 64 KiB when the terminator isn't found in it
    if isinstance(payload, memoryview):
        view = bytes(payload[:4096])
        end = view.find(HEADER_TERMINATOR)
        if end < 0 and len(payload) > 4096:
            view = bytes(payload[:64 * 1024])
            end = view.find(HEADER_TERMINATOR)
    else:
        view = payload
        end = view.find(HEADER_TERMINATOR, 0, 64 * 1024)
    if end < 0:
        nl = view.find(b"\n\n", 0, 64 * 1024)  # tolerate LF-only messages
        if nl < 0:
            return None, 0
        head, body_off, sep = view[:nl], nl + 2, b"\n"
    else:
        head, body_off, sep = view[:end], end + 4, CRLF
    lines = head.split(sep)
    if not lines or not (lines[0].startswith(b"HTTP/") or b" HTTP/" in lines[0]):
        return None, 0
    headers = HttpHeaderMap(lines[0])
    for line in lines[1:_MAX_HEADER_LINES + 1]:
        if not line:
            continue
        if line[0] in (0x20, 0x09):  # folded continuation
            headers.append_continuation(line.strip())
            continue
        colon = line.find(b":")
        if colon < 0:
            continue
        headers.append(line[:colon].strip(), line[colon + 1:].strip())
    return headers, body_off


def parse_http_baseline(payload: bytes) -> tuple[HttpHeaderMap | None, int]:
    """WARCIO-faithful variant: eager decode, per-line regex split.

    Part of the measured baseline; deliberately mirrors
    ``warcio.statusandheaders.StatusAndHeadersParser``.
    """
    # simulate readline-oriented consumption over the payload
    off = 0
    n = len(payload)
    i = payload.find(b"\n", off)
    if i < 0:
        return None, 0
    status_line = payload[off:i].rstrip(b"\r")
    text = status_line.decode("latin-1", "replace")  # eager decode (baseline)
    if not (text.startswith("HTTP/") or " HTTP/" in text):
        return None, 0
    headers = HttpHeaderMap(status_line)
    off = i + 1
    while off < n:
        i = payload.find(b"\n", off)
        if i < 0:
            i = n - 1
        line = payload[off:i].rstrip(b"\r")
        off = i + 1
        if not line:
            break
        decoded = line.decode("latin-1", "replace")  # eager decode per line
        if decoded[0] in (" ", "\t"):
            headers.append_continuation(decoded.strip().encode("latin-1"))
            continue
        parts = _BASELINE_SPLIT.split(decoded, maxsplit=1)
        if len(parts) != 2:
            continue
        headers.append(parts[0].encode("latin-1"), parts[1].encode("latin-1"))
    return headers, off
