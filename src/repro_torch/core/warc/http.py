"""HTTP message parsing for ``application/http`` WARC payloads.

FastWARC-style: one ``find(b"\\r\\n\\r\\n")`` to bound the header block,
one ``split(b"\\r\\n")``, lazy byte values.
"""
from __future__ import annotations

from .record import CRLF, HEADER_TERMINATOR, HttpHeaderMap

# Adversarial payloads can pack tens of thousands of tiny "a:b\r\n" lines
# into the 64 KiB header window; cap how many we ever materialize so a
# hostile record costs O(cap) header-map appends, not O(window).
_MAX_HEADER_LINES = 512


def parse_http_fast(payload: bytes | memoryview
                    ) -> tuple[HttpHeaderMap | None, int]:
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
    if not lines or not (lines[0].startswith(b"HTTP/")
                         or b" HTTP/" in lines[0]):
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
