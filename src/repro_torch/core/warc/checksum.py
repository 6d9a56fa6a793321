"""Record digests in WARC header notation.

WARC records carry ``WARC-Block-Digest`` / ``WARC-Payload-Digest`` headers
of the form ``sha1:<base32>`` (also ``md5:``/``sha256:`` in the wild, and
``crc32:``/``adler32:`` as cheap in-pipeline checks). SHA-1/MD5/SHA-256 run
through hashlib's C core; CRC-32 and Adler-32 through ``zlib``. The writer
uses them; verifying digests on read is not ported yet.
"""
from __future__ import annotations

import base64
import hashlib
import zlib

_HASHLIB_ALGOS = {"sha1", "md5", "sha256"}


def block_digest(data: bytes | memoryview, algo: str = "sha1") -> str:
    """Digest in WARC header notation, e.g. ``sha1:3I42H3S6...``."""
    algo = algo.lower()
    if algo in _HASHLIB_ALGOS:
        raw = hashlib.new(algo, data).digest()
        return f"{algo}:{base64.b32encode(raw).decode('ascii')}"
    if algo == "crc32":
        return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"
    if algo == "adler32":
        return f"adler32:{zlib.adler32(data) & 0xFFFFFFFF:08x}"
    raise ValueError(f"unsupported digest algorithm: {algo}")
