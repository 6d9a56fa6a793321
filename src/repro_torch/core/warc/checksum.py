"""Record digests in WARC header notation.

WARC records carry ``WARC-Block-Digest`` / ``WARC-Payload-Digest`` headers
of the form ``sha1:<base32>`` (also ``md5:``/``sha256:`` in the wild, and
``crc32:``/``adler32:`` as cheap in-pipeline checks). SHA-1/MD5/SHA-256 run
through hashlib's C core on the host; CRC-32 through ``zlib.crc32``.

Adler-32 digests of many records are verified in bulk on the device
(:func:`verify_digests_bulk` through
:func:`repro_torch.kernels.adler32.adler32_batch`): CRC's bit-feedback
loop has no data-parallel form, Adler's two running sums do.
"""
from __future__ import annotations

import base64
import hashlib
import zlib

__all__ = ["adler32_reference", "block_digest", "verify_digest",
           "verify_digests_bulk"]

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


def verify_digest(data: bytes | memoryview, header_value: str) -> bool:
    """Check ``data`` against a ``algo:value`` WARC digest header."""
    algo, _, expected = header_value.partition(":")
    algo = algo.strip().lower()
    expected = expected.strip()
    if algo in _HASHLIB_ALGOS:
        raw = hashlib.new(algo, data).digest()
        if base64.b32encode(raw).decode("ascii") == expected.upper():
            return True
        # tolerate hex notation, which some writers emit instead of base32
        try:
            return bytes.fromhex(expected) == raw
        except ValueError:
            return False
    if algo in ("crc32", "adler32"):
        try:
            want = int(expected, 16)
        except ValueError:  # malformed digest value: mismatch, not a crash
            return False
        got = zlib.crc32(data) if algo == "crc32" else zlib.adler32(data)
        return (got & 0xFFFFFFFF) == want
    return False


def verify_digests_bulk(datas, header_values, *,
                        device="cuda") -> list[bool]:
    """Verify many ``algo:value`` digest headers at once, on ``device``.

    Every adler32-digested payload of the batch is checksummed by the
    batched kernel (:func:`repro_torch.kernels.adler32.adler32_batch`:
    one launch per width bucket, never one per record) and compared on
    the host. All other algorithms go through :func:`verify_digest` item
    by item.
    """
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    datas = list(datas)
    header_values = list(header_values)
    if len(datas) != len(header_values):
        raise ValueError("datas and header_values must have equal length")
    results: list[bool] = [False] * len(datas)
    adler_idx: list[int] = []
    adler_expected: list[int] = []
    for i, (data, header) in enumerate(zip(datas, header_values)):
        algo, _, expected = header.partition(":")
        if algo.strip().lower() == "adler32":
            try:
                adler_expected.append(int(expected.strip(), 16))
            except ValueError:  # malformed digest value: a mismatch
                continue
            adler_idx.append(i)
            continue
        results[i] = verify_digest(data, header)
    if adler_idx:
        from repro_torch.kernels.adler32 import adler32_batch

        got = adler32_batch([datas[i] for i in adler_idx], device=dev)
        for j, i in enumerate(adler_idx):
            results[i] = int(got[j]) == adler_expected[j]
    return results


def adler32_reference(data: bytes) -> int:
    """Pure-Python Adler-32 (oracle for the kernel tests)."""
    mod = 65521
    s1, s2 = 1, 0
    for b in data:
        s1 = (s1 + b) % mod
        s2 = (s2 + s1) % mod
    return (s2 << 16) | s1
