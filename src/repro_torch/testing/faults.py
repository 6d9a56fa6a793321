"""Deterministic fault injection for WARC robustness tests.

Two families of injectors:

* **Byte corruption** — :func:`corrupt_warc` damages a seeded sample of
  members/records in a WARC image and returns the exact damaged spans,
  so a test can predict which records the tolerant parser must
  quarantine and assert the survivors byte-identical to a clean oracle.
* **Process faults** — :func:`arm_worker_kill` / :func:`arm_decoder_stall`
  arm the in-tree hooks (``REPRO_TORCH_FAULT_WORKER_KILL``, read by
  :func:`repro_torch.core.parallel._maybe_worker_kill`;
  ``REPRO_TORCH_FAULT_DECODER_STALL``, read by the readahead decoder
  child) with a fresh one-shot latch file, so exactly one child process
  dies or stalls per armed context no matter how many children inherit
  the environment. The pool captures its spec when it starts a worker,
  so arm before building the pool.

Everything is deterministic under a fixed ``seed``: same input bytes →
same damaged spans → same surviving record set.
"""
from __future__ import annotations

import contextlib
import os
import random
import uuid
import zlib
from dataclasses import dataclass

from repro_torch.core.warc import lz4 as _lz4
from repro_torch.core.warc.streams import detect_compression

__all__ = [
    "DamagedSpan",
    "arm_decoder_stall",
    "arm_worker_kill",
    "corrupt_warc",
    "member_spans",
]

# Junk that can never resynchronize: contains no WARC record magic, no
# gzip member magic (1f 8b 08), and no LZ4 frame magic (04 22 4d 18).
_JUNK = b"\xde\xad\xbe\xef\xfe\xed\xfa\xce"


@dataclass(frozen=True)
class DamagedSpan:
    """One damaged member/record: ``[start, end)`` in the *original* image."""

    index: int        # member ordinal in the clean image
    start: int        # absolute byte offset of the member/record
    end: int          # absolute end (next member's start)
    kind: str         # "garble" | "flip" | "truncate"


def member_spans(data: bytes) -> list[tuple[int, int]]:
    """Exact ``[start, end)`` spans of every member/record in ``data``.

    Spans are recovered by *decoding*, not by magic scanning, so
    compressed payload bytes that happen to contain a magic string can't
    produce phantom boundaries: gzip members via ``zlib`` unused-data
    walking, LZ4 frames via the in-tree frame parser, uncompressed
    records via the record parser's framing walk.
    """
    kind = detect_compression(data[:8])
    spans: list[tuple[int, int]] = []
    if kind == "gzip":
        pos = 0
        while pos < len(data):
            d = zlib.decompressobj(wbits=31)
            d.decompress(data[pos:])
            end = len(data) - len(d.unused_data)
            spans.append((pos, end))
            pos = end
    elif kind == "lz4":
        pos = 0
        while pos < len(data):
            end = _lz4.skip_frame(data, pos)
            spans.append((pos, end))
            pos = end
    elif kind == "none":
        from repro_torch.core.warc.fastwarc import FastWARCIterator

        offsets = [r.stream_offset
                   for r in FastWARCIterator(data, parse_http=False)]
        for i, off in enumerate(offsets):
            end = offsets[i + 1] if i + 1 < len(offsets) else len(data)
            spans.append((off, end))
    else:  # pragma: no cover - zstd shards aren't member-addressable
        raise ValueError(f"unsupported compression for fault injection: "
                         f"{kind}")
    return spans


def _damage(buf: bytearray, a: int, b: int, kind: str, fmt: str) -> None:
    if kind == "garble":
        # Hit the spot each decoder validates *first*, so the error is
        # raised at the member boundary and the resync span is exact:
        # gzip CM byte (offset 2), LZ4 frame descriptor (offset 4, fails
        # the header checksum), uncompressed record magic.
        off = a + (2 if fmt == "gzip" else 4 if fmt == "lz4" else 0)
        n = min(len(_JUNK), b - off)
        buf[off:off + n] = _JUNK[:n]
    elif kind == "flip":
        # One bit-flipped byte mid-member: compressed formats catch it
        # via CRC/content checks; uncompressed payload flips may pass
        # silently (WARC framing intact) — realistic, and why the chaos
        # test uses "garble" when it needs exact survivor accounting.
        mid = a + (b - a) // 2
        buf[mid] ^= 0xFF
    else:
        raise ValueError(f"unknown damage kind: {kind}")


def corrupt_warc(data: bytes, *, fraction: float = 0.01, seed: int = 0,
                 mode: str = "garble") -> tuple[bytes, list[DamagedSpan]]:
    """Damage a seeded sample of members in a WARC image.

    ``mode="garble"`` overwrites each selected member's format header
    with junk (deterministically detectable at the member boundary);
    ``mode="flip"`` flips one byte mid-member; ``mode="truncate"``
    ignores ``fraction`` and cuts the image mid-way through its final
    member. Returns ``(damaged_bytes, spans)`` where ``spans`` lists the
    exact damaged ranges in the original image — the records a tolerant
    reader is expected to lose, in order.
    """
    spans = member_spans(data)
    if not spans:
        return data, []
    if mode == "truncate":
        a, b = spans[-1]
        cut = a + max(1, (b - a) // 2)
        return data[:cut], [DamagedSpan(len(spans) - 1, a, b, "truncate")]
    if mode not in ("garble", "flip"):
        raise ValueError(f"unknown corruption mode: {mode}")
    fmt = detect_compression(data[:8])
    k = min(len(spans), max(1, round(fraction * len(spans))))
    picks = sorted(random.Random(seed).sample(range(len(spans)), k))
    buf = bytearray(data)
    out: list[DamagedSpan] = []
    for i in picks:
        a, b = spans[i]
        _damage(buf, a, b, mode, fmt)
        out.append(DamagedSpan(i, a, b, mode))
    return bytes(buf), out


# ---------------------------------------------------------------------------
# process-fault arming (env + one-shot latch)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _armed(var: str, latch_dir: str, spec_tail: str):
    latch = os.path.join(str(latch_dir), f"fault-latch-{uuid.uuid4().hex}")
    prev = os.environ.get(var)
    os.environ[var] = f"{latch}:{spec_tail}"
    # armed faults are themselves counted, so a merged snapshot from a
    # fault-injection run says which faults were live
    from repro_torch import obs

    obs.registry().counter_add(f"faults.armed.{var}")
    try:
        yield latch
    finally:
        if prev is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = prev
        with contextlib.suppress(OSError):
            os.unlink(latch)


def arm_worker_kill(latch_dir: str, nth: int = 1):
    """Arm ``REPRO_TORCH_FAULT_WORKER_KILL``: the first pool worker
    (across the whole process tree sharing this environment) to reach
    its ``nth`` produced result wins the latch and hard-exits
    (``os._exit``) before sending it. Yields the latch path; the latch
    file existing afterwards means the fault actually fired.
    """
    from repro_torch.core.parallel import FAULT_WORKER_KILL_ENV

    return _armed(FAULT_WORKER_KILL_ENV, latch_dir, str(int(nth)))


def arm_decoder_stall(latch_dir: str, member: int = 1,
                      seconds: float = 30.0):
    """Arm ``REPRO_TORCH_FAULT_DECODER_STALL``: the first readahead
    decoder child to decode its ``member``-th member wins the latch and
    sleeps ``seconds`` — long past the supervisor's stall timeout
    (``REPRO_TORCH_DECODER_STALL_S``), so the parent must detect the
    hang, kill the child, and resume. Yields the latch path.
    """
    from repro_torch.core.warc.streams import FAULT_DECODER_STALL_ENV

    return _armed(FAULT_DECODER_STALL_ENV, latch_dir,
                  f"{int(member)}:{float(seconds)}")
