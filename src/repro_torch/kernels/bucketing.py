"""Shared ragged-batch helpers for the byte kernels' public wrappers.

The byte kernels (``pattern_scan``, ``digest_sig``) batch ragged payload
lists into padded ``(B, W)`` matrices; ``bucket_width`` is the common
width-bucketing rule (one dispatch per bucket, repeated ragged batches
reuse a bounded set of shapes). Kept in one place so the wrappers — and
consumers that account dispatches, like the index query engine — cannot
drift apart.

Bucket boundaries are **half-step** quantized: sizes round up to
``m · 2^j`` blocks with mantissa ``m ∈ {2, 3}`` (plus the single-block
floor), i.e. the ladder runs 1, 2, 3, 4, 6, 8, 12, 16, … blocks. This
bounds per-row width waste at 1.5× while only doubling the shape ladder
of a pure power-of-two rule. The same quantizer pads *row counts*
(``quantize_count``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["ROWGROUP_PAD", "SMALL_BLOCK", "as_u8", "bucket_width",
           "check_rowgroup", "dispatch_count", "payload_width",
           "quantize_count"]

# Width-bucket granularity for payloads below one full kernel block
# (digest path: the 2048 Adler block is an overflow *bound*, not a width
# floor). Yields the sub-block half-step ladder 256, 512, 768, 1024, 1536
# under the 2048 boundary.
SMALL_BLOCK = 256

# Zero right-padding of packed row-group matrices: (B, width + ROWGROUP_PAD)
# uint8, payload left-justified, zeros after. Bounds both the digest
# kernel's n-gram reach (n − 1) and the pattern kernel's window reach
# (MAX_PATTERN − 1).
ROWGROUP_PAD = 128


def as_u8(data) -> np.ndarray:
    """View bytes-like or array input as a uint8 numpy array."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.asarray(data, np.uint8)


def check_rowgroup(matrix, lengths) -> tuple[np.ndarray, np.ndarray, int]:
    """Validate a packed row-group and its live rows' true lengths.

    ``matrix`` must be a 2-D uint8 ``(B, width + ROWGROUP_PAD)`` array
    with ``width > 0``; ``lengths`` covers its first ``1..B`` rows.
    Returns ``(matrix, lengths as int64, width)``.
    """
    mat = np.asarray(matrix)
    if mat.dtype != np.uint8 or mat.ndim != 2:
        raise ValueError("matrix must be a 2-D uint8 array")
    nrows, padded_width = mat.shape
    width = padded_width - ROWGROUP_PAD
    if width <= 0:
        raise ValueError("matrix must carry the ROWGROUP_PAD zero tail")
    lengths = np.asarray(lengths, np.int64)
    if not 0 < lengths.size <= nrows:
        raise ValueError(f"need 1 <= live rows <= {nrows}, got "
                         f"{lengths.size}")
    return mat, lengths, width


def quantize_count(n: int) -> int:
    """Smallest half-step-pow2 value ≥ ``n``: 1, 2, 3, 4, 6, 8, 12, ….

    The shared shape quantizer for both bucket widths (in blocks) and
    padded row counts: worst-case padding 1.5×.
    """
    if n <= 1:
        return 1
    pow2 = 1 << (max(n, 1) - 1).bit_length()   # next power of two ≥ n
    half = (pow2 // 4) * 3                     # the 3·2^j step just below it
    return half if half >= n else pow2


def bucket_width(size: int, block: int) -> int:
    """Block-multiple width bucket: half-step quantized block count."""
    nblocks = max((size + block - 1) // block, 1)
    return block * quantize_count(nblocks)


def payload_width(size: int, block: int, small: int | None = SMALL_BLOCK
                  ) -> int:
    """Width bucket with sub-block granularity below one block.

    The digest bucketing rule: payloads that fit in a single kernel block
    take finer ``small``-granular buckets (the whole row is one block, so
    nothing forces the full-block floor). Larger payloads use the
    block-multiple ladder.
    """
    if small and size <= block:
        return min(bucket_width(size, small), block)
    return bucket_width(size, block)


def dispatch_count(sizes, block: int) -> int:
    """Kernel dispatches a batch of these payload sizes costs: one per
    distinct width bucket (what the batched wrappers actually issue)."""
    return len({bucket_width(int(s), block) for s in sizes})
