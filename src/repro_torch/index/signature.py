"""Per-record n-gram signatures: the query engine's decompress-avoidance
pre-filter.

At index time every record's content block is folded into a small
Bloom-style bitmap: each overlapping byte n-gram is hashed to ``k`` bit
positions which are set in an ``m``-bit signature. At query time a
pattern of length ≥ n is folded the same way; any record whose signature
is missing one of the pattern's bits **cannot** contain the pattern
(every substring occurrence implies all of its n-grams occur), so the
record is never even decompressed. False positives only cost a wasted
decompress + scan — correctness never depends on the filter.

Signatures are built with one rolling-hash sweep per record (numpy, no
per-byte Python), and candidate selection is a single ``(N, words)``
bitwise-AND/compare over the whole index column. The fused build path
computes the hashes on the device (:mod:`repro_torch.kernels.digest_sig`)
and folds them with the same :func:`positions_from_hashes` /
:func:`fold_positions_rows` arithmetic as here.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.bucketing import as_u8

__all__ = [
    "SIG_BITS",
    "SIG_HASHES",
    "SIG_NGRAM",
    "SIG_WORDS",
    "candidate_mask",
    "fold_positions_rows",
    "pattern_bits",
    "positions_from_hashes",
    "signature_of",
]

SIG_BITS = 4096     # bitmap size m (bits): 512 B per record. A few hundred
                    # distinct n-grams per few-KiB record keeps fill ~15 %,
                    # so a 10-byte pattern's ~14 required bits reject
                    # non-matching records with high probability.
SIG_WORDS = SIG_BITS // 64
SIG_NGRAM = 4       # n-gram length; patterns shorter than this skip the filter
SIG_HASHES = 2      # k bit positions per n-gram (Kirsch–Mitzenmacher)

_FNV_PRIME = np.uint32(0x01000193)
_MIX = np.uint32(0x9E3779B1)


def _ngram_hashes(buf: np.ndarray, n: int) -> np.ndarray:
    """uint32 polynomial hash of every overlapping n-gram (one sweep)."""
    m = buf.size - n + 1
    h = np.zeros(m, dtype=np.uint32)
    for j in range(n):  # unrolled over the (tiny, static) n-gram length
        h = h * _FNV_PRIME + buf[j:j + m].astype(np.uint32)
    return h


def _fold(positions: np.ndarray, bits: int) -> np.ndarray:
    sig = np.zeros(bits // 64, dtype=np.uint64)
    words = (positions >> np.uint32(6)).astype(np.intp)
    shifts = (positions & np.uint32(63)).astype(np.uint64)
    np.bitwise_or.at(sig, words, np.uint64(1) << shifts)
    return sig


def positions_from_hashes(h: np.ndarray, bits: int, k: int) -> np.ndarray:
    """``(k, …)`` bit positions from uint32 n-gram hashes (double hashing).

    Vectorized over any hash-array shape; shared by the fused
    ``digest_signature_batch`` wrapper and the host reference so both
    derive bit positions from identical arithmetic.
    """
    h = h.astype(np.uint32, copy=False)
    h2 = (h ^ (h >> np.uint32(15))) * _MIX
    pow2 = bits & (bits - 1) == 0  # power-of-two: mask beats modulo
    out = np.empty((k,) + h.shape, np.uint32)
    acc = h
    for j in range(k):  # incremental: k+1 passes, no (k, m) temporaries
        if j == 1:
            acc = h + h2
        elif j > 1:
            acc += h2
        out[j] = acc & np.uint32(bits - 1) if pow2 else acc % np.uint32(bits)
    return out


def fold_positions_rows(n_rows: int, row_ids: np.ndarray,
                        positions: np.ndarray, bits: int) -> np.ndarray:
    """Fold flat ``(row, bit-position)`` pairs into ``(n_rows, bits//64)``
    uint64 signatures — layout-identical to :func:`_fold`, built via one
    flat boolean scatter + ``packbits``.

    ``positions`` may be ``(m,)`` or ``(k, m)`` (one plane per hash,
    scattered plane by plane); ``row_ids`` is the matching ``(m,)`` row
    index."""
    bitmap = np.zeros(n_rows * bits, np.uint8)
    if positions.size:
        base = row_ids.astype(np.int64, copy=False) * bits
        planes = positions if positions.ndim == 2 else positions[None, :]
        for plane in planes:
            bitmap[base + plane] = 1
    packed = np.packbits(bitmap.reshape(n_rows, bits), axis=1,
                         bitorder="little")
    return packed.view(np.uint64)


def signature_of(data, *, bits: int = SIG_BITS, n: int = SIG_NGRAM,
                 k: int = SIG_HASHES) -> np.ndarray:
    """``(bits // 64,)`` uint64 signature of one record's content bytes."""
    buf = as_u8(data)
    if buf.size < n:
        return np.zeros(bits // 64, dtype=np.uint64)
    return _fold(positions_from_hashes(_ngram_hashes(buf, n), bits,
                                       k).ravel(), bits)


def pattern_bits(pattern, *, bits: int = SIG_BITS, n: int = SIG_NGRAM,
                 k: int = SIG_HASHES) -> np.ndarray | None:
    """Required-bits mask for a query pattern, or ``None`` when the
    pattern is shorter than the n-gram length (filter inapplicable)."""
    pat = as_u8(pattern)
    if pat.size < n:
        return None
    return _fold(positions_from_hashes(_ngram_hashes(pat, n), bits,
                                       k).ravel(), bits)


def candidate_mask(signatures: np.ndarray, pattern, *, n: int = SIG_NGRAM,
                   k: int = SIG_HASHES) -> np.ndarray:
    """Boolean ``(N,)`` mask: which rows of a ``(N, words)`` signature
    column *may* contain ``pattern`` (exact for "cannot contain")."""
    required = pattern_bits(pattern, bits=signatures.shape[1] * 64, n=n, k=k)
    if required is None:  # short pattern: every record is a candidate
        return np.ones(signatures.shape[0], dtype=bool)
    return ((signatures & required[None, :]) == required[None, :]).all(axis=1)
