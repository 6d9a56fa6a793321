"""Host reference for the fused digest+signature sweep (kernel oracle)."""
from __future__ import annotations

import zlib

import numpy as np


def digest_signature_reference(payloads, *, bits: int | None = None,
                               n: int | None = None, k: int | None = None
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Two-pass host computation: ``zlib.adler32`` + ``signature_of``."""
    from repro_torch.index.signature import (SIG_BITS, SIG_HASHES, SIG_NGRAM,
                                             signature_of)

    bits = SIG_BITS if bits is None else bits
    n = SIG_NGRAM if n is None else n
    k = SIG_HASHES if k is None else k
    digests = np.asarray(
        [zlib.adler32(p) & 0xFFFFFFFF for p in payloads], np.uint32)
    sigs = (np.stack([signature_of(p, bits=bits, n=n, k=k)
                      for p in payloads])
            if len(payloads) else np.empty((0, bits // 64), np.uint64))
    return digests, sigs
