"""Fused Adler-32 + n-gram-signature batch kernel.

One batched CUDA sweep produces both per-record CDX byte columns — the
content digest and the query pre-filter signature — so index
construction reads each payload byte once.
"""
from .digest_sig import (BLOCK, FNV_PRIME, HPAD, digest_sig_partials_batch,
                         digest_sig_plain)
from .ops import digest_signature_batch, digest_signature_rowgroup
from .ref import digest_signature_reference

__all__ = [
    "BLOCK",
    "FNV_PRIME",
    "HPAD",
    "digest_sig_partials_batch",
    "digest_sig_plain",
    "digest_signature_batch",
    "digest_signature_rowgroup",
    "digest_signature_reference",
]
