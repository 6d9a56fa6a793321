"""Adler-32 of ragged payload batches: the bulk digest-verification kernel."""
from .adler32 import (BLOCK, MOD, adler32_partials_batch, adler32_plain)
from .ops import adler32, adler32_batch, combine_partials
from .ref import adler32_blocked, adler32_zlib

__all__ = ["BLOCK", "MOD", "adler32", "adler32_batch", "adler32_blocked",
           "adler32_partials_batch", "adler32_plain", "adler32_zlib",
           "combine_partials"]
