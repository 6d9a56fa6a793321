"""Contiguous-array packing: the CDX column region's encode/decode.

:func:`pack_arrays` / :class:`ArrayCursor` write and read the fixed,
implicit column schema of :meth:`repro_torch.index.cdx.CdxIndex.save`
and ``load`` (the v2 byte format).
"""
from __future__ import annotations

import numpy as np

__all__ = ["ArrayCursor", "pack_arrays"]


def pack_arrays(out, arrays) -> None:
    """Write arrays back-to-back as contiguous bytes (no framing — the
    schema is the caller's contract, as in the CDX fixed column order)."""
    for arr in arrays:
        out.write(np.ascontiguousarray(arr).tobytes())


class ArrayCursor:
    """Decode arrays packed by :func:`pack_arrays` from a bytes-like.

    Zero-copy: each :meth:`take` is an ``np.frombuffer`` view advancing
    an offset.
    """

    def __init__(self, blob, pos: int = 0) -> None:
        self.blob = blob
        self.pos = pos

    def take(self, dtype, count: int, shape=None) -> np.ndarray:
        arr = np.frombuffer(self.blob, dtype, count, self.pos)
        self.pos += arr.nbytes
        return arr.reshape(shape) if shape else arr
