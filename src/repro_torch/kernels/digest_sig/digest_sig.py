"""Fused Adler-32 + n-gram-hash kernel: CUDA launch, plain PyTorch version,
launch count.

Over a padded ``(B, W + HPAD)`` byte matrix (payload left-justified,
zeros after) one sweep produces

* per ``block``-byte sub-block the Adler partials ``S_j = Σ b`` and
  ``T_j = Σ t·b`` (``t`` the offset inside the sub-block), and
* the polynomial hash of every overlapping byte n-gram,
  ``h_i = Σ_{j<n} b_{i+j}·P^{n-1-j} mod 2³²`` (``P = 0x01000193``), as
  int32 tensors holding the uint32 bit patterns.

The ``HPAD`` zero tail bounds every n-gram window (``n ≤ HPAD + 1``).
:func:`digest_sig_partials_batch` launches ``csrc/digest_sig.cu`` for a
CUDA tensor and uses :func:`digest_sig_plain` for a CPU tensor; any other
device raises. ``launches`` counts CUDA launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.bucketing import ROWGROUP_PAD

__all__ = ["BLOCK", "FNV_PRIME", "HPAD", "digest_sig_partials_batch",
           "digest_sig_plain", "launches"]

BLOCK = 2048          # Adler overflow bound: T_j < 2048·2047/2·255 < 2³¹
HPAD = ROWGROUP_PAD   # zero right-padding; bounds n − 1
FNV_PRIME = 0x01000193
_MAX_KBLOCK = 32 * 1024  # sub-block + look-ahead fit 48 KiB of shared memory

launches = 0  # CUDA launches of the kernel in this process


def _check(padded: torch.Tensor, n: int, block: int) -> int:
    """Validate the kernel's inputs; returns the payload width W."""
    if padded.dtype != torch.uint8 or padded.dim() != 2:
        raise ValueError("padded must be a 2-D uint8 tensor")
    width = padded.shape[1] - HPAD
    if block <= 0 or block % 16 or block > _MAX_KBLOCK:
        raise ValueError(f"block must be a multiple of 16 in "
                         f"[16, {_MAX_KBLOCK}], got {block}")
    if width <= 0 or width % block:
        raise ValueError(f"padded width {padded.shape[1]} must be HPAD plus "
                         f"a positive multiple of block={block}")
    if not 1 < n <= HPAD + 1:
        raise ValueError(f"need 2 <= n <= {HPAD + 1}, got {n}")
    return width


def digest_sig_plain(padded: torch.Tensor, *, n: int, block: int = BLOCK
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version in int64 arithmetic, reduced mod 2³²."""
    width = _check(padded, n, block)
    rows = padded.shape[0]
    ext = padded.to(torch.int64)
    seg = ext[:, :width].reshape(rows, width // block, block)
    iota = torch.arange(block, dtype=torch.int64, device=padded.device)
    s = seg.sum(dim=2)
    t = (seg * iota).sum(dim=2)
    h = ext[:, :width]
    for j in range(1, n):
        h = (h * FNV_PRIME + ext[:, j:j + width]) & 0xFFFFFFFF
    h = torch.where(h >= 1 << 31, h - (1 << 32), h)
    return s.to(torch.int32), t.to(torch.int32), h.to(torch.int32)


def _launch(padded: torch.Tensor, n: int, block: int, width: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    from repro_torch.kernels._build import library

    if not padded.is_contiguous() or padded.data_ptr() % 16:
        raise ValueError("padded must be contiguous and 16-byte aligned")
    rows = padded.shape[0]
    nsb = width // block
    if rows * nsb >= 1 << 31:
        raise ValueError("too many sub-blocks for one launch")
    fn = library("digest_sig").digest_sig_partials_batch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = padded.device
    s = torch.empty((rows, nsb), dtype=torch.int32, device=dev)
    t = torch.empty((rows, nsb), dtype=torch.int32, device=dev)
    h = torch.empty((rows, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(padded.data_ptr(), s.data_ptr(), t.data_ptr(), h.data_ptr(),
                 rows, width, block, n, stream)
    if err:
        raise RuntimeError(f"digest_sig kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return s, t, h


def digest_sig_partials_batch(padded: torch.Tensor, *, n: int,
                              block: int = BLOCK
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Fused per-(row, sub-block) partials over a padded byte matrix.

    ``padded`` is ``(B, W + HPAD)`` uint8 with ``W % block == 0``.
    Returns ``(S, T, H)``: two ``(B, W // block)`` int32 Adler partial
    tensors and the ``(B, W)`` int32 n-gram hash matrix, on ``padded``'s
    device. One launch sweeps the whole batch once.
    """
    width = _check(padded, n, block)
    if padded.device.type == "cpu":
        return digest_sig_plain(padded, n=n, block=block)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    return _launch(padded, n, block, width)
