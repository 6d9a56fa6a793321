"""Pattern-scan kernel: CUDA launch, plain PyTorch version, launch count.

For a pattern ``p`` of length P ≤ 16 the match mask of a padded byte
matrix is ``mask[r, i] = AND_{j<P} buf[r, i + j] == p[j]``. Rows are
packed as ``(B, W + MAX_PATTERN)`` with a zero tail, so every window
starting in a row is in bounds and no halo input is needed (the Pallas
kernel's halo existed only because its BlockSpecs could not overlap).

:func:`pattern_scan_batch` launches ``csrc/pattern_scan.cu`` for a CUDA
tensor and uses :func:`pattern_scan_plain` for a CPU tensor; any other
device raises. ``launches`` counts CUDA launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["DEFAULT_BLOCK", "MAX_PATTERN", "launches", "pattern_scan_batch",
           "pattern_scan_plain"]

DEFAULT_BLOCK = 64 * 1024  # width-bucket granularity of whole-buffer scans
MAX_PATTERN = 16           # longest pattern; also each row's zero tail

launches = 0  # CUDA launches of the kernel in this process


def _check(padded: torch.Tensor, pattern: np.ndarray, pat_len: int) -> int:
    """Validate the kernel's inputs; returns the scanned width W."""
    if padded.dtype != torch.uint8 or padded.dim() != 2:
        raise ValueError("padded must be a 2-D uint8 tensor")
    width = padded.shape[1] - MAX_PATTERN
    if width <= 0 or width % 16:
        raise ValueError(f"padded width {padded.shape[1]} must be "
                         f"{MAX_PATTERN} plus a positive multiple of 16")
    if pattern.dtype != np.uint8 or pattern.shape != (MAX_PATTERN,):
        raise ValueError(f"pattern must be a ({MAX_PATTERN},) uint8 array")
    if not 0 < pat_len <= MAX_PATTERN:
        raise ValueError(f"pat_len must be in [1, {MAX_PATTERN}]")
    return width


def pattern_scan_plain(padded: torch.Tensor, pattern: np.ndarray,
                       pat_len: int) -> torch.Tensor:
    """Plain PyTorch version: P shifted compares over the whole matrix."""
    width = _check(padded, pattern, pat_len)
    acc = padded[:, :width] == int(pattern[0])
    for j in range(1, pat_len):
        acc &= padded[:, j:j + width] == int(pattern[j])
    return acc.to(torch.uint8)


def _launch(padded: torch.Tensor, pattern: np.ndarray, pat_len: int,
            width: int) -> torch.Tensor:
    from repro_torch.kernels._build import library

    if not padded.is_contiguous() or padded.data_ptr() % 16:
        raise ValueError("padded must be contiguous and 16-byte aligned")
    fn = library("pattern_scan").pattern_scan_batch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = padded.shape[0]
    mask = torch.empty((rows, width), dtype=torch.uint8, device=padded.device)
    lo = int.from_bytes(pattern[:8].tobytes(), "little")
    hi = int.from_bytes(pattern[8:].tobytes(), "little")
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(padded.data_ptr(), mask.data_ptr(), rows, width, lo, hi,
                 pat_len, stream)
    if err:
        raise RuntimeError(f"pattern_scan kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return mask


def pattern_scan_batch(padded: torch.Tensor, pattern: np.ndarray,
                       pat_len: int) -> torch.Tensor:
    """Match mask over a padded byte matrix — one launch for the batch.

    ``padded`` is ``(B, W + MAX_PATTERN)`` uint8 with ``W % 16 == 0`` and
    a zero tail; ``pattern`` is the ``(MAX_PATTERN,)`` zero-padded
    pattern, ``pat_len`` its true length. Returns the ``(B, W)`` uint8
    mask on ``padded``'s device.
    """
    width = _check(padded, pattern, pat_len)
    if padded.device.type == "cpu":
        return pattern_scan_plain(padded, pattern, pat_len)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    return _launch(padded, pattern, pat_len, width)
