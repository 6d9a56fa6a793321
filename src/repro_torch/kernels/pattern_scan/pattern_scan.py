"""Pattern-scan kernel: CUDA launches, plain PyTorch versions, launch counts.

For a pattern ``p`` of length P ≤ 16 the match mask of a padded byte
matrix is ``mask[r, i] = AND_{j<P} buf[r, i + j] == p[j]``. Rows carry a
zero tail, so every window starting in a row is in bounds and no halo
input is needed (the Pallas kernel's halo existed only because its
BlockSpecs could not overlap). Two layouts and two pattern forms, one
CUDA source; the single-pattern row-group scan has its own body (a
candidate filter with early exit), the other three share one template:

* batches, ``(B, W + MAX_PATTERN)``: :func:`pattern_scan_batch`, plain
  version :func:`pattern_scan_plain`, counted in ``launches``;
* row-groups of the columnar store, ``(B, W + ROWGROUP_PAD)``:
  :func:`pattern_scan_rowgroup`, plain version
  :func:`pattern_scan_rowgroup_plain`, counted in ``rowgroup_launches``;
* one pattern **per row** (the gateway's cross-request batching): a
  ``(B, MAX_PATTERN)`` uint8 pattern matrix and ``(B,)`` int32 lengths;
  positions at or past a row's own length always match.
  :func:`pattern_scan_batch_multi` / :func:`pattern_scan_rowgroup_multi`,
  plain versions :func:`pattern_scan_multi_plain` /
  :func:`pattern_scan_rowgroup_multi_plain`, counted in
  ``multi_launches`` / ``rowgroup_multi_launches``.

Each entry point launches ``csrc/pattern_scan.cu`` for a CUDA tensor and
uses its plain version for a CPU tensor; any other device raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.bucketing import ROWGROUP_PAD

__all__ = ["DEFAULT_BLOCK", "MAX_PATTERN", "launches", "multi_launches",
           "pattern_scan_batch", "pattern_scan_batch_multi",
           "pattern_scan_multi_plain", "pattern_scan_plain",
           "pattern_scan_rowgroup", "pattern_scan_rowgroup_multi",
           "pattern_scan_rowgroup_multi_plain", "pattern_scan_rowgroup_plain",
           "rowgroup_launches", "rowgroup_multi_launches"]

DEFAULT_BLOCK = 64 * 1024  # width-bucket granularity of whole-buffer scans
MAX_PATTERN = 16           # longest pattern; also each batch row's zero tail

launches = 0           # CUDA launches of pattern_scan_batch in this process
rowgroup_launches = 0  # CUDA launches of pattern_scan_rowgroup
multi_launches = 0     # CUDA launches of pattern_scan_batch_multi
rowgroup_multi_launches = 0  # CUDA launches of pattern_scan_rowgroup_multi


def _check(padded: torch.Tensor, pattern: np.ndarray, pat_len: int,
           tail: int) -> int:
    """Validate the kernel's inputs; returns the scanned width W."""
    if padded.dtype != torch.uint8 or padded.dim() != 2:
        raise ValueError("padded must be a 2-D uint8 tensor")
    width = padded.shape[1] - tail
    if width <= 0 or width % 16:
        raise ValueError(f"padded width {padded.shape[1]} must be "
                         f"{tail} plus a positive multiple of 16")
    if pattern.dtype != np.uint8 or pattern.shape != (MAX_PATTERN,):
        raise ValueError(f"pattern must be a ({MAX_PATTERN},) uint8 array")
    if not 0 < pat_len <= MAX_PATTERN:
        raise ValueError(f"pat_len must be in [1, {MAX_PATTERN}]")
    return width


def _plain(padded: torch.Tensor, pattern: np.ndarray, pat_len: int,
           width: int) -> torch.Tensor:
    """P shifted compares over the whole matrix."""
    acc = padded[:, :width] == int(pattern[0])
    for j in range(1, pat_len):
        acc &= padded[:, j:j + width] == int(pattern[j])
    return acc.to(torch.uint8)


def pattern_scan_plain(padded: torch.Tensor, pattern: np.ndarray,
                       pat_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pattern_scan_batch`."""
    width = _check(padded, pattern, pat_len, MAX_PATTERN)
    return _plain(padded, pattern, pat_len, width)


def pattern_scan_rowgroup_plain(matrix: torch.Tensor, pattern: np.ndarray,
                                pat_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pattern_scan_rowgroup`."""
    width = _check(matrix, pattern, pat_len, ROWGROUP_PAD)
    return _plain(matrix, pattern, pat_len, width)


@functools.cache
def _entry(entry: str) -> ctypes._CFuncPtr:
    """The C entry point ``entry`` of ``pattern_scan.cu``, resolved and
    typed once per process. Every entry takes (buf, mask, rows, width),
    the row-group ones then the row stride, and then the single-pattern
    ones (pat_lo, pat_hi, pat_len), the multi ones (pats, lens, max_len),
    and last the stream."""
    from repro_torch.kernels._build import library

    fn = getattr(library("pattern_scan"), entry)
    stride = [ctypes.c_int64] if "rowgroup" in entry else []
    pattern = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
               if entry.endswith("_multi")
               else [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64] + stride + pattern + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, padded: torch.Tensor, pattern: np.ndarray,
            pat_len: int, width: int) -> torch.Tensor:
    """Launch the C entry point ``entry`` of ``pattern_scan.cu``."""
    if not padded.is_contiguous() or padded.data_ptr() % 16:
        raise ValueError("padded must be contiguous and 16-byte aligned")
    fn = _entry(entry)
    # the row-group entry also takes the row stride, after the width
    stride = [padded.shape[1]] if entry == "pattern_scan_rowgroup" else []
    rows = padded.shape[0]
    mask = torch.empty((rows, width), dtype=torch.uint8, device=padded.device)
    lo = int.from_bytes(pattern[:8].tobytes(), "little")
    hi = int.from_bytes(pattern[8:].tobytes(), "little")
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(padded.data_ptr(), mask.data_ptr(), rows, width, *stride,
                 lo, hi, pat_len, stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return mask


def pattern_scan_batch(padded: torch.Tensor, pattern: np.ndarray,
                       pat_len: int) -> torch.Tensor:
    """Match mask over a padded byte matrix — one launch for the batch.

    ``padded`` is ``(B, W + MAX_PATTERN)`` uint8 with ``W % 16 == 0`` and
    a zero tail; ``pattern`` is the ``(MAX_PATTERN,)`` zero-padded
    pattern, ``pat_len`` its true length. Returns the ``(B, W)`` uint8
    mask on ``padded``'s device.
    """
    width = _check(padded, pattern, pat_len, MAX_PATTERN)
    if padded.device.type == "cpu":
        return _plain(padded, pattern, pat_len, width)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    mask = _launch("pattern_scan_batch", padded, pattern, pat_len, width)
    global launches
    launches += 1
    return mask


def pattern_scan_rowgroup(matrix: torch.Tensor, pattern: np.ndarray,
                          pat_len: int) -> torch.Tensor:
    """Match mask over a packed row-group matrix — one launch.

    ``matrix`` is ``(B, W + ROWGROUP_PAD)`` uint8 in the columnar store's
    row-group layout (payload left-justified, zero tail; ``W % 16 == 0``);
    ``pattern`` and ``pat_len`` as in :func:`pattern_scan_batch`. Returns
    the ``(B, W)`` uint8 mask on ``matrix``'s device; positions past each
    row's true length are the caller's to trim.
    """
    width = _check(matrix, pattern, pat_len, ROWGROUP_PAD)
    if matrix.device.type == "cpu":
        return _plain(matrix, pattern, pat_len, width)
    if matrix.device.type != "cuda":
        raise ValueError(f"unsupported device {matrix.device}")
    mask = _launch("pattern_scan_rowgroup", matrix, pattern, pat_len, width)
    global rowgroup_launches
    rowgroup_launches += 1
    return mask


# -- one pattern per row ------------------------------------------------------

def _check_multi(padded: torch.Tensor, pattern_mat: torch.Tensor,
                 pat_lens: torch.Tensor, max_len: int, tail: int) -> int:
    """Validate the multi-pattern kernel's inputs; returns the width W."""
    if padded.dtype != torch.uint8 or padded.dim() != 2:
        raise ValueError("padded must be a 2-D uint8 tensor")
    rows = padded.shape[0]
    width = padded.shape[1] - tail
    if width <= 0 or width % 16:
        raise ValueError(f"padded width {padded.shape[1]} must be "
                         f"{tail} plus a positive multiple of 16")
    if (pattern_mat.dtype != torch.uint8
            or tuple(pattern_mat.shape) != (rows, MAX_PATTERN)):
        raise ValueError(f"pattern_mat must be a ({rows}, {MAX_PATTERN}) "
                         f"uint8 tensor")
    if pat_lens.dtype != torch.int32 or tuple(pat_lens.shape) != (rows,):
        raise ValueError(f"pat_lens must be a ({rows},) int32 tensor")
    if not (padded.device == pattern_mat.device == pat_lens.device):
        raise ValueError("padded, pattern_mat and pat_lens must share a "
                         "device")
    if not 0 < max_len <= MAX_PATTERN:
        raise ValueError(f"max_len must be in [1, {MAX_PATTERN}]")
    return width


def _plain_multi(padded: torch.Tensor, pattern_mat: torch.Tensor,
                 pat_lens: torch.Tensor, max_len: int,
                 width: int) -> torch.Tensor:
    """``max_len`` shifted compares; position j >= 1 forced to match on
    rows whose pattern is shorter than j + 1 (the lengths are not read
    back from the device, so any value is defined: position 0 is always
    compared)."""
    acc = padded[:, :width] == pattern_mat[:, 0:1]
    lens = pat_lens.reshape(-1, 1)
    for j in range(1, max_len):
        acc &= (padded[:, j:j + width] == pattern_mat[:, j:j + 1]) | (j >= lens)
    return acc.to(torch.uint8)


def pattern_scan_multi_plain(padded: torch.Tensor, pattern_mat: torch.Tensor,
                             pat_lens: torch.Tensor,
                             max_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pattern_scan_batch_multi`."""
    width = _check_multi(padded, pattern_mat, pat_lens, max_len, MAX_PATTERN)
    return _plain_multi(padded, pattern_mat, pat_lens, max_len, width)


def pattern_scan_rowgroup_multi_plain(matrix: torch.Tensor,
                                      pattern_mat: torch.Tensor,
                                      pat_lens: torch.Tensor,
                                      max_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pattern_scan_rowgroup_multi`."""
    width = _check_multi(matrix, pattern_mat, pat_lens, max_len, ROWGROUP_PAD)
    return _plain_multi(matrix, pattern_mat, pat_lens, max_len, width)


def _launch_multi(entry: str, padded: torch.Tensor,
                  pattern_mat: torch.Tensor, pat_lens: torch.Tensor,
                  max_len: int, width: int) -> torch.Tensor:
    """Launch the per-row-pattern C entry point ``entry``."""
    for name, t in (("padded", padded), ("pattern_mat", pattern_mat)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if not pat_lens.is_contiguous():
        raise ValueError("pat_lens must be contiguous")
    fn = _entry(entry)
    # the row-group entry also takes the row stride, after the width
    stride = ([padded.shape[1]] if entry == "pattern_scan_rowgroup_multi"
              else [])
    rows = padded.shape[0]
    mask = torch.empty((rows, width), dtype=torch.uint8, device=padded.device)
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(padded.data_ptr(), mask.data_ptr(), rows, width, *stride,
                 pattern_mat.data_ptr(), pat_lens.data_ptr(), max_len,
                 stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return mask


def pattern_scan_batch_multi(padded: torch.Tensor, pattern_mat: torch.Tensor,
                             pat_lens: torch.Tensor,
                             max_len: int) -> torch.Tensor:
    """Per-row-pattern match masks — **one** launch for a mixed batch.

    ``padded`` is ``(B, W + MAX_PATTERN)`` uint8 as in
    :func:`pattern_scan_batch`; row ``r`` is scanned for
    ``pattern_mat[r, :pat_lens[r]]`` (``pattern_mat`` ``(B, MAX_PATTERN)``
    uint8 zero-padded, ``pat_lens`` ``(B,)`` int32, all on ``padded``'s
    device). ``max_len`` bounds the compare loop (the longest length);
    the caller keeps every length in ``[1, max_len]``.
    Returns the ``(B, W)`` uint8 mask on ``padded``'s device.
    """
    width = _check_multi(padded, pattern_mat, pat_lens, max_len, MAX_PATTERN)
    if padded.device.type == "cpu":
        return _plain_multi(padded, pattern_mat, pat_lens, max_len, width)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    mask = _launch_multi("pattern_scan_batch_multi", padded, pattern_mat,
                         pat_lens, max_len, width)
    global multi_launches
    multi_launches += 1
    return mask


def pattern_scan_rowgroup_multi(matrix: torch.Tensor,
                                pattern_mat: torch.Tensor,
                                pat_lens: torch.Tensor,
                                max_len: int) -> torch.Tensor:
    """Per-row-pattern match masks over a packed row-group — one launch.

    ``matrix`` is ``(B, W + ROWGROUP_PAD)`` uint8 in the row-group layout;
    the patterns as in :func:`pattern_scan_batch_multi`. Returns the
    ``(B, W)`` uint8 mask on ``matrix``'s device; positions past each
    row's true length are the caller's to trim.
    """
    width = _check_multi(matrix, pattern_mat, pat_lens, max_len, ROWGROUP_PAD)
    if matrix.device.type == "cpu":
        return _plain_multi(matrix, pattern_mat, pat_lens, max_len, width)
    if matrix.device.type != "cuda":
        raise ValueError(f"unsupported device {matrix.device}")
    mask = _launch_multi("pattern_scan_rowgroup_multi", matrix, pattern_mat,
                         pat_lens, max_len, width)
    global rowgroup_multi_launches
    rowgroup_multi_launches += 1
    return mask
