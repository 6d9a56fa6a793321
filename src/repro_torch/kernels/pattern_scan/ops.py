"""Public wrappers for the pattern-scan kernel.

``find_pattern_mask`` scans one buffer; ``find_pattern_mask_batch`` packs
a ragged batch of payloads into padded byte matrices and issues one
launch per half-step **width bucket**: a uniform batch costs a single
launch, and one giant outlier cannot inflate every row to its width.
Each row is packed with a ``MAX_PATTERN`` zero tail (the kernel's
window reach), copied to the device, scanned, and the mask copied back
and trimmed to the row's true length.

Each bucket's time is split into host-to-device copy, kernel and
device-to-host copy, published as the
``stage.find_pattern_mask_batch.{h2d,kernel,d2h}_us`` counters.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.kernels.bucketing import as_u8, bucket_width, quantize_count
from repro_torch.obs.kernels import record_dispatch
from .pattern_scan import DEFAULT_BLOCK, MAX_PATTERN, pattern_scan_batch

__all__ = ["count_matches", "find_pattern_mask", "find_pattern_mask_batch",
           "find_pattern_positions"]


def _check_pattern(pattern) -> tuple[np.ndarray, int]:
    pat = as_u8(pattern)
    if not 0 < pat.size <= MAX_PATTERN:
        raise ValueError(f"pattern length must be in [1, {MAX_PATTERN}]")
    # zero padding never false-positives: pattern bytes are non-zero in
    # WARC use; all-zero patterns are rejected to keep that invariant
    if not pat.any():
        raise ValueError("all-zero patterns are not supported")
    pad_vec = np.zeros(MAX_PATTERN, dtype=np.uint8)
    pad_vec[:pat.size] = pat
    return pad_vec, int(pat.size)


def _pack(bufs: list[np.ndarray], width: int) -> np.ndarray:
    """Stack ragged buffers into ``(B, width + MAX_PATTERN)``, zero tail."""
    out = np.zeros((len(bufs), width + MAX_PATTERN), dtype=np.uint8)
    for i, buf in enumerate(bufs):
        out[i, :buf.size] = buf
    return out


def _trim(mask_row: np.ndarray, n: int, plen: int) -> np.ndarray:
    out = np.array(mask_row[:n])  # own the buffer
    # matches that would read past the true end are padding artifacts
    if plen > 1 and n >= plen:
        out[n - plen + 1:] = 0
    elif n < plen:
        out[:] = 0
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def find_pattern_mask_batch(bufs, pattern, *, block: int = DEFAULT_BLOCK,
                            device="cuda") -> list[np.ndarray]:
    """uint8 match masks for a ragged batch — few kernel launches.

    Returns one mask per input, each the same length as its buffer.
    Inputs are grouped into half-step width buckets of ``block``-byte
    granularity (``block`` must be a multiple of 16) — one launch per
    bucket, rows padded to a quantized count.
    """
    pat_vec, plen = _check_pattern(pattern)
    if block <= 0 or block % 16:
        raise ValueError(f"block must be a positive multiple of 16, "
                         f"got {block}")
    dev = resolve_device(device)
    arrs = [as_u8(b) for b in bufs]
    if not arrs:
        return []
    out: list = [None] * len(arrs)
    buckets: dict[int, list[int]] = {}
    for i, arr in enumerate(arrs):
        buckets.setdefault(bucket_width(arr.size, block), []).append(i)
    empty = np.empty(0, np.uint8)
    reg = obs.registry()
    for width, idxs in buckets.items():
        rows = [arrs[i] for i in idxs]
        rows += [empty] * (quantize_count(len(rows)) - len(rows))
        padded = _pack(rows, width)
        record_dispatch("find_pattern_mask_batch", width=width,
                        rows=len(idxs), padded_rows=len(rows),
                        useful_bytes=sum(arrs[i].size for i in idxs))
        t0 = time.perf_counter()
        x = torch.from_numpy(padded).to(dev)
        _sync(dev)
        t1 = time.perf_counter()
        masks = pattern_scan_batch(x, pat_vec, plen)
        _sync(dev)
        t2 = time.perf_counter()
        masks = masks.cpu().numpy()
        t3 = time.perf_counter()
        reg.fold_counters({"h2d_us": int((t1 - t0) * 1e6),
                           "kernel_us": int((t2 - t1) * 1e6),
                           "d2h_us": int((t3 - t2) * 1e6)},
                          prefix="stage.find_pattern_mask_batch.")
        for row, i in enumerate(idxs):
            out[i] = _trim(masks[row], arrs[i].size, plen)
    return out


def find_pattern_mask(buf, pattern, *, block: int = DEFAULT_BLOCK,
                      device="cuda") -> np.ndarray:
    """uint8 match mask (same length as ``buf``)."""
    return find_pattern_mask_batch([buf], pattern, block=block,
                                   device=device)[0]


def find_pattern_positions(buf, pattern, **kw) -> np.ndarray:
    """Sorted match start offsets (host-side compaction of the mask)."""
    return np.flatnonzero(find_pattern_mask(buf, pattern, **kw))


def count_matches(buf, pattern, **kw) -> int:
    return int(find_pattern_mask(buf, pattern, **kw).sum())
