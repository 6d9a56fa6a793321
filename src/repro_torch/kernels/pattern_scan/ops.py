"""Public wrappers for the pattern-scan kernel.

``find_pattern_mask`` scans one buffer; ``find_pattern_mask_batch`` packs
a ragged batch of payloads into padded byte matrices and issues one
launch per half-step **width bucket**: a uniform batch costs a single
launch, and one giant outlier cannot inflate every row to its width.
Each row is packed with a ``MAX_PATTERN`` zero tail (the kernel's
window reach), copied to the device, scanned, and the mask copied back
and trimmed to the row's true length. ``find_pattern_mask_rowgroup``
scans a row-group the columnar store already packed: one launch, no
packing. ``find_pattern_masks_multi`` and
``find_pattern_masks_multi_rowgroup`` are the same two entry points with
**one pattern per row** — the gateway's cross-request batching, where
rows of different queries share a launch.

Each launch's time is split into host-to-device copy, kernel and
device-to-host copy, published as the
``stage.<wrapper>.{h2d,kernel,d2h}_us`` counters.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device, to_device
from repro_torch.kernels.bucketing import (as_u8, bucket_width,
                                           check_rowgroup, quantize_count)
from repro_torch.obs.kernels import record_dispatch
from .pattern_scan import (DEFAULT_BLOCK, MAX_PATTERN, pattern_scan_batch,
                           pattern_scan_batch_multi, pattern_scan_rowgroup,
                           pattern_scan_rowgroup_multi)

__all__ = ["count_matches", "find_pattern_mask", "find_pattern_mask_batch",
           "find_pattern_mask_rowgroup", "find_pattern_masks_multi",
           "find_pattern_masks_multi_rowgroup", "find_pattern_positions"]

# pattern of the pad rows that round a multi-pattern batch up to its
# quantized row count: it never matches an all-zero pad row
_INERT_PATTERN = np.zeros(MAX_PATTERN, np.uint8)
_INERT_PATTERN[0] = 1


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


def _scan_multi(scan, mat: np.ndarray, pat_mat: np.ndarray,
                lens: np.ndarray, max_len: int, dev: torch.device,
                stage: str) -> np.ndarray:
    """Copy one per-row-pattern batch to ``dev``, launch ``scan`` on it,
    copy the mask back; the stage split lands in ``stage.<stage>.*``."""
    t0 = time.perf_counter()
    x = to_device(mat, dev)
    p = torch.from_numpy(pat_mat).to(dev)
    n = torch.from_numpy(lens).to(dev)
    _sync(dev)
    t1 = time.perf_counter()
    masks = scan(x, p, n, max_len)
    _sync(dev)
    t2 = time.perf_counter()
    del x  # the CPU path's tensor may be a view of the caller's matrix
    masks = masks.cpu().numpy()
    t3 = time.perf_counter()
    obs.registry().fold_counters({"h2d_us": int((t1 - t0) * 1e6),
                                  "kernel_us": int((t2 - t1) * 1e6),
                                  "d2h_us": int((t3 - t2) * 1e6)},
                                 prefix=f"stage.{stage}.")
    return masks


def find_pattern_masks_multi(bufs, patterns, *, block: int = DEFAULT_BLOCK,
                             device="cuda") -> list[np.ndarray]:
    """Match masks for a ragged batch where **each row has its own
    pattern** — the cross-request batching entry point.

    ``patterns[i]`` scans ``bufs[i]``; rows from different queries that
    land in the same width bucket share one launch (the compare loop
    runs to the bucket's longest pattern). Same bucketing and trim as
    :func:`find_pattern_mask_batch`, so for equal patterns the two give
    equal masks. Pad rows (all zero, the inert pattern ``[1, 0, ...]`` of
    length 1) round each bucket up to its quantized row count; their
    masks are discarded.
    """
    if len(bufs) != len(patterns):
        raise ValueError("bufs and patterns must pair up")
    if block <= 0 or block % 16:
        raise ValueError(f"block must be a positive multiple of 16, "
                         f"got {block}")
    dev = resolve_device(device)
    arrs = [as_u8(b) for b in bufs]
    pats: list[np.ndarray] = []
    plens: list[int] = []
    for p in patterns:
        vec, n = _check_pattern(p)
        pats.append(vec)
        plens.append(n)
    if not arrs:
        return []
    out: list = [None] * len(arrs)
    buckets: dict[int, list[int]] = {}
    for i, arr in enumerate(arrs):
        buckets.setdefault(bucket_width(arr.size, block), []).append(i)
    empty = np.empty(0, np.uint8)
    for width, idxs in buckets.items():
        rows = [arrs[i] for i in idxs]
        n_pad = quantize_count(len(rows)) - len(rows)
        rows += [empty] * n_pad
        padded = _pack(rows, width)
        pat_mat = np.stack([pats[i] for i in idxs]
                           + [_INERT_PATTERN] * n_pad)
        lens = np.asarray([plens[i] for i in idxs] + [1] * n_pad, np.int32)
        record_dispatch("find_pattern_masks_multi", width=width,
                        rows=len(idxs), padded_rows=len(rows),
                        useful_bytes=sum(arrs[i].size for i in idxs))
        masks = _scan_multi(pattern_scan_batch_multi, padded, pat_mat, lens,
                            max(plens[i] for i in idxs), dev,
                            "find_pattern_masks_multi")
        for row, i in enumerate(idxs):
            out[i] = _trim(masks[row], arrs[i].size, plens[i])
    return out


def _trim_rows(masks: np.ndarray, lengths: np.ndarray, plens) -> np.ndarray:
    """Vectorized :func:`_trim` over row-group masks: zero every position
    whose match window would read past its row's true length."""
    width = masks.shape[1]
    last = np.maximum(lengths[:, None] - np.asarray(plens).reshape(-1, 1) + 1,
                      0)
    return np.where(np.arange(width)[None, :] < last, masks, 0)


def find_pattern_mask_rowgroup(matrix, lengths, pattern, *, trim: bool = True,
                               device="cuda") -> np.ndarray:
    """Match masks over an **already-packed row-group** — one launch.

    The columnar scan entry point: ``matrix`` is ``(B, width +
    ROWGROUP_PAD)`` uint8 in the shared row-group layout (typically a
    read-only view of a memory-mapped columnar store), ``lengths`` the
    true payload lengths of the first ``len(lengths)`` rows (trailing
    rows are padding). Only those live rows are copied to ``device`` and
    scanned; no per-payload copy, re-bucketing or halo build. Returns a
    ``(live, width)`` uint8 mask, trimmed per row exactly like
    :func:`find_pattern_mask_batch` trims its outputs.

    ``trim=False`` skips the per-row trim and hands back the raw kernel
    output: positions past ``length - len(pattern) + 1`` may carry
    padding artifacts the caller must filter out. The column-scan hot
    path does exactly that on the compacted hit list.

    No tensor built on ``matrix`` outlives the call, so a store can be
    closed once the caller drops its own views.
    """
    pat_vec, plen = _check_pattern(pattern)
    dev = resolve_device(device)
    mat, lengths, width = check_rowgroup(matrix, lengths)
    live = lengths.size
    record_dispatch("find_pattern_mask_rowgroup", width=width, rows=live,
                    padded_rows=live, useful_bytes=int(lengths.sum()))
    t0 = time.perf_counter()
    x = to_device(mat[:live], dev)
    _sync(dev)
    t1 = time.perf_counter()
    masks = pattern_scan_rowgroup(x, pat_vec, plen)
    _sync(dev)
    t2 = time.perf_counter()
    del x  # the CPU path's tensor is a view of ``matrix``
    masks = masks.cpu().numpy()
    t3 = time.perf_counter()
    obs.registry().fold_counters({"h2d_us": int((t1 - t0) * 1e6),
                                  "kernel_us": int((t2 - t1) * 1e6),
                                  "d2h_us": int((t3 - t2) * 1e6)},
                                 prefix="stage.find_pattern_mask_rowgroup.")
    if not trim:
        return masks
    return _trim_rows(masks, lengths, plen)


def find_pattern_masks_multi_rowgroup(matrix, lengths, patterns, *,
                                      device="cuda") -> np.ndarray:
    """Per-row-pattern masks over an already-packed row-group — one
    launch.

    ``patterns[i]`` scans row ``i`` of ``matrix`` (the row-group layout of
    :func:`find_pattern_mask_rowgroup`); rows of different queries share
    the launch. As there, only the ``len(lengths)`` live rows are copied
    and scanned, so the launch carries no pad rows. Returns the
    ``(live, width)`` uint8 mask, each row trimmed with its own pattern's
    length.
    """
    dev = resolve_device(device)
    mat, lengths, width = check_rowgroup(matrix, lengths)
    live = lengths.size
    if live != len(patterns):
        raise ValueError("lengths and patterns must pair up")
    pats, plens = zip(*(_check_pattern(p) for p in patterns))
    plens = np.asarray(plens, np.int32)
    record_dispatch("find_pattern_masks_multi_rowgroup", width=width,
                    rows=live, padded_rows=live,
                    useful_bytes=int(lengths.sum()))
    masks = _scan_multi(pattern_scan_rowgroup_multi, mat[:live],
                        np.stack(pats), plens, int(plens.max()), dev,
                        "find_pattern_masks_multi_rowgroup")
    return _trim_rows(masks, lengths, plens)


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
