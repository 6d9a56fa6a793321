"""Public wrappers for the pattern-scan kernel.

``find_pattern_mask`` scans one buffer; ``find_pattern_mask_batch`` packs
a ragged batch of payloads into padded byte matrices, one per half-step
**width bucket** (one giant outlier cannot inflate every row to its
width), all in one (pinned) staging buffer beside a descriptor table;
it copies the buffer to the device in **one** transfer, sweeps every
bucket in **one** launch, copies the masks back in one transfer and
synchronizes once, then trims each row's mask to its true length from
views of the one result. Each row carries a ``MAX_PATTERN`` zero tail
(the kernel's window reach). ``find_pattern_mask_rowgroup`` scans a
row-group the columnar store already packed: one launch, no packing.
``find_pattern_masks_multi`` and ``find_pattern_masks_multi_rowgroup``
are the same two entry points with **one pattern per row** — the
gateway's cross-request batching, where rows of different queries share
a launch; the batch form stages each bucket's patterns and lengths
beside its matrix.

The batch wrappers publish their time as the
``stage.<wrapper>.{pack,h2d,kernel,d2h}_us`` counters: host packing, and
the two copies and the kernel as device time from CUDA events, read
after the one synchronize. The row-group wrappers split host-clock time
into ``stage.<wrapper>.{h2d,kernel,d2h}_us``. Every width bucket is
still accounted as one dispatch (:func:`~repro_torch.obs.kernels.
record_dispatch`), as the reference accounts it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device, to_device
from repro_torch.kernels._clock import Clock, sync
from repro_torch.kernels.bucketing import (as_u8, bucket_width,
                                           check_rowgroup, quantize_count)
from repro_torch.obs.kernels import record_dispatch
from .pattern_scan import (DEFAULT_BLOCK, MAX_PATTERN, group_layout,
                           group_views, pattern_scan_group,
                           pattern_scan_multi_group, pattern_scan_rowgroup,
                           pattern_scan_rowgroup_multi)

__all__ = ["count_matches", "find_pattern_mask", "find_pattern_mask_batch",
           "find_pattern_mask_rowgroup", "find_pattern_masks_multi",
           "find_pattern_masks_multi_rowgroup", "find_pattern_positions",
           "pack_scan"]

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


def _trim(mask_row: np.ndarray, n: int, plen: int) -> np.ndarray:
    out = np.array(mask_row[:n])  # own the buffer
    # matches that would read past the true end are padding artifacts
    if plen > 1 and n >= plen:
        out[n - plen + 1:] = 0
    elif n < plen:
        out[:] = 0
    return out


def _check_block(block: int) -> None:
    if block <= 0 or block % 16:
        raise ValueError(f"block must be a positive multiple of 16, "
                         f"got {block}")


def pack_scan(bufs: list[np.ndarray], block: int, *,
              patterns: list[np.ndarray] | None = None,
              plens: list[int] | None = None, pin: bool = False
              ) -> tuple[torch.Tensor, np.ndarray, int, list[list[int]]]:
    """Pack a ragged batch into one group: each half-step width bucket of
    ``block`` granularity a ``(quantized rows, width + MAX_PATTERN)``
    zero-padded matrix at its table offset of one staging buffer
    (page-locked when ``pin``). With ``patterns`` (zero-padded
    ``(MAX_PATTERN,)`` vectors, one per buffer) and ``plens``, each
    bucket's patterns and int32 lengths follow its matrix, pad rows
    taking the inert pattern ``[1, 0, ...]`` of length 1, and its
    ``max_len`` is its longest length.

    Returns ``(staging, table, mask_bytes, members)``: the 1-D uint8
    buffer, its :data:`~repro_torch.kernels.pattern_scan.pattern_scan.
    GROUP_DTYPE` table, the size of the group's mask buffer and, per
    entry, the indices of ``bufs`` in its rows.
    """
    buckets: dict[int, list[int]] = {}
    for i, buf in enumerate(bufs):
        buckets.setdefault(bucket_width(buf.size, block), []).append(i)
    members = list(buckets.values())
    multi = patterns is not None
    table, in_bytes, mask_bytes = group_layout(
        [(quantize_count(len(idxs)), width,
          max(plens[i] for i in idxs) if multi else 1)
         for width, idxs in buckets.items()], multi=multi)
    staging = torch.empty(in_bytes, dtype=torch.uint8, pin_memory=pin)
    flat = staging.numpy()
    flat[:] = 0
    for e, idxs in zip(table, members):
        off, rows, width = int(e["in_off"]), int(e["rows"]), int(e["width"])
        mat = flat[off:off + rows * (width + MAX_PATTERN)].reshape(rows, -1)
        for row, i in enumerate(idxs):
            mat[row, :bufs[i].size] = bufs[i]
        if multi:
            off = int(e["pat_off"])
            pats = flat[off:off + rows * MAX_PATTERN].reshape(rows, -1)
            pats[:len(idxs)] = [patterns[i] for i in idxs]
            pats[len(idxs):] = _INERT_PATTERN
            off = int(e["len_off"])
            lens = flat[off:off + 4 * rows].view(np.int32)
            lens[:len(idxs)] = [plens[i] for i in idxs]
            lens[len(idxs):] = 1
    return staging, table, mask_bytes, members


def _scan_group(name: str, arrs: list[np.ndarray], dev: torch.device,
                block: int, scan, **packing
                ) -> list[tuple[list[int], np.ndarray]]:
    """Pack ``arrs`` into one group, run ``scan(x, table, out)`` on
    ``dev`` between one copy each way, synchronize once, and return each
    bucket's masks (views of the one result), in ``pack_scan``'s member
    order beside the members. Accounts each bucket as one dispatch of
    ``name`` and the stage split in ``stage.<name>.*``."""
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    staging, table, mask_bytes, members = pack_scan(arrs, block, pin=cuda,
                                                    **packing)
    for e, idxs in zip(table, members):
        record_dispatch(name, width=int(e["width"]), rows=len(idxs),
                        padded_rows=int(e["rows"]),
                        useful_bytes=sum(arrs[i].size for i in idxs))
    t1 = time.perf_counter()
    clock = Clock(dev)
    x = torch.empty(staging.shape, dtype=torch.uint8, device=dev)
    out = torch.empty(mask_bytes, dtype=torch.uint8, device=dev)
    res = torch.empty(mask_bytes, dtype=torch.uint8, pin_memory=cuda)
    with clock.span():
        x.copy_(staging, non_blocking=True)
    with clock.span():
        scan(x, table, out)
    with clock.span():
        res.copy_(out, non_blocking=True)
    sync(dev)
    h2d, kernel, d2h = clock.spans_us()
    obs.registry().fold_counters({"pack_us": int((t1 - t0) * 1e6),
                                  "h2d_us": h2d, "kernel_us": kernel,
                                  "d2h_us": d2h}, prefix=f"stage.{name}.")
    return list(zip(members, group_views(res.numpy(), table)))


def find_pattern_mask_batch(bufs, pattern, *, block: int = DEFAULT_BLOCK,
                            device="cuda") -> list[np.ndarray]:
    """uint8 match masks for a ragged batch — one kernel launch.

    Returns one mask per input, each the same length as its buffer.
    Inputs are grouped into half-step width buckets of ``block``-byte
    granularity (``block`` must be a multiple of 16), rows padded to a
    quantized count; one launch sweeps every bucket.
    """
    pat_vec, plen = _check_pattern(pattern)
    _check_block(block)
    dev = resolve_device(device)
    arrs = [as_u8(b) for b in bufs]
    if not arrs:
        return []
    out: list = [None] * len(arrs)
    for idxs, masks in _scan_group(
            "find_pattern_mask_batch", arrs, dev, block,
            lambda x, table, m: pattern_scan_group(x, table, m, pat_vec,
                                                   plen)):
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
    sync(dev)
    t1 = time.perf_counter()
    masks = scan(x, p, n, max_len)
    sync(dev)
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

    ``patterns[i]`` scans ``bufs[i]``; rows from different queries share
    the launch (each bucket's compare loop runs to its longest pattern,
    each row's to its own). Same bucketing and trim as
    :func:`find_pattern_mask_batch`, so for equal patterns the two give
    equal masks. Pad rows (all zero, the inert pattern ``[1, 0, ...]`` of
    length 1) round each bucket up to its quantized row count; their
    masks are discarded.
    """
    if len(bufs) != len(patterns):
        raise ValueError("bufs and patterns must pair up")
    _check_block(block)
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
    for idxs, masks in _scan_group("find_pattern_masks_multi", arrs, dev,
                                   block, pattern_scan_multi_group,
                                   patterns=pats, plens=plens):
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
    sync(dev)
    t1 = time.perf_counter()
    masks = pattern_scan_rowgroup(x, pat_vec, plen)
    sync(dev)
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
