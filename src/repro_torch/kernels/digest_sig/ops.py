"""Public wrapper: fused digests + signatures for ragged payload batches.

``digest_signature_batch`` stacks a ragged batch of record payloads into
half-step width buckets (the shared :mod:`repro_torch.kernels.bucketing`
rule), packs every bucket's padded matrix into one (pinned) staging
buffer beside a descriptor table, copies it to the device in **one**
transfer, sweeps all buckets in **one** launch of the fused kernel,
copies the partials and hashes back in one transfer and synchronizes
once; then it finishes each bucket on the host:

* Adler-32: the kernel's ``(S, T)`` partials reduce through
  :func:`repro_torch.kernels.adler32.ops.combine_partials` — entry-wise
  equal to ``zlib.adler32``.
* signatures: the n-gram hash matrix feeds the double-hash position
  derivation (:func:`repro_torch.index.signature.positions_from_hashes`)
  and the batch ``packbits`` fold — bit-identical to
  :func:`repro_torch.index.signature.signature_of` per row.

``digest_signature_rowgroup`` does the same for a row-group that the
columnar derive already packed in the kernel's layout: one launch, no
bucketing.

Each call's time is split into host packing (batch wrapper only),
host-to-device copy, kernel, device-to-host copy and host fold,
published as the ``stage.<wrapper>.{pack,h2d,kernel,d2h,fold}_us``
counters; the batch wrapper times its copies and its kernel on the card
with CUDA events, read after its one synchronize.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device, to_device
from repro_torch.kernels._clock import Clock, sync
from repro_torch.kernels.adler32.ops import combine_partials
from repro_torch.kernels.bucketing import (as_u8, check_rowgroup,
                                           payload_width, quantize_count)
from repro_torch.obs.kernels import record_dispatch
from .digest_sig import (BLOCK, HPAD, digest_sig_group,
                         digest_sig_partials_batch, group_layout, group_views)

__all__ = ["digest_signature_batch", "digest_signature_rowgroup",
           "pack_batch"]


def _sig_geometry(bits: int | None, n: int | None, k: int | None
                  ) -> tuple[int, int, int]:
    """Validated signature geometry, defaulting to the index constants."""
    from repro_torch.index.signature import SIG_BITS, SIG_HASHES, SIG_NGRAM

    bits = SIG_BITS if bits is None else bits
    n = SIG_NGRAM if n is None else n
    k = SIG_HASHES if k is None else k
    if bits <= 0 or bits & (bits - 1) or bits % 64:
        raise ValueError(f"bits must be a power of two multiple of 64, "
                         f"got {bits}")
    if not 1 < n <= HPAD + 1 or k < 1:
        raise ValueError(f"need 2 <= n <= {HPAD + 1} and k >= 1")
    return bits, n, k


def _host_fold(s: np.ndarray, t: np.ndarray, h: np.ndarray,
               lengths: np.ndarray, *, width: int, bits: int, n: int, k: int,
               block: int) -> tuple[np.ndarray, np.ndarray]:
    """Finish the fused sweep on the host for the first ``len(lengths)``
    rows of the kernel partials: Adler combine + hash → k bit positions
    → flat packbits fold. All O(#n-grams) on hash values. Valid n-grams
    are a per-row prefix, so the flat gather indices come from
    repeat/cumsum — no boolean mask sweep."""
    from repro_torch.index.signature import (fold_positions_rows,
                                             positions_from_hashes)

    live = lengths.size
    digests = combine_partials(s[:live], t[:live], lengths, block)
    hu = h.view(np.uint32)
    m = np.maximum(lengths - (n - 1), 0)         # valid n-grams per row
    rows = np.arange(live, dtype=np.int64)
    offs = np.cumsum(m) - m                      # per-row prefix starts
    gidx = np.arange(int(m.sum()), dtype=np.int64)
    gidx += np.repeat(rows * width - offs, m)    # flat (row, col) index
    hv = hu.ravel()[gidx]
    pos = positions_from_hashes(hv, bits, k)     # (k, total) planes
    sigs = fold_positions_rows(live, np.repeat(rows, m), pos, bits)
    return digests, sigs


def pack_batch(bufs: list[np.ndarray], *, pin: bool = False
               ) -> tuple[torch.Tensor, np.ndarray, int, list[list[int]]]:
    """Pack a ragged batch into one group: each half-step width bucket a
    ``(quantized rows, width + HPAD)`` zero-padded matrix at its table
    offset of one staging buffer (page-locked when ``pin``).

    Returns ``(staging, table, out_words, members)``: the 1-D uint8
    buffer, its :data:`~repro_torch.kernels.digest_sig.digest_sig.
    GROUP_DTYPE` table, the int32 words of the group's output and, per
    entry, the indices of ``bufs`` in its rows.
    """
    buckets: dict[int, list[int]] = {}
    for i, buf in enumerate(bufs):
        # BLOCK is the Adler overflow *bound*, not a width floor: payloads
        # below one block take sub-block width buckets (the whole row is a
        # single Adler block) — see payload_width
        buckets.setdefault(payload_width(buf.size, BLOCK), []).append(i)
    members = list(buckets.values())
    table, in_bytes, out_words = group_layout(
        [(quantize_count(len(idxs)), width, min(BLOCK, width))
         for width, idxs in buckets.items()])
    staging = torch.empty(in_bytes, dtype=torch.uint8, pin_memory=pin)
    flat = staging.numpy()
    flat[:] = 0
    for e, idxs in zip(table, members):
        off, rows, width = int(e["in_off"]), int(e["rows"]), int(e["width"])
        mat = flat[off:off + rows * (width + HPAD)].reshape(rows, -1)
        for row, i in enumerate(idxs):
            mat[row, :bufs[i].size] = bufs[i]
    return staging, table, out_words, members


def digest_signature_batch(payloads, *, bits: int | None = None,
                           n: int | None = None, k: int | None = None,
                           device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Adler-32 digests **and** n-gram signatures of a ragged batch: one
    fused kernel launch over all its width buckets, on ``device``.

    Returns ``(digests, signatures)``: uint32 ``(B,)`` matching
    ``zlib.adler32`` and uint64 ``(B, bits // 64)`` matching
    ``signature_of`` row-wise. ``bits`` must be a power of two; the
    signature geometry defaults to the :mod:`repro_torch.index.signature`
    constants.
    """
    bits, n, k = _sig_geometry(bits, n, k)
    dev = resolve_device(device)
    bufs = [as_u8(p) for p in payloads]
    nrows = len(bufs)
    digests = np.empty(nrows, np.uint32)
    sigs = np.zeros((nrows, bits // 64), np.uint64)
    if nrows == 0:
        return digests, sigs
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    staging, table, words, members = pack_batch(bufs, pin=cuda)
    lengths = [np.asarray([bufs[i].size for i in idxs], np.int64)
               for idxs in members]
    for e, lens in zip(table, lengths):
        record_dispatch("digest_signature_batch", width=int(e["width"]),
                        rows=lens.size, padded_rows=int(e["rows"]),
                        useful_bytes=int(lens.sum()))
    t1 = time.perf_counter()
    clock = Clock(dev)
    x = torch.empty(staging.shape, dtype=torch.uint8, device=dev)
    out = torch.empty(words, dtype=torch.int32, device=dev)
    res = torch.empty(words, dtype=torch.int32, pin_memory=cuda)
    with clock.span():
        x.copy_(staging, non_blocking=True)
    with clock.span():
        digest_sig_group(x, table, out, n=n)
    with clock.span():
        res.copy_(out, non_blocking=True)
    sync(dev)
    t2 = time.perf_counter()
    views = group_views(res.numpy(), table)
    for e, idxs, lens, (s, t, h) in zip(table, members, lengths, views):
        width = int(e["width"])
        digests[idxs], sigs[idxs] = _host_fold(
            s, t, h, lens, width=width, bits=bits, n=n, k=k,
            block=int(e["kblock"]))
    t3 = time.perf_counter()
    h2d, kernel, d2h = clock.spans_us()
    obs.registry().fold_counters({"pack_us": int((t1 - t0) * 1e6),
                                  "h2d_us": h2d, "kernel_us": kernel,
                                  "d2h_us": d2h,
                                  "fold_us": int((t3 - t2) * 1e6)},
                                 prefix="stage.digest_signature_batch.")
    return digests, sigs


def digest_signature_rowgroup(matrix, lengths, *, bits: int | None = None,
                              n: int | None = None, k: int | None = None,
                              block: int = BLOCK, device="cuda"
                              ) -> tuple[np.ndarray, np.ndarray]:
    """Fused digests + signatures over an **already-packed row-group**.

    The columnar derive entry point: ``matrix`` is a ``(B, width +
    HPAD)`` uint8 row-group in the kernel's native layout (payload bytes
    left-justified, zero tail), ``lengths`` the true payload lengths of
    the first ``len(lengths)`` rows; trailing rows are padding and are
    neither copied to ``device`` nor swept. ``width`` must be a multiple
    of ``block`` (below 2048 the caller passes ``block = width``: the
    whole row is one Adler block).

    Returns ``(digests, signatures)`` for the live rows, bit-identical
    to :func:`digest_signature_batch` on the same payloads.
    """
    bits, n, k = _sig_geometry(bits, n, k)
    dev = resolve_device(device)
    mat, lengths, width = check_rowgroup(matrix, lengths)  # HPAD == its pad
    live = lengths.size
    if block <= 0 or width % block:
        raise ValueError(f"row-group width {width} must be a multiple of "
                         f"block={block}")
    if lengths.max() > width:
        raise ValueError("length exceeds row-group width")
    record_dispatch("digest_signature_rowgroup", width=width, rows=live,
                    padded_rows=live, useful_bytes=int(lengths.sum()))
    t0 = time.perf_counter()
    x = to_device(mat[:live], dev)
    sync(dev)
    t1 = time.perf_counter()
    s, t, h = digest_sig_partials_batch(x, n=n, block=block)
    sync(dev)
    t2 = time.perf_counter()
    del x  # the CPU path's tensor is a view of ``matrix``
    s, t, h = s.cpu().numpy(), t.cpu().numpy(), h.cpu().numpy()
    t3 = time.perf_counter()
    out = _host_fold(s, t, h, lengths, width=width, bits=bits, n=n, k=k,
                     block=block)
    t4 = time.perf_counter()
    obs.registry().fold_counters({"h2d_us": int((t1 - t0) * 1e6),
                                  "kernel_us": int((t2 - t1) * 1e6),
                                  "d2h_us": int((t3 - t2) * 1e6),
                                  "fold_us": int((t4 - t3) * 1e6)},
                                 prefix="stage.digest_signature_rowgroup.")
    return out
