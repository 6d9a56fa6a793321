"""Public wrapper: fused digests + signatures for ragged payload batches.

``digest_signature_batch`` stacks a ragged batch of record payloads into
half-step width buckets (the shared :mod:`repro_torch.kernels.bucketing`
rule), copies each bucket's padded matrix to the device, sweeps it
**once** through the fused kernel, copies the partials and hashes back,
and finishes on the host:

* Adler-32: the kernel's ``(S, T)`` partials reduce through
  :func:`combine_partials` — entry-wise equal to ``zlib.adler32``.
* signatures: the n-gram hash matrix feeds the double-hash position
  derivation (:func:`repro_torch.index.signature.positions_from_hashes`)
  and the batch ``packbits`` fold — bit-identical to
  :func:`repro_torch.index.signature.signature_of` per row.

Each bucket's time is split into host-to-device copy, kernel,
device-to-host copy and host fold, published as the
``stage.digest_signature_batch.{h2d,kernel,d2h,fold}_us`` counters.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.kernels.bucketing import as_u8, payload_width, quantize_count
from repro_torch.obs.kernels import record_dispatch
from .digest_sig import BLOCK, HPAD, digest_sig_partials_batch

__all__ = ["combine_partials", "digest_signature_batch"]

MOD = 65521  # Adler-32 modulus


def combine_partials(s: np.ndarray, t: np.ndarray, lengths: np.ndarray,
                     block: int) -> np.ndarray:
    """Host-side reduction of per-block partials to final checksums.

    Zero padding contributes nothing to S or T, so full-row sums with each
    row's *true* length are exact for every ragged entry.
    """
    s = s.astype(np.int64)
    t = t.astype(np.int64)
    offsets = np.arange(s.shape[1], dtype=np.int64) * block   # o_j
    n = lengths.astype(np.int64)[:, None]                     # (B, 1)
    a = (1 + s.sum(axis=1)) % MOD
    b = (n[:, 0] + ((n - offsets) * s - t).sum(axis=1)) % MOD
    out = ((b << 16) | a).astype(np.uint32)
    out[lengths == 0] = 1  # adler32(b"") == 1
    return out


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


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def digest_signature_batch(payloads, *, bits: int | None = None,
                           n: int | None = None, k: int | None = None,
                           device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Adler-32 digests **and** n-gram signatures of a ragged batch,
    one fused kernel sweep per width bucket, on ``device``.

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
    buckets: dict[int, list[int]] = {}
    for i, buf in enumerate(bufs):
        # BLOCK is the Adler overflow *bound*, not a width floor: payloads
        # below one block take sub-block width buckets (the whole row is a
        # single Adler block) — see payload_width
        buckets.setdefault(payload_width(buf.size, BLOCK), []).append(i)
    reg = obs.registry()
    for width, idxs in buckets.items():
        kblock = min(BLOCK, width)  # sub-2048 widths are one Adler block
        padded = np.zeros((quantize_count(len(idxs)), width + HPAD), np.uint8)
        for row, i in enumerate(idxs):
            padded[row, :bufs[i].size] = bufs[i]
        lengths = np.asarray([bufs[i].size for i in idxs], np.int64)
        record_dispatch("digest_signature_batch", width=width,
                        rows=len(idxs), padded_rows=padded.shape[0],
                        useful_bytes=int(lengths.sum()))
        t0 = time.perf_counter()
        x = torch.from_numpy(padded).to(dev)
        _sync(dev)
        t1 = time.perf_counter()
        s, t, h = digest_sig_partials_batch(x, n=n, block=kblock)
        _sync(dev)
        t2 = time.perf_counter()
        s, t, h = s.cpu().numpy(), t.cpu().numpy(), h.cpu().numpy()
        t3 = time.perf_counter()
        digests[idxs], sigs[idxs] = _host_fold(
            s, t, h, lengths, width=width, bits=bits, n=n, k=k, block=kblock)
        t4 = time.perf_counter()
        reg.fold_counters({"h2d_us": int((t1 - t0) * 1e6),
                           "kernel_us": int((t2 - t1) * 1e6),
                           "d2h_us": int((t3 - t2) * 1e6),
                           "fold_us": int((t4 - t3) * 1e6)},
                          prefix="stage.digest_signature_batch.")
    return digests, sigs
