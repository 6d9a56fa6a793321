"""Public wrappers: Adler-32 of byte buffers through the partials kernel.

``adler32`` checksums one buffer; ``adler32_batch`` stacks a ragged batch
of payloads into zero-padded ``(B, W)`` matrices, one per half-step width
bucket, copies each to the device, launches the kernel once per bucket
and combines the partials on the host.

Each launch's time is split into host-to-device copy, kernel and
device-to-host copy, published as the
``stage.adler32_batch.{h2d,kernel,d2h}_us`` counters.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.kernels.bucketing import as_u8, bucket_width
from repro_torch.obs.kernels import record_dispatch
from .adler32 import BLOCK, MOD, adler32_partials_batch

__all__ = ["adler32", "adler32_batch", "combine_partials"]


def combine_partials(s: np.ndarray, t: np.ndarray, lengths: np.ndarray,
                     block: int) -> np.ndarray:
    """Host-side reduction of per-block partials to final checksums.

    Zero padding contributes nothing to S or T, so full-row sums with each
    row's *true* length are exact for every ragged entry. Shared with the
    fused ``digest_signature_batch`` wrapper, whose kernel emits the same
    ``(S, T)`` partial layout.
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


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def adler32_batch(payloads, *, device="cuda") -> np.ndarray:
    """Adler-32 of every payload in a ragged batch, on ``device``.

    Returns a uint32 array matching ``zlib.adler32`` entry-wise. Payloads
    are zero-padded and grouped into half-step width buckets of 2048-byte
    granularity — one launch per bucket — so a uniform batch costs a
    single launch while one giant outlier cannot inflate every row to its
    width.
    """
    dev = resolve_device(device)
    bufs = [as_u8(p) for p in payloads]
    nrows = len(bufs)
    if nrows == 0:
        return np.empty(0, np.uint32)
    out = np.empty(nrows, np.uint32)
    buckets: dict[int, list[int]] = {}
    for i, buf in enumerate(bufs):
        buckets.setdefault(bucket_width(buf.size, BLOCK), []).append(i)
    reg = obs.registry()
    for width, idxs in buckets.items():
        padded = np.zeros((len(idxs), width), dtype=np.uint8)
        for row, i in enumerate(idxs):
            padded[row, :bufs[i].size] = bufs[i]
        lengths = np.asarray([bufs[i].size for i in idxs], np.int64)
        record_dispatch("adler32_batch", width=width, rows=len(idxs),
                        padded_rows=len(idxs),
                        useful_bytes=int(lengths.sum()))
        t0 = time.perf_counter()
        x = torch.from_numpy(padded).to(dev)
        _sync(dev)
        t1 = time.perf_counter()
        s, t = adler32_partials_batch(x)
        _sync(dev)
        t2 = time.perf_counter()
        s, t = s.cpu().numpy(), t.cpu().numpy()
        t3 = time.perf_counter()
        reg.fold_counters({"h2d_us": int((t1 - t0) * 1e6),
                           "kernel_us": int((t2 - t1) * 1e6),
                           "d2h_us": int((t3 - t2) * 1e6)},
                          prefix="stage.adler32_batch.")
        out[idxs] = combine_partials(s, t, lengths, BLOCK)
    return out


def adler32(data, *, device="cuda") -> int:
    """Adler-32 checksum (matches ``zlib.adler32``)."""
    buf = as_u8(data)
    if buf.size == 0:
        resolve_device(device)
        return 1
    return int(adler32_batch([buf], device=device)[0])
