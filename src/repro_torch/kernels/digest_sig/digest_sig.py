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

One CUDA launch covers a **group** of such matrices: the width buckets of
one wrapper call, packed at 16-byte-aligned offsets of one byte buffer,
with a descriptor table (:data:`GROUP_DTYPE`, one entry per matrix: input
offset, rows, width, sub-block, and the offsets of its S, T and H in one
int32 output buffer). :func:`digest_sig_group` launches
``csrc/digest_sig.cu`` once for a CUDA buffer and runs
:func:`digest_sig_plain` per table entry for a CPU buffer; any other
device raises. :func:`digest_sig_partials_batch` is the one-entry group
over one matrix. ``launches`` counts CUDA launches in this process, and
each launch also adds one to the process registry's
``kernel.digest_sig.launches`` counter, which a pool worker's stats slot
carries back to the parent (``build_index(workers=N, fused=True)``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.bucketing import ROWGROUP_PAD

__all__ = ["BLOCK", "FNV_PRIME", "GROUP_DTYPE", "HPAD", "MAX_GROUP",
           "digest_sig_group", "digest_sig_partials_batch", "digest_sig_plain",
           "group_layout", "group_views", "launches"]

BLOCK = 2048          # Adler overflow bound: T_j < 2048·2047/2·255 < 2³¹
HPAD = ROWGROUP_PAD   # zero right-padding; bounds n − 1
FNV_PRIME = 0x01000193
_MAX_KBLOCK = 32 * 1024  # sub-block + look-ahead fit 48 KiB of shared memory
MAX_GROUP = 64           # matrices one launch takes (the kernel's table)
ALIGN = 16               # byte alignment of every matrix and output

# one matrix of a group; the layout of ``Desc`` in csrc/digest_sig.cu.
# in_off is in bytes of the input buffer; s_off, t_off and h_off are in
# int32 elements of the output buffer
GROUP_DTYPE = np.dtype([("in_off", "<i8"), ("s_off", "<i8"),
                        ("t_off", "<i8"), ("h_off", "<i8"),
                        ("rows", "<i4"), ("width", "<i4"),
                        ("kblock", "<i4"), ("pad", "<i4")])

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


def _align(x: int, unit: int) -> int:
    return -(-x // unit) * unit


def group_layout(shapes) -> tuple[np.ndarray, int, int]:
    """Descriptor table of a group of matrices, packed in order.

    ``shapes`` is a sequence of ``(rows, width, kblock)``; matrix ``i``
    is ``(rows, width + HPAD)`` uint8. Returns ``(table, in_bytes,
    out_words)``: the :data:`GROUP_DTYPE` table, the input buffer's size
    in bytes and the output buffer's size in int32 words. Every matrix
    and every output starts 16-byte aligned, and no two overlap.
    """
    table = np.zeros(len(shapes), GROUP_DTYPE)
    in_off = out_off = 0
    for e, (rows, width, kblock) in zip(table, shapes):
        if not (0 < width < 1 << 31 and 0 <= rows < 1 << 31
                and 0 < kblock <= width):
            raise ValueError(f"matrix ({rows}, {width}) with block {kblock} "
                             f"does not fit the kernel's table")
        nsb = width // kblock
        e["in_off"] = in_off
        e["s_off"] = out_off
        e["t_off"] = out_off + _align(rows * nsb, ALIGN // 4)
        e["h_off"] = e["t_off"] + _align(rows * nsb, ALIGN // 4)
        e["rows"], e["width"], e["kblock"] = rows, width, kblock
        in_off += _align(rows * (width + HPAD), ALIGN)
        out_off = int(e["h_off"]) + _align(rows * width, ALIGN // 4)
    return table, in_off, out_off


def group_views(out: torch.Tensor | np.ndarray, table: np.ndarray):
    """``(S, T, H)`` views of each table entry's outputs in ``out``."""
    views = []
    for e in table:
        rows, width, kblock = int(e["rows"]), int(e["width"]), int(e["kblock"])
        nsb = width // kblock
        views.append(tuple(
            out[int(e[key]):int(e[key]) + rows * cols].reshape(rows, cols)
            for key, cols in (("s_off", nsb), ("t_off", nsb),
                              ("h_off", width))))
    return views


def _check_group(buf: torch.Tensor, table: np.ndarray, out: torch.Tensor,
                 n: int) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("buf must be a 1-D uint8 tensor")
    if out.dtype != torch.int32 or out.dim() != 1:
        raise ValueError("out must be a 1-D int32 tensor")
    if buf.device != out.device:
        raise ValueError("buf and out must share a device")
    if table.dtype != GROUP_DTYPE or table.ndim != 1:
        raise ValueError("table must be a 1-D GROUP_DTYPE array")
    if not 1 < n <= HPAD + 1:
        raise ValueError(f"need 2 <= n <= {HPAD + 1}, got {n}")
    for e in table:
        rows, width, kblock = int(e["rows"]), int(e["width"]), int(e["kblock"])
        if rows < 0 or kblock <= 0 or kblock % 16 or kblock > _MAX_KBLOCK:
            raise ValueError(f"block must be a multiple of 16 in "
                             f"[16, {_MAX_KBLOCK}], got {kblock}")
        if width <= 0 or width % kblock:
            raise ValueError(f"width {width} must be a positive multiple "
                             f"of block={kblock}")
        nsb = width // kblock
        spans = ((int(e["in_off"]), rows * (width + HPAD), buf.numel(),
                  ALIGN),
                 (int(e["s_off"]), rows * nsb, out.numel(), 1),
                 (int(e["t_off"]), rows * nsb, out.numel(), 1),
                 (int(e["h_off"]), rows * width, out.numel(), ALIGN // 4))
        for off, size, limit, align in spans:
            if off < 0 or off % align or off + size > limit:
                raise ValueError("table entry outside its buffer or "
                                 "misaligned")


@functools.cache
def _entry() -> ctypes._CFuncPtr:
    """The C entry point, resolved and typed once per process."""
    from repro_torch.kernels._build import library

    fn = library("digest_sig").digest_sig_group
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(buf: torch.Tensor, table: np.ndarray, out: torch.Tensor,
            n: int) -> None:
    if not buf.is_contiguous() or buf.data_ptr() % ALIGN:
        raise ValueError("buf must be contiguous and 16-byte aligned")
    if not out.is_contiguous() or out.data_ptr() % ALIGN:
        raise ValueError("out must be contiguous and 16-byte aligned")
    if not 0 < table.size <= MAX_GROUP:
        raise ValueError(f"a group holds 1 to {MAX_GROUP} matrices, got "
                         f"{table.size}")
    units = int((table["rows"].astype(np.int64)
                 * (table["width"] // table["kblock"])).sum())
    if units >= 1 << 31:
        raise ValueError("too many sub-blocks for one launch")
    table = np.ascontiguousarray(table)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(buf.data_ptr(), out.data_ptr(), table.ctypes.data,
                       table.size, n, stream)
    if err:
        raise RuntimeError(f"digest_sig kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    from repro_torch import obs

    obs.registry().counter_add("kernel.digest_sig.launches")


def digest_sig_group(buf: torch.Tensor, table: np.ndarray,
                     out: torch.Tensor, *, n: int) -> None:
    """Sweep every matrix of a group into ``out`` — one launch.

    ``buf`` is a 1-D uint8 tensor holding each ``table`` entry's
    ``(rows, width + HPAD)`` matrix at its ``in_off``; ``out`` a 1-D
    int32 tensor on the same device that receives each entry's S, T and
    H at its offsets (:func:`group_layout` builds a table,
    :func:`group_views` reads the results). On a CUDA tensor one kernel
    launch sweeps the whole group; on a CPU tensor each entry goes
    through :func:`digest_sig_plain`.
    """
    _check_group(buf, table, out, n)
    if buf.device.type == "cuda":
        _launch(buf, table, out, n)
        return
    if buf.device.type != "cpu":
        raise ValueError(f"unsupported device {buf.device}")
    for e, (s, t, h) in zip(table, group_views(out, table)):
        rows, width = int(e["rows"]), int(e["width"])
        off = int(e["in_off"])
        mat = buf[off:off + rows * (width + HPAD)].reshape(rows, width + HPAD)
        for dst, src in zip((s, t, h), digest_sig_plain(
                mat, n=n, block=int(e["kblock"]))):
            dst.copy_(src)


def digest_sig_partials_batch(padded: torch.Tensor, *, n: int,
                              block: int = BLOCK
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Fused per-(row, sub-block) partials over a padded byte matrix.

    ``padded`` is ``(B, W + HPAD)`` uint8 with ``W % block == 0``.
    Returns ``(S, T, H)``: two ``(B, W // block)`` int32 Adler partial
    tensors and the ``(B, W)`` int32 n-gram hash matrix, on ``padded``'s
    device. One launch (a one-entry group) sweeps the whole batch once.
    """
    width = _check(padded, n, block)
    table, _, words = group_layout([(padded.shape[0], width, block)])
    out = torch.empty(words, dtype=torch.int32, device=padded.device)
    digest_sig_group(padded.reshape(-1), table, out, n=n)
    return group_views(out, table)[0]
