"""Adler-32 partials kernel: CUDA launch, plain PyTorch version, launch count.

Adler-32 decomposes into two reductions. With ``b`` the bytes and
``n = len(b)``::

    A = 1 + Σ b_i                      (mod 65521)
    B = n + Σ (n - i) · b_i            (mod 65521, i zero-based)

Per block ``j`` at offset ``o_j`` of ``BLOCK`` bytes the kernel emits

    S_j = Σ_t b_{o_j+t}              (plain sum)
    T_j = Σ_t t · b_{o_j+t}          (dot with the in-block offset)

and the host combines ``B = n + Σ_j [(n − o_j)·S_j − T_j]`` (mod 65521),
see :func:`repro_torch.kernels.adler32.ops.combine_partials`. Blocks of
2048 bytes keep ``T_j < 2³¹`` (2048·2047/2·255 ≈ 5.3e8), so no modulo is
needed inside the kernel. Rows are zero-padded: zero bytes add nothing to
either sum.

:func:`adler32_partials_batch` launches ``csrc/adler32.cu`` for a CUDA
tensor and uses :func:`adler32_plain` for a CPU tensor; any other device
raises. ``launches`` counts CUDA launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["BLOCK", "MOD", "adler32_partials_batch", "adler32_plain",
           "launches"]

BLOCK = 2048  # T_j < 2048·2047/2·255 < 2³¹
MOD = 65521

launches = 0  # CUDA launches of the kernel in this process


def _check(padded: torch.Tensor) -> int:
    """Validate the kernel's input; returns the block count per row."""
    if padded.dtype != torch.uint8 or padded.dim() != 2:
        raise ValueError("padded must be a 2-D uint8 tensor")
    width = padded.shape[1]
    if width <= 0 or width % BLOCK:
        raise ValueError(f"padded width {width} must be a positive multiple "
                         f"of {BLOCK}")
    return width // BLOCK


def adler32_plain(padded: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version in int64 arithmetic."""
    nblocks = _check(padded)
    seg = padded.to(torch.int64).reshape(padded.shape[0], nblocks, BLOCK)
    iota = torch.arange(BLOCK, dtype=torch.int64, device=padded.device)
    return (seg.sum(dim=2).to(torch.int32),
            (seg * iota).sum(dim=2).to(torch.int32))


def _launch(padded: torch.Tensor, nblocks: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.kernels._build import library

    if not padded.is_contiguous() or padded.data_ptr() % 16:
        raise ValueError("padded must be contiguous and 16-byte aligned")
    fn = library("adler32").adler32_partials_batch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows, width = padded.shape
    s = torch.empty((rows, nblocks), dtype=torch.int32, device=padded.device)
    t = torch.empty((rows, nblocks), dtype=torch.int32, device=padded.device)
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(padded.data_ptr(), s.data_ptr(), t.data_ptr(), rows, width,
                 stream)
    if err:
        raise RuntimeError(f"adler32 kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return s, t


def adler32_partials_batch(padded: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, block) ``(S, T)`` int32 partials over a padded byte matrix.

    ``padded`` is ``(B, W)`` uint8 with ``W % BLOCK == 0``; returns two
    ``(B, W // BLOCK)`` int32 tensors on ``padded``'s device. One launch
    covers the whole batch.
    """
    nblocks = _check(padded)
    if padded.device.type == "cpu":
        return adler32_plain(padded)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    return _launch(padded, nblocks)
