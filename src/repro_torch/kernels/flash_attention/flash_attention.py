"""Flash-attention kernel: CUDA launch and launch count.

``csrc/flash_attention.cu`` is blocked GQA attention with an online
softmax, the counterpart of the reference's Pallas
``flash_attention_bhsd``: fp32 math over f32 or bf16 inputs, the causal
diagonal aligned bottom-right (offset ``Sk - Sq``), rows with no key left
written as 0. It takes any ``Sq`` and ``Sk`` (masks inside the kernel, no
padding), ``D`` of 64 or 128, and strided batch, head and sequence axes
(the KV cache's ``[..., :length, :]`` views need no copy); the last axis
is contiguous.

:func:`flash_attention_bhsd` launches it for CUDA tensors and raises for
anything it does not take; the plain version for CPU tensors is
:func:`repro_torch.kernels.flash_attention.ref.attention_plain`, chosen by
:func:`repro_torch.kernels.flash_attention.flash_attention`. ``launches``
counts CUDA launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["HEAD_DIMS", "check_shapes", "flash_attention_bhsd", "launches"]

HEAD_DIMS = (64, 128)  # the kernel's template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # CUDA launches of the kernel in this process


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless q [B,H,Sq,D], k/v [B,Hkv,Sk,D] agree."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D [batch, heads, seq, dim]")
    B, H, Sq, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {Hkv}")
    if B < 1 or Sq < 1 or Sk < 1:
        raise ValueError("batch, Sq and Sk must be positive")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on q [B,H,Sq,D], k/v [B,Hkv,Sk,D] (all on one
    CUDA device); returns a new contiguous [B,H,Sq,D] in q's dtype. Does
    not synchronise."""
    from repro_torch.kernels._build import library

    check_shapes(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (one of {HEAD_DIMS})")
    if B * Hkv > 65535:
        raise ValueError(f"batch x kv heads = {B * Hkv} exceeds 65535")
    align = 16 if q.dtype == torch.float32 else 8
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
        st = t.stride()[:3]
        if any(s % 4 for s in st) or t.data_ptr() % align:
            raise ValueError(f"{name} needs strides that are multiples of 4 "
                             f"and a {align}-byte aligned start")
        strides += st
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    fn = library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    st_arr = (ctypes.c_int64 * 9)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, Hkv, Sq, Sk, D, _DTYPES[q.dtype], int(bool(causal)),
                 ctypes.cast(st_arr, ctypes.c_void_p), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out
