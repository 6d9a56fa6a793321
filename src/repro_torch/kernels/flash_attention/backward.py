"""Flash-attention backward kernel: CUDA launch and launch count.

``csrc/flash_attention_bwd.cu`` is the gradient of the forward kernel's
f32 path, recomputed FlashAttention-2 style from the output and each
row's log-sum-exp (:func:`.flash_attention.flash_attention_fwd_lse`):
Δ = rowsum(dO ∘ O), then a dK/dV kernel (one block a 64-key tile and
(batch, KV head), summing the group's query heads in registers, so the
result is deterministic) and a dQ kernel (one block a 64-row query tile
and (batch, head)). f32, fp32 math on CUDA cores, D of 16, 32, 64 or
128, the forward's bottom-right causal mask, Sq != Sk allowed; rows with
no key pass on no gradient.

The reference has no counterpart: it differentiates its jnp
``chunked_attention`` under XLA. The plain version is
:func:`repro_torch.kernels.flash_attention.ref.attention_backward_plain`.
``launches`` counts calls of :func:`flash_attention_backward` that
launched; ``cuda_launches`` adds up the CUDA launches that the C entry
point reports it made for them (Δ, dK/dV and dQ: three a call).
"""
from __future__ import annotations

import ctypes

import torch

from .flash_attention import HEAD_DIMS, check_shapes

__all__ = ["cuda_launches", "flash_attention_backward", "launches"]

launches = 0  # calls that launched the backward kernels in this process
cuda_launches = 0  # CUDA launches those calls made, as the C entry counts
_fn = None


def _entry():
    global _fn
    if _fn is None:
        from repro_torch.kernels._build import library

        fn = library("flash_attention_bwd").flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 6
                       + [ctypes.c_int, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` of attention on one CUDA device: q, o, do
    [B,H,Sq,D], k/v [B,Hkv,Sk,D] float32 (made contiguous here), lse
    [B,H,Sq] float32 from the forward. Does not synchronise."""
    check_shapes(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if any(t.device.type != "cuda" or t.device != q.device
           for t in (k, v, o, lse, do)):
        raise ValueError("every tensor must lie on q's CUDA device")
    if any(t.dtype != torch.float32 for t in (q, o, lse, do)):
        raise ValueError("the backward kernel takes float32 only")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} or lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (one of {HEAD_DIMS})")
    if B * H > 65535:
        raise ValueError(f"batch x heads = {B * H} exceeds 65535")
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _entry()
    made = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Sq,
                 Sk, D, int(bool(causal)), stream, ctypes.byref(made))
    global launches, cuda_launches
    cuda_launches += made.value
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return dq, dk, dv
