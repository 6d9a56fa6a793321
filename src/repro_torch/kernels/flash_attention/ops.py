"""Public wrapper: GQA attention through the flash-attention kernel.

A CUDA tensor launches the hand-written kernel
(:func:`.flash_attention.flash_attention_bhsd`); a CPU tensor takes the
plain version (:func:`.ref.attention_plain`). Nothing else falls back:
the kernel takes any ``Sq`` and ``Sk``, so unlike the reference's wrapper
there is no quiet detour for shapes that are not multiples of a block,
and a build or launch failure raises. Tiles are the kernel's own (the
reference's ``block_q``/``block_k``/``interpret``/``use_kernel`` have no
counterpart).

With grad enabled and an input that requires it, the call goes through
:class:`FlashAttentionFn`: on CUDA its forward is the kernel's f32 path
with the log-sum-exp kept (:func:`.flash_attention.flash_attention_fwd_lse`)
and its backward the hand-written backward kernel
(:func:`.backward.flash_attention_backward`); on the CPU both are the
plain versions. Inference calls (decode, bf16, the engine) keep the
dispatch above.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import backward as _bwd
from . import flash_attention as _fwd
from .flash_attention import check_shapes, flash_attention_bhsd
from .ref import attention_backward_plain, attention_plain

__all__ = ["FlashAttentionFn", "flash_attention"]


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: f32 (or float64 on the CPU) only."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if q.device.type == "cpu":
            out, lse = attention_plain(q, k, v, causal=causal,
                                       return_lse=True)
        else:
            out, lse = _fwd.flash_attention_fwd_lse(q, k, v, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = attention_backward_plain(q, k, v, out, lse, do,
                                             ctx.causal)
        else:
            grads = _bwd.flash_attention_backward(q, k, v, out, lse, do,
                                                  causal=ctx.causal)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention: q [B,H,Sq,D], k/v [B,Hkv,Sk,D] -> [B,H,Sq,D] in q's
    dtype, on q's device; differentiable when grad is enabled and an
    input requires it."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        check_shapes(q, k, v)
        if q.dtype == torch.bfloat16:
            raise NotImplementedError(
                "attention with a gradient takes float32: bf16 training "
                "waits for ROADMAP's bf16-training item (#7's bf16 lse "
                "and a bf16 backward)")
        return FlashAttentionFn.apply(q, k, v, causal)
    if q.device.type == "cpu":
        check_shapes(q, k, v)
        return attention_plain(q, k, v, causal=causal)
    return flash_attention_bhsd(q, k, v, causal=causal)
