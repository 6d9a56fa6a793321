"""The plain version of the flash-attention kernel: exact GQA attention.

Materialises the ``[B, H, Sq, Sk]`` scores in fp32, repeats each KV head
over its ``H // Hkv`` query heads, and masks causally on the bottom-right
diagonal (key ``j`` is kept for query row ``i`` when ``j <= i + Sk - Sq``).

It follows the Pallas kernel (and the CUDA kernel), not the reference's
``attention_ref``, on rows with no key left (causal with ``Sk < Sq``):
masked scores are ``-1e30`` and take no weight, a denominator of 0 is
taken as 1, and such a row is 0 (``attention_ref`` gives NaN there).

On the CPU the math runs in float64 and the result is rounded once to
``q``'s type, so it does not depend on which fp32 matrix-product path the
process's state selects: a reduced-precision fp32 mode (oneDNN's bf16
path on AMX CPUs under ``torch.set_float32_matmul_precision("medium")``)
moved the fp32 result far outside fp32 rounding. On the GPU it is the
kernel's plain version and keeps the kernel's fp32 math.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "attention_plain"]

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,Hkv,Sk,D] -> [B,H,Sq,D] in q's dtype; fp32
    math on the GPU, fp64 on the CPU."""
    H, Sq, D = q.shape[1], q.shape[2], q.shape[3]
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    acc = torch.float64 if q.device.type == "cpu" else torch.float32
    qa = q.to(acc) * (1.0 / math.sqrt(D))
    ka = k.to(acc).repeat_interleave(group, dim=1)
    va = v.to(acc).repeat_interleave(group, dim=1)
    s = torch.matmul(qa, ka.transpose(-1, -2))
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        valid = torch.arange(Sk, device=q.device)[None, :] <= rows
    else:
        valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    return (torch.matmul(p, va) / denom).to(q.dtype)
