"""The plain versions of the flash-attention kernels: exact GQA attention
and its gradient.

Materialises the ``[B, H, Sq, Sk]`` scores, repeats each KV head over its
``H // Hkv`` query heads, and masks causally on the bottom-right diagonal
(key ``j`` is kept for query row ``i`` when ``j <= i + Sk - Sq``).

It follows the Pallas kernel (and the CUDA kernel), not the reference's
``attention_ref``, on rows with no key left (causal with ``Sk < Sq``):
masked scores are ``-1e30`` and take no weight, a denominator of 0 is
taken as 1, and such a row is 0 (``attention_ref`` gives NaN there). Its
log-sum-exp is :data:`LSE_EMPTY`, and it sends no gradient anywhere.

On the CPU the math runs in float64 and the result is rounded once to
``q``'s type, so it does not depend on which fp32 matrix-product path the
process's state selects: a reduced-precision fp32 mode (oneDNN's bf16
path on AMX CPUs under ``torch.set_float32_matmul_precision("medium")``)
moved the fp32 result far outside fp32 rounding. On the GPU it is the
kernels' plain version and keeps their fp32 math.
"""
from __future__ import annotations

import math

import torch

__all__ = ["LSE_EMPTY", "NEG_INF", "attention_backward_plain",
           "attention_plain"]

NEG_INF = -1e30
#: log-sum-exp of a row with no key: ``exp(s - LSE_EMPTY)`` is 0 for any
#: score, so such a row gets no probability and passes on no gradient
LSE_EMPTY = 1e30


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """(scaled scores [B,H,Sq,Sk] in the math type, valid mask [Sq,Sk],
    the math type, the GQA group)."""
    H, Sq, D = q.shape[1], q.shape[2], q.shape[3]
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    acc = torch.float64 if q.device.type == "cpu" else torch.float32
    qa = q.to(acc) * (1.0 / math.sqrt(D))
    ka = k.to(acc).repeat_interleave(group, dim=1)
    s = torch.matmul(qa, ka.transpose(-1, -2))
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        valid = torch.arange(Sk, device=q.device)[None, :] <= rows
    else:
        valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    return torch.where(valid, s, NEG_INF), valid, acc, group


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q [B,H,Sq,D], k/v [B,Hkv,Sk,D] -> [B,H,Sq,D] in q's dtype; fp32
    math on the GPU, fp64 on the CPU. With ``return_lse`` also the
    log-sum-exp of each row's scaled scores, ``[B, H, Sq]`` float32
    (:data:`LSE_EMPTY` on rows with no key), as the kernel writes it."""
    s, valid, acc, group = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    empty = denom == 0.0
    denom = torch.where(empty, 1.0, denom)
    va = v.to(acc).repeat_interleave(group, dim=1)
    out = (torch.matmul(p, va) / denom).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(empty, LSE_EMPTY, m + torch.log(denom))[..., 0]
    return out, lse.to(torch.float32)


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_plain` from its output ``o``, its
    log-sum-exp ``lse`` and the output's gradient ``do``, by the explicit
    formulas (scale = 1 / sqrt(D), G = H // Hkv)::

        P  = exp(scale q k^T - lse)   (0 where masked)
        dv = sum over the group's heads of P^T do
        dS = P * (do v^T - rowsum(do * o))
        dq = scale dS k,   dk = sum over the group's heads of scale dS^T q

    fp64 on the CPU, fp32 on the GPU; each gradient in its input's dtype.
    """
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    s, valid, acc, group = _scores(q, k, causal)
    scale = 1.0 / math.sqrt(D)
    p = torch.where(valid, torch.exp(s - lse.to(acc)[..., None]), 0.0)
    doa, oa = do.to(acc), o.to(acc)
    ka = k.to(acc).repeat_interleave(group, dim=1)
    va = v.to(acc).repeat_interleave(group, dim=1)
    delta = (doa * oa).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(doa, va.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, ka) * scale
    dk = (torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale).view(
        B, Hkv, group, Sk, D).sum(dim=2)
    dv = torch.matmul(p.transpose(-1, -2), doa).view(
        B, Hkv, group, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
