"""Public wrapper: GQA attention through the flash-attention kernel.

A CUDA tensor launches the hand-written kernel
(:func:`.flash_attention.flash_attention_bhsd`); a CPU tensor takes the
plain version (:func:`.ref.attention_plain`). Nothing else falls back:
the kernel takes any ``Sq`` and ``Sk``, so unlike the reference's wrapper
there is no quiet detour for shapes that are not multiples of a block,
and a build or launch failure raises. Tiles are the kernel's own (the
reference's ``block_q``/``block_k``/``interpret``/``use_kernel`` have no
counterpart).
"""
from __future__ import annotations

import torch

from .flash_attention import check_shapes, flash_attention_bhsd
from .ref import attention_plain

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention: q [B,H,Sq,D], k/v [B,Hkv,Sk,D] -> [B,H,Sq,D] in q's
    dtype, on q's device."""
    if q.device.type == "cpu":
        check_shapes(q, k, v)
        return attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention_bhsd(q, k, v, causal=causal)
