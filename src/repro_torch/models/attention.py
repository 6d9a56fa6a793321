"""Attention pieces of the LM: RoPE, chunked attention, the KV cache.

* :func:`apply_rope` — rotary position embedding (``rope_cos_sin`` +
  ``rotate``, so a forward or a decode step builds its tables once for
  all layers).
* :func:`chunked_attention` — the reference's online-softmax attention
  over KV chunks, in PyTorch. It is the parity target the reference's
  model lowers; the port's model runs the flash-attention kernel
  (:mod:`repro_torch.kernels.flash_attention`) instead, so this function
  is kept for the parity tests and is not on the card's path.
* :func:`init_kv_cache` / :func:`cache_update` — the decode cache; the
  reference is functional and returns a new cache, the port writes the
  new K/V in place (no copy of the cache a step) and keeps ``length`` a
  host integer, so a step needs no device-to-host read.
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import resolve_device

__all__ = ["apply_rope", "cache_update", "chunked_attention",
           "init_kv_cache", "rope_cos_sin", "rope_frequencies", "rotate"]


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float = 10000.0,
                     device: torch.device | None = None) -> torch.Tensor:
    exponents = torch.arange(0, d_head, 2, dtype=torch.float32,
                             device=device) / d_head
    return 1.0 / (theta ** exponents)  # [d_head/2]


def rope_cos_sin(positions: torch.Tensor, d_head: int,
                 theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions [S] or [B, S], broadcastable against
    [B, H, S, d_head/2]."""
    freqs = rope_frequencies(d_head, theta, device=positions.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, D/2]
    if angles.dim() == 2:  # [S, D/2] -> broadcast over batch and heads
        angles = angles[None, None]
    else:  # [B, S, D/2]
        angles = angles[:, None]
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Apply precomputed RoPE tables to x [B, H, S, D] (fp32 math)."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [S] or [B, S]."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


# --------------------------------------------------------------------------
# chunked online-softmax attention
# --------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, chunk: int = 1024,
                      kv_offset: int | None = None) -> torch.Tensor:
    """GQA attention without the full score matrix.

    q [B,H,Sq,D], k/v [B,Hkv,Sk,D] -> [B,H,Sq,D]. Walks KV in chunks of
    ``chunk`` with running (max, denom, acc) — the flash recurrence.
    ``kv_offset`` aligns the causal diagonal (defaults to Sk - Sq).
    """
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    offset = Sk - Sq if kv_offset is None else kv_offset
    scale = 1.0 / math.sqrt(D)

    if Sk <= chunk:
        return _attn_block(q, k, v, 0, causal, offset, scale, group)

    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    q32 = q.to(torch.float32) * scale
    rows = offset + torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for k_start in range(0, n_chunks * chunk, chunk):
        kb = k[:, :, k_start:k_start + chunk].to(torch.float32)
        vb = v[:, :, k_start:k_start + chunk].to(torch.float32)
        kb = kb.repeat_interleave(group, dim=1)
        vb = vb.repeat_interleave(group, dim=1)
        s = torch.matmul(q32, kb.transpose(-1, -2))
        cols = k_start + torch.arange(chunk, device=q.device)[None]
        valid = cols < Sk  # padding chunk guard
        if causal:
            valid = valid & (rows >= cols)
        s = torch.where(valid, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.to(q.dtype)


def _attn_block(q, k, v, k_start, causal, offset, scale, group):
    """Single-block exact attention (small Sk fast path)."""
    s = torch.matmul(
        q.to(torch.float32) * scale,
        k.to(torch.float32).repeat_interleave(group, dim=1).transpose(-1, -2))
    if causal:
        rows = offset + torch.arange(s.shape[2], device=q.device)[:, None]
        cols = k_start + torch.arange(s.shape[3], device=q.device)[None]
        s = torch.where(rows >= cols, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(
        p, v.to(torch.float32).repeat_interleave(group, dim=1))
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# KV cache (decode path)
# --------------------------------------------------------------------------

def init_kv_cache(n_layers: int, batch: int, n_kv_heads: int, max_seq: int,
                  d_head: int, dtype: torch.dtype = torch.bfloat16, *,
                  device: "str | torch.device" = "cuda") -> dict:
    dev = resolve_device(device)
    shape = (n_layers, batch, n_kv_heads, max_seq, d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "length": 0}


def cache_update(cache: dict, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> dict:
    """Write [B, Hkv, 1, D] at the current length of ``layer``, in place."""
    idx = cache["length"]
    if idx >= cache["k"].shape[3]:
        raise ValueError(f"KV cache is full ({idx} positions)")
    cache["k"][layer, :, :, idx] = k_new[:, :, 0]
    cache["v"][layer, :, :, idx] = v_new[:, :, 0]
    return cache
