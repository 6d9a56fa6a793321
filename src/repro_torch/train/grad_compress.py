"""Error-feedback int8 gradient compression (a copy of the reference's
``repro.train.grad_compress`` transform).

Each gradient leaf is quantized to int8 with one per-leaf scale, the
quantization residual carried into the next step [Seide et al.,
Interspeech'14; Karimireddy et al., arXiv:1901.09847]. Trees are dicts
keyed by the port's parameter names. The collective that carries the
int8 payload across devices (the reference's ``compressed_psum``) waits
for the multi-device slice (ROADMAP item 6).
"""
from __future__ import annotations

import torch

__all__ = ["dequantize", "ef_compress_tree", "init_error_state", "quantize"]


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads: dict, errors: dict) -> tuple[dict, dict]:
    """Error-feedback compression over a gradient dict: returns
    (decompressed grads, new errors); the decompressed grads are what
    the wire would carry, the errors accumulate the residual."""
    out, new_err = {}, {}
    for name, g in grads.items():
        target = g.to(torch.float32) + errors[name]
        deq = dequantize(*quantize(target))
        out[name] = deq.to(g.dtype)
        new_err[name] = target - deq
    return out, new_err


def init_error_state(params) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()}
