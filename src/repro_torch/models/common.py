"""Shared layers and their initialisers (``nn.Module`` containers).

The reference keeps parameters as dict pytrees; here each layer is a
small ``nn.Module`` container holding the same leaves under the same
names (``Dense.w``/``Dense.b``, ``RMSNorm.scale``, ``SwiGLU.gate``/
``up``/``down``), and the module-level functions (``dense``,
``rmsnorm``, ``swiglu``) apply them with the reference's math. Dense weights keep the reference's ``[d_in, d_out]``
layout, so ``dense`` is ``x @ w (+ b)`` and a JAX tree carries across
unchanged. Parameters are created with ``requires_grad=False``, so
serving builds no graph; training turns grad on for them
(:func:`repro_torch.train.step.init_train_state`).

Initialisers take an explicit ``torch.Generator`` and draw from the
reference's distributions (dense: uniform ±1/√d_in, embedding:
N(0, 0.02²), norm scales: 1) on the generator's device: with a CUDA
generator every leaf is made on the card, so a full-width model is never
whole on the host. The same seed gives other bits on another device.
They do not reproduce ``jax.random``'s bits; tests carry the reference's
own parameters across instead
(:func:`repro_torch.models.transformer.params_from_jax`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "RMSNorm", "SwiGLU", "dense", "dense_init",
           "embed_init", "frozen", "rmsnorm", "rmsnorm_init", "swiglu",
           "swiglu_init", "uniform_init"]


def frozen(t: torch.Tensor) -> nn.Parameter:
    """``t`` as a parameter that autograd does not track."""
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` of shape ``[d_in, d_out]``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = frozen(w)
        self.b = frozen(b) if b is not None else None


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = frozen(scale)


class SwiGLU(nn.Module):
    """LLaMA-style gated MLP: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, gate: Dense, up: Dense, down: Dense):
        super().__init__()
        self.gate, self.up, self.down = gate, up, down


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def uniform_init(shape: tuple, scale: float, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform ±``scale`` of ``shape``, drawn in f32 on the generator's
    device and cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return w.uniform_(-scale, scale, generator=generator).to(dtype)


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               dtype: torch.dtype = torch.float32,
               bias: bool = False) -> Dense:
    w = uniform_init((d_in, d_out), 1.0 / math.sqrt(d_in),
                     generator=generator, dtype=dtype)
    b = (torch.zeros((d_out,), dtype=dtype, device=generator.device)
         if bias else None)
    return Dense(w, b)


def embed_init(vocab: int, dim: int, *, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    e = torch.randn((vocab, dim), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return e.mul_(0.02).to(dtype)


def rmsnorm_init(dim: int, dtype: torch.dtype = torch.float32,
                 device: "str | torch.device" = "cpu") -> RMSNorm:
    return RMSNorm(torch.ones((dim,), dtype=dtype, device=device))


def swiglu_init(d_model: int, d_ff: int, *, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> SwiGLU:
    return SwiGLU(dense_init(d_model, d_ff, generator=generator, dtype=dtype),
                  dense_init(d_model, d_ff, generator=generator, dtype=dtype),
                  dense_init(d_ff, d_model, generator=generator, dtype=dtype))


# --------------------------------------------------------------------------
# layer applications
# --------------------------------------------------------------------------

def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p.w)
    if p.b is not None:
        y = y + p.b
    return y


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation in fp32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p.scale.to(torch.float32)).to(dt)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return dense(p.down, F.silu(dense(p.gate, x)) * dense(p.up, x))
