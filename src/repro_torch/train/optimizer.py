"""AdamW + global-norm clipping + schedules (a copy of the reference's
``repro.train.optimizer`` in PyTorch).

The state mirrors the parameters: ``m`` and ``v`` are dicts keyed by the
port's parameter names (``named_parameters()``), so the state of a layer
leaf is one tensor a layer. :func:`opt_state_to_jax` /
:func:`opt_state_from_jax` carry it to and from the reference's layout
(each layer leaf stacked on ``[n_layers]``), as checkpoints and tests
need. Updates run under ``torch.no_grad()`` and write the parameters in
place; the schedule is computed on the host in float32, as the
reference computes it in its step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.transformer import (map_tree, tensor_tree,
                                            stack_named, to_numpy,
                                            unstack_tree)

__all__ = ["AdamWConfig", "apply_updates", "clip_by_global_norm",
           "global_norm", "init_state", "lr_at", "opt_state_from_jax",
           "opt_state_to_jax", "opt_state_tree"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"       # cosine | constant | linear
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    #: compact optimizer state: momentum as int8 with per-row fp32
    #: scales, second moment as bf16 (the reference's 8-bit-optimizer
    #: style state)
    compact_state: bool = False


def lr_at(cfg: AdamWConfig, step) -> float:
    """Warmup + (cosine | linear | constant) decay at ``step``, in
    float32 as the reference computes it."""
    f32 = np.float32
    step = f32(int(step))
    warm = min(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    frac = f32(np.clip((step - f32(cfg.warmup_steps))
                       / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       f32(0.0), f32(1.0)))
    if cfg.schedule == "cosine":
        decay = f32(cfg.min_lr_ratio) + f32(1 - cfg.min_lr_ratio) * f32(0.5) \
            * (f32(1) + np.cos(f32(math.pi) * frac))
    elif cfg.schedule == "linear":
        decay = f32(1.0) - f32(1 - cfg.min_lr_ratio) * frac
    else:
        decay = f32(1.0)
    return float(f32(cfg.lr) * f32(warm) * f32(decay))


def init_state(params, compact: bool = False) -> dict:
    """Zero moments for ``params`` (a module): ``{"m", "v", "step"}``, or
    with ``compact`` ``{"m_q" int8, "m_scale" f32 per row, "v" bf16,
    "step"}``. ``step`` is a host int."""
    named = dict(params.named_parameters())
    if not compact:
        return {"m": {n: torch.zeros_like(p, dtype=torch.float32)
                      for n, p in named.items()},
                "v": {n: torch.zeros_like(p, dtype=torch.float32)
                      for n, p in named.items()},
                "step": 0}
    return {
        "m_q": {n: torch.zeros(p.shape, dtype=torch.int8, device=p.device)
                for n, p in named.items()},
        "m_scale": {n: torch.zeros(p.shape[:-1] or (1,), dtype=torch.float32,
                                   device=p.device)
                    for n, p in named.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
              for n, p in named.items()},
        "step": 0,
    }


def _m_dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    s = scale if q.dim() == scale.dim() else scale[..., None]
    return q.to(torch.float32) * s


def _m_quant(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = m.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(m / scale[..., None]), -127, 127).to(
        torch.int8)
    if scale.dim() == 0:  # 1-D params: keep the scale rank-1 ((1,) leaves)
        scale = scale.reshape(1)
    return q, scale


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(params, grads: dict, state: dict, cfg: AdamWConfig
                  ) -> tuple[object, dict, dict]:
    """One AdamW step on ``params`` (a module, updated in place) from
    ``grads`` (keyed like ``state``). Returns (params, state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1c = float(1 - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(1 - np.float32(cfg.b2) ** np.float32(step))
    compact = "m_q" in state
    new_m, new_v = {}, {}
    for name, p in params.named_parameters():
        g32 = grads[name].to(torch.float32)
        m = (_m_dequant(state["m_q"][name], state["m_scale"][name])
             if compact else state["m"][name])
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * state["v"][name].to(torch.float32) \
            + (1 - cfg.b2) * g32 * g32
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_m[name], new_v[name] = m_new, v_new
    if compact:
        quantized = {n: _m_quant(m) for n, m in new_m.items()}
        new_state = {"m_q": {n: q for n, (q, _) in quantized.items()},
                     "m_scale": {n: s for n, (_, s) in quantized.items()},
                     "v": {n: v.to(torch.bfloat16) for n, v in new_v.items()},
                     "step": step}
    else:
        new_state = {"m": new_m, "v": new_v, "step": step}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}


def opt_state_tree(state: dict) -> dict:
    """The state in the reference's layout, leaves still tensors: each
    name-keyed dict stacked (:func:`stack_named`), ``step`` a 0-d int32.
    A compact ``m_scale`` of a 1-D layer leaf stacks as the reference's
    ``[n_layers]``, not ``[n_layers, 1]``."""
    out = {}
    for key, val in state.items():
        if key == "step":
            out[key] = torch.tensor(int(val), dtype=torch.int32)
        elif key == "m_scale":
            # a layer's 1-D leaf has a (1,) scale; stacked as a scalar a
            # layer it is the reference's [n_layers]
            out[key] = stack_named({
                n: (sc.reshape(()) if n.startswith("layers.")
                    and state["m_q"][n].dim() == 1 else sc)
                for n, sc in val.items()})
        else:
            out[key] = stack_named(val)
    return out


def opt_state_to_jax(state: dict) -> dict:
    """The state as the reference's tree of numpy arrays."""
    return map_tree(opt_state_tree(state), to_numpy)


def opt_state_from_jax(tree: dict, *,
                       device: "str | torch.device" = "cuda") -> dict:
    """The reference's optimizer state (numpy arrays or tensors) as the
    port's, on ``device``."""
    t = tensor_tree({k: v for k, v in tree.items() if k != "step"})
    out = {}
    for key, val in t.items():
        named = unstack_tree(val)
        if key == "m_scale":  # [n_layers] of a 1-D leaf -> (1,) a layer
            named = {n: s.reshape(1) if s.dim() == 0 else s
                     for n, s in named.items()}
        out[key] = {n: s.contiguous().to(device) for n, s in named.items()}
    out["step"] = int(np.asarray(tree["step"]))
    return out

