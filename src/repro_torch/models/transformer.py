"""Decoder-only transformer LM (dense, GQA + RoPE) for serving.

The reference stacks every layer leaf on a leading ``n_layers`` axis and
scans over it; here the layers are an ``nn.ModuleList`` of :class:`Layer`
modules, applied in a Python loop. The module-level functions keep the
reference's names so a reader finds the counterparts:

  * :func:`forward`      — logits for teacher forcing ([B,S] tokens)
  * :func:`decode_step`  — one-token serve step against a KV cache
  * :func:`init_cache`   — the decode cache

Attention runs through the hand-written flash-attention kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`) in both:
prefill is causal with ``Sq == Sk``; a decode step attends its one query
row over the cache's first ``length + 1`` positions, where the kernel's
bottom-right causal offset ``Sk - Sq`` keeps every one of them.

MoE configurations raise ``NotImplementedError`` (they come with
``models/moe.py``); ``loss_fn``/``fused_ce_loss`` wait for training.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from .attention import cache_update, init_kv_cache, rope_cos_sin, rotate
from .common import (Dense, RMSNorm, SwiGLU, dense, dense_init, embed_init,
                     frozen, rmsnorm, rmsnorm_init, swiglu, swiglu_init)

__all__ = ["Layer", "Transformer", "TransformerConfig", "decode_step",
           "forward", "forward_hidden", "init_cache", "init_params",
           "params_from_jax"]


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    moe_experts: int = 0           # 0 = dense FFN
    moe_top_k: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    dtype: str = "float32"
    remat: bool = True
    attn_chunk: int = 1024
    attn_unroll: bool = False    # dry-run: unroll the KV-chunk scan
    layers_unroll: bool = False  # dry-run delta compiles: unroll layer scan
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    train_microbatches: int = 1  # grad-accumulation splits of global batch
    compact_opt_state: bool = False  # int8/bf16 Adam state (8-bit-optimizer)
    grad_accum_dtype: str = "float32"  # microbatch grad accumulator dtype

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def scaled(self, **kw) -> "TransformerConfig":
        return replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (no allocation)."""
        d, dh = self.d_model, self.d_head
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * dh
        if self.is_moe:
            ffn = d * self.moe_experts \
                + 3 * self.moe_experts * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.vocab * d * 2 + self.n_layers * per_layer + d


def _dense_only(is_moe: bool) -> None:
    if is_moe:
        raise NotImplementedError(
            "MoE configurations are not ported yet (models/moe.py)")


class Layer(nn.Module):
    """One transformer layer: attention (``ln1``, ``wq``, ``wk``, ``wv``,
    ``wo``) and a SwiGLU FFN (``ln2``, ``mlp``)."""

    def __init__(self, ln1: RMSNorm, ln2: RMSNorm, wq: Dense, wk: Dense,
                 wv: Dense, wo: Dense, mlp: SwiGLU):
        super().__init__()
        self.ln1, self.ln2 = ln1, ln2
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.mlp = mlp


class Transformer(nn.Module):
    """The parameters of the LM: ``embed`` [vocab, d], ``layers``,
    ``ln_f``, ``lm_head`` (the reference's tree, one module a layer)."""

    def __init__(self, embed: torch.Tensor, layers: list[Layer],
                 ln_f: RMSNorm, lm_head: Dense):
        super().__init__()
        self.embed = frozen(embed)
        self.layers = nn.ModuleList(layers)
        self.ln_f = ln_f
        self.lm_head = lm_head

    @property
    def device(self) -> torch.device:
        return self.embed.device


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _layer_init(cfg: TransformerConfig, g: torch.Generator) -> Layer:
    dt = cfg.torch_dtype
    d, dh = cfg.d_model, cfg.d_head
    return Layer(
        ln1=rmsnorm_init(d, dt), ln2=rmsnorm_init(d, dt),
        wq=dense_init(d, cfg.n_heads * dh, generator=g, dtype=dt,
                      bias=cfg.qkv_bias),
        wk=dense_init(d, cfg.n_kv_heads * dh, generator=g, dtype=dt,
                      bias=cfg.qkv_bias),
        wv=dense_init(d, cfg.n_kv_heads * dh, generator=g, dtype=dt,
                      bias=cfg.qkv_bias),
        wo=dense_init(cfg.n_heads * dh, d, generator=g, dtype=dt),
        mlp=swiglu_init(d, cfg.d_ff, generator=g, dtype=dt))


def init_params(cfg: TransformerConfig, *, generator: torch.Generator,
                device: "str | torch.device" = "cuda") -> Transformer:
    """Seeded parameters from a CPU ``generator``, moved to ``device``."""
    dev = resolve_device(device)
    _dense_only(cfg.is_moe)
    dt = cfg.torch_dtype
    embed = embed_init(cfg.vocab, cfg.d_model, generator=generator, dtype=dt)
    layers = [_layer_init(cfg, generator) for _ in range(cfg.n_layers)]
    head = dense_init(cfg.d_model, cfg.vocab, generator=generator, dtype=dt)
    return Transformer(embed, layers, rmsnorm_init(cfg.d_model, dt),
                       head).to(dev)


def _tensors(tree: dict) -> dict:
    """``tree`` with every leaf (numpy array, ml_dtypes bf16 array or
    tensor) as a CPU tensor; numpy leaves are copied."""
    out = {}
    for key, a in tree.items():
        if isinstance(a, dict):
            out[key] = _tensors(a)
        elif isinstance(a, torch.Tensor):
            out[key] = a
        else:
            arr = np.asarray(a)
            if arr.dtype.name == "bfloat16":  # ml_dtypes: keep the bits
                out[key] = torch.from_numpy(arr.view(np.uint16).copy()).view(
                    torch.bfloat16)
            else:
                out[key] = torch.from_numpy(np.array(arr))
    return out


def _dense_from(p: dict, i: int | None = None) -> Dense:
    w, b = p["w"], p.get("b")
    if i is not None:
        w, b = w[i], (b[i] if b is not None else None)
    return Dense(w, b)


def params_from_jax(tree: dict, *,
                    device: "str | torch.device" = "cuda") -> Transformer:
    """The reference's parameter tree (numpy arrays, or tensors) as the
    port's :class:`Transformer` on ``device``.

    ``tree["layers"]`` holds every layer leaf stacked on a leading
    ``[n_layers]`` axis; it is unstacked into one :class:`Layer` each.
    Dense weights keep their ``[d_in, d_out]`` layout unchanged.
    """
    dev = resolve_device(device)
    t = _tensors(tree)
    lt = t["layers"]
    _dense_only("moe" in lt)
    layers = [Layer(ln1=RMSNorm(lt["ln1"]["scale"][i]),
                    ln2=RMSNorm(lt["ln2"]["scale"][i]),
                    wq=_dense_from(lt["wq"], i), wk=_dense_from(lt["wk"], i),
                    wv=_dense_from(lt["wv"], i), wo=_dense_from(lt["wo"], i),
                    mlp=SwiGLU(_dense_from(lt["mlp"]["gate"], i),
                               _dense_from(lt["mlp"]["up"], i),
                               _dense_from(lt["mlp"]["down"], i)))
              for i in range(lt["ln1"]["scale"].shape[0])]
    return Transformer(t["embed"], layers, RMSNorm(t["ln_f"]["scale"]),
                       _dense_from(t["lm_head"])).to(dev)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _attention_block(lp: Layer, x: torch.Tensor, cfg: TransformerConfig,
                     cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    h = rmsnorm(lp.ln1, x)
    q = dense(lp.wq, h).view(B, S, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k = dense(lp.wk, h).view(B, S, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    v = dense(lp.wv, h).view(B, S, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    q = rotate(q, cos, sin)
    k = rotate(k, cos, sin)
    # the reference calls chunked_attention here; the kernel computes the
    # same function (v keeps its strided [B, S, Hkv, D] layout: no copy)
    o = flash_attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.d_head)
    return x + dense(lp.wo, o)


def _ffn_block(lp: Layer, x: torch.Tensor) -> torch.Tensor:
    return x + swiglu(lp.mlp, rmsnorm(lp.ln2, x))


def forward_hidden(params: Transformer, tokens, cfg: TransformerConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden [B, S, d], aux_loss = 0)."""
    _dense_only(cfg.is_moe)
    dev = params.device
    tokens = torch.as_tensor(tokens, device=dev)
    S = tokens.shape[1]
    x = params.embed[tokens]
    cos, sin = rope_cos_sin(torch.arange(S, device=dev), cfg.d_head,
                            cfg.rope_theta)
    for lp in params.layers:
        x = _attention_block(lp, x, cfg, cos, sin)
        x = _ffn_block(lp, x)
    return (rmsnorm(params.ln_f, x),
            torch.zeros((), dtype=torch.float32, device=dev))


def forward(params: Transformer, tokens, cfg: TransformerConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux_loss = 0)."""
    x, aux = forward_hidden(params, tokens, cfg)
    return dense(params.lm_head, x), aux


# --------------------------------------------------------------------------
# decode (serve path)
# --------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype: torch.dtype | None = None, *,
               device: "str | torch.device" = "cuda") -> dict:
    """``{"k", "v"}`` zeros of [n_layers, B, Hkv, max_seq, d_head] and
    ``"length"``, a host integer."""
    return init_kv_cache(cfg.n_layers, batch, cfg.n_kv_heads, max_seq,
                         cfg.d_head, dtype or cfg.torch_dtype, device=device)


def decode_step(params: Transformer, cache: dict, token: torch.Tensor,
                cfg: TransformerConfig) -> tuple[torch.Tensor, dict]:
    """One decode step: token [B] -> (logits [B, V], the cache).

    The new K/V are written in place at ``cache["length"]`` (the
    reference returns a new cache; the port saves the copy), then each
    layer attends its query over the first ``length + 1`` cached
    positions through the flash kernel. ``length`` advances by one.

    Past a full cache (``length >= max_seq``) the step does what the
    reference's one-hot insert does: it writes nothing, attends over all
    ``max_seq`` cached positions, keeps RoPE at the true position
    ``length`` and still advances ``length``.
    """
    _dense_only(cfg.is_moe)
    B = token.shape[0]
    idx = cache["length"]
    full = idx >= cache["k"].shape[3]
    kv_len = cache["k"].shape[3] if full else idx + 1
    x = params.embed[token][:, None, :]                    # [B, 1, d]
    cos, sin = rope_cos_sin(
        torch.full((1,), idx, dtype=torch.int64, device=params.device),
        cfg.d_head, cfg.rope_theta)
    cdt = cache["k"].dtype
    for layer, lp in enumerate(params.layers):
        h = rmsnorm(lp.ln1, x)
        q = dense(lp.wq, h).view(B, 1, cfg.n_heads, cfg.d_head).transpose(1, 2)
        k = dense(lp.wk, h).view(B, 1, cfg.n_kv_heads,
                                 cfg.d_head).transpose(1, 2)
        v = dense(lp.wv, h).view(B, 1, cfg.n_kv_heads,
                                 cfg.d_head).transpose(1, 2)
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)
        if not full:
            cache_update(cache, layer, k.to(cdt), v.to(cdt))
        o = flash_attention(q.to(cdt), cache["k"][layer, :, :, :kv_len],
                            cache["v"][layer, :, :, :kv_len], causal=True)
        o = o.to(x.dtype).transpose(1, 2).reshape(
            B, 1, cfg.n_heads * cfg.d_head)
        x = x + dense(lp.wo, o)
        x = _ffn_block(lp, x)
    x = rmsnorm(params.ln_f, x)
    logits = dense(params.lm_head, x)[:, 0]
    cache["length"] = idx + 1
    return logits, cache
