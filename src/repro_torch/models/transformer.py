"""Decoder-only transformer LM (dense or MoE, GQA + RoPE): serving and
training.

The reference stacks every layer leaf on a leading ``n_layers`` axis and
scans over it; here the layers are an ``nn.ModuleList`` of :class:`Layer`
modules, applied in a Python loop. The module-level functions keep the
reference's names so a reader finds the counterparts:

  * :func:`forward`      — logits for teacher forcing ([B,S] tokens)
  * :func:`loss_fn`      — next-token CE through :func:`fused_ce_loss`
  * :func:`decode_step`  — one-token serve step against a KV cache
  * :func:`init_cache`   — the decode cache

Attention runs through the hand-written flash-attention kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`) in both:
prefill is causal with ``Sq == Sk``; a decode step attends its one query
row over the cache's first ``length + 1`` positions, where the kernel's
bottom-right causal offset ``Sk - Sq`` keeps every one of them.

With grad enabled (training), the flash call takes its autograd path:
the forward keeps each row's log-sum-exp and the backward is the
hand-written backward kernel. ``cfg.remat`` recomputes each layer in the
backward (``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint`` of its scanned layer does; the recompute launches the
forward kernel again.

Parameters stay one leaf a layer; :func:`stack_named` and
:func:`unstack_tree` map them (and any tree keyed like them: optimizer
moments, error-feedback state) to and from the reference's layout, every
layer leaf stacked on ``[n_layers]`` (:func:`params_to_jax`,
:func:`params_from_jax`).

A MoE configuration's layers hold ``moe`` (:mod:`.moe`, the reference's
grouped capacity dispatch) where a dense one's hold ``mlp``; ``forward``
returns the reference's aux loss, the mean of the layers' Switch losses,
and a decode step routes its batch with ``capacity_factor`` at least 2.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from .attention import cache_update, init_kv_cache, rope_cos_sin, rotate
from .common import (Dense, RMSNorm, SwiGLU, dense, dense_init, embed_init,
                     frozen, rmsnorm, rmsnorm_init, swiglu, swiglu_init)
from .moe import MoE, moe_apply, moe_init

__all__ = ["Layer", "Transformer", "TransformerConfig", "decode_step",
           "forward", "forward_hidden", "fused_ce_loss", "init_cache",
           "init_params", "loss_fn", "map_tree", "params_from_jax",
           "params_to_jax", "stack_named", "tensor_tree", "to_numpy",
           "unstack_tree"]


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

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k of E experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dh = self.d_head
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        ffn_active = d * self.moe_experts + 3 * self.moe_top_k * d * self.d_ff
        per_layer = attn + ffn_active + 2 * d
        return self.vocab * d * 2 + self.n_layers * per_layer + d


class Layer(nn.Module):
    """One transformer layer: attention (``ln1``, ``wq``, ``wk``, ``wv``,
    ``wo``) and an FFN (``ln2`` and either a SwiGLU ``mlp`` or a mixture
    of experts ``moe``)."""

    def __init__(self, ln1: RMSNorm, ln2: RMSNorm, wq: Dense, wk: Dense,
                 wv: Dense, wo: Dense, mlp: SwiGLU | None = None,
                 moe: MoE | None = None):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a layer holds one FFN: mlp or moe")
        self.ln1, self.ln2 = ln1, ln2
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        if mlp is not None:
            self.mlp = mlp
        else:
            self.moe = moe


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
    if cfg.is_moe:
        ffn = {"moe": moe_init(d, cfg.d_ff, cfg.moe_experts, generator=g,
                               dtype=dt)}
    else:
        ffn = {"mlp": swiglu_init(d, cfg.d_ff, generator=g, dtype=dt)}
    return Layer(
        ln1=rmsnorm_init(d, dt, g.device), ln2=rmsnorm_init(d, dt, g.device),
        wq=dense_init(d, cfg.n_heads * dh, generator=g, dtype=dt,
                      bias=cfg.qkv_bias),
        wk=dense_init(d, cfg.n_kv_heads * dh, generator=g, dtype=dt,
                      bias=cfg.qkv_bias),
        wv=dense_init(d, cfg.n_kv_heads * dh, generator=g, dtype=dt,
                      bias=cfg.qkv_bias),
        wo=dense_init(cfg.n_heads * dh, d, generator=g, dtype=dt),
        **ffn)


def init_params(cfg: TransformerConfig, *, generator: torch.Generator,
                device: "str | torch.device" = "cuda") -> Transformer:
    """Seeded parameters, each leaf drawn on ``generator``'s device (a
    CUDA generator makes the model on the card, never whole on the
    host), then moved to ``device``."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    embed = embed_init(cfg.vocab, cfg.d_model, generator=generator, dtype=dt)
    layers = [_layer_init(cfg, generator) for _ in range(cfg.n_layers)]
    head = dense_init(cfg.d_model, cfg.vocab, generator=generator, dtype=dt)
    return Transformer(embed, layers,
                       rmsnorm_init(cfg.d_model, dt, generator.device),
                       head).to(dev)


def tensor_tree(tree: dict) -> dict:
    """``tree`` with every leaf (numpy array, ml_dtypes bf16 array or
    tensor) as a CPU tensor; numpy leaves are copied."""
    out = {}
    for key, a in tree.items():
        if isinstance(a, dict):
            out[key] = tensor_tree(a)
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


def _put(tree: dict, path: list[str], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def stack_named(named: dict) -> dict:
    """Leaves keyed by the port's parameter names (``"embed"``,
    ``"layers.3.wq.w"``, ``"ln_f.scale"``, ...) as the reference's tree:
    nested dicts, each ``layers.<i>.<path>`` leaf stacked over ``i`` on a
    leading ``[n_layers]`` axis at ``["layers"][<path>]``."""
    tree: dict = {}
    per_layer: dict[tuple, dict[int, torch.Tensor]] = {}
    for name, leaf in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(tuple(parts[2:]), {})[int(parts[1])] = leaf
        else:
            _put(tree, parts, leaf)
    for path, by_layer in per_layer.items():
        _put(tree, ["layers", *path],
             torch.stack([by_layer[i] for i in range(len(by_layer))]))
    return tree


def unstack_tree(tree: dict) -> dict:
    """Inverse of :func:`stack_named`: ``name -> leaf`` (the layer leaves
    as views of the stacked ones)."""
    out: dict = {}

    def walk(node: dict, prefix: list[str]) -> None:
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + [key])
            elif prefix[:1] == ["layers"]:
                for i in range(val.shape[0]):
                    out[".".join(["layers", str(i), *prefix[1:], key])] = val[i]
            else:
                out[".".join(prefix + [key])] = val

    walk(tree, [])
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (bfloat16 as ``ml_dtypes.bfloat16``,
    imported only for such a leaf)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_to_jax(params: Transformer) -> dict:
    """The port's parameters as the reference's tree of numpy arrays
    (layer leaves stacked on ``[n_layers]``): the inverse of
    :func:`params_from_jax`."""
    tree = stack_named({n: p.detach()
                        for n, p in params.named_parameters()})
    return map_tree(tree, to_numpy)


def map_tree(tree: dict, fn) -> dict:
    """``tree`` (nested dicts) with ``fn`` applied to every leaf."""
    return {k: map_tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _ffn_from(lt: dict, i: int) -> dict:
    """Layer ``i``'s FFN from the stacked tree: ``moe`` or ``mlp``."""
    if "moe" in lt:
        m = lt["moe"]
        return {"moe": MoE(_dense_from(m["router"], i), m["gate"][i],
                           m["up"][i], m["down"][i])}
    m = lt["mlp"]
    return {"mlp": SwiGLU(_dense_from(m["gate"], i), _dense_from(m["up"], i),
                          _dense_from(m["down"], i))}


def params_from_jax(tree: dict, *,
                    device: "str | torch.device" = "cuda") -> Transformer:
    """The reference's parameter tree (numpy arrays, or tensors) as the
    port's :class:`Transformer` on ``device``.

    ``tree["layers"]`` holds every layer leaf stacked on a leading
    ``[n_layers]`` axis; it is unstacked into one :class:`Layer` each.
    Dense weights keep their ``[d_in, d_out]`` layout unchanged.
    """
    dev = resolve_device(device)
    t = tensor_tree(tree)
    lt = t["layers"]
    layers = [Layer(ln1=RMSNorm(lt["ln1"]["scale"][i]),
                    ln2=RMSNorm(lt["ln2"]["scale"][i]),
                    wq=_dense_from(lt["wq"], i), wk=_dense_from(lt["wk"], i),
                    wv=_dense_from(lt["wv"], i), wo=_dense_from(lt["wo"], i),
                    **_ffn_from(lt, i))
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


def _ffn_block(lp: Layer, x: torch.Tensor, cfg: TransformerConfig,
               capacity_factor: float
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x + FFN(ln2(x)), and the MoE's aux loss (None for a dense FFN)."""
    h = rmsnorm(lp.ln2, x)
    if cfg.is_moe:
        B, S, d = h.shape
        y, aux = moe_apply(lp.moe, h.reshape(B * S, d), top_k=cfg.moe_top_k,
                           capacity_factor=capacity_factor)
        return x + y.view(B, S, d), aux
    return x + swiglu(lp.mlp, h), None


def _layer(lp: Layer, x: torch.Tensor, cfg: TransformerConfig,
           cos: torch.Tensor, sin: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor | None]:
    return _ffn_block(lp, _attention_block(lp, x, cfg, cos, sin), cfg,
                      cfg.capacity_factor)


def forward_hidden(params: Transformer, tokens, cfg: TransformerConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden [B, S, d], aux_loss): the aux loss
    is the mean of the MoE layers' Switch losses (0 for a dense model).

    With grad enabled and ``cfg.remat``, each layer is checkpointed: its
    activations are recomputed in the backward instead of kept."""
    dev = params.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    S = tokens.shape[1]
    x = params.embed[tokens]
    cos, sin = rope_cos_sin(torch.arange(S, device=dev), cfg.d_head,
                            cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for lp in params.layers:
        if remat:
            x, aux_l = checkpoint(_layer, lp, x, cfg, cos, sin,
                                  use_reentrant=False)
        else:
            x, aux_l = _layer(lp, x, cfg, cos, sin)
        if aux_l is not None:
            aux = aux + aux_l
    return rmsnorm(params.ln_f, x), aux / cfg.n_layers


def forward(params: Transformer, tokens, cfg: TransformerConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux_loss)."""
    x, aux = forward_hidden(params, tokens, cfg)
    return dense(params.lm_head, x), aux


def _chunk_nll(head: Dense, xs: torch.Tensor, ls: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the chunk's token NLLs, count of its labels != -1)."""
    logits = dense(head, xs).to(torch.float32)          # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)               # [B, c]
    mask = ls != -1
    safe = torch.where(mask, ls, 0)
    label_logit = logits.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(mask, lse - label_logit, 0.0)
    return nll.sum(), mask.sum()


def fused_ce_loss(head: Dense, x: torch.Tensor, labels,
                  chunk_s: int = 512) -> torch.Tensor:
    """lm_head + cross entropy, chunked over the sequence dim: each chunk
    projects one [B, chunk, d] slice and reduces it to (logsumexp,
    label-logit) pairs; with grad enabled the chunk's logits are
    recomputed in the backward (never all [B, S, V] at once). Labels of
    -1 are ignored; the mean is over the rest."""
    B, S, _ = x.shape
    labels = torch.as_tensor(labels, device=x.device).long()
    chunk_s = min(chunk_s, S)
    while S % chunk_s:
        chunk_s //= 2
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, S, chunk_s):
        xs, ls = x[:, c0:c0 + chunk_s], labels[:, c0:c0 + chunk_s]
        if torch.is_grad_enabled():
            s, c = checkpoint(_chunk_nll, head, xs, ls, use_reentrant=False)
        else:
            s, c = _chunk_nll(head, xs, ls)
        nll_sum = nll_sum + s
        count = count + c
    return nll_sum / torch.clamp(count, min=1)


def loss_fn(params: Transformer, tokens, labels,
            cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token cross entropy + ``aux_loss_weight`` × the aux loss
    (0 for a dense model)."""
    x, aux = forward_hidden(params, tokens, cfg)
    return fused_ce_loss(params.lm_head, x, labels) \
        + cfg.aux_loss_weight * aux


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
    positions through the flash kernel. ``length`` advances by one. A MoE
    FFN routes the step's ``B`` tokens with ``capacity_factor =
    max(cfg.capacity_factor, 2.0)``, as the reference does.

    Past a full cache (``length >= max_seq``) the step does what the
    reference's one-hot insert does: it writes nothing, attends over all
    ``max_seq`` cached positions, keeps RoPE at the true position
    ``length`` and still advances ``length``.
    """
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
        x, _ = _ffn_block(lp, x, cfg, max(cfg.capacity_factor, 2.0))
    x = rmsnorm(params.ln_f, x)
    logits = dense(params.lm_head, x)[:, 0]
    cache["length"] = idx + 1
    return logits, cache
