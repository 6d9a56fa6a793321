"""Mixture-of-Experts FFN: top-k routing with the reference's GShard
grouped dispatch.

The reference (``repro.models.moe``) splits the ``T`` tokens into ``G``
groups (its mesh's batch shards; the port has no mesh, so ``groups=None``
means one group), and within each group:

* routes: router logits in the parameters' dtype, cast to f32, softmax,
  the top ``k`` experts (the lower expert index first on a tie, as
  ``jax.lax.top_k``), the selected gates renormalised (Qwen3);
* dispatches: the group's ``A = Tg·k`` assignments sorted stably by
  expert, so each expert takes its assignments in token order; the
  first ``C = int(max(cf·A/E, k))`` (rounded up to 8) are kept, the rest
  dropped; kept assignments fill a dense ``[E, C]`` slot table of token
  ids whose empty slots point at a zero row (``Tg``);
* computes every expert's SwiGLU on its ``[C, d]`` slots as one batched
  product over ``E`` (the reference's ``einsum`` outside any kernel);
* combines: each token's kept slots weighted by their gates.

The reference scatter-adds the weighted slots in the activations' dtype;
on CUDA that is an atomic add whose order, and so its bf16 rounding,
changes from run to run. Here each token gathers its ``k`` slots and
sums them in top-k order in float32, then casts once to ``x``'s dtype,
so a greedy engine's tokens do not flicker.

The Switch load-balancing loss ``E·Σ_e f_e·p̄_e`` counts every assignment
before drops (``f_e``) against the mean router probability (``p̄_e``).

:func:`moe_apply_plain` is an independent plain version (a loop over
experts) that the tests and the chip smoke run hold :func:`moe_apply`
against; the model never calls it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dense, dense, frozen, uniform_init

__all__ = ["MoE", "Routing", "expert_capacity", "moe_apply",
           "moe_apply_plain", "moe_init", "moe_route", "num_groups",
           "top_k_lower_first"]

PAD_ROWS = 8  # zero rows after each group's tokens: the empty slots' source


class MoE(nn.Module):
    """The reference's MoE leaves: ``router.w`` [d, E], ``gate`` and
    ``up`` [E, d, f], ``down`` [E, f, d]."""

    def __init__(self, router: Dense, gate: torch.Tensor, up: torch.Tensor,
                 down: torch.Tensor):
        super().__init__()
        self.router = router
        self.gate, self.up, self.down = frozen(gate), frozen(up), frozen(down)


def moe_init(d_model: int, d_ff: int, n_experts: int, *,
             generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> MoE:
    """Seeded leaves of the reference's distributions: uniform ±1/√d for
    the router, ``gate`` and ``up``, ±1/√f for ``down`` (drawn on the
    generator's device)."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    kw = {"generator": generator, "dtype": dtype}
    return MoE(Dense(uniform_init((d_model, n_experts), s_in, **kw)),
               uniform_init((n_experts, d_model, d_ff), s_in, **kw),
               uniform_init((n_experts, d_model, d_ff), s_in, **kw),
               uniform_init((n_experts, d_ff, d_model), s_out, **kw))


def num_groups(T: int, groups: int | None) -> int:
    """The reference's group count: ``groups`` (1 when None) clipped to
    [1, T], then lowered until it divides ``T``."""
    G = max(min(1 if groups is None else groups, T), 1)
    while T % G:  # tiny/odd token counts: fall back to fewer groups
        G -= 1
    return G


def expert_capacity(A: int, E: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots an expert has in a group of ``A`` assignments, in the
    reference's Python float arithmetic, rounded up to 8."""
    capacity = int(max(capacity_factor * A / E, top_k))
    return -(-capacity // 8) * 8


def top_k_lower_first(probs: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last axis, largest first, the lower index
    first among equal values (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclass
class Routing:
    """One dispatch: ``G`` groups of ``Tg`` tokens, ``E`` experts of
    ``capacity`` slots each."""

    probs: torch.Tensor      # [G, Tg, E] f32 router probabilities
    experts: torch.Tensor    # [G, Tg, k] chosen experts, best first
    gates: torch.Tensor      # [G, Tg, k] f32 gates (renormalised if asked)
    counts: torch.Tensor     # [G, E] assignments per expert, before drops
    token_ids: torch.Tensor  # [G, E, C] token of each slot; Tg where empty
    slots: torch.Tensor      # [G, Tg, k] e·C + position; E·C where dropped
    capacity: int

    @property
    def kept(self) -> torch.Tensor:
        """[G, Tg, k] True where the assignment found a slot."""
        return self.slots < self.token_ids.shape[1] * self.capacity

    @property
    def dropped(self) -> int:
        return int((~self.kept).sum())


def moe_route(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, norm_topk: bool = True,
              groups: int | None = None) -> Routing:
    """The reference's routing and slot assignment of x [T, d]
    (``repro/models/moe.py:60``, lines 67-123)."""
    T, d = x.shape
    E = p.gate.shape[0]
    G = num_groups(T, groups)
    Tg = T // G
    A = Tg * top_k
    C = expert_capacity(A, E, top_k, capacity_factor)
    # the router product in the parameters' dtype, then f32 (a product
    # in f32 would choose other experts in bf16)
    logits = dense(p.router, x.reshape(G, Tg, d)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k_lower_first(probs, top_k)
    if norm_topk:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_expert = experts.reshape(G, A)
    order = torch.sort(flat_expert, dim=1, stable=True).indices
    sorted_expert = flat_expert.gather(1, order)
    # integer adds: exact in any order (bincount would read its input's
    # maximum back to the host, a sync a layer)
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_expert, torch.ones_like(flat_expert))
    starts = counts.cumsum(1) - counts
    pos = (torch.arange(A, device=x.device)[None, :]
           - starts.gather(1, sorted_expert))
    sorted_slot = torch.where(pos < C, sorted_expert * C + pos, E * C)
    slots = torch.empty_like(sorted_slot).scatter_(1, order, sorted_slot)
    # every dropped assignment lands on the sentinel column E·C, cut off
    token_ids = torch.full((G, E * C + 1), Tg, dtype=torch.int64,
                           device=x.device)
    token_ids.scatter_(1, sorted_slot, order // top_k)
    return Routing(probs=probs, experts=experts, gates=gates, counts=counts,
                   token_ids=token_ids[:, :E * C].reshape(G, E, C),
                   slots=slots.view(G, Tg, top_k), capacity=C)


def _aux_loss(probs: torch.Tensor, counts: torch.Tensor,
              top_k: int) -> torch.Tensor:
    """Switch loss ``E·Σ_e f_e·p̄_e``: ``f_e`` the share of all
    ``G·Tg·k`` assignments (before drops) that chose expert ``e``."""
    G, Tg, E = probs.shape
    frac = counts.sum(0).float() / max(G * Tg * top_k, 1)
    return E * torch.sum(frac * probs.mean(dim=(0, 1)))


def moe_apply(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, norm_topk: bool = True,
              groups: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] -> (out [T, d] in x's dtype, aux loss f32 scalar).

    The expert products run batched over E in the parameters' dtype
    (``torch.bmm``); the combine gathers each token's ``k`` slots (a
    dropped one with gate 0) and sums ``gate · y`` over them in float32
    (one reduction of fixed shape: the same order every run), then casts
    once.
    """
    T, d = x.shape
    E = p.gate.shape[0]
    r = moe_route(p, x, top_k=top_k, capacity_factor=capacity_factor,
                  norm_topk=norm_topk, groups=groups)
    G, Tg, C = r.slots.shape[0], r.slots.shape[1], r.capacity
    rows = torch.arange(G, device=x.device)[:, None, None]
    # row gathers over flattened groups: group g's rows start at g·(Tg+8)
    # in x_pad and at g·E·C in the expert outputs
    x_pad = torch.cat([x.reshape(G, Tg, d), x.new_zeros(G, PAD_ROWS, d)],
                      dim=1).view(G * (Tg + PAD_ROWS), d)
    xe = x_pad.index_select(0, (r.token_ids + rows * (Tg + PAD_ROWS))
                            .view(-1))                       # [G·E·C, d]
    xe = xe.view(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(xe, p.gate)) * torch.bmm(xe, p.up)  # [E, G·C, f]
    ye = torch.bmm(h, p.down)                                # [E, G·C, d]
    ye = ye.view(E, G, C, d).transpose(0, 1).reshape(G * E * C, d)

    kept = r.kept
    src = torch.where(kept, r.slots, 0) + rows * (E * C)
    yk = ye.index_select(0, src.view(-1)).view(G, Tg, top_k, d).float()
    yk.mul_(torch.where(kept, r.gates, 0.0).unsqueeze(-1))
    return (yk.sum(2).view(T, d).to(x.dtype),
            _aux_loss(r.probs, r.counts, top_k))


def moe_apply_plain(p: MoE, x: torch.Tensor, *, top_k: int,
                    capacity_factor: float = 1.25, norm_topk: bool = True,
                    groups: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The same function as :func:`moe_apply`, written plainly: per group,
    the top ``k`` by repeated ``argmax`` (its first maximal index on a
    tie), then per expert its assignments in token order, the first
    ``C`` kept, ``gate · expert(x)`` added to each kept token (float32,
    experts in ascending order). Returns (out, aux, the chosen experts
    [T, k], the kept mask [T, k])."""
    T, d = x.shape
    E = p.gate.shape[0]
    G = num_groups(T, groups)
    Tg = T // G
    C = expert_capacity(Tg * top_k, E, top_k, capacity_factor)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    experts = torch.empty((T, top_k), dtype=torch.int64, device=x.device)
    kept = torch.zeros((T, top_k), dtype=torch.bool, device=x.device)
    assigned = torch.zeros(E, dtype=torch.float32, device=x.device)
    prob_sum = torch.zeros(E, dtype=torch.float32, device=x.device)
    for g in range(G):
        lo = g * Tg
        xs = x[lo:lo + Tg]
        probs = torch.softmax(dense(p.router, xs).float(), dim=-1)
        prob_sum += probs.sum(0)
        left = probs.clone()
        chosen = []
        for _ in range(top_k):
            e = left.argmax(-1)
            chosen.append(e)
            left.scatter_(-1, e[:, None], -1.0)
        ex = torch.stack(chosen, -1)                        # [Tg, k]
        gate = probs.gather(-1, ex)
        if norm_topk:
            gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        experts[lo:lo + Tg] = ex
        for e in range(E):
            tok, j = (ex == e).nonzero(as_tuple=True)       # token order
            assigned[e] += tok.numel()
            tok, j = tok[:C], j[:C]
            if not tok.numel():
                continue
            kept[lo + tok, j] = True
            xt = xs[tok]
            y = (F.silu(xt @ p.gate[e]) * (xt @ p.up[e])) @ p.down[e]
            out.index_add_(0, lo + tok, gate[tok, j, None] * y.float())
    aux = E * torch.sum(assigned / max(T * top_k, 1) * (prob_sum / T))
    return out.to(x.dtype), aux, experts, kept
