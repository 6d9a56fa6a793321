"""Generic train step: grad → (compress) → clip → AdamW, with microbatch
accumulation (a copy of the reference's ``repro.train.step``).

``make_train_step`` closes over a ``loss_fn(params, batch)`` and returns
``step(state, batch) -> (state, metrics)``. The gradient comes from
autograd over the parameter module (``torch.autograd.grad``); with
``n_microbatches > 1`` the batch's leaves are split on their leading dim
and the gradients summed in ``accum_dtype``, then divided, as the
reference's ``lax.scan`` does.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .grad_compress import ef_compress_tree, init_error_state
from .optimizer import AdamWConfig, apply_updates, init_state

__all__ = ["init_train_state", "make_train_step"]


def init_train_state(params, use_grad_compression: bool = False,
                     compact_state: bool = False) -> dict:
    """``{"params", "opt"[, "ef_error"]}``; turns grad on for every
    parameter of ``params`` (a module)."""
    for p in params.parameters():
        p.requires_grad_(True)
    state = {"params": params, "opt": init_state(params, compact_state)}
    if use_grad_compression:
        state["ef_error"] = init_error_state(params)
    return state


def make_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    opt_cfg: AdamWConfig,
    *,
    n_microbatches: int = 1,
    use_grad_compression: bool = False,
    accum_dtype: str = "float32",
) -> Callable[[dict, Any], tuple[dict, dict]]:
    """Returns step(state, batch) -> (state, metrics).

    ``batch`` is a dict whose leaves (numpy arrays or tensors) have a
    leading global-batch dim divisible by ``n_microbatches``.
    """

    def grads_of(params, batch) -> tuple[torch.Tensor, dict]:
        names, leaves = zip(*params.named_parameters())
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(names, grads))

    def step(state: dict, batch: Any) -> tuple[dict, dict]:
        params = state["params"]
        if n_microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            n = n_microbatches
            micro = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])
                     for k, x in batch.items()}
            acc_dt = getattr(torch, accum_dtype)
            loss = torch.zeros((), dtype=torch.float32, device=params.device)
            grads = {name: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for name, p in params.named_parameters()}
            for i in range(n):
                l_i, g_i = grads_of(params, {k: x[i] for k, x in micro.items()})
                loss = loss + l_i
                grads = {name: a + g_i[name].to(a.dtype)
                         for name, a in grads.items()}
            loss = loss / n
            grads = {name: g / n for name, g in grads.items()}

        new_state = dict(state)
        if use_grad_compression:
            grads, new_err = ef_compress_tree(grads, state["ef_error"])
            new_state["ef_error"] = new_err
        new_params, new_opt, opt_metrics = apply_updates(
            params, grads, state["opt"], opt_cfg)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, {"loss": loss, **opt_metrics}

    return step
