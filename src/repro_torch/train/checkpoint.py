"""Checkpoints in the reference's format (``repro.train.checkpoint``), with
no JAX.

Layout of a checkpoint directory::

    step_000123/
      metadata.json       # leaf names (keystr paths), shapes, dtypes, extras
      arrays/<idx>.npy    # one .npy per leaf, index matches metadata order
      COMMIT              # written last: restore ignores dirs without it

The leaves are the reference's: the train state ``{"params", "opt"[,
"ef_error"]}`` as nested dicts with sorted keys, each named by its
``keystr`` path (``['opt']['m']['layers']['wq']['w']``), every layer leaf
stacked on ``[n_layers]`` (:func:`train_state_tree`). So a checkpoint the
port writes restores in the reference, and the reverse. bfloat16 leaves
are written as 2-byte ``uint16`` bits with ``"bfloat16"`` in the
metadata; the reference writes raw 2-byte void records; either is read
back by its bits.

* :func:`save` and :class:`AsyncCheckpointer` (at most one write in
  flight; the train loop waits only for the device→host copy) write the
  whole train state with ``extras`` (the step and the loader's cursor).
  Leaves land in a temporary directory, ``COMMIT`` last, then an atomic
  rename; :func:`_rotate` keeps the newest ``keep``.
* ``restore(directory, target)`` reads one back into the structure of
  ``target`` (a train state: the parameters are written into ``target``'s
  modules in place, the optimizer state comes back on their devices);
  ``restore(directory)`` keeps only the ``['params']`` leaves as nested
  dicts of CPU tensors, what the serve path needs
  (:func:`repro_torch.models.transformer.params_from_jax`).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.models.transformer import stack_named, unstack_tree
from .optimizer import opt_state_from_jax, opt_state_tree

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save",
           "train_state_tree"]

_COMMIT = "COMMIT"
_DICT_PATH = re.compile(r"(?:\['[^']*'\])+")
_KEY = re.compile(r"\['([^']*)'\]")


def train_state_tree(state: dict) -> dict:
    """A train state in the reference's tree layout, leaves still tensors
    (layer leaves stacked: a copy on their device)."""
    tree = {"params": stack_named(
        {n: p.detach() for n, p in state["params"].named_parameters()}),
        "opt": opt_state_tree(state["opt"])}
    if "ef_error" in state:
        tree["ef_error"] = stack_named(state["ef_error"])
    return tree


def _flatten(tree: dict, prefix: str = "") -> list[tuple[str, Any]]:
    """``(keystr, leaf)`` in the reference's order: dict keys sorted."""
    out = []
    for key in sorted(tree):
        name = f"{prefix}['{key}']"
        if isinstance(tree[key], dict):
            out += _flatten(tree[key], name)
        else:
            out.append((name, tree[key]))
    return out


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` for ``np.save`` and its dtype name."""
    leaf = leaf.detach().cpu()
    dtype = str(leaf.dtype).split(".")[1]
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(np.uint16).copy(), dtype
    return leaf.numpy().copy(), dtype


def _snapshot(state: dict) -> list[tuple[str, np.ndarray, str]]:
    return [(name, *_host(leaf))
            for name, leaf in _flatten(train_state_tree(state))]


def save(directory: str, step: int, state: dict,
         extras: dict | None = None, keep: int = 3) -> str:
    """Synchronous checkpoint write. Returns the checkpoint path."""
    return _write(directory, step, _snapshot(state), extras or {}, keep)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one in flight."""

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None

    def save(self, directory: str, step: int, state: dict,
             extras: dict | None = None, keep: int = 3) -> None:
        self.wait()
        leaves = _snapshot(state)  # device -> host here; the write later

        def work():
            self.last_path = _write(directory, step, leaves, extras or {},
                                    keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _write(directory: str, step: int,
           leaves: list[tuple[str, np.ndarray, str]], extras: dict,
           keep: int) -> str:
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    arrays = os.path.join(tmp, "arrays")
    os.makedirs(arrays, exist_ok=True)
    meta = {
        "step": step,
        "names": [name for name, _, _ in leaves],
        "shapes": [list(arr.shape) for _, arr, _ in leaves],
        "dtypes": [dtype for _, _, dtype in leaves],
        "extras": extras,
    }
    for i, (_, arr, _) in enumerate(leaves):
        np.save(os.path.join(arrays, f"{i}.npy"), arr, allow_pickle=False)
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _rotate(directory, keep)
    return final


def _rotate(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for stale in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, stale), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and os.path.exists(
                os.path.join(directory, d, _COMMIT)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.name == dtype:
        return torch.from_numpy(arr)
    if dtype == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    raise ValueError(f"leaf stored as {arr.dtype} for dtype {dtype!r} is "
                     f"not supported")


def _read(directory: str, step: int | None
          ) -> tuple[str, dict, list[tuple[int, str, str]]]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    return path, meta, list(zip(range(len(meta["names"])), meta["names"],
                                meta["dtypes"]))


def _nest(leaves: list[tuple[str, torch.Tensor]], drop: int = 0) -> dict:
    """Nested dicts from ``(keystr, leaf)``, dropping the first ``drop``
    keys of each path."""
    tree: dict = {}
    for name, leaf in leaves:
        if not _DICT_PATH.fullmatch(name):
            raise ValueError(f"leaf {name!r} is not a dict path")
        *parents, last = _KEY.findall(name)[drop:]
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def restore(directory: str, target: dict | None = None,
            step: int | None = None) -> tuple[dict, dict]:
    """``(state, extras)`` of checkpoint ``step`` (default: the latest
    committed one).

    With ``target`` (a train state) the checkpoint must hold its leaves,
    name for name: the parameters are copied into ``target["params"]``
    in place, the optimizer (and error-feedback) state comes back on the
    parameters' device. Without it, ``state`` is only the
    ``['params']`` subtree as nested dicts of CPU tensors."""
    path, meta, entries = _read(directory, step)

    def load(i: int, dtype: str) -> torch.Tensor:
        return _leaf(np.load(os.path.join(path, "arrays", f"{i}.npy")),
                     dtype)

    if target is None:
        params = _nest([(name, load(i, dtype)) for i, name, dtype in entries
                        if name.startswith("['params']")], drop=1)
        if not params:
            raise ValueError(f"checkpoint {path} holds no ['params'] leaves")
        return params, meta["extras"]
    names = [name for name, _ in _flatten(train_state_tree(target))]
    if names != meta["names"]:
        raise ValueError("checkpoint/target tree mismatch: "
                         f"{set(names) ^ set(meta['names'])}")
    tree = _nest([(name, load(i, dtype)) for i, name, dtype in entries])
    module = target["params"]
    dev = module.device
    with torch.no_grad():
        loaded = unstack_tree(tree["params"])
        for name, p in module.named_parameters():
            p.copy_(loaded[name])
    state = dict(target)
    state["opt"] = opt_state_from_jax(tree["opt"], device=dev)
    if "ef_error" in tree:
        state["ef_error"] = {n: e.contiguous().to(dev) for n, e in
                             unstack_tree(tree["ef_error"]).items()}
    return state, meta["extras"]
