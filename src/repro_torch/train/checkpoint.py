"""Read the checkpoints the reference's trainer writes (no JAX needed).

Layout of a checkpoint directory (``repro.train.checkpoint``)::

    step_000123/
      metadata.json       # leaf names (keystr paths), shapes, dtypes, extras
      arrays/<idx>.npy    # one .npy per leaf, index matches metadata order
      COMMIT              # written last: restore ignores dirs without it

:func:`restore` keeps the ``['params']…`` leaves (the optimizer state is
not needed to serve) as nested dicts of CPU tensors, ready for
:func:`repro_torch.models.transformer.params_from_jax`. bfloat16 leaves
are stored as raw 2-byte void records; they are read as ``uint16`` and
viewed as ``torch.bfloat16`` (no ``ml_dtypes`` needed). ``save`` and
the async writer wait for the training slice.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

__all__ = ["latest_step", "restore"]

_COMMIT = "COMMIT"
_DICT_PATH = re.compile(r"(?:\['[^']*'\])+")
_KEY = re.compile(r"\['([^']*)'\]")


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
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    raise ValueError(f"leaf stored as {arr.dtype} for dtype {dtype!r} is "
                     f"not supported")


def restore(directory: str, step: int | None = None) -> tuple[dict, dict]:
    """``(params, extras)`` of checkpoint ``step`` (default: the latest
    committed one): ``params`` is the ``['params']`` subtree as nested
    dicts of CPU tensors."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    params: dict = {}
    for i, (name, dtype) in enumerate(zip(meta["names"], meta["dtypes"])):
        if not name.startswith("['params']"):
            continue
        if not _DICT_PATH.fullmatch(name):
            raise ValueError(f"parameter leaf {name!r} is not a dict path")
        *parents, last = _KEY.findall(name)[1:]
        node = params
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = _leaf(np.load(os.path.join(path, "arrays", f"{i}.npy")),
                           dtype)
    if not params:
        raise ValueError(f"checkpoint {path} holds no ['params'] leaves")
    return params, meta["extras"]
