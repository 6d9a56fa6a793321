"""Device resolution shared by every public entry point."""
from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device: "str | torch.device") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Only ``cuda`` and ``cpu`` devices are accepted. A CUDA device with no
    GPU present raises instead of silently running on the CPU: the CPU
    path is taken only when the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device='cpu' "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (need cuda or cpu)")
    return dev


def to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``arr`` as a tensor on ``dev``: a copy on a CUDA device, a view on
    the CPU.

    Read-only arrays (zero-copy views of a memory-mapped file) are
    accepted: the tensor built on them is only read. The caller drops the
    returned CPU tensor before the mapping is closed.
    """
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable",
                                category=UserWarning)
        host = torch.from_numpy(np.ascontiguousarray(arr))
    return host.to(dev) if dev.type == "cuda" else host
