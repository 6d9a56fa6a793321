"""Device resolution shared by every public entry point."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
