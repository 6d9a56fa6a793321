"""``repro_torch.obs`` — process-default counter registry.

The ported path publishes the same counters as the reference: the kernel
dispatch profiler (``kernel.<name>.*``, :mod:`.kernels`), the index
build's stage times (``index.stage.*``) and the parser's ``ingest.*``
totals.
"""
from __future__ import annotations

from .registry import ObsSnapshot, Registry

__all__ = ["ObsSnapshot", "Registry", "registry", "reset", "snapshot"]

_default = Registry()


def registry() -> Registry:
    """The process-default registry every producer writes to."""
    return _default


def snapshot() -> ObsSnapshot:
    """Snapshot the process-default registry."""
    return _default.snapshot()


def reset() -> None:
    """Clear the process-default registry (tests and measurements)."""
    _default.reset()
