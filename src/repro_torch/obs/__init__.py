"""``repro_torch.obs`` — process-default metrics registry and tracing.

The ported path publishes the same counters as the reference: the kernel
dispatch profiler (``kernel.<name>.*``, :mod:`.kernels`), the index
build's stage times (``index.stage.*``) and the parser's ``ingest.*``
totals. The registry also holds gauges and bounded reservoir histograms
(:mod:`.registry`). Request-scoped span trees (:mod:`.trace`), the
bounded flight recorder with anomaly dumps (:mod:`.flight`) and the
Chrome-trace / stage-breakdown exporters (:mod:`.export`) serve the
archive gateway.
"""
from __future__ import annotations

from .registry import HISTOGRAM_CAP, ObsSnapshot, Registry, percentile
from . import export, flight, trace

__all__ = ["HISTOGRAM_CAP", "ObsSnapshot", "Registry", "export", "flight",
           "percentile", "registry", "reset", "snapshot", "trace"]

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
