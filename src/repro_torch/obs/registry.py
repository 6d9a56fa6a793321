"""Counter registry: the part of the reference's metrics registry the
ported path publishes to.

One :class:`Registry` per process (see :func:`repro_torch.obs.registry`).
Writers are short (a dict add) under one lock. Snapshots
(:class:`ObsSnapshot`) are plain data read by the kernel dispatch report
(:func:`repro_torch.obs.kernels.pad_waste_report`).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Mapping

__all__ = ["ObsSnapshot", "Registry"]


@dataclass
class ObsSnapshot:
    """Point-in-time copy of a registry's counters."""

    counters: Dict[str, int] = field(default_factory=dict)

    def counter(self, name: str, default: int = 0) -> int:
        return self.counters.get(name, default)


class Registry:
    """Thread-safe counter registry for one process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}

    def counter_add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def fold_counters(self, mapping: Mapping[str, int],
                      prefix: str = "") -> None:
        """Bulk-add a dict of counters; zero values add no key."""
        with self._lock:
            for k, v in mapping.items():
                if v:
                    key = prefix + k
                    self._counters[key] = self._counters.get(key, 0) + int(v)

    def snapshot(self) -> ObsSnapshot:
        with self._lock:
            return ObsSnapshot(counters=dict(self._counters))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
