"""Metrics registry: counters, gauges and bounded reservoir histograms.

One process-default :class:`Registry` (see :func:`repro_torch.obs.registry`)
plus private instances wherever isolation matters: each
``ArchiveGateway`` owns one, so two gateways in a process never
cross-count. Everything is guarded by a single lock — writers are short
(a dict add).

Histograms are **bounded reservoirs**: exact below ``cap`` samples,
Algorithm-R sampling beyond, with a per-name seeded RNG so the same
observation sequence always yields the same reservoir. Quantiles use
linear interpolation (:func:`percentile`).

Snapshots (:class:`ObsSnapshot`) are plain data: they merge
deterministically (counters sum, gauges take the max, histogram
reservoirs sort-merge then stride-decimate) and render to a dict.
"""
from __future__ import annotations

import random
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = ["HISTOGRAM_CAP", "ObsSnapshot", "Registry", "percentile"]

#: Reservoir bound: histograms are exact below this many observations.
HISTOGRAM_CAP = 4096


def percentile(values: List[float], q: float) -> float:
    """Linear-interpolated percentile (``q`` in [0, 100]) of a list."""
    if not values:
        return 0.0
    data = sorted(values)
    if len(data) == 1:
        return data[0]
    pos = (len(data) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(data) - 1)
    frac = pos - lo
    return data[lo] * (1.0 - frac) + data[hi] * frac


class _Reservoir:
    """Bounded sample reservoir: exact below ``cap``, Algorithm R beyond.

    The RNG is seeded from the histogram *name*, so a fixed observation
    sequence produces a fixed reservoir.
    """

    __slots__ = ("cap", "count", "total", "min", "max", "samples", "_rng")

    def __init__(self, name: str, cap: int = HISTOGRAM_CAP):
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: List[float] = []
        self._rng = random.Random(0x5EED ^ zlib.crc32(name.encode()))

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if len(self.samples) < self.cap:
            self.samples.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self.samples[j] = value

    def summary(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "samples": list(self.samples),
        }


def _decimate(sorted_samples: List[float], cap: int) -> List[float]:
    """Deterministic stride-decimation of a sorted sample list to ``cap``;
    keeps both endpoints, so min/max survive."""
    n = len(sorted_samples)
    if n <= cap:
        return sorted_samples
    return [sorted_samples[round(i * (n - 1) / (cap - 1))] for i in range(cap)]


def _merge_hist(a: Mapping[str, Any], b: Mapping[str, Any],
                cap: int = HISTOGRAM_CAP) -> Dict[str, Any]:
    count = a["count"] + b["count"]
    merged = sorted(list(a["samples"]) + list(b["samples"]))
    return {
        "count": count,
        "sum": a["sum"] + b["sum"],
        "min": min(a["min"], b["min"]) if count else 0.0,
        "max": max(a["max"], b["max"]) if count else 0.0,
        "samples": _decimate(merged, cap),
    }


@dataclass
class ObsSnapshot:
    """Point-in-time view of a registry (or a merge of several)."""

    counters: Dict[str, int] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    histograms: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    sources: Tuple[str, ...] = ("parent",)

    def counter(self, name: str, default: int = 0) -> int:
        return self.counters.get(name, default)

    def gauge(self, name: str, default: float = 0.0) -> float:
        return self.gauges.get(name, default)

    def quantile(self, name: str, q: float) -> float:
        h = self.histograms.get(name)
        if not h or not h["samples"]:
            return 0.0
        return percentile(h["samples"], q)

    def merged_with(self, other: "ObsSnapshot") -> "ObsSnapshot":
        """Merge two snapshots: counters sum, gauges take the max,
        histogram reservoirs sort-merge then decimate."""
        counters = dict(self.counters)
        for k, v in other.counters.items():
            counters[k] = counters.get(k, 0) + v
        gauges = dict(self.gauges)
        for k, v in other.gauges.items():
            gauges[k] = max(gauges[k], v) if k in gauges else v
        hists = {k: dict(v, samples=list(v["samples"]))
                 for k, v in self.histograms.items()}
        for k, v in other.histograms.items():
            hists[k] = _merge_hist(hists[k], v) if k in hists else \
                dict(v, samples=list(v["samples"]))
        sources = self.sources + tuple(
            s for s in other.sources if s not in self.sources)
        return ObsSnapshot(counters, gauges, hists, sources)

    @classmethod
    def merge(cls, snaps: Iterable["ObsSnapshot"]) -> "ObsSnapshot":
        out = cls(sources=())
        for s in snaps:
            out = out.merged_with(s)
        if not out.sources:
            out.sources = ("parent",)
        return out

    def as_dict(self) -> Dict[str, Any]:
        hists = {}
        for name, h in sorted(self.histograms.items()):
            s = sorted(h["samples"])
            hists[name] = {
                "count": h["count"], "sum": h["sum"],
                "min": h["min"], "max": h["max"],
                "p50": percentile(s, 50.0), "p99": percentile(s, 99.0),
            }
        return {
            "sources": list(self.sources),
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "histograms": hists,
        }


class Registry:
    """Thread-safe metrics registry for one process (or one subsystem)."""

    def __init__(self, source: str = "parent"):
        self.source = source
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Reservoir] = {}
        self._extra_sources: List[str] = []

    # -- writers ----------------------------------------------------------
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

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Reservoir(name)
            h.observe(value)

    def attach_source(self, name: str) -> None:
        """Record that counters folded in here came from another process
        (a pool worker, the pool itself)."""
        with self._lock:
            if name not in self._extra_sources:
                self._extra_sources.append(name)

    def absorb(self, snap: ObsSnapshot, prefix: str = "") -> None:
        """Fold a child snapshot into this registry: counters sum,
        gauges take the max, histogram reservoirs sort-merge then
        decimate (the :meth:`ObsSnapshot.merged_with` rules), and the
        snapshot's sources are attached. Call exactly once per child
        snapshot: counters are cumulative, absorbing twice double-counts."""
        self.fold_counters(snap.counters, prefix=prefix)
        with self._lock:
            for k, v in snap.gauges.items():
                key = prefix + k
                self._gauges[key] = max(self._gauges.get(key, v), v)
            for k, h in snap.histograms.items():
                key = prefix + k
                cur = self._hists.get(key)
                if cur is None:
                    cur = self._hists[key] = _Reservoir(key)
                m = _merge_hist(cur.summary(), h) if cur.count else \
                    dict(h, samples=list(h["samples"]))
                cur.count = m["count"]
                cur.total = m["sum"]
                cur.min = m["min"] if m["count"] else float("inf")
                cur.max = m["max"] if m["count"] else float("-inf")
                cur.samples = list(m["samples"])
        for s in snap.sources:
            self.attach_source(s)

    # -- readers ----------------------------------------------------------
    def counter(self, name: str, default: int = 0) -> int:
        with self._lock:
            return self._counters.get(name, default)

    def quantile(self, name: str, q: float) -> float:
        with self._lock:
            h = self._hists.get(name)
            samples = list(h.samples) if h else []
        return percentile(samples, q)

    def hist_count(self, name: str) -> int:
        with self._lock:
            h = self._hists.get(name)
            return h.count if h else 0

    def snapshot(self, source: Optional[str] = None) -> ObsSnapshot:
        """Plain-data view; its ``sources`` are this registry's own name
        followed by every attached source."""
        with self._lock:
            src = source if source is not None else self.source
            return ObsSnapshot(
                counters=dict(self._counters),
                gauges=dict(self._gauges),
                histograms={k: h.summary() for k, h in self._hists.items()},
                sources=(src, *self._extra_sources),
            )

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._extra_sources.clear()
