"""Gateway metrics: counters, latency and stage histograms, gauges.

The gateway counts everything that matters (requests, coalesced waiters,
unique scans, kernel launches, records and bytes scanned, fetches) so
that "fewer kernel launches per request" is observable, not asserted.

A thin facade over :class:`repro_torch.obs.Registry`: per-request
latencies land in the registry's bounded reservoir histogram (exact
below ``repro_torch.obs.HISTOGRAM_CAP`` samples, deterministic
Algorithm-R sampling beyond); p50/p99 use linear interpolation
(:func:`percentile`).

Each ``GatewayMetrics`` owns a private registry (source ``"gateway"``):
two gateways in one process never cross-count, and :meth:`obs_snapshot`
exports the whole surface as a mergeable
:class:`~repro_torch.obs.ObsSnapshot`.

Thread-safe: submit-side counters race with the scheduler threads.
"""
from __future__ import annotations

from repro_torch.obs.export import breakdown_from_snapshot
from repro_torch.obs.registry import ObsSnapshot, Registry, percentile

__all__ = ["GatewayMetrics", "percentile"]

_LATENCY_HIST = "gateway.latency_s"
_STAGE_PREFIX = "gateway.stage."


class GatewayMetrics:
    """Counter + latency surface for
    :class:`repro_torch.serve.archive.ArchiveGateway`."""

    _COUNTERS = (
        "requests",            # submitted (accepted) requests
        "rejected",            # admission-queue overflows (backpressure)
        "responses",           # resolved requests
        "coalesced",           # requests served by another request's scan
        "unique_scans",        # scans actually planned + executed
        "scan_batches",        # drained scheduler batches
        "kernel_dispatches",   # kernel launches (shared across requests)
        "host_scans",          # records scanned on the host path
        "records_scanned",     # candidate records through the scan stage
        "bytes_scanned",
        "records_fetched",     # payload fetches that missed the cache
        "store_fetches",       # of "records_fetched": served from an
                               # attached columnar store (no seek/inflate)
        "errors",              # scans resolved with an exception
        "timeouts",            # requests resolved with GatewayTimeout
        "read_errors",         # damaged-record fetches (RecordReadError)
        "quarantined_rows",    # candidate rows skipped as unreadable
        "flight_dumps",        # anomaly-tripped flight-recorder dumps
        "shard_deaths",        # drain threads that exited abnormally
        "shard_respawns",      # deaths recovered by a respawn
        "shards_down",         # shards retired permanently (respawns spent)
        "redriven",            # orphaned tickets re-routed exactly once
        "shard_down_errors",   # tickets failed typed with GatewayShardDown
    )

    def __init__(self, registry: Registry | None = None) -> None:
        self._reg = registry if registry is not None \
            else Registry(source="gateway")
        self._hw_seen = 0  # global queue-depth high-water across shards
        # declare every counter up front: count()/snapshot() report 0 for
        # untouched counters instead of KeyError/absence
        for name in self._COUNTERS:
            self._reg.counter_add(name, 0)

    @property
    def registry(self) -> Registry:
        return self._reg

    def inc(self, name: str, n: int = 1) -> None:
        self._reg.counter_add(name, n)

    def observe_latency(self, seconds: float) -> None:
        self._reg.observe(_LATENCY_HIST, seconds)

    def observe_stage(self, span_name: str, seconds: float) -> None:
        """Record one request-scoped stage duration: span name
        ``gw.<stage>`` lands in the ``gateway.stage.<stage>_s``
        histogram, the source
        :func:`repro_torch.obs.export.breakdown_from_snapshot` reads."""
        stage = span_name[3:] if span_name.startswith("gw.") else span_name
        self._reg.observe(f"{_STAGE_PREFIX}{stage}_s", seconds)

    def gauge_set(self, name: str, value: float) -> None:
        """Set a gauge (prefixed ``gateway.`` for the merged snapshot)."""
        self._reg.gauge_set(f"gateway.{name}", value)

    def note_global_depth(self, depth: int) -> None:
        """Fold one shard's observed queue depth into the gateway-wide
        ``queue_depth`` gauge (the most recent observation from any
        shard) and its monotone high-water mark; each shard also
        publishes ``shard<i>.queue_depth``."""
        self.gauge_set("queue_depth", depth)
        if depth > self._hw_seen:
            self._hw_seen = depth
            self.gauge_set("queue_depth_highwater", depth)

    def count(self, name: str) -> int:
        return self._reg.counter(name)

    def stage_quantile(self, stage: str, q: float) -> float:
        return self._reg.quantile(f"{_STAGE_PREFIX}{stage}_s", q)

    def snapshot(self, cache=None) -> dict:
        """One coherent view: raw counters + the derived headline rates.

        ``cache`` — optional :class:`repro_torch.serve.cache.RecordCache`
        (or its sharded form); its counters are folded in under
        ``cache_*`` keys.
        """
        snap = self._reg.snapshot()
        out: dict = {name: snap.counter(name) for name in self._COUNTERS}
        responses = max(out["responses"], 1)
        out["latency_p50_ms"] = snap.quantile(_LATENCY_HIST, 50) * 1e3
        out["latency_p99_ms"] = snap.quantile(_LATENCY_HIST, 99) * 1e3
        out["coalesce_rate"] = out["coalesced"] / max(out["requests"], 1)
        out["dispatches_per_request"] = out["kernel_dispatches"] / responses
        out["records_scanned_per_request"] = out["records_scanned"] / responses
        out["queue_depth"] = snap.gauge("gateway.queue_depth")
        out["queue_depth_highwater"] = snap.gauge(
            "gateway.queue_depth_highwater")
        stages = breakdown_from_snapshot(snap)
        if stages:  # request tracing on: per-stage attribution rides along
            out["stages"] = stages
        if cache is not None:
            for key, value in cache.snapshot().items():
                out[f"cache_{key}"] = value
        return out

    def obs_snapshot(self, cache=None) -> ObsSnapshot:
        """The same surface as a mergeable :class:`ObsSnapshot`, counters
        prefixed ``gateway.``; cache counters fold in as
        ``gateway.cache.*``."""
        raw = self._reg.snapshot()
        out = ObsSnapshot(sources=("gateway",))
        out.counters = {f"gateway.{k}": v for k, v in raw.counters.items()}
        # gauge_set already stores gauges gateway.-prefixed (snapshot()
        # reads them by that name); re-prefixing would yield gateway.gateway.*
        out.gauges = {k if k.startswith("gateway.") else f"gateway.{k}": v
                      for k, v in raw.gauges.items()}
        out.histograms = dict(raw.histograms)  # already gateway.-prefixed
        if cache is not None:
            for key, value in cache.snapshot().items():
                if isinstance(value, float):
                    out.gauges[f"gateway.cache.{key}"] = value
                elif isinstance(value, int):
                    out.counters[f"gateway.cache.{key}"] = value
                # non-numeric cache fields (the policy name) have no
                # counter/gauge representation and are skipped
        return out
