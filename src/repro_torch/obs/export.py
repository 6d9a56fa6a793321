"""Span exporters: Chrome ``trace_event`` JSON + per-stage breakdown tables.

* :func:`chrome_trace` turns a span list (usually
  ``flight_recorder.spans()``) into the Chrome ``trace_event`` format —
  complete (``"ph": "X"``) events with microsecond timestamps, one
  ``tid`` per producing thread, thread-name metadata events, and
  trace/span/parent ids under ``args`` — loadable in ``chrome://tracing``
  and Perfetto as-is.
* :func:`breakdown_from_snapshot` distills *where the time went* from
  the gateway's ``gateway.stage.<name>_s`` histograms: per-stage count,
  total seconds, p50/p99 and share of the summed stage time.

Stages mix per-request spans (``queue_wait``) with per-batch spans shared
by many requests (``cache_fill``, ``kernel_dispatch``), so shares answer
"which stage burns the wall time", not "what does one request pay" —
the p50/p99 columns answer that.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Mapping, Optional

from .registry import ObsSnapshot, percentile
from .trace import Span

__all__ = ["breakdown_from_snapshot", "chrome_trace", "dominant_stage",
           "render_stage_table", "write_chrome_trace"]


def chrome_trace(spans: Iterable[Span], *,
                 process_name: str = "repro_torch") -> dict:
    """Chrome/Perfetto ``trace_event`` JSON object for a span list."""
    pid = os.getpid()
    tids: Dict[str, int] = {}
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    body: List[dict] = []
    for s in sorted(spans, key=lambda s: s.t0):
        if s.t1 is None:
            continue
        tid = tids.get(s.thread)
        if tid is None:
            tid = tids[s.thread] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": s.thread}})
        args = {"trace_id": s.trace_id, "span_id": s.span_id,
                "parent_id": s.parent_id}
        if s.attrs:
            args.update({k: v for k, v in s.attrs.items()
                         if isinstance(v, (str, int, float, bool))})
        body.append({
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ph": "X",
            "ts": s.as_dict()["t0_us"],
            "dur": (s.t1 - s.t0) * 1e6,
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    return {"traceEvents": events + body, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Span], **kw) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(spans, **kw), f)
        f.write("\n")
    return path


def breakdown_from_snapshot(snap: ObsSnapshot | Mapping,
                            prefix: str = "gateway.stage."
                            ) -> Dict[str, dict]:
    """Per-stage attribution from the stage histograms of a snapshot
    (or its :meth:`~repro_torch.obs.ObsSnapshot.as_dict` form):
    ``{stage: {count, total_s, p50_ms, p99_ms, share}}``, sorted by total
    time. Counts and sums are exact (reservoir sampling bounds only the
    quantile samples)."""
    hists = snap.histograms if isinstance(snap, ObsSnapshot) \
        else snap.get("histograms", {})
    out: Dict[str, dict] = {}
    for name, h in hists.items():
        if not name.startswith(prefix) or not name.endswith("_s"):
            continue
        stage = name[len(prefix):-2]
        samples = sorted(h.get("samples", ()))
        if samples:
            p50, p99 = percentile(samples, 50), percentile(samples, 99)
        else:  # as_dict form: pre-computed quantiles, no raw samples
            p50, p99 = h.get("p50", 0.0), h.get("p99", 0.0)
        out[stage] = {
            "count": h["count"],
            "total_s": h["sum"],
            "p50_ms": p50 * 1e3,
            "p99_ms": p99 * 1e3,
        }
    total = sum(v["total_s"] for v in out.values())
    for v in out.values():
        v["share"] = v["total_s"] / total if total else 0.0
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_s"]))


def dominant_stage(breakdown: Mapping[str, Mapping]) -> Optional[str]:
    """The stage burning the most total time, or ``None`` if empty."""
    if not breakdown:
        return None
    return max(breakdown, key=lambda k: breakdown[k]["total_s"])


def render_stage_table(breakdown: Mapping[str, Mapping]) -> str:
    """Fixed-width text table of a stage breakdown."""
    lines = [f"{'stage':<18} {'count':>8} {'p50 ms':>9} {'p99 ms':>9} "
             f"{'total s':>9} {'share':>6}"]
    for name, v in breakdown.items():
        lines.append(
            f"{name:<18} {v['count']:>8} {v['p50_ms']:>9.2f} "
            f"{v['p99_ms']:>9.2f} {v['total_s']:>9.3f} "
            f"{v['share'] * 100:>5.1f}%")
    return "\n".join(lines)
