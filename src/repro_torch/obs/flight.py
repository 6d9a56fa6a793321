"""Flight recorder: always-on, bounded, per-thread span rings + anomaly dumps.

A :class:`FlightRecorder` keeps the last ``capacity_per_thread``
finished :class:`~repro_torch.obs.trace.Span`\\ s **per writing thread**
in fixed-size ring buffers. Each ring has exactly one writer (its
thread), an append is two reference stores plus an int bump, and readers
never block writers — a dump may observe a ring mid-rotation and lose
the span being overwritten that instant, which is fine for a diagnostic
artifact. The global lock is touched once per thread *lifetime* (ring
registration), never per span, so the recorder stays on in the serve hot
path at bounded memory (``capacity_per_thread × threads`` spans).

**Anomaly auto-dump.** :meth:`FlightRecorder.trip` is the hook the
gateway calls when something the SLO cares about happens
(``GatewayTimeout``, ``GatewayOverloaded``, p99 over the SLO, queue-depth
high-water, a shard death): it writes the newest spans to a JSON file,
rate-limited (``min_dump_interval_s``) so an overload storm produces one
artifact; suppressed trips are counted (``flight.trips_suppressed``).
Dump files land in ``dump_dir`` (default ``$REPRO_FLIGHT_DIR`` or
``<tmp>/repro-flight``) and render into Chrome ``trace_event`` JSON via
:mod:`repro_torch.obs.export`.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from time import perf_counter, time as _wall
from typing import List, Optional

from .trace import Span

__all__ = ["DEFAULT_CAPACITY", "FlightRecorder", "recorder",
           "set_recorder"]

#: Spans retained per writing thread before the ring rotates.
DEFAULT_CAPACITY = 4096


def _default_dump_dir() -> str:
    return os.environ.get("REPRO_FLIGHT_DIR") or \
        os.path.join(tempfile.gettempdir(), "repro-flight")


class _Ring:
    """Single-writer span ring: ``buf[idx % cap]`` slot store + bump."""

    __slots__ = ("buf", "idx", "cap", "thread")

    def __init__(self, cap: int, thread: str):
        self.buf: List[Optional[Span]] = [None] * cap
        self.idx = 0
        self.cap = cap
        self.thread = thread

    def append(self, span: Span) -> None:
        self.buf[self.idx % self.cap] = span
        self.idx += 1

    def items(self) -> List[Span]:
        """Resident spans, oldest first (tolerant of a concurrent writer
        rotating under it)."""
        idx, cap = self.idx, self.cap
        if idx <= cap:
            out = self.buf[:idx]
        else:
            cut = idx % cap
            out = self.buf[cut:] + self.buf[:cut]
        return [s for s in out if s is not None]


class FlightRecorder:
    """Bounded always-on span store with rate-limited anomaly dumps."""

    def __init__(self, capacity_per_thread: int = DEFAULT_CAPACITY, *,
                 min_dump_interval_s: float = 30.0,
                 dump_dir: Optional[str] = None,
                 max_dump_spans: int = 8192) -> None:
        self.capacity_per_thread = max(16, int(capacity_per_thread))
        self.min_dump_interval_s = min_dump_interval_s
        self.dump_dir = dump_dir if dump_dir is not None \
            else _default_dump_dir()
        self.max_dump_spans = max_dump_spans
        self._local = threading.local()
        self._rings: List[_Ring] = []
        self._reg_lock = threading.Lock()   # ring registration only
        self._dump_lock = threading.Lock()  # dump serialization only
        self._last_dump = float("-inf")
        self._dump_seq = 0
        self.dump_paths: List[str] = []

    # -- hot path --------------------------------------------------------
    def record(self, span: Span) -> None:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self.capacity_per_thread,
                         threading.current_thread().name)
            self._local.ring = ring
            with self._reg_lock:
                self._rings.append(ring)
        ring.append(span)

    # -- readers ---------------------------------------------------------
    def spans(self, last: Optional[int] = None) -> List[Span]:
        """Resident finished spans across all rings, sorted by start time
        (``last`` keeps only the newest N)."""
        with self._reg_lock:
            rings = list(self._rings)
        out: List[Span] = []
        for ring in rings:
            out.extend(s for s in ring.items() if s.t1 is not None)
        out.sort(key=lambda s: s.t0)
        if last is not None and len(out) > last:
            out = out[-last:]
        return out

    def trace_tree(self, trace_id: int) -> List[Span]:
        """Every resident span of one trace, parents before children."""
        spans = [s for s in self.spans() if s.trace_id == trace_id]
        spans.sort(key=lambda s: (s.parent_id != 0, s.t0))
        return spans

    # -- dumping ---------------------------------------------------------
    def trip(self, reason: str, attrs: Optional[dict] = None, *,
             tag: Optional[str] = None) -> Optional[str]:
        """Anomaly hook: dump unless one fired within
        ``min_dump_interval_s``. Returns the dump path, or ``None`` when
        suppressed. Counts ``flight.trips.<reason>`` either way. ``tag``
        (the tripping gateway shard, e.g. ``"shard2"``) lands in both the
        payload and the dump file name."""
        from repro_torch import obs

        obs.registry().counter_add(f"flight.trips.{reason}")
        now = perf_counter()
        with self._dump_lock:
            if now - self._last_dump < self.min_dump_interval_s:
                obs.registry().counter_add("flight.trips_suppressed")
                return None
            self._last_dump = now
        return self.dump(reason=reason, attrs=attrs, tag=tag)

    def dump(self, path: Optional[str] = None, *, reason: str = "manual",
             attrs: Optional[dict] = None,
             tag: Optional[str] = None) -> str:
        """Write the resident spans (newest ``max_dump_spans``) as JSON;
        returns the path written."""
        from repro_torch import obs

        spans = self.spans(last=self.max_dump_spans)
        if path is None:
            os.makedirs(self.dump_dir, exist_ok=True)
            with self._dump_lock:
                self._dump_seq += 1
                seq = self._dump_seq
            stem = reason if tag is None else f"{reason}-{tag}"
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in stem)
            path = os.path.join(
                self.dump_dir, f"flight-{os.getpid()}-{seq:04d}-{safe}.json")
        payload = {
            "reason": reason,
            "tag": tag,
            "attrs": attrs or {},
            "wall_time_s": _wall(),
            "pid": os.getpid(),
            "n_spans": len(spans),
            "spans": [s.as_dict() for s in spans],
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
            f.write("\n")
        os.replace(tmp, path)  # a reader never sees a half-written dump
        self.dump_paths.append(path)
        obs.registry().counter_add("flight.dumps")
        return path


_default = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-default flight recorder ``Span.finish`` records into."""
    return _default


def set_recorder(rec: FlightRecorder) -> FlightRecorder:
    """Swap the process-default recorder (tests); returns the previous."""
    global _default
    prev = _default
    _default = rec
    return prev
