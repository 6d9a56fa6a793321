"""Request-scoped span trees.

:class:`Span` carries ``trace_id`` / ``span_id`` / ``parent_id`` so one
request's time decomposes into true parent/child stages, across thread
boundaries: the submitting thread opens the root span, stashes it on the
gateway's ticket, and the scheduler thread opens children against that
explicit parent (:func:`start_span`). Within one thread the current span
propagates through a ``contextvars.ContextVar`` (:func:`current_span`,
:class:`use_span`). Finished spans land in the flight recorder
(:mod:`repro_torch.obs.flight`) — bounded per-thread rings — and the
*owner* of the span decides which registry (if any) gets its duration
histogram; the gateway routes stage durations into its private registry
as ``gateway.stage.<name>_s``.

Span names the gateway opens:

=========================  =================================================
``gw.request``             gateway request root (submit → resolution)
``gw.admission``           submit body: route + coalesce probe + queue put
``gw.queue_wait``          queue put → drained by the owning shard
``gw.coalesce_attach``     attach to an in-flight identical scan
``gw.scan_batch``          shard batch root (one drained batch)
``gw.batch_form``          shed expired + group by scan key + publish
``gw.prefilter``           plan: literal/signature prefilter → candidates
``gw.cache_fill``          chunk payload fetch (cache hits + decompress)
``gw.kernel_dispatch``     one shared multi-pattern kernel launch
``gw.host_verify``         host-side verify/regex gate over a chunk
``gw.respond``             ranking + resolving every waiter's future
``gw.timeout``             marker: request resolved with GatewayTimeout
``gw.redrive``             marker: orphan re-routed after a shard death
=========================  =================================================

``enabled()`` reports the process-wide switch (``REPRO_OBS_TRACE``, off
by default) that call sites read once per batch; the gateway traces
every request whatever it says. The flat helpers :func:`add` and
:func:`count` publish a duration or a count straight to the process
registry: the LM serving engine records ``serve.prefill`` and
``serve.decode`` through them when tracing is on.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time as _time
from time import perf_counter
from typing import Optional, Tuple, Union

__all__ = ["ROOT", "Span", "add", "count", "current_span", "enable",
           "enabled", "perf_to_wall_us", "start_span", "use_span"]

_ENABLED = os.environ.get("REPRO_OBS_TRACE", "") not in ("", "0")


def enabled() -> bool:
    """Is span recording on? Call sites capture this once per iterator or
    per batch — never per record."""
    return _ENABLED


def enable(on: bool = True) -> bool:
    """Turn span recording on/off; returns the previous setting."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def add(name: str, seconds: float, n: int = 1) -> None:
    """Record a span duration directly (for call sites that time with
    ``perf_counter`` themselves): the ``span.<name>_s`` histogram and the
    ``span.<name>.count`` counter of the process-default registry."""
    from repro_torch import obs

    reg = obs.registry()
    reg.observe(f"span.{name}_s", seconds)
    if n:
        reg.counter_add(f"span.{name}.count", n)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the process-default registry."""
    from repro_torch import obs

    obs.registry().counter_add(name, n)


# wall-clock anchor: spans time with perf_counter (monotonic, cheap) and
# convert to wall microseconds only at export time, via one pair of
# epoch samples taken at import
_EPOCH_PERF = perf_counter()
_EPOCH_WALL = _time.time()

#: monotonically increasing ids; ``itertools.count().__next__`` is atomic
#: under the interpreter lock, so ids are unique across threads
_NEXT_ID = itertools.count(1).__next__


def perf_to_wall_us(t_perf: float) -> float:
    """Convert a ``perf_counter`` instant to wall-clock microseconds."""
    return (_EPOCH_WALL + (t_perf - _EPOCH_PERF)) * 1e6


class Span:
    """One timed stage in a trace tree.

    ``trace_id`` groups every span of one logical request (or one
    scheduler batch); ``parent_id`` is the ``span_id`` of the enclosing
    stage (``0`` for roots). Spans are started by :func:`start_span`
    and closed with :meth:`finish`, which appends them to a flight
    recorder ring. A span may be started on one thread and finished on
    another — ``thread`` records the *starting* thread.
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "thread", "attrs")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: int, t0: float, thread: str,
                 attrs: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.thread = thread
        self.attrs = attrs

    def set_attr(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def context(self) -> Tuple[int, int]:
        """``(trace_id, span_id)`` — the hand-off token for children
        started on another thread."""
        return (self.trace_id, self.span_id)

    def finish(self, t1: Optional[float] = None, *,
               recorder=None) -> float:
        """Close the span and record it; returns the duration in seconds.

        ``recorder=None`` uses the process-default flight recorder;
        ``recorder=False`` closes without recording. Idempotent: a second
        ``finish`` only returns the duration.
        """
        if self.t1 is not None:
            return self.t1 - self.t0
        self.t1 = t1 if t1 is not None else perf_counter()
        if recorder is not False:
            if recorder is None:
                from repro_torch.obs import flight

                recorder = flight.recorder()
            recorder.record(self)
        return self.t1 - self.t0

    def as_dict(self) -> dict:
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": self.thread,
            "t0_us": perf_to_wall_us(self.t0),
            "dur_us": (self.t1 - self.t0) * 1e6 if self.t1 is not None
                      else None,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


_current_span: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("repro_torch_obs_current_span", default=None)

#: Sentinel parent: root a fresh trace even when a current span exists.
ROOT: Tuple = ()

ParentLike = Union[Span, Tuple[int, int], None]


def current_span() -> Optional[Span]:
    """The context's innermost active span, if any."""
    return _current_span.get()


def start_span(name: str, parent: ParentLike = None, *,
               t0: Optional[float] = None,
               attrs: Optional[dict] = None) -> Span:
    """Open a span.

    ``parent`` may be a :class:`Span`, a ``(trace_id, span_id)`` context
    tuple (cross-thread hand-off), :data:`ROOT` (a fresh trace), or
    ``None`` — then the contextvar's current span is the parent, and if
    there is none either, this span roots a fresh trace. ``t0``
    backdates the start (``gw.queue_wait`` starts at the submit
    instant)."""
    if parent is None:
        parent = _current_span.get()
    if parent is None or parent == ():  # () == ROOT: force a fresh trace
        trace_id, parent_id = _NEXT_ID(), 0
    elif isinstance(parent, Span):
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        trace_id, parent_id = parent
    return Span(name, trace_id, _NEXT_ID(), parent_id,
                t0 if t0 is not None else perf_counter(),
                threading.current_thread().name, attrs)


class use_span:
    """Context manager installing ``span`` as the context's current span
    (children started with ``parent=None`` nest under it); optionally
    finishes it on exit (``finish=True``)."""

    __slots__ = ("_span", "_finish", "_recorder", "_token")

    def __init__(self, span_: Span, *, finish: bool = False, recorder=None):
        self._span = span_
        self._finish = finish
        self._recorder = recorder

    def __enter__(self) -> Span:
        self._token = _current_span.set(self._span)
        return self._span

    def __exit__(self, *exc) -> None:
        _current_span.reset(self._token)
        if self._finish:
            self._span.finish(recorder=self._recorder)
