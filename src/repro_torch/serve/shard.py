"""``repro_torch.serve.shard`` — one gateway scheduler shard.

:class:`~repro_torch.serve.archive.ArchiveGateway` is a *router* over a
pool of :class:`ShardScheduler` instances defined here. A shard is the
unit of serving **and** the unit of failure:

* it owns one :class:`~repro_torch.index.query.QueryEngine` (and
  therefore its readers and kernel launches) plus one drain thread;
* it runs its **own admission budget** — a queue-depth bound — and
  raises a typed, shard-tagged :class:`GatewayOverloaded` instead of
  contributing to one global cliff;
* it keeps its **own in-flight registry**, so request coalescing works
  *within* the shard — and the router's scan-identity affinity hashing
  guarantees identical scans always land on the same shard, which is why
  sharding doesn't cost any coalescing;
* it is **supervised**: the drain thread updates a heartbeat each cycle,
  an abnormal exit (including the injected ``REPRO_FAULT_SHARD_KILL``
  death, spec captured at shard-spawn time) marks the shard dirty-dead,
  and the router reaps it via :meth:`ShardScheduler.take_orphans` —
  every queued, serving and coalesce-attached ticket comes back exactly
  once for re-drive.

The serving machinery (batch formation, deadline shedding, prefilter
planning, chunked cache-aware fetch, shared multi-pattern kernel launch,
host verify, respond) gives responses identical to a synchronous
:class:`QueryEngine` run.

Concurrency note: shards share one device, so the kernel-launch stage
alone runs under a process-wide lock (:data:`_DISPATCH_LOCK`); the
wrapper it calls copies the chunk to the card, launches and
synchronizes before it returns, so no launch is pending once the lock is
released. Queue wait, planning, fetch and host verify overlap across
shards. Shards are threads, never processes: no process forks from one
that holds a CUDA context.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.warc.errors import RecordReadError
from repro_torch.index.query import PatternHit, QueryEngine, QueryPlan
from repro_torch.index.service import QueryRequest, QueryResponse
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import trace as obs_trace

__all__ = ["GatewayClosed", "GatewayOverloaded", "GatewayShardDown",
           "GatewayTimeout", "ShardKilled", "ShardScheduler"]

#: fault-injection hook: ``<latch path>:<nth batch>`` kills the first shard
#: to begin serving its nth drained batch (one-shot, won through the latch
#: file); the reference package's test helper arms the same variable
FAULT_SHARD_KILL_ENV = "REPRO_FAULT_SHARD_KILL"

#: shards share one device; serialize only the kernel-launch stage
_DISPATCH_LOCK = threading.Lock()

#: per-shard admission-queue bound — the backpressure knob
MAX_PENDING = 256
#: how many queued requests one shard drain may aggregate into a batch
MAX_BATCH_REQUESTS = 16
#: drain-thread queue poll (also its heartbeat period when idle)
POLL_INTERVAL_S = 0.02
#: a shard's queue depth at which it trips a ``queue_highwater`` dump
QUEUE_HIGHWATER = (MAX_PENDING * 3) // 4


class GatewayOverloaded(RuntimeError):
    """Admission budget exhausted: backpressure instead of unbounded
    growth. Per shard — ``shard`` names the scheduler shard
    that rejected."""

    def __init__(self, msg: str, *, shard: int | None = None) -> None:
        super().__init__(msg)
        self.shard = shard


class GatewayClosed(RuntimeError):
    """Request submitted to (or still pending in) a closed gateway."""


class GatewayTimeout(RuntimeError):
    """Per-request deadline expired before the scan could resolve it.

    Distinct from :class:`GatewayOverloaded` (rejected at admission) —
    a timed-out request was *accepted* but couldn't be served in time;
    the caller can tell load shedding apart from slow serving.
    """


class GatewayShardDown(RuntimeError):
    """A scheduler shard died and the request could not be recovered.

    Raised (as a future's exception, never silently dropped) only when
    the single allowed re-drive also failed — the re-driven shard died
    too, or every shard is permanently down. ``shard`` names the last
    shard that failed the request.
    """

    def __init__(self, msg: str, *, shard: int | None = None) -> None:
        super().__init__(msg)
        self.shard = shard


class ShardKilled(BaseException):
    """Injected shard death (``REPRO_FAULT_SHARD_KILL``).

    Derives :class:`BaseException` so the per-batch ``except
    BaseException`` isolation in the drain loop can explicitly re-raise
    it: the injected fault must kill the *thread* (exercising the
    reap/re-drive path), not be absorbed as a batch error.
    """


@dataclass
class _Ticket:
    """One submitted request and its completion future."""

    request: QueryRequest
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)
    deadline: float | None = None  # absolute perf_counter time, or None
    # request-scoped tracing (set by the submitter): the root span
    # carries the trace across the submit-thread → scheduler-thread
    # boundary; wait_span times queue residency (opened by the submitter,
    # closed by the scheduler)
    span: obs_trace.Span | None = None
    wait_span: obs_trace.Span | None = None
    # routing state: the shard currently responsible, and whether the
    # ticket already consumed its single allowed re-drive
    shard: int | None = None
    redriven: bool = False

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class _StageCM:
    """``with shard._stage("gw.cache_fill") as sp:`` — span + stage
    histogram, or a no-op when the gateway isn't tracing."""

    __slots__ = ("_owner", "span")

    def __init__(self, owner, name: str, parent=None, attrs=None):
        self._owner = owner
        self.span = obs_trace.start_span(name, parent, attrs=attrs)

    def __enter__(self) -> obs_trace.Span:
        return self.span

    def __exit__(self, *exc) -> None:
        self._owner._end_span(self.span)


class ShardScheduler:
    """One supervised scheduler shard: queue + budgets + engine + thread.

    Created, started and reaped by :class:`~repro_torch.serve.archive.
    ArchiveGateway`; client threads only ever touch :meth:`admit` (via
    the router) and the returned futures.
    """

    def __init__(self, shard_id: int, *, engine: QueryEngine, cache,
                 metrics,
                 flight_recorder: obs_flight.FlightRecorder | None = None
                 ) -> None:
        self.shard_id = shard_id
        self.engine = engine
        self.index = engine.index
        self.cache = cache        # shared (sharded) record cache
        self.metrics = metrics    # shared gateway metrics
        self._flight = flight_recorder if flight_recorder is not None \
            else obs_flight.recorder()
        self._above_highwater = False
        # admission state, all under one lock/condition: queued depth
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._queue: "queue.Queue[_Ticket]" = queue.Queue()  # depth-bounded
        self._depth = 0                                      # via _depth
        self._inflight: dict[tuple, list[_Ticket]] = {}
        self._serving: list[_Ticket] = []
        # lifecycle flags (written under self._lock where racing reap)
        self.closed = False        # close() called — reject new work
        self.down = False          # permanently down (respawn budget spent)
        self.dead = False          # drain thread exited abnormally
        self._reaped = False       # take_orphans() already collected
        self.respawns = 0
        self.batches_served = 0    # drained batches (fault nth counts these)
        self.heartbeat = time.perf_counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Spawn the drain thread. The shard-kill fault spec is captured
        from the environment *now* (arm before spawn), so re-arming after
        spawn cannot retroactively affect a running shard."""
        fault_spec = os.environ.get(FAULT_SHARD_KILL_ENV)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, args=(fault_spec,), daemon=True,
            name=f"gw-shard-{self.shard_id}")
        self._thread.start()

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def respawn(self) -> None:
        """Restart after a dirty death (router-driven, post-reap)."""
        with self._lock:
            self.dead = False
            self._reaped = False
            self.respawns += 1
        self.start()

    def mark_down(self) -> None:
        """Permanently retire the shard (respawn budget exhausted)."""
        with self._space:
            self.down = True
            self._space.notify_all()

    # -- tracing plumbing -------------------------------------------------
    def _end_span(self, span: obs_trace.Span) -> None:
        """Finish a span into the flight recorder and fold its duration
        into the ``gateway.stage.*`` histogram of the same name."""
        self.metrics.observe_stage(span.name,
                                   span.finish(recorder=self._flight))

    def _stage(self, name: str, parent=None, attrs=None):
        """Context manager for one scheduler-side stage."""
        return _StageCM(self, name, parent, attrs)

    def _trip(self, reason: str, attrs: dict | None = None) -> None:
        """Anomaly: auto-dump the flight recorder, tagged with the shard
        (rate-limited inside)."""
        attrs = dict(attrs or {})
        attrs.setdefault("shard", self.shard_id)
        if self._flight.trip(reason, attrs,
                             tag=f"shard{self.shard_id}") is not None:
            self.metrics.inc("flight_dumps")

    def _note_queue_depth(self, depth: int) -> None:
        self.metrics.gauge_set(f"shard{self.shard_id}.queue_depth", depth)
        self.metrics.note_global_depth(depth)
        if depth >= QUEUE_HIGHWATER:
            if not self._above_highwater:  # trip on the crossing, not
                self._above_highwater = True  # on every submit above it
                self._trip("queue_highwater",
                           {"depth": depth, "highwater": QUEUE_HIGHWATER})
        else:
            self._above_highwater = False

    # -- admission (called by the router, any client thread) --------------
    def admit(self, ticket: _Ticket, *, block: bool = True,
              timeout: float | None = None,
              force: bool = False) -> tuple[str, int]:
        """Admit one ticket under this shard's budgets.

        Returns ``("attached", n_waiters)`` when the ticket coalesced
        onto an already-executing identical scan (no queue slot, no
        budget charge), or ``("queued", depth)`` when it entered the
        queue, charging one slot of :data:`MAX_PENDING`.

        ``force=True`` (re-drive path) bypasses the budget check: a
        recovered ticket was already admitted once and must not bounce.
        Raises :class:`GatewayShardDown` if the shard is retired and
        :class:`GatewayOverloaded` (shard-tagged) over budget.
        """
        key = ticket.request.scan_key()
        deadline = (time.perf_counter() + timeout) if timeout is not None \
            else None
        with self._space:
            while True:
                if self.down or self.closed:
                    raise GatewayShardDown(
                        f"shard {self.shard_id} is retired",
                        shard=self.shard_id)
                waiters = self._inflight.get(key)
                if waiters is not None:
                    # in-flight coalescing fast path: join the executing
                    # scan directly, never entering the queue
                    waiters.append(ticket)
                    ticket.shard = self.shard_id
                    self.metrics.inc("requests")
                    self.metrics.inc("coalesced")
                    return ("attached", len(waiters))
                if force or self._depth < MAX_PENDING:
                    self._depth += 1
                    ticket.shard = self.shard_id
                    self._queue.put(ticket)
                    depth = self._depth
                    self.metrics.inc("requests")
                    break
                if not block:
                    self._reject()
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    self._reject()
                self._space.wait(remaining if remaining is not None
                                 else POLL_INTERVAL_S)
        self._note_queue_depth(depth)
        return ("queued", depth)

    def _reject(self) -> None:
        self.metrics.inc("rejected")
        self._trip("gateway_overloaded", {"max_pending": MAX_PENDING})
        raise GatewayOverloaded(
            f"shard {self.shard_id} admission queue full "
            f"({MAX_PENDING} pending)", shard=self.shard_id)

    def _uncharge(self, batch: list[_Ticket]) -> None:
        """Release the admission budget for a drained batch."""
        with self._space:
            self._depth -= len(batch)
            self._space.notify_all()

    def pending(self) -> int:
        return self._depth

    # -- drain loop -------------------------------------------------------
    def _run(self, fault_spec: str | None) -> None:
        try:
            self._drain(fault_spec)
        except ShardKilled:
            with self._lock:
                self.dead = True  # dirty death: supervisor reaps + re-drives
        except BaseException:  # pragma: no cover - defensive
            self.metrics.inc("errors")
            with self._lock:
                self.dead = True

    def _drain(self, fault_spec: str | None) -> None:
        while True:
            self.heartbeat = time.perf_counter()
            try:
                first = self._queue.get(timeout=POLL_INTERVAL_S)
            except queue.Empty:
                if self._stop.is_set():
                    return  # drained: every accepted request was served
                continue
            batch = [first]
            while len(batch) < MAX_BATCH_REQUESTS:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            self._uncharge(batch)
            self._note_queue_depth(self._depth)
            self.batches_served += 1
            self._serving = batch
            try:
                self._serve_batch(batch, fault_spec)
            except ShardKilled:
                raise  # injected death: leave _serving/_inflight for reap
            except BaseException:  # the scheduler must outlive any batch
                self.metrics.inc("errors")
            self._serving = []

    def _timeout(self, ticket: _Ticket) -> None:
        """Resolve one expired ticket (caller already claimed the future)."""
        waited = time.perf_counter() - ticket.t_submit
        ticket.future.set_exception(GatewayTimeout(
            f"deadline expired after {waited:.3f}s"))
        self.metrics.inc("timeouts")
        # marker child + closed root *before* the trip, so the dump holds
        # the offending request's complete span tree
        with self._stage("gw.timeout", ticket.span,
                         attrs={"waited_s": waited}):
            pass
        ticket.span.set_attr("error", "GatewayTimeout")
        ticket.span.finish(recorder=self._flight)
        self._trip("gateway_timeout",
                   {"waited_s": waited, "trace_id": ticket.span.trace_id})

    def _serve_batch(self, tickets: list[_Ticket],
                     fault_spec: str | None = None) -> None:
        # the batch roots its own trace (a scan serves many requests —
        # span trees are strict, so waiter roots *link* to it via attrs
        # rather than parent it); installing it as the context's current
        # span lets every stage below default-parent to it
        for ticket in tickets:
            if ticket.wait_span is not None:  # queue residency ends here
                self._end_span(ticket.wait_span)
                ticket.wait_span = None
        batch_span = obs_trace.start_span(
            "gw.scan_batch", obs_trace.ROOT,
            attrs={"shard": self.shard_id,
                   "n_tickets": len(tickets),
                   "waiter_traces": [t.span.trace_id for t in tickets]})
        try:
            with obs_trace.use_span(batch_span):
                self._serve_batch_body(tickets, fault_spec)
        finally:
            self._end_span(batch_span)

    def _maybe_kill(self, fault_spec: str | None) -> None:
        """Injected mid-batch death: fires *after* the in-flight registry
        is published (so coalesce-attached waiters are orphaned too) and
        before any waiter resolves — the worst moment the re-drive
        protocol must survive. One-shot across every shard sharing the
        latch: losers of the O_EXCL race keep serving."""
        if not fault_spec:
            return
        latch, _, nth = fault_spec.rpartition(":")
        if not latch or self.batches_served != int(nth):
            return
        try:
            fd = os.open(latch, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            return  # another shard already died for this latch
        os.close(fd)
        raise ShardKilled(
            f"shard {self.shard_id} killed mid-batch by fault injection")

    def _serve_batch_body(self, tickets: list[_Ticket],
                          fault_spec: str | None = None) -> None:
        form = self._stage("gw.batch_form").__enter__()
        # shed already-expired tickets before planning anything: under
        # overload the queue ages, and scanning for a waiter that stopped
        # caring only makes every later deadline worse
        now = time.perf_counter()
        live: list[_Ticket] = []
        for ticket in tickets:
            if ticket.expired(now):
                if ticket.future.set_running_or_notify_cancel():
                    self._timeout(ticket)
            else:
                live.append(ticket)
        if not live:
            self._end_span(form)
            return
        tickets = live
        # group by scan identity; first occurrence keeps submission order
        groups: dict[tuple, list[_Ticket]] = {}
        for ticket in tickets:
            key = ticket.request.scan_key()
            if key in groups:
                groups[key].append(ticket)
                self.metrics.inc("coalesced")
            else:
                groups[key] = [ticket]
        with self._lock:
            # publish the in-flight registry: identical requests submitted
            # while we scan attach to these lists and never enter the queue
            self._inflight.update(groups)
            self._serving = []  # tickets now owned by _inflight, not both
        self._end_span(form)
        self._maybe_kill(fault_spec)
        self.metrics.inc("scan_batches")
        self.metrics.inc("unique_scans", len(groups))
        results: dict[tuple, list[PatternHit]] = {}
        failures: dict[tuple, BaseException] = {}
        try:
            plans = {}
            for key, group_waiters in groups.items():
                try:
                    with self._stage("gw.prefilter",
                                     attrs={"pattern":
                                            repr(key[0][:64])}):
                        plans[key] = self._plan(group_waiters[0].request)
                except Exception as exc:  # malformed query: fail only its
                    failures[key] = exc   # own waiters, not the batch
                    self.metrics.inc("errors")
            results, scan_failures = self._execute_plans(plans)
            for key, exc in scan_failures.items():
                failures.setdefault(key, exc)
        except ShardKilled:
            raise  # _inflight deliberately left populated for the reap
        except BaseException as exc:  # scan failure: resolve all, keep serving
            self.metrics.inc("errors")
            failures = {key: failures.get(key, exc) for key in groups}
            with self._lock:
                waiters = {key: self._inflight.pop(key) for key in groups
                           if key in self._inflight}
        else:
            with self._lock:
                waiters = {key: self._inflight.pop(key) for key in groups
                           if key in self._inflight}
        with self._stage("gw.respond"):
            now = time.perf_counter()
            for key, tickets_for_key in waiters.items():
                hits = results.get(key, [])
                error = failures.get(key)
                # rank: most matches first, index order breaks ties
                # (stable) — identical to IndexQueryService
                ranked = sorted(hits, key=lambda h: -h.n_matches)
                for ticket in tickets_for_key:
                    # a client may have cancel()ed while we scanned;
                    # claiming the future first makes the set_* below
                    # race-free (and a cancelled ticket must not kill the
                    # scheduler)
                    if not ticket.future.set_running_or_notify_cancel():
                        ticket.span.set_attr("cancelled", True)
                        ticket.span.finish(recorder=self._flight)
                        continue
                    if error is not None:
                        ticket.future.set_exception(error)
                        ticket.span.set_attr("error", type(error).__name__)
                        ticket.span.finish(recorder=self._flight)
                        continue
                    if ticket.expired(now):  # scan outlived the deadline
                        self._timeout(ticket)
                        continue
                    latency = now - ticket.t_submit
                    ticket.future.set_result(QueryResponse(
                        request=ticket.request,
                        hits=ranked[:ticket.request.top_k],
                        total_matches=len(hits), latency_s=latency))
                    self.metrics.observe_latency(latency)
                    self.metrics.inc("responses")
                    ticket.span.finish(recorder=self._flight)

    def _plan(self, request: QueryRequest) -> QueryPlan:
        if request.regex:
            return self.engine.plan_regex(request.pattern, request.filters,
                                          prefilter=request.prefilter)
        return self.engine.plan(request.pattern, request.filters,
                                prefilter=request.prefilter)

    # -- cache-aware fetch ----------------------------------------------
    def _fetch(self, row: int) -> bytes:
        key = (int(self.index.shard_id[row]), int(self.index.offset[row]))
        data = self.cache.get(key)
        if data is None:
            data = self.engine._fetch(row)
            self.cache.put(key, data)
            self.metrics.inc("records_fetched")
            if self.engine.store is not None:  # served from row-groups
                self.metrics.inc("store_fetches")
        return data

    def _fetch_chunk(self, chunk: list[tuple[tuple, int]]
                     ) -> tuple[dict[int, bytes], list[tuple[tuple, int]]]:
        """Fetch one chunk's payloads, quarantining unreadable rows.

        A row whose record can't be parsed (:class:`RecordReadError` —
        damaged member, bad framing) is dropped from the chunk instead
        of failing any query: a damaged record simply can't match, and
        every plan sharing the row keeps its other candidates. Counted
        under ``read_errors`` (fetch attempts that failed) and
        ``quarantined_rows`` (distinct rows skipped).
        """
        bufs: dict[int, bytes] = {}
        dead: set[int] = set()
        with self._stage("gw.cache_fill",
                         attrs={"rows": len(chunk)}) as sp:
            for _, row in chunk:  # dedupe: shared rows fetched once
                if row in bufs or row in dead:
                    continue
                try:
                    bufs[row] = self._fetch(row)
                except RecordReadError:
                    dead.add(row)
                    self.metrics.inc("read_errors")
            if sp is not None:
                sp.set_attr("fetched", len(bufs))
        if not dead:
            return bufs, chunk
        self.metrics.inc("quarantined_rows", len(dead))
        return bufs, [(key, row) for key, row in chunk if row not in dead]

    def _fail_chunk(self, chunk: list[tuple[tuple, int]],
                    exc: BaseException,
                    failures: dict[tuple, BaseException]) -> None:
        self.metrics.inc("errors")
        for key in {key for key, _ in chunk}:
            failures.setdefault(key, exc)

    # -- cross-request scan ----------------------------------------------
    def _execute_plans(self, plans: dict[tuple, QueryPlan]
                       ) -> tuple[dict[tuple, list[PatternHit]],
                                  dict[tuple, BaseException]]:
        """Scan all plans' candidates through *shared* kernel dispatches.

        Every (plan, candidate row) pair becomes one scan item; items
        from different plans are chunked together under the engine's
        batch_records / batch_bytes limits (sized from the index's
        ``uncomp_len`` column, so chunking decides before any payload is
        decompressed) and each chunk goes through one multi-pattern
        dispatch per width bucket — the request count no longer shows up
        in the dispatch count. Payloads are fetched per chunk in
        shard/offset order (deduped inside the chunk, the cache absorbs
        repeats across chunks), scanned and verified, then released —
        resident memory stays bounded by chunk size + cache budget, like
        the sync engine's streaming execute.

        Failure isolation: unreadable rows are skipped per-row (see
        :meth:`_fetch_chunk`); a chunk whose scan/verify raises fails
        only the plans with items in that chunk (returned in the second
        element), never the whole batch — one poisoned query can't take
        down its co-batched neighbours.
        """
        results: dict[tuple, list[PatternHit]] = {key: [] for key in plans}
        failures: dict[tuple, BaseException] = {}
        kernel_items: list[tuple[tuple, int]] = []  # (plan key, row)
        host_items: list[tuple[tuple, int]] = []
        for key, plan in plans.items():
            target = host_items if plan.needs_host_scan else kernel_items
            target.extend((key, int(r)) for r in plan.rows)

        def fetch_order(item: tuple[tuple, int]) -> tuple[int, int]:
            return (int(self.index.shard_id[item[1]]),
                    int(self.index.offset[item[1]]))

        kernel_items.sort(key=fetch_order)
        host_items.sort(key=fetch_order)

        n_scanned = bytes_scanned = 0
        for chunk in self._chunks(kernel_items):
            chunk = [item for item in chunk if item[0] not in failures]
            if not chunk:
                continue
            try:
                bufs, chunk = self._fetch_chunk(chunk)
                if chunk:
                    self._scan_chunk(chunk, plans, bufs, results)
                n_scanned += len(chunk)
                bytes_scanned += sum(len(bufs[row]) for _, row in chunk)
            except Exception as exc:
                self._fail_chunk(chunk, exc, failures)

        # host path (literal sweep / regex gate, no device work): same
        # chunked fetch-dedup-release structure as the kernel path
        for chunk in self._chunks(host_items):
            chunk = [item for item in chunk if item[0] not in failures]
            if not chunk:
                continue
            try:
                bufs, chunk = self._fetch_chunk(chunk)
                with self._stage("gw.host_verify",
                                 attrs={"rows": len(chunk)}):
                    for key, row in chunk:
                        plan = plans[key]
                        buf = bufs[row]
                        self._finish_row(plan, key, row, buf,
                                         plan.host_scan(buf), results)
                        n_scanned += 1
                        bytes_scanned += len(buf)
            except Exception as exc:
                self._fail_chunk(chunk, exc, failures)

        self.metrics.inc("host_scans", len(host_items))
        self.metrics.inc("records_scanned", n_scanned)
        self.metrics.inc("bytes_scanned", bytes_scanned)
        for hits in results.values():
            hits.sort(key=lambda h: h.index_row)
        return results, failures

    def _chunks(self, items: list[tuple[tuple, int]]
                ) -> "list[list[tuple[tuple, int]]]":
        """Split scan items under the engine's batch record/byte limits,
        sized from the index (``uncomp_len`` == payload length)."""
        chunks: list[list[tuple[tuple, int]]] = []
        current: list[tuple[tuple, int]] = []
        pending = 0
        for item in items:
            current.append(item)
            pending += int(self.index.uncomp_len[item[1]])
            if (len(current) >= self.engine.batch_records
                    or pending >= self.engine.batch_bytes):
                chunks.append(current)
                current, pending = [], 0
        if current:
            chunks.append(current)
        return chunks

    def _finish_row(self, plan: QueryPlan, key: tuple, row: int, buf: bytes,
                    lit_positions: np.ndarray,
                    results: dict[tuple, list[PatternHit]]) -> None:
        final, first_len = plan.verify(buf, lit_positions)
        if final.size:
            results[key].append(self.engine.make_hit(row, buf, final,
                                                     first_len))

    def _scan_chunk(self, chunk: list[tuple[tuple, int]],
                    plans: dict[tuple, QueryPlan], bufs: dict[int, bytes],
                    results: dict[tuple, list[PatternHit]]) -> None:
        from repro_torch.kernels.bucketing import dispatch_count
        from repro_torch.kernels.pattern_scan import find_pattern_masks_multi

        chunk_bufs = [bufs[row] for _, row in chunk]
        chunk_pats = [plans[key].kernel_pattern for key, _ in chunk]
        with self._stage("gw.kernel_dispatch",
                         attrs={"rows": len(chunk),
                                "shard": self.shard_id}) as sp:
            with _DISPATCH_LOCK:  # shards share one device (module note)
                masks = find_pattern_masks_multi(
                    chunk_bufs, chunk_pats, block=self.engine.scan_block,
                    device=self.engine.device)
            dispatches = dispatch_count(
                [len(b) for b in chunk_bufs], self.engine.scan_block)
            if sp is not None:
                sp.set_attr("dispatches", dispatches)
        self.metrics.inc("kernel_dispatches", dispatches)
        with self._stage("gw.host_verify", attrs={"rows": len(chunk)}):
            for (key, row), mask, buf in zip(chunk, masks, chunk_bufs):
                self._finish_row(plans[key], key, row, buf,
                                 np.flatnonzero(mask), results)

    # -- reap + teardown --------------------------------------------------
    def take_orphans(self) -> list[_Ticket]:
        """Collect every unresolved ticket this shard is responsible for
        — queued, mid-serve, and coalesce-attached — exactly once.

        Idempotent: the first caller after a death gets the full set and
        resets the admission accounting; later calls get ``[]``. Safe to
        call on a live shard only from ``close()`` after the drain
        thread has exited.
        """
        with self._space:
            if self._reaped:
                return []
            self._reaped = True
            orphans: list[_Ticket] = []
            seen: set[int] = set()

            def _add(ticket: _Ticket) -> None:
                if id(ticket) not in seen:
                    seen.add(id(ticket))
                    orphans.append(ticket)

            for ticket in self._serving:
                _add(ticket)
            for waiters in self._inflight.values():
                for ticket in waiters:
                    _add(ticket)
            while True:
                try:
                    _add(self._queue.get_nowait())
                except queue.Empty:
                    break
            self._serving = []
            self._inflight.clear()
            self._depth = 0
            self._space.notify_all()
        return [t for t in orphans if not t.future.done()]

    def fail_queued(self) -> None:
        """Fail every currently queued ticket with :class:`GatewayClosed`
        (the queue hands tickets to exactly one caller each, so this can
        race a live scheduler without double-resolving any future)."""
        drained: list[_Ticket] = []
        while True:
            try:
                ticket = self._queue.get_nowait()
            except queue.Empty:
                break
            drained.append(ticket)
        if drained:
            self._uncharge(drained)
        for ticket in drained:
            if ticket.future.set_running_or_notify_cancel():
                ticket.future.set_exception(GatewayClosed("gateway closed"))

    def close(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the drain thread; by default serve everything queued.

        Raises ``TimeoutError`` if the shard is still mid-scan after
        ``timeout`` — the engine is left open for it; call ``close``
        again to retry teardown.
        """
        with self._space:
            self.closed = True  # admit() now raises GatewayShardDown
            self._space.notify_all()
        if not drain:
            self.fail_queued()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"shard {self.shard_id} still serving after {timeout}s; "
                    f"engine left open — retry close() to finish teardown")
        # a submit that raced close() may have enqueued after the drain
        # thread exited — fail it rather than leave its future pending
        self.fail_queued()
        self.engine.close()
