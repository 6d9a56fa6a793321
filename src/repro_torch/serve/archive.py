"""``repro_torch.serve.archive`` — sharded async archive query gateway.

:class:`~repro_torch.index.service.IndexQueryService` is synchronous:
every request pays for its own scan. This multi-tenant layer adds an
admission queue, request coalescing, cross-request kernel batching and a
byte-budgeted record cache, served by a **supervised shard pool**:

* **router front end** (this class) — :meth:`ArchiveGateway.submit`
  hashes the request's *scan identity* (``QueryRequest.scan_key``) onto
  one of N :class:`~repro_torch.serve.shard.ShardScheduler` shards.
  Affinity hashing keeps coalescing intact: identical scans always route
  to the same shard, so its in-flight registry sees every duplicate;
* **per-shard admission budgets** — each shard bounds its own queue
  depth (:data:`~repro_torch.serve.shard.MAX_PENDING` per shard);
  rejections are typed, shard-tagged :class:`GatewayOverloaded`
  (``.shard``). Overload never spills to a sibling shard — that would
  split a scan identity across two in-flight registries and silently
  un-coalesce it;
* **sharded record cache** —
  :class:`~repro_torch.serve.cache.ShardedRecordCache` consistent-hashes
  payload keys over per-slice TinyLFU caches: shards never duplicate hot
  bytes, and a shard death evicts only its slice;
* **supervision + re-drive** — a supervisor thread watches shard
  liveness, reaps a dead shard's tickets (queued, serving and
  coalesce-attached alike), respawns it with capped backoff, and
  re-drives every orphan through the router **exactly once**; a ticket
  whose re-drive also dies fails with a typed :class:`GatewayShardDown`.
  Nothing is silently dropped and no future resolves twice (futures are
  claimed with ``set_running_or_notify_cancel`` before every
  resolution).

Every shard's default engine runs its kernel launches on the gateway's
``device``; shards are threads sharing that one device.

Correctness bar: responses are identical to what an independent
synchronous :class:`~repro_torch.index.query.QueryEngine` run produces —
routing, coalescing, caching, shared launches and re-drive change *when*
and *where* work happens, never *what* is computed.
"""
from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import Future

from repro_torch._device import resolve_device
from repro_torch.index.cdx import CdxIndex
from repro_torch.index.query import QueryEngine
from repro_torch.index.service import QueryRequest, QueryResponse
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import trace as obs_trace
from .cache import ShardedRecordCache
from .metrics import GatewayMetrics
from .shard import (GatewayClosed, GatewayOverloaded, GatewayShardDown,
                    GatewayTimeout, ShardScheduler, _StageCM, _Ticket)

__all__ = ["ArchiveGateway", "GatewayClosed", "GatewayOverloaded",
           "GatewayShardDown", "GatewayTimeout"]

#: byte budget of the decompressed-payload cache, split evenly across
#: the per-shard consistent-hash slices (TinyLFU admission per slice)
CACHE_BYTES = 64 << 20
#: a dying shard is respawned this many times before it is retired
#: (marked permanently down; traffic routes around it and its cache
#: slice leaves the ring)
MAX_RESPAWNS = 3
#: base of the capped exponential respawn backoff,
#: ``min(1 s, base·2^respawns)``
RESPAWN_BACKOFF_S = 0.05


def _key_hash(key: tuple) -> int:
    """Stable 64-bit hash of a scan identity (process-independent —
    ``repr`` of the key tuple, not Python's seeded ``hash``)."""
    digest = hashlib.blake2b(repr(key).encode("utf-8", "backslashreplace"),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big")


class ArchiveGateway:
    """Sharded, coalescing, cross-request-batching query front end.

    >>> with ArchiveGateway(index, shards=4) as gw:   # on the GPU
    ...     fut = gw.submit(QueryRequest(b"nginx"))
    ...     response = fut.result()
    ...     gw.metrics.snapshot(gw.cache)["dispatches_per_request"]

    Parameters
    ----------
    index:
        the corpus CDX index the gateway serves.
    shards:
        scheduler shard count (default 1). Each shard owns an engine, a
        drain thread and its own admission budget; requests route by
        scan-identity affinity hashing.
    engine:
        optional pre-built :class:`QueryEngine` for shard 0; owned (and
        closed) by its shard either way. The other shards build
        ``QueryEngine(index, device=device)``.
    flight_recorder:
        where finished spans and anomaly dumps go; ``None`` uses the
        process-default :func:`repro_torch.obs.flight.recorder`. Dumps
        tripped by a shard carry a ``shard<i>`` tag.
    device:
        where every default shard engine launches its kernels (default
        the GPU; ``"cpu"`` only when asked).

    The reference's tuning options (queue bound, batch size, cache
    budget, respawn policy) are the module constants above and in
    :mod:`repro_torch.serve.shard`; every request is traced.
    """

    def __init__(self, index: CdxIndex, *, engine: QueryEngine | None = None,
                 shards: int = 1,
                 flight_recorder: obs_flight.FlightRecorder | None = None,
                 device="cuda") -> None:
        dev = resolve_device(device)
        n = max(1, int(shards))
        self.index = index
        self.cache = ShardedRecordCache(CACHE_BYTES, n)
        self.metrics = GatewayMetrics()
        self._flight = flight_recorder if flight_recorder is not None \
            else obs_flight.recorder()
        self._closed = False
        self._reap_lock = threading.Lock()
        self._shards: list[ShardScheduler] = []
        for i in range(n):
            eng = engine if (i == 0 and engine is not None) \
                else QueryEngine(index, device=dev)
            self._shards.append(ShardScheduler(
                i, engine=eng, cache=self.cache, metrics=self.metrics,
                flight_recorder=self._flight))
        self.metrics.gauge_set("shards", n)
        for shard in self._shards:
            shard.start()
        self._sup_stop = threading.Event()
        self._sup_thread = threading.Thread(
            target=self._supervise, daemon=True, name="gw-supervisor")
        self._sup_thread.start()

    # -- public surface ---------------------------------------------------
    @property
    def shards(self) -> list[ShardScheduler]:
        return self._shards

    @property
    def engine(self) -> QueryEngine:
        """Shard 0's engine (single-shard compatibility surface)."""
        return self._shards[0].engine

    def pending(self) -> int:
        return sum(shard.pending() for shard in self._shards)

    # -- tracing plumbing -------------------------------------------------
    def _end_span(self, span: obs_trace.Span) -> None:
        self.metrics.observe_stage(span.name,
                                   span.finish(recorder=self._flight))

    def _stage(self, name: str, parent=None, attrs=None):
        return _StageCM(self, name, parent, attrs)

    def _trip(self, reason: str, attrs: dict | None = None,
              tag: str | None = None) -> None:
        if self._flight.trip(reason, attrs, tag=tag) is not None:
            self.metrics.inc("flight_dumps")

    # -- routing ----------------------------------------------------------
    def _shard_index(self, key: tuple) -> int:
        """Affinity home of a scan identity (ignoring down shards)."""
        return _key_hash(key) % len(self._shards)

    def _candidates(self, key: tuple):
        """The affinity ring walk: owner shard first, then successors,
        skipping permanently-down shards. Affinity is what preserves
        coalescing — every candidate order for a given key is stable
        while the down-set is stable."""
        shards = self._shards
        start = _key_hash(key) % len(shards)
        for j in range(len(shards)):
            shard = shards[(start + j) % len(shards)]
            if not shard.down:
                yield shard

    def _admit(self, key: tuple, ticket: _Ticket, *, block: bool,
               timeout: float | None, force: bool = False
               ) -> tuple[str, int, ShardScheduler]:
        last: GatewayShardDown | None = None
        for shard in self._candidates(key):
            try:
                status, detail = shard.admit(ticket, block=block,
                                             timeout=timeout, force=force)
                return status, detail, shard
            except GatewayShardDown as exc:
                last = exc  # raced a retirement: next ring candidate
                continue
        raise last if last is not None else GatewayShardDown(
            "all gateway shards are down")

    # -- client side -----------------------------------------------------
    def submit(self, request: QueryRequest, *, block: bool = True,
               timeout: float | None = None,
               deadline_s: float | None = None) -> "Future[QueryResponse]":
        """Route one request to its affinity shard; returns the future.

        An identical scan already **executing** on the shard is joined
        directly (the in-flight coalescing fast path, no queue slot);
        identical requests sitting in the shard queue merge when it
        drains them into the same batch. With ``block=False`` (or on
        ``timeout``) an over-budget shard raises
        :class:`GatewayOverloaded` — typed, shard-tagged backpressure.

        ``deadline_s`` bounds how long the request may wait end-to-end:
        a ticket whose deadline expires before its batch resolves gets
        :class:`GatewayTimeout` instead of a response — under overload
        the shards shed expired queue entries without scanning for them.
        """
        if self._closed:
            raise GatewayClosed("gateway is closed")
        ticket = _Ticket(request)
        if deadline_s is not None:
            ticket.deadline = ticket.t_submit + deadline_s
        # root span: the whole request, submit → resolution; its trace id
        # rides the ticket across the scheduler boundary
        ticket.span = obs_trace.start_span(
            "gw.request", parent=obs_trace.ROOT, t0=ticket.t_submit,
            attrs={"pattern": repr(request.pattern[:64]),
                   "regex": request.regex, "top_k": request.top_k})
        adm = obs_trace.start_span("gw.admission", ticket.span,
                                   t0=ticket.t_submit)
        key = request.scan_key()
        try:
            status, detail, shard = self._admit(key, ticket, block=block,
                                                timeout=timeout)
        except (GatewayOverloaded, GatewayShardDown) as exc:
            adm.set_attr("rejected", True)
            if getattr(exc, "shard", None) is not None:
                adm.set_attr("shard", exc.shard)
            self._end_span(adm)
            ticket.span.set_attr("error", type(exc).__name__)
            ticket.span.finish(recorder=self._flight)
            raise
        adm.set_attr("shard", shard.shard_id)
        self._end_span(adm)
        if status == "attached":
            with self._stage("gw.coalesce_attach", ticket.span,
                             attrs={"inflight_waiters": detail,
                                    "shard": shard.shard_id}):
                pass
        else:
            ticket.wait_span = obs_trace.start_span(
                "gw.queue_wait", ticket.span,
                attrs={"shard": shard.shard_id})
        if status == "queued" and self._closed and not shard.alive():
            # raced close(): we passed the closed check before close()
            # flipped it, but enqueued after the drain thread exited —
            # no one will serve the queue again, so fail it now
            shard.fail_queued()
        return ticket.future

    def query(self, request: QueryRequest,
              timeout: float | None = None) -> QueryResponse:
        """Synchronous convenience: submit and wait."""
        return self.submit(request).result(timeout)

    def snapshot(self):
        """Observability hook: one merged
        :class:`~repro_torch.obs.ObsSnapshot` — this gateway's private
        metrics registry + cache counters (source ``"gateway"``) merged
        with the process-default registry (kernel dispatch profile,
        ingest counters). For the raw dict surface use
        ``gateway.metrics.snapshot()``.
        """
        from repro_torch import obs

        return obs.snapshot().merged_with(
            self.metrics.obs_snapshot(self.cache))

    # -- supervision + re-drive -------------------------------------------
    def _supervise(self) -> None:
        while not self._sup_stop.wait(0.02):
            for shard in self._shards:
                if shard.dead and not shard.alive() and not shard.closed:
                    self._reap(shard)

    def _reap(self, shard: ShardScheduler, closing: bool = False) -> None:
        """Handle one shard death: collect its tickets exactly once,
        respawn (capped backoff) or retire it, re-drive the orphans."""
        with self._reap_lock:
            if shard._reaped or not shard.dead:
                return  # lost the race: someone else already reaped it
            sid = shard.shard_id
            self.metrics.inc("shard_deaths")
            self._trip("shard_down",
                       {"shard": sid, "respawns": shard.respawns},
                       tag=f"shard{sid}")
            retire = closing or shard.respawns >= MAX_RESPAWNS
            if retire:
                # retirement: route around it and drop its cache slice
                # from the ring (only *its* keys are invalidated)
                shard.mark_down()
                self.metrics.inc("shards_down")
                self.cache.remove_slice(sid)
            orphans = shard.take_orphans()
            if not retire:
                delay = min(1.0, RESPAWN_BACKOFF_S * (2 ** shard.respawns))
                if delay > 0:
                    time.sleep(delay)
                # a dirty death may have left mid-fill entries behind:
                # evict this shard's slice only, siblings keep their heat
                self.cache.clear_slice(sid)
                shard.respawn()
                self.metrics.inc("shard_respawns")
        for ticket in orphans:
            self._redrive(ticket, sid)

    def _redrive(self, ticket: _Ticket, from_shard: int) -> None:
        """Recover one orphaned ticket: exactly one re-route through the
        affinity ring (budgets bypassed — it was already admitted once);
        a second death fails it with :class:`GatewayShardDown`."""
        if ticket.future.done():
            return
        if ticket.redriven:
            self._fail_shard_down(ticket, from_shard)
            return
        ticket.redriven = True
        self.metrics.inc("redriven")
        with self._stage("gw.redrive", ticket.span,
                         attrs={"from_shard": from_shard}):
            pass
        try:
            self._admit(ticket.request.scan_key(), ticket,
                        block=False, timeout=None, force=True)
        except GatewayShardDown:
            self._fail_shard_down(ticket, from_shard)

    def _fail_shard_down(self, ticket: _Ticket, shard_id: int) -> None:
        """Typed terminal failure for an unrecoverable orphan (claimed
        first, so a raced resolution can never double-resolve)."""
        if not ticket.future.set_running_or_notify_cancel():
            return
        ticket.future.set_exception(GatewayShardDown(
            f"shard {shard_id} died before serving this request",
            shard=shard_id))
        self.metrics.inc("shard_down_errors")
        ticket.span.set_attr("error", "GatewayShardDown")
        ticket.span.finish(recorder=self._flight)

    # -- lifecycle -------------------------------------------------------
    def close(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the pool; by default serve everything already queued.

        Order matters for the close audit: (1) reject new submissions,
        (2) stop the supervisor (no respawns during teardown), (3) reap
        any already-dead shard — its orphans re-drive into siblings that
        are *still open* and will drain them, (4) close shards one by
        one (each serves its queue), (5) fail anything a shard that died
        *during* its own drain left behind, with :class:`GatewayShardDown`.
        A waiter attached to an in-flight batch on shard A is resolved by
        step (4) regardless of what order siblings closed in — shards
        never wait on each other, so there is no deadlock to have.

        ``drain=False`` fails queued-but-unserved requests with
        :class:`GatewayClosed` instead of serving them. Raises
        ``TimeoutError`` if any shard is still mid-scan after
        ``timeout`` — its engine is left open; call ``close`` again to
        retry teardown.
        """
        self._closed = True  # reject new submissions immediately
        self._sup_stop.set()
        if self._sup_thread.is_alive():
            self._sup_thread.join(5.0)
        for shard in self._shards:
            if shard.dead and not shard.alive():
                self._reap(shard, closing=True)
        timeout_exc: TimeoutError | None = None
        for shard in self._shards:
            try:
                shard.close(drain=drain, timeout=timeout)
            except TimeoutError as exc:
                timeout_exc = timeout_exc or exc
        for shard in self._shards:
            # a death mid-close-drain cannot re-drive (siblings are
            # closing/closed): typed failure, never a silent drop
            if shard.dead:
                for ticket in shard.take_orphans():
                    self._fail_shard_down(ticket, shard.shard_id)
        if timeout_exc is not None:
            raise timeout_exc

    def __enter__(self) -> "ArchiveGateway":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
